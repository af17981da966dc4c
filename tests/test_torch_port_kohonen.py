"""The port's Kohonen SOM against the JAX package on the CPU.

- ``kernels/kohonen.py som_step``'s plain version against the Pallas
  ``som_step`` in interpret mode: identical winners, weights within 1e-5;
- the SOM units and ``models/kohonen.py build`` at the demo's defaults
  against the JAX workflow under ``engine.pallas`` + ``pallas_interpret``,
  per minibatch and with ``scan_epoch``, from the JAX run's initial
  weights (carried with ``load_forward_params``) and shuffle state:
  identical winners, per-epoch ``weights_delta`` within 1e-5;
- the port's scan mode against its per-minibatch mode, the ``min_delta``
  stop and the mid-pass fallback (the reference's
  ``tests/test_kohonen_rbm.py`` cases);
- the kernel's own order (``som_step_twin``: ``som_plan``'s chunks and
  runs, the cluster's reduction ``rank_winners``) against the Pallas
  kernel, the plan's cover of neurons and samples, and the reduction's
  first-tie winner;
- the wrapper's refusals, its bound, and a ``cuda``-marked card check
  (bit-identical launches, one CUDA kernel a step).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.models import kohonen as jkohonen
from znicz_tpu.ops import kohonen as jk_ops
from znicz_tpu.ops.pallas import som_step as j_som_step

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import NumpyDevice, TorchDevice
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.core.memory import Array as TArray
from znicz_tpu_torch.core.workflow import Workflow as TWorkflow
from znicz_tpu_torch.kernels import kohonen as ksom
from znicz_tpu_torch.models import kohonen as tkohonen
from znicz_tpu_torch.ops import kohonen as tk_ops
from znicz_tpu_torch.units.kohonen import KohonenForward, KohonenTrainer
from znicz_tpu_torch.units.nn_units import load_forward_params

#: weights after a step or a run, port vs reference: both f32, the same
#: formulas, summed in other orders (torch's matmul blocking against the
#: Pallas interpreter's dots) — ~1e-7 measured
WEIGHT_ATOL = 1e-5


# -- the kernel's plain version ---------------------------------------------

@pytest.mark.parametrize("b,n,d,bs,alpha,sigma", [
    (500, 256, 16, 500, 0.5, 8.0),     # bench_kohonen's step
    (64, 256, 128, 64, 0.3, 1.5),      # the reference's parity sweep
    (50, 64, 2, 37, 0.5, 4.0),         # the demo's step, a padded tail
    (7, 9, 3, 1, 0.9, 0.5)])
def test_som_step_plain_matches_pallas(b, n, d, bs, alpha, sigma):
    rng = np.random.default_rng(b + n + d)
    x = rng.normal(size=(b, d)).astype(np.float32)
    w = (rng.normal(size=(n, d)) * 0.5).astype(np.float32)
    side = int(np.sqrt(n))
    coords = np.asarray(jk_ops.grid_coords(np, side, n // side))
    w_j, idx_j = j_som_step(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(coords), alpha, sigma, bs,
                            interpret=True)
    before = ksom.launches
    w_t, idx_t = ksom.som_step(torch.tensor(x), torch.tensor(w),
                               torch.tensor(coords), alpha, sigma, bs)
    assert ksom.launches == before          # the CPU runs no kernel
    assert idx_t.dtype == torch.int32 and w_t.dtype == torch.float32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=WEIGHT_ATOL)
    if bs < b:   # rows at or past bs change nothing
        x2 = x.copy()
        x2[bs:] = rng.normal(size=x2[bs:].shape)
        w_t2, _ = ksom.som_step(torch.tensor(x2), torch.tensor(w),
                                torch.tensor(coords), alpha, sigma, bs)
        np.testing.assert_array_equal(w_t2.numpy(), w_t.numpy())


@pytest.mark.parametrize("b,n,d,bs,alpha,sigma", [
    (500, 256, 16, 500, 0.5, 8.0),     # bench_kohonen's step, 16 runs
    (64, 256, 128, 64, 0.3, 1.5),      # the reference's parity sweep
    (50, 64, 2, 37, 0.5, 4.0),         # the demo's step, a padded tail
    (7, 9, 3, 1, 0.9, 0.5)])
def test_som_step_twin_matches_pallas(b, n, d, bs, alpha, sigma):
    """The kernel's order of summation (som_plan's chunks and runs) and
    its cluster's winners, in torch, against the Pallas kernel in
    interpret mode: identical winners, weights within 1e-5."""
    rng = np.random.default_rng(b + n + d)
    x = rng.normal(size=(b, d)).astype(np.float32)
    w = (rng.normal(size=(n, d)) * 0.5).astype(np.float32)
    side = int(np.sqrt(n))
    coords = np.asarray(jk_ops.grid_coords(np, side, n // side))
    w_j, idx_j = j_som_step(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(coords), alpha, sigma, bs,
                            interpret=True)
    w_t, idx_t = ksom.som_step_twin(torch.tensor(x), torch.tensor(w),
                                    torch.tensor(coords), alpha, sigma, bs)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=WEIGHT_ATOL)


@pytest.mark.parametrize("b", [500, 50, 5000])
@pytest.mark.parametrize("n", [256, 64, 7, 3])
def test_som_plan_covers_neurons_and_samples(b, n):
    """Each neuron belongs to exactly one rank (ranks past N own none),
    the chunks cover every sample, the runs every quad of a chunk, and
    the layout fits a block's shared memory."""
    plan = ksom.som_plan(b, n, 16)
    owned = [j for lo, hi in plan["ranges"] for j in range(lo, hi)]
    assert owned == list(range(n))
    assert len(plan["ranges"]) == ksom.RANKS
    assert all(hi - lo <= plan["per"] for lo, hi in plan["ranges"])
    chunk = plan["chunk"]
    assert chunk % 4 == 0 and chunk & (chunk - 1) == 0
    assert chunk <= ksom.MAX_CHUNK and chunk < 2 * max(b, 4)
    seen = [s for b0 in range(0, b, chunk) for s in
            range(b0, min(b0 + chunk, b))]
    assert seen == list(range(b))
    quads = -(-min(chunk, b) // 4)
    runs = [q for s in range(plan["slices"]) for q in
            range(s * quads // plan["slices"],
                  (s + 1) * quads // plan["slices"])]
    assert runs == list(range(quads))
    assert plan["resident"] and plan["smem_bytes"] <= ksom.SMEM_BUDGET


def test_som_plan_leaves_shared_memory_for_a_large_w():
    """W's rows past shared memory: the sums go to device memory, and a
    grid no chunk fits is refused by the plan (the launch then raises)."""
    plan = ksom.som_plan(300, 2048, 512)
    assert not plan["resident"] and plan["smem_bytes"] <= ksom.SMEM_BUDGET
    assert ksom.som_plan(100, 100000, 128) is None


@pytest.mark.parametrize("n", [256, 64, 7, 3])
def test_rank_winners_is_the_first_minimum(n):
    """The cluster's reduction of per-rank (d2, j) pairs gives
    torch.argmin's first-tie winner on rows whose minimum is tied across
    ranks, and 0 on all-NaN rows, as argmin does."""
    rng = np.random.default_rng(n)
    plan = ksom.som_plan(64, n, 16)
    d2 = torch.tensor(rng.integers(0, 4, size=(64, n)), dtype=torch.float32)
    for r in range(0, 64, 4):          # the minimum in the last ranks first
        d2[r, rng.permutation(n)[:min(n, 3)]] = -1.0
    d2[5] = float("nan")
    d2[6, : n // 2] = float("nan")     # NaN never wins
    got = ksom.rank_winners(d2, plan["ranges"])
    want = torch.where(d2.isnan(), float("inf"), d2).argmin(dim=1)
    want[5] = torch.argmin(d2[5])
    assert int(want[5]) == 0
    assert torch.equal(got, want)
    ties = [(d2[r] == d2[r].nan_to_num(9.0).min()).nonzero()
            for r in range(64)]
    assert sum(len(t) > 1 for t in ties) > 16     # the rows do tie


def test_som_step_first_minimum_wins():
    """Two neurons at the same distance: the smaller index wins, as the
    TPU kernel's where(d2 == min, col, N).min() picks it."""
    w = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [1.0, 0.0]],
                 np.float32)
    x = np.array([[0.0, 0.0], [2.0, 0.0]], np.float32)
    coords = np.asarray(jk_ops.grid_coords(np, 2, 2))
    _, idx = ksom.som_step(torch.tensor(x), torch.tensor(w),
                           torch.tensor(coords), 0.1, 1.0, 2)
    np.testing.assert_array_equal(idx.numpy(), [0, 0])


def test_som_step_refusals_and_bound():
    x, w = torch.zeros(4, 3), torch.zeros(9, 3)
    coords = torch.tensor(tk_ops.grid_coords(np, 3, 3))
    with pytest.raises(ValueError, match="coords"):
        ksom.som_step(x, w, coords[:4], 0.1, 1.0, 4)
    with pytest.raises(ValueError, match="float32"):
        ksom.som_step(x.double(), w, coords, 0.1, 1.0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ksom.som_step(torch.zeros(3, 4).t(), w, coords, 0.1, 1.0, 4)
    bound = ksom.bound((500, 16), (256, 16))
    assert bound["bytes"] == 4 * (500 * 16 + 2 * 256 * 16 + 2 * 256 + 500)
    assert bound["bound_by"] == "operations" and bound["bound_ms"] > 0


def test_ops_kohonen_is_the_reference_copy():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    coords = tk_ops.grid_coords(np, 2, 3)
    for a, b in zip(tk_ops.update(np, x, w, coords, 0.3, 1.0),
                    jk_ops.update(np, x, w, coords, 0.3, 1.0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tk_ops.hits(np, np.array([0, 2, 2]), 3),
                                  [1, 0, 2])


# -- the units --------------------------------------------------------------

def test_kohonen_trainer_backend_parity():
    """The reference's backend-parity case on the port: the numpy oracle
    against the torch path (the kernel's plain version) on the CPU."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    outs = []
    for device in (NumpyDevice(), TorchDevice("cpu")):
        tprng.seed_all(9)
        w = TWorkflow(name="t")
        tr = KohonenTrainer(w, shape=(3, 3))
        tr.input = TArray(x.copy())
        tr.batch_size = 16
        tr.initialize(device=device)
        tr.run()
        outs.append((tr.weights.map_read().copy(),
                     tr.winners.map_read().copy()))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_kohonen_forward_hits_accumulate_on_torch():
    tprng.seed_all(4)
    x = np.random.default_rng(1).normal(size=(10, 2)).astype(np.float32)
    w = TWorkflow(name="t")
    tr = KohonenTrainer(w, shape=(2, 2))
    tr.input = TArray(x)
    tr.initialize(device=TorchDevice("cpu"))
    fwd = KohonenForward(w, shape=(2, 2))
    fwd.input = TArray(x)
    fwd.weights = tr.weights
    fwd.batch_size = 10
    fwd.initialize(device=TorchDevice("cpu"))
    fwd.run()
    assert fwd.hits.sum() == 10
    np.testing.assert_array_equal(
        fwd.output.map_read(),
        jk_ops.winners(np, x, tr.weights.map_read()))
    fwd.run()
    assert fwd.hits.sum() == 20


def _scan(on: bool) -> None:
    jroot.common.engine.scan_epoch = on
    troot.common.engine.scan_epoch = on


def _record_winners(w, scan: bool) -> list:
    """Wrap the trainer's run to keep the winners of every per-minibatch
    step (scan mode updates none)."""
    winners, step = [], w.trainer.run

    def run():
        step()
        if not scan:
            winners.append(np.array(w.trainer.winners.map_read()))

    w.trainer.run = run
    return winners


@pytest.mark.parametrize("scan", [False, True])
def test_som_workflow_matches_jax(scan):
    """models/kohonen.build at the demo's defaults (8x8 grid, 500 2-D
    samples, minibatch 50, 10 epochs), the JAX run on its Pallas kernel in
    interpret mode, the port on the kernel's plain version."""
    _scan(scan)
    jroot.common.engine.pallas = True
    jroot.common.engine.pallas_interpret = True
    try:
        jprng.seed_all(17)
        jw = jkohonen.build()
        jw.initialize(device=TPUDevice())
        params = [{"w": jw.trainer.weights.map_read().copy()}]
        state = jprng.get().state_dict()
        j_win = _record_winners(jw, scan)
        jw.run()
    finally:
        jroot.common.engine.pallas = False
        jroot.common.engine.pallas_interpret = False
        _scan(False)
    _scan(scan)
    try:
        tprng.seed_all(17)
        tw = tkohonen.build()
        load_forward_params(tw.forwards, params)
        tw.initialize(device=TorchDevice("cpu"))
        tprng.get().load_state_dict(state)
        t_win = _record_winners(tw, scan)
        tw.run()
    finally:
        _scan(False)
    assert (tw.trainer._dataset_dev is not None) == scan
    j_hist = [h["metric_train"] for h in jw.decision.metrics_history]
    t_hist = [h["metric_train"] for h in tw.decision.metrics_history]
    assert len(t_hist) == len(j_hist) == 10
    np.testing.assert_allclose(t_hist, j_hist, rtol=0, atol=1e-5)
    assert len(t_win) == len(j_win) == (0 if scan else 100)
    for a, b in zip(t_win, j_win):
        np.testing.assert_array_equal(a, b)
    w_t = tw.trainer.weights.map_read()
    w_j = jw.trainer.weights.map_read()
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=WEIGHT_ATOL)
    data = tw.loader.original_data.map_read().reshape(500, -1)
    np.testing.assert_array_equal(jk_ops.winners(np, data, w_t),
                                  jk_ops.winners(np, data, w_j))


def test_scan_epoch_matches_per_minibatch():
    """The reference's scan-vs-eager case on the port: the same weights
    and |ΔW| history with the class pass launched at its first
    minibatch."""
    runs = {}
    for scan in (False, True):
        tprng.seed_all(77)
        troot.common.engine.scan_epoch = scan
        try:
            w = tkohonen.build(max_epochs=4, shape=(6, 6), minibatch_size=40,
                               n_train=200, sample_shape=(3,), min_delta=0.0)
            w.initialize(device=TorchDevice("cpu"))
            w.run()
        finally:
            troot.common.engine.scan_epoch = False
        runs[scan] = (w.trainer.weights.map_read().copy(),
                      [h["metric_train"] for h in
                       w.decision.metrics_history])
        assert (w.trainer._dataset_dev is not None) == scan
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(runs[True][1], runs[False][1], rtol=1e-4)


def test_scan_min_delta_still_stops():
    tprng.seed_all(5)
    troot.common.engine.scan_epoch = True
    try:
        w = tkohonen.build(max_epochs=50, shape=(4, 4), minibatch_size=50,
                           n_train=100, sample_shape=(2,), alpha=0.05,
                           radius_decay=0.5, min_delta=0.2)
        w.initialize(device=TorchDevice("cpu"))
        w.run()
    finally:
        troot.common.engine.scan_epoch = False
    hist = [h["metric_train"] for h in w.decision.metrics_history]
    assert hist[0] > 0.01, hist
    assert len(hist) < 50, len(hist)
    assert w.trainer.scan_delta_dev is None      # fetched every epoch


def test_scan_midpass_falls_back_to_per_minibatch():
    tprng.seed_all(21)
    troot.common.engine.scan_epoch = True
    try:
        w = tkohonen.build(max_epochs=3, shape=(4, 4), minibatch_size=25,
                           n_train=100, sample_shape=(2,), min_delta=0.0)
        w.initialize(device=TorchDevice("cpu"))
        assert w.trainer._dataset_dev is not None
        # a resume that landed mid-pass: the loader serves two minibatches
        # the trainer never sees
        w.loader.run()
        w.loader.run()
        assert int(w.loader.minibatch_offset) > 0
        w0 = np.array(w.trainer.weights.map_read())
        calls = []
        step = ksom.som_step

        def counted(*args):
            calls.append(args[0].shape[0])
            return step(*args)

        ksom.som_step = counted
        try:
            w.trainer.run()      # mid-pass -> one per-minibatch step
        finally:
            ksom.som_step = step
        assert calls == [25]
        assert np.abs(w.trainer.weights.map_read() - w0).max() > 0
        assert not w.trainer._scan_in_flight
    finally:
        troot.common.engine.scan_epoch = False


def test_scan_pass_launches_one_step_per_minibatch():
    """The class pass is one host loop of som_step calls, one a minibatch
    of the plan, the last with the padded tail's true row count."""
    tprng.seed_all(2)
    troot.common.engine.scan_epoch = True
    calls = []
    step = ksom.som_step

    def counted(x, w, coords, alpha, sigma, bs):
        calls.append((x.shape[0], bs))
        return step(x, w, coords, alpha, sigma, bs)

    ksom.som_step = counted
    try:
        w = tkohonen.build(max_epochs=2, shape=(4, 4), minibatch_size=30,
                           n_train=100, sample_shape=(2,), min_delta=0.0)
        w.initialize(device=TorchDevice("cpu"))
        w.run()
    finally:
        ksom.som_step = step
        troot.common.engine.scan_epoch = False
    assert calls == [(30, 30), (30, 30), (30, 30), (30, 10)] * 2


@pytest.mark.cuda
def test_som_step_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.normal(size=(500, 16)), dtype=torch.float32,
                     device="cuda")
    w = torch.tensor(rng.normal(size=(256, 16)), dtype=torch.float32,
                     device="cuda")
    coords = torch.tensor(tk_ops.grid_coords(np, 16, 16), device="cuda")
    from torch.profiler import ProfilerActivity, profile

    before = ksom.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ksom.som_step(x, w, coords, 0.5, 8.0, 480)
        torch.cuda.synchronize()
    again = ksom.som_step(x, w, coords, 0.5, 8.0, 480)
    want = ksom.som_step_plain(x, w, coords, 0.5, 8.0, 480)
    torch.cuda.synchronize()
    assert ksom.launches == before + 2
    assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) < WEIGHT_ATOL
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
    assert len(kernels) == 1 and kernels[0].count == 1, kernels
    assert "som_step_kernel" in kernels[0].key
