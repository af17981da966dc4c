"""The port's input layer on the CPU: the prefetch pipeline
(``znicz_tpu_torch/pipeline``), the loader's pipeline hooks, the fused
step's stager and the native row gather (``znicz_tpu_torch/native``).

- the cases of tests/test_pipeline_prefetch.py that need no snapshotter,
  on the port: pipelined metric histories bit-identical to the
  synchronous ones in the direct, indexed and ``scan_epoch`` feeding
  modes; fused only; the bounded queue's backpressure; a clean shutdown;
  a second attach refused; the workflow's stall table; the ring reusing
  its buffers, and fresh buffers without a stager;
- a worker fault re-raised on the consumer, the worker dead after;
- the loader's state dicts and the pipeline's resync on a restore;
- the stager's inputs equal to the synchronous path's (so the step's
  graphs on the card capture nothing new);
- the JAX package's and the port's ``mnist_fc.build_fused(
  pipeline_depth=2)`` from one seed and weights: the same served index
  sequence, the same n_err, weights within the MNIST FC SGD band;
- ``gather_rows`` against numpy fancy indexing (odd row counts, -1
  padding, fewer rows than threads, several dtypes), its checks, the
  loaders' use of it, and a failed native build raising.
"""

import threading
import time

import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.models import mnist_fc as jmnist

from znicz_tpu_torch import native
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader import fullbatch
from znicz_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from znicz_tpu_torch.models import mnist_fc as tmnist
from znicz_tpu_torch.pipeline import (BatchPrefetcher, PrefetcherStopped,
                                      attach_prefetcher, ring_safe_stager)
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.units.nn_units import load_forward_params

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 24},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 6},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
]
LOADER = {"n_classes": 6, "sample_shape": (10, 10), "n_train": 240,
          "n_valid": 120, "minibatch_size": 40, "spread": 2.5, "noise": 1.0}
#: weights after 2 epochs, port vs reference, SGD: both f32, differing in
#: summation order only (tests/test_torch_port_mnist.py's band)
SGD_WEIGHT_ATOL = 1e-6


def build(max_epochs, seed=77, depth=None):
    prng.seed_all(seed)
    w = StandardWorkflow(
        name="PipeTest", layers=LAYERS, loss_function="softmax",
        loader_name="synthetic_classifier", loader_config=LOADER,
        decision_config={"max_epochs": max_epochs},
        pipeline_config={"depth": depth} if depth else None)
    w.initialize(device=TorchDevice("cpu"))
    return w


def run_history(max_epochs, depth=None, **kw):
    w = build(max_epochs, depth=depth, **kw)
    w.run()
    hist = w.decision.metrics_history
    w.stop()
    return hist, w


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    faults.uninstall()


@pytest.fixture
def direct_transfers():
    """Force the batch-shipping path (no dataset pinned on the device) so
    the pipeline's staging leg carries the minibatches."""
    prev = root.common.engine.get("dataset_on_device_max_bytes", 1 << 30)
    root.common.engine.dataset_on_device_max_bytes = 0
    yield
    root.common.engine.dataset_on_device_max_bytes = prev


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == BatchPrefetcher.THREAD_NAME and t.is_alive()]


# -- determinism: sync vs prefetched ----------------------------------------

def test_prefetch_bit_exact_direct_mode(direct_transfers):
    """Prefetch depth 2 and 3: the epoch metric histories bit-identical to
    the synchronous path over the direct batch-transfer feeding mode."""
    sync_hist, _ = run_history(4)
    for depth in (2, 3):
        hist, w = run_history(4, depth=depth)
        assert hist == sync_hist, f"depth={depth} diverged"
        assert not w.loader.serve_indices_only
        snap = w.input_pipeline.stats.snapshot()
        assert snap["consumed"] == 4 * 9     # 6 train + 3 valid per epoch
        assert snap["bytes_staged"] > 0      # the staging leg really ran
        assert snap["max_fill"] <= depth


def test_prefetch_bit_exact_indexed_mode():
    """A data set pinned on the device (serve_indices_only): the pipeline
    stages only the raw indices; histories still bit-exact."""
    sync_hist, ws = run_history(3)
    hist, wp = run_history(3, depth=2)
    assert ws.loader.serve_indices_only and wp.loader.serve_indices_only
    assert hist == sync_hist
    assert wp.input_pipeline.stats.snapshot()["bytes_staged"] > 0


def test_prefetch_bit_exact_scan_epoch_mode():
    """Epoch-scan feeding (a class pass from its plan): the consumer
    replays the class plan the producer captured; nothing is staged;
    bit-exact."""
    prev = root.common.engine.get("scan_epoch", False)
    root.common.engine.scan_epoch = True
    try:
        sync_hist, _ = run_history(3)
        hist, w = run_history(3, depth=2)
    finally:
        root.common.engine.scan_epoch = prev
    assert w.step.scan_epoch
    assert hist == sync_hist
    assert w.input_pipeline.stats.snapshot()["bytes_staged"] == 0


def test_pipeline_requires_fused():
    with pytest.raises(ValueError, match="fused=True"):
        StandardWorkflow(
            name="Bad", layers=LAYERS, loss_function="softmax",
            loader_name="synthetic_classifier", loader_config=LOADER,
            fused=False, pipeline_config={"depth": 2})


def test_staged_inputs_equal_the_synchronous_inputs(direct_transfers):
    """The stager hands the step the same tensors, dtypes and shapes the
    synchronous path uploads (the graphs' keys on the card), detached
    from the ring slot on the CPU."""
    w = build(1)
    loader, step = w.loader, w.step
    stage = step.make_stager()
    rec = loader._next_record()
    arrays = loader.fill_batch(rec["indices"], rec["size"], rec["cls"])
    staged, nbytes = stage(rec, arrays)
    loader._publish_record(rec)
    loader.fill_minibatch()
    sync = step._host_inputs(loader)
    assert staged["event"] is None
    assert len(staged["inputs"]) == len(sync) == 3
    for got, want in zip(staged["inputs"], sync):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert nbytes == sum(a.nbytes for a in
                         (rec["indices"], arrays["data"], arrays["labels"]))
    arrays["data"][:] = 7.0                 # the ring slot, refilled
    assert not torch.equal(staged["inputs"][1], torch.full_like(
        staged["inputs"][1], 7.0))


def test_ring_safe_stager_detaches_on_the_cpu():
    slot = np.arange(6, dtype=np.float32)
    stage = ring_safe_stager(lambda a: torch.from_numpy(a),
                             torch.device("cpu"))
    staged, event = stage(slot)
    slot[:] = -1
    assert event is None
    assert torch.equal(staged, torch.arange(6, dtype=torch.float32))


def test_card_stager_refuses_a_missing_side_stream():
    with pytest.raises(RuntimeError, match="side CUDA stream"):
        ring_safe_stager(lambda a: a, torch.device("cuda"), None)


# -- the cross-package contract ----------------------------------------------

def _record_indices(step, out):
    orig = step.run

    def run():
        out.append(np.asarray(step.loader.minibatch_indices.mem).copy())
        orig()
    step.run = run


def test_mnist_fc_pipelined_matches_jax():
    """build_fused(pipeline_depth=2) in both packages from one seed and
    the same initial weights and shuffle state: the same served index
    sequence, the same per-epoch n_err, weights within the SGD band."""
    kw = {"max_epochs": 2, "layers": (32,), "minibatch_size": 50,
          "n_train": 300, "n_valid": 100, "pipeline_depth": 2}
    jprng.seed_all(11)
    jroot.common.engine.pallas = True
    jroot.common.engine.pallas_interpret = True
    try:
        jw = jmnist.build_fused(**kw)
        jw.initialize(device=TPUDevice())
        params = [{"w": f.weights.map_read().copy(),
                   "b": f.bias.map_read().copy()} for f in jw.forwards]
        state = jprng.get().state_dict()
        j_idx = []
        _record_indices(jw.step, j_idx)
        jw.run()
        jw.step.sync_to_units()
        jw.stop()
    finally:
        jroot.common.engine.pallas = False
        jroot.common.engine.pallas_interpret = False
    prng.seed_all(11)
    tw = tmnist.build_fused(**kw)
    load_forward_params(tw.forwards, params)
    tw.initialize(device=TorchDevice("cpu"))
    prng.get().load_state_dict(state)
    t_idx = []
    _record_indices(tw.step, t_idx)
    tw.run()
    tw.step.sync_to_units()
    tw.stop()
    assert tw.loader.pipeline is not None and tw.loader.serve_indices_only
    assert len(t_idx) == len(j_idx) == 2 * 8
    for a, b in zip(t_idx, j_idx):
        np.testing.assert_array_equal(a, b)
    assert [h["metric_train"] for h in tw.decision.metrics_history] == \
        [h["metric_train"] for h in jw.decision.metrics_history]
    assert [h["metric_validation"] for h in tw.decision.metrics_history] \
        == [h["metric_validation"] for h in jw.decision.metrics_history]
    for ft, fj in zip(tw.forwards, jw.forwards):
        for a in ("weights", "bias"):
            np.testing.assert_allclose(getattr(ft, a).map_read(),
                                       getattr(fj, a).map_read(), rtol=0,
                                       atol=SGD_WEIGHT_ATOL)


# -- failures ------------------------------------------------------------------

def test_worker_fault_reraised_on_the_consumer(direct_transfers):
    """A crash INSIDE the prefetch worker (site pipeline.fetch) surfaces
    on the consumer thread as the run's error, and the crashed walk stops
    the worker."""
    w = build(4, depth=2)
    plan = faults.FaultPlan(seed=99)
    plan.crash_at("pipeline.fetch", at_hit=14)
    with faults.active(plan):
        with pytest.raises(faults.FaultInjected):
            w.run()
    assert plan.log == [{"site": "pipeline.fetch", "action": "crash",
                         "hit": 14}]
    assert not _prefetch_threads(), "crashed run leaked a prefetch worker"


# -- backpressure / shutdown -------------------------------------------------

def _standalone_loader():
    prng.seed_all(5)
    loader = SyntheticClassifierLoader(
        None, n_classes=4, sample_shape=(8,), n_train=400, n_valid=0,
        minibatch_size=20)
    loader.initialize(device=TorchDevice("cpu"))
    return loader


def test_backpressure_bounds_queue():
    """The producer never runs more than ``depth`` batches ahead of the
    consumer: a slow consumer fills the bounded queue and the worker
    blocks (producer-starved accounting), it does not keep serving."""
    loader = _standalone_loader()
    pf = attach_prefetcher(loader, depth=2)
    try:
        pf.next_batch()                 # starts the worker
        deadline = time.monotonic() + 5.0
        while pf._queue.qsize() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)                 # give an unbounded producer rope
        assert pf._queue.qsize() == 2
        assert pf.stats.max_fill <= 2
        # queue(2) + one batch built and blocked on put + one consumed
        assert pf.stats.produced <= 2 + 1
        # draining hands the blocked batch straight through, in order
        offsets = [pf.next_batch().record["offset"] for _ in range(4)]
        assert offsets == [20, 40, 60, 80]
        assert pf.stats.producer_starved_s > 0.1
    finally:
        assert pf.stop()


def test_clean_shutdown_on_stop(direct_transfers):
    """After run() the worker is parked at the epoch barrier; the
    workflow's stop() joins it; next_batch afterwards raises."""
    w = build(2, depth=2)
    w.run()
    assert _prefetch_threads(), "worker should be parked at the barrier"
    w.stop()
    assert not _prefetch_threads(), "stop() leaked the prefetch worker"
    with pytest.raises(PrefetcherStopped):
        w.input_pipeline.next_batch()


def test_double_attach_refused():
    loader = _standalone_loader()
    attach_prefetcher(loader, depth=1)
    try:
        with pytest.raises(ValueError, match="already has a pipeline"):
            attach_prefetcher(loader, depth=1)
    finally:
        loader.pipeline.stop()


def test_timing_table_stalls(direct_transfers):
    """Stall accounting surfaces in Workflow.timing_table()."""
    w = build(2, depth=2)
    w.run()
    table = w.timing_table()
    for col in ("prod_stall", "cons_stall", "stage_s", "bound"):
        assert col in table, table
    snap = w.input_pipeline.stats_snapshot()
    assert snap["depth"] == 2 and snap["consumed"] == 2 * 9
    assert snap["bound"] in ("producer-starved", "consumer-starved",
                             "transfer-bound", "balanced")
    w.stop()


def test_fill_batch_ring_reuses_buffers():
    """With a slot-detaching stager the pipelined fill rotates depth + 2
    preallocated buffers instead of allocating per serve; the values are
    the synchronous gather's."""
    loader = _standalone_loader()
    pf = attach_prefetcher(loader, stager=lambda rec, arrays: (None, 0),
                           depth=1)
    try:
        seen = []
        for _ in range(7):
            batch = pf.next_batch()
            seen.append(id(batch.arrays["data"]))
        assert len(set(seen)) == 3          # depth + 2 rotating slots
        assert {k: len(r["bufs"]) for k, r in loader._rings.items()} == \
            {"data": 3, "labels": 3}
        batch = pf.next_batch()
        idx = batch.record["indices"][:batch.record["size"]]
        np.testing.assert_array_equal(
            batch.arrays["data"][:len(idx)],
            loader.original_data.mem[idx])
    finally:
        pf.stop()


def test_fill_batch_fresh_buffers_without_stager():
    """A stager-less pipeline does not rotate ring slots: every serve
    gets a fresh buffer."""
    loader = _standalone_loader()
    pf = attach_prefetcher(loader, depth=1)
    try:
        held = [pf.next_batch().arrays["data"] for _ in range(5)]
        assert len({id(a) for a in held}) == 5
        assert loader._rings == {}
    finally:
        pf.stop()


# -- loader state and resync --------------------------------------------------

def test_state_dict_at_epoch_boundary_and_resync():
    """At an epoch boundary the pipelined loader's state equals the
    synchronous one's (the barrier holds the producer); restoring a state
    re-arms the worker there, and both serve the same batches on."""
    n = 400 // 20                          # one epoch of train minibatches
    sync = _standalone_loader()            # each seeds the global prng
    served = []
    for _ in range(n):
        sync.run()
        served.append(sync.minibatch_indices.mem.copy())
    piped = _standalone_loader()
    attach_prefetcher(piped, depth=2)
    try:
        for want in served:
            piped.run()
            np.testing.assert_array_equal(piped.minibatch_indices.mem, want)
        assert sync.epoch_ended and piped.epoch_ended
        state = sync.state_dict()
        got = piped.state_dict()
        assert {k: v for k, v in got.items() if k != "shuffled"} == \
            {k: v for k, v in state.items() if k != "shuffled"}
        for c in state["shuffled"]:
            np.testing.assert_array_equal(got["shuffled"][c],
                                          state["shuffled"][c])
        for _ in range(3):                 # run ahead, then restore
            piped.run()
        piped.load_state_dict(state)
        assert piped.pipeline._thread is None
        for _ in range(5):
            sync.run()
            piped.run()
            np.testing.assert_array_equal(piped.minibatch_indices.mem,
                                          sync.minibatch_indices.mem)
            np.testing.assert_array_equal(piped.minibatch_data.mem,
                                          sync.minibatch_data.mem)
    finally:
        assert piped.pipeline.stop()


# -- the native gather ---------------------------------------------------------

@pytest.mark.parametrize("rows,real,n_threads,dtype", [
    (1, 1, 0, np.float32),       # one row
    (7, 5, 8, np.float32),       # fewer rows than threads, -1 padding
    (63, 63, 8, np.uint8),       # just under the threaded path
    (131, 128, 8, np.float32),   # odd, threaded, ragged last chunk
    (129, 100, 3, np.float64),   # odd thread count, padding
    (1000, 999, 0, np.int32),    # the default thread count
])
def test_gather_rows_matches_numpy(rows, real, n_threads, dtype):
    rng = np.random.default_rng(rows)
    src = (rng.normal(size=(257, 5, 3)) * 50).astype(dtype)
    idx = np.full(rows, -1, np.int64)
    idx[:real] = rng.integers(0, 257, real)
    dst = np.full((rows, 5, 3), 9, dtype)
    native.gather_rows(src, idx, dst, n_threads=n_threads)
    want = np.zeros_like(dst)
    want[:real] = src[idx[:real]]
    np.testing.assert_array_equal(dst, want)


def test_gather_rows_checks_its_arguments():
    src = np.zeros((10, 4), np.float32)
    dst = np.zeros((3, 4), np.float32)
    idx = np.zeros(3, np.int64)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_rows(src[:, ::2], idx, np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError, match="rows differ"):
        native.gather_rows(src, idx, dst.astype(np.float64))
    with pytest.raises(ValueError, match="indices for"):
        native.gather_rows(src, np.zeros(4, np.int64), dst)
    with pytest.raises(ValueError, match="past 10 rows"):
        native.gather_rows(src, np.array([0, 10, -1]), dst)


def test_loaders_gather_through_the_native_core(monkeypatch):
    """fill_minibatch and fill_batch go through gather_rows and serve
    what numpy fancy indexing gives; a non-contiguous source takes numpy,
    as the reference's does."""
    calls = []
    orig = native.gather_rows

    def counted(*a, **kw):
        calls.append(a[1].size)
        return orig(*a, **kw)
    monkeypatch.setattr(native, "gather_rows", counted)
    loader = _standalone_loader()
    loader.run()
    idx = loader.minibatch_indices.mem
    np.testing.assert_array_equal(loader.minibatch_data.mem,
                                  loader.original_data.mem[idx])
    out = loader.fill_batch(idx, 20, loader.minibatch_class)
    np.testing.assert_array_equal(out["data"], loader.minibatch_data.mem)
    assert calls == [20, 20]
    src = np.asfortranarray(loader.original_data.mem)
    dst = np.full((20,) + src.shape[1:], 5, src.dtype)
    idx = idx.copy()
    idx[15:] = -1
    fullbatch._gather(src, idx, 15, dst)
    assert calls == [20, 20]
    np.testing.assert_array_equal(dst[:15], src[idx[:15]])
    assert not dst[15:].any()


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No quiet numpy: a compiler that cannot run raises with the cause."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.gather_rows(np.zeros((2, 2), np.float32),
                           np.zeros(2, np.int64),
                           np.zeros((2, 2), np.float32))
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_native_compile_raises_with_the_compiler_output(monkeypatch,
                                                              tmp_path):
    bad = tmp_path / "loader_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build()


@pytest.mark.cuda
def test_ring_slots_are_pinned_on_the_card():
    """On the card the ring's slots are pinned host memory, depth + 2 of
    them, and the stager's copies leave on the side stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prng.seed_all(5)
    loader = SyntheticClassifierLoader(
        None, n_classes=4, sample_shape=(8,), n_train=400, n_valid=0,
        minibatch_size=20)
    loader.initialize(device=TorchDevice())
    pf = attach_prefetcher(loader, stager=lambda rec, arrays: (None, 0),
                           depth=2)
    try:
        for _ in range(9):
            pf.next_batch()
        bufs = loader._rings["data"]["bufs"]
        assert len(bufs) == 4
        assert all(torch.from_numpy(b).is_pinned() for b in bufs)
    finally:
        pf.stop()


def test_ring_slot_is_plain_numpy_off_the_card():
    loader = _standalone_loader()
    slot = loader._ring_slot((4, 3), np.float32)
    assert isinstance(slot, np.ndarray) and slot.shape == (4, 3)
