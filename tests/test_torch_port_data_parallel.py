"""Data parallel of the port's fused step (``znicz_tpu_torch/parallel/
step.py`` over ``parallel/mesh.py`` and ``parallel/zero.py``) on gloo
worlds of 2 and 4 processes, against the JAX package on a mesh of the
same size (``data_parallel_mesh(n)`` over the virtual CPU devices, XLA
updates as ``tests/test_zero_sharding.py`` runs them):

- the layout matrix of ``test_zero_sharding.py:42`` (replicated,
  ``shard_update``, ``shard_params``; SGD and AdamW) at each world size:
  identical metric histories and weights and momenta within the MNIST
  FC bands of the JAX run; ``shard_update`` within the reference's own
  2e-5 / 1e-6 of replicated, and ``shard_params`` bit-identical to
  ``shard_update``; every rank holding the same weights;
- the composition with accumulation and EMA (``:208``) and with the
  epoch scan and bf16 velocity (``:339``);
- the ZeRO memory gauges at 1/n and the gathered-bytes counter
  (``:163``);
- ``quantized_collectives`` (int8 with error feedback, bf16) in the
  replicated and shard_params layouts against the JAX package's run of
  the same codec (histories, weights, momenta and the residual slabs),
  and mode=off bit-identical to a step built without the option;
- the cross-world resume: 2 -> 1, 1 -> 2 and 2 -> 4 against the
  uninterrupted run (``test_snapshotter.py:87``: the same history,
  weights within 1e-4 / 1e-5), the error-feedback residuals' fold
  (``test_zero_sharding.py:533``), and a world-2 snapshot of the port
  resumed by the JAX package on a mesh of 2;
- per-rank generator streams, and a CUDA step's refusal of a gloo
  group.

Each world is one module-scoped spawn of gloo processes
(``tests/_torch_dp_world.py``) that runs the whole matrix; the JAX runs
and the world-of-one runs are made here.  The initial weights of the
runs held against the JAX package are the JAX run's (``load_forward_
params``), with its host PRNG state after initialize.
"""

import numpy as np
import pytest
import torch

import _torch_dp_world as world
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.models import mnist_fc as jmnist
from znicz_tpu.parallel.mesh import data_parallel_mesh as jmesh
from znicz_tpu.snapshotter import collect_state as jcollect
from znicz_tpu.snapshotter import restore_state as jrestore
from znicz_tpu.snapshotter import write_snapshot as jwrite

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.models import mnist_fc as tmnist
from znicz_tpu_torch.parallel import mesh as tmesh
from znicz_tpu_torch.parallel.step import FusedTrainStep
from znicz_tpu_torch.snapshotter import (collect_state, restore_state,
                                         write_snapshot)

#: port against the JAX package, by optimizer: the MNIST FC bands in
#: force (ROADMAP.md "The parity bands in force"), weights and momenta
WEIGHT_ATOL = {"sgd": 1e-6, "adam": 2e-3}
#: shard_update against replicated: the reference's own pin
#: (tests/test_zero_sharding.py:78)
LAYOUT_RTOL, LAYOUT_ATOL = 2e-5, 1e-6
#: EMA mirrors against the JAX run (tests/test_optimizers.py:548)
EMA_ATOL = 1e-6
#: a resume at another world size against the uninterrupted run
#: (tests/test_snapshotter.py:136)
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-5

LAYOUTS = ("replicated", "shard_update", "shard_params")
OPTIMIZERS = ("sgd", "adam")
WORLDS = (2, 4)

#: tests/test_zero_sharding.py:42's configuration
MATRIX = dict(fn="mnist", seed=31, layers=(23,), minibatch=32,
              n_train=160, n_valid=64, epochs=3, init="m31")
#: :208's (accumulation and EMA)
ACC = dict(fn="mnist", seed=17, layers=(12,), minibatch=16, n_train=96,
           n_valid=32, epochs=2, init="acc",
           options={"accumulate_steps": 2, "ema_decay": 0.9})
#: :339's (the epoch scan and bf16 velocity)
SCAN = dict(MATRIX, epochs=2, scan_epoch=True,
            options={"optimizer_config": {"state_dtype": "bfloat16"}})
#: the snapshot runs (tests/test_zero_sharding.py:25 _build): 2 epochs,
#: snapshot, on to 4
RES = dict(fn="mnist", seed=7, layers=(16,), minibatch=16, n_train=64,
           n_valid=0, epochs=4, optimizer="adam")
QC = {"mode": "int8", "chunk": 64, "error_feedback": True}
#: the codecs of the step runs held against the JAX package's
#: (tests/test_zero_sharding.py:460): int8 with error feedback, bf16
CODECS = {"int8": {"mode": "int8", "error_feedback": True},
          "bf16": {"mode": "bf16"}}
#: the layouts they run in: the exact gradient sum's codec path, and the
#: codec inside the shard_params regather as well
QC_LAYOUTS = ("replicated", "shard_params")
#: a quantized run's epoch is one train step and one eval: the port
#: steps from the JAX run's state at epoch 0 (its init) and at epoch 1
#: (its snapshot), and each step is held against the JAX run's next one
QC_STEP = dict(MATRIX, n_train=32, n_valid=32, init="qc")
#: the same with two accumulated half-steps an update
QC_ACC = dict(QC_STEP, n_train=64, init="qc-acc",
              options={"accumulate_steps": 2})
#: a rank's residual against the JAX rank's after one step: the
#: gradients' own f32 noise (1 ulp of the largest residual seen is
#: ~4e-9; the noise of a gradient element's sum order ~1e-6)
RES_ATOL = 1e-5
#: the share of a state's elements (every leaf's weights, or momenta,
#: or every rank's residuals) that the codec's rounding flips may move
#: past their band: where the two packages' gradients differ by an ulp
#: across a rounding boundary of the codec (an int8 step or a bf16
#: half-ulp), the element's payload differs by one step, and its
#: residual, weight and momentum with it (at most 38 of 73,180
#: residuals, 5.2e-4, measured in a step of these runs)
FLIP_SHARE = 1e-3


def _jax_build(cfg, n, **kw):
    jprng.seed_all(cfg["seed"])
    layouts = {"replicated": {}, "shard_update": {"shard_update": True},
               "shard_params": {"shard_params": True}}
    return jmnist.build_fused(
        max_epochs=kw.pop("epochs", cfg["epochs"]),
        layers=cfg["layers"], minibatch_size=cfg["minibatch"],
        n_train=cfg["n_train"], n_valid=cfg["n_valid"], mesh=jmesh(n),
        optimizer=cfg.get("optimizer", "sgd"),
        **layouts[cfg.get("layout", "replicated")],
        **cfg.get("options", {}), **kw)


def _jax_init(cfg) -> dict:
    """The JAX run's initial weights and host PRNG state after
    initialize, for the port's runs of ``cfg``."""
    w = _jax_build(cfg, 1)
    w.initialize(device=TPUDevice())
    return {"params": [{"w": f.weights.map_read().copy(),
                        "b": f.bias.map_read().copy()} for f in w.forwards],
            "state": jprng.get().state_dict()}


def _jax_run(cfg, n, restore=None, epochs=None) -> dict:
    w = _jax_build(cfg, n, epochs=epochs or cfg["epochs"])
    w.initialize(device=TPUDevice())
    if restore is not None:
        jrestore(w, restore)
        w.decision.complete.set(False)
    w.run()
    w.step.sync_to_units()
    out = {"hist": [(h.get("metric_train"), h.get("metric_validation"))
                    for h in w.decision.metrics_history],
           "w": [np.asarray(a.map_read()).copy() for f in w.forwards
                 for a in (f.weights, f.bias)],
           "v": [np.asarray(a.map_read()).copy() for g in w.gds
                 for a in (g.gradient_weights, g.gradient_bias)]}
    if w.step.ema_decay is not None:
        out["ema"] = w.step.ema_params()
    return out


def _jax_state(w) -> dict:
    w.step.sync_to_units()
    return {"hist": [(h.get("metric_train"), h.get("metric_validation"))
                     for h in w.decision.metrics_history],
            "w": [np.asarray(a.map_read()).copy() for f in w.forwards
                  for a in (f.weights, f.bias)],
            "v": [np.asarray(a.map_read()).copy() for g in w.gds
                  for a in (g.gradient_weights, g.gradient_bias)],
            "residuals": {k: v for k, v in
                          w.step.extra_state_arrays().items()
                          if k.endswith((".rw", ".rb"))}}


def _jax_two_epochs(cfg, n, snapshot) -> tuple:
    """The JAX run of ``cfg`` on a mesh of n: its state after epoch 1
    (written to ``snapshot`` too) and after epoch 2."""
    w = _jax_build(cfg, n, epochs=1)
    w.initialize(device=TPUDevice())
    w.run()
    one = _jax_state(w)
    jwrite(snapshot, *jcollect(w))
    w.decision.max_epochs = 2
    w.decision.complete.set(False)
    w.run()
    return one, _jax_state(w)


def _port_build(cfg, epochs, **options):
    tprng.seed_all(cfg["seed"])
    return tmnist.build_fused(
        max_epochs=epochs, layers=cfg["layers"],
        minibatch_size=cfg["minibatch"], n_train=cfg["n_train"],
        n_valid=cfg["n_valid"], optimizer=cfg.get("optimizer", "sgd"),
        **options)


def _port_weights(w):
    w.step.sync_to_units()
    return [np.asarray(a.map_read()).copy() for f in w.forwards
            for a in (f.weights, f.bias)]


def _hist(w):
    return [(h.get("metric_train"), h.get("metric_validation"))
            for h in w.decision.metrics_history]


def _qc_configs() -> dict:
    """The quantized step runs held against the JAX package's, by
    name."""
    out = {}
    for opt in OPTIMIZERS:
        for codec, config in CODECS.items():
            for layout in QC_LAYOUTS:
                out[f"qc-{opt}-{codec}-{layout}"] = dict(
                    QC_STEP, optimizer=opt, layout=layout,
                    options={"quantized_collectives": config})
    for layout in QC_LAYOUTS:
        out[f"qc-acc-{layout}"] = dict(
            QC_ACC, layout=layout,
            options=dict(QC_ACC["options"],
                         quantized_collectives=CODECS["int8"]))
    return out


def _case_list(n, paths):
    """The cases every rank of a world of ``n`` runs, by name."""
    cases = {}
    for opt in OPTIMIZERS:
        for layout in LAYOUTS:
            cases[f"{opt}-{layout}"] = dict(MATRIX, optimizer=opt,
                                            layout=layout)
    for layout in LAYOUTS:
        cases[f"acc-{layout}"] = dict(ACC, layout=layout)
    for layout in LAYOUTS[1:]:
        cases[f"scan-{layout}"] = dict(SCAN, layout=layout)
    for name, cfg in _qc_configs().items():
        cases[f"{name}-e1"] = dict(cfg, epochs=1)
        cases[f"{name}-e2"] = dict(cfg, epochs=2, restore=paths[(n, name)])
    for name, options in (("host", {}), ("host-pipe", {"pipeline_depth": 2})):
        cases[name] = dict(MATRIX, optimizer="sgd", layout="shard_params",
                           host_fed=True, options=options)
    cases["gen"] = dict(RES, fn="generator")
    cases["backend"] = {"fn": "backend"}
    if n == 2:
        cases["via-psum"] = dict(MATRIX, optimizer="sgd",
                                 layout="shard_params", via_psum=True)
        cases["off"] = dict(MATRIX, optimizer="sgd",
                            options={"quantized_collectives":
                                     {"mode": "off"}})
        cases["bf16"] = dict(MATRIX, optimizer="sgd", options={
            "quantized_collectives": {"mode": "bf16",
                                      "error_feedback": False}})
        cases["snap"] = dict(RES, snapshot=paths["w2"], snapshot_epochs=2)
        cases["snap-sp"] = dict(RES, layout="shard_params",
                                snapshot=paths["w2sp"], snapshot_epochs=2)
        cases["from-1"] = dict(RES, restore=paths["w1"])
        cases["ef"] = dict(RES, layout="shard_params",
                           options={"quantized_collectives": QC},
                           snapshot=paths["ef"], snapshot_epochs=2)
    else:
        cases["from-2sp"] = dict(RES, restore=paths["w2sp"])
        cases["fold"] = dict(RES, restore=paths["ef"],
                             options={"quantized_collectives": QC})
    return cases


@pytest.fixture(scope="module")
def dp(tmp_path_factory, cpu_devices):
    """Both worlds' results (name -> per-rank results), the snapshot
    paths, and the world-of-one runs: its 2-epoch snapshot (resumed at
    world 2) and its uninterrupted run."""
    tmp = tmp_path_factory.mktemp("dp")
    paths = {k: str(tmp / f"{k}.npz") for k in ("w1", "w2", "w2sp", "ef")}
    inits = {"m31": _jax_init(MATRIX), "acc": _jax_init(ACC),
             "qc": _jax_init(QC_STEP), "qc-acc": _jax_init(QC_ACC)}
    jax_qc = {}
    for n in WORLDS:
        for name, cfg in _qc_configs().items():
            paths[(n, name)] = str(tmp / f"jax-{n}-{name}.npz")
            jax_qc[(n, name)] = _jax_two_epochs(cfg, n, paths[(n, name)])
    w = _port_build(RES, 2)
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    write_snapshot(paths["w1"], *collect_state(w))
    w1 = _port_build(RES, 4)
    w1.initialize(device=TorchDevice("cpu"))
    w1.run()
    out = {"paths": paths, "jax_qc": jax_qc,
           "w1": {"hist": _hist(w1), "w": _port_weights(w1)}}
    for n in WORLDS:
        cases = _case_list(n, paths)
        ranks = world.run_world(n, list(cases.values()), inits)
        out[n] = {name: [r[i] for r in ranks]
                  for i, name in enumerate(cases)}
    return out


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_layouts_match_jax_mesh(dp, n, optimizer):
    """Every layout at world n against the JAX package's replicated run
    on a mesh of n: the same histories, weights and momenta within the
    optimizer's band; every rank holds the same weights."""
    want = _jax_run(dict(MATRIX, optimizer=optimizer), n)
    for layout in LAYOUTS:
        ranks = dp[n][f"{optimizer}-{layout}"]
        got = ranks[0]
        assert got["hist"] == want["hist"], layout
        for key in ("w", "v"):
            for a, b in zip(got[key], want[key]):
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=WEIGHT_ATOL[optimizer],
                    err_msg=f"{layout}/{key}")
        for other in ranks[1:]:
            for a, b in zip(other["w"], got["w"]):
                np.testing.assert_array_equal(a, b, err_msg=layout)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_shard_params_bit_identical_to_shard_update(dp, n, optimizer):
    """Within the port: shard_update within the reference's band of
    replicated, shard_params bit for bit shard_update (the regather is
    data movement, the slice update the same elementwise math)."""
    runs = {layout: dp[n][f"{optimizer}-{layout}"][0] for layout in LAYOUTS}
    assert runs["shard_update"]["hist"] == runs["replicated"]["hist"]
    for key in ("w", "v"):
        for a, b in zip(runs["shard_update"][key],
                        runs["replicated"][key]):
            np.testing.assert_allclose(a, b, rtol=LAYOUT_RTOL,
                                       atol=LAYOUT_ATOL)
        for a, b in zip(runs["shard_params"][key],
                        runs["shard_update"][key]):
            np.testing.assert_array_equal(a, b)
    # the layouts really are the sharded ones: flat 1/n slices
    size = 784 * 23
    shapes = runs["shard_params"]["leaf_shapes"][0]
    assert shapes["w"] == shapes["vw"] == (-(-size // n),)
    assert runs["shard_update"]["leaf_shapes"][0]["w"] == (784, 23)
    assert runs["shard_update"]["leaf_shapes"][0]["vw"] == \
        (-(-size // n),)


@pytest.mark.parametrize("n", WORLDS)
def test_accumulation_and_ema_compose_with_layouts(dp, n):
    """accumulate_steps 2 and EMA 0.9 in every layout: the replicated
    run against the JAX package's (history, EMA mirrors within 1e-6),
    shard_params against replicated within the layout band and bit for
    bit against shard_update."""
    want = _jax_run(ACC, n)
    runs = {layout: dp[n][f"acc-{layout}"][0] for layout in LAYOUTS}
    assert runs["replicated"]["hist"] == want["hist"]
    for a, b in zip(runs["replicated"]["ema"], want["ema"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=EMA_ATOL)
    for layout in LAYOUTS[1:]:
        assert runs[layout]["hist"] == runs["replicated"]["hist"]
        for a, b in zip(runs[layout]["ema"], runs["replicated"]["ema"]):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k], b[k], rtol=LAYOUT_RTOL,
                                           atol=LAYOUT_ATOL)
    for a, b in zip(runs["shard_params"]["ema"],
                    runs["shard_update"]["ema"]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n", WORLDS)
def test_scan_epoch_and_state_dtype_compose(dp, n):
    """The epoch scan with bf16 velocity: shard_params bit for bit
    shard_update, the velocity stored bf16, and the regather counted a
    scanned minibatch (the counter moves by a multiple of one
    dispatch's bytes)."""
    su, sp = dp[n]["scan-shard_update"][0], dp[n]["scan-shard_params"][0]
    assert sp["vw_dtype"] == su["vw_dtype"] == "torch.bfloat16"
    assert sp["hist"] == su["hist"]
    for a, b in zip(sp["w"], su["w"]):
        np.testing.assert_array_equal(a, b)
    per_dispatch = sp["gather_nbytes"]
    dispatches = SCAN["epochs"] * (SCAN["n_train"] + SCAN["n_valid"]) \
        // SCAN["minibatch"]
    assert per_dispatch > 0
    assert sp["gathered_delta"] == per_dispatch * dispatches


@pytest.mark.parametrize("n", WORLDS)
def test_zero_memory_gauges_at_one_nth(dp, n):
    """Per-rank persistent bytes (params + optimizer state) under
    shard_params at most 1/n of replicated's plus the padding epsilon;
    every dispatch gathers the static figure; replicated gathers
    nothing."""
    rep, sp = dp[n]["adam-replicated"][0], dp[n]["adam-shard_params"][0]
    n_sharded = sum(1 for leaf in sp["leaf_shapes"] for k in leaf
                    if k not in ("t",))
    eps = 4 * (n - 1) * n_sharded
    total = sp["param_bytes"] + sp["opt_bytes"]
    assert total <= (rep["param_bytes"] + rep["opt_bytes"]) / n + eps
    dispatches = MATRIX["epochs"] * (MATRIX["n_train"] +
                                     MATRIX["n_valid"]) // MATRIX["minibatch"]
    assert sp["gathered_delta"] == sp["gather_nbytes"] * dispatches > 0
    assert rep["gathered_delta"] == rep["gather_nbytes"] == 0


@pytest.mark.parametrize("n", WORLDS)
def test_host_fed_ranks_upload_their_own_rows(dp, n):
    """With the data set on the host, each rank cuts its rows of the
    minibatch before the upload, on the synchronous path and through the
    pipeline's stager: the step sees minibatch/n rows and trains bit for
    bit as with the data set pinned on the device."""
    want = dp[n]["sgd-shard_params"][0]
    assert want["dispatched_rows"] == [MATRIX["minibatch"] // n]
    for name in ("host", "host-pipe"):
        for got in dp[n][name]:
            assert got["dispatched_rows"] == [MATRIX["minibatch"] // n]
            assert got["hist"] == want["hist"], name
            for a, b in zip(got["w"], want["w"]):
                np.testing.assert_array_equal(a, b, err_msg=name)


def test_gather_via_psum_matches_the_all_gather(dp):
    """``engine.zero_gather_via_psum`` regathers the shard_params leaves
    through ``zero.psum_regather`` (a sum over zero buffers) and trains
    as the all-gather does (tests/test_zero_sharding.py:303)."""
    got, want = dp[2]["via-psum"][0], dp[2]["sgd-shard_params"][0]
    assert got["hist"] == want["hist"]
    for a, b in zip(got["w"], want["w"]):
        np.testing.assert_array_equal(a, b)


def _flat(arrays) -> np.ndarray:
    return np.concatenate([np.ravel(a) for a in arrays])


def _flip_bounded(got, want, atol, what) -> int:
    """Every element of ``got`` within ``atol`` of ``want`` but for a
    share of at most FLIP_SHARE; returns the count past the band."""
    far = int((np.abs(got - want) > atol).sum())
    assert far <= FLIP_SHARE * np.size(want), \
        f"{what}: {far} of {np.size(want)} elements past {atol}"
    return far


def _hold_quantized(dp, n, name, atol) -> None:
    """The port's step of ``name`` on a world of n, from the JAX run's
    init (epoch 1) and from its epoch-1 snapshot (epoch 2), against the
    JAX run's state after that step: the same histories, and weights,
    momenta and every rank's residuals within their bands up to the
    codec's rounding flips; every rank holds the same weights."""
    for epoch, want in zip(("e1", "e2"), dp["jax_qc"][(n, name)]):
        ranks = dp[n][f"{name}-{epoch}"]
        got, what = ranks[0], f"{name}/{epoch}"
        assert got["hist"] == want["hist"], what
        for key in ("w", "v"):
            _flip_bounded(_flat(got[key]), _flat(want[key]), atol,
                          f"{what}/{key}")
        res = {k: v for k, v in got["extra"].items()
               if k.endswith((".rw", ".rb"))}
        keys = sorted(want["residuals"])
        assert sorted(res) == keys != [], what
        for k in keys:
            assert res[k].shape[0] == n and np.abs(res[k]).max() > 0, what
        _flip_bounded(_flat(res[k] for k in keys),
                      _flat(want["residuals"][k] for k in keys), RES_ATOL,
                      f"{what}/residuals")
        for other in ranks[1:]:
            for a, b in zip(other["w"], got["w"]):
                np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_quantized_steps_match_jax_mesh(dp, n, optimizer, codec):
    """The step with ``quantized_collectives`` at world n, replicated
    (the codec's gradient sum, its residuals carried a rank) and under
    shard_params (the codec inside the regather too), held step by step
    against the JAX package's run of the same layout and codec on a
    mesh of n (tests/test_zero_sharding.py:460)."""
    for layout in QC_LAYOUTS:
        _hold_quantized(dp, n, f"qc-{optimizer}-{codec}-{layout}",
                        WEIGHT_ATOL[optimizer])


@pytest.mark.parametrize("n", WORLDS)
def test_quantized_accumulation_matches_jax_mesh(dp, n):
    """int8 with error feedback and two accumulated half-steps an
    update: each half-step's sum goes through the codec with the
    residuals it carries, as in the JAX package's run."""
    for layout in QC_LAYOUTS:
        _hold_quantized(dp, n, f"qc-acc-{layout}", WEIGHT_ATOL["sgd"])


def test_quantized_off_is_bit_identical_and_codecs_train(dp):
    """mode=off is the exact step bit for bit; bf16 without error
    feedback moves the weights off the exact run but trains."""
    exact, off = dp[2]["sgd-replicated"][0], dp[2]["off"][0]
    bf16 = dp[2]["bf16"][0]
    assert off["hist"] == exact["hist"]
    for a, b in zip(off["w"], exact["w"]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b)
               for a, b in zip(bf16["w"], exact["w"]))
    assert all(np.isfinite(a).all() for a in bf16["w"])
    assert bf16["hist"][-1][1] <= bf16["hist"][0][1]


def test_resume_two_to_one(dp):
    """A world-2 snapshot resumed by one process: the history and the
    weights of the world-2 uninterrupted run, within the cross-world
    band."""
    want = dp[2]["snap"][0]
    w = _port_build(RES, 4)
    w.initialize(device=TorchDevice("cpu"))
    restore_state(w, dp["paths"]["w2"])
    w.decision.complete.set(False)
    w.run()
    assert _hist(w) == want["hist"]
    for a, b in zip(_port_weights(w), want["w"]):
        np.testing.assert_allclose(a, b, rtol=RESUME_RTOL,
                                   atol=RESUME_ATOL)


def test_resume_one_to_two(dp):
    """A world-of-one snapshot resumed by a world of 2."""
    got, want = dp[2]["from-1"][0], dp["w1"]
    assert got["hist"] == want["hist"]
    for a, b in zip(got["w"], want["w"]):
        np.testing.assert_allclose(a, b, rtol=RESUME_RTOL,
                                   atol=RESUME_ATOL)


def test_resume_two_to_four_across_layouts(dp):
    """A world-2 shard_params snapshot resumed replicated by a world of
    4: the state arrays hold the param shape whatever the layout."""
    got, want = dp[4]["from-2sp"][0], dp[2]["snap-sp"][0]
    assert got["hist"] == want["hist"]
    for a, b in zip(got["w"], want["w"]):
        np.testing.assert_allclose(a, b, rtol=RESUME_RTOL,
                                   atol=RESUME_ATOL)


def test_ef_residual_fold_across_world_sizes(dp):
    """The error-feedback slab of a world-2 int8 run: written as (2,
    *shape) and accrued; restored by a world of 4 its rank sum lands on
    rank 0 and the other rows are zero; restored by one process it is
    the sum itself; both runs go on finite."""
    slab = dp[2]["ef"][0]["snapshot_rw"]
    assert slab.shape == (2, 784, 16)
    want = slab.sum(axis=0)
    assert np.abs(want).max() > 0
    fold = dp[4]["fold"][0]
    got = fold["restored_extra"]["0.rw"]
    assert got.shape == (4, 784, 16)
    np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-7)
    assert np.abs(got[1:]).max() == 0.0
    assert all(np.isfinite(a).all() for a in fold["w"])
    w = _port_build(RES, 4, quantized_collectives=QC)
    w.initialize(device=TorchDevice("cpu"))
    restore_state(w, dp["paths"]["ef"])
    np.testing.assert_allclose(w.step._params[0]["rw"].numpy(), want,
                               rtol=1e-6, atol=1e-7)
    w.decision.complete.set(False)
    w.run()
    assert all(np.isfinite(a).all() for a in _port_weights(w))


def test_world_two_snapshot_resumes_in_the_jax_package(dp):
    """The port's world-2 snapshot, resumed by the JAX package on a
    mesh of 2: the history of the port's uninterrupted world-2 run, the
    weights within the AdamW band."""
    want = dp[2]["snap"][0]
    got = _jax_run(RES, 2, restore=dp["paths"]["w2"])
    assert got["hist"] == want["hist"]
    for a, b in zip(got["w"], want["w"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=WEIGHT_ATOL["adam"])


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_draw_their_own_streams(dp, n):
    """Each rank's generator is a stream of its own; rank 0's is the
    one an ungrouped step mints from the same seed."""
    draws = [r["draws"] for r in dp[n]["gen"]]
    for i in range(n):
        for j in range(i):
            assert not np.array_equal(draws[i], draws[j])
    w = _port_build(RES, 1)
    w.initialize(device=TorchDevice("cpu"))
    np.testing.assert_array_equal(
        torch.rand(8, generator=w.step._gen).numpy(), draws[0])


@pytest.mark.parametrize("n", WORLDS)
def test_cuda_step_refuses_a_gloo_group(dp, n):
    """A step on CUDA tensors over a gloo group raises when built (no
    CUDA graph can hold a gloo collective); the whole step on the card
    is in test_torch_port_multihost.py."""
    for r in dp[n]["backend"]:
        assert r["refused"] and "needs a nccl group" in r["refused"]


def test_mesh_constructors_and_refusals():
    """The mesh outside a world is a mesh of one; other sizes raise,
    the pipeline's axes and DCN axes too (they build like any axis: the
    pipeline step's worlds are tests/test_torch_port_pipe_expert.py, the
    transformer's seq and model axes tests/test_torch_port_lm_axes.py);
    the fused step refuses every axis but data."""
    m = tmesh.data_parallel_mesh()
    assert (m.shape, m.rank, m.group) == ({"data": 1}, 0, None)
    assert tmesh.make_mesh({"data": 1, "seq": 1}).size == 1
    assert tmesh.make_hybrid_mesh({"data": 1}).size == 1
    assert tmesh.make_hybrid_mesh({"data": 1, "expert": 1},
                                  {"expert": 1}).size == 1
    for bad in (lambda: tmesh.data_parallel_mesh(2),
                lambda: tmesh.make_mesh({"data": 1, "model": 2}),
                lambda: tmesh.make_mesh({"data": 1, "expert": 2}),
                lambda: tmesh.make_hybrid_mesh({"data": 2}, {"data": 2})):
        with pytest.raises(ValueError, match="world of 1"):
            bad()
    with pytest.raises(NotImplementedError, match="fused step"):
        tmesh.resolve({"data": 1, "pipe": 2})
    with pytest.raises(ValueError, match="dcn axes"):
        tmesh.make_hybrid_mesh({"data": 1}, {"seq": 1})
    tmesh.check_backend(m, torch.device("cuda"))    # no group, no check


def test_step_refusals_left():
    """donate=False still raises, with its reason; anatomy builds and
    refuses accumulation in the reference's words."""
    with pytest.raises(ValueError, match="donation"):
        FusedTrainStep(None, donate=False)
    assert _port_build(RES, 1, anatomy=True).step.anatomy
    w = _port_build(RES, 1, anatomy=True, accumulate_steps=2)
    with pytest.raises(ValueError, match="requires accumulate_steps == 1"):
        w.initialize(device=TorchDevice("cpu"))


def test_minibatch_not_divisible_raises():
    """The world's size must divide the minibatch, as in the reference
    (parallel/step.py:1173)."""
    w = _port_build(RES, 1)
    w.step.mesh = tmesh.DataMesh(1)
    w.step.mesh.shape["data"] = 3        # a world of 3 (16 rows)
    with pytest.raises(ValueError, match="not divisible"):
        w.initialize(device=TorchDevice("cpu"))
