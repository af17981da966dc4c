"""The port's snapshots (``znicz_tpu_torch/snapshotter.py`` and the fused
step's hooks) on the CPU, and snapshots crossing between the packages.

- Port to port: resume from the epoch-2 snapshot of a 4-epoch run gives
  the uninterrupted run's history and weights bit for bit, eager and
  fused (SGD, AdamW with EMA, a conv net with dropout, whose draws come
  from the step's generator, saved as ``step.generator``); the array
  round trip; the Kohonen workflow; only-improved and the latest
  symlink; the checksum, a corrupt or tampered file, a retried write
  fault and a failing write that keeps the previous snapshot; the
  architecture, optimizer and EMA mismatches; a restore into a step
  that has already stepped (the in-place path the captured CUDA graphs
  need).
- Across packages: a snapshot written by the JAX package restores into
  the port with every array, the loader, the Decision and the host PRNG
  identical, and the port's restores into the JAX package the same way;
  then both continue one epoch, within the fused bands of ROADMAP's
  parity table: identical n_err, weights within 1e-6 (SGD, the conv
  net), 5e-4 (bf16 velocity), 2e-3 (AdamW).  Where a forward draws,
  both packages take the same seeded numpy uniforms.  The two
  packages' snapshots of one workflow have the same keys but the step's
  random state: the reference's ``step.key``, the port's
  ``step.generator``.  The JAX side runs XLA (no Pallas kernel is on its
  fused path without ``engine.pallas``).
"""

import collections
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.snapshotter import collect_state as jcollect
from znicz_tpu.snapshotter import restore_state as jrestore
from znicz_tpu.standard_workflow import StandardWorkflow as JStandard

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.launcher import resume
from znicz_tpu_torch.models import kohonen as tkohonen
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.snapshotter import (FORMAT_VERSION,
                                         SnapshotCorruptError,
                                         collect_state, content_checksum,
                                         process_rank_world, restore_state,
                                         verify_snapshot, write_snapshot)
from znicz_tpu_torch.standard_workflow import StandardWorkflow as TStandard

HYPER = {"learning_rate": 0.05, "gradient_moment": 0.9}
#: MNIST FC's topology at a narrow width (28x28 -> 32 tanh -> 10)
FC_LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 32},
              "<-": dict(HYPER)},
             {"type": "softmax", "->": {"output_sample_shape": 10},
              "<-": dict(HYPER)}]
FC_LOADER = {"n_classes": 10, "sample_shape": (28, 28), "n_train": 200,
             "n_valid": 100, "minibatch_size": 50, "spread": 2.5,
             "noise": 1.0}
#: a narrow fused conv net with two dropout layers (each train step
#: draws one uniform tensor a dropout layer)
CONV_LAYERS = [
    {"type": "conv_str", "->": {"n_kernels": 4, "kx": 3, "ky": 3},
     "<-": dict(HYPER)},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "all2all_str", "->": {"output_sample_shape": 16},
     "<-": dict(HYPER)},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "softmax", "->": {"output_sample_shape": 5},
     "<-": dict(HYPER)}]
CONV_LOADER = {"n_classes": 5, "sample_shape": (12, 12, 3), "n_train": 40,
               "n_valid": 20, "minibatch_size": 10, "spread": 1.0,
               "noise": 0.5}
#: case -> (layers, loader_name, loader config, StandardWorkflow kwargs)
CASES = {
    "sgd": (FC_LAYERS, "synthetic_classifier", FC_LOADER, {}),
    "adam_ema": (FC_LAYERS, "synthetic_classifier", FC_LOADER,
                 {"optimizer": "adam", "ema_decay": 0.9}),
    "bf16": (FC_LAYERS, "synthetic_classifier", FC_LOADER,
             {"optimizer_config": {"state_dtype": "bfloat16"}}),
    "conv_dropout": (CONV_LAYERS, "synthetic_image", CONV_LOADER, {}),
}
#: port vs reference after one epoch from the same snapshot (ROADMAP's
#: fused bands): f32 both sides, summation order only for SGD and the
#: conv net; a bf16 velocity element an ulp off rounds to a neighbouring
#: bf16 value; AdamW divides by the RMS of near-cancelling sums
WEIGHT_ATOL = {"sgd": 1e-6, "adam_ema": 2e-3, "bf16": 5e-4,
               "conv_dropout": 1e-6}
EPOCHS, SNAP_EPOCH, SEED = 3, 2, 77


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    faults.uninstall()


def build(case="sgd", max_epochs=4, snap_dir=None, fused=True, seed=SEED,
          jax_side=False, **snap_kw):
    """A fresh, initialized workflow of ``case`` in either package."""
    layers, loader_name, loader, kw = CASES[case]
    (jprng if jax_side else tprng).seed_all(seed)
    cfg = None
    if snap_dir is not None:
        cfg = {"directory": str(snap_dir), "prefix": "t",
               "only_improved": False, "keep_all": True, **snap_kw}
    w = (JStandard if jax_side else TStandard)(
        name="SnapTest", layers=layers, loss_function="softmax",
        loader_name=loader_name, loader_config=dict(loader),
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=cfg, fused=fused, **kw)
    w.initialize(device=TPUDevice() if jax_side else TorchDevice("cpu"))
    return w


def _weights(w):
    return {f"{f.name}.{a}": getattr(f, a).map_read().copy()
            for f in w.forwards for a in ("weights", "bias")
            if getattr(f, a, None)}


def _snapshot_arrays(path):
    with np.load(path, allow_pickle=False) as zf:
        meta = json.loads(str(zf["__meta__"]))
        return {k: zf[k] for k in zf.files if k != "__meta__"}, meta


# -- port to port ------------------------------------------------------------

@pytest.mark.parametrize("case,fused", [("sgd", True), ("sgd", False),
                                        ("adam_ema", True),
                                        ("conv_dropout", True)])
def test_resume_is_bit_exact(tmp_path, case, fused):
    full = build(case, 4, tmp_path, fused=fused)
    full.run()
    assert len(full.decision.metrics_history) == 4
    snap2 = tmp_path / "t_2.npz"
    assert snap2.exists(), sorted(os.listdir(tmp_path))
    res = build(case, 4, fused=fused)
    meta = restore_state(res, str(snap2))
    assert meta["loader"]["epoch_number"] == 2
    res.run()
    assert res.decision.metrics_history == full.decision.metrics_history
    full.stop()
    res.stop()
    for k, v in _weights(full).items():
        np.testing.assert_array_equal(_weights(res)[k], v, err_msg=k)
    if case == "adam_ema":
        for a, b in zip(full.step.ema_params(), res.step.ema_params()):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_dropout_resume_needs_the_generator_state(tmp_path):
    """The conv net's dropout draws from the step's generator: without
    ``step.generator`` the resumed run draws the initialize-time stream
    again and its history leaves the uninterrupted run's."""
    full = build("conv_dropout", 4, tmp_path)
    full.run()
    arrays, meta = _snapshot_arrays(tmp_path / "t_2.npz")
    assert arrays["step.generator"].dtype == np.uint8
    assert "step.key" not in arrays
    del arrays["step.generator"]
    path = str(tmp_path / "no_gen.npz")
    write_snapshot(path, arrays, {k: v for k, v in meta.items()
                                  if k != "checksum"})
    res = build("conv_dropout", 4)
    restore_state(res, path)
    res.run()
    assert res.decision.metrics_history[:2] == \
        full.decision.metrics_history[:2]
    res.stop()
    full.stop()
    assert any(not np.array_equal(v, _weights(res)[k])
               for k, v in _weights(full).items())


def test_snapshot_roundtrip_arrays(tmp_path):
    w = build("sgd", 1)
    w.run()
    arrays, meta = collect_state(w)
    assert meta["format_version"] == FORMAT_VERSION
    assert meta["optimizer"] == "sgd"
    assert {"forward.0.weights", "forward.0.bias", "gd.0.gradient_weights",
            "gd.1.gradient_bias", "step.generator"} <= set(arrays)
    path = str(tmp_path / "s.npz")
    write_snapshot(path, arrays, meta)
    w2 = build("sgd", 1, seed=9)
    restore_state(w2, path)
    w2.step.sync_to_units()
    np.testing.assert_array_equal(w2.forwards[0].weights.map_read(),
                                  arrays["forward.0.weights"])
    np.testing.assert_array_equal(w2.gds[0].gradient_weights.map_read(),
                                  arrays["gd.0.gradient_weights"])
    np.testing.assert_array_equal(
        w2.step._gen.get_state().numpy(), arrays["step.generator"])


def test_extra_state_arrays_are_param_shaped_and_load_back():
    w = build("adam_ema", 1)
    w.run()
    extra = w.step.extra_state_arrays()
    assert sorted(extra) == ["0.eb", "0.ew", "0.sb", "0.sw", "0.t",
                             "1.eb", "1.ew", "1.sb", "1.sw", "1.t"]
    assert extra["0.sw"].shape == (28 * 28, 32) and extra["0.t"].shape == ()
    assert float(extra["1.t"]) == 4.0          # 4 train minibatches
    w2 = build("adam_ema", 1, seed=5)
    # the reference's error-feedback residuals have no home here: dropped
    w2.step.load_extra_state({**extra, "0.rw": np.ones((1, 2))})
    for k, v in w2.step.extra_state_arrays().items():
        np.testing.assert_array_equal(v, extra[k])
    with pytest.raises(ValueError, match="shape"):
        w2.step.load_extra_state({"0.sw": np.zeros((3, 3))})


def test_snapshot_kohonen_workflow(tmp_path):
    """KohonenTrainer sits in ``forwards`` with no bias: it contributes
    fewer arrays and restores all the same."""
    tprng.seed_all(23)
    w = tkohonen.build(max_epochs=2, shape=(6, 6), n_train=200)
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    arrays, meta = collect_state(w)
    assert "forward.0.weights" in arrays
    assert "forward.0.bias" not in arrays
    path = str(tmp_path / "som.npz")
    write_snapshot(path, arrays, meta)
    tprng.seed_all(9)
    w2 = tkohonen.build(max_epochs=2, shape=(6, 6), n_train=200)
    w2.initialize(device=TorchDevice("cpu"))
    restore_state(w2, path)
    np.testing.assert_array_equal(w2.trainer.weights.map_read(),
                                  arrays["forward.0.weights"])


def test_only_improved_and_latest_symlink(tmp_path):
    w = build("sgd", 3, tmp_path, only_improved=True, keep_all=False)
    w.run()
    snaps = [f for f in os.listdir(tmp_path) if not f.endswith("latest.npz")]
    # non-improving epochs skipped and old snapshots pruned: exactly one
    assert len(snaps) == 1, snaps
    latest = tmp_path / "t_latest.npz"
    assert os.readlink(latest) == snaps[0]
    assert w.snapshotter.destination == str(tmp_path / snaps[0])


def test_stale_temps_of_dead_writers_are_swept(tmp_path):
    dead = tmp_path / "t_1.npz.tmp.999999999"
    dead.write_bytes(b"torn")
    live = tmp_path / f"t_1.npz.tmp.{os.getppid()}"   # a live writer's
    live.write_bytes(b"live")
    w = build("sgd", 1, tmp_path)
    w.run()
    assert not dead.exists() and live.exists()


def test_process_rank_world_reads_the_elastic_env(monkeypatch):
    assert process_rank_world() == (0, 1)
    monkeypatch.setenv("ZNICZ_TPU_ELASTIC_RANK", "2")
    monkeypatch.setenv("ZNICZ_TPU_ELASTIC_WORLD", "4")
    assert process_rank_world() == (2, 4)


# -- crash-safe snapshots ------------------------------------------------------

def _written(tmp_path):
    w = build("sgd", 1)
    w.run()
    arrays, meta = collect_state(w)
    path = str(tmp_path / "s.npz")
    write_snapshot(path, arrays, meta)
    return path, arrays, meta


def test_snapshot_checksum_roundtrip_and_verify(tmp_path):
    path, arrays, _ = _written(tmp_path)
    assert verify_snapshot(path)
    meta2 = restore_state(build("sgd", 1, seed=9), path)
    assert int(meta2["checksum"]) == content_checksum(arrays) > 0


def test_corrupt_snapshot_detected(tmp_path):
    path, _, _ = _written(tmp_path)
    blob = bytearray(open(path, "rb").read())
    mid = len(blob) // 2
    blob[mid:mid + 64] = b"\x00" * 64          # bit rot in the middle
    with open(path, "wb") as f:
        f.write(bytes(blob))
    assert not verify_snapshot(path)
    with pytest.raises(Exception):
        restore_state(build("sgd", 1, seed=9), path)


def test_checksum_mismatch_raises_on_restore(tmp_path):
    """A valid zip with tampered content is caught by the checksum."""
    path, _, _ = _written(tmp_path)
    loaded, meta = _snapshot_arrays(path)
    loaded["forward.0.weights"] = loaded["forward.0.weights"] + 1.0
    with open(path, "wb") as f:
        np.savez_compressed(f, __meta__=np.array(json.dumps(meta)),
                            **loaded)
    assert not verify_snapshot(path)
    with pytest.raises(SnapshotCorruptError, match="checksum"):
        restore_state(build("sgd", 1, seed=9), path)


def test_snapshot_write_fault_retried(tmp_path):
    w = build("sgd", 1)
    w.run()
    arrays, meta = collect_state(w)
    path = str(tmp_path / "s.npz")
    plan = faults.FaultPlan().oserror_at("snapshot.write", at_hit=1)
    with faults.active(plan):
        write_snapshot(path, arrays, meta)
    assert plan.log and verify_snapshot(path)
    assert not any(".tmp" in p for p in os.listdir(tmp_path))


def test_failing_snapshot_write_keeps_previous_and_run_alive(tmp_path):
    plan = faults.FaultPlan()
    for _ in range(9):
        plan.arm("snapshot.write", "oserror", when=lambda path:
                 not path.endswith("t_1.npz"))
    with faults.active(plan):
        w = build("sgd", 4, tmp_path)
        w.run()
    assert len(w.decision.metrics_history) == 4    # training survived
    published = sorted(p for p in os.listdir(tmp_path)
                       if not p.endswith("_latest.npz"))
    assert published == ["t_1.npz"], published
    assert verify_snapshot(str(tmp_path / "t_1.npz"))


# -- mismatches ----------------------------------------------------------------

def test_architecture_mismatch_raises(tmp_path):
    path, _, _ = _written(tmp_path)
    tprng.seed_all(1)
    wide = [dict(FC_LAYERS[0], **{"->": {"output_sample_shape": 48}}),
            FC_LAYERS[1]]
    w = TStandard(name="Wide", layers=wide, loss_function="softmax",
                  loader_name="synthetic_classifier",
                  loader_config=dict(FC_LOADER), fused=True)
    w.initialize(device=TorchDevice("cpu"))
    with pytest.raises(ValueError, match="shape"):
        restore_state(w, path)
    deeper = build("conv_dropout", 1)
    with pytest.raises(ValueError, match="architecture mismatch"):
        restore_state(deeper, path)


def test_optimizer_and_ema_mismatches_raise(tmp_path):
    path, _, _ = _written(tmp_path)            # sgd, no EMA
    with pytest.raises(ValueError, match="optimizer"):
        restore_state(build("adam_ema", 1), path)
    w = build("adam_ema", 1)
    w.run()
    arrays, meta = collect_state(w)
    ema_path = str(tmp_path / "ema.npz")
    write_snapshot(ema_path, arrays, meta)
    tprng.seed_all(SEED)
    no_ema = TStandard(name="NoEma", layers=FC_LAYERS,
                       loss_function="softmax",
                       loader_name="synthetic_classifier",
                       loader_config=dict(FC_LOADER), optimizer="adam",
                       fused=True)
    no_ema.initialize(device=TorchDevice("cpu"))
    with pytest.raises(ValueError, match="ema_decay"):
        restore_state(no_ema, ema_path)


# -- a restore into a step that has already stepped ---------------------------

@pytest.mark.parametrize("case", ["sgd", "adam_ema", "conv_dropout"])
def test_restore_into_a_stepped_step_is_in_place_and_bit_exact(tmp_path,
                                                               case):
    """The step copies the snapshot into the tensors it already holds (the
    ones its captured CUDA graphs read on the card): the same leaves,
    the same pinned data set, and the run continues bit-exact."""
    full = build(case, 4, tmp_path)
    full.run()
    w = build(case, 1)              # the same data, stepped one epoch
    w.run()
    step = w.step
    leaves = [(leaf, k, t) for leaf in step._params for k, t in leaf.items()]
    pinned = step._dataset_dev
    restore_state(w, str(tmp_path / "t_2.npz"))
    assert all(leaf[k] is t for leaf, k, t in leaves)
    assert step._dataset_dev is pinned
    w.decision.max_epochs = 4
    w.run()
    assert w.decision.metrics_history == full.decision.metrics_history
    w.stop()
    full.stop()
    for k, v in _weights(full).items():
        np.testing.assert_array_equal(_weights(w)[k], v, err_msg=k)


# -- across the packages ---------------------------------------------------------

class Uniforms:
    """Seeded numpy uniforms that both packages draw, a sequence a shape
    (each shape's own generator, so the order shapes are met in does
    not matter).  The reference's ``jax.random.uniform`` becomes a host
    callback that hands the next one out to each new key; the port's
    ``draw_uniform`` hands them out in call order.  ``start`` skips the
    draws of the epochs a restored run does not repeat."""

    def __init__(self, seed: int, start=None) -> None:
        self.seed = seed
        self.rngs = {}
        self.seq = collections.defaultdict(list)
        self.next = collections.Counter(start or {})
        self.by_key = {}

    def _take(self, shape):
        i = self.next[shape]
        self.next[shape] += 1
        seq = self.seq[shape]
        rng = self.rngs.setdefault(shape, np.random.default_rng(
            [self.seed, *shape]))
        while len(seq) <= i:
            seq.append(rng.random(shape, dtype=np.float32))
        return seq[i]

    def jax_uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                    maxval=1.0):
        shape = tuple(shape)

        def host(data):
            k = (np.asarray(data).tobytes(), shape)
            if k not in self.by_key:
                self.by_key[k] = self._take(shape)
            return self.by_key[k]

        data = jax.random.key_data(key) if jnp.issubdtype(
            key.dtype, jax.dtypes.prng_key) else key
        return jax.pure_callback(host, jax.ShapeDtypeStruct(shape,
                                                            jnp.float32),
                                 data)

    def port_draw(self, rng, shape, device):
        return torch.tensor(self._take(tuple(shape)), device=device)


def _drawing(w, uniforms, jax_side, monkeypatch):
    """Run ``w`` with ``uniforms`` as its forwards' random source."""
    if uniforms is None:
        w.run()
        return
    if jax_side:
        with monkeypatch.context() as m:
            m.setattr(jax.random, "uniform", uniforms.jax_uniform)
            w.run()
        return
    for f in w.forwards:
        if f.NEEDS_RNG:
            f.draw_uniform = uniforms.port_draw
    w.run()


def _cross(case, jax_writes, tmp_path, monkeypatch):
    """The writer's uninterrupted EPOCHS-epoch run with snapshots, and the
    other package's fresh workflow restored from its epoch-SNAP_EPOCH
    snapshot (not yet run) -> (full, restored, snapshot path,
    uniforms for the restored run or None)."""
    useed = 3 if case == "conv_dropout" else None
    uniforms = None if useed is None else Uniforms(useed)
    if jax_writes:
        with monkeypatch.context() as m:
            if uniforms is not None:
                m.setattr(jax.random, "uniform", uniforms.jax_uniform)
            full = build(case, EPOCHS, tmp_path, jax_side=True)
            full.run()
    else:
        full = build(case, EPOCHS, tmp_path)
        _drawing(full, uniforms, False, monkeypatch)
    full.step.sync_to_units()
    path = str(tmp_path / f"t_{SNAP_EPOCH}.npz")
    res = build(case, EPOCHS, jax_side=not jax_writes)
    (restore_state if jax_writes else jrestore)(res, path)
    later = None
    if uniforms is not None:
        later = Uniforms(useed, {s: n * SNAP_EPOCH // EPOCHS
                                 for s, n in uniforms.next.items()})
    return full, res, path, later


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("jax_writes", [True, False],
                         ids=["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages_and_both_continue(case, jax_writes,
                                                     tmp_path,
                                                     monkeypatch):
    full, res, path, uniforms = _cross(case, jax_writes, tmp_path,
                                       monkeypatch)
    snap, meta = _snapshot_arrays(path)
    # everything restored is the snapshot's, bit for bit
    arrays, got = (collect_state if jax_writes else jcollect)(res)
    random_keys = {"step.key", "step.generator"}
    assert set(arrays) - random_keys == set(snap) - random_keys
    for k in set(snap) - random_keys:
        np.testing.assert_array_equal(arrays[k], snap[k], err_msg=k)
    for k in ("loader", "decision", "prng"):
        assert json.loads(json.dumps(got[k])) == meta[k], k
    assert got.get("optimizer", "sgd") == meta.get("optimizer", "sgd")
    # then one more epoch on the restoring side: the writer's last epoch
    _drawing(res, uniforms, not jax_writes, monkeypatch)
    res.step.sync_to_units()
    assert len(res.decision.metrics_history) == EPOCHS
    assert res.decision.metrics_history == full.decision.metrics_history
    for k, v in _weights(full).items():
        np.testing.assert_allclose(_weights(res)[k], v, rtol=0,
                                   atol=WEIGHT_ATOL[case], err_msg=k)


@pytest.mark.parametrize("case", ["sgd", "conv_dropout"])
def test_key_sets_differ_only_by_the_steps_random_state(case, tmp_path):
    """One workflow, both packages: the same keys, shapes and dtypes but
    for the reference's ``step.key`` and the port's ``step.generator``."""
    jw = build(case, 1, tmp_path / "jax", jax_side=True)
    jw.run()
    tw = build(case, 1, tmp_path / "port")
    tw.run()
    j, jmeta = _snapshot_arrays(tmp_path / "jax" / "t_1.npz")
    t, tmeta = _snapshot_arrays(tmp_path / "port" / "t_1.npz")
    assert set(j) - set(t) == {"step.key"}
    assert set(t) - set(j) == {"step.generator"}
    for k in set(j) & set(t):
        assert (j[k].shape, j[k].dtype) == (t[k].shape, t[k].dtype), k
    assert set(jmeta) == set(tmeta)


def test_a_foreign_step_key_keeps_the_initialize_generator(tmp_path,
                                                           caplog):
    """A JAX snapshot carries the jax.random key only: the port keeps the
    generator its step minted at initialize, and says so."""
    jw = build("conv_dropout", 4, tmp_path, jax_side=True)
    jw.run()
    tw = build("conv_dropout", 4)
    minted = tw.step._gen.get_state().clone()
    with caplog.at_level(logging.WARNING):
        restore_state(tw, str(tmp_path / "t_2.npz"))
    assert "step.key" in caplog.text
    assert torch.equal(tw.step._gen.get_state(), minted)


# -- resuming a finished run -----------------------------------------------------

def test_a_finished_run_resumes_to_a_later_max_epochs(tmp_path):
    """The epoch-2 snapshot of a 2-epoch run (``complete`` saved set):
    ``restore_state`` keeps the flag, as the reference's does; the
    launcher's ``resume`` into a 4-epoch workflow clears it and the run
    trains on to epoch 4, bit-exact against a 4-epoch run; into a
    2-epoch workflow it stays complete."""
    done = build("sgd", 2, tmp_path)
    done.run()
    path = str(tmp_path / "t_2.npz")
    assert _snapshot_arrays(path)[1]["decision"]["complete"]
    kept = build("sgd", 4)
    restore_state(kept, path)
    assert bool(kept.decision.complete)
    same = build("sgd", 2)
    resume(same, path)
    assert bool(same.decision.complete)
    more = build("sgd", 4)
    resume(more, path)
    assert not bool(more.decision.complete)
    more.run()
    assert more.decision.metrics_history == history_of(build("sgd", 4))


def test_a_run_ended_by_its_target_metric_is_judged_again_on_resume(
        tmp_path):
    """Resumed into a larger ``max_epochs``, a run that its target metric
    ended trains one more epoch, and its Decision's own rule ends it
    there: the stopping rules live in the Decision alone."""
    w = build("sgd", 2, tmp_path)
    w.decision.target_metric = 1e9            # any epoch meets it
    w.run()
    assert len(w.decision.metrics_history) == 1
    more = build("sgd", 4)
    more.decision.target_metric = 1e9
    resume(more, str(tmp_path / "t_1.npz"))
    assert not bool(more.decision.complete)
    more.run()
    assert [h["epoch"] for h in more.decision.metrics_history] == [1, 2]
    assert bool(more.decision.complete)


def history_of(w):
    w.run()
    return w.decision.metrics_history
