"""The port's health guard and elastic fleet (``znicz_tpu_torch/
resilience/health.py`` and ``elastic.py``) against the JAX package on
the CPU:

- ``HealthGuard`` on fused MNIST FC-shaped runs (``tests/
  test_resilience.py:430-497``'s workflow): ``mode="skip"`` with a NaN
  injected at ``step.loss`` trips once and skips one batch, restoring the
  certified copy into the step's live tensors (the same ``data_ptr``s);
  ``mode="rollback"`` forces one ``NNRollback`` and halves the learning
  rate; both keep the JAX package's history, weights within the MNIST FC
  band;
- the heartbeat thread, the goodput ledger's tiling and the fault-plan
  env round trip (a plan fired in a subprocess that imports no jax);
- the drill workflow (``models/elastic_drill.py``) in-process gives the
  reference's ``tools/elastic_workflow.py`` history;
- one subprocess drill on gloo: 2 port workers, rank 0 SIGKILLed at the
  reference's seeded ``KILL_AT_HIT``, resumed at world 1 — its history
  bit-identical to the uninterrupted port run, one flight artifact that
  ``flight`` prints, the ``elastic_counts`` deltas, and each worker's
  metrics-export file rank-tagged.  No wall-clock share is asserted.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.standard_workflow import StandardWorkflow as JStandard

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.observe import federation, flight, probe
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.resilience.elastic import (GoodputLedger, run_elastic,
                                                start_heartbeat)
from znicz_tpu_torch.resilience.supervisor import SupervisorPolicy
from znicz_tpu_torch.standard_workflow import StandardWorkflow as TStandard
from znicz_tpu_torch.units import nn_rollback
from znicz_tpu_torch.units.nn_units import load_forward_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRILL = os.path.join(REPO, "znicz_tpu_torch", "models", "elastic_drill.py")
REF_DRILL = os.path.join(REPO, "tools", "elastic_workflow.py")
EPOCHS = 6
#: tests/test_elastic.py:58's seeded kill step; rank 0, the writer
KILL_AT_HIT = int(np.random.default_rng(1234).integers(40, 70))
#: the port's fused step against the JAX package's (SGD): the MNIST FC
#: band in force (tests/test_torch_port_mnist.py WEIGHT_ATOL)
WEIGHT_ATOL = 1e-6
#: generous limits for a loaded host: nothing here is held to them
DRILL_TIMEOUT = 600.0

#: tests/test_resilience.py:26's workflow
LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 24},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 6},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
]
LOADER = {"n_classes": 6, "sample_shape": (10, 10), "n_train": 240,
          "n_valid": 120, "minibatch_size": 40, "spread": 2.5, "noise": 1.0}


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    faults.uninstall()


def _build(cls, health):
    return cls(name="ResTest", layers=LAYERS, loss_function="softmax",
               loader_name="synthetic_classifier", loader_config=LOADER,
               decision_config={"max_epochs": 3}, health_config=health)


def _weights(w):
    w.step.sync_to_units()
    return [np.asarray(a.map_read()).copy() for f in w.forwards
            for a in (f.weights, f.bias)]


def _jax_guarded(health):
    from znicz_tpu.resilience import faults as jfaults

    jprng.seed_all(77)
    w = _build(JStandard, health)
    w.initialize(device=TPUDevice())
    init = {"params": [{"w": f.weights.map_read().copy(),
                        "b": f.bias.map_read().copy()} for f in w.forwards],
            "state": jprng.get().state_dict()}
    plan = jfaults.FaultPlan().nan_at("step.loss", at_hit=4)
    with jfaults.active(plan):
        w.run()
    assert plan.log
    return w, init


def _port_guarded(health, init):
    tprng.seed_all(77)
    w = _build(TStandard, health)
    load_forward_params(w.forwards, init["params"])
    w.initialize(device=TorchDevice("cpu"))
    tprng.get().load_state_dict(init["state"])
    return w


def test_health_guard_skip_restores_the_certified_copy_in_place(
        monkeypatch):
    jw, init = _jax_guarded({"mode": "skip"})
    w = _port_guarded({"mode": "skip"}, init)
    ptrs = [t.data_ptr() for leaf in w.step._params for t in leaf.values()]
    restored = []
    real = nn_rollback.restore_params

    def checked(workflow, stored):
        real(workflow, stored)
        # the certified copy now IS the step's live state, in the same
        # tensors the (captured) step reads
        for i, leaf in enumerate(workflow.step._params):
            np.testing.assert_array_equal(
                leaf["w"].numpy(), stored[f"forward.{i}.weights"])
            np.testing.assert_array_equal(
                leaf["b"].numpy(), stored[f"forward.{i}.bias"])
        restored.append([t.data_ptr() for leaf in workflow.step._params
                         for t in leaf.values()])

    monkeypatch.setattr(nn_rollback, "restore_params", checked)
    plan = faults.FaultPlan().nan_at("step.loss", at_hit=4)
    with faults.active(plan):
        w.run()
    assert plan.log, "the armed NaN never fired"
    guard = w.health_guard
    assert guard.nan_trips == 1 and guard.skipped_batches == 1
    assert restored == [ptrs]
    assert len(w.decision.metrics_history) == 3
    snap = guard.snapshot()
    assert snap == {**jw.health_guard.snapshot(), "runs": snap["runs"]}
    assert w.decision.metrics_history == jw.decision.metrics_history
    for got, want in zip(_weights(w), _weights(jw)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=WEIGHT_ATOL)


def test_health_guard_rollback_mode():
    health = {"mode": "rollback", "rollback": {"lr_cut": 0.5}}
    jw, init = _jax_guarded(health)
    w = _port_guarded(health, init)
    base_lr = float(w.gds[0].learning_rate)
    plan = faults.FaultPlan().nan_at("step.loss", at_hit=4)
    with faults.active(plan):
        w.run()
    assert w.health_guard.rollbacks_forced == 1
    assert w.nn_rollback.rollback_count == 1
    assert float(w.gds[0].learning_rate) == base_lr * 0.5
    assert w.decision.metrics_history == jw.decision.metrics_history
    for got, want in zip(_weights(w), _weights(jw)):
        np.testing.assert_allclose(got, want, rtol=0, atol=WEIGHT_ATOL)


# -- the fleet's plumbing -----------------------------------------------------

def test_heartbeat_thread_writes_progress(tmp_path):
    path = str(tmp_path / "hb")
    values = iter([3, 17, 17, 29])
    start_heartbeat(path, interval=0.02, progress=lambda: next(values, 29))
    deadline = time.monotonic() + 30
    seen = set()
    while time.monotonic() < deadline and 29 not in seen:
        try:
            with open(path) as f:
                ts_text, _, progress = f.read().strip().partition(" ")
            float(ts_text)
            seen.add(int(progress))
        except (OSError, ValueError):
            pass
        time.sleep(0.01)
    assert 29 in seen, seen


def test_goodput_ledger_tiles_its_cursor():
    """Every segment lands in exactly one category a rank: the per-rank
    sums reconstruct the cursor's span, the split charges its head and
    its remainder, and the probe families carry the same seconds."""
    before = probe.goodput_totals()
    ledger = GoodputLedger()
    t0 = ledger._cursor
    ledger.advance("idle", ranks=(0, 1), until=t0 + 1.0)
    ledger.advance("productive", until=t0 + 4.0)
    ledger.advance("snapshot", ranks=(0,), until=t0 + 4.5)
    assert ledger.per_rank["0"] == {"productive": 3.0, "lost": 0.0,
                                    "snapshot": 0.5, "idle": 1.0}
    assert ledger.per_rank["1"]["productive"] == 3.0
    assert sum(ledger.per_rank["0"].values()) == pytest.approx(4.5)
    dt = ledger.advance_split(0.0, "productive", "lost")
    assert ledger.per_rank["0"]["lost"] == pytest.approx(dt)
    doc = ledger.as_dict()
    assert 0.0 < doc["ratio"] <= 1.0
    after = probe.goodput_totals()
    assert after["productive"] - before["productive"] == pytest.approx(6.0)
    assert after["idle"] - before["idle"] == pytest.approx(2.0)


def test_fault_plan_env_roundtrip_and_fires_in_a_port_process(tmp_path):
    plan = faults.FaultPlan(seed=9)
    plan.kill_at("elastic.worker", at_hit=33)
    plan.hang_at("workflow.step", at_hit=2, seconds=7.5, once=False)
    clone = faults.FaultPlan.from_env(plan.to_env())
    assert [(f.site, f.action, f.at_hit, f.seconds, f.once)
            for f in clone._faults] == \
        [("elastic.worker", "kill", 33, 30.0, True),
         ("workflow.step", "hang", 2, 7.5, False)]
    code = ("import sys\n"
            "from znicz_tpu_torch.resilience import faults\n"
            "plan = faults.install_from_env()\n"
            "faults.fault_hook('drill.site')\n"
            "try:\n"
            "    faults.fault_hook('drill.site')\n"
            "    print('MISSED')\n"
            "except faults.FaultInjected as exc:\n"
            "    print('FIRED', exc)\n"
            "print('JAX' if 'jax' in sys.modules else 'NOJAX')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env[faults.PLAN_ENV_VAR] = \
        faults.FaultPlan(seed=3).crash_at("drill.site", at_hit=2).to_env()
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FIRED" in out.stdout and "hit 2" in out.stdout
    assert "NOJAX" in out.stdout


# -- the drill ---------------------------------------------------------------

def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def baseline():
    """The uninterrupted drill in-process, as the CLI seeds it
    (``--random-seed`` 1): the port's and the reference's histories."""
    saved = {k: os.environ.get(k) for k in ("ZNICZ_TPU_ELASTIC_EPOCHS",
                                            "ZNICZ_TPU_SNAP_DIR")}
    os.environ["ZNICZ_TPU_ELASTIC_EPOCHS"] = str(EPOCHS)
    os.environ.pop("ZNICZ_TPU_SNAP_DIR", None)
    try:
        tprng.seed_all(1)
        tw = _load(DRILL, "port_drill").build()
        tw.initialize(device=TorchDevice("cpu"))
        tw.run()
        jprng.seed_all(1)
        jw = _load(REF_DRILL, "ref_drill").build()
        jw.initialize(device=TPUDevice())
        jw.run()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"port": tw.decision.metrics_history,
            "jax": jw.decision.metrics_history}


def test_drill_workflow_in_process_matches_the_reference(baseline):
    assert baseline["port"] == baseline["jax"]
    assert len(baseline["port"]) == EPOCHS
    assert any(row.get("metric_validation") for row in baseline["port"])


def test_elastic_drill_seeded_kill_bit_exact_resume(tmp_path, baseline,
                                                    capsys):
    """2 port workers on gloo, rank 0 SIGKILLed at the seeded hit,
    resumed at world 1 from the newest valid snapshot: the history is
    the uninterrupted run's bit for bit."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               ZNICZ_TPU_ELASTIC_EPOCHS=str(EPOCHS))
    counts0 = probe.elastic_counts()
    plan = faults.FaultPlan(seed=1234).kill_at("elastic.worker",
                                               at_hit=KILL_AT_HIT)
    snap = tmp_path / "drill"
    report = run_elastic(
        [DRILL, "-d", "cpu"], str(snap), workers=2, world_sizes=[2, 1],
        prefix="ew", policy=SupervisorPolicy(max_restarts=2,
                                             sleep=lambda s: None),
        env=env, fault_plans={0: plan}, term_grace=30.0,
        round_timeout=DRILL_TIMEOUT)
    counts = probe.elastic_counts()
    assert report.completed and report.restarts == 1
    assert report.world_size == 1
    assert any(d["cause"] == "signal" and d["code"] == -9
               for d in report.worker_deaths), report.worker_deaths
    assert len(report.resumed_from) == 1
    resumed_epoch = int(re.search(
        r"_(\d+)\.npz$", os.path.basename(report.resumed_from[0])).group(1))
    assert 0 < resumed_epoch < EPOCHS
    with open(os.path.join(str(snap), "history_0.json")) as f:
        assert json.load(f)["history"] == baseline["port"]
    # one flight artifact, elastic-stamped, that the viewer prints
    assert len(report.flights) == 1
    doc = flight.load(report.flights[0])
    assert doc["reason"] == "elastic_restart" and doc["extra"]["world"] == 2
    assert flight.flight_main([report.flights[0]]) == 0
    assert "flight: elastic_restart" in capsys.readouterr().out
    assert counts["restarts"] - counts0["restarts"] == 1
    assert counts["resumes"] - counts0["resumes"] == 1
    assert counts["worker_deaths"] - counts0["worker_deaths"] >= 1
    assert counts["world_size"] == 0
    # the resumed worker's metrics export: rank-tagged, parseable
    path = os.path.join(str(snap), "elastic", "metrics_r1_w0.json")
    with open(path) as f:
        exported = json.load(f)
    assert exported["rank"] == 0
    assert federation.parse_prometheus(exported["prom"])
    agg = federation.FleetAggregator(min_refresh_s=0.0)
    try:
        agg.add_file_source(0, path)
        assert any('rank="0"' in k for k in agg.snapshot_flat())
    finally:
        agg.close()
