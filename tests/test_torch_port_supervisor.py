"""The port's supervisor (``znicz_tpu_torch/resilience/supervisor.py``, a
copy of the reference's over the port's snapshotter) and its flight
recorder (``observe/flight.py``) on the CPU: the drills of the
reference's ``tests/test_resilience.py`` and the two pipelined drills of
``tests/test_pipeline_prefetch.py``, run against port workflows.

A run crashed at a seeded epoch (or inside the prefetch worker) and
resumed by ``run_supervised`` gives the uninterrupted run's history bit
for bit; a corrupt newest snapshot is rejected for the one before it;
the restart budget runs out; the backoff is seeded; the watchdog turns an
injected hang into a restart and writes the hung thread's stack into
the flight artifact; and no prefetch worker outlives its workflow.
"""

import json
import os
import threading

import numpy as np
import pytest

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.observe import flight
from znicz_tpu_torch.observe import trace
from znicz_tpu_torch.observe.watchtower import WATCHTOWER, Watchtower
from znicz_tpu_torch.pipeline import BatchPrefetcher
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.resilience.supervisor import (SupervisorExhausted,
                                                   SupervisorPolicy,
                                                   find_latest_valid_snapshot,
                                                   run_supervised)
from znicz_tpu_torch.snapshotter import verify_snapshot
from znicz_tpu_torch.standard_workflow import StandardWorkflow

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 24},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 6},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
]
LOADER = {"n_classes": 6, "sample_shape": (10, 10), "n_train": 240,
          "n_valid": 120, "minibatch_size": 40, "spread": 2.5, "noise": 1.0}


def build(max_epochs, snap_dir=None, seed=77, depth=None, built=None):
    """Fresh, initialized workflow: the supervisor's factory discipline
    (re-seed the global PRNG as a fresh process would).  ``built``
    collects every workflow made, so a drill can stop the crashed ones."""
    prng.seed_all(seed)
    cfg = None
    if snap_dir is not None:
        cfg = {"directory": str(snap_dir), "prefix": "t",
               "only_improved": False, "keep_all": True}
    w = StandardWorkflow(
        name="ResTest", layers=LAYERS, loss_function="softmax",
        loader_name="synthetic_classifier", loader_config=LOADER,
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=cfg,
        pipeline_config={"depth": depth} if depth else None)
    w.initialize(device=TorchDevice("cpu"))
    if built is not None:
        built.append(w)
    return w


def history(max_epochs, **kw):
    w = build(max_epochs, **kw)
    w.run()
    w.stop()
    return w.decision.metrics_history


def fast_policy(**kw):
    kw.setdefault("sleep", lambda s: None)
    return SupervisorPolicy(**kw)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == BatchPrefetcher.THREAD_NAME and t.is_alive()]


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    """A chaos test must never leak an armed plan or a flight config."""
    yield
    faults.uninstall()
    flight.configure()


@pytest.fixture
def direct_transfers():
    """Ship every minibatch (no data set pinned), so the pipeline's
    staging leg carries the rows."""
    prev = root.common.engine.get("dataset_on_device_max_bytes", 1 << 30)
    root.common.engine.dataset_on_device_max_bytes = 0
    yield
    root.common.engine.dataset_on_device_max_bytes = prev


def _crash_at_epoch(plan, epoch):
    plan.crash_at("workflow.step", when=lambda workflow, unit:
                  int(workflow.decision.epoch_number) == epoch)


# -- supervised auto-resume ---------------------------------------------------

def test_supervised_resume_is_bit_exact_after_seeded_crash(tmp_path):
    full_hist = history(4)
    crash_epoch = int(np.random.default_rng(1234).integers(1, 4))
    snap_dir = tmp_path / "chaos"
    plan = faults.FaultPlan(seed=1234)
    _crash_at_epoch(plan, crash_epoch)
    with faults.active(plan):
        report = run_supervised(lambda: build(4, snap_dir), str(snap_dir),
                                fast_policy())
    assert plan.log, "the armed crash never fired"
    assert report.restarts == 1
    assert report.resumed_from, "supervisor did not resume from a snapshot"
    assert report.workflow.decision.metrics_history == full_hist
    assert report.as_dict()["failures"][0].startswith("FaultInjected")


def test_supervisor_rejects_corrupt_newest_snapshot(tmp_path):
    full_hist = history(4)
    snap_dir = tmp_path / "s"
    history(3, snap_dir=snap_dir)                  # dies "mid-job" at 3
    newest = snap_dir / "t_3.npz"
    blob = bytearray(newest.read_bytes())
    blob[len(blob) // 2:len(blob) // 2 + 128] = b"\xff" * 128
    newest.write_bytes(bytes(blob))
    assert not verify_snapshot(str(newest))
    rejected = []
    assert find_latest_valid_snapshot(str(snap_dir), rejected=rejected) \
        == str(snap_dir / "t_2.npz")
    assert rejected == [str(newest)]
    report = run_supervised(lambda: build(4, snap_dir), str(snap_dir),
                            fast_policy())
    assert str(newest) in report.rejected_snapshots
    assert report.resumed_from[0] == str(snap_dir / "t_2.npz")
    assert report.workflow.decision.metrics_history == full_hist


def test_supervisor_restart_budget_exhausts(tmp_path):
    plan = faults.FaultPlan()
    for _ in range(10):
        plan.crash_at("workflow.step", at_hit=None, once=True)
    with faults.active(plan):
        with pytest.raises(SupervisorExhausted):
            run_supervised(lambda: build(2, tmp_path), str(tmp_path),
                           fast_policy(max_restarts=2))
    # one flight artifact a failure, the last one marked exhausted
    flights = sorted(p for p in os.listdir(tmp_path)
                     if p.startswith("flight_"))
    assert len(flights) == 3 and flights[-1].endswith("_exhausted.json")


def test_supervisor_backoff_is_seeded_deterministic():
    a = SupervisorPolicy(seed=5)
    b = SupervisorPolicy(seed=5)
    delays = [a.restart_delay(i) for i in (1, 2, 3)]
    assert delays == [b.restart_delay(i) for i in (1, 2, 3)]
    assert delays[0] < delays[2] <= a.backoff_max * (1 + a.backoff_jitter)
    with pytest.raises(ValueError):
        SupervisorPolicy(max_restarts=-1)


def test_watchdog_detects_injected_hang(tmp_path):
    full_hist = history(3)
    snap_dir = tmp_path / "hang"
    plan = faults.FaultPlan()
    plan.hang_at("workflow.step", seconds=60.0, when=lambda workflow, unit:
                 int(workflow.decision.epoch_number) == 1)
    with faults.active(plan):
        report = run_supervised(
            lambda: build(3, snap_dir), str(snap_dir),
            fast_policy(step_timeout=2.0, hang_grace=5.0))
    assert plan.log and plan.log[0]["action"] == "hang"
    assert report.hang_events == 1
    assert report.restarts == 1
    assert report.workflow.decision.metrics_history == full_hist
    # the hung thread's stack, captured before the interrupt unwound it,
    # names the stall point: the injected hang's wait in the fault plan
    with open(report.flights[0]) as f:
        doc = json.load(f)
    stack = "".join(doc["extra"]["hung_stack"])
    assert "faults.py" in stack and "_hang" in stack, stack[-2000:]
    assert doc["extra"]["error_type"] in ("StepHangError",
                                          "HangInterrupted")


def test_supervised_survives_repeated_crashes(tmp_path):
    """Three kills across one job; every restart resumes from the newest
    valid snapshot and the final history is still bit-exact."""
    full_hist = history(6)
    snap_dir = tmp_path / "multi"
    plan = faults.FaultPlan(seed=99)
    for epoch in (1, 3, 4):
        _crash_at_epoch(plan, epoch)
    with faults.active(plan):
        report = run_supervised(lambda: build(6, snap_dir), str(snap_dir),
                                fast_policy(max_restarts=5))
    assert report.restarts == 3
    assert report.workflow.decision.metrics_history == full_hist


def test_workflow_progress_counter_advances():
    w = build(1)
    assert w.signals_dispatched == 0
    w.run()
    assert w.signals_dispatched > 10


# -- the pipelined drills ------------------------------------------------------

def test_chaos_kill_and_resume_bit_exact_pipelined(tmp_path,
                                                   direct_transfers):
    """A pipelined run killed at a seeded epoch and resumed by the
    supervisor gives the synchronous run's history: the epoch barrier
    makes snapshots hold the synchronous loader and prng state, and the
    restore drains and re-arms the worker."""
    sync_hist = history(4)
    crash_epoch = int(np.random.default_rng(1234).integers(1, 4))
    snap_dir = tmp_path / "chaos"
    plan = faults.FaultPlan(seed=1234)
    _crash_at_epoch(plan, crash_epoch)
    built = []
    with faults.active(plan):
        report = run_supervised(
            lambda: build(4, snap_dir, depth=2, built=built), str(snap_dir),
            fast_policy())
    assert plan.log, "the armed crash never fired"
    assert report.restarts == 1 and report.resumed_from
    assert report.workflow.decision.metrics_history == sync_hist
    assert report.workflow.input_pipeline.stats.snapshot()[
        "bytes_staged"] > 0
    for w in built:
        w.stop()
    assert not _prefetch_threads(), "a run leaked a prefetch worker"


def test_worker_fault_kill_and_resume(tmp_path, direct_transfers):
    """A crash inside the prefetch worker (site pipeline.fetch) re-raises
    on the consumer; the supervisor restarts and restores, and the
    history is the synchronous run's."""
    sync_hist = history(4)
    snap_dir = tmp_path / "chaos"
    plan = faults.FaultPlan(seed=99)
    plan.crash_at("pipeline.fetch", at_hit=14)   # mid-epoch-2 on the worker
    with faults.active(plan):
        report = run_supervised(
            lambda: build(4, snap_dir, depth=2), str(snap_dir),
            fast_policy())
    assert plan.log == [{"site": "pipeline.fetch", "action": "crash",
                         "hit": 14}]
    assert report.restarts == 1 and report.resumed_from
    assert report.workflow.decision.metrics_history == sync_hist
    report.workflow.stop()
    assert not _prefetch_threads(), "crashed run leaked a prefetch worker"


# -- the flight recorder -------------------------------------------------------

def test_flight_artifact_after_a_crash(tmp_path):
    """The artifact the supervisor dumps before its resume: the schema,
    the error-marked step that died among the newest spans, the restart
    instant, at least one time-series sample, the registry, the live
    planes, and a fingerprint that boots no device."""
    flight.register_plane("drill", lambda: {"answer": np.int64(42)})
    try:
        snap_dir = tmp_path / "chaos"
        plan = faults.FaultPlan()
        _crash_at_epoch(plan, 2)
        with faults.active(plan):
            report = run_supervised(lambda: build(3, snap_dir),
                                    str(snap_dir), fast_policy())
    finally:
        flight.unregister_plane("drill")
    assert len(report.flights) == 1
    doc = flight.load(report.flights[0])
    assert doc["schema"] == flight.SCHEMA and doc["reason"] == "restart"
    assert doc["extra"]["error_type"] == "FaultInjected"
    assert doc["planes"]["drill"] == {"answer": 42.0}
    steps = [e for e in doc["spans"] if e["name"] == "workflow.step"]
    assert steps and steps[-1]["args"].get("error") is True
    assert any(e["name"] == "resilience.fault" for e in doc["spans"])
    assert len(doc["timeseries"]["samples"]) >= 1
    assert "summary" in doc["timeseries"] and doc["metrics"]
    cfg = doc["config"]
    assert cfg["root"] is not None and "argv" in cfg
    # no CUDA context here, so the fingerprint names no device
    assert cfg["mesh"] is None and "torch" not in cfg
    assert not any(p.endswith(".tmp") for p in os.listdir(snap_dir))
    bad = tmp_path / "not_a_flight.json"
    bad.write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError, match="not a flight artifact"):
        flight.load(str(bad))


def test_flight_auto_dump_is_opt_in_and_rate_limited(tmp_path):
    assert flight.auto_dump("fault") is None        # not configured
    flight.configure(dir=str(tmp_path), min_interval_s=3600.0)
    assert flight.configured()
    plan = faults.FaultPlan().oserror_at("snapshot.write", at_hit=1)
    with faults.active(plan):
        with pytest.raises(OSError):
            faults.fault_hook("snapshot.write", path="x")
    first = [p for p in os.listdir(tmp_path) if p.startswith("flight_")]
    assert len(first) == 1 and first[0].endswith("_fault.json")
    doc = flight.load(str(tmp_path / first[0]))
    assert doc["extra"] == {"site": "snapshot.write", "action": "oserror",
                            "hit": 1}
    assert flight.auto_dump("again") is None         # rate-limited
    flight.configure()
    assert not flight.configured()


def test_watchtower_samples_the_run_and_the_dump(tmp_path):
    """``Workflow.watchtowers`` (the copied run loop's wiring) samples
    the registry at step boundaries without moving the history; a dump
    adds one sample to the global tower's ring."""
    tower = Watchtower(step_every=1)
    w = build(2)
    tower.attach(w)
    try:
        w.run()
    finally:
        tower.detach(w)
    assert len(tower.ring.to_dict()["samples"]) > 10
    assert w.decision.metrics_history == history(2)
    before = len(WATCHTOWER.ring.to_dict()["samples"])
    flight.dump(dir=str(tmp_path), reason="manual")
    assert len(WATCHTOWER.ring.to_dict()["samples"]) == before + 1
    trace.instant("drill.done")
    assert trace.TRACER.tail(1)[0]["name"] == "drill.done"
