"""Supervised auto-resume training — a copy of
``znicz_tpu/resilience/supervisor.py`` over the port's snapshotter (the
drift check in ``tests/test_torch_port_isolation.py`` holds the code
equal).

``run_supervised(workflow_factory, snap_dir, policy)`` is the in-process
analog of a cluster supervisor restarting a failed trainer (TensorFlow's
supervisor/monitored-session shape, arXiv 1605.08695): run the workflow,
catch crashes, restore the newest *valid* snapshot into a freshly built
workflow, resume — under a bounded restart budget with backed-off
restarts.  A watchdog thread detects a hung step (no control-graph
progress within ``step_timeout``) and treats it as a crash.

Correctness contract (pinned by tests/test_torch_port_supervisor.py):
because the snapshotter's resume is bit-exact, a run killed at any point
and auto-resumed by the supervisor reproduces the uninterrupted run's
metric history *exactly* — recovery is verifiable, not best-effort.

Poison snapshots: ``find_latest_valid_snapshot`` checksum-verifies
candidates newest-first (``snapshotter.verify_snapshot``) and falls back
to the previous valid one, so a snapshot torn by the very crash being
recovered from (or corrupted on disk) is rejected instead of trusted.

The factory owns seeding and construction: it must return a freshly
built, *initialized* workflow each call (re-seeding any global PRNG it
uses, exactly like a fresh process would) — the same discipline the
snapshotter tests already follow.
"""

from __future__ import annotations

import glob
import os
import re
import sys
import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.observe import flight as _flight
from znicz_tpu_torch.observe import probe as _probe
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.snapshotter import restore_state, verify_snapshot


class SupervisorExhausted(RuntimeError):
    """Restart budget spent without a completed run."""


class StepHangError(RuntimeError):
    """Watchdog: no control-graph progress within ``step_timeout``."""


class SupervisorPolicy:
    """Knobs for :func:`run_supervised`.

    max_restarts:  restarts allowed after the initial attempt.
    backoff_base/backoff_multiplier/backoff_max: restart delay schedule
                   (exponential, seconds).
    backoff_jitter: +/- fraction of the delay, drawn from a generator
                   seeded with ``seed`` (deterministic in tests).
    step_timeout:  watchdog stall threshold in seconds (None = watchdog
                   off; the workflow runs on the calling thread).
    hang_grace:    after interrupting injected hangs, how long to wait
                   for the worker thread to die before abandoning it.
    flight_recorder: dump a flight artifact (observe/flight.py: span
                   tail + time series + registry + log tail) into the
                   snapshot directory before every restore-and-resume
                   and on budget exhaustion, so the post-mortem
                   survives the process.
    sleep:         injectable clock for tests.
    """

    def __init__(self, max_restarts: int = 3, backoff_base: float = 0.05,
                 backoff_multiplier: float = 2.0, backoff_max: float = 5.0,
                 backoff_jitter: float = 0.25, seed: int = 0,
                 step_timeout: Optional[float] = None,
                 hang_grace: float = 2.0, flight_recorder: bool = True,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got "
                             f"{max_restarts}")
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_multiplier = float(backoff_multiplier)
        self.backoff_max = float(backoff_max)
        self.backoff_jitter = float(backoff_jitter)
        self.step_timeout = step_timeout
        self.hang_grace = float(hang_grace)
        self.flight_recorder = bool(flight_recorder)
        self.sleep = sleep
        self._rng = np.random.default_rng(seed)

    def restart_delay(self, restart: int) -> float:
        """Backoff before restart ``restart`` (1-based), jittered."""
        d = min(self.backoff_max,
                self.backoff_base * self.backoff_multiplier ** (restart - 1))
        if self.backoff_jitter:
            d *= 1.0 + self.backoff_jitter * float(
                self._rng.uniform(-1.0, 1.0))
        return d


class SupervisorReport:
    """What happened: restart count, snapshots resumed from, snapshots
    rejected as invalid, hang events, the failures caught, the flight
    artifacts dumped per failure, and the final workflow (its
    ``decision.metrics_history`` is the training record)."""

    def __init__(self) -> None:
        self.restarts = 0
        self.resumed_from: list[str] = []
        self.rejected_snapshots: list[str] = []
        self.hang_events = 0
        self.failures: list[str] = []
        self.flights: list[str] = []
        self.workflow = None

    def as_dict(self) -> dict:
        return {"restarts": self.restarts,
                "resumed_from": list(self.resumed_from),
                "rejected_snapshots": list(self.rejected_snapshots),
                "hang_events": self.hang_events,
                "failures": list(self.failures),
                "flights": list(self.flights)}


_EPOCH_RE = re.compile(r"_(\d+)\.npz$")


def _snapshot_candidates(snap_dir: str, prefix: Optional[str]) -> list[str]:
    """Real snapshot files newest-first: ``*_latest.npz`` pointers are
    skipped (they alias a numbered file), order is by embedded epoch
    number when present, mtime otherwise."""
    pattern = f"{prefix}_*.npz" if prefix else "*.npz"
    paths = [p for p in glob.glob(os.path.join(snap_dir, pattern))
             if not p.endswith("_latest.npz") and not os.path.islink(p)]

    def key(p):
        m = _EPOCH_RE.search(os.path.basename(p))
        return (1, int(m.group(1))) if m else (0, os.path.getmtime(p))

    return sorted(paths, key=key, reverse=True)


def find_latest_valid_snapshot(snap_dir: str, prefix: Optional[str] = None,
                               rejected: Optional[list] = None
                               ) -> Optional[str]:
    """Newest snapshot in ``snap_dir`` that passes checksum verification;
    invalid ones (torn writes, bit rot, poison) are appended to
    ``rejected`` and skipped — the previous valid snapshot wins."""
    if not os.path.isdir(snap_dir):
        return None
    for path in _snapshot_candidates(snap_dir, prefix):
        if verify_snapshot(path):
            return path
        if rejected is not None:
            rejected.append(path)
    return None


class _Watchdog:
    """Run ``workflow.run()`` on a worker thread while the supervisor
    thread polls the workflow's ``signals_dispatched`` progress counter.
    A stall beyond ``step_timeout`` aborts injected hangs (cooperative)
    and, failing that, abandons the daemon worker — either way the run
    is declared failed with :class:`StepHangError`."""

    def __init__(self, workflow, step_timeout: float,
                 hang_grace: float) -> None:
        self.workflow = workflow
        self.step_timeout = step_timeout
        self.hang_grace = hang_grace
        self.error: Optional[BaseException] = None
        #: the hung worker thread's stack, captured at stall-detection
        #: time (BEFORE the hang interrupt unwinds it) — the flight
        #: artifact's answer to "WHERE did the step stall", not just
        #: "that it did"
        self.hung_stack: list[str] = []
        self._done = threading.Event()

    def _capture_stack(self, thread: threading.Thread) -> None:
        try:
            frame = sys._current_frames().get(thread.ident)
            if frame is not None:
                self.hung_stack = traceback.format_stack(frame)
        except Exception:  # noqa: BLE001 — diagnostics must not fail the
            pass           # failure path

    def _worker(self) -> None:
        try:
            self.workflow.run()
        except BaseException as exc:  # noqa: BLE001 — reported to caller
            self.error = exc
        finally:
            self._done.set()

    def run(self) -> Optional[BaseException]:
        t = threading.Thread(target=self._worker, daemon=True)
        t.start()
        last = -1
        last_change = time.monotonic()
        while not self._done.wait(timeout=min(0.05, self.step_timeout / 4)):
            now = time.monotonic()
            progress = self.workflow.signals_dispatched
            if progress != last:
                last, last_change = progress, now
            elif now - last_change > self.step_timeout:
                self._capture_stack(t)     # where is it stuck, exactly?
                faults.interrupt_hangs()   # cooperative: injected hangs die
                t.join(self.hang_grace)
                if t.is_alive():
                    # a real (non-injected) hang: abandon the daemon
                    # thread — the restarted attempt uses fresh objects
                    return StepHangError(
                        f"no progress for {self.step_timeout}s "
                        f"(stuck at {progress} signals); worker abandoned")
                if self._done.is_set() and self.error is None:
                    # the "stall" was a long single step (e.g. an XLA
                    # compile) that finished inside the grace window —
                    # not a hang; size step_timeout above the worst
                    # compile+step time to avoid tripping this at all
                    return None
                return self.error or StepHangError(
                    f"no progress for {self.step_timeout}s; worker "
                    f"stopped after hang interrupt")
        return self.error


def run_supervised(workflow_factory: Callable, snap_dir: str,
                   policy: Optional[SupervisorPolicy] = None,
                   prefix: Optional[str] = None) -> SupervisorReport:
    """Train to completion under supervision; returns the report (the
    final workflow rides on ``report.workflow``).

    Each attempt: build a fresh workflow via ``workflow_factory()``
    (initialized, freshly seeded), restore the newest valid snapshot from
    ``snap_dir`` when one exists, run.  A crash or detected hang consumes
    one restart from the budget and backs off before the next attempt;
    when the budget is spent, :class:`SupervisorExhausted` is raised from
    the last failure.
    """
    policy = policy or SupervisorPolicy()
    report = SupervisorReport()
    log = Logger()
    attempt = 0
    while True:
        attempt += 1
        workflow = workflow_factory()
        if not workflow.initialized:
            raise RuntimeError("workflow_factory must return an "
                               "initialized workflow")
        snap = find_latest_valid_snapshot(
            snap_dir, prefix, rejected=report.rejected_snapshots)
        if snap is not None:
            restore_state(workflow, snap)
            report.resumed_from.append(snap)
            _probe.resilience_event("snapshot_resume", attempt=attempt,
                                    snapshot=os.path.basename(snap))
            log.info(f"supervisor: attempt {attempt} resumes from {snap}")
        error: Optional[BaseException] = None
        hung_stack: list[str] = []
        if policy.step_timeout is None:
            try:
                workflow.run()
            except Exception as exc:  # noqa: BLE001 — supervised surface
                error = exc
        else:
            watchdog = _Watchdog(workflow, policy.step_timeout,
                                 policy.hang_grace)
            error = watchdog.run()
            hung_stack = watchdog.hung_stack
        if error is None and bool(workflow.decision.complete):
            report.workflow = workflow
            return report
        if error is None:
            error = RuntimeError("workflow.run returned without "
                                 "decision.complete (control graph "
                                 "drained early)")
        if isinstance(error, StepHangError) or \
                isinstance(error, faults.HangInterrupted):
            report.hang_events += 1
            _probe.resilience_event("hang", attempt=attempt)
        report.failures.append(repr(error))
        report.restarts += 1
        # restart on the shared timeline: the instant sits between the
        # last step span of the crashed attempt and the first of the next
        _probe.resilience_event("restart", attempt=attempt,
                                error=type(error).__name__)
        exhausted = report.restarts > policy.max_restarts
        if policy.flight_recorder:
            # post-mortem BEFORE restore-and-resume (or the final
            # raise): the next attempt overwrites in-memory telemetry,
            # so this artifact is the only record of the crashed one.
            # Recorder failures degrade to a warning — they must not
            # consume another restart.
            try:
                extra = {"attempt": attempt, "restarts": report.restarts,
                         "error": repr(error),
                         "error_type": type(error).__name__}
                if hung_stack:
                    # the post-mortem shows WHERE the step stalled
                    extra["hung_stack"] = hung_stack
                report.flights.append(_flight.dump(
                    dir=snap_dir,
                    reason="exhausted" if exhausted else "restart",
                    extra=extra))
            except Exception as flight_exc:  # noqa: BLE001
                log.warning(f"supervisor: flight dump failed: "
                            f"{flight_exc!r}")
        log.warning(f"supervisor: attempt {attempt} failed: {error!r}")
        if exhausted:
            raise SupervisorExhausted(
                f"gave up after {report.restarts - 1} restarts "
                f"({policy.max_restarts} allowed); failures: "
                f"{report.failures}") from error
        policy.sleep(policy.restart_delay(report.restarts))
