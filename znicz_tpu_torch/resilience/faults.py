"""Deterministic, seeded fault injection.

A :class:`FaultPlan` arms faults at named *sites* — fixed hook points the
production code calls explicitly:

===================  ======================================================
site                 hook location
===================  ======================================================
``workflow.step``    ``core/workflow.py`` run loop, once per control-graph
                     signal delivery (context: ``workflow``, ``unit``)
``snapshot.write``   ``snapshotter.write_snapshot``, before the atomic
                     publish (context: ``path``)
``serve.run``        ``serve/engine.py`` ``BatchEngine.run`` entry
``generate.step``    ``serve/continuous.py`` decode loop, once per
                     batched decode step (context: ``batcher``) — a
                     crash fails every ACTIVE stream with its terminal
                     error sentinel and the worker keeps serving
``pipeline.fetch``   ``pipeline/prefetcher.py`` worker loop, once per
                     prefetched batch (context: ``loader``, ``batch``);
                     a crash here re-raises on the consumer — the
                     supervisor sees an ordinary failed step
``step.loss``        ``parallel/step.py`` metric publish — value-poison
                     site (NaN into the published loss)
``step.params``      ``parallel/step.py`` after a train dispatch —
                     value-poison site (NaN into the param pytree, the
                     observable effect of NaN gradients)
``elastic.worker``   ``core/workflow.py`` run loop, same cadence as
                     ``workflow.step`` but with NO context kwargs — the
                     cross-process site: elastic-fleet drills arm it via
                     the ``ZNICZ_TPU_FAULT_PLAN`` env (``at_hit`` only;
                     predicates cannot cross a process boundary), usually
                     with the ``kill`` action
===================  ======================================================

Chaos tests therefore exercise the *real* step loop / save path / serving
path, never a mock.  Every fault triggers on a deterministic condition: an
absolute hit count of its site (``at_hit``) and/or a predicate over the
hook context (``when``), so a seeded test reproduces exactly.  The plan's
own ``rng`` (``numpy`` Generator seeded from the constructor) is how tests
derive "a random epoch" reproducibly.

The module-level registry is process-global and *off by default*: with no
plan installed every hook is a single ``None`` check.  ``install(plan)`` /
``uninstall()`` or the ``active(plan)`` context manager flip it.

Fault actions:

- ``crash``   — raise :class:`FaultInjected` (not retryable: simulates a
  process death / assertion failure)
- ``oserror`` — raise ``OSError`` (retryable by the default I/O
  :class:`~znicz_tpu.resilience.retry.RetryPolicy`: simulates flaky
  filesystem / network)
- ``hang``    — block for ``seconds``, *cooperatively*: the sleep polls
  the plan's abort event so a supervisor watchdog can interrupt it
  (raising :class:`HangInterrupted`) instead of leaking a stuck thread
- ``nan``     — value-poison: ``poison(site, value)`` returns a NaN-filled
  copy at the armed hit (scalars and array pytrees)
- ``kill``    — ``SIGKILL`` the OWN process: no exception, no cleanup, no
  atexit, no snapshot — the honest simulation of an OOM-killed / preempted
  worker for multi-process drills.  Never arm it in-process in a test
  runner; it is meant for worker subprocesses via the env plan.

Cross-process plans: the elastic fleet supervisor serializes a plan into
each worker's environment as ``ZNICZ_TPU_FAULT_PLAN`` (``plan.to_env()`` /
``install_from_env()``, called by ``python -m znicz_tpu`` at boot).  Only
deterministic triggers survive the boundary — ``site``/``action``/
``at_hit``/``seconds``/``once`` — so a seeded kill drill reproduces
exactly in the worker; plans with ``when`` predicates refuse to
serialize.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from znicz_tpu_torch.observe import flight as _flight
from znicz_tpu_torch.observe import probe as _probe


class FaultInjected(RuntimeError):
    """An armed ``crash`` fault fired (simulated process death)."""


class HangInterrupted(FaultInjected):
    """An armed ``hang`` fault was aborted by the supervisor watchdog."""


class _Fault:
    __slots__ = ("site", "action", "at_hit", "when", "seconds", "fired",
                 "once")

    def __init__(self, site: str, action: str, at_hit: Optional[int],
                 when: Optional[Callable], seconds: float, once: bool):
        self.site = site
        self.action = action
        self.at_hit = at_hit
        self.when = when
        self.seconds = seconds
        self.once = once
        self.fired = 0


class FaultPlan:
    """A seeded set of armed faults plus per-site hit counters."""

    ACTIONS = ("crash", "oserror", "hang", "nan", "kill")

    def __init__(self, seed: int = 0) -> None:
        #: seeded generator for tests to derive "random" trigger points
        #: (epochs, hit counts) reproducibly
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.hits: dict[str, int] = {}
        self.log: list[dict] = []       # every fired fault, for assertions
        self._faults: list[_Fault] = []
        self._abort = threading.Event()
        self._lock = threading.Lock()

    # -- arming --------------------------------------------------------------
    def arm(self, site: str, action: str = "crash", *,
            at_hit: Optional[int] = None,
            when: Optional[Callable] = None,
            seconds: float = 30.0, once: bool = True) -> "FaultPlan":
        """Arm one fault at ``site``.  It fires when the site's hit count
        equals ``at_hit`` (1-based) and/or ``when(**context)`` is true; with
        neither condition it fires on every hit.  ``once=True`` (default)
        disarms after the first firing — the restarted run proceeds."""
        if action not in self.ACTIONS:
            raise ValueError(f"unknown fault action {action!r}; known: "
                             f"{self.ACTIONS}")
        self._faults.append(_Fault(site, action, at_hit, when, seconds, once))
        return self

    def crash_at(self, site: str, at_hit: Optional[int] = None,
                 **kw) -> "FaultPlan":
        return self.arm(site, "crash", at_hit=at_hit, **kw)

    def hang_at(self, site: str, at_hit: Optional[int] = None,
                seconds: float = 30.0, **kw) -> "FaultPlan":
        return self.arm(site, "hang", at_hit=at_hit, seconds=seconds, **kw)

    def oserror_at(self, site: str, at_hit: Optional[int] = None,
                   **kw) -> "FaultPlan":
        return self.arm(site, "oserror", at_hit=at_hit, **kw)

    def nan_at(self, site: str, at_hit: Optional[int] = None,
               **kw) -> "FaultPlan":
        return self.arm(site, "nan", at_hit=at_hit, **kw)

    def kill_at(self, site: str, at_hit: Optional[int] = None,
                **kw) -> "FaultPlan":
        return self.arm(site, "kill", at_hit=at_hit, **kw)

    # -- cross-process serialization (ZNICZ_TPU_FAULT_PLAN) ------------------
    def to_env(self) -> str:
        """Serialize for a worker subprocess's environment.  Only the
        deterministic trigger survives (``at_hit``); a plan carrying a
        ``when`` predicate refuses loudly — closures cannot cross a
        process boundary, and silently dropping the condition would turn
        a seeded drill into fire-on-every-hit."""
        specs = []
        for f in self._faults:
            if f.when is not None:
                raise ValueError(
                    f"fault at {f.site!r} has a `when` predicate; "
                    f"predicates cannot be serialized into a worker env "
                    f"— arm with at_hit instead")
            specs.append({"site": f.site, "action": f.action,
                          "at_hit": f.at_hit, "seconds": f.seconds,
                          "once": f.once})
        return json.dumps({"seed": self.seed, "faults": specs})

    @classmethod
    def from_env(cls, text: str) -> "FaultPlan":
        doc = json.loads(text)
        plan = cls(seed=int(doc.get("seed", 0)))
        for spec in doc["faults"]:
            plan.arm(spec["site"], spec["action"],
                     at_hit=spec.get("at_hit"),
                     seconds=float(spec.get("seconds", 30.0)),
                     once=bool(spec.get("once", True)))
        return plan

    # -- watchdog integration ------------------------------------------------
    def interrupt_hangs(self) -> None:
        """Abort any in-flight (and future) injected hangs — the
        supervisor watchdog calls this when it declares a stall."""
        self._abort.set()

    def reset_abort(self) -> None:
        self._abort.clear()

    # -- firing --------------------------------------------------------------
    def _matches(self, f: _Fault, hit: int, ctx: dict) -> bool:
        if f.once and f.fired:
            return False
        if f.at_hit is not None and hit != f.at_hit:
            return False
        if f.when is not None and not f.when(**ctx):
            return False
        return True

    def _record(self, f: _Fault, hit: int) -> None:
        f.fired += 1
        self.log.append({"site": f.site, "action": f.action, "hit": hit})

    def trip(self, site: str, **ctx) -> None:
        """Count one hit of ``site``; execute the FIRST armed
        crash/oserror/hang whose condition matches (one fault per hook
        call, so N identically-armed faults survive N restarts)."""
        with self._lock:
            hit = self.hits[site] = self.hits.get(site, 0) + 1
            fault = next((f for f in self._faults
                          if f.site == site and f.action != "nan" and
                          self._matches(f, hit, ctx)), None)
            if fault is not None:
                self._record(fault, hit)
        if fault is None:
            return
        # telemetry plane: every firing lands as a counter + an instant
        # event on the step timeline (emitted OUTSIDE the plan lock —
        # the registry/tracer must never nest under it); with the flight
        # recorder configured, the firing also freezes a post-mortem
        # artifact (no-op + rate-limited otherwise)
        _probe.resilience_event("fault", site=site, action=fault.action,
                                hit=hit)
        _flight.auto_dump("fault", site=site, action=fault.action,
                          hit=hit)
        if fault.action == "kill":
            # simulated SIGKILL: die NOW, exactly like the OOM killer —
            # the elastic fleet's post-mortem comes from its own side.
            # Flush stdio first so a worker's last log lines reach the
            # supervisor's pump threads.
            import sys
            for stream in (sys.stdout, sys.stderr):
                try:
                    stream.flush()
                except Exception:  # noqa: BLE001
                    pass
            os.kill(os.getpid(), _signal.SIGKILL)
        if fault.action == "crash":
            raise FaultInjected(f"injected crash at {site} hit {hit}")
        if fault.action == "oserror":
            raise OSError(f"injected I/O failure at {site} hit {hit}")
        self._hang(fault, site, hit)

    def _hang(self, f: _Fault, site: str, hit: int) -> None:
        deadline = time.monotonic() + f.seconds
        while time.monotonic() < deadline:
            if self._abort.wait(timeout=0.02):
                raise HangInterrupted(
                    f"injected hang at {site} hit {hit} aborted by "
                    f"watchdog")
        # an un-aborted hang just ends after its duration (a stall, not a
        # crash) — the run continues

    def poison(self, site: str, value, **ctx):
        """Count one hit of ``site``; return ``value`` NaN-poisoned if an
        armed ``nan`` fault matches, unchanged otherwise.  Handles float
        scalars, numpy arrays, torch tensors, and dicts/lists of them."""
        with self._lock:
            hit = self.hits[site] = self.hits.get(site, 0) + 1
            fault = next((f for f in self._faults
                          if f.site == site and f.action == "nan" and
                          self._matches(f, hit, ctx)), None)
            if fault is not None:
                self._record(fault, hit)
        if fault is None:
            return value
        _probe.resilience_event("fault", site=site, action="nan", hit=hit)
        return _nan_like(value)


def _nan_like(value):
    if isinstance(value, (int, float)):
        return float("nan")
    if isinstance(value, np.ndarray):
        return np.full_like(value, np.nan)
    if isinstance(value, torch.Tensor):
        # multiply on the tensor's own device: no host round trip
        return value * float("nan")
    if isinstance(value, dict):
        return {k: _nan_like(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_nan_like(v) for v in value)
    raise TypeError(f"cannot NaN-poison a {type(value).__name__}")


# -- process-global registry -------------------------------------------------
_PLAN: Optional[FaultPlan] = None

#: worker subprocesses receive their armed plan through this variable
#: (set by the elastic supervisor, consumed by the CLI at boot)
PLAN_ENV_VAR = "ZNICZ_TPU_FAULT_PLAN"


def install_from_env() -> Optional[FaultPlan]:
    """Install the plan serialized in ``$ZNICZ_TPU_FAULT_PLAN`` when one
    is set (no-op otherwise).  A malformed plan raises — a kill drill
    whose plan was silently dropped would "pass" by never killing."""
    text = os.environ.get(PLAN_ENV_VAR)
    if not text:
        return None
    try:
        plan = FaultPlan.from_env(text)
    except (ValueError, KeyError, TypeError) as exc:
        raise ValueError(
            f"malformed {PLAN_ENV_VAR} ({exc!r}): {text[:200]!r}") from exc
    return install(plan)


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def get_plan() -> Optional[FaultPlan]:
    return _PLAN


class active:
    """``with active(plan): ...`` — install for the block, always
    uninstall after (chaos tests must never leak faults into the suite)."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return install(self.plan)

    def __exit__(self, *exc) -> None:
        uninstall()


def fault_hook(site: str, **ctx) -> None:
    """Production-code hook: a single ``None`` check when no plan is
    installed (the hot-loop cost of the resilience plane is one global
    load per site visit)."""
    if _PLAN is not None:
        _PLAN.trip(site, **ctx)


def poison_hook(site: str, value, **ctx):
    """Value-poison variant of :func:`fault_hook`."""
    if _PLAN is not None:
        return _PLAN.poison(site, value, **ctx)
    return value


def interrupt_hangs() -> None:
    """Watchdog helper: abort injected hangs if a plan is installed
    (no-op otherwise — real hangs cannot be interrupted, only abandoned)."""
    if _PLAN is not None:
        _PLAN.interrupt_hangs()
