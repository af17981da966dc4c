"""Resilience plane — fault injection, retries, supervised auto-resume
training, and health guards (beyond-reference; the training-side
counterpart of the serve/ plane).

The reference framework treated worker failure as fatal: an exception
anywhere tore the whole process down, and recovery meant a human
re-launching ``veles -w snap.pickle.gz``.  Production-scale training
systems treat failure as routine (TensorFlow, arXiv 1605.08695): the
supervisor catches the crash, restores the newest *valid* checkpoint and
resumes — and the snapshotter's bit-exact resume contract is exactly what
makes that recovery verifiable.

Modules:

- :mod:`znicz_tpu_torch.resilience.faults` — deterministic, seeded fault
  injection (``FaultPlan``) with explicit hook sites in the production
  code paths, so chaos tests drive real code, not mocks.
- :mod:`znicz_tpu_torch.resilience.retry` — ``RetryPolicy`` (bounded attempts,
  exponential backoff with seeded jitter, retryable-exception filter,
  per-attempt timeout) applied to the flaky-I/O surfaces.
- :mod:`znicz_tpu_torch.resilience.supervisor` — ``run_supervised``: in-process
  crash/hang supervision with checkpoint auto-resume, poison-snapshot
  rejection, and a bounded restart budget.
- :mod:`znicz_tpu_torch.resilience.health` — per-step NaN/Inf guard with
  skip-batch or rollback degradation, trip counters surfaced through
  ``WebStatus``.
- :mod:`znicz_tpu_torch.resilience.elastic` — ``run_elastic``: the
  multi-PROCESS fleet supervisor (heartbeat + exit-code watch, SIGKILL
  a worker and the fleet resumes from the newest valid snapshot at a
  possibly different world size).
"""

import importlib

#: public name -> defining submodule.  Resolution is lazy (PEP 562): the
#: fault/retry hook sites live in import-weight-sensitive modules
#: (core/workflow.py, serve/engine.py — the latter must stay importable
#: without JAX for the native serving path), and the supervisor pulls
#: the snapshotter (and thus torch) in; eager re-exports here would drag
#: that into every hook site's import chain.
_EXPORTS = {
    "FaultInjected": "faults", "HangInterrupted": "faults",
    "FaultPlan": "faults", "fault_hook": "faults", "poison_hook": "faults",
    "install": "faults", "uninstall": "faults", "active": "faults",
    "get_plan": "faults", "interrupt_hangs": "faults",
    "AttemptTimeout": "retry", "RetryPolicy": "retry",
    "DEFAULT_IO_RETRY": "retry",
    "StepHangError": "supervisor", "SupervisorExhausted": "supervisor",
    "SupervisorPolicy": "supervisor", "SupervisorReport": "supervisor",
    "find_latest_valid_snapshot": "supervisor",
    "run_supervised": "supervisor",
    "HealthGuard": "health",
    "ElasticExhausted": "elastic", "ElasticReport": "elastic",
    "run_elastic": "elastic", "start_heartbeat": "elastic",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
