"""Per-step NaN/Inf health guard with graceful degradation.

A NaN that reaches the weights is unrecoverable without a checkpoint; a
NaN *detected as it appears* costs at most a couple of minibatches.  ``HealthGuard``
sits in the control graph right after the Decision and checks the
freshest training metrics (fused step: ``loss``/``mse``; eager MSE:
``evaluator.mse``; optionally the gradient buffers) every minibatch.

Degradation modes:

- ``mode="skip"`` (skip-batch): keep host copies of the params,
  double-buffered — a copy is promoted to the restorable "good" state
  only once a LATER finite metric certifies it (the loss published at a
  step is computed from the params *before* that step's update, so the
  freshest copy is never yet proven clean; restoring it could re-install
  the very poison being skipped).  On a non-finite metric the certified
  copy is restored — at most two batches are lost.  The copy costs one
  host sync per ``store_interval`` observations (default every
  observation — a debugging/resilience mode, not a peak-throughput
  mode; raise the interval to amortize).
- ``mode="rollback"``: delegate to a linked
  :class:`~znicz_tpu_torch.units.nn_rollback.NNRollback` — restore its
  last-good (best-validation) state and cut the learning rates, the
  reference's divergence response, but triggered per-step instead of
  per-epoch.

Trip counters (``snapshot()``) are surfaced through
``WebStatus.register_health`` next to the serving metrics, so a
dashboard shows NaN trips alongside QPS.

Scope note: the guard protects the *parameters*.  Metrics already
published to the Decision for the poisoned minibatch stay as observed
(softmax Decisions watch integer error counts, which cannot be NaN; MSE
histories may record the one poisoned entry).
"""

from __future__ import annotations

import math

import numpy as np

from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.observe import flight as _flight
from znicz_tpu_torch.observe import probe as _probe


class HealthGuard(Unit):
    """NaN/Inf watchdog over the training metrics; see module docstring."""

    MODES = ("skip", "rollback")

    def __init__(self, workflow=None, mode: str = "skip",
                 check_grads: bool = False, store_interval: int = 1,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if mode not in self.MODES:
            raise ValueError(f"unknown HealthGuard mode {mode!r}; known: "
                             f"{self.MODES}")
        if store_interval < 1:
            raise ValueError(f"store_interval must be >= 1, got "
                             f"{store_interval}")
        self.mode = mode
        self.check_grads = bool(check_grads)
        self.store_interval = int(store_interval)
        self.target_workflow = None
        self.rollback = None            # NNRollback, for mode="rollback"
        #: double buffer: _candidate holds the freshest copy (not yet
        #: certified finite by a later metric); _good holds the newest
        #: CERTIFIED copy — the only one ever restored
        self._good: dict[str, np.ndarray] = {}
        self._candidate: dict[str, np.ndarray] = {}
        self._runs = 0
        self._observations = 0
        # trip counters (WebStatus.register_health surfaces these)
        self.nan_trips = 0
        self.skipped_batches = 0
        self.rollbacks_forced = 0
        self.last_trip_run = None

    def link_workflow_state(self, workflow) -> "HealthGuard":
        self.target_workflow = workflow
        return self

    def link_rollback(self, rollback) -> "HealthGuard":
        """Attach the NNRollback unit ``mode="rollback"`` delegates to."""
        self.rollback = rollback
        return self

    # -- observation ---------------------------------------------------------
    def _observed_metrics(self):
        """(name, value) pairs of the freshest per-step training metrics.
        Zero-size deferred publishes (mid-pass placeholders) are skipped —
        their zeroed metrics carry no information."""
        w = self.target_workflow
        step = getattr(w, "step", None)
        if step is not None:
            if int(getattr(step, "minibatch_size", 0)) > 0:
                yield "loss", float(step.loss)
                yield "mse", float(step.mse)
            return
        ev = getattr(w, "evaluator", None)
        if ev is not None:
            mse = getattr(ev, "mse", None)
            if mse is not None:
                yield "mse", float(mse)

    def _grads_finite(self) -> bool:
        for gd in getattr(self.target_workflow, "gds", []) or []:
            for attr in ("gradient_weights", "gradient_bias"):
                arr = getattr(gd, attr, None)
                if arr and not np.isfinite(arr.map_read()).all():
                    return False
        return True

    def _observe(self) -> tuple[bool, bool]:
        """-> (observed_anything, all_finite).  A run with no fresh
        metrics (deferred-metrics mid-pass placeholder publishes) is a
        non-observation: the guard neither stores a param copy (the
        params could already be poisoned without an observable metric
        yet) nor trips.  ``check_grads`` only AUGMENTS a metric
        observation — it never creates one, since in fused workflows the
        gradient buffers are not refreshed per step and a vacuous
        "grads fine" must not certify anything."""
        observed = list(self._observed_metrics())
        finite = all(math.isfinite(v) for _, v in observed)
        if observed and self.check_grads:
            finite = finite and self._grads_finite()
        return bool(observed), finite

    # -- control -------------------------------------------------------------
    def run(self) -> None:
        from znicz_tpu_torch.units.nn_rollback import capture_params, \
            restore_params

        self._runs += 1
        observed, finite = self._observe()
        if not observed:
            return
        self._observations += 1
        if finite:
            if self.mode == "skip":
                # this finite metric was computed from the params the
                # CANDIDATE captured (the published loss is a pre-update
                # forward) — certify it as restorable; capture the
                # still-unproven current params as the next candidate on
                # the store interval
                if self._candidate:
                    self._good = self._candidate
                    self._candidate = {}
                if (self._observations - 1) % self.store_interval == 0:
                    self._candidate = capture_params(self.target_workflow)
            return
        self.nan_trips += 1
        self.last_trip_run = self._runs
        _probe.resilience_event("nan_guard", action=self.mode,
                                run=self._runs, trip=self.nan_trips)
        # a NaN trip is exactly the "what led up to this" moment the
        # flight recorder exists for (no-op unless flight.configure()
        # opted in)
        _flight.auto_dump("nan_guard", mode=self.mode, run=self._runs,
                          trip=self.nan_trips)
        if self.mode == "skip":
            # the candidate may be the poison itself (captured after the
            # update this metric is now flagging) — drop it
            self._candidate = {}
            if self._good:
                restore_params(self.target_workflow, self._good)
                self.skipped_batches += 1
                self.warning(f"health: non-finite metric at run "
                             f"{self._runs}; batch skipped (params "
                             f"restored, trip #{self.nan_trips})")
            else:
                self.warning(f"health: non-finite metric at run "
                             f"{self._runs} before any certified state "
                             f"was captured; nothing restored")
            return
        if self.rollback is None:
            raise RuntimeError('HealthGuard(mode="rollback") needs '
                               'link_rollback(NNRollback) before run')
        self.rollback.force_rollback()
        self.rollbacks_forced += 1
        self.warning(f"health: non-finite metric at run {self._runs}; "
                     f"forced rollback #{self.rollbacks_forced}")

    # -- observability -------------------------------------------------------
    def snapshot(self) -> dict:
        """Counters for ``WebStatus.register_health``."""
        return {"mode": self.mode,
                "runs": self._runs,
                "nan_trips": self.nan_trips,
                "skipped_batches": self.skipped_batches,
                "rollbacks_forced": self.rollbacks_forced,
                "last_trip_run": self.last_trip_run}
