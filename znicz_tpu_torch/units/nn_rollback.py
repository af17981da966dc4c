"""Divergence rollback — the port of ``znicz_tpu/units/nn_rollback.py``
(rebuild of veles.znicz nn_rollback.py :: NNRollback).

Epoch-gated watchdog: on validation improvement it stores host copies of
all weights/bias/momenta ("last good"); when training diverges (NaN/inf
metric, or ``fail_iterations`` epochs without improvement) it restores the
last-good state and multiplies every gd learning rate by ``lr_cut``.

The one difference from the reference: a fused step's restore copies the
stored values INTO the step's live param tensors
(``FusedTrainStep.place_params``) instead of rebinding ``step._params``.
On the card the step's CUDA graphs read the tensors they captured, so a
rebinding would leave every later replay training the poisoned weights;
the copy keeps each leaf (its ``data_ptr``) and needs no recapture.
"""

from __future__ import annotations

import math

import numpy as np

from znicz_tpu_torch.core.units import Unit


# -- shared param capture (used by NNRollback and resilience.HealthGuard) ----
def param_arrays(workflow):
    """(key, Array) pairs of every host-visible trainable buffer — the
    same inventory the snapshotter walks (weights/bias + momentum)."""
    for i, fwd in enumerate(workflow.forwards):
        for attr in ("weights", "bias"):
            # three-arg getattr: KohonenTrainer has no bias attribute
            if getattr(fwd, attr, None):
                yield f"forward.{i}.{attr}", getattr(fwd, attr)
    for i, gd in enumerate(getattr(workflow, "gds", []) or []):
        for attr in ("gradient_weights", "gradient_bias"):
            if getattr(gd, attr, None):
                yield f"gd.{i}.{attr}", getattr(gd, attr)


def capture_params(workflow) -> dict:
    """Host copy of the current trainable state (device params synced
    back first in fused workflows)."""
    step = getattr(workflow, "step", None)
    if step is not None and getattr(step, "_params", None) is not None:
        step.sync_to_units()
    return {k: np.array(arr.map_read(), copy=True)
            for k, arr in param_arrays(workflow)}


def restore_params(workflow, stored: dict) -> None:
    """Write a :func:`capture_params` copy back (and, in fused
    workflows, into the step's live leaves, where its graphs read it)."""
    for k, arr in param_arrays(workflow):
        if k in stored:
            arr.map_invalidate()
            arr.mem = stored[k].copy()
    step = getattr(workflow, "step", None)
    if step is not None and getattr(step, "_params", None) is not None:
        step.place_params(step.gather_params())


class NNRollback(Unit):
    """Reference: nn_rollback.py :: NNRollback."""

    def __init__(self, workflow=None, lr_cut: float = 0.5,
                 fail_iterations: int = 5, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.lr_cut = float(lr_cut)
        self.fail_iterations = int(fail_iterations)
        self.target_workflow = None
        self.decision = None
        self._good: dict[str, np.ndarray] = {}
        self._bad_epochs = 0
        self.rollback_count = 0

    def link_workflow_state(self, workflow) -> "NNRollback":
        self.target_workflow = workflow
        self.decision = workflow.decision
        return self

    # -- state capture (same array inventory as the snapshotter) ------------
    def _store_good(self) -> None:
        self._good = capture_params(self.target_workflow)

    def _restore_good(self) -> None:
        restore_params(self.target_workflow, self._good)

    def _metric_is_finite(self) -> bool:
        for m in self.decision.epoch_metrics:
            if m is not None and not math.isfinite(m):
                return False
        return True

    def run(self) -> None:
        dec = self.decision
        if not bool(dec.epoch_ended):
            return
        if bool(dec.improved) and self._metric_is_finite():
            self._store_good()
            self._bad_epochs = 0
            return
        self._bad_epochs += 1
        if not self._metric_is_finite() or \
                self._bad_epochs >= self.fail_iterations:
            self.force_rollback()

    def force_rollback(self) -> None:
        """Restore last-good state and cut the learning rates now —
        called by ``run`` on epoch-level divergence and by
        ``resilience/health.py HealthGuard(mode="rollback")`` on a
        per-step NaN trip."""
        if self._good:
            self._restore_good()
        for gd in getattr(self.target_workflow, "gds", []) or []:
            gd.learning_rate = float(gd.learning_rate) * self.lr_cut
            gd.learning_rate_bias = \
                float(gd.learning_rate_bias) * self.lr_cut
        self._bad_epochs = 0
        self.rollback_count += 1
        self.info(f"rollback #{self.rollback_count}: restored last-good "
                  f"weights, lr cut by {self.lr_cut}")
