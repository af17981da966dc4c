"""Learning-rate schedules — the port of ``znicz_tpu/units/lr_adjust.py``
(rebuild of veles.znicz lr_adjust.py :: LearningRateAdjust + policy
classes (exp, inv, step, arbitrary)); framework-free, a copy.

The unit sits in the control graph (after Decision) and mutates the
``learning_rate`` / ``learning_rate_bias`` of its linked gradient units.
The fused step (``parallel/step.py``) writes the gd units' hyperparams
into one persistent device buffer before every dispatch, so a schedule's
change reaches the next step, and on the card the captured graphs, which
read that buffer, without a recapture.  Exception: in epoch-scan mode
(``root.common.engine.scan_epoch``) the hyperparams are read once per
class pass, so the step refuses a per-minibatch (``by_epoch=False``)
schedule, as the reference's does; per-epoch schedules are unaffected.
"""

from __future__ import annotations

from typing import Optional

from znicz_tpu_torch.core.units import Unit


class LRPolicyBase:
    """lr = f(base_lr, iteration) (reference: lr_adjust policy objects)."""

    def __call__(self, base_lr: float, it: int) -> float:
        raise NotImplementedError


class FixedPolicy(LRPolicyBase):
    def __call__(self, base_lr, it):
        return base_lr


class ExpPolicy(LRPolicyBase):
    """lr = base * gamma^it (reference: exp policy)."""

    def __init__(self, gamma: float) -> None:
        self.gamma = gamma

    def __call__(self, base_lr, it):
        return base_lr * self.gamma ** it


class InvPolicy(LRPolicyBase):
    """lr = base * (1 + gamma*it)^-power (reference: inv policy)."""

    def __init__(self, gamma: float, power: float) -> None:
        self.gamma, self.power = gamma, power

    def __call__(self, base_lr, it):
        return base_lr * (1.0 + self.gamma * it) ** (-self.power)


class StepExpPolicy(LRPolicyBase):
    """lr = base * gamma^(it // step) (reference: step_exp policy)."""

    def __init__(self, gamma: float, step: int) -> None:
        self.gamma, self.step = gamma, step

    def __call__(self, base_lr, it):
        return base_lr * self.gamma ** (it // self.step)


class ArbitraryStepPolicy(LRPolicyBase):
    """Explicit [(lr, n_iterations), ...] table; the last entry's lr holds
    forever (reference: arbitrary_step policy)."""

    def __init__(self, table) -> None:
        self.table = [(float(lr), int(n)) for lr, n in table]

    def __call__(self, base_lr, it):
        for lr, n in self.table:
            if it < n:
                return lr
            it -= n
        return self.table[-1][0]


class LearningRateAdjust(Unit):
    """Reference: lr_adjust.py :: LearningRateAdjust.

    ``by_epoch``: step the schedule per epoch (gated on decision
    epoch_ended) instead of per minibatch.
    """

    def __init__(self, workflow=None, lr_policy: Optional[LRPolicyBase] = None,
                 bias_lr_policy: Optional[LRPolicyBase] = None,
                 by_epoch: bool = False, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.lr_policy = lr_policy or FixedPolicy()
        self.bias_lr_policy = bias_lr_policy or self.lr_policy
        self.by_epoch = by_epoch
        self.decision = None           # set when by_epoch
        self._gd_units: list = []      # (gd, base_lr, base_lr_bias)
        self._iteration = 0

    def add_gd_unit(self, gd) -> "LearningRateAdjust":
        self._gd_units.append((gd, float(gd.learning_rate),
                               float(gd.learning_rate_bias)))
        return self

    def run(self) -> None:
        if self.by_epoch and self.decision is not None and \
                not bool(self.decision.epoch_ended):
            return
        for gd, base_lr, base_lr_bias in self._gd_units:
            gd.learning_rate = self.lr_policy(base_lr, self._iteration)
            gd.learning_rate_bias = self.bias_lr_policy(base_lr_bias,
                                                        self._iteration)
        self._iteration += 1
