"""Structured weight masking — the port of
``znicz_tpu/units/weights_zerofilling.py`` (rebuild of veles.znicz
weights_zerofilling.py :: ZeroFiller); a copy.

Holds a 0/1 ``mask`` per attached forward unit and re-applies
``weights *= mask`` every run (the reference used it to zero chosen weight
blocks each iteration — structured-sparsity experiments).  With the fused
step, call ``apply()`` after ``sync_to_units()`` or attach in eager mode.
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.core.units import Unit


class ZeroFiller(Unit):
    """Reference: weights_zerofilling.py :: ZeroFiller."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self._targets: list = []  # (forward_unit, mask ndarray)

    def add_target(self, forward, mask: np.ndarray) -> "ZeroFiller":
        mask = np.asarray(mask, np.float32)
        if forward.weights and \
                tuple(mask.shape) != tuple(forward.weights.shape):
            raise ValueError(f"mask shape {mask.shape} != weights "
                             f"{forward.weights.shape}")
        self._targets.append((forward, mask))
        return self

    def apply(self) -> None:
        for fwd, mask in self._targets:
            w = fwd.weights.map_read()
            fwd.weights.map_invalidate()
            fwd.weights.mem = w * mask

    def run(self) -> None:
        self.apply()
