"""Input normalization unit — the port of
``znicz_tpu/units/mean_disp_normalizer.py`` (rebuild of veles.znicz
mean_disp_normalizer.py :: MeanDispNormalizer).

``output = (input - mean) * rdisp`` on the unit's device; ``mean`` and
``rdisp`` (reciprocal dispersion) are dataset statistics computed by the
loader pipeline (the reference's ImageNet workflows feed the precomputed
mean/dispersion tensors).  ``fit()`` computes them from a sample batch
when the pipeline does not supply them.  The device path is one plain
torch expression, as the reference's is one jitted jnp expression.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.memory import Array


class MeanDispNormalizer(AcceleratedUnit):
    """Reference: mean_disp_normalizer.py :: MeanDispNormalizer."""

    def __init__(self, workflow=None, epsilon: float = 1e-6,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.input = Array()
        self.mean = Array()    # linked from the loader pipeline, or fit()
        self.rdisp = Array()
        self.output = Array()
        self.epsilon = float(epsilon)

    def fit(self, samples: np.ndarray) -> None:
        """Compute mean/rdisp over a representative batch (axis 0)."""
        samples = np.asarray(samples, np.float32)
        self.mean.mem = samples.mean(axis=0)
        disp = samples.max(axis=0) - samples.min(axis=0)
        self.rdisp.mem = (1.0 / np.maximum(disp, self.epsilon)).astype(
            np.float32)

    def _common_init(self, **kwargs) -> None:
        if not self.mean or not self.rdisp:
            raise ValueError("MeanDispNormalizer needs mean/rdisp (link "
                             "them or call fit())")
        if self.mean.shape != self.input.shape[1:]:
            raise ValueError(f"mean shape {self.mean.shape} != sample shape "
                             f"{self.input.shape[1:]}")
        if not self.output or self.output.shape != self.input.shape:
            self.output.reset(shape=self.input.shape)
        self.init_array(self.input, self.mean, self.rdisp, self.output)

    @staticmethod
    def compute(xp, x, mean, rdisp):
        return (x - mean) * rdisp

    def numpy_run(self) -> None:
        self.output.map_invalidate()
        self.output.mem = self.compute(np, self.input.mem, self.mean.mem,
                                       self.rdisp.mem)

    def torch_run(self) -> None:
        for arr in (self.input, self.mean, self.rdisp):
            arr.unmap()
        self.output.set_devmem(self.compute(
            torch, self.input.devmem, self.mean.devmem, self.rdisp.devmem))
