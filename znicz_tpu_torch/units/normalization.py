"""Local response normalization units — the port of
``znicz_tpu/units/normalization.py`` (rebuild of veles.znicz
normalization.py :: LRNormalizerForward, LRNormalizerBackward).

AlexNet cross-map LRN with the reference's hyperparameters
(alpha/beta/k/n) and the exact-derivative backward (``ops/lrn.py``).  The
eager units are plain torch on the device: the reference's eager units
never reach its LRN kernel (``ops/pallas/lrn.py``), and neither do these.

The fused step's forward (``torch_apply``) runs in f32 and casts back
to the compute dtype, as the reference's ``xla_apply`` does, through
``kernels/lrn.py lrn``: the forward and backward kernels, x the only
saved tensor.  That is a deliberate divergence: the reference's fused
LRN is jnp under ``jax.checkpoint``, which XLA fuses into one pass on
the TPU; eager PyTorch would take some fifteen passes over the tensor
for the same forward, and the kernels give the plain version's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.kernels import lrn as klrn
from znicz_tpu_torch.ops import lrn as lrn_ops
from znicz_tpu_torch.units.nn_units import Forward, GradientDescentBase


class LRNormalizerForward(Forward):
    """Reference: LRNormalizerForward (alpha=1e-4, beta=0.75, k=2, n=5)."""

    MAPPING = {"norm"}

    def __init__(self, workflow=None, alpha=1e-4, beta=0.75, k=2.0, n=5,
                 **kwargs) -> None:
        super().__init__(workflow, include_bias=False, **kwargs)
        self.alpha, self.beta, self.k, self.n = alpha, beta, float(k), int(n)

    def _common_init(self, **kwargs) -> None:
        if not self.output or self.output.shape != self.input.shape:
            self.output.reset(shape=self.input.shape)
        self.init_array(self.input, self.output)

    def _run(self, xp, x):
        return lrn_ops.forward(xp, x, self.alpha, self.beta, self.k, self.n)

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        y = klrn.lrn.apply(x.to(torch.float32), self.alpha, self.beta,
                           self.k, self.n)
        return y.to(x.dtype)

    def numpy_run(self) -> None:
        self.output.map_invalidate()
        self.output.mem = self._run(np, self.input.mem)

    def torch_run(self) -> None:
        self.input.unmap()
        self.output.set_devmem(self._run(torch, self.input.devmem))


class LRNormalizerBackward(GradientDescentBase):
    """Reference: LRNormalizerBackward — exact derivative."""

    MAPPING = {"norm"}

    def __init__(self, workflow=None, alpha=1e-4, beta=0.75, k=2.0, n=5,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.alpha, self.beta, self.k, self.n = alpha, beta, float(k), int(n)

    def link_from_forward(self, forward) -> "LRNormalizerBackward":
        self.link_attrs(forward, "input", "output")
        self.alpha, self.beta = forward.alpha, forward.beta
        self.k, self.n = forward.k, forward.n
        return self

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        if not self.err_input or self.err_input.shape != self.input.shape:
            self.err_input.reset(shape=self.input.shape)
        self.init_array(self.err_input, self.err_output)

    def _run(self, xp, x, e):
        return lrn_ops.backward(xp, x, e, self.alpha, self.beta, self.k,
                                self.n)

    def numpy_run(self) -> None:
        err_in = self._run(np, self.input.map_read(),
                           self.err_output.map_read())
        self.err_input.map_invalidate()
        self.err_input.mem = err_in

    def torch_run(self) -> None:
        for arr in (self.input, self.err_output):
            arr.unmap()
        self.err_input.set_devmem(self._run(torch, self.input.devmem,
                                            self.err_output.devmem))
