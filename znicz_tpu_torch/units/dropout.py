"""Dropout units — the port of ``znicz_tpu/units/dropout.py`` (rebuild of
veles.znicz dropout.py :: DropoutForward, DropoutBackward).

Forward draws a Bernoulli mask (keep prob ``1 - dropout_ratio``) and
scales kept activations by ``1/(1-p)`` (reference semantics: the mask
Array holds 0 or 1/(1-p) and the backward reuses it); ``forward_mode``
(inference) and a ratio of 0 give the identity.  A ratio of 0 allocates
no mask, so the backward is the identity too.  This departs from the
reference, whose zero-filled never-drawn mask makes the backward return
zeros and stops every layer below the dropout from training (ROADMAP
queue C).  The numpy path draws
from the host stream, as the reference's; the torch path from the port's
device stream, ``prng.get().key(device)`` (a ``torch.Generator``), in
place of the reference's jax keys — the two frameworks draw different
bits from one seed, so the parity tests inject the mask.  Plain torch on
the device: the reference's units never reach its dropout kernel
(``ops/pallas/dropout.py``), and neither do these.

``torch_apply`` is the fused step's forward, the reference's
``xla_apply``: ``x * make_mask(u, ratio)`` with u drawn from the step's
generator in a train step, the identity at eval or at ratio 0.  Plain
torch, as the reference's fused route is jnp: the dropout kernel draws
its own bits by another rule (``bits > thresh``).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops.dropout import make_mask
from znicz_tpu_torch.units.nn_units import Forward, GradientDescentBase


class DropoutForward(Forward):
    """Reference: DropoutForward (attribute ``dropout_ratio`` = drop prob)."""

    MAPPING = {"dropout"}
    NEEDS_RNG = True

    def __init__(self, workflow=None, dropout_ratio=0.5, **kwargs) -> None:
        super().__init__(workflow, include_bias=False, **kwargs)
        self.dropout_ratio = float(dropout_ratio)
        self.mask = Array()

    def _common_init(self, **kwargs) -> None:
        if not self.output or self.output.shape != self.input.shape:
            self.output.reset(shape=self.input.shape)
        if self.dropout_ratio and (not self.mask or
                                   self.mask.shape != self.input.shape):
            self.mask.reset(shape=self.input.shape)
        self.init_array(self.input, self.output, self.mask)

    def _make_mask_np(self, shape):
        u = prng.get().uniform(0.0, 1.0, shape)
        return make_mask(np, u, self.dropout_ratio, np.float32)

    def _make_mask_torch(self, shape, device):
        u = torch.rand(shape, generator=prng.get().key(device),
                       device=device)
        return make_mask(torch, u, self.dropout_ratio, torch.float32)

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        if not train or self.dropout_ratio == 0.0:
            return x
        u = self.draw_uniform(rng, x.shape, x.device)
        return x * make_mask(torch, u, self.dropout_ratio, x.dtype)

    def numpy_run(self) -> None:
        x = self.input.mem
        self.output.map_invalidate()
        if self.forward_mode or self.dropout_ratio == 0.0:
            self.output.mem = x
            return
        mask = self._make_mask_np(x.shape)
        self.mask.map_invalidate()
        self.mask.mem = mask
        self.output.mem = x * mask

    def torch_run(self) -> None:
        self.input.unmap()
        x = self.input.devmem
        if self.forward_mode or self.dropout_ratio == 0.0:
            self.output.set_devmem(x)
            return
        mask = self._make_mask_torch(tuple(x.shape), x.device)
        self.mask.set_devmem(mask)
        self.output.set_devmem(x * mask)


class DropoutBackward(GradientDescentBase):
    """Reference: DropoutBackward — err * mask (mask already holds the
    1/(1-p) scale)."""

    MAPPING = {"dropout"}

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.mask = Array()  # linked from the forward

    def link_from_forward(self, forward) -> "DropoutBackward":
        self.link_attrs(forward, "input", "output", "mask")
        self.forward_unit = forward
        return self

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        if not self.err_input or self.err_input.shape != self.err_output.shape:
            self.err_input.reset(shape=self.err_output.shape)
        self.init_array(self.err_input, self.err_output)

    def numpy_run(self) -> None:
        e = self.err_output.map_read()
        self.err_input.map_invalidate()
        if not self.mask:
            self.err_input.mem = e
            return
        self.err_input.mem = e * self.mask.map_read()

    def torch_run(self) -> None:
        self.err_output.unmap()
        if not self.mask:
            self.err_input.set_devmem(self.err_output.devmem)
            return
        self.mask.unmap()
        self.err_input.set_devmem(self.err_output.devmem * self.mask.devmem)
