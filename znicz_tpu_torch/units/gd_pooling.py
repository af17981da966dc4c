"""Pooling gradient units — the port of ``znicz_tpu/units/gd_pooling.py``
(rebuild of veles.znicz gd_pooling.py :: GDPooling, GDMaxPooling,
GDMaxAbsPooling, GDAvgPooling; the stochastic variants share the
offset-scatter backward).

Max and stochastic: scatter err through the offsets the forward
recorded; avg: spread err uniformly over each (clipped) window.  Plain
torch on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.units.nn_units import GradientDescentBase


class GDPooling(GradientDescentBase):
    """Geometry base (reference: gd_pooling.py :: GDPooling)."""

    MAPPING: set = set()

    def __init__(self, workflow=None, kx=2, ky=2, sliding=None,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.kx, self.ky = int(kx), int(ky)
        if sliding is None:
            sliding = (self.ky, self.kx)
        self.sliding = (sliding, sliding) if isinstance(sliding, int) \
            else tuple(sliding)

    @property
    def sy(self) -> int:
        return self.sliding[0]

    @property
    def sx(self) -> int:
        return self.sliding[1]

    def link_from_forward(self, forward) -> "GDPooling":
        self.link_attrs(forward, "input", "output")
        self.kx, self.ky = forward.kx, forward.ky
        self.sliding = forward.sliding
        return self

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        if not self.err_input or self.err_input.shape != self.input.shape:
            self.err_input.reset(shape=self.input.shape)
        self.init_array(self.err_input, self.err_output)


class GDMaxPooling(GDPooling):
    """Backward through recorded winner offsets (reference:
    GDMaxPooling)."""

    MAPPING = {"max_pooling"}

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.input_offset = Array()  # linked from the forward

    def link_from_forward(self, forward) -> "GDMaxPooling":
        super().link_from_forward(forward)
        self.link_attrs(forward, "input_offset")
        return self

    def numpy_run(self) -> None:
        err_in = pool_ops.scatter_backward(
            np, self.err_output.map_read(), self.input_offset.map_read(),
            self.input.shape)
        self.err_input.map_invalidate()
        self.err_input.mem = err_in

    def torch_run(self) -> None:
        for arr in (self.err_output, self.input_offset):
            arr.unmap()
        self.err_input.set_devmem(pool_ops.scatter_backward(
            torch, self.err_output.devmem, self.input_offset.devmem,
            tuple(self.input.shape), (self.ky, self.kx, self.sy, self.sx)))


class GDMaxAbsPooling(GDMaxPooling):
    """Reference: GDMaxAbsPooling — same scatter."""
    MAPPING = {"maxabs_pooling"}


class GDStochasticPooling(GDMaxPooling):
    """Stochastic pooling backward = scatter to the sampled winner."""
    MAPPING = {"stochastic_pooling"}


class GDStochasticAbsPooling(GDMaxPooling):
    MAPPING = {"stochastic_abs_pooling"}


class GDAvgPooling(GDPooling):
    """Uniform spread backward (reference: GDAvgPooling)."""

    MAPPING = {"avg_pooling"}

    def numpy_run(self) -> None:
        err_in = pool_ops.avg_backward(
            np, self.err_output.map_read(), self.input.shape,
            self.ky, self.kx, self.sy, self.sx)
        self.err_input.map_invalidate()
        self.err_input.mem = err_in

    def torch_run(self) -> None:
        self.err_output.unmap()
        self.err_input.set_devmem(pool_ops.avg_backward(
            torch, self.err_output.devmem, tuple(self.input.shape),
            self.ky, self.kx, self.sy, self.sx).contiguous())
