"""Spatial crop unit pair — the port of ``znicz_tpu/units/cutter.py``
(rebuild of veles.znicz cutter.py :: Cutter, GDCutter).

Forward crops a fixed spatial window out of an NHWC batch; the gradient
routes err back by zero-padding it into the input geometry.  Registered as
layer type "cutter" for StandardWorkflow.  Both are pure data movement:
on a ``TorchDevice`` the crop is a contiguous copy of the window and the
pad ``torch.nn.functional.pad``, bit for bit the numpy path's values.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.units.nn_units import Forward, GradientDescentBase


class Cutter(Forward):
    """Reference: cutter.py :: Cutter (crop offset ``(y, x)``, size
    ``(h, w)``)."""

    MAPPING = {"cutter"}

    def __init__(self, workflow=None, offset=(0, 0), size=None,
                 **kwargs) -> None:
        super().__init__(workflow, include_bias=False, **kwargs)
        if size is None:
            raise ValueError("Cutter requires size=(h, w)")
        self.offset = tuple(int(v) for v in offset)
        self.size = tuple(int(v) for v in size)

    def _common_init(self, **kwargs) -> None:
        n, h, w, c = self.input.shape
        oy, ox = self.offset
        ch, cw = self.size
        if oy + ch > h or ox + cw > w:
            raise ValueError(f"crop {self.offset}+{self.size} exceeds input "
                             f"{(h, w)}")
        out_shape = (n, ch, cw, c)
        if not self.output or self.output.shape != out_shape:
            self.output.reset(shape=out_shape)
        self.init_array(self.input, self.output)

    def _crop(self, x):
        oy, ox = self.offset
        ch, cw = self.size
        return x[:, oy:oy + ch, ox:ox + cw, :]

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        return self._crop(x)

    def numpy_run(self) -> None:
        self.output.map_invalidate()
        self.output.mem = np.ascontiguousarray(self._crop(self.input.mem))

    def torch_run(self) -> None:
        self.input.unmap()
        self.output.set_devmem(self._crop(self.input.devmem).contiguous())


class GDCutter(GradientDescentBase):
    """Reference: cutter.py :: GDCutter — zero-pad err into input geometry."""

    MAPPING = {"cutter"}

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.offset = (0, 0)
        self.size = None

    def link_from_forward(self, forward) -> "GDCutter":
        self.link_attrs(forward, "input", "output")
        self.offset = forward.offset
        self.size = forward.size
        return self

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        if not self.err_input or self.err_input.shape != self.input.shape:
            self.err_input.reset(shape=self.input.shape)
        self.init_array(self.err_input, self.err_output)

    def _pad(self, xp, err):
        n, h, w, c = self.input.shape
        oy, ox = self.offset
        ch, cw = self.size
        if xp is np:
            return xp.pad(err, ((0, 0), (oy, h - oy - ch),
                                (ox, w - ox - cw), (0, 0)))
        # F.pad lists (before, after) pairs from the last dim backwards
        return F.pad(err, (0, 0, ox, w - ox - cw, oy, h - oy - ch))

    def numpy_run(self) -> None:
        self.err_input.map_invalidate()
        self.err_input.mem = self._pad(np, self.err_output.map_read())

    def torch_run(self) -> None:
        self.err_input.set_devmem(self._pad(torch,
                                            self.err_output.devmem))
