"""Deconvolution gradient unit — the port of
``znicz_tpu/units/gd_deconv.py`` (rebuild of veles.znicz gd_deconv.py ::
GDDeconv).

err_input is the *forward* conv of err_output (adjoint of the transposed
conv); grad_weights the patch GEMM with input/error roles swapped relative
to GDConv.  No bias (matches Deconv).  On a ``TorchDevice`` the backward
is the ``deconv2d_backward`` kernels (``kernels/conv.py``; the reference's
route under ``root.common.engine.pallas``), which launch err_input only
when ``need_err_input`` is set (the reference computes it and drops it);
the SGD update is ``ops/sgd.py`` in plain torch, as in the other eager
gradient units.  The numpy path is the col2im oracle (``ops/deconv.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.kernels import conv as kconv
from znicz_tpu_torch.ops import deconv as deconv_ops, sgd
from znicz_tpu_torch.units.nn_units import GradientDescentBase


class GDDeconv(GradientDescentBase):
    """Reference: gd_deconv.py :: GDDeconv."""

    MAPPING = {"deconv"}

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.sliding = (1, 1)
        self.padding = (0, 0, 0, 0)

    def link_from_forward(self, forward) -> "GDDeconv":
        self.link_attrs(forward, "input", "output", "weights")
        self.sliding = forward.sliding
        self.padding = forward.padding
        return self

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        if not self.err_input or self.err_input.shape != self.input.shape:
            self.err_input.reset(shape=self.input.shape)
        self.init_array(self.err_input, self.err_output,
                        self.gradient_weights)

    def _backward(self, xp, x, w, err_out):
        if xp is np:
            return deconv_ops.backward(
                xp, x, w, err_out, self.sliding, self.padding)
        return kconv.deconv2d_backward(
            x.contiguous(), w, err_out.contiguous(), self.sliding,
            self.padding, need_err_input=self.need_err_input)

    def _step(self, xp, x, w, err_out, vel_w, batch_size):
        err_in, grad_w = self._backward(xp, x, w, err_out)
        if not self.need_err_input:
            err_in = None
        if self.apply_gradient:
            w, vel_w = sgd.update(xp, w, grad_w, vel_w, self.learning_rate,
                                  self.weights_decay, self.l1_vs_l2,
                                  self.gradient_moment, batch_size)
        return err_in, w, vel_w

    def numpy_run(self) -> None:
        err_in, w, vel_w = self._step(
            np, self.input.mem, self.weights.mem, self.err_output.mem,
            self.gradient_weights.mem,
            self.current_batch_size(self.err_output))
        if err_in is not None:
            self.err_input.map_invalidate()
            self.err_input.mem = err_in
        self.weights.map_invalidate()
        self.weights.mem = w
        self.gradient_weights.map_invalidate()
        self.gradient_weights.mem = vel_w

    def torch_run(self) -> None:
        err_in, w, vel_w = self._step(
            torch, self.input.devmem, self.weights.devmem,
            self.err_output.devmem, self.gradient_weights.devmem,
            self.current_batch_size(self.err_output))
        if err_in is not None:
            self.err_input.set_devmem(err_in)
        self.weights.set_devmem(w)
        self.gradient_weights.set_devmem(vel_w)
