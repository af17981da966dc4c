"""Convolutional gradient units — the port of ``znicz_tpu/units/gd_conv.py``
(rebuild of veles.znicz gd_conv.py :: GradientDescentConv, GDTanhConv,
GDRELUConv, GDStrictRELUConv, GDSigmoidConv).

On a ``TorchDevice`` the backward runs the activation derivative in plain
torch, as the reference does, then the ``conv2d_input_grad`` and
``conv2d_weight_grad`` kernels (``kernels/conv.py``; the reference's
route under ``root.common.engine.pallas``); the input gradient is launched
only when ``need_err_input`` is set (the first conv of a workflow needs
none).  The SGD update is ``ops/sgd.py`` in plain torch, as in the
reference and in the FC units.  The numpy path is the explicit
im2col/col2im oracle (``ops/conv.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.kernels import conv as kconv
from znicz_tpu_torch.ops import activations, conv as conv_ops, sgd
from znicz_tpu_torch.units.nn_units import GradientDescentBase


class GradientDescentConv(GradientDescentBase):
    """Gradient for Conv (reference: gd_conv.py :: GradientDescentConv)."""

    MAPPING = {"conv"}
    ACTIVATION = activations.LINEAR

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        # geometry is data-linked from the paired forward (link_conv_attrs)
        self.sliding = (1, 1)
        self.padding = (0, 0, 0, 0)

    def link_from_forward(self, forward) -> "GradientDescentConv":
        super().link_from_forward(forward)
        self.sliding = forward.sliding
        self.padding = forward.padding
        return self

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        if not self.err_input or self.err_input.shape != self.input.shape:
            self.err_input.reset(shape=self.input.shape)
        self.init_array(self.err_input, self.err_output,
                        self.gradient_weights, self.gradient_bias)

    def _backward(self, xp, x, y, w, err_out):
        if xp is np:
            return conv_ops.backward(
                xp, x, y, w, err_out, self.sliding, self.padding,
                self.ACTIVATION, activation_applied=True)
        # the reference's col2im-as-gather + transposed-tap-GEMM pair on
        # the conv kernels; the activation derivative stays plain torch
        err_v = activations.backward(torch, self.ACTIVATION, y,
                                     err_out).contiguous()
        return kconv.conv2d_backward(x.contiguous(), w, err_v, self.sliding,
                                     self.padding,
                                     need_err_input=self.need_err_input)

    def _step(self, xp, x, y, w, b, err_out, vel_w, vel_b, batch_size):
        err_in, grad_w, grad_b = self._backward(xp, x, y, w, err_out)
        if not self.need_err_input:
            err_in = None
        if self.apply_gradient:
            w, vel_w = sgd.update(xp, w, grad_w, vel_w, self.learning_rate,
                                  self.weights_decay, self.l1_vs_l2,
                                  self.gradient_moment, batch_size)
            if b is not None:
                b, vel_b = sgd.update(xp, b, grad_b, vel_b,
                                      self.learning_rate_bias,
                                      self.weights_decay_bias, self.l1_vs_l2,
                                      self.gradient_moment_bias, batch_size)
        return err_in, w, b, vel_w, vel_b

    def numpy_run(self) -> None:
        has_bias = bool(self.bias)
        err_in, w, b, vel_w, vel_b = self._step(
            np, self.input.mem, self.output.mem, self.weights.mem,
            self.bias.mem if has_bias else None, self.err_output.mem,
            self.gradient_weights.mem,
            self.gradient_bias.mem if has_bias else None,
            self.current_batch_size(self.err_output))
        if err_in is not None:
            self.err_input.map_invalidate()
            self.err_input.mem = err_in
        self.weights.map_invalidate()
        self.weights.mem = w
        self.gradient_weights.map_invalidate()
        self.gradient_weights.mem = vel_w
        if has_bias:
            self.bias.map_invalidate()
            self.bias.mem = b
            self.gradient_bias.map_invalidate()
            self.gradient_bias.mem = vel_b

    def torch_run(self) -> None:
        has_bias = bool(self.bias)
        err_in, w, b, vel_w, vel_b = self._step(
            torch, self.input.devmem, self.output.devmem,
            self.weights.devmem, self.bias.devmem if has_bias else None,
            self.err_output.devmem, self.gradient_weights.devmem,
            self.gradient_bias.devmem if has_bias else None,
            self.current_batch_size(self.err_output))
        if err_in is not None:
            self.err_input.set_devmem(err_in)
        self.weights.set_devmem(w)
        self.gradient_weights.set_devmem(vel_w)
        if has_bias:
            self.bias.set_devmem(b)
            self.gradient_bias.set_devmem(vel_b)


class GDTanhConv(GradientDescentConv):
    """Gradient for ConvTanh (reference: GDTanhConv)."""
    MAPPING = {"conv_tanh"}
    ACTIVATION = activations.TANH


class GDRELUConv(GradientDescentConv):
    """Gradient for ConvRELU (reference: GDRELUConv)."""
    MAPPING = {"conv_relu"}
    ACTIVATION = activations.RELU


class GDStrictRELUConv(GradientDescentConv):
    """Gradient for ConvStrictRELU (reference: GDStrictRELUConv)."""
    MAPPING = {"conv_str"}
    ACTIVATION = activations.STRICT_RELU


class GDSigmoidConv(GradientDescentConv):
    """Gradient for ConvSigmoid."""
    MAPPING = {"conv_sigmoid"}
    ACTIVATION = activations.SIGMOID
