"""Standalone activation units — the port of
``znicz_tpu/units/activation.py`` (rebuild of veles.znicz activation.py ::
ActivationForward / ActivationBackward pairs {Tanh, RELU, StrictRELU,
Sigmoid, Log, SinCos, TanhLog, Mul}).

For nets where the activation is decoupled from FC/conv.  Each pair
shares a name in the MAPPING registry so StandardWorkflow can
instantiate the backward chain automatically.  ``Mul`` is the elementwise
product of two linked inputs (gating).

On a ``TorchDevice`` both directions are plain torch on the device, as
the reference's are XLA: the backward differentiates from the INPUT
(``activations.derivative_from_input``), which the ``act_backward``
kernel, taking the output ``y``, does not.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import activations
from znicz_tpu_torch.units.nn_units import Forward, GradientDescentBase


class ActivationForward(Forward):
    """Elementwise activation as its own unit."""

    MAPPING: set = set()
    ACTIVATION = activations.LINEAR

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, include_bias=False, **kwargs)

    def _common_init(self, **kwargs) -> None:
        if not self.output or self.output.shape != self.input.shape:
            self.output.reset(shape=self.input.shape)
        self.init_array(self.input, self.output)

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        return activations.forward(torch, self.ACTIVATION, x)

    def numpy_run(self) -> None:
        self.output.map_invalidate()
        self.output.mem = activations.forward(np, self.ACTIVATION,
                                              self.input.mem)

    def torch_run(self) -> None:
        self.input.unmap()
        self.output.set_devmem(activations.forward(
            torch, self.ACTIVATION, self.input.devmem))


class ActivationBackward(GradientDescentBase):
    """err_input = err_output * act'(input) — has both input and output
    linked (reference: ActivationBackward)."""

    MAPPING: set = set()
    ACTIVATION = activations.LINEAR

    def link_from_forward(self, forward) -> "ActivationBackward":
        self.link_attrs(forward, "input", "output")
        return self

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        if not self.err_input or self.err_input.shape != self.err_output.shape:
            self.err_input.reset(shape=self.err_output.shape)
        self.init_array(self.err_input, self.err_output)

    def _backward(self, xp, x, y, e):
        return e * activations.derivative_from_input(
            xp, self.ACTIVATION, x, y)

    def numpy_run(self) -> None:
        err_in = self._backward(np, self.input.map_read(),
                                self.output.map_read(),
                                self.err_output.map_read())
        self.err_input.map_invalidate()
        self.err_input.mem = err_in

    def torch_run(self) -> None:
        self.err_input.set_devmem(self._backward(
            torch, self.input.devmem, self.output.devmem,
            self.err_output.devmem))


class ForwardTanh(ActivationForward):
    MAPPING = {"activation_tanh"}
    ACTIVATION = activations.TANH


class BackwardTanh(ActivationBackward):
    MAPPING = {"activation_tanh"}
    ACTIVATION = activations.TANH


class ForwardRELU(ActivationForward):
    MAPPING = {"activation_relu"}
    ACTIVATION = activations.RELU


class BackwardRELU(ActivationBackward):
    MAPPING = {"activation_relu"}
    ACTIVATION = activations.RELU


class ForwardStrictRELU(ActivationForward):
    MAPPING = {"activation_str"}
    ACTIVATION = activations.STRICT_RELU


class BackwardStrictRELU(ActivationBackward):
    MAPPING = {"activation_str"}
    ACTIVATION = activations.STRICT_RELU


class ForwardSigmoid(ActivationForward):
    MAPPING = {"activation_sigmoid"}
    ACTIVATION = activations.SIGMOID


class BackwardSigmoid(ActivationBackward):
    MAPPING = {"activation_sigmoid"}
    ACTIVATION = activations.SIGMOID


class ForwardLog(ActivationForward):
    MAPPING = {"activation_log"}
    ACTIVATION = activations.LOG


class BackwardLog(ActivationBackward):
    MAPPING = {"activation_log"}
    ACTIVATION = activations.LOG


class ForwardSinCos(ActivationForward):
    MAPPING = {"activation_sincos"}
    ACTIVATION = activations.SINCOS


class BackwardSinCos(ActivationBackward):
    MAPPING = {"activation_sincos"}
    ACTIVATION = activations.SINCOS


class ForwardTanhLog(ActivationForward):
    MAPPING = {"activation_tanhlog"}
    ACTIVATION = activations.TANHLOG


class BackwardTanhLog(ActivationBackward):
    MAPPING = {"activation_tanhlog"}
    ACTIVATION = activations.TANHLOG


class ForwardMul(ActivationForward):
    """y = input * input2 (elementwise gate)."""

    MAPPING = {"activation_mul"}

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.input2 = Array()

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        self.init_array(self.input2)

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        # the single-input fused-chain protocol cannot thread input2;
        # refuse rather than silently degrade to identity
        raise NotImplementedError(
            "ForwardMul (two-input gate) is eager-only; keep it outside "
            "the fused segment")

    def numpy_run(self) -> None:
        self.output.map_invalidate()
        self.output.mem = self.input.map_read() * self.input2.map_read()

    def torch_run(self) -> None:
        self.output.set_devmem(self.input.devmem * self.input2.devmem)


class BackwardMul(ActivationBackward):
    """err_input = err_output * input2."""

    MAPPING = {"activation_mul"}

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.input2 = Array()

    def link_from_forward(self, forward) -> "BackwardMul":
        self.link_attrs(forward, "input", "output", "input2")
        return self

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        self.init_array(self.input2)

    def numpy_run(self) -> None:
        self.err_input.map_invalidate()
        self.err_input.mem = self.err_output.map_read() * \
            self.input2.map_read()

    def torch_run(self) -> None:
        self.err_input.set_devmem(self.err_output.devmem *
                                  self.input2.devmem)
