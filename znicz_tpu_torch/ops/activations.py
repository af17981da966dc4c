"""Activation functions of the reference's fused set — the port of
``znicz_tpu/ops/activations.py``.

The semantics are the reference's (veles' activation macros), not
PyTorch's defaults:

- ``linear``:      y = x
- ``tanh``:        y = 1.7159 * tanh(2/3 x)        (LeCun-scaled tanh)
- ``relu``:        y = log(1 + e^x)                (the reference's RELU is
                    the soft ReLU, computed in its stable form)
- ``strict_relu``: y = max(0, x)
- ``sigmoid``:     y = 1 / (1 + e^-x)

Derivatives are taken from the forward output ``y``, as the reference's
gradient units see only that buffer.  Every function takes ``xp``
(``numpy`` or ``torch``): the numpy branch is the reference's code, the
torch branch the same arithmetic in torch.  The standalone-unit extras
(``log``, ``sincos``, ``tanhlog``) come with the activation units (ROADMAP
queue A, conv stack) and raise here.
"""

from __future__ import annotations

import numpy as np
import torch

LINEAR = "linear"
TANH = "tanh"
RELU = "relu"
STRICT_RELU = "strict_relu"
SIGMOID = "sigmoid"

#: LeCun tanh constants (reference: defines.cl :: 1.7159 * tanh(2/3 x))
TANH_A = 1.7159
TANH_B = 2.0 / 3.0


def _max0(xp, v):
    return xp.maximum(v, 0) if xp is np else torch.clamp(v, min=0)


def forward(xp, name: str, v):
    """Apply activation ``name`` elementwise to pre-activation ``v``."""
    if name == LINEAR:
        return v
    if name == TANH:
        return TANH_A * xp.tanh(TANH_B * v)
    if name == RELU:
        # log1p(exp(v)) overflows for large v; use the stable max + log1p form
        return _max0(xp, v) + xp.log1p(xp.exp(-xp.abs(v)))
    if name == STRICT_RELU:
        return _max0(xp, v)
    if name == SIGMOID:
        return 1.0 / (1.0 + xp.exp(-v))
    raise ValueError(f"unknown activation {name!r}")


def derivative_from_output(xp, name: str, y):
    """d(act)/d(pre-activation) expressed via the forward output ``y``."""
    if name == LINEAR:
        return xp.ones_like(y)
    if name == TANH:
        # y = A tanh(Bv)  =>  dy/dv = B (A - y^2 / A)
        return TANH_B * (TANH_A - y * y / TANH_A)
    if name == RELU:
        # y = log(1+e^v)  =>  dy/dv = sigmoid(v) = 1 - e^-y
        return 1.0 - xp.exp(-y)
    if name == STRICT_RELU:
        return (y > 0).astype(y.dtype) if xp is np else (y > 0).to(y.dtype)
    if name == SIGMOID:
        return y * (1.0 - y)
    raise ValueError(f"unknown activation {name!r}")


def backward(xp, name: str, y, err_output):
    """Propagate err through the activation: err_v = err_y * act'(y)."""
    if name == LINEAR:
        return err_output
    return err_output * derivative_from_output(xp, name, y)
