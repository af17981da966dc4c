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
gradient units see only that buffer; the standalone activation units'
extras (``log``, ``sincos``, ``tanhlog``, ``units/activation.py``) take
theirs from the input (:func:`derivative_from_input`).  Every function
takes ``xp`` (``numpy`` or ``torch``): the numpy branch is the
reference's code, the torch branch the same arithmetic in torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LINEAR = "linear"
TANH = "tanh"
RELU = "relu"
STRICT_RELU = "strict_relu"
SIGMOID = "sigmoid"
#: standalone-unit extras (the reference's formulas, reconstructed there)
LOG = "log"            # y = log(x + sqrt(x^2+1))  (asinh — defined everywhere)
SINCOS = "sincos"      # even flat indices cos(x), odd sin(x)
TANHLOG = "tanhlog"    # LeCun tanh below |x|<=d, log-growth tail above

#: LeCun tanh constants (reference: defines.cl :: 1.7159 * tanh(2/3 x))
TANH_A = 1.7159
TANH_B = 2.0 / 3.0
#: tanh->log switchover point for TANHLOG
TANHLOG_D = 1.0


def _max0(xp, v):
    return xp.maximum(v, 0) if xp is np else torch.clamp(v, min=0)


def _parity(xp, flat):
    """0/1 per column of a (batch, rest) view: even flat indices 0."""
    n = flat.shape[1]
    return (np.arange(n) if xp is np else
            torch.arange(n, device=flat.device)) % 2


def _sincos(xp, v, even, odd):
    flat = v.reshape(v.shape[0], -1)
    out = xp.where(_parity(xp, flat)[None, :] == 0, even(flat), odd(flat))
    return out.reshape(v.shape)


def _floor_abs(xp, v, d):
    """max(|v|, d)."""
    return xp.maximum(xp.abs(v), d) if xp is np else \
        torch.clamp(v.abs(), min=d)


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
    if name == LOG:
        return xp.log(v + xp.sqrt(v * v + 1.0))
    if name == SINCOS:
        return _sincos(xp, v, xp.cos, xp.sin)
    if name == TANHLOG:
        d = TANHLOG_D
        knee = TANH_A * (np.tanh(TANH_B * d) if xp is np else
                         math.tanh(TANH_B * d))
        tail = xp.sign(v) * (knee + xp.log(_floor_abs(xp, v, d) / d))
        return xp.where(xp.abs(v) <= d, TANH_A * xp.tanh(TANH_B * v), tail)
    raise ValueError(f"unknown activation {name!r}")


def derivative_from_input(xp, name: str, x, y):
    """d(act)/dx for activations whose derivative needs the *input* —
    the standalone activation units link both sides (reference:
    ActivationBackward has input + output attrs)."""
    if name == LOG:
        return 1.0 / xp.sqrt(x * x + 1.0)
    if name == SINCOS:
        return _sincos(xp, x, lambda f: -xp.sin(f), xp.cos)
    if name == TANHLOG:
        d = TANHLOG_D
        t = TANH_A * xp.tanh(TANH_B * x)
        dtanh = TANH_B * (TANH_A - t * t / TANH_A)
        return xp.where(xp.abs(x) <= d, dtanh,
                        1.0 / _floor_abs(xp, x, d))
    return derivative_from_output(xp, name, y)


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
