"""Fully-connected (All2All) forward and backward — the port of
``znicz_tpu/ops/linear.py``.

Weights are stored **(in, out)**, so the forward is ``x @ W`` (the
reference's layout, kept at every boundary of the port).  Every function
takes ``xp`` (``numpy`` or ``torch``); the numpy branch is the
reference's code.
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.ops import activations


def flatten_batch(xp, x):
    """(B, ...) -> (B, features) — the reference reshapes implicitly."""
    return x.reshape(x.shape[0], -1)


def forward(xp, x, weights, bias, activation: str = activations.LINEAR):
    """y = act(x·W + b).  ``bias`` may be None (include_bias=False)."""
    v = flatten_batch(xp, x) @ weights
    if bias is not None:
        v = v + bias
    return activations.forward(xp, activation, v)


def softmax_forward(xp, x, weights, bias):
    """All2AllSoftmax forward: row-max-subtracted exp-normalize.

    Returns ``(y, max_idx)`` — the per-row argmax the evaluator reads."""
    v = flatten_batch(xp, x) @ weights
    if bias is not None:
        v = v + bias
    if xp is np:
        m = v.max(axis=1, keepdims=True)
        e = xp.exp(v - m)
        y = e / e.sum(axis=1, keepdims=True)
        return y, v.argmax(axis=1)
    e = xp.exp(v - v.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True), v.argmax(dim=1)


def backward(xp, x, y, weights, err_output, activation: str,
             activation_applied: bool = True):
    """Full backward for one FC layer -> ``(err_input, grad_weights,
    grad_bias)``, the gradients **summed over the batch** (the SGD update
    divides by the batch size).  ``activation_applied=False``: err_output
    is already d/d(pre-activation) (the GDSoftmax case)."""
    x_flat = flatten_batch(xp, x)
    if activation_applied:
        err_v = activations.backward(xp, activation, y, err_output)
    else:
        err_v = err_output
    err_input = (err_v @ weights.T).reshape(x.shape)
    grad_weights = x_flat.T @ err_v
    grad_bias = err_v.sum(axis=0) if xp is np else err_v.sum(dim=0)
    return err_input, grad_weights, grad_bias
