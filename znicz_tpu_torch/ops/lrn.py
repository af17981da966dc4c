"""Local response normalization (cross-map, AlexNet-style) — the port of
``znicz_tpu/ops/lrn.py`` (rebuild of the reference's normalization.{cl,cu}
kernels).

    d_i = k + alpha * sum_{j in window(i)} x_j^2
    y_i = x_i * d_i^(-beta)

The channel window is ``n`` channels centred on i (clipped at the ends).
Backward is the exact derivative:

    dL/dx_j = e_j d_j^(-beta)
              - 2 alpha beta x_j * sum_{i: j in window(i)} e_i x_i d_i^(-beta-1)

The inverse-neighbourhood sum is the adjoint of the forward window: for
odd ``n`` it equals the forward sliding sum applied to ``t = e * x *
d^(-beta-1)``; for even ``n`` the adjoint mirrors the padding.  Every
function takes ``xp`` (``numpy`` or ``torch``); plain torch on the device,
as the reference's units keep LRN on XLA.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F


def window_sum(xp, x, n: int, adjoint: bool = False):
    """Sliding sum over the channel (last) axis, window ``n`` centred,
    zero-padded.  ``adjoint=True`` mirrors the padding, giving the
    transpose of the forward operator (identical for odd n)."""
    half = n // 2
    lo, hi = (n - 1 - half, half) if adjoint else (half, n - 1 - half)
    if xp is np:
        xpad = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(lo, hi)])
    else:
        xpad = F.pad(x, (lo, hi))
    c = x.shape[-1]
    acc = xpad[..., 0:c]
    for i in range(1, n):
        acc = acc + xpad[..., i:i + c]
    return acc


def _pow_neg_beta(xp, d, beta: float):
    """``d ** -beta``; for beta = 3/4, ``d^-3/4 = sqrt(sqrt(d)) / d``."""
    if beta == 0.75:
        return xp.sqrt(xp.sqrt(d)) / d
    return d ** (-beta)


def forward(xp, x, alpha: float, beta: float, k: float, n: int):
    d = k + alpha * window_sum(xp, x * x, n)
    return x * _pow_neg_beta(xp, d, beta)


def backward(xp, x, err_output, alpha: float, beta: float, k: float, n: int):
    d = k + alpha * window_sum(xp, x * x, n)
    dnb = _pow_neg_beta(xp, d, beta)
    t = err_output * x * (dnb / d)           # d^(-beta-1)
    return err_output * dnb - 2.0 * alpha * beta * x * window_sum(
        xp, t, n, adjoint=True)
