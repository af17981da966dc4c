"""Kohonen SOM ops — the port's copy of ``znicz_tpu/ops/kohonen.py``
(rebuild of the reference's kohonen.{cl,cu} kernels: distance compute,
argmin reduction, neighborhood-weighted update).

The per-sample distance scan is one batched product (``|x-w|^2 = |x|^2 -
2 x·Wᵀ + |w|^2``) and a row argmin; the winner-neighborhood update is two
products (``ΔW = Hᵀ·X - diag(Hᵀ·1)·W``).  numpy only here: it is the
oracle the SOM units' numpy path runs and the kernel's tests compare
against; the torch path is ``kernels/kohonen.py``.
"""

from __future__ import annotations

import numpy as np


def grid_coords(xp, sy: int, sx: int):
    """(n_neurons, 2) [row, col] coordinates of the SOM grid."""
    rows = xp.repeat(xp.arange(sy), sx)
    cols = xp.tile(xp.arange(sx), sy)
    return xp.stack([rows, cols], axis=1).astype(xp.float32)


def distances_sq(xp, x, weights):
    """``(batch, n_neurons)`` squared euclidean distances; x ``(b, d)``,
    weights ``(n_neurons, d)``."""
    x2 = (x * x).sum(axis=1, keepdims=True)
    w2 = (weights * weights).sum(axis=1)
    return x2 - 2.0 * (x @ weights.T) + w2


def winners(xp, x, weights):
    """Best-matching-unit index per sample (the argmin reduction)."""
    return distances_sq(xp, x, weights).argmin(axis=1)


def neighborhood(xp, winner_idx, coords, sigma: float):
    """Gaussian grid-distance weighting ``(batch, n_neurons)`` of every
    neuron to each sample's winner."""
    wc = coords[winner_idx]                      # (b, 2)
    d2 = ((wc[:, None, :] - coords[None, :, :]) ** 2).sum(axis=2)
    return xp.exp(-d2 / (2.0 * sigma * sigma))


def update(xp, x, weights, coords, alpha: float, sigma: float,
           mask=None):
    """One batch SOM step: returns ``(new_weights, winner_idx)``.

    Batch-stable form: each neuron is pulled toward its neighborhood-
    weighted batch mean, ``W_j += alpha * (Σ_b H[b,j] x_b - Σ_b H[b,j] W_j)
    / (Σ_b H[b,j] + 1)`` — as the neighborhood mass grows this approaches
    ``alpha * (mean - W_j)`` (bounded for alpha <= 1, unlike the raw
    batch-summed delta), and neurons far from every winner barely move.
    ``mask`` (b,) zeroes padded samples' contribution.
    """
    idx = winners(xp, x, weights)
    h = neighborhood(xp, idx, coords, sigma)
    if mask is not None:
        h = h * mask.astype(h.dtype)[:, None]
    num = h.T @ x                                # (n, d)
    den = h.sum(axis=0)[:, None]                 # (n, 1)
    new_w = weights + alpha * (num - den * weights) / (den + 1.0)
    return new_w, idx


def hits(xp, winner_idx, n_neurons: int):
    """Winner histogram (reference: KohonenHits plotting input)."""
    if xp is np:
        return np.bincount(np.asarray(winner_idx), minlength=n_neurons)
    one_hot = (winner_idx[:, None] ==
               xp.arange(n_neurons)[None, :]).astype(xp.int32)
    return one_hot.sum(axis=0)
