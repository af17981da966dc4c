"""Fused SGD weight update — the port of ``znicz_tpu/ops/sgd.py``.

Update rule (reference semantics):

    g     = grad_sum / batch_size
            + weights_decay * ((1 - l1_vs_l2) * w + l1_vs_l2 * sign(w))
    vel   = gradient_moment * vel + learning_rate * g
    w_new = w - vel

``xp`` is ``numpy`` or ``torch``; the numpy branch is the reference's
code.  The kernel of this rule is ``kernels/optim.py sgd_update_``.
"""

from __future__ import annotations

import numpy as np


def _cast(xp, a, dtype):
    return a.astype(dtype) if xp is np else a.to(dtype)


def update(xp, w, grad_sum, vel, learning_rate: float, weights_decay: float,
           l1_vs_l2: float, gradient_moment: float, batch_size):
    """One SGD step -> ``(w_new, vel_new)``.

    ``vel`` is the momentum buffer (zeros before the first step);
    ``batch_size`` may be a device scalar (a masked tail minibatch
    divides by its real sample count).  The math runs in ``w``'s dtype;
    ``vel`` may be stored narrow (bf16) and comes back in its own dtype.
    A weight decay given as the plain number 0 skips the decay term, as
    in the reference; a tensor never does."""
    vel_dtype = vel.dtype
    if vel_dtype != w.dtype:
        vel = _cast(xp, vel, w.dtype)
    g = grad_sum / batch_size
    if not (isinstance(weights_decay, (int, float)) and weights_decay == 0):
        g = g + weights_decay * ((1.0 - l1_vs_l2) * w +
                                 l1_vs_l2 * xp.sign(w))
    vel_new = gradient_moment * vel + learning_rate * g
    w_new = w - vel_new
    if vel_dtype != w.dtype:
        vel_new = _cast(xp, vel_new, vel_dtype)
    return w_new, vel_new
