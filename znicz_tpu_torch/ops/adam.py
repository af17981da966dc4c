"""Fused AdamW weight update — the port of ``znicz_tpu/ops/adam.py``.

Update rule (decoupled weight decay):

    g     = grad_sum / batch_size
    m'    = b1*m + (1-b1)*g
    v'    = b2*v + (1-b2)*g^2
    mhat  = m' / (1 - b1^t);  vhat = v' / (1 - b2^t)
    w'    = w - lr * (mhat / (sqrt(vhat) + eps) + weight_decay * w)

``t`` is the POST-increment step count (1 on the first step).  ``xp`` is
``numpy`` or ``torch``; the same code serves both.  The kernel of this
rule is ``kernels/optim.py adam_update_``, which takes the bias
corrections ready made, as :func:`corrected_update` does.
"""

from __future__ import annotations


def update(xp, w, grad_sum, m, v, t, learning_rate, weight_decay,
           beta1, beta2, eps, batch_size):
    """One AdamW step -> ``(w_new, m_new, v_new)``; every scalar may be a
    number or a 0-d tensor on ``w``'s device."""
    return corrected_update(xp, w, grad_sum, m, v, learning_rate,
                            weight_decay, beta1, beta2, eps,
                            1.0 - beta1 ** t, 1.0 - beta2 ** t, batch_size)


def corrected_update(xp, w, grad_sum, m, v, learning_rate, weight_decay,
                     beta1, beta2, eps, c1, c2, batch_size):
    """:func:`update` with the bias corrections ``c1 = 1 - beta1^t`` and
    ``c2 = 1 - beta2^t`` given (the reference's kernel takes them so)."""
    g = grad_sum / batch_size
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * (g * g)
    mhat = m_new / c1
    vhat = v_new / c2
    step = mhat / (xp.sqrt(vhat) + eps) + weight_decay * w
    return w - learning_rate * step, m_new, v_new
