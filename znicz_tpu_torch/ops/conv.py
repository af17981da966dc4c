"""2-D convolution forward/backward — the port of ``znicz_tpu/ops/conv.py``
(rebuild of the reference's implicit-im2col conv kernels).

Layouts are the reference's: **NHWC** activations and **HWIO** weights
``(ky, kx, c_in, n_kernels)``; ``ref_weights_view`` converts to the
reference's ``(n_kernels, ky*kx*c)`` matrix for import/export.  Geometry:
``sliding=(sy, sx)`` strides and an explicit ``padding=(top, bottom, left,
right)`` 4-tuple (ints and 2-tuples are normalized by
:func:`normalize_geometry`).

Every function takes ``xp`` (``numpy`` or ``torch``).  The numpy branch
is the reference's im2col oracle (materialized patch tensor + GEMM).  The
torch branch is plain torch: the tap loops of ``kernels/conv.py``'s plain
versions (the kernels themselves are reached through the units, on CUDA
tensors).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from znicz_tpu_torch.ops import activations


def normalize_geometry(kx: int, ky: int, sliding, padding
                       ) -> Tuple[int, int, int, int, int, int, int, int]:
    """Returns ``(ky, kx, sy, sx, pt, pb, pl, pr)``."""
    if isinstance(sliding, int):
        sy = sx = sliding
    else:
        sy, sx = sliding
    if isinstance(padding, int):
        pt = pb = pl = pr = padding
    elif len(padding) == 2:
        (pt, pl) = padding
        pb, pr = pt, pl
    else:
        pt, pb, pl, pr = padding
    return ky, kx, sy, sx, pt, pb, pl, pr


def out_size(size: int, k: int, stride: int, pad0: int, pad1: int) -> int:
    return (size + pad0 + pad1 - k) // stride + 1


def im2col(xp, x, ky, kx, sy, sx, pt, pb, pl, pr):
    """Patch tensor ``(n, oh, ow, ky, kx, c)`` of a numpy ``x``."""
    n, h, w, c = x.shape
    oh = out_size(h, ky, sy, pt, pb)
    ow = out_size(w, kx, sx, pl, pr)
    xpad = xp.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    rows = []
    for iy in range(ky):
        cols = []
        for ix in range(kx):
            cols.append(xpad[:, iy:iy + oh * sy:sy, ix:ix + ow * sx:sx, :])
        rows.append(xp.stack(cols, axis=3))
    return xp.stack(rows, axis=3), oh, ow  # (n, oh, ow, ky, kx, c)


def col2im(xp, cols_err, x_shape, ky, kx, sy, sx, pt, pb, pl, pr):
    """Scatter patch-gradients back onto the input — the reference's
    hardest kernel (overlapping atomics col2im); here an overlap-add."""
    n, h, w, c = x_shape
    oh, ow = cols_err.shape[1], cols_err.shape[2]
    padded = np.zeros((n, h + pt + pb, w + pl + pr, c), cols_err.dtype)
    for iy in range(ky):
        for ix in range(kx):
            padded[:, iy:iy + oh * sy:sy, ix:ix + ow * sx:sx, :] += \
                cols_err[:, :, :, iy, ix, :]
    return padded[:, pt:pt + h, pl:pl + w, :]


def forward_linear(xp, x, weights, bias, sliding, padding):
    """Pre-activation conv: NHWC x  *  HWIO w  (+ b)."""
    ky, kx = weights.shape[0], weights.shape[1]
    ky, kx, sy, sx, pt, pb, pl, pr = normalize_geometry(
        kx, ky, sliding, padding)
    if xp is not np:
        from znicz_tpu_torch.kernels import conv as kconv
        return kconv.conv2d_fwd_plain(x, weights, bias, (sy, sx),
                                      (pt, pb, pl, pr))
    cols, oh, ow = im2col(np, x, ky, kx, sy, sx, pt, pb, pl, pr)
    n = x.shape[0]
    v = cols.reshape(n * oh * ow, -1) @ weights.reshape(-1, weights.shape[3])
    v = v.reshape(n, oh, ow, weights.shape[3])
    if bias is not None:
        v = v + bias
    return v


def forward(xp, x, weights, bias, sliding, padding,
            activation: str = activations.LINEAR):
    return activations.forward(
        xp, activation, forward_linear(xp, x, weights, bias, sliding, padding))


def backward(xp, x, y, weights, err_output, sliding, padding,
             activation: str, activation_applied: bool = True):
    """Returns ``(err_input, grad_weights, grad_bias)``; gradients are
    summed over the batch (normalization happens in the SGD update —
    reference semantics, ops/sgd.py)."""
    ky, kx = weights.shape[0], weights.shape[1]
    ky, kx, sy, sx, pt, pb, pl, pr = normalize_geometry(
        kx, ky, sliding, padding)
    if activation_applied:
        err_v = activations.backward(xp, activation, y, err_output)
    else:
        err_v = err_output
    if xp is not np:
        from znicz_tpu_torch.kernels import conv as kconv
        geom = ((sy, sx), (pt, pb, pl, pr))
        err_input = kconv.conv2d_input_grad_plain(err_v, weights, *geom,
                                                  x.shape[1:3])
        grad_w, grad_b = kconv.conv2d_weight_grad_plain(x, err_v,
                                                        weights.shape, *geom)
        return err_input, grad_w, grad_b
    cols, oh, ow = im2col(np, x, ky, kx, sy, sx, pt, pb, pl, pr)
    n = x.shape[0]
    e = err_v.reshape(n * oh * ow, -1)
    grad_w = (cols.reshape(n * oh * ow, -1).T @ e).reshape(weights.shape)
    cols_err = (e @ weights.reshape(-1, weights.shape[3]).T).reshape(
        n, oh, ow, ky, kx, x.shape[3])
    err_input = col2im(np, cols_err, x.shape, ky, kx, sy, sx, pt, pb, pl, pr)
    grad_b = err_v.sum(axis=(0, 1, 2))
    return err_input, grad_w, grad_b


def ref_weights_view(w_hwio):
    """HWIO -> the reference's ``(n_kernels, ky*kx*c)`` matrix view
    (export/interop only — never in the hot loop)."""
    ky, kx, c, n = w_hwio.shape
    return np.transpose(np.asarray(w_hwio), (3, 0, 1, 2)).reshape(n, -1)


def from_ref_weights(w_ref, ky: int, kx: int, c: int):
    """Inverse of :func:`ref_weights_view`."""
    n = w_ref.shape[0]
    return np.transpose(np.asarray(w_ref).reshape(n, ky, kx, c),
                        (1, 2, 3, 0))
