"""Transposed convolution (deconv) forward/backward — the port of
``znicz_tpu/ops/deconv.py`` (rebuild of the reference's deconv.{cl,cu} /
gradient_descent_deconv kernels).

A Deconv is the exact adjoint of a Conv with the same geometry: its input
has the conv's *output* shape ``(n, oh, ow, n_kernels)``, its output the
conv's *input* shape ``(n, h, w, c)``, sharing the HWIO weights.

- numpy path: the reference's patch-GEMM + overlap-add ``col2im`` oracle,
  copied;
- torch path: plain torch with the jnp path's semantics.  The forward is
  ``F.conv_transpose2d`` (the lhs-dilated, flipped, io-swapped conv the
  reference writes as one ``lax.conv_general_dilated``) over the full
  ``(oh-1)*stride + k`` output, then a signed ``F.pad`` to ``out_shape``:
  the top/left pads crop, and the bottom/right one pads zeros where
  ``out_shape`` is slack or crops where it is short (the jnp path's
  negative padding).  It is differentiable, so the fused step's autograd
  takes its backward.  ``backward`` is the plain versions of the deconv
  kernels (``kernels/conv.py``).

``min_output_size`` gives the canonical inverse spatial size
``(o-1)*stride + k - pad0 - pad1`` (the conv input size that produces ``o``
outputs with nothing left over).
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.ops.conv import (col2im, forward_linear, im2col,
                                      normalize_geometry)


def min_output_size(o: int, k: int, stride: int, pad0: int, pad1: int) -> int:
    return (o - 1) * stride + k - pad0 - pad1


def output_shape_for(in_shape, weights_shape, sliding, padding):
    """Deconv output shape (the paired conv's input shape)."""
    n, oh, ow, nk = in_shape
    ky, kx, c, nk_w = weights_shape
    if nk != nk_w:
        raise ValueError(f"input channels {nk} != weight kernels {nk_w}")
    ky, kx, sy, sx, pt, pb, pl, pr = normalize_geometry(
        kx, ky, sliding, padding)
    return (n, min_output_size(oh, ky, sy, pt, pb),
            min_output_size(ow, kx, sx, pl, pr), c)


def forward(xp, x, weights, sliding, padding, out_shape):
    """x ``(n, oh, ow, nk)``, HWIO weights -> ``out_shape`` (n, h, w, c)."""
    ky, kx, c, nk = weights.shape
    ky, kx, sy, sx, pt, pb, pl, pr = normalize_geometry(
        kx, ky, sliding, padding)
    if xp is np:
        n, oh, ow, _ = x.shape
        e = x.reshape(n * oh * ow, nk)
        cols = (e @ weights.reshape(-1, nk).T).reshape(
            n, oh, ow, ky, kx, c)
        return col2im(np, cols, out_shape, ky, kx, sy, sx, pt, pb, pl, pr)
    import torch.nn.functional as F

    _, oh, ow, _ = x.shape
    h, w_out = out_shape[1], out_shape[2]
    full = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                              weights.permute(3, 2, 0, 1), stride=(sy, sx))
    # rows pt .. pt+h of the full (oh-1)*sy + ky rows (zeros past its end)
    full = F.pad(full, (-pl, w_out + pl - ((ow - 1) * sx + kx),
                        -pt, h + pt - ((oh - 1) * sy + ky)))
    return full.permute(0, 2, 3, 1)


def backward(xp, x, weights, err_output, sliding, padding):
    """Returns ``(err_input, grad_weights)``: err_input is the forward conv
    of err_output (adjoint of the adjoint); grad_weights the patch GEMM
    with input/error roles swapped relative to conv backward."""
    ky, kx, c, nk = weights.shape
    ky, kx, sy, sx, pt, pb, pl, pr = normalize_geometry(
        kx, ky, sliding, padding)
    if xp is np:
        err_input = forward_linear(np, err_output, weights, None,
                                   (sy, sx), (pt, pb, pl, pr))
        cols, oh, ow = im2col(np, err_output, ky, kx, sy, sx, pt, pb, pl, pr)
        n = x.shape[0]
        grad_w = (cols.reshape(n * oh * ow, -1).T @
                  x.reshape(n * oh * ow, nk)).reshape(weights.shape)
        return err_input, grad_w
    from znicz_tpu_torch.kernels import conv as kconv

    return kconv.deconv2d_backward_plain(x, weights, err_output, (sy, sx),
                                         (pt, pb, pl, pr))
