"""Window pooling forward/backward — the port of
``znicz_tpu/ops/pooling.py`` (rebuild of the reference's pooling.{cl,cu}
and gradient_descent_pooling kernels): the eager max, max-|x| and average
pooling and their backwards.

Semantics kept from the reference:
- geometry ``kx/ky`` window, ``sliding`` stride; **partial border windows
  are included** (output size = ceil((in - k)/stride) + 1, window clipped
  at the edge); a window that would START beyond the input is dropped
  (torch ceil_mode semantics); see :func:`pool_out_size`;
- max variants record the winner's flat ``(row*W + col)`` offset per
  ``(n, oy, ox, c)`` for the backward scatter; ties go to the first
  window element in row-major order;
- avg divides by the *actual* (clipped) window element count;
- stochastic variants sample the winner with probability proportional to
  the (abs) activation — Zeiler&Fergus stochastic pooling; in
  ``forward_mode`` (inference) they give the probability-weighted
  expectation.  The eager units sample through the kernel
  (``kernels/pooling.py``); :func:`stochastic_forward` is the oracle.

Every function takes ``xp`` (``numpy`` or ``torch``); the numpy branch is
the reference's code.  The fused path's custom backwards are not ported
yet (ROADMAP queue A item 8a).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def pool_out_size(size: int, k: int, stride: int) -> int:
    """ceil((size - k)/stride) + 1, but never losing the first window and
    never emitting a window that STARTS beyond the input."""
    if size <= k:
        return 1
    out = -(-(size - k) // stride) + 1
    if (out - 1) * stride >= size:
        out -= 1
    return out


def window_counts(h, w, ky, kx, sy, sx):
    """Static window geometry: ``(valid, count)`` where valid (oh, ow, ky*kx)
    masks in-bounds window elements and count (oh, ow, 1) is their number.
    Pure numpy — computed once from shapes, no data touched."""
    oh = pool_out_size(h, ky, sy)
    ow = pool_out_size(w, kx, sx)
    oy = np.arange(oh)[:, None, None] * sy
    ox = np.arange(ow)[None, :, None] * sx
    iy = np.arange(ky * kx)[None, None, :] // kx
    ix = np.arange(ky * kx)[None, None, :] % kx
    valid = ((oy + iy < h) & (ox + ix < w))          # (oh, ow, ky*kx)
    return valid, valid.sum(axis=2, keepdims=True)


def _border_pad(h, w, ky, kx, sy, sx):
    """Bottom/right padding that turns znicz's clipped border windows into
    full windows over a padded input."""
    oh = pool_out_size(h, ky, sy)
    ow = pool_out_size(w, kx, sx)
    return max((oh - 1) * sy + ky - h, 0), max((ow - 1) * sx + kx - w, 0)


def _as(xp, a, like):
    """A numpy constant as ``xp``'s array (on ``like``'s device)."""
    return a if xp is np else torch.as_tensor(a, device=like.device)


def patches(xp, x, ky, kx, sy, sx, pad_value=0.0):
    """``(patch, valid, count)`` where patch is (n, oh, ow, ky*kx, c) with
    out-of-bounds elements set to ``pad_value``."""
    n, h, w, c = x.shape
    oh = pool_out_size(h, ky, sy)
    ow = pool_out_size(w, kx, sx)
    pb, pr = _border_pad(h, w, ky, kx, sy, sx)
    if xp is np:
        xpad = np.pad(x, ((0, 0), (0, pb), (0, pr), (0, 0)),
                      constant_values=pad_value)
    else:
        xpad = F.pad(x, (0, 0, 0, pr, 0, pb), value=pad_value)
    parts = []
    for iy in range(ky):
        for ix in range(kx):
            parts.append(xpad[:, iy:iy + oh * sy:sy, ix:ix + ow * sx:sx, :])
    patch = np.stack(parts, axis=3) if xp is np else torch.stack(parts, 3)
    valid, count = window_counts(h, w, ky, kx, sy, sx)
    return patch, _as(xp, valid, x), count


def offsets_of(xp, winner_idx, in_shape, ky, kx, sy, sx):
    """Flat (row*W + col) input offset of window element ``winner_idx``
    (n, oh, ow, c) — the reference's ``input_offset`` payload."""
    _, h, w, _ = in_shape
    oh, ow = winner_idx.shape[1], winner_idx.shape[2]
    oy = _as(xp, np.arange(oh)[None, :, None, None] * sy, winner_idx)
    ox = _as(xp, np.arange(ow)[None, None, :, None] * sx, winner_idx)
    row = oy + winner_idx // kx
    col = ox + winner_idx % kx
    off = row * w + col
    return off.astype(np.int32) if xp is np else off.to(torch.int32)


def max_forward(xp, x, ky, kx, sy, sx, use_abs: bool = False):
    """Returns ``(y, offsets)``; the first maximum of a window wins."""
    patch, valid, _ = patches(xp, x, ky, kx, sy, sx, pad_value=NEG_INF)
    key = xp.abs(patch) if use_abs else patch
    key = xp.where(valid[None, :, :, :, None], key, NEG_INF)
    if xp is np:
        idx = key.argmax(axis=3)                              # (n,oh,ow,c)
        y = np.take_along_axis(patch, idx[:, :, :, None, :],
                               axis=3)[:, :, :, 0, :]
    else:
        idx = key.argmax(dim=3)     # torch: the first maximal index too
        y = torch.gather(patch, 3, idx[:, :, :, None, :])[:, :, :, 0, :]
    return y, offsets_of(xp, idx, x.shape, ky, kx, sy, sx)


def avg_forward(xp, x, ky, kx, sy, sx):
    patch, _, count = patches(xp, x, ky, kx, sy, sx, pad_value=0.0)
    count = count[None].astype(np.float32)
    if xp is np:
        return patch.sum(axis=3) / count
    return patch.sum(dim=3) / _as(xp, count, x)


def _stochastic_probs(xp, x, ky, kx, sy, sx, use_abs: bool):
    """``(patch, p, total)`` — the (abs-)activation window probabilities
    shared by train sampling and eval expectation."""
    patch, valid, _ = patches(xp, x, ky, kx, sy, sx, pad_value=0.0)
    vmask = valid[None, :, :, :, None]
    if xp is np:
        p = np.abs(patch) if use_abs else np.maximum(patch, 0.0)
    else:
        p = patch.abs() if use_abs else patch.clamp_min(0.0)
    p = xp.where(vmask, p, 0.0)
    return patch, p, p.sum(axis=3, keepdims=True)


def _stochastic_choice(xp, x, ky, kx, sy, sx, uniform, use_abs: bool):
    """Inverse-CDF winner per window -> ``(patch, idx)``.  STRICT
    compare: a zero-total window (all probabilities 0, u = 0) selects
    element 0, which is always in-bounds — the window origin is a real
    input cell."""
    patch, p, total = _stochastic_probs(xp, x, ky, kx, sy, sx, use_abs)
    cdf = np.cumsum(p, axis=3) if xp is np else torch.cumsum(p, dim=3)
    u = uniform[:, :, :, None, :] * total
    idx = (cdf < u).sum(axis=3)
    if xp is np:
        return patch, np.minimum(idx, ky * kx - 1)
    return patch, idx.clamp_max(ky * kx - 1)


def stochastic_forward(xp, x, ky, kx, sy, sx, uniform, use_abs: bool,
                       train: bool):
    """Zeiler&Fergus stochastic pooling.  ``uniform`` is (n, oh, ow, c) in
    [0, 1).  Returns ``(y, offsets)`` when training, else
    ``(expectation, None)``."""
    if not train:
        patch, p, total = _stochastic_probs(xp, x, ky, kx, sy, sx,
                                            use_abs)
        w = xp.where(total > 0, p / xp.where(total > 0, total, 1.0), 0.0)
        return (patch * w).sum(axis=3), None
    patch, idx = _stochastic_choice(xp, x, ky, kx, sy, sx, uniform,
                                    use_abs)
    if xp is np:
        y = np.take_along_axis(patch, idx[:, :, :, None, :],
                               axis=3)[:, :, :, 0, :]
    else:
        y = torch.gather(patch, 3, idx[:, :, :, None, :])[:, :, :, 0, :]
    return y, offsets_of(xp, idx, x.shape, ky, kx, sy, sx)


def scatter_backward(xp, err_output, offsets, in_shape, window=None):
    """Route err to recorded winner offsets (max/stochastic backward).

    The numpy branch is the reference's ``np.add.at``: each input cell
    sums its terms in output order.  The torch branch gives the same
    bits on every device and every run, so it takes the pooling
    ``window`` ``(ky, kx, sy, sx)``: where windows do not overlap
    (stride >= window) a cell receives at most one term and a scatter is
    exact; where they do, :func:`_tap_scatter` adds the terms without
    atomics in ``np.add.at``'s order."""
    n, h, w, c = in_shape
    flat = offsets.reshape(n, -1, c)
    e = err_output.reshape(n, -1, c)
    if xp is np:
        out = np.zeros((n, h * w, c), err_output.dtype)
        ni = np.arange(n)[:, None, None]
        ci = np.arange(c)[None, None, :]
        np.add.at(out, (ni, flat, ci), e)
        return out.reshape(in_shape)
    if window is None:
        raise ValueError("the torch scatter needs the pooling window "
                         "(ky, kx, sy, sx)")
    ky, kx, sy, sx = window
    if sy < ky or sx < kx:
        return _tap_scatter(err_output, offsets, in_shape, ky, kx, sy, sx)
    out = torch.zeros((n, h * w, c), dtype=err_output.dtype,
                      device=err_output.device)
    out.scatter_add_(1, flat.long(), e)
    return out.reshape(in_shape)


def _tap_scatter(err_output, offsets, in_shape, ky, kx, sy, sx):
    """Overlapping windows: one pass a tap, in DESCENDING tap order, adds
    each output's err (or +0.0) into the strided view of the tap's input
    cells, in an output padded to whole windows and then cropped.  The
    windows covering a cell meet it at descending taps in ascending
    (oy, ox) order, which is ``np.add.at``'s order, and adding +0.0
    changes no sum, so the result is the numpy branch's, bit for bit."""
    n, h, w, c = in_shape
    oh, ow = pool_out_size(h, ky, sy), pool_out_size(w, kx, sx)
    e = err_output.reshape(n, oh, ow, c)
    off = offsets.reshape(n, oh, ow, c)
    dev, it = e.device, off.dtype
    oy = torch.arange(oh, device=dev, dtype=it)[None, :, None, None] * sy
    ox = torch.arange(ow, device=dev, dtype=it)[None, None, :, None] * sx
    tap = (off // w - oy) * kx + (off % w - ox)      # the winner's tap
    ph, pw = max(h, (oh - 1) * sy + ky), max(w, (ow - 1) * sx + kx)
    out = torch.zeros((n, ph, pw, c), dtype=e.dtype, device=dev)
    for t in reversed(range(ky * kx)):
        iy, ix = divmod(t, kx)
        out[:, iy:iy + (oh - 1) * sy + 1:sy,
            ix:ix + (ow - 1) * sx + 1:sx] += torch.where(tap == t, e, 0.0)
    return out[:, :h, :w].contiguous()


def avg_backward(xp, err_output, in_shape, ky, kx, sy, sx):
    """Spread err uniformly over each (clipped) window."""
    n, h, w, c = in_shape
    oh = pool_out_size(h, ky, sy)
    ow = pool_out_size(w, kx, sx)
    _, count = window_counts(h, w, ky, kx, sy, sx)
    e = err_output / _as(xp, count[None].astype(np.float32), err_output)
    pb, pr = _border_pad(h, w, ky, kx, sy, sx)
    if xp is np:
        padded = np.zeros((n, h + pb, w + pr, c), err_output.dtype)
    else:
        padded = torch.zeros((n, h + pb, w + pr, c), dtype=err_output.dtype,
                             device=err_output.device)
    for iy in range(ky):
        for ix in range(kx):
            padded[:, iy:iy + oh * sy:sy, ix:ix + ow * sx:sx, :] += e
    return padded[:, :h, :w, :]
