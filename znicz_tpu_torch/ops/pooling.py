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

Every eager function takes ``xp`` (``numpy`` or ``torch``); the numpy
branch is the reference's code.  The fused step's forms
(:func:`max_forward_fast`, :func:`maxabs_forward_fast`,
:func:`avg_forward_fast`, :func:`stochastic_forward_fast`) are torch
autograd Functions with the reference's own backwards: first-winner
masks over the k*k strided taps, each tap's term added into a strided
view of the padded input, in the reference's tap order.  No scatter and
no atomics, so overlapping windows (AlexNet's k3 s2) give the same bits
on every run.
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


#: device copies of the numpy constants the torch forms use (window
#: validity, counts, tap offsets), made once per value, dtype and device:
#: a step body captured into a CUDA graph may not copy from the host
_DEVICE_CONSTANTS: dict = {}


def _as(xp, a, like, dtype=None):
    """A numpy constant as ``xp``'s array (on ``like``'s device, read
    only: torch callers share one cached copy)."""
    if xp is np:
        return a
    a = np.ascontiguousarray(a)
    key = (a.dtype.str, a.shape, a.tobytes(), str(like.device), dtype)
    t = _DEVICE_CONSTANTS.get(key)
    if t is None:
        t = _DEVICE_CONSTANTS[key] = torch.as_tensor(a, dtype=dtype,
                                                     device=like.device)
    return t


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


# -- the fused step's forms (znicz_tpu/ops/pooling.py :107-386) ------------

def _tap_geometry(h, w, ky, kx, sy, sx):
    """``(oh, ow, ph, pw)``: the output size and the padded extent that
    holds every (possibly partial) window, at least the input's."""
    oh, ow = pool_out_size(h, ky, sy), pool_out_size(w, kx, sx)
    return oh, ow, max(h, (oh - 1) * sy + ky), max(w, (ow - 1) * sx + kx)


def _taps(xpad, oh, ow, ky, kx, sy, sx):
    """The k*k strided views of the padded input, row-major window
    order."""
    return [xpad[:, dy:dy + (oh - 1) * sy + 1:sy,
                 dx:dx + (ow - 1) * sx + 1:sx, :]
            for dy in range(ky) for dx in range(kx)]


def _pad_to(x, ph, pw, value):
    return F.pad(x, (0, 0, 0, pw - x.shape[2], 0, ph - x.shape[1]),
                 value=value)


def _add_taps(terms, shape, ky, kx, sy, sx, order):
    """The transpose of the taps: each tap's term added into the strided
    view of its input cells in an output padded to whole windows, taps
    in ``order``, then cropped to the input's ``shape``."""
    n, h, w, c = shape
    oh, ow, ph, pw = _tap_geometry(h, w, ky, kx, sy, sx)
    out = torch.zeros((n, ph, pw, c), dtype=terms[0].dtype,
                      device=terms[0].device)
    for t in order:
        dy, dx = divmod(t, kx)
        out[:, dy:dy + (oh - 1) * sy + 1:sy,
            dx:dx + (ow - 1) * sx + 1:sx] += terms[t]
    return out[:, :h, :w].contiguous()


def _first_winner_backward(x, y, g, ky, kx, sy, sx):
    """The reference's ``_mpgen_bwd``: each output's cotangent goes to the
    first tap (row-major window order) whose value equals the output."""
    oh, ow, ph, pw = _tap_geometry(*x.shape[1:3], ky, kx, sy, sx)
    taps = _taps(_pad_to(x, ph, pw, float("-inf")), oh, ow, ky, kx, sy,
                 sx)
    seen = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    terms = []
    for tap in taps:
        hit = tap == y
        terms.append(torch.where(hit & ~seen, g, 0.0))
        seen |= hit
    return _add_taps(terms, x.shape, ky, kx, sy, sx, range(ky * kx))


def _tap_max(taps):
    y = taps[0].clone(memory_format=torch.contiguous_format)
    for t in taps[1:]:
        torch.maximum(y, t, out=y)
    return y


class _MaxPoolTaps(torch.autograd.Function):
    """Max pooling as an elementwise max over the strided taps (the
    reference's ``_maxpool_taps``), any geometry."""

    @staticmethod
    def forward(ctx, x, ky, kx, sy, sx):
        oh, ow, ph, pw = _tap_geometry(*x.shape[1:3], ky, kx, sy, sx)
        y = _tap_max(_taps(_pad_to(x, ph, pw, float("-inf")), oh, ow, ky,
                           kx, sy, sx))
        ctx.save_for_backward(x, y)
        ctx.window = (ky, kx, sy, sx)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return (_first_winner_backward(x, y, g, *ctx.window), None, None,
                None, None)


class _MaxPoolNonoverlap(torch.autograd.Function):
    """Window == stride dividing the input (the reference's
    ``_maxpool_nonoverlap``): a reshape and a max; the backward puts the
    cotangent on the first winner of each window in row-major order."""

    @staticmethod
    def forward(ctx, x, ky, kx):
        n, h, w, c = x.shape
        y = x.reshape(n, h // ky, ky, w // kx, kx, c).amax(dim=(2, 4))
        ctx.save_for_backward(x, y)
        ctx.window = (ky, kx)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        ky, kx = ctx.window
        n, h, w, c = x.shape
        xr = x.reshape(n, h // ky, ky, w // kx, kx, c)
        mask = xr == y[:, :, None, :, None, :]
        # rank = the lexicographic running count of winners; the first
        # winner has rank 1
        s_dx = torch.cumsum(mask.to(torch.int32), dim=4)
        row_tot = s_dx[:, :, :, :, -1:, :]
        rank = torch.cumsum(row_tot, dim=2) - row_tot + s_dx
        dx = torch.where(mask & (rank == 1), g[:, :, None, :, None, :],
                         0.0)
        return dx.reshape(n, h, w, c), None, None


def max_forward_fast(x, ky, kx, sy, sx):
    """The fused step's max pooling: the reshape form where the windows
    tile the input exactly, else the strided taps.  Both give the same
    bits; at MNIST conv's and CIFAR conv's 2x2 pools the reshape form
    issues and runs in about half the tap form's time (``chip_smoke.py``
    fused_conv_parity, PERF.md)."""
    if (sy, sx) == (ky, kx) and x.shape[1] % ky == 0 and \
            x.shape[2] % kx == 0:
        return _MaxPoolNonoverlap.apply(x, ky, kx)
    return _MaxPoolTaps.apply(x, ky, kx, sy, sx)


class _MaxAbsPool(torch.autograd.Function):
    """The signed winner of the max-|x| window from two tap folds,
    ``pos = max(x)`` and ``neg = max(-x)`` (each over its own -inf
    padding); y is the winning tap's value in both branches, so the
    backward is the max pool's."""

    @staticmethod
    def forward(ctx, x, ky, kx, sy, sx):
        oh, ow, ph, pw = _tap_geometry(*x.shape[1:3], ky, kx, sy, sx)
        pos, neg = (_tap_max(_taps(_pad_to(v, ph, pw, float("-inf")), oh,
                                   ow, ky, kx, sy, sx)) for v in (x, -x))
        y = torch.where(pos >= neg, pos, -neg)
        ctx.save_for_backward(x, y)
        ctx.window = (ky, kx, sy, sx)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return (_first_winner_backward(x, y, g, *ctx.window), None, None,
                None, None)


def maxabs_forward_fast(x, ky, kx, sy, sx):
    return _MaxAbsPool.apply(x, ky, kx, sy, sx)


class _AvgPool(torch.autograd.Function):
    """The windowed sum over the zero-padded input (taps in row-major
    order) over the clipped window's count; the backward spreads the
    cotangent over the count and adds it to each cell's taps in
    descending tap order, the order of the transposed windowed sum the
    reference's autodiff emits."""

    @staticmethod
    def forward(ctx, x, ky, kx, sy, sx):
        n, h, w, c = x.shape
        oh, ow, ph, pw = _tap_geometry(h, w, ky, kx, sy, sx)
        taps = _taps(_pad_to(x, ph, pw, 0.0), oh, ow, ky, kx, sy, sx)
        s = taps[0].clone(memory_format=torch.contiguous_format)
        for t in taps[1:]:
            s += t
        count = _as(torch, window_counts(h, w, ky, kx, sy, sx)[1][None], x,
                    x.dtype)
        ctx.save_for_backward(count)
        ctx.geometry = (x.shape, ky, kx, sy, sx)
        return s / count

    @staticmethod
    def backward(ctx, g):
        (count,) = ctx.saved_tensors
        shape, ky, kx, sy, sx = ctx.geometry
        e = g / count
        return (_add_taps([e] * (ky * kx), shape, ky, kx, sy, sx,
                          reversed(range(ky * kx))), None, None, None, None)


def avg_forward_fast(x, ky, kx, sy, sx):
    return _AvgPool.apply(x, ky, kx, sy, sx)


class _StochasticPool(torch.autograd.Function):
    """Train-mode stochastic pooling from the uniforms ``u``: the
    inverse-CDF winner of each window (:func:`_stochastic_choice`), the
    cotangent routed to it tap by tap; ``u`` gets none."""

    @staticmethod
    def forward(ctx, x, u, ky, kx, sy, sx, use_abs):
        patch, idx = _stochastic_choice(torch, x, ky, kx, sy, sx, u,
                                        use_abs)
        y = torch.gather(patch, 3, idx[:, :, :, None, :])[:, :, :, 0, :]
        ctx.save_for_backward(idx)
        ctx.geometry = (x.shape, x.dtype, ky, kx, sy, sx)
        return y

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape, dtype, ky, kx, sy, sx = ctx.geometry
        terms = [torch.where(idx == t, g, 0.0) for t in range(ky * kx)]
        dx = _add_taps(terms, shape, ky, kx, sy, sx, range(ky * kx))
        return dx.to(dtype), None, None, None, None, None, None


def stochastic_forward_fast(x, u, ky, kx, sy, sx, use_abs: bool):
    return _StochasticPool.apply(x, u, ky, kx, sy, sx, use_abs)
