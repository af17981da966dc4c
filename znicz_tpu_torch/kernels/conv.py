"""2-D convolution forward, input gradient and weight gradient as
hand-written Hopper kernels (``csrc/conv.cu``).

Replaces three Pallas calls of the JAX package, in float32 on NHWC
activations and HWIO weights with the reference's geometry (``sliding``
strides, 4-tuple ``padding``; ints and 2-tuples are normalized as
``ops/conv.py normalize_geometry`` does):

- :func:`conv2d_fwd` ``(x, w, b)`` -> ``conv(x, w) + b``
  (``ops/pallas/conv.py:97 conv2d_im2col``);
- :func:`conv2d_input_grad` ``(e, w, ..., in_hw)`` -> the input gradient
  of the cotangent ``e`` (``ops/pallas/conv_bwd.py:98 _adjoint_call``).
  The input geometry is an argument, so ``deconv2d`` can reuse it;
- :func:`conv2d_weight_grad` ``(x, e)`` -> ``(gw, gb)``, both f32
  (``ops/pallas/conv_bwd.py:118 _grad_call``); K is split into the slices
  :func:`split_k` chooses, reduced in a fixed order.

:func:`conv2d_backward` composes the two gradients with the semantics of
``ops/pallas/conv_bwd.py conv2d_backward``, launching the input gradient
only when it is needed.

Beside each kernel sits its plain PyTorch version, which repeats the TPU
kernel's arithmetic: a loop over the (iy, ix) taps, each an f32 matmul of
a strided tap slice with ``w[iy, ix]``.  The wrappers run the plain
versions on CPU tensors only; on CUDA tensors they launch the kernels or
raise.  ``fwd_launches`` / ``input_grad_launches`` /
``weight_grad_launches`` count kernel launches and nothing else.
Importing this module needs no ``nvcc``: the library is built at the
first CUDA call.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.kernels.gemm import _bound_of
from znicz_tpu_torch.ops.conv import normalize_geometry, out_size

#: kernel launches since import (or since a caller reset them to 0)
fwd_launches = 0
input_grad_launches = 0
weight_grad_launches = 0

#: the TPU kernels these replace
REPLACES_FWD = "znicz_tpu/ops/pallas/conv.py:97"
REPLACES_INPUT_GRAD = "znicz_tpu/ops/pallas/conv_bwd.py:98"
REPLACES_WEIGHT_GRAD = "znicz_tpu/ops/pallas/conv_bwd.py:118"
SOURCE = "znicz_tpu_torch/csrc/conv.cu"

#: the depth of the kernels' k tiles and the side of their output tiles
#: (BK, BM = BN in csrc/tile_f32.cuh)
K_TILE, TILE = 8, 128
#: blocks that fill the H100 once: two resident blocks of 256 threads on
#: each of its 132 SMs (the weight gradient's split-K aims at this)
WAVE_BLOCKS = 2 * 132

_lib = None


def geometry(w_shape, sliding, padding) -> tuple:
    """``(ky, kx, sy, sx, pt, pb, pl, pr)`` of HWIO weights of
    ``w_shape`` with the reference's geometry arguments."""
    return normalize_geometry(w_shape[1], w_shape[0], sliding, padding)


def _taps(xpad, iy, ix, sy, sx, oh, ow):
    """The (n, oh, ow, c) strided tap slice for window offset (iy, ix)."""
    return xpad[:, iy:iy + (oh - 1) * sy + 1:sy, ix:ix + (ow - 1) * sx + 1:sx]


def _pad(x, pt, pb, pl, pr):
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def conv2d_fwd_plain(x, w, b=None, sliding=(1, 1), padding=(0, 0, 0, 0)):
    """The plain PyTorch ``conv(x, w) + b``: one f32 matmul per tap of the
    padded input's strided slice (the TPU kernel's tap loop)."""
    ky, kx, sy, sx, pt, pb, pl, pr = geometry(w.shape, sliding, padding)
    n, h, wd, cin = x.shape
    oh, ow = out_size(h, ky, sy, pt, pb), out_size(wd, kx, sx, pl, pr)
    xpad = _pad(x, pt, pb, pl, pr)
    y = torch.zeros((n * oh * ow, w.shape[3]), dtype=x.dtype, device=x.device)
    for iy in range(ky):
        for ix in range(kx):
            tap = _taps(xpad, iy, ix, sy, sx, oh, ow).reshape(-1, cin)
            y += tap @ w[iy, ix]
    if b is not None:
        y += b
    return y.reshape(n, oh, ow, w.shape[3])


def conv2d_input_grad_plain(e, w, sliding=(1, 1), padding=(0, 0, 0, 0),
                            in_hw=None):
    """The plain PyTorch input gradient: each tap's ``e @ w[iy, ix]ᵀ``
    added onto its strided slice of the padded input, then cropped."""
    ky, kx, sy, sx, pt, _, pl, _ = geometry(w.shape, sliding, padding)
    n, oh, ow, cout = e.shape
    h, wd = in_hw
    cin = w.shape[2]
    hp = max(pt + h, (oh - 1) * sy + ky)
    wp = max(pl + wd, (ow - 1) * sx + kx)
    out = torch.zeros((n, hp, wp, cin), dtype=e.dtype, device=e.device)
    e2 = e.reshape(-1, cout)
    for iy in range(ky):
        for ix in range(kx):
            _taps(out, iy, ix, sy, sx, oh, ow).add_(
                (e2 @ w[iy, ix].t()).reshape(n, oh, ow, cin))
    return out[:, pt:pt + h, pl:pl + wd].contiguous()


def conv2d_weight_grad_plain(x, e, w_shape, sliding=(1, 1),
                             padding=(0, 0, 0, 0)):
    """The plain PyTorch ``(gw, gb)``: per tap ``tapᵀ @ e``, and the column
    sum of ``e``."""
    ky, kx, sy, sx, pt, pb, pl, pr = geometry(w_shape, sliding, padding)
    n, oh, ow, cout = e.shape
    cin = x.shape[3]
    xpad = _pad(x, pt, pb, pl, pr)
    e2 = e.reshape(-1, cout)
    gw = torch.empty((ky, kx, cin, cout), dtype=torch.float32,
                     device=x.device)
    for iy in range(ky):
        for ix in range(kx):
            gw[iy, ix] = _taps(xpad, iy, ix, sy, sx, oh, ow).reshape(
                -1, cin).t() @ e2
    return gw, e2.sum(dim=0)


def split_k(rows: int, n: int, k: int) -> tuple:
    """``(splits, per)`` of the weight gradient's K = ``k`` pixels for a
    ``rows`` x ``n`` product: enough slices that the grid fills the card
    once (``WAVE_BLOCKS``), each a whole number of k tiles, none empty."""
    tiles = math.ceil(rows / TILE) * math.ceil(n / TILE)
    k_tiles = math.ceil(k / K_TILE)
    splits = max(1, min(math.ceil(WAVE_BLOCKS / tiles), k_tiles))
    per = math.ceil(k_tiles / splits) * K_TILE
    return math.ceil(k / per), per


def _pairs(out: int, k: int, stride: int, pad: int, size: int) -> int:
    """(output, tap) pairs along one axis whose input index is inside."""
    return sum(1 for o in range(out) for t in range(k)
               if 0 <= o * stride + t - pad < size)


def bound(kind: str, x_shape, w_shape, sliding=(1, 1),
          padding=(0, 0, 0, 0)) -> dict:
    """The least time the card could take for one of the three kernels
    (``kind`` "fwd", "input_grad" or "weight_grad") on the conv of an
    input of ``x_shape`` with weights of ``w_shape``: the larger of the
    flops over the f32 peak and the bytes over the HBM rate.  The flops
    are 2 per multiply-add that touches the image (taps over the padding
    need none; the same count for all three), plus the forward's bias;
    the bytes move each input once and each output once."""
    ky, kx, sy, sx, pt, pb, pl, pr = geometry(w_shape, sliding, padding)
    n, h, wd, cin = x_shape
    cout = w_shape[3]
    oh, ow = out_size(h, ky, sy, pt, pb), out_size(wd, kx, sx, pl, pr)
    macs = n * cin * cout * _pairs(oh, ky, sy, pt, h) * \
        _pairs(ow, kx, sx, pl, wd)
    x_n, w_n, y_n = n * h * wd * cin, ky * kx * cin * cout, n * oh * ow * cout
    if kind == "fwd":
        return _bound_of(2 * macs + y_n, 4 * (x_n + w_n + cout + y_n))
    if kind == "input_grad":
        return _bound_of(2 * macs, 4 * (y_n + w_n + x_n))
    if kind == "weight_grad":
        return _bound_of(2 * macs + y_n, 4 * (x_n + y_n + w_n + cout))
    raise ValueError(f"unknown conv kernel {kind!r}")


def _check(device, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (the kernels are "
                             f"f32), not {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name} has {t.numel()} elements; the kernels "
                             f"index with 32-bit ints")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the conv kernels run on cpu or cuda tensors, not "
                         f"{device.type}")


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("conv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.znicz_conv2d_fwd_f32.argtypes = [ptr] * 4 + [i32] * 13 + [ptr]
        lib.znicz_conv2d_input_grad_f32.argtypes = [ptr] * 3 + [i32] * 13 + \
            [ptr]
        lib.znicz_conv2d_weight_grad_f32.argtypes = [ptr] * 5 + \
            [i32] * 15 + [ptr]
        for fn in (lib.znicz_conv2d_fwd_f32, lib.znicz_conv2d_input_grad_f32,
                   lib.znicz_conv2d_weight_grad_f32):
            fn.restype = i32
        lib.znicz_conv_error_string.argtypes = [i32]
        lib.znicz_conv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().znicz_conv_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def conv2d_fwd(x, w, b=None, sliding=(1, 1), padding=(0, 0, 0, 0)):
    """``conv(x, w) + b`` for NHWC ``x`` (n, h, w, cin), HWIO ``w`` (ky,
    kx, cin, cout) and ``b`` (cout,) or None -> a new contiguous (n, oh,
    ow, cout); the plain version on CPU tensors, the kernel on CUDA
    tensors (on the current stream)."""
    global fwd_launches
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"need NHWC x and HWIO w with matching channels; "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    ky, kx, sy, sx, pt, pb, pl, pr = geometry(w.shape, sliding, padding)
    n, h, wd, cin = x.shape
    oh, ow = out_size(h, ky, sy, pt, pb), out_size(wd, kx, sx, pl, pr)
    cout = w.shape[3]
    if min(n, cin, cout, oh, ow) < 1:
        raise ValueError(f"empty conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, output {oh}x{ow}")
    tensors = {"x": x, "w": w}
    if b is not None:
        if tuple(b.shape) != (cout,):
            raise ValueError(f"b must be ({cout},); got {tuple(b.shape)}")
        tensors["b"] = b
    _check(x.device, **tensors)
    if x.device.type == "cpu":
        return conv2d_fwd_plain(x, w, b, sliding, padding)
    y = torch.empty((n, oh, ow, cout), dtype=torch.float32, device=x.device)
    rc = _library().znicz_conv2d_fwd_f32(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), n, h, wd, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl,
        _stream(x))
    _raise_on(rc, "conv2d_fwd")
    fwd_launches += 1
    return y


def conv2d_input_grad(e, w, sliding=(1, 1), padding=(0, 0, 0, 0),
                      in_hw=None):
    """The input gradient (n, h, w, cin) of the cotangent ``e`` (n, oh,
    ow, cout) through HWIO ``w``, for an input of spatial size ``in_hw`` =
    (h, w); the plain version on CPU tensors, the kernel on CUDA tensors."""
    global input_grad_launches
    if e.dim() != 4 or w.dim() != 4 or e.shape[3] != w.shape[3]:
        raise ValueError(f"need NHWC e and HWIO w with matching output "
                         f"channels; got {tuple(e.shape)} and "
                         f"{tuple(w.shape)}")
    ky, kx, sy, sx, pt, pb, pl, pr = geometry(w.shape, sliding, padding)
    n, oh, ow, cout = e.shape
    h, wd = (int(v) for v in in_hw)
    if (out_size(h, ky, sy, pt, pb), out_size(wd, kx, sx, pl, pr)) != \
            (oh, ow):
        raise ValueError(f"e's {oh}x{ow} is not the output of a {h}x{wd} "
                         f"input under this geometry")
    cin = w.shape[2]
    _check(e.device, e=e, w=w)
    if e.device.type == "cpu":
        return conv2d_input_grad_plain(e, w, sliding, padding, (h, wd))
    ei = torch.empty((n, h, wd, cin), dtype=torch.float32, device=e.device)
    rc = _library().znicz_conv2d_input_grad_f32(
        e.data_ptr(), w.data_ptr(), ei.data_ptr(), n, h, wd, cin, oh, ow,
        cout, ky, kx, sy, sx, pt, pl, _stream(e))
    _raise_on(rc, "conv2d_input_grad")
    input_grad_launches += 1
    return ei


def conv2d_weight_grad(x, e, w_shape, sliding=(1, 1), padding=(0, 0, 0, 0)):
    """``(gw, gb)``: the gradient (ky, kx, cin, cout) of HWIO weights of
    ``w_shape`` and of the bias (cout,), both f32, summed over the batch,
    from NHWC ``x`` and the cotangent ``e``; the plain version on CPU
    tensors, the kernel on CUDA tensors."""
    global weight_grad_launches
    w_shape = tuple(int(v) for v in w_shape)
    if x.dim() != 4 or e.dim() != 4 or len(w_shape) != 4 or \
            x.shape[3] != w_shape[2] or e.shape[3] != w_shape[3] or \
            x.shape[0] != e.shape[0]:
        raise ValueError(f"need NHWC x, e and HWIO w_shape that agree; got "
                         f"{tuple(x.shape)}, {tuple(e.shape)}, {w_shape}")
    ky, kx, sy, sx, pt, pb, pl, pr = geometry(w_shape, sliding, padding)
    n, h, wd, cin = x.shape
    _, oh, ow, cout = e.shape
    if (out_size(h, ky, sy, pt, pb), out_size(wd, kx, sx, pl, pr)) != \
            (oh, ow):
        raise ValueError(f"e's {oh}x{ow} is not the output of x's "
                         f"{h}x{wd} under this geometry")
    _check(x.device, x=x, e=e)
    if x.device.type == "cpu":
        return conv2d_weight_grad_plain(x, e, w_shape, sliding, padding)
    rows = ky * kx * cin + 1
    splits, per = split_k(rows, cout, n * oh * ow)
    part = torch.empty((splits, rows, cout), dtype=torch.float32,
                       device=x.device)
    gw = torch.empty(w_shape, dtype=torch.float32, device=x.device)
    gb = torch.empty((cout,), dtype=torch.float32, device=x.device)
    rc = _library().znicz_conv2d_weight_grad_f32(
        x.data_ptr(), e.data_ptr(), part.data_ptr(), gw.data_ptr(),
        gb.data_ptr(), n, h, wd, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl,
        splits, per, _stream(x))
    _raise_on(rc, "conv2d_weight_grad")
    weight_grad_launches += 1
    return gw, gb


def conv2d_backward(x, w, err_v, sliding=(1, 1), padding=(0, 0, 0, 0),
                    need_err_input: bool = True):
    """Linear-conv backward -> ``(err_input or None, grad_w, grad_b)`` for
    the activation-corrected cotangent ``err_v``, gradients summed over
    the batch (the semantics of ``ops/pallas/conv_bwd.py
    conv2d_backward``); the input gradient is computed only when
    ``need_err_input``."""
    err_input = conv2d_input_grad(err_v, w, sliding, padding,
                                  x.shape[1:3]) if need_err_input else None
    gw, gb = conv2d_weight_grad(x, err_v, w.shape, sliding, padding)
    return err_input, gw, gb
