"""2-D convolution forward, input gradient and weight gradient, and the
transposed conv (deconv) pair over them, as hand-written Hopper kernels
(``csrc/conv.cu``).

Replaces five functions of the JAX package that reach ``pl.pallas_call``,
on NHWC activations and HWIO weights with the reference's geometry
(``sliding`` strides, 4-tuple ``padding``; ints and 2-tuples are
normalized as ``ops/conv.py normalize_geometry`` does):

- :func:`conv2d_fwd` ``(x, w, b)`` -> ``conv(x, w) + b``
  (``ops/pallas/conv.py:97 conv2d_im2col``), in float32, or on bfloat16
  operands with f32 sums, the bias added in f32 and one rounding to bf16
  (the reference kernel's ``acc += b; acc.astype(y.dtype)``);
- :func:`conv2d_input_grad` ``(e, w, ..., in_hw)`` -> the input gradient
  of the cotangent ``e`` (``ops/pallas/conv_bwd.py:98 _adjoint_call``),
  float32;
- :func:`conv2d_weight_grad` ``(x, e)`` -> ``(gw, gb)``, both f32
  (``ops/pallas/conv_bwd.py:118 _grad_call``); K is split into the slices
  :func:`split_k` chooses, reduced in a fixed order;
- :func:`deconv2d` (``ops/pallas/conv_bwd.py:164``): the input-gradient
  kernel with the data as the cotangent, for any ``out_shape``;
- :func:`deconv2d_backward` (``ops/pallas/conv_bwd.py:180``): err_input
  is the forward kernel on ``err_output``, grad_w the weight-gradient
  kernel with input and error swapped; err_input is launched only when
  it is needed.

:func:`conv2d_backward` composes the two gradients with the semantics of
``ops/pallas/conv_bwd.py conv2d_backward``, launching the input gradient
only when it is needed.

Beside each kernel sits its plain PyTorch version, which repeats the TPU
kernel's arithmetic: a loop over the (iy, ix) taps, each an f32 matmul of
a strided tap slice with ``w[iy, ix]``.  The wrappers run the plain
versions on CPU tensors only; on CUDA tensors they launch the kernels or
raise.  ``fwd_launches`` (f32) / ``fwd_bf16_launches`` /
``input_grad_launches`` / ``weight_grad_launches`` count launches of each
``conv.cu`` kernel, whichever wrapper asked for it;
``deconv_fwd_launches`` / ``deconv_bwd_launches`` count the deconv
wrappers' calls that launched, so a run can tell the two paths apart.
Importing this module needs no ``nvcc``: the library is built at the
first CUDA call.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.kernels.gemm import (BF16_FLOPS, F32_FLOPS, _bound_of,
                                          whole_wave_splits)
from znicz_tpu_torch.ops.conv import normalize_geometry, out_size

#: kernel launches since import (or since a caller reset them to 0)
fwd_launches = 0
fwd_bf16_launches = 0
input_grad_launches = 0
weight_grad_launches = 0
deconv_fwd_launches = 0
deconv_bwd_launches = 0

#: the TPU kernels these replace
REPLACES_FWD = "znicz_tpu/ops/pallas/conv.py:97"
REPLACES_INPUT_GRAD = "znicz_tpu/ops/pallas/conv_bwd.py:98"
REPLACES_WEIGHT_GRAD = "znicz_tpu/ops/pallas/conv_bwd.py:118"
REPLACES_DECONV = "znicz_tpu/ops/pallas/conv_bwd.py:164"
REPLACES_DECONV_BWD = "znicz_tpu/ops/pallas/conv_bwd.py:180"
SOURCE = "znicz_tpu_torch/csrc/conv.cu"
#: the dtypes each kernel takes (all operands alike)
FWD_DTYPES = (torch.float32, torch.bfloat16)

#: the depth of the f32 forward's k tiles (kBK in csrc/tile_f32.cuh)
K_TILE = 16
#: the f32 forward's tile family (conv_fwd_kernel<BM, BN, VEC> in
#: csrc/conv.cu): (BM, BN) -> resident blocks an SM on the H100, the
#: fewer of its two loaders', by ptxas's registers and the tile's shared
#: memory (the smoke holds this table against
#: cudaOccupancyMaxActiveBlocksPerMultiprocessor)
FWD_F32_TILES = {(128, 128): 2, (128, 96): 2, (128, 64): 3, (64, 128): 4,
                 (64, 96): 4, (64, 64): 6}
#: the weight gradient's k tiles: 32 pixels (kWgBK in csrc/conv.cu)
WEIGHT_GRAD_K_TILE = 32
#: the weight gradient's tile family (WgTile in csrc/conv.cu): (BM, BN)
#: -> resident blocks of 256 threads an SM on the H100, by ptxas's
#: registers and the tile's shared memory (the smoke holds this table
#: against cudaOccupancyMaxActiveBlocksPerMultiprocessor)
WEIGHT_GRAD_TILES = {(128, 128): 1, (128, 64): 2, (64, 128): 2, (64, 64): 3}
#: the split-K schedule spreads over at most this many waves
WEIGHT_GRAD_MAX_WAVES = 4
#: the H100's SMs
SMS = 132
#: the depth of the bf16 forward's k tiles (kBfBK in csrc/conv.cu): 64
#: bf16, one 128-byte swizzle row of its wgmma operands
BF16_K_TILE = 64
#: the bf16 forward's M tile: two warpgroups of 64 rows (kBfBM)
BF16_TILE_M = 128
#: the input gradient's tile family (IgTile in csrc/conv.cu): (BM, BN)
#: after the largest cin each takes; wider cin gets (128, 128)
INPUT_GRAD_TILES = ((8, (256, 8)), (32, (128, 32)), (64, (128, 64)),
                    (96, (128, 96)))
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
    padded input's strided slice (the TPU kernel's tap loop).  bf16
    operands are widened to f32, summed and biased in f32 and rounded
    once."""
    if x.dtype == torch.bfloat16:
        return conv2d_fwd_plain(x.float(), w.float(),
                                None if b is None else b.float(), sliding,
                                padding).to(torch.bfloat16)
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


def deconv2d_plain(x, w, sliding=(1, 1), padding=(0, 0, 0, 0),
                   out_shape=None):
    """The plain PyTorch transposed conv: the input gradient's tap loop
    with the data ``x`` (n, oh, ow, nk) as the cotangent, for the output
    size ``out_shape[1:3]``."""
    return conv2d_input_grad_plain(x, w, sliding, padding, out_shape[1:3])


def deconv2d_backward_plain(x, w, err_output, sliding=(1, 1),
                            padding=(0, 0, 0, 0), need_err_input=True):
    """The plain PyTorch ``(err_input or None, grad_w)`` of the deconv:
    the forward conv of ``err_output``, and the weight gradient with input
    and error swapped."""
    err_input = conv2d_fwd_plain(err_output, w, None, sliding, padding) \
        if need_err_input else None
    gw, _ = conv2d_weight_grad_plain(err_output, x, w.shape, sliding,
                                     padding)
    return err_input, gw


def fwd_bf16_tile(cout: int) -> int:
    """The bf16 forward's N tile for ``cout`` output channels, the twin
    of ``fwd_bf16_bn`` in csrc/conv.cu: the first of 64, 128, 192 and 256
    that holds cout, or above 256 the one of 256, 192 and 128 that pads
    cout least (the wider on a tie)."""
    for bn in (64, 128, 192, 256):
        if cout <= bn:
            return bn
    return min((256, 192, 128), key=lambda bn: math.ceil(cout / bn) * bn)


def fwd_f32_tile(m: int, cout: int) -> tuple:
    """``(BM, BN)`` of the f32 forward's tile for ``m`` = n·oh·ow output
    pixels and ``cout`` channels, the twin of ``fwd_f32_plan`` in
    csrc/conv.cu.  BN: the first of 64, 96 and 128 that holds cout, or
    above 128 the one of 128, 96 and 64 that pads cout least (the wider
    on a tie).  BM: 128, or 64 where its grid fills the last of its
    waves of resident blocks (SMS x :data:`FWD_F32_TILES`) strictly
    better."""
    bn = next((b for b in (64, 96, 128) if cout <= b), None)
    if bn is None:
        bn = min((128, 96, 64), key=lambda b: math.ceil(cout / b) * b)
    # each BM's tiles, and those rounded up to whole waves
    nt = math.ceil(cout / bn)
    t128, t64 = math.ceil(m / 128) * nt, math.ceil(m / 64) * nt
    w128, w64 = (SMS * FWD_F32_TILES[(bm, bn)] for bm in (128, 64))
    r128, r64 = math.ceil(t128 / w128) * w128, math.ceil(t64 / w64) * w64
    return (64 if t64 * r128 > t128 * r64 else 128), bn


def input_grad_tile(cin: int) -> tuple:
    """``(BM, BN)`` of the input-gradient kernel's tile for ``cin`` input
    channels (its N), the twin of ``input_grad_bn`` in csrc/conv.cu: a
    function of cin alone."""
    for most, tile in INPUT_GRAD_TILES:
        if cin <= most:
            return tile
    return 128, 128


def weight_grad_tile(rows: int, n: int) -> tuple:
    """``(BM, BN)`` of the weight-gradient kernel's tile for a product of
    ``rows`` = ky·kx·cin + 1 partial rows (the last the bias) and ``n`` =
    cout columns, the twin of ``weight_grad_code`` in csrc/conv.cu: 128
    wide unless the ky·kx·cin rows or cout are at most 64."""
    return (128 if rows - 1 > 64 else 64), (128 if n > 64 else 64)


def split_k(rows: int, n: int, k: int) -> tuple:
    """``(splits, per)`` of the weight gradient's K = ``k`` pixels for a
    ``rows`` x ``n`` product (``rows`` = ky·kx·cin + 1), the twin of the
    weight gradient's schedule in csrc/conv.cu: with ``wave`` = SMS x
    the tile's resident blocks, :func:`whole_wave_splits` over at most
    ``WEIGHT_GRAD_MAX_WAVES`` waves, each slice a whole number of
    32-pixel k tiles, none empty.  The bias row is summed by row tile 0's
    blocks, so the tiles cover rows - 1."""
    bm, bn = weight_grad_tile(rows, n)
    k_tiles = math.ceil(k / WEIGHT_GRAD_K_TILE)
    best = whole_wave_splits(
        math.ceil((rows - 1) / bm) * math.ceil(n / bn),
        SMS * WEIGHT_GRAD_TILES[(bm, bn)], k_tiles, WEIGHT_GRAD_MAX_WAVES)
    per = math.ceil(k_tiles / best) * WEIGHT_GRAD_K_TILE
    return math.ceil(k / per), per


def weight_grad_grid(rows: int, n: int, k: int) -> dict:
    """The weight gradient's launch for a ``rows`` x ``n`` product over
    ``k`` pixels: its tile, slices, blocks and resident blocks an SM."""
    bm, bn = weight_grad_tile(rows, n)
    splits, per = split_k(rows, n, k)
    blocks = math.ceil((rows - 1) / bm) * math.ceil(n / bn) * splits
    per_sm = WEIGHT_GRAD_TILES[(bm, bn)]
    return {"tile": [bm, bn], "splits": splits, "per": per,
            "blocks": blocks, "blocks_per_sm": per_sm,
            "waves": blocks / (SMS * per_sm)}


def _pairs(out: int, k: int, stride: int, pad: int, size: int) -> int:
    """(output, tap) pairs along one axis whose input index is inside."""
    return sum(1 for o in range(out) for t in range(k)
               if 0 <= o * stride + t - pad < size)


def _sizes(x_shape, w_shape, sliding, padding) -> tuple:
    """``(macs, x_n, w_n, y_n, cout)`` of the conv of an input of
    ``x_shape`` with weights of ``w_shape``: the multiply-adds that touch
    the image (taps over the padding need none) and the element counts."""
    ky, kx, sy, sx, pt, pb, pl, pr = geometry(w_shape, sliding, padding)
    n, h, wd, cin = x_shape
    cout = w_shape[3]
    oh, ow = out_size(h, ky, sy, pt, pb), out_size(wd, kx, sx, pl, pr)
    macs = n * cin * cout * _pairs(oh, ky, sy, pt, h) * \
        _pairs(ow, kx, sx, pl, wd)
    return (macs, n * h * wd * cin, ky * kx * cin * cout, n * oh * ow * cout,
            cout)


def bound(kind: str, x_shape, w_shape, sliding=(1, 1),
          padding=(0, 0, 0, 0), dtype=torch.float32) -> dict:
    """The least time the card could take for one of the three kernels
    (``kind`` "fwd", "input_grad" or "weight_grad") on the conv of an
    input of ``x_shape`` with weights of ``w_shape``: the larger of the
    flops over the peak and the bytes over the HBM rate.  The flops are 2
    per multiply-add that touches the image (the same count for all
    three), plus the forward's bias; the bytes move each input once and
    each output once.  ``dtype`` bfloat16 (the forward only) counts
    2-byte operands and the bf16 tensor-core peak."""
    macs, x_n, w_n, y_n, cout = _sizes(x_shape, w_shape, sliding, padding)
    if kind == "fwd":
        if dtype not in FWD_DTYPES:
            raise ValueError(f"no conv forward kernel for {dtype}")
        bf16 = dtype == torch.bfloat16
        return _bound_of(2 * macs + y_n,
                         (2 if bf16 else 4) * (x_n + w_n + cout + y_n),
                         BF16_FLOPS if bf16 else F32_FLOPS)
    if dtype != torch.float32:
        raise ValueError(f"the conv {kind} kernel is f32 only, not {dtype}")
    if kind == "input_grad":
        return _bound_of(2 * macs, 4 * (y_n + w_n + x_n))
    if kind == "weight_grad":
        return _bound_of(2 * macs + y_n, 4 * (x_n + y_n + w_n + cout))
    raise ValueError(f"unknown conv kernel {kind!r}")


def deconv_bound(x_shape, w_shape, sliding=(1, 1), padding=(0, 0, 0, 0),
                 out_shape=None, backward=False,
                 need_err_input=True) -> dict:
    """The same for :func:`deconv2d` (``backward`` False) or
    :func:`deconv2d_backward` on a deconv input of ``x_shape`` (n, oh, ow,
    nk) to ``out_shape`` (n, h, w, c), f32: the paired conv of an input
    of ``out_shape``.  The forward moves x, w and the output; the backward
    reads x, w and err_output and writes err_input and grad_w, with the
    multiply-adds of both products (of grad_w alone without err_input)."""
    macs, o_n, w_n, x_n, _ = _sizes(out_shape, w_shape, sliding, padding)
    if not backward:
        return _bound_of(2 * macs, 4 * (x_n + w_n + o_n))
    if need_err_input:
        return _bound_of(4 * macs, 4 * (x_n + w_n + o_n + x_n + w_n))
    return _bound_of(2 * macs, 4 * (x_n + o_n + w_n))


def _check(device, dtypes=(torch.float32,), **tensors) -> None:
    """Every tensor on ``device``, contiguous, of one dtype out of
    ``dtypes`` (the first tensor's)."""
    dtype = next(iter(tensors.values())).dtype
    for name, t in tensors.items():
        if t.dtype not in dtypes:
            raise ValueError(
                f"{name} must be {' or '.join(str(d)[6:] for d in dtypes)} "
                f"(the kernel's types), not {t.dtype}")
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, not "
                             f"{next(iter(tensors))}'s {dtype}: the "
                             f"operands must share one dtype")
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
        for fn in (lib.znicz_conv2d_fwd_f32, lib.znicz_conv2d_fwd_bf16):
            fn.argtypes = [ptr] * 4 + [i32] * 13 + [ptr]
        lib.znicz_conv2d_input_grad_f32.argtypes = [ptr] * 3 + [i32] * 13 + \
            [ptr]
        lib.znicz_conv2d_weight_grad_f32.argtypes = [ptr] * 5 + \
            [i32] * 15 + [ptr]
        for fn in (lib.znicz_conv2d_fwd_f32, lib.znicz_conv2d_fwd_bf16,
                   lib.znicz_conv2d_input_grad_f32,
                   lib.znicz_conv2d_weight_grad_f32):
            fn.restype = i32
        for fn in (lib.znicz_conv2d_fwd_bf16_tile,
                   lib.znicz_conv2d_input_grad_tile):
            fn.argtypes = [i32]
            fn.restype = i32
        lib.znicz_conv2d_weight_grad_plan.argtypes = [i32] * 3 + [ptr]
        lib.znicz_conv2d_weight_grad_plan.restype = i32
        lib.znicz_conv2d_fwd_f32_plan.argtypes = [ctypes.c_longlong, i32,
                                                  ptr]
        lib.znicz_conv2d_fwd_f32_plan.restype = i32
        lib.znicz_conv2d_fwd_f32_residency.argtypes = [i32, i32, i32]
        lib.znicz_conv2d_fwd_f32_residency.restype = i32
        lib.znicz_conv_error_string.argtypes = [i32]
        lib.znicz_conv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def weight_grad_plan_on_card(rows: int, n: int, k: int) -> dict:
    """The weight gradient's schedule as ``csrc/conv.cu`` computes it on
    this card (:func:`weight_grad_grid`'s keys but ``waves``), its
    residency from the CUDA occupancy calculator; -1 blocks an SM where
    the kernel's two loader instantiations differ."""
    out = (ctypes.c_int * 5)()
    _raise_on(_library().znicz_conv2d_weight_grad_plan(rows, n, k, out),
              "conv2d_weight_grad plan")
    bm, bn, per_sm, splits, per = out
    return {"tile": [bm, bn], "splits": splits, "per": per,
            "blocks": math.ceil((rows - 1) / bm) * math.ceil(n / bn)
            * splits, "blocks_per_sm": per_sm}


def fwd_f32_plan_on_card(m: int, cout: int) -> dict:
    """The f32 forward's tile as ``csrc/conv.cu`` chooses it on this
    card, and that tile's resident blocks an SM."""
    out = (ctypes.c_int * 3)()
    _raise_on(_library().znicz_conv2d_fwd_f32_plan(m, cout, out),
              "conv2d_fwd plan")
    return {"tile": [out[0], out[1]], "blocks_per_sm": out[2]}


def fwd_f32_residency_on_card(gathers: bool = False) -> dict:
    """``{"BMxBN": resident blocks an SM}`` of each f32 forward tile on
    this card: the fewer of its two gathers' (as the plan takes it), or
    with ``gathers`` each instantiation's, keyed ``"BMxBN/vec"`` (1 the
    16-byte gather, 0 the one-float)."""
    lib = _library()
    by = {f"{bm}x{bn}/{v}": lib.znicz_conv2d_fwd_f32_residency(bm, bn, v)
          for bm, bn in FWD_F32_TILES for v in (0, 1)}
    if gathers:
        return by
    return {f"{bm}x{bn}": min(by[f"{bm}x{bn}/0"], by[f"{bm}x{bn}/1"])
            for bm, bn in FWD_F32_TILES}


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().znicz_conv_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# -- the launches: one per kernel, each counted by the kernel it launches --

def _launch_fwd(x, w, b, geom, oh, ow, what):
    global fwd_launches, fwd_bf16_launches
    ky, kx, sy, sx, pt, _, pl, _ = geom
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    lib = _library()
    fn = lib.znicz_conv2d_fwd_bf16 if x.dtype == torch.bfloat16 else \
        lib.znicz_conv2d_fwd_f32
    rc = fn(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), n, h, wd, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl,
            _stream(x))
    _raise_on(rc, what)
    if x.dtype == torch.bfloat16:
        fwd_bf16_launches += 1
    else:
        fwd_launches += 1
    return y


def _launch_input_grad(e, w, geom, h, wd, what):
    global input_grad_launches
    ky, kx, sy, sx, pt, _, pl, _ = geom
    n, oh, ow, cout = e.shape
    cin = w.shape[2]
    ei = torch.empty((n, h, wd, cin), dtype=torch.float32, device=e.device)
    rc = _library().znicz_conv2d_input_grad_f32(
        e.data_ptr(), w.data_ptr(), ei.data_ptr(), n, h, wd, cin, oh, ow,
        cout, ky, kx, sy, sx, pt, pl, _stream(e))
    _raise_on(rc, what)
    input_grad_launches += 1
    return ei


def _launch_weight_grad(x, e, w_shape, geom, what):
    global weight_grad_launches
    ky, kx, sy, sx, pt, _, pl, _ = geom
    n, h, wd, cin = x.shape
    _, oh, ow, cout = e.shape
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
    _raise_on(rc, what)
    weight_grad_launches += 1
    return gw, gb


# -- the wrappers -----------------------------------------------------------

def conv2d_fwd(x, w, b=None, sliding=(1, 1), padding=(0, 0, 0, 0)):
    """``conv(x, w) + b`` for NHWC ``x`` (n, h, w, cin), HWIO ``w`` (ky,
    kx, cin, cout) and ``b`` (cout,) or None, all float32 or all bfloat16
    -> a new contiguous (n, oh, ow, cout) of that dtype; the plain version
    on CPU tensors, the kernel on CUDA tensors (on the current stream)."""
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"need NHWC x and HWIO w with matching channels; "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    geom = geometry(w.shape, sliding, padding)
    ky, kx, sy, sx, pt, pb, pl, pr = geom
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
    _check(x.device, FWD_DTYPES, **tensors)
    if x.device.type == "cpu":
        return conv2d_fwd_plain(x, w, b, sliding, padding)
    return _launch_fwd(x, w, b, geom, oh, ow, "conv2d_fwd")


def conv2d_input_grad(e, w, sliding=(1, 1), padding=(0, 0, 0, 0),
                      in_hw=None):
    """The input gradient (n, h, w, cin) of the cotangent ``e`` (n, oh,
    ow, cout) through HWIO ``w``, for an input of spatial size ``in_hw`` =
    (h, w); the plain version on CPU tensors, the kernel on CUDA tensors."""
    if e.dim() != 4 or w.dim() != 4 or e.shape[3] != w.shape[3]:
        raise ValueError(f"need NHWC e and HWIO w with matching output "
                         f"channels; got {tuple(e.shape)} and "
                         f"{tuple(w.shape)}")
    geom = geometry(w.shape, sliding, padding)
    ky, kx, sy, sx, pt, pb, pl, pr = geom
    _, oh, ow, _ = e.shape
    h, wd = (int(v) for v in in_hw)
    if (out_size(h, ky, sy, pt, pb), out_size(wd, kx, sx, pl, pr)) != \
            (oh, ow):
        raise ValueError(f"e's {oh}x{ow} is not the output of a {h}x{wd} "
                         f"input under this geometry")
    _check(e.device, e=e, w=w)
    if e.device.type == "cpu":
        return conv2d_input_grad_plain(e, w, sliding, padding, (h, wd))
    return _launch_input_grad(e, w, geom, h, wd, "conv2d_input_grad")


def conv2d_weight_grad(x, e, w_shape, sliding=(1, 1), padding=(0, 0, 0, 0)):
    """``(gw, gb)``: the gradient (ky, kx, cin, cout) of HWIO weights of
    ``w_shape`` and of the bias (cout,), both f32, summed over the batch,
    from NHWC ``x`` and the cotangent ``e``; the plain version on CPU
    tensors, the kernel on CUDA tensors."""
    w_shape = tuple(int(v) for v in w_shape)
    if x.dim() != 4 or e.dim() != 4 or len(w_shape) != 4 or \
            x.shape[3] != w_shape[2] or e.shape[3] != w_shape[3] or \
            x.shape[0] != e.shape[0]:
        raise ValueError(f"need NHWC x, e and HWIO w_shape that agree; got "
                         f"{tuple(x.shape)}, {tuple(e.shape)}, {w_shape}")
    geom = geometry(w_shape, sliding, padding)
    ky, kx, sy, sx, pt, pb, pl, pr = geom
    _, h, wd, _ = x.shape
    _, oh, ow, _ = e.shape
    if (out_size(h, ky, sy, pt, pb), out_size(wd, kx, sx, pl, pr)) != \
            (oh, ow):
        raise ValueError(f"e's {oh}x{ow} is not the output of x's "
                         f"{h}x{wd} under this geometry")
    _check(x.device, x=x, e=e)
    if x.device.type == "cpu":
        return conv2d_weight_grad_plain(x, e, w_shape, sliding, padding)
    return _launch_weight_grad(x, e, w_shape, geom, "conv2d_weight_grad")


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


def deconv2d(x, w, sliding=(1, 1), padding=(0, 0, 0, 0), out_shape=None):
    """The transposed conv of ``x`` (n, oh, ow, nk) through HWIO ``w``
    (ky, kx, c, nk) -> a new contiguous ``out_shape`` (n, h, w, c), f32:
    the adjoint of the conv of an (h, w) input, whatever (h, w) is (rows
    and columns no window reaches are 0; a smaller out_shape crops).  The
    plain version on CPU tensors, the input-gradient kernel on CUDA
    tensors."""
    global deconv_fwd_launches
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[3]:
        raise ValueError(f"need NHWC x and HWIO w with x's channels as w's "
                         f"kernels; got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    out_shape = tuple(int(v) for v in out_shape)
    if len(out_shape) != 4 or out_shape[0] != x.shape[0] or \
            out_shape[3] != w.shape[2] or min(out_shape) < 1:
        raise ValueError(f"out_shape {out_shape} is not (n, h, w, c) for x "
                         f"{tuple(x.shape)} and w {tuple(w.shape)}")
    _check(x.device, x=x, w=w)
    if x.device.type == "cpu":
        return deconv2d_plain(x, w, sliding, padding, out_shape)
    y = _launch_input_grad(x, w, geometry(w.shape, sliding, padding),
                           out_shape[1], out_shape[2], "deconv2d")
    deconv_fwd_launches += 1
    return y


def deconv2d_backward(x, w, err_output, sliding=(1, 1),
                      padding=(0, 0, 0, 0), need_err_input: bool = True):
    """``(err_input or None, grad_w)`` of :func:`deconv2d` for its input
    ``x`` (n, oh, ow, nk), HWIO ``w`` and ``err_output`` (n, h, w, c),
    f32, grad_w summed over the batch (the semantics of
    ``ops/pallas/conv_bwd.py deconv2d_backward``): err_input is the
    forward conv of err_output, launched only when ``need_err_input``;
    grad_w the weight gradient with input and error swapped.  The paired
    conv of err_output must give x's (oh, ow), as every out_shape of
    ``ops/deconv.py output_shape_for`` does; another raises."""
    global deconv_bwd_launches
    if x.dim() != 4 or w.dim() != 4 or err_output.dim() != 4 or \
            x.shape[3] != w.shape[3] or err_output.shape[3] != w.shape[2] \
            or x.shape[0] != err_output.shape[0]:
        raise ValueError(f"need NHWC x, err_output and HWIO w that agree; "
                         f"got {tuple(x.shape)}, {tuple(err_output.shape)}, "
                         f"{tuple(w.shape)}")
    geom = geometry(w.shape, sliding, padding)
    ky, kx, sy, sx, pt, pb, pl, pr = geom
    _, h, wd, _ = err_output.shape
    _, oh, ow, _ = x.shape
    if (out_size(h, ky, sy, pt, pb), out_size(wd, kx, sx, pl, pr)) != \
            (oh, ow):
        raise ValueError(f"err_output's {h}x{wd} does not give x's {oh}x{ow} "
                         f"under this geometry (the deconv's out_shape is "
                         f"not one its paired conv takes)")
    _check(x.device, x=x, w=w, err_output=err_output)
    if x.device.type == "cpu":
        return deconv2d_backward_plain(x, w, err_output, sliding, padding,
                                       need_err_input)
    err_input = _launch_fwd(err_output, w, None, geom, oh, ow,
                            "deconv2d_backward") if need_err_input else None
    gw, _ = _launch_weight_grad(err_output, x, tuple(w.shape), geom,
                                "deconv2d_backward")
    deconv_bwd_launches += 1
    return err_input, gw
