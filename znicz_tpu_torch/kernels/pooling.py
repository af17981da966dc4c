"""Stochastic pooling forward as a hand-written Hopper kernel
(``csrc/pooling.cu``).

Replaces ``znicz_tpu/ops/pallas/pooling.py stochastic_pool`` (the
in-kernel-PRNG call at ``:84`` and the ``bits=`` call at ``:89``).
:func:`stochastic_pool` reads an NHWC input ``x`` (n, h, w, c) f32 with a
``ky`` x ``kx`` window and ``(sy, sx)`` strides — the reference's
ceil-mode clipped border windows (``ops/pooling.py pool_out_size``) — and
returns ``(y, offsets)``, both (n, oh, ow, c): the signed value at the
sampled tap, and that tap's flat ``row * w + col`` input offset
(``ops/pooling.py offsets_of``), which the gradient unit scatters
through.  The TPU kernel's semantics are kept bit for bit (``:25-49``):
``u = (bits >> 8) · 2⁻²⁴``; ``p = max(x, 0)`` (``|x|`` with ``use_abs``),
0 outside the input; the winner is the count of taps whose running
``cdf < u · total`` (strict), clamped to K-1, so a window of zero mass
picks tap 0.

The random operand is either ``seed=`` (the counter-based generator of
``kernels/counter_rng.py``, keyed by the seed and the flat output index)
or ``bits=``: uint32 (or int32) bits of shape (n, oh, ow, c), the TPU
kernel's test operand, through which the tests hold this kernel against
the JAX package.

The kernel takes one of two paths, with the same arithmetic on every
element (:func:`four_channel_path` says which): four consecutive
channels of one output pixel a thread where ``c % 4 == 0``, the window
has at most 16 taps and x, y, the offsets and the bits are 16-byte
aligned (MNIST conv's 32 and 64 channels, AlexNet's 96: one Philox block
for four words, float4 tap loads, float4/int4 stores); one element a
thread otherwise (at most ``MAX_TAPS`` taps).

:func:`stochastic_pool_plain` is the plain PyTorch version (the patch
tensor, running sums in tap order).  The wrapper runs it on CPU tensors
only; on CUDA tensors it launches the kernel or raises.  ``launches``
counts kernel launches and nothing else.  Importing this module needs no
``nvcc``: the library is built at the first CUDA call.
"""

from __future__ import annotations

import ctypes

import torch

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.kernels import counter_rng
from znicz_tpu_torch.kernels.gemm import _bound_of
from znicz_tpu_torch.ops import pooling as pool_ops

#: kernel launches since import (or since a caller reset them to 0)
launches = 0

#: the TPU kernel this replaces (its PRNG call; the bits= call is :89)
REPLACES = "znicz_tpu/ops/pallas/pooling.py:84"
SOURCE = "znicz_tpu_torch/csrc/pooling.cu"
#: the kernel keeps a window's taps in registers: at most this many
MAX_TAPS = 64
#: the most taps of the four-channels-a-thread path (four floats a tap)
MAX_TAPS_4 = 16

_lib = None


def output_shape(x_shape, ky: int, kx: int, sy: int, sx: int) -> tuple:
    n, h, w, c = x_shape
    return (n, pool_ops.pool_out_size(h, ky, sy),
            pool_ops.pool_out_size(w, kx, sx), c)


def four_channel_path(c: int, ky: int, kx: int, *tensors) -> bool:
    """Whether the kernel takes four channels a thread for ``c``
    channels, a ``ky`` x ``kx`` window and these operands (x, y, the
    offsets and the bits, where given): ``c % 4 == 0``, at most
    ``MAX_TAPS_4`` taps and every operand 16-byte aligned (the source's
    dispatch in ``znicz_stochastic_pool_f32``)."""
    return c % 4 == 0 and c // 4 <= 1024 and ky * kx <= MAX_TAPS_4 and \
        all(t.data_ptr() % 16 == 0 for t in tensors)


def stochastic_pool_plain(x, ky: int, kx: int, sy: int, sx: int,
                          use_abs: bool, words):
    """The plain PyTorch pick for the int64 ``words`` (one per output
    element, flat NHWC order, values in [0, 2**32)) -> ``(y, offsets)``;
    ``total`` and ``cdf`` are running sums in tap order, as the kernel
    sums them."""
    patch, valid, _ = pool_ops.patches(torch, x, ky, kx, sy, sx,
                                       pad_value=0.0)
    n, oh, ow, k, c = patch.shape
    p = patch.abs() if use_abs else patch.clamp_min(0.0)
    p = torch.where(valid[None, :, :, :, None], p, 0.0)
    total = torch.zeros((n, oh, ow, c), dtype=x.dtype, device=x.device)
    for t in range(k):
        total = total + p[:, :, :, t]
    target = counter_rng.uniform24(words).reshape(n, oh, ow, c) * total
    cdf = torch.zeros_like(total)
    idx = torch.zeros((n, oh, ow, c), dtype=torch.int64, device=x.device)
    for t in range(k):
        cdf = cdf + p[:, :, :, t]
        idx += cdf < target
    idx = idx.clamp_max(k - 1)
    y = torch.gather(patch, 3, idx[:, :, :, None, :])[:, :, :, 0, :]
    return y, pool_ops.offsets_of(torch, idx, x.shape, ky, kx, sy, sx)


def bound(x_shape, ky: int, kx: int, sy: int, sx: int,
          with_bits: bool = False) -> dict:
    """The least time the card could take: x read once, y and the offsets
    written once (and the bits read, when given) over the HBM rate,
    against 2K + 1 flops an output (the two running sums and the target)
    over the f32 peak."""
    n, h, w, c = x_shape
    m = n * pool_ops.pool_out_size(h, ky, sy) * \
        pool_ops.pool_out_size(w, kx, sx) * c
    nbytes = 4 * (n * h * w * c + (3 if with_bits else 2) * m)
    return _bound_of((2 * ky * kx + 1) * m, nbytes)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("pooling")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.znicz_stochastic_pool_f32.argtypes = \
            [ptr, ptr, ctypes.c_ulonglong, ptr, ptr] + [i32] * 11 + [ptr]
        lib.znicz_stochastic_pool_f32.restype = i32
        lib.znicz_pooling_error_string.argtypes = [i32]
        lib.znicz_pooling_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def stochastic_pool(x, ky: int, kx: int, sy: int, sx: int,
                    use_abs: bool = False, *, seed=None, bits=None):
    """Stochastic pooling of NHWC ``x`` -> ``(y, offsets)`` (f32, int32),
    drawing from ``seed`` or taking ``bits`` (exactly one of the two):
    the plain version on CPU tensors, the kernel on CUDA tensors (on the
    current stream)."""
    global launches
    if (seed is None) == (bits is None):
        raise ValueError("pass exactly one of seed= and bits=")
    if x.dim() != 4:
        raise ValueError(f"need NHWC x, got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, not {x.dtype} "
                         f"(contiguous: {x.is_contiguous()})")
    if min(ky, kx, sy, sx) < 1 or min(x.shape) < 1:
        raise ValueError(f"bad window {ky}x{kx} stride {sy}x{sx} over "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stochastic_pool runs on cpu or cuda tensors, "
                         f"not {x.device.type}")
    out = output_shape(x.shape, ky, kx, sy, sx)
    if bits is not None:
        if tuple(bits.shape) != out:
            raise ValueError(f"bits must be {out}, got {tuple(bits.shape)}")
        if bits.device != x.device or not bits.is_contiguous():
            raise ValueError(f"bits must be contiguous on {x.device}")
        words = counter_rng.as_words(bits)       # checks the dtype
    else:
        seed = counter_rng.check_seed(seed)
    if x.device.type == "cpu":
        if bits is None:
            words = counter_rng.random_bits(seed, out[0] * out[1] * out[2] *
                                            out[3], x.device)
        return stochastic_pool_plain(x, ky, kx, sy, sx, use_abs,
                                     words.reshape(-1))
    if ky * kx > MAX_TAPS:
        raise ValueError(f"the kernel takes windows of at most {MAX_TAPS} "
                         f"taps, not {ky}x{kx}")
    if x.numel() >= 2 ** 31:
        raise ValueError("the kernel's offsets are 32-bit ints")
    y = torch.empty(out, dtype=torch.float32, device=x.device)
    off = torch.empty(out, dtype=torch.int32, device=x.device)
    n, h, w, c = x.shape
    rc = _library().znicz_stochastic_pool_f32(
        x.data_ptr(), None if bits is None else bits.data_ptr(),
        0 if seed is None else seed, y.data_ptr(), off.data_ptr(), n, h, w,
        c, out[1], out[2], ky, kx, sy, sx, int(bool(use_abs)),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = _library().znicz_pooling_error_string(rc).decode()
        raise RuntimeError(f"stochastic_pool launch failed: {msg}")
    launches += 1
    return y, off
