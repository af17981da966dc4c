"""Inverted dropout forward as a hand-written Hopper kernel
(``csrc/dropout.cu``).

Replaces ``znicz_tpu/ops/pallas/dropout.py dropout_forward`` (the
in-kernel-PRNG call at ``:56`` and the ``bits=`` call at ``:62``) with
its rule (``:18-21``, ``:48-50``), which is not ``ops/dropout.py
make_mask``'s: an element is kept when its uint32 ``bits > thresh``, with
``thresh = uint32(min(max(ratio, 0), 1 - 1e-9) · (2³² - 1))`` and the
kept ones scaled by ``f32(1 / (1 - ratio))``.  :func:`dropout_forward`
returns ``(y, mask)``, the mask in x's dtype, for the backward to reuse.

The random operand is ``seed=`` (the counter-based generator of
``kernels/counter_rng.py``, keyed by the seed and the flat element
index) or ``bits=``: uint32 (or int32) bits of x's shape, the TPU
kernel's test operand.  The dropout *unit* stays plain torch, as the
reference's does: nothing in the reference's unit graph reaches this
kernel; its path is the kernel-layer check (``utils/kernel_hw.py``).

The wrapper runs :func:`dropout_forward_plain` on CPU tensors only; on
CUDA tensors it launches the kernel (float32) or raises.  ``launches``
counts kernel launches and nothing else.  Importing this module needs no
``nvcc``: the library is built at the first CUDA call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.kernels import counter_rng
from znicz_tpu_torch.kernels.gemm import _bound_of

#: kernel launches since import (or since a caller reset them to 0)
launches = 0

#: the TPU kernel this replaces (its PRNG call; the bits= call is :62)
REPLACES = "znicz_tpu/ops/pallas/dropout.py:56"
SOURCE = "znicz_tpu_torch/csrc/dropout.cu"

_lib = None


def threshold(ratio: float) -> int:
    """The keep threshold, as the reference computes it (a truncating
    conversion of the double product)."""
    return int(min(max(ratio, 0.0), 1.0 - 1e-9) * (2 ** 32 - 1))


def scale(ratio: float) -> float:
    """The kept elements' factor, rounded to f32."""
    return float(np.float32(1.0 / (1.0 - ratio)))


def dropout_forward_plain(x, ratio: float, words):
    """The plain PyTorch mask and product for int64 ``words`` (one per
    element, flat order, values in [0, 2**32)) -> ``(y, mask)``."""
    keep = words.reshape(x.shape) > threshold(ratio)
    mask = torch.where(keep, torch.tensor(scale(ratio), device=x.device),
                       torch.tensor(0.0, device=x.device)).to(x.dtype)
    return x * mask, mask


def bound(numel: int, with_bits: bool = False) -> dict:
    """The least time the card could take: x read, y and the mask written
    (and the bits read, when given) over the HBM rate, against one
    multiply an element over the f32 peak."""
    return _bound_of(numel, (16 if with_bits else 12) * numel)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("dropout")
        ptr = ctypes.c_void_p
        lib.znicz_dropout_forward_f32.argtypes = [
            ptr, ptr, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float, ptr,
            ptr, ctypes.c_longlong, ptr]
        lib.znicz_dropout_forward_f32.restype = ctypes.c_int
        lib.znicz_dropout_error_string.argtypes = [ctypes.c_int]
        lib.znicz_dropout_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def dropout_forward(x, ratio: float, *, seed=None, bits=None):
    """Inverted dropout of ``x`` at drop probability ``ratio`` -> ``(y,
    mask)``, drawing from ``seed`` or taking ``bits`` (exactly one of the
    two): the plain version on CPU tensors, the kernel on CUDA tensors (on
    the current stream)."""
    global launches
    if (seed is None) == (bits is None):
        raise ValueError("pass exactly one of seed= and bits=")
    if not 0.0 <= ratio < 1.0:
        raise ValueError(f"dropout ratio {ratio} is outside [0, 1)")
    if not x.is_contiguous() or x.numel() < 1:
        raise ValueError("x must be a non-empty contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dropout_forward runs on cpu or cuda tensors, not "
                         f"{x.device.type}")
    if bits is not None:
        if bits.shape != x.shape or bits.device != x.device or \
                not bits.is_contiguous():
            raise ValueError(f"bits must be contiguous {tuple(x.shape)} on "
                             f"{x.device}, got {tuple(bits.shape)} on "
                             f"{bits.device}")
        words = counter_rng.as_words(bits)       # checks the dtype
    else:
        seed = counter_rng.check_seed(seed)
    if x.device.type == "cpu":
        if bits is None:
            words = counter_rng.random_bits(seed, x.numel(), x.device)
        return dropout_forward_plain(x, ratio, words)
    if x.dtype != torch.float32:
        raise ValueError(f"the dropout kernel takes float32, not {x.dtype}")
    y = torch.empty_like(x)
    mask = torch.empty_like(x)
    rc = _library().znicz_dropout_forward_f32(
        x.data_ptr(), None if bits is None else bits.data_ptr(),
        0 if seed is None else seed, threshold(ratio), scale(ratio),
        y.data_ptr(), mask.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = _library().znicz_dropout_error_string(rc).decode()
        raise RuntimeError(f"dropout_forward launch failed: {msg}")
    launches += 1
    return y, mask
