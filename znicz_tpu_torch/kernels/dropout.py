"""Inverted dropout forward as a hand-written Hopper kernel
(``csrc/dropout.cu``), in float32 and bfloat16.

Replaces ``znicz_tpu/ops/pallas/dropout.py dropout_forward`` (the
in-kernel-PRNG call at ``:56`` and the ``bits=`` call at ``:62``) with
its rule (``:18-21``, ``:48-50``), which is not ``ops/dropout.py
make_mask``'s: an element is kept when its uint32 ``bits > thresh``, with
``thresh = uint32(min(max(ratio, 0), 1 - 1e-9) · (2³² - 1))`` and the
kept ones scaled by ``f32(1 / (1 - ratio))``.  :func:`dropout_forward`
returns ``(y, mask)`` in x's dtype, as the TPU kernel does (``:20``,
``:53-54``): the mask is the f32 scale cast to that dtype (or 0), and y
is x times the mask, the product rounded once (bf16: 6 bytes an element
against f32's 12).

The random operand is ``seed=`` (the counter-based generator of
``kernels/counter_rng.py``, keyed by the seed and the flat element
index) or ``bits=``: uint32 (or int32) bits of x's shape, the TPU
kernel's test operand.  The dropout *unit* stays plain torch, as the
reference's does: nothing in the reference's unit graph reaches this
kernel; its path is the kernel-layer check (``utils/kernel_hw.py``).

The launch (:func:`dropout_plan`, the twin of ``plan_of`` in the
source): one 16-byte group a thread and one block a 256 groups where n
fills whole groups (4 f32 or 8 bf16 elements) and every operand lies on
16 bytes, else one element a thread.

The wrapper runs :func:`dropout_forward_plain` on CPU tensors only; on
CUDA tensors it launches the kernel (float32 or bfloat16) or raises.
``launches`` counts kernel launches and nothing else.  Importing this
module needs no ``nvcc``: the library is built at the first CUDA call.
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

#: the TPU kernel this replaces (its PRNG call; the bits= call is :62;
#: both take any dtype and return y and the mask in it)
REPLACES = "znicz_tpu/ops/pallas/dropout.py:56"
SOURCE = "znicz_tpu_torch/csrc/dropout.cu"

#: the dtypes the kernel takes, by the source's dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: threads a block (the source's kThreads)
THREADS = 256
#: the largest grid a launch takes (the source's kMaxBlocks)
MAX_BLOCKS = 0x7FFFFFFF

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
    element, flat order, values in [0, 2**32)) -> ``(y, mask)`` in x's
    dtype."""
    keep = words.reshape(x.shape) > threshold(ratio)
    mask = torch.where(keep, torch.tensor(scale(ratio), device=x.device),
                       torch.tensor(0.0, device=x.device)).to(x.dtype)
    return x * mask, mask


def bound(numel: int, with_bits: bool = False,
          dtype=torch.float32) -> dict:
    """The least time the card could take: x read, y and the mask written
    (and the bits read, when given) over the HBM rate, against one
    multiply an element over the f32 peak."""
    size = torch.tensor([], dtype=dtype).element_size()
    return _bound_of(numel, 3 * size * numel + (4 * numel if with_bits
                                                else 0))


def dropout_plan(n: int, dtype=torch.float32, aligned: bool = True) -> dict:
    """The launch at ``n`` elements as ``plan_of`` in the source chooses
    it: ``path`` ("vector" or "element"), ``blocks`` (one a THREADS
    groups or elements, at most MAX_BLOCKS) and ``threads``."""
    per = 16 // torch.tensor([], dtype=dtype).element_size()
    vec = n % per == 0 and aligned
    items = n // per if vec else n
    return {"path": "vector" if vec else "element",
            "blocks": min(-(-items // THREADS), MAX_BLOCKS),
            "threads": THREADS}


def dropout_plan_on_card(n: int, dtype=torch.float32,
                         aligned: bool = True) -> dict:
    """``znicz_dropout_plan`` from the source in :func:`dropout_plan`'s
    terms."""
    out = (ctypes.c_int * 3)()
    rc = _library().znicz_dropout_plan(n, DTYPES[dtype], int(aligned),
                                       ctypes.cast(out, ctypes.c_void_p))
    _raise_on(rc, "dropout_plan")
    vec, blocks, threads = list(out)
    return {"path": "vector" if vec else "element", "blocks": blocks,
            "threads": threads}


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("dropout")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.znicz_dropout_forward.argtypes = [
            ptr, ptr, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float, ptr,
            ptr, ctypes.c_longlong, i32, ptr]
        lib.znicz_dropout_forward.restype = i32
        lib.znicz_dropout_plan.argtypes = [ctypes.c_longlong, i32, i32, ptr]
        lib.znicz_dropout_plan.restype = i32
        lib.znicz_dropout_error_string.argtypes = [i32]
        lib.znicz_dropout_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().znicz_dropout_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def dropout_forward(x, ratio: float, *, seed=None, bits=None):
    """Inverted dropout of ``x`` at drop probability ``ratio`` -> ``(y,
    mask)`` in x's dtype, drawing from ``seed`` or taking ``bits``
    (exactly one of the two): the plain version on CPU tensors, the
    kernel on CUDA tensors (on the current stream)."""
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
    if x.dtype not in DTYPES:
        raise ValueError(f"the dropout kernel takes {list(DTYPES)}, not "
                         f"{x.dtype}")
    y = torch.empty_like(x)
    mask = torch.empty_like(x)
    rc = _library().znicz_dropout_forward(
        x.data_ptr(), None if bits is None else bits.data_ptr(),
        0 if seed is None else seed, threshold(ratio), scale(ratio),
        y.data_ptr(), mask.data_ptr(), x.numel(), DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "dropout_forward")
    launches += 1
    return y, mask
