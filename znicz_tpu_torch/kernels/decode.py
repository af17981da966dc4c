"""Paged flash-decode: single-query attention over the block-paged KV
arena, as a hand-written Hopper kernel (``csrc/paged_decode.cu``).

Replaces ``znicz_tpu/ops/pallas/decode.py::paged_flash_decode`` — the
attention shape the generative plane dispatches at every steady-state
decode step.  ``q (B, H, Dh)`` attends to one arena layer
``k/v_pages (N, page, H, Dh)`` through ``page_table (B, P)`` int32; key
row ``p·page + r`` counts iff it is ``< lengths[b]``; an f32 online
softmax with ``sm_scale = 1/√Dh``; returns ``o (B, H, Dh)`` float32.

Bound on the card: device-memory bytes.  Every live K and V row is read
once for four flops per element, far below the H100's ridge, so the
least time is ``Σ lengths · H · 2 · Dh · itemsize / 3.35 TB/s``
(:func:`bound_bytes`).  Design: one block per (head, slot) loops over
the slot's live rows only, reading its page table and length itself,
with coalesced 16-byte row loads and per-group online softmax states
merged in shared memory (see the source's header).  Split-K over pages,
TMA and several heads per block are later work.

:func:`paged_decode` is the wrapper: on CPU tensors it runs
:func:`paged_decode_plain`, the plain PyTorch version (the analogue of
the reference's ``decode.reference``); on CUDA tensors it launches the
kernel or raises — there is no fallback.  ``launches`` counts kernel
launches and nothing else.  Importing this module needs no ``nvcc``:
the library is built at the first CUDA call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.ops.attention import MASK_VALUE

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

#: the TPU kernel this one replaces
REPLACES = "znicz_tpu/ops/pallas/decode.py:131"
SOURCE = "znicz_tpu_torch/csrc/paged_decode.cu"

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (64, 128)

_lib = None


def supported(head_dim: int, dtype) -> bool:
    """Shapes the compiled kernel has instantiations for; any page size
    works (the block walks rows, not page tiles)."""
    return int(head_dim) in HEAD_DIMS and dtype in _DTYPE_CODES


def paged_decode_plain(q, k_pages, v_pages, page_table, lengths):
    """The plain PyTorch version: gather the page view, mask rows past
    each slot's length with -1e30, dense softmax in f32."""
    B, H, Dh = q.shape
    page = k_pages.shape[1]
    t_view = page_table.shape[1] * page
    pt = page_table.long()
    kc = k_pages[pt].reshape(B, t_view, H, Dh)
    vc = v_pages[pt].reshape(B, t_view, H, Dh)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kc.float()) / math.sqrt(Dh)
    dead = torch.arange(t_view, device=q.device)[None, :] >= \
        lengths.long()[:, None]
    s = s.masked_fill(dead[:, None, :], MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vc.float())


def bound_bytes(q, k_pages, page_table, lengths) -> int:
    """Bytes the function must move for these inputs: q, the live K and
    V rows (``Σ lengths`` rows of ``H·Dh`` each, read once), the page
    table and lengths, and the f32 output."""
    B, H, Dh = q.shape
    rows = int(lengths.long().sum())
    return (q.numel() * q.element_size()
            + 2 * rows * H * Dh * k_pages.element_size()
            + page_table.numel() * 4 + lengths.numel() * 4
            + B * H * Dh * 4)


def _check(q, k_pages, v_pages, page_table, lengths):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"need q (B, H, Dh) and pages (N, page, H, Dh); "
                         f"got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    B, H, Dh = q.shape
    N, page = k_pages.shape[:2]
    if tuple(k_pages.shape[2:]) != (H, Dh) or \
            v_pages.shape != k_pages.shape:
        raise ValueError(f"pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError(f"need page_table (B, P) and lengths (B,) for "
                         f"B={B}; got {tuple(page_table.shape)}, "
                         f"{tuple(lengths.shape)}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    devices = {t.device for t in (q, k_pages, v_pages, page_table, lengths)}
    if len(devices) != 1:
        raise ValueError(f"all operands must share one device; got "
                         f"{sorted(map(str, devices))}")
    return B, H, Dh, N, page, page_table.shape[1]


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("paged_decode")
        lib.znicz_paged_decode.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        lib.znicz_paged_decode.restype = ctypes.c_int
        lib.znicz_cuda_error_string.argtypes = [ctypes.c_int]
        lib.znicz_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def paged_decode(q, k_pages, v_pages, page_table, lengths):
    """Fused single-query paged attention; see the module docstring.

    On CPU tensors the plain version runs, after checking that every
    length is in ``[1, P·page]`` and every page id in ``[0, N)``.  On
    CUDA tensors those values are the caller's contract (the paged
    decoder checks them on the host before upload) and the kernel traps
    on a violation; the wrapper checks shapes, dtypes, contiguity and
    alignment, launches on the current stream and raises if the launch
    is refused."""
    global launches
    B, H, Dh, N, page, P = _check(q, k_pages, v_pages, page_table, lengths)
    if q.device.type == "cpu":
        if int(lengths.min()) < 1 or int(lengths.max()) > P * page:
            raise ValueError(f"lengths must lie in [1, {P * page}] (the "
                             f"page view); got [{int(lengths.min())}, "
                             f"{int(lengths.max())}]")
        if int(page_table.min()) < 0 or int(page_table.max()) >= N:
            raise ValueError(f"page ids must lie in [0, {N})")
        return paged_decode_plain(q, k_pages, v_pages, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cpu or cuda tensors, not "
                         f"{q.device.type}")
    if not supported(Dh, q.dtype):
        raise ValueError(f"no paged_decode kernel for head_dim={Dh}, "
                         f"dtype={q.dtype} (have head_dim {HEAD_DIMS} in "
                         f"bfloat16/float32)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("q", "k_pages", "v_pages") and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the "
                             f"kernel reads rows in 16-byte loads)")
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=q.device)
    lib = _library()
    rc = lib.znicz_paged_decode(
        _DTYPE_CODES[q.dtype], Dh, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, N, page, P, 1.0 / math.sqrt(Dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: "
                           f"{lib.znicz_cuda_error_string(rc).decode()}")
    launches += 1
    return out
