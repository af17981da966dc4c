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
(:func:`bound_bytes`).  Design (flash-decoding; the source's header has
the details): the page view is split into runs of pages
(:func:`decode_split`, from the host's shapes alone), one block a (split,
slot, head block) of up to ``HEADS_PER_BLOCK`` heads, a warp a head, so
any head count is served; each block streams its split's live rows (its
heads' run of each) by the TMA into a shared-memory ring and
writes its partial softmax state to a workspace, and a second kernel
merges the splits in split order (:func:`paged_decode_split_plain` is
that arithmetic in PyTorch).

:func:`paged_decode` is the wrapper: on CPU tensors it runs
:func:`paged_decode_plain`, the plain PyTorch version (the analogue of
the reference's ``decode.reference``); on CUDA tensors it launches the
kernel or raises — there is no fallback.  ``launches`` counts the wrapper's
launches (one a call, for the split kernel and its combine together)
and nothing else.  Importing this module needs no ``nvcc``:
the library is built at the first CUDA call.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.ops.attention import MASK_VALUE

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

#: the TPU kernel this one replaces
REPLACES = "znicz_tpu/ops/pallas/decode.py:131"
SOURCE = "znicz_tpu_torch/csrc/paged_decode.cu"

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (64, 128)
#: a block holds up to this many heads, a warp each (kMaxHeads in the
#: source); more heads take more blocks
HEADS_PER_BLOCK = 32
#: blocks the page split aims at over the batch and the head blocks: two
#: for each of the
#: H100's 132 SMs (most slots are shorter than the view, and a split
#: past a slot's length exits at once; four an SM, 32-row splits, was no
#: faster on the H100 and doubled the combine's reads)
SPLIT_BLOCKS = 2 * 132
#: the most splits the combine takes (kMaxSplits in the source): a page
#: view of up to 4096 x 32 rows
MAX_SPLITS = 4096
#: no split shorter than this many key rows: a block's set-up (page ids,
#: barriers, its partial state) is worth at least two 16-row pages
MIN_SPLIT_ROWS = 32

_lib = None


def supported(head_dim: int, dtype, heads: int | None = None) -> bool:
    """Shapes the compiled kernel has instantiations for: head_dim 64
    or 128 in bfloat16 or float32, and any head count of at least one
    (when given); any page size works (a stage holds a divisor of it)."""
    return int(head_dim) in HEAD_DIMS and dtype in _DTYPE_CODES and \
        (heads is None or int(heads) >= 1)


def head_blocks(heads: int) -> int:
    """The blocks a (split, slot) takes for ``heads`` heads."""
    return -(-int(heads) // HEADS_PER_BLOCK)


def decode_split(batch: int, pages: int, page: int, heads: int = 1) -> tuple:
    """``(pages_per_split, splits)`` of a page view of ``pages`` entries
    of ``page`` rows for ``batch`` slots of ``heads`` heads: about
    ``SPLIT_BLOCKS`` blocks over the batch and the head blocks (one up
    to ``HEADS_PER_BLOCK`` heads, so the split is the same for every
    such count), no split under ``MIN_SPLIT_ROWS`` rows, and ``splits =
    ceil(pages / pages_per_split)``, so no split lies wholly past the
    view.  A function of the host's shapes only, never of the lengths
    (which stay on the card)."""
    want = -(-SPLIT_BLOCKS // (int(batch) * head_blocks(heads)))
    pps = max(-(-int(pages) // want), -(-MIN_SPLIT_ROWS // int(page)))
    pps = min(pps, int(pages))
    return pps, -(-int(pages) // pps)


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


def paged_decode_split_plain(q, k_pages, v_pages, page_table, lengths,
                            pages_per_split: int):
    """The kernel's arithmetic in plain PyTorch: each split of
    ``pages_per_split`` page-table entries gives its f32 softmax state
    ``(m, l, acc)`` over its live rows (the empty state ``(-1e30, 0, 0)``
    where it has none), and the splits merge in split order: ``o = Σ_s
    acc_s·e^(m_s - m) / Σ_s l_s·e^(m_s - m)`` with ``m = max_s m_s``."""
    B, H, Dh = q.shape
    page = k_pages.shape[1]
    P = page_table.shape[1]
    pps = int(pages_per_split)
    splits = -(-P // pps)
    rows = pps * page
    pt = F.pad(page_table.long(), (0, splits * pps - P))
    kc = k_pages[pt].reshape(B, splits, rows, H, Dh).float()
    vc = v_pages[pt].reshape(B, splits, rows, H, Dh).float()
    s = torch.einsum("bhd,bsrhd->bhsr", q.float(), kc) / math.sqrt(Dh)
    t = torch.arange(splits * rows, device=q.device).reshape(splits, rows)
    live = t[None] < lengths.long()[:, None, None]           # (B, S, R)
    s = s.masked_fill(~live[:, None], MASK_VALUE)
    m = s.amax(-1)                                           # (B, H, S)
    p = torch.exp(s - m[..., None]) * live[:, None]
    l_s = p.sum(-1)
    acc = torch.einsum("bhsr,bsrhd->bhsd", p, vc)
    m_all = m.amax(-1, keepdim=True)
    w = torch.exp(m - m_all)
    return (acc * w[..., None]).sum(2) / (l_s * w).sum(-1)[..., None]


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
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
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
    if not supported(Dh, q.dtype, H):
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
    pps, splits = decode_split(B, P, page, H)
    if splits > MAX_SPLITS:
        raise ValueError(f"no paged_decode kernel for a view of {P} pages "
                         f"of {page} rows at batch {B}: {splits} splits > "
                         f"{MAX_SPLITS}")
    ws = torch.empty((B, splits, H, Dh + 2), dtype=torch.float32,
                     device=q.device)
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=q.device)
    lib = _library()
    rc = lib.znicz_paged_decode(
        _DTYPE_CODES[q.dtype], Dh, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        ws.data_ptr(), out.data_ptr(), B, H, N, page, P, pps, splits,
        1.0 / math.sqrt(Dh), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: "
                           f"{lib.znicz_cuda_error_string(rc).decode()}")
    launches += 1
    return out
