"""Flash attention, forward and backward, as hand-written Hopper kernels
(``csrc/flash_attention.cu``).

Replaces the two Pallas calls of ``znicz_tpu/ops/pallas/attention.py``:
``_call_fwd`` (``:132``) and ``_flash_bwd`` (``:185``).  On folded
per-head tensors ``(b·h, t, dh)``:

- forward: ``s = q·kᵀ·scale`` in f32 (``scale = 1/√dh``), a causal key
  ``kpos > qpos`` scores -1e30; ``o = round(p)·v / l`` with
  ``p = exp(s - m)`` and the ``1/l`` normalisation in f32 (``round``
  is to the input dtype, as the reference rounds ``p`` before its
  product); ``lse = m + log l`` (f32, shape ``(b·h, t, 1)``);
- backward: ``p = exp(s - lse)``; ``dv = round(p)ᵀ·do``;
  ``ds = p ⊙ (do·vᵀ - Δ)·scale``; ``dq = round(ds)·k``;
  ``dk = round(ds)ᵀ·q``.  ``Δ = rowsum(do ⊙ o)`` minus the lse
  cotangent is computed here in torch, as the reference computes it
  outside its kernel.

Bound on the card: operations (see :func:`bound`).  Design: in bf16
each block has two consumer warpgroups and a producer warp that streams
128-byte-swizzled tiles through a ring in shared memory by TMA
(``cp.async.bulk.tensor`` on a 3-D tensor map per operand, completed on
``mbarrier`` barriers); every product is ``wgmma`` with f32
accumulation.  The forward runs one block per (128 q rows, head) with
an online softmax in base 2 over 128-key tiles, stopping at the
diagonal when causal; the backward is two passes without atomics
(dk/dv per 128 keys, dq per 128 q rows), so it is deterministic.  f32
runs on the CUDA cores in full f32.  The source's header has the
details.  Unlike the TPU kernel the GPU kernel masks a ragged last tile
itself, so any ``t >= 1`` is accepted.

The wrappers :func:`flash_attention_fwd` / :func:`flash_attention_bwd`
run the plain PyTorch versions (:func:`flash_attention_fwd_plain`,
:func:`flash_attention_bwd_plain`) on CPU tensors only; on CUDA tensors
they launch the kernels or raise.  ``fwd_launches`` / ``bwd_launches``
count kernel launches and nothing else (one backward launch is the
dk/dv kernel followed by the dq kernel).  :func:`flash_attention` and
:func:`flash_attention_lse` are the differentiable entry points, one
``torch.autograd.Function`` under both.  Importing this module needs no
``nvcc``: the library is built at the first CUDA call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.ops.attention import MASK_VALUE

#: kernel launches since import (or since a caller reset them to 0)
fwd_launches = 0
bwd_launches = 0

#: the TPU kernels these replace
REPLACES_FWD = "znicz_tpu/ops/pallas/attention.py:132"
REPLACES_BWD = "znicz_tpu/ops/pallas/attention.py:185"
SOURCE = "znicz_tpu_torch/csrc/flash_attention.cu"

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (64, 128)

#: H100 SXM data-sheet peaks: HBM bytes/s; dense flop/s of the units each
#: instantiation runs on (bf16 tensor cores, f32 CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

_lib = None


def supported(t: int, dh: int, dtype=torch.bfloat16) -> bool:
    """Shapes the compiled kernels have instantiations for: head dim 64
    or 128 in bfloat16 or float32, and any sequence length ``t >= 1``
    (the kernel masks a ragged last tile; there is no VMEM budget).
    ``t`` stays in the signature of the reference's gate
    (``attention.py:231``) because the ring path asks per local block
    length; a builder that knows only the head dim passes 1."""
    return int(t) >= 1 and int(dh) in HEAD_DIMS and dtype in _DTYPE_CODES


def _scores(q, k, causal: bool):
    """Scaled f32 scores ``(bh, t, t)`` with the -1e30 causal mask."""
    t, dh = q.shape[1], q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * \
        (1.0 / math.sqrt(dh))
    if causal:
        pos = torch.arange(t, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], MASK_VALUE)
    return s


def _round(x, dtype):
    """``x`` rounded to ``dtype`` and widened back to f32."""
    return x.to(dtype).float()


def flash_attention_fwd_plain(q, k, v, causal: bool = False):
    """The plain PyTorch forward: dense f32 scores, a whole-row softmax,
    ``p`` rounded to the value dtype before the value product ->
    ``(o in q.dtype, lse (bh, t, 1) f32)``."""
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(_round(p, v.dtype), v.float()) / l
    return o.to(q.dtype), m + torch.log(l)


def flash_attention_bwd_plain(q, k, v, do, lse, delta, causal: bool = False):
    """The plain PyTorch backward from ``lse`` and ``delta`` (both
    ``(bh, t, 1)`` f32) -> ``(dq, dk, dv)`` in the input dtypes; ``p``
    and ``ds`` are rounded to the input dtype before their products and
    every product accumulates in f32."""
    scale = 1.0 / math.sqrt(q.shape[2])
    p = torch.exp(_scores(q, k, causal) - lse)
    dv = torch.matmul(_round(p, v.dtype).transpose(1, 2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = _round(p * (dp - delta) * scale, q.dtype)
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bound(q, causal: bool, backward: bool = False) -> dict:
    """The least time the card could take for one call at ``q``'s shape
    and dtype: the larger of its flops over the dtype's peak and its
    bytes over the HBM rate.  Flops count only the live (query, key)
    pairs — ``t(t+1)/2`` per head when causal, ``t²`` otherwise — at
    ``4·dh`` each forward and ``10·dh`` backward.  Bytes count q, k, v,
    o and lse once each, and for the backward also do, dq, dk, dv and
    Δ."""
    bh, t, dh = (int(s) for s in q.shape)
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    flops = (10 if backward else 4) * pairs * dh
    rows = bh * t
    tensors = 8 if backward else 4               # (bh, t, dh) in/outputs
    nbytes = tensors * rows * dh * q.element_size() + \
        (2 if backward else 1) * rows * 4        # lse (and Δ), f32
    flops_ms = flops / PEAK_FLOPS[q.dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes"}


def _check(q, k, v, *extra):
    """Shapes, dtypes and devices of the folded operands; ``extra`` are
    more ``(bh, t, dh)`` tensors that must match q (do)."""
    if q.dim() != 3:
        raise ValueError(f"need folded (b*h, t, dh) tensors; got q "
                         f"{tuple(q.shape)}")
    for name, x in (("k", k), ("v", v)) + tuple(("do", x) for x in extra):
        if x.shape != q.shape:
            raise ValueError(f"{name} {tuple(x.shape)} does not match q "
                             f"{tuple(q.shape)}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} dtype {x.dtype} differs from q's "
                             f"{q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention takes bfloat16 or float32, "
                         f"not {q.dtype}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda tensors, "
                         f"not {q.device.type}")
    bh, t, dh = q.shape
    if bh < 1 or t < 1:
        raise ValueError(f"empty attention shape {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)) + tuple(
            ("do", x) for x in extra):
        if not x.is_contiguous():
            # the kernels' layout contract, held on the CPU too so the
            # plain path's callers meet what the card will demand
            raise ValueError(f"{name} must be contiguous")
    return bh, t, dh


def _check_rows(q, **rows):
    """lse / Δ: contiguous f32 ``(bh, t, 1)`` on q's device."""
    want = (q.shape[0], q.shape[1], 1)
    for name, x in rows.items():
        if tuple(x.shape) != want or x.dtype != torch.float32 or \
                x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {want} "
                             f"on {q.device}; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _check_cuda(dh, dtype, **tensors):
    if not supported(1, dh, dtype):
        raise ValueError(f"no flash-attention kernel for head_dim={dh}, "
                         f"dtype={dtype} (have head_dim {HEAD_DIMS} in "
                         f"bfloat16/float32)")
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA and the "
                             f"kernels' 16-byte loads need it)")


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.znicz_flash_fwd.argtypes = (
            [i32, i32] + [ptr] * 5 + [i32, i32, i32, ctypes.c_float, ptr])
        lib.znicz_flash_fwd.restype = i32
        lib.znicz_flash_bwd.argtypes = (
            [i32, i32] + [ptr] * 9 + [i32, i32, i32, ctypes.c_float, ptr])
        lib.znicz_flash_bwd.restype = i32
        lib.znicz_flash_error_string.argtypes = [i32]
        lib.znicz_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().znicz_flash_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def flash_attention_fwd(q, k, v, causal: bool = False):
    """Forward on folded ``(bh, t, dh)`` tensors -> ``(o, lse)``; the
    plain version on CPU tensors, the kernel on CUDA tensors (launched on
    the current stream; raises if the launch is refused)."""
    global fwd_launches
    bh, t, dh = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    _check_cuda(dh, q.dtype, q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, t, 1), dtype=torch.float32, device=q.device)
    rc = _library().znicz_flash_fwd(
        _DTYPE_CODES[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), bh, t, int(causal),
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_attention_fwd")
    fwd_launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, do, lse, delta, causal: bool = False):
    """Backward on folded tensors -> ``(dq, dk, dv)`` from the saved
    ``lse`` and ``delta`` (``rowsum(do ⊙ o)`` minus any lse cotangent);
    the plain version on CPU tensors, the two-pass kernel on CUDA
    tensors."""
    global bwd_launches
    bh, t, dh = _check(q, k, v, do)
    _check_rows(q, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, causal)
    _check_cuda(dh, q.dtype, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rc = _library().znicz_flash_bwd(
        _DTYPE_CODES[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, t, int(causal),
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


class _FlashLse(torch.autograd.Function):
    """``(o, lse)`` of folded q, k, v, both differentiable: the lse
    cotangent folds into Δ (``Δ' = Δ - dlse``), so the backward kernel
    is the same either way — the reference's ``flash_attention_lse``
    VJP (``attention.py:163-173``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        if dlse is not None:
            delta = delta - dlse
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, delta,
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention_lse(q, k, v, causal: bool = False):
    """Flash attention over folded ``(b·h, t, dh)`` tensors returning
    ``(o, lse)``, both differentiable — the building block of blockwise
    (ring) composition."""
    return _FlashLse.apply(q, k, v, bool(causal))


def flash_attention(q, k, v, causal: bool = False):
    """Attention over per-head tensors ``(b, t, h, dh)`` — the contract
    of ``ops.attention.attention`` (``softmax(q·kᵀ/√dh)·v``), through
    the flash kernels and differentiable."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q, k, v of one (b, t, h, dh) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, h, dh = q.shape

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, t, dh).contiguous()

    o, _ = _FlashLse.apply(fold(q), fold(k), fold(v), bool(causal))
    return o.reshape(b, h, t, dh).transpose(1, 2)
