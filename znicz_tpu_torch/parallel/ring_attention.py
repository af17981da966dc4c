"""Ring attention — sequence-parallel exact attention over the ``seq``
mesh axis, the port of ``znicz_tpu/parallel/ring_attention.py`` on a
mesh axis handle (``parallel/mesh.py``).

Each rank holds a sequence block of Q/K/V ``(b, t_local, h, dh)``.  K/V
blocks rotate around the ring (one ``ppermute`` a step: each rank sends
its block to the next rank and receives the previous rank's, one
``batch_isend_irecv``) while an online softmax accumulates the local Q
block's output:

    m' = max(m, rowmax(s));  l' = l*e^(m-m') + rowsum(e^(s-m'))
    o' = o*e^(m-m') + e^(s-m') @ V_blk

After ``seq`` steps every Q block has attended to the whole sequence.
The rotations are one ``torch.autograd.Function`` (:func:`ring_blocks`)
whose backward sends the gradients the other way round the ring
(``lax.ppermute``'s transpose).

Two divergences from the reference, both on the host's knowledge of the
ring step (the reference's ``scan`` cannot branch on it):

- the last rotation, which the reference's ``scan`` performs and never
  reads, is not made;
- :func:`ring_flash_attention` launches no kernel on a causally
  excluded (future) block: the reference launches the flash kernel on
  it and drops the result by a select, so the merged result has the
  same bits.  Under causal masking rank ``r`` launches ``r + 1`` flash
  forwards (and backwards) a layer instead of ``seq``.
"""

from __future__ import annotations

import torch

from znicz_tpu_torch.kernels import flash_attention as _kflash
from znicz_tpu_torch.ops import attention as _attn
from znicz_tpu_torch.parallel.mesh import DataMesh


class _RingBlocks(torch.autograd.Function):
    """Every block of the ring that reaches this rank, in ring order: the
    own block (a copy), then ``n - 1`` rotations, each sending the last
    block to the next rank and receiving the previous rank's.  One
    Function for the whole ring, so its backward (the rotations the
    other way, each adding the cotangent of the block it passes) runs on
    every rank of the ring even where a rank reads none of the blocks it
    received, as under causal masking: a rank that left its share out
    would leave its neighbours waiting."""

    @staticmethod
    def forward(ctx, axis, *tensors):
        ctx.axis, ctx.k = axis, len(tensors)
        blocks = [t.clone() for t in tensors]
        out = list(blocks)
        for _ in range(axis.size - 1):
            blocks = axis.ppermute(blocks, 1)
            out += blocks
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        k = ctx.k
        acc = list(grads[-k:])
        for s in range(len(grads) // k - 2, -1, -1):
            back = ctx.axis.ppermute(acc, -1)
            acc = [g + b for g, b in zip(grads[s * k:(s + 1) * k], back)]
        return (None, *acc)


def ring_blocks(tensors, axis) -> list:
    """``[blocks at ring step 0, at step 1, ...]`` (each a list like
    ``tensors``): the own blocks, then each rotation's, ``axis.size``
    steps in all, differentiable; the last rotation, never read, is not
    made.  ``axis`` is a mesh axis handle, or a stand-in with ``size``,
    ``index`` and a differentiable ``ppermute(tensors)`` of its own."""
    k = len(tensors)
    if isinstance(axis, DataMesh):
        flat = _RingBlocks.apply(axis, *tensors)
        return [list(flat[s * k:(s + 1) * k]) for s in range(axis.size)]
    steps = [list(tensors)]
    for _ in range(axis.size - 1):
        steps.append(list(axis.ppermute(steps[-1])))
    return steps


def ring_attention(q, k, v, axis, causal: bool = False):
    """Sequence-sharded exact attention on this rank's ``(b, t_loc, h,
    dh)`` blocks, the sequence split over ``axis`` (the ``seq`` handle):
    the online softmax in f32, K/V rotated in their own dtype."""
    n, me = axis.size, axis.index
    t_loc = q.shape[1]
    # online-softmax state (o, m, l) in f32 even when q/k/v are bf16
    o = torch.zeros(q.shape[0], q.shape[2], t_loc, q.shape[3],
                    dtype=torch.float32, device=q.device)
    m = torch.full(o.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros(o.shape[:-1], device=q.device)
    for s, (k, v) in enumerate(ring_blocks((k, v), axis)):
        blk = (me - s) % n
        sc = _attn.masked_scores(q, k, causal, q_offset=me * t_loc,
                                 k_offset=blk * t_loc)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        # p rides the value product at the value dtype, accumulated f32
        o = o * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
        m = m_new
    out = (o / l[..., None]).to(q.dtype)
    return out.transpose(1, 2)                       # (b, t_loc, h, dh)


def _merge_blocks(o, lse, o_s, lse_s, include):
    """Numerically stable lse-weighted merge of two NORMALIZED attention
    results over the same queries but disjoint key blocks; ``include``
    False (a bool, or a bool tensor) leaves the accumulator unchanged
    bit for bit (a select, not a zero-weight pass through the merge
    arithmetic).  All f32; ``o`` ``(bh, t, dh)``, ``lse`` ``(bh, t,
    1)``."""
    m = torch.maximum(lse, lse_s)
    w_old = torch.exp(lse - m)
    w_new = torch.exp(lse_s - m)
    tot = w_old + w_new
    o_out = (o * w_old + o_s.float() * w_new) / tot
    lse_out = m + torch.log(tot)
    if isinstance(include, torch.Tensor):
        return torch.where(include, o_out, o), \
            torch.where(include, lse_out, lse)
    return (o_out, lse_out) if include else (o, lse)


def ring_block(me: int, blk: int, causal: bool):
    """What rank ``me`` does with key block ``blk``: ``"causal"`` (its
    own block under causal masking), ``"full"`` (a past block, or any
    block without masking) or None (a future block: excluded, no
    launch)."""
    if not causal:
        return "full"
    if blk == me:
        return "causal"
    return "full" if blk < me else None


def ring_flash_attention(q, k, v, axis, causal: bool = False):
    """Ring attention whose block math is the flash kernel pair
    (``kernels/flash_attention.py flash_attention_lse``, its plain
    versions on CPU tensors) on folded ``(b·h, t_loc, dh)`` blocks:
    the folded K/V rotate over ``axis`` as in :func:`ring_attention`,
    each ring step computes its (q block × k block) attention without
    the score matrix, and the per-block results merge by the lse rule
    (:func:`_merge_blocks`).  Gradients flow through the merge into
    both o and lse; the kernel's backward takes the lse cotangent.

    Block-aligned causality needs no kernel offsets: the own block runs
    the kernel's causal mask, a past block runs unmasked, a future block
    is skipped (:func:`ring_block`).  Same signature and result as
    :func:`ring_attention` (``(b, t_loc, h, dh)``)."""
    b, t_loc, h, dh = q.shape
    n, me = axis.size, axis.index

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, t_loc, dh).contiguous()

    qf = fold(q)
    o = torch.zeros(b * h, t_loc, dh, dtype=torch.float32, device=q.device)
    lse = torch.full((b * h, t_loc, 1), float("-inf"), device=q.device)
    for s, (kf, vf) in enumerate(ring_blocks((fold(k), fold(v)), axis)):
        kind = ring_block(me, (me - s) % n, causal)
        if kind is not None:
            o_s, lse_s = _kflash.flash_attention_lse(qf, kf, vf,
                                                     kind == "causal")
            o, lse = _merge_blocks(o, lse, o_s, lse_s, True)
    out = o.reshape(b, h, t_loc, dh).to(q.dtype)
    return out.transpose(1, 2)                       # (b, t_loc, h, dh)


def ring_mha_forward(x, params: dict, n_heads: int, axis,
                     causal: bool = False):
    """MHA with ring attention: ``x`` ``(b, t_local, d)`` sequence-
    sharded over ``axis``; the projection weights replicated (or
    tp-sharded by the caller).  The projection convention of
    ``ops.attention.mha_forward``; only the core differs."""
    def core(q, k, v, causal):
        return ring_attention(q, k, v, axis, causal=causal)

    return _attn.mha_forward(x, params, n_heads, causal=causal,
                             attention_fn=core)
