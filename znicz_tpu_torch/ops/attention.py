"""Multi-head attention ops on torch tensors — the counterpart of
``znicz_tpu/ops/attention.py``.

Layouts: per-head tensors ``(batch, time, heads, head_dim)``; scores
``(batch, heads, tq, tk)`` in float32.  Masked scores carry the serve
plane's shared -1e30 constant, so a masked row contributes exactly 0
once one row of the softmax is valid.
"""

from __future__ import annotations

import math

import torch

#: THE mask constant (the reference's ``-1e30``), shared by every
#: attention path of the port and by the decode kernel's initial max
MASK_VALUE = -1e30


def softmax(x, dim: int = -1):
    m = x.amax(dim=dim, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=dim, keepdim=True)


def masked_scores(q, k, causal: bool, q_offset: int = 0, k_offset: int = 0):
    """Scaled q·kᵀ scores ``(b, h, tq, tk)`` in float32 with optional
    causal masking; ``*_offset`` give global positions when q/k are
    sequence blocks.  bf16 inputs are widened first, so the products are
    exact and only the accumulator is f32 — the reference's
    ``preferred_element_type=float32`` rule."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / math.sqrt(dh)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(tk, device=q.device)[None, :] + k_offset
        s = s.masked_fill((kpos > qpos)[None, None, :, :], MASK_VALUE)
    return s


def attention(q, k, v, causal: bool = False):
    """Scaled-dot-product attention over per-head tensors
    ``(b, t, h, dh)``; probabilities are rounded to the value dtype
    before the value product, as in the reference."""
    p = softmax(masked_scores(q, k, causal))
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def split_heads(x, n_heads: int):
    """``(b, t, d)`` -> per-head ``(b, t, n_heads, d / n_heads)`` (a
    view)."""
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def merge_heads(x):
    """Per-head ``(b, t, h, dh)`` -> ``(b, t, h·dh)``."""
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def mha_forward(x, params: dict, n_heads: int, causal: bool = False,
                attention_fn=None):
    """Full MHA block: qkv projections -> attention -> output projection.
    ``params``: wq/wk/wv/wo ``(d, d)`` (+ optional bq/bk/bv/bo).
    ``attention_fn(q, k, v, causal)`` overrides the core (the ring
    variant passes its sequence-parallel core) — ONE definition of the
    projection/param convention for all MHA assemblies."""
    def proj(w_key, b_key):
        y = x @ params[w_key]
        if params.get(b_key) is not None:
            y = y + params[b_key]
        return split_heads(y, n_heads)

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    core = attention if attention_fn is None else attention_fn
    y = merge_heads(core(q, k, v, causal=causal)) @ params["wo"]
    if params.get("bo") is not None:
        y = y + params["bo"]
    return y
