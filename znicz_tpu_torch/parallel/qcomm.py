"""Quantized-collective codec (EQuARX, arXiv:2506.17615) — the port of
``znicz_tpu/parallel/qcomm.py`` on a :class:`~.mesh.DataMesh`: chunk-
scaled int8 (or bf16) payloads for the two hot collectives of the data-
parallel step, the gradient sum and the ZeRO ``shard_params`` regather.

The sum is rebuilt as quantize -> all-gather -> dequantize -> local f32
sum in rank order: the quantized payload (1 byte an element for int8
plus one f32 scale a chunk, 2 bytes an element for bf16) is what
crosses the wire, and every rank computes the same sum.

int8 chunks are balanced: a flat payload of ``size`` elements splits
into ``ceil(size/chunk)`` chunks of ``ceil(size/n_chunks)`` elements, so
padding never exceeds ``n_chunks - 1`` elements.

Error feedback: the caller carries a residual r per leaf; each step
quantizes ``h = g + r`` and the new residual ``h - dequantize(quantize
(h))`` goes into the next step.  It is rank-local state.

``resolve`` turns the ``quantized_collectives`` mapping (``{"mode":
"off|bf16|int8", "chunk": N, "error_feedback": bool}``) into a
:class:`Codec` or None, and every entry point treats None as exact, so
``mode=off`` runs the exact collectives bit for bit.

The reference's codec is jnp, and so is this one plain torch: no kernel
of the repo belongs to it.  :func:`quantized_psum` lives here because
the reference's (``parallel/compat.py``) sits beside a ``shard_map``
shim the port does not need.  Trees are what the fused step passes:
lists and dicts of tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from znicz_tpu_torch.core.config import root

#: config keys accepted by :func:`resolve` (anything else is a typo,
#: refused rather than silently running exact)
_CONFIG_KEYS = {"mode", "chunk", "error_feedback"}
MODES = ("off", "bf16", "int8")
DEFAULT_CHUNK = 1024


class Codec:
    """Resolved quantized-collective configuration (mode != off)."""

    __slots__ = ("mode", "chunk", "error_feedback")

    def __init__(self, mode: str, chunk: int = DEFAULT_CHUNK,
                 error_feedback: bool = True) -> None:
        self.mode = mode
        self.chunk = int(chunk)
        self.error_feedback = bool(error_feedback)

    def __repr__(self) -> str:
        return (f"Codec(mode={self.mode!r}, chunk={self.chunk}, "
                f"error_feedback={self.error_feedback})")


def resolve(config=None) -> Optional[Codec]:
    """Config mapping -> :class:`Codec`, or None for the exact path.
    ``config=None`` falls back to ``root.common.engine
    .quantized_collectives``; ``mode`` missing or "off" -> None."""
    if config is None:
        config = root.common.engine.get("quantized_collectives", None)
    if config is None:
        return None
    if isinstance(config, Codec):
        return None if config.mode == "off" else config
    unknown = set(config) - _CONFIG_KEYS
    if unknown:
        raise ValueError(
            f"quantized_collectives: unknown key(s) {sorted(unknown)}; "
            f"accepted: {sorted(_CONFIG_KEYS)}")
    mode = config.get("mode", "off")
    if mode not in MODES:
        raise ValueError(f"quantized_collectives.mode={mode!r} — choose "
                         f"from {MODES}")
    if mode == "off":
        return None
    chunk = int(config.get("chunk", DEFAULT_CHUNK))
    if chunk <= 0:
        raise ValueError(f"quantized_collectives.chunk must be > 0, "
                         f"got {chunk}")
    return Codec(mode, chunk, bool(config.get("error_feedback", True)))


# -- chunk layout / byte math ------------------------------------------------

def chunk_layout(size: int, chunk: int) -> tuple:
    """Balanced chunking of a flat ``size``-element payload:
    ``(n_chunks, chunk_len)`` with ``n_chunks * chunk_len >= size`` and
    at most ``n_chunks - 1`` padded elements."""
    size = max(int(size), 1)
    n_chunks = -(-size // chunk)
    chunk_len = -(-size // n_chunks)
    return n_chunks, chunk_len


def wire_nbytes(codec: Optional[Codec], size: int) -> int:
    """Bytes one participant ships for a collective over a flat f32
    payload of ``size`` elements."""
    if codec is None:
        return int(size) * 4
    if codec.mode == "bf16":
        return int(size) * 2
    n_chunks, chunk_len = chunk_layout(size, codec.chunk)
    return n_chunks * chunk_len + 4 * n_chunks


def exact_nbytes(size: int) -> int:
    """The f32 wire bytes the exact path ships for the same payload."""
    return int(size) * 4


# -- quantize / dequantize ---------------------------------------------------

def quantize_flat(x: torch.Tensor, codec: Codec, valid_size=None) -> tuple:
    """Flat tensor -> ``(payload, scales)``: int8 with one f32 absmax
    scale per balanced chunk, or a bf16 downcast with ``scales`` None.
    ``valid_size`` zeroes the positions at and past it before the scales
    are taken, so a pad never coarsens a chunk; an all-pad chunk gets
    scale 1."""
    flat = x.reshape(-1).to(torch.float32)
    if valid_size is not None:
        keep = torch.arange(flat.shape[0], device=flat.device) < valid_size
        flat = torch.where(keep, flat, torch.zeros_like(flat))
    if codec.mode == "bf16":
        return flat.to(torch.bfloat16), None
    n_chunks, chunk_len = chunk_layout(flat.shape[0], codec.chunk)
    pad = n_chunks * chunk_len - flat.shape[0]
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n_chunks, chunk_len)
    absmax = chunks.abs().amax(dim=1)
    scales = torch.where(absmax > 0.0, absmax / 127.0,
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(chunks / scales[:, None]), -127.0, 127.0)
    return q.to(torch.int8), scales


def dequantize_flat(payload: torch.Tensor, scales, size: int):
    """Inverse of :func:`quantize_flat`: flat f32 of ``size`` elements."""
    if scales is None:                       # bf16
        return payload.to(torch.float32)[:size]
    deq = payload.reshape(scales.shape[0], -1).to(torch.float32) * \
        scales[:, None]
    return deq.reshape(-1)[:size]


def _rank_sum(rows: torch.Tensor) -> torch.Tensor:
    """``rows[0] + rows[1] + ...`` in rank order, in f32."""
    total = rows[0]
    for r in range(1, rows.shape[0]):
        total = total + rows[r]
    return total


def _dequantize_gathered(payloads, scales, size: int) -> torch.Tensor:
    """(n, L) gathered payloads (+ (n, C) scales) -> the rank-order f32
    sum of their first ``size`` elements."""
    if scales is None:
        deq = payloads.to(torch.float32)
    else:
        n = payloads.shape[0]
        deq = (payloads.reshape(n, scales.shape[1], -1).to(torch.float32) *
               scales[:, :, None]).reshape(n, -1)
    return _rank_sum(deq[:, :size])


# -- quantized sum -----------------------------------------------------------

def psum_leaf(g: torch.Tensor, mesh, codec: Codec, residual=None) -> tuple:
    """Quantized sum of ``g`` over the mesh -> ``(summed, new_residual)``:
    each rank quantizes its ``g`` (plus the carried ``residual``), the
    payloads are all-gathered, and each rank dequantizes and sums them
    in f32.  ``new_residual`` is the rank's own quantization error (None
    when ``residual`` is)."""
    h = g if residual is None else g + residual
    size = h.numel()
    payload, scales = quantize_flat(h, codec)
    gathered = mesh.all_gather(payload)
    g_scales = None if scales is None else mesh.all_gather(scales)
    summed = _dequantize_gathered(gathered, g_scales, size) \
        .reshape(h.shape).to(g.dtype)
    if residual is None:
        return summed, None
    own = dequantize_flat(payload, scales, size).reshape(h.shape)
    return summed, (h - own).to(g.dtype)


def _flatten(tree) -> tuple:
    """Leaves of a list/tuple/dict tree in order, and a rebuild."""
    if isinstance(tree, dict):
        parts = [_flatten(v) for v in tree.values()]
        keys = list(tree)
        leaves = [leaf for p in parts for leaf in p[0]]

        def rebuild(vals):
            out, at = {}, 0
            for k, (ls, rb) in zip(keys, parts):
                out[k] = rb(vals[at:at + len(ls)])
                at += len(ls)
            return out
        return leaves, rebuild
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        leaves = [leaf for p in parts for leaf in p[0]]

        def rebuild(vals):
            out, at = [], 0
            for ls, rb in parts:
                out.append(rb(vals[at:at + len(ls)]))
                at += len(ls)
            return type(tree)(out)
        return leaves, rebuild
    return [tree], lambda vals: vals[0]


def _split(flat: torch.Tensor, sizes) -> list:
    """``flat`` (..., sum(sizes)) cut along its last axis."""
    return list(torch.split(flat, list(sizes), dim=-1))


def psum_tree(tree, mesh, codec: Codec, residuals=None) -> tuple:
    """:func:`psum_leaf` over a tree -> ``(summed_tree,
    new_residual_tree)``, ``residuals`` of ``tree``'s structure or None.
    Every leaf's payload rides one all-gather (and its scales one more):
    the same bytes and the same sums as one gather a leaf."""
    leaves, rebuild = _flatten(tree)
    res = [None] * len(leaves) if residuals is None \
        else _flatten(residuals)[0]
    hs = [g if r is None else g + r for g, r in zip(leaves, res)]
    quant = [quantize_flat(h, codec) for h in hs]
    payloads = mesh.all_gather(torch.cat([p.reshape(-1) for p, _ in quant]))
    lengths = [p.numel() for p, _ in quant]
    scales = None
    if codec.mode == "int8":
        scales = _split(mesh.all_gather(torch.cat([s for _, s in quant])),
                        [s.shape[0] for _, s in quant])
    summed, new_res = [], []
    for i, (g, h, (p, s), gathered) in enumerate(
            zip(leaves, hs, quant, _split(payloads, lengths))):
        total = _dequantize_gathered(
            gathered, None if scales is None else scales[i], h.numel())
        summed.append(total.reshape(h.shape).to(g.dtype))
        if residuals is not None:
            own = dequantize_flat(p, s, h.numel()).reshape(h.shape)
            new_res.append((h - own).to(g.dtype))
    return rebuild(summed), None if residuals is None else rebuild(new_res)


def quantized_psum(tree, mesh, codec: Optional[Codec] = None,
                   residuals=None) -> tuple:
    """The sum of ``tree`` over the mesh with an opt-in quantized wire
    format -> ``(summed_tree, new_residual_tree)``.  ``codec=None`` is
    the exact path: every leaf summed in f32 by one all-reduce of their
    concatenation (nothing at all without a group), ``residuals`` handed
    back untouched.  With a codec, :func:`psum_tree`."""
    if codec is not None:
        return psum_tree(tree, mesh, codec, residuals)
    if mesh.group is None:
        return tree, residuals
    leaves, rebuild = _flatten(tree)
    flat = mesh.all_reduce_(torch.cat([t.reshape(-1) for t in leaves]))
    parts = _split(flat, [t.numel() for t in leaves])
    return rebuild([p.view(t.shape) for p, t in zip(parts, leaves)]), \
        residuals


# -- quantized slice gather (the ZeRO shard_params regather) -----------------

def gather_slices(shard: torch.Tensor, mesh, like, codec: Codec):
    """Quantized ``zero.all_gather_slices``: each rank quantizes its own
    flat slice (``valid_size`` masks the pad of a non-aligned leaf's
    trailing ranks out of its scales), the payloads and scales are
    all-gathered, and every rank dequantizes the n slices into
    ``like``'s shape (a tensor or a shape)."""
    shape = tuple(getattr(like, "shape", like))
    size = 1
    for d in shape:
        size *= int(d)
    shard_len = shard.shape[0]
    valid = min(max(size - mesh.rank * shard_len, 0), shard_len)
    payload, scales = quantize_flat(shard, codec, valid_size=valid)
    gathered = mesh.all_gather(payload)                   # (n, padded)
    if scales is None:
        slices = gathered.to(torch.float32)[:, :shard_len]
    else:
        g_scales = mesh.all_gather(scales)
        n = gathered.shape[0]
        slices = (gathered.reshape(n, scales.shape[0], -1)
                  .to(torch.float32) * g_scales[:, :, None]) \
            .reshape(n, -1)[:, :shard_len]
    full = slices.reshape(-1)[:size].reshape(shape)
    return full.to(shard.dtype)
