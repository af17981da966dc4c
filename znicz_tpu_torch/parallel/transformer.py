"""The transformer LM — the counterpart of
``znicz_tpu/parallel/transformer.py``, on one device: layer norm, the
compute-dtype policy, parameter init, and the functional trainer
(:func:`make_train_step`), eval loss (:func:`make_eval_loss`) and
full-pass logits oracle (:func:`make_logits_fn`) over one shared
forward body.

Parameters are a plain dict of tensors mirroring the reference's
pytree: ``emb (vocab, d)``, ``head (d, vocab)`` and ``blocks[i]`` with
``ln1_g ln1_b wq wk wv wo ln2_g ln2_b w1 b1 w2 b2``.
:func:`init_params` is pure numpy and draws in the reference's order, so
one seed gives identical weights in both packages;
:func:`params_from_numpy` carries such a numpy pytree (as ``load_lm``
returns it) onto a device and :func:`params_to_numpy` brings it back
(the train -> ``export_lm`` -> serve handoff).

Attention in every block goes through the flash-attention kernels
(``kernels/flash_attention.py``): on CUDA tensors the hand-written
kernels, on CPU tensors their plain versions.  Unlike the reference
there is no switch back to dense attention
(``root.common.engine.flash_attention``) and no quiet dense path for an
unsupported head dim: a step for a head dim or dtype the kernels lack
raises when it is built.

What the reference has and this slice does not yet (each raises
``NotImplementedError``; ROADMAP.md queue A): meshes with an axis above
1 (data, sequence and tensor parallelism), ``shard_update``,
``shard_params``, ``head_sharded``, MoE blocks, quantized collectives,
``anatomy`` and selective ``remat_policy``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from znicz_tpu_torch.core.backends import device as _device
from znicz_tpu_torch.core.backends import resolve_compute_dtype
from znicz_tpu_torch.kernels import flash_attention as _kflash
from znicz_tpu_torch.parallel import tp

_GELU = functools.partial(F.gelu, approximate="tanh")  # jax.nn.gelu default


def _layer_norm(x, g, b, eps: float = 1e-5):
    # stats in f32 regardless of the compute dtype (bf16 mean/var loses
    # ~3 decimal digits); the normalized result returns to x.dtype so the
    # surrounding matmuls stay in the compute dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = ((xf - mu) / torch.sqrt(var + eps)).to(x.dtype)
    return y * g + b


def _default_compute_dtype(compute_dtype=None, device=None):
    """Explicit dtype wins; None defers to the framework-wide precision
    policy (core.backends.resolve_compute_dtype) for ``device``'s type."""
    if compute_dtype is not None:
        return compute_dtype
    return resolve_compute_dtype(torch.device(device or "cuda").type)


def init_params(gen, n_layers: int, d: int, heads: int, ff: int,
                vocab: int):
    """Global parameter pytree (numpy f32) from ``gen`` (a numpy
    Generator) — draw for draw the reference's dense-FFN init."""
    def w(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[-2] if len(shape) > 1
                                       else shape[0])
        return gen.normal(0.0, scale, shape).astype(np.float32)

    blocks = []
    for _ in range(n_layers):
        blocks.append({
            "ln1_g": np.ones(d, np.float32), "ln1_b": np.zeros(d, np.float32),
            "wq": w((d, d)), "wk": w((d, d)), "wv": w((d, d)), "wo": w((d, d)),
            "ln2_g": np.ones(d, np.float32), "ln2_b": np.zeros(d, np.float32),
            "w1": w((d, ff)), "b1": np.zeros(ff, np.float32),
            "w2": w((ff, d)), "b2": np.zeros(d, np.float32),
        })
    return {"emb": w((vocab, d), 0.02), "head": w((d, vocab)),
            "blocks": blocks}


def param_shapes(n_layers: int, d: int, ff: int, vocab: int):
    """Shape pytree mirroring :func:`init_params` (dense FFN blocks)."""
    blk = {
        "ln1_g": (d,), "ln1_b": (d,),
        "wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
        "ln2_g": (d,), "ln2_b": (d,),
        "w1": (d, ff), "b1": (ff,), "w2": (ff, d), "b2": (d,),
    }
    return {"emb": (vocab, d), "head": (d, vocab),
            "blocks": [dict(blk) for _ in range(n_layers)]}


def _map(fn, params) -> dict:
    return {"emb": fn(params["emb"]), "head": fn(params["head"]),
            "blocks": [{k: fn(a) for k, a in blk.items()}
                       for blk in params["blocks"]]}


def _leaves(params) -> list:
    return [params["emb"], params["head"]] + [
        a for blk in params["blocks"] for a in blk.values()]


def params_from_numpy(params, device, dtype=torch.float32) -> dict:
    """Copy a parameter pytree of numpy (or CPU tensor) leaves onto
    ``device`` as ``dtype`` tensors, keeping the pytree's shape.  Always
    a copy, never a view of the caller's arrays: the train step updates
    its params in place."""
    return _map(lambda a: torch.tensor(np.asarray(a, np.float32)).to(
        device=device, dtype=dtype), params)


def params_to_numpy(params) -> dict:
    """The inverse of :func:`params_from_numpy`: a numpy f32 pytree (what
    ``utils.export.export_lm`` packages)."""
    return _map(lambda a: a.detach().float().cpu().numpy(), params)


# -- the shared forward ------------------------------------------------------
def _block(x, p, heads: int, causal: bool):
    """One transformer block: flash attention over tensor-parallel heads,
    then the Megatron MLP (tanh GELU).  The reference's ``_block`` with
    the sequence axis unsharded and a dense FFN."""
    h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
    b, t_loc, _ = h.shape

    def heads_of(w):
        return (h @ w).reshape(b, t_loc, heads, -1)

    q, k, v = heads_of(p["wq"]), heads_of(p["wk"]), heads_of(p["wv"])
    o = _kflash.flash_attention(q, k, v, causal=causal)
    o = o.reshape(b, t_loc, -1)
    x = x + tp.row_parallel(o, p["wo"])
    m = _layer_norm(x, p["ln2_g"], p["ln2_b"])
    return x + tp.mlp(m, p["w1"], p["b1"], p["w2"], p["b2"], _GELU)


def _forward_hidden(ps, tokens, heads: int, causal: bool, cdt,
                    remat: bool = False):
    """Embedding + block stack — the ONE pre-head forward body, shared by
    the CE loss (:func:`_forward_ce`) and the logits oracle
    (:func:`make_logits_fn`).  Returns ``(x, ps_cast)``: the hidden
    states and the params cast to the compute dtype (so the caller's
    head product follows the same precision policy).  ``remat`` wraps
    each block in ``torch.utils.checkpoint``: the backward recomputes
    the block's activations instead of keeping them."""
    ps = _map(lambda w: w.to(cdt), ps)
    x = ps["emb"][tokens]                            # (b, t, d)
    for p in ps["blocks"]:
        if remat:
            x = checkpoint(_block, x, p, heads, causal,
                           use_reentrant=False)
        else:
            x = _block(x, p, heads, causal)
    return x, ps


def _dense_chunk_nll(xc, lc, wc, head):
    """Σ w·(-log p[label]) over one token chunk, from the head's
    logits."""
    logits = (xc @ head).float()                     # (chunk, vocab)
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, lc[:, None])[:, 0]
    return (-picked * wc).sum()


def _ce_token_nll_sum(x, labels, head, n_chunks: int, weights):
    """Σ weights·(-log p[label]) over the tokens, ``n_chunks`` token
    chunks at a time, each recomputed in the backward
    (``torch.utils.checkpoint``): the full ``(tokens, vocab)`` f32
    logits never exist, only one chunk's.  Padded rows weigh 0.
    Per-token numerics equal the dense path; only the cross-token
    summation order differs."""
    b, t, d = x.shape
    n_tok = b * t
    xf = x.reshape(n_tok, d)
    lf = labels.reshape(n_tok)
    wf = weights.expand(b, t).reshape(n_tok) if weights is not None else \
        torch.ones(n_tok, dtype=torch.float32, device=x.device)
    chunk = -(-n_tok // n_chunks)
    pad = chunk * n_chunks - n_tok
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad))
        wf = F.pad(wf, (0, pad))
    totals = [checkpoint(_dense_chunk_nll, xf[i * chunk:(i + 1) * chunk],
                         lf[i * chunk:(i + 1) * chunk],
                         wf[i * chunk:(i + 1) * chunk], head,
                         use_reentrant=False)
              for i in range(n_chunks)]
    return torch.stack(totals).sum()


def _forward_ce(ps, tokens, labels, mask, heads: int, causal: bool,
                cdt, remat: bool = False, loss_chunks: int | None = None):
    """The ONE forward + CE-loss body (shared by the train step and the
    eval pass).  ``mask`` is a per-row validity mask or None; masked rows
    contribute neither loss nor gradients.  The reference's
    normalisations with one data and one sequence shard: the unmasked
    loss is the mean over all tokens, the masked one the nll sum over
    the valid rows' tokens."""
    x, ps = _forward_hidden(ps, tokens, heads, causal, cdt, remat)
    b_l, t_l = labels.shape
    mvec = mask[:, None].float() if mask is not None else None
    if loss_chunks and loss_chunks > 1:
        nll = _ce_token_nll_sum(x, labels, ps["head"], loss_chunks, mvec)
    else:
        logits = (x @ ps["head"]).float()
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(-1, labels[..., None])[..., 0]
        nll = -picked.sum() if mvec is None else \
            -(picked * mvec.expand_as(picked)).sum()
    if mask is None:
        return nll / (b_l * t_l)
    total = mask.float().sum() * t_l
    return nll / torch.clamp(total, min=1.0)


# -- the step, eval and logits factories ------------------------------------
def _refuse(mesh, **options) -> None:
    """The reference options this slice has not ported: each raises
    rather than being ignored."""
    axes = dict(getattr(mesh, "shape", mesh) or {})
    wide = {a: n for a, n in axes.items() if n != 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: data, sequence and tensor parallelism are "
            f"not ported yet (ROADMAP.md queue A, multi-GPU axes); the "
            f"port trains on one device")
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (ROADMAP.md queue A, "
                f"transformer leftovers)")


def _setup(mesh, d: int, heads: int, compute_dtype, device, **options):
    """Shared build-time checks -> ``(device, compute dtype)``.
    On CUDA the flash kernels must have an instantiation for the head
    dim and compute dtype — decided here, never mid-step."""
    _refuse(mesh, **options)
    if d % heads:
        raise ValueError(f"heads={heads} must divide d={d}")
    dev = _device(device)
    cdt = _default_compute_dtype(compute_dtype, dev)
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype must be bfloat16 or float32, not "
                         f"{cdt}")
    if dev.type == "cuda" and not _kflash.supported(1, d // heads, cdt):
        raise ValueError(
            f"no flash-attention kernel for head_dim={d // heads}, "
            f"dtype={cdt} (have head_dim {_kflash.HEAD_DIMS} in "
            f"bfloat16/float32)")
    return dev, cdt


def _on(a, dev, dtype=torch.int64):
    """Token ids (or a row mask) from numpy or a tensor, on ``dev``."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device=dev, dtype=dtype)


def _check_params(params, dev) -> list:
    leaves = _leaves(params)
    for w in leaves:
        if w.device.type != dev.type or w.dtype != torch.float32:
            raise ValueError(
                f"params must be float32 tensors on {dev} (see "
                f"params_from_numpy); got {w.dtype} on {w.device}")
    return leaves


def make_train_step(mesh, n_layers: int, d: int,
                    heads: int, ff: int, vocab: int,
                    lr: float = 0.1, causal: bool = True, compute_dtype=None,
                    shard_update: bool = False, shard_params: bool = False,
                    masked: bool = False, remat: bool = False,
                    loss_chunks: int | None = None,
                    head_sharded: bool = False,
                    n_experts: int | None = None,
                    moe_aux_weight: float = 0.0, moe_top_k: int = 1,
                    remat_policy: str | None = None,
                    moe_zloss_weight: float = 0.0,
                    quantized_collectives: dict | None = None,
                    anatomy: bool = False, device=None):
    """-> ``step(params, tokens, labels) -> (params, loss)``
    (``masked=True``: ``step(params, tokens, labels, mask)`` with a
    per-row bool mask — padded rows train nothing), the reference's
    train step on one device.

    ``mesh``: None or the reference's ``{axis: size}`` with every size 1.
    ``params``: the f32 master pytree on ``device``
    (:func:`params_from_numpy`); ``tokens``/``labels``: int ``(batch,
    time)``, numpy or tensors.  The forward casts the masters to
    ``compute_dtype`` (default: bf16 on cuda, f32 on cpu); autograd
    carries the gradients back to the f32 masters, and the SGD update
    ``w -= lr·g`` is applied IN PLACE — the returned ``params`` is the
    same dict, and the in-place update is what the reference's
    ``donate=True`` buys.  ``loss`` is a 0-d f32 tensor on the device.

    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``); ``loss_chunks=k`` computes the CE k
    token-chunks at a time, each recomputed in the backward, so the
    ``(tokens, vocab)`` f32 logits never exist whole.  ``device``
    defaults to ``cuda`` and raises on a host without one — the port
    never falls back to the CPU on its own.  The reference's sharding,
    MoE, quantized-collective, anatomy and ``remat_policy`` options
    raise ``NotImplementedError``."""
    dev, cdt = _setup(
        mesh, d, heads, compute_dtype, device, shard_update=shard_update,
        shard_params=shard_params, head_sharded=head_sharded,
        n_experts=n_experts, moe_aux_weight=moe_aux_weight,
        moe_top_k=None if moe_top_k == 1 else moe_top_k,
        remat_policy=remat_policy, moe_zloss_weight=moe_zloss_weight,
        quantized_collectives=quantized_collectives, anatomy=anatomy)

    def step(params, tokens, labels, mask=None):
        if masked != (mask is not None):
            raise ValueError("a masked step takes a mask and an unmasked "
                             "step none")
        leaves = _check_params(params, dev)
        tok, lab = _on(tokens, dev), _on(labels, dev)
        m = None if mask is None else _on(mask, dev, torch.bool)
        for w in leaves:
            w.requires_grad_(True)
        try:
            loss = _forward_ce(params, tok, lab, m, heads, causal,
                               cdt, remat=remat, loss_chunks=loss_chunks)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for w in leaves:
                w.requires_grad_(False)
        with torch.no_grad():
            for w, g in zip(leaves, grads):
                w.sub_(lr * g)
        return params, loss.detach()

    return step


def make_eval_loss(mesh, n_layers: int, d: int,
                   heads: int, ff: int, vocab: int,
                   causal: bool = True, compute_dtype=None,
                   masked: bool = False, loss_chunks: int | None = None,
                   head_sharded: bool = False, n_experts: int | None = None,
                   moe_top_k: int = 1, device=None):
    """-> ``eval_loss(params, tokens, labels[, mask]) -> loss`` — the
    train step's forward + CE loss (the shared :func:`_forward_ce`) with
    no update and no autograd graph."""
    dev, cdt = _setup(
        mesh, d, heads, compute_dtype, device, head_sharded=head_sharded,
        n_experts=n_experts, moe_top_k=None if moe_top_k == 1 else moe_top_k)

    @torch.no_grad()
    def eval_loss(params, tokens, labels, mask=None):
        if masked != (mask is not None):
            raise ValueError("a masked eval takes a mask and an unmasked "
                             "eval none")
        _check_params(params, dev)
        m = None if mask is None else _on(mask, dev, torch.bool)
        return _forward_ce(params, _on(tokens, dev), _on(labels, dev), m,
                           heads, causal, cdt, loss_chunks=loss_chunks)

    return eval_loss


def make_logits_fn(mesh, n_layers: int, d: int,
                   heads: int, ff: int, vocab: int,
                   causal: bool = True, compute_dtype=None,
                   n_experts: int | None = None, moe_top_k: int = 1,
                   device=None):
    """-> ``logits(params, tokens) -> (b, t, vocab)`` f32 — the full
    forward through the SAME :func:`_forward_hidden` body the train and
    eval steps use, with the head applied per position.  The generative
    serving plane's correctness oracle: KV-cache decode is held against
    exactly this function."""
    dev, cdt = _setup(
        mesh, d, heads, compute_dtype, device, n_experts=n_experts,
        moe_top_k=None if moe_top_k == 1 else moe_top_k)

    @torch.no_grad()
    def logits(params, tokens):
        _check_params(params, dev)
        x, ps = _forward_hidden(params, _on(tokens, dev), heads, causal,
                                cdt)
        return (x @ ps["head"]).float()

    return logits
