"""The transformer LM — the counterpart of
``znicz_tpu/parallel/transformer.py``, on one device: layer norm, the
compute-dtype policy, parameter init, and the functional trainer
(:func:`make_train_step`), eval loss (:func:`make_eval_loss`) and
full-pass logits oracle (:func:`make_logits_fn`) over one shared
forward body.

Parameters are a plain dict of tensors mirroring the reference's
pytree: ``emb (vocab, d)``, ``head (d, vocab)`` and ``blocks[i]`` with
``ln1_g ln1_b wq wk wv wo ln2_g ln2_b`` and either the dense FFN's
``w1 b1 w2 b2`` or, with ``n_experts``, the MoE FFN's ``gate ew1 eb1
ew2 eb2`` (``parallel/moe.py``).  :func:`init_params` is pure numpy and
draws in the reference's order, so one seed gives identical weights in
both packages; :func:`params_from_numpy` carries such a numpy pytree
(as ``load_lm`` returns it) onto a device and :func:`params_to_numpy`
brings it back (the train -> ``export_lm`` -> serve handoff).

Attention in every block goes through the flash-attention kernels
(``kernels/flash_attention.py``): on CUDA tensors the hand-written
kernels, on CPU tensors their plain versions.  Unlike the reference
there is no switch back to dense attention
(``root.common.engine.flash_attention``) and no quiet dense path for an
unsupported head dim: a step for a head dim or dtype the kernels lack
raises when it is built.

On CUDA the train step and the eval body run as CUDA graph replays
(``parallel/graphs.py run_graphed``), one graph a (body, input shapes,
param tensors): the counterpart of the reference's one jitted program a
minibatch.  The CPU runs them eagerly.

What the reference has and the port does not yet (each raises
``NotImplementedError``; ROADMAP.md queue A): meshes with an axis above
1 (data, sequence, tensor and expert parallelism), ``shard_update``,
``shard_params``, ``head_sharded`` and quantized collectives (item 10b),
and ``anatomy`` (item 14).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from znicz_tpu_torch.core.backends import device as _device
from znicz_tpu_torch.core.backends import resolve_compute_dtype
from znicz_tpu_torch.kernels import flash_attention as _kflash
from znicz_tpu_torch.parallel import tp
from znicz_tpu_torch.parallel.graphs import run_graphed
from znicz_tpu_torch.parallel.moe import (load_balance_aux, moe_ffn,
                                          router_z_loss)

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
                vocab: int, n_experts: int | None = None):
    """Global parameter pytree (numpy f32) from ``gen`` (a numpy
    Generator) — draw for draw the reference's init.  ``n_experts``
    swaps each block's dense FFN for an MoE FFN (gate + per-expert
    w1/b1/w2/b2 stacks)."""
    def w(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[-2] if len(shape) > 1
                                       else shape[0])
        return gen.normal(0.0, scale, shape).astype(np.float32)

    blocks = []
    for _ in range(n_layers):
        blk = {
            "ln1_g": np.ones(d, np.float32), "ln1_b": np.zeros(d, np.float32),
            "wq": w((d, d)), "wk": w((d, d)), "wv": w((d, d)), "wo": w((d, d)),
            "ln2_g": np.ones(d, np.float32), "ln2_b": np.zeros(d, np.float32),
        }
        if n_experts:
            blk.update({
                "gate": w((d, n_experts)),
                "ew1": w((n_experts, d, ff)),
                "eb1": np.zeros((n_experts, ff), np.float32),
                "ew2": w((n_experts, ff, d)),
                "eb2": np.zeros((n_experts, d), np.float32),
            })
        else:
            blk.update({
                "w1": w((d, ff)), "b1": np.zeros(ff, np.float32),
                "w2": w((ff, d)), "b2": np.zeros(d, np.float32),
            })
        blocks.append(blk)
    return {"emb": w((vocab, d), 0.02), "head": w((d, vocab)),
            "blocks": blocks}


def param_shapes(n_layers: int, d: int, ff: int, vocab: int,
                 n_experts: int | None = None):
    """Shape pytree mirroring :func:`init_params`."""
    blk = {
        "ln1_g": (d,), "ln1_b": (d,),
        "wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
        "ln2_g": (d,), "ln2_b": (d,),
    }
    if n_experts:
        blk.update({
            "gate": (d, n_experts),
            "ew1": (n_experts, d, ff), "eb1": (n_experts, ff),
            "ew2": (n_experts, ff, d), "eb2": (n_experts, d),
        })
    else:
        blk.update({"w1": (d, ff), "b1": (ff,), "w2": (ff, d), "b2": (d,)})
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
def _block(x, p, heads: int, causal: bool, moe_top_k: int = 1,
           moe_aux_weight: float = 0.0, moe_zloss_weight: float = 0.0):
    """One transformer block: flash attention over tensor-parallel heads,
    then the Megatron MLP (tanh GELU) or, for an MoE block, the dense-
    masked MoE FFN.  The reference's ``_block`` with the sequence axis
    unsharded.  Returns ``(x, aux)``: the MoE block's regularizers,
    weighted here, or None for a dense block."""
    h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
    b, t_loc, _ = h.shape

    def heads_of(w):
        return (h @ w).reshape(b, t_loc, heads, -1)

    q, k, v = heads_of(p["wq"]), heads_of(p["wk"]), heads_of(p["wv"])
    o = _kflash.flash_attention(q, k, v, causal=causal)
    o = o.reshape(b, t_loc, -1)
    x = x + tp.row_parallel(o, p["wo"])
    m = _layer_norm(x, p["ln2_g"], p["ln2_b"])
    if "ew1" not in p:
        return x + tp.mlp(m, p["w1"], p["b1"], p["w2"], p["b2"],
                          _GELU), None
    m2d = m.reshape(-1, m.shape[-1])
    y2d, probs = moe_ffn(m2d, p["gate"], p["ew1"], p["eb1"], p["ew2"],
                         p["eb2"], _GELU, top_k=moe_top_k)
    # the regularizers pre-weighted here, as the reference's are (its
    # weights are static floats); a zero weight adds nothing to compute
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if moe_aux_weight:
        aux = aux + moe_aux_weight * load_balance_aux(probs)
    if moe_zloss_weight:
        aux = aux + moe_zloss_weight * router_z_loss(m2d @ p["gate"])
    return x + y2d.reshape(m.shape), aux


#: the reference's named selective-remat policies, as the aten products
#: whose outputs the backward keeps (everything else it recomputes):
#: "dots" every matmul, "dots_no_batch" those with no batch dimension
#: (the weight products; the MoE experts' batched products recompute),
#: "nothing" none.  The flash kernel's output is no product, so it
#: recomputes under every policy, as the reference's Pallas call does
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT_POLICIES = {
    "dots": _MATMULS + (torch.ops.aten.bmm.default,),
    "dots_no_batch": _MATMULS,
    "nothing": (),
}


def _remat_context(saved: tuple):
    """The selective-checkpoint contexts keeping the outputs of
    ``saved`` ops."""
    def policy(_ctx, op, *_args, **_kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else \
            CheckpointPolicy.PREFER_RECOMPUTE
    return create_selective_checkpoint_contexts(policy)


def _forward_hidden(ps, tokens, heads: int, causal: bool, cdt,
                    remat: bool = False, remat_policy: str | None = None,
                    moe_top_k: int = 1, moe_aux_weight: float = 0.0,
                    moe_zloss_weight: float = 0.0):
    """Embedding + block stack — the ONE pre-head forward body, shared by
    the CE loss (:func:`_forward_ce`) and the logits oracle
    (:func:`make_logits_fn`).  Returns ``(x, aux_term, ps_cast)``: the
    hidden states, the summed MoE regularizer term, and the params cast
    to the compute dtype (so the caller's head product follows the same
    precision policy).  ``remat`` wraps each block in
    ``torch.utils.checkpoint``: the backward recomputes the block's
    activations instead of keeping them; ``remat_policy`` (one of
    :data:`REMAT_POLICIES`, implies remat) keeps the outputs of its
    products.  The checkpoints keep no RNG state (the blocks draw
    nothing), which the CUDA graph capture needs."""
    ps = _map(lambda w: w.to(cdt), ps)
    x = ps["emb"][tokens]                            # (b, t, d)
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if remat_policy:
        kw["context_fn"] = functools.partial(_remat_context,
                                             REMAT_POLICIES[remat_policy])
    aux_term = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in ps["blocks"]:
        args = (x, p, heads, causal, moe_top_k, moe_aux_weight,
                moe_zloss_weight)
        x, aux = checkpoint(_block, *args, **kw) \
            if remat or remat_policy else _block(*args)
        if aux is not None:
            aux_term = aux_term + aux
    return x, aux_term, ps


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
                         use_reentrant=False, preserve_rng_state=False)
              for i in range(n_chunks)]
    return torch.stack(totals).sum()


def _forward_ce(ps, tokens, labels, mask, heads: int, causal: bool,
                cdt, loss_chunks: int | None = None, **hidden_kw):
    """The ONE forward + CE-loss body (shared by the train step and the
    eval pass).  ``mask`` is a per-row validity mask or None; masked rows
    contribute neither loss nor gradients (padded rows still count in
    the MoE routing statistics, as in the reference: the aux is a
    regularizer, not a metric).  The reference's normalisations with one
    data and one sequence shard: the unmasked loss is the mean over all
    tokens, the masked one the nll sum over the valid rows' tokens, each
    plus the summed MoE regularizer term.  ``hidden_kw`` goes to
    :func:`_forward_hidden` (remat and the MoE options)."""
    x, aux_term, ps = _forward_hidden(ps, tokens, heads, causal, cdt,
                                      **hidden_kw)
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
        return nll / (b_l * t_l) + aux_term
    total = mask.float().sum() * t_l
    return nll / torch.clamp(total, min=1.0) + aux_term


# -- the step, eval and logits factories ------------------------------------
def _refuse(mesh, **options) -> None:
    """The reference options the port has not ported: each raises rather
    than being ignored, naming its ROADMAP item."""
    axes = dict(getattr(mesh, "shape", mesh) or {})
    wide = {a: n for a, n in axes.items() if n != 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: data, sequence, tensor and expert "
            f"parallelism are not ported yet (ROADMAP.md queue A item 10b, "
            f"multi-GPU axes); the port trains on one device")
    for name, value in options.items():
        if value:
            item = "14" if name == "anatomy" else "10b"
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (ROADMAP.md queue A "
                f"item {item})")


def _check_moe(n_experts, moe_top_k: int, moe_aux_weight: float = 0.0,
               moe_zloss_weight: float = 0.0) -> None:
    """The MoE options' validity: the reference's ``_check_tp`` on a
    one-device mesh (every expert count divides by tp 1), plus the
    port's refusal of MoE options on a dense stack (the reference
    ignores them there; its ``TransformerLMStep`` refuses them too) and
    of a ``moe_top_k`` outside ``1..n_experts``."""
    if not n_experts:
        if moe_aux_weight or moe_zloss_weight or moe_top_k != 1:
            raise ValueError(
                "moe_aux_weight/moe_zloss_weight/moe_top_k have no effect "
                "without n_experts — a dense model would train silently")
        return
    if not 1 <= moe_top_k <= n_experts:
        raise ValueError(f"moe_top_k={moe_top_k} must be in 1.."
                         f"n_experts={n_experts}")


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


def _tensor(a, dtype=torch.int64):
    """Token ids (or a row mask) from numpy or a tensor, as ``dtype``, on
    the device they are on."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(dtype=dtype)


def _batch(masked: bool, tokens, labels, mask) -> tuple:
    """``(tokens, labels[, mask])`` as the step's input tensors."""
    if masked != (mask is not None):
        raise ValueError("a masked step takes a mask and an unmasked step "
                         "none")
    inputs = (_tensor(tokens), _tensor(labels))
    return inputs if mask is None else inputs + (_tensor(mask, torch.bool),)


def _check_params(params, dev) -> list:
    leaves = _leaves(params)
    for w in leaves:
        if w.device.type != dev.type or w.dtype != torch.float32:
            raise ValueError(
                f"params must be float32 tensors on {dev} (see "
                f"params_from_numpy); got {w.dtype} on {w.device}")
    return leaves


def _eager(dev):
    """-> ``run(kind, leaves, body, inputs)``: ``body(*inputs)`` with its
    inputs on ``dev``, eagerly."""
    def run(_kind, _leaves, body, inputs):
        return body(*(t.to(dev) for t in inputs))
    return run


def _runner(dev):
    """-> ``run(kind, leaves, body, inputs)`` for a step factory: eager
    on the CPU; on the card through ``run_graphed`` (the first call of a
    key eager, the second captured, later ones replayed), one graph a
    (kind, input shapes and dtypes, param tensors).  A graph reads and
    updates the tensors it captured, so a call with other param tensors
    drops the old graph and captures anew.  A replay's output is
    overwritten by the next replay: the caller gets a copy.  ``run.graphs``
    maps each key to its ``_StepGraph`` (None after the eager call)."""
    if dev.type != "cuda":
        run = _eager(dev)
        run.graphs = None
        return run
    graphs, stream = {}, torch.cuda.Stream(dev)

    def run(kind, leaves, body, inputs):
        shapes = (kind,) + tuple((tuple(t.shape), t.dtype) for t in inputs)
        key = shapes + (tuple(w.data_ptr() for w in leaves),)
        for stale in [k for k in graphs if k[:-1] == shapes and k != key]:
            del graphs[stale]
        return run_graphed(graphs, key, f"LM step's {kind}", body, inputs,
                           dev, stream).clone()

    run.graphs = graphs
    return run


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
    ``donate=True`` buys.  ``loss`` is a 0-d f32 tensor on the device,
    which later steps leave as it is.  On the card the step is a CUDA
    graph replay from its second call on the same params (see
    :func:`_runner`); ``step.eager`` runs the same body with eager
    launches (to hold the replays against), ``step.graphs`` holds the
    graphs.

    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``), ``remat_policy`` ("dots" |
    "dots_no_batch" | "nothing", :data:`REMAT_POLICIES`) keeps the
    outputs of its products and recomputes the rest; ``loss_chunks=k``
    computes the CE k token-chunks at a time, each recomputed in the
    backward, so the ``(tokens, vocab)`` f32 logits never exist whole.
    ``n_experts=E`` swaps every block's dense FFN for a dense-masked MoE
    FFN (``parallel/moe.py``; pass ``init_params(..., n_experts=E)``
    params) routing each token to its ``moe_top_k`` best experts;
    ``moe_aux_weight`` adds the switch load-balance aux and
    ``moe_zloss_weight`` the router z-loss, summed over blocks, to the
    training loss.  ``device`` defaults to ``cuda`` and raises on a host
    without one — the port never falls back to the CPU on its own.  The
    reference's sharding, quantized-collective and anatomy options raise
    ``NotImplementedError``."""
    dev, cdt = _setup(
        mesh, d, heads, compute_dtype, device, shard_update=shard_update,
        shard_params=shard_params, head_sharded=head_sharded,
        quantized_collectives=quantized_collectives, anatomy=anatomy)
    _check_moe(n_experts, moe_top_k, moe_aux_weight, moe_zloss_weight)
    if remat_policy is not None and remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={remat_policy!r} — choose from "
                         f"{sorted(REMAT_POLICIES)}")
    fwd_kw = dict(loss_chunks=loss_chunks, remat=remat,
                  remat_policy=remat_policy, moe_top_k=moe_top_k,
                  moe_aux_weight=moe_aux_weight,
                  moe_zloss_weight=moe_zloss_weight)

    def body_of(params, leaves):
        def body(tok, lab, m=None):
            loss = _forward_ce(params, tok, lab, m, heads, causal, cdt,
                               **fwd_kw)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for w, g in zip(leaves, grads):
                    w.sub_(lr * g)
            return loss.detach()
        return body

    def call(run, params, tokens, labels, mask):
        inputs = _batch(masked, tokens, labels, mask)
        leaves = _check_params(params, dev)
        # autograd's leaves are marked outside the (captured) body
        for w in leaves:
            w.requires_grad_(True)
        try:
            loss = run("train", leaves, body_of(params, leaves), inputs)
        finally:
            for w in leaves:
                w.requires_grad_(False)
        return params, loss

    run, eager_run = _runner(dev), _eager(dev)

    def step(params, tokens, labels, mask=None):
        return call(run, params, tokens, labels, mask)

    def eager(params, tokens, labels, mask=None):
        return call(eager_run, params, tokens, labels, mask)

    step.eager, step.graphs = eager, run.graphs
    return step


def make_eval_loss(mesh, n_layers: int, d: int,
                   heads: int, ff: int, vocab: int,
                   causal: bool = True, compute_dtype=None,
                   masked: bool = False, loss_chunks: int | None = None,
                   head_sharded: bool = False, n_experts: int | None = None,
                   moe_top_k: int = 1, device=None):
    """-> ``eval_loss(params, tokens, labels[, mask]) -> loss`` — the
    train step's forward + CE loss (the shared :func:`_forward_ce`) with
    no update, no autograd graph and no MoE regularizers (it has no aux
    weights, as the reference's has none).  On the card a CUDA graph
    replay from its second call on the same params, as the train step
    is; ``eval_loss.graphs`` holds the graphs."""
    dev, cdt = _setup(mesh, d, heads, compute_dtype, device,
                      head_sharded=head_sharded)
    _check_moe(n_experts, moe_top_k)

    def body_of(params):
        @torch.no_grad()
        def body(tok, lab, m=None):
            return _forward_ce(params, tok, lab, m, heads, causal, cdt,
                               loss_chunks=loss_chunks, moe_top_k=moe_top_k)
        return body

    run = _runner(dev)

    def eval_loss(params, tokens, labels, mask=None):
        inputs = _batch(masked, tokens, labels, mask)
        leaves = _check_params(params, dev)
        return run("eval", leaves, body_of(params), inputs)

    eval_loss.graphs = run.graphs
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
    dev, cdt = _setup(mesh, d, heads, compute_dtype, device)
    _check_moe(n_experts, moe_top_k)

    @torch.no_grad()
    def logits(params, tokens):
        _check_params(params, dev)
        x, _aux, ps = _forward_hidden(params, _tensor(tokens).to(dev),
                                      heads, causal, cdt,
                                      moe_top_k=moe_top_k)
        return (x @ ps["head"]).float()

    return logits
