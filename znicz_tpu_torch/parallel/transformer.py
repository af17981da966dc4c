"""The transformer LM on a ``(data, seq, model)`` mesh — the port of
``znicz_tpu/parallel/transformer.py``'s ``make_train_step``,
``make_eval_loss`` and ``make_logits_fn``: layer norm, the
compute-dtype policy, parameter init and layouts, and the functional
trainer, eval loss and full-pass logits oracle over one shared forward
body.

Parameters are a plain dict of tensors mirroring the reference's
pytree: ``emb (vocab, d)``, ``head (d, vocab)`` and ``blocks[i]`` with
``ln1_g ln1_b wq wk wv wo ln2_g ln2_b`` and either the dense FFN's
``w1 b1 w2 b2`` or, with ``n_experts``, the MoE FFN's ``gate ew1 eb1
ew2 eb2`` (``parallel/moe.py``).  :func:`init_params` is pure numpy and
draws in the reference's order, so one seed gives identical weights in
both packages.

The mesh.  One process a device, each a rank of one ``torch.distributed``
world; ``mesh`` (``parallel/mesh.py make_mesh``, or a ``{axis: size}``)
is this rank's place on ``(data, seq, model)``, None a mesh of one with
no group.  Each rank holds its local shards in f32, by the layouts of
:func:`param_specs` (specs are tuples of axis names, ``()``
replicated): attention's q/k/v column-sharded and wo row-sharded over
``model``, the MLP Megatron-sharded, MoE experts sharded ``E/tp`` a
rank, the head vocab-sharded with ``head_sharded``.
:func:`params_from_numpy` places a global numpy pytree on a mesh (the
reference's ``device_put`` with ``NamedSharding``) and
:func:`params_to_numpy`, collective on a mesh, gathers it back.  A step
takes the global minibatch and cuts this rank's block: the rows of
``data``, the time block of ``seq`` and the mask rows of ``data``.
Attention is the flash kernels' (``kernels/flash_attention.py``: on
CUDA tensors the hand-written kernels, on CPU tensors their plain
versions): plain flash at ``seq`` 1, ring flash attention
(``parallel/ring_attention.py``) above.  There is no switch back to
dense attention (``root.common.engine.flash_attention``): a step for a
head dim or dtype the kernels lack raises when it is built.

The gradients are the reference's.  It differentiates inside
``shard_map`` with replication checking off, where a ``psum``'s
transpose is again a ``psum`` (the cotangent of a rank's term is the
sum of the cotangents over the group), its loss is the ``(data,
seq)`` sum of the local terms and its update divides by the shard
count.  The port reproduces each leaf's update: every rank
differentiates its own local term (:func:`_forward_ce`, the
reference's ``reduce=False`` form), every collective of the forward is
a ``torch.autograd.Function`` whose backward is the reference's
transpose (``tp.psum``, the ring's rotations), and the update is ``w -=
lr·g``; with a codec the gradients are summed over ``(data, seq)``
through ``qcomm.quantized_psum`` and divided by the shard count, as the
reference's are.  A replica of a replicated leaf therefore takes its
own gradient, as in the reference: above ``data``, ``seq`` or
``model`` 1 the run is not the one-device run (ROADMAP.md
"Divergences").

On CUDA the train step and the eval body run as CUDA graph replays
(``parallel/graphs.py run_graphed``), one graph a (body, input shapes,
param tensors), the mesh's collectives captured with them: the
counterpart of the reference's one jitted program a minibatch.  A CUDA
step needs an NCCL world (``mesh.check_backend``).  The CPU runs them
eagerly.

The ``(data, pipe, expert)`` configuration: :func:`init_moe_pipeline_params`
(stage-stacked MoE blocks, a flat dict ``gate w1 b1 w2 b2``),
:func:`moe_pipeline_specs` and :func:`make_pipeline_step`, GPipe over
``pipe`` (``parallel/pipeline.py``) with the dense-masked MoE FFN over
``expert`` in each stage.  Its gradients are the reference's in the
same way: the pipeline's and the experts' sums are ``tp.psum``, so at
``pipe`` S the first update is S times the sequential model's, and a
replica of ``gate`` (replicated over ``expert``) or of any leaf over
``data`` takes its own gradient (ROADMAP.md "Divergences").

``make_train_step(anatomy=True)`` is the reference's split-dispatch
step: its phases (``zero_gather`` under shard_params, ``grad``,
``collective``, ``update``) run eagerly one after another with a
``torch.cuda.synchronize()`` and a host stamp at each seam, feeding
``znicz_anatomy_*{plane="transformer"}``; see :func:`make_train_step`.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from znicz_tpu_torch.core.backends import device as _device
from znicz_tpu_torch.core.backends import resolve_compute_dtype
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.kernels import flash_attention as _kflash
from znicz_tpu_torch.parallel import mesh as _mesh
from znicz_tpu_torch.parallel import qcomm, tp, zero
from znicz_tpu_torch.parallel.graphs import run_graphed
from znicz_tpu_torch.parallel.moe import (load_balance_aux, moe_ffn,
                                          router_z_loss)
from znicz_tpu_torch.parallel.pipeline import pipeline_apply
from znicz_tpu_torch.parallel.ring_attention import ring_flash_attention
from znicz_tpu_torch.parallel.tree import (tree_leaves as _leaves,
                                           tree_map as _map,
                                           tree_rebuild as _rebuild)

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


# -- layouts ------------------------------------------------------------------
def param_specs(n_layers: int, head_sharded: bool = False,
                moe: bool = False) -> dict:
    """The reference's PartitionSpecs as tuples (``()`` replicated):
    attention qkv column-sharded, wo row-sharded, MLP Megatron-sharded
    over ``model``; the rest replicated.  ``head_sharded`` vocab-shards
    the LM head over ``model``; ``moe`` shards the expert stacks over
    ``model`` on the expert dim, gate replicated."""
    blk = {"ln1_g": (), "ln1_b": (),
           "wq": (None, "model"), "wk": (None, "model"),
           "wv": (None, "model"), "wo": ("model", None),
           "ln2_g": (), "ln2_b": ()}
    if moe:
        blk.update({"gate": (), "ew1": ("model", None, None),
                    "eb1": ("model", None), "ew2": ("model", None, None),
                    "eb2": ("model", None)})
    else:
        blk.update({"w1": (None, "model"), "b1": ("model",),
                    "w2": ("model", None), "b2": ()})
    head = (None, "model") if head_sharded else ()
    return {"emb": (), "head": head,
            "blocks": [dict(blk) for _ in range(n_layers)]}


def shard_params_specs(specs) -> dict:
    """The ``shard_params`` layout: every replicated leaf becomes a flat
    array sharded over ``data``; tensor-sharded leaves keep theirs."""
    return _map(lambda s: ("data",) if s == () else s, specs)


def shard_params_host(params, specs, n: int) -> dict:
    """Host-side conversion INTO the ``shard_params`` layout: replicated
    leaves flatten and zero-pad to a multiple of ``n``; tensor-sharded
    leaves pass through.  ``specs`` is the replicated layout
    (:func:`param_specs`)."""
    def conv(w, s):
        if s != ():
            return w
        f = np.asarray(w).reshape(-1)
        return np.pad(f, (0, (-f.size) % n)) if f.size % n else f
    return _map(conv, params, specs)


def unshard_params_host(params, specs, shapes) -> dict:
    """Inverse of :func:`shard_params_host` on host arrays: flat padded
    leaves slice back to their :func:`param_shapes` shapes."""
    flat = [np.asarray(w).reshape(-1)[:int(np.prod(shp))].reshape(shp)
            if s == () else np.asarray(w)
            for w, s, shp in zip(_leaves(params), _leaves(specs),
                                 _leaves(shapes))]
    return _rebuild(params, flat)


def _check_tp(model_size: int, heads: int, d: int, ff: int,
              vocab_sharded: int | None = None,
              n_experts: int | None = None) -> int:
    """The reference's ``_check_tp`` -> the heads a ``model`` rank
    holds."""
    if heads % model_size or d % model_size:
        raise ValueError(f"tp={model_size} must divide heads={heads} "
                         f"and d={d}")
    # the MoE FFN shards the EXPERT dim, never ff; the dense FFN
    # Megatron-splits ff
    if n_experts:
        if n_experts % model_size:
            raise ValueError(f"n_experts={n_experts} must divide by "
                             f"tp={model_size}")
    elif ff % model_size:
        raise ValueError(f"tp={model_size} must divide ff={ff}")
    if vocab_sharded is not None and vocab_sharded % model_size:
        raise ValueError(f"head_sharded needs vocab={vocab_sharded} "
                         f"divisible by tp={model_size}")
    return heads // model_size


def _as_mesh(mesh) -> "_mesh.Mesh":
    """None -> a mesh of one with no group; a ``Mesh`` as given; a
    ``{axis: size}`` (or an object with ``.shape``) through
    ``make_mesh``."""
    if mesh is None:
        return _mesh.local_mesh()
    if isinstance(mesh, _mesh.Mesh):
        return mesh
    return _mesh.make_mesh(dict(getattr(mesh, "shape", mesh)))


def _shard(a, spec, mesh):
    """This rank's block of the global array ``a`` under ``spec``."""
    for dim, name in enumerate(spec):
        if name is None:
            continue
        k, i = mesh.shape.get(name, 1), mesh.coords.get(name, 0)
        if a.shape[dim] % k:
            raise ValueError(f"dim {dim} of {tuple(a.shape)} does not "
                             f"split over {name}={k}")
        n = a.shape[dim] // k
        a = a[(slice(None),) * dim + (slice(i * n, (i + 1) * n),)]
    return a


def _global(gathered: np.ndarray, spec, mesh) -> np.ndarray:
    """The global array from every rank's block (``gathered[i]``: the
    world line's order, row-major over the coordinates): each block is
    read from the first rank that holds it (the rank with the
    block's coordinates on the spec's axes and 0 on the others), as the
    reference's ``device_get`` reads the first device holding it."""
    sharded = [(dim, name) for dim, name in enumerate(spec)
               if name is not None]
    local = gathered.shape[1:]
    shape = list(local)
    for dim, name in sharded:
        shape[dim] *= mesh.shape.get(name, 1)
    out = np.empty(shape, gathered.dtype)
    sizes = tuple(mesh.shape.values()) or (1,)
    for idx in itertools.product(*(range(mesh.shape.get(name, 1))
                                   for _, name in sharded)):
        coords = {name: i for (_, name), i in zip(sharded, idx)}
        owner = int(np.ravel_multi_index(
            tuple(coords.get(a, 0) for a in mesh.shape) or (0,), sizes))
        where = [slice(None)] * len(shape)
        for (dim, _), i in zip(sharded, idx):
            where[dim] = slice(i * local[dim], (i + 1) * local[dim])
        out[tuple(where)] = gathered[owner]
    return out


def _need_specs(specs) -> None:
    if specs is None:
        raise ValueError("a mesh needs the layout's specs (a step's "
                         "step.specs, or param_specs / moe_pipeline_specs)")


def params_from_numpy(params, device, dtype=torch.float32, mesh=None,
                      specs=None) -> dict:
    """Copy a parameter pytree of numpy (or CPU tensor) leaves onto
    ``device`` as ``dtype`` tensors, keeping the pytree's shape.  On a
    ``mesh`` each leaf is this rank's block of the global leaf under
    ``specs``, which a mesh needs (a step's layout is ``step.specs``).
    Always a copy, never a view of the caller's arrays: the train step
    updates its params in place."""
    def put(a, spec):
        a = np.asarray(a, np.float32)
        if mesh is not None:
            a = _shard(a, spec, mesh)
        return torch.tensor(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)
    if mesh is not None:
        mesh = _as_mesh(mesh)
        _need_specs(specs)
    return _map(put, params, specs or _map(lambda _: (), params))


def params_to_numpy(params, mesh=None, specs=None) -> dict:
    """The inverse of :func:`params_from_numpy`: a numpy f32 pytree (what
    ``utils.export.export_lm`` packages).  On a ``mesh`` the global
    pytree, gathered over the whole world: collective, every rank calls
    it and every rank gets the result, each block the first holder's (a
    replicated leaf's replicas may differ: the first rank's copy, as the
    reference's ``out_specs`` reads its first device's)."""
    if mesh is None:
        return _map(lambda a: a.detach().float().cpu().numpy(), params)
    mesh = _as_mesh(mesh)
    _need_specs(specs)
    every = mesh.axis(tuple(mesh.shape))
    return _map(lambda a, spec: _global(
        every.all_gather(a.detach().float()).cpu().numpy(), spec, mesh),
        params, specs)


class _Axes:
    """The step's axis handles on its mesh: ``data``, ``seq``, ``model``
    and ``ds`` (``("data", "seq")``, over which the loss and the
    quantized gradients sum); ``n_shards`` = data × seq."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.data = mesh.axis("data")
        self.seq = mesh.axis("seq")
        self.model = mesh.axis("model")
        self.ds = mesh.axis(("data", "seq"))
        self.n_shards = self.data.size * self.seq.size

    def cut(self, t, time: bool = True):
        """This rank's block of a global ``(batch, time)`` input (rows of
        ``data``, the time block of ``seq``), or of a ``(batch,)`` mask
        (``time=False``)."""
        nd, ns = self.data.size, self.seq.size
        b = t.shape[0]
        if b % nd:
            raise ValueError(f"batch {b} not divisible by data={nd}")
        rows = b // nd
        t = t[self.data.index * rows:(self.data.index + 1) * rows]
        if not time:
            return t
        if t.shape[1] % ns:
            raise ValueError(f"time {t.shape[1]} not divisible by "
                             f"seq={ns}")
        cols = t.shape[1] // ns
        return t[:, self.seq.index * cols:(self.seq.index + 1) * cols]


# -- the shared forward ------------------------------------------------------
def _block(x, p, ax, heads_local: int, causal: bool, moe_top_k: int = 1,
           moe_aux_weight: float = 0.0, moe_zloss_weight: float = 0.0):
    """One transformer block on local shards: flash attention over this
    rank's heads (ring flash attention over ``seq`` when it is sharded),
    then the Megatron MLP (tanh GELU) or, for an MoE block, the dense-
    masked MoE FFN over this rank's experts, each half summed over
    ``model``.  Returns ``(x, aux)``: the MoE block's regularizers,
    weighted here, or None for a dense block."""
    h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
    b, t_loc, _ = h.shape

    def heads_of(w):
        return (h @ w).reshape(b, t_loc, heads_local, -1)

    q, k, v = heads_of(p["wq"]), heads_of(p["wk"]), heads_of(p["wv"])
    if ax.seq.size > 1:
        o = ring_flash_attention(q, k, v, ax.seq, causal=causal)
    else:
        o = _kflash.flash_attention(q, k, v, causal=causal)
    o = o.reshape(b, t_loc, -1)
    x = x + tp.row_parallel(o, p["wo"], None, ax.model)
    m = _layer_norm(x, p["ln2_g"], p["ln2_b"])
    if "ew1" not in p:
        return x + tp.mlp(m, p["w1"], p["b1"], p["w2"], p["b2"], _GELU,
                          ax.model), None
    m2d = m.reshape(-1, m.shape[-1])
    y2d, probs = moe_ffn(m2d, p["gate"], p["ew1"], p["eb1"], p["ew2"],
                         p["eb2"], _GELU, ax.model, top_k=moe_top_k)
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


def _forward_hidden(ps, tokens, heads_local: int, causal: bool, cdt,
                    ax=None, remat: bool = False,
                    remat_policy: str | None = None, moe_top_k: int = 1,
                    moe_aux_weight: float = 0.0,
                    moe_zloss_weight: float = 0.0):
    """Embedding + block stack — the ONE pre-head forward body, shared by
    the CE loss (:func:`_forward_ce`) and the logits oracle
    (:func:`make_logits_fn`).  Returns ``(x, aux_term, ps_cast)``: the
    hidden states, the summed MoE regularizer term, and the params cast
    to the compute dtype (so the caller's head product follows the same
    precision policy).  ``ax`` is the step's axes (None: one device).
    ``remat`` wraps each block in
    ``torch.utils.checkpoint``: the backward recomputes the block's
    activations (and its collectives) instead of keeping them;
    ``remat_policy`` (one of :data:`REMAT_POLICIES`, implies remat)
    keeps the outputs of its products.  The checkpoints keep no RNG
    state (the blocks draw nothing), which the CUDA graph capture
    needs."""
    ax = ax or _Axes(_mesh.local_mesh())
    ps = _map(lambda w: w.to(cdt), ps)
    x = ps["emb"][tokens]                            # (b, t, d)
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if remat_policy:
        kw["context_fn"] = functools.partial(_remat_context,
                                             REMAT_POLICIES[remat_policy])
    aux_term = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in ps["blocks"]:
        args = (x, p, ax, heads_local, causal, moe_top_k, moe_aux_weight,
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


def _vshard_chunk_nll(xc, lc, wc, head_local, model):
    """The same sum for a VOCAB-SHARDED head (Megatron parallel cross
    entropy, arXiv:1909.08053 §3): each ``model`` rank computes its
    ``(chunk, vocab/tp)`` logit columns; the stable-softmax max reduces
    by an all-reduce MAX with no gradient (the shift is gradient-
    neutral), the sum-exp and the owner's picked logit by ``tp.psum`` —
    the full-vocab logits row never exists on any rank."""
    logits = (xc @ head_local).float()               # (chunk, v_loc)
    v_loc = logits.shape[-1]
    start = model.index * v_loc
    m = model.all_reduce_(logits.detach().amax(-1), op="max")
    se = tp.psum(torch.exp(logits - m[:, None]).sum(-1), model)
    lse = m + torch.log(se)
    mine = (lc >= start) & (lc < start + v_loc)
    picked_loc = logits.gather(-1, (lc - start).clamp(0, v_loc - 1)
                               [:, None])[:, 0]
    picked = tp.psum(torch.where(mine, picked_loc,
                                 torch.zeros_like(picked_loc)), model)
    return (-(picked - lse) * wc).sum()


def _ce_token_nll_sum(x, labels, chunk_nll, n_chunks: int, weights):
    """Σ weights·(-log p[label]) over the local tokens, ``n_chunks``
    token chunks at a time, each recomputed in the backward
    (``torch.utils.checkpoint``): the full ``(tokens, vocab)`` f32
    logits never exist, only one chunk's.  ``chunk_nll(xc, lc, wc)`` is
    the chunk's sum.  Padded rows weigh 0.  Per-token numerics equal the
    dense path; only the cross-token summation order differs."""
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
    totals = [checkpoint(chunk_nll, xf[i * chunk:(i + 1) * chunk],
                         lf[i * chunk:(i + 1) * chunk],
                         wf[i * chunk:(i + 1) * chunk],
                         use_reentrant=False, preserve_rng_state=False)
              for i in range(n_chunks)]
    return torch.stack(totals).sum()


def _forward_ce(ps, tokens, labels, mask, heads_local: int, causal: bool,
                cdt, ax=None, loss_chunks: int | None = None,
                head_sharded: bool = False, **hidden_kw):
    """The ONE forward + CE-loss body (shared by the train step and the
    eval pass) -> this rank's LOCAL term, whose sum over ``(data, seq)``
    is the reference's reduced loss times the shard count (its
    ``reduce=False`` form).  ``mask`` is this rank's rows' validity or
    None; masked rows contribute neither loss nor gradients (padded rows
    still count in the MoE routing statistics, as in the reference: the
    aux is a regularizer, not a metric).  Unmasked: the local token mean
    plus the MoE term; masked: ``n_shards·nll / total`` (``total`` the
    valid tokens of the whole minibatch: the mask is seq-invariant, so
    its count sums over ``data`` and multiplies by ``seq``) plus the MoE
    term.  A vocab-sharded head always takes the chunk helper (its CE
    needs the reduced softmax; one chunk when unchunked).
    ``hidden_kw`` goes to :func:`_forward_hidden`."""
    ax = ax or _Axes(_mesh.local_mesh())
    x, aux_term, ps = _forward_hidden(ps, tokens, heads_local, causal, cdt,
                                      ax, **hidden_kw)
    b_l, t_l = labels.shape
    mvec = mask[:, None].float() if mask is not None else None
    if head_sharded or (loss_chunks and loss_chunks > 1):
        fn = functools.partial(_vshard_chunk_nll, head_local=ps["head"],
                               model=ax.model) if head_sharded else \
            functools.partial(_dense_chunk_nll, head=ps["head"])
        nll = _ce_token_nll_sum(x, labels, fn, max(loss_chunks or 1, 1),
                                mvec)
    else:
        logits = (x @ ps["head"]).float()
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(-1, labels[..., None])[..., 0]
        nll = -picked.sum() if mvec is None else \
            -(picked * mvec.expand_as(picked)).sum()
    if mask is None:
        return nll / (b_l * t_l) + aux_term
    total = ax.data.all_reduce_(mask.float().sum() * t_l) * ax.seq.size
    return ax.n_shards * nll / torch.clamp(total, min=1.0) + aux_term


def _reduced(local, ax):
    """The reported loss: the local terms summed over ``(data, seq)``
    over the shard count (exactly, whatever the codec), then the
    ``model`` line's first rank's on every rank.  The model ranks'
    replicas of the replicated leaves take their own gradients (the
    reference's transpose), so their losses part after the first step;
    the reference reports its first device's, and a workflow on every
    rank must read one number to take one decision."""
    loss = ax.ds.all_reduce_(local.detach().clone()) / ax.n_shards
    if ax.model.group is not None and ax.model.size > 1:
        loss = ax.model.all_reduce_(
            loss if ax.model.index == 0 else torch.zeros_like(loss))
    return loss


# -- the step, eval and logits factories ------------------------------------
def _check_moe(n_experts, moe_top_k: int, moe_aux_weight: float = 0.0,
               moe_zloss_weight: float = 0.0) -> None:
    """The port's refusal of MoE options on a dense stack (the reference
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


def _setup(mesh, d: int, heads: int, ff: int, vocab_sharded, n_experts,
           compute_dtype, device):
    """Shared build-time checks -> ``(axes, device, compute dtype, heads
    a model rank holds)``.  On CUDA the flash kernels must have an
    instantiation for the head dim and compute dtype, and the world must
    be NCCL's — decided here, never mid-step."""
    if d % heads:
        raise ValueError(f"heads={heads} must divide d={d}")
    ax = _Axes(_as_mesh(mesh))
    heads_local = _check_tp(ax.model.size, heads, d, ff, vocab_sharded,
                            n_experts)
    _mesh.check_backend(ax.mesh, torch.device(device or "cuda"))
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
    return ax, dev, cdt, heads_local


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


def _cutter(ax):
    """-> ``cut(tokens, labels, mask=None)``: this rank's block of a
    global minibatch (numpy or tensors), as the step's local inputs take
    it."""
    def cut(tokens, labels, mask=None):
        block = (ax.cut(tokens), ax.cut(labels))
        return block if mask is None else block + (ax.cut(mask, False),)
    return cut


def _check_params(params, dev, shapes) -> list:
    leaves = _leaves(params)
    for w, shape in zip(leaves, _leaves(shapes)):
        if w.device.type != dev.type or w.dtype != torch.float32:
            raise ValueError(
                f"params must be float32 tensors on {dev} (see "
                f"params_from_numpy); got {w.dtype} on {w.device}")
        if tuple(w.shape) != tuple(shape):
            raise ValueError(
                f"a param of shape {tuple(w.shape)} where this rank's "
                f"layout holds {tuple(shape)} (place global params with "
                f"params_from_numpy(..., mesh=, specs=step.specs))")
    return leaves


def _local_shapes(shapes, specs, ax) -> dict:
    """The shapes of this rank's blocks of leaves of ``shapes`` under
    ``specs`` (a flat ``("data",)`` leaf: its padded slice)."""
    def local(shape, spec):
        if spec == ("data",):
            return (zero.shard_len(int(np.prod(shape)), ax.data.size),)
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        return tuple(n // (ax.mesh.shape.get(a, 1) if a else 1)
                     for n, a in zip(shape, spec))
    return _map(local, shapes, specs)


def _eager(dev):
    """-> ``run(kind, leaves, body, inputs)``: ``body(*inputs)`` with its
    inputs on ``dev``, eagerly."""
    def run(_kind, _leaves, body, inputs):
        return body(*(t.to(dev) for t in inputs))
    return run


def _with_grad(run, held=lambda leaves: leaves):
    """``run`` with autograd's leaves (``held(leaves)``) marked outside
    the (captured) body, unmarked after it."""
    def graded(kind, leaves, body, inputs):
        marked = held(leaves)
        for w in marked:
            w.requires_grad_(True)
        try:
            return run(kind, leaves, body, inputs)
        finally:
            for w in marked:
                w.requires_grad_(False)
    return graded


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


def _entry(run, kind: str, dev, ax, masked: bool, shapes, body_of):
    """-> ``(fn, local)``: ``fn(params, tokens, labels[, mask])`` on a
    global minibatch, which it cuts to this rank's block, and
    ``local(params, *block)`` on a block already cut (``fn.cut``), both
    through ``run``."""
    cut = _cutter(ax)

    def local(params, *block):
        leaves = _check_params(params, dev, shapes)
        return run(kind, leaves, body_of(params, leaves), block)

    def fn(params, tokens, labels, mask=None):
        return local(params, *cut(*_batch(masked, tokens, labels, mask)))

    fn.cut, fn.local = cut, local
    return fn


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
    train step on this rank of ``mesh``.

    ``mesh``: None (one device, no group), a ``parallel/mesh.py Mesh``
    or a ``{axis: size}`` over the world.  ``params``: this rank's f32
    blocks on ``device`` in the layout ``step.specs``
    (:func:`params_from_numpy` with ``mesh`` and ``specs``);
    ``tokens``/``labels``: the GLOBAL int ``(batch, time)`` minibatch,
    numpy or tensors, of which the step takes this rank's block
    (``step.local(params, *step.cut(tokens, labels[, mask]))`` takes a
    block already cut, as the LM unit's staging does).  The forward
    casts the masters to ``compute_dtype`` (default: bf16 on cuda, f32
    on cpu); autograd carries the gradients back to the f32 masters and
    the update is applied IN PLACE — the returned ``params`` is the same
    dict, and the in-place update is what the reference's ``donate=True``
    buys.  ``loss`` is the global loss, a 0-d f32 tensor on the device.
    On the card the step is a CUDA graph replay from its second call on
    the same params (see :func:`_runner`); ``step.eager`` runs the same
    body with eager launches, ``step.graphs`` holds the graphs.

    ``remat`` recomputes each block in the backward, ``remat_policy``
    ("dots" | "dots_no_batch" | "nothing", :data:`REMAT_POLICIES`)
    keeps the outputs of its products; ``loss_chunks=k`` computes the CE
    k token-chunks at a time, each recomputed in the backward;
    ``head_sharded`` vocab-shards the head over ``model`` with Megatron
    parallel cross-entropy (:func:`_vshard_chunk_nll`).  ``n_experts=E``
    swaps every block's dense FFN for the dense-masked MoE FFN
    (``parallel/moe.py``, experts sharded over ``model``) routing each
    token to its ``moe_top_k`` best experts; ``moe_aux_weight`` adds the
    switch load-balance aux and ``moe_zloss_weight`` the router z-loss,
    summed over blocks, to the training loss.

    The layouts of the replicated leaves (the reference's
    arXiv:2004.13336 splits over ``data``): ``shard_update`` updates a
    1/n slice a ``data`` rank and regathers the slices through a sum
    (``zero.psum_regather``); ``shard_params`` keeps them flat-sharded
    over ``data`` between steps (``step.specs`` is
    :func:`shard_params_specs`; place :func:`shard_params_host` arrays,
    read back with :func:`unshard_params_host`), gathers them ahead of
    the forward outside autograd (``zero.gather_chain``, one collective
    a leaf; ``root.common.engine.zero_gather_via_psum`` takes the
    sum form) and updates the local slice.  ``quantized_collectives``
    (None defers to ``root.common.engine.quantized_collectives``) sums
    every gradient leaf over ``(data, seq)`` through one quantized sum
    (``qcomm.quantized_psum``) and ships the ``shard_params`` gathers
    quantized; the reported loss sums exactly.

    ``anatomy=True`` returns the reference's split-dispatch step
    instead: the same gather, forward, autograd and update calls run
    eagerly phase by phase (``zero_gather`` / ``grad`` / ``collective`` /
    ``update``, see :func:`_anatomy_step`), with a device sync and a host
    stamp at each seam feeding ``znicz_anatomy_*{plane="transformer"}``.
    Its reduction follows the quantized-collectives semantics (the local
    gradients plus one explicit sum over ``(data, seq)`` — the true
    batch-mean gradient) even with no codec, as the reference's does, so
    on a mesh it tracks the plain step within a band, not bitwise; on one
    device the two are the same calls.  A diagnostic mode: on the card
    it runs eagerly, never as a graph replay (``step.graphs`` is None).

    ``device`` defaults to ``cuda`` and raises on a host without one —
    the port never falls back to the CPU on its own; a CUDA step needs
    an NCCL world."""
    if shard_params and shard_update:
        raise ValueError(
            "shard_params subsumes shard_update (replicated leaves "
            "persist sharded and update in place — there is no "
            "regather left to split); pass only one")
    ax, dev, cdt, heads_local = _setup(
        mesh, d, heads, ff, vocab if head_sharded else None, n_experts,
        compute_dtype, device)
    _check_moe(n_experts, moe_top_k, moe_aux_weight, moe_zloss_weight)
    if remat_policy is not None and remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={remat_policy!r} — choose from "
                         f"{sorted(REMAT_POLICIES)}")
    specs = param_specs(n_layers, head_sharded, moe=bool(n_experts))
    step_specs = shard_params_specs(specs) if shard_params else specs
    shapes = param_shapes(n_layers, d, ff, vocab, n_experts=n_experts)
    full_shapes = _leaves(_local_shapes(shapes, specs, ax))
    replicated = [s == () for s in _leaves(specs)]
    via_psum = bool(root.common.engine.get("zero_gather_via_psum", False))
    codec = qcomm.resolve(quantized_collectives)
    fwd_kw = dict(loss_chunks=loss_chunks, head_sharded=head_sharded,
                  remat=remat, remat_policy=remat_policy,
                  moe_top_k=moe_top_k, moe_aux_weight=moe_aux_weight,
                  moe_zloss_weight=moe_zloss_weight)
    n_data, i_data = ax.data.size, ax.data.index

    def full_leaves(leaves) -> list:
        """The leaves the forward reads: under ``shard_params`` the
        replicated ones gathered whole (outside autograd, so the
        gradients are the replicated layout's), marked for autograd."""
        if not shard_params:
            return leaves
        idx = [i for i, r in enumerate(replicated) if r]
        with torch.no_grad():
            whole = zero.gather_chain([leaves[i] for i in idx],
                                      [full_shapes[i] for i in idx],
                                      ax.data, via_psum=via_psum,
                                      codec=codec)
        out = list(leaves)
        for i, w in zip(idx, whole):
            out[i] = w.requires_grad_(True)
        return out

    def update_(leaves, grads, summed: bool = False) -> None:
        for w, g, rep in zip(leaves, grads, replicated):
            # the reference's w - lr·g/n with its n-scaled g: lr·g here
            # (an explicit sum, the codec's or anatomy's, carries the n
            # back)
            upd = lr * g / ax.n_shards if codec is not None or summed \
                else lr * g
            if rep and shard_params:
                w.sub_(zero.pad_slice(upd, i_data, n_data))
            elif rep and shard_update:
                w.copy_(zero.psum_regather(
                    zero.pad_slice(w, i_data, n_data) -
                    zero.pad_slice(upd, i_data, n_data), ax.data, w))
            else:
                w.sub_(upd)

    def body_of(params, leaves):
        def body(tok, lab, m=None):
            full = full_leaves(leaves)
            local = _forward_ce(_rebuild(params, full), tok, lab, m,
                                heads_local, causal, cdt, ax, **fwd_kw)
            grads = torch.autograd.grad(local, full)
            with torch.no_grad():
                if codec is not None:
                    grads, _ = qcomm.quantized_psum(list(grads), ax.ds,
                                                    codec)
                loss = _reduced(local, ax)
                update_(leaves, grads)
            return loss
        return body

    local_shapes = _local_shapes(shapes, step_specs, ax)
    if anatomy:
        def forward(params, full, tok, lab, m=None):
            return _forward_ce(_rebuild(params, full), tok, lab, m,
                               heads_local, causal, cdt, ax, **fwd_kw)
        return _anatomy_step(ax, dev, masked, shapes, local_shapes,
                             step_specs, replicated, shard_params,
                             full_leaves, forward, codec, update_)

    def with_grad(run):
        return _with_grad(run, lambda leaves: [
            w for w, rep in zip(leaves, replicated)
            if not (rep and shard_params)])

    run = _runner(dev)
    train = _entry(with_grad(run), "train", dev, ax, masked, local_shapes,
                   body_of)
    eager = _entry(with_grad(_eager(dev)), "train", dev, ax, masked,
                   local_shapes, body_of)

    def step(params, tokens, labels, mask=None):
        return params, train(params, tokens, labels, mask)

    def step_local(params, *block):
        return params, train.local(params, *block)

    def step_eager(params, tokens, labels, mask=None):
        return params, eager(params, tokens, labels, mask)

    step.eager, step.graphs, step.cut, step.local = \
        step_eager, run.graphs, train.cut, step_local
    step.mesh, step.specs = ax.mesh, step_specs
    return step


def _anatomy_step(ax, dev, masked, shapes, local_shapes, step_specs,
                  replicated, shard_params, full_leaves, forward, codec,
                  update_):
    """``make_train_step(anatomy=True)``'s split step: the plain body's
    calls cut at its phase seams and run eagerly — ``full_leaves``
    (``zero_gather``, under shard_params), the upload, ``forward`` and
    autograd with the reported loss (``grad``), the explicit sum of the
    local gradients over ``(data, seq)`` through ``qcomm.quantized_psum``
    (``collective``), ``update_`` of the summed gradients (``update``) —
    with ``torch.cuda.synchronize()`` and a host stamp at each seam."""
    from znicz_tpu_torch.observe.anatomy import TRAIN_PHASES, StepAnatomy

    anat = StepAnatomy("transformer", TRAIN_PHASES)
    # the MFU numerator: ~6 FLOPs per matmul weight per token for one
    # train step (2 forward + 4 backward), the embedding lookup excluded;
    # the global token count is known at the first call
    matmul_params = sum(int(np.prod(s)) for s in _leaves(shapes)
                        if len(s) >= 2) - int(np.prod(shapes["emb"]))
    state = {"flops_set": False}
    marked_of = [not (rep and shard_params) for rep in replicated]
    cut = _cutter(ax)

    def seam(phase):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        anat.stamp(phase)

    def local(params, *block):
        leaves = _check_params(params, dev, local_shapes)
        if not state["flops_set"]:
            tokens = int(block[0].numel()) * ax.n_shards
            anat.set_flops(6.0 * matmul_params * tokens)
            state["flops_set"] = True
        anat.begin()
        marked = [w for w, m in zip(leaves, marked_of) if m]
        for w in marked:
            w.requires_grad_(True)
        try:
            full = full_leaves(leaves)
            if shard_params:
                seam("zero_gather")
            local_loss = forward(params, full, *(t.to(dev) for t in block))
            grads = torch.autograd.grad(local_loss, full)
        finally:
            for w in marked:
                w.requires_grad_(False)
        with torch.no_grad():
            loss = _reduced(local_loss, ax)
            seam("grad")
            grads, _ = qcomm.quantized_psum(list(grads), ax.ds, codec)
            seam("collective")
            update_(leaves, grads, summed=True)
            seam("update")
        anat.finish()
        return params, loss

    def step(params, tokens, labels, mask=None):
        return local(params, *cut(*_batch(masked, tokens, labels, mask)))

    step.eager, step.graphs, step.cut, step.local = step, None, cut, local
    step.mesh, step.specs, step.anatomy = ax.mesh, step_specs, anat
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
    weights, as the reference's has none), on this rank of ``mesh`` in
    the replicated layout (``eval_loss.specs``); the global minibatch
    in, the global loss out (``.cut`` / ``.local`` as the train
    step's).  On the card a CUDA graph replay from its second call on
    the same params; ``eval_loss.graphs`` holds the graphs."""
    ax, dev, cdt, heads_local = _setup(
        mesh, d, heads, ff, vocab if head_sharded else None, n_experts,
        compute_dtype, device)
    _check_moe(n_experts, moe_top_k)
    specs = param_specs(n_layers, head_sharded, moe=bool(n_experts))
    shapes = _local_shapes(param_shapes(n_layers, d, ff, vocab,
                                        n_experts=n_experts), specs, ax)

    def body_of(params, _leaves):
        @torch.no_grad()
        def body(tok, lab, m=None):
            return _reduced(_forward_ce(
                params, tok, lab, m, heads_local, causal, cdt, ax,
                loss_chunks=loss_chunks, head_sharded=head_sharded,
                moe_top_k=moe_top_k), ax)
        return body

    run = _runner(dev)
    eval_loss = _entry(run, "eval", dev, ax, masked, shapes, body_of)
    eval_loss.graphs, eval_loss.mesh, eval_loss.specs = \
        run.graphs, ax.mesh, specs
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
    exactly this function.  On a mesh each rank computes its block of
    the global ``tokens`` and the blocks are gathered over ``(data,
    seq)``: every rank returns the whole.  The head is replicated
    (``head_sharded`` has no logits form, as in the reference)."""
    ax, dev, cdt, heads_local = _setup(mesh, d, heads, ff, None, n_experts,
                                       compute_dtype, device)
    _check_moe(n_experts, moe_top_k)
    specs = param_specs(n_layers, False, moe=bool(n_experts))
    shapes = _local_shapes(param_shapes(n_layers, d, ff, vocab,
                                        n_experts=n_experts), specs, ax)

    @torch.no_grad()
    def logits(params, tokens):
        _check_params(params, dev, shapes)
        block = ax.cut(_tensor(tokens)).to(dev)
        x, _aux, ps = _forward_hidden(params, block, heads_local, causal,
                                      cdt, ax, moe_top_k=moe_top_k)
        out = (x @ ps["head"]).float()
        if ax.ds.size == 1:
            return out
        nd, ns = ax.data.size, ax.seq.size
        b_l, t_l, v = out.shape
        every = ax.ds.all_gather(out).view(nd, ns, b_l, t_l, v)
        return every.permute(0, 2, 1, 3, 4).reshape(nd * b_l, ns * t_l, v)

    logits.mesh, logits.specs = ax.mesh, specs
    return logits


# -- the (data, pipe, expert) configuration ----------------------------------
def init_moe_pipeline_params(gen, n_stages: int, d: int, ff: int,
                             n_experts: int) -> dict:
    """Stage-stacked MoE-block params (leading dim the pipe stage), numpy
    f32 from ``gen`` — draw for draw the reference's."""
    def w(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[-2])
        return gen.normal(0.0, scale, shape).astype(np.float32)

    return {
        "gate": w((n_stages, d, n_experts)),
        "w1": w((n_stages, n_experts, d, ff)),
        "b1": np.zeros((n_stages, n_experts, ff), np.float32),
        "w2": w((n_stages, n_experts, ff, d)),
        "b2": np.zeros((n_stages, n_experts, d), np.float32),
    }


def moe_pipeline_specs() -> dict:
    """Every leaf sharded over ``pipe`` on the stage dim and over
    ``expert`` on the expert dim; ``gate`` over ``pipe`` only."""
    return {k: ("pipe", "expert") if k != "gate" else ("pipe",)
            for k in ("gate", "w1", "b1", "w2", "b2")}


def moe_stage(p, x, expert=None):
    """One pipeline stage on its block of the stage-stacked params: the
    MoE residual block ``x + moe_ffn(x)`` (tanh GELU, top-1, this rank's
    experts of the ``expert`` handle; None: every expert)."""
    y, _ = moe_ffn(x, p["gate"][0], p["w1"][0], p["b1"][0], p["w2"][0],
                   p["b2"][0], _GELU, expert)
    return x + y


def make_pipeline_step(mesh, n_experts: int, lr: float = 0.05,
                       compute_dtype=None, device=None):
    """-> ``step(params, xs, ys) -> (params, loss)`` on this rank of a
    ``(data, pipe, expert)`` mesh (None: one device, no group): each pipe
    stage is an expert-parallel MoE residual block (:func:`moe_stage`,
    experts sharded over ``expert``); ``xs`` and ``ys`` are the GLOBAL
    ``(n_micro, mb, d)`` microbatches and their regression targets
    (numpy or tensors), of which the step takes this rank's ``mb`` rows
    of ``data``.  ``params``: this rank's f32 blocks
    in the layout ``step.specs`` (:func:`moe_pipeline_specs`, placed by
    :func:`params_from_numpy`); sizes flow from them.  The loss is the
    MSE summed over ``data``; the update, in place, is the reference's
    ``w - lr·g / n_data`` (each rank differentiates its local term:
    ``w -= lr·g``), so each rank keeps its own copy of a leaf it
    shares, and the reported loss is the first rank's.  The forward casts
    the masters to ``compute_dtype`` (default: bf16 on cuda, f32 on
    cpu).  On the card the step is a CUDA graph replay from its second
    call on the same params (``step.graphs``); a CUDA step needs an NCCL
    world."""
    mesh = _as_mesh(mesh)
    data, pipe = mesh.axis("data"), mesh.axis("pipe")
    expert, first = mesh.axis("expert"), mesh.axis(("pipe", "expert"))
    if n_experts % expert.size:
        raise ValueError(f"expert-axis size {expert.size} must divide "
                         f"n_experts={n_experts}")
    _mesh.check_backend(mesh, torch.device(device or "cuda"))
    dev = _device(device)
    cdt = _default_compute_dtype(compute_dtype, dev)

    stage_fn = functools.partial(moe_stage, expert=expert)

    def body_of(params, leaves):
        def body(xs, ys):
            ps = _map(lambda w: w.to(cdt), params)
            out = pipeline_apply(stage_fn, ps, xs.to(cdt), pipe)
            diff = out.float() - ys
            local = (diff * diff).mean()
            grads = torch.autograd.grad(local, leaves)
            with torch.no_grad():
                loss = data.all_reduce_(local.detach().clone()) / data.size
                if first.group is not None and first.size > 1:
                    loss = first.all_reduce_(
                        loss if first.index == 0 else torch.zeros_like(loss))
                for w, g in zip(leaves, grads):
                    w.sub_(lr * g)
            return loss
        return body

    def rows(a):
        """This rank's rows of ``data`` of global microbatches."""
        a = torch.as_tensor(a, dtype=torch.float32)
        if a.shape[1] % data.size:
            raise ValueError(f"microbatch of {a.shape[1]} not divisible "
                             f"by data={data.size}")
        n = a.shape[1] // data.size
        return a[:, data.index * n:(data.index + 1) * n]

    runner = _runner(dev)
    run = _with_grad(runner)

    def step(params, xs, ys):
        leaves = _leaves(params)
        for w in leaves:
            if w.device.type != dev.type or w.dtype != torch.float32:
                raise ValueError(
                    f"params must be float32 tensors on {dev} (see "
                    f"params_from_numpy); got {w.dtype} on {w.device}")
        return params, run("pipe", leaves, body_of(params, leaves),
                           (rows(xs), rows(ys)))

    step.graphs, step.specs = runner.graphs, moe_pipeline_specs()
    return step
