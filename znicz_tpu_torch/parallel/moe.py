"""Mixture-of-experts FFN — the port of ``znicz_tpu/parallel/moe.py``.

- :func:`moe_ffn` is the reference's dense-masked regime: every expert
  of this rank runs over every token, each token's output is its
  experts' outputs weighted by their gates, and the ranks' partial
  outputs are summed over the axis (``tp.psum``, the reference's
  ``psum`` with its transpose).  The transformer step passes the
  ``model`` axis, over which the experts are sharded ``E/tp`` a rank;
  with no axis (or a line of one) every expert is local.  It keeps
  top-1 switch routing and top-k ≥ 2 with GShard renormalization.  The
  expert products are batched matmuls (``torch.bmm``), as the
  reference's are XLA einsums outside any Pallas kernel.
- :func:`router_z_loss` and :func:`load_balance_aux` are the two
  regularizers, in f32 whatever the compute dtype.
- :func:`moe_ffn_dispatch` is the token-sharded regime: each rank
  holds its own tokens and ``E_local`` experts, and every routed token
  travels to its expert's rank and back through two all-to-alls
  (``DataMesh.all_to_all``, each an autograd Function whose backward is
  the inverse exchange).  The reference forms the buckets and the
  combine as one-hot einsums over ``(tokens, E, capacity)``; the port
  indexes the same slots (:func:`bucket_slots`: a copy into the
  buckets, a gather back), which gives the same values without the
  ``tokens × E × capacity`` masks.
"""

from __future__ import annotations

import math

import torch

from znicz_tpu_torch.parallel import tp


def moe_ffn(x, gate_w, w1, b1, w2, b2, act, axis=None, top_k: int = 1):
    """``x`` ``(tokens, d)`` replicated over ``axis``; ``gate_w`` ``(d,
    E)`` replicated; ``w1`` ``(E_local, d, ff)``, ``b1`` ``(E_local,
    ff)``, ``w2`` ``(E_local, ff, d)``, ``b2`` ``(E_local, d)``: this
    rank's experts, ``axis.index * E_local`` onwards.  Returns ``(y
    (tokens, d), gate_probs (tokens, E))``, both replicated.

    ``top_k=1`` is switch routing (the winner scaled by its raw softmax
    prob); ``top_k≥2`` is GShard-style: the k winners' probs are
    RENORMALIZED to sum to 1 and their expert outputs combine
    weighted."""
    e_local = w1.shape[0]
    scores = x @ gate_w                            # (tokens, E)
    gate_probs = torch.softmax(scores, dim=-1)
    choice_k = torch.topk(scores, top_k, dim=-1).indices   # (tokens, k)
    gate_k = gate_probs.gather(1, choice_k)        # (tokens, k)
    if top_k > 1:
        gate_k = gate_k / gate_k.sum(dim=-1, keepdim=True)
    first = axis.index * e_local if axis is not None else 0
    ids = first + torch.arange(e_local, device=x.device)
    # (E_local, tokens): each local expert's combined gate weight per
    # token (0 when the token routed elsewhere)
    sel = choice_k[None, :, :] == ids[:, None, None]       # (E_l, t, k)
    wgt = (sel.to(x.dtype) * gate_k[None, :, :]).sum(-1)
    xe = x.expand(e_local, *x.shape)               # (E_l, t, d), no copy
    h = act(torch.bmm(xe, w1) + b1[:, None, :])    # (E_l, t, ff)
    y_e = torch.bmm(h, w2) + b2[:, None, :]        # (E_l, t, d)
    return tp.psum((y_e * wgt[:, :, None]).sum(dim=0), axis), gate_probs


def router_z_loss(scores):
    """ST-MoE router z-loss (arXiv:2202.08906 eq. 5): mean of
    ``logsumexp(scores)²`` — penalizes large router logits.  f32
    regardless of the compute dtype."""
    z = torch.logsumexp(scores.float(), dim=-1)
    return (z * z).mean()


def load_balance_aux(gate_probs):
    """Switch-transformer load-balance auxiliary (arXiv:2101.03961
    eq. 4): ``E · Σ_e f_e·P_e`` with ``f`` the top-1 routed fraction
    (argmax-derived — gradients flow through the mean gate prob ``P``
    only) — minimized (=1) at uniform routing.  f32 regardless of the
    compute dtype."""
    n_exp = gate_probs.shape[-1]
    pf = gate_probs.float()
    f = torch.nn.functional.one_hot(pf.argmax(-1), n_exp).float().mean(0)
    return n_exp * (f * pf.mean(dim=0)).sum()


class _AllToAll(torch.autograd.Function):
    """``axis.all_to_all``; its backward the inverse exchange (the same
    swap of the leading dim)."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return axis.all_to_all(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_to_all(g.contiguous()), None


def _all_to_all(t, axis):
    if axis is None or axis.group is None:
        return t
    return _AllToAll.apply(t, axis)


def bucket_slots(choice, n_experts: int, capacity: int):
    """The bucket slot of every (token, choice) pair, token-major with
    the k choices inner (``choice`` ``(tokens, k)``): expert ``e``'s
    pairs take positions 0, 1, ... in that order, and the pair's slot is
    ``e · capacity + position``.  -> ``(slot (tokens·k,), keep
    (tokens·k,) bool)``: a pair past its expert's capacity is dropped
    and its slot is ``n_experts · capacity`` (one spare slot past the
    buckets)."""
    cf = choice.reshape(-1)
    experts = torch.arange(n_experts, device=cf.device)
    onehot = (cf[:, None] == experts).to(torch.int64)      # (t·k, E)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    keep = pos < capacity
    spare = torch.full_like(cf, n_experts * capacity)
    return torch.where(keep, cf * capacity + pos, spare), keep


def moe_ffn_dispatch(x, gate_w, w1, b1, w2, b2, act, axis=None,
                     capacity_factor: float = 2.0, top_k: int = 1):
    """Token-dispatch MoE FFN for the TOKEN-SHARDED regime: ``x``
    ``(tokens_local, d)`` is this rank's tokens on the ``axis`` line (the
    ``expert`` handle; None, or a line of one: every expert local), and
    ``w1`` ``(E_local, d, ff)``, ``b1``, ``w2``, ``b2`` its experts,
    ``axis.index · E_local`` onwards.  Each (token, choice) pair takes a
    slot of its expert's bucket (``capacity = ceil(capacity_factor ·
    tokens_local · top_k / E)`` slots a source rank, token-major); a
    pair past its expert's capacity is dropped and adds nothing (size
    ``capacity_factor`` ≥ ``E / top_k`` for lossless routing).  The
    buckets travel to their experts' ranks and back through two
    all-to-alls; gradients flow through both to ``x``, the gate and the
    owning expert's weights.  ``top_k ≥ 2`` combines the k experts with
    GShard-renormalized weights, as :func:`moe_ffn`.  Returns ``(y
    (tokens_local, d), gate_probs)``, both sharded like ``x``."""
    n_dev = 1 if axis is None else axis.size
    tokens, d = x.shape
    e_local = w1.shape[0]
    n_experts = n_dev * e_local
    scores = x @ gate_w                            # (t, E)
    gate_probs = torch.softmax(scores, dim=-1)
    choice_k = torch.topk(scores, top_k, dim=-1).indices   # (t, k)
    gate_k = gate_probs.gather(1, choice_k)        # (t, k)
    if top_k > 1:
        gate_k = gate_k / gate_k.sum(dim=-1, keepdim=True)
    capacity = int(math.ceil(capacity_factor * tokens * top_k / n_experts))
    slot, _keep = bucket_slots(choice_k, n_experts, capacity)
    # the buckets, one spare slot past them taking the dropped pairs
    src = x.repeat_interleave(top_k, dim=0) if top_k > 1 else x
    disp = x.new_zeros(n_experts * capacity + 1, d).index_copy(0, slot, src)
    disp = disp[:-1].reshape(n_dev, e_local, capacity, d)
    recv = _all_to_all(disp, axis)                 # my experts' buckets
    xin = recv.transpose(0, 1).reshape(e_local, n_dev * capacity, d)
    h = act(torch.bmm(xin, w1) + b1[:, None, :])
    y = torch.bmm(h, w2) + b2[:, None, :]
    y = y.reshape(e_local, n_dev, capacity, d).transpose(0, 1)
    back = _all_to_all(y.contiguous(), axis)       # my tokens' results
    res = torch.cat([back.reshape(n_experts * capacity, d),
                     back.new_zeros(1, d)])
    picked = res.index_select(0, slot).reshape(tokens, top_k, d)
    return (picked * gate_k[:, :, None]).sum(1), gate_probs
