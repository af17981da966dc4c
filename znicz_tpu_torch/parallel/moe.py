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
- :func:`moe_ffn_dispatch`, the token-sharded all-to-all regime over
  the pipeline step's expert axis, raises until ROADMAP.md queue A item
  10c.
"""

from __future__ import annotations

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


def moe_ffn_dispatch(*_args, **_kwargs):
    """The reference's token-dispatch regime (tokens sharded over the
    expert axis, two all-to-all exchanges), the pipeline step's.  Not
    ported yet."""
    raise NotImplementedError(
        "moe_ffn_dispatch (tokens sharded over the expert axis) is not "
        "ported yet (ROADMAP.md queue A item 10c, the pipeline step and "
        "the expert axis); use moe_ffn, experts sharded over model")
