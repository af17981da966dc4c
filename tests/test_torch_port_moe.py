"""The port's MoE blocks and remat policies against the JAX reference, on
the CPU in f32 at a small size (2 layers, d 64, 2 heads, ff 128, vocab
32, 4 experts, batch 2, t 64).

- ``parallel/moe.py``: ``moe_ffn`` (top-1 switch routing and top-2
  GShard renormalization), ``load_balance_aux`` and ``router_z_loss``
  within 1e-5 of the reference's, which runs under its own one-device
  mesh (``shard_map`` over ``model``, whose ``psum`` is the identity
  there); ``moe_ffn_dispatch`` on one rank within 1e-5 of ``moe_ffn``,
  values and gradients, at a lossless capacity, and its drops at one
  slot an expert (its all-to-all worlds against the JAX dispatch:
  ``tests/test_torch_port_pipe_expert.py``).
- ``make_train_step`` with ``n_experts=4``, ``moe_top_k`` 1 and 2, aux
  0.01 and z-loss 1e-3: losses within rtol 1e-4 / atol 1e-5 and params
  within 1e-5 over 3 steps (the bands of tests/test_torch_port_train.py,
  the reference's flash-vs-dense band), masked and unmasked; the eval
  loss and the logits oracle too.
- Each ``remat_policy`` (and ``remat``): the port within 1e-6 of its own
  step without remat, and within the train step's band of JAX under the
  same policy, dense and MoE; each policy keeps the products it names
  and recomputes the rest (counted in the backward).
- The CPU rehearsal of the CUDA graph capture: after its first call a
  train or eval body (dense, MoE, remat, chunked CE) makes no tensor
  from host data and reads nothing back.

The JAX side runs its Pallas flash kernel in interpret mode where the
head dim allows it, as tests/test_torch_port_train.py does."""

import functools

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from znicz_tpu.core.config import root as jax_root
from znicz_tpu.parallel import moe as jmoe
from znicz_tpu.parallel import transformer as jtfm
from znicz_tpu.parallel.compat import shard_map
from znicz_tpu.parallel.mesh import make_mesh
from jax.sharding import PartitionSpec as P

from znicz_tpu_torch.parallel import moe as tmoe
from znicz_tpu_torch.parallel import transformer as tfm

N_LAYERS, D, HEADS, FF, VOCAB, E = 2, 64, 2, 128, 32, 4
B, T, LR, STEPS = 2, 64, 0.1, 3
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-4, 1e-5, 1e-5
#: moe_ffn and its regularizers, port vs reference, f32
MOE_BAND = 1e-5
#: a remat policy against no remat in the port: the same ops recomputed
#: on the same inputs (bit-equal on the CPU; 1e-6 leaves room for a
#: reordered sum)
REMAT_BAND = 1e-6
MOE_KW = {"n_experts": E, "moe_aux_weight": 0.01, "moe_zloss_weight": 1e-3}


@pytest.fixture(scope="module")
def moe_params():
    return tfm.init_params(np.random.default_rng(31), N_LAYERS, D, HEADS,
                           FF, VOCAB, n_experts=E)


@pytest.fixture(scope="module")
def dense_params():
    return tfm.init_params(np.random.default_rng(32), N_LAYERS, D, HEADS,
                           FF, VOCAB)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(37)
    tokens = rng.integers(0, VOCAB, (B, T)).astype(np.int32)
    labels = ((tokens * 3 + 1) % VOCAB).astype(np.int32)
    return tokens, labels, np.array([True, False])


@pytest.fixture
def interpret():
    jax_root.common.engine.pallas_interpret = True
    try:
        yield
    finally:
        jax_root.common.engine.pallas_interpret = False


def _mesh():
    return make_mesh({"data": 1, "seq": 1, "model": 1})


def _copy(params):
    return {"emb": params["emb"].copy(), "head": params["head"].copy(),
            "blocks": [{k: a.copy() for k, a in blk.items()}
                       for blk in params["blocks"]]}


def _flat(params):
    return [np.asarray(params["emb"]), np.asarray(params["head"])] + [
        np.asarray(blk[k]) for blk in params["blocks"] for k in sorted(blk)]


def _jax_moe(x, blk, top_k):
    """The reference's moe_ffn and regularizers under its one-device
    mesh."""
    def local(x, g, w1, b1, w2, b2):
        y, probs = jmoe.moe_ffn(x, g, w1, b1, w2, b2, jax.nn.gelu,
                                axis_name="model", top_k=top_k)
        return (y, probs, jmoe.load_balance_aux(probs),
                jmoe.router_z_loss(x @ g))
    fn = shard_map(local, mesh=_mesh(), in_specs=(P(),) * 6,
                   out_specs=(P(),) * 4)
    return [np.asarray(a) for a in jax.jit(fn)(
        x, blk["gate"], blk["ew1"], blk["eb1"], blk["ew2"], blk["eb2"])]


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_and_regularizers_match_jax(moe_params, top_k):
    x = np.random.default_rng(41).normal(0, 1, (B * T, D)).astype(
        np.float32)
    blk = moe_params["blocks"][0]
    want = _jax_moe(x, blk, top_k)
    t = {k: torch.tensor(a) for k, a in blk.items()}
    xt = torch.tensor(x)
    y, probs = tmoe.moe_ffn(xt, t["gate"], t["ew1"], t["eb1"], t["ew2"],
                            t["eb2"], tfm._GELU, top_k=top_k)
    got = [y, probs, tmoe.load_balance_aux(probs),
           tmoe.router_z_loss(xt @ t["gate"])]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=MOE_BAND,
                                   atol=MOE_BAND)
    # every token reached its top_k experts, each output nonzero
    assert float(got[2]) >= 1.0 - MOE_BAND      # the aux's minimum is 1


def test_regularizers_are_f32_for_bf16_inputs():
    scores = torch.randn(16, E, generator=torch.Generator().manual_seed(3))
    z = tmoe.router_z_loss(scores.bfloat16())
    aux = tmoe.load_balance_aux(torch.softmax(scores, -1).bfloat16())
    assert z.dtype == aux.dtype == torch.float32


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_dispatch_matches_moe_ffn_on_one_rank(top_k):
    """With every expert local and a lossless capacity (``E / top_k``)
    the token dispatch computes the dense-masked FFN, values and
    gradients (its all-to-all worlds: tests/test_torch_port_pipe_expert.py);
    at capacity 1 a bucket holds one pair and later pairs add nothing."""
    gen = torch.Generator().manual_seed(top_k)
    x, gate = torch.randn(32, 8, generator=gen), torch.randn(8, E,
                                                             generator=gen)
    w1, w2 = (0.3 * torch.randn(E, a, b, generator=gen)
              for a, b in ((8, 16), (16, 8)))
    b1, b2 = torch.randn(E, 16, generator=gen), torch.randn(E, 8,
                                                            generator=gen)
    args = [t.requires_grad_(True) for t in (x, gate, w1, b1, w2, b2)]
    outs = {}
    for name, fn in (("dense", tmoe.moe_ffn), ("dispatch", functools.partial(
            tmoe.moe_ffn_dispatch, capacity_factor=E / top_k))):
        y, probs = fn(*args, tfm._GELU, None, top_k=top_k)
        outs[name] = (y, probs) + torch.autograd.grad((y * y).sum(), args)
    for a, b in zip(outs["dispatch"], outs["dense"]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=MOE_BAND, atol=MOE_BAND)
    y, _ = tmoe.moe_ffn_dispatch(*args, tfm._GELU, None,
                                 capacity_factor=E / x.shape[0], top_k=1)
    choice = (x @ gate).argmax(-1).tolist()
    first = [choice.index(e) for e in set(choice)]
    kept = (y.detach().abs().sum(-1) > 0).nonzero().ravel().tolist()
    assert sorted(kept) == sorted(first)


def test_init_params_and_shapes_match_jax_with_experts(moe_params):
    want = jtfm.init_params(np.random.default_rng(31), N_LAYERS, D, HEADS,
                            FF, VOCAB, n_experts=E)
    for got, ref in zip(_flat(moe_params), _flat(want)):
        np.testing.assert_array_equal(got, ref)
    shapes = tfm.param_shapes(N_LAYERS, D, FF, VOCAB, n_experts=E)
    assert shapes == jtfm.param_shapes(N_LAYERS, D, FF, VOCAB, n_experts=E)
    assert shapes["blocks"][0] == {k: a.shape for k, a in
                                   moe_params["blocks"][0].items()}


def _run_steps(make, params, args, **kw):
    step = make(**kw)
    ps = params
    losses = []
    for _ in range(STEPS):
        ps, loss = step(ps, *args)
        losses.append(float(loss))
    return losses, ps


def _jax_run(params, args, masked, **kw):
    return _run_steps(
        lambda **k: jtfm.make_train_step(_mesh(), N_LAYERS, D, HEADS, FF,
                                         VOCAB, lr=LR, masked=masked,
                                         **k)[0],
        _copy(params), args, **kw)


def _port_run(params, args, masked, **kw):
    losses, ps = _run_steps(
        lambda **k: tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                                        lr=LR, masked=masked, device="cpu",
                                        **k),
        tfm.params_from_numpy(params, "cpu"), args, **kw)
    return losses, tfm.params_to_numpy(ps)


def _held(got, want):
    (tl, tp), (jl, jp) = got, want
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for a, b in zip(_flat(tp), _flat(jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("top_k,masked", [(1, False), (2, False),
                                          (2, True)])
def test_moe_train_step_matches_jax(moe_params, batch, interpret, top_k,
                                    masked):
    tokens, labels, mask = batch
    args = (tokens, labels) + ((mask,) if masked else ())
    kw = dict(MOE_KW, moe_top_k=top_k, loss_chunks=4)
    got = _port_run(moe_params, args, masked, **kw)
    assert got[0][-1] < got[0][0]
    _held(got, _jax_run(moe_params, args, masked, **kw))


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_eval_loss_and_logits_match_jax(moe_params, batch, interpret,
                                            top_k):
    """The eval loss carries no regularizer, as the reference's."""
    tokens, labels, mask = batch
    jeval = jtfm.make_eval_loss(_mesh(), N_LAYERS, D, HEADS, FF, VOCAB,
                                masked=True, n_experts=E, moe_top_k=top_k)
    teval = tfm.make_eval_loss(None, N_LAYERS, D, HEADS, FF, VOCAB,
                               masked=True, n_experts=E, moe_top_k=top_k,
                               device="cpu")
    tp = tfm.params_from_numpy(moe_params, "cpu")
    np.testing.assert_allclose(float(teval(tp, tokens, labels, mask)),
                               float(jeval(moe_params, tokens, labels,
                                           mask)),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    jlogits = jtfm.make_logits_fn(_mesh(), N_LAYERS, D, HEADS, FF, VOCAB,
                                  n_experts=E, moe_top_k=top_k)
    tlogits = tfm.make_logits_fn(None, N_LAYERS, D, HEADS, FF, VOCAB,
                                 n_experts=E, moe_top_k=top_k, device="cpu")
    np.testing.assert_allclose(tlogits(tp, tokens).numpy(),
                               np.asarray(jlogits(moe_params, tokens)),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def no_remat(dense_params, moe_params, batch):
    """Each flavor's port run without remat, the runs a policy's are held
    against."""
    args = batch
    return {"dense": _port_run(dense_params, args, True),
            "moe": _port_run(moe_params, args, True,
                             **dict(MOE_KW, moe_top_k=2))}


REMAT_CASES = [("dense", None, True), ("dense", "dots", False),
               ("dense", "dots_no_batch", False), ("dense", "nothing", False),
               ("moe", "dots", False), ("moe", "dots_no_batch", False),
               ("moe", "nothing", False)]


@pytest.mark.parametrize("flavor,policy,remat", REMAT_CASES)
def test_remat_policy_matches_own_step_and_jax(dense_params, moe_params,
                                               batch, no_remat, interpret,
                                               flavor, policy, remat):
    args = batch
    params = moe_params if flavor == "moe" else dense_params
    kw = dict(MOE_KW, moe_top_k=2) if flavor == "moe" else {}
    plain = no_remat[flavor]
    got = _port_run(params, args, True, remat=remat, remat_policy=policy,
                    **kw)
    np.testing.assert_allclose(got[0], plain[0], rtol=REMAT_BAND,
                               atol=REMAT_BAND)
    for a, b in zip(_flat(got[1]), _flat(plain[1])):
        np.testing.assert_allclose(a, b, rtol=0, atol=REMAT_BAND)
    _held(got, _jax_run(params, args, True, remat=remat,
                        remat_policy=policy, **kw))


class _CountProducts(TorchDispatchMode):
    """Counts the aten products a region runs."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(params, batch, policy):
    """The products the backward of one MoE loss runs: its own plus what
    the policy recomputes."""
    tokens, labels, _ = batch
    ps = tfm.params_from_numpy(params, "cpu")
    leaves = tfm._leaves(ps)
    for w in leaves:
        w.requires_grad_(True)
    loss = tfm._forward_ce(ps, torch.as_tensor(tokens).long(),
                           torch.as_tensor(labels).long(), None, HEADS,
                           True, torch.float32, remat_policy=policy,
                           moe_top_k=2)
    with _CountProducts() as counter:
        torch.autograd.grad(loss, leaves)
    return counter.counts


def test_remat_policies_keep_the_products_they_name(moe_params, batch):
    """"dots" keeps every product (the backward recomputes none of the
    forward's), "dots_no_batch" recomputes the experts' batched products
    only, "nothing" recomputes both kinds."""
    counts = {p: _backward_products(moe_params, batch, p)
              for p in (None, "dots", "dots_no_batch", "nothing")}
    assert counts["dots"] == counts[None]
    assert counts["dots_no_batch"]["mm"] == counts[None]["mm"]
    assert counts["dots_no_batch"]["bmm"] > counts[None]["bmm"]
    assert counts["nothing"]["mm"] > counts[None]["mm"]
    assert counts["nothing"]["bmm"] == counts["dots_no_batch"]["bmm"]


class _NoHostTraffic(TorchFunctionMode):
    """Fails on what a CUDA graph capture refuses: a tensor made from
    host data (a host-to-device copy on the card) and a value read back
    to the host (a sync)."""

    MAKERS = {torch.tensor, torch.as_tensor}
    READS = {"item", "__bool__", "__int__", "__float__", "__index__",
             "tolist", "numpy", "cpu"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if (func in self.MAKERS and args and
                not isinstance(args[0], torch.Tensor)) or name in self.READS:
            raise AssertionError(f"{name} inside a captured step body")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("flavor,kw", [
    ("dense", {"loss_chunks": 4}), ("dense", {"remat_policy": "dots"}),
    ("moe", dict(MOE_KW, moe_top_k=2)),
    ("moe", dict(MOE_KW, moe_top_k=1, remat_policy="dots_no_batch",
                 loss_chunks=3))])
def test_lm_bodies_make_no_host_traffic_after_their_first_call(
        dense_params, moe_params, batch, flavor, kw):
    """The CPU rehearsal of the capture: the step's and the eval's bodies
    (``step.eager``, the body a graph captures) run once freely, as the
    first eager call does, then make no tensor from host data and read
    nothing back."""
    params = moe_params if flavor == "moe" else dense_params
    tokens, labels, mask = (torch.as_tensor(a) for a in batch)
    step = tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                               masked=True, device="cpu", **kw)
    evaluate = tfm.make_eval_loss(
        None, N_LAYERS, D, HEADS, FF, VOCAB, masked=True, device="cpu",
        loss_chunks=kw.get("loss_chunks"), n_experts=kw.get("n_experts"),
        moe_top_k=kw.get("moe_top_k", 1))
    ps = tfm.params_from_numpy(params, "cpu")
    for _ in range(2):
        step.eager(ps, tokens, labels, mask)
        evaluate(ps, tokens, labels, mask)
        with _NoHostTraffic():
            step.eager(ps, tokens, labels, mask)
            evaluate(ps, tokens, labels, mask)
    assert step.graphs is None and evaluate.graphs is None   # the CPU


def test_step_returns_losses_later_steps_keep(dense_params, batch):
    """Each call's loss stays as it was returned (the smoke keeps the
    list and reads it later), and params change in place."""
    tokens, labels, _ = batch
    step = tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                               device="cpu")
    ps = tfm.params_from_numpy(dense_params, "cpu")
    emb = ps["emb"]
    losses = [step(ps, tokens, labels)[1] for _ in range(3)]
    values = [float(x) for x in losses]
    assert len(set(values)) == 3 and values[-1] < values[0]
    assert ps["emb"] is emb
    for _ in range(2):
        step(ps, tokens, labels)
    assert [float(x) for x in losses] == values


@pytest.mark.cuda
def test_graphed_steps_equal_eager_and_follow_their_params_on_the_card(
        moe_params, batch):
    """On the card the MoE step (remat "dots_no_batch") replays a graph
    from its second call: bit-identical to its eager body over 4 steps,
    each returned loss kept as it was; a call with other param tensors
    captures anew instead of replaying onto the old ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tokens, labels, mask = batch
    step = tfm.make_train_step(None, N_LAYERS, D, 1, FF, VOCAB, masked=True,
                               device="cuda", remat_policy="dots_no_batch",
                               **dict(MOE_KW, moe_top_k=2))
    graphed = tfm.params_from_numpy(moe_params, "cuda")
    eager = tfm.params_from_numpy(moe_params, "cuda")
    got = [step(graphed, tokens, labels, mask)[1] for _ in range(4)]
    want = [step.eager(eager, tokens, labels, mask)[1] for _ in range(4)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in
               zip(tfm._leaves(graphed), tfm._leaves(eager)))
    (graph,) = [g for g in step.graphs.values() if g is not None]
    assert graph.replays == 3
    fresh = tfm.params_from_numpy(moe_params, "cuda")
    first = [step(fresh, tokens, labels, mask)[1] for _ in range(2)]
    assert torch.equal(first[0], want[0]) and torch.equal(first[1], want[1])
    assert len(step.graphs) == 1                # the old graph dropped
