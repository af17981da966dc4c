"""The port's single-device transformer trainer against the JAX
reference, on the CPU in f32 at a small size (2 layers, d 128, 2 heads
so head_dim 64, ff 256, vocab 64, batch 2, t 128).

The same seeded numpy weights and tokens go through the JAX
``make_train_step`` on a 1x1x1 mesh with
``root.common.engine.pallas_interpret=True`` (so its blocks run the
Pallas flash kernels in interpret mode) and through the port's
``make_train_step(..., device="cpu")`` (whose blocks run the flash
kernels' plain versions).  Per-step losses over 3 steps are held within
rtol 1e-4 / atol 1e-5, the reference's own flash-vs-dense band
(tests/test_transformer_spmd.py), over ``loss_chunks`` None and 4,
masked and unmasked, and ``remat``.  Also the eval loss and logits
oracle, KV decode against the port's own oracle (the analogue of
tests/test_generate.py's pin), bf16 against f32, and the options the
slice refuses."""

import numpy as np
import pytest
import torch

from znicz_tpu.core.config import root as jax_root
from znicz_tpu.parallel import transformer as jtfm
from znicz_tpu.parallel.mesh import make_mesh

from znicz_tpu_torch.parallel import transformer as tfm
from znicz_tpu_torch.serve.kvcache import KVDecoder, TokenSampler

N_LAYERS, D, HEADS, FF, VOCAB = 2, 128, 2, 256, 64
B, T, LR, STEPS = 2, 128, 0.1, 3
#: per-step losses: the reference's flash-vs-dense band
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
#: params after 3 steps: both sides f32 and differ in summation order
#: (matmul blocking, softmax and CE reductions); gradients of order
#: 1e-2..1 times lr 0.1 over 3 steps leave differences ~1e-7
PARAM_ATOL = 1e-5
#: logits of the eval oracle, port vs reference, f32
LOGIT_BAND = 1e-4


@pytest.fixture(scope="module")
def params():
    return tfm.init_params(np.random.default_rng(17), N_LAYERS, D, HEADS,
                           FF, VOCAB)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(23)
    tokens = rng.integers(0, VOCAB, (B, T)).astype(np.int32)
    labels = ((tokens + 1) % VOCAB).astype(np.int32)
    return tokens, labels, np.array([True, False])


@pytest.fixture
def interpret():
    """The JAX side runs its Pallas flash kernels in interpret mode."""
    jax_root.common.engine.pallas_interpret = True
    try:
        yield
    finally:
        jax_root.common.engine.pallas_interpret = False


def _copy(params):
    return {"emb": params["emb"].copy(), "head": params["head"].copy(),
            "blocks": [{k: a.copy() for k, a in blk.items()}
                       for blk in params["blocks"]]}


def _mesh():
    return make_mesh({"data": 1, "seq": 1, "model": 1})


def _flat(params):
    return [np.asarray(params["emb"]), np.asarray(params["head"])] + [
        np.asarray(blk[k]) for blk in params["blocks"] for k in sorted(blk)]


@pytest.mark.parametrize("loss_chunks,masked,remat", [
    (None, False, False), (4, False, False), (None, True, False),
    (4, True, False), (4, False, True)])
def test_train_step_matches_jax(params, batch, interpret, loss_chunks,
                                masked, remat):
    tokens, labels, mask = batch
    args = (tokens, labels) + ((mask,) if masked else ())
    jstep, _ = jtfm.make_train_step(_mesh(), N_LAYERS, D, HEADS, FF, VOCAB,
                                    lr=LR, masked=masked, remat=remat,
                                    loss_chunks=loss_chunks)
    step = tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB, lr=LR,
                               masked=masked, remat=remat,
                               loss_chunks=loss_chunks, device="cpu")
    jp = _copy(params)
    tp = tfm.params_from_numpy(params, "cpu")
    jl, tl = [], []
    for _ in range(STEPS):
        jp, jloss = jstep(jp, *args)
        tp, tloss = step(tp, *args)
        jl.append(float(jloss))
        tl.append(float(tloss))
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for got, want in zip(_flat(tfm.params_to_numpy(tp)), _flat(jp)):
        np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_ATOL)
    assert all(w.dtype == torch.float32 and not w.requires_grad
               for w in tfm._leaves(tp))


@pytest.mark.parametrize("masked", [False, True])
def test_eval_loss_and_logits_match_jax(params, batch, interpret, masked):
    """3 CE chunks of 86 tokens over 256: the last chunk carries 2
    padded rows that must weigh 0."""
    tokens, labels, mask = batch
    args = (tokens, labels) + ((mask,) if masked else ())
    jeval = jtfm.make_eval_loss(_mesh(), N_LAYERS, D, HEADS, FF, VOCAB,
                                masked=masked, loss_chunks=3)
    teval = tfm.make_eval_loss(None, N_LAYERS, D, HEADS, FF, VOCAB,
                               masked=masked, loss_chunks=3, device="cpu")
    tp = tfm.params_from_numpy(params, "cpu")
    np.testing.assert_allclose(float(teval(tp, *args)),
                               float(jeval(params, *args)),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    jlogits = jtfm.make_logits_fn(_mesh(), N_LAYERS, D, HEADS, FF, VOCAB)
    tlogits = tfm.make_logits_fn(None, N_LAYERS, D, HEADS, FF, VOCAB,
                                 device="cpu")
    got = tlogits(tp, tokens)
    assert got.shape == (B, T, VOCAB) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jlogits(params, tokens)),
                               rtol=LOGIT_BAND, atol=LOGIT_BAND)


def test_kv_decode_equals_logits_oracle(params):
    """Greedy KV-cache decode reproduces full forward passes through
    the port's training forward token for token, with logits within
    2e-5 (tests/test_generate.py's pin, port against port)."""
    oracle = tfm.make_logits_fn(None, N_LAYERS, D, HEADS, FF, VOCAB,
                                device="cpu")
    tp = tfm.params_from_numpy(params, "cpu")
    prompt, n_new = [5, 7, 1, 30, 12, 63, 0], 12
    toks, want_tokens, want_logits = list(prompt), [], []
    for _ in range(n_new):
        lg = oracle(tp, np.asarray([toks]))[0, -1].numpy()
        want_tokens.append(int(np.argmax(lg)))
        want_logits.append(lg)
        toks.append(want_tokens[-1])
    dec = KVDecoder(params, heads=HEADS, max_len=32, device="cpu")
    kv, logits = dec.prefill(prompt, bucket=dec.bucket_for(len(prompt)
                                                           + n_new))
    got_tokens, pos = [], len(prompt)
    for i in range(n_new):
        np.testing.assert_allclose(logits, want_logits[i], rtol=2e-5,
                                   atol=2e-5)
        got_tokens.append(int(np.argmax(logits)))
        if i + 1 < n_new:
            kv, step_logits = dec.decode(kv, [pos], [got_tokens[-1]])
            logits = step_logits[0]
            pos += 1
    assert got_tokens == want_tokens
    assert dec.generate(prompt, n_new, TokenSampler(temperature=0.0)) == \
        want_tokens


def test_bf16_compute_tracks_f32(params, batch):
    """bf16 compute with f32 masters trains the same function: losses
    within 2e-2 of the f32 run (the reference's band), masters stay
    f32."""
    tokens, labels, _ = batch
    losses = {}
    for name, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        step = tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                                   lr=LR, compute_dtype=cdt, loss_chunks=4,
                                   device="cpu")
        tp = tfm.params_from_numpy(params, "cpu")
        run = []
        for _ in range(STEPS):
            tp, loss = step(tp, tokens, labels)
            run.append(float(loss))
        losses[name] = run
        assert all(w.dtype == torch.float32 for w in tfm._leaves(tp))
    np.testing.assert_allclose(losses["bf16"], losses["f32"], rtol=2e-2)


def test_params_numpy_round_trip_and_shapes(params, batch):
    back = tfm.params_to_numpy(tfm.params_from_numpy(params, "cpu"))
    for got, want in zip(_flat(back), _flat(params)):
        np.testing.assert_array_equal(got, want)
    # the in-place update never writes through to the numpy source
    before = _flat(_copy(params))
    step = tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                               device="cpu")
    step(tfm.params_from_numpy(params, "cpu"), *batch[:2])
    for got, want in zip(_flat(params), before):
        np.testing.assert_array_equal(got, want)
    shapes = tfm.param_shapes(N_LAYERS, D, FF, VOCAB)
    assert shapes["emb"] == params["emb"].shape
    assert shapes["head"] == params["head"].shape
    for blk_shapes, blk in zip(shapes["blocks"], params["blocks"]):
        assert blk_shapes == {k: a.shape for k, a in blk.items()}
    assert shapes == jtfm.param_shapes(N_LAYERS, D, FF, VOCAB)


@pytest.mark.parametrize("option,item", [
    ({"shard_update": True}, 10), ({"shard_params": True}, 10),
    ({"head_sharded": True}, 10),
    ({"quantized_collectives": {"mode": "int8"}}, 10),
    ({"anatomy": True}, 14)])
def test_unported_options_raise(option, item):
    """``anatomy`` raises naming its ROADMAP item; the layout and
    collective options the reference serves on wide meshes (item 10)
    build since the (data, seq, model) mesh, here on a mesh of one
    (their parity with the JAX step on wide meshes:
    tests/test_torch_port_lm_axes.py)."""
    if item == 14:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue A "
                                                      f"item {item}"):
            tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                                device="cpu", **option)
        return
    step = tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                               device="cpu", **option)
    assert callable(step) and step.mesh.size == 1


@pytest.mark.parametrize("option", [
    {"moe_aux_weight": 0.01}, {"moe_top_k": 2}, {"moe_zloss_weight": 1e-3},
    {"n_experts": 4, "moe_top_k": 5}, {"remat_policy": "everything"}])
def test_invalid_moe_and_remat_options_raise(option):
    """MoE options without ``n_experts`` would train a dense model
    silently, ``moe_top_k`` must pick among the experts, and an unknown
    remat policy has no meaning: each is a ``ValueError``."""
    with pytest.raises(ValueError):
        tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                            device="cpu", **option)


@pytest.mark.parametrize("build", [tfm.make_train_step, tfm.make_eval_loss,
                                   tfm.make_logits_fn])
def test_wide_mesh_raises_and_unit_mesh_builds(build):
    """A mesh wider than the world raises (one process a device: a mesh
    of 2 needs a world of 2), on the pipeline's axes too, and a unit
    mesh builds."""
    for wide in ({"data": 2, "seq": 1, "model": 1}, {"data": 1, "pipe": 2}):
        with pytest.raises(ValueError, match="world of 1"):
            build(wide, N_LAYERS, D, HEADS, FF, VOCAB, device="cpu")
    assert callable(build({"data": 1, "seq": 1, "model": 1}, N_LAYERS, D,
                          HEADS, FF, VOCAB, device="cpu"))
    assert callable(build(_mesh(), N_LAYERS, D, HEADS, FF, VOCAB,
                          device="cpu"))


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """Without ``device`` the step is built for cuda; on a host without
    one that raises instead of quietly training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB)


def test_step_rejects_bad_calls(params, batch):
    tokens, labels, mask = batch
    step = tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                               device="cpu")
    tp = tfm.params_from_numpy(params, "cpu")
    with pytest.raises(ValueError, match="mask"):
        step(tp, tokens, labels, mask)
    with pytest.raises(ValueError, match="float32"):
        step(tfm.params_from_numpy(params, "cpu", torch.bfloat16), tokens,
             labels)
    with pytest.raises(ValueError, match="divide"):
        tfm.make_train_step(None, N_LAYERS, D, 3, FF, VOCAB, device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        tfm.make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                            compute_dtype=torch.float16, device="cpu")
