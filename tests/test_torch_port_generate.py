"""The port's generative serving slice against the JAX reference, on the
CPU at a small size (2 layers, d 64, 4 heads, ff 128, vocab 64, f32).

Seeded numpy weights and prompts go through both packages: prefill and
paged-decode logits are held within 1e-4 of the JAX ``PagedKVDecoder``
with its Pallas flash-decode kernel (interpret mode on the CPU), greedy
tokens must be identical, port paged decode must reproduce port
contiguous decode, LM packages cross both ways, and the CLI serves on
``--device cpu`` but refuses to fall back to the CPU on its own."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from znicz_tpu.parallel.transformer import init_params as jax_init_params
from znicz_tpu.serve.paged import PagedKVDecoder as JaxPagedKVDecoder
from znicz_tpu.utils import export as jax_export

from znicz_tpu_torch.core import backends
from znicz_tpu_torch.observe import flight
from znicz_tpu_torch.parallel.transformer import init_params
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.serve.continuous import ContinuousBatcher
from znicz_tpu_torch.serve.kvcache import KVDecoder
from znicz_tpu_torch.serve.paged import PagedKVDecoder
from znicz_tpu_torch.utils import export as port_export

N_LAYERS, D, HEADS, FF, VOCAB = 2, 64, 4, 128, 64
#: f32 logits, port vs reference: the same math in two frameworks
#: (matmul blocking and softmax order differ at f32 rounding)
BAND = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def params():
    return jax_init_params(np.random.default_rng(5), N_LAYERS, D, HEADS,
                           FF, VOCAB)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).tolist() for n in lens]


def test_init_params_identical_from_one_seed(params):
    ours = init_params(np.random.default_rng(5), N_LAYERS, D, HEADS, FF,
                       VOCAB)
    for key in ("emb", "head"):
        np.testing.assert_array_equal(ours[key], params[key])
    for mine, ref in zip(ours["blocks"], params["blocks"]):
        assert mine.keys() == ref.keys()
        for key in ref:
            np.testing.assert_array_equal(mine[key], ref[key])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_lm_package_crosses_both_ways(params, tmp_path, direction):
    path = str(tmp_path / "lm.npz")
    charmap = [chr(65 + i) for i in range(VOCAB)]
    writer, reader = (jax_export, port_export) if \
        direction == "jax_to_port" else (port_export, jax_export)
    writer.export_lm(params, path, heads=HEADS, charmap=charmap,
                     name="tiny")
    got, meta = reader.load_lm(path)
    assert meta["format"] == port_export.LM_FORMAT == jax_export.LM_FORMAT
    assert (meta["n_layers"], meta["d"], meta["heads"], meta["ff"],
            meta["vocab"], meta["charmap"]) == (N_LAYERS, D, HEADS, FF,
                                                VOCAB, charmap)
    np.testing.assert_array_equal(got["emb"], params["emb"])
    np.testing.assert_array_equal(got["head"], params["head"])
    for mine, ref in zip(got["blocks"], params["blocks"]):
        for key in ref:
            np.testing.assert_array_equal(mine[key], ref[key])


def test_lm_draft_crosses_both_ways(params, tmp_path):
    draft = jax_init_params(np.random.default_rng(6), 1, D, HEADS, FF,
                            VOCAB)
    for writer, reader in ((jax_export, port_export),
                           (port_export, jax_export)):
        path = str(tmp_path / f"{writer.__name__}.npz")
        writer.export_lm(params, path, heads=HEADS, draft_params=draft)
        got, meta = reader.load_lm_draft(path)
        assert (meta["n_layers"], meta["heads"]) == (1, HEADS)
        np.testing.assert_array_equal(got["blocks"][0]["wq"],
                                      draft["blocks"][0]["wq"])
        assert reader.load_lm(path)[1]["draft"] == meta
    port_export.export_lm(params, path, heads=HEADS)
    assert port_export.load_lm_draft(path) == (None, None)


def test_load_lm_refuses_non_lm_package(tmp_path):
    np.savez(str(tmp_path / "fwd.npz"), __arch__=np.array("{}"))
    with pytest.raises(ValueError, match="not an LM package"):
        port_export.load_lm(str(tmp_path / "fwd.npz"))


@pytest.mark.parametrize("n", [1, 5, 13, 30])
def test_prefill_logits_match_jax(params, n):
    jax_dec = JaxPagedKVDecoder(params, heads=HEADS, max_len=32, batch=1,
                                page=8, use_pallas=True)
    ours = KVDecoder(params, heads=HEADS, max_len=32, batch=1,
                     device="cpu")
    prompt = _prompts(n, [n])[0]
    kv_j, want = jax_dec.prefill(prompt)
    kv_t, got = ours.prefill(prompt)
    assert got.shape == (VOCAB,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=BAND, atol=BAND)
    np.testing.assert_allclose(kv_t["k"].numpy(), np.asarray(kv_j["k"]),
                               rtol=BAND, atol=BAND)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_ops_match_reference(causal):
    import jax.numpy as jnp

    from znicz_tpu.ops import attention as jax_attention
    from znicz_tpu_torch.ops import attention

    rng = np.random.default_rng(int(causal))
    q, k, v = (rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
               for _ in range(3))
    want_s = jax_attention.masked_scores(jnp, q, k, causal)
    got_s = attention.masked_scores(*map(torch.from_numpy, (q, k)), causal)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=BAND, atol=BAND)
    want = jax_attention.attention(jnp, q, k, v, causal=causal)
    got = attention.attention(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BAND,
                               atol=BAND)


def _admit(dec, prompt):
    pages = dec.ledger.alloc(dec.pages_for(len(prompt)))
    kv1, logits = dec.prefill(prompt, bucket=dec.bucket_for(len(prompt)))
    dec.adopt_paged(kv1, pages)
    return pages, logits


def test_paged_decode_matches_jax_pallas_decoder(params):
    """16 batched steps for 3 slots through both paged planes — the
    reference with its Pallas kernel (interpret on the CPU), the port
    with the kernel wrapper's plain twin — on one shared page table."""
    kw = dict(heads=HEADS, max_len=64, batch=3, page=8)
    jax_dec = JaxPagedKVDecoder(params, use_pallas=True, **kw)
    ours = PagedKVDecoder(params, device="cpu", **kw)
    assert ours._arena["k"].shape == (N_LAYERS, 3 * 8 + 1, 8, HEADS,
                                      D // HEADS)
    prompts = _prompts(1, [5, 13, 9])
    pages, pos, tok = [], np.zeros(3, np.int32), np.zeros(3, np.int32)
    for i, prompt in enumerate(prompts):
        pj, want = _admit(jax_dec, prompt)
        pt_, got = _admit(ours, prompt)
        assert pj == pt_
        np.testing.assert_allclose(got, want, rtol=BAND, atol=BAND)
        pages.append(pj)
        pos[i], tok[i] = len(prompt), int(np.argmax(want))
    for _ in range(16):
        for i in range(3):
            while len(pages[i]) * 8 < pos[i] + 1:
                new = jax_dec.ledger.alloc(1)
                assert ours.ledger.alloc(1) == new
                pages[i] += new
        pt = np.zeros((3, ours.view_bucket(max(map(len, pages)))),
                      np.int32)
        for i, pg in enumerate(pages):
            pt[i, :len(pg)] = pg
        want = jax_dec.decode_paged(pt, pos, tok)
        got = ours.decode_paged(pt, pos, tok)
        np.testing.assert_allclose(got, want, rtol=BAND, atol=BAND)
        assert (got.argmax(1) == want.argmax(1)).all()
        tok = want.argmax(1).astype(np.int32)
        pos += 1
    assert ours.stats()["decode_steps"] == 16


@pytest.mark.parametrize("heads", [40, 64])
def test_paged_decode_matches_jax_past_32_heads(heads):
    """A one-layer model of 40 and 64 heads (head_dim 4) through both
    paged planes for 4 batched steps: the port's decoder builds and
    serves past one kernel block's 32 heads, as the reference does."""
    params = jax_init_params(np.random.default_rng(heads), 1, 4 * heads,
                             heads, 64, VOCAB)
    kw = dict(heads=heads, max_len=32, batch=2, page=8)
    jax_dec = JaxPagedKVDecoder(params, use_pallas=True, **kw)
    ours = PagedKVDecoder(params, device="cpu", **kw)
    pages, pos, tok = [], np.zeros(2, np.int32), np.zeros(2, np.int32)
    for i, prompt in enumerate(_prompts(heads, [6, 11])):
        pj, want = _admit(jax_dec, prompt)
        pt_, got = _admit(ours, prompt)
        assert pj == pt_
        np.testing.assert_allclose(got, want, rtol=BAND, atol=BAND)
        pages.append(pj)
        pos[i], tok[i] = len(prompt), int(np.argmax(want))
    for _ in range(4):
        for i in range(2):
            while len(pages[i]) * 8 < pos[i] + 1:
                new = jax_dec.ledger.alloc(1)
                assert ours.ledger.alloc(1) == new
                pages[i] += new
        pt = np.zeros((2, ours.view_bucket(max(map(len, pages)))),
                      np.int32)
        for i, pg in enumerate(pages):
            pt[i, :len(pg)] = pg
        want = jax_dec.decode_paged(pt, pos, tok)
        got = ours.decode_paged(pt, pos, tok)
        np.testing.assert_allclose(got, want, rtol=BAND, atol=BAND)
        assert (got.argmax(1) == want.argmax(1)).all()
        tok = want.argmax(1).astype(np.int32)
        pos += 1


def _drive_paged(dec, prompt, n_new, slot=0):
    """Hand-drive one greedy request through the paged plane."""
    pages, logits = _admit(dec, prompt)
    pos, tok = len(prompt), int(np.argmax(logits))
    out = [tok]
    for _ in range(n_new - 1):
        while len(pages) * dec.page < pos + 1:
            pages.extend(dec.ledger.alloc(1))
        pt = np.zeros((dec.batch, dec.view_bucket(len(pages))), np.int32)
        pt[slot, :len(pages)] = pages
        pos_v = np.zeros(dec.batch, np.int32)
        tok_v = np.zeros(dec.batch, np.int32)
        pos_v[slot], tok_v[slot] = pos, tok
        tok = int(np.argmax(dec.decode_paged(pt, pos_v, tok_v)[slot]))
        out.append(tok)
        pos += 1
    dec.ledger.release(pages)
    return out


@pytest.mark.parametrize("slot", [0, 1])
def test_port_paged_matches_port_contiguous(params, slot):
    contiguous = KVDecoder(params, heads=HEADS, max_len=32, batch=1,
                           device="cpu")
    paged = PagedKVDecoder(params, heads=HEADS, max_len=32, batch=2,
                           page=8, arena_pages=9, device="cpu")
    for prompt in _prompts(slot, [4, 11, 1]):
        want = contiguous.generate(prompt, 12)
        assert _drive_paged(paged, prompt, 12, slot=slot) == want
    assert paged.ledger.used == 0


def test_continuous_batcher_streams_match_contiguous(params):
    """More requests than slots through the paged continuous batcher:
    every stream equals its lone contiguous generation."""
    contiguous = KVDecoder(params, heads=HEADS, max_len=64, batch=1,
                           device="cpu")
    paged = PagedKVDecoder(params, heads=HEADS, max_len=64, batch=2,
                           page=8, device="cpu")
    prompts = _prompts(9, [3, 17, 8, 25, 1])
    batcher = ContinuousBatcher(paged, default_timeout_s=60.0)
    try:
        streams = [batcher.submit(p, max_new_tokens=10) for p in prompts]
        got = [s.result(timeout_s=60) for s in streams]
        # the live admission ledger is registered as a flight plane
        assert flight.planes()["generate_ledger"]["admitted"] == 5
    finally:
        assert batcher.stop()
    assert "generate_ledger" not in flight.planes()
    assert got == [contiguous.generate(p, 10) for p in prompts]
    assert batcher.page_ledger()["pages_used"] == 0
    snap = batcher.metrics.snapshot()
    assert (snap["admitted"], snap["completed"]) == (5, 5)


def test_contiguous_batcher_streams_match_generate(params):
    contiguous = KVDecoder(params, heads=HEADS, max_len=64, batch=1,
                           device="cpu")
    batched = KVDecoder(params, heads=HEADS, max_len=64, batch=2,
                        device="cpu")
    prompts = _prompts(4, [6, 2, 20])
    batcher = ContinuousBatcher(batched, default_timeout_s=60.0)
    try:
        got = [batcher.submit(p, max_new_tokens=8).result(timeout_s=60)
               for p in prompts]
    finally:
        assert batcher.stop()
    assert got == [contiguous.generate(p, 8) for p in prompts]


def test_decode_step_crash_fails_active_streams_and_keeps_serving(params):
    """Chaos site ``generate.step``: an injected crash gives every active
    stream its terminal error sentinel; the worker serves the next
    request and the page ledger closes."""
    paged = PagedKVDecoder(params, heads=HEADS, max_len=32, batch=2,
                           page=8, device="cpu")
    batcher = ContinuousBatcher(paged, default_timeout_s=60.0)
    plan = faults.FaultPlan(seed=0).crash_at("generate.step", at_hit=2)
    try:
        with faults.active(plan):
            doomed = batcher.submit([1, 2, 3], max_new_tokens=6)
            events = [doomed.next_event(timeout=30) for _ in range(2)]
            while not events[-1].get("done"):
                events.append(doomed.next_event(timeout=30))
        assert "error" in events[-1]
        assert len(batcher.submit([4], max_new_tokens=3)
                   .result(timeout_s=60)) == 3
    finally:
        assert batcher.stop()
    assert plan.log and plan.log[0]["site"] == "generate.step"
    assert paged.ledger.used == 0


def test_nan_poison_covers_torch_tensors():
    plan = faults.FaultPlan().nan_at("step.loss", at_hit=1)
    value = {"w": torch.ones(3), "b": [torch.zeros(2)]}
    out = plan.poison("step.loss", value)
    assert torch.isnan(out["w"]).all() and torch.isnan(out["b"][0]).all()
    assert plan.poison("step.loss", 1.5) == 1.5


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        backends.device()
    with pytest.raises(RuntimeError, match="is_available"):
        KVDecoder(jax_init_params(np.random.default_rng(0), 1, 8, 2, 8, 4),
                  heads=2)
    assert backends.device("cpu").type == "cpu"
    assert backends.resolve_compute_dtype("cpu") == torch.float32
    assert backends.resolve_compute_dtype("cuda") == torch.bfloat16
    assert backends.resolve_compute_dtype("cuda", "float32") == \
        torch.float32


def _cli(pkg, *extra):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch", "generate", pkg,
         "--max-len", "32", "--slots", "2", "--port", "0", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)


def test_cli_smoke_test_serves_on_cpu(params, tmp_path):
    pkg = str(tmp_path / "lm.npz")
    port_export.export_lm(params, pkg, heads=HEADS)
    r = _cli(pkg, "--smoke-test", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["smoke"] == "ok" and doc["events"] == 9
    assert doc["metrics"]["decoder"]["device"] == "cpu"
    assert doc["metrics"]["generate"]["completed"] == 1


def test_cli_without_device_refuses_on_host_without_cuda(params,
                                                         tmp_path):
    pkg = str(tmp_path / "lm.npz")
    port_export.export_lm(params, pkg, heads=HEADS)
    r = _cli(pkg, "--smoke-test")
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
    assert "smoke" not in r.stdout


def test_cli_one_shot_on_cpu(params, tmp_path):
    pkg = str(tmp_path / "lm.npz")
    port_export.export_lm(params, pkg, heads=HEADS)
    r = _cli(pkg, "--tokens", "1,2,3", "--max-tokens", "5", "--device",
             "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    want = KVDecoder(params, heads=HEADS, max_len=32, batch=1,
                     device="cpu").generate([1, 2, 3], 5)
    assert [int(t) for t in r.stdout.split()] == want
