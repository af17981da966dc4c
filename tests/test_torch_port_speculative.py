"""The port's speculative decoding against the JAX reference, on the CPU
at ``tests/test_paged.py``'s toy sizes (2 layers, d 32, 4 heads, ff 64,
vocab 31, max_len 32, page 8, f32).

Seeded numpy weights go through both packages: ``truncate_draft`` is
the reference's, ``verify_paged`` gives the reference's logits within
the decode band (1e-4) and writes the same arena rows, and the
speculative continuous batcher streams exactly what the port's plain
batcher and the JAX package's speculative batcher stream — greedy and
seeded-sampled — with both page ledgers closing.  The ``generate`` CLI
serves ``--speculative`` on ``--device cpu`` and exits 2 where the
reference's does."""

import json
import os
import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import pytest

from znicz_tpu.parallel.transformer import init_params as jax_init_params
from znicz_tpu.serve import continuous as jax_continuous
from znicz_tpu.serve import paged as jax_paged

from znicz_tpu_torch.observe.registry import REGISTRY
from znicz_tpu_torch.serve import server as port_server
from znicz_tpu_torch.serve.continuous import ContinuousBatcher
from znicz_tpu_torch.serve.kvcache import KVDecoder
from znicz_tpu_torch.serve.paged import PagedKVDecoder, truncate_draft
from znicz_tpu_torch.utils import export as port_export

N_LAYERS, D, HEADS, FF, VOCAB = 2, 32, 4, 64, 31
#: f32 logits, port vs reference: the decode band of the port's tests
BAND = 1e-4
#: arena rows, port vs reference: one layer's K/V projection each
ROW_BAND = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def params():
    return jax_init_params(np.random.default_rng(3), N_LAYERS, D, HEADS,
                           FF, VOCAB)


@pytest.fixture(scope="module")
def contiguous(params):
    return KVDecoder(params, heads=HEADS, max_len=32, batch=1,
                     device="cpu")


@pytest.fixture(scope="module")
def jax_pair(params):
    """The reference's target and draft decoders, one pair per config
    for the module: its compiled programs are request-independent."""
    cache: dict = {}

    def get(max_len=32, batch=2, page=8, arena_pages=None,
            draft_arena_pages=None):
        key = (max_len, batch, page, arena_pages, draft_arena_pages)
        if key not in cache:
            kw = dict(heads=HEADS, max_len=max_len, batch=batch, page=page)
            cache[key] = (
                jax_paged.PagedKVDecoder(params, arena_pages=arena_pages,
                                         **kw),
                jax_paged.PagedKVDecoder(
                    jax_paged.truncate_draft(params, 1),
                    arena_pages=draft_arena_pages, **kw))
        return cache[key]

    return get


def _port_pair(params, max_len=32, batch=2, page=8, arena_pages=None,
               draft_arena_pages=None):
    kw = dict(heads=HEADS, max_len=max_len, batch=batch, page=page,
              device="cpu")
    return (PagedKVDecoder(params, arena_pages=arena_pages, **kw),
            PagedKVDecoder(truncate_draft(params, 1),
                           arena_pages=draft_arena_pages, **kw))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).tolist() for n in lens]


@contextmanager
def _held(batcher):
    """Hold the batcher's worker while requests are submitted, so every
    one of them is queued before the first admission: the admission
    order, and so the rounds, are the same in both packages."""
    with batcher._cond:
        yield


def _events(stream):
    out = [stream.next_event(timeout=60)]
    while not out[-1].get("done"):
        out.append(stream.next_event(timeout=60))
    return out


def _run(batcher, requests):
    """Submit every ``(prompt, kwargs)`` with the worker held, stop
    (drain), and return each request's event list."""
    try:
        with _held(batcher):
            streams = [batcher.submit(p, **kw) for p, kw in requests]
        return [_events(s) for s in streams]
    finally:
        assert batcher.stop()


def _tokens(events):
    return [e["token"] for e in events if "token" in e]


# -- the draft -----------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [1])
def test_truncate_draft_equals_reference(params, n_layers):
    got = truncate_draft(params, n_layers)
    want = jax_paged.truncate_draft(params, n_layers)
    assert len(got["blocks"]) == len(want["blocks"]) == n_layers
    for key in ("emb", "head"):
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])
    for mine, ref in zip(got["blocks"], want["blocks"]):
        assert mine.keys() == ref.keys()
        for key in ref:
            assert mine[key].dtype == np.float32
            np.testing.assert_array_equal(mine[key], ref[key])


@pytest.mark.parametrize("n_layers", [0, N_LAYERS, N_LAYERS + 1])
def test_truncate_draft_refuses_a_draft_not_smaller(params, n_layers):
    with pytest.raises(ValueError, match="draft needs") as ours:
        truncate_draft(params, n_layers)
    with pytest.raises(ValueError) as ref:
        jax_paged.truncate_draft(params, n_layers)
    assert str(ours.value) == str(ref.value)


# -- the verify pass -----------------------------------------------------------

def test_verify_paged_matches_reference(params):
    """Three slots adopt their prompts into both arenas on the same
    pages, then one verify of Q = 5 rows: slot 0's rows 6..10 cross
    its first page boundary.  Logits within the decode band, every
    owned arena row within ROW_BAND afterwards, and the port's
    counters those of the reference."""
    kw = dict(heads=HEADS, max_len=32, batch=3, page=8)
    ref = jax_paged.PagedKVDecoder(params, **kw)
    ours = PagedKVDecoder(params, device="cpu", **kw)
    q_len = 5
    prompts = _prompts(11, [6, 13, 3])
    pages, pos = [], np.zeros(3, np.int32)
    for i, prompt in enumerate(prompts):
        pg = ref.ledger.alloc(ref.pages_for(len(prompt) + q_len))
        assert ours.ledger.alloc(len(pg)) == pg
        for dec in (ref, ours):
            kv1, _ = dec.prefill(prompt, bucket=dec.bucket_for(len(prompt)))
            dec.adopt_paged(kv1, pg[:dec.pages_for(len(prompt))])
        pages.append(pg)
        pos[i] = len(prompt)
    assert pos[0] // 8 != (pos[0] + q_len - 1) // 8
    pt = np.zeros((3, ours.view_bucket(max(map(len, pages)))), np.int32)
    for i, pg in enumerate(pages):
        pt[i, :len(pg)] = pg
    tokens = np.random.default_rng(12).integers(
        0, VOCAB, (3, q_len)).astype(np.int32)
    want = ref.verify_paged(pt, pos, tokens)
    got = ours.verify_paged(pt, pos, tokens)
    assert got.shape == want.shape == (3, q_len, VOCAB)
    np.testing.assert_allclose(got, want, rtol=BAND, atol=BAND)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    owned = sorted(p for pg in pages for p in pg)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            ours._arena[name][:, owned].numpy(),
            np.asarray(ref._arena[name])[:, owned], rtol=ROW_BAND,
            atol=ROW_BAND)
    assert (ours.decode_steps, ours.tokens_decoded) == \
        (ref.decode_steps, ref.tokens_decoded) == (1, 3 * q_len)
    with pytest.raises(ValueError, match="outside"):
        ours.verify_paged(pt, pos + pt.shape[1] * 8 - q_len + 1, tokens)
    with pytest.raises(ValueError, match="verify tokens"):
        ours.verify_paged(pt, pos, tokens[:, 0])


def test_verify_rows_equal_single_token_decode(params):
    """One verify of Q rows against Q single-token decode steps fed the
    same tokens, on two decoders with identical arenas: the same rows
    and the same logits."""
    kw = dict(heads=HEADS, max_len=32, batch=2, page=8, device="cpu")
    a, b = PagedKVDecoder(params, **kw), PagedKVDecoder(params, **kw)
    q_len = 4
    pos = np.asarray([7, 2], np.int32)
    pt = np.zeros((2, 2), np.int32)
    for i, prompt in enumerate(_prompts(13, pos.tolist())):
        pg = a.ledger.alloc(2)
        assert b.ledger.alloc(2) == pg
        pt[i] = pg
        for dec in (a, b):
            kv1, _ = dec.prefill(prompt)
            dec.adopt_paged(kv1, pg[:1])
    tokens = np.random.default_rng(14).integers(
        0, VOCAB, (2, q_len)).astype(np.int32)
    got = a.verify_paged(pt, pos, tokens)
    want = np.stack([b.decode_paged(pt, pos + i, tokens[:, i])
                     for i in range(q_len)], axis=1)
    np.testing.assert_allclose(got, want, rtol=BAND, atol=BAND)
    for name in ("k", "v"):
        np.testing.assert_allclose(a._arena[name][:, 1:].numpy(),
                                   b._arena[name][:, 1:].numpy(),
                                   rtol=ROW_BAND, atol=ROW_BAND)


# -- the speculative batcher ----------------------------------------------------

def test_speculative_greedy_streams_identical_to_plain_and_reference(
        params, contiguous, jax_pair):
    """THE speculation pin: greedy draft+verify rounds stream exactly
    what plain decode streams, and exactly what the reference's
    speculative batcher streams, with the same acceptance counts."""
    prompts = [[5, 7, 1, 30, 12], [2, 9], [1, 2, 3, 4], [8]]
    requests = [(p, {"max_new_tokens": 10}) for p in prompts]
    target, draft = _port_pair(params, arena_pages=17)
    spec = ContinuousBatcher(target, draft=draft, spec_k=3,
                             default_timeout_s=60.0)
    got = _run(spec, requests)
    jt, jd = jax_pair(arena_pages=17)
    jspec = jax_continuous.ContinuousBatcher(jt, draft=jd, spec_k=3,
                                             default_timeout_s=60.0)
    ref = _run(jspec, requests)
    plain = _run(ContinuousBatcher(target, default_timeout_s=60.0),
                 requests)
    want = [contiguous.generate(p, 10) for p in prompts]
    assert [_tokens(e) for e in got] == [_tokens(e) for e in plain] == \
        [_tokens(e) for e in ref] == want
    snap, jsnap = spec.metrics.snapshot(), jspec.metrics.snapshot()
    judged = snap["spec_accepted"] + snap["spec_rejected"]
    assert judged > 0 and judged % 3 == 0 and snap["spec_accepted"] > 0
    assert (snap["spec_accepted"], snap["spec_rejected"]) == \
        (jsnap["spec_accepted"], jsnap["spec_rejected"])
    ledger = spec.page_ledger()
    assert ledger["pages_used"] == ledger["draft_pages_used"] == 0
    assert target.ledger.used == draft.ledger.used == 0


def test_speculative_draft_of_the_targets_own_weights_accepts(
        params, contiguous):
    """A draft with the target's own weights proposes what the target
    would decode, so rounds accept and emit several tokens (the bonus
    token included) and the next round builds on the accepted rows:
    the streams stay plain decode's and the reference's, with the
    reference's acceptance counts."""
    prompts = [[5, 7, 1, 30, 12], [2, 9], [1, 2, 3, 4], [8]]
    requests = [(p, {"max_new_tokens": 10}) for p in prompts]
    kw = dict(heads=HEADS, max_len=32, batch=2, page=8, arena_pages=17)
    spec = ContinuousBatcher(
        PagedKVDecoder(params, device="cpu", **kw),
        draft=PagedKVDecoder(params, device="cpu", **kw), spec_k=3,
        default_timeout_s=60.0)
    got = _run(spec, requests)
    jspec = jax_continuous.ContinuousBatcher(
        jax_paged.PagedKVDecoder(params, **kw),
        draft=jax_paged.PagedKVDecoder(params, **kw), spec_k=3,
        default_timeout_s=60.0)
    ref = _run(jspec, requests)
    assert [_tokens(e) for e in got] == [_tokens(e) for e in ref] == \
        [contiguous.generate(p, 10) for p in prompts]
    snap, jsnap = spec.metrics.snapshot(), jspec.metrics.snapshot()
    assert snap["spec_accepted"] > snap["spec_rejected"]
    assert (snap["spec_accepted"], snap["spec_rejected"]) == \
        (jsnap["spec_accepted"], jsnap["spec_rejected"])
    ledger = spec.page_ledger()
    assert ledger["pages_used"] == ledger["draft_pages_used"] == 0


def test_speculative_sampled_request_keeps_seeded_distribution(
        params, jax_pair):
    """A temperature > 0 request rides the verify pass's position-0
    logits — its exact decode distribution — so it streams what the
    plain batcher streams, and what the reference's speculative batcher
    streams."""
    requests = [([7, 8, 9], {"max_new_tokens": 6, "temperature": 0.9,
                             "top_k": 5, "seed": 42})]
    target, draft = _port_pair(params, arena_pages=17)
    want = _run(ContinuousBatcher(target), requests)
    got = _run(ContinuousBatcher(target, draft=draft, spec_k=3), requests)
    jt, jd = jax_pair(arena_pages=17)
    ref = _run(jax_continuous.ContinuousBatcher(jt, draft=jd, spec_k=3),
               requests)
    assert _tokens(got[0]) == _tokens(want[0]) == _tokens(ref[0])
    assert len(_tokens(got[0])) == 6


def test_speculative_mixed_greedy_and_sampled_match_reference(
        params, contiguous, jax_pair):
    """Greedy and sampled requests in one batch: the greedy slots ride
    the acceptance rule, the sampled one takes one token a round."""
    requests = [([3, 14, 15], {"max_new_tokens": 12}),
                ([9, 2, 6, 5], {"max_new_tokens": 9, "temperature": 0.7,
                                "top_k": 4, "seed": 7}),
                ([26], {"max_new_tokens": 11})]
    target, draft = _port_pair(params, arena_pages=17)
    got = _run(ContinuousBatcher(target, draft=draft, spec_k=2), requests)
    want = _run(ContinuousBatcher(target), requests)
    jt, jd = jax_pair(arena_pages=17)
    ref = _run(jax_continuous.ContinuousBatcher(jt, draft=jd, spec_k=2),
               requests)
    assert [_tokens(e) for e in got] == [_tokens(e) for e in want] == \
        [_tokens(e) for e in ref]
    assert _tokens(got[0]) == contiguous.generate([3, 14, 15], 12)


def test_speculative_config_validation(params):
    target, draft = _port_pair(params, arena_pages=17)
    contig = KVDecoder(params, heads=HEADS, max_len=32, batch=2,
                       device="cpu")
    with pytest.raises(ValueError, match="Paged"):
        ContinuousBatcher(contig, draft=draft)
    with pytest.raises(ValueError, match="Paged"):
        ContinuousBatcher(target, draft=KVDecoder(
            truncate_draft(params, 1), heads=HEADS, max_len=32, batch=2,
            device="cpu"))
    narrow = PagedKVDecoder(truncate_draft(params, 1), heads=HEADS,
                            max_len=32, batch=3, page=8, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        ContinuousBatcher(target, draft=narrow)
    other = jax_init_params(np.random.default_rng(4), 1, D, HEADS, FF,
                            VOCAB + 1)
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatcher(target, draft=PagedKVDecoder(
            other, heads=HEADS, max_len=32, batch=2, page=8,
            device="cpu"))
    short = PagedKVDecoder(truncate_draft(params, 1), heads=HEADS,
                           max_len=16, batch=2, page=8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        ContinuousBatcher(target, draft=short)
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatcher(target, draft=draft, spec_k=0)


def test_speculative_request_to_the_max_len_boundary(params, contiguous,
                                                     jax_pair):
    """A budget that runs to max_len: the rounds near its end degrade to
    plain decode (a verify would write past the widest view), the
    stream stays identical, and both ledgers close."""
    requests = [([5, 7, 1, 30], {"max_new_tokens": 28})]
    target, draft = _port_pair(params, arena_pages=9)
    spec = ContinuousBatcher(target, draft=draft, spec_k=4,
                             default_timeout_s=60.0)
    got = _run(spec, requests)
    jt, jd = jax_pair(arena_pages=9)
    ref = _run(jax_continuous.ContinuousBatcher(jt, draft=jd, spec_k=4,
                                                default_timeout_s=60.0),
               requests)
    want = contiguous.generate([5, 7, 1, 30], 28)
    assert _tokens(got[0]) == _tokens(ref[0]) == want
    ledger = spec.page_ledger()
    assert ledger["pages_used"] == ledger["draft_pages_used"] == 0


def test_speculative_warmup_skips_views_narrower_than_a_round(params,
                                                              jax_pair):
    """warmup(spec_k=4) at page 4: the one-page view (4 rows) cannot
    hold a round of 5 rows and is skipped, not failed; the wider views
    run the verify, and the served stream is the reference's."""
    kw = dict(max_len=16, batch=1, page=4)
    target, draft = _port_pair(params, **kw)
    assert tuple(target.page_buckets) == (1, 2, 4)
    steps = target.decode_steps
    assert target.warmup(spec_k=4) == len(target.buckets) + 3 + 2
    assert target.decode_steps - steps == 3 + 2
    draft.warmup()
    requests = [([3, 1], {"max_new_tokens": 10})]
    got = _run(ContinuousBatcher(target, draft=draft, spec_k=4), requests)
    jt, jd = jax_pair(**kw)
    ref = _run(jax_continuous.ContinuousBatcher(jt, draft=jd, spec_k=4),
               requests)
    assert _tokens(got[0]) == _tokens(ref[0])
    assert len(_tokens(got[0])) == 10


def test_spec_counter_series_exist_at_boot(params):
    """The batcher's init-time on_spec(0, 0) materializes both labelled
    series, so a fleet delta rule sees a 0 baseline, not a missing
    key; the snapshot carries both counts."""
    target, draft = _port_pair(params)
    batcher = ContinuousBatcher(target, draft=draft, spec_k=3)
    try:
        prom = REGISTRY.render_prometheus()
        for event in ("accepted", "rejected"):
            assert f'znicz_generate_spec_tokens_total{{event="{event}"}}' \
                in prom
        snap = batcher.metrics.snapshot()
        assert (snap["spec_accepted"], snap["spec_rejected"]) == (0, 0)
    finally:
        assert batcher.stop()


def test_eviction_when_the_draft_arena_runs_out(params, jax_pair):
    """The target's arena is the worst case; the draft's holds three
    pages.  Two requests grow past them: the one that cannot append a
    draft page is evicted with the arena's error sentinel, the other
    completes, every request gets exactly one terminal event, the
    ledgers close — and the reference does the same, token for token."""
    # budgets of 23 and 24 rows: three draft pages each, all of them
    requests = [([4, 1, 7], {"max_new_tokens": 20}),
                ([12, 9, 3, 8], {"max_new_tokens": 20})]
    target, draft = _port_pair(params, draft_arena_pages=4)
    spec = ContinuousBatcher(target, draft=draft, spec_k=2,
                             default_timeout_s=60.0)
    got = _run(spec, requests)
    jt, jd = jax_pair(draft_arena_pages=4)
    ref = _run(jax_continuous.ContinuousBatcher(jt, draft=jd, spec_k=2,
                                                default_timeout_s=60.0),
               requests)
    for events in got:
        assert sum(bool(e.get("done")) for e in events) == 1
    terminal = [("error" in e[-1], e[-1].get("reason")) for e in got]
    assert sorted(terminal, key=str) == [(False, "length"), (True, None)]
    assert [_tokens(e) for e in got] == [_tokens(e) for e in ref]
    assert terminal == [("error" in e[-1], e[-1].get("reason"))
                        for e in ref]
    evicted = next(e[-1] for e in got if "error" in e[-1])
    assert "KV arena exhausted" in evicted["error"]
    snap = spec.metrics.snapshot()
    assert (snap["admitted"], snap["completed"], snap["failed"]) == \
        (2, 1, 1)
    ledger = spec.page_ledger()
    assert ledger["pages_used"] == ledger["draft_pages_used"] == 0


# -- the CLI -------------------------------------------------------------------

def _package(params, tmp_path, **kw):
    pkg = str(tmp_path / "lm.npz")
    port_export.export_lm(params, pkg, heads=HEADS, **kw)
    return pkg


def _generate(pkg, *extra):
    return port_server.generate_main(
        [pkg, "--max-len", "32", "--slots", "2", "--port", "0",
         "--device", "cpu", "--no-warmup", *extra])


def test_cli_speculative_smoke_test_serves_on_cpu(params, tmp_path):
    pkg = _package(params, tmp_path)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch", "generate", pkg,
         "--serve", "--speculative", "--draft-layers", "1", "--spec-k",
         "3", "--device", "cpu", "--smoke-test", "--max-len", "32",
         "--slots", "2", "--port", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["smoke"] == "ok" and doc["events"] == 9
    gen = doc["metrics"]["generate"]
    assert gen["completed"] == 1
    assert (gen["spec_accepted"] + gen["spec_rejected"]) % 3 == 0


@pytest.mark.parametrize("extra, message", [
    (("--speculative", "--no-paged", "--draft-layers", "1"),
     "--speculative needs the paged arena (drop --no-paged)"),
    (("--speculative", "--spec-k", "0", "--draft-layers", "1"),
     "--spec-k must be >= 1, got 0"),
    (("--speculative",),
     "--speculative needs a draft model in the package (export_lm "
     "draft_params=...) or --draft-layers N")])
def test_cli_speculative_refusals_exit_2(params, tmp_path, capsys, extra,
                                         message):
    pkg = _package(params, tmp_path)
    assert _generate(pkg, "--serve", *extra) == 2
    assert capsys.readouterr().out.strip() == f"generate: {message}"


def test_package_draft_wins_over_draft_layers(params, tmp_path):
    """A package that carries a draft serves it, whatever
    --draft-layers says; the server reports itself speculative."""
    dparams = jax_init_params(np.random.default_rng(8), 1, D, 2, FF, VOCAB)
    pkg = _package(params, tmp_path, draft_params=dparams, draft_heads=2)
    args = port_server.build_generate_parser().parse_args(
        [pkg, "--serve", "--speculative", "--draft-layers", "1",
         "--max-len", "32", "--slots", "2", "--port", "0", "--device",
         "cpu", "--no-warmup"])
    server = port_server.start_generate_server(args, *port_export.load_lm(
        pkg))
    try:
        draft = server.batcher._draft
        assert draft.heads == 2
        np.testing.assert_array_equal(
            draft._params["blocks"][0]["wq"].numpy(),
            dparams["blocks"][0]["wq"])
        assert server.meta_snapshot()["speculative"] is True
    finally:
        server.stop()


def test_pallas_decode_flag_parses_and_changes_nothing(params, tmp_path):
    pkg = _package(params, tmp_path)
    parser = port_server.build_generate_parser()
    on = vars(parser.parse_args([pkg, "--pallas-decode"]))
    off = vars(parser.parse_args([pkg]))
    assert on.pop("pallas_decode") is True
    assert off.pop("pallas_decode") is False
    assert on == off
    assert "always runs the paged-decode kernel" in " ".join(
        parser.format_help().split())
    for flag in ([], ["--pallas-decode"]):
        args = parser.parse_args([pkg, "--serve", "--max-len", "32",
                                  "--slots", "2", "--port", "0",
                                  "--device", "cpu", "--no-warmup",
                                  *flag])
        server = port_server.start_generate_server(
            args, *port_export.load_lm(pkg))
        try:
            assert server.meta_snapshot()["speculative"] is False
            out = server.batcher.submit([1, 2], max_new_tokens=4) \
                .result(timeout_s=60)
        finally:
            server.stop()
        if not flag:
            want = out
    assert out == want


def test_feedback_spool_is_not_ported_yet(params, tmp_path):
    """The spool is ported now: ``--feedback-spool`` appends the smoke's
    completed generation, in the reference's record shape."""
    from znicz_tpu.learn.spool import SpoolReader, initial_cursor

    pkg = _package(params, tmp_path)
    spool = str(tmp_path / "spool")
    assert _generate(pkg, "--smoke-test", "--feedback-spool", spool) == 0
    recs, _ = SpoolReader(spool).read(initial_cursor(spool), 1, wait_s=1.0)
    assert recs[0]["kind"] == "generate" and len(recs[0]["tokens"]) == 8
