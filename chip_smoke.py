#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``znicz_tpu_torch``): the
quickest proof that the port builds and serves on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one GPU

Phases, each printing one JSON line (any failure raises and the script
exits non-zero without the final ``ok`` line):

1. **kernel** — build every kernel of the serving path from
   ``znicz_tpu_torch/csrc`` with ``nvcc`` and hold each against its
   plain PyTorch version on the card at the path's shapes, in bf16 and
   f32; time the kernel, the plain version and one PyTorch library call
   computing the same function; compute the kernel's bound from this
   run's inputs.
2. **serve** — make the full-width transformer LM package from a seed
   (6 layers, d 512, 8 heads, ff 2048, vocab 32000), boot the
   ``generate`` server in-process (8 slots, max_len 2048, page 16,
   bf16) and stream 12 concurrent greedy requests through HTTP; every
   kernel launch counter is set to 0 just before the requests and read
   just after.
3. **profile** — where a steady decode step's time goes: the served
   decoder runs steps with all 8 slots live, timed without and then
   with ``torch.profiler`` (device busy time, the kernel's share, the
   device's idle share).
4. **parity** — teacher-forced decode of a subset of the prompts through
   the paged decoder (kernel attention) and the contiguous decoder
   (plain attention) on the card, in f32 and bf16.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and, last, the ``{"ok": true, ...}`` line.
Exits non-zero without a usable CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from znicz_tpu_torch.core.backends import resolve_compute_dtype
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.kernels import build as kbuild
from znicz_tpu_torch.kernels import decode as kdecode
from znicz_tpu_torch.observe.trace import TRACER
from znicz_tpu_torch.parallel.transformer import init_params
from znicz_tpu_torch.serve.kvcache import KVDecoder
from znicz_tpu_torch.serve.paged import PagedKVDecoder
from znicz_tpu_torch.serve.server import (build_generate_parser,
                                          start_generate_server)
from znicz_tpu_torch.utils.export import export_lm, load_lm

SEED = 20261016
#: every tensor, decoder and the server run here (stated explicitly)
DEVICE = "cuda"
#: the largest transformer the repo configures (bench.py
#: bench_transformer): layers, d, heads, ff, vocab
N_LAYERS, D, HEADS, FF, VOCAB = 6, 512, 8, 2048, 32000
SLOTS, MAX_LEN, PAGE = 8, 2048, 16
PROMPT_LENS = (17, 64, 130, 255, 511, 700, 1024, 1500, 33, 300, 900, 1200)
MAX_TOKENS = 32
#: steady decode steps timed (and then profiled) in phase profile
PROFILE_STEPS = 20
#: the parity subset: prompt lengths and teacher-forced decode steps
PARITY_LENS, PARITY_STEPS = (17, 511, 1024), 16

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

#: kernel vs plain on identical inputs: both compute in f32 from the
#: same (bf16-exact) operands and differ only in summation order, ~1e-7
#: at these shapes — 2e-5 is the reference's own kernel band
KERNEL_ATOL = 2e-5
#: whole-model logits, kernel attention vs plain attention, f32: the
#: attention sums reorder (~1e-7 per layer) and the difference carries
#: through 6 layers — the CPU parity band of the port's tests
PARITY_ATOL_F32 = 1e-4
#: the same in bf16: the plain path rounds softmax probabilities to bf16
#: before the value product and the kernel does not, so activations
#: differ by bf16 roundings (~0.4 %) that compound over 6 layers on
#: logits of order 1; a wrong page or mask moves logits by order 1
PARITY_ATOL_BF16 = 0.25


def emit(doc: dict) -> None:
    print(json.dumps(doc), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def time_cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each
    call, with L2 flushed before each (the serving path meets each
    layer's arena cold: six layers of K/V exceed the 50 MB L2)."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


def decode_inputs(rng, dtype, head_dim, lengths, batch=SLOTS, heads=HEADS,
                  page=PAGE, max_len=MAX_LEN):
    """Random q and an arena layer with every slot's pages scattered
    over a shuffled page table (page 0 reserved, padding -> 0)."""
    p_view = -(-max_len // page)
    n_pages = batch * p_view + 1
    q = torch.tensor(rng.normal(size=(batch, heads, head_dim)),
                     dtype=dtype, device=DEVICE)
    k = torch.tensor(rng.normal(size=(n_pages, page, heads, head_dim)),
                     dtype=dtype, device=DEVICE)
    v = torch.tensor(rng.normal(size=(n_pages, page, heads, head_dim)),
                     dtype=dtype, device=DEVICE)
    perm = rng.permutation(np.arange(1, n_pages))
    pt = np.zeros((batch, p_view), np.int32)
    for b, n_rows in enumerate(lengths):
        n = -(-n_rows // page)
        pt[b, :n] = perm[b * p_view:b * p_view + n]
    return (q, k, v, torch.tensor(pt, device=DEVICE),
            torch.tensor(lengths, dtype=torch.int32, device=DEVICE))


def sdpa_on_view(q, k, v, pt, lengths):
    """The library yardstick: gather the page view once (untimed), then
    one scaled_dot_product_attention call with the length mask."""
    B, H, Dh = q.shape
    t_view = pt.shape[1] * k.shape[1]
    kc = k[pt.long()].reshape(B, t_view, H, Dh).transpose(1, 2).contiguous()
    vc = v[pt.long()].reshape(B, t_view, H, Dh).transpose(1, 2).contiguous()
    live = (torch.arange(t_view, device=DEVICE)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=live)


def phase_kernel() -> dict:
    t0 = time.perf_counter()
    kbuild.build(["paged_decode"])
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    lengths = rng.permutation([1, 17, 300, 700, 1024, 1500, 2000, 2048])
    lengths = [int(n) for n in lengths]
    checks = []
    timed = None
    for dtype in (torch.bfloat16, torch.float32):
        for head_dim in kdecode.HEAD_DIMS:
            args = decode_inputs(rng, dtype, head_dim, lengths)
            before = kdecode.launches
            o = kdecode.paged_decode(*args)
            o2 = kdecode.paged_decode(*args)
            if kdecode.launches != before + 2:
                fail("paged_decode did not count its launches")
            ref = kdecode.paged_decode_plain(*args)
            torch.cuda.synchronize()
            err = float((o - ref).abs().max())
            checks.append({"dtype": str(dtype).split(".")[-1],
                           "head_dim": head_dim, "max_abs_err": err,
                           "deterministic": bool(torch.equal(o, o2))})
            if not torch.isfinite(o).all():
                fail(f"non-finite kernel output ({dtype}, {head_dim})")
            if err > KERNEL_ATOL:
                fail(f"kernel vs plain {err} > {KERNEL_ATOL} "
                     f"({dtype}, head_dim {head_dim})")
            if not torch.equal(o, o2):
                fail("kernel output differs between two identical runs")
            if dtype == torch.bfloat16 and head_dim == D // HEADS:
                timed = args
    # the serving shapes: bf16, head_dim 64, the widest page view
    q, k, v, pt, ln = timed
    ms = time_cuda_ms(lambda: kdecode.paged_decode(q, k, v, pt, ln))
    plain_ms = time_cuda_ms(lambda: kdecode.paged_decode_plain(q, k, v, pt,
                                                               ln))
    library_ms = time_cuda_ms(sdpa_on_view(q, k, v, pt, ln))
    nbytes = kdecode.bound_bytes(q, k, pt, ln)
    flops = 4 * int(ln.long().sum()) * HEADS * (D // HEADS)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    ptxas = [line.split(":", 1)[1].strip() for line in
             kbuild.build_log("paged_decode").splitlines()
             if "registers" in line]
    return {"phase": "kernel", "build_s": build_s, "ptxas": ptxas,
            "checks": checks,
            "atol": KERNEL_ATOL, "lengths": lengths,
            "shape": {"B": SLOTS, "H": HEADS, "Dh": D // HEADS,
                      "page": PAGE, "P": int(pt.shape[1]),
                      "dtype": "bfloat16"},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": nbytes,
            "max_abs_err": max(c["max_abs_err"] for c in checks)}


def _stream(port: int, ids: list, out: dict) -> None:
    body = json.dumps({"tokens": ids, "max_tokens": MAX_TOKENS,
                       "temperature": 0.0}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=body,
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            if not events:
                out["ttft_ms"] = (time.perf_counter() - t0) * 1e3
            events.append(json.loads(raw))
    out["events"] = events
    out["total_ms"] = (time.perf_counter() - t0) * 1e3


def phase_serve(pkg: str) -> dict:
    args = build_generate_parser().parse_args(
        [pkg, "--serve", "--port", "0", "--slots", str(SLOTS),
         "--max-len", str(MAX_LEN), "--page-size", str(PAGE),
         "--device", DEVICE])
    t0 = time.perf_counter()
    lm_params, meta = load_lm(pkg)
    server = start_generate_server(args, lm_params, meta)
    boot_s = time.perf_counter() - t0
    decoder = server.decoder
    if decoder.device.type != DEVICE or \
            decoder.dtype != resolve_compute_dtype(DEVICE):
        fail(f"server decodes in {decoder.dtype} on {decoder.device}")
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in PROMPT_LENS]
    results = [{} for _ in prompts]
    steps0 = decoder.decode_steps
    TRACER.clear()
    kdecode.launches = 0                     # counts: 0 just before ...
    t0 = time.perf_counter()
    threads = [threading.Thread(target=_stream,
                                args=(server.port, ids, out))
               for ids, out in zip(prompts, results)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_s = time.perf_counter() - t0
    launches = kdecode.launches              # ... and read just after
    steps = decoder.decode_steps - steps0
    server.stop()                            # drains: the ledger is final
    snap = server.metrics.snapshot()
    if any(t.is_alive() for t in threads):
        fail("a request stream did not finish")
    n_tokens = 0
    streams = []
    for ids, res in zip(prompts, results):
        events = res.get("events", [])
        toks = [e["token"] for e in events if "token" in e]
        last = events[-1] if events else {}
        if not (last.get("done") and last.get("reason") == "length"
                and "error" not in last):
            fail(f"prompt of {len(ids)} tokens ended with {last}")
        if len(toks) != MAX_TOKENS or not all(0 <= t < VOCAB
                                              for t in toks):
            fail(f"prompt of {len(ids)} tokens streamed {len(toks)} "
                 f"tokens, want {MAX_TOKENS} ids in [0, {VOCAB})")
        n_tokens += len(toks)
        streams.append(toks)
    if launches < steps * N_LAYERS or launches == 0:
        fail(f"paged_decode launched {launches} times over {steps} "
             f"decode steps x {N_LAYERS} layers")
    step_ms = [e["dur"] / 1e3 for e in TRACER.tail(len(TRACER))
               if e["name"] == "generate.decode_step"]
    ttft = [r["ttft_ms"] for r in results]
    if snap["completed"] != len(prompts):
        fail(f"ledger: {snap}")
    return {"phase": "serve", "boot_s": boot_s, "requests": len(prompts),
            "prompt_lens": list(PROMPT_LENS), "max_tokens": MAX_TOKENS,
            "dtype": str(decoder.dtype), "decode_steps": steps,
            "kernel_launches": launches,
            "launches_per_step": launches / max(steps, 1),
            "ttft_ms": ttft, "ttft_ms_p50": float(np.median(ttft)),
            "ttft_ms_max": float(max(ttft)),
            "decode_step_ms_p50": float(np.median(step_ms)),
            "decode_step_ms_mean": float(np.mean(step_ms)),
            "tokens": n_tokens, "wall_s": wall_s,
            "tokens_per_s": n_tokens / wall_s,
            "ledger": {k: snap[k] for k in ("admitted", "completed",
                                            "failed", "abandoned")},
            "_streams": streams, "_decoder": decoder}


def phase_profile(decoder) -> dict:
    """All slots live at the first prompts' lengths plus their 32
    tokens; time PROFILE_STEPS decode steps on the host clock, then
    profile the same steps for device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    lens = [n + MAX_TOKENS for n in PROMPT_LENS[:decoder.batch]]
    pages = [decoder.ledger.alloc(decoder.pages_for(n + 1)) for n in lens]
    pt = np.zeros((decoder.batch,
                   decoder.view_bucket(max(map(len, pages)))), np.int32)
    for i, pg in enumerate(pages):
        pt[i, :len(pg)] = pg
    pos = np.asarray(lens, np.int32)
    tok = np.random.default_rng(SEED + 3).integers(
        0, decoder.vocab, decoder.batch).astype(np.int32)

    def steps():
        for _ in range(PROFILE_STEPS):
            decoder.decode_paged(pt, pos, tok)
        torch.cuda.synchronize()

    steps()                                  # warm
    t0 = time.perf_counter()
    steps()
    step_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps()
    for pg in pages:
        decoder.ledger.release(pg)
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 \
        / PROFILE_STEPS
    kernel_ms = sum(e.self_device_time_total for e in device
                    if "paged_decode_kernel" in e.key) / 1e3 / PROFILE_STEPS
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    return {"phase": "profile", "steps": PROFILE_STEPS,
            "slot_lengths": lens, "page_view": int(pt.shape[1]),
            "step_ms": step_ms,
            "device_busy_ms_per_step": busy_ms or None,
            "paged_decode_ms_per_step": kernel_ms or None,
            "device_idle_share": (1 - busy_ms / step_ms) if busy_ms
            else None,
            "kernels_per_step": sum(e.count for e in device)
            / PROFILE_STEPS,
            "top_device": [{"name": e.key[:80], "count": e.count,
                            "ms_per_step": e.self_device_time_total / 1e3
                            / PROFILE_STEPS} for e in top]}


def _teacher_forced(params, precision: str, prompts, n_steps: int) -> dict:
    """Decode ``prompts`` through the paged decoder (kernel attention)
    and the contiguous decoder (plain attention) on the card, feeding
    both the paged decoder's greedy tokens; compare logits at every
    step and count argmax disagreements."""
    root.common.engine.precision = precision
    try:
        batch = len(prompts)
        paged = PagedKVDecoder(params, heads=HEADS, max_len=MAX_LEN,
                               batch=batch, page=PAGE, device=DEVICE)
        contig = KVDecoder(params, heads=HEADS, max_len=MAX_LEN,
                           batch=batch, device=DEVICE)
    finally:
        root.common.engine.precision = "bfloat16"
    bucket = contig.bucket_for(max(len(p) for p in prompts) + n_steps)
    kv = contig.alloc(bucket)
    pages, pos, tok = [], np.zeros(batch, np.int32), \
        np.zeros(batch, np.int32)
    for i, ids in enumerate(prompts):
        pg = paged.ledger.alloc(paged.pages_for(len(ids)))
        kv1, lg = paged.prefill(ids)
        paged.adopt_paged(kv1, pg)
        # the decode rows to come: a page-table append, as the batcher
        pg += paged.ledger.alloc(paged.pages_for(len(ids) + n_steps)
                                 - len(pg))
        kv1c, _ = contig.prefill(ids)
        kv = contig.adopt(kv, kv1c, i)
        pages.append(pg)
        pos[i], tok[i] = len(ids), int(np.argmax(lg))
    pt = np.zeros((batch, paged.view_bucket(max(map(len, pages)))),
                  np.int32)
    for i, pg in enumerate(pages):
        pt[i, :len(pg)] = pg
    worst, flips = 0.0, 0
    for _ in range(n_steps):
        lp = paged.decode_paged(pt, pos, tok)
        kv, lc = contig.decode(kv, pos, tok)
        if not np.isfinite(lp).all():
            fail(f"non-finite paged logits ({precision})")
        worst = max(worst, float(np.abs(lp - lc).max()))
        flips += int((lp.argmax(1) != lc.argmax(1)).sum())
        tok = lp.argmax(1).astype(np.int32)
        pos += 1
    return {"max_abs_logit_diff": worst, "argmax_flips": flips,
            "compared": batch * n_steps, "dtype": str(paged.dtype)}


def phase_parity(params) -> dict:
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in PARITY_LENS]
    out = {"phase": "parity", "prompt_lens": list(PARITY_LENS),
           "steps": PARITY_STEPS,
           "f32": _teacher_forced(params, "float32", prompts,
                                  PARITY_STEPS),
           "bf16": _teacher_forced(params, "bfloat16", prompts,
                                   PARITY_STEPS),
           "atol": {"f32": PARITY_ATOL_F32, "bf16": PARITY_ATOL_BF16},
           "exact": "kernel output bit-identical across two runs "
                    "(phase kernel); the band: logits, kernel vs plain "
                    "attention; bf16 argmax flips are counted, not "
                    "failed"}
    if out["f32"]["max_abs_logit_diff"] > PARITY_ATOL_F32:
        fail(f"f32 kernel-vs-plain logits {out['f32']} > "
             f"{PARITY_ATOL_F32}")
    if out["bf16"]["max_abs_logit_diff"] > PARITY_ATOL_BF16:
        fail(f"bf16 kernel-vs-plain logits {out['bf16']} > "
             f"{PARITY_ATOL_BF16}")
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke runs only on a CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    kernel = phase_kernel()
    emit(kernel)
    t0 = time.perf_counter()
    params = init_params(np.random.default_rng(SEED), N_LAYERS, D, HEADS,
                         FF, VOCAB)
    with tempfile.TemporaryDirectory() as tmp:
        pkg = export_lm(params, os.path.join(tmp, "lm.npz"), heads=HEADS)
        package_s = time.perf_counter() - t0
        serve = phase_serve(pkg)
    streams = serve.pop("_streams")
    decoder = serve.pop("_decoder")
    serve["package_s"] = package_s
    emit(serve)
    emit(phase_profile(decoder))
    del decoder
    parity = phase_parity(params)
    emit(parity)
    emit({"kernels": [{
        "name": "paged_decode", "route": "cuda", "source": kdecode.SOURCE,
        "replaces": kdecode.REPLACES, "launches": serve["kernel_launches"],
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"], "library_ms": kernel["library_ms"],
    }], "first_stream": streams[0][:8],
        "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
