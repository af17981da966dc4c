#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``znicz_tpu_torch``): the
quickest proof that the port builds, serves and trains on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one GPU

Phases, each printing one JSON line (any failure raises and the script
exits non-zero without the final ``ok`` line):

1. **kernel** — build every kernel of the serving path from
   ``znicz_tpu_torch/csrc`` with ``nvcc`` and hold each against its
   plain PyTorch version on the card at the path's shapes, in bf16 and
   f32; time the kernel, the plain version and one PyTorch library call
   computing the same function; compute the kernel's bound from this
   run's inputs.
1b. **flash** — the same for the training path's flash-attention
   forward and backward kernels: held against their plain versions
   (norm-relative error of each 64-row tile) in bf16 and f32, head dim
   64 and 128, causal and not, at t 2048 and a ragged t, and at the
   training shape; bit-identical across two launches; each band must
   reject a control run that reads one K/V tile as zeros.  Timed (with
   ptxas's registers and spills) at the training shape.
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
5. **train** — bench.py bench_transformer's training step at full width
   (6 layers, d 512, 8 heads, ff 2048, vocab 32000, batch 8, t 2048,
   16 CE chunks, bf16 compute over f32 masters) through
   ``make_train_step``: one warm and 12 timed steps with both flash
   launch counters set to 0 just before and read just after; the loss
   must be finite and fall.  Step ms, tokens/s, MFU, peak memory, then
   two steps under ``torch.profiler``.
6. **train_parity** — 3 steps at 2 layers, batch 2, t 256: the card in
   f32 (TF32 off) against the port on the CPU, and the card in bf16
   against the card in f32; the f32 bands must reject the same steps
   with TF32 on.
7. **handoff** — the trained params through ``export_lm`` into a paged
   decoder on the card in f32: 8 greedy tokens from a 100-token prompt,
   each step's logits held against ``make_logits_fn``.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and, last, the ``{"ok": true, ...}`` line.
Exits non-zero without a usable CUDA device.
"""

from __future__ import annotations

import json
import os
import re
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
from znicz_tpu_torch.kernels import flash_attention as kflash
from znicz_tpu_torch.observe.trace import TRACER
from znicz_tpu_torch.parallel.transformer import (init_params,
                                                  make_logits_fn,
                                                  make_train_step,
                                                  param_shapes,
                                                  params_from_numpy,
                                                  params_to_numpy)
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

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor and
#: bf16 dense tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

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

#: flash phase: the check matrix runs at b·h 16 (b 2, h 8), at the full
#: t and at a ragged t that is no multiple of the kernels' 64-row tiles,
#: then at the training shape (b·h 64, t 2048, dh 64, bf16, causal)
FLASH_CHECK_BH, FLASH_TS = 16, (2048, 1000)
#: rows per tile of the error metric: the kernels' q and k tile height
FLASH_ERR_TILE = 64
#: flash kernel vs plain, as the largest norm-relative error of any
#: 64-row tile of any head, ||kernel - plain|| / ||plain||, per output
#: (a tile's norm sums 64 rows, so no near-zero row blows it up, and one
#: wrong tile cannot hide behind the large early rows of a causal head).
#: lse is f32 in both dtypes, from the same operands and the unrounded
#: p: summation order only.  f32 o and grads: summation order only.
#: bf16 o and grads: p and ds round to bf16 at the online running max
#: in the kernel and at the whole-row max in the plain version, and the
#: outputs are bf16.  Each band sits above the sound readings and well
#: below a kernel that reads one K/V tile as zeros (the control below),
#: which the smoke requires the band to reject
FLASH_TOL = {torch.bfloat16: {"o": 1e-2, "lse": 1e-6, "dq": 1e-2,
                              "dk": 1e-2, "dv": 1e-2},
             torch.float32: {"o": 1e-5, "lse": 1e-6, "dq": 1e-5,
                             "dk": 1e-5, "dv": 1e-5}}
#: the training step of bench.py bench_transformer: batch, time, CE
#: chunks, learning rate (plain SGD at 0.05 diverges at this width, on
#: the CPU path as on the card; at 1e-3 the random-init loss of ~13
#: falls by ~0.3 a step)
TRAIN_B, TRAIN_T, TRAIN_CHUNKS, TRAIN_LR = 8, 2048, 16, 1e-3
#: timed steps after one warm step
TRAIN_STEPS = 12
#: train_parity: depth, batch, time and CE chunks of the reduced run
PARITY_LAYERS, PARITY_B, PARITY_T, PARITY_CHUNKS = 2, 2, 256, 4
#: card (f32 kernels, TF32 off) vs CPU (plain versions), both full f32:
#: they differ in summation order only (cuBLAS vs the CPU's GEMM
#: blocking, the kernels' tiles vs whole-row softmax), by about one
#: f32 ulp: ~1e-7 relative on losses of ~11 and ~6e-8 on the params
#: after 3 steps of lr 1e-3.  The loss band (~6 ulps) must reject the
#: same three steps run with TF32 on (the control below, ~20 ulps): a
#: run that silently left full f32 does not pass
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 5e-7, 1e-6
#: bf16 compute vs f32 on the card: the reference's own band
#: (tests/test_transformer_spmd.py::test_bf16_step_tracks_f32)
TRAIN_BF16_RTOL = 2e-2
#: handoff: prompt and decoded tokens; decoder logits (prefill in plain
#: attention, decode through paged_decode, f32) vs the training forward
#: (flash forward kernel, f32) over 6 layers differ in summation order,
#: ~1e-5 on logits of order 1; a wrong row or layer moves them by order 1
HANDOFF_PROMPT, HANDOFF_TOKENS, HANDOFF_ATOL = 100, 8, 1e-3


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


def ptxas_usage(name: str) -> dict:
    """Registers and spill bytes per kernel from ptxas's build log, keyed
    by the kernel's name and template arguments (``flash_fwd_bf16<64>``)."""
    usage, current = {}, None
    for line in kbuild.build_log(name).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            # the mangled name: <length><name>I<Li<n>E...>E...
            m = re.search(r"\d(flash_[a-z0-9_]+?)I((?:Li\d+E)+)E",
                          entry.group(1))
            current = (f"{m.group(1)}<"
                       f"{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
                       if m else entry.group(1))
            usage[current] = {}
        elif current and "spill stores" in line:
            nums = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
            usage[current].update(spill_stores=nums[0], spill_loads=nums[1])
        elif current and "registers" in line:
            usage[current]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return usage


def _flash_inputs(rng, bh, t, dh, dtype):
    return [torch.tensor(rng.normal(size=(bh, t, dh)), dtype=dtype,
                         device=DEVICE) for _ in range(4)]


def _delta(do, o, dlse):
    """Δ = rowsum(do ⊙ o) minus the lse cotangent, as the autograd
    function folds it."""
    return (do.float() * o.float()).sum(-1, keepdim=True) - dlse


def _flash_run(q, k, v, do, dlse, causal):
    """Forward then backward through the kernels."""
    o, lse = kflash.flash_attention_fwd(q, k, v, causal)
    return (o, lse) + kflash.flash_attention_bwd(
        q, k, v, do, lse, _delta(do, o, dlse), causal)


def _flash_plain(q, k, v, do, dlse, causal):
    o, lse = kflash.flash_attention_fwd_plain(q, k, v, causal)
    return (o, lse) + kflash.flash_attention_bwd_plain(
        q, k, v, do, lse, _delta(do, o, dlse), causal)


def tile_rel_err(a, b, rows: int = FLASH_ERR_TILE) -> float:
    """The largest ||a - b|| / ||b|| over ``rows``-row tiles of dim 1 of
    ``(bh, t, x)`` tensors, each head's tiles apart (a ragged last tile
    is zero-padded in both, which changes neither norm)."""
    bh, t = a.shape[:2]
    pad = -t % rows
    a, b = (torch.nn.functional.pad(x.float().reshape(bh, t, -1),
                                    (0, 0, 0, pad)).reshape(bh, -1, rows *
                                                            x[0, 0].numel())
            for x in (a, b))
    num = (a - b).norm(dim=-1)
    den = b.norm(dim=-1)
    return float((num / den.clamp_min(torch.finfo(torch.float32).tiny))
                 .max())


#: the training shape, a case of the check matrix: b·h, t, dh, dtype,
#: causal
FLASH_TRAIN_CASE = (TRAIN_B * HEADS, TRAIN_T, D // HEADS, torch.bfloat16,
                    True)
FLASH_OUTPUTS = ("o", "lse", "dq", "dk", "dv")


def _flash_check(rng, bh, t, dh, dtype, causal) -> tuple:
    """One case: the kernels against the plain versions (random do, a
    nonzero lse cotangent), two launches bit for bit, and the control —
    the kernels run with the last K/V tile read as zeros, which every
    output's band must reject.  Returns the report and the inputs."""
    case = (f"{str(dtype).split('.')[-1]}, b·h {bh}, t {t}, dh {dh}, "
            f"causal {causal}")
    q, k, v, do = _flash_inputs(rng, bh, t, dh, dtype)
    dlse = torch.tensor(rng.normal(size=(bh, t, 1)), dtype=torch.float32,
                        device=DEVICE)
    got = _flash_run(q, k, v, do, dlse, causal)
    again = _flash_run(q, k, v, do, dlse, causal)
    want = _flash_plain(q, k, v, do, dlse, causal)
    last = (t - 1) // FLASH_ERR_TILE * FLASH_ERR_TILE
    kz, vz = k.clone(), v.clone()
    kz[:, last:] = 0
    vz[:, last:] = 0
    wrong = _flash_run(q, kz, vz, do, dlse, causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    rel, control = {}, {}
    for name, a, b, w in zip(FLASH_OUTPUTS, got, want, wrong):
        if not torch.isfinite(a).all():
            fail(f"non-finite flash {name} ({case})")
        rel[name] = tile_rel_err(a, b)
        control[name] = tile_rel_err(w, b)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    report = {"dtype": str(dtype).split(".")[-1], "bh": bh, "head_dim": dh,
              "causal": causal, "t": t, "rel_err": rel,
              "control_rel_err": control, "deterministic": same,
              "max_abs_err_by": {
                  n: float((a.float() - b.float()).abs().max())
                  for n, a, b in zip(FLASH_OUTPUTS, got, want)}}
    if not all(rel[n] <= tol[n] for n in FLASH_OUTPUTS):    # NaN fails
        fail(f"flash kernel vs plain {rel} > {tol} ({case})")
    if not all(control[n] > tol[n] for n in FLASH_OUTPUTS):
        fail(f"a band passes the zeroed-tile control {control} vs {tol} "
             f"({case})")
    if not same:
        fail(f"flash kernel output differs between two identical runs "
             f"({case})")
    return report, (q, k, v, do, dlse)


def phase_flash() -> dict:
    t0 = time.perf_counter()
    kbuild.build(["flash_attention"])
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 4)
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        for dh in kflash.HEAD_DIMS:
            for causal in (True, False):
                for t in FLASH_TS:
                    checks.append(_flash_check(rng, FLASH_CHECK_BH, t, dh,
                                               dtype, causal)[0])
    train_check, (q, k, v, do, dlse) = _flash_check(rng, *FLASH_TRAIN_CASE)
    checks.append(train_check)
    o, lse = kflash.flash_attention_fwd(q, k, v, True)
    delta = _delta(do, o, dlse)
    shape4 = (TRAIN_B, HEADS, TRAIN_T, D // HEADS)
    q4, k4, v4 = (x.view(shape4).detach().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o4 = sdpa(q4, k4, v4, is_causal=True)
    do4 = do.view(shape4)
    timed = {
        "fwd": {"ms": time_cuda_ms(
                    lambda: kflash.flash_attention_fwd(q, k, v, True)),
                "plain_ms": time_cuda_ms(
                    lambda: kflash.flash_attention_fwd_plain(q, k, v, True)),
                "library_ms": time_cuda_ms(
                    lambda: sdpa(q4, k4, v4, is_causal=True)),
                "max_abs_err": max(train_check["max_abs_err_by"][n]
                                   for n in ("o", "lse")),
                **kflash.bound(q, True)},
        "bwd": {"ms": time_cuda_ms(lambda: kflash.flash_attention_bwd(
                    q, k, v, do, lse, delta, True)),
                "plain_ms": time_cuda_ms(
                    lambda: kflash.flash_attention_bwd_plain(
                        q, k, v, do, lse, delta, True)),
                "library_ms": time_cuda_ms(lambda: torch.autograd.grad(
                    o4, (q4, k4, v4), do4, retain_graph=True)),
                "max_abs_err": max(train_check["max_abs_err_by"][n]
                                   for n in ("dq", "dk", "dv")),
                **kflash.bound(q, True, backward=True)},
    }
    return {"phase": "flash", "build_s": build_s,
            "ptxas": ptxas_usage("flash_attention"),
            "tol": {str(k).split(".")[-1]: v for k, v in FLASH_TOL.items()},
            "checks": checks,
            "shape": {"bh": TRAIN_B * HEADS, "t": TRAIN_T, "dh": D // HEADS,
                      "dtype": "bfloat16", "causal": True},
            **timed}


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
    profile the same steps for device time by kernel.  The idle share
    sets the device's busy time against the wall time of the profiled
    window itself (profiler on)."""
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
    # busy and wall time (the idle share) from the same profiled window;
    # device activity only, as recording every host op would stretch
    # this host-bound step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
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
            "step_ms": step_ms, "profiled_step_ms": profiled_ms,
            "device_busy_ms_per_step": busy_ms or None,
            "paged_decode_ms_per_step": kernel_ms or None,
            "device_idle_share": (1 - busy_ms / profiled_ms) if busy_ms
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


def _n_matmul(n_layers: int) -> int:
    """Matmul weights of the model, the embedding excluded (its lookup
    does no matmul flops) — bench.py's ``mfu_matmul_only`` count."""
    shapes = param_shapes(n_layers, D, FF, VOCAB)
    leaves = [shapes["head"]] + [s for blk in shapes["blocks"]
                                 for s in blk.values()]
    return sum(int(np.prod(s)) for s in leaves if len(s) >= 2)


def _train_batch(seed: int, b: int, t: int):
    """Seeded tokens with the learnable rule labels = (tokens + 1) mod
    vocab, made on the host and put on the card."""
    tokens = np.random.default_rng(seed).integers(0, VOCAB, (b, t))
    return (torch.tensor(tokens, device=DEVICE),
            torch.tensor((tokens + 1) % VOCAB, device=DEVICE))


def phase_train(params) -> tuple:
    """The full-width training step of bench.py bench_transformer on the
    card: a warm step and TRAIN_STEPS timed ones with both flash launch
    counters set to 0 just before and read just after, then two
    profiled steps (device busy time against the wall time of that
    same window).  Returns the report and the trained params."""
    from torch.profiler import ProfilerActivity, profile

    step = make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB, lr=TRAIN_LR,
                           loss_chunks=TRAIN_CHUNKS, device=DEVICE)
    ps = params_from_numpy(params, DEVICE)
    tokens, labels = _train_batch(SEED, TRAIN_B, TRAIN_T)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kflash.fwd_launches = kflash.bwd_launches = 0   # counts: 0 just before
    ps, loss = step(ps, tokens, labels)             # warm
    losses, events = [loss], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ps, loss = step(ps, tokens, labels)
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    fwd, bwd = kflash.fwd_launches, kflash.bwd_launches  # ... read after
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    steps = TRAIN_STEPS + 1
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    if fwd < steps * N_LAYERS or bwd < steps * N_LAYERS:
        fail(f"flash kernels launched fwd {fwd} / bwd {bwd} times over "
             f"{steps} steps x {N_LAYERS} layers")
    step_ms = float(np.median([s.elapsed_time(e) for s, e in events]))
    tokens_per_s = TRAIN_B * TRAIN_T / (step_ms / 1e3)

    def two_steps():
        nonlocal ps
        for _ in range(2):
            ps, _ = step(ps, tokens, labels)
        torch.cuda.synchronize()

    # busy and wall time from the same profiled window; device activity
    # only, as recording every host op would stretch the step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        two_steps()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / 2

    def kernel_ms(tag):
        return sum(e.self_device_time_total for e in device
                   if tag in e.key) / 1e3 / 2

    fwd_ms, bwd_ms = kernel_ms("flash_fwd_"), kernel_ms("flash_bwd_")
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    return {"phase": "train", "steps": steps, "timed_steps": TRAIN_STEPS,
            "shape": {"n_layers": N_LAYERS, "d": D, "heads": HEADS,
                      "ff": FF, "vocab": VOCAB, "b": TRAIN_B, "t": TRAIN_T,
                      "loss_chunks": TRAIN_CHUNKS, "lr": TRAIN_LR,
                      "compute": "bfloat16", "masters": "float32"},
            "losses": losses, "step_ms": step_ms,
            "tokens_per_s": tokens_per_s,
            "mfu": 6.0 * _n_matmul(N_LAYERS) * tokens_per_s / BF16_FLOPS,
            "peak_mem_bytes": peak,
            "fwd_launches": fwd, "bwd_launches": bwd,
            "profile": {"steps": 2, "wall_ms_per_step": wall_ms,
                        "device_busy_ms_per_step": busy_ms or None,
                        "device_idle_share":
                            (1 - busy_ms / wall_ms) if busy_ms else None,
                        "flash_fwd_ms_per_step": fwd_ms or None,
                        "flash_bwd_ms_per_step": bwd_ms or None,
                        "flash_share_of_busy":
                            (fwd_ms + bwd_ms) / busy_ms if busy_ms
                            else None,
                        "ops_per_step": sum(e.count for e in device) / 2,
                        "top_device": [
                            {"name": e.key[:80], "count": e.count,
                             "ms_per_step":
                                 e.self_device_time_total / 1e3 / 2}
                            for e in top]}}, ps


def phase_train_parity() -> dict:
    """Three steps at reduced depth and batch from one seed: on the card
    in f32 with TF32 off (the f32 kernels) against the port on the CPU
    (the plain versions), then on the card in bf16 against the card's
    f32 losses.  The control, the same f32 steps on the card with TF32
    on, must fall outside the f32 bands."""
    params = init_params(np.random.default_rng(SEED + 5), PARITY_LAYERS, D,
                         HEADS, FF, VOCAB)
    tokens, labels = _train_batch(SEED + 6, PARITY_B, PARITY_T)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)

    def run(device, cdt, allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        torch.backends.cudnn.allow_tf32 = allow_tf32
        step = make_train_step(None, PARITY_LAYERS, D, HEADS, FF, VOCAB,
                               lr=TRAIN_LR, compute_dtype=cdt,
                               loss_chunks=PARITY_CHUNKS, device=device)
        ps = params_from_numpy(params, device)
        losses = [float(step(ps, tokens, labels)[1]) for _ in range(3)]
        return losses, params_to_numpy(ps)

    try:
        card, card_params = run(DEVICE, torch.float32)
        cpu, cpu_params = run("cpu", torch.float32)
        card_bf16, bf16_params = run(DEVICE, torch.bfloat16)
        card_tf32, tf32_params = run(DEVICE, torch.float32, allow_tf32=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    def leaves(p):
        return [p["emb"], p["head"]] + [x for blk in p["blocks"]
                                        for x in blk.values()]

    def vs_cpu(losses, ps):
        """(max relative loss error, max abs param error) against the
        CPU's f32 run."""
        return (max(abs(a - b) / abs(b) for a, b in zip(losses, cpu)),
                max(float(np.abs(a - b).max())
                    for a, b in zip(leaves(ps), leaves(cpu_params))))

    loss_rel, param_err = vs_cpu(card, card_params)
    controls = {"card_tf32": vs_cpu(card_tf32, tf32_params),
                "card_bf16": vs_cpu(card_bf16, bf16_params)}
    bf16_rel = max(abs(a - b) / abs(b) for a, b in zip(card_bf16, card))
    out = {"phase": "train_parity",
           "shape": {"n_layers": PARITY_LAYERS, "d": D, "heads": HEADS,
                     "ff": FF, "vocab": VOCAB, "b": PARITY_B, "t": PARITY_T,
                     "loss_chunks": PARITY_CHUNKS, "lr": TRAIN_LR},
           "losses": {"card_f32": card, "cpu_f32": cpu,
                      "card_bf16": card_bf16, "card_tf32": card_tf32},
           "loss_rel_f32": loss_rel, "param_max_abs_f32": param_err,
           "controls_vs_cpu": {
               name: {"loss_rel": lr_, "param_max_abs": pe}
               for name, (lr_, pe) in controls.items()},
           "loss_rel_bf16_vs_f32": bf16_rel,
           "bands": {"loss_rel_f32": TRAIN_LOSS_RTOL,
                     "param_atol_f32": TRAIN_PARAM_ATOL,
                     "loss_rel_bf16": TRAIN_BF16_RTOL}}
    if not loss_rel <= TRAIN_LOSS_RTOL:
        fail(f"card f32 losses {card} vs cpu {cpu}: {loss_rel}")
    if not param_err <= TRAIN_PARAM_ATOL:
        fail(f"card f32 params vs cpu differ by {param_err}")
    tf32_loss, tf32_param = controls["card_tf32"]
    if tf32_loss <= TRAIN_LOSS_RTOL and tf32_param <= TRAIN_PARAM_ATOL:
        fail(f"the f32 bands pass the TF32 control: losses {tf32_loss}, "
             f"params {tf32_param}")
    if not bf16_rel <= TRAIN_BF16_RTOL:
        fail(f"card bf16 losses {card_bf16} vs f32 {card}: {bf16_rel}")
    return out


def phase_handoff(ps) -> dict:
    """The trained params through the LM package into a paged decoder on
    the card in f32; 8 greedy tokens from a 100-token prompt, each
    step's logits held against the training forward (make_logits_fn,
    flash forward kernel) on the growing sequence."""
    with tempfile.TemporaryDirectory() as tmp:
        pkg = export_lm(params_to_numpy(ps), os.path.join(tmp, "lm.npz"),
                        heads=HEADS)
        lm_params, _ = load_lm(pkg)
    root.common.engine.precision = "float32"
    try:
        dec = PagedKVDecoder(lm_params, heads=HEADS, max_len=MAX_LEN,
                             batch=1, page=PAGE, device=DEVICE)
    finally:
        root.common.engine.precision = "bfloat16"
    oracle = make_logits_fn(None, N_LAYERS, D, HEADS, FF, VOCAB,
                            compute_dtype=torch.float32, device=DEVICE)
    ps32 = params_from_numpy(lm_params, DEVICE)
    prompt = np.random.default_rng(SEED + 7).integers(
        0, VOCAB, HANDOFF_PROMPT).tolist()
    pages = dec.ledger.alloc(dec.pages_for(HANDOFF_PROMPT + HANDOFF_TOKENS))
    kv1, logits = dec.prefill(prompt)
    dec.adopt_paged(kv1, pages)
    pt = np.zeros((1, dec.view_bucket(len(pages))), np.int32)
    pt[0, :len(pages)] = pages
    seq, decoded, oracle_tokens, worst = list(prompt), [], [], 0.0
    for i in range(HANDOFF_TOKENS):
        want = oracle(ps32, np.asarray([seq]))[0, -1].cpu().numpy()
        if not np.isfinite(logits).all():
            fail("non-finite decoder logits in the handoff")
        worst = max(worst, float(np.abs(logits - want).max()))
        decoded.append(int(np.argmax(logits)))
        oracle_tokens.append(int(np.argmax(want)))
        seq.append(decoded[-1])
        if i + 1 < HANDOFF_TOKENS:
            logits = dec.decode_paged(pt, [len(seq) - 1], [decoded[-1]])[0]
    dec.ledger.release(pages)
    out = {"phase": "handoff", "prompt_len": HANDOFF_PROMPT,
           "tokens": decoded, "oracle_tokens": oracle_tokens,
           "max_abs_logit_diff": worst, "atol": HANDOFF_ATOL,
           "dtype": str(dec.dtype)}
    if decoded != oracle_tokens:
        fail(f"decoded {decoded} != oracle {oracle_tokens}")
    if worst > HANDOFF_ATOL:
        fail(f"decoder vs training-forward logits {worst} > "
             f"{HANDOFF_ATOL}")
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
    flash = phase_flash()
    emit(flash)
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
    emit(phase_parity(params))
    train, trained = phase_train(params)
    emit(train)
    emit(phase_train_parity())
    emit(phase_handoff(trained))
    emit({"kernels": [{
        "name": "paged_decode", "route": "cuda", "source": kdecode.SOURCE,
        "replaces": kdecode.REPLACES, "launches": serve["kernel_launches"],
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"], "library_ms": kernel["library_ms"],
    }] + [{
        "name": f"flash_attention_{half}", "route": "cuda",
        "source": kflash.SOURCE, "replaces": replaces,
        "launches": train[f"{half}_launches"],
        "max_abs_err": flash[half]["max_abs_err"], "ms": flash[half]["ms"],
        "plain_ms": flash[half]["plain_ms"],
        "bound_ms": flash[half]["bound_ms"],
        "bound_by": flash[half]["bound_by"],
        "library_ms": flash[half]["library_ms"],
    } for half, replaces in (("fwd", kflash.REPLACES_FWD),
                             ("bwd", kflash.REPLACES_BWD))],
        "first_stream": streams[0][:8],
        "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
