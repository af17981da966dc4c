"""One Kohonen SOM batch step as a hand-written Hopper kernel
(``csrc/kohonen.cu``).

Replaces ``znicz_tpu/ops/pallas/kohonen.py:72 som_step``: for ``x`` (B,
D), weights ``w`` (N, D) and grid ``coords`` (N, 2), all f32,
:func:`som_step` returns ``(new_w, winner)``.  The semantics are the TPU
kernel's (``:22-58``):

- squared distances as ``|x|^2 - 2 x·wᵀ + |w|^2`` in full f32 (no TF32,
  no bf16);
- the winner of a sample is the smallest index attaining its row minimum;
- the Gaussian neighbourhood of each winner over the grid, rows at or past
  ``bs`` contributing nothing;
- ``w + alpha (num - den w) / (den + 1)``, ``num = hᵀ x``, ``den = hᵀ 1``.

:func:`som_step_plain` is the plain PyTorch version of the same
arithmetic.  The wrapper runs it on CPU tensors only; on CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches (one
per step: one CUDA kernel on one cluster of :data:`RANKS` blocks) and
nothing else.  Importing this module needs no ``nvcc``: the library is
built at the first CUDA call.

:func:`som_plan` is the Python twin of the launch's plan in the source
(each rank's neurons, the chunk of samples, phase B's runs, the shared
memory); :func:`rank_winners` the cluster's reduction of per-rank
minima, and :func:`som_step_twin` the kernel's order of summation, both
in torch, for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.kernels.gemm import _bound_of

#: kernel launches since import (or since a caller reset them to 0)
launches = 0

#: the TPU kernel this replaces
REPLACES = "znicz_tpu/ops/pallas/kohonen.py:72"
SOURCE = "znicz_tpu_torch/csrc/kohonen.cu"

#: the cluster's blocks, threads a block, the largest chunk of samples and
#: a block's shared memory (``csrc/kohonen.cu`` kRanks, kThreads,
#: kMaxChunk, kSmemBudget)
RANKS, THREADS, MAX_CHUNK, SMEM_BUDGET = 8, 512, 2048, 232448

_lib = None


def _up4(v: int) -> int:
    return (v + 3) // 4 * 4


def _smem_floats(n: int, per: int, pp: int, dp: int, chunk: int,
                 slices: int, resident: bool, table: bool) -> int:
    """The kernel's ``Layout``: its shared-memory regions in floats, each
    rounded up to 4."""
    tiles = (pp // 4) * (dp // 4)
    sizes = [per * (dp + 4) if resident else 0,
             16 * tiles if resident else 0, per, per,
             2 * n if table else 0, dp * (chunk + 4), 4 * THREADS,
             4 * THREADS, 2 * RANKS * chunk, chunk]
    sizes += [0 if table else chunk] * 3
    sizes += [((n + 1) if table else chunk) * pp,
              slices * tiles * 20 if slices > 1 else 0]
    return sum(_up4(v) for v in sizes)


def som_plan(b: int, n: int, d: int) -> dict:
    """The launch's plan at x (b, d), w (n, d), as ``make_plan`` in
    ``csrc/kohonen.cu`` makes it: ``ranges``, each rank's neurons
    ``[lo, hi)``; ``chunk``, samples a chunk (the least 4·2^k covering b,
    at most MAX_CHUNK, halved until the layout fits); ``slices``, phase
    B's runs of a chunk's samples; ``resident``, W and its sums in shared
    memory (else in device memory); ``table``, h computed once a launch
    for every grid cell a winner can take (where n < chunk), else a
    chunk's samples at a time; ``smem_bytes``.  None where even a chunk
    of 4 does not fit."""
    per = -(-n // RANKS)
    pp, dp = _up4(per), _up4(d)
    first = 4
    while first < b and first < MAX_CHUNK:
        first *= 2
    tiles = (pp // 4) * (dp // 4)
    for resident in (True, False):
        chunk = first
        while chunk >= 4:
            slices, table = 1, n < chunk
            while 2 * slices * tiles <= THREADS and 2 * slices <= chunk // 4:
                slices *= 2
            nbytes = 4 * _smem_floats(n, per, pp, dp, chunk, slices,
                                      resident, table)
            if nbytes <= SMEM_BUDGET:
                return {"ranges": [(min(r * per, n), min(r * per + per, n))
                                   for r in range(RANKS)],
                        "per": per, "chunk": chunk, "slices": slices,
                        "resident": resident, "table": table,
                        "smem_bytes": nbytes}
            chunk //= 2
    return None


def rank_winners(d2, ranges):
    """The cluster's winners from distances ``d2`` (B, N): each rank's
    first minimum over its neurons (NaN never wins; none at all leaves
    (inf, N)), then the smaller distance of the ranks' pairs, on a tie
    the smaller index; N (an all-NaN row) becomes 0."""
    n = d2.shape[1]
    best = torch.full(d2.shape[:1], float("inf"), dtype=d2.dtype)
    arg = torch.full(d2.shape[:1], n, dtype=torch.int64)
    for lo, hi in ranges:
        part = d2[:, lo:hi]
        part = torch.where(part.isnan(), float("inf"), part)
        if hi > lo:
            m = part.amin(dim=1)
            j = torch.where(part == m[:, None],
                            torch.arange(lo, hi), n).amin(dim=1)
            j = torch.where(m < float("inf"), j, n)  # d2 < inf only wins
        else:
            m, j = torch.full_like(best, float("inf")), torch.full_like(
                arg, n)
        take = (m < best) | ((m == best) & (j < arg))
        best, arg = torch.where(take, m, best), torch.where(take, j, arg)
    return torch.where(arg < n, arg, 0)


def som_step_twin(x, w, coords, alpha: float, sigma: float, bs):
    """The step in the kernel's order, on CPU tensors: the plain
    version's distances and neighbourhood, winners by
    :func:`rank_winners`, and num and den summed as the kernel sums them
    (each chunk of :func:`som_plan`'s runs summed over its samples in
    order, the runs added in order, the chunk's sum added to the running
    sum).  The kernel fuses each product into its add (fmaf); here each
    is rounded apart, so the two differ by a rounding a term."""
    b, n = x.shape[0], w.shape[0]
    plan = som_plan(b, n, x.shape[1])
    x2 = (x * x).sum(dim=1, keepdim=True)
    d2 = x2 - 2.0 * (x @ w.t()) + (w * w).sum(dim=1)
    idx = rank_winners(d2, plan["ranges"])
    wc = coords[idx]
    g2 = (wc * wc).sum(dim=1, keepdim=True) - 2.0 * (wc @ coords.t()) + \
        (coords * coords).sum(dim=1)
    sig = torch.tensor(sigma, dtype=torch.float32)
    h = torch.exp(-g2 / (2.0 * sig * sig))
    h = torch.where(torch.arange(b)[:, None] < bs, h, 0.0)
    num, den = torch.zeros_like(w), torch.zeros(n, dtype=w.dtype)
    for b0 in range(0, b, plan["chunk"]):
        quads = -(-min(plan["chunk"], b - b0) // 4)
        runs = []
        for s in range(plan["slices"]):
            pn, pd = torch.zeros_like(w), torch.zeros_like(den)
            for q in range(s * quads // plan["slices"],
                           (s + 1) * quads // plan["slices"]):
                for r in range(b0 + 4 * q, min(b0 + 4 * q + 4, b)):
                    pn = pn + h[r][:, None] * x[r][None, :]
                    pd = pd + h[r]
            runs.append((pn, pd))
        cn, cd = runs[0]
        for pn, pd in runs[1:]:
            cn, cd = cn + pn, cd + pd
        num, den = num + cn, den + cd
    den = den[:, None]
    return w + alpha * (num - den * w) / (den + 1.0), idx.to(torch.int32)


def som_step_plain(x, w, coords, alpha: float, sigma: float, bs):
    """The plain PyTorch step: the TPU kernel's formulas, in f32."""
    n = w.shape[0]
    x2 = (x * x).sum(dim=1, keepdim=True)
    w2 = (w * w).sum(dim=1)
    d2 = x2 - 2.0 * (x @ w.t()) + w2
    col = torch.arange(n, device=x.device)
    idx = torch.where(d2 == d2.amin(dim=1, keepdim=True), col,
                      n).amin(dim=1)
    idx = torch.where(idx < n, idx, 0)          # an all-NaN row: 0
    wc = coords[idx]
    g2 = (wc * wc).sum(dim=1, keepdim=True) - 2.0 * (wc @ coords.t()) + \
        (coords * coords).sum(dim=1)
    sigma = torch.tensor(sigma, dtype=torch.float32)
    h = torch.exp(-g2 / (2.0 * sigma * sigma).to(x.device))
    row = torch.arange(x.shape[0], device=x.device)[:, None]
    h = torch.where(row < bs, h, 0.0)
    num = h.t() @ x
    den = h.sum(dim=0)[:, None]
    return w + alpha * (num - den * w) / (den + 1.0), idx.to(torch.int32)


def bound(x_shape, w_shape) -> dict:
    """The least time the card could take for one step: the larger of its
    flops over the f32 peak and its bytes (x, w and coords read once, the
    new weights and the winners written once) over the HBM rate.  Flops:
    the distances (2·B·N·D, |x|^2, |w|^2 and 3 a pair), the neighbourhood
    (9 a pair and the exp), the update's products (2·B·N·D + B·N) and 5
    an element of the new weights."""
    b, d = x_shape
    n = w_shape[0]
    flops = 4 * b * n * d + 2 * (b + n) * d + 13 * b * n + 5 * n * d
    nbytes = 4 * (b * d + 2 * n * d + 2 * n + b)
    return _bound_of(flops, nbytes)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("kohonen")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.znicz_som_step_f32.argtypes = [ptr] * 5 + [i32] * 4 + \
            [f32, f32, ptr]
        lib.znicz_som_step_f32.restype = i32
        for fn in (lib.znicz_som_plan, lib.znicz_som_clusters):
            fn.argtypes = [i32, i32, i32, ptr]
            fn.restype = i32
        lib.znicz_kohonen_error_string.argtypes = [i32]
        lib.znicz_kohonen_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, w, coords) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1] or \
            tuple(coords.shape) != (w.shape[0], 2):
        raise ValueError(f"need x (B, D), w (N, D), coords (N, 2); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(coords.shape)}")
    if min(x.shape[0], w.shape[0], x.shape[1]) < 1:
        raise ValueError("empty SOM step")
    for name, t in (("x", x), ("w", w), ("coords", coords)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (the kernel is full "
                             f"f32), not {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"som_step runs on cpu or cuda tensors, not "
                         f"{x.device.type}")
    if x.numel() >= 2 ** 31 or w.numel() >= 2 ** 31:
        raise ValueError("the kernel indexes with 32-bit ints")


def som_step(x, w, coords, alpha: float, sigma: float, bs):
    """One SOM batch step -> ``(new_w, winner)``: the plain version on CPU
    tensors, the kernel on CUDA tensors (on the current stream).  ``bs`` is
    the number of real rows (rows ``>= bs`` are padding)."""
    global launches
    _check(x, w, coords)
    bs = int(bs)
    if x.device.type == "cpu":
        return som_step_plain(x, w, coords, alpha, sigma, bs)
    new_w = torch.empty_like(w)
    winner = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    rc = _library().znicz_som_step_f32(
        x.data_ptr(), w.data_ptr(), coords.data_ptr(), new_w.data_ptr(),
        winner.data_ptr(), x.shape[0], w.shape[0], x.shape[1], bs,
        float(alpha), float(sigma),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = _library().znicz_kohonen_error_string(rc).decode()
        if som_plan(x.shape[0], w.shape[0], x.shape[1]) is None:
            msg += " (no chunk of samples fits a block's shared memory)"
        raise RuntimeError(f"som_step launch failed: {msg}")
    launches += 1
    return new_w, winner


def _card_ints(fn, b: int, n: int, d: int, count: int) -> list:
    out = (ctypes.c_int * count)()
    rc = fn(b, n, d, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        msg = _library().znicz_kohonen_error_string(rc).decode()
        raise RuntimeError(f"som plan at {(b, n, d)}: {msg}")
    return list(out)


def som_plan_on_card(b: int, n: int, d: int) -> dict:
    """``make_plan`` from ``csrc/kohonen.cu`` (``znicz_som_plan``) in
    :func:`som_plan`'s terms, for the smoke to hold one against the
    other."""
    per, _, _, chunk, slices, resident, table, smem = _card_ints(
        _library().znicz_som_plan, b, n, d, 8)
    return {"ranges": [(min(r * per, n), min(r * per + per, n))
                       for r in range(RANKS)],
            "per": per, "chunk": chunk, "slices": slices,
            "resident": bool(resident), "table": bool(table),
            "smem_bytes": smem}


def clusters_on_card(b: int, n: int, d: int) -> int:
    """How many of the step's clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``): 0 would never launch."""
    return _card_ints(_library().znicz_som_clusters, b, n, d, 1)[0]
