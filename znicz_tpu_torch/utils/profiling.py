"""Profiler-trace summarization — the read side of the ``--profile``
flag, the port of ``znicz_tpu/utils/profiling.py``: a trace directory
into the "top ops by device time" table.

The reference reads the ``.xplane.pb`` files ``jax.profiler`` writes;
the port reads the Chrome traces ``torch.profiler`` writes
(``*.pt.trace.json``, optionally gzipped), a recorded divergence.  The
device events (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) are
summed when the trace has any; a CPU-only trace sums its ``cpu_op``
events (``aten::`` and the like) instead.  As in the reference, the
newest run directory under the trace directory is the one summarized
(a multi-process run writes one file per process into the same run
directory).

:func:`compare_traces` diffs two runs by kernel family
(:func:`_category`): the port's own kernels by their ``csrc/`` names,
cuDNN, cuBLAS, NCCL, and ``aten::`` operators — a recorded divergence
from the reference's HLO op classes.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os

#: Chrome-trace categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the trace files ``torch.profiler`` writes
TRACE_PATTERNS = ("*.pt.trace.json", "*.pt.trace.json.gz")


def _newest_run_files(logdir: str) -> list[str]:
    """All trace files of the NEWEST run directory (a multi-process
    trace writes one file per process under the same run dir —
    summarizing a single file would show one arbitrary process)."""
    files = [f for pat in TRACE_PATTERNS for f in glob.glob(
        os.path.join(logdir, "**", pat), recursive=True)]
    if not files:
        return []
    by_run: dict[str, list[str]] = collections.defaultdict(list)
    for f in files:
        by_run[os.path.dirname(f)].append(f)
    newest = max(by_run, key=lambda d: max(os.path.getmtime(f)
                                           for f in by_run[d]))
    return sorted(by_run[newest])


def _events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    return doc.get("traceEvents", []) if isinstance(doc, dict) else doc


def summarize_trace(logdir: str, top: int | None = 25) -> list[dict]:
    """-> rows ``{"op", "total_ms", "count"}`` sorted by total device
    time, aggregated over every process of the newest trace run under
    ``logdir`` (host ``cpu_op`` time when the trace holds no device
    event).  ``top=None`` returns the full untruncated list."""
    files = _newest_run_files(logdir)
    if not files:
        raise FileNotFoundError(f"no .pt.trace.json under {logdir!r} — "
                                f"pass the directory given to --profile")
    device: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    host: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for path in files:
        for ev in _events(path):
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat")
            agg = device if cat in DEVICE_CATS else \
                host if cat == "cpu_op" else None
            if agg is None:
                continue
            entry = agg[ev.get("name", "?")]
            entry[0] += float(ev.get("dur", 0.0))
            entry[1] += 1
    rows = [{"op": op, "total_ms": us / 1e3, "count": count}
            for op, (us, count) in (device or host).items()]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows if top is None else rows[:top]


def format_summary(rows: list[dict]) -> str:
    """Rows -> aligned text table (logged by the Launcher after a
    profiled run)."""
    if not rows:
        return "(empty trace)"
    width = max(len(r["op"]) for r in rows)
    lines = [f"{'total_ms':>10}  {'count':>7}  op"]
    lines += [f"{r['total_ms']:10.3f}  {r['count']:7d}  "
              f"{r['op']:<{width}}" for r in rows]
    return "\n".join(lines)


#: the port's kernels (``csrc/*.cu``) by family: a name holding the
#: key belongs to the family
PORT_KERNELS = (
    ("gemm_f32_kernel", "gemm_fc"), ("gemm_reduce_kernel", "gemm_fc"),
    ("act_backward_f32_kernel", "act_backward"),
    ("sgd_kernel", "sgd"), ("adam_multi_kernel", "adam"),
    ("lrn_fwd", "lrn"), ("lrn_bwd", "lrn"),
    ("dropout_", "dropout"), ("flash_fwd", "flash"), ("flash_bwd", "flash"),
    ("paged_decode", "paged_decode"), ("conv_fwd", "conv"),
    ("conv_input_grad", "conv"), ("conv_weight_grad", "conv"),
    ("reduce_splits_kernel", "conv"), ("som_step", "kohonen"),
    ("stochastic_pool", "stochastic_pool"))


def _category(op: str) -> str:
    """Kernel or operator name -> coarse family for cross-trace
    comparison (template arguments and launch shapes differ between
    runs; family totals are stable)."""
    for key, family in PORT_KERNELS:
        if key in op:
            return family
    low = op.lower()
    if "cudnn" in low or low.startswith(("sm90_xmma_fprop",
                                         "sm90_xmma_dgrad",
                                         "sm90_xmma_wgrad")):
        return "cudnn"
    if "nccl" in low:
        return "nccl"
    if "cublas" in low or "gemm" in low or "cutlass" in low:
        return "cublas"
    if op.startswith("aten::"):
        return "aten"
    if low.startswith(("memcpy", "memset")):
        return low.split(" ")[0]
    name = op.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].strip()[:24] or op[:24]


def compare_traces(logdir_a: str, logdir_b: str,
                   top: int | None = None) -> list[dict]:
    """Family-level device-time diff of two profiled runs (A = before,
    B = after) -> rows ``{"category", "a_ms", "b_ms", "delta_ms"}``
    sorted by |delta|.  Family totals aggregate the FULL op list by
    default.  A family present in only ONE trace is a legitimate diff
    outcome: its missing side reads 0.0 and the whole total lands in
    ``delta_ms``."""
    out: dict[str, list] = collections.defaultdict(lambda: [0.0, 0.0])
    for i, logdir in enumerate((logdir_a, logdir_b)):
        for r in summarize_trace(logdir, top=top):
            out[_category(r["op"])][i] += r["total_ms"]
    rows = [{"category": k, "a_ms": round(a, 2), "b_ms": round(b, 2),
             "delta_ms": round(b - a, 2)} for k, (a, b) in out.items()]
    rows.sort(key=lambda r: -abs(r["delta_ms"]))
    return rows
