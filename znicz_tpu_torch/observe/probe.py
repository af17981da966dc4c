"""Automatic instrumentation hooks wiring the runtime into the registry
and tracer.

The production code calls these at fixed sites, mirroring the
resilience plane's ``fault_hook`` discipline:

====================  =====================================================
hook                  call site
====================  =====================================================
``unit_observers``    ``core/units.py :: Unit._timed_run`` — donates
                      per-unit run counts/seconds into
                      ``znicz_unit_runs_total`` / ``znicz_unit_run_
                      seconds_total`` (labels: workflow, unit); the
                      registry children ARE what ``timing_table()`` reads
``step_histogram``    ``core/workflow.py`` run loop — per signal-delivery
                      wall time into ``znicz_workflow_step_seconds``
``watch_compiles`` /  ``parallel/step.py`` registers its jitted
``check_recompiles``  functions; the workflow loop polls their
                      ``_cache_size()`` sum — a positive delta increments
                      ``znicz_recompiles_total{fn}`` and drops a
                      ``compile.recompile`` instant on the trace timeline
``staged_bytes``      ``pipeline/prefetcher.py`` worker — H2D staging
                      volume (counter) + per-pipeline live gauges
``resilience_event``  ``resilience/{faults,retry,supervisor,health}.py``
                      — every fault firing / retry / restart / NaN-guard
                      action lands as a counter increment AND an instant
                      event, so failures correlate with steps on one
                      timeline
``compile_cache_      ``compilecache.py``'s jax monitoring listener —
event``               every persistent compilation-cache consultation
                      lands in ``znicz_compile_cache_{hits,misses}_
                      total`` so warm-vs-cold boot is a counter delta
====================  =====================================================

All hooks early-out on ``observe.set_enabled(False)`` (one module-global
load), which is how the ``metrics_overhead`` bench measures the bare
path and how determinism tests pin "instrumentation off == seed path".
"""

from __future__ import annotations

import time
import weakref
from typing import Optional

from znicz_tpu_torch.observe import registry as _reg
from znicz_tpu_torch.observe import trace as _trace

# -- enable/disable (module-global; also flips the tracer) -------------------

_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(flag: bool) -> None:
    """Master switch for every automatic probe AND the global tracer —
    registry families stay registered (their values simply stop moving),
    so a scrape during a disabled window still parses."""
    global _enabled
    _enabled = bool(flag)
    if flag:
        _trace.TRACER.enable()
    else:
        _trace.TRACER.disable()


# -- workflow plane ----------------------------------------------------------

_UNIT_RUNS = _reg.counter(
    "znicz_unit_runs_total", "control-graph unit firings",
    labelnames=("workflow", "unit"))
_UNIT_SECONDS = _reg.counter(
    "znicz_unit_run_seconds_total", "wall seconds inside unit.run()",
    labelnames=("workflow", "unit"))
_STEP_SECONDS = _reg.histogram(
    "znicz_workflow_step_seconds",
    "wall time of one control-graph signal delivery")
_SIGNALS = _reg.counter(
    "znicz_workflow_signals_total", "control-graph signals dispatched")
_WORKFLOW_RUNS = _reg.counter(
    "znicz_workflow_runs_total", "Workflow.run invocations",
    labelnames=("workflow",))


def unit_observers(workflow_name: str, unit_name: str):
    """(runs_counter, seconds_counter) children for one unit — cached by
    the unit itself so the hot path is one :func:`unit_run` call."""
    return (_UNIT_RUNS.labels(workflow=workflow_name, unit=unit_name),
            _UNIT_SECONDS.labels(workflow=workflow_name, unit=unit_name))


def unit_run(obs, dt_s: float) -> None:
    """Donate one unit firing: both children share the registry lock, so
    taking it ONCE for the pair halves the hot-path lock traffic (the
    metrics_overhead budget is per-microsecond at signal granularity)."""
    runs, secs = obs
    with runs._lock:
        runs.value += 1.0
        secs.value += dt_s


def unit_timing_rows(workflow_name: str, unit_names) -> list:
    """``timing_table()``'s data source: ``(seconds, runs, unit)`` rows
    from the registry for one workflow's units.  Counters are
    process-lifetime (Prometheus semantics), so a supervised restart's
    table shows the CUMULATIVE cost across attempts — by design: that is
    the number a restart storm inflates.  Units sharing a name merge."""
    rows = []
    for name in dict.fromkeys(unit_names):          # dedupe, keep order
        runs = _UNIT_RUNS.labels(workflow=workflow_name, unit=name).get()
        secs = _UNIT_SECONDS.labels(workflow=workflow_name,
                                    unit=name).get()
        rows.append((secs, int(runs), name))
    return rows


def step_histogram():
    return _STEP_SECONDS


def signal_dispatched(dt_s: float) -> None:
    """One control-graph delivery took ``dt_s`` wall seconds.  Only the
    histogram moves per signal; ``znicz_workflow_signals_total`` is
    batch-incremented per run (:func:`signals_add`) — one fewer lock
    round-trip on the per-signal path."""
    _STEP_SECONDS.observe(dt_s)


def signals_add(n: int) -> None:
    """Batch-donate ``n`` dispatched signals (called once per
    Workflow.run with the walk's delta)."""
    if n:
        _SIGNALS.inc(n)


def workflow_run(workflow_name: str) -> None:
    _WORKFLOW_RUNS.labels(workflow=workflow_name).inc()


# -- recompile detection -----------------------------------------------------

_RECOMPILES = _reg.counter(
    "znicz_recompiles_total",
    "XLA compile-cache growth observed on watched jitted functions",
    labelnames=("fn",))

#: key -> [tuple of weakrefs to jitted fns, last observed cache-size
#: sum, metric label].  Weak refs: a watched step that dies (dropped
#: workflow, supervised-restart rebuild) stops being polled and its
#: entry is reaped on the next poll, so two live steps never fight over
#: one key and dead ones never pin their compiled programs in memory.
_watched: dict[str, list] = {}


def watch_compiles(key: str, *fns, label: Optional[str] = None) -> None:
    """Register jitted function(s) for compile-cache delta polling.
    ``key`` must be unique per watched OBJECT (two live FusedTrainSteps
    in one process each keep their own watch); ``label`` is the
    ``znicz_recompiles_total{fn=...}`` label and defaults to ``key`` —
    instances of one class share a label while keeping separate
    baselines.  Functions without ``_cache_size`` (older jax, non-jit
    callables) are ignored.  A warm function registers its current
    cache size as the baseline, so only growth counts."""
    refs = tuple(weakref.ref(f) for f in fns
                 if hasattr(f, "_cache_size"))
    if not refs:
        return
    _watched[key] = [refs, _cache_total(refs), label or key]


def unwatch_compiles(key: str) -> None:
    _watched.pop(key, None)


def _cache_total(refs) -> Optional[int]:
    """Cache-size sum over the still-living functions; None when every
    ref is dead (the entry should be reaped)."""
    total, alive = 0, False
    for ref in refs:
        fn = ref()
        if fn is None:
            continue
        alive = True
        try:
            total += int(fn._cache_size())
        except Exception:  # noqa: BLE001 — a torn-down backend must not
            pass           # crash the run loop polling it
    return total if alive else None


def check_recompiles() -> int:
    """Poll watched functions; returns newly observed compiles.  The
    FIRST compile of a fresh function counts too — a steady-state loop
    asserts the counter moves exactly once per function, and the pinned
    zero-recompile tests keep holding because they compare cache sizes
    directly."""
    if not _watched or not _enabled:
        return 0
    new = 0
    for key, entry in list(_watched.items()):
        total = _cache_total(entry[0])
        if total is None:                 # every watched fn died
            _watched.pop(key, None)
            continue
        delta = total - entry[1]
        if delta > 0:
            entry[1] = total
            new += delta
            _RECOMPILES.labels(fn=entry[2]).inc(delta)
            _trace.instant("compile.recompile", fn=entry[2], new=delta,
                           cache_size=total)
        elif delta < 0:
            # a subset of the fns died (or a cache was cleared): rebase
            # so the shrink is not later mistaken for absence of growth
            entry[1] = total
    return new


# -- cold-compile timing -----------------------------------------------------

_COMPILE_SECONDS = _reg.histogram(
    "znicz_compile_seconds",
    "cold-path XLA compile wall time: first call of a wrapped jitted "
    "program, or a serve-engine bucket materializing",
    labelnames=("fn",))


def compile_observed(label: str, dt_s: float, **args) -> None:
    """One cold compile (+ first execution) took ``dt_s`` wall seconds:
    histogram observation plus a ``compile.cold`` complete-span on the
    trace timeline, so the ROADMAP compile-latency work lands with its
    baseline already recorded."""
    if not _enabled:
        return
    _COMPILE_SECONDS.labels(fn=label).observe(dt_s)
    _trace.TRACER.complete("compile.cold", time.perf_counter() - dt_s,
                           dt_s, fn=label, **args)


class _CompileTimed:
    """Thin wrapper over a jitted callable: the FIRST invocation — the
    trace+compile+run cold path — is timed into ``znicz_compile_seconds
    {fn=label}``; every later call is one attribute check of passthrough.
    ``_cache_size`` delegates so :func:`watch_compiles` keeps polling the
    real compile cache through the wrapper."""

    __slots__ = ("_fn", "_label", "_cold", "__weakref__")

    def __init__(self, fn, label: str) -> None:
        self._fn = fn
        self._label = label
        self._cold = True

    def _cache_size(self) -> int:
        size = getattr(self._fn, "_cache_size", None)
        return int(size()) if size is not None else 0

    def __call__(self, *args, **kw):
        if not self._cold:
            return self._fn(*args, **kw)
        self._cold = False
        t0 = time.perf_counter()
        out = self._fn(*args, **kw)
        compile_observed(self._label, time.perf_counter() - t0)
        return out


def time_compiles(label: str, fn):
    """Wrap ``fn`` (a jitted program) so its first call lands in the
    compile-time histogram; ``None`` passes through for optional
    programs."""
    if fn is None:
        return None
    return _CompileTimed(fn, label)


# -- persistent compilation cache ------------------------------------------

_CACHE_HITS = _reg.counter(
    "znicz_compile_cache_hits_total",
    "persistent XLA compilation-cache hits (an executable was loaded "
    "from disk instead of compiled)")
_CACHE_MISSES = _reg.counter(
    "znicz_compile_cache_misses_total",
    "persistent compilation-cache misses — cold compiles; feeds "
    "watchtower.recompile_storm when pointed at this family")


def compile_cache_event(kind: str) -> None:
    """One cache consultation, fed by ``compilecache``'s jax monitoring
    listener.  ``kind``: ``hit`` | ``miss``.  Counted even while probes
    are disabled: the warm-vs-cold contract (tests, the
    ``compile_latency`` bench, t1's zero-JIT smoke) must stay assertable
    through an ``observe.set_enabled(False)`` window, and a compile is
    not on any per-signal hot path."""
    (_CACHE_HITS if kind == "hit" else _CACHE_MISSES).inc()


def compile_cache_stats() -> tuple:
    """Lifetime ``(hits, misses)`` — scenario lines and the serve
    warmup summary report deltas of these."""
    return int(_CACHE_HITS.get()), int(_CACHE_MISSES.get())


# -- ZeRO sharding plane --------------------------------------------------

_ZERO_PARAM_BYTES = _reg.gauge(
    "znicz_zero_param_bytes",
    "per-chip bytes of persistent model parameters held by a fused "
    "train step (full when replicated; 1/n flat shards + padding under "
    "shard_params)", labelnames=("unit",))
_ZERO_OPT_BYTES = _reg.gauge(
    "znicz_zero_opt_state_bytes",
    "per-chip bytes of persistent optimizer/EMA state held by a fused "
    "train step (1/n flat shards under shard_update/shard_params)",
    labelnames=("unit",))
_ZERO_GATHERED = _reg.counter(
    "znicz_zero_gathered_bytes_total",
    "bytes all-gathered on demand to materialize full weights for a "
    "forward/backward dispatch under shard_params",
    labelnames=("unit",))


def zero_memory(unit: str, param_bytes: int, opt_bytes: int) -> None:
    """Per-chip persistent-state accounting, set once per step build.
    Recorded even while probes are disabled (the compile_cache_event
    precedent): the memory contract must stay assertable through a
    bench's bare arm, and a step build is never on the per-signal hot
    path."""
    _ZERO_PARAM_BYTES.labels(unit=unit).set(float(param_bytes))
    _ZERO_OPT_BYTES.labels(unit=unit).set(float(opt_bytes))


def zero_gather_counter(unit: str):
    """Cached child handle for the per-dispatch gathered-bytes counter
    (the step increments it on its hot path — one ``inc`` per dispatch,
    gated on :func:`enabled` by the caller)."""
    return _ZERO_GATHERED.labels(unit=unit)


# -- quantized collectives ------------------------------------------------

#: ``collective`` label values: "grad_psum" (the explicit gradient
#: reduction) and "zero_gather" (the shard_params regather chain)
_QCOMM_WIRE = _reg.counter(
    "znicz_qcomm_bytes_on_wire_total",
    "bytes actually shipped by quantized collectives (int8/bf16 payload "
    "+ per-chunk scales), per unit and collective site",
    labelnames=("unit", "collective"))
_QCOMM_EXACT = _reg.counter(
    "znicz_qcomm_bytes_exact_total",
    "bytes the SAME collectives would have shipped unquantized (f32) — "
    "the before to znicz_qcomm_bytes_on_wire_total's after",
    labelnames=("unit", "collective"))
_QCOMM_RATIO = _reg.gauge(
    "znicz_qcomm_compression_ratio",
    "exact/wire byte ratio of a quantized collective (~4 for int8 with "
    "the default chunk, 2 for bf16); set once per step build",
    labelnames=("unit", "collective"))
_QCOMM_RESIDUAL = _reg.gauge(
    "znicz_qcomm_residual_norm",
    "L2 norm of the error-feedback residual tree carried by a fused "
    "train step (quantization error deferred into the next step)",
    labelnames=("unit",))


def qcomm_ratio(unit: str, collective: str, wire_bytes: int,
                exact_bytes: int) -> None:
    """Static per-dispatch compression figure, set once per step build.
    Recorded even while probes are disabled (the zero_memory precedent:
    the wire contract must stay assertable through a bench's bare arm,
    and a build is never on the per-signal hot path)."""
    _QCOMM_RATIO.labels(unit=unit, collective=collective).set(
        float(exact_bytes) / max(float(wire_bytes), 1.0))


def qcomm_counters(unit: str, collective: str) -> tuple:
    """Cached ``(wire, exact)`` counter children for one collective site
    (the step increments both per dispatch, gated on :func:`enabled`)."""
    return (_QCOMM_WIRE.labels(unit=unit, collective=collective),
            _QCOMM_EXACT.labels(unit=unit, collective=collective))


def qcomm_residual_norm(unit: str, value: float) -> None:
    """Error-feedback residual L2 norm (published at class-pass ends —
    the caller owns the device reduction and the :func:`enabled` gate)."""
    _QCOMM_RESIDUAL.labels(unit=unit).set(float(value))


# -- pipeline plane ----------------------------------------------------------

_BYTES_STAGED = _reg.counter(
    "znicz_pipeline_bytes_staged_total",
    "host bytes shipped through prefetch stagers")


def staged_bytes(nbytes: int) -> None:
    if _enabled:
        _BYTES_STAGED.inc(nbytes)


# -- resilience plane --------------------------------------------------------

_RESILIENCE = _reg.counter(
    "znicz_resilience_events_total",
    "resilience-plane events (fault fired, retry, restart, hang, "
    "nan_guard, snapshot_resume)", labelnames=("kind", "site"))


def resilience_event(kind: str, site: str = "", **args) -> None:
    """Counter + same-timeline instant event for one resilience action.
    ``kind``: fault | retry | restart | hang | nan_guard |
    snapshot_resume; ``site`` is the fault-plan site / fn name / '' when
    not site-shaped."""
    if not _enabled:
        return
    _RESILIENCE.labels(kind=kind, site=site).inc()
    _trace.instant(f"resilience.{kind}", site=site, **args)


# -- elastic fleet ---------------------------------------------------------

_ELASTIC_RESTARTS = _reg.counter(
    "znicz_elastic_restarts_total",
    "elastic fleet restart rounds (a worker died or hung; the remainder "
    "was killed and the fleet relaunched)")
_ELASTIC_DEATHS = _reg.counter(
    "znicz_elastic_worker_deaths_total",
    "worker processes observed dead without being asked to stop",
    labelnames=("cause",))
_ELASTIC_RESUMES = _reg.counter(
    "znicz_elastic_resumes_total",
    "fleet relaunches that resumed from a valid snapshot (vs cold "
    "restarts)")
_ELASTIC_WORLD = _reg.gauge(
    "znicz_elastic_world_size",
    "worker-process count of the currently running fleet round (0 when "
    "no fleet is up)")


def elastic_event(kind: str, **args) -> None:
    """One elastic-fleet lifecycle event: counter + timeline instant.
    ``kind``: restart | resume | worker_death (``cause`` = exit |
    signal | hung | boot | wedged).  Counted in the SUPERVISOR process
    — workers keep their own registries."""
    if not _enabled:
        return
    if kind == "worker_death":
        _ELASTIC_DEATHS.labels(cause=args.get("cause", "exit")).inc()
    elif kind == "restart":
        _ELASTIC_RESTARTS.inc()
    elif kind == "resume":
        _ELASTIC_RESUMES.inc()
    _trace.instant(f"elastic.{kind}", **args)


def elastic_world_size(n: int) -> None:
    """Gauge: the fleet's live world size (set at each round launch,
    zeroed when the fleet returns)."""
    _ELASTIC_WORLD.set(float(n))


def elastic_counts() -> dict:
    """Lifetime elastic counters — the drill asserts these match its
    event counts."""
    deaths = sum(child.get() for _, child in _ELASTIC_DEATHS.items())
    return {"restarts": int(_ELASTIC_RESTARTS.get()),
            "worker_deaths": int(deaths),
            "resumes": int(_ELASTIC_RESUMES.get()),
            "world_size": int(_ELASTIC_WORLD.get())}


# -- step anatomy ------------------------------------------------------------


def anatomy_phase(plane: str, phase: str, dt_s: float,
                  t0: Optional[float] = None) -> None:
    """One already-timed anatomy phase from a producer that owns its
    own clock (prefetcher input-wait/stage, the continuous batcher's
    prefill/decode/verify).  Thin delegate so producers only import
    probe; the import is lazy to keep anatomy off probe's module-load
    path."""
    if not _enabled:
        return
    from znicz_tpu_torch.observe import anatomy as _anatomy
    _anatomy.observe_phase(plane, phase, dt_s, t0=t0)


# -- goodput ledger (supervisor-side, like the elastic plane) --------------

_GOODPUT_PRODUCTIVE = _reg.counter(
    "znicz_goodput_productive_seconds_total",
    "per-rank wall seconds the elastic fleet spent making step progress "
    "(completed rounds + failed-round time covered by a later-valid "
    "snapshot)", labelnames=("rank",))
_GOODPUT_LOST = _reg.counter(
    "znicz_goodput_lost_seconds_total",
    "per-rank wall seconds of work discarded by a failure (failed-round "
    "time past the newest valid snapshot — recomputed after restart)",
    labelnames=("rank",))
_GOODPUT_SNAPSHOT = _reg.counter(
    "znicz_goodput_snapshot_seconds_total",
    "per-rank wall seconds inside teardown/snapshot grace windows "
    "(SIGTERM grace, snapshot-then-exit)", labelnames=("rank",))
_GOODPUT_IDLE = _reg.counter(
    "znicz_goodput_idle_seconds_total",
    "per-rank wall seconds with no fleet running (spawn windows, "
    "restart backoff, flight dumps)", labelnames=("rank",))
_GOODPUT_RATIO = _reg.gauge(
    "znicz_goodput_ratio",
    "productive / (productive + lost + snapshot + idle) over the "
    "supervisor's lifetime — the fleet-level goodput figure")

_GOODPUT = {"productive": _GOODPUT_PRODUCTIVE, "lost": _GOODPUT_LOST,
            "snapshot": _GOODPUT_SNAPSHOT, "idle": _GOODPUT_IDLE}


def goodput_pretouch(ranks) -> None:
    """Materialize every goodput child before the first fleet sample
    (the fleet delta-rule lesson: a rule needs a 0 baseline)."""
    for rank in ranks:
        for fam in _GOODPUT.values():
            fam.labels(rank=str(rank)).inc(0.0)
    _GOODPUT_RATIO.set(0.0)


def goodput_note(category: str, rank, dt_s: float) -> None:
    """Donate ``dt_s`` wall seconds of ``category`` (productive | lost |
    snapshot | idle) for one rank.  Recorded even while probes are
    disabled (the zero_memory precedent): the goodput drill must stay
    assertable through a bench's bare arm, and the supervisor's round
    bookkeeping is never on a per-signal hot path."""
    if dt_s <= 0.0:
        return
    fam = _GOODPUT.get(category)
    if fam is None:
        raise ValueError(f"unknown goodput category: {category!r}")
    fam.labels(rank=str(rank)).inc(float(dt_s))
    total = sum(child.get() for f in _GOODPUT.values()
                for _, child in f.items())
    if total > 0.0:
        _GOODPUT_RATIO.set(
            sum(c.get() for _, c in _GOODPUT_PRODUCTIVE.items()) / total)


def goodput_totals() -> dict:
    """Per-category second sums across ranks — what the elastic drill
    reconciles against supervisor wall time."""
    return {cat: float(sum(child.get() for _, child in fam.items()))
            for cat, fam in _GOODPUT.items()}
