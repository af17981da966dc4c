"""Per-step span tracing into a bounded ring buffer, exportable as
Chrome-trace JSON (loads in ``chrome://tracing`` and Perfetto).

TensorFlow made the step timeline a first-class system feature (Abadi
et al., 2016); this is the native equivalent for the workflow plane:
``span("workflow.step", step=n)`` wraps one control-graph delivery,
``instant("resilience.fault", site=...)`` drops a point event, and
because the resilience plane emits its events into the SAME tracer, a
chaos restart or a NaN-guard trip lands on the same timeline as the
steps around it — post-hoc diagnosis reads one file instead of four
log formats.

Design constraints (pinned by tests/test_observe.py):

- **bounded**: events live in a ``deque(maxlen=capacity)`` ring — a
  10k-step soak holds memory flat and keeps the newest window;
- **cheap**: one ring append per span (events are stored as plain
  tuples, serialization happens only at export); a disabled tracer
  returns a shared no-op span object, so the off cost is one global
  load + one truthiness test;
- **deterministic**: the tracer never touches the PRNG or published
  training state — metric histories are bit-exact with tracing on,
  off, or toggled mid-run.

Export is the Chrome trace-event JSON array format: ``X`` (complete)
events for spans, ``i`` (instant) events for point events, ``M``
metadata rows naming the process and threads.  Timestamps are
microseconds on a per-tracer monotonic origin.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

#: default ring capacity — ~3 MB of tuples at the worst case, a few
#: thousand training steps of window with per-step spans on
DEFAULT_CAPACITY = 65536


class _Span:
    """Reusable-shape active span: records an ``X`` event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        tracer = self._tracer
        tracer._events.append(
            ("X", self._name, (self._t0 - tracer._origin) * 1e6,
             (t1 - self._t0) * 1e6, threading.get_ident(), self._args))


class _NoopSpan:
    """Shared singleton handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoopSpan()


class Tracer:
    """Bounded ring of trace events; see module docstring."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = True) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._origin = time.perf_counter()
        # deque appends are atomic under the GIL — spans from the
        # prefetch worker, HTTP threads and the control walk interleave
        # without a lock on the hot path
        self._events: deque = deque(maxlen=self.capacity)

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing one region:
        ``with tracer.span("workflow.step", step=n): ...``"""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, args or None)

    def complete(self, name: str, start: float, duration: float,
                 args: Optional[dict] = None, tid: Optional[int] = None,
                 **kw) -> None:
        """Record an already-timed span: ``start`` is a
        ``time.perf_counter()`` stamp, ``duration`` in seconds — the
        workflow run loop times deliveries once and feeds both the
        step-latency histogram and the trace from the same reads.
        ``args`` takes a PRE-BUILT (reusable) dict so the per-signal
        path allocates only the event tuple; kwargs remain for cold
        callers.  ``tid`` overrides the recorded thread id with a
        synthetic track — the serving plane's per-request phase spans
        (queue/prefill/decode/stream) share one
        ``federation.request_track(rid)`` row so concurrent requests'
        overlapping phases render as parallel tracks in Perfetto
        instead of colliding on the worker thread's row."""
        if not self.enabled:
            return
        self._events.append(
            ("X", name, (start - self._origin) * 1e6, duration * 1e6,
             tid if tid is not None else threading.get_ident(),
             kw or args))

    def instant(self, name: str, **args) -> None:
        """Point event (fault fired, recompile, restart, ...)."""
        if not self.enabled:
            return
        self._events.append(
            ("i", name, (time.perf_counter() - self._origin) * 1e6,
             0.0, threading.get_ident(), args or None))
        # observability satellites share one machine-readable stream:
        # rare point events also land as log records, so a JSONL log
        # sink (core/logger.py configure(jsonl_path=...)) interleaves
        # them with ordinary log lines
        from znicz_tpu_torch.core import logger as _logger

        _logger.event_log(name, args)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # -- export --------------------------------------------------------------
    @staticmethod
    def _format_event(event: tuple, pid: int) -> dict:
        ph, name, ts, dur, tid, args = event
        ev = {"ph": ph, "pid": pid, "tid": tid, "name": name,
              "ts": round(ts, 3), "cat": name.split(".", 1)[0]}
        if ph == "X":
            ev["dur"] = round(dur, 3)
        else:
            ev["s"] = "t"              # instant scoped to its thread
        if args:
            ev["args"] = args
        return ev

    def tail(self, n: int) -> list:
        """Newest ``n`` ring events as Chrome-trace dicts (no metadata
        rows) — the flight recorder's span window around a crash."""
        events = list(self._events)    # atomic snapshot of the ring
        pid = os.getpid()
        return [self._format_event(e, pid) for e in events[-n:]]

    def export_dict(self) -> dict:
        """Chrome trace JSON document (``{"traceEvents": [...]}``).
        Carries two fleet-merge anchors on top of the Chrome schema
        (extra top-level keys are ignored by Perfetto): ``rank`` (the
        elastic fleet env, None outside a fleet) and
        ``origin_unix_ts`` — the wall-clock instant of this tracer's
        ``ts == 0``, so ``federation.merge_traces`` can align N
        workers' monotonic clocks onto one timeline."""
        pid = os.getpid()
        events = list(self._events)   # atomic snapshot of the ring
        tids = {}
        out = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": "znicz_tpu"}}]
        for t in threading.enumerate():
            tids[t.ident] = t.name
        for event in events:
            out.append(self._format_event(event, pid))
        for ident, tname in tids.items():
            out.append({"ph": "M", "pid": pid, "tid": ident,
                        "name": "thread_name", "args": {"name": tname}})
        from znicz_tpu_torch.observe.federation import fleet_rank

        origin_unix = time.time() - (time.perf_counter() - self._origin)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "rank": fleet_rank(),
                "origin_unix_ts": round(origin_unix, 6)}

    def export(self, path: str) -> int:
        """Write the Chrome-trace JSON to ``path``; returns the number
        of trace events written (metadata rows excluded)."""
        doc = self.export_dict()
        n = sum(1 for e in doc["traceEvents"] if e["ph"] != "M")
        with open(path, "w") as f:
            json.dump(doc, f)
        return n


#: THE process-global tracer (mirrors registry.REGISTRY).
TRACER = Tracer()


def span(name: str, **args):
    return TRACER.span(name, **args)


def instant(name: str, **args) -> None:
    TRACER.instant(name, **args)


def export_trace(path: str) -> int:
    return TRACER.export(path)
