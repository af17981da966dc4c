"""Generative serving telemetry — the counterpart of
``znicz_tpu/serve/metrics.py`` for the generate plane.

Everything is stdlib + O(1) per event: a fixed-bucket TTFT histogram
(p50/p95/p99 read off the cumulative bucket counts, no per-request
sample retention), admission / completion / failure counters, slot and
queue gauges, arena-page occupancy and tokens/sec over a sliding
window.  ``snapshot()`` returns a plain JSON-able dict — the wire schema
served by ``GET /metrics``; the same events are mirrored into the
process-global registry as the ``znicz_generate_*`` family.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from znicz_tpu_torch.observe import probe as _probe
from znicz_tpu_torch.observe import registry as _metrics
from znicz_tpu_torch.observe.registry import quantile_from_buckets

#: Fixed latency bucket upper bounds in milliseconds.  Spanning 0.5 ms
#: (in-process hits on a warm engine) to 8 s (drain under overload);
#: requests beyond the last edge land in the +Inf bucket.
LATENCY_BUCKETS_MS = (
    0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 4000, 8000)

#: TTFT bucket upper bounds in milliseconds — generative serving's
#: time-to-first-token spans an in-process prefill (~ms) to a deep
#: admission queue under load
TTFT_BUCKETS_MS = (
    1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000)

# registry mirrors: counters aggregate across instances (process
# lifetime, Prometheus semantics); gauges follow the newest instance —
# one serving plane per process is the deployed shape
_M_GEN_REQUESTS = _metrics.counter(
    "znicz_generate_requests_total", "generation requests by outcome",
    labelnames=("event",))
_M_GEN_TOKENS = _metrics.counter(
    "znicz_generate_tokens_total", "tokens streamed to clients")
_M_GEN_TTFT = _metrics.histogram(
    "znicz_generate_ttft_seconds",
    "time to first token (admit -> first sampled token)",
    buckets=tuple(b / 1000.0 for b in TTFT_BUCKETS_MS))
_M_GEN_SLOTS = _metrics.gauge(
    "znicz_generate_active_slots",
    "decode-batch slots generating right now (newest batcher)")
_M_GEN_TPS = _metrics.gauge(
    "znicz_generate_tokens_per_sec",
    "tokens/sec over the sliding window (newest batcher)")
_M_GEN_ABANDONED = _metrics.counter(
    "znicz_generate_abandoned_total",
    "requests abandoned by the client (cancel / disconnect)")
# the wait queue is scrapeable (not snapshot-only): a fleet
# autoscaler rule reads the total queue depth across workers
_M_GEN_QUEUE = _metrics.gauge(
    "znicz_generate_queue_depth",
    "admitted generations waiting for a decode slot (newest batcher)")
# paged-arena occupancy: the fleet-rule signal for the generative
# memory plane
_M_GEN_PAGES_TOTAL = _metrics.gauge(
    "znicz_generate_cache_pages_total",
    "allocatable KV-arena pages (scratch page excluded; newest paged "
    "batcher)")
_M_GEN_PAGES_USED = _metrics.gauge(
    "znicz_generate_cache_pages_used",
    "KV-arena pages held by live generations (newest paged batcher)")


class LatencyHistogram:
    """Fixed-bucket histogram with percentile estimation.

    Percentiles are linearly interpolated inside the winning bucket
    (Prometheus ``histogram_quantile`` convention), so accuracy is
    bounded by bucket width — the standard serving trade-off against
    unbounded sample storage.
    """

    def __init__(self, buckets_ms=LATENCY_BUCKETS_MS) -> None:
        self.edges = tuple(float(b) for b in buckets_ms)
        self.counts = [0] * (len(self.edges) + 1)   # +1: overflow bucket
        self.total = 0
        self.sum_ms = 0.0

    def record(self, latency_s: float) -> None:
        ms = latency_s * 1000.0
        i = 0
        for i, edge in enumerate(self.edges):       # noqa: B007
            if ms <= edge:
                break
        else:
            i = len(self.edges)
        self.counts[i] += 1
        self.total += 1
        self.sum_ms += ms

    def percentile(self, p: float) -> float:
        """Estimated ``p``-th percentile in milliseconds (0 when empty)
        — delegates to the registry's shared
        :func:`~znicz_tpu.observe.registry.quantile_from_buckets`
        (one quantile estimator, not two private codes), with
        this histogram's long-standing overflow convention (interpolate
        toward ``max(last_edge, mean)``)."""
        if self.total == 0:
            return 0.0
        return quantile_from_buckets(
            self.edges, self.counts, p / 100.0,
            overflow_hi=max(self.edges[-1], self.sum_ms / self.total))

    def snapshot(self) -> dict:
        return {
            "count": self.total,
            "mean_ms": round(self.sum_ms / self.total, 3) if self.total
            else 0.0,
            "p50_ms": round(self.percentile(50), 3),
            "p95_ms": round(self.percentile(95), 3),
            "p99_ms": round(self.percentile(99), 3),
            "buckets_ms": {
                **{f"{edge:g}": self.counts[i]
                   for i, edge in enumerate(self.edges)},
                "+Inf": self.counts[-1],
            },
        }


class GenerateMetrics:
    """Thread-safe counters for one generative serving plane
    (continuous batcher + ``POST /generate``), mirrored into the shared
    registry as the ``znicz_generate_*`` family.

    The admission ledger is exact by construction — every admitted
    request reaches exactly one of ``completed`` / ``failed`` /
    ``abandoned`` (the continuous batcher's single terminal-event
    path), so chaos drills assert ``admitted == completed + failed +
    abandoned`` with ``==``, not ``>=``.
    """

    #: sliding-window length for the tokens/sec figure
    WINDOW_S = 10.0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.started_at = time.monotonic()
        self.admitted = 0
        self.rejected = 0          # backpressure: queue-full fast failures
        self.completed = 0         # streams that ended normally
        self.failed = 0            # terminal error sentinel (incl. deadline)
        self.abandoned = 0         # client cancelled / disconnected
        self.tokens = 0
        self.active_slots = 0
        self.queue_depth = 0       # admitted, waiting for a slot
        self.pages_used = 0        # paged arena only; 0 on contiguous
        self.pages_total = 0
        self.ttft = LatencyHistogram(TTFT_BUCKETS_MS)
        self._recent: deque = deque()       # (stamp, n_tokens)
        _M_GEN_TPS.set_function(self.tokens_per_sec)  # newest wins

    # -- event hooks (called by the continuous batcher) ----------------------
    def on_admit(self) -> None:
        with self._lock:
            self.admitted += 1
            self.queue_depth += 1
            depth = self.queue_depth
        if _probe.enabled():
            _M_GEN_REQUESTS.labels(event="admitted").inc()
            _M_GEN_QUEUE.set(depth)

    def on_reject(self) -> None:
        with self._lock:
            self.rejected += 1
        if _probe.enabled():
            _M_GEN_REQUESTS.labels(event="rejected").inc()

    def on_slots(self, active: int, queued: int) -> None:
        with self._lock:
            self.active_slots = active
            self.queue_depth = queued
        if _probe.enabled():
            _M_GEN_SLOTS.set(active)
            _M_GEN_QUEUE.set(queued)

    def on_first_token(self, ttft_s: float) -> None:
        with self._lock:
            self.ttft.record(ttft_s)
        if _probe.enabled():
            _M_GEN_TTFT.observe(ttft_s)

    def on_tokens(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            self.tokens += n
            self._recent.append((now, n))
            cutoff = now - self.WINDOW_S
            while self._recent and self._recent[0][0] < cutoff:
                self._recent.popleft()
        if _probe.enabled():
            _M_GEN_TOKENS.inc(n)

    def on_complete(self) -> None:
        with self._lock:
            self.completed += 1
        if _probe.enabled():
            _M_GEN_REQUESTS.labels(event="completed").inc()

    def on_failed(self) -> None:
        with self._lock:
            self.failed += 1
        if _probe.enabled():
            _M_GEN_REQUESTS.labels(event="failed").inc()

    def on_abandoned(self) -> None:
        with self._lock:
            self.abandoned += 1
        if _probe.enabled():
            _M_GEN_ABANDONED.inc()
            _M_GEN_REQUESTS.labels(event="abandoned").inc()

    def on_pages(self, used: int, total: int) -> None:
        """Paged-arena occupancy: called by the continuous
        batcher whenever a page is allocated, appended or released."""
        with self._lock:
            self.pages_used = int(used)
            self.pages_total = int(total)
        if _probe.enabled():
            _M_GEN_PAGES_USED.set(used)
            _M_GEN_PAGES_TOTAL.set(total)

    # -- export -------------------------------------------------------------
    def tokens_per_sec(self) -> float:
        """Streamed tokens/sec over the sliding window (since-start
        average while the window is still filling)."""
        with self._lock:
            return self._tps_locked(time.monotonic())

    def _tps_locked(self, now: float) -> float:
        elapsed = now - self.started_at
        if elapsed <= 0:
            return 0.0
        if elapsed < self.WINDOW_S:
            return self.tokens / elapsed
        cutoff = now - self.WINDOW_S
        while self._recent and self._recent[0][0] < cutoff:
            self._recent.popleft()
        return sum(n for _, n in self._recent) / self.WINDOW_S

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                "uptime_s": round(now - self.started_at, 3),
                "tokens_per_sec": round(self._tps_locked(now), 3),
                "admitted": self.admitted,
                "rejected": self.rejected,
                "completed": self.completed,
                "failed": self.failed,
                "abandoned": self.abandoned,
                "tokens": self.tokens,
                "active_slots": self.active_slots,
                "queue_depth": self.queue_depth,
                "pages_used": self.pages_used,
                "pages_total": self.pages_total,
                "ttft": self.ttft.snapshot(),
            }
