"""Process-global metrics registry — the shared schema every subsystem
donates into.

Before this module the tree had four ad-hoc telemetry surfaces
(``Workflow.timing_table()`` strings, ``PipelineStats``,
``serve/metrics.py::ServingMetrics``, per-subsystem ``WebStatus``
JSON blocks) with no common schema and nothing scrapeable.  This is the
one substrate: three metric kinds modeled on the Prometheus data model —

- :class:`Counter` — monotonically increasing float (``inc``);
- :class:`Gauge`   — settable level (``set``/``inc``/``dec``), or a
  zero-arg callable evaluated at scrape time (``set_function``);
- :class:`Histogram` — fixed upper-bound buckets (``observe``), exposed
  with cumulative bucket counts plus ``_sum``/``_count`` so a scraper
  can run ``histogram_quantile`` over it.

Families support labels (declared at creation, ``labels(**kv)`` returns
the per-labelset child).  Getters are get-or-create and idempotent, so
any module can say ``counter("znicz_x_total")`` without ordering
concerns; re-declaring with a different type or label set is an error.

Everything is stdlib; one registry-wide lock guards both family
creation and child mutation (hot-path cost: one uncontended lock + one
float add, ~1 µs — the ``metrics_overhead`` bench scenario pins the
end-to-end cost at <2 %).  Counters are process-lifetime monotonic,
exactly like a real Prometheus client: a supervised restart keeps
counting, which is what makes restart storms visible on a dashboard.

Export surfaces: ``snapshot()`` (structured dict, merged into
``WebStatus.snapshot()`` under ``"metrics"``), ``snapshot_flat()``
(compact ``name{labels} -> number`` dict, attached to bench JSON
lines), and ``render_prometheus()`` (text exposition served by
``GET /metrics``).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Optional, Sequence

#: default buckets for second-valued histograms: 100 µs (a no-op unit
#: fire) .. 60 s (a cold XLA compile inside a step); beyond -> +Inf.
SECONDS_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0)

_TYPES = ("counter", "gauge", "histogram")


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape(v)}"' for n, v in zip(names, values))
    return "{" + inner + "}"


def quantile_from_buckets(edges: Sequence[float], counts: Sequence[int],
                          q: float,
                          overflow_hi: Optional[float] = None) -> float:
    """THE histogram quantile estimator: linear
    interpolation inside the winning bucket, the Prometheus
    ``histogram_quantile`` convention — accuracy bounded by bucket
    width, no per-observation sample retention.  ``counts`` are
    per-bucket (NOT cumulative) with the ``+Inf`` overflow last, so
    ``len(counts) == len(edges) + 1``; ``q`` in [0, 1].  A quantile
    landing in the overflow bucket interpolates toward ``overflow_hi``
    (callers pass ``max(last_edge, mean)`` — the serving plane's
    long-standing convention) or clamps to the last edge.  Shared by
    :meth:`_Child.quantile` and ``serve/metrics.py::LatencyHistogram``
    instead of two private percentile codes."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    seen = 0
    for i, count in enumerate(counts):
        if count == 0:
            continue
        if seen + count >= rank:
            lo = edges[i - 1] if i > 0 else 0.0
            if i < len(edges):
                hi = edges[i]
            else:
                hi = overflow_hi if overflow_hi is not None else edges[-1]
            return lo + (hi - lo) * (rank - seen) / count
        seen += count
    return edges[-1]


class _Child:
    """One (family, labelset) time series.  All mutation goes through the
    owning registry's lock (passed in) — a single shared lock keeps the
    hot path allocation-free."""

    __slots__ = ("_lock", "value", "fn", "counts", "sum", "count",
                 "_edges")

    def __init__(self, lock: threading.Lock,
                 edges: Optional[tuple] = None) -> None:
        self._lock = lock
        self.value = 0.0
        self.fn: Optional[Callable[[], float]] = None
        self._edges = edges
        if edges is not None:
            self.counts = [0] * (len(edges) + 1)
            self.sum = 0.0
            self.count = 0

    # counter / gauge -------------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)
            self.fn = None

    def set_function(self, fn: Callable[[], float]) -> None:
        """Gauge evaluated at scrape time (e.g. a QPS window or a live
        queue depth owned by another object)."""
        with self._lock:
            self.fn = fn

    def get(self) -> float:
        # the callable runs OUTSIDE the registry lock: scrape-time
        # providers (e.g. ServingMetrics.qps) take their own locks, and
        # their event hooks take the registry lock — evaluating under
        # ours would invert the order and deadlock
        with self._lock:
            fn = self.fn
            value = self.value
        if fn is not None:
            try:
                return float(fn())
            except Exception:  # noqa: BLE001 — a dead provider must
                return float("nan")        # not kill the scrape
        return value

    # histogram -------------------------------------------------------------
    def observe(self, value: float) -> None:
        # bisect_left == first edge >= value — the "value <= edge"
        # bucket (C-speed: this runs once per control-graph signal)
        i = bisect_left(self._edges, value)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += value

    def hist_dict(self) -> dict:
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "buckets": {("+Inf" if i == len(self._edges)
                                 else f"{self._edges[i]:g}"): c
                                for i, c in enumerate(self.counts)}}

    def raw(self) -> tuple:
        """``(count, sum, per-bucket counts)`` in ONE lock round-trip —
        the ``snapshot_flat`` hot path (the watchtower samples it on
        every stride; three separate ``quantile()`` calls would pay
        three lock+copy rounds)."""
        with self._lock:
            return self.count, self.sum, list(self.counts)

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0 when empty) via the shared
        :func:`quantile_from_buckets`; the overflow bucket interpolates
        toward ``max(last_edge, mean)``."""
        total, total_sum, counts = self.raw()
        if total == 0:
            return 0.0
        return quantile_from_buckets(
            self._edges, counts, q,
            overflow_hi=max(self._edges[-1], total_sum / total))


class _Family:
    """A named metric family: type + help + label schema + children."""

    __slots__ = ("name", "type", "help", "labelnames", "buckets",
                 "_children", "_lock", "_flat_keys")

    def __init__(self, name: str, mtype: str, help_: str,
                 labelnames: tuple, lock: threading.Lock,
                 buckets: Optional[tuple] = None) -> None:
        self.name = name
        self.type = mtype
        self.help = help_
        self.labelnames = labelnames
        self.buckets = buckets
        self._children: dict[tuple, _Child] = {}
        self._lock = lock
        self._flat_keys: dict[tuple, object] = {}
        if not labelnames:
            self._children[()] = _Child(lock, buckets)

    def _flat_key(self, key: tuple):
        """Memoized flat-snapshot key strings for one labelset: key
        formatting dominates ``snapshot_flat`` once the watchtower
        samples it every stride, and the strings never change (label
        schema and bucket edges are both declaration-frozen).  Scalars
        cache the single ``name{labels}`` string; histograms cache
        ``(count_key, sum_key, ((quantile_key, q), ...),
        (bucket_key, ...))``."""
        entry = self._flat_keys.get(key)
        if entry is not None:
            return entry
        ls = _label_str(self.labelnames, key)
        if self.type == "histogram":
            names = self.labelnames + ("le",)
            edge_strs = [f"{e:g}" for e in self.buckets] + ["+Inf"]
            entry = (
                f"{self.name}_count{ls}", f"{self.name}_sum{ls}",
                tuple((f"{self.name}_{tag}{ls}", q)
                      for q, tag in ((0.5, "p50"), (0.95, "p95"),
                                     (0.99, "p99"))),
                tuple(f"{self.name}_bucket"
                      f"{_label_str(names, key + (e,))}"
                      for e in edge_strs))
        else:
            entry = f"{self.name}{ls}"
        self._flat_keys[key] = entry       # idempotent; GIL-atomic
        return entry

    def labels(self, **kv) -> _Child:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, _Child(self._lock, self.buckets))
        return child

    # label-less convenience: the family proxies its single child --------
    def _solo(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"metric {self.name!r} has labels "
                             f"{self.labelnames}; use .labels(...)")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._solo().set_function(fn)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    def get(self) -> float:
        return self._solo().get()

    def items(self):
        return list(self._children.items())


class Registry:
    """Named families, one lock, three export formats."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # -- declaration (get-or-create, idempotent) ----------------------------
    def _family(self, name: str, mtype: str, help_: str,
                labelnames: Sequence[str],
                buckets: Optional[Sequence[float]] = None) -> _Family:
        labelnames = tuple(labelnames)
        buckets = tuple(float(b) for b in buckets) if buckets else None
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    name, mtype, help_, labelnames, self._lock, buckets)
                return fam
        if fam.type != mtype:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam.type}, not {mtype}")
        if fam.labelnames != labelnames:
            raise ValueError(f"metric {name!r} already registered with "
                             f"labels {fam.labelnames}, not {labelnames}")
        if mtype == "histogram" and fam.buckets != buckets:
            raise ValueError(f"metric {name!r} already registered with "
                             f"buckets {fam.buckets}, not {buckets} — "
                             f"observations would land in edges the "
                             f"second declarer never asked for")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = SECONDS_BUCKETS) -> _Family:
        return self._family(name, "histogram", help, labelnames, buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def clear(self) -> None:
        """Drop every family — TESTS ONLY (cached child handles held by
        long-lived objects keep writing into orphaned children)."""
        with self._lock:
            self._families.clear()

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """Structured dict: name -> {type, help, values: [{labels, value}]}.
        Histogram values are {count, sum, buckets} dicts."""
        with self._lock:
            fams = list(self._families.values())
        out = {}
        for fam in fams:
            values = []
            for key, child in fam.items():
                labels = dict(zip(fam.labelnames, key))
                if fam.type == "histogram":
                    values.append({"labels": labels,
                                   "value": child.hist_dict()})
                else:
                    values.append({"labels": labels, "value": child.get()})
            out[fam.name] = {"type": fam.type, "help": fam.help,
                             "values": values}
        return out

    def snapshot_flat(self, skip_zero: bool = True,
                      buckets: bool = False) -> dict:
        """Compact ``name{labels} -> number`` dict (histograms contribute
        ``_count`` / ``_sum`` plus estimated ``_p50`` / ``_p95`` /
        ``_p99`` so SLO rules and time series can target latency
        quantiles directly) — the per-scenario snapshot bench.py
        attaches to its JSON result lines and the watchtower ring
        samples.  ``skip_zero`` drops never-touched series so artifact
        lines stay small.  ``buckets`` additionally emits each
        histogram's cumulative ``name_bucket{...,le="..."}`` counts
        (Prometheus convention) — the watchtower samples with it so
        windowed quantiles can be computed over bucket-count deltas
        (the lifetime ``_p95`` estimate damps mid-run regressions)."""
        with self._lock:
            fams = list(self._families.values())
        out = {}
        for fam in fams:
            for key, child in fam.items():
                if fam.type == "histogram":
                    count, total_sum, counts = child.raw()
                    if skip_zero and count == 0:
                        continue
                    count_key, sum_key, q_keys, bucket_keys = \
                        fam._flat_key(key)
                    out[count_key] = count
                    out[sum_key] = round(total_sum, 6)
                    if count:
                        hi = max(child._edges[-1], total_sum / count)
                        for qk, q in q_keys:
                            out[qk] = round(quantile_from_buckets(
                                child._edges, counts, q,
                                overflow_hi=hi), 6)
                    else:
                        for qk, _ in q_keys:
                            out[qk] = 0.0
                    if buckets:
                        acc = 0
                        for bk, c in zip(bucket_keys, counts):
                            acc += c
                            out[bk] = acc
                else:
                    v = child.get()
                    if skip_zero and v == 0.0:
                        continue
                    out[fam._flat_key(key)] = round(v, 6)
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4 — the ``GET /metrics``
        body.  Stable ordering: families in registration order, children
        in creation order."""
        with self._lock:
            fams = list(self._families.values())
        lines = []
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for key, child in fam.items():
                if fam.type == "histogram":
                    h = child.hist_dict()
                    acc = 0
                    for edge, c in h["buckets"].items():
                        acc += c
                        names = tuple(fam.labelnames) + ("le",)
                        vals = key + (edge,)
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_label_str(names, vals)} {acc}")
                    ls = _label_str(fam.labelnames, key)
                    lines.append(f"{fam.name}_sum{ls} {_fmt(h['sum'])}")
                    lines.append(f"{fam.name}_count{ls} {h['count']}")
                else:
                    ls = _label_str(fam.labelnames, key)
                    lines.append(f"{fam.name}{ls} {_fmt(child.get())}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    f = float(v)
    # NaN/inf reach here via dead scrape-time gauge providers — Prometheus
    # text accepts them spelled out, and int(nan) would raise
    if f != f or f in (float("inf"), float("-inf")):
        return repr(f)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


#: THE process-global registry (the Prometheus default-registry shape).
REGISTRY = Registry()


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> _Family:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> _Family:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = SECONDS_BUCKETS) -> _Family:
    return REGISTRY.histogram(name, help, labelnames, buckets)
