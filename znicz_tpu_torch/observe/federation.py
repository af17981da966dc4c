"""Fleet telemetry — cross-process metric federation, a copy of
``znicz_tpu/observe/federation.py`` (stdlib only; the same code but for
the package name in imports, held so by
``tests/test_torch_port_isolation.py``).

- **worker side**: :class:`MetricsExporter` / :func:`start_metrics_export`
  — a daemon thread atomically rewriting one rank-tagged JSON file
  (``{"schema", "rank", "ts", "prom"}``) with the process-global
  registry's Prometheus text every ``interval_s``; ``__main__`` starts it
  off ``$ZNICZ_TPU_METRICS_EXPORT`` (the elastic supervisor's worker env).
- **supervisor side**: :class:`FleetAggregator` — scrapes or ingests N
  workers' registries (HTTP ``/metrics.prom``, exporter files, or any
  zero-arg callable), injects a ``rank`` label onto every series and
  merges them into one fleet view (``/fleet/metrics``,
  ``/fleet/metrics.prom``, ``/fleet/status.json`` on its own
  :meth:`~FleetAggregator.serve` listener), with a fleet-level
  :class:`~znicz_tpu_torch.observe.watchtower.Watchtower` over the merged
  view and the fleet rules (:func:`fleet_queue_saturation`,
  :func:`fleet_latency_slo`, :func:`any_rank_recompile_storm`,
  :func:`rank_straggler`).  It registers itself as the flight recorder's
  ``fleet`` plane, so every artifact dumped in the supervisor process
  embeds each worker's last snapshot.
- **traces**: every worker's ``Tracer.export_dict()`` carries its rank
  and a wall-clock anchor for its monotonic origin; :func:`merge_traces`
  aligns N such documents onto one timeline (``pid`` = rank) and
  ``python -m znicz_tpu_torch trace --fleet -o out.json SRC...`` merges
  URLs or exported files offline (:func:`fleet_trace_main`).
- request ids: :func:`next_request_id` and :func:`request_track`, the
  serving planes' correlation keys, and :func:`fleet_rank`.

Clock alignment uses ``time.time()`` (shared on one host; across hosts
only as good as NTP — the merged doc keeps per-rank origins).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from typing import Callable, Optional, Sequence, Union

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.observe import flight as _flight
from znicz_tpu_torch.observe import registry as _reg
from znicz_tpu_torch.observe.watchtower import Rule, Watchtower

#: worker-side env contract (set per worker by resilience/elastic.py,
#: honored by __main__ exactly like $ZNICZ_TPU_HEARTBEAT)
METRICS_EXPORT_ENV = "ZNICZ_TPU_METRICS_EXPORT"
METRICS_EXPORT_INTERVAL_ENV = "ZNICZ_TPU_METRICS_EXPORT_INTERVAL"

#: exporter file schema identifier
EXPORT_SCHEMA = "znicz_tpu.metrics/1"

# aggregator self-telemetry (the SUPERVISOR's own registry — served by
# its own /metrics, never mixed into the merged worker view)
_M_WORKERS = _reg.gauge(
    "znicz_fleet_workers",
    "worker sources with a fresh scrape (live fleet width as the "
    "aggregator sees it)")
_M_SCRAPES = _reg.counter(
    "znicz_fleet_scrapes_total",
    "aggregator scrape attempts by worker and outcome",
    labelnames=("rank", "outcome"))
_M_SCRAPE_SECONDS = _reg.histogram(
    "znicz_fleet_scrape_seconds",
    "wall time of one worker scrape (HTTP fetch / file read + parse)")


def fleet_rank() -> Optional[int]:
    """This process's fleet rank, or None outside a fleet.  Reads the
    elastic env contract directly (``ZNICZ_TPU_ELASTIC_RANK``,
    resilience/elastic.py) — the observe plane must not import the
    resilience plane, which imports it."""
    rank = os.environ.get("ZNICZ_TPU_ELASTIC_RANK")
    if rank is None:
        return None
    try:
        return int(rank)
    except ValueError:
        return None


# -- Prometheus text ingestion ------------------------------------------------

def parse_prometheus(text: str):
    """Parse exposition text into ``(families, samples)``:
    ``families`` maps family name -> ``{"type", "help"}`` (registration
    order preserved); ``samples`` is ``[(family, name, inner, value)]``
    in document order, where ``inner`` is the raw label string between
    the braces (``'le="0.5"'``, '' when label-less) — kept raw so
    re-rendering and rank injection never re-escape label values.

    Histogram children (``_bucket``/``_sum``/``_count``) attach to the
    family their preceding ``# TYPE`` line declared, the exposition
    convention ``render_prometheus`` emits.  A sample line that does
    not parse raises ``ValueError`` naming it — the concurrent-scrape
    soak relies on torn text failing loudly, not half-merging."""
    families: dict = {}
    samples: list = []
    current: Optional[str] = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) == 4:
                current = parts[2]
                families.setdefault(current, {"type": None, "help": ""})
                families[current]["type"] = parts[3].strip()
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 3:
                families.setdefault(parts[2], {"type": None, "help": ""})
                families[parts[2]]["help"] = \
                    parts[3].strip() if len(parts) == 4 else ""
            continue
        if line.startswith("#"):
            continue
        # the closing brace is the LAST "}" on the line (label values
        # may contain a raw "}", but the value/timestamp tail is
        # numeric); an optional trailing timestamp (valid 0.0.4) is
        # accepted and dropped rather than mis-parsed as the value
        name_part, brace, rest = line.partition("{")
        if brace:
            inner, closed, tail = rest.rpartition("}")
            if not closed:
                raise ValueError(f"unclosed label block in exposition "
                                 f"line: {line!r}")
            name, fields = name_part, tail.split()
        else:
            fields = line.split()
            name, fields = fields[0], fields[1:]
            inner = ""
        if not name or not fields or len(fields) > 2:
            raise ValueError(f"unparseable exposition line: {line!r}")
        try:
            value = float(fields[0])
        except ValueError as exc:
            raise ValueError(
                f"unparseable sample value in line: {line!r}") from exc
        family = current if current is not None and \
            name.startswith(current) else name
        samples.append((family, name, inner, value))
    return families, samples


def inject_rank(inner: str, rank) -> str:
    """Append ``rank="N"`` to a raw label string (no-op when the series
    already carries a rank label — an aggregator scraping another
    aggregator must not double-tag)."""
    if 'rank="' in inner:
        return inner
    return f'{inner},rank="{rank}"' if inner else f'rank="{rank}"'


# -- worker-side exporter -----------------------------------------------------

class MetricsExporter:
    """Daemon thread atomically rewriting ``path`` with this process's
    registry rendered as Prometheus text, wrapped in a small JSON
    envelope (rank, wall-clock stamp) so the aggregator can tell a live
    worker from a stale file.  Write failures are swallowed — a full
    disk must not kill the trainer, only its telemetry (the
    heartbeat's convention)."""

    def __init__(self, path: str, interval_s: float = 1.0,
                 registry: Optional[_reg.Registry] = None) -> None:
        self.path = str(path)
        self.interval_s = float(interval_s)
        self._registry = registry or _reg.REGISTRY
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="znicz-metrics-export")

    def start(self) -> "MetricsExporter":
        self._thread.start()
        return self

    def write_once(self) -> None:
        doc = {"schema": EXPORT_SCHEMA,
               "rank": fleet_rank() or 0,
               "pid": os.getpid(),
               "ts": time.time(),
               "prom": self._registry.render_prometheus()}
        tmp = f"{self.path}.{os.getpid()}.tmp"   # pid-unique: racers
        try:                                     # cannot tear a shared tmp
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except OSError:
            pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.write_once()
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        """Stop the cadence and publish one final snapshot — the state
        a post-mortem wants is the one at exit, not one interval ago."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.write_once()


def start_metrics_export(path: str, interval_s: float = 1.0,
                         registry: Optional[_reg.Registry] = None
                         ) -> MetricsExporter:
    """Start a :class:`MetricsExporter`; ``__main__`` calls this when
    ``$ZNICZ_TPU_METRICS_EXPORT`` is set (the elastic fleet's worker
    env contract)."""
    return MetricsExporter(path, interval_s, registry).start()


# -- trace merging ------------------------------------------------------------

def merge_traces(docs: Sequence[dict]) -> dict:
    """Align N ``Tracer.export_dict()`` documents onto ONE
    Perfetto-loadable timeline: each document's events shift by the
    difference between its wall-clock origin and the earliest one, its
    ``pid`` becomes the worker's rank (falling back to 1000+index for
    rank-less docs), and one ``process_name`` metadata row per rank
    labels the track.  Per-rank origins ride along under ``"origins"``
    so cross-host NTP skew stays auditable."""
    base = min((d["origin_unix_ts"] for d in docs
                if d.get("origin_unix_ts") is not None), default=None)
    events: list = []
    origins: dict = {}
    for i, doc in enumerate(docs):
        rank = doc.get("rank")
        pid = rank if rank is not None else 1000 + i
        origin = doc.get("origin_unix_ts")
        shift = 0.0 if base is None or origin is None \
            else (origin - base) * 1e6
        origins[str(pid)] = origin
        name = doc.get("label") or (f"rank {rank}" if rank is not None
                                    else f"source {i}")
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": name}})
        for ev in doc.get("traceEvents", ()):
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue               # replaced by the rank row above
            ev = dict(ev)
            ev["pid"] = pid
            if ev["ph"] != "M":
                ev["ts"] = round(ev.get("ts", 0.0) + shift, 3)
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "origins": origins}


def _load_trace_source(src: str, timeout_s: float = 10.0) -> dict:
    """One ``merge_traces`` input from a URL (a worker base or a full
    ``/trace.json`` URL) or a local exported-trace file path."""
    if src.startswith(("http://", "https://")):
        url = src if src.endswith(".json") else \
            src.rstrip("/") + "/trace.json"
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            return json.load(r)
    with open(src) as f:
        return json.load(f)


def fleet_trace_main(argv) -> int:
    """``python -m znicz_tpu_torch trace --fleet -o out.json SRC [SRC ...]``
    — SRC is a worker base URL (its ``/trace.json`` is fetched), a full
    trace URL, or an exported trace file.  Writes the merged
    Perfetto-loadable timeline to ``-o`` (default
    ``fleet_trace.json``)."""
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="znicz_tpu trace --fleet",
        description="merge worker trace timelines onto one clock")
    p.add_argument("sources", nargs="+",
                   help="worker base URLs, /trace.json URLs, or "
                        "exported trace files")
    p.add_argument("-o", "--output", default="fleet_trace.json")
    args = p.parse_args(argv)
    docs = []
    for src in args.sources:
        try:
            docs.append(_load_trace_source(src))
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            print(f"trace --fleet: cannot load {src!r}: {exc}",
                  file=sys.stderr)
            return 2
    merged = merge_traces(docs)
    with open(args.output, "w") as f:
        json.dump(merged, f)
    n = sum(1 for e in merged["traceEvents"] if e["ph"] != "M")
    print(f"trace --fleet: merged {n} events from {len(docs)} "
          f"source(s) -> {args.output}")
    return 0


# -- the aggregator -----------------------------------------------------------

def _cumulative(family_type: Optional[str], name: str) -> bool:
    """Whether a sample is monotonic-cumulative (counter / histogram
    child) as opposed to a level (gauge).  Stale sources keep their
    cumulative series in the merge at last-known values — dropping a
    counter to 0 and snapping it back on recovery would register the
    worker's lifetime total as in-window growth and falsely trip every
    delta/quantile rule — while their gauges drop out (a dead worker's
    queue must not read saturated forever).  Untyped exposition falls
    back to the name-suffix convention."""
    if family_type in ("counter", "histogram"):
        return True
    if family_type == "gauge":
        return False
    return name.endswith(("_total", "_count", "_sum", "_bucket"))


class _Source:
    """One worker's scrape target + its last successful ingest."""

    __slots__ = ("rank", "kind", "target", "ts", "families", "samples",
                 "ok", "error", "scrapes", "label")

    def __init__(self, rank, kind: str, target,
                 label: Optional[str] = None) -> None:
        self.rank = rank
        self.kind = kind                  # "http" | "file" | "callable"
        self.target = target
        #: display name for non-worker sources (the serving
        #: fleet's ROUTER scrapes into the same merged view — its trace
        #: track reads "router", not "rank 9000")
        self.label = label
        self.ts: Optional[float] = None   # wall stamp of the last ingest
        self.families: dict = {}
        self.samples: list = []
        self.ok = False
        self.error: Optional[str] = None
        self.scrapes = 0


class FleetAggregator(Logger):
    """Merge N workers' registries into one rank-labeled fleet view;
    see module docstring.  ``stale_s`` bounds how old a source's data
    may be before it stops counting as a live worker — past it, the
    source's GAUGES drop out of the merge (a dead worker's queue-depth
    gauge must not read saturated forever — the watchtower ring's
    vanish-to-zero discipline) while its CUMULATIVE series (counters,
    histogram buckets) carry forward at their last value: vanishing a
    counter to 0 and snapping it back on recovery would register the
    worker's whole lifetime as in-window growth and falsely trip every
    delta/quantile fleet rule.  A transiently FAILING scrape keeps
    serving the cached data until it ages out, for the same reason.
    ``min_refresh_s`` coalesces concurrent scrape triggers (the fleet
    tower's cadence, HTTP requests, flight dumps) into one fetch per
    window; within a pass, sources are scraped concurrently so one
    unreachable worker costs the pass ``timeout_s`` once, not per
    caller per source."""

    def __init__(self, stale_s: float = 15.0, timeout_s: float = 5.0,
                 min_refresh_s: float = 0.25, capacity: int = 720) -> None:
        super().__init__()
        self.stale_s = float(stale_s)
        self.timeout_s = float(timeout_s)
        self.min_refresh_s = float(min_refresh_s)
        self._sources: dict = {}
        self._lock = threading.Lock()          # sources map + gate
        self._refresh_lock = threading.Lock()  # one scrape pass at a time
        self._executor = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="znicz-fleet-scrape")
        self._last_refresh: Optional[float] = None
        #: the fleet watchtower samples THIS object: ``snapshot_flat``
        #: below is the merged rank-labeled view, so every existing
        #: reduce (family sums, label filters, bucket-delta quantiles)
        #: works fleet-wide unchanged
        self.tower = Watchtower(capacity=capacity, registry=self)
        #: top-level ``/fleet/status.json`` blocks from the planes that
        #: own fleet-wide facts: the worker pool
        #: registers ``"package"`` (current fingerprint + convergence),
        #: the router's rollout registers ``"rollout"``, the learn
        #: bridge registers ``"learn"`` — so operators and the adoption
        #: gate read ONE document instead of folding per-worker /readyz
        #: answers themselves
        self._status_providers: dict = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.port = 0
        # every flight artifact dumped in this process now embeds each
        # worker's last snapshot (newest aggregator wins the name, the
        # registry-gauge convention).  The bound method is stored so
        # close() can conditionally unregister the EXACT object it
        # registered — a fresh `self.workers_snapshot` access creates a
        # new bound-method object that would never compare `is`
        self._flight_plane = self.workers_snapshot
        _flight.register_plane("fleet", self._flight_plane)

    # -- sources -------------------------------------------------------------
    def add_http_source(self, rank, base_url: str,
                        label: Optional[str] = None) -> "FleetAggregator":
        """A serve/generate worker: ``<base_url>/metrics.prom`` is
        scraped; its ``/trace.json`` feeds the merged fleet trace.
        ``label`` names a non-worker source (the fleet ROUTER)
        on the merged trace's process row and in
        ``/fleet/status.json``."""
        with self._lock:
            self._sources[int(rank)] = _Source(
                int(rank), "http", base_url.rstrip("/"), label=label)
        return self

    def add_file_source(self, rank, path: str) -> "FleetAggregator":
        """An elastic training rank: ``path`` is the worker's
        :class:`MetricsExporter` file beside its heartbeat."""
        with self._lock:
            self._sources[int(rank)] = _Source(int(rank), "file",
                                               str(path))
        return self

    def add_source(self, rank, fn: Callable[[], Union[str, dict]]
                   ) -> "FleetAggregator":
        """A zero-arg callable returning exposition text or an exporter
        envelope dict — the deterministic-test hook."""
        with self._lock:
            self._sources[int(rank)] = _Source(int(rank), "callable", fn)
        return self

    def remove_source(self, rank) -> None:
        with self._lock:
            self._sources.pop(int(rank), None)

    def clear_sources(self) -> None:
        with self._lock:
            self._sources.clear()

    def ranks(self) -> list:
        with self._lock:
            return sorted(self._sources)

    # -- scraping ------------------------------------------------------------
    def _fetch(self, src: _Source) -> tuple:
        """-> (wall_ts, prom_text) for one source; raises on any
        failure (unreachable worker, torn file, bad envelope)."""
        if src.kind == "http":
            with urllib.request.urlopen(src.target + "/metrics.prom",
                                        timeout=self.timeout_s) as r:
                return time.time(), r.read().decode()
        if src.kind == "file":
            with open(src.target) as f:
                doc = json.load(f)
            if doc.get("schema") != EXPORT_SCHEMA:
                raise ValueError(
                    f"{src.target}: not a metrics export "
                    f"(schema={doc.get('schema')!r})")
            return float(doc["ts"]), doc["prom"]
        out = src.target()
        if isinstance(out, dict):
            return float(out.get("ts", time.time())), out["prom"]
        return time.time(), out

    def _fresh(self, src: _Source, now: Optional[float] = None) -> bool:
        # data-age only, NOT the latest attempt's outcome: one
        # transient scrape failure (GC pause, torn file read) must not
        # instantly vanish a live worker's series — the data keeps
        # serving until it ages past stale_s (src.ok/src.error still
        # record the attempt for /fleet/status.json)
        if src.ts is None:
            return False
        return (now if now is not None else time.time()) - src.ts \
            <= self.stale_s

    def _scrape_one(self, src: _Source) -> None:
        t0 = time.perf_counter()
        try:
            ts, text = self._fetch(src)
            families, samples = parse_prometheus(text)
            src.ts, src.families, src.samples = ts, families, samples
            src.ok, src.error = True, None
            outcome = "ok"
        except Exception as exc:  # noqa: BLE001 — one dead worker
            src.ok, src.error = False, repr(exc)   # must not kill
            outcome = "error"                      # the fleet view
        src.scrapes += 1
        _M_SCRAPES.labels(rank=str(src.rank), outcome=outcome).inc()
        _M_SCRAPE_SECONDS.observe(time.perf_counter() - t0)

    def refresh(self, force: bool = False) -> None:
        """Scrape every source (coalesced to one pass per
        ``min_refresh_s`` unless forced; one pass at a time).  Sources
        scrape concurrently, so a pass over a fleet with K unreachable
        workers costs ~``timeout_s``, not K times it."""
        with self._refresh_lock:
            with self._lock:
                now = time.monotonic()
                if not force and self._last_refresh is not None and \
                        now - self._last_refresh < self.min_refresh_s:
                    return
                self._last_refresh = now
                sources = list(self._sources.values())
            if len(sources) == 1:
                self._scrape_one(sources[0])
            elif sources:
                list(self._executor.map(self._scrape_one, sources))
            wall = time.time()
            _M_WORKERS.set(sum(1 for s in sources
                               if self._fresh(s, wall)))

    # -- merged views --------------------------------------------------------
    def snapshot_flat(self, skip_zero: bool = True,
                      buckets: bool = False) -> dict:
        """The merged fleet view in the registry's flat-key shape —
        every worker series carries an injected ``rank`` label, plus a
        synthetic ``znicz_fleet_worker_up{rank=}`` 1/0 per source so
        rules can watch fleet width.  This is the
        ``Registry.snapshot_flat`` signature on purpose: the fleet
        :class:`Watchtower`'s ring samples this object directly."""
        self.refresh()
        wall = time.time()
        out: dict = {}
        with self._lock:
            sources = [self._sources[r] for r in sorted(self._sources)]
        for src in sources:
            up = self._fresh(src, wall)
            out[f'znicz_fleet_worker_up{{rank="{src.rank}"}}'] = \
                1.0 if up else 0.0
            for family, name, inner, value in src.samples:
                if not up and not _cumulative(
                        src.families.get(family, {}).get("type"), name):
                    continue           # stale gauges drop; counters stay
                if not buckets and name.endswith("_bucket"):
                    continue
                if skip_zero and value == 0.0:
                    continue
                out[f"{name}{{{inject_rank(inner, src.rank)}}}"] = value
        return out

    def render_prometheus(self) -> str:
        """The merged fleet exposition (``GET /fleet/metrics.prom``):
        one ``TYPE``/``HELP`` declaration per family (the first source
        carrying type metadata wins), then every rank's sample
        lines."""
        self.refresh()
        wall = time.time()
        with self._lock:
            sources = [self._sources[r] for r in sorted(self._sources)]
        fams: dict = {}        # name -> {"type", "help", "lines": []}
        up_lines = []
        for src in sources:
            up = self._fresh(src, wall)
            up_lines.append(
                f'znicz_fleet_worker_up{{rank="{src.rank}"}} '
                f'{1 if up else 0}')
            for family, name, inner, value in src.samples:
                meta = src.families.get(family, {})
                if not up and not _cumulative(meta.get("type"), name):
                    continue           # stale gauges drop; counters stay
                fam = fams.setdefault(
                    family, {"type": meta.get("type") or "untyped",
                             "help": meta.get("help", ""), "lines": []})
                if fam["type"] == "untyped" and meta.get("type"):
                    # the first source SEEN may lack metadata (e.g. a
                    # schema-drifted stale cache) — the first source
                    # CARRYING a type wins instead
                    fam["type"] = meta["type"]
                    fam["help"] = fam["help"] or meta.get("help", "")
                fam["lines"].append(
                    f"{name}{{{inject_rank(inner, src.rank)}}} "
                    f"{_reg._fmt(value)}")
        lines = ["# HELP znicz_fleet_worker_up 1 while the rank's last "
                 "scrape is fresh (aggregator-synthesized)",
                 "# TYPE znicz_fleet_worker_up gauge"] + up_lines
        for name, fam in fams.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            lines.extend(fam["lines"])
        return "\n".join(lines) + "\n"

    def workers_snapshot(self) -> dict:
        """Per-rank last-known state — embedded into every flight
        artifact via the ``"fleet"`` plane.  Deliberately serves the
        CACHED scrape (no network in a crash path)."""
        wall = time.time()
        with self._lock:
            sources = [self._sources[r] for r in sorted(self._sources)]
        out = {}
        for src in sources:
            flat = {f"{name}{{{inject_rank(inner, src.rank)}}}": value
                    for _, name, inner, value in src.samples
                    if not name.endswith("_bucket")}
            out[str(src.rank)] = {
                "kind": src.kind,
                "label": src.label,
                "target": src.target if src.kind != "callable"
                else repr(src.target),
                "ok": src.ok, "error": src.error,
                "age_s": round(wall - src.ts, 3)
                if src.ts is not None else None,
                "scrapes": src.scrapes,
                "flat": flat}
        return out

    def metrics_doc(self) -> dict:
        """``GET /fleet/metrics``: the merged flat view + per-rank
        scrape health."""
        flat = self.snapshot_flat(skip_zero=True, buckets=False)
        return {"workers": {r: {k: v for k, v in w.items()
                                if k != "flat"}
                            for r, w in self.workers_snapshot().items()},
                "flat": flat}

    # -- status providers ----------------------------------------------------
    def register_status_provider(self, key: str, fn: Callable[[], dict]
                                 ) -> None:
        """Merge ``fn()`` into ``/fleet/status.json`` under top-level
        ``key`` — fleet-wide facts (package fingerprint, rollout state,
        learn-plane adoption) surface in one document.  A provider
        failure degrades to an ``{"error": ...}`` block, never a 500."""
        with self._lock:
            self._status_providers[str(key)] = fn

    def unregister_status_provider(self, key: str, fn=None) -> None:
        """Remove ``key`` (only if still ``fn``, when given — the
        newest-registrant-wins convention the flight planes use)."""
        with self._lock:
            if fn is None or self._status_providers.get(key) is fn:
                self._status_providers.pop(str(key), None)

    def status_doc(self) -> dict:
        """``GET /fleet/status.json``: liveness + the fleet
        watchtower's rule states, plus every registered provider's
        top-level block (``package``/``rollout``/``learn``)."""
        self.refresh()
        with self._lock:
            providers = dict(self._status_providers)
        doc = {"workers": {r: {k: v for k, v in w.items()
                               if k != "flat"}
                           for r, w in self.workers_snapshot().items()},
               "watchtower": self.tower.snapshot()}
        for key, fn in providers.items():
            try:
                doc[key] = fn()
            except Exception as exc:  # noqa: BLE001 — one dead plane
                doc[key] = {"error": repr(exc)}   # must not 500 status
        return doc

    def trace_doc(self) -> dict:
        """``GET /fleet/trace.json``: the HTTP sources' live tracer
        rings merged onto one timeline (file/callable ranks cannot be
        trace-scraped — they are listed under ``"missing"``; training
        ranks export via ``--trace`` or flight artifacts instead)."""
        with self._lock:
            sources = [self._sources[r] for r in sorted(self._sources)]
        docs, missing = [], []
        for src in sources:
            if src.kind != "http":
                missing.append(src.rank)
                continue
            try:
                with urllib.request.urlopen(src.target + "/trace.json",
                                            timeout=self.timeout_s) as r:
                    doc = json.load(r)
                if doc.get("rank") is None:
                    # a worker outside an elastic fleet exports
                    # rank=None — the REGISTRATION rank is its identity
                    # here (setdefault would never fire on the
                    # explicit None export_dict always writes)
                    doc["rank"] = src.rank
                if src.label:
                    doc["label"] = src.label
                docs.append(doc)
            except Exception as exc:  # noqa: BLE001 — merge what lives
                missing.append(src.rank)
                self.warning(f"fleet trace scrape rank {src.rank} "
                             f"failed: {exc!r}")
        merged = merge_traces(docs)
        merged["missing"] = missing
        return merged

    # -- fleet watchtower ----------------------------------------------------
    def add_rule(self, rule: Rule) -> Rule:
        """Add one SLO rule over the MERGED view (family selectors sum
        across ranks; ``{rank="N"}`` filters isolate one worker)."""
        return self.tower.add_rule(rule)

    def add_rule_per_rank(self, make_rule: Callable[[int], Rule]) -> list:
        """Instantiate ``make_rule(rank)`` for every registered source
        — the "any-rank" pattern (e.g. a per-rank recompile storm: ONE
        misbehaving worker must trip even while the fleet sum stays
        quiet)."""
        return [self.add_rule(make_rule(rank)) for rank in self.ranks()]

    def start(self, interval_s: float = 2.0) -> None:
        """Background scrape-and-judge cadence (the fleet tower's
        sampler thread; each sample triggers one coalesced refresh)."""
        self.tower.start(interval_s)

    def stop(self) -> None:
        self.tower.stop()

    # -- HTTP ----------------------------------------------------------------
    def http_payload(self, path: str):
        """``(body_bytes, content_type)`` for one ``/fleet/*`` path, or
        None for paths this plane does not own — shared by the
        aggregator's own listener and ``WebStatus.register_fleet``."""
        if path.startswith("/fleet/metrics.prom"):
            return (self.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
        if path.startswith("/fleet/metrics"):
            return json.dumps(self.metrics_doc()).encode(), \
                "application/json"
        if path.startswith("/fleet/status.json"):
            return json.dumps(self.status_doc()).encode(), \
                "application/json"
        if path.startswith("/fleet/trace.json"):
            return json.dumps(self.trace_doc()).encode(), \
                "application/json"
        return None

    def serve(self, port: int = 0) -> int:
        """Standalone fleet listener (the supervisor case, where no
        WebStatus runs): serves the four ``/fleet/*`` endpoints;
        un-prefixed paths (``/metrics.prom``) alias into the fleet
        namespace for scraper convenience."""
        from http.server import BaseHTTPRequestHandler

        agg = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                path = self.path if self.path.startswith("/fleet/") \
                    else "/fleet" + (self.path if self.path != "/"
                                     else "/status.json")
                payload = agg.http_payload(path)
                if payload is None:
                    body, ctype = (json.dumps(
                        {"error": f"unknown path {self.path!r}"}).encode(),
                        "application/json")
                    self.send_response(404)
                else:
                    body, ctype = payload
                    self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)),
                                          Handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="znicz-fleet-http")
        self._http_thread.start()
        self.info(f"fleet telemetry on http://127.0.0.1:{self.port}"
                  f"/fleet/ ({len(self.ranks())} source(s))")
        return self.port

    def stop_server(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def close(self) -> None:
        """Full teardown: cadence, listener, and this aggregator's
        flight plane (only if still the registered one)."""
        self.stop()
        self.stop_server()
        _flight.unregister_plane("fleet", self._flight_plane)
        self._executor.shutdown(wait=False)


# -- fleet rule catalogue (docs/OBSERVABILITY.md) -----------------------------

def fleet_queue_saturation(depth: float = 64.0, for_s: float = 5.0,
                           metric: str = "znicz_serve_queue_depth",
                           action: Optional[Callable] = None) -> Rule:
    """TOTAL admission-queue depth across every rank pinned above
    ``depth`` — the serving-fleet autoscaler signal (family selectors
    sum across the injected rank labels).  Point ``metric`` at
    ``znicz_generate_queue_depth`` for the generative plane."""
    return Rule(
        f"fleet_queue_saturation[{metric}]"
        if metric != "znicz_serve_queue_depth"
        else "fleet_queue_saturation",
        metric, lambda v: v > depth, for_s=for_s, action=action,
        description=f"fleet-total {metric} > {depth:g} for {for_s:g}s")


def fleet_latency_slo(p95_s: float, window_s: float = 60.0,
                      metric: str = "znicz_serve_latency_seconds",
                      min_count: int = 8,
                      action: Optional[Callable] = None) -> Rule:
    """Fleet p95 latency over ``window_s`` above ``p95_s`` seconds —
    the quantile runs over bucket-count deltas MERGED across ranks, so
    one slow worker degrades the fleet figure in proportion to its
    traffic share (point ``metric`` at ``znicz_generate_ttft_seconds``
    for a TTFT SLO)."""
    return Rule(
        f"fleet_latency_slo[{metric}]"
        if metric != "znicz_serve_latency_seconds" else "fleet_latency_slo",
        metric, lambda q: q > p95_s, window_s=window_s,
        reduce="window_quantile", quantile=0.95, min_count=min_count,
        action=action,
        description=f"fleet p95 {metric} > {p95_s:g}s over {window_s:g}s")


def any_rank_recompile_storm(rank: int, max_in_window: float = 3.0,
                             window_s: float = 60.0,
                             metric: str = "znicz_recompiles_total",
                             action: Optional[Callable] = None) -> Rule:
    """ONE rank recompiling after warmup — use with
    ``add_rule_per_rank(lambda r: any_rank_recompile_storm(r))``: the
    fleet sum would dilute a single worker's storm across N quiet
    peers, so each rank gets its own label-filtered rule."""
    return Rule(
        f"any_rank_recompile_storm[{rank}]",
        f'{metric}{{rank="{rank}"}}',
        lambda d: d > max_in_window, window_s=window_s, reduce="delta",
        action=action,
        description=f"> {max_in_window:g} recompiles on rank {rank} "
                    f"inside {window_s:g}s ({metric})")


def rank_straggler(rank: int, peers: Sequence[Rule],
                   spread: float = 1.5, window_s: float = 60.0,
                   min_count: int = 4,
                   metric: str = "znicz_anatomy_step_seconds",
                   action: Optional[Callable] = None) -> Rule:
    """ONE rank's windowed step-time median above ``spread``x the
    median of its PEERS' medians (the straggler watch) — the
    SPMD failure mode no single-rank rule can see: every collective
    runs at the slowest rank's pace, so one degraded worker (thermal
    throttle, a sick host, an unlucky NUMA layout) silently taxes the
    whole fleet while its own absolute numbers still look plausible.

    Relative-to-peers rather than an absolute threshold: the fleet is
    its own baseline, so the rule needs no per-model tuning.  Each
    rank's rule reduces its OWN rank-filtered
    ``znicz_anatomy_step_seconds`` buckets to a windowed p50, then the
    predicate compares against the median of the sibling rules'
    ``last_value`` — ``peers`` is the shared (mutable) list of all the
    fleet's straggler rules, read at evaluation time, so build through
    :func:`add_straggler_rules` rather than by hand.  With fewer than
    two peers reporting there is no baseline and the rule stays quiet.
    """
    name = f"rank_straggler[{rank}]"

    def predicate(own_p50: float) -> bool:
        others = sorted(r.last_value for r in peers
                        if r.name != name and r.last_value is not None)
        if not others:
            return False
        mid = len(others) // 2
        peer_median = others[mid] if len(others) % 2 else \
            0.5 * (others[mid - 1] + others[mid])
        return peer_median > 0.0 and own_p50 > spread * peer_median

    return Rule(
        name, f'{metric}{{rank="{rank}"}}',
        predicate, window_s=window_s, reduce="window_quantile",
        quantile=0.5, min_count=min_count, action=action,
        description=f"rank {rank} windowed step p50 > {spread:g}x the "
                    f"peer-median p50 over {window_s:g}s ({metric})")


def add_straggler_rules(aggregator: "FleetAggregator", *,
                        spread: float = 1.5, window_s: float = 60.0,
                        min_count: int = 4,
                        metric: str = "znicz_anatomy_step_seconds",
                        action: Optional[Callable] = None) -> list:
    """Install one :func:`rank_straggler` per registered source and
    wire their shared peer list — the factory's baseline is the OTHER
    rules' last windowed p50, so the rules must know each other."""
    peers: list = []
    peers.extend(aggregator.add_rule_per_rank(
        lambda rank: rank_straggler(
            rank, peers, spread=spread, window_s=window_s,
            min_count=min_count, metric=metric, action=action)))
    return list(peers)


#: rolling id for requests minted at HTTP admission — combined with the
#: pid so ids stay unique across a worker fleet without coordination
_RID_SEQ = itertools.count(1)


def next_request_id() -> str:
    """Mint one request id (``<pid hex>-<seq hex>``) — the distributed
    tracing correlation key threaded HTTP admission -> batcher ->
    decode phases (serve/server.py)."""
    return f"{os.getpid():x}-{next(_RID_SEQ):x}"


def request_track(rid: str) -> int:
    """Deterministic synthetic trace track (Chrome-trace ``tid``) for
    one request: every phase span of a request shares a row in
    Perfetto instead of overlapping arbitrarily on the worker threads
    that happened to run it."""
    return 0x40000000 | zlib.crc32(rid.encode())
