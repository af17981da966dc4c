"""Serving-fleet front-end router — the port of
``znicz_tpu/fleet/router.py``.

One listener load-balances both serving planes across the pool's
workers — the VELES master that fronted its slave fleet, rebuilt for
HTTP inference traffic:

    POST /predict    -> proxied to the least-loaded READY worker
    POST /generate   -> streaming relay: ndjson lines flushed through
                        as the worker emits them
    GET  /healthz    -> 200 while the router process serves (liveness)
    GET  /readyz     -> 200 while >= 1 worker is ready (routability)
    GET  /metrics    -> router ledger + per-worker states + rollout
    GET  /metrics.prom /trace.json  -> this process's registry / spans
    GET  /fleet/*    -> the pool aggregator's merged view
    GET  /rollout    -> rolling-update state machine status
    POST /rollout    -> {"package": path} starts a rolling update

Routing policy:

- **readiness-gated**: only workers whose last ``/readyz`` probe
  answered 200 (and that the pool is not retiring) receive traffic —
  a draining or mid-reboot worker drops out of rotation BEFORE its
  drain completes (serve/server.py's liveness/readiness split);
- **least-loaded**: pick = min over ready workers of scraped queue
  depth + active slots (the pool's probe loop, at most one
  ``probe_interval_s`` old) plus the router's own live in-flight count
  (covers the scrape gap);
- **bounded retry, idempotent failures only**: a connection-level
  failure before any response byte, or an admission 503 (queue full /
  draining), moves the request to ANOTHER worker — at most
  ``max_retries`` times, never the same worker twice, because nothing
  was admitted anywhere.  Anything after admission is relayed
  verbatim; a stream that breaks mid-generation gets a synthesized
  terminal error line (the stream contract: never silence), NOT a
  retry — the generation was not idempotent once tokens flowed.

The router is itself a scrape source in the merged fleet view
(``ROUTER_RANK``, labeled "router"), so ``/fleet/trace.json`` shows the
``router.proxy`` span and the worker's queue/prefill/decode/stream
spans of one request on ONE synthetic track — the ``X-Request-Id`` the
router mints is honored by the worker (serve/server.py) and
``federation.request_track`` derives the track from it on both sides.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from typing import Optional

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.observe import registry as _reg
from znicz_tpu_torch.observe import trace as _trace
from znicz_tpu_torch.observe.federation import next_request_id, request_track
from znicz_tpu_torch.serve.server import _JsonHandler

#: aggregator source rank for the router's own registry/trace — far
#: above any worker rank the pool will ever mint, and outside
#: merge_traces' 1000+i rank-less fallback band
ROUTER_RANK = 9000

_M_REQUESTS = _reg.counter(
    "znicz_router_requests_total",
    "routed requests by plane and outcome (ok / error / rejected / "
    "client_gone)",
    labelnames=("plane", "outcome"))
_M_RETRIES = _reg.counter(
    "znicz_router_retries_total",
    "admission failures moved to another worker (connection refused "
    "or 503 before any admission — idempotent by construction)")
_M_PROXY_SECONDS = _reg.histogram(
    "znicz_router_proxy_seconds",
    "router-side wall time of one proxied request (pick -> terminal "
    "byte relayed)",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
             2.5, 5.0, 10.0, 30.0, 120.0))
_M_INFLIGHT = _reg.gauge(
    "znicz_router_inflight",
    "requests currently inside the router (admitted, not yet terminal)")
_M_WORKERS_READY = _reg.gauge(
    "znicz_router_workers_ready",
    "workers in rotation as the router sees them (ready and not "
    "retiring; newest router wins)")


class NoReadyWorker(RuntimeError):
    """Every pick attempt was exhausted (or no worker is ready)."""


class FleetRouter(Logger):
    """The assembled front end over a
    :class:`~znicz_tpu_torch.fleet.workers.WorkerPool`; see module docstring.

    ``upstream_timeout_s`` bounds one /predict proxy (and a /generate
    admission + inter-line gap); a worker that stalls longer mid-stream
    gets its stream terminated with the error sentinel."""

    def __init__(self, pool, port: int = 0, max_retries: int = 2,
                 upstream_timeout_s: float = 120.0) -> None:
        super().__init__()
        self.pool = pool
        self.port = int(port)
        self.max_retries = int(max_retries)
        self.upstream_timeout_s = float(upstream_timeout_s)
        self.rollout = None             # attach_rollout
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.started_at = time.monotonic()
        self._ledger = {"admitted": 0, "completed": 0, "failed": 0,
                        "rejected": 0, "retries": 0, "client_gone": 0}
        self._inflight = 0
        _M_WORKERS_READY.set_function(
            lambda: float(self.pool.ready_count()))

    def attach_rollout(self, rollout) -> None:
        """Mount a :class:`~znicz_tpu_torch.fleet.rollout.RollingUpdate` on
        the admin endpoints (GET/POST /rollout) and surface its state
        machine top-level in ``/fleet/status.json`` (the learn
        bridge and operators gate adoption on
        one document)."""
        self.rollout = rollout
        self.pool.aggregator.register_status_provider(
            "rollout",
            lambda: {k: v for k, v in rollout.status().items()
                     if k != "steps"})

    # -- ledger --------------------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._ledger[key] += n

    def _track_inflight(self, delta: int) -> None:
        with self._lock:
            self._inflight += delta
            _M_INFLIGHT.set(self._inflight)

    def snapshot(self) -> dict:
        with self._lock:
            ledger = dict(self._ledger)
        ledger["inflight"] = self._inflight
        ledger["uptime_s"] = round(time.monotonic() - self.started_at, 3)
        ledger["workers_ready"] = self.pool.ready_count()
        return ledger

    # -- picking -------------------------------------------------------------
    def pick(self, exclude=()) -> "object":
        """Least-loaded ready worker not in ``exclude``; raises
        :class:`NoReadyWorker` when rotation is empty."""
        candidates = [w for w in self.pool.ready_workers()
                      if w.rank not in exclude]
        if not candidates:
            raise NoReadyWorker(
                f"no ready worker ({self.pool.worker_count()} in pool, "
                f"{len(exclude)} already tried)")
        return min(candidates, key=lambda w: (w.load(), w.rank))

    # -- proxying ------------------------------------------------------------
    def _upstream(self, worker, path: str, body: bytes, rid: str):
        """Open one upstream POST; returns the live response.  Raises
        ``urllib.error.HTTPError`` (status answer) or ``URLError`` /
        ``OSError`` (no answer at all)."""
        req = urllib.request.Request(
            worker.base + path, data=body,
            headers={"Content-Type": "application/json",
                     "X-Request-Id": rid})
        return urllib.request.urlopen(req,
                                      timeout=self.upstream_timeout_s)

    def _finish(self, plane: str, outcome: str, rid: str, t0: float,
                worker_rank, attempts: int) -> None:
        """One terminal accounting point per routed request — ledger,
        registry, and the ``router.proxy`` span on the request's
        track."""
        dur = time.perf_counter() - t0
        self._count("completed" if outcome == "ok" else
                    "client_gone" if outcome == "client_gone" else
                    "failed")
        _M_REQUESTS.labels(plane=plane, outcome=outcome).inc()
        _M_PROXY_SECONDS.observe(dur)
        _trace.TRACER.complete(
            "router.proxy", t0, dur, tid=request_track(rid), rid=rid,
            plane=plane, outcome=outcome, worker=worker_rank,
            attempts=attempts)

    def _route(self, handler, plane: str, body: bytes, rid: str) -> None:
        """The shared admission/retry loop for both planes.  A worker
        answer (ANY status) ends the retry loop except an admission
        503, which is idempotent by definition — nothing was admitted."""
        t0 = time.perf_counter()
        self._count("admitted")
        self._track_inflight(1)
        attempts = 0
        tried: set = set()
        last_error = "no ready worker"
        try:
            while attempts <= self.max_retries:
                try:
                    worker = self.pick(exclude=tried)
                except NoReadyWorker as exc:
                    last_error = str(exc)
                    break
                tried.add(worker.rank)
                attempts += 1
                worker.add_inflight(1)
                try:
                    response = self._upstream(
                        worker, f"/{plane}", body, rid)
                except urllib.error.HTTPError as exc:
                    payload = exc.read()
                    if exc.code == 503 and attempts <= self.max_retries:
                        last_error = f"worker {worker.rank}: 503"
                        self._count("retries")
                        _M_RETRIES.inc()
                        continue
                    # a non-retryable worker verdict (400/404/500/504,
                    # or a 503 with the budget spent): relay verbatim.
                    # A client that hung up first must still reach
                    # _finish — every admitted request gets EXACTLY one
                    # terminal accounting, whichever side died
                    try:
                        handler._reply_raw(
                            exc.code, payload,
                            exc.headers.get("Content-Type")
                            or "application/json", rid=rid)
                        outcome = "error"
                    except OSError:
                        outcome = "client_gone"
                    self._finish(plane, outcome, rid, t0, worker.rank,
                                 attempts)
                    return
                except (urllib.error.URLError, OSError) as exc:
                    # no response at all — connection refused mid-boot,
                    # reset on a SIGKILL'd worker: nothing admitted
                    last_error = f"worker {worker.rank}: {exc!r}"
                    self._count("retries")
                    _M_RETRIES.inc()
                    continue
                finally:
                    worker.add_inflight(-1)
                # -- admitted: relay the response, no more retries --
                worker.add_inflight(1)
                try:
                    outcome = self._relay(handler, response, rid)
                finally:
                    worker.add_inflight(-1)
                    response.close()
                self._finish(plane, outcome, rid, t0, worker.rank,
                             attempts)
                return
            # admission failed everywhere inside the budget — counted
            # BEFORE the reply flushes so a client that reacts to the
            # 503 instantly still reads a settled ledger
            with self._lock:
                self._ledger["rejected"] += 1
                self._ledger["admitted"] -= 1    # never admitted: the
            #   router ledger mirrors the workers' (admitted == one
            #   terminal outcome each; rejected rides its own column)
            _M_REQUESTS.labels(plane=plane, outcome="rejected").inc()
            handler._reply(503, {"error": f"no worker admitted the "
                                          f"request after {attempts} "
                                          f"attempt(s): {last_error}"},
                           headers=(("Retry-After", "1"),
                                    ("X-Request-Id", rid)))
        finally:
            self._track_inflight(-1)

    def _relay(self, handler, response, rid: str) -> str:
        """Relay one upstream 200 to the client.  ndjson streams are
        flushed line by line; anything else is relayed whole.  Returns
        the outcome: a broken upstream mid-stream synthesizes the
        terminal error line (never silence), a gone client cancels
        upstream by closing it."""
        ctype = response.headers.get("Content-Type") or \
            "application/json"
        if "ndjson" not in ctype:
            body = response.read()
            try:
                handler._reply_raw(response.status, body, ctype,
                                   rid=rid)
            except OSError:             # client hung up waiting: the
                return "client_gone"    # ledger must still close
            return "ok"
        try:
            handler.send_response(response.status)
            handler.send_header("Content-Type", ctype)
            handler.send_header("X-Request-Id", rid)
            handler.end_headers()       # close-delimited, like the worker
        except OSError:
            return "client_gone"
        while True:
            try:
                line = response.readline()
            except (OSError, ValueError) as exc:
                # upstream died mid-stream (chaos SIGKILL): the client
                # still gets EXACTLY ONE terminal event
                line = (json.dumps(
                    {"error": f"worker stream broke mid-generation: "
                              f"{exc!r}", "done": True}) + "\n").encode()
                try:
                    handler.wfile.write(line)
                    handler.wfile.flush()
                except OSError:
                    return "client_gone"
                return "error"
            if not line:
                # upstream closed WITHOUT a terminal line — the worker
                # contract says this cannot happen after admission, but
                # a killed process closes sockets without ceremony
                try:
                    handler.wfile.write(
                        (json.dumps({"error": "worker stream ended "
                                              "without a terminal "
                                              "event", "done": True})
                         + "\n").encode())
                    handler.wfile.flush()
                except OSError:
                    return "client_gone"
                return "error"
            try:
                handler.wfile.write(line)
                handler.wfile.flush()
            except OSError:
                return "client_gone"    # closing upstream cancels the
            #                             generation (abandoned)
            try:
                doc = json.loads(line)
            except ValueError:
                doc = {}
            if doc.get("done"):
                return "error" if "error" in doc else "ok"

    # -- admin ---------------------------------------------------------------
    def meta_doc(self) -> dict:
        return {"router": self.snapshot(),
                "pool": self.pool.snapshot(),
                "rollout": self.rollout.status()
                if self.rollout is not None else None}

    # -- HTTP ----------------------------------------------------------------
    def start(self) -> int:
        router = self

        class Handler(_JsonHandler):
            def _reply_raw(self, code: int, body: bytes, ctype: str,
                           rid: Optional[str] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if rid:
                    self.send_header("X-Request-Id", rid)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/fleet/"):
                    payload = router.pool.aggregator.http_payload(
                        self.path)
                    if payload is None:
                        self._reply(404, {"error": self.path})
                    else:
                        self._reply_raw(200, *payload)
                elif self.path.startswith("/metrics.prom"):
                    self._reply_prom()
                elif self.path.startswith("/metrics"):
                    self._reply(200, router.meta_doc())
                elif self.path.startswith("/trace.json"):
                    self._reply_trace()
                elif self.path.startswith("/livez") or \
                        self.path.startswith("/healthz"):
                    self._reply(200, {"status": "ok"})
                elif self.path.startswith("/readyz"):
                    ready = router.pool.ready_count() > 0
                    self._reply(200 if ready else 503,
                                {"status": "ready" if ready
                                 else "no_ready_worker",
                                 "workers_ready":
                                     router.pool.ready_count()})
                elif self.path.startswith("/rollout"):
                    if router.rollout is None:
                        self._reply(404, {"error": "no rollout "
                                                   "machinery attached"})
                    else:
                        self._reply(200, router.rollout.status())
                else:
                    self._reply(200, router.meta_doc())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if self.path.startswith("/predict"):
                    plane = "predict"
                elif self.path.startswith("/generate"):
                    plane = "generate"
                elif self.path.startswith("/rollout"):
                    self._admin_rollout(body)
                    return
                else:
                    self._reply(404, {"error": "POST /predict | "
                                               "/generate | /rollout"})
                    return
                rid = self.headers.get("X-Request-Id") or \
                    next_request_id()
                try:
                    router._route(self, plane, body, rid)
                except Exception as exc:  # noqa: BLE001 — one request
                    router.error(f"route failed: {exc!r}")
                    try:
                        self._reply(500, {"error": repr(exc)})
                    except OSError:
                        pass

            def _admin_rollout(self, body: bytes) -> None:
                if router.rollout is None:
                    self._reply(404, {"error": "no rollout machinery "
                                               "attached"})
                    return
                try:
                    doc = json.loads(body)
                    package = doc["package"]
                except (ValueError, KeyError, TypeError) as exc:
                    self._reply(400, {"error": f"body needs "
                                               f'{{"package": path}}: '
                                               f"{exc!r}"})
                    return
                try:
                    router.rollout.start(package)
                except ValueError as exc:     # already rolling / bad pkg
                    self._reply(409, {"error": str(exc)})
                    return
                self._reply(202, {"started": True,
                                  "status": router.rollout.status()})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port),
                                          Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="fleet-router")
        self._thread.start()
        # the router joins the merged fleet view as a labeled source:
        # /fleet/trace.json then shows router.proxy -> worker phases of
        # one request on one track, and /fleet/metrics.prom carries the
        # znicz_router_* families beside the workers'
        self.pool.aggregator.add_http_source(
            ROUTER_RANK, f"http://127.0.0.1:{self.port}",
            label="router")
        self.info(f"fleet router on http://127.0.0.1:{self.port}/ "
                  f"({self.pool.worker_count()} worker(s))")
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.pool.aggregator.remove_source(ROUTER_RANK)
