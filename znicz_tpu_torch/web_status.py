"""Web status dashboard — the port of ``znicz_tpu/web_status.py``
(rebuild of veles/web_status.py).

A minimal in-process HTTP endpoint on the training host:
``/status.json`` reports every registered workflow's name, epoch,
metrics history and per-unit timing (plus the watchtower's time-series
digest under ``"watchtower"``); ``/metrics`` serves the process-global
telemetry registry in Prometheus text exposition format; ``/trace.json``
dumps the global tracer's ring buffer as Chrome-trace JSON (Perfetto);
``/timeseries.json`` serves the watchtower's retained delta ring
(``observe/watchtower.py``); ``register_fleet`` mounts a fleet
aggregator's merged cross-process view under ``/fleet/*``
(``observe/federation.py``); ``/`` renders a plain HTML table.  Stdlib
``http.server`` on a daemon thread.  The observe plane it reads is the
port's (copies of the reference's modules), so nothing here touches the
card.  A copy of the reference's module, under the drift check of
``tests/test_torch_port_isolation.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from znicz_tpu_torch import observe
from znicz_tpu_torch.core.logger import Logger


class WebStatus(Logger):
    """Serve live status for one or more workflows."""

    def __init__(self, port: int = 0) -> None:
        super().__init__()
        self.workflows: list = []
        self.serving: list = []
        self.health: list = []
        self.pipelines: list = []
        self.fleet = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port = port

    def register(self, workflow) -> "WebStatus":
        self.workflows.append(workflow)
        return self

    def register_serving(self, name: str, source) -> "WebStatus":
        """Surface a serving plane's metrics in ``/status.json``.

        ``source``: a ``ServeServer`` (its ``metrics_snapshot``), any
        object with a ``snapshot()`` (e.g. ``ServingMetrics``), or a
        zero-arg callable returning a dict.
        """
        fn = getattr(source, "metrics_snapshot", None) or \
            getattr(source, "snapshot", None) or source
        if not callable(fn):
            raise TypeError(f"register_serving needs a snapshot source, "
                            f"got {source!r}")
        self.serving.append((str(name), fn))
        return self

    def register_health(self, name: str, guard) -> "WebStatus":
        """Surface a resilience guard's trip counters in ``/status.json``
        (next to the serving metrics): ``guard`` is a
        :class:`~znicz_tpu.resilience.health.HealthGuard`, anything with
        a ``snapshot()``, or a zero-arg callable returning a dict."""
        fn = getattr(guard, "snapshot", None) or guard
        if not callable(fn):
            raise TypeError(f"register_health needs a snapshot source, "
                            f"got {guard!r}")
        self.health.append((str(name), fn))
        return self

    def register_pipeline(self, name: str, pipeline) -> "WebStatus":
        """Surface an input pipeline's stall accounting in
        ``/status.json`` (next to the serving and health metrics):
        ``pipeline`` is a
        :class:`~znicz_tpu.pipeline.BatchPrefetcher` (its
        ``stats_snapshot``), anything with a ``snapshot()``, or a
        zero-arg callable returning a dict."""
        fn = getattr(pipeline, "stats_snapshot", None) or \
            getattr(pipeline, "snapshot", None) or pipeline
        if not callable(fn):
            raise TypeError(f"register_pipeline needs a snapshot source, "
                            f"got {pipeline!r}")
        self.pipelines.append((str(name), fn))
        return self

    def register_fleet(self, aggregator) -> "WebStatus":
        """Mount a :class:`~znicz_tpu.observe.federation.
        FleetAggregator`'s merged cross-process view under ``/fleet/*``
        (``/fleet/metrics``, ``/fleet/metrics.prom``,
        ``/fleet/status.json``, ``/fleet/trace.json``) — ISSUE 11."""
        self.fleet = aggregator
        return self

    # -- payload ------------------------------------------------------------
    def snapshot(self) -> dict:
        out = []
        for w in self.workflows:
            dec = getattr(w, "decision", None)
            out.append({
                "name": w.name,
                "epoch": (int(dec.epoch_number) if dec is not None else None),
                "complete": bool(dec.complete) if dec is not None else None,
                "best_metric": dec.best_metric if dec is not None else None,
                "history": list(dec.metrics_history) if dec is not None
                else [],
                "units": [
                    {"name": u.name, "runs": u.timing[0],
                     "time_s": round(u.timing[1], 4)} for u in w.units],
            })
        doc = {"workflows": out}
        for key, sources in (("serving", self.serving),
                             ("health", self.health),
                             ("pipeline", self.pipelines)):
            section = {}
            for name, fn in sources:
                try:
                    section[name] = fn()
                except Exception as exc:  # noqa: BLE001 — a dead plane
                    section[name] = {"error": repr(exc)}  # must not kill
            if section:                                   # the dashboard
                doc[key] = section
        # the shared telemetry plane rides along under its own top-level
        # keys — "metrics"/"watchtower" collide with none of the
        # per-plane sections above (workflows/serving/health/pipeline),
        # pinned by tests/test_observe.py
        doc["metrics"] = observe.REGISTRY.snapshot()
        doc["watchtower"] = observe.WATCHTOWER.snapshot()
        return doc

    # -- server -------------------------------------------------------------
    def start(self) -> int:
        status = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence request logging
                pass

            def do_GET(self):
                if self.path.startswith("/fleet/") and \
                        status.fleet is not None:
                    payload = status.fleet.http_payload(self.path)
                    if payload is not None:
                        body, ctype = payload
                        self.send_response(200)
                        self.send_header("Content-Type", ctype)
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                if self.path.startswith("/status.json"):
                    body = json.dumps(status.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    # Prometheus text exposition of the process-global
                    # registry — the scrape target
                    body = observe.REGISTRY.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.startswith("/trace.json"):
                    # Chrome-trace dump of the tracer ring (Perfetto)
                    body = json.dumps(
                        observe.TRACER.export_dict()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/timeseries.json"):
                    # the watchtower's retained delta ring: replay
                    # base + samples in order to reconstruct every
                    # metric's history (docs/OBSERVABILITY.md)
                    body = json.dumps(
                        observe.WATCHTOWER.timeseries_dict()).encode()
                    ctype = "application/json"
                else:
                    rows = "".join(
                        f"<tr><td>{w['name']}</td><td>{w['epoch']}</td>"
                        f"<td>{w['best_metric']}</td>"
                        f"<td>{w['complete']}</td></tr>"
                        for w in status.snapshot()["workflows"])
                    body = (f"<html><body><h1>znicz_tpu status</h1>"
                            f"<table border=1><tr><th>workflow</th>"
                            f"<th>epoch</th><th>best</th><th>done</th></tr>"
                            f"{rows}</table></body></html>").encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.info(f"web status on http://127.0.0.1:{self.port}/")
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
