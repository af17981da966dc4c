"""RESTful inference serving — the port of ``znicz_tpu/loader/restful.py``
(rebuild of the reference's ``veles/loader/restful.py`` row): an HTTP
endpoint that feeds request samples through a trained forward chain and
returns predictions; a copy.

``PredictionServer`` is a thin wrapper over
:class:`znicz_tpu_torch.serve.engine.BatchEngine`: execution pads to the
engine's bucketed batch shapes, so on the card each bucket is one CUDA
graph, captured at its first batch and replayed after.  A package path
loads an ``ExportedForward`` on the card; pass an ``ExportedForward``
built with ``device="cpu"`` to serve on the host.  For queueing,
backpressure, deadlines and metrics use the full plane:
:class:`znicz_tpu_torch.serve.server.ServeServer`.

    POST /predict  {"input": [[...], ...]}  ->  {"output": [[...], ...]}
    GET  /         -> model metadata JSON

The client side (``predict_remote``) rides
:class:`~znicz_tpu_torch.resilience.retry.RetryPolicy`: connection
failures and 5xx responses retry with backoff, 4xx (a malformed request
will not get better) raise immediately.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.resilience.retry import RetryPolicy
from znicz_tpu_torch.serve.engine import BatchEngine

#: client default: 4 attempts, 0.1 s -> 0.8 s backoff; retries OSError
#: (URLError's base covers refused/reset connections) — HTTP status
#: filtering happens in predict_remote, which re-raises 5xx as OSError
DEFAULT_CLIENT_RETRY = RetryPolicy(max_attempts=4, base_delay=0.1,
                                   multiplier=2.0, max_delay=2.0,
                                   retryable=(OSError,), seed=0)


def predict_remote(url: str, batch, policy: Optional[RetryPolicy] = None,
                   timeout: float = 30.0) -> np.ndarray:
    """RESTful client: ``POST {url}/predict`` with retries.

    Transient failures — refused/reset connections, timeouts, HTTP 5xx
    (an overloaded server shedding load with 503 is the backpressure
    design of the serve plane) — retry under ``policy``; HTTP 4xx raises
    ``ValueError`` immediately.
    """
    policy = policy or DEFAULT_CLIENT_RETRY
    url = url.rstrip("/") + "/predict"
    body = json.dumps(
        {"input": np.asarray(batch, np.float32).tolist()}).encode()

    def _call() -> np.ndarray:
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return np.asarray(json.load(resp)["output"], np.float32)
        except urllib.error.HTTPError as exc:
            if exc.code >= 500:
                raise OSError(f"server error {exc.code} from {url}") \
                    from exc
            raise ValueError(
                f"request rejected ({exc.code}) by {url}: "
                f"{exc.read()[:200]!r}") from exc

    return policy.call(_call)


class PredictionServer(Logger):
    """Serve ``model(x) -> y`` over HTTP on localhost.

    ``model``: an ``ExportedForward``, a path to a forward package
    (.npz, loaded via utils.export.ExportedForward), or any callable
    taking a float32 batch array.  ``port=0`` picks a free port.
    """

    def __init__(self, model, port: int = 0, max_batch: int = 1024) -> None:
        super().__init__()
        self.engine = BatchEngine(model, max_batch=max_batch)
        self.model = self.engine.model
        self.port = int(port)
        self.max_batch = self.engine.max_batch
        self.meta = self.engine.meta
        self.n_requests = 0
        self._lock = threading.Lock()   # engine.run locks per batch; this
        self._httpd = None              # one keeps n_requests exact
        self._thread = None

    def predict(self, batch) -> np.ndarray:
        x = np.asarray(batch, np.float32)
        if x.ndim == 1:
            x = x[None]
        if len(x) > self.max_batch:
            raise ValueError(f"batch {len(x)} > max_batch {self.max_batch}")
        with self._lock:
            self.n_requests += 1
        return self.engine.run(x)

    # -- HTTP ----------------------------------------------------------------
    def start(self) -> int:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, doc: dict) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._reply(200, {"model": server.meta,
                                  "n_requests": server.n_requests,
                                  "max_batch": server.max_batch})

            def do_POST(self):
                if not self.path.startswith("/predict"):
                    self._reply(404, {"error": "POST /predict"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    doc = json.loads(self.rfile.read(n))
                    out = server.predict(doc["input"])
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as exc:
                    self._reply(400, {"error": str(exc)})
                    return
                self._reply(200, {"output": out.tolist()})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.info(f"prediction server on http://127.0.0.1:{self.port}/")
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
