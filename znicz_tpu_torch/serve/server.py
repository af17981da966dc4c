"""HTTP front end + CLI of the generative serving plane — the
counterpart of ``znicz_tpu/serve/server.py``'s ``generate`` half.

    POST /generate      streaming (ndjson) or single-document generation
    GET  /metrics       -> {"generate": ..., "decoder": ...}
    GET  /metrics.prom  -> process registry, Prometheus text
    GET  /trace.json    -> span ring incl. per-request phase spans
    GET  /healthz | /livez | /readyz | /

CLI:  python -m znicz_tpu_torch generate <lm.npz> [--prompt TEXT |
          --tokens IDS] [--serve --port N --slots B] [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device; with no card
and no ``--device cpu`` the CLI exits non-zero with a message.  The
forward-package ``serve`` plane comes with a later slice of the port.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.observe import trace as _trace
from znicz_tpu_torch.observe.federation import (next_request_id,
                                                request_track)
from znicz_tpu_torch.serve.batcher import QueueFull


class _JsonHandler(BaseHTTPRequestHandler):
    """Shared HTTP scaffolding of the serving planes: silent access log,
    one JSON reply helper, one healthz shape — the front ends must never
    drift on the envelope load balancers and scrapers read."""

    def log_message(self, *args):
        pass

    def _reply(self, code: int, doc: dict, headers=()) -> None:
        body = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_healthz(self, draining: bool) -> None:
        self._reply(503 if draining else 200,
                    {"status": "draining" if draining else "ok"})

    # -- liveness vs readiness ------------------------------------------------
    # The fleet router routes on READINESS and restarts on LIVENESS,
    # the two questions k8s-style probes keep distinct: a draining or
    # mid-reboot worker is alive (do not replace it) but must stop
    # receiving traffic before its drain completes.  /healthz keeps its
    # historical shape (alive-and-accepting) for existing monitors.
    def _reply_livez(self) -> None:
        """``GET /livez``: 200 while the process serves HTTP at all —
        draining included.  Only a dead listener fails this probe."""
        self._reply(200, {"status": "ok"})

    def _reply_readyz(self, draining: bool, package=None) -> None:
        """``GET /readyz``: 200 only while this worker should receive
        NEW traffic; carries the package fingerprint so a rolling
        weight update can gate on what the worker actually serves."""
        doc = {"status": "draining" if draining else "ready"}
        if package is not None:
            doc["package"] = package
        self._reply(503 if draining else 200, doc)

    def _request_id(self) -> str:
        """The request's trace id: honor an ``X-Request-Id`` minted
        upstream (the fleet router's router->worker correlation key)
        so every phase span of one request shares a track
        across processes; mint one only at the true admission edge."""
        return self.headers.get("X-Request-Id") or next_request_id()

    def _reply_prom(self) -> None:
        """``GET /metrics.prom``: the process-global registry in
        Prometheus text — the fleet aggregator's scrape target."""
        from znicz_tpu_torch.observe.registry import REGISTRY

        body = REGISTRY.render_prometheus().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_trace(self) -> None:
        """``GET /trace.json``: this worker's tracer ring (request
        phase spans included), rank-anchored so
        ``federation.merge_traces`` / ``/fleet/trace.json`` can align
        it with its peers."""
        from znicz_tpu_torch.observe.trace import TRACER

        self._reply(200, TRACER.export_dict())


def encode_chars(text: str, charmap) -> list:
    """THE charmap text encoder (id <- character), shared by the HTTP
    front end and the CLI so out-of-vocab handling cannot drift: every
    character must be in the model's vocab — unknown characters fail
    loudly instead of aliasing to id 0."""
    stoi = {c: i for i, c in enumerate(charmap)}
    missing = sorted({c for c in text if c not in stoi})
    if missing:
        raise ValueError(f"prompt contains characters outside the "
                         f"model vocab: {missing[:8]!r}")
    return [stoi[c] for c in text]


class GenerateServer(Logger):
    """The assembled generative plane: KV-cache decoder + continuous
    batcher + streaming HTTP.

    ::

        POST /generate  {"prompt": "text"} | {"tokens": [ids]},
                        "max_tokens": 32, "temperature": 0.0,
                        "top_k": 0, "seed": 0, "timeout_s": 60,
                        "stream": true
            -> 200 ndjson stream: {"token": id[, "text": "c"]} per
               token, then EXACTLY ONE terminal line — {"done": true,
               "reason": "length", "n_tokens": N} or the error sentinel
               {"error": "...", "done": true} (a stream NEVER just goes
               quiet — the chaos drill pins this)
            |  200 single JSON document with "stream": false
            |  400 bad input | 503 queue full | 504 deadline (non-
               stream mode; streamed deadlines arrive as the sentinel)
        GET  /metrics       -> {"generate": ..., "decoder": ...}
        GET  /metrics.prom  -> process registry, Prometheus text
        GET  /trace.json    -> span ring incl. per-request phase spans
                               (queue/prefill/decode/stream, linked by
                               request id on one synthetic track)
        GET  /healthz       -> 200 ok | 503 draining
        GET  /livez         -> 200 while the process serves HTTP
        GET  /readyz        -> 200 ready + package fingerprint
                               | 503 draining (router routing gate)
        GET  /              -> model metadata

    ``charmap`` (id -> character, from the LM package) enables text
    prompts and per-token ``"text"`` fields; tokens-only models speak
    raw ids.
    """

    def __init__(self, batcher, charmap=None, port: int = 0,
                 name: str = "lm", package_info: dict | None = None) -> None:
        super().__init__()
        #: content fingerprint of the package this worker booted from,
        #: served on /readyz so rolling weight updates can gate on it
        self.package_info = package_info
        self.batcher = batcher
        self.decoder = batcher.decoder
        self.metrics = batcher.metrics
        self.name = name
        self.charmap = list(charmap) if charmap else None
        self.port = int(port)
        self._httpd = None
        self._thread = None

    # -- text codec ----------------------------------------------------------
    def encode(self, text: str) -> list:
        if self.charmap is None:
            raise ValueError("this model has no charmap; send "
                             "{\"tokens\": [...]} instead of a text "
                             "prompt")
        return encode_chars(text, self.charmap)

    def decode_text(self, ids) -> str:
        if self.charmap is None:
            return ""
        return "".join(self.charmap[i] for i in ids
                       if 0 <= i < len(self.charmap))

    # -- payloads ------------------------------------------------------------
    def metrics_snapshot(self) -> dict:
        return {"generate": self.metrics.snapshot(),
                "decoder": self.decoder.stats()}

    def meta_snapshot(self) -> dict:
        return {"model": {"name": self.name, "kind": "lm",
                          "vocab": self.decoder.vocab,
                          "charmap": self.charmap is not None},
                "max_len": self.decoder.max_len,
                "slots": self.decoder.batch,
                "paged": bool(getattr(self.decoder, "paged", False)),
                "package": self.package_info,
                "n_requests": self.metrics.snapshot()["admitted"]}

    def _submit_doc(self, doc: dict, request_id: str | None = None):
        """Parse one /generate body and admit it; returns the stream.
        Raises ValueError (400) / QueueFull (503)."""
        if "tokens" in doc:
            ids = [int(t) for t in doc["tokens"]]
        elif "prompt" in doc:
            ids = self.encode(str(doc["prompt"]))
        else:
            raise ValueError('body needs "prompt" or "tokens"')
        return self.batcher.submit(
            ids,
            max_new_tokens=int(doc.get("max_tokens", 32)),
            temperature=float(doc.get("temperature", 0.0)),
            top_k=int(doc.get("top_k", 0)),
            seed=int(doc.get("seed", 0)),
            timeout_s=doc.get("timeout_s"),
            request_id=request_id)

    # -- HTTP ----------------------------------------------------------------
    def start(self) -> int:
        plane = self

        class Handler(_JsonHandler):
            def do_GET(self):
                if self.path.startswith("/metrics.prom"):
                    self._reply_prom()
                elif self.path.startswith("/metrics"):
                    self._reply(200, plane.metrics_snapshot())
                elif self.path.startswith("/trace.json"):
                    self._reply_trace()
                elif self.path.startswith("/livez"):
                    self._reply_livez()
                elif self.path.startswith("/readyz"):
                    self._reply_readyz(plane.batcher.draining,
                                       plane.package_info)
                elif self.path.startswith("/healthz"):
                    self._reply_healthz(plane.batcher.draining)
                else:
                    self._reply(200, plane.meta_snapshot())

            def _slack(self, timeout_s) -> float:
                """How long to wait on the stream before declaring the
                worker wedged: the request's own deadline (explicit, or
                the batcher's configured default — NOT a hardcoded
                constant a --timeout-s flag would silently undercut)
                plus grace."""
                return (timeout_s or plane.batcher.default_timeout_s
                        or 60.0) + 30.0

            def _stream_events(self, stream, timeout_s) -> None:
                """ndjson relay: every event the batcher emits becomes
                one flushed line; a client that hangs up cancels the
                generation (abandoned-request accounting).  The relay
                itself is the request's ``generate.stream`` phase span
                — queue/prefill/decode cover the worker side, this one
                covers the wire."""
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("X-Request-Id", stream.request_id)
                self.end_headers()      # no Content-Length: close-delimited
                # terminal events are guaranteed; the slack only guards
                # a wedged worker from pinning this handler thread
                slack = self._slack(timeout_s)
                t_stream = time.perf_counter()
                n_events = 0
                try:
                    while True:
                        try:
                            event = stream.next_event(timeout=slack)
                        except TimeoutError:
                            # the client gets a terminal error NOW;
                            # cancel so a later-recovering worker frees
                            # the slot instead of decoding for a gone
                            # client
                            stream.cancel()
                            event = {"error": "stream stalled (worker "
                                     "unresponsive)", "done": True}
                        if "token" in event and plane.charmap is not None:
                            event = {**event, "text":
                                     plane.decode_text([event["token"]])}
                        try:
                            self.wfile.write(
                                (json.dumps(event) + "\n").encode())
                            self.wfile.flush()
                            n_events += 1
                        except (BrokenPipeError, ConnectionResetError,
                                OSError):
                            stream.cancel()  # client hung up: free the
                            return           # slot, count it abandoned
                        if event.get("done"):
                            return
                finally:
                    _trace.TRACER.complete(
                        "generate.stream", t_stream,
                        time.perf_counter() - t_stream,
                        tid=request_track(stream.request_id),
                        rid=stream.request_id, events=n_events)

            def do_POST(self):
                if not self.path.startswith("/generate"):
                    self._reply(404, {"error": "POST /generate"})
                    return
                rid = self._request_id()     # router-minted or admission
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    doc = json.loads(self.rfile.read(n))
                    if not isinstance(doc, dict):
                        raise ValueError("body must be a JSON object")
                    stream = plane._submit_doc(doc, request_id=rid)
                except QueueFull as exc:
                    self._reply(503, {"error": str(exc)},
                                headers=(("Retry-After", "1"),))
                    return
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as exc:
                    self._reply(400, {"error": str(exc)})
                    return
                if doc.get("stream", True):
                    self._stream_events(stream, doc.get("timeout_s"))
                    return
                from znicz_tpu_torch.serve.continuous import GenerationError
                try:
                    ids = stream.result(
                        timeout_s=self._slack(doc.get("timeout_s")))
                except GenerationError as exc:
                    code = 504 if "deadline" in str(exc) else 500
                    self._reply(code, {"error": str(exc),
                                       "n_tokens": len(stream.tokens)})
                    return
                except TimeoutError as exc:
                    stream.cancel()     # free the slot for a client
                    self._reply(500, {"error": str(exc)})  # that's gone
                    return
                self._reply(200, {"tokens": ids,
                                  "text": plane.decode_text(ids),
                                  "reason": "length",
                                  "n_tokens": len(ids),
                                  "request_id": stream.request_id},
                            headers=(("X-Request-Id",
                                      stream.request_id),))

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port),
                                          Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="generate-http")
        self._thread.start()
        self.info(f"generating on http://127.0.0.1:{self.port}/ "
                  f"({self.decoder.batch} slots, max_len "
                  f"{self.decoder.max_len})")
        return self.port

    def stop(self, drain: bool = True) -> None:
        """Graceful shutdown in load-balancer-observable order: the
        batcher drains first (healthz says 503 draining, new /generate
        admissions 503), then the listener closes."""
        self.batcher.stop(drain=drain)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None



# -- CLI ---------------------------------------------------------------------

def build_generate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch generate",
        description="generate tokens from an LM package — one-shot to "
                    "stdout, or a streaming HTTP server with "
                    "continuous batching")
    p.add_argument("package", help="path to an LM package (export_lm)")
    p.add_argument("--prompt", default=None,
                   help="text prompt (one-shot mode unless --serve)")
    p.add_argument("--tokens", default=None,
                   help="comma-separated token ids instead of --prompt")
    p.add_argument("--max-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 samples (seeded, reproducible)")
    p.add_argument("--top-k", type=int, default=0,
                   help="truncate sampling to the k most likely (0 = "
                        "full vocab)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-len", type=int, default=256,
                   help="cache-length ceiling (prompt + generation)")
    p.add_argument("--serve", action="store_true",
                   help="serve POST /generate with continuous batching "
                        "instead of a one-shot generation")
    p.add_argument("--port", type=int, default=8080,
                   help="listen port (0 picks a free one)")
    p.add_argument("--slots", type=int, default=4,
                   help="decode-batch width (concurrent generations)")
    p.add_argument("--max-queue", type=int, default=64,
                   help="requests waiting for a slot; beyond it -> 503")
    p.add_argument("--timeout-s", type=float, default=60.0,
                   help="default per-request deadline")
    p.add_argument("--no-paged", action="store_true",
                   help="serve from per-slot contiguous cache buckets "
                        "instead of the block-paged KV arena")
    p.add_argument("--page-size", type=int, default=16,
                   help="KV arena rows per page (paged serving)")
    p.add_argument("--arena-pages", type=int, default=0,
                   help="total KV arena pages shared by all slots "
                        "(0 = worst case: slots x max_len rows); "
                        "smaller values bank on the long tail and set "
                        "the real slot ceiling")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda; there is "
                        "no automatic CPU fallback — pass cpu to run "
                        "on the CPU)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip exercising every cache bucket at boot")
    p.add_argument("--smoke-test", action="store_true",
                   help="start, stream one self-request, exit (CI "
                        "probe)")
    return p


def _parse_prompt(args, charmap) -> list:
    if args.tokens is not None:
        return [int(t) for t in args.tokens.split(",") if t.strip()]
    if args.prompt is None:
        raise ValueError("need --prompt or --tokens")
    if not charmap:
        raise ValueError("this package has no charmap; use --tokens")
    return encode_chars(args.prompt, charmap)


def start_generate_server(args, params, meta) -> GenerateServer:
    """Boot the serving half of ``generate``: decoder (the paged arena
    unless ``--no-paged``), warmup, continuous batcher, HTTP listener.
    Returns the started server; ``server.port`` is the bound port."""
    from znicz_tpu_torch.serve.continuous import ContinuousBatcher
    from znicz_tpu_torch.utils.naming import package_fingerprint

    if args.no_paged:
        from znicz_tpu_torch.serve.kvcache import KVDecoder

        decoder = KVDecoder(params, heads=meta["heads"],
                            max_len=args.max_len, batch=args.slots,
                            device=args.device)
    else:
        from znicz_tpu_torch.serve.paged import PagedKVDecoder

        decoder = PagedKVDecoder(
            params, heads=meta["heads"], max_len=args.max_len,
            batch=args.slots, page=args.page_size,
            arena_pages=args.arena_pages or None, device=args.device)
    if not args.no_warmup:
        decoder.warmup()
    batcher = ContinuousBatcher(decoder, max_queue=args.max_queue,
                                default_timeout_s=args.timeout_s)
    server = GenerateServer(batcher, charmap=meta.get("charmap"),
                            port=args.port, name=meta.get("name", "lm"),
                            package_info=package_fingerprint(args.package))
    server.start()
    return server


def _one_shot(args, params, meta) -> int:
    """Stream one generation to stdout as it decodes."""
    from znicz_tpu_torch.serve.kvcache import KVDecoder, TokenSampler

    charmap = meta.get("charmap")
    try:
        ids = _parse_prompt(args, charmap)
        decoder = KVDecoder(params, heads=meta["heads"],
                            max_len=args.max_len, batch=1,
                            device=args.device)
        sampler = TokenSampler(seed=args.seed,
                               temperature=args.temperature,
                               top_k=args.top_k)

        def on_token(tok: int) -> None:
            if charmap:
                print(charmap[tok], end="", flush=True)
            else:
                print(tok, end=" ", flush=True)

        out = decoder.generate(ids, args.max_tokens, sampler,
                               on_token=on_token)
    except ValueError as exc:
        print(f"generate: {exc}")
        return 2
    print()
    print(json.dumps({"n_tokens": len(out), "prompt_tokens": len(ids),
                      "decoder": decoder.stats()}), file=sys.stderr)
    return 0


def _smoke(server) -> int:
    """Stream one self-request through the HTTP front end."""
    import urllib.request

    body = {"max_tokens": 8, "temperature": 0.0}
    if server.charmap:
        body["prompt"] = server.charmap[0]
    else:
        body["tokens"] = [0]
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    lines = []
    with urllib.request.urlopen(req, timeout=60) as r:
        for raw in r:
            lines.append(json.loads(raw))
    ok = len(lines) >= 2 and lines[-1].get("done") and \
        all("token" in ln for ln in lines[:-1])
    print(json.dumps({"smoke": "ok" if ok else "bad", "port": server.port,
                      "events": len(lines),
                      "metrics": server.metrics_snapshot()}))
    server.stop()
    return 0 if ok else 1


def generate_main(argv) -> int:
    from znicz_tpu_torch.core.backends import device as _device
    from znicz_tpu_torch.utils.export import load_lm

    args = build_generate_parser().parse_args(argv)
    try:
        _device(args.device)
    except RuntimeError as exc:
        print(f"generate: {exc}", file=sys.stderr)
        return 2
    try:
        params, meta = load_lm(args.package)
    except (OSError, ValueError, KeyError) as exc:
        print(f"generate: cannot load {args.package!r}: {exc}")
        return 2
    if not (args.serve or args.smoke_test):
        return _one_shot(args, params, meta)
    server = start_generate_server(args, params, meta)
    if args.smoke_test:
        return _smoke(server)
    done = threading.Event()
    import signal

    prev = signal.signal(signal.SIGTERM, lambda *a: done.set())
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    try:
        # the handler stays installed THROUGH the drain: restoring the
        # default first would let a second SIGTERM kill the worker
        # mid-drain and lose every request it had admitted
        print("generate: draining...")
        server.stop()
    finally:
        signal.signal(signal.SIGTERM, prev)
    return 0
