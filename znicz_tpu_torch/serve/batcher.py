"""Dynamic micro-batcher — the admission half of the forward-package
serving plane, the counterpart of ``znicz_tpu/serve/batcher.py``.

The device sustains throughput only when requests arrive in batches, but
clients arrive one at a time; the batcher decouples the two the way the
reference decoupled libVeles inference from the master process.  A
bounded queue feeds a single worker that coalesces concurrent requests
into one engine batch, up to ``engine.max_batch`` rows or ``max_wait_ms``
after the first request of the batch — the classic
latency/utilization knob.

Contract (every admitted request gets exactly one response):

- **backpressure**: a full queue rejects at submit time with
  :class:`QueueFull` — a fast 503, never a silent drop or an unbounded
  queue;
- **deadlines**: a request whose deadline lapses while queued fails with
  :class:`DeadlineExceeded` at service time — a loud timeout, never a
  stale answer;
- **oversize chunking**: a request larger than ``max_batch`` is split
  into chunks that ride separate engine batches and is reassembled in
  submission order before the response resolves;
- **graceful drain**: ``stop(drain=True)`` rejects new arrivals but
  services everything already admitted before the worker exits.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.observe import flight as _flight
from znicz_tpu_torch.observe import trace as _trace
from znicz_tpu_torch.observe.federation import next_request_id, request_track
from znicz_tpu_torch.serve.metrics import ServingMetrics


class QueueFull(RuntimeError):
    """Backpressure: the bounded queue has no room (HTTP 503)."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline lapsed before service (HTTP 504)."""


class _Request:
    """One client request; ``parts`` collects per-chunk outputs."""

    __slots__ = ("future", "deadline", "t_submit", "parts", "remaining",
                 "failed", "rid", "t0_perf")

    def __init__(self, n_chunks: int, deadline, t_submit: float,
                 rid: str) -> None:
        self.future: Future = Future()
        self.deadline = deadline            # monotonic stamp or None
        self.t_submit = t_submit
        self.parts: list = [None] * n_chunks
        self.remaining = n_chunks
        self.failed = False
        self.rid = rid                      # trace correlation key
        self.t0_perf = time.perf_counter()  # admission span anchor


class _Chunk:
    __slots__ = ("req", "index", "x")

    def __init__(self, req: _Request, index: int, x: np.ndarray) -> None:
        self.req = req
        self.index = index
        self.x = x


class MicroBatcher(Logger):
    """Coalesce concurrent requests into engine batches.

    ``engine``: a :class:`znicz_tpu_torch.serve.engine.BatchEngine` (or any
    object with ``max_batch``, ``input_shape`` and ``run(x)``).
    ``max_wait_ms``: how long the worker holds an underfull batch open
    for stragglers.  ``max_queue``: queue bound in chunks — admission
    beyond it fails fast.  ``default_timeout_s``: per-request deadline
    when ``submit`` gets none.
    """

    def __init__(self, engine, max_wait_ms: float = 2.0,
                 max_queue: int = 128, default_timeout_s: float = 30.0,
                 metrics: ServingMetrics | None = None) -> None:
        super().__init__()
        self.engine = engine
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.default_timeout_s = default_timeout_s
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._closing = False
        # flight artifacts embed the predict plane's admission ledger
        # too (see ContinuousBatcher)
        self._flight_plane = self.metrics.snapshot
        _flight.register_plane("serve_ledger", self._flight_plane)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="micro-batcher")
        self._worker.start()

    @property
    def draining(self) -> bool:
        """True once stop() began: no new admissions (healthz surfaces
        this as 503 "draining" so load balancers bleed traffic off)."""
        return self._closing

    # -- client side ---------------------------------------------------------
    def submit(self, x, timeout_s: float | None = None,
               request_id: str | None = None) -> Future:
        """Admit one request; returns a Future resolving to the output
        rows in submission order.  Raises :class:`QueueFull` immediately
        under backpressure or during drain.  ``request_id`` threads an
        HTTP-admission trace id through (one minted otherwise)."""
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        shape = getattr(self.engine, "input_shape", None)
        if shape is not None and x.shape[1:] != tuple(shape):
            raise ValueError(f"input shape {x.shape[1:]} != model input "
                             f"{tuple(shape)}")
        if x.shape[0] == 0:
            raise ValueError("empty batch")
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        now = time.monotonic()
        deadline = now + timeout_s if timeout_s is not None else None
        step = self.engine.max_batch
        n_chunks = (x.shape[0] + step - 1) // step
        if n_chunks > self.max_queue:
            # not backpressure: this request can NEVER be admitted, so
            # a retryable QueueFull would mislead — fail as bad input
            raise ValueError(
                f"request of {x.shape[0]} rows needs {n_chunks} chunks, "
                f"more than the whole queue ({self.max_queue}); raise "
                "max_queue/max_batch or split the request")
        req = _Request(n_chunks=n_chunks, deadline=deadline, t_submit=now,
                       rid=request_id or next_request_id())
        chunks = [_Chunk(req, i, x[o:o + step])
                  for i, o in enumerate(range(0, x.shape[0], step))]
        with self._cond:
            if self._closing:
                self.metrics.on_reject()
                raise QueueFull("batcher is draining")
            if len(self._queue) + len(chunks) > self.max_queue:
                self.metrics.on_reject()
                raise QueueFull(
                    f"queue full ({len(self._queue)}/{self.max_queue})")
            self._queue.extend(chunks)
            self.metrics.on_admit(len(chunks))
            self._cond.notify_all()
        return req.future

    def predict(self, x, timeout_s: float | None = None) -> np.ndarray:
        """Blocking convenience: submit and wait for the response."""
        return self.submit(x, timeout_s=timeout_s).result()

    # -- worker side ---------------------------------------------------------
    def _fail(self, req: _Request, exc: Exception) -> None:
        if not req.failed:
            req.failed = True
            # the ONE place requests terminally fail — counted per
            # REQUEST (not per chunk/batch), so the admission ledger
            # closes exactly: admitted == completed + failed
            self.metrics.on_request_failed()
            try:
                req.future.set_exception(exc)
            except Exception:   # client cancelled the future: gone, fine
                pass

    def _take(self, now: float, capacity: int | None = None):
        """Pop the next serviceable chunk under the lock; expired
        requests fail loudly here (the only place chunks leave the
        queue).  Returns None when the queue is empty or when the next
        serviceable chunk would not fit ``capacity`` rows (that chunk
        stays queued for the next batch)."""
        while self._queue:
            chunk = self._queue[0]
            req = chunk.req
            expired = req.deadline is not None and now > req.deadline
            if req.failed or expired:   # sibling timed out / deadline
                self._queue.popleft()
                self.metrics.on_dequeue()
                if expired and not req.failed:
                    self.metrics.on_timeout()
                    self._fail(req, DeadlineExceeded(
                        f"deadline lapsed after "
                        f"{now - req.t_submit:.3f}s in queue"))
                continue
            if capacity is not None and len(chunk.x) > capacity:
                return None             # would overflow the batch
            self._queue.popleft()
            self.metrics.on_dequeue()
            return chunk
        return None

    def _gather(self):
        """Block for the first chunk, then coalesce stragglers up to
        ``max_batch`` rows or ``max_wait_ms``.  Returns (chunks, rows),
        or (None, 0) when closing with an empty queue."""
        with self._cond:
            while True:
                chunk = self._take(time.monotonic())
                if chunk is not None:
                    break
                if self._closing:
                    return None, 0
                self._cond.wait()   # submit()/stop() notify_all
            batch = [chunk]
            rows = len(chunk.x)
            hold_until = time.monotonic() + self.max_wait_ms / 1000.0
            while rows < self.engine.max_batch:
                now = time.monotonic()
                if self._queue:
                    chunk = self._take(now, self.engine.max_batch - rows)
                    if chunk is not None:
                        batch.append(chunk)
                        rows += len(chunk.x)
                        continue
                    if self._queue:
                        break           # next chunk would overflow
                    continue            # queue drained by expiry; recheck
                if self._closing or now >= hold_until:
                    break
                self._cond.wait(hold_until - now)
            return batch, rows

    def _service(self, batch: list, rows: int) -> None:
        self.metrics.on_batch(rows)
        t_infer = time.perf_counter()
        try:
            # concatenate inside the guard: with no engine input_shape
            # declared, mismatched per-request widths surface here and
            # must fail the batch, not the worker
            x = batch[0].x if len(batch) == 1 else \
                np.concatenate([c.x for c in batch], axis=0)
            y = self.engine.run(x)
        except Exception as exc:  # noqa: BLE001 — fail the batch, serve on
            self.metrics.on_error()
            self.error(f"engine failed on batch of {rows}: {exc!r}")
            for chunk in batch:
                self._fail(chunk.req, exc)
            return
        now = time.monotonic()
        now_perf = time.perf_counter()
        # one engine-dispatch span per coalesced batch (worker thread —
        # strictly sequential, so batch spans nest cleanly)
        _trace.TRACER.complete("serve.infer", t_infer,
                               now_perf - t_infer, rows=rows,
                               chunks=len(batch))
        offset = 0
        for chunk in batch:
            n = len(chunk.x)
            req = chunk.req
            req.parts[chunk.index] = y[offset:offset + n]
            offset += n
            req.remaining -= 1
            if req.remaining == 0 and not req.failed:
                out = req.parts[0] if len(req.parts) == 1 else \
                    np.concatenate(req.parts, axis=0)
                try:
                    req.future.set_result(out)
                except Exception:   # cancelled mid-service: the worker
                    # must outlive any client's Future — and the ledger
                    # must still close: a cancelled request reached its
                    # terminal state (the client walked away), so it
                    # counts failed, keeping admitted == completed +
                    # failed exact
                    req.failed = True
                    self.metrics.on_request_failed()
                    continue
                self.metrics.on_complete(now - req.t_submit)
                # whole-request span (admission -> response resolved)
                # on the request's own trace track
                _trace.TRACER.complete(
                    "serve.request", req.t0_perf,
                    time.perf_counter() - req.t0_perf,
                    tid=request_track(req.rid), rid=req.rid,
                    chunks=len(req.parts))

    def _loop(self) -> None:
        while True:
            batch, rows = self._gather()
            if batch is None:
                return
            try:
                self._service(batch, rows)
            except Exception as exc:  # noqa: BLE001 — the worker must
                # outlive anything a batch can throw (reassembly bugs,
                # metric sinks); affected requests fail loudly instead
                self.error(f"batch service crashed: {exc!r}")
                for chunk in batch:
                    self._fail(chunk.req, exc)

    # -- lifecycle -----------------------------------------------------------
    def stop(self, drain: bool = True, join_timeout_s: float = 30.0) -> bool:
        """Stop admitting.  ``drain=True`` services everything already
        queued; ``drain=False`` fails queued requests with QueueFull.
        Returns True when the worker actually exited — False means the
        drain outlived ``join_timeout_s`` and the worker is still going
        (callers must not tear down the engine underneath it)."""
        with self._cond:
            self._closing = True
            if not drain:
                while self._queue:
                    chunk = self._queue.popleft()
                    self.metrics.on_dequeue()
                    self._fail(chunk.req, QueueFull("batcher shut down"))
            self._cond.notify_all()
        self._worker.join(timeout=join_timeout_s)
        _flight.unregister_plane("serve_ledger", self._flight_plane)
        return not self._worker.is_alive()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)
