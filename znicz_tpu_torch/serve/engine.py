"""Bucketed batch execution engine — the device half of the
forward-package serving plane, the counterpart of
``znicz_tpu/serve/engine.py``.

A naive server that forwards whatever batch size arrived would meet a
new shape under real traffic at every turn (batch 3, then 7, then 5,
...).  The engine instead pads every batch up to a small fixed set of
bucket shapes — powers of two up to ``max_batch`` — so warmup
materializes each bucket exactly once and steady-state serving
materializes nothing.  On the card a bucket's materialization is the
capture of the forward into a CUDA graph (``utils/export.py
ExportedForward``, through ``parallel/graphs.py run_graphed``: the
counterpart of the reference's jit per bucket), and every later batch of
that bucket is one graph replay.  ``compile_count`` counts the buckets
materialized (the captures on the card), ``run_count`` the batches: the
zero-captures-after-warmup property is asserted on them.  ``aot_count``
stays 0: the port has no ahead-of-time executables.

Backends: ``utils.export.ExportedForward`` (torch; on the card by
default), ``native.infer.NativeForward`` (the C++ CPU runtime, by the
caller's explicit choice; ``static_shapes = False``, so the engine skips
padding), or any ``array -> array`` callable.

One divergence: ``load_backend(prefer_native=True)`` raises when the
native runtime cannot be built, where the reference quietly serves the
``ExportedForward`` instead.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.observe import probe as _probe
from znicz_tpu_torch.observe import registry as _registry
from znicz_tpu_torch.observe import trace as _trace
from znicz_tpu_torch.resilience.faults import fault_hook


def bucket_sizes(max_batch: int) -> tuple:
    """Powers of two up to ``max_batch``; ``max_batch`` itself is always
    the final bucket so one compile covers the full admission range."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def load_backend(path: str, prefer_native: bool = False, device="cuda"):
    """Load a utils/export.py forward package as an engine backend: the
    C++ ``NativeForward`` (on the host) when ``prefer_native``, else the
    torch ``ExportedForward`` on ``device``.  The reference's ``aot``
    has no counterpart (the port has no ahead-of-time executables).  A
    native runtime that cannot be built raises: the
    caller asked for it, so nothing switches to ``ExportedForward``."""
    if prefer_native:
        from znicz_tpu_torch.native import infer

        return infer.NativeForward(path)
    from znicz_tpu_torch.utils.export import ExportedForward

    return ExportedForward(path, device=device)


class BatchEngine(Logger):
    """Serve ``model(x) -> y`` at a fixed set of batch shapes.

    ``model``: an ``ExportedForward``, ``NativeForward``, a path to a
    forward package (.npz), or any callable over a float32 batch array.
    ``input_shape`` is taken from the model when it carries one.
    ``run()`` is thread-safe (a graph's static buffers serve one batch at
    a time); the micro-batcher funnels through a single worker anyway,
    but direct callers may be concurrent.
    """

    def __init__(self, model, max_batch: int = 64,
                 input_shape=None) -> None:
        super().__init__()
        if isinstance(model, str):
            model = load_backend(model)
        self.model = model
        self.max_batch = int(max_batch)
        self.buckets = bucket_sizes(self.max_batch)
        #: backends with a graph per shape -> pad to buckets; backends
        #: that declare static_shapes=False (native C++) run any batch
        self.static_shapes = bool(getattr(model, "static_shapes", True))
        shape = input_shape if input_shape is not None else \
            getattr(model, "input_shape", None)
        self.input_shape = tuple(shape) if shape is not None else None
        self.meta = dict(getattr(model, "meta", {}) or {})
        self.compile_count = 0      # buckets materialized (captures)
        self.aot_count = 0          # no AOT executables in the port
        self.run_count = 0          # batches executed
        self.rows_served = 0
        self._seen_buckets: set = set()
        self._lock = threading.Lock()

    # -- shape policy --------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        if n < 1:
            raise ValueError("empty batch")
        if n > self.max_batch:
            raise ValueError(f"batch {n} > max_batch {self.max_batch} "
                             "(the micro-batcher chunks oversize requests)")
        if not self.static_shapes:
            return n
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def warmup(self, input_shape=None) -> int:
        """Run one zero batch per bucket so every serving shape is
        materialized (on the card: captured into its CUDA graph) before
        traffic arrives; returns the compile count.  Boot cost is one
        greppable summary line: bucket count, total seconds, captures."""
        shape = input_shape if input_shape is not None else self.input_shape
        if shape is None:
            raise ValueError("warmup needs input_shape (the model does "
                             "not declare one)")
        self.input_shape = tuple(shape)
        if not self.static_shapes:
            # native path: no per-shape materialization; one probe run
            # validates the package end to end
            self.run(np.zeros((1,) + self.input_shape, np.float32))
            return 0
        t0 = time.perf_counter()
        for b in self.buckets:
            self.run(np.zeros((b,) + self.input_shape, np.float32))
        dt = time.perf_counter() - t0
        self.info(f"warmup: {len(self.buckets)} buckets in {dt:.2f}s — "
                  f"{self.compile_count} materialized")
        return self.compile_count

    # -- execution -----------------------------------------------------------
    def run(self, x) -> np.ndarray:
        """Execute one batch: pad to the bucket shape, run the model,
        slice the answer back to the true row count."""
        # chaos hook (site "serve.run"): injected crashes/hangs exercise
        # the batcher's error propagation and the server's 5xx path
        fault_hook("serve.run", engine=self)
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        if self.input_shape is not None and x.shape[1:] != self.input_shape:
            raise ValueError(f"input shape {x.shape[1:]} != model input "
                             f"{self.input_shape}")
        n = x.shape[0]
        bucket = self.bucket_for(n)
        if bucket != n:
            pad = np.zeros((bucket - n,) + x.shape[1:], np.float32)
            x = np.concatenate([x, pad], axis=0)
        compiled = False
        with self._lock:
            if self.static_shapes and bucket not in self._seen_buckets:
                self._seen_buckets.add(bucket)
                self.compile_count += 1
                compiled = True
                self.debug(f"materializing bucket {bucket} "
                           f"({self.compile_count}/{len(self.buckets)})")
            t0 = time.perf_counter()
            y = np.asarray(self.model(x))
            dt = time.perf_counter() - t0
            self.run_count += 1
            self.rows_served += n
        if compiled and _probe.enabled():
            # shared telemetry plane: a bucket materializing after warmup
            # is the steady-state-capture smell the smoke asserts against
            # — make it scrapeable and visible on the timeline, and
            # record how long the cold bucket cost (znicz_compile_seconds
            # + compile.cold span)
            _registry.counter("znicz_serve_engine_compiles_total",
                              "engine buckets compiled").inc()
            _trace.instant("serve.compile", bucket=bucket)
            _probe.compile_observed("BatchEngine", dt, bucket=bucket)
        return y[:n]

    def stats(self) -> dict:
        """Engine-side counters, merged into ``GET /metrics``."""
        with self._lock:
            return {
                "max_batch": self.max_batch,
                "buckets": list(self.buckets),
                "static_shapes": self.static_shapes,
                "compile_count": self.compile_count,
                "aot_count": self.aot_count,
                "run_count": self.run_count,
                "rows_served": self.rows_served,
            }

    def close(self) -> None:
        close = getattr(self.model, "close", None)
        if callable(close):
            close()
