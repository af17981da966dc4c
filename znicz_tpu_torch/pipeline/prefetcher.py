"""BatchPrefetcher — bounded background prefetch + overlapped H2D
staging; the port of ``znicz_tpu/pipeline/prefetcher.py``.

One daemon thread ("znicz-prefetch") runs the loader's serve core
(:meth:`Loader._next_record` → :meth:`Loader.fill_batch` →
:meth:`Loader._complete_record` — shuffle included, so prng order is
byte-identical to the synchronous path) and an optional step-provided
*stager* (:meth:`FusedTrainStep.make_stager`), pushing
:class:`StagedBatch` items into a depth-N bounded queue.  The consumer
(``Loader.torch_run`` on the control-walk thread) pops batches, replays
their control metadata onto the loader's published attributes and hands
the staged device tensors to the step — so the host gather of batch
k+1..k+depth (the native gather, which releases the GIL) and its
host-to-device copy both overlap the device compute of batch k.

On the card the stager's copy runs from a pinned ring slot on a side
``torch.cuda.Stream`` and records an event; the worker waits on that
event, so the slot is free again before the batch is queued, and the
consumer's stream waits on it before it reads the staged tensors
(:func:`ready_on_current_stream`, which also keeps the caching allocator
from reusing them early).  The step's graphs replay on the consumer's
stream, never on the side stream.

Determinism contract (pinned by tests/test_torch_port_pipeline.py):

- the producer OWNS the serve loop — the per-epoch reshuffle draws from
  the global prng in exactly the synchronous order, just on the worker
  thread; nothing else consumes the host prng during a fused run (the
  fused step's random bits come from its own ``torch.Generator``, drawn
  on the consumer);
- published loader attributes (``minibatch_*``, ``epoch_number``,
  ``epoch_ended``) are written ONLY by the consumer thread, from the
  captured record — downstream units never observe producer-ahead state;
- **epoch-boundary barrier**: after queueing a batch whose serve crossed
  an epoch boundary, the worker parks until the consumer has consumed
  that batch AND asked for the next one, so loader and prng state at an
  epoch boundary is exactly the sync-mode state.

Failure semantics: any exception on the worker (including an armed
``pipeline.fetch`` chaos fault, resilience/faults.py) is re-raised on the
consumer at the next :meth:`next_batch` once the queue drains.
``Workflow.run`` stops registered pipelines on any crash, and a loader
restore calls :meth:`resync` so a restored cursor never mixes with
batches prefetched from the pre-restore state.  The step-anatomy plane
``pipeline`` takes the staging leg as its ``stage`` phase and the
consumer's wait on an empty ring as ``input_wait``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from znicz_tpu_torch.observe import probe
from znicz_tpu_torch.observe import registry as _metrics
from znicz_tpu_torch.observe import trace as _trace
from znicz_tpu_torch.resilience.faults import fault_hook

# shared-registry mirror of PipelineStats: the instance stats below stay
# the per-pipeline single-writer truth (tests pin snapshot()); these
# process-wide series are what GET /metrics scrapes — stall seconds
# aggregate across pipelines, the fill gauge tracks the live queue
_M_PRODUCED = _metrics.counter("znicz_pipeline_batches_produced_total",
                               "batches the prefetch workers queued")
_M_CONSUMED = _metrics.counter("znicz_pipeline_batches_consumed_total",
                               "prefetched batches the consumers popped")
_M_SERVE = _metrics.counter("znicz_pipeline_serve_seconds_total",
                            "host serve+fill seconds on prefetch workers")
_M_STAGE = _metrics.counter("znicz_pipeline_stage_seconds_total",
                            "host-to-device staging seconds on workers")
_M_PROD_STALL = _metrics.counter(
    "znicz_pipeline_producer_starved_seconds_total",
    "workers waited for a free queue slot")
_M_CONS_STALL = _metrics.counter(
    "znicz_pipeline_consumer_starved_seconds_total",
    "consumers waited on an empty queue")
_M_BARRIER = _metrics.counter(
    "znicz_pipeline_barrier_seconds_total",
    "epoch-boundary determinism parks on workers")
_M_FILL = _metrics.gauge("znicz_pipeline_queue_fill",
                         "prefetch queue occupancy after the last event")


class PrefetcherStopped(RuntimeError):
    """``next_batch`` after ``stop()`` — the pipeline is shut down."""


def ring_safe_stager(put: Callable, device: torch.device,
                     stream: Optional["torch.cuda.Stream"] = None
                     ) -> Callable:
    """Wrap a device-placement callable so ring-slot handoff is safe —
    THE one place the detach-or-fence invariant lives:

    - on the CPU the host arrays are detached with a worker-side copy
      before the put (a CPU tensor made from a ring slot would alias it);
    - on the card ``put`` runs on the side ``stream`` (its copies leave
      from pinned ring slots), an event is recorded there and the WORKER
      waits on it, so the slot is free for reuse when the batch is
      queued; the event rides with the staged tensors for the consumer's
      stream to wait on (:func:`ready_on_current_stream`).

    Either way the cost rides the producer thread, never the consumer.
    ``put(*host_arrays)`` returns the staged tensors; ``stage`` returns
    ``(staged, event)`` (``event`` None on the CPU).  On the card
    without a side stream it raises rather than ship host arrays."""
    if device.type == "cpu":
        def stage_cpu(*host_arrays):
            return put(*(np.array(a) for a in host_arrays)), None
        return stage_cpu
    if stream is None:
        raise RuntimeError("ring_safe_stager: no side CUDA stream for the "
                           "staging copies")

    def stage(*host_arrays):
        with torch.cuda.stream(stream):
            staged = put(*host_arrays)
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()           # the ring slots are free again
        return staged, event

    return stage


def ready_on_current_stream(tensors, event) -> None:
    """Consumer side of :func:`ring_safe_stager`: the current stream waits
    on the staging ``event`` before it reads ``tensors``, and each tensor
    is marked as used there, so the caching allocator does not hand its
    memory to the side stream's next batch while this stream still reads
    it.  A no-op for CPU tensors (``event`` None)."""
    if event is None:
        return
    current = torch.cuda.current_stream(tensors[0].device)
    current.wait_event(event)
    for t in tensors:
        t.record_stream(current)


class StagedBatch:
    """One prefetched minibatch: the loader control record, the filled
    host arrays (None when the loader serves indices only), and the
    stager's device arrays (None without a stager)."""

    __slots__ = ("record", "arrays", "staged")

    def __init__(self, record: dict, arrays: Optional[dict],
                 staged: Optional[dict]) -> None:
        self.record = record
        self.arrays = arrays
        self.staged = staged


class PipelineStats:
    """Per-stage accounting.  Single-writer discipline: the worker owns
    ``produced``/``serve_s``/``stage_s``/``producer_starved_s``/
    ``barrier_s``/``bytes_staged``/``max_fill``; the consumer owns
    ``consumed``/``consumer_starved_s`` — no locks on the hot path."""

    def __init__(self, depth: int) -> None:
        self.depth = depth
        self.produced = 0            # batches the worker queued
        self.consumed = 0            # batches the consumer popped
        self.bytes_staged = 0        # host bytes shipped through the stager
        self.max_fill = 0            # high-water queue occupancy observed
        self.serve_s = 0.0           # host serve+fill time (worker)
        self.stage_s = 0.0           # H2D staging time (worker)
        self.producer_starved_s = 0.0  # worker waited for a free slot
        self.consumer_starved_s = 0.0  # consumer waited on an empty queue
        self.barrier_s = 0.0         # epoch-boundary determinism park

    def bound(self) -> str:
        """Dominant stall: ``consumer-starved`` (producer is the
        bottleneck), ``producer-starved`` (compute is — the pipeline keeps
        up), or ``transfer-bound`` (staging dominates the worker)."""
        stalls = {"producer-starved": self.producer_starved_s,
                  "consumer-starved": self.consumer_starved_s,
                  "transfer-bound": self.stage_s}
        if max(stalls.values()) <= 0.0:
            return "balanced"
        return max(stalls, key=stalls.get)

    def snapshot(self) -> dict:
        return {
            "depth": self.depth,
            "produced": self.produced,
            "consumed": self.consumed,
            "bytes_staged": self.bytes_staged,
            "max_fill": self.max_fill,
            "serve_s": round(self.serve_s, 4),
            "stage_s": round(self.stage_s, 4),
            "producer_starved_s": round(self.producer_starved_s, 4),
            "consumer_starved_s": round(self.consumer_starved_s, 4),
            "barrier_s": round(self.barrier_s, 4),
            "bound": self.bound(),
        }


class BatchPrefetcher:
    """Depth-bounded producer of :class:`StagedBatch` items over a Loader.

    ``stager(record, arrays) -> (staged_dict, nbytes)`` runs on the worker
    thread right after the host fill — its copies on the side stream are
    the overlapped H2D leg.  ``stager=None`` still overlaps the host fill
    (the consumer uploads as the sync path does).
    """

    THREAD_NAME = "znicz-prefetch"

    def __init__(self, loader, stager: Optional[Callable] = None,
                 depth: int = 2) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = int(depth)
        self._stager = stager
        #: a stager detaches ring slots before handoff (ring_safe_stager
        #: copy/fence); without one, batches reach the consumer as raw
        #: host buffers it may still read from — fill_batch then serves
        #: FRESH buffers (sync-path ownership) instead of rotating
        self.detaches_slots = stager is not None
        self.stats = PipelineStats(self.depth)
        self._queue: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._barrier_sem = threading.Semaphore(0)
        self._pending_release = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # -- producer ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("prefetcher already started")
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=self.THREAD_NAME)
        self._thread.start()

    def _worker(self) -> None:
        loader = self.loader
        try:
            while not self._stop.is_set():
                # chaos hook: crash/hang/oserror inside the REAL worker
                # loop (site "pipeline.fetch") — the consumer re-raises
                fault_hook("pipeline.fetch", loader=loader,
                           batch=self.stats.produced)
                t0 = time.perf_counter()
                rec = loader._next_record()
                arrays = None
                if not loader.serve_indices_only:
                    arrays = loader.fill_batch(rec["indices"], rec["size"],
                                              rec["cls"])
                loader._complete_record(rec)
                serve_dt = time.perf_counter() - t0
                self.stats.serve_s += serve_dt
                observed = probe.enabled()
                if observed:
                    _M_SERVE.inc(serve_dt)
                staged = None
                if self._stager is not None:
                    t0 = time.perf_counter()
                    staged, nbytes = self._stager(rec, arrays)
                    stage_dt = time.perf_counter() - t0
                    self.stats.stage_s += stage_dt
                    self.stats.bytes_staged += int(nbytes)
                    if observed:
                        _M_STAGE.inc(stage_dt)
                        probe.staged_bytes(int(nbytes))
                        # anatomy plane: the staging leg as a phase of
                        # the input pipeline's step
                        probe.anatomy_phase("pipeline", "stage",
                                            stage_dt, t0=t0)
                batch = StagedBatch(rec, arrays, staged)
                t0 = time.perf_counter()
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                else:
                    return
                stall_dt = time.perf_counter() - t0
                self.stats.producer_starved_s += stall_dt
                self.stats.produced += 1
                fill = self._queue.qsize()
                if fill > self.stats.max_fill:
                    self.stats.max_fill = fill
                if observed:
                    _M_PROD_STALL.inc(stall_dt)
                    _M_PRODUCED.inc()
                    _M_FILL.set(fill)
                if rec["epoch_ended"]:
                    # determinism barrier: hold the post-boundary state
                    # (reshuffled order, advanced epoch) frozen until the
                    # consumer-side snapshotter has had its window
                    t0 = time.perf_counter()
                    self._barrier_sem.acquire()
                    barrier_dt = time.perf_counter() - t0
                    self.stats.barrier_s += barrier_dt
                    if observed:
                        _M_BARRIER.inc(barrier_dt)
        except BaseException as exc:  # noqa: BLE001 — re-raised on consumer
            self._error = exc
            # the error is parked until the consumer drains the queue —
            # drop an instant NOW so a flight artifact dumped between
            # the worker dying and the consumer noticing still carries
            # the real failure point
            if probe.enabled():
                _trace.instant("pipeline.error",
                               error=type(exc).__name__,
                               batch=self.stats.produced)

    # -- consumer ------------------------------------------------------------
    def next_batch(self) -> StagedBatch:
        """Pop the next prefetched batch (starts the worker lazily);
        re-raises a worker failure once the queue drains."""
        if self._thread is None:
            self.start()
        if self._pending_release:
            # the consume AFTER the epoch-boundary batch: the snapshot
            # window is over, release the parked worker into the new epoch
            self._pending_release = False
            self._barrier_sem.release()
        t0 = time.perf_counter()
        while True:
            if self._stop.is_set():
                raise PrefetcherStopped("prefetcher was stopped")
            try:
                batch = self._queue.get(timeout=0.05)
                break
            except queue.Empty:
                if self._error is not None:
                    raise self._error
        stall_dt = time.perf_counter() - t0
        self.stats.consumer_starved_s += stall_dt
        self.stats.consumed += 1
        if probe.enabled():
            _M_CONS_STALL.inc(stall_dt)
            _M_CONSUMED.inc()
            # anatomy plane: consumer-side input wait — the time the
            # step sat blocked on an empty prefetch ring
            probe.anatomy_phase("pipeline", "input_wait", stall_dt,
                                t0=t0)
        if batch.record["epoch_ended"]:
            self._pending_release = True
        return batch

    # -- lifecycle -----------------------------------------------------------
    def stop(self) -> bool:
        """Shut down: unpark + join the worker, drop queued batches.
        Returns True when the worker is confirmed dead (False = it was
        still alive after the join grace — abandoned, not re-armable)."""
        self._stop.set()
        self._barrier_sem.release()          # unpark a barrier wait
        t = self._thread
        if t is not None and t.is_alive() and \
                t is not threading.current_thread():
            t.join(timeout=10.0)
        while True:                          # release ring-buffer refs
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        return t is None or not t.is_alive()

    def resync(self) -> None:
        """Drain and re-arm after the loader's cursor was replaced
        (snapshot restore): queued batches belong to the pre-restore
        state and are discarded; the next ``next_batch`` restarts the
        worker from the restored position."""
        if not self.stop():
            # a wedged worker would wake against the replaced stop event
            # and race a fresh one over the loader's cursor + the global
            # prng — refuse to re-arm; the supervisor treats the failed
            # restore as one more crashed attempt
            raise RuntimeError(
                "prefetch worker still alive after stop(); cannot re-arm "
                "the pipeline over a live producer")
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self.depth)
        self._barrier_sem = threading.Semaphore(0)
        self._pending_release = False
        self._error = None
        self._thread = None

    def stats_snapshot(self) -> dict:
        """``WebStatus.register_pipeline`` payload."""
        return self.stats.snapshot()


def attach_prefetcher(loader, stager: Optional[Callable] = None,
                      depth: int = 2) -> BatchPrefetcher:
    """Attach a prefetch pipeline to ``loader``: its ``run`` now consumes
    staged batches while the worker produces ahead.  Registers with the
    owning workflow (``Workflow.pipelines``) for timing_table/stop
    integration; returns the prefetcher."""
    if getattr(loader, "pipeline", None) is not None:
        raise ValueError(f"loader {loader.name!r} already has a pipeline")
    pf = BatchPrefetcher(loader, stager=stager, depth=depth)
    loader.pipeline = pf
    workflow = getattr(loader, "workflow", None)
    if workflow is not None and hasattr(workflow, "pipelines"):
        workflow.pipelines.append(pf)
    return pf
