"""Serving-fleet worker pool — process lifecycle; the port of
``znicz_tpu/fleet/workers.py``.

A fleet worker is an ORDINARY serving CLI (``python -m znicz_tpu_torch
generate <pkg> --serve`` or ``python -m znicz_tpu_torch serve <pkg>``)
on its own port: nothing in the worker knows it is part of a fleet beyond the
rank env the pool sets (the elastic contract, so traces and JSONL logs
arrive rank-tagged).  The pool owns what the single-process CLIs cannot:

- **spawn/retire** through the elastic hooks
  (:func:`~znicz_tpu_torch.resilience.elastic.spawn_worker` /
  :func:`~znicz_tpu_torch.resilience.elastic.teardown_workers`): piped log
  pump, SIGTERM-drain-then-SIGKILL reaping, tail capture;
- **probes**: a background loop polling each worker's ``/readyz``
  (routing gate + reported package fingerprint) and ``/metrics``
  (scraped queue depth + active slots — the router's least-loaded
  signal), and watching the subprocess itself (``/livez`` of a process
  the pool spawned is its exit code);
- **replacement**: a worker that dies WITHOUT being retired (OOM kill,
  chaos SIGKILL) is respawned at the pool's CURRENT package — which is
  how a fleet converges on the new weights when a worker is lost
  mid-rollout (rollout.py flips ``package`` first);
- **federation**: every worker is an HTTP source in the pool's
  :class:`~znicz_tpu_torch.observe.federation.FleetAggregator`, so the
  merged ``/fleet/*`` view, the autoscaler's SLO rules, and the merged
  Perfetto trace ride the federation machinery unchanged.

The pool adds nothing of its own to a worker's command line: the
device travels in ``worker_args`` (``--device cpu`` on a host without a
card) like every other worker flag.

Ranks are unique for the POOL's lifetime (monotonic), never reused: a
replaced worker's metrics/trace identity must not collide with its
predecessor's in the merged view.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.observe import federation as _federation
from znicz_tpu_torch.observe import registry as _reg
from znicz_tpu_torch.resilience.elastic import (RANK_ENV, spawn_worker,
                                                teardown_workers)
from znicz_tpu_torch.utils.naming import package_fingerprint

# fleet-scale telemetry — the pool is the single writer
_M_SCALE_WORKERS = _reg.gauge(
    "znicz_fleet_scale_workers",
    "serving workers the pool currently manages (spawned or adopted)")
_M_SCALE_EVENTS = _reg.counter(
    "znicz_fleet_scale_events_total",
    "pool scale actions by kind: up (autoscaler spawn), down "
    "(autoscaler retire), replace (unexpected death respawned), "
    "rollout (worker rebooted onto a new package)",
    labelnames=("event",))
_M_SCALE_REACTION = _reg.gauge(
    "znicz_fleet_scale_reaction_seconds",
    "latest SLO-breach-to-new-worker-ready reaction time "
    "(autoscale.py stamps it after each scale-up gates ready)")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_json(url: str, timeout: float):
    """-> (status, parsed body) for one GET; raises on transport
    failure.  4xx/5xx with a JSON body return normally — a 503
    "draining" readyz is an ANSWER, not an error."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        body = exc.read()
        try:
            return exc.code, json.loads(body)
        except (ValueError, UnicodeDecodeError):
            return exc.code, {}


class FleetWorker:
    """One serving worker as the pool/router see it: the subprocess
    handle (None for adopted externally-managed workers) plus the last
    probe's verdicts."""

    def __init__(self, rank: int, base: str, proc=None,
                 package: Optional[str] = None) -> None:
        self.rank = rank
        self.base = base.rstrip("/")            # http://127.0.0.1:port
        self.proc = proc                        # elastic.WorkerProcess
        self.package = package                  # path this worker booted
        self.started = time.monotonic()
        # -- probe state (written by the pool's probe loop) --
        self.ready = False
        self.live = proc is not None            # spawned => process up
        self.fingerprint: Optional[dict] = None  # reported by /readyz
        self.depth = 0.0          # scraped queue depth + active slots
        self.last_probe: Optional[float] = None
        self.probe_error: Optional[str] = None
        # -- lifecycle flags --
        self.retiring = False     # pool-initiated teardown: death is
        #                           expected, do NOT replace
        self.gone = False         # reaped; kept for post-mortems only
        # -- router state --
        self.inflight = 0         # requests the router has in this
        self._lock = threading.Lock()   # worker right now

    def add_inflight(self, delta: int) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight + delta)

    def load(self) -> float:
        """Least-loaded pick key: the last scraped queue depth plus the
        router's own live in-flight count (the scrape is a snapshot up
        to a probe interval old; in-flight covers the gap)."""
        return self.depth + self.inflight

    def snapshot(self) -> dict:
        return {"rank": self.rank, "base": self.base,
                "ready": self.ready, "live": self.live,
                "retiring": self.retiring, "gone": self.gone,
                "depth": self.depth, "inflight": self.inflight,
                "package": self.package,
                "fingerprint": self.fingerprint,
                "pid": self.proc.proc.pid if self.proc is not None
                else None,
                "probe_error": self.probe_error}


class WorkerPool(Logger):
    """Spawn, probe, replace and retire N serving workers; see module
    docstring.  ``plane`` picks the worker CLI (``generate`` boots
    ``generate <pkg> --serve``; ``serve`` boots ``serve <pkg>``);
    ``worker_args`` passes through to it verbatim (slots, max-len,
    ...).  ``probe_interval_s`` bounds how stale the router's readiness
    and queue-depth views may be."""

    def __init__(self, package: str, *, plane: str = "generate",
                 worker_args: Sequence[str] = (),
                 env: Optional[dict] = None,
                 run_dir: Optional[str] = None,
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 2.0,
                 ready_timeout_s: float = 180.0,
                 term_grace_s: float = 30.0) -> None:
        super().__init__()
        if plane not in ("generate", "serve"):
            raise ValueError(f"plane must be 'generate' or 'serve', "
                             f"got {plane!r}")
        self.plane = plane
        self.package = str(package)
        self.expected_fingerprint = package_fingerprint(self.package)
        self.worker_args = list(worker_args)
        self.env = dict(env if env is not None else os.environ)
        self.run_dir = run_dir or os.path.join(
            os.path.dirname(os.path.abspath(self.package)) or ".",
            "fleet")
        os.makedirs(self.run_dir, exist_ok=True)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.term_grace_s = float(term_grace_s)
        self._workers: list = []
        self._next_rank = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        # one probe pass at a time: the background loop and an
        # explicit probe_once (the rollout converge gate) must not both
        # see the same dead worker and replace it twice
        self._probe_lock = threading.Lock()
        # probes fan out like federation's scrape pass — one wedged
        # worker must not stall the whole fleet's readiness view by
        # N * probe_timeout_s
        self._probe_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="znicz-fleet-probe")
        #: the merged telemetry view over every live worker
        #: (the router mounts its /fleet/* endpoints on this)
        self.aggregator = _federation.FleetAggregator(
            stale_s=max(10.0 * probe_interval_s, 5.0))
        # /fleet/status.json surfaces the fleet's
        # CURRENT package fingerprint + convergence top-level, so the
        # learn-plane adoption gate and operators read one field
        # instead of folding per-worker /readyz answers
        self.aggregator.register_status_provider("package",
                                                 self.package_status)
        self.replacements = 0

    # -- package (rollout flips this) ----------------------------------------
    def set_package(self, package: str) -> dict:
        """Point FUTURE spawns (scale-ups and replacements) at a new
        export package — the first step of a rolling update.  Returns
        the new expected fingerprint."""
        fp = package_fingerprint(package)
        with self._lock:
            self.package = str(package)
            self.expected_fingerprint = fp
        return fp

    # -- spawn / adopt -------------------------------------------------------
    def _worker_argv(self, package: str, port: int) -> list:
        argv = [sys.executable, "-m", "znicz_tpu_torch", self.plane,
                package]
        if self.plane == "generate":
            argv.append("--serve")
        argv += ["--port", str(port), *self.worker_args]
        return argv

    def spawn(self, event: Optional[str] = None,
              env_extra: Optional[dict] = None) -> FleetWorker:
        """Start one worker process at the pool's current package; does
        NOT wait for readiness (``wait_ready`` is the gate).  ``event``
        labels the scale counter ("up" / "replace" / "rollout"); None
        = initial capacity, not a scale action.  ``env_extra`` lands in
        THIS worker's environment only — the chaos drills arm one
        worker's ``ZNICZ_TPU_FAULT_PLAN`` through it (a replacement
        spawned after the seeded death boots clean)."""
        with self._lock:
            rank = self._next_rank
            self._next_rank += 1
            package = self.package
        port = free_port()
        env = dict(self.env)
        if env_extra:
            env.update(env_extra)
        env[RANK_ENV] = str(rank)       # rank-tagged traces + JSONL
        proc = spawn_worker(
            self._worker_argv(package, port), rank=rank, env=env,
            log_path=os.path.join(self.run_dir, f"worker_w{rank}.log"),
            log_tree="fleet")
        worker = FleetWorker(rank, f"http://127.0.0.1:{port}",
                             proc=proc, package=package)
        with self._lock:
            self._workers.append(worker)
        self.aggregator.add_http_source(rank, worker.base)
        if event is not None:
            _M_SCALE_EVENTS.labels(event=event).inc()
        _M_SCALE_WORKERS.set(self.worker_count())
        self.info(f"fleet: spawned worker {rank} on {worker.base} "
                  f"({os.path.basename(package)}"
                  + (f", {event}" if event else "") + ")")
        return worker

    def adopt(self, base_url: str) -> FleetWorker:
        """Register an externally-managed worker (already listening):
        the router routes to it and probes it, but the pool never
        spawns, replaces, or SIGTERMs it — retire only deregisters."""
        with self._lock:
            rank = self._next_rank
            self._next_rank += 1
        worker = FleetWorker(rank, base_url, proc=None)
        with self._lock:
            self._workers.append(worker)
        self.aggregator.add_http_source(rank, worker.base)
        _M_SCALE_WORKERS.set(self.worker_count())
        return worker

    # -- views ---------------------------------------------------------------
    def workers(self) -> list:
        with self._lock:
            return [w for w in self._workers if not w.gone]

    def ready_workers(self) -> list:
        return [w for w in self.workers()
                if w.ready and not w.retiring]

    def worker_count(self) -> int:
        return len(self.workers())

    def ready_count(self) -> int:
        return len(self.ready_workers())

    def snapshot(self) -> dict:
        return {"package": self.package,
                "expected_fingerprint": self.expected_fingerprint,
                "plane": self.plane,
                "replacements": self.replacements,
                "workers": [w.snapshot() for w in self.workers()]}

    def package_status(self) -> dict:
        """The ``/fleet/status.json`` top-level ``"package"`` block:
        what the fleet SHOULD serve (the pool's expected fingerprint)
        and whether every non-retiring worker's last probe agrees —
        the one field a rolling adoption gates on."""
        with self._lock:
            package, fp = self.package, self.expected_fingerprint
        workers = [w for w in self.workers() if not w.retiring]
        converged = bool(workers) and all(
            (w.fingerprint or {}).get("sha256") == fp.get("sha256")
            for w in workers)
        return {"package": package, "fingerprint": fp,
                "converged": converged,
                "workers_ready": self.ready_count()}

    # -- probing -------------------------------------------------------------
    def probe_worker(self, worker: FleetWorker) -> None:
        """One probe pass over one worker: process exit first (a
        spawned worker's truest liveness signal), then ``/readyz``
        (routing gate + fingerprint), then ``/metrics`` (queue depth)
        only while ready — a draining worker's depth must not attract
        traffic it will refuse."""
        if worker.proc is not None and worker.proc.proc.poll() is not None:
            worker.live = False
            worker.ready = False
            worker.probe_error = (
                f"process exited rc={worker.proc.proc.returncode}")
            return
        try:
            status, doc = _http_json(worker.base + "/readyz",
                                     self.probe_timeout_s)
            worker.live = True
            worker.ready = status == 200
            if doc.get("package"):
                worker.fingerprint = doc["package"]
            worker.probe_error = None
        except (urllib.error.URLError, OSError, ValueError) as exc:
            # not listening (booting or mid-reboot) => not ready; an
            # ADOPTED worker is also presumed dead-or-unreachable
            worker.ready = False
            worker.live = worker.proc is not None
            worker.probe_error = repr(exc)
            worker.last_probe = time.monotonic()
            return
        if worker.ready:
            try:
                _, snap = _http_json(worker.base + "/metrics",
                                     self.probe_timeout_s)
                stats = snap.get("generate") or snap.get("serving") or {}
                worker.depth = float(stats.get("queue_depth", 0)) + \
                    float(stats.get("active_slots", 0))
            except (urllib.error.URLError, OSError, ValueError):
                pass                    # keep the last depth one tick
        worker.last_probe = time.monotonic()

    def probe_once(self) -> None:
        """Probe every worker (concurrently) and replace unexpected
        deaths (the convergence half of the rollout guarantee: a worker
        lost for ANY reason comes back on the pool's CURRENT package).
        Serialized against itself — the background loop and an explicit
        caller (the rollout converge gate) must not both replace the
        same death."""
        with self._probe_lock:
            workers = self.workers()
            if len(workers) > 1:
                list(self._probe_pool.map(self.probe_worker, workers))
            elif workers:
                self.probe_worker(workers[0])
            dead = [w for w in self.workers()
                    if w.proc is not None and not w.live
                    and not w.retiring]
            for worker in dead:
                self.warning(
                    f"fleet: worker {worker.rank} died unexpectedly "
                    f"({worker.probe_error}); tail: "
                    f"{list(worker.proc.tail)[-3:]}")
                self._deregister(worker)
                self.replacements += 1
                self.spawn(event="replace")

    def start_probes(self) -> None:
        if self._probe_thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self.probe_interval_s):
                try:
                    self.probe_once()
                except Exception as exc:  # noqa: BLE001 — the probe
                    self.warning(f"fleet probe pass failed: {exc!r}")

        self._probe_thread = threading.Thread(
            target=loop, daemon=True, name="znicz-fleet-probe")
        self._probe_thread.start()

    def wait_ready(self, worker: FleetWorker,
                   timeout_s: Optional[float] = None,
                   expect_fingerprint: Optional[dict] = None) -> bool:
        """Block until ``worker`` answers ``/readyz`` 200 (and, when
        given, reports ``expect_fingerprint``); False on timeout or
        death.  Probes directly — no dependency on the background
        loop's cadence."""
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.ready_timeout_s)
        while time.monotonic() < deadline:
            self.probe_worker(worker)
            if worker.proc is not None and not worker.live:
                return False            # exited before ever ready
            if worker.ready and (
                    expect_fingerprint is None or
                    (worker.fingerprint or {}).get("sha256") ==
                    expect_fingerprint.get("sha256")):
                return True
            time.sleep(0.1)
        return False

    def wait_all_ready(self, timeout_s: Optional[float] = None) -> bool:
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.ready_timeout_s)
        for worker in self.workers():
            left = deadline - time.monotonic()
            if left <= 0 or not self.wait_ready(worker, timeout_s=left):
                return False
        return True

    # -- retire --------------------------------------------------------------
    def _deregister(self, worker: FleetWorker) -> None:
        worker.gone = True
        worker.ready = False
        self.aggregator.remove_source(worker.rank)
        with self._lock:
            self._workers = [w for w in self._workers if not w.gone]
        _M_SCALE_WORKERS.set(self.worker_count())

    def retire(self, worker: FleetWorker, *, drain: bool = True,
               event: Optional[str] = None, wait: bool = True) -> bool:
        """Take one worker out of service: mark it retiring (the router
        stops picking it immediately, before any probe runs), then
        SIGTERM — the serving CLIs turn that into drain-then-exit-0, so
        every request the worker already admitted completes.  ``wait``
        False returns after the signal (the rollout overlaps the drain
        with the replacement's boot); :meth:`reap` finishes the job."""
        worker.retiring = True
        if event is not None:
            _M_SCALE_EVENTS.labels(event=event).inc()
        if worker.proc is None:         # adopted: just stop routing
            self._deregister(worker)
            return True
        worker.proc.killed = True       # signaled HERE: reap's
        try:                            # teardown must not SIGTERM a
            if drain:                   # draining worker a second time
                worker.proc.proc.terminate()   # CLI drains, exits 0
            else:
                worker.proc.proc.kill()        # a dud replacement has
        except OSError:                        # nothing worth draining
            pass
        if not wait:
            return True
        return self.reap(worker)

    def reap(self, worker: FleetWorker) -> bool:
        """Wait out a retiring worker's drain (bounded by
        ``term_grace_s``, then SIGKILL via the elastic teardown hook)
        and deregister it.  True iff it exited cleanly (drained)."""
        teardown_workers([worker.proc], self.term_grace_s, self)
        rc = worker.proc.proc.returncode
        self._deregister(worker)
        if rc != 0:
            self.warning(f"fleet: worker {worker.rank} exited rc={rc} "
                         f"on retire (expected a clean drain)")
        return rc == 0

    def stop(self, drain: bool = True) -> None:
        """Retire every worker (drain by default) and stop the probe
        loop + aggregator."""
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
            self._probe_thread = None
        workers = self.workers()
        for worker in workers:          # signal all, then reap all —
            worker.retiring = True      # drains overlap
            if worker.proc is not None:
                worker.proc.killed = True    # single-signal contract
                try:
                    if drain:
                        worker.proc.proc.terminate()
                    else:
                        worker.proc.proc.kill()
                except OSError:
                    pass
        for worker in workers:
            if worker.proc is not None:
                self.reap(worker)
            else:
                self._deregister(worker)
        self.aggregator.close()
        self._probe_pool.shutdown(wait=False)
        _M_SCALE_WORKERS.set(0)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
