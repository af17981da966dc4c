"""Zero-downtime rolling weight update — the port of
``znicz_tpu/fleet/rollout.py``.

A new export package is adopted one worker at a time; the state
machine per worker is

    DRAIN      retire the old worker (readiness drops SYNCHRONOUSLY —
               the router stops picking it before the SIGTERM lands;
               requests it already admitted decode to completion, the
               serve CLIs' drain-then-exit-0 contract)
    BOOT       spawn the replacement on the NEW package — overlapped
               with the drain, so fleet capacity only dips by the one
               worker being replaced and only for its boot window
    GATE       wait for the replacement's ``/readyz`` to answer 200
               AND report the new package's fingerprint; only then
               move to the next worker
    REAP       confirm the old worker exited 0 (drained clean)

Guarantees, pinned by the chaos drill (the fleet tests and
``chip_smoke.py --phase fleet_learn``):

- **no admitted request is lost**: admission failures during the
  window (the drained worker's 503s) are idempotent and the router
  retries them on another worker; requests already admitted anywhere
  either complete or — if their worker is killed outright — get the
  router's synthesized terminal error.  Every admitted stream ends in
  exactly one terminal event;
- **the torn-mix window is the rollout window**: ``pool.set_package``
  flips FIRST, so every spawn from that instant (the rollout's own
  replacements, autoscaler scale-ups, AND crash replacements for a
  worker SIGKILL'd mid-rollout) boots the new package — once ``run``
  returns converged, every worker in the fleet reports the new
  fingerprint, and nothing can reintroduce the old one;
- **abort is safe**: a replacement that never gates ready fails the
  rollout (it is reaped), but the fleet keeps serving on the workers
  not yet touched — a bad package strands the rollout, not the fleet.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.fleet.workers import _M_SCALE_EVENTS


class RolloutError(RuntimeError):
    """The rollout could not complete; the fleet still serves."""


class RollingUpdate(Logger):
    """Drive rolling adoptions over a
    :class:`~znicz_tpu_torch.fleet.workers.WorkerPool`.  One instance per
    fleet; :meth:`start` runs :meth:`run` on a thread (the router's
    ``POST /rollout`` path) and refuses overlapping rollouts."""

    def __init__(self, pool, *, ready_timeout_s: Optional[float] = None,
                 converge_timeout_s: float = 120.0) -> None:
        super().__init__()
        self.pool = pool
        self.ready_timeout_s = ready_timeout_s
        self.converge_timeout_s = float(converge_timeout_s)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._state = {"state": "idle", "package": None,
                       "fingerprint": None, "steps": [],
                       "error": None, "history": []}

    # -- status --------------------------------------------------------------
    def _set(self, **kv) -> None:
        with self._lock:
            self._state.update(kv)

    def _step(self, doc: dict) -> None:
        with self._lock:
            self._state["steps"].append(doc)

    def status(self) -> dict:
        with self._lock:
            return {**{k: v for k, v in self._state.items()
                       if k != "steps"},
                    "steps": list(self._state["steps"])}

    @property
    def rolling(self) -> bool:
        return self._state["state"] == "rolling"

    # -- driving -------------------------------------------------------------
    def start(self, package: str) -> threading.Thread:
        """Kick one rollout off on a daemon thread; raises
        ``ValueError`` when one is already rolling or the package file
        is unreadable (checked NOW — the admin endpoint should 409/400
        synchronously, not strand a thread)."""
        with self._lock:
            if self._state["state"] == "rolling":
                raise ValueError("a rollout is already in progress")
            if not os.path.isfile(package):
                raise ValueError(f"package {package!r} does not exist")
            self._state.update(state="rolling", package=str(package),
                               error=None, steps=[])
        self._thread = threading.Thread(
            target=self._run_logged, args=(package,), daemon=True,
            name="znicz-fleet-rollout")
        self._thread.start()
        return self._thread

    def _run_logged(self, package: str) -> None:
        try:
            self.run(package, _entered=True)
        except RolloutError:
            pass                        # status already carries it
        except Exception:  # noqa: BLE001 — run() recorded the failure;
            pass           # a daemon thread has nobody to re-raise to

    def join(self, timeout_s: float = 600.0) -> dict:
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        return self.status()

    def run(self, package: str, _entered: bool = False) -> dict:
        """Adopt ``package`` across the fleet; returns the report dict
        (also the terminal :meth:`status`).  Raises
        :class:`RolloutError` on failure — the fleet keeps serving
        either way."""
        if not _entered:
            with self._lock:
                if self._state["state"] == "rolling":
                    raise ValueError("a rollout is already in progress")
                self._state.update(state="rolling",
                                   package=str(package), error=None,
                                   steps=[])
        t0 = time.monotonic()
        try:
            fp = self.pool.set_package(package)   # torn-mix window opens:
            self._set(fingerprint=fp)             # every spawn from here
            #                                       boots the NEW package
            targets = [w for w in self.pool.workers()
                       if not w.retiring and
                       (w.fingerprint or {}).get("sha256") !=
                       fp.get("sha256")]
            self.info(f"rollout: adopting "
                      f"{os.path.basename(package)} across "
                      f"{len(targets)} worker(s) "
                      f"(sha256 {fp['sha256'][:12]})")
            adopted = 0
            for old in targets:
                adopted += self._roll_one(old, fp)
            self._converge(fp)
            report = {"state": "done", "adopted": adopted,
                      "duration_s": round(time.monotonic() - t0, 3)}
            self._set(**report)
            with self._lock:
                self._state["history"].append(
                    {"package": os.path.basename(package),
                     "sha256": fp["sha256"],
                     "duration_s": report["duration_s"]})
            self.info(f"rollout: converged in "
                      f"{report['duration_s']:.1f}s")
            return self.status()
        except RolloutError as exc:
            self._set(state="failed", error=str(exc))
            self.error(f"rollout failed: {exc}")
            raise
        except Exception as exc:  # noqa: BLE001 — an unexpected crash
            # (vanished package file, spawn OSError) must not strand
            # the state at "rolling": that would 409 every future
            # rollout for the life of the process
            self._set(state="failed", error=repr(exc))
            self.error(f"rollout crashed: {exc!r}")
            raise

    # -- one worker ----------------------------------------------------------
    def _roll_one(self, old, fp: dict) -> int:
        """DRAIN+BOOT -> GATE -> REAP for one worker; returns 1 when a
        replacement was adopted, 0 when the worker was already gone
        (chaos killed it — its crash replacement already boots the new
        package and the converge gate verifies it)."""
        if old.gone or not old.live:
            self._step({"rank": old.rank, "outcome": "already_dead"})
            return 0
        _M_SCALE_EVENTS.labels(event="rollout").inc()
        self._step({"rank": old.rank, "outcome": "draining"})
        # readiness drops inside retire() BEFORE the signal: the router
        # never picks this worker again, and its in-flight admissions
        # drain behind the 503 wall the batcher raises
        self.pool.retire(old, event=None, wait=False)
        new = self.pool.spawn(event=None)     # overlapped BOOT
        self._step({"rank": old.rank, "outcome": "booting",
                    "replacement": new.rank})
        if not self.pool.wait_ready(new, timeout_s=self.ready_timeout_s,
                                    expect_fingerprint=fp):
            # GATE failed: reap the dud, leave the fleet on the workers
            # not yet touched (old is already draining — reap it too,
            # its requests still finish behind the drain)
            self.pool.retire(new, drain=False, event=None, wait=True)
            self.pool.reap(old)
            raise RolloutError(
                f"replacement worker {new.rank} never became ready "
                f"with the new fingerprint (old worker {old.rank} was "
                f"already draining and has been reaped)")
        self._step({"rank": old.rank, "outcome": "gated",
                    "replacement": new.rank})
        drained = self.pool.reap(old)         # REAP: bounded by the
        self._step({"rank": old.rank,         # pool's term grace
                    "outcome": "drained" if drained else "killed"})
        return 1

    def _converge(self, fp: dict) -> None:
        """Post-roll gate: EVERY live worker (including crash
        replacements still booting) must report the new fingerprint
        before the rollout declares done — the no-torn-mix pin."""
        deadline = time.monotonic() + self.converge_timeout_s
        while True:
            self.pool.probe_once()
            workers = [w for w in self.pool.workers() if not w.retiring]
            stale = [w.rank for w in workers
                     if (w.fingerprint or {}).get("sha256") !=
                     fp.get("sha256")]
            if workers and not stale:
                return
            if time.monotonic() > deadline:
                raise RolloutError(
                    f"fleet did not converge on "
                    f"sha256 {fp['sha256'][:12]} within "
                    f"{self.converge_timeout_s:g}s "
                    f"(stale/booting ranks: {stale})")
            time.sleep(0.25)
