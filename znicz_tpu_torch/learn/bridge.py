"""Adoption bridge — publish-to-rollout glue; the port of
``znicz_tpu/learn/bridge.py``.

The trainer announces packages in the publish manifest
(learn/publish.py); the serving fleet adopts packages through the
fleet's :class:`~znicz_tpu_torch.fleet.rollout.RollingUpdate`.  The bridge
is the small daemon that closes the gap: poll the manifest, and when
it names a fingerprint the fleet does not serve yet (gated on the
pool's ``expected_fingerprint`` — the same field
``/fleet/status.json`` now surfaces top-level), drive one rolling
update and stamp the publish-to-adopted latency.

Failure posture mirrors the rollout's: a failed adoption leaves the
fleet serving what it served (counted ``outcome="failed"``), and the
bridge retries on the NEXT manifest change rather than hammering the
same package — a bad export must not turn into a rollout storm.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.learn.publish import latest_manifest
from znicz_tpu_torch.observe import registry as _reg

_M_ADOPTIONS = _reg.counter(
    "znicz_learn_adoptions_total",
    "publish-triggered rolling updates by outcome (adopted / failed)",
    labelnames=("outcome",))
_M_ADOPTION_S = _reg.gauge(
    "znicz_learn_adoption_seconds",
    "latest publish-to-adopted latency: manifest wall stamp to fleet "
    "convergence on the published fingerprint")


class AdoptionBridge(Logger):
    """Poll ``publish_dir``'s manifest; roll the fleet onto every new
    fingerprint.  ``pool`` and ``rollout`` are the live fleet
    objects (the learn CLI runs all three in one process)."""

    def __init__(self, publish_dir: str, pool, rollout,
                 poll_s: float = 0.5,
                 rollout_timeout_s: float = 600.0) -> None:
        super().__init__()
        self.publish_dir = str(publish_dir)
        self.pool = pool
        self.rollout = rollout
        self.poll_s = float(poll_s)
        self.rollout_timeout_s = float(rollout_timeout_s)
        self.adoptions = 0
        self.failures = 0
        self.last_adoption_s: Optional[float] = None
        self.last_manifest: Optional[dict] = None
        self._skip_sha: Optional[str] = None   # failed sha: wait for a
        self._stop = threading.Event()         # NEW publish to retry
        self._thread: Optional[threading.Thread] = None

    # -- the decision --------------------------------------------------------
    def poll_once(self) -> Optional[dict]:
        """One decision: adopt the manifest's package when its
        fingerprint is new to the fleet.  Returns the rollout report
        when one ran (the deterministic-test hook)."""
        doc = latest_manifest(self.publish_dir)
        if doc is None:
            return None
        self.last_manifest = doc
        sha = (doc.get("fingerprint") or {}).get("sha256")
        if not sha or sha == self._skip_sha:
            return None
        if sha == (self.pool.expected_fingerprint or {}).get("sha256"):
            return None                  # fleet already on it
        if self.rollout.rolling:
            return None                  # one at a time; next poll
        self.info(f"adopting published package "
                  f"{doc['package']} (epoch {doc.get('epoch')}, "
                  f"sha256 {sha[:12]})")
        try:
            self.rollout.start(doc["package"])
        except ValueError as exc:        # raced another rollout / gone
            self.warning(f"adoption not started: {exc}")
            return None
        report = self.rollout.join(timeout_s=self.rollout_timeout_s)
        if report.get("state") == "done":
            self.adoptions += 1
            latency = max(0.0, time.time() - float(doc.get("ts") or
                                                   time.time()))
            self.last_adoption_s = latency
            _M_ADOPTIONS.labels(outcome="adopted").inc()
            _M_ADOPTION_S.set(latency)
            self.info(f"fleet adopted sha256 {sha[:12]} "
                      f"{latency:.1f}s after publish")
        else:
            self.failures += 1
            self._skip_sha = sha         # retry only on a NEW publish
            _M_ADOPTIONS.labels(outcome="failed").inc()
            self.error(f"adoption of sha256 {sha[:12]} failed: "
                       f"{report.get('error')}")
        return report

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "AdoptionBridge":
        if self._thread is not None:
            return self
        # pre-touch both outcome children so fleet delta rules see the
        # 0 baseline (a delta rule over a series that first
        # appears mid-incident reads as a spike)
        _M_ADOPTIONS.labels(outcome="adopted").inc(0)
        _M_ADOPTIONS.labels(outcome="failed").inc(0)

        def loop() -> None:
            while not self._stop.wait(self.poll_s):
                try:
                    self.poll_once()
                except Exception as exc:  # noqa: BLE001 — the bridge
                    self.warning(f"bridge poll failed: {exc!r}")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="znicz-learn-bridge")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def status(self) -> dict:
        """The ``/fleet/status.json`` ``"learn"`` block (the learn CLI
        registers it as a status provider)."""
        return {"publish_dir": self.publish_dir,
                "adoptions": self.adoptions,
                "failures": self.failures,
                "last_adoption_s": self.last_adoption_s,
                "manifest": self.last_manifest}
