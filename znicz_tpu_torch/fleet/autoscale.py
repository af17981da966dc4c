"""SLO-driven autoscaler for the serving fleet — the port of
``znicz_tpu/fleet/autoscale.py``.

The scale signal is NOT invented here: it is the fleet watchtower
running the watchtower's rule machinery over the pool aggregator's
rank-merged view — ``fleet_queue_saturation`` (total admission-queue
depth summed across every worker's injected ``rank`` label) and
``fleet_latency_slo`` (p95 over rank-merged histogram bucket deltas).
The autoscaler adds only the CONTROL half:

- **scale up** while a scale rule is breaching (continuous breach, not
  just the trip edge — a saturated fleet keeps growing one worker per
  cooldown until the rule recovers or ``max_workers`` is reached), and
  stamps ``znicz_fleet_scale_reaction_seconds`` with breach-to-ready
  wall time once the new worker gates ready;
- **scale down** only after the fleet has been IDLE (total depth ~ 0)
  for a full ``idle_down_s`` window — hysteresis, so a bursty queue
  does not flap workers — and never below ``min_workers``; the retired
  worker drains (readiness drops first, the router stops routing, then
  SIGTERM -> drain -> exit 0: scale-down loses no admitted request);
- **cooldown** between ANY two actions bounds the control loop's slew
  rate against the scrape/probe staleness it acts on.

Everything decision-shaped lives in :meth:`Autoscaler.tick`, which
takes an explicit timestamp — the deterministic-test hook, exactly the
``observe_now(ts=...)`` convention the watchtower tests use.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.observe.federation import (FleetAggregator,
                                                fleet_latency_slo,
                                                fleet_queue_saturation)
from znicz_tpu_torch.fleet.workers import _M_SCALE_REACTION


class Autoscaler(Logger):
    """Scale a worker pool inside ``[min_workers, max_workers]`` off
    fleet SLO rules; see module docstring.

    ``pool`` needs the :class:`~znicz_tpu_torch.fleet.workers.WorkerPool`
    surface: ``worker_count() / ready_workers() / spawn(event=) /
    retire(worker, event=) / wait_ready(worker)`` — a fake pool with
    those five methods makes every decision testable without a process.

    ``queue_high`` is the fleet-total queue-depth breach level;
    ``p95_high_s`` (optional) arms the latency SLO rule too.
    ``queue_metric`` defaults to the generative plane's depth gauge —
    pass ``znicz_serve_queue_depth`` for a predict fleet.
    """

    def __init__(self, pool, aggregator: Optional[FleetAggregator] = None,
                 *, min_workers: int = 1, max_workers: int = 4,
                 queue_high: float = 8.0,
                 queue_metric: str = "znicz_generate_queue_depth",
                 p95_high_s: Optional[float] = None,
                 latency_metric: str = "znicz_generate_ttft_seconds",
                 breach_for_s: float = 2.0,
                 cooldown_s: float = 15.0,
                 idle_down_s: float = 30.0,
                 idle_depth: float = 0.5) -> None:
        super().__init__()
        if not 1 <= min_workers <= max_workers:
            raise ValueError(f"need 1 <= min_workers <= max_workers, "
                             f"got [{min_workers}, {max_workers}]")
        self.pool = pool
        self.aggregator = aggregator if aggregator is not None \
            else pool.aggregator
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.breach_for_s = float(breach_for_s)
        self.cooldown_s = float(cooldown_s)
        self.idle_down_s = float(idle_down_s)
        self.idle_depth = float(idle_depth)
        self.queue_metric = queue_metric
        #: the scale-up signals — plain fleet rules over the merged view
        self.rules = [self.aggregator.add_rule(fleet_queue_saturation(
            depth=queue_high, for_s=breach_for_s, metric=queue_metric))]
        if p95_high_s is not None:
            self.rules.append(self.aggregator.add_rule(fleet_latency_slo(
                p95_high_s, metric=latency_metric)))
        self._last_action_ts: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._breach_since: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_reaction_s: Optional[float] = None

    # -- signals -------------------------------------------------------------
    def _breaching(self) -> bool:
        return any(r.snapshot()["breaching"] for r in self.rules)

    def _fleet_depth(self) -> float:
        """Fleet-total queue depth from the merged view (the same
        series the saturation rule sums) — the idle detector."""
        flat = self.aggregator.snapshot_flat(skip_zero=False)
        return sum(v for k, v in flat.items()
                   if k.partition("{")[0] == self.queue_metric)

    def _in_cooldown(self, now: float) -> bool:
        return self._last_action_ts is not None and \
            now - self._last_action_ts < self.cooldown_s

    # -- the decision --------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control-loop pass: sample the rules, then at most ONE
        scale action.  Returns "up" / "down" / None — the test
        surface."""
        now = time.time() if now is None else now
        with self._lock:
            self.aggregator.tower.observe_now(ts=now)
            breaching = self._breaching()
            if breaching and self._breach_since is None:
                self._breach_since = now
            elif not breaching:
                self._breach_since = None
            depth = self._fleet_depth()
            if depth <= self.idle_depth:
                if self._idle_since is None:
                    self._idle_since = now
            else:
                self._idle_since = None
            if self._in_cooldown(now):
                return None
            # the rule's `breaching` flag rises on the FIRST breach
            # sample (its for_s only gates trips); the scaler holds its
            # own continuous-breach window so one noisy scrape cannot
            # buy a worker
            if (breaching and
                    now - self._breach_since >= self.breach_for_s and
                    self.pool.worker_count() < self.max_workers):
                return self._scale_up(now)
            if (not breaching and self._idle_since is not None and
                    now - self._idle_since >= self.idle_down_s and
                    self.pool.worker_count() > self.min_workers):
                return self._scale_down(now)
            return None

    def _scale_up(self, now: float) -> str:
        self._last_action_ts = now
        self.scale_ups += 1
        breach_t0 = time.monotonic() - (
            max(0.0, now - self._breach_since)
            if self._breach_since is not None else 0.0)
        self.info(f"autoscale: SLO breach -> scaling up to "
                  f"{self.pool.worker_count() + 1} worker(s)")
        worker = self.pool.spawn(event="up")
        # the reaction gauge wants breach -> READY, so gate readiness
        # off the control thread — the loop must keep sampling (and be
        # able to scale again after cooldown) while the worker boots
        def gate() -> None:
            if self.pool.wait_ready(worker):
                reaction = time.monotonic() - breach_t0
                self.last_reaction_s = reaction
                _M_SCALE_REACTION.set(reaction)
                self.info(f"autoscale: worker {worker.rank} ready "
                          f"{reaction:.2f}s after the breach began")
            else:
                self.warning(f"autoscale: worker {worker.rank} never "
                             f"became ready")

        threading.Thread(target=gate, daemon=True,
                         name="znicz-autoscale-gate").start()
        return "up"

    def _scale_down(self, now: float) -> Optional[str]:
        ready = self.pool.ready_workers()
        victim = max(ready, key=lambda w: w.rank) if ready else None
        if victim is None:
            # nothing safely retirable (everything above the floor is
            # booting/retiring): no action, no cooldown burned — a
            # breach a moment later must still scale up immediately
            return None
        self._last_action_ts = now
        self._idle_since = None         # a fresh idle window per retire
        self.scale_downs += 1
        self.info(f"autoscale: fleet idle {self.idle_down_s:g}s -> "
                  f"draining worker {victim.rank} "
                  f"({self.pool.worker_count() - 1} remain)")
        # drain off-thread: the SIGTERM-to-exit window is the worker's
        # business, the control loop only stops routing to it (retire
        # flips `retiring` synchronously, before this returns)
        self.pool.retire(victim, event="down", wait=False)
        threading.Thread(target=self.pool.reap, args=(victim,),
                         daemon=True,
                         name="znicz-autoscale-reap").start()
        return "down"

    # -- cadence -------------------------------------------------------------
    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception as exc:  # noqa: BLE001 — the control
                    self.warning(f"autoscale tick failed: {exc!r}")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="znicz-autoscale")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def status(self) -> dict:
        return {"min_workers": self.min_workers,
                "max_workers": self.max_workers,
                "workers": self.pool.worker_count(),
                "breaching": self._breaching(),
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "last_reaction_s": self.last_reaction_s,
                "rules": [r.snapshot() for r in self.rules]}
