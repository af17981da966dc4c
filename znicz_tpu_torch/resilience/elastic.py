"""Elastic multi-process training — the fleet supervisor, a copy of
``znicz_tpu/resilience/elastic.py`` but for the worker command
(``python -m znicz_tpu_torch``) and the CLI's names and help texts
(held so by ``tests/test_torch_port_isolation.py``).

``run_supervised`` (supervisor.py) restarts a crashed trainer
*in-process*; this module lifts the same contract across real process
boundaries, the VELES master–slave topology reborn as
coordinator-supervised SPMD peers (PAPER.md §1; TensorFlow's
checkpoint-based recovery, arXiv 1605.08695, is the fault-tolerance
blueprint; Awan et al. 2018 motivates treating process death as a
first-class, measured event).

``run_elastic(worker_argv, snap_dir)`` spawns N worker processes — each
one the ordinary ``python -m znicz_tpu_torch <workflow.py> ...`` CLI,
joined into one job via ``launcher.multihost`` when ``spmd=True`` (gloo
with ``-d cpu``, NCCL on the card) — and
supervises them:

- **exit-code watch + heartbeats**: workers touch a per-rank heartbeat
  file (``start_heartbeat``, wired by ``__main__``) carrying a
  timestamp and the workflow's ``signals_dispatched`` progress counter;
  the fleet declares a worker dead on an unexpected exit, wedged on a
  stale heartbeat, and hung on a flat progress counter;
- **kill-and-resume**: on any death the remainder is SIGTERM'd (the
  launcher's snapshot-then-exit handler gives them one epoch boundary
  to publish), a flight-recorder artifact is dumped, the newest VALID
  snapshot is picked via ``find_latest_valid_snapshot``, and the fleet
  relaunches — **optionally at a different world size**
  (``world_sizes=[2, 1]`` = start at 2, resume at 1): elastic re-mesh,
  real across processes;
- **budget + backoff** ride the existing :class:`SupervisorPolicy`.

Worker environment contract (what a worker process finds):

=============================  =========================================
``ZNICZ_TPU_ELASTIC_RANK``     this worker's rank (snapshot election:
                               rank 0 writes, every other rank verifies
                               — ``snapshotter.process_rank_world``)
``ZNICZ_TPU_ELASTIC_WORLD``    the round's worker count
``ZNICZ_TPU_SNAP_DIR``         the fleet's snapshot directory (workflow
                               files point their snapshotter here)
``ZNICZ_TPU_HEARTBEAT``        heartbeat file path (``__main__`` starts
                               the beat thread when set)
``ZNICZ_TPU_FAULT_PLAN``       serialized :class:`FaultPlan` — round-0
                               workers only, so a seeded kill drill
                               does not re-fire after every resume
``ZNICZ_TPU_METRICS_EXPORT``   rank-tagged registry snapshot file the
                               worker atomically rewrites (``__main__``
                               starts the exporter when set) — the
                               supervisor's fleet aggregator ingests
                               these beside the heartbeats
=============================  =========================================

Fleet telemetry: the supervisor hosts an
``observe/federation.py`` :class:`FleetAggregator` over the round's
worker snapshot files — every flight artifact it dumps embeds each
worker's last registry snapshot (the ``planes.fleet`` key), and
``fleet_port=N`` / ``--fleet-port N`` serves the merged
``/fleet/metrics[.prom]`` + ``/fleet/status.json`` view while the
fleet runs.

Determinism contract (pinned by tests/test_elastic.py): the workers'
snapshot resume is the snapshotter's bit-exact resume, so a fleet killed
at any point and relaunched at ANY world size reproduces the
uninterrupted run's metric history exactly.

CLI: ``python -m znicz_tpu_torch elastic --workers N --snap-dir D
<workflow.py> [worker args ...]``.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Mapping, Optional, Sequence

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.observe import federation as _federation
from znicz_tpu_torch.observe import flight as _flight
from znicz_tpu_torch.observe import probe as _probe
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.resilience.supervisor import (SupervisorExhausted,
                                             SupervisorPolicy,
                                             find_latest_valid_snapshot)

#: exit code a SIGTERM'd worker uses for "terminated as asked" (the
#: launcher's snapshot-then-exit handler).  During a round TEARDOWN this
#: is the expected graceful outcome; a worker exiting 143 on its own
#: (an operator or cgroup SIGTERM the fleet did not send) still counts
#: as a death, because the round can no longer complete either way —
#: the distinction 143 buys is "clean snapshot published" vs "died
#: mid-write", not "ignore me"
TERMINATED_EXIT = 143

HEARTBEAT_ENV = "ZNICZ_TPU_HEARTBEAT"
HEARTBEAT_INTERVAL_ENV = "ZNICZ_TPU_HEARTBEAT_INTERVAL"
RANK_ENV = "ZNICZ_TPU_ELASTIC_RANK"
WORLD_ENV = "ZNICZ_TPU_ELASTIC_WORLD"
SNAP_DIR_ENV = "ZNICZ_TPU_SNAP_DIR"


class ElasticExhausted(SupervisorExhausted):
    """Fleet restart budget spent without a completed run."""


# -- worker side -------------------------------------------------------------

def start_heartbeat(path: str, interval: float = 0.25,
                    progress=None) -> threading.Thread:
    """Worker-side beat: a daemon thread rewrites ``path`` with
    ``"<unix-ts> <progress>"`` every ``interval`` seconds.  ``progress``
    is a callable returning the workflow's ``signals_dispatched`` (-1
    until one exists) — mtime proves the PROCESS is alive, the counter
    proves the STEP LOOP is, which is how the fleet tells a wedged
    process from a hung step.  Write failures are swallowed: a full
    disk must not kill the trainer, only its liveness signal."""
    progress = progress or (lambda: -1)

    def beat() -> None:
        while True:
            try:
                value = int(progress())
            except Exception:  # noqa: BLE001 — a torn-down workflow
                value = -1
            try:
                with open(path, "w") as f:
                    f.write(f"{time.time():.3f} {value}\n")
            except OSError:
                pass
            time.sleep(interval)

    t = threading.Thread(target=beat, name="znicz-heartbeat", daemon=True)
    t.start()
    return t


def _read_heartbeat(path: str):
    """-> (mtime, progress) or None while the file does not parse."""
    try:
        with open(path) as f:
            ts_text, _, progress_text = f.read().strip().partition(" ")
        return float(ts_text), int(progress_text)
    except (OSError, ValueError):
        return None


# -- supervisor side ---------------------------------------------------------

class WorkerProcess:
    """One spawned worker process + its log pump — the fleet's unit of
    supervision.  It is the SHARED spawn/retire primitive:
    the elastic training supervisor and the serving fleet's worker pool
    (the reference's ``fleet/workers.py``) both manage these, through
    :func:`spawn_worker` / :func:`teardown_workers`, so process
    lifecycle (log pumping, SIGTERM-grace-SIGKILL reaping, tail capture
    for post-mortems) lives once."""

    def __init__(self, rank: int, proc: subprocess.Popen,
                 heartbeat_path: str, log_path: str,
                 log_tree: str = "elastic") -> None:
        self.rank = rank
        self.proc = proc
        self.heartbeat_path = heartbeat_path
        self.log_path = log_path
        self.log_tree = log_tree
        self.tail: collections.deque = collections.deque(maxlen=40)
        self.started = time.monotonic()
        self.last_progress = -1
        self.last_progress_change = self.started
        self.killed = False          # teardown-initiated, not a death
        self._pump = threading.Thread(target=self._pump_output,
                                      name=f"znicz-{log_tree}-w{rank}-log",
                                      daemon=True)
        self._pump.start()

    def _pump_output(self) -> None:
        """Worker stdout/stderr -> per-worker log file + the supervisor's
        logging tree under ``znicz_tpu.<tree>.w<rank>`` (a configured
        JSONL sink therefore interleaves every worker, rank-prefixed,
        on one machine-readable stream)."""
        log = logging.getLogger(f"znicz_tpu.{self.log_tree}.w{self.rank}")
        try:
            with open(self.log_path, "a") as sink:
                for line in self.proc.stdout:
                    line = line.rstrip("\n")
                    self.tail.append(line)
                    sink.write(line + "\n")
                    log.debug("%s", line)
        except (OSError, ValueError):
            pass                     # stream closed under us at teardown

    def update_progress(self, now: float) -> None:
        beat = _read_heartbeat(self.heartbeat_path)
        if beat is None:
            return
        _, progress = beat
        if progress != self.last_progress:
            self.last_progress = progress
            self.last_progress_change = now

    def heartbeat_age(self) -> Optional[float]:
        try:
            return time.time() - os.path.getmtime(self.heartbeat_path)
        except OSError:
            return None


#: historical private name, kept for in-repo references
_Worker = WorkerProcess


class GoodputLedger:
    """Supervisor wall-time attribution: every second of the
    fleet's life is charged to exactly one category per rank —

    ==============  ====================================================
    ``productive``  round run windows that fed a surviving snapshot
                    (completed rounds fully; failed rounds up to the
                    newest valid snapshot's mtime)
    ``lost``        a failed round's remainder past that snapshot — the
                    compute a resume re-does
    ``snapshot``    teardown grace windows (SIGTERM is the launcher's
                    snapshot-then-exit)
    ``idle``        spawn windows, flight dumps, restart backoff — the
                    supervisor's own overhead
    ==============  ====================================================

    A monotonic cursor guarantees the categories tile the wall: each
    :meth:`advance` charges exactly cursor->now, so per rank the four
    sums reconstruct the supervisor's wall time (pinned by
    tests/test_elastic.py).  Every segment is donated to the
    ``znicz_goodput_*`` probe families, and :meth:`as_dict` doubles as
    the flight recorder's ``goodput`` plane, so a restart artifact
    carries the ledger of the round it post-mortems."""

    CATEGORIES = ("productive", "lost", "snapshot", "idle")

    def __init__(self) -> None:
        self.started = time.monotonic()
        self._cursor = self.started
        self._ranks: tuple = (0,)
        self.per_rank: dict = {}

    def _charge(self, category: str, dt: float) -> None:
        if dt <= 0.0:
            return
        for rank in self._ranks:
            cats = self.per_rank.setdefault(
                str(rank), dict.fromkeys(self.CATEGORIES, 0.0))
            cats[category] += dt
            _probe.goodput_note(category, rank, dt)

    def advance(self, category: str, ranks=None,
                until: Optional[float] = None) -> float:
        """Charge cursor->``until`` (default: now) as ``category`` to
        ``ranks`` (default: the previous segment's ranks)."""
        if ranks is not None:
            self._ranks = tuple(ranks) or (0,)
        now = time.monotonic() if until is None else until
        dt = now - self._cursor
        self._cursor = max(self._cursor, now)
        self._charge(category, dt)
        return dt

    def advance_split(self, boundary_s: float, before: str, after: str,
                      ranks=None) -> float:
        """Charge cursor->now as two categories: the first
        ``boundary_s`` seconds as ``before``, the remainder as
        ``after`` — the failed-round split (productive up to the
        surviving snapshot, lost past it).  A stale snapshot from an
        earlier round arrives as a negative/zero boundary and the whole
        window lands in ``after``."""
        if ranks is not None:
            self._ranks = tuple(ranks) or (0,)
        now = time.monotonic()
        dt = max(0.0, now - self._cursor)
        self._cursor = max(self._cursor, now)
        head = min(max(0.0, boundary_s), dt)
        self._charge(before, head)
        self._charge(after, dt - head)
        return dt

    def totals(self) -> dict:
        out = dict.fromkeys(self.CATEGORIES, 0.0)
        for cats in self.per_rank.values():
            for cat, seconds in cats.items():
                out[cat] += seconds
        return out

    def as_dict(self) -> dict:
        totals = self.totals()
        spent = sum(totals.values())
        return {"wall_s": time.monotonic() - self.started,
                "per_rank": {r: dict(c)
                             for r, c in sorted(self.per_rank.items())},
                "totals": totals,
                "ratio": (totals["productive"] / spent) if spent > 0.0
                else 0.0}


def spawn_worker(argv: Sequence[str], *, rank: int, log_path: str,
                 env: Optional[Mapping[str, str]] = None,
                 heartbeat_path: str = "",
                 log_tree: str = "elastic") -> WorkerProcess:
    """Spawn one supervised worker process (the shared spawn hook):
    stdout+stderr piped into the :class:`WorkerProcess` log pump, text
    mode, line buffered.  ``heartbeat_path`` may be "" for workers whose
    liveness is probed another way (the serving fleet probes HTTP
    ``/livez`` instead of heartbeat files)."""
    proc = subprocess.Popen(
        list(argv), env=dict(env) if env is not None else None,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        bufsize=1)
    return WorkerProcess(rank, proc, heartbeat_path, log_path,
                         log_tree=log_tree)


class ElasticReport:
    """What happened across the fleet's rounds."""

    def __init__(self) -> None:
        self.completed = False
        self.rounds: list[dict] = []
        self.restarts = 0
        self.worker_deaths: list[dict] = []
        self.resumed_from: list[str] = []
        self.rejected_snapshots: list[str] = []
        self.hang_events = 0
        self.flights: list[str] = []
        self.world_size = 0          # final round's world size
        self.goodput: dict = {}      # GoodputLedger.as_dict() at exit

    def as_dict(self) -> dict:
        return {"completed": self.completed, "rounds": self.rounds,
                "restarts": self.restarts,
                "worker_deaths": list(self.worker_deaths),
                "resumed_from": list(self.resumed_from),
                "rejected_snapshots": list(self.rejected_snapshots),
                "hang_events": self.hang_events,
                "flights": list(self.flights),
                "world_size": self.world_size,
                "goodput": dict(self.goodput)}


def _free_port(host: str) -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def run_elastic(worker_argv: Sequence[str], snap_dir: str, *,
                workers: int = 2,
                world_sizes: Optional[Sequence[int]] = None,
                policy: Optional[SupervisorPolicy] = None,
                prefix: Optional[str] = None,
                run_dir: Optional[str] = None,
                spmd: bool = True,
                coordinator_host: str = "127.0.0.1",
                env: Optional[Mapping[str, str]] = None,
                fault_plans: Optional[Mapping[int, object]] = None,
                poll_s: float = 0.05,
                term_grace: float = 5.0,
                heartbeat_interval: float = 0.25,
                heartbeat_timeout: Optional[float] = None,
                progress_timeout: Optional[float] = None,
                boot_timeout: Optional[float] = None,
                round_timeout: Optional[float] = None,
                fleet_port: Optional[int] = None,
                metrics_interval: float = 1.0,
                stop_event: Optional[threading.Event] = None
                ) -> ElasticReport:
    """Supervise an elastic worker fleet to completion.

    ``worker_argv`` is the CLI tail after ``python -m znicz_tpu_torch`` (the
    workflow file, configs, flags); the fleet appends per-worker
    ``--coordinator/--num-processes/--process-id`` (when ``spmd``) and
    ``-w <snapshot>`` on resumed rounds.  ``world_sizes`` is the
    per-round worker count (last entry repeats; default: ``[workers]``).
    ``fault_plans`` maps rank -> :class:`FaultPlan` (or a pre-serialized
    string) injected into ROUND 0 workers' env only — a seeded kill
    drill fires once and resumed rounds run clean (a plan inherited
    from the supervisor's own env is deliberately scrubbed for the same
    reason).  Optional watch layers, each in seconds: ``heartbeat_
    timeout`` (stale heartbeat file = wedged process), ``progress_
    timeout`` (flat step counter after the first step = hung step —
    deliberately blind before step 1, where a long first compile is
    indistinguishable from a stall), ``boot_timeout`` (no first step
    within this long of launch = hung boot; size it above worst
    torch-import + kernel-build time), ``round_timeout`` (whole-round
    backstop).  ``policy`` supplies the restart budget + backoff.
    ``fleet_port`` serves the fleet aggregator's merged telemetry
    (``/fleet/metrics[.prom]``, ``/fleet/status.json``) while the fleet
    runs (None = the aggregator still ingests worker snapshots so
    flight artifacts embed them, just no listener);
    ``metrics_interval`` is the workers' snapshot-export cadence.
    ``stop_event`` is a cooperative shutdown hook (the learn
    CLI supervises its trainer on a thread and must be able to retire
    it on SIGTERM): once set, the in-flight round is torn down
    gracefully (SIGTERM = snapshot-then-exit) and the report returns
    with a ``"stopped"`` round instead of a restart.

    Returns an :class:`ElasticReport`; raises :class:`ElasticExhausted`
    when the budget is spent.
    """
    policy = policy or SupervisorPolicy()
    log = Logger()
    report = ElasticReport()
    schedule = [int(w) for w in (world_sizes or [workers])]
    if any(w < 1 for w in schedule):
        raise ValueError(f"world sizes must be >= 1, got {schedule}")
    run_dir = run_dir or os.path.join(snap_dir, "elastic")
    os.makedirs(run_dir, exist_ok=True)
    os.makedirs(snap_dir, exist_ok=True)
    base_env = dict(env if env is not None else os.environ)
    # a plan in the SUPERVISOR'S env must not leak into every worker of
    # every round: hit counters reset with each fresh process, so an
    # inherited seeded kill would re-fire after every resume and the
    # fleet could never complete — plans reach workers only through
    # ``fault_plans`` (round 0, per rank)
    base_env.pop(faults.PLAN_ENV_VAR, None)
    # the fleet telemetry master view: sources re-registered
    # per round, embedded into every flight dump via the "fleet" plane;
    # staleness bound sized to the export cadence so a SIGKILL'd
    # worker's series drop out instead of reading live forever
    aggregator = _federation.FleetAggregator(
        stale_s=max(10.0 * metrics_interval, 5.0))
    # the goodput ledger: every supervisor second lands in
    # exactly one znicz_goodput_* family per rank.  Children pre-touched
    # for the whole schedule up front (the delta-rule lesson: a
    # fleet rule over a series that first appears mid-incident reads as
    # a rate spike or never trips at all)
    ledger = GoodputLedger()
    _probe.goodput_pretouch(range(max(schedule)))
    goodput_plane = ledger.as_dict
    _flight.register_plane("goodput", goodput_plane)
    current: list = []       # the in-flight round's workers, shared with
    try:                     # the round loop so cleanup sees them all
        if fleet_port is not None:
            # inside the try: a bind failure must still run close(),
            # which unregisters the "fleet" flight plane this
            # aggregator registered at construction
            aggregator.serve(port=fleet_port)
        return _supervise_rounds(
            worker_argv, snap_dir, schedule, policy, prefix, run_dir,
            spmd, coordinator_host, base_env, fault_plans, poll_s,
            term_grace, heartbeat_interval, heartbeat_timeout,
            progress_timeout, boot_timeout, round_timeout, report, log,
            current, aggregator, metrics_interval, ledger, stop_event)
    finally:
        # ANY exit — completion, ElasticExhausted, KeyboardInterrupt,
        # a spawn OSError halfway through a round — must not orphan
        # live workers (they would keep training and writing snapshots
        # a later invocation silently resumes from)
        leaked = [w for w in current if w.proc.poll() is None]
        if leaked:
            log.warning(f"elastic: reaping {len(leaked)} live worker(s) "
                        f"on supervisor exit")
            # an abnormal exit mid-round: the round ran until now, the
            # reap is a snapshot window (SIGTERM = snapshot-then-exit)
            ledger.advance("productive")
            teardown_workers(leaked, term_grace, log)
            ledger.advance("snapshot")
        # flush the tail so the categories tile the supervisor's wall
        ledger.advance("idle")
        report.goodput = ledger.as_dict()
        _flight.unregister_plane("goodput", goodput_plane)
        aggregator.close()
        _probe.elastic_world_size(0)


def _supervise_rounds(worker_argv, snap_dir, schedule, policy, prefix,
                      run_dir, spmd, coordinator_host, base_env,
                      fault_plans, poll_s, term_grace,
                      heartbeat_interval, heartbeat_timeout,
                      progress_timeout, boot_timeout, round_timeout,
                      report, log, current, aggregator,
                      metrics_interval, ledger,
                      stop_event=None) -> ElasticReport:
    """:func:`run_elastic`'s round loop, split out so the caller's
    try/finally can guarantee teardown of ``current`` on ANY exit."""
    round_no = 0
    while True:
        if stop_event is not None and stop_event.is_set():
            # stop landed between rounds (e.g. during backoff): do not
            # spawn a round just to tear it down
            report.rounds.append({"round": round_no, "world": 0,
                                  "outcome": "stopped"})
            return report
        world = schedule[min(round_no, len(schedule) - 1)]
        resume = find_latest_valid_snapshot(
            snap_dir, prefix, rejected=report.rejected_snapshots)
        if resume is not None:
            report.resumed_from.append(resume)
            _probe.elastic_event("resume", round=round_no,
                                 snapshot=os.path.basename(resume))
        coordinator = None
        if spmd:
            coordinator = (f"{coordinator_host}:"
                           f"{_free_port(coordinator_host)}")
        current.clear()
        fleet: list = current          # shared with the caller's finally
        aggregator.clear_sources()     # this round's files replace last
        for rank in range(world):
            argv = [sys.executable, "-m", "znicz_tpu_torch", *worker_argv]
            if spmd:
                argv += ["--coordinator", coordinator,
                         "--num-processes", str(world),
                         "--process-id", str(rank)]
            if resume is not None:
                argv += ["-w", resume]
            hb_path = os.path.join(run_dir, f"hb_r{round_no}_w{rank}")
            mx_path = os.path.join(run_dir,
                                   f"metrics_r{round_no}_w{rank}.json")
            worker_env = dict(base_env)
            worker_env[RANK_ENV] = str(rank)
            worker_env[WORLD_ENV] = str(world)
            worker_env[SNAP_DIR_ENV] = str(snap_dir)
            worker_env[HEARTBEAT_ENV] = hb_path
            worker_env[HEARTBEAT_INTERVAL_ENV] = repr(heartbeat_interval)
            worker_env[_federation.METRICS_EXPORT_ENV] = mx_path
            worker_env[_federation.METRICS_EXPORT_INTERVAL_ENV] = \
                repr(metrics_interval)
            aggregator.add_file_source(rank, mx_path)
            if round_no == 0 and fault_plans and rank in fault_plans:
                plan = fault_plans[rank]
                worker_env[faults.PLAN_ENV_VAR] = (
                    plan if isinstance(plan, str) else plan.to_env())
            fleet.append(spawn_worker(
                argv, rank=rank, env=worker_env, heartbeat_path=hb_path,
                log_path=os.path.join(run_dir,
                                      f"worker_r{round_no}_w{rank}.log")))
        _probe.elastic_world_size(world)
        log.info(f"elastic: round {round_no} up — {world} worker(s)"
                 + (f", resumed from {os.path.basename(resume)}"
                    if resume else ", cold start")
                 + (f", coordinator {coordinator}" if coordinator else ""))
        # everything since the last stamp — the spawn loop plus the
        # previous round's flight dump and restart backoff — is the
        # supervisor's own overhead, charged to this round's ranks
        ledger.advance("idle", ranks=range(world))
        round_started = time.monotonic()
        round_wall_started = time.time()   # snapshot mtimes are wall time
        deaths: list[dict] = []
        hung: list[dict] = []
        timed_out = False
        while True:
            now = time.monotonic()
            if stop_event is not None and stop_event.is_set():
                # cooperative shutdown: SIGTERM the round —
                # the launcher handler turns that into one final
                # snapshot — and return without a restart
                log.info("elastic: stop requested; retiring the round")
                ledger.advance("productive")   # the round ran until now
                teardown_workers(fleet, term_grace, log)
                ledger.advance("snapshot")     # SIGTERM grace window
                report.rounds.append({"round": round_no, "world": world,
                                      "outcome": "stopped"})
                report.world_size = world
                return report
            alive = [w for w in fleet if w.proc.poll() is None]
            if fleet[0].proc.poll() == 0:
                # rank 0 — the snapshot writer and history owner —
                # exited 0: the job's output is complete.  Check BEFORE
                # the deaths scan: when the writer finishes first, its
                # exit tears the process group's store down, and
                # a slower replica's resulting abort must read as a
                # redundant straggler, not as a death that fails a
                # finished round.  (A writer that exits NONZERO still
                # lands in the deaths scan below.)
                # replicas finishing moments behind the writer (the
                # election self-pacing keeps them within one poll) get
                # one grace window to exit on their own before the reap
                grace_end = time.monotonic() + term_grace
                while time.monotonic() < grace_end and \
                        any(w.proc.poll() is None for w in fleet):
                    time.sleep(poll_s)
                stragglers = [w.rank for w in fleet
                              if w.proc.poll() != 0]
                if stragglers:
                    log.info(f"elastic: rank 0 completed; reaping "
                             f"redundant straggler(s) {stragglers}")
                    teardown_workers([w for w in fleet if w.rank in stragglers],
                              term_grace, log)
                report.rounds.append({"round": round_no, "world": world,
                                      "outcome": "completed",
                                      "stragglers": stragglers})
                # the whole round window — including the straggler
                # grace — is productive: the job's output is complete
                ledger.advance("productive")
                report.completed = True
                report.world_size = world   # gauge zeroed by the caller
                log.info(f"elastic: completed at world size {world} "
                         f"after {report.restarts} restart(s)")
                return report
            deaths = [
                {"rank": w.rank, "code": w.proc.returncode,
                 "cause": "signal" if w.proc.returncode < 0 else "exit",
                 "tail": list(w.tail)[-10:]}
                for w in fleet
                if w.proc.poll() not in (None, 0)]
            if deaths:
                break
            for w in alive:
                w.update_progress(now)
                # wedged BEFORE hung: when the whole interpreter is
                # stuck (native deadlock, GIL held) the heartbeat
                # daemon freezes too, so mtime AND progress both stall
                # — the stale file is the discriminator, and checking
                # flat progress first would misfile every post-step-1
                # wedge as a mere hung step
                age = w.heartbeat_age()
                stale = heartbeat_timeout is not None and (
                    (age is not None and age > heartbeat_timeout) or
                    (age is None and now - w.started > heartbeat_timeout))
                if stale:
                    hung.append({"rank": w.rank, "cause": "wedged",
                                 "heartbeat_age": age})
                elif progress_timeout is not None and \
                        w.last_progress > 0 and \
                        now - w.last_progress_change > progress_timeout:
                    hung.append({"rank": w.rank, "cause": "hung",
                                 "progress": w.last_progress})
                elif boot_timeout is not None and w.last_progress <= 0 \
                        and now - w.started > boot_timeout:
                    # never reached step 1: a hang inside boot/compile,
                    # where the progress watch is deliberately blind
                    hung.append({"rank": w.rank, "cause": "boot",
                                 "progress": w.last_progress})
            if hung:
                break
            if round_timeout is not None and \
                    now - round_started > round_timeout:
                timed_out = True
                break
            time.sleep(poll_s)
        # -- failure round: record, tear down, dump, back off, relaunch --
        for death in deaths:
            report.worker_deaths.append(death)
            _probe.elastic_event("worker_death", cause=death["cause"],
                                 rank=death["rank"], code=death["code"])
            log.warning(f"elastic: worker {death['rank']} died "
                        f"(code {death['code']})")
        for event in hung:
            report.hang_events += 1
            _probe.elastic_event("worker_death", cause=event["cause"],
                                 rank=event["rank"])
            log.warning(f"elastic: worker {event['rank']} "
                        f"{event['cause']} "
                        f"(progress {event.get('progress')})")
        if timed_out:
            log.warning(f"elastic: round {round_no} exceeded "
                        f"{round_timeout}s; restarting")
        # goodput split for the failed round: productive up to the
        # newest snapshot that survives validation (that compute is
        # KEPT — the resume continues from it), lost past it (that
        # compute is re-done).  A snapshot from an earlier round has
        # mtime < round start and the whole window reads as lost.
        saved = find_latest_valid_snapshot(
            snap_dir, prefix, rejected=report.rejected_snapshots)
        saved_s = 0.0
        if saved is not None:
            try:
                saved_s = os.path.getmtime(saved) - round_wall_started
            except OSError:
                saved_s = 0.0
        ledger.advance_split(saved_s, "productive", "lost")
        teardown_workers(fleet, term_grace, log)
        ledger.advance("snapshot")     # SIGTERM grace window
        report.rounds.append({
            "round": round_no, "world": world, "outcome": "failed",
            "deaths": deaths, "hung": hung, "timed_out": timed_out})
        report.restarts += 1          # counts FAILED rounds (supervisor
        exhausted = report.restarts > policy.max_restarts   # semantics)
        if not exhausted:
            # the metric is documented as "the fleet relaunched": the
            # final failed round that only raises must not inflate it
            _probe.elastic_event("restart", round=round_no, world=world)
        if policy.flight_recorder:
            # the fleet-side post-mortem: which workers died, with what
            # codes, their last output lines, plus this process's whole
            # telemetry state — dumped BEFORE the relaunch overwrites
            # it.  One forced scrape first: the artifact's "fleet"
            # plane then embeds each worker's LAST exported registry
            # snapshot (the dead rank's included), ledger-checkable
            # without any live worker
            try:
                aggregator.refresh(force=True)
            except Exception:  # noqa: BLE001 — telemetry must not
                pass           # block the post-mortem
            try:
                report.flights.append(_flight.dump(
                    dir=run_dir,
                    reason="elastic_exhausted" if exhausted
                    else "elastic_restart",
                    extra={"round": round_no, "world": world,
                           "deaths": deaths, "hung": hung,
                           "timed_out": timed_out,
                           "restarts": report.restarts}))
            except Exception as exc:  # noqa: BLE001
                log.warning(f"elastic: flight dump failed: {exc!r}")
        if exhausted:
            raise ElasticExhausted(
                f"elastic fleet gave up after {report.restarts} failed "
                f"rounds ({policy.max_restarts} restart(s) allowed); "
                f"deaths: {report.worker_deaths}, hangs: "
                f"{report.hang_events}")
        policy.sleep(policy.restart_delay(report.restarts))
        round_no += 1


def teardown_workers(fleet: list, term_grace: float, log) -> None:
    """Kill a fleet's survivors (the shared retire hook): SIGTERM (the
    launcher handler turns it into snapshot-then-exit-143; serving
    workers drain and exit 0), bounded grace, then SIGKILL.  Every
    process is reaped.  A worker whose ``killed`` flag is already set
    was signaled by the caller and is NOT re-signaled — the serving
    CLIs restore the default SIGTERM disposition once their drain
    begins, so a second SIGTERM would kill a worker mid-drain (-15)
    and lose the requests it had admitted."""
    for w in fleet:
        if w.proc.poll() is None and not w.killed:
            w.killed = True
            try:
                w.proc.terminate()
            except OSError:
                pass
    deadline = time.monotonic() + term_grace
    for w in fleet:
        while w.proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        if w.killed and w.proc.poll() == TERMINATED_EXIT:
            log.info(f"elastic: worker {w.rank} terminated gracefully "
                     f"(snapshot-then-exit {TERMINATED_EXIT})")
        if w.proc.poll() is None:
            log.warning(f"elastic: worker {w.rank} survived SIGTERM "
                        f"{term_grace}s grace; SIGKILL")
            try:
                w.proc.kill()
            except OSError:
                pass
        try:
            w.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:  # pragma: no cover — SIGKILL'd
            pass


# -- CLI ---------------------------------------------------------------------

def elastic_main(argv) -> int:
    """``python -m znicz_tpu_torch elastic --workers N --snap-dir D
    <workflow.py> [worker args ...]`` — unknown flags pass through to the
    workers verbatim, so everything the plain CLI accepts works here."""
    import argparse

    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch elastic", allow_abbrev=False,
        description="coordinator-supervised elastic worker fleet")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--snap-dir", required=True,
                   help="shared snapshot directory (workers see it as "
                        "$ZNICZ_TPU_SNAP_DIR; rank 0 writes, others "
                        "verify)")
    p.add_argument("--prefix", default=None,
                   help="snapshot filename prefix filter for resume")
    p.add_argument("--run-dir", default=None,
                   help="fleet artifacts: worker logs, heartbeats, "
                        "flight dumps (default: <snap-dir>/elastic)")
    p.add_argument("--world-sizes", default=None, metavar="N,M,...",
                   help="per-round worker counts, e.g. 2,1 = start at "
                        "2, resume at 1 (default: --workers for every "
                        "round)")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--no-spmd", action="store_true",
                   help="do not join workers via torch.distributed "
                        "(independent replicated workers)")
    p.add_argument("--heartbeat-timeout", type=float, default=60.0)
    p.add_argument("--progress-timeout", type=float, default=None,
                   help="declare a worker hung when its step counter is "
                        "flat this long (off by default: size it above "
                        "the worst compile+step time)")
    p.add_argument("--boot-timeout", type=float, default=None,
                   help="declare a worker hung when it reaches no first "
                        "step this long after launch (off by default: "
                        "size it above worst torch-import + build time)")
    p.add_argument("--round-timeout", type=float, default=None)
    p.add_argument("--term-grace", type=float, default=5.0)
    p.add_argument("--fleet-port", type=int, default=None,
                   help="serve the fleet aggregator's merged telemetry "
                        "(/fleet/metrics[.prom], /fleet/status.json) on "
                        "this port while the fleet runs (0 picks a free "
                        "one; default: no listener — worker snapshots "
                        "still feed flight artifacts)")
    p.add_argument("--fault-plan", action="append", default=[],
                   metavar="RANK=JSON",
                   help="arm a serialized FaultPlan (FaultPlan.to_env "
                        "output) in one ROUND-0 worker's env — the "
                        "seeded chaos drill hook; repeatable.  (A "
                        "ZNICZ_TPU_FAULT_PLAN in the supervisor's own "
                        "env is deliberately NOT inherited: it would "
                        "re-fire after every resume.)")
    args, worker_argv = p.parse_known_args(argv)
    if not worker_argv:
        p.error("no worker command given (expected a workflow .py and "
                "its flags after the elastic options)")
    fault_plans = {}
    for spec in args.fault_plan:
        rank_text, sep, plan_text = spec.partition("=")
        if not sep or not rank_text.isdigit():
            p.error(f"--fault-plan wants RANK=JSON, got {spec!r}")
        try:
            faults.FaultPlan.from_env(plan_text)  # validate loudly now
        except (ValueError, KeyError, TypeError) as exc:
            p.error(f"--fault-plan {rank_text}: bad plan JSON "
                    f"({exc!r})")
        fault_plans[int(rank_text)] = plan_text
    try:
        report = run_elastic(
            worker_argv, args.snap_dir, workers=args.workers,
            world_sizes=[int(w) for w in args.world_sizes.split(",")]
            if args.world_sizes else None,
            policy=SupervisorPolicy(max_restarts=args.max_restarts),
            prefix=args.prefix, run_dir=args.run_dir,
            spmd=not args.no_spmd, term_grace=args.term_grace,
            fault_plans=fault_plans,
            heartbeat_timeout=args.heartbeat_timeout,
            progress_timeout=args.progress_timeout,
            boot_timeout=args.boot_timeout,
            round_timeout=args.round_timeout,
            fleet_port=args.fleet_port)
    except ElasticExhausted as exc:
        print(f"elastic: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(report.as_dict()))
    return 0
