"""Launcher — the port of ``znicz_tpu/launcher.py`` (rebuild of
veles/launcher.py :: Launcher).

Owns a workflow's lifecycle: device selection, optional snapshot resume,
initialize/run/stop, the timing table.  The device is ``cuda`` unless the
caller names another (``TorchDevice("cpu")``, ``NumpyDevice()``): there
is no quiet CPU fallback.  ``stealth`` (``-s``) is accepted and does
nothing: the port has no plotters or other side services to suppress.

The multi-process join (``multihost``, the CLI's ``--coordinator``) is
the reference's collapse of veles' master/slave protocol into peers
(SURVEY.md §3.4): N identical processes join one ``torch.distributed``
world and run the same standalone path, the fused step's collectives
replacing the job protocol.

``profile_dir`` (``--profile DIR``) wraps ``workflow.run()`` in
``torch.profiler.profile`` — CPU activity, plus CUDA activity when the
run is on the card — and writes its Chrome trace to
``DIR/<run>/<host>.<pid>.pt.trace.json``, one run directory a launch;
a failure to write is logged, never raised, and then the top-15 table
of ``utils/profiling.py summarize_trace`` is logged.

``manhole_path`` (``--manhole[=PATH]``) serves a live REPL into the
running workflow (``utils/manhole.py``: a 0600 AF_UNIX socket, ``""``
for a private path) with the reference's namespace, ``wf``,
``launcher`` and ``root``, from after the resume until the run stops.
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import sys
import time
from typing import Optional

from znicz_tpu_torch.core.backends import AutoDevice, Device
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.resilience.retry import RetryPolicy
from znicz_tpu_torch.snapshotter import process_rank_world, restore_state

#: non-zero ranks wait for the coordinator under this schedule before
#: joining: bounded at ~60 s of backed-off TCP probes (the reference's)
DEFAULT_CONNECT_RETRY = dict(max_attempts=40, base_delay=0.1,
                             multiplier=1.4, max_delay=3.0,
                             retryable=(OSError,), seed=0)


class CoordinatorUnreachable(RuntimeError):
    """The multihost coordinator never accepted a connection within the
    bounded retry schedule."""


def wait_for_coordinator(coordinator: str,
                         policy: Optional[RetryPolicy] = None,
                         connect_timeout: float = 1.0) -> None:
    """Block until ``coordinator`` (``host:port``) accepts a TCP
    connection, retrying under a bounded ``RetryPolicy``; exhaustion
    raises :class:`CoordinatorUnreachable` naming the address."""
    policy = policy or RetryPolicy(**DEFAULT_CONNECT_RETRY)
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {coordinator!r} is not "
                         f"host:port")

    def probe() -> None:
        with socket.create_connection((host, int(port)),
                                      timeout=connect_timeout):
            pass

    try:
        policy.call(probe)
    except OSError as exc:
        raise CoordinatorUnreachable(
            f"multihost coordinator {coordinator} unreachable after "
            f"{policy.total_attempts} attempts "
            f"(last error: {exc!r}); is process 0 up?") from exc


def multihost(coordinator: str, num_processes: int, process_id: int,
              connect_policy: Optional[RetryPolicy] = None,
              initialization_timeout: Optional[int] = None,
              device: str = "cuda") -> None:
    """Join a multi-process data-parallel job: every process is a peer
    and ``process_id`` its rank; rank 0 hosts the rendezvous store at
    ``coordinator`` (``host:port``).  Call before the workflow is built.

    Ranks other than 0 first wait for the coordinator's port under a
    bounded :class:`RetryPolicy` (``connect_policy``, default
    ``DEFAULT_CONNECT_RETRY``).  Then ``dist.init_process_group`` at
    ``tcp://{coordinator}``: NCCL on ``cuda`` (the device becomes
    ``cuda:<local rank>``: ``$LOCAL_RANK``, else the rank modulo the
    cards this host has), gloo on ``cpu`` (and ``numpy``).  There is no
    fallback from one backend to the other.  ``initialization_timeout``
    (seconds) bounds the rendezvous."""
    import torch
    import torch.distributed as dist

    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process_id {process_id} is not a rank of "
                         f"{num_processes} processes")
    if process_id != 0:
        wait_for_coordinator(coordinator, connect_policy)
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(
            seconds=int(initialization_timeout))
    if device in ("cpu", "numpy"):
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "multihost on cuda: torch.cuda.is_available() is False; "
                "pass device='cpu' (CLI: -d cpu) for a gloo world")
        local = int(os.environ.get(
            "LOCAL_RANK", int(process_id) % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)


def resume(workflow, path: str) -> dict:
    """``restore_state(workflow, path)``, then let a finished run go on.
    A snapshot taken where ``max_epochs`` ended the run restores the
    Decision's ``complete`` set; resumed into a workflow whose
    ``max_epochs`` is larger than the snapshot's epoch (``-w snap -o
    ...max_epochs=M``), ``complete`` is cleared and the Decision's own
    rules judge again at the next epoch end.  (The reference keeps the
    saved flag, so its resumed run stops after one minibatch.)  Returns
    the snapshot's metadata."""
    meta = restore_state(workflow, path)
    decision = getattr(workflow, "decision", None)
    limit = getattr(decision, "max_epochs", None)
    if decision is not None and bool(decision.complete) and \
            limit is not None and \
            int(meta["loader"]["epoch_number"]) < limit:
        decision.complete.set(False)
    return meta


class Launcher(Logger):
    """Boot and own one workflow run (reference: veles/launcher.py)."""

    def __init__(self, device: Optional[Device] = None,
                 snapshot: Optional[str] = None,
                 stealth: bool = False,
                 profile_dir: Optional[str] = None,
                 manhole_path: Optional[str] = None) -> None:
        super().__init__()
        self.device = device
        self.snapshot = snapshot
        #: the profiler trace's directory (None: no trace)
        self.profile_dir = profile_dir
        #: when set, serve a live REPL into the running workflow on an
        #: AF_UNIX socket ("" = auto private path) — reference's manhole
        self.manhole_path = manhole_path
        self.manhole = None
        self.workflow = None
        #: seconds ``resume`` took in ``main`` (None: no snapshot)
        self.restore_seconds: Optional[float] = None
        self._interrupted = False
        #: set by SIGTERM: the run stops at the next epoch end
        self._terminated = Bool(False)

    # -- the load/main pair handed to sample modules ------------------------
    def load(self, builder, **kwargs):
        """Reference ``load`` contract: build the workflow (module-supplied
        builder + kwargs), remember it, return (workflow, from_snapshot)."""
        self.workflow = builder(**kwargs)
        return self.workflow, self.snapshot is not None

    def main(self, **_ignored):
        """Reference ``main`` contract: initialize, resume, run, stop."""
        if self.workflow is None:
            raise RuntimeError("load() was not called before main()")
        device = self.device if self.device is not None else AutoDevice()
        self.info(f"initializing {self.workflow.name} on {device!r}")
        self.workflow.initialize(device=device)
        if self.snapshot:
            t0 = time.perf_counter()
            meta = resume(self.workflow, self.snapshot)
            self.restore_seconds = time.perf_counter() - t0
            self.info(f"resumed from {self.snapshot} "
                      f"(epoch {meta['loader']['epoch_number']}, "
                      f"{self.restore_seconds:.3f} s)")
        if self.manhole_path is not None:
            # explicitly opt-in, so it is served even under --stealth
            from znicz_tpu_torch.core.config import root
            from znicz_tpu_torch.utils.manhole import Manhole
            self.manhole = Manhole(
                namespace={"wf": self.workflow, "launcher": self,
                           "root": root},
                path=self.manhole_path)
            self.manhole.start()
        decision = getattr(self.workflow, "decision", None)
        end_point = self.workflow.end_point
        gate = end_point.gate_block
        if decision is not None:
            # SIGTERM opens the end point at the next epoch end, without
            # marking the run complete: the final snapshot resumes it
            end_point.gate_block = gate & ~(self._terminated &
                                            decision.epoch_ended)
        prev = None
        prev_term = None
        profiler = None
        try:
            prev = signal.signal(signal.SIGINT, self._on_sigint)
            # SIGTERM: finish the current epoch, publish a final
            # snapshot, exit 143 — the graceful half of kill-and-resume
            prev_term = signal.signal(signal.SIGTERM, self._on_sigterm)
            if self.profile_dir:
                profiler = self._start_profiler(device)
            self.workflow.run()
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)
            if self.manhole is not None:
                self.manhole.stop()
            if prev is not None:
                signal.signal(signal.SIGINT, prev)
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            end_point.gate_block = gate
            self.workflow.stop()
        self.info("timing:\n" + self.workflow.timing_table())
        if self._terminated:
            # snapshot-then-exit: the run stopped at an epoch boundary
            # (the snapshotter's granularity), so a final export is a
            # legitimate resume point; then exit with 128+SIGTERM so a
            # supervisor can tell "terminated as asked" (143) from
            # "completed" (0).  Every rank exports (the state's gather is
            # a collective); only the elected writer (rank 0) writes.
            snapshotter = getattr(self.workflow, "snapshotter", None)
            if snapshotter is not None and \
                    getattr(snapshotter, "target_workflow", None) is not None:
                try:
                    snapshotter.export()
                    if process_rank_world()[0] == 0:
                        self.info(f"SIGTERM: final snapshot -> "
                                  f"{snapshotter.destination}")
                except Exception as exc:  # noqa: BLE001 — exit anyway
                    self.warning(f"SIGTERM: final snapshot failed: "
                                 f"{exc!r}")
            sys.exit(143)
        return self.workflow

    def _start_profiler(self, device):
        """``torch.profiler.profile`` over CPU activity, plus CUDA
        activity when the workflow runs on the card, started."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        dev = getattr(device, "torch_device", None)
        if (dev is None and torch.cuda.is_initialized()) or \
                (dev is not None and dev.type == "cuda"):
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Stop ``profiler``, write its Chrome trace under a new run
        directory of ``profile_dir`` and log the top-15 table; a
        failure is logged, never raised (cleanup goes on)."""
        try:
            profiler.__exit__(None, None, None)
            run_dir = os.path.join(self.profile_dir,
                                   time.strftime("%Y_%m_%d_%H_%M_%S"))
            os.makedirs(run_dir, exist_ok=True)
            path = os.path.join(run_dir, f"{socket.gethostname()}."
                                         f"{os.getpid()}.pt.trace.json")
            profiler.export_chrome_trace(path)
            self.info(f"profiler trace -> {path}")
        except Exception as exc:  # noqa: BLE001
            self.warning(f"profiler trace failed: {exc!r}")
            return
        # the trace is on disk either way — a summary failure must not
        # read as a broken trace
        try:
            from znicz_tpu_torch.utils.profiling import (format_summary,
                                                         summarize_trace)
            self.info("top ops by device time:\n" + format_summary(
                summarize_trace(self.profile_dir, top=15)))
        except Exception as exc:  # noqa: BLE001
            self.warning(f"trace summary unavailable: {exc!r}")

    def _on_sigterm(self, signum, frame):
        # finish the epoch (the end point opens at the next epoch end,
        # where the snapshotter publishes), then main() exports a final
        # snapshot and exits 143 instead of returning
        self._terminated.set(True)
        self.warning("SIGTERM: finishing current epoch, then "
                     "snapshot-and-exit(143)")

    def _on_sigint(self, signum, frame):
        # flip the decision's complete gate so the loop exits at the next
        # epoch boundary check; a second ^C raises at once
        if self._interrupted:
            raise KeyboardInterrupt
        self._interrupted = True
        self.warning("SIGINT: finishing current minibatch, then stopping "
                     "(press again to abort)")
        if self.workflow is not None and \
                getattr(self.workflow, "decision", None) is not None:
            self.workflow.decision.complete.set(True)
