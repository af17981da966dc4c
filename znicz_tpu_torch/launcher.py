"""Launcher — the port of ``znicz_tpu/launcher.py`` (rebuild of
veles/launcher.py :: Launcher).

Owns a workflow's lifecycle: device selection, optional snapshot resume,
initialize/run/stop, the timing table.  The device is ``cuda`` unless the
caller names another (``TorchDevice("cpu")``, ``NumpyDevice()``): there
is no quiet CPU fallback.  ``stealth`` (``-s``) is accepted and does
nothing: the port has no plotters or other side services to suppress.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: the profiler trace directory and the manhole (item 14), and the
multi-process join, ``multihost`` with ``wait_for_coordinator`` (item 10).
"""

from __future__ import annotations

import signal
import sys
import time
from typing import Optional

from znicz_tpu_torch.core.backends import AutoDevice, Device
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.snapshotter import process_rank_world, restore_state


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue "
                               f"A item {item})")


def multihost(coordinator: str, num_processes: int, process_id: int,
              **_kwargs) -> None:
    """The reference's multi-process join (``--coordinator``)."""
    raise _not_ported("the multi-process join (multihost, --coordinator)",
                      "10")


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
        if profile_dir is not None:
            raise _not_ported("the profiler trace (profile_dir, --profile)",
                              "14")
        if manhole_path is not None:
            raise _not_ported("the manhole (manhole_path, --manhole)", "14")
        self.device = device
        self.snapshot = snapshot
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
        try:
            prev = signal.signal(signal.SIGINT, self._on_sigint)
            # SIGTERM: finish the current epoch, publish a final
            # snapshot, exit 143 — the graceful half of kill-and-resume
            prev_term = signal.signal(signal.SIGTERM, self._on_sigterm)
            self.workflow.run()
        finally:
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
            # "completed" (0).  Only the elected writer (rank 0) exports.
            snapshotter = getattr(self.workflow, "snapshotter", None)
            if snapshotter is not None and \
                    process_rank_world()[0] == 0 and \
                    getattr(snapshotter, "target_workflow", None) is not None:
                try:
                    snapshotter.export()
                    self.info(f"SIGTERM: final snapshot -> "
                              f"{snapshotter.destination}")
                except Exception as exc:  # noqa: BLE001 — exit anyway
                    self.warning(f"SIGTERM: final snapshot failed: "
                                 f"{exc!r}")
            sys.exit(143)
        return self.workflow

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
