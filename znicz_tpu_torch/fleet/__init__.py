"""Serving fleet — the port of ``znicz_tpu/fleet/``: front-end router,
SLO-driven autoscaler and zero-downtime rolling weight updates, composed
from planes the port already has (elastic process supervision,
drainable serving workers, fleet telemetry) into one production
topology: VELES's master–slave serving in the master/worker shape.

``python -m znicz_tpu_torch fleet <package.npz> --workers N`` boots the
whole thing; every worker is an ordinary ``python -m znicz_tpu_torch
generate --serve`` (or ``serve``) process, on the card unless its
arguments (``-- --device cpu``) say otherwise.
"""

from znicz_tpu_torch.fleet.autoscale import Autoscaler
from znicz_tpu_torch.fleet.rollout import RollingUpdate, RolloutError
from znicz_tpu_torch.fleet.router import (ROUTER_RANK, FleetRouter,
                                          NoReadyWorker)
from znicz_tpu_torch.fleet.workers import FleetWorker, WorkerPool

__all__ = ["Autoscaler", "FleetRouter", "FleetWorker", "NoReadyWorker",
           "ROUTER_RANK", "RollingUpdate", "RolloutError", "WorkerPool"]
