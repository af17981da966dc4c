"""Training steps of the port: the transformer trainer and the fused
Unit/Workflow train step, and the meshes they run on (one process a
device, ``torch.distributed``; ``parallel/mesh.py``)."""

from znicz_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                           make_hybrid_mesh, make_mesh)
from znicz_tpu_torch.parallel.step import FusedTrainStep

__all__ = ["make_mesh", "make_hybrid_mesh", "data_parallel_mesh",
           "FusedTrainStep"]
