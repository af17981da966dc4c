"""AcceleratedUnit — per-backend dispatch; the port of
``znicz_tpu/core/accelerated_units.py`` (rebuild of
veles/accelerated_units.py :: AcceleratedUnit).

``initialize()`` dispatches to ``{suffix}_init`` and ``run()`` to
``{suffix}_run`` of the selected device:

- ``numpy_init``/``numpy_run`` — the pure-numpy oracle path, required;
- ``torch_init``/``torch_run`` — the device path on a ``TorchDevice``
  (the card, or the CPU in tests).  Units feed the ``devmem`` of their
  input Arrays to torch code or to the port's kernels and store outputs
  with ``set_devmem``.  The default ``torch_run`` falls back to the numpy
  oracle through host memory, exactly where the reference's default
  ``xla_run`` does.

The training hot loop fuses the segment into one step instead
(``parallel/step.py``).  ``DeviceBenchmark`` is not ported yet (ROADMAP
queue A).
"""

from __future__ import annotations

from typing import Optional

from znicz_tpu_torch.core.backends import Device, NumpyDevice
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.core.workflow import Workflow


class AcceleratedUnit(Unit):
    """A Unit whose work runs on the selected backend."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.device: Optional[Device] = None
        #: true (unpadded) minibatch row count, usually data-linked to the
        #: loader; see current_batch_size()
        self.batch_size = None

    # -- dispatch -----------------------------------------------------------
    @property
    def backend_suffix(self) -> str:
        return self.device.suffix if self.device is not None else "numpy"

    def initialize(self, device=None, **kwargs) -> None:
        self.device = device if isinstance(device, Device) else NumpyDevice()
        self._common_init(**kwargs)
        getattr(self, f"{self.backend_suffix}_init", self.numpy_init)()
        self.initialized = True

    def run(self) -> None:
        getattr(self, f"{self.backend_suffix}_run", self.numpy_run)()

    # -- override points ----------------------------------------------------
    def _common_init(self, **kwargs) -> None:
        """Backend-independent setup: shapes, Array allocation."""

    def numpy_init(self) -> None:
        pass

    def numpy_run(self) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} must implement numpy_run")

    def torch_init(self) -> None:
        pass

    def torch_run(self) -> None:
        # default: oracle fallback through host memory — correct everywhere,
        # overridden by every unit with a device-side compute path
        self.numpy_run()

    # -- helpers ------------------------------------------------------------
    def init_array(self, *arrays: Array) -> None:
        for arr in arrays:
            arr.initialize(self.device)

    def current_batch_size(self, fallback: Optional[Array] = None) -> int:
        """True (unpadded) minibatch size: the data-linked ``batch_size``
        when wired, else the row count of ``fallback``; never 0."""
        bs = self.batch_size
        if bs is None and fallback is not None:
            bs = len(fallback)
        return max(int(bs or 0), 1)


class AcceleratedWorkflow(Workflow):
    """Workflow whose initialize injects a Device into accelerated children
    (reference: veles/accelerated_units.py :: AcceleratedWorkflow)."""
