"""Device backends of the port — the counterpart of
``znicz_tpu/core/backends.py`` (rebuild of veles/backends.py).

- :func:`resolve_compute_dtype` is the framework-wide precision policy
  and :func:`device` resolves a device name, refusing a CUDA device that
  is not there.  Entry points default to ``cuda``; the CPU is used only
  when the caller names it.
- ``TorchDevice`` wraps a ``torch.device`` (``cuda`` by default, the CPU
  when asked — the tests run the torch path there) with the matmul
  precision policy; it is the counterpart of the reference's
  ``TPUDevice``, which also runs on the CPU in the reference's tests.
- ``NumpyDevice`` is the pure-numpy oracle backend every accelerated
  unit also implements.
- ``AutoDevice()`` honors ``root.common.engine.backend`` ("numpy",
  "torch" or "auto"; "auto" is "torch").
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger


def resolve_compute_dtype(platform: str, precision: str | None = None):
    """THE precision policy: bf16 on an accelerator when ``precision``
    (default ``root.common.engine.precision``) is "bfloat16"; f32 on the
    CPU regardless, preserving oracle numerics.  ``platform`` is a
    ``torch.device`` type ("cuda", "cpu")."""
    precision = precision or root.common.engine.get("precision", "bfloat16")
    return torch.bfloat16 if (precision == "bfloat16"
                              and platform != "cpu") else torch.float32


def device(name: str | torch.device | None = None) -> torch.device:
    """``name`` as a ``torch.device``, ``cuda`` when None.  A CUDA device
    on a host without one raises: the port never falls back to the CPU
    on its own."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run on the "
            "CPU")
    return dev


class Device(Logger):
    """Base device."""

    #: dispatch suffix: AcceleratedUnit calls f"{suffix}_init" / f"{suffix}_run"
    suffix = "numpy"

    def __init__(self) -> None:
        super().__init__()

    @property
    def is_accelerated(self) -> bool:
        return self.suffix != "numpy"

    def __repr__(self) -> str:
        return f"<{type(self).__name__}>"


class NumpyDevice(Device):
    """Pure-numpy oracle backend (reference: veles/backends.py :: NumpyDevice)."""

    suffix = "numpy"


class TorchDevice(Device):
    """PyTorch device: ``cuda`` by default, the CPU when named.  Holds the
    ``torch.device`` this process drives and the matmul precision
    (bfloat16 on the card, float32 on the CPU; see
    :func:`resolve_compute_dtype`).  Without a card and without
    ``device="cpu"`` it raises."""

    suffix = "torch"

    def __init__(self, device: Optional[str | torch.device] = None,
                 precision: Optional[str] = None) -> None:
        super().__init__()
        self.torch_device = _resolve(device)
        self.precision = precision or root.common.engine.get("precision",
                                                             "bfloat16")
        self.platform = self.torch_device.type

    @property
    def compute_dtype(self):
        return resolve_compute_dtype(self.platform, self.precision)

    def put(self, host_array: np.ndarray) -> torch.Tensor:
        # always a private copy: callers (the Loader hot path) reuse and
        # mutate their host buffers per minibatch, and on the CPU a
        # torch.from_numpy view would alias them (the reference copies
        # for the same reason: device_put reads the source asynchronously)
        return torch.tensor(np.ascontiguousarray(host_array),
                            device=self.torch_device)

    def __repr__(self) -> str:
        return f"<TorchDevice {self.torch_device} precision={self.precision}>"


_resolve = device


def AutoDevice() -> Device:
    """Select per ``root.common.engine.backend`` (reference: AutoDevice):
    "numpy" -> NumpyDevice; "torch" or "auto" -> TorchDevice() (cuda)."""
    backend = root.common.engine.get("backend", "auto")
    if backend == "numpy":
        return NumpyDevice()
    if backend not in ("torch", "auto"):
        raise ValueError(f"engine.backend {backend!r}: the port has the "
                         f"numpy, torch and auto backends")
    return TorchDevice()
