"""Device policy of the port — the counterpart of
``znicz_tpu/core/backends.py``.

Only what the serving slice needs: the framework-wide precision policy
(:func:`resolve_compute_dtype`) and :func:`device`, which resolves a
device name and refuses a CUDA device that is not there.  Entry points
default to ``cuda``; the CPU is used only when the caller names it.
The Unit/Workflow ``Device`` classes come with the training slices.
"""

from __future__ import annotations

import torch

from znicz_tpu_torch.core.config import root


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
