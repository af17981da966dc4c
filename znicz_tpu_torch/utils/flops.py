"""Analytic FLOPs model for workflow forwards, the port of
``znicz_tpu/utils/flops.py``.

Counts multiply-accumulates as 2 FLOPs.  A training step is counted as
3x the forward GEMM/conv FLOPs (1 forward + 2 backward passes: the
input-gradient and the weight-gradient products) — the standard MFU
convention.  Elementwise work (activations, pooling, LRN) is bound by
memory, not by the tensor cores, and is excluded: MFU measures
matmul-unit utilisation.

The denominator: ``$ZNICZ_TPU_PEAK_FLOPS`` wins, as in the reference;
otherwise an H100 (a CUDA device whose name holds "H100") has the dense
bf16 tensor-core peak of ``kernels/gemm.py BF16_FLOPS``, its one owner.
Anything else — the CPU, another card — has no known peak (None).  The
port keeps no TPU peak table (a recorded divergence).
"""

from __future__ import annotations

import os

import numpy as np


#: explicit per-device peak override (FLOPs/s, float literal): the CPU's
#: nominal denominator, so MFU stays a live number comparable within one
#: host (and NOT across machines)
PEAK_FLOPS_ENV = "ZNICZ_TPU_PEAK_FLOPS"


def peak_flops(device=None) -> float | None:
    """Peak FLOPs/s of ``device`` (default: the current CUDA device when
    CUDA is initialized).  ``$ZNICZ_TPU_PEAK_FLOPS`` wins; an H100 gets
    ``kernels/gemm.py BF16_FLOPS``; anything else None."""
    env = os.environ.get(PEAK_FLOPS_ENV, "")
    if env:
        try:
            val = float(env)
        except ValueError:
            val = 0.0
        if val > 0.0:
            return val
    import torch

    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return None
    elif not torch.cuda.is_initialized():
        # a peak read never boots the card
        return None
    name = torch.cuda.get_device_name(device)
    if "H100" in name:
        from znicz_tpu_torch.kernels.gemm import BF16_FLOPS

        return BF16_FLOPS
    return None


def forward_flops(unit, batch: int) -> float:
    """Forward-pass matmul FLOPs of one unit for a ``batch``-row
    minibatch."""
    from znicz_tpu_torch.units.all2all import All2All
    from znicz_tpu_torch.units.conv import Conv
    from znicz_tpu_torch.units.deconv import Deconv

    if isinstance(unit, All2All):
        n_in = int(np.prod(unit.input.shape[1:]))
        n_out = int(np.prod(unit.output.shape[1:]))
        return 2.0 * batch * n_in * n_out
    if isinstance(unit, (Conv, Deconv)):
        # gather side of the GEMM: out_positions x (kx*ky*c_in) x c_out
        out_shape = unit.output.shape  # (B, H, W, C_out)
        positions = int(np.prod(out_shape[1:3]))
        c_out = int(out_shape[3])
        c_in = int(unit.input.shape[3])
        k = int(unit.kx) * int(unit.ky) * c_in
        return 2.0 * batch * positions * k * c_out
    return 0.0


def train_step_flops(forwards, batch: int) -> float:
    """Analytic matmul FLOPs of one fused train step (forward +
    backward)."""
    return 3.0 * sum(forward_flops(f, batch) for f in forwards)


def mfu(samples_per_sec: float, forwards, batch: int,
        device=None) -> float | None:
    """Model FLOPs utilisation against the device's peak."""
    peak = peak_flops(device)
    if not peak:
        return None
    step_flops = train_step_flops(forwards, batch)
    return (samples_per_sec / batch) * step_flops / peak
