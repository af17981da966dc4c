"""One Kohonen SOM batch step as a hand-written Hopper kernel
(``csrc/kohonen.cu``).

Replaces ``znicz_tpu/ops/pallas/kohonen.py:72 som_step``: for ``x`` (B,
D), weights ``w`` (N, D) and grid ``coords`` (N, 2), all f32,
:func:`som_step` returns ``(new_w, winner)``.  The semantics are the TPU
kernel's (``:22-58``):

- squared distances as ``|x|^2 - 2 x·wᵀ + |w|^2`` in full f32 (no TF32,
  no bf16);
- the winner of a sample is the smallest index attaining its row minimum;
- the Gaussian neighbourhood of each winner over the grid, rows at or past
  ``bs`` contributing nothing;
- ``w + alpha (num - den w) / (den + 1)``, ``num = hᵀ x``, ``den = hᵀ 1``.

:func:`som_step_plain` is the plain PyTorch version of the same
arithmetic.  The wrapper runs it on CPU tensors only; on CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches (one
per step; a step is two CUDA kernels) and nothing else.  Importing this
module needs no ``nvcc``: the library is built at the first CUDA call.
"""

from __future__ import annotations

import ctypes

import torch

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.kernels.gemm import _bound_of

#: kernel launches since import (or since a caller reset them to 0)
launches = 0

#: the TPU kernel this replaces
REPLACES = "znicz_tpu/ops/pallas/kohonen.py:72"
SOURCE = "znicz_tpu_torch/csrc/kohonen.cu"

_lib = None


def som_step_plain(x, w, coords, alpha: float, sigma: float, bs):
    """The plain PyTorch step: the TPU kernel's formulas, in f32."""
    n = w.shape[0]
    x2 = (x * x).sum(dim=1, keepdim=True)
    w2 = (w * w).sum(dim=1)
    d2 = x2 - 2.0 * (x @ w.t()) + w2
    col = torch.arange(n, device=x.device)
    idx = torch.where(d2 == d2.amin(dim=1, keepdim=True), col,
                      n).amin(dim=1)
    idx = torch.where(idx < n, idx, 0)          # an all-NaN row: 0
    wc = coords[idx]
    g2 = (wc * wc).sum(dim=1, keepdim=True) - 2.0 * (wc @ coords.t()) + \
        (coords * coords).sum(dim=1)
    sigma = torch.tensor(sigma, dtype=torch.float32)
    h = torch.exp(-g2 / (2.0 * sigma * sigma).to(x.device))
    row = torch.arange(x.shape[0], device=x.device)[:, None]
    h = torch.where(row < bs, h, 0.0)
    num = h.t() @ x
    den = h.sum(dim=0)[:, None]
    return w + alpha * (num - den * w) / (den + 1.0), idx.to(torch.int32)


def bound(x_shape, w_shape) -> dict:
    """The least time the card could take for one step: the larger of its
    flops over the f32 peak and its bytes (x, w and coords read once, the
    new weights and the winners written once) over the HBM rate.  Flops:
    the distances (2·B·N·D, |x|^2, |w|^2 and 3 a pair), the neighbourhood
    (9 a pair and the exp), the update's products (2·B·N·D + B·N) and 5
    an element of the new weights."""
    b, d = x_shape
    n = w_shape[0]
    flops = 4 * b * n * d + 2 * (b + n) * d + 13 * b * n + 5 * n * d
    nbytes = 4 * (b * d + 2 * n * d + 2 * n + b)
    return _bound_of(flops, nbytes)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("kohonen")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.znicz_som_step_f32.argtypes = [ptr] * 5 + [i32] * 4 + \
            [f32, f32, ptr]
        lib.znicz_som_step_f32.restype = i32
        lib.znicz_kohonen_error_string.argtypes = [i32]
        lib.znicz_kohonen_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, w, coords) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1] or \
            tuple(coords.shape) != (w.shape[0], 2):
        raise ValueError(f"need x (B, D), w (N, D), coords (N, 2); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(coords.shape)}")
    if min(x.shape[0], w.shape[0], x.shape[1]) < 1:
        raise ValueError("empty SOM step")
    for name, t in (("x", x), ("w", w), ("coords", coords)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (the kernel is full "
                             f"f32), not {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"som_step runs on cpu or cuda tensors, not "
                         f"{x.device.type}")
    if x.numel() >= 2 ** 31 or w.numel() >= 2 ** 31:
        raise ValueError("the kernel indexes with 32-bit ints")


def som_step(x, w, coords, alpha: float, sigma: float, bs):
    """One SOM batch step -> ``(new_w, winner)``: the plain version on CPU
    tensors, the kernel on CUDA tensors (on the current stream).  ``bs`` is
    the number of real rows (rows ``>= bs`` are padding)."""
    global launches
    _check(x, w, coords)
    bs = int(bs)
    if x.device.type == "cpu":
        return som_step_plain(x, w, coords, alpha, sigma, bs)
    new_w = torch.empty_like(w)
    winner = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    rc = _library().znicz_som_step_f32(
        x.data_ptr(), w.data_ptr(), coords.data_ptr(), new_w.data_ptr(),
        winner.data_ptr(), x.shape[0], w.shape[0], x.shape[1], bs,
        float(alpha), float(sigma),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = _library().znicz_kohonen_error_string(rc).decode()
        raise RuntimeError(f"som_step launch failed: {msg}")
    launches += 1
    return new_w, winner
