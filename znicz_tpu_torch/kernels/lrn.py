"""Local response normalization forward and backward as hand-written
Hopper kernels (``csrc/lrn.cu``).

Replaces ``znicz_tpu/ops/pallas/lrn.py`` ``lrn_forward`` (``:65``) and
``lrn_backward`` (``:79``): the cross-channel window over the last axis
of ``x`` (NHWC flattened to (rows, C)), ``half = n // 2`` channels below
and ``n - 1 - half`` above, ``d = k + alpha · Σ x²``, ``y = x · d^-β``,
and the exact adjoint for the backward.  ``d^-β`` is ``sqrt(sqrt(d)) / d``
exactly when ``β == 0.75``, as ``ops/lrn.py`` computes it.

The plain versions are ``ops/lrn.py forward`` / ``backward`` in torch,
whose arithmetic (order included) the kernels repeat.  The wrappers run
them on CPU tensors only; on CUDA tensors they launch the kernels or
raise.  ``fwd_launches`` / ``bwd_launches`` count kernel launches and
nothing else.  Importing this module needs no ``nvcc``: the library is
built at the first CUDA call.

Each direction takes one of two paths, :func:`lrn_plan` its Python twin
of ``csrc/lrn.cu``'s choice: four channels a thread (float4 loads and
stores, whole rows a block) where ``c % 4 == 0``, ``c <= 4096`` and
every pointer lies on 16 bytes, else one element a thread.

:class:`lrn` is the differentiable form the fused step composes: its
forward launches :func:`lrn_forward`, its backward :func:`lrn_backward`
(which recomputes d from x), and it saves x only, as the reference's
``jax.checkpoint`` around its jnp LRN keeps only the input.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.kernels.gemm import _bound_of
from znicz_tpu_torch.ops import lrn as lrn_ops

#: kernel launches since import (or since a caller reset them to 0)
fwd_launches = 0
bwd_launches = 0

#: the TPU kernels these replace
REPLACES_FWD = "znicz_tpu/ops/pallas/lrn.py:65"
REPLACES_BWD = "znicz_tpu/ops/pallas/lrn.py:79"
SOURCE = "znicz_tpu_torch/csrc/lrn.cu"

#: the quad path's block target, its widest row (in quads), and the
#: element path's block and tile (``csrc/lrn.cu``)
QUAD_THREADS, MAX_QUADS, ELEM_THREADS, ELEM_TILE = 256, 1024, 256, 2048

_lib = None


def lrn_forward_plain(x, alpha: float, beta: float, k: float, n: int):
    return lrn_ops.forward(torch, x, alpha, beta, k, n)


def lrn_backward_plain(x, err_output, alpha: float, beta: float, k: float,
                       n: int):
    return lrn_ops.backward(torch, x, err_output, alpha, beta, k, n)


def bound(x_shape, n: int, backward: bool = False) -> dict:
    """The least time the card could take: x (and the cotangent) read once
    and the output written once over the HBM rate, against the flops of
    the window sums and the power (2n + 6 an element forward, 3n + 12
    backward) over the f32 peak."""
    elems = int(np.prod(x_shape))
    if backward:
        return _bound_of((3 * n + 12) * elems, 12 * elems)
    return _bound_of((2 * n + 6) * elems, 8 * elems)


def lrn_plan(rows: int, c: int, n: int, beta: float = 0.75,
             aligned: bool = True, backward: bool = True) -> dict:
    """The launch of one direction at (rows, c), as ``quad_plan`` in
    ``csrc/lrn.cu`` chooses it: ``path`` ("quad" or "element"),
    ``rows_per_block``, ``threads`` (x, y), ``smem_bytes`` and, on the
    quad path, ``n_fixed``: 5 for AlexNet's window at beta 0.75 (the
    unrolled instantiation), else 0 (n at run time).  ``aligned``: every
    pointer lies on 16 bytes (:func:`aligned16`).  The forward stages x
    (one row of floats a block row), the backward x and t on the quad
    path and x, d^-beta and t on the element path."""
    if c % 4 == 0 and aligned and c // 4 <= MAX_QUADS:
        tx = c // 4
        ty = 1 if tx >= QUAD_THREADS else QUAD_THREADS // tx
        return {"path": "quad", "rows_per_block": ty, "threads": (tx, ty),
                "smem_bytes": (2 if backward else 1) * ty * c * 4,
                "n_fixed": 5 if n == 5 and beta == 0.75 else 0}
    per = 1 if c >= ELEM_TILE else ELEM_TILE // c
    return {"path": "element", "rows_per_block": per,
            "threads": (ELEM_THREADS, 1),
            "smem_bytes": (3 if backward else 1) * per * c * 4,
            "n_fixed": 0}


def aligned16(*tensors) -> bool:
    """Whether every tensor's data starts on 16 bytes (the quad path's
    float4 accesses)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def lrn_plan_on_card(rows: int, c: int, n: int, beta: float = 0.75,
                     aligned: bool = True, backward: bool = True) -> dict:
    """``znicz_lrn_plan`` from ``csrc/lrn.cu`` in :func:`lrn_plan`'s
    terms, for the smoke to hold one against the other."""
    out = (ctypes.c_int * 6)()
    rc = _library().znicz_lrn_plan(
        rows, c, n, int(beta == 0.75), int(aligned), int(backward),
        ctypes.cast(out, ctypes.c_void_p))
    _raise_on(rc, "lrn_plan")
    quad, per, tx, ty, smem, n_fixed = list(out)
    return {"path": "quad" if quad else "element", "rows_per_block": per,
            "threads": (tx, ty), "smem_bytes": smem, "n_fixed": n_fixed}


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("lrn")
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        lib.znicz_lrn_forward_f32.argtypes = [ptr, ptr, i64, i32, i32, f32,
                                              f32, i32, f32, ptr]
        lib.znicz_lrn_backward_f32.argtypes = [ptr, ptr, ptr, i64, i32, i32,
                                               f32, f32, i32, f32, f32, ptr]
        lib.znicz_lrn_plan.argtypes = [i64, i32, i32, i32, i32, i32, ptr]
        for fn in (lib.znicz_lrn_forward_f32, lib.znicz_lrn_backward_f32,
                   lib.znicz_lrn_plan):
            fn.restype = i32
        lib.znicz_lrn_error_string.argtypes = [i32]
        lib.znicz_lrn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(n: int, **tensors) -> None:
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (the kernels are "
                             f"f32), not {t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does "
                             f"not match {tuple(first.shape)} on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if first.dim() < 1 or first.numel() < 1 or int(n) < 1:
        raise ValueError(f"need a non-empty x and n >= 1; got "
                         f"{tuple(first.shape)}, n {n}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the LRN kernels run on cpu or cuda tensors, not "
                         f"{first.device.type}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().znicz_lrn_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def lrn_forward(x, alpha: float, beta: float, k: float, n: int):
    """LRN over the last axis of ``x`` -> a new tensor of its shape: the
    plain version on CPU tensors, the kernel on CUDA tensors (on the
    current stream)."""
    global fwd_launches
    _check(n, x=x)
    if x.device.type == "cpu":
        return lrn_forward_plain(x, alpha, beta, k, n)
    y = torch.empty_like(x)
    c = x.shape[-1]
    rc = _library().znicz_lrn_forward_f32(
        x.data_ptr(), y.data_ptr(), x.numel() // c, c, int(n), float(alpha),
        float(beta), int(beta == 0.75), float(k),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "lrn_forward")
    fwd_launches += 1
    return y


def lrn_backward(x, err_output, alpha: float, beta: float, k: float,
                 n: int):
    """The input gradient of the cotangent ``err_output`` through LRN at
    ``x``: the plain version on CPU tensors, the kernel on CUDA tensors."""
    global bwd_launches
    _check(n, x=x, err_output=err_output)
    if x.device.type == "cpu":
        return lrn_backward_plain(x, err_output, alpha, beta, k, n)
    out = torch.empty_like(x)
    c = x.shape[-1]
    rc = _library().znicz_lrn_backward_f32(
        x.data_ptr(), err_output.data_ptr(), out.data_ptr(), x.numel() // c,
        c, int(n), float(alpha), float(beta), int(beta == 0.75), float(k),
        float(2.0 * alpha * beta),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "lrn_backward")
    bwd_launches += 1
    return out


class lrn(torch.autograd.Function):
    """LRN over the last axis of an f32 ``x`` with its exact adjoint,
    both on the kernels (their plain versions on CPU tensors).  Saves x
    only: the backward recomputes d from it."""

    @staticmethod
    def forward(ctx, x, alpha: float, beta: float, k: float, n: int):
        x = x.contiguous()
        ctx.save_for_backward(x)
        ctx.args = (alpha, beta, k, n)
        return lrn_forward(x, alpha, beta, k, n)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return (lrn_backward(x, grad.contiguous(), *ctx.args), None, None,
                None, None)
