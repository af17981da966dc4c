"""The fused train step's optimizer updates, SGD with momentum and AdamW,
as hand-written Hopper kernels (``csrc/optim.cu``).

Replaces ``znicz_tpu/ops/pallas/_elementwise.py:81 tiled_update`` with
the bodies of ``ops/pallas/sgd.py`` (``fused_sgd_update``, ``:31``) and
``ops/pallas/adam.py`` (``fused_adam_update``, ``:37``):

- :func:`sgd_update_` ``(w, grad, vel, lr, wd, l1, mom, bs)``: in place,
  ``g = grad/bs + wd·((1-l1)·w + l1·sign w)``, ``vel = mom·vel + lr·g``,
  ``w -= vel``; ``vel`` may be stored in bf16 (f32 math, one rounded
  store);
- :func:`adam_update_multi_` ``(leaves, b1, b2, eps, bs)``: in place
  AdamW on every leaf ``(w, grad, m, v, lr, wd, c1, c2)`` of ``leaves``,
  with the bias corrections ``c1 = 1 - b1^t`` and ``c2 = 1 - b2^t`` made
  by the caller, outside the kernel, as the reference makes them
  (``adam.py:43-45``); the fused step computes them on the device once
  per layer from its step count, and updates all its leaves in one call;
- :func:`adam_update_` ``(w, grad, m, v, lr, wd, b1, b2, eps, c1, c2,
  bs)``: the same on one leaf.

On CUDA tensors every scalar is a 0-d (or one-element) float32 tensor on
the same device — the counterpart of the TPU kernel's SMEM pack — so a
step's batch size (a device value) and an LR schedule's values reach the
kernel with no host sync.  An SGD call updates one leaf with one launch;
an AdamW call updates up to ``ADAM_LEAVES`` leaves a launch, the leaves
read as one index space of 16-byte vectors (:func:`adam_grid` sizes its
grid; :func:`adam_cover` is its index arithmetic in Python).

The wrappers run the plain versions (:func:`sgd_update_plain`,
:func:`adam_update_plain`, the ``ops/`` formulas in torch) on CPU tensors
only; on CUDA tensors they launch the kernel or raise.  There is no
fallback for a shape the TPU's VMEM could not tile: the GPU kernel
streams any size.  ``sgd_launches`` / ``adam_launches`` count launches.
"""

from __future__ import annotations

import ctypes

import torch

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.ops import adam as adam_ops
from znicz_tpu_torch.ops import sgd as sgd_ops

#: kernel launches since import (or since a caller reset them to 0)
sgd_launches = 0
adam_launches = 0

#: the TPU kernel these replace (one pallas_call site serves both)
REPLACES = "znicz_tpu/ops/pallas/_elementwise.py:81"
SOURCE = "znicz_tpu_torch/csrc/optim.cu"

#: H100 SXM data-sheet peaks: HBM bytes/s; f32 flop/s of the CUDA cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

#: leaves an AdamW launch takes (kAdamLeaves in the source: its table is
#: a kernel parameter, under 4 KB); threads a block, 16-byte vectors of
#: each operand a thread loads before its math, and the most waves of
#: resident blocks in its grid (kThreads, kUnroll, kAdamWaves)
ADAM_LEAVES = 32
ADAM_THREADS, ADAM_UNROLL, ADAM_WAVES = 256, 2, 4

_VEL_CODES = {torch.bfloat16: 0, torch.float32: 1}
_lib = None


def sgd_update_plain(w, grad, vel, lr, wd, l1, mom, bs):
    """The plain PyTorch SGD step (``ops/sgd.py update``), written back
    into ``w`` and ``vel`` -> ``(w, vel)``."""
    with torch.no_grad():
        w_new, vel_new = sgd_ops.update(torch, w, grad, vel, lr, wd, l1,
                                        mom, bs)
        w.copy_(w_new)
        vel.copy_(vel_new)
    return w, vel


def adam_update_plain(w, grad, m, v, lr, wd, b1, b2, eps, c1, c2, bs):
    """The plain PyTorch AdamW step (``ops/adam.py corrected_update``),
    written back into ``w``, ``m``, ``v`` -> ``(w, m, v)``."""
    with torch.no_grad():
        outs = adam_ops.corrected_update(torch, w, grad, m, v, lr, wd, b1,
                                         b2, eps, c1, c2, bs)
        for x, new in zip((w, m, v), outs):
            x.copy_(new)
    return w, m, v


def adam_spaces(leaves) -> tuple:
    """``(vecs, tails, vec0, tail0)`` of an AdamW launch over ``leaves``,
    ``(n, aligned)`` pairs, as the source builds its table: a leaf gives
    ``n // 4`` 16-byte vectors where its operands are all 16-byte
    aligned (else none), and its other elements to the scalar space;
    ``vec0``/``tail0`` are each leaf's first index in the two spaces."""
    vecs = tails = 0
    vec0, tail0 = [], []
    for n, aligned in leaves:
        vec0.append(vecs)
        tail0.append(tails)
        v = int(n) // 4 if aligned else 0
        vecs += v
        tails += int(n) - 4 * v
    return vecs, tails, vec0, tail0


def adam_grid(vecs: int, tails: int, blocks_per_sm: int,
              sms: int = 132) -> int:
    """Blocks of an AdamW launch (``adam_grid`` in the source):
    ``ADAM_WAVES`` waves of ``blocks_per_sm`` x ``sms``, or one block a
    chunk of ``ADAM_UNROLL`` x ``ADAM_THREADS`` vectors where there are
    fewer, and at least the blocks the scalars need."""
    chunks = -(-int(vecs) // (ADAM_UNROLL * ADAM_THREADS))
    want = max(chunks, -(-int(tails) // ADAM_THREADS), 1)
    return min(want, ADAM_WAVES * int(blocks_per_sm) * int(sms))


def adam_cover(leaves, blocks: int):
    """The source's index arithmetic at ``blocks`` blocks over
    ``leaves`` (``(n, aligned)`` pairs): yields ``(leaf, element)`` for
    every element each thread updates, vectors first (chunks of
    ``ADAM_UNROLL`` x ``ADAM_THREADS`` vectors, block b taking chunks b,
    b + blocks, ...), then the scalars the grid strides over."""
    vecs, tails, vec0, tail0 = adam_spaces(leaves)
    count = len(vec0)
    chunk = ADAM_UNROLL * ADAM_THREADS
    for b in range(blocks):
        for t in range(ADAM_THREADS):
            leaf = 0
            for base in range(b * chunk + t, vecs, blocks * chunk):
                for u in range(ADAM_UNROLL):
                    j = base + u * ADAM_THREADS
                    while leaf + 1 < count and j >= vec0[leaf + 1]:
                        leaf += 1
                    if j < vecs:
                        at = j - vec0[leaf]
                        yield from ((leaf, 4 * at + e) for e in range(4))
    for first in range(blocks * ADAM_THREADS):
        leaf = 0
        for s in range(first, tails, blocks * ADAM_THREADS):
            while leaf + 1 < count and s >= tail0[leaf + 1]:
                leaf += 1
            n_vec = (vec0[leaf + 1] if leaf + 1 < count else vecs) - \
                vec0[leaf]
            yield leaf, 4 * n_vec + s - tail0[leaf]


def _bound(leaves, bytes_per_param: int, flops_per_param: int) -> dict:
    """Bytes and flops over the HBM rate and the f32 peak for one step
    over ``leaves`` (tensors or shapes)."""
    n = sum(torch.Size(getattr(x, "shape", x)).numel() for x in leaves)
    flops_ms = flops_per_param * n / F32_FLOPS * 1e3
    bytes_ms = bytes_per_param * n / HBM_BYTES_PER_S * 1e3
    return {"flops": flops_per_param * n, "bytes": bytes_per_param * n,
            "bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes"}


def sgd_bound(leaves, vel_dtype=torch.float32) -> dict:
    """The least time for one SGD step over ``leaves``: w read and
    written, grad read, vel read and written in its storage dtype (16
    bytes a parameter with bf16 velocity, 20 with f32); 11 flops a
    parameter."""
    vel_bytes = torch.empty((), dtype=vel_dtype).element_size()
    return _bound(leaves, 12 + 2 * vel_bytes, 11)


def adam_bound(leaves) -> dict:
    """The same for AdamW: w, m, v read and written, grad read (28 bytes
    a parameter); 16 flops a parameter."""
    return _bound(leaves, 28, 16)


def _check(w, **others) -> None:
    """w f32 contiguous on cpu or cuda; the others its shape, device and
    contiguity (their dtypes are checked by the callers)."""
    if w.dtype != torch.float32:
        raise ValueError(f"w must be float32, not {w.dtype}")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the update kernels run on cpu or cuda tensors, "
                         f"not {w.device.type}")
    for name, x in (("w", w),) + tuple(others.items()):
        if x.shape != w.shape:
            raise ValueError(f"{name} {tuple(x.shape)} differs from w "
                             f"{tuple(w.shape)}")
        if x.device != w.device:
            raise ValueError(f"{name} is on {x.device}, w on {w.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (updated in place)")
    if w.numel() < 1:
        raise ValueError("empty parameter leaf")


def _scalar_ptrs(device, **scalars):
    """Device pointers of the scalars (0-d or one-element f32 tensors on
    ``device``) as the ctypes array the kernels take."""
    ptrs = []
    for name, s in scalars.items():
        if not (isinstance(s, torch.Tensor) and s.dtype == torch.float32
                and s.device == device and s.numel() == 1):
            raise ValueError(
                f"{name} must be a one-element float32 tensor on {device} "
                f"(the kernel reads its scalars from device memory); got "
                f"{s!r}")
        ptrs.append(s.data_ptr())
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("optim")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.znicz_sgd_update.argtypes = [i32, ptr, ptr, ptr, i64, ptr, ptr]
        lib.znicz_sgd_update.restype = i32
        lib.znicz_adam_update_multi.argtypes = [i32, ptr, ptr, ptr, ptr,
                                                ptr]
        lib.znicz_adam_update_multi.restype = i32
        lib.znicz_adam_grid.argtypes = [i64, i64]
        lib.znicz_adam_grid.restype = i64
        lib.znicz_adam_residency.argtypes = []
        lib.znicz_adam_residency.restype = i32
        lib.znicz_optim_error_string.argtypes = [i32]
        lib.znicz_optim_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().znicz_optim_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def sgd_update_(w, grad, vel, lr, wd, l1, mom, bs):
    """One in-place SGD step on a leaf -> ``(w, vel)``: the plain
    version on CPU tensors, the kernel on CUDA tensors (on the current
    stream).  ``grad`` is f32; ``vel`` f32 or bf16."""
    global sgd_launches
    _check(w, grad=grad, vel=vel)
    if grad.dtype != torch.float32:
        raise ValueError(f"grad must be float32, not {grad.dtype}")
    if vel.dtype not in _VEL_CODES:
        raise ValueError(f"vel must be float32 or bfloat16, not {vel.dtype}")
    if w.device.type == "cpu":
        return sgd_update_plain(w, grad, vel, lr, wd, l1, mom, bs)
    hyper = _scalar_ptrs(w.device, lr=lr, wd=wd, l1=l1, mom=mom, bs=bs)
    rc = _library().znicz_sgd_update(
        _VEL_CODES[vel.dtype], w.data_ptr(), grad.data_ptr(), vel.data_ptr(),
        w.numel(), hyper, torch.cuda.current_stream(w.device).cuda_stream)
    _raise_on(rc, "sgd_update_")
    sgd_launches += 1
    return w, vel


def adam_update_multi_(leaves, b1, b2, eps, bs) -> None:
    """One in-place AdamW step on every leaf ``(w, grad, m, v, lr, wd,
    c1, c2)`` of ``leaves`` (all f32, distinct ``w``, one device), with
    each leaf's bias corrections ``c1``, ``c2`` given and ``b1``, ``b2``,
    ``eps`` and ``bs`` shared.  The plain version leaf by leaf on CPU
    tensors; on CUDA tensors one launch for every ``ADAM_LEAVES`` leaves
    (on the current stream)."""
    global adam_launches
    leaves = [tuple(leaf) for leaf in leaves]
    if not leaves:
        raise ValueError("no leaves to update")
    device = leaves[0][0].device
    for w, grad, m, v, *_ in leaves:
        _check(w, grad=grad, m=m, v=v)
        if w.device != device:
            raise ValueError(f"leaves on {w.device} and {device}")
        for name, x in (("grad", grad), ("m", m), ("v", v)):
            if x.dtype != torch.float32:
                raise ValueError(f"{name} must be float32, not {x.dtype}")
    if len({leaf[0].data_ptr() for leaf in leaves}) != len(leaves):
        raise ValueError("a leaf appears twice (its updates would race)")
    if device.type == "cpu":
        for w, grad, m, v, lr, wd, c1, c2 in leaves:
            adam_update_plain(w, grad, m, v, lr, wd, b1, b2, eps, c1, c2, bs)
        return
    shared = _scalar_ptrs(device, b1=b1, b2=b2, eps=eps, bs=bs)
    stream = torch.cuda.current_stream(device).cuda_stream
    for first in range(0, len(leaves), ADAM_LEAVES):
        group = leaves[first:first + ADAM_LEAVES]
        ops = [t.data_ptr() for leaf in group for t in leaf[:4]]
        hyper = [p for w, _, _, _, lr, wd, c1, c2 in group
                 for p in _scalar_ptrs(device, lr=lr, wd=wd, c1=c1, c2=c2)]
        rc = _library().znicz_adam_update_multi(
            len(group), (ctypes.c_void_p * len(ops))(*ops),
            (ctypes.c_longlong * len(group))(*(leaf[0].numel()
                                               for leaf in group)),
            (ctypes.c_void_p * len(hyper))(*hyper), shared, stream)
        _raise_on(rc, "adam_update_multi_")
        adam_launches += 1


def adam_update_(w, grad, m, v, lr, wd, b1, b2, eps, c1, c2, bs):
    """One in-place AdamW step on a leaf -> ``(w, m, v)``, all f32,
    with the bias corrections ``c1``, ``c2`` given: the one-leaf case of
    :func:`adam_update_multi_`."""
    adam_update_multi_([(w, grad, m, v, lr, wd, c1, c2)], b1, b2, eps, bs)
    return w, m, v


def adam_grid_on_card(vecs: int, tails: int) -> dict:
    """The AdamW launch's grid on this card (the source's ``adam_grid``
    at the occupancy calculator's residency) and that residency."""
    lib = _library()
    return {"blocks": int(lib.znicz_adam_grid(vecs, tails)),
            "blocks_per_sm": int(lib.znicz_adam_residency())}
