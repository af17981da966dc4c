"""The FC layer's GEMM with fused bias and activation, and its
activation backward, as hand-written Hopper kernels (``csrc/gemm.cu``).

Replaces two Pallas calls of ``znicz_tpu/ops/pallas/gemm.py``:
``matmul`` (``:76``), which ``fc_forward`` (``:129``) and the two
products of ``fc_backward`` (``:137``) reach, and ``_act_backward``
(``:119``).  In float32:

- :func:`gemm_fc` ``(a, b, bias, activation)`` -> ``act(a @ b + bias)``
  for a 2-D ``a`` (M, K) and ``b`` (K, N), each contiguous or the
  transpose of a contiguous matrix: the kernel reads the stored layout
  with a transpose flag, so ``err_v @ W.T`` and ``x.T @ err_v`` read the
  (in, out) weights and (batch, in) activations as they are.  f32 sums
  on the CUDA cores, no TF32; bias and activation in the epilogue;
  ragged edges masked in the kernel, nothing padded.
  Products whose tile grid fills the card poorly split K into the
  slices :func:`gemm_plan` chooses, summed in slice order by a second
  kernel before bias and activation (:func:`gemm_split_plain` is the
  plain version of that arithmetic).
- :func:`act_backward` ``(y, err, activation, bias_grad)`` -> ``err *
  act'(y)``, the derivative from the forward output, and with
  ``bias_grad`` also ``grad_b``, its column sums, from the same launch:
  the rows split over the blocks of a thread-block cluster, the sums
  taken in a fixed order (:func:`act_bias_plan`;
  :func:`act_bias_backward_plain` sums in that order).  ``linear``
  returns ``err`` and launches nothing, as the reference does.

:func:`fc_forward` and :func:`fc_backward` compose them with the
reference's semantics (``ops/linear.py``).  The reference sums
``grad_b`` outside its kernel, where XLA fuses it into the activation
pass; here a non-linear backward takes it from act_backward's one
launch, and a linear one (no activation pass to ride) is a torch sum.

The wrappers run the plain versions (:func:`fc_forward_plain`,
:func:`act_backward_plain`, :func:`act_bias_backward_plain`) on CPU
tensors only; on CUDA tensors they
launch the kernels or raise.  ``gemm_launches`` / ``act_launches``
count kernel launches and nothing else.  Importing this module needs no
``nvcc``: the library is built at the first CUDA call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from znicz_tpu_torch.kernels import build as _build
from znicz_tpu_torch.ops import activations

#: kernel launches since import (or since a caller reset them to 0)
gemm_launches = 0
act_launches = 0

#: the TPU kernels these replace
REPLACES_GEMM = "znicz_tpu/ops/pallas/gemm.py:76"
REPLACES_ACT = "znicz_tpu/ops/pallas/gemm.py:119"
SOURCE = "znicz_tpu_torch/csrc/gemm.cu"

#: activations the kernels apply in-block (the reference's fused set),
#: in the order of csrc/gemm.cu's codes
FUSED_ACTIVATIONS = (activations.LINEAR, activations.TANH,
                     activations.RELU, activations.STRICT_RELU,
                     activations.SIGMOID)
_ACT_CODES = {a: i for i, a in enumerate(FUSED_ACTIVATIONS)}
#: the depth of the kernel's k tiles (kBK in csrc/tile_f32.cuh)
K_TILE = 16
#: the kernel's tiles (gemm_bn in csrc/gemm.cu): (BM, BN) -> resident
#: blocks an SM on the H100, the least over the tile's four operand
#: layouts, by ptxas's registers and the tile's shared memory (the smoke
#: holds this table against cudaOccupancyMaxActiveBlocksPerMultiprocessor)
GEMM_TILES = {(128, 128): 2, (128, 64): 3}
#: the split-K schedule spreads over at most this many waves
GEMM_MAX_WAVES = 4
#: act_backward's block (csrc/gemm.cu kActCols, kActLanes): column
#: threads (a 16-byte vector of 4 columns each, or one column off the
#: vector path) by row lanes; the rows split over a cluster of at most
#: ACT_MAX_RANKS blocks
ACT_COLS, ACT_LANES, ACT_MAX_RANKS = 16, 16, 8
#: the H100's SMs
SMS = 132

#: H100 SXM data-sheet peaks: HBM bytes/s; f32 flop/s of the CUDA cores;
#: dense bf16 flop/s of the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
#: flops per element of err * act'(y), counted from the formulas
_ACT_FLOPS = {activations.TANH: 5, activations.RELU: 3,
              activations.STRICT_RELU: 2, activations.SIGMOID: 3}

_lib = None


def fc_forward_plain(x, w, bias=None, activation: str = activations.LINEAR):
    """The plain PyTorch ``act(flatten(x) @ w + bias)`` — the semantics
    of ``ops/linear.py forward``."""
    v = x.reshape(x.shape[0], -1) @ w
    if bias is not None:
        v = v + bias
    return activations.forward(torch, activation, v)


def act_backward_plain(y, err, activation: str):
    """The plain PyTorch ``err * act'(y)``."""
    return activations.backward(torch, activation, y, err)


def act_bias_plan(m: int, n: int, vec: int = 4) -> dict:
    """act_backward's launch for an (m, n) ``err_v`` at vector width
    ``vec`` (4 where n % 4 == 0 and every pointer is 16-byte aligned,
    else 1), which the wrapper hands to csrc/gemm.cu: ``tiles`` blocks
    of ``ACT_COLS * vec`` columns across, and the rows split over
    ``ranks`` blocks of one cluster, ``rows_per_lane`` rows to each of a
    block's ``ACT_LANES`` lanes.  ``ranks`` is the fewest (a power of two
    up to ``ACT_MAX_RANKS``) whose grid covers the SMs once, and no more
    than give every block a lane's worth of rows."""
    tiles = math.ceil(n / (ACT_COLS * vec))
    ranks = 1
    while ranks < ACT_MAX_RANKS and tiles * ranks < SMS and \
            ranks * ACT_LANES < m:
        ranks *= 2
    return {"tiles": tiles, "ranks": ranks,
            "rows_per_lane": math.ceil(m / (ranks * ACT_LANES))}


def _act_vec(*tensors) -> int:
    """The kernel's vector width for these (m, n) operands: 4 where n is
    a multiple of 4 and every pointer is 16-byte aligned, else 1."""
    ok = tensors[0].shape[-1] % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if ok else 1


def column_sum_in_plan_order(v, vec: int = 4):
    """The column sums of a 2-D f32 ``v`` (m, n) in act_backward's
    order: each lane's rows in row order from 0, each block's lanes in
    lane order from 0, the cluster's ranks in rank order from 0 — the
    kernel's f32 additions one for one, so the same bits."""
    m, n = v.shape
    plan = act_bias_plan(m, n, vec)
    ranks, per = plan["ranks"], plan["rows_per_lane"]
    rows = ranks * ACT_LANES * per
    if rows > m:                      # rows past m add nothing
        v = torch.cat([v, v.new_zeros(rows - m, n)])
    v = v.reshape(ranks, ACT_LANES, per, n)
    lane = v.new_zeros(ranks, ACT_LANES, n)
    for r in range(per):
        lane = lane + v[:, :, r]
    block = v.new_zeros(ranks, n)
    for lo in range(ACT_LANES):
        block = block + lane[:, lo]
    out = v.new_zeros(n)
    for r in range(ranks):
        out = out + block[r]
    return out


def act_bias_backward_plain(y, err, activation: str, vec: int = None):
    """The plain PyTorch ``(err * act'(y), grad_b)`` on 2-D ``y`` and
    ``err``: ``grad_b`` the column sums in the kernel's order
    (:func:`column_sum_in_plan_order`, at the kernel's vector width for
    these operands unless ``vec`` is given)."""
    err_v = act_backward_plain(y, err, activation)
    vec = _act_vec(y, err) if vec is None else vec
    return err_v, column_sum_in_plan_order(err_v, vec)


def gemm_split_plain(a, b, bias=None, activation: str = activations.LINEAR,
                     per=None):
    """The plain PyTorch ``act(a @ b + bias)`` with K in slices of
    ``per`` (the plan's by default): each slice's product, summed in
    slice order, then bias and activation — the split kernel's
    arithmetic."""
    (m, k), n = a.shape, b.shape[1]
    per = gemm_plan(m, n, k)["per"] if per is None else per
    v = None
    for lo in range(0, k, per):
        part = a[:, lo:lo + per] @ b[lo:lo + per]
        v = part if v is None else v + part
    if bias is not None:
        v = v + bias
    return activations.forward(torch, activation, v)


def gemm_tile(m: int, n: int) -> tuple:
    """``(BM, BN)`` of the kernel's tile for an (m, ·) x (·, n) product,
    the twin of ``gemm_bn`` in csrc/gemm.cu: 128 rows, and 128 columns
    unless n <= 64."""
    return 128, (64 if n <= 64 else 128)


def whole_wave_splits(tiles: int, wave: int, k_tiles: int,
                      max_waves: int) -> int:
    """Slices of a K of ``k_tiles`` k tiles for ``tiles`` output tiles,
    ``wave`` blocks resident at once, the twin of ``whole_wave_splits``
    in csrc/tile_f32.cuh: the count whose grid fills its last wave best
    over at most ``max_waves`` waves, the fewest on a tie, each slice a
    whole number of k tiles.  For w waves the fullest grid takes the most
    slices that fit, floor(w·wave / tiles) (fewer once whole k tiles
    round them), so those few counts are the only candidates."""
    best, best_waves = 0, 1
    for w in range(1, max_waves + 1):
        s = min(max(1, w * wave // tiles), k_tiles)
        sp = math.ceil(k_tiles / math.ceil(k_tiles / s))  # whole k tiles
        waves = math.ceil(sp * tiles / wave)
        if sp * best_waves > best * waves:          # a fuller last wave
            best, best_waves = sp, waves
    return best


@functools.lru_cache(maxsize=4096)
def _plan(m: int, n: int, k: int) -> tuple:
    bm, bn = gemm_tile(m, n)
    k_tiles = math.ceil(k / K_TILE)
    splits = whole_wave_splits(math.ceil(m / bm) * math.ceil(n / bn),
                               SMS * GEMM_TILES[(bm, bn)], k_tiles,
                               GEMM_MAX_WAVES)
    per = math.ceil(k_tiles / splits) * K_TILE
    return bm, bn, math.ceil(k / per), per


def gemm_plan(m: int, n: int, k: int) -> dict:
    """The kernel's schedule for an (m, k) x (k, n) product, the twin of
    ``gemm_plan`` in csrc/gemm.cu: its tile (:func:`gemm_tile`), and K in
    ``splits`` slices of ``per`` — with ``wave`` = SMS x the tile's
    resident blocks, the slice count whose grid fills its last wave best
    over at most ``GEMM_MAX_WAVES`` waves (the fewest slices on a tie),
    each slice a whole number of k tiles, none empty
    (:func:`whole_wave_splits`, the conv weight gradient's rule).  Also
    its blocks and the tile's resident blocks an SM."""
    bm, bn, splits, per = _plan(m, n, k)
    return {"tile": [bm, bn], "splits": splits, "per": per,
            "blocks": math.ceil(m / bm) * math.ceil(n / bn) * splits,
            "blocks_per_sm": GEMM_TILES[(bm, bn)]}


def _bound_of(flops: float, nbytes: float, peak: float = F32_FLOPS) -> dict:
    """The larger of the flops over ``peak`` (the f32 one by default) and
    the bytes over the HBM rate, and which of the two it is."""
    flops_ms = flops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes"}


def bound(a, b, bias=None, activation: str = activations.LINEAR) -> dict:
    """The least time the card could take for :func:`gemm_fc` on these
    operands: the larger of ``2·M·N·K`` flops (plus the epilogue's) over
    the f32 peak and the bytes of a, b, bias and the output, each moved
    once, over the HBM rate."""
    (m, k), n = a.shape, b.shape[1]
    epilogue = (bias is not None) + _ACT_FLOPS.get(activation, 0)
    flops = 2 * m * n * k + epilogue * m * n
    nbytes = 4 * (m * k + k * n + m * n + (n if bias is not None else 0))
    return _bound_of(flops, nbytes)


def act_backward_bound(y, activation: str, bias_grad: bool = False) -> dict:
    """The same for :func:`act_backward`: y and err read, out written,
    and with ``bias_grad`` one add an element and ``grad_b`` (a column
    each) written."""
    n = y.numel()
    cols = y.shape[-1] if bias_grad else 0
    return _bound_of((_ACT_FLOPS[activation] + bool(bias_grad)) * n,
                     12 * n + 4 * cols)


def _check_activation(activation: str) -> None:
    if activation not in _ACT_CODES:
        raise ValueError(f"activation {activation!r} is not in the fused "
                         f"kernel set {FUSED_ACTIVATIONS}")


def _check_f32(device, **tensors) -> None:
    for name, x in tensors.items():
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (the kernels are "
                             f"f32), not {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the FC kernels run on cpu or cuda tensors, not "
                         f"{device.type}")


def _stored(x, name: str) -> int:
    """0 if ``x`` is contiguous, 1 if it is the transpose of a
    contiguous matrix (the kernel reads it transposed); else raise."""
    if x.is_contiguous():
        return 0
    if x.t().is_contiguous():
        return 1
    raise ValueError(f"{name} must be contiguous or the transpose of a "
                     f"contiguous matrix")


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("gemm")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.znicz_gemm_f32.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
        lib.znicz_gemm_f32.restype = i32
        lib.znicz_gemm_f32_plan.argtypes = [i32] * 3 + [ptr]
        lib.znicz_gemm_f32_plan.restype = i32
        lib.znicz_gemm_f32_residency.argtypes = [i32] * 3
        lib.znicz_gemm_f32_residency.restype = i32
        i64 = ctypes.c_longlong
        lib.znicz_act_backward_f32.argtypes = [ptr] * 4 + [
            i64, i64, i64, i32, i64, i32, i32, ptr]
        lib.znicz_act_backward_f32.restype = i32
        lib.znicz_empty_launch.argtypes = [i64, i32, ptr]
        lib.znicz_empty_launch.restype = i32
        lib.znicz_gemm_error_string.argtypes = [i32]
        lib.znicz_gemm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def gemm_plan_on_card(m: int, n: int, k: int) -> dict:
    """The kernel's schedule as ``csrc/gemm.cu`` computes it on this
    card (:func:`gemm_plan`'s keys), its residency from the CUDA
    occupancy calculator."""
    out = (ctypes.c_int * 5)()
    _raise_on(_library().znicz_gemm_f32_plan(m, n, k, out), "gemm_fc plan")
    bm, bn, per_sm, splits, per = out
    return {"tile": [bm, bn], "splits": splits, "per": per,
            "blocks": math.ceil(m / bm) * math.ceil(n / bn) * splits,
            "blocks_per_sm": per_sm}


def gemm_residency_on_card(layouts: bool = False) -> dict:
    """``{"BMxBN": resident blocks an SM}`` of each tile on this card
    (the least over its four operand layouts, as the plan takes it), or
    with ``layouts`` each instantiation's, keyed ``"BMxBN/trans_a,
    trans_b"``."""
    if not layouts:
        return {f"{bm}x{bn}": gemm_plan_on_card(bm, bn, K_TILE)[
            "blocks_per_sm"] for bm, bn in GEMM_TILES}
    lib = _library()
    return {f"{bm}x{bn}/{ta},{tb}": lib.znicz_gemm_f32_residency(bn, ta, tb)
            for bm, bn in GEMM_TILES for ta in (0, 1) for tb in (0, 1)}


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().znicz_gemm_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def gemm_fc(a, b, bias=None, activation: str = activations.LINEAR):
    """``act(a @ b + bias)`` on 2-D f32 ``a`` (M, K) and ``b`` (K, N),
    bias (N,) or None -> a new contiguous (M, N); the plain version on
    CPU tensors, the kernel on CUDA tensors (on the current stream)."""
    global gemm_launches
    _check_activation(activation)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a (M, K) and b (K, N); got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    if min(m, n, k) < 1:
        raise ValueError(f"empty GEMM ({m}, {k}) x ({k}, {n})")
    tensors = {"a": a, "b": b}
    if bias is not None:
        if tuple(bias.shape) != (n,) or not bias.is_contiguous():
            raise ValueError(f"bias must be a contiguous ({n},); got "
                             f"{tuple(bias.shape)}")
        tensors["bias"] = bias
    _check_f32(a.device, **tensors)
    trans_a, trans_b = _stored(a, "a"), _stored(b, "b")
    if a.device.type == "cpu":
        return fc_forward_plain(a, b, bias, activation)
    _, _, splits, per = _plan(m, n, k)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    part = torch.empty((splits, m, n), dtype=torch.float32,
                       device=a.device) if splits > 1 else None
    rc = _library().znicz_gemm_f32(
        a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), m, n, k, trans_a,
        trans_b, _ACT_CODES[activation], splits, per,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "gemm_fc")
    gemm_launches += 1
    return out


def act_backward(y, err, activation: str, bias_grad: bool = False):
    """``err * act'(y)`` on same-shaped contiguous f32 tensors, taken as
    (shape[0], rest); with ``bias_grad`` -> ``(err_v, grad_b)``, grad_b
    the column sums over the rows from the same launch.  Returns ``err``
    itself for ``linear`` (no launch; not with ``bias_grad``).  The plain
    versions on CPU tensors, the kernel on CUDA tensors; the kernel
    always writes grad_b, which is dropped without ``bias_grad``."""
    global act_launches
    _check_activation(activation)
    if y.shape != err.shape:
        raise ValueError(f"y {tuple(y.shape)} and err {tuple(err.shape)} "
                         f"differ in shape")
    _check_f32(y.device, y=y, err=err)
    if not (y.is_contiguous() and err.is_contiguous()):
        raise ValueError("y and err must be contiguous")
    if activation == activations.LINEAR:
        if bias_grad:
            raise ValueError("a linear backward has no activation pass "
                             "to take grad_b from; sum err itself")
        return err
    if y.numel() < 1:
        raise ValueError("empty act_backward")
    m = y.shape[0] if y.dim() > 1 else 1
    y2, e2 = y.reshape(m, -1), err.reshape(m, -1)
    if y.device.type == "cpu":
        if bias_grad:
            return act_bias_backward_plain(y2, e2, activation)
        return act_backward_plain(y, err, activation)
    n = y2.shape[1]
    out = torch.empty_like(err)
    grad_b = torch.empty(n, dtype=torch.float32, device=y.device)
    vec = _act_vec(y2, e2, out, grad_b)
    plan = act_bias_plan(m, n, vec)
    rc = _library().znicz_act_backward_f32(
        y.data_ptr(), err.data_ptr(), out.data_ptr(), grad_b.data_ptr(), m,
        n, plan["tiles"], plan["ranks"], plan["rows_per_lane"], vec,
        _ACT_CODES[activation], torch.cuda.current_stream(y.device)
        .cuda_stream)
    _raise_on(rc, "act_backward")
    act_launches += 1
    return (out, grad_b) if bias_grad else out


def empty_launch(y) -> None:
    """An empty kernel over the grid and clusters :func:`act_backward`'s
    vector path takes for a 2-D ``y``, launched through the same library
    on the current stream of ``y``'s device: a measurement of the launch
    floor, on no path (so no counter)."""
    plan = act_bias_plan(y.shape[0], y.shape[1], 4)
    rc = _library().znicz_empty_launch(
        plan["tiles"], plan["ranks"],
        torch.cuda.current_stream(y.device).cuda_stream)
    _raise_on(rc, "empty_launch")


def fc_forward(x, w, bias=None, activation: str = activations.LINEAR):
    """All2All forward: flatten-batch GEMM with fused bias and
    activation (the semantics of ``ops/linear.py forward``)."""
    return gemm_fc(x.reshape(x.shape[0], -1), w, bias, activation)


def fc_backward(x, y, w, err_output, activation: str = activations.LINEAR,
                activation_applied: bool = True):
    """All2All backward -> ``(err_input, grad_w, grad_b)``, gradients
    summed over the batch (the semantics of ``ops/linear.py backward``):
    ``err_v = err * act'(y)`` and ``grad_b`` from act_backward's one
    launch, then ``err_v @ w.T`` and ``x.T @ err_v`` on the GEMM kernel.
    With no activation to apply (``linear`` or ``activation_applied``
    False), ``err_v`` is the error itself and ``grad_b`` a torch sum."""
    x_flat = x.reshape(x.shape[0], -1)
    err = err_output.reshape(err_output.shape[0], -1)
    if activation_applied and activation != activations.LINEAR:
        err_v, grad_b = act_backward(y.reshape(y.shape[0], -1), err,
                                     activation, bias_grad=True)
    else:
        err_v, grad_b = err, err.sum(dim=0)
    err_input = gemm_fc(err_v, w.t()).reshape(x.shape)
    grad_w = gemm_fc(x_flat.t(), err_v)
    return err_input, grad_w, grad_b
