"""Meshes of named axes — the port of ``znicz_tpu/parallel/mesh.py`` on
``torch.distributed``.

The reference is one process driving N devices through ``shard_map``
over a ``jax.sharding.Mesh``.  The port runs one process per device, the
PyTorch idiom: a mesh is this process's place in an initialized
``torch.distributed`` world (``launcher.multihost`` or a caller's
``init_process_group``).  A mesh of one needs no group, so a
single-process run keeps working without one.

Two kinds of mesh:

- :class:`DataMesh`, the fused step's 1-axis ``("data",)`` mesh over
  the whole world (what :func:`resolve` returns for it);
- :class:`Mesh`, the transformer's mesh of named axes (``{"data": a,
  "seq": b, "model": c}``, :func:`make_mesh`).  Rank ``r``'s
  coordinates are ``np.unravel_index(r, sizes)`` in the dict's order,
  as the reference reshapes its device list row-major: rank ``r`` is
  the device at ``mesh.devices`` position ``r``.  ``mesh.axis(name)``
  (or a tuple of names) is a handle over the line of ranks through this
  rank along those axes: a :class:`DataMesh` with the line's group, its
  ``size`` and this rank's ``index`` on it.

The groups are made with ``dist.new_group``, one a line of every
non-empty set of axes, every rank making every group in the same order
(the call is collective).  ``init_device_mesh`` would give the lines of
single axes, but the step also reduces over a pair of axes (the loss
and the gradients over ``("data", "seq")``), which ``DeviceMesh`` gives
only through its private flattening; explicit groups also keep the
rank order on a line the reference's (row-major over the named axes).
A line of one rank inside a larger world has no group (its collectives
are the identity); a line that is the whole world takes the default
group, so a one-process world still runs its collectives on it.

Every collective a step makes goes through one counted seam,
:class:`DataMesh`'s ``all_reduce_`` (sum or max), ``all_gather`` and
``ppermute``: each runs on the current stream as a blocking collective,
so a CUDA graph captured on the step's stream holds it, and
``collective_launches`` counts them as the kernel wrappers count their
launches (a graph's replays add its capture's count back).

Not ported: the pipeline and expert axes and DCN axes above 1 (the
pipeline step, ``moe_ffn_dispatch`` and multi-slice meshes, ROADMAP.md
queue A item 10c) raise.  The reference's ``varying`` (shard_map's
replication typing of scan carries) has no counterpart: there is no
such type system here.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

#: collectives issued through a mesh since import (or since a caller
#: reset it to 0); a graph replay adds its capture's count
collective_launches = 0

#: the axes of the reference's pipeline step, not ported yet
_PIPELINE_AXES = ("pipe", "expert")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A item 10c: the "
        f"pipeline and expert axes and DCN meshes); the port's meshes "
        f"have the data, seq and model axes")


def world() -> tuple:
    """``(rank, world size, group)`` of this process: the initialized
    default group, else ``(0, 1, None)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    return 0, 1, None


class DataMesh:
    """A line of ranks under one axis name (or several): this process is
    rank ``rank`` of ``n`` on it, and ``group`` carries the collectives
    (None only for a line of one).  The fused step's mesh is the
    ``("data",)`` line over the whole world."""

    def __init__(self, n: int, rank: int = 0, group=None,
                 names: tuple = ("data",), ranks=None) -> None:
        if group is None and n != 1:
            raise ValueError(f"a mesh of {n} needs a process group")
        self.names = tuple(names)
        self.shape = {"+".join(self.names): int(n)}
        self.rank = int(rank)
        self.group = group
        #: the global ranks of the line, in line order (None: [rank])
        self.ranks = list(ranks) if ranks is not None else None

    @property
    def size(self) -> int:
        return next(iter(self.shape.values()))

    @property
    def index(self) -> int:
        """This rank's place on the line (``lax.axis_index``)."""
        return self.rank

    @property
    def backend(self) -> Optional[str]:
        """The group's backend ("nccl", "gloo"), None without a group."""
        return None if self.group is None else dist.get_backend(self.group)

    def __repr__(self) -> str:
        return (f"DataMesh({'+'.join(self.names)}={self.size}, "
                f"rank={self.rank}, backend={self.backend})")

    # -- the step's collectives ---------------------------------------------
    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or, ``op="max"``, the largest of) ``t`` over the line, in
        place (a no-op without a group)."""
        global collective_launches
        if self.group is not None:
            dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX}[op],
                            group=self.group)
            collective_launches += 1
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in line order: ``(n, *t.shape)``."""
        global collective_launches
        t = t.contiguous()
        if self.group is None:
            return t[None].clone()
        out = torch.empty(self.size * t.numel(), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.reshape(-1), group=self.group)
        collective_launches += 1
        return out.view((self.size,) + tuple(t.shape))

    def ppermute(self, tensors, shift: int = 1) -> list:
        """Each of ``tensors`` sent to the rank ``shift`` places on along
        the line (cyclically) and the one from ``shift`` places back
        received: ``lax.ppermute`` with ``perm = [(i, (i + shift) % n)]``,
        every tensor of one call in one ``batch_isend_irecv``.  A line of
        one hands the tensors back."""
        global collective_launches
        tensors = [t.contiguous() for t in tensors]
        if self.size == 1:
            return tensors
        dst = self.ranks[(self.rank + shift) % self.size]
        src = self.ranks[(self.rank - shift) % self.size]
        out = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, dst, self.group, tag=i)
               for i, t in enumerate(tensors)] + \
            [dist.P2POp(dist.irecv, o, src, self.group, tag=i)
             for i, o in enumerate(out)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        collective_launches += 1
        return out


class Mesh:
    """A mesh of named axes over the world: ``shape`` ``{axis: size}`` in
    the caller's order, this process's global ``rank`` and its
    ``coords`` on each axis; :meth:`axis` gives the handle of one axis or
    of a tuple of axes.  ``devices`` is the rank array (the reference's
    device array: rank ``r`` where its device ``r`` sits)."""

    def __init__(self, shape: dict, rank: int, lines: dict) -> None:
        self.shape = {str(a): int(s) for a, s in shape.items()}
        self.rank = int(rank)
        sizes = tuple(self.shape.values()) or (1,)
        self.devices = np.arange(int(np.prod(sizes))).reshape(sizes)
        self.coords = dict(zip(self.shape, (int(i) for i in np.unravel_index(
            self.rank, sizes)))) if self.shape else {}
        self._lines = lines

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def backend(self) -> Optional[str]:
        """The world group's backend, None for a mesh with no group."""
        groups = [line.group for line in self._lines.values()
                  if line.group is not None]
        return dist.get_backend(groups[0]) if groups else None

    def axis(self, names) -> DataMesh:
        """The handle over ``names`` (one axis or a tuple of axes; an axis
        the mesh does not have has size 1)."""
        names = (names,) if isinstance(names, str) else tuple(names)
        known = tuple(a for a in self.shape if a in names)
        return self._lines.get(known) or DataMesh(1, 0, None, names=names)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def local_mesh(axis_sizes: Optional[dict] = None) -> Mesh:
    """A mesh of one with no group whatever the world (``{"data": 1,
    "seq": 1, "model": 1}`` by default): the ungrouped step's."""
    shape = axis_sizes or {"data": 1, "seq": 1, "model": 1}
    if any(int(s) != 1 for s in shape.values()):
        raise ValueError(f"a local mesh has every axis 1, not {shape}")
    return Mesh(shape, 0, {})


def _line_ranks(shape: dict, names: tuple, coords: dict) -> list:
    """Global ranks of the line through ``coords`` along ``names``, in
    row-major order over ``names``."""
    sizes = tuple(shape.values())
    free = [range(shape[a]) if a in names else (coords[a],) for a in shape]
    return [int(np.ravel_multi_index(c, sizes))
            for c in itertools.product(*free)]


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """A mesh over the whole world from ``{axis: size}`` (insertion
    ordered): the product of the sizes must be the world's size (one
    process per device; outside a world, 1).  The pipeline and expert
    axes above 1 raise (item 10c).  ``devices`` is the reference's
    argument and must be None: each process drives one device."""
    if devices is not None:
        raise ValueError("the port's mesh spans processes, one device "
                         "each: pass no devices")
    shape = {str(a): int(s) for a, s in axis_sizes.items()}
    wide = {a: s for a, s in shape.items()
            if a in _PIPELINE_AXES and s != 1}
    if wide:
        raise _not_ported(f"mesh axes {wide}")
    rank, size, default = world()
    n = int(np.prod(list(shape.values()))) if shape else 1
    if n != size:
        raise ValueError(
            f"a mesh of {n} ({shape}) in a world of {size}: the mesh spans "
            f"the whole world (start {n} processes, launcher.multihost)")
    lines = {}
    names = list(shape)
    # every rank makes every group, in one order (new_group is collective)
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(names, k):
            for fixed in itertools.product(*(
                    range(shape[a]) if a not in sub else (0,)
                    for a in names)):
                ranks = _line_ranks(shape, sub, dict(zip(names, fixed)))
                if len(ranks) == size:
                    group = default
                elif len(ranks) == 1:
                    group = None
                else:
                    group = dist.new_group(ranks)
                if rank in ranks:
                    lines[sub] = DataMesh(len(ranks), ranks.index(rank),
                                          group, names=sub, ranks=ranks)
    return Mesh(shape, rank, lines)


def data_parallel_mesh(n: Optional[int] = None,
                       devices=None) -> DataMesh:
    """A 1-axis ("data",) mesh over the whole world (default) or ``n``
    processes, which must be the world's size: every process of the
    world trains the one model.  Without an initialized world only a
    mesh of one exists.  ``devices`` is the reference's argument and
    must be None: each process drives one device."""
    if devices is not None:
        raise ValueError("the port's mesh spans processes, one device "
                         "each: pass no devices")
    rank, size, group = world()
    n = size if n is None else int(n)
    if n != size:
        raise ValueError(
            f"a data mesh of {n} in a world of {size}: the mesh spans the "
            f"whole world (start {n} processes, launcher.multihost)")
    return DataMesh(n, rank, group, ranks=range(size))


def make_hybrid_mesh(axis_sizes: dict, dcn_axis_sizes: Optional[dict] = None,
                     devices=None) -> Mesh:
    """The reference's DCN-aware mesh, with its argument checks: a DCN
    axis above 1 (multi-slice) raises, the rest is :func:`make_mesh`."""
    dcn = {k: 1 for k in axis_sizes}
    dcn.update(dcn_axis_sizes or {})
    unknown = set(dcn) - set(axis_sizes)
    if unknown:
        raise ValueError(f"dcn axes {sorted(unknown)} not in axis_sizes")
    for name, total in axis_sizes.items():
        if total % dcn[name]:
            raise ValueError(f"axis {name!r}: dcn size {dcn[name]} must "
                             f"divide total {total}")
    spanning = {k: v for k, v in dcn.items() if v != 1}
    if spanning:
        raise _not_ported(f"DCN mesh axes {spanning}")
    return make_mesh(axis_sizes, devices)


def resolve(mesh) -> DataMesh:
    """The fused step's mesh: a :class:`DataMesh` as given; None for the
    whole world; a :class:`Mesh`, a reference-style ``{axis: size}`` or
    an object with ``.shape`` as its data axis.  The fused step shards
    the data axis only (the reference's runs replicated over any other
    axis): another axis above 1 raises."""
    if isinstance(mesh, DataMesh):
        return mesh
    if mesh is None:
        return data_parallel_mesh()
    shape = dict(getattr(mesh, "shape", mesh))
    wide = {a: int(s) for a, s in shape.items()
            if a != "data" and int(s) != 1}
    if wide:
        if any(a in _PIPELINE_AXES for a in wide):
            raise _not_ported(f"mesh axes {wide}")
        raise NotImplementedError(
            f"mesh axes {wide}: the fused step shards the data axis only "
            f"(the reference's runs replicated over the others; ROADMAP.md, "
            f"item 10b's divergences); seq and model are the transformer "
            f"step's")
    line = (mesh if isinstance(mesh, Mesh) else make_mesh(shape)).axis("data")
    return DataMesh(line.size, line.rank, line.group, ranks=line.ranks)


def check_backend(mesh, device: torch.device) -> None:
    """A step on ``device`` needs a group that can carry its tensors:
    NCCL for CUDA tensors (its collectives run inside the step's CUDA
    graphs, which cannot hold a gloo collective), gloo for CPU tensors.
    There is no fallback from one to the other."""
    backend = mesh.backend
    if backend is None:
        return
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(
            f"a {device.type} step on a {backend} group: the fused step on "
            f"{device.type} tensors needs a {want} group "
            f"(launcher.multihost picks NCCL for cuda, gloo for -d cpu)")
