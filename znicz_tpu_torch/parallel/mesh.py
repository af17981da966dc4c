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
- :class:`Mesh`, a mesh of named axes (``{"data": a, "seq": b,
  "model": c}`` for the transformer, ``{"data": a, "pipe": b,
  "expert": c}`` for the pipeline step; :func:`make_mesh`).
  ``mesh.devices`` is the rank array: :func:`make_mesh` reshapes the
  ranks row-major in the dict's order, as the reference reshapes its
  device list (rank ``r`` at position ``np.unravel_index(r, sizes)``);
  :func:`make_hybrid_mesh` lays them out by node (the reference's
  slices).  ``mesh.axis(name)`` (or a tuple of names) is a handle over
  the line of ranks through this rank along those axes: a
  :class:`DataMesh` with the line's group, its ``size`` and this rank's
  ``index`` on it.

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
:class:`DataMesh`'s ``all_reduce_`` (sum or max), ``all_gather``,
``ppermute`` and ``all_to_all``: each runs on the current stream as a
blocking collective, so a CUDA graph captured on the step's stream
holds it, and ``collective_launches`` counts them as the kernel
wrappers count their launches (a graph's replays add its capture's
count back).  A process group orders its ranks by global rank; a line
whose order differs (a hybrid mesh's) has its gathered and exchanged
blocks put back in line order.

The reference's ``varying`` (shard_map's replication typing of scan
carries) has no counterpart: there is no such type system here.
"""

from __future__ import annotations

import itertools
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

#: collectives issued through a mesh since import (or since a caller
#: reset it to 0); a graph replay adds its capture's count
collective_launches = 0

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
        # the group's order is by global rank: where the line's is not,
        # _order[i] is the group place of the line's i-th rank
        order = [sorted(self.ranks).index(r) for r in self.ranks] \
            if ranks is not None else []
        self._order = order if order != sorted(order) else None

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
        out = out.view((self.size,) + tuple(t.shape))
        return out if self._order is None else out[self._order]

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

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all(t, split_axis=0, concat_axis=0)`` over the
        line: ``t`` ``(n, ...)``, block ``j`` sent to the line's rank
        ``j``; block ``i`` of the result is what rank ``i`` sent here.
        Without a group (a line of one) ``t`` comes back."""
        global collective_launches
        if self.group is None:
            return t
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all of {tuple(t.shape)} over a line "
                             f"of {self.size}: dim 0 must be the line")
        t = t.contiguous()
        if self._order is not None:
            # block of the group's g-th rank first
            t = t[[self._order.index(g) for g in range(self.size)]]
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        collective_launches += 1
        return out if self._order is None else out[self._order]


class Mesh:
    """A mesh of named axes over the world: ``shape`` ``{axis: size}`` in
    the caller's order, this process's global ``rank`` and its
    ``coords`` on each axis; :meth:`axis` gives the handle of one axis or
    of a tuple of axes.  ``devices`` is the rank array (the reference's
    device array: the rank where its device sits; row-major
    ``np.arange`` unless given)."""

    def __init__(self, shape: dict, rank: int, lines: dict,
                 devices=None) -> None:
        self.shape = {str(a): int(s) for a, s in shape.items()}
        self.rank = int(rank)
        sizes = tuple(self.shape.values()) or (1,)
        self.devices = np.arange(int(np.prod(sizes))).reshape(sizes) \
            if devices is None else np.asarray(devices).reshape(sizes)
        where = np.argwhere(self.devices == self.rank)[0]
        self.coords = dict(zip(self.shape, (int(i) for i in where))) \
            if self.shape else {}
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


def _line_ranks(shape: dict, names: tuple, coords: dict,
                devices: np.ndarray) -> list:
    """Global ranks of the line through ``coords`` along ``names``, in
    row-major order over ``names``."""
    free = [range(shape[a]) if a in names else (coords[a],) for a in shape]
    return [int(devices[c]) for c in itertools.product(*free)]


def _spans_world(shape: dict, size: int) -> None:
    n = int(np.prod(list(shape.values()))) if shape else 1
    if n != size:
        raise ValueError(
            f"a mesh of {n} ({shape}) in a world of {size}: the mesh spans "
            f"the whole world (start {n} processes, launcher.multihost)")


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """A mesh over the whole world from ``{axis: size}`` (insertion
    ordered): the product of the sizes must be the world's size (one
    process per device; outside a world, 1).  ``devices`` is the
    reference's argument and must be None: each process drives one
    device."""
    if devices is not None:
        raise ValueError("the port's mesh spans processes, one device "
                         "each: pass no devices")
    shape = {str(a): int(s) for a, s in axis_sizes.items()}
    _spans_world(shape, world()[1])
    return _mesh_of(shape, None)


def _mesh_of(shape: dict, ranks: Optional[np.ndarray]) -> Mesh:
    """The mesh of ``shape`` over the world with rank array ``ranks``
    (None: row-major), every line's group made on every rank."""
    rank, size, default = world()
    sizes = tuple(shape.values()) or (1,)
    ranks = np.arange(size).reshape(sizes) if ranks is None else ranks
    lines = {}
    names = list(shape)
    # every rank makes every group, in one order (new_group is collective)
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(names, k):
            for fixed in itertools.product(*(
                    range(shape[a]) if a not in sub else (0,)
                    for a in names)):
                line = _line_ranks(shape, sub, dict(zip(names, fixed)),
                                   ranks)
                if len(line) == size:
                    group = default
                elif len(line) == 1:
                    group = None
                else:
                    group = dist.new_group(line)
                if rank in line:
                    lines[sub] = DataMesh(len(line), line.index(rank),
                                          group, names=sub, ranks=line)
    return Mesh(shape, rank, lines, ranks)


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


def _dcn_sizes(axis_sizes: dict, dcn_axis_sizes: Optional[dict]) -> dict:
    """The reference's checks of the DCN sizes -> ``{axis: dcn size}``."""
    dcn = {k: 1 for k in axis_sizes}
    dcn.update(dcn_axis_sizes or {})
    unknown = set(dcn) - set(axis_sizes)
    if unknown:
        raise ValueError(f"dcn axes {sorted(unknown)} not in axis_sizes")
    for name, total in axis_sizes.items():
        if total % dcn[name]:
            raise ValueError(f"axis {name!r}: dcn size {dcn[name]} must "
                             f"divide total {total}")
    return dcn


def hybrid_ranks(axis_sizes: dict, dcn_axis_sizes: Optional[dict],
                 nodes: list) -> np.ndarray:
    """The rank array of a DCN-aware mesh over ``nodes`` (each node's
    global ranks; the reference's slices): the DCN axes outermost, one
    node a block of ``axis_sizes // dcn`` ranks within it, the blocks
    laid out over the DCN sizes in node order (the reference's
    ``create_hybrid_device_mesh``).  One node gives the plain row-major
    mesh.  The mesh spans the whole world, so where the reference trims
    surplus nodes or ranks this raises."""
    dcn = _dcn_sizes(axis_sizes, dcn_axis_sizes)
    shape = tuple(int(s) for s in axis_sizes.values())
    total = int(np.prod(shape)) if shape else 1
    nodes = [sorted(int(r) for r in node) for node in nodes]
    n_slices, n_dcn = len(nodes), int(np.prod(list(dcn.values())))
    if n_slices > 1 and n_dcn > n_slices:
        raise ValueError(f"dcn axes span {n_dcn} slices, runtime "
                         f"reports only {n_slices}")
    if n_slices > 1 and n_dcn == 1:
        raise ValueError(
            f"no single slice holds the {total} devices this mesh wants "
            f"(largest has {max(len(n) for n in nodes)}); give the "
            f"slice-spanning axis a dcn_axis_sizes entry")
    _spans_world(dict(axis_sizes), sum(len(n) for n in nodes))
    if n_slices == 1:
        return np.asarray(nodes[0]).reshape(shape or (1,))
    if n_slices > n_dcn:
        raise ValueError(
            f"{n_slices} nodes for dcn axes spanning {n_dcn}: the mesh "
            f"spans the whole world and trims no node")
    ici = tuple(s // d for s, d in zip(shape, dcn.values()))
    for sid, node in enumerate(nodes):
        if len(node) != int(np.prod(ici)):
            raise ValueError(
                f"slice {sid} has {len(node)} devices, mesh wants "
                f"{int(np.prod(ici))} per slice (the mesh spans the whole "
                f"world: no rank is trimmed)")
    blocks = [np.asarray(node).reshape(ici) for node in nodes]

    def nest(dims, offset):
        # blocks[offset:] laid out row-major over dims, as np.block nests
        if not dims:
            return blocks[offset]
        step = int(np.prod(dims[1:]))
        return [nest(dims[1:], offset + i * step) for i in range(dims[0])]
    return np.block(nest(tuple(dcn.values()), 0))


def local_nodes() -> list:
    """The world's nodes, each its global ranks: ``LOCAL_WORLD_SIZE``
    consecutive ranks a node where a launcher set it, else the ranks that
    share a host name (an all-gather), in order of their first rank."""
    rank, size, group = world()
    if group is None:
        return [[0]]
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 0))
    if local:
        if size % local:
            raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide "
                             f"the world of {size}")
        return [list(range(i, i + local)) for i in range(0, size, local)]
    hosts = [None] * size
    dist.all_gather_object(hosts, socket.gethostname())
    nodes: dict = {}
    for r, host in enumerate(hosts):
        nodes.setdefault(host, []).append(r)
    return list(nodes.values())


def make_hybrid_mesh(axis_sizes: dict, dcn_axis_sizes: Optional[dict] = None,
                     devices=None) -> Mesh:
    """The reference's DCN-aware mesh over the world's nodes
    (:func:`local_nodes`, the reference's slices): ``axis_sizes`` the
    total sizes, ``dcn_axis_sizes`` how much of each axis spans nodes
    (:func:`hybrid_ranks`).  ``devices`` must be None, as in
    :func:`make_mesh`."""
    if devices is not None:
        raise ValueError("the port's mesh spans processes, one device "
                         "each: pass no devices")
    shape = {str(a): int(s) for a, s in axis_sizes.items()}
    return _mesh_of(shape, hybrid_ranks(shape, dcn_axis_sizes,
                                        local_nodes()))


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
        raise NotImplementedError(
            f"mesh axes {wide}: the fused step shards the data axis only "
            f"(the reference's runs replicated over the others; ROADMAP.md, "
            f"item 10b's divergences); seq and model are the transformer "
            f"step's, pipe and expert the pipeline step's")
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
