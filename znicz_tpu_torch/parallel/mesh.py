"""The data mesh — the port of ``znicz_tpu/parallel/mesh.py`` on
``torch.distributed``.

The reference is one process driving N devices through ``shard_map``
over a ``jax.sharding.Mesh``.  The port runs one process per device, the
PyTorch idiom: a :class:`DataMesh` is this process's place in an
initialized ``torch.distributed`` world (``launcher.multihost`` or a
caller's ``init_process_group``), with the reference's axis name and
``.shape["data"]``.  A mesh of one needs no group, so a single-process
run keeps working without one.

The mesh is also the one seam through which the fused step makes its
collectives (:meth:`DataMesh.all_reduce_`, :meth:`DataMesh.all_gather`):
each runs on the current stream as a blocking collective, so a CUDA
graph captured on the step's stream holds every collective the step
makes, and ``collective_launches`` counts them as the kernel wrappers
count their launches (a graph's replays add its capture's count back).

Only the ``data`` axis is ported.  ``make_mesh`` and ``make_hybrid_mesh``
raise for any other axis above 1 and for any DCN axis above 1: those are
the transformer's multi-device axes (ROADMAP.md queue A item 10b).  The
reference's ``varying`` (shard_map's replication typing of scan carries)
has no counterpart: there is no such type system here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

#: collectives issued through a mesh since import (or since a caller
#: reset it to 0); a graph replay adds its capture's count
collective_launches = 0


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A item 10b, the "
        f"transformer's multi-device axes); the port's mesh has one axis, "
        f"data")


def world() -> tuple:
    """``(rank, world size, group)`` of this process: the initialized
    default group, else ``(0, 1, None)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    return 0, 1, None


class DataMesh:
    """A 1-axis ("data",) mesh: this process is rank ``rank`` of ``n``,
    and ``group`` carries the collectives (None only for a mesh of one
    outside any world)."""

    def __init__(self, n: int, rank: int = 0, group=None) -> None:
        if group is None and n != 1:
            raise ValueError(f"a mesh of {n} needs a process group")
        self.shape = {"data": int(n)}
        self.rank = int(rank)
        self.group = group

    @property
    def size(self) -> int:
        return self.shape["data"]

    @property
    def backend(self) -> Optional[str]:
        """The group's backend ("nccl", "gloo"), None without a group."""
        return None if self.group is None else dist.get_backend(self.group)

    def __repr__(self) -> str:
        return (f"DataMesh(data={self.size}, rank={self.rank}, "
                f"backend={self.backend})")

    # -- the step's collectives ---------------------------------------------
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the mesh, in place (a no-op without a group)."""
        global collective_launches
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
            collective_launches += 1
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: ``(n, *t.shape)``."""
        global collective_launches
        t = t.contiguous()
        if self.group is None:
            return t[None].clone()
        out = torch.empty(self.size * t.numel(), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.reshape(-1), group=self.group)
        collective_launches += 1
        return out.view((self.size,) + tuple(t.shape))


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
    return DataMesh(n, rank, group)


def make_mesh(axis_sizes: dict, devices=None) -> DataMesh:
    """A mesh from ``{axis: size}``: only ``data`` may exceed 1."""
    wide = {a: int(s) for a, s in axis_sizes.items()
            if a != "data" and int(s) != 1}
    if wide:
        raise _not_ported(f"mesh axes {wide}")
    return data_parallel_mesh(int(axis_sizes.get("data", 1)), devices)


def make_hybrid_mesh(axis_sizes: dict, dcn_axis_sizes: Optional[dict] = None,
                     devices=None) -> DataMesh:
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
    whole world; a reference-style ``{axis: size}`` (or an object with
    ``.shape``) through :func:`make_mesh`."""
    if isinstance(mesh, DataMesh):
        return mesh
    if mesh is None:
        return data_parallel_mesh()
    return make_mesh(dict(getattr(mesh, "shape", mesh)))


def check_backend(mesh: DataMesh, device: torch.device) -> None:
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
