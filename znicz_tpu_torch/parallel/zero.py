"""ZeRO-style sharding primitives (Xu et al. 2020, arXiv:2004.13336) —
the port of ``znicz_tpu/parallel/zero.py`` on a :class:`DataMesh`.

A leaf of ``size`` elements is flattened, zero-padded to a multiple of
the mesh size n and cut into n equal slices; rank r holds slice r (the
rows ``P("data")`` gives device r in the reference).  The regathers
ride the mesh's collective seam (``parallel/mesh.py``), so inside the
fused step's CUDA graphs they are captured with the step.

- ``pad_slice``: this rank's slice, with no pad when n divides the size;
- ``psum_regather``: the slices through a sum over a zero buffer (the
  reference's provably-replicating form, n× the bytes of the payload);
- ``all_gather_slices``: the slices through one all-gather (the
  payload-proportional form), ``via_psum`` and ``codec`` as in the
  reference;
- ``gather_chain``: one collective a leaf, in the order the leaves are
  used (the reference dispatches them ahead of the forward so XLA
  overlaps them; here they are issued in that order on one stream).
"""

from __future__ import annotations

import torch


def shard_len(size: int, n: int) -> int:
    """Elements of each rank's slice of a ``size``-element leaf."""
    return -(-int(size) // n)


def pad_slice(x: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """This rank's 1/n slice of ``x`` flattened and zero-padded to a
    multiple of ``n``: a view of ``x`` when no pad is needed (the
    aligned case pays no copy), else a slice of a padded copy."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat.shape[0] // n
    return flat[rank * shard:(rank + 1) * shard]


def _full(flat: torch.Tensor, like) -> torch.Tensor:
    """The first ``like``'s-size elements of ``flat`` in ``like``'s
    shape (``like`` is a tensor or a shape)."""
    shape = tuple(getattr(like, "shape", like))
    size = 1
    for d in shape:
        size *= int(d)
    return flat.reshape(-1)[:size].reshape(shape)


def psum_regather(shard: torch.Tensor, mesh, like) -> torch.Tensor:
    """Disjoint per-rank slices -> the full array of ``like``'s shape on
    every rank: each rank writes its slice into a zero buffer at its
    offset and the buffers are summed."""
    size = shard.shape[0]
    buf = shard.new_zeros(size * mesh.size)
    buf[mesh.rank * size:(mesh.rank + 1) * size] = shard
    return _full(mesh.all_reduce_(buf), like)


def all_gather_slices(shard: torch.Tensor, mesh, like,
                      via_psum: bool = False, codec=None) -> torch.Tensor:
    """Disjoint per-rank flat slices (the aligned ``pad_slice`` layout)
    -> the full array of ``like``'s shape on every rank, through one
    all-gather.  ``via_psum`` takes :func:`psum_regather` instead;
    ``codec`` (a ``qcomm.Codec``) ships each slice quantized and
    overrides ``via_psum``; None keeps the exact path."""
    if codec is not None:
        from znicz_tpu_torch.parallel import qcomm
        return qcomm.gather_slices(shard, mesh, like, codec)
    if via_psum:
        return psum_regather(shard, mesh, like)
    return _full(mesh.all_gather(shard), like)


def gather_chain(shards, likes, mesh, via_psum: bool = False,
                 codec=None) -> list:
    """Full arrays from their per-rank slices, one collective a leaf in
    the order given (the order the forward uses them)."""
    return [all_gather_slices(s, mesh, like, via_psum=via_psum,
                              codec=codec)
            for s, like in zip(shards, likes)]
