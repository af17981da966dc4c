"""Sharded checkpoints of parameter pytrees — the port of
``znicz_tpu/parallel/checkpoint.py`` (orbax there) on
``torch.distributed.checkpoint`` (DCP).

A pytree is nested dicts and lists of tensors, each rank holding its
block of every leaf under a mesh and a spec tree (``parallel/mesh.py``,
specs as in ``parallel/transformer.py``: tuples of axis names, ``()``
replicated).  :func:`save_pytree` writes every leaf as a DTensor over a
``DeviceMesh`` of the mesh's rank array, its placements taken from the
spec (``Shard(dim)`` on an axis the spec names, ``Replicate()`` on the
others), so each rank writes its own blocks and a block held by several
ranks is written once, by the lowest of them (the first holder, whose
copy ``params_to_numpy`` reads too).  :func:`load_pytree` restores onto
any mesh and layout of the same global shapes: ``like`` (this rank's
target tensors) with ``mesh`` and ``specs`` decides each rank's block,
and DCP reads the overlapping pieces of whatever blocks were saved.
Outside a world the leaves are whole tensors.

The format is DCP's, not orbax's: a checkpoint of one package does not
load in the other (the workflow snapshots, ``snapshotter.py``, do).
The workflow world keeps its snapshotter; this module covers the
functional params of the transformer and pipeline steps.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import warnings

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.api import CheckpointException
from torch.distributed.checkpoint.default_planner import DefaultSavePlanner

from znicz_tpu_torch.parallel import mesh as _mesh
from znicz_tpu_torch.parallel.tree import tree_map
from znicz_tpu_torch.resilience.retry import DEFAULT_IO_RETRY


def _in_world() -> bool:
    return _mesh.world()[2] is not None


def _placed(local: torch.Tensor, mesh, spec):
    """``local`` as the DTensor of its global leaf on ``mesh`` under
    ``spec`` (a plain tensor outside a world or without a mesh)."""
    if mesh is None or not _in_world():
        return local
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    spec = tuple(spec)
    shape = list(local.shape)
    for dim, name in enumerate(spec):
        if name is not None:
            shape[dim] *= mesh.shape.get(name, 1)
    placements = [Shard(spec.index(a)) if a in spec else Replicate()
                  for a in mesh.shape]
    dmesh = DeviceMesh(local.device.type, torch.as_tensor(mesh.devices),
                       mesh_dim_names=tuple(mesh.shape),
                       _init_backend=False)
    return DTensor.from_local(local, dmesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


@contextlib.contextmanager
def _dcp_call():
    """Outside a world DCP runs in one process, as asked (``no_dist``),
    and warns that it does; the warning says nothing here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled")
        yield


def _agreed(local, retryable: tuple) -> None:
    """``local()``, this rank's own filesystem step, then (in a world)
    every rank learns every rank's outcome and all leave together: a
    failure anywhere raises on every rank, of a ``retryable`` class on
    every rank when each failure was one, so the ranks retry or give up
    at the same step.  Also the ranks' barrier."""
    err = None
    try:
        local()
    except Exception as exc:  # noqa: BLE001 — agreed on, then re-raised
        err = exc
    if not _in_world():
        if err is not None:
            raise err
        return
    outcomes = [None] * dist.get_world_size()
    dist.all_gather_object(outcomes, None if err is None else (
        repr(err), isinstance(err, retryable)))
    failed = {r: o for r, o in enumerate(outcomes) if o is not None}
    if not failed:
        return
    transient = all(t for _msg, t in failed.values())
    if err is not None and isinstance(err, retryable) == transient:
        raise err
    msg = f"checkpoint step failed on ranks {failed}"
    raise (retryable[0] if transient else RuntimeError)(msg) from err


def _write(state, path: str, retryable: tuple) -> None:
    """``dcp.save``: collective, and DCP raises one failure on every rank
    when any rank's write failed; a failure of ``retryable`` writes is
    raised as the first of them, so every rank retries."""
    try:
        with _dcp_call():
            dcp.save(state, checkpoint_id=path,
                     planner=DefaultSavePlanner(
                         dedup_save_to_lowest_rank=True),
                     no_dist=not _in_world())
    except CheckpointException as exc:
        errs = [e for e, _trace in exc.failures.values()]
        if errs and all(isinstance(e, retryable) for e in errs):
            raise errs[0] from exc
        raise


def _remove(path: str) -> None:
    if os.path.exists(path):
        shutil.rmtree(path)


def save_pytree(path: str, params, retry=DEFAULT_IO_RETRY, mesh=None,
                specs=None) -> str:
    """Write ``params`` (nested dicts and lists of tensors: this rank's
    blocks under ``specs`` on ``mesh``; None: whole leaves, replicated
    over the world) under the directory ``path``, replaced whole once
    every rank has written (collective in a world).  Transient
    filesystem failures retry under the shared I/O policy; the ranks
    agree on each step's outcome, so a failure on one rank retries on
    all of them together."""
    path = os.path.abspath(path)
    specs = specs if specs is not None else tree_map(lambda _: (), params)
    rank = _mesh.world()[0]
    state = tree_map(lambda a, s: _placed(a.detach(), mesh, s), params,
                     specs)
    partial = path + ".partial"
    retryable = retry.retryable if retry is not None else ()

    def _save() -> None:
        _agreed(lambda: rank == 0 and _remove(partial), retryable)
        _write(state, partial, retryable)

        def _publish() -> None:
            if rank == 0:
                _remove(path)
                os.replace(partial, path)
        _agreed(_publish, retryable)

    if retry is None:
        _save()
    else:
        retry.call(_save)
    return path


def _saved_tree(path: str, device):
    """The saved pytree as whole tensors of the saved dtypes on
    ``device``, empty, from the checkpoint's metadata (its leaves' paths
    and shapes)."""
    meta = dcp.FileSystemReader(path).read_metadata()
    tree: dict = {}
    for fqn, item in meta.state_dict_metadata.items():
        keys = meta.planner_data.get(fqn, (fqn,))
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = torch.empty(tuple(item.size),
                                     dtype=item.properties.dtype,
                                     device=device)

    def lists(node):
        # DCP's paths index lists by int: rebuild them as lists
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def load_pytree(path: str, like=None, mesh=None, specs=None,
                device="cuda"):
    """Load a pytree checkpoint (collective in a world).  ``like``: this
    rank's target tensors (their shapes, dtypes and devices), blocks
    under ``specs`` on ``mesh`` (None: whole leaves) — which is how a
    checkpoint written on one mesh and layout restores onto another of
    the same global shapes.  Without ``like``: every leaf whole, as
    saved, on ``device`` (the card unless the caller asks for the CPU,
    as the reference restores onto its default device).  Returns new
    tensors in the pytree's structure."""
    path = os.path.abspath(path)
    if like is None:
        out = _saved_tree(path, torch.device(device))
        with _dcp_call():
            dcp.load(out, checkpoint_id=path, no_dist=not _in_world())
        return out
    specs = specs if specs is not None else tree_map(lambda _: (), like)
    def empty(a):
        a = torch.as_tensor(a)
        return torch.empty(a.shape, dtype=a.dtype, device=a.device)
    local = tree_map(empty, like)
    state = tree_map(lambda a, s: _placed(a, mesh, s), local, specs)
    with _dcp_call():
        dcp.load(state, checkpoint_id=path, no_dist=not _in_world())
    return tree_map(lambda t: t.to_local() if hasattr(t, "to_local")
                    else t, state)
