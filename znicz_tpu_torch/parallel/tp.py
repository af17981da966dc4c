"""Tensor-parallel linear layers over the ``model`` axis — the port of
``znicz_tpu/parallel/tp.py`` (Megatron column/row pattern) on a mesh
axis handle (``parallel/mesh.py``).

- ``column_parallel``: W sharded on the output dim; each rank computes
  its slice of the features.  No communication.
- ``row_parallel``: W sharded on the input dim, activation
  feature-sharded from the previous column layer; the partial products
  are summed back to replicated over the ``model`` group by
  :func:`psum`.

``torch.distributed`` collectives carry no autograd, so :func:`psum` is
a ``torch.autograd.Function``: an all-reduce forward and an all-reduce
backward.  That is the reference's ``lax.psum`` under ``shard_map``
with replication checking off (``znicz_tpu/parallel/compat.py``), whose
transpose is again a ``psum``: the cotangent of a rank's partial is the
sum of every rank's cotangent of the replicated result.  Megatron's
pair (identity forward / all-reduce backward before the column layer,
all-reduce forward / identity backward after the row layer) computes
the one-device gradient instead; the reference's, held by the parity
tests against the JAX step, is this one (ROADMAP.md "Divergences")."""

from __future__ import annotations

import torch


class _Psum(torch.autograd.Function):
    """Sum over ``axis``, forward and backward (``lax.psum`` and its
    transpose)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.clone()), None


def psum(x, axis):
    """``x`` summed over the line of ``axis`` (a mesh axis handle, or
    None for no axis), differentiable: the backward sums the cotangents
    over the same line."""
    if axis is None or axis.group is None:
        return x
    return _Psum.apply(x, axis)


def column_parallel(x, w_local, b_local=None):
    """x replicated ``(..., d_in)``; w_local ``(d_in, d_out/tp)`` ->
    feature-sharded ``(..., d_out/tp)``."""
    y = x @ w_local
    if b_local is not None:
        y = y + b_local
    return y


def row_parallel(x_local, w_local, b=None, axis=None):
    """x_local feature-sharded ``(..., d_in/tp)``; w_local
    ``(d_in/tp, d_out)`` -> replicated ``(..., d_out)`` via one
    :func:`psum` over ``axis``.  ``b`` must be replicated (added once,
    after the reduce)."""
    y = psum(x_local @ w_local, axis)
    if b is not None:
        y = y + b
    return y


def mlp(x, w1_local, b1_local, w2_local, b2, act, axis=None):
    """Megatron MLP: column-parallel + activation + row-parallel."""
    return row_parallel(act(column_parallel(x, w1_local, b1_local)),
                        w2_local, b2, axis)
