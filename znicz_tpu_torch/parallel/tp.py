"""Tensor-parallel linear layers over the ``model`` axis — the
counterpart of ``znicz_tpu/parallel/tp.py`` (Megatron column/row
pattern), on one device for now.

- ``column_parallel``: W sharded on the output dim; each device computes
  its slice of the features.  No communication.
- ``row_parallel``: W sharded on the input dim, activation
  feature-sharded from the previous column layer; partial products are
  summed back to replicated over the ``model`` group.

The port runs a single device, where the sum over a one-member
``model`` group is the identity, so ``row_parallel`` is the local
product; the names stay so the multi-GPU slice adds the group and the
all-reduce (``torch.distributed``) here."""

from __future__ import annotations


def column_parallel(x, w_local, b_local=None):
    """x replicated ``(..., d_in)``; w_local ``(d_in, d_out/tp)`` ->
    feature-sharded ``(..., d_out/tp)``."""
    y = x @ w_local
    if b_local is not None:
        y = y + b_local
    return y


def row_parallel(x_local, w_local, b=None):
    """x_local feature-sharded ``(..., d_in/tp)``; w_local
    ``(d_in/tp, d_out)`` -> replicated ``(..., d_out)``.  On one device
    the sum over ``model`` is the identity, so this is the local
    product; ``b`` is added once, after the (future) reduce."""
    return column_parallel(x_local, w_local, b)


def mlp(x, w1_local, b1_local, w2_local, b2, act):
    """Megatron MLP: column-parallel + activation + row-parallel."""
    return row_parallel(act(column_parallel(x, w1_local, b1_local)),
                        w2_local, b2)
