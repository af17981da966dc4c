"""Pipeline parallelism over the ``pipe`` mesh axis — the port of
``znicz_tpu/parallel/pipeline.py`` (GPipe microbatch rotation as one
SPMD program) on a mesh axis handle (``parallel/mesh.py``).

Every rank runs the same loop of ``n_micro + S - 1`` ticks; rank ``s``
of the ``pipe`` line applies stage ``s``'s params.  At tick ``t`` stage
0 takes microbatch ``min(t, n_micro - 1)``, every stage applies its
stage to what it holds, the last stage emits its result (finished
microbatch ``t - (S - 1)``) and each stage hands its result one stage
forward (``ppermute``: one ``batch_isend_irecv`` a tick).  The bubble is
the standard ``S - 1`` ticks.  The emitted results (zeros off the last
stage) are summed over ``pipe`` with ``tp.psum``, the reference's
``psum`` with its transpose, so every stage returns them.

Each rotation is a ``torch.autograd.Function`` whose backward hands the
cotangent one stage back (``lax.ppermute``'s transpose).  Every rank
must join every backward rotation, as its neighbours wait for it, so
nothing a rank drops leaves autograd's graph: stage 0 replaces what it
received with the feed through :class:`_TakeFeed` and the other stages
emit their zeros through :class:`_Zeros`, each giving what it drops a
zero cotangent (the reference's ``where``).  Each rank's rotations then
run backward in tick order, one tick's after the next one's.

One divergence from the reference: the rotation after the last tick,
which its ``scan`` makes and never reads, is not made (as the ring's in
``parallel/ring_attention.py``).
"""

from __future__ import annotations

import torch

from znicz_tpu_torch.parallel import tp


class _Rotate(torch.autograd.Function):
    """``y`` to the next stage, the previous stage's received; the
    backward the other way round."""

    @staticmethod
    def forward(ctx, axis, y):
        ctx.axis = axis
        return axis.ppermute([y], 1)[0]

    @staticmethod
    def backward(ctx, g):
        return None, ctx.axis.ppermute([g.contiguous()], -1)[0]


class _TakeFeed(torch.autograd.Function):
    """Stage 0's input: the feed, the received activation dropped with a
    zero cotangent (so its rotation's backward still runs)."""

    @staticmethod
    def forward(ctx, feed, received):
        return feed.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


class _Zeros(torch.autograd.Function):
    """``n`` zero blocks of ``y``'s shape in place of a non-last stage's
    emissions, ``y`` kept in the graph with a zero cotangent."""

    @staticmethod
    def forward(ctx, y, n):
        return y.new_zeros((n,) + tuple(y.shape))

    @staticmethod
    def backward(ctx, g):
        return g.new_zeros(g.shape[1:]), None


def pipeline_ticks(stage_fn, stage_params, xs, axis):
    """This stage's part of the schedule -> ``(n_micro, mb, d)``: the
    finished microbatches on the last stage, zeros on the others.
    ``axis`` is the ``pipe`` handle, or a stand-in with ``size``,
    ``index`` and a ``ppermute(tensors, shift)`` of its own that hands
    over what the previous stage sent at this tick."""
    n_stages, stage = axis.size, axis.index
    n_micro = xs.shape[0]
    n_ticks = n_micro + n_stages - 1
    act = torch.zeros_like(xs[0])
    emitted = []
    for t in range(n_ticks):
        feed = xs[min(t, n_micro - 1)]
        if stage == 0:
            act = feed if t == 0 or n_stages == 1 else \
                _TakeFeed.apply(feed, act)
        y = stage_fn(stage_params, act)
        if stage == n_stages - 1 and t >= n_stages - 1:
            emitted.append(y)
        if t < n_ticks - 1 and n_stages > 1:
            act = _Rotate.apply(axis, y)
    if stage != n_stages - 1:
        return _Zeros.apply(y, n_micro)
    return torch.stack(emitted)


def pipeline_apply(stage_fn, stage_params, xs, axis):
    """Run ``n_micro`` microbatches through the stage pipeline over the
    ``pipe`` handle ``axis`` (``axis.size`` stages, this rank stage
    ``axis.index``).

    - ``stage_fn(params, x) -> y``: one stage's compute, ``(mb, d) ->
      (mb, d)`` on every stage;
    - ``stage_params``: this rank's stage params (the caller's block of
      a stage-stacked pytree sharded over ``pipe``);
    - ``xs``: ``(n_micro, mb, d)`` microbatches, the same on every stage.

    Returns ``(n_micro, mb, d)`` on every stage (``tp.psum`` over
    ``axis``)."""
    return tp.psum(pipeline_ticks(stage_fn, stage_params, xs, axis), axis)
