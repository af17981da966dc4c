"""Pooling forward units — the port of ``znicz_tpu/units/pooling.py``
(rebuild of veles.znicz pooling.py :: Pooling, OffsetPooling, MaxPooling,
MaxAbsPooling, AvgPooling).

Max and stochastic variants record the winner's flat input offset per
output element into ``input_offset`` (reference behavior) for the eager
backward scatter.  Max and average pooling are plain torch on the device,
as the reference keeps them on XLA (no TPU kernel).  Stochastic pooling
(reference: StochasticPooling, StochasticAbsPooling) samples through the
hand-written kernel (``kernels/pooling.py stochastic_pool``) in train
mode — its plain version on CPU tensors — with a seed drawn from the
host prng stream per forward, the reference's route under
``engine.pallas`` (``units/pooling.py:212-234``); in ``forward_mode`` it
returns the probability-weighted expectation in plain torch.

``torch_apply`` is the fused step's forward, the reference's
``xla_apply``: the tap forms of ``ops/pooling.py`` with their custom
backwards, no offsets.  A stochastic unit in a train step draws its
uniforms from the step's generator and samples in plain torch, as the
reference's fused route is jnp; at eval it takes the expectation.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.kernels import pooling as kpool
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.units.nn_units import Forward


class Pooling(Forward):
    """Geometry base (reference: pooling.py :: Pooling)."""

    MAPPING: set = set()

    def __init__(self, workflow=None, kx=2, ky=2, sliding=None,
                 **kwargs) -> None:
        super().__init__(workflow, include_bias=False, **kwargs)
        self.kx, self.ky = int(kx), int(ky)
        if sliding is None:
            sliding = (self.ky, self.kx)
        self.sliding = (sliding, sliding) if isinstance(sliding, int) \
            else tuple(sliding)

    @property
    def sy(self) -> int:
        return self.sliding[0]

    @property
    def sx(self) -> int:
        return self.sliding[1]

    def output_shape_for(self, in_shape):
        n, h, w, c = in_shape
        return (n, pool_ops.pool_out_size(h, self.ky, self.sy),
                pool_ops.pool_out_size(w, self.kx, self.sx), c)

    def _common_init(self, **kwargs) -> None:
        in_shape = self.input.shape
        if len(in_shape) != 4:
            raise ValueError(f"Pooling wants NHWC input, got {in_shape}")
        out_shape = self.output_shape_for(in_shape)
        if not self.output or self.output.shape != out_shape:
            self.output.reset(shape=out_shape)
        self.init_array(self.input, self.output)


class OffsetPooling(Pooling):
    """Pooling that records winner offsets (reference: OffsetPooling)."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.input_offset = Array()

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        out_shape = self.output.shape
        if not self.input_offset or self.input_offset.shape != out_shape:
            self.input_offset.reset(shape=out_shape, dtype=np.int32)
        self.init_array(self.input_offset)


class MaxPooling(OffsetPooling):
    """Max pooling (reference: MaxPooling)."""

    MAPPING = {"max_pooling"}
    USE_ABS = False

    def _run(self, xp, x):
        return pool_ops.max_forward(xp, x, self.ky, self.kx, self.sy,
                                    self.sx, use_abs=self.USE_ABS)

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        fast = pool_ops.maxabs_forward_fast if self.USE_ABS \
            else pool_ops.max_forward_fast
        return fast(x, self.ky, self.kx, self.sy, self.sx)

    def numpy_run(self) -> None:
        y, off = self._run(np, self.input.mem)
        self.output.map_invalidate()
        self.output.mem = y
        self.input_offset.map_invalidate()
        self.input_offset.mem = off

    def torch_run(self) -> None:
        self.input.unmap()
        y, off = self._run(torch, self.input.devmem)
        self.output.set_devmem(y.contiguous())
        self.input_offset.set_devmem(off)


class MaxAbsPooling(MaxPooling):
    """Max-|x| pooling emitting the signed winner (reference:
    MaxAbsPooling)."""
    MAPPING = {"maxabs_pooling"}
    USE_ABS = True


class AvgPooling(Pooling):
    """Average pooling (reference: AvgPooling); border windows divide by
    the clipped element count."""

    MAPPING = {"avg_pooling"}

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        return pool_ops.avg_forward_fast(x, self.ky, self.kx, self.sy,
                                         self.sx)

    def numpy_run(self) -> None:
        self.output.map_invalidate()
        self.output.mem = pool_ops.avg_forward(
            np, self.input.mem, self.ky, self.kx, self.sy, self.sx)

    def torch_run(self) -> None:
        self.input.unmap()
        self.output.set_devmem(pool_ops.avg_forward(
            torch, self.input.devmem, self.ky, self.kx, self.sy, self.sx))


class StochasticPooling(OffsetPooling):
    """Stochastic pooling, winner ~ p(x_i) = x_i+ / sum (reference:
    StochasticPooling; Zeiler & Fergus 2013)."""

    MAPPING = {"stochastic_pooling"}
    USE_ABS = False
    NEEDS_RNG = True

    def _uniform_host(self, shape):
        return prng.get().uniform(0.0, 1.0, shape).astype(np.float32)

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        if train:
            u = self.draw_uniform(rng, self.output_shape_for(x.shape),
                                  x.device)
            return pool_ops.stochastic_forward_fast(
                x, u, self.ky, self.kx, self.sy, self.sx, self.USE_ABS)
        y, _ = pool_ops.stochastic_forward(
            torch, x, self.ky, self.kx, self.sy, self.sx, None,
            self.USE_ABS, train=False)
        return y

    def numpy_run(self) -> None:
        train = not self.forward_mode
        u = self._uniform_host(self.output.shape) if train else None
        y, off = pool_ops.stochastic_forward(
            np, self.input.mem, self.ky, self.kx, self.sy, self.sx, u,
            self.USE_ABS, train=train)
        self.output.map_invalidate()
        self.output.mem = y
        if off is not None:
            self.input_offset.map_invalidate()
            self.input_offset.mem = off

    def _random(self) -> dict:
        """The kernel's random operand for one train forward: a seed drawn
        from the host stream, one per forward as the reference draws it
        (``units/pooling.py:216``)."""
        return {"seed": int(prng.get().randint(0, 2 ** 31))}

    def torch_run(self) -> None:
        self.input.unmap()
        x = self.input.devmem
        if self.forward_mode:
            y, _ = pool_ops.stochastic_forward(
                torch, x, self.ky, self.kx, self.sy, self.sx, None,
                self.USE_ABS, train=False)
            self.output.set_devmem(y.contiguous())
            return
        y, off = kpool.stochastic_pool(x, self.ky, self.kx, self.sy,
                                       self.sx, self.USE_ABS,
                                       **self._random())
        self.output.set_devmem(y)
        self.input_offset.set_devmem(off)


class StochasticAbsPooling(StochasticPooling):
    """Stochastic pooling over |x| (reference: StochasticAbsPooling)."""
    MAPPING = {"stochastic_abs_pooling"}
    USE_ABS = True
