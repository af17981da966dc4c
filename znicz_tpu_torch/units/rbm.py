"""RBM building blocks — the port of ``znicz_tpu/units/rbm.py`` (rebuild
of veles.znicz rbm_units.py :: Binarization, IterationCounter,
BatchWeights, GradientsCalculator, WeightsUpdater: the contrastive-
divergence components of the RBM sample).

The CD-1 chain the reference's rbm sample wires from these blocks:
v0 -> (All2AllSigmoid) h0_prob -> Binarization h0 -> reconstruct v1_prob
-> h1_prob;  BatchWeights of (v0, h0_prob) and (v1_prob, h1_prob) give the
positive/negative statistics, GradientsCalculator their difference,
WeightsUpdater the momentum SGD step on the shared weights/biases.

On a ``TorchDevice`` every block stays on the device: the statistics are
``torch.matmul`` (the reference's are one XLA product), the difference
and the update elementwise torch in the numpy path's order of
operations.  One divergence: ``Binarization`` draws its uniforms from
``prng.get().key(device)``, the port's ``torch.Generator``, where the
reference draws ``jax.random.uniform`` from its key — one seed gives the
two packages different binary states (tests inject the same numpy
uniforms into both).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.units import Unit


class Binarization(AcceleratedUnit):
    """Bernoulli-sample binary states from probabilities (reference:
    rbm_units.py :: Binarization); draws ride the framework PRNG."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.input = Array()
        self.output = Array()

    def _common_init(self, **kwargs) -> None:
        if not self.output or self.output.shape != self.input.shape:
            self.output.reset(shape=self.input.shape)
        self.init_array(self.input, self.output)

    def numpy_run(self) -> None:
        p = self.input.map_read()
        u = prng.get().uniform(0.0, 1.0, p.shape)
        self.output.map_invalidate()
        self.output.mem = (u < p).astype(np.float32)

    def draw_uniform(self, shape, device) -> torch.Tensor:
        """The one draw of a device run: uniforms in [0, 1) from a fresh
        generator of the default stream, as the reference takes a fresh
        key each run."""
        return torch.rand(tuple(shape), device=device,
                          generator=prng.get().key(device))

    def torch_run(self) -> None:
        p = self.input.devmem
        u = self.draw_uniform(p.shape, p.device)
        self.output.set_devmem((u < p).to(torch.float32))


class IterationCounter(Unit):
    """Counts firings; ``complete`` flips at ``max_iterations``
    (reference: rbm_units.py :: IterationCounter)."""

    def __init__(self, workflow=None, max_iterations: int = 0,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.max_iterations = int(max_iterations)
        self.iteration = 0
        self.complete = Bool(False)

    def reset(self) -> None:
        self.iteration = 0
        self.complete.set(False)

    def run(self) -> None:
        self.iteration += 1
        if self.max_iterations and self.iteration >= self.max_iterations:
            self.complete.set(True)


class BatchWeights(AcceleratedUnit):
    """Associations of a (visible, hidden) pair: ``vh = vᵀh``, plus bias
    sums (reference: rbm_units.py :: BatchWeights)."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.v = Array()
        self.h = Array()
        self.vh = Array()
        self.v_sum = Array()
        self.h_sum = Array()

    def _common_init(self, **kwargs) -> None:
        nv, nh = self.v.shape[1], self.h.shape[1]
        if not self.vh or self.vh.shape != (nv, nh):
            self.vh.reset(shape=(nv, nh))
            self.v_sum.reset(shape=(nv,))
            self.h_sum.reset(shape=(nh,))
        self.init_array(self.v, self.h, self.vh, self.v_sum, self.h_sum)

    @staticmethod
    def compute(xp, v, h):
        if xp is np:
            return v.T @ h, v.sum(axis=0), h.sum(axis=0)
        return torch.matmul(v.t(), h), v.sum(dim=0), h.sum(dim=0)

    def numpy_run(self) -> None:
        vh, vs, hs = self.compute(np, self.v.map_read(), self.h.map_read())
        for arr, val in ((self.vh, vh), (self.v_sum, vs), (self.h_sum, hs)):
            arr.map_invalidate()
            arr.mem = val

    def torch_run(self) -> None:
        vh, vs, hs = self.compute(torch, self.v.devmem, self.h.devmem)
        self.vh.set_devmem(vh)
        self.v_sum.set_devmem(vs)
        self.h_sum.set_devmem(hs)


class GradientsCalculator(AcceleratedUnit):
    """CD gradient = (positive - negative) statistics / batch_size
    (reference: rbm_units.py :: GradientsCalculator)."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.pos = None   # BatchWeights unit (data-linked)
        self.neg = None
        self.grad_weights = Array()
        self.grad_vbias = Array()
        self.grad_hbias = Array()

    def _common_init(self, **kwargs) -> None:
        if self.pos is None or self.neg is None:
            raise ValueError("GradientsCalculator needs pos/neg BatchWeights")
        if not self.grad_weights:
            self.grad_weights.reset(shape=self.pos.vh.shape)
            self.grad_vbias.reset(shape=self.pos.v_sum.shape)
            self.grad_hbias.reset(shape=self.pos.h_sum.shape)
        self.init_array(self.grad_weights, self.grad_vbias, self.grad_hbias)

    def _pairs(self):
        return ((self.grad_weights, self.pos.vh, self.neg.vh),
                (self.grad_vbias, self.pos.v_sum, self.neg.v_sum),
                (self.grad_hbias, self.pos.h_sum, self.neg.h_sum))

    def numpy_run(self) -> None:
        bs = float(self.current_batch_size(self.pos.v))
        for out, p, n in self._pairs():
            out.map_invalidate()
            out.mem = (p.map_read() - n.map_read()) / bs

    def torch_run(self) -> None:
        bs = float(self.current_batch_size(self.pos.v))
        for out, p, n in self._pairs():
            out.set_devmem((p.devmem - n.devmem) / bs)


class WeightsUpdater(AcceleratedUnit):
    """Momentum SGD step on the RBM parameters (reference: rbm_units.py ::
    WeightsUpdater).  ``weights`` is (nv, nh); the paired All2AllSigmoid
    units share it (v->h uses it directly, h->v transposed)."""

    def __init__(self, workflow=None, learning_rate: float = 0.1,
                 gradient_moment: float = 0.5, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.learning_rate = float(learning_rate)
        self.gradient_moment = float(gradient_moment)
        self.gradients = None    # GradientsCalculator (data-linked)
        self.weights = Array()
        self.vbias = Array()
        self.hbias = Array()
        self._vel = None

    def _common_init(self, **kwargs) -> None:
        if self._vel is None:
            self._vel = [np.zeros(a.shape, np.float32)
                         for a in (self.weights, self.vbias, self.hbias)]
        self.init_array(self.weights, self.vbias, self.hbias)

    def torch_init(self) -> None:
        # the velocities live beside the params on the device
        self._vel = [torch.as_tensor(v, dtype=torch.float32,
                                     device=self.weights.devmem.device)
                     for v in self._vel]

    def _triples(self):
        g = self.gradients
        return zip((self.weights, self.vbias, self.hbias),
                   (g.grad_weights, g.grad_vbias, g.grad_hbias), self._vel)

    def numpy_run(self) -> None:
        for arr, grad, vel in self._triples():
            vel *= self.gradient_moment
            vel += self.learning_rate * grad.map_read()
            arr.map_invalidate()
            arr.mem = arr.map_read() + vel

    def torch_run(self) -> None:
        for arr, grad, vel in self._triples():
            vel.mul_(self.gradient_moment)
            vel.add_(self.learning_rate * grad.devmem)
            arr.set_devmem(arr.devmem + vel)
