"""Bernoulli RBM workflow via CD-1 — the port of ``znicz_tpu/models/
rbm.py`` (a copy, under the drift check of
``tests/test_torch_port_isolation.py``; reference: veles.znicz rbm sample
over rbm_units.py building blocks).  On a ``TorchDevice`` the three
All2AllSigmoid products run on the ``gemm_fc`` kernel, ``h2v`` reading the
shared ``(nv, nh)`` weights transposed through its ``trans_b`` flag.

Chain per minibatch: v0 -> h0_prob (All2AllSigmoid, shared W + hbias) ->
Binarization -> v1_prob (All2AllSigmoid, Wᵀ + vbias) -> h1_prob;
positive/negative BatchWeights -> GradientsCalculator -> WeightsUpdater on
train minibatches; EvaluatorMSE(v1_prob vs v0) + DecisionMSE track
reconstruction error per epoch.
"""

from __future__ import annotations

from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.plumbing import Repeater
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from znicz_tpu_torch.units.all2all import All2AllSigmoid
from znicz_tpu_torch.units.decision import DecisionMSE
from znicz_tpu_torch.units.evaluator import EvaluatorMSE
from znicz_tpu_torch.units.nn_units import NNWorkflow
from znicz_tpu_torch.units.rbm import (BatchWeights, Binarization,
                                 GradientsCalculator, WeightsUpdater)


def build(max_epochs: int = 5, n_hidden: int = 32, minibatch_size: int = 25,
          n_train: int = 300, n_valid: int = 100, sample_shape=(16,),
          learning_rate: float = 0.05, gradient_moment: float = 0.5
          ) -> NNWorkflow:
    w = NNWorkflow(name="RBM")
    w.repeater = Repeater(w)
    loader = w.loader = SyntheticClassifierLoader(
        w, n_classes=4, sample_shape=tuple(sample_shape), n_train=n_train,
        n_valid=n_valid, minibatch_size=minibatch_size, spread=1.0,
        noise=0.3)

    v2h = All2AllSigmoid(w, output_sample_shape=n_hidden, name="v2h")
    binz = Binarization(w, name="binarize")
    h2v = All2AllSigmoid(w, weights_transposed=True, name="h2v",
                         output_sample_shape=int(sample_shape[0]))
    h2v2 = All2AllSigmoid(w, output_sample_shape=n_hidden, name="v2h_neg")
    pos = BatchWeights(w, name="pos_stats")
    neg = BatchWeights(w, name="neg_stats")
    grads = GradientsCalculator(w, name="cd_grads")
    upd = WeightsUpdater(w, learning_rate=learning_rate,
                         gradient_moment=gradient_moment, name="update")
    ev = w.evaluator = EvaluatorMSE(w)
    dec = w.decision = DecisionMSE(w, max_epochs=max_epochs)
    w.forwards = [v2h]
    w.gds = []

    # control chain
    w.repeater.link_from(w.start_point)
    loader.link_from(w.repeater)
    v2h.link_from(loader)
    binz.link_from(v2h)
    h2v.link_from(binz)
    h2v2.link_from(h2v)
    ev.link_from(h2v2)
    dec.link_from(ev)
    for u in (pos, neg, grads, upd):
        u.gate_skip = Bool(lambda: int(loader.minibatch_class) != TRAIN)
    pos.link_from(dec)
    neg.link_from(pos)
    grads.link_from(neg)
    upd.link_from(grads)
    w.repeater.link_from(upd)
    w.end_point.link_from(upd)
    w.end_point.gate_block = ~dec.complete

    # data links
    v2h.link_attrs(loader, ("input", "minibatch_data"))
    binz.link_attrs(v2h, ("input", "output"))
    h2v.link_attrs(binz, ("input", "output"))
    h2v.link_attrs(v2h, "weights")        # shared W (transposed use)
    h2v2.link_attrs(h2v, ("input", "output"))
    h2v2.link_attrs(v2h, "weights", "bias")
    ev.link_attrs(h2v, "output")
    ev.link_attrs(loader, ("target", "minibatch_data"),
                  ("batch_size", "minibatch_size"))
    dec.link_attrs(loader, "minibatch_class", "last_minibatch",
                   "class_lengths", "epoch_number", "minibatch_size")
    dec.link_attrs(ev, ("minibatch_mse", "mse"))

    pos.link_attrs(loader, ("v", "minibatch_data"),
                   ("batch_size", "minibatch_size"))
    pos.link_attrs(v2h, ("h", "output"))
    neg.link_attrs(h2v, ("v", "output"))
    neg.link_attrs(h2v2, ("h", "output"))
    grads.pos, grads.neg = pos, neg
    grads.link_attrs(loader, ("batch_size", "minibatch_size"))
    upd.gradients = grads
    upd.link_attrs(v2h, "weights", ("hbias", "bias"))
    upd.link_attrs(h2v, ("vbias", "bias"))
    return w


def run(load, main):
    load(build)
    main()
