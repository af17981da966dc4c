"""Kohonen SOM demo workflow — the port of ``znicz_tpu/models/kohonen.py``
(reference: veles.znicz samples/DemoKohonen/kohonen.py — unsupervised SOM
on 2-D point clouds).  The same graph and arguments; on a
``TorchDevice`` every SOM step runs ``kernels/kohonen.py som_step``.

Control graph: Repeater -> Loader -> KohonenTrainer -> KohonenDecision ->
Repeater, with a KohonenForward (shared weights) serving winner maps for
the plotters after training.
"""

from __future__ import annotations

from znicz_tpu_torch.core.plumbing import Repeater
from znicz_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from znicz_tpu_torch.units.kohonen import (KohonenDecision,
                                           KohonenForward, KohonenTrainer)
from znicz_tpu_torch.units.nn_units import NNWorkflow


def build(max_epochs: int = 10, shape=(8, 8), minibatch_size: int = 50,
          n_train: int = 500, sample_shape=(2,), alpha: float = 0.5,
          radius_decay: float = 0.9, min_delta: float = 1e-4) -> NNWorkflow:
    w = NNWorkflow(name="KohonenDemo")
    w.repeater = Repeater(w)
    # SOM demo data: unlabeled point clouds (labels unused by training)
    w.loader = SyntheticClassifierLoader(
        w, n_classes=4, sample_shape=tuple(sample_shape), n_train=n_train,
        n_valid=0, minibatch_size=minibatch_size, spread=3.0, noise=0.5)
    trainer = w.trainer = KohonenTrainer(
        w, shape=shape, alpha=alpha, radius_decay=radius_decay)
    # enables epoch-scan mode (root.common.engine.scan_epoch): one host
    # loop of SOM steps per class pass over the device-pinned dataset
    trainer.loader = w.loader
    fwd = w.forward = KohonenForward(w, shape=shape)
    dec = w.decision = KohonenDecision(w, max_epochs=max_epochs,
                                       min_delta=min_delta)
    w.forwards = [trainer]   # snapshot inventory slot
    w.gds = []

    w.repeater.link_from(w.start_point)
    w.loader.link_from(w.repeater)
    trainer.link_from(w.loader)
    dec.link_from(trainer)
    w.repeater.link_from(dec)
    w.end_point.link_from(dec)
    w.end_point.gate_block = ~dec.complete

    trainer.link_attrs(w.loader, ("input", "minibatch_data"),
                       ("batch_size", "minibatch_size"), "epoch_number",
                       "epoch_ended")
    fwd.link_attrs(w.loader, ("input", "minibatch_data"),
                   ("batch_size", "minibatch_size"))
    fwd.link_attrs(trainer, "weights")
    dec.link_attrs(w.loader, "minibatch_class", "last_minibatch",
                   "class_lengths", "epoch_number", "minibatch_size")
    dec.trainer = trainer
    return w


def run(load, main):
    load(build)
    main()
