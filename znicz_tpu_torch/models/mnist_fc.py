"""MNIST fully-connected workflow — the port of
``znicz_tpu/models/mnist_fc.py`` (reference: veles.znicz samples/MNIST —
All2AllTanh -> All2AllSoftmax, the canonical first sample).

Two execution shapes over the same units:

- ``build_eager``: the reference-style control graph where every unit runs
  its own backend path per minibatch (numpy oracle, or per-unit torch:
  the ``gemm_fc`` and ``act_backward`` kernels on the card);
- ``build_fused``: the accelerated segment collapsed into one
  ``FusedTrainStep`` (``parallel/step.py``: the update kernels on the
  card), on one device or data-parallel over a ``torch.distributed``
  world.

Datasets: seeded synthetic MNIST-shaped blobs; weights come from the
``prng`` streams (or from ``units/nn_units.py load_forward_params``).
``build_fused`` has the reference's signature and passes ``mesh``,
``shard_update``, ``shard_params``, ``quantized_collectives`` and
``anatomy`` (the step's phase accounting) through to the step.  Gradient accumulation, EMA and ``pipeline_depth`` (the input
pipeline with the step's stager) run as the reference's do; on the card
every step is a CUDA graph replay.
"""

from __future__ import annotations

from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.plumbing import Repeater
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from znicz_tpu_torch.parallel.step import FusedTrainStep
from znicz_tpu_torch.units.all2all import All2AllSoftmax, All2AllTanh
from znicz_tpu_torch.units.decision import DecisionGD
from znicz_tpu_torch.units.evaluator import EvaluatorSoftmax
from znicz_tpu_torch.units.gd import GDSoftmax, GDTanh
from znicz_tpu_torch.units.nn_units import NNWorkflow


def _make_loader(w, minibatch_size: int, n_train: int, n_valid: int):
    return SyntheticClassifierLoader(
        w, n_classes=10, sample_shape=(28, 28), n_train=n_train,
        n_valid=n_valid, minibatch_size=minibatch_size, spread=2.5, noise=1.0)


def _make_units(w, layers=(64,), lr=0.05, moment=0.9):
    """Create forwards/evaluator/decision/gds (unwired)."""
    forwards = []
    for width in layers:
        forwards.append(All2AllTanh(w, output_sample_shape=width,
                                    name=f"fc{len(forwards)}"))
    forwards.append(All2AllSoftmax(w, output_sample_shape=10, name="softmax"))
    ev = EvaluatorSoftmax(w)
    gds = []
    for i, fwd in enumerate(forwards):
        cls = GDSoftmax if isinstance(fwd, All2AllSoftmax) else GDTanh
        gds.append(cls(w, learning_rate=lr, gradient_moment=moment,
                       name=f"gd{i}"))
    return forwards, ev, gds


def build_eager(max_epochs=4, layers=(64,), lr=0.05, moment=0.9,
                minibatch_size=50, n_train=600, n_valid=200,
                loader=None) -> NNWorkflow:
    """Reference-style per-unit control graph."""
    w = NNWorkflow(name="MnistFC")
    w.repeater = Repeater(w)
    w.loader = loader or _make_loader(w, minibatch_size, n_train, n_valid)
    forwards, ev, gds = _make_units(w, layers, lr, moment)
    w.forwards, w.evaluator, w.gds = forwards, ev, gds
    dec = w.decision = DecisionGD(w, max_epochs=max_epochs)

    w.repeater.link_from(w.start_point)
    w.loader.link_from(w.repeater)
    prev = w.loader
    for fwd in forwards:
        fwd.link_from(prev)
        prev = fwd
    ev.link_from(prev)
    dec.link_from(ev)
    prev = dec
    for fwd, gd in reversed(list(zip(forwards, gds))):
        gd.link_from(prev)
        gd.gate_skip = Bool(
            lambda: int(w.loader.minibatch_class) != TRAIN)
        prev = gd
    w.repeater.link_from(prev)
    w.end_point.link_from(prev)
    w.end_point.gate_block = ~dec.complete

    # data links
    forwards[0].link_attrs(w.loader, ("input", "minibatch_data"))
    for a, b in zip(forwards, forwards[1:]):
        b.link_attrs(a, ("input", "output"))
    ev.link_attrs(forwards[-1], "output", "max_idx")
    ev.link_attrs(w.loader, ("labels", "minibatch_labels"),
                  ("batch_size", "minibatch_size"))
    dec.link_attrs(w.loader, "minibatch_class", "last_minibatch",
                   "class_lengths", "epoch_number", "minibatch_size")
    dec.link_attrs(ev, ("minibatch_n_err", "n_err"))
    dec.evaluator = ev
    down = ev
    for fwd, gd in reversed(list(zip(forwards, gds))):
        gd.link_from_forward(fwd)
        if down is ev:
            gd.link_attrs(down, "err_output")
        else:
            gd.link_attrs(down, ("err_output", "err_input"))
        gd.link_attrs(w.loader, ("batch_size", "minibatch_size"))
        down = gd
    return w


def build_fused(max_epochs=4, layers=(64,), lr=0.05, moment=0.9,
                minibatch_size=64, n_train=640, n_valid=192,
                mesh=None, loader=None, optimizer="sgd",
                optimizer_config=None, shard_update=False,
                shard_params=False, accumulate_steps=1, ema_decay=None,
                quantized_collectives=None,
                pipeline_depth=None, anatomy=None) -> NNWorkflow:
    """Repeater -> Loader -> FusedTrainStep -> Decision."""
    w = NNWorkflow(name="MnistFC-fused")
    w.repeater = Repeater(w)
    w.loader = loader or _make_loader(w, minibatch_size, n_train, n_valid)
    forwards, ev, gds = _make_units(w, layers, lr, moment)
    w.forwards, w.evaluator, w.gds = forwards, ev, gds
    step = w.step = FusedTrainStep(
        w, forwards=forwards, evaluator=ev, gds=gds, loader=w.loader,
        mesh=mesh, optimizer=optimizer,
        optimizer_config=optimizer_config, shard_update=shard_update,
        shard_params=shard_params,
        accumulate_steps=accumulate_steps, ema_decay=ema_decay,
        quantized_collectives=quantized_collectives,
        anatomy=anatomy, name="FusedStep")
    dec = w.decision = DecisionGD(w, max_epochs=max_epochs)

    w.repeater.link_from(w.start_point)
    w.loader.link_from(w.repeater)
    step.link_from(w.loader)
    dec.link_from(step)
    w.repeater.link_from(dec)
    w.end_point.link_from(dec)
    w.end_point.gate_block = ~dec.complete

    # the segment units stay OUT of the control graph (the step subsumes
    # them) but their Arrays need allocation: the step initializes them
    forwards[0].link_attrs(w.loader, ("input", "minibatch_data"))
    for a, b in zip(forwards, forwards[1:]):
        b.link_attrs(a, ("input", "output"))
    ev.link_attrs(forwards[-1], "output", "max_idx")
    ev.link_attrs(w.loader, ("labels", "minibatch_labels"),
                  ("batch_size", "minibatch_size"))
    for fwd, gd in zip(forwards, gds):
        gd.link_from_forward(fwd)
        gd.link_attrs(w.loader, ("batch_size", "minibatch_size"))
    gds[-1].link_attrs(ev, "err_output")
    for up, down in zip(gds, gds[1:]):
        up.link_attrs(down, ("err_output", "err_input"))

    dec.link_attrs(w.loader, "minibatch_class", "last_minibatch",
                   "class_lengths", "epoch_number")
    # the sample count behind the class-pass metrics comes from the step
    dec.link_attrs(step, ("minibatch_n_err", "n_err"), "minibatch_size")
    if pipeline_depth:
        # async input pipeline: the host serve of batch k+1 and its copy
        # to the device overlap the compute of batch k
        from znicz_tpu_torch.pipeline import attach_prefetcher
        attach_prefetcher(w.loader, stager=step.make_stager(),
                          depth=pipeline_depth)
    return w
