"""The fused step's modes in the port (``znicz_tpu_torch/parallel/step.py``)
against the JAX package on the CPU, at tiny widths:

- ``accumulate_steps``: 4 minibatches of 16 against the reference at the
  same settings (``tests/test_optimizers.py _accum_build``: tanh 12 ->
  softmax 4 on 64 unshuffled synthetic samples, 3 epochs), SGD and
  AdamW, and against the port's own 1 x 64; a ragged tail applies at the
  train pass's end;
- ``ema_decay``: ``ema_params()`` against the reference's and against an
  average tracked by hand;
- ``scan_epoch``: the class pass from its plan equals the per-minibatch
  path (a dropout layer included, so the step's generator is drawn), and
  the reference's scan; a pass entered mid-way falls through;
- the refusals (``train_steps`` and ``scan_epoch`` with accumulation),
  ``StandardWorkflow``'s ``fused=True`` checks, the hyperparameter
  buffer an LR change is written into in place, and the chaos hook's
  in-place poisoning;
- the step bodies that the card captures into CUDA graphs copy nothing
  from the host and read nothing back after their first call, for every
  model shape the port fuses (a copy or a sync is what a capture
  refuses).

The reference runs its Pallas update kernels in interpret mode
(``engine.pallas`` + ``pallas_interpret``); the port its plain twins.
The JAX run's initial weights cross into the port through
``load_forward_params`` and its shuffle stream's state after initialize.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.models import mnist_fc as jmnist
from znicz_tpu.standard_workflow import StandardWorkflow as JStandard

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.models import alexnet as talexnet
from znicz_tpu_torch.models import autoencoder as tautoencoder
from znicz_tpu_torch.models import cifar_conv as tcifar
from znicz_tpu_torch.models import mnist_conv as tmnist_conv
from znicz_tpu_torch.models import mnist_fc as tmnist
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.standard_workflow import StandardWorkflow as TStandard
from znicz_tpu_torch.units.nn_units import load_forward_params

#: port vs reference weights after accumulation, by optimizer: the bands
#: in force for the fused step (tests/test_torch_port_mnist.py
#: WEIGHT_ATOL): f32 on both sides, summation order only for SGD; AdamW
#: divides each gradient element by its RMS, so an element whose sum
#: nearly cancels moves by an order-dependent O(lr)
WEIGHT_ATOL = {"sgd": 1e-6, "adam": 2e-3}
#: port 4 x 16 against port 1 x 64: the reference's own band
#: (tests/test_optimizers.py:442): the same sums in another grouping
ACC_RTOL, ACC_ATOL = 2e-5, 1e-6
#: the averaged weights against the reference's and a hand-kept average
#: (tests/test_optimizers.py:548)
EMA_ATOL = 1e-6


@contextlib.contextmanager
def _scan_epoch(on):
    """``root.common.engine.scan_epoch`` in both packages (the models'
    switch for the epoch scan: neither StandardWorkflow takes it)."""
    jroot.common.engine.scan_epoch = troot.common.engine.scan_epoch = on
    try:
        yield
    finally:
        jroot.common.engine.scan_epoch = False
        troot.common.engine.scan_epoch = False


def _with_pallas(fn):
    jroot.common.engine.pallas = True
    jroot.common.engine.pallas_interpret = True
    try:
        return fn()
    finally:
        jroot.common.engine.pallas = False
        jroot.common.engine.pallas_interpret = False


def _accum_layers():
    hyper = {"learning_rate": 0.05, "learning_rate_bias": 0.05,
             "gradient_moment": 0.9, "gradient_moment_bias": 0.9}
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 12},
             "<-": dict(hyper)},
            {"type": "softmax", "->": {"output_sample_shape": 4},
             "<-": dict(hyper)}]


def _accum_build(cls, minibatch, accumulate, optimizer="sgd", n_train=64,
                 max_epochs=3, **kw):
    return cls(name="AccWf", loss_function="softmax",
               layers=_accum_layers(), loader_name="synthetic_classifier",
               loader_config={"n_classes": 4, "sample_shape": (6,),
                              "n_train": n_train, "n_valid": 0,
                              "minibatch_size": minibatch,
                              "shuffle_limit": 0},
               decision_config={"max_epochs": max_epochs},
               optimizer=optimizer, accumulate_steps=accumulate, **kw)


def _jax_side(make, seed, run=True):
    """The reference's workflow from ``make()``, initialized (and run)
    with the Pallas kernels in interpret mode -> (workflow, initial
    params, the prng state after initialize)."""
    def go():
        jprng.seed_all(seed)
        w = make()
        w.initialize(device=TPUDevice())
        params = [{"w": f.weights.map_read().copy(),
                   "b": f.bias.map_read().copy()} for f in w.forwards]
        state = jprng.get().state_dict()
        if run:
            w.run()
            w.step.sync_to_units()
        return w, params, state
    return _with_pallas(go)


def _port_side(make, seed, params=None, state=None, run=True):
    tprng.seed_all(seed)
    w = make()
    if params is not None:
        load_forward_params(w.forwards, params)
    w.initialize(device=TorchDevice("cpu"))
    if state is not None:
        tprng.get().load_state_dict(state)
    if run:
        w.run()
        w.step.sync_to_units()
    return w


def _weights(w):
    return [np.asarray(a.map_read()).copy() for f in w.forwards
            for a in (f.weights, f.bias) if a]


# -- accumulate_steps -------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_accumulation_matches_jax(optimizer):
    """4 x 16 with the update every 4 minibatches, port against the
    reference at the same settings: identical n_err histories, weights
    within the band of the optimizer."""
    jw, params, state = _jax_side(
        lambda: _accum_build(JStandard, 16, 4, optimizer), 61)
    tw = _port_side(lambda: _accum_build(TStandard, 16, 4, optimizer), 61,
                    params, state)
    assert tw.decision.metrics_history == jw.decision.metrics_history
    assert tw.step._grad_acc is None and jw.step._grad_acc is None
    for got, want in zip(_weights(tw), _weights(jw)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=WEIGHT_ATOL[optimizer])


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_accumulation_matches_big_minibatch(optimizer):
    """Accumulating 4 minibatches of 16 applies the same updates as one
    minibatch of 64 over the same unshuffled data."""
    weights = {}
    for minibatch, accumulate in ((64, 1), (16, 4)):
        w = _port_side(lambda: _accum_build(TStandard, minibatch,
                                            accumulate, optimizer), 61)
        assert w.step._grad_acc is None        # nothing left pending
        weights[accumulate] = _weights(w)
    for a, b in zip(weights[1], weights[4]):
        np.testing.assert_allclose(b, a, rtol=ACC_RTOL, atol=ACC_ATOL)


def test_accumulation_ragged_tail_applies_at_pass_end():
    """48 samples in minibatches of 16 with N = 4: the pass ends after 3
    half-steps, and their sum is applied there, not carried into the
    next epoch."""
    w = _port_side(lambda: _accum_build(TStandard, 16, 4, n_train=48,
                                        max_epochs=1), 61, run=False)
    before = _weights(w)
    applied = []
    while not bool(w.loader.last_minibatch) or not applied:
        w.loader.run()
        w.step.run()
        applied.append(w.step._acc_count)
    assert applied == [1, 2, 0]
    assert w.step._grad_acc is None
    w.step.sync_to_units()
    assert all(not np.array_equal(a, b)
               for a, b in zip(before, _weights(w)))
    w4 = _port_side(lambda: _accum_build(TStandard, 16, 4, n_train=48,
                                         max_epochs=4), 61)
    hist = [h["metric_train"] for h in w4.decision.metrics_history]
    assert w4.step._grad_acc is None and hist[-1] < hist[0], hist


def test_accumulation_refusals():
    w = _port_side(lambda: _accum_build(TStandard, 16, 2), 61, run=False)
    x = torch.zeros((2, 16, 6))
    y = torch.zeros((2, 16), dtype=torch.int32)
    m = torch.ones((2, 16), dtype=torch.bool)
    with pytest.raises(ValueError, match="per-minibatch run"):
        w.step.train_steps(x, y, m)
    with _scan_epoch(True), pytest.raises(ValueError,
                                          match="disable scan_epoch"):
        _port_side(lambda: _accum_build(TStandard, 16, 2), 61, run=False)


@pytest.mark.parametrize("option", [{"accumulate_steps": 2},
                                    {"ema_decay": 0.9}])
def test_standard_workflow_keeps_fused_only_options_fused(option):
    """StandardWorkflow's ``fused=True`` checks stand as they were."""
    with pytest.raises(ValueError, match="requires fused=True"):
        TStandard(name="x", loss_function="softmax",
                  layers=[{"type": "softmax",
                           "->": {"output_sample_shape": 3}}],
                  loader_name="synthetic_classifier",
                  loader_config={"n_classes": 3, "sample_shape": (4,),
                                 "n_train": 30, "n_valid": 0,
                                 "minibatch_size": 30},
                  decision_config={"max_epochs": 1}, fused=False, **option)


# -- ema_decay --------------------------------------------------------------

def test_ema_matches_jax_and_manual_average():
    """ema_decay 0.8 over 5 minibatches: ew = d·ew + (1-d)·w after every
    update, seeded with the initial weights, against the reference's
    mirror and against the same average kept by hand from the weights
    after each step."""
    d = 0.8
    kw = dict(max_epochs=1, layers=(16,), minibatch_size=20, n_train=100,
              n_valid=0, ema_decay=d)

    def steps(w, params_of):
        manual = [p["w"].copy() for p in params_of(w)]
        for _ in range(5):
            w.loader.run()
            w.step.run()
            for i, p in enumerate(params_of(w)):
                manual[i] = d * manual[i] + (1 - d) * p["w"]
        return manual

    jw, params, state = _jax_side(lambda: jmnist.build_fused(**kw), 61,
                                  run=False)
    j_manual = _with_pallas(lambda: steps(jw, lambda w: [
        {"w": np.asarray(jax.device_get(leaf["w"]))}
        for leaf in w.step._params]))
    tw = _port_side(lambda: tmnist.build_fused(**kw), 61, params, state,
                    run=False)
    assert all("ew" in leaf and "eb" in leaf for leaf in tw.step._params)
    t_manual = steps(tw, lambda w: [{"w": leaf["w"].numpy().copy()}
                                    for leaf in w.step._params])
    ours, theirs = tw.step.ema_params(), jw.step.ema_params()
    assert len(ours) == len(theirs) == 2
    for i, (leaf, ref) in enumerate(zip(ours, theirs)):
        assert set(leaf) == {"w", "b"}
        np.testing.assert_allclose(leaf["w"], t_manual[i], rtol=0,
                                   atol=EMA_ATOL, err_msg=f"layer {i}")
        for k in ("w", "b"):
            np.testing.assert_allclose(leaf[k], ref[k], rtol=0,
                                       atol=EMA_ATOL, err_msg=f"{i}.{k}")
        np.testing.assert_allclose(j_manual[i], ref["w"], rtol=0,
                                   atol=EMA_ATOL)
    w = tmnist.build_fused(max_epochs=1)
    w.initialize(device=TorchDevice("cpu"))
    with pytest.raises(RuntimeError, match="ema_decay"):
        w.step.ema_params()


# -- scan_epoch -------------------------------------------------------------

def _scan_layers():
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 12},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
            {"type": "dropout", "->": {"dropout_ratio": 0.3}},
            {"type": "softmax", "->": {"output_sample_shape": 4},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}]


def _scan_build(cls, layers=None, n_train=70, n_valid=30, max_epochs=3):
    return cls(name="ScanWf", loss_function="softmax",
               layers=layers or _scan_layers(),
               loader_name="synthetic_classifier",
               loader_config={"n_classes": 4, "sample_shape": (6,),
                              "n_train": n_train, "n_valid": n_valid,
                              "minibatch_size": 16},
               decision_config={"max_epochs": max_epochs})


def test_scan_epoch_equals_the_per_minibatch_path():
    """3 epochs (a ragged last minibatch in both classes, a dropout layer
    drawing from the step's generator): the same histories, bit-identical
    weights, and the pass's plan consumed."""
    runs = {}
    for scan in (False, True):
        with _scan_epoch(scan):
            w = _port_side(lambda: _scan_build(TStandard), 13)
        assert w.step.scan_epoch is scan
        assert w.loader.capture_class_plan is scan
        runs[scan] = w
    assert runs[True].decision.metrics_history == \
        runs[False].decision.metrics_history
    for a, b in zip(_weights(runs[True]), _weights(runs[False])):
        np.testing.assert_array_equal(a, b)
    assert not runs[True].step._scan_in_flight


def test_scan_epoch_matches_jax():
    """The class pass from its plan against the reference's scan over the
    same plan, no layer drawing: identical n_err, weights within 1e-6."""
    layers = [spec for spec in _scan_layers() if spec["type"] != "dropout"]
    with _scan_epoch(True):
        jw, params, state = _jax_side(lambda: _scan_build(JStandard, layers),
                                      17)
        tw = _port_side(lambda: _scan_build(TStandard, layers), 17, params,
                        state)
    assert jw.step._scan_idx_fns and tw.step.scan_epoch
    assert tw.decision.metrics_history == jw.decision.metrics_history
    for got, want in zip(_weights(tw), _weights(jw)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=WEIGHT_ATOL["sgd"])


def test_scan_epoch_entered_mid_pass_falls_through():
    """A train pass entered at a non-zero offset runs minibatch by
    minibatch for the rest of it, as the per-minibatch path does."""
    ws = {}
    for scan in (False, True):
        with _scan_epoch(scan):
            w = _port_side(lambda: _scan_build(TStandard, n_valid=0,
                                               max_epochs=1), 13, run=False)
        w.loader.run()                 # the pass's first minibatch: skipped
        sums = []
        while True:
            w.loader.run()
            assert int(w.loader.minibatch_offset) > 0
            w.step.run()
            sums.append((w.step.n_err, w.step.minibatch_size))
            if bool(w.loader.last_minibatch):
                break
        assert not w.step._scan_in_flight
        w.step.sync_to_units()
        ws[scan] = (sums, _weights(w))
        # the deferred sums cover the minibatches this step ran
        assert sums[-1][1] == w.loader.class_lengths[TRAIN] - 16
    assert ws[True][0] == ws[False][0]
    for a, b in zip(ws[True][1], ws[False][1]):
        np.testing.assert_array_equal(a, b)


# -- the hyperparameter buffer and the chaos hook ---------------------------

def test_lr_change_lands_in_the_same_buffer():
    """An LR change between steps is written into the one device buffer
    the update kernels (and a graph's captured pointers) read: the same
    data_ptr, the new value, and the step that follows moves the weights
    by the new rate."""
    tprng.seed_all(23)
    w = tmnist.build_fused(max_epochs=1, layers=(8,), minibatch_size=16,
                           n_train=64, n_valid=0)
    w.initialize(device=TorchDevice("cpu"))
    step = w.step
    buf = step._hyper_buf
    ptr = buf.data_ptr()
    w.loader.run()
    step.run()
    assert float(step._hyper_views[0]["lr"]) == np.float32(0.05)
    for gd in w.gds:
        gd.learning_rate = 0.0
        gd.learning_rate_bias = 0.0
        gd.gradient_moment = 0.0
        gd.gradient_moment_bias = 0.0
    before = [leaf["w"].clone() for leaf in step._params]
    w.loader.run()
    step.run()
    assert step._hyper_buf is buf and buf.data_ptr() == ptr
    assert float(step._hyper_views[0]["lr"]) == 0.0
    assert float(step._hyper_views[1]["mom_b"]) == 0.0
    for leaf, b in zip(step._params, before):
        assert torch.equal(leaf["w"], b)       # lr 0, momentum 0


def test_chaos_hook_poisons_the_params_in_place():
    tprng.seed_all(29)
    w = tmnist.build_fused(max_epochs=1, layers=(8,), minibatch_size=16,
                           n_train=64, n_valid=0)
    w.initialize(device=TorchDevice("cpu"))
    ptrs = [t.data_ptr() for leaf in w.step._params for t in leaf.values()]
    params = w.step._params
    with faults.active(faults.FaultPlan().nan_at("step.params", 1)):
        w.loader.run()
        w.step.run()
    assert w.step._params is params
    assert [t.data_ptr() for leaf in params
            for t in leaf.values()] == ptrs
    assert all(torch.isnan(leaf["w"]).all() for leaf in params)


# -- the bodies a CUDA graph captures ---------------------------------------

class _NoHostTraffic(TorchFunctionMode):
    """Fails on what a CUDA graph capture refuses: a tensor made from
    host data (a host-to-device copy on the card) and a value read back
    to the host (a sync)."""

    MAKERS = {torch.tensor, torch.as_tensor}
    READS = {"item", "__bool__", "__int__", "__float__", "__index__",
             "tolist", "numpy", "cpu"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if (func in self.MAKERS and args and
                not isinstance(args[0], torch.Tensor)) or name in self.READS:
            raise AssertionError(f"{name} inside a captured step body")
        return func(*args, **(kwargs or {}))


def _bodies(w):
    """Every body the step dispatches, with inputs of the step's own
    shapes: (kind, body, inputs)."""
    step, loader = w.step, w.loader
    raw = torch.from_numpy(np.asarray(loader.minibatch_indices.mem))
    if step._dataset_dev is not None:
        batch = (raw,)
        x, y, m = step._batch(raw)
    else:
        lab = loader.minibatch_targets if loader.minibatch_targets \
            else loader.minibatch_labels
        x = torch.as_tensor(np.asarray(loader.minibatch_data.mem),
                            dtype=torch.float32)
        y = torch.from_numpy(np.asarray(lab.mem))
        m = raw >= 0
        batch = (raw, x, y)
    out = [("train", step._train_batch, batch),
           ("eval", step._eval_batch, batch),
           ("steps", step._train_step, (x, y, m))]
    if step.accumulate_steps > 1:
        out.append(("grads", step._grads_batch, batch))
    return out


def _mnist_fc(**kw):
    return lambda: tmnist.build_fused(max_epochs=1, layers=(8,),
                                      minibatch_size=16, n_train=32,
                                      n_valid=16, **kw)


def _mnist_fc_weighted():
    w = TStandard(name="w", loss_function="softmax",
                  layers=_scan_layers(),
                  loader_name="synthetic_classifier",
                  loader_config={"n_classes": 4, "sample_shape": (6,),
                                 "n_train": 32, "n_valid": 16,
                                 "minibatch_size": 16},
                  evaluator_config={"class_weights": [1.0, 2.0, 0.5, 1.0],
                                    "compute_confusion_matrix": True},
                  decision_config={"max_epochs": 1}, clip_norm=1.0)
    return w


def _mnist_conv_pools():
    """MNIST conv at narrow widths with a stochastic first pool and an
    avg second one (the pooling forms that use window constants)."""
    specs = copy.deepcopy(tmnist_conv.LAYERS)
    pools = iter(("stochastic_pooling", "avg_pooling"))
    for spec in specs:
        if spec["type"] == "max_pooling":
            spec["type"] = next(pools)
        elif spec["type"] == "conv_relu":
            spec["->"]["n_kernels"] //= 8
        elif spec["type"] == "all2all_relu":
            spec["->"]["output_sample_shape"] = 16
    return TStandard(name="pools", layers=specs, loss_function="softmax",
                     loader_name="synthetic_image",
                     loader_config={"n_classes": 10,
                                    "sample_shape": (28, 28, 1),
                                    "n_train": 20, "n_valid": 10,
                                    "minibatch_size": 10},
                     decision_config={"max_epochs": 1})


CAPTURED = {
    "mnist_fc_sgd_bf16": _mnist_fc(
        optimizer_config={"state_dtype": "bfloat16"}),
    "mnist_fc_adam_ema": _mnist_fc(optimizer="adam", ema_decay=0.9),
    "mnist_fc_accumulate": _mnist_fc(accumulate_steps=2),
    "weighted_dropout_clip": _mnist_fc_weighted,
    "alexnet_small": lambda: talexnet.build(
        input_size=67, n_classes=10, n_train=16, n_valid=8,
        loader_config={"minibatch_size": 8}),
    "mnist_conv_stochastic_avg": _mnist_conv_pools,
    "cifar_conv": lambda: tcifar.build(loader_name="synthetic_image",
                                       n_train=20, n_valid=10,
                                       minibatch_size=10, max_epochs=1),
    "conv_ae": lambda: tautoencoder.build(n_train=20, n_valid=10,
                                          minibatch_size=10, max_epochs=1),
}


@pytest.mark.parametrize("case", list(CAPTURED))
def test_step_bodies_make_no_host_traffic_after_their_first_call(case):
    """Every body the card captures (train, eval, the train_steps body,
    the accumulation half-step) runs once freely, as the first eager
    step does, and then makes no tensor from host data and reads nothing
    back: the CPU rehearsal of the capture."""
    w = _port_side(CAPTURED[case], 31, run=False)
    w.loader.run()
    while int(w.loader.minibatch_class) != TRAIN:
        w.loader.run()
    for kind, body, inputs in _bodies(w):
        body(*inputs)
        with _NoHostTraffic():
            body(*inputs)


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_graph_replays_equal_the_unrolled_body_on_the_card():
    """MNIST FC fused at tiny widths, twice from one seed on the card:
    ``train_steps`` a step at a time (the second call captures, the rest
    replay) against the step's unrolled body, bit for bit, with an LR
    change between steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    twins = []
    for _ in range(2):
        tprng.seed_all(37)
        w = tmnist.build_fused(max_epochs=1, layers=(32,),
                               minibatch_size=64, n_train=128, n_valid=0)
        w.initialize(device=TorchDevice())
        twins.append(w)
    graphed, eager = twins
    data, labels = graphed.step._dataset_dev
    mask = torch.ones(64, dtype=torch.bool, device="cuda")
    for k in range(5):
        if k == 3:
            for w in twins:
                for gd in w.gds:
                    gd.learning_rate *= 0.5
        x, y = data[k * 16:k * 16 + 64], labels[k * 16:k * 16 + 64]
        got = graphed.step.train_steps(x[None], y[None], mask[None])
        want = eager.step._train_step(x, y, mask)
        for key in want:
            assert torch.equal(got[key], want[key]), (k, key)
    for a, b in zip(graphed.step._params, eager.step._params):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    (graph,) = [g for g in graphed.step._graphs.values() if g is not None]
    assert graph.replays == 4


@pytest.mark.cuda
def test_a_body_that_cannot_be_captured_raises_on_the_card():
    """A forward that copies from the host inside the step: its first
    (eager) call runs, its capture raises with the reason, and nothing
    falls back to eager launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tprng.seed_all(41)
    w = tmnist.build_fused(max_epochs=1, layers=(8,), minibatch_size=16,
                           n_train=64, n_valid=0)
    w.initialize(device=TorchDevice())
    fwd = w.forwards[0]
    plain = fwd.torch_apply
    fwd.torch_apply = lambda p, x, **kw: plain(p, x, **kw) * torch.tensor(
        1.0, device=x.device)
    w.loader.run()
    w.step.run()                                   # eager: runs
    w.loader.run()
    with pytest.raises(RuntimeError, match="cannot be captured"):
        w.step.run()
