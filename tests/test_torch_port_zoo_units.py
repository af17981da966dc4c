"""The port's auxiliary units, plotters and the interactive and RESTful
loaders (``znicz_tpu_torch/units/{activation,cutter,resizable_all2all,
weights_zerofilling,nn_rollback,lr_adjust,diversity,image_saver,
nn_plotting}.py``, ``plotting.py``, ``loader/{interactive,restful}.py``)
against the JAX package on the CPU, from one seed.

- the activation pairs within 1e-6 forward and 1e-5 backward (as
  ``tests/test_conv_units.py``), the numpy oracles bit-identical, and an
  activation layer inside a StandardWorkflow, eager and fused;
- ``Cutter`` / ``GDCutter`` bit-identical; ``resize`` equal to the
  reference's after the same draws; ``ZeroFiller`` eager and fused;
- every LR policy's value, a schedule's effect on a fused run (through
  the step's one hyperparameter buffer), and the ``scan_epoch`` refusal
  of a per-minibatch schedule in the reference's words;
- ``NNRollback`` as ``tests/test_aux_units.py`` drives it, plus: a fused
  restore copies into the step's live leaves (same tensors, same
  ``data_ptr``), where captured graphs read them;
- ``Diversity``'s groups; the plotters and ``ImageSaver`` write the files
  ``tests/test_services.py`` expects;
- the interactive loader's minibatches bit for bit and its online fused
  run's history; ``PredictionServer`` answering ``POST /predict`` within
  1e-5 of the reference's server on the same package.
"""

import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import NumpyDevice as JNumpyDevice
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.core.memory import Array as JArray
from znicz_tpu.core.workflow import Workflow as JWorkflow
from znicz_tpu.loader import interactive as jinteractive
from znicz_tpu.loader import restful as jrestful
from znicz_tpu.standard_workflow import StandardWorkflow as JStandard
from znicz_tpu.units import activation as jact
from znicz_tpu.units import cutter as jcutter
from znicz_tpu.units import diversity as jdiv
from znicz_tpu.units import lr_adjust as jlr
from znicz_tpu.units import nn_rollback as jrb
from znicz_tpu.units import resizable_all2all as jresize
from znicz_tpu.units import weights_zerofilling as jzf

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import NumpyDevice, TorchDevice
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.core.memory import Array as TArray
from znicz_tpu_torch.core.workflow import Workflow as TWorkflow
from znicz_tpu_torch.loader import interactive as tinteractive
from znicz_tpu_torch.loader import restful as trestful
from znicz_tpu_torch.loader.base import TRAIN, get_loader
from znicz_tpu_torch.standard_workflow import StandardWorkflow as TStandard
from znicz_tpu_torch.units import activation as tact
from znicz_tpu_torch.units import cutter as tcutter
from znicz_tpu_torch.units import diversity as tdiv
from znicz_tpu_torch.units import lr_adjust as tlr
from znicz_tpu_torch.units import nn_rollback as trb
from znicz_tpu_torch.units import resizable_all2all as tresize
from znicz_tpu_torch.units import weights_zerofilling as tzf
from znicz_tpu_torch.units.nn_units import MatchingObject
from znicz_tpu_torch.utils import export as texport

#: activation units, port vs reference (tests/test_conv_units.py)
FWD_ATOL, BWD_ATOL = 1e-6, 1e-5
#: weights of a fused or eager FC run, port vs reference (the MNIST FC
#: SGD band, tests/test_torch_port_mnist.py)
WEIGHT_ATOL = 1e-6
#: the reference's serving test band (tests/test_interactive_restful.py)
SERVE_RTOL = 1e-5

ACTIVATIONS = ["tanh", "relu", "str", "sigmoid", "log", "sincos",
               "tanhlog", "mul"]
SIDES = {"jax": (jprng, JWorkflow, JArray, JStandard),
         "port": (tprng, TWorkflow, TArray, TStandard)}


def _pair_cls(mod, name: str):
    key = f"activation_{name}"
    return tuple(next(c for c in vars(mod).values()
                      if isinstance(c, type) and key in
                      getattr(c, "MAPPING", ()) and
                      issubclass(c, base))
                 for base in (mod.ActivationForward,
                              mod.ActivationBackward))


def test_the_units_and_the_loader_register_under_the_reference_names():
    for name in ACTIVATIONS:
        key = f"activation_{name}"
        assert MatchingObject.forwards[key].__module__.endswith(
            "units.activation")
        assert MatchingObject.gds[key].__module__.endswith(
            "units.activation")
    assert MatchingObject.forwards["cutter"] is tcutter.Cutter
    assert MatchingObject.gds["cutter"] is tcutter.GDCutter
    assert MatchingObject.forwards["resizable_all2all"] is \
        tresize.ResizableAll2All
    assert get_loader("interactive") is tinteractive.InteractiveLoader


def _activation_run(side, name, device, x, x2, err):
    prng, Workflow, Array, _ = SIDES[side]
    mod = jact if side == "jax" else tact
    fwd_cls, bwd_cls = _pair_cls(mod, name)
    prng.seed_all(42)
    w = Workflow(name="t")
    fwd = fwd_cls(w)
    fwd.input = Array(x)
    if name == "mul":
        fwd.input2 = Array(x2)
        fwd.input2.initialize(device)
    fwd.initialize(device=device)
    fwd.run()
    bwd = bwd_cls(w)
    bwd.link_from_forward(fwd)
    bwd.err_output = Array(err)
    bwd.initialize(device=device)
    bwd.run()
    return (np.array(fwd.output.map_read()),
            np.array(bwd.err_input.map_read()))


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_pair_matches_jax(name):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 8)).astype(np.float32) * 2.0
    x2 = rng.normal(size=(3, 8)).astype(np.float32)
    err = rng.normal(size=(3, 8)).astype(np.float32)
    jy, je = _activation_run("jax", name, TPUDevice(), x, x2, err)
    ty, te = _activation_run("port", name, TorchDevice("cpu"), x, x2, err)
    np.testing.assert_allclose(ty, jy, rtol=FWD_ATOL, atol=FWD_ATOL)
    np.testing.assert_allclose(te, je, rtol=BWD_ATOL, atol=BWD_ATOL)
    # the numpy oracles run the same code
    jy, je = _activation_run("jax", name, JNumpyDevice(), x, x2, err)
    ty, te = _activation_run("port", name, NumpyDevice(), x, x2, err)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(te, je)


def test_mul_refuses_the_fused_chain_in_the_reference_words():
    msgs = []
    for mod in (jact, tact):
        with pytest.raises(NotImplementedError) as exc:
            getattr(mod.ForwardMul(None), "xla_apply" if mod is jact
                    else "torch_apply")({}, None)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def _gated_layers(act: str):
    return [{"type": "all2all", "->": {"output_sample_shape": 12},
             "<-": {"learning_rate": 0.1, "gradient_moment": 0.5}},
            {"type": f"activation_{act}"},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": {"learning_rate": 0.1, "gradient_moment": 0.5}}]


def _classifier(side, layers, fused, seed=7, **kw):
    prng, _, _, Standard = SIDES[side]
    prng.seed_all(seed)
    return Standard(
        name="Zoo", layers=layers, loss_function="softmax",
        loader_name="synthetic_classifier",
        loader_config={"n_classes": 3, "sample_shape": (6,),
                       "n_train": 60, "n_valid": 30, "minibatch_size": 10},
        decision_config={"max_epochs": kw.pop("max_epochs", 3)},
        fused=fused, **kw)


def _weights(w):
    return [np.array(getattr(f, a).map_read()) for f in w.forwards
            for a in ("weights", "bias") if getattr(f, a, None)]


def _held(tw, jw, atol=WEIGHT_ATOL):
    pairs = list(zip(_weights(tw), _weights(jw), strict=True))
    assert pairs
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _train_both(make):
    """``make(side)`` on each package's device, trained -> (jax, port)."""
    jw = make("jax")
    jw.initialize(device=TPUDevice())
    jw.run()
    tw = make("port")
    tw.initialize(device=TorchDevice("cpu"))
    tw.run()
    for w in (jw, tw):
        if getattr(w, "step", None) is not None:
            w.step.sync_to_units()
    return jw, tw


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_an_activation_layer_trains_as_the_reference(fused):
    jw, tw = _train_both(lambda side: _classifier(
        side, _gated_layers("sigmoid"), fused))
    assert type(tw.forwards[1]).__name__ == "ForwardSigmoid"
    assert tw.decision.metrics_history == jw.decision.metrics_history
    _held(tw, jw)


@pytest.mark.parametrize("device", ["numpy", "torch"])
def test_cutter_pair_is_bit_identical(device):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    err = rng.normal(size=(2, 4, 5, 3)).astype(np.float32)
    outs = []
    for side, mod, dev in (("jax", jcutter, TPUDevice()),
                           ("port", tcutter, NumpyDevice()
                            if device == "numpy" else TorchDevice("cpu"))):
        _, Workflow, Array, _ = SIDES[side]
        w = Workflow(name="t")
        cut = mod.Cutter(w, offset=(2, 1), size=(4, 5))
        cut.input = Array(x.copy())
        cut.initialize(device=dev)
        cut.run()
        gd = mod.GDCutter(w)
        gd.link_from_forward(cut)
        gd.err_output = Array(err.copy())
        gd.initialize(device=dev)
        gd.run()
        outs.append((np.array(cut.output.map_read()),
                     np.array(gd.err_input.map_read())))
    np.testing.assert_array_equal(outs[1][0], x[:, 2:6, 1:6, :])
    for got, want in zip(outs[1], outs[0]):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="requires size"):
        tcutter.Cutter(None)


def test_resize_draws_what_the_reference_draws():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    runs = {}
    for side, mod, dev in (("jax", jresize, TPUDevice()),
                           ("port", tresize, TorchDevice("cpu"))):
        prng, Workflow, Array, _ = SIDES[side]
        prng.seed_all(3)
        u = mod.ResizableAll2All(Workflow(name="t"), output_sample_shape=5)
        u.input = Array(x)
        u.initialize(device=dev)
        u.run()
        seen = [(np.array(u.weights.map_read()),
                 np.array(u.output.map_read()))]
        for n in (8, 3):
            u.resize(n)
            u.run()
            seen.append((np.array(u.weights.map_read()),
                         np.array(u.bias.map_read()),
                         np.array(u.output.map_read())))
        runs[side] = seen
    (w0, _), (w8, _, y8), (w3, _, y3) = runs["port"]
    assert y8.shape == (4, 8) and y3.shape == (4, 3)
    np.testing.assert_array_equal(w8[:, :5], w0)
    np.testing.assert_array_equal(w3, w0[:, :3])
    for got, want in zip(runs["port"], runs["jax"]):
        np.testing.assert_array_equal(got[0], want[0])          # weights
        np.testing.assert_allclose(got[-1], want[-1], rtol=1e-5,
                                   atol=1e-6)                   # output
        if len(got) == 3:
            np.testing.assert_array_equal(got[1], want[1])      # bias


def test_zero_filler_eager_matches_the_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6)).astype(np.float32)
    mask = np.ones((6, 4), np.float32)
    mask[2:4, :] = 0.0
    out = []
    for side, rmod, zmod in (("jax", jresize, jzf), ("port", tresize, tzf)):
        prng, Workflow, Array, _ = SIDES[side]
        prng.seed_all(4)
        w = Workflow(name="t")
        u = rmod.ResizableAll2All(w, output_sample_shape=4)
        u.input = Array(x)
        u.initialize(device=JNumpyDevice() if side == "jax"
                     else NumpyDevice())
        zf = zmod.ZeroFiller(w)
        zf.add_target(u, mask)
        zf.run()
        out.append(np.array(u.weights.map_read()))
        with pytest.raises(ValueError):
            zf.add_target(u, np.ones((3, 3)))
    assert np.all(out[1][2:4, :] == 0.0) and np.all(out[1][0] != 0.0)
    np.testing.assert_array_equal(out[1], out[0])


def test_zero_filler_on_a_fused_run_matches_the_reference():
    """With the fused step: ``apply()`` after ``sync_to_units()``."""
    jw, tw = _train_both(lambda side: _classifier(
        side, _gated_layers("tanh"), True, max_epochs=2))
    masks = [np.ones(f.weights.shape, np.float32) for f in tw.forwards
             if f.weights]
    for m in masks:
        m[::2] = 0.0
    for w, mod in ((jw, jzf), (tw, tzf)):
        zf = mod.ZeroFiller(w)
        for f, m in zip([f for f in w.forwards if f.weights], masks):
            zf.add_target(f, m)
        zf.apply()
    for f, m in zip([f for f in tw.forwards if f.weights], masks):
        assert not f.weights.map_read()[m == 0].any()
    _held(tw, jw)


def test_lr_policies_match_the_reference():
    pols = [("ExpPolicy", (0.5,)), ("InvPolicy", (1.0, 1.0)),
            ("StepExpPolicy", (0.1, 10)),
            ("ArbitraryStepPolicy", ([(0.1, 2), (0.01, 3)],)),
            ("FixedPolicy", ())]
    for name, args in pols:
        jp, tp = getattr(jlr, name)(*args), getattr(tlr, name)(*args)
        assert [tp(0.3, i) for i in range(30)] == \
            [jp(0.3, i) for i in range(30)], name
    pol = tlr.ArbitraryStepPolicy([(0.1, 2), (0.01, 3)])
    assert [pol(1.0, i) for i in range(7)] == \
        [0.1, 0.1, 0.01, 0.01, 0.01, 0.01, 0.01]


def _with_schedule(side, by_epoch):
    w = _classifier(side, _gated_layers("tanh"), True)
    mod = jlr if side == "jax" else tlr
    adj = mod.LearningRateAdjust(w, lr_policy=mod.ExpPolicy(0.97),
                                 by_epoch=by_epoch, name="lr_adjust")
    adj.decision = w.decision
    for gd in w.gds:
        adj.add_gd_unit(gd)
    # wire into the loop: decision -> adj -> repeater
    w.repeater.links_from.clear()
    w.decision.links_to.remove(w.repeater)
    adj.link_from(w.decision)
    w.repeater.link_from(adj)
    w.lr_adjust = adj
    return w


@pytest.mark.parametrize("by_epoch", [False, True],
                         ids=["per_minibatch", "per_epoch"])
def test_a_schedule_moves_the_fused_run_as_the_reference(by_epoch):
    """The unit's changes reach the port's steps through the step's one
    hyperparameter buffer, written in place (the tensor on the card's
    captured graphs read): the same history and weights as the
    reference's run, and the last rates in the buffer."""
    jw = _with_schedule("jax", by_epoch)
    jw.initialize(device=TPUDevice())
    jw.run()
    tw = _with_schedule("port", by_epoch)
    tw.initialize(device=TorchDevice("cpu"))
    buf = tw.step._hyper_buf
    ptr, views = buf.data_ptr(), tw.step._hyper_views
    tw.run()
    for w in (jw, tw):
        w.step.sync_to_units()
    assert tw.lr_adjust._iteration == jw.lr_adjust._iteration >= 2
    assert tw.gds[0].learning_rate == jw.gds[0].learning_rate < 0.1
    assert tw.decision.metrics_history == jw.decision.metrics_history
    _held(tw, jw)
    hyper = tw.step._hyper_device()
    assert tw.step._hyper_buf is buf and buf.data_ptr() == ptr
    assert hyper is views
    for gd, h in zip(tw.gds, hyper):
        assert float(h["lr"]) == pytest.approx(gd.learning_rate, rel=1e-6)
        assert float(h["lr_b"]) == pytest.approx(gd.learning_rate_bias,
                                                 rel=1e-6)


def test_scan_epoch_refuses_a_per_minibatch_schedule_as_the_reference():
    msgs = {}
    for side, root, dev in (("jax", jroot, TPUDevice()),
                            ("port", troot, TorchDevice("cpu"))):
        root.common.engine.scan_epoch = True
        try:
            w = _with_schedule(side, False)
            with pytest.raises(ValueError, match="scan_epoch") as exc:
                w.initialize(device=dev)
            msgs[side] = str(exc.value)
            # a per-epoch schedule is unaffected
            _with_schedule(side, True).initialize(device=dev)
        finally:
            root.common.engine.scan_epoch = False
    assert msgs["port"] == msgs["jax"]
    assert "lr_adjust" in msgs["port"]


def _rolled_back(side):
    """tests/test_aux_units.py's rollback drill on ``side`` -> (workflow,
    rollback unit, the stored good weights, per-leaf (tensor, data_ptr)
    of the port's step before the rollback)."""
    prng, _, _, Standard = SIDES[side]
    prng.seed_all(6)
    w = Standard(
        name="RbTest",
        layers=[{"type": "all2all_tanh", "output_sample_shape": 8,
                 "<-": {"learning_rate": 0.1}},
                {"type": "softmax", "output_sample_shape": 3,
                 "<-": {"learning_rate": 0.1}}],
        loader_name="synthetic_classifier",
        loader_config={"n_classes": 3, "sample_shape": (6,), "n_train": 60,
                       "n_valid": 30, "minibatch_size": 10},
        decision_config={"max_epochs": 2})
    w.initialize(device=TPUDevice() if side == "jax"
                 else TorchDevice("cpu"))
    w.run()
    rb = (jrb if side == "jax" else trb).NNRollback(
        w, lr_cut=0.5, fail_iterations=1)
    rb.link_workflow_state(w)
    # simulate: improvement -> store
    w.decision.epoch_ended.set(True)
    w.decision.improved.set(True)
    rb.run()
    good = w.forwards[0].weights.map_read().copy()
    # corrupt the weights (units and step), then a failing epoch
    # triggers restore + lr cut
    w.step.sync_to_units()
    w.forwards[0].weights.map_invalidate()
    w.forwards[0].weights.mem = np.full_like(good, np.nan)
    if side == "jax":
        w.step._params = w.step.gather_params()
        leaves = None
    else:
        w.step.place_params(w.step.gather_params())
        leaves = [[(k, t, t.data_ptr()) for k, t in leaf.items()]
                  for leaf in w.step._params]
        assert torch.isnan(w.step._params[0]["w"]).all()
    w.decision.improved.set(False)
    rb.run()
    return w, rb, good, leaves


def test_nn_rollback_restores_into_the_live_leaves():
    jw, jrbu, jgood, _ = _rolled_back("jax")
    tw, rb, good, leaves = _rolled_back("port")
    np.testing.assert_allclose(good, jgood, rtol=0, atol=WEIGHT_ATOL)
    for w, r, g in ((jw, jrbu, jgood), (tw, rb, good)):
        assert r.rollback_count == 1
        np.testing.assert_array_equal(w.forwards[0].weights.map_read(), g)
        assert w.gds[0].learning_rate == pytest.approx(0.05)
    # the step keeps every leaf: the same tensor at the same address,
    # holding the restored values
    for leaf, before in zip(tw.step._params, leaves, strict=True):
        assert [(k, t, t.data_ptr()) for k, t in leaf.items()] == before
        for k, t, _ in before:
            assert t is leaf[k]
    np.testing.assert_array_equal(tw.step._params[0]["w"].numpy(), good)
    assert float(tw.step._hyper_device()[0]["lr"]) == pytest.approx(0.05)
    # training continues from the restored state with the cut rate
    tw.loader.run()
    tw.step.run()
    tw.step.flush_metrics()
    assert np.isfinite(tw.step.loss)
    tw.step.sync_to_units()
    assert np.isfinite(tw.forwards[0].weights.map_read()).all()


def test_capture_and_restore_round_trip_the_unit_inventory():
    tw, rb, _, _ = _rolled_back("port")
    keys = [k for k, _ in trb.param_arrays(tw)]
    assert keys == [k for k, _ in jrb.param_arrays(_rolled_back("jax")[0])]
    stored = trb.capture_params(tw)
    assert sorted(stored) == sorted(keys)
    before = [t.clone() for leaf in tw.step._params for t in leaf.values()]
    for leaf in tw.step._params:
        for t in leaf.values():
            t.zero_()
    trb.restore_params(tw, stored)
    after = [t for leaf in tw.step._params for t in leaf.values()]
    for a, b in zip(after, before, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _planted(rng):
    w = rng.normal(size=(6, 20)).astype(np.float32)
    w[3] = w[0] * 2.0 + 0.1          # correlated with kernel 0
    w[5] = w[2] * 0.5                # correlated with kernel 2
    return w


def test_diversity_groups_match_the_reference():
    """The port computes on its input's device: CPU tensors here."""
    rng = np.random.default_rng(4)
    w = _planted(rng)
    host = torch.from_numpy
    np.testing.assert_allclose(tdiv.similarity_matrix(host(w)),
                               jdiv.similarity_matrix(w), rtol=1e-5,
                               atol=1e-6)
    groups = tdiv.get_similar_kernels(host(w), threshold=0.95)
    assert groups == jdiv.get_similar_kernels(w, threshold=0.95)
    assert [0, 3] in groups and [2, 5] in groups
    noise = rng.normal(size=(6, 20))
    assert tdiv.get_similar_kernels(host(noise), 0.95) == \
        jdiv.get_similar_kernels(noise, 0.95) == []
    conv = np.random.default_rng(9).normal(size=(3, 3, 2, 8)) \
        .astype(np.float32)
    conv[..., 6] = conv[..., 1] * -0.5 + 0.01
    for th in (0.5, 0.95):
        assert tdiv.get_similar_kernels(host(conv.reshape(-1, 8).T),
                                        th) == \
            jdiv.get_similar_kernels(conv.reshape(-1, 8).T, th)


def test_diversity_of_an_array_goes_to_the_card():
    """An array (the reference's way of calling) is computed on the card
    unless the caller passes a CPU tensor: no silent host product on a
    host with no card."""
    w = _planted(np.random.default_rng(4))
    if torch.cuda.is_available():
        np.testing.assert_allclose(
            tdiv.similarity_matrix(w),
            tdiv.similarity_matrix(torch.from_numpy(w)), rtol=1e-5,
            atol=1e-6)
    else:
        for call in (tdiv.similarity_matrix, tdiv.get_similar_kernels):
            with pytest.raises((AssertionError, RuntimeError)):
                call(w)


def test_diversity_unit_reports_on_a_torch_workflow():
    from znicz_tpu_torch.units.all2all import All2All

    tprng.seed_all(8)
    w = TWorkflow(name="d")
    fc = All2All(w, output_sample_shape=8)
    fc.input = TArray(np.zeros((4, 10), np.float32))
    fc.initialize(device=TorchDevice("cpu"))
    # plant duplicates: two output kernels share a column direction
    wm = fc.weights.map_read().copy()
    wm[:, 5] = wm[:, 1] * 3.0
    fc.weights.map_invalidate()
    fc.weights.mem = wm
    kernels = tdiv.kernels_of(fc)                # the forward's buffer
    assert kernels.device.type == "cpu" and kernels.shape == (8, 10)
    assert kernels.data_ptr() == fc.weights.devmem.data_ptr()
    unit = tdiv.Diversity(w, threshold=0.95).link_forwards([fc])
    unit.run()
    assert unit.report == {0: [[1, 5]]}


def test_plotters_render_the_reference_files(tmp_path):
    from znicz_tpu_torch import plotting
    from znicz_tpu_torch.models import kohonen, wine
    from znicz_tpu_torch.units import nn_plotting

    repo = os.path.dirname(os.path.dirname(os.path.abspath(
        plotting.__file__)))
    assert troot.common.dirs.plots == os.path.join(repo, ".data", "plots")
    tprng.seed_all(3)
    w = wine.build(max_epochs=3, n_train=60, n_valid=30, minibatch_size=10)
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    w.step.sync_to_units()
    d = str(tmp_path / "nn")
    acc = plotting.AccumulatingPlotter(None, name="err_curve", directory=d)
    for v in (5.0, 3.0, 1.0):
        acc.input = v
        acc.run()
    assert acc.render_count == 3 and os.path.exists(acc.last_path)
    mat = plotting.MatrixPlotter(None, name="confusion", directory=d)
    mat.input = np.array([[5, 1], [0, 7]])
    mat.run()
    img = plotting.ImagePlotter(None, name="sample", directory=d)
    img.input = np.zeros((8, 8, 1), np.float32)
    img.run()
    hist = plotting.Histogram(None, name="whist", directory=d)
    hist.input = w.forwards[0].weights
    hist.run()
    w2d = nn_plotting.Weights2D(None, name="w2d", directory=d,
                                sample_shape=(13, 1))
    w2d.input = w.forwards[0].weights
    w2d.run()
    mh = nn_plotting.MultiHistogram(None, name="mh", directory=d)
    mh.inputs = [f.weights for f in w.forwards]
    mh.run()
    assert sorted(os.listdir(d)) == sorted(
        f"{n}.png" for n in ("err_curve", "confusion", "sample", "whist",
                             "w2d", "mh"))
    assert nn_plotting.tile_filters(np.zeros((16, 9), np.float32)).shape \
        == (14, 14)

    tprng.seed_all(23)
    k = kohonen.build(max_epochs=2, shape=(4, 4), n_train=200)
    k.initialize(device=TorchDevice("cpu"))
    k.run()
    k.forward.batch_size = 50
    k.forward.input = k.loader.minibatch_data
    k.forward.run()
    for cls, attr in ((nn_plotting.KohonenHits, "forward"),
                      (nn_plotting.KohonenInputMaps, "trainer"),
                      (nn_plotting.KohonenNeighborMap, "trainer")):
        p = cls(None, name=cls.__name__, directory=str(tmp_path / "som"))
        setattr(p, attr, getattr(k, attr))
        p.run()
        assert os.path.exists(p.last_path)


def test_image_saver_writes_the_reference_files(tmp_path):
    from znicz_tpu.units.image_saver import ImageSaver as JSaver

    from znicz_tpu_torch.units.image_saver import ImageSaver as TSaver

    rng = np.random.default_rng(0)
    x = rng.normal(size=(10, 6, 6, 1)).astype(np.float32)
    probs = np.full((10, 3), 0.2, np.float32)
    probs[:, 0] = 0.6                      # predict class 0 for everyone
    saved = {}
    for side, cls in (("jax", JSaver), ("port", TSaver)):
        _, _, Array, _ = SIDES[side]
        saver = cls(None, directory=str(tmp_path / side), limit=4)
        saver.input = Array(x)
        saver.output = Array(probs)
        saver.labels = Array(np.arange(10, dtype=np.int32) % 3)
        saver.minibatch_size = 10
        saver.minibatch_class = 2
        saver.epoch_number = 1
        saver.run()
        saver.flush()
        assert 0 < len(saver.saved_paths) <= 4
        saved[side] = [os.path.relpath(p, tmp_path / side)
                       for p in saver.saved_paths]
        for p in saver.saved_paths:
            assert os.path.exists(p)
    assert saved["port"] == saved["jax"]
    for rel in saved["port"]:
        with open(tmp_path / "port" / rel, "rb") as a, \
                open(tmp_path / "jax" / rel, "rb") as b:
            assert a.read() == b.read()


def _interactive(side, **kw):
    prng, Workflow, _, _ = SIDES[side]
    prng.seed_all(31)
    mod = jinteractive if side == "jax" else tinteractive
    loader = mod.InteractiveLoader(Workflow(name="t"), sample_shape=(6,),
                                   n_classes=3, **kw)
    loader.initialize(device=JNumpyDevice() if side == "jax"
                      else NumpyDevice())
    return loader


def test_interactive_loader_serves_the_reference_minibatches():
    rng = np.random.default_rng(0)
    loaders = {s: _interactive(s, capacity=16, minibatch_size=4)
               for s in SIDES}
    a = np.full((2, 6), 1.0, np.float32)
    b = rng.normal(size=(14, 6)).astype(np.float32)
    for loader in loaders.values():
        assert loader.feed(a, np.zeros(2, np.int32)) == 2
    for step in range(12):
        if step == 3:
            for loader in loaders.values():
                assert loader.feed(b, np.arange(14) % 3) == 16
        for loader in loaders.values():
            loader.run()
        j, t = loaders["jax"], loaders["port"]
        assert t.minibatch_class == j.minibatch_class == TRAIN
        for attr in ("minibatch_data", "minibatch_labels",
                     "minibatch_indices"):
            np.testing.assert_array_equal(getattr(t, attr).mem,
                                          getattr(j, attr).mem)
    t = loaders["port"]
    with pytest.raises(ValueError):
        t.feed(np.zeros((2, 5), np.float32))
    with pytest.raises(ValueError, match="needs labels"):
        t.feed(np.zeros((2, 6), np.float32))
    empty = _interactive("port", capacity=8, minibatch_size=4)
    with pytest.raises(RuntimeError, match="no samples fed"):
        empty.run()


def _wait_before_refill(w) -> None:
    """The reference's host-fed step reads the loader's minibatch
    buffers asynchronously, and ``InteractiveLoader.fill_minibatch``
    overwrites them in place: under CPU load the next fill can land
    before the dispatched step has read its rows, and the JAX run's
    history changes from run to run (the port's CPU step is
    synchronous).  So the JAX side waits for each step's params before
    the loader serves again."""
    serve = w.loader.run

    def run():
        if getattr(w.step, "_params", None) is not None:
            jax.block_until_ready(w.step._params)
        serve()
    w.loader.run = run


def test_interactive_online_fused_run_matches_the_reference():
    """tests/test_interactive_restful.py's online training, both sides."""
    rng = np.random.default_rng(5)
    centers = rng.normal(0, 2.0, (3, 6)).astype(np.float32)
    labels = rng.integers(0, 3, 96).astype(np.int32)
    data = centers[labels] + rng.normal(0, 0.3, (96, 6)).astype(np.float32)

    def make(side):
        prng, _, _, Standard = SIDES[side]
        prng.seed_all(17)
        w = Standard(
            name="Online", loss_function="softmax",
            layers=[{"type": "all2all_tanh",
                     "->": {"output_sample_shape": 16}},
                    {"type": "softmax", "->": {"output_sample_shape": 3}}],
            loader_name="interactive",
            loader_config={"sample_shape": (6,), "n_classes": 3,
                           "capacity": 96, "minibatch_size": 24},
            decision_config={"max_epochs": 6})
        w.loader.feed(data, labels)
        if side == "jax":
            _wait_before_refill(w)
        return w
    jw, tw = _train_both(make)
    hist = tw.decision.metrics_history
    assert hist == jw.decision.metrics_history
    assert hist[-1]["metric_train"] < hist[0]["metric_train"]
    _held(tw, jw)


def test_prediction_server_answers_as_the_reference(tmp_path):
    tprng.seed_all(23)
    w = TStandard(
        name="Srv", loss_function="softmax",
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 8}},
                {"type": "softmax", "->": {"output_sample_shape": 3}}],
        loader_name="synthetic_classifier",
        loader_config={"n_classes": 3, "sample_shape": (6,), "n_train": 60,
                       "n_valid": 0, "minibatch_size": 20},
        decision_config={"max_epochs": 1})
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    pkg = str(tmp_path / "srv.npz")
    texport.export_forward(w, pkg)
    servers = {"jax": jrestful.PredictionServer(pkg, max_batch=16),
               "port": trestful.PredictionServer(
                   texport.ExportedForward(pkg, device="cpu"),
                   max_batch=16)}
    x = np.random.default_rng(1).normal(size=(5, 6)).astype(np.float32)
    out = {}
    try:
        for side, server in servers.items():
            port = server.start()
            url = f"http://127.0.0.1:{port}"
            out[side] = trestful.predict_remote(url, x)
            assert trestful.predict_remote(url, x[0]).shape == (1, 3)
            with urllib.request.urlopen(url + "/", timeout=5) as r:
                meta = json.loads(r.read())
            assert meta["model"]["name"] == "Srv"
            assert meta["n_requests"] == 2
            assert meta["max_batch"] == 16
            with pytest.raises(ValueError, match="rejected"):
                trestful.predict_remote(url, np.zeros((2, 5), np.float32))
        assert servers["port"].engine.compile_count == 2    # buckets 8, 1
    finally:
        for server in servers.values():
            server.stop()
    np.testing.assert_allclose(out["port"], out["jax"], rtol=SERVE_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(out["port"].sum(axis=1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="max_batch"):
        servers["port"].predict(np.zeros((17, 6), np.float32))
