"""The port's MNIST FC slice (``znicz_tpu_torch``: the Unit/Workflow
graph, the FC units, ``FusedTrainStep`` on one device and
``models/mnist_fc.py``) against the JAX package on the CPU.

Both packages build the same workflow from one seed at ``layers=(64,)``
(seed 11, 2 epochs); the reference runs on ``TPUDevice`` with
``root.common.engine.pallas`` and ``pallas_interpret`` on (so its eager
units run the Pallas GEMM kernels and its fused step the Pallas update
kernels, in interpret mode), the port on ``TorchDevice("cpu")`` (the
kernels' plain versions).  The JAX run's initial weights cross into the
port through ``load_forward_params``, and the port's shuffle stream
takes the JAX stream's state after initialize, so parity rests on
neither the prng copy nor the weight-init draws.  Checks: identical
per-epoch n_err histories and weights within bands stated below; the
All2AllTanh+GDTanh unit pair; fused with SGD, AdamW and bf16 velocity;
``train_steps``; the MSE path with nearest-target n_err; port fused
against port eager; class weights and the confusion matrix; and the
options the port refuses.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import znicz_tpu.core.plumbing as j_plumbing
import znicz_tpu.loader.synthetic as j_synthetic
import znicz_tpu.parallel.step as j_step
import znicz_tpu.units.all2all as j_all2all
import znicz_tpu.units.decision as j_decision
import znicz_tpu.units.evaluator as j_evaluator
import znicz_tpu.units.gd as j_gd
import znicz_tpu.units.nn_units as j_nn
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.core.memory import Array as JArray
from znicz_tpu.core.workflow import Workflow as JWorkflow
from znicz_tpu.models import mnist_fc as jmnist

import znicz_tpu_torch.core.plumbing as t_plumbing
import znicz_tpu_torch.loader.synthetic as t_synthetic
import znicz_tpu_torch.parallel.step as t_step
import znicz_tpu_torch.units.all2all as t_all2all
import znicz_tpu_torch.units.decision as t_decision
import znicz_tpu_torch.units.evaluator as t_evaluator
import znicz_tpu_torch.units.gd as t_gd
import znicz_tpu_torch.units.nn_units as t_nn
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import NumpyDevice, TorchDevice
from znicz_tpu_torch.core.memory import Array as TArray
from znicz_tpu_torch.core.workflow import Workflow as TWorkflow
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.models import mnist_fc as tmnist
from znicz_tpu_torch.units.nn_units import load_forward_params

SEED, EPOCHS = 11, 2
#: weights after 2 epochs, port vs reference, by optimizer.  SGD (eager
#: and fused): both sides f32, differing in summation order only —
#: 1.1e-7 measured.  bf16 velocity: a velocity element whose f32 value
#: differs by an ulp can round to a neighbouring bf16 value (2^-8
#: relative), which moves its weight by ~lr * 0.4 % of the velocity —
#: 5.3e-5 measured.  AdamW divides each gradient element by its RMS, so
#: an element whose batch sum nearly cancels (|g| ~ 1e-6 of terms ~ 1e-3)
#: takes O(lr) steps whose size depends on the summation order — 1.7e-4
#: measured (the reference's own XLA-vs-Pallas runs, which share the
#: gradient's summation, differ by 2e-5)
WEIGHT_ATOL = {"sgd": 1e-6, "bf16": 5e-4, "adam": 2e-3}
FUSED_CASES = {"sgd": {}, "adam": {"optimizer": "adam"},
               "bf16": {"optimizer_config": {"state_dtype": "bfloat16"}}}


def _jax_run(kind, seed=SEED, run=True, **kw):
    """Build + initialize the reference's workflow (Pallas interpret
    mode) and, if ``run``, train it.  Returns (workflow, initial params,
    the default stream's state after initialize)."""
    jprng.seed_all(seed)
    jroot.common.engine.pallas = True
    jroot.common.engine.pallas_interpret = True
    try:
        w = getattr(jmnist, f"build_{kind}")(**kw)
        w.decision.evaluator = w.evaluator
        w.initialize(device=TPUDevice())
        params = [{"w": f.weights.map_read().copy(),
                   "b": f.bias.map_read().copy()} for f in w.forwards]
        state = jprng.get().state_dict()
        if run:
            w.run()
            if kind == "fused":
                w.step.sync_to_units()
    finally:
        jroot.common.engine.pallas = False
        jroot.common.engine.pallas_interpret = False
    return w, params, state


def _port_build(kind, params, state, seed=SEED, **kw):
    tprng.seed_all(seed)
    w = getattr(tmnist, f"build_{kind}")(**kw)
    # the Decision collects the confusion matrixes when handed the
    # evaluator (build_eager does it, build_fused leaves it to the caller)
    w.decision.evaluator = w.evaluator
    load_forward_params(w.forwards, params)
    w.initialize(device=TorchDevice("cpu"))
    tprng.get().load_state_dict(state)
    return w


def _port_run(kind, params, state, **kw):
    w = _port_build(kind, params, state, **kw)
    w.run()
    if kind == "fused":
        w.step.sync_to_units()
    return w


def _weights(w):
    return [a for f in w.forwards for a in (f.weights.map_read(),
                                            f.bias.map_read())]


def _assert_weights(port, ref, atol):
    for got, want in zip(_weights(port), _weights(ref)):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_eager_matches_jax():
    jw, params, state = _jax_run("eager", max_epochs=EPOCHS)
    tw = _port_run("eager", params, state, max_epochs=EPOCHS)
    assert tw.decision.metrics_history == jw.decision.metrics_history
    assert bool(tw.decision.complete)
    _assert_weights(tw, jw, WEIGHT_ATOL["sgd"])
    for cls in (VALID, TRAIN):
        np.testing.assert_array_equal(tw.decision.confusion_matrixes[cls],
                                      jw.decision.confusion_matrixes[cls])


def test_eager_units_run_the_fc_kernels_and_data_matches():
    """The eager graph on a TorchDevice routes All2AllTanh/GDTanh through
    the kernel wrappers (on CPU tensors: their plain versions), and the
    seeded dataset is the reference's, bit for bit."""
    jw, params, state = _jax_run("eager", run=False, max_epochs=1)
    tw = _port_build("eager", params, state, max_epochs=1)
    np.testing.assert_array_equal(tw.loader.original_data.mem,
                                  jw.loader.original_data.mem)
    np.testing.assert_array_equal(tw.loader.original_labels.mem,
                                  jw.loader.original_labels.mem)
    assert "_backward" in tw.gds[0].__dict__         # the kernel route
    assert "_backward" not in tw.gds[1].__dict__     # GDSoftmax: plain
    tw.run()
    assert isinstance(tw.forwards[0].output.devmem, torch.Tensor)


def _unit_pair(fwd_cls, gd_cls, array_cls, workflow_cls, device, params):
    """One forward and one gradient step of a unit pair -> (the initial
    params, the gd unit's arrays after the step)."""
    rng = np.random.default_rng(7)
    w = workflow_cls(name="fc")
    fwd = fwd_cls(w, output_sample_shape=24)
    fwd.input = array_cls(rng.normal(size=(16, 33)).astype(np.float32))
    if params is not None:
        load_forward_params([fwd], params)
    fwd.initialize(device=device)
    init = [{"w": fwd.weights.map_read().copy(),
             "b": fwd.bias.map_read().copy()}]
    fwd.run()
    gd = gd_cls(w, learning_rate=0.1, weights_decay=0.01,
                gradient_moment=0.9)
    gd.link_from_forward(fwd)
    gd.err_output = array_cls(rng.normal(size=fwd.output.shape)
                              .astype(np.float32))
    gd.batch_size = 16
    gd.initialize(device=device)
    gd.run()
    return init, {a: np.asarray(getattr(gd, a).map_read()).copy()
                  for a in ("err_input", "weights", "bias",
                            "gradient_weights", "gradient_bias")}


def test_all2all_tanh_and_gd_tanh_pair_matches_jax():
    """One forward + one gradient step of the unit pair, the reference's
    Pallas route against the port's kernel route from the same initial
    weights, at the reference's band (tests/test_pallas_kernels.py:
    676-677)."""
    jprng.seed_all(19)
    jroot.common.engine.pallas = True
    jroot.common.engine.pallas_interpret = True
    try:
        params, want = _unit_pair(j_all2all.All2AllTanh, j_gd.GDTanh,
                                  JArray, JWorkflow, TPUDevice(), None)
    finally:
        jroot.common.engine.pallas = False
        jroot.common.engine.pallas_interpret = False
    _, got = _unit_pair(t_all2all.All2AllTanh, t_gd.GDTanh, TArray,
                        TWorkflow, TorchDevice("cpu"), params)
    for attr, value in want.items():
        np.testing.assert_allclose(got[attr], value, rtol=2e-4, atol=2e-5,
                                   err_msg=attr)


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_matches_jax(case):
    kw = dict(FUSED_CASES[case], max_epochs=EPOCHS)
    jw, params, state = _jax_run("fused", **kw)
    tw = _port_run("fused", params, state, **kw)
    assert tw.decision.metrics_history == jw.decision.metrics_history
    _assert_weights(tw, jw, WEIGHT_ATOL[case])
    for cls in (VALID, TRAIN):
        assert tw.decision.confusion_matrixes[cls].sum() > 0
        np.testing.assert_array_equal(tw.decision.confusion_matrixes[cls],
                                      jw.decision.confusion_matrixes[cls])
    leaf = tw.step._params[0]
    assert leaf["w"].dtype == torch.float32
    if case == "bf16":
        assert leaf["vw"].dtype == torch.bfloat16
    if case == "adam":
        assert float(leaf["t"]) == float(jw.step._params[0]["t"])


def test_train_steps_matches_jax():
    """K minibatches in one call (the reference scans them in one
    program, the port loops): summed metrics and params."""
    jw, params, state = _jax_run("fused", run=False, max_epochs=1)
    tw = _port_build("fused", params, state, max_epochs=1)
    rng = np.random.default_rng(4)
    k, b = 3, 64
    xs = rng.normal(size=(k, b, 28, 28)).astype(np.float32)
    ys = rng.integers(0, 10, (k, b)).astype(np.int32)
    ms = np.ones((k, b), bool)
    ms[-1, 40:] = False
    want = jw.step.train_steps(jnp.asarray(xs), jnp.asarray(ys),
                               jnp.asarray(ms))
    got = tw.step.train_steps(torch.tensor(xs), torch.tensor(ys),
                              torch.tensor(ms))
    assert int(got["bs"]) == int(want["bs"]) == 3 * 64 - 24
    assert int(got["n_err"]) == int(want["n_err"])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  np.asarray(want["confusion"]))
    jw.step.sync_to_units()
    tw.step.sync_to_units()
    _assert_weights(tw, jw, WEIGHT_ATOL["sgd"])


def _mse_workflow(ns, nn, device, params=None):
    """The approximator's shape by hand in either package: prototype
    targets, tanh hidden layer, linear output, EvaluatorMSE with the
    nearest-target classification links, DecisionMSE, fused step."""
    w = nn.NNWorkflow(name="mse")
    w.repeater = ns.plumbing.Repeater(w)
    loader = w.loader = ns.synthetic.SyntheticRegressionLoader(
        w, sample_shape=(8,), target_shape=(3,), n_train=60, n_valid=20,
        prototypes=4, minibatch_size=20)
    fwds = [ns.all2all.All2AllTanh(w, output_sample_shape=12),
            ns.all2all.All2All(w, output_sample_shape=3)]
    ev = ns.evaluator.EvaluatorMSE(w)
    gds = [cls(w, learning_rate=0.05, gradient_moment=0.9,
               weights_decay=1e-4) for cls in (ns.gd.GDTanh,
                                               ns.gd.GradientDescent)]
    step = w.step = ns.step.FusedTrainStep(w, forwards=fwds, evaluator=ev,
                                           gds=gds, loader=loader)
    dec = w.decision = ns.decision.DecisionMSE(w, max_epochs=2)
    w.repeater.link_from(w.start_point)
    loader.link_from(w.repeater)
    step.link_from(loader)
    dec.link_from(step)
    w.repeater.link_from(dec)
    w.end_point.link_from(dec)
    w.end_point.gate_block = ~dec.complete
    fwds[0].link_attrs(loader, ("input", "minibatch_data"))
    fwds[1].link_attrs(fwds[0], ("input", "output"))
    ev.link_attrs(fwds[1], "output")
    ev.link_attrs(loader, ("target", "minibatch_targets"),
                  ("labels", "minibatch_labels"), "class_targets",
                  ("batch_size", "minibatch_size"))
    for fwd, gd in zip(fwds, gds):
        gd.link_from_forward(fwd)
    dec.link_attrs(loader, "minibatch_class", "last_minibatch",
                   "class_lengths", "epoch_number")
    dec.link_attrs(step, ("minibatch_mse", "mse"), "minibatch_size")
    w.forwards = fwds
    if params is not None:
        load_forward_params(fwds, params)
    w.initialize(device=device)
    return w


def test_fused_mse_with_nearest_target_matches_jax():
    jns = types.SimpleNamespace(plumbing=j_plumbing, synthetic=j_synthetic,
                                all2all=j_all2all, evaluator=j_evaluator,
                                gd=j_gd, step=j_step, decision=j_decision)
    tns = types.SimpleNamespace(plumbing=t_plumbing, synthetic=t_synthetic,
                                all2all=t_all2all, evaluator=t_evaluator,
                                gd=t_gd, step=t_step, decision=t_decision)
    jprng.seed_all(SEED)
    jw = _mse_workflow(jns, j_nn, TPUDevice())
    params = [{"w": f.weights.map_read().copy(),
               "b": f.bias.map_read().copy()} for f in jw.forwards]
    state = jprng.get().state_dict()
    jw.run()
    jw.step.sync_to_units()
    tprng.seed_all(SEED)
    tw = _mse_workflow(tns, t_nn, TorchDevice("cpu"), params)
    tprng.get().load_state_dict(state)
    tw.run()
    tw.step.sync_to_units()
    assert tw.step._nt_recovery_valid() and jw.step._nt_recovery_valid()
    assert tw.step.n_err == jw.step.n_err
    for got, want in zip(tw.decision.metrics_history,
                         jw.decision.metrics_history):
        assert got["epoch"] == want["epoch"]
        for key in ("metric_validation", "metric_train"):
            assert got[key] == pytest.approx(want[key], rel=1e-5)
    _assert_weights(tw, jw, WEIGHT_ATOL["sgd"])


def _one_train_minibatch(kind, seed=77, **kw):
    tprng.seed_all(seed)
    w = getattr(tmnist, f"build_{kind}")(max_epochs=1, n_valid=0, **kw)
    w.initialize(device=TorchDevice("cpu"))
    w.loader.run()
    if kind == "fused":
        w.step.run()
        w.step.sync_to_units()
    else:
        for f in w.forwards:
            f.run()
        w.evaluator.run()
        for gd in reversed(w.gds):
            gd.run()
    return w


def test_port_fused_step_matches_port_eager_units():
    """tests/test_parallel.py::test_fused_step_matches_eager_units on the
    port: one TRAIN minibatch, autograd of the composed loss against the
    hand-written unit backward, weights and velocities."""
    kw = dict(n_train=200, minibatch_size=50)
    we = _one_train_minibatch("eager", **kw)
    wf = _one_train_minibatch("fused", **kw)
    for i, (fe, ff) in enumerate(zip(we.forwards, wf.forwards)):
        for attr in ("weights", "bias"):
            np.testing.assert_allclose(
                getattr(ff, attr).map_read(), getattr(fe, attr).map_read(),
                rtol=1e-4, atol=1e-5, err_msg=f"layer {i} {attr}")
    for i, (ge, gf) in enumerate(zip(we.gds, wf.gds)):
        np.testing.assert_allclose(
            gf.gradient_weights.map_read(), ge.gradient_weights.map_read(),
            rtol=1e-4, atol=1e-5, err_msg=f"layer {i} velocity")


@pytest.mark.parametrize("eager_device", ["numpy", "torch"])
def test_class_weights_fused_matches_eager(eager_device):
    """tests/test_mnist_fc.py:148 on the port: class weights enter via
    err_output scaling (eager: the numpy oracle, or the torch path) and
    via the loss term (fused), with equal updates; and they change the
    update."""
    cw = np.linspace(0.5, 2.0, 10).astype(np.float32)
    kw = dict(n_train=200, minibatch_size=50, layers=(16,), moment=0.0,
              lr=0.1)
    runs = {}
    for kind in ("eager", "fused", "plain"):
        tprng.seed_all(123)
        w = getattr(tmnist, f"build_{'fused' if kind == 'plain' else kind}")(
            max_epochs=1, n_valid=0, **kw)
        if kind != "plain":
            w.evaluator.class_weights = cw
        dev = NumpyDevice() if kind == "eager" and eager_device == \
            "numpy" else TorchDevice("cpu")
        w.initialize(device=dev)
        w.loader.run()
        if kind == "eager":
            for f in w.forwards:
                f.run()
            w.evaluator.run()
            for gd in reversed(w.gds):
                gd.run()
        else:
            w.step.run()
            w.step.sync_to_units()
        runs[kind] = w
    _assert_close = np.testing.assert_allclose
    for fe, ff in zip(runs["eager"].forwards, runs["fused"].forwards):
        _assert_close(ff.weights.map_read(), fe.weights.map_read(),
                      rtol=1e-4, atol=1e-5)
        _assert_close(ff.bias.map_read(), fe.bias.map_read(), rtol=1e-4,
                      atol=1e-5)
    assert not np.allclose(runs["plain"].forwards[-1].weights.map_read(),
                           runs["fused"].forwards[-1].weights.map_read())


@pytest.mark.parametrize("device", [NumpyDevice, lambda: TorchDevice("cpu")])
def test_evaluator_mse_nearest_target_unit(device):
    """tests/test_mnist_fc.py:313 on the port, on both backends:
    outputs nearer the wrong prototype count as errors, padded rows do
    not."""
    w = TWorkflow(name="nt")
    ev = t_evaluator.EvaluatorMSE(w)
    protos = np.array([[0.0, 0.0], [10.0, 10.0]], np.float32)
    ev.output.mem = np.array([[0.1, 0.2], [9.0, 9.5], [9.9, 9.9]],
                             np.float32)
    ev.target.mem = protos[[0, 0, 1]]
    ev.labels.mem = np.array([0, 0, 0], np.int32)
    ev.class_targets.mem = protos
    ev.batch_size = 2
    ev.initialize(device=device())
    ev.target.initialize(ev.device)     # a loader's array, normally
    ev.run()
    assert ev._classifies and ev.n_err == 1
    want_mse = ((np.array([[0.1, 0.2], [9.0, 9.5]]) ** 2).mean(1)).sum() / 2
    assert ev.mse == pytest.approx(want_mse, rel=1e-6)
    assert ev.rmse == pytest.approx(np.sqrt(want_mse), rel=1e-6)
    np.testing.assert_allclose(ev.err_output.map_read()[2], 0.0)


def test_class_weights_of_the_wrong_length_raise():
    tprng.seed_all(5)
    w = tmnist.build_fused(max_epochs=1, n_valid=0, n_train=100,
                           minibatch_size=50)
    w.evaluator.class_weights = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="entries"):
        w.initialize(device=TorchDevice("cpu"))


def test_fused_confusion_matrix_matches_eager():
    """tests/test_mnist_fc.py:240 on the port: per-class-pass confusion
    matrixes of the fused step against the eager evaluator's."""
    kw = dict(n_train=200, n_valid=100, minibatch_size=50, layers=(12,),
              moment=0.0, max_epochs=1)
    runs = {}
    for kind in ("eager", "fused"):
        tprng.seed_all(44)
        w = getattr(tmnist, f"build_{kind}")(**kw)
        w.decision.evaluator = w.evaluator
        w.initialize(device=TorchDevice("cpu"))
        w.run()
        runs[kind] = w
    for cls, expected in ((VALID, 100), (TRAIN, 200)):
        me = runs["eager"].decision.confusion_matrixes[cls]
        mf = runs["fused"].decision.confusion_matrixes[cls]
        assert me.sum() == mf.sum() == expected
        np.testing.assert_array_equal(mf.sum(axis=0), me.sum(axis=0))
        assert np.abs(mf - me).sum() <= 4, (cls, mf, me)


def test_fused_confusion_matrix_survives_midpass_flush():
    """A probe calling flush_metrics() mid class pass must not
    double-count (tests/test_mnist_fc.py:283 on the port)."""
    tprng.seed_all(11)
    w = tmnist.build_fused(max_epochs=1, n_valid=0, n_train=120,
                           minibatch_size=40)
    w.decision.evaluator = w.evaluator
    w.initialize(device=TorchDevice("cpu"))
    while True:
        w.loader.run()
        w.step.run()
        w.step.flush_metrics()
        w.step.flush_metrics()
        if bool(w.loader.last_minibatch):
            break
    w.decision.run()
    mat = w.decision.confusion_matrixes[TRAIN]
    assert mat is not None and mat.sum() == 120, mat


@pytest.mark.parametrize("option", [
    {"mesh": {"data": 1, "model": 2}}, {"anatomy": True}])
def test_unported_options_raise(option):
    """What the fused step still lacks raises naming its ROADMAP item:
    a mesh axis other than data (item 10b).  Anatomy is ported
    (tests/test_torch_port_anatomy.py), as are the data mesh,
    shard_update, shard_params and quantized_collectives
    (tests/test_torch_port_data_parallel.py)."""
    if "anatomy" in option:
        w = tmnist.build_fused(max_epochs=1, **option)
        w.initialize(device=TorchDevice("cpu"))
        assert w.step._anatomy is not None
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        w = tmnist.build_fused(max_epochs=1, **option)
        w.initialize(device=TorchDevice("cpu"))


def test_unported_step_options_raise():
    # donate=False has no counterpart: PyTorch has no donation
    with pytest.raises(ValueError, match="donation"):
        t_step.FusedTrainStep(donate=False)
    # a unit mesh and quantized collectives switched off build
    tmnist.build_fused(mesh={"data": 1},
                       quantized_collectives={"mode": "off"})
    w = tmnist.build_fused(max_epochs=1)
    # the input pipeline's stager is ported
    # (tests/test_torch_port_pipeline.py)
    assert callable(w.step.make_stager())
    # a forward that needs random bits builds: the step mints its
    # generator at initialize
    w.forwards[0].NEEDS_RNG = True
    w.initialize(device=TorchDevice("cpu"))
    assert isinstance(w.step._gen, torch.Generator)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """``TorchDevice()`` and a fused step given no TorchDevice both mean
    cuda; on a host without one they raise instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDevice()
    tprng.seed_all(3)
    w = tmnist.build_fused(max_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        w.initialize(device=NumpyDevice())
