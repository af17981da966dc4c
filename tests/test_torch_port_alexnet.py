"""The port's conv-stack units, ``StandardWorkflow`` and
``models/alexnet.py`` against the JAX package on the CPU.

- pooling (max, max-|x|, avg) at k3 s2 with border windows, forward and
  backward, ties included: identical int offsets;
- LRN forward and backward against ``znicz_tpu.ops.lrn``;
- dropout with the mask injected into both packages;
- a conv unit pair (ConvTanh + GDTanhConv) one step against the
  reference's Pallas route in interpret mode;
- ``StandardWorkflow(fused=False)`` with AlexNet's geometry at test size
  (67 px, conv 8/16/16/16/8, fc 32/32, 10 classes, batch 8) against the
  JAX eager run under ``engine.pallas`` + ``pallas_interpret``: lr 0.03,
  3 epochs, dropout 0.5 with the same masks injected on both sides (the
  frameworks draw different bits).  The JAX run's initial weights cross
  over with ``load_forward_params`` and the port takes the JAX shuffle
  stream's state after initialize.  Per-epoch n_err must be identical and
  every conv and FC weight within ``WEIGHT_ATOL``;
- the registry and the refusals; the fused shape is
  ``tests/test_torch_port_fused_conv.py``'s.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import znicz_tpu.units.conv as j_conv
import znicz_tpu.units.dropout as j_dropout
import znicz_tpu.units.gd_conv as j_gd_conv
import znicz_tpu.units.gd_pooling as j_gd_pooling
import znicz_tpu.units.pooling as j_pooling
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.core.memory import Array as JArray
from znicz_tpu.core.workflow import Workflow as JWorkflow
from znicz_tpu.loader import base as j_loader_base
from znicz_tpu.models import alexnet as jalexnet
from znicz_tpu.ops import lrn as jlrn
from znicz_tpu.standard_workflow import StandardWorkflow as JStandard

import znicz_tpu_torch.units.conv as t_conv
import znicz_tpu_torch.units.dropout as t_dropout
import znicz_tpu_torch.units.gd_conv as t_gd_conv
import znicz_tpu_torch.units.gd_pooling as t_gd_pooling
import znicz_tpu_torch.units.normalization as t_norm
import znicz_tpu_torch.units.pooling as t_pooling
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import NumpyDevice, TorchDevice
from znicz_tpu_torch.core.memory import Array as TArray
from znicz_tpu_torch.core.workflow import Workflow as TWorkflow
from znicz_tpu_torch.loader import base as t_loader_base
from znicz_tpu_torch.models import alexnet as talexnet
from znicz_tpu_torch.ops import lrn as tlrn
from znicz_tpu_torch.standard_workflow import StandardWorkflow as TStandard
from znicz_tpu_torch.units.nn_units import load_forward_params

SEED, EPOCHS = 5, 3
#: conv and FC weights after 3 epochs, port vs reference: both f32, the
#: same masks, differing in summation order only (the tap loops' and
#: matmul blockings against the Pallas interpreter's) — 6e-8 measured
WEIGHT_ATOL = 1e-6
#: the test-size loader: 10 classes of 67x67x3 images, 30 train and 10
#: validation samples, batch 8
LOADER = {"n_classes": 10, "sample_shape": (67, 67, 3), "n_train": 32,
          "n_valid": 16, "minibatch_size": 8, "spread": 1.0, "noise": 0.5}


def _pallas(on: bool) -> None:
    jroot.common.engine.pallas = on
    jroot.common.engine.pallas_interpret = on


# -- pooling ----------------------------------------------------------------

def _pool_pair(fwd_cls, gd_cls, array_cls, workflow_cls, device, x, err):
    w = workflow_cls(name="pool")
    fwd = fwd_cls(w, kx=3, ky=3, sliding=(2, 2))
    fwd.input = array_cls(x)
    fwd.initialize(device=device)
    fwd.run()
    gd = gd_cls(w)
    gd.link_from_forward(fwd)
    gd.err_output = array_cls(err)
    gd.initialize(device=device)
    gd.run()
    out = {"y": fwd.output.map_read(), "err_input": gd.err_input.map_read()}
    if hasattr(fwd, "input_offset"):
        out["offset"] = fwd.input_offset.map_read()
    return {k: np.array(v) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["max", "maxabs", "avg"])
@pytest.mark.parametrize("ties", [False, True])
def test_pooling_units_match_jax(kind, ties):
    """k3 s2 over 9x8 and 8x7: the last window of each axis is clipped
    (the reference's border windows); integer-valued inputs tie often, so
    the first-match rule shows in the offsets."""
    names = {"max": ("MaxPooling", "GDMaxPooling"),
             "maxabs": ("MaxAbsPooling", "GDMaxAbsPooling"),
             "avg": ("AvgPooling", "GDAvgPooling")}[kind]
    rng = np.random.default_rng(21)
    for shape in ((2, 9, 8, 3), (3, 8, 7, 2)):
        x = (rng.integers(-2, 3, shape) if ties
             else rng.normal(size=shape)).astype(np.float32)
        oh, ow = (t_pooling.pool_ops.pool_out_size(s, 3, 2)
                  for s in shape[1:3])
        err = rng.normal(size=(shape[0], oh, ow, shape[3])).astype(
            np.float32)
        want = _pool_pair(getattr(j_pooling, names[0]),
                          getattr(j_gd_pooling, names[1]), JArray,
                          JWorkflow, TPUDevice(), x, err)
        for device in (TorchDevice("cpu"), NumpyDevice()):
            got = _pool_pair(getattr(t_pooling, names[0]),
                             getattr(t_gd_pooling, names[1]), TArray,
                             TWorkflow, device, x, err)
            assert got["y"].shape == (shape[0], oh, ow, shape[3])
            np.testing.assert_allclose(got["y"], want["y"], rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(got["err_input"], want["err_input"],
                                       rtol=1e-6, atol=1e-7)
            if "offset" in want:
                assert got["offset"].dtype == np.int32
                np.testing.assert_array_equal(got["offset"], want["offset"])


# -- LRN --------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 4])
def test_lrn_matches_jax(n):
    """The op (odd and even windows) against the reference's, and the
    unit pair on both backends; the same f32 formula, ~1 ulp apart."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 4, 11)).astype(np.float32) * 3
    err = rng.normal(size=x.shape).astype(np.float32)
    args = (1e-2, 0.75, 2.0, n)
    y = jlrn.forward(np, x, *args)
    e = jlrn.backward(np, x, err, *args)
    for xp, conv in ((np, np.asarray), (torch, torch.tensor)):
        np.testing.assert_allclose(np.asarray(tlrn.forward(xp, conv(x),
                                                           *args)),
                                   y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(tlrn.backward(xp, conv(x), conv(err), *args)), e,
            rtol=1e-5, atol=1e-6)
    for device in (TorchDevice("cpu"), NumpyDevice()):
        w = TWorkflow(name="lrn")
        fwd = t_norm.LRNormalizerForward(w, alpha=1e-2, n=n)
        fwd.input = TArray(x)
        fwd.initialize(device=device)
        fwd.run()
        gd = t_norm.LRNormalizerBackward(w)
        gd.link_from_forward(fwd)
        gd.err_output = TArray(err)
        gd.initialize(device=device)
        gd.run()
        np.testing.assert_allclose(fwd.output.map_read(), y, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(gd.err_input.map_read(), e, rtol=1e-5,
                                   atol=1e-6)


# -- dropout ----------------------------------------------------------------

def _dropout_pair(ns, array_cls, workflow_cls, device, x, err, mask=None,
                  ratio=0.25, forward_mode=False):
    w = workflow_cls(name="drop")
    fwd = ns.DropoutForward(w, dropout_ratio=ratio)
    fwd.input = array_cls(x)
    fwd.forward_mode = forward_mode
    fwd.initialize(device=device)
    if mask is not None:        # the injected mask, in both packages
        fwd._make_mask_np = lambda shape: mask
        fwd._make_mask_torch = lambda shape, dev: torch.tensor(mask,
                                                               device=dev)
    fwd.run()
    gd = ns.DropoutBackward(w)
    gd.link_from_forward(fwd)
    gd.err_output = array_cls(err)
    gd.initialize(device=device)
    gd.run()
    return np.array(fwd.output.map_read()), np.array(gd.err_input.map_read())


def test_dropout_with_an_injected_mask_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 6, 5)).astype(np.float32)
    err = rng.normal(size=x.shape).astype(np.float32)
    mask = t_dropout.make_mask(np, rng.random(x.shape), 0.25, np.float32)
    y_j, e_j = _dropout_pair(j_dropout, JArray, JWorkflow, NumpyDevice(), x,
                             err, mask)
    for device in (TorchDevice("cpu"), NumpyDevice()):
        y, e = _dropout_pair(t_dropout, TArray, TWorkflow, device, x, err,
                             mask)
        np.testing.assert_array_equal(y, y_j)
        np.testing.assert_array_equal(e, e_j)


def test_dropout_draws_from_the_device_stream():
    """The port's own mask: 0 or 1/(1-p), about p dropped, a new mask per
    run, the identity in forward_mode.  With ratio 0 the port draws no
    mask and both directions are the identity; the reference's backward
    multiplies by its never-drawn zero mask (ROADMAP queue C)."""
    x = np.ones((64, 128), np.float32)
    err = np.ones_like(x)
    tprng.seed_all(3)
    y, e = _dropout_pair(t_dropout, TArray, TWorkflow, TorchDevice("cpu"),
                         x, err, ratio=0.25)
    assert set(np.unique(y)) == {0.0, np.float32(1 / 0.75)}
    assert abs((y == 0).mean() - 0.25) < 0.02
    np.testing.assert_array_equal(e, y)
    y2, _ = _dropout_pair(t_dropout, TArray, TWorkflow, TorchDevice("cpu"),
                          x, err, ratio=0.25)
    assert not np.array_equal(y, y2)
    y3, _ = _dropout_pair(t_dropout, TArray, TWorkflow, TorchDevice("cpu"),
                          x, err, ratio=0.25, forward_mode=True)
    np.testing.assert_array_equal(y3, x)
    for ns, arr, wf, dev, e_want in (
            (t_dropout, TArray, TWorkflow, TorchDevice("cpu"), err),
            (t_dropout, TArray, TWorkflow, NumpyDevice(), err),
            (j_dropout, JArray, JWorkflow, TPUDevice(), np.zeros_like(err))):
        y0, e0 = _dropout_pair(ns, arr, wf, dev, x, err, ratio=0.0)
        np.testing.assert_array_equal(y0, x)
        np.testing.assert_array_equal(e0, e_want)


# -- the conv unit pair -----------------------------------------------------

def _conv_pair(ns, gd_ns, array_cls, workflow_cls, device, params):
    rng = np.random.default_rng(6)
    w = workflow_cls(name="conv")
    fwd = ns.ConvTanh(w, n_kernels=6, kx=3, ky=3, sliding=(2, 2),
                      padding=(1, 0, 2, 1))
    fwd.input = array_cls(rng.normal(size=(4, 11, 9, 5)).astype(np.float32))
    if params is not None:
        load_forward_params([fwd], params)
    fwd.initialize(device=device)
    init = [{"w": fwd.weights.map_read().copy(),
             "b": fwd.bias.map_read().copy()}]
    fwd.run()
    gd = gd_ns.GDTanhConv(w, learning_rate=0.1, weights_decay=0.01,
                          gradient_moment=0.9)
    gd.link_from_forward(fwd)
    gd.err_output = array_cls(rng.normal(size=fwd.output.shape)
                              .astype(np.float32))
    gd.batch_size = 4
    gd.initialize(device=device)
    gd.run()
    return init, {a: np.array(getattr(gd, a).map_read()) for a in
                  ("output", "err_input", "weights", "bias",
                   "gradient_weights", "gradient_bias")}


def test_conv_tanh_unit_pair_matches_jax():
    """One forward + one gradient step, the reference's Pallas route
    against the port's kernel route (plain versions on the CPU) from the
    same weights, at the reference's band (tests/test_pallas_kernels.py:
    676-677)."""
    jprng.seed_all(19)
    _pallas(True)
    try:
        params, want = _conv_pair(j_conv, j_gd_conv, JArray, JWorkflow,
                                  TPUDevice(), None)
    finally:
        _pallas(False)
    _, got = _conv_pair(t_conv, t_gd_conv, TArray, TWorkflow,
                        TorchDevice("cpu"), params)
    for attr, value in want.items():
        np.testing.assert_allclose(got[attr], value, rtol=2e-4, atol=2e-5,
                                   err_msg=attr)


# -- AlexNet at test size through StandardWorkflow --------------------------

def _small_layers(mod, dropout=0.5, lr=0.03):
    """alexnet.layers with the test's narrow widths."""
    specs = mod.layers(n_classes=10, lr=lr, dropout=dropout)
    widths = iter((8, 16, 16, 16, 8))
    for spec in specs:
        if spec["type"] == "conv_str":
            spec["->"]["n_kernels"] = next(widths)
        elif spec["type"] == "all2all_str":
            spec["->"]["output_sample_shape"] = 32
    return specs


def _inject_masks(w, seed, jax_side):
    """Every dropout unit of ``w`` takes its masks from one numpy stream
    (the JAX units' jitted draw replaced, the port's device draw too)."""
    rng = np.random.default_rng(seed)

    def mask(shape, ratio):
        keep = rng.random(shape, dtype=np.float32) >= ratio
        return keep / np.float32(1.0 - ratio)

    for fwd in w.forwards:
        if type(fwd).__name__ != "DropoutForward":
            continue
        r = fwd.dropout_ratio
        if jax_side:
            def fn(x, key, r=r):
                m = jnp.asarray(mask(tuple(x.shape), r))
                return x * m, m
            fwd._xla_fn = fn
        else:
            fwd._make_mask_torch = lambda shape, dev, r=r: torch.tensor(
                mask(shape, r), device=dev)


def _workflow(cls, mod):
    return cls(name="AlexNet-small", layers=_small_layers(mod),
               loss_function="softmax", loader_name="synthetic_image",
               loader_config=dict(LOADER),
               decision_config={"max_epochs": EPOCHS}, fused=False)


def _conv_fc(w):
    return [(f.name, f.weights.map_read(), f.bias.map_read())
            for f in w.forwards if f.weights]


def test_alexnet_eager_matches_jax():
    jprng.seed_all(SEED)
    _pallas(True)
    try:
        jw = _workflow(JStandard, jalexnet)
        jw.initialize(device=TPUDevice())
        params = [{"w": f.weights.map_read().copy(),
                   "b": f.bias.map_read().copy()} if f.weights else None
                  for f in jw.forwards]
        state = jprng.get().state_dict()
        _inject_masks(jw, 99, jax_side=True)
        jw.run()
    finally:
        _pallas(False)
    tprng.seed_all(SEED)
    tw = _workflow(TStandard, talexnet)
    np.testing.assert_array_equal(np.asarray(tw.layer_specs, object),
                                  np.asarray(jw.layer_specs, object))
    load_forward_params(tw.forwards, params)
    tw.initialize(device=TorchDevice("cpu"))
    tprng.get().load_state_dict(state)
    _inject_masks(tw, 99, jax_side=False)
    # the conv gds run the kernel wrappers (their plain versions on CPU
    # tensors); the first conv asks for no input gradient
    calls = []
    backward = t_gd_conv.kconv.conv2d_backward

    def counted(*args, need_err_input):
        calls.append(need_err_input)
        return backward(*args, need_err_input=need_err_input)

    t_gd_conv.kconv.conv2d_backward = counted
    try:
        tw.run()
    finally:
        t_gd_conv.kconv.conv2d_backward = backward
    # per train minibatch (4 an epoch: 30 samples at batch 8) the gds run
    # conv5 .. conv1, and only conv1 skips the input gradient
    assert calls == ([True] * 4 + [False]) * 4 * EPOCHS
    assert bool(tw.decision.complete)
    assert tw.decision.metrics_history == jw.decision.metrics_history
    assert len(tw.decision.metrics_history) == EPOCHS
    for (name, w_t, b_t), (_, w_j, b_j), p in zip(
            _conv_fc(tw), _conv_fc(jw), [p for p in params if p]):
        assert not np.array_equal(w_t, p["w"]), name   # every layer trained
        np.testing.assert_allclose(w_t, w_j, rtol=0, atol=WEIGHT_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(b_t, b_j, rtol=0, atol=WEIGHT_ATOL,
                                   err_msg=name)


def test_alexnet_eager_at_dropout_0_trains_every_layer():
    """At dropout 0 the error reaches every layer: each gradient unit's
    err_output after the last train minibatch is nonzero, conv1's too
    (a zero mask in the dropout backward would stop it above fc7)."""
    tprng.seed_all(SEED)
    specs = _small_layers(talexnet, dropout=0.0)
    w = TStandard(name="AlexNet-small", layers=specs,
                  loss_function="softmax", loader_name="synthetic_image",
                  loader_config=dict(LOADER),
                  decision_config={"max_epochs": 1}, fused=False)
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    assert [type(g).__name__ for g in w.gds].count("DropoutBackward") == 2
    for gd in w.gds:
        assert np.abs(gd.err_output.map_read()).max() > 0, gd.name


def test_synthetic_image_loader_and_registry_match_jax():
    for name in ("synthetic_classifier", "synthetic_image",
                 "synthetic_regression"):
        assert t_loader_base.get_loader(name).__name__ == \
            j_loader_base.get_loader(name).__name__
    with pytest.raises(KeyError, match="registered"):
        t_loader_base.get_loader("no_such_loader")
    data = []
    for prng_mod, base in ((jprng, j_loader_base),
                           (tprng, t_loader_base)):
        prng_mod.seed_all(4)
        loader = base.get_loader("synthetic_image")(
            None, n_classes=5, sample_shape=(13, 10, 2), n_train=20,
            n_valid=10)
        loader.load_data()
        data.append((loader.original_data.mem, loader.original_labels.mem,
                     loader.class_lengths))
    np.testing.assert_array_equal(data[0][0], data[1][0])
    np.testing.assert_array_equal(data[0][1], data[1][1])
    assert data[0][2] == data[1][2]


# -- what the port refuses or does not have yet -----------------------------

def test_standard_workflow_fused_fc_only_trains():
    """fused=True builds FusedTrainStep as the reference does; an FC-only
    layer list trains through it."""
    tprng.seed_all(7)
    w = TStandard(
        name="fc", layers=[{"type": "all2all_tanh",
                            "->": {"output_sample_shape": 16},
                            "<-": {"learning_rate": 0.1}},
                           {"type": "softmax",
                            "->": {"output_sample_shape": 4},
                            "<-": {"learning_rate": 0.1}}],
        loader_name="synthetic_classifier",
        loader_config={"n_classes": 4, "sample_shape": (12,),
                       "n_train": 80, "n_valid": 40, "minibatch_size": 20},
        decision_config={"max_epochs": 3}, fused=True)
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    hist = w.decision.metrics_history
    assert len(hist) == 3 and w.step.n_err >= 0
    assert hist[-1]["metric_train"] < hist[0]["metric_train"]


def test_alexnet_refusals():
    tprng.seed_all(1)
    # the fused shape builds (tests/test_torch_port_fused_conv.py trains it)
    w = talexnet.build(input_size=67, n_train=100, fused=True)
    assert type(w.step).__name__ == "FusedTrainStep"
    # the image-file loaders are ported (tests/test_torch_port_image.py);
    # augment needs one of them, as in the reference
    for name, cls in (("file_image", "FileImageLoader"),
                      ("full_batch_image", "FullBatchImageLoader")):
        w = talexnet.build(fused=False, loader_name=name,
                           loader_config={"augment": True})
        assert type(w.loader).__name__ == cls
        assert w.loader.crop == (227, 227) and w.loader.mirror
    with pytest.raises(ValueError, match="image-file loader"):
        talexnet.build(fused=False, loader_config={"augment": True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TStandard(layers=_small_layers(talexnet), fused=True,
                  loader_name="synthetic_image", health_config={})
    # the snapshotter is ported (tests/test_torch_port_snapshotter.py):
    # its gated side chain sits after the Decision
    snapped = TStandard(layers=_small_layers(talexnet), fused=True,
                        loader_name="synthetic_image",
                        snapshotter_config={"only_improved": False})
    assert type(snapped.snapshotter).__name__ == "NNSnapshotter"
    assert snapped.decision in snapped.snapshotter.links_from
    # the input pipeline is ported (tests/test_torch_port_pipeline.py)
    piped = TStandard(layers=_small_layers(talexnet), fused=True,
                      loader_name="synthetic_image",
                      pipeline_config={"depth": 2})
    assert piped.input_pipeline.depth == 2
    assert piped.loader.pipeline is piped.input_pipeline
    for kw, msg in (({"optimizer": "adam"}, "requires fused"),
                    ({"clip_norm": 1.0}, "requires fused"),
                    ({"pipeline_config": {"depth": 2}}, "requires fused")):
        with pytest.raises(ValueError, match=msg):
            TStandard(layers=_small_layers(talexnet), fused=False,
                      loader_name="synthetic_image", **kw)
    with pytest.raises(ValueError, match="no loader"):
        TStandard(layers=_small_layers(talexnet), fused=False)
    with pytest.raises(KeyError, match="unknown layer type"):
        TStandard(layers=[{"type": "no_such_layer"}], fused=False,
                  loader_name="synthetic_image")


def test_load_forward_params_skips_paramless_layers():
    tprng.seed_all(2)
    w = talexnet.build(fused=False, input_size=67, n_train=100,
                       loader_config={"minibatch_size": 4})
    params = [{"w": np.full(f.weights.shape or (1,), 0.5)} if isinstance(
        f, t_conv.Conv) else ({} if i % 2 else None)
        for i, f in enumerate(w.forwards)]
    with pytest.raises(ValueError, match="param dicts"):
        load_forward_params(w.forwards, params[:-1])
    conv1 = w.forwards[0]
    conv1.weights.mem = np.zeros((11, 11, 3, 96), np.float32)
    load_forward_params(w.forwards, params)
    assert float(conv1.weights.mem.max()) == 0.5
    assert not w.forwards[1].weights     # LRN: skipped, still no weights
