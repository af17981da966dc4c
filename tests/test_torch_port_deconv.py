"""The port's deconv slice (``kernels/conv.py deconv2d`` /
``deconv2d_backward``, ``ops/deconv.py``, ``units/deconv.py``,
``units/gd_deconv.py``, the conv and deconv units' ``torch_apply`` and
``models/autoencoder.py``) against the JAX package on the CPU.

The same seeded numpy operands go through the reference's Pallas deconv
kernels in interpret mode and its numpy col2im oracle, and through the
port's wrappers on CPU tensors (their plain versions), at k3 s1 p0, k4 s2
p1, stride 3, asymmetric pads, and slack and cropped out_shapes; bands are
the conv ones in force (ROADMAP queue C): rtol 1e-4 / atol 1e-5 for
values, 1e-4 for the weight gradient (a sum over every pixel).  The
workflows (the reference on ``TPUDevice`` under ``engine.pallas`` +
``pallas_interpret`` when eager, its XLA forward and Pallas update kernels
when fused; the port on ``TorchDevice("cpu")``) start from the JAX run's
initial weights (``load_forward_params``) and the JAX shuffle stream's
state; their MSE histories agree within rtol 1e-5 (the reference's own
pin, tests/test_models.py:55-61) and their weights within the bands
below.  The kernel-vs-plain check on the card is ``cuda``-marked and
skips here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import znicz_tpu.units.conv as j_conv
import znicz_tpu.units.deconv as j_deconv
import znicz_tpu.units.gd_deconv as j_gd_deconv
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.core.memory import Array as JArray
from znicz_tpu.core.workflow import Workflow as JWorkflow
from znicz_tpu.models import autoencoder as jae
from znicz_tpu.ops import deconv as jdeconv
from znicz_tpu.ops.pallas import deconv2d as j_deconv2d
from znicz_tpu.ops.pallas import deconv2d_backward as j_deconv2d_backward

import znicz_tpu_torch.units.conv as t_conv
import znicz_tpu_torch.units.deconv as t_deconv
import znicz_tpu_torch.units.gd_deconv as t_gd_deconv
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import NumpyDevice, TorchDevice
from znicz_tpu_torch.core.memory import Array as TArray
from znicz_tpu_torch.core.workflow import Workflow as TWorkflow
from znicz_tpu_torch.kernels import conv as kconv
from znicz_tpu_torch.models import autoencoder as tae
from znicz_tpu_torch.ops import deconv as tdeconv
from znicz_tpu_torch.units.nn_units import load_forward_params

#: (oh, ow, nk, c, k, sliding, padding, slack): the deconv input (n, oh,
#: ow, nk), HWIO (k, k, c, nk) weights, and the rows/columns added to (or,
#: negative, cut from) output_shape_for's out_shape
GEOMS = [
    (5, 6, 4, 3, 3, (1, 1), (0, 0, 0, 0), (0, 0)),
    (4, 4, 6, 2, 4, (2, 2), (1, 1, 1, 1), (0, 0)),
    (3, 4, 5, 3, 3, (3, 3), (1, 1, 1, 1), (0, 0)),
    (4, 3, 5, 2, 3, (2, 1), (1, 0, 2, 1), (0, 0)),
    (4, 5, 3, 4, 5, (2, 2), (3, 1, 0, 2), (0, 0)),
    (3, 4, 5, 3, 3, (3, 3), (1, 1, 1, 1), (2, 1)),    # slack < stride
]
#: out_shapes the paired conv cannot take: the forward only
FWD_ONLY_SLACK = [(3, 2), (-1, -2)]
#: the workflows' weights, port vs reference.  Eager: both f32, the same
#: tap-loop arithmetic in other summation orders — 1.3e-7 measured.
#: Fused: the port's forward is F.conv2d / F.conv_transpose2d (oneDNN on
#: the CPU) and the reference's XLA's conv, each summing the <= 72
#: products of a value in its own blocking, and momentum 0.9 carries 4
#: epochs of those differences — 9.3e-7 measured on weights of 0.24, so
#: the band is twice the eager one
WEIGHT_ATOL = {"eager": 1e-6, "fused": 2e-6}
#: ConvAE MSE per epoch, port vs reference and vs the reference's pin
MSE_RTOL = 1e-5
#: tests/test_models.py:55-61, the reference's pinned ConvAE run
AE_PIN = [1.2079215, 0.39782357, 0.32945922, 0.25455874]


def _pallas(on: bool) -> None:
    jroot.common.engine.pallas = on
    jroot.common.engine.pallas_interpret = on


def _operands(geom, seed=7):
    oh, ow, nk, c, k, sliding, padding, slack = geom
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, oh, ow, nk)).astype(np.float32)
    w = (rng.normal(size=(k, k, c, nk)) * 0.1).astype(np.float32)
    n, h, wd, _ = jdeconv.output_shape_for(x.shape, w.shape, sliding,
                                           padding)
    out_shape = (n, h + slack[0], wd + slack[1], c)
    err = rng.normal(size=out_shape).astype(np.float32)
    return x, w, err, sliding, padding, out_shape


# -- the kernels' plain versions --------------------------------------------

@pytest.mark.parametrize("geom", GEOMS)
def test_deconv2d_matches_pallas_interpret_and_the_oracle(geom):
    x, w, _, sliding, padding, out_shape = _operands(geom)
    want = np.asarray(j_deconv2d(jnp.asarray(x), jnp.asarray(w), sliding,
                                 padding, out_shape, interpret=True))
    got = kconv.deconv2d(torch.tensor(x), torch.tensor(w), sliding, padding,
                         out_shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == out_shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    oracle = jdeconv.forward(np, x, w, sliding, padding, out_shape)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("geom", GEOMS)
def test_deconv2d_backward_matches_pallas_interpret_and_the_oracle(geom):
    x, w, err, sliding, padding, _ = _operands(geom, seed=11)
    ei_j, gw_j = j_deconv2d_backward(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(err), sliding, padding,
                                     interpret=True)
    ei_o, gw_o = jdeconv.backward(np, x, w, err, sliding, padding)
    ei, gw = kconv.deconv2d_backward(torch.tensor(x), torch.tensor(w),
                                     torch.tensor(err), sliding, padding)
    for want in (np.asarray(ei_j), ei_o):
        np.testing.assert_allclose(ei.numpy(), want, rtol=1e-4, atol=1e-5)
    for want in (np.asarray(gw_j), gw_o):
        np.testing.assert_allclose(gw.numpy(), want, rtol=1e-4, atol=1e-4)
    none, gw2 = kconv.deconv2d_backward(
        torch.tensor(x), torch.tensor(w), torch.tensor(err), sliding,
        padding, need_err_input=False)
    assert none is None and torch.equal(gw2, gw)


#: build_deep's deconv geometry (k4 s2 p1) at output channels c on each
#: side of the input-gradient kernel's N tiles (kernels/conv.py
#: input_grad_tile): 1, 3 and 8 in the 8-wide tile, 17 in the 32-wide one,
#: 64 and 96 at the tops of theirs
EDGE_C = (1, 3, 8, 17, 64, 96)


def _edge_geom(c):
    return (4, 3, 8, c, 4, (2, 2), (1, 1, 1, 1), (0, 0))


@pytest.mark.parametrize("c", EDGE_C)
def test_deconv2d_plain_at_the_tile_edges_matches_pallas_interpret(c):
    """The card's oracle for the deconv forward at every N tile of the
    input-gradient kernel, against the Pallas deconv2d in interpret mode
    and the reference's numpy deconv (rtol 1e-4, atol 1e-5)."""
    x, w, _, sliding, padding, out_shape = _operands(_edge_geom(c))
    got = kconv.deconv2d(torch.tensor(x), torch.tensor(w), sliding, padding,
                         out_shape)
    want = np.asarray(j_deconv2d(jnp.asarray(x), jnp.asarray(w), sliding,
                                 padding, out_shape, interpret=True))
    oracle = jdeconv.forward(np, x, w, sliding, padding, out_shape)
    assert tuple(got.shape) == out_shape
    for ref in (want, oracle):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("slack", FWD_ONLY_SLACK)
@pytest.mark.parametrize("geom", GEOMS[1:3])
def test_deconv2d_slack_and_cropped_out_shapes(geom, slack):
    """An out_shape the paired conv cannot produce: the forward is the
    adjoint all the same (zeros where no window reaches, the rest cut),
    as the reference's jnp path and its Pallas kernel compute it; the
    backward refuses it rather than compute it wrong."""
    x, w, _, sliding, padding, _ = _operands(geom[:-1] + (slack,))
    _, _, err, _, _, out_shape = _operands(geom[:-1] + (slack,))
    want = np.asarray(jdeconv.forward(jnp, jnp.asarray(x), jnp.asarray(w),
                                      sliding, padding, out_shape))
    pallas = np.asarray(j_deconv2d(jnp.asarray(x), jnp.asarray(w), sliding,
                                   padding, out_shape, interpret=True))
    for got in (kconv.deconv2d(torch.tensor(x), torch.tensor(w), sliding,
                               padding, out_shape),
                tdeconv.forward(torch, torch.tensor(x), torch.tensor(w),
                                sliding, padding, out_shape)):
        assert tuple(got.shape) == out_shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="paired conv"):
        kconv.deconv2d_backward(torch.tensor(x), torch.tensor(w),
                                torch.tensor(err), sliding, padding)


@pytest.mark.parametrize("geom", GEOMS)
def test_ops_deconv_matches_the_reference(geom):
    """``ops/deconv.py``: the numpy branch is the reference's code; the
    torch branch (conv_transpose2d + signed pad, and the kernels' plain
    versions backward) agrees with it, and its forward's autograd is the
    backward."""
    x, w, err, sliding, padding, out_shape = _operands(geom, seed=3)
    assert tdeconv.output_shape_for(x.shape, w.shape, sliding, padding) == \
        jdeconv.output_shape_for(x.shape, w.shape, sliding, padding)
    assert tdeconv.min_output_size(4, 4, 2, 1, 1) == \
        jdeconv.min_output_size(4, 4, 2, 1, 1)
    y = jdeconv.forward(np, x, w, sliding, padding, out_shape)
    np.testing.assert_array_equal(
        tdeconv.forward(np, x, w, sliding, padding, out_shape), y)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    yt = tdeconv.forward(torch, xt, wt, sliding, padding, out_shape)
    np.testing.assert_allclose(yt.detach().numpy(), y, rtol=1e-5, atol=1e-6)
    wants = jdeconv.backward(np, x, w, err, sliding, padding)
    for got, want in zip(tdeconv.backward(np, x, w, err, sliding, padding),
                         wants):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tdeconv.backward(torch, torch.tensor(x),
                                          torch.tensor(w),
                                          torch.tensor(err), sliding,
                                          padding), wants):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    (yt * torch.tensor(err)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), wants[0], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), wants[1], rtol=1e-4,
                               atol=1e-4)


def test_cpu_calls_take_the_plain_path_and_count_no_launch():
    x, w, err, sliding, padding, out_shape = (
        torch.tensor(a) if isinstance(a, np.ndarray) else a
        for a in _operands(GEOMS[1]))
    before = (kconv.fwd_launches, kconv.input_grad_launches,
              kconv.weight_grad_launches, kconv.deconv_fwd_launches,
              kconv.deconv_bwd_launches)
    assert torch.equal(kconv.deconv2d(x, w, sliding, padding, out_shape),
                       kconv.deconv2d_plain(x, w, sliding, padding,
                                            out_shape))
    got = kconv.deconv2d_backward(x, w, err, sliding, padding)
    want = kconv.deconv2d_backward_plain(x, w, err, sliding, padding)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (kconv.fwd_launches, kconv.input_grad_launches,
            kconv.weight_grad_launches, kconv.deconv_fwd_launches,
            kconv.deconv_bwd_launches) == before


def test_deconv_bound_counts_the_paired_conv():
    """build_deep's last deconv at batch 64: (64, 32, 32, 64) -> (64, 64,
    64, 3) is the adjoint of the k4 s2 p1 conv of a 64x64x3 input."""
    x_shape, w_shape = (64, 32, 32, 64), (4, 4, 3, 64)
    geom = ((2, 2), (1, 1, 1, 1))
    out_shape = (64, 64, 64, 3)
    fwd = kconv.deconv_bound(x_shape, w_shape, *geom, out_shape)
    ig = kconv.bound("input_grad", out_shape, w_shape, *geom)
    assert (fwd["flops"], fwd["bytes"]) == (ig["flops"], ig["bytes"])
    # each of the 32 outputs a row reaches 4 taps but the first and the
    # last, which reach 3 (the pad): 126 (o, t) pairs a row
    assert fwd["flops"] == 2 * 64 * 3 * 64 * 126 * 126
    bwd = kconv.deconv_bound(x_shape, w_shape, *geom, out_shape,
                             backward=True)
    assert bwd["flops"] == 2 * fwd["flops"]
    assert bwd["bytes"] == 4 * (2 * 64 * 32 * 32 * 64 + 2 * 4 * 4 * 3 * 64 +
                                64 * 64 * 64 * 3)
    half = kconv.deconv_bound(x_shape, w_shape, *geom, out_shape,
                              backward=True, need_err_input=False)
    assert half["flops"] == fwd["flops"] and half["bytes"] < bwd["bytes"]


def test_deconv_wrappers_refuse_bad_calls():
    x, w = torch.ones(2, 4, 4, 6), torch.ones(3, 3, 2, 6)
    geom = ((2, 2), (1, 1, 1, 1))
    shape = (2, 7, 7, 2)
    for bad in (x.double(), x.half(), x.bfloat16()):
        with pytest.raises(ValueError, match="float32"):
            kconv.deconv2d(bad, w, *geom, shape)
        with pytest.raises(ValueError, match="float32"):
            kconv.deconv2d(bad.to("meta"), w.to("meta"), *geom, shape)
    with pytest.raises(ValueError, match="float32"):
        kconv.deconv2d_backward(x, w.double(), torch.ones(shape), *geom)
    with pytest.raises(ValueError, match="kernels"):
        kconv.deconv2d(x, torch.ones(3, 3, 2, 5), *geom, shape)
    with pytest.raises(ValueError, match="out_shape"):
        kconv.deconv2d(x, w, *geom, (2, 7, 7, 3))
    with pytest.raises(ValueError, match="agree"):
        kconv.deconv2d_backward(x, w, torch.ones(2, 7, 7, 5), *geom)
    with pytest.raises(ValueError, match="contiguous"):
        kconv.deconv2d(x.transpose(1, 2), w, *geom, shape)


# -- the unit pair ----------------------------------------------------------

GEOM = dict(sliding=(2, 2), padding=(1, 1, 1, 1))


def _deconv_pair(ns, gd_ns, array_cls, workflow_cls, device, params,
                 need_err_input=True):
    """tests/test_deconv.py:82-102's standalone pair: one forward, one
    gradient step."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 4, 6)).astype(np.float32)
    w = workflow_cls(name="t")
    fwd = ns.Deconv(w, n_kernels=6, kx=3, ky=3, n_channels=2, **GEOM)
    fwd.input = array_cls(x)
    if params is not None:
        load_forward_params([fwd], params)
    fwd.initialize(device=device)
    init = [{"w": fwd.weights.map_read().copy()}]
    fwd.run()
    gd = gd_ns.GDDeconv(w, learning_rate=0.1, gradient_moment=0.9,
                        need_err_input=need_err_input)
    gd.link_from_forward(fwd)
    gd.err_output = array_cls(rng.normal(size=fwd.output.shape)
                              .astype(np.float32))
    gd.batch_size = 2
    gd.initialize(device=device)
    gd.run()
    return init, {a: np.array(getattr(gd, a).map_read()) for a in
                  ("output", "err_input", "weights", "gradient_weights")}


def test_deconv_unit_pair_matches_jax():
    """The reference's Pallas route against the port's kernel route (plain
    versions on the CPU) and its numpy oracle, from the same weights."""
    jprng.seed_all(5)
    _pallas(True)
    try:
        params, want = _deconv_pair(j_deconv, j_gd_deconv, JArray,
                                    JWorkflow, TPUDevice(), None)
    finally:
        _pallas(False)
    assert want["output"].shape == (2, 7, 7, 2)
    for device in (TorchDevice("cpu"), NumpyDevice()):
        _, got = _deconv_pair(t_deconv, t_gd_deconv, TArray, TWorkflow,
                              device, params)
        for attr, value in want.items():
            np.testing.assert_allclose(got[attr], value, rtol=1e-4,
                                       atol=1e-5, err_msg=attr)
    # need_err_input=False: the same update, err_input never written
    _, got = _deconv_pair(t_deconv, t_gd_deconv, TArray, TWorkflow,
                          TorchDevice("cpu"), params, need_err_input=False)
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=1e-4,
                               atol=1e-5)
    assert not got["err_input"].any()


def test_deconv_draws_its_weights_like_the_reference():
    """Standalone weights: fan-in kx·ky·n_kernels, the same prng draw."""
    ws = []
    for prng_mod, ns, arr, wf in ((jprng, j_deconv, JArray, JWorkflow),
                                  (tprng, t_deconv, TArray, TWorkflow)):
        prng_mod.seed_all(9)
        fwd = ns.Deconv(wf(name="t"), n_kernels=5, kx=4, ky=3,
                        n_channels=2, **GEOM)
        fwd.input = arr(np.zeros((1, 3, 3, 5), np.float32))
        fwd.initialize(device=NumpyDevice() if ns is t_deconv else
                       TPUDevice())
        ws.append(np.array(fwd.weights.map_read()))
    assert ws[1].shape == (3, 4, 2, 5)
    np.testing.assert_array_equal(ws[0], ws[1])
    assert np.abs(ws[1]).max() <= np.sqrt(3.0 / (4 * 3 * 5)) + 1e-7


def _tied(ns, conv_ns, gd_ns, array_cls, workflow_cls, device, params):
    """tests/test_deconv.py:105-121's tied pair, then one GDDeconv step
    that updates the conv's weights through the tie."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 8, 8, 1)).astype(np.float32)
    w = workflow_cls(name="t")
    conv = conv_ns.Conv(w, n_kernels=3, kx=3, ky=3)
    conv.input = array_cls(x)
    de = ns.Deconv(w, n_kernels=3, kx=3, ky=3)
    de.link_conv_attrs(conv)
    if params is not None:
        load_forward_params([conv, de], params)
    conv.initialize(device=device)
    init = [{"w": conv.weights.map_read().copy(),
             "b": conv.bias.map_read().copy()}, None]
    conv.run()
    de.input = array_cls(np.array(conv.output.map_read()))
    de.initialize(device=device)
    de.run()
    out = np.array(de.output.map_read())
    gd = gd_ns.GDDeconv(w, learning_rate=0.1, gradient_moment=0.9)
    gd.link_from_forward(de)
    gd.err_output = array_cls(out - x)
    gd.batch_size = 1
    gd.initialize(device=device)
    gd.run()
    with pytest.raises(RuntimeError, match="eager-only"):
        de.param_arrays()
    return init, out, np.array(conv.weights.map_read())


def test_tied_deconv_follows_its_conv_like_jax():
    """The tie carries the conv's weights into the deconv, the weights
    cross over to the port through the conv (``load_forward_params``
    fills a tied Deconv through its conv), and GDDeconv's step moves the
    conv's weights."""
    jprng.seed_all(6)
    _pallas(True)
    try:
        params, out_j, w_j = _tied(j_deconv, j_conv, j_gd_deconv, JArray,
                                   JWorkflow, TPUDevice(), None)
    finally:
        _pallas(False)
    _, out_t, w_t = _tied(t_deconv, t_conv, t_gd_deconv, TArray,
                          TWorkflow, TorchDevice("cpu"), params)
    assert out_t.shape == (1, 8, 8, 1)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-4, atol=1e-5)
    # weights given to the tied deconv land in its conv
    tprng.seed_all(6)
    w = TWorkflow(name="t")
    conv = t_conv.Conv(w, n_kernels=3, kx=3, ky=3)
    de = t_deconv.Deconv(w, n_kernels=3, kx=3, ky=3).link_conv_attrs(conv)
    load_forward_params([conv, de], [{}, {"w": np.full((3, 3, 1, 3), 0.5)}])
    assert conv.weights.mem is de.weights.mem
    assert float(conv.weights.mem.min()) == 0.5


# -- the workflows ----------------------------------------------------------

def _ae_runs(fused, build="build", seed=31, **kw):
    """The reference's and the port's runs of one autoencoder builder
    from one seed and the same initial weights -> both workflows."""
    jprng.seed_all(seed)
    _pallas(True)
    try:
        jw = getattr(jae, build)(fused=fused, **kw)
        jw.initialize(device=TPUDevice())
        params = [{"w": f.weights.map_read().copy(),
                   **({"b": f.bias.map_read().copy()} if f.bias else {})}
                  for f in jw.forwards]
        state = jprng.get().state_dict()
        jw.run()
        if fused:
            jw.step.sync_to_units()
    finally:
        _pallas(False)
    tprng.seed_all(seed)
    tw = getattr(tae, build)(fused=fused, **kw)
    np.testing.assert_array_equal(np.asarray(tw.layer_specs, object),
                                  np.asarray(jw.layer_specs, object))
    load_forward_params(tw.forwards, params)
    tw.initialize(device=TorchDevice("cpu"))
    tprng.get().load_state_dict(state)
    tw.run()
    if fused:
        tw.step.sync_to_units()
    return jw, tw, params


def _mse(w):
    return [[h[k] for k in sorted(h) if k.startswith("metric")]
            for h in w.decision.metrics_history]


def _weights(w):
    return [np.array(f.weights.map_read()) for f in w.forwards]


@pytest.mark.parametrize("fused", [False, True])
def test_conv_autoencoder_matches_jax(fused):
    """models/autoencoder.py build at tests/test_models.py:55-61's
    arguments, eager on the kernels' plain versions and fused on
    torch_apply + the update kernels' plain versions, against the JAX
    runs and the reference's pin."""
    jw, tw, params = _ae_runs(fused, max_epochs=4, n_train=200, n_valid=64,
                              sample_shape=(12, 12, 1))
    assert bool(tw.decision.complete) and len(_mse(tw)) == 4
    np.testing.assert_allclose(_mse(tw), _mse(jw), rtol=MSE_RTOL)
    np.testing.assert_allclose(
        [h["metric_validation"] for h in tw.decision.metrics_history],
        AE_PIN, rtol=MSE_RTOL)
    kind = "fused" if fused else "eager"
    for got, want, p in zip(_weights(tw), _weights(jw), params):
        assert not np.array_equal(got, p["w"])       # every layer trained
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=WEIGHT_ATOL[kind])
    if not fused:
        assert [type(g).__name__ for g in tw.gds] == \
            ["GradientDescentConv", "GDDeconv"]
        assert tw.gds[0].need_err_input is False


def test_deep_autoencoder_eager_matches_jax_and_mirrors_its_input():
    """build_deep shrunk as tests/test_models.py:233-247 shrinks it
    (16x16x3, n_kernels (8, 16), batch 16, 64 samples, 3 epochs)."""
    jw, tw, _ = _ae_runs(False, "build_deep", seed=7, max_epochs=3,
                         minibatch_size=16, sample_shape=(16, 16, 3),
                         n_kernels=(8, 16), n_train=64)
    assert [f.output.shape[1] for f in tw.forwards] == [8, 4, 8, 16]
    assert tw.forwards[-1].output.shape[1:] == (16, 16, 3)
    np.testing.assert_allclose(_mse(tw), _mse(jw), rtol=MSE_RTOL)
    hist = tw.decision.metrics_history
    assert hist[-1]["metric_train"] < hist[0]["metric_train"]
    for got, want in zip(_weights(tw), _weights(jw)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=WEIGHT_ATOL["eager"])


def test_autoencoder_fused_equals_eager_in_the_port():
    """The port's two shapes of one run: eager (the kernels' plain tap
    loops, per-unit SGD) and fused (F.conv2d / conv_transpose2d with
    autograd, the update kernels' plain versions), both f32."""
    runs = {}
    for fused in (False, True):
        tprng.seed_all(13)
        w = tae.build_deep(fused=fused, max_epochs=2, minibatch_size=16,
                           sample_shape=(16, 16, 3), n_kernels=(8, 16),
                           n_train=64, n_valid=16)
        w.initialize(device=TorchDevice("cpu"))
        w.run()
        if fused:
            w.step.sync_to_units()
        runs[fused] = w
    np.testing.assert_allclose(_mse(runs[True]), _mse(runs[False]),
                               rtol=MSE_RTOL)
    for got, want in zip(_weights(runs[True]), _weights(runs[False])):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=WEIGHT_ATOL["fused"])


def test_autoencoder_refusals_and_device_default():
    # a tied deconv has no params of its own: the fused step refuses it
    tprng.seed_all(1)
    w = tae.build(fused=True, max_epochs=1, n_train=20, n_valid=10,
                  minibatch_size=10)
    w.forwards[1].link_conv_attrs(w.forwards[0])
    with pytest.raises(RuntimeError, match="eager-only"):
        w.initialize(device=TorchDevice("cpu"))
    # a deconv whose n_kernels is not its input's channels
    w = tae.build_deep(fused=False, max_epochs=1, sample_shape=(8, 8, 1),
                       n_kernels=(4, 6), n_train=8, minibatch_size=4)
    w.forwards[2].n_kernels = 5
    with pytest.raises(ValueError, match="n_kernels"):
        w.initialize(device=TorchDevice("cpu"))
    with pytest.raises(ValueError, match="n_kernels, kx, ky"):
        t_deconv.Deconv(TWorkflow(name="t"), kx=3, ky=3)
    with pytest.raises(ValueError, match="n_channels"):
        d = t_deconv.Deconv(TWorkflow(name="t"), n_kernels=2, kx=3, ky=3)
        d.input = TArray(np.zeros((1, 4, 4, 2), np.float32))
        d.initialize(device=TorchDevice("cpu"))
    # without a CPU device the builders build for cuda, never the CPU
    if not torch.cuda.is_available():
        for fused in (False, True):
            w = tae.build(fused=fused, max_epochs=1, n_train=20, n_valid=10,
                          minibatch_size=10)
            with pytest.raises((RuntimeError, AssertionError)):
                w.initialize(device=TorchDevice())


@pytest.mark.cuda
def test_deconv_kernels_match_plain_on_the_card():
    """The deconv wrappers on the card against their plain versions (TF32
    off) at the geometries above, bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for geom in GEOMS:
            x, w, err, sliding, padding, out_shape = (
                torch.tensor(a, device="cuda") if isinstance(a, np.ndarray)
                else a for a in _operands(geom))
            y = kconv.deconv2d(x, w, sliding, padding, out_shape)
            assert torch.equal(y, kconv.deconv2d(x, w, sliding, padding,
                                                 out_shape))
            torch.testing.assert_close(
                y, kconv.deconv2d_plain(x, w, sliding, padding, out_shape),
                rtol=1e-5, atol=1e-5)
            got = kconv.deconv2d_backward(x, w, err, sliding, padding)
            want = kconv.deconv2d_backward_plain(x, w, err, sliding, padding)
            for g, w_ in zip(got, want):
                torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_deconv2d_kernel_at_the_tile_edges_on_the_card():
    """deconv2d on the card at every N tile of the input-gradient kernel
    against its plain version (TF32 off), bit-identical across two
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for c in EDGE_C:
            x, w, _, sliding, padding, out_shape = (
                torch.tensor(a, device="cuda") if isinstance(a, np.ndarray)
                else a for a in _operands(_edge_geom(c)))
            y = kconv.deconv2d(x, w, sliding, padding, out_shape)
            assert torch.equal(y, kconv.deconv2d(x, w, sliding, padding,
                                                 out_shape))
            torch.testing.assert_close(
                y, kconv.deconv2d_plain(x, w, sliding, padding, out_shape),
                rtol=1e-5, atol=1e-5)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
