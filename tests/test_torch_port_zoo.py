"""The port's rest of the zoo (``znicz_tpu_torch/models/{wine,
approximator,spam,tv_channels,rbm}.py``) against the JAX package on the
CPU.

Both packages build each model from one seed at its ``build()`` defaults
(the epochs the reference's own pins use); the reference runs on
``TPUDevice`` (plain XLA, as its pinned tests run it) or ``NumpyDevice``,
the port on ``TorchDevice("cpu")`` (the kernels' plain versions) or
``NumpyDevice``.  The port's seeded initial weights must equal the
reference's, so each side draws its own.  Checks:

- classifier histories (integer n_err per epoch) identical to the JAX
  run's and to the reference's pins (``tests/test_models.py``,
  ``tests/test_zoo_text_faces.py``); MSE histories within ``MSE_RTOL``;
- the final weights within ``WEIGHT_ATOL`` (the MNIST FC SGD band and
  the fused conv band, both 1e-6);
- the CD-1 RBM with the same numpy uniforms injected into both packages'
  ``Binarization`` (the reference's ``jax.random.uniform``, the port's
  ``draw_uniform``): the MSE history within ``MSE_RTOL``, ``W``,
  ``vbias``, ``hbias`` within ``WEIGHT_ATOL``; and the port's own seeded
  run improving its reconstruction, as the reference's test asks.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import NumpyDevice as JNumpyDevice
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.models import approximator as japprox
from znicz_tpu.models import rbm as jrbm
from znicz_tpu.models import spam as jspam
from znicz_tpu.models import tv_channels as jtv
from znicz_tpu.models import wine as jwine

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import NumpyDevice, TorchDevice
from znicz_tpu_torch.models import approximator as tapprox
from znicz_tpu_torch.models import rbm as trbm
from znicz_tpu_torch.models import spam as tspam
from znicz_tpu_torch.models import tv_channels as ttv
from znicz_tpu_torch.models import wine as twine
from znicz_tpu_torch.units.rbm import Binarization as TBinarization

#: MSE histories, port vs reference: both f32, summed in other orders
MSE_RTOL = 1e-5
#: final weights, port vs reference: the MNIST FC SGD band and the fused
#: conv band (tests/test_torch_port_mnist.py, test_torch_port_fused_conv.py)
WEIGHT_ATOL = 1e-6
#: TvChannels eager on torch against the reference's XLA run: the
#: weights are held to WEIGHT_ATOL at the end of epoch 3 (7.8e-8
#: measured).  The pin's run goes on to epoch 8 at lr 0.05, momentum 0.9,
#: through the epochs whose validation n_err swings (10 -> 25 -> 16),
#: which amplify the two sides' summation-order differences to 1e-5 by
#: the end; there the n_err histories must still be identical.  The
#: numpy oracles are bit-identical to the end
TV_EAGER_HELD_EPOCH = 3
#: the reference's pins (tests/test_models.py, tests/test_zoo_text_faces.py)
WINE_PIN = ([19] + [0] * 9, 8)
APPROX_PIN = [2.572527, 0.283226, 0.18658, 0.079837, 0.054828]
SPAM_PIN = ([86, 0, 0, 0, 0], 28)
TV_PIN = [176, 178, 82, 37, 0, 0]
TV_EAGER_PIN = [84, 88, 78, 10, 25, 16, 2, 0]


def _at_epoch(w, epoch, out):
    """Record ``_weights(w)`` at the end of ``epoch`` into ``out``."""
    logged = w.decision.on_epoch_logged

    def on_epoch_logged():
        logged()
        if len(w.decision.metrics_history) == epoch:
            out.extend(_weights(w))
    w.decision.on_epoch_logged = on_epoch_logged


def _pair(jmod, tmod, seed, jdev, tdev, snap=None, port_kw=None, **kw):
    """Each package's ``build(**kw)`` from ``seed`` (the port's updated
    with ``port_kw``), initialized on its device and run -> (jax
    workflow, port workflow); with ``snap``
    (epoch, jax list, port list) an eager run's weights at that epoch's
    end land in the lists.  The port's initial weights must be the
    reference's before either trains."""
    jprng.seed_all(seed)
    jw = jmod.build(**kw)
    jw.initialize(device=jdev)
    init = [np.array(f.weights.map_read()) for f in jw.forwards
            if f.weights]
    if snap:
        _at_epoch(jw, snap[0], snap[1])
    jw.run()
    tprng.seed_all(seed)
    tw = tmod.build(**{**kw, **(port_kw or {})})
    tw.initialize(device=tdev)
    for got, want in zip([f.weights.map_read() for f in tw.forwards
                          if f.weights], init, strict=True):
        np.testing.assert_array_equal(got, want)
    if snap:
        _at_epoch(tw, snap[0], snap[2])
    tw.run()
    for w in (jw, tw):
        assert bool(w.decision.complete)
        if getattr(w, "step", None) is not None:
            w.step.sync_to_units()
    return jw, tw


def _weights(w):
    return [(f.name, a, np.array(getattr(f, a).map_read()))
            for f in w.forwards for a in ("weights", "bias")
            if getattr(f, a, None)]


def _held(tw, jw, atol=WEIGHT_ATOL):
    _held_lists(_weights(tw), _weights(jw), atol)


def _held_lists(port, ref, atol):
    pairs = list(zip(port, ref, strict=True))
    assert pairs
    for (name, attr, got), (_, _, want) in pairs:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=f"{name}.{attr}")


def _ints(hist, key):
    return [int(h[key]) for h in hist]


def _mse(hist):
    return [[h[k] for k in sorted(h) if k.startswith("metric")]
            for h in hist]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_wine_matches_jax_and_the_pin(fused):
    jw, tw = _pair(jwine, twine, 31, TPUDevice(), TorchDevice("cpu"),
                   max_epochs=10, fused=fused)
    hist = tw.decision.metrics_history
    assert hist == jw.decision.metrics_history
    assert (_ints(hist, "metric_validation"),
            int(hist[0]["metric_train"])) == WINE_PIN
    _held(tw, jw)


def test_approximator_regression_matches_jax_and_the_pin():
    jw, tw = _pair(japprox, tapprox, 31, TPUDevice(), TorchDevice("cpu"),
                   max_epochs=5)
    hist = tw.decision.metrics_history
    np.testing.assert_allclose(_mse(hist), _mse(jw.decision.metrics_history),
                               rtol=MSE_RTOL)
    np.testing.assert_allclose([h["metric_validation"] for h in hist],
                               APPROX_PIN, rtol=1e-4)
    _held(tw, jw)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_approximator_prototypes_matches_jax(fused):
    """prototypes=5: nearest-target n_err, eager (EvaluatorMSE) and fused
    (the label recovered as the target's nearest prototype)."""
    jw, tw = _pair(japprox, tapprox, 31, TPUDevice(), TorchDevice("cpu"),
                   max_epochs=5, prototypes=5, fused=fused)
    np.testing.assert_allclose(_mse(tw.decision.metrics_history),
                               _mse(jw.decision.metrics_history),
                               rtol=MSE_RTOL)
    if fused:
        assert isinstance(tw.step.n_err, int)
        assert tw.step.n_err == jw.step.n_err
        assert tw.step.n_err <= 10
    else:
        assert tw.evaluator.class_targets.shape == (5, 4)
        assert tw.evaluator._classifies
        assert tw.evaluator.n_err == jw.evaluator.n_err == 0
    _held(tw, jw)


def test_spam_matches_jax_and_the_pin(tmp_path):
    """Each package synthesizes its seeded corpus in a dir of its own
    under the test's tmp dir."""
    jw, tw = _pair(jspam, tspam, 31, TPUDevice(), TorchDevice("cpu"),
                   max_epochs=5,
                   loader_config={"data_dir": str(tmp_path / "jax")},
                   port_kw={"loader_config": {
                       "data_dir": str(tmp_path / "port")}})
    hist = tw.decision.metrics_history
    assert hist == jw.decision.metrics_history
    assert (_ints(hist, "metric_validation"),
            int(hist[0]["metric_train"])) == SPAM_PIN
    assert tw.loader.class_lengths == [0, 200, 600]
    assert tw.loader.vocab == jw.loader.vocab and len(tw.loader.vocab) == 256
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax")
    _held(tw, jw)


def test_tv_channels_fused_matches_jax_and_the_pin():
    jw, tw = _pair(jtv, ttv, 31, TPUDevice(), TorchDevice("cpu"),
                   max_epochs=6)
    hist = tw.decision.metrics_history
    assert hist == jw.decision.metrics_history
    assert _ints(hist, "metric_validation") == TV_PIN
    assert tw.forwards[0].output.shape == (50, 10, 10, 3)      # cropped
    _held(tw, jw)


@pytest.mark.parametrize("device", ["numpy", "torch"])
def test_tv_channels_eager_through_gd_cutter_matches_jax(device):
    """The eager chain routes the conv's input gradient through GDCutter
    (zero-padding it back into frame geometry): the reference's pinned
    eager run (NumpyDevice), on the port's numpy oracle and on torch."""
    jdev, tdev = ((JNumpyDevice(), NumpyDevice()) if device == "numpy"
                  else (TPUDevice(), TorchDevice("cpu")))
    snap = (TV_EAGER_HELD_EPOCH, [], [])
    jw, tw = _pair(jtv, ttv, 31, jdev, tdev, snap=snap, max_epochs=8,
                   n_train=400, n_valid=100, lr=0.05, fused=False)
    hist = tw.decision.metrics_history
    assert hist == jw.decision.metrics_history
    assert _ints(hist, "metric_validation") == TV_EAGER_PIN
    assert type(tw.gds[0]).__name__ == "GDCutter"
    assert tw.gds[1].need_err_input
    if device == "numpy":
        _held(tw, jw, 0)
    else:
        _held_lists(snap[2], snap[1], WEIGHT_ATOL)


class _Uniforms:
    """One seeded stream of numpy uniforms that both packages'
    ``Binarization`` draw, in draw order, each side from its own cursor."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.drawn = []
        self.cursor = {"jax": 0, "port": 0}

    def take(self, side, shape):
        i = self.cursor[side]
        if i == len(self.drawn):
            self.drawn.append(self.rng.uniform(size=shape)
                              .astype(np.float32))
        self.cursor[side] += 1
        u = self.drawn[i]
        assert u.shape == tuple(shape)
        return u


def test_rbm_matches_jax_with_the_same_uniforms(monkeypatch):
    uni = _Uniforms(5)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "uniform",
                  lambda key, shape: jnp.asarray(uni.take("jax", shape)))
        m.setattr(TBinarization, "draw_uniform",
                  lambda self, shape, device: torch.from_numpy(
                      uni.take("port", shape)).to(device))
        jw, tw = _pair(jrbm, trbm, 11, TPUDevice(), TorchDevice("cpu"),
                       max_epochs=6)
    assert uni.cursor["jax"] == uni.cursor["port"] == len(uni.drawn) > 0
    np.testing.assert_allclose(_mse(tw.decision.metrics_history),
                               _mse(jw.decision.metrics_history),
                               rtol=MSE_RTOL)
    tu = {u.name: u for u in tw.units}
    ju = {u.name: u for u in jw.units}
    for attr in ("weights", "vbias", "hbias"):
        np.testing.assert_allclose(
            getattr(tu["update"], attr).map_read(),
            getattr(ju["update"], attr).map_read(), rtol=0,
            atol=WEIGHT_ATOL, err_msg=attr)
    # h2v reads the shared (nv, nh) weights transposed
    assert tu["h2v"].weights is tu["v2h"].weights
    assert tu["h2v"].weights_transposed


def test_rbm_reconstruction_improves_on_its_own_draws():
    """The reference's property (tests/test_kohonen_rbm.py) on the port's
    own generator."""
    tprng.seed_all(11)
    w = trbm.build(max_epochs=6)
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    assert bool(w.decision.complete)
    hist = [h["metric_validation"] for h in w.decision.metrics_history]
    assert hist[-1] < hist[0], hist
