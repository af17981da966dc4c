"""The port's fused conv shape against the JAX package on the CPU.

- ``ops/pooling.py``'s fused forms (max, max-|x|, avg, stochastic and its
  |x| variant) forward and backward against ``jax.vjp`` of the
  reference's custom-VJP forms: AlexNet's overlapping k3 s2, MNIST's 2x2
  tiling, ragged ceil-mode borders, a stride past the window, ties;
- ``StandardWorkflow(fused=True)`` with AlexNet's geometry at test size
  (67 px, conv 8/16/16/16/8, fc 32/32, 10 classes, batch 8; dropout 0 and
  0.5), MNIST conv with both pools stochastic at narrow widths, and
  ``cifar_conv.build`` on the synthetic loader, each against the JAX
  fused run (``engine.pallas`` + ``pallas_interpret``) from the same
  initial weights and shuffles: identical n_err, weights within
  ``WEIGHT_ATOL``.  Where a forward draws, both packages take the same
  seeded numpy uniforms: the reference's ``jax.random.uniform`` is
  replaced by a host callback keyed by the key it is given, the port's
  ``draw_uniform`` by the same uniforms in draw order;
- the port's fused run equals its eager run where nothing is drawn;
- the step's generator: minted once at initialize, drawn once a step by
  each NEEDS_RNG forward in forward order, never at eval;
- the models' fused defaults build and train.
"""

import collections
import copy
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.models import alexnet as jalexnet
from znicz_tpu.models import cifar_conv as jcifar
from znicz_tpu.models import mnist_conv as jmnist_conv
from znicz_tpu.ops import pooling as jpool
from znicz_tpu.standard_workflow import StandardWorkflow as JStandard

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.kernels import lrn as klrn
from znicz_tpu_torch.models import alexnet as talexnet
from znicz_tpu_torch.models import cifar_conv as tcifar
from znicz_tpu_torch.models import mnist_conv as tmnist_conv
from znicz_tpu_torch.ops import pooling as tpool
from znicz_tpu_torch.parallel.step import FusedTrainStep
from znicz_tpu_torch.standard_workflow import StandardWorkflow as TStandard
from znicz_tpu_torch.units.nn_units import load_forward_params

#: weights after 3 epochs, port fused vs reference fused: both f32, the
#: same uniforms, differing in summation order only (oneDNN's convs and
#: matmuls against XLA's; the port's LRN backward is the exact adjoint,
#: the reference's autodiff of the jnp forward) — 1.8e-7 measured
WEIGHT_ATOL = 1e-6
#: the avg pool's forward where a window is clipped: XLA sums the padded
#: window in another order than the taps' row-major one, up to 2.4e-7
#: apart on these O(1) inputs (bit-identical where no window is clipped)
AVG_CLIPPED_ATOL = 5e-7
#: (shape, window side, stride): AlexNet's overlapping k3 s2 (13 -> 6),
#: MNIST's 2x2 tiling, ragged ceil-mode edges at k3 s2 and k2 s2, and a
#: stride past the window
POOL_GEOMS = [((3, 13, 13, 4), 3, 2), ((2, 8, 8, 3), 2, 2),
              ((2, 9, 8, 3), 3, 2), ((2, 9, 7, 3), 2, 2),
              ((2, 7, 7, 2), 2, 3)]
#: the AlexNet test-size loader: 10 classes of 67x67x3 images, 30 train
#: and 10 validation samples, batch 8
ALEX_LOADER = {"n_classes": 10, "sample_shape": (67, 67, 3), "n_train": 32,
               "n_valid": 16, "minibatch_size": 8, "spread": 1.0,
               "noise": 0.5}
EPOCHS = 3


# -- the fused pooling forms ------------------------------------------------

def _clipped(shape, k, s):
    return any((tpool.pool_out_size(n, k, s) - 1) * s + k > n
               for n in shape[1:3])


@pytest.mark.parametrize("geom", POOL_GEOMS)
@pytest.mark.parametrize("kind", ["max", "maxabs", "avg", "stochastic",
                                  "stochastic_abs"])
@pytest.mark.parametrize("ties", [False, True])
def test_fused_pooling_forms_match_jax_vjp(geom, kind, ties):
    """Forward and VJP against the reference's forms on the same x, u and
    cotangent: the same bits (integer-valued inputs tie often, so the
    first-winner rule shows), but for the avg forward's clipped windows."""
    shape, k, s = geom
    rng = np.random.default_rng(zlib.crc32(repr((geom, kind, ties)).encode()))
    x = (rng.integers(-2, 3, shape) if ties
         else rng.normal(size=shape)).astype(np.float32)
    oh, ow = (tpool.pool_out_size(n, k, s) for n in shape[1:3])
    u = rng.random((shape[0], oh, ow, shape[3]), dtype=np.float32)
    g = rng.normal(size=u.shape).astype(np.float32)
    if kind.startswith("stochastic"):
        use_abs = kind.endswith("abs")
        j_fn = lambda a: jpool.stochastic_forward_fast(   # noqa: E731
            a, jnp.asarray(u), k, k, s, s, use_abs)
        t_fn = lambda a: tpool.stochastic_forward_fast(   # noqa: E731
            a, torch.tensor(u), k, k, s, s, use_abs)
    else:
        name = f"{kind}_forward_fast"
        j_fn = lambda a: getattr(jpool, name)(a, k, k, s, s)  # noqa: E731
        t_fn = lambda a: getattr(tpool, name)(a, k, k, s, s)  # noqa: E731
    y_j, vjp = jax.vjp(j_fn, jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    y_t = t_fn(xt)
    (dx_t,) = torch.autograd.grad(y_t, xt, torch.tensor(g))
    assert y_t.shape == (shape[0], oh, ow, shape[3])
    if kind == "avg" and _clipped(shape, k, s) and not ties:
        np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                                   rtol=0, atol=AVG_CLIPPED_ATOL)
    else:
        np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(dx_t.numpy(), np.asarray(dx_j))


def test_fused_max_pool_backward_sums_overlaps_in_tap_order():
    """A peak that wins four overlapping k3 s2 windows gets the sum of
    their four cotangents, added in ascending tap order; the eager
    scatter's np.add.at order differs only in rounding."""
    x = torch.zeros((1, 7, 7, 1))
    x[0, 2, 2, 0] = x[0, 2, 4, 0] = x[0, 4, 2, 0] = 1.0
    x[0, 4, 4, 0] = 5.0
    x.requires_grad_(True)
    y = tpool.max_forward_fast(x, 3, 3, 2, 2)
    g = torch.tensor([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]).reshape(
        1, 3, 3, 1)
    (dx,) = torch.autograd.grad(y, x, g)
    # (4, 4) is the maximum of the four windows at (1..2, 1..2), met at
    # taps 8, 6, 2, 0 of the windows (1,1), (1,2), (2,1), (2,2)
    assert float(dx[0, 4, 4, 0]) == ((np.float32(0.9) + np.float32(0.8)) +
                                     np.float32(0.6)) + np.float32(0.5)
    assert float(dx.sum()) == pytest.approx(float(g.sum()))


# -- the whole fused shape against the reference ----------------------------

class SharedUniforms:
    """Seeded numpy uniforms that both packages draw.  The reference's
    ``jax.random.uniform`` becomes a host callback keyed by its key's
    data, which records each new key's uniforms in draw order per shape;
    the port's ``draw_uniform`` hands them out again in that order."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.by_key = {}
        self.drawn = collections.defaultdict(list)
        self.taken = collections.Counter()

    def _host(self, key_data, shape):
        k = (np.asarray(key_data).tobytes(), shape)
        if k not in self.by_key:
            self.by_key[k] = self.rng.random(shape, dtype=np.float32)
            self.drawn[shape].append(self.by_key[k])
        return self.by_key[k]

    def jax_uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                    maxval=1.0):
        shape = tuple(shape)
        data = jax.random.key_data(key) if jnp.issubdtype(
            key.dtype, jax.dtypes.prng_key) else key
        return jax.pure_callback(lambda d: self._host(d, shape),
                                 jax.ShapeDtypeStruct(shape, jnp.float32),
                                 data)

    def port_draw(self, rng, shape, device):
        shape = tuple(shape)
        i = self.taken[shape]
        self.taken[shape] += 1
        return torch.tensor(self.drawn[shape][i], device=device)


def _fused_runs(make, seed, uniforms=None, monkeypatch=None):
    """The reference's fused run (Pallas interpret mode) and the port's
    from its initial weights and shuffle state -> both workflows."""
    jprng.seed_all(seed)
    jroot.common.engine.pallas = True
    jroot.common.engine.pallas_interpret = True
    try:
        with monkeypatch.context() as m:
            if uniforms is not None:
                m.setattr(jax.random, "uniform", uniforms.jax_uniform)
            jw = make(True)
            jw.initialize(device=TPUDevice())
            params = [{"w": f.weights.map_read().copy(),
                       "b": f.bias.map_read().copy()} if f.weights else None
                      for f in jw.forwards]
            state = jprng.get().state_dict()
            jw.run()
        jw.step.sync_to_units()
    finally:
        jroot.common.engine.pallas = False
        jroot.common.engine.pallas_interpret = False
    tprng.seed_all(seed)
    tw = make(False)
    np.testing.assert_array_equal(np.asarray(tw.layer_specs, object),
                                  np.asarray(jw.layer_specs, object))
    load_forward_params(tw.forwards, params)
    tw.initialize(device=TorchDevice("cpu"))
    tprng.get().load_state_dict(state)
    if uniforms is not None:
        for f in tw.forwards:
            if f.NEEDS_RNG:
                f.draw_uniform = uniforms.port_draw
    tw.run()
    tw.step.sync_to_units()
    return jw, tw, params


def _small_alexnet_layers(mod, dropout, lr=0.03):
    specs = mod.layers(n_classes=10, lr=lr, dropout=dropout)
    widths = iter((8, 16, 16, 16, 8))
    for spec in specs:
        if spec["type"] == "conv_str":
            spec["->"]["n_kernels"] = next(widths)
        elif spec["type"] == "all2all_str":
            spec["->"]["output_sample_shape"] = 32
    return specs


def _alexnet(dropout, fused=True):
    def make(jax_side):
        return (JStandard if jax_side else TStandard)(
            name="AlexNet-small",
            layers=_small_alexnet_layers(jalexnet if jax_side else talexnet,
                                         dropout),
            loss_function="softmax", loader_name="synthetic_image",
            loader_config=dict(ALEX_LOADER),
            decision_config={"max_epochs": EPOCHS}, fused=fused)
    return make


def _stochastic_mnist_layers(mod):
    """mnist_conv.LAYERS with both pools stochastic, at narrow widths
    (conv 4/8, fc 16)."""
    specs = copy.deepcopy(mod.LAYERS)
    for spec in specs:
        if spec["type"] == "max_pooling":
            spec["type"] = "stochastic_pooling"
        elif spec["type"] == "conv_relu":
            spec["->"]["n_kernels"] //= 8
        elif spec["type"] == "all2all_relu":
            spec["->"]["output_sample_shape"] = 16
    return specs


def _mnist_stochastic(jax_side):
    return (JStandard if jax_side else TStandard)(
        name="MnistConv-stochastic",
        layers=_stochastic_mnist_layers(jmnist_conv if jax_side
                                        else tmnist_conv),
        loss_function="softmax", loader_name="synthetic_image",
        loader_config={"n_classes": 10, "sample_shape": (28, 28, 1),
                       "n_train": 60, "n_valid": 20, "minibatch_size": 20,
                       "spread": 2.5, "noise": 1.0},
        decision_config={"max_epochs": EPOCHS}, fused=True)


def _cifar(jax_side):
    return (jcifar if jax_side else tcifar).build(
        loader_name="synthetic_image", n_train=60, n_valid=20,
        minibatch_size=20, max_epochs=EPOCHS)


FUSED_CASES = {
    # name: (make, seed, uniforms' seed or None, the draws' shapes)
    "alexnet_dropout0": (_alexnet(0.0), 5, None, {}),
    "alexnet_dropout05": (_alexnet(0.5), 5, 3, {(8, 1, 1, 8): 12,
                                                 (8, 32): 12}),
    "mnist_conv_stochastic": (_mnist_stochastic, 6, 4,
                              {(20, 14, 14, 4): 9, (20, 7, 7, 8): 9}),
    "cifar_conv": (_cifar, 7, 5, {(20, 8, 8, 64): 9}),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_conv_shape_matches_jax(case, monkeypatch):
    """3 epochs from one seed: identical per-epoch n_err, every weight
    and bias within WEIGHT_ATOL, every layer trained; the draws (3 train
    minibatches an epoch, one a NEEDS_RNG forward each) as many and as
    shaped on both sides."""
    make, seed, useed, draws = FUSED_CASES[case]
    uniforms = None if useed is None else SharedUniforms(useed)
    jw, tw, params = _fused_runs(make, seed, uniforms, monkeypatch)
    assert isinstance(tw.step, FusedTrainStep)
    assert bool(tw.decision.complete)
    assert len(tw.decision.metrics_history) == EPOCHS
    assert tw.decision.metrics_history == jw.decision.metrics_history
    if uniforms is not None:
        assert {s: len(v) for s, v in uniforms.drawn.items()} == draws
        assert dict(uniforms.taken) == draws
    for ft, fj, p in zip(tw.forwards, jw.forwards, params):
        if p is None:
            continue
        assert not np.array_equal(ft.weights.map_read(), p["w"]), ft.name
        for a in ("weights", "bias"):
            np.testing.assert_allclose(getattr(ft, a).map_read(),
                                       getattr(fj, a).map_read(), rtol=0,
                                       atol=WEIGHT_ATOL,
                                       err_msg=f"{ft.name}.{a}")


def test_fused_equals_eager_in_the_port_where_nothing_is_drawn():
    """AlexNet at test size, dropout 0: the eager units (the conv and FC
    kernels' plain versions, the LRN and pooling backwards unit by unit)
    and the fused step (F.conv2d, the lrn Function, the tap pools under
    autograd) from one seed, f32 both."""
    runs = {}
    for fused in (False, True):
        tprng.seed_all(9)
        w = _alexnet(0.0, fused=fused)(False)
        w.initialize(device=TorchDevice("cpu"))
        w.run()
        if fused:
            w.step.sync_to_units()
        runs[fused] = w
    assert runs[True].decision.metrics_history == \
        runs[False].decision.metrics_history
    for ff, fe in zip(runs[True].forwards, runs[False].forwards):
        if ff.weights:
            for a in ("weights", "bias"):
                np.testing.assert_allclose(
                    getattr(ff, a).map_read(), getattr(fe, a).map_read(),
                    rtol=0, atol=WEIGHT_ATOL, err_msg=f"{ff.name}.{a}")


# -- the step's generator ----------------------------------------------------

def test_the_step_generator_advances_per_step_and_unit_and_not_at_eval():
    """MNIST conv with both pools stochastic, fused on the CPU: the step
    mints one torch.Generator at initialize (one key of the default
    stream); each train step draws once per stochastic unit, in forward
    order, from it, each draw new; validation steps draw nothing."""
    tprng.seed_all(2)
    w = _mnist_stochastic(False)
    w.decision.max_epochs = 1
    counter = tprng.get()._key_counter
    w.initialize(device=TorchDevice("cpu"))
    assert tprng.get()._key_counter == counter + 1
    gen = w.step._gen
    assert isinstance(gen, torch.Generator)
    draws, classes = [], []
    served = w.loader.run

    def serve():
        served()
        classes.append(int(w.loader.minibatch_class))

    w.loader.run = serve
    for f in w.forwards:
        if f.NEEDS_RNG:
            def draw(rng, shape, device, f=f, own=f.draw_uniform):
                assert rng is gen
                before = rng.get_state()
                u = own(rng, shape, device)
                assert not torch.equal(rng.get_state(), before)
                draws.append((len(classes), f.name, u))
                return u
            f.draw_uniform = draw
    w.run()
    n_train = sum(c == 2 for c in classes)
    assert n_train == 3 and len(classes) == 4       # 1 validation first
    names = [f.name for f in w.forwards if f.NEEDS_RNG]
    assert [d[1] for d in draws] == names * n_train
    assert {d[0] for d in draws} == {i + 1 for i, c in enumerate(classes)
                                     if c == 2}
    firsts = [d[2] for d in draws if d[1] == names[0]]
    assert not torch.equal(firsts[0], firsts[1])


def test_a_draw_without_the_generator_raises():
    tprng.seed_all(2)
    w = _mnist_stochastic(False)
    pool = w.forwards[1]
    x = torch.zeros((2, 28, 28, 4))
    with pytest.raises(ValueError, match="generator"):
        pool.torch_apply({}, x, train=True)
    assert pool.torch_apply({}, x, train=False).shape == (2, 14, 14, 4)


# -- the models ---------------------------------------------------------------

@pytest.mark.parametrize("model", ["alexnet", "mnist_conv", "cifar_conv"])
def test_models_train_fused_by_default(model):
    """The reference's defaults build the fused step; at a CPU-sized data
    set (AlexNet at 67 px) one epoch trains through it."""
    tprng.seed_all(4)
    if model == "alexnet":
        w = talexnet.build(input_size=67, n_classes=10, n_train=24,
                           n_valid=8, loader_config={"minibatch_size": 8})
    else:
        mod = tmnist_conv if model == "mnist_conv" else tcifar
        w = mod.build(loader_name="synthetic_image", max_epochs=1,
                      n_train=40, n_valid=20, minibatch_size=20)
    assert isinstance(w.step, FusedTrainStep)
    w.initialize(device=TorchDevice("cpu"))
    before = [f.weights.map_read().copy() for f in w.forwards if f.weights]
    w.run()
    w.step.sync_to_units()
    assert bool(w.decision.complete)
    after = [f.weights.map_read() for f in w.forwards if f.weights]
    assert all(not np.array_equal(a, b) for a, b in zip(after, before))


def test_cifar_conv_is_the_reference_config():
    assert tcifar.LAYERS == jcifar.LAYERS
    # the default loader is the CIFAR pickle batches, as the reference's
    # (trained in tests/test_torch_port_file_loaders.py)
    assert type(tcifar.build().loader).__name__ == "PicklesImageLoader"
    w = tcifar.build(loader_name="synthetic_image", fused=False,
                     n_train=20, n_valid=10, minibatch_size=10)
    assert [type(f).__name__ for f in w.forwards] == [
        "ConvRELU", "MaxPooling", "ConvRELU", "MaxPooling",
        "DropoutForward", "All2AllRELU", "All2AllSoftmax"]


def test_fused_lrn_runs_on_the_lrn_function(monkeypatch):
    """The LRN unit's torch_apply goes through kernels/lrn.py lrn in f32
    and casts back to the compute dtype; on CPU tensors the Function
    runs the plain versions and counts no launch."""
    calls = []
    apply = klrn.lrn.apply

    def counted(x, *args):
        calls.append(x.dtype)
        return apply(x, *args)

    monkeypatch.setattr(klrn.lrn, "apply", counted)
    tprng.seed_all(1)
    w = _alexnet(0.0)(False)
    norm = w.forwards[1]
    x = torch.rand((2, 15, 15, 8), dtype=torch.bfloat16)
    before = (klrn.fwd_launches, klrn.bwd_launches)
    y = norm.torch_apply({}, x)
    assert y.dtype == torch.bfloat16 and calls == [torch.float32]
    assert (klrn.fwd_launches, klrn.bwd_launches) == before
