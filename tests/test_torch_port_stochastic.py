"""The port's stochastic pooling and its counter-based generator against
the JAX package on the CPU.

- ``kernels/counter_rng.py``: Philox4x32-10's known answers, bits keyed by
  (seed, flat index) whatever the tensor's shape, uniforms within a
  chi-square band;
- ``kernels/pooling.py stochastic_pool``'s plain version against the
  Pallas ``stochastic_pool`` in interpret mode through ``bits=``:
  identical y, taps and offsets, both variants, ceil-mode borders and
  windows of zero mass; the ported ``ops/pooling.py stochastic_forward``
  against the reference's;
- ``StochasticPooling`` + ``GDStochasticPooling`` and a 2-epoch MNIST conv
  with both pooling layers stochastic at narrow widths against the JAX
  eager run (``engine.pallas`` + ``pallas_interpret``) with the same bits
  injected into both: identical n_err, weights within 1e-6;
- refusals, the bound, and a ``cuda``-marked card check.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import znicz_tpu.units.gd_pooling as j_gd_pooling
import znicz_tpu.units.pooling as j_pooling
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.core.memory import Array as JArray
from znicz_tpu.core.workflow import Workflow as JWorkflow
from znicz_tpu.models import mnist_conv as jmnist_conv
from znicz_tpu.ops import pooling as jpool
from znicz_tpu.ops.pallas import stochastic_pool as j_stochastic_pool
from znicz_tpu.standard_workflow import StandardWorkflow as JStandard

import znicz_tpu_torch.units.gd_pooling as t_gd_pooling
import znicz_tpu_torch.units.pooling as t_pooling
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import NumpyDevice, TorchDevice
from znicz_tpu_torch.core.memory import Array as TArray
from znicz_tpu_torch.core.workflow import Workflow as TWorkflow
from znicz_tpu_torch.kernels import counter_rng
from znicz_tpu_torch.kernels import dropout as kdrop
from znicz_tpu_torch.kernels import pooling as kpool
from znicz_tpu_torch.models import mnist_conv as tmnist_conv
from znicz_tpu_torch.ops import pooling as tpool
from znicz_tpu_torch.standard_workflow import StandardWorkflow as TStandard
from znicz_tpu_torch.units.nn_units import load_forward_params

#: chi-square upper-tail 1e-6 quantiles (scipy.stats.chi2.isf(1e-6, df))
CHI2_255, CHI2_15 = 377.07811549898673, 56.49344249977338


# -- the generator ----------------------------------------------------------

def _philox(c, k):
    words = counter_rng.philox4x32_10(
        *(torch.tensor([v], dtype=torch.int64) for v in c),
        k[0] | (k[1] << 32))
    return [int(w) for w in words]


def test_philox_known_answers():
    """Random123's known-answer vectors for philox4x32_10."""
    assert _philox((0, 0, 0, 0), (0, 0)) == [
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    assert _philox((0xffffffff,) * 4, (0xffffffff, 0xffffffff)) == [
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]
    assert _philox((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
                   (0xa4093822, 0x299f31d0)) == [
        0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]


def test_bits_are_keyed_by_seed_and_flat_index():
    a = counter_rng.random_bits(5, 1003)
    assert torch.equal(counter_rng.random_bits(5, 10), a[:10])
    assert a.min() >= 0 and a.max() < 2 ** 32
    assert not torch.equal(counter_rng.random_bits(6, 1003), a)
    assert not torch.equal(counter_rng.random_bits(5 + (1 << 32), 1003), a)
    # a tensor's split into dimensions does not change an element's bits
    x = torch.randn(24, 10)
    _, m1 = kdrop.dropout_forward(x, 0.5, seed=9)
    _, m2 = kdrop.dropout_forward(x.reshape(4, 6, 10), 0.5, seed=9)
    _, m3 = kdrop.dropout_forward(x.reshape(-1), 0.5, seed=9)
    assert torch.equal(m1.reshape(-1), m2.reshape(-1))
    assert torch.equal(m1.reshape(-1), m3)
    with pytest.raises(ValueError, match="seed"):
        counter_rng.random_bits(-1, 4)


def test_uniforms_lie_within_a_chi_square_band():
    words = counter_rng.random_bits(2026, 1 << 20)
    u = counter_rng.uniform24(words)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    counts = torch.bincount((u * 256).long(), minlength=256).double()
    want = len(u) / 256
    assert float(((counts - want) ** 2 / want).sum()) < CHI2_255
    # the low bits too (u drops the low 8): each nibble is uniform
    low = torch.bincount(words & 15, minlength=16).double()
    assert float(((low - len(u) / 16) ** 2 / (len(u) / 16)).sum()) < CHI2_15


# -- the kernel's plain version ---------------------------------------------

def _jax_pool(x, k, s, use_abs, bits):
    """The Pallas kernel in interpret mode through bits=, as the JAX unit
    calls it -> (y, taps, offsets) in NHWC."""
    patch, valid, _ = jpool.patches(np, x, k, k, s, s, pad_value=0.0)
    n, oh, ow, kk, c = patch.shape
    vt = np.broadcast_to(valid.reshape(1, oh * ow, kk), (n, oh * ow, kk))
    y, tap = j_stochastic_pool(
        jnp.asarray(patch.reshape(n * oh * ow, kk, c)),
        jnp.asarray(vt.reshape(n * oh * ow, kk)), 0, use_abs,
        bits=jnp.asarray(bits.reshape(n * oh * ow, c)), interpret=True)
    tap = np.asarray(tap).reshape(n, oh, ow, c)
    return (np.asarray(y).reshape(n, oh, ow, c), tap,
            np.asarray(jpool.offsets_of(np, tap, x.shape, k, k, s, s)))


def _taps_of(off, w, k, s):
    oh, ow = off.shape[1], off.shape[2]
    oy = np.arange(oh)[None, :, None, None] * s
    ox = np.arange(ow)[None, None, :, None] * s
    return (off // w - oy) * k + (off % w - ox)


@pytest.mark.parametrize("shape,k,s,use_abs", [
    ((3, 9, 8, 5), 3, 2, False), ((3, 9, 8, 5), 3, 2, True),
    ((4, 11, 13, 6), 2, 2, False), ((4, 11, 13, 6), 2, 2, True),
    ((2, 8, 8, 16), 2, 2, False), ((2, 7, 5, 4), 2, 3, True),
    ((2, 4, 4, 3), 5, 1, False)])
def test_stochastic_pool_plain_matches_pallas(shape, k, s, use_abs):
    """Identical y, taps and offsets through bits=, ceil-mode clipped
    borders included; a block of zero-mass windows picks tap 0."""
    rng = np.random.default_rng(sum(shape) + k)
    x = rng.normal(size=shape).astype(np.float32)
    z = s + k
    x[0, :z, :z] = 0.0 if use_abs else -np.abs(x[0, :z, :z])
    out = kpool.output_shape(shape, k, k, s, s)
    bits = rng.integers(0, 2 ** 32, out, dtype=np.uint32)
    y_j, tap_j, off_j = _jax_pool(x, k, s, use_abs, bits)
    before = kpool.launches
    y, off = kpool.stochastic_pool(torch.tensor(x), k, k, s, s, use_abs,
                                   bits=torch.from_numpy(bits))
    assert kpool.launches == before          # the CPU runs no kernel
    assert off.dtype == torch.int32 and tuple(y.shape) == out
    np.testing.assert_array_equal(y.numpy(), y_j)
    np.testing.assert_array_equal(off.numpy(), off_j)
    np.testing.assert_array_equal(_taps_of(off.numpy(), shape[2], k, s),
                                  tap_j)
    if out[1] > 1 and out[2] > 1:
        assert (tap_j[0, :2, :2] == 0).all()
    # int32 bits are the same bits
    y2, off2 = kpool.stochastic_pool(
        torch.tensor(x), k, k, s, s, use_abs,
        bits=torch.from_numpy(bits.view(np.int32)))
    assert torch.equal(y2, y) and torch.equal(off2, off)


def test_stochastic_pool_seed_draws_the_counter_bits():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(2, 9, 9, 7)).astype(np.float32))
    y, off = kpool.stochastic_pool(x, 3, 3, 2, 2, seed=123)
    y2, off2 = kpool.stochastic_pool(x, 3, 3, 2, 2, seed=123)
    assert torch.equal(y, y2) and torch.equal(off, off2)
    words = counter_rng.random_bits(123, y.numel()).reshape(y.shape)
    bits = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    yb, offb = kpool.stochastic_pool(x, 3, 3, 2, 2,
                                     bits=bits.to(torch.int32))
    assert torch.equal(y, yb) and torch.equal(off, offb)
    y3, _ = kpool.stochastic_pool(x, 3, 3, 2, 2, seed=124)
    assert not torch.equal(y, y3)


def test_stochastic_pool_refusals_and_bound():
    x = torch.zeros(2, 6, 6, 3)
    with pytest.raises(ValueError, match="exactly one"):
        kpool.stochastic_pool(x, 2, 2, 2, 2)
    with pytest.raises(ValueError, match="exactly one"):
        kpool.stochastic_pool(x, 2, 2, 2, 2, seed=1,
                              bits=torch.zeros(2, 3, 3, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="bits must be"):
        kpool.stochastic_pool(x, 2, 2, 2, 2,
                              bits=torch.zeros(2, 3, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint32"):
        kpool.stochastic_pool(x, 2, 2, 2, 2, bits=torch.zeros(2, 3, 3, 3))
    with pytest.raises(ValueError, match="float32"):
        kpool.stochastic_pool(x.double(), 2, 2, 2, 2, seed=1)
    bound = kpool.bound((100, 28, 28, 32), 2, 2, 2, 2)
    assert bound["bytes"] == 4 * (100 * 28 * 28 * 32 + 2 * 100 * 14 * 14 * 32)
    assert bound["bound_by"] == "bytes"
    assert abs(kpool.bound((128, 55, 55, 96), 3, 3, 2, 2)["bound_ms"] -
               0.0661) < 1e-3


@pytest.mark.parametrize("use_abs", [False, True])
def test_stochastic_forward_op_matches_reference(use_abs):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    x[0, :4, :4] = 0.0
    u = rng.random((2, 4, 3, 3), dtype=np.float32)
    for train in (True, False):
        y_j, off_j = jpool.stochastic_forward(np, x, 3, 3, 2, 2, u, use_abs,
                                              train)
        for xp, conv in ((np, np.asarray), (torch, torch.tensor)):
            y, off = tpool.stochastic_forward(xp, conv(x), 3, 3, 2, 2,
                                              conv(u), use_abs, train)
            np.testing.assert_allclose(np.asarray(y), y_j, rtol=1e-6,
                                       atol=1e-7)
            if train:
                np.testing.assert_array_equal(np.asarray(off), off_j)
            else:
                assert off is None and off_j is None


# -- the units --------------------------------------------------------------

def _inject_jax(w_or_units, seed):
    """The JAX stochastic pooling units draw only their seed from the host
    stream (as on the TPU) and take their bits from one numpy stream."""
    rng = np.random.default_rng(seed)
    for fwd in w_or_units:
        if not isinstance(fwd, j_pooling.StochasticPooling):
            continue
        fwd._pallas_interp = False
        orig = fwd._xla_pallas_fn

        def fn(x, seed, bits, fwd=fwd, orig=orig):
            n, oh, ow, c = fwd.output.shape
            b = rng.integers(0, 2 ** 32, (n, oh, ow, c), dtype=np.uint32)
            return orig(x, seed, jnp.asarray(b.reshape(n * oh * ow, c)))

        fwd._xla_pallas_fn = fn


def _inject_port(w_or_units, seed):
    """The port's units: the same numpy stream of bits, the seed still
    drawn from the host stream by the unit's own draw."""
    rng = np.random.default_rng(seed)
    for fwd in w_or_units:
        if not isinstance(fwd, t_pooling.StochasticPooling):
            continue

        def random(fwd=fwd, draw=fwd._random):
            draw()
            return {"bits": torch.from_numpy(rng.integers(
                0, 2 ** 32, fwd.output.shape, dtype=np.uint32))}

        fwd._random = random


def _pallas(on: bool) -> None:
    jroot.common.engine.pallas = on
    jroot.common.engine.pallas_interpret = on


def _pool_pair(ns, gd_ns, fwd_name, array_cls, workflow_cls, device, x,
               err, inject, forward_mode=False):
    w = workflow_cls(name="pool")
    fwd = getattr(ns, fwd_name)(w, kx=3, ky=3, sliding=(2, 2))
    fwd.input = array_cls(x)
    fwd.forward_mode = forward_mode
    fwd.initialize(device=device)
    inject([fwd], 31)
    fwd.run()
    gd = getattr(gd_ns, "GD" + fwd_name)(w)
    gd.link_from_forward(fwd)
    gd.err_output = array_cls(err)
    gd.initialize(device=device)
    gd.run()
    return {"y": np.array(fwd.output.map_read()),
            "offset": np.array(fwd.input_offset.map_read()),
            "err_input": np.array(gd.err_input.map_read())}


@pytest.mark.parametrize("fwd_name", ["StochasticPooling",
                                      "StochasticAbsPooling"])
def test_stochastic_pooling_units_match_jax(fwd_name):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 9, 8, 4)).astype(np.float32)
    err = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    jprng.seed_all(3)
    _pallas(True)
    try:
        want = _pool_pair(j_pooling, j_gd_pooling, fwd_name, JArray,
                          JWorkflow, TPUDevice(), x, err, _inject_jax)
    finally:
        _pallas(False)
    tprng.seed_all(3)
    got = _pool_pair(t_pooling, t_gd_pooling, fwd_name, TArray, TWorkflow,
                     TorchDevice("cpu"), x, err, _inject_port)
    assert got["offset"].dtype == np.int32
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the same seed draw on both sides: the host streams stay in step
    assert tprng.get().randint(0, 2 ** 31) == jprng.get().randint(0, 2 ** 31)


def test_stochastic_pooling_unit_draws_and_forward_mode():
    """The port's own draw: one seed per forward from the host stream, a
    new sample per forward; forward_mode gives the reference's expectation
    on the torch and numpy paths."""
    rng = np.random.default_rng(5)
    x = np.abs(rng.normal(size=(2, 8, 8, 3))).astype(np.float32)
    err = np.ones((2, 4, 4, 3), np.float32)
    tprng.seed_all(8)
    a = _pool_pair(t_pooling, t_gd_pooling, "StochasticPooling", TArray,
                   TWorkflow, TorchDevice("cpu"), x, err, lambda *a: None)
    b = _pool_pair(t_pooling, t_gd_pooling, "StochasticPooling", TArray,
                   TWorkflow, TorchDevice("cpu"), x, err, lambda *a: None)
    assert not np.array_equal(a["offset"], b["offset"])
    assert a["err_input"].sum() == err.size     # one winner a window
    want, _ = jpool.stochastic_forward(np, x, 3, 3, 2, 2, None, False,
                                       train=False)
    for device in (TorchDevice("cpu"), NumpyDevice()):
        e = _pool_pair(t_pooling, t_gd_pooling, "StochasticPooling", TArray,
                       TWorkflow, device, x, err, lambda *a: None,
                       forward_mode=True)
        np.testing.assert_allclose(e["y"], want, rtol=1e-6, atol=1e-7)


# -- MNIST conv with stochastic pooling -------------------------------------

def _stochastic_layers(mod):
    """mnist_conv.LAYERS with both pooling layers stochastic, at narrow
    widths (conv 4 and 8, fc 16)."""
    specs = [dict(s, **{k: dict(s[k]) for k in ("->", "<-") if k in s})
             for s in mod.LAYERS]
    widths = iter((4, 8))
    for spec in specs:
        if spec["type"] == "max_pooling":
            spec["type"] = "stochastic_pooling"
        elif spec["type"] == "conv_relu":
            spec["->"]["n_kernels"] = next(widths)
        elif spec["type"] == "all2all_relu":
            spec["->"]["output_sample_shape"] = 16
    return specs


LOADER = {"n_classes": 10, "sample_shape": (28, 28, 1), "n_train": 60,
          "n_valid": 20, "minibatch_size": 10, "spread": 2.5, "noise": 1.0}


def _mnist(cls, mod):
    return cls(name="MnistConv", layers=_stochastic_layers(mod),
               loss_function="softmax", loader_name="synthetic_image",
               loader_config=dict(LOADER),
               decision_config={"max_epochs": 2}, fused=False)


def test_mnist_conv_stochastic_matches_jax():
    """Two epochs eager, the JAX run on its Pallas kernels in interpret
    mode, the port on the plain versions, the same bits injected: the
    same n_err history, conv and FC weights within 1e-6 (both f32, sums
    in other orders)."""
    jprng.seed_all(13)
    _pallas(True)
    try:
        jw = _mnist(JStandard, jmnist_conv)
        jw.initialize(device=TPUDevice())
        params = [{"w": f.weights.map_read().copy(),
                   "b": f.bias.map_read().copy()} if f.weights else None
                  for f in jw.forwards]
        state = jprng.get().state_dict()
        _inject_jax(jw.forwards, 99)
        jw.run()
    finally:
        _pallas(False)
    tprng.seed_all(13)
    tw = _mnist(TStandard, tmnist_conv)
    assert [type(f).__name__ for f in tw.forwards] == \
        [type(f).__name__ for f in jw.forwards]
    load_forward_params(tw.forwards, params)
    tw.initialize(device=TorchDevice("cpu"))
    tprng.get().load_state_dict(state)
    _inject_port(tw.forwards, 99)
    calls = []
    pool = kpool.stochastic_pool

    def counted(*args, **kw):
        calls.append(sorted(kw))
        return pool(*args, **kw)

    kpool.stochastic_pool = counted
    try:
        tw.run()
    finally:
        kpool.stochastic_pool = pool
    # 8 minibatches an epoch (6 train, 2 validation), two pools each, all
    # sampling: nothing in the eager graph sets forward_mode
    assert calls == [["bits"]] * 2 * 8 * 2
    assert tw.decision.metrics_history == jw.decision.metrics_history
    assert len(tw.decision.metrics_history) == 2
    for ft, fj, p in zip(tw.forwards, jw.forwards, params):
        if p is None:
            continue
        assert not np.array_equal(ft.weights.map_read(), p["w"])
        for a in ("weights", "bias"):
            np.testing.assert_allclose(getattr(ft, a).map_read(),
                                       getattr(fj, a).map_read(), rtol=0,
                                       atol=1e-6, err_msg=f"{ft.name}.{a}")


def test_mnist_conv_build_defaults_raise():
    assert tmnist_conv.LAYERS == jmnist_conv.LAYERS
    # the default loader is the MNIST IDX files, as the reference's
    # (trained in tests/test_torch_port_file_loaders.py)
    assert type(tmnist_conv.build().loader).__name__ == "MnistLoader"
    # the fused shape, the default, builds on the synthetic loader
    fused = tmnist_conv.build(loader_name="synthetic_image", n_train=20,
                              n_valid=10, minibatch_size=10)
    assert type(fused.step).__name__ == "FusedTrainStep"
    w = tmnist_conv.build(loader_name="synthetic_image", fused=False,
                          n_train=20, n_valid=10, minibatch_size=10)
    assert [type(f).__name__ for f in w.forwards][:2] == ["ConvRELU",
                                                          "MaxPooling"]


@pytest.mark.cuda
def test_stochastic_pool_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(16, 27, 27, 32, device="cuda")
    before = kpool.launches
    y, off = kpool.stochastic_pool(x, 3, 3, 2, 2, seed=77)
    words = counter_rng.random_bits(77, y.numel(), "cuda")
    y_p, off_p = kpool.stochastic_pool_plain(x, 3, 3, 2, 2, False, words)
    torch.cuda.synchronize()
    assert kpool.launches == before + 1
    assert torch.equal(y, y_p) and torch.equal(off, off_p)


def test_four_channel_path_takes_the_paths_shapes():
    """The kernel's dispatch (``four_channel_path``): MNIST conv's 32
    and 64 channels and AlexNet's 96 take four channels a thread; three
    channels, a window of more than 16 taps or an operand off 16-byte
    alignment take one element a thread."""
    x = torch.zeros(64)
    assert all(kpool.four_channel_path(c, k, k, x) for c, k in
               ((32, 2), (64, 2), (96, 3), (4, 4)))
    assert not kpool.four_channel_path(3, 2, 2, x)
    assert not kpool.four_channel_path(6, 2, 2, x)
    assert not kpool.four_channel_path(32, 5, 5, x)
    assert not kpool.four_channel_path(32, 2, 2, x[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,s", [((16, 27, 27, 32), 3, 2),
                                       ((8, 28, 28, 3), 2, 2),
                                       ((4, 11, 13, 96), 3, 2),
                                       ((4, 14, 14, 64), 2, 2)])
@pytest.mark.parametrize("aligned", [True, False])
def test_both_kernel_paths_match_plain_on_the_card(shape, k, s, aligned):
    """Four channels a thread (c % 4 == 0, aligned) and one element a
    thread (c 3, or x 4 bytes off alignment) against the plain version,
    bit for bit, through seed= and through bits=."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = int(np.prod(shape))
    store = torch.randn(n + 1, device="cuda")
    x = (store[:n] if aligned else store[1:]).view(shape)
    y, off = kpool.stochastic_pool(x, k, k, s, s, seed=5)
    words = counter_rng.random_bits(5, y.numel(), "cuda")
    y_p, off_p = kpool.stochastic_pool_plain(x, k, k, s, s, False, words)
    bits = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32).reshape(y.shape)
    y_b, off_b = kpool.stochastic_pool(x, k, k, s, s, True, bits=bits)
    y_pb, off_pb = kpool.stochastic_pool_plain(x, k, k, s, s, True, words)
    torch.cuda.synchronize()
    assert torch.equal(y, y_p) and torch.equal(off, off_p)
    assert torch.equal(y_b, y_pb) and torch.equal(off_b, off_pb)
