"""The port's update kernels (``kernels/optim.py``) against the JAX
package's Pallas updates (``ops/pallas/sgd.py``, ``ops/pallas/adam.py``)
in interpret mode, on the CPU (where the wrappers run the plain
versions), at the reference's own bands (tests/test_pallas_kernels.py):
SGD 1e-6 / 1e-7, SGD with bf16 velocity 1e-5 / 1e-6 with the velocity's
dtype kept, AdamW 1e-5 / 1e-6.  Hyperparameters go in as Python floats
and as 0-d tensors (how the fused step passes them).  The
kernel-vs-plain check on the card is ``cuda``-marked and skips here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops.pallas import fused_adam_update, fused_sgd_update

from znicz_tpu_torch.kernels import optim as koptim

SHAPES = [(64, 128), (7, 33), (3, 5, 16)]
#: lr, weights_decay, l1_vs_l2, gradient_moment, batch_size
SGD_ARGS = (0.05, 1e-3, 0.3, 0.9, 32.0)
#: lr, weight_decay, beta1, beta2, eps, batch_size; t = 3
ADAM_T, ADAM_ARGS = 3.0, (0.01, 0.001, 0.9, 0.999, 1e-8, 32.0)


def _adam_args(as_tensors):
    """The kernel's argument order (lr, wd, b1, b2, eps, c1, c2, bs),
    the bias corrections made from t = 3 in the scalars' own arithmetic
    (f32 for tensors, as the reference's wrapper makes them)."""
    lr, wd, b1, b2, eps, bs = _scalars(ADAM_ARGS) if as_tensors \
        else ADAM_ARGS
    t = torch.tensor(ADAM_T) if as_tensors else ADAM_T
    return lr, wd, b1, b2, eps, 1.0 - b1 ** t, 1.0 - b2 ** t, bs


def _tensors(*arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype) for a in arrays]


def _scalars(values):
    return [torch.tensor(v, dtype=torch.float32) for v in values]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("as_tensors", [False, True])
def test_sgd_matches_pallas_interpret(shape, as_tensors):
    rng = np.random.default_rng(0)
    w, g = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    v = (rng.normal(size=shape) * 0.1).astype(np.float32)
    w_ref, v_ref = fused_sgd_update(jnp.asarray(w), jnp.asarray(g),
                                    jnp.asarray(v), *SGD_ARGS,
                                    interpret=True)
    tw, tg, tv = _tensors(w, g, v)
    args = _scalars(SGD_ARGS) if as_tensors else SGD_ARGS
    out_w, out_v = koptim.sgd_update_(tw, tg, tv, *args)
    assert out_w is tw and out_v is tv                     # in place
    np.testing.assert_allclose(tw.numpy(), np.asarray(w_ref), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v_ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("shape", [(64, 128), (3, 5, 16)])
def test_sgd_bf16_velocity_matches_pallas_interpret(shape):
    """f32 math, one narrow store: the velocity stays bf16."""
    rng = np.random.default_rng(5)
    w = jnp.asarray(rng.normal(size=shape), jnp.float32)
    g = jnp.asarray(rng.normal(size=shape), jnp.float32)
    v = jnp.asarray(rng.normal(size=shape) * 0.1, jnp.bfloat16)
    w_ref, v_ref = fused_sgd_update(w, g, v, *SGD_ARGS, interpret=True)
    tw, tg = _tensors(np.asarray(w), np.asarray(g))
    tv = torch.tensor(np.asarray(v, np.float32)).to(torch.bfloat16)
    koptim.sgd_update_(tw, tg, tv, *_scalars(SGD_ARGS))
    assert tv.dtype == torch.bfloat16
    np.testing.assert_allclose(tw.numpy(), np.asarray(w_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.float().numpy(),
                               np.asarray(v_ref, np.float32), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("as_tensors", [False, True])
def test_adam_matches_pallas_interpret(shape, as_tensors):
    rng = np.random.default_rng(9)
    w, g = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    m = (rng.normal(size=shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=shape)) * 0.01).astype(np.float32)
    refs = fused_adam_update(jnp.asarray(w), jnp.asarray(g), jnp.asarray(m),
                             jnp.asarray(v), ADAM_T, *ADAM_ARGS,
                             interpret=True)
    tw, tg, tm, tv = _tensors(w, g, m, v)
    outs = koptim.adam_update_(tw, tg, tm, tv, *_adam_args(as_tensors))
    assert outs[0] is tw and outs[1] is tm and outs[2] is tv
    for got, want in zip((tw, tm, tv), refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


#: bench_fc-like leaves at small width (784-64-64-10: w and b of three
#: layers), with lr / wd per leaf (the fused step's lr and lr_b) and
#: c1 / c2 per layer (each layer's own step count)
MULTI_SHAPES = [(784, 64), (64,), (64, 64), (64,), (64, 10), (10,)]
MULTI_T = (3.0, 3.0, 5.0, 5.0, 1.0, 1.0)
MULTI_LR_WD = ((0.01, 1e-3), (0.02, 0.0), (0.01, 1e-3), (0.02, 0.0),
               (0.005, 1e-2), (0.01, 0.0))


def _multi_state(seed):
    rng = np.random.default_rng(seed)
    out = []
    for shape in MULTI_SHAPES:
        w, g = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        m = (rng.normal(size=shape) * 0.1).astype(np.float32)
        v = (np.abs(rng.normal(size=shape)) * 0.01).astype(np.float32)
        out.append((w, g, m, v))
    return out


@pytest.mark.parametrize("as_tensors", [False, True])
def test_adam_multi_matches_one_leaf_calls_and_pallas_interpret(as_tensors):
    """One adam_update_multi_ call over six leaves with per-leaf lr, wd,
    c1 and c2 equals six adam_update_ calls bit for bit and the JAX
    package's fused_adam_update leaf by leaf in interpret mode (band
    1e-5 / 1e-6); on the CPU it counts no launch."""
    _, _, b1, b2, eps, bs = ADAM_ARGS
    state = _multi_state(13)
    conv = (lambda x: torch.tensor(x, dtype=torch.float32)) if as_tensors \
        else (lambda x: x)
    multi, single = ([_tensors(*arrays) for arrays in state]
                     for _ in range(2))
    leaves = []
    for (w, g, m, v), t, (lr, wd) in zip(multi, MULTI_T, MULTI_LR_WD):
        tt = conv(t)
        leaves.append((w, g, m, v, conv(lr), conv(wd), 1.0 - conv(b1) ** tt,
                       1.0 - conv(b2) ** tt))
    before = koptim.adam_launches
    koptim.adam_update_multi_(leaves, conv(b1), conv(b2), conv(eps),
                              conv(bs))
    assert koptim.adam_launches == before
    for leaf, ops, (w, g, m, v), t, (lr, wd) in zip(
            leaves, single, state, MULTI_T, MULTI_LR_WD):
        koptim.adam_update_(*ops, *leaf[4:6], conv(b1), conv(b2),
                            conv(eps), *leaf[6:], conv(bs))
        for got, want in zip((leaf[0], leaf[2], leaf[3]),
                             (ops[0], ops[2], ops[3])):
            assert torch.equal(got, want)
        refs = fused_adam_update(*map(jnp.asarray, (w, g, m, v)), t, lr, wd,
                                 b1, b2, eps, bs, interpret=True)
        for got, want in zip((leaf[0], leaf[2], leaf[3]), refs):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


def test_adam_multi_refuses_bad_leaves():
    w, g, m, v = (torch.ones(4, 4) for _ in range(4))
    args = _adam_args(False)
    leaf = (w, g, m, v, args[0], args[1], args[5], args[6])
    shared = (args[2], args[3], args[4], args[7])
    with pytest.raises(ValueError, match="no leaves"):
        koptim.adam_update_multi_([], *shared)
    with pytest.raises(ValueError, match="twice"):
        koptim.adam_update_multi_([leaf, leaf], *shared)
    with pytest.raises(ValueError, match="m must be"):
        koptim.adam_update_multi_([(w, g, m.double(), v) + leaf[4:]],
                                  *shared)


#: leaf sizes (n, all operands 16-byte aligned) across leaf boundaries,
#: tails of 1 to 3 elements, leaves of fewer than 4, an unaligned leaf
#: (all of it scalar) and zero-vector leaves between others
COVER_LEAVES = [
    [(20037, True)],
    [(7, True), (1, True), (4096, True), (3, True), (40961, True),
     (10, True)],
    [(1030, True), (2, True), (555, False), (9, True), (3000, True)],
    [(3, False), (5, True), (1, True)],
]


@pytest.mark.parametrize("leaves", COVER_LEAVES)
@pytest.mark.parametrize("blocks_per_sm", [1, 4, 8])
def test_adam_grid_covers_every_element_exactly_once(leaves, blocks_per_sm):
    """The kernel's index arithmetic (adam_cover, at the grid adam_grid
    gives on a card of 132 SMs and on one of 3, and at one block) updates
    every element of every leaf once and nothing else; the grid is at
    most ADAM_WAVES waves and at least one block."""
    vecs, tails, vec0, tail0 = koptim.adam_spaces(leaves)
    assert vecs == sum(n // 4 for n, ok in leaves if ok)
    assert vecs * 4 + tails == sum(n for n, _ in leaves)
    want = [(i, e) for i, (n, _) in enumerate(leaves) for e in range(n)]
    for sms in (132, 3, None):
        blocks = 1 if sms is None else \
            koptim.adam_grid(vecs, tails, blocks_per_sm, sms)
        if sms is not None:
            assert 1 <= blocks <= koptim.ADAM_WAVES * blocks_per_sm * sms
        assert sorted(koptim.adam_cover(leaves, blocks)) == want


def test_adam_grid_is_whole_waves_at_bench_fc():
    """bench_fc's six leaves (5.0 M vectors, 2 scalars) fill ADAM_WAVES
    whole waves; a launch of a few vectors takes a block a chunk."""
    leaves = [(784 * 4096, True), (4096, True), (4096 * 4096, True),
              (4096, True), (40960, True), (10, True)]
    vecs, tails, _, _ = koptim.adam_spaces(leaves)
    assert (vecs, tails) == (20037640 // 4, 2)
    assert koptim.adam_grid(vecs, tails, 3) == koptim.ADAM_WAVES * 3 * 132
    assert koptim.adam_grid(1000, 3, 3) == 2
    assert koptim.adam_grid(0, 3, 3) == 1
    assert koptim.adam_grid(0, 3000, 3) == 12


@pytest.mark.parametrize("xp", ["numpy", "torch"])
def test_ops_updates_match_the_reference_ops(xp):
    """``ops/sgd.py`` and ``ops/adam.py`` (both branches) against the
    reference's own ops, which the reference's eager units and fused
    step run: the same f32 formula."""
    from znicz_tpu.ops import adam as jadam, sgd as jsgd
    from znicz_tpu_torch.ops import adam as tadam, sgd as tsgd

    rng = np.random.default_rng(4)
    w, g, m = (rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3))
    v = np.abs(m)
    conv = (lambda a: a) if xp == "numpy" else torch.tensor
    mod = np if xp == "numpy" else torch
    want = jsgd.update(np, w, g, m, *SGD_ARGS)
    got = tsgd.update(mod, *map(conv, (w, g, m)), *SGD_ARGS)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-7)
    want = jadam.update(np, w, g, m, v, ADAM_T, *ADAM_ARGS)
    got = tadam.update(mod, *map(conv, (w, g, m, v)), ADAM_T, *ADAM_ARGS)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-7)


def test_cpu_calls_count_no_launch():
    w, g, v = (torch.ones(4, 4) for _ in range(3))
    before = (koptim.sgd_launches, koptim.adam_launches)
    koptim.sgd_update_(w, g, v, *SGD_ARGS)
    koptim.adam_update_(w, g, torch.zeros(4, 4), torch.zeros(4, 4),
                        *_adam_args(False))
    assert (koptim.sgd_launches, koptim.adam_launches) == before


def test_bounds_count_bytes():
    leaves = [(784, 4096), (4096,), (4096, 4096), (4096,), (4096, 10),
              (10,)]
    n = 784 * 4096 + 4096 + 4096 * 4096 + 4096 + 40960 + 10
    assert n == 20037642
    bf16 = koptim.sgd_bound(leaves, torch.bfloat16)
    assert bf16["bytes"] == 16 * n and bf16["bound_by"] == "bytes"
    assert bf16["bound_ms"] == pytest.approx(16 * n / 3.35e12 * 1e3)
    assert koptim.sgd_bound(leaves)["bytes"] == 20 * n
    adam = koptim.adam_bound([torch.empty(s) for s in leaves])
    assert adam["bytes"] == 28 * n and adam["bound_by"] == "bytes"


def test_bad_calls_raise():
    w = torch.ones(4, 4)
    with pytest.raises(ValueError, match="float32"):
        koptim.sgd_update_(w.to(torch.bfloat16), w, w, *SGD_ARGS)
    with pytest.raises(ValueError, match="differs"):
        koptim.sgd_update_(w, torch.ones(4, 5), w, *SGD_ARGS)
    with pytest.raises(ValueError, match="vel must be"):
        koptim.sgd_update_(w, w.clone(), w.to(torch.float16), *SGD_ARGS)
    with pytest.raises(ValueError, match="contiguous"):
        koptim.sgd_update_(w, w.clone(), torch.ones(4, 4).t(), *SGD_ARGS)
    with pytest.raises(ValueError, match="grad must be"):
        koptim.adam_update_(w, w.double(), w.clone(), w.clone(),
                            *_adam_args(False))
    # on the card the scalars must be device f32 tensors (the SMEM pack's
    # counterpart): a Python float is refused, never silently uploaded
    with pytest.raises(ValueError, match="one-element float32 tensor"):
        koptim._scalar_ptrs(torch.device("cpu"), lr=0.1)
    with pytest.raises(ValueError, match="one-element float32 tensor"):
        koptim._scalar_ptrs(torch.device("cpu"),
                            lr=torch.tensor(0.1, dtype=torch.float64))


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """sgd_update_ (f32 and bf16 velocity) and adam_update_ on the card
    against their plain versions: the same f32 operations in the same
    order, so bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    rng = np.random.default_rng(2)
    sc = [torch.tensor(a, device="cuda") for a in
          np.float32([0.05, 1e-3, 0.3, 0.9, 32.0])]
    for shape in SHAPES + [(1000, 10)]:
        for vdt in (torch.float32, torch.bfloat16):
            w, g, v = (torch.tensor(rng.normal(size=shape),
                                    dtype=torch.float32, device="cuda")
                       for _ in range(3))
            v = v.to(vdt)
            kw, kv, pw, pv = w.clone(), v.clone(), w.clone(), v.clone()
            koptim.sgd_update_(kw, g, kv, *sc)
            koptim.sgd_update_plain(pw, g, pv, *sc)
            assert torch.equal(kw, pw) and torch.equal(kv, pv)
        w, g, m = (torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                                device="cuda") for _ in range(3))
        v = m.abs()
        args = [a.cuda() for a in _adam_args(True)]
        ker = [x.clone() for x in (w, m, v)]
        ref = [x.clone() for x in (w, m, v)]
        koptim.adam_update_(ker[0], g, ker[1], ker[2], *args)
        koptim.adam_update_plain(ref[0], g, ref[1], ref[2], *args)
        assert all(torch.equal(a, b) for a, b in zip(ker, ref))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_adam_multi_on_the_card_is_the_one_leaf_kernel_bit_for_bit():
    """adam_update_multi_ over 35 leaves (two launches: 32 and 3), one of
    them unaligned and several with tails, against one-leaf launches and
    the plain version: bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    rng = np.random.default_rng(8)
    sizes = [int(n) for n in rng.integers(1, 5000, size=35)]
    state = []
    for n in sizes:
        w, g, m = (torch.tensor(rng.normal(size=n), dtype=torch.float32,
                                device="cuda") for _ in range(3))
        state.append((w, g, m, m.abs() * 0.01))
    args = [a.cuda() for a in _adam_args(True)]
    lr, wd, b1, b2, eps, c1, c2, bs = args

    def clone(i, j, x):
        if (i, j) != (3, 0):
            return x.clone()
        store = torch.empty(x.numel() + 1, device="cuda")
        store[1:] = x                   # leaf 3's w 4 bytes off alignment
        return store[1:]

    copies = [[[clone(i, j, x) for j, x in enumerate(leaf)]
               for i, leaf in enumerate(state)] for _ in range(3)]
    assert copies[0][3][0].data_ptr() % 16
    before = koptim.adam_launches
    koptim.adam_update_multi_(
        [(w, g, m, v, lr * (i + 1), wd, c1, c2)
         for i, (w, g, m, v) in enumerate(copies[0])], b1, b2, eps, bs)
    assert koptim.adam_launches == before + 2
    for i, ((w, g, m, v), (pw, pg, pm, pv)) in enumerate(
            zip(copies[1], copies[2])):
        koptim.adam_update_(w, g, m, v, lr * (i + 1), wd, b1, b2, eps, c1,
                            c2, bs)
        koptim.adam_update_plain(pw, pg, pm, pv, lr * (i + 1), wd, b1, b2,
                                 eps, c1, c2, bs)
    torch.cuda.synchronize()
    for a, b, c in zip(*copies):
        for i in (0, 2, 3):
            assert torch.equal(a[i], b[i]) and torch.equal(a[i], c[i])
