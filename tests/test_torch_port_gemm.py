"""The port's FC kernels (``kernels/gemm.py``) against the JAX package's
Pallas GEMM (``ops/pallas/gemm.py``) on the CPU.

The same seeded numpy operands go through the reference's
``fc_forward`` / ``fc_backward`` in Pallas interpret mode and through the
port's wrappers on CPU tensors (which run the plain versions), across
padded and exact-block geometries and every fused activation, at the
reference's own bands (tests/test_pallas_kernels.py:624-633): rtol 1e-4
/ atol 1e-4 forward, 2e-4 / 2e-3 backward.  Also the act-backward pass,
the wrappers' checks, launch counting and ``bound``.  The kernel-vs-plain
check on the card is ``cuda``-marked and skips here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import linear as jlinear
from znicz_tpu.ops.pallas import gemm as jgemm

from znicz_tpu_torch.kernels import gemm as kgemm

#: the reference's geometries (tests/test_pallas_kernels.py:607): padded
#: (32, 784, 100), (7, 13, 3), (129, 200, 257) and exact (8, 128, 128)
FC_GEOMS = [(32, 784, 100), (7, 13, 3), (129, 200, 257), (8, 128, 128)]
ACTS = list(kgemm.FUSED_ACTIVATIONS)


def _operands(geom):
    """The reference test's operands and forward (seed 13)."""
    B, F, O = geom
    rng = np.random.default_rng(13)
    x = rng.normal(size=(B, F)).astype(np.float32)
    w = (rng.normal(size=(F, O)) * 0.05).astype(np.float32)
    b = rng.normal(size=(O,)).astype(np.float32)
    e = rng.normal(size=(B, O)).astype(np.float32)
    return x, w, b, e


@pytest.mark.parametrize("geom", FC_GEOMS)
@pytest.mark.parametrize("act", ACTS)
def test_fc_forward_and_backward_match_pallas_interpret(geom, act):
    x, w, b, e = _operands(geom)
    want = np.asarray(jgemm.fc_forward(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), act, interpret=True))
    got = kgemm.fc_forward(torch.tensor(x), torch.tensor(w),
                           torch.tensor(b), act)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    y = jlinear.forward(np, x, w, b, act)
    wants = jgemm.fc_backward(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                              jnp.asarray(e), act, interpret=True)
    gots = kgemm.fc_backward(torch.tensor(x), torch.tensor(y),
                             torch.tensor(w), torch.tensor(e), act)
    for name, g, want in zip(("err_input", "grad_w", "grad_b"), gots,
                             wants):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-3, err_msg=name)


def test_fc_backward_without_activation_and_with_3d_input():
    """``activation_applied=False`` (the GDSoftmax contract) and an
    MNIST-shaped (B, 28, 28) input whose err_input keeps that shape."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 28, 28)).astype(np.float32)
    w = (rng.normal(size=(784, 10)) * 0.05).astype(np.float32)
    y = rng.normal(size=(6, 10)).astype(np.float32)
    e = rng.normal(size=(6, 10)).astype(np.float32)
    wants = jlinear.backward(np, x, y, w, e, "tanh", False)
    gots = kgemm.fc_backward(torch.tensor(x), torch.tensor(y),
                             torch.tensor(w), torch.tensor(e), "tanh", False)
    assert gots[0].shape == (6, 28, 28)
    for g, want in zip(gots, wants):
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("act", ACTS)
def test_act_backward_plain_matches_pallas_interpret(act):
    """err * act'(y): the same f32 formula on both sides; exp may differ
    by an ulp, so 1e-6 on values of order 1."""
    rng = np.random.default_rng(5)
    y = jlinear.forward(np, rng.normal(size=(9, 130)).astype(np.float32),
                        np.eye(130, dtype=np.float32), None, act)
    err = rng.normal(size=(9, 130)).astype(np.float32)
    want = np.asarray(jgemm._act_backward(jnp.asarray(y), jnp.asarray(err),
                                          act, interpret=True))
    got = kgemm.act_backward(torch.tensor(y), torch.tensor(err), act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        kgemm.act_backward_plain(torch.tensor(y), torch.tensor(err),
                                 act).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ACTS)
def test_ops_match_the_reference_ops(act):
    """``ops/activations.py`` and ``ops/linear.py`` (both branches)
    against the reference's ops: forward, derivative from y, the FC
    backward and the softmax forward with its argmax."""
    from znicz_tpu.ops import activations as jact
    from znicz_tpu_torch.ops import activations as tact, linear as tlin

    x, w, b, e = _operands((9, 13, 6))
    y = jlinear.forward(np, x, w, b, act)
    for mod, conv in ((np, lambda a: a), (torch, torch.tensor)):
        np.testing.assert_allclose(
            np.asarray(tlin.forward(mod, conv(x), conv(w), conv(b), act)), y,
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(tact.derivative_from_output(mod, act, conv(y))),
            jact.derivative_from_output(np, act, y), rtol=1e-6, atol=1e-6)
        for got, want in zip(
                tlin.backward(mod, conv(x), conv(y), conv(w), conv(e), act),
                jlinear.backward(np, x, y, w, e, act)):
            np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                                       atol=1e-5)
        sy, si = tlin.softmax_forward(mod, conv(x), conv(w), conv(b))
        jy, ji = jlinear.softmax_forward(np, x, w, b)
        np.testing.assert_allclose(np.asarray(sy), jy, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(np.asarray(si), ji)


def test_linear_act_backward_returns_err_itself():
    err = torch.ones(3, 4)
    assert kgemm.act_backward(torch.zeros(3, 4), err, "linear") is err


def test_transposed_operands_read_in_place():
    """The backward's products take ``w.t()`` and ``x.t()`` views of
    contiguous storage, as the kernel does."""
    rng = np.random.default_rng(9)
    a = torch.tensor(rng.normal(size=(5, 7)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(3, 5)).astype(np.float32))
    got = kgemm.gemm_fc(a.t(), b.t())
    np.testing.assert_allclose(got.numpy(), (a.t() @ b.t()).numpy(),
                               rtol=1e-6)


def test_cpu_calls_count_no_launch():
    x, w, b, e = (torch.tensor(a) for a in _operands((7, 13, 3)))
    before = (kgemm.gemm_launches, kgemm.act_launches)
    y = kgemm.fc_forward(x, w, b, "tanh")
    kgemm.fc_backward(x, y, w, e, "tanh")
    kgemm.act_backward(y, e, "sigmoid")
    assert (kgemm.gemm_launches, kgemm.act_launches) == before


def test_bound_counts_flops_and_bytes():
    a = torch.empty(1024, 4096)
    b = torch.empty(4096, 4096)
    bias = torch.empty(4096)
    got = kgemm.bound(a, b, bias, "tanh")
    assert got["flops"] == 2 * 1024 * 4096 * 4096 + 6 * 1024 * 4096
    assert got["bytes"] == 4 * (1024 * 4096 * 2 + 4096 * 4096 + 4096)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(got["flops"] / 67e12 * 1e3)
    assert 0.51 < got["bound_ms"] < 0.52
    act = kgemm.act_backward_bound(a, "tanh")
    assert act["bytes"] == 12 * 1024 * 4096 and act["bound_by"] == "bytes"
    assert act["bound_ms"] == pytest.approx(act["bytes"] / 3.35e12 * 1e3)


def test_bad_calls_raise():
    a, b = torch.ones(4, 6), torch.ones(6, 5)
    with pytest.raises(ValueError, match="fused kernel set"):
        kgemm.gemm_fc(a, b, None, "softmax")
    with pytest.raises(ValueError, match="float32"):
        kgemm.gemm_fc(a.to(torch.bfloat16), b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="need a"):
        kgemm.gemm_fc(a, torch.ones(5, 5))
    with pytest.raises(ValueError, match="bias"):
        kgemm.gemm_fc(a, b, torch.ones(4))
    with pytest.raises(ValueError, match="transpose"):
        kgemm.gemm_fc(torch.ones(4, 12)[:, ::2], b)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kgemm.gemm_fc(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="differ in shape"):
        kgemm.act_backward(torch.ones(3, 4), torch.ones(4, 3), "tanh")
    with pytest.raises(ValueError, match="contiguous"):
        kgemm.act_backward(torch.ones(4, 3).t(), torch.ones(3, 4), "tanh")


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """gemm_fc and act_backward on the card against their plain
    versions (TF32 off), bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    for m, k, n in ((7, 13, 3), (129, 200, 257), (256, 784, 512)):
        a = torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32,
                         device="cuda")
        b = torch.tensor(rng.normal(size=(k, n)) / np.sqrt(k),
                         dtype=torch.float32, device="cuda")
        bias = torch.tensor(rng.normal(size=n), dtype=torch.float32,
                            device="cuda")
        for act in ACTS:
            got = kgemm.gemm_fc(a, b, bias, act)
            assert torch.equal(got, kgemm.gemm_fc(a, b, bias, act))
            want = kgemm.fc_forward_plain(a, b, bias, act)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            err = torch.randn_like(got)
            torch.testing.assert_close(
                kgemm.act_backward(got, err, act),
                kgemm.act_backward_plain(got, err, act), rtol=1e-6,
                atol=1e-6)
    torch.cuda.synchronize()


#: (m, n, k) of the products the FC paths run: bench_fc's six (batch
#: 1024; 784-4096-4096 and its 10-way last layer), AlexNet's six at batch
#: 128 (fc6 9216 -> 4096, fc7 4096 -> 4096: forward, err_v.W^T and
#: x^T.err_v) and ragged shapes
PLAN_SHAPES = [(1024, 4096, 784), (1024, 4096, 4096), (1024, 4096, 4096),
               (1024, 784, 4096), (4096, 4096, 1024), (784, 4096, 1024),
               (1024, 10, 4096),
               (128, 4096, 9216), (128, 9216, 4096), (9216, 4096, 128),
               (128, 4096, 4096), (128, 4096, 4096), (4096, 4096, 128),
               (1, 1, 1), (7, 3, 13), (129, 257, 200), (300, 100, 1000),
               (5000, 70, 33)]


@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_gemm_plan_covers_the_output_and_fills_whole_waves(m, n, k):
    """The tile covers the output; the slices are whole 32-deep k tiles,
    none empty, and cover K; a split grid stays within GEMM_MAX_WAVES
    waves of the tile's resident blocks (SMS x GEMM_TILES), and no slice
    count in that range fills its last wave better (the count is then
    the fewest)."""
    plan = kgemm.gemm_plan(m, n, k)
    bm, bn = plan["tile"]
    assert (bm, bn) == kgemm.gemm_tile(m, n) and (bm, bn) in kgemm.GEMM_TILES
    assert bn >= min(n, 64) and bm == 128
    splits, per = plan["splits"], plan["per"]
    assert per % kgemm.K_TILE == 0
    assert (splits - 1) * per < k <= splits * per       # none empty
    tiles = -(-m // bm) * -(-n // bn)
    assert plan["blocks"] == tiles * splits
    wave = kgemm.SMS * plan["blocks_per_sm"]
    k_tiles = -(-k // kgemm.K_TILE)

    def fill(s):
        s = -(-k_tiles // -(-k_tiles // s))       # slices of whole tiles
        return s * tiles / (-(-s * tiles // wave) * wave)

    assert splits == 1 or splits * tiles <= kgemm.GEMM_MAX_WAVES * wave
    most = min(max(1, kgemm.GEMM_MAX_WAVES * wave // tiles), k_tiles)
    assert all(fill(s) <= fill(splits) + 1e-12 for s in range(1, most + 1))
    assert all(fill(s) < fill(splits) for s in range(1, splits))


def test_gemm_plan_splits_the_products_that_underfill_the_card():
    """bench_fc's fc0 err_v.W^T (56 tiles) and AlexNet's batch-128
    products (32-72 tiles) split K; products of a few waves of tiles, the
    headline among them, do not."""
    tiles = {(m, n): -(-m // 128) * -(-n // 128)
             for m, n in ((1024, 784), (128, 4096), (128, 9216))}
    assert tiles == {(1024, 784): 56, (128, 4096): 32, (128, 9216): 72}
    for m, n, k in ((1024, 784, 4096), (128, 4096, 9216),
                    (128, 9216, 4096), (128, 4096, 4096)):
        assert kgemm.gemm_plan(m, n, k)["splits"] > 1, (m, n, k)
    for m, n, k in ((1024, 4096, 4096), (4096, 4096, 1024),
                    (9216, 4096, 128), (4096, 4096, 128)):
        assert kgemm.gemm_plan(m, n, k)["splits"] == 1, (m, n, k)


#: (m, k, n) that split: one 128 x 128 tile of a long K, six tiles, a
#: K that ends inside a k tile, a 64-column tile
SPLIT_GEOMS = [(64, 2048, 100), (129, 1000, 257), (7, 300, 3),
               (200, 1300, 40)]


@pytest.mark.parametrize("geom", SPLIT_GEOMS)
@pytest.mark.parametrize("act", ACTS)
def test_gemm_split_plain_matches_pallas_interpret(geom, act):
    """The split arithmetic (each slice's product, summed in slice
    order, then bias and activation) against the Pallas matmul in
    interpret mode, through the forward and the backward's two products,
    within the FC bands (rtol 1e-4 / atol 1e-4 forward, 2e-4 / 2e-3
    backward)."""
    m, k, n = geom
    assert kgemm.gemm_plan(m, n, k)["splits"] > 1
    x, w, b, e = _operands((m, k, n))
    tx, tw, tb, te = (torch.tensor(v) for v in (x, w, b, e))
    want = np.asarray(jgemm.fc_forward(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), act, interpret=True))
    got = kgemm.gemm_split_plain(tx, tw, tb, act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    y = jlinear.forward(np, x, w, b, "linear")
    err_in, grad_w, _ = jgemm.fc_backward(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), jnp.asarray(e),
        "linear", interpret=True)
    assert kgemm.gemm_plan(m, k, n)["splits"] >= 1
    np.testing.assert_allclose(kgemm.gemm_split_plain(te, tw.t()).numpy(),
                               np.asarray(err_in), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(
        kgemm.gemm_split_plain(tx.t(), te).numpy(), np.asarray(grad_w),
        rtol=2e-4, atol=2e-3)


def test_gemm_split_plain_differs_from_unsplit_only_by_order():
    """One slice of all of K is the plain forward bit for bit; any split
    moves a value by the summation order alone."""
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.normal(size=(33, 700)).astype(np.float32))
    b = torch.tensor((rng.normal(size=(700, 20)) / np.sqrt(700)).astype(
        np.float32))
    bias = torch.tensor(rng.normal(size=20).astype(np.float32))
    whole = kgemm.fc_forward_plain(a, b, bias, "tanh")
    assert torch.equal(kgemm.gemm_split_plain(a, b, bias, "tanh", per=704),
                       whole)
    for per in (32, 96, 352):
        torch.testing.assert_close(
            kgemm.gemm_split_plain(a, b, bias, "tanh", per=per), whole,
            rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_split_kernel_matches_plain_at_alexnet_fc_shapes_on_the_card():
    """gemm_fc at AlexNet's fc7 products at batch 128 (the forward and
    err_v.W^T split K, x^T.err_v does not) against the plain version and
    the split arithmetic (TF32 off), bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(6)

        def dev(*shape, scale=1.0):
            return torch.tensor(rng.normal(size=shape) * scale,
                                dtype=torch.float32, device="cuda")

        x, w, e = dev(128, 4096), dev(4096, 4096, scale=1 / 64), dev(128,
                                                                    4096)
        bias = dev(4096)
        for a, b, bv, act in ((x, w, bias, "strict_relu"),
                              (e, w.t(), None, "linear"),
                              (x.t(), e, None, "linear")):
            got = kgemm.gemm_fc(a, b, bv, act)
            assert torch.equal(got, kgemm.gemm_fc(a, b, bv, act))
            torch.testing.assert_close(
                got, kgemm.fc_forward_plain(a, b, bv, act), rtol=1e-5,
                atol=1e-5)
            torch.testing.assert_close(
                got, kgemm.gemm_split_plain(a, b, bv, act), rtol=1e-5,
                atol=1e-5)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# -- act_backward with the bias gradient in one launch ----------------------

#: shapes of the fused act/bias pass: the reference's geometries' (B, O),
#: AlexNet's fc7/fc6 at batch 128, bench_fc's hidden layer at batch 1024,
#: one row, and columns off the 4-wide vector path
BIAS_SHAPES = [(32, 100), (7, 3), (129, 257), (8, 128), (128, 4096),
               (1024, 1024), (1, 5), (200, 13)]


@pytest.mark.parametrize("geom", FC_GEOMS)
@pytest.mark.parametrize("act", ACTS[1:])
def test_fused_bias_twin_matches_pallas_fc_backward(geom, act):
    """The plain twin of the one-launch backward (``err_v`` and
    ``grad_b`` in the kernel's order, then the two GEMMs) against the
    reference's ``fc_backward`` in interpret mode, at the FC GEMM band
    (rtol 1e-4 / atol 2e-4)."""
    x, w, b, e = _operands(geom)
    y = jlinear.forward(np, x, w, b, act)
    wants = jgemm.fc_backward(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                              jnp.asarray(e), act, interpret=True)
    err_v, grad_b = kgemm.act_bias_backward_plain(torch.tensor(y),
                                                  torch.tensor(e), act)
    gots = (kgemm.fc_forward_plain(err_v, torch.tensor(w).t()),
            kgemm.fc_forward_plain(torch.tensor(x).t(), err_v), grad_b)
    for name, g, want in zip(("err_input", "grad_w", "grad_b"), gots,
                             wants):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=2e-4, err_msg=name)
    # fc_backward on CPU tensors takes exactly this route
    for g, want in zip(kgemm.fc_backward(torch.tensor(x), torch.tensor(y),
                                         torch.tensor(w), torch.tensor(e),
                                         act), gots):
        assert torch.equal(g, want)


@pytest.mark.parametrize("m,n", BIAS_SHAPES)
@pytest.mark.parametrize("vec", [1, 4])
def test_bias_twin_against_an_f64_column_sum(m, n, vec):
    """The twin's column sums against the f64 sums of the same f32
    values, within the bound of any order of f32 additions: (m - 1) u
    sum |v| a column, u = 2^-24."""
    rng = np.random.default_rng(m * 31 + n)
    v = rng.normal(size=(m, n)).astype(np.float32)
    got = kgemm.column_sum_in_plan_order(torch.tensor(v), vec).numpy()
    want = v.astype(np.float64).sum(axis=0)
    bound = max(m - 1, 1) * 2.0 ** -24 * np.abs(v).astype(
        np.float64).sum(axis=0)
    assert np.all(np.abs(got - want) <= bound)


def _kernel_order_sums(v, vec):
    """act_backward's column sums as csrc/gemm.cu's threads take them,
    one f32 addition at a time in numpy: a lane's rows, a block's lanes
    (lane 0 first), then rank 0 over the cluster's ranks."""
    m, n = v.shape
    plan = kgemm.act_bias_plan(m, n, vec)
    per, f32 = plan["rows_per_lane"], np.float32
    out = np.zeros(n, np.float32)
    for col in range(n):
        g = f32(0)
        for rank in range(plan["ranks"]):
            b = f32(0)
            for lane in range(kgemm.ACT_LANES):
                acc = f32(0)
                r0 = (rank * kgemm.ACT_LANES + lane) * per
                for r in range(r0, min(m, r0 + per)):
                    acc = f32(acc + v[r, col])
                b = f32(b + acc)
            g = f32(g + b)
        out[col] = g
    return out


@pytest.mark.parametrize("m,n", [(129, 257), (37, 8), (7, 3), (300, 12)])
@pytest.mark.parametrize("vec", [1, 4])
def test_bias_twin_adds_in_the_kernels_order(m, n, vec):
    """The twin's vectorised sums give the bits of the kernel's per-thread
    order, so the smoke can hold the card's grad_b to it tightly."""
    v = np.random.default_rng(m + n).normal(size=(m, n)).astype(np.float32)
    got = kgemm.column_sum_in_plan_order(torch.tensor(v), vec).numpy()
    np.testing.assert_array_equal(got, _kernel_order_sums(v, vec))


@pytest.mark.parametrize("m,n", BIAS_SHAPES)
@pytest.mark.parametrize("vec", [1, 4])
def test_bias_plan_splits_every_row_once(m, n, vec):
    plan = kgemm.act_bias_plan(m, n, vec)
    ranks, per = plan["ranks"], plan["rows_per_lane"]
    assert ranks in (1, 2, 4, 8)
    assert plan["tiles"] * kgemm.ACT_COLS * vec >= n
    assert (plan["tiles"] - 1) * kgemm.ACT_COLS * vec < n
    assert ranks * kgemm.ACT_LANES * per >= m
    assert (ranks * kgemm.ACT_LANES * per - m) < ranks * kgemm.ACT_LANES
    # a rank more would have given some block no rows, or the grid
    # covers the SMs already
    assert ranks == kgemm.ACT_MAX_RANKS or ranks * kgemm.ACT_LANES >= m \
        or plan["tiles"] * ranks >= kgemm.SMS


def test_act_backward_bias_grad_refuses_linear_and_keeps_err_v():
    rng = np.random.default_rng(2)
    y, e = (torch.tensor(rng.normal(size=(5, 6)).astype(np.float32))
            for _ in range(2))
    with pytest.raises(ValueError, match="linear"):
        kgemm.act_backward(y, e, "linear", bias_grad=True)
    err_v, grad_b = kgemm.act_backward(y, e, "tanh", bias_grad=True)
    assert torch.equal(err_v, kgemm.act_backward_plain(y, e, "tanh"))
    assert grad_b.shape == (6,)
    b = kgemm.act_backward_bound(y, "tanh", bias_grad=True)
    assert b["bytes"] == 12 * 30 + 4 * 6 and b["bound_by"] == "bytes"


@pytest.mark.cuda
def test_fused_act_backward_on_the_card_is_one_launch_and_reproducible():
    """On a card: fc_backward with an activation makes one act_backward
    launch and two GEMM launches; err_v equals the twin's bits at strict
    ReLU; grad_b is bit-identical across launches and within 1e-6
    (norm-relative) of the twin."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    rng = np.random.default_rng(4)
    for m, n in ((128, 4096), (129, 257), (7, 3)):
        y = torch.tensor(np.maximum(rng.normal(size=(m, n)), 0),
                         dtype=torch.float32, device="cuda")
        e = torch.tensor(rng.normal(size=(m, n)), dtype=torch.float32,
                         device="cuda")
        got = kgemm.act_backward(y, e, "strict_relu", bias_grad=True)
        again = kgemm.act_backward(y, e, "strict_relu", bias_grad=True)
        want = kgemm.act_bias_backward_plain(y, e, "strict_relu")
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], again[1])
        assert float((got[1] - want[1]).norm() / want[1].norm()) <= 1e-6
        x = torch.randn(m, 16, device="cuda")
        w = torch.randn(16, n, device="cuda")
        before = (kgemm.gemm_launches, kgemm.act_launches)
        kgemm.fc_backward(x, y, w, e, "strict_relu")
        assert (kgemm.gemm_launches - before[0],
                kgemm.act_launches - before[1]) == (2, 1)
    torch.cuda.synchronize()
