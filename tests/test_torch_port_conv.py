"""The port's conv kernels (``kernels/conv.py``) and conv ops
(``ops/conv.py``) against the JAX package on the CPU.

The same seeded numpy operands go through the reference's Pallas conv
kernels in interpret mode (``conv2d_im2col``, ``conv2d_backward``) and
through the port's wrappers on CPU tensors (which run the plain
versions), across the reference's geometries (tests/test_pallas_kernels.
py:126-132) plus stride-4 11x11 geometries, with 4-tuple, 2-tuple, int and
asymmetric pads and inputs the last window does not reach.  The bands are
the reference's (tests/test_pallas_kernels.py:145, :448-453): rtol 1e-4 /
atol 1e-5 for the output and the input gradient, 1e-4 for the weight and
bias gradients.  Also ``ops/conv.py`` against the reference's numpy
oracle, launch counting, ``bound``, ``split_k`` and the wrappers' checks.
The kernel-vs-plain check on the card is ``cuda``-marked and skips here.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import conv as jconv
from znicz_tpu.ops.pallas import conv2d_backward, conv2d_im2col

from znicz_tpu_torch.kernels import conv as kconv
from znicz_tpu_torch.ops import conv as tconv

#: (h, w, cin, cout, k, sliding, padding): the reference's four, then
#: stride-4 11x11 (conv1's geometry) with a 2-tuple pad and rows/columns
#: past the last window, and int stride and pad
GEOMS = [
    (8, 8, 3, 16, 3, (1, 1), (0, 0, 0, 0)),
    (9, 7, 4, 8, 3, (2, 2), (1, 1, 1, 1)),
    (12, 12, 2, 8, 5, (2, 2), (2, 1, 0, 2)),
    (6, 6, 8, 32, 1, (1, 1), (0, 0, 0, 0)),
    (23, 23, 3, 8, 11, (4, 4), (0, 0, 0, 0)),
    (25, 22, 3, 8, 11, (4, 4), (1, 2)),
    (10, 10, 4, 6, 3, 2, 1),
]


def _operands(geom, seed=7):
    h, w, cin, cout, k, sliding, padding = geom
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, h, w, cin)).astype(np.float32)
    wts = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    y = jconv.forward_linear(np, x, wts, None, sliding, padding)
    e = rng.normal(size=y.shape).astype(np.float32)
    return x, wts, b, e, sliding, padding


@pytest.mark.parametrize("geom", GEOMS)
def test_forward_matches_pallas_interpret(geom):
    x, wts, b, _, sliding, padding = _operands(geom)
    for bias in (b, None):
        want = np.asarray(conv2d_im2col(
            jnp.asarray(x), jnp.asarray(wts),
            None if bias is None else jnp.asarray(bias), sliding, padding,
            interpret=True))
        got = kconv.conv2d_fwd(torch.tensor(x), torch.tensor(wts),
                               None if bias is None else torch.tensor(bias),
                               sliding, padding)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("geom", GEOMS)
def test_backward_matches_pallas_interpret(geom):
    x, wts, _, e, sliding, padding = _operands(geom, seed=11)
    ei_j, gw_j, gb_j = conv2d_backward(jnp.asarray(x), jnp.asarray(wts),
                                       jnp.asarray(e), sliding, padding,
                                       interpret=True)
    ei, gw, gb = kconv.conv2d_backward(torch.tensor(x), torch.tensor(wts),
                                       torch.tensor(e), sliding, padding)
    np.testing.assert_allclose(ei.numpy(), np.asarray(ei_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), rtol=1e-4,
                               atol=1e-4)
    none, gw2, _ = kconv.conv2d_backward(torch.tensor(x), torch.tensor(wts),
                                         torch.tensor(e), sliding, padding,
                                         need_err_input=False)
    assert none is None and torch.equal(gw2, gw)


@pytest.mark.parametrize("geom", GEOMS)
def test_ops_match_the_reference_numpy_oracle(geom):
    """``ops/conv.py``: the numpy branch is the reference's code, and the
    torch branch (the plain tap loops) agrees with it, forward and the
    activation-corrected backward."""
    x, wts, b, e, sliding, padding = _operands(geom, seed=3)
    act = "tanh"
    y = jconv.forward(np, x, wts, b, sliding, padding, act)
    np.testing.assert_array_equal(
        tconv.forward(np, x, wts, b, sliding, padding, act), y)
    t = torch.tensor
    np.testing.assert_allclose(
        tconv.forward(torch, t(x), t(wts), t(b), sliding, padding,
                      act).numpy(), y, rtol=1e-5, atol=1e-6)
    wants = jconv.backward(np, x, y, wts, e, sliding, padding, act)
    for got, want in zip(tconv.backward(np, x, y, wts, e, sliding, padding,
                                        act), wants):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tconv.backward(torch, t(x), t(y), t(wts), t(e),
                                        sliding, padding, act), wants):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_geometry_helpers_and_weight_views_match_the_reference():
    for kx, ky, s, p in ((3, 5, 2, 1), (11, 11, (4, 3), (1, 2)),
                         (1, 1, (1, 1), (0, 1, 2, 3))):
        assert tconv.normalize_geometry(kx, ky, s, p) == \
            jconv.normalize_geometry(kx, ky, s, p)
    for args in ((227, 11, 4, 0, 0), (27, 5, 1, 2, 2), (12, 5, 2, 2, 1)):
        assert tconv.out_size(*args) == jconv.out_size(*args)
    w = np.random.default_rng(1).normal(size=(3, 5, 4, 7)).astype(np.float32)
    ref = tconv.ref_weights_view(w)
    np.testing.assert_array_equal(ref, jconv.ref_weights_view(w))
    np.testing.assert_array_equal(tconv.from_ref_weights(ref, 3, 5, 4), w)


def test_input_grad_takes_the_input_geometry():
    """The input gradient's spatial size comes from the caller (deconv
    will pass its output shape): rows and columns past the last window
    get zeros, and an (h, w) the cotangent cannot come from raises."""
    x, wts, _, e, sliding, padding = _operands(GEOMS[5])
    ei = kconv.conv2d_input_grad(torch.tensor(e), torch.tensor(wts),
                                 sliding, padding, x.shape[1:3])
    assert ei.shape == x.shape
    want = jconv.backward(np, x, None, wts, e, sliding, padding, "linear",
                          activation_applied=False)[0]
    np.testing.assert_allclose(ei.numpy(), want, rtol=1e-4, atol=1e-5)
    assert float(ei[:, :, -1].abs().max()) == 0.0   # past the last window
    with pytest.raises(ValueError, match="not the output"):
        kconv.conv2d_input_grad(torch.tensor(e), torch.tensor(wts), sliding,
                                padding, (x.shape[1] + 9, x.shape[2]))


def test_cpu_calls_take_the_plain_path_and_count_no_launch():
    x, wts, b, e, sliding, padding = (
        torch.tensor(a) if isinstance(a, np.ndarray) else a
        for a in _operands(GEOMS[2]))
    before = (kconv.fwd_launches, kconv.input_grad_launches,
              kconv.weight_grad_launches)
    y = kconv.conv2d_fwd(x, wts, b, sliding, padding)
    assert torch.equal(y, kconv.conv2d_fwd_plain(x, wts, b, sliding,
                                                 padding))
    ei, gw, gb = kconv.conv2d_backward(x, wts, e, sliding, padding)
    assert torch.equal(ei, kconv.conv2d_input_grad_plain(
        e, wts, sliding, padding, x.shape[1:3]))
    pw, pb = kconv.conv2d_weight_grad_plain(x, e, wts.shape, sliding,
                                            padding)
    assert torch.equal(gw, pw) and torch.equal(gb, pb)
    assert (kconv.fwd_launches, kconv.input_grad_launches,
            kconv.weight_grad_launches) == before


def test_bound_counts_flops_and_bytes():
    """conv2 of AlexNet at batch 128: the 5x5 pad-2 window over 27x27
    reaches the image in 23·5 + 2·(3 + 4) = 129 of 135 (oy, iy) pairs a
    row, so 2·128·96·256·129² multiply-adds' flops, plus the bias."""
    x_shape, w_shape = (128, 27, 27, 96), (5, 5, 96, 256)
    fwd = kconv.bound("fwd", x_shape, w_shape, 1, 2)
    macs = 128 * 96 * 256 * 129 ** 2
    y_n = 128 * 27 * 27 * 256
    assert fwd["flops"] == 2 * macs + y_n
    assert fwd["bytes"] == 4 * (128 * 27 * 27 * 96 + 5 * 5 * 96 * 256 +
                                256 + y_n)
    assert fwd["bound_by"] == "operations"
    assert fwd["bound_ms"] == pytest.approx(fwd["flops"] / 67e12 * 1e3)
    grad = kconv.bound("input_grad", x_shape, w_shape, 1, 2)
    assert grad["flops"] == 2 * macs
    # conv1 touches no padding: the GEMM view's 2·M·N·K exactly
    c1 = kconv.bound("weight_grad", (128, 227, 227, 3), (11, 11, 3, 96), 4, 0)
    assert c1["flops"] == 2 * 387200 * 96 * 363 + 387200 * 96
    assert 0.40 < c1["bound_ms"] < 0.41
    with pytest.raises(ValueError, match="unknown"):
        kconv.bound("deconv", x_shape, w_shape)


@pytest.mark.parametrize("rows,n,k", [(364, 96, 387200), (2401, 256, 93312),
                                      (3457, 384, 21632), (28, 16, 108),
                                      (10, 4, 5)])
def test_split_k_fills_the_card_with_whole_k_tiles(rows, n, k):
    """Whole 32-pixel k tiles, no empty slice, at most
    WEIGHT_GRAD_MAX_WAVES waves of the tile's resident blocks, and no
    slice count in that range fills its last wave better (the count is
    then the fewest)."""
    splits, per = kconv.split_k(rows, n, k)
    assert per % kconv.WEIGHT_GRAD_K_TILE == 0
    assert (splits - 1) * per < k <= splits * per       # none empty
    bm, bn = kconv.weight_grad_tile(rows, n)
    tiles = -(-(rows - 1) // bm) * -(-n // bn)
    wave = kconv.SMS * kconv.WEIGHT_GRAD_TILES[(bm, bn)]
    k_tiles = -(-k // kconv.WEIGHT_GRAD_K_TILE)

    def fill(s):
        s = -(-k_tiles // -(-k_tiles // s))       # slices of whole tiles
        return s * tiles / (-(-s * tiles // wave) * wave)

    assert splits == 1 or splits * tiles <= \
        kconv.WEIGHT_GRAD_MAX_WAVES * wave
    most = min(max(1, kconv.WEIGHT_GRAD_MAX_WAVES * wave // tiles), k_tiles)
    assert all(fill(s) <= fill(splits) + 1e-12 for s in range(1, most + 1))
    assert all(fill(s) < fill(splits) for s in range(1, splits))


def test_bad_calls_raise():
    x, w = torch.ones(2, 8, 8, 3), torch.ones(3, 3, 3, 4)
    with pytest.raises(ValueError, match="float32"):
        kconv.conv2d_fwd(x.double(), w.double())
    with pytest.raises(ValueError, match="matching channels"):
        kconv.conv2d_fwd(x, torch.ones(3, 3, 2, 4))
    with pytest.raises(ValueError, match="contiguous"):
        kconv.conv2d_fwd(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="b must be"):
        kconv.conv2d_fwd(x, w, torch.ones(3))
    with pytest.raises(ValueError, match="empty conv"):
        kconv.conv2d_fwd(torch.ones(2, 2, 2, 3), w)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kconv.conv2d_fwd(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="agree"):
        kconv.conv2d_weight_grad(x, torch.ones(2, 6, 6, 5), w.shape)


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps (8 significant bits) of ``want``, or of
    2^-10 where ``want`` is smaller: a sum that cancels below 2^-10 keeps
    the f32 rounding of its products (~1e-7 over the 576 of the sweep's
    shape), which is more than a bf16 ulp there."""
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -10)))
                  - 7)
    return np.abs(np.asarray(got, np.float32) - want) / ulp


@pytest.mark.parametrize("geom", GEOMS + [(16, 16, 64, 128, 3, (1, 1),
                                           (1, 1, 1, 1))])
def test_bf16_forward_matches_pallas_interpret(geom):
    """bf16 operands, f32 sums, the bf16 bias added in f32, one rounding:
    the port's plain version (the card's kernel's contract) against the
    reference's kernel in interpret mode within 1 bf16 ulp (the two sum
    in other orders before the one rounding), and both within the
    reference sweep's bf16 band (5e-2 / 5e-1, utils/pallas_hw.py:266-267)
    of the f32 oracle on the same bf16-rounded operands.  The last case
    is the sweep's own shape at batch 3."""
    x, wts, b, _, sliding, padding = _operands(geom)
    xb, wb, bb = (torch.tensor(a).bfloat16() for a in (x, wts, b))
    for bias, tb in ((b, bb), (None, None)):
        want = conv2d_im2col(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(wts, jnp.bfloat16),
            None if bias is None else jnp.asarray(bias, jnp.bfloat16),
            sliding, padding, interpret=True)
        assert want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        got = kconv.conv2d_fwd(xb, wb, tb, sliding, padding)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _bf16_ulps(got.float().numpy(), want).max() <= 1.0
        oracle = jconv.forward_linear(
            np, xb.float().numpy(), wb.float().numpy(),
            None if tb is None else tb.float().numpy(), sliding, padding)
        for out in (got.float().numpy(), want):
            np.testing.assert_allclose(out, oracle, rtol=5e-2, atol=5e-1)


def test_bf16_forward_rounds_once():
    """The plain bf16 version equals the f32 plain version on the widened
    operands, rounded once; bound counts 2-byte operands and the bf16
    tensor-core peak."""
    x, wts, b, _, sliding, padding = _operands(GEOMS[1])
    xb, wb, bb = (torch.tensor(a).bfloat16() for a in (x, wts, b))
    y32 = kconv.conv2d_fwd(xb.float(), wb.float(), bb.float(), sliding,
                           padding)
    assert torch.equal(kconv.conv2d_fwd(xb, wb, bb, sliding, padding),
                       y32.bfloat16())
    f32 = kconv.bound("fwd", (128, 27, 27, 96), (5, 5, 96, 256), 1, 2)
    bf16 = kconv.bound("fwd", (128, 27, 27, 96), (5, 5, 96, 256), 1, 2,
                       dtype=torch.bfloat16)
    assert bf16["flops"] == f32["flops"] and 2 * bf16["bytes"] == \
        f32["bytes"]
    assert bf16["bound_ms"] == pytest.approx(
        max(bf16["flops"] / 989e12, bf16["bytes"] / 3.35e12) * 1e3)
    with pytest.raises(ValueError, match="f32 only"):
        kconv.bound("input_grad", (128, 27, 27, 96), (5, 5, 96, 256),
                    dtype=torch.bfloat16)


#: the bf16 forward's N-tile edges (kernels/conv.py fwd_bf16_tile): conv1's
#: cin 3 / cout 96 at its stride-4 11x11 geometry (the gathered A path),
#: then couts at and past the 64, 128, 192 and 256 tiles, cout 6 (the
#: scalar B path) and cin 5 (the gathered A path) at stride 2 with
#: asymmetric pads; (h, w, cin, cout, k, sliding, padding)
BF16_EDGE_GEOMS = [
    (23, 23, 3, 96, 11, (4, 4), (0, 0, 0, 0)),
    (7, 7, 8, 64, 3, (1, 1), (1, 1, 1, 1)),
    (7, 7, 8, 65, 3, (1, 1), (1, 1, 1, 1)),
    (6, 6, 16, 192, 3, (1, 1), (1, 1, 1, 1)),
    (6, 6, 16, 200, 3, (1, 1), (1, 1, 1, 1)),
    (9, 9, 5, 6, 3, (2, 2), (0, 1, 1, 0)),
]
#: the input gradient's N-tile edges (kernels/conv.py input_grad_tile): cin
#: 1, 3 and 8 in the 8-wide tile, 17 in the 32-wide one, 64 and 96 at the
#: tops of theirs; each at stride 2 with asymmetric pads (four residue
#: classes, the 16-byte copies of cout % 4 == 0) and at stride 1 with
#: cout 6 (the scalar copies); (h, w, cout, k, sliding, padding)
IG_EDGE_CIN = (1, 3, 8, 17, 64, 96)
IG_EDGE_GEOMS = [(11, 10, 12, 3, (2, 2), (1, 0, 2, 1)),
                 (9, 9, 6, 3, (1, 1), (1, 1, 1, 1))]


def _bf16_edge_operands(geom, seed=13):
    h, w, cin, cout, k, sliding, padding = geom
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    wts = (rng.normal(size=(k, k, cin, cout)) / np.sqrt(k * k * cin)) \
        .astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, wts, b, sliding, padding


@pytest.mark.parametrize("geom", BF16_EDGE_GEOMS)
def test_bf16_plain_at_the_tile_edges_matches_pallas_interpret(geom):
    """The card's oracle for the bf16 forward, held against the reference
    at every N tile the kernel picks: within 1 bf16 ulp of the Pallas
    kernel in interpret mode, as at the reference's geometries."""
    x, wts, b, sliding, padding = _bf16_edge_operands(geom)
    xb, wb, bb = (torch.tensor(a).bfloat16() for a in (x, wts, b))
    want = conv2d_im2col(jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(wts, jnp.bfloat16),
                         jnp.asarray(b, jnp.bfloat16), sliding, padding,
                         interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = kconv.conv2d_fwd(xb, wb, bb, sliding, padding)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _bf16_ulps(got.float().numpy(), want).max() <= 1.0


def _ig_edge_operands(cin, geom, seed=17):
    h, w, cout, k, sliding, padding = geom
    rng = np.random.default_rng(seed + cin)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    wts = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    y = jconv.forward_linear(np, x, wts, None, sliding, padding)
    e = rng.normal(size=y.shape).astype(np.float32)
    return x, wts, e, sliding, padding


@pytest.mark.parametrize("geom", IG_EDGE_GEOMS)
@pytest.mark.parametrize("cin", IG_EDGE_CIN)
def test_input_grad_plain_at_the_tile_edges_matches_the_reference(cin,
                                                                  geom):
    """The card's oracle for the input gradient, at every N tile the
    kernel picks, against the reference's Pallas conv2d_backward in
    interpret mode and its numpy backward (rtol 1e-4, atol 1e-5)."""
    x, wts, e, sliding, padding = _ig_edge_operands(cin, geom)
    got = kconv.conv2d_input_grad(torch.tensor(e), torch.tensor(wts),
                                  sliding, padding, x.shape[1:3])
    ei_j, _, _ = conv2d_backward(jnp.asarray(x), jnp.asarray(wts),
                                 jnp.asarray(e), sliding, padding,
                                 interpret=True)
    ei_o, _, _ = jconv.backward(np, x, None, wts, e, sliding, padding,
                                "linear", activation_applied=False)
    assert got.shape == x.shape
    for want in (np.asarray(ei_j), ei_o):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_tile_choices_fit_the_paths_widths():
    """Both tile choices are functions of one channel count: the input
    gradient's of cin (AlexNet's conv2-5 and build_deep's conv2, deconv1
    and deconv2 below), the bf16 forward's of cout (AlexNet's five), with
    no more padding than the next tile would need."""
    tile = kconv.input_grad_tile
    assert [tile(c) for c in (96, 256, 384, 384)] == \
        [(128, 96), (128, 128), (128, 128), (128, 128)]
    assert [tile(c) for c in (64, 64, 3)] == [(128, 64), (128, 64), (256, 8)]
    assert [tile(c) for c in (1, 8, 9, 17, 32, 33, 96, 97)] == \
        [(256, 8), (256, 8), (128, 32), (128, 32), (128, 32), (128, 64),
         (128, 96), (128, 128)]
    bn = kconv.fwd_bf16_tile
    assert [bn(c) for c in (96, 256, 384, 384, 256)] == \
        [128, 256, 192, 192, 256]
    assert [bn(c) for c in (1, 64, 65, 128, 129, 193, 512, 640)] == \
        [64, 64, 128, 128, 192, 256, 256, 128]
    for c in range(1, 1025):
        assert bn(c) in (64, 128, 192, 256)
        assert math.ceil(c / bn(c)) * bn(c) <= min(
            math.ceil(c / t) * t for t in (128, 192, 256))
    assert kconv.BF16_K_TILE == 64 and kconv.K_TILE == 16
    assert kconv.WEIGHT_GRAD_K_TILE == 32


def test_unsupported_dtypes_raise_before_any_launch():
    """f16, f64 and mixed operands raise in the wrappers whatever the
    device (the dtype is checked before the device is looked at: the
    meta tensors stand in for the card's here); the gradients are f32
    only."""
    x, w, b = torch.ones(2, 8, 8, 3), torch.ones(3, 3, 3, 4), torch.ones(4)
    for dev in ("cpu", "meta"):
        x_, w_, b_ = (t.to(dev) for t in (x, w, b))
        for bad in (torch.float16, torch.float64):
            with pytest.raises(ValueError, match="float32 or bfloat16"):
                kconv.conv2d_fwd(x_.to(bad), w_.to(bad))
        with pytest.raises(ValueError, match="share one dtype"):
            kconv.conv2d_fwd(x_.bfloat16(), w_)
        with pytest.raises(ValueError, match="share one dtype"):
            kconv.conv2d_fwd(x_.bfloat16(), w_.bfloat16(), b_)
        e = torch.ones(2, 6, 6, 4, device=dev)
        with pytest.raises(ValueError, match="must be float32"):
            kconv.conv2d_input_grad(e.bfloat16(), w_.bfloat16(), 1, 0,
                                    (8, 8))
        with pytest.raises(ValueError, match="must be float32"):
            kconv.conv2d_weight_grad(x_.bfloat16(), e.bfloat16(), w.shape)


@pytest.mark.cuda
def test_unsupported_dtypes_raise_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(2, 8, 8, 4, device="cuda")
    w = torch.ones(3, 3, 4, 8, device="cuda")
    for bad in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            kconv.conv2d_fwd(x.to(bad), w.to(bad))
    with pytest.raises(ValueError, match="share one dtype"):
        kconv.conv2d_fwd(x.bfloat16(), w)
    y = kconv.conv2d_fwd(x.bfloat16(), w.bfloat16())
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and float(y.float().max()) == 36.0


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """The three kernels on the card against their plain versions (TF32
    off) at the geometries above, bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for geom in GEOMS:
            x, wts, b, e, sliding, padding = (
                torch.tensor(a, device="cuda") if isinstance(a, np.ndarray)
                else a for a in _operands(geom))
            y = kconv.conv2d_fwd(x, wts, b, sliding, padding)
            assert torch.equal(y, kconv.conv2d_fwd(x, wts, b, sliding,
                                                   padding))
            torch.testing.assert_close(
                y, kconv.conv2d_fwd_plain(x, wts, b, sliding, padding),
                rtol=1e-5, atol=1e-5)
            got = kconv.conv2d_backward(x, wts, e, sliding, padding)
            want = (kconv.conv2d_input_grad_plain(e, wts, sliding, padding,
                                                  x.shape[1:3]),
                    *kconv.conv2d_weight_grad_plain(x, e, wts.shape,
                                                    sliding, padding))
            for g, w_ in zip(got, want):
                torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_redesigned_kernels_match_plain_at_the_tile_edges_on_the_card():
    """The wgmma bf16 forward at the reference's geometries and every N
    tile (within 1 bf16 ulp of its plain version), and the input
    gradient at every N tile (f32, TF32 off), both bit-identical across
    two launches."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for geom in GEOMS[:4] + BF16_EDGE_GEOMS:
            x, wts, b, sliding, padding = _bf16_edge_operands(geom)
            xb, wb, bb = (torch.tensor(a, device="cuda").bfloat16()
                          for a in (x, wts, b))
            y = kconv.conv2d_fwd(xb, wb, bb, sliding, padding)
            assert torch.equal(y, kconv.conv2d_fwd(xb, wb, bb, sliding,
                                                   padding))
            want = kconv.conv2d_fwd_plain(xb, wb, bb, sliding, padding)
            assert _bf16_ulps(y.float().cpu().numpy(),
                              want.float().cpu().numpy()).max() <= 1.0
        for cin in IG_EDGE_CIN:
            for geom in IG_EDGE_GEOMS:
                x, wts, e, sliding, padding = (
                    torch.tensor(a, device="cuda")
                    if isinstance(a, np.ndarray) else a
                    for a in _ig_edge_operands(cin, geom))
                got = kconv.conv2d_input_grad(e, wts, sliding, padding,
                                              x.shape[1:3])
                assert torch.equal(got, kconv.conv2d_input_grad(
                    e, wts, sliding, padding, x.shape[1:3]))
                torch.testing.assert_close(
                    got, kconv.conv2d_input_grad_plain(
                        e, wts, sliding, padding, x.shape[1:3]),
                    rtol=1e-5, atol=1e-5)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


#: the weight gradient's products on the paths: (rows, cout, pixels) of
#: AlexNet's five layers at batch 128 and build_deep's two shapes at
#: batch 64 (its conv1 and deconv2's grad_w: rows 49; conv2 and
#: deconv1's: rows 1025)
WGRAD_PATH_SHAPES = [(364, 96, 387200), (2401, 256, 93312),
                     (2305, 384, 21632), (3457, 384, 21632),
                     (3457, 256, 21632), (49, 64, 65536), (1025, 128, 16384)]


@pytest.mark.parametrize("rows,n,k", WGRAD_PATH_SHAPES)
def test_weight_grad_grid_fills_whole_waves_on_the_paths(rows, n, k):
    """At the paths' shapes the grid stays within a whole number of
    waves of the tile's resident blocks (SMS x WEIGHT_GRAD_TILES) and
    fills at least 85 % of its last wave; the tile follows (rows, cout)."""
    grid = kconv.weight_grad_grid(rows, n, k)
    bm, bn = grid["tile"]
    assert (bm, bn) == ((64 if rows <= 65 else 128), (64 if n <= 64
                                                      else 128))
    wave = kconv.SMS * grid["blocks_per_sm"]
    waves = -(-grid["blocks"] // wave)
    assert 1 <= waves <= kconv.WEIGHT_GRAD_MAX_WAVES
    assert grid["blocks"] >= 0.85 * waves * wave
    assert grid["blocks"] == -(-(rows - 1) // bm) * -(-n // bn) * \
        grid["splits"]
    assert (grid["splits"], grid["per"]) == kconv.split_k(rows, n, k)


def test_weight_grad_tiles_are_a_function_of_rows_and_cout():
    tile = kconv.weight_grad_tile
    assert [tile(r, 64) for r in (2, 49, 65, 66, 1025)] == \
        [(64, 64), (64, 64), (64, 64), (128, 64), (128, 64)]
    assert [tile(49, c) for c in (1, 8, 64, 65, 96, 384)] == \
        [(64, 64)] * 3 + [(64, 128)] * 3
    assert set(kconv.WEIGHT_GRAD_TILES) == {
        tile(r, c) for r in (49, 1025) for c in (8, 96)}


#: the weight gradient on the card: (batch, side, cin, cout, k, stride,
#: pad) at cin 1, 3, 4, 17 and 96 by cout 8, 64 and 96, and build_deep's
#: two shapes (rows 49 and 1025) at a smaller batch
WGRAD_CARD_GEOMS = [(2, 11, cin, cout, 3, 2, 1) for cin in (1, 3, 4, 17, 96)
                    for cout in (8, 64, 96)] + \
    [(8, 64, 3, 64, 4, 2, 1), (8, 32, 64, 128, 4, 2, 1)]


@pytest.mark.cuda
def test_weight_grad_matches_plain_across_tiles_on_the_card():
    """The weight gradient (every tile, both loaders, split-K and the
    bias row) against its plain version in f32 with TF32 off, within the
    reference's 1e-4, bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(3)
        for n, side, cin, cout, k, s, p in WGRAD_CARD_GEOMS:
            oh = (side + 2 * p - k) // s + 1
            x = torch.tensor(rng.normal(size=(n, side, side, cin)),
                             dtype=torch.float32, device="cuda")
            e = torch.tensor(rng.normal(size=(n, oh, oh, cout)),
                             dtype=torch.float32, device="cuda")
            w_shape = (k, k, cin, cout)
            got = kconv.conv2d_weight_grad(x, e, w_shape, s, p)
            again = kconv.conv2d_weight_grad(x, e, w_shape, s, p)
            want = kconv.conv2d_weight_grad_plain(x, e, w_shape, s, p)
            for g, a, w_ in zip(got, again, want):
                assert torch.equal(g, a)
                torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


#: the f32 forward's products on the paths: (m = n·oh·ow, cout) of
#: AlexNet's five layers at batch 128, build_deep's conv1 and conv2 (and
#: the deconvs' err_input, the same shapes) at batch 64, and ragged ones
FWD_F32_SHAPES = [(387200, 96), (93312, 256), (21632, 384), (21632, 384),
                  (21632, 256), (65536, 64), (16384, 128), (1, 1), (75, 3),
                  (300, 200), (100000, 1000), (8448, 129)]


@pytest.mark.parametrize("m,cout", FWD_F32_SHAPES)
def test_fwd_f32_tile_fits_cout_and_fills_whole_waves(m, cout):
    """BN pads cout no more than any tile of the family (the narrowest
    that holds cout up to 128: conv1's 96 takes 96, not 128); BM is 128
    unless 64 fills the last wave of its resident blocks (SMS x
    FWD_F32_TILES) strictly better, and never fills it worse."""
    bm, bn = kconv.fwd_f32_tile(m, cout)
    assert (bm, bn) in kconv.FWD_F32_TILES
    assert -(-cout // bn) * bn == min(-(-cout // t) * t for t in (64, 96,
                                                                 128))
    if cout <= 128:
        assert bn == min(t for t in (64, 96, 128) if t >= cout)
    n_tiles = -(-cout // bn)

    def fill(tm):
        tiles = -(-m // tm) * n_tiles
        wave = kconv.SMS * kconv.FWD_F32_TILES[(tm, bn)]
        return tiles / (-(-tiles // wave) * wave)

    assert fill(bm) >= fill(192 - bm)
    assert bm == 128 or fill(64) > fill(128)


def test_fwd_f32_tile_on_alexnet_takes_cout_tiles_without_padding():
    bns = [kconv.fwd_f32_tile(m, c)[1] for m, c in FWD_F32_SHAPES[:5]]
    assert bns == [96, 128, 128, 128, 128]
    assert set(kconv.FWD_F32_TILES) == {(bm, bn) for bm in (64, 128)
                                        for bn in (64, 96, 128)}


#: the f32 forward on the card: (batch, side, cin, cout, k, stride, pad)
#: at cin 3 (the one-float gather) and 4, 17, 96 by cout 8, 64, 96, 128,
#: 200 and 384 (every N tile, one and several N tiles)
FWD_F32_CARD_GEOMS = [(2, 13, cin, cout, 3, s, 1) for cin in (3, 4, 17, 96)
                      for cout in (8, 64, 96, 128, 200, 384)
                      for s in (1, 2)] + [(4, 35, 3, 96, 11, 4, 0)]


@pytest.mark.cuda
def test_fwd_f32_matches_plain_across_tiles_on_the_card():
    """The f32 forward (every N tile, both loaders, ragged M and N)
    against its plain version with TF32 off, within rtol / atol 1e-5
    (outputs of unit scale), bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(8)
        for n, side, cin, cout, k, s, p in FWD_F32_CARD_GEOMS:
            x = torch.tensor(rng.normal(size=(n, side, side, cin)),
                             dtype=torch.float32, device="cuda")
            w = torch.tensor(rng.normal(size=(k, k, cin, cout)) /
                             np.sqrt(k * k * cin), dtype=torch.float32,
                             device="cuda")
            b = torch.tensor(rng.normal(size=cout), dtype=torch.float32,
                             device="cuda")
            got = kconv.conv2d_fwd(x, w, b, s, p)
            assert torch.equal(got, kconv.conv2d_fwd(x, w, b, s, p))
            torch.testing.assert_close(
                got, kconv.conv2d_fwd_plain(x, w, b, s, p), rtol=1e-5,
                atol=1e-5)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
