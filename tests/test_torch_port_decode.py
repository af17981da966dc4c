"""The port's paged-decode kernel module (``znicz_tpu_torch/kernels/
decode.py``) against the reference: its plain PyTorch twin is held
against the JAX Pallas kernel run in interpret mode and against the
kernel's jnp ``reference``, on the same seeded numpy inputs over random
page tables and lengths (band 2e-5, f32 — the reference's own kernel
band).  Also the wrapper's CPU dispatch (plain version, no launch
counted) and its input checks.  The CUDA kernel itself runs only on a
card: its test is marked ``cuda`` and skips here."""

import numpy as np
import pytest
import torch

from znicz_tpu.ops.pallas.decode import paged_flash_decode, reference
from znicz_tpu_torch.kernels import decode as kdecode

#: f32 on both sides; the two softmaxes differ in summation order only
BAND = 2e-5

#: (B, H, Dh, page, n_pages, P) — the reference test's cases plus the
#: serving head dim at a ragged page count
CASES = [(3, 4, 8, 8, 10, 2), (2, 2, 16, 4, 7, 4), (1, 1, 8, 16, 3, 1),
         (4, 2, 64, 16, 12, 3), (2, 3, 16, 7, 9, 5)]


def _inputs(seed, B, H, Dh, page, n_pages, P):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    k = rng.normal(size=(n_pages, page, H, Dh)).astype(np.float32)
    v = rng.normal(size=(n_pages, page, H, Dh)).astype(np.float32)
    pt = rng.integers(0, n_pages, size=(B, P)).astype(np.int32)
    lengths = rng.integers(1, P * page + 1, size=(B,)).astype(np.int32)
    return q, k, v, pt, lengths


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernel_interpret_and_reference(case):
    args = _inputs(sum(case), *case)
    want_kernel = np.asarray(paged_flash_decode(*args, interpret=True))
    want_ref = np.asarray(reference(*args))
    got = kdecode.paged_decode_plain(*_torch(*args)).numpy()
    assert got.dtype == np.float32 and got.shape == want_ref.shape
    np.testing.assert_allclose(got, want_kernel, rtol=BAND, atol=BAND)
    np.testing.assert_allclose(got, want_ref, rtol=BAND, atol=BAND)


def test_plain_masks_rows_past_each_length_exactly():
    """Rows at or past ``lengths[b]`` carry no weight: scribbling over
    them (garbage pages, the scratch page) leaves the output bitwise
    unchanged."""
    q, k, v, _, _ = _inputs(7, 2, 2, 16, 4, 9, 3)
    pt = np.random.default_rng(7).permutation(9)[:6].reshape(2, 3) \
        .astype(np.int32)                    # no page shared by slots
    lengths = np.array([5, 9], np.int32)
    base = kdecode.paged_decode_plain(*_torch(q, k, v, pt, lengths))
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(lengths):
        for t in range(n, pt.shape[1] * 4):
            k2[pt[b, t // 4], t % 4] = 1e4
            v2[pt[b, t // 4], t % 4] = -1e4
    got = kdecode.paged_decode_plain(*_torch(q, k2, v2, pt, lengths))
    assert torch.equal(got, base)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    args = _torch(*_inputs(3, *CASES[0]))
    before = kdecode.launches
    out = kdecode.paged_decode(*args)
    assert kdecode.launches == before
    assert torch.equal(out, kdecode.paged_decode_plain(*args))


@pytest.mark.parametrize("bad", ["zero_length", "long_length",
                                 "page_id", "dtype", "shape", "table"])
def test_wrapper_rejects_bad_input(bad):
    q, k, v, pt, lengths = _torch(*_inputs(5, *CASES[0]))
    if bad == "zero_length":
        lengths[0] = 0
    elif bad == "long_length":
        lengths[0] = pt.shape[1] * k.shape[1] + 1
    elif bad == "page_id":
        pt[0, 0] = k.shape[0]
    elif bad == "dtype":
        lengths = lengths.long()
    elif bad == "shape":
        v = v[:, :, :1]
    else:
        pt = pt[:1]
    with pytest.raises(ValueError):
        kdecode.paged_decode(q, k, v, pt, lengths)


def test_supported_shapes_and_bound():
    assert kdecode.supported(64, torch.bfloat16)
    assert kdecode.supported(128, torch.float32)
    assert not kdecode.supported(16, torch.float32)
    assert not kdecode.supported(64, torch.float16)
    q, k, v, pt, lengths = _torch(*_inputs(2, 2, 2, 64, 16, 5, 2))
    lengths[:] = torch.tensor([3, 20], dtype=torch.int32)
    rows_bytes = 2 * 23 * 2 * 64 * 4          # K and V, live rows only
    assert kdecode.bound_bytes(q, k, pt, lengths) == (
        q.numel() * 4 + rows_bytes + pt.numel() * 4 + 2 * 4
        + 2 * 2 * 64 * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_kernel_matches_plain_on_card(dtype, head_dim):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    rng = np.random.default_rng(head_dim)
    B, H, page, n_pages, P = 3, 4, 16, 40, 8
    q = torch.tensor(rng.normal(size=(B, H, head_dim)), dtype=dtype,
                     device="cuda")
    k, v = (torch.tensor(rng.normal(size=(n_pages, page, H, head_dim)),
                         dtype=dtype, device="cuda") for _ in range(2))
    pt = torch.tensor(rng.integers(0, n_pages, size=(B, P)),
                      dtype=torch.int32, device="cuda")
    lengths = torch.tensor([1, 77, P * page], dtype=torch.int32,
                           device="cuda")
    before = kdecode.launches
    out = kdecode.paged_decode(q, k, v, pt, lengths)
    assert kdecode.launches == before + 1
    want = kdecode.paged_decode_plain(q, k, v, pt, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=BAND, atol=BAND)


#: the split-and-combine cases: (B, H, Dh, page, n_pages, P, lengths,
#: pages_per_split) — lengths 1 and 17, a length ending exactly on a
#: split boundary (2 pages of 8 = 16 rows a split), a slot whose later
#: splits hold no live row, and page views of 1 and of 128 pages
SPLIT_CASES = [
    (2, 4, 8, 8, 10, 4, (1, 17), 1),
    (3, 2, 16, 8, 12, 6, (16, 32, 48), 2),
    (2, 3, 8, 4, 20, 8, (3, 5), 2),
    (2, 2, 16, 16, 4, 1, (1, 16), 1),
    (2, 2, 64, 16, 300, 128, (1, 2048), 4),
    (8, 2, 8, 16, 300, 128, (1, 17, 64, 65, 300, 1024, 2047, 2048), 4)]


def _split_inputs(seed, B, H, Dh, page, n_pages, P, lengths):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    k = rng.normal(size=(n_pages, page, H, Dh)).astype(np.float32)
    v = rng.normal(size=(n_pages, page, H, Dh)).astype(np.float32)
    pt = rng.integers(0, n_pages, size=(B, P)).astype(np.int32)
    return q, k, v, pt, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_twin_matches_jax_kernel_interpret_and_reference(case):
    """The kernel's split-and-combine arithmetic (each split's (m, l,
    acc), merged in split order) against the JAX Pallas kernel in
    interpret mode and its jnp reference, f32, band 2e-5."""
    *shape, lengths, pps = case
    args = _split_inputs(sum(shape), *shape, lengths)
    want_ref = np.asarray(reference(*args))
    got = kdecode.paged_decode_split_plain(*_torch(*args), pps).numpy()
    assert got.dtype == np.float32 and got.shape == want_ref.shape
    np.testing.assert_allclose(got, want_ref, rtol=BAND, atol=BAND)
    if shape[5] <= 8:           # interpret mode walks the grid in Python
        want_kernel = np.asarray(paged_flash_decode(*args, interpret=True))
        np.testing.assert_allclose(got, want_kernel, rtol=BAND, atol=BAND)
    np.testing.assert_allclose(
        got, kdecode.paged_decode_plain(*_torch(*args)).numpy(),
        rtol=BAND, atol=BAND)


def test_split_twin_ignores_pages_past_each_length():
    """A split wholly past a slot's length contributes exactly nothing:
    scribbling over every page it would read leaves the output bitwise
    unchanged."""
    q, k, v, pt, lengths = _split_inputs(11, 2, 2, 8, 4, 20, 8, (5, 9))
    pt = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    base = kdecode.paged_decode_split_plain(*_torch(q, k, v, pt, lengths), 2)
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(lengths):
        for p in range(-(-n // 8) * 2, 8):      # splits past the length
            k2[pt[b, p]] = 1e4
            v2[pt[b, p]] = -1e4
    got = kdecode.paged_decode_split_plain(*_torch(q, k2, v2, pt, lengths),
                                           2)
    assert torch.equal(got, base)


@pytest.mark.parametrize("batch,pages,page", [
    (8, 128, 16), (8, 64, 16), (8, 16, 16), (8, 1, 16), (1, 128, 16),
    (2, 5, 4), (64, 8, 16), (3, 2048, 1)])
def test_decode_split_depends_on_shapes_only_and_covers_the_view(
        batch, pages, page):
    """The split is a function of (batch, pages, page) alone; its splits
    cover the view with none wholly past it; a split holds at least
    MIN_SPLIT_ROWS rows where the view does; the widest serving view
    gives 4 pages (64 rows) a split and 256 blocks."""
    pps, splits = kdecode.decode_split(batch, pages, page)
    assert (pps, splits) == kdecode.decode_split(batch, pages, page)
    assert 1 <= pps <= pages and (splits - 1) * pps < pages <= splits * pps
    assert pps * page >= min(kdecode.MIN_SPLIT_ROWS, pages * page)
    if pps > -(-kdecode.MIN_SPLIT_ROWS // page):
        assert splits * batch >= kdecode.SPLIT_BLOCKS // 2
    if (batch, pages, page) == (8, 128, 16):
        assert (pps, splits) == (4, 32)


def test_supported_takes_up_to_32_heads():
    """Up to 32 heads, and past them: a (split, slot) takes one block of
    up to HEADS_PER_BLOCK heads each, so 40 and 64 heads are served as
    the reference serves them; no head at all is not a shape."""
    assert kdecode.supported(64, torch.bfloat16, 8)
    assert kdecode.supported(128, torch.float32, kdecode.HEADS_PER_BLOCK)
    assert kdecode.supported(64, torch.bfloat16, 40)
    assert kdecode.supported(128, torch.bfloat16, 64)
    assert not kdecode.supported(64, torch.bfloat16, 0)
    assert [kdecode.head_blocks(h) for h in (1, 32, 33, 40, 64, 65)] == \
        [1, 1, 2, 2, 2, 3]


#: past one block's 32 heads: (B, H, Dh, page, n_pages, P, lengths)
HEAD_CASES = [(2, 40, 16, 8, 9, 3, (5, 24)), (2, 64, 8, 8, 9, 3, (1, 17))]


@pytest.mark.parametrize("case", HEAD_CASES)
def test_plain_matches_jax_past_32_heads(case):
    """At 40 and 64 heads the plain version and the split twin (at the
    split the wrapper takes for that head count) against the JAX Pallas
    kernel in interpret mode and its jnp reference, f32, band 2e-5."""
    *shape, lengths = case
    args = _split_inputs(sum(shape), *shape, lengths)
    want_kernel = np.asarray(paged_flash_decode(*args, interpret=True))
    want_ref = np.asarray(reference(*args))
    B, H, _, page, _, P = shape
    pps, _ = kdecode.decode_split(B, P, page, H)
    for got in (kdecode.paged_decode_plain(*_torch(*args)),
                kdecode.paged_decode_split_plain(*_torch(*args), pps)):
        assert got.shape == (B, H, shape[2])
        np.testing.assert_allclose(got.numpy(), want_kernel, rtol=BAND,
                                   atol=BAND)
        np.testing.assert_allclose(got.numpy(), want_ref, rtol=BAND,
                                   atol=BAND)


@pytest.mark.parametrize("batch,pages,page", [(8, 128, 16), (1, 128, 16),
                                              (8, 16, 16), (3, 2048, 1)])
def test_decode_split_counts_head_blocks(batch, pages, page):
    """Up to 32 heads the split is the one-block split it always was
    (the serving path's launch does not move); past them it aims the
    same ~SPLIT_BLOCKS blocks over the batch and the head blocks."""
    base = kdecode.decode_split(batch, pages, page)
    for heads in (1, 8, 32):
        assert kdecode.decode_split(batch, pages, page, heads) == base
    for heads in (40, 64, 96):
        pps, splits = kdecode.decode_split(batch, pages, page, heads)
        blocks = splits * batch * kdecode.head_blocks(heads)
        assert 1 <= pps <= pages and \
            (splits - 1) * pps < pages <= splits * pps
        assert pps >= base[0]
        if pps > -(-kdecode.MIN_SPLIT_ROWS // page):
            assert blocks >= kdecode.SPLIT_BLOCKS // 2
    assert kdecode.decode_split(8, 128, 16, 64) == (8, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SPLIT_CASES[3:])
def test_kernel_matches_plain_at_the_split_cases_on_card(dtype, case):
    """The split kernel and its combine at the split cases with head_dim
    64 (the view's widths kept), against the plain version, bit-identical
    across two launches, one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    B, H, _, page, n_pages, P, lengths, _ = case
    q, k, v, pt, ln = (torch.from_numpy(a).to("cuda") for a in
                       _split_inputs(P, B, H, 64, page, n_pages, P, lengths))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = kdecode.launches
    out = kdecode.paged_decode(q, k, v, pt, ln)
    again = kdecode.paged_decode(q, k, v, pt, ln)
    assert kdecode.launches == before + 2
    want = kdecode.paged_decode_plain(q, k, v, pt, ln)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, want, rtol=BAND, atol=BAND)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [40, 64])
def test_kernel_matches_plain_past_32_heads_on_card(dtype, heads):
    """Two head blocks a (split, slot), the second of 40 heads' holding
    8: the kernel against the plain version at head_dim 64 and 128,
    bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    for head_dim in kdecode.HEAD_DIMS:
        q, k, v, pt, ln = (torch.from_numpy(a).to("cuda") for a in
                           _split_inputs(heads + head_dim, 4, heads,
                                         head_dim, 16, 40, 8,
                                         (1, 33, 100, 128)))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        out = kdecode.paged_decode(q, k, v, pt, ln)
        again = kdecode.paged_decode(q, k, v, pt, ln)
        want = kdecode.paged_decode_plain(q, k, v, pt, ln)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        torch.testing.assert_close(out, want, rtol=BAND, atol=BAND)
