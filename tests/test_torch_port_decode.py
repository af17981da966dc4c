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
