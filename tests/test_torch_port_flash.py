"""The port's flash-attention kernel module (``znicz_tpu_torch/kernels/
flash_attention.py``) against the reference: its plain PyTorch forward
and backward are held against the JAX Pallas kernels run in interpret
mode (``flash_attention`` / ``flash_attention_lse`` and their VJPs) on
the same seeded numpy inputs, at the reference's own bands (o within
2e-5, grads within 2e-4, f32).  A ragged ``t`` (which the GPU kernel
accepts and the TPU kernel does not) is held against the port's dense
``ops.attention.attention``.  Also the wrappers' CPU dispatch (plain
version, no launch counted), their input checks, ``supported`` and
``bound``.  The CUDA kernels run only on a card: those tests are marked
``cuda`` and skip here."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.ops.pallas.attention import flash_attention as jax_flash
from znicz_tpu.ops.pallas.attention import \
    flash_attention_lse as jax_flash_lse
from znicz_tpu_torch.kernels import flash_attention as kflash
from znicz_tpu_torch.ops.attention import attention as dense_attention

#: f32 on both sides, the reference's flash-vs-dense bands
#: (tests/test_pallas_kernels.py): forward and gradients
O_BAND, GRAD_BAND = 2e-5, 2e-4
B, T, H, DH = 2, 256, 2, 64


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_fwd_bwd_match_jax_kernel_interpret(causal):
    q, k, v, do = _inputs(4 + causal, (B, T, H, DH))
    o_ref, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_ref = vjp(jnp.asarray(do))
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    o = kflash.flash_attention(tq, tk, tv, causal=causal)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               rtol=O_BAND, atol=O_BAND)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_BAND, atol=GRAD_BAND)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_outputs_and_cotangent_match_jax(causal):
    """Both outputs of ``flash_attention_lse`` and a nonzero lse
    cotangent, which folds into Δ (Δ' = Δ - dlse)."""
    q, k, v, do = _inputs(9 + causal, (B * H, T, DH))
    dlse = np.random.default_rng(3).normal(size=(B * H, T, 1)) \
        .astype(np.float32)
    (o_ref, lse_ref), vjp = jax.vjp(
        lambda q, k, v: jax_flash_lse(q, k, v, causal, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_ref = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    o, lse = kflash.flash_attention_lse(tq, tk, tv, causal)
    assert lse.shape == (B * H, T, 1) and lse.dtype == torch.float32
    torch.autograd.backward((o, lse), (torch.from_numpy(do),
                                       torch.from_numpy(dlse)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               rtol=O_BAND, atol=O_BAND)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_ref),
                               rtol=O_BAND, atol=O_BAND)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_BAND, atol=GRAD_BAND)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_t_matches_dense_attention(causal):
    """t = 200 is no multiple of any tile; the plain path (what the GPU
    kernel is held to on the card) matches the dense op, forward and
    gradients."""
    q, k, v, do = _inputs(11, (B, 200, H, DH))
    got_leaves = [_leaf(a) for a in (q, k, v)]
    ref_leaves = [_leaf(a) for a in (q, k, v)]
    o = kflash.flash_attention(*got_leaves, causal=causal)
    ref = dense_attention(*ref_leaves, causal=causal)
    o.backward(torch.from_numpy(do))
    ref.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), ref.detach().numpy(),
                               rtol=O_BAND, atol=O_BAND)
    for got, want in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   rtol=GRAD_BAND, atol=GRAD_BAND)


def test_bf16_plain_rounds_p_before_the_value_product():
    """In bf16 the plain forward rounds p to bf16 before its product,
    like the reference kernel: it equals a hand-rolled f32 computation
    of exactly that recipe, and differs from the unrounded one."""
    q, k, v, _ = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(2, (2, 64, DH)))
    o, lse = kflash.flash_attention_fwd_plain(q, k, v, causal=True)
    s = (q.float() @ k.float().transpose(1, 2)) / math.sqrt(DH)
    s = s.masked_fill(torch.ones(64, 64).triu(1).bool(), -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    want = (p.to(torch.bfloat16).float() @ v.float()) / l
    assert o.dtype == torch.bfloat16
    assert torch.equal(o, want.to(torch.bfloat16))
    assert torch.equal(lse, m + torch.log(l))


def test_cpu_wrappers_run_plain_and_count_no_launch():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, (4, 96, DH)))
    fwd0, bwd0 = kflash.fwd_launches, kflash.bwd_launches
    o, lse = kflash.flash_attention_fwd(q, k, v, causal=True)
    o_p, lse_p = kflash.flash_attention_fwd_plain(q, k, v, causal=True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = (do * o).sum(-1, keepdim=True)
    got = kflash.flash_attention_bwd(q, k, v, do, lse, delta, causal=True)
    want = kflash.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                            causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (kflash.fwd_launches, kflash.bwd_launches) == (fwd0, bwd0)


@pytest.mark.parametrize("bad", ["rank", "shape", "dtype", "mixed_dtype",
                                 "device", "empty"])
def test_fwd_wrapper_rejects_bad_input(bad):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(6, (2, 32, DH)))
    if bad == "rank":
        q = q[None]
    elif bad == "shape":
        k = k[:, :16]
    elif bad == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif bad == "device":
        q, k, v = (x.to("meta") for x in (q, k, v))
    else:
        q, k, v = (x[:, :0] for x in (q, k, v))
    with pytest.raises(ValueError):
        kflash.flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("bad", ["do_shape", "lse_dtype", "delta_shape"])
def test_bwd_wrapper_rejects_bad_input(bad):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(7, (2, 32, DH)))
    lse = torch.zeros(2, 32, 1)
    delta = torch.zeros(2, 32, 1)
    if bad == "do_shape":
        do = do[:, :8]
    elif bad == "lse_dtype":
        lse = lse.double()
    else:
        delta = delta[:, :, 0]
    with pytest.raises(ValueError):
        kflash.flash_attention_bwd(q, k, v, do, lse, delta)


def test_batch_of_one_folds_contiguous_and_wrappers_refuse_strides():
    """At b = 1 folding (b, t, h, dh) to (h, t, dh) is a strided view;
    the fold makes it contiguous, as the kernels need, and the wrapper
    refuses a strided operand on the CPU as it would on the card."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(8, (1, 40, H, DH)))
    o = kflash.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(o.numpy(), dense_attention(q, k, v, True)
                               .numpy(), rtol=O_BAND, atol=O_BAND)
    strided = q.transpose(1, 2).reshape(H, 40, DH)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        kflash.flash_attention_fwd(strided, strided.contiguous(),
                                   strided.contiguous())


def test_flash_attention_rejects_mismatched_layouts():
    q = torch.zeros(1, 8, 2, DH)
    with pytest.raises(ValueError):
        kflash.flash_attention(q, torch.zeros(1, 8, 1, DH), q)


def test_supported_and_bound():
    assert kflash.supported(2048, 64, torch.bfloat16)
    assert kflash.supported(1000, 128, torch.float32)
    assert kflash.supported(1, 64)
    assert not kflash.supported(0, 64)
    assert not kflash.supported(2048, 32)
    assert not kflash.supported(2048, 64, torch.float16)
    q = torch.empty(64, 2048, 64, dtype=torch.bfloat16)
    pairs = 64 * 2048 * 2049 // 2
    fwd = kflash.bound(q, causal=True)
    bwd = kflash.bound(q, causal=True, backward=True)
    assert fwd["flops"] == 4 * pairs * 64
    assert bwd["flops"] == 10 * pairs * 64
    assert fwd["bytes"] == 4 * 64 * 2048 * 64 * 2 + 64 * 2048 * 4
    assert bwd["bytes"] == 8 * 64 * 2048 * 64 * 2 + 2 * 64 * 2048 * 4
    # the training shape is set by operations: ~0.035 / ~0.087 ms
    assert fwd["bound_by"] == bwd["bound_by"] == "operations"
    assert fwd["bound_ms"] == pytest.approx(4 * pairs * 64 / 989e12 * 1e3)
    assert 0.034 < fwd["bound_ms"] < 0.036
    assert 0.086 < bwd["bound_ms"] < 0.088
    full = kflash.bound(q, causal=False)
    assert full["flops"] == 4 * 64 * 2048 * 2048 * 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [17, 200, 1984])
def test_kernels_match_plain_on_card(dtype, head_dim, causal, t):
    """t 17 is shorter than one tile, 200 ragged, 1984 a multiple of 64
    but not of the bf16 kernels' 128-row tiles."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    rng = np.random.default_rng(head_dim + causal + t)
    q, k, v, do = (torch.tensor(rng.normal(size=(3, t, head_dim)),
                                dtype=dtype, device="cuda")
                   for _ in range(4))
    before = kflash.fwd_launches, kflash.bwd_launches
    o, lse = kflash.flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    grads = kflash.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    assert (kflash.fwd_launches, kflash.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    # deterministic: a second launch gives the same bits
    o2, lse2 = kflash.flash_attention_fwd(q, k, v, causal)
    grads2 = kflash.flash_attention_bwd(q, k, v, do, lse2, delta, causal)
    for a, b in zip((o, lse) + tuple(grads), (o2, lse2) + tuple(grads2)):
        assert torch.equal(a, b)
    o_p, lse_p = kflash.flash_attention_fwd_plain(q, k, v, causal)
    grads_p = kflash.flash_attention_bwd_plain(q, k, v, do, lse_p, delta,
                                               causal)
    torch.cuda.synchronize()
    # norm-relative error of each 64-row tile, chip_smoke.py's metric and
    # bands: lse and f32 differ in summation order only; bf16 o and
    # grads also in where p and ds round (online vs whole-row max)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, got, want in zip(("o", "lse", "dq", "dk", "dv"),
                               (o, lse) + tuple(grads),
                               (o_p, lse_p) + tuple(grads_p)):
        assert _tile_rel_err(got, want) <= (1e-6 if name == "lse" else tol)


def _tile_rel_err(a, b, rows=64):
    """The largest ||a - b|| / ||b|| over ``rows``-row tiles of each
    head of ``(bh, t, x)`` tensors."""
    worst = 0.0
    for s in range(0, a.shape[1], rows):
        diff = (a[:, s:s + rows] - b[:, s:s + rows]).float()
        ref = b[:, s:s + rows].float()
        worst = max(worst, float((diff.flatten(1).norm(dim=1) /
                                  ref.flatten(1).norm(dim=1)).max()))
    return worst


def test_tile_rel_err_sees_one_wrong_tile():
    """The metric of the card test: a wrong 64-row tile of a long head
    shows at its own size, however large the other tiles are."""
    b = torch.ones(2, 256, 8)
    b[:, :64] = 100.0
    a = b.clone()
    a[1, 192:] *= 1.5
    assert _tile_rel_err(a, b) == pytest.approx(0.5)
    assert _tile_rel_err(b, b) == 0.0
