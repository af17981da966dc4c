"""The port's LRN and dropout kernels and its kernel-layer check against
the JAX package on the CPU.

- ``kernels/lrn.py``'s plain versions against the Pallas ``lrn_forward``
  / ``lrn_backward`` in interpret mode, n in {3, 5} (and an even n),
  beta 0.75 and another, at the reference's 1e-4 / 1e-3 bands; the
  library yardstick ``F.local_response_norm`` with alpha·n computes the
  same forward;
- ``kernels/dropout.py``'s plain version against the Pallas
  ``dropout_forward`` through ``bits=``, in f32 and in bf16 (the mask the
  scale cast to bf16, y the bf16 product rounded once): identical y and
  mask; the ``seed=`` draw (mask values, drop rate, y = x·mask);
  ``dropout_plan`` at the smoke's shapes and where n fills no whole
  16-byte group or x lies off 16 bytes;
- ``utils/kernel_hw.run_parity("cpu")``: ``ok`` for every ported family,
  the unported ones named so and never ``ok``, and ``FAIL`` for a
  deliberately broken plain version;
- ``lrn_plan``: each direction's quad path at AlexNet's widths, the
  element path at c % 4 != 0 and off 16 bytes;
- the ``lrn`` autograd Function: its gradient is the plain backward's,
  it saves x only, and on CPU tensors it counts no launch;
- refusals, bounds, and ``cuda``-marked card checks (both LRN
  directions bit-identical on both paths; the dropout kernel bit for bit
  in bf16 and on its element path).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from znicz_tpu.ops.pallas import dropout_forward as j_dropout_forward
from znicz_tpu.ops.pallas import lrn_backward as j_lrn_backward
from znicz_tpu.ops.pallas import lrn_forward as j_lrn_forward
from znicz_tpu.utils import pallas_hw

from znicz_tpu_torch.kernels import dropout as kdrop
from znicz_tpu_torch.kernels import kohonen as ksom
from znicz_tpu_torch.kernels import lrn as klrn
from znicz_tpu_torch.utils import kernel_hw


@pytest.mark.parametrize("n", [3, 5, 4])
@pytest.mark.parametrize("beta", [0.75, 0.6])
def test_lrn_plain_matches_pallas(n, beta):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, 5, 4, 24)) * 3).astype(np.float32)
    e = rng.normal(size=x.shape).astype(np.float32)
    args = (1e-2, beta, 2.0, n)
    before = (klrn.fwd_launches, klrn.bwd_launches)
    y = klrn.lrn_forward(torch.tensor(x), *args)
    dx = klrn.lrn_backward(torch.tensor(x), torch.tensor(e), *args)
    assert (klrn.fwd_launches, klrn.bwd_launches) == before
    np.testing.assert_allclose(
        y.numpy(), np.asarray(j_lrn_forward(jnp.asarray(x), *args,
                                            interpret=True)),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        dx.numpy(), np.asarray(j_lrn_backward(jnp.asarray(x), jnp.asarray(e),
                                              *args, interpret=True)),
        rtol=1e-3, atol=1e-4)


def test_lrn_backward_is_the_adjoint():
    """<dx, v> = <e, J v> for the forward's Jacobian J (central
    difference in f64): the backward is the exact adjoint, even n too."""
    rng = np.random.default_rng(1)
    for n in (4, 5):
        x = torch.tensor(rng.normal(size=(3, 10)) * 2)
        e = torch.tensor(rng.normal(size=(3, 10)))
        v = torch.tensor(rng.normal(size=(3, 10)))
        args = (0.05, 0.75, 1.0, n)
        h = 1e-6
        jv = (klrn.lrn_forward_plain(x + h * v, *args) -
              klrn.lrn_forward_plain(x - h * v, *args)) / (2 * h)
        lhs = float((klrn.lrn_backward_plain(x, e, *args) * v).sum())
        assert abs(lhs - float((e * jv).sum())) < 1e-6


@pytest.mark.parametrize("n", [5, 4])
def test_local_response_norm_with_alpha_n_is_the_same_forward(n):
    """The library yardstick the smoke times: torch's LRN averages x² over
    the window (pads n//2 below, (n-1)//2 above: the port's window), so
    alpha·n gives the port's forward, odd and even n."""
    rng = np.random.default_rng(2)
    x = torch.tensor((rng.normal(size=(2, 4, 3, 16)) * 3).astype(np.float32))
    alpha, beta, k = 1e-2, 0.75, 2.0
    lib = F.local_response_norm(x.permute(0, 3, 1, 2), n, alpha=alpha * n,
                                beta=beta, k=k).permute(0, 2, 3, 1)
    np.testing.assert_allclose(lib.numpy(),
                               klrn.lrn_forward(x, alpha, beta, k, n).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_lrn_refusals_and_bound():
    with pytest.raises(ValueError, match="float32"):
        klrn.lrn_forward(torch.zeros(2, 4, dtype=torch.float64), 1e-4,
                         0.75, 2.0, 5)
    with pytest.raises(ValueError, match="match"):
        klrn.lrn_backward(torch.zeros(2, 4), torch.zeros(2, 5), 1e-4, 0.75,
                          2.0, 5)
    fwd = klrn.bound((128, 55, 55, 96), 5)
    bwd = klrn.bound((128, 55, 55, 96), 5, backward=True)
    assert fwd["bound_by"] == bwd["bound_by"] == "bytes"
    assert abs(fwd["bound_ms"] - 0.0888) < 1e-3
    assert abs(bwd["bound_ms"] - 0.1331) < 1e-3


@pytest.mark.parametrize("c", [96, 256, 128])
def test_lrn_plan_takes_four_channels_a_thread(c):
    """AlexNet's norm widths and run_parity's take the quad path in both
    directions: whole rows a block of about 256 threads, x (the forward)
    or x and t (the backward) of its rows in shared memory, AlexNet's
    window unrolled."""
    x = torch.zeros(3, c)
    for backward, arrays in ((True, 2), (False, 1)):
        plan = klrn.lrn_plan(3, c, 5, 0.75, klrn.aligned16(x, x),
                             backward=backward)
        tx, ty = plan["threads"]
        assert plan["path"] == "quad" and tx == c // 4
        assert ty == plan["rows_per_block"] and \
            tx * ty <= 256 < tx * (ty + 1)
        assert plan["smem_bytes"] == arrays * ty * c * 4
        assert plan["n_fixed"] == 5
        assert klrn.lrn_plan(3, c, 4, backward=backward)["n_fixed"] == 0
        assert klrn.lrn_plan(3, c, 5, 0.6,
                             backward=backward)["n_fixed"] == 0


@pytest.mark.parametrize("c,offset", [(3, 0), (5, 0), (96, 1), (128, 2)])
def test_lrn_plan_element_path(c, offset):
    """c % 4 != 0, or a storage offset that moves x off 16 bytes, takes
    the one-element kernel in both directions: x of its rows staged
    forward, x, d^-beta and t backward."""
    store = torch.zeros(4 * c + offset)
    x = store[offset:].view(4, c)
    assert klrn.aligned16(x) == (offset * 4 % 16 == 0)
    for backward, arrays in ((True, 3), (False, 1)):
        plan = klrn.lrn_plan(4, c, 5, 0.75,
                             klrn.aligned16(x, torch.zeros(c)),
                             backward=backward)
        assert plan["path"] == "element" and plan["threads"] == (256, 1)
        assert plan["rows_per_block"] == 2048 // c
        assert plan["smem_bytes"] == arrays * (2048 // c) * c * 4


@pytest.mark.parametrize("n", [5, 4])
@pytest.mark.parametrize("shape", [(2, 5, 4, 24), (3, 7, 5)])
def test_lrn_function_gradient_is_the_plain_backward(n, shape):
    """``kernels/lrn.py lrn``'s forward is the plain forward and its
    gradient the plain backward at x, bit for bit, on a cotangent that
    reaches it non-contiguous; no launch is counted on the CPU."""
    rng = np.random.default_rng(n)
    args = (1e-2, 0.75, 2.0, n)
    x = torch.tensor((rng.normal(size=shape) * 3).astype(np.float32),
                     requires_grad=True)
    e = torch.tensor(rng.normal(size=shape[::-1]).astype(np.float32)).t() \
        if len(shape) == 2 else torch.tensor(
            rng.normal(size=shape).astype(np.float32))
    before = (klrn.fwd_launches, klrn.bwd_launches)
    y = klrn.lrn.apply(x, *args)
    (dx,) = torch.autograd.grad(y, x, e)
    assert (klrn.fwd_launches, klrn.bwd_launches) == before
    xd = x.detach()
    assert torch.equal(y.detach(), klrn.lrn_forward_plain(xd, *args))
    assert torch.equal(dx, klrn.lrn_backward_plain(xd, e.contiguous(),
                                                   *args))


def test_lrn_function_saves_x_only():
    """The memory of the reference's ``jax.checkpoint``: the graph keeps
    the input and no intermediate of the window sums."""
    x = torch.rand((4, 6, 8), requires_grad=True)
    y = klrn.lrn.apply(x, 1e-4, 0.75, 2.0, 5)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].data_ptr() == x.data_ptr()


@pytest.mark.parametrize("ratio", [0.5, 0.4, 0.1, 0.0])
def test_dropout_plain_matches_pallas(ratio):
    rng = np.random.default_rng(int(ratio * 10))
    x = rng.normal(size=(6, 5, 40)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, x.shape, dtype=np.uint32)
    y_j, m_j = j_dropout_forward(jnp.asarray(x), 0, ratio,
                                 bits=jnp.asarray(bits), interpret=True)
    before = kdrop.launches
    y, m = kdrop.dropout_forward(torch.tensor(x), ratio,
                                 bits=torch.from_numpy(bits))
    assert kdrop.launches == before
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    assert m.dtype == torch.float32


@pytest.mark.parametrize("ratio", [0.5, 0.3])
def test_dropout_bf16_plain_matches_pallas(ratio):
    """bf16 x: the TPU kernel's mask is the f32 scale cast to bf16 and y
    the bf16 product; the plain version takes the same rule."""
    rng = np.random.default_rng(int(ratio * 10) + 7)
    x = rng.normal(size=(4, 9, 40)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, x.shape, dtype=np.uint32)
    y_j, m_j = j_dropout_forward(jnp.asarray(x, jnp.bfloat16), 0, ratio,
                                 bits=jnp.asarray(bits), interpret=True)
    y, m = kdrop.dropout_forward(torch.tensor(x).to(torch.bfloat16), ratio,
                                 bits=torch.from_numpy(bits))
    assert y.dtype == m.dtype == torch.bfloat16
    assert y_j.dtype == m_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(y_j, np.float32))
    np.testing.assert_array_equal(m.float().numpy(),
                                  np.asarray(m_j, np.float32))
    # the scale 1 / (1 - 0.3) is not a bf16 value: the mask rounds it
    kept = m.float().numpy()[m.float().numpy() > 0]
    assert set(kept.tolist()) == {float(torch.tensor(
        kdrop.scale(ratio)).to(torch.bfloat16))}


@pytest.mark.parametrize("n,dtype", [
    (128 * 9216, torch.float32), (128 * 9216, torch.bfloat16),
    (8192 * 8192, torch.float32), (8192 * 8192, torch.bfloat16)])
def test_dropout_plan_at_the_smoke_shapes(n, dtype):
    """The vector path at AlexNet's fc6 input and at 64 M elements: one
    16-byte group (4 f32 or 8 bf16 elements) a thread and one block a 256
    groups."""
    per = 4 if dtype == torch.float32 else 8
    groups = n // per
    assert kdrop.dropout_plan(n, dtype, True) == {
        "path": "vector", "blocks": -(-groups // 256), "threads": 256}


@pytest.mark.parametrize("n,dtype,aligned", [
    (7007, torch.float32, True), (1004, torch.bfloat16, True),
    (128 * 9216, torch.float32, False), (3, torch.bfloat16, True)])
def test_dropout_plan_element_path(n, dtype, aligned):
    """An n that fills no whole group (n % 4 != 0 in f32, n % 8 != 0 in
    bf16) or an operand off 16 bytes: one element a thread, one block a
    256 elements."""
    assert kdrop.dropout_plan(n, dtype, aligned) == {
        "path": "element", "threads": 256, "blocks": -(-n // 256)}


def test_dropout_seed_draw():
    x = torch.randn(512, 256)
    y, m = kdrop.dropout_forward(x, 0.25, seed=4)
    y2, m2 = kdrop.dropout_forward(x, 0.25, seed=4)
    assert torch.equal(y, y2) and torch.equal(m, m2)
    assert set(torch.unique(m).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs(float((m == 0).double().mean()) - 0.25) < 0.01
    assert torch.equal(y, x * m)
    _, m3 = kdrop.dropout_forward(x, 0.25, seed=5)
    assert not torch.equal(m, m3)
    # the mask in x's dtype
    yb, mb = kdrop.dropout_forward(x.to(torch.bfloat16), 0.25, seed=4)
    assert mb.dtype == torch.bfloat16 and torch.equal(mb, m.bfloat16())


def test_dropout_refusals_and_bound():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="exactly one"):
        kdrop.dropout_forward(x, 0.5)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        kdrop.dropout_forward(x, 1.0, seed=1)
    with pytest.raises(ValueError, match="bits must be"):
        kdrop.dropout_forward(x, 0.5, bits=torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint32"):
        kdrop.dropout_forward(x, 0.5, bits=torch.zeros(4, 4))
    assert kdrop.threshold(0.5) == 2147483647
    assert kdrop.threshold(0.0) == 0
    b = kdrop.bound(1 << 26)
    assert b["bytes"] == 12 << 26 and b["bound_by"] == "bytes"
    assert kdrop.bound(1 << 26, dtype=torch.bfloat16)["bytes"] == 6 << 26
    assert kdrop.bound(1 << 26, with_bits=True)["bytes"] == 16 << 26


# -- the kernel-layer check -------------------------------------------------

def test_run_parity_cpu_holds_every_plain_version():
    results = kernel_hw.run_parity("cpu")
    # the reference's families, every one named
    ref_names = {"sgd", "adam", "dropout", "lrn", "fc_gemm", "conv_fwd",
                 "conv_bwd", "deconv", "stochastic_pool", "kohonen",
                 "flash_attention", "conv_fwd_bf16", "flash_attention_bf16",
                 "sgd_bf16state"}
    assert set(results) == ref_names
    for name, verdict in results.items():
        if name in kernel_hw.NOT_PORTED:
            assert verdict.startswith("not ported: ROADMAP"), (name, verdict)
        else:
            assert verdict == "ok", (name, verdict)


def test_run_parity_reports_a_broken_plain_version(monkeypatch):
    """A plain version that is wrong gives FAIL, and the sweep finishes."""
    plain = ksom.som_step_plain

    def other_winners(*args):
        w, idx = plain(*args)
        return w, (idx + 1) % w.shape[0]

    monkeypatch.setattr(ksom, "som_step_plain", other_winners)
    monkeypatch.setattr(klrn, "lrn_backward_plain",
                        lambda x, e, *a: torch.zeros_like(x))
    results = kernel_hw.run_parity("cpu")
    assert results["kohonen"].startswith("FAIL")
    assert results["lrn"].startswith("FAIL")
    assert results["sgd"] == results["flash_attention"] == "ok"


def test_run_parity_names_the_reference_families():
    """The port's sweep and the reference's name the same families (the
    reference's run in interpret mode is its own test's business)."""
    import inspect

    src = inspect.getsource(pallas_hw.run_parity)
    for name in kernel_hw.run_parity("cpu"):
        assert f'"{name}"' in src, name


@pytest.mark.cuda
def test_lrn_and_dropout_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(64, 13, 13, 96, device="cuda") * 3
    e = torch.randn_like(x)
    args = (1e-4, 0.75, 2.0, 5)
    assert torch.equal(klrn.lrn_forward(x, *args),
                       klrn.lrn_forward_plain(x, *args))
    assert torch.equal(klrn.lrn_backward(x, e, *args),
                       klrn.lrn_backward_plain(x, e, *args))
    for backward in (True, False):
        assert klrn.lrn_plan(x.numel() // 96, 96, 5, 0.75,
                             klrn.aligned16(x, e),
                             backward=backward)["path"] == "quad"
    x5, e5 = x[..., :5].contiguous(), e[..., :5].contiguous()
    assert klrn.lrn_plan(x5.numel() // 5, 5, 5)["path"] == "element"
    assert torch.equal(klrn.lrn_forward(x5, *args),
                       klrn.lrn_forward_plain(x5, *args))
    assert torch.equal(klrn.lrn_backward(x5, e5, *args),
                       klrn.lrn_backward_plain(x5, e5, *args))
    store = torch.randn(x.numel() + 1, device="cuda")
    xu = store[1:].view(x.shape)          # off 16 bytes: the element path
    assert torch.equal(klrn.lrn_forward(xu, *args),
                       klrn.lrn_forward_plain(xu, *args))
    for n in (3, 4):     # the quad path with n at run time
        assert torch.equal(klrn.lrn_forward(x, 1e-4, 0.75, 2.0, n),
                           klrn.lrn_forward_plain(x, 1e-4, 0.75, 2.0, n))
        assert torch.equal(klrn.lrn_backward(x, e, 1e-4, 0.75, 2.0, n),
                           klrn.lrn_backward_plain(x, e, 1e-4, 0.75, 2.0,
                                                   n))
    xg = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(klrn.lrn.apply(xg, *args), xg, e)
    assert torch.equal(dx, klrn.lrn_backward_plain(x, e, *args))
    y, m = kdrop.dropout_forward(x, 0.5, seed=3)
    words = kdrop.counter_rng.random_bits(3, x.numel(), "cuda")
    y_p, m_p = kdrop.dropout_forward_plain(x, 0.5, words)
    torch.cuda.synchronize()
    assert torch.equal(y, y_p) and torch.equal(m, m_p)
    results = kernel_hw.run_parity("cuda")
    assert all(v == "ok" for k, v in results.items()
               if k not in kernel_hw.NOT_PORTED), results


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_bf16_and_element_path_on_the_card(dtype):
    """The kernel bit for bit against its plain version on the vector
    path and on the element path (n % 8 != 0; x one element off 16
    bytes), from a seed and from bits=."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for shape, offset in (((128, 9216), 0), ((1001, 7), 0),
                          ((128, 9216), 1)):
        n = int(np.prod(shape))
        x = (torch.randn(n + offset, device="cuda") * 2).to(dtype)[
            offset:].view(shape)
        words = kdrop.counter_rng.random_bits(5, n, "cuda")
        want = kdrop.dropout_forward_plain(x, 0.4, words)
        before = kdrop.launches
        got = kdrop.dropout_forward(x, 0.4, seed=5)
        bits = words.to(torch.int64).view(shape).to(torch.uint32) \
            if hasattr(torch, "uint32") else None
        torch.cuda.synchronize()
        assert kdrop.launches == before + 1
        assert got[0].dtype == got[1].dtype == dtype
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if bits is not None:
            gb = kdrop.dropout_forward(x, 0.4, bits=bits.contiguous())
            assert torch.equal(gb[0], want[0]) and torch.equal(gb[1],
                                                               want[1])
