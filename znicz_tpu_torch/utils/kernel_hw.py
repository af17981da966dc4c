"""The kernel layer's parity sweep in one call — the port of
``znicz_tpu/utils/pallas_hw.py run_parity``: every kernel family of the
port executed against an oracle at the reference's sweep shapes and bands,
so one run on the card checks the whole kernel layer.

``run_parity(device)`` returns ``{family: "ok" | "FAIL: ..."}`` with the
reference's family names, all fourteen of them.  Inputs are made from
a seeded numpy generator and moved to ``device``; each family calls the
port's kernel wrapper there (the kernel on ``cuda``, its plain version on
``cpu``) and compares with an oracle on the CPU: the numpy code the port
copies from the reference (``ops/``) where it has one, the plain-torch
reference ops otherwise (attention), so on the CPU the sweep holds each
plain version against the reference's arithmetic.  Nothing is skipped,
on either device; a failure is caught and reported (a sweep must finish),
never hidden.
"""

from __future__ import annotations

import numpy as np
import torch

#: families the port has no counterpart for: none (every family of the
#: reference has one since the deconv pair and the bf16 conv forward)
NOT_PORTED: dict = {}


def _close(got, want, rtol, atol, what=""):
    got = got.detach().float().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    want = want.detach().float().cpu().numpy() if torch.is_tensor(want) \
        else np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _check(name, fn, results) -> None:
    try:
        fn()
        results[name] = "ok"
    except Exception as exc:  # noqa: BLE001 — a sweep must finish
        results[name] = f"FAIL: {exc!r}"[:300]


def run_parity(device="cuda") -> dict:
    """Run every family on ``device`` ("cuda" or "cpu") -> the results."""
    from znicz_tpu_torch.core.backends import device as resolve_device
    from znicz_tpu_torch.kernels import (conv as kconv, counter_rng,
                                         dropout as kdrop,
                                         flash_attention as kflash,
                                         gemm as kgemm, kohonen as ksom,
                                         lrn as klrn, optim as koptim,
                                         pooling as kpool)
    from znicz_tpu_torch.ops import (activations, adam as adam_ops,
                                     attention as att, conv as conv_ops,
                                     deconv as deconv_ops,
                                     kohonen as k_ops, linear as lin_ops,
                                     lrn as lrn_ops, pooling as pool_ops,
                                     sgd as sgd_ops)

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    results: dict = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)

    def on(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def sgd(vel_dtype=torch.float32):
        w = rng.normal(size=(256, 256)).astype(np.float32)
        g = rng.normal(size=(256, 256)).astype(np.float32)
        v = np.zeros((256, 256), np.float32) if vel_dtype == torch.float32 \
            else (rng.normal(size=(256, 256)) * 0.1).astype(np.float32)
        args = (0.05, 1e-3, 0.3, 0.9, 32.0)
        v_dev = on(v, vel_dtype)
        v_in = v_dev.float().cpu().numpy()      # the bf16-rounded start
        w_ref, v_ref = sgd_ops.update(np, w, g, v_in, *args)
        w_k, v_k = on(w), v_dev
        koptim.sgd_update_(w_k, on(g), v_k, *(scalar(a) for a in args))
        if v_k.dtype != vel_dtype:
            raise AssertionError(f"velocity came back {v_k.dtype}")
        _close(w_k, w_ref, 1e-5, 1e-6, "w")
        want_v = torch.tensor(v_ref).to(vel_dtype).float()
        _close(v_k, want_v, 1e-5, 1e-6, "vel")

    def adam():
        w = rng.normal(size=(256, 256)).astype(np.float32)
        g = rng.normal(size=(256, 256)).astype(np.float32)
        m = np.zeros((256, 256), np.float32)
        v = np.zeros((256, 256), np.float32)
        t, lr, wd, b1, b2, eps, bs = 3.0, 0.01, 0.001, 0.9, 0.999, 1e-8, 32.0
        refs = adam_ops.update(np, w, g, m, v, t, lr, wd, b1, b2, eps, bs)
        outs = (on(w), on(g), on(m), on(v))
        koptim.adam_update_(outs[0], outs[1], outs[2], outs[3], scalar(lr),
                            scalar(wd), scalar(b1), scalar(b2), scalar(eps),
                            scalar(1.0 - b1 ** t), scalar(1.0 - b2 ** t),
                            scalar(bs))
        for got, want, what in zip((outs[0], outs[2], outs[3]), refs,
                                   ("w", "m", "v")):
            _close(got, want, 1e-5, 1e-6, what)

    def dropout():
        x = rng.normal(size=(256, 256)).astype(np.float32)
        ratio = 0.4
        y, mask = kdrop.dropout_forward(on(x), ratio, seed=7)
        scale = np.float32(1.0 / (1.0 - ratio))
        m = mask.cpu().numpy()
        if not set(np.unique(m)) <= {np.float32(0.0), scale}:
            raise AssertionError(f"mask values {np.unique(m)[:5]}")
        np.testing.assert_array_equal(y.cpu().numpy(), x * m)
        words = counter_rng.random_bits(7, x.size).numpy()
        want = np.where(words.reshape(x.shape) > kdrop.threshold(ratio),
                        scale, np.float32(0.0))
        np.testing.assert_array_equal(m, want)   # the generator's bits
        rate = float((m == 0).mean())
        if abs(rate - ratio) >= 0.05:
            raise AssertionError(f"drop rate {rate}")
        bits = rng.integers(0, 2 ** 32, x.shape, dtype=np.uint32)
        yb, mb = kdrop.dropout_forward(
            on(x), ratio, bits=torch.from_numpy(bits).to(dev))
        want = np.where(bits > kdrop.threshold(ratio), scale,
                        np.float32(0.0))
        np.testing.assert_array_equal(mb.cpu().numpy(), want)
        np.testing.assert_array_equal(yb.cpu().numpy(), x * want)

    def lrn():
        x = rng.normal(size=(4, 8, 8, 128)).astype(np.float32)
        err = rng.normal(size=x.shape).astype(np.float32)
        args = (1e-4, 0.75, 2.0, 5)
        _close(klrn.lrn_forward(on(x), *args),
               lrn_ops.forward(np, x, *args), 1e-4, 1e-5, "y")
        _close(klrn.lrn_backward(on(x), on(err), *args),
               lrn_ops.backward(np, x, err, *args), 1e-3, 1e-4, "err_input")

    def fc_gemm():
        x = rng.normal(size=(64, 256)).astype(np.float32)
        w = (rng.normal(size=(256, 128)) * 0.05).astype(np.float32)
        b = rng.normal(size=(128,)).astype(np.float32)
        y_ref = lin_ops.forward(np, x, w, b, activations.TANH)
        y = kgemm.fc_forward(on(x), on(w), on(b), activations.TANH)
        _close(y, y_ref, 1e-4, 1e-4, "y")
        e = rng.normal(size=(64, 128)).astype(np.float32)
        refs = lin_ops.backward(np, x, y_ref, w, e, activations.TANH)
        outs = kgemm.fc_backward(on(x), on(y_ref), on(w), on(e),
                                 activations.TANH)
        for got, want, what in zip(outs, refs, ("err_input", "gw", "gb")):
            _close(got, want, 1e-4, 1e-3, what)

    def conv_fwd(dtype=torch.float32, rtol=1e-4, atol=1e-4):
        # one body serves both precisions, as the reference's does; the
        # oracle takes the operands as the kernel sees them (bf16-rounded)
        x, w, b = (on(a, dtype) for a in (
            rng.normal(size=(8, 16, 16, 64)),
            rng.normal(size=(3, 3, 64, 128)) * 0.1, rng.normal(size=(128,))))
        geom = ((1, 1), (1, 1, 1, 1))
        y = kconv.conv2d_fwd(x, w, b, *geom)
        if y.dtype != dtype:
            raise AssertionError(f"y came back {y.dtype}")
        _close(y, conv_ops.forward_linear(
            np, *(a.float().cpu().numpy() for a in (x, w, b)), *geom),
            rtol, atol, "y")

    def conv_bwd():
        x = rng.normal(size=(8, 16, 16, 64)).astype(np.float32)
        w = (rng.normal(size=(3, 3, 64, 128)) * 0.1).astype(np.float32)
        err = rng.normal(size=(8, 8, 8, 128)).astype(np.float32)
        geom = ((2, 2), (1, 1, 1, 1))
        refs = conv_ops.backward(np, x, None, w, err, *geom,
                                 activations.LINEAR,
                                 activation_applied=False)
        outs = kconv.conv2d_backward(on(x), on(w), on(err), *geom)
        for got, want, what in zip(outs, refs, ("err_input", "gw", "gb")):
            _close(got, want, 1e-4, 1e-3, what)

    def deconv():
        x = rng.normal(size=(8, 8, 8, 128)).astype(np.float32)
        w = (rng.normal(size=(4, 4, 64, 128)) * 0.1).astype(np.float32)
        geom = ((2, 2), (1, 1, 1, 1))
        out_shape = deconv_ops.output_shape_for(x.shape, w.shape, *geom)
        _close(kconv.deconv2d(on(x), on(w), *geom, out_shape),
               deconv_ops.forward(np, x, w, *geom, out_shape), 1e-4, 1e-3,
               "y")
        err = rng.normal(size=out_shape).astype(np.float32)
        refs = deconv_ops.backward(np, x, w, err, *geom)
        outs = kconv.deconv2d_backward(on(x), on(w), on(err), *geom)
        for got, want, what in zip(outs, refs, ("err_input", "gw")):
            _close(got, want, 1e-4, 1e-3, what)

    def stochastic_pool():
        x = rng.normal(size=(4, 16, 16, 128)).astype(np.float32)
        y, off = kpool.stochastic_pool(on(x), 2, 2, 2, 2, seed=5)
        y, off = y.cpu().numpy(), off.cpu().numpy()
        n, oh, ow, c = y.shape
        flat = x.reshape(n, -1, c)
        picked = np.take_along_axis(flat, off.reshape(n, -1, c).astype(
            np.int64), axis=1).reshape(y.shape)
        np.testing.assert_array_equal(y, picked)
        words = counter_rng.random_bits(5, y.size)
        u = counter_rng.uniform24(words).numpy().reshape(y.shape)
        y_ref, off_ref = pool_ops.stochastic_forward(np, x, 2, 2, 2, 2, u,
                                                     False, train=True)
        np.testing.assert_array_equal(y, y_ref)
        np.testing.assert_array_equal(off, off_ref)

    def kohonen():
        x = rng.normal(size=(64, 128)).astype(np.float32)
        w = rng.normal(size=(256, 128)).astype(np.float32)
        coords = np.asarray(k_ops.grid_coords(np, 16, 16))
        w_ref, idx_ref = k_ops.update(np, x, w, coords, 0.3, 1.5, None)
        w_k, idx = ksom.som_step(on(x), on(w), on(coords), 0.3, 1.5, 64)
        _close(w_k, w_ref, 1e-3, 1e-4, "weights")
        np.testing.assert_array_equal(idx.cpu().numpy(), idx_ref)

    def flash_attention(dtype=torch.float32, rtol=2e-4, atol=2e-4,
                        grad_rtol=2e-3, grad_atol=2e-3):
        b, t, h, dh = 2, 512, 2, 128
        qkv = [rng.normal(size=(b, t, h, dh)).astype(np.float32)
               for _ in range(3)]
        cpu = [torch.tensor(a, dtype=dtype) for a in qkv]
        for causal in (False, True):
            _close(kflash.flash_attention(*(on(a, dtype) for a in qkv),
                                          causal=causal),
                   att.attention(*cpu, causal=causal), rtol, atol,
                   f"o causal={causal}")
        leaves = [on(a, dtype).requires_grad_() for a in qkv]
        kflash.flash_attention(*leaves, causal=True).float().sum().backward()
        ref = [a.clone().requires_grad_() for a in cpu]
        att.attention(*ref, causal=True).float().sum().backward()
        for got, want, what in zip(leaves, ref, ("dq", "dk", "dv")):
            _close(got.grad, want.grad, grad_rtol, grad_atol, what)

    def conv_fwd_bf16():
        conv_fwd(torch.bfloat16, rtol=5e-2, atol=5e-1)

    def flash_attention_bf16():
        flash_attention(torch.bfloat16, rtol=5e-2, atol=5e-2,
                        grad_rtol=1e-1, grad_atol=5e-1)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, fn in (("sgd", sgd), ("adam", adam), ("dropout", dropout),
                         ("lrn", lrn), ("fc_gemm", fc_gemm),
                         ("conv_fwd", conv_fwd), ("conv_bwd", conv_bwd),
                         ("deconv", deconv),
                         ("stochastic_pool", stochastic_pool),
                         ("kohonen", kohonen),
                         ("flash_attention", flash_attention),
                         ("conv_fwd_bf16", conv_fwd_bf16),
                         ("flash_attention_bf16", flash_attention_bf16),
                         ("sgd_bf16state",
                          lambda: sgd(vel_dtype=torch.bfloat16))):
            _check(name, fn, results)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return results
