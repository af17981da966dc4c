"""Convolutional forward units — the port of ``znicz_tpu/units/conv.py``
(rebuild of veles.znicz conv.py :: Conv, ConvTanh, ConvRELU,
ConvStrictRELU, ConvSigmoid).

NHWC activations, HWIO weights, arbitrary ``kx/ky``, ``sliding`` stride
and 4-tuple ``padding`` — the reference's geometry.  On a ``TorchDevice``
``torch_run`` launches the ``conv2d_fwd`` kernel with the bias in its
epilogue (``kernels/conv.py``; the reference's route under
``root.common.engine.pallas`` — the port has no switch) and applies the
activation in plain torch, as the reference does around its kernel.  The
fused step's ``torch_apply`` is plain torch (``F.conv2d``: cuDNN on the
card), as the reference's ``xla_apply`` is ``lax.conv`` and not its
Pallas kernel.

Weight init follows the reference: uniform/gaussian via the framework
PRNG, plus the optional ``weights_filling="gabor"`` bank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.kernels import conv as kconv
from znicz_tpu_torch.ops import activations, conv as conv_ops
from znicz_tpu_torch.units.nn_units import Forward


def gabor_bank(ky: int, kx: int, c_in: int, n_kernels: int) -> np.ndarray:
    """Deterministic Gabor-filter bank (reference: conv.py gabor filling) —
    orientations x phases cycled across kernels, PRNG-jittered wavelength."""
    gen = prng.get()
    yy, xx = np.meshgrid(np.linspace(-1, 1, ky), np.linspace(-1, 1, kx),
                         indexing="ij")
    bank = np.empty((ky, kx, c_in, n_kernels), np.float32)
    for k in range(n_kernels):
        theta = np.pi * k / max(n_kernels, 1)
        lam = 0.8 + 0.4 * float(gen.uniform(0.0, 1.0, (1,))[0])
        psi = 0.0 if k % 2 == 0 else np.pi / 2
        xr = xx * np.cos(theta) + yy * np.sin(theta)
        yr = -xx * np.sin(theta) + yy * np.cos(theta)
        g = np.exp(-(xr ** 2 + 0.5 * yr ** 2) / 0.3) * \
            np.cos(2 * np.pi * xr / lam + psi)
        bank[:, :, :, k] = g[:, :, None] / max(np.abs(g).max(), 1e-6)
    return bank * 0.1


def conv2d_nhwc(x, w, b, sliding, padding):
    """NHWC ``x`` * HWIO ``w`` (+ ``b``) through ``F.conv2d`` on the
    channels-last view, the reference's geometry; an asymmetric pad is
    applied by ``F.pad`` first.  Differentiable (the fused step's
    autograd)."""
    ky, kx, sy, sx, pt, pb, pl, pr = conv_ops.normalize_geometry(
        w.shape[1], w.shape[0], sliding, padding)
    pad = (pt, pl)
    if (pt, pl) != (pb, pr):
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pad = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                 stride=(sy, sx), padding=pad)
    return y.permute(0, 2, 3, 1)


class Conv(Forward):
    """Linear convolution (reference: conv.py :: Conv)."""

    MAPPING = {"conv"}
    ACTIVATION = activations.LINEAR

    def __init__(self, workflow=None, n_kernels=None, kx=None, ky=None,
                 sliding=(1, 1), padding=(0, 0, 0, 0), **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if None in (n_kernels, kx, ky):
            raise ValueError("Conv requires n_kernels, kx, ky")
        self.n_kernels = int(n_kernels)
        self.kx, self.ky = int(kx), int(ky)
        self.sliding = sliding
        self.padding = padding

    # -- shapes -------------------------------------------------------------
    def output_shape_for(self, in_shape):
        n, h, w, _ = in_shape
        ky, kx, sy, sx, pt, pb, pl, pr = conv_ops.normalize_geometry(
            self.kx, self.ky, self.sliding, self.padding)
        return (n, conv_ops.out_size(h, ky, sy, pt, pb),
                conv_ops.out_size(w, kx, sx, pl, pr), self.n_kernels)

    def _common_init(self, **kwargs) -> None:
        in_shape = self.input.shape
        if len(in_shape) != 4:
            raise ValueError(f"Conv wants NHWC input, got {in_shape}")
        c_in = in_shape[3]
        if not self.weights:
            if self.weights_filling == "gabor":
                self.weights.mem = gabor_bank(self.ky, self.kx, c_in,
                                              self.n_kernels)
            else:
                # fan-in scaling, no 0.05 cap — see nn_units.init_weights
                fan_in = self.kx * self.ky * c_in
                stddev = self.weights_stddev or 1.0 / np.sqrt(fan_in)
                self.weights.mem = self._fill(
                    (self.ky, self.kx, c_in, self.n_kernels),
                    self.weights_filling, stddev)
        if self.include_bias and not self.bias:
            self.bias.mem = self._fill((self.n_kernels,), self.bias_filling,
                                       self.bias_stddev or 0.01)
        out_shape = self.output_shape_for(in_shape)
        if not self.output or self.output.shape != out_shape:
            self.output.reset(shape=out_shape)
        self.init_array(self.input, self.output, self.weights, self.bias)

    # -- fused-step protocol ------------------------------------------------
    def param_arrays(self) -> dict:
        out = {"w": self.weights}
        if self.include_bias:
            out["b"] = self.bias
        return out

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        return activations.forward(
            torch, self.ACTIVATION,
            conv2d_nhwc(x, p["w"], p.get("b"), self.sliding, self.padding))

    # -- compute ------------------------------------------------------------
    def numpy_run(self) -> None:
        out = conv_ops.forward(np, self.input.mem, self.weights.mem,
                               self.bias.mem if self.include_bias else None,
                               self.sliding, self.padding, self.ACTIVATION)
        self.output.map_invalidate()
        self.output.mem = out

    def torch_run(self) -> None:
        self.input.unmap()
        v = kconv.conv2d_fwd(
            self.input.devmem.contiguous(), self.weights.devmem,
            self.bias.devmem if self.include_bias else None, self.sliding,
            self.padding)
        self.output.set_devmem(activations.forward(torch, self.ACTIVATION,
                                                   v))


class ConvTanh(Conv):
    """Conv + LeCun tanh (reference: ConvTanh)."""
    MAPPING = {"conv_tanh"}
    ACTIVATION = activations.TANH


class ConvRELU(Conv):
    """Conv + soft ReLU log(1+e^x) (reference: ConvRELU)."""
    MAPPING = {"conv_relu"}
    ACTIVATION = activations.RELU


class ConvStrictRELU(Conv):
    """Conv + max(0, x) (reference: ConvStrictRELU)."""
    MAPPING = {"conv_str"}
    ACTIVATION = activations.STRICT_RELU


class ConvSigmoid(Conv):
    """Conv + logistic sigmoid."""
    MAPPING = {"conv_sigmoid"}
    ACTIVATION = activations.SIGMOID
