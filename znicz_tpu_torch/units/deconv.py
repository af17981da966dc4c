"""Deconvolution forward unit — the port of ``znicz_tpu/units/deconv.py``
(rebuild of veles.znicz deconv.py :: Deconv).

Transposed conv for autoencoders: input has the paired Conv's output shape
``(n, oh, ow, n_kernels)``, output its input shape ``(n, h, w, c)``.
Two usage modes (both in the reference's AE samples):

- ``link_conv_attrs(conv)``: tie geometry AND weights to an existing Conv
  (classic tied-weight autoencoder; eager shape only — the fused step
  requires each forward to own its params);
- standalone: pass ``n_kernels/kx/ky/n_channels`` and the unit owns its
  weights (StandardWorkflow's "deconv" layer type).

No bias (reference: Deconv carries none).  On a ``TorchDevice``
``torch_run`` launches the ``deconv2d`` kernel (``kernels/conv.py``; the
reference's route under ``root.common.engine.pallas`` — the port has no
switch).  The fused step's ``torch_apply`` is plain torch
(``ops/deconv.py``), as the reference's ``xla_apply`` is XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.kernels import conv as kconv
from znicz_tpu_torch.ops import deconv as deconv_ops
from znicz_tpu_torch.units.nn_units import Forward


class Deconv(Forward):
    """Reference: deconv.py :: Deconv."""

    MAPPING = {"deconv"}

    def __init__(self, workflow=None, n_kernels=None, kx=None, ky=None,
                 n_channels=None, sliding=(1, 1), padding=(0, 0, 0, 0),
                 **kwargs) -> None:
        super().__init__(workflow, include_bias=False, **kwargs)
        if None in (n_kernels, kx, ky):
            raise ValueError("Deconv requires n_kernels, kx, ky")
        self.n_kernels = int(n_kernels)
        self.kx, self.ky = int(kx), int(ky)
        #: output channel count (required unless weights are tied)
        self.n_channels = None if n_channels is None else int(n_channels)
        self.sliding = sliding
        self.padding = padding
        self._tied = False

    def link_conv_attrs(self, conv) -> "Deconv":
        """Tie geometry + weights to the paired Conv (reference helper)."""
        self.n_kernels = conv.n_kernels
        self.kx, self.ky = conv.kx, conv.ky
        self.sliding = conv.sliding
        self.padding = conv.padding
        self.link_attrs(conv, "weights")
        self._tied = True
        return self

    def output_shape_for(self, in_shape):
        return deconv_ops.output_shape_for(
            in_shape, self.weights.shape, self.sliding, self.padding)

    def _common_init(self, **kwargs) -> None:
        in_shape = self.input.shape
        if len(in_shape) != 4:
            raise ValueError(f"Deconv wants NHWC input, got {in_shape}")
        if in_shape[3] != self.n_kernels:
            raise ValueError(f"Deconv input channels {in_shape[3]} != "
                             f"n_kernels {self.n_kernels}")
        if not self.weights:
            if self.n_channels is None:
                raise ValueError("standalone Deconv requires n_channels")
            fan_in = self.kx * self.ky * self.n_kernels
            stddev = self.weights_stddev or 1.0 / np.sqrt(fan_in)
            self.weights.mem = self._fill(
                (self.ky, self.kx, self.n_channels, self.n_kernels),
                self.weights_filling, stddev)
        out_shape = self.output_shape_for(in_shape)
        if not self.output or self.output.shape != out_shape:
            self.output.reset(shape=out_shape)
        self.init_array(self.input, self.output, self.weights)

    # -- fused-step protocol ------------------------------------------------
    def param_arrays(self) -> dict:
        if self._tied:
            raise RuntimeError("tied-weight Deconv is eager-only; give the "
                               "deconv its own weights for the fused step")
        return {"w": self.weights}

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        out_shape = self.output_shape_for(x.shape)
        return deconv_ops.forward(torch, x, p["w"], self.sliding,
                                  self.padding, out_shape)

    # -- compute ------------------------------------------------------------
    def numpy_run(self) -> None:
        self.output.map_invalidate()
        self.output.mem = deconv_ops.forward(
            np, self.input.mem, self.weights.mem, self.sliding, self.padding,
            self.output.shape)

    def torch_run(self) -> None:
        self.input.unmap()
        self.output.set_devmem(kconv.deconv2d(
            self.input.devmem.contiguous(), self.weights.devmem,
            self.sliding, self.padding, self.output.shape))
