"""Fully-connected forward units — the port of
``znicz_tpu/units/all2all.py`` (rebuild of veles.znicz all2all.py ::
All2All, All2AllTanh, All2AllRELU, All2AllStrictRELU, All2AllSigmoid,
All2AllSoftmax).

y = act(x·W + b).  On a ``TorchDevice`` the units with a fused
activation run the ``gemm_fc`` kernel with bias and activation in its
epilogue (``kernels/gemm.py``; the reference's route under
``root.common.engine.pallas`` — the port has no switch), and
``All2AllSoftmax`` stays plain torch, as the reference keeps it on XLA.
The Softmax variant also emits ``max_idx`` per row for EvaluatorSoftmax.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.kernels import gemm as kgemm
from znicz_tpu_torch.ops import activations, linear
from znicz_tpu_torch.units.nn_units import Forward


class All2All(Forward):
    """Linear fully-connected layer (reference: all2all.py :: All2All)."""

    MAPPING = {"all2all"}
    ACTIVATION = activations.LINEAR

    def __init__(self, workflow=None, output_sample_shape=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if output_sample_shape is None:
            raise ValueError("All2All requires output_sample_shape")
        self.output_sample_shape = (
            (output_sample_shape,) if isinstance(output_sample_shape, int)
            else tuple(output_sample_shape))

    # -- shapes -------------------------------------------------------------
    @property
    def n_input(self) -> int:
        return int(np.prod(self.input.shape[1:]))

    @property
    def n_output(self) -> int:
        return int(np.prod(self.output_sample_shape))

    def _common_init(self, **kwargs) -> None:
        batch = self.input.shape[0]
        self.init_weights(self.n_input, self.n_output)
        if not self.output or self.output.shape[0] != batch:
            self.output.reset(shape=(batch,) + self.output_sample_shape)
        self.init_array(self.input, self.output, self.weights, self.bias)

    # -- weights view (honoring weights_transposed on the stored layout) ----
    def _w(self, xp):
        if xp is np:
            w = self.weights.mem
            return w.T if self.weights_transposed else w
        w = self.weights.devmem
        return w.t() if self.weights_transposed else w

    def _b(self, xp):
        if not self.include_bias:
            return None
        return self.bias.mem if xp is np else self.bias.devmem

    # -- fused-step protocol (parallel/step.py) -----------------------------
    def param_arrays(self) -> dict:
        """Trainable Arrays contributed to the fused step's params."""
        out = {"w": self.weights}
        if self.include_bias:
            out["b"] = self.bias
        return out

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        """The forward in torch over a params leaf-dict (the fused step's
        products are plain torch matmuls, as the reference's are XLA
        dots)."""
        return activations.forward(torch, self.ACTIVATION,
                                   self.torch_apply_linear(p, x))

    def torch_apply_linear(self, p: dict, x):
        """Pre-activation part only (the fused softmax+CE path composes
        log_softmax into the loss)."""
        w = p["w"].t() if self.weights_transposed else p["w"]
        return linear.forward(torch, x, w, p.get("b"), activations.LINEAR)

    # -- compute ------------------------------------------------------------
    def numpy_run(self) -> None:
        out = linear.forward(np, self.input.mem, self._w(np), self._b(np),
                             self.ACTIVATION)
        self.output.map_invalidate()
        self.output.mem = out.reshape((-1,) + self.output_sample_shape)

    def torch_run(self) -> None:
        self.input.unmap()
        out = kgemm.fc_forward(self.input.devmem, self._w(torch),
                               self._b(torch), self.ACTIVATION)
        self.output.set_devmem(out.reshape((-1,) + self.output_sample_shape))


class All2AllTanh(All2All):
    """FC + LeCun-scaled tanh (reference: All2AllTanh)."""
    MAPPING = {"all2all_tanh"}
    ACTIVATION = activations.TANH


class All2AllRELU(All2All):
    """FC + soft ReLU log(1+e^x) (reference: All2AllRELU)."""
    MAPPING = {"all2all_relu"}
    ACTIVATION = activations.RELU


class All2AllStrictRELU(All2All):
    """FC + max(0, x) (reference: All2AllStrictRELU)."""
    MAPPING = {"all2all_str"}
    ACTIVATION = activations.STRICT_RELU


class All2AllSigmoid(All2All):
    """FC + logistic sigmoid (reference: All2AllSigmoid)."""
    MAPPING = {"all2all_sigmoid"}
    ACTIVATION = activations.SIGMOID


class All2AllSoftmax(All2All):
    """FC + softmax, emitting per-row argmax into ``max_idx``
    (reference: All2AllSoftmax with apply_exp kernel).  Plain torch on the
    device, as the reference keeps it on XLA."""

    MAPPING = {"softmax"}
    ACTIVATION = "softmax"

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.max_idx = Array()

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        return torch.softmax(self.torch_apply_linear(p, x), dim=1)

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        if not self.max_idx or self.max_idx.shape[0] != self.output.shape[0]:
            self.max_idx.reset(shape=(self.output.shape[0],), dtype=np.int32)
        self.init_array(self.max_idx)

    def numpy_run(self) -> None:
        y, idx = linear.softmax_forward(np, self.input.mem, self._w(np),
                                        self._b(np))
        self.output.map_invalidate()
        self.output.mem = y.reshape((-1,) + self.output_sample_shape)
        self.max_idx.map_invalidate()
        self.max_idx.mem = idx.astype(np.int32)

    def torch_run(self) -> None:
        self.input.unmap()
        y, idx = linear.softmax_forward(torch, self.input.devmem,
                                        self._w(torch), self._b(torch))
        self.output.set_devmem(y.reshape((-1,) + self.output_sample_shape))
        self.max_idx.set_devmem(idx.to(torch.int32))
