"""NN base classes — the port of ``znicz_tpu/units/nn_units.py`` (rebuild
of veles.znicz nn_units.py :: Forward, GradientDescentBase,
MatchingObject, NNWorkflow).

``Forward`` units own weights/bias and map input -> output;
``GradientDescentBase`` units are their hand-paired duals mapping
err_output -> err_input while updating the shared weights.
``MatchingObject`` keeps the fwd<->gd pairing registry.  Weights are
(in, out).  The per-unit ``torch_run`` paths are the eager device path;
the fused step composes the units' ``torch_apply`` instead
(``parallel/step.py``).  :func:`load_forward_params` writes given
weights into forward units before they initialize.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import (AcceleratedUnit,
                                                    AcceleratedWorkflow)
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import activations


class MatchingObject(type):
    """Metaclass keeping the forward<->gradient pairing registry: a class
    declaring ``MAPPING = {"all2all", ...}`` registers as the forward (or,
    for GradientDescentBase descendants, the gradient) unit of those
    names."""

    forwards: dict[str, type] = {}
    gds: dict[str, type] = {}

    def __init__(cls, name, bases, namespace):
        super().__init__(name, bases, namespace)
        mapping = namespace.get("MAPPING")
        if not mapping:
            return
        is_gd = any(getattr(base, "_matching_kind", None) == "gd"
                    or namespace.get("_matching_kind") == "gd"
                    for base in cls.__mro__)
        registry = MatchingObject.gds if is_gd else MatchingObject.forwards
        for key in mapping:
            registry[key] = cls

    @staticmethod
    def gd_for(forward_unit: "Forward") -> type:
        """The gradient class paired with a forward unit's MAPPING name."""
        for key in type(forward_unit).MAPPING:
            gd_cls = MatchingObject.gds.get(key)
            if gd_cls is not None:
                return gd_cls
        raise KeyError(f"no gradient unit registered for {type(forward_unit)}")


class NNLayerBase(AcceleratedUnit, metaclass=MatchingObject):
    """Shared plumbing for forward and gradient units."""

    MAPPING: set = set()


class Forward(NNLayerBase):
    """Base forward unit (reference: nn_units.py :: Forward).

    Data-linked attributes: ``input`` (from the loader or the previous
    forward), ``output`` (allocated here), ``weights`` / ``bias``
    (allocated and filled here, shared with the paired gradient unit).
    """

    _matching_kind = "forward"
    ACTIVATION = activations.LINEAR

    def __init__(self, workflow=None,
                 weights_filling: str = "uniform",
                 weights_stddev: Optional[float] = None,
                 bias_filling: str = "uniform",
                 bias_stddev: Optional[float] = None,
                 include_bias: bool = True,
                 weights_transposed: bool = False,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.weights_filling = weights_filling
        self.weights_stddev = weights_stddev
        self.bias_filling = bias_filling
        self.bias_stddev = bias_stddev
        self.include_bias = include_bias
        self.weights_transposed = weights_transposed
        self.input = Array()
        self.output = Array()
        self.weights = Array()
        self.bias = Array()
        #: inference mode: loader-independent forward pass (reference:
        #: forward_mode — dropout switches off)
        self.forward_mode = False

    # -- weight init (reference: uniform/gaussian via prng) -----------------
    def _fill(self, shape, filling: str, stddev: float) -> np.ndarray:
        gen = prng.get()
        if filling == "uniform":
            bound = stddev * np.sqrt(3.0)  # uniform with this stddev
            return gen.uniform(-bound, bound, shape)
        if filling == "gaussian":
            return gen.normal(0.0, stddev, shape)
        if filling == "constant":
            return np.full(shape, stddev, dtype=np.float32)
        raise ValueError(f"unknown filling {filling!r}")

    # -- fused-step protocol (parallel/step.py) -----------------------------
    def param_arrays(self) -> dict:
        """Trainable Arrays contributed to the fused step's params; paramless
        units return {}."""
        return {}

    def torch_apply(self, p: dict, x, *, rng=None, train=True):
        """The forward in torch over a params leaf-dict, composed by the
        fused step (the reference's ``xla_apply``).  ``rng`` is the
        step's ``torch.Generator``, given to units that set
        ``NEEDS_RNG`` (dropout, stochastic pooling) in train steps."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support the fused step")

    #: class flag: torch_apply consumes a random generator each step
    NEEDS_RNG = False

    def draw_uniform(self, rng, shape, device):
        """Uniforms in [0, 1) of ``shape`` from the fused step's
        generator: the one draw of a ``NEEDS_RNG`` unit's train
        forward."""
        if rng is None:
            raise ValueError(f"{self.name}: a train forward of a "
                             f"NEEDS_RNG unit needs the step's generator")
        return torch.rand(tuple(shape), generator=rng, device=device)

    def init_weights(self, n_input: int, n_output: int) -> None:
        if not self.weights:
            # the reference's default scale: 1/sqrt(fan_in)
            stddev = self.weights_stddev or 1.0 / np.sqrt(n_input)
            shape = ((n_output, n_input) if self.weights_transposed
                     else (n_input, n_output))
            self.weights.mem = self._fill(shape, self.weights_filling, stddev)
        if self.include_bias and not self.bias:
            stddev = self.bias_stddev or 0.01
            self.bias.mem = self._fill((n_output,), self.bias_filling, stddev)


def load_forward_params(forwards, params) -> None:
    """Write per-layer ``{"w": ndarray, "b": ndarray}`` dicts (``b``
    optional, ``w`` in each unit's stored layout: (in, out) FC, HWIO conv)
    into ``forwards`` before they initialize, which then keep them instead
    of drawing their own — how weights cross from the JAX package (its
    units' ``weights.mem`` / ``bias.mem``) or from a file.  ``None`` or
    ``{}`` stands for a forward without weights (pooling, LRN, dropout),
    which is skipped."""
    if len(params) != len(forwards):
        raise ValueError(f"{len(params)} param dicts for {len(forwards)} "
                         f"forward units")
    for fwd, p in zip(forwards, params):
        if not p:
            continue
        if fwd.initialized:
            raise RuntimeError(f"{fwd.name} is initialized already: load "
                               f"its params before initialize")
        fwd.weights.mem = np.array(p["w"], dtype=np.float32)
        if "b" in p:
            fwd.bias.mem = np.array(p["b"], dtype=np.float32)


class GradientDescentBase(NNLayerBase):
    """Base gradient-descent unit (reference: nn_units.py ::
    GradientDescentBase).

    Data links: ``input``/``output``/``weights``/``bias`` from the paired
    forward; ``err_output`` from the downstream gd's ``err_input`` (or the
    evaluator's ``err_output``); ``batch_size`` from the loader.  Owns
    ``err_input`` and the momentum buffers ``gradient_weights`` /
    ``gradient_bias`` (reference names).  Hyperparameters follow the
    reference SGD semantics (``ops/sgd.py``).
    """

    _matching_kind = "gd"
    ACTIVATION = activations.LINEAR
    #: evaluator already produced d/d(pre-activation) (softmax+CE case)
    ACTIVATION_APPLIED = True

    def __init__(self, workflow=None,
                 learning_rate: float = 0.01,
                 learning_rate_bias: Optional[float] = None,
                 weights_decay: float = 0.0,
                 weights_decay_bias: float = 0.0,
                 l1_vs_l2: float = 0.0,
                 gradient_moment: float = 0.0,
                 gradient_moment_bias: Optional[float] = None,
                 need_err_input: bool = True,
                 apply_gradient: bool = True,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.learning_rate = learning_rate
        self.learning_rate_bias = (learning_rate if learning_rate_bias is None
                                   else learning_rate_bias)
        self.weights_decay = weights_decay
        self.weights_decay_bias = weights_decay_bias
        self.l1_vs_l2 = l1_vs_l2
        self.gradient_moment = gradient_moment
        self.gradient_moment_bias = (gradient_moment if gradient_moment_bias
                                     is None else gradient_moment_bias)
        self.need_err_input = need_err_input
        self.apply_gradient = apply_gradient
        #: set by link_from_forward to match the paired forward's layout
        self.weights_transposed = False
        self.err_input = Array()
        self.err_output = Array()
        # empty defaults; paramful gd units overwrite them with data links
        self.weights = Array()
        self.bias = Array()
        self.gradient_weights = Array()
        self.gradient_bias = Array()

    def _common_init(self, **kwargs) -> None:
        if self.weights and not self.gradient_weights:
            self.gradient_weights.mem = np.zeros_like(self.weights.mem)
        if self.bias and not self.gradient_bias:
            self.gradient_bias.mem = np.zeros_like(self.bias.mem)

    def numpy_init(self) -> None:
        # a re-initialize onto the numpy backend drops the kernel-backed
        # ``_backward`` a torch initialize installed: the numpy oracle
        # path never runs torch
        self.__dict__.pop("_backward", None)

    def link_from_forward(self, forward: Forward) -> "GradientDescentBase":
        """Wire the standard data links from the paired forward unit."""
        self.link_attrs(forward, "input", "output", "weights", "bias")
        self.weights_transposed = forward.weights_transposed
        return self


class NNWorkflow(AcceleratedWorkflow):
    """Workflow with the conventional NN slots (reference: nn_units.py ::
    NNWorkflow): repeater, loader, forwards[], evaluator, decision, gds[]."""

    def __init__(self, workflow=None, name=None, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.loader = None
        self.forwards: list[Forward] = []
        self.evaluator = None
        self.decision = None
        self.gds: list[GradientDescentBase] = []
