"""Declarative workflow builder — the port of
``znicz_tpu/standard_workflow.py`` (rebuild of veles.znicz
standard_workflow.py :: StandardWorkflowBase, StandardWorkflow).

``StandardWorkflow(layers=[{"type": "conv_str", "->": {...geometry...},
"<-": {...gd hyperparams...}}, ...])`` turns a list-of-dicts description
into the full training graph: Repeater -> Loader -> forwards -> Evaluator
-> Decision -> gradient chain -> Repeater.  Two execution shapes, as in
the reference:

- ``fused=False``: the reference-style per-unit control graph, each unit
  running its own device path per minibatch (the conv kernels, the FC
  kernels, plain torch elsewhere).  Complete.
- ``fused=True``: the accelerated segment collapsed into one
  ``FusedTrainStep`` (``parallel/step.py``).  It composes the forwards'
  ``torch_apply``, which every registered forward unit has (FC, conv,
  deconv, pooling, LRN, dropout).

Layer spec keys: ``type`` (MatchingObject registry name), ``->`` (forward
constructor kwargs), ``<-`` (gradient/hyperparameter kwargs), ``name``;
any other key is shorthand for a forward kwarg.  ``pipeline_config=
{"depth": N}`` (fused only) attaches the input pipeline
(``znicz_tpu_torch/pipeline``): a worker serves N batches ahead and
copies each to the card on a side stream while the step runs.
``snapshotter_config`` (the ``NNSnapshotter`` kwargs: directory, prefix,
interval, only_improved, keep_all) adds the gated snapshotter side
chain after the Decision, as the reference does.  The health guard
(item 14) is not ported: ``health_config`` raises
``NotImplementedError`` unless None.
"""

from __future__ import annotations

from typing import Optional

from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.plumbing import Repeater
from znicz_tpu_torch.loader import (image, interactive,  # noqa: F401
                                    mnist, pickles, sequence, synthetic,
                                    text)  # (register loaders)
from znicz_tpu_torch.loader.base import TRAIN, get_loader
from znicz_tpu_torch.parallel.step import FusedTrainStep
import znicz_tpu_torch.units  # noqa: F401  (populates the MatchingObject registry)
from znicz_tpu_torch.units.all2all import All2AllSoftmax
from znicz_tpu_torch.units.decision import DecisionGD, DecisionMSE
from znicz_tpu_torch.units.evaluator import EvaluatorMSE, EvaluatorSoftmax
from znicz_tpu_torch.units.nn_units import (Forward, MatchingObject,
                                            NNWorkflow)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue "
                               f"A item {item})")


class StandardWorkflowBase(NNWorkflow):
    """Layer-list parsing + forward-chain construction (reference:
    standard_workflow.py :: StandardWorkflowBase)."""

    def __init__(self, workflow=None, layers=None, loader_name=None,
                 loader_config=None, name=None, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        if not layers:
            raise ValueError("StandardWorkflow requires a non-empty layers=[]")
        self.layer_specs = [self._parse_layer(sp) for sp in layers]
        self._loader_name = loader_name
        self._loader_config = dict(loader_config or {})

    @staticmethod
    def _parse_layer(spec) -> tuple:
        """-> (type_name, unit_name, fwd_kwargs, gd_kwargs)."""
        if isinstance(spec, str):
            spec = {"type": spec}
        spec = dict(spec)
        type_name = spec.pop("type")
        fwd_kwargs = dict(spec.pop("->", {}))
        gd_kwargs = dict(spec.pop("<-", {}))
        unit_name = spec.pop("name", None)
        fwd_kwargs.update(spec)  # flat shorthand
        return type_name, unit_name, fwd_kwargs, gd_kwargs

    # -- builder hooks (reference method names kept) ------------------------
    def link_repeater(self) -> Repeater:
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)
        return self.repeater

    def link_loader(self, *parents) -> None:
        if self._loader_name is None:
            raise ValueError("no loader: pass loader_name")
        self.loader = get_loader(self._loader_name)(self,
                                                    **self._loader_config)
        self.loader.link_from(*parents)

    def link_forwards(self, loader_attr: str = "minibatch_data",
                      *parents) -> None:
        """Instantiate the forward chain from the parsed specs and wire both
        control (sequential) and data (output->input) links."""
        self.forwards = []
        prev_unit = None
        for i, (type_name, unit_name, fwd_kwargs, _) in \
                enumerate(self.layer_specs):
            cls = MatchingObject.forwards.get(type_name)
            if cls is None:
                raise KeyError(f"unknown layer type {type_name!r}; known: "
                               f"{sorted(MatchingObject.forwards)}")
            fwd = cls(self, name=unit_name or f"{type_name}{i}", **fwd_kwargs)
            if prev_unit is None:
                fwd.link_from(*parents)
                fwd.link_attrs(self.loader, ("input", loader_attr))
            else:
                fwd.link_from(prev_unit)
                fwd.link_attrs(prev_unit, ("input", "output"))
            self.forwards.append(fwd)
            prev_unit = fwd


class StandardWorkflow(StandardWorkflowBase):
    """Full declarative training workflow (reference: StandardWorkflow).

    Parameters mirror the reference: ``loss_function`` ("softmax" | "mse"),
    ``decision_config`` (max_epochs, fail_iterations), ``loader_name`` +
    ``loader_config`` (registry lookup), ``fused`` and the fused step's
    options.
    """

    def __init__(self, workflow=None, layers=None,
                 loss_function: str = "softmax",
                 evaluator_config: Optional[dict] = None,
                 decision_config: Optional[dict] = None,
                 snapshotter_config: Optional[dict] = None,
                 health_config: Optional[dict] = None,
                 fused: bool = True, mesh=None,
                 pipeline_config: Optional[dict] = None,
                 defer_metrics: bool = True,
                 optimizer: str = "sgd",
                 optimizer_config: Optional[dict] = None,
                 shard_update: bool = False,
                 shard_params: bool = False,
                 clip_norm: Optional[float] = None,
                 accumulate_steps: int = 1,
                 ema_decay: Optional[float] = None,
                 quantized_collectives: Optional[dict] = None,
                 **kwargs) -> None:
        super().__init__(workflow, layers=layers, **kwargs)
        if loss_function not in ("softmax", "mse"):
            raise ValueError(f"unknown loss_function {loss_function!r}")
        self.loss_function = loss_function
        #: forwarded to the evaluator constructor (e.g. class_weights,
        #: compute_confusion_matrix, root_mse)
        self.evaluator_config = dict(evaluator_config or {})
        self.decision_config = dict(decision_config or {})
        self.fused = fused
        self.mesh = mesh
        #: async input pipeline (znicz_tpu_torch.pipeline): ``{"depth":
        #: N}`` prefetches N batches ahead with overlapped H2D staging;
        #: None = synchronous serving
        self.pipeline_config = pipeline_config
        self.defer_metrics = defer_metrics
        #: "sgd" (reference parity, eager + fused) or "adam" (AdamW,
        #: fused-only — the eager gd units carry SGD semantics)
        self.optimizer = optimizer
        self.optimizer_config = optimizer_config
        self.shard_update = shard_update
        self.shard_params = shard_params
        self.clip_norm = clip_norm
        self.accumulate_steps = accumulate_steps
        self.ema_decay = ema_decay
        self.quantized_collectives = quantized_collectives
        if optimizer != "sgd" and not fused:
            raise ValueError(f"optimizer {optimizer!r} requires fused=True "
                             f"(the eager gd units implement SGD only)")
        if shard_update and not fused:
            raise ValueError("shard_update requires fused=True (the eager "
                             "gd units keep fully replicated state)")
        if shard_params and not fused:
            raise ValueError("shard_params requires fused=True (the eager "
                             "gd units keep fully replicated state)")
        if clip_norm is not None and not fused:
            raise ValueError("clip_norm requires fused=True (the eager gd "
                             "units apply per-unit updates with no global "
                             "gradient view)")
        if accumulate_steps > 1 and not fused:
            raise ValueError("accumulate_steps requires fused=True")
        if ema_decay is not None and not fused:
            raise ValueError("ema_decay requires fused=True (the EMA "
                             "mirror lives in the fused step's params)")
        if quantized_collectives is not None and not fused:
            raise ValueError("quantized_collectives requires fused=True "
                             "(the eager gd units psum per-unit inside "
                             "their own programs)")
        if clip_norm is not None and clip_norm <= 0:
            raise ValueError(f"clip_norm must be positive, got {clip_norm}"
                             f" (0 freezes training; negative flips the "
                             f"gradient sign)")
        if pipeline_config is not None and not fused:
            raise ValueError(
                "pipeline_config requires fused=True (the eager per-unit "
                "path owns its own host uploads and may draw host prng "
                "per step, which the prefetch producer would reorder)")
        if health_config is not None:
            raise _not_ported("the health guard (health_config)", "14")
        self.snapshotter_config = snapshotter_config
        self.snapshotter = None
        self.input_pipeline = None
        self.create_workflow()

    # -- graph assembly ------------------------------------------------------
    def create_workflow(self) -> None:
        self.link_repeater()
        self.link_loader(self.repeater)
        self.link_forwards("minibatch_data", self.loader)
        self.link_evaluator(self.forwards[-1])
        self.link_decision(self.evaluator)
        if self.fused:
            self.link_fused_step()
            if self.pipeline_config is not None:
                self.link_pipeline()
        else:
            self.link_gds()
        self.link_snapshotter()
        # the loop back-edge: exactly ONE provider — the Repeater fires on
        # any signal, so a second edge would double-run each minibatch
        self.repeater.link_from(self._tail)
        self.link_end_point()

    #: evaluator_config keys each loss accepts — the Unit base swallows
    #: unknown kwargs, so a typo'd or misplaced key (class_weights on an
    #: MSE workflow) would otherwise be dropped silently
    _EVALUATOR_KEYS = {"softmax": {"compute_confusion_matrix",
                                   "class_weights"},
                       "mse": {"root_mse"}}

    def link_evaluator(self, parent: Forward) -> None:
        unknown = set(self.evaluator_config) - \
            self._EVALUATOR_KEYS[self.loss_function]
        if unknown:
            raise ValueError(
                f"evaluator_config keys {sorted(unknown)} are not "
                f"accepted by the {self.loss_function!r} evaluator "
                f"(accepted: "
                f"{sorted(self._EVALUATOR_KEYS[self.loss_function])})")
        if self.loss_function == "softmax":
            if not isinstance(self.forwards[-1], All2AllSoftmax):
                raise ValueError('loss_function="softmax" requires the last '
                                 'layer to be of type "softmax"')
            ev = self.evaluator = EvaluatorSoftmax(self,
                                                   **self.evaluator_config)
            ev.link_attrs(parent, "output", "max_idx")
            ev.link_attrs(self.loader, ("labels", "minibatch_labels"),
                          ("batch_size", "minibatch_size"))
        else:
            ev = self.evaluator = EvaluatorMSE(self,
                                               **self.evaluator_config)
            ev.link_attrs(parent, "output")
            ev.link_attrs(self.loader, ("target", "minibatch_targets"),
                          ("batch_size", "minibatch_size"))
            if hasattr(self.loader, "class_targets"):
                # nearest-target classification (approximator samples)
                ev.link_attrs(self.loader, ("labels", "minibatch_labels"),
                              "class_targets")
        ev.link_from(parent)

    def link_decision(self, parent) -> None:
        cls = DecisionGD if self.loss_function == "softmax" else DecisionMSE
        dec = self.decision = cls(self, **self.decision_config)
        dec.link_from(parent)
        dec.link_attrs(self.loader, "minibatch_class", "last_minibatch",
                       "class_lengths", "epoch_number", "minibatch_size")
        if self.loss_function == "softmax":
            dec.link_attrs(self.evaluator, ("minibatch_n_err", "n_err"))
            dec.evaluator = self.evaluator
        else:
            dec.link_attrs(self.evaluator, ("minibatch_mse", "mse"))

    def _make_gds(self) -> None:
        """Instantiate gradient units paired to the forwards (forward
        order), wiring the shared-weight data links."""
        self.gds = []
        for (type_name, unit_name, _, gd_kwargs), fwd in \
                zip(self.layer_specs, self.forwards):
            gd_cls = MatchingObject.gds.get(type_name)
            if gd_cls is None:
                raise KeyError(f"no gradient unit for type {type_name!r}")
            gd = gd_cls(self, name=f"gd_{fwd.name}", **gd_kwargs)
            gd.link_from_forward(fwd)
            gd.link_attrs(self.loader, ("batch_size", "minibatch_size"))
            self.gds.append(gd)
        # err chain: evaluator feeds the last gd; each gd feeds the previous
        self.gds[-1].link_attrs(self.evaluator, "err_output")
        for up, down in zip(self.gds, self.gds[1:]):
            up.link_attrs(down, ("err_output", "err_input"))
        self.gds[0].need_err_input = False

    def link_gds(self) -> None:
        """Eager backward chain: gds run in reverse order after Decision,
        skipped on non-train minibatches (reference control shape)."""
        self._make_gds()
        prev = self.decision
        for gd in reversed(self.gds):
            gd.link_from(prev)
            gd.gate_skip = Bool(
                lambda: int(self.loader.minibatch_class) != TRAIN)
            prev = gd
        self._tail = prev

    def link_fused_step(self) -> None:
        """Forwards/evaluator/gds subsumed by one FusedTrainStep; control
        graph is Repeater -> Loader -> Step -> Decision."""
        self._make_gds()
        step = self.step = FusedTrainStep(
            self, forwards=self.forwards, evaluator=self.evaluator,
            gds=self.gds, loader=self.loader, mesh=self.mesh,
            defer_metrics=self.defer_metrics, optimizer=self.optimizer,
            optimizer_config=self.optimizer_config,
            shard_update=self.shard_update,
            shard_params=self.shard_params, clip_norm=self.clip_norm,
            accumulate_steps=self.accumulate_steps,
            ema_decay=self.ema_decay,
            quantized_collectives=self.quantized_collectives,
            name="FusedStep")
        # re-route control: loader -> step -> decision
        step.link_from(self.loader)
        # evaluator/forwards keep their data links but leave the control
        # graph; Decision re-links to read the step's metric mirrors
        self.evaluator.unlink_all()
        for fwd in self.forwards:
            fwd.unlink_all()
        self.decision.unlink_all()
        self.decision.link_from(step)
        # the sample count behind the metric sums comes from the step, so
        # Decision's epoch accounting stays exact when they arrive
        # aggregated per class pass
        self.decision.link_attrs(step, "minibatch_size")
        if self.loss_function == "softmax":
            self.decision.link_attrs(step, ("minibatch_n_err", "n_err"))
        else:
            self.decision.link_attrs(step, ("minibatch_mse", "mse"))
        self._tail = self.decision

    def link_pipeline(self) -> None:
        """Async input pipeline: a prefetch worker runs the loader's
        serve loop ahead of the step and stages each batch onto the card
        while the previous step computes (znicz_tpu_torch.pipeline)."""
        from znicz_tpu_torch.pipeline import attach_prefetcher
        self.input_pipeline = attach_prefetcher(
            self.loader, stager=self.step.make_stager(),
            **self.pipeline_config)

    def link_snapshotter(self) -> None:
        """Gated snapshotter side chain: runs after the Decision at each
        epoch end; no-op when snapshotter_config is None."""
        if self.snapshotter_config is None:
            return
        from znicz_tpu_torch.snapshotter import NNSnapshotter
        snap = self.snapshotter = NNSnapshotter(self,
                                                **self.snapshotter_config)
        snap.link_from(self._tail)
        snap.link_workflow_state(self)
        snap.gate_skip = ~self.decision.epoch_ended
        self._tail = snap

    def link_end_point(self) -> None:
        self.end_point.link_from(self._tail)
        self.end_point.gate_block = ~self.decision.complete
