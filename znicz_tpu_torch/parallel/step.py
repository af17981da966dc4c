"""FusedTrainStep — the port of ``znicz_tpu/parallel/step.py`` on one
device.

One Unit replaces the accelerated segment of an NN workflow (forwards ->
evaluator -> gradient updates): Repeater -> Loader -> FusedTrainStep ->
Decision -> Repeater, with the loader and the decision host-side as in
the reference.  Per minibatch:

    (params, hyper, x, labels/targets, mask) -> (params', metrics)

- the forward composes each unit's ``torch_apply`` (plain torch
  matmuls, as the reference's are XLA dots), casting activations and
  the f32 master params to the compute dtype: bf16 on ``cuda``, f32 on
  the CPU;
- the loss is the reference's masked sum (softmax cross-entropy with
  class weights, or MSE) computed in f32, with the metric sums beside
  it: ``n_err``, the confusion matrix, ``mse_sum``, nearest-target
  ``n_err``;
- the backward is autograd of that loss, as the reference's is
  ``jax.value_and_grad``;
- the update is SGD with momentum (``state_dtype="bfloat16"`` stores the
  velocity narrow) or AdamW, with an optional global-norm clip, on the
  hand-written update kernels (``kernels/optim.py``; the reference's
  route under ``root.common.engine.pallas`` — the port has no switch).
  It runs IN PLACE on the master params: that is the port's ``donate``.
  The hyperparameters and the batch size (a device value, the mask's
  sum) reach the kernels as device scalars, so a step never syncs with
  the host; Adam's step count ``t`` is a device leaf and its bias
  corrections are computed from it on the device.

Forwards that need random bits (``NEEDS_RNG``: dropout, stochastic
pooling) draw them in a train step from one ``torch.Generator`` on the
step's device, minted at initialize by ``prng.get().key`` as the
reference mints its one key; each such forward draws its uniforms in
forward order, so the stream advances per step and per unit, as the
reference's split and fold per step and unit do.  An eval step draws
nothing.  The draws never sync with the host.  The two frameworks draw
different bits from one seed.

A full-batch dataset is pinned on the device at initialize, so the hot
loop ships only the minibatch's indices.  Metric sums stay on the device
and reach the host once per class pass (``defer_metrics``).
``train_steps`` runs K minibatches in one call (a Python loop over the
same step for now; CUDA graphs are later work).

Not ported yet, each raising ``NotImplementedError`` (ROADMAP.md queue
A): a mesh over more than one device, ``shard_update``,
``shard_params``, ``quantized_collectives``, ``anatomy``,
``accumulate_steps > 1``, ``ema_decay``, ``scan_epoch`` and the input
pipeline's ``make_stager``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from znicz_tpu_torch.core import backends, prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.kernels import optim as koptim
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.resilience.faults import poison_hook
from znicz_tpu_torch.units.all2all import All2AllSoftmax
from znicz_tpu_torch.units.evaluator import EvaluatorMSE, EvaluatorSoftmax

_STATE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def full_batch_arrays(loader, mse: bool):
    """Does ``loader`` expose a static full-batch dataset?  Returns
    ``(data_arr, labels_arr, None)`` or ``(None, None, reason)``."""
    if loader is None:
        return None, None, "no loader"
    data_arr = getattr(loader, "original_data", None)
    if not data_arr:
        return None, None, "loader exposes no original_data"
    if getattr(loader, "augmenting", False):
        return None, None, "augmenting loader"
    labels_arr = getattr(
        loader, "original_targets" if mse else "original_labels", None)
    if not labels_arr:
        return None, None, "loader exposes no labels/targets array"
    return data_arr, labels_arr, None


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, the fused step's "
        f"leftovers); the port's fused step runs on one device")


class FusedTrainStep(Unit):
    """One-unit replacement for the accelerated segment of the graph."""

    OPTIMIZERS = ("sgd", "adam")
    ADAM_DEFAULTS = {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8}
    #: per-layer hyperparameters, the columns of the device hyper buffer
    HYPER_KEYS = ("lr", "wd", "l1", "mom", "lr_b", "wd_b", "mom_b")

    def __init__(self, workflow=None, forwards=None, evaluator=None,
                 gds=None, loader=None, mesh=None, donate: bool = True,
                 defer_metrics: bool = True,
                 scan_epoch: Optional[bool] = None,
                 optimizer: str = "sgd",
                 optimizer_config: Optional[dict] = None,
                 shard_update: bool = False,
                 shard_params: bool = False,
                 clip_norm: Optional[float] = None,
                 accumulate_steps: int = 1,
                 ema_decay: Optional[float] = None,
                 quantized_collectives: Optional[dict] = None,
                 anatomy: Optional[bool] = None,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if optimizer not in self.OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optimizer!r}; "
                             f"registered: {self.OPTIMIZERS}")
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got "
                             f"{ema_decay}")
        self.optimizer = optimizer
        self.optimizer_config = {**self.ADAM_DEFAULTS,
                                 **(optimizer_config or {})}
        #: optional storage dtype of the SGD momentum buffers: the update
        #: math stays f32, only the persistent velocity lives narrow
        sd = self.optimizer_config.pop("state_dtype", None)
        if sd is not None and str(sd) not in _STATE_DTYPES:
            raise ValueError(f"state_dtype {sd!r}: have {list(_STATE_DTYPES)}")
        self.state_dtype = None if sd is None else _STATE_DTYPES[str(sd)]
        if self.state_dtype is not None and optimizer != "sgd":
            raise ValueError(
                "state_dtype applies to the SGD momentum buffers only "
                "(adam moments need f32 second-moment accumulation)")
        sizes = dict(getattr(mesh, "shape", mesh) or {})
        if any(int(n) != 1 for n in sizes.values()):
            raise _not_ported(f"a mesh over more than one device ({sizes})")
        refused = {"donate=False": not donate,
                   "shard_update": shard_update,
                   "shard_params": shard_params,
                   "accumulate_steps > 1": accumulate_steps > 1,
                   "ema_decay": ema_decay is not None,
                   "scan_epoch": scan_epoch if scan_epoch is not None
                   else root.common.engine.get("scan_epoch", False),
                   "anatomy": anatomy if anatomy is not None
                   else root.common.engine.get("step_anatomy", False)}
        qc = quantized_collectives if quantized_collectives is not None \
            else root.common.engine.get("quantized_collectives", None)
        refused["quantized_collectives"] = bool(qc) and \
            dict(qc).get("mode", "off") != "off"
        for what, on in refused.items():
            if on:
                raise _not_ported(what)
        #: global-norm gradient clipping of the batch-mean gradient
        self.clip_norm = clip_norm
        self.forwards = list(forwards or [])
        self.evaluator = evaluator
        #: gradient units in FORWARD order (gds[i] pairs forwards[i]);
        #: suppliers of per-layer hyperparams + momentum buffers
        self.gds = list(gds or [])
        self.loader = loader
        #: keep per-minibatch metric sums ON DEVICE and sync to host once
        #: per class pass (at ``loader.last_minibatch``)
        self.defer_metrics = defer_metrics
        #: forward/backward compute dtype (resolved from the device at
        #: initialize: bf16 on cuda, f32 on the CPU); params stay f32
        self.compute_dtype = None
        self._dev = None
        self._params = None
        self._adam_consts = None  # (b1, b2, eps) device scalars
        self._gen = None          # the train steps' torch.Generator
        self._dataset_dev = None  # device-pinned (data, labels) full batch
        self._hyper_cache = None  # (signature, per-layer device scalars)
        self._acc = None          # device-side metric sums (deferred mode)
        self._conf_seen = None    # confusion sums already folded this pass
        self._nt_valid = None     # nearest-target recovery proven valid?
        # metrics the Decision links to (mirrors the evaluator's attrs)
        self.n_err = 0
        self.mse = 0.0
        self.loss = 0.0
        #: host mirror of the summed sample count behind the current
        #: n_err/mse values (the Decision's ``minibatch_size`` link)
        self.minibatch_size = 0

    # -- parameters -----------------------------------------------------------
    def _put(self, host, dtype=torch.float32) -> torch.Tensor:
        """A device copy of a host array (never a view of it)."""
        return torch.tensor(np.asarray(host), dtype=dtype, device=self._dev)

    def gather_params(self) -> list:
        """The params from the unit Arrays: per layer a dict of f32
        master ``w``/``b``, momentum ``vw``/``vb`` (in ``state_dtype``),
        and for adam the second moments ``sw``/``sb`` and the step count
        ``t`` (a 0-d device leaf)."""
        vdt = self.state_dtype or torch.float32
        params = []
        for fwd, gd in zip(self.forwards, self.gds):
            leaf = {k: self._put(arr.map_read())
                    for k, arr in fwd.param_arrays().items()}
            for k, vel in (("w", gd.gradient_weights),
                           ("b", gd.gradient_bias)):
                if k not in leaf:
                    continue
                leaf["v" + k] = self._put(
                    vel.map_read() if vel else np.zeros(leaf[k].shape),
                    vdt)
                if self.optimizer == "adam":
                    leaf["s" + k] = torch.zeros_like(leaf[k])
            if self.optimizer == "adam":
                leaf["t"] = torch.zeros((), device=self._dev)
            params.append(leaf)
        return params

    def hyper_params(self) -> list:
        """Per-layer hyperparams as host floats, read from the gd units."""
        return [
            {"lr": float(gd.learning_rate), "wd": float(gd.weights_decay),
             "l1": float(gd.l1_vs_l2), "mom": float(gd.gradient_moment),
             "lr_b": float(gd.learning_rate_bias),
             "wd_b": float(gd.weights_decay_bias),
             "mom_b": float(gd.gradient_moment_bias)}
            for gd in self.gds
        ]

    def _hyper_device(self) -> list:
        """Per-layer dicts of 0-d device scalars (views into one f32
        buffer), re-uploaded only when an LR schedule changed a value."""
        sig = tuple(tuple(h[k] for k in self.HYPER_KEYS)
                    for h in self.hyper_params())
        if self._hyper_cache is None or self._hyper_cache[0] != sig:
            buf = torch.tensor(sig, dtype=torch.float32, device=self._dev)
            views = [{k: buf[i, j] for j, k in enumerate(self.HYPER_KEYS)}
                     for i in range(len(sig))]
            self._hyper_cache = (sig, views)
        return self._hyper_cache[1]

    def sync_to_units(self) -> None:
        """Write copies of the device params back into the unit Arrays
        (snapshot / inspection path; the hot loop never does this)."""
        for fwd, gd, leaf in zip(self.forwards, self.gds, self._params):
            for k, arr, vel in (("w", fwd.weights, gd.gradient_weights),
                                ("b", fwd.bias, gd.gradient_bias)):
                if k in leaf:
                    arr.set_devmem(leaf[k].detach().clone())
                    vel.set_devmem(leaf["v" + k].to(torch.float32,
                                                    copy=True))

    # -- forward / loss composition -----------------------------------------
    def _forward_chain(self, params, x, train: bool, rng=None):
        """Compose the forwards; returns pre-softmax logits when the last
        layer is All2AllSoftmax under EvaluatorSoftmax (the loss takes
        log_softmax directly).  ``rng`` is the train step's generator,
        handed to each NEEDS_RNG forward, which draws from it in forward
        order.  Activations and params run in ``compute_dtype``;
        autograd casts the gradients back to the f32 masters."""
        cdt = self.compute_dtype
        x = x.to(cdt)
        last = len(self.forwards) - 1
        logits_tail = isinstance(self.forwards[last], All2AllSoftmax) and \
            isinstance(self.evaluator, EvaluatorSoftmax)
        for i, (fwd, p) in enumerate(zip(self.forwards, params)):
            pc = {k: p[k].to(cdt) for k in ("w", "b") if k in p}
            if i == last and logits_tail:
                x = fwd.torch_apply_linear(pc, x)
            else:
                x = fwd.torch_apply(pc, x, train=train, rng=rng if getattr(
                    fwd, "NEEDS_RNG", False) else None)
        return x, logits_tail

    def _nt_recovery_valid(self) -> bool:
        """Fused nearest-target n_err is emitted only when every stored
        target is the exact prototype row of its label (so the label is
        recoverable as the target's nearest prototype).  Cached."""
        if self._nt_valid is not None:
            return self._nt_valid
        self._nt_valid = False
        ev = self.evaluator
        loader = self.loader
        if isinstance(ev, EvaluatorMSE) and ev._classifies and \
                loader is not None:
            targets = getattr(loader, "original_targets", None)
            labels = getattr(loader, "original_labels", None)
            if targets and labels:
                protos = ev.class_targets.map_read()
                lab = np.asarray(labels.mem)
                self._nt_valid = bool(
                    np.array_equal(np.asarray(targets.mem), protos[lab]))
        return self._nt_valid

    def _loss_and_metrics(self, out, logits_tail, labels, mask):
        """Masked loss-sum + metric sums, in f32 whatever the forward's
        compute dtype."""
        out = out.to(torch.float32)
        fmask = mask.to(out.dtype)
        n = out.shape[0]
        if isinstance(self.evaluator, EvaluatorSoftmax):
            labels = labels.long()
            if logits_tail:
                logp = torch.log_softmax(out, dim=1)
            else:
                logp = torch.log(torch.clamp(out, min=1e-30))
            picked = logp[torch.arange(n, device=out.device), labels]
            # per-class weights: each sample's CE term scaled by its TRUE
            # class's weight, so autograd yields err rows scaled exactly
            # like the eager evaluator's
            cw = getattr(self.evaluator, "class_weights", None)
            wrow = fmask if cw is None else \
                fmask * torch.as_tensor(cw, device=out.device)[labels]
            loss = -(picked * wrow).sum()
            pred = out.detach().argmax(dim=1)
            metrics = {"loss": loss, "n_err": ((pred != labels) & mask).sum()}
            if getattr(self.evaluator, "compute_confusion_matrix", False):
                # (pred, label) counts as f32 sums, oriented like the
                # eager evaluator's np.add.at(confusion, (max_idx, labels))
                c = out.shape[1]
                one_hot = torch.nn.functional.one_hot
                pred_oh = one_hot(pred, c).to(torch.float32) * \
                    fmask[:, None]
                lab_oh = one_hot(labels, c).to(torch.float32)
                metrics["confusion"] = pred_oh.T @ lab_oh
            return loss, metrics
        if isinstance(self.evaluator, EvaluatorMSE):
            target = labels.reshape(n, -1).to(out.dtype)
            diff = (out.reshape(n, -1) - target) * fmask[:, None]
            loss = 0.5 * (diff * diff).sum()
            metrics = {"loss": loss,
                       "mse_sum": (diff * diff).mean(dim=1).sum()}
            if self._nt_recovery_valid():
                protos = torch.as_tensor(
                    self.evaluator.class_targets.map_read(),
                    device=out.device).to(out.dtype)
                nearest = EvaluatorMSE.nearest_prototype
                pred = nearest(torch, out.detach(), protos)
                lab = nearest(torch, target, protos)
                metrics["n_err"] = ((pred != lab) & mask).sum()
            return loss, metrics
        raise TypeError(f"unsupported evaluator {type(self.evaluator)}")

    # -- the step bodies -----------------------------------------------------
    def _train_step(self, x, labels, mask) -> dict:
        """One minibatch: forward, autograd backward, in-place update.
        Returns the metric sums (device tensors)."""
        params = self._params
        leaves = [leaf[k] for leaf in params for k in ("w", "b")
                  if k in leaf]
        for t in leaves:
            t.requires_grad_(True)
        try:
            out, logits_tail = self._forward_chain(params, x, train=True,
                                                   rng=self._gen)
            loss, metrics = self._loss_and_metrics(out, logits_tail,
                                                   labels, mask)
            flat = iter(torch.autograd.grad(loss, leaves))
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [{k: next(flat) for k in ("w", "b") if k in leaf}
                 for leaf in params]
        metrics["loss"] = loss.detach()
        metrics["bs"] = mask.sum()
        self._apply_update(params, grads, self._hyper_device(),
                           metrics["bs"].to(torch.float32))
        return metrics

    def _eval_step(self, x, labels, mask) -> dict:
        with torch.no_grad():
            out, logits_tail = self._forward_chain(self._params, x,
                                                   train=False)
            _, metrics = self._loss_and_metrics(out, logits_tail, labels,
                                                mask)
        metrics["bs"] = mask.sum()
        return metrics

    def _apply_update(self, params, grads, hyper, bs) -> None:
        """One optimizer step, in place, for summed gradients ``grads``
        over ``bs`` samples (a device scalar), on the update kernels."""
        if self.clip_norm is not None:
            # clip the batch-mean gradient's GLOBAL norm across layers;
            # scaling the sums by the same factor is equivalent
            sq = sum(torch.sum(torch.square(g / bs))
                     for leaf in grads for g in leaf.values())
            scale = torch.clamp(self.clip_norm / torch.clamp(
                torch.sqrt(sq), min=1e-12), max=1.0)
            grads = [{k: v * scale for k, v in leaf.items()}
                     for leaf in grads]
        if self.optimizer == "adam":
            # every leaf of the step, w and b of each layer, in one call
            b1, b2, eps = self._adam_consts
            leaves = []
            for leaf, grad, h in zip(params, grads, hyper):
                leaf["t"].add_(1.0)
                # bias corrections on the device, outside the kernel
                c1, c2 = 1.0 - b1 ** leaf["t"], 1.0 - b2 ** leaf["t"]
                leaves += [(leaf[k], grad[k].contiguous(), leaf["v" + k],
                            leaf["s" + k], h[lr], h[wd], c1, c2)
                           for k, lr, wd in (("w", "lr", "wd"),
                                             ("b", "lr_b", "wd_b"))
                           if k in leaf]
            koptim.adam_update_multi_(leaves, b1, b2, eps, bs)
            return
        for leaf, grad, h in zip(params, grads, hyper):
            for k, lr, wd, mom in (("w", "lr", "wd", "mom"),
                                   ("b", "lr_b", "wd_b", "mom_b")):
                if k in leaf:
                    koptim.sgd_update_(leaf[k], grad[k].contiguous(),
                                       leaf["v" + k], h[lr], h[wd],
                                       h["l1"], h[mom], bs)

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, device=None, **kwargs) -> None:
        # the step subsumes the segment units: they are not in the control
        # graph, so initialize them here (weights allocated + filled)
        for unit in (*self.forwards, self.evaluator, *self.gds):
            if unit is not None and not unit.initialized:
                unit.initialize(device=device, **kwargs)
                unit.initialized = True
        if self.optimizer == "adam":
            bad = [gd.name for gd in self.gds
                   if float(getattr(gd, "l1_vs_l2", 0.0)) != 0.0]
            if bad:
                raise ValueError(
                    f"l1_vs_l2 is SGD-only (adam applies decoupled L2 "
                    f"weight decay); set it to 0 on: {bad}")
        # a TorchDevice names the device; anything else means the default,
        # cuda — which raises on a host without one, never the CPU
        self._dev = device.torch_device \
            if isinstance(device, backends.TorchDevice) else \
            backends.device(None)
        if self.compute_dtype is None:
            self.compute_dtype = getattr(device, "compute_dtype", None) or \
                backends.resolve_compute_dtype(self._dev.type)
        self._params = self.gather_params()
        # one generator for every train step's draws, minted whether or
        # not a forward draws, as the reference mints its key
        self._gen = prng.get().key(self._dev)
        if self.optimizer == "adam":
            cfg = self.optimizer_config
            self._adam_consts = tuple(
                torch.tensor(float(cfg[k]), device=self._dev)
                for k in ("beta1", "beta2", "eps"))
        self._pin_dataset()
        self.initialized = True

    def _pin_dataset(self) -> None:
        """Place a full-batch dataset on the device so the hot loop ships
        only minibatch INDICES.  Gated on size
        (``root.common.engine.dataset_on_device_max_bytes``, default 1
        GiB)."""
        self._dataset_dev = None
        data_arr, labels_arr, _why = full_batch_arrays(
            self.loader, mse=isinstance(self.evaluator, EvaluatorMSE))
        if data_arr is None:
            return
        limit = int(root.common.engine.get(
            "dataset_on_device_max_bytes", 1 << 30))
        data = np.asarray(data_arr.mem, np.float32)
        if data.nbytes > limit:
            return
        labels = np.asarray(labels_arr.mem)
        self._dataset_dev = (self._put(data),
                             torch.tensor(labels, device=self._dev))
        # the loader now serves indices only
        self.loader.serve_indices_only = True

    def train_steps(self, xs, ys, masks) -> dict:
        """Run ``xs.shape[0]`` training minibatches in one call and
        return the summed metric dict (device tensors).  ``xs``/``ys``/
        ``masks`` carry a leading step axis; a Python loop over the same
        step for now (the reference scans them in one program)."""
        total = None
        for k in range(int(xs.shape[0])):
            m = self._train_step(xs[k], ys[k], masks[k])
            total = m if total is None else \
                {key: total[key] + m[key] for key in total}
        return total

    def make_stager(self):
        raise _not_ported("the input pipeline's stager (pipeline_depth)")

    # -- per-minibatch control callback -------------------------------------
    def run(self) -> None:
        loader = self.loader
        # one upload a step: the raw indices (-1 = padding); the mask and
        # the clamped gather indices are made on the device
        raw = torch.tensor(loader.minibatch_indices.mem, device=self._dev)
        mask = raw >= 0
        if self._dataset_dev is not None:
            idx = torch.clamp(raw, min=0)
            data, labels_all = self._dataset_dev
            x, labels = data[idx], labels_all[idx]
        else:
            x = self._put(loader.minibatch_data.mem)
            lab = loader.minibatch_targets if isinstance(
                self.evaluator, EvaluatorMSE) else loader.minibatch_labels
            labels = torch.tensor(lab.mem, device=self._dev)
        if int(loader.minibatch_class) != TRAIN:
            metrics = self._eval_step(x, labels, mask)
        else:
            metrics = self._train_step(x, labels, mask)
        self._finish_run(loader, metrics)

    def _finish_run(self, loader, metrics) -> None:
        # chaos hook (site "step.params"): NaN-poisons the params — the
        # observable effect of NaN gradients
        self._params = poison_hook("step.params", self._params)
        if not self.defer_metrics:
            self._publish(_to_host(metrics))
            return
        # deferred mode: fold into the device-side sums (no host sync) and
        # fetch only at the end of the class pass
        self._acc = metrics if self._acc is None else \
            {k: self._acc[k] + v for k, v in metrics.items()}
        if loader.last_minibatch:
            self._publish(_to_host(self._acc), cumulative=True)
            self._acc = None
            self._conf_seen = None
        else:
            # non-final minibatches contribute zero to the Decision's
            # accumulators; the class-pass totals land in one shot above
            self.n_err = 0
            self.mse = 0.0
            self.loss = 0.0
            self.minibatch_size = 0

    def _publish(self, sums, cumulative: bool = False) -> None:
        """Write (host) metric sums into the attrs the Decision reads.
        ``cumulative=True``: the sums cover the class pass so far, so the
        confusion matrix folds only the delta since the last publish."""
        bs = float(sums["bs"])
        self.minibatch_size = int(bs)
        # chaos hook (site "step.loss"): NaN into the published loss
        self.loss = poison_hook("step.loss", float(sums["loss"]))
        if "n_err" in sums:
            self.n_err = int(sums["n_err"])
        if "mse_sum" in sums:
            self.mse = float(sums["mse_sum"]) / max(bs, 1.0)
        if "confusion" in sums and \
                getattr(self.evaluator, "confusion_matrix", None) is not None:
            conf = np.rint(np.asarray(sums["confusion"])).astype(np.int64)
            if cumulative:
                delta = conf if self._conf_seen is None else \
                    conf - self._conf_seen
                self._conf_seen = conf
            else:
                delta = conf
            self.evaluator.confusion_matrix += delta

    def flush_metrics(self) -> None:
        """Sync pending deferred sums into the host mirrors (probe/debug
        path); the class pass keeps accumulating."""
        if self._acc is not None:
            self._publish(_to_host(self._acc), cumulative=True)

    def stop(self) -> None:
        if self._params is not None:
            self.sync_to_units()


def _to_host(sums: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in sums.items()}
