"""FusedTrainStep — the port of ``znicz_tpu/parallel/step.py``, on one
device or data-parallel over a ``torch.distributed`` world.

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

On ``cuda`` every step body (train, eval, and the accumulation
half-step) runs as a replay of a ``torch.cuda.CUDAGraph``, one graph a
(body, input shapes): the counterpart of the reference's one jitted
dispatch a minibatch.  The first call of each runs the body eagerly (it
is a real step, and it builds every kernel and workspace on the capture
stream); the second captures the body and replays the capture at once;
every later call copies its inputs into the graph's buffers and replays.
A body that cannot be captured raises with the reason; nothing falls
back to eager launches.  The hyperparameters live in one persistent
device buffer written in place, the step's generator is registered with
every graph (a replay advances its Philox offset as an eager step
would), and each kernel counter's launches at capture are added back on
every replay.  ``train_steps`` runs K minibatches in one call: K replays
of the same graph (the reference scans them in one program).  The CPU
runs the same bodies eagerly.

``accumulate_steps > 1`` sums the gradients of a half-step (graphed on
the card) on the device and applies the update (eagerly) every N train
minibatches and at the train pass's last; ``ema_decay`` keeps f32
mirrors ``ew``/``eb`` updated after every update inside the step body;
``scan_epoch`` uploads the class pass's plan once at its first
minibatch and replays the step once a plan row.

The input pipeline (``znicz_tpu_torch/pipeline``) feeds the step through
:meth:`FusedTrainStep.make_stager`: its worker copies each batch's step
inputs (the raw indices, and the rows and labels when the data set is
not pinned) from pinned ring slots to the card on a side stream, and
``run`` consumes them from ``loader.take_staged()``, its stream waiting
on the staging event; a graph's static inputs then take a device-to-
device copy and no host copy.

Data parallel (ROADMAP.md queue A item 10a).  The reference is one
process driving N devices through ``shard_map``; the port runs one
process per device over a ``torch.distributed`` world, its place in it a
:class:`~znicz_tpu_torch.parallel.mesh.DataMesh` (``mesh=None``: the
whole world, or a mesh of one outside any world).  Every rank runs the
same seeded loader and serves the same global minibatch; rank r takes
its contiguous rows ``[r·b/n, (r+1)·b/n)`` (those ``P("data")`` gives
device r) and a minibatch n does not divide raises at initialize.  Each
rank runs autograd over its rows; the summed gradients go through one
all-reduce of their concatenation (with ``quantized_collectives``,
``qcomm.psum_tree``'s quantize -> all-gather -> dequantize -> f32 sum
in rank order, and the error-feedback residuals ``rw``/``rb`` carried
per rank), and the metric sums and ``bs`` through one exact all-reduce,
so the Decision runs the same on every rank.  The layouts are the
reference's: replicated; ``shard_update`` (ZeRO-1: the optimizer state
lives as flat 1/n shards, each rank updates its slice of every leaf and
the slices are all-gathered back); ``shard_params`` (the weights and
EMA mirrors live as flat shards too, regathered leaf by leaf before
each forward: pure data movement, so it is bit-identical to
``shard_update``).  On the card the collectives run inside the step's
CUDA graphs (an NCCL group is required; the group is warmed by one
eager collective on the step's stream at initialize); on the CPU the
group is gloo.  Each rank's generator is its own stream (rank 0 keeps
the one minted at initialize, so a world of one draws what an ungrouped
step draws).  Snapshots hold param-shaped arrays whatever the layout:
the state is gathered to every rank before a write, and each rank takes
its slice at a restore, at any world size.

Not ported: ``anatomy`` (item 14) raises ``NotImplementedError``;
``donate=False`` raises ``ValueError`` (PyTorch has no donation: the
update always runs in place on the master params).
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
from znicz_tpu_torch.observe import probe as _probe
from znicz_tpu_torch.parallel import mesh as _mesh
from znicz_tpu_torch.parallel import qcomm, zero
from znicz_tpu_torch.parallel.graphs import run_graphed
from znicz_tpu_torch.pipeline import (ready_on_current_stream,
                                      ring_safe_stager)
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


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A item {item})")


def _fold(acc: Optional[dict], metrics: dict) -> dict:
    """``acc + metrics`` key by key in new tensors (``metrics`` may be a
    graph's outputs, which its next replay overwrites)."""
    if acc is None:
        return {k: v.clone() for k, v in metrics.items()}
    return {k: acc[k] + v for k, v in metrics.items()}


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
        if not donate:
            raise ValueError(
                "donate=False has no counterpart: PyTorch has no buffer "
                "donation, and the port's update always runs in place on "
                "the master params")
        if anatomy if anatomy is not None else \
                root.common.engine.get("step_anatomy", False):
            raise _not_ported("anatomy (the split-dispatch step accounting)",
                              "14")
        #: the data mesh (resolved at initialize: None is the whole world)
        self.mesh = mesh
        #: the weights (and EMA mirrors) live as flat 1/n shards between
        #: steps, regathered before each forward; implies shard_update
        self.shard_params = bool(shard_params)
        #: the optimizer state lives as flat 1/n shards; each rank
        #: updates its slice and the slices are all-gathered back
        self.shard_update = bool(shard_update) or self.shard_params
        #: the codec config of the gradient sum and the shard_params
        #: regather (None: root.common.engine.quantized_collectives)
        self.quantized_collectives = quantized_collectives
        #: global-norm gradient clipping of the batch-mean gradient
        self.clip_norm = clip_norm
        #: apply the summed gradients every N train minibatches (and at
        #: the train pass's last)
        self.accumulate_steps = int(accumulate_steps)
        #: Polyak averaging: ``e = d·e + (1-d)·w`` after every update
        self.ema_decay = ema_decay
        #: a whole class pass from its first minibatch (None: resolved
        #: from root.common.engine.scan_epoch when the data set is pinned)
        self.scan_epoch = scan_epoch
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
        self._hyper_sig = None    # the hyperparameters in the buffer
        self._hyper_buf = None    # (layers, HYPER_KEYS) f32 on the device
        self._hyper_views = None  # per-layer dicts of 0-d views into it
        self._graphs = None       # (body, input shapes) -> _StepGraph
        self._stream = None       # the capture stream (cuda only)
        self._h2d_stream = None   # the input pipeline's side stream
        self._cw = None           # the class weights on the device
        self._protos = None       # the class targets on the device
        self._acc = None          # device-side metric sums (deferred mode)
        self._grad_acc = None     # summed grads awaiting their update
        self._bs_acc = None       # their summed sample count
        self._acc_count = 0       # half-steps since the last update
        self._scan_in_flight = False  # the class pass ran from its plan
        self._conf_seen = None    # confusion sums already folded this pass
        self._nt_valid = None     # nearest-target recovery proven valid?
        self._codec = None        # resolved qcomm.Codec (None = exact)
        self._ef = False          # error-feedback residuals rw/rb?
        self._gather_via_psum = False   # the shard_params regather form
        self._zero_gather_nbytes = 0    # bytes gathered a dispatch
        self._zero_gather_counter = None
        self._qcomm_grad_bytes = None   # (wire, exact) a train step
        self._qcomm_gather_bytes = None  # (wire, exact) a dispatch
        self._qcomm_grad_counters = None
        self._qcomm_gather_counters = None
        # metrics the Decision links to (mirrors the evaluator's attrs)
        self.n_err = 0
        self.mse = 0.0
        self.loss = 0.0
        #: host mirror of the summed sample count behind the current
        #: n_err/mse values (the Decision's ``minibatch_size`` link)
        self.minibatch_size = 0

    # -- parameters -----------------------------------------------------------
    #: leaf keys holding optimizer state (flat-sharded under shard_update)
    OPT_STATE_KEYS = ("vw", "vb", "sw", "sb")

    def _put(self, host, dtype=torch.float32) -> torch.Tensor:
        """A device copy of a host array (never a view of it)."""
        return torch.tensor(np.asarray(host), dtype=dtype, device=self._dev)

    def _flat_shard_put(self, host, dtype=torch.float32) -> torch.Tensor:
        """This rank's flat slice of a host array, zero-padded to the
        mesh's multiple (the ZeRO layout of ``zero.pad_slice``), on the
        device."""
        part = zero.pad_slice(torch.from_numpy(np.asarray(host, np.float32)),
                              self.mesh.rank, self.mesh.size)
        return part.to(dtype=dtype, device=self._dev, copy=True)

    def _leaf_sharded(self, k: str) -> bool:
        """Does leaf key ``k`` live as a flat shard?  The one layout
        decision of gather_params, extra_state_arrays, load_extra_state
        and sync_to_units.  (The error-feedback residuals ``rw``/``rb``
        are rank-local and param-shaped: the reference's slab row.)"""
        if k in self.OPT_STATE_KEYS:
            return self.shard_update
        if k in ("w", "b", "ew", "eb"):
            return self.shard_params
        return False

    def _param_shape(self, i: int, key: str) -> tuple:
        fwd = self.forwards[i]
        return tuple((fwd.weights if key.endswith("w") else fwd.bias).shape)

    def _unshard(self, shard: torch.Tensor, shape) -> torch.Tensor:
        """A flat shard's full param-shaped tensor on every rank (one
        all-gather: every rank must call it)."""
        return zero.all_gather_slices(shard, self.mesh, shape).clone()

    def gather_params(self) -> list:
        """The params from the unit Arrays: per layer a dict of f32
        master ``w``/``b``, momentum ``vw``/``vb`` (in ``state_dtype``),
        for adam the second moments ``sw``/``sb`` and the step count
        ``t`` (a 0-d device leaf), the EMA mirrors ``ew``/``eb``, and
        under error feedback the rank's residuals ``rw``/``rb``; each
        leaf in its layout (``_leaf_sharded``)."""
        vdt = self.state_dtype or torch.float32
        put_w = self._flat_shard_put if self.shard_params else self._put
        put_v = self._flat_shard_put if self.shard_update else self._put
        params = []
        for i, (fwd, gd) in enumerate(zip(self.forwards, self.gds)):
            leaf = {k: put_w(arr.map_read())
                    for k, arr in fwd.param_arrays().items()}
            for k, vel in (("w", gd.gradient_weights),
                           ("b", gd.gradient_bias)):
                if k not in leaf:
                    continue
                shape = self._param_shape(i, k)
                leaf["v" + k] = put_v(
                    vel.map_read() if vel else np.zeros(shape), vdt)
                if self.optimizer == "adam":
                    leaf["s" + k] = put_v(np.zeros(shape))
            if self.optimizer == "adam":
                leaf["t"] = torch.zeros((), device=self._dev)
            for k in ("w", "b"):
                if k not in leaf:
                    continue
                if self.ema_decay is not None:
                    # f32 mirrors, seeded with the weights, in their layout
                    leaf["e" + k] = leaf[k].clone()
                if self._ef:
                    leaf["r" + k] = torch.zeros(self._param_shape(i, k),
                                                device=self._dev)
            params.append(leaf)
        return params

    def place_params(self, params: list) -> None:
        """Copy ``params`` (``gather_params``' layout) into the step's
        leaves in place: its captured graphs read those tensors, so they
        replay the new values."""
        for leaf, new in zip(self._params, params, strict=True):
            if leaf.keys() != new.keys():
                raise ValueError(f"param leaf keys {sorted(new)} != the "
                                 f"step's {sorted(leaf)}")
            for k, v in new.items():
                leaf[k].copy_(v)

    def load_generator_state(self, state) -> None:
        """Set the train steps' generator to a saved ``get_state()``
        (uint8).  ``set_state`` writes the seed and offset in place, and
        the captured graphs read the generator's offset at each replay.
        A state of another device's generator (a CPU run's snapshot
        resumed on the card) cannot be set: the step keeps its own
        generator and logs a warning."""
        state = torch.as_tensor(np.asarray(state, np.uint8))
        try:
            self._gen.set_state(state)
        except RuntimeError as exc:
            self.warning(f"the snapshot's generator state ({state.numel()}"
                         f" bytes) does not fit this step's "
                         f"{self._dev.type} generator ({exc}); keeping "
                         f"the generator minted at initialize")
            return
        # the snapshot holds rank 0's generator: the other ranks re-key it
        self._rank_stream()

    def extra_state_arrays(self) -> dict:
        """Optimizer state that has no unit Array home (adam second
        moments and step count, EMA mirrors, error-feedback residuals)
        -> host arrays for the snapshotter under the reference's keys
        (``"{layer}.{key}"``), always in the param shape: sharded leaves
        are all-gathered, and the residuals come as the reference's
        ``(n, *shape)`` slab of every rank's.  A collective: every rank
        calls it.  Every leaf comes down in one device-to-host copy of
        their concatenation, not one sync a leaf."""
        if self._params is None:
            return {}
        keys = []
        if self.optimizer == "adam":
            keys += ["sw", "sb", "t"]
        if self.ema_decay is not None:
            keys += ["ew", "eb"]
        if self._ef:
            keys += ["rw", "rb"]
        dev = {}
        for i, leaf in enumerate(self._params):
            for k in keys:
                if k not in leaf:
                    continue
                t = leaf[k]
                if k in ("rw", "rb"):
                    t = self.mesh.all_gather(t)
                elif self._leaf_sharded(k):
                    t = self._unshard(t, self._param_shape(i, k))
                dev[f"{i}.{k}"] = t
        if not dev:
            return {}
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in dev.values()]).cpu().numpy()
        out, at = {}, 0
        for key, t in dev.items():
            n = t.numel()
            out[key] = flat[at:at + n].reshape(tuple(t.shape)).copy()
            at += n
        return out

    def load_extra_state(self, arrays: dict) -> None:
        """Restore ``extra_state_arrays`` output into the step's leaves
        (after ``place_params`` on resume), in place, each rank taking
        its slice of a sharded leaf.  The residual slab of a snapshot
        taken at another world size is folded: only the rank sum of the
        residuals means anything, and it goes onto rank 0.  Residuals
        restored into a step without error feedback are dropped, as the
        reference drops them."""
        for key, val in arrays.items():
            i, k = key.split(".", 1)
            i = int(i)
            val = np.asarray(val, np.float32)
            if k in ("rw", "rb"):
                if not self._ef:
                    continue
                n = self.mesh.size
                if val.shape[0] != n:
                    folded = np.zeros((n,) + val.shape[1:], np.float32)
                    folded[0] = val.sum(axis=0)
                    val = folded
                val = val[self.mesh.rank]
            leaf = self._params[i]
            if k not in leaf:
                raise ValueError(f"snapshot optimizer state {key!r} has no "
                                 f"leaf in this step")
            want = self._param_shape(i, k) if self._leaf_sharded(k) or \
                k in ("rw", "rb") else tuple(leaf[k].shape)
            if tuple(val.shape) != want:
                raise ValueError(f"{key}: snapshot shape {val.shape} != "
                                 f"step shape {want}")
            if self._leaf_sharded(k):
                leaf[k].copy_(self._flat_shard_put(val))
            else:
                leaf[k].copy_(torch.from_numpy(val))

    def ema_params(self) -> list:
        """Host copies of the averaged weights: a ``{"w": ..., "b": ...}``
        dict a layer, in unit order (regathered from their shards under
        shard_params: every rank calls it)."""
        if self.ema_decay is None:
            raise RuntimeError("ema_decay is not enabled on this step")
        out = []
        for i, leaf in enumerate(self._params):
            layer = {}
            for k in ("ew", "eb"):
                if k in leaf:
                    t = leaf[k]
                    if self._leaf_sharded(k):
                        t = self._unshard(t, self._param_shape(i, k))
                    layer[k[1]] = t.detach().cpu().numpy().copy()
            out.append(layer)
        return out

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
        """Per-layer dicts of 0-d device scalars, views into one f32
        buffer that lives as long as the step: an LR schedule's new
        values are written into it in place, so the kernels (and the
        graphs that captured their pointers) read them at the next
        step."""
        sig = tuple(tuple(h[k] for k in self.HYPER_KEYS)
                    for h in self.hyper_params())
        if self._hyper_buf is None:
            self._hyper_buf = torch.tensor(sig, dtype=torch.float32,
                                           device=self._dev)
            self._hyper_views = [
                {k: self._hyper_buf[i, j]
                 for j, k in enumerate(self.HYPER_KEYS)}
                for i in range(len(sig))]
        elif sig != self._hyper_sig:
            self._hyper_buf.copy_(torch.tensor(sig, dtype=torch.float32))
        self._hyper_sig = sig
        return self._hyper_views

    def sync_to_units(self) -> None:
        """Write copies of the device params back into the unit Arrays
        (snapshot / inspection path; the hot loop never does this),
        regathering sharded leaves to the param shape: every rank calls
        it."""
        for i, (fwd, gd, leaf) in enumerate(
                zip(self.forwards, self.gds, self._params)):
            for k, arr, vel in (("w", fwd.weights, gd.gradient_weights),
                                ("b", fwd.bias, gd.gradient_bias)):
                if k not in leaf:
                    continue
                shape = self._param_shape(i, k)
                w, v = leaf[k], leaf["v" + k]
                if self._leaf_sharded(k):
                    w = self._unshard(w, shape)
                if self._leaf_sharded("v" + k):
                    v = self._unshard(v, shape)
                arr.set_devmem(w.detach().clone())
                vel.set_devmem(v.to(torch.float32, copy=True))

    # -- accounting (the reference's znicz_zero_* and qcomm families) ---------
    def _account_zero_memory(self) -> None:
        """Per-rank persistent-state bytes into ``znicz_zero_param_bytes``
        and ``znicz_zero_opt_state_bytes`` (a shard counts its own bytes,
        padding included), the bytes a ``shard_params`` dispatch gathers,
        and the codec's figures."""
        n = self.mesh.size
        param_b = opt_b = gather_b = 0
        for leaf in self._params:
            for k, v in leaf.items():
                nb = v.numel() * v.element_size()
                if k in ("w", "b"):
                    param_b += nb
                    if self.shard_params:
                        gather_b += nb * n
                else:
                    opt_b += nb
        self._zero_gather_nbytes = gather_b
        _probe.zero_memory(self.name, param_b, opt_b)
        self._zero_gather_counter = _probe.zero_gather_counter(self.name)
        self._account_qcomm()

    def _account_qcomm(self) -> None:
        """Static wire and exact bytes of the quantized collectives: the
        gradient sum a train step, and the shard_params regather a
        dispatch, with the compression-ratio gauges."""
        if self._codec is None:
            return
        n = self.mesh.size
        grad_wire = grad_exact = zg_wire = zg_exact = 0
        for i, leaf in enumerate(self._params):
            for k in ("w", "b"):
                if k not in leaf:
                    continue
                size = int(np.prod(self._param_shape(i, k)))
                grad_wire += qcomm.wire_nbytes(self._codec, size)
                grad_exact += qcomm.exact_nbytes(size)
                if self.shard_params:
                    padded = zero.shard_len(size, n) * n
                    zg_wire += n * qcomm.wire_nbytes(self._codec,
                                                     padded // n)
                    zg_exact += qcomm.exact_nbytes(padded)
        self._qcomm_grad_bytes = (grad_wire, grad_exact)
        self._qcomm_grad_counters = _probe.qcomm_counters(self.name,
                                                          "grad_psum")
        _probe.qcomm_ratio(self.name, "grad_psum", grad_wire, grad_exact)
        if self.shard_params:
            self._qcomm_gather_bytes = (zg_wire, zg_exact)
            self._qcomm_gather_counters = _probe.qcomm_counters(
                self.name, "zero_gather")
            _probe.qcomm_ratio(self.name, "zero_gather", zg_wire, zg_exact)

    def _note_gathered(self, n_steps: int = 1) -> None:
        """Count ``n_steps`` dispatches' regathers under shard_params."""
        if not _probe.enabled():
            return
        if self._zero_gather_nbytes:
            self._zero_gather_counter.inc(
                float(self._zero_gather_nbytes) * n_steps)
        if self._qcomm_gather_bytes:
            for c, nb in zip(self._qcomm_gather_counters,
                             self._qcomm_gather_bytes):
                c.inc(float(nb) * n_steps)

    def _note_qcomm_grads(self, n_steps: int = 1) -> None:
        """Count ``n_steps`` train dispatches' quantized gradient sums."""
        if self._qcomm_grad_bytes and _probe.enabled():
            for c, nb in zip(self._qcomm_grad_counters,
                             self._qcomm_grad_bytes):
                c.inc(float(nb) * n_steps)

    def _publish_residual_norm(self) -> None:
        """The L2 norm of every rank's error-feedback residuals into
        ``znicz_qcomm_residual_norm`` (class-pass cadence; a collective,
        taken on every rank alike)."""
        if not self._ef or not _probe.enabled():
            return
        sq = torch.zeros(1, device=self._dev)
        for leaf in self._params:
            for k in ("rw", "rb"):
                if k in leaf:
                    sq += torch.sum(torch.square(leaf[k]))
        _probe.qcomm_residual_norm(
            self.name, float(torch.sqrt(self.mesh.all_reduce_(sq))))

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
            wrow = fmask if self._cw is None else fmask * self._cw[labels]
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
                if self._protos is None:      # uploaded once
                    self._protos = torch.as_tensor(
                        self.evaluator.class_targets.map_read(),
                        device=out.device)
                protos = self._protos.to(out.dtype)
                nearest = EvaluatorMSE.nearest_prototype
                pred = nearest(torch, out.detach(), protos)
                lab = nearest(torch, target, protos)
                metrics["n_err"] = ((pred != lab) & mask).sum()
            return loss, metrics
        raise TypeError(f"unsupported evaluator {type(self.evaluator)}")

    # -- the step bodies -----------------------------------------------------
    def _trainable(self) -> list:
        """Per layer ``{"w", "b"}`` in the param shape for the forward:
        the master leaves, or under shard_params their regather (one
        all-gather a leaf, in the order the forward uses them)."""
        if not self.shard_params:
            return [{k: leaf[k] for k in ("w", "b") if k in leaf}
                    for leaf in self._params]
        sites = [(i, k) for i, leaf in enumerate(self._params)
                 for k in ("w", "b") if k in leaf]
        full = zero.gather_chain(
            [self._params[i][k] for i, k in sites],
            [self._param_shape(i, k) for i, k in sites], self.mesh,
            via_psum=self._gather_via_psum, codec=self._codec)
        out = [{} for _ in self._params]
        for (i, k), v in zip(sites, full):
            out[i][k] = v
        return out

    def _sum_metrics(self, metrics: dict) -> dict:
        """The metric sums over the mesh, exactly: one all-reduce of
        their f32 concatenation (counts below 2^24 stay exact), each
        cast back to its dtype.  Unchanged without a group."""
        if self.mesh.group is None:
            return metrics
        keys = list(metrics)
        flat = self.mesh.all_reduce_(torch.cat(
            [metrics[k].reshape(-1).to(torch.float32) for k in keys]))
        out, at = {}, 0
        for k in keys:
            v = metrics[k]
            out[k] = flat[at:at + v.numel()].reshape(v.shape).to(v.dtype)
            at += v.numel()
        return out

    def _sum_grads(self, grads: list) -> list:
        """The gradient sums over the mesh through the codec seam: one
        exact all-reduce, or the quantized sum with the rank's
        error-feedback residuals carried into their leaves in place."""
        residuals = None
        if self._ef:
            residuals = [{k: self._params[i]["r" + k] for k in g}
                         for i, g in enumerate(grads)]
        grads, new_res = qcomm.quantized_psum(grads, self.mesh, self._codec,
                                              residuals)
        if new_res is not None:
            for res, new in zip(residuals, new_res):
                for k, v in new.items():
                    res[k].copy_(v)
        return grads

    def _grads_and_metrics(self, x, labels, mask):
        """Forward and autograd backward of this rank's rows -> ``(grads,
        metrics)``: the gradients summed over the mesh a layer and the
        metric sums (device tensors), ``bs`` the masks' sum."""
        trainable = self._trainable()
        leaves = [t for leaf in trainable for t in leaf.values()]
        for t in leaves:
            t.requires_grad_(True)
        try:
            out, logits_tail = self._forward_chain(trainable, x, train=True,
                                                   rng=self._gen)
            loss, metrics = self._loss_and_metrics(out, logits_tail,
                                                   labels, mask)
            flat = iter(torch.autograd.grad(loss, leaves))
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [{k: next(flat) for k in leaf} for leaf in trainable]
        metrics["loss"] = loss.detach()
        metrics["bs"] = mask.sum()
        return self._sum_grads(grads), self._sum_metrics(metrics)

    def _train_step(self, x, labels, mask) -> dict:
        """One minibatch: forward, autograd backward, in-place update.
        Returns the metric sums (device tensors)."""
        grads, metrics = self._grads_and_metrics(x, labels, mask)
        self._apply_update(self._params, grads, self._hyper_device(),
                           metrics["bs"].to(torch.float32))
        return metrics

    def _grads_step(self, x, labels, mask) -> dict:
        """The accumulation half-step: the summed gradients and the
        metric sums, no update."""
        grads, metrics = self._grads_and_metrics(x, labels, mask)
        return {"grads": grads, "metrics": metrics}

    def _eval_step(self, x, labels, mask) -> dict:
        with torch.no_grad():
            out, logits_tail = self._forward_chain(self._trainable(), x,
                                                   train=False)
            _, metrics = self._loss_and_metrics(out, logits_tail, labels,
                                                mask)
        metrics["bs"] = mask.sum()
        return self._sum_metrics(metrics)

    def _batch(self, raw, x=None, labels=None) -> tuple:
        """``(x, labels, mask)`` of a minibatch from its raw indices (-1
        = padding): gathered from the pinned data set, or the ``x`` and
        ``labels`` the loader served."""
        mask = raw >= 0
        if x is None:
            idx = torch.clamp(raw, min=0)
            data, labels_all = self._dataset_dev
            x, labels = data[idx], labels_all[idx]
        return x, labels, mask

    def _train_batch(self, *inputs) -> dict:
        return self._train_step(*self._batch(*inputs))

    def _eval_batch(self, *inputs) -> dict:
        return self._eval_step(*self._batch(*inputs))

    def _grads_batch(self, *inputs) -> dict:
        return self._grads_step(*self._batch(*inputs))

    def _local_rows(self, t):
        """This rank's contiguous rows of a global minibatch input (a
        tensor or a host array: the host paths cut before the copy, so
        a rank uploads only its own rows)."""
        n = self.mesh.size
        if n == 1:
            return t
        b = int(t.shape[0])
        if b % n:
            raise ValueError(f"minibatch {b} not divisible by data-mesh "
                             f"size {n}")
        rows = b // n
        return t[self.mesh.rank * rows:(self.mesh.rank + 1) * rows]

    def _dispatch(self, kind: str, body, *inputs):
        """``body(*inputs)`` on the step's device, where ``inputs`` are
        already this rank's rows (``_local_rows``).  On the CPU the body
        runs eagerly; on the card through :func:`run_graphed`, one graph
        a ``(kind, input shapes)``."""
        self._hyper_device()      # an LR change lands in the buffer first
        if self._graphs is None:
            return body(*(t.to(self._dev) for t in inputs))
        key = (kind,) + tuple((tuple(t.shape), t.dtype) for t in inputs)
        needs_rng = kind != "eval" and any(
            getattr(f, "NEEDS_RNG", False) for f in self.forwards)
        return run_graphed(self._graphs, key, f"fused step's {kind}", body,
                           inputs, self._dev, self._stream,
                           self._gen if needs_rng else None)

    def _update_operands(self, leaf, grad, k) -> tuple:
        """``(w, g)`` the update kernels take for leaf key ``k``: whole
        leaves when replicated; under shard_update this rank's flat
        slices (the weight's own shard under shard_params)."""
        if not self.shard_update:
            return leaf[k], grad[k].contiguous()
        n, rank = self.mesh.size, self.mesh.rank
        g = zero.pad_slice(grad[k], rank, n)
        w = leaf[k] if self.shard_params else \
            zero.pad_slice(leaf[k], rank, n)
        return w, g

    def _apply_update(self, params, grads, hyper, bs) -> None:
        """One optimizer step, in place, for summed gradients ``grads``
        over ``bs`` samples (a device scalar), on the update kernels: on
        whole leaves, or under shard_update on this rank's slices, which
        are then all-gathered back into the replicated weights (under
        shard_params the updated slice is the weight's layout)."""
        if self.clip_norm is not None:
            # clip the batch-mean gradient's GLOBAL norm across layers;
            # scaling the sums by the same factor is equivalent
            sq = sum(torch.sum(torch.square(g / bs))
                     for leaf in grads for g in leaf.values())
            scale = torch.clamp(self.clip_norm / torch.clamp(
                torch.sqrt(sq), min=1e-12), max=1.0)
            grads = [{k: v * scale for k, v in leaf.items()}
                     for leaf in grads]
        updated = []              # (leaf, k, the updated w operand)
        if self.optimizer == "adam":
            # every leaf (or shard) of the step, w and b of each layer, in
            # one call
            b1, b2, eps = self._adam_consts
            leaves = []
            for leaf, grad, h in zip(params, grads, hyper):
                leaf["t"].add_(1.0)
                # bias corrections on the device, outside the kernel
                c1, c2 = 1.0 - b1 ** leaf["t"], 1.0 - b2 ** leaf["t"]
                for k, lr, wd in (("w", "lr", "wd"), ("b", "lr_b", "wd_b")):
                    if k in leaf:
                        w, g = self._update_operands(leaf, grad, k)
                        leaves.append((w, g, leaf["v" + k], leaf["s" + k],
                                       h[lr], h[wd], c1, c2))
                        updated.append((leaf, k, w))
            koptim.adam_update_multi_(leaves, b1, b2, eps, bs)
        else:
            for leaf, grad, h in zip(params, grads, hyper):
                for k, lr, wd, mom in (("w", "lr", "wd", "mom"),
                                       ("b", "lr_b", "wd_b", "mom_b")):
                    if k in leaf:
                        w, g = self._update_operands(leaf, grad, k)
                        koptim.sgd_update_(w, g, leaf["v" + k], h[lr],
                                           h[wd], h["l1"], h[mom], bs)
                        updated.append((leaf, k, w))
        if self.shard_update and not self.shard_params:
            # the post-update regather: pure data movement
            for leaf, k, w in updated:
                leaf[k].copy_(zero.all_gather_slices(w, self.mesh, leaf[k]))
        if self.ema_decay is not None:
            # the reference's order: d * e + (1 - d) * w, each product
            # rounded to f32, with d and 1 - d as f32 constants
            d = np.float32(self.ema_decay)
            rest = float(np.float32(1.0) - d)
            for leaf in params:
                for k in ("w", "b"):
                    if k in leaf:
                        leaf["e" + k].mul_(float(d)).add_(leaf[k] * rest)

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
        self.mesh = _mesh.resolve(self.mesh)
        _mesh.check_backend(self.mesh, self._dev)
        n_data = self.mesh.size
        if self.loader is not None and \
                int(self.loader.max_minibatch_size) % n_data != 0:
            raise ValueError(
                f"minibatch {self.loader.max_minibatch_size} not divisible "
                f"by data-mesh size {n_data}")
        if self.compute_dtype is None:
            self.compute_dtype = getattr(device, "compute_dtype", None) or \
                backends.resolve_compute_dtype(self._dev.type)
        # the regather's form and the codec, before gather_params: the
        # residual leaves must exist in the params
        self._gather_via_psum = bool(root.common.engine.get(
            "zero_gather_via_psum", False))
        self._codec = qcomm.resolve(self.quantized_collectives)
        self._ef = self._codec is not None and self._codec.error_feedback
        self._params = self.gather_params()
        self._account_zero_memory()
        # one generator for every train step's draws, minted whether or
        # not a forward draws, as the reference mints its key; a stream
        # of its own on every rank but 0, as the reference folds the rank
        # into each step's key
        self._gen = prng.get().key(self._dev)
        self._rank_stream()
        if self.optimizer == "adam":
            cfg = self.optimizer_config
            self._adam_consts = tuple(
                torch.tensor(float(cfg[k]), device=self._dev)
                for k in ("beta1", "beta2", "eps"))
        cw = getattr(self.evaluator, "class_weights", None)
        self._cw = None if cw is None else torch.as_tensor(cw,
                                                           device=self._dev)
        self._hyper_device()
        if self._dev.type == "cuda":
            self._graphs = {}
            self._stream = torch.cuda.Stream(self._dev)
            self._h2d_stream = torch.cuda.Stream(self._dev)
            if self.mesh.group is not None:
                # one eager collective on the step's stream: the group's
                # communicator exists before the first capture
                self._stream.wait_stream(torch.cuda.current_stream(self._dev))
                with torch.cuda.stream(self._stream):
                    self.mesh.all_reduce_(torch.zeros(1, device=self._dev))
                torch.cuda.current_stream(self._dev).wait_stream(self._stream)
        self._pin_dataset()
        if self.scan_epoch and self._dataset_dev is not None:
            self._refuse_per_minibatch_schedules()
        self.initialized = True

    def _refuse_per_minibatch_schedules(self) -> None:
        """In epoch-scan mode the hyperparams are read once per class
        pass, so a per-MINIBATCH LR schedule would silently coarsen to
        per-pass granularity: refuse it, as the reference does."""
        from znicz_tpu_torch.units.lr_adjust import LearningRateAdjust
        gd_ids = {id(gd) for gd in self.gds}
        offenders = [
            u.name for u in (self.workflow.units if self.workflow else [])
            if isinstance(u, LearningRateAdjust) and not u.by_epoch
            and any(id(gd) in gd_ids for gd, _, _ in u._gd_units)]
        if offenders:
            raise ValueError(
                f"scan_epoch compiles a whole class pass into one "
                f"dispatch reading hyperparams once, so the "
                f"per-minibatch (by_epoch=False) LearningRateAdjust "
                f"unit(s) {offenders} would silently coarsen to "
                f"per-pass schedules; use by_epoch=True or disable "
                f"scan_epoch")

    def _rank_stream(self) -> None:
        """Re-key the step's generator for this rank (rank 0 keeps it):
        a seed derived from its seed and the rank, at its offset where the
        generator has one (a CUDA generator: every rank draws as much a
        step, so a restored offset is every rank's)."""
        rank = self.mesh.rank
        if rank == 0:
            return
        gen = self._gen
        try:
            offset = gen.get_offset()
        except RuntimeError:          # a CPU generator has none
            offset = None
        gen.manual_seed(int(np.random.SeedSequence(
            (gen.initial_seed(), rank)).generate_state(1, np.uint64)[0]))
        if offset is not None:
            gen.set_offset(offset)

    def _pin_dataset(self) -> None:
        """Place a full-batch dataset on the device so the hot loop ships
        only minibatch INDICES.  Gated on size
        (``root.common.engine.dataset_on_device_max_bytes``, default 1
        GiB)."""
        pinned, self._dataset_dev = self._dataset_dev, None
        data_arr, labels_arr, _why = full_batch_arrays(
            self.loader, mse=isinstance(self.evaluator, EvaluatorMSE))
        if data_arr is None:
            return
        limit = int(root.common.engine.get(
            "dataset_on_device_max_bytes", 1 << 30))
        data = np.asarray(data_arr.mem, np.float32)
        if data.nbytes > limit:
            return
        host = (torch.from_numpy(data),
                torch.from_numpy(np.asarray(labels_arr.mem)))
        if pinned is not None:
            # a re-pin (a restore): into the tensors the captured graphs
            # gather from
            for d, h in zip(pinned, host):
                d.copy_(h)
            self._dataset_dev = pinned
        else:
            self._dataset_dev = tuple(h.to(self._dev, copy=True)
                                      for h in host)
        # the loader now serves indices only
        self.loader.serve_indices_only = True
        if self.scan_epoch is None:
            self.scan_epoch = bool(root.common.engine.get("scan_epoch",
                                                          False))
        if self.scan_epoch and self.accumulate_steps > 1:
            raise ValueError("accumulate_steps > 1 is a per-minibatch "
                             "mode; disable scan_epoch to use it")
        if self.scan_epoch:
            # the plan of each class pass, captured at its first serve
            self.loader.capture_class_plan = True

    def train_steps(self, xs, ys, masks) -> dict:
        """Run ``xs.shape[0]`` training minibatches in one call and
        return the summed metric dict (device tensors).  ``xs``/``ys``/
        ``masks`` carry a leading step axis; on the card each minibatch
        is one replay of the step's graph (the reference scans them in
        one program)."""
        if self.accumulate_steps > 1:
            raise ValueError("train_steps applies the optimizer per "
                             "minibatch; accumulate_steps > 1 requires "
                             "the per-minibatch run() path")
        total = None
        for k in range(int(xs.shape[0])):
            total = _fold(total, self._dispatch(
                "steps", self._train_step,
                *(self._local_rows(t) for t in (xs[k], ys[k], masks[k]))))
        self._note_gathered(int(xs.shape[0]))
        self._note_qcomm_grads(int(xs.shape[0]))
        return total

    # -- input-pipeline staging ---------------------------------------------
    def make_stager(self):
        """Producer-side staging callable for the input pipeline
        (``znicz_tpu_torch.pipeline``): copies the NEXT batch's step
        inputs to the step's device while the current step runs, so the
        host-to-device copy hides under device compute.  Signature:
        ``stage(record, arrays) -> (staged_dict, nbytes)``.

        The staged inputs are the ones the synchronous ``run`` uploads,
        in the same dtypes and shapes, so the step's graphs see the same
        keys and capture nothing new: the raw indices (-1 = padding; the
        mask and the gather indices are made from them on the device, as
        the reference stages its idx and mask) and, when the data set is
        not pinned, the f32 rows and the labels or targets, all in one
        staging call.  In ``scan_epoch`` mode the class pass runs from
        its plan and nothing is staged, ``(None, 0)``.  On the card the
        copies run on the step's side stream from the loader's pinned
        ring slots, handed off through
        :func:`~znicz_tpu_torch.pipeline.ring_safe_stager`.  The stager
        is made before ``initialize``, so it reads the device and the
        side stream at each call."""
        def put(*host):
            out = []
            for a in host:
                t = torch.from_numpy(a)
                d = torch.empty(t.shape, dtype=t.dtype, device=self._dev)
                out.append(d.copy_(t, non_blocking=True))
            if len(out) > 1:
                # the rows in f32, as the synchronous path uploads them
                out[1] = out[1].to(torch.float32)
            return tuple(out)

        def stage(rec, arrays):
            if self.scan_epoch and self._dataset_dev is not None:
                # the class pass runs from its plan: per-minibatch
                # staging would be dead device buffers (the pipeline
                # still overlaps the shuffle and plan work)
                return None, 0
            host = (rec["indices"],)
            if self._dataset_dev is None:
                y = arrays["targets" if isinstance(
                    self.evaluator, EvaluatorMSE) else "labels"]
                host += (arrays["data"], y)
            host = tuple(self._local_rows(a) for a in host)
            inputs, event = ring_safe_stager(put, self._dev,
                                             self._h2d_stream)(*host)
            return ({"inputs": inputs, "event": event},
                    sum(a.nbytes for a in host))

        return stage

    # -- per-minibatch control callback -------------------------------------
    def run(self) -> None:
        loader = self.loader
        # pipelined feeding: the step inputs were copied to the device by
        # the prefetch worker — consume them instead of re-shipping the
        # host copies
        staged = loader.take_staged() \
            if getattr(loader, "pipeline", None) is not None else None
        if self.scan_epoch and self._dataset_dev is not None and \
                (int(loader.minibatch_offset) == 0 or
                 self._scan_in_flight):
            self._run_scanned_class(loader)
            return
        # (a class pass entered mid-way falls through to the
        # per-minibatch path for the rest of it)
        if staged is not None:
            inputs = staged["inputs"]
            ready_on_current_stream(inputs, staged["event"])
        else:
            inputs = self._host_inputs(loader)
        if int(loader.minibatch_class) != TRAIN:
            metrics = self._dispatch("eval", self._eval_batch, *inputs)
        elif self.accumulate_steps > 1:
            metrics = self._accumulate(
                self._dispatch("grads", self._grads_batch, *inputs), loader)
            self._note_qcomm_grads()
        else:
            metrics = self._dispatch("train", self._train_batch, *inputs)
            self._note_qcomm_grads()
        self._finish_run(loader, metrics)

    def _host_inputs(self, loader) -> tuple:
        """The synchronous path's step inputs from the loader's published
        host arrays: one upload a step of the raw indices (-1 = padding;
        the mask and the clamped gather indices are made on the device),
        plus the f32 rows and the labels or targets when the data set is
        not pinned; each cut to this rank's rows before the upload."""
        def rows(arr):
            return self._local_rows(np.asarray(arr.mem))
        inputs = (torch.from_numpy(rows(loader.minibatch_indices)),)
        if self._dataset_dev is None:
            lab = loader.minibatch_targets if isinstance(
                self.evaluator, EvaluatorMSE) else loader.minibatch_labels
            inputs += (torch.as_tensor(rows(loader.minibatch_data),
                                       dtype=torch.float32),
                       torch.from_numpy(rows(lab)))
        return inputs

    def _accumulate(self, half: dict, loader) -> dict:
        """Fold a half-step's summed gradients into the device
        accumulator; apply the update every ``accumulate_steps`` train
        minibatches and at the END of a train pass (a ragged tail must
        not leak into the next epoch's first update).  Returns the
        half-step's metrics."""
        grads, metrics = half["grads"], half["metrics"]
        if self._grad_acc is None:
            self._grad_acc = [{k: g.clone() for k, g in leaf.items()}
                              for leaf in grads]
            self._bs_acc = metrics["bs"].clone()
        else:
            for acc, leaf in zip(self._grad_acc, grads):
                for k, g in leaf.items():
                    acc[k].add_(g)
            self._bs_acc += metrics["bs"]
        self._acc_count += 1
        if self._acc_count >= self.accumulate_steps or loader.last_minibatch:
            self._apply_update(self._params, self._grad_acc,
                               self._hyper_device(),
                               self._bs_acc.to(torch.float32))
            self._grad_acc = None
            self._bs_acc = None
            self._acc_count = 0
        return metrics

    def _run_scanned_class(self, loader) -> None:
        """Epoch-scan mode: the first minibatch of a class pass uploads
        the pass's plan once and runs the step once a plan row (one
        replay each on the card), summing the metrics on the device; the
        control loop keeps iterating and the sums land at the pass's last
        minibatch, the "virtual minibatch" the Decision sees in deferred
        mode."""
        if int(loader.minibatch_offset) == 0:
            plan = torch.from_numpy(loader.class_plan())
            if self._dev.type == "cuda":      # one upload, not waited for
                plan = plan.pin_memory()
            plan = plan.to(self._dev, non_blocking=True)
            kind, body = ("train", self._train_batch) \
                if int(loader.minibatch_class) == TRAIN \
                else ("eval", self._eval_batch)
            acc = None
            for row in plan:
                acc = _fold(acc, self._dispatch(kind, body,
                                                self._local_rows(row)))
            if kind == "train":
                self._note_qcomm_grads(int(plan.shape[0]))
            self._note_gathered(int(plan.shape[0]))
            self._acc = acc
            self._scan_in_flight = True
        if loader.last_minibatch:
            self._publish(_to_host(self._acc), cumulative=True)
            self._acc = None
            self._conf_seen = None
            self._scan_in_flight = False
            self._publish_residual_norm()
        else:
            self._zero_published()

    def _finish_run(self, loader, metrics) -> None:
        # one dispatch (train, half-step or eval) = one regather under
        # shard_params
        self._note_gathered()
        if loader.last_minibatch:
            self._publish_residual_norm()
        # chaos hook (site "step.params"): NaN-poisons the params — the
        # observable effect of NaN gradients — in place, since the
        # captured graphs read these tensors
        poisoned = poison_hook("step.params", self._params)
        if poisoned is not self._params:
            for leaf, bad in zip(self._params, poisoned):
                for k, v in leaf.items():
                    v.copy_(bad[k])
        if not self.defer_metrics:
            self._publish(_to_host(metrics))
            return
        # deferred mode: fold into the device-side sums (no host sync) and
        # fetch only at the end of the class pass
        self._acc = _fold(self._acc, metrics)
        if loader.last_minibatch:
            self._publish(_to_host(self._acc), cumulative=True)
            self._acc = None
            self._conf_seen = None
        else:
            self._zero_published()

    def _zero_published(self) -> None:
        """Non-final minibatches contribute zero to the Decision's
        accumulators; the class-pass totals land in one shot."""
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
