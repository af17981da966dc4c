"""Kohonen SOM units — the port of ``znicz_tpu/units/kohonen.py``
(rebuild of veles.znicz kohonen.py :: KohonenBase, KohonenForward,
KohonenTrainer, plus the sample's decision logic).

Unsupervised winner-take-all with Gaussian neighbourhood decay; no
gradient pair.  ``KohonenTrainer`` owns the ``(sy*sx, n_input)`` weights
and performs the batched update; ``KohonenForward`` emits winner indices
(and hit counts) from the shared weights; ``KohonenDecision`` stops on
max_epochs or when the epoch's weight movement ``|ΔW|/|W|`` stabilizes.

On the torch path every SOM step is :func:`kernels.kohonen.som_step`: the
hand-written kernel on CUDA tensors (the reference's route under
``engine.pallas``; the port has no switch), its plain version on CPU
tensors.  With ``root.common.engine.scan_epoch`` the trainer pins the
loader's dataset on the device and, at the first minibatch of each class
pass, launches the whole pass as one host loop of steps with no
synchronisation inside, computing ``|ΔW|/|W|`` on the device; the
decision fetches that one scalar an epoch (``scan_delta_dev``).  The
winners of ``KohonenForward`` stay plain torch, as the reference's
``_winners_jit`` is jnp.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.kernels import kohonen as ksom
from znicz_tpu_torch.loader.base import plan_device_arrays
from znicz_tpu_torch.ops import kohonen as k_ops
from znicz_tpu_torch.units.decision import DecisionBase


class KohonenBase(AcceleratedUnit):
    """Shared geometry (reference: kohonen.py :: KohonenBase)."""

    def __init__(self, workflow=None, shape=(8, 8), **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.sy, self.sx = int(shape[0]), int(shape[1])
        self.input = Array()
        self.weights = Array()

    @property
    def n_neurons(self) -> int:
        return self.sy * self.sx

    def _flat_input(self, mem):
        return mem.reshape(mem.shape[0], -1)


class KohonenTrainer(KohonenBase):
    """Reference: kohonen.py :: KohonenTrainer.

    ``gradient_decay``/``radius_decay``: per-epoch multiplicative decay of
    the learning rate and neighbourhood radius."""

    def __init__(self, workflow=None, shape=(8, 8), alpha: float = 0.5,
                 alpha_min: float = 0.01, gradient_decay: float = 0.95,
                 radius: float = None, radius_min: float = 0.5,
                 radius_decay: float = 0.95, **kwargs) -> None:
        super().__init__(workflow, shape=shape, **kwargs)
        self.alpha0 = float(alpha)
        self.alpha_min = float(alpha_min)
        self.gradient_decay = float(gradient_decay)
        self.radius0 = float(radius if radius is not None
                             else max(self.sy, self.sx) / 2.0)
        self.radius_min = float(radius_min)
        self.radius_decay = float(radius_decay)
        self.epoch_number = 0            # data-linked from the loader
        self.epoch_ended = False         # data-linked from the loader
        self.winners = Array()
        self._coords_np = None
        #: optional loader reference enabling epoch-scan mode: one host
        #: loop of SOM steps per class pass over the device-pinned
        #: dataset, launched at the pass's first minibatch.  Resolved
        #: from ``root.common.engine.scan_epoch`` at torch_init when None
        self.loader = None
        self.scan_epoch = None
        self._dataset_dev = None         # set when the scan mode is on
        self._coords_dev = None
        self._scan_in_flight = False     # current class pass scanned
        #: device scalar |ΔW|/|W| of the last scanned pass, fetched by
        #: KohonenDecision (one device-to-host copy an epoch)
        self.scan_delta_dev = None
        #: weights as of the START of the current epoch, for the decision's
        #: |ΔW| on the per-minibatch path (its own capture point runs after
        #: this unit and would miss the first minibatch's movement)
        self.epoch_start_weights = None
        self._snap_epoch = None

    @property
    def _schedule_epoch(self) -> int:
        """The epoch the CURRENT minibatch belongs to: the loader
        increments ``epoch_number`` while serving the last minibatch of an
        epoch, before this unit runs on it."""
        e = int(self.epoch_number)
        if bool(getattr(self, "epoch_ended", False)):
            e = max(e - 1, 0)
        return e

    @property
    def alpha(self) -> float:
        return max(self.alpha0 * self.gradient_decay ** self._schedule_epoch,
                   self.alpha_min)

    @property
    def radius(self) -> float:
        return max(self.radius0 * self.radius_decay ** self._schedule_epoch,
                   self.radius_min)

    def _common_init(self, **kwargs) -> None:
        dim = int(np.prod(self.input.shape[1:]))
        if not self.weights:
            self.weights.mem = prng.get().normal(
                0.0, 0.1, (self.n_neurons, dim))
        if not self.winners or len(self.winners) != self.input.shape[0]:
            self.winners.reset(shape=(self.input.shape[0],), dtype=np.int32)
        self._coords_np = np.asarray(k_ops.grid_coords(np, self.sy, self.sx))
        self.init_array(self.input, self.weights, self.winners)

    def _maybe_snapshot_epoch_start(self) -> None:
        e = self._schedule_epoch
        if self._snap_epoch != e:
            self.epoch_start_weights = np.asarray(
                self.weights.map_read()).copy()
            self._snap_epoch = e

    def _mask(self, n):
        bs = self.current_batch_size(self.input)
        if bs >= n:
            return None
        return np.arange(n) < bs

    def numpy_run(self) -> None:
        self._maybe_snapshot_epoch_start()
        x = self._flat_input(self.input.mem)
        mask = self._mask(x.shape[0])
        new_w, idx = k_ops.update(np, x, self.weights.mem, self._coords_np,
                                  self.alpha, self.radius, mask)
        self.weights.map_invalidate()
        self.weights.mem = new_w
        self.winners.map_invalidate()
        self.winners.mem = idx.astype(np.int32)

    def torch_init(self) -> None:
        self._coords_dev = torch.as_tensor(
            self._coords_np, device=self.device.torch_device)
        self._maybe_enable_scan()

    def _maybe_enable_scan(self) -> None:
        """Pin the loader's full-batch dataset on the device for the
        per-class-pass scan (class-plan padding sits at the tail, so each
        step's ``bs`` mask stays valid)."""
        from znicz_tpu_torch.core.config import root

        if self.scan_epoch is None:
            self.scan_epoch = bool(root.common.engine.get("scan_epoch",
                                                          False))
        loader = self.loader
        data_arr = getattr(loader, "original_data", None)
        if not self.scan_epoch or loader is None or not data_arr:
            return
        if getattr(loader, "augmenting", False):
            # per-serve augmentation is data-dependent: the pinned scan
            # would silently train on the raw uncropped dataset
            return
        data = np.asarray(data_arr.mem, np.float32)
        data = data.reshape(data.shape[0], -1)
        limit = int(root.common.engine.get(
            "dataset_on_device_max_bytes", 1 << 30))
        if data.nbytes > limit:
            return
        self._dataset_dev = torch.as_tensor(
            data, device=self.device.torch_device)
        loader.capture_class_plan = True
        # the loader keeps filling minibatch_data: KohonenForward and the
        # mid-pass fallback below read it

    def _scan_pass(self) -> None:
        """The whole class pass: one som_step per minibatch of the plan,
        launched back to back (the counterpart of the reference's
        ``lax.scan``), then ``|ΔW|/|W|`` on the device."""
        idxs, counts = plan_device_arrays(self.loader.class_plan(),
                                          self._dataset_dev.device)
        self.weights.unmap()
        w0 = w = self.weights.devmem
        alpha, radius = self.alpha, self.radius
        for i, bs in enumerate(counts.tolist()):
            w, _ = ksom.som_step(self._dataset_dev[idxs[i]], w,
                                 self._coords_dev, alpha, radius, bs)
        self.weights.set_devmem(w)
        self.scan_delta_dev = (w - w0).abs().sum() / \
            w0.abs().sum().clamp_min(1e-12)

    def torch_run(self) -> None:
        if self._dataset_dev is not None and \
                (int(self.loader.minibatch_offset) == 0 or
                 self._scan_in_flight):
            # epoch-scan mode: the WHOLE class pass at its first minibatch;
            # its later minibatches are no-ops (the loader still serves
            # them).  ``winners`` is not updated per minibatch here
            if int(self.loader.minibatch_offset) == 0:
                self._scan_pass()
                self._scan_in_flight = True
            if self.loader.last_minibatch:
                self._scan_in_flight = False
            return
        # per-minibatch path: also the fallback for a class pass entered
        # mid-way (restored loader state after a resume)
        self._maybe_snapshot_epoch_start()
        self.input.unmap()
        self.weights.unmap()
        x = self.input.devmem
        new_w, idx = ksom.som_step(
            x.reshape(x.shape[0], -1).float().contiguous(),
            self.weights.devmem, self._coords_dev, self.alpha, self.radius,
            self.current_batch_size(self.input))
        self.weights.set_devmem(new_w)
        self.winners.set_devmem(idx)


class KohonenForward(KohonenBase):
    """Reference: kohonen.py :: KohonenForward — winner index per sample
    (+ hit counts for the SOM plotters); weights linked from the trainer."""

    def __init__(self, workflow=None, shape=(8, 8), compute_hits: bool = True,
                 **kwargs) -> None:
        super().__init__(workflow, shape=shape, **kwargs)
        self.output = Array()
        self.compute_hits = compute_hits
        self.hits = None

    def _common_init(self, **kwargs) -> None:
        if not self.output or len(self.output) != self.input.shape[0]:
            self.output.reset(shape=(self.input.shape[0],), dtype=np.int32)
        if self.compute_hits and self.hits is None:
            self.hits = np.zeros(self.n_neurons, np.int64)
        self.init_array(self.input, self.weights, self.output)

    def _count_hits(self, idx) -> None:
        if self.compute_hits:
            bs = self.current_batch_size(self.input)
            self.hits += np.bincount(np.asarray(idx)[:bs],
                                     minlength=self.n_neurons)

    def numpy_run(self) -> None:
        x = self._flat_input(self.input.mem)
        idx = k_ops.winners(np, x, self.weights.mem).astype(np.int32)
        self.output.map_invalidate()
        self.output.mem = idx
        self._count_hits(idx)

    def torch_run(self) -> None:
        self.input.unmap()
        self.weights.unmap()
        x = self.input.devmem
        idx = k_ops.winners(torch, x.reshape(x.shape[0], -1),
                            self.weights.devmem).to(torch.int32)
        self.output.set_devmem(idx)
        if self.compute_hits:
            self._count_hits(idx.cpu().numpy())


class KohonenDecision(DecisionBase):
    """Epoch bookkeeping for SOM training: the metric is the epoch's weight
    movement ``|ΔW|/|W|``; stops on max_epochs or when the movement falls
    below ``min_delta`` (the reference sample's stop logic)."""

    def __init__(self, workflow=None, min_delta: float = 1e-4,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.min_delta = float(min_delta)
        self.trainer = None
        self._epoch_start_w = None
        self.weights_delta = 0.0

    def accumulate(self, cls: int) -> None:
        if getattr(self.trainer, "scan_delta_dev", None) is not None:
            return            # the metric rides the scanned pass
        if self._epoch_start_w is None:
            pre = getattr(self.trainer, "epoch_start_weights", None)
            self._epoch_start_w = pre.copy() if pre is not None \
                else self.trainer.weights.map_read().copy()

    def finalize_class(self, cls: int) -> float:
        delta_dev = getattr(self.trainer, "scan_delta_dev", None)
        if delta_dev is not None:
            # scan mode: ONE scalar device-to-host copy is the epoch's fence
            self.weights_delta = float(delta_dev)
            self.trainer.scan_delta_dev = None
            return self.weights_delta
        w = self.trainer.weights.map_read()
        denom = max(float(np.abs(self._epoch_start_w).sum()), 1e-12)
        self.weights_delta = float(
            np.abs(w - self._epoch_start_w).sum()) / denom
        return self.weights_delta

    def reset_epoch(self) -> None:
        self._epoch_start_w = None

    def run(self) -> None:
        super().run()
        if bool(self.epoch_ended) and self.weights_delta < self.min_delta:
            self.complete.set(True)

    def on_epoch_logged(self) -> None:
        self.info(f"epoch {int(self.epoch_number)}: weights delta "
                  f"{self.weights_delta:.6f}")
