"""Loader base — the port of ``znicz_tpu/loader/base.py`` (rebuild of
veles/loader/base.py :: Loader).

Epoch structure (reference semantics): each epoch serves the sample
classes in order TEST -> VALID -> TRAIN, in fixed-size minibatches; only
the train set is reshuffled (deterministically, via prng) at each epoch
start.  ``last_minibatch`` marks the final minibatch of a class pass;
``epoch_ended`` flips when the train pass finishes and ``epoch_number``
increments.

Static-shape policy: the served arrays always have ``max_minibatch_size``
rows; a short tail is padded and the true row count exposed as
``minibatch_size`` — evaluator/GD mask/divide by it.

``register_loader`` / ``get_loader`` keep the registry behind
``StandardWorkflow``'s ``loader_name`` lookup, under the reference's
names.

The class-plan capture (``capture_class_plan``, :meth:`Loader.class_plan`,
:func:`plan_device_arrays`) serves the SOM trainer's and the fused
step's epoch scans.

The prefetch pipeline's hooks (``znicz_tpu_torch/pipeline``): the
producer runs :meth:`Loader._next_record` -> :meth:`Loader.fill_batch`
-> :meth:`Loader._complete_record` on its worker, filling rotating ring
buffers (:meth:`Loader._next_buffer`); the consumer publishes each
batch's record (:meth:`Loader._consume_prefetched`) and the step takes
the staged device tensors (:meth:`Loader.take_staged`).  On the card
each ring slot is pinned host memory, so the stager's host-to-device
copy is truly asynchronous and needs no staging copy of its own.
:meth:`Loader.state_dict` / :meth:`Loader.load_state_dict` carry the
serving cursor and re-arm the pipeline on a restore.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit

#: sample classes (reference: veles/loader/base.py :: CLASS_NAMES order)
TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAMES = ("test", "validation", "train")

#: loader registry behind StandardWorkflow's ``loader_name`` lookup
#: (reference: veles/loader/base.py registry consumed by
#: standard_workflow.py :: StandardWorkflowBase)
LOADER_REGISTRY: dict[str, type] = {}


def register_loader(name: str):
    """Class decorator: register under ``name`` for loader_name lookup."""
    def deco(cls):
        LOADER_REGISTRY[name] = cls
        cls.LOADER_NAME = name
        return cls
    return deco


def get_loader(name: str) -> type:
    try:
        return LOADER_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown loader {name!r}; registered: "
                       f"{sorted(LOADER_REGISTRY)}") from None


def plan_device_arrays(plan: np.ndarray, device):
    """Class plan -> ``(idxs, counts)`` for a scanned pass: int64 row
    indices on ``device`` with the -1 padding clamped to row 0, and each
    step's count of real rows on the host (the reference's mask sum,
    which the SOM step takes as ``bs`` without a device round trip)."""
    idxs = torch.as_tensor(np.maximum(plan, 0), device=device)
    return idxs, (plan >= 0).sum(axis=1)


class Loader(AcceleratedUnit):
    """Minibatch server over an abstract dataset."""

    def __init__(self, workflow=None, minibatch_size: int = 100,
                 shuffle_limit: Optional[int] = None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.max_minibatch_size = int(minibatch_size)
        #: epochs to keep shuffling for (None = always; 0 = never)
        self.shuffle_limit = shuffle_limit
        # served state (data-linked by downstream units)
        self.minibatch_data = Array()
        self.minibatch_labels = Array()
        self.minibatch_targets = Array()
        self.minibatch_indices = Array()
        self.minibatch_size = 0          # true (unpadded) row count
        self.minibatch_class = TRAIN
        self.minibatch_offset = 0
        self.last_minibatch = False
        self.epoch_number = 0
        self.epoch_ended = False
        #: set by FusedTrainStep._pin_dataset: the consumer reads only
        #: minibatch_indices, so skip per-step data gather/upload
        self.serve_indices_only = False
        #: set by KohonenTrainer's epoch scan: capture the class plan at
        #: each class start (dead work for everyone else)
        self.capture_class_plan = False
        self._current_plan = None        # captured at each class start
        #: attached BatchPrefetcher (znicz_tpu_torch.pipeline) — when set,
        #: run() consumes prefetched batches instead of serving
        self.pipeline = None
        #: the pipeline's staged payload for the CURRENT batch (taken
        #: one-shot by the step via take_staged)
        self.staged = None
        # dataset geometry, set by load_data()
        self.class_lengths = [0, 0, 0]
        self._position = 0               # offset within current class
        self._class = TEST
        self._epoch = 0                  # private epoch cursor: epoch_number
        #                                  is its published mirror (the
        #                                  pipeline producer advances this;
        #                                  only the consumer writes publics)
        self._shuffled: dict[int, np.ndarray] = {}
        self._rings: dict[str, dict] = {}   # fill_batch rotating buffers

    # -- override points ----------------------------------------------------
    def load_data(self) -> None:
        """Set ``class_lengths`` and prepare backing storage."""
        raise NotImplementedError

    def create_minibatch_data(self) -> None:
        """Allocate ``minibatch_data`` (and labels/targets if served)."""
        raise NotImplementedError

    def fill_minibatch(self) -> None:
        """Copy rows selected by ``minibatch_indices`` into the served
        arrays; indices beyond ``minibatch_size`` are -1 (padding)."""
        raise NotImplementedError

    def fill_batch(self, indices: np.ndarray, count: int, cls: int) -> dict:
        """Pipeline-producer fill: gather the rows selected by ``indices``
        (-1 = padding, zeroed) of the minibatch class ``cls`` into
        PRODUCER-OWNED buffers and return them as ``{"data": ...,
        "labels": ..., "targets": ...}`` (present keys only).  Unlike
        :meth:`fill_minibatch` this must not touch the published
        ``minibatch_*`` attributes — it runs on the prefetch worker while
        downstream units still read the previous batch.
        Implementations use :meth:`_next_buffer` so the staging ring owns
        buffer lifetimes."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement fill_batch — the "
            f"prefetch pipeline needs a producer-side fill that leaves "
            f"the published minibatch_* attributes alone")

    def _next_buffer(self, key: str, shape: tuple, dtype) -> np.ndarray:
        """Rotating preallocated buffer for ``fill_batch``: the ring holds
        ``pipeline.depth + 2`` slots (queue depth + the batch in flight +
        the one being consumed), so a buffer is reused only after its
        batch has fully left the pipeline.  On the card each slot is
        pinned host memory (``torch.empty(..., pin_memory=True)`` viewed
        as numpy), the source the stager's asynchronous copy needs.
        Rotation requires a slot-detaching stager (ring_safe_stager's
        copy or fence); a stager-less pipeline hands raw host buffers to
        the consumer, so it gets a fresh buffer per serve instead."""
        if self.pipeline is None or not self.pipeline.detaches_slots:
            return np.empty(shape, dtype)
        slots = self.pipeline.depth + 2
        ring = self._rings.setdefault(key, {"bufs": [], "i": 0})
        bufs = ring["bufs"]
        if len(bufs) < slots:
            bufs.append(self._ring_slot(shape, dtype))
            return bufs[-1]
        buf = bufs[ring["i"] % slots]
        ring["i"] += 1
        return buf

    def _ring_slot(self, shape: tuple, dtype) -> np.ndarray:
        """One ring buffer: pinned host memory when the loader serves a
        CUDA device, plain numpy otherwise."""
        dev = getattr(self.device, "torch_device", None)
        if dev is None or dev.type != "cuda":
            return np.empty(shape, dtype)
        tdt = torch.from_numpy(np.empty(0, dtype)).dtype
        return torch.empty(shape, dtype=tdt, pin_memory=True).numpy()

    # -- geometry helpers ---------------------------------------------------
    @property
    def total_samples(self) -> int:
        return int(sum(self.class_lengths))

    def class_offset(self, cls: int) -> int:
        """Global sample index where class ``cls`` starts (storage order is
        [test | validation | train], reference layout)."""
        return int(sum(self.class_lengths[:cls]))

    @property
    def has_labels(self) -> bool:
        return bool(self.minibatch_labels)

    def _nonempty_classes(self) -> list[int]:
        return [c for c in (TEST, VALID, TRAIN) if self.class_lengths[c] > 0]

    # -- lifecycle ----------------------------------------------------------
    def _common_init(self, **kwargs) -> None:
        self.load_data()
        if self.class_lengths[TRAIN] <= 0:
            raise ValueError("Loader: empty train set")
        self.create_minibatch_data()
        if not self.minibatch_indices:
            self.minibatch_indices.reset(
                shape=(self.max_minibatch_size,), dtype=np.int64)
        self.init_array(self.minibatch_data, self.minibatch_labels,
                        self.minibatch_targets, self.minibatch_indices)
        self._class = self._nonempty_classes()[0]
        self._position = 0
        self._shuffle_train()

    def _shuffle_train(self) -> None:
        for cls in self._nonempty_classes():
            if cls not in self._shuffled:
                self._shuffled[cls] = np.arange(
                    self.class_offset(cls),
                    self.class_offset(cls) + self.class_lengths[cls],
                    dtype=np.int64)
        if self.shuffle_limit is not None and \
                self._epoch >= self.shuffle_limit:
            return
        prng.get().shuffle(self._shuffled[TRAIN])

    # -- serving ------------------------------------------------------------
    def numpy_run(self) -> None:
        if self.pipeline is not None:
            self._consume_prefetched()
            return
        self._serve()

    def torch_run(self) -> None:
        if self.pipeline is not None:
            self._consume_prefetched()
            if self.staged is None and not self.serve_indices_only:
                # no stager attached: upload on the consumer thread
                # exactly like the synchronous path below
                self._upload_minibatch()
            return
        self._serve()
        if self.serve_indices_only:
            # the fused step pinned the dataset on the device: it consumes
            # only minibatch_indices, so the host gather + upload of the
            # minibatch itself would be dead work on the hot loop
            return
        self._upload_minibatch()

    def _upload_minibatch(self) -> None:
        for arr in (self.minibatch_data, self.minibatch_labels,
                    self.minibatch_targets):
            if arr:
                arr.unmap()

    def _next_record(self) -> dict:
        """Advance the PRIVATE serving cursor one minibatch and return the
        control record — publishes nothing.  The sync path and the
        pipeline producer share this core, so serve order (and therefore
        prng order) is identical with prefetching on or off."""
        cls = self._class
        length = self.class_lengths[cls]
        start = self._position
        count = min(self.max_minibatch_size, length - start)
        indices = np.full((self.max_minibatch_size,), -1, dtype=np.int64)
        indices[:count] = self._shuffled[cls][start:start + count]
        self._position = start + count
        rec = {"indices": indices, "size": count, "cls": cls,
               "offset": start, "last": self._position >= length,
               "plan": None, "epoch_ended": False,
               "epoch_number": self._epoch}
        if start == 0 and self.capture_class_plan:
            rec["plan"] = self._capture_class_plan(cls)
        return rec

    def _complete_record(self, rec: dict) -> dict:
        """Class/epoch advance for a record from :meth:`_next_record` —
        runs AFTER the fill (reference order: augmenting fills draw prng
        before the epoch-boundary reshuffle)."""
        if rec["last"]:
            classes = self._nonempty_classes()
            idx = classes.index(self._class)
            if idx + 1 < len(classes):
                self._class = classes[idx + 1]
            else:
                # train pass done -> epoch boundary
                self._epoch += 1
                rec["epoch_ended"] = True
                self._class = classes[0]
                self._shuffle_train()
            self._position = 0
        rec["epoch_number"] = self._epoch
        return rec

    def _publish_record(self, rec: dict) -> None:
        """Write a record's control metadata into the published attrs the
        downstream units read (consumer-thread only)."""
        self.epoch_ended = False
        self.minibatch_indices.map_invalidate()
        self.minibatch_indices.mem = rec["indices"]
        self.minibatch_size = rec["size"]
        self.minibatch_class = rec["cls"]
        self.minibatch_offset = rec["offset"]
        self.last_minibatch = rec["last"]
        if rec["plan"] is not None:
            self._current_plan = rec["plan"]

    def _serve(self) -> None:
        rec = self._next_record()
        self._publish_record(rec)
        if not self.serve_indices_only:
            self.fill_minibatch()
        self._complete_record(rec)
        self.epoch_number = rec["epoch_number"]
        self.epoch_ended = rec["epoch_ended"]

    def _consume_prefetched(self) -> None:
        """Pop the next pipelined batch and replay it: control metadata,
        filled host arrays, and the staged device payload."""
        batch = self.pipeline.next_batch()
        rec = batch.record
        self._publish_record(rec)
        if batch.arrays:
            for name, host in batch.arrays.items():
                arr = getattr(self, f"minibatch_{name}")
                arr.map_invalidate()
                arr.mem = host
        self.staged = batch.staged
        self.epoch_number = rec["epoch_number"]
        self.epoch_ended = rec["epoch_ended"]

    def take_staged(self):
        """One-shot handoff of the pipeline's staged payload for the
        current batch (None in sync mode or when nothing was staged) —
        steps call this instead of re-uploading the batch."""
        staged, self.staged = self.staged, None
        return staged

    def class_plan(self) -> np.ndarray:
        """The FULL minibatch plan of the class currently being served:
        ``(n_minibatches, max_minibatch_size)`` int64 indices, -1 padding
        on the final partial row.  Captured at the first serve of the
        class pass — for a single-minibatch class, ``_complete_record``
        (and the epoch-boundary reshuffle) has ALREADY run by the time
        the consumer acts, so reading ``_shuffled`` lazily would hand out
        the next class's plan."""
        return self._current_plan

    def _capture_class_plan(self, cls: int) -> np.ndarray:
        order = self._shuffled[cls]
        length = self.class_lengths[cls]
        bs = self.max_minibatch_size
        n_mb = -(-length // bs)
        plan = np.full((n_mb, bs), -1, dtype=np.int64)
        flat = plan.reshape(-1)
        flat[:length] = order[:length]
        return plan

    # -- lifecycle ----------------------------------------------------------
    def stop(self) -> None:
        if self.pipeline is not None:
            self.pipeline.stop()

    # -- snapshot support ---------------------------------------------------
    def state_dict(self) -> dict:
        # at a snapshot point (epoch boundary) the pipeline's determinism
        # barrier guarantees the private cursor equals the sync-mode state
        return {
            "epoch_number": int(self._epoch),
            "position": int(self._position),
            "cls": int(self._class),
            "shuffled": {c: v.copy() for c, v in self._shuffled.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        if self.pipeline is not None:
            # prefetched batches belong to the pre-restore cursor: drain
            # the worker and re-arm it on the restored state
            self.pipeline.resync()
        self.staged = None
        self._epoch = int(state["epoch_number"])
        self.epoch_number = self._epoch
        self._position = state["position"]
        self._class = state["cls"]
        self._shuffled = {c: np.asarray(v) for c, v in
                          state["shuffled"].items()}
