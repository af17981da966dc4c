"""Full-batch loaders — the port of ``znicz_tpu/loader/fullbatch.py``
(rebuild of veles/loader/fullbatch.py :: FullBatchLoader, MSE variant).

The whole dataset lives in one Array pair (``original_data``,
``original_labels`` / ``original_targets``) in [test | validation |
train] storage order; ``fill_minibatch`` and the prefetch producer's
``fill_batch`` gather rows on the host through the native threaded
gather (``znicz_tpu_torch/native``), numpy only where the reference
takes it (a non-contiguous source or a dtype mismatch).  The fused step
pins a dataset that fits on the device and gathers there.
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch import native
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import Loader


def _gather(src: np.ndarray, indices: np.ndarray, count: int,
            dst: np.ndarray) -> None:
    """``dst[:count] = src[indices[:count]]``, ``dst[count:] = 0``: the
    native gather (it zeroes the -1 padding rows itself), numpy for a
    source it cannot take."""
    if src.flags.c_contiguous and src.dtype == dst.dtype:
        native.gather_rows(src, indices, dst)
    else:
        dst[:count] = src[indices[:count]]
        dst[count:] = 0


class FullBatchLoader(Loader):
    """Dataset fully materialized in host memory."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.original_data = Array()
        self.original_labels = Array()

    # subclasses override load_data() to fill original_* + class_lengths

    def create_minibatch_data(self) -> None:
        sample_shape = self.original_data.shape[1:]
        self.minibatch_data.reset(
            shape=(self.max_minibatch_size,) + tuple(sample_shape),
            dtype=self.original_data.dtype)
        if self.original_labels:
            self.minibatch_labels.reset(
                shape=(self.max_minibatch_size,), dtype=np.int32)

    def fill_minibatch(self) -> None:
        indices = self.minibatch_indices.mem
        count = self.minibatch_size
        idx = indices[:count]
        src = self.original_data.mem
        # a FRESH buffer every serve: a consumer may still read the
        # previous one (the reference's rule for asynchronous dispatch)
        data = np.empty((self.max_minibatch_size,) + src.shape[1:],
                        src.dtype)
        _gather(src, indices, count, data)
        self.minibatch_data.mem = data
        if self.original_labels:
            labels = np.zeros((self.max_minibatch_size,), np.int32)
            labels[:count] = self.original_labels.mem[idx]
            self.minibatch_labels.mem = labels

    def fill_batch(self, indices: np.ndarray, count: int, cls: int) -> dict:
        """Producer-side gather for the prefetch pipeline.  Unlike
        :meth:`fill_minibatch` there is no per-serve fresh buffer: the
        staging ring owns buffer lifetimes (a slot is reused only after
        its batch has left the pipeline), so the gather lands in a
        rotating preallocated buffer (pinned on the card's host)."""
        src = self.original_data.mem
        data = self._next_buffer(
            "data", (self.max_minibatch_size,) + src.shape[1:], src.dtype)
        _gather(src, indices, count, data)
        out = {"data": data}
        if self.original_labels:
            labels = self._next_buffer(
                "labels", (self.max_minibatch_size,), np.int32)
            labels[:count] = self.original_labels.mem[indices[:count]]
            labels[count:] = 0
            out["labels"] = labels
        return out


class FullBatchLoaderMSE(FullBatchLoader):
    """Full-batch loader also serving regression targets
    (reference: FullBatchLoaderMSE)."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.original_targets = Array()

    def create_minibatch_data(self) -> None:
        super().create_minibatch_data()
        target_shape = self.original_targets.shape[1:]
        self.minibatch_targets.reset(
            shape=(self.max_minibatch_size,) + tuple(target_shape),
            dtype=self.original_targets.dtype)

    def fill_minibatch(self) -> None:
        super().fill_minibatch()
        indices = self.minibatch_indices.mem
        count = self.minibatch_size
        src = self.original_targets.mem
        targets = np.zeros((self.max_minibatch_size,) + src.shape[1:],
                           src.dtype)
        targets[:count] = src[indices[:count]]
        self.minibatch_targets.mem = targets

    def fill_batch(self, indices: np.ndarray, count: int, cls: int) -> dict:
        out = super().fill_batch(indices, count, cls)
        src = self.original_targets.mem
        targets = self._next_buffer(
            "targets", (self.max_minibatch_size,) + src.shape[1:],
            src.dtype)
        targets[:count] = src[indices[:count]]
        targets[count:] = 0
        out["targets"] = targets
        return out
