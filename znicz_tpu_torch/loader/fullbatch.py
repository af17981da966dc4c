"""Full-batch loaders — the port of ``znicz_tpu/loader/fullbatch.py``
(rebuild of veles/loader/fullbatch.py :: FullBatchLoader, MSE variant).

The whole dataset lives in one Array pair (``original_data``,
``original_labels`` / ``original_targets``) in [test | validation |
train] storage order; ``fill_minibatch`` is a host-side numpy gather (the
reference's own numpy path; its native threaded gather is not ported).
The fused step pins the dataset on the device and gathers there.
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import Loader


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
        data[:count] = src[idx]
        data[count:] = 0
        self.minibatch_data.mem = data
        if self.original_labels:
            labels = np.zeros((self.max_minibatch_size,), np.int32)
            labels[:count] = self.original_labels.mem[idx]
            self.minibatch_labels.mem = labels


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
