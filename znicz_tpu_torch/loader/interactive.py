"""Interactive (stream-fed) loader — the port of
``znicz_tpu/loader/interactive.py`` (rebuild of the reference's
``veles/loader/interactive.py`` row): samples are pushed by the host
program at runtime instead of loaded from files; a copy.

Static shapes come first.  The loader declares a fixed
``capacity`` up front (the train class length — every compiled step keeps
the same geometry) and owns a ring buffer the host fills via
:meth:`feed` between epochs; serving gathers minibatches from whatever
has been fed so far, wrapping over the filled region.  This turns the
reference's blocking stdin/REPL pattern into an online-training queue
that never changes a compiled shape.
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import Loader, register_loader


@register_loader("interactive")
class InteractiveLoader(Loader):
    """Queue-fed loader: ``feed(data, labels)`` appends samples; epochs
    draw train minibatches from the filled ring buffer."""

    def __init__(self, workflow=None, sample_shape=(4,), capacity: int = 256,
                 n_classes: int = 0, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.sample_shape = tuple(sample_shape)
        self.capacity = int(capacity)
        #: 0 -> regression targets of sample_shape; >0 -> int class labels
        self.n_classes = int(n_classes)
        self._fill = 0            # total samples ever fed (ring position)
        # ring buffers live from construction so the host may feed()
        # before the workflow initializes (capacity is static anyway)
        self._buffer = np.zeros((self.capacity,) + self.sample_shape,
                                np.float32)
        if self.n_classes > 0:
            self._label_buffer = np.zeros((self.capacity,), np.int32)
        else:
            self._label_buffer = np.zeros(
                (self.capacity,) + self.sample_shape, np.float32)

    # -- feeding ------------------------------------------------------------
    def feed(self, data, labels=None) -> int:
        """Append a batch of samples (and labels) to the ring buffer;
        returns how many samples are currently available.  Callable any
        time from the host thread — the NEXT minibatch gather sees the
        new rows (the loader copies at serve time)."""
        data = np.asarray(data, np.float32)
        if data.shape[1:] != self.sample_shape:
            raise ValueError(f"fed samples {data.shape[1:]} != declared "
                             f"sample_shape {self.sample_shape}")
        if self.n_classes > 0 and labels is None:
            raise ValueError("classification loader (n_classes > 0) needs "
                             "labels with every feed()")
        if labels is not None:
            labels = np.asarray(labels)
            if len(labels) != len(data):
                raise ValueError("labels/data length mismatch")
        for i in range(len(data)):
            slot = self._fill % self.capacity
            self._buffer[slot] = data[i]
            # regression batches fed without targets train
            # autoencoder-style against their own inputs — written into
            # the target buffer PER SLOT, so mixed labeled/unlabeled
            # feeds never pair rows with stale targets
            self._label_buffer[slot] = labels[i] if labels is not None                 else data[i]
            self._fill += 1
        return self.available

    @property
    def available(self) -> int:
        return min(self._fill, self.capacity)

    # -- Loader overrides ---------------------------------------------------
    def load_data(self) -> None:
        self.class_lengths = [0, 0, self.capacity]

    def create_minibatch_data(self) -> None:
        bs = self.max_minibatch_size
        self.minibatch_data = Array()
        self.minibatch_data.reset(shape=(bs,) + self.sample_shape,
                                  dtype=np.float32)
        if self.n_classes > 0:
            self.minibatch_labels = Array()
            self.minibatch_labels.reset(shape=(bs,), dtype=np.int32)
        else:
            self.minibatch_targets = Array()
            self.minibatch_targets.reset(
                shape=(bs,) + self.sample_shape, dtype=np.float32)

    def fill_minibatch(self) -> None:
        if self.available == 0:
            raise RuntimeError(
                "InteractiveLoader: no samples fed yet — call "
                "feed(data, labels) before running the workflow")
        idx = np.asarray(self.minibatch_indices.mem)
        # global index -> train-class row -> filled ring slot
        rows = np.maximum(idx, 0) - self.class_offset(2)
        rows = rows % self.available
        self.minibatch_data.map_write()[...] = self._buffer[rows]
        if self.n_classes > 0:
            self.minibatch_labels.map_write()[...] = self._label_buffer[rows]
        else:
            self.minibatch_targets.map_write()[...] = \
                self._label_buffer[rows]
