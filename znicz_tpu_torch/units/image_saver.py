"""ImageSaver — the port of ``znicz_tpu/units/image_saver.py`` (a copy;
rebuild of veles.znicz image_saver.py :: ImageSaver).

Per minibatch, collects the worst-classified (and optionally best)
samples; on epoch end dumps them as PNGs named
``{class}/{epoch}_{true}_{pred}_{score}.png`` (reference naming shape).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.loader.base import CLASS_NAMES


class ImageSaver(Unit):
    """Reference: image_saver.py :: ImageSaver."""

    def __init__(self, workflow=None, directory: Optional[str] = None,
                 limit: int = 16, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.directory = directory or os.path.join(
            str(root.common.dirs.plots), "image_saver")
        self.limit = int(limit)
        # data links
        self.input = None        # loader minibatch_data Array
        self.output = None       # softmax probabilities Array
        self.labels = None       # loader minibatch_labels Array
        self.minibatch_class = 0
        self.minibatch_size = 0
        self.epoch_number = 0
        #: collected (score, img, true, pred) worst-first
        self._worst: list = []
        self.saved_paths: list[str] = []

    def run(self) -> None:
        y = np.asarray(self.output.map_read())
        # labels may live in a float32 Array (Array's default dtype)
        labels = np.asarray(self.labels.map_read()).astype(np.int64)
        x = np.asarray(self.input.map_read())
        n = int(self.minibatch_size)
        pred = y[:n].argmax(axis=1)
        true_p = y[np.arange(n), labels[:n]]
        for i in range(n):
            if pred[i] != labels[i]:
                self._worst.append((float(true_p[i]), x[i].copy(),
                                    int(labels[i]), int(pred[i])))
        self._worst.sort(key=lambda t: t[0])
        del self._worst[self.limit:]

    def flush(self) -> None:
        """Write collected samples (call on epoch end; gated in graphs)."""
        from PIL import Image
        cls_dir = os.path.join(self.directory,
                               CLASS_NAMES[int(self.minibatch_class)])
        os.makedirs(cls_dir, exist_ok=True)
        self.saved_paths = []
        for score, img, true, pred in self._worst:
            img = np.asarray(img, np.float32)
            if img.ndim == 3 and img.shape[-1] == 1:
                img = img[..., 0]
            lo, hi = img.min(), img.max()
            norm = ((img - lo) / (hi - lo) * 255 if hi > lo
                    else img * 0).astype(np.uint8)
            path = os.path.join(
                cls_dir, f"{int(self.epoch_number)}_{true}_{pred}_"
                f"{score:.3f}.png")
            Image.fromarray(norm).save(path)
            self.saved_paths.append(path)
        self._worst = []
