"""Pickled-batch loaders — the port's copy of
``znicz_tpu/loader/pickles.py`` (numpy only; rebuild of
veles/loader/pickles.py :: PicklesImageFullBatchLoader, the CIFAR-10
python-batch format: each file unpickles to a dict with ``data`` (N x
3072 uint8, CHW row-major) and ``labels``).

Real CIFAR-10 ``data_batch_*`` / ``test_batch`` files dropped into
``data_dir`` are read as they are (bytes- and str-keyed dicts); when
absent a seeded CIFAR-format set is synthesized ONCE (a fixed private
seed: both packages write the same bytes), so the unpickle -> reshape ->
normalize -> minibatch path always runs against real files.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import register_loader
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.resilience.retry import DEFAULT_IO_RETRY
from znicz_tpu_torch.loader.normalization import (
    NormalizerStateMixin, normalizer_factory)

TRAIN_FILES = [f"data_batch_{i}" for i in range(1, 6)]
VALID_FILE = "test_batch"


def _read_file(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def _read_batch(path: str, shape: tuple) -> tuple[np.ndarray, np.ndarray]:
    """One pickle file -> ((N, H, W, C) float32, (N,) int32 labels).
    The raw read retries transient OSErrors under the shared I/O policy
    (a malformed pickle is not transient and raises immediately)."""
    d = DEFAULT_IO_RETRY.call(_read_file, path)
    get = lambda k: d.get(k.encode(), d.get(k))  # noqa: E731
    data = np.asarray(get("data"))
    labels = np.asarray(get("labels"), np.int32)
    h, w, c = shape
    data = data.reshape(len(data), c, h, w).transpose(0, 2, 3, 1)
    return data.astype(np.float32), labels


def synthesize_cifar(data_dir: str, shape=(32, 32, 3),
                     n_per_train_batch: int = 400,
                     n_valid: int = 400, n_classes: int = 10) -> None:
    """Write seeded CIFAR-format pickle batches once (smooth per-class
    patterns, uint8 CHW rows like the real files).  Fixed private seed:
    bit-identical files regardless of global prng state (tier-2 pins)."""
    os.makedirs(data_dir, exist_ok=True)
    gen = np.random.default_rng(1234603)
    h, w, c = shape
    ch, cw = max(2, h // 4), max(2, w // 4)
    coarse = gen.normal(0.0, 1.0, (n_classes, ch, cw, c)).astype(np.float32)
    means = np.kron(coarse, np.ones((1, -(-h // ch), -(-w // cw), 1),
                                    np.float32))[:, :h, :w, :]
    means -= means.min()
    means /= max(float(means.max()), 1e-6)

    def make(n):
        labels = (np.arange(n) % n_classes).astype(np.int64)
        gen.shuffle(labels)
        imgs = means[labels] * gen.uniform(0.55, 1.0, (n, 1, 1, 1)) + \
            gen.normal(0.0, 0.10, (n, h, w, c))
        rows = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
        rows = rows.transpose(0, 3, 1, 2).reshape(n, -1)  # CHW row-major
        return {b"data": rows, b"labels": [int(x) for x in labels]}

    for name in TRAIN_FILES:
        with open(os.path.join(data_dir, name), "wb") as f:
            pickle.dump(make(n_per_train_batch), f)
    with open(os.path.join(data_dir, VALID_FILE), "wb") as f:
        pickle.dump(make(n_valid), f)


@register_loader("pickles_image")
class PicklesImageLoader(NormalizerStateMixin, FullBatchLoader):
    """CIFAR-format pickled-batch full-batch loader."""

    def __init__(self, workflow=None, data_dir: str | None = None,
                 sample_shape=(32, 32, 3), n_train: int | None = None,
                 n_valid: int | None = None,
                 normalization_type: str = "mean_disp",
                 synthesize: bool = True,
                 synth_config: dict | None = None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.data_dir = data_dir or os.path.join(
            str(root.common.dirs.datasets), "cifar")
        self.sample_shape = tuple(sample_shape)
        self.n_train = n_train
        self.n_valid = n_valid
        self.normalizer = normalizer_factory(normalization_type)
        self.synthesize = synthesize
        self.synth_config = dict(synth_config or {})

    def _ensure_files(self) -> None:
        needed = TRAIN_FILES + [VALID_FILE]
        missing = [n for n in needed
                   if not os.path.exists(os.path.join(self.data_dir, n))]
        if not missing:
            return
        if not self.synthesize:
            raise FileNotFoundError(
                f"CIFAR batches missing in {self.data_dir}: {missing}")
        self.info(f"synthesizing CIFAR-format batches in {self.data_dir}")
        synthesize_cifar(self.data_dir, shape=self.sample_shape,
                         **self.synth_config)

    def _load_raw(self):
        """(valid_x, valid_y, train_x, train_y) from the pickle batches,
        subsets applied; shared by load_data and restore."""
        self._ensure_files()
        parts = [_read_batch(os.path.join(self.data_dir, n),
                             self.sample_shape) for n in TRAIN_FILES]
        train_x = np.concatenate([p[0] for p in parts])
        train_y = np.concatenate([p[1] for p in parts])
        valid_x, valid_y = _read_batch(
            os.path.join(self.data_dir, VALID_FILE), self.sample_shape)
        if self.n_train:
            train_x, train_y = train_x[:self.n_train], train_y[:self.n_train]
        if self.n_valid:
            valid_x, valid_y = valid_x[:self.n_valid], valid_y[:self.n_valid]
        return valid_x, valid_y, train_x, train_y

    def load_data(self) -> None:
        valid_x, valid_y, train_x, train_y = self._load_raw()
        self.normalizer.analyze(train_x)
        data = np.concatenate([valid_x, train_x])
        self.original_data.mem = self.normalizer.normalize(data)
        self.original_labels.mem = np.concatenate(
            [valid_y, train_y]).astype(np.int32)
        self.class_lengths = [0, len(valid_x), len(train_x)]

    def _renormalize_served_data(self) -> None:
        valid_x, _vy, train_x, _ty = self._load_raw()
        self.original_data.map_invalidate()
        self.original_data.mem = self.normalizer.normalize(
            np.concatenate([valid_x, train_x]))
