"""Deterministic synthetic datasets — the port of
``znicz_tpu/loader/synthetic.py``: seeded Gaussian-blob classification
data (the MNIST stand-in) and the seeded regression dataset.

Generation goes through the port's ``core.prng`` streams, whose host
half is the reference's, so one seed gives both packages the same data.
The loaders are registered under the reference's names.
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import (TEST, VALID, TRAIN,
                                         register_loader)
from znicz_tpu_torch.loader.fullbatch import (FullBatchLoader,
                                              FullBatchLoaderMSE)


def assemble_classes(means: np.ndarray, n_per_class: dict[int, int],
                     noise: float, gen) -> tuple:
    """[test|valid|train]-ordered samples around per-class ``means``
    ``(n_classes, *sample_shape)`` plus Gaussian noise.  Returns
    ``(data, labels, class_lengths)`` — the one definition of the split
    ordering / label tiling every synthetic loader shares."""
    n_classes = means.shape[0]
    sample_shape = means.shape[1:]
    data_parts, label_parts, lengths = [], [], [0, 0, 0]
    for cls in (TEST, VALID, TRAIN):
        n = n_per_class.get(cls, 0) * n_classes
        lengths[cls] = n
        if n == 0:
            continue
        labels = np.tile(np.arange(n_classes), n_per_class[cls])
        samples = means[labels] + gen.normal(
            0.0, noise, (n,) + sample_shape).astype(np.float32)
        data_parts.append(samples.astype(np.float32, copy=False))
        label_parts.append(labels.astype(np.int32))
    if not data_parts:
        raise ValueError(
            f"empty synthetic dataset: n_per_class={n_per_class} over "
            f"{n_classes} classes (n_train/n_valid must be >= n_classes)")
    return (np.concatenate(data_parts), np.concatenate(label_parts), lengths)


def make_blobs(n_per_class: dict[int, int], n_classes: int,
               sample_shape: tuple, spread: float = 2.0,
               noise: float = 1.0, stream: str = "synthetic"):
    """Gaussian-blob classification data in [test|valid|train] order.

    Returns ``(data, labels, class_lengths)``; each class' mean is a seeded
    random direction scaled by ``spread`` — linearly separable-ish, so small
    nets converge in a few epochs (what the functional tests pin).
    """
    gen = prng.get(stream)
    shape = tuple(sample_shape)
    means = gen.normal(0.0, spread, (n_classes,) + shape).astype(np.float32)
    return assemble_classes(means, n_per_class, noise, gen)


@register_loader("synthetic_classifier")
class SyntheticClassifierLoader(FullBatchLoader):
    """Seeded Gaussian-blob classification dataset (MNIST stand-in)."""

    def __init__(self, workflow=None, n_classes: int = 10,
                 sample_shape=(28, 28), n_train: int = 600,
                 n_valid: int = 100, n_test: int = 0,
                 spread: float = 2.0, noise: float = 1.0, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.n_classes = n_classes
        self.sample_shape = tuple(sample_shape)
        self.n_per_class = {TEST: n_test // n_classes,
                            VALID: n_valid // n_classes,
                            TRAIN: n_train // n_classes}
        self.spread = spread
        self.noise = noise

    def load_data(self) -> None:
        data, labels, lengths = make_blobs(
            self.n_per_class, self.n_classes, self.sample_shape,
            self.spread, self.noise)
        self.original_data.mem = data
        self.original_labels.mem = labels
        self.class_lengths = lengths


@register_loader("synthetic_image")
class SyntheticImageLoader(SyntheticClassifierLoader):
    """Class patterns rendered as spatially-smooth (H, W, C) images —
    conv-stack test/benchmark data.

    Each class mean is a coarse ``(H//4, W//4)`` pattern upsampled to full
    resolution, so classes have the local spatial structure convolutions
    exploit (per-pixel blobs are white noise that conv + pooling average
    away)."""

    def __init__(self, workflow=None, sample_shape=(32, 32, 3), **kwargs) -> None:
        if len(sample_shape) == 2:
            sample_shape = tuple(sample_shape) + (1,)
        super().__init__(workflow, sample_shape=sample_shape, **kwargs)

    def load_data(self) -> None:
        gen = prng.get("synthetic")
        h, w, c = self.sample_shape
        ch, cw = max(2, h // 4), max(2, w // 4)
        coarse = gen.normal(0.0, self.spread,
                            (self.n_classes, ch, cw, c)).astype(np.float32)
        ry, rx = -(-h // ch), -(-w // cw)  # ceil
        means = np.kron(coarse, np.ones((1, ry, rx, 1), np.float32))
        means = np.ascontiguousarray(means[:, :h, :w, :])
        data, labels, lengths = assemble_classes(
            means, self.n_per_class, self.noise, gen)
        self.original_data.mem = data
        self.original_labels.mem = labels
        self.class_lengths = lengths


@register_loader("synthetic_regression")
class SyntheticRegressionLoader(FullBatchLoaderMSE):
    """Seeded regression dataset: targets are a fixed random linear map of
    the inputs plus noise (autoencoder/MSE workflow test data).

    ``prototypes=P`` switches to the approximator-classification shape
    (reference: the approximator samples' nearest-target evaluation):
    inputs are per-class Gaussian blobs, targets are the class's exact
    prototype vector, and ``labels`` + ``class_targets`` feed
    EvaluatorMSE's nearest-target ``n_err``.
    """

    def __init__(self, workflow=None, sample_shape=(16,), target_shape=(4,),
                 n_train: int = 512, n_valid: int = 128,
                 identity: bool = False, prototypes: int = 0,
                 spread: float = 2.0, noise: float = 1.0,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.sample_shape = tuple(sample_shape)
        self.target_shape = tuple(target_shape)
        self.n_train = n_train
        self.n_valid = n_valid
        #: identity=True -> targets = inputs (autoencoder reconstruction)
        self.identity = identity
        self.prototypes = int(prototypes)
        self.spread = spread
        self.noise = noise
        self.class_targets = Array()   # (P, *target_shape) in proto mode

    def load_data(self) -> None:
        gen = prng.get("synthetic")
        n = self.n_valid + self.n_train
        dim = int(np.prod(self.sample_shape))
        if self.prototypes:
            P = self.prototypes
            tdim = int(np.prod(self.target_shape))
            means = gen.normal(0.0, self.spread, (P, dim)).astype(np.float32)
            protos = gen.normal(0.0, 1.0, (P, tdim)).astype(np.float32)
            labels = (np.arange(n) % P).astype(np.int32)
            gen.shuffle(labels)
            data = means[labels] + \
                gen.normal(0.0, self.noise, (n, dim)).astype(np.float32)
            self.original_data.mem = data.reshape((n,) + self.sample_shape)
            self.original_targets.mem = protos[labels].reshape(
                (n,) + self.target_shape)
            self.original_labels.mem = labels
            self.class_targets.mem = protos.reshape(
                (P,) + self.target_shape)
            self.class_lengths = [0, self.n_valid, self.n_train]
            return
        data = gen.normal(0.0, 1.0, (n, dim)).astype(np.float32)
        if self.identity:
            targets = data.copy().reshape((n,) + self.sample_shape)
        else:
            tdim = int(np.prod(self.target_shape))
            w = gen.normal(0.0, 1.0 / np.sqrt(dim), (dim, tdim))
            targets = (data @ w).astype(np.float32).reshape(
                (n,) + self.target_shape)
        self.original_data.mem = data.reshape((n,) + self.sample_shape)
        self.original_targets.mem = targets
        self.class_lengths = [0, self.n_valid, self.n_train]
