"""Image-file autoencoder workflow — the port of
``znicz_tpu/models/image_ae.py`` (rebuild of the reference's ImagenetAE
research sample, veles.znicz tests/research/ImagenetAE: a conv -> deconv
reconstruction autoencoder trained on image FILES, where
``models/autoencoder.py`` trains on synthetic data).

The sample-owned loader (reference convention) extends the
directory-per-class image loader with identity targets: each served
minibatch's target IS its normalized input, so EvaluatorMSE drives the
reconstruction loss end to end over the file -> decode -> normalize
pipeline.  Eager (``fused=False``) runs the conv and deconv units on the
conv kernels; fused pins the decoded set and its targets on the device
and trains through ``FusedTrainStep`` (cuDNN on the card, as for the
conv autoencoders).
"""

from __future__ import annotations

import os

import numpy as np

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import register_loader
from znicz_tpu_torch.loader.image import (FullBatchImageLoader,
                                          ensure_image_tree)
from znicz_tpu_torch.standard_workflow import StandardWorkflow


@register_loader("image_ae")
class ImageAELoader(FullBatchImageLoader):
    """FullBatchImageLoader serving identity reconstruction targets
    (reference: the ImagenetAE pipeline feeds the decoded image as both
    input and target)."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.original_targets = Array()

    def load_data(self) -> None:
        super().load_data()
        # identity targets share the stored dataset's buffer semantics:
        # normalized when serving straight, raw when augmenting (the
        # per-serve path normalizes both sides consistently)
        self.original_targets.mem = np.asarray(self.original_data.mem)

    def _renormalize_served_data(self) -> None:
        # a restored normalizer re-derived original_data: the identity
        # targets must follow it or the MSE would train toward the old
        # normalization
        super()._renormalize_served_data()
        self.original_targets.map_invalidate()
        self.original_targets.mem = np.asarray(self.original_data.mem)

    def create_minibatch_data(self) -> None:
        super().create_minibatch_data()
        self.minibatch_targets.reset(
            shape=(self.max_minibatch_size,) + self.served_shape,
            dtype=np.float32)

    def fill_minibatch(self) -> None:
        super().fill_minibatch()
        # target == served input (identity reconstruction)
        self.minibatch_targets.mem = self.minibatch_data.mem.copy()

    def fill_batch(self, indices: np.ndarray, count: int, cls: int) -> dict:
        out = super().fill_batch(indices, count, cls)
        targets = self._next_buffer("targets", out["data"].shape,
                                    np.float32)
        targets[...] = out["data"]
        out["targets"] = targets
        return out


def layers(n_kernels: int = 16, k: int = 3, channels: int = 3,
           lr: float = 0.002, moment: float = 0.9):
    hyper = {"learning_rate": lr, "gradient_moment": moment}
    return [
        {"type": "conv", "->": {"n_kernels": n_kernels, "kx": k, "ky": k},
         "<-": dict(hyper)},
        {"type": "deconv", "->": {"n_kernels": n_kernels, "kx": k, "ky": k,
                                  "n_channels": channels},
         "<-": dict(hyper)},
    ]


def ensure_dataset(data_dir: str | None = None, n_classes: int = 6,
                   n_per_class: int = 20, size: int = 24) -> str:
    data_dir = data_dir or os.path.join(
        str(root.common.dirs.datasets), "image_ae")
    return ensure_image_tree(data_dir, n_classes=n_classes,
                             n_per_class=n_per_class, size=(size, size))


def build(max_epochs: int = 10, minibatch_size: int = 20,
          image_size: int = 24, n_kernels: int = 16, lr: float = 0.002,
          valid_fraction: float = 0.25, fused: bool = True, mesh=None,
          loader_config: dict | None = None,
          snapshotter_config: dict | None = None) -> StandardWorkflow:
    cfg = {"data_dir": ensure_dataset(
               (loader_config or {}).get("data_dir"), size=image_size),
           "sample_shape": (image_size, image_size, 3),
           "valid_fraction": valid_fraction,
           "minibatch_size": minibatch_size,
           "normalization_type": "mean_disp"}
    cfg.update(loader_config or {})
    # the deconv reconstructs the EFFECTIVE channel count (loader_config
    # may override sample_shape, e.g. grayscale trees)
    lay = layers(n_kernels=n_kernels, lr=lr,
                 channels=cfg["sample_shape"][-1])
    return StandardWorkflow(
        name="ImageAE", layers=lay,
        loss_function="mse", loader_name="image_ae", loader_config=cfg,
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh)


def run(load, main):
    """The sample's ``run(load, main)`` entry, driven by the CLI
    (``python -m znicz_tpu_torch <workflow.py> [config.py ...]``)."""
    load(build)
    main()
