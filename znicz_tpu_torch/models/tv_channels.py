"""TV-channels workflow — the port of ``znicz_tpu/models/tv_channels.py``
(a copy, under the drift check of ``tests/test_torch_port_isolation.py``);
rebuild of the reference's TvChannels research
sample (veles.znicz tests/research/TvChannels: identify the broadcasting
channel from a video frame, where the discriminative feature is the
station logo in a fixed corner of the frame).

The sample-specific loader lives in the sample module, the reference's
convention (the MNIST sample owns MnistLoader the same way).  Frames are
synthesized: a smooth random background shared across classes plus a
per-channel logo stamped at a fixed corner with brightness jitter — the
class signal is LOCAL, which is what makes this workflow the natural
consumer of the Cutter unit: the graph crops the logo region before the
conv stack, exactly how the reference sample avoids burning compute on
logo-free frame area.
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader.base import register_loader
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.standard_workflow import StandardWorkflow

FRAME = 32          # synthesized frame side
LOGO = 10           # logo patch side
CORNER = (2, 2)     # logo's top-left corner (y, x)


@register_loader("tv_channels_synthetic")
class TvChannelsLoader(FullBatchLoader):
    """Seeded frame generator: per-class corner logos over shared-
    statistics backgrounds."""

    def __init__(self, workflow=None, n_channels: int = 8,
                 n_train: int = 800, n_valid: int = 200,
                 noise: float = 0.25, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.n_channels = n_channels
        self.n_train = n_train
        self.n_valid = n_valid
        self.noise = noise

    @property
    def n_classes(self) -> int:
        return self.n_channels

    def load_data(self) -> None:
        gen = prng.get("synthetic")
        n = self.n_valid + self.n_train
        logos = gen.uniform(0.0, 1.0,
                            (self.n_channels, LOGO, LOGO, 3)) \
            .astype(np.float32)
        labels = (np.arange(n) % self.n_channels).astype(np.int32)
        gen.shuffle(labels)
        # smooth background: coarse noise upsampled (same stats for all
        # classes — nothing discriminative outside the logo)
        coarse = gen.normal(0.5, 0.2, (n, FRAME // 4, FRAME // 4, 3))
        frames = np.kron(coarse, np.ones((1, 4, 4, 1))).astype(np.float32)
        frames += gen.normal(0.0, self.noise, frames.shape) \
            .astype(np.float32)
        oy, ox = CORNER
        brightness = gen.uniform(0.6, 1.0, (n, 1, 1, 1)).astype(np.float32)
        frames[:, oy:oy + LOGO, ox:ox + LOGO, :] = logos[labels] * brightness
        self.original_data.mem = frames
        self.original_labels.mem = labels
        self.class_lengths = [0, self.n_valid, self.n_train]


def layers(n_channels: int = 8, lr: float = 0.02, moment: float = 0.9,
           wd: float = 1e-4):
    hyper = {"learning_rate": lr, "gradient_moment": moment,
             "weights_decay": wd}
    return [
        # crop the logo region first — the reference sample's trick
        {"type": "cutter", "->": {"offset": CORNER, "size": (LOGO, LOGO)}},
        {"type": "conv_relu", "->": {"n_kernels": 16, "kx": 3, "ky": 3,
                                     "padding": (1, 1, 1, 1)},
         "<-": dict(hyper)},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 48},
         "<-": dict(hyper)},
        {"type": "softmax", "->": {"output_sample_shape": n_channels},
         "<-": dict(hyper)},
    ]


def build(max_epochs: int = 8, minibatch_size: int = 50,
          n_channels: int = 8, n_train: int = 800, n_valid: int = 200,
          lr: float = 0.02, fused: bool = True, mesh=None,
          loader_config: dict | None = None,
          snapshotter_config: dict | None = None) -> StandardWorkflow:
    cfg = {"n_channels": n_channels, "n_train": n_train,
           "n_valid": n_valid, "minibatch_size": minibatch_size}
    cfg.update(loader_config or {})
    return StandardWorkflow(
        name="TvChannels", layers=layers(n_channels=n_channels, lr=lr),
        loss_function="softmax", loader_name="tv_channels_synthetic",
        loader_config=cfg,
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh)


def run(load, main):
    load(build)
    main()
