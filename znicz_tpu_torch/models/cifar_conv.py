"""CIFAR-10 ConvRELU workflow — the port of
``znicz_tpu/models/cifar_conv.py`` (reference: veles.znicz samples/
CIFAR10/cifar.py, the ConvRELU benchmark workflow in BASELINE.json).

The same declarative layer list (conv 32 3x3 p1 -> pool 2x2 -> conv 64
3x3 p1 -> pool 2x2 -> dropout 0.3 -> fc 256 -> softmax 10) and signature,
fused by default.  Runs over the in-memory ``synthetic_image`` loader;
the reference's default loader, the CIFAR python-batch pickles
(``pickles_image``), waits for ``loader/image.py`` (ROADMAP.md queue A
item 5) and raises.
"""

from __future__ import annotations

from znicz_tpu_torch.standard_workflow import StandardWorkflow

LAYERS = [
    {"type": "conv_relu", "->": {"n_kernels": 32, "kx": 3, "ky": 3,
                                 "padding": (1, 1, 1, 1)},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 1e-4}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "conv_relu", "->": {"n_kernels": 64, "kx": 3, "ky": 3,
                                 "padding": (1, 1, 1, 1)},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 1e-4}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "dropout", "->": {"dropout_ratio": 0.3}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 256},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 1e-4}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 1e-4}},
]


def build(max_epochs: int = 10, minibatch_size: int = 100,
          n_train: int = 2000, n_valid: int = 500, fused: bool = True,
          mesh=None, loader_name: str = "pickles_image",
          loader_config: dict | None = None,
          snapshotter_config: dict | None = None,
          optimizer: str = "sgd",
          optimizer_config: dict | None = None) -> StandardWorkflow:
    """The reference's signature and defaults; runs with
    ``loader_name="synthetic_image"``."""
    if loader_name == "pickles_image":
        raise NotImplementedError(
            "the CIFAR pickle loader (pickles_image, loader/image.py) is "
            "not ported yet (ROADMAP.md queue A item 5); pass loader_name="
            "'synthetic_image'")
    cfg = {"n_classes": 10, "sample_shape": (32, 32, 3),
           "n_train": n_train, "n_valid": n_valid,
           "minibatch_size": minibatch_size, "spread": 2.0, "noise": 1.0}
    cfg.update(loader_config or {})
    return StandardWorkflow(
        name="CifarConv", layers=LAYERS, loss_function="softmax",
        loader_name=loader_name, loader_config=cfg,
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh,
        optimizer=optimizer, optimizer_config=optimizer_config)
