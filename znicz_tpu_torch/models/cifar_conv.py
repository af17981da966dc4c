"""CIFAR-10 ConvRELU workflow — the port of
``znicz_tpu/models/cifar_conv.py`` (reference: veles.znicz samples/
CIFAR10/cifar.py, the ConvRELU benchmark workflow in BASELINE.json).

The same declarative layer list (conv 32 3x3 p1 -> pool 2x2 -> conv 64
3x3 p1 -> pool 2x2 -> dropout 0.3 -> fc 256 -> softmax 10) and signature,
fused by default.  The default data path reads CIFAR python-format
pickle batches (``pickles_image``, ``loader/pickles.py``) from
``root.common.dirs.datasets/cifar``: real files as they are, a seeded
CIFAR-format set synthesized once otherwise; ``loader_name=
"synthetic_image"`` takes the in-memory stand-in.
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
    """The reference's signature and defaults."""
    if loader_name == "pickles_image":
        # CIFAR python-batch pickle files (real ones when dropped into
        # root.common.dirs.datasets/cifar, synthesized otherwise)
        cfg = {"n_train": n_train, "n_valid": n_valid,
               "minibatch_size": minibatch_size, "sample_shape": (32, 32, 3)}
    else:
        cfg = {"n_classes": 10, "sample_shape": (32, 32, 3),
               "n_train": n_train, "n_valid": n_valid,
               "minibatch_size": minibatch_size, "spread": 2.0,
               "noise": 1.0}
    cfg.update(loader_config or {})
    return StandardWorkflow(
        name="CifarConv", layers=LAYERS, loss_function="softmax",
        loader_name=loader_name, loader_config=cfg,
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh,
        optimizer=optimizer, optimizer_config=optimizer_config)


def run(load, main):
    """The sample's ``run(load, main)`` entry, driven by the CLI
    (``python -m znicz_tpu_torch <workflow.py> [config.py ...]``)."""
    load(build)
    main()
