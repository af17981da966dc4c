"""MNIST convolutional workflow — the port of
``znicz_tpu/models/mnist_conv.py`` (reference: veles.znicz samples/MNIST
conv config — BASELINE.md config 2).

The same declarative layer list (conv 32 5x5 p2 -> pool 2x2 -> conv 64
5x5 p2 -> pool 2x2 -> fc 128 -> softmax 10) and signature, fused (the
default) or eager.  The default data path is the IDX file loader
(``loader/mnist.py``): real MNIST files when present under
``root.common.dirs.datasets/mnist``, a seeded synthesized IDX quartet
otherwise; ``loader_name="synthetic_image"`` takes the in-memory
stand-in.  A caller may swap a pooling layer's type
(``stochastic_pooling``), as the reference's StandardWorkflow accepts.
"""

from __future__ import annotations

from znicz_tpu_torch.standard_workflow import StandardWorkflow

LAYERS = [
    {"type": "conv_relu", "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                                 "padding": (2, 2, 2, 2)},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 5e-4}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "conv_relu", "->": {"n_kernels": 64, "kx": 5, "ky": 5,
                                 "padding": (2, 2, 2, 2)},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 5e-4}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 128},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 5e-4}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 5e-4}},
]


def build(max_epochs: int = 10, minibatch_size: int = 100,
          n_train: int = 2000, n_valid: int = 500, fused: bool = True,
          mesh=None, loader_name: str = "mnist",
          loader_config: dict | None = None,
          snapshotter_config: dict | None = None,
          optimizer: str = "sgd",
          optimizer_config: dict | None = None) -> StandardWorkflow:
    """The reference's signature and defaults."""
    if loader_name == "mnist":
        cfg = {"n_train": n_train, "n_valid": n_valid,
               "minibatch_size": minibatch_size,
               "normalization_type": "linear"}
    else:
        cfg = {"n_classes": 10, "sample_shape": (28, 28, 1),
               "n_train": n_train, "n_valid": n_valid,
               "minibatch_size": minibatch_size, "spread": 2.5,
               "noise": 1.0}
    cfg.update(loader_config or {})
    return StandardWorkflow(
        name="MnistConv", layers=LAYERS, loss_function="softmax",
        loader_name=loader_name, loader_config=cfg,
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh,
        optimizer=optimizer, optimizer_config=optimizer_config)


def run(load, main):
    """The sample's ``run(load, main)`` entry, driven by the CLI
    (``python -m znicz_tpu_torch <workflow.py> [config.py ...]``)."""
    load(build)
    main()
