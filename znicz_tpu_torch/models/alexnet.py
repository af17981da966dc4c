"""AlexNet ImageNet workflow — the port of ``znicz_tpu/models/alexnet.py``
(rebuild of the reference's ImageNet AlexNet sample; BASELINE.md config
3, the north-star workflow).

Canonical geometry (Krizhevsky et al. 2012, as the reference configures
it): 227x227x3 input; conv 96/11x11 s4 -> LRN -> pool3 s2 -> conv 256/5x5
pad2 -> LRN -> pool -> conv 384 -> conv 384 -> conv 256 -> pool -> fc 4096
(dropout) -> fc 4096 (dropout) -> softmax 1000.

``build()`` (``fused=True``, the default) trains through the fused step:
cuDNN convs and plain matmuls under autograd, as the reference's fused
step runs XLA's, with LRN on its forward and backward kernels and the
update on the SGD kernel; ``build(fused=False)`` trains eager on the
conv and FC kernels.  ``loader_name="file_image"`` (or
``"full_batch_image"``) reads a directory-per-class image tree through
``loader/image.py`` with a fitted mean_disp normalizer, and ``augment``
serves the canonical seeded crops and mirrors; the synthetic in-memory
loader is the default, as in the reference.
"""

from __future__ import annotations

from znicz_tpu_torch.standard_workflow import StandardWorkflow


def layers(n_classes: int = 1000, lr: float = 0.01, moment: float = 0.9,
           wd: float = 5e-4, dropout: float = 0.5):
    hyper = {"learning_rate": lr, "gradient_moment": moment,
             "weights_decay": wd}
    return [
        {"type": "conv_str", "->": {"n_kernels": 96, "kx": 11, "ky": 11,
                                    "sliding": (4, 4)}, "<-": dict(hyper)},
        {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "k": 2.0,
                                "n": 5}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "conv_str", "->": {"n_kernels": 256, "kx": 5, "ky": 5,
                                    "padding": (2, 2, 2, 2)},
         "<-": dict(hyper)},
        {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "k": 2.0,
                                "n": 5}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "conv_str", "->": {"n_kernels": 384, "kx": 3, "ky": 3,
                                    "padding": (1, 1, 1, 1)},
         "<-": dict(hyper)},
        {"type": "conv_str", "->": {"n_kernels": 384, "kx": 3, "ky": 3,
                                    "padding": (1, 1, 1, 1)},
         "<-": dict(hyper)},
        {"type": "conv_str", "->": {"n_kernels": 256, "kx": 3, "ky": 3,
                                    "padding": (1, 1, 1, 1)},
         "<-": dict(hyper)},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "dropout", "->": {"dropout_ratio": dropout}},
        {"type": "all2all_str", "->": {"output_sample_shape": 4096},
         "<-": dict(hyper)},
        {"type": "dropout", "->": {"dropout_ratio": dropout}},
        {"type": "all2all_str", "->": {"output_sample_shape": 4096},
         "<-": dict(hyper)},
        {"type": "softmax", "->": {"output_sample_shape": n_classes},
         "<-": dict(hyper)},
    ]


def build(max_epochs: int = 1, minibatch_size: int = 128,
          n_classes: int = 1000, input_size: int = 227,
          n_train: int = 1000, n_valid: int = 0, lr: float = 0.01,
          dropout: float = 0.5, fused: bool = True, mesh=None,
          loader_name: str = "synthetic_image",
          loader_config: dict | None = None,
          snapshotter_config: dict | None = None,
          optimizer_config: dict | None = None,
          shard_update: bool = False, shard_params: bool = False,
          quantized_collectives: dict | None = None) -> StandardWorkflow:
    """The reference's signature and defaults, and the data-parallel
    options of the fused step (``StandardWorkflow``'s), which the
    reference's ``build`` does not pass.  The synthetic loader
    serves ``min(n_classes, 50)`` classes of spatially smooth images.
    ``loader_name="file_image"`` + ``loader_config={"data_dir": ...}``
    streams a directory-per-class ImageNet-style tree with fitted
    mean_disp normalization (the real-data path); add ``"augment": True``
    for the canonical AlexNet recipe — decode at ``input_size + 29``
    (256 for 227) and serve seeded random crops + horizontal mirrors on
    TRAIN, center crops elsewhere (Krizhevsky et al. 2012, the
    reference pipeline's augmentation)."""
    loader_config = dict(loader_config or {})
    if loader_config.get("augment") and loader_name not in (
            "file_image", "full_batch_image"):
        raise ValueError(f"augment requires an image-file loader "
                         f"(got loader_name={loader_name!r})")
    if loader_name in ("file_image", "full_batch_image"):
        cfg = {"sample_shape": (input_size, input_size, 3),
               "minibatch_size": minibatch_size,
               "normalization_type": "mean_disp"}
        if loader_config.pop("augment", False):
            # decode larger, serve random input_size crops + mirrors
            decode = input_size + 29          # 256 for the canonical 227
            cfg.update({"sample_shape": (decode, decode, 3),
                        "crop": (input_size, input_size), "mirror": True})
    else:
        cfg = {"n_classes": min(n_classes, 50),
               "sample_shape": (input_size, input_size, 3),
               "n_train": n_train, "n_valid": n_valid,
               "minibatch_size": minibatch_size, "spread": 1.0,
               "noise": 0.5}
    cfg.update(loader_config)
    return StandardWorkflow(
        name="AlexNet",
        layers=layers(n_classes=n_classes, lr=lr, dropout=dropout),
        loss_function="softmax", loader_name=loader_name,
        loader_config=cfg,
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh,
        optimizer_config=optimizer_config, shard_update=shard_update,
        shard_params=shard_params,
        quantized_collectives=quantized_collectives)


def run(load, main):
    """The sample's ``run(load, main)`` entry, driven by the CLI
    (``python -m znicz_tpu_torch <workflow.py> [config.py ...]``)."""
    load(build)
    main()
