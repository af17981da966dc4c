"""Conv -> Deconv autoencoder workflow — the port of
``znicz_tpu/models/autoencoder.py`` (reference: veles.znicz Deconv
autoencoder sample, tests/research/ImagenetAE — BASELINE.md config 4).

MSE reconstruction of the input (identity targets); the deconv owns its
weights (fused-step compatible); the tied-weight variant is available in
eager mode via Deconv.link_conv_attrs.  Eager (``fused=False``) runs the
conv and deconv units on the conv kernels; fused runs ``FusedTrainStep``
over their ``torch_apply`` (cuDNN on the card) and the update kernels.
The workflow builds for ``cuda`` unless ``initialize`` is given a CPU
device.
"""

from __future__ import annotations

from znicz_tpu_torch.standard_workflow import StandardWorkflow


def layers(n_kernels: int = 8, k: int = 3):
    return [
        {"type": "conv", "->": {"n_kernels": n_kernels, "kx": k, "ky": k},
         "<-": {"learning_rate": 0.001, "gradient_moment": 0.9}},
        {"type": "deconv", "->": {"n_kernels": n_kernels, "kx": k, "ky": k,
                                  "n_channels": 1},
         "<-": {"learning_rate": 0.001, "gradient_moment": 0.9}},
    ]


def build(max_epochs: int = 10, minibatch_size: int = 50,
          sample_shape=(16, 16, 1), n_train: int = 500, n_valid: int = 150,
          n_kernels: int = 8, fused: bool = True, mesh=None,
          snapshotter_config: dict | None = None) -> StandardWorkflow:
    lay = layers(n_kernels)
    lay[-1]["->"]["n_channels"] = sample_shape[-1]
    return StandardWorkflow(
        name="ConvAE", layers=lay, loss_function="mse",
        loader_name="synthetic_regression",
        loader_config={"sample_shape": tuple(sample_shape), "identity": True,
                       "n_train": n_train, "n_valid": n_valid,
                       "minibatch_size": minibatch_size},
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh)


def deep_layers(sample_shape, n_kernels=(64, 128), lr: float = 0.001):
    """ImagenetAE-scale encoder/decoder stack (reference:
    tests/research/ImagenetAE — strided conv pyramid mirrored by a deconv
    pyramid).  ``k4 s2 p1`` halves/doubles the spatial size exactly, so
    the decoder round-trips the encoder for any power-of-two input."""
    geom = {"kx": 4, "ky": 4, "sliding": (2, 2), "padding": (1, 1, 1, 1)}
    gd = {"learning_rate": lr, "gradient_moment": 0.9}
    k1, k2 = n_kernels
    return [
        {"type": "conv_relu", "->": {"n_kernels": k1, **geom}, "<-": gd},
        {"type": "conv_relu", "->": {"n_kernels": k2, **geom}, "<-": gd},
        {"type": "deconv", "->": {"n_kernels": k2, "n_channels": k1,
                                  **geom}, "<-": gd},
        {"type": "deconv", "->": {"n_kernels": k1,
                                  "n_channels": sample_shape[-1],
                                  **geom}, "<-": gd},
    ]


def build_deep(max_epochs: int = 10, minibatch_size: int = 64,
               sample_shape=(64, 64, 3), n_train: int = 256,
               n_valid: int = 0, n_kernels=(64, 128), fused: bool = True,
               mesh=None, snapshotter_config: dict | None = None,
               lr: float = 0.001) -> StandardWorkflow:
    """BASELINE.md config 4 at representative scale: 64x64x3 input,
    64/128-kernel strided encoder, mirrored deconv decoder.  ``lr`` (the
    port's addition, passed to ``deep_layers``) keeps the reference's
    0.001 by default, which is tuned for the 16x16 inputs of its tests:
    the summed MSE gradient grows with the output area, and at 64x64 the
    reference's run and the port's both diverge at 0.001."""
    return StandardWorkflow(
        name="DeepConvAE", layers=deep_layers(sample_shape, n_kernels, lr),
        loss_function="mse", loader_name="synthetic_regression",
        loader_config={"sample_shape": tuple(sample_shape), "identity": True,
                       "n_train": n_train, "n_valid": n_valid,
                       "minibatch_size": minibatch_size},
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh)


def run(load, main):
    load(build)
    main()
