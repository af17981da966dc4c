"""Wine classification workflow — the port of ``znicz_tpu/models/
wine.py`` (reference: veles.znicz samples/Wine/wine.py — the smallest
sample: 13-feature vectors, 3 classes, one hidden layer; the reference's
"hello world" after MNIST).  Fused, the step trains on the SGD kernel;
eager, the tanh layer runs on the FC kernels.  A copy of the reference's
module, under the drift check of ``tests/test_torch_port_isolation.py``.
"""

from __future__ import annotations

from znicz_tpu_torch.standard_workflow import StandardWorkflow

def layers(lr: float = 0.3, moment: float = 0.5, hidden: int = 10):
    return [
        {"type": "all2all_tanh", "->": {"output_sample_shape": hidden},
         "<-": {"learning_rate": lr, "gradient_moment": moment}},
        {"type": "softmax", "->": {"output_sample_shape": 3},
         "<-": {"learning_rate": lr, "gradient_moment": moment}},
    ]


LAYERS = layers()


def build(max_epochs: int = 20, minibatch_size: int = 10,
          n_train: int = 150, n_valid: int = 30, lr: float = 0.3,
          hidden: int = 10, fused: bool = True,
          mesh=None, snapshotter_config: dict | None = None
          ) -> StandardWorkflow:
    return StandardWorkflow(
        name="Wine", layers=layers(lr=lr, hidden=hidden),
        loss_function="softmax",
        loader_name="synthetic_classifier",
        loader_config={"n_classes": 3, "sample_shape": (13,),
                       "n_train": n_train, "n_valid": n_valid,
                       "minibatch_size": minibatch_size, "spread": 3.0,
                       "noise": 1.0},
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh)


def run(load, main):
    load(build)
    main()
