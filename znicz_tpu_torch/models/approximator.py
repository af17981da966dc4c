"""Approximator workflow — the port of ``znicz_tpu/models/
approximator.py`` (a copy, under the drift check of
``tests/test_torch_port_isolation.py``); rebuild of the reference's function-
approximation MSE sample (veles.znicz samples/Approximator: All2AllTanh
hidden layers into a linear All2All output trained against target
vectors with EvaluatorMSE + DecisionMSE).

Two dataset shapes via the synthetic_regression loader:
- default: targets are a fixed random linear map of the inputs — pure
  regression, Decision tracks validation mse;
- ``prototypes=P``: inputs are class blobs and targets the class's
  prototype vector — the reference's nearest-target classification
  shape, where EvaluatorMSE (eager) or the fused step's metrics (the
  label is recovered as the target's nearest prototype) report integer
  ``n_err``.
"""

from __future__ import annotations

from znicz_tpu_torch.standard_workflow import StandardWorkflow


def layers(target_dim: int = 4, hidden: int = 32, lr: float = 0.05,
           moment: float = 0.9, wd: float = 1e-4):
    hyper = {"learning_rate": lr, "gradient_moment": moment,
             "weights_decay": wd}
    return [
        {"type": "all2all_tanh", "->": {"output_sample_shape": hidden},
         "<-": dict(hyper)},
        {"type": "all2all", "->": {"output_sample_shape": target_dim},
         "<-": dict(hyper)},
    ]


def build(max_epochs: int = 10, minibatch_size: int = 40,
          sample_dim: int = 16, target_dim: int = 4, hidden: int = 32,
          n_train: int = 400, n_valid: int = 120, lr: float = 0.05,
          prototypes: int = 0, fused: bool = True, mesh=None,
          loader_config: dict | None = None,
          snapshotter_config: dict | None = None) -> StandardWorkflow:
    cfg = {"sample_shape": (sample_dim,), "target_shape": (target_dim,),
           "n_train": n_train, "n_valid": n_valid,
           "minibatch_size": minibatch_size, "prototypes": prototypes}
    cfg.update(loader_config or {})
    return StandardWorkflow(
        name="Approximator",
        layers=layers(target_dim=target_dim, hidden=hidden, lr=lr),
        loss_function="mse", loader_name="synthetic_regression",
        loader_config=cfg,
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh)


def run(load, main):
    load(build)
    main()
