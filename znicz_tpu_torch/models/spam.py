"""Spam-filter workflow — the port of ``znicz_tpu/models/spam.py`` (a
copy, under the drift check of ``tests/test_torch_port_isolation.py``);
rebuild of the reference's SpamFilter research
sample (veles.znicz tests/research/SpamFilter: bag-of-words spam/ham
classification with an All2All stack over a lemmatized corpus).

The text_bow loader (znicz_tpu_torch.loader.text) reads ``train.txt`` /
``test.txt`` under ``root.common.dirs.datasets/spam_corpus`` (real corpus
files used as-is; a seeded two-class corpus is synthesized once
otherwise), builds the train-split vocabulary, and serves normalized
log1p bag-of-words vectors.
"""

from __future__ import annotations

from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.loader import text  # noqa: F401  (registry population)


def layers(hidden: int = 64, lr: float = 0.1, moment: float = 0.9,
           wd: float = 1e-4):
    hyper = {"learning_rate": lr, "gradient_moment": moment,
             "weights_decay": wd}
    return [
        {"type": "all2all_tanh", "->": {"output_sample_shape": hidden},
         "<-": dict(hyper)},
        {"type": "softmax", "->": {"output_sample_shape": 2},
         "<-": dict(hyper)},
    ]


def build(max_epochs: int = 10, minibatch_size: int = 50,
          n_train: int | None = None, n_valid: int | None = None,
          vocab_size: int = 256, hidden: int = 64, lr: float = 0.1,
          fused: bool = True, mesh=None,
          loader_config: dict | None = None,
          snapshotter_config: dict | None = None) -> StandardWorkflow:
    cfg = {"vocab_size": vocab_size, "n_train": n_train,
           "n_valid": n_valid, "minibatch_size": minibatch_size}
    cfg.update(loader_config or {})
    return StandardWorkflow(
        name="SpamFilter", layers=layers(hidden=hidden, lr=lr),
        loss_function="softmax", loader_name="text_bow", loader_config=cfg,
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh)


def run(load, main):
    load(build)
    main()
