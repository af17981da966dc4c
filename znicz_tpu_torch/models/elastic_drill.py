"""Elastic-drill workflow — the worker program of the port's
multi-process kill-and-resume drills, a copy of the reference's
``tools/elastic_workflow.py`` (the same code but for the package name in
its import).

Run under the fleet supervisor:

    python -m znicz_tpu_torch elastic --workers 2 --snap-dir /tmp/snaps \\
        znicz_tpu_torch/models/elastic_drill.py -d cpu

Reads the fleet's env contract (``resilience/elastic.py``): the
snapshotter writes into ``$ZNICZ_TPU_SNAP_DIR`` (rank 0 writes, other
ranks verify), ``$ZNICZ_TPU_ELASTIC_EPOCHS`` overrides the epoch budget,
and on natural completion each worker drops ``history_<rank>.json`` —
the drill's bit-exactness evidence — next to the snapshots.  A SIGTERM'd
worker exits 143 inside ``main()`` and never writes a history.

The loader is noisy (spread 1.2, noise 2.0) so the error curve stays
non-zero across epochs: a resume bug cannot hide behind a history of
all-zero metrics.
"""

import json
import os

from znicz_tpu_torch.standard_workflow import StandardWorkflow

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
     "<-": {"learning_rate": 0.02, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.02, "gradient_moment": 0.9}},
]
LOADER = {"n_classes": 4, "sample_shape": (8, 8), "n_train": 120,
          "n_valid": 60, "minibatch_size": 30, "spread": 1.2, "noise": 2.0}


def build():
    snap_dir = os.environ.get("ZNICZ_TPU_SNAP_DIR")
    snap_cfg = None
    if snap_dir:
        snap_cfg = {"directory": snap_dir, "prefix": "ew",
                    "only_improved": False, "keep_all": True,
                    "verify_timeout": 2.0}
    return StandardWorkflow(
        name="ElasticDrill", layers=LAYERS, loss_function="softmax",
        loader_name="synthetic_classifier", loader_config=LOADER,
        decision_config={
            "max_epochs": int(os.environ.get("ZNICZ_TPU_ELASTIC_EPOCHS",
                                             "4"))},
        snapshotter_config=snap_cfg)


def run(load, main):
    workflow, _ = load(build)
    main()
    snap_dir = os.environ.get("ZNICZ_TPU_SNAP_DIR")
    if snap_dir:
        rank = os.environ.get("ZNICZ_TPU_ELASTIC_RANK", "0")
        out = os.path.join(snap_dir, f"history_{rank}.json")
        with open(out, "w") as f:
            json.dump({"rank": int(rank),
                       "history": workflow.decision.metrics_history},
                      f, default=float)
