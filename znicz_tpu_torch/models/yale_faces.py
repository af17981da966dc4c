"""Yale-faces workflow — the port of ``znicz_tpu/models/yale_faces.py``
(rebuild of the reference's YaleFaces research sample, veles.znicz
tests/research/YaleFaces: subject identification over the Extended Yale
B grayscale face images, directory-per-subject layout, an All2AllTanh
hidden layer + softmax — the reference sample is an MLP).

Data path: the ``full_batch_image`` loader (``loader/image.py``) scans a
directory-per-class PNG tree under ``root.common.dirs.datasets/yale_faces``
(drop the real cropped Yale B images in that layout to use them; a
seeded stand-in tree is synthesized once otherwise), decodes to
grayscale, splits deterministically, and fits a mean_disp normalizer —
the reference pipeline's shape.  Fused, the decoded set is pinned on
the device and the step trains on the SGD kernel; eager, the layers run
on the FC kernels.  A copy of the reference's module, under the drift
check of ``tests/test_torch_port_isolation.py``.
"""

from __future__ import annotations

import os

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow

N_SUBJECTS = 15          # the Yale face database's subject count
IMAGE_SIZE = 32          # downscaled stand-in geometry


def layers(n_subjects: int = N_SUBJECTS, hidden: int = 100,
           lr: float = 0.02, moment: float = 0.9, wd: float = 1e-4):
    hyper = {"learning_rate": lr, "gradient_moment": moment,
             "weights_decay": wd}
    return [
        {"type": "all2all_tanh", "->": {"output_sample_shape": hidden},
         "<-": dict(hyper)},
        {"type": "softmax", "->": {"output_sample_shape": n_subjects},
         "<-": dict(hyper)},
    ]


def ensure_dataset(data_dir: str | None = None, n_subjects: int = N_SUBJECTS,
                   n_per_subject: int = 20,
                   size: int = IMAGE_SIZE) -> str:
    """Synthesize the stand-in face tree once (versioned, torn-synthesis
    safe — see loader.image.ensure_image_tree); real images in the same
    layout are used untouched."""
    from znicz_tpu_torch.loader.image import ensure_image_tree

    data_dir = data_dir or os.path.join(
        str(root.common.dirs.datasets), "yale_faces")
    return ensure_image_tree(data_dir, n_classes=n_subjects,
                             n_per_class=n_per_subject, size=(size, size))


def build(max_epochs: int = 10, minibatch_size: int = 25,
          n_subjects: int = N_SUBJECTS, image_size: int = IMAGE_SIZE,
          lr: float = 0.02, valid_fraction: float = 0.25,
          fused: bool = True, mesh=None,
          loader_config: dict | None = None,
          snapshotter_config: dict | None = None) -> StandardWorkflow:
    cfg = {"data_dir": ensure_dataset(
               (loader_config or {}).get("data_dir"),
               n_subjects=n_subjects, size=image_size),
           "sample_shape": (image_size, image_size, 1),
           "valid_fraction": valid_fraction,
           "minibatch_size": minibatch_size,
           "normalization_type": "mean_disp"}
    cfg.update(loader_config or {})
    return StandardWorkflow(
        name="YaleFaces", layers=layers(n_subjects=n_subjects, lr=lr),
        loss_function="softmax", loader_name="full_batch_image",
        loader_config=cfg,
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=snapshotter_config, fused=fused, mesh=mesh)


def run(load, main):
    load(build)
    main()
