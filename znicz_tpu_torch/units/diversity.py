"""Weight-diversity diagnostic — the port of ``znicz_tpu/units/
diversity.py`` (rebuild of veles.znicz diversity.py's
``get_similar_kernels`` helpers: detect near-duplicate conv kernels as a
training-health signal).

Semantics: kernels (weight rows / conv filters flattened per output
channel) whose pairwise correlation exceeds ``threshold`` are grouped;
large groups mean the layer wastes capacity on redundant features (bad
init or a collapsed lr schedule).  One product computes the whole
correlation matrix, in torch on the weights' device (the reference's is
one XLA GEMM); the grouping is host-side union-find, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.core.units import Unit


def similarity_matrix(weights) -> np.ndarray:
    """(n_kernels, n_kernels) pairwise correlation of kernel vectors.

    ``weights`` is (n_kernels, fan_in) — All2All stores (in, out), conv
    stores HWIO; use :func:`kernels_of` to get this view.  A tensor is
    computed on its own device; an array goes to the card (pass a CPU
    tensor to compute on the host)."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=None if
                        isinstance(weights, torch.Tensor) else "cuda")
    w = w - w.mean(dim=1, keepdim=True)
    norm = torch.linalg.vector_norm(w, dim=1, keepdim=True)
    w = w / torch.clamp(norm, min=1e-12)
    return (w @ w.T).cpu().numpy()


def kernels_of(forward) -> torch.Tensor:
    """Per-output-channel kernel vectors of a forward unit's weights, on
    the forward's device (its device buffer on a TorchDevice, the host
    array on the numpy oracle)."""
    if isinstance(forward.weights.device, TorchDevice):
        w = forward.weights.devmem
    else:
        w = torch.from_numpy(np.asarray(forward.weights.map_read()))
    if w.ndim == 4:                     # conv HWIO -> (n_kernels, ky*kx*c)
        return w.reshape(-1, w.shape[3]).T
    return w.T                          # all2all (in, out) -> (out, in)


def get_similar_kernels(weights, threshold: float = 0.95
                        ) -> list[list[int]]:
    """Groups of kernel indices with pairwise correlation > threshold
    (reference: diversity.py :: get_similar_kernels — union-find over the
    thresholded similarity graph); ``weights`` as in
    :func:`similarity_matrix`."""
    sim = similarity_matrix(weights)
    n = sim.shape[0]
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if sim[i, j] > threshold:
                parent[find(i)] = find(j)
    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return sorted((g for g in groups.values() if len(g) > 1),
                  key=lambda g: (-len(g), g))


class Diversity(Unit):
    """Epoch-gated diagnostic unit: logs redundant-kernel groups per
    layer (wire after Decision with ``gate_skip = ~decision.epoch_ended``
    like the plotters).  Exposes ``report`` for tests/plotters."""

    def __init__(self, workflow=None, threshold: float = 0.95,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.threshold = float(threshold)
        self.forwards = []
        #: layer index -> list of duplicate groups, refreshed per run()
        self.report: dict[int, list[list[int]]] = {}

    def link_forwards(self, forwards) -> "Diversity":
        self.forwards = list(forwards)
        return self

    def run(self) -> None:
        self.report = {}
        for i, fwd in enumerate(self.forwards):
            if not getattr(fwd, "weights", None):
                continue
            groups = get_similar_kernels(kernels_of(fwd), self.threshold)
            if groups:
                self.report[i] = groups
                dup = sum(len(g) - 1 for g in groups)
                self.warning(
                    f"{fwd.name}: {dup} near-duplicate kernels "
                    f"(threshold {self.threshold}): {groups[:3]}")
