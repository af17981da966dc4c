"""Model ensembles — the port of ``znicz_tpu/utils/ensemble.py``
(rebuild of veles/ensemble/: ``--ensemble-train`` / ``--ensemble-test``):
train N seeded instances of a workflow, evaluate them as a committee.

Classification committees majority-vote the argmax predictions (ties
break toward the lower class id, deterministic); regression committees
average outputs.  Members run one after another on the local device.
The reference's module but for :meth:`Ensemble._member_outputs`, which
runs the port's fused step's forward (``FusedTrainStep._forward_chain``)
on the step's device, in the step's compute type.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.loader.base import VALID


def train_members_from_module(module, n_members: int, base_seed: int,
                              make_launcher: Callable) -> dict:
    """CLI ``--ensemble-train`` core: N seeded runs of a ``run(load,
    main)`` workflow module; returns the summary dict the CLI writes.
    Shared with :class:`Ensemble` semantics (prng.seed_all(base+i) per
    member, Decision best metric collected)."""
    members = []
    name = None
    for i in range(n_members):
        seed = base_seed + i
        prng.seed_all(seed)
        launcher = make_launcher()
        module.run(launcher.load, launcher.main)
        dec = launcher.workflow.decision
        name = launcher.workflow.name
        members.append({"member": i, "seed": seed,
                        "best_metric": dec.best_metric,
                        "best_epoch": dec.best_epoch,
                        "history": dec.metrics_history})
    # a member whose Decision never finished a train epoch reports
    # best_metric None — aggregate over the rest instead of crashing
    # after every member already trained
    scored = [m["best_metric"] for m in members
              if m["best_metric"] is not None]
    return {"workflow": name, "n_members": n_members,
            "best": min(scored) if scored else None,
            "mean": sum(scored) / len(scored) if scored else None,
            "members": members}


class Ensemble(Logger):
    """Train + evaluate a committee of identically-built workflows."""

    def __init__(self, builder: Callable, n_members: int = 5,
                 base_seed: int = 1000, **builder_kwargs) -> None:
        super().__init__()
        self.builder = builder
        self.n_members = n_members
        self.base_seed = base_seed
        self.builder_kwargs = builder_kwargs
        self.members: list = []

    def train(self, device) -> "Ensemble":
        """Reference --ensemble-train: N runs with distinct seeds."""
        for i in range(self.n_members):
            prng.seed_all(self.base_seed + i)
            w = self.builder(**self.builder_kwargs)
            w.initialize(device=device)
            w.run()
            w.stop()
            self.members.append(w)
            self.info(f"member {i}: best metric "
                      f"{w.decision.best_metric}")
        return self

    # -- committee evaluation ----------------------------------------------
    def _member_outputs(self, w, data: np.ndarray) -> np.ndarray:
        """Forward ``data`` through a trained member's fused params on
        the step's device -> float32 rows."""
        step = w.step
        if getattr(step, "shard_params", False):
            # flat-sharded layout: the step's leaves are this rank's
            # slices, so rebuild full w/b from the unit Arrays — train()'s
            # stop() already synced the final slices back into them
            params = [{k: torch.as_tensor(arr.map_read(), device=step._dev)
                       for k, arr in fwd.param_arrays().items()}
                      for fwd in step.forwards]
        else:
            params = [{k: v for k, v in leaf.items()}
                      for leaf in step._params]
        with torch.no_grad():
            out, _ = step._forward_chain(
                params, torch.as_tensor(np.asarray(data)).to(step._dev),
                train=False)
        return out.float().cpu().numpy()

    def predict_classes(self, data: np.ndarray) -> np.ndarray:
        """Majority vote over member argmaxes (reference --ensemble-test)."""
        votes = np.stack([self._member_outputs(w, data).argmax(axis=1)
                          for w in self.members])          # (n, batch)
        n_classes = self._member_outputs(self.members[0], data[:1]).shape[1]
        counts = np.apply_along_axis(
            lambda col: np.bincount(col, minlength=n_classes), 0, votes)
        return counts.argmax(axis=0)

    def predict_mean(self, data: np.ndarray) -> np.ndarray:
        return np.mean([self._member_outputs(w, data)
                        for w in self.members], axis=0)

    def test_classification(self) -> dict:
        """Evaluate the committee on the validation split of member 0's
        loader; returns committee + per-member error counts."""
        loader = self.members[0].loader
        off = loader.class_offset(VALID)
        n = loader.class_lengths[VALID]
        # served_dataset: the deterministic eval view (original_data may
        # hold RAW data for loaders that augment per serve)
        all_data, all_labels = loader.served_dataset()
        data = all_data[off:off + n]
        labels = all_labels[off:off + n]
        committee_err = int((self.predict_classes(data) != labels).sum())
        member_errs = [
            int((self._member_outputs(w, data).argmax(axis=1) != labels)
                .sum()) for w in self.members]
        self.info(f"committee err {committee_err}/{n}; members {member_errs}")
        return {"n": n, "committee_err": committee_err,
                "member_errs": member_errs}
