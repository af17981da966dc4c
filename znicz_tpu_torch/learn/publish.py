"""LM package publication — the trainer's half of the VELES
master-loop; the port of ``znicz_tpu/learn/publish.py``.  Every K epochs
the live training params are exported through the existing
``export_lm`` path and announced in an atomic manifest the adoption
bridge polls.

Publish protocol (all writes atomic, so a reader never sees a torn
package or a manifest naming a half-written file):

1. ``step.export_lm`` writes ``lm_e<epoch>.npz`` (export_lm's own
   pid-unique tmp + rename);
2. ``manifest.json`` is rewritten (tmp + rename) with the package
   path, its content fingerprint (``utils/naming.py``), the epoch and
   a wall stamp — the fingerprint in the manifest is what the bridge
   compares against the fleet's current one, and the wall stamp is the
   start of the publish-to-adopted latency clock.

Republishing after an elastic resume is harmless by construction: the
resumed trainer's params are bit-identical (the overlap drill's pin),
so epoch K's re-export carries the same sha256 and the bridge sees
nothing new.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.observe import registry as _reg
from znicz_tpu_torch.utils.naming import package_fingerprint

MANIFEST_NAME = "manifest.json"
MANIFEST_SCHEMA = "znicz_tpu.learn/1"

_M_PUBLISHES = _reg.counter(
    "znicz_learn_publishes_total",
    "LM packages the trainer exported and announced in the publish "
    "manifest (one per K-epoch boundary; the adoption bridge's input)")


def manifest_path(publish_dir: str) -> str:
    return os.path.join(publish_dir, MANIFEST_NAME)


def latest_manifest(publish_dir: str) -> Optional[dict]:
    """The newest published package, or None while nothing was
    published (or the manifest is mid-rewrite — rename is atomic, so a
    parse failure only ever means "not yet")."""
    try:
        with open(manifest_path(publish_dir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("schema") != MANIFEST_SCHEMA:
        return None
    return doc


def publish_package(step, publish_dir: str, epoch: int,
                    seq: int, keep: int = 8) -> dict:
    """Export the step's live params and announce them; returns the
    manifest written.  ``keep`` bounds the publish dir the way
    ``max_segments`` bounds the spool: superseded ``lm_e*.npz``
    packages beyond the newest ``keep`` are unlinked (the manifest's
    current package is always among them, since it is always the
    newest) — a long-running continuous-learning deployment must not
    grow the disk one dead package per K epochs."""
    os.makedirs(publish_dir, exist_ok=True)
    pkg = os.path.join(publish_dir, f"lm_e{epoch:05d}.npz")
    step.export_lm(pkg)
    doc = {"schema": MANIFEST_SCHEMA, "package": os.path.abspath(pkg),
           "epoch": int(epoch), "seq": int(seq),
           "fingerprint": package_fingerprint(pkg),
           "ts": round(time.time(), 3)}
    path = manifest_path(publish_dir)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    _M_PUBLISHES.inc()
    stale = sorted(n for n in os.listdir(publish_dir)
                   if n.startswith("lm_e") and n.endswith(".npz"))[
                       :-max(1, int(keep))]
    for name in stale:
        try:
            os.unlink(os.path.join(publish_dir, name))
        except OSError:
            pass                      # retention must never fail a
    return doc                        # publish


class LMPublisher(Unit):
    """Workflow unit: export + announce every ``every``-th epoch.

    Linked after the snapshotter (decision -> snapshotter -> publisher)
    with ``gate_skip = ~decision.epoch_ended``, so a publish happens at
    the SAME boundary the training snapshot covers — the published
    weights are always resumable state, never mid-epoch params.  Rank 0
    only (the single-writer election the snapshotter uses).
    """

    def __init__(self, workflow=None, step=None, decision=None,
                 publish_dir: str = "", every: int = 1,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if step is None or decision is None or not publish_dir:
            raise ValueError("LMPublisher needs step=, decision= and "
                             "publish_dir=")
        self.step = step
        self.decision = decision
        self.publish_dir = str(publish_dir)
        self.every = int(every)
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.published: list[dict] = []

    def run(self) -> None:
        epoch = int(self.decision.epoch_number)
        if epoch % self.every:
            return
        from znicz_tpu_torch.snapshotter import process_rank_world
        if process_rank_world()[0] != 0:
            return
        doc = publish_package(self.step, self.publish_dir, epoch,
                              seq=len(self.published) + 1)
        self.published.append(doc)
        self.info(f"published {os.path.basename(doc['package'])} "
                  f"(epoch {epoch}, sha256 "
                  f"{doc['fingerprint']['sha256'][:12]})")
