"""Trainer worker program for the learn plane (the port of
``znicz_tpu/learn/trainer_workflow.py``) — the file
``python -m znicz_tpu_torch`` (and therefore the elastic supervisor) runs as
the continuous-learning trainer:

    python -m znicz_tpu_torch elastic --workers 1 --no-spmd \\
        --snap-dir /run/learn/snaps \\
        znicz_tpu_torch/learn/trainer_workflow.py [-d cpu] \\
        -o root.learn.spool_dir=/run/learn/spool \\
        -o root.learn.package=/run/lm.npz \\
        -o root.learn.publish_dir=/run/learn/publish

Control graph (the char_lm shape over the streaming loader)::

    Repeater -> SpoolSequenceLoader -> TransformerLMStep
             -> DecisionMSE -> NNSnapshotter -> LMPublisher -> Repeater

The base LM package supplies the vocabulary AND the starting weights —
the trainer continues the weights the fleet is serving (the VELES
master-owns-canonical-weights loop), and every ``publish_every`` epochs
exports a fresh package the adoption bridge rolls out.  The step is
the port's ``TransformerLMStep``: on the card its train and eval
minibatches are CUDA graph replays through the flash kernels.

Config (``root.learn.*``, all overridable with ``-o``):

=====================  ======================================================
``spool_dir``          feedback spool directory (required)
``package``            base LM package: charmap + architecture + init params
                       (required)
``publish_dir``        manifest + exported packages (default:
                       ``<spool_dir>/../publish``)
``publish_every``      publish every K epochs (default 2)
``max_epochs``         stop after this many epochs (default 4)
``records_per_epoch``  stream slice one epoch trains on (default 8)
``seq_len``            training window length (default 16)
``minibatch_size``     rows per minibatch (default 8)
``lr``                 SGD learning rate (default 0.05)
``pipeline_depth``     async input-pipeline depth (0 = sync; default 2)
``wait_timeout_s``     epoch-ingest wait budget (default 300)
=====================  ======================================================

Snapshots land in ``$ZNICZ_TPU_SNAP_DIR`` (the elastic env contract);
on natural completion the worker drops ``history_<rank>.json`` beside
them — the overlap drill's bit-exactness evidence, exactly the
``models/elastic_drill.py`` convention.
"""

from __future__ import annotations

import json
import os


def build():
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.core.plumbing import Repeater
    from znicz_tpu_torch.learn.publish import LMPublisher
    from znicz_tpu_torch.loader.spool import SpoolSequenceLoader
    from znicz_tpu_torch.units.decision import DecisionMSE
    from znicz_tpu_torch.units.lm import TransformerLMStep
    from znicz_tpu_torch.units.nn_units import NNWorkflow
    from znicz_tpu_torch.utils.export import load_lm

    cfg = root.learn
    spool_dir = str(cfg.get("spool_dir", "") or "")
    package = str(cfg.get("package", "") or "")
    if not spool_dir or not package:
        raise ValueError(
            "the learn trainer needs -o root.learn.spool_dir=DIR and "
            "-o root.learn.package=LM.npz")
    publish_dir = str(cfg.get("publish_dir", "") or "") or \
        os.path.join(os.path.dirname(os.path.abspath(spool_dir)),
                     "publish")
    params, meta = load_lm(package)
    charmap = meta.get("charmap")
    if not charmap:
        raise ValueError(f"{package!r} carries no charmap — the learn "
                         f"plane trains char LMs over the serving "
                         f"vocabulary")

    w = NNWorkflow(name="LearnTrainer")
    w.repeater = Repeater(w)
    w.loader = SpoolSequenceLoader(
        w, spool_dir=spool_dir, charmap=charmap,
        seq_len=int(cfg.get("seq_len", 16)),
        records_per_epoch=int(cfg.get("records_per_epoch", 8)),
        minibatch_size=int(cfg.get("minibatch_size", 8)),
        wait_timeout_s=float(cfg.get("wait_timeout_s", 300.0)))
    step = w.step = TransformerLMStep(
        w, loader=w.loader, n_layers=int(meta["n_layers"]),
        d=int(meta["d"]), heads=int(meta["heads"]), ff=int(meta["ff"]),
        lr=float(cfg.get("lr", 0.05)))
    # continuous learning: start from the weights the fleet serves
    # (xla_init places a pre-set pytree instead of initializing fresh)
    step._params = params
    dec = w.decision = DecisionMSE(
        w, max_epochs=int(cfg.get("max_epochs", 4)))
    w.forwards = [step]
    w.gds = []

    w.repeater.link_from(w.start_point)
    w.loader.link_from(w.repeater)
    step.link_from(w.loader)
    dec.link_from(step)
    tail = dec
    snap_dir = os.environ.get("ZNICZ_TPU_SNAP_DIR")
    if snap_dir:
        from znicz_tpu_torch.snapshotter import NNSnapshotter
        snap = w.snapshotter = NNSnapshotter(
            w, directory=snap_dir, prefix="learn",
            only_improved=False, keep_all=True, verify_timeout=2.0)
        snap.link_from(dec)
        snap.link_workflow_state(w)
        snap.gate_skip = ~dec.epoch_ended
        tail = snap
    pub = w.publisher = LMPublisher(
        w, step=step, decision=dec, publish_dir=publish_dir,
        every=int(cfg.get("publish_every", 2)))
    pub.link_from(tail)
    # publish at the same boundary the snapshot covers: the announced
    # weights are always resumable state
    pub.gate_skip = ~dec.epoch_ended
    tail = pub
    w.repeater.link_from(tail)
    w.end_point.link_from(tail)
    w.end_point.gate_block = ~dec.complete

    dec.link_attrs(w.loader, "minibatch_class", "last_minibatch",
                   "class_lengths", "epoch_number")
    dec.link_attrs(step, "minibatch_mse", "minibatch_size")
    depth = int(cfg.get("pipeline_depth", 2))
    if depth:
        from znicz_tpu_torch.pipeline import attach_prefetcher
        attach_prefetcher(w.loader, stager=step.make_stager(),
                          depth=depth)
    return w


def run(load, main):
    w, _ = load(build)
    main()
    snap_dir = os.environ.get("ZNICZ_TPU_SNAP_DIR")
    if snap_dir:
        # the bit-exactness evidence (elastic_workflow.py convention):
        # a SIGTERM'd worker exits 143 inside main() and never writes
        rank = os.environ.get("ZNICZ_TPU_ELASTIC_RANK", "0")
        out = os.path.join(snap_dir, f"history_{rank}.json")
        with open(out, "w") as f:
            json.dump({"rank": int(rank),
                       "history": w.decision.metrics_history},
                      f, default=float)
