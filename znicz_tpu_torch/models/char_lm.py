"""Character-level language model workflow — the port of
``znicz_tpu/models/char_lm.py`` (the transformer stack in the
``run(load, main)`` zoo contract).

Control graph (the Kohonen-demo shape): Repeater -> CharSequenceLoader
-> TransformerLMStep -> DecisionMSE -> Repeater.  The decision watches
mean validation cross-entropy per token; training stops on max_epochs or
stagnation like every other sample.  On the card every train and eval
minibatch is a CUDA graph replay on the flash kernels.

``remat_policy`` is the port's own argument (the reference's builder
has none), and ``run`` takes the builder's arguments from
``root.char_lm`` (`-o root.char_lm.d=512 -o root.char_lm.n_layers=6
...`), so the CLI trains any width; everything else is the
reference's.  ``mesh`` is the step's ``(data, seq, model)`` mesh (a
``{axis: size}``; from the CLI ``-o "root.char_lm.mesh={'data': 1,
'seq': 2, 'model': 2}"`` in a world of 4 started with
``--coordinator``), None a data-only mesh over the world.
"""

from __future__ import annotations

from znicz_tpu_torch.core.plumbing import Repeater
from znicz_tpu_torch.loader.sequence import CharSequenceLoader
from znicz_tpu_torch.units.decision import DecisionMSE
from znicz_tpu_torch.units.lm import TransformerLMStep
from znicz_tpu_torch.units.nn_units import NNWorkflow


def build(max_epochs: int = 3, seq_len: int = 32, minibatch_size: int = 16,
          n_layers: int = 2, d: int = 32, heads: int = 2, lr: float = 0.05,
          valid_fraction: float = 0.1, mesh=None, data_dir: str = "",
          snapshotter_config: dict | None = None,
          loss_chunks: int | None = None,
          head_sharded: bool = False,
          n_experts: int | None = None,
          moe_aux_weight: float = 0.0,
          moe_top_k: int = 1,
          moe_zloss_weight: float = 0.0,
          pipeline_depth: int | None = None,
          remat_policy: str | None = None) -> NNWorkflow:
    w = NNWorkflow(name="CharLM")
    w.repeater = Repeater(w)
    w.loader = CharSequenceLoader(
        w, data_dir=data_dir, seq_len=seq_len,
        minibatch_size=minibatch_size, valid_fraction=valid_fraction)
    # loss_chunks: chunked rematerialized CE (the vocab≫d lever);
    # n_experts/moe_*: the MoE FFN stack; remat_policy: selective remat
    step = w.step = TransformerLMStep(
        w, loader=w.loader, n_layers=n_layers, d=d, heads=heads, lr=lr,
        mesh=mesh, loss_chunks=loss_chunks, head_sharded=head_sharded,
        n_experts=n_experts,
        moe_aux_weight=moe_aux_weight, moe_top_k=moe_top_k,
        moe_zloss_weight=moe_zloss_weight, remat_policy=remat_policy)
    dec = w.decision = DecisionMSE(w, max_epochs=max_epochs)
    w.forwards = [step]      # snapshot inventory slot (params live here)
    w.gds = []

    w.repeater.link_from(w.start_point)
    w.loader.link_from(w.repeater)
    step.link_from(w.loader)
    dec.link_from(step)
    tail = dec
    if snapshotter_config is not None:
        from znicz_tpu_torch.snapshotter import NNSnapshotter
        snap = w.snapshotter = NNSnapshotter(w, **snapshotter_config)
        snap.link_from(dec)
        snap.link_workflow_state(w)
        snap.gate_skip = ~dec.epoch_ended
        tail = snap
    w.repeater.link_from(tail)
    w.end_point.link_from(tail)
    w.end_point.gate_block = ~dec.complete

    dec.link_attrs(w.loader, "minibatch_class", "last_minibatch",
                   "class_lengths", "epoch_number")
    dec.link_attrs(step, "minibatch_mse", "minibatch_size")
    if pipeline_depth:
        # input pipeline: the corpus windowing and the one staged copy
        # of tokens/labels/mask overlap the previous step
        from znicz_tpu_torch.pipeline import attach_prefetcher
        attach_prefetcher(w.loader, stager=step.make_stager(),
                          depth=pipeline_depth)
    return w


def run(load, main):
    from znicz_tpu_torch.core.config import root

    # the builder's arguments from the config tree (`-o
    # root.char_lm.d=512` or a config file), so the CLI trains any width
    # (the port's own hook: the reference's run builds the defaults)
    node = root.get("char_lm")
    w, _ = load(build, **(node.as_dict() if node else {}))
    main()
    # generative serving handoff: with
    # `-o root.common.engine.lm_export=path.npz` the trained params and
    # the corpus charmap land as an LM package that `python -m
    # znicz_tpu_torch generate` boots directly
    path = str(root.common.engine.get("lm_export", "") or "")
    if path:
        # multi-process runs: every rank gathers, only rank 0 writes
        from znicz_tpu_torch.snapshotter import process_rank_world
        w.step.export_lm(path)
        if process_rank_world()[0] == 0:
            print(f"char_lm: exported LM package -> {path}")
