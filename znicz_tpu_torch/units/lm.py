"""Transformer language-model step unit — the port of
``znicz_tpu/units/lm.py``: it wires the transformer stack
(``parallel/transformer.py``: flash attention, the ``(data, seq,
model)`` mesh, MoE blocks, remat policies, mixed precision) into the
unit graph with the fused step's control contract: Repeater -> Loader
-> step -> Decision.

``mesh`` is the step's (a ``parallel/mesh.py Mesh`` or ``{axis:
size}``); None is a data-only mesh over the world
(``launcher.multihost``), a mesh of one outside any world.  Every rank
runs the same loader over the same global minibatches.

Per minibatch it stages this rank's block of (tokens, labels, padding
mask) on the device in one pinned host-to-device copy, runs the train
step or the eval pass (each a CUDA graph replay on the card from its
second call) and reads the global loss back: one sync a minibatch, the
``minibatch_mse`` the decision watches.  The input pipeline stages the
next minibatch on a side stream instead
(:meth:`TransformerLMStep.make_stager`).  ``state_dict``,
``export_lm`` and so the snapshotter gather the global params: on a
mesh a collective every rank makes.

Torch-only, as the reference's is XLA-only: ``numpy_init`` raises.
``anatomy=True`` builds the step's split-dispatch form
(``make_train_step(anatomy=True)``, ``plane="transformer"``) and times
the synchronous path's host-to-device staging as the plane's ``stage``
phase.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.observe import probe
from znicz_tpu_torch.parallel import mesh as _mesh
from znicz_tpu_torch.parallel import transformer as tfm
from znicz_tpu_torch.pipeline import (ready_on_current_stream,
                                      ring_safe_stager)


class TransformerLMStep(AcceleratedUnit):
    """One train-or-eval step per served (tokens, labels) minibatch.

    Publishes ``minibatch_mse`` (mean CE loss per token — the DecisionMSE
    contract: a lower-is-better per-sample metric).  Params live on the
    device and update in place; the loss read is the only device-to-host
    sync per minibatch.
    """

    def __init__(self, workflow=None, loader=None, n_layers: int = 2,
                 d: int = 32, heads: int = 2, ff: Optional[int] = None,
                 lr: float = 0.1, mesh=None,
                 loss_chunks: Optional[int] = None,
                 head_sharded: bool = False,
                 n_experts: Optional[int] = None,
                 moe_aux_weight: float = 0.0,
                 moe_top_k: int = 1,
                 moe_zloss_weight: float = 0.0,
                 remat_policy: Optional[str] = None,
                 anatomy: Optional[bool] = None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.loader = loader
        self.n_layers = int(n_layers)
        self.d = int(d)
        self.heads = int(heads)
        self.ff = int(ff) if ff is not None else 4 * self.d
        self.lr = float(lr)
        self.mesh = mesh
        #: CE loss chunk count — set when vocab ≫ d so the (tokens,
        #: vocab) logits never materialize
        self.loss_chunks = loss_chunks
        #: vocab-shard the LM head over the mesh's model axis
        self.head_sharded = head_sharded
        #: MoE FFN blocks: expert count, load-balance aux and router
        #: z-loss weights (training loss only), and routing k
        self.n_experts = n_experts
        self.moe_aux_weight = float(moe_aux_weight)
        self.moe_top_k = int(moe_top_k)
        self.moe_zloss_weight = float(moe_zloss_weight)
        if n_experts is None and (self.moe_aux_weight != 0.0 or
                                  self.moe_zloss_weight != 0.0 or
                                  self.moe_top_k != 1):
            raise ValueError(
                "moe_aux_weight/moe_zloss_weight/moe_top_k have no "
                "effect without "
                "n_experts — a dense model would train silently")
        #: selective rematerialization of each block (the port's own
        #: option here: the reference's unit builds its step without one)
        self.remat_policy = remat_policy
        #: step-anatomy split-dispatch mode: the train step runs its
        #: phases eagerly with host stamps between them, feeding
        #: znicz_anatomy_*{plane="transformer"} — explicit-sum reduction
        #: semantics, see make_train_step(anatomy=True).
        #: None -> root.common.engine.step_anatomy (False)
        self.anatomy = anatomy
        self.vocab_size: Optional[int] = None
        # decision links (DecisionMSE contract)
        self.minibatch_mse = 0.0
        self.minibatch_size = 0
        self._params = None       # numpy pytree until initialize, then
        #                           the device tensors the step updates
        self._step = None
        self._eval = None
        self._dev = None
        self._h2d_stream = None   # the input pipeline's side stream
        self._arange = None

    # -- lifecycle ----------------------------------------------------------
    def numpy_init(self) -> None:
        raise NotImplementedError(
            "TransformerLMStep runs on torch only (a TorchDevice: -d cuda "
            "or -d cpu); the transformer stack has no numpy oracle by "
            "design")

    def torch_init(self) -> None:
        if self.loader is None:
            raise ValueError("TransformerLMStep needs loader=")
        if self.anatomy is None:
            self.anatomy = bool(root.common.engine.get("step_anatomy",
                                                       False))
        self.vocab_size = int(self.loader.vocab_size)
        self._dev = self.device.torch_device
        if self.mesh is None and _mesh.world()[1] > 1:
            self.mesh = {"data": _mesh.world()[1], "seq": 1, "model": 1}
        if self.mesh is not None and not isinstance(self.mesh, _mesh.Mesh):
            self.mesh = _mesh.make_mesh(dict(getattr(self.mesh, "shape",
                                                     self.mesh)))
        if self._params is None:
            self._params = tfm.init_params(
                prng.get(), self.n_layers, self.d, self.heads, self.ff,
                self.vocab_size, n_experts=self.n_experts)
        # masked: the loader's padded tail rows contribute neither loss
        # nor gradients
        arch = (self.mesh, self.n_layers, self.d, self.heads, self.ff,
                self.vocab_size)
        common = dict(compute_dtype=self.device.compute_dtype, masked=True,
                      loss_chunks=self.loss_chunks,
                      head_sharded=self.head_sharded,
                      n_experts=self.n_experts, moe_top_k=self.moe_top_k,
                      device=self._dev)
        self._step = tfm.make_train_step(
            *arch, lr=self.lr, moe_aux_weight=self.moe_aux_weight,
            moe_zloss_weight=self.moe_zloss_weight,
            remat_policy=self.remat_policy, anatomy=bool(self.anatomy),
            **common)
        self._eval = tfm.make_eval_loss(*arch, **common)
        self._params = self._place(self._params)
        if self._dev.type == "cuda":
            self._h2d_stream = torch.cuda.Stream(self._dev)
        #: reused mask row — the hot loop allocates no index per step
        self._arange = np.arange(self.loader.max_minibatch_size)

    def _place(self, params) -> dict:
        """A global numpy pytree as this rank's blocks on the device (the
        step's layout on its mesh)."""
        return tfm.params_from_numpy(params, self._dev, mesh=self.mesh,
                                     specs=self._step.specs)

    def _global_params(self) -> dict:
        """The global numpy pytree (a collective on a mesh)."""
        return tfm.params_to_numpy(self._params, self.mesh,
                                   self._step.specs if self.mesh is not None
                                   else None)

    def _stage_batch(self, tokens, labels, count: int) -> tuple:
        """This rank's block of (tokens, labels, mask) on the step's
        device in ONE host-to-device copy: packed into one int64 block,
        pinned on the card (PyTorch's caching host allocator keeps it
        until the copy is done), then split into views.  Shared by the
        synchronous path and the input-pipeline stager."""
        tokens, labels, mask = self._step.cut(
            np.asarray(tokens), np.asarray(labels),
            self._arange[:np.shape(tokens)[0]] < count)
        b, t = np.shape(tokens)
        packed = np.empty(2 * b * t + b, np.int64)
        packed[:b * t] = np.reshape(tokens, -1)
        packed[b * t:2 * b * t] = np.reshape(labels, -1)
        packed[2 * b * t:] = mask
        host = torch.from_numpy(packed)
        if self._dev.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self._dev, non_blocking=True)
        return (dev[:b * t].view(b, t), dev[b * t:2 * b * t].view(b, t),
                dev[2 * b * t:].bool())

    def make_stager(self):
        """Producer-side staging for the input pipeline
        (``znicz_tpu_torch.pipeline``): the worker copies the next
        batch's (tokens, labels, mask) to the card on a side stream
        while the current step runs, through
        :func:`~znicz_tpu_torch.pipeline.ring_safe_stager`; ``torch_run``
        makes its stream wait on the staging event.  Made before
        ``initialize``, so it reads the device and the stream at each
        call."""
        def stage(rec, arrays):
            tokens, labels = arrays["data"], arrays["labels"]
            staged, event = ring_safe_stager(
                lambda t, lab: self._stage_batch(t, lab, rec["size"]),
                self._dev, self._h2d_stream)(tokens, labels)
            nbytes = tokens.nbytes + labels.nbytes + self._arange.size
            return {"lm": staged, "event": event}, nbytes
        return stage

    # -- compute ------------------------------------------------------------
    def numpy_run(self) -> None:
        self.numpy_init()

    def torch_run(self) -> None:
        loader = self.loader
        count = int(loader.minibatch_size)
        staged = loader.take_staged() \
            if getattr(loader, "pipeline", None) is not None else None
        if staged is not None:
            # pipelined feeding: the prefetch worker already issued the
            # copy, overlapped with the previous step
            inputs = staged["lm"]
            ready_on_current_stream(inputs, staged["event"])
        elif self.anatomy:
            t0 = time.perf_counter()
            inputs = self._stage_batch(loader.minibatch_data.mem,
                                       loader.minibatch_labels.mem, count)
            probe.anatomy_phase("transformer", "stage",
                                time.perf_counter() - t0, t0=t0)
        else:
            inputs = self._stage_batch(loader.minibatch_data.mem,
                                       loader.minibatch_labels.mem, count)
        if int(loader.minibatch_class) == TRAIN:
            self._params, loss = self._step.local(self._params, *inputs)
        else:
            loss = self._eval.local(self._params, *inputs)
        self.minibatch_mse = float(loss)
        self.minibatch_size = count

    # -- serving handoff ----------------------------------------------------
    def export_lm(self, path: str,
                  draft_layers: int | None = None) -> str:
        """Package the trained params as a generative serving artifact
        (``utils/export.py::export_lm``): weights + architecture + the
        loader's charmap, bootable by ``python -m znicz_tpu_torch
        generate`` into the paged decode plane.  ``draft_layers=k`` also
        ships a layer-truncated draft (the first k blocks + the shared
        embedding and head) for speculative decoding.  On a mesh every
        rank calls it (the params' gather is collective) and rank 0
        writes."""
        from znicz_tpu_torch.serve.paged import truncate_draft
        from znicz_tpu_torch.utils.export import export_lm

        if self._step is None:
            raise ValueError("export_lm needs an initialized workflow "
                             "(params live on the device after "
                             "initialize)")
        if self.n_experts:
            raise ValueError("export_lm cannot package an MoE stack "
                             "(KV-cache decode serves dense FFN only)")
        params = self._global_params()
        if _mesh.world()[0] != 0:
            return path
        draft = truncate_draft(params, draft_layers) if draft_layers \
            else None
        charmap = list(getattr(self.loader, "vocab", []) or []) or None
        wf = getattr(self, "workflow", None)
        return export_lm(params, path, heads=self.heads, charmap=charmap,
                         name=getattr(wf, "name", None) or "char_lm",
                         draft_params=draft)

    # -- snapshot support ---------------------------------------------------
    def state_dict(self) -> dict:
        if self._params is None:
            return {}
        params = self._params if self._step is None else \
            self._global_params()
        return {"params": params}

    def load_state_dict(self, state: dict) -> None:
        if "params" not in state:
            return
        params = state["params"]
        # architecture validation — the generic snapshot restore checks
        # the pytree's keys; the shapes' meaning is this unit's contract
        restored_vocab = int(params["emb"].shape[0])
        if len(params["blocks"]) != self.n_layers or \
                int(params["emb"].shape[1]) != self.d or \
                tuple(params["head"].shape) != (self.d, restored_vocab):
            raise ValueError(
                f"snapshot params (d={params['emb'].shape[1]}, "
                f"{len(params['blocks'])} blocks) do not match this "
                f"workflow (d={self.d}, {self.n_layers} blocks)")
        # the FFN flavor is architecture too: a dense snapshot cannot
        # restore into an MoE workflow (or vice versa), and the expert
        # count must match
        blk0 = params["blocks"][0]
        snap_experts = int(blk0["ew1"].shape[0]) if "ew1" in blk0 else None
        if snap_experts != (self.n_experts or None):
            raise ValueError(
                f"snapshot FFN flavor (n_experts={snap_experts}) does "
                f"not match this workflow (n_experts={self.n_experts})")
        # vocab must match what the loader SERVES NOW — after a restore
        # the loader has adopted the snapshot vocab (CharSequenceLoader
        # snapshots it), so a mismatch means a genuinely different corpus
        live_vocab = int(self.loader.vocab_size) \
            if self.loader is not None else self.vocab_size
        if live_vocab and restored_vocab != live_vocab:
            raise ValueError(
                f"snapshot params carry vocab {restored_vocab} but the "
                f"loader serves vocab {live_vocab} — the corpus does not "
                f"match the snapshot")
        self.vocab_size = restored_vocab
        if self._step is None:
            self._params = params
            return
        # initialized: copy this rank's blocks into the live tensors,
        # which the captured graphs read and update
        params = {"emb": params["emb"], "head": params["head"],
                  "blocks": [{k: snap[k] for k in blk} for blk, snap in
                             zip(self._params["blocks"], params["blocks"])]}
        try:
            placed = self._place(params)
        except ValueError as exc:
            raise ValueError(f"snapshot params' shapes do not match this "
                             f"workflow's (ff={self.ff}): {exc}") from exc
        pairs = list(zip(tfm._leaves(self._params), tfm._leaves(placed)))
        bad = [tuple(a.shape) for w, a in pairs
               if tuple(w.shape) != tuple(a.shape)]
        if bad:
            raise ValueError(f"snapshot params' shapes do not match this "
                             f"workflow's (ff={self.ff}): {bad[:3]}")
        with torch.no_grad():
            for w, a in pairs:
                w.copy_(a)
