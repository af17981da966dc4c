"""Forward and LM packages — the port of ``znicz_tpu/utils/export.py``
(rebuild of veles.znicz nn_units.py :: ForwardExporter and the
libVeles/libZnicz inference path).

A package is one ``.npz``: flat float32 weight arrays plus a JSON meta
block.  Both formats are byte-compatible with the reference's, so
packages cross between the two packages in both directions:

- the forward package (:func:`export_forward`, ``__arch__``: the
  StandardWorkflow's layer specs, ``{i}.weights`` / ``{i}.bias``),
  served by :class:`ExportedForward` (torch on the card or the CPU) or
  ``native/infer.py NativeForward`` (the C++ runtime);
- the LM package (:func:`export_lm`, ``__lm__``), whose
  :func:`load_lm` returns the numpy pytree that
  ``parallel.transformer.params_from_numpy`` carries onto a device.

A forge registry (``utils/forge.py``) holds forward packages:
:func:`forge_publish`, :func:`forge_fetch` (an :class:`ExportedForward`
on the card unless the caller names another device) and
:func:`forge_list`.

One divergence: the reference embeds ahead-of-time XLA executables in a
forward package (``attach_aot``, ``__aot__<bucket>`` entries, the
``aot`` CLI).  The port has no XLA executables, so it has no
counterpart: a package that carries ``__aot__`` entries loads here and
those entries are ignored (``ExportedForward.ignored_aot``); on the card
each serving bucket is captured into a CUDA graph at warmup instead.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

#: schema tag of a forward package's ``__arch__`` meta
FORWARD_FORMAT = "znicz_tpu.forward"

#: npz entry prefix of the reference's per-bucket AOT executables
_AOT_PREFIX = "__aot__"


def export_forward(workflow, path: str, use_ema: bool = False,
                   aot_max_batch: int | None = None) -> str:
    """Package a StandardWorkflow's forward chain (layer specs + trained
    weights) into ``path`` (.npz), in the reference's format.
    ``use_ema=True`` ships the fused step's Polyak-averaged mirrors
    instead of the raw weights (the usual serving choice when
    ``ema_decay`` was on).  ``aot_max_batch`` (the reference's
    ahead-of-time executables) has no counterpart here and raises."""
    if aot_max_batch is not None:
        raise ValueError("aot_max_batch: the port embeds no ahead-of-time "
                         "executables (no XLA); its serving engine "
                         "captures each bucket into a CUDA graph at "
                         "warmup")
    if not hasattr(workflow, "layer_specs"):
        raise TypeError("export_forward needs a StandardWorkflow (layer "
                        "specs carry the architecture)")
    step = getattr(workflow, "step", None)
    if step is not None and getattr(step, "_params", None) is not None:
        step.sync_to_units()
    ema = None
    if use_ema:
        if step is None or getattr(step, "ema_decay", None) is None:
            raise ValueError("use_ema=True needs a fused workflow built "
                             "with ema_decay")
        if getattr(step, "_params", None) is None:
            raise ValueError("use_ema=True needs an initialized workflow "
                             "(the EMA mirrors live in the step's device "
                             "params)")
        ema = step.ema_params()
    arch = []
    arrays = {}
    for i, ((type_name, _unit_name, fwd_kwargs, _gd), fwd) in enumerate(
            zip(workflow.layer_specs, workflow.forwards)):
        arch.append({"type": type_name, "config": fwd_kwargs})
        for attr, ema_key in (("weights", "w"), ("bias", "b")):
            arr = getattr(fwd, attr)
            if arr:
                if ema is not None and ema_key in ema[i]:
                    arrays[f"{i}.{attr}"] = np.asarray(ema[i][ema_key])
                else:
                    arrays[f"{i}.{attr}"] = np.asarray(arr.map_read())
    meta = {"format": FORWARD_FORMAT, "version": 1, "arch": arch,
            "name": workflow.name, "ema": bool(use_ema),
            "input_shape": list(workflow.loader.minibatch_data.shape[1:])}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __arch__=np.array(json.dumps(meta)), **arrays)
    os.replace(tmp, path)
    return path

#: schema tag for transformer LM packages (serve/kvcache.py consumers)
LM_FORMAT = "znicz_tpu.lm/1"


def _lm_arch(params, heads: int, prefix: str = ""):
    """-> (arch meta dict, flat arrays dict) for one transformer param
    pytree — shared by the target and draft halves of a package."""
    vocab, d = (int(s) for s in np.shape(params["emb"]))
    blocks = params["blocks"]
    if any("ew1" in blk for blk in blocks):
        raise ValueError("export_lm supports dense FFN stacks only "
                         "(KV-cache decode does not serve MoE)")
    ff = int(np.shape(blocks[0]["w1"])[1])
    if d % int(heads):
        raise ValueError(f"heads={heads} must divide d={d}")
    arrays = {f"{prefix}emb": np.asarray(params["emb"], np.float32),
              f"{prefix}head": np.asarray(params["head"], np.float32)}
    for i, blk in enumerate(blocks):
        for key, arr in blk.items():
            arrays[f"{prefix}blocks.{i}.{key}"] = \
                np.asarray(arr, np.float32)
    meta = {"n_layers": len(blocks), "d": d, "heads": int(heads),
            "ff": ff, "vocab": vocab}
    return meta, arrays


def export_lm(params, path: str, *, heads: int, charmap=None,
              name: str = "lm", draft_params=None,
              draft_heads: int | None = None) -> str:
    """Package a ``parallel/transformer.py`` param pytree as a
    generative serving artifact (.npz): flat weight arrays plus an
    ``__lm__`` meta block carrying the architecture (layers/d/heads/ff/
    vocab — everything :class:`~znicz_tpu_torch.serve.kvcache.KVDecoder`
    needs) and, for char LMs, the ``charmap`` (id -> character) so the
    server can speak text on the wire.  ``heads`` is the one
    architecture fact the shapes cannot reveal.

    ``draft_params`` ships a smaller DRAFT transformer over the same
    vocab alongside the target: its arrays ride under a
    ``draft.`` prefix and its architecture under ``meta["draft"]``, so
    ``--speculative`` serving boots both from one artifact
    (:func:`load_lm_draft`).  ``draft_heads`` defaults to ``heads``."""
    arch, arrays = _lm_arch(params, heads)
    vocab = arch["vocab"]
    if charmap is not None and len(charmap) != vocab:
        raise ValueError(f"charmap has {len(charmap)} entries but the "
                         f"embedding carries vocab {vocab}")
    meta = {"format": LM_FORMAT, "name": name, **arch,
            "charmap": list(charmap) if charmap is not None else None,
            "draft": None}
    if draft_params is not None:
        draft_arch, draft_arrays = _lm_arch(
            draft_params, heads if draft_heads is None else draft_heads,
            prefix="draft.")
        if draft_arch["vocab"] != vocab:
            raise ValueError(
                f"draft vocab {draft_arch['vocab']} != target vocab "
                f"{vocab} — the draft must share the charmap")
        meta["draft"] = draft_arch
        arrays.update(draft_arrays)
    # pid-unique temp (the snapshot lesson): two processes
    # exporting to the same path must not tear a shared .tmp
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __lm__=np.array(json.dumps(meta)),
                            **arrays)
    os.replace(tmp, path)
    return path


def load_lm(path: str):
    """-> ``(params, meta)`` from an :func:`export_lm` package.  The
    params come back as the numpy pytree ``KVDecoder`` (and
    ``make_logits_fn``) consume; raises ``ValueError`` on a package
    that is not an LM artifact (e.g. a ``forward`` package handed to
    the wrong CLI)."""
    with np.load(path, allow_pickle=False) as z:
        if "__lm__" not in z:
            raise ValueError(f"{path!r} is not an LM package (no __lm__ "
                             "meta; `serve` handles forward "
                             "packages)")
        meta = json.loads(str(z["__lm__"]))
        if meta.get("format") != LM_FORMAT:
            raise ValueError(f"unsupported LM package format "
                             f"{meta.get('format')!r} (want {LM_FORMAT})")
        blocks: list = [{} for _ in range(int(meta["n_layers"]))]
        for key in z.files:
            if key.startswith("blocks."):
                _, idx, leaf = key.split(".", 2)
                if not 0 <= int(idx) < len(blocks):
                    # ValueError, not IndexError: the CLI's cannot-load
                    # rc=2 path catches the former
                    raise ValueError(
                        f"{path!r} carries {key!r} but meta declares "
                        f"only {len(blocks)} layer(s)")
                blocks[int(idx)][leaf] = z[key]
        params = {"emb": z["emb"], "head": z["head"], "blocks": blocks}
    if any(not blk for blk in blocks):
        raise ValueError(f"{path!r} is missing block arrays for "
                         f"{sum(not b for b in blocks)} of "
                         f"{len(blocks)} layers")
    return params, meta


def load_lm_draft(path: str):
    """-> ``(draft_params, draft_meta)`` from a package exported with
    ``draft_params``, or ``(None, None)`` when the package carries no
    draft.  The draft pytree has the same shape contract as the target
    (``emb`` / ``head`` / ``blocks``) and boots a
    :class:`~znicz_tpu_torch.serve.paged.PagedKVDecoder` directly."""
    with np.load(path, allow_pickle=False) as z:
        if "__lm__" not in z:
            raise ValueError(f"{path!r} is not an LM package")
        meta = json.loads(str(z["__lm__"]))
        draft_meta = meta.get("draft")
        if not draft_meta:
            return None, None
        blocks: list = [{} for _ in range(int(draft_meta["n_layers"]))]
        for key in z.files:
            if key.startswith("draft.blocks."):
                _, _, idx, leaf = key.split(".", 3)
                if not 0 <= int(idx) < len(blocks):
                    raise ValueError(
                        f"{path!r} carries {key!r} but the draft meta "
                        f"declares only {len(blocks)} layer(s)")
                blocks[int(idx)][leaf] = z[key]
        params = {"emb": z["draft.emb"], "head": z["draft.head"],
                  "blocks": blocks}
    if any(not blk for blk in blocks):
        raise ValueError(f"{path!r} draft is missing block arrays")
    return params, draft_meta


class ExportedForward:
    """A loaded forward package: inference with no workflow machinery
    (the libZnicz-equivalent runtime), the reference's
    ``ExportedForward``.

    It rebuilds bare forward units from the package's layer specs
    (``MatchingObject.forwards``) and runs their ``torch_apply(p, x,
    rng=None, train=False)``, the reference's ``xla_apply``: FC and conv
    products are ``torch.matmul`` / ``F.conv2d`` (the reference's are XLA
    dots and ``lax.conv``), LRN runs ``kernels/lrn.py`` (the
    ``lrn_forward`` kernel on the card), dropout is the identity.  It
    computes in eval's type (``core/backends.py resolve_compute_dtype``:
    bf16 on the card by default, f32 on the CPU) and returns float32
    numpy rows.

    ``device`` is ``cuda`` unless the caller names another; a CUDA
    device on a host without one raises.  On the card a call runs one
    CUDA graph replay for its input shape: the first call of a shape
    runs the body eagerly, captures it (``parallel/graphs.py
    run_graphed``) and replays the capture, so ``captures`` counts the
    shapes materialized.  :meth:`eager` runs the same body with eager
    launches.  As a serve/engine.py backend it declares ``static_shapes
    = True``: the engine pads to its bucket shapes, so steady-state
    serving captures nothing.
    """

    #: a graph per input shape: the serving engine pads to fixed buckets
    static_shapes = True

    def __init__(self, path: str, device="cuda") -> None:
        import torch

        import znicz_tpu_torch.units  # noqa: F401  (the unit registry)
        from znicz_tpu_torch.core import backends
        from znicz_tpu_torch.units.nn_units import MatchingObject

        self.device = backends.device(device)
        with np.load(path, allow_pickle=False) as zf:
            meta = json.loads(str(zf["__arch__"]))
            if meta.get("format") != FORWARD_FORMAT:
                raise ValueError(f"{path!r} is not a forward package")
            self.meta = meta
            self.arrays = {k: zf[k] for k in zf.files
                           if k != "__arch__" and
                           not k.startswith(_AOT_PREFIX)}
            #: the reference's AOT executables in the package, ignored
            self.ignored_aot = sorted(k for k in zf.files
                                      if k.startswith(_AOT_PREFIX))
        self.name = meta["name"]
        self.input_shape = tuple(meta["input_shape"])
        self.compute_dtype = backends.resolve_compute_dtype(
            self.device.type)
        # bare forward units (no workflow) for their torch_apply
        self._units = [MatchingObject.forwards[spec["type"]](
            None, **spec["config"]) for spec in meta["arch"]]
        self._params = []
        for i in range(len(self._units)):
            leaf = {}
            for attr, key in (("weights", "w"), ("bias", "b")):
                if f"{i}.{attr}" in self.arrays:
                    leaf[key] = torch.as_tensor(
                        self.arrays[f"{i}.{attr}"]).to(
                            self.device, self.compute_dtype)
            self._params.append(leaf)
        #: input shape -> its CUDA graph (parallel/graphs.py), on the card
        self.graphs: dict = {}
        #: shapes captured into a graph so far
        self.captures = 0
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._lock = threading.Lock()

    def _body(self, x):
        """The forward over a device batch: eval's type inside, f32 out."""
        x = x.to(self.compute_dtype)
        for unit, p in zip(self._units, self._params):
            x = unit.torch_apply(p, x, rng=None, train=False)
        return x.float()

    def _input(self, x):
        import torch

        x = np.ascontiguousarray(x, np.float32)
        if x.shape[1:] != self.input_shape:
            raise ValueError(f"input shape {x.shape[1:]} != package "
                             f"input {self.input_shape}")
        return torch.from_numpy(x)

    def eager(self, x) -> np.ndarray:
        """The forward of ``x`` with eager launches (no graph)."""
        import torch

        with torch.no_grad():
            y = self._body(self._input(x).to(self.device))
            return y.cpu().numpy()

    def __call__(self, x) -> np.ndarray:
        import torch

        from znicz_tpu_torch.parallel.graphs import run_graphed

        if self.device.type != "cuda":
            return self.eager(x)
        x = self._input(x)
        key = tuple(x.shape)
        with self._lock, torch.no_grad():
            if key not in self.graphs:
                # the eager first run, then the capture and its replay
                run_graphed(self.graphs, key, "serving forward", self._body,
                            [x], self.device, self._stream)
                self.captures += 1
            y = run_graphed(self.graphs, key, "serving forward", self._body,
                            [x], self.device, self._stream)
            # a copy: the next replay overwrites the graph's output
            return y.cpu().numpy()


# -- forge: local model-zoo packaging (reference: veles/forge) --------------
# Thin wrappers over the registry (utils/forge.py ForgeRegistry: manifest,
# sha256 integrity, semantic version order), the reference's three.

def forge_publish(package_path: str, repo_dir: str, name: str,
                  version: str = "1.0", metrics: dict | None = None) -> str:
    """Publish a forward package (reference: veles forge upload)."""
    from znicz_tpu_torch.utils.forge import ForgeRegistry

    reg = ForgeRegistry(repo_dir)
    entry = reg.upload(package_path, name, version, metadata=metrics or {})
    return os.path.join(repo_dir, entry["file"])


def forge_fetch(repo_dir: str, name: str, version: str | None = None,
                device="cuda") -> ExportedForward:
    """Fetch and load a published model (reference: veles forge fetch),
    read in place from the registry after its checksum is verified; it
    serves on ``device``, the card unless the caller names another."""
    from znicz_tpu_torch.utils.forge import ForgeRegistry

    return ExportedForward(ForgeRegistry(repo_dir).fetch(name, version),
                           device=device)


def forge_list(repo_dir: str) -> dict:
    """name -> its versions in semantic order."""
    from znicz_tpu_torch.utils.forge import ForgeRegistry

    return ForgeRegistry(repo_dir).list_packages()
