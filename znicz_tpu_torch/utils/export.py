"""LM package format — the generative half of
``znicz_tpu/utils/export.py``.

A package is one ``.npz``: flat float32 weight arrays plus an ``__lm__``
JSON meta block (``LM_FORMAT``).  The format is byte-compatible with the
reference, so packages cross between the two packages in both
directions; :func:`load_lm` returns the numpy pytree that
``parallel.transformer.params_from_numpy`` carries onto a device.  The
forward-package half (``export_forward``, AOT executables) comes with a
later slice of the port.
"""

from __future__ import annotations

import json
import os

import numpy as np

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
