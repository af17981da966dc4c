"""Transformer pieces the serving slice needs — the counterpart of
``znicz_tpu/parallel/transformer.py`` (layer norm, compute-dtype policy,
parameter init).

Parameters are a plain dict of tensors mirroring the reference's
pytree: ``emb (vocab, d)``, ``head (d, vocab)`` and ``blocks[i]`` with
``ln1_g ln1_b wq wk wv wo ln2_g ln2_b w1 b1 w2 b2``.
:func:`init_params` is pure numpy and draws in the reference's order, so
one seed gives identical weights in both packages;
:func:`params_from_numpy` carries such a numpy pytree (as ``load_lm``
returns it) onto a device.  The sharded training step comes with a later
slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core.backends import resolve_compute_dtype


def _layer_norm(x, g, b, eps: float = 1e-5):
    # stats in f32 regardless of the compute dtype (bf16 mean/var loses
    # ~3 decimal digits); the normalized result returns to x.dtype so the
    # surrounding matmuls stay in the compute dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = ((xf - mu) / torch.sqrt(var + eps)).to(x.dtype)
    return y * g + b


def _default_compute_dtype(compute_dtype=None, device=None):
    """Explicit dtype wins; None defers to the framework-wide precision
    policy (core.backends.resolve_compute_dtype) for ``device``'s type."""
    if compute_dtype is not None:
        return compute_dtype
    return resolve_compute_dtype(torch.device(device or "cuda").type)


def init_params(gen, n_layers: int, d: int, heads: int, ff: int,
                vocab: int):
    """Global parameter pytree (numpy f32) from ``gen`` (a numpy
    Generator) — draw for draw the reference's dense-FFN init."""
    def w(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[-2] if len(shape) > 1
                                       else shape[0])
        return gen.normal(0.0, scale, shape).astype(np.float32)

    blocks = []
    for _ in range(n_layers):
        blocks.append({
            "ln1_g": np.ones(d, np.float32), "ln1_b": np.zeros(d, np.float32),
            "wq": w((d, d)), "wk": w((d, d)), "wv": w((d, d)), "wo": w((d, d)),
            "ln2_g": np.ones(d, np.float32), "ln2_b": np.zeros(d, np.float32),
            "w1": w((d, ff)), "b1": np.zeros(ff, np.float32),
            "w2": w((ff, d)), "b2": np.zeros(d, np.float32),
        })
    return {"emb": w((vocab, d), 0.02), "head": w((d, vocab)),
            "blocks": blocks}


def params_from_numpy(params, device, dtype=torch.float32) -> dict:
    """Carry a parameter pytree of numpy (or CPU tensor) leaves onto
    ``device`` as ``dtype`` tensors, keeping the pytree's shape."""
    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(
            device=device, dtype=dtype)

    return {"emb": put(params["emb"]), "head": put(params["head"]),
            "blocks": [{k: put(a) for k, a in blk.items()}
                       for blk in params["blocks"]]}
