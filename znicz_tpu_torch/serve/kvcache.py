"""KV-cache incremental decode — the device core of the generative
serving plane; the counterpart of ``znicz_tpu/serve/kvcache.py``.

Autoregressive serving recomputes nothing: each request's attention
keys/values live in a preallocated device cache, ``prefill`` runs the
prompt once (filling the cache and yielding the first next-token
logits), and every subsequent token is one ``decode`` step that writes
a single cache row and attends over the rows written so far.  Caches
and prompts are padded to power-of-two *cache-length buckets*
(``engine.bucket_sizes``), exactly as in the reference, so the port
sees the reference's shapes and ``warmup`` can walk all of them once.

The decode math mirrors the reference op by op — the same
``_layer_norm``, the same ``masked_scores`` scale and -1e30 mask, f32
softmax accumulators with probabilities rounded to the value dtype
before the value product, tanh-approximated GELU (``jax.nn.gelu``'s
default), and the same compute-dtype policy (bf16 on CUDA, f32 on the
CPU).  Parameters are cast to the compute dtype once, at construction.
PyTorch runs eagerly, so where the reference rebinds functional
buffers the port writes cache rows in place.  Dense FFN blocks only.

Sampling stays on the host: :class:`TokenSampler` is seeded
temperature / top-k sampling over the returned logits with numpy's
``default_rng``, so a fixed ``(seed, temperature, top_k)`` triple
reproduces a generation exactly — the same draws as the reference.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.core.backends import device as _device
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.ops.attention import MASK_VALUE, masked_scores
from znicz_tpu_torch.parallel.transformer import (_default_compute_dtype,
                                                  _layer_norm,
                                                  params_from_numpy)
from znicz_tpu_torch.serve.engine import bucket_sizes


class TokenSampler:
    """Seeded, deterministic next-token sampling over host logits.

    ``temperature == 0`` (or ``top_k == 1``) is greedy argmax — ties
    break toward the lowest id, matching ``np.argmax``.  Otherwise logits
    are temperature-scaled, optionally truncated to the ``top_k``
    largest, and sampled from the renormalized softmax with this
    sampler's own ``numpy`` Generator — one sampler per request, so
    concurrent generations never share PRNG state.
    """

    def __init__(self, seed: int = 0, temperature: float = 1.0,
                 top_k: int = 0) -> None:
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        self.seed = int(seed)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.rng = np.random.default_rng(self.seed)

    def sample(self, logits: np.ndarray) -> int:
        z = np.asarray(logits, np.float64).ravel()
        if self.temperature == 0.0 or self.top_k == 1:
            return int(np.argmax(z))
        z = z / self.temperature
        if self.top_k and self.top_k < z.size:
            # keep the top_k largest; the cutoff uses partition so ties
            # at the boundary keep every value >= the k-th largest
            cut = np.partition(z, -self.top_k)[-self.top_k]
            z = np.where(z >= cut, z, -np.inf)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self.rng.choice(z.size, p=p))


def _ffn(x, p):
    m = _layer_norm(x, p["ln2_g"], p["ln2_b"])
    return x + (F.gelu(m @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"]
                + p["b2"])


class KVDecoder(Logger):
    """Bucketed incremental decoder over a transformer parameter pytree.

    ``params``: the ``parallel/transformer.py`` pytree (``emb``,
    ``head``, ``blocks``) as numpy arrays (``load_lm``'s output); placed
    on ``device`` (default ``cuda``) once, in the compute dtype.
    ``heads`` cannot be derived from the arrays and must be given;
    everything else (layers, d, ff, vocab) is read off the shapes.
    ``max_len`` bounds prompt+generation length and defines the bucket
    set; ``batch`` is the fixed slot width of the batched ``decode``
    (1 for single-request use, >1 for the continuous batcher).

    - ``prefill(tokens) -> (kv1, logits (V,))`` — full prompt pass at a
      bucket, cache ``(L, 1, bucket, H, Dh)`` for every row;
    - ``decode(kv, pos (B,), token (B,)) -> (kv, logits (B, V))`` —
      write row ``pos`` per slot in place, attend over rows ``<= pos``;
    - ``adopt(kv, kv1, slot)`` — splice a prefilled single-request cache
      into a batch slot (continuous admission); ``grow`` pads a batch
      cache out to a larger bucket.
    """

    def __init__(self, params, heads: int, max_len: int = 256,
                 batch: int = 1, device=None) -> None:
        super().__init__()
        if any("ew1" in blk for blk in params["blocks"]):
            raise NotImplementedError(
                "KV-cache decode supports dense FFN blocks only; MoE "
                "decode (expert routing at batch-of-one) is not wired")
        self.device = _device(device)
        self.n_layers = len(params["blocks"])
        self.vocab, self.d = (int(s) for s in np.shape(params["emb"]))
        self.ff = int(np.shape(params["blocks"][0]["w1"])[1])
        self.heads = int(heads)
        if self.d % self.heads:
            raise ValueError(f"heads={heads} must divide d={self.d}")
        self.head_dim = self.d // self.heads
        self.max_len = int(max_len)
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.buckets = bucket_sizes(self.max_len)
        self.dtype = self._cast_policy()
        self._params = params_from_numpy(params, self.device, self.dtype)
        self.prefill_count = 0
        self.decode_steps = 0        # batched decode dispatches
        self.tokens_decoded = 0      # slot-tokens produced by decode
        self._lock = threading.Lock()

    # -- shape policy --------------------------------------------------------
    def bucket_for(self, total_len: int) -> int:
        """Smallest cache bucket covering ``total_len`` tokens."""
        if total_len < 1:
            raise ValueError("empty sequence")
        if total_len > self.max_len:
            # admission-time rejection (400, never a burned slot): the
            # message names the configured limit so a client knows what
            # to shrink — prompt + max_tokens must fit --max-len
            raise ValueError(
                f"sequence of {total_len} tokens (prompt + max_tokens) "
                f"exceeds this server's max_len {self.max_len} "
                f"(--max-len)")
        for b in self.buckets:
            if total_len <= b:
                return b
        return self.max_len

    # -- math ----------------------------------------------------------------
    def _cast_policy(self):
        return _default_compute_dtype(None, self.device)

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    @staticmethod
    def _attend(s, v_cache):
        """Softmax attention from f32 scores ``s (B,H,Q,T)`` and cached
        values ``(B,T,H,Dh)``: f32 max/exp/sum, probabilities rounded to
        the value dtype, value product accumulated in f32, the result
        back in the value dtype — the reference's recipe."""
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bhqd", p.to(v_cache.dtype).float(),
                         v_cache.float())
        o = (o / l).to(v_cache.dtype)
        return o.transpose(1, 2)                     # (B, Q, H, Dh)

    def _prefill(self, tokens, length: int):
        ps = self._params
        H, Dh = self.heads, self.head_dim
        x = ps["emb"][tokens]                        # (1, T, d)
        b, t = x.shape[:2]
        pad = torch.arange(t, device=self.device) >= length
        ks, vs = [], []
        for p in ps["blocks"]:
            h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
            q = (h @ p["wq"]).reshape(b, t, H, Dh)
            k = (h @ p["wk"]).reshape(b, t, H, Dh)
            v = (h @ p["wv"]).reshape(b, t, H, Dh)
            ks.append(k)
            vs.append(v)
            s = masked_scores(q, k, True)            # causal, f32
            s = s.masked_fill(pad[None, None, None, :], MASK_VALUE)
            o = self._attend(s, v).reshape(b, t, -1)
            x = _ffn(x + o @ p["wo"], p)
        logits = (x[0, length - 1] @ ps["head"]).float()
        return {"k": torch.stack(ks), "v": torch.stack(vs)}, logits

    # -- public API ----------------------------------------------------------
    def prefill(self, tokens, bucket: int | None = None):
        """Run the prompt through the full pass: ``tokens`` (1-D int
        sequence) -> ``(kv1, logits)`` — a single-request cache
        ``(L, 1, bucket, H, Dh)`` plus the next-token logits as a host
        f32 vector.  With ``batch == 1`` the returned cache feeds
        :meth:`decode` directly; the continuous batcher splices it into
        a slot via :meth:`adopt`."""
        ids = np.asarray(tokens, np.int32).ravel()
        if ids.size < 1:
            raise ValueError("empty prompt")
        if ids.min() < 0 or ids.max() >= self.vocab:
            raise ValueError(f"token ids must be in [0, {self.vocab}); "
                             f"got range [{ids.min()}, {ids.max()}]")
        bucket = self.bucket_for(ids.size) if bucket is None else bucket
        if ids.size > bucket:
            raise ValueError(f"prompt of {ids.size} tokens > bucket "
                             f"{bucket}")
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :ids.size] = ids
        kv1, logits = self._prefill(self._tensor(padded), int(ids.size))
        with self._lock:
            self.prefill_count += 1
        return kv1, logits.cpu().numpy()

    def alloc(self, bucket: int):
        """Zeroed batch cache for ``bucket`` — ``{"k"/"v"}`` of shape
        ``(layers, batch, bucket, heads, head_dim)`` on the device."""
        shape = (self.n_layers, self.batch, bucket, self.heads,
                 self.head_dim)
        return {name: torch.zeros(shape, dtype=self.dtype,
                                  device=self.device) for name in "kv"}

    def grow(self, kv, new_bucket: int):
        """Pad a cache out to a larger bucket (zeros past the old length
        — every live row index is below it, and per-slot ``pos`` masks
        keep the padding invisible)."""
        old = kv["k"].shape[2]
        if new_bucket < old:
            raise ValueError(f"grow to {new_bucket} < current {old}")
        if new_bucket == old:
            return kv
        return {name: F.pad(c, (0, 0, 0, 0, 0, new_bucket - old))
                for name, c in kv.items()}

    def decode(self, kv, pos, token):
        """One batched decode step: ``pos``/``token`` arrays of width
        ``batch`` -> ``(kv, logits (batch, vocab))`` with logits on the
        host.  Rows are written into ``kv`` in place.  Slots whose row is
        not meant to advance simply get their next cache row overwritten
        again later — the caller (continuous batcher) owns slot
        liveness."""
        bucket = int(kv["k"].shape[2])
        pos = np.asarray(pos, np.int32)
        if pos.max() >= bucket or pos.min() < 0:
            # an out-of-range row would write past the cache (or wrap a
            # negative position onto a live row) — the batcher grows
            # the bucket before this
            raise ValueError(f"decode positions [{int(pos.min())}, "
                             f"{int(pos.max())}] outside cache bucket "
                             f"{bucket}; grow() first")
        ps = self._params
        H, Dh = self.heads, self.head_dim
        pos_t = self._tensor(pos)
        B = pos.size
        slots = torch.arange(B, device=self.device)
        x = ps["emb"][self._tensor(token)][:, None, :]  # (B, 1, d)
        dead = torch.arange(bucket, device=self.device)[None, :] > \
            pos_t[:, None]                           # (B, T)
        for li, p in enumerate(ps["blocks"]):
            h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
            q = (h @ p["wq"]).reshape(B, 1, H, Dh)
            kv["k"][li, slots, pos_t] = (h @ p["wk"]).reshape(B, H, Dh)
            kv["v"][li, slots, pos_t] = (h @ p["wv"]).reshape(B, H, Dh)
            kc, vc = kv["k"][li], kv["v"][li]
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float())
            s = s / float(np.sqrt(Dh))
            # keys past this slot's current position are unwritten (or
            # stale rows of a previous occupant): the -1e30 mask
            s = s.masked_fill(dead[:, None, None, :], MASK_VALUE)
            o = self._attend(s, vc).reshape(B, 1, -1)
            x = _ffn(x + o @ p["wo"], p)
        logits = (x[:, 0] @ ps["head"]).float()
        with self._lock:
            self.decode_steps += 1
            self.tokens_decoded += int(pos.size)
        return kv, logits.cpu().numpy()

    def adopt(self, kv, kv1, slot: int):
        """Splice a prefilled single-request cache into batch ``slot``
        (in place; returns ``kv``)."""
        bucket = int(kv["k"].shape[2])
        if int(kv1["k"].shape[2]) != bucket:
            kv1 = self.grow(kv1, bucket)
        for name in ("k", "v"):
            kv[name][:, slot] = kv1[name][:, 0]
        return kv

    def warmup(self) -> int:
        """Exercise every bucket's prefill and decode once (and adopt
        when batched), so allocator pools and library handles are warm
        before live traffic; returns the number of shapes run."""
        t0 = time.perf_counter()
        for b in self.buckets:
            kv1, _ = self.prefill([0], bucket=b)
            kv = kv1 if self.batch == 1 else \
                self.adopt(self.alloc(b), kv1, 0)
            self.decode(kv, np.zeros(self.batch, np.int32),
                        np.zeros(self.batch, np.int32))
        self.info(f"warmup: {len(self.buckets)} cache buckets in "
                  f"{time.perf_counter() - t0:.2f}s")
        return len(self.buckets)

    # -- single-request convenience -----------------------------------------
    def generate(self, prompt, max_new_tokens: int,
                 sampler: TokenSampler | None = None,
                 on_token=None) -> list:
        """Prefill + decode loop for a lone request (``batch == 1``):
        returns the generated ids; ``on_token(id)`` streams them as
        produced.  The CLI one-shot mode runs through exactly this
        path."""
        if self.batch != 1:
            raise ValueError("generate() needs a batch=1 decoder; the "
                             "continuous batcher owns batched decode")
        # default is GREEDY (temperature 0), matching the CLI default —
        # an unconfigured generate() must be reproducible
        sampler = sampler if sampler is not None else \
            TokenSampler(temperature=0.0)
        ids = np.asarray(prompt, np.int32).ravel()
        bucket = self.bucket_for(ids.size + max_new_tokens)
        kv, logits = self.prefill(ids, bucket=bucket)
        out = []
        pos = ids.size
        for _ in range(max_new_tokens):
            tok = sampler.sample(logits)
            out.append(tok)
            if on_token is not None:
                on_token(tok)
            if len(out) == max_new_tokens:
                break
            kv, batch_logits = self.decode(
                kv, np.asarray([pos], np.int32),
                np.asarray([tok], np.int32))
            logits = batch_logits[0]
            pos += 1
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "n_layers": self.n_layers, "d": self.d,
                "heads": self.heads, "ff": self.ff, "vocab": self.vocab,
                "max_len": self.max_len, "batch": self.batch,
                "buckets": list(self.buckets),
                "device": str(self.device), "dtype": str(self.dtype),
                "prefill_count": self.prefill_count,
                "decode_steps": self.decode_steps,
                "tokens_decoded": self.tokens_decoded,
            }
