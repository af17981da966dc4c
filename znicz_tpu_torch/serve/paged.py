"""Block-paged KV arena — the memory plane of generative serving; the
counterpart of ``znicz_tpu/serve/paged.py``.

ONE preallocated device buffer of fixed-size pages
``(layers, n_pages, page, heads, head_dim)`` in the compute dtype is
shared by every slot, plus a host-side per-slot page table.  A request
holds exactly the pages its resident tokens span, ``grow`` is a
page-table append instead of a device copy, and the slot ceiling is set
by tokens actually resident — not ``slots × max_bucket``.

Layout and invariants (the reference's):

- **page 0 is scratch** — page-table padding entries, writes from empty
  batch slots, and the tail of an adopt scatter all land there; its
  content is garbage by contract and no live view exposes it unmasked.
  The allocator hands out pages ``1..n_pages-1`` only.
- A slot's page table maps sequence rows ``[0, len(pages)·page)`` to
  arena pages; row ``r`` lives at ``(pages[r // page], r % page)``.
- Page tables are padded to power-of-two *page-view* widths
  (``view_bucket``), as in the reference.
- Pages freed by a finished request may be reissued at once: the new
  owner's rows are rewritten before exposure or masked by its own
  ``pos``.

Decode attention goes through
:func:`znicz_tpu_torch.kernels.decode.paged_decode`: on a CUDA arena it
ALWAYS launches the hand-written kernel (there is no switch, and an
arena the kernel cannot take is refused at construction, never served
by the plain path); on a CPU arena the wrapper runs its plain PyTorch
twin.  The speculative verify pass goes through the same kernel: its
``B·Q`` queries are one flattened batch, each with its slot's page-table
row and its own causal frontier as its length (the reference computes
that attention in jnp; a recorded divergence).  Prompt prefill and the
rest of the math are inherited from
:class:`~znicz_tpu_torch.serve.kvcache.KVDecoder`.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.kernels import decode as _kdecode
from znicz_tpu_torch.parallel.transformer import _layer_norm
from znicz_tpu_torch.serve.engine import bucket_sizes
from znicz_tpu_torch.serve.kvcache import KVDecoder, _ffn


class ArenaExhausted(RuntimeError):
    """No free pages left in the shared KV arena.  At admission this is
    backpressure (the batcher leaves the request queued); mid-generation
    it is the eviction policy — the growing request fails loudly with an
    error sentinel naming the arena."""


class PageLedger:
    """Host-side page accounting for one arena: free list, usage
    counters and the orphan sweep.  Page 0 (scratch) is never issued.

    Thread-safe, though in steady state only the continuous batcher's
    worker thread allocates and frees; ``submit`` threads read the
    counters for the never-servable check.
    """

    def __init__(self, n_pages: int) -> None:
        if n_pages < 2:
            raise ValueError(f"arena needs >= 2 pages (page 0 is the "
                             f"reserved scratch page), got {n_pages}")
        self.n_pages = int(n_pages)
        # pop() order hands out low page ids first — determinism for the
        # tests, irrelevant to correctness
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._lock = threading.Lock()
        self.peak_used = 0

    @property
    def total(self) -> int:
        """Allocatable pages (scratch excluded)."""
        return self.n_pages - 1

    @property
    def used(self) -> int:
        with self._lock:
            return self.total - len(self._free)

    @property
    def free(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc(self, n: int) -> list:
        """Take ``n`` pages or raise :class:`ArenaExhausted` (all-or-
        nothing — a partial grant would orphan pages on the error
        path)."""
        with self._lock:
            if n > len(self._free):
                raise ArenaExhausted(
                    f"KV arena exhausted: need {n} pages, "
                    f"{len(self._free)} of {self.total} free")
            pages = [self._free.pop() for _ in range(n)]
            self.peak_used = max(self.peak_used,
                                 self.total - len(self._free))
            return pages

    def release(self, pages) -> None:
        with self._lock:
            free = set(self._free)
            for p in pages:
                p = int(p)
                if p <= 0 or p >= self.n_pages or p in free:
                    raise ValueError(f"release of page {p} not owned by "
                                     f"this ledger (double free?)")
                free.add(p)
                self._free.append(p)

    def reclaim(self, owned) -> int:
        """Orphan sweep: free every used page NOT in ``owned`` — called
        after a crash path that may have lost a request between
        allocation and its page-table record.  Returns the number of
        pages reclaimed."""
        owned = {int(p) for p in owned}
        with self._lock:
            known = set(self._free) | owned
            orphans = [p for p in range(1, self.n_pages)
                       if p not in known]
            self._free.extend(orphans)
            return len(orphans)


class PagedKVDecoder(KVDecoder):
    """Bucketed incremental decoder over a shared block-paged KV arena.

    Extends :class:`KVDecoder` (prompt prefill, bucket policy and the
    single-request contiguous path are inherited) with the paged plane:

    - ``adopt_paged(kv1, pages)`` — scatter a prefilled contiguous
      single-request cache into arena pages (admission);
    - ``decode_paged(page_table, pos, token)`` — one batched
      single-token step: write each slot's row through its page table,
      attend over the slot's live rows with the paged-decode kernel;
    - ``verify_paged(page_table, pos, tokens)`` — the speculative
      target pass: write and attend ``q_len`` rows per slot in one
      batched pass, returning logits at every position (the acceptance
      rule reads these directly).

    ``page`` is the rows-per-page granularity; ``arena_pages`` sizes the
    shared buffer (default: worst case — every slot at ``max_len`` —
    plus the scratch page).  On a CUDA device the head dim and compute
    dtype must be ones the kernel is built for
    (:func:`~znicz_tpu_torch.kernels.decode.supported`), else the
    constructor raises.
    """

    paged = True

    def __init__(self, params, heads: int, max_len: int = 256,
                 batch: int = 1, page: int = 16,
                 arena_pages: int | None = None, device=None) -> None:
        super().__init__(params, heads=heads, max_len=max_len,
                         batch=batch, device=device)
        self.page = int(page)
        if self.page < 1:
            raise ValueError(f"page must be >= 1, got {page}")
        if self.device.type == "cuda" and \
                not _kdecode.supported(self.head_dim, self.dtype):
            # decide at CONSTRUCTION, never mid-request, and never by
            # quietly serving the plain path
            raise ValueError(
                f"no paged-decode kernel for head_dim={self.head_dim}, "
                f"dtype={self.dtype} (have head_dim "
                f"{_kdecode.HEAD_DIMS} in bfloat16/float32)")
        self.max_pages = -(-self.max_len // self.page)
        self.page_buckets = bucket_sizes(self.max_pages)
        if arena_pages is None:
            arena_pages = self.batch * self.max_pages + 1
        self.arena_pages = int(arena_pages)
        if self.arena_pages < 2:
            raise ValueError(f"arena_pages={arena_pages}: need >= 2 "
                             f"(page 0 is the reserved scratch page)")
        self.ledger = PageLedger(self.arena_pages)
        shape = (self.n_layers, self.arena_pages, self.page, self.heads,
                 self.head_dim)
        #: THE shared device arena — one buffer for every slot
        self._arena = {name: torch.zeros(shape, dtype=self.dtype,
                                         device=self.device)
                       for name in "kv"}

    # -- page geometry -------------------------------------------------------
    def pages_for(self, n_rows: int) -> int:
        """Pages needed to hold ``n_rows`` sequence rows (min 1)."""
        return max(1, -(-int(n_rows) // self.page))

    def view_bucket(self, n_pages: int) -> int:
        """Smallest page-view width covering ``n_pages``."""
        for b in self.page_buckets:
            if n_pages <= b:
                return b
        raise ValueError(f"{n_pages} pages > max_pages {self.max_pages} "
                         f"(max_len {self.max_len}, page {self.page})")

    def arena_bytes(self) -> int:
        """Device bytes held by the shared arena (both K and V)."""
        return sum(int(a.numel() * a.element_size())
                   for a in self._arena.values())

    # -- public paged API ----------------------------------------------------
    def adopt_paged(self, kv1, pages) -> None:
        """Scatter a prefilled single-request contiguous cache
        ``kv1 (L, 1, T_p, H, Dh)`` into the arena at ``pages`` — the
        admission splice.  ``pages`` may be SHORTER than the prefill
        bucket spans (a 130-token prompt in a 256 bucket owns 9 pages,
        not 16): the scatter's tail chunks — masked bucket padding — are
        routed to the scratch page."""
        t_p = int(kv1["k"].shape[2])
        n = self.pages_for(t_p)
        if len(pages) > n:
            raise ValueError(f"{len(pages)} pages for a {t_p}-row "
                             f"prefill ({n} chunks)")
        self._count("padopt", t_p)
        pg = np.zeros(n, np.int64)                   # tail -> scratch
        pg[:len(pages)] = np.asarray(pages, np.int64)
        pg = self._tensor(pg)
        pad = n * self.page - t_p
        for name in ("k", "v"):
            c1 = kv1[name][:, 0]                     # (L, t_p, H, Dh)
            if pad:
                c1 = F.pad(c1, (0, 0, 0, 0, 0, pad))
            self._arena[name][:, pg] = c1.reshape(
                self.n_layers, n, self.page, self.heads, self.head_dim)

    def _check_view(self, page_table, pos, rows_ahead: int):
        pt = np.asarray(page_table, np.int32)
        pos = np.asarray(pos, np.int32)
        if pt.ndim != 2 or pt.shape[0] != self.batch:
            raise ValueError(f"page_table must be ({self.batch}, "
                             f"view); got {pt.shape}")
        p_view = pt.shape[1]
        if p_view not in self.page_buckets:
            raise ValueError(f"page-table view {p_view} is not a "
                             f"page bucket {self.page_buckets}")
        if pos.min() < 0 or int(pos.max()) + rows_ahead > p_view * \
                self.page:
            # an out-of-view row would write a wrong page
            raise ValueError(
                f"rows [{int(pos.min())}, {int(pos.max()) + rows_ahead}"
                f") outside the {p_view * self.page}-row page view")
        if pt.min() < 0 or pt.max() >= self.arena_pages:
            raise ValueError(f"page ids must lie in [0, "
                             f"{self.arena_pages}); got "
                             f"[{pt.min()}, {pt.max()}]")
        return pt, pos, p_view

    def decode_paged(self, page_table, pos, token) -> np.ndarray:
        """One batched decode step through the page table; writes each
        slot's row into the shared arena in place and returns host
        logits ``(batch, vocab)`` — the verify pass of one row."""
        tokens = np.asarray(token, np.int32)[:, None]
        pt, pos, p_view = self._check_view(page_table, pos, 1)
        self._count("pdecode", p_view)
        return self._pass(pt, pos, tokens)[:, 0]

    def verify_paged(self, page_table, pos, tokens) -> np.ndarray:
        """The speculative target pass: process ``tokens (batch, Q)``
        (last accepted token + Q-1 draft proposals) in one batched pass,
        writing Q rows per slot, and return logits ``(batch, Q, vocab)``
        — position ``i``'s row predicts the token after ``tokens[:i]``,
        which is exactly what the greedy acceptance rule compares.

        Each layer writes all ``B·Q`` rows through the page table, then
        launches the paged-decode kernel once on the flattened queries:
        query ``(b, i)`` takes slot ``b``'s page-table row and length
        ``pos[b] + i + 1``, so it sees rows ``<= pos[b] + i`` and the
        draft rows after its own stay invisible."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2:
            raise ValueError(f"verify tokens must be (batch, q); got "
                             f"{tokens.shape}")
        q_len = tokens.shape[1]
        pt, pos, p_view = self._check_view(page_table, pos, q_len)
        self._count("pverify", (p_view, q_len))
        return self._pass(pt, pos, tokens)

    def _pass(self, pt, pos, tokens) -> np.ndarray:
        """The batched pass behind decode and verify over a checked page
        view: ``tokens (batch, Q)`` in, host logits ``(batch, Q,
        vocab)`` out."""
        q_len = tokens.shape[1]
        ps = self._params
        H, Dh, page = self.heads, self.head_dim, self.page
        B = pos.size
        n = B * q_len
        rows = pos[:, None] + np.arange(q_len, dtype=np.int32)[None, :]
        pg_w = self._tensor(np.take_along_axis(pt, rows // page, axis=1)
                            .ravel())
        off = self._tensor((rows % page).ravel())
        pt_q = self._tensor(np.repeat(pt, q_len, axis=0), torch.int32)
        lengths = self._tensor((rows + 1).ravel(), torch.int32)
        x = ps["emb"][self._tensor(tokens)]          # (B, Q, d)
        for li, p in enumerate(ps["blocks"]):
            h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
            q = (h @ p["wq"]).reshape(n, H, Dh)
            ka, va = self._arena["k"][li], self._arena["v"][li]
            # all Q rows are written before any query attends; each
            # query's length hides the rows after its own
            ka[pg_w, off] = (h @ p["wk"]).reshape(n, H, Dh)
            va[pg_w, off] = (h @ p["wv"]).reshape(n, H, Dh)
            o = _kdecode.paged_decode(q, ka, va, pt_q, lengths)
            o = o.to(va.dtype).reshape(B, q_len, -1)
            x = _ffn(x + o @ p["wo"], p)
        logits = (x @ ps["head"]).float().cpu().numpy()
        with self._lock:
            self.decode_steps += 1
            self.tokens_decoded += int(tokens.size)
        return logits

    def warmup(self, spec_k: int | None = None) -> int:
        """Exercise every prompt bucket's prefill and adopt scatter, the
        decode at every page-view width, and (when ``spec_k`` is given)
        the verify of ``spec_k + 1`` rows at every view that holds them,
        so the kernel library is built and loaded and the allocator
        pools are warm before live traffic; returns the number of shapes
        run.  All warmup writes land on the scratch page."""
        t0 = time.perf_counter()
        for b in self.buckets:
            kv1, _ = self.prefill([0], bucket=b)
            self.adopt_paged(kv1, [])                # all-scratch splice
        zeros = np.zeros(self.batch, np.int32)
        n = len(self.buckets)
        for pv in self.page_buckets:
            pt = np.zeros((self.batch, pv), np.int32)
            self.decode_paged(pt, zeros, zeros)
            n += 1
            # verify writes spec_k+1 rows, so live traffic only ever
            # dispatches it at views that hold them (the batcher's
            # _ensure_pages guarantees pages*page >= pos+k+1): a
            # narrower view would just fail the warmup
            if spec_k and pv * self.page >= spec_k + 1:
                self.verify_paged(pt, zeros,
                                  np.zeros((self.batch, spec_k + 1),
                                           np.int32))
                n += 1
        self.info(f"paged warmup: {len(self.buckets)} prefill buckets "
                  f"+ {len(self.page_buckets)} page views"
                  f"{' (with verify)' if spec_k else ''} in "
                  f"{time.perf_counter() - t0:.2f}s")
        return n

    def stats(self) -> dict:
        out = super().stats()
        out.update({
            "paged": True, "page": self.page,
            "arena_pages": self.arena_pages,
            "pages_total": self.ledger.total,
            "pages_used": self.ledger.used,
            "pages_peak": self.ledger.peak_used,
            "arena_bytes": self.arena_bytes(),
        })
        return out


def truncate_draft(params, n_layers: int):
    """Derive a layer-truncated draft from a target param pytree: same
    embedding, same head (same charmap vocab by construction), first
    ``n_layers`` blocks, as f32 numpy.  Early-exit drafting — the
    zero-extra-training way to get a cheaper proposer whose logits track
    the target's."""
    blocks = params["blocks"]
    n_layers = int(n_layers)
    if not 1 <= n_layers < len(blocks):
        raise ValueError(f"draft needs 1 <= n_layers < {len(blocks)}, "
                         f"got {n_layers}")
    return {"emb": np.asarray(params["emb"], np.float32),
            "head": np.asarray(params["head"], np.float32),
            "blocks": [{k: np.asarray(a, np.float32)
                        for k, a in blk.items()}
                       for blk in blocks[:n_layers]]}
