"""Continuous batching for generative decode — the admission half of
the generative serving plane; the counterpart of
``znicz_tpu/serve/continuous.py``.

The continuous batcher keeps ONE decode batch running over a
fixed-width *slot map*: every decode step advances all occupied slots by
one token, finished requests free their slot mid-flight, and newly
admitted requests prefill and join the very next step — no drain, no
stragglers.

Contract: **every admitted request gets exactly one terminal event** —
``done`` after its tokens, or an error sentinel — never silence, never a
duplicate:

- **backpressure**: a full wait queue rejects at ``submit`` with
  :class:`~znicz_tpu_torch.serve.batcher.QueueFull` (HTTP 503);
- **deadlines**: a request whose deadline lapses (queued OR
  mid-generation) gets a terminal error sentinel naming the deadline;
- **abort**: ``TokenStream.cancel()`` frees the slot at the next step
  and counts the request abandoned;
- **chaos**: a crash inside the decode loop (fault site
  ``generate.step``, or a real engine failure) fails every ACTIVE
  stream with the error sentinel and keeps the worker serving — queued
  requests still get their turn;
- **graceful drain**: ``stop(drain=True)`` rejects new arrivals but
  decodes everything admitted to completion.

With a :class:`~znicz_tpu_torch.serve.paged.PagedKVDecoder` the batcher
admits against the PAGE budget (a queued request waits for free arena
pages, not a worst-case bucket), ``grow`` is a page-table append,
eviction on arena exhaustion fails the growing request loudly, and a
crash-path sweep keeps the page ledger exact (``pages_used == Σ live
slot pages``).  With a ``draft`` decoder each step becomes a speculative
round — the draft proposes ``spec_k`` tokens, the target verifies all
of them in one batched pass, and greedy streams stay token-identical to
plain decode by construction (every emitted token is the target's own
greedy choice).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.observe import flight as _flight
from znicz_tpu_torch.observe import probe as _probe
from znicz_tpu_torch.observe import trace as _trace
from znicz_tpu_torch.observe.federation import (next_request_id,
                                                request_track)
from znicz_tpu_torch.resilience.faults import fault_hook
from znicz_tpu_torch.serve.batcher import QueueFull
from znicz_tpu_torch.serve.kvcache import KVDecoder, TokenSampler
from znicz_tpu_torch.serve.metrics import GenerateMetrics
from znicz_tpu_torch.serve.paged import ArenaExhausted


class GenerationError(RuntimeError):
    """Terminal error sentinel carried by a :class:`TokenStream`."""


class TokenStream:
    """Client handle for one generation: a bounded-unbounded event
    queue the batcher worker feeds.  Events are plain dicts —
    ``{"token": id}`` per token, then exactly one terminal event:
    ``{"done": True, "reason": ...}`` or ``{"error": msg, "done":
    True}`` — the same shapes ``POST /generate`` streams as ndjson.
    """

    def __init__(self, prompt_len: int, max_new_tokens: int,
                 request_id: str | None = None) -> None:
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        #: distributed-tracing correlation key: minted at
        #: HTTP admission (or here for direct submits) and carried by
        #: every phase span this request emits
        self.request_id = request_id or next_request_id()
        self.tokens: list = []
        self.t_submit = time.monotonic()
        self.ttft_s: float | None = None
        #: batcher step counter when the first/last token landed — the
        #: continuous-join pin reads these (a late joiner must finish at
        #: a LOWER step count than a long early request)
        self.first_token_step: int | None = None
        self.finish_step: int | None = None
        self._events: queue.Queue = queue.Queue()
        self._terminal: dict | None = None
        self._cancelled = threading.Event()

    # -- batcher side --------------------------------------------------------
    def _push_token(self, token: int) -> None:
        self.tokens.append(token)
        self._events.put({"token": int(token)})

    def _push_terminal(self, event: dict) -> None:
        self._terminal = event
        self._events.put(event)

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    # -- client side ---------------------------------------------------------
    def cancel(self) -> None:
        """Ask the batcher to free this request's slot at the next
        step; the stream still receives its terminal event (``reason:
        "aborted"``)."""
        self._cancelled.set()

    def next_event(self, timeout: float | None = None) -> dict:
        """Blocking pop of the next event; raises ``TimeoutError`` when
        ``timeout`` lapses with nothing produced."""
        try:
            return self._events.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no stream event within {timeout}s") from None

    def __iter__(self):
        """Yield token ids until the terminal event; a terminal error
        sentinel raises :class:`GenerationError`."""
        while True:
            event = self._events.get()
            if "error" in event:
                raise GenerationError(event["error"])
            if event.get("done"):
                return
            yield event["token"]

    def result(self, timeout_s: float | None = None) -> list:
        """Collect the full generation; raises on the error sentinel."""
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        while self._terminal is None or not self._events.empty():
            remaining = None if deadline is None else \
                max(0.001, deadline - time.monotonic())
            event = self.next_event(timeout=remaining)
            if "error" in event:
                raise GenerationError(event["error"])
            if event.get("done"):
                return list(self.tokens)
        if "error" in (self._terminal or {}):
            raise GenerationError(self._terminal["error"])
        return list(self.tokens)


class _GenRequest:
    __slots__ = ("stream", "prompt", "max_new", "sampler", "deadline",
                 "pos", "next_token", "emitted", "finished", "track",
                 "t0_perf", "first_perf", "pages", "draft_pages")

    def __init__(self, stream: TokenStream, prompt: np.ndarray,
                 max_new: int, sampler: TokenSampler,
                 deadline: float | None) -> None:
        self.stream = stream
        self.prompt = prompt
        self.max_new = max_new
        self.sampler = sampler
        self.deadline = deadline            # monotonic stamp or None
        self.pos = 0                        # next cache row to write
        self.next_token = 0                 # token to feed next step
        self.emitted = 0
        self.finished = False
        #: arena pages this request holds (paged decoder only) — the
        #: page table maps row r to (pages[r // page], r % page)
        self.pages: list = []
        self.draft_pages: list = []
        #: trace anchors: every phase span of this request
        #: lands on one synthetic per-request track
        self.track = request_track(stream.request_id)
        self.t0_perf = time.perf_counter()      # admission (queue start)
        self.first_perf: float | None = None    # first token sampled

    @property
    def greedy(self) -> bool:
        """Greedy requests ride the speculative acceptance rule; sampled
        ones take one token per round from the verify logits' position 0
        (their exact decode distribution — speculation never distorts
        sampling)."""
        return self.sampler.temperature == 0.0 or self.sampler.top_k == 1

    @property
    def total_budget(self) -> int:
        return len(self.prompt) + self.max_new


class ContinuousBatcher(Logger):
    """Run a :class:`KVDecoder`'s batched decode loop with per-step
    slot admission and retirement.

    ``decoder.batch`` is the slot width; ``max_queue`` bounds requests
    waiting for a slot (admission beyond it fails fast with
    :class:`QueueFull`); ``default_timeout_s`` is the per-request
    deadline when ``submit`` gets none.  With a contiguous
    :class:`KVDecoder` the shared KV cache starts at the smallest
    bucket covering the first admissions and grows (never shrinks) to
    the bucket ceiling of what is admitted; with a
    :class:`~znicz_tpu_torch.serve.paged.PagedKVDecoder` requests hold
    arena pages instead and admission/growth/eviction ride the page
    ledger.

    ``draft`` (paged only) switches every step to a speculative
    draft+verify round proposing ``spec_k`` tokens — greedy streams
    stay token-identical to plain decode; sampled ones keep their
    exact seeded distribution.
    """

    def __init__(self, decoder: KVDecoder, max_queue: int = 64,
                 default_timeout_s: float = 60.0,
                 metrics: GenerateMetrics | None = None,
                 draft: KVDecoder | None = None,
                 spec_k: int = 4) -> None:
        super().__init__()
        self.decoder = decoder
        #: paged decoders swap the shared bucket cache for the
        #: block-paged arena: admission and growth ride the page ledger
        self._paged = bool(getattr(decoder, "paged", False))
        self._draft = draft
        self._spec_k = int(spec_k)
        if self._spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if draft is not None:
            if not self._paged or not getattr(draft, "paged", False):
                raise ValueError(
                    "speculative decoding needs PagedKVDecoder for both "
                    "target and draft (the contiguous path has no "
                    "multi-row verify)")
            if draft.batch != decoder.batch:
                raise ValueError(f"draft batch {draft.batch} != target "
                                 f"batch {decoder.batch}")
            if draft.vocab != decoder.vocab:
                raise ValueError(f"draft vocab {draft.vocab} != target "
                                 f"vocab {decoder.vocab} — the draft "
                                 "must speak the same charmap")
            if draft.max_len < decoder.max_len:
                raise ValueError(f"draft max_len {draft.max_len} < "
                                 f"target max_len {decoder.max_len}")
        self.slots: list = [None] * decoder.batch
        self.max_queue = int(max_queue)
        self.default_timeout_s = default_timeout_s
        self.metrics = metrics if metrics is not None else \
            GenerateMetrics()
        if self._paged:
            self.metrics.on_pages(decoder.ledger.used,
                                  decoder.ledger.total)
        if draft is not None:
            # touch both counter series so fleet delta rules see the 0
            # baseline, not a missing key
            self.metrics.on_spec(0, 0)
        self.step_count = 0
        self._kv = None
        self._bucket = 0
        self._pending: list = []
        self._cond = threading.Condition()
        self._closing = False
        self._drain = True
        # the flight plane embeds the live admission ledger (admitted/
        # completed/failed/abandoned), so a post-mortem checks ledger
        # equality without a live scrape.  One provider object so stop()
        # can unregister exactly what it registered (newest batcher wins
        # the name).
        self._flight_plane = self.metrics.snapshot
        _flight.register_plane("generate_ledger", self._flight_plane)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-batcher")
        self._worker.start()

    @property
    def draining(self) -> bool:
        return self._closing

    # -- client side ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               timeout_s: float | None = None,
               request_id: str | None = None) -> TokenStream:
        """Admit one generation; returns its :class:`TokenStream`.
        Raises :class:`QueueFull` under backpressure or during drain,
        ``ValueError`` on never-servable input (bad ids, budget beyond
        the decoder's ``max_len``).  ``request_id`` threads an
        HTTP-admission trace id through; direct callers get one
        minted."""
        ids = np.asarray(prompt, np.int32).ravel()
        if ids.size < 1:
            raise ValueError("empty prompt")
        if ids.min() < 0 or ids.max() >= self.decoder.vocab:
            raise ValueError(
                f"token ids must be in [0, {self.decoder.vocab}); got "
                f"range [{ids.min()}, {ids.max()}]")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        # never admissible — bad input, not backpressure (400, not 503):
        # the check runs HERE, before any slot or prefill is burned, and
        # the error names the configured limit
        self.decoder.bucket_for(ids.size + max_new_tokens)
        if self._paged:
            need = self.decoder.pages_for(ids.size + max_new_tokens)
            if need > self.decoder.ledger.total:
                raise ValueError(
                    f"request budget of {ids.size + max_new_tokens} "
                    f"tokens needs {need} arena pages but the arena "
                    f"holds only {self.decoder.ledger.total} "
                    f"(page size {self.decoder.page}; raise "
                    f"--arena-pages)")
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got "
                             f"{timeout_s}")
        sampler = TokenSampler(seed=seed, temperature=temperature,
                               top_k=top_k)
        stream = TokenStream(ids.size, max_new_tokens,
                             request_id=request_id)
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        req = _GenRequest(stream, ids, max_new_tokens, sampler, deadline)
        with self._cond:
            if self._closing:
                self.metrics.on_reject()
                raise QueueFull("generate batcher is draining")
            if len(self._pending) >= self.max_queue:
                self.metrics.on_reject()
                raise QueueFull(f"generate queue full "
                                f"({len(self._pending)}/{self.max_queue})")
            self._pending.append(req)
            self.metrics.on_admit()
            self._cond.notify_all()
        return stream

    # -- worker side ---------------------------------------------------------
    def _finish(self, req: _GenRequest, event: dict) -> None:
        """THE single terminal-event path — exactly once per admitted
        request, whatever the cause."""
        if req.finished:
            return
        req.finished = True
        req.stream.finish_step = self.step_count
        if req.first_perf is not None:
            # the decode phase span: first sampled token -> terminal
            # event, on the request's own trace track (per-step timing
            # lives in the batched generate.decode_step spans; this one
            # makes a single request's tail attributable end to end)
            t1 = time.perf_counter()
            _trace.TRACER.complete(
                "generate.decode", req.first_perf, t1 - req.first_perf,
                tid=req.track, rid=req.stream.request_id,
                n_tokens=req.emitted)
        req.stream._push_terminal(event)
        self._release_pages(req)
        if "error" in event:
            self.metrics.on_failed()
        elif event.get("reason") == "aborted":
            self.metrics.on_abandoned()
        else:
            self.metrics.on_complete()

    def _release_pages(self, req: _GenRequest) -> None:
        """Return a finished request's arena pages — called from the ONE
        terminal path, so every exit (done/deadline/cancel/crash) frees
        exactly what admission and growth allocated."""
        if req.pages:
            self.decoder.ledger.release(req.pages)
            req.pages = []
        if req.draft_pages:
            self._draft.ledger.release(req.draft_pages)
            req.draft_pages = []
        if self._paged:
            self.metrics.on_pages(self.decoder.ledger.used,
                                  self.decoder.ledger.total)

    def _emit_token(self, req: _GenRequest, token: int) -> None:
        if req.emitted == 0:
            req.stream.ttft_s = time.monotonic() - req.stream.t_submit
            req.stream.first_token_step = self.step_count
            req.first_perf = time.perf_counter()
            self.metrics.on_first_token(req.stream.ttft_s)
        req.stream._push_token(token)
        req.emitted += 1
        self.metrics.on_tokens(1)

    def _retire_if_done(self, req: _GenRequest, slot: int,
                        now: float) -> bool:
        """Post-emit terminal checks; True when the slot was freed."""
        if req.emitted >= req.max_new:
            self._finish(req, {"done": True, "reason": "length",
                               "n_tokens": req.emitted})
        elif req.stream.cancelled:
            self._finish(req, {"done": True, "reason": "aborted",
                               "n_tokens": req.emitted})
        elif req.deadline is not None and now > req.deadline:
            self._finish(req, {
                "error": f"deadline exceeded after {req.emitted} tokens "
                         f"({now - req.stream.t_submit:.3f}s)",
                "done": True})
        if req.finished:
            self.slots[slot] = None
            return True
        return False

    def _can_admit(self, req: _GenRequest) -> bool:
        """Paged admission gate: the request's PROMPT pages must be free
        in the arena (and the draft's, under speculation) — the rest of
        its budget grows page by page as it decodes.  A gated request
        stays queued; running slots free pages as they finish."""
        need = self.decoder.pages_for(len(req.prompt))
        if self.decoder.ledger.free < need:
            return False
        if self._draft is not None and \
                self._draft.ledger.free < self._draft.pages_for(
                    len(req.prompt)):
            return False
        return True

    def _admit(self) -> None:
        """Move pending requests into free slots: prefill the prompt,
        splice the cache in, emit the first token (TTFT stops here).
        Contiguous decoders grow the one shared bucket cache before the
        splice; paged decoders allocate prompt pages from the arena and
        scatter the prefill through the page table."""
        while True:
            with self._cond:
                free = [i for i, s in enumerate(self.slots) if s is None]
                if not free or not self._pending:
                    return
                if self._paged and not self._can_admit(self._pending[0]):
                    if any(s is not None for s in self.slots):
                        return          # pages free up as slots finish
                    # nothing is running yet the arena says full: only a
                    # leak can cause this — sweep, then fail loudly if
                    # the request still does not fit
                    self._sweep_orphan_pages()
                    if not self._can_admit(self._pending[0]):
                        req = self._pending.pop(0)
                        self._finish(req, {
                            "error": "KV arena exhausted with no live "
                                     "generations (page leak?)",
                            "done": True})
                        continue
                req = self._pending.pop(0)
            now = time.monotonic()
            # queue-wait phase span: admission -> leaving the wait queue
            # (expired/cancelled requests keep theirs — the span IS the
            # evidence the queue killed them)
            t_dequeue = time.perf_counter()
            _trace.TRACER.complete(
                "generate.queue", req.t0_perf, t_dequeue - req.t0_perf,
                tid=req.track, rid=req.stream.request_id)
            if req.stream.cancelled:
                self._finish(req, {"done": True, "reason": "aborted",
                                   "n_tokens": 0})
                continue
            if req.deadline is not None and now > req.deadline:
                self._finish(req, {
                    "error": f"deadline exceeded after "
                             f"{now - req.stream.t_submit:.3f}s in queue",
                    "done": True})
                continue
            slot = free[0]
            t_prefill = time.perf_counter()
            try:
                logits = self._attach_paged(req, slot) if self._paged \
                    else self._attach_contiguous(req, slot)
            except Exception as exc:  # noqa: BLE001 — this request only
                self.error(f"prefill failed: {exc!r}")
                # _finish releases any pages already allocated, so a
                # failure between alloc and the page-table record cannot
                # orphan arena pages
                self._finish(req, {"error": f"prefill failed: {exc!r}",
                                   "done": True})
                continue
            _trace.TRACER.complete(
                "generate.prefill", t_prefill,
                time.perf_counter() - t_prefill, tid=req.track,
                rid=req.stream.request_id, prompt_len=len(req.prompt),
                slot=slot)
            # anatomy plane: prompt attach / KV prefill as a phase of
            # the serving plane's step taxonomy
            _probe.anatomy_phase("serve", "prefill",
                                 time.perf_counter() - t_prefill,
                                 t0=t_prefill)
            req.pos = len(req.prompt)
            self.slots[slot] = req
            token = req.sampler.sample(logits)
            req.next_token = token
            self._emit_token(req, token)
            self._retire_if_done(req, slot, time.monotonic())
        # (unreachable)

    def _attach_contiguous(self, req: _GenRequest, slot: int):
        """Contiguous admission: grow the one shared bucket cache to the
        budget ceiling of everything live, prefill at the REQUEST's own
        bucket (a short prompt must not pay a long request's
        O(bucket^2) attention pass), splice via adopt."""
        need = self.decoder.bucket_for(max(
            [req.total_budget] +
            [r.total_budget for r in self.slots if r is not None]))
        if self._kv is None:
            self._kv = self.decoder.alloc(need)
            self._bucket = need
        elif need > self._bucket:
            self._kv = self.decoder.grow(self._kv, need)
            self._bucket = need
        kv1, logits = self.decoder.prefill(
            req.prompt, bucket=self.decoder.bucket_for(req.total_budget))
        self._kv = self.decoder.adopt(self._kv, kv1, slot)
        return logits

    def _attach_paged(self, req: _GenRequest, slot: int):
        """Paged admission: allocate the PROMPT's pages only (the rest
        of the budget appends page by page as the generation grows),
        prefill at the prompt's own bucket, scatter into the arena.
        Pages are recorded on the request the moment they are allocated,
        so the error path (``_finish`` -> ``_release_pages``) can never
        orphan them."""
        dec = self.decoder
        req.pages = dec.ledger.alloc(dec.pages_for(len(req.prompt)))
        kv1, logits = dec.prefill(
            req.prompt, bucket=dec.bucket_for(len(req.prompt)))
        dec.adopt_paged(kv1, req.pages)
        if self._draft is not None:
            d = self._draft
            req.draft_pages = d.ledger.alloc(d.pages_for(len(req.prompt)))
            kv1d, _ = d.prefill(req.prompt,
                                bucket=d.bucket_for(len(req.prompt)))
            d.adopt_paged(kv1d, req.draft_pages)
        self.metrics.on_pages(dec.ledger.used, dec.ledger.total)
        return logits

    # -- paged stepping -------------------------------------------------------
    def _ensure_pages(self, req: _GenRequest, slot: int,
                      rows: int) -> bool:
        """grow() as a page-table append: extend the request's page
        tables until they cover ``rows`` sequence rows.  Exhaustion is
        the eviction policy — the GROWING request fails loudly with an
        error sentinel naming the arena (its pages free immediately;
        everything else keeps decoding)."""
        pairs = [(self.decoder, req.pages)]
        if self._draft is not None:
            pairs.append((self._draft, req.draft_pages))
        for dec, pages in pairs:
            while len(pages) * dec.page < rows:
                try:
                    pages.extend(dec.ledger.alloc(1))
                except ArenaExhausted as exc:
                    self.warning(f"evicting {req.stream.request_id}: "
                                 f"{exc}")
                    self._finish(req, {
                        "error": f"KV arena exhausted after "
                                 f"{req.emitted} tokens: {exc}",
                        "done": True})
                    self.slots[slot] = None
                    return False
        return True

    def _page_table(self, dec, attr: str) -> np.ndarray:
        """Assemble the device-facing page table for one decoder: a
        ``(slots, view)`` int32 array at the page-view bucket covering
        the widest live slot; empty slots and padding entries point at
        the scratch page (their writes land in /dev/null and their
        reads are masked)."""
        widest = max(len(getattr(r, attr))
                     for r in self.slots if r is not None)
        pt = np.zeros((len(self.slots), dec.view_bucket(widest)),
                      np.int32)
        for i, req in enumerate(self.slots):
            if req is not None:
                pages = getattr(req, attr)
                pt[i, :len(pages)] = pages
        return pt

    def _sweep_orphan_pages(self) -> int:
        """Reconcile the arena against the slot map: any used page no
        live request owns is reclaimed.  Steady state never produces orphans — the
        sweep guards the crash path, and the chaos drill asserts the
        ledger closes (``pages_used == Σ live slot pages``) after it."""
        if not self._paged:
            return 0
        n = self.decoder.ledger.reclaim(
            [p for r in self.slots if r is not None for p in r.pages])
        if self._draft is not None:
            n += self._draft.ledger.reclaim(
                [p for r in self.slots if r is not None
                 for p in r.draft_pages])
        if n:
            self.warning(f"swept {n} orphaned arena pages")
        self.metrics.on_pages(self.decoder.ledger.used,
                              self.decoder.ledger.total)
        return n

    def page_ledger(self) -> dict:
        """Arena accounting for post-mortems and tests: used pages per
        the allocator vs pages owned by live slots — equal whenever the
        worker is quiescent."""
        if not self._paged:
            return {"paged": False}
        with self._cond:
            owned = sum(len(r.pages) for r in self.slots
                        if r is not None)
            draft_owned = sum(len(r.draft_pages) for r in self.slots
                              if r is not None)
        out = {"paged": True,
               "pages_used": self.decoder.ledger.used,
               "pages_owned": owned,
               "pages_total": self.decoder.ledger.total,
               "pages_peak": self.decoder.ledger.peak_used}
        if self._draft is not None:
            out["draft_pages_used"] = self._draft.ledger.used
            out["draft_pages_owned"] = draft_owned
        return out

    def _spec_round(self, pt, ptd, pos, tok):
        """Draft-then-verify: the draft proposes k tokens per slot
        (k+1 single-token steps — the last one writes the k-th
        proposal's K/V so an all-accepted round leaves the draft cache
        current), then the target judges all k+1 positions in ONE
        batched verify pass.  Returns ``(proposals (B, k), verify
        logits (B, k+1, V))``."""
        k = self._spec_k
        feeds = tok.copy()
        proposals = np.zeros((len(self.slots), k), np.int32)
        for j in range(k + 1):
            dlogits = self._draft.decode_paged(ptd, pos + j, feeds)
            if j < k:
                feeds = np.argmax(dlogits, axis=1).astype(np.int32)
                proposals[:, j] = feeds
        tokens = np.concatenate([tok[:, None], proposals], axis=1)
        return proposals, self.decoder.verify_paged(pt, pos, tokens)

    def _step_paged(self) -> None:
        """One batched round over the paged arena: plain single-token
        decode, or a speculative draft+verify round emitting 1..k+1
        tokens per greedy slot."""
        k = self._spec_k if self._draft is not None else 0
        if k:
            # a verify pass writes k+1 rows per slot UNCONDITIONALLY — a
            # slot within k tokens of its budget would be forced past
            # pages_for(budget) (spurious eviction in a tight arena)
            # and, at the max_len boundary, past the widest page view.
            # The round degrades to plain decode whenever any live slot
            # is that close to its end — its final tokens were arriving
            # one per step anyway.
            head = min((r.total_budget - r.pos - 1
                        for r in self.slots if r is not None),
                       default=0)
            if head < k:
                k = 0
            # an all-sampled batch gains nothing from a round (each
            # slot takes one token off verify position 0 anyway) but
            # would pay k+1 draft steps and the wide verify for it
            elif not any(r.greedy for r in self.slots
                         if r is not None):
                k = 0
        for i, req in enumerate(self.slots):
            if req is not None and \
                    not self._ensure_pages(req, i, req.pos + k + 1):
                continue                     # evicted: arena exhausted
        live = [(i, r) for i, r in enumerate(self.slots)
                if r is not None]
        if not live:
            return
        pos = np.zeros(len(self.slots), np.int32)
        tok = np.zeros(len(self.slots), np.int32)
        for i, req in live:
            pos[i] = req.pos
            tok[i] = req.next_token
        pt = self._page_table(self.decoder, "pages")
        t_step = time.perf_counter()
        if k:
            proposals, vlogits = self._spec_round(
                pt, self._page_table(self._draft, "draft_pages"), pos,
                tok)
        else:
            logits = self.decoder.decode_paged(pt, pos, tok)
        self.step_count += 1
        _trace.TRACER.complete("generate.decode_step", t_step,
                               time.perf_counter() - t_step,
                               step=self.step_count, active=len(live),
                               paged=True, spec_k=k)
        # anatomy plane: a speculative round is a "verify" phase (draft
        # proposals + the target's batched judgment); a plain round is
        # one "decode" dispatch
        _probe.anatomy_phase("serve", "verify" if k else "decode",
                             time.perf_counter() - t_step, t0=t_step)
        now = time.monotonic()
        for i, req in live:
            if req.stream.cancelled or (req.deadline is not None and
                                        now > req.deadline):
                self._retire_if_done(req, i, now)
                continue
            if not k:
                emitted = [req.sampler.sample(logits[i])]
            elif req.greedy:
                g = np.argmax(vlogits[i], axis=-1)
                a = 0
                while a < k and proposals[i, a] == g[a]:
                    a += 1
                # a accepted drafts + the target's own token at the
                # first mismatch (or the bonus token when all matched):
                # every emitted token IS the target's greedy choice, so
                # the stream is token-identical to plain decode by
                # construction
                emitted = [int(t) for t in proposals[i, :a]] + [int(g[a])]
                self.metrics.on_spec(a, k - a)
            else:
                # sampled request: position 0 of the verify logits IS
                # its exact next-token distribution — one token per
                # round, distribution untouched
                emitted = [req.sampler.sample(vlogits[i, 0])]
            for token in emitted:
                req.pos += 1
                req.next_token = int(token)
                self._emit_token(req, int(token))
                if req.emitted >= req.max_new:
                    break
            self._retire_if_done(req, i, now)

    def _step(self) -> None:
        """One batched decode step over the occupied slots."""
        # chaos hook (site "generate.step"): an injected crash here
        # exercises the fail-all-active path and the stream error
        # sentinel — the kill-mid-decode drill's anchor
        fault_hook("generate.step", batcher=self)
        if self._paged:
            self._step_paged()
            return
        pos = np.zeros(len(self.slots), np.int32)
        tok = np.zeros(len(self.slots), np.int32)
        active = 0
        for i, req in enumerate(self.slots):
            if req is not None:
                pos[i] = req.pos
                tok[i] = req.next_token
                active += 1
        t_step = time.perf_counter()
        self._kv, logits = self.decoder.decode(self._kv, pos, tok)
        self.step_count += 1
        # one batched decode-step span per step (worker thread): a
        # request's share of it is bracketed by its first_token_step /
        # finish_step counters
        _trace.TRACER.complete("generate.decode_step", t_step,
                               time.perf_counter() - t_step,
                               step=self.step_count, active=active)
        _probe.anatomy_phase("serve", "decode",
                             time.perf_counter() - t_step, t0=t_step)
        now = time.monotonic()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            # cancel/deadline between steps: retire without sampling
            if req.stream.cancelled or (req.deadline is not None and
                                        now > req.deadline):
                self._retire_if_done(req, i, now)
                continue
            req.pos += 1
            token = req.sampler.sample(logits[i])
            req.next_token = token
            self._emit_token(req, token)
            self._retire_if_done(req, i, now)

    def _fail_active(self, exc: Exception) -> None:
        """A decode-loop crash poisons every in-flight stream (their
        cache state is unknowable mid-step) — each gets its error
        sentinel and the worker keeps serving the queue."""
        for i, req in enumerate(self.slots):
            if req is not None:
                self._finish(req, {"error": f"decode failed: {exc!r}",
                                   "done": True})
                self.slots[i] = None

    def _flush_pending(self, exc: Exception) -> None:
        while True:
            with self._cond:
                if not self._pending:
                    return
                req = self._pending.pop(0)
            self._finish(req, {"error": str(exc), "done": True})

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and \
                        all(s is None for s in self.slots) and \
                        not self._closing:
                    self._cond.wait()
                closing = self._closing
                drain = self._drain
            if closing and not drain:
                self._fail_active(QueueFull("generate batcher shut down"))
                self._flush_pending(QueueFull("generate batcher shut "
                                              "down"))
                return
            try:
                self._admit()
                if any(s is not None for s in self.slots):
                    self._step()
            except Exception as exc:  # noqa: BLE001 — the worker must
                # outlive anything one decode step can throw
                self.error(f"decode step crashed: {exc!r}")
                self._fail_active(exc)
                # a crash between a page allocation and its page-table
                # record could strand arena pages — reconcile before
                # serving the queue again
                self._sweep_orphan_pages()
            with self._cond:
                active = sum(s is not None for s in self.slots)
                queued = len(self._pending)
            self.metrics.on_slots(active, queued)
            if closing and active == 0 and queued == 0:
                return

    # -- lifecycle -----------------------------------------------------------
    def stop(self, drain: bool = True,
             join_timeout_s: float = 30.0) -> bool:
        """Stop admitting.  ``drain=True`` decodes everything admitted
        to completion; ``drain=False`` fails queued and active requests
        loudly.  Returns True when the worker exited in time."""
        with self._cond:
            self._closing = True
            self._drain = drain
            self._cond.notify_all()
        self._worker.join(timeout=join_timeout_s)
        _flight.unregister_plane("generate_ledger", self._flight_plane)
        return not self._worker.is_alive()

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)
