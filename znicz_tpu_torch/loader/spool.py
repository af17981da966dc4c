"""Streaming dataset loader over the feedback spool (the port of
``znicz_tpu/loader/spool.py``) — the learn plane's bridge between live
serving traffic and the training loop.

``SpoolSequenceLoader`` tails a :class:`~znicz_tpu_torch.learn.spool.
FeedbackSpool` directory and serves (tokens, next-token labels)
windows exactly like :class:`~znicz_tpu_torch.loader.sequence.
CharSequenceLoader` serves a static corpus — same window geometry,
same static-shape minibatches, same ``fill_batch`` producer fill, so
the async ``BatchPrefetcher`` pipelines it unchanged.  The one
difference from the reference is the producer fill's signature: the
port's pipeline passes the minibatch class too.

**Epoch = a deterministic slice of the stream.**  At each epoch start
the loader ingests the next ``records_per_epoch`` spool records from
its cursor (extending one record at a time while they yield zero full
windows), windows them, and serves that set as one epoch.  Because the
spool fixes a total record order the moment bytes are appended
(learn/spool.py), "the next R records after cursor C" is a pure
function of the spool bytes — two runs consuming from the same cursor
train on identical data no matter when they run.  That is the whole
determinism story:

- the consumption cursor (where the CURRENT epoch started, where it
  ended, and how many records it spans) rides ``state_dict`` into
  every training snapshot;
- ``load_state_dict`` re-reads exactly that span from the spool and
  verifies it lands on the stored end cursor — an elastic resume
  therefore re-trains NOTHING and skips NOTHING (pinned by the
  overlap drill: a mid-epoch SIGKILL'd trainer resumes to a
  bit-identical metric history);
- torn spool lines are skipped-and-counted inside the reader, never a
  loader crash, and the skip is part of the byte-stable replay.

The durable ``CURSOR.json`` beside the segments mirrors the epoch
floor for operators and retention tooling; the snapshot remains the
resume authority.
"""

from __future__ import annotations

import os

import numpy as np

from znicz_tpu_torch.learn.spool import (SpoolReader, initial_cursor,
                                         write_cursor_file)
from znicz_tpu_torch.loader.base import TRAIN, Loader, register_loader
from znicz_tpu_torch.observe import registry as _reg

_M_TRAINED = _reg.counter(
    "znicz_learn_records_trained_total",
    "spool records the trainer has ingested into an epoch (committed "
    "to the next snapshot's cursor)")


@register_loader("spool_sequence")
class SpoolSequenceLoader(Loader):
    """Serve next-token windows over the live feedback spool.

    ``charmap`` is the id space (from the serving LM package — trainer
    and servers must agree on the vocabulary); ``records_per_epoch``
    sets the stream slice one epoch trains on; ``wait_timeout_s``
    bounds how long an epoch ingest waits for quiet writers before
    failing loudly.  Records of kind ``generate`` contribute their
    ``prompt + tokens`` id stream; other kinds are consumed (the
    cursor advances past them) but yield no windows.
    """

    def __init__(self, workflow=None, spool_dir: str = "",
                 charmap=None, seq_len: int = 16,
                 records_per_epoch: int = 8,
                 wait_timeout_s: float = 120.0,
                 publish_cursor: bool = True, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if not spool_dir:
            raise ValueError("SpoolSequenceLoader needs spool_dir=")
        if not charmap:
            raise ValueError(
                "SpoolSequenceLoader needs charmap= (the serving "
                "package's id->char map — trainer and servers must "
                "share one vocabulary)")
        self.spool_dir = str(spool_dir)
        #: the id->char map; ``vocab``/``vocab_size`` follow the
        #: CharSequenceLoader convention TransformerLMStep + export read
        self.vocab = list(charmap)
        self.seq_len = int(seq_len)
        self.records_per_epoch = int(records_per_epoch)
        if self.records_per_epoch < 1:
            raise ValueError(f"records_per_epoch must be >= 1, got "
                             f"{records_per_epoch}")
        self.wait_timeout_s = float(wait_timeout_s)
        self.publish_cursor = bool(publish_cursor)
        self._reader = SpoolReader(self.spool_dir)
        self._windows: np.ndarray | None = None   # (n, seq_len + 1)
        self._cursor_start: dict | None = None    # current epoch's span
        self._cursor: dict | None = None
        self._epoch_records = 0
        self._ingested_epoch = -1

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- stream ingestion ----------------------------------------------------
    def _window_records(self, records: list) -> np.ndarray:
        """Token streams -> stacked (n, seq_len + 1) windows.  Each
        generate record windows independently (requests are not
        concatenated across provenance boundaries); ids outside the
        vocab clamp to 0, the CharSequenceLoader convention."""
        T = self.seq_len
        rows = []
        for rec in records:
            if rec.get("kind") != "generate":
                continue
            ids = list(rec.get("prompt") or []) + \
                list(rec.get("tokens") or [])
            stream = np.clip(np.asarray(ids, np.int64), 0,
                             self.vocab_size - 1).astype(np.int32)
            for w in range((len(stream) - 1) // T):
                rows.append(stream[w * T:w * T + T + 1])
        if not rows:
            return np.zeros((0, T + 1), np.int32)
        return np.stack(rows)

    def _ingest(self, wait: bool = True) -> None:
        """Advance the stream one epoch: read ``records_per_epoch``
        records from the cursor (extending while they yield zero
        windows), rebuild the window table, publish the durable
        cursor floor."""
        start = dict(self._cursor)
        records, cursor = self._reader.read(
            dict(start), self.records_per_epoch,
            wait_s=self.wait_timeout_s if wait else None)
        windows = self._window_records(records)
        while not len(windows):
            # deterministic extension: zero-window slices (short or
            # non-generate records) pull one more record — still a
            # pure function of (spool bytes, cursor).  Bounded: a
            # traffic profile whose records NEVER out-length the
            # window (seq_len + 1 ids) must fail loudly naming the
            # mismatch, not stall the trainer forever.
            if len(records) >= 8 * self.records_per_epoch:
                raise ValueError(
                    f"{len(records)} consecutive spool records yielded "
                    f"zero training windows — records must carry at "
                    f"least seq_len + 1 = {self.seq_len + 1} token ids "
                    f"(shrink seq_len or raise the serving plane's "
                    f"max_tokens)")
            more, cursor = self._reader.read(
                dict(cursor), 1,
                wait_s=self.wait_timeout_s if wait else None)
            records.extend(more)
            windows = self._window_records(records)
        self._adopt_epoch(start, cursor, len(records), windows)
        _M_TRAINED.inc(len(records))
        self._reader.lag(cursor)          # stamps the lag gauge
        if self.publish_cursor:
            write_cursor_file(self.spool_dir, start)

    def _adopt_epoch(self, start: dict, end: dict, n_records: int,
                     windows: np.ndarray) -> None:
        self._cursor_start = dict(start)
        self._cursor = dict(end)
        self._epoch_records = int(n_records)
        self._windows = windows
        self.class_lengths = [0, 0, len(windows)]
        # the window table changed size: the base class rebuilds (and
        # reshuffles) the train order from the new class_lengths
        self._shuffled.pop(TRAIN, None)
        self._ingested_epoch = self._epoch

    # -- Loader lifecycle ----------------------------------------------------
    def load_data(self) -> None:
        os.makedirs(self.spool_dir, exist_ok=True)
        self._cursor = initial_cursor(self.spool_dir)
        self._ingest()

    def _shuffle_train(self) -> None:
        # epoch boundary (base _complete_record bumped _epoch before
        # calling here): pull the next stream slice BEFORE the reshuffle
        # so the fresh order covers the fresh windows.  prng order is
        # untouched — ingestion draws nothing.
        if self._ingested_epoch < self._epoch:
            self._ingest()
        super()._shuffle_train()

    def create_minibatch_data(self) -> None:
        shape = (self.max_minibatch_size, self.seq_len)
        self.minibatch_data.reset(shape=shape, dtype=np.int32)
        self.minibatch_labels.reset(shape=shape, dtype=np.int32)

    def _fill_rows(self, data, labels, indices) -> None:
        """THE window gather (sync and pipelined fills share it)."""
        for row, gi in enumerate(indices):
            if gi < 0:
                data[row] = 0
                labels[row] = 0
                continue
            window = self._windows[int(gi)]
            data[row] = window[:-1]
            labels[row] = window[1:]

    def fill_minibatch(self) -> None:
        self._fill_rows(self.minibatch_data.map_write(),
                        self.minibatch_labels.map_write(),
                        self.minibatch_indices.mem)

    def fill_batch(self, indices: np.ndarray, count: int, cls: int) -> dict:
        shape = (self.max_minibatch_size, self.seq_len)
        data = self._next_buffer("data", shape, np.int32)
        labels = self._next_buffer("labels", shape, np.int32)
        self._fill_rows(data, labels, indices)
        return {"data": data, "labels": labels}

    # -- snapshot support ----------------------------------------------------
    def state_dict(self) -> dict:
        # the current epoch's stream span is the resume contract: the
        # snapshot names WHERE the epoch's records start, where they
        # end, and how many there are — restore re-reads exactly that
        # span, so a resumed trainer re-trains nothing and skips
        # nothing (the exactly-once pin)
        return {**super().state_dict(),
                "charmap": list(self.vocab),
                "cursor_start": dict(self._cursor_start),
                "cursor": dict(self._cursor),
                "epoch_records": int(self._epoch_records)}

    def load_state_dict(self, state: dict) -> None:
        if "cursor_start" not in state:
            raise ValueError("snapshot carries no spool cursor — not a "
                             "SpoolSequenceLoader snapshot")
        if list(state.get("charmap", [])) != self.vocab:
            raise ValueError(
                "snapshot charmap differs from this trainer's — the "
                "serving package and the snapshot disagree on the "
                "vocabulary")
        start = dict(state["cursor_start"])
        want_end = dict(state["cursor"])
        want_n = int(state["epoch_records"])
        records, cursor = self._reader.read(
            dict(start), want_n, wait_s=self.wait_timeout_s)
        if (cursor["seg"], cursor["offset"]) != \
                (want_end["seg"], want_end["offset"]):
            raise ValueError(
                f"spool bytes changed under the snapshot cursor: "
                f"re-reading {want_n} records from "
                f"{start['seg']}:{start['offset']} landed at "
                f"{cursor['seg']}:{cursor['offset']}, snapshot says "
                f"{want_end['seg']}:{want_end['offset']}")
        windows = self._window_records(records)
        self._adopt_epoch(start, cursor, want_n, windows)
        if self.publish_cursor:
            write_cursor_file(self.spool_dir, start)
        super().load_state_dict(state)
        self._ingested_epoch = self._epoch
        order = self._shuffled.get(TRAIN)
        if order is None or len(order) != len(windows):
            raise ValueError(
                f"snapshot train order covers "
                f"{0 if order is None else len(order)} windows but the "
                f"replayed stream span yields {len(windows)} — cannot "
                f"resume")
