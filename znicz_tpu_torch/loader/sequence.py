"""Character-sequence loader for language-model training — the port of
``znicz_tpu/loader/sequence.py`` (numpy only; the sequence sibling of the
bag-of-words text loader, over the reference's TEST/VALID/TRAIN
minibatch serving).

The corpus files are the text loader's (``train.txt``/``test.txt``,
synthesized once when absent — loader/text.py, a copy of the
reference's, so both packages read the same bytes); their characters
become one id stream per split, and each "sample" is a non-overlapping
window of ``seq_len + 1`` characters serving ``tokens = w[:-1]`` and
``labels = w[1:]`` (next-char targets).  The VALID split is carved off
the train stream's tail; TEST windows come from ``test.txt``.  Window
ORDER shuffles per epoch through the base-class plan; window CONTENT is
fixed.  The only difference from the reference is the producer fill's
signature: the port's pipeline passes the minibatch class too.
"""

from __future__ import annotations

import os

import numpy as np

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import (TEST, TRAIN, VALID, Loader,
                                         register_loader)
from znicz_tpu_torch.loader.text import FILES, ensure_corpus_files


@register_loader("char_sequence")
class CharSequenceLoader(Loader):
    """Serve (tokens, next-char labels) windows over a character corpus.

    ``vocab`` is the sorted character set of the whole corpus (train +
    test) — deterministic, so checkpoints and exports agree on ids.
    """

    def __init__(self, workflow=None, data_dir: str = "",
                 seq_len: int = 32, valid_fraction: float = 0.1,
                 synthesize: bool = True, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.data_dir = data_dir or os.path.join(
            str(root.common.dirs.datasets), "text_corpus")
        self.seq_len = int(seq_len)
        self.valid_fraction = float(valid_fraction)
        self.synthesize = synthesize
        self.vocab: list[str] = []
        self._streams: dict[int, np.ndarray] = {}   # cls -> id stream
        self._starts: np.ndarray | None = None      # global idx -> offset
        self._start_cls: np.ndarray | None = None   # global idx -> cls

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- corpus -> id streams ----------------------------------------------
    def load_data(self) -> None:
        ensure_corpus_files(self.data_dir, self.synthesize, self.info)
        self._texts = {}
        for split in ("train", "test"):
            with open(os.path.join(self.data_dir, FILES[split]),
                      encoding="utf-8") as f:
                self._texts[split] = f.read()
        self.vocab = sorted(set(self._texts["train"]) |
                            set(self._texts["test"]))
        self._vectorize()

    def _vectorize(self) -> None:
        """Id streams + window table from ``self._texts`` under the
        CURRENT ``self.vocab`` (re-run by restore when the snapshot's
        vocab must override a changed corpus's)."""
        lut = {ch: i for i, ch in enumerate(self.vocab)}
        # chars outside the vocab (corpus changed after the snapshot that
        # pinned it) map to id 0 — the params carry no row for them
        ids = {split: np.fromiter((lut.get(c, 0) for c in text), np.int32,
                                  count=len(text))
               for split, text in self._texts.items()}
        train_ids = ids["train"]
        n_valid_chars = int(len(train_ids) * self.valid_fraction)
        self._streams = {
            TEST: ids["test"],
            VALID: train_ids[len(train_ids) - n_valid_chars:],
            TRAIN: train_ids[:len(train_ids) - n_valid_chars],
        }
        starts, start_cls = [], []
        for cls in (TEST, VALID, TRAIN):       # storage order = class order
            # non-overlapping windows of seq_len tokens; the label slice
            # reads one char past the window, hence the -1
            n_win = max(len(self._streams[cls]) - 1, 0) // self.seq_len
            self.class_lengths[cls] = n_win
            starts.extend(off * self.seq_len for off in range(n_win))
            start_cls.extend([cls] * n_win)
        self._starts = np.asarray(starts, np.int64)
        self._start_cls = np.asarray(start_cls, np.int64)

    # -- serving ------------------------------------------------------------
    def create_minibatch_data(self) -> None:
        shape = (self.max_minibatch_size, self.seq_len)
        self.minibatch_data.reset(shape=shape, dtype=np.int32)
        self.minibatch_labels.reset(shape=shape, dtype=np.int32)

    def _fill_rows(self, data, labels, indices) -> None:
        """THE window gather (sync and pipelined fills share it, so the
        two paths cannot drift): tokens/next-char labels per index row,
        zeroed padding for -1."""
        T = self.seq_len
        for row, gi in enumerate(indices):
            if gi < 0:
                data[row] = 0
                labels[row] = 0
                continue
            stream = self._streams[int(self._start_cls[gi])]
            off = int(self._starts[gi])
            data[row] = stream[off:off + T]
            labels[row] = stream[off + 1:off + T + 1]

    def fill_minibatch(self) -> None:
        self._fill_rows(self.minibatch_data.map_write(),
                        self.minibatch_labels.map_write(),
                        self.minibatch_indices.mem)

    def fill_batch(self, indices: np.ndarray, count: int, cls: int) -> dict:
        """Producer-side fill for the prefetch pipeline (ring-owned
        buffers, published attrs untouched)."""
        shape = (self.max_minibatch_size, self.seq_len)
        data = self._next_buffer("data", shape, np.int32)
        labels = self._next_buffer("labels", shape, np.int32)
        self._fill_rows(data, labels, indices)
        return {"data": data, "labels": labels}

    # -- snapshot support ---------------------------------------------------
    def state_dict(self) -> dict:
        # the vocab IS the id assignment the trained params depend on:
        # restore must re-vectorize with the snapshot's char->id map even
        # if the corpus files changed underneath
        return {**super().state_dict(), "vocab": list(self.vocab)}

    def load_state_dict(self, state: dict) -> None:
        # adopt the snapshot vocab BEFORE restoring the serving position:
        # the restored shuffle orders index the snapshot-era window
        # table, which re-vectorizing reproduces
        if "vocab" in state and list(state["vocab"]) != self.vocab:
            self.warning("corpus vocab differs from the snapshot's; "
                         "re-vectorizing with the snapshot vocab "
                         "(unknown chars map to id 0)")
            self.vocab = list(state["vocab"])
            self._vectorize()
        super().load_state_dict(state)
        # a corpus that changed SIZE since the snapshot shifts the window
        # table and the class boundaries — restored indices would serve
        # wrong-split (or out-of-range) windows; fail loudly instead
        for cls, order in self._shuffled.items():
            lo = self.class_offset(cls)
            hi = lo + self.class_lengths[cls]
            if len(order) != self.class_lengths[cls] or \
                    (len(order) and (order.min() < lo or
                                     order.max() >= hi)):
                raise ValueError(
                    "snapshot loader state does not match the current "
                    "corpus geometry — cannot resume the serving "
                    "position on a changed corpus")
