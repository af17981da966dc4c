"""Text-corpus loader — the port's copy of ``znicz_tpu/loader/text.py``
(numpy only): bag-of-words vectorization over a labeled token
corpus (reference: the veles.znicz SpamFilter research workflow, whose
loader turns a lemmatized spam/ham corpus into fixed-width bag-of-words
vectors served by a FullBatchLoader; tests/research/SpamFilter).

Corpus format (one document per line, UTF-8)::

    <label>\t<token> <token> <token> ...

``train.txt`` and ``test.txt`` are both required (``test.txt`` serves as
the VALID class, the reference convention; make it an empty file for a
train-only corpus).  The vocabulary is the ``vocab_size``
most frequent train-split tokens (count-then-alphabetical ordering — fully
deterministic); each document becomes a ``log1p(count)`` vector with a
fitted normalizer on top, so the text path reuses the same normalizer
registry and snapshot-restore contract as every other loader.

``synthesize_text_corpus`` writes a seeded two-class corpus once when the
real files are absent (nothing is downloaded) — class-conditional Zipfian
token draws with overlapping support, so the classes are separable but not
trivially so.  Drop real corpus files in the same layout to use them.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import register_loader
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.loader.normalization import (NormalizerStateMixin,
                                                   normalizer_factory)

FILES = {"train": "train.txt", "test": "test.txt"}

#: bump when the synthesis recipe changes — stale cached files regenerate
SYNTH_VERSION = "1"


def read_corpus(path: str) -> tuple[list[list[str]], np.ndarray]:
    """Parse one corpus file -> (documents, labels)."""
    docs, labels = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            label, _, text = line.partition("\t")
            docs.append(text.split())
            labels.append(int(label))
    return docs, np.asarray(labels, np.int32)


def build_vocabulary(docs: list[list[str]], vocab_size: int) -> dict:
    """Top-``vocab_size`` tokens by frequency; ties alphabetical (the
    ordering is part of the serve contract — snapshots depend on it)."""
    counts = Counter(t for doc in docs for t in doc)
    ordered = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    return {tok: i for i, (tok, _) in enumerate(ordered[:vocab_size])}


def vectorize(docs: list[list[str]], vocab: dict) -> np.ndarray:
    """Documents -> float32 ``log1p(count)`` matrix (n_docs, len(vocab));
    out-of-vocabulary tokens are dropped (reference behavior: the fixed
    dictionary is built from the train corpus only)."""
    out = np.zeros((len(docs), len(vocab)), np.float32)
    for row, doc in enumerate(docs):
        for tok in doc:
            col = vocab.get(tok)
            if col is not None:
                out[row, col] += 1.0
    return np.log1p(out)


def synthesize_text_corpus(directory: str, n_train: int = 600,
                           n_test: int = 200, n_tokens: int = 300,
                           doc_len: int = 40) -> None:
    """Write a seeded two-class corpus (spam=1 / ham=0) once.  Each class
    draws tokens Zipf-style from its own half of the token table plus a
    shared overlap band in the middle, so bag-of-words statistics separate
    the classes without any single giveaway token.  Fixed private seed:
    files are bit-identical regardless of global prng state."""
    os.makedirs(directory, exist_ok=True)
    gen = np.random.default_rng(1234603)
    half = n_tokens // 2
    overlap = n_tokens // 4
    for split, n in (("train", n_train), ("test", n_test)):
        lines = []
        labels = np.arange(n) % 2
        gen.shuffle(labels)
        for label in labels:
            lo = 0 if label == 0 else half - overlap // 2
            hi = half + overlap // 2 if label == 0 else n_tokens
            ranks = gen.zipf(1.5, size=doc_len)
            ids = lo + (ranks - 1) % (hi - lo)
            toks = " ".join(f"w{int(i):04d}" for i in ids)
            lines.append(f"{int(label)}\t{toks}")
        # write-then-rename: a visible corpus file is always complete (a
        # torn synthesis leaves a missing file, which _ensure_files
        # detects — never a silently truncated one)
        final = os.path.join(directory, FILES[split])
        tmp = final + f".tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        os.replace(tmp, final)
    with open(os.path.join(directory, ".synth_version"), "w") as f:
        f.write(SYNTH_VERSION)


def ensure_corpus_files(data_dir: str, synthesize: bool, log=None) -> None:
    """The ONE corpus ensure/staleness protocol (sibling-loader
    convention, see MnistLoader._ensure_files): all files required — a
    torn synthesis shows up as a missing file and regenerates instead of
    silently serving an empty split; a stale ``.synth_version`` rebuilds.
    Shared by the bag-of-words and char-sequence loaders."""
    missing = [n for n in FILES.values()
               if not os.path.exists(os.path.join(data_dir, n))]
    vfile = os.path.join(data_dir, ".synth_version")
    stale = False
    if os.path.exists(vfile):
        with open(vfile) as f:
            stale = f.read().strip() != SYNTH_VERSION
    if not missing and not stale:
        return
    if not synthesize:
        raise FileNotFoundError(
            f"corpus files missing in {data_dir}: {missing}")
    if log is not None:
        log(f"synthesizing text corpus in {data_dir}")
    synthesize_text_corpus(data_dir)


@register_loader("text_bow")
class TextBagOfWordsLoader(NormalizerStateMixin, FullBatchLoader):
    """Bag-of-words corpus loader.

    ``n_train`` / ``n_valid`` subset the files (None = all); ``test.txt``
    serves as the VALID class.  The vocabulary and the normalizer are
    fitted on the train split only.
    """

    def __init__(self, workflow=None, data_dir: str | None = None,
                 vocab_size: int = 256, n_train: int | None = None,
                 n_valid: int | None = None,
                 normalization_type: str = "mean_disp",
                 synthesize: bool = True, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.data_dir = data_dir or os.path.join(
            str(root.common.dirs.datasets), "spam_corpus")
        self.vocab_size = vocab_size
        self.n_train = n_train
        self.n_valid = n_valid
        self.normalizer = normalizer_factory(normalization_type)
        self.synthesize = synthesize
        self.vocab: dict = {}

    @property
    def n_classes(self) -> int:
        return 2

    def _ensure_files(self) -> None:
        ensure_corpus_files(self.data_dir, self.synthesize, self.info)

    def _load_raw(self):
        """(test_docs, test_y, train_docs, train_y) straight from the
        corpus files, subsets applied."""
        self._ensure_files()
        train_docs, train_y = read_corpus(
            os.path.join(self.data_dir, FILES["train"]))
        test_path = os.path.join(self.data_dir, FILES["test"])
        if os.path.exists(test_path):
            test_docs, test_y = read_corpus(test_path)
        else:
            test_docs, test_y = [], np.zeros(0, np.int32)
        n_train = self.n_train if self.n_train is not None \
            else len(train_docs)
        n_valid = self.n_valid if self.n_valid is not None \
            else len(test_docs)
        return (test_docs[:n_valid], test_y[:n_valid],
                train_docs[:n_train], train_y[:n_train])

    def load_data(self) -> None:
        test_docs, test_y, train_docs, train_y = self._load_raw()
        self.vocab = build_vocabulary(train_docs, self.vocab_size)
        train_x = vectorize(train_docs, self.vocab)
        test_x = vectorize(test_docs, self.vocab)
        self.normalizer.analyze(train_x)
        self.original_data.mem = self.normalizer.normalize(
            np.concatenate([test_x, train_x]))
        self.original_labels.mem = np.concatenate(
            [test_y, train_y]).astype(np.int32)
        self.class_lengths = [0, len(test_docs), len(train_docs)]

    def state_dict(self) -> dict:
        state = super().state_dict()
        # the vocabulary is part of the serve contract: restore must
        # vectorize with the snapshot's token->column map even if the
        # corpus files changed underneath
        state["vocab"] = dict(self.vocab)
        return state

    def load_state_dict(self, state: dict) -> None:
        if "vocab" in state:
            self.vocab = dict(state["vocab"])
        super().load_state_dict(state)

    def _renormalize_served_data(self) -> None:
        # snapshot restore swapped the normalizer in after load_data:
        # re-vectorize from the files with the restored stats
        test_docs, _ty, train_docs, _y = self._load_raw()
        raw = np.concatenate([vectorize(test_docs, self.vocab),
                              vectorize(train_docs, self.vocab)])
        self.original_data.map_invalidate()
        self.original_data.mem = self.normalizer.normalize(raw)
