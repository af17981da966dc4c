"""MNIST loader over IDX files — the port's copy of
``znicz_tpu/loader/mnist.py`` (numpy only; rebuild of the znicz MNIST
sample loader, veles.znicz samples/MNIST :: MnistLoader, which reads the
classic ``train-images-idx3-ubyte`` quartet under
``root.common.dirs.datasets``).

Nothing is downloaded: missing files are synthesized ONCE as real IDX
files (rendered digit glyphs with seeded jitter, from a fixed private
seed, so both packages write the same bytes) and every later run goes
through the genuine file -> decode -> normalize -> minibatch path.  Real
MNIST files dropped into the same directory are used as they are.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import register_loader
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.loader.normalization import (
    NormalizerStateMixin, normalizer_factory)

#: IDX dtype codes (the format's own table)
_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
               0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
_IDX_CODES = {np.dtype(v): k for k, v in _IDX_DTYPES.items()}

FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def write_idx(path: str, array: np.ndarray) -> None:
    """Serialize ``array`` in IDX format (gzip if path ends with .gz).
    IDX payloads are big-endian; byte-swap multi-byte dtypes on write
    (uint8 MNIST images are unaffected, int32/float32 tensors are not)."""
    array = np.ascontiguousarray(array)
    code = _IDX_CODES[array.dtype]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, code, array.ndim))
        for dim in array.shape:
            f.write(struct.pack(">I", dim))
        f.write(array.astype(array.dtype.newbyteorder(">"),
                             copy=False).tobytes())


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (transparently handles a .gz sibling)."""
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path += ".gz"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, zero2, code, ndim = struct.unpack(">BBBB", f.read(4))
        if zero or zero2 or code not in _IDX_DTYPES:
            raise ValueError(f"{path}: not an IDX file")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        dtype = np.dtype(_IDX_DTYPES[code]).newbyteorder(">")
        data = np.frombuffer(f.read(), dtype=dtype)
    return data.reshape(shape).astype(_IDX_DTYPES[code])


#: 7x5 digit glyphs for the synthetic fallback
_GLYPHS = [
    "01110 10001 10011 10101 11001 10001 01110",  # 0
    "00100 01100 00100 00100 00100 00100 01110",  # 1
    "01110 10001 00001 00110 01000 10000 11111",  # 2
    "01110 10001 00001 00110 00001 10001 01110",  # 3
    "00010 00110 01010 10010 11111 00010 00010",  # 4
    "11111 10000 11110 00001 00001 10001 01110",  # 5
    "01110 10000 10000 11110 10001 10001 01110",  # 6
    "11111 00001 00010 00100 01000 01000 01000",  # 7
    "01110 10001 10001 01110 10001 10001 01110",  # 8
    "01110 10001 10001 01111 00001 00001 01110",  # 9
]


def _render_digit(digit: int, gen, size: int = 28) -> np.ndarray:
    """One jittered glyph image (uint8): scale 2-3x, near-centered with
    +-3px shift (real MNIST is centered), intensity jitter, noise."""
    rows = _GLYPHS[digit].split()
    glyph = np.array([[c == "1" for c in row] for row in rows], np.float32)
    scale = int(gen.integers(2, 4))
    img = np.kron(glyph, np.ones((scale, scale), np.float32))
    h, w = img.shape
    canvas = np.zeros((size, size), np.float32)
    cy, cx = (size - h) // 2, (size - w) // 2
    dy = int(np.clip(cy + gen.integers(-3, 4), 0, size - h))
    dx = int(np.clip(cx + gen.integers(-3, 4), 0, size - w))
    canvas[dy:dy + h, dx:dx + w] = img
    canvas *= gen.uniform(0.6, 1.0)
    canvas += gen.normal(0.0, 0.08, canvas.shape).astype(np.float32)
    return (np.clip(canvas, 0, 1) * 255).astype(np.uint8)


#: bump when the synthesis recipe changes — stale cached files regenerate
SYNTH_VERSION = "2"


def synthesize_mnist(directory: str, n_train: int = 6000,
                     n_test: int = 1000) -> None:
    """Write a seeded MNIST-format dataset (IDX quartet) into
    ``directory`` — done once; later runs read the files like real data.
    Uses a FIXED private seed (not the global prng) so the generated files
    are bit-identical no matter which process creates them first — the
    tier-2 pinned metrics depend on that."""
    os.makedirs(directory, exist_ok=True)
    gen = np.random.default_rng(1234601)
    for split, n in (("train", n_train), ("test", n_test)):
        labels = np.arange(n, dtype=np.uint8) % 10
        gen.shuffle(labels)
        images = np.stack([_render_digit(int(d), gen) for d in labels])
        write_idx(os.path.join(directory, FILES[f"{split}_images"]), images)
        write_idx(os.path.join(directory, FILES[f"{split}_labels"]),
                  np.asarray(labels, np.uint8))
    with open(os.path.join(directory, ".synth_version"), "w") as f:
        f.write(SYNTH_VERSION)


@register_loader("mnist")
class MnistLoader(NormalizerStateMixin, FullBatchLoader):
    """IDX-file MNIST with fitted normalization.

    ``n_train`` / ``n_valid`` subset the files (None = all); the MNIST
    test file serves as the VALID class (reference convention: Decision
    watches it).  ``normalization_type`` picks from the registry.
    """

    def __init__(self, workflow=None, data_dir: str | None = None,
                 n_train: int | None = None, n_valid: int | None = None,
                 normalization_type: str = "linear",
                 synthesize: bool = True,
                 synth_sizes: tuple = (6000, 1000), **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.data_dir = data_dir or os.path.join(
            str(root.common.dirs.datasets), "mnist")
        self.n_train = n_train
        self.n_valid = n_valid
        self.normalizer = normalizer_factory(normalization_type)
        self.synthesize = synthesize
        self.synth_sizes = tuple(synth_sizes)

    def _ensure_files(self) -> None:
        missing = [n for n in FILES.values()
                   if not os.path.exists(os.path.join(self.data_dir, n))
                   and not os.path.exists(
                       os.path.join(self.data_dir, n + ".gz"))]
        vfile = os.path.join(self.data_dir, ".synth_version")
        stale = False
        if os.path.exists(vfile):
            with open(vfile) as f:
                stale = f.read().strip() != SYNTH_VERSION
        if not missing and not stale:
            return
        if not self.synthesize:
            raise FileNotFoundError(
                f"MNIST files missing in {self.data_dir}: {missing}")
        self.info(f"synthesizing MNIST-format dataset in {self.data_dir}")
        synthesize_mnist(self.data_dir, *self.synth_sizes)

    def _load_raw(self):
        """(test_x, test_y, train_x, train_y) straight from the IDX
        files, subset applied — shared by load_data and the restore
        re-normalization (which re-reads instead of holding a second
        in-RAM copy of the dataset)."""
        self._ensure_files()
        d = self.data_dir
        train_x = read_idx(os.path.join(d, FILES["train_images"]))
        train_y = read_idx(os.path.join(d, FILES["train_labels"]))
        test_x = read_idx(os.path.join(d, FILES["test_images"]))
        test_y = read_idx(os.path.join(d, FILES["test_labels"]))
        n_train = self.n_train or len(train_x)
        n_valid = self.n_valid if self.n_valid is not None else len(test_x)
        return (test_x[:n_valid], test_y[:n_valid],
                train_x[:n_train], train_y[:n_train])

    def load_data(self) -> None:
        test_x, test_y, train_x, train_y = self._load_raw()
        # fit on train only (reference: loader analyzes the train split)
        self.normalizer.analyze(train_x.astype(np.float32))
        raw = np.concatenate([test_x, train_x]).astype(np.float32)
        # serve NHWC (28, 28, 1): conv stacks need the channel axis and
        # All2All flattens anything
        self.original_data.mem = self.normalizer.normalize(raw)[..., None]
        self.original_labels.mem = np.concatenate(
            [test_y, train_y]).astype(np.int32)
        self.class_lengths = [0, len(test_x), len(train_x)]

    def _renormalize_served_data(self) -> None:
        # a snapshot restore swapped the normalizer in AFTER load_data:
        # re-read the raw files and re-normalize with the restored stats
        test_x, _ty, train_x, _y = self._load_raw()
        raw = np.concatenate([test_x, train_x]).astype(np.float32)
        self.original_data.map_invalidate()
        self.original_data.mem = self.normalizer.normalize(raw)[..., None]
