"""Image-file loaders — the port of ``znicz_tpu/loader/image.py``
(rebuild of veles/loader/image.py :: ImageLoader / FullBatchImageLoader
and veles/loader/file_image.py :: FileImageLoader, with the
directory-per-class convention of the ImageNet/AlexNet pipelines).

Reference behavior kept: images live on disk; the loader scans a directory
tree where each subdirectory name is a class label, splits deterministically
into train/validation, decodes per minibatch (streaming: the whole dataset
is never materialized), augments (seeded crops and mirrors) and applies a
fitted normalizer.  Decoding goes into fresh per-minibatch buffers, as the
reference's does.

``synthesize_image_dataset`` writes the reference's seeded tree (the same
files) once, so the file -> decode -> normalize -> minibatch path runs
where no dataset is installed.

The prefetch pipeline's producer fill (:meth:`FileImageLoader.fill_batch`)
serves what :meth:`FileImageLoader.fill_minibatch` serves, drawing the
augmentation stream in the same order, into the staging ring's buffers.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import (Loader, TEST, TRAIN, VALID,
                                         register_loader)
from znicz_tpu_torch.loader.fullbatch import _gather
from znicz_tpu_torch.loader.normalization import (NormalizerStateMixin,
                                                  normalizer_factory)
from znicz_tpu_torch.resilience.retry import DEFAULT_IO_RETRY

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".gif")

#: bump when the synthesis recipe changes — stale cached trees regenerate
SYNTH_VERSION = "1"


def _decode_once(path: str, sample_shape: tuple) -> np.ndarray:
    from PIL import Image

    h, w, c = sample_shape
    with Image.open(path) as img:
        img = img.convert("L" if c == 1 else "RGB")
        if img.size != (w, h):
            img = img.resize((w, h), Image.BILINEAR)
        arr = np.asarray(img, np.float32)
    if c == 1 and arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _decode(path: str, sample_shape: tuple) -> np.ndarray:
    """Read one image file as (H, W, C) float32 in [0, 255], resized to
    ``sample_shape`` where it differs.  Transient read failures (NFS
    blips, flaky disks) retry under the shared I/O policy; a truly
    truncated or undecodable file still raises after the attempts are
    spent."""
    return DEFAULT_IO_RETRY.call(_decode_once, path, sample_shape)


def scan_image_tree(data_dir: str) -> tuple[list, list, list]:
    """``data_dir/<class_name>/*.png`` -> (paths, labels, class_names);
    both levels sorted for determinism (reference: FileImageLoader scans
    with glob patterns; labels come from the directory names)."""
    class_names = sorted(
        d for d in os.listdir(data_dir)
        if os.path.isdir(os.path.join(data_dir, d)))
    if not class_names:
        raise FileNotFoundError(f"no class subdirectories in {data_dir}")
    paths, labels = [], []
    for label, name in enumerate(class_names):
        sub = os.path.join(data_dir, name)
        for fname in sorted(os.listdir(sub)):
            if fname.lower().endswith(IMAGE_EXTS):
                paths.append(os.path.join(sub, fname))
                labels.append(label)
    if not paths:
        raise FileNotFoundError(f"no image files under {data_dir}")
    return paths, labels, class_names


def synthesize_image_dataset(data_dir: str, n_classes: int = 8,
                             n_per_class: int = 24,
                             size: tuple = (32, 32)) -> None:
    """Write a seeded directory-per-class PNG tree once.  Each class is a
    smooth random pattern (low-frequency, so conv stacks can learn it)
    plus per-image noise/brightness jitter.  Fixed private seed: the
    files are the reference's, whatever the global prng state."""
    from PIL import Image

    gen = np.random.default_rng(1234602)
    h, w = size
    ch, cw = max(2, h // 4), max(2, w // 4)
    for cls in range(n_classes):
        sub = os.path.join(data_dir, f"class_{cls:03d}")
        os.makedirs(sub, exist_ok=True)
        coarse = gen.normal(0.0, 1.0, (ch, cw, 3)).astype(np.float32)
        mean = np.kron(coarse, np.ones((-(-h // ch), -(-w // cw), 1),
                                       np.float32))[:h, :w, :]
        mean = (mean - mean.min()) / max(float(mean.max() - mean.min()),
                                         1e-6)
        for i in range(n_per_class):
            img = mean * gen.uniform(0.55, 1.0) + \
                gen.normal(0.0, 0.10, mean.shape).astype(np.float32)
            arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(sub, f"{i:04d}.png"))
    # completion marker, written LAST: its presence certifies the whole
    # tree (ensure_image_tree keys regeneration off it)
    with open(os.path.join(data_dir, ".synth_version"), "w") as f:
        f.write(SYNTH_VERSION)


def ensure_image_tree(data_dir: str, **synth_kwargs) -> str:
    """Return ``data_dir``, synthesizing the stand-in tree when needed.

    Regeneration contract (shared with the mnist and cifar loaders): a
    missing or empty directory is synthesized into a temp sibling and
    renamed into place (a torn synthesis never becomes visible); a tree
    carrying a stale ``.synth_version`` marker is rebuilt; a non-empty
    tree WITHOUT the marker is user data and is never touched."""
    vfile = os.path.join(data_dir, ".synth_version")

    def _current() -> bool:
        if not (os.path.isdir(data_dir) and os.listdir(data_dir)):
            return False
        if not os.path.exists(vfile):
            return True                           # user-supplied tree
        with open(vfile) as f:
            return f.read().strip() == SYNTH_VERSION

    if _current():
        return data_dir
    if os.path.isdir(data_dir) and os.listdir(data_dir):
        # stale recipe: rebuild.  A concurrent rebuilder may be deleting
        # or replacing the same tree — tolerate the shared deletion and
        # re-check: if a winner already installed a current tree, use it
        shutil.rmtree(data_dir, ignore_errors=True)
        if _current():
            return data_dir
    tmp = data_dir.rstrip("/\\") + f".tmp{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    synthesize_image_dataset(tmp, **synth_kwargs)
    try:
        if os.path.isdir(data_dir):               # empty dir from makedirs
            os.rmdir(data_dir)
        os.replace(tmp, data_dir)
    except OSError:
        # lost a synthesis race: another process renamed its tree into
        # place first (rmdir ENOTEMPTY / replace over a populated dir).
        # Use the winner's tree if it validates; drop our tmp either way.
        shutil.rmtree(tmp, ignore_errors=True)
        if not _current():
            raise
    return data_dir


@register_loader("file_image")
class FileImageLoader(NormalizerStateMixin, Loader):
    """Streaming directory-per-class image loader.

    ``valid_fraction`` of each class (deterministic seeded split) serves as
    the VALID class; set ``test_fraction`` for a TEST split too.  The
    normalizer is fitted once on up to ``fit_samples`` train images.

    Augmentation (reference: ImageLoader's mirror/crop options):
    ``mirror=True`` flips each TRAIN sample horizontally with p=0.5
    (seeded through the ``loader_augment`` stream: runs are
    reproducible); ``crop=(ch, cw)`` serves a window of the decoded
    image — random position on TRAIN, center on VALID/TEST — so the
    served sample shape becomes ``(ch, cw, c)``.  Augmenting loaders are
    excluded from the fused step's device pinning (the per-minibatch
    serve is data-dependent).
    """

    def __init__(self, workflow=None, data_dir: str = "",
                 sample_shape=(32, 32, 3), valid_fraction: float = 0.15,
                 test_fraction: float = 0.0,
                 normalization_type: str = "mean_disp",
                 fit_samples: int = 256, mirror: bool = False,
                 crop: tuple | None = None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.data_dir = data_dir
        self.sample_shape = tuple(sample_shape)
        self.valid_fraction = valid_fraction
        self.test_fraction = test_fraction
        self.normalizer = normalizer_factory(normalization_type)
        self.fit_samples = fit_samples
        self.mirror = bool(mirror)
        self.crop = None if crop is None else tuple(crop)
        if self.crop is not None and (
                self.crop[0] > self.sample_shape[0] or
                self.crop[1] > self.sample_shape[1]):
            raise ValueError(f"crop {self.crop} exceeds decoded sample "
                             f"{self.sample_shape[:2]}")
        self.class_names: list[str] = []
        self._paths: list[str] = []     # [test | valid | train] order
        self._labels: np.ndarray | None = None

    @property
    def augmenting(self) -> bool:
        """True when per-minibatch serves are data-dependent (the fused
        step must not bypass fill_minibatch with a pinned dataset)."""
        return self.mirror or self.crop is not None

    @property
    def served_shape(self) -> tuple:
        """Shape of one SERVED sample (crop applied)."""
        if self.crop is None:
            return self.sample_shape
        return (self.crop[0], self.crop[1], self.sample_shape[2])

    def _augment(self, batch: np.ndarray, train: bool) -> np.ndarray:
        """Mirror/crop a decoded (n, H, W, C) batch -> (n, ch, cw, C).
        Seeded stream: same seed => same augmentation sequence."""
        if not self.augmenting:
            return batch
        gen = prng.get("loader_augment")
        n, h, w, _c = batch.shape
        if self.crop is not None:
            ch, cw = self.crop
            out = np.empty((n, ch, cw, batch.shape[3]), batch.dtype)
            if train:
                oys = gen.randint(0, h - ch + 1, n)
                oxs = gen.randint(0, w - cw + 1, n)
            else:
                oys = np.full(n, (h - ch) // 2)
                oxs = np.full(n, (w - cw) // 2)
            for i in range(n):
                out[i] = batch[i, oys[i]:oys[i] + ch, oxs[i]:oxs[i] + cw]
            batch = out
        if self.mirror and train:
            flips = gen.uniform(0.0, 1.0, n) < 0.5
            batch[flips] = batch[flips, :, ::-1]
        return batch

    @property
    def n_classes(self) -> int:
        return len(self.class_names)

    def load_data(self) -> None:
        paths, labels, self.class_names = scan_image_tree(self.data_dir)
        # deterministic per-class split (reference: validation_ratio)
        gen = prng.get("loader_split")
        by_class: dict[int, list[int]] = {}
        for i, lab in enumerate(labels):
            by_class.setdefault(lab, []).append(i)
        split: dict[int, list[int]] = {TEST: [], VALID: [], TRAIN: []}
        for lab in sorted(by_class):
            idx = np.array(by_class[lab])
            gen.shuffle(idx)
            n = len(idx)
            n_test = int(n * self.test_fraction)
            n_valid = int(n * self.valid_fraction)
            split[TEST] += list(idx[:n_test])
            split[VALID] += list(idx[n_test:n_test + n_valid])
            split[TRAIN] += list(idx[n_test + n_valid:])
        order = split[TEST] + split[VALID] + split[TRAIN]
        self._paths = [paths[i] for i in order]
        self._labels = np.array([labels[i] for i in order], np.int32)
        self.class_lengths = [len(split[TEST]), len(split[VALID]),
                              len(split[TRAIN])]
        if not self.normalizer.fitted:
            train0 = self.class_offset(TRAIN)
            k = min(self.fit_samples, self.class_lengths[TRAIN])
            # evenly spaced over the (shuffled) train list; fitted on the
            # SERVED geometry (center crop) — mean_disp stats are
            # per-feature, so crop-then-normalize keeps them aligned
            pick = train0 + np.linspace(
                0, self.class_lengths[TRAIN] - 1, k).astype(int)
            sample = np.stack([
                _decode(self._paths[i], self.sample_shape) for i in pick])
            self.normalizer.analyze(self._augment(sample, train=False))

    def create_minibatch_data(self) -> None:
        self.minibatch_data.reset(
            shape=(self.max_minibatch_size,) + self.served_shape,
            dtype=np.float32)
        self.minibatch_labels.reset(
            shape=(self.max_minibatch_size,), dtype=np.int32)

    def _serve_rows(self, indices: np.ndarray, count: int, train: bool,
                    data: np.ndarray) -> None:
        """Decode, augment and normalize the rows ``indices[:count]`` into
        ``data[:count]`` and zero the padding rows."""
        raw = np.zeros((count,) + self.sample_shape, np.float32)
        for row, idx in enumerate(indices[:count]):
            raw[row] = _decode(self._paths[idx], self.sample_shape)
        data[:count] = self.normalizer.normalize(self._augment(raw, train))
        data[count:] = 0

    def _labels_of(self, indices: np.ndarray, count: int,
                   labels: np.ndarray) -> np.ndarray:
        labels[:count] = self._labels[indices[:count]]
        labels[count:] = 0
        return labels

    def fill_minibatch(self) -> None:
        indices = self.minibatch_indices.mem
        count = self.minibatch_size
        # fresh buffers every serve: a consumer may still read the last
        data = np.empty((self.max_minibatch_size,) + self.served_shape,
                        np.float32)
        self._serve_rows(indices, count,
                         int(self.minibatch_class) == TRAIN, data)
        self.minibatch_data.mem = data
        self.minibatch_labels.mem = self._labels_of(
            indices, count, np.empty((self.max_minibatch_size,), np.int32))

    def fill_batch(self, indices: np.ndarray, count: int, cls: int) -> dict:
        """The prefetch producer's fill: what :meth:`fill_minibatch` serves,
        into the staging ring's buffers."""
        data = self._next_buffer(
            "data", (self.max_minibatch_size,) + self.served_shape,
            np.float32)
        self._serve_rows(indices, count, int(cls) == TRAIN, data)
        labels = self._next_buffer("labels", (self.max_minibatch_size,),
                                   np.int32)
        return {"data": data,
                "labels": self._labels_of(indices, count, labels)}


@register_loader("full_batch_image")
class FullBatchImageLoader(FileImageLoader):
    """Directory-per-class loader that materializes the whole decoded
    dataset in host memory at load time (reference:
    FullBatchImageLoader): RAM for no per-minibatch decode.  The dataset
    lives in ``original_data``/``original_labels`` Arrays (the
    FullBatchLoader contract), so the fused step pins it on the device
    and the hot loop serves indices only."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.original_data = Array()
        self.original_labels = Array()

    def load_data(self) -> None:
        super().load_data()
        decoded = np.stack([_decode(p, self.sample_shape)
                            for p in self._paths])
        if self.augmenting:
            # augmentation is per-serve: keep the RAW decoded dataset and
            # crop+normalize in fill_minibatch (the pre-normalized device
            # pinning does not apply — see ``augmenting``)
            self.original_data.mem = decoded
        else:
            self.original_data.mem = self.normalizer.normalize(decoded)
        self.original_labels.mem = np.asarray(self._labels, np.int32)

    def _renormalize_served_data(self) -> None:
        # restore swapped the normalizer in: re-decode from disk (the
        # tree is still there) instead of keeping a second in-RAM copy
        if self.augmenting:
            return                    # dataset is stored raw: nothing to redo
        self.original_data.map_invalidate()
        self.original_data.mem = self.normalizer.normalize(np.stack([
            _decode(p, self.sample_shape) for p in self._paths]))

    def served_dataset(self):
        """The deterministic eval view (FullBatchLoader contract): when
        augmenting, the stored dataset is RAW — center-crop + normalize
        it the way a non-train serve would."""
        data = self.original_data.map_read()
        if self.augmenting:
            data = self.normalizer.normalize(self._augment(
                np.ascontiguousarray(data), train=False))
        return data, self.original_labels.map_read()

    def _serve_rows(self, indices: np.ndarray, count: int, train: bool,
                    data: np.ndarray) -> None:
        if not self.augmenting:
            _gather(self.original_data.mem, indices, count, data)
            return
        batch = self.original_data.mem[indices[:count]]
        data[:count] = self.normalizer.normalize(self._augment(
            np.ascontiguousarray(batch), train))
        data[count:] = 0
