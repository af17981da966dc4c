"""Fitted dataset-feature normalizers — the port's copy of
``znicz_tpu/loader/normalization.py`` (numpy only; rebuild of
veles/normalization.py :: NormalizerRegistry: linear / mean_disp / exp /
pointwise / none).

Reference semantics: a normalizer is a small picklable object that is
*fitted* on the training data once (``analyze``) and then applied to any
batch (``normalize``); loaders own one and snapshot it with the workflow so
inference sees identical preprocessing.  Fitted state is plain numpy in
instance attributes — pickling just works, matching the reference's
pickle-the-loader snapshot path.

Normalization runs host-side in the loader (the reference's placement);
the arrays it produces are what the fused step uploads or pins.
"""

from __future__ import annotations

import numpy as np

#: name -> class registry (reference: NormalizerRegistry metaclass MAPPING)
NORMALIZER_REGISTRY: dict[str, type] = {}


def register_normalizer(name: str):
    def deco(cls):
        NORMALIZER_REGISTRY[name] = cls
        cls.NAME = name
        return cls
    return deco


def normalizer_factory(name: str, **kwargs) -> "NormalizerBase":
    """Instantiate by registry name (reference: NormalizerRegistry)."""
    try:
        return NORMALIZER_REGISTRY[name](**kwargs)
    except KeyError:
        raise KeyError(f"unknown normalizer {name!r}; registered: "
                       f"{sorted(NORMALIZER_REGISTRY)}") from None


class NormalizerBase:
    """fit-once / apply-many feature scaler."""

    def __init__(self, **kwargs) -> None:
        self._fitted = False

    @property
    def fitted(self) -> bool:
        return self._fitted

    def analyze(self, data: np.ndarray) -> "NormalizerBase":
        """Fit on (N, ...) training data; idempotent refits overwrite."""
        self._analyze(np.asarray(data))
        self._fitted = True
        return self

    def normalize(self, data: np.ndarray) -> np.ndarray:
        """Return the scaled copy of (N, ...) data (reference normalizes
        in place; a fresh array is returned here because served minibatch
        buffers are immutable-once-dispatched on the async TPU path)."""
        if not self._fitted:
            raise RuntimeError(f"{type(self).__name__} not fitted; "
                               "call analyze() first")
        return self._apply(np.asarray(data, np.float32))

    def denormalize(self, data: np.ndarray) -> np.ndarray:
        if not self._fitted:
            raise RuntimeError(f"{type(self).__name__} not fitted")
        return self._reverse(np.asarray(data, np.float32))

    # override points
    def _analyze(self, data: np.ndarray) -> None:
        raise NotImplementedError

    def _apply(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _reverse(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- snapshot support ---------------------------------------------------
    def state_dict(self) -> tuple[dict, dict]:
        """-> (meta, arrays): JSON-able metadata + numpy fit state, split
        so the snapshotter stores arrays in the .npz payload and meta in
        the JSON header (the reference pickles the whole object; the
        array-based snapshot format cannot)."""
        meta: dict = {"type": self.NAME}
        arrays: dict = {}
        for k, v in vars(self).items():
            if isinstance(v, np.ndarray):
                arrays[k] = v
            elif isinstance(v, NormalizerBase):
                sub_meta, sub_arrays = v.state_dict()
                meta[f"sub:{k}"] = sub_meta
                arrays.update({f"{k}.{sk}": sv
                               for sk, sv in sub_arrays.items()})
            elif isinstance(v, tuple):
                meta[f"attr:{k}"] = list(v)
            else:
                meta[f"attr:{k}"] = v
        return meta, arrays


class NormalizerStateMixin:
    """state_dict/load_state_dict plumbing shared by every loader that
    owns a fitted ``self.normalizer`` (mix in BEFORE the loader base).

    On restore, :meth:`_renormalize_served_data` re-derives any data the
    loader pre-normalized at load time — full-batch loaders re-read the
    raw bytes from disk rather than holding a second in-RAM copy of the
    dataset for the rare restore path."""

    def state_dict(self) -> dict:
        state = super().state_dict()
        meta, arrays = self.normalizer.state_dict()
        state["normalizer"] = {"meta": meta, "arrays": arrays}
        return state

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        if "normalizer" in state:
            self.normalizer = normalizer_from_state(
                state["normalizer"]["meta"], state["normalizer"]["arrays"])
            self._renormalize_served_data()

    def _renormalize_served_data(self) -> None:
        """Re-apply the (restored) normalizer to pre-normalized data;
        streaming loaders that normalize per minibatch need nothing."""


def normalizer_from_state(meta: dict, arrays: dict) -> "NormalizerBase":
    """Rebuild a fitted normalizer from :meth:`NormalizerBase.state_dict`
    output."""
    norm = normalizer_factory(meta["type"])
    for key, v in meta.items():
        if key.startswith("attr:"):
            setattr(norm, key[5:], tuple(v) if isinstance(v, list) else v)
        elif key.startswith("sub:"):
            name = key[4:]
            sub_arrays = {k[len(name) + 1:]: a for k, a in arrays.items()
                          if k.startswith(name + ".")}
            setattr(norm, name, normalizer_from_state(v, sub_arrays))
    for k, a in arrays.items():
        if "." not in k:
            setattr(norm, k, np.asarray(a))
    return norm


@register_normalizer("none")
class NoneNormalizer(NormalizerBase):
    """Identity (reference: "none")."""

    def _analyze(self, data) -> None:
        pass

    def _apply(self, data):
        return data

    def _reverse(self, data):
        return data


@register_normalizer("linear")
class LinearNormalizer(NormalizerBase):
    """Global min/max -> [-1, 1] (reference: "linear")."""

    def __init__(self, interval=(-1.0, 1.0), **kwargs) -> None:
        super().__init__(**kwargs)
        self.interval = tuple(interval)
        self.vmin = self.vmax = None

    def _analyze(self, data) -> None:
        self.vmin = float(data.min())
        self.vmax = float(data.max())

    def _scale(self):
        lo, hi = self.interval
        spread = self.vmax - self.vmin
        return (hi - lo) / spread if spread > 0 else 1.0, lo

    def _apply(self, data):
        k, lo = self._scale()
        return (data - self.vmin) * k + lo

    def _reverse(self, data):
        k, lo = self._scale()
        return (data - lo) / k + self.vmin


@register_normalizer("pointwise")
class PointwiseNormalizer(NormalizerBase):
    """Per-feature min/max -> [-1, 1] (reference: "pointwise").

    Features where min == max map to the interval midpoint.
    """

    def __init__(self, interval=(-1.0, 1.0), **kwargs) -> None:
        super().__init__(**kwargs)
        self.interval = tuple(interval)
        self.vmin = self.vmax = None

    def _analyze(self, data) -> None:
        self.vmin = data.min(axis=0).astype(np.float32)
        self.vmax = data.max(axis=0).astype(np.float32)

    def _apply(self, data):
        lo, hi = self.interval
        spread = self.vmax - self.vmin
        k = np.where(spread > 0, (hi - lo) / np.where(spread > 0, spread, 1),
                     0.0).astype(np.float32)
        mid = 0.5 * (lo + hi)
        out = (data - self.vmin) * k + lo
        return np.where(spread > 0, out, mid).astype(np.float32)

    def _reverse(self, data):
        lo, hi = self.interval
        spread = self.vmax - self.vmin
        k = np.where(spread > 0, (hi - lo) / np.where(spread > 0, spread, 1),
                     1.0).astype(np.float32)
        return ((data - lo) / k + self.vmin).astype(np.float32)


@register_normalizer("mean_disp")
class MeanDispNormalizer(NormalizerBase):
    """(x - mean) / (max - min) per feature (reference: "mean_disp" —
    the ImageNet pipeline scaler; the *unit* of the same name applies the
    on-device version inside the graph)."""

    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self.mean = self.disp = None

    def _analyze(self, data) -> None:
        self.mean = data.mean(axis=0).astype(np.float32)
        disp = (data.max(axis=0) - data.min(axis=0)).astype(np.float32)
        self.disp = np.where(disp > 0, disp, 1.0).astype(np.float32)

    def _apply(self, data):
        return ((data - self.mean) / self.disp).astype(np.float32)

    def _reverse(self, data):
        return (data * self.disp + self.mean).astype(np.float32)


@register_normalizer("exp")
class ExponentNormalizer(NormalizerBase):
    """Linear fit to [-1, 1] then sigmoid squash into (0, 1)
    (reference: "exp" — bounded smooth scaling for heavy-tailed features)."""

    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self.linear = LinearNormalizer()

    @property
    def fitted(self) -> bool:
        return self.linear.fitted

    def _analyze(self, data) -> None:
        self.linear.analyze(data)

    def _apply(self, data):
        x = self.linear._apply(data)
        return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)

    def _reverse(self, data):
        x = np.log(data / (1.0 - data))
        return self.linear._reverse(x)


@register_normalizer("external_mean")
class ExternalMeanNormalizer(NormalizerBase):
    """Subtract a supplied mean array (reference: "external_mean" — the
    AlexNet workflow ships a precomputed ImageNet mean image)."""

    def __init__(self, mean=None, **kwargs) -> None:
        super().__init__(**kwargs)
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        if self.mean is not None:
            self._fitted = True

    def _analyze(self, data) -> None:
        if self.mean is None:
            self.mean = data.mean(axis=0).astype(np.float32)

    def _apply(self, data):
        return (data - self.mean).astype(np.float32)

    def _reverse(self, data):
        return (data + self.mean).astype(np.float32)
