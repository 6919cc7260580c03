"""Data normalizers (counterpart of
`deeplearning4j_tpu/datasets/normalizers.py`).

`NormalizerStandardize`, `NormalizerMinMaxScaler` and
`ImagePreProcessingScaler` fit their statistics on the host in f64 and
apply them on the host (`transform`, `revert_*`) or, attached with
`MultiLayerNetwork.set_normalizer`, on the device (`device_transform`,
torch ops on the features' device). `OneHotEncoder(n_classes)` expands
integer category ids, (B,) or (B, T), into one-hot rows on the device, so
a char-RNN batch crosses to the card as one byte per character.

The serialized form (`to_bytes`, the `normalizer.bin` of a checkpoint) is
the JAX package's: an npz holding the kind and the constructor arguments
as JSON, then the statistics arrays; the kinds are looked up in one
registry under the JAX package's names, so either package restores what
the other wrote.
"""
from __future__ import annotations

import io
import json
import logging
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger("deeplearning4j_tpu_torch")

_NORMALIZER_REGISTRY = {}


def register_normalizer(cls):
    _NORMALIZER_REGISTRY[cls.KIND] = cls
    return cls


def _iter_batches(data):
    """The batches of a DataSet or of an iterator (rewound before and
    after)."""
    if hasattr(data, "features"):
        yield data
        return
    data.reset()
    yield from data
    data.reset()


def _rows(a, dtype) -> np.ndarray:
    """`a` (numpy or a tensor) as a host array of `dtype`, one row per
    example."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a, dtype)
    return a.reshape(a.shape[0], -1)


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A statistics array as a tensor on `like`'s device."""
    return torch.as_tensor(a, device=like.device)


class DataNormalization:
    """Base of the normalizers: `fit(data)`, then a transform."""

    KIND = "base"
    # True for transforms that consume raw integer ids: the input prep
    # hands them int ids instead of casting to the model's float type
    consumes_integer_ids = False
    supports_device = False

    def fit(self, data) -> "DataNormalization":
        raise NotImplementedError

    def transform(self, ds):
        raise NotImplementedError

    def revert_features(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def pre_process(self, ds):
        return self.transform(ds)

    def __call__(self, ds):
        return self.transform(ds)

    def device_transform(self, features: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} has no device-side transform; apply it "
            "on the host with transform()/pre_process()")

    def check_device_attachable(self) -> None:
        """Raise unless the whole transform can run on the device."""
        if not self.supports_device:
            raise ValueError(
                f"{type(self).__name__} has no device-side transform; "
                "apply it on the host with transform()/pre_process()")

    def _arrays(self) -> dict:
        return {}

    def _meta(self) -> dict:
        return {}

    def to_bytes(self) -> bytes:
        """The `normalizer.bin` payload."""
        buf = io.BytesIO()
        arrays = {k: v for k, v in self._arrays().items() if v is not None}
        np.savez(buf, __kind__=np.frombuffer(
            json.dumps({"kind": self.KIND, **self._meta()}).encode(),
            np.uint8), **arrays)
        return buf.getvalue()

    @staticmethod
    def from_bytes(b: bytes) -> "DataNormalization":
        data = np.load(io.BytesIO(b))
        meta = json.loads(bytes(data["__kind__"]).decode())
        kind = meta.pop("kind")
        if kind not in _NORMALIZER_REGISTRY:
            raise ValueError(f"unknown normalizer kind {kind!r}")
        obj = _NORMALIZER_REGISTRY[kind](**meta)
        for k in data.files:
            if k != "__kind__":
                setattr(obj, k, data[k])
        return obj


@register_normalizer
class NormalizerStandardize(DataNormalization):
    """Zero mean and unit variance per feature column, optionally also
    per label column (regression)."""

    KIND = "standardize"
    supports_device = True

    def __init__(self, fit_label: bool = False):
        self.fit_label = bool(fit_label)
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.label_mean: Optional[np.ndarray] = None
        self.label_std: Optional[np.ndarray] = None

    def _meta(self):
        return {"fit_label": self.fit_label}

    def _arrays(self):
        return {"mean": self.mean, "std": self.std,
                "label_mean": self.label_mean, "label_std": self.label_std}

    def fit(self, data):
        """Column sums and sums of squares in f64 over every batch."""
        n = 0
        s = ss = ls = lss = None
        for ds in _iter_batches(data):
            f = _rows(ds.features, np.float64)
            if s is None:
                s, ss = f.sum(0), (f ** 2).sum(0)
            else:
                s += f.sum(0)
                ss += (f ** 2).sum(0)
            if self.fit_label:
                lab = _rows(ds.labels, np.float64)
                if ls is None:
                    ls, lss = lab.sum(0), (lab ** 2).sum(0)
                else:
                    ls += lab.sum(0)
                    lss += (lab ** 2).sum(0)
            n += f.shape[0]
        if n == 0:
            raise ValueError("NormalizerStandardize.fit: no data")
        self.mean = (s / n).astype(np.float32)
        self.std = self._guarded_std(ss, s, n, "feature")
        if self.fit_label:
            self.label_mean = (ls / n).astype(np.float32)
            self.label_std = self._guarded_std(lss, ls, n, "label")
        return self

    @staticmethod
    def _guarded_std(ss, s, n, what: str) -> np.ndarray:
        """Per-column std; a constant column (std 0, which would divide
        to NaN/Inf) gets std 1, so it maps to exactly 0, with a warning."""
        var = np.maximum(ss / n - (s / n) ** 2, 0.0)
        std = np.sqrt(var).astype(np.float32)
        zero = var <= 1e-12
        if zero.any():
            logger.warning(
                "NormalizerStandardize: %d zero-variance %s column(s) "
                "(std == 0 would divide to NaN/Inf); clamping std to 1.0 "
                "for columns %s", int(zero.sum()), what,
                np.flatnonzero(zero)[:16].tolist())
            std = np.where(zero, np.float32(1.0), std).astype(np.float32)
        return std

    def transform(self, ds):
        if self.mean is None:
            raise ValueError("normalizer not fitted")
        shp = ds.features.shape
        f = _rows(ds.features, np.float32)
        ds.features = ((f - self.mean) / self.std).reshape(shp)
        if self.fit_label and self.label_mean is not None:
            lshp = ds.labels.shape
            lab = _rows(ds.labels, np.float32)
            ds.labels = ((lab - self.label_mean)
                         / self.label_std).reshape(lshp)
        return ds

    def revert_features(self, features: np.ndarray) -> np.ndarray:
        shp = np.shape(features)
        f = _rows(features, np.float32)
        return (f * self.std + self.mean).reshape(shp)

    def revert_labels(self, labels: np.ndarray) -> np.ndarray:
        if not self.fit_label:
            return labels
        shp = np.shape(labels)
        lab = _rows(labels, np.float32)
        return (lab * self.label_std + self.label_mean).reshape(shp)

    def device_transform(self, features: torch.Tensor) -> torch.Tensor:
        if self.mean is None:
            raise ValueError("normalizer not fitted")
        shp = features.shape
        f = features.reshape(shp[0], -1)
        return ((f - _on(self.mean, f)) / _on(self.std, f)).reshape(shp)

    def check_device_attachable(self) -> None:
        if self.fit_label:
            raise ValueError(
                "NormalizerStandardize(fit_label=True) cannot run on the "
                "device: device_transform covers only the features, so the "
                "label standardization would be silently dropped; "
                "normalize labels on the host with transform()/"
                "pre_process() instead")
        super().check_device_attachable()


@register_normalizer
class NormalizerMinMaxScaler(DataNormalization):
    """Each feature column scaled to [min_range, max_range]."""

    KIND = "minmax"
    supports_device = True

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.fmin: Optional[np.ndarray] = None
        self.fmax: Optional[np.ndarray] = None

    def _meta(self):
        return {"min_range": self.min_range, "max_range": self.max_range}

    def _arrays(self):
        return {"fmin": self.fmin, "fmax": self.fmax}

    def fit(self, data):
        fmin = fmax = None
        for ds in _iter_batches(data):
            f = _rows(ds.features, np.float64)
            bmin, bmax = f.min(0), f.max(0)
            fmin = bmin if fmin is None else np.minimum(fmin, bmin)
            fmax = bmax if fmax is None else np.maximum(fmax, bmax)
        if fmin is None:
            raise ValueError("NormalizerMinMaxScaler.fit: no data")
        self.fmin = fmin.astype(np.float32)
        self.fmax = fmax.astype(np.float32)
        return self

    def _range(self) -> np.ndarray:
        return np.maximum(self.fmax - self.fmin, 1e-12)

    def transform(self, ds):
        if self.fmin is None:
            raise ValueError("normalizer not fitted")
        shp = ds.features.shape
        f = _rows(ds.features, np.float32)
        scaled = ((f - self.fmin) / self._range()
                  * (self.max_range - self.min_range) + self.min_range)
        ds.features = scaled.reshape(shp)
        return ds

    def revert_features(self, features: np.ndarray) -> np.ndarray:
        shp = np.shape(features)
        f = _rows(features, np.float32)
        return ((f - self.min_range) / (self.max_range - self.min_range)
                * self._range() + self.fmin).reshape(shp)

    def device_transform(self, features: torch.Tensor) -> torch.Tensor:
        if self.fmin is None:
            raise ValueError("normalizer not fitted")
        shp = features.shape
        f = features.reshape(shp[0], -1)
        scaled = ((f - _on(self.fmin, f)) / _on(self._range(), f)
                  * (self.max_range - self.min_range) + self.min_range)
        return scaled.reshape(shp)


@register_normalizer
class ImagePreProcessingScaler(DataNormalization):
    """Pixels x / max_pixel mapped to [min_range, max_range]. Stateless:
    `fit` does nothing."""

    KIND = "image_scaler"
    supports_device = True

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.max_pixel = float(max_pixel)

    def _meta(self):
        return {"min_range": self.min_range, "max_range": self.max_range,
                "max_pixel": self.max_pixel}

    def fit(self, data):
        return self

    def transform(self, ds):
        f = np.asarray(ds.features, np.float32)
        ds.features = (f / self.max_pixel
                       * (self.max_range - self.min_range) + self.min_range)
        return ds

    def revert_features(self, features: np.ndarray) -> np.ndarray:
        f = np.asarray(features, np.float32)
        return ((f - self.min_range) / (self.max_range - self.min_range)
                * self.max_pixel)

    def device_transform(self, features: torch.Tensor) -> torch.Tensor:
        return (features / self.max_pixel
                * (self.max_range - self.min_range) + self.min_range)


@register_normalizer
class OneHotEncoder(DataNormalization):
    """Integer category ids -> one-hot rows (..., n_classes) in f32."""

    KIND = "one_hot"
    consumes_integer_ids = True
    supports_device = True

    def __init__(self, n_classes: int = 0):
        self.n_classes = int(n_classes)

    def _meta(self):
        return {"n_classes": self.n_classes}

    def fit(self, data):
        """Take n_classes from the largest id seen, unless it is set."""
        if self.n_classes <= 0:
            m = 0
            for ds in _iter_batches(data):
                m = max(m, int(np.asarray(ds.features).max()))
            self.n_classes = m + 1
        return self

    def check_ids(self, ids, value_range=None) -> None:
        """Raise on an id outside [0, n_classes): the one-hot expansion
        would otherwise fail on the device (or, in the JAX package, give
        a zero row). Ids already on the card are checked against
        `value_range`, the (min, max) taken when they were staged, where
        there is one, instead of being read back."""
        if isinstance(ids, torch.Tensor):
            if ids.device.type != "cpu" and value_range is not None:
                ids = np.asarray(value_range)
            else:
                ids = ids.detach().cpu().numpy()
        ids = np.asarray(ids)
        if not ids.size:
            return
        mn, mx = int(ids.min()), int(ids.max())
        if mn < 0 or mx >= self.n_classes:
            bad = mn if mn < 0 else mx
            raise ValueError(
                f"OneHotEncoder({self.n_classes}): feature id {bad} out of "
                f"range [0, {self.n_classes})")

    def transform(self, ds):
        if self.n_classes <= 0:
            raise ValueError("OneHotEncoder needs n_classes (set it or fit)")
        ids = np.asarray(ds.features).astype(np.int64)
        self.check_ids(ids)
        ds.features = np.eye(self.n_classes, dtype=np.float32)[ids]
        return ds

    def revert_features(self, features: np.ndarray) -> np.ndarray:
        return np.argmax(np.asarray(features), axis=-1)

    def device_transform(self, features: torch.Tensor) -> torch.Tensor:
        if self.n_classes <= 0:
            raise ValueError("OneHotEncoder needs n_classes (set it or fit)")
        out = features.dtype if features.is_floating_point() \
            else torch.float32
        return F.one_hot(features.long(), self.n_classes).to(out)
