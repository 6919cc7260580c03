"""Device-side data normalizers (counterpart of
`deeplearning4j_tpu/datasets/normalizers.py`, reduced to what the
char-RNN path needs).

`OneHotEncoder(n_classes)` expands integer category ids, (B,) or (B, T),
into one-hot rows on the device, so a char-RNN batch crosses to the card
as one byte per character. Attach it with
`MultiLayerNetwork.set_normalizer`. Its serialized form (`to_bytes`, the
`normalizer.bin` of a checkpoint) is the JAX package's. The statistics
normalizers (`NormalizerStandardize`, `NormalizerMinMaxScaler`,
`ImagePreProcessingScaler`) are not ported (ROADMAP queue A14).
"""
from __future__ import annotations

import io
import json

import numpy as np
import torch
import torch.nn.functional as F

NOT_PORTED = "is not ported yet (ROADMAP queue A14: data)"


def _iter_batches(data):
    if hasattr(data, "features"):
        yield data
        return
    yield from data


class DataNormalization:
    """Base of the normalizers: `fit(data)`, then a transform."""

    KIND = "base"
    # True for transforms that consume raw integer ids: the input prep
    # hands them int ids instead of casting to the model's float type
    consumes_integer_ids = False
    supports_device = False

    def fit(self, data) -> "DataNormalization":
        raise NotImplementedError

    def device_transform(self, features: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} has no device-side transform")

    def check_device_attachable(self) -> None:
        if not self.supports_device:
            raise ValueError(f"{type(self).__name__} has no device-side "
                             "transform; apply it on the host")

    def _meta(self) -> dict:
        return {}

    def to_bytes(self) -> bytes:
        """The JAX package's `normalizer.bin` payload (an npz holding the
        kind and the constructor arguments)."""
        buf = io.BytesIO()
        np.savez(buf, __kind__=np.frombuffer(
            json.dumps({"kind": self.KIND, **self._meta()}).encode(),
            np.uint8))
        return buf.getvalue()

    @staticmethod
    def from_bytes(b: bytes) -> "DataNormalization":
        data = np.load(io.BytesIO(b))
        meta = json.loads(bytes(data["__kind__"]).decode())
        kind = meta.pop("kind")
        if kind != OneHotEncoder.KIND or len(data.files) > 1:
            raise NotImplementedError(f"normalizer kind {kind!r} {NOT_PORTED}")
        return OneHotEncoder(**meta)


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

    def check_ids(self, ids) -> None:
        """Raise on an id outside [0, n_classes): the one-hot expansion
        would otherwise fail on the device (or, in the JAX package, give
        a zero row)."""
        if isinstance(ids, torch.Tensor):
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

    def device_transform(self, features: torch.Tensor) -> torch.Tensor:
        if self.n_classes <= 0:
            raise ValueError("OneHotEncoder needs n_classes (set it or fit)")
        out = features.dtype if features.is_floating_point() \
            else torch.float32
        return F.one_hot(features.long(), self.n_classes).to(out)
