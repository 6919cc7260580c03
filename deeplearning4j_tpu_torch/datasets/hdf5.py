"""HDF5-backed mini-batch iterator.

Reference: `deeplearning4j-keras/.../HDF5MiniBatchDataSetIterator.java`
(SURVEY §2.8) — the Keras-backend gateway streams batches from HDF5 files.
Two layouts are supported:
- one dataset pair (`features`, `labels`): sliced into mini-batches;
- the reference's directory layout: groups/datasets named per batch
  (`features_0`, `labels_0`, ...), one DataSet per pair.

Counterpart of `deeplearning4j_tpu/datasets/hdf5.py`:
host code, a copy of the JAX package's with the port's imports; it gives
the same results.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


class HDF5MiniBatchDataSetIterator(DataSetIterator):
    def __init__(self, path: Union[str, Path], batch_size: int = 32,
                 features_key: str = "features", labels_key: str = "labels"):
        try:
            import h5py
        except ImportError as e:  # pragma: no cover - h5py is in this image
            raise ImportError(
                "HDF5MiniBatchDataSetIterator requires h5py") from e
        self._h5py = h5py
        self.path = str(path)
        self.batch_size = batch_size
        self.features_key = features_key
        self.labels_key = labels_key
        with h5py.File(self.path, "r") as f:
            if features_key in f:
                self._mode = "sliced"
                self._n = f[features_key].shape[0]
                self._batch_names: List[str] = []
            else:
                self._mode = "per_batch"
                self._batch_names = sorted(
                    (k for k in f.keys() if k.startswith(f"{features_key}_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
                if not self._batch_names:
                    raise ValueError(
                        f"{self.path}: no '{features_key}' dataset and no "
                        f"'{features_key}_N' batch datasets found")
                self._n = len(self._batch_names)
        self._pos = 0

    def reset(self) -> None:
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < self._n

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        with self._h5py.File(self.path, "r") as f:
            if self._mode == "sliced":
                lo = self._pos
                hi = min(lo + self.batch_size, self._n)
                self._pos = hi
                feats = np.asarray(f[self.features_key][lo:hi], np.float32)
                labels = (np.asarray(f[self.labels_key][lo:hi], np.float32)
                          if self.labels_key in f else None)
                return DataSet(feats, labels)
            name = self._batch_names[self._pos]
            idx = name.rsplit("_", 1)[1]
            self._pos += 1
            feats = np.asarray(f[name], np.float32)
            lname = f"{self.labels_key}_{idx}"
            labels = (np.asarray(f[lname], np.float32) if lname in f else None)
            return DataSet(feats, labels)

    def batch(self) -> int:
        return self.batch_size
