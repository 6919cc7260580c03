"""DataSet and MultiDataSet containers (counterpart of
`deeplearning4j_tpu/datasets/dataset.py`).

Features, labels and their masks, kept as host numpy arrays; the network
moves each batch to its device when it trains on it. `shuffle(seed)`
draws the JAX package's permutation (`np.random.default_rng(seed)`), and
`save`/`load` write and read its npz file, so either package reads the
other's files and orders a shuffled set the same way.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

_FIELDS = ("features", "labels", "features_mask", "labels_mask")


def _sl(a, lo, hi):
    return None if a is None else a[lo:hi]


@dataclass
class DataSet:
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def _rows(self, lo, hi) -> "DataSet":
        return DataSet(*(_sl(getattr(self, f), lo, hi) for f in _FIELDS))

    def split_test_and_train(self, n_train: int
                             ) -> Tuple["DataSet", "DataSet"]:
        """(the first `n_train` examples, the rest)."""
        return self._rows(0, n_train), self._rows(n_train,
                                                  self.num_examples())

    def shuffle(self, seed: Optional[int] = None) -> None:
        """Reorder the examples in place by
        `np.random.default_rng(seed).permutation`."""
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        for f in _FIELDS:
            a = getattr(self, f)
            if a is not None:
                setattr(self, f, a[idx])

    def save(self, path) -> None:
        """Write this DataSet to one npz file: the arrays keep their dtype
        and shape; absent labels and masks are left out. `.npz` is added
        to a path without it, as `load` does."""
        arrays = {f: getattr(self, f) for f in _FIELDS
                  if getattr(self, f) is not None}
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, **arrays)

    @staticmethod
    def load(path) -> "DataSet":
        """Read a DataSet written by `save` (by either package)."""
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=False) as z:
            return DataSet(*(z[f] if f in z else None for f in _FIELDS))

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        """Consecutive batches of `batch_size` rows (the last may be
        shorter)."""
        return [self._rows(lo, lo + batch_size)
                for lo in range(0, self.num_examples(), batch_size)]

    @staticmethod
    def merge(sets: Sequence["DataSet"]) -> "DataSet":
        """The sets' examples in order, in one DataSet. Labels are kept
        only when every set has them; where some sets have a mask and
        others not, the missing masks are filled with ones (all valid)."""
        def cat(xs):
            if any(x is None for x in xs):
                return None
            return np.concatenate(xs, axis=0)

        def cat_masks(masks, refs):
            if all(m is None for m in masks):
                return None
            filled = [m if m is not None
                      else np.ones(r.shape[:2], np.float32)
                      for m, r in zip(masks, refs)]
            return np.concatenate(filled, axis=0)

        return DataSet(
            np.concatenate([d.features for d in sets], axis=0),
            cat([d.labels for d in sets]),
            cat_masks([d.features_mask for d in sets],
                      [d.features for d in sets]),
            cat_masks([d.labels_mask for d in sets],
                      [d.labels if d.labels is not None else d.features
                       for d in sets]),
        )


@dataclass
class MultiDataSet:
    """Several input and output arrays (for a ComputationGraph)."""

    features: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
