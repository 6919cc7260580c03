"""DataSet container (counterpart of `deeplearning4j_tpu/datasets/dataset.py`).

Features, labels and their masks, kept as host numpy arrays; the network
moves each batch to its device when it trains on it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class DataSet:
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        """Consecutive batches of `batch_size` rows (the last may be
        shorter)."""
        def sl(a, lo, hi):
            return None if a is None else a[lo:hi]

        n = self.num_examples()
        return [DataSet(self.features[lo:lo + batch_size],
                        sl(self.labels, lo, lo + batch_size),
                        sl(self.features_mask, lo, lo + batch_size),
                        sl(self.labels_mask, lo, lo + batch_size))
                for lo in range(0, n, batch_size)]
