"""DataSet iterators (counterpart of
`deeplearning4j_tpu/datasets/iterators.py`).

`fit` runs an iterator as it is given. The background-prefetch
`AsyncDataSetIterator` is not ported yet (ROADMAP queue A14).
"""
from __future__ import annotations

from typing import Iterator, List, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Base iterator contract (reference ND4J `DataSetIterator`)."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Iterate a pre-batched list; one DataSet with `batch_size` is cut
    into batches."""

    def __init__(self, data: List[DataSet], batch_size: Optional[int] = None):
        if batch_size is not None and len(data) == 1:
            data = data[0].batch_by(batch_size)
        self._data = list(data)
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._data)

    def next(self):
        d = self._data[self._pos]
        self._pos += 1
        return d

    def reset(self):
        self._pos = 0
