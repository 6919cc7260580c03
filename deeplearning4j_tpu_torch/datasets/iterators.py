"""DataSet iterators (counterpart of
`deeplearning4j_tpu/datasets/iterators.py`).

`AsyncDataSetIterator` prefetches the batches of another iterator on a
producer thread into a bounded queue; an exception in the producer is
raised to the consumer at the batch where it happened, and `reset` (or
`close`) stops the thread before it returns. `fit` runs an iterator as it
is given (the JAX package wraps every `async_supported` iterator in
`AsyncDataSetIterator` itself; the results are the same either way), and
stops the producer of an `AsyncDataSetIterator` it was iterating when an
exception leaves the loop. `DeviceCacheDataSetIterator` keeps its batches
as tensors on the card, so an epoch moves nothing over the host link.
"""
from __future__ import annotations

import os
import queue
import re
import threading
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

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

    def batch(self) -> int:
        raise NotImplementedError

    @property
    def async_supported(self) -> bool:
        return True


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

    def batch(self):
        return self._data[0].num_examples() if self._data else 0


class ExistingDataSetIterator(DataSetIterator):
    """Wrap any Python iterable of DataSets. A one-shot iterator
    (generator) can be walked once: a second pass raises."""

    def __init__(self, iterable: Iterable[DataSet]):
        self._iterable = iterable
        self._one_shot = iter(iterable) is iterable
        self._consumed = False
        self._it: Optional[Iterator[DataSet]] = None
        self._peek: Optional[DataSet] = None

    def reset(self):
        if self._one_shot:
            if self._consumed:
                raise ValueError(
                    "ExistingDataSetIterator wraps a one-shot iterator "
                    "(generator) that has already been consumed; pass a list "
                    "or a restartable iterable to train multiple epochs")
            self._it = self._iterable
        else:
            self._it = iter(self._iterable)
        self._peek = None

    def has_next(self):
        if self._it is None:
            self.reset()
        if self._peek is not None:
            return True
        try:
            self._peek = next(self._it)
            self._consumed = True
            return True
        except StopIteration:
            return False

    def next(self):
        if not self.has_next():
            raise StopIteration
        d, self._peek = self._peek, None
        return d

    def batch(self):
        return -1


def natural_key(key: str):
    """Sort key that reads digit runs as numbers: s_9 < s_10 < s_11."""
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", key)]


class FileDataSetIterator(DataSetIterator):
    """DataSets read lazily from files written by `DataSet.save` (one
    file in memory at a time). `paths`: an iterable of paths, one file,
    or a directory (every `*.npz` in it, digit runs sorted as numbers)."""

    def __init__(self, paths):
        if isinstance(paths, (str, os.PathLike)):
            if os.path.isdir(paths):
                self.paths = sorted(
                    (os.path.join(paths, f) for f in os.listdir(paths)
                     if f.endswith(".npz")), key=natural_key)
            else:
                self.paths = [os.fspath(paths)]
        else:
            self.paths = [os.fspath(p) for p in paths]
        if not self.paths:
            raise ValueError("no exported dataset files to iterate")
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.paths)

    def next(self):
        if not self.has_next():
            raise StopIteration
        ds = DataSet.load(self.paths[self._pos])
        self._pos += 1
        return ds

    def batch(self):
        return -1


class MultipleEpochsIterator(DataSetIterator):
    """Replay an underlying iterator `epochs` times."""

    def __init__(self, epochs: int, underlying: DataSetIterator):
        self.epochs = epochs
        self._under = underlying
        self._epoch = 0

    def reset(self):
        self._under.reset()
        self._epoch = 0

    def has_next(self):
        if self._under.has_next():
            return True
        if self._epoch + 1 < self.epochs:
            self._epoch += 1
            self._under.reset()
            return self._under.has_next()
        return False

    def next(self):
        if not self.has_next():
            raise StopIteration
        return self._under.next()

    def batch(self):
        return self._under.batch()


_END = object()


class AsyncDataSetIterator(DataSetIterator):
    """Prefetch on a producer thread into a queue of `queue_size`
    batches. The producer starts at the first `has_next` (so the
    `__iter__` -> `reset` handshake prefetches nothing it throws away);
    its exception is raised to the consumer in order; `reset` and
    `close` stop it and join it before they return."""

    def __init__(self, underlying, queue_size: int = 2):
        if queue_size < 1:
            raise ValueError("queue_size must be >= 1")
        self._under = underlying
        self._queue_size = queue_size
        self._queue: Optional[queue.Queue] = None
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._peek = None
        self._exhausted = False

    def _start(self):
        q = self._queue = queue.Queue(maxsize=self._queue_size)
        stop = self._stop = threading.Event()
        self._exhausted = False
        self._peek = None
        under = self._under

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                while not stop.is_set() and under.has_next():
                    if not put(under.next()):
                        return
            except Exception as e:  # handed to the consumer, raised there
                put(e)
                return
            put(_END)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="AsyncDataSetIterator")
        self._thread.start()

    def close(self) -> None:
        """Stop the producer and wait for it; the underlying iterator is
        left where the producer stopped."""
        if self._thread is not None:
            self._stop.set()
            while self._thread.is_alive():
                try:  # unblock a producer waiting on a full queue
                    self._queue.get(timeout=0.05)
                except queue.Empty:
                    pass
            self._thread.join()
            self._thread = None
        self._peek = None
        self._exhausted = False

    def reset(self):
        self.close()
        self._under.reset()

    def has_next(self):
        if self._peek is not None:
            return True
        if self._exhausted:
            return False
        if self._thread is None:
            self._start()
        item = self._queue.get()
        if item is _END or isinstance(item, Exception):
            self._exhausted = True
            self._thread.join()
            self._thread = None
            if item is _END:
                return False
            raise item
        self._peek = item
        return True

    def next(self):
        if not self.has_next():
            raise StopIteration
        d, self._peek = self._peek, None
        return d

    def batch(self):
        return self._under.batch()


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """`AsyncDataSetIterator` over an iterator of MultiDataSets: the
    producer asks only `has_next`/`next` of its source."""


class IteratorDataSetIterator(DataSetIterator):
    """Re-batches an iterable of DataSets of any sizes to `batch_size`
    examples a batch (the last may be shorter)."""

    def __init__(self, source: Iterable[DataSet], batch_size: int):
        self._source = source
        self.batch_size = batch_size
        self._one_shot = iter(source) is source
        self._consumed = False
        self._iter: Optional[Iterator[DataSet]] = None
        self._buf: List[DataSet] = []
        self._buffered = 0
        self._peek: Optional[DataSet] = None

    def reset(self) -> None:
        if self._one_shot:
            if self._consumed:
                raise ValueError(
                    "IteratorDataSetIterator wraps a one-shot iterator "
                    "(generator) that has already been consumed; pass a "
                    "list or a restartable iterable to train multiple epochs")
            self._iter = self._source
            self._consumed = True
        else:
            self._iter = iter(self._source)
        self._buf, self._buffered, self._peek = [], 0, None

    def _assemble(self) -> Optional[DataSet]:
        while self._buffered < self.batch_size:
            try:
                ds = next(self._iter)
            except StopIteration:
                break
            self._buf.append(ds)
            self._buffered += ds.num_examples()
        if not self._buf:
            return None
        merged = DataSet.merge(self._buf)
        self._buf = []
        n, take = merged.num_examples(), self.batch_size
        if n > take:  # keep the tail for the next batch
            head, tail = merged.split_test_and_train(take)
            self._buf, self._buffered = [tail], n - take
            return head
        self._buffered = 0
        return merged

    def has_next(self) -> bool:
        if self._iter is None:
            self.reset()
        if self._peek is None:
            self._peek = self._assemble()
        return self._peek is not None

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds, self._peek = self._peek, None
        return ds

    def batch(self) -> int:
        return self.batch_size


class SingletonMultiDataSetIterator:
    """Yields one MultiDataSet per pass."""

    def __init__(self, mds):
        self._mds = mds
        self._done = False

    def __iter__(self):
        self._done = False
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        self._done = True
        return self._mds

    def reset(self) -> None:
        self._done = False

    @property
    def async_supported(self) -> bool:
        return False


def _int_range(a, mask=None):
    """(min, max) of an integer host array (positions where `mask` is 0
    left out), or None: kept beside a batch staged on the card, so that
    range checks need not read it back."""
    if a is None:
        return None
    arr = np.asarray(a)
    if not np.issubdtype(arr.dtype, np.integer) or not arr.size:
        return None
    if mask is not None:
        arr = arr[np.asarray(mask).astype(bool).reshape(arr.shape)]
        if not arr.size:
            return None
    return int(arr.min()), int(arr.max())


class DeviceCacheDataSetIterator(DataSetIterator):
    """Upload a pre-batched dataset to `device` once (the card by
    default) and iterate the resident tensors, any number of epochs.
    Batches keep their compact dtypes (uint8 ids, int labels); the
    network casts them on the device as it does host batches, so training
    on them gives the same results. Each batch carries the (min, max) of
    its integer features and labels, taken on the host, for the range
    checks of `fit`."""

    def __init__(self, data, batch_size=None, device="cuda"):
        from deeplearning4j_tpu_torch.ops.kernel_dispatch import (
            resolve_device,
        )

        dev = resolve_device(device)
        data = list(data) if not isinstance(data, list) else data
        if batch_size is not None and len(data) == 1:
            data = data[0].batch_by(batch_size)

        def put(a):
            if a is None:
                return None
            t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
            return t.to(dev)

        self._data = []
        for d in data:
            ds = DataSet(put(d.features), put(d.labels),
                         put(d.features_mask), put(d.labels_mask))
            ds._value_ranges = {
                "features": _int_range(d.features),
                "labels": _int_range(d.labels, d.labels_mask)}
            self._data.append(ds)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # uploads complete before the first pass
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._data)

    def next(self):
        d = self._data[self._pos]
        self._pos += 1
        return d

    def reset(self):
        self._pos = 0

    def batch(self):
        return self._data[0].num_examples() if self._data else 0

    @property
    def async_supported(self):
        return False  # already resident: a prefetch thread adds nothing


class QuarantiningDataSetIterator(DataSetIterator):
    """Screens every batch of an underlying iterator for NaN/Inf in its
    features, labels and masks (`optimize.health.non_finite_batch_reason`)
    and diverts poisoned batches, with provenance, to an
    `optimize.health.BatchQuarantine` instead of the fit loop.
    `quarantined` counts them over all passes. `has_next` pulls ahead
    until it holds a clean batch or the underlying iterator ends."""

    def __init__(self, underlying, quarantine, max_quarantined: int = 256):
        from deeplearning4j_tpu_torch.optimize.health import BatchQuarantine

        self._u = underlying
        self.quarantine = (quarantine if isinstance(quarantine,
                                                    BatchQuarantine)
                           else BatchQuarantine(
                               quarantine, max_records=max_quarantined))
        self.quarantined = 0
        self._pos = 0  # position in the current pass (provenance)
        self._pending: Optional[DataSet] = None

    def _advance(self) -> None:
        from deeplearning4j_tpu_torch.optimize.health import (
            non_finite_batch_reason,
        )

        while self._pending is None and self._u.has_next():
            ds = self._u.next()
            pos = self._pos
            self._pos += 1
            reason = non_finite_batch_reason(ds)
            if reason is None:
                self._pending = ds
                return
            self.quarantine.quarantine(
                ds, reason, {"stream_position": pos, "stage": "iterator"})
            self.quarantined += 1

    def has_next(self) -> bool:
        self._advance()
        return self._pending is not None

    def next(self) -> DataSet:
        self._advance()
        if self._pending is None:
            raise StopIteration
        ds, self._pending = self._pending, None
        return ds

    def reset(self) -> None:
        self._pending = None
        self._pos = 0
        self._u.reset()

    def batch(self) -> int:
        return self._u.batch()

    @property
    def async_supported(self) -> bool:
        return False
