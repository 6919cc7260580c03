"""Device-side batch prefetch (counterpart of
`deeplearning4j_tpu/parallel/device_prefetch.py`; reference
`parallelism/MagicQueue.java:21`, the device-aware queue that stages each
mini-batch on its target GPU before the worker needs it).

`DevicePrefetchIterator` wraps any DataSetIterator and keeps the next
`depth` batches on the card ahead of the consumer. Each array is copied
from the host array into a pinned staging buffer (a host memcpy), then
to the card with `non_blocking=True` on a side CUDA stream, so the copy
of batch N+k overlaps the training step of batch N. An event recorded on
the side stream after the copy is what the consuming stream waits on
when the batch is handed out, and `record_stream` tells the caching
allocator that the consumer uses the device tensor, so its memory (taken
on the side stream) is not reused while the consumer's work is queued.

A pinned staging buffer is refilled only after the event of its previous
copy has completed (`_take`): overwriting it while that copy is still
queued would hand the consumer a batch with another batch's bytes. The
buffers are kept in one ring of `depth` per array size.

Batches handed out carry the (min, max) of their integer features and
labels, taken on the host, so `fit`'s range checks never read the card.
Given a CPU target (`device="cpu"`, or a placement on a CPU mesh), the
iterator passes the underlying batches through unchanged.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,
    _int_range,
)
from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


class DevicePrefetchIterator(DataSetIterator):
    """Yields DataSets whose arrays are already on the card.

    `sharding`: the mesh data-axis placement (`mesh.data_placement("data")`,
    the counterpart of `NamedSharding(mesh, P("data"))`), whose device
    the batches land on; `device` is used when `sharding` is None (the
    card by default).
    `depth`: how many batches to keep in flight ahead of the consumer.
    """

    def __init__(self, underlying: DataSetIterator, depth: int = 2,
                 sharding=None, device="cuda"):
        self._under = underlying
        self.depth = max(1, depth)
        self.sharding = sharding
        self.device = resolve_device(device if sharding is None
                                     else sharding.device)
        self._fifo: deque = deque()
        self._iter: Optional[Iterator[DataSet]] = None
        self._stream = None
        self._pool: Dict[int, deque] = {}
        self.staged = 0   # arrays copied to the card (observability)

    # ------------------------------------------------------------ staging
    @property
    def copy_stream(self):
        """The side stream the copies run on (None for a CPU target)."""
        if self._stream is None and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def _take(self, nbytes: int) -> torch.Tensor:
        """A pinned buffer of `nbytes` whose previous copy has completed:
        a new one while the size's ring holds fewer than `depth`, else the
        oldest, after the host waits for its copy's event."""
        ring = self._pool.setdefault(nbytes, deque())
        if len(ring) < self.depth:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        buf, done = ring.popleft()
        done.synchronize()
        return buf

    def _put(self, a):
        """(device tensor, the copy's event) of one array."""
        if a is None:
            return None
        host = _host_tensor(a)
        if host.device.type != "cpu":
            raise ValueError(f"DevicePrefetchIterator stages host arrays; "
                             f"got a tensor on {host.device}")
        nbytes = host.numel() * host.element_size()
        buf = self._take(nbytes)
        staging = buf.view(host.dtype).view(host.shape)
        staging.copy_(host)
        stream = self.copy_stream
        with torch.cuda.stream(stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(staging, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        self._pool[nbytes].append((buf, done))
        self.staged += 1
        return dev, done

    def _stage(self, ds: DataSet):
        if self.device.type != "cuda":
            return ds
        staged = DataSet(*(self._put(getattr(ds, f)) for f in (
            "features", "labels", "features_mask", "labels_mask")))
        staged._value_ranges = {
            "features": _int_range(ds.features),
            "labels": _int_range(ds.labels, ds.labels_mask)}
        return staged

    def _hand_out(self, staged):
        """The staged batch as device tensors, the consuming stream made
        to wait for each copy and recorded as a user of its memory."""
        if self.device.type != "cuda":
            return staged
        consumer = torch.cuda.current_stream(self.device)
        out = []
        for f in ("features", "labels", "features_mask", "labels_mask"):
            item = getattr(staged, f)
            if item is None:
                out.append(None)
                continue
            dev, done = item
            consumer.wait_event(done)
            dev.record_stream(consumer)
            out.append(dev)
        ds = DataSet(*out)
        ds._value_ranges = staged._value_ranges
        return ds

    def _refill(self):
        while len(self._fifo) < self.depth:
            try:
                ds = next(self._iter)
            except StopIteration:
                return
            self._fifo.append(self._stage(ds))

    # ----------------------------------------------------------- iterator
    def reset(self) -> None:
        self._iter = iter(self._under)
        self._fifo.clear()
        self._refill()

    def has_next(self) -> bool:
        if self._iter is None:
            self.reset()
        return bool(self._fifo)

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds = self._hand_out(self._fifo.popleft())
        self._refill()
        return ds

    def batch(self) -> int:
        return self._under.batch()

    @property
    def async_supported(self) -> bool:
        # already ahead of time; wrapping in the host-thread prefetcher too
        # would just add queue handoffs
        return False
