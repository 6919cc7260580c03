"""Object-store dataset/model IO (reference `aws/s3/` role, SURVEY §2.4;
counterpart of `deeplearning4j_tpu/cloud/storage.py`, host code copied:
the port imports nothing of the JAX package).

Objects are the JAX package's bytes: a dataset is the same `.npz`, a
model the same checkpoint zip, so either package reads what the other
wrote to a bucket. `get_model(key, device=)` restores onto the port's
device (the card by default)."""
from __future__ import annotations

import io
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.datasets.iterators import (
    natural_key as _natural_key,  # canonical home for the shard sort key
)


def _ds_to_bytes(ds: DataSet) -> bytes:
    buf = io.BytesIO()
    arrays = {"features": ds.features}
    if ds.labels is not None:
        arrays["labels"] = ds.labels
    if ds.features_mask is not None:
        arrays["features_mask"] = ds.features_mask
    if ds.labels_mask is not None:
        arrays["labels_mask"] = ds.labels_mask
    np.savez(buf, **arrays)
    return buf.getvalue()


def _ds_from_bytes(raw: bytes) -> DataSet:
    z = np.load(io.BytesIO(raw), allow_pickle=False)
    return DataSet(z["features"],
                   z["labels"] if "labels" in z else None,
                   z["features_mask"] if "features_mask" in z else None,
                   z["labels_mask"] if "labels_mask" in z else None)


class DataSetStorage:
    """Key → bytes object store with DataSet/model helpers (reference
    `S3Uploader` / `BaseS3DataSetIterator` surface)."""

    # -- raw object contract (backends implement) -------------------------
    def put_bytes(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get_bytes(self, key: str) -> bytes:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    # -- dataset/model helpers -------------------------------------------
    def put_dataset(self, key: str, ds: DataSet) -> None:
        self.put_bytes(key, _ds_to_bytes(ds))

    def get_dataset(self, key: str) -> DataSet:
        return _ds_from_bytes(self.get_bytes(key))

    def put_model(self, key: str, net) -> None:
        import tempfile

        from deeplearning4j_tpu_torch.util.serialization import write_model

        with tempfile.NamedTemporaryFile(suffix=".zip") as f:
            write_model(net, f.name)
            f.seek(0)
            self.put_bytes(key, Path(f.name).read_bytes())

    def get_model(self, key: str, device="cuda"):
        import tempfile

        from deeplearning4j_tpu_torch.util.serialization import restore_model

        with tempfile.NamedTemporaryFile(suffix=".zip") as f:
            f.write(self.get_bytes(key))
            f.flush()
            return restore_model(f.name, device=device)


class LocalStorage(DataSetStorage):
    """Filesystem backend — always available; also the test double for the
    gated cloud backends (the reference tests S3 paths against local files
    the same way)."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        p = (self.root / key).resolve()
        # Path.is_relative_to, not a string prefix compare: "/data/bucket"
        # must not admit "/data/bucket-evil"
        if not p.is_relative_to(self.root.resolve()):
            raise ValueError(f"key {key!r} escapes the storage root")
        return p

    def put_bytes(self, key: str, data: bytes) -> None:
        from deeplearning4j_tpu_torch.util.checkpoint_store import (
            atomic_write_bytes,
        )

        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        # atomic publish: an interrupted put must not leave a truncated
        # object that a later get would hand to a model restore
        atomic_write_bytes(p, data)

    def get_bytes(self, key: str) -> bytes:
        return self._path(key).read_bytes()

    def list_keys(self, prefix: str = "") -> List[str]:
        return sorted(str(f.relative_to(self.root))
                      for f in self.root.rglob("*")
                      if f.is_file() and str(f.relative_to(self.root)).startswith(prefix))

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()


class RetryingStorage(DataSetStorage):
    """Bounded-backoff retry + post-transfer checksum re-verification for
    ANY `DataSetStorage` backend — the cloud-transfer leg of the durable
    checkpoint subsystem (`util/checkpoint_store.py`), under the same
    retry discipline as `RetryingParameterServerClient`.

    - transient transport failures (`ConnectionError`/`OSError`/
      `TimeoutError`) retry after `backoff × backoff_multiplier^attempt`
      seconds, at most `max_retries` retries, then re-raise;
    - with `verify=True` (default), every `put_bytes` is read back and
      its SHA-256 compared against what was sent — an object store that
      corrupted bytes in flight is retried like a transport failure, and
      exhaustion raises `CheckpointCorruptError`. `get_bytes` accepts an
      optional `expected_sha256` for the symmetric download check (used
      by `CheckpointStore.download`, whose manifests carry the digests).

    Counters (`attempts`, `retries`) are observability for chaos tests."""

    def __init__(self, storage: DataSetStorage, max_retries: int = 3,
                 backoff: float = 0.05, backoff_multiplier: float = 2.0,
                 verify: bool = True):
        self._storage = storage
        self.max_retries = max_retries
        self.backoff = backoff
        self.backoff_multiplier = backoff_multiplier
        self.verify = verify
        self.attempts = 0
        self.retries = 0

    def _retry(self, what: str, fn, extra_retryable: tuple = ()):
        from deeplearning4j_tpu_torch.util.checkpoint_store import (
            retry_with_backoff,
        )

        def counted():
            self.attempts += 1
            return fn()

        before = self.attempts

        try:
            return retry_with_backoff(
                counted, what=what, max_retries=self.max_retries,
                backoff=self.backoff,
                backoff_multiplier=self.backoff_multiplier,
                retryable=(ConnectionError, OSError, TimeoutError)
                + extra_retryable)
        finally:
            self.retries += max(0, self.attempts - before - 1)

    def put_bytes(self, key: str, data: bytes) -> None:
        import hashlib

        from deeplearning4j_tpu_torch.util.checkpoint_store import (
            CheckpointCorruptError,
        )

        if not self.verify:
            self._retry(f"put {key}", lambda: self._storage.put_bytes(key, data))
            return
        want = hashlib.sha256(data).hexdigest()

        def _put_verified():
            self._storage.put_bytes(key, data)
            got = hashlib.sha256(self._storage.get_bytes(key)).hexdigest()
            if got != want:
                raise CheckpointCorruptError(
                    f"upload of {key!r} corrupted in transit "
                    "(read-back digest mismatch)")

        self._retry(f"put {key}", _put_verified,
                    extra_retryable=(CheckpointCorruptError,))

    def get_bytes(self, key: str,
                  expected_sha256: "str | None" = None) -> bytes:
        import hashlib

        from deeplearning4j_tpu_torch.util.checkpoint_store import (
            CheckpointCorruptError,
        )

        def _get():
            data = self._storage.get_bytes(key)
            if expected_sha256 is not None \
                    and hashlib.sha256(data).hexdigest() != expected_sha256:
                raise CheckpointCorruptError(
                    f"download of {key!r} corrupted in transit "
                    "(digest mismatch)")
            return data

        return self._retry(f"get {key}", _get,
                           extra_retryable=(CheckpointCorruptError,)
                           if expected_sha256 is not None else ())

    def list_keys(self, prefix: str = "") -> List[str]:
        return self._retry(f"list {prefix!r}",
                           lambda: self._storage.list_keys(prefix))

    def exists(self, key: str) -> bool:
        return self._retry(f"exists {key}",
                           lambda: self._storage.exists(key))


class GCSStorage(DataSetStorage):
    """Google Cloud Storage backend. `client=None` imports the real
    google-cloud-storage package (not bundled here — no egress); inject
    any object with the client surface this class consumes
    (`bucket().blob().upload_from_string/download_as_bytes/exists`,
    `bucket().list_blobs`) to run the SAME key-prefixing/serde code
    against a fake — how CI exercises this path
    (`tests/test_torch_cloud.py::FakeGCSClient`)."""

    def __init__(self, bucket: str, prefix: str = "", client=None):
        if client is None:
            try:
                from google.cloud import storage  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "GCSStorage requires the google-cloud-storage package "
                    "(or pass client=); use LocalStorage in this "
                    "environment") from e
            client = storage.Client()
        self._bucket = client.bucket(bucket)
        self._prefix = prefix.rstrip("/")

    def _key(self, key: str) -> str:
        return f"{self._prefix}/{key}" if self._prefix else key

    def put_bytes(self, key: str, data: bytes) -> None:
        self._bucket.blob(self._key(key)).upload_from_string(data)

    def get_bytes(self, key: str) -> bytes:
        return self._bucket.blob(self._key(key)).download_as_bytes()

    def list_keys(self, prefix: str = "") -> List[str]:
        full = self._key(prefix)
        skip = len(self._prefix) + 1 if self._prefix else 0
        return sorted(b.name[skip:] for b in self._bucket.list_blobs(prefix=full))

    def exists(self, key: str) -> bool:
        return self._bucket.blob(self._key(key)).exists()


class StorageDataSetIterator(DataSetIterator):
    """STREAM DataSets from a key prefix, one object in memory at a time
    (reference `BaseS3DataSetIterator.java` — its `next()` opens the next
    S3 object): the training set lives in the bucket and is never
    downloaded up front, so it may be far larger than host storage.

    `async_supported` is True — wrap in `AsyncDataSetIterator` and the
    next object's download overlaps the current batch's device step (the
    same producer/consumer overlap the host infeed pipeline uses).
    `reset()` re-lists the prefix, so shards appended between epochs
    become visible on the next pass."""

    def __init__(self, storage: DataSetStorage, prefix: str = ""):
        self.storage = storage
        self.prefix = prefix
        self._keys: Optional[List[str]] = None
        self._pos = 0

    def reset(self) -> None:
        # natural sort: shard writers number keys, often WITHOUT zero
        # padding ("shard_10" must follow "shard_9", not "shard_1") —
        # iteration order must be the write order regardless of backend
        # listing order
        self._keys = sorted(self.storage.list_keys(self.prefix),
                            key=_natural_key)
        self._pos = 0

    def has_next(self) -> bool:
        if self._keys is None:
            self.reset()
        return self._pos < len(self._keys)

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds = self.storage.get_dataset(self._keys[self._pos])
        self._pos += 1
        return ds

    def batch(self) -> int:
        return -1
