"""Atomic checkpoint commits (counterpart of the publish primitives of
`deeplearning4j_tpu/util/checkpoint_store.py`).

A payload is written to a temp name in the destination's directory,
fsynced, then published with `os.replace` (and a directory fsync): a
reader sees the old file or the new one, never a partial one.
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path


class CheckpointCorruptError(RuntimeError):
    """A checkpoint is truncated, fails its CRC or misses an entry."""


def fsync_file(path) -> None:
    with open(path, "rb+") as f:
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(directory) -> None:
    """fsync a directory so a published rename survives power loss.
    Best effort: some filesystems refuse read-only directory handles."""
    try:
        fd = os.open(os.fspath(directory), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _tmp_name(path: Path) -> Path:
    # same directory as the destination (os.replace must not cross a
    # filesystem); a unique suffix keeps concurrent savers apart
    return path.parent / f".{path.name}.tmp-{os.getpid()}-{time.monotonic_ns()}"


@contextlib.contextmanager
def atomic_write(path):
    """Yield a temp path in `path`'s directory; on clean exit the temp
    file is fsynced and published over `path`. On any exception it is
    removed and `path` is untouched."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_name(path)
    try:
        yield tmp
        if tmp.exists():
            fsync_file(tmp)
        os.replace(tmp, path)
        _fsync_dir(path.parent)
    finally:
        with contextlib.suppress(OSError):
            tmp.unlink()
