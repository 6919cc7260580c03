"""Durable checkpoint persistence: atomic commits, integrity manifests and
last-good fallback (counterpart of
`deeplearning4j_tpu/util/checkpoint_store.py`; a copy, since the port
imports nothing of the JAX package).

- **atomic commit**: a payload is written to a temp name in the
  destination's directory, fsynced, then published with `os.replace`
  (and a directory fsync): a reader sees the old file or the new one,
  never a partial one.
- **integrity manifest**: each checkpoint carries a sidecar
  `<name>.manifest.json` with per-file size, SHA-256 and CRC32, the
  training step, wall-clock and library version, in the JAX package's
  format (`MANIFEST_FORMAT`), so a directory written by either package
  verifies and loads in the other. `verify_manifest` re-hashes on load;
  any drift raises `CheckpointCorruptError`. The manifest is published
  after its payload, so a crash between the two leaves an unverifiable
  payload that the fallback loader skips.
- **last-good fallback**: `CheckpointStore` keeps the newest `keep_last`
  checkpoints and `load_latest_verified` walks newest to oldest, skipping
  corrupt, truncated or unverifiable entries.

`CheckpointStore(save_hooks=[...])` calls each hook at the named phases
of a save (`pre_write`, `mid_write`, `pre_publish`, `post_payload`): the
seam a crash drill plants its fault in. The verified cloud transfer
(`upload`/`download`) needs `cloud/storage.py`, which is not ported.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import time
import zlib
from hashlib import sha256
from pathlib import Path
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")

MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_FORMAT = "deeplearning4j_tpu/checkpoint-manifest/v1"
_HASH_CHUNK = 1 << 20


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (truncated file, digest
    mismatch, missing manifest or zip entry), or no retained checkpoint
    survived verification."""


# ---------------------------------------------------------------------------
# atomic publish primitives


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


def fsync_file(path) -> None:
    with open(path, "rb+") as f:
        f.flush()
        os.fsync(f.fileno())


def fsync_dir(directory) -> None:
    """fsync a directory so a file just created in it survives power
    loss (best effort, as `_fsync_dir`)."""
    _fsync_dir(directory)


def crc32_hex(data: bytes) -> str:
    """CRC32 of `data` as 8 lowercase hex characters."""
    return format(zlib.crc32(data) & 0xFFFFFFFF, "08x")


def _tmp_name(path: Path) -> Path:
    # same directory as the destination (os.replace must not cross a
    # filesystem); a unique suffix keeps concurrent savers apart
    return path.parent / f".{path.name}.tmp-{os.getpid()}-{time.monotonic_ns()}"


@contextlib.contextmanager
def atomic_write(path, fsync: bool = True):
    """Yield a temp path in `path`'s directory; on clean exit the temp
    file is fsynced and published over `path`. On any exception it is
    removed and `path` is untouched."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_name(path)
    try:
        yield tmp
        if fsync and tmp.exists():
            fsync_file(tmp)
        os.replace(tmp, path)
        _fsync_dir(path.parent)
    finally:
        with contextlib.suppress(OSError):
            tmp.unlink()


def atomic_write_bytes(path, data: bytes, fsync: bool = True) -> None:
    """Atomically publish `data` at `path` (temp + fsync + os.replace)."""
    with atomic_write(path, fsync=fsync) as tmp:
        tmp.write_bytes(data)


# ---------------------------------------------------------------------------
# integrity manifests


def file_digests(path) -> dict:
    """Size, SHA-256 and CRC32 of a file, read in chunks."""
    h = sha256()
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK)
            if not chunk:
                break
            h.update(chunk)
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return {"size": size, "sha256": h.hexdigest(),
            "crc32": format(crc & 0xFFFFFFFF, "08x")}


def _payload_files(path: Path) -> List[Tuple[str, Path]]:
    """(relative name, path) pairs a manifest covers: the file itself, or
    every regular file under a directory checkpoint, sidecar manifests
    and temp scratch left out."""
    if path.is_file():
        return [(path.name, path)]
    out = []
    for f in sorted(path.rglob("*")):
        if not f.is_file():
            continue
        name = f.relative_to(path).as_posix()
        if name.endswith(MANIFEST_SUFFIX) \
                or (f.name.startswith(".") and ".tmp-" in f.name):
            continue
        out.append((name, f))
    return out


def build_manifest(path, step: Optional[int] = None,
                   extra: Optional[dict] = None) -> dict:
    """Manifest dict for a file or directory checkpoint: per-file
    size/SHA-256/CRC32 plus step, wall-clock and this package's version."""
    from deeplearning4j_tpu_torch import __version__

    path = Path(path)
    manifest = {
        "format": MANIFEST_FORMAT,
        "library_version": __version__,
        "wall_clock": time.time(),
        "step": step,
        "files": {name: file_digests(p) for name, p in _payload_files(path)},
    }
    if extra:
        manifest.update(extra)
    return manifest


def manifest_path_for(path) -> Path:
    path = Path(path)
    return path.parent / (path.name + MANIFEST_SUFFIX)


def write_manifest_for(path, step: Optional[int] = None,
                       extra: Optional[dict] = None) -> Path:
    """Build and atomically publish the sidecar manifest of a checkpoint
    file or directory. Returns the manifest's path."""
    mpath = manifest_path_for(path)
    manifest = build_manifest(path, step=step, extra=extra)
    atomic_write_bytes(mpath, json.dumps(manifest, indent=1).encode())
    return mpath


def load_manifest(path) -> dict:
    """The sidecar manifest of a checkpoint path. Raises
    `CheckpointCorruptError` when it is absent or unreadable (a payload
    without a manifest is unverifiable, not trusted)."""
    mpath = manifest_path_for(path)
    try:
        manifest = json.loads(mpath.read_bytes().decode())
    except FileNotFoundError:
        raise CheckpointCorruptError(
            f"no integrity manifest for checkpoint {path} "
            f"(expected {mpath}): the save was interrupted before the "
            "manifest was published, or the checkpoint predates manifests")
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest {mpath}: {e}") from e
    if not isinstance(manifest, dict) or "files" not in manifest:
        raise CheckpointCorruptError(f"malformed manifest {mpath}")
    return manifest


def verify_manifest(path, manifest: Optional[dict] = None) -> dict:
    """Re-hash a checkpoint against its manifest; raises
    `CheckpointCorruptError` on a missing file, a size drift or a digest
    mismatch. Returns the verified manifest."""
    path = Path(path)
    if manifest is None:
        manifest = load_manifest(path)
    for name, want in manifest["files"].items():
        f = path if path.is_file() and name == path.name else path / name
        if not f.is_file():
            raise CheckpointCorruptError(
                f"checkpoint {path}: manifest file {name!r} is missing")
        got = file_digests(f)
        if got["size"] != want["size"]:
            raise CheckpointCorruptError(
                f"checkpoint {path}: {name!r} is {got['size']} bytes, "
                f"manifest says {want['size']} (truncated/partial write)")
        if got["sha256"] != want.get("sha256", got["sha256"]) \
                or got["crc32"] != want.get("crc32", got["crc32"]):
            raise CheckpointCorruptError(
                f"checkpoint {path}: {name!r} digest mismatch "
                "(bit rot or tampering)")
    return manifest


# ---------------------------------------------------------------------------
# bounded-backoff retry


_NON_RETRYABLE = (FileNotFoundError, PermissionError, IsADirectoryError,
                  NotADirectoryError)


def retry_with_backoff(fn: Callable, *, what: str = "operation",
                       max_retries: int = 3, backoff: float = 0.05,
                       backoff_multiplier: float = 2.0,
                       retryable: tuple = (ConnectionError, OSError,
                                           TimeoutError),
                       non_retryable: tuple = _NON_RETRYABLE):
    """Run `fn()`, retrying `retryable` failures after
    `backoff * backoff_multiplier**attempt` seconds, at most `max_retries`
    times; the last failure is re-raised. Anything outside `retryable`,
    and `non_retryable` types even where they subclass a retryable one
    (a missing file stays missing), re-raises at once."""
    delay = backoff
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except retryable as e:
            if isinstance(e, non_retryable) or attempt >= max_retries:
                raise
            logger.warning("%s failed (%s: %s); retry %d/%d in %.3fs",
                           what, type(e).__name__, e, attempt + 1,
                           max_retries, delay)
            time.sleep(delay)
            delay *= backoff_multiplier


# ---------------------------------------------------------------------------
# the store


class CheckpointStore:
    """A directory of durably committed, manifest-verified checkpoints
    with keep-last-N retention and newest-verified-first restore.

        <dir>/checkpoint_<step>.zip                 payload
        <dir>/checkpoint_<step>.zip.manifest.json   integrity sidecar
        <dir>/latest                                newest-payload marker

    `save(step, writer)` hands `writer` a temp path to write the payload
    at, hashes it, and publishes payload, manifest and marker in that
    order, each with `os.replace`. A payload whose manifest never
    published is skipped by `load_latest_verified`, does not count for
    retention, and is overwritten by the next save of that step.

    `save_hooks`: callables `hook(phase, step, path)` fired at
    `pre_write` / `mid_write` / `pre_publish` / `post_payload`."""

    def __init__(self, directory, keep_last: int = 3,
                 prefix: str = "checkpoint_", suffix: str = ".zip",
                 save_hooks=()):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_last = max(1, keep_last)
        self.prefix = prefix
        self.suffix = suffix
        self.save_hooks = list(save_hooks)
        self._step_re = re.compile(
            re.escape(prefix) + r"(\d+)" + re.escape(suffix) + r"$")

    # -- layout ----------------------------------------------------------
    def path_for(self, step: int) -> Path:
        return self.directory / f"{self.prefix}{step}{self.suffix}"

    def steps(self) -> List[int]:
        """Published checkpoint steps, ascending, from a directory scan
        (the marker file is a convenience, never the source of truth)."""
        out = []
        for f in self.directory.iterdir():
            m = self._step_re.match(f.name)
            if m and f.is_file():
                out.append(int(m.group(1)))
        return sorted(out)

    def _hook(self, phase: str, step: int, path: Path) -> None:
        for hook in self.save_hooks:
            hook(phase, step, path)

    # -- commit ----------------------------------------------------------
    def save(self, step: int, writer: Callable[[Path], None]) -> Path:
        """Durably commit one checkpoint: `writer(tmp_path)` writes the
        payload at a temp name; the store fsyncs it, writes the manifest,
        and publishes both atomically. Returns the published path. On any
        failure (an injected crash too) the temp files are removed and
        earlier checkpoints are untouched."""
        final = self.path_for(step)
        tmp_payload = _tmp_name(final)
        mpath = manifest_path_for(final)
        tmp_manifest = _tmp_name(mpath)
        try:
            self._hook("pre_write", step, tmp_payload)
            writer(tmp_payload)
            self._hook("mid_write", step, tmp_payload)
            fsync_file(tmp_payload)
            manifest = build_manifest(tmp_payload, step=step)
            # the manifest vouches for the final name, not the temp one
            manifest["files"] = {
                final.name: manifest["files"][tmp_payload.name]}
            tmp_manifest.write_bytes(json.dumps(manifest, indent=1).encode())
            fsync_file(tmp_manifest)
            self._hook("pre_publish", step, tmp_payload)
            os.replace(tmp_payload, final)
            self._hook("post_payload", step, final)
            os.replace(tmp_manifest, mpath)
            _fsync_dir(self.directory)
            atomic_write_bytes(self.directory / "latest",
                               final.name.encode())
            self.gc()
            return final
        finally:
            for t in (tmp_payload, tmp_manifest):
                with contextlib.suppress(OSError):
                    t.unlink()

    def save_bytes(self, step: int, data: bytes) -> Path:
        return self.save(step, lambda tmp: tmp.write_bytes(data))

    # -- verification / restore ------------------------------------------
    def verify(self, step: int) -> dict:
        """Verify one checkpoint against its manifest; raises
        `CheckpointCorruptError`, returns the manifest."""
        return verify_manifest(self.path_for(step))

    def latest_verified(self) -> Optional[Tuple[int, Path]]:
        """(step, path) of the newest checkpoint that passes verification,
        or None when the store is empty; damaged entries are logged and
        skipped, and `CheckpointCorruptError` is raised when none
        passes."""
        steps = self.steps()
        for step in reversed(steps):
            try:
                self.verify(step)
                return step, self.path_for(step)
            except CheckpointCorruptError as e:
                logger.warning("skipping checkpoint step %d: %s", step, e)
        if steps:
            raise CheckpointCorruptError(
                f"no verifiable checkpoint in {self.directory}: all "
                f"{len(steps)} retained entries failed integrity checks "
                f"(steps {steps})")
        return None

    def load_latest_verified(self, loader: Callable[[Path], object]):
        """Restore from the newest checkpoint that passes manifest
        verification and that `loader(path)` accepts (a loader raising
        `CheckpointCorruptError` moves the walk on to an older one).
        Returns `(loader_result, step)`. Raises `CheckpointCorruptError`
        when checkpoints exist but none survives, `FileNotFoundError`
        when the store is empty."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        failures = []
        for step in reversed(steps):
            path = self.path_for(step)
            try:
                self.verify(step)
                return loader(path), step
            except CheckpointCorruptError as e:
                logger.warning("skipping checkpoint step %d: %s", step, e)
                failures.append((step, str(e)))
        raise CheckpointCorruptError(
            f"no loadable checkpoint in {self.directory}: "
            + "; ".join(f"step {s}: {msg}" for s, msg in failures))

    # -- retention -------------------------------------------------------
    def gc(self) -> List[Path]:
        """Drop all but the newest `keep_last` verifiable checkpoints
        (payload and sidecar together), orphaned sidecars and stale temp
        files. Payloads without a manifest never count for retention and
        are left in place. Returns the removed payload paths."""
        removed = []
        steps = [s for s in self.steps()
                 if manifest_path_for(self.path_for(s)).exists()]
        for step in steps[:-self.keep_last] if len(steps) > self.keep_last \
                else []:
            p = self.path_for(step)
            for f in (p, manifest_path_for(p)):
                with contextlib.suppress(OSError):
                    f.unlink()
            removed.append(p)
        for f in self.directory.iterdir():
            if f.name.endswith(MANIFEST_SUFFIX):
                payload = f.with_name(f.name[:-len(MANIFEST_SUFFIX)])
                if not payload.exists():
                    with contextlib.suppress(OSError):
                        f.unlink()
            elif f.name.startswith(".") and ".tmp-" in f.name:
                with contextlib.suppress(OSError):
                    f.unlink()
        return removed

    # -- verified cloud transfer -----------------------------------------
    def upload(self, storage, key_prefix: str = "",
               step: Optional[int] = None, max_retries: int = 3,
               backoff: float = 0.05) -> str:
        raise NotImplementedError(
            "CheckpointStore.upload is not ported yet (ROADMAP queue A14: "
            "cloud/storage.py)")

    def download(self, storage, key_prefix: str = "",
                 step: Optional[int] = None, max_retries: int = 3,
                 backoff: float = 0.05) -> Path:
        raise NotImplementedError(
            "CheckpointStore.download is not ported yet (ROADMAP queue "
            "A14: cloud/storage.py)")
