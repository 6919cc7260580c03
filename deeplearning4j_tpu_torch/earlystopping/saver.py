"""Model savers (reference `earlystopping/saver/`): persist the best and
the latest model during early-stopping training."""
from __future__ import annotations

from pathlib import Path
from typing import Optional


class EarlyStoppingModelSaver:
    def save_best_model(self, net, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, net, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    """Keep clones in memory (reference `InMemoryModelSaver`)."""

    def __init__(self):
        self.best = None
        self.latest = None

    def save_best_model(self, net, score):
        self.best = net.clone()

    def save_latest_model(self, net, score):
        self.latest = net.clone()

    def get_best_model(self):
        return self.best

    def get_latest_model(self):
        return self.latest


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """Checkpoint zips under a directory (reference `LocalFileModelSaver`:
    bestModel.bin / latestModel.bin), written by `util/serialization`, so
    the zips load in either package.

    Saves commit atomically (temp file, fsync, `os.replace`) and publish
    an integrity sidecar (`bestModel.bin.manifest.json`); loads verify
    the sidecar and raise the typed `CheckpointCorruptError` for a
    truncated or bit-rotted file. `device` is where loads rebuild the
    network: by default the device of the last network this saver
    wrote, else the card. A zip holds no compute dtype, so a loaded
    network computes in f32, as the reference's does."""

    def __init__(self, directory, device=None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.best_path = self.directory / "bestModel.bin"
        self.latest_path = self.directory / "latestModel.bin"
        self.device = device

    def _save(self, net, path) -> None:
        import contextlib

        from deeplearning4j_tpu_torch.util.checkpoint_store import (
            manifest_path_for,
            write_manifest_for,
        )
        from deeplearning4j_tpu_torch.util.serialization import write_model

        # retire the old sidecar before replacing the payload: a crash
        # between the two must leave a manifest-less file that still
        # loads, never a stale manifest vouching for bytes that are gone
        with contextlib.suppress(OSError):
            manifest_path_for(path).unlink()
        write_model(net, path)
        write_manifest_for(path, step=net.iteration)
        if self.device is None:
            self.device = net.device

    def save_best_model(self, net, score):
        self._save(net, self.best_path)

    def save_latest_model(self, net, score):
        self._save(net, self.latest_path)

    def _load(self, path) -> Optional[object]:
        if not path.exists():
            return None
        from deeplearning4j_tpu_torch.util.checkpoint_store import (
            manifest_path_for,
            verify_manifest,
        )
        from deeplearning4j_tpu_torch.util.serialization import restore_model

        if manifest_path_for(path).exists():
            # the sidecar catches damage the zip CRC cannot (a clobbered
            # central directory); manifest-less files still get the
            # typed-error translation in restore
            verify_manifest(path)
        return restore_model(path, device=self.device or "cuda")

    def get_best_model(self):
        return self._load(self.best_path)

    def get_latest_model(self):
        return self._load(self.latest_path)
