"""Training listeners (counterpart of
`deeplearning4j_tpu/optimize/listeners.py`, a copy).

Reference: `optimize/api/IterationListener.java`, `TrainingListener.java`
(onEpochStart/onEpochEnd hooks), impls in `optimize/listeners/`:
`ScoreIterationListener`, `PerformanceListener` (samples/sec, batches/sec),
`CollectScoresIterationListener`, `ParamAndGradientIterationListener`,
and `CheckpointListener` on the port's `CheckpointStore`.

Listeners read `model.score_value`, which waits for the device the first
time it is read after a step; a listener that fires every iteration adds
that sync to every step.
"""
from __future__ import annotations

import logging
import os
import time
from typing import List, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    """Base hook interface (reference `IterationListener.java`).

    `on_restart`/`on_rollback` have no reference analogue: they fire when
    a fault-tolerant trainer restores a checkpoint, `on_restart` after a
    crash or transient failure, `on_rollback` after the health sentinel's
    divergence escalation
    (`optimize/health.HealthSentinel`) — so listeners holding
    iteration-keyed state (score curves, UI streams) can note the
    rollback instead of seeing the iteration clock silently jump
    backwards."""

    def iteration_done(self, model, iteration: int) -> None:
        pass

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass

    def on_restart(self, model, restart_count: int) -> None:
        pass

    def on_rollback(self, model, rollback_count: int) -> None:
        pass


class ScoreIterationListener(IterationListener):
    """Log score every N iterations (reference
    `ScoreIterationListener.java`)."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.print_iterations == 0:
            logger.info("Score at iteration %d is %s", iteration, model.score_value)


class PerformanceListener(IterationListener):
    """Throughput telemetry (reference `PerformanceListener.java`:
    samples/sec and batches/sec every N iterations)."""

    def __init__(self, frequency: int = 10, report_samples: bool = True):
        self.frequency = max(1, frequency)
        self.report_samples = report_samples
        self._last_time = None
        self._last_iter = 0
        self._samples_since = 0
        self.last_samples_per_sec = 0.0
        self.last_batches_per_sec = 0.0

    def record_batch(self, num_samples: int) -> None:
        self._samples_since += num_samples

    def iteration_done(self, model, iteration: int) -> None:
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
            return
        if iteration - self._last_iter >= self.frequency:
            dt = now - self._last_time
            batches = iteration - self._last_iter
            self.last_batches_per_sec = batches / dt
            self.last_samples_per_sec = self._samples_since / dt if dt > 0 else 0.0
            logger.info("iteration %d: %.1f batches/sec, %.1f samples/sec",
                        iteration, self.last_batches_per_sec, self.last_samples_per_sec)
            self._last_time = now
            self._last_iter = iteration
            self._samples_since = 0


class CollectScoresIterationListener(IterationListener):
    """Collect (iteration, score) pairs (reference
    `CollectScoresIterationListener.java`)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(model.score_value)))


class ParamAndGradientIterationListener(IterationListener):
    """Tab-delimited per-parameter and per-gradient summary statistics
    every `frequency` iterations (reference
    `optimize/listeners/ParamAndGradientIterationListener.java`: writes
    mean/absmean/min/max for params and gradients to console or file).

    Gradients are recomputed on the model's last batch when the listener
    fires (the train step does not keep them): one extra forward and
    backward per report, only while this listener is attached."""

    HEADER = ("iteration\tscore\tname\tp_mean\tp_absmean\tp_min\tp_max"
              "\tg_mean\tg_absmean\tg_min\tg_max")

    def __init__(self, frequency: int = 1, file_path=None,
                 print_console: bool = False):
        self.frequency = max(1, frequency)
        self.file_path = file_path
        self.print_console = print_console
        self.rows: List[str] = []
        if file_path is not None:
            with open(file_path, "w") as f:
                f.write(self.HEADER + "\n")

    def _emit(self, line: str) -> None:
        self.rows.append(line)
        if self.print_console:
            print(line)
        if self.file_path is not None:
            with open(self.file_path, "a") as f:
                f.write(line + "\n")

    def iteration_done(self, model, iteration: int) -> None:
        import numpy as np

        if iteration % self.frequency != 0:
            return
        ds = getattr(model, "_last_batch", None)
        if ds is None:
            return
        grad_flat, score = model.compute_gradient_and_score(ds)
        # walk per-layer named params in flat-vector order
        offset = 0
        for name, arr in self._named(model):
            p = arr.detach().float().cpu().numpy().ravel()
            g = grad_flat[offset:offset + p.size]
            offset += p.size
            self._emit("\t".join([
                str(iteration), f"{score:.6g}", name,
                f"{p.mean():.6g}", f"{np.abs(p).mean():.6g}",
                f"{p.min():.6g}", f"{p.max():.6g}",
                f"{g.mean():.6g}", f"{np.abs(g).mean():.6g}",
                f"{g.min():.6g}", f"{g.max():.6g}"]))

    def _named(self, model):
        # iteration order must match ravel_pytree's flat layout: dict keys
        # are flattened in SORTED order
        ps = model._params
        if isinstance(ps, dict):
            for vname in sorted(ps):
                for pname in sorted(ps[vname]):
                    yield f"{vname}_{pname}", ps[vname][pname]
        else:
            for i, d in enumerate(ps):
                for pname in sorted(d):
                    yield f"{i}_{pname}", d[pname]


class CheckpointListener(IterationListener):
    """Periodic checkpointing with keep-last-N rotation (Deeplearning4j
    checkpoints through `ModelSerializer` and early-stopping savers; this
    listener does it on an iteration or epoch cadence).

    Saves commit through `util/checkpoint_store.CheckpointStore`: each
    `<dir>/checkpoint_<iteration>.zip` is written to a temp name,
    fsynced, and published with `os.replace` together with an integrity
    sidecar (`...zip.manifest.json` — per-file size/SHA-256/CRC32, step,
    wall-clock, library version), so a crash mid-save can never destroy a
    previously published checkpoint. The `latest` marker file remains as
    a convenience; the restore path trusts manifest verification, not the
    marker. `save_hooks` are the store's save-phase hooks (a crash
    drill's seam)."""

    def __init__(self, directory, every_n_iterations: int = 0,
                 every_n_epochs: int = 0, keep_last: int = 3,
                 save_hooks=()):
        from deeplearning4j_tpu_torch.util.checkpoint_store import CheckpointStore

        if not every_n_iterations and not every_n_epochs:
            raise ValueError("set every_n_iterations and/or every_n_epochs")
        self.directory = directory
        self.store = CheckpointStore(directory, keep_last=keep_last,
                                     save_hooks=save_hooks)
        self.every_n_iterations = every_n_iterations
        self.every_n_epochs = every_n_epochs
        self.keep_last = self.store.keep_last
        self.saved: List[str] = []
        self._last_saved_iteration = -1

    def _save(self, model, iteration: int) -> None:
        from deeplearning4j_tpu_torch.util.serialization import write_model

        if iteration == self._last_saved_iteration:
            return  # iteration- and epoch-cadence fired at the same step
        # the store owns the atomic commit, so the writer skips its own
        # temp+fsync+replace pass (atomic=False): one fsync per save
        path = self.store.save(
            iteration, lambda tmp: write_model(model, tmp, atomic=False))
        # marked saved only AFTER the publish: a crashed save must not
        # consume this iteration's slot — the rolled-back run re-saves it
        self._last_saved_iteration = iteration
        self.saved.append(str(path))
        self.saved = [p for p in self.saved
                      if os.path.exists(p)][-self.keep_last:]

    def iteration_done(self, model, iteration: int) -> None:
        if self.every_n_iterations and iteration % self.every_n_iterations == 0:
            self._save(model, iteration)

    def on_epoch_end(self, model) -> None:
        if self.every_n_epochs and (model.epoch + 1) % self.every_n_epochs == 0:
            self._save(model, model.iteration)

    @staticmethod
    def last_checkpoint(directory) -> "str | None":
        """Path of the newest VERIFIED checkpoint (manifest re-hash).
        Falls back to the legacy `latest` marker for manifest-less
        directories written by older builds; returns None when nothing
        usable remains (e.g. every retained checkpoint is corrupt — the
        caller should start fresh rather than restore damage)."""
        from deeplearning4j_tpu_torch.util.checkpoint_store import (
            CheckpointCorruptError,
            CheckpointStore,
            manifest_path_for,
        )

        if not os.path.isdir(directory):
            return None  # stay a pure probe: never mkdir as a side effect
        store = CheckpointStore(directory)
        has_manifests = any(
            manifest_path_for(store.path_for(s)).exists()
            for s in store.steps())
        if has_manifests:
            try:
                latest = store.latest_verified()
            except CheckpointCorruptError:
                return None
            if latest is not None:
                return str(latest[1])
        marker = os.path.join(directory, "latest")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            name = f.read().strip()
        path = os.path.join(directory, name)
        return path if os.path.exists(path) else None
