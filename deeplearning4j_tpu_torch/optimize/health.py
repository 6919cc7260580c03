"""Training health sentinel: non-finite guards, divergence escalation,
poison-batch quarantine (counterpart of
`deeplearning4j_tpu/optimize/health.py`, a copy: the port imports nothing
of the JAX package).

- `HealthSentinel` watches every training step. With one attached
  (`MultiLayerNetwork.set_health_sentinel`), the step computes one global
  gradient-norm scalar in f32 (the squared norms of the gradient leaves
  summed in the JAX package's leaf order) and a finite flag, reads the
  small `(loss, grad_norm, ok)` vector to the host (the step's one
  device-to-host read) and applies the parameter and optimizer updates
  only when loss and gradient norm are both finite: a non-finite step
  never touches the parameters, the optimizer state or the layer state,
  and the iteration still advances. The host then runs EWMA spike
  detection and the escalation ladder on those scalars.
- The escalation ladder: each rung fires after `skip_budget` consecutive
  unhealthy steps (non-finite, so skipped; or a finite spike past
  `spike_factor` x the EWMA, committed but counted unhealthy):
  1. skip: the guard already dropped the update; counted and logged;
  2. LR backoff: every layer's learning rate is multiplied by
     `lr_backoff_factor` (the updater reads it each step), at most
     `backoff_budget` times per incident;
  3. rollback: raise `DivergenceRollback` for a trainer that can restore
     the last verified checkpoint (`rollback_available`; at most
     `rollback_budget` times); a standalone fit skips this rung;
  4. give up: raise the typed `TrainingDivergedError`.
- `BatchQuarantine`: a directory of poisoned records with provenance
  sidecars, fed by `datasets.iterators.QuarantiningDataSetIterator`.

`HealthSentinel` state is host-side and not thread-safe: attach one per
fit loop.
"""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")

_EPS = 1e-8


class TrainingDivergedError(RuntimeError):
    """Training diverged and the sentinel's recovery budget is exhausted
    (skips, LR backoffs, and rollbacks all spent). Typed so trainers can
    distinguish a genuinely dead run from a transient failure — it is
    never swallowed by `FaultTolerantTrainer`'s restart loop."""


class DivergenceRollback(RuntimeError):
    """Control-flow signal, not a failure: the sentinel requests a restore
    of the last verified-good checkpoint + replay. Consumed by
    `FaultTolerantTrainer` (counted as `rollbacks`, fires `on_rollback`
    listeners, never charged against `max_restarts`)."""


class QuarantineFullError(RuntimeError):
    """The quarantine directory hit `max_records` — the stream is
    producing poisoned records faster than anyone is triaging them, which
    is a data-pipeline outage, not noise to absorb silently."""


# ---------------------------------------------------------------------------
# poisoned-batch helpers


def non_finite_array_reason(a, name: str = "array") -> Optional[str]:
    """Why this single array is poisoned, or None when clean: NaN/Inf in a
    floating array (integer arrays are finite by construction). Shared by
    the batch screen below and the serving tier's output screen
    (`serving.model_server` runs it on every inference result before the
    circuit breaker sees the step as a success). A torch tensor is
    checked where it lives; only the count comes back to the host."""
    if hasattr(a, "detach"):
        if not a.is_floating_point():
            return None
        bad = int((~torch.isfinite(a.detach())).sum())
        return f"{name} contain {bad} non-finite value(s)" if bad else None
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.floating):
        return None
    if not np.isfinite(a).all():
        bad = np.count_nonzero(~np.isfinite(a))
        return f"{name} contain {bad} non-finite value(s)"
    return None


def non_finite_batch_reason(ds) -> Optional[str]:
    """Why this batch would poison a training step, or None when clean:
    checks features/labels/masks for NaN/Inf (integer arrays are finite by
    construction and skipped). Host-side screen for stream records —
    cheap next to the fit dispatch it protects."""
    for name in ("features", "labels", "features_mask", "labels_mask"):
        a = getattr(ds, name, None)
        if a is None:
            continue
        reason = non_finite_array_reason(a, name)
        if reason is not None:
            return reason
    return None


class BatchQuarantine:
    """A directory of quarantined records, each an `.npz` payload plus a
    `.json` provenance sidecar (reason, wall-clock, stream position,
    shapes) — the triage trail for poisoned data:

        <dir>/record_<seq>.npz
        <dir>/record_<seq>.json

    Existing records are counted on construction so a restarted pipeline
    appends instead of overwriting. `max_records` bounds the directory;
    exceeding it raises `QuarantineFullError` (a stream that is ALL
    poison is an outage, not noise)."""

    def __init__(self, directory, max_records: int = 256):
        if max_records < 1:
            raise ValueError("max_records must be >= 1")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_records = max_records
        # resume after the HIGHEST existing index, not the count: a
        # triaged (deleted) record must never cause a later one to be
        # overwritten
        existing = [int(p.stem.split("_")[1]) for p in self.record_paths()]
        self._seq = max(existing) + 1 if existing else 0

    def __len__(self) -> int:
        return len(self.record_paths())

    def record_paths(self) -> List[Path]:
        return sorted(self.directory.glob("record_*.npz"))

    def quarantine(self, ds, reason: str, provenance: Optional[dict] = None
                   ) -> Path:
        """Write one poisoned record + provenance; returns the payload
        path. Raises `QuarantineFullError` past `max_records`."""
        if len(self.record_paths()) >= self.max_records:
            raise QuarantineFullError(
                f"quarantine {self.directory} is full "
                f"({self.max_records} records) — the stream is producing "
                "poisoned records faster than they are being triaged")
        seq = self._seq
        self._seq += 1
        payload = self.directory / f"record_{seq}.npz"
        ds.save(payload)
        meta = {
            "seq": seq,
            "reason": reason,
            "wall_clock": time.time(),
            "num_examples": int(ds.num_examples()),
            "features_shape": list(np.shape(ds.features)),
            "features_dtype": str(np.asarray(ds.features).dtype),
        }
        if ds.labels is not None:
            meta["labels_shape"] = list(np.shape(ds.labels))
        if provenance:
            meta["provenance"] = provenance
        sidecar = self.directory / f"record_{seq}.json"
        sidecar.write_text(json.dumps(meta, indent=1, default=str))
        logger.warning("quarantined poisoned record %d -> %s (%s)",
                       seq, payload, reason)
        return payload

    def load(self, seq: int) -> Tuple[object, dict]:
        """(DataSet, provenance dict) for one quarantined record — the
        triage read path."""
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        ds = DataSet.load(self.directory / f"record_{seq}.npz")
        meta = json.loads(
            (self.directory / f"record_{seq}.json").read_text())
        return ds, meta


# ---------------------------------------------------------------------------
# the sentinel


class HealthSentinel:
    """Per-step training health watchdog + bounded escalation policy.

    Attach with `net.set_health_sentinel(sentinel)`: the train step
    gains the finite guard (see the module docstring) and calls
    `observe()` once per step with the step's `(loss, grad_norm, ok)`,
    read to the host once: the one sync the sentinel costs. Line-search
    fits (`Solver`) report through `observe_host` with the scalars their
    host loop already materialized.

    Escalation state: `skip_budget` consecutive unhealthy steps trigger
    the next rung (LR backoff → rollback → `TrainingDivergedError`);
    `skip_budget` consecutive HEALTHY steps close the incident (the
    backoff count re-arms; the backed-off LR intentionally stays — the
    replay must not re-diverge at the LR that killed it). EWMA baselines
    update only on healthy steps, so a spike cannot drag its own
    threshold up.
    """

    def __init__(self, spike_factor: float = 10.0, ewma_beta: float = 0.9,
                 warmup_steps: int = 10, skip_budget: int = 3,
                 lr_backoff_factor: float = 0.5, backoff_budget: int = 2,
                 rollback_budget: int = 2,
                 on_event: Optional[Callable[[dict], None]] = None):
        if not (0.0 < ewma_beta < 1.0):
            raise ValueError("ewma_beta must be in (0, 1)")
        if spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1")
        if not (0.0 < lr_backoff_factor < 1.0):
            raise ValueError("lr_backoff_factor must be in (0, 1)")
        if skip_budget < 1:
            raise ValueError("skip_budget must be >= 1")
        if backoff_budget < 0 or rollback_budget < 0:
            raise ValueError("budgets must be >= 0")
        self.spike_factor = spike_factor
        self.ewma_beta = ewma_beta
        self.warmup_steps = warmup_steps
        self.skip_budget = skip_budget
        self.lr_backoff_factor = lr_backoff_factor
        self.backoff_budget = backoff_budget
        self.rollback_budget = rollback_budget
        self.on_event = on_event
        # armed by a rollback-capable trainer (FaultTolerantTrainer);
        # standalone fits skip the rollback rung and fail typed instead
        self.rollback_available = False
        # counters (observable state for tests/telemetry)
        self.steps = 0
        self.skips = 0
        self.spikes = 0
        self.backoffs = 0
        self.rollbacks = 0
        self.lr_scale = 1.0
        self.last_verdict = "ok"
        self.last_step_skipped = False
        # EWMA baselines + streak machine
        self._loss_ewma: Optional[float] = None
        self._gnorm_ewma: Optional[float] = None
        self._healthy_seen = 0
        self._unhealthy_streak = 0
        self._healthy_streak = 0
        self._backoffs_in_incident = 0

    # -- observation entry points ----------------------------------------
    def observe(self, net, health) -> bool:
        """Consume one guarded step's health vector `[loss, grad_norm, ok]`
        (a host array, or a tensor read back here). Returns True when the step was healthy; raises
        `DivergenceRollback` / `TrainingDivergedError` per the ladder."""
        if hasattr(health, "detach"):
            health = health.detach().cpu().numpy()
        h = np.asarray(health, np.float64)
        return self._record(net, float(h[0]), float(h[1]),
                            committed=bool(h[2] >= 0.5))

    def observe_host(self, net, loss, grad_norm: Optional[float] = None,
                     committed: bool = True) -> bool:
        """Host-scalar path (line-search solvers already materialize
        their score; `committed=False` marks a candidate the caller
        rejected, e.g. `Solver._commit`'s non-finite guard)."""
        loss = float("nan") if loss is None else float(loss)
        return self._record(net, loss,
                            None if grad_norm is None else float(grad_norm),
                            committed=committed)

    # -- telemetry --------------------------------------------------------
    def counters(self) -> dict:
        return {"steps": self.steps, "skips": self.skips,
                "spikes": self.spikes, "backoffs": self.backoffs,
                "rollbacks": self.rollbacks, "lr_scale": self.lr_scale}

    def _emit(self, kind: str, **fields) -> None:
        if self.on_event is not None:
            self.on_event({"event": kind, **fields})

    # -- the ladder --------------------------------------------------------
    def _record(self, net, loss: float, gnorm: Optional[float],
                committed: bool) -> bool:
        self.steps += 1
        finite = (committed and np.isfinite(loss)
                  and (gnorm is None or np.isfinite(gnorm)))
        spike = finite and self._is_spike(loss, gnorm)
        self.last_step_skipped = not committed
        if not committed:
            self.skips += 1
        if finite and not spike:
            self._note_healthy(loss, gnorm)
            return True
        it = getattr(net, "iteration", -1)
        if spike:
            self.spikes += 1
            self.last_verdict = "spike"
            logger.warning(
                "HealthSentinel: spike at iteration %d (loss=%g vs EWMA "
                "%s, grad_norm=%s vs EWMA %s, factor %gx)", it, loss,
                self._loss_ewma, gnorm, self._gnorm_ewma,
                self.spike_factor)
        else:
            self.last_verdict = "non-finite"
            logger.warning(
                "HealthSentinel: non-finite step at iteration %d "
                "(loss=%s, grad_norm=%s)%s", it, loss, gnorm,
                "; batch skipped, parameters untouched"
                if not committed else "")
        self._emit(self.last_verdict, iteration=it, loss=loss,
                   grad_norm=gnorm)
        self._unhealthy_streak += 1
        self._healthy_streak = 0
        if self._unhealthy_streak >= self.skip_budget:
            self._unhealthy_streak = 0
            self._escalate(net)
        return False

    def _is_spike(self, loss: float, gnorm: Optional[float]) -> bool:
        if self._healthy_seen < self.warmup_steps:
            return False
        if self._loss_ewma is not None \
                and loss > self.spike_factor * (abs(self._loss_ewma) + _EPS):
            return True
        return (gnorm is not None and self._gnorm_ewma is not None
                and gnorm > self.spike_factor * (self._gnorm_ewma + _EPS))

    def _note_healthy(self, loss: float, gnorm: Optional[float]) -> None:
        self.last_verdict = "ok"
        b = self.ewma_beta
        self._loss_ewma = loss if self._loss_ewma is None \
            else b * self._loss_ewma + (1 - b) * loss
        if gnorm is not None:
            self._gnorm_ewma = gnorm if self._gnorm_ewma is None \
                else b * self._gnorm_ewma + (1 - b) * gnorm
        self._healthy_seen += 1
        self._unhealthy_streak = 0
        self._healthy_streak += 1
        if self._healthy_streak >= self.skip_budget:
            # incident closed: re-arm the backoff budget (the backed-off
            # LR stays — recovery at the lower LR is the stable state)
            self._backoffs_in_incident = 0

    def _escalate(self, net) -> None:
        if self._backoffs_in_incident < self.backoff_budget:
            self._backoff_lr(net)
            return
        if self.rollback_available and self.rollbacks < self.rollback_budget:
            self.rollbacks += 1
            logger.warning(
                "HealthSentinel: requesting rollback %d/%d to the last "
                "verified-good checkpoint (LR backoffs exhausted at "
                "lr_scale=%g)", self.rollbacks, self.rollback_budget,
                self.lr_scale)
            self._emit("rollback", rollbacks=self.rollbacks)
            raise DivergenceRollback(
                f"sustained divergence after {self.backoffs} LR "
                f"backoff(s); rollback {self.rollbacks}/"
                f"{self.rollback_budget} requested")
        raise TrainingDivergedError(
            f"training diverged and the recovery budget is exhausted: "
            f"{self.skips} skipped batch(es), {self.backoffs} LR "
            f"backoff(s) (lr_scale={self.lr_scale:g}), "
            f"{self.rollbacks}/{self.rollback_budget} rollback(s)"
            + ("" if self.rollback_available
               else " (no rollback-capable trainer attached)"))

    def _backoff_lr(self, net) -> None:
        self.backoffs += 1
        self._backoffs_in_incident += 1
        self.lr_scale *= self.lr_backoff_factor
        for layer in getattr(net, "layers", []):
            cfg = getattr(layer, "updater_cfg", None)
            if cfg is None:
                continue
            cfg.learning_rate *= self.lr_backoff_factor
            if cfg.bias_learning_rate is not None:
                cfg.bias_learning_rate *= self.lr_backoff_factor
        gc = getattr(getattr(net, "conf", None), "global_conf", None)
        if gc is not None:
            gc.learning_rate *= self.lr_backoff_factor
        # the updater reads the rate from these configurations at every
        # step, so the next step runs at the reduced rate
        logger.warning(
            "HealthSentinel: backing off learning rate x%g (backoff %d, "
            "cumulative lr_scale=%g)", self.lr_backoff_factor,
            self.backoffs, self.lr_scale)
        self._emit("backoff", backoffs=self.backoffs,
                   lr_scale=self.lr_scale)

    def on_rolled_back(self, net=None) -> None:
        """Called by the rollback-capable trainer after the checkpoint restore:
        the replay starts from different dynamics, so the streaks and
        EWMA baselines reset and the backoff budget re-arms — but the
        rollback count and the backed-off LR persist (the budget is per
        sentinel, and replaying at the divergent LR would loop)."""
        self._loss_ewma = None
        self._gnorm_ewma = None
        self._healthy_seen = 0
        self._unhealthy_streak = 0
        self._healthy_streak = 0
        self._backoffs_in_incident = 0
        self.last_step_skipped = False
        self.last_verdict = "ok"
