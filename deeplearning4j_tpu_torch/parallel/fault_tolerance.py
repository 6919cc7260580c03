"""Checkpoint-based fault tolerance + fault-injection framework
(counterpart of `deeplearning4j_tpu/parallel/fault_tolerance.py`; the
injectors are its code, the trainer restores through the port's
`CheckpointStore` and `restore_model` onto the network's own device).

Reference (SURVEY §5 "Failure detection / elastic recovery"): absent — the
reference inherits Spark task retry and nothing else; there is no
checkpoint-based elasticity and no fault-injection framework. Both are
table stakes for long runs (preemptible machines), so this build provides:

- `FaultTolerantTrainer`: drives `fit` epoch-by-epoch with periodic
  checkpoints; on a transient failure it restores the newest checkpoint
  (model + updater state + iteration clock) and resumes, up to
  `max_restarts` times. Works on a bare network AND on distributed
  handles (`DistributedMultiLayer`, `ParallelWrapper`) — anything with a
  `fit(iterator, epochs=)` whose underlying network is reachable via
  `get_network()`.
- Fault injectors, all logging through the `deeplearning4j_tpu_torch`
  logger so
  chaos tests assert on `caplog` rather than stdout:
  * `FaultInjectionListener` — single-node: raise at iteration N.
  * `WorkerCrashInjector` — distributed: worker k raises on its n-th fit.
  * `SlowWorkerInjector` — distributed: worker k sleeps per minibatch,
    exercising the master's straggler `worker_timeout`.
  * `ParameterServerStallInjector` — wraps a parameter-server store so
    push/pull block, exercising the client's timeout/backoff give-up.
  * `CheckpointCrashInjector` — kills a checkpoint SAVE at a chosen
    phase (mid-write, pre-publish, between payload and manifest),
    exercising the durable store's atomic-commit + last-good-fallback
    guarantees (`util/checkpoint_store.py`).
  * `NaNGradientInjector` — poisons a minibatch's features with NaN/Inf
    so loss/gradients go non-finite at a chosen step, TRANSIENTLY (the
    original data is restored/untouched) — exercises the health
    sentinel's fused skip guard and escalation ladder
    (`optimize/health.py`).
  * `PoisonBatchInjector` — poisons specific records PERSISTENTLY (every
    replay/re-dispatch sees the same bad record) — exercises quarantine
    and the exhausted-budget `TrainingDivergedError` path.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from deeplearning4j_tpu_torch.optimize.listeners import (
    CheckpointListener,
    IterationListener,
)
from deeplearning4j_tpu_torch.parallel.training_master import (
    TrainingHook,
    current_worker_id,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")


class InjectedFault(RuntimeError):
    """Raised by fault injectors (distinguishable from real bugs)."""


class FaultInjectionListener(IterationListener):
    """Raises `InjectedFault` once training reaches `fail_at_iteration`
    (>=, so a restarted run that resumes past the trigger still fires);
    fires at most `times` times."""

    def __init__(self, fail_at_iteration: int, times: int = 1):
        self.fail_at_iteration = fail_at_iteration
        self.remaining = times
        self.fired = 0

    def iteration_done(self, model, iteration: int) -> None:
        if self.remaining > 0 and iteration >= self.fail_at_iteration:
            self.remaining -= 1
            self.fired += 1
            logger.warning("FaultInjectionListener: injected fault at "
                           "iteration %d", iteration)
            raise InjectedFault(
                f"injected fault at iteration {iteration}")


# ---------------------------------------------------------------------------
# distributed injectors (TrainingHook seam — attach via
# `ParameterAveragingTrainingWorker.add_hook`)


class WorkerCrashInjector(TrainingHook):
    """TrainingHook: worker `worker_id` raises `InjectedFault` in
    `pre_update` once it has seen `fail_at_fit` minibatches (1-based,
    counted across shards and retries), at most `times` times.
    Thread-safe: hooks fire concurrently from shard threads."""

    def __init__(self, worker_id: int, fail_at_fit: int = 1,
                 times: int = 1):
        self.worker_id = worker_id
        self.fail_at_fit = fail_at_fit
        self.remaining = times
        self.fired = 0
        self._fits = 0
        self._lock = threading.Lock()

    def pre_update(self, ds, net) -> None:
        if current_worker_id() != self.worker_id:
            return
        with self._lock:
            self._fits += 1
            if self._fits < self.fail_at_fit or self.remaining <= 0:
                return
            self.remaining -= 1
            self.fired += 1
            fits = self._fits
        logger.warning("WorkerCrashInjector: injected crash on worker %d "
                       "(fit %d)", self.worker_id, fits)
        raise InjectedFault(
            f"injected crash on worker {self.worker_id} (fit {fits})")


class SlowWorkerInjector(TrainingHook):
    """TrainingHook: worker `worker_id` sleeps `delay` seconds before each
    of its first `times` minibatches — a deterministic straggler to
    exercise the master's `worker_timeout` path. Keep `delay` bounded in
    tests: the hung shard thread runs to completion in the background (its
    result is discarded), and an unbounded sleep would outlive the test."""

    def __init__(self, worker_id: int, delay: float, times: int = 1):
        self.worker_id = worker_id
        self.delay = delay
        self.remaining = times
        self.fired = 0
        self._lock = threading.Lock()

    def pre_update(self, ds, net) -> None:
        if current_worker_id() != self.worker_id:
            return
        with self._lock:
            if self.remaining <= 0:
                return
            self.remaining -= 1
            self.fired += 1
        logger.warning("SlowWorkerInjector: delaying worker %d by %.2fs",
                       self.worker_id, self.delay)
        time.sleep(self.delay)


class ParameterServerStallInjector:
    """Wraps any pull/push parameter-server store; after `stall_after`
    successful requests, every request blocks for `stall_seconds` (or
    until `release()`) before reaching the store — the PS-stall chaos
    hook. Pair with `RetryingParameterServerClient` to prove a stalled
    server raises after bounded backoff instead of deadlocking."""

    def __init__(self, store, stall_after: int = 0,
                 stall_seconds: float = 3600.0):
        self._store = store
        self.stall_after = stall_after
        self.stall_seconds = stall_seconds
        self.requests = 0
        self.stalled_requests = 0
        self._released = threading.Event()
        self._lock = threading.Lock()

    def release(self) -> None:
        """Un-stall (lets background threads stuck in a stalled request
        finish promptly at test teardown)."""
        self._released.set()

    def _maybe_stall(self) -> None:
        with self._lock:
            self.requests += 1
            stall = self.requests > self.stall_after
            if stall:
                self.stalled_requests += 1
                n = self.requests
        if stall and not self._released.is_set():
            logger.warning("ParameterServerStallInjector: stalling "
                           "request %d", n)
            self._released.wait(self.stall_seconds)

    def pull(self):
        self._maybe_stall()
        return self._store.pull()

    def push_update(self, delta, **kwargs) -> None:
        # kwargs (e.g. request_id) pass through so idempotent retried
        # pushes stay idempotent with the injector in the middle
        self._maybe_stall()
        self._store.push_update(delta, **kwargs)

    @property
    def num_pushes(self) -> int:
        return self._store.num_pushes


class CheckpointCrashInjector:
    """Save-hook for `util/checkpoint_store.CheckpointStore`: kill the
    `fail_at_save`-th checkpoint save (1-based, at most `times` times) at
    a chosen `phase` of the commit protocol —

    - ``pre_write``: die before any byte is written,
    - ``mid_write``: truncate the temp payload to half its size (a
      partially flushed file) and die — the classic preemption-mid-save,
    - ``pre_publish``: payload + manifest fully written and fsynced but
      neither published,
    - ``post_payload``: payload published, manifest not — the narrowest
      crash window, leaving an unverifiable orphan the fallback loader
      must skip.

    In every case the store's atomic-commit contract says previously
    published checkpoints stay verified and loadable; the chaos suite
    proves save-crash → restart → resume-from-last-good end to end
    through `FaultTolerantTrainer` (wire via
    `FaultTolerantTrainer(..., save_hooks=[injector])`)."""

    PHASES = ("pre_write", "mid_write", "pre_publish", "post_payload")

    def __init__(self, phase: str = "mid_write", fail_at_save: int = 1,
                 times: int = 1):
        if phase not in self.PHASES:
            raise ValueError(f"unknown save phase {phase!r}; choose from "
                             f"{self.PHASES}")
        self.phase = phase
        self.fail_at_save = fail_at_save
        self.remaining = times
        self.fired = 0
        self.saves = 0
        self._lock = threading.Lock()

    def __call__(self, phase: str, step: int, path) -> None:
        with self._lock:
            if phase == "pre_write":
                self.saves += 1
            if (phase != self.phase or self.remaining <= 0
                    or self.saves < self.fail_at_save):
                return
            self.remaining -= 1
            self.fired += 1
        if phase == "mid_write":
            # leave a half-flushed temp file behind, like a real kill -9
            # between write() and fsync()
            import os

            size = os.path.getsize(path)
            with open(path, "rb+") as f:
                f.truncate(size // 2)
        logger.warning("CheckpointCrashInjector: injected crash during "
                       "checkpoint save (step %d, phase %s)", step, phase)
        raise InjectedFault(
            f"injected crash during checkpoint save (step {step}, "
            f"phase {phase})")


# ---------------------------------------------------------------------------
# data-poisoning injectors (health-sentinel chaos seams)


class _PoisonedDataSetIterator:
    """DataSetIterator-contract wrapper produced by
    `NaNGradientInjector.wrap` / `PoisonBatchInjector.wrap`: delegates the
    underlying iterator and runs every yielded batch through the
    injector. `async_supported` is False so injection order stays
    deterministic under chaos assertions (no prefetch races)."""

    def __init__(self, underlying, injector):
        self._u = underlying
        self._inj = injector

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self):
        return self._u.has_next()

    def next(self):
        return self._inj._process(self._u.next())

    def reset(self):
        self._inj._on_reset()
        self._u.reset()

    def batch(self):
        return self._u.batch()

    @property
    def async_supported(self):
        return False


def _poisoned_copy(ds, value: float):
    """A features-poisoned COPY of `ds` (labels/masks shared; the
    original batch is never touched). Features become float32 — poisoning
    only makes sense for float-featured nets."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    bad = np.full(np.shape(ds.features), value, np.float32)
    return DataSet(bad, ds.labels, ds.features_mask, ds.labels_mask)


class NaNGradientInjector(TrainingHook):
    """TRANSIENT numeric blow-up: the `fail_at_fit`-th minibatch (1-based,
    counted across epochs/retries/replays, at most `times` times) gets
    its features replaced with `value` (NaN by default, try ``float('inf')``
    for the overflow flavor), so the fused train step's loss and gradients
    go non-finite at a chosen step — the health sentinel's skip guard is
    what keeps that from corrupting the parameters. Two seams:

    - ``wrap(iterator)`` — single-node fit loops: yields poisoned COPIES;
      the underlying batches stay clean, so a rollback replay trains on
      good data (a true transient, unlike `PoisonBatchInjector`).
    - `TrainingHook` (``worker.add_hook``) — distributed workers:
      `pre_update` poisons the shard batch in place and `post_update`
      restores the original features, so a re-dispatched shard trains
      clean while THIS worker's replica blows up (its non-finite result
      is then quarantined by the master —
      `training_master.NonFiniteWorkerResultError`). Restrict to one
      worker with `worker_id`.
    """

    def __init__(self, fail_at_fit: int = 1, times: int = 1,
                 value: float = float("nan"),
                 worker_id: Optional[int] = None):
        self.fail_at_fit = fail_at_fit
        self.remaining = times
        self.value = value
        self.worker_id = worker_id
        self.fired = 0
        self._fits = 0
        self._saved = {}
        self._lock = threading.Lock()

    def _trigger(self) -> bool:
        with self._lock:
            self._fits += 1
            if self._fits < self.fail_at_fit or self.remaining <= 0:
                return False
            self.remaining -= 1
            self.fired += 1
            fits = self._fits
        logger.warning("NaNGradientInjector: poisoning minibatch %d with "
                       "%s features", fits, self.value)
        return True

    # -- iterator seam ----------------------------------------------------
    def wrap(self, iterator) -> _PoisonedDataSetIterator:
        return _PoisonedDataSetIterator(iterator, self)

    def _process(self, ds):
        return _poisoned_copy(ds, self.value) if self._trigger() else ds

    def _on_reset(self) -> None:
        pass  # fits count across resets: a replay sees clean data once
        # `times` is spent — the transient contract

    # -- TrainingHook seam ------------------------------------------------
    def pre_update(self, ds, net) -> None:
        if self.worker_id is not None \
                and current_worker_id() != self.worker_id:
            return
        if not self._trigger():
            return
        import numpy as np

        with self._lock:
            self._saved[id(ds)] = ds.features
        ds.features = np.full(np.shape(ds.features), self.value,
                              np.float32)

    def post_update(self, ds, net) -> None:
        with self._lock:
            orig = self._saved.pop(id(ds), None)
        if orig is not None:
            ds.features = orig  # transient: re-dispatch sees clean data


class PoisonBatchInjector(TrainingHook):
    """PERSISTENT data poisoning: the record(s) at stream position
    `poison_at` (0-based int or collection of ints; position counts from
    the last `reset()`) have their features replaced with `value` EVERY
    time they are seen — retries, re-dispatches, and rollback replays
    included. A genuinely bad record, not a transient blow-up: the path
    that must end in quarantine (streaming tier) or a typed
    `TrainingDivergedError` (exhausted sentinel budget), never a hang.

    Seams: ``wrap(iterator)`` (DataSetIterator), ``wrap_source(source)``
    (plain streaming iterable — also accepts `(features, labels)` tuple
    records), and `TrainingHook` `pre_update` (poisons the shard batch in
    place with NO restore — the poison sticks to the shard across
    re-dispatches, so a data-poisoned shard fails on every worker and
    surfaces as `WorkerFailureError`)."""

    def __init__(self, poison_at=0, value: float = float("nan"),
                 worker_id: Optional[int] = None):
        self.poison_at = ({poison_at} if isinstance(poison_at, int)
                          else set(poison_at))
        self.value = value
        self.worker_id = worker_id
        self.fired = 0
        self._pos = 0
        self._fits = 0
        self._lock = threading.Lock()

    def _note_fired(self, pos: int) -> None:
        self.fired += 1
        logger.warning("PoisonBatchInjector: poisoned record at position "
                       "%d (%s features)", pos, self.value)

    # -- iterator seam ----------------------------------------------------
    def wrap(self, iterator) -> _PoisonedDataSetIterator:
        return _PoisonedDataSetIterator(iterator, self)

    def _process(self, ds):
        with self._lock:
            pos = self._pos
            self._pos += 1
            hit = pos in self.poison_at
        if not hit:
            return ds
        self._note_fired(pos)
        return _poisoned_copy(ds, self.value)

    def _on_reset(self) -> None:
        with self._lock:
            self._pos = 0  # persistent: the SAME positions re-poison
            # on every pass/replay

    def wrap_source(self, source):
        """Poisoning pass-through for a streaming source (plain
        iterable of DataSets or `(features, labels)` records)."""
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        def gen():
            for item in source:
                ds = item if isinstance(item, DataSet) else DataSet(*item)
                yield self._process(ds)

        return gen()

    # -- TrainingHook seam ------------------------------------------------
    def pre_update(self, ds, net) -> None:
        if self.worker_id is not None \
                and current_worker_id() != self.worker_id:
            return
        import numpy as np

        with self._lock:
            pos = self._fits
            self._fits += 1
            hit = pos in self.poison_at
        if not hit:
            return
        self._note_fired(pos)
        ds.features = np.full(np.shape(ds.features), self.value,
                              np.float32)  # in place, never restored


# ---------------------------------------------------------------------------
# restart-driving trainer


class FaultTolerantTrainer:
    """Usage:

        trainer = FaultTolerantTrainer(net, iterator, checkpoint_dir=dir,
                                       checkpoint_every=50, max_restarts=3)
        trainer.fit(epochs=10)

    `net` may be a bare network OR a distributed handle
    (`DistributedMultiLayer`, `ParallelWrapper`, ...): anything exposing
    `fit(iterator, epochs=)` plus `get_network()` for the underlying
    network that checkpoints/restores — so worker-pool averaging and the
    data-parallel wrapper compose with checkpoint recovery.

    The iterator must be restartable (reset()-able); after a restore the
    current epoch is re-run from its start — batches before the checkpoint
    are re-applied only if they came after the last checkpoint, which is
    the at-least-once semantics checkpoint-interval recovery gives.

    On every restore, listeners implementing `on_restart(model, count)`
    are notified, and when the handle's TrainingMaster collects stats the
    restart is counted there as `restarts`.

    Checkpoints commit durably (`util/checkpoint_store.CheckpointStore`:
    atomic publish + integrity manifest), and a restore walks backwards
    to the newest checkpoint that still VERIFIES — a crash during a save
    (even one injected by `CheckpointCrashInjector` via `save_hooks`)
    costs at most the batches since the previous checkpoint, never the
    ability to restore. `CheckpointCorruptError` is raised only when no
    retained checkpoint survives.
    """

    def __init__(self, net, iterator, checkpoint_dir,
                 checkpoint_every: int = 100, max_restarts: int = 3,
                 keep_last: int = 2, propagate: tuple = (),
                 save_hooks=(), sentinel=None):
        # `propagate`: exception types that are CONTROL FLOW, not failures
        # (e.g. early stopping's iteration-abort) — re-raised immediately
        # instead of triggering a checkpoint restore
        self.propagate = propagate
        # `sentinel`: a `optimize.health.HealthSentinel` to attach to the
        # network (a bare network only — a distributed handle's
        # replicas never consult it, so attach is refused
        # loudly there; that tier is guarded by the master's non-finite
        # result quarantine). The trainer then serves as the sentinel's
        # rollback handler: a `DivergenceRollback` restores the last
        # verified-good checkpoint and replays (counted as `rollbacks`,
        # never against `max_restarts`), and the typed
        # `TrainingDivergedError` always propagates (an exhausted
        # divergence budget is not a transient)
        self.sentinel = sentinel
        self.rollbacks = 0
        self.net = net
        # the restorable network behind a distributed handle/wrapper
        self.target = net.get_network() if hasattr(net, "get_network") \
            else net
        self.iterator = iterator
        self.checkpoint_dir = str(checkpoint_dir)
        self.max_restarts = max_restarts
        self.restarts = 0
        self._snapshot_known_good = False
        self._ckpt = CheckpointListener(self.checkpoint_dir,
                                        every_n_iterations=checkpoint_every,
                                        keep_last=keep_last,
                                        save_hooks=save_hooks)
        self.checkpoint_store = self._ckpt.store

    def _master_stats(self):
        master = getattr(self.net, "training_master", None)
        return master.get_training_stats() if master is not None else None

    def _restore(self) -> bool:
        """Restore the newest checkpoint that passes manifest
        verification AND loads, skipping corrupt/partial entries
        backwards (last-good fallback). Raises `CheckpointCorruptError`
        when checkpoints exist but none survive; returns False only when
        the store is empty."""
        from deeplearning4j_tpu_torch.util.serialization import restore_model

        store = self.checkpoint_store
        if not store.steps():
            return False
        net = self.target
        restored, step = store.load_latest_verified(
            lambda p: restore_model(p, device=net.device))
        net.set_params(restored.params())
        net.set_updater_state(restored.get_updater_state())
        net.set_layer_state(restored._layer_state)
        net.iteration = restored.iteration
        net.epoch = restored.epoch
        logger.warning("restored %s (iteration %d)", store.path_for(step),
                       net.iteration)
        return True

    def fit(self, epochs: int = 1, iterator=None) -> None:
        if iterator is not None:
            self.iterator = iterator
        net = self.target
        listeners = list(net.listeners)
        if self._ckpt not in listeners:
            net.set_listeners(*(listeners + [self._ckpt]))
        net._ensure_init()
        if self.sentinel is not None:
            if self.net is not net \
                    or not hasattr(net, "set_health_sentinel"):
                # fail LOUDLY: a distributed handle drives worker clones /
                # its own sharded step, neither of which consults the
                # sentinel — attaching one would be silently inert, the
                # exact silent-NaN outcome the sentinel exists to prevent
                raise ValueError(
                    "sentinel= requires a network whose own fit path runs "
                    "the guarded step (MultiLayerNetwork); "
                    f"{type(self.net).__name__} drives replicas/sharded "
                    "steps that never consult it — the distributed tier "
                    "is guarded by the master's non-finite result "
                    "quarantine (NonFiniteWorkerResultError) instead")
            self.sentinel.rollback_available = True
            if net.get_health_sentinel() is not self.sentinel:
                net.set_health_sentinel(self.sentinel)
        from deeplearning4j_tpu_torch.util.checkpoint_store import (
            CheckpointCorruptError,
        )

        # the "do we have a restorable checkpoint" probe re-hashes full
        # payloads, and this fit() runs once per epoch under
        # EarlyStoppingDistributedTrainer — once a good checkpoint is
        # known to exist it stays monotonically true (our own saves only
        # add more), so check at most once per trainer
        if not self._snapshot_known_good:
            try:
                have_good = (self.checkpoint_store.latest_verified()
                             is not None)
            except CheckpointCorruptError:
                have_good = False  # all retained damaged: snapshot now
            if not have_good:
                # a fault BEFORE the first cadence checkpoint must still
                # roll back (otherwise pre-fault batches get re-applied
                # on retry)
                self._ckpt._save(net, net.iteration)
            self._snapshot_known_good = True
        done = 0
        while done < epochs:
            try:
                self.net.fit(self.iterator, epochs=1)
                done += 1
            except Exception as e:
                from deeplearning4j_tpu_torch.optimize.health import (
                    DivergenceRollback,
                    TrainingDivergedError,
                )

                if isinstance(e, self.propagate) \
                        or isinstance(e, TrainingDivergedError):
                    # a typed divergence give-up is a verdict, not a
                    # transient — restoring and retrying would loop
                    raise
                rollback = isinstance(e, DivergenceRollback)
                if rollback:
                    # bounded by the SENTINEL's rollback_budget (it
                    # raises TrainingDivergedError when spent), so never
                    # charged against max_restarts
                    self.rollbacks += 1
                    logger.warning("divergence rollback %d: %s",
                                   self.rollbacks, e)
                else:
                    self.restarts += 1
                    if self.restarts > self.max_restarts:
                        logger.error("giving up after %d restarts",
                                     self.restarts - 1)
                        raise
                    logger.warning("training failed (%s: %s); restart %d/%d",
                                   type(e).__name__, e, self.restarts,
                                   self.max_restarts)
                if not self._restore():  # can't happen after the initial
                    raise RuntimeError(   # save; fail loudly if it does
                        "no checkpoint available to restore")
                master = getattr(self.net, "training_master", None)
                if master is not None and hasattr(master,
                                                  "reset_worker_health"):
                    # a restart is a fresh attempt: re-admit dropped
                    # workers, otherwise a transiently-dead pool (e.g. a
                    # brief PS outage that felled every worker) would fail
                    # every retry against the same empty pool
                    logger.warning("re-admitting all workers after restart")
                    master.reset_worker_health()
                stats = self._master_stats()
                if stats is not None:
                    stats.increment("rollbacks" if rollback else "restarts")
                hook_name = "on_rollback" if rollback else "on_restart"
                count = self.rollbacks if rollback else self.restarts
                for listener in getattr(net, "listeners", []):
                    listener_hook = getattr(listener, hook_name, None)
                    if listener_hook is not None:
                        listener_hook(net, count)
                if rollback:
                    sentinel = self.sentinel or getattr(
                        net, "get_health_sentinel", lambda: None)()
                    if sentinel is not None:
                        sentinel.on_rolled_back(net)
