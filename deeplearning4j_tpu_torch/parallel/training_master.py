"""TrainingMaster / TrainingWorker SPI + parameter-averaging master
(counterpart of `deeplearning4j_tpu/parallel/training_master.py`).

Reference: `dl4j-spark/.../spark/api/TrainingMaster.java`,
`TrainingWorker.java` (the pluggable distributed-training contract),
`spark/impl/paramavg/ParameterAveragingTrainingMaster.java:75`
(`executeTrainingDirect:356`, `doIteration:647`, `processResults:767` —
split the stream into averaging windows, fan out to workers, tree-reduce
parameter vectors, average, broadcast) and
`ParameterAveragingTrainingWorker.java:162`.

Workers run in-process (the analogue of the reference's Spark `local[N]`
test masters): each is a `net.clone()` on the net's device, trained on a
`ThreadPoolExecutor` thread, so on one card the replicas share it and
their kernels interleave on its stream. A worker ships back its flat f32
parameter vector and its flat updater state, in the JAX package's
`ravel_pytree` order (layer order, sorted parameter names, sorted state
names), and the master averages them example-weighted in f64 with
`np.average`, then `set_params`: the JAX package's arithmetic on the same
host arrays. The elasticity (timeouts, retries with backoff, the
non-finite quarantine, window re-runs over survivors,
`NoHealthyWorkersError`) is the JAX package's code.

A timed-out shard's thread cannot be killed: it stops at its next
minibatch boundary (`_run_shard`), and its replica holds device memory
until then. Build the kernels (and warm the allocator) before a drill
with a tight `worker_timeout`: a first-use build reads as a straggler.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import (
    FIRST_COMPLETED,
    Future,
    ThreadPoolExecutor,
    wait as _futures_wait,
)
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.parallel.repartition import (
    Repartition,
    RepartitionStrategy,
    balanced_partitions,
    should_repartition,
)
from deeplearning4j_tpu_torch.parallel.stats import TrainingStats
from deeplearning4j_tpu_torch.parallel.time_source import (
    TimeSource,
    TimeSourceProvider,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")


# ---------------------------------------------------------------------------
# worker health / elasticity


class NoHealthyWorkersError(RuntimeError):
    """Every worker in the pool has been dropped — training cannot proceed.
    Raised instead of hanging on an averaging barrier no one will reach."""


class WorkerFailureError(RuntimeError):
    """A shard kept failing across re-dispatches (bounded attempts
    exhausted); the last worker exception is chained as __cause__."""


class NonFiniteWorkerResultError(RuntimeError):
    """A worker shipped back non-finite parameters or updater state — a
    replica that diverged (NaN gradient, poisoned shard data). The result
    is quarantined (it never reaches the average: one NaN replica would
    poison every parameter of the merged model) and the shard is treated
    exactly like a failed shard: re-dispatched to a surviving worker
    under the usual retry/backoff/drop discipline."""


class _WindowAbort(Exception):
    """Internal: a worker was dropped mid-window. Nothing has been committed
    to the master net yet, so the window repartitions over the surviving
    workers and re-runs from the same master parameters."""


class _ShardAbandoned(Exception):
    """Internal: raised inside an orphaned shard thread (its result was
    discarded after a timeout/abort) so it stops training dead weight,
    frees its pool slot, and stops stamping heartbeats for a worker the
    master no longer trusts."""


@dataclass
class WorkerHealth:
    """Per-worker liveness record the master keeps across averaging windows
    and epochs (the elastic layer's analogue of Spark's executor liveness
    view, which the reference delegates to the cluster manager)."""

    worker_id: int
    alive: bool = True
    consecutive_failures: int = 0
    total_failures: int = 0
    shards_completed: int = 0
    last_heartbeat_ms: Optional[int] = None
    last_error: Optional[str] = None


@dataclass
class _ShardTask:
    """One shard's dispatch bookkeeping inside a window."""

    index: int
    shard: List[DataSet]
    health: WorkerHealth
    attempts: int = 0
    queued_at: float = 0.0              # monotonic; set at submit
    started_at: Optional[float] = None  # monotonic; set by the pool thread
    not_before: float = 0.0             # monotonic; backoff gate for retry
    abandoned: bool = False             # result discarded; thread bails out

    def deadline(self, timeout: float) -> float:
        """Expiry instant: from actual start when the pool thread picked
        the task up, else from submit — a task that cannot even START
        within the timeout is starved by hung threads saturating the
        pool, and must count as a failure of its assigned worker (the
        drop path then converges to NoHealthyWorkersError instead of
        spinning forever waiting for a slot that will never free)."""
        return (self.started_at if self.started_at is not None
                else self.queued_at) + timeout


_worker_ctx = threading.local()


def current_worker_id() -> Optional[int]:
    """Worker id of the calling shard thread, or None outside a worker.
    The seam distributed fault injectors key on (see
    `parallel/fault_tolerance.WorkerCrashInjector`)."""
    return getattr(_worker_ctx, "worker_id", None)


# ---------------------------------------------------------------------------
# SPI


@dataclass
class TrainingResult:
    """What a worker ships back (reference `ExecuteWorkerFlatMap` returns
    (params, updaterState, score) via `ParameterAveragingTrainingResult`)."""

    params: np.ndarray  # flat parameter vector
    updater_state: Optional[np.ndarray]  # flat updater-state vector
    score: float
    num_examples: int


class TrainingHook:
    """Observer invoked around every worker minibatch (reference
    `spark/api/TrainingHook.java`: onTrainingStart/End and
    preUpdate/postUpdate — the seam the reference's parameter-server Spark
    integration plugs into, `ParameterServerTrainingHook.java`). Hooks run
    on worker shard threads, outside the compiled step; one worker instance
    serves all shards (unlike the reference, where each Spark executor
    deserializes its own worker copy). The hook LIST is snapshotted under a
    lock, but callbacks themselves run unlocked and may fire concurrently
    from different shard threads — a hook that blocks (e.g. a straggler
    injector sleeping) must not stall the other workers, so stateful hooks
    guard their own mutable state. `current_worker_id()` identifies the
    calling shard thread."""

    def on_training_start(self, net) -> None:
        pass

    def on_training_end(self, net) -> None:
        pass

    def pre_update(self, ds: DataSet, net) -> None:
        pass

    def post_update(self, ds: DataSet, net) -> None:
        pass


class TrainingWorker:
    """Per-executor training contract (reference
    `spark/api/TrainingWorker.java`)."""

    def __init__(self):
        self.training_hooks: List[TrainingHook] = []
        self._hook_lock = threading.RLock()

    def add_hook(self, hook: TrainingHook) -> None:
        """Reference `TrainingWorker.addHook`."""
        with self._hook_lock:
            self.training_hooks.append(hook)

    def remove_hook(self, hook: TrainingHook) -> None:
        with self._hook_lock:
            self.training_hooks.remove(hook)

    def _run_hooks(self, method: str, *args) -> None:
        with self._hook_lock:
            # snapshot under the lock (a hook may add/remove hooks), but
            # invoke OUTSIDE it: a blocking hook on one shard thread — a
            # SlowWorkerInjector, a network-backed PS hook mid-retry — must
            # not freeze every other worker's minibatch callbacks
            hooks = list(self.training_hooks)
        for h in hooks:
            getattr(h, method)(*args)

    def get_initial_model(self):
        raise NotImplementedError

    def process_minibatch(self, ds: DataSet, net, is_last: bool) -> None:
        raise NotImplementedError

    def get_final_result(self, net) -> TrainingResult:
        raise NotImplementedError


class TrainingMaster:
    """Distributed-training contract (reference
    `spark/api/TrainingMaster.java`): how to partition work, run workers,
    and combine results."""

    def execute_training(self, net, iterator: DataSetIterator) -> None:
        raise NotImplementedError

    def get_training_stats(self) -> Optional[TrainingStats]:
        return None


# ---------------------------------------------------------------------------
# parameter averaging


def _updater_leaves(net):
    """(layer key, parameter name, state name, tensor) of every updater
    state tensor in `ravel_pytree` order: layer order (a graph's nodes
    sorted by name), then sorted parameter names, then sorted state
    names."""
    from deeplearning4j_tpu_torch.nn.multilayer import _tree_items

    return [(key, name, sk, u[name][sk])
            for key, u in _tree_items(net.get_updater_state())
            for name in sorted(u) for sk in sorted(u[name])]


def _flat_updater_state(net) -> Optional[np.ndarray]:
    """The updater state as one flat host vector in the JAX package's
    order (so equal states average to equal moments in both packages),
    or None for a stateless updater."""
    leaves = _updater_leaves(net)
    if not leaves:
        return None
    return torch.cat([t.detach().reshape(-1) for *_, t in leaves]) \
        .cpu().numpy()


def _set_updater_state_flat(net, flat: np.ndarray) -> None:
    """Load a flat vector written by `_flat_updater_state` (possibly f64:
    an average) into fresh tensors on the network's device and dtype."""
    flat = torch.as_tensor(np.asarray(flat))
    off = 0
    for key, name, sk, t in _updater_leaves(net):
        n = t.numel()
        net._upd_state[key][name][sk] = flat[off:off + n].reshape(
            t.shape).to(device=net.device, dtype=t.dtype)
        off += n
    if off != flat.numel():
        raise ValueError(f"flat updater state has {flat.numel()} values; "
                         f"the network's has {off}")


def _host_params(net) -> np.ndarray:
    """The flat parameter vector (`params()` order) as a host array."""
    return net.params().detach().cpu().numpy()


class ParameterAveragingTrainingWorker(TrainingWorker):
    """Reference `ParameterAveragingTrainingWorker.java:162`
    (`processMinibatch` = net.fit(ds))."""

    def __init__(self, template_net):
        super().__init__()
        self._template = template_net

    def get_initial_model(self):
        net = self._template.clone()
        self._run_hooks("on_training_start", net)
        return net

    def process_minibatch(self, ds: DataSet, net, is_last: bool) -> None:
        self._run_hooks("pre_update", ds, net)
        net.fit(ds)
        self._run_hooks("post_update", ds, net)
        if is_last:
            self._run_hooks("on_training_end", net)

    def get_final_result(self, net) -> TrainingResult:
        return TrainingResult(params=_host_params(net),
                              updater_state=_flat_updater_state(net),
                              score=net.score_value or float("nan"),
                              num_examples=0)


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Synchronous coarse-grained data parallelism by parameter averaging
    (reference `ParameterAveragingTrainingMaster.java:75`).

    Stream is consumed in *averaging windows* of
    `num_workers × averaging_frequency` minibatches; each worker fits
    `averaging_frequency` of them on its own replica, then parameter vectors
    (and optionally updater state) are averaged and re-broadcast — the same
    schedule as the reference's `doIteration:647` → `processResults:767`
    (`results.aggregate(Add/Combine):772` → `params.divi(aggCount):783`).

    Elasticity (no reference analogue — Spark owned task retry there):

    - Every shard dispatch is watched: a worker that raises, or exceeds
      `worker_timeout` seconds on one shard, is marked failed and its shard
      is re-dispatched to a surviving worker after exponential backoff
      (`retry_backoff × backoff_multiplier^attempt`), with per-shard
      attempts bounded by `max_retries` re-dispatches. Set
      `worker_timeout` comfortably ABOVE the first step's latency: the
      first window may pay the kernels' nvcc build and the allocator's
      warm-up, and a too-tight timeout reads that as a straggler —
      training still
      completes (degradation is graceful), but with needlessly shed
      capacity.
    - A worker shipping back NON-FINITE parameters or updater state (a
      diverged replica: NaN gradient, poisoned shard data) is treated
      exactly like a crashed worker — the result is quarantined, never
      averaged in (one NaN replica would poison every merged parameter),
      and the shard re-dispatches (`NonFiniteWorkerResultError`, counted
      as `nonfinite_results` in `TrainingStats`).
    - A worker accumulating more than `max_retries` CONSECUTIVE failures is
      dropped from the pool; the in-flight window aborts (nothing was
      committed) and re-runs repartitioned over the survivors, so a
      degraded pool trains exactly like a master configured with the
      smaller worker count. An empty pool raises `NoHealthyWorkersError`.
    - Aggregation weights each worker result by its example count
      (`example_weighted=True`, the default) so uneven shards — tail
      windows, degraded pools — average correctly; equal shards reduce to
      the reference's plain `divi(aggCount)` mean. Pass False for the
      reference's unweighted behavior.
    - Per-worker `WorkerHealth` records (heartbeat stamped per minibatch
      from the configured `TimeSource`) persist across windows and epochs;
      failures/retries/drops also count into `TrainingStats` when
      `collect_training_stats=True`.
    """

    def __init__(self, num_workers: int, averaging_frequency: int = 5,
                 average_updaters: bool = True,
                 collect_training_stats: bool = False,
                 worker: Optional[TrainingWorker] = None,
                 repartition: Repartition = Repartition.ALWAYS,
                 repartition_strategy: RepartitionStrategy = RepartitionStrategy.ROUND_ROBIN,
                 rng_seed: Optional[int] = None,
                 worker_timeout: Optional[float] = None,
                 max_retries: int = 2,
                 retry_backoff: float = 0.05,
                 backoff_multiplier: float = 2.0,
                 example_weighted: bool = True,
                 time_source: Optional[TimeSource] = None):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if averaging_frequency < 1:
            raise ValueError("averaging_frequency must be >= 1")
        if worker_timeout is not None and worker_timeout <= 0:
            raise ValueError("worker_timeout must be positive (or None)")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.num_workers = num_workers
        self.averaging_frequency = averaging_frequency
        self.average_updaters = average_updaters
        self.repartition = repartition
        self.repartition_strategy = repartition_strategy
        self.worker_timeout = worker_timeout
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.backoff_multiplier = backoff_multiplier
        self.example_weighted = example_weighted
        self._rng_seed = rng_seed
        self._worker_factory = worker
        self._stats = TrainingStats() if collect_training_stats else None
        self._time_source = time_source or TimeSourceProvider.get_instance()
        self.worker_health: List[WorkerHealth] = [
            WorkerHealth(i) for i in range(num_workers)]

    # -- SPI ---------------------------------------------------------------
    def get_training_stats(self) -> Optional[TrainingStats]:
        return self._stats

    # -- health ------------------------------------------------------------
    def alive_workers(self) -> List[WorkerHealth]:
        return [h for h in self.worker_health if h.alive]

    def reset_worker_health(self) -> None:
        """Re-admit every worker (e.g. after replacing failed hardware)."""
        self.worker_health = [WorkerHealth(i)
                              for i in range(self.num_workers)]

    def worker_heartbeat_age_ms(self, worker_id: int) -> Optional[int]:
        """Milliseconds since `worker_id` last finished a minibatch, or
        None if it never heartbeat."""
        hb = self.worker_health[worker_id].last_heartbeat_ms
        if hb is None:
            return None
        return self._time_source.current_time_millis() - hb

    def _heartbeat(self, worker_id: int) -> None:
        self.worker_health[worker_id].last_heartbeat_ms = (
            self._time_source.current_time_millis())

    def execute_training_paths(self, net, paths) -> None:
        """Train from EXPORTED dataset shards (files written by
        `parallel/export.batch_and_export`) — the reference's second RDD
        training approach (`RDDTrainingApproach.Export`,
        `executeTrainingPathsHelper:506`): workers stream batches from
        paths one file at a time, so the training set never has to fit in
        memory. Same averaging schedule as `execute_training`."""
        from deeplearning4j_tpu_torch.datasets.iterators import (
            FileDataSetIterator,
        )

        self.execute_training(net, FileDataSetIterator(paths))

    def execute_training(self, net, iterator: DataSetIterator) -> None:
        net._ensure_init()
        worker = self._worker_factory or ParameterAveragingTrainingWorker(net)
        window = self.num_workers * self.averaging_frequency
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            batches: List[DataSet] = []
            for ds in iterator:
                batches.append(ds)
                if len(batches) == window:
                    self._do_iteration(net, worker, batches, pool)
                    batches = []
            if batches:  # tail window (reference tolerates short splits)
                self._do_iteration(net, worker, batches, pool)
        finally:
            # don't block on a hung straggler thread: shards that matter
            # were already awaited (with timeout) inside the window loop
            pool.shutdown(wait=False)

    # -- internals ---------------------------------------------------------
    def _partition(self, batches: Sequence[DataSet],
                   n_workers: int) -> List[List[DataSet]]:
        """Split one window's batches over `n_workers` (reference
        balancedRandomSplit + repartition)."""
        if should_repartition(len(batches), n_workers, self.repartition):
            return balanced_partitions(batches, n_workers,
                                       self.repartition_strategy,
                                       seed=self._rng_seed)
        # keep arrival-order contiguous chunks (no data movement)
        return balanced_partitions(batches, n_workers,
                                   RepartitionStrategy.BALANCED, seed=0)

    def _do_iteration(self, net, worker: TrainingWorker,
                      batches: Sequence[DataSet],
                      pool: ThreadPoolExecutor) -> None:
        """One averaging window (reference `doIteration:647`), re-run over
        the surviving pool whenever a worker is dropped mid-window."""
        stats = self._stats
        while True:
            alive = self.alive_workers()
            if not alive:
                raise NoHealthyWorkersError(
                    f"all {self.num_workers} workers have been dropped "
                    f"(per-worker failures: "
                    f"{[h.total_failures for h in self.worker_health]}) — "
                    "no healthy worker left to train on")
            with (stats.timer("split") if stats else _nullcontext()):
                shards = self._partition(batches, len(alive))
            try:
                with (stats.timer("fit") if stats else _nullcontext()):
                    results = self._run_window(worker, shards, alive, pool)
                break
            except _WindowAbort:
                if stats:
                    stats.increment("window_reruns")
                logger.warning(
                    "averaging window aborted (worker dropped); re-running "
                    "over %d surviving workers", len(self.alive_workers()))

        with (stats.timer("aggregate") if stats else _nullcontext()):
            # example-weighted average so uneven shards (tail windows,
            # degraded pools) combine correctly; with equal shard sizes this
            # IS the reference's plain mean (`processResults:767-783`:
            # aggregate add + divi by count), which `example_weighted=False`
            # restores exactly
            weights = None
            if self.example_weighted:
                w = np.asarray([r.num_examples for r in results], np.float64)
                if w.sum() > 0:
                    weights = w
            params = np.average([r.params for r in results], axis=0,
                                weights=weights)
            upd = None
            if self.average_updaters:
                vs = [r.updater_state for r in results]
                if all(v is not None for v in vs) and vs:
                    upd = np.average(vs, axis=0, weights=weights)

        with (stats.timer("broadcast") if stats else _nullcontext()):
            net.set_params(params)
            if upd is not None:
                _set_updater_state_flat(net, upd)
        net.score_value = float(np.average([r.score for r in results],
                                           weights=weights))
        # master clock advances by the longest worker shard (= the number of
        # sequential optimizer steps this window represents)
        net.iteration += max(len(s) for s in shards)
        for listener in getattr(net, "listeners", []):
            listener.iteration_done(net, net.iteration)

    # -- elastic window execution ------------------------------------------
    def _run_shard(self, worker: TrainingWorker,
                   task: _ShardTask) -> TrainingResult:
        task.started_at = time.monotonic()
        wid = task.health.worker_id
        _worker_ctx.worker_id = wid
        self._heartbeat(wid)
        try:
            wnet = worker.get_initial_model()
            n = 0
            for j, ds in enumerate(task.shard):
                if task.abandoned:
                    # orphaned (timed out / window aborted): stop training
                    # dead weight, free the slot, and above all stop
                    # stamping heartbeats the master would misread as the
                    # dropped worker being healthy
                    raise _ShardAbandoned(f"shard {task.index}")
                worker.process_minibatch(ds, wnet, j == len(task.shard) - 1)
                n += ds.num_examples()
                if not task.abandoned:
                    self._heartbeat(wid)
            result = worker.get_final_result(wnet)
            result.num_examples = n
            self._check_result_finite(result, wid, task.index)
            return result
        finally:
            _worker_ctx.worker_id = None

    @staticmethod
    def _check_result_finite(result: TrainingResult, worker_id: int,
                             shard_index: int) -> None:
        """Quarantine gate on the averaging input: a worker returning
        non-finite params/updater state is a FAILED shard (raises
        `NonFiniteWorkerResultError` → retry/backoff/drop machinery),
        never averaged in. The score is deliberately not checked — a
        worker that never scored reports NaN score with finite params,
        and the average ignores it."""
        bad = None
        if not np.all(np.isfinite(result.params)):
            bad = "parameters"
        elif result.updater_state is not None \
                and not np.all(np.isfinite(result.updater_state)):
            bad = "updater state"
        if bad is not None:
            logger.warning(
                "quarantining non-finite result from worker %d (shard "
                "%d): %s contain NaN/Inf — never averaged in;"
                " re-dispatching", worker_id, shard_index, bad)
            raise NonFiniteWorkerResultError(
                f"worker {worker_id} returned non-finite {bad} for shard "
                f"{shard_index} — result quarantined, shard re-dispatched")

    def _run_window(self, worker: TrainingWorker,
                    shards: List[List[DataSet]],
                    alive: List[WorkerHealth],
                    pool: ThreadPoolExecutor) -> List[TrainingResult]:
        """Dispatch shards, await with per-shard timeout, retry/re-dispatch
        failures, drop repeat offenders (raising `_WindowAbort`)."""
        results: List[Optional[TrainingResult]] = [None] * len(shards)
        inflight: Dict[Future, _ShardTask] = {}
        pending: List[_ShardTask] = []  # retries gated by backoff not_before
        for health, (i, shard) in zip(alive, enumerate(shards)):
            task = _ShardTask(i, shard, health, queued_at=time.monotonic())
            inflight[pool.submit(self._run_shard, worker, task)] = task
        try:
            self._watch_window(worker, pool, results, inflight, pending)
        except Exception:
            # window abort / give-up: whatever is still running is dead
            # weight — tell those threads to bail out and stop heartbeating
            for t in inflight.values():
                t.abandoned = True
            raise
        return results  # type: ignore[return-value]  # all slots filled

    def _watch_window(self, worker: TrainingWorker,
                      pool: ThreadPoolExecutor,
                      results: List[Optional[TrainingResult]],
                      inflight: Dict[Future, _ShardTask],
                      pending: List[_ShardTask]) -> None:
        while inflight or pending:
            now = time.monotonic()
            for task in [t for t in pending if now >= t.not_before]:
                pending.remove(task)
                task.started_at = None
                task.queued_at = time.monotonic()
                inflight[pool.submit(self._run_shard, worker, task)] = task
            if not inflight:  # only backoff-gated retries remain
                time.sleep(max(0.0, min(t.not_before for t in pending) - now))
                continue
            done, _ = _futures_wait(
                set(inflight),
                timeout=self._wait_timeout(inflight, pending),
                return_when=FIRST_COMPLETED)
            now = time.monotonic()
            expired: List[Future] = []
            if not done and self.worker_timeout is not None:
                # a future that completed between the wait and this check
                # is NOT expired — its (successful) result is harvested on
                # the next loop pass instead of being discarded and
                # charged to the worker as a phantom failure
                expired = [f for f, t in inflight.items()
                           if now >= t.deadline(self.worker_timeout)
                           and not f.done()]
                if not expired:
                    continue
            for f in done:
                task = inflight.pop(f)
                exc = f.exception()
                if exc is None:
                    results[task.index] = f.result()
                    task.health.consecutive_failures = 0
                    task.health.shards_completed += 1
                else:
                    self._on_shard_failure(task, exc, timed_out=False)
                    self._schedule_retry(task, pending, exc)
            for f in expired:
                task = inflight.pop(f)
                f.cancel()  # a queued task is cancelled outright; a running
                task.abandoned = True  # thread bails at its next minibatch
                exc = TimeoutError(
                    f"worker {task.health.worker_id} exceeded "
                    f"worker_timeout={self.worker_timeout}s on shard "
                    f"{task.index}")
                self._on_shard_failure(task, exc, timed_out=True)
                self._schedule_retry(task, pending, exc)

    def _wait_timeout(self, inflight: Dict[Future, _ShardTask],
                      pending: List[_ShardTask]) -> Optional[float]:
        now = time.monotonic()
        wakeups = [t.not_before for t in pending]
        if self.worker_timeout is not None:
            wakeups += [t.deadline(self.worker_timeout)
                        for t in inflight.values()]
        if not wakeups:
            return None
        return max(0.0, min(wakeups) - now)

    def _on_shard_failure(self, task: _ShardTask, exc: BaseException,
                          timed_out: bool) -> None:
        h = task.health
        task.attempts += 1
        h.consecutive_failures += 1
        h.total_failures += 1
        h.last_error = f"{type(exc).__name__}: {exc}"
        if self._stats:
            self._stats.increment("worker_failures")
            if timed_out:
                self._stats.increment("worker_timeouts")
            if isinstance(exc, NonFiniteWorkerResultError):
                self._stats.increment("nonfinite_results")
        logger.warning(
            "worker %d %s on shard %d (shard attempt %d, consecutive "
            "worker failures %d/%d): %s",
            h.worker_id, "timed out" if timed_out else "failed", task.index,
            task.attempts, h.consecutive_failures, self.max_retries + 1,
            h.last_error)
        if h.consecutive_failures > self.max_retries:
            h.alive = False
            if self._stats:
                self._stats.increment("workers_dropped")
            logger.warning(
                "worker %d dropped after %d consecutive failures; pool "
                "shrinks to %d healthy workers",
                h.worker_id, h.consecutive_failures,
                len(self.alive_workers()))
            raise _WindowAbort(task.index)

    def _schedule_retry(self, task: _ShardTask, pending: List[_ShardTask],
                        exc: BaseException) -> None:
        """Queue the failed shard for re-dispatch to a surviving worker
        once its exponential backoff elapses. The backoff is a not-before
        gate consumed by the watch loop, NOT a sleep here — sleeping
        would stall harvesting/timeout detection for every other
        in-flight shard."""
        if task.attempts > self.max_retries:
            raise WorkerFailureError(
                f"shard {task.index} failed {task.attempts} times across "
                f"re-dispatches (max_retries={self.max_retries}); last "
                f"error: {type(exc).__name__}: {exc}") from exc
        alive = self.alive_workers()
        if not alive:
            raise NoHealthyWorkersError(
                "no healthy worker left to re-dispatch shard "
                f"{task.index} to") from exc
        # prefer a DIFFERENT surviving worker; fall back to the same one
        # when it is the only survivor
        candidates = [h for h in alive if h is not task.health] or alive
        target = candidates[(task.attempts - 1) % len(candidates)]
        delay = self.retry_backoff * (self.backoff_multiplier
                                      ** (task.attempts - 1))
        if self._stats:
            self._stats.increment("worker_retries")
        logger.warning(
            "re-dispatching shard %d to worker %d after %.3fs backoff "
            "(attempt %d/%d)", task.index, target.worker_id, delay,
            task.attempts + 1, self.max_retries + 1)
        # a FRESH task object: the old one may still be held by an orphaned
        # thread whose bail-out check must not observe the retry's state
        pending.append(_ShardTask(task.index, task.shard, target,
                                  attempts=task.attempts,
                                  not_before=time.monotonic() + delay))


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# user-facing wrappers (reference SparkDl4jMultiLayer / SparkComputationGraph)


class DistributedMultiLayer:
    """User-facing handle pairing a network with a TrainingMaster (reference
    `spark/impl/multilayer/SparkDl4jMultiLayer.java` — `fit(RDD):216` →
    `trainingMaster.executeTraining:220`).

    evaluate / calculate_score / score_examples genuinely DISTRIBUTE (r5):
    batches shard round-robin over the master's worker pool, each worker
    evaluates its shard on its own replica (the reference broadcasts the
    net to executors the same way), and per-worker results merge —
    `Evaluation.merge` for evaluate (reference
    `SparkDl4jMultiLayer.evaluate:511-528` → `IEvaluation.merge`),
    example-weighted score sums for calculate_score (`calculateScore:382`),
    order-restoring concatenation for score_examples
    (`scoreExamples:382-416`)."""

    def __init__(self, net, training_master: TrainingMaster):
        self.net = net
        self.training_master = training_master
        # distributed-evaluate replica cache: clones persist across
        # _shard_map calls and are pointed at the net's CURRENT params
        # and layer state before each use (see _replicas_for)
        self._replica_cache: list = []

    def _num_workers(self) -> int:
        return getattr(self.training_master, "num_workers", 4)

    def fit(self, data, epochs: int = 1):
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])
        for _ in range(epochs):
            data.reset()
            self.training_master.execute_training(self.net, data)
            self.net.epoch += 1
        return self.net

    # -- distributed inference-side operations -----------------------------
    def _shard_map(self, data, per_batch_fn):
        """Round-robin the iterator's batches over worker threads, each
        holding its own replica; returns [(batch_index, result)] in
        arbitrary completion order. The replica clone mirrors the
        reference's per-executor deserialized network copy."""
        if isinstance(data, (DataSet, MultiDataSet)):
            data = ListDataSetIterator([data])
        batches = list(data)
        n_workers = max(1, min(self._num_workers(), len(batches) or 1))
        if n_workers == 1:
            # single shard: evaluate on the net itself — no clone, no pool
            # (score(ds) and per-epoch calculator loops stay cheap)
            return [(idx, per_batch_fn(self.net, ds))
                    for idx, ds in enumerate(batches)]
        replicas = self._replicas_for(n_workers)
        shards = [[] for _ in range(n_workers)]
        for idx, ds in enumerate(batches):
            shards[idx % n_workers].append((idx, ds))

        def run_shard(wi):
            return [(idx, per_batch_fn(replicas[wi], ds))
                    for idx, ds in shards[wi]]

        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            out = []
            for part in pool.map(run_shard, range(n_workers)):
                out.extend(part)
        return out

    def _replicas_for(self, n_workers: int) -> list:
        """Cached per-worker replica clones: one `net.clone()` per worker
        for the whole life of the handle, not one per `_shard_map` call
        (an early-stopping loop evaluates every epoch). Before each use
        every replica is pointed at the net's current parameter and
        layer-state trees, so it needs no param copy: the net's training
        step updates its parameters in place and replaces its layer
        state, and a repoint costs two assignments. Aliasing is safe:
        replicas only ever evaluate, which reads the trees."""
        if len(self._replica_cache) < n_workers:
            self._replica_cache.extend(
                self.net.clone()
                for _ in range(n_workers - len(self._replica_cache)))
        for replica in self._replica_cache:
            replica._params = self.net._params
            replica._layer_state = self.net._layer_state
        return self._replica_cache[:n_workers]

    def evaluate(self, data, labels: Optional[List[str]] = None,
                 top_n: int = 1):
        """Cluster-style evaluation: per-shard `Evaluation`s merged into
        one (reference `SparkDl4jMultiLayer.evaluate:511-528`). Confusion
        counts are additive, so the merged result equals single-device
        `net.evaluate` on the same data exactly."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        def eval_batch(replica, ds):
            # the replica's own evaluate handles container specifics
            # (MultiDataSet inputs, masks) for both MLN and CG
            return replica.evaluate(ds, labels=labels, top_n=top_n)

        merged = Evaluation(labels=labels, top_n=top_n)
        for _, ev in sorted(self._shard_map(data, eval_batch)):
            merged.merge(ev)
        return merged

    def calculate_score(self, data, average: bool = True) -> float:
        """Loss over the full dataset, computed shard-parallel and combined
        example-weighted (reference `SparkDl4jMultiLayer.calculateScore:382`
        — sum of per-partition scores, optionally / total examples)."""
        results = self._shard_map(
            data, lambda replica, ds: (replica.score(ds) * ds.num_examples(),
                                       ds.num_examples()))
        total = sum(s for _, (s, _) in results)
        n = sum(n for _, (_, n) in results)
        return float(total / n) if average and n else float(total)

    def score(self, ds) -> float:
        """Mean loss on one batch (reference `SparkDl4jMultiLayer.score`)."""
        return self.calculate_score(ds, average=True)

    def score_examples(self, data,
                       add_regularization: bool = False) -> np.ndarray:
        """Per-example scores over the dataset, shard-parallel, returned in
        the ORIGINAL example order (reference
        `SparkDl4jMultiLayer.scoreExamples:382-416`), as a host array."""
        results = self._shard_map(
            data,
            lambda replica, ds: replica.score_examples(
                ds, add_regularization=add_regularization)
            .detach().cpu().numpy())
        return np.concatenate([r for _, r in sorted(results)]) \
            if results else np.zeros((0,))

    def get_network(self):
        return self.net


class DistributedComputationGraph(DistributedMultiLayer):
    """Reference `spark/impl/graph/SparkComputationGraph.java`."""
