"""Replicated serving pool: health-probed replicas, failover routing,
hedged predicts, and zero-downtime rolling reload (counterpart of
`deeplearning4j_tpu/serving/replica_pool.py`).

One `ModelServer` is one failure domain: one breaker-open window, one
wedged reload, or one poisoned replica takes the whole service down.
`ReplicaPool` puts N servers behind one dispatch point, with the
server's robustness ladders applied per replica. On the card the
replicas of `from_net` share the device of the caller's network (each
holds its own parameters there), and every replica's engine runs the
paged-attention kernel; the pool itself is host bookkeeping.

- **least-loaded routing** — every request goes to the healthy replica
  with the smallest queued+in-flight load (`ModelServer.pending()`),
  ties broken round-robin so equal replicas share evenly.
- **health probing + passive eviction** — a daemon probe loop serves a
  canary batch through every replica each `probe_interval` (a
  generation-only pool auto-arms a one-token generation canary from
  its first served `generate` instead — see `_probe_generate`). A
  replica
  is EVICTED (no new traffic) when its probe fails, its breaker is
  open, it hangs past `watchdog_timeout` (the probe runs under a
  watchdog — a wedged device step cannot wedge the probe loop), or
  passive error tracking sees `evict_threshold` consecutive request
  failures (SICKNESS only — queue-full and deadline sheds are load and
  time signals, and must not evict a healthy-but-busy replica into a
  pool-wide cascade). An evicted replica is re-admitted only after
  `readmit_successes` CONSECUTIVE probe passes — flapping replicas
  stay out.
- **request failover** — a retryable typed failure
  (`ServiceUnavailableError`, `InferenceFailedError`, a replica-level
  queue-full, `ReplicaEvictedError`) is transparently re-routed to
  another healthy replica, up to `max_failovers` re-routes per
  request. Non-retryable give-ups propagate typed:
  `DeadlineExceededError` (the request ran out of time — another
  replica cannot give it back) and the POOL-level
  `ServerOverloadedError` from the shared admission budget
  (`admission_budget` bounds total in-flight across the pool, so N
  replicas cannot hoard N full queues of doomed work).
- **hedged predicts** (`hedge=True`) — when the primary replica has
  not answered within the hedge delay (an EWMA-tracked p95-style
  latency bound, or an explicit `hedge_delay`), the request is FIRED
  AGAIN on a second healthy replica; the first finite result wins and
  the loser is absorbed (its result discarded, its failure noted).
  A single slow or silently-wedged replica costs one hedge, not one
  ruined tail latency.
- **rolling reload** — `rolling_reload(source)` swaps new weights in
  replica-at-a-time: drain (stop routing, wait for pending work) →
  reload through the server's canary ladder (manifest verify + canary
  validation, old weights keep serving on rejection) → serve a probe
  successfully → re-admit, and only then the next replica. The other
  replicas carry the traffic, so a deploy is zero-downtime. If ANY
  replica's canary or post-reload probe fails, the WHOLE pool rolls
  back to the old weights (`ModelServer.restore_model`) — a bad
  checkpoint never takes traffic, not even on the replicas that
  individually accepted it. Quantized serving rides this ladder
  unchanged: replicas built with `quantize={"weights": ...}` quantize
  each reload candidate BEFORE canary validation and score it against
  the candidate's own full-precision outputs via the drift gates
  (`drift_gate={...}`, serving/quantize.py) — a quantization-broken
  candidate (clipped scales, outlier channels) is rejected exactly
  like a corrupt checkpoint and the pool rolls back free, with zero
  failed requests under live traffic (tests/test_quantize.py drill).
- **degraded mode** — with every replica evicted the pool serves the
  typed `ServiceUnavailableError` with `retry_after=probe_interval`
  and KEEPS PROBING: the moment replicas pass `readmit_successes`
  probes they rejoin and the pool recovers by itself.

`generate()` routes autoregressive generation (each replica's
lazily-built `DecodeEngine`) with the same least-loaded + failover
discipline — a generation request is seeded, so a failover re-send
recomputes identical tokens.

`stats()` aggregates per-replica `ModelServer.stats()` plus the pool
counters (`failovers`, `hedges_fired`, `hedge_wins`, `evictions`,
`readmissions`, `rolling_reloads`, `rollbacks`, `shed_overload`,
`shed_unavailable`) — the schema the gateway's `pool_stats` RPC
exposes and `tests/test_replica_pool.py` pins.

Chaos seams: `serving.chaos.ReplicaCrashInjector` (every step on one
replica raises — a dead process) and `ReplicaHangInjector` (steps
block — a wedged device) plug into a single replica's `infer_hooks`;
`ReloadCorruptionInjector` damages rolling-reload candidates per
replica. `tests/test_replica_pool.py` drives the ladders end to end.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.serving import observability
from deeplearning4j_tpu_torch.serving.kv_transfer import (
    KVTransferError,
    SlotMigratedError,
)
from deeplearning4j_tpu_torch.serving.model_server import (
    AutoscaleError,
    DeadlineExceededError,
    InferenceFailedError,
    ModelServer,
    ServerClosedError,
    ServerOverloadedError,
    ServiceUnavailableError,
    ServingError,
)
from deeplearning4j_tpu_torch.util.concurrency import assert_owned

logger = logging.getLogger("deeplearning4j_tpu_torch")


class ReplicaEvictedError(ServingError):
    """The chosen replica was evicted between routing and dispatch (or
    found evicted mid-flight). Retryable: the pool re-routes it to
    another healthy replica under the request's failover budget."""


# transport-level faults a KV handoff edge can surface when the victim
# is a remote replica whose adapter is gone (RemoteReplica maps live
# wire failures into the ServingError taxonomy; these cover a torn-down
# client): the fallback ladder treats them exactly like typed failures
_TRANSFER_FAULTS = (ConnectionError, TimeoutError, OSError)


def _tag(err: BaseException, replica_id: int) -> BaseException:
    """Stamp the originating replica on a typed error so failover
    accounting — and the gateway error payload — can name it."""
    err.replica_id = replica_id
    return err


class _Replica:
    """Pool-side bookkeeping around one `ModelServer`."""

    __slots__ = ("id", "server", "state", "consecutive_failures",
                 "probe_successes", "evictions", "stale")

    def __init__(self, replica_id: int, server):
        self.id = replica_id
        self.server = server
        self.state = "healthy"  # healthy | evicted | draining
        self.consecutive_failures = 0  # passive error tracking
        self.probe_successes = 0       # consecutive, while evicted
        self.evictions = 0
        # weights behind the pool's (a best-effort reload of this
        # evicted replica failed during a rolling deploy): probes must
        # NOT re-admit it, or the pool would split between versions
        self.stale = False

    def load(self) -> int:
        return self.server.pending()


class ReplicaPool:
    """N `ModelServer` replicas behind one dispatch point (see module
    docstring). Construct from ready servers, or `ReplicaPool.from_net`
    to clone one fitted net across N fresh servers."""

    _RETRYABLE = (ServiceUnavailableError, InferenceFailedError,
                  ReplicaEvictedError)

    def __init__(self, replicas: Sequence, *,
                 probe_batch: Optional[np.ndarray] = None,
                 probe_interval: float = 1.0,
                 probe_timeout: Optional[float] = 5.0,
                 watchdog_timeout: float = 10.0,
                 evict_threshold: int = 3,
                 readmit_successes: int = 2,
                 max_failovers: int = 2,
                 admission_budget: Optional[int] = None,
                 hedge: bool = False,
                 hedge_delay: Optional[float] = None,
                 default_timeout: Optional[float] = None,
                 prefix_directory=None,
                 affinity_margin: int = 2):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("a replica pool needs at least one replica")
        if probe_interval <= 0:
            raise ValueError("probe_interval must be > 0")
        if watchdog_timeout <= 0:
            raise ValueError("watchdog_timeout must be > 0")
        if evict_threshold < 1:
            raise ValueError("evict_threshold must be >= 1")
        if readmit_successes < 1:
            raise ValueError("readmit_successes must be >= 1")
        if max_failovers < 0:
            raise ValueError("max_failovers must be >= 0")
        self._replicas: List[_Replica] = [
            _Replica(i, srv) for i, srv in enumerate(replicas)]
        self._probe_batch = None if probe_batch is None \
            else np.asarray(probe_batch)  # guarded by: _lock
        self._probe_gen = None  # generation canary prompt; guarded by: _lock
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.watchdog_timeout = watchdog_timeout
        self.evict_threshold = evict_threshold
        self.readmit_successes = readmit_successes
        self.max_failovers = max_failovers
        # shared admission budget: total in-flight requests across the
        # POOL. Default = the sum of replica queue capacities — the work
        # the pool could genuinely absorb with every replica healthy;
        # with replicas evicted the budget does NOT grow, so overload is
        # shed at the pool door instead of N queues' worth piling onto
        # the survivors
        self.admission_budget = (
            sum(getattr(r, "max_queue", 64) for r in replicas)
            if admission_budget is None else admission_budget)
        if self.admission_budget < 1:
            raise ValueError("admission_budget must be >= 1")
        self.hedge = hedge
        self.hedge_delay = hedge_delay
        self.default_timeout = default_timeout
        self._lock = threading.Lock()
        self._rr = itertools.count()  # round-robin tiebreak
        self._in_flight = 0  # guarded by: _lock
        self._closed = False  # guarded by: _lock
        # EWMA of successful predict latency + its absolute deviation:
        # the auto hedge delay is ewma + 4·dev, a cheap p95-style upper
        # bound that adapts to the model without a histogram
        self._lat_ewma = 0.05  # guarded by: _lock
        self._lat_dev = 0.025  # guarded by: _lock
        # pool counters (the stats()/gateway contract)
        self.served = 0  # guarded by: _lock
        self.failovers = 0  # guarded by: _lock
        self.hedges_fired = 0  # guarded by: _lock
        self.hedge_wins = 0  # guarded by: _lock
        self.evictions = 0  # guarded by: _lock
        self.readmissions = 0  # guarded by: _lock
        self.rolling_reloads = 0  # guarded by: _lock
        self.rollbacks = 0  # guarded by: _lock
        self.shed_overload = 0  # guarded by: _lock
        self.shed_unavailable = 0  # guarded by: _lock
        self.replicas_added = 0  # guarded by: _lock
        self.replicas_removed = 0  # guarded by: _lock
        self.migrations = 0  # guarded by: _lock
        self.migration_fallbacks = 0  # guarded by: _lock
        # cluster-global prefix cache: a shared PrefixDirectory makes a
        # prompt prefix prefilled on ANY replica fetchable (in-process
        # servers bind their engines as publishers+fetchers; remote
        # replicas publish via `refresh_prefix_directory` pull) and
        # steers dispatch toward holders within `affinity_margin`
        # pending requests of the least-loaded replica
        self._prefix_directory = prefix_directory
        self._affinity_margin = int(affinity_margin)
        self.affinity_routes = 0  # guarded by: _lock
        # observability: the pool keeps its own registry + recorder for
        # routing-layer views (failovers, hedges, probe verdicts,
        # evictions, reloads); each replica's ModelServer keeps its own
        # pair — `flight_record()` / `metrics_text()` merge both levels
        self.metrics = observability.MetricsRegistry()
        self.recorder = observability.FlightRecorder()
        self.metrics.register_stats("replica_pool", self.stats)
        self._pool_latency_hist = self.metrics.histogram(
            "replica_pool_predict_latency_ms")
        self.metrics.gauge("replica_pool_in_flight",
                           lambda: self._in_flight)
        self.metrics.gauge("replica_pool_healthy_replicas",
                           self.healthy_replicas)
        for rep in self._replicas:
            self._bind_prefix(rep)
        self._reload_lock = threading.Lock()
        self._probe_wake = threading.Event()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True, name="replica-pool-probe")
        self._probe_thread.start()

    @classmethod
    def from_net(cls, net, n_replicas: int, *,
                 server_kwargs: Optional[dict] = None,
                 **pool_kwargs) -> "ReplicaPool":
        """Clone `net` across `n_replicas` fresh `ModelServer`s (each
        replica owns its own parameters, so a poisoned or hot-reloaded
        replica never aliases another's weights) and pool them."""
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        kw = dict(server_kwargs or {})
        nets = [net] + [net.clone() for _ in range(n_replicas - 1)]
        return cls([ModelServer(n, **kw) for n in nets], **pool_kwargs)

    # -- observability -----------------------------------------------------
    @property
    def net(self):
        """The first healthy replica's live model (read-only peek — the
        gateway keeps its model registry pointed at served weights)."""
        for rep in self._replicas:
            if rep.state == "healthy":
                return rep.server.net
        return self._replicas[0].server.net

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    def healthy_replicas(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if r.state == "healthy")

    def stats(self) -> dict:
        with self._lock:
            per_replica = {}
            healthy = 0
            for rep in self._replicas:
                healthy += rep.state == "healthy"
                s = rep.server.stats()
                s["state"] = rep.state
                s["consecutive_failures"] = rep.consecutive_failures
                s["evictions"] = rep.evictions
                s["stale"] = rep.stale
                # string keys: JSON object keys are strings, so the
                # in-process contract and the gateway `pool_stats` RPC
                # must agree — int keys would silently become "0"/"1"
                # over the wire
                per_replica[str(rep.id)] = s
            return {
                "n_replicas": len(self._replicas),
                "healthy_replicas": healthy,
                "pool_in_flight": self._in_flight,
                "admission_budget": self.admission_budget,
                "served": self.served,
                "failovers": self.failovers,
                "hedges_fired": self.hedges_fired,
                "hedge_wins": self.hedge_wins,
                "evictions": self.evictions,
                "readmissions": self.readmissions,
                "rolling_reloads": self.rolling_reloads,
                "rollbacks": self.rollbacks,
                "shed_overload": self.shed_overload,
                "shed_unavailable": self.shed_unavailable,
                "replicas_added": self.replicas_added,
                "replicas_removed": self.replicas_removed,
                "migrations": self.migrations,
                "migration_fallbacks": self.migration_fallbacks,
                "affinity_routes": self.affinity_routes,
                "directory_entries": (
                    0 if self._prefix_directory is None else
                    self._prefix_directory.stats()["directory_entries"]),
                "ewma_latency_ms": round(1e3 * self._lat_ewma, 3),
                "replicas": per_replica,
            }

    def flight_record(self) -> dict:
        """Two-level dump: the pool's own ring (routing decisions,
        failovers, hedges, probe verdicts, evictions, reload events)
        plus every replica's `ModelServer.flight_record()` (string
        replica-id keys — the same JSON-safe contract as `stats`)."""
        return {
            "pool": self.recorder.dump(),
            "replicas": {str(rep.id): rep.server.flight_record()
                         for rep in self._replicas},
        }

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def metrics_text(self, labels=None) -> str:
        """One Prometheus text page for the whole pool: the pool's own
        instruments plus each replica's exposition labeled
        ``{replica="<id>"}`` (merged with caller `labels`, e.g. the
        gateway's ``{"model": name}``)."""
        parts = [self.metrics.exposition(labels=labels)]
        for rep in self._replicas:
            parts.append(rep.server.metrics.exposition(
                labels=dict(labels or {}, replica=str(rep.id))))
        return "".join(parts)

    def _shed_obs(self, trace, err: BaseException,
                  kind: str = "predict") -> None:
        """Pool-door shed / terminal failure: stamp the timeline, attach
        it to the typed error, pin it in the pool's failures ring."""
        decision = type(err).__name__
        trace.finish(decision)
        observability.attach_trace(err, trace)
        self.recorder.record(trace, decision, kind=kind)

    # -- cluster prefix cache ----------------------------------------------
    def _bind_prefix(self, rep: _Replica) -> None:
        """Join `rep`'s engine to the pool's prefix directory (no-op
        without a directory, or for adapters — remote replicas — that
        cannot bind an in-process object; those publish via
        `refresh_prefix_directory` instead)."""
        if self._prefix_directory is None:
            return
        bind = getattr(rep.server, "bind_prefix_directory", None)
        if bind is None:
            return
        bind(self._prefix_directory, f"replica-{rep.id}",
             peers=self._holder_peer)

    def _holder_peer(self, holder_id: str):
        """Resolve a directory holder id back to a live server — the
        peers hook engines use to fetch prefix pages. Only healthy
        replicas resolve: a fetch must not land on an evicted host."""
        try:
            rid = int(str(holder_id).rsplit("-", 1)[1])
        except (IndexError, ValueError):
            return None
        with self._lock:
            for rep in self._replicas:
                if rep.id == rid and rep.state == "healthy":
                    return rep.server
        return None

    def refresh_prefix_directory(self) -> int:
        """Pull-mode publication for replicas whose engines cannot push
        into the shared directory (remote processes behind the RPC
        adapter): snapshot each healthy replica's resident chains and
        publish them under its holder id, refreshing TTLs. Returns the
        number of chain keys published. In-process replicas publish
        synchronously on promotion; calling this for them is a harmless
        TTL refresh."""
        if self._prefix_directory is None:
            return 0
        with self._lock:
            reps = [(rep.id, rep.server) for rep in self._replicas
                    if rep.state == "healthy"]
        published = 0
        for rid, srv in reps:
            fn = getattr(srv, "prefix_chains", None)
            if fn is None:
                continue
            try:
                snap = fn()
            except ServingError:
                continue  # unreachable replica: its entries age out
            if not snap or not snap.get("chains"):
                continue
            self._prefix_directory.publish(
                snap["weight_version"], snap["page_size"],
                snap["chains"], f"replica-{rid}")
            published += len(snap["chains"])
        return published

    # -- routing -----------------------------------------------------------
    def _pick(self, exclude=(), prompt=None,
              tenant=None) -> Optional[_Replica]:
        """Least-loaded healthy replica, preferring ones not in
        `exclude` (already failed this request); when every healthy
        replica has been tried, re-allow them — a half-open breaker may
        admit the retry. None = no healthy replica at all. With a
        prefix directory bound and a `prompt` given, a replica holding
        the prompt's deepest cached chain wins the pick when its load
        is within `affinity_margin` of the least-loaded candidate —
        hot prefixes concentrate instead of replicating pool-wide."""
        with self._lock:
            healthy = [r for r in self._replicas if r.state == "healthy"]
            if not healthy:
                return None
            fresh = [r for r in healthy if r.id not in exclude]
            pool = fresh or healthy
        affine = self._affine(pool, prompt, tenant)
        if affine is not None:
            return affine
        # tiebreak on the INDEX within the candidate list (an id-based
        # key collapses to a constant when the surviving ids are
        # congruent mod the pool size, pinning tied traffic to one
        # replica)
        rr = next(self._rr)
        best = min(range(len(pool)),
                   key=lambda i: (pool[i].load(), (i - rr) % len(pool)))
        return pool[best]

    def _affine(self, pool, prompt, tenant) -> Optional[_Replica]:
        if self._prefix_directory is None or prompt is None:
            return None
        hit = self._prefix_directory.best_holder(
            np.asarray(prompt), tenant)
        if hit is None:
            return None
        ids = set()
        for holder in hit["holders"]:
            try:
                ids.add(int(str(holder).rsplit("-", 1)[1]))
            except (IndexError, ValueError):
                continue
        holders = [r for r in pool if r.id in ids]
        if not holders:
            return None
        loads = {r.id: r.load() for r in pool}
        floor = min(loads.values())
        best = min((r for r in holders
                    if loads[r.id] <= floor + self._affinity_margin),
                   key=lambda r: loads[r.id], default=None)
        if best is None:
            return None  # holder too busy: load beats affinity
        with self._lock:
            self.affinity_routes += 1
        self.recorder.event("affinity-route", replica=best.id,
                            depth_pages=hit["depth"],
                            pending=loads[best.id])
        return best

    def _degraded(self) -> ServiceUnavailableError:
        with self._lock:
            self.shed_unavailable += 1
        return ServiceUnavailableError(
            "no healthy replica in the pool (all evicted); probing "
            f"continues — retry in {self.probe_interval:.3f}s",
            retry_after=self.probe_interval)

    def _note_failure(self, rep: _Replica, err: BaseException) -> None:
        """Passive error tracking: consecutive request failures evict —
        the probe loop is not the only path off a sick replica."""
        with self._lock:
            rep.consecutive_failures += 1
            if rep.state == "healthy" and \
                    rep.consecutive_failures >= self.evict_threshold:
                self._evict_locked(rep, f"{type(err).__name__} x"
                                        f"{rep.consecutive_failures}")

    def _note_success(self, rep: _Replica,
                      latency: Optional[float] = None) -> None:
        """Reset the replica's failure streak; fold `latency` into the
        PREDICT latency EWMA when given. Generation successes pass None
        — a multi-second generate folded into the predict EWMA would
        blow up the auto hedge delay and the admission retry_after
        hints for millisecond predicts."""
        with self._lock:
            rep.consecutive_failures = 0
            if latency is not None:
                err = abs(latency - self._lat_ewma)
                self._lat_ewma = 0.8 * self._lat_ewma + 0.2 * latency
                self._lat_dev = 0.8 * self._lat_dev + 0.2 * err

    def _evict_locked(self, rep: _Replica, reason: str) -> None:
        assert_owned(self._lock, "ReplicaPool._evict_locked")
        if rep.state != "healthy":
            return
        rep.state = "evicted"
        rep.probe_successes = 0
        rep.evictions += 1
        self.evictions += 1
        if self._prefix_directory is not None:
            # an evicted host must stop attracting affinity routes and
            # fetches NOW, not a TTL later (directory has its own leaf
            # lock; it never calls back into the pool)
            self._prefix_directory.drop_holder(f"replica-{rep.id}")
        self.recorder.event("evict", replica=rep.id, reason=reason)
        logger.warning("replica pool: evicted replica %d (%s)",
                       rep.id, reason)

    def _restore_or_evict(self, rep: _Replica, old_net) -> bool:
        """Restore `rep` to `old_net`, treating a failed restore as a
        dead replica rather than a failed deploy: evict it (whatever
        state it is in — rollback reaches replicas mid-"draining") and
        mark it stale, because its weights are now UNKNOWN (the swap
        may have landed while the restore did not) and re-admitting it
        unreloaded could split the pool between versions. Remote
        replicas make this path real — a peer process can die between
        its reload and the pool-wide unwind. Returns True when the
        restore landed."""
        try:
            rep.server.restore_model(old_net)
            return True
        # rollback edge: the restore's
        # own failure has no caller to type for — the recovery IS
        # evict+stale, and the deploy error already propagating must
        # not be displaced by this secondary one
        except BaseException as e:
            with self._lock:
                if rep.state != "evicted":
                    rep.state = "evicted"
                    rep.probe_successes = 0
                    rep.evictions += 1
                    self.evictions += 1
                    self.recorder.event(
                        "evict", replica=rep.id,
                        reason=f"rollback restore failed: "
                               f"{type(e).__name__}")
                rep.stale = True
            logger.warning(
                "replica pool: rollback restore on replica %d failed "
                "(%s) — evicted + stale until a later reload lands",
                rep.id, type(e).__name__)
            return False

    # -- admission ---------------------------------------------------------
    def _admit(self):
        with self._lock:
            if self._closed:
                raise ServerClosedError("replica pool is shut down")
            if self._in_flight >= self.admission_budget:
                self.shed_overload += 1
                retry = max(0.001, self._lat_ewma)
                raise ServerOverloadedError(
                    f"pool admission budget exhausted "
                    f"({self.admission_budget} in flight across "
                    f"{len(self._replicas)} replicas); retry in "
                    f"{retry:.3f}s", retry_after=retry)
            self._in_flight += 1

    def _release(self):
        with self._lock:
            self._in_flight -= 1

    # -- predict (failover + hedging) --------------------------------------
    def predict(self, x, timeout: Optional[float] = None) -> np.ndarray:
        """Serve one request through the pool: least-loaded routing,
        transparent failover on retryable typed failures (up to
        `max_failovers` re-routes), optional hedging. Raises the same
        typed `ServingError` family as `ModelServer.predict`; every
        replica-originated error carries `.replica_id` — and, with
        tracing on, `.trace_id`/`.trace`: the request's span timeline
        across pool routing and the replica's server/engine."""
        timeout = self.default_timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        trace = observability.maybe_trace()
        t0 = time.monotonic()
        try:
            self._admit()
        except ServingError as e:
            self._shed_obs(trace, e)
            raise
        try:
            # bind the trace to this thread: the replica's ModelServer
            # (same synchronous chain) joins it instead of minting one
            with observability.use_trace(trace):
                out = self._predict_failover(np.asarray(x), deadline)
        except ServingError as e:
            self._shed_obs(trace, e)
            raise
        finally:
            self._release()
        trace.finish("served")
        self.recorder.record(trace, "served", kind="predict")
        self._pool_latency_hist.observe(1e3 * (time.monotonic() - t0))
        # auto-arm the probe batch from the first served predict (the
        # pool-level mirror of ModelServer's auto_canary): without it, a
        # replica evicted before ANY canary armed anywhere could never
        # prove recovery — probes would stay inconclusive forever and
        # degraded mode would need an operator after all
        if self._probe_batch is None:
            # copy outside the lock; first publication under it wins
            armed = np.array(np.asarray(x)[:1])
            with self._lock:
                if self._probe_batch is None:
                    self._probe_batch = armed
        return out

    def __call__(self, x, timeout: Optional[float] = None) -> np.ndarray:
        return self.predict(x, timeout=timeout)

    def _remaining(self, deadline: Optional[float]) -> Optional[float]:
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise DeadlineExceededError(
                "deadline expired while the pool was routing/failing "
                "over; request shed")
        return rem

    def _route_with_failover(self, attempt, prompt=None, tenant=None):
        """The one failover loop `predict` and `generate` share: pick a
        healthy replica, run `attempt(replica, tried)`, and on a
        retryable typed failure — `_RETRYABLE` sickness, or a
        REPLICA-level `ServerOverloadedError` (another replica may have
        room; the POOL-level budget shed happens in `_admit`, before
        this loop, and is terminal) — re-route to another replica up to
        `max_failovers` times. After exhaustion the ORIGINAL typed
        error propagates (an overloaded replica's `retry_after` hint
        survives to the client). `DeadlineExceededError` is terminal:
        another replica cannot give the time back."""
        tried: set = set()
        reroutes = 0
        while True:
            rep = self._pick(exclude=tried, prompt=prompt, tenant=tenant)
            if rep is None:
                raise self._degraded()
            try:
                return attempt(rep, tried)
            except (ServerOverloadedError, *self._RETRYABLE) as e:
                rid = getattr(e, "replica_id", rep.id)
                tried.add(rid)
                if reroutes >= self.max_failovers:
                    raise
                reroutes += 1
                with self._lock:
                    self.failovers += 1
                trace = observability.current_trace()
                if trace:
                    trace.event("failover", hop=reroutes, replica=rid,
                                error=type(e).__name__)
                self.recorder.event("failover", replica=rid,
                                    hop=reroutes,
                                    error=type(e).__name__)
                logger.warning(
                    "replica pool: failover %d/%d after %s on replica %d",
                    reroutes, self.max_failovers, type(e).__name__, rid)

    def _predict_failover(self, x, deadline) -> np.ndarray:
        def attempt(rep, tried):
            rem = self._remaining(deadline)
            if self.hedge:
                return self._hedged_dispatch(rep, x, rem, tried)
            return self._dispatch(rep, x, rem)

        return self._route_with_failover(attempt)

    def _call_replica(self, rep: _Replica, call, *,
                      track_latency: bool = True):
        """The per-attempt policy every routed call shares (predict,
        generate): health re-check at dispatch, typed error tagging,
        sickness-vs-load accounting, served counter. A policy change
        here changes every entry point at once. `track_latency=False`
        keeps generation out of the predict latency EWMA."""
        if rep.state != "healthy":  # evicted between pick and dispatch
            raise _tag(ReplicaEvictedError(
                f"replica {rep.id} evicted before dispatch"), rep.id)
        trace = observability.current_trace()
        if trace:
            trace.event("route", replica=rep.id, load=rep.load())
        t0 = time.monotonic()
        try:
            out = call()
        except self._RETRYABLE as e:
            # sickness: feeds passive eviction tracking
            self._note_failure(rep, e)
            raise _tag(e, rep.id)
        except ServingError as e:
            # queue-full / deadline: load and time signals, NOT
            # sickness — they must not evict a healthy-but-busy replica
            raise _tag(e, rep.id)
        self._note_success(rep, (time.monotonic() - t0) if track_latency
                           else None)
        with self._lock:
            self.served += 1
        return out

    def _dispatch(self, rep: _Replica, x, timeout) -> np.ndarray:
        return self._call_replica(
            rep, lambda: rep.server.predict(x, timeout=timeout))

    # -- hedging -----------------------------------------------------------
    def _auto_hedge_delay(self) -> float:
        if self.hedge_delay is not None:
            return self.hedge_delay
        with self._lock:
            return self._lat_ewma + 4.0 * self._lat_dev

    def _hedged_dispatch(self, primary: _Replica, x, timeout,
                         tried: set) -> np.ndarray:
        """Fire `primary`; if it has not answered within the hedge
        delay, fire one more healthy replica. First finite result wins
        (results are already non-finite-screened by the replica's
        `ModelServer`); the loser keeps running and is absorbed — its
        outcome is noted by passive tracking AT COMPLETION, inside the
        worker thread, so a replica that consistently loses hedges by
        failing slowly still accumulates toward eviction even though no
        waiter is left. Raises the PRIMARY's typed error when both
        fail."""
        if primary.state != "healthy":
            raise _tag(ReplicaEvictedError(
                f"replica {primary.id} evicted before dispatch"),
                primary.id)
        cond = threading.Condition()
        outcomes: List[tuple] = []  # (tag, replica, result, error, dt)
        # the caller's trace, re-bound inside each hedge lane's worker
        # thread (thread-locals do not cross the spawn) so both lanes'
        # server spans land on the ONE request timeline
        trace = observability.current_trace() or observability.NULL_TRACE

        def run(rep: _Replica, tag: str) -> None:
            t0 = time.monotonic()
            trace.event(f"{tag}-dispatch", replica=rep.id)
            try:
                with observability.use_trace(trace):
                    out = rep.server.predict(x, timeout=timeout)
            # hedge worker: the failure
            # becomes this lane's outcome (classified retryable/fatal by
            # the racer below), never an unhandled thread death
            except BaseException as e:
                # note here, win or lose the race: sickness counts
                # toward eviction, queue-full/deadline are load/time
                # signals and do not
                if isinstance(e, self._RETRYABLE):
                    self._note_failure(rep, e)
                with cond:
                    outcomes.append((tag, rep, None, _tag(e, rep.id),
                                     time.monotonic() - t0))
                    cond.notify_all()
                return
            # failure-streak reset only — the WINNER's latency is folded
            # into the EWMA by the waiter; a loser that finally returns
            # after a 60 s wedge (the tail hedging exists to mask) must
            # not inflate the hedge delay / retry_after hints
            self._note_success(rep, None)
            with cond:
                outcomes.append((tag, rep, out, None,
                                 time.monotonic() - t0))
                cond.notify_all()

        threading.Thread(target=run, args=(primary, "primary"),
                         daemon=True).start()
        hedge_rep: Optional[_Replica] = None
        deadline = None if timeout is None else time.monotonic() + timeout
        hedge_at = time.monotonic() + max(0.0, self._auto_hedge_delay())
        with cond:
            while True:
                for tag, rep, out, err, dt in outcomes:
                    if err is None:
                        self._note_success(rep, dt)  # winner's latency
                        with self._lock:
                            self.served += 1
                            if tag == "hedge":
                                self.hedge_wins += 1
                        if tag == "hedge":
                            trace.event("hedge-win", replica=rep.id)
                            self.recorder.event("hedge-win",
                                                replica=rep.id)
                        return out
                errors = {tag: err
                          for tag, rep, out, err, dt in outcomes
                          if err is not None}
                if "primary" in errors and hedge_rep is None:
                    # primary failed before the hedge fired: plain
                    # failover handles it (cheaper than hedging a
                    # replica we know is sick)
                    raise errors["primary"]
                if "primary" in errors and hedge_rep is not None:
                    if "hedge" in errors:
                        # both down: raise the primary's error (the
                        # failover loop excludes both — tried grows by
                        # the hedge id)
                        tried.add(hedge_rep.id)
                        raise errors["primary"]
                    # primary failed while the hedge is still in
                    # flight: if an UNTRIED healthy replica exists,
                    # fail over to it now rather than block on the
                    # hedge — the hedge replica may itself be wedged
                    # (slowness is WHY it got hedged). The running
                    # hedge is absorbed at completion like any loser.
                    # With no fresh alternative the hedge is the
                    # request's best remaining shot — keep waiting
                    used = tried | {primary.id, hedge_rep.id}
                    with self._lock:
                        alt = any(r.state == "healthy"
                                  and r.id not in used
                                  for r in self._replicas)
                    if alt:
                        tried.add(hedge_rep.id)
                        raise errors["primary"]
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    raise _tag(DeadlineExceededError(
                        "deadline expired waiting on hedged replicas"),
                        primary.id)
                if hedge_rep is None and now >= hedge_at:
                    hedge_rep = self._pick(
                        exclude=tried | {primary.id})
                    if hedge_rep is not None \
                            and hedge_rep.id != primary.id:
                        with self._lock:
                            self.hedges_fired += 1
                        trace.event("hedge-fire", replica=hedge_rep.id,
                                    primary=primary.id)
                        self.recorder.event("hedge-fire",
                                            replica=hedge_rep.id,
                                            primary=primary.id)
                        threading.Thread(target=run,
                                         args=(hedge_rep, "hedge"),
                                         daemon=True).start()
                    else:
                        hedge_rep = None
                        hedge_at = now + self.probe_interval  # re-try later
                waits = [0.05]
                if deadline is not None:
                    waits.append(deadline - now)
                if hedge_rep is None:
                    waits.append(max(0.0, hedge_at - now) + 1e-4)
                cond.wait(max(1e-4, min(waits)))

    # -- generation --------------------------------------------------------
    # in-process replicas accept a streaming sink; the remote pool
    # overrides this False (a callable cannot cross the wire)
    supports_stream_sink = True

    def generate(self, prompt_ids, n_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None,
                 tenant: Optional[str] = None,
                 priority: str = "interactive",
                 logprobs: int = 0,
                 on_token: Optional[Callable] = None):
        """Route one generation request (each replica's lazily-built
        `DecodeEngine`) with least-loaded routing + failover. Safe to
        re-route: generation is seeded, so a failover re-send
        recomputes identical tokens — and with an `on_token` stream
        sink attached, a re-send republishes cursors 1..k into the same
        ring where they deduplicate, so the consumer-visible stream
        stays append-only across failovers. Shares the pool admission
        budget with `predict`. `tenant`/`priority` ride through to the
        chosen replica's engine-level QoS doors."""
        timeout = self.default_timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        # passed conditionally so adapters with the narrower pre-logprobs
        # signature keep working untouched
        genkw = {}
        if logprobs:
            genkw["logprobs"] = int(logprobs)
        if on_token is not None:
            genkw["on_token"] = on_token
        trace = observability.maybe_trace()
        try:
            self._admit()
        except ServingError as e:
            self._shed_obs(trace, e, kind="generate")
            raise
        try:
            def attempt(rep, tried):
                rem = self._remaining(deadline)
                try:
                    return self._call_replica(
                        rep, lambda: rep.server.generate(
                            prompt_ids, n_tokens, temperature=temperature,
                            seed=seed, timeout=rem, tenant=tenant,
                            priority=priority, **genkw),
                        track_latency=False)
                except SlotMigratedError as e:
                    # a redirect, not a failure: the replica exported
                    # this request's decode state under a lease (drain,
                    # scale-down) — fetch it and resume on a peer. A
                    # failed resume raises the retryable
                    # InferenceFailedError so THIS loop re-routes the
                    # full seeded generate (identical output, just the
                    # re-prefill cost)
                    return self._resume_migrated(rep, e, deadline, tried,
                                                 on_token=on_token)

            with observability.use_trace(trace):
                out = self._route_with_failover(attempt, prompt=prompt_ids,
                                                tenant=tenant)
        except ServingError as e:
            self._shed_obs(trace, e, kind="generate")
            raise
        finally:
            self._release()
        trace.finish("served")
        self.recorder.record(trace, "served", kind="generate")
        # auto-arm the generation probe from the first served generate
        # (the generation mirror of predict's probe_batch auto-arm): a
        # generation-ONLY pool never arms a predict canary at any layer,
        # so without this an evicted replica — e.g. one respawned by the
        # supervisor after a crash — could never prove recovery; probes
        # would stay inconclusive forever and the pool would sit in
        # degraded mode until an operator intervened
        if self._probe_gen is None:
            armed = np.array(np.asarray(prompt_ids))
            with self._lock:
                if self._probe_gen is None:
                    self._probe_gen = armed
        return out

    def _resume_migrated(self, victim: _Replica,
                         redirect: SlotMigratedError, deadline,
                         tried: set, on_token: Optional[Callable] = None):
        """Finish one migrated generation: fetch the leased KV payload
        from the exporting `victim`, resume it on a healthy peer, splice
        the victim's already-emitted tokens in front of the peer's tail.
        Any transfer/resume failure aborts the lease (the victim
        reclaims its pages immediately) and raises the retryable
        `InferenceFailedError` so the failover loop re-runs the full
        seeded generate — the degradation ladder's last rung, which
        reproduces the exact same output."""
        trace = observability.current_trace()
        handoff_id = redirect.handoff_id
        if trace:
            trace.event("migrate-redirect", replica=victim.id,
                        handoff_id=handoff_id,
                        emitted=len(redirect.tokens))
        self.recorder.event("migrate-redirect", replica=victim.id,
                            handoff_id=handoff_id)
        try:
            rem = self._remaining(deadline)
            payload = victim.server.fetch_handoff(handoff_id)
            peer = self._pick(exclude=tried | {victim.id})
            if peer is None or peer.id == victim.id:
                raise KVTransferError(
                    "no healthy peer to resume the migrated slot on")
            if trace:
                trace.event("migrate-resume", replica=peer.id,
                            handoff_id=handoff_id)
            reskw = {} if on_token is None else {"on_token": on_token}
            tail = self._call_replica(
                peer, lambda: peer.server.resume_generate(
                    payload, timeout=rem, **reskw),
                track_latency=False)
        except DeadlineExceededError:
            raise  # terminal: a peer cannot give the time back
        except (ServingError, *_TRANSFER_FAULTS) as e:
            # best-effort early reclaim: without it the victim's pages
            # stay leased until the TTL sweep
            try:
                victim.server.abort_handoff(handoff_id)
            except (ServingError, *_TRANSFER_FAULTS):
                logger.info(
                    "replica pool: abort_handoff %s unreachable after "
                    "failed resume; victim's lease sweep reclaims it",
                    handoff_id)
            with self._lock:
                self.migration_fallbacks += 1
            if trace:
                trace.event("migrate-fallback", replica=victim.id,
                            error=type(e).__name__)
            self.recorder.event("migrate-fallback", replica=victim.id,
                                handoff_id=handoff_id,
                                error=type(e).__name__)
            raise _tag(InferenceFailedError(
                f"migrated slot {handoff_id} could not be resumed "
                f"({type(e).__name__}: {e}); falling back to a full "
                "re-prefill on another replica"), victim.id) from e
        # success: resolve the lease so the victim frees the shipped
        # pages now instead of at TTL expiry (best-effort — expiry is
        # the backstop)
        try:
            victim.server.commit_handoff(handoff_id)
        except (ServingError, *_TRANSFER_FAULTS):
            logger.info(
                "replica pool: commit_handoff %s unreachable after "
                "successful resume; victim's lease sweep reclaims it",
                handoff_id)
        with self._lock:
            self.migrations += 1
        if trace:
            trace.event("migrate-done", handoff_id=handoff_id,
                        spliced=len(redirect.tokens))
        self.recorder.event("migrate-done", handoff_id=handoff_id)
        head = np.asarray(redirect.tokens, np.int32)
        if isinstance(tail, dict):
            # logprobs rode the handoff: splice the victim's per-step
            # entries in front of the peer's tail, mirroring the tokens
            head_lps = list(payload.get("logprob_values")
                            or [])[:len(redirect.tokens)]
            return {"tokens": np.concatenate(
                        [head, np.asarray(tail["tokens"],
                                          np.int32).reshape(-1)]),
                    "logprobs": head_lps + list(tail["logprobs"])}
        return np.concatenate([head, np.asarray(tail, np.int32).reshape(-1)])

    # -- health probing ----------------------------------------------------
    def _probe_input(self) -> Optional[np.ndarray]:
        """The batch probes serve: the configured/auto-armed
        `probe_batch`, else a canary BORROWED from any replica that
        armed one (all replicas serve the same model contract, so one
        replica's canary proves another's health) — an evicted replica
        gets no traffic to arm its own."""
        if self._probe_batch is not None:
            return self._probe_batch
        for rep in self._replicas:
            canary = getattr(rep.server, "_canary", None)
            if canary is not None:
                return canary
        return None

    def _probe_generate(self, rep: _Replica, prompt: np.ndarray,
                        timeout: Optional[float]) -> Optional[bool]:
        """Generation-canary probe: serve ONE greedy token through the
        replica's full generate path (admission, engine, non-finite
        screen — and, for a remote replica, the wire). Same
        three-valued contract as `ModelServer.probe`: a load/time shed
        is inconclusive, typed sickness is False, a served token is
        True. Used when no predict canary exists anywhere — a
        generation-only pool's replicas serve no predict traffic to
        arm one."""
        try:
            rep.server.generate(prompt, 1, temperature=0.0, seed=0,
                                timeout=timeout)
        except (ServerOverloadedError, DeadlineExceededError):
            return None  # load/time shed: not evidence of sickness
        except ServingError:
            return False
        return True

    def _probe_async(self, rep: _Replica):
        """Start one probe on a helper thread; returns (event, verdict)
        where verdict[0] lands as True (healthy), False (sick — incl.
        an exception out of the probe), or None (inconclusive: the
        probe was shed on load/time; see `ModelServer.probe`)."""
        verdict: List[Optional[bool]] = [False]
        done = threading.Event()
        batch = self._probe_input()
        with self._lock:
            gen_prompt = self._probe_gen if batch is None else None

        # a probe must ALWAYS carry a deadline: with timeout=None a
        # probe of a wedged replica would block its helper thread (and
        # hold its queue slot) forever — one leaked thread per cycle.
        # The watchdog window bounds how long a verdict is waited on,
        # so it is the natural fallback bound
        probe_timeout = self.probe_timeout \
            if self.probe_timeout is not None else self.watchdog_timeout

        def run():
            try:
                if batch is None and gen_prompt is not None:
                    verdict[0] = self._probe_generate(rep, gen_prompt,
                                                      probe_timeout)
                else:
                    verdict[0] = rep.server.probe(batch,
                                                  timeout=probe_timeout)
            # probe worker: any failure
            # (hang, crash, typed shed) means one thing — unhealthy; the
            # verdict is the only channel out of this watchdog thread
            except BaseException:
                verdict[0] = False
            done.set()

        threading.Thread(target=run, daemon=True).start()
        return done, verdict

    def _probe(self, rep: _Replica) -> Optional[bool]:
        """One watchdogged probe: sick (False) if no verdict lands
        within `watchdog_timeout` — a replica wedged INSIDE a device
        step (where deadlines cannot reach) reads as hung, not slow."""
        done, verdict = self._probe_async(rep)
        if not done.wait(self.watchdog_timeout):
            logger.warning("replica pool: probe of replica %d hung past "
                           "watchdog_timeout=%.3fs", rep.id,
                           self.watchdog_timeout)
            return False
        return verdict[0]

    def _apply_probe_verdict(self, rep: _Replica,
                             ok: Optional[bool]) -> None:
        """Three-valued: True counts toward re-admission, False evicts
        (or resets the re-admission streak), None — the probe was shed
        on load — changes NOTHING: a busy replica proves nothing, and
        treating busyness as sickness would let a saturating burst
        evict healthy replicas and cascade the pool into degraded
        mode."""
        self.recorder.event("probe", replica=rep.id, state=rep.state,
                            verdict="inconclusive" if ok is None
                            else bool(ok))
        with self._lock:
            if rep.state == "draining" or ok is None:
                return
            if rep.state == "evicted":
                if ok:
                    if rep.stale:
                        # recovered, but on weights behind the pool's (a
                        # best-effort deploy reload failed on it):
                        # re-admitting would split the pool between
                        # versions — it stays out until reloaded
                        return
                    rep.probe_successes += 1
                    if rep.probe_successes >= self.readmit_successes:
                        rep.state = "healthy"
                        rep.consecutive_failures = 0
                        rep.probe_successes = 0
                        self.readmissions += 1
                        self.recorder.event("readmit", replica=rep.id)
                        logger.warning(
                            "replica pool: re-admitted replica %d after "
                            "%d consecutive probe successes", rep.id,
                            self.readmit_successes)
                else:
                    rep.probe_successes = 0
            elif not ok:
                self._evict_locked(rep, "probe failed")

    def _probe_loop(self) -> None:
        while True:
            self._probe_wake.wait(self.probe_interval)
            self._probe_wake.clear()
            with self._lock:
                if self._closed:
                    return
                targets = [r for r in self._replicas
                           if r.state != "draining"]
            probing = []
            for rep in targets:
                # breaker-open is sickness the pool need not probe to see
                if rep.state == "healthy" \
                        and rep.server.breaker.state == "open":
                    with self._lock:
                        self._evict_locked(rep, "breaker open")
                    continue
                probing.append((rep,) + self._probe_async(rep))
            # ONE shared watchdog window for the whole cycle: probes run
            # concurrently, so a single hung replica costs the cycle one
            # watchdog_timeout — not one per hung replica — and cannot
            # starve the other replicas' eviction/re-admission decisions
            cycle_deadline = time.monotonic() + self.watchdog_timeout
            for rep, done, verdict in probing:
                if not done.wait(max(0.0,
                                     cycle_deadline - time.monotonic())):
                    logger.warning(
                        "replica pool: probe of replica %d hung past "
                        "watchdog_timeout=%.3fs", rep.id,
                        self.watchdog_timeout)
                    self._apply_probe_verdict(rep, False)
                else:
                    self._apply_probe_verdict(rep, verdict[0])
            with self._lock:
                if self._closed:
                    return

    # -- rolling reload ----------------------------------------------------
    def rolling_reload(self, source, step: Optional[int] = None,
                       drain_timeout: float = 30.0) -> List[int]:
        """Replica-at-a-time canary-gated weight swap under live
        traffic. Per replica: DRAIN (routing stops, pending work
        finishes, bounded by `drain_timeout`) → `ModelServer.reload`
        (manifest verify + canary ladder) → serve a watchdogged probe
        successfully → re-admit; only then the next replica. The rest
        of the pool carries traffic throughout, so the deploy is
        zero-downtime.

        If any HEALTHY replica's reload or post-reload probe fails, the
        WHOLE pool rolls back to the old weights (every
        already-reloaded replica gets its old model restored via
        `ModelServer.restore_model`) and the typed error propagates —
        a bad checkpoint never splits the pool between versions.

        EVICTED replicas are not deploy gates — the pool serves without
        them, so a dead replica must not block deploying a good
        checkpoint. They get a BEST-EFFORT reload (no drain, no probe
        gate — they take no traffic): on success they carry the new
        weights into their eventual re-admission; on failure they are
        marked `stale` and the probe loop refuses to re-admit them
        until a later reload lands, so a replica recovering on old
        weights can never split the pool either. Returns the
        per-replica new model versions (healthy replicas only)."""
        with self._reload_lock:
            self.recorder.event("rolling-reload", decision="start")
            done: List[tuple] = []  # (replica, old_net, was_stale)
            newly_stale: List[_Replica] = []
            versions: List[int] = []
            try:
                for rep in list(self._replicas):
                    with self._lock:
                        evicted = rep.state == "evicted"
                        was_stale = rep.stale
                    if evicted:
                        try:
                            # .net inside the try: on a REMOTE replica it
                            # is a snapshot RPC, and a dead evicted
                            # replica failing to answer must stay
                            # best-effort, not abort the deploy
                            old_net = rep.server.net
                            rep.server.reload(source, step=step)
                        # best-effort
                        # catch-up reload of an evicted replica: failure
                        # marks it stale for the next readmission probe
                        except BaseException as e:
                            with self._lock:
                                if not rep.stale:
                                    newly_stale.append(rep)
                                rep.stale = True
                            logger.warning(
                                "replica pool: best-effort reload of "
                                "evicted replica %d failed (%s) — "
                                "marked stale, barred from "
                                "re-admission until reloaded",
                                rep.id, type(e).__name__)
                            continue
                        with self._lock:
                            rep.stale = False
                        done.append((rep, old_net, was_stale))
                        continue
                    self._drain_replica(rep, drain_timeout)
                    swapped = False
                    try:
                        # .net inside the try: a remote replica answers
                        # the pre-deploy snapshot over the wire, and a
                        # wire failure here must release the drain (the
                        # finally below) instead of wedging the replica
                        # in "draining" forever
                        old_net = rep.server.net
                        versions.append(rep.server.reload(source,
                                                          step=step))
                        swapped = True
                        # three-valued: only a SICK verdict (False)
                        # fails the deploy — an inconclusive probe
                        # (None: shed on load, or no probe batch armed)
                        # matches reload()'s own canary-optional
                        # behavior
                        if self._probe(rep) is False:
                            raise InferenceFailedError(
                                f"replica {rep.id} failed its "
                                "post-reload probe on the candidate")
                    except BaseException as e:
                        if swapped:
                            self._restore_or_evict(rep, old_net)
                        raise _tag(e, rep.id)
                    finally:
                        # back on known weights either way: old on
                        # failure, probed candidate on success. Reset
                        # the passive failure streak like probe-loop
                        # re-admission does — failures noted against
                        # the PRE-deploy weights during the drain
                        # window must not count against the fresh ones
                        with self._lock:
                            if rep.state == "draining":
                                rep.state = "healthy"
                                rep.consecutive_failures = 0
                    done.append((rep, old_net, False))
            except BaseException:
                for rep, old_net, was_stale in reversed(done):
                    # per-replica: one replica dying mid-rollback (a
                    # remote peer can vanish between its reload and the
                    # pool-wide unwind) must not strand the OTHER
                    # already-reloaded replicas on the new weights —
                    # that would be the exact version split the
                    # rollback exists to prevent
                    if not self._restore_or_evict(rep, old_net):
                        continue
                    with self._lock:
                        # back on its PRE-deploy weights: for a replica
                        # that was already stale coming in, those are
                        # still behind the pool's — the bar stays
                        rep.stale = was_stale
                for rep in newly_stale:
                    with self._lock:
                        # its best-effort reload failed, but the whole
                        # pool just rolled back to the very weights it
                        # still holds — no version split, no bar
                        rep.stale = False
                with self._lock:
                    self.rollbacks += 1
                self.recorder.event("rolling-reload",
                                    decision="rolled-back",
                                    completed=len(done))
                logger.warning(
                    "replica pool: rolling reload FAILED after %d/%d "
                    "replicas — whole pool rolled back to old weights",
                    len(done), len(self._replicas))
                raise
            with self._lock:
                self.rolling_reloads += 1
            self.recorder.event("rolling-reload", decision="complete",
                                replicas=len(done))
            logger.warning("replica pool: rolling reload complete "
                           "across %d replicas", len(done))
            return versions

    def sync_net(self, net) -> None:
        """Propagate `net`'s weights to every replica that does not
        already serve that exact object (each gets its own clone —
        replicas never alias each other's parameters). The seam the
        gateway's `fit` RPC uses after training the installed net in
        place: replica 0 aliases it and sees the new weights, but the
        clones would keep serving pre-fit parameters and silently
        version-split the pool. Replicas synced here are on the pool's
        weights by construction, so any stale bar is lifted."""
        with self._reload_lock:
            for rep in self._replicas:
                if rep.server.net is not net:
                    rep.server.restore_model(net.clone())
                with self._lock:
                    rep.stale = False

    def _drain_replica(self, rep: _Replica, drain_timeout: float,
                       reason: str = "rolling-reload") -> None:
        """Stop routing to `rep` and wait (bounded) for its pending
        work to finish so the reload's canary/swap does not contend
        with live traffic. A drain timeout is not fatal — `reload`'s
        write lock still guarantees in-flight work finishes on the old
        model; the bound just caps how long a deploy can stall.

        Migrate-then-drain: when the victim can export decode state
        (`migrate_slots`) AND a healthy peer exists to resume on, its
        in-flight generations are exported as leased KV handoffs first —
        their waiters get the `SlotMigratedError` redirect and finish on
        a peer mid-sequence instead of holding the drain for their full
        tails. With no peer the export is skipped: a redirect nobody can
        resume would turn a finishable request into a fallback."""
        with self._lock:
            if rep.state == "healthy":
                rep.state = "draining"
            peers = sum(1 for r in self._replicas
                        if r.id != rep.id and r.state == "healthy")
        self.recorder.event("drain", replica=rep.id, reason=reason)
        moved = 0
        if peers >= 1 and hasattr(rep.server, "migrate_slots"):
            try:
                moved = rep.server.migrate_slots(wait=drain_timeout)
            except (ServingError, *_TRANSFER_FAULTS) as e:
                # the export is an optimization — a victim that cannot
                # export still drains the classic way (bounded wait)
                logger.info(
                    "replica pool: migrate-then-drain export failed on "
                    "replica %d (%s); draining without migration",
                    rep.id, type(e).__name__)
            else:
                if moved:
                    self.recorder.event("migrate-drain", replica=rep.id,
                                        slots=moved, reason=reason)
                    logger.info(
                        "replica pool: migrated %d in-flight slot(s) "
                        "off replica %d before drain (%s)",
                        moved, rep.id, reason)
        deadline = time.monotonic() + drain_timeout
        while rep.server.pending() and time.monotonic() < deadline:
            time.sleep(0.005)
        if moved:
            # the exported payloads live ON the victim until their
            # receivers fetch them; letting the caller dispose the
            # victim before that would turn every migration into a
            # fallback re-prefill. Wait (same bounded budget) until no
            # lease is unfetched — commit/abort can land after disposal
            # (the resume already holds the bytes; expiry is moot on a
            # dead sender), so fetched is the bar, not resolved
            while time.monotonic() < deadline:
                try:
                    gen = rep.server.stats().get("generation", {})
                except (ServingError, *_TRANSFER_FAULTS):
                    break  # victim unreachable: nothing left to wait on
                if not gen.get("handoffs_unfetched", 0):
                    break
                time.sleep(0.01)

    # -- elasticity (the autoscaler's seam) --------------------------------
    def add_replica(self, server, *, healthy: bool = False) -> int:
        """Attach one more replica to the live pool and return its id.

        The new replica enters EVICTED by default: it serves no traffic
        until the probe ladder re-admits it (`readmit_successes`
        consecutive probe passes) — scale-up never routes requests to a
        replica that has not proven itself. `healthy=True` skips the
        ladder for callers that already validated the server (tests,
        pre-warmed spares). The admission budget grows by the new
        replica's queue capacity, and the replica list is replaced
        copy-on-write so unlocked snapshot readers never see a
        half-mutated list."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("replica pool is shut down")
            new_id = max((r.id for r in self._replicas), default=-1) + 1
            rep = _Replica(new_id, server)
            if not healthy:
                rep.state = "evicted"
            self._replicas = self._replicas + [rep]
            self.admission_budget += getattr(server, "max_queue", 64)
            self.replicas_added += 1
            self.recorder.event("add-replica", replica=new_id,
                                state=rep.state,
                                n_replicas=len(self._replicas))
        self._bind_prefix(rep)
        logger.info("replica pool: added replica %d (%s)", new_id,
                    rep.state)
        self._probe_wake.set()  # start the ladder immediately
        return new_id

    def remove_replica(self, replica_id: int, *,
                       drain_timeout: float = 30.0):
        """Detach one replica with the zero-failed-requests drain
        discipline and return its (still running) server: routing stops
        first, in-flight work on the victim finishes, THEN the replica
        leaves the pool. If the drain does not complete inside
        `drain_timeout` the removal is aborted — the replica is
        restored to rotation and `AutoscaleError` raised, because
        completing the removal would fail its in-flight requests. The
        caller owns the returned server's shutdown."""
        with self._lock:
            rep = next((r for r in self._replicas if r.id == replica_id),
                       None)
            if rep is None:
                raise ValueError(f"no replica with id {replica_id}")
            if len(self._replicas) <= 1:
                raise ValueError("cannot remove the last replica")
            prior_state = rep.state
        self._drain_replica(rep, drain_timeout, reason="scale-down")
        if rep.server.pending():
            with self._lock:
                if rep.state == "draining":
                    rep.state = prior_state
            raise AutoscaleError(
                f"replica {replica_id} still has {rep.server.pending()} "
                f"in-flight requests after a {drain_timeout:.1f}s drain; "
                "removal aborted (completing it would fail them)")
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if r.id != replica_id]
            self.admission_budget = max(
                1, self.admission_budget
                - getattr(rep.server, "max_queue", 64))
            self.replicas_removed += 1
            self.recorder.event("remove-replica", replica=replica_id,
                                n_replicas=len(self._replicas))
        if self._prefix_directory is not None:
            self._prefix_directory.drop_holder(f"replica-{replica_id}")
        logger.info("replica pool: removed replica %d (drained clean)",
                    replica_id)
        return rep.server

    def set_tenant_quota(self, tenant: str, rate=None, burst=None,
                         max_pages=None, weight=None) -> None:
        """Fan one tenant's token-rate quota, KV page ceiling, and
        batch-lane fair-queueing weight out to every replica (the quota
        is enforced per decode engine; a pool-level budget would need
        cross-replica accounting the wire does not carry)."""
        with self._lock:
            replicas = list(self._replicas)
        for rep in replicas:
            rep.server.set_tenant_quota(tenant, rate=rate, burst=burst,
                                        max_pages=max_pages,
                                        weight=weight)

    # -- shutdown ----------------------------------------------------------
    def shutdown(self, drain_timeout: float = 10.0) -> bool:
        """Stop admission + probing, drain every replica concurrently
        against one shared `drain_timeout` budget. Returns True when
        every replica drained clean. Idempotent."""
        with self._lock:
            self._closed = True
        self._probe_wake.set()
        self._probe_thread.join(self.watchdog_timeout
                                + self.probe_interval + 5.0)
        results = {}
        threads = [
            threading.Thread(
                target=lambda r=rep: results.__setitem__(
                    r.id, r.server.shutdown(drain_timeout=drain_timeout)),
                daemon=True)
            for rep in self._replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join(drain_timeout + 10.0)
        return all(results.get(rep.id, False) for rep in self._replicas)
