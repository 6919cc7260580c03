"""Closed-loop autoscaler: elastic replica count driven by live load
(counterpart of `deeplearning4j_tpu/serving/autoscaler.py`). In-process
pools scale through `spawn=` / `dispose=`; the `grow_replica` route
belongs to the remote pool, which is not ported yet.

The pool machinery alone makes replica count a DEPLOY-TIME choice:
`ReplicaPool` routes across a fixed set, `ReplicaSupervisor` respawns
the fixed set, and a diurnal traffic swell either overloads the fixed
set (typed sheds) or wastes idle accelerators all night. `Autoscaler`
closes the loop:

- **signal** — every `interval` it samples the pool's own telemetry
  (the metrics/stats contract): pool in-flight vs the admission
  budget, per-replica queue fill, decode-engine slot occupancy and
  `pages_in_use` / `pool_pages`, queued page demand vs the wait-room
  cap — and counts fresh p99-excursion pins in the locally readable
  flight recorders. The max of those ratios is the instantaneous
  *pressure* (1.0 = some resource is saturated), folded into an EWMA
  so one bursty sample cannot thrash the fleet.
- **hysteresis** — only `hysteresis` CONSECUTIVE samples with the EWMA
  past `high_watermark` scale up, and only as many consecutive samples
  under `low_watermark` scale down; every action starts a `cooldown`
  window in which no further action fires (the new replica needs time
  to take load before the signal is trusted again).
- **scale-up** — through the same machinery a crash-recovery uses:
  `RemoteReplicaPool.grow_replica()` (supervisor `grow_slot` → fresh
  readiness-gated process → `pool.add_replica`) or a caller-supplied
  `spawn()` for in-process pools. The new replica enters EVICTED and
  serves nothing until the probe ladder re-admits it — scale-up can
  never route traffic onto an unproven replica. Bounded by
  `max_replicas`; supervisor exhaustion surfaces as the typed
  `AutoscaleError` (counted, recorded, never fatal to the loop).
- **scale-down** — the rolling-reload drain discipline, zero failed
  requests: the victim stops taking traffic, its in-flight work
  FINISHES, and only then does it leave the pool
  (`ReplicaPool.remove_replica` aborts the removal typed if the drain
  cannot complete). Remote victims' supervisor slots are retired so
  the process is stopped and never respawned. Bounded by
  `min_replicas`.

Lock order: `Autoscaler._lock` is a LEAF — it guards only the
scaler's own counters/EWMA and is never held across a call into the
pool or supervisor (whose locks are acquired freely while no
autoscaler lock is held). Sample → decide (under `_lock`) → act
(no locks held) → account (under `_lock`).

`stats()` registers into the pool's metrics registry under
``autoscaler`` — `autoscale_events`, `scale_ups`, `scale_downs`,
failures, and the live pressure/EWMA — and every decision lands in
the pool's flight recorder as an ``autoscale`` event carrying the
deciding metric values (the chaos drill asserts the timeline names
every decision).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.serving.model_server import AutoscaleError

logger = logging.getLogger("deeplearning4j_tpu_torch")


class Autoscaler:
    """Watch one `ReplicaPool`'s telemetry; grow/shrink its replica set.

    `spawn` (optional) builds one ready `ModelServer`-shaped server for
    in-process pools; without it the pool must expose `grow_replica`
    (`RemoteReplicaPool`). `dispose` (optional) tears down a server
    returned by `remove_replica` on the in-process path (default:
    ``server.shutdown()``)."""

    def __init__(self, pool, *,
                 min_replicas: int = 1,
                 max_replicas: int = 4,
                 interval: float = 0.5,
                 alpha: float = 0.3,
                 high_watermark: float = 0.75,
                 low_watermark: float = 0.25,
                 hysteresis: int = 3,
                 cooldown: float = 5.0,
                 drain_timeout: float = 30.0,
                 excursion_weight: float = 0.25,
                 spawn: Optional[Callable] = None,
                 dispose: Optional[Callable] = None):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if interval <= 0:
            raise ValueError("interval must be > 0")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if not 0.0 <= low_watermark < high_watermark:
            raise ValueError(
                "watermarks must satisfy 0 <= low < high")
        if hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")
        self.pool = pool
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.interval = interval
        self.alpha = alpha
        self.high_watermark = high_watermark
        self.low_watermark = low_watermark
        self.hysteresis = hysteresis
        self.cooldown = cooldown
        self.drain_timeout = drain_timeout
        self.excursion_weight = excursion_weight
        self._spawn = spawn
        self._dispose = dispose
        self._lock = threading.Lock()
        self._pressure = 0.0  # guarded by: _lock
        self._pressure_ewma = 0.0  # guarded by: _lock
        self._above = 0  # guarded by: _lock
        self._below = 0  # guarded by: _lock
        self._cooldown_until = 0.0  # guarded by: _lock
        self._last_excursion_scan = time.time()  # guarded by: _lock
        self._last_decision = "none"  # guarded by: _lock
        # how long the most recent migrate-then-drain shrink took; stays
        # 0.0 until the first scale-down — guarded by: _lock
        self._last_scale_down_ms = 0.0
        self.autoscale_events = 0  # guarded by: _lock
        self.scale_ups = 0  # guarded by: _lock
        self.scale_downs = 0  # guarded by: _lock
        self.autoscale_failures = 0  # guarded by: _lock
        self.samples = 0  # guarded by: _lock
        self._closed = False  # guarded by: _lock
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        pool.metrics.register_stats("autoscaler", self.stats)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="autoscaler")
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._closed = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(self.interval + 5.0)

    def _loop(self) -> None:
        while True:
            self._wake.wait(self.interval)
            self._wake.clear()
            with self._lock:
                if self._closed:
                    return
            try:
                self.tick()
            # the control loop must
            # outlive any one bad sample/action; the failure is counted
            # and recorded, and the next tick re-reads ground truth
            except BaseException as e:
                with self._lock:
                    self.autoscale_failures += 1
                self.pool.recorder.event(
                    "autoscale", direction="error",
                    error=type(e).__name__, detail=str(e)[:200])
                logger.warning("autoscaler: tick failed (%s: %s)",
                               type(e).__name__, e)

    # -- signal ------------------------------------------------------------
    def _sample_pressure(self) -> float:
        """Instantaneous pressure in [0, ~1]: the max saturation ratio
        across every resource that sheds when full, plus an excursion
        term — fresh p99 pins push pressure up even while queues are
        nominally short (tail latency is load the counters miss)."""
        st = self.pool.stats()
        ratios = [st["pool_in_flight"] / max(1, st["admission_budget"])]
        for s in st["replicas"].values():
            if s.get("state") != "healthy":
                continue
            depth = s.get("queue_depth") or 1
            ratios.append(s.get("queued", 0) / depth)
            gen = s.get("generation")
            if not gen:
                continue
            ratios.append(gen["active_slots"] / max(1, gen["n_slots"]))
            ratios.append(gen["pages_in_use"] / max(1, gen["pool_pages"]))
            ratios.append(gen["queued_page_demand"]
                          / max(1, gen["max_queued_pages"]))
        excursions = self._fresh_excursions()
        if excursions:
            ratios.append(min(1.0, excursions * self.excursion_weight))
        return max(ratios)

    def _recorders(self) -> List:
        """Locally readable flight recorders: the pool's own ring plus
        any in-process replica server's (a `RemoteReplica` keeps no
        local recorder — its excursions surface in the remote process
        and reach us through that replica's queue/occupancy ratios
        instead)."""
        recs = [self.pool.recorder]
        for rep in list(getattr(self.pool, "_replicas", [])):
            rec = getattr(rep.server, "recorder", None)
            if rec is not None and hasattr(rec, "dump"):
                recs.append(rec)
        return recs

    def _fresh_excursions(self) -> int:
        """p99-excursion events pinned since the previous sample."""
        with self._lock:
            since = self._last_excursion_scan
            self._last_excursion_scan = time.time()
        n = 0
        for rec in self._recorders():
            try:
                events = rec.dump().get("events", [])
            # a replica mid-teardown
            # must not kill the sampling tick
            except Exception:
                continue
            n += sum(1 for e in events
                     if e.get("kind") == "excursion"
                     and e.get("wall_time", 0.0) > since)
        return n

    # -- decision ----------------------------------------------------------
    def tick(self) -> Optional[str]:
        """One control iteration: sample, fold, decide, act. Returns
        the action taken ("up"/"down") or None. Exposed for tests and
        for callers that drive the loop themselves."""
        pressure = self._sample_pressure()
        now = time.monotonic()
        with self._lock:
            self.samples += 1
            self._pressure = pressure
            self._pressure_ewma = ((1 - self.alpha) * self._pressure_ewma
                                   + self.alpha * pressure)
            ewma = self._pressure_ewma
            if ewma > self.high_watermark:
                self._above += 1
                self._below = 0
            elif ewma < self.low_watermark:
                self._below += 1
                self._above = 0
            else:
                self._above = 0
                self._below = 0
            in_cooldown = now < self._cooldown_until
            want_up = self._above >= self.hysteresis and not in_cooldown
            want_down = self._below >= self.hysteresis and not in_cooldown
        n = self.pool.n_replicas
        if want_up and n < self.max_replicas:
            self.scale_up()
            return "up"
        if want_down and n > self.min_replicas:
            self.scale_down()
            return "down"
        return None

    def _account(self, direction: str, **attrs) -> None:
        with self._lock:
            self.autoscale_events += 1
            if direction == "up":
                self.scale_ups += 1
            elif direction == "down":
                self.scale_downs += 1
            self._above = 0
            self._below = 0
            self._cooldown_until = time.monotonic() + self.cooldown
            self._last_decision = direction
            pressure, ewma = self._pressure, self._pressure_ewma
        self.pool.recorder.event(
            "autoscale", direction=direction, pressure=round(pressure, 4),
            pressure_ewma=round(ewma, 4), n_replicas=self.pool.n_replicas,
            high_watermark=self.high_watermark,
            low_watermark=self.low_watermark, **attrs)

    # -- actions -----------------------------------------------------------
    def scale_up(self) -> int:
        """Add one replica (probe-ladder gated). Returns the new pool
        replica id. Raises the typed `AutoscaleError` when the bound is
        hit or the spawn path is exhausted."""
        if self.pool.n_replicas >= self.max_replicas:
            raise AutoscaleError(
                f"already at max_replicas={self.max_replicas}")
        try:
            if self._spawn is not None:
                rid = self.pool.add_replica(self._spawn())
            elif hasattr(self.pool, "grow_replica"):
                rid = self.pool.grow_replica()
            else:
                raise AutoscaleError(
                    "no scale-up path: pool has no grow_replica and no "
                    "spawn callable was configured")
        except AutoscaleError:
            with self._lock:
                self.autoscale_failures += 1
                self._cooldown_until = time.monotonic() + self.cooldown
            raise
        # supervisor/spawn failures wrap
        # into the control plane's typed error; the pool keeps serving
        # at its previous size
        except BaseException as e:
            with self._lock:
                self.autoscale_failures += 1
                self._cooldown_until = time.monotonic() + self.cooldown
            self.pool.recorder.event("autoscale", direction="up-failed",
                                     error=type(e).__name__)
            raise AutoscaleError(
                f"scale-up failed: {type(e).__name__}: {e}") from e
        self._account("up", replica=rid)
        logger.info("autoscaler: scaled up to %d replicas (replica %d)",
                    self.pool.n_replicas, rid)
        return rid

    def scale_down(self) -> int:
        """Drain + remove one replica (zero failed requests — aborts
        typed if the victim cannot drain). The pool's drain is
        migrate-then-drain: the victim's in-flight generations export
        as leased KV handoffs and resume mid-sequence on surviving
        replicas (`serving.kv_transfer`), so scale-down no longer waits
        on — or re-computes — long decode tails. Returns the removed
        replica id."""
        if self.pool.n_replicas <= self.min_replicas:
            raise AutoscaleError(
                f"already at min_replicas={self.min_replicas}")
        victim = self._pick_victim()
        if victim is None:
            raise AutoscaleError(
                "no healthy replica is removable right now")
        t0 = time.monotonic()
        try:
            if hasattr(self.pool, "shrink_replica"):
                self.pool.shrink_replica(
                    victim, drain_timeout=self.drain_timeout)
            else:
                server = self.pool.remove_replica(
                    victim, drain_timeout=self.drain_timeout)
                if self._dispose is not None:
                    self._dispose(server)
                else:
                    server.shutdown()
        except AutoscaleError:
            with self._lock:
                self.autoscale_failures += 1
                self._cooldown_until = time.monotonic() + self.cooldown
            raise
        # migrate-then-drain makes this a bounded handoff, not a wait
        # on the longest in-flight generation — the duration stat is
        # the regression alarm for that property
        duration_ms = round((time.monotonic() - t0) * 1000.0, 1)
        with self._lock:
            self._last_scale_down_ms = duration_ms
        self._account("down", replica=victim, duration_ms=duration_ms)
        logger.info("autoscaler: scaled down to %d replicas (removed %d "
                    "in %.1fms)", self.pool.n_replicas, victim,
                    duration_ms)
        return victim

    def _pick_victim(self) -> Optional[int]:
        """Least-loaded healthy replica: it drains fastest and the
        pool loses the least in-flight capacity."""
        st = self.pool.stats()
        candidates = [
            (s.get("queued", 0) + s.get("in_flight", 0), int(rid))
            for rid, s in st["replicas"].items()
            if s.get("state") == "healthy"]
        if not candidates:
            return None
        return min(candidates)[1]

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "autoscale_events": self.autoscale_events,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "autoscale_failures": self.autoscale_failures,
                "samples": self.samples,
                "pressure": round(self._pressure, 4),
                "pressure_ewma": round(self._pressure_ewma, 4),
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "cooldown_remaining": round(
                    max(0.0, self._cooldown_until - time.monotonic()), 3),
                "last_decision": self._last_decision,
                "last_scale_down_ms": self._last_scale_down_ms,
            }
