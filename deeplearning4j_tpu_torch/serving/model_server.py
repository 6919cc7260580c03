"""Robust model serving: admission control, deadlines, micro-batched
predict, circuit breaking and safe hot reload (counterpart of
`deeplearning4j_tpu/serving/model_server.py`).

`ModelServer` wraps a network behind four defenses:

- **admission control**: a bounded request queue plus `max_concurrent`
  executor threads, each dispatching one device step at a time. A full
  queue raises the typed `ServerOverloadedError` with a `retry_after`
  hint (EWMA step latency x backlog) instead of queueing without bound;
  expired entries are swept first, so they are not the reason a live
  request is shed.
- **per-request deadlines**: `predict(x, timeout=...)` stamps a
  monotonic deadline; expired requests are shed (`DeadlineExceededError`)
  before they reach the device, at pop time and again at batch assembly,
  and assembly never waits past the earliest deadline in the batch.
- **micro-batching**: concurrent predicts of one shape and dtype
  coalesce into one device step, their rows padded up to the next
  power of two <= `max_batch_size` (`_bucket`), waiting at most
  `batch_window` seconds for stragglers.
- **circuit breaking**: `breaker_threshold` consecutive failed steps
  (a raising step, or non-finite outputs: the screen runs on the device
  and reads back only the count) open the `CircuitBreaker`; requests then
  fail fast with `ServiceUnavailableError` without touching the device,
  until after `breaker_reset_timeout` one probe closes it or re-opens it.
- **safe hot reload**: `reload(source)` loads a candidate from a path or
  a `CheckpointStore` (manifest verified first) onto the live network's
  device, validates it on a canary batch (finite outputs of the live
  model's width), quantizes it and runs the drift gate when asked, then
  swaps under a read-write lock: in-flight requests finish on the old
  model. The generation engine drains its slots (in-flight generations
  finish on the old weights) and swaps too; if it refuses, the predict
  path rolls back with a new version. A refused candidate raises typed
  (`CheckpointCorruptError`, `ModelValidationError`) and the old model
  keeps serving.

`predict` returns a host numpy array: the network's output rows for the
request, screened on the device, cut from the padded batch, and copied
to the host once (in f32 when the output is in a 16-bit type: numpy has
no bf16). `MultiLayerNetwork.output` runs in the parameter dtype in both
packages, whatever `compute_dtype` says, so a GPT with f32 masters
answers `predict` in f32 and takes the f32 flash route past
`attention_block_size`; its generation engine computes in the compute
dtype.

**Generation**: with `generation={...}` (`DecodeEngine` arguments, or
True), `generate(prompt_ids, n_tokens, ...)` runs through a lazily built
`serving.decode_engine.DecodeEngine` on the network's device that shares
the server's breaker, flight recorder and metrics, and inherits
`quantize["kv"]`.

**Quantized weights**: `quantize={"weights": "int8" | "bf16"}` serves a
quantized clone (`serving.quantize.quantize_net_weights`), made at
construction and again for every reload candidate before it is gated;
`drift_gate={"eval_set", "max_argmax_drift", "max_ppl_delta"}` scores it
against its own full-precision weights (`drift_report`) and refuses a
breach with `ModelValidationError`, at construction too.

Observability (`serving/observability.py`): every request joins or
mints a `Trace` (queue-wait and device-step spans, the end decision,
attached to a raised `ServingError`); the server owns a
`MetricsRegistry` (predict-latency and step histograms, queue-depth and
in-flight gauges, its `stats()`) and a `FlightRecorder` (timelines,
breaker transitions, reload events), shared with the engine and exposed
by `metrics_text()` / `metrics_snapshot()` / `flight_record()`.

Test seam: `infer_hooks=[hook]` calls `hook(phase, info)` at `pre_step`
and `post_step` around every device step.

**The cluster seams** (`serving/kv_transfer.py`,
`serving/prefix_directory.py`): `generation={..., "role", "qos",
"handoff_ttl"}` reach the engine; `set_tenant_quota`, `migrate_slots`,
`fetch_handoff`, `fetch_handoff_header`, `fetch_handoff_frame`,
`commit_handoff`, `abort_handoff`, `resume_generate`,
`bind_prefix_directory`, `prefix_depth`, `prefix_chains` and
`export_prefix` delegate to it, as the JAX server's do; a
`DisaggCoordinator` drives them across in-process servers.

`parallel={"tp": N}` shards the lazily built decode engine over the
process's first N slots (`serving/tp_engine.py`); it is checked when
the engine is built, as in the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.serving import observability
from deeplearning4j_tpu_torch.util.concurrency import assert_owned

logger = logging.getLogger("deeplearning4j_tpu_torch")


# ---------------------------------------------------------------------------
# typed give-up errors


class ServingError(RuntimeError):
    """Base class for every typed serving-tier give-up."""


class ServerOverloadedError(ServingError):
    """Admission control shed this request: the bounded queue is full.
    `retry_after` (seconds) estimates when capacity frees up."""

    def __init__(self, msg: str, retry_after: float = 0.1):
        super().__init__(msg)
        self.retry_after = retry_after


class OutOfPagesError(ServerOverloadedError):
    """The decode engine's paged KV pool cannot reserve enough pages
    for this request right now: memory-side admission control shed it
    at the door. Subclasses `ServerOverloadedError` so every existing
    overload handler (gateway retry_after payloads, serve-route shed
    counting) composes unchanged; `retry_after` estimates when enough
    pages free up."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before (or while) it could be
    served; it was shed without touching the accelerator."""


class ServiceUnavailableError(ServingError):
    """The circuit breaker is open (or the probe slot is taken while
    half-open): recent inference failed repeatedly, so requests fail
    fast instead of queueing behind a broken model. `retry_after`
    (seconds) is the time until the next half-open probe window."""

    def __init__(self, msg: str, retry_after: float = 0.1):
        super().__init__(msg)
        self.retry_after = retry_after


class InferenceFailedError(ServingError):
    """The device step for this request's batch raised, or produced
    non-finite outputs. Counted by the circuit breaker."""


class ModelValidationError(ServingError):
    """A hot-reload candidate failed canary validation (raised on the
    canary batch, produced non-finite outputs, or changed the output
    width). The previous model is still serving."""


class ServerClosedError(ServingError):
    """The server is shut (or shutting) down; no new requests are
    admitted and unfinished queued requests fail with this."""


class TenantQuotaExceededError(ServingError):
    """This tenant's own token-rate quota is exhausted — deliberately
    NOT a `ServerOverloadedError` subclass: a flooding tenant must hear
    about ITS budget, and well-behaved co-tenants must never see this
    error for someone else's flood. `retry_after` (seconds) is when the
    tenant's token bucket refills enough to admit this request."""

    def __init__(self, msg: str, retry_after: float = 0.1):
        super().__init__(msg)
        self.retry_after = retry_after


class AutoscaleError(ServingError):
    """The autoscaler could not complete a scale action: the supervisor
    exhausted its spawn budget, the pool refused the mutation, or the
    new replica never passed the probe ladder. The pool keeps serving
    at its previous size."""


# ---------------------------------------------------------------------------
# read-write lock (hot reload swaps under the write side; every device
# step holds the read side, so in-flight requests finish on the old model)


class _RWLock:
    """Writer-preferring reader-writer lock: once a writer is waiting,
    new readers queue behind it, so a reload cannot be starved by a
    steady request stream."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


# ---------------------------------------------------------------------------
# circuit breaker


class CircuitBreaker:
    """Classic three-state breaker over consecutive failures.

    closed --(threshold consecutive failures)--> open
    open --(reset_timeout elapsed)--> half_open (one probe admitted)
    half_open --(probe ok)--> closed; --(probe fails)--> open

    Thread-safe; all transitions are logged. Successes anywhere reset
    the consecutive-failure count."""

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout: float = 5.0,
                 on_event: Optional[Callable[[str], None]] = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout <= 0:
            raise ValueError("reset_timeout must be > 0")
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.on_event = on_event
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._pending_events: List[str] = []
        self.opens = 0  # telemetry: how many times the breaker tripped

    def _transition(self, state: str) -> None:
        if state != self._state:
            logger.warning("circuit breaker: %s -> %s", self._state, state)
            self._state = state
            if state == "open":
                self.opens += 1
                self._opened_at = time.monotonic()
            if self.on_event is not None:
                self._pending_events.append(state)

    def _take_events(self) -> List[str]:
        events, self._pending_events = self._pending_events, []
        return events

    def _fire(self, events: List[str]) -> None:
        # OUTSIDE the lock: a callback that reads .state / calls reset()
        # must not deadlock against the transition that fired it
        for state in events:
            self.on_event(state)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            out, events = self._state, self._take_events()
        self._fire(events)
        return out

    def _maybe_half_open(self) -> None:
        if self._state == "open" and \
                time.monotonic() - self._opened_at >= self.reset_timeout:
            self._transition("half_open")
            self._probe_in_flight = False

    def _reject_open_locked(self) -> None:
        assert_owned(self._lock, "CircuitBreaker._reject_open_locked")
        if self._state == "open":
            remaining = max(
                0.0, self.reset_timeout
                - (time.monotonic() - self._opened_at))
            raise ServiceUnavailableError(
                f"circuit breaker open after "
                f"{self._consecutive_failures} consecutive inference "
                f"failures; retry in {remaining:.3f}s",
                retry_after=remaining)

    def reject_if_open(self) -> None:
        """Fail-fast door check: raises `ServiceUnavailableError` while
        open, NEVER consumes the half-open probe slot (only `acquire`,
        whose caller always reports success/failure, may take it — a
        door check that took the slot could never give it back)."""
        with self._lock:
            self._maybe_half_open()
            try:
                self._reject_open_locked()
            finally:
                events = self._take_events()
        self._fire(events)

    def acquire(self) -> bool:
        """Gate one unit of work. Raises `ServiceUnavailableError` when
        open (retry_after = time to half-open) or when half-open with
        the probe slot already taken. Returns True when the caller IS
        the half-open probe — it MUST pass that token back to
        `record_success`/`record_failure` (both release the slot; only
        the probe's outcome drives half-open transitions, so a stale
        pre-open step finishing late cannot corrupt the probe state)."""
        with self._lock:
            self._maybe_half_open()
            try:
                self._reject_open_locked()
                probe = False
                if self._state == "half_open":
                    if self._probe_in_flight:
                        raise ServiceUnavailableError(
                            "circuit breaker half-open: probe in flight",
                            retry_after=self.reset_timeout / 4)
                    self._probe_in_flight = True
                    probe = True
            finally:
                events = self._take_events()
        self._fire(events)
        return probe

    def record_success(self, probe: bool = False) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if probe:
                self._probe_in_flight = False
                self._transition("closed")
            # a stale (non-probe) success during open/half_open only
            # resets the failure streak — the probe decides the state
            events = self._take_events()
        self._fire(events)

    def record_failure(self, probe: bool = False) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if probe:
                self._probe_in_flight = False
                self._transition("open")  # failed probe: re-open
            elif self._state == "closed" and \
                    self._consecutive_failures >= self.failure_threshold:
                self._transition("open")
            events = self._take_events()
        self._fire(events)

    def reset(self) -> None:
        """Force-close (used after a successful hot reload: the new
        model's health is proven by the canary, not inherited)."""
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            self._transition("closed")
            events = self._take_events()
        self._fire(events)


# ---------------------------------------------------------------------------
# requests


class _Request:
    __slots__ = ("features", "deadline", "event", "result", "error",
                 "enqueued_at", "trace")

    def __init__(self, features: np.ndarray, deadline: Optional[float]):
        self.features = features
        self.deadline = deadline
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.monotonic()
        # the request's timeline, carried across the caller-thread →
        # executor-thread hop (thread-locals don't cross it)
        self.trace = observability.NULL_TRACE

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) >= self.deadline

    def finish(self, result=None, error: Optional[BaseException] = None):
        self.result = result
        self.error = error
        self.event.set()


def _bucket(n: int, max_batch: int) -> int:
    """Next power-of-two >= n, capped at max_batch: the batch shapes a
    server runs stay O(log max_batch)."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)




# ---------------------------------------------------------------------------
# the server


def _host_rows(out) -> np.ndarray:
    """One host copy of a device output, in f32 when it is in a 16-bit
    float type (numpy has no bf16)."""
    import torch

    if out.dtype in (torch.bfloat16, torch.float16):
        out = out.float()
    return out.cpu().numpy()


class ModelServer:
    """Admission-controlled, deadline-aware, breaker-protected serving
    wrapper around a network (see the module docstring). It serves on
    the network's device.

    `predict(x)` is thread-safe and blocking: any number of caller
    threads may call it concurrently; compatible concurrent calls
    coalesce into one device step.
    """

    def __init__(self, net, *, max_queue: int = 64, max_concurrent: int = 1,
                 max_batch_size: int = 64, batch_window: float = 0.002,
                 default_timeout: Optional[float] = None,
                 breaker_threshold: int = 5,
                 breaker_reset_timeout: float = 5.0,
                 canary: Optional[np.ndarray] = None,
                 auto_canary: bool = True,
                 infer_hooks: Sequence[Callable] = (),
                 pad_batches: bool = True,
                 generation: Optional[dict] = None,
                 quantize: Optional[dict] = None,
                 drift_gate: Optional[dict] = None,
                 parallel: Optional[dict] = None):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        # weights are quantized HERE, at construction and again for every
        # reload candidate, before canary and drift validation, so the
        # numerics that serve are the numerics that get gated
        if quantize is not None:
            unknown = set(quantize) - {"weights", "kv"}
            if unknown:
                raise ValueError(f"unknown quantize keys: {sorted(unknown)}")
            if quantize.get("weights") not in (None, "int8", "bf16"):
                raise ValueError(
                    "quantize['weights'] must be 'int8' or 'bf16', got "
                    f"{quantize.get('weights')!r}")
            if quantize.get("kv") not in (None, "int8"):
                raise ValueError("quantize['kv'] must be 'int8', got "
                                 f"{quantize.get('kv')!r}")
        self._quantize_cfg = dict(quantize) if quantize else None
        # tensor-parallel serving (serving/tp_engine.py): checked when
        # the decode engine is built, as it is the engine that shards
        if parallel is not None and not isinstance(parallel, dict):
            raise ValueError('parallel must be a dict like {"tp": N}')
        self._parallel_cfg = dict(parallel) if parallel else None
        if drift_gate is not None:
            unknown = set(drift_gate) - {"eval_set", "max_argmax_drift",
                                         "max_ppl_delta"}
            if unknown:
                raise ValueError(
                    f"unknown drift_gate keys: {sorted(unknown)}")
            if drift_gate.get("eval_set") is None:
                raise ValueError(
                    "drift_gate needs an 'eval_set' (pinned (B, T) token "
                    "ids the argmax-drift / perplexity gates score)")
        self._drift_gate = dict(drift_gate) if drift_gate else None
        self.drift_gate_checks = 0  # guarded by: _cond
        self.drift_gate_failures = 0  # guarded by: _cond
        self._last_drift: Optional[dict] = None  # guarded by: _cond
        wq = self._quantize_cfg.get("weights") if self._quantize_cfg \
            else None
        self._weight_bits = {"int8": 8, "bf16": 16}.get(wq, 32)
        if wq is not None:
            from deeplearning4j_tpu_torch.serving.quantize import (
                quantize_net_weights,
            )

            raw = net
            net = quantize_net_weights(net, wq)
            # the full-precision net is the drift reference
            self._raw_net = raw
        else:
            self._raw_net = net
        self._net = net  # guarded by: _rwlock.write()
        self.max_queue = max_queue
        self.max_batch_size = max_batch_size
        self.batch_window = batch_window
        self.default_timeout = default_timeout
        self.pad_batches = pad_batches
        self.infer_hooks: List[Callable] = list(infer_hooks)
        self.breaker = CircuitBreaker(failure_threshold=breaker_threshold,
                                      reset_timeout=breaker_reset_timeout)
        # one registry and one recorder, shared with the lazily built
        # decode engine, cover both serving paths
        self.metrics = observability.MetricsRegistry()
        self.recorder = observability.FlightRecorder()
        self.metrics.register_stats("model_server", self.stats)
        self._latency_hist = self.metrics.histogram(
            "model_server_predict_latency_ms")
        self._step_hist = self.metrics.histogram("model_server_step_ms")
        self.metrics.gauge("model_server_queue_depth",
                           lambda: len(self._queue))
        self.metrics.gauge("model_server_in_flight",
                           lambda: self._in_flight)
        self.breaker.on_event = self._breaker_event
        self._canary = None if canary is None else np.asarray(canary)  # guarded by: _cond
        # with auto_canary, the first served request donates its leading
        # row as the reload-validation batch
        self.auto_canary = auto_canary
        self._rwlock = _RWLock()
        self._reload_lock = threading.Lock()
        self.model_version = 0  # guarded by: _rwlock.write()
        # a deque under one condition: executors peek deadlines and pop
        # several compatible requests per batch
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()  # guarded by: _cond
        self._in_flight = 0  # guarded by: _cond
        self._closed = False  # guarded by: _cond
        self._step_latency_ewma = 0.01  # guarded by: _cond
        # generation tier: DecodeEngine arguments (or {} for defaults);
        # the engine is built on the first generate()
        self._generation_cfg = {} if generation is True else generation
        self._engine = None  # guarded by: _engine_lock
        self._engine_lock = threading.Lock()
        # a prefix-directory binding made before the lazy engine exists,
        # applied when it is built
        self._prefix_bind = None  # guarded by: _engine_lock
        # counters
        self.served = 0          # guarded by: _cond — requests completed
        self.batches = 0         # guarded by: _cond — device steps dispatched
        self.rows_dispatched = 0  # guarded by: _cond — rows across micro-batches
        self.shed_overload = 0   # guarded by: _cond — rejected at admission
        self.shed_deadline = 0   # guarded by: _cond — expired pre device step
        self.shed_unavailable = 0  # guarded by: _cond — open-breaker rejects
        self.failures = 0        # guarded by: _cond — bad device steps
        self.reloads = 0  # guarded by: _reload_lock
        self.reload_rejections = 0  # guarded by: _cond
        if wq is not None and self._drift_gate is not None:
            # a server must not start serving numerics it would refuse to
            # reload into
            self._check_drift_gate(self._raw_net, self._net)
        self._threads = [
            threading.Thread(target=self._serve_loop, daemon=True,
                             name=f"model-server-exec-{i}")
            for i in range(max_concurrent)]
        for t in self._threads:
            t.start()

    # -- public surface ----------------------------------------------------
    @property
    def net(self):
        """The live model (read-only peek; swapped by `reload`)."""
        return self._net

    def _breaker_event(self, state: str) -> None:
        # fired by CircuitBreaker outside its lock
        self.recorder.event("breaker", state=state)
        self.metrics.counter("model_server_breaker_transitions").inc()

    def _shed_obs(self, trace, err: BaseException, kind: str = "predict"):
        """Stamp a typed give-up onto the request's timeline, attach the
        timeline to the error, and pin it in the failures ring."""
        decision = type(err).__name__
        trace.finish(decision)
        observability.attach_trace(err, trace)
        self.recorder.record(trace, decision, kind=kind)

    def flight_record(self) -> dict:
        """The flight recorder's dump: request timelines, pinned
        failures, breaker, reload and engine events."""
        return self.recorder.dump()

    def metrics_text(self, labels=None) -> str:
        """Prometheus-style text exposition of the metrics registry;
        `labels` (e.g. ``{"model": name}``) keep several servers' series
        apart on one scrape page."""
        return self.metrics.exposition(labels=labels)

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def stats(self) -> dict:
        with self._cond:
            queued = len(self._queue)
            in_flight = self._in_flight
            ewma_ms = 1e3 * self._step_latency_ewma
            # how full dispatched micro-batches are against
            # max_batch_size: low means under-occupied device steps
            fill = (100.0 * self.rows_dispatched
                    / (self.batches * self.max_batch_size)
                    if self.batches else 0.0)
        out = {"served": self.served, "batches": self.batches,
               "batch_fill_pct": round(fill, 1),
               "shed_overload": self.shed_overload,
               "shed_deadline": self.shed_deadline,
               "shed_unavailable": self.shed_unavailable,
               "failures": self.failures, "reloads": self.reloads,
               "reload_rejections": self.reload_rejections,
               "breaker_state": self.breaker.state,
               "breaker_opens": self.breaker.opens,
               "model_version": self.model_version, "queued": queued,
               # "queue_depth" aliases "queued": the routing contract's
               # name beside the historical one
               "in_flight": in_flight, "queue_depth": queued,
               "ewma_latency_ms": round(ewma_ms, 3),
               "weight_bits": self._weight_bits,
               "drift_gate_checks": self.drift_gate_checks,
               "drift_gate_failures": self.drift_gate_failures}
        with self._cond:
            last_drift = self._last_drift
        if last_drift is not None:
            out["drift"] = dict(last_drift)
        engine = self._engine
        if engine is not None:
            gen = engine.stats()
            # the engine's headline numbers at the top level, beside the
            # predict path's
            out["slot_occupancy_pct"] = gen["slot_occupancy_pct"]
            out["pages_in_use"] = gen["pages_in_use"]
            out["page_fragmentation_pct"] = gen["page_fragmentation_pct"]
            out["prefill_chunks"] = gen["prefill_chunks"]
            for key in ("prefix_hit_tokens_pct", "spec_accept_rate",
                        "spec_tokens_per_step"):
                if key in gen:
                    out[key] = gen[key]
            out["preemptions"] = gen["preemptions"]
            out["slo_sheds"] = gen["slo_sheds"]
            out["shed_quota"] = gen["shed_quota"]
            out["generation"] = gen
        return out

    def predict(self, x, timeout: Optional[float] = None) -> np.ndarray:
        """Serve one request: features `x` of shape (B, ...). Blocks
        until the result (a host numpy array) is ready or a typed give-up
        fires (`ServerOverloadedError`, `DeadlineExceededError`,
        `ServiceUnavailableError`, `InferenceFailedError`,
        `ServerClosedError`). `timeout` (seconds; `default_timeout` when
        None) stamps the request's deadline."""
        x = np.asarray(x)
        if x.ndim < 2:
            raise ValueError(
                f"predict expects a batched (B, ...) array, got shape "
                f"{x.shape} — wrap a single example as x[None]")
        timeout = self.default_timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        trace = observability.maybe_trace()
        # fail fast at the door while the breaker is open (the door check
        # never takes the half-open probe slot: only an executor's
        # acquire/record pair may)
        try:
            self.breaker.reject_if_open()
        except ServiceUnavailableError as e:
            with self._cond:
                self.shed_unavailable += 1
            self._shed_obs(trace, e)
            raise
        req = _Request(x, deadline)
        req.trace = trace
        err: Optional[ServingError] = None
        with self._cond:
            # a full queue is swept of expired entries before the
            # queue-full verdict: each swept entry fails with its own
            # DeadlineExceededError
            now = time.monotonic()
            if len(self._queue) >= self.max_queue:
                live = [r for r in self._queue
                        if not self._pop_expired(r, now)]
                if len(live) != len(self._queue):
                    self._queue.clear()
                    self._queue.extend(live)
            if self._closed:
                err = ServerClosedError("model server is shut down")
            elif deadline is not None and deadline <= now:
                self.shed_deadline += 1
                err = DeadlineExceededError(
                    "deadline expired before admission; request shed at "
                    "the door")
            elif len(self._queue) >= self.max_queue:
                self.shed_overload += 1
                # backlog / capacity x EWMA step latency: when the queue
                # has likely drained enough to admit us
                retry = max(0.001, self._step_latency_ewma
                            * (len(self._queue) / max(1, len(self._threads))
                               / max(1, self.max_batch_size) + 1))
                err = ServerOverloadedError(
                    f"request queue full ({self.max_queue} pending); "
                    f"retry in {retry:.3f}s", retry_after=retry)
            else:
                trace.event("admission", queue_depth=len(self._queue))
                self._queue.append(req)
                self._cond.notify()
        if err is not None:
            self._shed_obs(trace, err)
            raise err
        wait = None if deadline is None \
            else max(0.0, deadline - time.monotonic()) + 30.0
        if not req.event.wait(wait):  # executors always finish requests;
            err = InferenceFailedError(  # this is a last bound
                "request was never completed (executor stalled)")
            self._shed_obs(trace, err)
            raise err
        if req.error is not None:
            self._shed_obs(trace, req.error)
            raise req.error
        with self._cond:
            self.served += 1
        trace.finish("served")
        self._latency_hist.observe(
            1e3 * (time.monotonic() - req.enqueued_at))
        self.recorder.record(trace, "served", kind="predict")
        return req.result

    def __call__(self, x, timeout: Optional[float] = None) -> np.ndarray:
        return self.predict(x, timeout=timeout)

    def pending(self) -> int:
        """Queued + in-flight requests across both serving paths (the
        predict queue and the decode engine's queued and in-slot
        generations)."""
        with self._cond:
            n = len(self._queue) + self._in_flight
        engine = self._engine
        if engine is not None:
            n += engine.pending()
        return n

    def probe(self, x=None,
              timeout: Optional[float] = None) -> Optional[bool]:
        """Active health probe through the full predict path: True when
        the canary (or `x`) was served, False on sickness (a failed or
        non-finite step, an open breaker), None when inconclusive (shed
        on load or time, or no batch to probe with and the breaker not
        open)."""
        batch = x if x is not None else self._canary
        if batch is None:
            return False if self.breaker.state == "open" else None
        try:
            self.predict(np.asarray(batch), timeout=timeout)
        except (ServerOverloadedError, DeadlineExceededError):
            return None  # load/time shed: not evidence of sickness
        except ServingError:
            return False
        return True

    def restore_model(self, net) -> int:
        """Swap `net` in WITHOUT canary validation: the rollback seam
        that puts known-good weights back. Same swap discipline as
        `reload` (write lock, engine drain, breaker reset, a new
        version); the same net object keeps the engine's pools. Returns
        the new model_version."""
        with self._reload_lock:
            with self._rwlock.write():
                self._net = net
                self._raw_net = net  # restored weights are their own
                self.model_version += 1  # drift reference
                version = self.model_version
            with self._engine_lock:
                engine = self._engine
            if engine is not None:
                engine.drain_and_swap(net)
            self.breaker.reset()
            self.recorder.event("reload", decision="rolled-back",
                                model_version=version)
            logger.warning("model server: restored previous model "
                           "(model_version=%d)", version)
            return version

    # -- generation (continuous batching) ----------------------------------
    def _ensure_engine(self):
        if self._generation_cfg is None:
            raise ServingError(
                "generation serving is not enabled — construct the server "
                "with generation={...} (DecodeEngine kwargs) or "
                "generation=True")
        # the closed check and the lazy build share the engine lock, and
        # shutdown() reads the engine under it: a generate() racing
        # shutdown() either sees _closed or builds an engine shutdown()
        # then drains
        with self._engine_lock:
            with self._cond:
                if self._closed:
                    raise ServerClosedError("model server is shut down")
            if self._engine is None:
                from deeplearning4j_tpu_torch.serving.decode_engine import (
                    DecodeEngine,
                )

                cfg = dict(self._generation_cfg)
                cfg.setdefault("max_queue", self.max_queue)
                cfg.setdefault("breaker", self.breaker)
                cfg.setdefault("recorder", self.recorder)
                cfg.setdefault("metrics", self.metrics)
                if self._quantize_cfg and self._quantize_cfg.get("kv"):
                    cfg.setdefault(
                        "quantize", {"kv": self._quantize_cfg["kv"]})
                cfg.setdefault("device", self._net.device)
                if self._parallel_cfg:
                    cfg.setdefault("parallel", self._parallel_cfg)
                self._engine = DecodeEngine(self._net, **cfg)
                if self._prefix_bind is not None:
                    a, kw = self._prefix_bind
                    self._engine.bind_prefix_directory(*a, **kw)
            return self._engine

    # streaming sinks (`on_token=`) reach the engine in-process here; an
    # adapter that cannot ship a callable over a wire says False
    supports_stream_sink = True

    def generate(self, prompt_ids, n_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None,
                 tenant: Optional[str] = None,
                 priority: str = "interactive",
                 logprobs: int = 0,
                 on_token: Optional[Callable] = None):
        """Serve one generation request through the continuous-batching
        `DecodeEngine` (same breaker and typed give-ups as `predict`).
        Returns the generated token ids (1-D int32), or with
        `logprobs=K > 0` a dict ``{"tokens", "logprobs"}``;
        `on_token(cursor, token, logprob_entry)` is called per emitted
        token. `tenant` and `priority` feed the engine's QoS admission
        (per-tenant quotas; "interactive" preempts the "batch" lane under
        pressure)."""
        engine = self._ensure_engine()
        timeout = self.default_timeout if timeout is None else timeout
        return engine.generate(prompt_ids, n_tokens,
                               temperature=temperature, seed=seed,
                               timeout=timeout, tenant=tenant,
                               priority=priority, logprobs=logprobs,
                               on_token=on_token)

    def set_tenant_quota(self, tenant: str, rate: Optional[float] = None,
                         burst: Optional[float] = None,
                         max_pages: Optional[int] = None,
                         weight: Optional[float] = None) -> None:
        """Set (or clear, with `rate=None` / `max_pages=None`) a tenant's
        token-rate quota, page ceiling and batch-lane `weight` on the
        decode engine. Needs generation serving."""
        self._ensure_engine().set_tenant_quota(
            tenant, rate=rate, burst=burst, max_pages=max_pages,
            weight=weight)

    # -- KV handoff and live migration (kv_transfer) -----------------------
    def migrate_slots(self, wait: Optional[float] = 5.0) -> int:
        """Export every in-flight generation as a leased handoff (its
        waiter raises the `SlotMigratedError` redirect). 0 when
        generation was never exercised: an idle engine is not built to
        migrate nothing."""
        with self._engine_lock:
            if self._engine is None:
                return 0
        return self._ensure_engine().migrate_slots(wait=wait)

    def resume_generate(self, payload: dict,
                        timeout: Optional[float] = None, *,
                        on_token: Optional[Callable] = None):
        """Admit a fetched handoff payload and return the tail tokens
        this server generates (`KVTransferError` when the payload fails
        validation against this server's weights or geometry)."""
        timeout = self.default_timeout if timeout is None else timeout
        return self._ensure_engine().resume_generate(
            payload, timeout=timeout, on_token=on_token)

    def fetch_handoff(self, handoff_id: str) -> dict:
        return self._ensure_engine().fetch_handoff(handoff_id)

    def commit_handoff(self, handoff_id: str) -> bool:
        return self._ensure_engine().commit_handoff(handoff_id)

    def abort_handoff(self, handoff_id: str) -> bool:
        return self._ensure_engine().abort_handoff(handoff_id)

    # -- cluster prefix cache (prefix_directory) ---------------------------
    def bind_prefix_directory(self, directory, holder_id: str,
                              peers=None, **kw) -> "ModelServer":
        """Join a cluster prefix directory (chainable): applied to the
        engine now if it exists, else when the lazy engine is built, so
        binding never builds an engine a server may never use."""
        with self._engine_lock:
            self._prefix_bind = ((directory, holder_id, peers), kw)
            if self._engine is not None:
                self._engine.bind_prefix_directory(directory, holder_id,
                                                   peers, **kw)
        return self

    def prefix_depth(self, prompt_ids, tenant=None) -> int:
        """0 when generation was never exercised: nothing is resident."""
        with self._engine_lock:
            if self._engine is None:
                return 0
        return self._ensure_engine().prefix_depth(prompt_ids, tenant=tenant)

    def prefix_chains(self) -> dict:
        """{} when generation was never exercised: nothing is resident to
        publish."""
        with self._engine_lock:
            if self._engine is None:
                return {}
        return self._ensure_engine().prefix_chains()

    def export_prefix(self, prompt_ids, have_pages: int = 0,
                      tenant=None, frame_pages=None,
                      timeout=None) -> dict:
        return self._ensure_engine().export_prefix(
            prompt_ids, have_pages=have_pages, tenant=tenant,
            frame_pages=frame_pages, timeout=timeout)

    def fetch_handoff_header(self, handoff_id: str, skip_pages: int = 0,
                             frame_pages=None) -> dict:
        return self._ensure_engine().fetch_handoff_header(
            handoff_id, skip_pages=skip_pages, frame_pages=frame_pages)

    def fetch_handoff_frame(self, handoff_id: str, frame: int,
                            skip_pages: int = 0,
                            frame_pages=None) -> dict:
        return self._ensure_engine().fetch_handoff_frame(
            handoff_id, frame, skip_pages=skip_pages,
            frame_pages=frame_pages)

    # -- batch assembly ----------------------------------------------------
    def _pop_expired(self, req: _Request, now: float) -> bool:
        assert_owned(self._cond, "ModelServer._pop_expired")
        if req.expired(now):
            self.shed_deadline += 1
            req.finish(error=DeadlineExceededError(
                f"deadline expired {now - req.deadline:.3f}s ago while "
                "queued; request shed before the device step"))
            return True
        return False

    def _assemble(self) -> Optional[List[_Request]]:
        """Pop one deadline-respecting micro-batch (None = shut down and
        queue drained). Waits up to `batch_window` after the first
        request for compatible stragglers, but never past the earliest
        deadline in the forming batch less one EWMA step."""
        with self._cond:
            while True:
                now = time.monotonic()
                while self._queue and self._pop_expired(self._queue[0], now):
                    self._queue.popleft()
                if self._queue:
                    break
                if self._closed:
                    return None
                self._cond.wait(0.05)
            first = self._queue.popleft()
            batch = [first]
            rows = first.features.shape[0]
            shape, dtype = first.features.shape[1:], first.features.dtype
            margin = self._step_latency_ewma

            def _bound(end, deadline):
                return end if deadline is None \
                    else min(end, deadline - margin)

            window_end = _bound(time.monotonic() + self.batch_window,
                                first.deadline)
            while rows < self.max_batch_size:
                now = time.monotonic()
                if self._queue:
                    nxt = self._queue[0]
                    if self._pop_expired(nxt, now):
                        self._queue.popleft()
                        continue
                    if nxt.features.shape[1:] != shape \
                            or nxt.features.dtype != dtype \
                            or rows + nxt.features.shape[0] \
                            > self.max_batch_size:
                        break  # incompatible/overflow: next batch's problem
                    self._queue.popleft()
                    batch.append(nxt)
                    rows += nxt.features.shape[0]
                    window_end = _bound(window_end, nxt.deadline)
                    continue
                if now >= window_end or self._closed:
                    break
                self._cond.wait(window_end - now)
            self._in_flight += len(batch)
            return batch

    def _finish(self, batch: List[_Request], *, results=None, error=None):
        for i, req in enumerate(batch):
            req.finish(result=None if results is None else results[i],
                       error=error)
        with self._cond:
            self._in_flight -= len(batch)
            self._cond.notify_all()

    # -- the device step ---------------------------------------------------
    def _hook(self, phase: str, info: dict) -> None:
        for hook in self.infer_hooks:
            hook(phase, info)

    def _serve_loop(self) -> None:
        while True:
            batch = self._assemble()
            if batch is None:
                return
            # last deadline screen before the device: assembly may have
            # waited on a window; expired members are shed, not computed
            now = time.monotonic()
            live = []
            with self._cond:
                for req in batch:
                    if req.expired(now):
                        self.shed_deadline += 1
                        self._in_flight -= 1
                        req.finish(error=DeadlineExceededError(
                            "deadline expired during batch assembly; "
                            "request shed before the device step"))
                    else:
                        live.append(req)
                if not live:
                    self._cond.notify_all()
            if not live:
                continue
            for req in live:
                req.trace.add_timed("queue-wait", req.enqueued_at, now,
                                    batch=len(live))
            try:
                probe = self.breaker.acquire()
            except ServiceUnavailableError as e:
                with self._cond:
                    self.shed_unavailable += len(live)
                self._finish(live, error=e)
                continue
            try:
                results = self._execute(live)
            # the serve loop's firewall: the failure reaches every waiter
            # as InferenceFailedError; re-raising would kill the thread
            except Exception as e:
                self.breaker.record_failure(probe)
                with self._cond:
                    self.failures += len(live)
                err = e if isinstance(e, ServingError) else \
                    InferenceFailedError(
                        f"device step failed: {type(e).__name__}: {e}")
                logger.warning("model server: inference failure (%s)", err)
                self._finish(live, error=err)
                continue
            self.breaker.record_success(probe)
            self._finish(live, results=results)

    def _execute(self, batch: List[_Request]) -> List[np.ndarray]:
        """One device step for a micro-batch: pad to the bucket, run the
        network, screen the request rows for non-finite values on the
        device (only the count comes back), copy them to the host once,
        and split them per request."""
        from deeplearning4j_tpu_torch.optimize.health import (
            non_finite_array_reason,
        )

        feats = np.concatenate([r.features for r in batch], axis=0) \
            if len(batch) > 1 else batch[0].features
        rows = feats.shape[0]
        padded = rows
        if self.pad_batches:
            padded = _bucket(rows, self.max_batch_size)
            if padded > rows:
                pad = np.zeros((padded - rows,) + feats.shape[1:],
                               feats.dtype)
                feats = np.concatenate([feats, pad], axis=0)
        info = {"batch_size": rows, "padded_size": padded,
                "requests": len(batch), "model_version": self.model_version}
        t0 = time.monotonic()
        with self._rwlock.read():
            self._hook("pre_step", info)
            out = self._net.output(feats)[:rows]
            reason = non_finite_array_reason(out, "outputs")
            host = None if reason is not None else _host_rows(out)
            self._hook("post_step", info)
        t1 = time.monotonic()
        # one device step serves the whole micro-batch: the same span
        # lands on every member's timeline
        for req in batch:
            req.trace.add_timed("device-step", t0, t1, rows=rows,
                                padded=padded, requests=len(batch),
                                model_version=info["model_version"])
        self._step_hist.observe(1e3 * (t1 - t0))
        with self._cond:  # concurrent executors must not lose updates
            self._step_latency_ewma = (0.8 * self._step_latency_ewma
                                       + 0.2 * (t1 - t0))
            self.batches += 1
            self.rows_dispatched += rows
        if reason is not None:
            raise InferenceFailedError(
                f"model produced poisoned predictions: {reason}")
        if self._canary is None and self.auto_canary:
            # a concurrent executor may be donating its own row; the
            # first publication under the lock wins
            with self._cond:
                if self._canary is None:
                    self._canary = np.array(batch[0].features[:1])
        results, lo = [], 0
        for req in batch:
            hi = lo + req.features.shape[0]
            results.append(host[lo:hi])
            lo = hi
        return results

    # -- hot reload --------------------------------------------------------
    def reload(self, source, step: Optional[int] = None,
               canary: Optional[np.ndarray] = None) -> int:
        """Safely swap in a new model under live traffic.

        `source` is a checkpoint path or a `util.checkpoint_store
        .CheckpointStore` (newest verified step when `step` is None),
        restored onto the live network's device. The integrity manifest
        is verified before any bytes are trusted, then the candidate must
        pass canary validation (accept the canary batch, produce finite
        outputs of the live model's output width), and with quantized
        weights the drift gate, BEFORE the swap: a refused candidate
        raises `CheckpointCorruptError` / `ModelValidationError` with the
        old model still serving. The swap happens under the write lock
        (in-flight requests finish on the old model), the generation
        engine drains and swaps, and the breaker resets. Returns the new
        `model_version`."""
        with self._reload_lock:
            try:
                candidate = self._load_candidate(source, step)
                raw_candidate = candidate
                wq = self._quantize_cfg.get("weights") \
                    if self._quantize_cfg else None
                if wq is not None:
                    from deeplearning4j_tpu_torch.serving.quantize import (
                        quantize_net_weights,
                    )

                    # quantize BEFORE validation: the canary and drift
                    # gates score the numerics that will serve
                    candidate = quantize_net_weights(raw_candidate, wq)
                self._validate_candidate(candidate, canary)
                if wq is not None and self._drift_gate is not None:
                    self._check_drift_gate(raw_candidate, candidate)
            except Exception as e:
                # every pre-swap failure is a refused deploy: integrity
                # and canary refusals alike show in the counter
                with self._cond:
                    self.reload_rejections += 1
                self.recorder.event("reload", decision="rejected",
                                    error=type(e).__name__)
                raise
            with self._rwlock.write():
                old_net = self._net
                old_raw = self._raw_net
                self._net = candidate
                self._raw_net = raw_candidate
                self.model_version += 1
                version = self.model_version
            # the engine drains its slots (in-flight generations finish on
            # the old weights), swaps, and serves queued and new requests
            # on the candidate. Outside the rwlock: generation steps keep
            # running while it drains. Read under _engine_lock, so a first
            # generate() that is mid-build cannot install an old-weights
            # engine this reload never sees
            with self._engine_lock:
                engine = self._engine
            if engine is not None:
                try:
                    engine.drain_and_swap(candidate)
                except BaseException:
                    # the engine refused the swap and serves the old
                    # weights: roll the predict path back too, as its own
                    # version, so versions stay monotonic
                    with self._rwlock.write():
                        self._net = old_net
                        self._raw_net = old_raw
                        self.model_version += 1
                    with self._cond:
                        self.reload_rejections += 1
                    self.recorder.event("reload", decision="rolled-back",
                                        model_version=self.model_version)
                    raise
            self.breaker.reset()
            self.reloads += 1
            self.recorder.event("reload", decision="complete",
                                model_version=version)
            logger.warning("model server: hot reload complete "
                           "(model_version=%d)", version)
            return version

    def _load_candidate(self, source, step: Optional[int]):
        """The candidate network, restored on the live network's
        device."""
        from deeplearning4j_tpu_torch.util.checkpoint_store import (
            CheckpointStore,
            manifest_path_for,
            verify_manifest,
        )
        from deeplearning4j_tpu_torch.util.serialization import restore_model

        device = self._net.device

        def load(path):
            return restore_model(path, device=device)

        if isinstance(source, CheckpointStore):
            if step is None:
                candidate, got = source.load_latest_verified(load)
                logger.info("reload candidate: checkpoint step %d", got)
                return candidate
            source.verify(step)
            return load(source.path_for(step))
        path = Path(source)
        if manifest_path_for(path).exists():
            verify_manifest(path)  # raises CheckpointCorruptError on drift
        else:
            logger.warning("reload candidate %s has no integrity manifest; "
                           "loading unverified", path)
        return load(path)

    def _validate_candidate(self, candidate,
                            canary: Optional[np.ndarray]) -> None:
        from deeplearning4j_tpu_torch.optimize.health import (
            non_finite_array_reason,
        )

        canary = canary if canary is not None else self._canary
        if canary is None:
            logger.warning("model server: no canary batch configured — "
                           "hot-reload candidate swaps in UNVALIDATED "
                           "(pass canary= to the server or to reload())")
            return
        canary = np.asarray(canary)
        try:
            out = candidate.output(canary)
        except Exception as e:
            raise ModelValidationError(
                f"reload candidate rejected: canary batch of shape "
                f"{canary.shape} raised {type(e).__name__}: {e}") from e
        reason = non_finite_array_reason(out, "canary outputs")
        if reason is not None:
            raise ModelValidationError(
                f"reload candidate rejected: {reason} on the canary batch "
                "(non-finite parameters or a numerically broken graph)")
        try:
            live_shape = tuple(self._net.output(canary).shape)
        # the live model failing the canary must not block reloading a
        # good candidate: the width contract check is skipped
        except Exception:
            live_shape = None
        if live_shape is not None \
                and live_shape[1:] != tuple(out.shape[1:]):  # width contract
            raise ModelValidationError(
                f"reload candidate rejected: output shape "
                f"{tuple(out.shape[1:])} != live model's {live_shape[1:]} — "
                "clients would observe a silent contract break")

    def _check_drift_gate(self, reference, candidate) -> None:
        """Score the QUANTIZED candidate against its own full-precision
        weights on the pinned eval set (argmax disagreement and
        perplexity delta, `serving.quantize.drift_report`). A breach
        raises `ModelValidationError` before any swap. The reference is
        the raw candidate, never the live net: new weights legitimately
        differ from old ones; the gate polices what quantization
        changed."""
        from deeplearning4j_tpu_torch.serving.quantize import drift_report

        gate = self._drift_gate
        ids = np.asarray(gate["eval_set"])
        try:
            ref_out = _host_rows(reference.output(ids))
            cand_out = _host_rows(candidate.output(ids))
        except Exception as e:
            raise ModelValidationError(
                f"drift gate could not score the eval set "
                f"{ids.shape}: {type(e).__name__}: {e}") from e
        report = drift_report(ref_out, cand_out, ids)
        max_drift = gate.get("max_argmax_drift")
        max_ppl = gate.get("max_ppl_delta")
        breaches = []
        if max_drift is not None and report["argmax_drift"] > max_drift:
            breaches.append(
                f"argmax drift {report['argmax_drift']:.4f} > "
                f"{max_drift}")
        if max_ppl is not None and report["ppl_delta"] > max_ppl:
            breaches.append(
                f"perplexity delta {report['ppl_delta']:.4f} > {max_ppl}")
        with self._cond:
            self.drift_gate_checks += 1
            if breaches:
                self.drift_gate_failures += 1
            self._last_drift = report
        if breaches:
            self.recorder.event("drift-gate", decision="rejected",
                                **report)
            raise ModelValidationError(
                "quantized candidate rejected by drift gate: "
                + "; ".join(breaches))
        self.recorder.event("drift-gate", decision="accepted", **report)

    # -- shutdown ----------------------------------------------------------
    def shutdown(self, drain_timeout: float = 10.0) -> bool:
        """Stop admission, drain queued + in-flight requests (both paths,
        at the same time) for up to `drain_timeout` seconds, fail the rest
        with `ServerClosedError`, and join the executor threads. Returns
        True when every admitted request finished. Idempotent."""
        deadline = time.monotonic() + drain_timeout
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        with self._engine_lock:  # see _ensure_engine: closes the race
            engine = self._engine  # with a concurrent lazy construction
        drained = True
        engine_result: dict = {}
        engine_thread = None
        if engine is not None:
            # the engine drains concurrently with the predict queue, on
            # the same budget
            engine_thread = threading.Thread(
                target=lambda: engine_result.update(
                    ok=engine.shutdown(drain_timeout=drain_timeout)),
                daemon=True)
            engine_thread.start()
        with self._cond:
            while self._queue or self._in_flight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    drained = False
                    while self._queue:
                        self._queue.popleft().finish(
                            error=ServerClosedError(
                                "server shut down before this request "
                                "could be served"))
                    break
                self._cond.wait(min(remaining, 0.05))
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()) + 1.0)
        if engine_thread is not None:
            engine_thread.join(max(0.0, deadline - time.monotonic()) + 5.0)
            drained = drained and engine_result.get("ok", False)
        if not drained:
            logger.warning("model server: shutdown drain timed out with "
                           "requests still pending")
        return drained
