"""Cross-process replica pool: remote replicas over the gateway protocol
(counterpart of `deeplearning4j_tpu/serving/remote_replica.py`).

`ReplicaPool` makes N replicas one service, but all N share the pool's
address space (and, on one card, one interpreter lock), so a hard crash
(`kill -9`), a wedged interpreter, or a host partition is still one
failure domain. The reference stack's scaleout tier serves model
replicas across JVM processes and hosts; this module is that promotion
for the pool:

- **`RemoteReplica`** — an adapter presenting the replica seam the
  pool already routes through (`predict`/`generate`/`probe`/`pending`/
  `stats`/`flight_record`/`restore_model`/`reload`/`breaker.state`/
  `metrics.exposition`) over the gateway wire protocol to a
  `ModelServer` living in ANOTHER process or host. Every network edge
  carries fault discipline: read deadlines derived from the request
  deadline (+`deadline_margin`), bounded exponential-backoff retries
  for idempotent calls only (`GatewayClient`), keep-alive connection
  pooling with stale-connection replacement, and partial-read /
  oversize / garbage-response handling (`GatewayProtocolError`) mapped
  onto the existing typed `ServingError` taxonomy — so eviction,
  three-valued probe verdicts, failover, hedging, degraded mode, and
  the shared admission budget all work UNCHANGED on remote replicas.
- **`ReplicaEntryPoint`** — the replica-process side: the gateway
  `EntryPoint` plus the pool-management RPCs the seam needs
  (`snapshot_model`/`restore_snapshot` for rolling-reload rollback
  across the process boundary, `replica_metrics`, `health`). Runnable
  as ``python -m deeplearning4j_tpu_torch.serving.remote_replica``;
  `--device` (default ``cuda``) is where the replica serves, and a
  replica asked for the card on a machine without one dies at startup
  (its supervisor raises `ReplicaSpawnError` with the log tail) rather
  than serving on the CPU. `--slots N` exposes N slots of that device
  (`parallel.mesh.set_local_slots`), so a `parallel={"tp": N}` replica
  runs on one card; the supervisor passes it from the serving config.
- **`ReplicaSupervisor`** — spawns (each a fresh interpreter, never a
  fork of a process holding a CUDA context; the CUDA sources are built
  once in the parent first), watches, and respawns replica
  processes with bounded restart backoff (doubling per quick death up
  to `max_backoff`, give-up past `max_restarts` deaths inside
  `restart_window`). A `kill -9` costs the pool a failover plus one
  supervised respawn — never the service.
- **`RemoteReplicaPool` / `spawn_replica_pool`** — the pool subclass
  binding the two, keeping `rolling_reload`'s pool-wide-rollback
  guarantee when a replica dies mid-deploy (weights roll back via
  per-replica snapshots; a peer that dies mid-rollback is evicted +
  marked stale instead of stranding the others on the new version).

Traces cross the wire: the pool's trace context (trace_id + a
monotonic/wall-clock anchor pair) travels on each request, the remote
gateway JOINS that trace_id, and the returned remote timeline is
grafted into the local one via the wall-clock anchors
(`observability.graft_remote_trace`) — one causally-ordered timeline
per request in the flight recorder, process boundary and all.

A replica process that stops cleanly writes its kernel counts (the paged
and flash wrappers' launches and plain calls over its life) as one line
of its log, which `replica_launch_counts` reads: a replica's launches
happen in its own process, where the parent's counts cannot see them.
SIGUSR1 makes a serving replica write the same line at once, so that a
caller can read the counts of a window as the difference of two lines.

Single-host-multi-process vs multi-host: the supervisor spawns local
processes, and `snapshot_model`/`restore_snapshot`/`reload` exchange
CHECKPOINT PATHS — both ends must see the same filesystem. Multi-host
deployments point `RemoteReplica` at remote gateways directly (no
supervisor) over a shared filesystem for the deploy paths.

`tests/test_torch_remote_replica.py` drives the wire ladders
in-process; `tests/test_torch_remote_replica_mp.py` runs the
separate-process chaos drills (kill -9 / partition / crash-mid-deploy
under live traffic).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.gateway import (
    EntryPoint,
    GatewayClient,
    GatewayError,
    GatewayProtocolError,
    GatewayServer,
)
from deeplearning4j_tpu_torch.serving import observability
from deeplearning4j_tpu_torch.serving.kv_transfer import (
    KVTransferError,
    SlotMigratedError,
)
from deeplearning4j_tpu_torch.serving.model_server import (
    DeadlineExceededError,
    InferenceFailedError,
    ModelValidationError,
    OutOfPagesError,
    ServerClosedError,
    ServerOverloadedError,
    ServiceUnavailableError,
    ServingError,
    TenantQuotaExceededError,
)
from deeplearning4j_tpu_torch.serving.replica_pool import (
    ReplicaEvictedError,
    ReplicaPool,
)
from deeplearning4j_tpu_torch.util.serialization import (
    restore_model as _read_model_file,
    write_model as _write_model_file,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")

_REPO_ROOT = Path(__file__).resolve().parents[2]
# the prefix of the kernel-count line a replica writes when it stops
_COUNTS_PREFIX = "replica launch counts: "


def free_port() -> int:
    """A free localhost TCP port (a copy of the JAX package's
    `parallel.multiprocess.free_port`)."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch_counts(final: bool) -> dict:
    """This process's paged and flash counts: kernel launches by key and
    plain-version calls."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    def keyed(d):
        return {",".join(map(str, k)): int(n) for k, n in d.items()}

    return {"pid": os.getpid(), "final": final,
            "paged": keyed(pa.paged_attention.launches_by),
            "paged_plain": int(pa.paged_attention_plain.calls),
            "flash": keyed(fa.launches_by_route),
            "flash_plain": int(fa.flash_attention_plain_fwd.calls)}


def replica_launch_counts(log_path) -> List[dict]:
    """The kernel-count lines of a replica log, oldest first: one per
    SIGUSR1 (``"final": False``) and one per process life that stopped
    cleanly (``"final": True``; a killed process writes none), each
    ``{"pid", "final", "paged": {"C,pools": n}, "paged_plain", "flash":
    {"kind,route": n}, "flash_plain"}`` over the life so far."""
    out = []
    with contextlib.suppress(OSError):
        # whole lines only: a line being written has no newline yet
        text = Path(log_path).read_text(errors="replace")
        for line in text.split("\n")[:-1]:
            if line.startswith(_COUNTS_PREFIX):
                out.append(json.loads(line[len(_COUNTS_PREFIX):]))
    return out

# every replica pid this process ever spawned and has not yet reaped —
# the test suite's autouse reaper kills leftovers so a failing chaos
# drill cannot leak interpreter processes past its test
_ORPHAN_PIDS: set = set()
# live supervisors, weakly held: their pids are NOT orphans while the
# supervisor is open (a shared long-lived pool must survive the reaper
# running between tests)
_LIVE_SUPERVISORS: "weakref.WeakSet" = weakref.WeakSet()


def reap_orphans() -> int:
    """SIGKILL every replica process this process spawned whose
    supervisor is closed or gone (crash-test hygiene; normal shutdown
    goes through `ReplicaSupervisor.stop`). Returns how many were
    signalled."""
    protected = set()
    for sup in list(_LIVE_SUPERVISORS or ()):
        if not sup._closed:
            protected.update(p.pid for p in sup._procs if p is not None)
    n = 0
    for pid in list(_ORPHAN_PIDS):
        if pid in protected:
            continue
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
            n += 1
        _ORPHAN_PIDS.discard(pid)
    return n


class ReplicaSpawnError(ServingError):
    """A replica process failed to come up (died during startup or
    never wrote its ready file within `spawn_timeout`)."""


# wire error_type -> local typed error. The remote's `ServerClosedError`
# deliberately maps to `ServiceUnavailableError`: the REMOTE server
# shutting down means THIS pool's replica went away (fail over), not
# that this pool is closed (terminal).
_WIRE_ERRORS: Dict[str, type] = {
    "ServerOverloadedError": ServerOverloadedError,
    "OutOfPagesError": OutOfPagesError,
    "ServiceUnavailableError": ServiceUnavailableError,
    "DeadlineExceededError": DeadlineExceededError,
    "InferenceFailedError": InferenceFailedError,
    "ModelValidationError": ModelValidationError,
    "ReplicaEvictedError": ReplicaEvictedError,
    "TenantQuotaExceededError": TenantQuotaExceededError,
    "ServerClosedError": ServiceUnavailableError,
    "KVTransferError": KVTransferError,
    "SlotMigratedError": SlotMigratedError,
}

# the transport failures a remote call can surface (socket.timeout IS
# TimeoutError on this Python; ConnectionError subclasses OSError)
_TRANSPORT_ERRORS = (GatewayError, GatewayProtocolError, TimeoutError,
                     ConnectionError, OSError)


class _RemoteSnapshot:
    """Pool-side handle to a replica-written weight snapshot: the
    `rolling_reload` rollback currency. Holding a PATH instead of a
    live net keeps pre-deploy snapshots out of this process's memory —
    restore ships the path back over the wire and the replica reloads
    it locally."""

    __slots__ = ("path", "version")

    def __init__(self, path: str, version: int):
        self.path = str(path)
        self.version = int(version)

    def __repr__(self):
        return f"_RemoteSnapshot({self.path!r}, v{self.version})"


class _RemoteBreakerView:
    """The pool's probe loop reads `rep.server.breaker.state`; for a
    remote replica that is the LAST OBSERVED state (refreshed by
    `stats()` and batchless probes). A remotely-open breaker the cache
    has not seen yet still evicts promptly — its typed sheds fail the
    next probe."""

    __slots__ = ("_replica",)

    def __init__(self, replica: "RemoteReplica"):
        self._replica = replica

    @property
    def state(self) -> str:
        return self._replica._breaker_state


class _RemoteMetricsView:
    """`rep.server.metrics.exposition(labels=...)` seam: fetches the
    remote server's full Prometheus text page over the wire."""

    __slots__ = ("_replica",)

    def __init__(self, replica: "RemoteReplica"):
        self._replica = replica

    def exposition(self, namespace: str = "dl4j", labels=None) -> str:
        rep = self._replica
        try:
            return rep._client.call("replica_metrics", name=rep.MODEL,
                                    labels=labels,
                                    _timeout=rep.rpc_timeout)
        except _TRANSPORT_ERRORS as e:
            logger.warning("remote replica %s: metrics unreachable (%s)",
                           rep.endpoint, type(e).__name__)
            return (f"# remote replica {rep.endpoint} unreachable: "
                    f"{type(e).__name__}\n")


class RemoteReplica:
    """One pool replica living in another process/host, reached over
    the gateway wire protocol (see module docstring). Presents exactly
    the seam `ReplicaPool` routes through, with every wire failure
    mapped into the typed `ServingError` taxonomy:

    - server-side typed errors travel as `error_type` and are
      reconstructed locally (`retry_after` hints survive — satellite
      of the failover contract);
    - transport failures (refused/reset/EOF) become
      `ServiceUnavailableError` — retryable, so the pool fails over;
    - protocol garbage (unparseable/truncated/oversize responses)
      becomes `InferenceFailedError` — retryable sickness that feeds
      passive eviction;
    - a fired read deadline becomes `DeadlineExceededError` when the
      caller bounded the request (terminal — the time is gone), else
      `ServiceUnavailableError`.

    Read deadlines derive from the request deadline: a call with
    `timeout=T` reads with `T + deadline_margin` so the remote's own
    typed deadline verdict wins the race against the socket timer
    whenever the peer is alive to deliver it."""

    MODEL = "replica"

    def __init__(self, host: str, port: int, *,
                 rpc_timeout: float = 30.0,
                 admin_timeout: float = 120.0,
                 deadline_margin: float = 2.0,
                 max_queue: int = 64,
                 retry_backoff: float = 0.05,
                 max_retries: int = 1,
                 pool_size: int = 2,
                 max_idle: float = 30.0,
                 scratch_dir=None):
        self.endpoint = f"{host}:{port}"
        self.rpc_timeout = rpc_timeout
        self.admin_timeout = admin_timeout
        self.deadline_margin = deadline_margin
        # the pool sums replica `max_queue`s into its admission budget;
        # mirror the remote server's configured queue depth here
        self.max_queue = max_queue
        self._scratch = Path(scratch_dir) if scratch_dir is not None \
            else Path(tempfile.gettempdir())
        # eager_connect=False: a replica process still booting must not
        # fail pool construction — the probe ladder owns reachability
        self._client = GatewayClient(host=host, port=port,
                                     timeout=rpc_timeout,
                                     retry_backoff=retry_backoff,
                                     max_retries=max_retries,
                                     pool_size=pool_size,
                                     max_idle=max_idle,
                                     eager_connect=False)
        self._lock = threading.Lock()
        self._pending = 0  # guarded by: _lock
        self._breaker_state = "closed"  # last observed; guarded by: _lock
        self._restore_counter = itertools.count()
        self.breaker = _RemoteBreakerView(self)
        self.metrics = _RemoteMetricsView(self)

    # -- error mapping -----------------------------------------------------
    def _wire_error(self, e: BaseException, *, deadline_bound: bool,
                    what: str) -> BaseException:
        """Map one wire failure into the typed taxonomy; returns `e`
        itself for error types with no local mapping (re-raised
        unchanged by the caller)."""
        if isinstance(e, GatewayError):
            cls = _WIRE_ERRORS.get(e.error_type or "")
            if cls is None:
                return e
            if cls is SlotMigratedError:
                # a redirect, not a failure: rebuild its routing fields
                # from the structured error payload so the pool can
                # fetch + resume the handoff on a peer
                data = getattr(e, "payload", None) or {}
                return SlotMigratedError(
                    f"remote replica {self.endpoint}: {e}",
                    handoff_id=str(data.get("handoff_id", "")),
                    tokens=[int(t) for t in data.get("tokens", [])],
                    source=data.get("source") or self.endpoint)
            err = cls(f"remote replica {self.endpoint}: {e}")
            retry_after = getattr(e, "retry_after", None)
            if retry_after is not None:
                err.retry_after = float(retry_after)
            return err
        if isinstance(e, GatewayProtocolError):
            return InferenceFailedError(
                f"remote replica {self.endpoint} answered {what} with "
                f"undecodable bytes: {e}")
        if isinstance(e, TimeoutError):
            if deadline_bound:
                return DeadlineExceededError(
                    f"remote replica {self.endpoint} exceeded the "
                    f"{what} deadline (read timed out)")
            return ServiceUnavailableError(
                f"remote replica {self.endpoint} timed out on {what} "
                "with no caller deadline", retry_after=0.05)
        if isinstance(e, OSError):  # incl. ConnectionError subclasses
            return ServiceUnavailableError(
                f"remote replica {self.endpoint} unreachable during "
                f"{what}: {type(e).__name__}: {e}", retry_after=0.05)
        return e

    def _raise_mapped(self, e: BaseException, *, deadline_bound: bool,
                      what: str):
        mapped = self._wire_error(e, deadline_bound=deadline_bound,
                                  what=what)
        if mapped is e:
            raise e
        raise mapped from e

    # -- data path ---------------------------------------------------------
    @contextlib.contextmanager
    def _count_pending(self):
        with self._lock:
            self._pending += 1
        try:
            yield
        finally:
            with self._lock:
                self._pending -= 1

    def pending(self) -> int:
        """In-flight wire calls from THIS pool — the least-loaded
        routing signal. Local by design: asking the remote for its
        queue depth would cost a round-trip per routing decision."""
        with self._lock:
            return self._pending

    def _wire_deadline(self, timeout: Optional[float]) -> float:
        if timeout is None:
            return self.rpc_timeout
        return float(timeout) + self.deadline_margin

    def _graft(self, trace, remote: Optional[dict]) -> None:
        if trace and remote:
            observability.graft_remote_trace(trace, remote,
                                             endpoint=self.endpoint)

    def _data_call(self, what: str, timeout: Optional[float],
                   **params):
        """One traced data-path RPC: trace context on the request,
        remote timeline grafted on the way out (success AND failure),
        wire failures mapped typed."""
        trace = observability.current_trace()
        ctx = observability.wire_trace_context(trace)
        with self._count_pending():
            try:
                out = self._client.call(
                    what, name=self.MODEL, timeout=timeout,
                    _timeout=self._wire_deadline(timeout), _trace=ctx,
                    **params)
            except _TRANSPORT_ERRORS as e:
                # a typed remote failure carries its timeline — graft
                # it so the pinned local trace names the remote spans
                self._graft(trace, getattr(e, "trace", None))
                self._raise_mapped(e, deadline_bound=timeout is not None,
                                   what=what)
            self._graft(trace, self._client.last_trace)
            return out

    def predict(self, x, timeout: Optional[float] = None) -> np.ndarray:
        return np.asarray(self._data_call(
            "predict", timeout, features=np.asarray(x, np.float32)))

    def generate(self, prompt_ids, n_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None,
                 tenant: Optional[str] = None,
                 priority: str = "interactive",
                 logprobs: int = 0):
        # logprobs rides the wire as a plain kwarg (omitted when 0 so
        # older gateways keep accepting the call); the dict reply passes
        # through un-coerced
        kw = {"logprobs": int(logprobs)} if logprobs else {}
        out = self._data_call(
            "generate", timeout, prompt_ids=np.asarray(prompt_ids),
            n_tokens=int(n_tokens), temperature=float(temperature),
            seed=int(seed), tenant=tenant, priority=priority, **kw)
        return out if isinstance(out, dict) else np.asarray(out)

    def set_tenant_quota(self, tenant: str, rate=None, burst=None,
                         max_pages=None, weight=None) -> None:
        """Push one tenant's token-rate quota, page ceiling, and
        batch-lane fair-queueing weight to the remote engine (the wire
        mirror of `ModelServer.set_tenant_quota`)."""
        self._client.call("set_tenant_quota", name=self.MODEL,
                          tenant=tenant, rate=rate, burst=burst,
                          max_pages=max_pages, weight=weight,
                          _timeout=self.rpc_timeout)

    # -- KV handoff / live migration ---------------------------------------
    def migrate_slots(self, wait: Optional[float] = 5.0) -> int:
        """Ask the remote engine to export its in-flight generations as
        leased handoffs (migrate-then-drain). Idempotent: re-running on
        an already-drained engine migrates zero slots."""
        try:
            return int(self._client.call(
                "migrate_slots", name=self.MODEL, wait=wait,
                _timeout=self._wire_deadline(wait)))
        except _TRANSPORT_ERRORS as e:
            self._raise_mapped(e, deadline_bound=wait is not None,
                               what="migrate_slots")

    def resume_generate(self, payload: dict,
                        timeout: Optional[float] = None):
        """Admit a fetched handoff payload on the remote engine; returns
        the TAIL tokens it generates (a `{"tokens", "logprobs"}` dict
        when the handoff carries logprobs). NOT retried on ambiguous
        wire failures — a re-send could double-admit the same handoff
        (the caller's fallback is re-prefill, which is always safe)."""
        out = self._data_call(
            "resume_generate", timeout, payload=payload,
            _idempotent=False)
        return out if isinstance(out, dict) else np.asarray(out)

    def fetch_handoff(self, handoff_id: str,
                      timeout: Optional[float] = None) -> dict:
        """Fetch a leased handoff payload from the remote sender
        (extends the lease TTL). Read-only, so retryable."""
        try:
            return self._client.call(
                "fetch_handoff", name=self.MODEL, handoff_id=handoff_id,
                _timeout=self._wire_deadline(timeout))
        except _TRANSPORT_ERRORS as e:
            self._raise_mapped(e, deadline_bound=timeout is not None,
                               what="fetch_handoff")

    def commit_handoff(self, handoff_id: str) -> bool:
        """Resolve a handoff lease after a successful resume (sender
        frees the shipped pages). Resolve-by-id, so retryable."""
        try:
            return bool(self._client.call(
                "commit_handoff", name=self.MODEL, handoff_id=handoff_id,
                _timeout=self.rpc_timeout))
        except _TRANSPORT_ERRORS as e:
            self._raise_mapped(e, deadline_bound=False,
                               what="commit_handoff")

    def abort_handoff(self, handoff_id: str) -> bool:
        """Resolve a handoff lease after a FAILED resume (sender
        reclaims the shipped pages now, not at TTL expiry)."""
        try:
            return bool(self._client.call(
                "abort_handoff", name=self.MODEL, handoff_id=handoff_id,
                _timeout=self.rpc_timeout))
        except _TRANSPORT_ERRORS as e:
            self._raise_mapped(e, deadline_bound=False,
                               what="abort_handoff")

    # -- cluster prefix cache ----------------------------------------------
    # The wire mirror of the ModelServer prefix surface, so a remote
    # replica can serve as a fetch HOLDER (export + frames) and a delta
    # RECEIVER probe (prefix_depth), and publish into a pool's directory
    # via `ReplicaPool.refresh_prefix_directory` (prefix_chains pull).

    def export_prefix(self, prompt_ids, have_pages: int = 0,
                      tenant: Optional[str] = None,
                      frame_pages: Optional[int] = None,
                      timeout: Optional[float] = None) -> dict:
        """Lease the remote's resident prefix-chain pages for
        `prompt_ids` beyond `have_pages`; returns the framed-transfer
        header. Retryable: a duplicate grant's lease TTL unpins it."""
        try:
            return self._client.call(
                "export_prefix", name=self.MODEL,
                prompt_ids=[int(x) for x in np.asarray(prompt_ids)],
                have_pages=int(have_pages), tenant=tenant,
                frame_pages=frame_pages, timeout=timeout,
                _timeout=self._wire_deadline(timeout))
        except _TRANSPORT_ERRORS as e:
            self._raise_mapped(e, deadline_bound=timeout is not None,
                               what="export_prefix")

    def fetch_handoff_header(self, handoff_id: str, skip_pages: int = 0,
                             frame_pages: Optional[int] = None) -> dict:
        """Blockless delta header of a leased handoff (read-only)."""
        try:
            return self._client.call(
                "fetch_handoff_header", name=self.MODEL,
                handoff_id=handoff_id, skip_pages=int(skip_pages),
                frame_pages=frame_pages, _timeout=self.rpc_timeout)
        except _TRANSPORT_ERRORS as e:
            self._raise_mapped(e, deadline_bound=False,
                               what="fetch_handoff_header")

    def fetch_handoff_frame(self, handoff_id: str, frame: int,
                            skip_pages: int = 0,
                            frame_pages: Optional[int] = None) -> dict:
        """One bounded frame of a leased handoff (read-only)."""
        try:
            return self._client.call(
                "fetch_handoff_frame", name=self.MODEL,
                handoff_id=handoff_id, frame=int(frame),
                skip_pages=int(skip_pages), frame_pages=frame_pages,
                _timeout=self.rpc_timeout)
        except _TRANSPORT_ERRORS as e:
            self._raise_mapped(e, deadline_bound=False,
                               what="fetch_handoff_frame")

    def prefix_depth(self, prompt_ids,
                     tenant: Optional[str] = None) -> int:
        """Resident prefix-chain depth (pages) on the remote engine."""
        try:
            return int(self._client.call(
                "prefix_depth", name=self.MODEL,
                prompt_ids=[int(x) for x in np.asarray(prompt_ids)],
                tenant=tenant, _timeout=self.rpc_timeout))
        except _TRANSPORT_ERRORS as e:
            self._raise_mapped(e, deadline_bound=False,
                               what="prefix_depth")

    def prefix_chains(self) -> dict:
        """Resident chain-key snapshot — the pull-mode directory feed."""
        try:
            return self._client.call(
                "prefix_chains", name=self.MODEL,
                _timeout=self.rpc_timeout)
        except _TRANSPORT_ERRORS as e:
            self._raise_mapped(e, deadline_bound=False,
                               what="prefix_chains")

    # -- health ------------------------------------------------------------
    def probe(self, x=None, timeout: Optional[float] = None
              ) -> Optional[bool]:
        """Three-valued, mirroring `ModelServer.probe`: True healthy,
        False sick (unreachable, garbage, typed sickness, breaker
        open), None inconclusive (shed on load/time — busyness proves
        nothing). Probes never retry (`_idempotent=False`): a verdict
        must reflect ONE observation, not the best of two."""
        wire_timeout = self._wire_deadline(timeout) \
            if timeout is not None else self.rpc_timeout
        if x is None:
            # no batch to serve: reachability + the remote breaker
            try:
                st = self._client.call("server_stats", name=self.MODEL,
                                       _timeout=wire_timeout,
                                       _idempotent=False)
            except _TRANSPORT_ERRORS:
                return False
            state = st.get("breaker_state", "closed")
            with self._lock:
                self._breaker_state = state
            return False if state == "open" else None
        try:
            self._client.call("predict", name=self.MODEL,
                              features=np.asarray(x, np.float32),
                              timeout=timeout, _timeout=wire_timeout,
                              _idempotent=False)
        except GatewayError as e:
            mapped = self._wire_error(e, deadline_bound=True,
                                      what="probe")
            if isinstance(mapped, (ServerOverloadedError,
                                   DeadlineExceededError)):
                return None  # load/time signal, not sickness
            return False
        except (GatewayProtocolError, TimeoutError, OSError):
            # garbage, a wedged read, or an unreachable peer: all
            # sickness — the pool's watchdog semantics for "hung"
            return False
        return True

    def stats(self) -> dict:
        """The remote server's `stats()` dict; when the replica is
        unreachable, a zeroed schema-complete dict with
        ``unreachable: True`` and the last observed breaker state —
        `pool_stats` aggregation must survive a dead replica."""
        try:
            st = self._client.call("server_stats", name=self.MODEL,
                                   _timeout=self.rpc_timeout)
        except _TRANSPORT_ERRORS as e:
            logger.warning("remote replica %s: stats unreachable (%s)",
                           self.endpoint, type(e).__name__)
            st = {k: 0 for k in observability.MODEL_SERVER_STATS_KEYS}
            with self._lock:
                st["breaker_state"] = self._breaker_state
            st["endpoint"] = self.endpoint
            st["unreachable"] = True
            return st
        with self._lock:
            self._breaker_state = st.get("breaker_state",
                                         self._breaker_state)
        st["endpoint"] = self.endpoint
        st["unreachable"] = False
        return st

    def flight_record(self) -> dict:
        """The remote server's flight-recorder dump (pinned failure
        timelines survive the process boundary by crossing it here);
        ``{"unreachable": True}`` when the replica cannot answer."""
        try:
            rec = self._client.call("flight_record", name=self.MODEL,
                                    _timeout=self.rpc_timeout)
        except _TRANSPORT_ERRORS as e:
            logger.warning(
                "remote replica %s: flight record unreachable (%s)",
                self.endpoint, type(e).__name__)
            return {"endpoint": self.endpoint, "unreachable": True}
        rec["endpoint"] = self.endpoint
        return rec

    # -- deploy seam -------------------------------------------------------
    def _admin_call(self, method: str, _idempotent=None, **params):
        try:
            return self._client.call(method, _timeout=self.admin_timeout,
                                     _idempotent=_idempotent, **params)
        except _TRANSPORT_ERRORS as e:
            self._raise_mapped(e, deadline_bound=False, what=method)

    @property
    def net(self):
        """A `_RemoteSnapshot` of the replica's CURRENT weights (the
        replica writes them to scratch and answers with the path) —
        what `rolling_reload` captures before a deploy so rollback can
        restore across the process boundary. Requires a filesystem
        both processes share."""
        info = self._admin_call("snapshot_model", name=self.MODEL)
        return _RemoteSnapshot(info["path"], info["version"])

    def restore_model(self, obj) -> int:
        """Swap the remote replica onto `obj`: a `_RemoteSnapshot`
        (rollback — ship the path back) or a live net (`sync_net` —
        serialize to scratch first). Idempotent on the wire: restoring
        the same weights twice is the same outcome, so a mid-restore
        connection hiccup retries instead of evicting the replica."""
        if isinstance(obj, _RemoteSnapshot):
            path = obj.path
        else:
            path = str(self._scratch /
                       f"restore-{os.getpid()}-"
                       f"{next(self._restore_counter)}.zip")
            _write_model_file(obj, path)
        return self._admin_call("restore_snapshot", _idempotent=True,
                                name=self.MODEL, path=str(path))

    def reload(self, source, step: Optional[int] = None) -> int:
        """Run the remote server's full reload ladder (manifest verify
        + canary) against a checkpoint path/store directory BOTH
        processes can see. Never auto-retried: the ladder is
        side-effectful and its typed rejection must reach the deploy
        loop un-doubled."""
        path = str(getattr(source, "directory", source))
        return self._admin_call("reload_model", name=self.MODEL,
                                path=path, step=step)

    def shutdown(self, drain_timeout: float = 10.0) -> bool:
        """Close this side's connections. The replica PROCESS outlives
        its pool handle on purpose — the supervisor owns process
        lifecycle (SIGTERM → remote `GatewayServer.stop` drains)."""
        self._client.close()
        return True


class ReplicaEntryPoint(EntryPoint):
    """The replica-process side of the seam: the full gateway
    `EntryPoint` plus the pool-management RPCs `RemoteReplica` needs.
    Always constructed WITH the serving tier (a replica without
    admission control would turn the pool's typed sheds into hangs).
    `device` is where it serves (the card by default).

    `chaos={"die_on_reload": True}` arms the crash-mid-deploy drill:
    the process SIGKILLs itself on the next `reload_model`, before the
    swap — exactly the window `rolling_reload`'s pool-wide rollback
    must survive."""

    def __init__(self, serving: Optional[dict] = None, *,
                 scratch_dir=None, chaos: Optional[dict] = None,
                 device="cuda"):
        super().__init__(serving=serving if serving is not None else {},
                         device=device)
        self._scratch = Path(scratch_dir) if scratch_dir is not None \
            else Path(tempfile.gettempdir())
        self._scratch.mkdir(parents=True, exist_ok=True)
        self._snap_counter = itertools.count()
        self._chaos = dict(chaos or {})

    def serve_net(self, net, name: str = "replica") -> str:
        """Install a live net under `name` (the in-process test seam;
        subprocess replicas load via `--model`)."""
        self._install(name, net)
        return name

    def health(self) -> dict:
        return {"ok": True, "pid": os.getpid(),
                "models": sorted(self._models)}

    def snapshot_model(self, name: str) -> dict:
        """Write the CURRENT weights to scratch; answer the path +
        model_version. The rolling-reload rollback currency — the pool
        holds paths, not remote processes' live memory."""
        srv = self._server(name)
        version = int(getattr(srv, "model_version", 0))
        path = self._scratch / (f"snapshot-{name}-v{version}-"
                                f"{os.getpid()}-"
                                f"{next(self._snap_counter)}.zip")
        _write_model_file(srv.net, path)
        return {"path": str(path), "version": version}

    def restore_snapshot(self, name: str, path: str) -> int:
        """Swap this replica onto the weights at `path` (no canary —
        mirrors `ModelServer.restore_model`'s rollback semantics)."""
        srv = self._server(name)
        version = srv.restore_model(_read_model_file(path,
                                                     device=self.device))
        self._models[name] = srv.net
        return version

    def replica_metrics(self, name: str, labels=None) -> str:
        return self._server(name).metrics_text(labels=labels)

    def reload_model(self, name: str, path: str,
                     step: Optional[int] = None) -> int:
        if self._chaos.get("die_on_reload"):
            logger.warning("replica %d: chaos die_on_reload armed — "
                           "SIGKILLing self", os.getpid())
            os.kill(os.getpid(), signal.SIGKILL)
        return super().reload_model(name, path, step=step)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Replica-process entry: serve one model behind a gateway until
    SIGTERM/SIGINT. Readiness is published by ATOMICALLY writing
    ``<port> <pid>`` to `--ready-file` after the listener is up. On a
    clean stop the process prints its kernel counts as one line
    (`replica_launch_counts` reads it back from the log); SIGUSR1 prints
    that line while it serves."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.serving.remote_replica",
        description="One supervised pool replica: a ModelServer behind "
                    "a gateway endpoint.")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--model", default=None,
                        help="checkpoint to serve (write_model format)")
    parser.add_argument("--scratch", default=None,
                        help="shared scratch dir for snapshot exchange")
    parser.add_argument("--serving", default=None,
                        help="JSON dict of ModelServer kwargs")
    parser.add_argument("--ready-file", default=None)
    parser.add_argument("--device", default="cuda",
                        help="where the replica serves: cuda (default; "
                             "startup fails without a card) or cpu")
    parser.add_argument("--slots", type=int, default=None,
                        help="expose this many slots of --device (a "
                             "tensor-parallel replica on one device)")
    parser.add_argument("--chaos-die-on-reload", action="store_true",
                        help="chaos drill: SIGKILL self on reload_model")
    args = parser.parse_args(argv)
    if args.slots is not None:
        from deeplearning4j_tpu_torch.parallel.mesh import set_local_slots

        set_local_slots(args.slots, args.device)

    serving = json.loads(args.serving) if args.serving else {}
    chaos = {"die_on_reload": True} if args.chaos_die_on_reload else None
    entry = ReplicaEntryPoint(serving=serving, scratch_dir=args.scratch,
                              chaos=chaos, device=args.device)
    if args.model:
        entry.load_model("replica", args.model)
    server = GatewayServer(entry_point=entry, host=args.host,
                           port=args.port).start()

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    def print_counts(final: bool) -> None:
        # one write, so a line from another thread cannot split it
        sys.stdout.write(_COUNTS_PREFIX + json.dumps(_launch_counts(final))
                         + "\n")
        sys.stdout.flush()

    signal.signal(signal.SIGUSR1, lambda *_: print_counts(False))

    if args.ready_file:
        # atomic publish: the supervisor must never read a half-written
        # ready file
        tmp = Path(args.ready_file + ".tmp")
        tmp.write_text(f"{server.port} {os.getpid()}\n")
        tmp.rename(args.ready_file)
    logger.info("replica %d serving on %s:%d", os.getpid(), args.host,
                server.port)
    stop.wait()
    server.stop(drain_timeout=10.0)
    print_counts(True)
    return 0


class ReplicaSupervisor:
    """Spawns and keeps alive N replica processes, one fixed port per
    slot (ports survive respawns, so `RemoteReplica` endpoints stay
    stable and the pool's probe ladder re-admits a respawned replica
    with zero reconfiguration).

    Restart discipline per slot: a death is respawned after a backoff
    that DOUBLES per quick death (`restart_backoff` up to
    `max_backoff`) and resets once a replica survives
    `restart_window` seconds; more than `max_restarts` deaths inside
    one window gives the slot up (a crash-looping binary must not burn
    the host forever). Respawn does NOT wait for readiness — the
    pool's probes own re-admission.

    `kill(i)` is the chaos drill seam (`kill -9` by default);
    `chaos_die_on_reload` arms specific slots to SIGKILL themselves
    mid-`reload_model`. `device` is passed to every replica as
    `--device`; for the card, `start` builds the CUDA sources here first,
    so that N replicas do not all run nvcc on them at once."""

    def __init__(self, model_path, n_replicas: int, *,
                 scratch_dir, serving: Optional[dict] = None,
                 host: str = "127.0.0.1",
                 python: str = sys.executable,
                 restart_backoff: float = 0.25,
                 max_backoff: float = 5.0,
                 max_restarts: int = 5,
                 restart_window: float = 30.0,
                 poll_interval: float = 0.2,
                 spawn_timeout: float = 90.0,
                 env: Optional[dict] = None,
                 chaos_die_on_reload: Sequence[int] = (),
                 device="cuda"):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.n_replicas = n_replicas
        self._model_path = str(model_path)
        self._scratch = Path(scratch_dir)
        self._scratch.mkdir(parents=True, exist_ok=True)
        self._serving = dict(serving or {})
        self._host = host
        self._python = python
        self.restart_backoff = restart_backoff
        self.max_backoff = max_backoff
        self.max_restarts = max_restarts
        self.restart_window = restart_window
        self.poll_interval = poll_interval
        self.spawn_timeout = spawn_timeout
        self._env = dict(os.environ)
        self._env.update(env or {})
        self._chaos = frozenset(chaos_die_on_reload)
        self.device = str(device)
        self.ports = [free_port() for _ in range(n_replicas)]
        self._procs: List[Optional[subprocess.Popen]] = [None] * n_replicas
        self._lock = threading.Lock()
        self._closed = False  # guarded by: _lock
        self._wake = threading.Event()
        self._last_spawn = [0.0] * n_replicas
        self._restarts_in_window = [0] * n_replicas
        self._backoffs = [restart_backoff] * n_replicas
        self._retired: set = set()  # guarded by: _lock
        self.respawns = 0  # guarded by: _lock
        self._monitor: Optional[threading.Thread] = None
        _LIVE_SUPERVISORS.add(self)

    # -- lifecycle ---------------------------------------------------------
    def _build_kernels(self) -> None:
        """Build every CUDA source of the package in this process before
        any replica needs one (the builds are atomic by rename but not
        locked). Only for the card, and only where there is one: a
        replica asked for the card without one fails at startup."""
        import torch

        if torch.device(self.device).type != "cuda" \
                or not torch.cuda.is_available():
            return
        from deeplearning4j_tpu_torch.ops import cuda_build

        cuda_build.build([p.stem for p in
                          sorted(cuda_build.CSRC_DIR.glob("*.cu"))])

    def start(self) -> "ReplicaSupervisor":
        self._build_kernels()
        try:
            for i in range(self.n_replicas):
                self._spawn(i)
            deadline = time.monotonic() + self.spawn_timeout
            for i in range(self.n_replicas):
                self._await_ready(i, deadline)
        except BaseException:
            self.stop()
            raise
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="replica-supervisor")
        self._monitor.start()
        return self

    def _ready_path(self, i: int) -> Path:
        return self._scratch / f"replica-{i}.ready"

    def _cmd(self, i: int) -> List[str]:
        cmd = [self._python, "-m",
               "deeplearning4j_tpu_torch.serving.remote_replica",
               "--host", self._host, "--port", str(self.ports[i]),
               "--model", self._model_path,
               "--scratch", str(self._scratch),
               "--ready-file", str(self._ready_path(i)),
               "--device", self.device]
        tp = ((self._serving or {}).get("parallel") or {}).get("tp", 1)
        if isinstance(tp, int) and tp > 1:
            cmd += ["--slots", str(tp)]
        if self._serving:
            cmd += ["--serving", json.dumps(self._serving)]
        if i in self._chaos:
            cmd += ["--chaos-die-on-reload"]
        return cmd

    def _spawn(self, i: int) -> None:
        ready = self._ready_path(i)
        with contextlib.suppress(OSError):
            ready.unlink()
        log_path = self._scratch / f"replica-{i}.log"
        with open(log_path, "ab") as log:
            proc = subprocess.Popen(self._cmd(i), cwd=str(_REPO_ROOT),
                                    env=self._env, stdout=log,
                                    stderr=subprocess.STDOUT)
        self._procs[i] = proc
        self._last_spawn[i] = time.monotonic()
        _ORPHAN_PIDS.add(proc.pid)
        logger.info("replica supervisor: spawned replica %d (pid %d, "
                    "port %d)", i, proc.pid, self.ports[i])

    def _log_tail(self, i: int, n: int = 20) -> str:
        try:
            lines = (self._scratch / f"replica-{i}.log") \
                .read_text(errors="replace").splitlines()
            return "\n".join(lines[-n:])
        except OSError:
            return "<no log>"

    def _await_ready(self, i: int, deadline: float) -> None:
        ready = self._ready_path(i)
        while time.monotonic() < deadline:
            if ready.exists():
                return
            proc = self._procs[i]
            if proc is not None and proc.poll() is not None:
                raise ReplicaSpawnError(
                    f"replica {i} (port {self.ports[i]}) died during "
                    f"startup (exit {proc.returncode}); log tail:\n"
                    f"{self._log_tail(i)}")
            time.sleep(0.05)
        raise ReplicaSpawnError(
            f"replica {i} (port {self.ports[i]}) not ready within "
            f"{self.spawn_timeout:.0f}s; log tail:\n{self._log_tail(i)}")

    # -- respawn loop ------------------------------------------------------
    def _monitor_loop(self) -> None:
        while True:
            self._wake.wait(self.poll_interval)
            self._wake.clear()
            with self._lock:
                if self._closed:
                    return
                retired = set(self._retired)
            for i in range(self.n_replicas):
                if i in retired:
                    continue  # scale-down: never respawn a retired slot
                proc = self._procs[i]
                if proc is None or proc.poll() is None:
                    continue
                _ORPHAN_PIDS.discard(proc.pid)
                lived = time.monotonic() - self._last_spawn[i]
                if lived > self.restart_window:
                    # it ran long enough to count as stable: forgive
                    self._backoffs[i] = self.restart_backoff
                    self._restarts_in_window[i] = 0
                self._restarts_in_window[i] += 1
                if self._restarts_in_window[i] > self.max_restarts:
                    logger.error(
                        "replica supervisor: replica %d died %d times "
                        "within %.0fs — giving the slot up; log "
                        "tail:\n%s", i, self._restarts_in_window[i],
                        self.restart_window, self._log_tail(i))
                    self._procs[i] = None
                    continue
                backoff = self._backoffs[i]
                self._backoffs[i] = min(backoff * 2, self.max_backoff)
                logger.warning(
                    "replica supervisor: replica %d (pid %d) exited "
                    "%s — respawn %d/%d after %.2fs backoff", i,
                    proc.pid, proc.returncode,
                    self._restarts_in_window[i], self.max_restarts,
                    backoff)
                if self._wake.wait(backoff):
                    self._wake.clear()
                with self._lock:
                    if self._closed:
                        return
                    # a slot retired during the backoff (a scale-down
                    # whose victim died mid-drain) stays down: spawning
                    # under the lock orders this against retire_slot
                    if i in self._retired:
                        continue
                    self._spawn(i)
                    self.respawns += 1

    # -- elasticity (the autoscaler's seam) --------------------------------
    def grow_slot(self) -> int:
        """Scale-up: allocate a NEW slot (fresh port), spawn its replica
        process, and wait for readiness. Returns the slot index. On any
        failure the half-born slot is retired (the monitor must never
        respawn it) and `ReplicaSpawnError` propagates — the autoscaler
        wraps it in `AutoscaleError`."""
        with self._lock:
            if self._closed:
                raise ReplicaSpawnError("supervisor is stopped")
            i = len(self.ports)
            self.ports.append(free_port())
            self._procs.append(None)
            self._last_spawn.append(0.0)
            self._restarts_in_window.append(0)
            self._backoffs.append(self.restart_backoff)
            # n_replicas grows LAST: the monitor iterates
            # range(n_replicas) without the lock, so every parallel
            # array must already cover the new slot when it does
            self.n_replicas += 1
        try:
            self._spawn(i)
            self._await_ready(i, time.monotonic() + self.spawn_timeout)
        except BaseException:
            self.retire_slot(i)
            raise
        logger.info("replica supervisor: grew slot %d (port %d)", i,
                    self.ports[i])
        return i

    def retire_slot(self, i: int) -> None:
        """Scale-down: permanently stop slot `i`. The slot is marked
        retired BEFORE its process is signalled — otherwise the monitor
        could observe the death and respawn it in the gap. Slot indices
        and ports are never reused, so surviving `RemoteReplica`
        endpoints stay stable. Idempotent."""
        if not 0 <= i < self.n_replicas:
            raise ValueError(f"no supervisor slot {i}")
        with self._lock:
            self._retired.add(i)
        proc = self._procs[i]
        self._procs[i] = None
        if proc is not None:
            _ORPHAN_PIDS.discard(proc.pid)
        if proc is not None and proc.poll() is None:
            with contextlib.suppress(OSError):
                proc.terminate()
            with contextlib.suppress(Exception):
                proc.wait(timeout=5.0)
            if proc.poll() is None:
                with contextlib.suppress(OSError):
                    proc.kill()
                with contextlib.suppress(Exception):
                    proc.wait(timeout=5.0)
        logger.info("replica supervisor: retired slot %d (port %d)", i,
                    self.ports[i])

    def slot_for_port(self, port: int) -> int:
        """Map a replica endpoint's port back to its supervisor slot
        (the autoscaler removes a pool replica first, then retires the
        slot that served it)."""
        with self._lock:
            retired = set(self._retired)
        for i, p in enumerate(self.ports):
            if p == port and i not in retired:
                return i
        raise ValueError(f"no live supervisor slot serving port {port}")

    def live_slots(self) -> int:
        """Slots that can currently hold a process (not retired, not
        given up) — the autoscaler's view of supervisor capacity."""
        with self._lock:
            retired = set(self._retired)
        return sum(1 for i in range(self.n_replicas) if i not in retired)

    # -- drills / introspection --------------------------------------------
    def kill(self, i: int, sig: int = signal.SIGKILL) -> int:
        """Chaos seam: signal replica `i`'s process (default SIGKILL —
        the hard-crash drill). Returns the signalled pid."""
        proc = self._procs[i]
        if proc is None:
            raise ValueError(f"replica {i} has no live process")
        os.kill(proc.pid, sig)
        return proc.pid

    def is_alive(self, i: int) -> bool:
        proc = self._procs[i]
        return proc is not None and proc.poll() is None

    def endpoints(self) -> List[Tuple[str, int]]:
        return [(self._host, p) for p in self.ports]

    def set_model_path(self, path) -> None:
        """Point future respawns at newly-deployed weights (called by
        `RemoteReplicaPool.rolling_reload` on success — a replica
        respawned after a deploy must not resurrect the old
        version)."""
        self._model_path = str(path)

    def stop(self) -> None:
        """Terminate every replica (SIGTERM → the process drains its
        gateway; SIGKILL after a bounded wait) and stop respawning.
        Idempotent."""
        with self._lock:
            self._closed = True
        self._wake.set()
        procs = [p for p in self._procs if p is not None]
        for proc in procs:
            with contextlib.suppress(OSError):
                proc.terminate()
        deadline = time.monotonic() + 5.0
        for proc in procs:
            with contextlib.suppress(Exception):
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            if proc.poll() is None:
                with contextlib.suppress(OSError):
                    proc.kill()
                with contextlib.suppress(Exception):
                    proc.wait(timeout=5.0)
            _ORPHAN_PIDS.discard(proc.pid)
        if self._monitor is not None:
            self._monitor.join(self.poll_interval + self.max_backoff
                               + 5.0)


class RemoteReplicaPool(ReplicaPool):
    """`ReplicaPool` over `RemoteReplica`s, plus the glue the process
    boundary needs: `.net` answers the spawn-time template net instead
    of a snapshot RPC per registry peek, `sync_net` serializes ONCE
    and ships the path to every replica (a dead replica is evicted +
    marked stale, not fatal), `rolling_reload` re-points the
    supervisor at the deployed weights so respawns serve the new
    version, and `shutdown` stops the supervisor."""

    # a streaming sink is a callable — it cannot cross the process
    # boundary, so remote pools serve streams unary-fallback style
    supports_stream_sink = False

    def __init__(self, replicas: Sequence, *, supervisor=None,
                 template_net=None, scratch_dir=None, **pool_kwargs):
        self._supervisor = supervisor
        self._template_net = template_net
        self._scratch = Path(scratch_dir) if scratch_dir is not None \
            else Path(tempfile.gettempdir())
        self._sync_counter = itertools.count()
        super().__init__(replicas, **pool_kwargs)

    @property
    def supervisor(self):
        return self._supervisor

    # -- elasticity (the autoscaler's seam) --------------------------------
    def grow_replica(self) -> int:
        """Scale-up across the process boundary: grow a supervisor slot
        (fresh process, fresh port, readiness-gated) and attach it to
        the pool EVICTED — the probe ladder owns re-admission, exactly
        like a respawned crashed replica. Returns the pool replica id.
        `ReplicaSpawnError` propagates on supervisor exhaustion."""
        sup = self._supervisor
        if sup is None:
            raise ReplicaSpawnError(
                "pool has no supervisor to spawn replicas with")
        slot = sup.grow_slot()
        rep = RemoteReplica(
            sup._host, sup.ports[slot], scratch_dir=self._scratch,
            max_queue=sup._serving.get("max_queue", 64))
        return self.add_replica(rep)

    def shrink_replica(self, replica_id: int, *,
                       drain_timeout: float = 30.0) -> None:
        """Scale-down across the process boundary: drain + detach the
        pool replica (zero-failed-requests discipline — aborts typed if
        the drain cannot finish), then retire the supervisor slot that
        served it so the process is stopped and never respawned."""
        server = self.remove_replica(replica_id,
                                     drain_timeout=drain_timeout)
        if self._supervisor is not None:
            port = int(server.endpoint.rsplit(":", 1)[1])
            try:
                self._supervisor.retire_slot(
                    self._supervisor.slot_for_port(port))
            except ValueError:
                logger.warning(
                    "remote pool: no live supervisor slot for removed "
                    "replica %d (port %d) — already retired?",
                    replica_id, port)

    @property
    def net(self):
        """The template net the pool was spawned from (kept in step by
        `sync_net`) — NOT a live replica's weights; reading those
        would cost a snapshot RPC per access."""
        return self._template_net

    def sync_net(self, net) -> None:
        with self._reload_lock:
            path = self._scratch / (f"sync-{os.getpid()}-"
                                    f"{next(self._sync_counter)}.zip")
            _write_model_file(net, path)
            snap = _RemoteSnapshot(str(path), 0)
            for rep in self._replicas:
                try:
                    rep.server.restore_model(snap)
                except (ServingError, GatewayError) as e:
                    # a replica that cannot take the sync is on OLD
                    # weights: evict + stale bars it from re-admission
                    # until a later reload/sync lands, so it cannot
                    # version-split the pool
                    with self._lock:
                        self._evict_locked(
                            rep, f"sync_net failed: {type(e).__name__}")
                        rep.stale = True
                    continue
                with self._lock:
                    rep.stale = False
            self._template_net = net

    @staticmethod
    def _resolve_deploy_path(source, step: Optional[int]):
        """The concrete checkpoint file a deploy landed — what future
        respawns must serve."""
        if hasattr(source, "path_for"):
            if step is not None:
                return source.path_for(step)
            latest = source.latest_verified()
            return None if latest is None else latest[1]
        return source

    def rolling_reload(self, source, step: Optional[int] = None,
                       drain_timeout: float = 30.0) -> List[int]:
        versions = super().rolling_reload(source, step=step,
                                          drain_timeout=drain_timeout)
        if self._supervisor is not None:
            try:
                path = self._resolve_deploy_path(source, step)
            except (OSError, ValueError, ServingError) as e:
                logger.warning(
                    "remote pool: could not resolve the deployed "
                    "checkpoint path (%s) — respawns keep the previous "
                    "weights until the next deploy", type(e).__name__)
                path = None
            if path is not None:
                self._supervisor.set_model_path(path)
        return versions

    def shutdown(self, drain_timeout: float = 10.0) -> bool:
        ok = super().shutdown(drain_timeout=drain_timeout)
        if self._supervisor is not None:
            self._supervisor.stop()
        return ok


def spawn_replica_pool(net, n_replicas: int, *,
                       scratch_dir=None,
                       server_kwargs: Optional[dict] = None,
                       pool_kwargs: Optional[dict] = None,
                       supervisor_kwargs: Optional[dict] = None,
                       host: str = "127.0.0.1",
                       rpc_timeout: float = 30.0,
                       admin_timeout: float = 120.0,
                       deadline_margin: float = 2.0) -> RemoteReplicaPool:
    """The one-call cross-process pool: serialize `net`, spawn
    `n_replicas` supervised replica processes each serving it behind a
    gateway endpoint, and wire a `RemoteReplicaPool` over them.
    `server_kwargs` configure each replica's ModelServer (shipped as
    the process's `--serving` JSON), `pool_kwargs` the pool,
    `supervisor_kwargs` the restart discipline. The replicas serve on
    `net.device` (a `device` in `supervisor_kwargs` wins). The gateway's
    `serving={"replicas": N, "remote": {...}}` config lands here."""
    server_kwargs = dict(server_kwargs or {})
    scratch = Path(scratch_dir) if scratch_dir is not None else \
        Path(tempfile.mkdtemp(prefix="dl4j-remote-pool-"))
    scratch.mkdir(parents=True, exist_ok=True)
    model_path = scratch / "model.zip"
    _write_model_file(net, model_path)
    sup_kw = {"device": str(net.device), **(supervisor_kwargs or {})}
    supervisor = ReplicaSupervisor(model_path, n_replicas,
                                   scratch_dir=scratch,
                                   serving=server_kwargs, host=host,
                                   **sup_kw)
    try:
        supervisor.start()
        replicas = [
            RemoteReplica(host, port, scratch_dir=scratch,
                          rpc_timeout=rpc_timeout,
                          admin_timeout=admin_timeout,
                          deadline_margin=deadline_margin,
                          max_queue=server_kwargs.get("max_queue", 64))
            for port in supervisor.ports]
        return RemoteReplicaPool(replicas, supervisor=supervisor,
                                 template_net=net, scratch_dir=scratch,
                                 **(pool_kwargs or {}))
    except BaseException:
        supervisor.stop()
        raise


if __name__ == "__main__":
    sys.exit(main())
