"""Gateway server: drive this framework from another process or language
(counterpart of `deeplearning4j_tpu/gateway.py`, with the same wire).

Reference: `deeplearning4j-keras/` (SURVEY §2.8) — a py4j `GatewayServer`
(`Server.java:15-22`) exposing `DeepLearning4jEntryPoint` so Python Keras
could call DL4J for fit. Here the framework is Python, and the capability
stays: a line-delimited JSON-RPC server over TCP, arrays as base64 npy
payloads, so any language (or another Python process holding no card)
can build configs, fit, predict, evaluate. The bytes on the wire are the
JAX package's: either package's client talks to either package's
server. The models an `EntryPoint` builds or loads live
on its `device` (the card unless asked otherwise); results leave the
device as host numpy arrays, a 16-bit float result as its f32 host copy.

Protocol: one JSON object per line. Request:
  {"id": 1, "method": "fit", "params": {...}}
Response:
  {"id": 1, "result": ...}
  or {"id": 1, "error": "Type: message", "error_type": "Type",
      "retry_after": 0.05}           # retry_after only on shed errors
Arrays travel as {"__ndarray__": "<base64 of np.save bytes>"}.

Robustness (the serving-tier hardening pass):

- **request-size bound** — a line longer than `max_request_bytes` gets a
  typed `RequestTooLargeError` response and the connection closes (the
  stream cannot be resynced mid-line). An unterminated request can no
  longer grow a handler's buffer without bound.
- **recv timeout** — each connection arms a socket-level `recv_timeout`;
  a client that goes silent mid-request releases its handler thread
  instead of pinning it forever.
- **serving integration** — construct with `serving={...}` (ModelServer
  kwargs, or `True` for defaults) and every created/loaded model is
  wrapped in a `serving.ModelServer`: `predict`/`evaluate` ride through
  admission control, deadlines, and the circuit breaker, and the typed
  shed errors (`ServerOverloadedError` + `retry_after`, ...) surface in
  the error payload. `reload_model` hot-swaps a model from a checkpoint
  path or store directory with canary validation — a corrupt or broken
  candidate is rejected while the old model keeps serving. With
  `serving={"generation": {...}}`, `generate` serves autoregressive
  decoding through the continuous-batching decode engine; the latency
  tier rides the same dict — `"generation": {"prefix_cache": true,
  "speculative": {"draft": "self" | <config json>, "k": 4}}` is fully
  JSON-expressible, so a wire client can enable shared-prefix KV reuse
  and speculative decoding without shipping a net object.
  (`server_stats` then carries `prefix_hit_tokens_pct` /
  `spec_accept_rate` / `spec_tokens_per_step` top-level).
  `serving={"parallel": {"tp": N}}` flows to each ModelServer the same
  way and shards its decode engine over an N-slot tensor-parallel mesh
  (`serving/tp_engine.py`; `parallel.mesh.set_local_slots` exposes N
  slots of one card).
- **client retries** — `GatewayClient` retries idempotent methods once
  with backoff after a `ConnectionResetError`/`BrokenPipeError`
  (server restart, LB connection recycle), and surfaces server-side
  `error` payloads as the typed `GatewayError` (`.error_type`,
  `.retry_after`) instead of a bare RuntimeError.
- **exactly-once serving** — construct the server with
  `exactly_once={...}` (or `True`) and every request carrying a
  client-minted `request_id` (the client stamps one on every call)
  rides `serving.exactly_once.ExactlyOnceDoor`: a wire-level retry of
  ANY method — `fit` and `reload_model` included — returns the parked
  original outcome instead of re-executing, a client that disconnects
  mid-`generate` can reconnect and `claim(request_id)` the finished
  tokens, and with `"journal_dir"` accepted generate/predict/fit
  requests hit a durable WAL that a restarted gateway replays — a
  kill -9 under live traffic completes every accepted request exactly
  once. `GatewayClient(exactly_once=True)` then retries EVERY method
  (the `_IDEMPOTENT` whitelist collapses into the server-side dedup
  door) and polls through `ResultPendingError` while the original
  execution finishes.
"""
from __future__ import annotations

import base64
import contextlib
import io
import json
import logging
import socket
import socketserver
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving import observability

logger = logging.getLogger("deeplearning4j_tpu_torch")

# Data-path RPCs that get a gateway-minted trace: the gateway is the
# outermost hop, so these requests' span timelines start here and every
# layer below (pool routing, server admission, engine scheduling) joins
# the same trace_id via the thread-local binding.
_TRACED_METHODS = frozenset({"predict", "evaluate", "generate",
                             "resume_generate"})

# Exactly-once built-ins answered by the door itself, never dispatched
# to the entry point (and never themselves deduped: claim IS the retry).
_DOOR_METHODS = frozenset({"claim", "exactly_once_stats"})


class GatewayError(RuntimeError):
    """A server-side error surfaced through the gateway protocol.
    `error_type` is the server-side exception class name (e.g.
    `"ServerOverloadedError"`); `retry_after` (seconds) is present on
    shed/unavailable responses so clients can back off intelligently."""

    def __init__(self, msg: str, error_type: Optional[str] = None,
                 retry_after: Optional[float] = None,
                 replica_id: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 trace: Optional[dict] = None,
                 payload: Optional[dict] = None):
        super().__init__(msg)
        self.error_type = error_type
        self.retry_after = retry_after
        # structured error payload for errors that carry data, not just
        # a message — e.g. `SlotMigratedError`'s handoff_id + tokens, so
        # a remote pool can resume a migrated request on a peer
        self.payload = payload
        # present when a replicated pool produced the error: which
        # replica it originated on
        self.replica_id = replica_id
        # present when serving-tier tracing is on: the request's id and
        # span timeline across gateway → pool → server → engine, so a
        # wire client holds the same postmortem an in-process caller
        # reads off the typed error
        self.trace_id = trace_id
        self.trace = trace


class RequestTooLargeError(RuntimeError):
    """The request line exceeded the server's `max_request_bytes`."""


class GatewayProtocolError(RuntimeError):
    """The peer answered with bytes that do not parse as one gateway
    response line: garbage, a line truncated by a mid-response
    disconnect, an oversize line past `max_response_bytes`, or a
    response id that does not match the request's. The stream cannot be
    resynced mid-line, so the connection is discarded; idempotent calls
    may retry over a fresh one (`serving.remote_replica` maps this to
    the typed `InferenceFailedError` so a garbage-spewing replica feeds
    the pool's passive eviction, not a crash)."""


def _host_array(a) -> np.ndarray:
    """A tensor's host copy as numpy (a 16-bit float tensor as f32, which
    numpy's npy format carries); anything else through `np.asarray`."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def encode_array(a) -> Dict[str, str]:
    buf = io.BytesIO()
    np.save(buf, _host_array(a), allow_pickle=False)
    return {"__ndarray__": base64.b64encode(buf.getvalue()).decode("ascii")}


def decode_value(v):
    """Recursive inverse of encode_value (the two must stay symmetric, or
    nested arrays silently arrive as base64 dicts)."""
    if isinstance(v, dict) and "__ndarray__" in v:
        raw = base64.b64decode(v["__ndarray__"])
        return np.load(io.BytesIO(raw), allow_pickle=False)
    if isinstance(v, dict):
        return {k: decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    return v


def encode_value(v):
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return encode_array(v)
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, dict):
        return {k: encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [encode_value(x) for x in v]
    return v


class EntryPoint:
    """Methods callable over the gateway (reference
    `DeepLearning4jEntryPoint.java`): one live model per session keyed by a
    caller-chosen name.

    `serving` — None serves `predict`/`evaluate` directly off the net
    (historical behavior); a dict of `serving.ModelServer` kwargs (or
    `True` for defaults) wraps every created/loaded model in a
    ModelServer, so those calls gain admission control, deadlines, and
    circuit breaking, plus `reload_model`/`server_stats` management.
    With `serving={"replicas": N, "pool": {...}, ...}` (N > 1; "pool"
    holds optional `serving.ReplicaPool` kwargs, the rest ModelServer
    kwargs) every model is cloned across N replicas behind a
    `ReplicaPool`: least-loaded routing, health-probed eviction +
    failover, optional hedging, and `rolling_reload`/`pool_stats`
    management — a replica failure costs a failover, not the service.
    Errors that originated on a specific replica carry `replica_id` in
    the error payload.

    `device` is where the models it creates or loads live, and where its
    servers serve: the card by default (raising here without one), the
    CPU only when asked (`device="cpu"`)."""

    # lifecycle methods a remote caller must NOT reach through the RPC
    # dispatch: one unauthenticated request could drain every ModelServer
    # (after which predict would silently bypass the serving tier)
    _RPC_EXCLUDED = frozenset({"shutdown"})

    def __init__(self, serving: Optional[dict] = None,
                 streaming: Optional[dict] = None, device="cuda"):
        from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device
        from deeplearning4j_tpu_torch.serving.streaming import StreamRegistry

        self.device = resolve_device(device)
        self._models: Dict[str, Any] = {}
        self._servers: Dict[str, Any] = {}
        self._serving = {} if serving is True else serving
        # per-request emitted-token rings (`generate_stream` /
        # `resume_stream`); `streaming` carries StreamRegistry kwargs
        self.streams = StreamRegistry(**(streaming or {}))
        self._stream_stats_bound: set = set()

    # -- model lifecycle --------------------------------------------------
    def create_model(self, name: str, config: dict) -> str:
        from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
            MultiLayerConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        conf = MultiLayerConfiguration.from_json(
            config if isinstance(config, str) else json.dumps(config))
        net = MultiLayerNetwork(conf, device=self.device)
        net.init()
        self._install(name, net)
        return name

    def load_model(self, name: str, path: str) -> str:
        from deeplearning4j_tpu_torch.util.serialization import restore_model

        self._install(name, restore_model(path, device=self.device))
        return name

    def save_model(self, name: str, path: str) -> str:
        from deeplearning4j_tpu_torch.util.serialization import write_model

        write_model(self._model(name), path)
        return path

    def _install(self, name: str, net) -> None:
        self._models[name] = net
        if self._serving is not None:
            old = self._servers.pop(name, None)
            if old is not None:
                old.shutdown(drain_timeout=5.0)
            self._servers[name] = self._make_server(net)

    def _make_server(self, net):
        """One ModelServer — or, with `"replicas": N` in the serving
        config, a ReplicaPool cloning the net across N servers
        (`"pool"` sub-dict carries ReplicaPool kwargs; everything else
        is ModelServer kwargs). With `"remote": true` (or a dict of
        `spawn_replica_pool` kwargs) the N replicas are SEPARATE
        PROCESSES spawned and supervised on this host, reached over the
        gateway wire protocol — a replica crash costs a failover plus a
        supervised respawn, not the service."""
        cfg = dict(self._serving)
        disagg_cfg = cfg.pop("disagg", None)
        raw_replicas = cfg.pop("replicas", 1)
        n_replicas = 1 if raw_replicas is None else int(raw_replicas)
        if n_replicas < 1:
            raise ValueError(
                "serving config 'replicas' must be >= 1, got "
                f"{raw_replicas!r}")
        pool_cfg = cfg.pop("pool", {}) or {}
        remote_cfg = cfg.pop("remote", None)
        autoscale_cfg = cfg.pop("autoscale", None)
        if disagg_cfg:
            if n_replicas > 1 or remote_cfg or autoscale_cfg:
                raise ValueError(
                    "serving config 'disagg' builds its own prefill + "
                    "decode replica set and cannot combine with "
                    "'replicas' > 1, 'remote', or 'autoscale'")
            from deeplearning4j_tpu_torch.serving.kv_transfer import (
                DisaggCoordinator,
            )

            disagg_kw = {} if disagg_cfg is True else dict(disagg_cfg)
            return DisaggCoordinator(net, server_kwargs=cfg, **disagg_kw)
        if pool_cfg and n_replicas == 1:
            # fail at construction, not silently un-replicated: pool
            # kwargs without replicas almost certainly means a typo'd
            # or forgotten "replicas": N
            raise ValueError(
                "serving config has 'pool' kwargs but 'replicas' is "
                f"{raw_replicas!r} — a ReplicaPool needs 'replicas' > 1")
        if remote_cfg:
            from deeplearning4j_tpu_torch.serving.remote_replica import (
                spawn_replica_pool,
            )

            remote_kw = {} if remote_cfg is True else dict(remote_cfg)
            # the serving config's own sections and any explicit
            # spawn_replica_pool kwargs inside "remote" must merge, not
            # collide (either shape is documented; remote's win)
            remote_kw["server_kwargs"] = {
                **cfg, **(remote_kw.get("server_kwargs") or {})}
            remote_kw["pool_kwargs"] = {
                **pool_cfg, **(remote_kw.get("pool_kwargs") or {})}
            pool = spawn_replica_pool(net, n_replicas, **remote_kw)
            return self._maybe_autoscale(pool, autoscale_cfg)
        if n_replicas > 1:
            from deeplearning4j_tpu_torch.serving import ReplicaPool, ModelServer

            pool = ReplicaPool.from_net(net, n_replicas,
                                        server_kwargs=cfg, **pool_cfg)
            # scale-up on the in-process path clones the served net into
            # a fresh ModelServer (the same recipe from_net used)
            spawn = lambda: ModelServer(net.clone(), **cfg)  # noqa: E731
            return self._maybe_autoscale(pool, autoscale_cfg, spawn=spawn)
        if autoscale_cfg:
            raise ValueError(
                "serving config has 'autoscale' but 'replicas' is "
                f"{raw_replicas!r} — the autoscaler drives a ReplicaPool; "
                "set 'replicas' > 1 (or 'remote')")
        from deeplearning4j_tpu_torch.serving import ModelServer

        return ModelServer(net, **cfg)

    @staticmethod
    def _maybe_autoscale(pool, autoscale_cfg, spawn=None):
        """Attach a started `Autoscaler` to `pool` when the serving
        config carries `"autoscale"` (True for defaults, or a dict of
        Autoscaler kwargs). The scaler rides on the pool as
        `pool.autoscaler` so `shutdown`/stats RPCs can find it."""
        if not autoscale_cfg:
            return pool
        from deeplearning4j_tpu_torch.serving.autoscaler import Autoscaler

        scale_kw = {} if autoscale_cfg is True else dict(autoscale_cfg)
        if spawn is not None and "spawn" not in scale_kw:
            scale_kw["spawn"] = spawn
        scaler = Autoscaler(pool, **scale_kw)
        scaler.start()
        pool.autoscaler = scaler
        return pool

    def _model(self, name: str):
        if name not in self._models:
            raise KeyError(f"no model {name!r}; create_model/load_model first")
        return self._models[name]

    def _live_server(self, name: str):
        """The model's ModelServer, re-wrapping lazily when serving is
        enabled but the server is gone (a `GatewayServer.stop()` drains
        servers; a later `start()` must NOT silently serve unprotected).
        None when the serving tier is disabled."""
        if self._serving is None:
            return None
        if name in self._models and name not in self._servers:
            self._servers[name] = self._make_server(self._models[name])
        return self._servers.get(name)

    def _server(self, name: str):
        self._model(name)  # raises the canonical "no model" KeyError
        srv = self._live_server(name)
        if srv is None:
            from deeplearning4j_tpu_torch.serving import ServingError
            raise ServingError(
                f"model {name!r} has no ModelServer — construct the "
                "gateway with serving={...} to enable the serving tier")
        return srv

    # -- train/infer ------------------------------------------------------
    def fit(self, name: str, features, labels, epochs: int = 1) -> float:
        net = self._model(name)
        net.fit(np.asarray(features, np.float32),
                np.asarray(labels, np.float32), epochs=epochs)
        srv = self._servers.get(name)
        if srv is not None and hasattr(srv, "sync_net"):
            # in-place training updated replica 0's aliased net; push
            # the new weights to the cloned replicas too, or routing
            # would answer with pre-fit parameters on N-1 of N picks
            srv.sync_net(net)
        return float(net.score_value)

    def predict(self, name: str, features,
                timeout: Optional[float] = None) -> np.ndarray:
        feats = np.asarray(features, np.float32)
        net = self._model(name)
        srv = self._live_server(name)
        if srv is not None:
            return srv.predict(feats, timeout=timeout)
        return _host_array(net.output(feats))

    def evaluate(self, name: str, features, labels,
                 timeout: Optional[float] = None) -> dict:
        feats = np.asarray(features, np.float32)
        labs = np.asarray(labels, np.float32)
        self._model(name)
        srv = self._live_server(name)
        if srv is not None:
            # ride the serving tier so evaluation traffic obeys the same
            # admission/deadline/breaker discipline as predictions
            from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

            out = srv.predict(feats, timeout=timeout)
            ev = Evaluation()
            ev.eval(labs, out)
        else:
            from deeplearning4j_tpu_torch.datasets.dataset import DataSet

            ev = self._model(name).evaluate(DataSet(feats, labs))
        return {"accuracy": ev.accuracy(), "precision": ev.precision(),
                "recall": ev.recall(), "f1": ev.f1()}

    def score(self, name: str) -> Optional[float]:
        return self._model(name).score_value

    def generate(self, name: str, prompt_ids, n_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None,
                 tenant: Optional[str] = None,
                 priority: str = "interactive",
                 logprobs: int = 0):
        """Autoregressive generation for a `gpt_configuration` model
        through the serving tier's continuous-batching decode engine —
        concurrent gateway callers share the slot pool, so no request
        waits on another's tail. Requires `serving={..., "generation":
        {...}}` (DecodeEngine kwargs, or True for defaults). Typed shed
        errors (`ServerOverloadedError` + retry_after, ...) surface in
        the error payload like `predict`'s. `tenant` and `priority`
        ("interactive" | "batch") feed the engine's multi-tenant QoS
        doors when a `"qos"` generation config is present. With
        `logprobs=K > 0` (needs `"generation": {"logprobs": K, ...}`)
        the reply is `{"tokens", "logprobs"}` — one per-step entry of
        the chosen token's logprob plus the top-K alternatives, from
        the UNSCALED model distribution."""
        srv = self._server(name)
        kw = {"logprobs": int(logprobs)} if logprobs else {}
        return srv.generate(np.asarray(prompt_ids), int(n_tokens),
                            temperature=float(temperature),
                            seed=int(seed), timeout=timeout,
                            tenant=tenant, priority=priority, **kw)

    def generate_stream(self, name: str, prompt_ids, n_tokens: int,
                        temperature: float = 0.0, seed: int = 0,
                        timeout: Optional[float] = None,
                        tenant: Optional[str] = None,
                        priority: str = "interactive",
                        logprobs: int = 0,
                        request_id: Optional[str] = None,
                        _finish_stream: bool = True):
        """`generate` with every emitted token published into a
        per-request `TokenStream` ring keyed by `request_id` — the
        gateway handler pumps the ring to the socket as incremental
        frames, and `resume_stream(request_id, cursor)` replays it
        after a disconnect. Servers whose adapters cannot carry a sink
        across the wire (`supports_stream_sink = False`) fall back to
        unary execution: no incremental frames, but the terminal result
        still lands and resume/claim semantics hold. Returns the same
        value as `generate` (journal replay executes this method
        directly; the stream it re-opens serves late resumes)."""
        srv = self._server(name)
        rid = str(request_id) if request_id else f"stream-{uuid.uuid4()}"
        stream = self.streams.open(rid)
        metrics = getattr(srv, "metrics", None)
        if metrics is not None and id(metrics) not in self._stream_stats_bound:
            # lazy: the first streamed request pins the registry stats
            # into this server's Prometheus exposition
            metrics.register_stats("streaming", self.streams.stats)
            self._stream_stats_bound.add(id(metrics))
        kw = {"logprobs": int(logprobs)} if logprobs else {}
        if getattr(srv, "supports_stream_sink", False):
            kw["on_token"] = stream.publish
        try:
            out = srv.generate(np.asarray(prompt_ids), int(n_tokens),
                               temperature=float(temperature),
                               seed=int(seed), timeout=timeout,
                               tenant=tenant, priority=priority, **kw)
        except Exception as e:
            # park the typed failure as the terminal frame so a resume
            # after the fact sees the error instead of hanging; the
            # raise still reaches the caller's error shaping
            self.streams.finish(stream, {
                "error": str(e), "error_type": type(e).__name__})
            raise
        if _finish_stream:
            self.streams.finish(stream, {"result": encode_value(out)})
        return out

    # -- serving management ----------------------------------------------
    @staticmethod
    def _reload_source(path: str) -> Any:
        p = Path(path)
        if p.is_dir():
            from deeplearning4j_tpu_torch.util.checkpoint_store import (
                CheckpointStore,
            )

            return CheckpointStore(p)
        return p

    def reload_model(self, name: str, path: str,
                     step: Optional[int] = None) -> int:
        """Hot-swap model `name` from a checkpoint file path or a
        `CheckpointStore` directory (newest verified step when `step` is
        None), with manifest verification + canary validation — a bad
        candidate is rejected with the old model still serving. On a
        replicated pool this delegates to `rolling_reload`, so a deploy
        through the historical RPC is zero-downtime too. Returns the
        new model_version."""
        srv = self._server(name)
        source = self._reload_source(path)
        if hasattr(srv, "rolling_reload"):
            # versions cover HEALTHY replicas; a fully-degraded pool
            # (best-effort reloads only) returns [] — still a deploy,
            # not an internal error
            version = max(srv.rolling_reload(source, step=step),
                          default=0)
        else:
            version = srv.reload(source, step=step)
        self._models[name] = srv.net
        return version

    def rolling_reload(self, name: str, path: str,
                       step: Optional[int] = None) -> list:
        """Replica-at-a-time canary-gated reload of model `name`'s
        `ReplicaPool` (requires `serving={"replicas": N, ...}`): drain →
        reload → probe per replica, pool-wide rollback to the old
        weights if any replica's canary or probe fails. Returns the
        per-replica model versions."""
        srv = self._server(name)
        if not hasattr(srv, "rolling_reload"):
            from deeplearning4j_tpu_torch.serving import ServingError
            raise ServingError(
                f"model {name!r} is served by a single ModelServer — "
                "rolling_reload needs serving={'replicas': N} (N > 1); "
                "use reload_model instead")
        versions = srv.rolling_reload(self._reload_source(path), step=step)
        self._models[name] = srv.net
        return versions

    def server_stats(self, name: str) -> dict:
        return self._server(name).stats()

    def pool_stats(self, name: str) -> dict:
        """Aggregated `ReplicaPool.stats()` — per-replica server stats
        plus the pool counters (failovers, hedges, evictions,
        rolling_reloads, ...)."""
        srv = self._server(name)
        if not hasattr(srv, "rolling_reload"):
            from deeplearning4j_tpu_torch.serving import ServingError
            raise ServingError(
                f"model {name!r} is served by a single ModelServer — "
                "pool_stats needs serving={'replicas': N} (N > 1); use "
                "server_stats instead")
        return srv.stats()

    def set_tenant_quota(self, name: str, tenant: str,
                         rate: Optional[float] = None,
                         burst: Optional[float] = None,
                         max_pages: Optional[int] = None,
                         weight: Optional[float] = None) -> bool:
        """Install (or update) tenant `tenant`'s token-rate quota and KV
        page ceiling on model `name`'s decode engine — `rate`
        tokens/second refill, `burst` bucket depth, `max_pages` the most
        KV pages the tenant may hold at once, `weight` the batch lane's
        weighted-fair-queueing share (default 1.0; weight 2 earns twice
        the admitted span of weight 1 under saturation). On a pool this
        fans out to every replica so failover cannot launder a flooding
        tenant past its quota."""
        self._server(name).set_tenant_quota(tenant, rate=rate, burst=burst,
                                            max_pages=max_pages,
                                            weight=weight)
        return True

    # -- KV handoff / live migration --------------------------------------
    def migrate_slots(self, name: str, wait: Optional[float] = 5.0) -> int:
        """Export model `name`'s in-flight generations as leased KV
        handoffs (live decode-state migration; see
        `serving.kv_transfer`). Returns the number migrated."""
        return int(self._server(name).migrate_slots(wait=wait))

    def resume_generate(self, name: str, payload: dict,
                        timeout: Optional[float] = None) -> np.ndarray:
        """Admit a fetched KV handoff payload on model `name`'s engine
        and return the TAIL tokens it generates (the sender already
        emitted `payload['tokens']`)."""
        return self._server(name).resume_generate(payload, timeout=timeout)

    def fetch_handoff(self, name: str, handoff_id: str) -> dict:
        """Fetch a leased handoff payload by id (extends its TTL)."""
        return self._server(name).fetch_handoff(handoff_id)

    def commit_handoff(self, name: str, handoff_id: str) -> bool:
        """Resolve a handoff lease after a successful resume: the sender
        frees the shipped pages. Idempotent; False when already gone."""
        return bool(self._server(name).commit_handoff(handoff_id))

    def abort_handoff(self, name: str, handoff_id: str) -> bool:
        """Resolve a handoff lease after a FAILED resume: the sender
        reclaims the shipped pages immediately instead of waiting for
        the TTL sweep. Idempotent; False when already gone."""
        return bool(self._server(name).abort_handoff(handoff_id))

    # -- cluster prefix cache (serving.prefix_directory) -------------------
    def export_prefix(self, name: str, prompt_ids, have_pages: int = 0,
                      tenant: Optional[str] = None,
                      frame_pages: Optional[int] = None,
                      timeout: Optional[float] = None) -> dict:
        """Lease model `name`'s resident KV pages for `prompt_ids`'
        cached prefix chain beyond the `have_pages` the caller already
        holds; returns the framed-transfer HEADER (drain the frames
        with `fetch_handoff_frame`, then commit/abort the lease).
        Typed refusal when the chain is no longer resident — the
        fetcher falls back to cold prefill."""
        return self._server(name).export_prefix(
            prompt_ids, have_pages=int(have_pages), tenant=tenant,
            frame_pages=frame_pages, timeout=timeout)

    def fetch_handoff_header(self, name: str, handoff_id: str,
                             skip_pages: int = 0,
                             frame_pages: Optional[int] = None) -> dict:
        """Blockless header of a leased handoff, advanced by
        `skip_pages` receiver-resident pages and annotated with the
        frame schedule (delta transfers; extends the lease TTL)."""
        return self._server(name).fetch_handoff_header(
            handoff_id, skip_pages=int(skip_pages),
            frame_pages=frame_pages)

    def fetch_handoff_frame(self, name: str, handoff_id: str, frame: int,
                            skip_pages: int = 0,
                            frame_pages: Optional[int] = None) -> dict:
        """One bounded frame of a leased handoff's page slices
        (stateless: pass back the header's skip/frame_pages pair)."""
        return self._server(name).fetch_handoff_frame(
            handoff_id, int(frame), skip_pages=int(skip_pages),
            frame_pages=frame_pages)

    def prefix_depth(self, name: str, prompt_ids,
                     tenant: Optional[str] = None) -> int:
        """How many leading pages of `prompt_ids`' prefix chain are
        resident on model `name` — the receiver-side probe a delta
        transfer uses to decide how many pages to skip."""
        return int(self._server(name).prefix_depth(prompt_ids,
                                                   tenant=tenant))

    def prefix_chains(self, name: str) -> dict:
        """Snapshot of model `name`'s resident prefix chain keys
        (``{"weight_version", "page_size", "chains"}``) — the pull-mode
        publication feed for a cluster prefix directory."""
        return self._server(name).prefix_chains()

    def autoscaler_stats(self, name: str) -> dict:
        """The autoscaler's decision counters and live pressure signal
        for model `name` (requires serving={'replicas': N, 'autoscale':
        ...})."""
        srv = self._server(name)
        scaler = getattr(srv, "autoscaler", None)
        if scaler is None:
            from deeplearning4j_tpu_torch.serving import ServingError
            raise ServingError(
                f"model {name!r} has no autoscaler — enable it with "
                "serving={'replicas': N, 'autoscale': {...}}")
        return scaler.stats()

    def metrics(self, name: Optional[str] = None) -> str:
        """Prometheus-style text exposition of the serving tier's
        metrics registry — one model's (by `name`) or every served
        model's, each block labeled ``{model="<name>"}`` (pools add a
        ``replica`` label per replica). The unified scrape surface for
        the counters/gauges/histograms plus every layer's ``stats()``
        dict flattened to gauges. Requires the serving tier."""
        names = [name] if name is not None else sorted(self._models)
        return "".join(
            self._server(n).metrics_text(labels={"model": n})
            for n in names)

    def flight_record(self, name: str) -> dict:
        """Model `name`'s flight-recorder dump: bounded rings of
        completed request timelines, timelines pinned at typed
        failures, and scheduler events (admissions, retirements, page
        reclaims, probe verdicts, breaker transitions). A `ReplicaPool`
        dump nests each replica's rings under ``"replicas"`` alongside
        the pool's own routing ring. Requires the serving tier."""
        return self._server(name).flight_record()

    def shutdown(self, drain_timeout: float = 10.0) -> None:
        """Drain and stop every ModelServer (called by
        `GatewayServer.stop`)."""
        for srv in self._servers.values():
            # stop the control loop first or it may race the drain with
            # a concurrent scale decision against a closing pool
            scaler = getattr(srv, "autoscaler", None)
            if scaler is not None:
                scaler.stop()
            srv.shutdown(drain_timeout=drain_timeout)
        self._servers.clear()


class GatewayServer:
    """TCP JSON-RPC server (reference `Server.java` GatewayServer role).

    `port=0` picks an ephemeral port (see `.port` after `start()`).
    `max_request_bytes` bounds one request line (oversize → typed error +
    close); `recv_timeout` arms a per-connection socket timeout so a
    silent client cannot pin a handler thread forever; `serving` enables
    the ModelServer tier on the default EntryPoint (ignored when an
    `entry_point` instance is passed — configure that one directly), and
    `device` is that EntryPoint's device (the card by default).

    `exactly_once` (True for defaults, or a dict of
    `serving.exactly_once.ExactlyOnceDoor` kwargs plus the gateway-level
    `"replay"` / `"replay_timeout"` knobs) installs the dedup door:
    every request stamped with a `request_id` is deduplicated against a
    bounded TTL'd completed-result ring, outcomes park for
    `claim(request_id)` after a mid-response disconnect, and with
    `"journal_dir"` a restarted gateway replays accepted-but-unfinished
    generate/predict/fit requests off the durable journal (the replay
    thread waits — within `replay_timeout` — for each record's named
    model to be re-installed)."""

    def __init__(self, entry_point: Optional[EntryPoint] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_request_bytes: int = 64 << 20,
                 recv_timeout: Optional[float] = 600.0,
                 serving: Optional[dict] = None,
                 exactly_once=None,
                 streaming: Optional[dict] = None,
                 stream_send_timeout: float = 30.0,
                 stream_coalesce: float = 0.005,
                 device="cuda"):
        if max_request_bytes < 1:
            raise ValueError("max_request_bytes must be >= 1")
        if stream_send_timeout <= 0:
            raise ValueError("stream_send_timeout must be > 0")
        if stream_coalesce < 0:
            raise ValueError("stream_coalesce must be >= 0")
        self.entry = entry_point or EntryPoint(serving=serving,
                                               streaming=streaming,
                                               device=device)
        self.max_request_bytes = max_request_bytes
        self.recv_timeout = recv_timeout
        # how long one stream frame write may block before the pump
        # declares the consumer slow and sheds it (the generation keeps
        # running; its outcome parks behind the door)
        self.stream_send_timeout = stream_send_timeout
        # after the FIRST frame (TTFT is never delayed), the pump waits
        # this long between reads so tokens batch into fewer frames —
        # per-token syscall + wakeup cost is the streaming goodput tax
        self.stream_coalesce = stream_coalesce
        self._host, self._requested_port = host, port
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.door = None
        self._replay_enabled = True
        self._replay_timeout = 60.0
        self._stop_replay = threading.Event()
        self._replay_thread: Optional[threading.Thread] = None
        if exactly_once:
            from deeplearning4j_tpu_torch.serving.exactly_once import (
                ExactlyOnceDoor,
            )

            kw = {} if exactly_once is True else dict(exactly_once)
            self._replay_enabled = bool(kw.pop("replay", True))
            self._replay_timeout = float(kw.pop("replay_timeout", 60.0))
            self.door = ExactlyOnceDoor(**kw)

    @property
    def port(self) -> int:
        if self._server is None:
            raise GatewayError("server not started")
        return self._server.server_address[1]

    def start(self) -> "GatewayServer":
        entry = self.entry
        max_bytes = self.max_request_bytes
        recv_timeout = self.recv_timeout
        send_timeout = self.stream_send_timeout
        coalesce = self.stream_coalesce
        door = self.door

        class Handler(socketserver.StreamRequestHandler):
            # StreamRequestHandler.setup() arms this on the connection:
            # a silent/stalled client raises socket.timeout out of
            # readline instead of blocking the handler thread forever
            timeout = recv_timeout
            # streaming pushes many small frames; Nagle + delayed-ACK
            # turns each into a ~40ms stall on a one-way pipe
            disable_nagle_algorithm = True

            def _respond(self, resp: dict) -> bool:
                try:
                    self.wfile.write((json.dumps(resp) + "\n").encode())
                    self.wfile.flush()
                    return True
                except (BrokenPipeError, ConnectionResetError, OSError):
                    # client vanished mid-response: nothing to salvage
                    logger.info("gateway: client disconnected mid-response")
                    return False

            def _pump(self, stream, cursor: int, req_id):
                """Feed this socket from `stream`'s ring starting at
                `cursor`: incremental frames as tokens land, then the
                terminal body (returned for the common respond path at
                the bottom of handle()). None means the connection is
                done — slow-consumer shed or client disconnect — and
                the handler must close; the generation keeps running
                and its outcome parks for resume/claim."""
                from deeplearning4j_tpu_torch.serving.streaming import (
                    StreamBackpressureError,
                )

                try:
                    # frame writes get their own (shorter) timeout: a
                    # reader that stops draining must be shed, not
                    # trusted with the idle recv budget
                    self.connection.settimeout(send_timeout)
                    sent_any = False
                    while True:
                        # after the first frame (TTFT stays prompt) the
                        # read lingers so tokens batch into fewer frames;
                        # finish() aborts the linger, so the terminal
                        # body is never delayed by coalescing
                        try:
                            toks, lps, cursor, body = stream.read(
                                cursor, timeout=0.25,
                                linger=coalesce if sent_any else 0.0)
                        except StreamBackpressureError:
                            # this consumer fell out of the replay ring:
                            # count the shed, answer typed through the
                            # common wire-error path (the client falls
                            # back to the parked outcome)
                            entry.streams.shed(stream)
                            raise
                        if toks:
                            sent_any = True
                            payload = {"cursor": cursor, "tokens": toks}
                            if lps is not None:
                                payload["logprobs"] = encode_value(lps)
                            frame = {"id": req_id, "frame": payload}
                            try:
                                self.wfile.write(
                                    (json.dumps(frame) + "\n").encode())
                                self.wfile.flush()
                            # socket.timeout subclasses OSError: the
                            # slow-consumer verdict must be caught first
                            # or it reads as a disconnect
                            except (socket.timeout, TimeoutError):
                                entry.streams.shed(stream)
                                logger.warning(
                                    "gateway: stream %s consumer stalled "
                                    "past stream_send_timeout=%.1fs; "
                                    "shed — the outcome parks for "
                                    "resume/claim", stream.request_id,
                                    send_timeout)
                                return None
                            except (BrokenPipeError, ConnectionResetError,
                                    OSError):
                                logger.info(
                                    "gateway: stream %s consumer gone at "
                                    "cursor %d (resumable)",
                                    stream.request_id, cursor)
                                return None
                        elif body is not None:
                            return {"id": req_id, **body}
                finally:
                    self.connection.settimeout(recv_timeout)

            def _generate_stream(self, req, req_id, ctx, request_key):
                """Execute `generate_stream` on a worker thread feeding
                the request's ring while THIS thread pumps the ring to
                the socket — the worker outlives any number of consumer
                disconnects, parks the terminal body behind the door,
                and finishes the stream for late resumes."""
                params = decode_value(req.get("params") or {})
                # without a door the wire stamp never becomes a
                # request_key, but it must still key the ring or a
                # door-less server could not serve resumes
                rid = str(request_key or params.get("request_id")
                          or req.get("request_id")
                          or f"stream-{uuid.uuid4()}")
                params["request_id"] = rid
                stream = entry.streams.open(rid)

                def work():
                    trace = None
                    try:
                        if observability.tracing_enabled():
                            trace = observability.Trace(
                                trace_id=ctx.get("trace_id")
                                if ctx else None)
                        if trace is not None:
                            with observability.use_trace(trace), \
                                    trace.span("gateway",
                                               method="generate_stream"):
                                result = entry.generate_stream(
                                    _finish_stream=False, **params)
                        else:
                            result = entry.generate_stream(
                                _finish_stream=False, **params)
                        body = {"result": encode_value(result)}
                        if trace is not None:
                            trace.finish("served")
                            body["trace_id"] = trace.trace_id
                            body["trace"] = trace.to_dict()
                    # RPC boundary
                    # (worker half): any failure must become the
                    # stream's typed terminal frame, never kill the
                    # worker silently
                    except Exception as e:
                        body = {"error": f"{type(e).__name__}: {e}",
                                "error_type": type(e).__name__}
                        retry_after = getattr(e, "retry_after", None)
                        if retry_after is not None:
                            body["retry_after"] = float(retry_after)
                        replica_id = getattr(e, "replica_id", None)
                        if replica_id is not None:
                            body["replica_id"] = int(replica_id)
                        wire_payload = getattr(e, "wire_payload", None)
                        if callable(wire_payload):
                            body["error_payload"] = encode_value(
                                wire_payload())
                        if trace is not None:
                            trace.finish(type(e).__name__)
                            body["trace_id"] = trace.trace_id
                            body["trace"] = trace.to_dict()
                    if request_key is not None:
                        retryable = "error" in body \
                            and "retry_after" in body
                        try:
                            door.complete(request_key, body,
                                          retryable=retryable)
                        # the terminal
                        # frame must still land when parking fails —
                        # logged loudly, never silent
                        except Exception:
                            logger.exception(
                                "gateway: exactly-once complete failed "
                                "for %r", request_key)
                    entry.streams.finish(stream, body)

                threading.Thread(target=work, daemon=True,
                                 name=f"gateway-stream-{rid}").start()
                return self._pump(stream, 0, req_id)

            def _resume_stream(self, req, req_id):
                """Re-attach a reconnecting consumer at its cursor. A
                live (or TTL-retained finished) stream replays from the
                ring; an aged-out stream falls back to the parked
                exactly-once outcome, whose full result the client
                trims by cursor. Typed errors (pending / unknown /
                backpressure) surface through the common wire-error
                path."""
                from deeplearning4j_tpu_torch.serving.exactly_once import (
                    UnknownRequestError,
                )

                params = decode_value(req.get("params") or {})
                rid = str(params.get("request_id"))
                cursor = int(params.get("cursor") or 0)
                stream = entry.streams.attach(rid)
                if stream is not None:
                    return self._pump(stream, cursor, req_id)
                if door is None:
                    raise UnknownRequestError(
                        f"stream {rid!r}: no ring retained and no "
                        "exactly-once door to claim the outcome from — "
                        "re-issue the generation")
                outcome = door.claim(rid)
                return {"id": req_id, **outcome}

            def handle(self):
                while True:
                    try:
                        raw = self.rfile.readline(max_bytes + 1)
                    except (socket.timeout, TimeoutError):
                        logger.warning(
                            "gateway: closing connection idle past "
                            "recv_timeout=%.1fs", recv_timeout)
                        return
                    # mid-request
                    # disconnect: the peer is gone, so there is nobody
                    # to answer typed — ending the handler IS the
                    # handling
                    except (ConnectionResetError, BrokenPipeError, OSError):
                        return  # mid-request disconnect
                    if not raw:
                        return  # clean EOF
                    if len(raw) > max_bytes:
                        # the remainder of this line is unread; the
                        # stream cannot be resynced — answer typed, close
                        self._respond({
                            "id": None,
                            "error": f"RequestTooLargeError: request line "
                                     f"exceeds max_request_bytes="
                                     f"{max_bytes}",
                            "error_type": "RequestTooLargeError"})
                        return
                    req_id = None  # this request's id only — never stale
                    trace = None  # minted per data-path request below
                    request_key = None  # exactly-once idempotency key
                    owner = False  # this handler executes + parks it
                    try:
                        req = json.loads(raw)
                        ctx = None
                        if isinstance(req, dict):
                            req_id = req.get("id")
                            # caller-propagated trace context: a remote
                            # pool's request arrives carrying the
                            # trace_id minted at ITS outermost hop
                            raw_ctx = req.get("trace")
                            if isinstance(raw_ctx, dict):
                                ctx = raw_ctx
                            if door is not None \
                                    and req.get("request_id") is not None:
                                request_key = str(req["request_id"])
                        resp = None
                        if door is not None and isinstance(req, dict) \
                                and req.get("method") in _DOOR_METHODS:
                            # door built-ins, answered without touching
                            # the entry point; claim raises the typed
                            # pending/unknown errors through the normal
                            # wire-error path below
                            if req["method"] == "claim":
                                outcome = door.claim(
                                    str(dict(req.get("params") or {})
                                        .get("request_id")))
                                resp = {"id": req_id, **outcome}
                            else:
                                resp = {"id": req_id,
                                        "result": door.stats()}
                        elif isinstance(req, dict) \
                                and req.get("method") == "resume_stream":
                            # stream re-attach: never deduped (the
                            # resume IS the retry) — ring replay, else
                            # parked-outcome fallback
                            resp = self._resume_stream(req, req_id)
                            if resp is None:
                                return  # shed or disconnected mid-pump
                        elif door is not None and request_key is not None:
                            verdict, info = door.admit(
                                request_key, req["method"],
                                req.get("params") or {})
                            if verdict == "cached":
                                # the original outcome, re-stamped with
                                # THIS retry's wire id — the whole
                                # exactly-once promise in one line
                                resp = {"id": req_id, **info}
                            elif verdict == "pending":
                                resp = {
                                    "id": req_id,
                                    "error": "ResultPendingError: request "
                                             f"{request_key!r} is still "
                                             "executing — claim it in "
                                             f"{float(info):.3g}s",
                                    "error_type": "ResultPendingError",
                                    "retry_after": float(info)}
                            else:
                                owner = True
                        if resp is not None:
                            pass  # door short-circuit: skip dispatch
                        elif req["method"] == "generate_stream":
                            # frames ride this socket from a worker-fed
                            # ring; the worker parks the outcome itself,
                            # so this handler must NOT double-complete
                            resp = self._generate_stream(
                                req, req_id, ctx,
                                request_key if owner else None)
                            owner = False
                            if resp is None:
                                return  # shed or disconnected mid-pump
                        else:
                            if req["method"].startswith("_") \
                                    or req["method"] \
                                    in getattr(entry, "_RPC_EXCLUDED", ()):
                                raise AttributeError(req["method"])
                            method = getattr(entry, req["method"])
                            params = decode_value(req.get("params", {}))
                            if (req["method"] in _TRACED_METHODS
                                    or ctx is not None) \
                                    and observability.tracing_enabled():
                                # the gateway is the outermost hop: mint
                                # the trace here and bind it
                                # thread-locally so pool/server/engine
                                # spans join this id — unless the request
                                # CARRIES a context, in which case this
                                # process is an inner hop and must join
                                # the caller's trace_id (the response's
                                # timeline then grafts into the caller's
                                # via the wall-clock anchors)
                                trace = observability.Trace(
                                    trace_id=ctx.get("trace_id")
                                    if ctx else None)
                                with observability.use_trace(trace), \
                                        trace.span("gateway",
                                                   method=req["method"]):
                                    result = method(**params)
                            else:
                                result = method(**params)
                            resp = {"id": req_id,
                                    "result": encode_value(result)}
                            if trace is not None:
                                trace.finish("served")
                                resp["trace_id"] = trace.trace_id
                                resp["trace"] = trace.to_dict()
                    # RPC boundary: any
                    # server-side failure, typed or not, must be serialized
                    # to the client as a wire error (error_type/retry_after
                    # travel alongside), never crash the connection thread
                    except Exception as e:  # surfaced to the client
                        resp = {"id": req_id,
                                "error": f"{type(e).__name__}: {e}",
                                "error_type": type(e).__name__}
                        retry_after = getattr(e, "retry_after", None)
                        if retry_after is not None:
                            resp["retry_after"] = float(retry_after)
                        # pool-routed errors name the replica that
                        # produced them — ops can map a failing
                        # error stream to one sick replica
                        replica_id = getattr(e, "replica_id", None)
                        if replica_id is not None:
                            resp["replica_id"] = int(replica_id)
                        # errors that carry structured data (e.g. a
                        # SlotMigratedError's handoff_id + emitted
                        # tokens) ship it alongside the message so the
                        # caller can act on it, not just read it
                        wire_payload = getattr(e, "wire_payload", None)
                        if callable(wire_payload):
                            resp["error_payload"] = encode_value(
                                wire_payload())
                        # the postmortem travels on the wire: the
                        # gateway-minted timeline when one exists, else
                        # whatever the typed error carried up
                        if trace is not None:
                            trace.finish(type(e).__name__)
                            resp["trace_id"] = trace.trace_id
                            resp["trace"] = trace.to_dict()
                        else:
                            err_tid = getattr(e, "trace_id", None)
                            if err_tid is not None:
                                resp["trace_id"] = err_tid
                            err_trace = getattr(e, "trace", None)
                            if err_trace is not None:
                                resp["trace"] = err_trace
                    if owner:
                        # park the outcome BEFORE replying: a client
                        # that dies mid-response can still reconnect
                        # and claim(request_id) it. Shed outcomes
                        # (retry_after) resolve VOID — the client's
                        # retry is a genuine new attempt, not a dup
                        body = {k: v for k, v in resp.items()
                                if k != "id"}
                        retryable = "error" in resp \
                            and "retry_after" in resp
                        try:
                            door.complete(request_key, body,
                                          retryable=retryable)
                        # the reply must
                        # still go out when parking/journaling fails —
                        # logged loudly, never silent
                        except Exception:
                            logger.exception(
                                "gateway: exactly-once complete failed "
                                "for %r", request_key)
                    if not self._respond(resp):
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            # handler threads block reading their client socket; stop() must
            # not join them (a connected client would hang shutdown forever)
            daemon_threads = True
            block_on_close = False

        self._server = Server((self._host, self._requested_port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        logger.info("gateway listening on %s:%d", self._host, self.port)
        if self.door is not None and self._replay_enabled \
                and self.door.pending_records():
            self._stop_replay.clear()
            self._replay_thread = threading.Thread(
                target=self._replay_pending, daemon=True,
                name="gateway-journal-replay")
            self._replay_thread.start()
        return self

    def _replay_pending(self) -> None:
        """Crash recovery: re-execute journaled requests that were
        admitted but never completed before the previous incarnation
        died. Each record rides the SAME dedup door as live traffic
        (a reconnecting client's retry and this loop can never both
        execute one id), and records wait — within `replay_timeout` —
        for their named model to be re-installed first."""
        door, entry = self.door, self.entry

        def ready(method: str, params: dict) -> bool:
            name = params.get("name") if isinstance(params, dict) else None
            return name is None or name in getattr(entry, "_models", {})

        def execute(method_name: str, raw_params: dict) -> dict:
            try:
                if method_name.startswith("_") or method_name \
                        in getattr(entry, "_RPC_EXCLUDED", ()):
                    raise AttributeError(method_name)
                method = getattr(entry, method_name)
                result = method(**decode_value(raw_params or {}))
                return {"result": encode_value(result)}
            # replay boundary: like the
            # live RPC boundary, any failure becomes the request's wire
            # outcome (error_type travels alongside), never a crash
            except Exception as e:
                body = {"error": f"{type(e).__name__}: {e}",
                        "error_type": type(e).__name__}
                retry_after = getattr(e, "retry_after", None)
                if retry_after is not None:
                    body["retry_after"] = float(retry_after)
                return body

        deadline = time.monotonic() + self._replay_timeout
        replayed = 0
        while not self._stop_replay.is_set() \
                and time.monotonic() < deadline:
            if not door.pending_records():
                break
            replayed_now = door.replay(execute, ready=ready)
            replayed += replayed_now
            if replayed_now == 0:
                # every remaining record waits on a model install
                self._stop_replay.wait(0.1)
        left = len(door.pending_records())
        if left:
            logger.warning(
                "gateway: replay window closed with %d journaled "
                "requests still pending (model never re-installed?)",
                left)
        else:
            logger.info("gateway: journal replay complete "
                        "(%d re-executed)", replayed)

    def stop(self, drain_timeout: float = 10.0) -> None:
        self._stop_replay.set()
        if self._replay_thread is not None:
            self._replay_thread.join(timeout=5.0)
            self._replay_thread = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        shutdown = getattr(self.entry, "shutdown", None)
        if shutdown is not None:
            shutdown(drain_timeout=drain_timeout)
        if self.door is not None:
            # closes the journal's append handle; a later start() (or a
            # fresh admit) reopens a new segment
            self.door.close()


class _PooledConn:
    """One keep-alive TCP connection in a `GatewayClient`'s pool."""

    __slots__ = ("sock", "file", "last_used")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.file = sock.makefile("rwb")
        self.last_used = time.monotonic()

    def close(self) -> None:
        # best-effort: closing a connection the peer already dropped
        # must not raise out of cleanup (the buffered writer flushes on
        # close)
        with contextlib.suppress(OSError):
            self.file.close()
        with contextlib.suppress(OSError):
            self.sock.close()


class GatewayClient:
    """Line-JSON client for GatewayServer (usable as a reference for
    non-Python clients). Thread-safe: concurrent `call`s each borrow a
    connection from a keep-alive pool (up to `pool_size` idle
    connections are kept; excess ones close on release) instead of
    serializing on one socket or paying a TCP connect per call.

    Fault discipline on every wire edge:

    - **stale-connection detection** — an idle connection older than
      `max_idle` seconds is proactively replaced before it is used (the
      server's `recv_timeout` or an LB may have torn it down; a
      NON-idempotent call cannot discover that mid-send and retry).
    - **bounded retries, idempotent only** — connection-level failures
      (`ConnectionResetError`/`BrokenPipeError`, the server closing
      mid-call) and protocol-level desyncs (`GatewayProtocolError`:
      garbage, truncated or oversize response lines) on IDEMPOTENT
      methods are retried up to `max_retries` times with exponential
      backoff (`retry_backoff * 2**attempt`) over a fresh connection.
      Non-idempotent methods (`fit`, `create_model`, ...) never
      auto-retry: the server may have applied the side effect before
      the connection died.
    - **deadline pass-through** — a per-call `_timeout` overrides the
      connect-time socket timeout, so a caller holding a request
      deadline (e.g. a remote replica adapter) can bound the read
      instead of pinning a thread on a wedged peer. A fired socket
      timeout is NOT retried — the time is gone.
    - **response bounds** — a response line longer than
      `max_response_bytes` or one that stops mid-line raises
      `GatewayProtocolError` and discards the (unresyncable)
      connection.
    - **exactly-once mode** — every call is stamped with a client-minted
      `request_id`; against a server built with `exactly_once={...}`,
      `GatewayClient(exactly_once=True)` retries EVERY method (the
      `_IDEMPOTENT` whitelist collapses into the server-side dedup
      door: a re-send returns the parked original outcome, never
      re-executes), polls through `ResultPendingError` while the
      original execution finishes, and `claim(request_id)` recovers
      the outcome of a call whose connection died mid-response
      (`last_request_id` holds the most recent stamp).

    Server-side errors raise the typed `GatewayError`."""

    # safe to re-send after an ambiguous connection failure: read-only or
    # naturally deduplicated on the server side (generate is seeded, so a
    # re-send recomputes the identical tokens)
    _IDEMPOTENT = frozenset({"predict", "evaluate", "score", "save_model",
                             "server_stats", "pool_stats", "generate",
                             "metrics", "flight_record", "health",
                             "snapshot_model", "replica_metrics",
                             "autoscaler_stats", "set_tenant_quota",
                             # KV handoff edges: fetch is a read,
                             # commit/abort resolve-by-id (re-resolving
                             # returns False), migrate_slots re-runs as
                             # a no-op on an already-drained engine.
                             # resume_generate is NOT here: a re-send
                             # could double-admit the same handoff.
                             "fetch_handoff", "commit_handoff",
                             "abort_handoff", "migrate_slots",
                             # cluster prefix cache: header/frame reads
                             # and the depth/chains probes are pure
                             # reads; export_prefix re-grants a fresh
                             # lease (the orphan's TTL sweep unpins it)
                             "fetch_handoff_header", "fetch_handoff_frame",
                             "prefix_depth", "prefix_chains",
                             "export_prefix"})

    def __init__(self, host: str = "127.0.0.1", port: int = 25333,
                 timeout: float = 60.0, retry_backoff: float = 0.05,
                 max_retries: int = 1, pool_size: int = 2,
                 max_idle: float = 30.0,
                 max_response_bytes: int = 64 << 20,
                 eager_connect: bool = True,
                 exactly_once: bool = False,
                 client_id: Optional[str] = None):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        self._host, self._port, self._timeout = host, port, timeout
        self.retry_backoff = retry_backoff
        self.max_retries = max_retries
        self.pool_size = pool_size
        self.max_idle = max_idle
        self.max_response_bytes = max_response_bytes
        self.exactly_once = bool(exactly_once)
        # the request_id namespace: unique per client process unless the
        # caller pins one (a RECONNECTING client must pin its old id to
        # claim outcomes stamped by its previous incarnation)
        self.client_id = client_id or uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._idle: list = []  # guarded by: _lock
        self._closed = False  # guarded by: _lock
        self._next_id = 0  # guarded by: _lock
        self._next_request = 0  # guarded by: _lock
        # the most recent call()'s idempotency stamp — after a failed
        # call, claim(last_request_id) recovers its parked outcome
        self.last_request_id: Optional[str] = None
        # the most recent response's trace (None when tracing is off or
        # the method is not a traced data-path RPC) — lets callers
        # correlate a result with the server-side span timeline without
        # widening every return type. Benign write race between
        # concurrent calls: each caller reads SOME recent response's
        # trace, which is all the attribute promises
        self.last_trace_id: Optional[str] = None
        self.last_trace: Optional[dict] = None
        if eager_connect:
            # prove the endpoint at construction (historical behavior:
            # a bad host/port fails here, not on the first call)
            self._release(self._open())

    @property
    def _sock(self) -> socket.socket:
        """The most recently pooled idle connection's socket — the
        historical single-connection attribute, kept as a diagnostic /
        test seam (half-closing it exercises the retry path)."""
        with self._lock:
            if not self._idle:
                raise ConnectionError("gateway client has no idle "
                                      "pooled connection")
            return self._idle[-1].sock

    # -- connection pool ---------------------------------------------------
    def _open(self) -> _PooledConn:
        sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout)
        # request lines are small; without NODELAY the resume handshake
        # and every unary call eat Nagle + delayed-ACK stalls
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return _PooledConn(sock)

    def _borrow(self) -> _PooledConn:
        while True:
            with self._lock:
                if self._closed:
                    raise ConnectionError("gateway client is closed")
                conn = self._idle.pop() if self._idle else None
            if conn is None:
                return self._open()
            if time.monotonic() - conn.last_used > self.max_idle:
                # stale keep-alive: the server's recv_timeout (or an
                # LB) may have torn it down — replace it here rather
                # than discover mid-send on a call that cannot retry
                conn.close()
                continue
            return conn

    def _release(self, conn: _PooledConn) -> None:
        conn.last_used = time.monotonic()
        with self._lock:
            if not self._closed and len(self._idle) < self.pool_size:
                self._idle.append(conn)
                return
        conn.close()

    # -- calls -------------------------------------------------------------
    def call(self, method: str, _idempotent: Optional[bool] = None,
             _timeout: Optional[float] = None,
             _trace: Optional[dict] = None,
             _request_id: Optional[str] = None, **params):
        """Invoke `method` on the server's entry point. `_idempotent`
        overrides the built-in retry whitelist for custom entry-point
        methods; `_timeout` bounds this call's socket reads (seconds —
        derive it from the request deadline plus a margin); `_trace` is
        an optional wire trace context
        (`observability.wire_trace_context`) the server joins instead
        of minting its own trace; `_request_id` pins the idempotency
        stamp (default: a fresh `<client_id>-<n>` — re-issuing a call
        with the OLD stamp is how a reconnecting client turns a retry
        into a dedup hit)."""
        with self._lock:
            self._next_request += 1
            request_id = _request_id \
                or f"{self.client_id}-{self._next_request}"
        self.last_request_id = request_id
        if _idempotent is not None:
            idempotent = _idempotent
        elif self.exactly_once:
            # the server-side dedup door makes EVERY re-send safe: it
            # returns the parked original outcome instead of
            # re-executing, so the whitelist no longer gates retries
            idempotent = True
        else:
            idempotent = method in self._IDEMPOTENT
        attempts = 1 + (self.max_retries if idempotent else 0)
        budget = self._timeout if _timeout is None else _timeout
        pending_deadline = time.monotonic() + budget
        attempt = 0
        while True:
            try:
                return self._call_once(method, params, timeout=_timeout,
                                       trace_ctx=_trace,
                                       request_id=request_id)
            except GatewayError as e:
                # exactly-once: "pending" means the ORIGINAL execution
                # is still running server-side (this retry raced it) —
                # poll until the parked outcome appears instead of
                # failing a call whose work is finishing fine
                if (self.exactly_once
                        and e.error_type == "ResultPendingError"
                        and time.monotonic() < pending_deadline):
                    time.sleep(min(e.retry_after or 0.05,
                                   max(0.0, pending_deadline
                                       - time.monotonic())))
                    continue
                raise
            except (ConnectionError, GatewayProtocolError) as e:
                attempt += 1
                if attempt >= attempts:
                    raise
                backoff = self.retry_backoff * (2 ** (attempt - 1))
                logger.warning(
                    "gateway client: %s during idempotent %r; retry "
                    "%d/%d over a fresh connection after %.3fs backoff",
                    type(e).__name__, method, attempt,
                    self.max_retries, backoff)
                time.sleep(backoff)

    def generate_stream(self, name: str, prompt_ids, n_tokens: int, *,
                        temperature: float = 0.0, seed: int = 0,
                        timeout: Optional[float] = None,
                        tenant: Optional[str] = None,
                        priority: str = "interactive",
                        logprobs: int = 0,
                        max_resumes: int = 8,
                        _timeout: Optional[float] = None,
                        _request_id: Optional[str] = None) -> "_GenStream":
        """Streamed `generate`: returns an iterator of frame dicts
        (`{"cursor", "tokens"[, "logprobs"]}`) pushed as the decode
        engine emits tokens. On ANY wire failure the iterator
        transparently reconnects and re-attaches via
        `resume_stream(request_id, cursor)` (up to `max_resumes`
        times): the server replays retained ring history and the
        client trims by cursor, so the concatenated `.tokens` is
        identical to the unary `generate` result — zero lost, zero
        duplicated, in order. A consumer that stalled past the ring
        falls back to the parked exactly-once outcome (`claim`)
        automatically. After exhaustion `.tokens`/`.logprobs` hold the
        full sequence and `.result` the terminal value; `.resumes`
        counts reconnects survived."""
        with self._lock:
            self._next_request += 1
            request_id = _request_id \
                or f"{self.client_id}-{self._next_request}"
        self.last_request_id = request_id
        params = {"name": name, "prompt_ids": np.asarray(prompt_ids),
                  "n_tokens": int(n_tokens),
                  "temperature": float(temperature), "seed": int(seed),
                  "timeout": timeout, "tenant": tenant,
                  "priority": priority}
        if logprobs:
            params["logprobs"] = int(logprobs)
        return _GenStream(self, params, request_id,
                          self._timeout if _timeout is None else _timeout,
                          max_resumes)

    def claim(self, request_id: str, timeout: Optional[float] = None,
              _timeout: Optional[float] = None):
        """Recover the parked outcome of a detached request — one whose
        connection died mid-response, or one submitted before a gateway
        restart and replayed off the journal. Polls through the typed
        `ResultPendingError` (the decode is still running) until
        `timeout` (default: the client timeout); a cached error outcome
        re-raises the ORIGINAL typed failure; `UnknownRequestError`
        means the outcome aged past the server's TTL (or was never
        admitted)."""
        deadline = time.monotonic() + (self._timeout if timeout is None
                                       else timeout)
        while True:
            try:
                return self.call("claim", request_id=str(request_id),
                                 _timeout=_timeout)
            except GatewayError as e:
                if e.error_type != "ResultPendingError":
                    raise
                now = time.monotonic()
                if now >= deadline:
                    raise
                time.sleep(min(e.retry_after or 0.05, deadline - now))

    def _call_once(self, method: str, params: dict,
                   timeout: Optional[float] = None,
                   trace_ctx: Optional[dict] = None,
                   request_id: Optional[str] = None):
        conn = self._borrow()
        try:
            with self._lock:
                self._next_id += 1
                req_id = self._next_id
            req = {"id": req_id, "method": method,
                   "params": encode_value(params)}
            if request_id is not None:
                # the idempotency stamp rides OUTSIDE params: servers
                # without the dedup door ignore unknown top-level keys,
                # so stamping is backward-compatible
                req["request_id"] = request_id
            if trace_ctx:
                req["trace"] = trace_ctx
            conn.sock.settimeout(self._timeout if timeout is None
                                 else timeout)
            conn.file.write((json.dumps(req) + "\n").encode())
            conn.file.flush()
            line = conn.file.readline(self.max_response_bytes + 1)
            if not line:
                raise ConnectionError("gateway closed the connection")
            if len(line) > self.max_response_bytes:
                raise GatewayProtocolError(
                    f"response line exceeds max_response_bytes="
                    f"{self.max_response_bytes}")
            if not line.endswith(b"\n"):
                raise GatewayProtocolError(
                    "response truncated mid-line (peer died while "
                    "writing)")
            try:
                resp = json.loads(line)
            except ValueError as e:
                raise GatewayProtocolError(
                    f"unparseable response line: {e}") from e
            if not isinstance(resp, dict) \
                    or ("result" not in resp and "error" not in resp):
                raise GatewayProtocolError(
                    "malformed response object (no result/error)")
            # id None is legal on pre-dispatch errors (oversize
            # request); anything else must echo OUR id or the stream
            # is carrying someone else's response
            if resp.get("id") not in (req_id, None):
                raise GatewayProtocolError(
                    f"response id {resp.get('id')!r} does not match "
                    f"request id {req_id} (stream desynced)")
        except BaseException:
            # the connection's framing state is unknowable after ANY
            # failure mid-call — never return it to the pool
            conn.close()
            raise
        self._release(conn)
        self.last_trace_id = resp.get("trace_id")
        self.last_trace = resp.get("trace")
        if "error" in resp:
            err_payload = resp.get("error_payload")
            raise GatewayError(resp["error"],
                               error_type=resp.get("error_type"),
                               retry_after=resp.get("retry_after"),
                               replica_id=resp.get("replica_id"),
                               trace_id=resp.get("trace_id"),
                               trace=resp.get("trace"),
                               payload=decode_value(err_payload)
                               if err_payload is not None else None)
        return decode_value(resp["result"])

    def close(self):
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


class _GenStream:
    """One streamed generation: iterate for frame dicts
    (`{"cursor", "tokens"[, "logprobs"]}`), each carrying only tokens
    not yet delivered THROUGH THIS ITERATOR — a resume replays ring
    history, and the client-side cursor trim drops everything already
    seen, so the frames concatenate to exactly the unary result no
    matter how many times the wire died in between.

    Borrows a pooled connection for EXCLUSIVE use while the stream is
    live (a multi-frame response cannot interleave with unary calls on
    one socket); a cleanly-terminated stream ends at a line boundary,
    so the connection goes back to the pool — a torn one is closed."""

    def __init__(self, client: GatewayClient, params: dict,
                 request_id: str, timeout: Optional[float],
                 max_resumes: int):
        self._client = client
        self.request_id = request_id
        self._timeout = timeout
        self._max_resumes = int(max_resumes)
        self.tokens: list = []
        self.logprobs: list = []
        self.resumes = 0
        self.result = None
        self.trace_id = None
        self.trace = None
        self._done = False
        self._conn: Optional[_PooledConn] = None
        self._req_id = None
        self._pending_deadline: Optional[float] = None
        self._send({"method": "generate_stream",
                    "params": encode_value(params),
                    "request_id": request_id})

    # -- wire --------------------------------------------------------------
    def _send(self, body: dict) -> None:
        self.close()
        conn = self._client._borrow()
        try:
            conn.sock.settimeout(self._timeout)
            with self._client._lock:
                self._client._next_id += 1
                self._req_id = self._client._next_id
            req = dict(body, id=self._req_id)
            conn.file.write((json.dumps(req) + "\n").encode())
            conn.file.flush()
        except BaseException:
            conn.close()
            raise
        self._conn = conn

    def _read_line(self) -> dict:
        max_bytes = self._client.max_response_bytes
        line = self._conn.file.readline(max_bytes + 1)
        if not line:
            raise ConnectionError("gateway closed the stream connection")
        if len(line) > max_bytes:
            raise GatewayProtocolError(
                f"stream line exceeds max_response_bytes={max_bytes}")
        if not line.endswith(b"\n"):
            raise GatewayProtocolError(
                "stream line truncated mid-frame (peer died while "
                "writing)")
        try:
            obj = json.loads(line)
        except ValueError as e:
            raise GatewayProtocolError(
                f"unparseable stream line: {e}") from e
        if not isinstance(obj, dict) or not (
                "frame" in obj or "result" in obj or "error" in obj):
            raise GatewayProtocolError(
                "malformed stream line (no frame/result/error)")
        if obj.get("id") not in (self._req_id, None):
            raise GatewayProtocolError(
                f"stream response id {obj.get('id')!r} does not match "
                f"request id {self._req_id} (stream desynced)")
        return obj

    def _resume(self) -> None:
        """Reconnect and re-attach at the current cursor (bounded)."""
        self.resumes += 1
        self._send({"method": "resume_stream",
                    "params": {"request_id": self.request_id,
                               "cursor": len(self.tokens)}})

    # -- terminal handling -------------------------------------------------
    def _finish(self, full) -> Optional[dict]:
        """Fold the terminal full result in: whatever tail the frames
        never delivered becomes one last frame (None when the frames
        already covered everything)."""
        self.result = full
        self._done = True
        # the terminal line is the stream's last byte: the connection
        # sits at a clean line boundary, so it can serve unary calls
        conn, self._conn = self._conn, None
        if conn is not None:
            self._client._release(conn)
        full_toks = full["tokens"] if isinstance(full, dict) else full
        full_toks = [int(t) for t in np.asarray(full_toks).reshape(-1)]
        rest = full_toks[len(self.tokens):]
        if not rest:
            return None
        self.tokens.extend(rest)
        out = {"cursor": len(self.tokens), "tokens": rest}
        if isinstance(full, dict):
            fresh_lps = list(full.get("logprobs")
                             or [])[len(self.logprobs):]
            if fresh_lps:
                self.logprobs.extend(fresh_lps)
                out["logprobs"] = fresh_lps
        return out

    # -- iterator protocol -------------------------------------------------
    def __iter__(self) -> "_GenStream":
        return self

    def __next__(self) -> dict:
        while True:
            if self._done:
                raise StopIteration
            try:
                obj = self._read_line()
            # socket.timeout and ConnectionError are OSError subclasses:
            # one catch covers torn, reset, and silent connections
            except (OSError, GatewayProtocolError):
                self.close()
                if self.resumes >= self._max_resumes:
                    raise
                # first reconnect is immediate — the tear already cost
                # the consumer latency; back off only on repeat failures
                if self.resumes:
                    time.sleep(self._client.retry_backoff
                               * (2 ** min(self.resumes - 1, 6)))
                self._resume()
                continue
            if "frame" in obj:
                self._pending_deadline = None
                frame = obj["frame"]
                cursor = int(frame.get("cursor", 0))
                toks = [int(t) for t in frame.get("tokens") or []]
                fresh = cursor - len(self.tokens)
                if fresh <= 0 or not toks:
                    continue  # wholly-duplicate replay frame
                fresh = min(fresh, len(toks))
                out = {"cursor": cursor, "tokens": toks[-fresh:]}
                self.tokens.extend(toks[-fresh:])
                lps = frame.get("logprobs")
                if lps is not None:
                    fresh_lps = decode_value(lps)[-fresh:]
                    self.logprobs.extend(fresh_lps)
                    out["logprobs"] = fresh_lps
                return out
            if "result" in obj:
                self.trace_id = obj.get("trace_id")
                self.trace = obj.get("trace")
                self._client.last_trace_id = self.trace_id
                self._client.last_trace = self.trace
                out = self._finish(decode_value(obj["result"]))
                if out is not None:
                    return out
                raise StopIteration
            # error line
            err_type = obj.get("error_type")
            if err_type == "ResultPendingError":
                # the original execution is still running server-side
                # (a resume raced it past the ring TTL): poll the
                # parked outcome instead of failing finished work
                now = time.monotonic()
                if self._pending_deadline is None:
                    self._pending_deadline = now + (
                        self._timeout or 60.0)
                if now < self._pending_deadline:
                    time.sleep(min(obj.get("retry_after") or 0.05,
                                   self._pending_deadline - now))
                    self._resume()
                    continue
            elif err_type == "StreamBackpressureError":
                # this consumer stalled out of the replay ring — the
                # generation finished (or will); recover the full
                # sequence from the parked exactly-once outcome and
                # trim it like any other terminal
                self.close()
                try:
                    full = self._client.claim(self.request_id,
                                              _timeout=self._timeout)
                except GatewayError as claim_err:
                    # no door (or the outcome is gone): the typed
                    # backpressure verdict must not be masked by the
                    # failed fallback
                    raise GatewayError(
                        obj.get("error", "stream fell out of the "
                                         "replay ring"),
                        error_type=err_type,
                        retry_after=obj.get("retry_after"),
                        trace_id=obj.get("trace_id"),
                    ) from claim_err
                out = self._finish(full)
                if out is not None:
                    return out
                raise StopIteration
            self.close()
            err_payload = obj.get("error_payload")
            raise GatewayError(obj.get("error", "stream failed"),
                               error_type=err_type,
                               retry_after=obj.get("retry_after"),
                               replica_id=obj.get("replica_id"),
                               trace_id=obj.get("trace_id"),
                               trace=obj.get("trace"),
                               payload=decode_value(err_payload)
                               if err_payload is not None else None)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

    def __enter__(self) -> "_GenStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
