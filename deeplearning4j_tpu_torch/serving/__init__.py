"""Serving tier — counterpart of `deeplearning4j_tpu.serving`:
`ModelServer` (admission control, deadlines, micro-batched predict,
circuit breaking, safe hot reload with canary and drift gate), the
continuous-batching `DecodeEngine` with its latency tier (`PrefixCache`,
`SpeculativeDecoder`) and quantization (`serving.quantize`), the
observability pieces, the typed serving errors, and the in-process half
of the cluster tier: QoS lanes, the prefill and decode roles, KV handoff
and live migration (`serving.kv_transfer`: `DisaggCoordinator`,
`LeaseTable`), the cluster prefix directory
(`serving.prefix_directory.PrefixDirectory`), the replica pool
(`serving.replica_pool.ReplicaPool`) with its `Autoscaler`, resumable
token streams (`serving.streaming`), the exactly-once door
(`serving.exactly_once`), the chaos injectors (`serving.chaos`), and
the cross-process pool: replicas as processes behind the gateway wire
(`serving.remote_replica`: `RemoteReplica`, `RemoteReplicaPool`,
`ReplicaSupervisor`, `spawn_replica_pool`).
"""
from deeplearning4j_tpu_torch.serving.autoscaler import Autoscaler
from deeplearning4j_tpu_torch.serving.chaos import (
    BrokenModelInjector,
    ChaosProxy,
    ConnectionResetInjector,
    GarbageResponseInjector,
    InjectedServingFault,
    JournalCorruptionInjector,
    KVTransferCorruptionInjector,
    LoadSpikeInjector,
    NetworkLatencyInjector,
    PartitionInjector,
    PrefixFetchSaboteur,
    ReloadCorruptionInjector,
    ReplicaCrashInjector,
    ReplicaHangInjector,
    SlowConsumerInjector,
    SlowInferenceInjector,
    SlowLorisInjector,
    TenantFloodInjector,
)
from deeplearning4j_tpu_torch.serving.decode_engine import DecodeEngine
from deeplearning4j_tpu_torch.serving.exactly_once import (
    DedupCache,
    ExactlyOnceDoor,
    RequestJournal,
    ResultPendingError,
    UnknownRequestError,
)
from deeplearning4j_tpu_torch.serving.kv_transfer import (
    DisaggCoordinator,
    KVTransferError,
    LeaseTable,
    SlotMigratedError,
)
from deeplearning4j_tpu_torch.serving.model_server import (
    AutoscaleError,
    CircuitBreaker,
    DeadlineExceededError,
    InferenceFailedError,
    ModelServer,
    ModelValidationError,
    OutOfPagesError,
    ServerClosedError,
    ServerOverloadedError,
    ServiceUnavailableError,
    ServingError,
    TenantQuotaExceededError,
)
from deeplearning4j_tpu_torch.serving.observability import (
    FlightRecorder,
    MetricsRegistry,
    Trace,
    attach_trace,
    current_trace,
    maybe_trace,
    tracing_enabled,
    use_trace,
)
from deeplearning4j_tpu_torch.serving.prefix_cache import (
    PrefixCache,
    chain_keys,
)
from deeplearning4j_tpu_torch.serving.prefix_directory import PrefixDirectory
from deeplearning4j_tpu_torch.serving.quantize import (
    argmax_drift_rate,
    drift_report,
    perplexity,
    quantize_net_weights,
)
from deeplearning4j_tpu_torch.serving.replica_pool import (
    ReplicaEvictedError,
    ReplicaPool,
)
from deeplearning4j_tpu_torch.serving.speculative import SpeculativeDecoder
from deeplearning4j_tpu_torch.serving.streaming import (
    StreamBackpressureError,
    StreamRegistry,
    TokenStream,
)

# the cross-process tier resolves lazily (PEP 562): remote_replica
# imports gateway, and gateway imports THIS package for observability —
# an eager import here would close that cycle while gateway is still
# half-executed. By the time anyone touches these names, gateway is
# fully loaded.
_REMOTE_NAMES = frozenset({
    "RemoteReplica",
    "RemoteReplicaPool",
    "ReplicaEntryPoint",
    "ReplicaSpawnError",
    "ReplicaSupervisor",
    "spawn_replica_pool",
})


def __getattr__(name):
    if name in _REMOTE_NAMES:
        from deeplearning4j_tpu_torch.serving import remote_replica

        return getattr(remote_replica, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AutoscaleError",
    "Autoscaler",
    "BrokenModelInjector",
    "ChaosProxy",
    "CircuitBreaker",
    "ConnectionResetInjector",
    "DeadlineExceededError",
    "DecodeEngine",
    "DedupCache",
    "DisaggCoordinator",
    "ExactlyOnceDoor",
    "FlightRecorder",
    "GarbageResponseInjector",
    "InferenceFailedError",
    "InjectedServingFault",
    "JournalCorruptionInjector",
    "KVTransferCorruptionInjector",
    "KVTransferError",
    "LeaseTable",
    "LoadSpikeInjector",
    "MetricsRegistry",
    "ModelServer",
    "ModelValidationError",
    "NetworkLatencyInjector",
    "OutOfPagesError",
    "PartitionInjector",
    "PrefixCache",
    "PrefixDirectory",
    "PrefixFetchSaboteur",
    "RemoteReplica",
    "RemoteReplicaPool",
    "ReplicaEntryPoint",
    "ReplicaSpawnError",
    "ReplicaSupervisor",
    "RequestJournal",
    "ResultPendingError",
    "SpeculativeDecoder",
    "ReloadCorruptionInjector",
    "ReplicaCrashInjector",
    "ReplicaEvictedError",
    "ReplicaHangInjector",
    "ReplicaPool",
    "ServerClosedError",
    "ServerOverloadedError",
    "ServiceUnavailableError",
    "ServingError",
    "SlotMigratedError",
    "SlowConsumerInjector",
    "SlowInferenceInjector",
    "SlowLorisInjector",
    "TenantFloodInjector",
    "TenantQuotaExceededError",
    "TokenStream",
    "StreamBackpressureError",
    "StreamRegistry",
    "Trace",
    "UnknownRequestError",
    "spawn_replica_pool",
    "argmax_drift_rate",
    "attach_trace",
    "chain_keys",
    "current_trace",
    "drift_report",
    "maybe_trace",
    "perplexity",
    "quantize_net_weights",
    "tracing_enabled",
    "use_trace",
]
