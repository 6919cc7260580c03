"""Serving tier — counterpart of `deeplearning4j_tpu.serving`:
`ModelServer` (admission control, deadlines, micro-batched predict,
circuit breaking, safe hot reload with canary and drift gate), the
continuous-batching `DecodeEngine` with its latency tier (`PrefixCache`,
`SpeculativeDecoder`) and quantization (`serving.quantize`), the
observability pieces, and the typed serving errors.

The serving cluster tier (replica pools, autoscaler, chaos injectors,
exactly-once, KV transfer, streaming, the prefix directory and the
remote replicas) is ROADMAP queue A11: its names resolve here to a
`NotImplementedError` that says so.
"""
from deeplearning4j_tpu_torch.serving.decode_engine import DecodeEngine
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
from deeplearning4j_tpu_torch.serving.quantize import (
    argmax_drift_rate,
    drift_report,
    perplexity,
    quantize_net_weights,
)
from deeplearning4j_tpu_torch.serving.speculative import SpeculativeDecoder

# the JAX package's serving cluster tier, not ported yet
_CLUSTER_TIER = frozenset({
    "Autoscaler", "BrokenModelInjector", "ChaosProxy",
    "ConnectionResetInjector", "DedupCache", "DisaggCoordinator",
    "ExactlyOnceDoor", "GarbageResponseInjector", "InjectedServingFault",
    "JournalCorruptionInjector", "KVTransferCorruptionInjector",
    "KVTransferError", "LeaseTable", "LoadSpikeInjector",
    "NetworkLatencyInjector", "PartitionInjector", "PrefixDirectory",
    "PrefixFetchSaboteur", "ReloadCorruptionInjector",
    "RemoteReplica", "RemoteReplicaPool", "ReplicaCrashInjector",
    "ReplicaEntryPoint", "ReplicaEvictedError", "ReplicaHangInjector",
    "ReplicaPool", "ReplicaSpawnError", "ReplicaSupervisor",
    "RequestJournal", "ResultPendingError", "SlotMigratedError",
    "SlowConsumerInjector", "SlowInferenceInjector", "SlowLorisInjector",
    "StreamBackpressureError", "StreamRegistry", "TenantFloodInjector",
    "TokenStream", "UnknownRequestError", "spawn_replica_pool",
})


def __getattr__(name):
    if name in _CLUSTER_TIER:
        raise NotImplementedError(
            f"serving.{name} is not ported yet (ROADMAP queue A11: serving "
            "cluster tier)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AutoscaleError",
    "CircuitBreaker",
    "DeadlineExceededError",
    "DecodeEngine",
    "FlightRecorder",
    "InferenceFailedError",
    "MetricsRegistry",
    "ModelServer",
    "ModelValidationError",
    "OutOfPagesError",
    "PrefixCache",
    "ServerClosedError",
    "ServerOverloadedError",
    "ServiceUnavailableError",
    "ServingError",
    "SpeculativeDecoder",
    "TenantQuotaExceededError",
    "Trace",
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
