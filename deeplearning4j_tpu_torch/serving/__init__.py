"""Serving tier — counterpart of `deeplearning4j_tpu.serving`:
`ModelServer` (admission control, deadlines, micro-batched predict,
circuit breaking, safe hot reload with canary and drift gate), the
continuous-batching `DecodeEngine` with its latency tier (`PrefixCache`,
`SpeculativeDecoder`) and quantization (`serving.quantize`), the
observability pieces, the typed serving errors, and the in-process half
of the cluster tier: QoS lanes, the prefill and decode roles, KV handoff
and live migration (`serving.kv_transfer`: `DisaggCoordinator`,
`LeaseTable`), and the cluster prefix directory
(`serving.prefix_directory.PrefixDirectory`).

The rest of the cluster tier resolves here to a `NotImplementedError`
naming its ROADMAP queue item: replica pools, the autoscaler, streaming
and exactly-once (A11b); the gateway, remote replicas and the chaos
injectors (A11c).
"""
from deeplearning4j_tpu_torch.serving.decode_engine import DecodeEngine
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
from deeplearning4j_tpu_torch.serving.speculative import SpeculativeDecoder

# the JAX package's serving cluster tier still to port, by queue item:
# the replica pool and what builds on it (A11b), the wire, the
# processes and the fault injectors (A11c)
_A11B = frozenset({
    "Autoscaler", "DedupCache", "ExactlyOnceDoor", "ReplicaEvictedError",
    "ReplicaPool", "RequestJournal", "ResultPendingError",
    "StreamBackpressureError", "StreamRegistry", "TokenStream",
    "UnknownRequestError",
})
_A11C = frozenset({
    "BrokenModelInjector", "ChaosProxy", "ConnectionResetInjector",
    "GarbageResponseInjector", "InjectedServingFault",
    "JournalCorruptionInjector", "KVTransferCorruptionInjector",
    "LoadSpikeInjector", "NetworkLatencyInjector", "PartitionInjector",
    "PrefixFetchSaboteur", "ReloadCorruptionInjector", "RemoteReplica",
    "RemoteReplicaPool", "ReplicaCrashInjector", "ReplicaEntryPoint",
    "ReplicaHangInjector", "ReplicaSpawnError", "ReplicaSupervisor",
    "SlowConsumerInjector", "SlowInferenceInjector", "SlowLorisInjector",
    "TenantFloodInjector", "spawn_replica_pool",
})


def __getattr__(name):
    if name in _A11B:
        raise NotImplementedError(
            f"serving.{name} is not ported yet (ROADMAP queue A11b: replica "
            "pools, the autoscaler, streaming, exactly-once)")
    if name in _A11C:
        raise NotImplementedError(
            f"serving.{name} is not ported yet (ROADMAP queue A11c: the "
            "gateway, remote replicas, the chaos injectors)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AutoscaleError",
    "CircuitBreaker",
    "DeadlineExceededError",
    "DecodeEngine",
    "DisaggCoordinator",
    "FlightRecorder",
    "InferenceFailedError",
    "KVTransferError",
    "LeaseTable",
    "MetricsRegistry",
    "ModelServer",
    "ModelValidationError",
    "OutOfPagesError",
    "PrefixCache",
    "PrefixDirectory",
    "ServerClosedError",
    "ServerOverloadedError",
    "ServiceUnavailableError",
    "ServingError",
    "SlotMigratedError",
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
