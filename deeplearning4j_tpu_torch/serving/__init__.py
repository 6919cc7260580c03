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
(`serving.exactly_once`) and the in-process chaos injectors
(`serving.chaos`).

The rest of the cluster tier resolves here to a `NotImplementedError`
naming its ROADMAP queue item: the gateway, remote replicas and the
network injectors (A11c).
"""
from deeplearning4j_tpu_torch.serving.autoscaler import Autoscaler
from deeplearning4j_tpu_torch.serving.chaos import (
    BrokenModelInjector,
    InjectedServingFault,
    JournalCorruptionInjector,
    KVTransferCorruptionInjector,
    LoadSpikeInjector,
    PrefixFetchSaboteur,
    ReloadCorruptionInjector,
    ReplicaCrashInjector,
    ReplicaHangInjector,
    SlowInferenceInjector,
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

# the JAX package's serving cluster tier still to port: the wire, the
# processes and the network injectors (A11c)
_A11C = frozenset({
    "ChaosProxy", "ConnectionResetInjector", "GarbageResponseInjector",
    "NetworkLatencyInjector", "PartitionInjector", "RemoteReplica",
    "RemoteReplicaPool", "ReplicaEntryPoint", "ReplicaSpawnError",
    "ReplicaSupervisor", "SlowConsumerInjector", "SlowLorisInjector",
    "spawn_replica_pool",
})


def __getattr__(name):
    if name in _A11C:
        raise NotImplementedError(
            f"serving.{name} is not ported yet (ROADMAP queue A11c: the "
            "gateway, remote replicas, the network injectors)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AutoscaleError",
    "Autoscaler",
    "BrokenModelInjector",
    "CircuitBreaker",
    "DeadlineExceededError",
    "DecodeEngine",
    "DedupCache",
    "DisaggCoordinator",
    "ExactlyOnceDoor",
    "FlightRecorder",
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
    "OutOfPagesError",
    "PrefixCache",
    "PrefixDirectory",
    "PrefixFetchSaboteur",
    "ReloadCorruptionInjector",
    "ReplicaCrashInjector",
    "ReplicaEvictedError",
    "ReplicaHangInjector",
    "ReplicaPool",
    "RequestJournal",
    "ResultPendingError",
    "ServerClosedError",
    "ServerOverloadedError",
    "ServiceUnavailableError",
    "ServingError",
    "SlotMigratedError",
    "SlowInferenceInjector",
    "SpeculativeDecoder",
    "StreamBackpressureError",
    "StreamRegistry",
    "TenantFloodInjector",
    "TenantQuotaExceededError",
    "TokenStream",
    "Trace",
    "UnknownRequestError",
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
