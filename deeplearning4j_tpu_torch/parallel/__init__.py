"""Distributed training — counterpart of `deeplearning4j_tpu.parallel`.

Only the replicated Switch mixture of experts (`parallel.experts`) is
ported: `MoELayer` and `TransformerBlock(moe_experts>0)` run it on one
card. The JAX package's parallel training (`ParallelWrapper`, meshes,
parameter servers, the training masters, fault tolerance) is ROADMAP
queue A12: its names resolve here to a `NotImplementedError` that says
so.
"""

_A12_NAMES = frozenset({
    "DistributedComputationGraph", "DistributedMultiLayer",
    "EarlyStoppingDistributedTrainer", "EarlyStoppingParallelTrainer",
    "FaultInjectionListener", "FaultTolerantTrainer", "InjectedFault",
    "NaNGradientInjector", "NoHealthyWorkersError",
    "NonFiniteWorkerResultError", "ParallelWrapper",
    "ParameterAveragingTrainingMaster", "ParameterAveragingTrainingWorker",
    "ParameterServer", "ParameterServerParallelWrapper",
    "ParameterServerStallInjector", "ParameterServerTimeoutError",
    "PoisonBatchInjector", "Repartition", "RepartitionStrategy",
    "RetryingParameterServerClient", "SlowWorkerInjector", "TrainingHook",
    "TrainingMaster", "TrainingResult", "TrainingStats", "TrainingWorker",
    "WorkerCrashInjector", "WorkerFailureError", "WorkerHealth",
    "balanced_partitions", "current_worker_id", "make_mesh",
})


def __getattr__(name):
    if name in _A12_NAMES:
        raise NotImplementedError(
            f"parallel.{name} is not ported yet (ROADMAP queue A12: "
            "parallel training)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
