"""Distributed training — counterpart of `deeplearning4j_tpu.parallel`.

The reference's parallelism inventory is data parallelism over three
transports (in-process multi-GPU averaging, `ParallelWrapper.java:179`;
Spark parameter averaging, `ParameterAveragingTrainingMaster.java:75`;
an Aeron parameter server, `ParameterServerParallelWrapper.java:39`).
Ported here, on one device: meshes (`make_mesh`), `ParallelWrapper`
(the single-device step on the whole batch: the JAX wrapper's
global-view result), device-side batch prefetch, the parameter-averaging
`TrainingMaster` with its elastic worker pool and the distributed
handles, the parameter server with its TCP wire, fault tolerance and
its injectors, parallel early stopping, export-staged training and the
CLI (`parallel.main`). The replicated Switch mixture of experts is
`parallel.experts`.

The multi-device half (ROADMAP queue A12b: meshes over several cards,
`multiprocess` on `torch.distributed`, tensor-parallel `param_specs`,
pipeline and sequence parallelism, the expert-parallel MoE) raises
`NotImplementedError` naming A12b.
"""

from deeplearning4j_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    ParallelWrapper,
)
from deeplearning4j_tpu_torch.parallel.early_stopping import (  # noqa: F401
    EarlyStoppingDistributedTrainer,
    EarlyStoppingParallelTrainer,
)
from deeplearning4j_tpu_torch.parallel.fault_tolerance import (  # noqa: F401
    FaultInjectionListener,
    FaultTolerantTrainer,
    InjectedFault,
    NaNGradientInjector,
    ParameterServerStallInjector,
    PoisonBatchInjector,
    SlowWorkerInjector,
    WorkerCrashInjector,
)
from deeplearning4j_tpu_torch.parallel.parameter_server import (  # noqa: F401
    ParameterServer,
    ParameterServerParallelWrapper,
    ParameterServerTimeoutError,
    RetryingParameterServerClient,
)
from deeplearning4j_tpu_torch.parallel.repartition import (  # noqa: F401
    Repartition,
    RepartitionStrategy,
    balanced_partitions,
)
from deeplearning4j_tpu_torch.parallel.stats import (  # noqa: F401
    TrainingStats,
)
from deeplearning4j_tpu_torch.parallel.training_master import (  # noqa: F401
    DistributedComputationGraph,
    DistributedMultiLayer,
    NoHealthyWorkersError,
    NonFiniteWorkerResultError,
    ParameterAveragingTrainingMaster,
    ParameterAveragingTrainingWorker,
    TrainingHook,
    TrainingMaster,
    TrainingResult,
    TrainingWorker,
    WorkerFailureError,
    WorkerHealth,
    current_worker_id,
)

# the multi-device half's names (the JAX package's `multiprocess`,
# `pipeline`, `pipeline_wrapper` and `sequence` modules)
_A12B_NAMES = frozenset({
    "MultiProcessParallelWrapper", "MultiProcessTrainingMaster",
    "PipelineParallelWrapper", "SequenceParallelWrapper", "find_trunk",
    "global_mesh", "initialize_multiprocess", "pipeline_apply",
    "ring_attention", "shard_stacked_params", "stack_stage_params",
    "ulysses_attention",
})


def __getattr__(name):
    if name in _A12B_NAMES:
        raise NotImplementedError(
            f"parallel.{name} is not ported yet (ROADMAP queue A12b: the "
            "multi-device half of parallel training on torch.distributed)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
