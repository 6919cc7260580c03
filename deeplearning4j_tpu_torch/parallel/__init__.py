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
CLI (`parallel.main`).

The in-process SPMD half runs the JAX package's per-device bodies once
per slot of a mesh (`parallel.spmd`; `parallel.mesh.set_local_slots`
puts N slots on one card): the GPipe pipeline (`parallel.pipeline`,
`parallel.pipeline_wrapper`), ring and Ulysses attention
(`parallel.sequence`), the expert-parallel mixture of experts
(`parallel.experts`) and tensor-parallel serving
(`serving.tp_engine`). Their names resolve here lazily, as the modules
import this package's wrapper.

The multi-process half runs one process per card, joined by
`torch.distributed` (`parallel.multiprocess`: `initialize_multiprocess`,
`global_mesh`, `MultiProcessParallelWrapper`,
`MultiProcessTrainingMaster`); `parallel.spmd` bodies run across
processes on a global mesh, and `util.sharded_checkpoint` saves and
restores the training state with `torch.distributed.checkpoint`.
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

# the in-process SPMD half's names, by module (resolved on first use)
_A12B_NAMES = {
    "PipelineParallelWrapper": "pipeline_wrapper",
    "find_trunk": "pipeline_wrapper",
    "pipeline_apply": "pipeline",
    "shard_stacked_params": "pipeline",
    "stack_stage_params": "pipeline",
    "SequenceParallelWrapper": "sequence",
    "ring_attention": "sequence",
    "ulysses_attention": "sequence",
}

# the multi-process half's names (`parallel.multiprocess`, resolved on
# first use)
_MULTIPROCESS_NAMES = frozenset({
    "MultiProcessParallelWrapper", "MultiProcessTrainingMaster",
    "global_mesh", "initialize_multiprocess",
})


def __getattr__(name):
    if name in _A12B_NAMES or name in _MULTIPROCESS_NAMES:
        import importlib

        mod = importlib.import_module(
            f"{__name__}.{_A12B_NAMES.get(name, 'multiprocess')}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
