"""Training-loop support: listeners, the health sentinel, line-search
solvers (counterpart of `deeplearning4j_tpu/optimize`)."""

from deeplearning4j_tpu_torch.optimize.health import (  # noqa: F401
    BatchQuarantine,
    DivergenceRollback,
    HealthSentinel,
    QuarantineFullError,
    TrainingDivergedError,
    non_finite_batch_reason,
)
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CheckpointListener,
    CollectScoresIterationListener,
    IterationListener,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ScoreIterationListener,
)
