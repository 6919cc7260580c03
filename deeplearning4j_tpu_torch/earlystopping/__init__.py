"""Early stopping (reference `deeplearning4j-nn/.../earlystopping/`;
counterpart of `deeplearning4j_tpu.earlystopping`)."""

from deeplearning4j_tpu_torch.earlystopping.config import EarlyStoppingConfiguration  # noqa: F401
from deeplearning4j_tpu_torch.earlystopping.result import (  # noqa: F401
    EarlyStoppingResult,
    TerminationReason,
)
from deeplearning4j_tpu_torch.earlystopping.saver import (  # noqa: F401
    InMemoryModelSaver,
    LocalFileModelSaver,
)
from deeplearning4j_tpu_torch.earlystopping.score_calc import DataSetLossCalculator  # noqa: F401
from deeplearning4j_tpu_torch.earlystopping.termination import (  # noqa: F401
    BestScoreEpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_tpu_torch.earlystopping.trainer import EarlyStoppingTrainer  # noqa: F401

# the reference has a separate EarlyStoppingGraphTrainer; here the one
# trainer drives both MultiLayerNetwork and ComputationGraph (same fit
# surface)
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
