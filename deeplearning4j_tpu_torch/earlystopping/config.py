"""Early-stopping configuration (reference
`earlystopping/EarlyStoppingConfiguration.java` + its Builder)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from deeplearning4j_tpu_torch.earlystopping.saver import (
    EarlyStoppingModelSaver,
    InMemoryModelSaver,
)
from deeplearning4j_tpu_torch.earlystopping.score_calc import ScoreCalculator
from deeplearning4j_tpu_torch.earlystopping.termination import (
    EpochTerminationCondition,
    IterationTerminationCondition,
)


@dataclass
class EarlyStoppingConfiguration:
    score_calculator: Optional[ScoreCalculator] = None
    model_saver: EarlyStoppingModelSaver = field(default_factory=InMemoryModelSaver)
    epoch_termination_conditions: List[EpochTerminationCondition] = field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = field(default_factory=list)
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1

    class Builder:
        def __init__(self):
            self._cfg = EarlyStoppingConfiguration()

        def epoch_termination_conditions(self, *conds):
            self._cfg.epoch_termination_conditions = list(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._cfg.iteration_termination_conditions = list(conds)
            return self

        def score_calculator(self, calc):
            self._cfg.score_calculator = calc
            return self

        def model_saver(self, saver):
            self._cfg.model_saver = saver
            return self

        def save_last_model(self, b: bool = True):
            self._cfg.save_last_model = b
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._cfg.evaluate_every_n_epochs = n
            return self

        def build(self) -> "EarlyStoppingConfiguration":
            return self._cfg
