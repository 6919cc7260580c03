"""Early-stopping outcome (reference `EarlyStoppingResult.java`)."""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional


class TerminationReason(str, enum.Enum):
    ERROR = "error"
    ITERATION_TERMINATION_CONDITION = "iteration_termination_condition"
    EPOCH_TERMINATION_CONDITION = "epoch_termination_condition"


@dataclass
class EarlyStoppingResult:
    termination_reason: TerminationReason
    termination_details: str
    score_vs_epoch: Dict[int, float]
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Optional[object] = None
