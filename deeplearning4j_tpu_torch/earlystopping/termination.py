"""Termination conditions (reference `earlystopping/termination/`):
epoch-level conditions checked after each score evaluation, iteration-level
conditions checked every minibatch."""
from __future__ import annotations

import math
import time


class EpochTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs (reference `MaxEpochsTerminationCondition`)."""

    def __init__(self, max_epochs: int):
        if max_epochs <= 0:
            raise ValueError("max_epochs must be > 0")
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once score drops at/below a target (reference
    `BestScoreEpochTerminationCondition`)."""

    def __init__(self, best_expected_score: float):
        self.best_expected_score = best_expected_score

    def terminate(self, epoch, score):
        return score <= self.best_expected_score

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected_score})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (sufficient) improvement (reference
    `ScoreImprovementEpochTerminationCondition`)."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.max_epochs_without_improvement = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best_score = None
        self.epochs_without = 0

    def initialize(self):
        self.best_score = None
        self.epochs_without = 0

    def terminate(self, epoch, score):
        if self.best_score is None or self.best_score - score > self.min_improvement:
            self.best_score = score if self.best_score is None else min(self.best_score, score)
            self.epochs_without = 0
            return False
        self.epochs_without += 1
        return self.epochs_without > self.max_epochs_without_improvement

    def __str__(self):
        return (f"ScoreImprovementEpochTerminationCondition"
                f"({self.max_epochs_without_improvement}, {self.min_improvement})")


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    """Wall-clock budget (reference `MaxTimeIterationTerminationCondition`)."""

    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, score):
        return (time.monotonic() - self._start) >= self.max_seconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if score explodes past a ceiling (reference
    `MaxScoreIterationTerminationCondition`)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score):
        return score > self.max_score

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort on NaN/Inf score (reference
    `InvalidScoreIterationTerminationCondition`)."""

    def terminate(self, score):
        return math.isnan(score) or math.isinf(score)

    def __str__(self):
        return "InvalidScoreIterationTerminationCondition()"
