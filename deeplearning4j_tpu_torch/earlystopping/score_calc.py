"""Score calculators (reference `earlystopping/scorecalc/`)."""
from __future__ import annotations


class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a held-out iterator (reference
    `DataSetLossCalculator`)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        self.iterator.reset()
        total, n = 0.0, 0
        for ds in self.iterator:
            b = ds.num_examples()
            # net.score is the per-example mean → weight by batch size
            total += net.score(ds) * b
            n += b
        self.iterator.reset()
        if n == 0:
            raise ValueError("DataSetLossCalculator: empty iterator")
        # average=True → per-example mean; False → summed loss over the set
        # (reference DataSetLossCalculator semantics)
        return total / n if self.average else total
