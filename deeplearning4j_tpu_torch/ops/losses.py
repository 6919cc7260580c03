"""Loss functions, as configuration only (counterpart of the enum in
`deeplearning4j_tpu/ops/losses.py`).

The serving path never evaluates a loss. The enum is here so that
output-layer configurations parse and re-serialize; the loss math comes
with the training slice.
"""
from __future__ import annotations

import enum


class LossFunction(str, enum.Enum):
    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    XENT = "xent"  # binary cross-entropy
    MCXENT = "mcxent"  # multi-class cross-entropy
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    COSINE_PROXIMITY = "cosine_proximity"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mean_absolute_percentage_error"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "mean_squared_logarithmic_error"
    POISSON = "poisson"
