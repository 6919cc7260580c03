"""Time-series + math utilities (a copy of
`deeplearning4j_tpu/util/time_series.py`: numpy only, on the host).

Reference: `deeplearning4j-nn/.../util/TimeSeriesUtils.java` (mask
manipulation, time reversal, last-step extraction) and `util/MathUtils.java`
(the handful of helpers the framework actually uses — most of MathUtils is
superseded by numpy).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


# ------------------------------------------------------------- TimeSeriesUtils
def reverse_time_series(x: np.ndarray,
                        mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Reverse along time, respecting per-example valid lengths: with a
    mask, each example's VALID prefix/suffix is reversed in place rather
    than rotating padding into the front (reference
    `TimeSeriesUtils.reverseTimeSeries`). x: (B, T, F), mask: (B, T)."""
    x = np.asarray(x)
    if mask is None:
        return x[:, ::-1]
    out = np.array(x)
    m = np.asarray(mask) > 0
    for b in range(x.shape[0]):
        idx = np.where(m[b])[0]
        out[b, idx] = x[b, idx[::-1]]
    return out


def extract_last_time_steps(x: np.ndarray,
                            mask: Optional[np.ndarray] = None) -> np.ndarray:
    """(B, T, F) → (B, F) at each example's last VALID step (reference
    `TimeSeriesUtils.pullLastTimeSteps`)."""
    x = np.asarray(x)
    if mask is None:
        return x[:, -1]
    m = np.asarray(mask) > 0
    last = m.shape[1] - 1 - np.argmax(m[:, ::-1], axis=1)
    out = x[np.arange(x.shape[0]), last]
    # an all-masked example has no last valid step: return zeros, matching
    # the fully-masked -> 0 convention used by attention/masked losses
    out = np.where(m.any(axis=1)[:, None], out, 0.0)
    return out


def time_series_mask_to_per_output_mask(mask: np.ndarray,
                                        n_out: int) -> np.ndarray:
    """(B, T) → (B, T, n_out) broadcast mask (reference
    `TimeSeriesUtils.reshapeTimeSeriesMaskToVector` family)."""
    return np.repeat(np.asarray(mask)[:, :, None], n_out, axis=2)


def moving_average(x: np.ndarray, window: int) -> np.ndarray:
    """Trailing moving average over the last axis (reference
    `MathUtils` usage in score smoothing)."""
    x = np.asarray(x, np.float64)
    if window <= 1:
        return x
    c = np.cumsum(np.insert(x, 0, 0.0))
    out = np.empty_like(x)
    for i in range(len(x)):
        lo = max(0, i - window + 1)
        out[i] = (c[i + 1] - c[lo]) / (i + 1 - lo)
    return out


# ------------------------------------------------------------------ MathUtils
def clamp(v: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, v))


def next_power_of_2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def uniform(rng: np.random.Generator, lo: float, hi: float) -> float:
    return float(rng.uniform(lo, hi))


def ss_error(predicted: np.ndarray, actual: np.ndarray) -> float:
    """Sum of squared errors (reference `MathUtils.ssError`)."""
    d = np.asarray(predicted, np.float64) - np.asarray(actual, np.float64)
    return float(np.sum(d * d))


def correlation(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson correlation (reference `MathUtils.correlation`)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if a.std() == 0 or b.std() == 0:
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])
