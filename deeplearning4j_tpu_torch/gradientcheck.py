"""Numerical against analytic gradients (counterpart of
`deeplearning4j_tpu/gradientcheck.py`), for a MultiLayerNetwork or a
ComputationGraph.

As in the reference (`GradientCheckUtil`), the check runs in float64:
build the network with `dtype=torch.float64` on the CPU. The analytic
gradient is autograd's (`compute_gradient_and_score`); the numerical one
is the central difference of `score_function` at each flat parameter
(`params()` order), eps 1e-6. A parameter fails when the relative error
|a - n| / (|a| + |n|) exceeds `max_rel_error` and the absolute error
exceeds `min_abs_error`.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")


def check_gradients(net, ds, eps: float = 1e-6, max_rel_error: float = 1e-3,
                    min_abs_error: float = 1e-8, print_results: bool = False,
                    subset: Optional[int] = None, seed: int = 0) -> bool:
    """Central differences at every parameter (or at `subset` of them,
    drawn by `np.random.default_rng(seed)`) against the analytic
    gradient; True when every checked parameter passes."""
    net._ensure_init()
    analytic, _ = net.compute_gradient_and_score(ds)
    score_at = net.score_function(ds)
    flat0 = net.params().detach().cpu().numpy()
    n = flat0.shape[0]
    idxs = np.arange(n)
    if subset is not None and subset < n:
        idxs = np.random.default_rng(seed).choice(n, size=subset,
                                                  replace=False)
    n_fail = 0
    max_err_seen = 0.0
    with torch.no_grad():
        for i in idxs:
            basis = np.zeros(n, flat0.dtype)
            basis[i] = eps
            plus = float(score_at(torch.from_numpy(flat0 + basis)))
            minus = float(score_at(torch.from_numpy(flat0 - basis)))
            numeric = (plus - minus) / (2.0 * eps)
            a = float(analytic[i])
            denom = abs(a) + abs(numeric)
            rel = abs(a - numeric) / denom if denom > 0 else 0.0
            max_err_seen = max(max_err_seen, rel)
            if rel > max_rel_error and abs(a - numeric) > min_abs_error:
                n_fail += 1
                if print_results:
                    logger.warning("param %d FAIL: analytic=%g numeric=%g "
                                   "rel=%g", i, a, numeric, rel)
    if print_results:
        logger.info("gradient check: %d/%d failed, max rel error %g",
                    n_fail, len(idxs), max_err_seen)
    return n_fail == 0
