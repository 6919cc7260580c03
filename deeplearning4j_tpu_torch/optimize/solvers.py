"""Solvers beyond plain SGD: line search, conjugate gradient and LBFGS
(counterpart of `deeplearning4j_tpu/optimize/solvers.py`).

Reference: `optimize/Solver.java:41` (dispatch by `OptimizationAlgorithm`,
lines 58-68), `ConjugateGradient.java`, `LBFGS.java`,
`LineGradientDescent.java`, `BackTrackLineSearch.java`.

The loss of the fixed batch is a function of the network's flat
parameter vector, in the order of `params()` (layer order, then sorted
parameter names, each tensor in C order), unravelled by
`MultiLayerNetwork._unravel` into views, so autograd gives the flat
gradient; value-only calls run under `torch.no_grad()` (on the card the
LSTM forward then runs without its training stash). The scalar
bookkeeping (Armijo backtracking, the CG beta, the LBFGS two-loop over an
m-deep history) runs on the host between device calls, each `float()` a
device sync, as in the JAX package.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    OptimizationAlgorithm,
)

log = logging.getLogger(__name__)


def backtrack_line_search(
    f: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    direction: torch.Tensor,
    value0: float,
    grad0: torch.Tensor,
    max_iterations: int = 5,
    initial_step: float = 1.0,
    c1: float = 1e-4,
    rho: float = 0.5,
) -> Tuple[float, float]:
    """Armijo backtracking: shrink the step until
    f(x + a d) <= f(x) + c1 a g.d. Returns (step, new value); step 0.0
    when no decrease was found."""
    slope = float(grad0 @ direction)
    if not np.isfinite(slope) or not np.isfinite(value0):
        # a NaN/Inf slope or score fails every Armijo comparison; refuse
        # the step instead of returning the blown-up value
        log.warning("line search: non-finite slope/value (slope=%s, "
                    "value0=%s); rejecting step", slope, value0)
        return 0.0, value0
    if slope >= 0:
        log.debug("line search: non-descent direction (slope=%g)", slope)
        return 0.0, value0
    alpha = initial_step
    for _ in range(max_iterations):
        v = float(f(x + alpha * direction))
        if np.isfinite(v) and v <= value0 + c1 * alpha * slope:
            return alpha, v
        alpha *= rho
    return 0.0, value0


def _norm(g: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(g))


class Solver:
    """Per-minibatch optimizer dispatch for the line-search family
    (SGD has the network's own training step)."""

    def __init__(self, net):
        self.net = net
        self.algo = net.conf.global_conf.optimization_algo
        self.max_ls = net.conf.global_conf.max_num_line_search_iterations
        self.last_commit_rejected = False

    def _closures(self, ds):
        """(value_and_grad, value) of the flat parameter vector on this
        batch, without dropout."""
        net = self.net
        feats, labels, fm, lm = net._batch_arrays(ds)
        lstate = net._layer_state

        def loss_at(flat):
            return net._loss_pure(net._unravel(flat), feats, labels, fm, lm,
                                  None, True, lstate)[0]

        def vg(x):
            leaf = x.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = loss_at(leaf)
                g, = torch.autograd.grad(loss, leaf)
            return loss.detach(), g

        def f(x):
            with torch.no_grad():
                return loss_at(x)

        return vg, f

    def optimize(self, ds, iterations: Optional[int] = None) -> float:
        """Run `iterations` optimizer steps on this batch; updates the
        network's parameters and returns the final score."""
        net = self.net
        iterations = iterations if iterations is not None else \
            net.conf.global_conf.iterations
        vg, f = self._closures(ds)
        x = net.params().detach()
        if self.algo == OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            lr = net.conf.global_conf.learning_rate
            v = None
            for _ in range(iterations):
                v, g = vg(x)
                x = x - lr * g
            final = float(v) if v is not None else float(f(x))
            self._commit(x, final)
            return final
        if self.algo == OptimizationAlgorithm.LINE_GRADIENT_DESCENT:
            return self._line_gd(vg, f, x, iterations)
        if self.algo == OptimizationAlgorithm.CONJUGATE_GRADIENT:
            return self._cg(vg, f, x, iterations)
        if self.algo == OptimizationAlgorithm.LBFGS:
            return self._lbfgs(vg, f, x, iterations)
        raise ValueError(f"unknown optimization algorithm {self.algo}")

    # -- steepest descent + line search ------------------------------------
    def _line_gd(self, vg, f, x, iterations) -> float:
        """d = -g, Armijo step (reference `LineGradientDescent.java`)."""
        v, g = vg(x)
        v = float(v)
        for _ in range(iterations):
            d = -g
            step0 = 1.0 / max(1.0, _norm(g))
            alpha, _ = backtrack_line_search(f, x, d, v, g, self.max_ls,
                                             initial_step=step0)
            if alpha == 0.0:
                break
            x = x + alpha * d
            v, g = vg(x)
            v = float(v)
        self._commit(x, v)
        return v

    # -- nonlinear conjugate gradient --------------------------------------
    def _cg(self, vg, f, x, iterations) -> float:
        """Polak-Ribiere+ CG with restarts (reference
        `ConjugateGradient.java`)."""
        v, g = vg(x)
        v = float(v)
        d = -g
        for _ in range(iterations):
            step0 = 1.0 / max(1.0, _norm(g))
            alpha, _ = backtrack_line_search(f, x, d, v, g, self.max_ls,
                                             initial_step=step0)
            if alpha == 0.0:
                # restart along steepest descent; stop if that fails too
                d = -g
                alpha, _ = backtrack_line_search(f, x, d, v, g, self.max_ls,
                                                 initial_step=step0)
                if alpha == 0.0:
                    break
            x_new = x + alpha * d
            v_new, g_new = vg(x_new)
            v_new = float(v_new)
            denom = float(g @ g)
            beta = max(0.0, float(g_new @ (g_new - g)) / max(denom, 1e-30))
            d = -g_new + beta * d
            x, v, g = x_new, v_new, g_new
        self._commit(x, v)
        return v

    # -- LBFGS --------------------------------------------------------------
    def _lbfgs(self, vg, f, x, iterations, m: int = 10) -> float:
        """Two-loop-recursion LBFGS with m (s, y) pairs (reference
        `LBFGS.java`)."""
        v, g = vg(x)
        v = float(v)
        s_hist: List[torch.Tensor] = []
        y_hist: List[torch.Tensor] = []
        for _ in range(iterations):
            d = -self._lbfgs_direction(g, s_hist, y_hist)
            alpha, _ = backtrack_line_search(f, x, d, v, g, self.max_ls,
                                             initial_step=1.0)
            if alpha == 0.0:
                # steepest descent once, else stop
                d = -g
                step0 = 1.0 / max(1.0, _norm(g))
                alpha, _ = backtrack_line_search(f, x, d, v, g, self.max_ls,
                                                 initial_step=step0)
                if alpha == 0.0:
                    break
                s_hist.clear()
                y_hist.clear()
            x_new = x + alpha * d
            v_new, g_new = vg(x_new)
            v_new = float(v_new)
            s, y = x_new - x, g_new - g
            if float(s @ y) > 1e-10:  # curvature condition
                s_hist.append(s)
                y_hist.append(y)
                if len(s_hist) > m:
                    s_hist.pop(0)
                    y_hist.pop(0)
            x, v, g = x_new, v_new, g_new
        self._commit(x, v)
        return v

    @staticmethod
    def _lbfgs_direction(g, s_hist, y_hist):
        q = g
        alphas = []
        for s, y in zip(reversed(s_hist), reversed(y_hist)):
            rho_i = 1.0 / float(y @ s)
            a = rho_i * float(s @ q)
            alphas.append((a, rho_i))
            q = q - a * y
        if s_hist:
            s, y = s_hist[-1], y_hist[-1]
            gamma = float(s @ y) / max(float(y @ y), 1e-30)
            q = gamma * q
        for (a, rho_i), s, y in zip(reversed(alphas), s_hist, y_hist):
            b = rho_i * float(y @ q)
            q = q + (a - b) * s
        return q

    def _commit(self, x, v) -> bool:
        """Publish the candidate parameters and score to the network,
        unless either is non-finite: the previous parameters and score
        stay, and `last_commit_rejected` (read by an attached health
        sentinel as a skipped step) says so."""
        finite_score = v is not None and np.isfinite(v)
        finite_params = bool(torch.isfinite(x).all())
        if not (finite_score and finite_params):
            self.last_commit_rejected = True
            log.warning(
                "solver: rejecting non-finite candidate (score=%s, "
                "params finite=%s); keeping previous parameters", v,
                finite_params)
            return False
        self.net.set_params(x)
        self.net.score_value = v
        return True
