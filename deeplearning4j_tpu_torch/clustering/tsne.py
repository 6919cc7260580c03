"""t-SNE (reference `deeplearning4j-core/.../plot/Tsne.java` +
`plot/BarnesHutTsne.java` 848 LoC).

Counterpart of `deeplearning4j_tpu/clustering/tsne.py`. Two
implementations, mirroring the reference pair:

- `Tsne` — EXACT t-SNE whose per-iteration O(N²) work (pairwise
  student-t affinities + gradient) is a few torch ops on the card, the
  Gram matrix one product in full f32; at N=10⁴ an iteration is
  milliseconds, which is why it is the default here even though the
  reference treats exact as the slow legacy path. The perplexity search
  (`_binary_search_sigmas`) stays host numpy, as in the JAX package.
- `BarnesHutTsne` — the θ-approximate host algorithm (VP-tree sparse input
  similarities + SpTree repulsion), f64 numpy on the host, kept for CPU
  parity and very large N.

Feature parity vs `BarnesHutTsne.java` (builder fields at :96-116):

| reference knob               | here                                      |
|------------------------------|-------------------------------------------|
| theta                        | `BarnesHutTsne(theta=)`                   |
| perplexity                   | `perplexity=`                             |
| learningRate                 | `learning_rate=`                          |
| maxIter                      | `n_iter=`                                 |
| initialMomentum/finalMomentum| `initial_momentum=` / `final_momentum=`   |
| switchMomentumIteration :71  | `switch_momentum_iteration=`              |
| stopLyingIteration :74       | `stop_lying_iteration=` (early exag off)  |
| minGain :69                  | `min_gain=`                               |
| normalize :72                | `normalize=` (zero-mean / max-abs scale)  |
| IterationListener :95        | `listeners=` + per-iteration KL reporting |
| error reporting (logs)       | `error_every=`, `error_history_`, logger  |
| realMin                      | the 1e-12 clamps (fixed)                  |
| similarityFunction/invert    | not carried: input P is always the        |
|                              | Gaussian-perplexity kernel (the only mode |
|                              | the reference's fit path exercises)       |
| usePca / tolerance           | out of scope: pre-reduce with your own    |
|                              | PCA; the sigma search tol is `1e-5` fixed |
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.kmeans import full_f32
from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device

logger = logging.getLogger("deeplearning4j_tpu_torch")


# ---------------------------------------------------------------- shared: P

def _binary_search_sigmas(D2: np.ndarray, perplexity: float,
                          tol: float = 1e-5, max_iter: int = 50) -> np.ndarray:
    """Per-point precision (beta) search so that H(P_i) = log(perplexity)
    (the same search as `Tsne.java` hBeta loop). D2: (N, M) squared
    distances to each point's candidate neighbors (self excluded)."""
    n = D2.shape[0]
    target = np.log(perplexity)
    betas = np.ones(n)
    P = np.zeros_like(D2)
    for i in range(n):
        lo, hi = -np.inf, np.inf
        beta = 1.0
        d = D2[i]
        for _ in range(max_iter):
            p = np.exp(-d * beta)
            s = p.sum()
            if s <= 0:
                H, p = 0.0, np.zeros_like(p)
            else:
                # d may contain inf (masked self-distance) where p == 0;
                # inf·0 must count as 0 in the entropy sum
                with np.errstate(invalid="ignore"):
                    dp = np.where(p > 0, d * p, 0.0)
                H = np.log(s) + beta * dp.sum() / s
                p = p / s
            if abs(H - target) < tol:
                break
            if H > target:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == -np.inf else (beta + lo) / 2
        P[i] = p
        betas[i] = beta
    return P


# ------------------------------------------------------------ exact/device

def _affinities(Y: torch.Tensor) -> torch.Tensor:
    """The student-t numerators 1 / (1 + |yi - yj|²) with the diagonal
    zeroed, (N, N). The Gram product runs in full f32 (`full_f32`): as the
    reference's comment on `Precision.HIGHEST` records, a reduced-precision
    product (TF32 on the card) feeds the cancellation-prone expansion of
    |yi - yj|² enough noise to destabilize the gradient late in training."""
    y2 = torch.sum(Y * Y, dim=1)
    with full_f32():
        num = torch.mm(Y, Y.T)
    # d2 = y2[:, None] - 2 yyt + y2[None, :], then 1 / (1 + d2), in place
    num.mul_(-2.0).add_(y2[:, None]).add_(y2[None, :])
    num.add_(1.0).reciprocal_()
    num.fill_diagonal_(0.0)
    return num


def _tsne_step(Y, velocity, gains, P, momentum, lr, min_gain):
    """One exact t-SNE update on Y's device: (Y, velocity, gains)."""
    num = _affinities(Y)
    Q = num / torch.clamp(torch.sum(num), min=1e-12)
    PQ = torch.sub(P, Q.clamp_(min=1e-12), out=Q).mul_(num)   # (N, N)
    del num
    # (diag(rowsum(PQ)) - PQ) @ Y without the N×N diagonal
    with full_f32():
        grad = 4.0 * (torch.sum(PQ, dim=1, keepdim=True) * Y - PQ @ Y)
    del PQ, Q
    same_sign = (grad * velocity) > 0
    gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                        min=min_gain)
    velocity = momentum * velocity - lr * gains * grad
    Y = Y + velocity
    Y = Y - torch.mean(Y, dim=0)
    return Y, velocity, gains


def _tsne_kl(Y, P) -> torch.Tensor:
    """KL(P || Q) at the CURRENT positions with the UNEXAGGERATED P —
    what reports and `kl_divergence_` must describe (the lying-phase
    objective and pre-update positions would both misstate the returned
    embedding's quality). A device scalar."""
    num = _affinities(Y)
    Q = num.div_(torch.clamp(torch.sum(num), min=1e-12)).clamp_(min=1e-12)
    return torch.sum(P * torch.log(torch.clamp(P, min=1e-12).div_(Q)))


class Tsne:
    """Exact t-SNE. Knob names mirror the reference builder (see module
    docstring parity table). `listeners`: callables
    `f(model, iteration, kl)` invoked every `error_every` iterations with
    the CURRENT KL divergence (the reference's IterationListener +
    per-iteration error log, `BarnesHutTsne.java:95/:464`); the reported
    KLs also accumulate in `error_history_`. `device`: where the
    iterations run (the card unless the caller asks for the CPU); the
    perplexity search runs on the host."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 1000,
                 early_exaggeration: float = 12.0, seed: int = 0,
                 initial_momentum: float = 0.5,
                 final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 stop_lying_iteration: Optional[int] = None,
                 min_gain: float = 0.01,
                 normalize: bool = False,
                 error_every: int = 50,
                 listeners: Sequence[Callable] = (),
                 device="cuda"):
        self.device = resolve_device(device)
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.early_exaggeration = early_exaggeration
        self.seed = seed
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.min_gain = min_gain
        self.normalize = normalize
        self.error_every = max(1, error_every)
        self.listeners: List[Callable] = list(listeners)
        self.kl_divergence_: float = float("nan")
        self.error_history_: List[float] = []

    # shared schedule/reporting helpers ----------------------------------
    def _stop_lying(self) -> int:
        if self.stop_lying_iteration is not None:
            return self.stop_lying_iteration
        return min(250, self.n_iter // 4)

    def _momentum(self, it: int) -> float:
        return (self.initial_momentum
                if it < self.switch_momentum_iteration
                else self.final_momentum)

    def _normalize_input(self, X: np.ndarray) -> np.ndarray:
        """Reference `normalize` flag: zero-mean, max-abs scale."""
        if not self.normalize:
            return X
        X = X - X.mean(axis=0)
        return X / max(np.abs(X).max(), 1e-12)

    def _report(self, it: int, kl: float) -> None:
        self.error_history_.append(kl)
        logger.info("t-SNE iteration %d: KL = %.6f", it, kl)
        for listener in self.listeners:
            listener(self, it, kl)

    def _input_probabilities(self, X: np.ndarray) -> np.ndarray:
        x2 = np.sum(X * X, axis=1)
        D2 = np.maximum(x2[:, None] - 2.0 * X @ X.T + x2[None, :], 0.0)
        np.fill_diagonal(D2, np.inf)  # exclude self
        P = _binary_search_sigmas(D2, self.perplexity)
        P = P + P.T
        return P / np.maximum(P.sum(), 1e-12)

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        """The embedding (N, n_components) as host numpy; the iterations
        run on `device`, the perplexity search on the host."""
        X = self._normalize_input(np.asarray(X, np.float32))
        n = X.shape[0]
        P = self._input_probabilities(X).astype(np.float32)
        rng = np.random.default_rng(self.seed)
        Y = torch.from_numpy(rng.normal(scale=1e-4, size=(
            n, self.n_components)).astype(np.float32)).to(self.device)
        vel = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        Pd = torch.from_numpy(P).to(self.device)
        stop_exag = self._stop_lying()
        # the lying phase's P, made once (the same values as P * exag at
        # every iteration) and freed when the phase ends
        Pe = Pd * self.early_exaggeration if stop_exag > 0 else None
        self.error_history_ = []
        for it in range(self.n_iter):
            if it == stop_exag:
                Pe = None
            Y, vel, gains = _tsne_step(
                Y, vel, gains, Pe if it < stop_exag else Pd,
                self._momentum(it), self.learning_rate, self.min_gain)
            if (it + 1) % self.error_every == 0 or it == self.n_iter - 1:
                # post-update KL with the unexaggerated P, read only at
                # report boundaries (a read every iteration would wait
                # for the device every iteration)
                self._report(it + 1, float(_tsne_kl(Y, Pd)))
        self.kl_divergence_ = (self.error_history_[-1]
                               if self.error_history_ else float("nan"))
        return Y.cpu().numpy()


# ------------------------------------------------------------- Barnes-Hut

class BarnesHutTsne(Tsne):
    """θ-approximate t-SNE (reference `plot/BarnesHutTsne.java`): sparse
    kNN input similarities (VP-tree, 3·perplexity neighbors) + SpTree
    repulsion. It runs on the host, in f64 numpy, as the reference's
    algorithm does, and takes no `device`: `Tsne` is the card's path.
    Shares every schedule / reporting / normalization knob with `Tsne`
    (parity table in the module docstring)."""

    def __init__(self, theta: float = 0.5, **kwargs):
        super().__init__(**kwargs, device="cpu")
        self.theta = theta

    def _kl_given_z(self, Y, Z, rows_u, cols_u, Pv) -> float:
        """KL on the sparse support given an already-computed Barnes-Hut
        normalizer Z for these positions."""
        diff = Y[rows_u] - Y[cols_u]
        qn = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
        Q = qn / max(Z, 1e-12)
        return float(np.sum(
            Pv * np.log(np.maximum(Pv, 1e-12) / np.maximum(Q, 1e-12))))

    def _sparse_kl(self, Y, rows_u, cols_u, Pv) -> float:
        """KL at the CURRENT positions, with its own repulsion pass (used
        only where no force pass follows — the final iteration)."""
        sp = SpTree.build(Y)
        Z = 0.0
        for i in range(Y.shape[0]):
            Z += sp.compute_non_edge_forces(Y[i], self.theta,
                                            np.zeros(self.n_components))
        return self._kl_given_z(Y, Z, rows_u, cols_u, Pv)

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        X = self._normalize_input(np.asarray(X, np.float64))
        n = X.shape[0]
        k = min(n - 1, int(3 * self.perplexity))
        tree = VPTree(X)
        nbr_idx = np.zeros((n, k), np.int64)
        nbr_d2 = np.zeros((n, k))
        for i in range(n):
            res = tree.knn(X[i], k + 1)          # includes self at d=0
            res = [(j, d) for j, d in res if j != i][:k]
            nbr_idx[i] = [j for j, _ in res]
            nbr_d2[i] = [d * d for _, d in res]
        cond = _binary_search_sigmas(nbr_d2, min(self.perplexity, k / 3.0))
        # symmetrized sparse P as a dict-of-rows dense matrix is avoided:
        # accumulate COO triplets
        rows = np.repeat(np.arange(n), k)
        cols = nbr_idx.reshape(-1)
        vals = cond.reshape(-1)
        # symmetrize: P_ij = (P_j|i + P_i|j) / 2N — merge duplicates
        all_rows = np.concatenate([rows, cols])
        all_cols = np.concatenate([cols, rows])
        all_vals = np.concatenate([vals, vals])
        key = all_rows * n + all_cols
        order = np.argsort(key)
        key, all_rows, all_cols, all_vals = (key[order], all_rows[order],
                                             all_cols[order], all_vals[order])
        uniq, starts = np.unique(key, return_index=True)
        merged = np.add.reduceat(all_vals, starts)
        rows_u, cols_u = uniq // n, uniq % n
        Psum = merged.sum()
        Pv = merged / max(Psum, 1e-12)

        rng = np.random.default_rng(self.seed)
        Y = rng.normal(scale=1e-4, size=(n, self.n_components))
        vel = np.zeros_like(Y)
        gains = np.ones_like(Y)
        stop_exag = self._stop_lying()
        self.error_history_ = []
        pending_report: Optional[int] = None
        for it in range(self.n_iter):
            exag = self.early_exaggeration if it < stop_exag else 1.0
            momentum = self._momentum(it)
            # attractive forces (sparse)
            diff = Y[rows_u] - Y[cols_u]
            q = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            attr = np.zeros_like(Y)
            w = (exag * Pv * q)[:, None] * diff
            np.add.at(attr, rows_u, w)
            # repulsive forces (Barnes-Hut)
            sp = SpTree.build(Y)
            rep = np.zeros_like(Y)
            Z = 0.0
            for i in range(n):
                negf = np.zeros(self.n_components)
                Z += sp.compute_non_edge_forces(Y[i], self.theta, negf)
                rep[i] = negf
            if pending_report is not None:
                # a report fell due after the PREVIOUS update; this force
                # pass just computed Z for exactly those positions, so the
                # report reuses it instead of paying a second O(N log N)
                # repulsion sweep
                self._report(pending_report,
                             self._kl_given_z(Y, Z, rows_u, cols_u, Pv))
                pending_report = None
            grad = 4.0 * (attr - rep / max(Z, 1e-12))
            same_sign = (grad * vel) > 0
            gains = np.clip(np.where(same_sign, gains * 0.8, gains + 0.2),
                            self.min_gain, None)
            vel = momentum * vel - self.learning_rate * gains * grad
            Y = Y + vel
            Y = Y - Y.mean(axis=0)
            if (it + 1) % self.error_every == 0 or it == self.n_iter - 1:
                pending_report = it + 1
        if pending_report is not None:
            # final-iteration report: no force pass follows, recompute
            # the normalizer at the final positions (the reference does
            # the same for its terminal error)
            self._report(pending_report,
                         self._sparse_kl(Y, rows_u, cols_u, Pv))
        self.kl_divergence_ = (self.error_history_[-1]
                               if self.error_history_ else float("nan"))
        return Y
