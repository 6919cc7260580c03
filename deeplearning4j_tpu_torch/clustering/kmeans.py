"""K-means (reference `deeplearning4j-core/.../clustering/kmeans/
KMeansClustering.java` + the `clustering/algorithm/BaseClusteringAlgorithm`
iteration loop).

Counterpart of `deeplearning4j_tpu/clustering/kmeans.py`. Each Lloyd
iteration is a handful of torch ops on the data's device: the N×K distance
matrix from one product, an argmin, and the centroid update as the
reference's one-hot product `onehot.T @ X` (a deterministic segment sum:
same-seed fits on the card give the same labels and centroids, which
`index_add_`'s atomics would not). The products run in full f32 whatever
the process-wide TF32 setting says (`full_f32`). k-means++ seeding runs on
the host from `np.random.default_rng(seed)`, as in the JAX package, so
both packages start from the same centroids."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device


@contextmanager
def full_f32():
    """Matrix products in full f32 inside the block (TF32 off for cuBLAS,
    as the reference's `Precision.HIGHEST`), the caller's setting after
    it."""
    m = torch.backends.cuda.matmul
    was = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = was


def _lloyd_step(X: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd iteration: (new centroids, assignments, cost), the
    assignments and cost measured against the INPUT centroids."""
    with full_f32():
        # |x-c|² = |x|² - 2 x·c + |c|²; the cross term is one product
        x2 = torch.sum(X * X, dim=1, keepdim=True)
        c2 = torch.sum(centroids * centroids, dim=1)
        d2 = x2 - 2.0 * (X @ centroids.T) + c2              # (N, K)
        assign = torch.argmin(d2, dim=1)                     # (N,)
        onehot = torch.nn.functional.one_hot(
            assign, centroids.shape[0]).to(X.dtype)          # (N, K)
        counts = torch.sum(onehot, dim=0)                    # (K,)
        sums = onehot.T @ X                                  # (K, D)
    new_c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts[:, None], min=1.0),
                        centroids)
    cost = torch.sum(torch.min(d2, dim=1).values)
    return new_c, assign, cost


class KMeansClustering:
    """`device`: where the Lloyd iterations run (the card unless the
    caller asks for the CPU); seeding, `predict` and the stored
    `centroids` / `labels_` are host numpy, as in the reference."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-4,
                 init: str = "kmeans++", seed: int = 0, device="cuda"):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.init = init
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.cost: float = float("inf")

    # -- seeding ------------------------------------------------------------
    def _seed_centroids(self, X: np.ndarray) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        n = X.shape[0]
        if self.init == "random":
            return X[rng.choice(n, self.k, replace=False)].copy()
        # k-means++
        cents = [X[int(rng.integers(0, n))]]
        d2 = np.full(n, np.inf)
        for _ in range(1, self.k):
            d2 = np.minimum(d2, np.sum((X - cents[-1]) ** 2, axis=1))
            p = d2 / d2.sum()
            cents.append(X[int(rng.choice(n, p=p))])
        return np.stack(cents)

    # -- API ----------------------------------------------------------------
    def fit(self, X) -> "KMeansClustering":
        """`X`: (N, D) numpy or a tensor (on any device: it is brought to
        the host for the seeding, and the iterations run on `device`)."""
        if isinstance(X, torch.Tensor):
            X = X.detach().float().cpu().numpy()
        X = np.asarray(X, np.float32)
        if X.shape[0] < self.k:
            raise ValueError(f"need at least k={self.k} points, got {X.shape[0]}")
        Xd = torch.from_numpy(X).to(self.device)
        c = torch.from_numpy(self._seed_centroids(X)).to(self.device)
        prev_cost = np.inf
        self.n_iter_ = 0
        for _ in range(self.max_iterations):
            c, assign, cost = _lloyd_step(Xd, c)
            self.n_iter_ += 1
            cost = float(cost)
            if abs(prev_cost - cost) <= self.tol * max(abs(prev_cost), 1.0):
                break
            prev_cost = cost
        # _lloyd_step's assign/cost are measured against its INPUT centroids;
        # one final evaluation makes labels_/cost consistent with the stored
        # (post-update) centroids
        self.centroids = c.cpu().numpy()
        _, assign, cost = _lloyd_step(Xd, c)
        self.cost = float(cost)
        self._assign = assign.cpu().numpy()
        return self

    def predict(self, X) -> np.ndarray:
        assert self.centroids is not None, "call fit() first"
        if isinstance(X, torch.Tensor):
            X = X.detach().float().cpu().numpy()
        X = np.asarray(X, np.float32)
        d2 = (np.sum(X * X, axis=1, keepdims=True)
              - 2.0 * X @ self.centroids.T
              + np.sum(self.centroids ** 2, axis=1))
        return np.argmin(d2, axis=1)

    @property
    def labels_(self) -> np.ndarray:
        return self._assign
