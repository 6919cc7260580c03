"""Quadtree for 2-D Barnes-Hut (reference
`deeplearning4j-core/.../clustering/quadtree/QuadTree.java`).

The reference implements quadtree (2-D) and sp-tree (n-D) as separate
classes; here QuadTree is the dim=2 specialization of SpTree — same
center-of-mass aggregation, insert/stacking semantics, and Barnes-Hut
force accumulation, with the 4-way subdivision falling out of 2^d."""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.clustering.sptree import SpTree


class QuadTree(SpTree):
    def __init__(self, center: np.ndarray, half: np.ndarray):
        center = np.asarray(center, np.float64)
        if center.shape != (2,):
            raise ValueError(f"QuadTree is 2-D; got center shape {center.shape}")
        super().__init__(center, half)

    @staticmethod
    def build(points: np.ndarray) -> "QuadTree":
        points = np.asarray(points, np.float64)
        if points.ndim != 2 or points.shape[1] != 2:
            raise ValueError(f"QuadTree needs (N, 2) points, got {points.shape}")
        lo, hi = points.min(axis=0), points.max(axis=0)
        center = (lo + hi) / 2
        half = np.maximum((hi - lo) / 2, 1e-9) * 1.0001
        tree = QuadTree(center, half)
        for p in points:
            tree.insert(p)
        return tree
