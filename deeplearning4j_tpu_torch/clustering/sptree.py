"""SPTree: n-dimensional Barnes-Hut tree (reference
`deeplearning4j-core/.../clustering/sptree/SpTree.java`): generalization of
the quadtree to 2^d children; used by Barnes-Hut t-SNE gradients."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class SpTree:
    def __init__(self, center: np.ndarray, half: np.ndarray):
        self.center = np.asarray(center, np.float64)
        self.half = np.asarray(half, np.float64)
        self.dim = len(self.center)
        self.n_points = 0
        self.com = np.zeros(self.dim)
        self._point: Optional[np.ndarray] = None
        self._point_count = 0  # stacked duplicates resident on this leaf
        self._children: Optional[List["SpTree"]] = None

    @staticmethod
    def build(points: np.ndarray) -> "SpTree":
        points = np.asarray(points, np.float64)
        lo, hi = points.min(axis=0), points.max(axis=0)
        center = (lo + hi) / 2
        half = np.maximum((hi - lo) / 2, 1e-9) * 1.0001
        tree = SpTree(center, half)
        for p in points:
            tree.insert(p)
        return tree

    def contains(self, p: np.ndarray) -> bool:
        return bool(np.all(np.abs(p - self.center) <= self.half + 1e-12))

    def insert(self, p: np.ndarray) -> bool:
        if not self.contains(p):
            return False
        self.com = (self.com * self.n_points + p) / (self.n_points + 1)
        self.n_points += 1
        if self._children is None:
            if self._point is None:
                self._point = p.copy()
                self._point_count = 1
                return True
            # duplicate points stack on the leaf without subdividing forever
            if np.allclose(self._point, p):
                self._point_count += 1
                return True
            self._subdivide()
            moved, count = self._point, self._point_count
            self._point, self._point_count = None, 0
            for _ in range(count):  # move ALL stacked copies down
                for c in self._children:
                    if c.insert(moved):
                        break
        for c in self._children:
            if c.insert(p):
                return True
        return False  # numerically outside all children (shouldn't happen)

    def _subdivide(self) -> None:
        h = self.half / 2
        self._children = []
        for m in range(2 ** self.dim):
            offs = np.array([(1 if (m >> b) & 1 else -1) for b in range(self.dim)])
            self._children.append(SpTree(self.center + offs * h, h))

    def compute_non_edge_forces(self, p: np.ndarray, theta: float,
                                neg: np.ndarray) -> float:
        """t-SNE repulsion via Barnes-Hut: returns partial Z sum, adds the
        force into `neg`."""
        if self.n_points == 0:
            return 0.0
        diff = p - self.com
        d2 = float(diff @ diff)
        width = float(np.max(self.half) * 2)
        if self._children is None or (d2 > 0 and width * width / d2 < theta * theta):
            if d2 == 0.0:
                return 0.0
            q = 1.0 / (1.0 + d2)
            mult = self.n_points * q
            neg += mult * q * diff
            return mult
        return sum(c.compute_non_edge_forces(p, theta, neg)
                   for c in self._children)
