"""Vantage-point tree (reference
`deeplearning4j-core/.../clustering/vptree/VPTree.java`): metric-space kNN
index; the reference uses it to build t-SNE's sparse input similarities."""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _VPNode:
    __slots__ = ("idx", "threshold", "inside", "outside")

    def __init__(self, idx: int):
        self.idx = idx
        self.threshold = 0.0
        self.inside: Optional["_VPNode"] = None
        self.outside: Optional["_VPNode"] = None


class VPTree:
    def __init__(self, points: np.ndarray, seed: int = 0):
        self._points = np.asarray(points, np.float64)
        self._rng = np.random.default_rng(seed)
        self._root = self._build(list(range(len(self._points))))

    def _dist(self, a: int, q: np.ndarray) -> float:
        return float(np.linalg.norm(self._points[a] - q))

    def _build(self, idxs: List[int]) -> Optional[_VPNode]:
        if not idxs:
            return None
        vp = idxs[int(self._rng.integers(0, len(idxs)))]
        rest = [i for i in idxs if i != vp]
        node = _VPNode(vp)
        if not rest:
            return node
        dists = np.linalg.norm(self._points[rest] - self._points[vp], axis=1)
        node.threshold = float(np.median(dists))
        inside = [i for i, d in zip(rest, dists) if d <= node.threshold]
        outside = [i for i, d in zip(rest, dists) if d > node.threshold]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    def knn(self, query: np.ndarray, k: int) -> List[Tuple[int, float]]:
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap by -dist
        tau = [np.inf]

        def visit(node: Optional[_VPNode]):
            if node is None:
                return
            d = self._dist(node.idx, query)
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.idx))
                tau[0] = -heap[0][0]
            if d < node.threshold:
                visit(node.inside)
                if d + tau[0] >= node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self._root)
        return sorted(((i, -nd) for nd, i in heap), key=lambda t: t[1])
