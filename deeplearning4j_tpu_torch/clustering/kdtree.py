"""KD-tree (reference `deeplearning4j-core/.../clustering/kdtree/KDTree.java`):
host-side spatial index for exact nearest-neighbor / kNN / range queries."""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("point", "idx", "axis", "left", "right")

    def __init__(self, point, idx, axis):
        self.point = point
        self.idx = idx
        self.axis = axis
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None


class KDTree:
    def __init__(self, points: np.ndarray):
        self._points = np.asarray(points, np.float64)
        idxs = list(range(len(self._points)))
        self._root = self._build(idxs, 0)

    def _build(self, idxs: List[int], depth: int) -> Optional[_Node]:
        if not idxs:
            return None
        axis = depth % self._points.shape[1]
        idxs.sort(key=lambda i: self._points[i, axis])
        mid = len(idxs) // 2
        node = _Node(self._points[idxs[mid]], idxs[mid], axis)
        node.left = self._build(idxs[:mid], depth + 1)
        node.right = self._build(idxs[mid + 1:], depth + 1)
        return node

    def nn(self, query: np.ndarray) -> Tuple[int, float]:
        """Nearest neighbor: (index, distance)."""
        res = self.knn(query, 1)
        return res[0]

    def knn(self, query: np.ndarray, k: int) -> List[Tuple[int, float]]:
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap by -dist

        def visit(node: Optional[_Node]):
            if node is None:
                return
            d = float(np.linalg.norm(query - node.point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.idx))
            diff = query[node.axis] - node.point[node.axis]
            near, far = (node.left, node.right) if diff <= 0 else (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self._root)
        return sorted(((i, -nd) for nd, i in heap), key=lambda t: t[1])

    def range(self, lower: np.ndarray, upper: np.ndarray) -> List[int]:
        """All point indices inside the axis-aligned box [lower, upper]."""
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        out: List[int] = []

        def visit(node: Optional[_Node]):
            if node is None:
                return
            if np.all(node.point >= lower) and np.all(node.point <= upper):
                out.append(node.idx)
            if node.point[node.axis] >= lower[node.axis]:
                visit(node.left)
            if node.point[node.axis] <= upper[node.axis]:
                visit(node.right)

        visit(self._root)
        return sorted(out)
