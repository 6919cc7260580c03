"""Berkeley-NLP-style utility collection.

Reference: `deeplearning4j-nn/.../berkeley/` (SURVEY §2.1 "berkeley utils",
4,484 LoC vendored from the Berkeley NLP parser): `Counter`, `CounterMap`,
`PriorityQueue`, `Pair`, `SloppyMath`. Python's stdlib covers much of this;
what remains are the exact APIs the NLP stack leans on — kept as thin,
typed wrappers so call sites read like the reference. Host code, a copy of
`deeplearning4j_tpu/util/berkeley.py`.
"""
from __future__ import annotations

import heapq
import math
from collections import defaultdict
from typing import Dict, Generic, Iterator, List, Optional, Tuple, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class Counter(Generic[K], Dict[K, float]):
    """Map key → float count with argmax/normalize (reference
    `berkeley/Counter.java`)."""

    def increment_count(self, key: K, by: float = 1.0) -> None:
        self[key] = self.get(key, 0.0) + by

    def get_count(self, key: K) -> float:
        return self.get(key, 0.0)

    def total_count(self) -> float:
        return float(sum(self.values()))

    def arg_max(self) -> Optional[K]:
        return max(self, key=self.get) if self else None

    def max_count(self) -> float:
        return max(self.values()) if self else 0.0

    def normalize(self) -> None:
        total = self.total_count()
        if total == 0.0:
            return
        for k in self:
            self[k] /= total

    def sorted_keys(self) -> List[K]:
        """Keys by descending count."""
        return sorted(self, key=self.get, reverse=True)


class CounterMap(Generic[K, V]):
    """Two-level counter: key → (key2 → count) (reference
    `berkeley/CounterMap.java`)."""

    def __init__(self):
        self._map: Dict[K, Counter[V]] = defaultdict(Counter)

    def increment_count(self, key: K, key2: V, by: float = 1.0) -> None:
        self._map[key].increment_count(key2, by)

    def get_count(self, key: K, key2: V) -> float:
        return self._map[key].get_count(key2) if key in self._map else 0.0

    def get_counter(self, key: K) -> Counter[V]:
        return self._map[key]

    def keys(self):
        return self._map.keys()

    def total_count(self) -> float:
        return float(sum(c.total_count() for c in self._map.values()))

    def total_size(self) -> int:
        return sum(len(c) for c in self._map.values())

    def __contains__(self, key: K) -> bool:
        return key in self._map

    def __len__(self) -> int:
        return len(self._map)


class PriorityQueue(Generic[V]):
    """Max-priority queue with peek (reference `berkeley/PriorityQueue.java`
    — iteration order is descending priority)."""

    def __init__(self):
        self._heap: List[Tuple[float, int, V]] = []
        self._tie = 0

    def put(self, item: V, priority: float) -> None:
        # negate for max-heap; tie-breaker keeps insertion order stable
        heapq.heappush(self._heap, (-priority, self._tie, item))
        self._tie += 1

    def peek(self) -> V:
        if not self._heap:
            raise IndexError("peek on empty PriorityQueue")
        return self._heap[0][2]

    def get_priority(self) -> float:
        if not self._heap:
            raise IndexError("get_priority on empty PriorityQueue")
        return -self._heap[0][0]

    def next(self) -> V:
        if not self._heap:
            raise IndexError("next on empty PriorityQueue")
        return heapq.heappop(self._heap)[2]

    def is_empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)

    def __iter__(self) -> Iterator[V]:
        while self._heap:
            yield self.next()


class SloppyMath:
    """Numerically-forgiving math helpers (reference
    `berkeley/SloppyMath.java`)."""

    LOG_TOLERANCE = 30.0

    @staticmethod
    def log_add(log_x: float, log_y: float) -> float:
        """log(exp(x) + exp(y)) without overflow."""
        if log_x == -math.inf:
            return log_y
        if log_y == -math.inf:
            return log_x
        hi, lo = (log_x, log_y) if log_x >= log_y else (log_y, log_x)
        if hi - lo > SloppyMath.LOG_TOLERANCE:
            return hi
        return hi + math.log1p(math.exp(lo - hi))

    @staticmethod
    def log_subtract(log_x: float, log_y: float) -> float:
        """log(exp(x) - exp(y)); requires x >= y."""
        if log_y == -math.inf:
            return log_x
        if log_y > log_x:
            raise ValueError("log_subtract requires log_x >= log_y")
        if log_x == log_y:
            return -math.inf
        return log_x + math.log1p(-math.exp(log_y - log_x))

    @staticmethod
    def sigmoid(x: float) -> float:
        if x >= 0:
            return 1.0 / (1.0 + math.exp(-x))
        e = math.exp(x)
        return e / (1.0 + e)


Pair = Tuple  # reference `berkeley/Pair.java` — a plain tuple in Python
