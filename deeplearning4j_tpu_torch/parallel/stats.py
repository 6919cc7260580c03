"""Per-phase training stats for distributed masters: a host copy of
`deeplearning4j_tpu/parallel/stats.py` (pure Python, copied so that the
port imports nothing of the JAX package).

Reference: `dl4j-spark/.../spark/api/stats/SparkTrainingStats.java`,
`CommonSparkTrainingStats.java`, and
`paramavg/stats/ParameterAveragingTrainingMasterStats.java` — wall-clock per
phase (split / fit / aggregate / broadcast), keyed timing lists.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List


class TrainingStats:
    """Phase wall-clock collection (ms per occurrence) plus named event
    counters (worker failures / retries / drops / restarts — the elastic
    layer's observability surface; the reference's stats classes only track
    timings because Spark owns its retry bookkeeping)."""

    def __init__(self) -> None:
        self._times: Dict[str, List[float]] = defaultdict(list)
        self._counters: Dict[str, int] = defaultdict(int)

    def add_time(self, phase: str, ms: float) -> None:
        self._times[phase].append(ms)

    def timer(self, phase: str) -> "_PhaseTimer":
        return _PhaseTimer(self, phase)

    def increment(self, counter: str, by: int = 1) -> None:
        self._counters[counter] += by

    def get_count(self, counter: str) -> int:
        return self._counters.get(counter, 0)

    def get_counters(self) -> Dict[str, int]:
        return dict(self._counters)

    def get_keys(self) -> List[str]:
        return sorted(self._times)

    def get_value(self, phase: str) -> List[float]:
        return list(self._times.get(phase, []))

    def total_ms(self, phase: str) -> float:
        return float(sum(self._times.get(phase, [])))

    def summary(self) -> str:
        lines = ["TrainingStats:"]
        for k in self.get_keys():
            v = self._times[k]
            lines.append(f"  {k}: n={len(v)} total={sum(v):.1f}ms "
                         f"mean={sum(v) / len(v):.2f}ms")
        for k in sorted(self._counters):
            lines.append(f"  {k}: count={self._counters[k]}")
        return "\n".join(lines)


class _PhaseTimer:
    def __init__(self, stats: TrainingStats, phase: str):
        self._stats = stats
        self._phase = phase

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._stats.add_time(self._phase,
                             (time.perf_counter() - self._t0) * 1e3)
        return False
