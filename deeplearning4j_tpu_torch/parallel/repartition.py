"""Repartitioning policy for distributed training windows: a host copy
of `deeplearning4j_tpu/parallel/repartition.py` (numpy only).

Equivalent of the reference's Spark repartition plumbing
(`spark/api/Repartition.java`, `spark/api/RepartitionStrategy.java`,
`spark/impl/common/repartition/BalancedPartitioner.java`,
`SparkUtils.repartition` called from
`ParameterAveragingTrainingMaster.doIteration:654`): decide whether the
minibatches of an averaging window should be redistributed across workers,
and if so produce partitions whose sizes differ by at most one.

Here the "RDD" is a plain list of host-side DataSets (each worker's
network moves a batch to its device when it trains on it), so
repartitioning is a cheap in-memory shuffle rather than a cluster-wide
data movement, but the policy surface is preserved so TrainingMaster
configs translate directly.
"""
from __future__ import annotations

import enum
from typing import List, Optional, Sequence, TypeVar

import numpy as np

T = TypeVar("T")


class Repartition(str, enum.Enum):
    """When to repartition (reference `spark/api/Repartition.java`)."""

    NEVER = "never"
    ALWAYS = "always"
    NUM_PARTITIONS_WORKERS_DIFFERS = "num_partitions_workers_differs"


class RepartitionStrategy(str, enum.Enum):
    """How to repartition (reference `spark/api/RepartitionStrategy.java`:
    SparkDefault vs Balanced). ROUND_ROBIN is the cheap default (keeps
    arrival order, deterministic); BALANCED additionally randomizes which
    partitions get the +1 remainder element (reference
    `BalancedPartitioner` assigns the remainder uniformly at random)."""

    ROUND_ROBIN = "round_robin"
    BALANCED = "balanced"


def should_repartition(num_items: int, num_partitions: int,
                       repartition: Repartition) -> bool:
    """Policy gate (reference `SparkUtils.repartition` switch)."""
    if repartition == Repartition.NEVER:
        return False
    if repartition == Repartition.ALWAYS:
        return True
    # NUM_PARTITIONS_WORKERS_DIFFERS: only when an even round-robin split
    # would leave partition sizes unequal
    return num_items % num_partitions != 0


def balanced_partitions(items: Sequence[T], num_partitions: int,
                        strategy: RepartitionStrategy = RepartitionStrategy.ROUND_ROBIN,
                        seed: Optional[int] = None) -> List[List[T]]:
    """Split `items` into `num_partitions` lists whose sizes differ by at
    most one (reference `BalancedPartitioner`: elementsPerPartition =
    ceil/floor split with the remainder spread one-each). Empty partitions
    are dropped, matching the reference's tolerance for short splits
    (`ParameterAveragingTrainingMaster.java:801`)."""
    if num_partitions < 1:
        raise ValueError("num_partitions must be >= 1")
    n = len(items)
    if strategy == RepartitionStrategy.ROUND_ROBIN:
        parts = [list(items[i::num_partitions]) for i in range(num_partitions)]
        return [p for p in parts if p]
    # BALANCED: contiguous floor-size chunks, remainder elements handed to a
    # random subset of partitions (reference BalancedPartitioner.getPartition
    # uniform remainder assignment)
    base, rem = divmod(n, num_partitions)
    rng = np.random.default_rng(seed)
    extra = set(rng.choice(num_partitions, size=rem, replace=False)) if rem else set()
    parts, pos = [], 0
    for p in range(num_partitions):
        size = base + (1 if p in extra else 0)
        if size:
            parts.append(list(items[pos:pos + size]))
        pos += size
    return parts
