"""Random-walk generators (reference
`deeplearning4j-graph/.../iterator/RandomWalkIterator.java`,
`WeightedRandomWalkIterator.java`): fixed-length vertex-sequence streams
feeding DeepWalk's skip-gram."""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph


class NoEdges:
    """Walk-termination modes (reference `iterator/NoEdgeHandling.java`)."""

    SELF_LOOP = "self_loop"
    EXCEPTION = "exception"


class RandomWalkIterator:
    """Uniform random walks of fixed length, one starting at every vertex
    (reference `RandomWalkIterator.java`)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 123,
                 no_edge_handling: str = NoEdges.SELF_LOOP):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling

    def _next_vertex(self, rng: np.random.Generator, cur: int) -> int:
        nbrs = self.graph.get_connected_vertices(cur)
        if not nbrs:
            if self.no_edge_handling == NoEdges.EXCEPTION:
                raise ValueError(f"vertex {cur} has no outgoing edges")
            return cur
        return nbrs[int(rng.integers(0, len(nbrs)))]

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        order = rng.permutation(self.graph.num_vertices())
        for start in order:
            walk = [int(start)]
            while len(walk) < self.walk_length:
                walk.append(self._next_vertex(rng, walk[-1]))
            yield walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional transition probabilities (reference
    `WeightedRandomWalkIterator.java`)."""

    def _next_vertex(self, rng: np.random.Generator, cur: int) -> int:
        edges = self.graph.get_edges_out(cur)
        if not edges:
            if self.no_edge_handling == NoEdges.EXCEPTION:
                raise ValueError(f"vertex {cur} has no outgoing edges")
            return cur
        w = np.array([e.weight for e in edges], np.float64)
        p = w / w.sum()
        return edges[int(rng.choice(len(edges), p=p))].dst
