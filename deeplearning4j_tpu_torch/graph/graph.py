"""In-memory graph (reference `deeplearning4j-graph/.../graph/api/IGraph.java`
+ `graph/graph/Graph.java`): vertices with optional values, directed or
undirected weighted edges, adjacency lists."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass
class Vertex:
    idx: int
    value: Any = None


@dataclass
class Edge:
    src: int
    dst: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    """Adjacency-list graph (reference `graph/graph/Graph.java`)."""

    def __init__(self, n_vertices: int, directed: bool = False,
                 values: Optional[Sequence[Any]] = None):
        self.directed = directed
        self._vertices = [Vertex(i, values[i] if values else None)
                          for i in range(n_vertices)]
        self._adj: List[List[Edge]] = [[] for _ in range(n_vertices)]

    # -- construction -------------------------------------------------------
    def add_edge(self, src: int, dst: int, weight: float = 1.0,
                 directed: Optional[bool] = None) -> None:
        directed = self.directed if directed is None else directed
        e = Edge(src, dst, weight, directed)
        self._adj[src].append(e)
        if not directed:
            self._adj[dst].append(Edge(dst, src, weight, directed))

    @staticmethod
    def from_edge_list(edges: Iterable[Tuple[int, int]],
                       n_vertices: Optional[int] = None,
                       directed: bool = False) -> "Graph":
        edges = list(edges)
        if n_vertices is None:
            n_vertices = 1 + max(max(s, d) for s, d in edges)
        g = Graph(n_vertices, directed)
        for s, d in edges:
            g.add_edge(s, d)
        return g

    # -- queries ------------------------------------------------------------
    def num_vertices(self) -> int:
        return len(self._vertices)

    def get_vertex(self, i: int) -> Vertex:
        return self._vertices[i]

    def get_edges_out(self, i: int) -> List[Edge]:
        return list(self._adj[i])

    def get_connected_vertices(self, i: int) -> List[int]:
        return [e.dst for e in self._adj[i]]

    def degree(self, i: int) -> int:
        return len(self._adj[i])
