"""DeepWalk: skip-gram over random walks (reference
`deeplearning4j-graph/.../models/deepwalk/DeepWalk.java` +
`GraphHuffman.java`). The reference trains hierarchical softmax with its own
Huffman coder over vertex degrees; here the shared SequenceVectors engine
provides both HS and negative sampling through its scatter steps on the
tables' device (`nlp/kernels.py`). Counterpart of
`deeplearning4j_tpu/graph/deepwalk.py`: the walks are the same host
numpy draws, the training runs on `device` (the card unless the caller
asks for the CPU)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walks import RandomWalkIterator
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors


class DeepWalk:
    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 10,
                 learning_rate: float = 0.025, negative: int = 5,
                 use_hierarchic_softmax: bool = False,
                 batch_size: int = 1024, seed: int = 123,
                 device="cuda"):
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.seed = seed
        self._sv = SequenceVectors(
            layer_size=vector_size, window=window_size,
            min_word_frequency=1.0, negative=negative,
            use_hierarchic_softmax=use_hierarchic_softmax,
            learning_rate=learning_rate, batch_size=batch_size,
            epochs=1, seed=seed, elements_learning_algorithm="skipgram",
            device=device)

    def fit(self, graph: Graph) -> None:
        """Generate walks_per_vertex × num_vertices walks and skip-gram
        them (reference `DeepWalk.fit(GraphWalkIterator)`)."""
        walks: List[List[str]] = []
        for r in range(self.walks_per_vertex):
            it = RandomWalkIterator(graph, self.walk_length,
                                    seed=self.seed + r)
            walks.extend([str(v) for v in walk] for walk in it)
        self._sv.fit(walks)

    # -- query --------------------------------------------------------------
    @property
    def lookup_table(self):
        return self._sv.lookup_table

    @property
    def vocab(self):
        return self._sv.vocab

    def vertex_vector(self, vertex: int) -> Optional[np.ndarray]:
        return self._sv.get_word_vector(str(vertex))

    def similarity(self, v1: int, v2: int) -> float:
        return self._sv.similarity(str(v1), str(v2))

    def verts_nearest(self, vertex: int, top_n: int = 10) -> List[Tuple[int, float]]:
        return [(int(w), s) for w, s in self._sv.words_nearest(str(vertex), top_n)]
