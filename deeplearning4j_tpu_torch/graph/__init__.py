"""Graph embeddings (reference `deeplearning4j-graph/`, §2.6 of SURVEY.md):
in-memory graph, random walks, DeepWalk skip-gram over walks.

Counterpart of `deeplearning4j_tpu/graph`: the graph, the walks and the
serializer are host code (the same walks, the same files); DeepWalk trains
on the port's `nlp.SequenceVectors`, on the card unless the caller asks
for the CPU."""
from deeplearning4j_tpu_torch.graph.graph import Graph, Vertex, Edge  # noqa: F401
from deeplearning4j_tpu_torch.graph.walks import (  # noqa: F401
    RandomWalkIterator,
    WeightedRandomWalkIterator,
)
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk  # noqa: F401
from deeplearning4j_tpu_torch.graph.serializer import GraphVectorSerializer  # noqa: F401
