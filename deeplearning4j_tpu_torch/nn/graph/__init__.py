"""ComputationGraph network — counterpart of `deeplearning4j_tpu.nn.graph`."""

from deeplearning4j_tpu_torch.nn.graph.computation_graph import ComputationGraph  # noqa: F401
