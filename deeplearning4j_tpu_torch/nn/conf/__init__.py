"""Configuration package — counterpart of `deeplearning4j_tpu.nn.conf`."""

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.layers import (  # noqa: F401
    DenseLayer,
    GravesBidirectionalLSTM,
    GravesLSTM,
    Layer,
    LayerNormalization,
    OutputLayer,
    RnnOutputLayer,
    TokenEmbedding,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (  # noqa: F401
    GlobalConf,
    ListBuilder,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    OptimizationAlgorithm,
)
