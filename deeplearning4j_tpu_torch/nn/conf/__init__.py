"""Configuration package — counterpart of `deeplearning4j_tpu.nn.conf`."""

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.layers import (  # noqa: F401
    ActivationLayer,
    AutoEncoder,
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    GlobalPoolingLayer,
    GravesBidirectionalLSTM,
    GravesLSTM,
    Layer,
    LayerNormalization,
    LocalResponseNormalization,
    LossLayer,
    MoELayer,
    OutputLayer,
    RBM,
    RnnOutputLayer,
    SelfAttention,
    SubsamplingLayer,
    TokenEmbedding,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.conf.variational import (  # noqa: F401
    BernoulliReconstructionDistribution,
    CompositeReconstructionDistribution,
    ExponentialReconstructionDistribution,
    GaussianReconstructionDistribution,
    LossFunctionWrapper,
    ReconstructionDistribution,
    VariationalAutoencoder,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (  # noqa: F401
    GlobalConf,
    ListBuilder,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.util.conv_utils import (  # noqa: F401
    ConvolutionMode,
    PoolingType,
)


def __getattr__(name):
    # the graph configuration is its own module, imported on first use
    if name in ("ComputationGraphConfiguration", "GraphBuilder"):
        from deeplearning4j_tpu_torch.nn.conf import (
            computation_graph_configuration as m,
        )

        return getattr(m, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
