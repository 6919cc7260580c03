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

_A9_NAMES = frozenset({
    "ActivationLayer", "AutoEncoder", "BatchNormalization",
    "BernoulliReconstructionDistribution",
    "CompositeReconstructionDistribution", "ConvolutionLayer",
    "ConvolutionMode", "DropoutLayer", "EmbeddingLayer",
    "ExponentialReconstructionDistribution",
    "GaussianReconstructionDistribution", "GlobalPoolingLayer",
    "LocalResponseNormalization", "LossFunctionWrapper", "LossLayer",
    "PoolingType", "RBM", "ReconstructionDistribution", "SelfAttention",
    "SubsamplingLayer", "VariationalAutoencoder",
})


def __getattr__(name):
    if name in _A9_NAMES:
        raise NotImplementedError(
            f"nn.conf.{name} is not ported yet (ROADMAP queue A9: the rest "
            "of nn/)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
