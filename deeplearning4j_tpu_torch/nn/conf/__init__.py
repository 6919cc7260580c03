"""Configuration package — counterpart of `deeplearning4j_tpu.nn.conf`."""

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.layers import (  # noqa: F401
    ActivationLayer,
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
    RnnOutputLayer,
    SelfAttention,
    SubsamplingLayer,
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
from deeplearning4j_tpu_torch.util.conv_utils import (  # noqa: F401
    ConvolutionMode,
    PoolingType,
)

# the JAX package's pretraining family, ROADMAP queue A9b
_A9B_NAMES = frozenset({
    "AutoEncoder", "BernoulliReconstructionDistribution",
    "CompositeReconstructionDistribution",
    "ExponentialReconstructionDistribution",
    "GaussianReconstructionDistribution", "LossFunctionWrapper", "RBM",
    "ReconstructionDistribution", "VariationalAutoencoder",
})


def __getattr__(name):
    if name in _A9B_NAMES:
        raise NotImplementedError(
            f"nn.conf.{name} is not ported yet (ROADMAP queue A9b: the "
            "pretraining layers and nn/conf/variational.py)")
    if name in ("ComputationGraphConfiguration", "GraphBuilder"):
        raise NotImplementedError(
            f"nn.conf.{name} is not ported yet (ROADMAP queue A10: "
            "ComputationGraph)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
