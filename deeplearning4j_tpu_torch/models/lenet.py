"""LeNet on MNIST-shaped images (counterpart of
`deeplearning4j_tpu/models/lenet.py`): two 5x5 convolutions (20 and 50
channels), each followed by 2x2 max pooling, a dense ReLU layer of 500
and a softmax head, on 28x28x1 inputs given flat; `build()` inserts the
FeedForwardToCnn and CnnToFeedForward preprocessors. The same
configuration, and JSON, as the JAX package's."""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayer,
    DenseLayer,
    InputType,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.updater import Updater
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from deeplearning4j_tpu_torch.util.conv_utils import PoolingType


def lenet_configuration(seed: int = 12345, learning_rate: float = 0.01,
                        updater: Updater = Updater.NESTEROVS,
                        n_classes: int = 10) -> MultiLayerConfiguration:
    return (NeuralNetConfiguration.Builder()
            .seed(seed)
            .learning_rate(learning_rate)
            .updater(updater)
            .momentum(0.9)
            .weight_init("xavier")
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel=(5, 5), stride=(1, 1),
                                    activation=Activation.IDENTITY))
            .layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                    kernel=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel=(5, 5), stride=(1, 1),
                                    activation=Activation.IDENTITY))
            .layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                    kernel=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation=Activation.RELU))
            .layer(OutputLayer(n_out=n_classes, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())
