"""ResNet family on the ComputationGraph (counterpart of
`deeplearning4j_tpu/models/resnet.py`, the same configurations and JSON):
BASELINE config 2, ResNet-50 on CIFAR-10.

Residual adds are `ElementWiseVertex` nodes; every convolution is a
`ConvolutionLayer` in SAME mode followed by a `BatchNormalization` node,
NHWC throughout (cuDNN convolves channels-last views; SAME's asymmetric
pads at stride 2 are applied explicitly before it).
"""
from __future__ import annotations

from typing import Tuple

from deeplearning4j_tpu_torch.nn.conf import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    GlobalPoolingLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import (
    ComputationGraphConfiguration,
    ElementWiseVertex,
)
from deeplearning4j_tpu_torch.nn.updater import Updater
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from deeplearning4j_tpu_torch.util.conv_utils import ConvolutionMode, PoolingType

# (block kind, units per stage) per depth — torchvision/He et al. layouts
_DEPTHS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
_STAGE_FILTERS = (64, 128, 256, 512)


def _conv_bn(b, name: str, inp: str, n_out: int, kernel: Tuple[int, int],
             stride: Tuple[int, int], relu: bool) -> str:
    b.add_layer(f"{name}_conv",
                ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                 convolution_mode=ConvolutionMode.SAME,
                                 activation=Activation.IDENTITY,
                                 bias_init=0.0),
                inp)
    b.add_layer(f"{name}_bn",
                BatchNormalization(
                    activation=Activation.RELU if relu else Activation.IDENTITY),
                f"{name}_conv")
    return f"{name}_bn"


def _basic_block(b, name: str, inp: str, in_ch: int, filters: int,
                 stride: int) -> Tuple[str, int]:
    x = _conv_bn(b, f"{name}_a", inp, filters, (3, 3), (stride, stride), relu=True)
    x = _conv_bn(b, f"{name}_b", x, filters, (3, 3), (1, 1), relu=False)
    shortcut = inp
    if stride != 1 or in_ch != filters:
        shortcut = _conv_bn(b, f"{name}_proj", inp, filters, (1, 1),
                            (stride, stride), relu=False)
    b.add_vertex(f"{name}_add", ElementWiseVertex(), x, shortcut)
    b.add_layer(f"{name}_relu", ActivationLayer(activation=Activation.RELU),
                f"{name}_add")
    return f"{name}_relu", filters


def _bottleneck_block(b, name: str, inp: str, in_ch: int, filters: int,
                      stride: int) -> Tuple[str, int]:
    out_ch = filters * 4
    x = _conv_bn(b, f"{name}_a", inp, filters, (1, 1), (1, 1), relu=True)
    x = _conv_bn(b, f"{name}_b", x, filters, (3, 3), (stride, stride), relu=True)
    x = _conv_bn(b, f"{name}_c", x, out_ch, (1, 1), (1, 1), relu=False)
    shortcut = inp
    if stride != 1 or in_ch != out_ch:
        shortcut = _conv_bn(b, f"{name}_proj", inp, out_ch, (1, 1),
                            (stride, stride), relu=False)
    b.add_vertex(f"{name}_add", ElementWiseVertex(), x, shortcut)
    b.add_layer(f"{name}_relu", ActivationLayer(activation=Activation.RELU),
                f"{name}_add")
    return f"{name}_relu", out_ch


def resnet_configuration(depth: int = 50, n_classes: int = 10,
                         height: int = 32, width: int = 32, channels: int = 3,
                         seed: int = 12345, learning_rate: float = 0.1,
                         updater: Updater = Updater.NESTEROVS,
                         stage_filters: Tuple[int, ...] = _STAGE_FILTERS,
                         ) -> ComputationGraphConfiguration:
    """Build a ResNet-`depth` ComputationGraphConfiguration.

    For small inputs (CIFAR, height < 64) the stem is the CIFAR-style 3x3
    conv without max-pool; otherwise the ImageNet 7x7/2 + maxpool stem.
    """
    if depth not in _DEPTHS:
        raise ValueError(f"unsupported resnet depth {depth}; choose from {sorted(_DEPTHS)}")
    kind, units = _DEPTHS[depth]
    if len(stage_filters) != len(units):
        raise ValueError(f"stage_filters must have {len(units)} entries, "
                         f"got {len(stage_filters)}")
    block = _basic_block if kind == "basic" else _bottleneck_block

    b = (NeuralNetConfiguration.Builder()
         .seed(seed)
         .learning_rate(learning_rate)
         .updater(updater)
         .momentum(0.9)
         .l2(1e-4)
         .weight_init("relu")
         .graph_builder()
         .add_inputs("in"))

    if height < 64:
        x = _conv_bn(b, "stem", "in", stage_filters[0], (3, 3), (1, 1), relu=True)
    else:
        x = _conv_bn(b, "stem", "in", stage_filters[0], (7, 7), (2, 2), relu=True)
        b.add_layer("stem_pool",
                    SubsamplingLayer(pooling_type=PoolingType.MAX, kernel=(3, 3),
                                     stride=(2, 2),
                                     convolution_mode=ConvolutionMode.SAME),
                    x)
        x = "stem_pool"

    ch = stage_filters[0]
    for stage, (n_units, filters) in enumerate(zip(units, stage_filters)):
        for unit in range(n_units):
            stride = 2 if (unit == 0 and stage > 0) else 1
            x, ch = block(b, f"s{stage}u{unit}", x, ch, filters, stride)

    b.add_layer("gap", GlobalPoolingLayer(pooling_type=PoolingType.AVG), x)
    b.add_layer("out", OutputLayer(n_out=n_classes, loss=LossFunction.MCXENT,
                                   activation=Activation.SOFTMAX,
                                   weight_init="xavier"),
                "gap")
    return (b.set_outputs("out")
            .set_input_types(InputType.convolutional(height, width, channels))
            .build())


def resnet_tiny_configuration(n_classes: int = 10, height: int = 8,
                              width: int = 8, channels: int = 3,
                              seed: int = 12345,
                              learning_rate: float = 0.05,
                              ) -> ComputationGraphConfiguration:
    """Two-stage basic-block ResNet for tests: same code path as ResNet-50
    (residual adds, BN, projection shortcuts) at toy scale."""
    b = (NeuralNetConfiguration.Builder()
         .seed(seed).learning_rate(learning_rate).updater(Updater.NESTEROVS)
         .momentum(0.9).weight_init("relu")
         .graph_builder()
         .add_inputs("in"))
    x = _conv_bn(b, "stem", "in", 8, (3, 3), (1, 1), relu=True)
    x, ch = _basic_block(b, "s0u0", x, 8, 8, 1)
    x, ch = _basic_block(b, "s1u0", x, ch, 16, 2)
    b.add_layer("gap", GlobalPoolingLayer(pooling_type=PoolingType.AVG), x)
    b.add_layer("out", OutputLayer(n_out=n_classes, loss=LossFunction.MCXENT,
                                   activation=Activation.SOFTMAX,
                                   weight_init="xavier"),
                "gap")
    return (b.set_outputs("out")
            .set_input_types(InputType.convolutional(height, width, channels))
            .build())
