"""Model configurations — counterpart of `deeplearning4j_tpu.models`:
LeNet and ResNet here, the GPT's in `models.transformer`."""

from deeplearning4j_tpu_torch.models.lenet import lenet_configuration  # noqa: F401
from deeplearning4j_tpu_torch.models.resnet import (  # noqa: F401
    resnet_configuration,
    resnet_tiny_configuration,
)
