"""Model configurations — counterpart of `deeplearning4j_tpu.models`:
`lenet_configuration` here, the GPT's in `models.transformer`. ResNet is
a ComputationGraph, ROADMAP queue A10."""

from deeplearning4j_tpu_torch.models.lenet import lenet_configuration  # noqa: F401


def __getattr__(name):
    if name in ("resnet_configuration", "resnet_tiny_configuration"):
        raise NotImplementedError(
            f"models.{name} is not ported yet (ROADMAP queue A10: "
            "ComputationGraph, which models/resnet.py builds)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
