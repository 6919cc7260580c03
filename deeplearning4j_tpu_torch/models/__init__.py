"""Model configurations — counterpart of `deeplearning4j_tpu.models`. The
GPT's is `models.transformer.gpt_configuration`; the CNN ones (LeNet,
ResNet) come with the CNN layers (ROADMAP queue A9)."""


def __getattr__(name):
    if name in ("lenet_configuration", "resnet_configuration",
                "resnet_tiny_configuration"):
        raise NotImplementedError(
            f"models.{name} is not ported yet (ROADMAP queue A9: the CNN "
            "layers and models/lenet.py, models/resnet.py)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
