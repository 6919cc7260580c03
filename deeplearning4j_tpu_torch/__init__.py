"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

The JAX package `deeplearning4j_tpu` stays the reference; this package
mirrors its module paths and public names, written in PyTorch for one
NVIDIA H100. Every TPU kernel on a ported path becomes a CUDA kernel
written by hand for Hopper (`csrc/`), built with nvcc at first use.

Entry points run on the card by default (`device="cuda"`) and raise when
there is none; pass `device="cpu"` to run the plain PyTorch versions of
the kernels on the CPU. This package imports neither `jax` nor anything
of `deeplearning4j_tpu`.

Ported so far: the configuration DSL and JSON with the input
preprocessors and the graph builder; `MultiLayerNetwork` and
`ComputationGraph` (fit, tBPTT, layerwise pretraining, the training
loop, evaluate, checkpoints with BatchNormalization state); the dense,
CNN, normalization, recurrent, attention, embedding, Switch-MoE and
pretraining (AutoEncoder, RBM, VAE) layers; GPT training and serving
(`models.transformer`, `serving`) on the flash and paged-attention
kernels, the char-RNN on the LSTM kernels, LeNet (`models.lenet`) and
ResNet (`models.resnet`); `gradientcheck`. ROADMAP.md's queue A lists what is still to port.
"""

__version__ = "0.1.0"

from deeplearning4j_tpu_torch.nn.conf import (  # noqa: F401
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: F401


from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: F401


def __getattr__(name):
    if name == "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import (  # noqa: E501
            ComputationGraphConfiguration,
        )

        return ComputationGraphConfiguration
    if name in ("earlystopping", "profiler"):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP queue A10b: early "
            "stopping, util.determinism, the profiler)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
