"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

The JAX package `deeplearning4j_tpu` stays the reference; this package
mirrors its module paths and public names, written in PyTorch for one
NVIDIA H100. Every TPU kernel on a ported path becomes a CUDA kernel
written by hand for Hopper (`csrc/`), built with nvcc at first use.

Entry points run on the card by default (`device="cuda"`) and raise when
there is none; pass `device="cpu"` to run the plain PyTorch versions of
the kernels on the CPU. This package imports neither `jax` nor anything
of `deeplearning4j_tpu`.

Ported so far: the GPT serving path (configuration DSL and JSON,
`MultiLayerNetwork` init/output, `models.transformer.generate`, the
continuous-batching `serving.decode_engine.DecodeEngine`, checkpoint
reading) with the paged-attention kernel.
"""

__version__ = "0.1.0"

from deeplearning4j_tpu_torch.nn.conf import (  # noqa: F401
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: F401
