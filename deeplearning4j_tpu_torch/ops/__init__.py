"""Kernels, their plain PyTorch versions, and the tensor primitives
around them; the activations and losses are exported here as in the
JAX package's `ops`."""

from deeplearning4j_tpu_torch.ops.activations import Activation, activation_fn  # noqa: F401
from deeplearning4j_tpu_torch.ops.losses import LossFunction, loss_fn  # noqa: F401
