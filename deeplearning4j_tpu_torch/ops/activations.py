"""Activation functions (counterpart of
`deeplearning4j_tpu/ops/activations.py`).

The enum values are the JAX package's, so configurations round-trip
between the two packages. `GELU` is the tanh approximation, which is
what `jax.nn.gelu` computes by default.
"""
from __future__ import annotations

import enum
from typing import Callable

import torch
import torch.nn.functional as F


class Activation(str, enum.Enum):
    """Mirrors the reference's Activation enum values."""

    IDENTITY = "identity"
    RELU = "relu"
    LEAKYRELU = "leakyrelu"
    RELU6 = "relu6"
    ELU = "elu"
    SELU = "selu"
    SIGMOID = "sigmoid"
    HARDSIGMOID = "hardsigmoid"
    TANH = "tanh"
    HARDTANH = "hardtanh"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    SOFTMAX = "softmax"
    LOGSOFTMAX = "logsoftmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    CUBE = "cube"
    SWISH = "swish"
    GELU = "gelu"
    MISH = "mish"
    THRESHOLDEDRELU = "thresholdedrelu"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return activation_fn(self)(x)


def _rational_tanh(x):
    # Pade-style tanh approximation of the reference's RationalTanh:
    # 1.7159 * tanh_approx(2x/3)
    a = torch.clamp(2.0 * x / 3.0, -22.0, 22.0)
    approx = torch.sign(a) * (
        1.0 - 1.0 / (1.0 + torch.abs(a) + a ** 2 + 1.41645 * a ** 4))
    return 1.7159 * approx


_ACTIVATIONS: dict = {
    Activation.IDENTITY: lambda x: x,
    Activation.RELU: F.relu,
    Activation.LEAKYRELU: lambda x: F.leaky_relu(x, negative_slope=0.01),
    Activation.RELU6: F.relu6,
    Activation.ELU: F.elu,
    Activation.SELU: F.selu,
    Activation.SIGMOID: torch.sigmoid,
    # reference HardSigmoid: clip(0.2x + 0.5, 0, 1)
    Activation.HARDSIGMOID: lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    Activation.TANH: torch.tanh,
    Activation.HARDTANH: lambda x: torch.clamp(x, -1.0, 1.0),
    Activation.RATIONALTANH: _rational_tanh,
    Activation.RECTIFIEDTANH: lambda x: torch.clamp_min(torch.tanh(x), 0.0),
    Activation.SOFTMAX: lambda x: torch.softmax(x, dim=-1),
    Activation.LOGSOFTMAX: lambda x: torch.log_softmax(x, dim=-1),
    Activation.SOFTPLUS: F.softplus,
    Activation.SOFTSIGN: F.softsign,
    Activation.CUBE: lambda x: x ** 3,
    Activation.SWISH: F.silu,
    Activation.GELU: lambda x: F.gelu(x, approximate="tanh"),
    Activation.MISH: F.mish,
    Activation.THRESHOLDEDRELU: lambda x: torch.where(
        x > 1.0, x, torch.zeros_like(x)),
}


def activation_fn(act) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation enum/string to its torch implementation."""
    if not isinstance(act, Activation):
        act = Activation(act.lower())
    return _ACTIVATIONS[act]
