"""Convolution/pooling shape math (counterpart of
`deeplearning4j_tpu/util/conv_utils.py`, copied).

Reference: `deeplearning4j-nn/.../util/ConvolutionUtils.java`
(`getOutputSize`, Same-mode padding) and `nn/conf/ConvolutionMode.java`:
- Strict:   out = (in - k + 2p) / s + 1, must divide exactly (else error)
- Truncate: out = floor((in - k + 2p) / s) + 1
- Same:     out = ceil(in / s), with asymmetric implicit padding
"""
from __future__ import annotations

import enum
import math
from typing import Sequence, Tuple


class ConvolutionMode(str, enum.Enum):
    STRICT = "strict"
    TRUNCATE = "truncate"
    SAME = "same"


class PoolingType(str, enum.Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


def output_size_1d(in_size: int, kernel: int, stride: int, padding: int,
                   mode: ConvolutionMode, dilation: int = 1) -> int:
    eff_k = kernel + (kernel - 1) * (dilation - 1)
    if mode == ConvolutionMode.SAME:
        return int(math.ceil(in_size / stride))
    num = in_size - eff_k + 2 * padding
    if mode == ConvolutionMode.STRICT:
        if num % stride != 0:
            raise ValueError(
                f"ConvolutionMode.Strict: (in={in_size} - k={eff_k} + 2*p={padding}) "
                f"= {num} not divisible by stride {stride} "
                "(reference ConvolutionUtils.getOutputSize error path)")
        return num // stride + 1
    return num // stride + 1  # Truncate: floor


def same_padding_1d(in_size: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """Asymmetric (lo, hi) padding for ConvolutionMode.Same — matches XLA's
    'SAME' semantics and the reference's Same-mode implicit padding."""
    eff_k = kernel + (kernel - 1) * (dilation - 1)
    out = int(math.ceil(in_size / stride))
    total = max(0, (out - 1) * stride + eff_k - in_size)
    lo = total // 2
    return lo, total - lo


def conv_output_hw(
    hw: Tuple[int, int],
    kernel: Tuple[int, int],
    stride: Tuple[int, int],
    padding: Tuple[int, int],
    mode: ConvolutionMode,
    dilation: Tuple[int, int] = (1, 1),
) -> Tuple[int, int]:
    return (
        output_size_1d(hw[0], kernel[0], stride[0], padding[0], mode, dilation[0]),
        output_size_1d(hw[1], kernel[1], stride[1], padding[1], mode, dilation[1]),
    )


def explicit_padding(
    hw: Tuple[int, int],
    kernel: Tuple[int, int],
    stride: Tuple[int, int],
    padding: Tuple[int, int],
    mode: ConvolutionMode,
    dilation: Tuple[int, int] = (1, 1),
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) padding to hand to
    the convolution and pooling layers, which pad with them first."""
    if mode == ConvolutionMode.SAME:
        return (
            same_padding_1d(hw[0], kernel[0], stride[0], dilation[0]),
            same_padding_1d(hw[1], kernel[1], stride[1], dilation[1]),
        )
    return ((padding[0], padding[0]), (padding[1], padding[1]))
