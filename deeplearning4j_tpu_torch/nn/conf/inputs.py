"""InputType: shape metadata for inter-layer shape inference (counterpart
of `deeplearning4j_tpu/nn/conf/inputs.py`, copied so the port needs
nothing of the JAX package).

Recurrent activations are (batch, time, size), as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass


class InputType:
    """Factory + base class, mirroring the reference's static factories."""

    @staticmethod
    def feed_forward(size: int) -> "InputTypeFeedForward":
        return InputTypeFeedForward(size)

    @staticmethod
    def recurrent(size: int, timeseries_length: int = -1) -> "InputTypeRecurrent":
        return InputTypeRecurrent(size, timeseries_length)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputTypeConvolutional":
        return InputTypeConvolutional(height, width, channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputTypeConvolutionalFlat":
        return InputTypeConvolutionalFlat(height, width, channels)

    def to_json(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_json(d: dict) -> "InputType":
        t = d["type"]
        if t == "feed_forward":
            return InputTypeFeedForward(d["size"])
        if t == "recurrent":
            return InputTypeRecurrent(d["size"], d.get("timeseries_length", -1))
        if t == "convolutional":
            return InputTypeConvolutional(d["height"], d["width"], d["channels"])
        if t == "convolutional_flat":
            return InputTypeConvolutionalFlat(d["height"], d["width"], d["channels"])
        raise ValueError(f"unknown InputType {t}")


@dataclass(frozen=True)
class InputTypeFeedForward(InputType):
    size: int

    def to_json(self) -> dict:
        return {"type": "feed_forward", "size": self.size}


@dataclass(frozen=True)
class InputTypeRecurrent(InputType):
    size: int
    timeseries_length: int = -1  # -1 = variable

    def to_json(self) -> dict:
        return {"type": "recurrent", "size": self.size,
                "timeseries_length": self.timeseries_length}


@dataclass(frozen=True)
class InputTypeConvolutional(InputType):
    height: int
    width: int
    channels: int

    def to_json(self) -> dict:
        return {"type": "convolutional", "height": self.height,
                "width": self.width, "channels": self.channels}


@dataclass(frozen=True)
class InputTypeConvolutionalFlat(InputType):
    """Flattened image rows: (batch, h*w*c)."""

    height: int
    width: int
    channels: int

    @property
    def flattened_size(self) -> int:
        return self.height * self.width * self.channels

    def to_json(self) -> dict:
        return {"type": "convolutional_flat", "height": self.height,
                "width": self.width, "channels": self.channels}
