"""Input preprocessors: shape adapters between layer kinds (counterpart of
`deeplearning4j_tpu/nn/conf/preprocessors.py`).

The classes, their fields, type tags and JSON are the JAX package's, so
a configuration with preprocessors written by either package parses in
the other. Layouts are the JAX package's too: CNN activations NHWC, RNN
activations (B, T, F); `CnnToFeedForwardPreProcessor` flattens in
(h, w, c) order, which is the row order of the dense weights after it.
Every preprocessor but `BinomialSamplingPreProcessor` is a reshape or a
batch statistic, differentiated by autograd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeFeedForward,
    InputTypeRecurrent,
)

_PRE_REGISTRY: Dict[str, type] = {}


def register_preprocessor(cls):
    _PRE_REGISTRY[cls.TYPE] = cls
    return cls


def preprocessor_to_json(p) -> dict:
    import dataclasses

    if p.TYPE == "composable":
        return {"type": "composable",
                "children": [preprocessor_to_json(c) for c in p.children]}
    return {"type": p.TYPE, **dataclasses.asdict(p)}


def preprocessor_from_json(d: dict):
    d = dict(d)
    t = d.pop("type")
    if t == "composable":
        return _PRE_REGISTRY[t](*[preprocessor_from_json(c)
                                  for c in d.pop("children")])
    return _PRE_REGISTRY[t](**d)


class InputPreProcessor:
    def preprocess(self, x: torch.Tensor, rng=None,
                   train: bool = False) -> torch.Tensor:
        """`rng`/`train` come from the training step for the stochastic
        preprocessor (BinomialSampling); the others ignore them."""
        raise NotImplementedError

    def output_type(self, it: InputType) -> InputType:
        raise NotImplementedError


@register_preprocessor
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """(B, H, W, C) -> (B, H*W*C), flattened in (h, w, c) order."""

    TYPE = "cnn_to_ff"
    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x, rng=None, train=False):
        return x.reshape(x.shape[0], -1)

    def output_type(self, it):
        assert isinstance(it, InputTypeConvolutional)
        return InputType.feed_forward(it.height * it.width * it.channels)


@register_preprocessor
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """(B, H*W*C) -> (B, H, W, C)."""

    TYPE = "ff_to_cnn"
    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x, rng=None, train=False):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, it):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """(B, T, F) -> (B*T, F)."""

    TYPE = "rnn_to_ff"

    def preprocess(self, x, rng=None, train=False):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, it):
        assert isinstance(it, InputTypeRecurrent)
        return InputType.feed_forward(it.size)


@register_preprocessor
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """(B*T, F) -> (B, T, F)."""

    TYPE = "ff_to_rnn"
    timeseries_length: int = -1

    def preprocess(self, x, rng=None, train=False):
        return x.reshape(-1, self.timeseries_length, x.shape[-1])

    def output_type(self, it):
        assert isinstance(it, InputTypeFeedForward)
        return InputType.recurrent(it.size, self.timeseries_length)


@register_preprocessor
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """(B, H, W, C) -> (B, 1, H*W*C): each image a length-1 sequence."""

    TYPE = "cnn_to_rnn"
    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x, rng=None, train=False):
        return x.reshape(x.shape[0], 1, -1)

    def output_type(self, it):
        assert isinstance(it, InputTypeConvolutional)
        return InputType.recurrent(it.height * it.width * it.channels, 1)


@register_preprocessor
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """(B, T, H*W*C) -> (B*T, H, W, C)."""

    TYPE = "rnn_to_cnn"
    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x, rng=None, train=False):
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, it):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclass
class ReshapePreProcessor(InputPreProcessor):
    """A fixed reshape that keeps the batch axis."""

    TYPE = "reshape"
    shape: tuple = ()

    def preprocess(self, x, rng=None, train=False):
        return x.reshape((x.shape[0],) + tuple(self.shape))

    def output_type(self, it):
        if len(self.shape) == 1:
            return InputType.feed_forward(self.shape[0])
        if len(self.shape) == 3:
            return InputType.convolutional(*self.shape)
        raise ValueError(self.shape)


@register_preprocessor
@dataclass
class ZeroMeanPrePreProcessor(InputPreProcessor):
    """Subtract the per-feature batch mean."""

    TYPE = "zero_mean"

    def preprocess(self, x, rng=None, train=False):
        return x - x.mean(dim=0, keepdim=True)

    def output_type(self, it: InputType) -> InputType:
        return it


@register_preprocessor
@dataclass
class UnitVarianceProcessor(InputPreProcessor):
    """Divide by the per-feature batch standard deviation (ddof 0)."""

    TYPE = "unit_variance"
    eps: float = 1e-8

    def preprocess(self, x, rng=None, train=False):
        return x / (x.std(dim=0, keepdim=True, correction=0) + self.eps)

    def output_type(self, it: InputType) -> InputType:
        return it


@register_preprocessor
@dataclass
class ZeroMeanAndUnitVariancePreProcessor(InputPreProcessor):
    """Standardize over the batch (ddof 0)."""

    TYPE = "zero_mean_unit_variance"
    eps: float = 1e-8

    def preprocess(self, x, rng=None, train=False):
        m = x.mean(dim=0, keepdim=True)
        s = x.std(dim=0, keepdim=True, correction=0)
        return (x - m) / (s + self.eps)

    def output_type(self, it: InputType) -> InputType:
        return it


@register_preprocessor
@dataclass
class BinomialSamplingPreProcessor(InputPreProcessor):
    """Sample Bernoulli(activation) in training when an rng is given;
    inference passes the probabilities through. The draws come from a
    `torch.Generator` seeded from the rng tuple: deterministic per seed,
    never equal to the JAX package's threefry draws."""

    TYPE = "binomial_sampling"

    def preprocess(self, x, rng=None, train=False):
        if not train or rng is None:
            return x
        from deeplearning4j_tpu_torch.nn.conf.layers import (
            _generator,
            fold_in,
        )

        u = torch.rand(x.shape, generator=_generator(fold_in(rng, 97),
                                                     x.device),
                       device=x.device)
        return (u < x).to(x.dtype)

    def output_type(self, it: InputType) -> InputType:
        return it


@dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    """Apply a sequence of preprocessors in order."""

    TYPE = "composable"

    def __init__(self, *children: InputPreProcessor):
        self.children = list(children)

    def preprocess(self, x, rng=None, train=False):
        for c in self.children:
            x = c.preprocess(x, rng=rng, train=train)
        return x

    def output_type(self, it: InputType) -> InputType:
        for c in self.children:
            it = c.output_type(it)
        return it


_PRE_REGISTRY["composable"] = ComposableInputPreProcessor
