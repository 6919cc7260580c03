"""Weight initialization (counterpart of `deeplearning4j_tpu/nn/weights.py`).

Same enum values and the same formulas as the JAX package, drawn from an
explicit `torch.Generator`. A JAX key and a torch generator never give
the same numbers, so the two packages agree on the distributions, not on
the draws: parity between them always goes through bridged weights
(`util.serialization.params_from_jax`).
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch


class WeightInit(str, enum.Enum):
    ZERO = "zero"
    ONES = "ones"
    UNIFORM = "uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    NORMAL = "normal"
    DISTRIBUTION = "distribution"


def _normal(gen, shape, dtype):
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=gen.device)


def _uniform(gen, shape, dtype, lo, hi):
    u = torch.rand(tuple(shape), generator=gen, dtype=dtype,
                   device=gen.device)
    return lo + (hi - lo) * u


@dataclass
class Distribution:
    """Serializable distribution for WeightInit.DISTRIBUTION."""

    kind: str = "normal"  # normal | uniform | binomial
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    n_trials: int = 1
    prob: float = 0.5

    def sample(self, gen: torch.Generator, shape: Sequence[int],
               dtype=torch.float32) -> torch.Tensor:
        if self.kind == "normal":
            return self.mean + self.std * _normal(gen, shape, dtype)
        if self.kind == "uniform":
            return _uniform(gen, shape, dtype, self.lower, self.upper)
        if self.kind == "binomial":
            counts = torch.full(tuple(shape), float(self.n_trials),
                                device=gen.device)
            probs = torch.full(tuple(shape), float(self.prob),
                               device=gen.device)
            return torch.binomial(counts, probs, generator=gen).to(dtype)
        raise ValueError(f"unknown distribution {self.kind}")

    def to_json(self) -> dict:
        return {"kind": self.kind, "mean": self.mean, "std": self.std,
                "lower": self.lower, "upper": self.upper,
                "n_trials": self.n_trials, "prob": self.prob}

    @staticmethod
    def from_json(d: dict) -> "Distribution":
        return Distribution(**d)


def init_weights(gen: torch.Generator, shape: Sequence[int], fan_in: float,
                 fan_out: float, weight_init,
                 distribution: Optional[Distribution] = None,
                 dtype=torch.float32) -> torch.Tensor:
    """Initialize a weight tensor on the generator's device (reference
    `WeightInitUtil.initWeights`)."""
    wi = WeightInit(weight_init)
    if wi == WeightInit.ZERO:
        return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)
    if wi == WeightInit.ONES:
        return torch.ones(tuple(shape), dtype=dtype, device=gen.device)
    if wi == WeightInit.UNIFORM:
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if wi == WeightInit.SIGMOID_UNIFORM:
        r = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -r, r)
    if wi == WeightInit.XAVIER:
        return math.sqrt(2.0 / (fan_in + fan_out)) * _normal(gen, shape, dtype)
    if wi == WeightInit.XAVIER_UNIFORM:
        r = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -r, r)
    if wi in (WeightInit.XAVIER_FAN_IN, WeightInit.LECUN_NORMAL):
        return _normal(gen, shape, dtype) / math.sqrt(fan_in)
    if wi == WeightInit.RELU:
        return math.sqrt(2.0 / fan_in) * _normal(gen, shape, dtype)
    if wi == WeightInit.RELU_UNIFORM:
        r = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, dtype, -r, r)
    if wi == WeightInit.LECUN_UNIFORM:
        r = math.sqrt(3.0 / fan_in)
        return _uniform(gen, shape, dtype, -r, r)
    if wi == WeightInit.NORMAL:
        return _normal(gen, shape, dtype)
    if wi == WeightInit.DISTRIBUTION:
        return (distribution or Distribution()).sample(gen, shape, dtype)
    raise ValueError(f"unknown weight init {wi}")
