"""Updater configuration (counterpart of the enums and `UpdaterConfig` in
`deeplearning4j_tpu/nn/updater.py`).

Configuration only: the serving slice never takes an optimizer step.
These types let a configuration written by the JAX package parse and
re-serialize unchanged; the update rules come with the training slice.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional


class Updater(str, enum.Enum):
    SGD = "sgd"
    ADAM = "adam"
    ADAMAX = "adamax"
    NADAM = "nadam"
    ADADELTA = "adadelta"
    NESTEROVS = "nesterovs"
    ADAGRAD = "adagrad"
    RMSPROP = "rmsprop"
    NONE = "none"


class LearningRatePolicy(str, enum.Enum):
    NONE = "none"
    EXPONENTIAL = "exponential"
    INVERSE = "inverse"
    POLY = "poly"
    SIGMOID = "sigmoid"
    STEP = "step"
    TORCH_STEP = "torch_step"
    SCHEDULE = "schedule"


class GradientNormalization(str, enum.Enum):
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENT_WISE_ABSOLUTE_VALUE = "clip_element_wise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


@dataclass
class UpdaterConfig:
    """Per-layer updater hyperparameters, merged global -> layer at
    build time."""

    updater: Updater = Updater.SGD
    learning_rate: float = 1e-1
    bias_learning_rate: Optional[float] = None  # None -> learning_rate
    momentum: float = 0.9
    rho: float = 0.95
    rms_decay: float = 0.95
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    epsilon: float = 1e-8
    lr_policy: LearningRatePolicy = LearningRatePolicy.NONE
    lr_policy_decay_rate: float = 0.0
    lr_policy_power: float = 0.0
    lr_policy_steps: float = 1.0
    lr_schedule: Dict[int, float] = field(default_factory=dict)
    gradient_normalization: GradientNormalization = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0

    def to_json(self) -> dict:
        return {
            "updater": self.updater.value,
            "learning_rate": self.learning_rate,
            "bias_learning_rate": self.bias_learning_rate,
            "momentum": self.momentum,
            "rho": self.rho,
            "rms_decay": self.rms_decay,
            "adam_mean_decay": self.adam_mean_decay,
            "adam_var_decay": self.adam_var_decay,
            "epsilon": self.epsilon,
            "lr_policy": self.lr_policy.value,
            "lr_policy_decay_rate": self.lr_policy_decay_rate,
            "lr_policy_power": self.lr_policy_power,
            "lr_policy_steps": self.lr_policy_steps,
            "lr_schedule": {str(k): v for k, v in self.lr_schedule.items()},
            "gradient_normalization": self.gradient_normalization.value,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
        }

    @staticmethod
    def from_json(d: dict) -> "UpdaterConfig":
        c = UpdaterConfig()
        c.updater = Updater(d.get("updater", "sgd"))
        c.learning_rate = d.get("learning_rate", 1e-1)
        c.bias_learning_rate = d.get("bias_learning_rate")
        c.momentum = d.get("momentum", 0.9)
        c.rho = d.get("rho", 0.95)
        c.rms_decay = d.get("rms_decay", 0.95)
        c.adam_mean_decay = d.get("adam_mean_decay", 0.9)
        c.adam_var_decay = d.get("adam_var_decay", 0.999)
        c.epsilon = d.get("epsilon", 1e-8)
        c.lr_policy = LearningRatePolicy(d.get("lr_policy", "none"))
        c.lr_policy_decay_rate = d.get("lr_policy_decay_rate", 0.0)
        c.lr_policy_power = d.get("lr_policy_power", 0.0)
        c.lr_policy_steps = d.get("lr_policy_steps", 1.0)
        c.lr_schedule = {int(k): v
                         for k, v in d.get("lr_schedule", {}).items()}
        c.gradient_normalization = GradientNormalization(
            d.get("gradient_normalization", "none"))
        c.gradient_normalization_threshold = d.get(
            "gradient_normalization_threshold", 1.0)
        return c
