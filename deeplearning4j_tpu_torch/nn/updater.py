"""Updaters: per-parameter update rules, learning-rate schedules and
gradient normalization (counterpart of `deeplearning4j_tpu/nn/updater.py`).

The configuration types are the JAX package's, so configurations parse
and re-serialize unchanged. The update math follows it step for step. The
per-layer scalars (the scheduled learning rate, Adam's bias corrections)
are f32 numbers computed on the host with numpy, as the JAX package
computes them in f32 inside its step. Tensor math runs in the master
weights' dtype (f32); `apply_layer_update` writes the new parameters and
optimizer state into their tensors in place (call it under
`torch.no_grad()`), where the JAX package returns new arrays.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch


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


def _f32(x) -> np.float32:
    return np.float32(x)


def _c(x) -> float:
    """A Python number rounded to f32 (a JAX weak-typed scalar in f32 math)."""
    return float(np.float32(x))


def scheduled_lr(cfg: UpdaterConfig, base_lr: float, iteration: int) -> float:
    """The learning rate at `iteration` under `cfg.lr_policy`, in f32."""
    it = _f32(iteration)
    p = cfg.lr_policy
    lr = _f32(base_lr)
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        if p == LearningRatePolicy.NONE:
            out = lr
        elif p == LearningRatePolicy.EXPONENTIAL:
            out = lr * np.power(_f32(cfg.lr_policy_decay_rate), it)
        elif p == LearningRatePolicy.INVERSE:
            out = lr / np.power(_f32(1.0) + _f32(cfg.lr_policy_decay_rate) * it,
                                _f32(cfg.lr_policy_power))
        elif p == LearningRatePolicy.POLY:
            out = lr * np.power(
                _f32(1.0) - it / np.maximum(_f32(cfg.lr_policy_steps),
                                            _f32(1.0)),
                _f32(cfg.lr_policy_power))
        elif p == LearningRatePolicy.SIGMOID:
            out = lr / (_f32(1.0) + np.exp(-_f32(cfg.lr_policy_decay_rate)
                                           * (it - _f32(cfg.lr_policy_steps))))
        elif p == LearningRatePolicy.STEP:
            out = lr * np.power(_f32(cfg.lr_policy_decay_rate),
                                np.floor(it / _f32(cfg.lr_policy_steps)))
        elif p == LearningRatePolicy.TORCH_STEP:
            out = lr * np.power(
                _f32(cfg.lr_policy_decay_rate),
                np.floor(it / np.maximum(_f32(cfg.lr_policy_steps),
                                         _f32(1.0))))
        elif p == LearningRatePolicy.SCHEDULE:
            # piecewise constant: the last entry with key <= iteration wins
            out = lr
            for k in sorted(cfg.lr_schedule):
                if it >= k:
                    out = _f32(cfg.lr_schedule[k])
        else:
            raise ValueError(f"unknown lr policy {p}")
    return float(_f32(out))


def init_updater_state(cfg: UpdaterConfig,
                       param: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-parameter optimizer state, zeros like `param`."""
    u = cfg.updater
    names = {Updater.SGD: (), Updater.NONE: (),
             Updater.ADAM: ("m", "v"), Updater.ADAMAX: ("m", "v"),
             Updater.NADAM: ("m", "v"), Updater.ADADELTA: ("msg", "msdx"),
             Updater.NESTEROVS: ("v",), Updater.ADAGRAD: ("h",),
             Updater.RMSPROP: ("g2",)}.get(u)
    if names is None:
        raise ValueError(f"unknown updater {u}")
    return {n: torch.zeros_like(param) for n in names}


def apply_updater(cfg: UpdaterConfig, state: Dict[str, torch.Tensor],
                  grad: torch.Tensor, lr: float,
                  iteration: int) -> Tuple[Dict[str, torch.Tensor],
                                           torch.Tensor]:
    """The update to SUBTRACT from the parameter, and the new state
    (written into `state`'s tensors, which are returned)."""
    u = cfg.updater
    new: Dict[str, torch.Tensor]
    if u == Updater.NONE:
        return state, torch.zeros_like(grad)
    if u == Updater.SGD:
        return state, lr * grad
    t = _f32(iteration) + _f32(1.0)
    b1, b2 = _f32(cfg.adam_mean_decay), _f32(cfg.adam_var_decay)
    # 1 - b1 etc. taken in double, then rounded once, as JAX's weak-typed
    # Python scalars are
    c1, c2 = _c(1 - cfg.adam_mean_decay), _c(1 - cfg.adam_var_decay)
    eps = _c(cfg.epsilon)
    one = _f32(1.0)
    if u in (Updater.ADAM, Updater.ADAMAX, Updater.NADAM):
        m = float(b1) * state["m"] + c1 * grad
    if u == Updater.ADAM:
        v = float(b2) * state["v"] + c2 * grad ** 2
        alpha = float(_f32(lr) * np.sqrt(one - b2 ** t) / (one - b1 ** t))
        new, upd = {"m": m, "v": v}, alpha * m / (torch.sqrt(v) + eps)
    elif u == Updater.ADAMAX:
        v = torch.maximum(float(b2) * state["v"], torch.abs(grad))
        new = {"m": m, "v": v}
        upd = float(_f32(lr) / (one - b1 ** t)) * m / (v + eps)
    elif u == Updater.NADAM:
        v = float(b2) * state["v"] + c2 * grad ** 2
        mhat = m / float(one - b1 ** (t + one))
        vhat = v / float(one - b2 ** t)
        ghat = grad / float(one - b1 ** t)
        new = {"m": m, "v": v}
        upd = lr * (float(b1) * mhat + c1 * ghat) \
            / (torch.sqrt(vhat) + eps)
    elif u == Updater.ADADELTA:
        rho, c = _c(cfg.rho), _c(1 - cfg.rho)
        msg = rho * state["msg"] + c * grad ** 2
        dx = torch.sqrt(state["msdx"] + eps) / torch.sqrt(msg + eps) * grad
        msdx = rho * state["msdx"] + c * dx ** 2
        new, upd = {"msg": msg, "msdx": msdx}, dx
    elif u == Updater.NESTEROVS:
        mu = _c(cfg.momentum)
        v_prev = state["v"]
        v = mu * v_prev - lr * grad
        # ND4J NesterovsUpdater: -(mu * v_prev) + (1 + mu) * (-v), as a
        # value to subtract
        upd = mu * v_prev - _c(1 + cfg.momentum) * v
        new = {"v": v}
    elif u == Updater.ADAGRAD:
        h = state["h"] + grad ** 2
        new, upd = {"h": h}, lr * grad / (torch.sqrt(h) + eps)
    elif u == Updater.RMSPROP:
        g2 = _c(cfg.rms_decay) * state["g2"] + _c(1 - cfg.rms_decay) * grad ** 2
        new, upd = {"g2": g2}, lr * grad / torch.sqrt(g2 + eps)
    else:
        raise ValueError(f"unknown updater {u}")
    for k, val in new.items():
        state[k].copy_(val)
    return state, upd


def normalize_gradients(cfg: UpdaterConfig, grads: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Gradient normalization of one layer's gradients, applied before
    the updater."""
    gn = cfg.gradient_normalization
    if gn == GradientNormalization.NONE:
        return grads
    thr = _c(cfg.gradient_normalization_threshold)

    def layer_norm():
        return torch.sqrt(sum((g ** 2).sum() for g in grads.values()) + 1e-12)

    if gn == GradientNormalization.RENORMALIZE_L2_PER_LAYER:
        norm = layer_norm()
        return {k: g / norm for k, g in grads.items()}
    if gn == GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
        return {k: g / torch.sqrt((g ** 2).sum() + 1e-12)
                for k, g in grads.items()}
    if gn == GradientNormalization.CLIP_ELEMENT_WISE_ABSOLUTE_VALUE:
        return {k: g.clamp(-thr, thr) for k, g in grads.items()}
    if gn == GradientNormalization.CLIP_L2_PER_LAYER:
        scale = torch.clamp(thr / layer_norm(), max=1.0)
        return {k: g * scale for k, g in grads.items()}
    if gn == GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
        return {k: g * torch.clamp(thr / torch.sqrt((g ** 2).sum() + 1e-12),
                                   max=1.0)
                for k, g in grads.items()}
    raise ValueError(f"unknown gradient normalization {gn}")


def apply_layer_update(layer, upd_state_i: Dict[str, Dict[str, torch.Tensor]],
                       params_i: Dict[str, torch.Tensor],
                       grads_i: Dict[str, torch.Tensor],
                       iteration: int) -> None:
    """One layer's update, in place: gradient normalization, the
    scheduled (bias-aware) learning rate, the updater, then the
    parameter minus the update. Call under `torch.no_grad()`."""
    cfg = layer.updater_cfg
    if cfg is None or not grads_i:
        return
    g_i = normalize_gradients(cfg, grads_i)
    for name, g in g_i.items():
        is_bias = layer.param_flags(name)["is_bias"]
        base_lr = (cfg.bias_learning_rate
                   if (is_bias and cfg.bias_learning_rate is not None)
                   else cfg.learning_rate)
        lr = scheduled_lr(cfg, base_lr, iteration)
        _, update = apply_updater(cfg, upd_state_i[name], g, lr, iteration)
        params_i[name].sub_(update)


def regularization_score(named_layer_params):
    """Sum of the L1/L2 penalties over (layer, params dict) pairs."""
    reg = 0.0
    for layer, params_i in named_layer_params:
        for name, v in params_i.items():
            fl = layer.param_flags(name)
            l1 = (layer.l1_bias if fl["is_bias"] else layer.l1) or 0.0
            l2 = (layer.l2_bias if fl["is_bias"] else layer.l2) or 0.0
            if not fl["regularizable"] and not fl["is_bias"]:
                continue
            if l1:
                reg = reg + l1 * v.abs().sum()
            if l2:
                reg = reg + 0.5 * l2 * (v ** 2).sum()
    return reg
