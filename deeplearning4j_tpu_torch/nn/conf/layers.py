"""Layer configurations with their parameter init, forward and loss
(counterpart of `deeplearning4j_tpu/nn/conf/layers.py`, for the layers
of the GPT path).

Each config is a dataclass whose fields, field order and JSON encoding
are the JAX package's, so a configuration written by either package
parses in the other and re-serializes equal. `init_params` draws from an
explicit `torch.Generator`. `forward(params, x, train=, rng=, mask=)`
serves inference and training; none of these layers carries layer
state. Dropout is inverted dropout drawn from a `torch.Generator` seeded
from `rng`, a tuple of ints (the configuration's seed, the iteration,
the layer index and the dropout site): deterministic per seed, never
equal to the JAX package's threefry draws.

Layout conventions are the JAX package's: FF activations (B, F), RNN
activations (B, T, F).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.updater import UpdaterConfig
from deeplearning4j_tpu_torch.nn.weights import (
    Distribution,
    WeightInit,
    init_weights,
)
from deeplearning4j_tpu_torch.ops.activations import Activation, activation_fn
from deeplearning4j_tpu_torch.ops.kernel_dispatch import stat_dtype
from deeplearning4j_tpu_torch.ops.losses import LossFunction

Params = Dict[str, torch.Tensor]
Rng = Optional[Tuple[int, ...]]


def fold_in(rng: Rng, i: int) -> Rng:
    """A new dropout key derived from `rng` and `i` (None stays None)."""
    return None if rng is None else tuple(rng) + (int(i),)


def _generator(rng: Tuple[int, ...], device) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(rng)).generate_state(
        1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, p: float, rng: Tuple[int, ...]) -> torch.Tensor:
    """Inverted dropout: zero each element with probability p, scale the
    kept ones by 1 / (1 - p), the mask drawn from `rng`."""
    keep = 1.0 - p
    m = torch.rand(x.shape, generator=_generator(rng, x.device),
                   device=x.device) < keep
    return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                device=x.device))

# ---------------------------------------------------------------------------
# serde registry

_LAYER_REGISTRY: Dict[str, type] = {}

# field-name -> decoder applied on from_json
_FIELD_DECODERS: Dict[str, Callable[[Any], Any]] = {
    "activation": Activation,
    "weight_init": WeightInit,
    "dist": Distribution.from_json,
    "loss": LossFunction,
    "updater_cfg": UpdaterConfig.from_json,
}


def register_layer(cls):
    _LAYER_REGISTRY[cls.TYPE] = cls
    return cls


def _encode(v):
    import enum

    if isinstance(v, enum.Enum):
        return v.value
    if hasattr(v, "to_json"):  # Distribution, UpdaterConfig
        return v.to_json()
    if isinstance(v, tuple):
        return list(v)
    return v


def layer_to_json(layer: "Layer") -> dict:
    d = {"type": layer.TYPE}
    for f in dataclasses.fields(layer):
        d[f.name] = _encode(getattr(layer, f.name))
    return d


def layer_from_json(d: dict) -> "Layer":
    d = dict(d)
    t = d.pop("type")
    cls = _LAYER_REGISTRY.get(t)
    if cls is None:
        raise NotImplementedError(
            f"layer type {t!r} is not ported yet (ROADMAP queue A: the "
            f"port carries {sorted(_LAYER_REGISTRY)})")
    kwargs = {}
    names = {f.name for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in names:
            continue
        if v is not None and k in _FIELD_DECODERS:
            v = _FIELD_DECODERS[k](v)
        kwargs[k] = v
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# base


@dataclass
class Layer:
    """Base layer config (reference `nn/conf/layers/Layer.java` +
    `BaseLayer` hyperparameter fields)."""

    TYPE = "base"

    name: Optional[str] = None
    # None -> inherit the global builder default at build() time
    activation: Optional[Activation] = None
    weight_init: Optional[WeightInit] = None
    dist: Optional[Distribution] = None
    bias_init: Optional[float] = None
    dropout: Optional[float] = None
    use_drop_connect: Optional[bool] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    updater_cfg: Optional[UpdaterConfig] = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None

    input_kind = "any"  # 'ff' | 'cnn' | 'rnn' | 'any'

    @property
    def has_params(self) -> bool:
        return True

    def output_type(self, it: InputType) -> InputType:
        raise NotImplementedError

    def init_params(self, gen: torch.Generator, it: InputType,
                    dtype=torch.float32) -> Params:
        return {}

    def forward(self, params: Params, x: torch.Tensor, *, train=False,
                rng: Rng = None, mask=None) -> torch.Tensor:
        raise NotImplementedError

    def param_flags(self, name: str) -> Dict[str, bool]:
        """is_bias: bias learning rate and bias l1/l2 apply; regularizable:
        l1/l2 apply."""
        is_bias = name in ("b", "vb", "beta")
        return {"is_bias": is_bias,
                "regularizable": not is_bias and name != "gamma"}

    def _maybe_dropout(self, x, train, rng: Rng):
        """Input dropout at train time (DL4J's inverted dropout)."""
        p = self.dropout or 0.0
        if not train or p <= 0.0 or rng is None:
            return x
        return dropout(x, p, rng)

    def _act(self):
        return activation_fn(self.activation or Activation.IDENTITY)

    def _winit(self, gen, shape, fan_in, fan_out, dtype):
        return init_weights(gen, shape, fan_in, fan_out,
                            self.weight_init or WeightInit.XAVIER, self.dist,
                            dtype)


class FeedForwardLayer(Layer):
    """Base for layers with n_in/n_out."""

    n_in: int = 0
    n_out: int = 0


# ---------------------------------------------------------------------------
# dense / output


@register_layer
@dataclass
class DenseLayer(FeedForwardLayer):
    """Fully-connected layer: act(x W + b)."""

    TYPE = "dense"
    input_kind = "ff"
    n_in: int = 0
    n_out: int = 0

    def output_type(self, it: InputType) -> InputType:
        if isinstance(it, InputTypeRecurrent):
            return InputType.recurrent(self.n_out, it.timeseries_length)
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        W = self._winit(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                        dtype)
        b = torch.full((self.n_out,), float(self.bias_init or 0.0),
                       dtype=dtype, device=gen.device)
        return {"W": W, "b": b}

    def pre_output(self, params, x, *, train=False, rng: Rng = None):
        if self.use_drop_connect and train and (self.dropout or 0.0) > 0 \
                and rng is not None:
            raise NotImplementedError(
                "DropConnect (use_drop_connect=True with dropout > 0) is not "
                "ported yet (ROADMAP queue A9: the rest of nn/)")
        x = self._maybe_dropout(x, train, rng)
        return x @ params["W"] + params["b"]

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        return self._act()(self.pre_output(params, x, train=train, rng=rng))


@register_layer
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head."""

    TYPE = "output"
    loss: LossFunction = LossFunction.MCXENT

    def loss_score(self, params, x, labels, *, train=False, rng: Rng = None,
                   mask=None):
        """Mean loss over (unmasked) rows; time-distributed (B, T, F)
        outputs are flattened to B*T rows."""
        from deeplearning4j_tpu_torch.ops.losses import loss_score

        pre = self.pre_output(params, x, train=train, rng=rng)
        if pre.ndim == 3:
            B, T, F_ = pre.shape
            pre = pre.reshape(B * T, F_)
            # sparse int labels are (B, T); dense targets keep a feature axis
            labels = (labels.reshape(B * T)
                      if labels.ndim == 2 and not labels.is_floating_point()
                      else labels.reshape(B * T, -1))
            if mask is not None:
                mask = mask.reshape(B * T)
        return loss_score(self.loss, self.activation or Activation.IDENTITY,
                          labels, pre, mask)


@register_layer
@dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep output layer: (B, T, F) -> (B, T, n_out)."""

    TYPE = "rnn_output"
    input_kind = "rnn"

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length if isinstance(it, InputTypeRecurrent) else -1
        return InputType.recurrent(self.n_out, t)


# ---------------------------------------------------------------------------
# transformer tier


@register_layer
@dataclass
class LayerNormalization(FeedForwardLayer):
    """Layer normalization over the feature axis, statistics in >= f32."""

    TYPE = "layer_norm"
    input_kind = "rnn"
    n_in: int = 0
    n_out: int = 0
    eps: float = 1e-5

    def __post_init__(self):
        if self.n_out and self.n_in and self.n_out != self.n_in:
            raise ValueError("LayerNormalization keeps width: n_in == n_out")

    def output_type(self, it: InputType) -> InputType:
        return it

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        nf = self.n_out or self.n_in or it.size
        return {"gamma": torch.ones((nf,), dtype=dtype, device=gen.device),
                "beta": torch.zeros((nf,), dtype=dtype, device=gen.device)}

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        return layer_norm(x, params["gamma"], params["beta"], self.eps)


def layer_norm(x, gamma, beta, eps=1e-5):
    """Statistics in f32 (f64 for f64 input), population variance (ddof 0,
    as `jnp.var`), result cast back to x's dtype."""
    sdt = stat_dtype(x.dtype)
    xs = x.to(sdt)
    mean = xs.mean(dim=-1, keepdim=True)
    var = xs.var(dim=-1, keepdim=True, correction=0)
    xhat = (xs - mean) / torch.sqrt(var + eps)
    return (xhat * gamma.to(sdt) + beta.to(sdt)).to(x.dtype)


@register_layer
@dataclass
class TokenEmbedding(FeedForwardLayer):
    """Token + learned positional embedding: (B, T) int ids -> (B, T, D)."""

    TYPE = "token_embedding"
    input_kind = "rnn"
    integer_input = True
    n_in: int = 0          # vocabulary size
    n_out: int = 0         # d_model
    max_length: int = 512
    # False: tokens only (RoPE models, where position lives in the
    # attention rotation)
    positional: bool = True

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length if isinstance(it, InputTypeRecurrent) else -1
        return InputType.recurrent(self.n_out, t)

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        tok = self._winit(gen, (self.n_in, self.n_out), self.n_in,
                          self.n_out, dtype)
        if not self.positional:
            return {"W": tok}
        pos = 0.02 * torch.randn((self.max_length, self.n_out),
                                 generator=gen, dtype=dtype,
                                 device=gen.device)
        return {"W": tok, "P": pos}

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        idx = x.long()
        if idx.ndim == 3:  # (B, T, 1) convenience
            idx = idx[..., 0]
        T = idx.shape[1]
        if self.positional and T > self.max_length:
            raise ValueError(f"sequence length {T} exceeds max_length "
                             f"{self.max_length}")
        y = params["W"][idx]
        if self.positional:
            y = y + params["P"][:T]
        return self._maybe_dropout(y, train, rng)

    def param_flags(self, name):
        # positional table: neither a bias nor weight-decayed
        if name == "P":
            return {"is_bias": False, "regularizable": False}
        return super().param_flags(name)


_NOT_PORTED_MOE = ("TransformerBlock(moe_experts>0) is not ported yet "
                   "(ROADMAP queue A9: MoELayer with ops/aux_loss)")


@register_layer
@dataclass
class TransformerBlock(FeedForwardLayer):
    """Pre-LN transformer block: x + MHA(LN(x)), then x + FFN(LN(x)).
    Dense gelu (tanh form) or swiglu FFN, grouped-query attention
    (`n_kv_heads`) and rotary embeddings (`rope`)."""

    TYPE = "transformer_block"
    input_kind = "rnn"
    n_in: int = 0          # d_model
    n_out: int = 0
    n_heads: int = 4
    n_kv_heads: int = 0    # 0 = n_heads (full MHA); 1 = MQA
    rope: bool = False
    rope_base: float = 10000.0
    ffn_mult: int = 4
    ffn_activation: str = "gelu"  # gelu | swiglu
    causal: bool = True
    block_size: Optional[int] = 1024
    eps: float = 1e-5
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    remat: bool = False

    def __post_init__(self):
        d = self.n_out or self.n_in
        if d and d % self.n_heads:
            raise ValueError(f"d_model {d} not divisible by n_heads "
                             f"{self.n_heads}")
        if self.n_in and self.n_out and self.n_in != self.n_out:
            raise ValueError("TransformerBlock keeps width: n_in == n_out")
        if self.n_kv_heads:
            if self.n_kv_heads < 0:
                raise ValueError(f"n_kv_heads must be >= 0, got "
                                 f"{self.n_kv_heads}")
            if self.n_heads % self.n_kv_heads:
                raise ValueError(
                    f"n_heads {self.n_heads} not divisible by n_kv_heads "
                    f"{self.n_kv_heads}")
        if self.rope and d and (d // self.n_heads) % 2:
            raise ValueError(f"RoPE rotates feature pairs: head_dim "
                             f"{d // self.n_heads} must be even")
        if self.ffn_activation not in ("gelu", "swiglu"):
            raise ValueError(f"unknown ffn_activation "
                             f"{self.ffn_activation!r}: gelu | swiglu")

    @property
    def _d(self) -> int:
        return self.n_out or self.n_in

    @property
    def _kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def _check_ported(self):
        if self.moe_experts > 0:
            raise NotImplementedError(_NOT_PORTED_MOE)

    def output_type(self, it: InputType) -> InputType:
        return it

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        self._check_ported()
        d = self._d
        h = d * self.ffn_mult
        kvw = self._kv_heads * (d // self.n_heads)
        w3 = d + 2 * kvw
        dev = gen.device

        def mk(shape, fi, fo):
            return self._winit(gen, shape, fi, fo, dtype)

        def const(n, v):
            return torch.full((n,), v, dtype=dtype, device=dev)

        params = {"ln1_g": const(d, 1.0), "ln1_b": const(d, 0.0),
                  "Wqkv": mk((d, w3), d, w3), "bqkv": const(w3, 0.0),
                  "Wo": mk((d, d), d, d), "bo": const(d, 0.0),
                  "ln2_g": const(d, 1.0), "ln2_b": const(d, 0.0),
                  "W1": mk((d, h), d, h)}
        if self.ffn_activation == "swiglu":
            params["W3"] = mk((d, h), d, h)
        else:
            params["b1"] = const(h, 0.0)
        params["W2"] = mk((h, d), h, d)
        params["b2"] = const(d, 0.0)
        return params

    def forward(self, params, x, *, train=False, rng: Rng = None,
                mask=None):
        """x + MHA(LN1(x)), then + FFN(LN2(x)); `mask` (B, T) is the key
        mask. With `remat` the training forward is recomputed in the
        backward (`torch.utils.checkpoint`, non-reentrant) instead of
        keeping its activations; dropout masks come from `rng`, so the
        recomputation draws the same ones."""
        self._check_ported()
        if self.remat and train and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            return checkpoint(self._block_body, params, x, rng, mask, train,
                              use_reentrant=False)
        return self._block_body(params, x, rng, mask, train)

    def _block_body(self, params, x, rng, mask, train):
        from deeplearning4j_tpu_torch.ops.attention import (
            multi_head_attention,
        )

        B, T, d = x.shape
        H, Hkv = self.n_heads, self._kv_heads
        hd = d // H
        h1 = layer_norm(x, params["ln1_g"], params["ln1_b"], self.eps)
        qkv = h1 @ params["Wqkv"] + params["bqkv"]
        kvw = Hkv * hd
        q = qkv[..., :d].reshape(B, T, H, hd)
        k = qkv[..., d:d + kvw].reshape(B, T, Hkv, hd)
        v = qkv[..., d + kvw:].reshape(B, T, Hkv, hd)
        if self.rope:
            from deeplearning4j_tpu_torch.ops.rope import (
                rope_angles,
                rope_rotate,
            )

            cos, sin = rope_angles(torch.arange(T, device=x.device), hd,
                                   self.rope_base)
            q = rope_rotate(q, cos, sin)
            k = rope_rotate(k, cos, sin)
        att = multi_head_attention(q, k, v, causal=self.causal,
                                   key_mask=mask, block_size=self.block_size)
        att = att.reshape(B, T, d) @ params["Wo"] + params["bo"]
        x = x + self._maybe_dropout(att, train, rng)
        return x + self._maybe_dropout(ffn(self, params, x), train,
                                       fold_in(rng, 1))

    def param_flags(self, name):
        is_bias = name.startswith("b") or name.endswith("_b")
        norm_scale = name.endswith("_g")
        return {"is_bias": is_bias,
                "regularizable": not is_bias and not norm_scale}


def ffn(layer: TransformerBlock, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The block's FFN term on LN2(x): gelu (tanh form) or swiglu."""
    h2 = layer_norm(x, p["ln2_g"], p["ln2_b"], layer.eps)
    if layer.ffn_activation == "swiglu":
        return (F.silu(h2 @ p["W1"]) * (h2 @ p["W3"])) @ p["W2"] + p["b2"]
    return F.gelu(h2 @ p["W1"] + p["b1"], approximate="tanh") @ p["W2"] \
        + p["b2"]
