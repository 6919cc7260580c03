"""Layer configurations with their parameter init, forward and loss
(counterpart of `deeplearning4j_tpu/nn/conf/layers.py`): the dense,
convolution, pooling, normalization, recurrent, attention, embedding and
mixture-of-experts layers, and the pretraining family (`AutoEncoder`,
`RBM`; the VAE is `nn/conf/variational.py`).

Each config is a dataclass whose fields, field order and JSON encoding
are the JAX package's, so a configuration written by either package
parses in the other and re-serializes equal. `init_params` draws from an
explicit `torch.Generator`. `forward(params, x, train=, rng=, mask=)`
serves inference and training. A layer with `stateful = True` carries
state (`init_state`): BatchNormalization its running mean and variance,
GravesLSTM the (h, c) carry of truncated BPTT. It has
`forward_with_state(params, state, x, ...) -> (out, new_state)`, which
`MultiLayerNetwork` calls with its `_layer_state` slot. Dropout and
DropConnect are inverted, drawn from a `torch.Generator` seeded from
`rng`, a tuple of ints (the configuration's seed, the iteration, the
layer index and the dropout site): deterministic per seed, never equal
to the JAX package's threefry draws.

Layout conventions are the JAX package's: FF activations (B, F), CNN
activations NHWC with HWIO convolution weights, RNN activations
(B, T, F). cuDNN is fed the NHWC tensors as channels-last NCHW views.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeFeedForward,
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
from deeplearning4j_tpu_torch.ops.losses import LossFunction, loss_fn
from deeplearning4j_tpu_torch.util.conv_utils import (
    ConvolutionMode,
    PoolingType,
    conv_output_hw,
    explicit_padding,
)

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]
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


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as the channels-last NCHW view cuDNN takes (no
    copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _pad_hw(x: torch.Tensor, pad, value: float = 0.0) -> torch.Tensor:
    """Pad an NHWC tensor by ((top, bottom), (left, right)): asymmetric
    pads (SAME mode puts the extra one at the end) are applied as they
    are, before an unpadded convolution or pooling."""
    (t, b), (l, r) = pad
    if not (t or b or l or r):
        return x
    return F.pad(x, (0, 0, l, r, t, b), value=value)

# ---------------------------------------------------------------------------
# serde registry

_LAYER_REGISTRY: Dict[str, type] = {}

# field-name -> decoder applied on from_json
_FIELD_DECODERS: Dict[str, Callable[[Any], Any]] = {
    "activation": Activation,
    "gate_activation": Activation,
    "weight_init": WeightInit,
    "dist": Distribution.from_json,
    "expert_activation": Activation,
    "loss": LossFunction,
    "pooling_type": PoolingType,
    "convolution_mode": ConvolutionMode,
    "updater_cfg": UpdaterConfig.from_json,
    "kernel": tuple,
    "stride": tuple,
    "padding": tuple,
    "dilation": tuple,
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
        raise KeyError(f"unknown layer type {t!r} (known: "
                       f"{sorted(_LAYER_REGISTRY)})")
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
    stateful = False    # True: has forward_with_state (layer state)

    @property
    def has_params(self) -> bool:
        return True

    def output_type(self, it: InputType) -> InputType:
        raise NotImplementedError

    def init_params(self, gen: torch.Generator, it: InputType,
                    dtype=torch.float32) -> Params:
        return {}

    def init_state(self, it: InputType, device=None) -> State:
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

    def _maybe_drop_connect(self, W, train, rng: Rng):
        """DropConnect: the weight matrix takes the dropout mask instead
        of the input (inverted, so E[W] is kept), drawn from the layer's
        rng folded with 1."""
        p = self.dropout or 0.0
        if not train or p <= 0.0 or rng is None:
            return W
        return dropout(W, p, fold_in(rng, 1))

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
        W = params["W"]
        if self.use_drop_connect:  # replaces input dropout, as in DL4J
            W = self._maybe_drop_connect(W, train, rng)
        else:
            x = self._maybe_dropout(x, train, rng)
        return x @ W + params["b"]

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

    def score_array(self, params, x, labels, *, mask=None):
        """Per-example losses (B,) for `MultiLayerNetwork.score_examples`:
        the per-row losses of the inference forward, time-distributed
        (B, T) rows (masked) summed over the sequence."""
        from deeplearning4j_tpu_torch.ops.losses import loss_per_row

        pre = self.pre_output(params, x, train=False, rng=None)
        per_row = loss_per_row(self.loss,
                               self.activation or Activation.IDENTITY,
                               labels, pre)
        if mask is not None:
            per_row = per_row * mask.reshape(per_row.shape)
        if per_row.ndim > 1:
            per_row = per_row.reshape(per_row.shape[0], -1).sum(dim=-1)
        return per_row


@register_layer
@dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep output layer: (B, T, F) -> (B, T, n_out)."""

    TYPE = "rnn_output"
    input_kind = "rnn"

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length if isinstance(it, InputTypeRecurrent) else -1
        return InputType.recurrent(self.n_out, t)


@register_layer
@dataclass
class LossLayer(Layer):
    """Parameter-free loss head: the activation of its input, scored
    against the labels."""

    TYPE = "loss"
    loss: LossFunction = LossFunction.MCXENT

    @property
    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return it

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        return self._act()(x)

    def pre_output(self, params, x, *, train=False, rng: Rng = None):
        return x

    loss_score = OutputLayer.loss_score
    score_array = OutputLayer.score_array


# ---------------------------------------------------------------------------
# convolutional


@register_layer
@dataclass
class ConvolutionLayer(FeedForwardLayer):
    """2D convolution, NHWC activations and HWIO weights. The padding of
    `convolution_mode` (SAME: asymmetric, the extra pad at the end) is
    applied first, then cuDNN convolves unpadded through
    `F.conv2d` on channels-last views."""

    TYPE = "convolution"
    input_kind = "cnn"
    n_in: int = 0   # in channels (inferred from the input type if 0)
    n_out: int = 0  # out channels
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE

    def _in_channels(self, it: InputType) -> int:
        if isinstance(it, InputTypeConvolutional):
            return it.channels
        return self.n_in

    def output_type(self, it: InputType) -> InputType:
        assert isinstance(it, InputTypeConvolutional), \
            f"conv needs CNN input, got {it}"
        oh, ow = conv_output_hw((it.height, it.width), self.kernel,
                                self.stride, self.padding,
                                self.convolution_mode, self.dilation)
        return InputType.convolutional(oh, ow, self.n_out)

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        cin = self._in_channels(it)
        kh, kw = self.kernel
        W = self._winit(gen, (kh, kw, cin, self.n_out), cin * kh * kw,
                        self.n_out * kh * kw, dtype)
        b = torch.full((self.n_out,), float(self.bias_init or 0.0),
                       dtype=dtype, device=gen.device)
        return {"W": W, "b": b}

    def pre_output(self, params, x, *, train=False, rng: Rng = None):
        x = self._maybe_dropout(x, train, rng)
        pad = explicit_padding((x.shape[1], x.shape[2]), self.kernel,
                               self.stride, self.padding,
                               self.convolution_mode, self.dilation)
        w = params["W"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        y = F.conv2d(_nchw(_pad_hw(x, pad)), w, stride=tuple(self.stride),
                     dilation=tuple(self.dilation))
        return _nhwc(y) + params["b"]

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        return self._act()(self.pre_output(params, x, train=train, rng=rng))


@register_layer
@dataclass
class SubsamplingLayer(Layer):
    """Pooling over NHWC windows: MAX pads with -inf, AVG divides by the
    whole window (pads included), SUM and PNORM pad with 0; the pads are
    applied first and the pooling runs unpadded."""

    TYPE = "subsampling"
    input_kind = "cnn"
    pooling_type: PoolingType = PoolingType.MAX
    kernel: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    pnorm: int = 2

    @property
    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        assert isinstance(it, InputTypeConvolutional)
        oh, ow = conv_output_hw((it.height, it.width), self.kernel,
                                self.stride, self.padding,
                                self.convolution_mode)
        return InputType.convolutional(oh, ow, it.channels)

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        pad = explicit_padding((x.shape[1], x.shape[2]), self.kernel,
                               self.stride, self.padding,
                               self.convolution_mode)
        k, st = tuple(self.kernel), tuple(self.stride)
        pt = self.pooling_type
        if pt == PoolingType.MAX:
            xp = _pad_hw(x, pad, float("-inf"))
            return _nhwc(F.max_pool2d(_nchw(xp), k, st))
        area = k[0] * k[1]
        if pt == PoolingType.AVG:
            return _nhwc(F.avg_pool2d(_nchw(_pad_hw(x, pad)), k, st))
        if pt == PoolingType.SUM:
            return _nhwc(F.avg_pool2d(_nchw(_pad_hw(x, pad)), k, st)) * area
        if pt == PoolingType.PNORM:
            p = float(self.pnorm)
            s = F.avg_pool2d(_nchw(_pad_hw(x.abs() ** p, pad)), k, st) * area
            return _nhwc(s ** (1.0 / p))
        raise ValueError(pt)


# ---------------------------------------------------------------------------
# normalization


@register_layer
@dataclass
class BatchNormalization(FeedForwardLayer):
    """Batch normalization over every axis but the last. Its running
    mean and variance are layer state (f32). Training normalizes by the
    batch statistics, computed in >= f32 as one shifted pass around the
    running mean (var = E[(x-m0)^2] - (mean-m0)^2, the biased batch
    variance), and moves the running stats by
    new = decay * old + (1 - decay) * batch; inference normalizes by the
    running stats. The normalization is one x * scale + bias in the
    activation dtype. (`F.batch_norm` keeps the unbiased variance and
    takes momentum = 1 - decay: not this layer's arithmetic.)"""

    TYPE = "batchnorm"
    stateful = True
    n_in: int = 0
    n_out: int = 0
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False

    def output_type(self, it: InputType) -> InputType:
        return it

    def _nf(self, it: Optional[InputType]) -> int:
        if isinstance(it, InputTypeConvolutional):
            return it.channels
        if isinstance(it, (InputTypeRecurrent, InputTypeFeedForward)):
            return it.size
        n = self.n_out or self.n_in
        if not n:
            raise ValueError(
                "BatchNormalization needs either a resolved InputType "
                "(set_input_type(s) on the builder) or an explicit n_in/n_out")
        return n

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        if self.lock_gamma_beta:
            return {}
        nf = self._nf(it)
        return {"gamma": torch.ones((nf,), dtype=dtype, device=gen.device),
                "beta": torch.zeros((nf,), dtype=dtype, device=gen.device)}

    def init_state(self, it: InputType, device=None) -> State:
        nf = self._nf(it)
        return {"mean": torch.zeros((nf,), dtype=torch.float32,
                                    device=device),
                "var": torch.ones((nf,), dtype=torch.float32, device=device)}

    def forward_with_state(self, params, state, x, *, train=False,
                           rng: Rng = None, mask=None):
        axes = tuple(range(x.ndim - 1))
        sdt = stat_dtype(x.dtype)
        if train:
            m0 = state["mean"].detach().to(x.dtype)
            xc = x - m0
            mean_c = torch.mean(xc, dim=axes, dtype=sdt)
            msq_c = torch.mean(xc * xc, dim=axes, dtype=sdt)
            var = torch.clamp(msq_c - mean_c * mean_c, min=0.0)
            mean = mean_c + m0.to(sdt)
            d = self.decay
            new_state = {"mean": d * state["mean"] + (1 - d) * mean,
                         "var": d * state["var"] + (1 - d) * var}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        scale = torch.rsqrt(var.to(sdt) + self.eps)
        if not self.lock_gamma_beta:
            scale = scale * params["gamma"].to(sdt)
        bias = -mean.to(sdt) * scale
        if not self.lock_gamma_beta:
            bias = bias + params["beta"].to(sdt)
        y = x * scale.to(x.dtype) + bias.to(x.dtype)
        return self._act()(y), new_state

    def param_flags(self, name):
        # gamma/beta: no l1/l2
        return {"is_bias": name == "beta", "regularizable": False}


@register_layer
@dataclass
class LocalResponseNormalization(Layer):
    """Across-channel LRN: y = x / (k + alpha * sum_{window n} x^2)^beta,
    the window padded (n // 2, n - 1 - n // 2) over the channels. alpha
    is not divided by n (`F.local_response_norm` divides it)."""

    TYPE = "lrn"
    input_kind = "cnn"
    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    @property
    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return it

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        half = self.n // 2
        C = x.shape[-1]
        sq = F.pad(x * x, (half, self.n - 1 - half))
        s = sq[..., 0:C]
        for i in range(1, self.n):
            s = s + sq[..., i:i + C]
        return x / (self.k + self.alpha * s) ** self.beta


# ---------------------------------------------------------------------------
# recurrent


@register_layer
@dataclass
class GravesLSTM(FeedForwardLayer):
    """Graves-style peephole LSTM (gate order [i, f, o, g]). The math is
    `nn/layers/recurrent.py`: the fused LSTM kernels for a sigmoid gate
    and a tanh cell, the plain time loop otherwise. Layer state: the
    (h, c) carry {"h", "c"} when the network seeds one (truncated BPTT);
    empty otherwise."""

    TYPE = "graves_lstm"
    input_kind = "rnn"
    stateful = True
    n_in: int = 0
    n_out: int = 0
    gate_activation: Activation = Activation.SIGMOID
    forget_gate_bias_init: float = 1.0

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length if isinstance(it, InputTypeRecurrent) else -1
        return InputType.recurrent(self.n_out, t)

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        n_in, n_out = self.n_in, self.n_out
        W = self._winit(gen, (n_in, 4 * n_out), n_in, n_out, dtype)
        RW = self._winit(gen, (n_out, 4 * n_out), n_out, n_out, dtype)
        b = torch.zeros((4 * n_out,), dtype=dtype, device=gen.device)
        # the forget gate's slice of the bias
        b[n_out:2 * n_out] = self.forget_gate_bias_init
        zero = lambda: torch.zeros((n_out,), dtype=dtype, device=gen.device)
        return {"W": W, "RW": RW, "b": b, "pI": zero(), "pF": zero(),
                "pO": zero()}

    def param_flags(self, name):
        return {"is_bias": name == "b", "regularizable": name in ("W", "RW")}

    def _acts(self):
        return (activation_fn(self.gate_activation),
                activation_fn(self.activation or Activation.TANH))

    def _act_kinds(self):
        """Whether the gate is a sigmoid and the cell a tanh: the fused
        route's condition."""
        return (self.gate_activation == Activation.SIGMOID,
                (self.activation or Activation.TANH) == Activation.TANH)

    def _run(self, p, x, h0, c0, mask, reverse):
        from deeplearning4j_tpu_torch.nn.layers.recurrent import lstm_forward

        gk, ck = self._act_kinds()
        return lstm_forward(x, p["W"], p["RW"], p["b"],
                            (p["pI"], p["pF"], p["pO"]), *self._acts(),
                            h0, c0, mask, reverse=reverse,
                            gate_is_sigmoid=gk, cell_is_tanh=ck)

    def forward_with_state(self, params, state, x, *, train=False,
                           rng: Rng = None, mask=None):
        """(out, new_state): with a seeded state the carry starts from
        state["h"], state["c"] and the new state is the final carry."""
        x = self._maybe_dropout(x, train, rng)
        h0 = state.get("h") if state else None
        c0 = state.get("c") if state else None
        out, (hT, cT) = self._run(params, x, h0, c0, mask, False)
        return out, ({"h": hT, "c": cT} if state else state)

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        return self.forward_with_state(params, None, x, train=train, rng=rng,
                                       mask=mask)[0]

    def step(self, params, x_t, h_prev, c_prev):
        """One timestep of streaming inference (`rnn_time_step`)."""
        from deeplearning4j_tpu_torch.nn.layers.recurrent import lstm_step

        peep = (params["pI"], params["pF"], params["pO"])
        return lstm_step(x_t, params["W"], params["RW"], params["b"], peep,
                         *self._acts(), h_prev, c_prev)


@register_layer
@dataclass
class GravesBidirectionalLSTM(GravesLSTM):
    """Bidirectional Graves LSTM: the sum of a forward and a reversed
    pass, with parameters `<name>_f` and `<name>_b`. Carries no state."""

    TYPE = "graves_bidirectional_lstm"
    stateful = False

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        f = GravesLSTM.init_params(self, gen, it, dtype)
        bwd = GravesLSTM.init_params(self, gen, it, dtype)
        out = {f"{k}_f": v for k, v in f.items()}
        out.update({f"{k}_b": v for k, v in bwd.items()})
        return out

    def param_flags(self, name):
        base = name[:-2]  # strip _f/_b
        return {"is_bias": base == "b", "regularizable": base in ("W", "RW")}

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        x = self._maybe_dropout(x, train, rng)
        side = lambda s: {k[:-2]: v for k, v in params.items()
                          if k.endswith(s)}
        out_f, _ = self._run(side("_f"), x, None, None, mask, False)
        out_b, _ = self._run(side("_b"), x, None, None, mask, True)
        return out_f + out_b


@register_layer
@dataclass
class SelfAttention(FeedForwardLayer):
    """Multi-head self-attention over a sequence, (B, T, n_in) ->
    (B, T, n_out), through `ops.attention.multi_head_attention`: an
    unmasked sequence longer than `block_size` takes the flash kernels
    (non-causal unless `causal`), others blockwise or full attention.
    Grouped-query K/V (`n_kv_heads`) need `project_input`."""

    TYPE = "self_attention"
    input_kind = "rnn"
    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    n_kv_heads: int = 0
    causal: bool = False
    block_size: Optional[int] = 1024
    project_input: bool = True

    def __post_init__(self):
        if not self.project_input and self.n_out not in (0, self.n_in):
            raise ValueError(
                f"project_input=False requires n_out == n_in (or 0); got "
                f"n_in={self.n_in}, n_out={self.n_out}")
        qkv = self.n_out or self.n_in if self.project_input else self.n_in
        if qkv % self.n_heads != 0:
            raise ValueError(f"attention width {qkv} not divisible by "
                             f"n_heads={self.n_heads}")
        if self.n_kv_heads:
            if self.n_kv_heads < 0:
                raise ValueError(f"n_kv_heads must be >= 0, got "
                                 f"{self.n_kv_heads}")
            if not self.project_input:
                raise ValueError("n_kv_heads requires project_input=True")
            if self.n_heads % self.n_kv_heads:
                raise ValueError(
                    f"n_heads {self.n_heads} not divisible by n_kv_heads "
                    f"{self.n_kv_heads}")

    @property
    def _width(self) -> int:
        return self.n_out or self.n_in

    @property
    def _kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length if isinstance(it, InputTypeRecurrent) else -1
        return InputType.recurrent(self._width, t)

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        w = self._width
        kvw = self._kv_heads * (w // self.n_heads)
        zero = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
        p = {}
        if self.project_input:
            for name, cols in (("Wq", w), ("Wk", kvw), ("Wv", kvw)):
                p[name] = self._winit(gen, (self.n_in, cols), self.n_in,
                                      cols, dtype)
            p["bq"], p["bk"], p["bv"] = zero(w), zero(kvw), zero(kvw)
        p["Wo"] = self._winit(gen, (w, w), w, w, dtype)
        p["bo"] = zero(w)
        return p

    def param_flags(self, name):
        is_bias = name.startswith("b")
        return {"is_bias": is_bias, "regularizable": not is_bias}

    def _heads(self, x, n_heads=None):
        B, T, _ = x.shape
        return x.reshape(B, T, n_heads or self.n_heads, -1)

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        from deeplearning4j_tpu_torch.ops.attention import (
            multi_head_attention,
        )

        x = self._maybe_dropout(x, train, rng)
        if self.project_input:
            Hkv = self._kv_heads
            q = self._heads(x @ params["Wq"] + params["bq"])
            k = self._heads(x @ params["Wk"] + params["bk"], Hkv)
            v = self._heads(x @ params["Wv"] + params["bv"], Hkv)
        else:
            q = k = v = self._heads(x)
        out = multi_head_attention(q, k, v, causal=self.causal, key_mask=mask,
                                   block_size=self.block_size)
        B, T = out.shape[:2]
        out = out.reshape(B, T, -1) @ params["Wo"] + params["bo"]
        return self._act()(out)


# ---------------------------------------------------------------------------
# embedding / dropout / activation / pooling


@register_layer
@dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Embedding lookup of int ids (B,) or (B, 1): act(W[ids] + b)."""

    TYPE = "embedding"
    input_kind = "ff"
    integer_input = True
    n_in: int = 0
    n_out: int = 0

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        W = self._winit(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                        dtype)
        b = torch.full((self.n_out,), float(self.bias_init or 0.0),
                       dtype=dtype, device=gen.device)
        return {"W": W, "b": b}

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        idx = x.long()
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        return self._act()(params["W"][idx] + params["b"])


@register_layer
@dataclass
class DropoutLayer(Layer):
    """Standalone (inverted) dropout."""

    TYPE = "dropout_layer"

    @property
    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return it

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        return self._maybe_dropout(x, train, rng)


@register_layer
@dataclass
class ActivationLayer(Layer):
    """Standalone activation."""

    TYPE = "activation_layer"

    @property
    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return it

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        return self._act()(x)


@register_layer
@dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over time ((B, T, F), with the (B, T) mask: masked
    steps never win a MAX, add nothing to SUM/PNORM and AVG divides by
    the unmasked count, at least 1) or over space ((B, H, W, C))."""

    TYPE = "global_pooling"
    pooling_type: PoolingType = PoolingType.MAX
    pnorm: int = 2

    @property
    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        if isinstance(it, InputTypeRecurrent):
            return InputType.feed_forward(it.size)
        if isinstance(it, InputTypeConvolutional):
            return InputType.feed_forward(it.channels)
        return it

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        if x.ndim == 3:
            axes = (1,)
            m = None if mask is None else mask[:, :, None].to(x.dtype)
        elif x.ndim == 4:
            axes, m = (1, 2), None
        else:
            raise ValueError(f"global pooling needs 3d/4d input, got "
                             f"{tuple(x.shape)}")
        pt = self.pooling_type
        if pt == PoolingType.MAX:
            xm = x if m is None else x.masked_fill(m <= 0, float("-inf"))
            return xm.amax(dim=axes)
        if pt == PoolingType.SUM:
            return (x if m is None else x * m).sum(dim=axes)
        if pt == PoolingType.AVG:
            if m is None:
                return x.mean(dim=axes)
            return (x * m).sum(dim=axes) / m.sum(dim=axes).clamp(min=1.0)
        if pt == PoolingType.PNORM:
            p = float(self.pnorm)
            xs = x.abs() ** p if m is None else (x.abs() * m) ** p
            return xs.sum(dim=axes) ** (1.0 / p)
        raise ValueError(pt)


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


@register_layer
@dataclass
class TransformerBlock(FeedForwardLayer):
    """Pre-LN transformer block: x + MHA(LN(x)), then x + FFN(LN(x)).
    Dense gelu (tanh form) or swiglu FFN, or with `moe_experts` > 0 a
    Switch mixture of experts (gelu experts, `parallel.experts.
    switch_ffn`, its load-balancing loss added to the training loss);
    grouped-query attention (`n_kv_heads`) and rotary embeddings
    (`rope`)."""

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
        if self.ffn_activation == "swiglu" and self.moe_experts > 0:
            raise ValueError("swiglu applies to the dense FFN only; the "
                             "Switch-MoE expert FFN keeps gelu")

    @property
    def _d(self) -> int:
        return self.n_out or self.n_in

    @property
    def _kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def output_type(self, it: InputType) -> InputType:
        return it

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
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
                  "ln2_g": const(d, 1.0), "ln2_b": const(d, 0.0)}
        E = self.moe_experts
        if E > 0:  # Switch experts, stacked on axis 0
            params.update({"router": mk((d, E), d, E),
                           "W1": mk((E, d, h), d, h),
                           "b1": torch.zeros((E, h), dtype=dtype, device=dev),
                           "W2": mk((E, h, d), h, d),
                           "b2": torch.zeros((E, d), dtype=dtype,
                                             device=dev)})
            return params
        params["W1"] = mk((d, h), d, h)
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
        mask. With `remat` the training forward of a dense block is
        recomputed in the backward (`torch.utils.checkpoint`,
        non-reentrant) instead of keeping its activations; dropout masks
        come from `rng`, so the recomputation draws the same ones. An MoE
        block is never recomputed: its load-balancing term would be added
        twice."""
        if self.remat and self.moe_experts == 0 and train \
                and torch.is_grad_enabled():
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
        return x + self._maybe_dropout(ffn(self, params, x, mask=mask,
                                           train=train), train,
                                       fold_in(rng, 1))

    def param_flags(self, name):
        is_bias = name.startswith("b") or name.endswith("_b")
        norm_scale = name.endswith("_g")
        return {"is_bias": is_bias,
                "regularizable": not is_bias and not norm_scale}


def ffn(layer: TransformerBlock, p: Params, x: torch.Tensor, *,
        mask=None, train: bool = False) -> torch.Tensor:
    """The block's FFN term on LN2(x): gelu (tanh form), swiglu, or the
    Switch experts over the flattened tokens with `passthrough="zero"`
    (the block adds its own residual, so a dropped token's term is 0;
    `mask` (B, T) keeps padding out of the routing; `train` adds the
    load-balancing loss)."""
    h2 = layer_norm(x, p["ln2_g"], p["ln2_b"], layer.eps)
    if layer.moe_experts > 0:
        from deeplearning4j_tpu_torch.parallel.experts import switch_ffn

        lead = h2.shape[:-1]
        return switch_ffn(p, h2.reshape(-1, h2.shape[-1]),
                          act=lambda t: F.gelu(t, approximate="tanh"),
                          capacity_factor=layer.moe_capacity_factor,
                          aux_weight=layer.moe_aux_weight,
                          token_mask=None if mask is None
                          else mask.reshape(-1),
                          train=train,
                          passthrough="zero").reshape(*lead, -1)
    if layer.ffn_activation == "swiglu":
        return (F.silu(h2 @ p["W1"]) * (h2 @ p["W3"])) @ p["W2"] + p["b2"]
    return F.gelu(h2 @ p["W1"] + p["b1"], approximate="tanh") @ p["W2"] \
        + p["b2"]


@register_layer
@dataclass
class MoELayer(FeedForwardLayer):
    """Switch-style top-1 mixture-of-experts FFN: (B, T, D) or (B, D) ->
    the same shape; the router picks one expert per token, overflow
    tokens pass through (`parallel.experts.switch_ffn`, global capacity
    over the flattened tokens); the load-balancing loss joins the
    training loss. `expert_axis` names the expert-parallel mesh axis of
    the JAX package; with no mesh (the only case the port has: the
    sharded path is ROADMAP queue A12) the layer runs replicated."""

    TYPE = "moe"
    input_kind = "rnn"
    n_in: int = 0
    n_out: int = 0
    n_experts: int = 4
    hidden_mult: int = 4
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    expert_axis: Optional[str] = None
    # its own field, so the builder's global activation cannot change it
    expert_activation: Activation = Activation.RELU

    def __post_init__(self):
        if self.n_in and self.n_out and self.n_in != self.n_out:
            raise ValueError("MoELayer keeps width: n_in == n_out")

    @property
    def _d(self) -> int:
        return self.n_out or self.n_in

    def output_type(self, it: InputType) -> InputType:
        return it

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        d = self._d
        h = d * self.hidden_mult
        E = self.n_experts
        return {
            "router": self._winit(gen, (d, E), d, E, dtype),
            "W1": self._winit(gen, (E, d, h), d, h, dtype),
            "b1": torch.zeros((E, h), dtype=dtype, device=gen.device),
            "W2": self._winit(gen, (E, h, d), h, d, dtype),
            "b2": torch.zeros((E, d), dtype=dtype, device=gen.device),
        }

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        from deeplearning4j_tpu_torch.parallel.experts import switch_ffn

        x = self._maybe_dropout(x, train, rng)
        shape = x.shape
        # padding tokens neither route, take capacity nor weigh the loss
        token_mask = (mask.reshape(-1) if mask is not None
                      and len(shape) == 3 else None)
        y = switch_ffn(params, x.reshape(-1, shape[-1]),
                       act=activation_fn(self.expert_activation),
                       capacity_factor=self.capacity_factor,
                       aux_weight=self.aux_loss_weight,
                       token_mask=token_mask, train=train)
        return y.reshape(shape)

    def param_flags(self, name):
        is_bias = name.startswith("b")
        return {"is_bias": is_bias, "regularizable": not is_bias}


# ---------------------------------------------------------------------------
# pretraining layers: a `pretrain_loss(params, x, rng)` each, which
# `MultiLayerNetwork.pretrain` minimises layer by layer; `rng` is a
# torch.Generator on x's device, or None for the deterministic route
# (no corruption, Gibbs chains on means)


@register_layer
@dataclass
class AutoEncoder(FeedForwardLayer):
    """Denoising autoencoder: act(x W + b) forward; pretraining
    reconstructs act(h W^T + vb) from an input whose elements are zeroed
    with probability `corruption_level`, scored by `loss` against the
    clean input."""

    TYPE = "autoencoder"
    input_kind = "ff"
    n_in: int = 0
    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: LossFunction = LossFunction.MSE

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        W = self._winit(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                        dtype)
        return {"W": W,
                "b": torch.zeros((self.n_out,), dtype=dtype,
                                 device=gen.device),
                "vb": torch.zeros((self.n_in,), dtype=dtype,
                                  device=gen.device)}

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        x = self._maybe_dropout(x, train, rng)
        return self._act()(x @ params["W"] + params["b"])

    def pretrain_loss(self, params, x, rng=None):
        if self.corruption_level > 0 and rng is not None:
            keep = torch.rand(x.shape, generator=rng, device=x.device) \
                < 1.0 - self.corruption_level
            xc = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
        else:
            xc = x
        act = self._act()
        h = act(xc @ params["W"] + params["b"])
        recon = act(h @ params["W"].T + params["vb"])
        return loss_fn(self.loss)(x, recon)


class HiddenUnit(str, enum.Enum):
    BINARY = "binary"
    GAUSSIAN = "gaussian"
    RECTIFIED = "rectified"
    SOFTMAX = "softmax"


class VisibleUnit(str, enum.Enum):
    BINARY = "binary"
    GAUSSIAN = "gaussian"
    SOFTMAX = "softmax"
    LINEAR = "linear"


def _bernoulli(mean, gen):
    return torch.bernoulli(mean, generator=gen).to(mean.dtype)


def _normal_like(pre, gen):
    return torch.randn(pre.shape, generator=gen, dtype=pre.dtype,
                       device=pre.device)


@register_layer
@dataclass
class RBM(FeedForwardLayer):
    """Restricted Boltzmann machine trained by contrastive divergence
    (CD-k): the update is the gradient of the free-energy surrogate
    F(v_data) - F(detach(v_model)), v_model the mean-field end of a k-step
    Gibbs chain from the data, so autograd gives the CD-k gradient."""

    TYPE = "rbm"
    input_kind = "ff"
    n_in: int = 0
    n_out: int = 0
    hidden_unit: HiddenUnit = HiddenUnit.BINARY
    visible_unit: VisibleUnit = VisibleUnit.BINARY
    k: int = 1
    sparsity: float = 0.0

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    init_params = AutoEncoder.init_params

    def forward(self, params, x, *, train=False, rng: Rng = None, mask=None):
        x = self._maybe_dropout(x, train, rng)
        act = self._act() if self.activation is not None else torch.sigmoid
        return act(x @ params["W"] + params["b"])

    # -- Gibbs machinery: (mean, sample); gen None samples the mean ------
    def _h_given_v(self, params, v, gen):
        pre = v @ params["W"] + params["b"]
        u = HiddenUnit(self.hidden_unit)
        if u == HiddenUnit.BINARY:
            mean = torch.sigmoid(pre)
            return mean, mean if gen is None else _bernoulli(mean, gen)
        if u == HiddenUnit.RECTIFIED:
            mean = torch.relu(pre)
            if gen is None:
                return mean, mean
            # NReLU: relu(pre + N(0, sigmoid(pre)))
            noise = _normal_like(pre, gen) * torch.sqrt(torch.sigmoid(pre))
            return mean, torch.relu(pre + noise)
        if u == HiddenUnit.GAUSSIAN:
            return pre, pre if gen is None else pre + _normal_like(pre, gen)
        if u == HiddenUnit.SOFTMAX:
            mean = torch.softmax(pre, dim=-1)
            return mean, mean
        raise ValueError(self.hidden_unit)

    def _v_given_h(self, params, h, gen):
        pre = h @ params["W"].T + params["vb"]
        u = VisibleUnit(self.visible_unit)
        if u == VisibleUnit.BINARY:
            mean = torch.sigmoid(pre)
            return mean, mean if gen is None else _bernoulli(mean, gen)
        if u == VisibleUnit.GAUSSIAN:
            return pre, pre if gen is None else pre + _normal_like(pre, gen)
        if u == VisibleUnit.SOFTMAX:
            mean = torch.softmax(pre, dim=-1)
            return mean, mean
        if u == VisibleUnit.LINEAR:
            return pre, pre
        raise ValueError(self.visible_unit)

    def free_energy(self, params, v):
        """F(v) per row. Hidden term: BINARY and RECTIFIED sum
        softplus(pre), GAUSSIAN sum pre^2 / 2, SOFTMAX logsumexp(pre).
        Visible term: BINARY and SOFTMAX -v.vb, GAUSSIAN and LINEAR
        sum (v - vb)^2 / 2."""
        pre = v @ params["W"] + params["b"]
        hu = HiddenUnit(self.hidden_unit)
        if hu == HiddenUnit.GAUSSIAN:
            hidden_term = 0.5 * torch.sum(pre ** 2, dim=-1)
        elif hu == HiddenUnit.SOFTMAX:
            hidden_term = torch.logsumexp(pre, dim=-1)
        else:  # BINARY, RECTIFIED
            hidden_term = torch.sum(F.softplus(pre), dim=-1)
        if VisibleUnit(self.visible_unit) in (VisibleUnit.GAUSSIAN,
                                              VisibleUnit.LINEAR):
            vis_term = 0.5 * torch.sum((v - params["vb"]) ** 2, dim=-1)
            return vis_term - hidden_term
        return -(v @ params["vb"]) - hidden_term

    def gibbs_chain(self, params, v0, rng, k: int):
        """The mean-field visible reconstruction after k Gibbs steps from
        v0 (each step samples h, then v, from `rng`)."""
        if k < 1:
            raise ValueError(f"RBM contrastive divergence needs k >= 1, "
                             f"got k={k}")
        v = v0
        for _ in range(k):
            _, h = self._h_given_v(params, v, rng)
            v_mean, v = self._v_given_h(params, h, rng)
        return v_mean

    def pretrain_loss(self, params, x, rng=None):
        with torch.no_grad():
            vk = self.gibbs_chain(params, x, rng, self.k)
        cd = torch.mean(self.free_energy(params, x)
                        - self.free_energy(params, vk))
        if self.sparsity > 0:
            h_mean, _ = self._h_given_v(params, x, None)
            cd = cd + self.sparsity * torch.mean(
                (torch.mean(h_mean, dim=0) - self.sparsity) ** 2)
        return cd

    def reconstruction_error(self, params, x, rng=None) -> float:
        """The mean-field reconstruction's error: cross-entropy for binary
        visible units, squared error otherwise (the score the reference
        reports)."""
        with torch.no_grad():
            _, h = self._h_given_v(params, x, None)
            v_mean, _ = self._v_given_h(params, h, None)
            v_mean = torch.clamp(v_mean, 1e-7, 1 - 1e-7)
            if VisibleUnit(self.visible_unit) == VisibleUnit.BINARY:
                return float(-torch.mean(torch.sum(
                    x * torch.log(v_mean) + (1 - x) * torch.log(1 - v_mean),
                    dim=-1)))
            return float(torch.mean(torch.sum((x - v_mean) ** 2, dim=-1)))


_FIELD_DECODERS["hidden_unit"] = HiddenUnit
_FIELD_DECODERS["visible_unit"] = VisibleUnit
