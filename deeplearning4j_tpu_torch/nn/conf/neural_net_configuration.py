"""Configuration DSL: fluent builders -> serializable network
configuration (counterpart of
`deeplearning4j_tpu/nn/conf/neural_net_configuration.py`).

`MultiLayerConfiguration.to_json` writes the JAX package's format
("deeplearning4j_tpu/MultiLayerConfiguration/v1") field for field, so
JSON round-trips between the two packages, input preprocessors
included. `build()` infers each layer's `n_in` from the input type and
inserts FeedForwardToCnn / CnnToFeedForward preprocessors where a layer
of one kind follows another, as the JAX package does.
"""
from __future__ import annotations

import enum
import json
import logging
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeConvolutionalFlat,
    InputTypeFeedForward,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer,
    DenseLayer,
    FeedForwardLayer,
    Layer,
    layer_from_json,
    layer_to_json,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    FeedForwardToCnnPreProcessor,
    InputPreProcessor,
    preprocessor_from_json,
    preprocessor_to_json,
)
from deeplearning4j_tpu_torch.nn.updater import (
    GradientNormalization,
    LearningRatePolicy,
    Updater,
    UpdaterConfig,
)
from deeplearning4j_tpu_torch.nn.weights import Distribution, WeightInit
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.losses import LossFunction


class OptimizationAlgorithm(str, enum.Enum):
    STOCHASTIC_GRADIENT_DESCENT = "stochastic_gradient_descent"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"


@dataclass
class GlobalConf:
    """Resolved global hyperparameter defaults (the Builder's fields)."""

    seed: int = 12345
    activation: Activation = Activation.SIGMOID
    weight_init: WeightInit = WeightInit.XAVIER
    dist: Optional[Distribution] = None
    bias_init: float = 0.0
    learning_rate: float = 1e-1
    bias_learning_rate: Optional[float] = None
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    dropout: float = 0.0
    use_drop_connect: bool = False
    updater: Updater = Updater.SGD
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
    optimization_algo: OptimizationAlgorithm = \
        OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
    max_num_line_search_iterations: int = 5
    iterations: int = 1
    mini_batch: bool = True
    use_regularization: bool = False


class NeuralNetConfiguration:
    """Namespace mirroring the reference class; use
    `NeuralNetConfiguration.Builder()`."""

    class Builder:
        def __init__(self):
            self._g = GlobalConf()

        def _set(self, **kw):
            for k, v in kw.items():
                setattr(self._g, k, v)
            return self

        def seed(self, s: int):
            return self._set(seed=int(s))

        def activation(self, a):
            return self._set(activation=Activation(a))

        def weight_init(self, w):
            return self._set(weight_init=WeightInit(w))

        def dist(self, d: Distribution):
            return self._set(dist=d, weight_init=WeightInit.DISTRIBUTION)

        def bias_init(self, b: float):
            return self._set(bias_init=b)

        def learning_rate(self, lr: float):
            return self._set(learning_rate=lr)

        def bias_learning_rate(self, lr: float):
            return self._set(bias_learning_rate=lr)

        def l1(self, v: float):
            return self._set(l1=v, use_regularization=True)

        def l2(self, v: float):
            return self._set(l2=v, use_regularization=True)

        def l1_bias(self, v: float):
            return self._set(l1_bias=v)

        def l2_bias(self, v: float):
            return self._set(l2_bias=v)

        def drop_out(self, p: float):
            return self._set(dropout=p)

        def use_drop_connect(self, use: bool = True):
            return self._set(use_drop_connect=use)

        def updater(self, u):
            return self._set(updater=Updater(u))

        def momentum(self, m: float):
            return self._set(momentum=m)

        def rho(self, r: float):
            return self._set(rho=r)

        def rms_decay(self, r: float):
            return self._set(rms_decay=r)

        def adam_mean_decay(self, v: float):
            return self._set(adam_mean_decay=v)

        def adam_var_decay(self, v: float):
            return self._set(adam_var_decay=v)

        def epsilon(self, e: float):
            return self._set(epsilon=e)

        def learning_rate_policy(self, p):
            return self._set(lr_policy=LearningRatePolicy(p))

        def lr_policy_decay_rate(self, r: float):
            return self._set(lr_policy_decay_rate=r)

        def lr_policy_power(self, p: float):
            return self._set(lr_policy_power=p)

        def lr_policy_steps(self, s: float):
            return self._set(lr_policy_steps=s)

        def learning_rate_schedule(self, sched: Dict[int, float]):
            return self._set(lr_schedule=dict(sched),
                             lr_policy=LearningRatePolicy.SCHEDULE)

        def gradient_normalization(self, gn):
            return self._set(gradient_normalization=GradientNormalization(gn))

        def gradient_normalization_threshold(self, t: float):
            return self._set(gradient_normalization_threshold=t)

        def optimization_algo(self, o):
            return self._set(optimization_algo=OptimizationAlgorithm(o))

        def max_num_line_search_iterations(self, n: int):
            return self._set(max_num_line_search_iterations=n)

        def iterations(self, n: int):
            return self._set(iterations=int(n))

        def mini_batch(self, b: bool):
            return self._set(mini_batch=b)

        def regularization(self, use: bool):
            return self._set(use_regularization=use)

        def list(self) -> "ListBuilder":
            return ListBuilder(self._g)

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import (  # noqa: E501
                GraphBuilder,
            )

            return GraphBuilder(self._g)


class ListBuilder:
    """Reference `NeuralNetConfiguration.ListBuilder`."""

    def __init__(self, g: GlobalConf):
        self._g = g
        self._layers: List[Layer] = []
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._backprop = True
        self._pretrain = False
        self._tbptt_fwd = -1
        self._tbptt_bwd = -1

    def layer(self, *args):
        """.layer(conf) or .layer(index, conf)."""
        if len(args) == 1:
            self._layers.append(args[0])
        else:
            idx, conf = args
            while len(self._layers) <= idx:
                self._layers.append(None)  # type: ignore
            self._layers[idx] = conf
        return self

    def input_pre_processor(self, idx: int, p: InputPreProcessor):
        self._preprocessors[idx] = p
        return self

    def set_input_type(self, it: InputType):
        self._input_type = it
        return self

    def backprop(self, b: bool):
        self._backprop = b
        return self

    def pretrain(self, p: bool):
        self._pretrain = p
        return self

    def t_bptt_forward_length(self, n: int):
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int):
        self._tbptt_bwd = n
        return self

    def build(self) -> "MultiLayerConfiguration":
        layers = [l for l in self._layers if l is not None]
        merged = [_merge_layer_defaults(l, self._g) for l in layers]
        for i, l in enumerate(merged):
            _warn_loss_activation_mismatch(l, i)
        pre = dict(self._preprocessors)
        if self._input_type is not None:
            _infer_shapes(merged, pre, self._input_type)
        return MultiLayerConfiguration(
            layers=merged,
            preprocessors=pre,
            global_conf=self._g,
            input_type=self._input_type,
            backprop=self._backprop,
            pretrain=self._pretrain,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
        )


def _warn_loss_activation_mismatch(layer: Layer, idx) -> None:
    """Cross-entropy losses over a non-probability activation train to
    garbage: warn, as the JAX package does."""
    loss = getattr(layer, "loss", None)
    if loss is None:
        return
    ok_by_loss = {
        LossFunction.MCXENT: (Activation.SOFTMAX,),
        LossFunction.XENT: (Activation.SIGMOID,),
        LossFunction.NEGATIVELOGLIKELIHOOD: (Activation.SOFTMAX,),
    }
    allowed = ok_by_loss.get(loss)
    act = layer.activation
    if allowed is not None and act is not None and act not in allowed:
        logging.getLogger("deeplearning4j_tpu_torch").warning(
            "layer %s: loss %s over activation %s — cross-entropy expects a "
            "probability output (%s); set the output layer's activation "
            "explicitly (the global default activation was applied)",
            idx, loss.value, act.value, "/".join(a.value for a in allowed))


def _merge_layer_defaults(layer: Layer, g: GlobalConf) -> Layer:
    """Fill layer Nones from the global builder."""
    l = replace(layer)
    if l.activation is None:
        l.activation = g.activation
    if l.weight_init is None:
        l.weight_init = g.weight_init
    if l.dist is None:
        l.dist = g.dist
    if l.bias_init is None:
        l.bias_init = g.bias_init
    if l.dropout is None:
        l.dropout = g.dropout
    if l.use_drop_connect is None:
        l.use_drop_connect = (g.use_drop_connect
                              if isinstance(l, DenseLayer) else False)
    elif l.use_drop_connect and not isinstance(l, DenseLayer):
        raise ValueError(
            f"use_drop_connect is only supported on dense-family layers; "
            f"{type(l).__name__} applies input dropout — set "
            "use_drop_connect=False/None for this layer")
    reg = g.use_regularization
    if l.l1 is None:
        l.l1 = g.l1 if reg else 0.0
    if l.l2 is None:
        l.l2 = g.l2 if reg else 0.0
    if l.l1_bias is None:
        l.l1_bias = g.l1_bias if reg else 0.0
    if l.l2_bias is None:
        l.l2_bias = g.l2_bias if reg else 0.0
    lr = l.learning_rate if l.learning_rate is not None else g.learning_rate
    bias_lr = (
        l.bias_learning_rate
        if l.bias_learning_rate is not None
        else (g.bias_learning_rate if g.bias_learning_rate is not None else lr)
    )
    if l.updater_cfg is None:
        l.updater_cfg = UpdaterConfig(
            updater=g.updater,
            learning_rate=lr,
            bias_learning_rate=bias_lr,
            momentum=g.momentum,
            rho=g.rho,
            rms_decay=g.rms_decay,
            adam_mean_decay=g.adam_mean_decay,
            adam_var_decay=g.adam_var_decay,
            epsilon=g.epsilon,
            lr_policy=g.lr_policy,
            lr_policy_decay_rate=g.lr_policy_decay_rate,
            lr_policy_power=g.lr_policy_power,
            lr_policy_steps=g.lr_policy_steps,
            lr_schedule=dict(g.lr_schedule),
            gradient_normalization=g.gradient_normalization,
            gradient_normalization_threshold=g.gradient_normalization_threshold,
        )
    l.learning_rate = lr
    l.bias_learning_rate = bias_lr
    return l


def _infer_shapes(layers: List[Layer], pre: Dict[int, InputPreProcessor],
                  input_type: InputType) -> None:
    """Walk the stack inferring n_in and inserting the preprocessors a
    change of layer kind needs (into `pre`, by layer index)."""
    it = input_type
    for i, layer in enumerate(layers):
        if i in pre:
            it = pre[i].output_type(it)
        else:
            p = _auto_preprocessor(layer, it)
            if p is not None:
                pre[i] = p
                it = p.output_type(it)
        if isinstance(layer, FeedForwardLayer) \
                and getattr(layer, "n_in", 0) in (0, None):
            if isinstance(it, (InputTypeFeedForward, InputTypeRecurrent)):
                layer.n_in = it.size
            elif isinstance(it, InputTypeConvolutional):
                layer.n_in = it.channels \
                    if isinstance(layer, ConvolutionLayer) \
                    else it.height * it.width * it.channels
            elif isinstance(it, InputTypeConvolutionalFlat):
                layer.n_in = it.flattened_size
        it = layer.output_type(it)


def _auto_preprocessor(layer: Layer, it: InputType
                       ) -> Optional[InputPreProcessor]:
    kind = layer.input_kind
    if kind == "cnn" and isinstance(it, InputTypeConvolutionalFlat):
        return FeedForwardToCnnPreProcessor(it.height, it.width, it.channels)
    if kind == "ff" and isinstance(it, InputTypeConvolutional):
        return CnnToFeedForwardPreProcessor(it.height, it.width, it.channels)
    if kind == "cnn" and isinstance(it, InputTypeFeedForward):
        raise ValueError(
            f"cannot feed FeedForward({it.size}) into CNN layer {layer.TYPE}; "
            "set an explicit input_pre_processor (reference: "
            "MultiLayerConfiguration preprocessor validation)")
    if kind == "rnn" and isinstance(it, InputTypeFeedForward):
        raise ValueError(
            f"cannot feed FeedForward({it.size}) into RNN layer {layer.TYPE} "
            "without a FeedForwardToRnnPreProcessor")
    return None


@dataclass
class MultiLayerConfiguration:
    """Built, fully-resolved network config."""

    layers: List[Layer]
    preprocessors: Dict[int, InputPreProcessor] = field(default_factory=dict)
    global_conf: GlobalConf = field(default_factory=GlobalConf)
    input_type: Optional[InputType] = None
    backprop: bool = True
    pretrain: bool = False
    tbptt_fwd_length: int = -1
    tbptt_bwd_length: int = -1

    @property
    def seed(self) -> int:
        return self.global_conf.seed

    def to_json(self) -> str:
        import dataclasses as dc

        g = dc.asdict(self.global_conf)
        for k, v in list(g.items()):
            if isinstance(v, enum.Enum):
                g[k] = v.value
        if self.global_conf.dist is not None:
            g["dist"] = self.global_conf.dist.to_json()
        d = {
            "format": "deeplearning4j_tpu/MultiLayerConfiguration/v1",
            "global_conf": g,
            "layers": [layer_to_json(l) for l in self.layers],
            "preprocessors": {str(k): preprocessor_to_json(p)
                              for k, p in self.preprocessors.items()},
            "input_type": self.input_type.to_json() if self.input_type else None,
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_bwd_length": self.tbptt_bwd_length,
        }
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        g = GlobalConf()
        gd = d.get("global_conf", {})
        for k, v in gd.items():
            if not hasattr(g, k) or v is None:
                continue
            cur = getattr(g, k)
            if isinstance(cur, enum.Enum):
                v = type(cur)(v)
            elif k == "dist" and isinstance(v, dict):
                v = Distribution.from_json(v)
            elif k == "lr_schedule":
                v = {int(kk): vv for kk, vv in v.items()}
            setattr(g, k, v)
        return MultiLayerConfiguration(
            layers=[layer_from_json(l) for l in d["layers"]],
            preprocessors={int(k): preprocessor_from_json(p)
                           for k, p in d.get("preprocessors", {}).items()},
            global_conf=g,
            input_type=InputType.from_json(d["input_type"])
            if d.get("input_type") else None,
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            tbptt_fwd_length=d.get("tbptt_fwd_length", -1),
            tbptt_bwd_length=d.get("tbptt_bwd_length", -1),
        )
