"""Keras model import: HDF5 / JSON → the port's network config + weights.

Reference: `deeplearning4j-modelimport/src/main/java/org/deeplearning4j/nn/
modelimport/keras/` — `KerasModelImport.java` (entry points),
`KerasModel.java:57` (config mapping :153-273), `KerasSequentialModel.java`,
`KerasLayer.java` (per-layer-type translation). The reference reads HDF5 via
JavaCPP hdf5 presets; here we read with h5py on the host — model import is
pure host-side ETL, the resulting network then runs like any
natively-built one. (Counterpart of `deeplearning4j_tpu/modelimport/keras.py`:
the translation is the JAX package's, copied; the weights land in the
port's torch parameters on the network's device, the card by default.
A Keras LSTM becomes a `GravesLSTM` with zero peepholes; with sigmoid
gates and a tanh cell it runs the fused LSTM kernels, with any other gate,
such as Keras 1's default `hard_sigmoid`, the step loop, by design
(`nn.layers.recurrent.lstm_forward`).)

Supports both Keras 1.x ("th"/"tf" dim orderings, per-gate LSTM weights) and
Keras 2.x (channels_first/channels_last, fused LSTM kernels) HDF5 files, for
Sequential (→ MultiLayerNetwork) and functional Model (→ ComputationGraph)
architectures.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import (
    ElementWiseOp,
    ElementWiseVertex,
    GraphBuilder,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    ConvolutionMode,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    GlobalPoolingLayer,
    GravesLSTM,
    Layer,
    OutputLayer,
    PoolingType,
    RnnOutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.losses import LossFunction


class InvalidKerasConfigurationException(ValueError):
    """Malformed Keras config (reference
    `InvalidKerasConfigurationException.java`)."""


class UnsupportedKerasConfigurationException(ValueError):
    """Valid Keras config using features we don't map (reference
    `UnsupportedKerasConfigurationException.java`)."""


# ---------------------------------------------------------------------------
# mappings

_ACTIVATIONS: Dict[str, Activation] = {
    "linear": Activation.IDENTITY,
    "relu": Activation.RELU,
    "softmax": Activation.SOFTMAX,
    "sigmoid": Activation.SIGMOID,
    "hard_sigmoid": Activation.HARDSIGMOID,
    "tanh": Activation.TANH,
    "softplus": Activation.SOFTPLUS,
    "softsign": Activation.SOFTSIGN,
    "elu": Activation.ELU,
    "selu": Activation.SELU,
    "gelu": Activation.GELU,
    "swish": Activation.SWISH,
}

_LOSSES: Dict[str, LossFunction] = {
    "categorical_crossentropy": LossFunction.MCXENT,
    "sparse_categorical_crossentropy": LossFunction.MCXENT,
    "binary_crossentropy": LossFunction.XENT,
    "mean_squared_error": LossFunction.MSE,
    "mse": LossFunction.MSE,
    "mean_absolute_error": LossFunction.MEAN_ABSOLUTE_ERROR,
    "mae": LossFunction.MEAN_ABSOLUTE_ERROR,
    "mean_absolute_percentage_error": LossFunction.MEAN_ABSOLUTE_PERCENTAGE_ERROR,
    "mean_squared_logarithmic_error": LossFunction.MEAN_SQUARED_LOGARITHMIC_ERROR,
    "squared_hinge": LossFunction.SQUARED_HINGE,
    "hinge": LossFunction.HINGE,
    "kullback_leibler_divergence": LossFunction.KL_DIVERGENCE,
    "kld": LossFunction.KL_DIVERGENCE,
    "poisson": LossFunction.POISSON,
    "cosine_proximity": LossFunction.COSINE_PROXIMITY,
}


def map_activation(name: Optional[str]) -> Activation:
    if not name:
        return Activation.IDENTITY
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise UnsupportedKerasConfigurationException(
            f"unknown Keras activation {name!r}") from None


def map_loss(name: str) -> LossFunction:
    try:
        return _LOSSES[name]
    except KeyError:
        raise UnsupportedKerasConfigurationException(
            f"unknown Keras loss {name!r}") from None


def _pair(v, default=None) -> Tuple[int, int]:
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _conv_mode(cfg: dict) -> ConvolutionMode:
    mode = cfg.get("border_mode") or cfg.get("padding") or "valid"
    if mode == "valid":
        return ConvolutionMode.TRUNCATE
    if mode == "same":
        return ConvolutionMode.SAME
    raise UnsupportedKerasConfigurationException(
        f"unsupported Keras border mode {mode!r}")


def _dim_ordering(cfg: dict) -> str:
    """'th' (channels_first, NCHW) or 'tf' (channels_last, NHWC)."""
    v = cfg.get("dim_ordering") or cfg.get("data_format")
    if v in ("th", "channels_first"):
        return "th"
    return "tf"


def _input_type_from_shape(shape: Sequence[Optional[int]],
                           ordering: str) -> InputType:
    """batch_input_shape (batch dim stripped) → InputType."""
    dims = [d for d in shape]
    if len(dims) == 3:  # image
        if ordering == "th":
            c, h, w = dims
        else:
            h, w, c = dims
        return InputType.convolutional(int(h), int(w), int(c))
    if len(dims) == 2:  # time series (T, F)
        t, f = dims
        return InputType.recurrent(int(f), int(t) if t else -1)
    if len(dims) == 1:
        return InputType.feed_forward(int(dims[0]))
    raise UnsupportedKerasConfigurationException(
        f"cannot infer InputType from input shape {shape!r}")


# ---------------------------------------------------------------------------
# per-layer translation (reference KerasLayer per-type translation)


def _units(cfg: dict, class_name: str) -> int:
    v = cfg.get("output_dim") or cfg.get("units") or cfg.get("nb_filter") \
        or cfg.get("filters")
    if v is None:
        raise InvalidKerasConfigurationException(
            f"{class_name} config has no output_dim/units/filters")
    return int(v)


def map_keras_layer(class_name: str, cfg: dict) -> Optional[Layer]:
    """One Keras layer config → our Layer config, or None for structural
    no-op layers (Flatten/Reshape/InputLayer — shape plumbing the builder's
    InputType inference + auto-preprocessors already performs)."""
    act = map_activation(cfg.get("activation"))
    name = cfg.get("name")
    if class_name == "Dense":
        return DenseLayer(name=name, activation=act,
                          n_out=_units(cfg, class_name))
    if class_name == "Activation":
        return ActivationLayer(name=name, activation=act)
    if class_name in ("Dropout", "SpatialDropout2D"):
        p = cfg.get("p", cfg.get("rate", 0.0))
        return DropoutLayer(name=name, dropout=float(p))
    if class_name in ("Convolution2D", "Conv2D"):
        n_out = _units(cfg, class_name)
        if "nb_row" in cfg:
            kernel = (int(cfg["nb_row"]), int(cfg["nb_col"]))
        else:
            kernel = _pair(cfg.get("kernel_size"))
        stride = _pair(cfg.get("subsample") or cfg.get("strides"), (1, 1))
        return ConvolutionLayer(name=name, activation=act, n_out=int(n_out),
                                kernel=kernel, stride=stride,
                                convolution_mode=_conv_mode(cfg))
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        pool = (PoolingType.MAX if class_name.startswith("Max")
                else PoolingType.AVG)
        kernel = _pair(cfg.get("pool_size"), (2, 2))
        stride = _pair(cfg.get("strides"), kernel)
        return SubsamplingLayer(name=name, pooling_type=pool, kernel=kernel,
                                stride=stride, convolution_mode=_conv_mode(cfg))
    if class_name in ("GlobalMaxPooling1D", "GlobalMaxPooling2D",
                      "GlobalAveragePooling1D", "GlobalAveragePooling2D"):
        pool = (PoolingType.MAX if "Max" in class_name else PoolingType.AVG)
        return GlobalPoolingLayer(name=name, pooling_type=pool)
    if class_name == "BatchNormalization":
        if cfg.get("mode", 0) not in (0, 2):
            raise UnsupportedKerasConfigurationException(
                f"Keras BatchNormalization mode {cfg['mode']} not supported")
        return BatchNormalization(name=name,
                                  eps=float(cfg.get("epsilon", 1e-5)),
                                  decay=float(cfg.get("momentum", 0.99)))
    if class_name == "Embedding":
        return EmbeddingLayer(name=name, activation=act,
                              n_in=int(cfg["input_dim"]),
                              n_out=_units(cfg, class_name))
    if class_name == "LSTM":
        n_out = _units(cfg, class_name)
        # Keras defaults: cell activation tanh, gate (recurrent) sigmoid
        act = map_activation(cfg.get("activation") or "tanh")
        gate = map_activation(cfg.get("inner_activation")
                              or cfg.get("recurrent_activation") or "sigmoid")
        if not cfg.get("return_sequences", False):
            raise UnsupportedKerasConfigurationException(
                "LSTM with return_sequences=False: add a LastTimeStep/global "
                "pooling stage explicitly (reference KerasLayer has the same "
                "restriction for sequence outputs)")
        return GravesLSTM(name=name, activation=act,
                          gate_activation=gate, n_out=n_out,
                          forget_gate_bias_init=1.0 if cfg.get(
                              "unit_forget_bias", True) else 0.0)
    if class_name in ("Flatten", "Reshape", "InputLayer", "ZeroPadding2D"):
        if class_name == "ZeroPadding2D":
            raise UnsupportedKerasConfigurationException(
                "ZeroPadding2D is not mapped; fold the padding into the "
                "following convolution's padding")
        return None
    raise UnsupportedKerasConfigurationException(
        f"unsupported Keras layer type {class_name!r}")


def _to_output_layer(layer: Layer, loss: LossFunction,
                     fold_activation: Optional[Activation]) -> Layer:
    """Final Dense(+Activation) → OutputLayer / RnnOutput (reference
    KerasModel turns the last Keras layer + training-config loss into a DL4J
    output layer)."""
    if isinstance(layer, DenseLayer) and not isinstance(layer, OutputLayer):
        return OutputLayer(name=layer.name,
                           activation=fold_activation or layer.activation,
                           n_in=layer.n_in, n_out=layer.n_out, loss=loss)
    if isinstance(layer, GravesLSTM):
        raise UnsupportedKerasConfigurationException(
            "recurrent final layer needs a TimeDistributed(Dense) head")
    return layer


# ---------------------------------------------------------------------------
# weight translation


def _lstm_weights(arrays: List[np.ndarray], n_out: int) -> Dict[str, np.ndarray]:
    """Keras LSTM weights → our gate order [i, f, o, g] (g = Keras's c /
    candidate). Keras 1.x: 12 per-gate arrays in order (i, c, f, o); Keras
    2.x: fused kernel/recurrent/bias with column blocks (i, f, c, o)."""
    if len(arrays) == 12:
        (Wi, Ui, bi, Wc, Uc, bc, Wf, Uf, bf, Wo, Uo, bo) = arrays
        W = np.concatenate([Wi, Wf, Wo, Wc], axis=1)
        RW = np.concatenate([Ui, Uf, Uo, Uc], axis=1)
        b = np.concatenate([bi, bf, bo, bc])
    elif len(arrays) == 3:
        K, R, b2 = arrays
        def reorder(a):
            i, f, c, o = np.split(a, 4, axis=-1)
            return np.concatenate([i, f, o, c], axis=-1)
        W, RW, b = reorder(K), reorder(R), reorder(b2)
    else:
        raise InvalidKerasConfigurationException(
            f"unexpected LSTM weight count {len(arrays)}")
    z = np.zeros((n_out,), W.dtype)
    return {"W": W, "RW": RW, "b": b, "pI": z, "pF": z, "pO": z}


def _conv_kernel(W: np.ndarray, ordering: str) -> np.ndarray:
    """Keras kernel → HWIO. th (Keras 1 channels_first): (out, in, kh, kw);
    tf / Keras 2: already (kh, kw, in, out)."""
    if ordering == "th":
        return np.transpose(W, (2, 3, 1, 0))
    return W


def _dense_after_flatten(W: np.ndarray, pre_shape: Tuple[int, int, int],
                         ordering: str) -> np.ndarray:
    """Fix dense-weight row order when the Keras model flattened a
    channels_first tensor: Keras rows are (C,H,W)-ordered, our
    CnnToFeedForward flattens NHWC → (H,W,C) order."""
    if ordering != "th":
        return W
    h, w, c = pre_shape
    return (W.reshape(c, h, w, -1).transpose(1, 2, 0, 3)
            .reshape(h * w * c, -1))


def translate_layer_weights(layer: Layer, arrays: List[np.ndarray],
                            ordering: str,
                            pre_flatten_shape: Optional[Tuple[int, int, int]]
                            ) -> Tuple[Dict[str, np.ndarray],
                                       Dict[str, np.ndarray]]:
    """→ (params, state) numpy dicts matching `layer.init_params` /
    `init_state` structure."""
    if isinstance(layer, GravesLSTM):
        return _lstm_weights(arrays, layer.n_out), {}
    if isinstance(layer, ConvolutionLayer):
        W, b = arrays
        return {"W": _conv_kernel(W, ordering), "b": b}, {}
    if isinstance(layer, BatchNormalization):
        gamma, beta, mean, var = arrays
        return ({"gamma": gamma, "beta": beta},
                {"mean": mean, "var": np.maximum(var, 0.0)})
    if isinstance(layer, EmbeddingLayer):
        (W,) = arrays
        return {"W": W, "b": np.zeros((W.shape[1],), W.dtype)}, {}
    if isinstance(layer, DenseLayer):
        W, b = arrays
        if pre_flatten_shape is not None:
            W = _dense_after_flatten(W, pre_flatten_shape, ordering)
        return {"W": W, "b": b}, {}
    raise UnsupportedKerasConfigurationException(
        f"no weight translation for layer {layer.TYPE}")


# ---------------------------------------------------------------------------
# HDF5 plumbing


def _read_h5_weights(f) -> "Dict[str, List[np.ndarray]]":
    """model_weights group → {keras_layer_name: [arrays in weight_names
    order]} (skips weightless layers)."""
    g = f["model_weights"] if "model_weights" in f else f
    out: Dict[str, List[np.ndarray]] = {}
    layer_names = [n.decode() if isinstance(n, bytes) else n
                   for n in g.attrs.get("layer_names", list(g.keys()))]
    for lname in layer_names:
        if lname not in g:
            continue
        lg = g[lname]
        wnames = [n.decode() if isinstance(n, bytes) else n
                  for n in lg.attrs.get("weight_names", [])]
        if not wnames:
            continue
        out[lname] = [np.asarray(lg[wn]) for wn in wnames]
    return out


def _json_attr(f, key: str) -> Optional[dict]:
    v = f.attrs.get(key)
    if v is None:
        return None
    if isinstance(v, bytes):
        v = v.decode("utf-8")
    return json.loads(v)


def _loss_from_training_config(f) -> LossFunction:
    tc = _json_attr(f, "training_config")
    if tc and isinstance(tc.get("loss"), str):
        return map_loss(tc["loss"])
    return LossFunction.MCXENT


# ---------------------------------------------------------------------------
# Sequential → MultiLayerConfiguration


class _SeqTranslation:
    def __init__(self):
        self.layers: List[Layer] = []
        self.keras_names: List[Optional[str]] = []  # aligned with layers
        self.input_type: Optional[InputType] = None
        self.ordering: str = "tf"
        # index of the Dense layer that consumes Flatten output (its weight
        # rows may need CHW→HWC permutation for channels_first models)
        self.flatten_dense_idx: Optional[int] = None


def _translate_sequential(layer_cfgs: List[dict]) -> _SeqTranslation:
    tr = _SeqTranslation()
    pending_flatten = False
    for entry in layer_cfgs:
        cls, cfg = entry["class_name"], dict(entry["config"])
        shape = cfg.get("batch_input_shape")
        if shape is not None and tr.input_type is None:
            tr.ordering = _dim_ordering(cfg)
            tr.input_type = _input_type_from_shape(shape[1:], tr.ordering)
        if cls in ("Convolution2D", "Conv2D", "MaxPooling2D",
                   "AveragePooling2D") and _dim_ordering(cfg) == "th":
            tr.ordering = "th"
        layer = map_keras_layer(cls, cfg)
        if layer is None:
            if cls == "Flatten":
                pending_flatten = True
            continue
        # pending_flatten survives pass-through layers (Dropout/Activation/
        # BatchNorm) until the Dense that consumes the flattened tensor
        if pending_flatten and isinstance(layer, DenseLayer):
            tr.flatten_dense_idx = len(tr.layers)
            pending_flatten = False
        elif isinstance(layer, (ConvolutionLayer, SubsamplingLayer,
                                GravesLSTM)):
            pending_flatten = False
        tr.layers.append(layer)
        tr.keras_names.append(cfg.get("name"))
    if not tr.layers:
        raise InvalidKerasConfigurationException("empty Keras model config")
    return tr


def _fold_trailing_activation(tr: _SeqTranslation) -> Optional[Activation]:
    """Final standalone Activation folds into the output layer."""
    if len(tr.layers) >= 2 and isinstance(tr.layers[-1], ActivationLayer) \
            and isinstance(tr.layers[-2], DenseLayer):
        act_layer = tr.layers.pop()
        tr.keras_names.pop()
        return act_layer.activation
    return None


def _build_mlc(tr: _SeqTranslation, loss: LossFunction) -> MultiLayerConfiguration:
    fold = _fold_trailing_activation(tr)
    tr.layers[-1] = _to_output_layer(tr.layers[-1], loss, fold)
    lb = NeuralNetConfiguration.Builder().list()
    for layer in tr.layers:
        lb.layer(layer)
    if tr.input_type is not None:
        lb.set_input_type(tr.input_type)
    return lb.build()


# ---------------------------------------------------------------------------
# functional Model → ComputationGraphConfiguration


_MERGE_MODES = {"concat": None, "sum": ElementWiseOp.ADD,
                "mul": ElementWiseOp.PRODUCT, "ave": ElementWiseOp.AVERAGE,
                "max": ElementWiseOp.MAX}


def _translate_functional(config: dict, loss: LossFunction) -> Tuple[
        "GraphBuilder", List[str], Dict[str, Layer], str]:
    """Keras functional-API graph → GraphBuilder. Returns (builder,
    output names, {keras_name: our layer}, dim ordering)."""
    gb = NeuralNetConfiguration.Builder().graph_builder()
    name_to_layer: Dict[str, Layer] = {}
    inputs: List[str] = []
    input_types: List[InputType] = []
    out_names = [o[0] for o in config["output_layers"]]
    in_names = {i[0] for i in config["input_layers"]}
    # Keras 1 declares dim_ordering on conv/pool layers, not the InputLayer —
    # scan first so input shapes are interpreted with the right ordering
    ordering = "tf"
    for entry in config["layers"]:
        if entry["class_name"] in ("Convolution2D", "Conv2D", "MaxPooling2D",
                                   "AveragePooling2D") \
                and _dim_ordering(entry["config"]) == "th":
            ordering = "th"

    for entry in config["layers"]:
        cls, cfg = entry["class_name"], dict(entry["config"])
        name = entry.get("name") or cfg.get("name")
        inbound = [n[0] for node in entry.get("inbound_nodes", [])
                   for n in node]
        if cls == "InputLayer" or name in in_names:
            shape = cfg.get("batch_input_shape")
            if shape is None:
                raise InvalidKerasConfigurationException(
                    f"input layer {name!r} missing batch_input_shape")
            inputs.append(name)
            input_types.append(_input_type_from_shape(shape[1:], ordering))
            continue
        if cls in ("Merge", "Concatenate", "Add", "Multiply", "Average",
                   "Maximum"):
            mode = cfg.get("mode", {"Concatenate": "concat", "Add": "sum",
                                    "Multiply": "mul", "Average": "ave",
                                    "Maximum": "max"}.get(cls, "concat"))
            op = _MERGE_MODES.get(mode, "missing")
            if op == "missing":
                raise UnsupportedKerasConfigurationException(
                    f"unsupported Merge mode {mode!r}")
            vertex = MergeVertex() if op is None else ElementWiseVertex(op=op)
            gb.add_vertex(name, vertex, *inbound)
            continue
        layer = map_keras_layer(cls, cfg)
        if layer is None:
            raise UnsupportedKerasConfigurationException(
                f"{cls} inside a functional model is not yet mapped "
                "(Sequential import handles Flatten via auto-preprocessors)")
        if name in out_names:
            layer = _to_output_layer(layer, loss, None)
        layer.name = name
        gb.add_layer(name, layer, *inbound)
        name_to_layer[name] = layer

    gb.add_inputs(*inputs)
    if input_types:
        gb.set_input_types(*input_types)
    gb.set_outputs(*out_names)
    return gb, out_names, name_to_layer, ordering


# ---------------------------------------------------------------------------
# public entry points (reference KerasModelImport.java)


class KerasModelImport:
    """Entry points mirroring the reference `KerasModelImport` API."""

    # -- Sequential --------------------------------------------------------
    @staticmethod
    def import_keras_sequential_configuration(
            model_json: Union[str, Path]) -> MultiLayerConfiguration:
        """JSON string or path (no weights) → MultiLayerConfiguration."""
        cfg = _load_model_config_json(model_json)
        if cfg["class_name"] != "Sequential":
            raise InvalidKerasConfigurationException(
                f"not a Sequential model: {cfg['class_name']}")
        tr = _translate_sequential(_seq_layer_list(cfg))
        return _build_mlc(tr, LossFunction.MCXENT)

    @staticmethod
    def import_keras_sequential_model_and_weights(
            h5_path: Union[str, Path], enforce_training_config: bool = False,
            device="cuda"):
        """HDF5 (config+weights) → initialized MultiLayerNetwork on
        `device`. `h5_path` is a path, or an open h5py-shaped object
        (`_open_h5`)."""
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        with _open_h5(h5_path) as f:
            cfg = _json_attr(f, "model_config")
            if cfg is None:
                raise InvalidKerasConfigurationException(
                    "HDF5 file has no model_config attribute")
            if cfg["class_name"] != "Sequential":
                raise InvalidKerasConfigurationException(
                    f"not a Sequential model: {cfg['class_name']}")
            loss = _loss_from_training_config(f)
            if enforce_training_config and _json_attr(f, "training_config") is None:
                raise InvalidKerasConfigurationException(
                    "no training_config in HDF5 file")
            tr = _translate_sequential(_seq_layer_list(cfg))
            mlc = _build_mlc(tr, loss)
            weights = _read_h5_weights(f)

        net = MultiLayerNetwork(mlc, device=device)
        net.init()
        _copy_sequential_weights(net, tr, weights)
        return net

    # -- functional Model --------------------------------------------------
    @staticmethod
    def import_keras_model_configuration(model_json: Union[str, Path]):
        cfg = _load_model_config_json(model_json)
        if cfg["class_name"] not in ("Model", "Functional"):
            raise InvalidKerasConfigurationException(
                f"not a functional Model: {cfg['class_name']}")
        gb, _, _, _ = _translate_functional(cfg["config"], LossFunction.MCXENT)
        return gb.build()

    @staticmethod
    def import_keras_model_and_weights(h5_path: Union[str, Path],
                                       device="cuda"):
        """HDF5 functional model → initialized ComputationGraph on
        `device`. `h5_path` is a path, or an open h5py-shaped object
        (`_open_h5`)."""
        from deeplearning4j_tpu_torch.nn.graph.computation_graph import (
            ComputationGraph,
        )

        with _open_h5(h5_path) as f:
            cfg = _json_attr(f, "model_config")
            if cfg is None:
                raise InvalidKerasConfigurationException(
                    "HDF5 file has no model_config attribute")
            if cfg["class_name"] not in ("Model", "Functional"):
                raise InvalidKerasConfigurationException(
                    f"not a functional Model: {cfg['class_name']}")
            loss = _loss_from_training_config(f)
            gb, _, name_to_layer, ordering = _translate_functional(
                cfg["config"], loss)
            weights = _read_h5_weights(f)

        cgc = gb.build()
        net = ComputationGraph(cgc, device=device)
        net.init()
        _copy_graph_weights(net, cgc, name_to_layer, weights, ordering)
        return net


def _open_h5(src):
    """A context giving the HDF5 file to read: `src` opened with h5py
    when it is a path; `src` itself when it already has h5py's reading
    surface (an `h5py.File` or group, or any object with `attrs`, `in`,
    `keys()` and item access whose leaves are arrays: the layout of a
    Keras file held in memory)."""
    import contextlib

    if hasattr(src, "attrs"):
        return contextlib.nullcontext(src)
    import h5py

    return h5py.File(src, "r")


def _seq_layer_list(cfg: dict) -> List[dict]:
    c = cfg["config"]
    if isinstance(c, dict):  # Keras 2.x: {"layers": [...], ...}
        return c["layers"]
    return c  # Keras 1.x: bare list


def _load_model_config_json(src: Union[str, Path]) -> dict:
    s = str(src)
    if s.lstrip().startswith("{"):
        return json.loads(s)
    return json.loads(Path(src).read_text(encoding="utf-8"))


# ---------------------------------------------------------------------------
# weight copy into initialized nets


def _keras_weight_key(keras_name: Optional[str], idx: int,
                      weights: Dict[str, List[np.ndarray]]) -> Optional[str]:
    if keras_name and keras_name in weights:
        return keras_name
    return None


def _copy_sequential_weights(net, tr: _SeqTranslation,
                             weights: Dict[str, List[np.ndarray]]) -> None:
    # match param-bearing layers to weight groups: by name when possible,
    # else in declaration order (reference matches strictly by layer name)
    unused = list(weights.items())
    pre_flatten_shapes = _pre_flatten_shapes(net, tr)
    for i, layer in enumerate(net.layers):
        if not layer.has_params:
            continue
        key = _keras_weight_key(tr.keras_names[i], i, weights)
        if key is not None:
            arrays = weights[key]
            unused = [(k, v) for k, v in unused if k != key]
        elif unused:
            _, arrays = unused.pop(0)
        else:
            raise InvalidKerasConfigurationException(
                f"no weights found for layer {i} ({layer.TYPE})")
        params, state = translate_layer_weights(
            layer, arrays, tr.ordering, pre_flatten_shapes.get(i))
        _check_and_set(net._params[i], params, i, layer)
        for k, v in state.items():
            net._layer_state[i][k] = torch.as_tensor(
                np.asarray(v, np.float32), device=net.device)


def _pre_flatten_shapes(net, tr: _SeqTranslation) -> Dict[int, Tuple[int, int, int]]:
    """{dense-layer idx: (H, W, C) of the conv tensor it flattened}."""
    out: Dict[int, Tuple[int, int, int]] = {}
    i = tr.flatten_dense_idx
    if i is None:
        return out
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputTypeConvolutional
    # recover the last convolutional tensor shape before the dense layer
    for j in range(i - 1, -1, -1):
        pt = net.layers[j].output_type(net._input_types[j])
        if isinstance(pt, InputTypeConvolutional):
            out[i] = (pt.height, pt.width, pt.channels)
            break
    else:  # Flatten directly after the network input
        it0 = net.conf.input_type
        if isinstance(it0, InputTypeConvolutional):
            out[i] = (it0.height, it0.width, it0.channels)
    return out


def _check_and_set(param_dict, new_params: Dict[str, np.ndarray], idx,
                   layer) -> None:
    for k, v in new_params.items():
        if k not in param_dict:
            raise InvalidKerasConfigurationException(
                f"layer {idx} ({layer.TYPE}) has no param {k!r}")
        want = tuple(param_dict[k].shape)
        got = tuple(np.shape(v))
        if want != got:
            raise InvalidKerasConfigurationException(
                f"layer {idx} ({layer.TYPE}) param {k!r}: Keras weight shape "
                f"{got} != expected {want}")
        param_dict[k] = torch.as_tensor(np.asarray(v)).to(
            device=param_dict[k].device, dtype=param_dict[k].dtype)


def _copy_graph_weights(net, cgc, name_to_layer: Dict[str, Layer],
                        weights: Dict[str, List[np.ndarray]],
                        ordering: str = "tf") -> None:
    for name, layer in name_to_layer.items():
        if not layer.has_params:
            continue
        if name not in weights:
            raise InvalidKerasConfigurationException(
                f"no weights for layer {name!r}")
        params, state = translate_layer_weights(layer, weights[name],
                                                ordering, None)
        _check_and_set(net._params[name], params, name, layer)
        for k, v in state.items():
            net._layer_state[name][k] = torch.as_tensor(
                np.asarray(v, np.float32), device=net.device)
