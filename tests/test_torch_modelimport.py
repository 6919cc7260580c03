"""The port's Keras model import (`deeplearning4j_tpu_torch.modelimport`)
against the JAX package's, on the same HDF5 files written here with h5py
(nothing is downloaded).

Each case imports one file in both packages: the configurations' JSON
must be equal, the weights copied into the port's torch parameters equal
to the JAX package's bit for bit, and `output` on the same input within
1e-5 (f32, CPU); the configuration-only entry points and the errors
match too. A Keras LSTM becomes a GravesLSTM with zero peepholes: with
sigmoid gates it runs the fused LSTM route, with Keras 1's
`hard_sigmoid` the step loop (`nn.layers.recurrent.lstm_forward.routes`).
An open h5py-shaped object (the file's layout in memory) imports as the
file does."""
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu.modelimport import keras as jk  # noqa: E402

from deeplearning4j_tpu_torch.modelimport import keras as pk  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import recurrent  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm as plstm  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs (the tier runs
    several pytest-xdist workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_keras_h5(path, model_config, layer_weights,
                    loss="categorical_crossentropy"):
    """layer_weights: [(layer_name, [(weight_name, array), ...]), ...]"""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config).encode()
        f.attrs["training_config"] = json.dumps(
            {"loss": loss, "optimizer": {"class_name": "SGD"}}).encode()
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array(
            [n.encode() for n, _ in layer_weights])
        for lname, ws in layer_weights:
            g = mw.create_group(lname)
            g.attrs["weight_names"] = np.array([wn.encode() for wn, _ in ws])
            for wn, arr in ws:
                g.create_dataset(wn, data=arr)


def _seq_k1(layers):
    return {"class_name": "Sequential",
            "config": [{"class_name": c, "config": cfg} for c, cfg in layers]}


def _seq_k2(layers):
    return {"class_name": "Sequential",
            "config": {"name": "sequential",
                       "layers": [{"class_name": c, "config": cfg}
                                  for c, cfg in layers]}}


def _r(rng, *shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _mlp(rng):
    cfg = _seq_k1([
        ("Dense", {"name": "dense_1", "output_dim": 16, "activation": "relu",
                   "batch_input_shape": [None, 8]}),
        ("Dropout", {"name": "do", "p": 0.5}),
        ("Dense", {"name": "dense_2", "output_dim": 3,
                   "activation": "softmax"})])
    w = [("dense_1", [("dense_1_W", _r(rng, 8, 16)),
                      ("dense_1_b", _r(rng, 16))]),
         ("dense_2", [("dense_2_W", _r(rng, 16, 3)),
                      ("dense_2_b", _r(rng, 3))])]
    return cfg, w, _r(rng, 4, 8)


def _cnn_th(rng):
    cfg = _seq_k1([
        ("Convolution2D", {"name": "conv", "nb_filter": 2, "nb_row": 3,
                           "nb_col": 3, "activation": "relu",
                           "border_mode": "valid", "dim_ordering": "th",
                           "batch_input_shape": [None, 1, 8, 8]}),
        ("Flatten", {"name": "flat"}),
        ("Dropout", {"name": "drop", "p": 0.25}),
        ("Dense", {"name": "dense", "output_dim": 4,
                   "activation": "softmax"})])
    w = [("conv", [("conv_W", _r(rng, 2, 1, 3, 3)), ("conv_b", _r(rng, 2))]),
         ("dense", [("dense_W", _r(rng, 72, 4)), ("dense_b", _r(rng, 4))])]
    return cfg, w, _r(rng, 2, 8, 8, 1)


def _cnn_tf_pool(rng):
    cfg = _seq_k2([
        ("Conv2D", {"name": "c", "filters": 3, "kernel_size": [2, 2],
                    "activation": "relu", "padding": "same",
                    "data_format": "channels_last",
                    "batch_input_shape": [None, 8, 8, 1]}),
        ("MaxPooling2D", {"name": "p", "pool_size": [2, 2],
                          "padding": "valid"}),
        ("BatchNormalization", {"name": "bn", "epsilon": 1e-3}),
        ("Flatten", {"name": "f"}),
        ("Dense", {"name": "d", "units": 2, "activation": "softmax"})])
    w = [("c", [("kernel", _r(rng, 2, 2, 1, 3)), ("bias", _r(rng, 3))]),
         ("bn", [("gamma", 1 + _r(rng, 3)), ("beta", _r(rng, 3)),
                 ("moving_mean", _r(rng, 3)),
                 ("moving_variance", 1 + np.abs(_r(rng, 3)))]),
         ("d", [("kernel", _r(rng, 48, 2)), ("bias", _r(rng, 2))])]
    return cfg, w, _r(rng, 2, 8, 8, 1)


def _lstm(gate):
    def make(rng):
        n_in, n, T = 5, 7, 6
        cfg = _seq_k2([
            ("LSTM", {"name": "lstm", "units": n, "activation": "tanh",
                      "recurrent_activation": gate,
                      "return_sequences": True,
                      "batch_input_shape": [None, T, n_in]}),
            ("Dense", {"name": "dense", "units": 3,
                       "activation": "softmax"})])
        w = [("lstm", [("kernel", _r(rng, n_in, 4 * n)),
                       ("recurrent_kernel", _r(rng, n, 4 * n)),
                       ("bias", _r(rng, 4 * n))]),
             ("dense", [("kernel", _r(rng, n, 3)), ("bias", _r(rng, 3))])]
        return cfg, w, _r(rng, 2, T, n_in)
    return make


def _lstm_k1(rng):
    """Keras 1: per-gate LSTM weights, hard_sigmoid gates."""
    cfg = _seq_k1([
        ("LSTM", {"name": "lstm", "output_dim": 6, "activation": "tanh",
                  "inner_activation": "hard_sigmoid",
                  "return_sequences": True,
                  "batch_input_shape": [None, 5, 4]}),
        ("Dense", {"name": "d", "output_dim": 2, "activation": "softmax"})])
    per_gate = []
    for g in ("i", "c", "f", "o"):
        per_gate += [(f"lstm_W_{g}", _r(rng, 4, 6)),
                     (f"lstm_U_{g}", _r(rng, 6, 6)),
                     (f"lstm_b_{g}", _r(rng, 6))]
    w = [("lstm", per_gate),
         ("d", [("d_W", _r(rng, 6, 2)), ("d_b", _r(rng, 2))])]
    return cfg, w, _r(rng, 3, 5, 4)


CASES = {"mlp_keras1": _mlp, "cnn_channels_first": _cnn_th,
         "cnn_pool_batchnorm_keras2": _cnn_tf_pool,
         "lstm_sigmoid_keras2": _lstm("sigmoid"),
         "lstm_hard_sigmoid_keras2": _lstm("hard_sigmoid"),
         "lstm_per_gate_keras1": _lstm_k1}


def _out(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequential_imports_like_the_jax_package(case, tmp_path):
    cfg, w, x = CASES[case](np.random.default_rng(len(case)))
    p = tmp_path / f"{case}.h5"
    _write_keras_h5(p, cfg, w)
    jnet = jk.KerasModelImport.import_keras_sequential_model_and_weights(p)
    pnet = pk.KerasModelImport.import_keras_sequential_model_and_weights(
        p, device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    np.testing.assert_array_equal(pnet.params().numpy(),
                                  np.asarray(jnet.params()))
    np.testing.assert_allclose(_out(pnet.output(x)), _out(jnet.output(x)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gate,route", [("sigmoid", "fused"),
                                        ("hard_sigmoid", "loop")])
def test_keras_lstm_gates_choose_the_lstm_route(gate, route, tmp_path):
    """A Keras LSTM is a GravesLSTM with zero peepholes; sigmoid gates
    take the fused LSTM (its plain version on the CPU), hard_sigmoid the
    step loop, by design."""
    cfg, w, x = _lstm(gate)(np.random.default_rng(1))
    p = tmp_path / "lstm.h5"
    _write_keras_h5(p, cfg, w)
    net = pk.KerasModelImport.import_keras_sequential_model_and_weights(
        p, device="cpu")
    assert type(net.layers[0]).__name__ == "GravesLSTM"
    peep = [net._params[0][k] for k in net._params[0]
            if k.lower().startswith("p") or "peep" in k.lower()]
    assert all(torch.count_nonzero(t) == 0 for t in peep)
    routes = recurrent.lstm_forward.routes
    before = dict(routes)
    calls = plstm.lstm_fwd_plain.calls
    net.output(x)
    assert routes[route] == before.get(route, 0) + 1
    assert (plstm.lstm_fwd_plain.calls > calls) == (route == "fused")


def test_functional_model_imports_as_a_graph(tmp_path):
    rng = np.random.default_rng(3)
    cfg = {"class_name": "Model", "config": {
        "name": "model",
        "layers": [
            {"class_name": "InputLayer", "name": "in",
             "config": {"name": "in", "batch_input_shape": [None, 4]},
             "inbound_nodes": []},
            {"class_name": "Dense", "name": "a",
             "config": {"name": "a", "units": 6, "activation": "relu"},
             "inbound_nodes": [[["in", 0, 0, {}]]]},
            {"class_name": "Dense", "name": "b",
             "config": {"name": "b", "units": 6, "activation": "tanh"},
             "inbound_nodes": [[["in", 0, 0, {}]]]},
            {"class_name": "Concatenate", "name": "merge",
             "config": {"name": "merge"},
             "inbound_nodes": [[["a", 0, 0, {}], ["b", 0, 0, {}]]]},
            {"class_name": "Add", "name": "sum",
             "config": {"name": "sum"},
             "inbound_nodes": [[["a", 0, 0, {}], ["b", 0, 0, {}]]]},
            {"class_name": "Dense", "name": "out",
             "config": {"name": "out", "units": 2, "activation": "softmax"},
             "inbound_nodes": [[["merge", 0, 0, {}]]]},
            {"class_name": "Dense", "name": "out2",
             "config": {"name": "out2", "units": 3,
                        "activation": "softmax"},
             "inbound_nodes": [[["sum", 0, 0, {}]]]},
        ],
        "input_layers": [["in", 0, 0]],
        "output_layers": [["out", 0, 0], ["out2", 0, 0]],
    }}
    p = tmp_path / "func.h5"
    _write_keras_h5(p, cfg, [
        ("a", [("kernel", _r(rng, 4, 6)), ("bias", _r(rng, 6))]),
        ("b", [("kernel", _r(rng, 4, 6)), ("bias", _r(rng, 6))]),
        ("out", [("kernel", _r(rng, 12, 2)), ("bias", _r(rng, 2))]),
        ("out2", [("kernel", _r(rng, 6, 3)), ("bias", _r(rng, 3))])])
    jnet = jk.KerasModelImport.import_keras_model_and_weights(p)
    pnet = pk.KerasModelImport.import_keras_model_and_weights(
        p, device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    np.testing.assert_array_equal(pnet.params().numpy(),
                                  np.asarray(jnet.params()))
    x = _r(rng, 3, 4)
    for got, want in zip(pnet.output(x), jnet.output(x)):
        np.testing.assert_allclose(_out(got), _out(want), rtol=TOL, atol=TOL)
    assert json.loads(pk.KerasModelImport.import_keras_model_configuration(
        json.dumps(cfg)).to_json()) == json.loads(
        jk.KerasModelImport.import_keras_model_configuration(
            json.dumps(cfg)).to_json())


class _Layout(dict):
    """A Keras file's layout in memory: attributes and items."""

    def __init__(self, attrs, **items):
        super().__init__(items)
        self.attrs = attrs


def test_an_open_h5py_shaped_object_imports_as_the_file(tmp_path):
    """`KerasModelImport` also takes an open h5py object (here the file
    itself, then the same layout held in memory): the same network."""
    cfg, w, x = _lstm("sigmoid")(np.random.default_rng(5))
    p = tmp_path / "m.h5"
    _write_keras_h5(p, cfg, w)
    want = pk.KerasModelImport.import_keras_sequential_model_and_weights(
        p, device="cpu")
    with h5py.File(p, "r") as f:
        opened = pk.KerasModelImport.import_keras_sequential_model_and_weights(
            f, device="cpu")
        mem = _Layout(dict(f.attrs), model_weights=_Layout(
            dict(f["model_weights"].attrs), **{
                name: _Layout(dict(g.attrs), **{k: np.asarray(g[k])
                                                for k in g})
                for name, g in f["model_weights"].items()}))
    held = pk.KerasModelImport.import_keras_sequential_model_and_weights(
        mem, device="cpu")
    for net in (opened, held):
        assert torch.equal(net.params(), want.params())
        assert torch.equal(net.output(x), want.output(x))


@pytest.mark.parametrize("case", ["pool_and_loss", "trailing_activation",
                                  "lstm_default_cell"])
def test_configuration_mapping_matches(case):
    if case == "lstm_default_cell":
        a = pk.map_keras_layer("LSTM", {"name": "l", "units": 4,
                                        "return_sequences": True})
        b = jk.map_keras_layer("LSTM", {"name": "l", "units": 4,
                                        "return_sequences": True})
        assert a.activation == b.activation and str(a.activation) \
            .lower().endswith("tanh")
        return
    if case == "pool_and_loss":
        cfg = _seq_k1([
            ("Convolution2D", {"name": "c", "nb_filter": 3, "nb_row": 2,
                               "nb_col": 2, "activation": "relu",
                               "border_mode": "same", "dim_ordering": "tf",
                               "batch_input_shape": [None, 8, 8, 1]}),
            ("MaxPooling2D", {"name": "p", "pool_size": [2, 2],
                              "border_mode": "valid"}),
            ("Flatten", {"name": "f"}),
            ("Dense", {"name": "d", "output_dim": 2,
                       "activation": "softmax"})])
    else:
        cfg = _seq_k1([
            ("Dense", {"name": "d1", "output_dim": 8, "activation": "relu",
                       "batch_input_shape": [None, 4]}),
            ("Dense", {"name": "d2", "output_dim": 3,
                       "activation": "linear"}),
            ("Activation", {"name": "act", "activation": "softmax"})])
    a = pk.KerasModelImport.import_keras_sequential_configuration(
        json.dumps(cfg))
    b = jk.KerasModelImport.import_keras_sequential_configuration(
        json.dumps(cfg))
    assert a.to_json() == b.to_json()
    for loss in ("categorical_crossentropy", "mse", "binary_crossentropy"):
        assert pk.map_loss(loss).value == jk.map_loss(loss).value


@pytest.mark.parametrize("cfg,err", [
    ({"class_name": "Model", "config": {}},
     "InvalidKerasConfigurationException"),
    (_seq_k1([("Lambda", {"name": "l", "batch_input_shape": [None, 4]})]),
     "UnsupportedKerasConfigurationException")])
def test_invalid_and_unsupported_raise_as_the_jax_package(cfg, err):
    def run(mod):
        with pytest.raises(Exception) as e:
            mod.KerasModelImport.import_keras_sequential_configuration(
                json.dumps(cfg))
        return type(e.value).__name__, str(e.value)

    assert run(pk) == run(jk) and run(pk)[0] == err
