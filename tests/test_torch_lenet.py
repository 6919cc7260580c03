"""LeNet and BatchNormalization networks of the port held against the
JAX package on the CPU.

`lenet_configuration()` builds the same JSON in both packages. From the
JAX network's weights (`params_from_jax`), LeNet takes 3 Nesterovs steps
(lr 0.01, momentum 0.9) on seeded uint8 28x28 images through
`ImagePreProcessingScaler`, in f32: per-step losses within 1e-5 and the
parameters after the steps within 1e-6 (rtol = atol). `evaluate` on a
held-out batch gives the same confusion matrix. A small CNN with
BatchNormalization trains 3 steps the same way (losses 1e-5, parameters
and running stats 1e-6), and its checkpoint zip, running stats included,
restores in the other package with outputs within 1e-6. Truncated BPTT
carries the LSTM state window to window and leaves BatchNormalization's
running stats to the training forward, as in the JAX package.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.datasets.normalizers import (  # noqa: E402
    ImagePreProcessingScaler as JScaler,
)
from deeplearning4j_tpu.models.lenet import (  # noqa: E402
    lenet_configuration as jlenet,
)
from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.normalizers import (  # noqa: E402
    ImagePreProcessingScaler,
)
from deeplearning4j_tpu_torch.models import lenet_configuration  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.util import serialization as pser  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the tier runs
    several pytest-xdist workers on one host, and torch's default of a
    thread per core in each of them oversubscribes the cores, so that
    every small op waits for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(n, B, seed, hw=28, classes=10):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (B, hw * hw), dtype=np.uint8),
             np.eye(classes, dtype=np.float32)[rng.integers(0, classes, B)])
            for _ in range(n)]


def _pair(jconf, pconf):
    jnet = JaxNet(jconf)
    jnet.init()
    pnet = MultiLayerNetwork(pconf, device="cpu")
    pnet.set_param_tree(pser.params_from_jax(pconf, jnet._params))
    return jnet, pnet


def _assert_params(jnet, pnet, tol=1e-6):
    for i, (jp, pp) in enumerate(zip(jnet._params, pnet._params)):
        for k in jp:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"layer {i} {k}")


def _assert_state(jnet, pnet, tol=1e-6):
    for i, (js, ps) in enumerate(zip(jnet._layer_state, pnet._layer_state)):
        for k in js:
            np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"layer {i} state {k}")


def test_lenet_configuration_json_both_ways():
    text = jlenet().to_json()
    assert lenet_configuration().to_json() == text
    assert PC.MultiLayerConfiguration.from_json(text).to_json() == text
    assert JC.MultiLayerConfiguration.from_json(
        lenet_configuration().to_json()).to_json() == text


def test_lenet_fit_and_evaluate_match_the_jax_package():
    jnet, pnet = _pair(jlenet(), lenet_configuration())
    jnet.set_normalizer(JScaler())
    pnet.set_normalizer(ImagePreProcessingScaler())
    for x, y in _images(3, 16, seed=0):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        assert pnet.score_value == pytest.approx(jnet.score_value,
                                                 rel=1e-5, abs=1e-5)
    _assert_params(jnet, pnet)
    assert pnet.summary() == jnet.summary()
    x, y = _images(1, 32, seed=9)[0]
    jev, pev = jnet.evaluate(JDataSet(x, y)), pnet.evaluate(DataSet(x, y))
    np.testing.assert_array_equal(pev.confusion_matrix, jev.confusion_matrix)
    assert pev.accuracy() == jev.accuracy()
    np.testing.assert_allclose(pnet.output(x).numpy(), jnet.output(x),
                               rtol=1e-5, atol=1e-6)


def _bn_cnn(C, updater="nesterovs"):
    return (C.NeuralNetConfiguration.Builder().seed(7).learning_rate(0.05)
            .updater(updater).momentum(0.9).list()
            .layer(C.ConvolutionLayer(n_out=4, kernel=(3, 3), stride=(2, 2),
                                      convolution_mode=C.ConvolutionMode.SAME,
                                      activation="relu"))
            .layer(C.BatchNormalization(decay=0.8, activation="identity"))
            .layer(C.LocalResponseNormalization(n=3))
            .layer(C.SubsamplingLayer(pooling_type=C.PoolingType.AVG,
                                      kernel=(2, 2), stride=(2, 2)))
            .layer(C.DenseLayer(n_out=8, activation="tanh"))
            .layer(C.BatchNormalization(activation="identity"))
            .layer(C.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(C.InputType.convolutional_flat(8, 8, 1))
            .build())


def _float_images(n, B, seed):
    return [(x.astype(np.float32) / 255.0, y)
            for x, y in _images(n, B, seed, hw=8, classes=3)]


def test_batch_norm_cnn_trains_like_the_jax_package(tmp_path):
    """3 steps: losses, parameters and both BatchNormalization layers'
    running stats; then the checkpoint zip both ways (stats included)."""
    jnet, pnet = _pair(_bn_cnn(JC), _bn_cnn(PC))
    for x, y in _float_images(3, 12, seed=1):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        assert pnet.score_value == pytest.approx(jnet.score_value,
                                                 rel=1e-5, abs=1e-5)
    _assert_params(jnet, pnet)
    _assert_state(jnet, pnet)
    assert not np.allclose(np.asarray(jnet._layer_state[1]["var"]), 1.0)
    x, _ = _float_images(1, 5, seed=2)[0]
    want = jnet.output(x)
    np.testing.assert_allclose(pnet.output(x).numpy(), want, rtol=1e-6,
                               atol=1e-6)

    pser.write_model(pnet, tmp_path / "port.zip")
    back_j = jser.restore_multi_layer_network(tmp_path / "port.zip")
    np.testing.assert_allclose(back_j.output(x), want, rtol=1e-6, atol=1e-6)
    _assert_state(back_j, pnet, tol=0)
    jser.write_model(jnet, tmp_path / "jax.zip")
    back_p = pser.restore_multi_layer_network(tmp_path / "jax.zip",
                                              device="cpu")
    np.testing.assert_allclose(back_p.output(x).numpy(), want, rtol=1e-6,
                               atol=1e-6)
    _assert_state(jnet, back_p, tol=0)
    assert back_p.iteration == 3
    # the restored network trains on exactly as the original
    x, y = _float_images(1, 12, seed=3)[0]
    back_p.fit(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    _assert_params(jnet, back_p)
    _assert_state(jnet, back_p)


def test_layer_state_loads_from_the_jax_package():
    jnet, pnet = _pair(_bn_cnn(JC), _bn_cnn(PC))
    for x, y in _float_images(2, 12, seed=4):
        jnet.fit(JDataSet(x, y))
    pnet.set_param_tree(pser.params_from_jax(pnet.conf, jnet._params))
    pnet.set_layer_state(pser.params_from_jax(pnet.conf,
                                              jnet._layer_state))
    x, _ = _float_images(1, 4, seed=5)[0]
    np.testing.assert_allclose(pnet.output(x).numpy(), jnet.output(x),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="state names"):
        pnet.set_layer_state([{}] * len(pnet.layers))


def _lstm_bn(C):
    return (C.NeuralNetConfiguration.Builder().seed(2).learning_rate(0.1)
            .updater("sgd").list()
            .layer(C.GravesLSTM(n_out=6, activation="tanh"))
            .layer(C.BatchNormalization(activation="identity"))
            .layer(C.RnnOutputLayer(n_out=4, activation="softmax"))
            .set_input_type(C.InputType.recurrent(4))
            .t_bptt_forward_length(3).build())


def test_tbptt_moves_batch_norm_stats_window_by_window():
    """T=7 in windows of 3 (the tail padded and masked): the LSTM carry
    crosses windows, BatchNormalization's running stats move once per
    window, and the carry slots are restored afterwards."""
    jnet, pnet = _pair(_lstm_bn(JC), _lstm_bn(PC))
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 4, (3, 8))
    x = np.eye(4, dtype=np.float32)[ids[:, :-1]]
    y = ids[:, 1:].astype(np.int32)
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    assert pnet.iteration == jnet.iteration == 3
    assert pnet.score_value == pytest.approx(jnet.score_value, rel=1e-5)
    _assert_params(jnet, pnet, tol=1e-5)
    _assert_state(jnet, pnet, tol=1e-5)
    assert pnet._layer_state[0] == {}


def test_embedding_and_drop_connect_network_fits():
    """EmbeddingLayer on int ids, a DropConnect dense layer and a
    LossLayer head: inference parity with the JAX package, and a
    training step that draws its masks per seed."""
    def conf(C):
        return (C.NeuralNetConfiguration.Builder().seed(4).learning_rate(0.1)
                .list()
                .layer(C.EmbeddingLayer(n_in=10, n_out=6, activation="tanh"))
                .layer(C.DenseLayer(n_out=5, dropout=0.3,
                                    use_drop_connect=True,
                                    activation="identity"))
                .layer(C.ActivationLayer(activation="relu"))
                .layer(C.DropoutLayer(dropout=0.2))
                .layer(C.LossLayer(activation="softmax"))
                .set_input_type(C.InputType.feed_forward(10)).build())

    jnet, pnet = _pair(conf(JC), conf(PC))
    ids = np.arange(8).reshape(8, 1) % 10
    np.testing.assert_allclose(pnet.output(ids).numpy(), jnet.output(ids),
                               rtol=1e-6, atol=1e-6)
    labels = np.eye(5, dtype=np.float32)[np.arange(8) % 5]
    a, b = pnet.clone(), pnet.clone()
    a.fit(DataSet(ids, labels))
    b.fit(DataSet(ids, labels))
    assert torch.equal(a.params(), b.params())
    assert not torch.equal(a.params(), pnet.params())
    assert pnet.conf.to_json() == conf(JC).to_json()
