"""The port's `gradientcheck.check_gradients`: central differences
against autograd in float64 on the CPU (eps 1e-6, relative error 1e-3),
for the list container and the graph: dense nets over activations,
losses and L1/L2, a CNN, BatchNormalization, an LSTM with and without a
mask (on the fused route's plain version), a masked recurrent graph, a
residual graph, DropConnect's deterministic path and a VAE as a
supervised layer. The port's analytic gradient also equals the JAX
package's on the residual graph (1e-10 relative, f64, same weights),
and a check fed a wrong gradient fails.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: E402
    DataSet,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.gradientcheck import (  # noqa: E402
    check_gradients,
)
from deeplearning4j_tpu_torch.nn import conf as C  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    computation_graph_configuration as V,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)

F64 = torch.float64


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


def small_ds(n=8, nin=4, nout=3, seed=0):
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(n, nin)),
                   np.eye(nout)[rng.integers(0, nout, n)])


def _mln(builder_tail, input_type):
    b = C.NeuralNetConfiguration.Builder().seed(42).updater("none")
    conf = builder_tail(b).set_input_type(input_type).build()
    net = MultiLayerNetwork(conf, dtype=F64, device="cpu")
    net.init()
    return net


@pytest.mark.parametrize("act,loss,out_act", [
    ("tanh", "mcxent", "softmax"), ("relu", "mcxent", "softmax"),
    ("sigmoid", "mse", "identity"), ("elu", "xent", "sigmoid"),
    ("softplus", "negativeloglikelihood", "softmax")])
def test_mlp_gradients(act, loss, out_act):
    net = _mln(lambda b: b.activation(act).list()
               .layer(C.DenseLayer(n_out=6))
               .layer(C.OutputLayer(n_out=3, loss=loss, activation=out_act)),
               C.InputType.feed_forward(4))
    assert check_gradients(net, small_ds(), print_results=True)


@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.01, 0.0), (0.0, 0.01),
                                   (0.01, 0.02)])
def test_mlp_gradients_regularization(l1, l2):
    def tail(b):
        b = b.activation("tanh")
        if l1:
            b = b.l1(l1)
        if l2:
            b = b.l2(l2)
        return (b.list().layer(C.DenseLayer(n_out=5))
                .layer(C.OutputLayer(n_out=3, activation="softmax")))

    assert check_gradients(_mln(tail, C.InputType.feed_forward(4)),
                           small_ds())


def test_cnn_and_batchnorm_gradients():
    rng = np.random.default_rng(3)
    net = _mln(lambda b: b.list()
               .layer(C.ConvolutionLayer(n_out=3, kernel=(3, 3),
                                         activation="tanh",
                                         convolution_mode="same"))
               .layer(C.BatchNormalization(activation="identity"))
               .layer(C.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
               .layer(C.OutputLayer(n_out=2, activation="softmax")),
               C.InputType.convolutional_flat(6, 6, 1))
    ds = DataSet(rng.normal(size=(4, 36)), np.eye(2)[rng.integers(0, 2, 4)])
    assert check_gradients(net, ds, print_results=True)


@pytest.mark.parametrize("masked", [False, True])
def test_lstm_gradients(masked):
    rng = np.random.default_rng(5)
    B, T, nin, nout = 3, 5, 3, 2
    X = rng.normal(size=(B, T, nin))
    labels = np.eye(nout)[rng.integers(0, nout, (B, T))]
    mask = np.ones((B, T))
    mask[0, 3:] = 0
    mask[2, 2:] = 0
    net = _mln(lambda b: b.list()
               .layer(C.GravesLSTM(n_out=4, activation="tanh"))
               .layer(C.RnnOutputLayer(n_out=nout, activation="softmax")),
               C.InputType.recurrent(nin))
    ds = DataSet(X, labels, mask, mask) if masked else DataSet(X, labels)
    assert check_gradients(net, ds, print_results=True)


def test_graph_lstm_gradients_masked():
    rng = np.random.default_rng(9)
    B, T, nin, nout = 3, 5, 3, 2
    X = rng.normal(size=(B, T, nin))
    labels = np.eye(nout)[rng.integers(0, nout, (B, T))]
    mask = np.ones((B, T))
    mask[1, 3:] = 0
    mask[2, 1:] = 0
    conf = (C.NeuralNetConfiguration.Builder().seed(42).updater("none")
            .graph_builder().add_inputs("in")
            .add_layer("lstm", C.GravesLSTM(n_in=nin, n_out=4,
                                            activation="tanh"), "in")
            .add_layer("out", C.RnnOutputLayer(n_in=4, n_out=nout,
                                               activation="softmax"), "lstm")
            .set_outputs("out").build())
    g = ComputationGraph(conf, dtype=F64, device="cpu")
    g.init()
    assert check_gradients(g, MultiDataSet([X], [labels],
                                           features_masks=[mask],
                                           labels_masks=[mask]),
                           print_results=True)


def _residual(M, Vm):
    return (M.NeuralNetConfiguration.Builder().seed(8).updater("none")
            .activation("tanh").l2(0.01)
            .graph_builder().add_inputs("in")
            .add_layer("d1", M.DenseLayer(n_out=5), "in")
            .add_layer("d2", M.DenseLayer(n_out=5), "d1")
            .add_vertex("res", Vm.ElementWiseVertex(op="add"), "d1", "d2")
            .add_vertex("m", Vm.MergeVertex(), "res", "d1")
            .add_layer("out", M.OutputLayer(n_out=2, activation="softmax"),
                       "m")
            .set_outputs("out")
            .set_input_types(M.InputType.feed_forward(4))
            .build())


def test_residual_graph_gradients_match_numeric_and_the_jax_package():
    import jax.numpy as jnp

    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn import conf as JC
    from deeplearning4j_tpu.nn.conf import (
        computation_graph_configuration as JV,
    )
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.util.serialization import params_from_jax

    jnet = JGraph(_residual(JC, JV), dtype=jnp.float64)
    jnet.init()
    g = ComputationGraph(_residual(C, V), dtype=F64, device="cpu")
    g.set_param_tree(params_from_jax(g.conf, jnet._params))
    rng = np.random.default_rng(7)
    X, y = rng.normal(size=(6, 4)), np.eye(2)[rng.integers(0, 2, 6)]
    assert check_gradients(g, DataSet(X, y), print_results=True)
    jg, js = jnet.compute_gradient_and_score(JDataSet(X, y))
    pg, ps = g.compute_gradient_and_score(DataSet(X, y))
    assert ps == pytest.approx(js, rel=1e-12)
    np.testing.assert_allclose(pg, jg, rtol=1e-10, atol=1e-14)


def test_dropconnect_and_vae_gradients_on_the_deterministic_path():
    net = _mln(lambda b: b.drop_out(0.3).use_drop_connect(True).list()
               .layer(C.DenseLayer(n_out=6, activation="tanh"))
               .layer(C.OutputLayer(n_out=3, activation="softmax")),
               C.InputType.feed_forward(4))
    assert net.layers[0].use_drop_connect is True
    assert check_gradients(net, small_ds(), print_results=True)
    vae = _mln(lambda b: b.activation("tanh").list()
               .layer(C.VariationalAutoencoder(
                   n_out=3, encoder_layer_sizes=(7,),
                   decoder_layer_sizes=(7,)))
               .layer(C.OutputLayer(n_out=3, activation="softmax")),
               C.InputType.feed_forward(6))
    assert check_gradients(vae, small_ds(nin=6), print_results=True)


def test_a_wrong_analytic_gradient_fails_the_check():
    net = _mln(lambda b: b.activation("tanh").list()
               .layer(C.DenseLayer(n_out=4))
               .layer(C.OutputLayer(n_out=3, activation="softmax")),
               C.InputType.feed_forward(4))
    right = net.compute_gradient_and_score

    def wrong(ds):
        g, s = right(ds)
        g[3] *= 1.01
        return g, s

    net.compute_gradient_and_score = wrong
    assert not check_gradients(net, small_ds())
