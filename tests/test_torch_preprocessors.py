"""The port's input preprocessors and their configuration wiring held
against the JAX package on the CPU: each preprocessor's forward on the
same seeded inputs (exact for the reshapes, rtol = atol = 1e-5 for the
batch statistics, which sum in another order), the preprocessors a
builder inserts, the `n_in` it infers and the errors it raises, and
configuration JSON with preprocessors written by either package parsing
in the other and re-serializing equal. BinomialSampling's draws are held
by their statistics."""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.conf import preprocessors as jpre  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import preprocessors as ppre  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)


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


CASES = {
    "cnn_to_ff": (("CnnToFeedForwardPreProcessor", (3, 4, 2)), (5, 3, 4, 2)),
    "ff_to_cnn": (("FeedForwardToCnnPreProcessor", (3, 4, 2)), (5, 24)),
    "rnn_to_ff": (("RnnToFeedForwardPreProcessor", ()), (5, 3, 4)),
    "ff_to_rnn": (("FeedForwardToRnnPreProcessor", (3,)), (6, 4)),
    "cnn_to_rnn": (("CnnToRnnPreProcessor", (3, 4, 2)), (5, 3, 4, 2)),
    "rnn_to_cnn": (("RnnToCnnPreProcessor", (2, 3, 2)), (4, 3, 12)),
    "reshape": (("ReshapePreProcessor", ((2, 3, 4),)), (5, 24)),
    "zero_mean": (("ZeroMeanPrePreProcessor", ()), (7, 5)),
    "unit_variance": (("UnitVarianceProcessor", ()), (7, 5)),
    "zero_mean_unit_variance": (("ZeroMeanAndUnitVariancePreProcessor", ()),
                                (7, 5)),
    "binomial_eval": (("BinomialSamplingPreProcessor", ()), (7, 5)),
}


def _pair(name, args):
    return getattr(jpre, name)(*args), getattr(ppre, name)(*args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocessor_forward_equals_the_jax_package(case):
    (name, args), shape = CASES[case]
    jp, pp = _pair(name, args)
    x = np.random.default_rng(0).uniform(0.1, 0.9, shape).astype(np.float32)
    want = np.asarray(jp.preprocess(jnp.asarray(x)))
    got = pp.preprocess(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    if "Mean" not in name and "Variance" not in name:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_composable_preprocessor_and_json():
    jp = jpre.ComposableInputPreProcessor(
        jpre.FeedForwardToCnnPreProcessor(2, 3, 2),
        jpre.CnnToFeedForwardPreProcessor(2, 3, 2),
        jpre.ZeroMeanPrePreProcessor())
    pp = ppre.preprocessor_from_json(jpre.preprocessor_to_json(jp))
    assert ppre.preprocessor_to_json(pp) == jpre.preprocessor_to_json(jp)
    x = np.random.default_rng(1).standard_normal((4, 12)).astype(np.float32)
    np.testing.assert_allclose(pp.preprocess(torch.tensor(x)).numpy(),
                               np.asarray(jp.preprocess(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocessor_json_both_ways(case):
    (name, args), _ = CASES[case]
    jp, pp = _pair(name, args)
    text = json.dumps(ppre.preprocessor_to_json(pp))
    assert text == json.dumps(jpre.preprocessor_to_json(jp))
    back = jpre.preprocessor_from_json(json.loads(text))
    assert json.dumps(jpre.preprocessor_to_json(back)) == text
    again = ppre.preprocessor_from_json(json.loads(text))
    assert json.dumps(ppre.preprocessor_to_json(again)) == text


def test_binomial_sampling_statistics():
    """Training draws Bernoulli(x) (mean x, values 0/1, the same draw for
    the same rng); inference passes x through."""
    pp = ppre.BinomialSamplingPreProcessor()
    x = torch.full((400, 500), 0.3)
    y = pp.preprocess(x, rng=(1, 0, 2), train=True)
    assert set(torch.unique(y).tolist()) == {0.0, 1.0}
    assert abs(y.mean().item() - 0.3) < 0.01
    assert torch.equal(y, pp.preprocess(x, rng=(1, 0, 2), train=True))
    assert torch.equal(pp.preprocess(x, rng=(1, 0, 2), train=False), x)


def _cnn_stack(C, flat=True, explicit=None):
    """A small CNN stack built the same way in either package `C`."""
    it = C.InputType.convolutional_flat(8, 8, 1) if flat \
        else C.InputType.convolutional(8, 8, 1)
    b = (C.NeuralNetConfiguration.Builder().seed(3).list()
         .layer(C.ConvolutionLayer(n_out=4, kernel=(3, 3)))
         .layer(C.BatchNormalization())
         .layer(C.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
         .layer(C.DenseLayer(n_out=6))
         .layer(C.OutputLayer(n_out=3)))
    if explicit:
        for i, p in explicit.items():
            b = b.input_pre_processor(i, p)
    return b.set_input_type(it).build()


@pytest.mark.parametrize("flat", [True, False])
def test_builder_inserts_the_same_preprocessors_and_n_in(flat):
    jconf, pconf = _cnn_stack(JC, flat), _cnn_stack(PC, flat)
    assert sorted(pconf.preprocessors) == sorted(jconf.preprocessors) \
        == ([0, 3] if flat else [3])
    assert [getattr(l, "n_in", None) for l in pconf.layers] == \
        [getattr(l, "n_in", None) for l in jconf.layers]
    assert pconf.to_json() == jconf.to_json()


def test_configuration_json_with_preprocessors_both_ways():
    explicit_j = {4: jpre.ComposableInputPreProcessor(
        jpre.ZeroMeanPrePreProcessor())}
    explicit_p = {4: ppre.ComposableInputPreProcessor(
        ppre.ZeroMeanPrePreProcessor())}
    jtext = _cnn_stack(JC, explicit=explicit_j).to_json()
    ptext = _cnn_stack(PC, explicit=explicit_p).to_json()
    assert ptext == jtext
    assert PC.MultiLayerConfiguration.from_json(jtext).to_json() == jtext
    assert JC.MultiLayerConfiguration.from_json(ptext).to_json() == ptext
    assert "zero_mean" in json.loads(ptext)["preprocessors"]["4"][
        "children"][0]["type"]


@pytest.mark.parametrize("which", ["cnn_after_ff", "rnn_after_ff"])
def test_builder_raises_the_same_errors(which):
    def stack(C):
        if which == "cnn_after_ff":
            layer = C.ConvolutionLayer(n_out=2, kernel=(2, 2))
        else:
            layer = C.GravesLSTM(n_out=2)
        return (C.NeuralNetConfiguration.Builder().list()
                .layer(layer).layer(C.OutputLayer(n_out=2))
                .set_input_type(C.InputType.feed_forward(16)).build())

    with pytest.raises(ValueError) as want:
        stack(JC)
    with pytest.raises(ValueError) as got:
        stack(PC)
    assert str(got.value) == str(want.value)


def test_network_applies_explicit_preprocessors_on_every_path():
    """An RnnToFeedForward / FeedForwardToRnn pair around a dense layer:
    output, feed_forward and summary agree with the JAX package."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
    from deeplearning4j_tpu_torch.util.serialization import params_from_jax

    def conf(C, P):
        return (C.NeuralNetConfiguration.Builder().seed(5).list()
                .layer(C.DenseLayer(n_in=4, n_out=6, activation="tanh"))
                .layer(C.RnnOutputLayer(n_in=6, n_out=3,
                                        activation="softmax"))
                .input_pre_processor(0, P.RnnToFeedForwardPreProcessor())
                .input_pre_processor(1, P.FeedForwardToRnnPreProcessor(5))
                .set_input_type(C.InputType.recurrent(4, 5)).build())

    jnet = JaxNet(conf(JC, jpre))
    jnet.init()
    pnet = MultiLayerNetwork(conf(PC, ppre), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, jnet._params))
    x = np.random.default_rng(2).standard_normal((2, 5, 4)).astype(
        np.float32)
    np.testing.assert_allclose(pnet.output(x).numpy(), jnet.output(x),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(pnet.feed_forward(x), jnet.feed_forward(x)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)
    assert pnet.summary() == jnet.summary()
