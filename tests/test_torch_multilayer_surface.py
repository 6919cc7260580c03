"""The port's `MultiLayerNetwork` inference and bookkeeping surface held
against the JAX package on the CPU: `predict`, `score_examples`,
`summary`, `score_function`, `clone`, `get_health_sentinel`, and the
`train=` argument of `output` and `score`.

Two networks, an MLP whose hidden layer drops its inputs (Adam, L2) and
a 2-layer GPT with dropout, are written by the JAX package to its
checkpoint zip and restored by both packages. Deterministic results
agree to 1e-6 (rtol = atol: f32 sums in another order), `predict` and
`summary` exactly. Dropout draws differ between the packages (JAX
threefry keys against torch generators), so `output(train=True)` is held
by its statistics: through an identity network, the kept fraction and
the kept values.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    gpt_configuration as jgpt,
)
from deeplearning4j_tpu.nn.conf import (  # noqa: E402
    DenseLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.nn.updater import Updater  # noqa: E402
from deeplearning4j_tpu.ops.activations import Activation  # noqa: E402
from deeplearning4j_tpu.ops.losses import LossFunction  # noqa: E402
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
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


TOL = 1e-6
MODELS = ("mlp", "gpt")


def _mlp_conf():
    return (NeuralNetConfiguration.Builder()
            .seed(3).learning_rate(0.05).updater(Updater.ADAM).l2(1e-3)
            .activation(Activation.TANH)
            .list()
            .layer(DenseLayer(n_out=16, dropout=0.3))
            .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX, dropout=0.0))
            .set_input_type(InputType.feed_forward(4))
            .build())


def _gpt_conf():
    return jgpt(vocab_size=32, d_model=32, n_heads=2, n_layers=2,
                max_length=32, dropout=0.1, seed=4)


def _data(model, seed):
    """(features, labels): MLP rows with one-hot labels, or GPT token ids
    with the next ids as sparse labels."""
    rng = np.random.default_rng(seed)
    if model == "mlp":
        x = rng.standard_normal((8, 4)).astype(np.float32)
        return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    ids = rng.integers(0, 32, (2, 17))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


@pytest.fixture(scope="module", params=MODELS)
def nets(request, tmp_path_factory):
    """(model, reference net, port net, zip path): the reference network
    after one training step (nonzero optimizer state, iteration 1),
    written to the checkpoint zip and restored by both packages."""
    model = request.param
    jnet = JaxNet(_mlp_conf() if model == "mlp" else _gpt_conf())
    jnet.init()
    jnet.fit(JDataSet(*_data(model, 0)))
    path = tmp_path_factory.mktemp(model) / "net.zip"
    jser.write_model(jnet, path)
    return (model, jser.restore_multi_layer_network(path),
            pser.restore_multi_layer_network(path, device="cpu"), path)


def _close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_predict_is_identical(nets):
    model, jnet, pnet, _ = nets
    x, _ = _data(model, 1)
    got = pnet.predict(x)
    assert got.shape == tuple(np.asarray(x).shape[:-1]) + (() if model ==
                                                           "mlp" else (16,))
    np.testing.assert_array_equal(got.numpy(), jnet.predict(x))


def test_inference_scores_agree(nets):
    """`output(train=False)`, `score(train=False)` and `score(train=True)`
    (the train-mode forward without a dropout draw) and `score_examples`
    with and without the L2 penalty."""
    model, jnet, pnet, _ = nets
    x, y = _data(model, 2)
    _close(pnet.output(x, train=False), jnet.output(x, train=False))
    for train in (False, True):
        _close(pnet.score(DataSet(x, y), train=train),
               jnet.score(JDataSet(x, y), train=train))
    for reg in (False, True):
        got = pnet.score_examples(DataSet(x, y), add_regularization=reg)
        assert got.shape == (x.shape[0],)
        _close(got, jnet.score_examples(JDataSet(x, y),
                                        add_regularization=reg))


def test_score_function_agrees_at_and_off_the_parameters(nets):
    """The flat-parameter closure at the network's parameters (where it
    is the train-mode score) and at a perturbed vector, in the shared
    flat order; it is differentiable in the flat vector."""
    model, jnet, pnet, _ = nets
    x, y = _data(model, 3)
    flat = np.array(ravel_pytree(jnet._params)[0])
    np.testing.assert_array_equal(pnet.params().numpy(), flat)
    moved = flat + 1e-2 * np.random.default_rng(4).standard_normal(
        flat.shape).astype(np.float32)
    jf = jnet.score_function(JDataSet(x, y))
    pf = pnet.score_function(DataSet(x, y))
    for v in (flat, moved):
        _close(pf(torch.from_numpy(v)), jf(jnp.asarray(v)))
    leaf = torch.from_numpy(moved).requires_grad_()
    (g,) = torch.autograd.grad(pf(leaf), leaf)
    assert g.shape == leaf.shape and bool(torch.isfinite(g).all())


def test_summary_text_is_equal(nets):
    _, jnet, pnet, _ = nets
    assert pnet.summary() == jnet.summary()


def test_clone_copies_state_and_trains_like_a_fresh_net(nets):
    """A clone carries the iteration, epoch, score and optimizer state;
    one fit step of the clone leaves the original untouched and gives
    the parameters that the same step gives a network restored afresh
    from the zip."""
    model, _, pnet, path = nets
    before = pnet.params().clone()
    twin = pnet.clone()
    assert (twin.iteration, twin.epoch, twin.score_value) == \
        (pnet.iteration, pnet.epoch, pnet.score_value)
    batch = DataSet(*_data(model, 5))
    twin.fit(batch)
    assert torch.equal(pnet.params(), before)
    fresh = pser.restore_multi_layer_network(path, device="cpu")
    fresh.fit(batch)
    assert torch.equal(twin.params(), fresh.params())
    assert twin.iteration == pnet.iteration + 1


def test_health_sentinel_is_none(nets):
    _, jnet, pnet, _ = nets
    assert pnet.get_health_sentinel() is None
    assert jnet.get_health_sentinel() is None


@pytest.mark.parametrize("p", [0.25, 0.5])
def test_train_mode_output_drops_inputs_like_the_reference(p):
    """`output(x, train=True)` through an identity network (both layers'
    weights the identity, biases 0) whose hidden layer drops its inputs
    with probability p: every output is 0 or x / (1 - p), the kept
    fraction of 64 x 256 ones lies within 4 standard errors of 1 - p in
    both packages, so does the mean (1 in expectation); a second call at
    the same iteration draws the same mask, a later iteration another,
    and `train=False` gives x."""
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    n = 64
    conf = (NeuralNetConfiguration.Builder()
            .seed(6).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_out=n, activation=Activation.IDENTITY,
                              dropout=p))
            .layer(OutputLayer(n_out=n, activation=Activation.IDENTITY,
                               loss=LossFunction.MSE, dropout=0.0))
            .set_input_type(InputType.feed_forward(n))
            .build())
    eye = np.eye(n, dtype=np.float32)
    flat = np.concatenate([eye.ravel(), np.zeros(n, np.float32)] * 2)
    jnet = JaxNet(conf)
    jnet.init()
    jnet.set_params(flat)
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu")
    pnet.set_params(flat)
    x = np.ones((256, n), np.float32)
    keep = 1.0 - p
    se = np.sqrt(keep * p / x.size)
    for out in (np.asarray(jnet.output(x, train=True)),
                pnet.output(x, train=True).numpy()):
        kept = out != 0
        np.testing.assert_allclose(out[kept], 1.0 / keep, rtol=1e-6)
        assert abs(kept.mean() - keep) < 4 * se
        assert abs(out.mean() - 1.0) < 4 * se / keep
    again = pnet.output(x, train=True)
    assert torch.equal(again, pnet.output(x, train=True))
    pnet.iteration += 1
    assert not torch.equal(again, pnet.output(x, train=True))
    np.testing.assert_array_equal(pnet.output(x, train=False).numpy(), x)
