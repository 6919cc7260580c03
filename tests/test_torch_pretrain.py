"""The pretraining family of the port (AutoEncoder, RBM, the VAE and its
reconstruction distributions, `MultiLayerNetwork.pretrain`) held against
the JAX package on the CPU.

Draws cannot be matched (threefry against torch generators), so parity
goes through the deterministic route: `pretrain_loss(params, x,
rng=None)` (the RBM's Gibbs chain on means, the VAE's eps = 0, no
corruption) and its gradient, in float64 from the same parameters,
within 1e-9 relative (1e-12 absolute), for every hidden and visible unit
of the RBM, the AutoEncoder's losses, and every reconstruction
distribution of the VAE (Composite included); `reconstruction_error`,
the VAE's `forward` and `generate_at_mean_given_z` the same way. An
AutoEncoder with `corruption_level=0` makes the whole `pretrain`
deterministic: after 2 epochs of 3 batches (f32, SGD and RMSPROP) the
parameters are within 1e-6 of the JAX package's (rtol = atol). The
sampled routes are held by what they must do: the RBM's CD-1 lowers
its reconstruction error, the VAE's sampled ELBO falls, and each is
deterministic per seed. The layers' JSON round-trips both ways.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as PL  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.util import serialization as pser  # noqa: E402

RTOL, ATOL = 1e-9, 1e-12


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


def _params64(layer_j, n_in, seed):
    """Random f64 parameters of the JAX layer's shapes (numpy, seeded),
    the biases too, so no term is trivially zero."""
    p = layer_j.init_params(jax.random.PRNGKey(seed), None, jnp.float64)
    rng = np.random.default_rng(seed)
    return {k: rng.normal(scale=0.5, size=v.shape) for k, v in p.items()}


def _parity(layer_j, layer_p, x, seed=0, fn="pretrain_loss"):
    """`fn(params, x, rng=None)` and its gradient in both packages."""
    params = _params64(layer_j, x.shape[1], seed)
    jfn = lambda p: getattr(layer_j, fn)(p, jnp.asarray(x), None)
    jl, jg = jax.value_and_grad(jfn)({k: jnp.asarray(v)
                                      for k, v in params.items()})
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
    pl = getattr(layer_p, fn)(leaves, torch.from_numpy(x), None)
    pg = torch.autograd.grad(pl, list(leaves.values()), allow_unused=True)
    assert float(pl.detach()) == pytest.approx(float(jl), rel=RTOL,
                                               abs=ATOL)
    for (k, _), g in zip(leaves.items(), pg):
        g = np.zeros_like(params[k]) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(jg[k]), rtol=1e-8,
                                   atol=ATOL, err_msg=k)
    return params


def _data(n=8, d=6, seed=0, binary=False, positive=False):
    rng = np.random.default_rng(seed)
    if binary:
        return (rng.random((n, d)) < 0.4).astype(np.float64)
    return rng.random((n, d)) if positive else rng.normal(size=(n, d))


# --------------------------------------------------------------- RBM
UNITS = [(h, v) for h in ("binary", "gaussian", "rectified", "softmax")
         for v in ("binary", "gaussian", "softmax", "linear")]


@pytest.mark.parametrize("hidden,visible", UNITS,
                         ids=[f"{h}-{v}" for h, v in UNITS])
def test_rbm_cd_loss_and_gradient_match_the_jax_package(hidden, visible):
    kw = dict(n_in=6, n_out=4, hidden_unit=hidden, visible_unit=visible,
              k=2, sparsity=0.05 if hidden == "binary" else 0.0,
              activation="sigmoid")
    lj, lp = JL.RBM(**kw), PL.RBM(**kw)
    x = _data(binary=visible == "binary", positive=visible == "softmax")
    params = _parity(lj, lp, x)
    got = lp.reconstruction_error({k: torch.from_numpy(v)
                                   for k, v in params.items()},
                                  torch.from_numpy(x))
    want = lj.reconstruction_error({k: jnp.asarray(v)
                                    for k, v in params.items()},
                                   jnp.asarray(x))
    assert got == pytest.approx(want, rel=RTOL)
    fe = lp.free_energy({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(fe, np.asarray(lj.free_energy(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


def test_rbm_refuses_k_below_one_and_its_sampled_chain_is_seeded():
    rbm = PL.RBM(n_in=6, n_out=4, k=0)
    p = {k: torch.from_numpy(v) for k, v in
         _params64(JL.RBM(n_in=6, n_out=4), 6, 1).items()}
    with pytest.raises(ValueError, match="k >= 1"):
        rbm.pretrain_loss(p, torch.from_numpy(_data(binary=True)), None)
    rbm = PL.RBM(n_in=6, n_out=4, k=1, hidden_unit="rectified")
    x = torch.from_numpy(_data(binary=True))
    draw = lambda s: rbm.pretrain_loss(p, x, torch.Generator().manual_seed(s))
    assert float(draw(3)) == float(draw(3))
    assert float(draw(3)) != float(draw(4))


# ------------------------------------------------------- AutoEncoder
@pytest.mark.parametrize("loss,act", [("mse", "sigmoid"), ("xent", "sigmoid"),
                                      ("l2", "tanh"), ("mcxent", "softmax")])
def test_autoencoder_loss_and_gradient_match_the_jax_package(loss, act):
    kw = dict(n_in=6, n_out=3, loss=loss, activation=act,
              corruption_level=0.3)
    _parity(JL.AutoEncoder(**kw), PL.AutoEncoder(**kw),
            _data(positive=True))


# --------------------------------------------------------------- VAE
def _dists(M):
    return {
        "gaussian": M.GaussianReconstructionDistribution(),
        "gaussian-tanh": M.GaussianReconstructionDistribution(
            activation="tanh"),
        "bernoulli": M.BernoulliReconstructionDistribution(),
        "bernoulli-hardsigmoid": M.BernoulliReconstructionDistribution(
            activation="hardsigmoid"),
        "exponential": M.ExponentialReconstructionDistribution(),
        "loss-wrapper": M.LossFunctionWrapper(loss="l1",
                                              activation="tanh"),
        "composite": M.CompositeReconstructionDistribution(parts=[
            (2, M.GaussianReconstructionDistribution()),
            (2, M.BernoulliReconstructionDistribution()),
            (2, M.ExponentialReconstructionDistribution())]),
    }


@pytest.mark.parametrize("dist", sorted(_dists(JC)))
def test_vae_elbo_and_gradient_match_the_jax_package(dist):
    kw = dict(n_in=6, n_out=2, encoder_layer_sizes=(5, 4),
              decoder_layer_sizes=(4,), activation="tanh",
              pzx_activation="identity", num_samples=3)
    lj = JC.VariationalAutoencoder(reconstruction_distribution=_dists(JC)[dist],
                                   **kw)
    lp = PC.VariationalAutoencoder(reconstruction_distribution=_dists(PC)[dist],
                                   **kw)
    x = _data(positive=True) if dist != "composite" else np.concatenate(
        [_data(d=2), _data(d=2, binary=True, seed=1),
         _data(d=2, positive=True, seed=2)], axis=1)
    if dist.startswith("bernoulli"):
        x = _data(binary=True)
    params = _parity(lj, lp, x)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    np.testing.assert_allclose(
        lp.forward(tp, torch.from_numpy(x)).numpy(),
        np.asarray(lj.forward(jp, {}, jnp.asarray(x))[0]), rtol=RTOL,
        atol=ATOL)
    z = np.random.default_rng(5).normal(size=(3, 2))
    np.testing.assert_allclose(
        lp.generate_at_mean_given_z(tp, torch.from_numpy(z)).numpy(),
        np.asarray(lj.generate_at_mean_given_z(jp, jnp.asarray(z))),
        rtol=RTOL, atol=ATOL)
    lp_x = lambda s: lp.reconstruction_probability(
        tp, torch.from_numpy(x), 4, torch.Generator().manual_seed(s))
    assert torch.equal(lp_x(1), lp_x(1)) and lp_x(1).shape == (8,)
    assert torch.isfinite(lp_x(2)).all()
    assert {k: tuple(v.shape) for k, v in lp.init_params(
        torch.Generator().manual_seed(0), None).items()} == \
        {k: v.shape for k, v in params.items()}


def test_composite_distribution_refuses_a_wrong_width():
    d = PC.CompositeReconstructionDistribution().add_distribution(
        3, PC.BernoulliReconstructionDistribution())
    with pytest.raises(ValueError, match="cover 3"):
        d.distribution_input_size(4)


# --------------------------------------------------------------- JSON
def _pretrain_net(C, vae_dist):
    return (C.NeuralNetConfiguration.Builder().seed(3).learning_rate(0.05)
            .updater("rmsprop").activation("tanh").list()
            .layer(C.AutoEncoder(n_out=5, corruption_level=0.2, loss="xent",
                                 activation="sigmoid"))
            .layer(C.RBM(n_out=4, hidden_unit="rectified",
                         visible_unit="gaussian", k=3, sparsity=0.1))
            .layer(C.VariationalAutoencoder(
                n_out=2, encoder_layer_sizes=[3], decoder_layer_sizes=[3, 3],
                reconstruction_distribution=vae_dist))
            .layer(C.OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(C.InputType.feed_forward(6))
            .build())


@pytest.mark.parametrize("dist", ["gaussian", "loss-wrapper", "composite"])
def test_pretraining_layers_json_round_trips_both_ways(dist):
    if dist == "composite":
        make = lambda C: C.CompositeReconstructionDistribution(parts=[
            (2, C.GaussianReconstructionDistribution(activation="tanh")),
            (4, C.BernoulliReconstructionDistribution())])
    else:
        make = lambda C: _dists(C)[dist]
    text = _pretrain_net(JC, make(JC)).to_json()
    port = _pretrain_net(PC, make(PC))
    assert port.to_json() == text
    assert PC.MultiLayerConfiguration.from_json(text).to_json() == text
    assert JC.MultiLayerConfiguration.from_json(port.to_json()).to_json() \
        == text
    back = PC.MultiLayerConfiguration.from_json(text)
    assert isinstance(back.layers[1].hidden_unit, PL.HiddenUnit)
    assert back.layers[2].encoder_layer_sizes == (3,)


# ------------------------------------------------------ pretrain runs
def _ae_stack(C, updater):
    return (C.NeuralNetConfiguration.Builder().seed(21).learning_rate(0.05)
            .updater(updater).list()
            .layer(C.DenseLayer(n_out=8, activation="tanh"))
            .layer(C.AutoEncoder(n_out=5, corruption_level=0.0,
                                 activation="sigmoid"))
            .layer(C.AutoEncoder(n_out=3, corruption_level=0.0, loss="xent",
                                 activation="sigmoid"))
            .layer(C.OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(C.InputType.feed_forward(6))
            .build())


@pytest.mark.parametrize("updater", ["sgd", "rmsprop"])
def test_uncorrupted_autoencoder_pretrain_matches_the_jax_package(updater):
    jnet = JaxNet(_ae_stack(JC, updater))
    jnet.init()
    pnet = MultiLayerNetwork(_ae_stack(PC, updater), device="cpu")
    pnet.set_param_tree(pser.params_from_jax(pnet.conf, jnet._params))
    rng = np.random.default_rng(0)
    xs = [rng.random((16, 6)).astype(np.float32) for _ in range(3)]
    jnet.pretrain(JListIterator([JDataSet(x, None) for x in xs]), epochs=2)
    pnet.pretrain(ListDataSetIterator([DataSet(x, None) for x in xs]),
                  epochs=2)
    for i, (jp, pp) in enumerate(zip(jnet._params, pnet._params)):
        for k in jp:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"layer {i} {k}")
    assert pnet.score_value == pytest.approx(jnet.score_value, rel=1e-5)
    assert pnet.iteration == 0   # pretraining leaves the fit clock alone


def _rbm_net(seed):
    return (PC.NeuralNetConfiguration.Builder().seed(seed).learning_rate(0.1)
            .updater("sgd").list()
            .layer(PC.RBM(n_out=8, k=1))
            .layer(PC.OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(PC.InputType.feed_forward(16))
            .build())


def _binary_templates(n, d, seed):
    rng = np.random.default_rng(seed)
    templates = (rng.random((4, d)) < 0.5).astype(np.float32)
    flips = (rng.random((n, d)) < 0.05).astype(np.float32)
    return np.abs(templates[rng.integers(0, 4, n)] - flips)


def test_rbm_cd1_pretrain_lowers_reconstruction_error_and_is_seeded():
    x = _binary_templates(64, 16, seed=1)
    nets = []
    for seed in (7, 7, 8):
        net = MultiLayerNetwork(_rbm_net(seed), device="cpu")
        net.init()
        nets.append(net)
    rbm = nets[0].layers[0]
    before = rbm.reconstruction_error(nets[0]._params[0], torch.from_numpy(x))
    for net in nets:
        net.pretrain(ListDataSetIterator([DataSet(x, None)]), epochs=40)
    after = rbm.reconstruction_error(nets[0]._params[0], torch.from_numpy(x))
    assert after < 0.8 * before
    assert torch.equal(nets[0].params(), nets[1].params())
    assert not torch.equal(nets[0].params(), nets[2].params())


def test_vae_sampled_elbo_falls_in_a_graph():
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = (PC.NeuralNetConfiguration.Builder().seed(4).learning_rate(0.01)
            .updater("adam").activation("tanh").graph_builder()
            .add_inputs("in")
            .add_layer("vae", PC.VariationalAutoencoder(
                n_in=16, n_out=2, encoder_layer_sizes=(12,),
                decoder_layer_sizes=(12,), num_samples=2,
                reconstruction_distribution=
                PC.BernoulliReconstructionDistribution()), "in")
            .add_layer("out", PC.OutputLayer(n_in=2, n_out=2,
                                             activation="softmax"), "vae")
            .set_outputs("out").build())
    x = torch.from_numpy(_binary_templates(64, 16, seed=2))
    g = ComputationGraph(conf, device="cpu")
    g.init()
    vae = conf.nodes["vae"].layer
    elbo = lambda: float(vae.pretrain_loss(g._params["vae"], x, None))
    before = elbo()
    g.pretrain(DataSet(x.numpy(), None), epochs=60)
    assert elbo() < 0.8 * before
    assert np.isfinite(g.score_value)
    out = g.output(x.numpy())[0]
    assert out.shape == (64, 2) and torch.isfinite(out).all()
