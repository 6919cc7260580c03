"""The port's line-search solvers (`optimize/solvers.py`) held against
the JAX package's on the CPU, from shared weights (`params_from_jax`).

Tolerances (f32): losses per iteration rtol 1e-5 over 3 iterations (the
solvers' host decisions, Armijo tests and LBFGS curvature checks, come
out the same; the values differ only in f32 summation order);
parameters rtol 1e-5 + atol 1e-5 (no updater state amplifies the
rounding here, unlike RMSPROP and Adam in ROADMAP's caveats). The flat
parameter order of `params()`/`_unravel` is pinned to
`jax.flatten_util.ravel_pytree`'s, which the JAX solver unravels with.
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
from deeplearning4j_tpu.nn import conf as jconf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.nn.updater import Updater as JUpdater  # noqa: E402
from deeplearning4j_tpu.optimize import solvers as jsolvers  # noqa: E402
from deeplearning4j_tpu.ops.activations import (  # noqa: E402
    Activation as JAct,
)
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.optimize import solvers as psolvers  # noqa: E402
from deeplearning4j_tpu_torch.optimize.health import (  # noqa: E402
    HealthSentinel,
)
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: E402
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.util import serialization as pser  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the tier runs
    several pytest-xdist workers on one host, and torch's default of a
    thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ALGOS = ["line_gradient_descent", "conjugate_gradient", "lbfgs"]
V, H, B, T = 8, 12, 4, 7


def _conf(model, algo, iterations=1):
    b = (jconf.NeuralNetConfiguration.Builder().seed(6).learning_rate(0.1)
         .optimization_algo(algo).iterations(iterations))
    if model == "dense":
        return (b.updater(JUpdater.SGD).activation(JAct.TANH).list()
                .layer(jconf.DenseLayer(n_out=10))
                .layer(jconf.OutputLayer(n_out=3, loss=JLoss.MCXENT,
                                         activation=JAct.SOFTMAX))
                .set_input_type(jconf.InputType.feed_forward(6)).build())
    return (b.updater(JUpdater.RMSPROP).list()
            .layer(jconf.GravesLSTM(n_in=V, n_out=H, activation=JAct.TANH))
            .layer(jconf.RnnOutputLayer(n_out=V, loss=JLoss.MCXENT,
                                        activation=JAct.SOFTMAX))
            .set_input_type(jconf.InputType.recurrent(V)).build())


def _data(model, seed=0):
    rng = np.random.default_rng(seed)
    if model == "dense":
        x = rng.standard_normal((16, 6)).astype(np.float32)
        return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    ids = rng.integers(0, V, (B, T + 1))
    return (np.eye(V, dtype=np.float32)[ids[:, :-1]],
            ids[:, 1:].astype(np.int32))


def _pair(model, algo, iterations=1):
    jnet = JaxNet(_conf(model, algo, iterations))
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(pser.params_from_jax(
        pnet.conf, jax.tree.map(np.asarray, jnet._params)))
    return jnet, pnet


def _params_close(jnet, pnet):
    np.testing.assert_allclose(pnet.params().numpy(),
                               np.asarray(jnet.params()), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("model", ["dense", "graves-lstm"])
def test_flat_parameter_order_is_ravel_pytrees(model):
    """`params()` is `ravel_pytree(_params)[0]`, and `_unravel` inverts
    it as `ravel_pytree`'s unravel does, bit for bit."""
    jnet, pnet = _pair(model, "lbfgs")
    flat, unravel = ravel_pytree(jnet._params)
    np.testing.assert_array_equal(pnet.params().numpy(), np.asarray(flat))
    probe = np.random.default_rng(1).standard_normal(flat.shape[0]) \
        .astype(np.float32)
    want = unravel(jnp.asarray(probe))
    got = pnet._unravel(probe)
    for a, b in zip(want, got):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


@pytest.mark.parametrize("model", ["dense", "graves-lstm"])
@pytest.mark.parametrize("algo", ALGOS)
def test_losses_per_iteration_match(model, algo):
    """Three fits of one iteration each on one batch: the score after
    each, and the parameters after the three."""
    jnet, pnet = _pair(model, algo)
    x, y = _data(model)
    first = pnet.score(DataSet(x, y))
    jl, pl = [], []
    for _ in range(3):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        jl.append(jnet.score_value)
        pl.append(pnet.score_value)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[0] < first and pl[-1] <= pl[0]
    assert pnet.iteration == jnet.iteration == 3
    _params_close(jnet, pnet)


@pytest.mark.parametrize("model", ["dense", "graves-lstm"])
@pytest.mark.parametrize("algo", ALGOS)
def test_three_solver_iterations_in_one_fit_match(model, algo):
    """`iterations(3)`: one fit runs three solver iterations (LBFGS
    keeps its curvature pairs across them)."""
    jnet, pnet = _pair(model, algo, iterations=3)
    x, y = _data(model, seed=2)
    first = pnet.score(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    np.testing.assert_allclose(pnet.score_value, jnet.score_value, rtol=1e-5)
    assert pnet.score_value < first
    _params_close(jnet, pnet)


def test_backtrack_line_search_matches():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((5, 5))
    A = (A @ A.T + np.eye(5)).astype(np.float32)
    x0 = rng.standard_normal(5).astype(np.float32)

    def run(mod, asarray):
        A_, x = asarray(A), asarray(x0)
        f = lambda v: 0.5 * (v @ (A_ @ v))
        g = A_ @ x
        v0 = float(f(x))
        out = [mod.backtrack_line_search(f, x, -g, v0, g, 8),
               mod.backtrack_line_search(f, x, g, v0, g, 8),
               mod.backtrack_line_search(f, x, -g, float("nan"), g, 8),
               mod.backtrack_line_search(f, x, -g, v0, g * float("inf"), 8)]
        return [(a, float(v)) for a, v in out]

    got = run(psolvers, torch.from_numpy)
    want = run(jsolvers, jnp.asarray)
    assert [a for a, _ in got] == [a for a, _ in want]
    assert got[0][0] > 0 and got[1][0] == 0.0 and got[2][0] == 0.0
    np.testing.assert_allclose([v for _, v in got[:2]],
                               [v for _, v in want[:2]], rtol=1e-6)


def test_fit_dispatches_to_the_solver_with_listeners_and_sentinel():
    _, pnet = _pair("graves-lstm", "conjugate_gradient")
    lis = CollectScoresIterationListener(1)
    sentinel = HealthSentinel()
    pnet.set_listeners(lis)
    pnet.set_health_sentinel(sentinel)
    x, y = _data("graves-lstm", seed=4)
    pnet.fit(DataSet(x, y), epochs=2)
    assert pnet.iteration == 2 and [i for i, _ in lis.scores] == [1, 2]
    assert sentinel.counters()["steps"] == 2
    assert sentinel.counters()["skips"] == 0


def test_a_non_finite_candidate_is_rejected_and_seen_as_a_skip(caplog):
    """A NaN batch: every line search refuses, the candidate is not
    committed (parameters unchanged), the sentinel counts a skip."""
    jnet, pnet = _pair("dense", "lbfgs")
    sentinel = HealthSentinel()
    pnet.set_health_sentinel(sentinel)
    x, y = _data("dense")
    x = x.copy()
    x[0, 0] = np.nan
    before = pnet.params().clone()
    pnet.fit(DataSet(x, y))
    assert torch.equal(pnet.params(), before)
    assert sentinel.counters()["skips"] == 1 and pnet.iteration == 1
    jnet.fit(JDataSet(x, y))
    np.testing.assert_array_equal(np.asarray(jnet.params()), before.numpy())
    solver = psolvers.Solver(pnet)
    assert not solver._commit(before * float("inf"), 1.0)
    assert solver.last_commit_rejected and torch.equal(pnet.params(), before)
    assert not psolvers.Solver(pnet)._commit(before, float("nan"))


def test_the_sgd_branch_matches_and_keeps_params_on_blowup():
    """`Solver` on an SGD network (the branch `fit` does not take: SGD has
    the network's own step): plain gradient steps at the global rate,
    and a blow-up keeps the previous parameters."""
    jnet, pnet = _pair("dense", "stochastic_gradient_descent")
    x, y = _data("dense", seed=5)
    got = psolvers.Solver(pnet).optimize(DataSet(x, y), iterations=2)
    want = jsolvers.Solver(jnet).optimize(JDataSet(x, y), iterations=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _params_close(jnet, pnet)
    before = pnet.params().clone()
    pnet.conf.global_conf.learning_rate = float("inf")
    s = psolvers.Solver(pnet)
    s.optimize(DataSet(x, y), iterations=1)
    assert s.last_commit_rejected and torch.equal(pnet.params(), before)
