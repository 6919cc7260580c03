"""The clustering package of the port (`deeplearning4j_tpu_torch.clustering`)
and `util.berkeley` against the JAX package's, on the CPU at small sizes:
a counterpart of every test of `tests/test_clustering.py`; the host trees
give the same answers; one Lloyd step and whole k-means fits give equal
labels and centroids to 1e-5; the t-SNE step and KL agree to 1e-5 from
identical inputs, `Tsne` runs of at most 20 iterations to 1e-4 of the
embedding's extent, longer runs by their KL history and separation;
`BarnesHutTsne` (the same f64 host numpy) to 1e-10; and the `berkeley`
tests of `tests/test_aux.py`."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import kmeans as jkm
from deeplearning4j_tpu.clustering import tsne as jts
import deeplearning4j_tpu.clustering as J
import deeplearning4j_tpu_torch.clustering as T
from deeplearning4j_tpu_torch.clustering import kmeans as tkm
from deeplearning4j_tpu_torch.clustering import tsne as tts

CPU = {"device": "cpu"}


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


def _blobs(n_per=60, centers=((0, 0, 0), (10, 10, 10), (-10, 10, -10)), seed=0):
    rng = np.random.default_rng(seed)
    X, y = [], []
    for c, mu in enumerate(centers):
        X.append(rng.normal(size=(n_per, len(mu))) + np.asarray(mu))
        y += [c] * n_per
    return np.concatenate(X).astype(np.float32), np.array(y)


def _separation(Y, y):
    d01 = np.linalg.norm(Y[y == 0].mean(0) - Y[y == 1].mean(0))
    spread0 = np.linalg.norm(Y[y == 0] - Y[y == 0].mean(0), axis=1).mean()
    return d01 / spread0


# ------------------------------------------------------------------- kmeans

def test_kmeans_recovers_blobs():
    X, y = _blobs()
    km = T.KMeansClustering(k=3, seed=1, **CPU).fit(X)
    labels = km.labels_
    for c in range(3):
        counts = np.bincount(labels[y == c], minlength=3)
        assert counts.max() / counts.sum() > 0.95
    assert km.predict(X[:5]).shape == (5,)


def test_kmeans_too_few_points():
    with pytest.raises(ValueError):
        T.KMeansClustering(k=5, **CPU).fit(np.zeros((3, 2), np.float32))


def test_kmeans_labels_consistent_with_predict():
    X, _ = _blobs()
    km = T.KMeansClustering(k=3, seed=1, **CPU).fit(X)
    np.testing.assert_array_equal(km.labels_, km.predict(X))


def test_kmeans_labels_and_cost_describe_the_stored_centroids():
    """One iteration from k-means++ moves the centroids; `labels_` and
    `cost` are measured against the moved ones, not the seeds."""
    X, _ = _blobs(n_per=40, centers=((0, 0), (3, 0), (0, 3), (3, 3)), seed=4)
    km = T.KMeansClustering(k=4, max_iterations=1, seed=2, **CPU).fit(X)
    seeds = km._seed_centroids(X)
    d = ((X[:, None, :] - km.centroids[None]) ** 2).sum(-1)
    d_seed = ((X[:, None, :] - seeds[None]) ** 2).sum(-1)
    assert (d.argmin(1) != d_seed.argmin(1)).any()  # the step moved labels
    np.testing.assert_array_equal(km.labels_, d.argmin(1))
    assert km.cost == pytest.approx(float(d.min(1).sum()), rel=1e-5)


def test_lloyd_step_matches_with_an_empty_cluster():
    """One step from identical inputs: centroids and cost to 1e-5,
    assignments equal; a centroid far from every point keeps its place."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(300, 8)).astype(np.float32)
    C = X[rng.choice(300, 6, replace=False)].copy()
    C[4] = 100.0  # no point is nearest to it
    jc, ja, jcost = jkm._lloyd_step(jnp.asarray(X), jnp.asarray(C))
    tc, ta, tcost = tkm._lloyd_step(torch.from_numpy(X), torch.from_numpy(C))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tc.numpy()[4], C[4])
    assert float(tcost) == pytest.approx(float(jcost), rel=1e-5)


@pytest.mark.parametrize("k,init,seed", [(3, "kmeans++", 1), (3, "random", 2),
                                         (5, "kmeans++", 3)])
def test_kmeans_fits_match(k, init, seed):
    X, _ = _blobs(seed=seed)
    a = J.KMeansClustering(k=k, init=init, seed=seed).fit(X)
    b = T.KMeansClustering(k=k, init=init, seed=seed, **CPU).fit(X)
    np.testing.assert_array_equal(b.labels_, a.labels_)
    np.testing.assert_allclose(b.centroids, a.centroids, rtol=1e-5,
                               atol=1e-5)
    assert b.cost == pytest.approx(a.cost, rel=1e-5)
    np.testing.assert_array_equal(b.predict(X[:17]), a.predict(X[:17]))


def test_kmeans_takes_a_tensor_and_full_f32_restores_tf32():
    X, _ = _blobs(n_per=20)
    a = T.KMeansClustering(k=3, seed=1, **CPU).fit(X)
    b = T.KMeansClustering(k=3, seed=1, **CPU).fit(torch.from_numpy(X))
    np.testing.assert_array_equal(a.labels_, b.labels_)
    m = torch.backends.cuda.matmul
    was = m.allow_tf32
    try:
        for setting in (True, False):
            m.allow_tf32 = setting
            with tkm.full_f32():
                assert m.allow_tf32 is False
            assert m.allow_tf32 is setting
    finally:
        m.allow_tf32 = was


# ------------------------------------------------------------------- kdtree

def test_kdtree_matches_bruteforce():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(200, 4))
    tree = T.KDTree(X)
    q = rng.normal(size=4)
    d = np.linalg.norm(X - q, axis=1)
    order = np.argsort(d)
    knn = tree.knn(q, 5)
    assert [i for i, _ in knn] == list(order[:5])
    nn_i, nn_d = tree.nn(q)
    assert nn_i == order[0]
    assert nn_d == pytest.approx(d[order[0]])
    assert knn == J.KDTree(X).knn(q, 5)


def test_kdtree_range_query():
    X = np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [5.0, 5.0]])
    tree = T.KDTree(X)
    assert tree.range([0.5, 0.5], [2.5, 2.5]) == [1, 2]
    rng = np.random.default_rng(8)
    Z = rng.normal(size=(150, 3))
    assert T.KDTree(Z).range([-0.5] * 3, [0.7] * 3) == \
        J.KDTree(Z).range([-0.5] * 3, [0.7] * 3)


# ------------------------------------------------------------------- vptree

def test_vptree_matches_bruteforce():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 6))
    tree = T.VPTree(X)
    ref = J.VPTree(X)
    for qi in range(3):
        q = rng.normal(size=6)
        d = np.linalg.norm(X - q, axis=1)
        order = np.argsort(d)
        knn = tree.knn(q, 8)
        assert [i for i, _ in knn] == list(order[:8])
        assert knn == ref.knn(q, 8)


# ---------------------------------------------------------------- BH trees

def test_quadtree_com_and_counts():
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    qt = T.QuadTree.build(pts)
    assert qt.n_points == 4
    np.testing.assert_allclose(qt.com, [0.5, 0.5])
    with pytest.raises(ValueError):
        T.QuadTree.build(np.zeros((3, 3)))


def test_sptree_barnes_hut_matches_exact_at_theta_zero():
    rng = np.random.default_rng(4)
    Y = rng.normal(size=(50, 2))
    sp = T.SpTree.build(Y)
    i = 7
    neg = np.zeros(2)
    Z = sp.compute_non_edge_forces(Y[i], 0.0, neg)  # theta=0 → exact
    diff = Y[i] - Y
    d2 = np.sum(diff * diff, axis=1)
    q = 1.0 / (1.0 + d2)
    mask = np.arange(50) != i
    Z_exact = np.sum(q[mask])
    neg_exact = np.sum((q[mask] ** 2)[:, None] * diff[mask], axis=0)
    assert Z == pytest.approx(Z_exact, rel=1e-9)
    np.testing.assert_allclose(neg, neg_exact, rtol=1e-9)


def test_sptree_forces_match_the_reference_at_theta_half():
    rng = np.random.default_rng(9)
    Y = rng.normal(size=(120, 3))
    a, b = J.SpTree.build(Y), T.SpTree.build(Y)
    for i in (0, 17, 99):
        na, nb = np.zeros(3), np.zeros(3)
        assert b.compute_non_edge_forces(Y[i], 0.5, nb) == \
            a.compute_non_edge_forces(Y[i], 0.5, na)
        np.testing.assert_array_equal(nb, na)


def test_sptree_duplicate_points():
    pts = np.zeros((10, 3))
    sp = T.SpTree.build(pts)  # must not recurse forever
    assert sp.n_points == 10
    assert sp._point_count == 10


def test_sptree_stacked_duplicates_subdivide_correctly():
    pts = np.array([[0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [5.0, 5.0]])
    sp = T.SpTree.build(pts)
    q = np.array([1.0, 1.0])
    neg = np.zeros(2)
    Z = sp.compute_non_edge_forces(q, 0.0, neg)
    d2 = np.sum((q - pts) ** 2, axis=1)
    qk = 1.0 / (1.0 + d2)
    assert Z == pytest.approx(np.sum(qk), rel=1e-9)


# --------------------------------------------------------------------- tsne

def _step_inputs(N, seed):
    rng = np.random.default_rng(seed)
    Y = (rng.normal(size=(N, 2)) * 5).astype(np.float32)
    V = (rng.normal(size=(N, 2)) * 0.1).astype(np.float32)
    G = rng.uniform(0.5, 2.0, size=(N, 2)).astype(np.float32)
    P = rng.random((N, N)).astype(np.float32)
    P = P + P.T
    np.fill_diagonal(P, 0.0)
    return Y, V, G, (P / P.sum()).astype(np.float32)


@pytest.mark.parametrize("N,exag,momentum", [(256, 12.0, 0.5),
                                             (700, 1.0, 0.8)])
def test_tsne_step_and_kl_match(N, exag, momentum):
    Y, V, G, P = _step_inputs(N, N)
    a = jts._tsne_step(jnp.asarray(Y), jnp.asarray(V), jnp.asarray(G),
                       jnp.asarray(P) * exag, jnp.float32(momentum),
                       jnp.float32(200.0), jnp.float32(0.01))
    b = tts._tsne_step(torch.from_numpy(Y), torch.from_numpy(V),
                       torch.from_numpy(G), torch.from_numpy(P) * exag,
                       momentum, 200.0, 0.01)
    for x, y in zip(a, b):
        x = np.asarray(x)
        np.testing.assert_allclose(y.numpy(), x, rtol=0,
                                   atol=1e-5 * np.abs(x).max())
    ka = float(jts._tsne_kl(jnp.asarray(Y), jnp.asarray(P)))
    kb = float(tts._tsne_kl(torch.from_numpy(Y), torch.from_numpy(P)))
    assert kb == pytest.approx(ka, rel=1e-5)


def test_tsne_step_masks_the_diagonal():
    """The diagonal of the affinities never enters Q: moving every P_ii
    changes nothing."""
    Y, V, G, P = _step_inputs(64, 1)
    Pd = P.copy()
    np.fill_diagonal(Pd, 0.0)
    num = tts._affinities(torch.from_numpy(Y))
    assert torch.all(torch.diagonal(num) == 0)
    a = tts._tsne_step(torch.from_numpy(Y), torch.from_numpy(V),
                       torch.from_numpy(G), torch.from_numpy(Pd), 0.5,
                       200.0, 0.01)
    d = np.sum((Y[:, None] - Y[None]) ** 2, -1).astype(np.float64)
    q = 1.0 / (1.0 + d)
    np.fill_diagonal(q, 0.0)
    Q = q / q.sum()
    PQ = (Pd - np.maximum(Q, 1e-12)) * q
    grad = 4.0 * (PQ.sum(1)[:, None] * Y - PQ @ Y)
    ref_vel = 0.5 * V - 200.0 * np.where(grad * V > 0, G * 0.8, G + 0.2) * grad
    np.testing.assert_allclose(a[1].numpy(), ref_vel, rtol=1e-4,
                               atol=1e-4 * np.abs(ref_vel).max())


@pytest.mark.parametrize("n_iter,normalize", [(20, False), (12, True)])
def test_short_tsne_runs_match(n_iter, normalize):
    X, _ = _blobs(n_per=30)
    kw = dict(perplexity=15.0, n_iter=n_iter, learning_rate=100.0, seed=5,
              normalize=normalize, error_every=5)
    a = J.Tsne(**kw)
    b = T.Tsne(**kw, **CPU)
    ya, yb = a.fit_transform(X), b.fit_transform(X)
    assert isinstance(yb, np.ndarray) and yb.dtype == np.float32
    np.testing.assert_allclose(yb, ya, rtol=0, atol=1e-4 * np.abs(ya).max())
    np.testing.assert_allclose(b.error_history_, a.error_history_,
                               rtol=1e-4)
    np.testing.assert_array_equal(b._input_probabilities(X),
                                  a._input_probabilities(X))


def test_exact_tsne_separates_blobs():
    X, y = _blobs(n_per=40)
    ts = T.Tsne(perplexity=15.0, n_iter=300, learning_rate=100.0, seed=5,
                **CPU)
    Y = ts.fit_transform(X)
    assert Y.shape == (120, 2)
    assert np.isfinite(ts.kl_divergence_)
    assert _separation(Y, y) > 2


def test_tsne_error_reporting_and_schedules():
    """Reference parity knobs: listener hook + per-iteration KL
    reporting, momentum switch, stop-lying iteration, min_gain,
    normalize — and KL must DECREASE over training, in both packages (the
    trajectories part after a few dozen iterations: t-SNE amplifies the
    last bits of a sum, so longer runs are held by their own KL history,
    not by each other's positions)."""
    rng = np.random.RandomState(4)
    X = np.concatenate([rng.randn(25, 6) + 4.0, rng.randn(25, 6) - 4.0])
    for make in (lambda **k: J.Tsne(**k), lambda **k: T.Tsne(**k, **CPU)):
        seen = []
        ts = make(perplexity=10.0, n_iter=240, learning_rate=100.0, seed=2,
                  normalize=True, error_every=60,
                  switch_momentum_iteration=120, stop_lying_iteration=80,
                  listeners=[lambda model, it, kl: seen.append((it, kl))])
        ts.fit_transform(X)
        assert [it for it, _ in seen] == [60, 120, 180, 240]
        assert ts.error_history_ == [kl for _, kl in seen]
        assert seen[-1][1] < seen[1][1]
        assert np.isfinite(ts.kl_divergence_)
        assert ts.kl_divergence_ == seen[-1][1]


def test_tsne_schedule_helpers_match():
    for kw in ({}, {"n_iter": 40}, {"stop_lying_iteration": 7,
                                    "switch_momentum_iteration": 3}):
        a, b = J.Tsne(**kw), T.Tsne(**kw, **CPU)
        assert b._stop_lying() == a._stop_lying()
        assert [b._momentum(i) for i in range(300)] == \
            [a._momentum(i) for i in range(300)]


def test_barnes_hut_tsne_runs_and_separates():
    X, y = _blobs(n_per=25)
    ts = T.BarnesHutTsne(theta=0.5, perplexity=10.0, n_iter=150,
                         learning_rate=100.0, seed=6)
    Y = ts.fit_transform(X)
    assert Y.shape == (75, 2)
    assert _separation(Y, y) > 2
    with pytest.raises(TypeError):
        T.BarnesHutTsne(device="cuda")


def test_barnes_hut_matches_the_reference_and_reports_decreasing_kl():
    rng = np.random.RandomState(5)
    X = np.concatenate([rng.randn(20, 5) + 3.0, rng.randn(20, 5) - 3.0])
    kw = dict(theta=0.5, perplexity=8.0, n_iter=120, learning_rate=80.0,
              seed=1, error_every=40, stop_lying_iteration=30)
    a, b = J.BarnesHutTsne(**kw), T.BarnesHutTsne(**kw)
    ya, yb = a.fit_transform(X), b.fit_transform(X)
    np.testing.assert_allclose(yb, ya, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(b.error_history_, a.error_history_,
                               rtol=1e-10)
    assert len(b.error_history_) == 3
    assert b.error_history_[-1] < b.error_history_[0]
    assert np.isfinite(b.kl_divergence_)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for make in (lambda: T.KMeansClustering(3), lambda: T.Tsne()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    T.BarnesHutTsne()  # host numpy: no card asked for


# ----------------------------------------------------------- berkeley utils

def test_counter():
    from deeplearning4j_tpu_torch.util.berkeley import Counter

    c = Counter()
    for w in ["a", "b", "a", "c", "a", "b"]:
        c.increment_count(w)
    assert c.get_count("a") == 3 and c.get_count("missing") == 0
    assert c.arg_max() == "a" and c.max_count() == 3
    assert c.sorted_keys()[0] == "a"
    assert c.total_count() == 6
    c.normalize()
    assert math.isclose(c.total_count(), 1.0)


def test_counter_map():
    from deeplearning4j_tpu_torch.util.berkeley import CounterMap

    cm = CounterMap()
    cm.increment_count("the", "cat")
    cm.increment_count("the", "cat")
    cm.increment_count("the", "dog")
    cm.increment_count("a", "dog", 0.5)
    assert cm.get_count("the", "cat") == 2
    assert cm.get_count("nope", "cat") == 0
    assert cm.get_counter("the").arg_max() == "cat"
    assert cm.total_count() == 3.5
    assert cm.total_size() == 3 and len(cm) == 2 and "the" in cm


def test_priority_queue():
    from deeplearning4j_tpu_torch.util.berkeley import PriorityQueue

    q = PriorityQueue()
    q.put("low", 1.0)
    q.put("high", 9.0)
    q.put("mid", 5.0)
    assert q.peek() == "high" and q.get_priority() == 9.0
    assert list(q) == ["high", "mid", "low"]
    assert q.is_empty()
    with pytest.raises(IndexError):
        q.peek()


def test_sloppy_math():
    from deeplearning4j_tpu_torch.util.berkeley import SloppyMath

    a, b = math.log(0.3), math.log(0.2)
    assert math.isclose(SloppyMath.log_add(a, b), math.log(0.5))
    assert math.isclose(SloppyMath.log_subtract(a, b), math.log(0.1))
    assert SloppyMath.log_add(-math.inf, a) == a
    assert math.isclose(SloppyMath.sigmoid(0.0), 0.5)
    assert SloppyMath.sigmoid(-800.0) == pytest.approx(0.0)
    with pytest.raises(ValueError):
        SloppyMath.log_subtract(b, a)


def test_berkeley_matches_the_reference():
    from deeplearning4j_tpu.util import berkeley as jb
    from deeplearning4j_tpu_torch.util import berkeley as tb

    rng = np.random.default_rng(11)
    words = [f"w{int(i)}" for i in rng.integers(0, 12, 200)]
    out = []
    for m in (jb, tb):
        c, q = m.Counter(), m.PriorityQueue()
        for i, w in enumerate(words):
            c.increment_count(w, 1.0 + (i % 3))
            q.put(w, float(i % 7))
        out.append((c.sorted_keys(), c.total_count(), list(q),
                    [m.SloppyMath.log_add(x, -x) for x in (0.1, 2.0, 40.0)]))
    assert out[0] == out[1]
