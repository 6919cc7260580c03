"""The graph-embedding package of the port (`deeplearning4j_tpu_torch.graph`)
against the JAX package's, on the CPU at small sizes: the graphs and the
walks (uniform and weighted, from the same numpy seeds) are identical; a
DeepWalk fit with hierarchical softmax and no negatives (every draw on the
host) gives syn0 and syn1 to 1e-5; the negative-sampling DeepWalk, which
draws its negatives from a `torch.Generator`, separates two cliques by the
reference's criterion and is deterministic per seed; serializer files are
byte-identical and each package reads the other's."""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph as J
import deeplearning4j_tpu_torch.graph as T
from deeplearning4j_tpu.graph.walks import NoEdges as JNoEdges
from deeplearning4j_tpu_torch.graph.walks import NoEdges

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


def _two_cliques(M, k=6):
    """Two k-cliques joined by a single bridge edge."""
    edges = []
    for a in range(k):
        for b in range(a + 1, k):
            edges.append((a, b))
            edges.append((k + a, k + b))
    edges.append((0, k))  # bridge
    return M.Graph.from_edge_list(edges, n_vertices=2 * k)


def _planted(M, n=60, groups=3, edges=400, p_in=0.8, seed=0, weighted=False):
    """A planted partition with weighted edges drawn from one numpy seed."""
    rng = np.random.default_rng(seed)
    g = M.Graph(n)
    label = np.arange(n) % groups
    for _ in range(edges):
        a = int(rng.integers(0, n))
        pool = np.flatnonzero(label == label[a]) if rng.random() < p_in \
            else np.flatnonzero(label != label[a])
        b = int(rng.choice(pool))
        g.add_edge(a, b, weight=float(rng.uniform(0.1, 5.0)) if weighted
                   else 1.0)
    return g


def _hs_deepwalk(M, graph, **extra):
    dw = M.DeepWalk(vector_size=16, window_size=3, walk_length=12,
                    walks_per_vertex=3, negative=0,
                    use_hierarchic_softmax=True, learning_rate=0.05,
                    batch_size=128, seed=3, **extra)
    dw.fit(graph)
    return dw


def test_graph_basics():
    for M in (J, T):
        g = M.Graph.from_edge_list([(0, 1), (1, 2)], n_vertices=4)
        assert g.num_vertices() == 4
        assert set(g.get_connected_vertices(1)) == {0, 2}
        assert g.degree(3) == 0
        d = M.Graph(3, directed=True, values=["a", "b", "c"])
        d.add_edge(0, 2, weight=2.5)
        assert d.get_connected_vertices(2) == [] and d.degree(0) == 1
        assert d.get_vertex(1).value == "b"
        assert d.get_edges_out(0)[0].weight == 2.5


def test_random_walks_cover_length_and_vertices():
    g = _two_cliques(T)
    walks = list(T.RandomWalkIterator(g, walk_length=10, seed=1))
    assert len(walks) == g.num_vertices()
    assert all(len(w) == 10 for w in walks)
    for w in walks:
        for a, b in zip(w, w[1:]):
            assert b in g.get_connected_vertices(a) or a == b


@pytest.mark.parametrize("seed", [1, 2, 17])
def test_walks_identical(seed):
    ga, gb = _planted(J, seed=seed), _planted(T, seed=seed)
    assert list(T.RandomWalkIterator(gb, 15, seed=seed)) == \
        list(J.RandomWalkIterator(ga, 15, seed=seed))
    wa, wb = _planted(J, seed=seed, weighted=True), \
        _planted(T, seed=seed, weighted=True)
    assert list(T.WeightedRandomWalkIterator(wb, 15, seed=seed)) == \
        list(J.WeightedRandomWalkIterator(wa, 15, seed=seed))


def test_walks_at_a_vertex_without_edges():
    for M, NE in ((J, JNoEdges), (T, NoEdges)):
        g = M.Graph(3, directed=True)
        g.add_edge(0, 1)
        walks = list(M.RandomWalkIterator(g, 4, seed=0))
        assert [2, 2, 2, 2] in walks
        with pytest.raises(ValueError, match="no outgoing edges"):
            list(M.WeightedRandomWalkIterator(
                g, 4, seed=0, no_edge_handling=NE.EXCEPTION))


def test_weighted_walks_follow_weights():
    g = T.Graph(3, directed=True)
    g.add_edge(0, 1, weight=100.0)
    g.add_edge(0, 2, weight=0.001)
    g.add_edge(1, 0, weight=1.0)
    g.add_edge(2, 0, weight=1.0)
    walks = list(T.WeightedRandomWalkIterator(g, walk_length=30, seed=2))
    visits_1 = sum(w.count(1) for w in walks)
    visits_2 = sum(w.count(2) for w in walks)
    assert visits_1 > visits_2 * 3


@pytest.mark.parametrize("graph", ["cliques", "planted"])
def test_hs_deepwalk_fit_matches(graph):
    make = _two_cliques if graph == "cliques" else _planted
    a = _hs_deepwalk(J, make(J))
    b = _hs_deepwalk(T, make(T), **CPU)
    for name in ("syn0", "syn1"):
        np.testing.assert_allclose(
            getattr(b.lookup_table, name).numpy(),
            np.asarray(getattr(a.lookup_table, name)), rtol=1e-5, atol=1e-5)
    assert [w.word for w in b.vocab.vocab_words()] == \
        [w.word for w in a.vocab.vocab_words()]
    np.testing.assert_allclose(b.vertex_vector(3), a.vertex_vector(3),
                               rtol=1e-5, atol=1e-5)
    assert b.similarity(1, 2) == pytest.approx(a.similarity(1, 2), abs=1e-5)
    assert [v for v, _ in b.verts_nearest(2, 4)] == \
        [v for v, _ in a.verts_nearest(2, 4)]


def test_deepwalk_separates_cliques_and_is_deterministic():
    fits = []
    for _ in range(2):
        dw = T.DeepWalk(vector_size=16, window_size=3, walk_length=20,
                        walks_per_vertex=8, negative=5, batch_size=256,
                        seed=3, **CPU)
        dw.fit(_two_cliques(T))
        fits.append(dw)
    dw = fits[0]
    assert dw.similarity(1, 2) > dw.similarity(1, 7)
    nearest = [v for v, _ in dw.verts_nearest(2, 4)]
    assert sum(1 for v in nearest if v < 6) >= 3
    assert torch.equal(fits[0].lookup_table.syn0, fits[1].lookup_table.syn0)
    assert torch.equal(fits[0].lookup_table.syn1neg,
                       fits[1].lookup_table.syn1neg)


def test_graph_vector_serializer_roundtrip(tmp_path):
    g = _two_cliques(T)
    dw = T.DeepWalk(vector_size=8, window_size=2, walk_length=10,
                    walks_per_vertex=2, negative=3, batch_size=128, seed=4,
                    **CPU)
    dw.fit(g)
    p = tmp_path / "gv.txt"
    T.GraphVectorSerializer.write_graph_vectors(dw, p)
    vecs, ids = T.GraphVectorSerializer.read_graph_vectors(p)
    assert ids == list(range(12))
    np.testing.assert_allclose(vecs[3], dw.vertex_vector(3), atol=1e-5)


def test_serializer_files_byte_identical_and_cross(tmp_path):
    """The same vectors give the same bytes, and each package reads the
    other's file."""
    a = _hs_deepwalk(J, _two_cliques(J))
    b = _hs_deepwalk(T, _two_cliques(T), **CPU)
    b.lookup_table.syn0 = torch.from_numpy(
        np.array(a.lookup_table.syn0, np.float32))
    pa, pb = tmp_path / "jax.txt", tmp_path / "torch.txt"
    J.GraphVectorSerializer.write_graph_vectors(a, pa)
    T.GraphVectorSerializer.write_graph_vectors(b, pb)
    assert pa.read_bytes() == pb.read_bytes()
    for reader, path in ((T, pa), (J, pb)):
        vecs, ids = reader.GraphVectorSerializer.read_graph_vectors(path)
        assert ids == list(range(12)) and vecs.dtype == np.float32
        np.testing.assert_allclose(vecs[5], a.vertex_vector(5), atol=1e-6)


def test_deepwalk_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.DeepWalk()
