"""The port's ComputationGraph held against the JAX package's on the CPU.

The same graph is built in both packages (the JSON must be equal both
ways) and the port's network takes the JAX network's weights
(`params_from_jax`); inputs are made with numpy from a seed. Every
vertex's forward within 1e-6 of the JAX package's (rtol = atol; the
average, L2 and normalize vertices too), on FF, sequence and NHWC
inputs. Training in f32: per-step losses within 1e-5 relative, the
parameters after 3 steps within 1e-5 (rtol = atol; SGD, Nesterovs,
Adam, RMSPROP at lr 0.1 or less), for a residual + merge DAG, a
multi-input multi-output graph, truncated BPTT (plain, masked, with a
static side input riding every window, on token ids) and `rnn_time_step`
(1e-5). A linear-chain graph equals the list container built from the
same layers (the list container's tests pin it to the JAX package): the
same flat parameters, the same tBPTT steps (1e-6), `rnn_time_step`
(1e-6) and layerwise `pretrain` (1e-6).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
    MultiDataSet as JMultiDataSet,
)
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.conf import (  # noqa: E402
    computation_graph_configuration as JV,
)
from deeplearning4j_tpu.nn.graph import (  # noqa: E402
    ComputationGraph as JGraph,
)
from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: E402
    DataSet,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    computation_graph_configuration as PV,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.util import serialization as pser  # noqa: E402

TOL = 1e-5


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


def _pair(build):
    """(JAX graph, port graph on the CPU) of `build(C, V)`, the port's
    holding the JAX network's parameters and layer state."""
    jconf, pconf = build(JC, JV), build(PC, PV)
    assert pconf.to_json() == jconf.to_json()
    jnet = JGraph(jconf)
    jnet.init()
    pnet = ComputationGraph(pconf, device="cpu")
    pnet.set_param_tree(pser.params_from_jax(pconf, jnet._params))
    pnet.set_layer_state(pser.params_from_jax(pconf, jnet._layer_state))
    return jnet, pnet


def _assert_params(jnet, pnet, tol=TOL):
    for name, jp in jnet._params.items():
        for k in jp:
            np.testing.assert_allclose(pnet._params[name][k].numpy(),
                                       np.asarray(jp[k]), rtol=tol, atol=tol,
                                       err_msg=f"node {name} {k}")
    np.testing.assert_allclose(pnet.params().numpy(), np.asarray(jnet.params()),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------- vertices
def _vertex_cases():
    rng = np.random.default_rng(0)
    ff = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(3)]
    seq = [rng.normal(size=(2, 4, 3)).astype(np.float32) for _ in range(2)]
    img = [rng.normal(size=(2, 3, 3, 4)).astype(np.float32)
           for _ in range(2)]
    cases = [("merge ff", lambda V: V.MergeVertex(), ff[:2], {}),
             ("merge nhwc", lambda V: V.MergeVertex(), img, {}),
             ("stack", lambda V: V.StackVertex(), ff[:2], {}),
             ("unstack", lambda V: V.UnstackVertex(index=1, num_stacks=3),
              [np.concatenate(ff)], {}),
             ("subset", lambda V: V.SubsetVertex(from_idx=1, to_idx=3),
              seq[:1], {}),
             ("l2 normalize", lambda V: V.L2NormalizeVertex(), ff[:1], {}),
             ("l2", lambda V: V.L2Vertex(), ff[:2], {}),
             ("scale", lambda V: V.ScaleVertex(scale=-2.5), img[:1], {}),
             ("shift", lambda V: V.ShiftVertex(shift=0.75), seq[:1], {}),
             ("last time step", lambda V: V.LastTimeStepVertex(), seq[:1],
              {}),
             ("last time step masked", lambda V: V.LastTimeStepVertex(),
              seq[:1], {"mask": np.array([[1, 1, 0, 0], [1, 1, 1, 1]],
                                         np.float32)}),
             ("duplicate to time series",
              lambda V: V.DuplicateToTimeSeriesVertex("seq"), ff[:1],
              {"length": 4}),
             ("preprocessor", lambda V: V.PreprocessorVertex(
                 (JC if V is JV else PC).preprocessors
                 .CnnToFeedForwardPreProcessor(3, 3, 4)), img[:1], {})]
    for op in ("add", "subtract", "product", "average", "max"):
        cases.append((f"elementwise {op}",
                      lambda V, op=op: V.ElementWiseVertex(op=op),
                      ff[:2] if op == "subtract" else ff, {}))
    return cases


@pytest.mark.parametrize("name,make,inputs,kw", _vertex_cases(),
                         ids=[c[0] for c in _vertex_cases()])
def test_vertex_forward_matches_the_jax_package(name, make, inputs, kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    pkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = np.asarray(make(JV).forward([jnp.asarray(x) for x in inputs],
                                       **jkw))
    got = make(PV).forward([torch.from_numpy(x) for x in inputs], **pkw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert make(PV).to_json() == make(JV).to_json()


# ------------------------------------------------------ configuration
def _json_graph(C, V):
    return (C.NeuralNetConfiguration.Builder()
            .seed(5).learning_rate(0.1)
            .graph_builder()
            .add_inputs("in")
            .add_layer("d1", C.DenseLayer(n_out=6, activation="relu"), "in")
            .add_vertex("sub", V.SubsetVertex(from_idx=0, to_idx=2), "d1")
            .add_vertex("norm", V.L2NormalizeVertex(), "sub")
            .add_vertex("pre", V.PreprocessorVertex(
                C.preprocessors.FeedForwardToCnnPreProcessor(1, 1, 3)),
                "norm")
            .add_layer("conv", C.ConvolutionLayer(n_out=2, kernel=(1, 1)),
                       "pre")
            .add_layer("out", C.OutputLayer(n_out=2, activation="softmax"),
                       "conv")
            .set_outputs("out")
            .set_input_types(C.InputType.feed_forward(4))
            .build())


def test_graph_json_round_trips_both_ways():
    text = _json_graph(JC, JV).to_json()
    port = _json_graph(PC, PV)
    assert port.to_json() == text
    back = PV.ComputationGraphConfiguration.from_json(text)
    assert back.to_json() == text
    assert back.topological_order == port.topological_order
    assert back.nodes["out"].layer.n_in == 2
    assert isinstance(back.nodes["out"].preprocessor,
                      PC.preprocessors.CnnToFeedForwardPreProcessor)
    assert {k: str(v) for k, v in back.resolved_types.items()} == \
        {k: str(v) for k, v in _json_graph(JC, JV).resolved_types.items()}
    assert JV.ComputationGraphConfiguration.from_json(
        port.to_json()).to_json() == text
    g = ComputationGraph(back, device="cpu")
    assert g.output(np.zeros((2, 4), np.float32))[0].shape == (2, 2)


def test_graph_cycle_and_unknown_inputs_are_refused():
    b = (PC.NeuralNetConfiguration.Builder().graph_builder()
         .add_inputs("in")
         .add_layer("a", PC.DenseLayer(n_in=4, n_out=4), "b")
         .add_layer("b", PC.DenseLayer(n_in=4, n_out=4), "a")
         .add_layer("out", PC.OutputLayer(n_in=4, n_out=2), "b")
         .set_outputs("out"))
    with pytest.raises(ValueError, match="cycle"):
        b.build()
    with pytest.raises(ValueError, match="unknown input"):
        (PC.NeuralNetConfiguration.Builder().graph_builder().add_inputs("in")
         .add_layer("out", PC.OutputLayer(n_in=4, n_out=2), "nope")
         .set_outputs("out").build())
    with pytest.raises(ValueError, match="duplicate"):
        (PC.NeuralNetConfiguration.Builder().graph_builder().add_inputs("in")
         .add_layer("in", PC.DenseLayer(n_in=4, n_out=2), "in"))


# ----------------------------------------------------------- training
def _blobs(n=32, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    return X, np.eye(2, dtype=np.float32)[y]


def _residual(C, V):
    return (C.NeuralNetConfiguration.Builder()
            .seed(2).learning_rate(0.1).updater("nesterovs").momentum(0.9)
            .l2(1e-3).activation("relu")
            .graph_builder()
            .add_inputs("in")
            .add_layer("d1", C.DenseLayer(n_out=4), "in")
            .add_layer("d2", C.DenseLayer(n_out=4), "d1")
            .add_vertex("residual", V.ElementWiseVertex(op="add"), "d1", "d2")
            .add_vertex("merged", V.MergeVertex(), "residual", "d1")
            .add_layer("bn", C.BatchNormalization(), "merged")
            .add_layer("out", C.OutputLayer(n_out=2, loss="mcxent",
                                            activation="softmax"), "bn")
            .set_outputs("out")
            .set_input_types(C.InputType.feed_forward(4))
            .build())


def test_residual_graph_trains_as_the_jax_package():
    jnet, pnet = _pair(_residual)
    assert pnet.conf.nodes["out"].layer.n_in == 8
    X, y = _blobs()
    for step in range(3):
        jnet.fit(JDataSet(X, y))
        pnet.fit(DataSet(X, y))
        assert pnet.score_value == pytest.approx(jnet.score_value, rel=TOL)
    _assert_params(jnet, pnet)
    for k in ("mean", "var"):
        np.testing.assert_allclose(pnet._layer_state["bn"][k].numpy(),
                                   np.asarray(jnet._layer_state["bn"][k]),
                                   rtol=TOL, atol=TOL)
    assert pnet.score(DataSet(X, y)) == pytest.approx(
        jnet.score(JDataSet(X, y)), rel=TOL)
    np.testing.assert_allclose(pnet.output(X)[0].numpy(), jnet.output(X)[0],
                               rtol=TOL, atol=1e-6)
    assert pnet.evaluate(DataSet(X, y)).accuracy() == \
        jnet.evaluate(JDataSet(X, y)).accuracy()
    assert pnet.iteration == jnet.iteration == 3


def _multi_io(C, V):
    return (C.NeuralNetConfiguration.Builder()
            .seed(4).learning_rate(0.05).updater("adam")
            .activation("tanh")
            .graph_builder()
            .add_inputs("a", "b")
            .add_vertex("ab", V.MergeVertex(), "a", "b")
            .add_layer("h", C.DenseLayer(n_out=12), "ab")
            .add_layer("out1", C.OutputLayer(n_out=2, activation="softmax"),
                       "h")
            .add_layer("out2", C.OutputLayer(n_out=3, activation="softmax"),
                       "h")
            .set_outputs("out1", "out2")
            .set_input_types(C.InputType.feed_forward(3),
                             C.InputType.feed_forward(5))
            .build())


def test_multi_input_multi_output_graph_matches_the_jax_package():
    jnet, pnet = _pair(_multi_io)
    rng = np.random.default_rng(3)
    Xa = rng.normal(size=(16, 3)).astype(np.float32)
    Xb = rng.normal(size=(16, 5)).astype(np.float32)
    y1 = np.eye(2, dtype=np.float32)[(Xa[:, 0] > 0).astype(int)]
    y2 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    batches = [([Xa, Xb], [y1, y2])] * 3
    jnet.fit(JListIterator([JMultiDataSet(f, l) for f, l in batches]))
    pnet.fit(ListDataSetIterator([MultiDataSet(f, l) for f, l in batches]),
             scan_steps=2)
    assert pnet.score_value == pytest.approx(jnet.score_value, rel=TOL)
    _assert_params(jnet, pnet)
    outs, jouts = pnet.output(Xa, Xb), jnet.output(Xa, Xb)
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.numpy(), jo, rtol=TOL, atol=1e-6)
    with pytest.raises(ValueError, match="label arrays"):
        pnet.fit(MultiDataSet([Xa, Xb], [y1]))


def _ids_through_vertex(C, V):
    return (C.NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .graph_builder()
            .add_inputs("ids")
            .add_vertex("sub", V.SubsetVertex(0, 0), "ids")
            .add_layer("emb", C.EmbeddingLayer(n_in=1000, n_out=8), "sub")
            .add_layer("out", C.OutputLayer(n_in=8, n_out=2,
                                            activation="softmax"), "emb")
            .set_outputs("out")
            .set_input_types(C.InputType.feed_forward(1))
            .build())


def test_bf16_leaves_ids_reaching_an_embedding_through_a_vertex_alone():
    pnet = ComputationGraph(_ids_through_vertex(PC, PV),
                            compute_dtype=torch.bfloat16, device="cpu")
    pnet.init()
    assert pnet._int_sinks >= {"ids"}
    ids = np.array([[513.0], [515.0], [777.0], [999.0]], np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]
    before = pnet._params["emb"]["W"].clone()
    pnet.fit(DataSet(ids, y))
    after = pnet._params["emb"]["W"]
    for tok in (513, 515, 777, 999):
        assert not torch.allclose(after[tok], before[tok]), tok
    changed = (after != before).any(dim=1).nonzero().flatten().tolist()
    assert changed == [513, 515, 777, 999]
    assert all(p.dtype == torch.float32 for d in pnet._params.values()
               for p in d.values())


# ----------------------------------------------------------- RNN tier
def _lstm_chain(C, V, tbptt=0, seed=5):
    b = (C.NeuralNetConfiguration.Builder()
         .seed(seed).learning_rate(0.1)
         .graph_builder()
         .add_inputs("in")
         .add_layer("lstm", C.GravesLSTM(n_in=4, n_out=6, activation="tanh"),
                    "in")
         .add_layer("out", C.RnnOutputLayer(n_in=6, n_out=3,
                                            activation="softmax",
                                            loss="mcxent"), "lstm")
         .set_outputs("out"))
    if tbptt:
        b = b.t_bptt_forward_length(tbptt).t_bptt_backward_length(tbptt)
    return b.build()


def _lstm_list(tbptt=0, seed=5):
    b = (PC.NeuralNetConfiguration.Builder()
         .seed(seed).learning_rate(0.1)
         .list()
         .layer(PC.GravesLSTM(n_in=4, n_out=6, activation="tanh"))
         .layer(PC.RnnOutputLayer(n_in=6, n_out=3, activation="softmax",
                                  loss="mcxent"))
         .set_input_type(PC.InputType.recurrent(4)))
    if tbptt:
        b = b.t_bptt_forward_length(tbptt).t_bptt_backward_length(tbptt)
    return b.build()


def _chain_and_list(graph_conf, list_conf):
    """A linear-chain graph and the list container of the same layers,
    holding the same parameters."""
    g = ComputationGraph(graph_conf, device="cpu")
    g.init()
    net = MultiLayerNetwork(list_conf, device="cpu")
    net.set_param_tree([g._params[n] for n, _ in g._layer_slots()])
    return g, net


def _chain_params_equal(g, net, tol):
    for (n, _), p in zip(g._layer_slots(), net._params):
        for k in p:
            np.testing.assert_allclose(g._params[n][k].numpy(),
                                       p[k].numpy(), rtol=tol, atol=tol,
                                       err_msg=f"{n} {k}")


def test_tbptt_matches_the_jax_package_and_the_list_container():
    jnet, pnet = _pair(lambda C, V: _lstm_chain(C, V, tbptt=4))
    g, net = _chain_and_list(_lstm_chain(PC, PV, tbptt=4), _lstm_list(4))
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 4).astype(np.float32)   # T=10: 3 windows, padded
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 10))]
    for _ in range(3):
        jnet.fit(JMultiDataSet([x], [y]))
        pnet.fit(MultiDataSet([x], [y]))
        g.fit(MultiDataSet([x], [y]))
        net.fit(DataSet(x, y))
        assert pnet.score_value == pytest.approx(jnet.score_value, rel=TOL)
        assert g.score_value == pytest.approx(net.score_value, rel=1e-6)
    _assert_params(jnet, pnet)
    _chain_params_equal(g, net, 1e-6)
    assert pnet.iteration == jnet.iteration == 9
    assert pnet._layer_state["lstm"] == {}


def test_masked_tbptt_matches_the_jax_package():
    jnet, pnet = _pair(lambda C, V: _lstm_chain(C, V, tbptt=5, seed=11))
    rng = np.random.RandomState(4)
    x = rng.randn(4, 12, 4).astype(np.float32)
    y = (x[..., 0] > 0).astype(np.int32) + (x[..., 1] > 0).astype(np.int32)
    mask = np.zeros((4, 12), np.float32)
    for i, n in enumerate([12, 9, 7, 12]):
        mask[i, :n] = 1.0
    for _ in range(3):
        jnet.fit(JMultiDataSet([x], [y], features_masks=[mask],
                               labels_masks=[mask]))
        pnet.fit(MultiDataSet([x], [y], features_masks=[mask],
                              labels_masks=[mask]))
        assert pnet.score_value == pytest.approx(jnet.score_value, rel=TOL)
    _assert_params(jnet, pnet)


def test_rnn_time_step_matches_the_jax_package_and_the_list_container():
    jnet, pnet = _pair(lambda C, V: _lstm_chain(C, V))
    g, net = _chain_and_list(_lstm_chain(PC, PV), _lstm_list())
    rng = np.random.RandomState(5)
    x = rng.randn(3, 8, 4).astype(np.float32)
    full = pnet.output(x)[0].numpy()
    np.testing.assert_allclose(full, jnet.output(x)[0], rtol=TOL, atol=1e-6)
    a = pnet.rnn_time_step(x[:, :5])[0]
    b = pnet.rnn_time_step(x[:, 5:])[0]
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), full,
                               rtol=TOL, atol=1e-6)
    ja = jnet.rnn_time_step(x[:, :5])[0]
    np.testing.assert_allclose(a.numpy(), ja, rtol=TOL, atol=1e-6)
    pnet.rnn_clear_previous_state()
    pnet.rnn_time_step(x[:, :5])
    st = pnet.rnn_get_previous_state()
    assert st["__pos__"] == 5
    c1 = pnet.rnn_time_step(x[:, 5:6])[0]
    pnet.rnn_set_previous_state(st)
    c2 = pnet.rnn_time_step(x[:, 5:6])[0]
    assert torch.equal(c1, c2)
    pnet.rnn_clear_previous_state()
    s = pnet.rnn_time_step(x[:, 0])[0]
    assert s.shape == (3, 3)
    np.testing.assert_allclose(s.numpy(), full[:, 0], rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(g.rnn_time_step(x)[0].numpy(),
                               net.rnn_time_step(x).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_rnn_time_step_rejects_a_bidirectional_node():
    conf = (PC.NeuralNetConfiguration.Builder().seed(1)
            .graph_builder().add_inputs("in")
            .add_layer("bi", PC.GravesBidirectionalLSTM(n_in=4, n_out=6),
                       "in")
            .add_layer("out", PC.RnnOutputLayer(n_in=6, n_out=3,
                                                activation="softmax"), "bi")
            .set_outputs("out").build())
    g = ComputationGraph(conf, device="cpu")
    with pytest.raises(ValueError, match="bidirectional"):
        g.rnn_time_step(np.zeros((2, 4), np.float32))


def _token_lstm(C, V, tbptt=0):
    b = (C.NeuralNetConfiguration.Builder().seed(17).learning_rate(0.1)
         .graph_builder().add_inputs("ids")
         .add_layer("emb", C.layers.TokenEmbedding(n_in=12, n_out=6, max_length=32),
                    "ids")
         .add_layer("lstm", C.GravesLSTM(n_in=6, n_out=8, activation="tanh"),
                    "emb")
         .add_layer("out", C.RnnOutputLayer(n_in=8, n_out=12,
                                            activation="softmax",
                                            loss="mcxent"), "lstm")
         .set_outputs("out"))
    if tbptt:
        b = b.t_bptt_forward_length(tbptt).t_bptt_backward_length(tbptt)
    return b.build()


def test_token_id_sequences_window_and_stream_as_the_jax_package():
    jnet, pnet = _pair(lambda C, V: _token_lstm(C, V, tbptt=4))
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 12, (2, 10)).astype(np.int32)
    labels = rng.randint(0, 12, (2, 10)).astype(np.int32)
    assert pnet._tbptt_applicable(MultiDataSet([ids], [labels]))
    jnet.fit(JMultiDataSet([ids], [labels]))
    pnet.fit(MultiDataSet([ids], [labels]))
    assert pnet.iteration == 3
    assert pnet.score_value == pytest.approx(jnet.score_value, rel=TOL)
    _assert_params(jnet, pnet)
    full = pnet.output(ids)[0]
    s1 = pnet.rnn_time_step(ids[:, :4])[0]
    st = pnet.rnn_get_previous_state()
    s2 = pnet.rnn_time_step(ids[:, 4:])[0]
    np.testing.assert_allclose(torch.cat([s1, s2], 1).numpy(), full.numpy(),
                               rtol=TOL, atol=1e-6)
    pnet.rnn_set_previous_state(st)
    assert torch.equal(pnet.rnn_time_step(ids[:, 4:])[0], s2)


def _side_input(C, V):
    return (C.NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .graph_builder()
            .add_inputs("seq", "cond")
            .add_layer("emb", C.EmbeddingLayer(n_in=5, n_out=4), "cond")
            .add_vertex("dup", V.DuplicateToTimeSeriesVertex("seq"), "emb")
            .add_vertex("m", V.MergeVertex(), "seq", "dup")
            .add_layer("lstm", C.GravesLSTM(n_in=7, n_out=6,
                                            activation="tanh"), "m")
            .add_vertex("last", V.LastTimeStepVertex("seq"), "lstm")
            .add_layer("out", C.OutputLayer(n_in=6, n_out=3,
                                            activation="softmax"), "last")
            .add_layer("rout", C.RnnOutputLayer(n_in=6, n_out=3,
                                                activation="softmax"), "lstm")
            .set_outputs("rout", "out")
            .build())


def test_static_side_input_and_last_step_match_the_jax_package():
    jnet, pnet = _pair(_side_input)
    rng = np.random.RandomState(1)
    seq = rng.randn(3, 10, 3).astype(np.float32)
    cond = rng.randint(0, 5, (3,)).astype(np.int32)
    y = rng.randint(0, 3, (3, 10)).astype(np.int32)
    y2 = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 3)]
    mask = np.ones((3, 10), np.float32)
    mask[0, 6:] = 0
    for _ in range(2):
        jnet.fit(JMultiDataSet([seq, cond], [y, y2],
                               features_masks=[mask, None]))
        pnet.fit(MultiDataSet([seq, cond], [y, y2],
                              features_masks=[mask, None]))
        assert pnet.score_value == pytest.approx(jnet.score_value, rel=TOL)
    _assert_params(jnet, pnet)
    for o, jo in zip(pnet.output(seq, cond), jnet.output(seq, cond)):
        np.testing.assert_allclose(o.numpy(), jo, rtol=TOL, atol=1e-6)


# ----------------------------------------------------------- pretrain
def test_pretrain_on_a_chain_equals_the_list_container():
    gconf = (PC.NeuralNetConfiguration.Builder()
             .seed(21).learning_rate(0.05).graph_builder().add_inputs("in")
             .add_layer("d0", PC.DenseLayer(n_in=6, n_out=6), "in")
             .add_layer("ae", PC.AutoEncoder(n_in=6, n_out=4,
                                             corruption_level=0.3,
                                             activation="sigmoid"), "d0")
             .add_layer("rbm", PC.RBM(n_in=4, n_out=3), "ae")
             .add_layer("out", PC.OutputLayer(n_in=3, n_out=2,
                                              activation="softmax"), "rbm")
             .set_outputs("out").build())
    mconf = (PC.NeuralNetConfiguration.Builder()
             .seed(21).learning_rate(0.05).list()
             .layer(PC.DenseLayer(n_in=6, n_out=6))
             .layer(PC.AutoEncoder(n_in=6, n_out=4, corruption_level=0.3,
                                   activation="sigmoid"))
             .layer(PC.RBM(n_in=4, n_out=3))
             .layer(PC.OutputLayer(n_in=3, n_out=2, activation="softmax"))
             .build())
    g, net = _chain_and_list(gconf, mconf)
    rng = np.random.RandomState(0)
    batches = [DataSet(rng.rand(16, 6).astype(np.float32), None)
               for _ in range(4)]
    before = g._params["d0"]["W"].clone()
    g.pretrain(ListDataSetIterator(list(batches)), epochs=2)
    net.pretrain(ListDataSetIterator(list(batches)), epochs=2)
    _chain_params_equal(g, net, 1e-6)
    assert g.score_value == pytest.approx(net.score_value, rel=1e-6)
    assert torch.equal(g._params["d0"]["W"], before)   # frozen
    assert torch.equal(net._params[0]["W"], before)


# ------------------------------------------------------------ surface
def test_summary_and_clone_match_the_jax_package():
    jnet, pnet = _pair(_residual)
    assert pnet.summary() == jnet.summary()
    assert "ElementWiseVertex" in pnet.summary()
    X, y = _blobs()
    pnet.fit(DataSet(X, y))
    twin = pnet.clone()
    assert torch.equal(twin.params(), pnet.params())
    twin.fit(DataSet(X, y))
    assert not torch.equal(twin.params(), pnet.params())
    assert twin.iteration == 2 and pnet.iteration == 1
    assert pnet.num_params() == int(np.asarray(jnet.params()).size)


def test_compute_gradient_and_score_matches_the_jax_package():
    jnet, pnet = _pair(_multi_io)
    rng = np.random.default_rng(9)
    Xa = rng.normal(size=(8, 3)).astype(np.float32)
    Xb = rng.normal(size=(8, 5)).astype(np.float32)
    y1 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    y2 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    jg, js = jnet.compute_gradient_and_score(JMultiDataSet([Xa, Xb], [y1, y2]))
    pg, ps = pnet.compute_gradient_and_score(MultiDataSet([Xa, Xb], [y1, y2]))
    assert ps == pytest.approx(js, rel=1e-6)
    np.testing.assert_allclose(pg, jg, rtol=1e-5, atol=1e-6)
    f = pnet.score_function(MultiDataSet([Xa, Xb], [y1, y2]))
    assert float(f(pnet.params())) == pytest.approx(ps, rel=1e-6)
