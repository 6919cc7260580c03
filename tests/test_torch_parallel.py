"""The port's data-parallel wrapper, meshes, device prefetch and
`SequenceVectors(mesh=)` (`deeplearning4j_tpu_torch.parallel`) held
against the JAX package on the CPU at small size.

The JAX wrapper computes, over its 8-device virtual mesh, exactly the
single-device step on the global batch. The port runs the network's own
step on the whole batch over an 8-slot mesh on the CPU
(`make_mesh(devices=[cpu] * 8)`). Both start from the same weights
(`params_from_jax`) and see the same batches, made with numpy from a
seed. Losses agree to 1e-6 (relative) and parameters within the
updater's tolerance: 1e-6 absolute for SGD and Nesterov, lr / 30 for
Adam and lr / 1000 for RMSProp (the caveats of ROADMAP queue C: the
adaptive updaters turn gradients that are noise into lr-sized steps).
The BatchNormalization and masked-tBPTT cases also show that a per-slot
computation would have been caught: it lands far outside the tolerance.
"""
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
    MultiDataSet as JMultiDataSet,
)
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    ListDataSetIterator as JList,
)
from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet,
)
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from deeplearning4j_tpu.parallel.wrapper import (  # noqa: E402
    ParallelWrapper as JWrapper,
)
from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: E402
    DataSet,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    AsyncDataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from deeplearning4j_tpu_torch.parallel.device_prefetch import (  # noqa: E402
    DevicePrefetchIterator,
)
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: E402
    ParallelWrapper,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)

CPU8 = [torch.device("cpu")] * 8
LOSS_RTOL = 1e-6
SGD_ATOL = 1e-6


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


@pytest.fixture(autouse=True)
def _bounded_wall():
    """Every test here bounds its own wall time."""
    t0 = time.monotonic()
    yield
    assert time.monotonic() - t0 < 60.0


def _mesh8():
    return pmesh.make_mesh({"data": 8}, devices=CPU8)


def _dense_conf(C, updater="nesterovs", bn=False):
    b = (C.NeuralNetConfiguration.Builder().seed(99).learning_rate(0.1)
         .updater(updater).activation("tanh").list()
         .layer(C.DenseLayer(n_out=16)))
    if bn:
        b = b.layer(C.BatchNormalization())
    return (b.layer(C.OutputLayer(n_out=3, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(C.InputType.feed_forward(4)).build())


def _pair(make_conf, graph=False):
    """(JAX network, port network on the CPU) with the same weights and
    layer state."""
    jconf, pconf = make_conf(JC), make_conf(PC)
    if graph:
        jnet, pnet = JGraph(jconf), ComputationGraph(pconf, device="cpu")
    else:
        jnet, pnet = JNet(jconf), MultiLayerNetwork(pconf, device="cpu")
    jnet.init()
    pnet.set_param_tree(params_from_jax(pconf, jnet._params))
    pnet.set_layer_state(params_from_jax(pconf, jnet._layer_state))
    return jnet, pnet


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return X, labels


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(pnet, jnet, atol):
    np.testing.assert_allclose(_np(pnet.params()), np.asarray(jnet.params()),
                               rtol=0, atol=atol)
    assert pnet.score_value == pytest.approx(float(jnet.score_value),
                                             rel=LOSS_RTOL)


# ------------------------------------------------------------------ meshes
def test_eight_slots_on_one_device():
    m = _mesh8()
    assert dict(m.shape) == {"data": 8} and m.size == 8
    assert m.distinct_devices() == [torch.device("cpu")]
    assert m.devices.shape == (8,)
    assert m.data_placement("data").device == torch.device("cpu")


def test_make_mesh_contract_matches_jax():
    """Sizes multiply to the device count, one -1 axis takes the rest,
    and the same ValueErrors (the JAX package's messages)."""
    import jax

    for axes in ({"data": 4, "model": -1}, {"a": 2, "b": 2, "c": 2},
                 {"data": -1}, None):
        m = pmesh.make_mesh(axes, devices=CPU8)
        jm = jmake_mesh(axes, devices=jax.devices())
        assert dict(m.shape) == dict(jm.shape)
        assert m.axis_names == jm.axis_names
    for axes in ({"a": -1, "b": -1}, {"data": 3}):
        with pytest.raises(ValueError) as pe:
            pmesh.make_mesh(axes, devices=CPU8)
        with pytest.raises(ValueError) as je:
            jmake_mesh(axes, devices=jax.devices())
        assert str(pe.value) == str(je.value)


def test_default_mesh_covers_the_card():
    if torch.cuda.is_available():
        m = pmesh.make_mesh()
        assert m.size == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in m.distinct_devices())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParallelWrapper(MultiLayerNetwork(_dense_conf(PC), device="cpu"))


# ---------------------------------------------------------- the wrapper
def test_data_parallel_matches_jax_wrapper():
    """5 epochs of Nesterov over the 8-slot mesh against the JAX wrapper
    over its 8 devices, from the same weights."""
    X, y = _data()
    jnet, pnet = _pair(_dense_conf)
    JWrapper(jnet, mesh=jmake_mesh({"data": 8})).fit(
        JList([JDataSet(X, y)]), epochs=5)
    ParallelWrapper(pnet, mesh=_mesh8()).fit(
        ListDataSetIterator([DataSet(X, y)]), epochs=5)
    _close(pnet, jnet, SGD_ATOL)
    assert pnet.iteration == jnet.iteration == 5
    assert pnet.epoch == jnet.epoch == 5


def test_trim_and_drop_match_jax(caplog):
    """A batch of 61 trims to 56 and a batch of 5 (< 8 slots) is dropped,
    with the JAX wrapper's log lines; the results follow the trim."""
    import logging

    X, y = _data(n=66, seed=3)
    batches = [(X[:61], y[:61]), (X[61:], y[61:])]
    jnet, pnet = _pair(_dense_conf)
    JWrapper(jnet, mesh=jmake_mesh({"data": 8})).fit(
        JList([JDataSet(a, b) for a, b in batches]), epochs=2)
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        ParallelWrapper(pnet, mesh=_mesh8()).fit(
            ListDataSetIterator([DataSet(a, b) for a, b in batches]),
            epochs=2)
    _close(pnet, jnet, SGD_ATOL)
    assert pnet.iteration == jnet.iteration == 2
    msgs = [r.getMessage() for r in caplog.records]
    assert "trimming batch 61 -> 56 (divisibility by 8)" in msgs
    assert "dropping batch of 5 < 8 devices" in msgs
    # and the trim matters: the untrimmed batch gives another result
    _, full = _pair(_dense_conf)
    full.fit(DataSet(X[:61], y[:61]), epochs=2)
    assert np.abs(_np(full.params()) - _np(pnet.params())).max() > 1e-4


def _per_slot_one_step(pnet_factory, X, y, slots=8, fm=None, lm=None):
    """What a per-slot wrapper would compute for one SGD step: each slot
    fits its shard of the batch on its own copy, the copies' parameters
    averaged (equal to averaging the slots' gradients for one SGD
    step)."""
    n = X.shape[0] // slots
    flats = []
    for s in range(slots):
        net = pnet_factory()
        sl = slice(s * n, (s + 1) * n)
        net.fit(DataSet(X[sl], y[sl], None if fm is None else fm[sl],
                        None if lm is None else lm[sl]))
        flats.append(_np(net.params()))
    return np.mean(flats, axis=0)


def test_batchnorm_uses_whole_batch_statistics():
    """A BatchNormalization net: the port over 8 slots equals the JAX
    wrapper over 8 devices (one global-batch step: batch statistics of
    all 64 rows, running stats moved by them); a per-slot computation
    (statistics of 8 rows each) lands far outside the tolerance."""
    X, y = _data(n=64, seed=5)
    X[:32] += 3.0  # shards see different statistics
    conf = lambda C: _dense_conf(C, updater="sgd", bn=True)  # noqa: E731
    jnet, pnet = _pair(conf)
    start = pnet.clone()
    JWrapper(jnet, mesh=jmake_mesh({"data": 8})).fit(
        JList([JDataSet(X, y)]), epochs=1)
    ParallelWrapper(pnet, mesh=_mesh8()).fit(DataSet(X, y))
    _close(pnet, jnet, SGD_ATOL)
    jstate = np.asarray(jnet._layer_state[1]["var"])
    np.testing.assert_allclose(_np(pnet._layer_state[1]["var"]), jstate,
                               rtol=1e-6, atol=1e-7)
    per_slot = _per_slot_one_step(start.clone, X, y)
    assert np.abs(per_slot - _np(pnet.params())).max() > 1e3 * SGD_ATOL


def _tbptt_conf(C, lr=0.1):
    return (C.NeuralNetConfiguration.Builder().seed(31).learning_rate(lr)
            .list()
            .layer(C.GravesLSTM(n_out=8, activation="tanh"))
            .layer(C.RnnOutputLayer(n_out=4, loss="mcxent",
                                    activation="softmax"))
            .set_input_type(C.InputType.recurrent(5))
            .t_bptt_forward_length(4).t_bptt_backward_length(4).build())


def _tbptt_data(seed=11):
    rng = np.random.default_rng(seed)
    # T=10 -> 3 windows incl. a padded+masked tail; B=16 splits over 8
    X = rng.normal(size=(16, 10, 5)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (16, 10))]
    mask = np.ones((16, 10), np.float32)
    mask[3, 7:] = 0
    mask[:2, 2:] = 0  # slot 0's rows keep 2 steps: unequal masked counts
    return X, labels, mask


def test_masked_tbptt_matches_jax_wrapper():
    """tBPTT (3 windows, a padded tail) over a variable-length masked
    batch: the port over 8 slots equals the JAX wrapper over 8 devices
    for 3 epochs, the carries are restored after every batch, and the
    masked loss mean is the whole batch's (a per-slot mean of masked
    means lands far outside the tolerance)."""
    X, y, m = _tbptt_data()
    conf = lambda C: _tbptt_conf(C)  # noqa: E731
    jnet, pnet = _pair(conf)
    start = pnet.clone()
    saved_state = [dict(s) for s in pnet._layer_state]
    JWrapper(jnet, mesh=jmake_mesh({"data": 8})).fit(
        JList([JDataSet(X, y, m, m)]), epochs=3)
    ParallelWrapper(pnet, mesh=_mesh8()).fit(
        ListDataSetIterator([DataSet(X, y, m, m)]), epochs=3)
    _close(pnet, jnet, SGD_ATOL)
    assert pnet.iteration == jnet.iteration == 9  # one per window
    assert [set(s) for s in pnet._layer_state] == \
        [set(s) for s in saved_state]
    assert "h" not in pnet._layer_state[0]
    out = pnet.output(X)
    assert tuple(out.shape) == (16, 10, 4)
    # a per-slot tBPTT step on the first window alone
    one = start.clone()
    ParallelWrapper(one, mesh=_mesh8()).fit(
        DataSet(X[:, :4], y[:, :4], m[:, :4], m[:, :4]))
    per_slot = _per_slot_one_step(start.clone, X[:, :4], y[:, :4],
                                  fm=m[:, :4], lm=m[:, :4])
    assert np.abs(per_slot - _np(one.params())).max() > 1e3 * SGD_ATOL


def test_tbptt_graph_matches_jax_wrapper():
    """A tBPTT ComputationGraph under the wrapper equals the JAX graph
    under its wrapper (the DAG container rides the same window path)."""
    def conf(C):
        return (C.NeuralNetConfiguration.Builder().seed(41).learning_rate(0.1)
                .graph_builder().add_inputs("in")
                .add_layer("lstm", C.GravesLSTM(n_in=5, n_out=8,
                                                activation="tanh"), "in")
                .add_layer("out", C.RnnOutputLayer(
                    n_in=8, n_out=4, activation="softmax", loss="mcxent"),
                    "lstm")
                .set_outputs("out")
                .t_bptt_forward_length(4).t_bptt_backward_length(4).build())

    rng = np.random.default_rng(12)
    X = rng.normal(size=(16, 10, 5)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (16, 10))]
    jg, pg = _pair(conf, graph=True)
    JWrapper(jg, mesh=jmake_mesh({"data": 8})).fit(
        JList([JMultiDataSet([X], [y])]), epochs=2)
    ParallelWrapper(pg, mesh=_mesh8()).fit(
        ListDataSetIterator([MultiDataSet([X], [y])]), epochs=2)
    np.testing.assert_allclose(_np(pg._params["lstm"]["W"]),
                               np.asarray(jg._params["lstm"]["W"]),
                               rtol=0, atol=SGD_ATOL)
    assert pg.score_value == pytest.approx(float(jg.score_value),
                                           rel=LOSS_RTOL)
    assert pg.iteration == jg.iteration == 6


def test_tbptt_restores_the_persistent_slots_after_a_failure():
    """The carries are restored even when a window fails mid-batch."""
    X, y, m = _tbptt_data()
    net = MultiLayerNetwork(_tbptt_conf(PC), device="cpu")
    net.init()
    before = net._layer_state[0]

    class Boom:
        def iteration_done(self, model, iteration):
            if iteration == 2:
                raise RuntimeError("boom")

    net.set_listeners(Boom())
    with pytest.raises(RuntimeError, match="boom"):
        ParallelWrapper(net, mesh=_mesh8()).fit(DataSet(X, y, m, m))
    assert net._layer_state[0] is before


def test_listeners_and_async_wrap():
    """Listeners see record_batch (the trimmed size), iteration_done and
    the epoch hooks; an async-capable iterator is wrapped in
    AsyncDataSetIterator of `prefetch_buffer`."""
    events = []

    class Rec:
        def record_batch(self, n):
            events.append(("batch", n))

        def iteration_done(self, model, it):
            events.append(("it", it))

        def on_epoch_start(self, model):
            events.append("start")

        def on_epoch_end(self, model):
            events.append("end")

    X, y = _data(n=20)
    net = MultiLayerNetwork(_dense_conf(PC), device="cpu")
    net.set_listeners(Rec())
    pw = ParallelWrapper(net, mesh=_mesh8(), prefetch_buffer=3)
    seen = []
    orig = AsyncDataSetIterator.__init__

    def spy(self, underlying, queue_size=2):
        seen.append(queue_size)
        orig(self, underlying, queue_size)

    AsyncDataSetIterator.__init__ = spy
    try:
        pw.fit(ListDataSetIterator([DataSet(X, y)]))
    finally:
        AsyncDataSetIterator.__init__ = orig
    assert events == ["start", ("batch", 16), ("it", 1), "end"]
    assert seen == [3]
    assert pw.get_network() is net and pw.num_devices == 8


@pytest.mark.parametrize("what", ["two_devices", "model_axis", "param_specs",
                                  "expert_axis", "save", "load"])
def test_the_multi_device_half_raises_naming_a12b(what, tmp_path):
    """A12b is ported: a `model` axis and splitting `param_specs` are
    checked and computed unsplit (the global view), an `expert_axis` the
    mesh lacks is the JAX wrapper's ValueError. A12c is ported too: a
    mesh over distinct devices in one process is refused, since the port
    runs one process per card, and the sharded checkpoints round-trip."""
    net = MultiLayerNetwork(_dense_conf(PC), device="cpu")
    if what == "model_axis":
        ParallelWrapper(net, mesh=pmesh.make_mesh(
            {"data": 4, "model": 2}, devices=CPU8))
        return
    if what == "param_specs":
        mesh = pmesh.make_mesh({"data": 4, "model": 2}, devices=CPU8)
        ParallelWrapper(net, mesh=mesh,
                        param_specs={0: {"W": (None, "model")}})
        with pytest.raises(ValueError, match="not a mesh axis"):
            ParallelWrapper(net, mesh=_mesh8(),
                            param_specs={0: {"W": (None, "model")}})
        return
    if what == "expert_axis":
        net.layers[0].expert_axis = "expert"
        net.layers[0].n_experts = 8
        try:
            with pytest.raises(ValueError, match="expert_axis 'expert'"):
                ParallelWrapper(net, mesh=_mesh8())
        finally:
            del net.layers[0].expert_axis
            del net.layers[0].n_experts
        return
    if what == "two_devices":
        with pytest.raises(ValueError, match="one process per card"):
            ParallelWrapper(net, mesh=pmesh.make_mesh(
                devices=[torch.device("cpu"), torch.device("meta")]))
    else:
        ck = tmp_path / "ck"
        other = MultiLayerNetwork(_dense_conf(PC), device="cpu")
        if what == "save":
            ParallelWrapper(net, mesh=_mesh8()).save_checkpoint(ck)
            ParallelWrapper(other, mesh=_mesh8()).load_checkpoint(ck)
        else:
            ParallelWrapper(other, mesh=_mesh8()).save_checkpoint(ck)
            ParallelWrapper(net, mesh=_mesh8()).load_checkpoint(ck)
        assert torch.equal(net.params(), other.params())
    # replicated specs are accepted
    ParallelWrapper(net, mesh=_mesh8(),
                    param_specs={0: {"W": (None, None), "b": ()}})


# --------------------------------------------------------- device prefetch
def _prefetch_batches(rng, n=5):
    return [DataSet(rng.normal(size=(16, 4)).astype(np.float32),
                    rng.normal(size=(16, 2)).astype(np.float32))
            for _ in range(n)]


def test_device_prefetch_iterator():
    """MagicQueue-role staging: on a CPU target the batches pass through
    unchanged, in order, and the iterator re-iterates after reset; a
    placement on the 8-slot mesh names its device; it feeds a training
    loop with the JAX package's results."""
    rng = np.random.default_rng(0)
    batches = _prefetch_batches(rng)
    it = DevicePrefetchIterator(ListDataSetIterator(batches), depth=2,
                                device="cpu")
    out = list(it)
    assert len(out) == 5 and all(a is b for a, b in zip(out, batches))
    assert len(list(it)) == 5
    assert it.async_supported is False and it.batch() == 16
    assert it.copy_stream is None and it.staged == 0

    placement = _mesh8().data_placement("data")
    sh = DevicePrefetchIterator(ListDataSetIterator(batches),
                                sharding=placement)
    assert sh.device == torch.device("cpu") and sh.sharding is placement
    np.testing.assert_array_equal(next(iter(sh)).features,
                                  batches[0].features)

    cls = [(rng.normal(size=(16, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
           for _ in range(4)]
    jnet, pnet = _pair(lambda C: _dense_conf(C, updater="sgd"))
    jnet.fit(JList([JDataSet(a, b) for a, b in cls]), epochs=2)
    pnet.fit(DevicePrefetchIterator(
        ListDataSetIterator([DataSet(a, b) for a, b in cls]),
        device="cpu"), epochs=2)
    _close(pnet, jnet, SGD_ATOL)


def test_device_prefetch_placement_rules():
    two = pmesh.make_mesh(devices=[torch.device("cpu"), torch.device("meta")])
    with pytest.raises(ValueError, match="one process per card"):
        DevicePrefetchIterator(ListDataSetIterator([]),
                               sharding=two.data_placement("data"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DevicePrefetchIterator(ListDataSetIterator([]))


# ------------------------------------------------- SequenceVectors(mesh=)
W2V = dict(layer_size=16, window=2, epochs=2, batch_size=64, seed=11,
           min_word_frequency=1, negative=0, use_hierarchic_softmax=True)


def test_distributed_word2vec_parity():
    """A mesh on one device trains exactly like the single-device path
    (bit for bit), and both match the JAX package's single-device fit
    (hierarchical softmax: every draw on the host) to 1e-5."""
    import deeplearning4j_tpu.nlp as J
    import deeplearning4j_tpu_torch.nlp as T

    corpus = [("the quick brown fox jumps over the lazy dog " * 3).split()
              for _ in range(30)]
    single = T.Word2Vec(device="cpu", **W2V)
    single.fit(corpus)
    sharded = T.Word2Vec(mesh=_mesh8(), device="cpu", **W2V)
    sharded.fit(corpus)
    assert torch.equal(single.lookup_table.syn0, sharded.lookup_table.syn0)
    ref = J.Word2Vec(**W2V)
    ref.fit(corpus)
    np.testing.assert_allclose(sharded.lookup_table.syn0.numpy(),
                               np.asarray(ref.lookup_table.syn0),
                               rtol=1e-5, atol=1e-5)
    assert sharded.similarity("quick", "quick") == pytest.approx(1.0)


def test_distributed_word2vec_batch_divisibility():
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    with pytest.raises(ValueError, match="must divide"):
        Word2Vec(mesh=_mesh8(), batch_size=100, device="cpu")
    meta = pmesh.make_mesh(devices=[torch.device("meta")] * 8)
    with pytest.raises(ValueError, match="not device="):
        Word2Vec(mesh=meta, batch_size=64, device="cpu")


# ------------------------------------------------------------ time sources
def test_time_sources():
    from deeplearning4j_tpu_torch.parallel.time_source import (
        MonotonicTimeSource,
        NTPTimeSource,
        SystemTimeSource,
        TimeSourceProvider,
    )

    now = SystemTimeSource().current_time_millis()
    mono = MonotonicTimeSource().current_time_millis()
    assert abs(now - mono) < 2000
    # injected offset: no network IO
    ntp = NTPTimeSource(offset_ms=5000.0)
    assert ntp.current_time_millis() - mono > 4000
    TimeSourceProvider.reset()
    assert isinstance(TimeSourceProvider.get_instance(), MonotonicTimeSource)
    TimeSourceProvider.reset()
