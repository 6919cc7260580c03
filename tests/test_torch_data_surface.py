"""The port's data surface and listeners held against the JAX package on
the CPU: `DataSet` (split, shuffle, save/load, merge) and `MultiDataSet`;
the statistics normalizers (statistics to 1e-12, transforms and their
reverts to 1e-6, `normalizer.bin` in both directions, attached to a
network and trained on: losses to 1e-6); the iterators, with the
prefetch thread's lifetime checked (each such test runs under its own
time limit, `_within`, so a leaked or stuck producer fails the test
rather than hanging a worker); and the listeners on networks from shared
weights.
"""
import logging
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from deeplearning4j_tpu.datasets import dataset as jds  # noqa: E402
from deeplearning4j_tpu.datasets import iterators as jit_  # noqa: E402
from deeplearning4j_tpu.datasets import normalizers as jnorm  # noqa: E402
from deeplearning4j_tpu.nn import conf as jconf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.nn.updater import Updater as JUpdater  # noqa: E402
from deeplearning4j_tpu.optimize import listeners as jlis  # noqa: E402
from deeplearning4j_tpu.ops.activations import (  # noqa: E402
    Activation as JAct,
)
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss  # noqa: E402
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402
from deeplearning4j_tpu_torch.datasets import dataset as pds  # noqa: E402
from deeplearning4j_tpu_torch.datasets import iterators as pit  # noqa: E402
from deeplearning4j_tpu_torch.datasets import normalizers as pnorm  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.optimize import listeners as plis  # noqa: E402
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


def _within(seconds, fn):
    """Run `fn` on a thread and fail unless it returns within `seconds`
    (re-raising what it raised)."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed back to the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still running after {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _producers():
    return [t for t in threading.enumerate()
            if t.name == "AsyncDataSetIterator" and t.is_alive()]


def _arrays(seed, n=10, masks=True):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, 3, 4)).astype(np.float32)
    lab = rng.integers(0, 5, (n, 3)).astype(np.int32)
    fm = (rng.random((n, 3)) > 0.2).astype(np.float32) if masks else None
    lm = (rng.random((n, 3)) > 0.2).astype(np.float32) if masks else None
    return f, lab, fm, lm


def _same_ds(a, b):
    for name in ("features", "labels", "features_mask", "labels_mask"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------------------------------------------- DataSet
@pytest.mark.parametrize("masks", [True, False])
def test_split_shuffle_batch_and_merge_match(masks):
    arrs = _arrays(0, masks=masks)
    j, p = jds.DataSet(*arrs), pds.DataSet(*arrs)
    for a, b in zip(j.split_test_and_train(7), p.split_test_and_train(7)):
        _same_ds(a, b)
    j.shuffle(11)
    p.shuffle(11)
    _same_ds(j, p)
    for a, b in zip(j.batch_by(4), p.batch_by(4)):
        _same_ds(a, b)
    other = _arrays(1, n=3, masks=False)
    _same_ds(jds.DataSet.merge([j, jds.DataSet(*other)]),
             pds.DataSet.merge([p, pds.DataSet(*other)]))
    assert p.num_examples() == 10


def test_save_and_load_in_both_directions(tmp_path):
    full = pds.DataSet(*_arrays(2))
    bare = pds.DataSet(_arrays(3)[0])
    for ds, name in ((full, "full"), (bare, "bare")):
        ds.save(tmp_path / f"port_{name}")
        _same_ds(jds.DataSet.load(tmp_path / f"port_{name}.npz"), ds)
        jds.DataSet(ds.features, ds.labels, ds.features_mask,
                    ds.labels_mask).save(tmp_path / f"jax_{name}.npz")
        _same_ds(pds.DataSet.load(tmp_path / f"jax_{name}"), ds)
    assert pds.DataSet.load(tmp_path / "port_full.npz").labels.dtype == \
        np.int32


def test_multi_dataset():
    x = [np.zeros((4, 2)), np.ones((4, 3))]
    mds = pds.MultiDataSet(x, [np.zeros((4, 1))])
    assert mds.num_examples() == 4 and mds.features_masks is None
    assert pds.MultiDataSet().labels == []


# ---------------------------------------------------------- normalizers
def _norm_data(seed=4):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((12, 2, 3)) * [1.0, 5.0, 0.1]
         + [0.0, 3.0, -2.0]).astype(np.float32)
    f[:, 1, 2] = 7.0  # a constant column: std clamped to 1
    return f, rng.standard_normal((12, 2)).astype(np.float32)


KINDS = {
    "standardize": (lambda m: m.NormalizerStandardize(), ("mean", "std")),
    "standardize labels": (lambda m: m.NormalizerStandardize(fit_label=True),
                           ("mean", "std", "label_mean", "label_std")),
    "minmax": (lambda m: m.NormalizerMinMaxScaler(-1.0, 2.0),
               ("fmin", "fmax")),
    "image": (lambda m: m.ImagePreProcessingScaler(0.0, 1.0, 255.0), ()),
    "one hot": (lambda m: m.OneHotEncoder(9), ()),
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("source", ["dataset", "iterator"])
def test_normalizers_fit_transform_revert_and_bytes_match(kind, source):
    make, stats = KINDS[kind]
    f, lab = _norm_data()
    if kind == "image":
        f = (np.abs(f) * 20).astype(np.float32)
    if kind == "one hot":
        f = np.random.default_rng(0).integers(0, 9, (12, 5))
    halves = [(f[:7], lab[:7]), (f[7:], lab[7:])]
    if source == "dataset":
        jsrc, psrc = jds.DataSet(f, lab), pds.DataSet(f, lab)
    else:
        jsrc = jit_.ListDataSetIterator([jds.DataSet(*h) for h in halves])
        psrc = pit.ListDataSetIterator([pds.DataSet(*h) for h in halves])
    j, p = make(jnorm).fit(jsrc), make(pnorm).fit(psrc)
    for s in stats:
        np.testing.assert_allclose(getattr(p, s), getattr(j, s), rtol=1e-12,
                                   atol=1e-12, err_msg=s)
    if kind == "one hot":
        assert p.n_classes == j.n_classes == 9
    jt, pt = j.transform(jds.DataSet(f, lab)), p.transform(pds.DataSet(f, lab))
    np.testing.assert_allclose(pt.features, jt.features, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(pt.labels, jt.labels, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.revert_features(pt.features),
                               j.revert_features(jt.features), rtol=1e-6,
                               atol=1e-5)
    if kind.startswith("standardize"):
        np.testing.assert_allclose(p.revert_labels(pt.labels),
                                   j.revert_labels(jt.labels), rtol=1e-6,
                                   atol=1e-5)
    # normalizer.bin both ways: registry names and arrays line up
    for back in (jnorm.DataNormalization.from_bytes(p.to_bytes()),
                 pnorm.DataNormalization.from_bytes(j.to_bytes())):
        assert back.KIND == p.KIND and back._meta() == p._meta()
        for s in stats:
            np.testing.assert_array_equal(getattr(back, s), getattr(p, s))
    if kind == "standardize labels":
        with pytest.raises(ValueError, match="fit_label=True"):
            p.check_device_attachable()
        with pytest.raises(ValueError, match="fit_label=True"):
            j.check_device_attachable()
        return
    # the device transform (torch) is the host transform
    feats = torch.from_numpy(np.asarray(f))
    got = p.device_transform(feats if kind == "one hot" else feats.float())
    np.testing.assert_allclose(got.numpy(), pt.features, rtol=1e-6, atol=1e-6)


def _mlp_conf():
    return (jconf.NeuralNetConfiguration.Builder().seed(7).learning_rate(0.05)
            .updater(JUpdater.ADAM).activation(JAct.TANH).list()
            .layer(jconf.DenseLayer(n_out=8))
            .layer(jconf.OutputLayer(n_out=3, loss=JLoss.MCXENT,
                                     activation=JAct.SOFTMAX))
            .set_input_type(jconf.InputType.feed_forward(6)).build())


def _pair(conf):
    jnet = JaxNet(conf)
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    tree = lambda t: jax.tree.map(np.asarray, t)
    pnet.set_param_tree(pser.params_from_jax(pnet.conf, tree(jnet._params)))
    pnet.set_updater_state(pser.updater_state_from_jax(
        pnet.conf, tree(jnet._upd_state)))
    return jnet, pnet


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
def test_attached_normalizers_train_and_checkpoint_like_the_jax_package(
        kind, tmp_path):
    rng = np.random.default_rng(8)
    x = (rng.random((16, 6)) * 255).astype(np.uint8 if kind == "image"
                                             else np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    make = {"standardize": lambda m: m.NormalizerStandardize(),
            "minmax": lambda m: m.NormalizerMinMaxScaler(),
            "image": lambda m: m.ImagePreProcessingScaler()}[kind]
    jn, pn = make(jnorm).fit(jds.DataSet(x, y)), make(pnorm).fit(
        pds.DataSet(x, y))
    jnet, pnet = _pair(_mlp_conf())
    jnet.set_normalizer(jn)
    pnet.set_normalizer(pn)
    for _ in range(3):
        jnet.fit(jds.DataSet(x, y))
        pnet.fit(pds.DataSet(x, y))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   rtol=1e-6)
    np.testing.assert_allclose(pnet.output(x).numpy(), jnet.output(x),
                               rtol=1e-5, atol=1e-6)
    pser.write_model(pnet, tmp_path / "p.zip", normalizer=pn)
    jser.write_model(jnet, tmp_path / "j.zip", normalizer=jn)
    for path in ("p.zip", "j.zip"):
        for back in (jser.restore_normalizer(tmp_path / path),
                     pser.restore_normalizer(tmp_path / path)):
            assert back.KIND == pn.KIND
            for k, v in pn._arrays().items():
                np.testing.assert_array_equal(getattr(back, k), v)
    assert pser.restore_normalizer(tmp_path / "p.zip").__class__ is \
        type(pn)
    assert isinstance(pser.restore_model(tmp_path / "j.zip", device="cpu"),
                      MultiLayerNetwork)


def test_host_only_normalizers_are_refused_like_the_jax_package():
    _, pnet = _pair(_mlp_conf())
    with pytest.raises(ValueError, match="cannot run on the device"):
        pnet.set_normalizer(pnorm.NormalizerStandardize(fit_label=True))

    class HostOnly(pnorm.DataNormalization):
        pass

    with pytest.raises(ValueError, match="no device-side transform"):
        pnet.set_normalizer(HostOnly())
    pnet.set_normalizer(None)
    assert pnet.get_normalizer() is None


# ------------------------------------------------------------ iterators
def _batches(n, seed=0):
    return [pds.DataSet(np.full((2, 3), i, np.float32),
                        np.full((2,), i % 3, np.int32)) for i in range(n)]


def _firsts(it):
    return [int(ds.features[0, 0]) for ds in it]


def test_async_iterator_delivers_in_order_and_restarts():
    def body():
        it = pit.AsyncDataSetIterator(
            pit.ListDataSetIterator(_batches(20)), queue_size=3)
        assert _firsts(it) == list(range(20))
        assert _firsts(it) == list(range(20))  # __iter__ resets
        assert not it.has_next() and not _producers()  # ended with the pass
        it.reset()
        assert it.has_next()  # a producer runs again
        it.reset()
        assert not _producers()

    _within(30, body)


def test_async_iterator_raises_the_producers_error_in_order():
    class Failing(pit.ListDataSetIterator):
        def next(self):
            if self._pos == 3:
                raise OSError("disk gone at batch 3")
            return super().next()

    def body():
        it = pit.AsyncDataSetIterator(Failing(_batches(6)), queue_size=2)
        got = []
        with pytest.raises(OSError, match="batch 3"):
            for ds in it:
                got.append(int(ds.features[0, 0]))
        assert got == [0, 1, 2] and not _producers()

    _within(30, body)


def test_reset_and_close_stop_a_blocked_producer():
    def body():
        it = pit.AsyncDataSetIterator(
            pit.ListDataSetIterator(_batches(50)), queue_size=1)
        assert it.has_next()  # the producer now waits on a full queue
        it.reset()
        assert not _producers()
        assert _firsts(it)[:3] == [0, 1, 2]
        assert it.has_next() is False
        it2 = pit.AsyncDataSetIterator(
            pit.ListDataSetIterator(_batches(50)), queue_size=1)
        assert it2.next().features[0, 0] == 0
        it2.close()
        assert not _producers()

    _within(30, body)


def test_a_failure_in_fit_stops_the_producer_and_reaches_the_caller():
    """The producer's error, and an error in the step, both propagate
    out of `fit`, with no producer thread left behind."""
    conf = MultiLayerConfiguration.from_json(_mlp_conf().to_json())

    def body():
        net = MultiLayerNetwork(conf, device="cpu")
        rng = np.random.default_rng(0)
        good = [pds.DataSet(rng.standard_normal((4, 6)).astype(np.float32),
                            np.eye(3, dtype=np.float32)[[0, 1, 2, 0]])
                for _ in range(8)]

        class Failing(pit.ListDataSetIterator):
            def next(self):
                if self._pos == 2:
                    raise OSError("source lost")
                return super().next()

        with pytest.raises(OSError, match="source lost"):
            net.fit(pit.AsyncDataSetIterator(Failing(good), queue_size=1))
        assert net.iteration == 2 and not _producers()
        bad = good[:3] + [pds.DataSet(good[0].features,
                                      np.eye(4, dtype=np.float32)[[0] * 4])]
        bad += good
        with pytest.raises(ValueError, match="width 4"):
            net.fit(pit.AsyncDataSetIterator(pit.ListDataSetIterator(bad),
                                             queue_size=1))
        assert net.iteration == 5 and not _producers()

    _within(60, body)


def test_async_multi_dataset_iterator():
    rng = np.random.default_rng(0)
    mds = [pds.MultiDataSet([rng.standard_normal((4, 3))],
                            [rng.standard_normal((4, 2))]) for _ in range(5)]

    def body():
        it = pit.AsyncMultiDataSetIterator(pit.ListDataSetIterator(mds),
                                           queue_size=2)
        for _ in range(2):
            got = []
            while it.has_next():
                got.append(it.next())
            assert [g.features[0] is m.features[0]
                    for g, m in zip(got, mds)] == [True] * 5
            it.reset()
        assert not _producers()

    _within(30, body)


def test_other_iterators_match_the_jax_package(tmp_path):
    sets = [pds.DataSet(*_arrays(s, n=3 + s, masks=False)[:2])
            for s in range(4)]
    jsets = [jds.DataSet(d.features, d.labels) for d in sets]
    pairs = [
        (pit.IteratorDataSetIterator(sets, 4),
         jit_.IteratorDataSetIterator(jsets, 4)),
        (pit.MultipleEpochsIterator(3, pit.ListDataSetIterator(sets)),
         jit_.MultipleEpochsIterator(3, jit_.ListDataSetIterator(jsets))),
        (pit.ExistingDataSetIterator(sets),
         jit_.ExistingDataSetIterator(jsets)),
    ]
    for p, j in pairs:
        for _ in range(2):
            got, want = list(p), list(j)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                _same_ds(a, b)
    gen = pit.ExistingDataSetIterator(d for d in sets)
    assert len(list(gen)) == 4
    with pytest.raises(ValueError, match="one-shot"):
        list(gen)
    once = pit.IteratorDataSetIterator((d for d in sets), 5)
    assert [d.num_examples() for d in once] == [5, 5, 5, 3]
    with pytest.raises(ValueError, match="one-shot"):
        list(once)
    for i in (10, 9, 2):  # digit runs sort as numbers: 2, 9, 10
        jsets[i % 4].save(tmp_path / f"shard_{i}")
    files = pit.FileDataSetIterator(tmp_path)
    assert [p.rsplit("/", 1)[1] for p in files.paths] == \
        ["shard_2.npz", "shard_9.npz", "shard_10.npz"]
    _same_ds(list(files)[2], sets[2])
    assert pit.natural_key("s_10") > pit.natural_key("s_9")
    single = pit.SingletonMultiDataSetIterator("mds")
    assert list(single) == ["mds"] and list(single) == ["mds"]
    assert single.async_supported is False


def test_device_cache_iterator_trains_like_host_batches():
    """Staged batches (here on the CPU device) keep their dtypes and
    train bit-identically to host batches; the range recorded at staging
    is checked in `fit` without reading the batch back."""
    conf = MultiLayerConfiguration.from_json(_mlp_conf().to_json())
    rng = np.random.default_rng(1)
    data = [pds.DataSet(rng.standard_normal((4, 6)).astype(np.float32),
                        rng.integers(0, 3, 4).astype(np.int32))
            for _ in range(3)]
    a, b = MultiLayerNetwork(conf, device="cpu"), MultiLayerNetwork(
        conf, device="cpu")
    cached = pit.DeviceCacheDataSetIterator(data, device="cpu")
    assert cached.batch() == 4 and cached.async_supported is False
    assert cached._data[0].labels.dtype == torch.int32
    a.fit(cached, epochs=2)
    b.fit(pit.ListDataSetIterator(data), epochs=2)
    assert torch.equal(a.params(), b.params())
    bad = [pds.DataSet(data[0].features, np.array([0, 1, 3, 0], np.int32))]
    with pytest.raises(ValueError, match="out of range"):
        a.fit(pit.DeviceCacheDataSetIterator(bad, device="cpu"))
    assert cached._data[1]._value_ranges["labels"] == (
        int(data[1].labels.min()), int(data[1].labels.max()))


# ------------------------------------------------------------ listeners
def test_listeners_match_the_jax_package(tmp_path, caplog):
    jnet, pnet = _pair(_mlp_conf())
    rng = np.random.default_rng(9)
    batches = [(rng.standard_normal((8, 6)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
               for _ in range(4)]
    jc, pc = jlis.CollectScoresIterationListener(2), \
        plis.CollectScoresIterationListener(2)
    jp = jlis.ParamAndGradientIterationListener(2, tmp_path / "j.tsv")
    pp = plis.ParamAndGradientIterationListener(2, tmp_path / "p.tsv")
    perf = plis.PerformanceListener(2)
    jnet.set_listeners(jc, jp)
    pnet.set_listeners(plis.ScoreIterationListener(1), perf, pc, pp)
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        jnet.fit(jit_.ListDataSetIterator([jds.DataSet(*b) for b in batches]))
        pnet.fit(pit.ListDataSetIterator([pds.DataSet(*b) for b in batches]))
    assert [i for i, _ in pc.scores] == [i for i, _ in jc.scores] == [2, 4]
    np.testing.assert_allclose([s for _, s in pc.scores],
                               [s for _, s in jc.scores], rtol=1e-6)
    assert sum("Score at iteration" in r.message for r in caplog.records) == 4
    assert perf.last_samples_per_sec > 0 and perf.last_batches_per_sec > 0
    jrows = (tmp_path / "j.tsv").read_text().splitlines()
    prows = (tmp_path / "p.tsv").read_text().splitlines()
    assert prows[0] == jrows[0] == plis.ParamAndGradientIterationListener.HEADER
    assert len(prows) == len(jrows) == 1 + 2 * 4
    for a, b in zip(prows[1:], jrows[1:]):
        pa, ja = a.split("\t"), b.split("\t")
        assert pa[0] == ja[0] and pa[2] == ja[2]
        np.testing.assert_allclose([float(v) for v in pa[3:7]],
                                   [float(v) for v in ja[3:7]], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose([float(v) for v in pa[7:]],
                                   [float(v) for v in ja[7:]], rtol=1e-3,
                                   atol=1e-5)
