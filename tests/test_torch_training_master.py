"""The port's parameter-averaging master, its distributed handles, the
in-process parameter server, export-staged training, repartitioning and
the CLI (`deeplearning4j_tpu_torch.parallel`) held against the JAX
package on the CPU at small size (4 features, 8 hidden units, 3
classes).

Both packages start from the same weights (`params_from_jax`) and see
the same batches, made with numpy from a seed; the workers are
`net.clone()`s on threads in both. Tolerances: parameters 1e-6 absolute
and scores 1e-6 relative for SGD (the averages are the same `np.average`
over the same f32 vectors), lr / 30 for Adam's parameters and moments
after several steps (ROADMAP queue C's Adam caveat); an updater state
flattened by the port equals the JAX package's `ravel_pytree` bit for
bit. Every test bounds its own wall time.
"""
import sys
import time
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    ListDataSetIterator as JList,
)
from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet,
)
from deeplearning4j_tpu.parallel import training_master as jtm  # noqa: E402
from deeplearning4j_tpu.parallel.parameter_server import (  # noqa: E402
    ParameterServerParallelWrapper as JPSWrapper,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    FileDataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.parallel import training_master as ptm  # noqa: E402
from deeplearning4j_tpu_torch.parallel.parameter_server import (  # noqa: E402
    ParameterServer,
    ParameterServerParallelWrapper,
)
from deeplearning4j_tpu_torch.parallel.training_master import (  # noqa: E402
    DistributedMultiLayer,
    ParameterAveragingTrainingMaster,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
    updater_state_from_jax,
)

ATOL = 1e-6
RTOL = 1e-6


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
    t0 = time.monotonic()
    yield
    assert time.monotonic() - t0 < 60.0


def _conf(C, seed=12345, lr=0.1, updater="sgd"):
    return (C.NeuralNetConfiguration.Builder()
            .seed(seed).learning_rate(lr).updater(updater)
            .list()
            .layer(C.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(C.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())


def _pair(**kw):
    """(JAX network, port network on the CPU) with the same weights."""
    jnet = JNet(_conf(JC, **kw))
    jnet.init()
    pconf = _conf(PC, **kw)
    pnet = MultiLayerNetwork(pconf, device="cpu")
    pnet.set_param_tree(params_from_jax(pconf, jnet._params))
    return jnet, pnet


def _net(**kw):
    return _pair(**kw)[1]


def _arrays(n, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = rng.randn(batch, 4).astype(np.float32)
        l = np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)]
        out.append((f, l))
    return out


def _batches(n, batch=16, seed=0):
    return [DataSet(f, l) for f, l in _arrays(n, batch, seed)]


def _both(n, batch=16, seed=0):
    arrs = _arrays(n, batch, seed)
    return ([JDataSet(f, l) for f, l in arrs],
            [DataSet(f, l) for f, l in arrs])


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(pnet, jnet, atol=ATOL):
    np.testing.assert_allclose(_np(pnet.params()), np.asarray(jnet.params()),
                               rtol=0, atol=atol)


# ------------------------------------------------------------- averaging
def test_single_worker_parity_vs_single_machine():
    """num_workers=1 parameter averaging is exactly single-machine SGD,
    and equals the JAX package's master."""
    jb, pb = _both(6)
    single = _net()
    for ds in pb:
        single.fit(ds)
    jnet, pnet = _pair()
    jtm.DistributedMultiLayer(jnet, jtm.ParameterAveragingTrainingMaster(
        num_workers=1, averaging_frequency=3)).fit(JList(jb))
    DistributedMultiLayer(pnet, ParameterAveragingTrainingMaster(
        num_workers=1, averaging_frequency=3)).fit(ListDataSetIterator(pb))
    np.testing.assert_allclose(_np(pnet.params()), _np(single.params()),
                               rtol=0, atol=1e-7)
    _close(pnet, jnet)
    assert pnet.score_value == pytest.approx(float(jnet.score_value),
                                             rel=RTOL)


def test_identical_shards_average_to_single_machine():
    base = _batches(3, seed=1)
    batches = [b for b in base for _ in range(3)]
    single = _net()
    for ds in base:
        single.fit(ds)
    dist_net = _net()
    master = ParameterAveragingTrainingMaster(num_workers=3,
                                              averaging_frequency=3)
    DistributedMultiLayer(dist_net, master).fit(ListDataSetIterator(batches))
    np.testing.assert_allclose(_np(dist_net.params()), _np(single.params()),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("container", ["multilayer", "graph"])
def test_flat_updater_state_is_the_jax_ravel_order(container):
    """The flat updater state (and its inverse) follows `ravel_pytree`:
    the JAX network's Adam state, loaded into the port's, flattens to the
    same vector bit for bit, for the list and the graph container."""
    from jax.flatten_util import ravel_pytree

    def gconf(C):
        return (C.NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
                .updater("adam").graph_builder().add_inputs("in")
                .add_layer("zd", C.DenseLayer(n_in=4, n_out=8,
                                              activation="tanh"), "in")
                .add_layer("a_out", C.OutputLayer(
                    n_in=8, n_out=3, activation="softmax", loss="mcxent"),
                    "zd")
                .set_outputs("a_out").build())

    if container == "multilayer":
        jnet = JNet(_conf(JC, updater="adam"))
        pconf = _conf(PC, updater="adam")
        pnet = MultiLayerNetwork(pconf, device="cpu")
    else:
        jnet = JGraph(gconf(JC))
        pconf = gconf(PC)
        pnet = ComputationGraph(pconf, device="cpu")
    jnet.init()
    jnet.fit(JDataSet(*_arrays(1)[0]))
    pnet.set_param_tree(params_from_jax(pconf, jnet._params))
    pnet.set_updater_state(updater_state_from_jax(pconf, jnet._upd_state))
    flat = ptm._flat_updater_state(pnet)
    ref = np.asarray(ravel_pytree(jnet._upd_state)[0])
    assert flat.dtype == np.float32
    np.testing.assert_array_equal(flat, ref)
    ptm._set_updater_state_flat(pnet, ref * 2.0)
    np.testing.assert_array_equal(ptm._flat_updater_state(pnet), ref * 2.0)
    sgd = MultiLayerNetwork(_conf(PC), device="cpu")
    sgd.init()
    assert ptm._flat_updater_state(sgd) is None


def test_averaging_trains_and_averages_updater_state():
    """2 workers x 2 batches a window, Adam, 3 epochs, example-weighted
    averaging of params and moments: equal to the JAX master."""
    jb, pb = _both(8, seed=2)
    jnet, pnet = _pair(updater="adam", lr=0.01)
    s0 = pnet.score(pb[0])
    jtm.DistributedMultiLayer(jnet, jtm.ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=2)).fit(JList(jb), epochs=3)
    master = ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=2, collect_training_stats=True)
    DistributedMultiLayer(pnet, master).fit(ListDataSetIterator(pb),
                                            epochs=3)
    assert pnet.score(pb[0]) < s0
    _close(pnet, jnet, atol=0.01 / 30)
    from jax.flatten_util import ravel_pytree

    np.testing.assert_allclose(
        ptm._flat_updater_state(pnet),
        np.asarray(ravel_pytree(jnet.get_updater_state())[0]),
        rtol=0, atol=0.01 / 30)
    assert float(np.abs(ptm._flat_updater_state(pnet)).sum()) > 0
    stats = master.get_training_stats()
    assert {"split", "fit", "aggregate", "broadcast"} <= set(stats.get_keys())
    assert "fit" in stats.summary()
    assert pnet.iteration == jnet.iteration == 12


def test_uneven_tail_window_is_example_weighted_like_jax():
    """A tail window of unequal shards (batches of 16, 16 and 8 over 2
    workers) averages example-weighted, as the JAX master does; the
    unweighted mean (example_weighted=False) is the JAX package's too."""
    arrs = _arrays(2, seed=9) + _arrays(1, batch=8, seed=10)
    for weighted in (True, False):
        jnet, pnet = _pair()
        jtm.ParameterAveragingTrainingMaster(
            num_workers=2, averaging_frequency=2,
            example_weighted=weighted).execute_training(
            jnet, JList([JDataSet(f, l) for f, l in arrs]))
        ParameterAveragingTrainingMaster(
            num_workers=2, averaging_frequency=2,
            example_weighted=weighted).execute_training(
            pnet, ListDataSetIterator([DataSet(f, l) for f, l in arrs]))
        _close(pnet, jnet)


def test_master_advances_iteration_and_listeners():
    calls = []

    class Rec:
        def iteration_done(self, model, iteration):
            calls.append(iteration)

    net = _net()
    net.set_listeners(Rec())
    DistributedMultiLayer(net, ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=2)).fit(
        ListDataSetIterator(_batches(8)))
    assert net.iteration == 4
    assert calls == [2, 4]


def test_training_hooks_invoked():
    from deeplearning4j_tpu_torch.parallel.training_master import (
        ParameterAveragingTrainingWorker,
        TrainingHook,
    )

    events = []

    class Recorder(TrainingHook):
        def on_training_start(self, net):
            events.append("start")

        def on_training_end(self, net):
            events.append("end")

        def pre_update(self, ds, net):
            events.append(("pre", ptm.current_worker_id()))

        def post_update(self, ds, net):
            events.append("post")

    net = _net()
    worker = ParameterAveragingTrainingWorker(net)
    worker.add_hook(Recorder())
    ParameterAveragingTrainingMaster(
        num_workers=1, averaging_frequency=3, worker=worker
    ).execute_training(net, ListDataSetIterator(_batches(3)))
    assert events == ["start", ("pre", 0), "post", ("pre", 0), "post",
                      ("pre", 0), "post", "end"]
    assert ptm.current_worker_id() is None


def test_replicas_are_clones_on_the_nets_device_on_threads():
    """Each shard trains on a clone of the master net (its own tensors,
    the net's device) on a pool thread; the master's tensors are not
    touched until the average is set."""
    import threading

    seen = []

    class Spy(ptm.TrainingHook):
        def pre_update(self, ds, net):
            seen.append((threading.current_thread().name, net.device,
                         id(net)))

    net = _net()
    before = _np(net.params()).copy()
    worker = ptm.ParameterAveragingTrainingWorker(net)
    worker.add_hook(Spy())
    master = ParameterAveragingTrainingMaster(num_workers=2,
                                              averaging_frequency=1,
                                              worker=worker)
    ids = {id(net)}
    master._run_window(worker, [[b] for b in _batches(2)],
                       master.alive_workers(), __import__(
                           "concurrent.futures").futures.ThreadPoolExecutor(2))
    np.testing.assert_array_equal(_np(net.params()), before)
    assert len(seen) == 2 and all(d == net.device for _, d, _ in seen)
    assert not ids & {i for *_, i in seen}
    assert all(n != threading.current_thread().name for n, *_ in seen)


# ------------------------------------------------------- parameter server
def test_parameter_server_basic():
    ps = ParameterServer(np.zeros(4, np.float32))
    ps.push_update(np.ones(4, np.float32))
    ps.push_update(2 * np.ones(4, np.float32))
    np.testing.assert_allclose(ps.pull(), 3 * np.ones(4))
    assert ps.num_pushes == 2


def test_parameter_server_wrapper_trains():
    batches = _batches(12, seed=3)
    net = _net(lr=0.05)
    s0 = net.score(batches[0])
    psw = ParameterServerParallelWrapper(net, workers=3, sync_frequency=2)
    psw.fit(ListDataSetIterator(batches), epochs=3)
    assert psw.server.num_pushes > 0
    assert net.iteration == 36
    assert net.score(batches[0]) < s0


def test_parameter_server_single_worker_parity():
    """One worker, sync every batch: the PS path is sequential training,
    equal to the JAX package's."""
    jb, pb = _both(5, seed=4)
    jnet, pnet = _pair()
    JPSWrapper(jnet, workers=1, sync_frequency=1).fit(JList(jb))
    ParameterServerParallelWrapper(pnet, workers=1, sync_frequency=1).fit(
        ListDataSetIterator(pb))
    _close(pnet, jnet, atol=1e-5)
    assert pnet.iteration == jnet.iteration == 5


# ------------------------------------------------------------------- CLI
def test_cli_parser_and_factory():
    from deeplearning4j_tpu_torch.parallel.main import (
        _load_factory,
        build_parser,
    )

    args = build_parser().parse_args([
        "--model-path", "m.zip", "--data-factory", "a.b:make",
        "--output-path", "o.zip", "--mode", "averaging", "--workers", "4"])
    assert args.workers == 4 and args.mode == "averaging"
    assert args.device == "cuda"
    with pytest.raises(ValueError):
        _load_factory("no_colon_here")


@pytest.mark.parametrize("mode", ["averaging", "wrapper", "ps"])
def test_cli_end_to_end(tmp_path, monkeypatch, mode):
    """Save a model, run the CLI on the CPU in each mode, load the
    output: it trained, and in averaging mode it equals the JAX CLI's
    run from the same zip."""
    from deeplearning4j_tpu.parallel.main import run as jrun
    from deeplearning4j_tpu.util.serialization import (
        restore_multi_layer_network as jrestore,
    )
    from deeplearning4j_tpu.util.serialization import write_model as jwrite
    from deeplearning4j_tpu_torch.parallel.main import run
    from deeplearning4j_tpu_torch.util.serialization import restore_model

    jnet = JNet(_conf(JC))
    jnet.init()
    model_in = tmp_path / "in.zip"
    jwrite(jnet, model_in)
    arrs = _arrays(4, seed=5)
    mod = types.ModuleType("cli_test_factory_mod_torch")
    mod.make_iterator = lambda: ListDataSetIterator(
        [DataSet(f, l) for f, l in arrs])
    mod.make_jax_iterator = lambda: JList([JDataSet(f, l) for f, l in arrs])
    monkeypatch.setitem(sys.modules, "cli_test_factory_mod_torch", mod)
    argv = ["--model-path", str(model_in), "--mode", mode, "--workers", "2",
            "--avg-frequency", "2"]
    assert run(argv + ["--data-factory",
                       "cli_test_factory_mod_torch:make_iterator",
                       "--output-path", str(tmp_path / "out.zip"),
                       "--device", "cpu"]) == 0
    out = restore_model(tmp_path / "out.zip", device="cpu")
    assert not np.allclose(_np(out.params()), np.asarray(jnet.params()))
    if mode == "averaging":
        assert jrun(argv + ["--data-factory",
                            "cli_test_factory_mod_torch:make_jax_iterator",
                            "--output-path", str(tmp_path / "j.zip")]) == 0
        np.testing.assert_allclose(
            _np(out.params()),
            np.asarray(jrestore(tmp_path / "j.zip").params()),
            rtol=0, atol=ATOL)


def test_cli_routes_stats_to_a_remote_ui(tmp_path, monkeypatch):
    """`--ui-url` attaches a StatsListener behind the remote router: the
    UI server receives the run's reports."""
    from deeplearning4j_tpu_torch.parallel.main import run
    from deeplearning4j_tpu_torch.ui.server import UIServer
    from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
    from deeplearning4j_tpu_torch.util.serialization import write_model

    net = _net()
    write_model(net, tmp_path / "in.zip")
    mod = types.ModuleType("cli_test_ui_mod_torch")
    mod.make_iterator = lambda: ListDataSetIterator(_batches(4, seed=6))
    monkeypatch.setitem(sys.modules, "cli_test_ui_mod_torch", mod)
    storage = InMemoryStatsStorage()
    ui = UIServer(port=0)
    ui.attach(storage)
    try:
        assert run(["--model-path", str(tmp_path / "in.zip"),
                    "--data-factory", "cli_test_ui_mod_torch:make_iterator",
                    "--output-path", str(tmp_path / "out.zip"),
                    "--mode", "averaging", "--workers", "2",
                    "--avg-frequency", "1", "--device", "cpu",
                    "--ui-url", f"127.0.0.1:{ui.port}"]) == 0
    finally:
        ui.stop()
    assert storage.list_session_ids()


# ----------------------------------------------------------- repartition
def test_repartition_matches_jax():
    """balanced_partitions gives the JAX package's partitions (round
    robin, and BALANCED's seeded remainder), and the gate fires alike."""
    from deeplearning4j_tpu.parallel import repartition as jr
    from deeplearning4j_tpu_torch.parallel import repartition as pr

    items = list(range(10))
    for strat, jstrat in zip(pr.RepartitionStrategy, jr.RepartitionStrategy):
        parts = pr.balanced_partitions(items, 3, strat, seed=7)
        assert parts == jr.balanced_partitions(items, 3, jstrat, seed=7)
        assert sorted(len(p) for p in parts) == [3, 3, 4]
    assert pr.balanced_partitions(items, 3)[0] == [0, 3, 6, 9]
    for n, k in ((9, 3), (10, 3)):
        for rp, jrp in zip(pr.Repartition, jr.Repartition):
            assert pr.should_repartition(n, k, rp) == \
                jr.should_repartition(n, k, jrp)
    with pytest.raises(ValueError):
        pr.balanced_partitions(items, 0)


def test_repartition_never_still_trains():
    from deeplearning4j_tpu_torch.parallel.repartition import Repartition

    net = _net()
    master = ParameterAveragingTrainingMaster(num_workers=2,
                                              averaging_frequency=2)
    master.repartition = Repartition.NEVER
    before = _np(net.params()).copy()
    master.execute_training(net, ListDataSetIterator(_batches(5)))
    assert not np.allclose(before, _np(net.params()))


# ----------------------------------------------------------------- export
def test_export_staged_training_parity(tmp_path):
    """batch_and_export then train from paths equals training from the
    in-memory iterator; the files are read by either package."""
    from deeplearning4j_tpu.datasets.iterators import (
        FileDataSetIterator as JFiles,
    )
    from deeplearning4j_tpu_torch.parallel.export import batch_and_export

    batches = _batches(6)
    paths = batch_and_export(batches, tmp_path / "exported", batch_size=16)
    assert len(paths) == 6
    for ds, rt, jrt in zip(batches, FileDataSetIterator(tmp_path / "exported"),
                           JFiles(tmp_path / "exported")):
        np.testing.assert_array_equal(rt.features, ds.features)
        np.testing.assert_array_equal(jrt.labels, ds.labels)
    mem_net = _net()
    ParameterAveragingTrainingMaster(
        num_workers=1, averaging_frequency=3).execute_training(
        mem_net, ListDataSetIterator(batches))
    path_net = _net()
    ParameterAveragingTrainingMaster(
        num_workers=1, averaging_frequency=3).execute_training_paths(
        path_net, paths)
    np.testing.assert_array_equal(_np(path_net.params()),
                                  _np(mem_net.params()))


def test_batch_and_export_matches_jax_files(tmp_path):
    """Uneven batches re-cut to 16, 16, 6: the same files as the JAX
    package's export, array for array; masks (mixed) survive."""
    from deeplearning4j_tpu.parallel.export import (
        batch_and_export as jexport,
    )
    from deeplearning4j_tpu_torch.parallel.export import batch_and_export

    rng = np.random.RandomState(3)
    sizes = [10, 7, 16, 5]
    arrs = [(rng.randn(s, 5, 4).astype(np.float32),
             rng.randn(s, 5, 3).astype(np.float32),
             (rng.rand(s, 5) > 0.3).astype(np.float32) if i % 2 else None)
            for i, s in enumerate(sizes)]
    paths = batch_and_export([DataSet(f, l, m) for f, l, m in arrs],
                             tmp_path / "p", batch_size=16)
    jpaths = jexport([JDataSet(f, l, m) for f, l, m in arrs],
                     tmp_path / "j", batch_size=16)
    assert [DataSet.load(p).num_examples() for p in paths] == [16, 16, 6]
    for p, jp in zip(paths, jpaths):
        a, b = DataSet.load(p), JDataSet.load(jp)
        for f in ("features", "labels", "features_mask", "labels_mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


def test_batch_and_export_clears_stale_shards(tmp_path):
    from deeplearning4j_tpu_torch.parallel.export import batch_and_export

    d = tmp_path / "exp"
    batch_and_export(_batches(6), d, batch_size=16)
    paths = batch_and_export(_batches(2, seed=9), d, batch_size=16)
    assert len(paths) == 2
    assert len(FileDataSetIterator(d).paths) == 2


# ----------------------------------------- distributed inference surfaces
def test_distributed_evaluate_matches_jax():
    jb, pb = _both(7, batch=8, seed=3)
    jnet, pnet = _pair(seed=5)
    for j, p in zip(jb[:2], pb[:2]):
        jnet.fit(j)
        pnet.fit(p)
    local = pnet.evaluate(ListDataSetIterator(pb))
    dist = DistributedMultiLayer(
        pnet, ParameterAveragingTrainingMaster(num_workers=3)).evaluate(
        ListDataSetIterator(pb))
    jdist = jtm.DistributedMultiLayer(
        jnet, jtm.ParameterAveragingTrainingMaster(num_workers=3)).evaluate(
        JList(jb))
    np.testing.assert_array_equal(dist.confusion_matrix,
                                  local.confusion_matrix)
    np.testing.assert_array_equal(dist.confusion_matrix,
                                  jdist.confusion_matrix)
    assert dist.accuracy() == pytest.approx(jdist.accuracy())
    assert dist.f1() == pytest.approx(jdist.f1())


def test_distributed_calculate_score_matches_jax():
    jb, pb = _both(5, batch=8, seed=4)
    jnet, pnet = _pair(seed=6)
    dm = DistributedMultiLayer(
        pnet, ParameterAveragingTrainingMaster(num_workers=2))
    jdm = jtm.DistributedMultiLayer(
        jnet, jtm.ParameterAveragingTrainingMaster(num_workers=2))
    for avg in (True, False):
        assert dm.calculate_score(ListDataSetIterator(pb), average=avg) == \
            pytest.approx(jdm.calculate_score(JList(jb), average=avg),
                          rel=RTOL)
    local = float(np.mean([pnet.score(ds) for ds in pb]))
    assert dm.calculate_score(ListDataSetIterator(pb)) == \
        pytest.approx(local, rel=RTOL)
    assert dm.score(pb[0]) == pytest.approx(pnet.score(pb[0]), rel=RTOL)


def test_distributed_score_examples_preserves_order():
    jb, pb = _both(5, batch=6, seed=9)
    jnet, pnet = _pair(seed=10)
    dist = DistributedMultiLayer(
        pnet, ParameterAveragingTrainingMaster(num_workers=3)).score_examples(
        ListDataSetIterator(pb))
    jdist = jtm.DistributedMultiLayer(
        jnet, jtm.ParameterAveragingTrainingMaster(num_workers=3)
    ).score_examples(JList(jb))
    assert isinstance(dist, np.ndarray) and dist.shape == (30,)
    np.testing.assert_allclose(dist, np.asarray(jdist), rtol=1e-5)
    local = np.concatenate([_np(pnet.score_examples(ds)) for ds in pb])
    np.testing.assert_array_equal(dist, local)


def test_distributed_evaluate_caches_replica_clones(monkeypatch):
    """One clone per worker for the handle's life; after a fit the
    replicas read the trained weights (no re-clone)."""
    net = _net()
    dm = DistributedMultiLayer(net, ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=1))
    batches = _batches(6)
    clones = [0]
    orig = MultiLayerNetwork.clone

    def counting_clone(self):
        clones[0] += 1
        return orig(self)

    monkeypatch.setattr(MultiLayerNetwork, "clone", counting_clone)

    def local(data):
        return sum(net.score(ds) * ds.num_examples() for ds in data) \
            / sum(ds.num_examples() for ds in data)

    s1 = dm.calculate_score(ListDataSetIterator(batches))
    assert clones[0] == 2
    np.testing.assert_allclose(s1, local(batches), rtol=RTOL)
    dm.calculate_score(ListDataSetIterator(batches))
    assert clones[0] == 2
    dm.fit(ListDataSetIterator(batches))
    fit_clones = clones[0]
    s3 = dm.calculate_score(ListDataSetIterator(batches))
    assert clones[0] == fit_clones
    np.testing.assert_allclose(s3, local(batches), rtol=RTOL)
    assert abs(s3 - s1) > 1e-9


# ------------------------------------------------ early stopping (master)
def _es_config(E, held=None, epochs=4):
    kw = dict(epoch_termination_conditions=[
        E.MaxEpochsTerminationCondition(epochs)],
        model_saver=E.InMemoryModelSaver())
    if held is not None:
        kw["score_calculator"] = E.DataSetLossCalculator(held)
    return E.EarlyStoppingConfiguration(**kw)


def test_early_stopping_through_master_matches_jax():
    """EarlyStoppingDistributedTrainer(num_workers=1) terminates like the
    single-device trainer and like the JAX package's distributed one."""
    import deeplearning4j_tpu.earlystopping as JE
    import deeplearning4j_tpu_torch.earlystopping as PE
    from deeplearning4j_tpu.parallel.early_stopping import (
        EarlyStoppingDistributedTrainer as JESD,
    )
    from deeplearning4j_tpu_torch.parallel.early_stopping import (
        EarlyStoppingDistributedTrainer,
    )

    jtrain, ptrain = _both(4, batch=8, seed=11)
    jtest, ptest = _both(2, batch=8, seed=12)
    jnet, pnet = _pair(seed=13)
    ref = PE.EarlyStoppingTrainer(_es_config(PE, ListDataSetIterator(ptest)),
                                  pnet.clone(), ListDataSetIterator(ptrain))
    ref_result = ref.fit()
    dist = EarlyStoppingDistributedTrainer(
        _es_config(PE, ListDataSetIterator(ptest)), pnet,
        ListDataSetIterator(ptrain),
        ParameterAveragingTrainingMaster(num_workers=1,
                                         averaging_frequency=1)).fit()
    jres = JESD(_es_config(JE, JList(jtest)), jnet, JList(jtrain),
                jtm.ParameterAveragingTrainingMaster(
                    num_workers=1, averaging_frequency=1)).fit()
    for other in (ref_result, jres):
        assert dist.termination_reason.value == \
            other.termination_reason.value
        assert dist.total_epochs == other.total_epochs
        assert dist.best_model_epoch == other.best_model_epoch
        for e, s in other.score_vs_epoch.items():
            assert dist.score_vs_epoch[e] == pytest.approx(s, rel=RTOL)
    assert isinstance(dist.best_model, MultiLayerNetwork)


def test_early_stopping_through_master_multiworker():
    import deeplearning4j_tpu_torch.earlystopping as PE
    from deeplearning4j_tpu_torch.parallel.early_stopping import (
        EarlyStoppingDistributedTrainer,
    )

    result = EarlyStoppingDistributedTrainer(
        _es_config(PE, epochs=3), _net(seed=15),
        ListDataSetIterator(_batches(4, batch=8, seed=14)),
        ParameterAveragingTrainingMaster(num_workers=2,
                                         averaging_frequency=2)).fit()
    assert result.termination_reason == \
        PE.TerminationReason.EPOCH_TERMINATION_CONDITION
    assert result.total_epochs == 3
    assert np.isfinite(result.best_model_score)
