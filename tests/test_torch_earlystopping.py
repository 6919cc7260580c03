"""The port's early stopping (`earlystopping/`) held against the JAX
package on the CPU at small size (4 features, 8 hidden units, 3 classes),
for both containers: a `MultiLayerNetwork` and the same stack as a
`ComputationGraph`. The same blobs, made with numpy from a seed, go
through both packages' trainers from the same initial weights
(`params_from_jax`); the held-out scores per epoch agree within a
relative 1e-5 and the termination reason, details, epochs and best epoch
are equal. The savers' zips cross between the packages.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu import earlystopping as JE  # noqa: E402
from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet,
)
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402
from deeplearning4j_tpu_torch import earlystopping as PE  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: E402
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.util import serialization as pser  # noqa: E402
from deeplearning4j_tpu_torch.util.checkpoint_store import (  # noqa: E402
    CheckpointCorruptError,
    verify_manifest,
)

TOL = 1e-5
CONTAINERS = ("multilayer", "graph")


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


def _blobs(n=90, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.asarray([[0, 0, 2, 2], [2, 2, 0, 0], [-2, 2, -2, 2]],
                         np.float32)
    X = np.concatenate([centers[c] + 0.3 * rng.normal(size=(n // 3, 4))
                        for c in range(3)]).astype(np.float32)
    y = np.concatenate([np.full(n // 3, c) for c in range(3)])
    idx = rng.permutation(n)
    return X[idx], np.eye(3, dtype=np.float32)[y][idx]


def _iterators(seed=0, batch=30, poison=None):
    """(JAX iterator, port iterator) over the same batches; `poison`
    inserts a NaN batch at that index."""
    X, y = _blobs(seed=seed)
    parts = [(X[i:i + batch], y[i:i + batch]) for i in range(0, len(X), batch)]
    if poison is not None:
        parts.insert(poison, (np.full_like(parts[0][0], np.nan), parts[0][1]))
    return (JListIterator([JDataSet(a, b) for a, b in parts]),
            ListDataSetIterator([DataSet(a, b) for a, b in parts]))


def _conf(C, container, lr, updater="sgd"):
    b = (C.NeuralNetConfiguration.Builder().seed(12345).learning_rate(lr)
         .updater(updater).activation("tanh"))
    if container == "multilayer":
        return (b.list().layer(C.DenseLayer(n_out=8))
                .layer(C.OutputLayer(n_out=3, loss="mcxent",
                                     activation="softmax"))
                .set_input_type(C.InputType.feed_forward(4)).build())
    return (b.graph_builder().add_inputs("in")
            .add_layer("d", C.DenseLayer(n_out=8), "in")
            .add_layer("out", C.OutputLayer(n_out=3, loss="mcxent",
                                            activation="softmax"), "d")
            .set_outputs("out")
            .set_input_types(C.InputType.feed_forward(4)).build())


def _pair(container, lr=0.3):
    """(JAX network, port network on the CPU) with the same weights."""
    jconf, pconf = _conf(JC, container, lr), _conf(PC, container, lr)
    if container == "multilayer":
        jnet, pnet = JNet(jconf), MultiLayerNetwork(pconf, device="cpu")
    else:
        jnet, pnet = JGraph(jconf), ComputationGraph(pconf, device="cpu")
    jnet.init()
    pnet.set_param_tree(pser.params_from_jax(pconf, jnet._params))
    return jnet, pnet


def _fit_both(container, build_cfg, lr=0.3, poison=None):
    """Run the trainer of each package on its half of the pair; the
    `build_cfg` gets (the package's earlystopping module, its held-out
    iterator)."""
    jnet, pnet = _pair(container, lr)
    jtrain, ptrain = _iterators(poison=poison)
    jheld, pheld = _iterators(seed=1)
    jres = JE.EarlyStoppingTrainer(build_cfg(JE, jheld), jnet, jtrain).fit()
    pres = PE.EarlyStoppingTrainer(build_cfg(PE, pheld), pnet, ptrain).fit()
    return jres, pres, pnet


def _same_result(jres, pres):
    assert pres.termination_reason.value == jres.termination_reason.value
    assert pres.termination_details == jres.termination_details
    assert pres.total_epochs == jres.total_epochs
    assert pres.best_model_epoch == jres.best_model_epoch
    assert sorted(pres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, s in jres.score_vs_epoch.items():
        assert pres.score_vs_epoch[e] == pytest.approx(s, rel=TOL), e


@pytest.mark.parametrize("container", CONTAINERS)
def test_max_epochs_termination(container):
    def cfg(E, held):
        return (E.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    E.MaxEpochsTerminationCondition(5))
                .score_calculator(E.DataSetLossCalculator(held))
                .model_saver(E.InMemoryModelSaver()).build())

    jres, pres, _ = _fit_both(container, cfg)
    _same_result(jres, pres)
    assert pres.termination_reason == PE.TerminationReason \
        .EPOCH_TERMINATION_CONDITION
    assert pres.total_epochs == 5 and "MaxEpochs" in pres.termination_details
    assert pres.best_model is not None and len(pres.score_vs_epoch) == 5
    assert pres.best_model_score < list(pres.score_vs_epoch.values())[0]


@pytest.mark.parametrize("container", CONTAINERS)
def test_score_improvement_termination(container):
    def cfg(E, held):
        return (E.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    E.MaxEpochsTerminationCondition(50),
                    E.ScoreImprovementEpochTerminationCondition(2))
                .score_calculator(E.DataSetLossCalculator(held)).build())

    jres, pres, _ = _fit_both(container, cfg, lr=0.0)  # never improves
    _same_result(jres, pres)
    assert "ScoreImprovement" in pres.termination_details
    assert pres.total_epochs <= 5


@pytest.mark.parametrize("container", CONTAINERS)
def test_max_score_iteration_termination(container):
    def cfg(E, held):
        return (E.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    E.MaxEpochsTerminationCondition(100))
                .iteration_termination_conditions(
                    E.MaxScoreIterationTerminationCondition(20.0),
                    E.InvalidScoreIterationTerminationCondition()).build())

    jres, pres, _ = _fit_both(container, cfg, lr=1e4)  # diverges fast
    assert pres.termination_reason == PE.TerminationReason \
        .ITERATION_TERMINATION_CONDITION
    assert pres.termination_reason.value == jres.termination_reason.value
    assert pres.total_epochs == jres.total_epochs


def test_max_time_termination():
    _, pnet = _pair("multilayer")
    cfg = (PE.EarlyStoppingConfiguration.Builder()
           .epoch_termination_conditions(
               PE.MaxEpochsTerminationCondition(100000))
           .iteration_termination_conditions(
               PE.MaxTimeIterationTerminationCondition(0.5)).build())
    result = PE.EarlyStoppingTrainer(cfg, pnet, _iterators()[1]).fit()
    assert result.termination_reason == PE.TerminationReason \
        .ITERATION_TERMINATION_CONDITION
    assert "MaxTime" in result.termination_details


@pytest.mark.parametrize("container", CONTAINERS)
def test_local_file_saver_roundtrip(tmp_path, container):
    """The best and latest zips are written, the best restores to the
    weights the result holds, and each package restores the other's
    zips with the same parameters."""
    def cfg(E, held):
        d = tmp_path / E.__name__.split(".")[0]
        return (E.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    E.MaxEpochsTerminationCondition(3))
                .score_calculator(E.DataSetLossCalculator(held))
                .model_saver(E.LocalFileModelSaver(d)).save_last_model()
                .build())

    jres, pres, _ = _fit_both(container, cfg)
    _same_result(jres, pres)
    pdir = tmp_path / "deeplearning4j_tpu_torch"
    jdir = tmp_path / "deeplearning4j_tpu"
    assert (pdir / "bestModel.bin").exists()
    assert (pdir / "latestModel.bin").exists()
    best = pres.best_model
    assert best.device.type == "cpu"
    torch.testing.assert_close(
        best.params(), PE.LocalFileModelSaver(pdir, device="cpu")
        .get_best_model().params(), rtol=0, atol=0)
    x = np.zeros((2, 4), np.float32)
    out = best.output(x)
    assert (out[0] if isinstance(out, list) else out).shape == (2, 3)
    # the zips cross: the JAX package restores the port's and back
    jback = jser.restore_model(pdir / "bestModel.bin")
    np.testing.assert_array_equal(np.asarray(jback.params()),
                                  best.params().numpy())
    pback = pser.restore_model(jdir / "bestModel.bin", device="cpu")
    np.testing.assert_allclose(pback.params().numpy(),
                               np.asarray(jres.best_model.params()),
                               rtol=0, atol=0)
    np.testing.assert_allclose(pback.params().numpy(), best.params().numpy(),
                               rtol=TOL, atol=TOL)


def test_local_file_saver_truncated_file_raises_typed_error(tmp_path):
    """A truncated latestModel.bin is the typed CheckpointCorruptError;
    the untouched best model still verifies and loads."""
    saver = PE.LocalFileModelSaver(tmp_path)
    _, net = _pair("multilayer")
    net.fit(_iterators()[1])
    saver.save_best_model(net, 0.5)
    saver.save_latest_model(net, 0.5)
    latest = tmp_path / "latestModel.bin"
    latest.write_bytes(latest.read_bytes()[: latest.stat().st_size // 2])
    with pytest.raises(CheckpointCorruptError):
        saver.get_latest_model()
    torch.testing.assert_close(saver.get_best_model().params(), net.params(),
                               rtol=0, atol=0)


def test_local_file_saver_writes_manifest_sidecars(tmp_path):
    saver = PE.LocalFileModelSaver(tmp_path)
    _, net = _pair("multilayer")
    net.fit(_iterators()[1])
    saver.save_best_model(net, 0.5)
    assert (tmp_path / "bestModel.bin.manifest.json").exists()
    net.fit(_iterators()[1])
    saver.save_best_model(net, 0.4)  # the overwrite keeps the sidecar true
    verify_manifest(tmp_path / "bestModel.bin")
    assert saver.get_best_model() is not None


def test_local_file_saver_missing_files_still_return_none(tmp_path):
    saver = PE.LocalFileModelSaver(tmp_path)
    assert saver.get_best_model() is None
    assert saver.get_latest_model() is None


_SCORES = (float("nan"), float("inf"), float("-inf"), 1e308 * 10,
           -1e308 * 10, 0.0, 1e308, -1e308, 20.0, 20.0 + 1e-6)


@pytest.mark.parametrize("name,args", [
    ("InvalidScoreIterationTerminationCondition", ()),
    ("MaxScoreIterationTerminationCondition", (20.0,)),
])
def test_iteration_conditions_on_every_non_finite_flavor(name, args):
    """NaN, both infinities, overflow and huge finite scores get the
    JAX package's verdict from each iteration condition."""
    jc, pc = getattr(JE, name)(*args), getattr(PE, name)(*args)
    assert [pc.terminate(s) for s in _SCORES] == \
        [jc.terminate(s) for s in _SCORES]
    assert str(pc) == str(jc)


def test_epoch_conditions_match_the_jax_package():
    seq = [1.0, 0.9, 0.95, 0.91, 0.92, 0.5, 0.6, 0.7]
    for name, args in (("MaxEpochsTerminationCondition", (4,)),
                       ("BestScoreEpochTerminationCondition", (0.6,)),
                       ("ScoreImprovementEpochTerminationCondition", (1, 0.02))):
        jc, pc = getattr(JE, name)(*args), getattr(PE, name)(*args)
        jc.initialize()
        pc.initialize()
        assert [pc.terminate(e, s) for e, s in enumerate(seq)] == \
            [jc.terminate(e, s) for e, s in enumerate(seq)], name
        assert str(pc) == str(jc)
    with pytest.raises(ValueError):
        PE.MaxEpochsTerminationCondition(0)


@pytest.mark.parametrize("container", CONTAINERS)
def test_nan_loss_triggers_invalid_score_termination(container):
    """A NaN batch drives the score non-finite and InvalidScore aborts
    the fit mid-epoch, in both packages."""
    def cfg(E, held):
        return (E.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    E.MaxEpochsTerminationCondition(100))
                .iteration_termination_conditions(
                    E.InvalidScoreIterationTerminationCondition()).build())

    jres, pres, _ = _fit_both(container, cfg, poison=1)
    assert pres.termination_reason == PE.TerminationReason \
        .ITERATION_TERMINATION_CONDITION
    assert "InvalidScore" in pres.termination_details
    assert pres.total_epochs == jres.total_epochs == 0


@pytest.mark.parametrize("container", CONTAINERS)
def test_score_conditions_advance_only_on_evaluated_epochs(container):
    """With `evaluate_every_n_epochs(2)` the held-out score is taken on
    epochs 0, 2, 4: only those enter the score stream, and the
    improvement condition counts only them; MaxEpochs counts every
    epoch."""
    def cfg(E, held):
        return (E.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    E.MaxEpochsTerminationCondition(6),
                    E.ScoreImprovementEpochTerminationCondition(1))
                .score_calculator(E.DataSetLossCalculator(held))
                .evaluate_every_n_epochs(2).build())

    jres, pres, _ = _fit_both(container, cfg, lr=0.0)
    _same_result(jres, pres)
    assert sorted(pres.score_vs_epoch) == [0, 2, 4]
    assert pres.total_epochs == 5  # stalls at epochs 2 and 4 of 0, 2, 4


def test_listeners_are_restored_on_every_exit(tmp_path):
    """The caller's listeners are back after a normal stop, an
    iteration abort and a failed run (TerminationReason.ERROR)."""
    _, net = _pair("multilayer", lr=1e4)
    mine = CollectScoresIterationListener()
    net.set_listeners(mine)

    class Broken(PE.score_calc.ScoreCalculator):
        def calculate_score(self, net):
            raise RuntimeError("held-out set unreadable")

    cfgs = [
        (PE.EarlyStoppingConfiguration.Builder()
         .epoch_termination_conditions(PE.MaxEpochsTerminationCondition(1))
         .build(), PE.TerminationReason.EPOCH_TERMINATION_CONDITION),
        (PE.EarlyStoppingConfiguration.Builder()
         .epoch_termination_conditions(PE.MaxEpochsTerminationCondition(50))
         .iteration_termination_conditions(
             PE.MaxScoreIterationTerminationCondition(20.0),
             PE.InvalidScoreIterationTerminationCondition()).build(),
         PE.TerminationReason.ITERATION_TERMINATION_CONDITION),
        (PE.EarlyStoppingConfiguration.Builder()
         .epoch_termination_conditions(PE.MaxEpochsTerminationCondition(3))
         .score_calculator(Broken()).build(), PE.TerminationReason.ERROR),
    ]
    for cfg, reason in cfgs:
        res = PE.EarlyStoppingTrainer(cfg, net, _iterators()[1]).fit()
        assert res.termination_reason == reason
        assert net.listeners == [mine]
    assert "held-out set unreadable" in res.termination_details
    assert len(mine.scores) > 0


def test_graph_trainer_alias_and_in_memory_saver():
    assert PE.EarlyStoppingGraphTrainer is PE.EarlyStoppingTrainer
    _, net = _pair("graph")
    saver = PE.InMemoryModelSaver()
    saver.save_best_model(net, 1.0)
    saver.save_latest_model(net, 1.0)
    assert saver.get_best_model() is not net
    torch.testing.assert_close(saver.get_latest_model().params(),
                               net.params(), rtol=0, atol=0)


@pytest.mark.parametrize("container", CONTAINERS)
def test_best_model_of_a_bf16_run_computes_in_f32(tmp_path, container):
    """A zip records no compute dtype, so the best model of an early
    stopping run with bf16 compute loads computing in f32 in both
    packages: its `compute_dtype` is None, and each best zip scores the
    held-out set the same in either package to f32 tolerance (the port
    once gave the loaded model the bf16 compute of the run, which moved
    its score by bf16 rounding)."""
    import jax.numpy as jnp

    jconf, pconf = _conf(JC, container, 0.3), _conf(PC, container, 0.3)
    if container == "multilayer":
        jnet = JNet(jconf, compute_dtype=jnp.bfloat16)
        pnet = MultiLayerNetwork(pconf, compute_dtype=torch.bfloat16,
                                 device="cpu")
    else:
        jnet = JGraph(jconf, compute_dtype=jnp.bfloat16)
        pnet = ComputationGraph(pconf, compute_dtype=torch.bfloat16,
                                device="cpu")
    jnet.init()
    pnet.set_param_tree(pser.params_from_jax(pconf, jnet._params))
    jtrain, ptrain = _iterators()
    jheld, pheld = _iterators(seed=1)

    def cfg(E, held):
        return (E.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    E.MaxEpochsTerminationCondition(2))
                .score_calculator(E.DataSetLossCalculator(held))
                .model_saver(E.LocalFileModelSaver(
                    tmp_path / E.__name__.split(".")[0]))
                .build())

    jres = JE.EarlyStoppingTrainer(cfg(JE, jheld), jnet, jtrain).fit()
    pres = PE.EarlyStoppingTrainer(cfg(PE, pheld), pnet, ptrain).fit()
    assert pres.best_model.compute_dtype is None
    assert jres.best_model.compute_dtype is None
    X, y = _blobs(seed=1)
    for pkg in ("deeplearning4j_tpu_torch", "deeplearning4j_tpu"):
        path = tmp_path / pkg / "bestModel.bin"
        jbest = JE.LocalFileModelSaver(tmp_path / pkg)._load(path)
        pbest = PE.LocalFileModelSaver(tmp_path / pkg, device="cpu")._load(
            path)
        assert pbest.compute_dtype is None
        jscore, pscore = jbest.score(JDataSet(X, y)), \
            pbest.score(DataSet(X, y))
        assert pscore == pytest.approx(float(jscore), rel=1e-6, abs=1e-6)
