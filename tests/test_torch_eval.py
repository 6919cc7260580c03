"""The port's `eval/` held against the JAX package's on the CPU: the same
seeded numpy inputs (and the same values as torch tensors) through both
packages' `Evaluation`, `RegressionEvaluation`, `ROC`, `ROCMultiClass`
and `EvaluationTools`, and `MultiLayerNetwork.evaluate` of both packages
from one shared checkpoint zip. Tolerances: counts and confusion
matrices exact, float metrics to 1e-12, `stats()` and HTML text equal;
the networks' evaluations exact (their outputs agree to ~1e-6, far from
any argmax tie on these inputs).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.eval import evaluation as jeval  # noqa: E402
from deeplearning4j_tpu.eval import evaluation_tools as jtools  # noqa: E402
from deeplearning4j_tpu.eval import regression as jreg  # noqa: E402
from deeplearning4j_tpu.eval import roc as jroc  # noqa: E402
from deeplearning4j_tpu.nn import conf as jconf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.nn.updater import Updater as JUpdater  # noqa: E402
from deeplearning4j_tpu.ops.activations import (  # noqa: E402
    Activation as JAct,
)
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss  # noqa: E402
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.eval import evaluation as peval  # noqa: E402
from deeplearning4j_tpu_torch.eval import evaluation_tools as ptools  # noqa: E402
from deeplearning4j_tpu_torch.eval import regression as preg  # noqa: E402
from deeplearning4j_tpu_torch.eval import roc as proc  # noqa: E402
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


TOL = 1e-12
C = 5
METRICS = ("accuracy", "precision", "recall", "f1", "false_positive_rate",
           "false_negative_rate", "false_alarm_rate")


def _probs(rng, shape):
    z = rng.standard_normal(shape)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _same_eval(j, p):
    np.testing.assert_array_equal(p.confusion_matrix, j.confusion_matrix)
    for m in METRICS:
        np.testing.assert_allclose(getattr(p, m)(), getattr(j, m)(),
                                   rtol=TOL, atol=TOL, err_msg=m)
    n = j.num_classes
    for cls in range(n):
        for m in ("true_positives", "false_positives", "false_negatives",
                  "true_negatives"):
            assert getattr(p, m)(cls) == getattr(j, m)(cls), (m, cls)
        for m in ("precision", "recall", "f1"):
            np.testing.assert_allclose(getattr(p, m)(cls),
                                       getattr(j, m)(cls), rtol=TOL,
                                       atol=TOL)
    if j.top_n > 1:
        np.testing.assert_allclose(p.top_n_accuracy(), j.top_n_accuracy(),
                                   rtol=TOL, atol=TOL)
    assert p.stats() == j.stats()
    assert p.stats(suppress_warnings=True) == j.stats(suppress_warnings=True)


def _cases(seed):
    """name -> (labels, predictions, mask) of each input form."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, C, 40)
    ts_ids = rng.integers(0, C, (4, 7))
    mask = (rng.random((4, 7)) > 0.3).astype(np.float32)
    ts_sparse = ts_ids.copy()
    ts_sparse[mask == 0] = 99  # sentinel ids where masked are allowed
    return {
        "one-hot": (np.eye(C, dtype=np.float32)[ids], _probs(rng, (40, C)),
                    None),
        "sparse": (ids.astype(np.int32), _probs(rng, (40, C)), None),
        "time series one-hot + mask": (
            np.eye(C, dtype=np.float32)[ts_ids], _probs(rng, (4, 7, C)),
            mask),
        "time series sparse + mask": (ts_sparse.astype(np.int32),
                                      _probs(rng, (4, 7, C)), mask),
        "binary column": ((rng.random((30, 1)) > 0.5).astype(np.float32),
                          rng.random((30, 1)).astype(np.float32), None),
        "binary (N,)": ((rng.random(30) > 0.5).astype(np.float32),
                        rng.random(30).astype(np.float32), None),
    }


@pytest.mark.parametrize("case", list(_cases(0)))
@pytest.mark.parametrize("top_n", [1, 3])
def test_evaluation_matches_the_jax_package(case, top_n):
    j = jeval.Evaluation(top_n=top_n, record_meta=True)
    p = peval.Evaluation(top_n=top_n, record_meta=True)
    for seed in (0, 1):
        labels, preds, mask = _cases(seed)[case]
        j.eval(labels, preds, mask=mask)
        p.eval(labels, preds, mask=mask)
    _same_eval(j, p)
    assert p.get_prediction_errors() == [
        peval.Prediction(e.actual, e.predicted, e.example_index)
        for e in j.get_prediction_errors()]


@pytest.mark.parametrize("case", ["one-hot", "time series sparse + mask"])
def test_evaluation_takes_torch_tensors(case):
    labels, preds, mask = _cases(2)[case]
    j = jeval.Evaluation()
    j.eval(labels, preds, mask=mask)
    p = peval.Evaluation()
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    p.eval(as_t(labels), as_t(preds).to(torch.bfloat16).float(),
           mask=as_t(mask))
    p2 = peval.Evaluation()
    p2.eval(labels, torch.from_numpy(preds).to(torch.bfloat16).float()
            .numpy(), mask=mask)
    _same_eval(p2, p)


def test_merge_names_and_range_errors_match():
    names = [f"c{i}" for i in range(C)]
    js = [jeval.Evaluation(labels=names, top_n=2) for _ in range(2)]
    ps = [peval.Evaluation(labels=names, top_n=2) for _ in range(2)]
    for k, (j, p) in enumerate(zip(js, ps)):
        labels, preds, _ = _cases(10 + k)["one-hot"]
        j.eval(labels, preds)
        p.eval(labels, preds)
    jm, pm = jeval.Evaluation(), peval.Evaluation()
    for j, p in zip(js, ps):
        jm.merge(j)
        pm.merge(p)
    _same_eval(jm, pm)
    bad = np.array([0, C], np.int32)
    preds = _probs(np.random.default_rng(3), (2, C))
    with pytest.raises(ValueError) as je:
        jeval.Evaluation(num_classes=C).eval(bad, preds)
    with pytest.raises(ValueError) as pe:
        peval.Evaluation(num_classes=C).eval(bad, preds)
    assert str(pe.value) == str(je.value)


def test_regression_and_roc_match():
    rng = np.random.default_rng(4)
    y = rng.standard_normal((3, 6, 2)).astype(np.float32)
    yhat = (y + 0.3 * rng.standard_normal(y.shape)).astype(np.float32)
    mask = (rng.random((3, 6)) > 0.2).astype(np.float32)
    jr, pr = jreg.RegressionEvaluation(), preg.RegressionEvaluation()
    jr.eval(y, yhat, mask=mask)
    pr.eval(torch.from_numpy(y), torch.from_numpy(yhat), mask=mask)
    for m in ("mean_squared_error", "mean_absolute_error",
              "root_mean_squared_error", "relative_squared_error",
              "correlation_r2"):
        for col in (0, 1):
            np.testing.assert_allclose(getattr(pr, m)(col),
                                       getattr(jr, m)(col), rtol=TOL,
                                       atol=TOL)
    assert pr.stats() == jr.stats()
    lab = (rng.random(200) > 0.4).astype(np.float32)
    prob = np.clip(0.5 * lab + 0.7 * rng.random(200), 0, 1).astype(np.float32)
    jo, po = jroc.ROC(50), proc.ROC(50)
    jo.eval(lab, prob)
    po.eval(torch.from_numpy(lab), torch.from_numpy(prob))
    for m in ("calculate_auc", "calculate_auprc"):
        np.testing.assert_allclose(getattr(po, m)(), getattr(jo, m)(),
                                   rtol=TOL, atol=TOL)
    for a, b in zip(po.get_roc_curve() + po.get_precision_recall_curve(),
                    jo.get_roc_curve() + jo.get_precision_recall_curve()):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    labels, preds, _ = _cases(5)["one-hot"]
    jm, pm = jroc.ROCMultiClass(20), proc.ROCMultiClass(20)
    jm.eval(labels, preds)
    pm.eval(labels, preds)
    np.testing.assert_allclose(pm.calculate_average_auc(),
                               jm.calculate_average_auc(), rtol=TOL, atol=TOL)
    assert ptools.EvaluationTools.roc_chart_html(po) == \
        jtools.EvaluationTools.roc_chart_html(jo)
    je, pe = jeval.Evaluation(), peval.Evaluation()
    je.eval(labels, preds)
    pe.eval(labels, preds)
    assert ptools.EvaluationTools.evaluation_html(pe) == \
        jtools.EvaluationTools.evaluation_html(je)


# ---------------------------------------------------- network evaluate
V, H, B, T = 12, 16, 6, 9


def _char_rnn():
    return (jconf.NeuralNetConfiguration.Builder().seed(2).learning_rate(0.1)
            .updater(JUpdater.RMSPROP).list()
            .layer(jconf.GravesLSTM(n_in=V, n_out=H, activation=JAct.TANH))
            .layer(jconf.RnnOutputLayer(n_out=V, loss=JLoss.MCXENT,
                                        activation=JAct.SOFTMAX))
            .set_input_type(jconf.InputType.recurrent(V)).build())


def _mlp():
    return (jconf.NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .updater(JUpdater.ADAM).activation(JAct.TANH).list()
            .layer(jconf.DenseLayer(n_out=8))
            .layer(jconf.OutputLayer(n_out=4, loss=JLoss.MCXENT,
                                     activation=JAct.SOFTMAX))
            .set_input_type(jconf.InputType.feed_forward(5)).build())


def _net_data(model, seed):
    rng = np.random.default_rng(seed)
    if model == "mlp":
        x = rng.standard_normal((20, 5)).astype(np.float32)
        return x, np.eye(4, dtype=np.float32)[rng.integers(0, 4, 20)], None
    ids = rng.integers(0, V, (B, T + 1))
    mask = np.ones((B, T), np.float32)
    mask[1, 6:] = 0
    mask[4, 2:] = 0
    return (np.eye(V, dtype=np.float32)[ids[:, :-1]],
            ids[:, 1:].astype(np.int32), mask)


@pytest.mark.parametrize("model", ["mlp", "char-rnn"])
@pytest.mark.parametrize("top_n", [1, 2])
def test_network_evaluate_matches_from_a_shared_zip(model, top_n, tmp_path):
    jnet = JaxNet(_mlp() if model == "mlp" else _char_rnn())
    jnet.init()
    x, y, m = _net_data(model, 0)
    jnet.fit(JDataSet(x, y, labels_mask=m))
    path = tmp_path / "net.zip"
    jser.write_model(jnet, path)
    pnet = pser.restore_model(path, device="cpu")
    batches = [_net_data(model, s) for s in (1, 2)]
    jev = jnet.evaluate(iter([JDataSet(x, y, labels_mask=m)
                              for x, y, m in batches]), top_n=top_n)
    pev = pnet.evaluate(ListDataSetIterator([DataSet(x, y, labels_mask=m)
                                             for x, y, m in batches]),
                        top_n=top_n)
    _same_eval(jev, pev)
    one = pnet.evaluate(DataSet(*batches[0][:2], labels_mask=batches[0][2]),
                        labels=[f"k{i}" for i in range(pev.num_classes)])
    assert one.label_names[0] == "k0"
    assert one.confusion_matrix.sum() == (
        len(batches[0][0]) if model == "mlp" else int(batches[0][2].sum()))
