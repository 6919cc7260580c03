"""The port's health sentinel and guarded training step held against the
JAX package on the CPU.

- `HealthSentinel` fed the same (loss, grad_norm, committed) streams in
  both packages gives the same verdicts, events, counters and typed
  errors, step by step.
- Guarded fits from shared weights (`params_from_jax`) on the same
  batches, one of them poisoned: the same `[loss, grad_norm, ok]` health
  vectors (loss rtol 1e-5, grad_norm rtol 1e-5: both sum each leaf's
  squares in f32 and add the leaves in one order, but in their own
  reduction trees), the same skips and counters, parameters within
  ROADMAP's caveat tolerances (RMSPROP atol lr/1000, Adam atol lr/30).
- On the port alone, in f32: a committed guarded step is bit-identical
  to an unguarded step from the same state, a skipped one leaves
  parameters, optimizer state and layer state bit-identical, and the
  iteration advances; after an LR backoff the next step is bit-identical
  to an unguarded step at the reduced rate.
- `BatchQuarantine` records and `QuarantiningDataSetIterator` as in the
  JAX package, each package reading the other's records.
"""
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.nn import conf as jconf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.nn.updater import Updater as JUpdater  # noqa: E402
from deeplearning4j_tpu.optimize import health as jhealth  # noqa: E402
from deeplearning4j_tpu.ops.activations import (  # noqa: E402
    Activation as JAct,
)
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator,
    QuarantiningDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.optimize import health as phealth  # noqa: E402
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


# ------------------------------------------------------------- streams
def _stream(seed, n=40):
    """(loss, grad_norm, committed) triples: a noisy falling loss with
    spikes, NaN/Inf steps and runs of them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        loss = 2.0 * np.exp(-i / 30) + 0.05 * rng.standard_normal()
        gn = 1.0 + 0.1 * rng.standard_normal()
        r = rng.random()
        if r < 0.12:
            out.append((float("nan"), float("nan"), False))
        elif r < 0.17:
            out.append((float("inf"), 3.0, False))
        elif r < 0.25:
            out.append((loss * 50, gn, True))
        elif r < 0.3:
            out.append((loss, gn * 40, True))
        else:
            out.append((loss, gn, True))
    return out


def _fake_net(jax_side):
    """What `_backoff_lr` touches: layers with updater configurations
    and the global configuration, for either package."""
    mk = (lambda: types.SimpleNamespace(learning_rate=0.1,
                                        bias_learning_rate=0.2))
    layers = [types.SimpleNamespace(updater_cfg=mk()),
              types.SimpleNamespace(updater_cfg=None)]
    gc = types.SimpleNamespace(learning_rate=0.1)
    return types.SimpleNamespace(layers=layers, iteration=0,
                                 conf=types.SimpleNamespace(global_conf=gc))


def _drive(mod, stream, kw, use_vector):
    events = []
    s = mod.HealthSentinel(on_event=events.append, **kw)
    net = _fake_net(mod is jhealth)
    log = []
    for i, (loss, gn, committed) in enumerate(stream):
        net.iteration = i + 1
        try:
            if use_vector:
                ok = s.observe(net, np.array([loss, gn, float(committed)],
                                             np.float32))
            else:
                ok = s.observe_host(net, loss, gn, committed=committed)
            log.append((ok, s.last_verdict, s.last_step_skipped,
                        s.counters()))
        except (mod.TrainingDivergedError, mod.DivergenceRollback) as e:
            # the port's messages say "trainer" for the JAX package's
            # "driver"
            log.append((type(e).__name__,
                        str(e).replace("driver", "trainer"), s.counters()))
            if isinstance(e, mod.TrainingDivergedError):
                break
            s.on_rolled_back(net)
    lrs = (net.layers[0].updater_cfg.learning_rate,
           net.layers[0].updater_cfg.bias_learning_rate,
           net.conf.global_conf.learning_rate)
    return log, events, lrs


SENTINEL_KW = [
    {},
    {"skip_budget": 1, "backoff_budget": 1, "warmup_steps": 3},
    {"skip_budget": 2, "spike_factor": 5.0, "warmup_steps": 4,
     "lr_backoff_factor": 0.25, "backoff_budget": 3},
    {"skip_budget": 1, "backoff_budget": 0, "rollback_budget": 2,
     "rollback": True},
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", range(len(SENTINEL_KW)))
@pytest.mark.parametrize("use_vector", [False, True])
def test_sentinel_verdicts_match_on_the_same_streams(seed, kw, use_vector):
    kw = dict(SENTINEL_KW[kw])
    rollback = kw.pop("rollback", False)
    stream = _stream(seed)
    results = []
    for mod in (jhealth, phealth):
        if rollback:
            orig = mod.HealthSentinel.__init__

            def init(self, *a, _orig=orig, **k):
                _orig(self, *a, **k)
                self.rollback_available = True

            mod_kw = kw
            cls = type("Armed", (mod.HealthSentinel,), {"__init__": init})
            fake = types.SimpleNamespace(
                HealthSentinel=cls,
                TrainingDivergedError=mod.TrainingDivergedError,
                DivergenceRollback=mod.DivergenceRollback)
            results.append(_drive(fake, stream, mod_kw, use_vector))
        else:
            results.append(_drive(mod, stream, kw, use_vector))
    (jlog, jev, jlr), (plog, pev, plr) = results
    assert plog == jlog
    assert repr(pev) == repr(jev)  # NaN fields compare by text
    assert plr == jlr


def test_sentinel_rejects_bad_configurations_like_the_jax_package():
    for bad in ({"ewma_beta": 1.0}, {"spike_factor": 1.0},
                {"lr_backoff_factor": 1.5}, {"skip_budget": 0},
                {"backoff_budget": -1}):
        with pytest.raises(ValueError) as je:
            jhealth.HealthSentinel(**bad)
        with pytest.raises(ValueError) as pe:
            phealth.HealthSentinel(**bad)
        assert str(pe.value) == str(je.value)


# ------------------------------------------------------- guarded steps
V, H, B, T = 10, 16, 4, 9


def _conf(model):
    b = jconf.NeuralNetConfiguration.Builder().seed(4).learning_rate(0.1)
    if model.startswith("mlp"):
        act = JAct.IDENTITY if model == "mlp identity" else JAct.TANH
        return (b.updater(JUpdater.ADAM).activation(act).list()
                .layer(jconf.DenseLayer(n_out=12))
                .layer(jconf.OutputLayer(n_out=3, loss=JLoss.MCXENT,
                                         activation=JAct.SOFTMAX))
                .set_input_type(jconf.InputType.feed_forward(5)).build())
    b = (b.updater(JUpdater.RMSPROP).list()
         .layer(jconf.GravesLSTM(n_in=V, n_out=H, activation=JAct.TANH))
         .layer(jconf.RnnOutputLayer(n_out=V, loss=JLoss.MCXENT,
                                     activation=JAct.SOFTMAX))
         .set_input_type(jconf.InputType.recurrent(V)))
    if model == "char-rnn tbptt":
        b = b.t_bptt_forward_length(4)
    return b.build()


def _batches(model, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if model.startswith("mlp"):
            x = rng.standard_normal((8, 5)).astype(np.float32)
            y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        else:
            ids = rng.integers(0, V, (B, T + 1))
            x = np.eye(V, dtype=np.float32)[ids[:, :-1]]
            y = ids[:, 1:].astype(np.int32)
        out.append((x, y))
    return out


def _pair(model):
    jnet = JaxNet(_conf(model))
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    tree = lambda t: jax.tree.map(np.asarray, t)
    pnet.set_param_tree(pser.params_from_jax(pnet.conf, tree(jnet._params)))
    pnet.set_updater_state(pser.updater_state_from_jax(
        pnet.conf, tree(jnet._upd_state)))
    return jnet, pnet


def _recording(mod):
    class Recording(mod.HealthSentinel):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.vectors = []

        def observe(self, net, health):
            h = health.detach().cpu().numpy() if hasattr(health, "detach") \
                else np.asarray(health)
            self.vectors.append(np.asarray(h, np.float64))
            return super().observe(net, health)

    return Recording


def _state(net):
    return ([v.clone() for p in net._params for v in p.values()]
            + [t.clone() for u in net.get_updater_state()
               for st in u.values() for t in st.values()]
            + [v.clone() for st in net._layer_state for v in st.values()])


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("model", ["mlp", "char-rnn", "char-rnn tbptt"])
def test_guarded_fit_matches_the_jax_package(model):
    jnet, pnet = _pair(model)
    js, ps = _recording(jhealth)(), _recording(phealth)()
    jnet.set_health_sentinel(js)
    pnet.set_health_sentinel(ps)
    batches = _batches(model, 4, seed=1)
    x, y = batches[1]
    x = x.copy()
    x[1, ..., 2] = np.nan
    batches[1] = (x, y)
    for x, y in batches:
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    assert pnet.iteration == jnet.iteration
    assert ps.counters() == js.counters()
    assert ps.counters()["skips"] >= 1
    assert len(ps.vectors) == len(js.vectors)
    for p, j in zip(ps.vectors, js.vectors):
        assert (p[2] >= 0.5) == (j[2] >= 0.5)
        if j[2] >= 0.5:
            np.testing.assert_allclose(p[:2], j[:2], rtol=1e-5)
        else:
            assert not np.isfinite(p[:2]).all()
    atol = 0.1 / 30 if model == "mlp" else 1e-4
    for a, b in zip(jnet._params, pnet._params):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=1e-5, atol=atol, err_msg=k)


@pytest.mark.parametrize("model,poison", [("char-rnn", "nan"),
                                          ("char-rnn", "inf"),
                                          ("mlp identity", "overflow")])
def test_guarded_skip_and_commit_are_bit_identical(model, poison):
    """Commit, skip, commit; the overflow case has a finite loss and
    finite gradients whose squared norm overflows f32 (identity layers,
    inputs x 1e30), which the guard counts as non-finite, as the JAX
    package's does."""
    _, net = _pair(model)
    sentinel = phealth.HealthSentinel()
    net.set_health_sentinel(sentinel)
    (x0, y0), (x1, y1), (x2, y2) = _batches(model, 3, seed=2)
    ref = net.clone()
    net.fit(DataSet(x0, y0))
    ref.fit(DataSet(x0, y0))
    assert _equal(_state(ref), _state(net))
    bad = x1.copy()
    if poison == "nan":
        bad[2, 3, 4] = np.nan
    elif poison == "inf":
        bad[0, 0, 0] = np.inf
    else:
        bad = bad * np.float32(1e30)
        loss, grads, _ = net._loss_and_grads(*net._batch_arrays(
            DataSet(bad, y1)))
        assert torch.isfinite(loss) and all(
            torch.isfinite(g).all() for d in grads for g in d.values())
        assert net._health(loss, grads)[2] == 0
    before = _state(net)
    net.fit(DataSet(bad, y1))
    assert _equal(before, _state(net))
    assert net.iteration == 2 and sentinel.counters()["skips"] == 1
    assert sentinel.last_step_skipped
    ref = net.clone()
    net.fit(DataSet(x2, y2))
    ref.fit(DataSet(x2, y2))
    assert _equal(_state(ref), _state(net))
    assert net.iteration == ref.iteration == 3
    assert net.get_health_sentinel() is sentinel
    assert ref.get_health_sentinel() is None


def test_a_skipped_tbptt_window_keeps_the_carries():
    """Inside truncated BPTT the guard decides per window: a poisoned
    window applies no update and carries the (h, c) it started with."""
    _, net = _pair("char-rnn tbptt")
    net.set_health_sentinel(phealth.HealthSentinel())
    (x, y), = _batches("char-rnn tbptt", 1, seed=3)
    bad = x.copy()
    bad[:, 5] = np.nan  # the second window of 4
    seen = []
    orig = net._apply_updates

    def spy(grads, new_state):
        seen.append(net.iteration)
        orig(grads, new_state)

    net._apply_updates = spy
    net.fit(DataSet(bad, y))
    assert seen == [0, 2]
    assert net.iteration == 3
    assert net.get_health_sentinel().counters()["skips"] == 1


def test_lr_backoff_then_the_next_step_runs_at_the_reduced_rate():
    jnet, pnet = _pair("char-rnn")
    kw = {"skip_budget": 1, "backoff_budget": 2}
    js, ps = jhealth.HealthSentinel(**kw), phealth.HealthSentinel(**kw)
    jnet.set_health_sentinel(js)
    pnet.set_health_sentinel(ps)
    (x0, y0), (x1, y1) = _batches("char-rnn", 2, seed=4)
    bad = x0.copy()
    bad[0, 0, 0] = np.nan
    jnet.fit(JDataSet(bad, y0))
    pnet.fit(DataSet(bad, y0))
    assert ps.counters() == js.counters()
    assert ps.counters()["backoffs"] == 1 and ps.lr_scale == 0.5
    for a, b in zip(jnet.layers, pnet.layers):
        if a.updater_cfg is not None:
            assert b.updater_cfg.learning_rate == a.updater_cfg.learning_rate \
                == 0.05
    # an unguarded network built at the reduced rate, from the same state
    ref = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(pnet.conf.to_json()), device="cpu")
    ref.set_param_tree(pnet._params)
    ref.set_updater_state(pnet.get_updater_state())
    ref.iteration = pnet.iteration
    assert ref.layers[0].updater_cfg.learning_rate == 0.05
    jnet.fit(JDataSet(x1, y1))
    pnet.fit(DataSet(x1, y1))
    ref.fit(DataSet(x1, y1))
    assert _equal(_state(ref)[:4], _state(pnet)[:4])
    for a, b in zip(jnet._params, pnet._params):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=1e-5, atol=1e-4, err_msg=k)


def test_the_ladder_ends_in_the_same_typed_error():
    jnet, pnet = _pair("mlp")
    kw = {"skip_budget": 1, "backoff_budget": 1}
    jnet.set_health_sentinel(jhealth.HealthSentinel(**kw))
    pnet.set_health_sentinel(phealth.HealthSentinel(**kw))
    (x, y), = _batches("mlp", 1)
    x = x.copy()
    x[0, 0] = np.nan
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    with pytest.raises(jhealth.TrainingDivergedError) as je:
        jnet.fit(JDataSet(x, y))
    with pytest.raises(phealth.TrainingDivergedError) as pe:
        pnet.fit(DataSet(x, y))
    # the same counts in the message; the port says "trainer" for the
    # JAX package's "driver"
    assert str(pe.value) == str(je.value).replace("driver", "trainer")
    assert pnet.iteration == jnet.iteration == 2


# ----------------------------------------------------------- quarantine
def test_non_finite_reasons_match():
    a = np.array([[1.0, np.nan], [np.inf, 2.0]], np.float32)
    for arr in (a, np.arange(4), np.ones(3, np.float32)):
        assert phealth.non_finite_array_reason(arr, "x") == \
            jhealth.non_finite_array_reason(arr, "x")
    assert phealth.non_finite_array_reason(torch.from_numpy(a), "x") == \
        jhealth.non_finite_array_reason(a, "x")
    assert phealth.non_finite_array_reason(torch.arange(3)) is None
    ds = (a, np.ones((2, 2), np.float32))
    assert phealth.non_finite_batch_reason(DataSet(*ds)) == \
        jhealth.non_finite_batch_reason(JDataSet(*ds))
    assert phealth.non_finite_batch_reason(
        DataSet(np.ones(2), labels_mask=np.array([np.nan]))) == \
        "labels_mask contain 1 non-finite value(s)"


def test_quarantine_records_read_in_both_packages(tmp_path):
    q = phealth.BatchQuarantine(tmp_path, max_records=2)
    x = np.ones((2, 3), np.float32)
    x[1, 1] = np.nan
    q.quarantine(DataSet(x, np.arange(2)), "bad", {"stream_position": 5})
    ds, meta = jhealth.BatchQuarantine(tmp_path).load(0)
    np.testing.assert_array_equal(ds.features, x)
    assert meta["reason"] == "bad" and meta["provenance"] == \
        {"stream_position": 5}
    jhealth.BatchQuarantine(tmp_path, max_records=2).quarantine(
        JDataSet(x), "again")
    again = phealth.BatchQuarantine(tmp_path, max_records=2)
    assert len(again) == 2
    ds, meta = again.load(1)
    assert meta["reason"] == "again" and ds.labels is None
    with pytest.raises(phealth.QuarantineFullError):
        again.quarantine(DataSet(x), "full")


def test_quarantining_iterator_screens_the_fit_loop(tmp_path):
    _, net = _pair("mlp")
    batches = _batches("mlp", 4, seed=5)
    x = batches[2][0].copy()
    x[0, 0] = np.nan
    batches[2] = (x, batches[2][1])
    it = QuarantiningDataSetIterator(
        ListDataSetIterator([DataSet(x, y) for x, y in batches]),
        tmp_path / "q")
    net.fit(it, epochs=2)
    assert net.iteration == 6 and it.quarantined == 2
    assert len(it.quarantine) == 2
    _, meta = it.quarantine.load(0)
    assert meta["provenance"] == {"stream_position": 2, "stage": "iterator"}
    assert np.isfinite(net.score_value)
