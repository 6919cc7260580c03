"""The port's profiler hooks (`profiler.py`, on `torch.profiler`) and
determinism check (`util.determinism.assert_deterministic`) on the CPU at
small size (a 4-8-2 dense network), beside the JAX package's: the
listener's summary keys and iteration count, a Chrome trace written over
an iteration window and over a with-block, a named host range in the
trace, and the bit-exact determinism verdict (with active dropout) in
both packages, with the same error text when training is not
deterministic.
"""
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu import profiler as jprof  # noqa: E402
from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet,
)
from deeplearning4j_tpu.util import determinism as jdet  # noqa: E402
from deeplearning4j_tpu_torch import profiler as pprof  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.util import determinism as pdet  # noqa: E402


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


def _conf(C, seed=1, drop=None):
    b = C.NeuralNetConfiguration.Builder().seed(seed).learning_rate(0.1)
    if drop:
        b = b.drop_out(drop)
    return (b.list().layer(C.DenseLayer(n_in=4, n_out=8))
            .layer(C.OutputLayer(n_in=8, n_out=2, dropout=0.0,
                                 activation="softmax")).build())


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]


def test_profiler_listener():
    """Six fits: five intervals (the first iteration only arms the
    timer), the JAX package's summary keys, and reset empties it."""
    out = {}
    for name, C, Net, DS, prof_mod, kw in (
            ("jax", JC, JNet, JDataSet, jprof, {}),
            ("port", PC, MultiLayerNetwork, DataSet, pprof,
             {"device": "cpu"})):
        net = Net(_conf(C), **kw)
        net.init()
        prof = prof_mod.ProfilerListener(sync=True)
        net.set_listeners(prof)
        x, y = _data()
        for _ in range(6):
            net.fit(DS(x, y))
        out[name] = prof.summary()
        prof.reset()
        assert prof.summary() == {}
    s = out["port"]
    assert set(s) == set(out["jax"])
    assert s["iterations"] == out["jax"]["iterations"] == 5
    assert s["mean_ms"] > 0 and s["p99_ms"] >= s["p50_ms"]


def test_profiler_listener_waits_only_for_the_card(monkeypatch):
    """`sync=True` calls `torch.cuda.synchronize` for a model on the card
    and nothing for one on the CPU."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))

    class Model:
        device = torch.device("cpu")

    prof = pprof.ProfilerListener(sync=True)
    prof.iteration_done(Model(), 0)
    assert calls == []
    Model.device = torch.device("cuda", 0)
    prof.iteration_done(Model(), 1)
    assert calls == [torch.device("cuda", 0)]
    assert prof.summary()["iterations"] == 1


def test_xla_trace_listener(tmp_path):
    """A trace over iterations [2, 4) is exported as a Chrome trace into
    the log dir; training past the window starts no second one."""
    net = MultiLayerNetwork(_conf(PC), device="cpu")
    tracer = pprof.XlaTraceListener(str(tmp_path), start_iteration=2,
                                    num_iterations=2)
    net.set_listeners(tracer)
    x, y = _data(32)
    for _ in range(8):
        net.fit(DataSet(x, y))
    tracer.stop()
    assert tracer.completed
    traces = list(tmp_path.glob("trace-*.json"))
    assert traces == [tmp_path / tracer.trace_path.split("/")[-1]]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_trace_capture_and_annotation(tmp_path):
    """`trace_capture` writes a trace over its block, holding the host
    range `trace_annotation` names; the profiler stops even when the
    block raises."""
    with pprof.trace_capture(str(tmp_path / "ok")):
        with pprof.trace_annotation("serve:prefill"):
            torch.ones(8).sum()
    (path,) = (tmp_path / "ok").glob("trace-*.json")
    names = {e.get("name") for e in
             json.loads(path.read_text())["traceEvents"]}
    assert "serve:prefill" in names
    with pytest.raises(RuntimeError, match="boom"):
        with pprof.trace_capture(str(tmp_path / "raised")):
            raise RuntimeError("boom")
    assert list((tmp_path / "raised").glob("trace-*.json"))
    with torch.profiler.profile() as prof:  # nothing left armed
        torch.ones(2).sum()
    assert prof.events() is not None


def test_assert_deterministic():
    """Dropout is active (its keys come from the seed and the iteration
    counter) and training must still be bit-deterministic, in both
    packages."""
    rng = np.random.default_rng(0)
    raw = [(rng.normal(size=(8, 4)).astype(np.float32),
            np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)])
           for _ in range(3)]

    def jfactory():
        net = JNet(_conf(JC, seed=9, drop=0.3))
        net.init()
        return net

    jdet.assert_deterministic(jfactory, [JDataSet(a, b) for a, b in raw],
                              epochs=2)
    pdet.assert_deterministic(
        lambda: MultiLayerNetwork(_conf(PC, seed=9, drop=0.3), device="cpu"),
        [DataSet(a, b) for a, b in raw], epochs=2)


def test_assert_deterministic_reports_a_difference():
    """Two runs that differ (each factory call a new seed) fail with the
    JAX package's message; an `atol` past the difference passes, and a
    diverged run is refused."""
    raw = [_data(8, seed=s) for s in range(2)]
    seeds = iter(range(100, 200))

    def pfactory():
        return MultiLayerNetwork(_conf(PC, seed=next(seeds)), device="cpu")

    with pytest.raises(AssertionError,
                       match=r"nondeterministic training: params differ at "
                             r"\d+/\d+ positions \(max \|diff\| = "):
        pdet.assert_deterministic(pfactory, [DataSet(a, b) for a, b in raw])
    pdet.assert_deterministic(pfactory, [DataSet(a, b) for a, b in raw],
                              atol=10.0)
    bad = [DataSet(np.full((8, 4), np.nan, np.float32), raw[0][1])]
    with pytest.raises(AssertionError, match="training diverged"):
        pdet.assert_deterministic(
            lambda: MultiLayerNetwork(_conf(PC), device="cpu"), bad)


class _FixedNet:
    """A stand-in network whose `params()` is a fixed vector: the factory
    hands out one per run, so the two runs differ by what the test says."""

    def __init__(self, value, torch_params):
        self._value = np.asarray([value, 1.0], np.float32)
        self._torch = torch_params

    def fit(self, iterator, epochs=1):
        pass

    def params(self):
        return torch.from_numpy(self._value) if self._torch \
            else self._value


@pytest.mark.parametrize("second,accepted", [
    (1e4 + 9.8e-4, True),    # inside atol + 1e-7 |b|, past atol alone
    (1e4 + 2.5e-3, False),   # past both
])
def test_assert_deterministic_tolerance_matches_numpy(second, accepted):
    """With `atol > 0` the verdict is numpy's `assert_allclose`, whose
    rtol is 1e-7: at 1e4 against 1e4 + 9.8e-4 and atol 1e-4 both
    packages accept (the port once compared with rtol 0 and refused),
    and a gap past atol + 1e-7 |b| both refuse."""
    for det, is_torch in ((jdet, False), (pdet, True)):
        values = iter([1e4, second])

        def factory():
            return _FixedNet(next(values), is_torch)

        if accepted:
            det.assert_deterministic(factory, [None], atol=1e-4)
        else:
            with pytest.raises(AssertionError):
                det.assert_deterministic(factory, [None], atol=1e-4)
