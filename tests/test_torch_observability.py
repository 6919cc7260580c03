"""The port's `serving/observability.py` held against the JAX package's:
the same sequence of counter, gauge and histogram observations,
excursions, traces and flight-recorder writes goes through both modules,
and the snapshots, quantile bounds, dumps and the Prometheus exposition
text must be equal (trace ids, timestamps and wall clocks masked), so a
scraper reads the same text from either package. Also the kill switch
(`DL4J_TPU_NO_TRACING`) and the `torch.profiler` span annotations."""
import math
import threading

import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu.serving import observability as ref  # noqa: E402
from deeplearning4j_tpu_torch.serving import observability as port  # noqa: E402


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
def _tracing_on(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_NO_TRACING", raising=False)
    monkeypatch.delenv("DL4J_TPU_XLA_SPAN_ANNOTATIONS", raising=False)


_CLOCK_KEYS = ("t0", "t1", "t", "wall_time", "anchor", "trace_id",
               "remote_trace_id")


def _mask(obj):
    """Trace ids, monotonic stamps and wall clocks differ run to run:
    replace them by their key, keep everything else."""
    if isinstance(obj, dict):
        return {k: (f"<{k}>" if k in _CLOCK_KEYS else _mask(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _drive_metrics(mod, buckets=None):
    """One fixed sequence of instrument writes and a component stats
    adapter with nested, boolean, string and None leaves."""
    reg = mod.MetricsRegistry()
    reg.counter("requests").inc()
    reg.counter("requests").inc(4)
    reg.counter("shed{reason=\"overload\"}").inc(2)
    depth = [3]
    reg.gauge("queue_depth", lambda: depth[0])
    reg.gauge("set_gauge").set(2.5)
    reg.gauge("broken", lambda: 1 / 0)  # a failing gauge is skipped
    h = reg.histogram("latency_ms") if buckets is None \
        else reg.histogram("latency_ms", buckets)
    for v in (0.5, 1.0, 3.0, 7.5, 40.0, 99.0, 420.0, 9000.0, 1e6):
        h.observe(v)
    reg.histogram("empty_ms")
    reg.register_stats("server", lambda: {
        "served": 7, "ratio": 0.25, "ok": True, "state": "closed",
        "nested": {"a": 1, "b": {"c": 2.0}, "none": None},
        "list": [1, 2]})
    reg.register_stats("dying", lambda: {}["missing"])
    depth[0] = 5  # gauges sample at snapshot time
    return reg


@pytest.mark.parametrize("buckets", [None, (1.0, 10.0, 100.0)])
def test_snapshot_matches_jax(buckets):
    assert _drive_metrics(port, buckets).snapshot() \
        == _drive_metrics(ref, buckets).snapshot()


@pytest.mark.parametrize("labels", [None, {"model": "gpt"},
                                    {"model": "m", "zone": "a"}])
def test_exposition_text_matches_jax_line_for_line(labels):
    got = _drive_metrics(port).exposition(labels=labels).splitlines()
    want = _drive_metrics(ref).exposition(labels=labels).splitlines()
    assert got == want
    assert any(line.startswith("dl4j_latency_ms_bucket") for line in got)


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9, 0.99, 0.999])
def test_quantile_bound_matches_jax(q):
    hp, hr = port.Histogram("h"), ref.Histogram("h")
    assert hp.quantile_bound(q) is None and hr.quantile_bound(q) is None
    for i in range(200):
        v = (i * 37 % 101) * 3.3
        hp.observe(v)
        hr.observe(v)
    assert hp.quantile_bound(q) == hr.quantile_bound(q)
    assert hp.snapshot() == hr.snapshot()


def test_histogram_rejects_empty_buckets_and_bad_excursion_config():
    for mod in (port, ref):
        with pytest.raises(ValueError):
            mod.Histogram("h", buckets=())
        h = mod.Histogram("h")
        with pytest.raises(ValueError):
            h.enable_excursion(quantile=1.0)
        with pytest.raises(ValueError):
            h.enable_excursion(min_count=0)


@pytest.mark.parametrize("quantile,min_count", [(0.5, 2), (0.9, 5),
                                                (0.99, 50)])
def test_excursion_hook_fires_identically(quantile, min_count):
    """The same observations fire the same (value, bound) excursions,
    judged against the bound before each observation, only once
    `min_count` observations exist, never in the +Inf bucket."""
    fired = {}
    values = [1.0, 2.0, 1.5, 30.0, 2.0, 800.0, 1.0, 1e6, 3.0, 60.0] * 8
    for mod in (port, ref):
        out = fired.setdefault(mod.__name__, [])
        h = mod.Histogram("h")
        h.enable_excursion(quantile=quantile, min_count=min_count,
                           hook=lambda v, b, tr, out=out: out.append((v, b)))
        for v in values:
            h.observe(v)
    got, want = fired.values()
    assert got == want


def _drive_recorder(mod, capacity=4):
    rec = mod.FlightRecorder(capacity=capacity, failure_capacity=2,
                             event_capacity=5)
    for i in range(6):
        tr = mod.Trace()
        tr.add_timed("queue-wait", 10.0 + i, 10.5 + i, batch=2)
        tr.event("admission", queue_depth=i)
        tr.finish("served" if i % 3 else "DeadlineExceededError")
        rec.record(tr, tr.decision, kind="predict", rows=i)
        rec.event("admit", slot=i % 2, pages=i)
    pinned = mod.Trace()
    pinned.add_timed("decode", 1.0, 2.0, steps=4)
    rec.pin(pinned, "excursion", latency_ms=5000.0, bound_ms=2.0)
    rec.record(mod.NULL_TRACE, "served")  # a null trace rings nothing
    return rec.dump()


@pytest.mark.parametrize("capacity", [2, 4, 16])
def test_flight_recorder_dump_matches_jax(capacity):
    got = _drive_recorder(port, capacity)
    want = _drive_recorder(ref, capacity)
    assert _mask(got) == _mask(want)
    assert len(got["failures"]) == 2 and len(got["events"]) == 5
    assert got["capacity"] == {"requests": capacity, "failures": 2,
                               "events": 5}


def _drive_trace(mod):
    tr = mod.Trace("fixed-id")
    with tr.span("prefill", bucket=8) as sp:
        sp.attrs["rows"] = 1
    with pytest.raises(KeyError):
        with tr.span("decode"):
            raise KeyError("boom")
    tr.event("admission", slot=0)
    tr.add_timed("queue-wait", 1.0, 1.25, decision="expired", pages=3)
    tr.finish("served")
    return tr


def test_trace_spans_and_decisions_match_jax():
    got, want = _drive_trace(port).to_dict(), _drive_trace(ref).to_dict()
    assert _mask(got) == _mask(want)
    decisions = {s["name"]: s.get("decision") for s in got["spans"]}
    assert decisions["prefill"] == "ok"
    assert decisions["decode"] == "KeyError"
    assert decisions["queue-wait"] == "expired"
    assert got["trace_id"] == "fixed-id" and got["decision"] == "served"


def test_trace_bounds_spans_and_counts_drops(monkeypatch):
    for mod in (port, ref):
        monkeypatch.setattr(mod.Trace, "MAX_SPANS", 3)
        tr = mod.Trace()
        for i in range(5):
            tr.event(f"e{i}")
        d = tr.to_dict()
        assert len(d["spans"]) == 3 and d["dropped_spans"] == 2


@pytest.mark.parametrize("value", ["1", "true", "yes"])
def test_kill_switch_gives_null_trace_and_a_silent_recorder(monkeypatch,
                                                            value):
    monkeypatch.setenv("DL4J_TPU_NO_TRACING", value)
    for mod in (port, ref):
        assert not mod.tracing_enabled()
        tr = mod.maybe_trace()
        assert tr is mod.NULL_TRACE and not tr
        with tr.span("x"):
            tr.event("y")
            tr.add_timed("z", 0.0, 1.0)
        tr.finish("served")
        assert tr.to_dict() is None and tr.trace_id is None
        rec = mod.FlightRecorder()
        rec.record(mod.Trace(), "DeadlineExceededError")
        rec.event("admit", slot=0)
        rec.pin(mod.Trace(), "excursion")
        d = rec.dump()
        assert d["requests"] == [] and d["failures"] == [] \
            and d["events"] == []


@pytest.mark.parametrize("value", ["", "0", "no"])
def test_tracing_stays_on_without_the_switch(monkeypatch, value):
    monkeypatch.setenv("DL4J_TPU_NO_TRACING", value)
    assert port.tracing_enabled() == ref.tracing_enabled() is True
    assert isinstance(port.maybe_trace(), port.Trace)


def test_use_trace_precedence_and_thread_locality():
    outer, inner = port.Trace(), port.Trace()
    assert port.current_trace() is None
    assert port.maybe_trace(outer) is outer
    seen = {}
    with port.use_trace(outer):
        assert port.maybe_trace() is outer
        with port.use_trace(inner):
            assert port.current_trace() is inner
        assert port.current_trace() is outer

        t = threading.Thread(
            target=lambda: seen.update(other=port.current_trace()))
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert seen["other"] is None and port.current_trace() is None
    fresh = port.maybe_trace()
    assert isinstance(fresh, port.Trace) and fresh is not outer


def test_attach_trace_stamps_errors_like_jax():
    for mod in (port, ref):
        tr = mod.Trace("tid")
        tr.event("admission")
        tr.finish("ServerOverloadedError")
        err = RuntimeError("shed")
        mod.attach_trace(err, tr)
        assert err.trace_id == "tid"
        assert err.trace["decision"] == "ServerOverloadedError"
        bare = RuntimeError("x")
        mod.attach_trace(bare, mod.NULL_TRACE)
        assert not hasattr(bare, "trace_id")


def test_wire_context_and_remote_graft_match_jax():
    remote = {"trace_id": "remote-1",
              "anchor": {"mono": 100.0, "wall": 5000.0},
              "decision": "served",
              "spans": [{"name": "device-step", "t0": 101.0, "t1": 101.5,
                         "attrs": {"rows": 2}},
                        {"name": "queue-wait", "t0": 100.5},
                        "not a span"]}
    out = {}
    for mod in (port, ref):
        tr = mod.Trace("local")
        tr.created_mono, tr.created_at = 10.0, 5000.5
        assert mod.wire_trace_context(tr) == {
            "trace_id": "local", "anchor": {"mono": 10.0, "wall": 5000.5}}
        assert mod.wire_trace_context(mod.NULL_TRACE) is None
        n = mod.graft_remote_trace(tr, remote, replica="r0")
        n_bare = mod.graft_remote_trace(tr, {"trace_id": "x"})
        out[mod.__name__] = (n, n_bare, tr.to_dict())
    (n, n_bare, got), (m, m_bare, want) = out.values()
    assert (n, n_bare) == (m, m_bare) == (2, 0)
    assert _mask(got) == _mask(want)
    # remote 101.0 on the remote clock is 101.0 + (4900 - 4990.5) here
    spans = {s["name"]: s for s in got["spans"]}
    assert math.isclose(spans["device-step"]["t0"], 10.5)
    assert spans["device-step"]["attrs"] == {"rows": 2, "replica": "r0",
                                             "remote": True}


def test_stats_key_contracts_are_the_jax_packages():
    for name in ("MODEL_SERVER_STATS_KEYS", "DECODE_ENGINE_STATS_KEYS",
                 "TENANT_STATS_KEYS", "REPLICA_POOL_STATS_KEYS",
                 "AUTOSCALER_STATS_KEYS", "EXACTLY_ONCE_STATS_KEYS",
                 "POOL_REPLICA_STATS_KEYS", "STREAMING_STATS_KEYS"):
        assert getattr(port, name) == getattr(ref, name), name
    assert sorted(port.__all__) == sorted(ref.__all__)


def test_span_annotations_name_phases_in_a_torch_profile(monkeypatch):
    """With the annotation switch, `Trace.span` and `annotation` record
    ``serve:<name>`` ranges in a `torch.profiler` capture; without it
    they cost nothing and record none."""
    def names_in(fn):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fn()
        return {e.name for e in prof.events()}

    def work():
        tr = port.Trace()
        with tr.span("prefill-chunk"):
            torch.ones(4).sum()
        with port.annotation("verify"):
            torch.ones(4).sum()

    assert not {"serve:prefill-chunk", "serve:verify"} & names_in(work)
    monkeypatch.setenv("DL4J_TPU_XLA_SPAN_ANNOTATIONS", "1")
    assert {"serve:prefill-chunk", "serve:verify"} <= names_in(work)
