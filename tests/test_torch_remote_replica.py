"""The port's remote replicas over the gateway wire, in process (the
ladders of the JAX package's `tests/test_remote_replica.py`): a port
`ReplicaEntryPoint` behind a port `GatewayServer` in the test process, a
`RemoteReplica` talking to it over loopback sockets, and `ChaosProxy`
between them for the network faults. Covered: the replica seam over the
wire (predict against the local network, three-valued probes, stats,
snapshot and restore, `sync_net`), traces joined and grafted across the
wire, the pooled connections of `GatewayClient`, every wire failure and
every proxy mode mapped to its typed error, failover exhaustion with its
hints, partition -> eviction -> heal -> readmission, rolling reload
across the boundary with the rollback of a poisoned candidate, the
gateway's `metrics` and `flight_record` over a remote pool, and a mixed
pool: one port `RemoteReplicaPool` over a port and a JAX gateway serving
the same zip, whose greedy tokens agree and which a `rolling_reload`
moves to a second zip on both.
"""
import signal
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu import gateway as jgw  # noqa: E402
from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.ops.activations import Activation  # noqa: E402
from deeplearning4j_tpu.ops.losses import LossFunction  # noqa: E402
from deeplearning4j_tpu.serving import (  # noqa: E402
    ReplicaEntryPoint as JaxReplicaEntryPoint,
)
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.gateway import (  # noqa: E402
    EntryPoint,
    GatewayClient,
    GatewayError,
    GatewayProtocolError,
    GatewayServer,
)
from deeplearning4j_tpu_torch.models.transformer import (  # noqa: E402
    generate,
)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    ChaosProxy,
    ConnectionResetInjector,
    DeadlineExceededError,
    GarbageResponseInjector,
    InferenceFailedError,
    ModelServer,
    ModelValidationError,
    NetworkLatencyInjector,
    PartitionInjector,
    ReloadCorruptionInjector,
    RemoteReplica,
    RemoteReplicaPool,
    ReplicaCrashInjector,
    ReplicaEntryPoint,
    ReplicaPool,
    ServerOverloadedError,
    ServiceUnavailableError,
    SlowLorisInjector,
    observability,
)
from deeplearning4j_tpu_torch.serving.remote_replica import (  # noqa: E402
    free_port,
)
from deeplearning4j_tpu_torch.util.checkpoint_store import (  # noqa: E402
    CheckpointStore,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    restore_model,
    write_model,
)

WEDGE_GUARD_S = 120
VOCAB = 48
GEN = {"n_slots": 2, "max_len": 48, "prompt_buckets": (8,)}


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
def _wedge_guard():
    """A wire test that wedges (a proxy mode or a drain path stuck) dies
    by SIGALRM instead of eating the tier's time."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def boom(signum, frame):
        raise TimeoutError(
            f"remote-replica test exceeded the {WEDGE_GUARD_S} s wedge "
            "guard — a wire/drain path is stuck")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(WEDGE_GUARD_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _jax_conf(n_out=3, seed=7):
    return (dl4j.NeuralNetConfiguration.Builder()
            .seed(seed).learning_rate(0.3)
            .list()
            .layer(DenseLayer(n_in=4, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=n_out,
                               activation=Activation.SOFTMAX,
                               loss=LossFunction.MCXENT))
            .build())


def _port_net(seed=7):
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(_jax_conf(seed=seed).to_json()),
        device="cpu")
    net.init()
    return net


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, n)
    x = (rng.normal(size=(n, 4)) + c[:, None]).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[c]


def _out(net, x):
    return net.output(x).detach().numpy()


def _fitted_clone(seed=1, epochs=3):
    net = _port_net(seed=seed)
    x, y = _data(48, seed=seed)
    net.fit(DataSet(x, y), epochs=epochs)
    return net


@pytest.fixture(scope="module")
def net():
    return _port_net()


@pytest.fixture()
def x():
    return _data()[0]


@pytest.fixture()
def wire(net, tmp_path):
    """Factory for in-process wire topologies (gateway-served replica
    endpoints, `RemoteReplica` adapters, chaos proxies, and
    `RemoteReplicaPool`s) with teardown in dependency order."""
    servers, reps, proxies, pools = [], [], [], []

    def make_server(the_net=None, serving=None):
        ep = ReplicaEntryPoint(
            serving={} if serving is None else serving,
            scratch_dir=tmp_path, device="cpu")
        ep.serve_net((the_net if the_net is not None else net).clone())
        srv = GatewayServer(entry_point=ep).start()
        servers.append(srv)
        return srv

    def make_replica(port, **kw):
        kw.setdefault("scratch_dir", tmp_path)
        kw.setdefault("rpc_timeout", 15.0)
        r = RemoteReplica("127.0.0.1", port, **kw)
        reps.append(r)
        return r

    def make_proxy(port):
        p = ChaosProxy("127.0.0.1", port)
        proxies.append(p)
        return p

    def make_pool(replicas, **kw):
        kw.setdefault("probe_batch", _data()[0][:2])
        kw.setdefault("probe_interval", 0.1)
        kw.setdefault("probe_timeout", 3.0)
        kw.setdefault("watchdog_timeout", 5.0)
        kw.setdefault("template_net", net)
        kw.setdefault("scratch_dir", tmp_path)
        p = RemoteReplicaPool(replicas, **kw)
        pools.append(p)
        return p

    yield SimpleNamespace(server=make_server, replica=make_replica,
                          proxy=make_proxy, pool=make_pool,
                          servers=servers)
    for p in pools:
        p.shutdown(drain_timeout=3.0)
    for r in reps:
        r.shutdown()
    for pr in proxies:
        pr.close()
    for s in servers:
        s.stop(drain_timeout=3.0)


# ------------------------------------------------- the replica seam
def test_remote_predict_matches_local(wire, net, x):
    srv = wire.server()
    rep = wire.replica(srv.port)
    np.testing.assert_allclose(rep.predict(x, timeout=10.0), _out(net, x),
                               atol=1e-6)
    assert rep.probe(x[:2], timeout=5.0) is True
    assert rep.probe() is None
    assert rep.pending() == 0
    st = rep.stats()
    assert st["unreachable"] is False
    assert st["endpoint"] == rep.endpoint
    assert st["served"] >= 1 and st["breaker_state"] == "closed"
    rec = rep.flight_record()
    assert rec["endpoint"] == rep.endpoint and "requests" in rec


def test_remote_stats_survive_a_dead_endpoint(wire, x):
    rep = wire.replica(free_port(), rpc_timeout=2.0)
    st = rep.stats()
    assert st["unreachable"] is True
    assert st["breaker_state"] == "closed"
    assert st["served"] == 0
    assert rep.flight_record() == {"endpoint": rep.endpoint,
                                   "unreachable": True}
    assert rep.probe() is False and rep.probe(x[:2]) is False
    text = rep.metrics.exposition(labels={"replica": "0"})
    assert text.startswith("#") and "unreachable" in text


def test_remote_snapshot_restore_roundtrip(wire, x):
    srv = wire.server()
    rep = wire.replica(srv.port)
    before = rep.predict(x, timeout=10.0)
    snap = rep.net
    assert snap.path and snap.version == 0
    fitted = _fitted_clone(seed=5)
    rep.restore_model(fitted)
    after = rep.predict(x, timeout=10.0)
    assert not np.allclose(before, after, atol=1e-3), \
        "test is vacuous: fitted clone agrees with the base net"
    np.testing.assert_allclose(after, _out(fitted, x), atol=1e-6)
    rep.restore_model(snap)
    np.testing.assert_allclose(rep.predict(x, timeout=10.0), before,
                               atol=1e-6)
    # the replica restored on its entry point's device
    assert srv.entry._models["replica"].device.type == "cpu"


def test_remote_sync_net_pushes_weights(wire, x):
    srv = wire.server()
    rep = wire.replica(srv.port)
    pool = wire.pool([rep], probe_interval=1.0)
    fitted = _fitted_clone(seed=3)
    pool.sync_net(fitted)
    np.testing.assert_allclose(pool.predict(x, timeout=10.0),
                               _out(fitted, x), atol=1e-5)
    assert pool.net is fitted


# ------------------------------------------------- traces over the wire
def test_remote_trace_joins_and_grafts_one_timeline(wire, x):
    srv = wire.server()
    rep = wire.replica(srv.port)
    trace = observability.Trace()
    with observability.use_trace(trace):
        rep.predict(x[:4], timeout=10.0)
    assert rep._client.last_trace_id == trace.trace_id
    remote_spans = [s for s in trace.to_dict()["spans"]
                    if (s.get("attrs") or {}).get("remote")]
    assert remote_spans
    assert all(s["attrs"]["endpoint"] == rep.endpoint for s in remote_spans)


def test_wire_trace_context_carries_anchor():
    trace = observability.Trace()
    ctx = observability.wire_trace_context(trace)
    assert ctx["trace_id"] == trace.trace_id
    assert ctx["anchor"] == {"mono": trace.created_mono,
                             "wall": trace.created_at}
    assert observability.wire_trace_context(observability.NULL_TRACE) \
        is None
    assert observability.wire_trace_context(None) is None


def test_graft_remote_trace_anchor_math():
    trace = observability.Trace()
    r_mono, r_wall = 5000.0, trace.created_at + 123.456
    remote = {"trace_id": trace.trace_id,
              "anchor": {"mono": r_mono, "wall": r_wall},
              "decision": "served",
              "spans": [{"name": "execute", "t0": r_mono + 1.0,
                         "t1": r_mono + 1.5, "decision": "ok"}]}
    assert observability.graft_remote_trace(trace, remote,
                                            endpoint="a:1") == 1
    span = [s for s in trace.to_dict()["spans"]
            if s["name"] == "execute"][0]
    offset = (r_wall - r_mono) - (trace.created_at - trace.created_mono)
    assert span["t0"] == pytest.approx(r_mono + 1.0 + offset)
    assert span["t1"] - span["t0"] == pytest.approx(0.5)
    assert span["attrs"]["remote"] is True
    assert span["attrs"]["endpoint"] == "a:1"
    assert "remote-decision" in [s["name"] for s in trace.to_dict()["spans"]]
    t2 = observability.Trace()
    assert observability.graft_remote_trace(
        t2, {"trace_id": "x", "spans": [{"name": "e", "t0": 1.0}]}) == 0
    assert [s["name"] for s in t2.to_dict()["spans"]] == ["remote-trace"]


# ------------------------------------------------ keep-alive pooling
def test_pooled_connection_reused_across_calls(wire):
    srv = wire.server()
    client = GatewayClient(port=srv.port)
    try:
        client.call("health")
        first = client._sock
        assert client.call("health")["ok"] is True
        assert client._sock is first
    finally:
        client.close()


def test_dropped_pooled_connection_transparently_reconnects(wire):
    srv = wire.server()
    client = GatewayClient(port=srv.port)
    try:
        client.call("health")
        stale = client._sock
        stale.shutdown(socket.SHUT_WR)
        assert client.call("health")["ok"] is True
        assert client._sock is not stale
    finally:
        client.close()


def test_stale_idle_connection_replaced_not_reused(wire):
    srv = wire.server()
    client = GatewayClient(port=srv.port, max_idle=0.05)
    try:
        client.call("health")
        old = client._sock
        time.sleep(0.15)
        assert client.call("health")["ok"] is True
        assert client._sock is not old
    finally:
        client.close()


def test_connection_pool_bounded_by_pool_size(wire):
    srv = wire.server()
    client = GatewayClient(port=srv.port, pool_size=2)
    try:
        barrier = threading.Barrier(4)
        errors = []

        def hit():
            try:
                barrier.wait(timeout=10)
                client.call("health")
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=hit) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert len(client._idle) <= 2
    finally:
        client.close()


# ------------------------------------------- wire -> typed error mapping
def test_wire_error_mapping_ladder():
    rep = RemoteReplica("127.0.0.1", free_port())
    try:
        m = rep._wire_error(
            GatewayError("queue full", error_type="ServerOverloadedError",
                         retry_after=0.7),
            deadline_bound=True, what="predict")
        assert isinstance(m, ServerOverloadedError)
        assert m.retry_after == 0.7
        m = rep._wire_error(
            GatewayError("closing", error_type="ServerClosedError"),
            deadline_bound=False, what="predict")
        assert isinstance(m, ServiceUnavailableError)
        e = GatewayError("no model 'replica'", error_type="KeyError")
        assert rep._wire_error(e, deadline_bound=False, what="predict") is e
        m = rep._wire_error(GatewayProtocolError("trash"),
                            deadline_bound=False, what="predict")
        assert isinstance(m, InferenceFailedError)
        m = rep._wire_error(TimeoutError(), deadline_bound=True,
                            what="predict")
        assert isinstance(m, DeadlineExceededError)
        m = rep._wire_error(TimeoutError(), deadline_bound=False,
                            what="predict")
        assert isinstance(m, ServiceUnavailableError)
        assert m.retry_after == 0.05
        m = rep._wire_error(ConnectionRefusedError("refused"),
                            deadline_bound=True, what="predict")
        assert isinstance(m, ServiceUnavailableError)
        assert m.retry_after == 0.05
    finally:
        rep.shutdown()


@pytest.mark.chaos
def test_partition_maps_to_service_unavailable(wire, net, x):
    srv = wire.server()
    proxy = wire.proxy(srv.port)
    rep = wire.replica(proxy.port)
    np.testing.assert_allclose(rep.predict(x[:4], timeout=10.0),
                               _out(net, x[:4]), atol=1e-6)
    part = PartitionInjector(proxy)
    part.partition()
    with pytest.raises(ServiceUnavailableError) as ei:
        rep.predict(x[:4], timeout=5.0)
    assert ei.value.retry_after == 0.05
    assert rep.probe(x[:2], timeout=2.0) is False
    part.heal()
    np.testing.assert_allclose(rep.predict(x[:4], timeout=10.0),
                               _out(net, x[:4]), atol=1e-6)
    assert part.partitions == 1


@pytest.mark.chaos
def test_garbage_response_maps_to_inference_failed(wire, x):
    srv = wire.server()
    proxy = wire.proxy(srv.port)
    rep = wire.replica(proxy.port)
    garbage = GarbageResponseInjector(proxy)
    garbage.inject()
    with pytest.raises(InferenceFailedError, match="undecodable"):
        rep.predict(x[:4], timeout=5.0)
    assert rep.probe(x[:2], timeout=2.0) is False
    garbage.release()
    assert rep.predict(x[:4], timeout=10.0).shape == (4, 3)


@pytest.mark.chaos
def test_slowloris_with_deadline_maps_to_deadline_exceeded(wire, x):
    srv = wire.server()
    proxy = wire.proxy(srv.port)
    rep = wire.replica(proxy.port, deadline_margin=0.2)
    SlowLorisInjector(proxy, interval=1.5).inject()
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceededError):
        rep.predict(x[:2], timeout=0.3)
    assert time.monotonic() - t0 < 5.0


@pytest.mark.chaos
def test_mid_response_reset_maps_to_service_unavailable(wire, x):
    srv = wire.server()
    proxy = wire.proxy(srv.port)
    rep = wire.replica(proxy.port)
    ConnectionResetInjector(proxy).inject()
    with pytest.raises(ServiceUnavailableError):
        rep.predict(x[:4], timeout=5.0)


@pytest.mark.chaos
def test_latency_injection_slows_but_serves(wire, net, x):
    srv = wire.server()
    proxy = wire.proxy(srv.port)
    rep = wire.replica(proxy.port)
    lat = NetworkLatencyInjector(proxy, delay=0.15)
    lat.inject()
    t0 = time.monotonic()
    out = rep.predict(x[:4], timeout=10.0)
    assert time.monotonic() - t0 >= 0.1
    np.testing.assert_allclose(out, _out(net, x[:4]), atol=1e-6)
    lat.release()


# --------------------------- failover exhaustion carries the hints
def test_remote_failover_exhaustion_carries_hints(wire, x):
    reps = [wire.replica(free_port(), rpc_timeout=5.0) for _ in range(2)]
    pool = wire.pool(reps, probe_batch=None, probe_interval=30.0,
                     max_failovers=1)
    with pytest.raises(ServiceUnavailableError) as ei:
        pool.predict(x[:4], timeout=5.0)
    assert ei.value.retry_after == 0.05
    assert getattr(ei.value, "replica_id", None) in (0, 1)
    assert pool.stats()["failovers"] == 1


def test_inprocess_failover_exhaustion_carries_hints(net, x):
    crashed = [ReplicaCrashInjector(crashed=True) for _ in range(2)]
    servers = [ModelServer(net.clone(), infer_hooks=[c]) for c in crashed]
    pool = ReplicaPool(servers, probe_interval=30.0, max_failovers=1)
    try:
        with pytest.raises(InferenceFailedError) as ei:
            pool.predict(x[:4], timeout=5.0)
        assert getattr(ei.value, "replica_id", None) in (0, 1)
        assert pool.stats()["failovers"] == 1
    finally:
        pool.shutdown(drain_timeout=3.0)


# ------------------------- partition -> evict -> heal -> re-admit
def _await_state(pool, rid, state, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pool.stats()["replicas"][str(rid)]["state"] == state:
            return
        time.sleep(0.05)
    pytest.fail(f"replica {rid} never became {state}")


@pytest.mark.chaos
def test_remote_pool_partition_evict_heal_readmit(wire, net, x):
    srv_a, srv_b = wire.server(), wire.server()
    proxy = wire.proxy(srv_b.port)
    rep_a = wire.replica(srv_a.port)
    rep_b = wire.replica(proxy.port, rpc_timeout=2.0)
    pool = wire.pool([rep_a, rep_b], probe_interval=0.05,
                     probe_timeout=2.0, watchdog_timeout=3.0,
                     evict_threshold=2, readmit_successes=2)
    np.testing.assert_allclose(pool.predict(x, timeout=10.0), _out(net, x),
                               atol=1e-6)
    part = PartitionInjector(proxy)
    part.partition()
    _await_state(pool, 1, "evicted")
    for _ in range(3):
        assert pool.predict(x[:4], timeout=10.0).shape == (4, 3)
    events = pool.flight_record()["pool"]["events"]
    assert any(e["kind"] == "evict" and e.get("replica") == 1
               for e in events)
    part.heal()
    _await_state(pool, 1, "healthy")
    assert pool.stats()["readmissions"] >= 1
    np.testing.assert_allclose(pool.predict(x, timeout=10.0), _out(net, x),
                               atol=1e-6)


# -------------------------------- rolling reload across the boundary
@pytest.mark.chaos
def test_remote_rolling_reload_and_poisoned_rollback(wire, net, x,
                                                     tmp_path):
    canary = x[:2]
    srv_a = wire.server(serving=dict(canary=canary))
    srv_b = wire.server(serving=dict(canary=canary))
    reps = [wire.replica(s.port) for s in (srv_a, srv_b)]
    pool = wire.pool(reps, probe_interval=0.2)
    store_dir = tmp_path / "store"
    store_dir.mkdir()
    store = CheckpointStore(store_dir)
    candidate = _fitted_clone()
    store.save(1, lambda p: write_model(candidate, p, atomic=False))
    assert pool.rolling_reload(store, step=1, drain_timeout=10.0) == [1, 1]
    np.testing.assert_allclose(pool.predict(x, timeout=10.0),
                               _out(candidate, x), atol=1e-5)
    s = pool.stats()
    assert s["rolling_reloads"] == 1 and s["rollbacks"] == 0
    ReloadCorruptionInjector().poison_params(store, 2, net)
    with pytest.raises(ModelValidationError, match="non-finite") as ei:
        pool.rolling_reload(store, step=2, drain_timeout=10.0)
    assert getattr(ei.value, "replica_id", None) == 0
    s = pool.stats()
    assert s["rollbacks"] == 1 and s["rolling_reloads"] == 1
    assert s["healthy_replicas"] == 2
    np.testing.assert_allclose(pool.predict(x, timeout=10.0),
                               _out(candidate, x), atol=1e-5)


# ---------------- gateway RPCs over a remote-backed pool
def test_gateway_metrics_and_flight_record_over_remote_pool(wire, net, x):
    srv_a, srv_b = wire.server(), wire.server()
    reps = [wire.replica(s.port) for s in (srv_a, srv_b)]
    pool = wire.pool(reps, probe_interval=0.5)
    front = EntryPoint(serving={}, device="cpu")
    front._models["m"] = net
    front._servers["m"] = pool
    gw = GatewayServer(entry_point=front).start()
    client = GatewayClient(port=gw.port)
    try:
        out = client.call("predict", name="m", features=x[:4])
        np.testing.assert_allclose(out, _out(net, x[:4]), atol=1e-6)
        text = client.call("metrics", name="m")
        assert 'model="m"' in text
        assert 'replica="0"' in text and 'replica="1"' in text
        with pytest.raises(GatewayError) as ei:
            client.call("predict", name="m",
                        features=np.ones((2, 9), np.float32),
                        _idempotent=False)
        assert ei.value.error_type == "InferenceFailedError"
        assert ei.value.replica_id in (0, 1)
        assert ei.value.trace_id
        rec = client.call("flight_record", name="m")
        assert set(rec["replicas"]) == {"0", "1"}
        assert any(r.get("failures") for r in rec["replicas"].values())
        pinned = rec["pool"]["failures"][-1]["trace"]
        assert pinned["trace_id"] == ei.value.trace_id
        assert any((sp.get("attrs") or {}).get("remote")
                   for sp in pinned["spans"])
        endpoints = {rep.endpoint for rep in reps}
        assert any((sp.get("attrs") or {}).get("endpoint") in endpoints
                   for sp in pinned["spans"])
    finally:
        client.close()
        gw.stop(drain_timeout=3.0)


# ----------------------------------------- a pool over both packages
@pytest.fixture(scope="module")
def gpt_zips(tmp_path_factory):
    """Two GPT zips of one configuration (different seeds), written from
    JAX networks."""
    d = tmp_path_factory.mktemp("mixed")
    paths = []
    for i, seed in enumerate((12345, 54321)):
        jnet = JaxNet(jax_gpt_configuration(vocab_size=VOCAB, d_model=32,
                                            n_heads=2, n_layers=2,
                                            max_length=64, seed=seed))
        jnet.init()
        jser.write_model(jnet, d / f"gpt{i}.zip")
        paths.append(d / f"gpt{i}.zip")
    return paths


@pytest.mark.chaos
def test_mixed_pool_over_a_port_and_a_jax_gateway(tmp_path, gpt_zips):
    """One port `RemoteReplicaPool` over a port gateway and a JAX
    gateway serving the same zip: greedy tokens are identical from
    either replica (and equal `generate` on the restored network), and
    a `rolling_reload` to a second zip lands on both."""
    z0, z1 = gpt_zips
    serving = {"generation": GEN}
    pep = ReplicaEntryPoint(serving=serving, scratch_dir=tmp_path,
                            device="cpu")
    pep.load_model("replica", str(z0))
    jep = JaxReplicaEntryPoint(serving=serving, scratch_dir=tmp_path)
    jep.load_model("replica", str(z0))
    psrv = GatewayServer(entry_point=pep).start()
    jsrv = jgw.GatewayServer(entry_point=jep).start()
    reps = [RemoteReplica("127.0.0.1", s.port, scratch_dir=tmp_path,
                          rpc_timeout=60.0) for s in (psrv, jsrv)]
    probe = np.arange(8, dtype=np.int32)[None] % VOCAB
    pool = RemoteReplicaPool(reps, scratch_dir=tmp_path,
                             template_net=restore_model(z0, device="cpu"),
                             probe_batch=probe, probe_interval=30.0,
                             probe_timeout=30.0, watchdog_timeout=60.0)
    try:
        for z in (z0, z1):
            if z is z1:
                versions = pool.rolling_reload(str(z1), drain_timeout=30.0)
                assert versions == [1, 1]
                assert pool.stats()["rolling_reloads"] == 1
            ref = restore_model(z, device="cpu")
            for seed, n in ((0, 8), (1, 10)):
                p = np.random.default_rng(seed).integers(0, VOCAB, 6)
                want = generate(ref, p[None], n, temperature=0.0,
                                device="cpu")[0]
                for rep in reps:
                    np.testing.assert_array_equal(
                        rep.generate(p, n, timeout=60.0), want)
                np.testing.assert_array_equal(
                    pool.generate(p, n, timeout=60.0), want)
        assert pool.healthy_replicas() == 2
    finally:
        pool.shutdown(drain_timeout=5.0)
        psrv.stop(drain_timeout=3.0)
        jsrv.stop(drain_timeout=3.0)
