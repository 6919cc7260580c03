"""The port's replica pool (`serving.replica_pool.ReplicaPool`) held
against the JAX package on the CPU: `predict` through the pool equals
the JAX pool's on shared weights (f32, 1e-6); the routing picks over
stub servers with scripted loads are identical in both packages; the
ladders (failover of a crashed replica, eviction and readmission,
degraded mode and its recovery, rolling reload under live traffic with
zero failures, rollback at replica k and of a poisoned candidate, hedged
predicts, the watchdog) hold; `generate` through the pool gives the JAX
engine's greedy tokens (vocab 48, d_model 32, 2 layers), also after a
slot migrated off a removed replica; the stats carry the JAX package's
key contracts; and the kernel counts stay exact when several replicas'
engines call in at once.
"""
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    generate as jax_generate,
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    DenseLayer as JaxDense,
    OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.ops.activations import Activation  # noqa: E402
from deeplearning4j_tpu.ops.losses import LossFunction  # noqa: E402
from deeplearning4j_tpu.serving import ModelServer as JaxServer  # noqa: E402
from deeplearning4j_tpu.serving import ReplicaPool as JaxPool  # noqa: E402
from deeplearning4j_tpu.serving import observability as jax_obs  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.ops import paged_attention as pa  # noqa: E402
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    InferenceFailedError,
    ModelServer,
    ModelValidationError,
    ReloadCorruptionInjector,
    ReplicaCrashInjector,
    ReplicaEvictedError,
    ReplicaHangInjector,
    ReplicaPool,
    ServerClosedError,
    ServerOverloadedError,
    ServiceUnavailableError,
    SlowInferenceInjector,
)
from deeplearning4j_tpu_torch.serving import observability as obs  # noqa: E402
from deeplearning4j_tpu_torch.util.checkpoint_store import (  # noqa: E402
    CheckpointStore,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
    write_model,
)

VOCAB = 48
WEDGE_GUARD_S = 120
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
    """A replica-pool test that wedges (a hung replica and a bug in the
    watchdog or drain path) dies by SIGALRM instead of eating the
    tier's time."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def boom(signum, frame):
        raise TimeoutError(
            f"replica-pool test exceeded the {WEDGE_GUARD_S} s wedge guard")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(WEDGE_GUARD_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _jax_conf(seed=7):
    return (dl4j.NeuralNetConfiguration.Builder()
            .seed(seed).learning_rate(0.3).list()
            .layer(JaxDense(n_in=4, n_out=8))
            .layer(JaxOutput(n_in=8, n_out=3, activation=Activation.SOFTMAX,
                             loss=LossFunction.MCXENT))
            .build())


def _port_twin(jnet):
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    return pnet


@pytest.fixture(scope="module")
def mlps():
    jnet = JaxNet(_jax_conf())
    jnet.init()
    return jnet, _port_twin(jnet)


@pytest.fixture(scope="module")
def gpts():
    jnet = JaxNet(jax_gpt_configuration(vocab_size=VOCAB, d_model=32,
                                        n_heads=2, n_layers=2, max_length=64,
                                        seed=12345))
    jnet.init()
    return jnet, _port_twin(jnet)


@pytest.fixture()
def x():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 3, 32)
    return (rng.normal(size=(32, 4)) + c[:, None]).astype(np.float32)


def _prompt(n=8, seed=3):
    return np.random.default_rng(seed).integers(0, VOCAB, n) \
        .astype(np.int32)


def _wait(cond, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise TimeoutError(f"{what} not reached within {timeout}s")


@pytest.fixture()
def pool_factory(mlps, x):
    """Pools with tight probe and watchdog intervals, shut down (hung
    injectors released first) whatever the test's outcome."""
    pools, injectors = [], []

    def make(n_replicas=3, hooks=None, server_kwargs=None, net=None,
             **pool_kwargs):
        base = net if net is not None else mlps[1]
        hooks = hooks or {}
        servers = []
        for i in range(n_replicas):
            skw = dict(server_kwargs or {})
            if i in hooks:
                skw["infer_hooks"] = [hooks[i]]
                injectors.append(hooks[i])
            servers.append(ModelServer(base if i == 0 else base.clone(),
                                       **skw))
        pool_kwargs.setdefault("probe_batch", x[:2])
        pool_kwargs.setdefault("probe_interval", 0.1)
        pool_kwargs.setdefault("probe_timeout", 5.0)
        pool_kwargs.setdefault("watchdog_timeout", 2.0)
        pool = ReplicaPool(servers, **pool_kwargs)
        pools.append(pool)
        return pool

    yield make
    for inj in injectors:
        release = getattr(inj, "release", None)
        if release is not None:
            release()
    for p in pools:
        p.shutdown(drain_timeout=5.0)


# ------------------------------------------------------------ parity
def test_pool_predict_matches_the_jax_pool(mlps, x):
    jnet, pnet = mlps
    jpool = JaxPool.from_net(jnet, 2, probe_interval=30.0)
    pool = ReplicaPool.from_net(pnet, 2, probe_interval=30.0)
    try:
        want = jpool.predict(x, timeout=30.0)
        got = pool.predict(x, timeout=30.0)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(pool(x[:5]), want[:5], atol=1e-6,
                                   rtol=0)
        assert pool.stats()["served"] == 2 and jpool.stats()["served"] == 1
    finally:
        jpool.shutdown(drain_timeout=5.0)
        pool.shutdown(drain_timeout=5.0)


def test_from_net_clones_onto_the_nets_device(mlps):
    pool = ReplicaPool.from_net(mlps[1], 3, probe_interval=30.0)
    try:
        nets = [r.server.net for r in pool._replicas]
        assert nets[0] is mlps[1]
        assert len({id(n) for n in nets}) == 3
        assert all(n.device == mlps[1].device for n in nets)
        assert all(torch.equal(n.params(), mlps[1].params()) for n in nets)
        assert pool.n_replicas == 3 and pool.net is mlps[1]
    finally:
        pool.shutdown(drain_timeout=5.0)


# ------------------------------------------------------- routing picks
class _Breaker:
    state = "closed"


class _StubServer:
    """A plain-Python server with a scripted load: shared by both
    packages' pools, so their picks can be compared one for one."""
    max_queue = 8

    def __init__(self):
        self.load = 0
        self.breaker = _Breaker()

    def pending(self):
        return self.load

    def probe(self, x=None, timeout=None):
        return None

    def stats(self):
        return {"queued": 0, "in_flight": 0}

    def shutdown(self, drain_timeout=10.0):
        return True


class _StubDirectory:
    """Every prompt's deepest chain is held by replica 1."""

    def best_holder(self, prompt, tenant=None):
        return {"holders": ["replica-1", "not-a-replica"], "depth": 2}

    def drop_holder(self, holder):
        pass

    def stats(self):
        return {"directory_entries": 1}


def _picks(pool_cls, servers, script, **kw):
    pool = pool_cls(servers, probe_interval=30.0, **kw)
    try:
        out = []
        for loads, exclude, evicted, prompt in script:
            for srv, load in zip(servers, loads):
                srv.load = load
            for rep in pool._replicas:
                rep.state = "evicted" if rep.id in evicted else "healthy"
            rep = pool._pick(exclude=exclude, prompt=prompt)
            out.append(None if rep is None else rep.id)
        return out, pool.stats()["affinity_routes"]
    finally:
        pool.shutdown(drain_timeout=1.0)


P = np.arange(8)
ROUTING = {
    "equal_loads_round_robin": [((0, 0, 0), (), (), None)] * 7,
    "least_loaded": [((3, 1, 2), (), (), None)] * 3
    + [((0, 5, 5), (), (), None)] * 2,
    "two_tied": [((4, 1, 1), (), (), None)] * 5,
    "exclude_tried": [((0, 0, 0), {0}, (), None)] * 4
    + [((0, 0, 9), {0, 1}, (), None)] * 2,
    "all_tried_reallowed": [((2, 1, 0), {0, 1, 2}, (), None)] * 4,
    "evicted_skipped": [((0, 0, 0), (), {1}, None)] * 4
    + [((0, 0, 0), (), {0, 1, 2}, None)],
    "moving_loads": [((i % 3, (i + 1) % 3, 1), (), (), None)
                     for i in range(9)],
    "affinity_within_margin": [((0, 2, 1), (), (), P)] * 3
    + [((0, 3, 0), (), (), P)] * 2 + [((0, 1, 0), {1}, (), P)],
}


@pytest.mark.parametrize("name", sorted(ROUTING))
def test_routing_picks_equal_the_jax_pools(name):
    """Least-loaded with the round-robin tiebreak by candidate index, the
    tried-replica exclusion, evicted replicas, and prefix affinity within
    `affinity_margin`: the same replica ids pick for pick."""
    script = ROUTING[name]
    kw = {"prefix_directory": _StubDirectory()} \
        if name.startswith("affinity") else {}
    servers = [_StubServer() for _ in range(3)]
    got = _picks(ReplicaPool, servers, script, **kw)
    want = _picks(JaxPool, servers, script, **kw)
    assert got == want
    assert None not in got[0][:-1] or name == "evicted_skipped"


# ------------------------------------------------------------ contracts
def test_stats_key_sets_are_the_contracts(pool_factory, x):
    assert obs.REPLICA_POOL_STATS_KEYS == jax_obs.REPLICA_POOL_STATS_KEYS
    assert obs.POOL_REPLICA_STATS_KEYS == jax_obs.POOL_REPLICA_STATS_KEYS
    pool = pool_factory(n_replicas=2, probe_interval=30.0)
    pool.predict(x, timeout=30.0)
    s = pool.stats()
    assert set(s) == obs.REPLICA_POOL_STATS_KEYS
    assert set(s["replicas"]) == {"0", "1"}
    for rs in s["replicas"].values():
        assert set(rs) >= obs.POOL_REPLICA_STATS_KEYS
        assert rs["state"] == "healthy" and rs["stale"] is False
    text = pool.metrics_text(labels={"model": "m"})
    assert "replica_pool_predict_latency_ms" in text
    assert 'replica="1"' in text and 'model="m"' in text
    fr = pool.flight_record()
    assert set(fr) == {"pool", "replicas"} and set(fr["replicas"]) == {
        "0", "1"}


def test_validation_matches_the_jax_pool():
    for cls in (ReplicaPool, JaxPool):
        with pytest.raises(ValueError, match="at least one"):
            cls([])
        for kw, match in (({"probe_interval": 0}, "probe_interval"),
                          ({"watchdog_timeout": 0}, "watchdog_timeout"),
                          ({"evict_threshold": 0}, "evict_threshold"),
                          ({"readmit_successes": 0}, "readmit_successes"),
                          ({"max_failovers": -1}, "max_failovers"),
                          ({"admission_budget": 0}, "admission_budget")):
            with pytest.raises(ValueError, match=match):
                cls([_StubServer()], **kw)


def test_pool_and_server_advertise_stream_sinks():
    assert ReplicaPool.supports_stream_sink is True
    assert ModelServer.supports_stream_sink is True
    assert JaxPool.supports_stream_sink is JaxServer.supports_stream_sink


# ------------------------------------------------------------ ladders
def test_least_loaded_routing_prefers_the_idle_replica(pool_factory, x):
    slow = SlowInferenceInjector(delay=0.6)
    pool = pool_factory(n_replicas=2, hooks={0: slow}, probe_interval=30.0)
    t = threading.Thread(target=lambda: pool.predict(x, timeout=30.0))
    t.start()
    time.sleep(0.15)
    assert pool.predict(x[:4], timeout=30.0).shape == (4, 3)
    assert pool.stats()["replicas"]["1"]["served"] >= 1
    slow.release()
    t.join()


def test_shared_admission_budget_sheds_pool_wide(pool_factory, x):
    slows = [SlowInferenceInjector(delay=0.3) for _ in range(2)]
    pool = pool_factory(n_replicas=2, hooks={0: slows[0], 1: slows[1]},
                        probe_interval=30.0, admission_budget=3,
                        max_failovers=0)
    ok, shed = [], []
    lock = threading.Lock()

    def flood():
        try:
            out = pool.predict(x[:2], timeout=30.0)
            with lock:
                ok.append(out.shape)
        except ServerOverloadedError as e:
            with lock:
                shed.append(e.retry_after)

    threads = [threading.Thread(target=flood) for _ in range(10)]
    for t in threads:
        t.start()
    time.sleep(0.15)
    for s in slows:
        s.release()
    for t in threads:
        t.join()
    assert shed and all(r > 0 for r in shed)
    assert len(ok) + len(shed) == 10
    assert pool.stats()["shed_overload"] == len(shed)


def test_replica_queue_full_is_load_not_sickness(pool_factory, x):
    slow = SlowInferenceInjector(delay=0.3)
    pool = pool_factory(n_replicas=1, hooks={0: slow}, probe_interval=0.05,
                        probe_timeout=0.2, admission_budget=100,
                        evict_threshold=1, max_failovers=2,
                        server_kwargs=dict(max_queue=2, max_batch_size=2,
                                           batch_window=0.0))
    shed = []

    def flood():
        try:
            pool.predict(x[:2], timeout=30.0)
        except ServerOverloadedError as e:
            shed.append(e)

    threads = [threading.Thread(target=flood) for _ in range(12)]
    for t in threads:
        t.start()
    time.sleep(0.15)
    slow.release()
    for t in threads:
        t.join()
    assert shed
    s = pool.stats()
    assert s["evictions"] == 0 and s["replicas"]["0"]["state"] == "healthy"


def test_crash_midflight_fails_over_evicts_and_readmits(pool_factory,
                                                        mlps, x):
    crash = ReplicaCrashInjector()
    pool = pool_factory(n_replicas=3, hooks={1: crash}, evict_threshold=2,
                        readmit_successes=2,
                        server_kwargs=dict(breaker_threshold=3,
                                           breaker_reset_timeout=0.2))
    results, failures = [], []
    lock = threading.Lock()
    barrier = threading.Barrier(9)

    def call(i):
        barrier.wait()
        if i == 0:
            crash.crash()
        try:
            out = pool.predict(x[:2], timeout=30.0)
            with lock:
                results.append(out)
        except Exception as e:  # any loss must surface below
            with lock:
                failures.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(9)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures and len(results) == 9
    want = mlps[1].output(x[:2]).numpy()
    for out in results:
        np.testing.assert_allclose(out, want, atol=1e-6)
    if crash.steps_killed:
        assert pool.stats()["failovers"] >= 1
    _wait(lambda: pool.stats()["replicas"]["1"]["state"] == "evicted",
          what="eviction")
    crash.revive()
    _wait(lambda: pool.stats()["healthy_replicas"] == 3, what="readmission")
    assert pool.stats()["readmissions"] >= 1


def test_all_replicas_down_degraded_then_recovers(pool_factory, x):
    crashes = {i: ReplicaCrashInjector(crashed=True) for i in range(2)}
    pool = pool_factory(n_replicas=2, hooks=crashes, evict_threshold=1,
                        readmit_successes=2,
                        server_kwargs=dict(breaker_threshold=2,
                                           breaker_reset_timeout=0.2))
    for _ in range(4):
        with pytest.raises((InferenceFailedError, ServiceUnavailableError,
                            ReplicaEvictedError)):
            pool.predict(x, timeout=10.0)
        if pool.stats()["healthy_replicas"] == 0:
            break
    _wait(lambda: pool.stats()["healthy_replicas"] == 0, what="all evicted")
    with pytest.raises(ServiceUnavailableError,
                       match="no healthy replica") as ei:
        pool.predict(x, timeout=5.0)
    assert ei.value.retry_after == pool.probe_interval
    assert pool.stats()["shed_unavailable"] >= 1
    for c in crashes.values():
        c.revive()
    _wait(lambda: pool.stats()["healthy_replicas"] == 2, timeout=30.0,
          what="recovery")
    assert pool.predict(x, timeout=10.0).shape == (32, 3)


def test_recovery_without_an_explicit_probe_batch(pool_factory, x):
    crash = ReplicaCrashInjector(crashed=True)
    pool = pool_factory(n_replicas=2, hooks={1: crash}, probe_batch=None,
                        evict_threshold=1, readmit_successes=2,
                        server_kwargs=dict(breaker_threshold=2,
                                           breaker_reset_timeout=0.2))
    assert pool.predict(x, timeout=10.0).shape == (32, 3)
    deadline = time.monotonic() + 20.0
    while pool.stats()["replicas"]["1"]["state"] != "evicted" \
            and time.monotonic() < deadline:
        try:
            pool.predict(x[:2], timeout=5.0)
        except Exception:  # driving the dead replica to eviction only
            pass
        time.sleep(0.02)
    assert pool.stats()["replicas"]["1"]["state"] == "evicted"
    crash.revive()
    _wait(lambda: pool.stats()["healthy_replicas"] == 2, timeout=30.0,
          what="readmission")


def _candidate(tmp_path, seed=11):
    """A `CheckpointStore` holding a port network of other weights at
    step 1 (written as the JAX package's zip)."""
    cand = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(_jax_conf(seed).to_json()),
        device="cpu")
    cand.init()
    store = CheckpointStore(tmp_path)
    store.save(1, lambda tmp: write_model(cand, tmp, atomic=False))
    return store, cand


def test_rolling_reload_under_live_traffic_fails_nothing(pool_factory,
                                                         mlps, x, tmp_path):
    store, cand = _candidate(tmp_path)
    pool = pool_factory(n_replicas=3, probe_interval=0.2,
                        server_kwargs=dict(canary=x[:2]))
    old = mlps[1].output(x[:4]).numpy()
    new = cand.output(x[:4]).numpy()
    stop = threading.Event()
    failures, answers = [], []

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                answers.append(pool.predict(x[:4], timeout=30.0))
            except Exception as e:  # the zero-failure contract
                failures.append(e)
            time.sleep(float(rng.exponential(0.004)))

    threads = [threading.Thread(target=client, args=(s,)) for s in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    versions = pool.rolling_reload(store, drain_timeout=10.0)
    time.sleep(0.1)
    stop.set()
    for t in threads:
        t.join()
    assert not failures and versions == [1, 1, 1]
    s = pool.stats()
    assert s["rolling_reloads"] == 1 and s["rollbacks"] == 0
    for out in answers:
        assert np.allclose(out, old, atol=1e-6) \
            or np.allclose(out, new, atol=1e-6)
    np.testing.assert_allclose(pool.predict(x[:4], timeout=30.0), new,
                               atol=1e-6)


def test_poisoned_candidate_rolls_the_pool_back(pool_factory, mlps, x,
                                                tmp_path):
    store = CheckpointStore(tmp_path)
    path = ReloadCorruptionInjector().poison_params(store, 1, mlps[1])
    assert path.exists()
    pool = pool_factory(n_replicas=3, server_kwargs=dict(canary=x[:2]))
    before = pool.predict(x, timeout=30.0)
    with pytest.raises(ModelValidationError, match="non-finite") as ei:
        pool.rolling_reload(store, step=1, drain_timeout=10.0)
    assert getattr(ei.value, "replica_id", None) == 0
    s = pool.stats()
    assert s["rollbacks"] == 1 and s["rolling_reloads"] == 0
    assert s["healthy_replicas"] == 3
    np.testing.assert_allclose(pool.predict(x, timeout=30.0), before,
                               atol=1e-6)


def test_probe_failure_at_replica_k_rolls_back_every_replica(
        pool_factory, mlps, x, tmp_path):
    """The candidate passes every canary but replica 1 cannot serve it:
    replica 0, already reloaded and readmitted, is restored too."""
    store, cand = _candidate(tmp_path)

    def break_candidate(phase, info):
        if phase == "pre_step" and info["model_version"] == 1:
            raise RuntimeError("injected: the candidate cannot serve here")

    pool = pool_factory(n_replicas=3, hooks={1: break_candidate},
                        probe_timeout=3.0,
                        server_kwargs=dict(canary=x[:2], breaker_threshold=2,
                                           breaker_reset_timeout=0.2))
    before = pool.predict(x, timeout=30.0)
    with pytest.raises(InferenceFailedError, match="post-reload probe"):
        pool.rolling_reload(store, step=1, drain_timeout=10.0)
    s = pool.stats()
    assert s["rollbacks"] == 1 and s["rolling_reloads"] == 0
    for i in range(3):
        np.testing.assert_allclose(
            pool._replicas[i].server.predict(x, timeout=10.0), before,
            atol=1e-6)
    assert all(rs["state"] == "healthy" for rs in s["replicas"].values())
    assert not np.allclose(before, cand.output(x).numpy(), atol=1e-3)


def test_hedge_beats_a_replica_hung_forever(pool_factory, x):
    hang = ReplicaHangInjector()
    pool = pool_factory(n_replicas=2, hooks={0: hang}, probe_interval=0.1,
                        watchdog_timeout=0.5, hedge=True, hedge_delay=0.1)
    t0 = time.monotonic()
    assert pool.predict(x, timeout=30.0).shape == (32, 3)
    assert time.monotonic() - t0 < 10.0
    s = pool.stats()
    if hang.hangs:
        assert s["hedges_fired"] >= 1 and s["hedge_wins"] >= 1
    _wait(lambda: pool.stats()["replicas"]["0"]["state"] == "evicted",
          what="watchdog eviction")
    assert pool.predict(x, timeout=10.0).shape == (32, 3)


def test_primary_failure_after_the_hedge_fired_fails_over(pool_factory,
                                                          x):
    hang = ReplicaHangInjector()

    def slow_then_fail(phase, info):
        if phase == "pre_step":
            time.sleep(1.0)
            raise RuntimeError("injected: the primary dies after hedging")

    pool = pool_factory(n_replicas=3, hooks={0: slow_then_fail, 2: hang},
                        probe_interval=30.0, watchdog_timeout=5.0,
                        hedge=True, hedge_delay=0.05)
    t0 = time.monotonic()
    assert pool.predict(x, timeout=60.0).shape == (32, 3)
    assert time.monotonic() - t0 < 30.0
    s = pool.stats()
    assert s["hedges_fired"] >= 1 and s["failovers"] >= 1


def test_watchdog_evicts_a_wedged_replica(pool_factory, x):
    hang = ReplicaHangInjector()
    pool = pool_factory(n_replicas=3, hooks={2: hang}, probe_interval=0.1,
                        watchdog_timeout=0.4)
    threading.Thread(
        target=lambda: pool._replicas[2].server.probe(x[:2], timeout=30.0),
        daemon=True).start()
    _wait(lambda: pool.stats()["replicas"]["2"]["state"] == "evicted",
          what="watchdog eviction")
    assert pool.stats()["evictions"] >= 1
    for _ in range(4):
        assert pool.predict(x, timeout=10.0).shape == (32, 3)


def test_shutdown_rejects_new_work_and_is_idempotent(pool_factory, x):
    pool = pool_factory(n_replicas=2, probe_interval=30.0)
    assert pool.shutdown(drain_timeout=5.0) is True
    with pytest.raises(ServerClosedError):
        pool.predict(x, timeout=5.0)
    with pytest.raises(ServerClosedError):
        pool.add_replica(_StubServer())
    pool.shutdown(drain_timeout=1.0)


def test_sync_net_and_replica_guards(pool_factory, mlps, x, tmp_path):
    """`sync_net` restores every replica that does not serve the given
    net onto a clone of it; `remove_replica` refuses unknown ids and
    the last replica."""
    _, cand = _candidate(tmp_path)
    pool = pool_factory(n_replicas=2, probe_interval=30.0)
    pool.sync_net(cand)
    want = cand.output(x).numpy()
    for rep in pool._replicas:
        assert rep.server.net is not cand
        np.testing.assert_allclose(rep.server.predict(x, timeout=10.0),
                                   want, atol=1e-6)
    with pytest.raises(ValueError, match="no replica"):
        pool.remove_replica(7)
    srv = pool.remove_replica(1, drain_timeout=5.0)
    srv.shutdown(drain_timeout=5.0)
    with pytest.raises(ValueError, match="last replica"):
        pool.remove_replica(0)
    s = pool.stats()
    assert s["n_replicas"] == 1 and s["replicas_removed"] == 1


# ---------------------------------------------------------- generation
def _gen_pool(pnet, n=2, hooks=(), **kw):
    kw.setdefault("probe_interval", 30.0)
    return ReplicaPool.from_net(
        pnet, n, server_kwargs={"generation": dict(
            GEN, logprobs=2, step_hooks=list(hooks))}, **kw)


def test_pool_generate_equals_the_jax_engines_tokens(gpts):
    jnet, pnet = gpts
    pool = _gen_pool(pnet)
    try:
        for seed in (3, 4):
            p = _prompt(seed=seed)
            want = np.asarray(jax_generate(jnet, p[None], 10,
                                           temperature=0.0))[0]
            np.testing.assert_array_equal(pool.generate(p, 10, timeout=120.0),
                                          want)
        out = pool.generate(_prompt(seed=3), 6, timeout=120.0, logprobs=2)
        assert isinstance(out, dict) and len(out["logprobs"]) == 6
        s = pool.stats()
        assert s["served"] == 3 and s["failovers"] == 0
        assert all(r.server.pending() == 0 for r in pool._replicas)
    finally:
        pool.shutdown(drain_timeout=30.0)


def _slow(dt=0.02):
    def hook(phase, info):
        if phase == "pre_decode":
            time.sleep(dt)
    return hook


def _busy_replica(pool):
    for rid, r in pool.stats()["replicas"].items():
        if r.get("generation", {}).get("active_slots", 0) > 0:
            return int(rid)
    return None


@pytest.mark.parametrize("logprobs", [0, 2], ids=["tokens", "logprobs"])
def test_generate_resumes_a_migrated_slot_on_a_peer(gpts, logprobs):
    """`remove_replica` on the replica decoding a request migrates its
    slot (migrate-then-drain): the pool splices the victim's head in
    front of the peer's tail, logprobs included, and the tokens equal
    the JAX package's greedy `generate`."""
    jnet, pnet = gpts
    pool = _gen_pool(pnet, hooks=[_slow()])
    res = {}
    try:
        p = _prompt(seed=5)
        want = np.asarray(jax_generate(jnet, p[None], 24,
                                       temperature=0.0))[0]
        pool.generate(_prompt(seed=9), 2, timeout=120.0)

        def run():
            res["out"] = pool.generate(p, 24, timeout=120.0,
                                       logprobs=logprobs)

        t = threading.Thread(target=run)
        t.start()
        _wait(lambda: _busy_replica(pool) is not None, what="a live slot")
        victim = _busy_replica(pool)
        time.sleep(0.1)
        srv = pool.remove_replica(victim, drain_timeout=60.0)
        t.join(60.0)
        assert not t.is_alive()
        srv.shutdown(drain_timeout=10.0)
        out = res["out"]
        tokens = out["tokens"] if logprobs else out
        np.testing.assert_array_equal(tokens, want)
        if logprobs:
            assert [e["token"] for e in out["logprobs"]] == want.tolist()
        s = pool.stats()
        assert s["migrations"] >= 1 and s["migration_fallbacks"] == 0
        assert s["n_replicas"] == 1
    finally:
        pool.shutdown(drain_timeout=30.0)


def test_generation_only_pool_arms_its_probe_and_readmits(gpts):
    """A pool that serves only `generate` arms a one-token generation
    probe from its first request, so an evicted replica proves its
    recovery through the engine."""
    jnet, pnet = gpts
    crash = ReplicaCrashInjector()

    def hook(phase, info):
        if phase in ("pre_decode", "pre_prefill"):
            crash("pre_step", info)

    servers = [ModelServer(pnet, generation=GEN),
               ModelServer(pnet.clone(),
                           generation=dict(GEN, step_hooks=[hook]))]
    pool = ReplicaPool(servers, probe_interval=0.1, readmit_successes=2,
                       evict_threshold=1)
    try:
        p = _prompt(seed=3)
        want = np.asarray(jax_generate(jnet, p[None], 6,
                                       temperature=0.0))[0]
        np.testing.assert_array_equal(pool.generate(p, 6, timeout=60.0),
                                      want)
        assert pool._probe_gen is not None
        crash.crash()
        _wait(lambda: pool.stats()["replicas"]["1"]["state"] == "evicted",
              what="eviction by the generation probe")
        for _ in range(3):
            np.testing.assert_array_equal(
                pool.generate(p, 6, timeout=60.0), want)
        crash.revive()
        _wait(lambda: pool.stats()["healthy_replicas"] == 2, timeout=30.0,
              what="readmission")
    finally:
        pool.shutdown(drain_timeout=30.0)


def test_set_tenant_quota_fans_out_to_every_replica(gpts):
    pool = _gen_pool(gpts[1])
    try:
        pool.set_tenant_quota("t", rate=5.0, burst=10.0, weight=2.0)
        for rep in pool._replicas:
            st = rep.server._engine._tenants["t"]
            assert st.rate == 5.0 and st.weight == 2.0
    finally:
        pool.shutdown(drain_timeout=30.0)


# --------------------------------------------------------- exact counts
def test_plain_counts_equal_the_engines_steps_under_three_replicas(gpts):
    """Three engines in one process call the paged plain version from
    their scheduler threads at once: its count equals layers x (decode
    steps + prefill chunks) summed over the engines, with no count
    lost."""
    pnet = gpts[1]
    gen = dict(GEN, prefill_chunk=8, max_len=48)
    pool = ReplicaPool.from_net(pnet, 3, server_kwargs={"generation": gen},
                                probe_interval=30.0)
    old = sys.getswitchinterval()
    try:
        pool.generate(_prompt(seed=1), 2, timeout=60.0)
        sys.setswitchinterval(1e-6)
        pa.reset_counts()
        befores = [dict(r.server._engine.stats()) if r.server._engine
                   else None for r in pool._replicas]
        prompts = [_prompt(n=8 + 4 * (i % 3), seed=i) for i in range(9)]
        outs = [None] * 9

        def run(i):
            outs[i] = pool.generate(prompts[i], 12, timeout=120.0)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        sys.setswitchinterval(old)
        assert all(o is not None and len(o) == 12 for o in outs)
        steps = 0
        for rep, before in zip(pool._replicas, befores):
            st = rep.server._engine.stats()
            b = before or {"decode_steps": 0, "prefill_chunks": 0}
            steps += st["decode_steps"] - b["decode_steps"] \
                + st["prefill_chunks"] - b["prefill_chunks"]
        assert steps > 0
        n_layers = 2
        assert pa.paged_attention_plain.calls == n_layers * steps
        assert pa.paged_attention.launches == 0
    finally:
        sys.setswitchinterval(old)
        pool.shutdown(drain_timeout=30.0)


class _FakeLib:
    @staticmethod
    def dl4j_flash_route(kind, code, D):
        return 0


def test_kernel_launch_counts_are_exact_under_concurrent_callers():
    """The wrappers' launch counts are plain ints bumped under a lock:
    eight threads counting 5000 launches each lose none."""
    old = sys.getswitchinterval()
    pa.reset_counts()
    fa.reset_counts()
    n, per = 8, 5000

    def paged():
        for _ in range(per):
            pa._count_launch((1, "dense"))

    def flash():
        for _ in range(per):
            fa._counted(fa.flash_forward, _FakeLib, fa._FWD, 0, 128)

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=f) for f in (paged, flash)
                   for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert pa.paged_attention.launches == n * per
    assert pa.paged_attention.launches_by == {(1, "dense"): n * per}
    assert fa.flash_forward.launches == n * per
    assert sum(fa.launches_by_route.values()) == n * per
    assert type(pa.paged_attention.launches) is int
    pa.reset_counts()
    fa.reset_counts()
