"""The cross-process pool drills of the JAX package's
`tests/test_remote_replica_mp.py`, with port replica PROCESSES on the CPU
(`python -m deeplearning4j_tpu_torch.serving.remote_replica --device
cpu`, each pinned to one torch thread through the supervisor's
environment), under live Poisson traffic:

1. kill -9 of a replica: failover absorbs the loss, the supervisor
   respawns the process, the pool readmits it, no request fails;
2. a partition of one replica (a `ChaosProxy` in front of its port):
   eviction, service from the survivor, readmission after the heal;
3. kill -9 in the middle of a `rolling_reload`: the deploy fails typed
   naming the dying replica and the pool rolls back;
4. autoscale: `grow_replica` spawns a third process that earns traffic
   through the probes, and a kill -9 racing its scale-down drain still
   ends with the slot retired.

Every drill waits on conditions with deadlines, never on wall-clock
bounds, and bounds its own wall time; the replica processes are reaped
after each test by the port's `reap_orphans` (the conftest's reaper
knows only the JAX package's module). A replica asked for the card on a
machine without one dies at startup with its log tail in a typed
`ReplicaSpawnError`.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu.ops.activations import Activation  # noqa: E402
from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    generate as jax_generate,
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.ops.losses import LossFunction  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    ChaosProxy,
    InferenceFailedError,
    PartitionInjector,
    RemoteReplica,
    RemoteReplicaPool,
    ReplicaSpawnError,
    ReplicaSupervisor,
    ServiceUnavailableError,
    observability,
    spawn_replica_pool,
)
from deeplearning4j_tpu_torch.serving import remote_replica  # noqa: E402
from deeplearning4j_tpu_torch.util.checkpoint_store import (  # noqa: E402
    CheckpointStore,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
    write_model,
)

pytestmark = [pytest.mark.multiprocess, pytest.mark.chaos]

WEDGE_GUARD_S = 90  # each drill's own bound on its wall time
# one torch thread in every replica process: the tier runs several
# workers on one host, and unpinned children oversubscribe its cores
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
SUP_KW = dict(restart_backoff=0.25, poll_interval=0.1, env=ONE_THREAD,
              spawn_timeout=60.0)


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
def _reap_port_replicas():
    """SIGKILL any port replica process a test left behind (a failing
    drill must not leak interpreters into the rest of the run)."""
    yield
    remote_replica.reap_orphans()


@pytest.fixture(autouse=True)
def _wedge_guard():
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def boom(signum, frame):
        raise TimeoutError(
            f"multiprocess drill exceeded the {WEDGE_GUARD_S} s wedge "
            "guard — a spawn/drill path is stuck")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(WEDGE_GUARD_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _conf(seed=7):
    jconf = (dl4j.NeuralNetConfiguration.Builder()
             .seed(seed).learning_rate(0.3)
             .list()
             .layer(DenseLayer(n_in=4, n_out=8))
             .layer(OutputLayer(n_in=8, n_out=3,
                                activation=Activation.SOFTMAX,
                                loss=LossFunction.MCXENT))
             .build())
    return MultiLayerConfiguration.from_json(jconf.to_json())


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, n)
    x = (rng.normal(size=(n, 4)) + c[:, None]).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[c]


def _out(net, x):
    return net.output(x).detach().numpy()


def _fitted_clone(seed=1, epochs=3):
    net = MultiLayerNetwork(_conf(seed=seed), device="cpu")
    net.init()
    x, y = _data(48, seed=seed)
    net.fit(DataSet(x, y), epochs=epochs)
    return net


@pytest.fixture(scope="module")
def net():
    n = MultiLayerNetwork(_conf(), device="cpu")
    n.init()
    return n


class _PoissonTraffic:
    """Live load: threads issuing `pool.predict` (or `call()`) with
    exponential gaps. Every exception is a failed request; the drills
    assert none."""

    def __init__(self, pool, x, rate_hz=20.0, n_threads=2, call=None):
        self._call = call or (lambda: pool.predict(x, timeout=15.0))
        self._rate = rate_hz / n_threads
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._loop, args=(i,),
                                          daemon=True)
                         for i in range(n_threads)]
        self.served = 0
        self.failures = []

    def _loop(self, seed):
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            try:
                self._call()
                with self._lock:
                    self.served += 1
            except Exception as e:  # the drill's metric
                with self._lock:
                    self.failures.append(e)
            time.sleep(float(rng.exponential(1.0 / self._rate)))

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30.0)
        return False


def _await(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    pytest.fail(f"timed out after {timeout:.0f}s waiting for {what}")


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    # a zombie still answers signal 0; its state says it is gone
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


_POOL_KW = dict(probe_interval=0.25, probe_timeout=5.0,
                watchdog_timeout=5.0, evict_threshold=2,
                readmit_successes=2, max_failovers=3)


def test_kill9_respawn_readmit_zero_failed_requests(net, tmp_path):
    x = _data()[0]
    pool = spawn_replica_pool(
        net, 2, scratch_dir=tmp_path,
        pool_kwargs=dict(probe_batch=x[:2], **_POOL_KW),
        supervisor_kwargs=SUP_KW)
    sup = pool.supervisor
    pids = []
    try:
        assert sup.device == "cpu"
        pids = [p.pid for p in sup._procs]
        np.testing.assert_allclose(pool.predict(x, timeout=30.0),
                                   _out(net, x), atol=1e-5)
        # SIGUSR1: a serving replica writes its counts so far to its log
        os.kill(pids[0], signal.SIGUSR1)
        _await(lambda: remote_replica.replica_launch_counts(
            tmp_path / "replica-0.log"), 30.0, "replica 0's counts line")
        snap = remote_replica.replica_launch_counts(
            tmp_path / "replica-0.log")
        assert [(c["pid"], c["final"]) for c in snap] == [(pids[0], False)]
        assert sup.is_alive(0)
        trace = observability.Trace()
        with observability.use_trace(trace):
            pool.predict(x[:2], timeout=30.0)
        remote_spans = [s for s in trace.to_dict()["spans"]
                        if (s.get("attrs") or {}).get("remote")]
        assert remote_spans, "no subprocess spans crossed the boundary"
        endpoints = {f"{h}:{p}" for h, p in sup.endpoints()}
        assert {s["attrs"]["endpoint"] for s in remote_spans} <= endpoints

        with _PoissonTraffic(pool, x[:8]) as traffic:
            _await(lambda: traffic.served >= 5, 30.0, "traffic warmup")
            sup.kill(1)
            _await(lambda: sup.respawns >= 1 and sup.is_alive(1),
                   30.0, "supervisor respawn of replica 1")
            _await(lambda: (pool.stats()["replicas"]["1"]["state"]
                            == "healthy"),
                   30.0, "re-admission of the respawned replica")
            _await(lambda: traffic.served >= 20, 30.0, "post-drill traffic")
        assert traffic.failures == [], traffic.failures
        s = pool.stats()
        assert s["healthy_replicas"] == 2
        assert s["evictions"] >= 1 and s["readmissions"] >= 1
        events = pool.flight_record()["pool"]["events"]
        assert any(e["kind"] == "evict" and e.get("replica") == 1
                   for e in events)
        assert any(e["kind"] == "readmit" and e.get("replica") == 1
                   for e in events)
        np.testing.assert_allclose(pool.predict(x, timeout=30.0),
                                   _out(net, x), atol=1e-5)
        pids += [p.pid for p in sup._procs]
    finally:
        pool.shutdown(drain_timeout=5.0)
    # the replicas that stopped cleanly wrote their counts: on the CPU
    # the plain versions ran, and no kernel launched
    counts = remote_replica.replica_launch_counts(tmp_path / "replica-0.log")
    assert counts and counts[-1]["paged"] == {} and counts[-1]["flash"] == {}
    assert counts[0]["pid"] == pids[0] and not counts[0]["final"]
    assert counts[-1]["final"]
    assert not any(_alive(p) for p in pids), "a replica outlived shutdown"


def test_partition_evict_heal_readmit_cross_process(net, tmp_path):
    x = _data()[0]
    model_path = tmp_path / "model.zip"
    write_model(net, model_path, atomic=False)
    sup = ReplicaSupervisor(model_path, 2, scratch_dir=tmp_path,
                            device="cpu", **SUP_KW).start()
    proxy = ChaosProxy("127.0.0.1", sup.ports[1])
    reps = [RemoteReplica("127.0.0.1", sup.ports[0], scratch_dir=tmp_path),
            RemoteReplica("127.0.0.1", proxy.port, scratch_dir=tmp_path,
                          rpc_timeout=5.0)]
    pool = RemoteReplicaPool(reps, supervisor=sup, template_net=net,
                             scratch_dir=tmp_path, probe_batch=x[:2],
                             **_POOL_KW)
    part = PartitionInjector(proxy)
    try:
        np.testing.assert_allclose(pool.predict(x, timeout=30.0),
                                   _out(net, x), atol=1e-5)
        with _PoissonTraffic(pool, x[:8]) as traffic:
            _await(lambda: traffic.served >= 5, 30.0, "traffic warmup")
            part.partition()
            _await(lambda: (pool.stats()["replicas"]["1"]["state"]
                            == "evicted"),
                   30.0, "eviction of the partitioned replica")
            before = traffic.served
            _await(lambda: traffic.served >= before + 5, 30.0,
                   "service from the surviving replica mid-partition")
            part.heal()
            _await(lambda: (pool.stats()["replicas"]["1"]["state"]
                            == "healthy"),
                   30.0, "re-admission after the partition healed")
        assert traffic.failures == [], traffic.failures
        assert sup.is_alive(1), "only the network was cut"
        events = pool.flight_record()["pool"]["events"]
        assert any(e["kind"] == "evict" and e.get("replica") == 1
                   for e in events)
        assert pool.stats()["readmissions"] >= 1
    finally:
        pool.shutdown(drain_timeout=5.0)
        proxy.close()


def test_rolling_reload_crash_mid_deploy_rolls_back_pool_wide(net,
                                                              tmp_path):
    x = _data()[0]
    pool = spawn_replica_pool(
        net, 2, scratch_dir=tmp_path,
        pool_kwargs=dict(probe_batch=x[:2], **_POOL_KW),
        supervisor_kwargs=dict(SUP_KW, chaos_die_on_reload=[1]))
    sup = pool.supervisor
    store_dir = tmp_path / "store"
    store_dir.mkdir()
    store = CheckpointStore(store_dir)
    candidate = _fitted_clone()
    store.save(1, lambda p: write_model(candidate, p, atomic=False))
    baseline = _out(net, x)
    try:
        with _PoissonTraffic(pool, x[:8]) as traffic:
            _await(lambda: traffic.served >= 5, 30.0, "traffic warmup")
            with pytest.raises((ServiceUnavailableError,
                                InferenceFailedError)) as ei:
                pool.rolling_reload(store, step=1, drain_timeout=30.0)
            assert getattr(ei.value, "replica_id", None) == 1
            _await(lambda: sup.respawns >= 1 and sup.is_alive(1),
                   30.0, "respawn of the replica that died mid-deploy")
            _await(lambda: pool.stats()["healthy_replicas"] == 2,
                   30.0, "full pool recovery after the failed deploy")
            _await(lambda: traffic.served >= 15, 30.0,
                   "post-rollback traffic")
        assert traffic.failures == [], traffic.failures
        s = pool.stats()
        assert s["rollbacks"] == 1 and s["rolling_reloads"] == 0
        np.testing.assert_allclose(pool.predict(x, timeout=30.0),
                                   baseline, atol=1e-5)
        assert not np.allclose(baseline, _out(candidate, x), atol=1e-3)
    finally:
        pool.shutdown(drain_timeout=5.0)


def _gpt_pair(seed):
    """A small JAX GPT and the port's copy of its weights."""
    jnet = dl4j.MultiLayerNetwork(jax_gpt_configuration(
        vocab_size=48, d_model=32, n_heads=2, n_layers=1, max_length=24,
        seed=seed))
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    return jnet, pnet


def test_pool_of_tp2_replicas_kill9_and_rolling_reload(tmp_path):
    """The JAX package's composition drill
    (`tests/test_tp_engine.py::test_remote_pool_of_tp2_replicas_kill9_and_rolling_reload`):
    a cross-process pool whose replicas are each a tp=2 engine (the
    supervisor starts them with `--slots 2`) survives kill -9 failover
    and a rolling reload under live generate traffic with zero failed
    requests (a slot live at a replica's drain is migrated to its peer
    or, where the peer cannot take it, run again; the handoff between
    tp engines is pinned in `tests/test_torch_tp_engine.py`). Tokens
    equal the JAX `generate` before and after the reload."""
    jnet, pnet = _gpt_pair(12345)
    prompt = np.random.default_rng(0).integers(0, 48, 5).astype(np.int32)
    expected = jax_generate(jnet, prompt[None], 4, temperature=0.0)[0]
    pool = spawn_replica_pool(
        pnet, 2, scratch_dir=tmp_path,
        server_kwargs={"generation": {"n_slots": 2, "max_len": 24,
                                      "prompt_buckets": (8,),
                                      "page_size": 8},
                       "parallel": {"tp": 2}},
        pool_kwargs=dict(probe_interval=0.5, probe_timeout=15.0,
                         watchdog_timeout=15.0, evict_threshold=2,
                         readmit_successes=2, max_failovers=3),
        supervisor_kwargs=SUP_KW, rpc_timeout=60.0)
    sup = pool.supervisor
    try:
        cmd = sup._cmd(0)
        assert cmd[cmd.index("--slots") + 1] == "2"
        np.testing.assert_array_equal(
            pool.generate(prompt, 4, temperature=0.0, seed=0,
                          timeout=60.0), expected)
        with _PoissonTraffic(pool, None, call=lambda: pool.generate(
                prompt, 4, temperature=0.0, seed=0,
                timeout=30.0)) as traffic:
            _await(lambda: traffic.served >= 3, 30.0, "traffic warmup")
            sup.kill(1)
            # the pool must first notice the death (a probe cycle)
            _await(lambda: (pool.stats()["replicas"]["1"]["state"]
                            != "healthy"), 30.0,
                   "eviction of the killed replica")
            _await(lambda: sup.respawns >= 1 and sup.is_alive(1),
                   30.0, "supervisor respawn of replica 1")
            _await(lambda: (pool.stats()["replicas"]["1"]["state"]
                            == "healthy"), 30.0,
                   "re-admission of the respawned tp replica")
            before = traffic.served
            _await(lambda: traffic.served >= before + 3, 30.0,
                   "post-kill traffic")
            store_dir = tmp_path / "store"
            store_dir.mkdir()
            store = CheckpointStore(store_dir)
            cjnet, candidate = _gpt_pair(999)
            store.save(1, lambda p: write_model(candidate, p, atomic=False))
            pool.rolling_reload(store, step=1, drain_timeout=30.0)
            before = traffic.served
            _await(lambda: traffic.served >= before + 3, 30.0,
                   "post-reload traffic")
        assert traffic.failures == [], traffic.failures
        got = pool.generate(prompt, 4, temperature=0.0, seed=0,
                            timeout=60.0)
        np.testing.assert_array_equal(
            got, jax_generate(cjnet, prompt[None], 4, temperature=0.0)[0])
        st = pool.stats()
        assert st["rolling_reloads"] == 1
        assert st["healthy_replicas"] == 2
    finally:
        pool.shutdown(drain_timeout=5.0)


def test_autoscale_grow_kill9_shrink_cross_process(net, tmp_path):
    x = _data()[0]
    pool = spawn_replica_pool(
        net, 2, scratch_dir=tmp_path,
        pool_kwargs=dict(probe_batch=x[:2], **_POOL_KW),
        supervisor_kwargs=SUP_KW)
    sup = pool.supervisor
    try:
        np.testing.assert_allclose(pool.predict(x, timeout=30.0),
                                   _out(net, x), atol=1e-5)
        with _PoissonTraffic(pool, x[:8]) as traffic:
            _await(lambda: traffic.served >= 5, 30.0, "traffic warmup")
            rid = pool.grow_replica()
            assert sup.live_slots() == 3
            _await(lambda: (pool.stats()["replicas"][str(rid)]["state"]
                            == "healthy"),
                   30.0, "probe-ladder re-admission of the grown replica")
            assert pool.stats()["n_replicas"] == 3
            _await(lambda: traffic.served >= 15, 30.0,
                   "traffic through the grown pool")
            rep = next(r for r in pool._replicas if r.id == rid)
            port = int(rep.server.endpoint.rsplit(":", 1)[1])
            slot = sup.slot_for_port(port)
            shrunk = threading.Event()

            def shrink():
                pool.shrink_replica(rid, drain_timeout=20.0)
                shrunk.set()

            t = threading.Thread(target=shrink, daemon=True)
            t.start()
            try:
                sup.kill(slot)
            except ValueError:
                pass  # a fast drain retired the slot first
            t.join(timeout=30.0)
            assert shrunk.is_set(), "scale-down wedged on a dead victim"
            _await(lambda: traffic.served >= 25, 30.0,
                   "post-shrink traffic")
        assert traffic.failures == [], traffic.failures
        st = pool.stats()
        assert st["n_replicas"] == 2 and str(rid) not in st["replicas"]
        assert sup.live_slots() == 2
        time.sleep(0.6)  # two respawn windows: a retired slot stays down
        assert sup.live_slots() == 2 and not sup.is_alive(slot)
        events = pool.flight_record()["pool"]["events"]
        assert any(e["kind"] == "drain"
                   and e.get("reason") == "scale-down" for e in events)
        assert any(e["kind"] == "remove-replica"
                   and e.get("replica") == rid for e in events)
        assert any(e["kind"] == "add-replica"
                   and e.get("replica") == rid for e in events)
    finally:
        pool.shutdown(drain_timeout=5.0)


def test_replica_without_a_card_fails_typed_with_its_log(net, tmp_path):
    """A replica asked for the card where there is none never serves on
    the CPU: it dies at startup, and the supervisor raises the typed
    `ReplicaSpawnError` carrying the log tail that names the cause."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    model_path = tmp_path / "model.zip"
    write_model(net, model_path, atomic=False)
    sup = ReplicaSupervisor(model_path, 1, scratch_dir=tmp_path,
                            device="cuda", **SUP_KW)
    with pytest.raises(ReplicaSpawnError, match="no CUDA device") as ei:
        sup.start()
    assert "died during startup" in str(ei.value)
    assert not sup.is_alive(0)
