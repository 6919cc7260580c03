"""The port's `Autoscaler` (`serving.autoscaler`) held against the JAX
package on the CPU: the same scripted pressure over a stub pool gives
the same `tick()` decisions, recorded events and stats in both packages
(the EWMA, the hysteresis, the cooldown, the bounds, the engine
saturation and p99-excursion terms); a failed spawn is typed, counted
and not fatal; and on a real port pool a scale cycle enters the new
replica evicted and readmits it through the probes, a closed loop under
a `LoadSpikeInjector` scales up and back down with no failed request,
and a scale-down is not pinned by a long generation: the slot migrates,
and the tokens equal the JAX package's greedy `generate` (vocab 48,
d_model 32, 2 layers).
"""
import signal
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
from deeplearning4j_tpu.serving import autoscaler as jax_autoscaler  # noqa: E402
from deeplearning4j_tpu.serving import model_server as jax_ms  # noqa: E402
from deeplearning4j_tpu.serving.observability import (  # noqa: E402
    AUTOSCALER_STATS_KEYS as JAX_AUTOSCALER_STATS_KEYS,
)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    AutoscaleError,
    Autoscaler,
    LoadSpikeInjector,
    ModelServer,
    ReplicaPool,
)
from deeplearning4j_tpu_torch.serving import autoscaler  # noqa: E402
from deeplearning4j_tpu_torch.serving import model_server as ms  # noqa: E402
from deeplearning4j_tpu_torch.serving.observability import (  # noqa: E402
    AUTOSCALER_STATS_KEYS,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)

VOCAB = 48
WEDGE_GUARD_S = 120
GEN = {"n_slots": 2, "max_len": 48, "prompt_buckets": (8,)}
PKGS = {"port": (autoscaler, ms), "jax": (jax_autoscaler, jax_ms)}


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
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def boom(signum, frame):
        raise TimeoutError(
            f"autoscaler test exceeded the {WEDGE_GUARD_S} s guard")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(WEDGE_GUARD_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _port_twin(jnet):
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    return pnet


@pytest.fixture(scope="module")
def mlp():
    jnet = JaxNet(dl4j.NeuralNetConfiguration.Builder()
                  .seed(7).learning_rate(0.3).list()
                  .layer(JaxDense(n_in=4, n_out=8))
                  .layer(JaxOutput(n_in=8, n_out=3,
                                   activation=Activation.SOFTMAX,
                                   loss=LossFunction.MCXENT)).build())
    jnet.init()
    return _port_twin(jnet)


@pytest.fixture(scope="module")
def gpts():
    jnet = JaxNet(jax_gpt_configuration(vocab_size=VOCAB, d_model=32,
                                        n_heads=2, n_layers=2, max_length=64,
                                        seed=12345))
    jnet.init()
    return jnet, _port_twin(jnet)


def _wait(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise TimeoutError(f"{what} not reached within {timeout}s")


# ------------------------------------------------------ the stub pool
class _Recorder:
    def __init__(self):
        self.events = []

    def event(self, kind, **attrs):
        self.events.append(dict(attrs, kind=kind, wall_time=time.time()))

    def dump(self):
        return {"events": list(self.events)}


class _Metrics:
    def __init__(self):
        self.components = {}

    def register_stats(self, name, fn):
        self.components[name] = fn


class _StubPool:
    """A scripted pool: `load` drives pool in-flight over the budget,
    `slots` the engines' slot occupancy (None: no generation), `sick`
    the replica ids that are not healthy."""

    def __init__(self):
        self.recorder = _Recorder()
        self.metrics = _Metrics()
        self.n_replicas = 1
        self.load = 0.0
        self.slots = None
        self.sick = ()
        self.removed = []
        self._next = 1

    def stats(self):
        reps = {}
        for i in range(self.n_replicas):
            s = {"state": "evicted" if i in self.sick else "healthy",
                 "queued": 0, "queue_depth": 8, "in_flight": i}
            if self.slots is not None:
                s["generation"] = {"active_slots": self.slots, "n_slots": 4,
                                   "pages_in_use": 1, "pool_pages": 100,
                                   "queued_page_demand": 0,
                                   "max_queued_pages": 100}
            reps[str(i)] = s
        return {"pool_in_flight": int(self.load * 64),
                "admission_budget": 64, "replicas": reps}

    def add_replica(self, server):
        self.n_replicas += 1
        rid, self._next = self._next, self._next + 1
        return rid

    def remove_replica(self, replica_id, *, drain_timeout=30.0):
        self.n_replicas -= 1
        self.removed.append(replica_id)

        class _Srv:
            def shutdown(self):
                pass
        return _Srv()


def _scaler(mod, pool, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("interval", 0.01)
    kw.setdefault("alpha", 1.0)
    kw.setdefault("hysteresis", 2)
    kw.setdefault("cooldown", 0.0)
    kw.setdefault("spawn", lambda: None)
    return mod.Autoscaler(pool, **kw)


def _drive(mod, script, **kw):
    """Run `script` (per tick: load, slots, sick replicas, excursion
    events to pin first) through one package's Autoscaler on a fresh
    stub pool: the decisions, the stats and the autoscale events, less
    their wall-clock readings."""
    pool = _StubPool()
    s = _scaler(mod, pool, **kw)
    out = []
    for load, slots, sick, pins in script:
        pool.load, pool.slots, pool.sick = load, slots, sick
        for _ in range(pins):
            pool.recorder.event("excursion", replica=0)
        try:
            out.append(s.tick())
        except Exception as e:  # the trace records the typed error
            out.append((type(e).__name__, str(e)))
    st = s.stats()
    # wall-clock readings: whether the cooldown runs, not how long is left;
    # a scale-down's duration is timed, not scripted
    st["cooldown_remaining"] = st["cooldown_remaining"] > 0
    st["last_scale_down_ms"] = st["last_scale_down_ms"] > 0 \
        or st["scale_downs"] > 0
    events = [{k: v for k, v in e.items()
               if k not in ("wall_time", "duration_ms")}
              for e in pool.recorder.events if e["kind"] == "autoscale"]
    return out, st, events, pool.n_replicas, pool.removed


def _t(load, slots=None, sick=(), pins=0):
    return (load, slots, sick, pins)


SCRIPTS = {
    "hysteresis_and_watermarks": ({}, [_t(0.9), _t(0.9)] + [_t(0.5)] * 3
                                  + [_t(0.05), _t(0.05)]),
    "between_watermarks_resets": ({}, [_t(0.9), _t(0.5), _t(0.9), _t(0.5),
                                       _t(0.05), _t(0.5), _t(0.05)]),
    "cooldown_blocks": ({"cooldown": 60.0, "max_replicas": 4},
                        [_t(0.9)] * 8),
    "upper_bound": ({"max_replicas": 2}, [_t(0.95)] * 6),
    "lower_bound": ({}, [_t(0.0)] * 5),
    "ewma_smooths_a_spike": ({"alpha": 0.3}, [_t(1.0), _t(0.0), _t(1.0),
                                              _t(1.0), _t(1.0), _t(1.0),
                                              _t(1.0), _t(0.0)]),
    "engine_slots_saturate": ({}, [_t(0.0, slots=4)] * 3
                              + [_t(0.0, slots=0)] * 3),
    "evicted_replica_ignored": ({}, [_t(0.0, slots=4, sick=(0,))] * 3),
    "excursions_push_pressure": ({"excursion_weight": 0.5},
                                 [_t(0.0, pins=2), _t(0.0, pins=2),
                                  _t(0.0), _t(0.0)]),
    "hysteresis_three": ({"hysteresis": 3, "max_replicas": 4},
                         [_t(0.8)] * 7),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tick_decisions_equal_the_jax_autoscalers(name):
    kw, script = SCRIPTS[name]
    got = _drive(autoscaler, script, **kw)
    want = _drive(jax_autoscaler, script, **kw)
    assert got == want
    assert set(got[1]) == AUTOSCALER_STATS_KEYS


def test_stats_keys_and_registration_are_the_contract():
    assert AUTOSCALER_STATS_KEYS == JAX_AUTOSCALER_STATS_KEYS
    pool = _StubPool()
    s = _scaler(autoscaler, pool)
    assert pool.metrics.components["autoscaler"] == s.stats
    assert set(s.stats()) == AUTOSCALER_STATS_KEYS


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_validation(pkg):
    mod, _ = PKGS[pkg]
    for kw, match in (({"min_replicas": 0}, "min_replicas"),
                      ({"min_replicas": 3, "max_replicas": 2},
                       "max_replicas"),
                      ({"interval": 0}, "interval"),
                      ({"alpha": 0.0}, "alpha"),
                      ({"low_watermark": 0.8}, "watermarks"),
                      ({"hysteresis": 0}, "hysteresis")):
        with pytest.raises(ValueError, match=match):
            mod.Autoscaler(_StubPool(), **kw)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_bounds_and_missing_paths_are_typed(pkg):
    mod, msmod = PKGS[pkg]
    s = _scaler(mod, _StubPool(), max_replicas=1)
    with pytest.raises(msmod.AutoscaleError, match="max_replicas"):
        s.scale_up()
    with pytest.raises(msmod.AutoscaleError, match="min_replicas"):
        s.scale_down()
    pool = _StubPool()
    s = _scaler(mod, pool, spawn=None)
    with pytest.raises(msmod.AutoscaleError, match="no scale-up path"):
        s.scale_up()
    pool.n_replicas, pool.sick = 2, (0, 1)
    with pytest.raises(msmod.AutoscaleError, match="no healthy replica"):
        s.scale_down()
    assert s.stats()["autoscale_failures"] == 1


def test_failed_spawn_is_typed_counted_and_not_fatal():
    pool = _StubPool()

    def bad_spawn():
        raise RuntimeError("no capacity")

    s = _scaler(autoscaler, pool, spawn=bad_spawn)
    with pytest.raises(AutoscaleError, match="no capacity"):
        s.scale_up()
    assert pool.n_replicas == 1
    assert s.stats()["autoscale_failures"] == 1
    assert any(e["direction"] == "up-failed"
               for e in pool.recorder.events if e["kind"] == "autoscale")
    # the control loop outlives a failing tick: counted, recorded
    pool.load = 0.95
    s.start()
    _wait(lambda: s.stats()["autoscale_failures"] >= 2, 10.0,
          "a failed tick in the loop")
    s.stop()
    assert s._thread is not None and not s._thread.is_alive()
    assert any(e.get("direction") == "error" for e in pool.recorder.events)


def test_scale_down_picks_the_least_loaded_healthy_replica():
    pool = _StubPool()
    pool.n_replicas = 3
    s = _scaler(autoscaler, pool)
    assert s._pick_victim() == 0
    pool.sick = (0,)
    assert s.scale_down() == 1
    assert pool.removed == [1]
    assert s.stats()["last_scale_down_ms"] >= 0.0


# ------------------------------------------------------ real pools
def test_scale_cycle_on_a_real_pool(mlp):
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    pool = ReplicaPool.from_net(mlp, 1, probe_batch=x[:2],
                                probe_interval=0.05, readmit_successes=2)
    disposed = []
    scaler = Autoscaler(pool, min_replicas=1, max_replicas=2,
                        drain_timeout=10.0,
                        spawn=lambda: ModelServer(mlp.clone()),
                        dispose=lambda srv: (disposed.append(srv),
                                             srv.shutdown()))
    try:
        pool.predict(x, timeout=30.0)
        rid = scaler.scale_up()
        added = [e for e in pool.recorder.dump()["events"]
                 if e["kind"] == "add-replica"]
        assert added and added[0]["state"] == "evicted"
        _wait(lambda: pool.stats()["replicas"][str(rid)]["state"]
              == "healthy", what="readmission")
        assert pool.stats()["healthy_replicas"] == 2
        assert pool.stats()["readmissions"] >= 1
        scaler.scale_down()
        st = pool.stats()
        assert st["n_replicas"] == 1 and len(disposed) == 1
        assert st["replicas_added"] == 1 and st["replicas_removed"] == 1
        assert pool.predict(x, timeout=30.0).shape == (8, 3)
        sst = scaler.stats()
        assert sst["autoscale_events"] == 2 and sst["scale_ups"] == 1
        assert pool.metrics.snapshot() is not None
    finally:
        scaler.stop()
        pool.shutdown(drain_timeout=10.0)


def test_closed_loop_under_a_load_spike_fails_nothing(gpts):
    """The loop samples a saturated engine under a `LoadSpikeInjector`,
    scales up (the new replica readmitted by the probes), then scales
    back down once the spike ends; no spike request fails."""
    pnet = gpts[1]
    gen = dict(GEN, n_slots=1)
    pool = ReplicaPool.from_net(pnet, 1, server_kwargs={"generation": gen},
                                probe_interval=0.05, readmit_successes=2)
    scaler = Autoscaler(pool, min_replicas=1, max_replicas=2, interval=0.02,
                        alpha=1.0, high_watermark=0.6, low_watermark=0.2,
                        hysteresis=2, cooldown=0.2, drain_timeout=30.0,
                        spawn=lambda: ModelServer(pnet.clone(),
                                                  generation=gen))
    prompt = np.arange(8, dtype=np.int32) % VOCAB
    spike = LoadSpikeInjector(pool, prompt=prompt, n_tokens=6, concurrency=3,
                              timeout=60.0)
    try:
        pool.generate(prompt, 2, timeout=60.0)
        scaler.start()
        spike.start()
        _wait(lambda: scaler.stats()["scale_ups"] >= 1, what="scale-up")
        _wait(lambda: pool.healthy_replicas() == 2, what="readmission")
        _wait(lambda: spike.counters()["served"] >= 6, what="spike traffic")
        spike.release()
        _wait(lambda: scaler.stats()["scale_downs"] >= 1, what="scale-down")
        c = spike.counters()
        assert c["failures"] == 0 and c["sheds"] == 0 and c["served"] >= 6
        assert spike.p99() > 0.0
        ev = [e["direction"] for e in pool.recorder.dump()["events"]
              if e["kind"] == "autoscale"]
        assert ev[:2] == ["up", "down"]
    finally:
        spike.release()
        scaler.stop()
        pool.shutdown(drain_timeout=30.0)


def test_scale_down_is_not_pinned_by_a_long_generation(gpts):
    """Forced onto the replica holding a live generation, `scale_down`
    returns well before the decode's remaining time: the slot migrates
    warm to the survivor, and the caller gets the JAX package's
    tokens."""
    jnet, pnet = gpts

    def hold(phase, info):
        if phase == "pre_decode":
            time.sleep(0.08)

    gen = dict(GEN, max_len=64, decode_chunk=1, step_hooks=[hold])
    prompt = np.random.default_rng(5).integers(0, VOCAB, 8).astype(np.int32)
    n = 48  # ~3.8 s of held decode: a drain that waited would show
    want = np.asarray(jax_generate(jnet, prompt[None], n,
                                   temperature=0.0))[0]
    pool = ReplicaPool.from_net(pnet, 2, server_kwargs={"generation": gen},
                                probe_interval=30.0)
    scaler = Autoscaler(pool, min_replicas=1, max_replicas=2,
                        drain_timeout=60.0)
    res = {}
    try:
        warm = [threading.Thread(target=lambda: pool.generate(
            prompt[:4], 2, timeout=60.0)) for _ in range(2)]
        for w in warm:
            w.start()
        for w in warm:
            w.join(60.0)

        def run():
            res["out"] = pool.generate(prompt, n, timeout=120.0)

        t = threading.Thread(target=run)
        t.start()

        def busy():
            for rid, r in pool.stats()["replicas"].items():
                if r.get("generation", {}).get("active_slots", 0) > 0:
                    return int(rid)
            return None

        _wait(lambda: busy() is not None, what="a live decode slot")
        scaler._pick_victim = busy
        t0 = time.monotonic()
        scaler.scale_down()
        took = time.monotonic() - t0
        assert took < 2.0, f"scale_down waited on the decode: {took:.2f}s"
        assert scaler.stats()["last_scale_down_ms"] < 2000.0
        t.join(60.0)
        assert not t.is_alive()
        np.testing.assert_array_equal(res["out"], want)
        ps = pool.stats()
        assert ps["migrations"] >= 1 and ps["migration_fallbacks"] == 0
        assert ps["n_replicas"] == 1
    finally:
        scaler.stop()
        pool.shutdown(drain_timeout=30.0)
