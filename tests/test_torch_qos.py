"""The port's QoS lanes (`DecodeEngine(qos=...)`, `submit(tenant=,
priority=)`) held against the JAX package on the CPU at small size
(vocab 48, d_model 32, 2 layers): token-bucket and page quotas shed the
tenant's own typed `TenantQuotaExceededError`, the door sweeps expired
entries before any capacity verdict, the SLO estimator sheds a provably
late request before prefill, interactive requests jump and preempt the
batch lane, and the batch lane is weighted-fair. A preempted greedy
request equals the JAX package's `generate` (f32), a preempted sampled
request its own unpreempted run, and the batch lane's admission order
equals the JAX engine's on the same traffic. The stats carry the JAX
package's key contracts.
"""
import signal
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    generate as jax_generate,
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.serving import DecodeEngine as JaxEngine  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    DeadlineExceededError,
    DecodeEngine,
    ModelServer,
    ServerOverloadedError,
    ServingError,
    TenantQuotaExceededError,
)
from deeplearning4j_tpu_torch.serving.observability import (  # noqa: E402
    DECODE_ENGINE_STATS_KEYS,
    TENANT_STATS_KEYS,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)

VOCAB = 48
WEDGE_GUARD_S = 120


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
    """A wedged preemption or drain path dies by SIGALRM instead of
    eating the tier's time."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def boom(signum, frame):
        raise TimeoutError(f"qos test exceeded the {WEDGE_GUARD_S} s guard")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(WEDGE_GUARD_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxNet(jax_gpt_configuration(vocab_size=VOCAB, d_model=32,
                                        n_heads=2, n_layers=2, max_length=64,
                                        seed=12345))
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    return jnet, pnet


def _prompt(t0=8, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, t0) \
        .astype(np.int32)


def _wait(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise TimeoutError(f"{what} not reached within {timeout}s")


def _engine(net, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("prompt_buckets", (8,))
    return DecodeEngine(net, device="cpu", **kw)


def _close(eng):
    """Shut down with the page ledger whole: free, owned and cached
    pages are `pool_pages` distinct ids."""
    with eng._cond:
        ids = list(eng._free_pages)
        for r in eng._slots:
            if r is not None and r.pages:
                ids += r.pages[r.n_shared:]
        if eng._prefix_cache is not None:
            ids += [n.page_id for n in eng._prefix_cache._nodes.values()]
    assert len(ids) == len(set(ids)) == eng.pool_pages
    eng.shutdown(drain_timeout=30.0)


# ---------------------------------------------------------- tenant quota
def test_qos_config_validation(nets):
    pnet = nets[1]
    with pytest.raises(ValueError, match="qos"):
        _engine(pnet, qos={"typo": {}})
    with pytest.raises(ValueError, match="rate"):
        _engine(pnet, qos={"tenants": {"t": {"rate": -1}}})
    with pytest.raises(ValueError, match="max_pages"):
        _engine(pnet, qos={"default": {"max_pages": 0}})
    with pytest.raises(ValueError, match="weight"):
        _engine(pnet, qos={"tenants": {"t": {"weight": 0}}})
    with pytest.raises(ValueError, match="tenant keys"):
        _engine(pnet, qos={"tenants": {"t": {"ceiling": 1}}})


def test_tenant_quota_typed_rejection_and_isolation(nets):
    eng = _engine(nets[1], qos={"tenants": {"flood": {"rate": 10,
                                                       "burst": 8}}})
    try:
        p = _prompt()
        r = eng.submit(p, 8, tenant="flood", priority="batch")
        with pytest.raises(TenantQuotaExceededError) as ei:
            eng.submit(p, 8, tenant="flood", priority="batch")
        assert ei.value.retry_after > 0
        assert not isinstance(ei.value, ServerOverloadedError)
        assert len(r.result(timeout=60.0)) == 8
        assert len(eng.submit(p, 4, tenant="user").result(timeout=60.0)) == 4
        st = eng.stats()
        assert st["shed_quota"] == 1
        assert st["tenants"]["flood"]["shed_quota"] == 1
        assert st["tenants"]["flood"]["served"] == 1
        assert st["tenants"]["flood"]["tokens_generated"] == 8
        assert st["tenants"]["user"]["shed_quota"] == 0
        assert any(e["kind"] == "quota-shed" and e.get("tenant") == "flood"
                   for e in eng.recorder.dump()["events"])
    finally:
        _close(eng)


def test_set_tenant_quota_at_runtime(nets):
    eng = _engine(nets[1])
    try:
        p = _prompt()
        eng.submit(p, 4, tenant="t").result(timeout=60.0)
        eng.set_tenant_quota("t", rate=1, burst=4)
        r = eng.submit(p, 4, tenant="t")
        with pytest.raises(TenantQuotaExceededError):
            eng.submit(p, 4, tenant="t")
        r.result(timeout=60.0)
        eng.set_tenant_quota("t", rate=None)
        eng.submit(p, 4, tenant="t").result(timeout=60.0)
        assert eng.stats()["tenants"]["t"]["served"] == 3
        with pytest.raises(ValueError, match="weight"):
            eng.set_tenant_quota("t", weight=-1)
    finally:
        _close(eng)


def test_default_quota_applies_to_unknown_tenants(nets):
    eng = _engine(nets[1], qos={"default": {"rate": 5, "burst": 4}})
    try:
        p = _prompt()
        r = eng.submit(p, 4, tenant="anyone")
        with pytest.raises(TenantQuotaExceededError):
            eng.submit(p, 4, tenant="anyone")
        r.result(timeout=60.0)
        eng.submit(p, 4).result(timeout=60.0)  # untenanted: unlimited
    finally:
        _close(eng)


def test_shed_by_shared_limit_does_not_burn_quota(nets):
    eng = _engine(nets[1], n_slots=1, max_queue=1,
                  qos={"tenants": {"t": {"rate": 100, "burst": 100}}})
    try:
        p = _prompt()
        occ1 = eng.submit(p, 12, tenant="t")
        _wait(lambda: eng.stats()["queued"] == 0)
        occ2 = eng.submit(p, 12, tenant="t")
        with pytest.raises(ServerOverloadedError):
            eng.submit(p, 12, tenant="t")
        with eng._cond:
            spent = 100 - eng._tenants["t"].tokens
        assert spent <= 24.001
        occ1.result(timeout=60.0)
        occ2.result(timeout=60.0)
    finally:
        _close(eng)


# ------------------------------------------------------------ door order
def test_engine_queue_full_of_corpses_sweeps_before_overload(nets):
    eng = _engine(nets[1], n_slots=1, max_queue=2)
    try:
        p = _prompt()
        eng.submit(p, 2).result(timeout=60.0)
        blocker = eng.submit(p, 36)
        _wait(lambda: eng.stats()["queued"] == 0)
        corpses = [eng.submit(p, 2, timeout=0.02) for _ in range(2)]
        time.sleep(0.05)
        live = eng.submit(p, 2, timeout=60.0)
        assert len(live.result(timeout=60.0)) == 2
        for c in corpses:
            with pytest.raises(DeadlineExceededError):
                c.result(timeout=60.0)
        blocker.result(timeout=60.0)
        assert eng.stats()["shed_deadline"] >= 2
        assert eng.stats()["shed_overload"] == 0
    finally:
        _close(eng)


def test_server_queue_full_of_corpses_sweeps_before_overload():
    """The same contract at the `ModelServer` predict door."""
    conf = (PC.NeuralNetConfiguration.Builder().seed(7).learning_rate(0.3)
            .list().layer(PC.DenseLayer(n_in=4, n_out=8))
            .layer(PC.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss="mcxent")).build())
    mlp = MultiLayerNetwork(conf, device="cpu")
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    release = threading.Event()

    def slow(phase, info):
        if phase == "pre_step":
            release.wait(0.15)

    srv = ModelServer(mlp, max_queue=2, max_batch_size=4, batch_window=0.0)
    try:
        srv.predict(x)
        srv.infer_hooks.append(slow)
        results, errors = [], []

        def call(timeout):
            try:
                results.append(srv.predict(x, timeout=timeout))
            except ServingError as e:
                errors.append(e)

        first = threading.Thread(target=call, args=(60.0,))
        first.start()
        time.sleep(0.03)
        corpses = [threading.Thread(target=call, args=(0.02,))
                   for _ in range(2)]
        for t in corpses:
            t.start()
        time.sleep(0.06)
        live = threading.Thread(target=call, args=(60.0,))
        live.start()
        for t in [first, *corpses, live]:
            t.join()
        release.set()
        assert len(results) == 2 and len(errors) == 2
        assert all(isinstance(e, DeadlineExceededError) for e in errors)
        assert srv.stats()["shed_overload"] == 0
    finally:
        srv.shutdown(drain_timeout=30.0)


# --------------------------------------------------------------- SLO shed
def test_slo_shed_rejects_unmeetable_deadline_before_prefill(nets):
    eng = _engine(nets[1], qos={"slo_shed": True})
    try:
        p = _prompt()
        eng.submit(p, 8).result(timeout=60.0)
        before = eng.stats()
        with pytest.raises(DeadlineExceededError, match="unmeetable"):
            eng.submit(p, 30, timeout=0.002)
        st = eng.stats()
        assert st["slo_sheds"] == 1 and st["shed_deadline"] == 0
        assert st["prefills"] == before["prefills"]
        ev = [e for e in eng.recorder.dump()["events"]
              if e["kind"] == "slo-shed"]
        assert ev and "estimate_s" in ev[0] and "budget_s" in ev[0]
    finally:
        _close(eng)


def test_slo_shed_off_by_default(nets):
    eng = _engine(nets[1])
    try:
        p = _prompt()
        eng.submit(p, 4).result(timeout=60.0)
        try:
            eng.submit(p, 12, timeout=1e-4).result(timeout=60.0)
        except DeadlineExceededError:
            pass  # expiring later is the old contract; the door must not
        assert eng.stats()["slo_sheds"] == 0
    finally:
        _close(eng)


# ------------------------------------------------------------- preemption
@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "sampled"])
def test_interactive_preempts_batch_and_batch_result_is_unchanged(
        nets, temperature):
    """The batch occupant yields its slot to an interactive request and
    resumes from its folded prompt with its own generator: greedy, its
    tokens equal the JAX package's `generate`; sampled, its own
    unpreempted run with the same seed."""
    jnet, pnet = nets
    p_batch, p_int = _prompt(8, seed=1), _prompt(8, seed=2)

    def drag(phase, info):
        if phase == "pre_decode":
            time.sleep(0.01)

    eng = _engine(pnet, n_slots=1, qos={"preempt": True},
                  step_hooks=[drag], decode_chunk=1)
    try:
        ref = eng.submit(p_batch, 24, temperature=temperature,
                         seed=5).result(timeout=60.0)
        if temperature == 0.0:
            np.testing.assert_array_equal(
                ref, jax_generate(jnet, p_batch[None], 24,
                                  temperature=0.0)[0])
        victim = eng.submit(p_batch, 24, temperature=temperature, seed=5,
                            tenant="bulk", priority="batch")
        _wait(lambda: len(victim.tokens) >= 3, 30.0, "batch tokens")
        urgent = eng.submit(p_int, 4, tenant="live", priority="interactive")
        assert len(urgent.result(timeout=60.0)) == 4
        np.testing.assert_array_equal(victim.result(timeout=60.0), ref)
        st = eng.stats()
        assert st["preemptions"] == 1
        assert st["tenants"]["bulk"]["preemptions"] == 1
        ev = [e for e in eng.recorder.dump()["events"]
              if e["kind"] == "preempt"]
        assert ev[0]["tenant"] == "bulk" and ev[0]["head_tenant"] == "live"
    finally:
        _close(eng)


def test_page_pressure_preempts_batch_through_the_prefix_cache(nets):
    """A page-blocked interactive head preempts a decoding batch slot;
    the victim's prompt pages were promoted into the prefix cache, so its
    re-prefill binds them as a hit, and its tokens are unchanged."""
    jnet, pnet = nets
    p_batch, p_int = _prompt(20, seed=3), _prompt(20, seed=4)
    want = jax_generate(jnet, p_batch[None], 12, temperature=0.0)[0]

    def drag(phase, info):
        if phase == "pre_decode":
            time.sleep(0.01)

    eng = _engine(pnet, n_slots=2, page_size=8, prefill_chunk=8,
                  prompt_buckets=(4,), pool_pages=4, decode_chunk=1,
                  prefix_cache=True, qos={"preempt": True},
                  step_hooks=[drag])
    try:
        victim = eng.submit(p_batch, 12, tenant="bulk", priority="batch")
        _wait(lambda: len(victim.tokens) >= 2, 30.0, "batch tokens")
        urgent = eng.submit(p_int, 4, priority="interactive")
        assert len(urgent.result(timeout=60.0)) == 4
        np.testing.assert_array_equal(victim.result(timeout=60.0), want)
        st = eng.stats()
        assert st["preemptions"] >= 1
        assert st["prefix_cache"]["hits"] >= 1
    finally:
        _close(eng)


def test_no_preemption_between_equals(nets):
    for qos in (None, {"preempt": True}):
        eng = _engine(nets[1], n_slots=1, qos=qos)
        try:
            eng.submit(_prompt(), 4).result(timeout=60.0)
            first = eng.submit(_prompt(8, 3), 10, priority="batch")
            second = eng.submit(_prompt(8, 4), 4, priority="batch")
            first.result(timeout=60.0)
            second.result(timeout=60.0)
            assert eng.stats()["preemptions"] == 0
        finally:
            _close(eng)


def test_interactive_selected_from_queue_ahead_of_batch(nets):
    eng = _engine(nets[1], n_slots=1)
    try:
        eng.submit(_prompt(), 4).result(timeout=60.0)
        blocker = eng.submit(_prompt(8, 5), 16)
        batch = [eng.submit(_prompt(8, 6 + i), 8, priority="batch")
                 for i in range(2)]
        urgent = eng.submit(_prompt(8, 9), 8, priority="interactive")
        urgent.result(timeout=60.0)
        batch_done = [len(b.tokens) == 8 for b in batch]
        blocker.result(timeout=60.0)
        for b in batch:
            b.result(timeout=60.0)
        assert not all(batch_done)
    finally:
        _close(eng)


# --------------------------------------------------- batch-lane fairness
def _hold(dt=0.02):
    def hook(phase, info):
        if phase == "pre_decode":
            time.sleep(dt)
    return hook


def _batch_admits(eng, tenants):
    return [e["tenant"] for e in eng.flight_record()["events"]
            if e["kind"] == "admit" and e.get("tenant") in tenants]


def _wfq_run(eng, tenants, submit_kw=None):
    eng.submit(_prompt(), 4).result(timeout=60.0)
    blocker = eng.submit(_prompt(8, 5), 24)
    reqs = [eng.submit(_prompt(8, 10 + i), 4, tenant=tenants[0],
                       priority="batch") for i in range(6)]
    reqs += [eng.submit(_prompt(8, 20 + i), 4, tenant=tenants[1],
                        priority="batch") for i in range(6)]
    blocker.result(timeout=60.0)
    for r in reqs:
        r.result(timeout=120.0)
    return _batch_admits(eng, tenants)


def test_wfq_equal_weight_batch_tenants_split_admission_evenly(nets):
    eng = _engine(nets[1], n_slots=1, step_hooks=[_hold()], pool_pages=8,
                  max_queued_pages=64)
    try:
        admits = _wfq_run(eng, ("a", "b"))
        assert len(admits) == 12
        for k in range(1, 13):
            assert abs(admits[:k].count("a") - admits[:k].count("b")) <= 1
    finally:
        _close(eng)


def test_wfq_weight_two_tenant_gets_double_share_as_the_jax_engine(nets):
    """The stride-scheduled admission order is deterministic: the port
    admits the same tenant sequence as the JAX engine on the same
    traffic, and the weight-2 tenant's backlog is in before the peer's
    fourth."""
    jnet, pnet = nets
    kw = dict(n_slots=1, max_len=48, prompt_buckets=(8,), pool_pages=8,
              max_queued_pages=64, step_hooks=[_hold()],
              qos={"tenants": {"heavy": {"weight": 2.0}}})
    jeng = JaxEngine(jnet, **kw)
    try:
        jadmits = _wfq_run(jeng, ("heavy", "light"))
    finally:
        jeng.shutdown(drain_timeout=30.0)
    eng = DecodeEngine(pnet, device="cpu", **kw)
    try:
        admits = _wfq_run(eng, ("heavy", "light"))
    finally:
        _close(eng)
    assert admits == jadmits
    sixth_heavy = [i for i, t in enumerate(admits) if t == "heavy"][5]
    fourth_light = [i for i, t in enumerate(admits) if t == "light"][3]
    assert sixth_heavy < fourth_light


# ---------------------------------------------------------- stats contract
def test_decode_engine_qos_stats_contract(nets):
    eng = _engine(nets[1], qos={"tenants": {"t": {"rate": 5, "burst": 5}}})
    try:
        eng.submit(_prompt(), 2, tenant="t").result(timeout=60.0)
        st = eng.stats()
        assert DECODE_ENGINE_STATS_KEYS <= set(st)
        assert set(st["tenants"]["t"]) == set(TENANT_STATS_KEYS)
        assert st["tp_degree"] == 1
    finally:
        _close(eng)


def test_model_server_carries_the_qos_lane(nets):
    """`ModelServer(generation={..., "qos"})` reaches the engine: the
    server's `set_tenant_quota` and `generate(tenant=)` shed the
    tenant's own quota, and its stats carry the QoS counters."""
    srv = ModelServer(nets[1], generation={
        "n_slots": 1, "max_len": 48, "prompt_buckets": (8,),
        "qos": {"tenants": {}}})
    try:
        srv.set_tenant_quota("t", rate=1, burst=4)
        assert len(srv.generate(_prompt(), 4, tenant="t")) == 4
        with pytest.raises(TenantQuotaExceededError):
            srv.generate(_prompt(), 4, tenant="t")
        st = srv.stats()
        assert st["shed_quota"] == 1 and st["preemptions"] == 0
        assert st["generation"]["tenants"]["t"]["served"] == 1
    finally:
        srv.shutdown()
