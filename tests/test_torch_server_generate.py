"""Generation through the port's `ModelServer`, held against the JAX
package on the CPU with a 2-layer f32 GPT at narrow width (vocab 48,
d_model 32) loaded into both packages from one zip.

Greedy `server.generate` tokens equal the JAX server's (one-shot and
chunked prefill); `logprobs=K` returns the same top-K ids and values
within 1e-5; `on_token` is called once per token, in order; a reload
under active decode lets the in-flight request finish on the old weights
while the queued one runs on the new; a drain that times out raises with
the old weights serving; an engine that refuses a swap rolls the predict
path back; `restore_model` with the same net keeps the pools; engine
failures open the breaker the server shares. Also the engine seams
themselves: the door checks, the p99-excursion pin, the swap that
re-reserves queued requests, and the stubs of the cluster tier.
"""
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    generate as jax_generate,
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.serving import ModelServer as JaxServer  # noqa: E402
from deeplearning4j_tpu.util.serialization import (  # noqa: E402
    write_model as jax_write_model,
)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    DecodeEngine,
    InferenceFailedError,
    ModelServer,
    PrefixCache,
    ServerClosedError,
    ServiceUnavailableError,
    ServingError,
    maybe_trace,
)
from deeplearning4j_tpu_torch.serving.decode_engine import (  # noqa: E402
    _lp_math,
)
from deeplearning4j_tpu_torch.util.checkpoint_store import (  # noqa: E402
    CheckpointStore,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    restore_model,
)


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


VOCAB = 48
WAIT = 30.0  # the bound of every wait on another thread


def _wait_until(pred, what: str, timeout: float = WAIT) -> None:
    end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.002)


class StepGate:
    """A step hook that holds the scheduler at `phase` until `release`
    is set; `entered` is set once a step is held."""

    def __init__(self, phase: str = "pre_decode"):
        self.phase = phase
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, phase, info):
        if phase == self.phase:
            self.entered.set()
            if not self.release.wait(WAIT):
                raise TimeoutError("gate never released")


def _gpt(seed, tmp_path_factory, name, max_length=64):
    jnet = JaxNet(jax_gpt_configuration(vocab_size=VOCAB, d_model=32,
                                        n_heads=2, n_layers=2,
                                        max_length=max_length, seed=seed))
    jnet.init()
    path = tmp_path_factory.mktemp(name) / f"{name}.zip"
    jax_write_model(jnet, path)
    return jnet, restore_model(path, device="cpu"), path


@pytest.fixture(scope="module")
def old(tmp_path_factory):
    return _gpt(1, tmp_path_factory, "old")


@pytest.fixture(scope="module")
def new(tmp_path_factory):
    return _gpt(2, tmp_path_factory, "new")


@pytest.fixture(scope="module")
def store(new, tmp_path_factory):
    """A checkpoint store holding the `new` weights at step 1."""
    d = tmp_path_factory.mktemp("store")
    s = CheckpointStore(d)
    s.save(1, lambda tmp: jax_write_model(new[0], tmp, atomic=False))
    return s


def _prompts(n, t0, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, t0)) \
        .astype(np.int32)


GEN = {"n_slots": 2, "max_len": 40, "prompt_buckets": (8,),
       "prefill_chunk": 8, "page_size": 8}


@pytest.fixture()
def servers():
    made = []

    def make(net, cls=ModelServer, **kw):
        srv = cls(net, **kw)
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.shutdown(drain_timeout=10.0)


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("t0", [5, 20])
def test_greedy_generate_matches_the_jax_server(old, servers, t0):
    """t0 = 5 prefills one-shot, t0 = 20 in chunks of 8."""
    jnet, pnet, _ = old
    prompts = _prompts(3, t0, seed=t0)
    srv = servers(pnet, generation=dict(GEN))
    jsrv = servers(jnet, cls=JaxServer, generation=dict(GEN))
    for p in prompts:
        np.testing.assert_array_equal(srv.generate(p, 8),
                                      jsrv.generate(p, 8))
    stats = srv.stats()
    assert stats["generation"]["served"] == 3
    assert (stats["prefill_chunks"] > 0) == (t0 > 8)


def test_logprobs_match_the_jax_server(old, servers):
    jnet, pnet, _ = old
    p = _prompts(1, 6, seed=3)[0]
    gen = dict(GEN, logprobs=3)
    got = servers(pnet, generation=gen).generate(p, 7, logprobs=3)
    want = servers(jnet, cls=JaxServer, generation=gen).generate(
        p, 7, logprobs=3)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert len(got["logprobs"]) == len(want["logprobs"]) == 7
    for g, w in zip(got["logprobs"], want["logprobs"]):
        assert g["token"] == w["token"]
        assert g["top_tokens"] == w["top_tokens"]
        np.testing.assert_allclose(g["top_logprobs"], w["top_logprobs"],
                                   atol=1e-5)
        assert abs(g["logprob"] - w["logprob"]) <= 1e-5
        assert g["top_logprobs"] == sorted(g["top_logprobs"], reverse=True)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_top_k_ties_keep_the_lower_id_first_as_jax_does(k):
    logits = np.array([[0.5, 2.0, 2.0, -1.0, 2.0, 0.5, 0.5, 2.0],
                       [1.0] * 8], np.float32)
    chosen = np.array([2, 5])
    lp, top_v, top_i = _lp_math(torch.from_numpy(logits),
                                torch.from_numpy(chosen), k)
    lsm = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    want_v, want_i = jax.lax.top_k(lsm, k)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(top_v.numpy(), np.asarray(want_v), atol=1e-6)
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(lsm)[np.arange(2), chosen], atol=1e-6)


def test_on_token_is_called_once_per_token_in_order(old, servers):
    _, pnet, _ = old
    srv = servers(pnet, generation=dict(GEN, logprobs=2))
    seen = []
    out = srv.generate(_prompts(1, 5)[0], 6, logprobs=2,
                       on_token=lambda c, t, e: seen.append((c, t, e)))
    assert [c for c, _, _ in seen] == list(range(1, 7))
    assert [t for _, t, _ in seen] == list(out["tokens"])
    assert [e for _, _, e in seen] == out["logprobs"]


def test_a_raising_sink_is_detached_and_the_result_delivers(old, servers):
    _, pnet, _ = old
    srv = servers(pnet, generation=dict(GEN))
    calls = []

    def sink(cursor, token, entry):
        calls.append(cursor)
        raise RuntimeError("consumer bug")

    p = _prompts(1, 5)[0]
    out = srv.generate(p, 5, on_token=sink)
    assert calls == [1] and len(out) == 5
    np.testing.assert_array_equal(out, srv.generate(p, 5))


# ----------------------------------------------------------- hot reload
def test_reload_under_active_decode(old, new, store, servers):
    """The in-flight request finishes on the old weights (its KV pages
    were computed with them); the request queued behind it, and every
    later one, runs on the new."""
    jold, pold, _ = old
    jnew = new[0]
    gate = StepGate()
    srv = servers(pold, auto_canary=False,
                  generation=dict(GEN, n_slots=1, step_hooks=[gate],
                                  decode_chunk=1))
    engine = srv._ensure_engine()
    prompts = _prompts(2, 5, seed=23)
    in_flight = engine.submit(prompts[0], 12)
    assert gate.entered.wait(WAIT)
    assert in_flight.tokens  # prefilled, held at its first decode step
    queued = engine.submit(prompts[1], 6)
    assert srv.pending() == 2
    got = {}
    r = threading.Thread(target=lambda: got.update(v=srv.reload(store)))
    r.start()
    _wait_until(lambda: engine._draining, "the engine draining")
    gate.release.set()
    r.join(WAIT)
    assert not r.is_alive() and got["v"] == 1
    np.testing.assert_array_equal(
        in_flight.result(timeout=WAIT),
        jax_generate(jold, prompts[:1], 12, temperature=0.0)[0])
    np.testing.assert_array_equal(
        queued.result(timeout=WAIT),
        jax_generate(jnew, prompts[1:2], 6, temperature=0.0)[0])
    np.testing.assert_array_equal(
        srv.generate(prompts[0], 4),
        jax_generate(jnew, prompts[:1], 4, temperature=0.0)[0])
    assert srv.stats()["generation"]["swaps"] == 1
    kinds = [(e["kind"], e.get("decision")) for e in
             srv.flight_record()["events"]
             if e["kind"] in ("drain", "swap", "reload")]
    assert kinds == [("drain", None), ("swap", "complete"),
                     ("reload", "complete")]


def test_drain_timeout_raises_with_the_old_weights_serving(old, new,
                                                           servers):
    jold, pold, _ = old
    gate = StepGate()
    srv = servers(pold, generation=dict(GEN, n_slots=1, step_hooks=[gate],
                                        decode_chunk=1))
    engine = srv._ensure_engine()
    p = _prompts(1, 5, seed=4)
    req = engine.submit(p[0], 6)
    assert gate.entered.wait(WAIT)
    with pytest.raises(ServingError, match="did not complete"):
        engine.drain_and_swap(new[1], timeout=0.1)
    gate.release.set()
    want = jax_generate(jold, p, 6, temperature=0.0)[0]
    np.testing.assert_array_equal(req.result(timeout=WAIT), want)
    np.testing.assert_array_equal(srv.generate(p[0], 6), want)
    assert engine.stats()["swaps"] == 0


def test_a_refused_engine_swap_rolls_the_predict_path_back(old, store,
                                                            servers,
                                                            monkeypatch):
    _, pold, _ = old
    srv = servers(pold, generation=dict(GEN))
    ids = _prompts(2, 6)
    before = srv.predict(ids)
    engine = srv._ensure_engine()

    def refuse(net, timeout=None):
        raise ServingError("swap refused")

    monkeypatch.setattr(engine, "drain_and_swap", refuse)
    with pytest.raises(ServingError, match="swap refused"):
        srv.reload(store)
    stats = srv.stats()
    assert stats["model_version"] == 2  # the swap and its rollback
    assert stats["reload_rejections"] == 1 and stats["reloads"] == 0
    assert srv.net is pold
    np.testing.assert_allclose(srv.predict(ids), before, atol=0)
    assert [e["decision"] for e in srv.flight_record()["events"]
            if e["kind"] == "reload"] == ["rolled-back"]


def test_restore_model_with_the_same_net_keeps_the_pools(old, servers):
    _, pold, _ = old
    srv = servers(pold, generation=dict(GEN, prefix_cache=True))
    srv.generate(_prompts(1, 17, seed=5)[0], 4)
    cached = srv.stats()["generation"]["prefix_cache"]["cached_pages"]
    assert cached > 0
    assert srv.restore_model(srv.net) == 1
    gen = srv.stats()["generation"]
    assert gen["swaps"] == 1
    assert gen["prefix_cache"]["cached_pages"] == cached
    swaps = [e["decision"] for e in srv.flight_record()["events"]
             if e["kind"] == "swap"]
    assert swaps == ["preserved-pools"]


def test_a_swap_fails_queued_requests_that_no_longer_fit(old, new,
                                                         tmp_path_factory):
    """Queued requests are re-reserved against the swapped geometry: one
    longer than the new max_len fails typed, one that fits runs."""
    _, pold, _ = old
    _, short, _ = _gpt(3, tmp_path_factory, "short", max_length=16)
    gate = StepGate()
    eng = DecodeEngine(pold, n_slots=1, max_len=40, prompt_buckets=(8,),
                       page_size=8, prefill_chunk=8, step_hooks=[gate],
                       decode_chunk=1, device="cpu")
    try:
        first = eng.submit(_prompts(1, 5)[0], 4)
        assert gate.entered.wait(WAIT)
        too_long = eng.submit(_prompts(1, 10, seed=1)[0], 10)
        fits = eng.submit(_prompts(1, 5, seed=2)[0], 4)
        t = threading.Thread(target=lambda: eng.drain_and_swap(short))
        t.start()
        _wait_until(lambda: eng._draining, "the drain")
        gate.release.set()
        t.join(WAIT)
        assert not t.is_alive()
        assert len(first.result(timeout=WAIT)) == 4
        with pytest.raises(ServingError, match="no longer fits"):
            too_long.result(timeout=WAIT)
        assert len(fits.result(timeout=WAIT)) == 4
        assert eng.max_len == 16 and eng.stats()["swaps"] == 1
        assert eng.stats()["queued_page_demand"] == 0
    finally:
        eng.shutdown()


# ------------------------------------------------------------ the breaker
def test_engine_failures_open_the_shared_breaker(old, servers):
    _, pold, _ = old
    broken = {"on": True}

    def hook(phase, info):
        if phase == "pre_decode" and broken["on"]:
            raise RuntimeError("injected decode failure")

    srv = servers(pold, breaker_threshold=2, breaker_reset_timeout=0.2,
                  generation=dict(GEN, step_hooks=[hook]))
    p = _prompts(1, 5)[0]
    for _ in range(2):
        with pytest.raises(InferenceFailedError, match="injected"):
            srv.generate(p, 4)
    assert srv.breaker.state == "open"
    with pytest.raises(ServiceUnavailableError):
        srv.generate(p, 4)
    with pytest.raises(ServiceUnavailableError):
        srv.predict(_prompts(1, 6))
    assert srv.stats()["generation"]["shed_unavailable"] == 1
    broken["on"] = False
    _wait_until(lambda: srv.breaker.state == "half_open", "half-open")
    assert len(srv.generate(p, 4)) == 4  # the probe closes it
    assert srv.breaker.state == "closed"
    assert [e["state"] for e in srv.flight_record()["events"]
            if e["kind"] == "breaker"] == ["open", "half_open", "closed"]


def test_a_standalone_engine_rings_its_own_breaker_events(old):
    from deeplearning4j_tpu_torch.serving import CircuitBreaker

    _, pold, _ = old
    brk = CircuitBreaker(failure_threshold=1, reset_timeout=60.0)
    eng = DecodeEngine(pold, breaker=brk, device="cpu", **GEN)
    try:
        brk.record_failure()
        with pytest.raises(ServiceUnavailableError):
            eng.submit(_prompts(1, 5)[0], 2)
        assert [e["state"] for e in eng.flight_record()["events"]
                if e["kind"] == "breaker"] == ["open"]
    finally:
        eng.shutdown()


# ------------------------------------------------------- stats, metrics
def test_server_stats_top_level_keys_match_the_jax_server(old, servers):
    jnet, pnet, _ = old
    srv = servers(pnet, generation=dict(GEN))
    jsrv = servers(jnet, cls=JaxServer, generation=dict(GEN))
    p = _prompts(1, 5)[0]
    srv.generate(p, 3)
    jsrv.generate(p, 3)
    got, want = srv.stats(), jsrv.stats()
    assert set(got) == set(want)
    for k in ("slot_occupancy_pct", "pages_in_use", "prefill_chunks",
              "preemptions", "slo_sheds", "shed_quota"):
        assert got[k] == want[k], k
    for k in ("served", "decode_steps", "tokens_generated", "swaps",
              "shed_unavailable", "kv_quant_bits"):
        assert got["generation"][k] == want["generation"][k], k


def test_engine_metrics_and_timelines(old, servers):
    _, pnet, _ = old
    srv = servers(pnet, generation=dict(GEN))
    srv.generate(_prompts(1, 20)[0], 3)
    text = srv.metrics_text()
    for name in ("dl4j_decode_engine_generate_latency_ms_count 1",
                 "dl4j_decode_engine_ttft_ms_count 1",
                 "dl4j_stats_decode_engine_served 1",
                 "dl4j_decode_engine_queued 0"):
        assert name in text, name
    dump = srv.flight_record()
    (gen,) = [r for r in dump["requests"] if r["kind"] == "generate"]
    names = {s["name"] for s in gen["trace"]["spans"]}
    assert {"enqueue", "queue-wait", "admission", "prefill-chunk",
            "decode"} <= names
    assert gen["decision"] == "served" and gen["attrs"]["tokens"] == 3
    assert [e["kind"] for e in dump["events"]] == ["admit", "retire"]


def test_generate_after_shutdown_is_refused(old, servers):
    _, pnet, _ = old
    srv = servers(pnet, generation=dict(GEN))
    srv.generate(_prompts(1, 5)[0], 2)
    assert srv.shutdown() is True
    with pytest.raises(ServerClosedError):
        srv.generate(_prompts(1, 5)[0], 2)


@pytest.mark.parametrize("kw,err", [
    ({"logprobs": -1}, ValueError),
    ({"logprobs": 2, "speculative": {"draft": "self", "k": 2}}, ValueError),
    ({"excursion": 0.99}, ValueError),
    ({"role": "decode"}, NotImplementedError),
    ({"handoff_ttl": 5.0}, NotImplementedError),
])
def test_engine_refuses_bad_options(old, kw, err):
    with pytest.raises(err):
        DecodeEngine(old[1], device="cpu", **dict(GEN, **kw))


def test_engine_submit_refuses_more_logprobs_than_built(old):
    eng = DecodeEngine(old[1], device="cpu", **dict(GEN, logprobs=2))
    try:
        with pytest.raises(ValueError, match="logprobs"):
            eng.submit(_prompts(1, 5)[0], 2, logprobs=3)
        with pytest.raises(ValueError, match="logprobs"):
            eng.submit(_prompts(1, 5)[0], 2, logprobs=-1)
    finally:
        eng.shutdown()


def test_excursion_pins_the_tail_trace(old):
    eng = DecodeEngine(old[1], device="cpu",
                       excursion={"quantile": 0.5, "min_count": 2}, **GEN)
    try:
        h = eng._gen_latency_hist
        tr = maybe_trace()
        h.observe(1.0)
        h.observe(5000.0, trace=tr)  # below min_count: no pin
        h.observe(1.0)
        h.observe(5000.0, trace=tr)  # past the bound: pinned
        pins = [f for f in eng.flight_record()["failures"]
                if f["kind"] == "excursion"]
        assert len(pins) == 1
        assert pins[0]["attrs"] == {"latency_ms": 5000.0, "bound_ms": 2.0}
    finally:
        eng.shutdown()


@pytest.mark.parametrize("excursion,armed", [(None, True), (False, False)])
def test_excursion_default_and_off(old, excursion, armed):
    eng = DecodeEngine(old[1], device="cpu", excursion=excursion, **GEN)
    try:
        h = eng._gen_latency_hist
        assert (h._exc_hook is not None) == armed
        if armed:
            assert h._exc_quantile == 0.99 and h._exc_min_count == 50
    finally:
        eng.shutdown()


_ENGINE_STUBS = {
    "model_bytes_per_chip": (), "set_tenant_quota": ("t",),
    "bind_prefix_directory": (None, "me"), "prefix_depth": ([1, 2],),
    "prefix_chains": (), "export_prefix": ([1, 2],),
    "fetch_handoff": ("h",), "fetch_handoff_header": ("h",),
    "fetch_handoff_frame": ("h", 0), "commit_handoff": ("h",),
    "abort_handoff": ("h",), "resume_submit": ({},),
    "resume_generate": ({},), "migrate_slots": (),
}


@pytest.fixture(scope="module")
def idle_engine(old):
    eng = DecodeEngine(old[1], device="cpu", **GEN)
    yield eng
    eng.shutdown()


@pytest.mark.parametrize("name", sorted(_ENGINE_STUBS))
def test_cluster_tier_engine_methods_raise_naming_a11(idle_engine, name):
    with pytest.raises(NotImplementedError, match="queue A11"):
        getattr(idle_engine, name)(*_ENGINE_STUBS[name])


def test_prefix_cache_chains_raises_naming_a11():
    with pytest.raises(NotImplementedError, match="queue A11"):
        PrefixCache(8).chains()
