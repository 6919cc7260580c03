"""The port's resumable token streams (`serving.streaming`) held against
the JAX package on the CPU: scripted publish / read / finish / shed
sequences give the same frames, cursors, typed errors and stats in both
packages; the engine's `on_token` sink streams frames that concatenate
to the unary tokens, equal to the JAX engine's on shared weights (vocab
48, d_model 32, 2 layers); and through a `ReplicaPool` a crash planted
after k tokens fails over and republishes cursors 1..k into the same
ring, where they deduplicate, so the frames stay contiguous.
"""
import signal
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.serving import DecodeEngine as JaxEngine  # noqa: E402
from deeplearning4j_tpu.serving import streaming as jax_streaming  # noqa: E402
from deeplearning4j_tpu.serving.observability import (  # noqa: E402
    STREAMING_STATS_KEYS as JAX_STREAMING_STATS_KEYS,
)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    DecodeEngine,
    ExactlyOnceDoor,
    ModelServer,
    ReplicaCrashInjector,
    ReplicaPool,
    StreamBackpressureError,
    StreamRegistry,
    TokenStream,
)
from deeplearning4j_tpu_torch.serving import streaming  # noqa: E402
from deeplearning4j_tpu_torch.serving.observability import (  # noqa: E402
    STREAMING_STATS_KEYS,
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
    """A wedged stream, drain or failover dies by SIGALRM instead of
    eating the tier's time."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def boom(signum, frame):
        raise TimeoutError(
            f"streaming test exceeded the {WEDGE_GUARD_S} s guard")

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


def _prompt(n=8, seed=3):
    return np.random.default_rng(seed).integers(0, VOCAB, n) \
        .astype(np.int32)


def _wait(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise TimeoutError(f"{what} not reached within {timeout}s")


GEN = {"n_slots": 2, "max_len": 48, "prompt_buckets": (8,)}


# ------------------------------------------------------- scripted ring
def _run_ring(mod, capacity, script):
    """Apply `script` to one package's TokenStream: every op's result,
    or its raised error's type name and message."""
    st = mod.TokenStream("req", capacity=capacity)
    trace = []
    for op in script:
        kind, args = op[0], op[1:]
        try:
            if kind == "pub":
                trace.append(st.publish(*args))
            elif kind == "read":
                trace.append(st.read(*args, timeout=0.0))
            elif kind == "finish":
                trace.append(st.finish(*args))
            elif kind == "state":
                trace.append((st.cursor, st.done, st.duplicate_tokens_dropped,
                              st.gap_tokens_dropped))
        except Exception as e:  # the trace records the typed error
            trace.append((type(e).__name__, str(e)))
    return trace


LP = {"token": 3, "logprob": -0.5, "top_tokens": [3, 1],
      "top_logprobs": [-0.5, -1.2]}
RING_SCRIPTS = {
    "roundtrip": (16, [("pub", c, 100 + c) for c in range(1, 6)]
                  + [("read", 0), ("read", 3), ("read", 5), ("state",)]),
    "dup_and_gap": (16, [("pub", 1, 7), ("pub", 2, 8), ("pub", 1, 7),
                         ("pub", 2, 8), ("pub", 5, 9), ("pub", 3, 4),
                         ("read", 0), ("state",)]),
    "overflow": (4, [("pub", c, c) for c in range(1, 11)]
                 + [("read", 0), ("read", 5), ("read", 6), ("read", 9),
                    ("read", 10), ("state",)]),
    "capacity_edge": (3, [("pub", 1, 1), ("pub", 2, 2), ("pub", 3, 3),
                          ("read", 0), ("pub", 4, 4), ("read", 0),
                          ("read", 1), ("state",)]),
    "finish_first_wins": (4, [("finish", {"result": "a"}),
                              ("finish", {"result": "b"}), ("read", 0),
                              ("state",)]),
    "tokens_then_body": (8, [("pub", 1, 5), ("pub", 2, 6),
                             ("finish", {"result": [5, 6]}), ("read", 0),
                             ("read", 2), ("pub", 3, 7), ("read", 2),
                             ("state",)]),
    "logprob_entries": (8, [("pub", 1, 3, LP), ("pub", 2, 4), ("read", 0),
                            ("read", 1), ("state",)]),
    "overflow_after_finish": (2, [("pub", c, c) for c in range(1, 6)]
                              + [("finish", {"result": 1}), ("read", 0),
                                 ("read", 3), ("read", 5), ("state",)]),
}


@pytest.mark.parametrize("name", sorted(RING_SCRIPTS))
def test_ring_script_matches_jax(name):
    """The same publish / read / finish sequence gives the same frames,
    cursors, bodies, typed errors (with their messages) and dedup
    counters in both packages."""
    capacity, script = RING_SCRIPTS[name]
    got = _run_ring(streaming, capacity, script)
    want = _run_ring(jax_streaming, capacity, script)
    assert got == want


def test_ring_overflow_raises_typed_backpressure():
    st = TokenStream("r", capacity=4)
    for c in range(1, 11):
        assert st.publish(c, c)
    with pytest.raises(StreamBackpressureError, match="ring") as ei:
        st.read(0, timeout=0)
    assert ei.value.retry_after == 0.5


@pytest.mark.parametrize("mod", [streaming, jax_streaming],
                         ids=["port", "jax"])
def test_constructor_validation(mod):
    with pytest.raises(ValueError, match="capacity"):
        mod.TokenStream("r", capacity=0)
    with pytest.raises(ValueError, match="ttl"):
        mod.StreamRegistry(ttl=0)


def test_read_linger_batches_and_finish_aborts_it():
    st = TokenStream("r5", capacity=16)
    st.publish(1, 1)

    def feed():
        st.publish(2, 2)
        st.publish(3, 3)
        st.finish({"result": 1})

    t = threading.Thread(target=feed)
    t0 = time.monotonic()
    t.start()
    toks, _, cursor, body = st.read(0, timeout=5.0, linger=10.0)
    t.join()
    assert time.monotonic() - t0 < 5.0
    assert toks == [1, 2, 3] and cursor == 3 and body == {"result": 1}


def test_read_blocks_until_a_token_lands():
    st = TokenStream("r6", capacity=8)
    threading.Timer(0.05, lambda: st.publish(1, 9)).start()
    toks, _, cursor, body = st.read(0, timeout=10.0)
    assert toks == [9] and cursor == 1 and body is None
    assert st.read(1, timeout=0.01) == ([], None, 1, None)


# --------------------------------------------------- scripted registry
def _run_registry(mod, script, ring=8, ttl=120.0):
    reg = mod.StreamRegistry(ring=ring, ttl=ttl)
    streams = {}
    trace = []
    for op in script:
        kind, args = op[0], op[1:]
        if kind == "open":
            s = reg.open(args[0])
            trace.append(("same" if streams.get(args[0]) is s else "new"))
            streams[args[0]] = s
        elif kind == "pub":
            trace.append(streams[args[0]].publish(args[1], args[2]))
        elif kind == "attach":
            s = reg.attach(args[0])
            trace.append(None if s is None else
                         ("same" if streams.get(args[0]) is s else "other"))
        elif kind == "get":
            trace.append(reg.get(args[0]) is not None)
        elif kind == "finish":
            trace.append(reg.finish(streams[args[0]], args[1]))
        elif kind == "shed":
            reg.shed(streams[args[0]])
        elif kind == "sleep":
            time.sleep(args[0])
        elif kind == "stats":
            trace.append(reg.stats())
    return trace


REGISTRY_SCRIPTS = {
    "failover_reopen_dedups": (120.0, [
        ("open", "a"), ("pub", "a", 1, 1), ("pub", "a", 2, 2),
        ("pub", "a", 3, 3), ("open", "a"), ("pub", "a", 1, 1),
        ("pub", "a", 2, 2), ("pub", "a", 4, 4), ("stats",),
        ("finish", "a", {"result": 1}), ("finish", "a", {"result": 2}),
        ("open", "a"), ("stats",)]),
    "attach_shed_stats": (120.0, [
        ("open", "a"), ("attach", "a"), ("attach", "b"), ("shed", "a"),
        ("open", "b"), ("finish", "a", {"result": 1}), ("stats",)]),
    "ttl_sweep": (0.05, [
        ("open", "a"), ("pub", "a", 1, 1), ("pub", "a", 1, 1),
        ("finish", "a", {"result": 1}), ("open", "b"), ("get", "a"),
        ("sleep", 0.1), ("attach", "a"), ("get", "b"), ("stats",)]),
    "replaced_stream_keeps_dup_total": (120.0, [
        ("open", "a"), ("pub", "a", 1, 1), ("pub", "a", 1, 1),
        ("finish", "a", {"result": 1}), ("open", "a"), ("pub", "a", 1, 5),
        ("pub", "a", 1, 5), ("stats",)]),
}


@pytest.mark.parametrize("name", sorted(REGISTRY_SCRIPTS))
def test_registry_script_matches_jax(name):
    """Open (reusing a live stream, replacing a finished one), attach,
    shed, finish exactly once, the lazy TTL sweep and the folded dedup
    totals: the same verdicts and stats in both packages."""
    ttl, script = REGISTRY_SCRIPTS[name]
    got = _run_registry(streaming, script, ttl=ttl)
    want = _run_registry(jax_streaming, script, ttl=ttl)
    assert got == want


def test_registry_stats_keys_are_the_contract():
    assert STREAMING_STATS_KEYS == JAX_STREAMING_STATS_KEYS
    assert set(StreamRegistry().stats()) == STREAMING_STATS_KEYS


# --------------------------------------------------- engine emission
def test_engine_frames_concatenate_to_unary_and_jax(nets):
    """`TokenStream.publish` as the engine's `on_token` sink, with a
    concurrent reader: the frames concatenate to the unary tokens, and
    both equal the JAX engine's greedy tokens on the same weights."""
    jnet, pnet = nets
    p = _prompt()
    jeng = JaxEngine(jnet, **GEN)
    try:
        want = np.asarray(jeng.generate(p, 12, timeout=120.0))
    finally:
        jeng.shutdown()
    eng = DecodeEngine(pnet, device="cpu", **GEN)
    reg = StreamRegistry(ring=64)
    stream = reg.open("e1")
    frames = []

    def reader():
        cur = 0
        while True:
            toks, _, cur, body = stream.read(cur, timeout=30.0)
            if toks:
                frames.append(toks)
            if body is not None and not toks:
                return

    t = threading.Thread(target=reader)
    t.start()
    try:
        out = eng.generate(p, 12, timeout=120.0, on_token=stream.publish)
        reg.finish(stream, {"result": out.tolist()})
        t.join(30.0)
    finally:
        eng.shutdown()
    assert not t.is_alive()
    np.testing.assert_array_equal(out, want)
    assert sum(frames, []) == out.tolist()
    assert stream.duplicate_tokens_dropped == 0
    assert stream.gap_tokens_dropped == 0


def test_engine_logprob_entries_ride_the_ring(nets):
    eng = DecodeEngine(nets[1], device="cpu", logprobs=2, **GEN)
    stream = TokenStream("lp", capacity=32)
    try:
        out = eng.generate(_prompt(), 6, timeout=120.0, logprobs=2,
                           on_token=stream.publish)
    finally:
        eng.shutdown()
    toks, lps, cursor, _ = stream.read(0, timeout=0)
    assert toks == out["tokens"].tolist() and cursor == 6
    assert [e["token"] for e in lps] == toks
    assert lps == out["logprobs"]


# ---------------------------------------------------- through the pool
def _crash_pool(pnet, n=2, slow=0.01):
    """A pool of `n` replicas whose engines each carry a crash injector
    (fired at their decode steps) and a slow-decode hook, so a crash can
    land mid-stream."""
    crashes = [ReplicaCrashInjector() for _ in range(n)]
    servers = []
    for i, inj in enumerate(crashes):
        def hook(phase, info, inj=inj):
            if phase == "pre_decode":
                time.sleep(slow)
                inj("pre_step", info)
        servers.append(ModelServer(
            pnet if i == 0 else pnet.clone(),
            generation=dict(GEN, step_hooks=[hook]),
            breaker_threshold=50))
    pool = ReplicaPool(servers, probe_interval=30.0, watchdog_timeout=5.0,
                       evict_threshold=5)
    return pool, crashes


def _serving_replica(pool):
    me = threading.current_thread()
    for i, rep in enumerate(pool._replicas):
        eng = rep.server._engine
        if eng is not None and eng._thread is me:
            return i
    return None


def test_pool_stream_equals_unary_and_resumes_at_a_cursor(nets):
    pool, _ = _crash_pool(nets[1])
    reg = StreamRegistry(ring=64)
    try:
        p = _prompt(seed=5)
        unary = pool.generate(p, 10, timeout=120.0)
        stream = reg.open("p1")
        out = pool.generate(p, 10, timeout=120.0, on_token=stream.publish)
        reg.finish(stream, {"result": out.tolist()})
        np.testing.assert_array_equal(out, unary)
        again = reg.attach("p1")
        assert again is stream
        toks, _, cursor, body = again.read(4, timeout=0)
        assert toks == unary.tolist()[4:] and cursor == 10
        assert body == {"result": unary.tolist()}
        assert reg.stats()["stream_resumes"] == 1
    finally:
        pool.shutdown(drain_timeout=30.0)


def test_pool_crash_after_k_tokens_republishes_deduplicated(nets):
    """A crash planted on the serving replica once k tokens are out: the
    pool fails over, the re-run republishes cursors 1..k into the same
    ring (dropped as duplicates), and the frames a concurrent reader
    saw are contiguous and equal to the unary tokens."""
    pool, crashes = _crash_pool(nets[1])
    reg = StreamRegistry(ring=64)
    k = 4
    try:
        p = _prompt(seed=6)
        unary = pool.generate(p, 14, timeout=120.0)
        stream = reg.open("c1")
        crashed = []

        def sink(cursor, token, entry=None):
            stream.publish(cursor, token, entry)
            if cursor == k and not crashed:
                i = _serving_replica(pool)
                crashed.append(i)
                crashes[i].crash()

        frames = []

        def reader():
            cur = 0
            while True:
                toks, _, cur, body = stream.read(cur, timeout=60.0)
                frames.extend(toks)
                if body is not None and not toks:
                    return

        t = threading.Thread(target=reader)
        t.start()
        out = pool.generate(p, 14, timeout=120.0, on_token=sink)
        reg.finish(stream, {"result": out.tolist()})
        t.join(60.0)
        for inj in crashes:
            inj.revive()
        assert not t.is_alive()
        np.testing.assert_array_equal(out, unary)
        assert frames == unary.tolist()
        assert crashed and crashes[crashed[0]].steps_killed >= 1
        assert pool.stats()["failovers"] >= 1
        assert stream.duplicate_tokens_dropped >= k
        assert stream.gap_tokens_dropped == 0
        assert reg.stats()["duplicate_tokens_dropped"] \
            == stream.duplicate_tokens_dropped
    finally:
        pool.shutdown(drain_timeout=30.0)


def test_pool_ring_overflow_sheds_typed_and_the_door_recovers(nets):
    """A consumer that never reads falls out of a small ring: the read
    raises `StreamBackpressureError`, and the outcome parked behind the
    exactly-once door is claimed whole."""
    pool, _ = _crash_pool(nets[1])
    reg = StreamRegistry(ring=3)
    door = ExactlyOnceDoor()
    try:
        p = _prompt(seed=7)
        verdict, _ = door.admit("o1", "generate_stream", {})
        assert verdict == "execute"
        stream = reg.open("o1")
        out = pool.generate(p, 12, timeout=120.0, on_token=stream.publish)
        door.complete("o1", {"result": out.tolist()})
        reg.finish(stream, {"result": out.tolist()})
        with pytest.raises(StreamBackpressureError):
            stream.read(0, timeout=0)
        reg.shed(stream)
        assert door.claim("o1") == {"result": out.tolist()}
        assert reg.stats()["stream_backpressure_sheds"] == 1
        toks, _, _, _ = stream.read(9, timeout=0)
        assert toks == out.tolist()[9:]
    finally:
        pool.shutdown(drain_timeout=30.0)


def test_pool_and_server_accept_stream_sinks():
    assert ReplicaPool.supports_stream_sink is True
    assert ModelServer.supports_stream_sink is True
