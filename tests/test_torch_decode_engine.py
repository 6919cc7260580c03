"""The port's continuous-batching `DecodeEngine` held against the JAX
package on the CPU at small size (vocab 48, d_model 32, 2 layers).

Parity contract: the port engine's greedy tokens equal the JAX
`DecodeEngine`'s and the JAX whole-batch `generate`'s for the same
prompts and bridged weights, under two admission orders, with mixed
lengths, slot and page reuse, chunked prefill and GQA + RoPE. The
serving ladders: pool exhaustion sheds the typed `OutOfPagesError`, the
bounded queue sheds `ServerOverloadedError`, and the page ledger returns
to zero. Every engine is shut down in `finally`.
"""
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
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    DeadlineExceededError,
    DecodeEngine,
    OutOfPagesError,
    ServerClosedError,
    ServerOverloadedError,
)
from deeplearning4j_tpu_torch.serving.decode_engine import (  # noqa: E402
    _write_pages,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)

VOCAB = 48


def _pair(**kw):
    kw = dict(dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2,
                   max_length=64), **kw)
    jnet = JaxNet(jax_gpt_configuration(**kw))
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    return jnet, pnet


@pytest.fixture(scope="module")
def nets():
    return _pair()


def _prompts(n, t0, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, t0)) \
        .astype(np.int32)


def _engine(net, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("prompt_buckets", (8,))
    return DecodeEngine(net, device="cpu", **kw)


def test_engine_matches_jax_engine_and_generate_two_orders(nets):
    """4 requests through 2 slots (slot reuse, in-flight admission) under
    two admission orders: port engine == JAX engine == JAX generate."""
    jnet, pnet = nets
    prompts = _prompts(4, 5)
    expected = jax_generate(jnet, prompts, 6, temperature=0.0)
    jeng = JaxEngine(jnet, n_slots=2, max_len=32, prompt_buckets=(8,))
    try:
        jreqs = [jeng.submit(p, 6) for p in prompts]
        jax_tokens = [r.result(timeout=120.0) for r in jreqs]
    finally:
        jeng.shutdown()
    np.testing.assert_array_equal(np.stack(jax_tokens), expected)
    for order in ([0, 1, 2, 3], [3, 1, 0, 2]):
        eng = _engine(pnet)
        try:
            reqs = {i: eng.submit(prompts[i], 6) for i in order}
            for i in order:
                np.testing.assert_array_equal(reqs[i].result(timeout=120.0),
                                              expected[i])
            assert eng.stats()["decode_steps"] >= 3
        finally:
            eng.shutdown()


def test_mixed_lengths_and_buckets_parity(nets):
    jnet, pnet = nets
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, t).astype(np.int32)
               for t in (3, 5, 9, 12)]
    n_toks = [7, 3, 10, 5]
    eng = _engine(pnet, n_slots=3, prompt_buckets=(4, 8, 16))
    try:
        reqs = [eng.submit(p, n) for p, n in zip(prompts, n_toks)]
        for p, n, r in zip(prompts, n_toks, reqs):
            exp = jax_generate(jnet, p[None], n, temperature=0.0)[0]
            np.testing.assert_array_equal(r.result(timeout=120.0), exp)
    finally:
        eng.shutdown()


def test_page_reuse_and_ledger_returns_to_zero(nets):
    """pool_pages=4 is exactly wave 1's demand, so wave 2 runs on
    reallocated pages: no stale KV may leak into it, and every page comes
    back to the free list."""
    jnet, pnet = nets
    prompts = _prompts(4, 9, seed=41)
    expected = jax_generate(jnet, prompts, 6, temperature=0.0)
    eng = _engine(pnet, n_slots=2, prompt_buckets=(16,), page_size=8,
                  pool_pages=4)
    try:
        for wave in ((0, 1), (2, 3)):
            reqs = [eng.submit(prompts[i], 6) for i in wave]
            for i, r in zip(wave, reqs):
                np.testing.assert_array_equal(r.result(timeout=120.0),
                                              expected[i])
            st = eng.stats()
            assert st["pages_in_use"] == 0 and st["queued_page_demand"] == 0
        assert eng.stats()["pages_in_use_peak"] == 4
        assert sorted(eng._free_pages) == [1, 2, 3, 4]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("variant", ["mha", "gqa_rope_swiglu"])
def test_chunked_prefill_parity(variant):
    """A prompt longer than every bucket and the chunk width prefills in
    chunks through the paged attention path and still matches JAX
    generate, with and without GQA + RoPE + SwiGLU."""
    kw = {} if variant == "mha" else dict(n_heads=4, n_kv_heads=2, rope=True,
                                          ffn_activation="swiglu")
    jnet, pnet = _pair(**kw)
    prompt = np.random.default_rng(31).integers(0, VOCAB, 19).astype(np.int32)
    exp = jax_generate(jnet, prompt[None], 5, temperature=0.0)[0]
    eng = _engine(pnet, max_len=48, prompt_buckets=(4,), prefill_chunk=8,
                  page_size=8)
    try:
        np.testing.assert_array_equal(eng.generate(prompt, 5), exp)
        st = eng.stats()
        assert st["prefill_chunks"] >= 3 and st["prefills"] == 1
    finally:
        eng.shutdown()


def test_chunked_prefill_interleaves_with_decode(nets):
    """While a long prompt prefills chunk by chunk, an in-flight decode
    keeps stepping between its chunks; both stay exact."""
    jnet, pnet = nets
    events, lock = [], threading.Lock()

    def hook(phase, info):
        with lock:
            events.append((phase, dict(info)))

    rng = np.random.default_rng(37)
    short = rng.integers(0, VOCAB, 5).astype(np.int32)
    long_p = rng.integers(0, VOCAB, 24).astype(np.int32)
    eng = _engine(pnet, max_len=64, prefill_chunk=8, page_size=8,
                  decode_chunk=1, step_hooks=[hook])
    try:
        short_req = eng.submit(short, 24)
        while not short_req.tokens:
            assert short_req.error is None, short_req.error
            time.sleep(0.005)
        long_req = eng.submit(long_p, 4)
        np.testing.assert_array_equal(
            short_req.result(timeout=120.0),
            jax_generate(jnet, short[None], 24, temperature=0.0)[0])
        np.testing.assert_array_equal(
            long_req.result(timeout=120.0),
            jax_generate(jnet, long_p[None], 4, temperature=0.0)[0])
    finally:
        eng.shutdown()
    chunk_idx = [i for i, (ph, info) in enumerate(events)
                 if ph == "pre_prefill" and "chunk_off" in info]
    decode_idx = [i for i, (ph, _) in enumerate(events) if ph == "pre_decode"]
    assert len(chunk_idx) >= 3
    assert any(chunk_idx[0] < d < chunk_idx[-1] for d in decode_idx)


def test_pool_exhaustion_sheds_typed_out_of_pages(nets):
    """Past `max_queued_pages` of queued demand, submit sheds
    `OutOfPagesError` (a `ServerOverloadedError`) with retry_after; the
    page-blocked waiter completes once the holder retires; a request
    that can never fit the pool is a ValueError."""
    jnet, pnet = nets
    gate = threading.Event()

    def slow_hook(phase, info):
        if phase == "pre_decode":
            gate.wait(0.05)

    prompts = _prompts(3, 5, seed=43)
    expected = jax_generate(jnet, prompts, 24, temperature=0.0)
    eng = _engine(pnet, page_size=8, pool_pages=4, max_queued_pages=4,
                  step_hooks=[slow_hook])
    try:
        holder = eng.submit(prompts[0], 24)      # takes all 4 pages
        while not holder.tokens:
            assert holder.error is None, holder.error
            time.sleep(0.005)
        assert eng.stats()["pages_in_use"] == 4
        waiter = eng.submit(prompts[1], 24)      # queued demand: 4
        with pytest.raises(OutOfPagesError) as ei:
            eng.submit(prompts[2], 24)           # 8 > 4 allowed
        assert ei.value.retry_after > 0
        assert isinstance(ei.value, ServerOverloadedError)
        st = eng.stats()
        assert st["shed_out_of_pages"] == 1 and st["queued_page_demand"] == 4
        gate.set()
        np.testing.assert_array_equal(holder.result(timeout=120.0),
                                      expected[0])
        np.testing.assert_array_equal(waiter.result(timeout=120.0),
                                      expected[1])
        assert eng.stats()["pages_in_use"] == 0
    finally:
        gate.set()
        eng.shutdown()
    eng2 = _engine(pnet, n_slots=1, page_size=8, pool_pages=2)
    try:
        with pytest.raises(ValueError, match="pool"):
            eng2.submit(prompts[0], 24)          # needs 4 > 2 pages
    finally:
        eng2.shutdown()


def test_overload_sheds_and_shutdown_rejects(nets):
    _, pnet = nets
    gate = threading.Event()

    def block(phase, info):
        if phase == "pre_prefill":
            gate.wait(5.0)

    eng = _engine(pnet, n_slots=1, max_queue=1, step_hooks=[block])
    try:
        first = eng.submit(_prompts(1, 4)[0], 3)   # admitted, held in prefill
        while eng.stats()["queued"]:
            time.sleep(0.005)
        eng.submit(_prompts(1, 4)[0], 3)           # fills the queue
        with pytest.raises(ServerOverloadedError) as ei:
            eng.submit(_prompts(1, 4)[0], 3)
        assert not isinstance(ei.value, OutOfPagesError)
        assert eng.stats()["shed_overload"] == 1
        gate.set()
        assert first.result(timeout=60.0).shape == (3,)
    finally:
        gate.set()
        eng.shutdown()
    with pytest.raises(ServerClosedError):
        eng.submit(_prompts(1, 4)[0], 3)


def test_deadlines_shed_in_queue_and_free_in_flight(nets):
    """A request whose deadline passes while it waits is shed before any
    prefill; one that expires mid-decode frees its slot and pages at
    once, and the next request still decodes exactly."""
    jnet, pnet = nets

    def slow(phase, info):
        if phase == "pre_decode":
            time.sleep(0.05)  # 24 tokens take >= 6 dispatches: > 0.3 s

    prompts = _prompts(3, 5, seed=47)
    eng = _engine(pnet, n_slots=1, step_hooks=[slow])
    try:
        with pytest.raises(DeadlineExceededError):
            eng.submit(prompts[0], 4, timeout=0.0)
        doomed = eng.submit(prompts[0], 24, timeout=0.2)
        queued = eng.submit(prompts[1], 4, timeout=0.05)
        with pytest.raises(DeadlineExceededError, match="slot freed"):
            doomed.result(timeout=60.0)
        with pytest.raises(DeadlineExceededError, match="queued"):
            queued.result(timeout=60.0)
        np.testing.assert_array_equal(
            eng.generate(prompts[2], 5),
            jax_generate(jnet, prompts[2][None], 5, temperature=0.0)[0])
        st = eng.stats()
        assert st["shed_deadline"] == 3 and st["pages_in_use"] == 0
    finally:
        eng.shutdown()


def test_eos_and_sampled_requests(nets):
    """EOS retires a slot early; sampled requests are deterministic per
    seed and vary across seeds."""
    jnet, pnet = nets
    prompt = _prompts(1, 5, seed=3)[0]
    exp = jax_generate(jnet, prompt[None], 8, temperature=0.0)[0]
    eng = _engine(pnet, eos_token=int(exp[2]))
    try:
        got = eng.generate(prompt, 8)
        np.testing.assert_array_equal(got, exp[:list(exp).index(exp[2]) + 1])
    finally:
        eng.shutdown()
    eng = _engine(pnet)
    try:
        a = eng.generate(prompt, 12, temperature=1.0, seed=5)
        b = eng.generate(prompt, 12, temperature=1.0, seed=5)
        others = [eng.generate(prompt, 12, temperature=1.0, seed=s)
                  for s in (6, 7, 8)]
        np.testing.assert_array_equal(a, b)
        assert any(not np.array_equal(a, o) for o in others)
    finally:
        eng.shutdown()


def test_unported_options_are_refused(nets):
    _, pnet = nets
    with pytest.raises(NotImplementedError, match="not ported"):
        _engine(pnet, prefix_cache=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        _engine(pnet, quantize={"kv": "int8"})
    with pytest.raises(TypeError, match="unexpected"):
        _engine(pnet, no_such_option=1)
    eng = _engine(pnet, breaker=None)  # the JAX default is accepted
    try:
        with pytest.raises(NotImplementedError, match="not ported"):
            eng.submit(_prompts(1, 4)[0], 2, logprobs=2)
    finally:
        eng.shutdown()


def test_write_pages_refuses_a_span_past_its_page():
    """A sub-page prefill span lands at its in-page offset and nowhere
    else; a span that would run past the page raises (the JAX package's
    `dynamic_update_slice` would clamp it instead)."""
    kp, vp = torch.zeros((3, 1, 2, 4)), torch.zeros((3, 1, 4, 2))
    kcol, vrow = torch.ones((1, 1, 2, 3)), torch.ones((1, 1, 3, 2))
    _write_pages(kp, vp, kcol, vrow, [1], 1, 4)
    assert kp[1, :, :, 1:].eq(1).all() and vp[1, :, 1:].eq(1).all()
    assert kp[1, :, :, 0].eq(0).all() and kp[[0, 2]].eq(0).all()
    with pytest.raises(ValueError, match="past"):
        _write_pages(kp, vp, kcol, vrow, [1], 2, 4)
