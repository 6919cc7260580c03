"""The port's shared-prefix KV cache (`serving/prefix_cache.py` and its
wiring in `DecodeEngine`) held against the JAX package on the CPU.

Host logic: the port's `PrefixCache` and the JAX class are driven through
the same sequences of calls and must agree on every hit, page id,
refcount, eviction and reclaim; `chain_keys` must be byte-equal. Through
the engine (vocab 48, d_model 32, 2 layers, page 8): a prefix hit serves
the JAX `generate`'s greedy tokens, binds pages that are bit-identical to
a cold engine's, retire-while-shared frees nothing, LRU reclaim under
pool pressure keeps caching from shrinking capacity, and the page ledger
balances. Every engine is shut down in `finally`.
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
from deeplearning4j_tpu.serving import prefix_cache as jpc  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving import DecodeEngine  # noqa: E402
from deeplearning4j_tpu_torch.serving import prefix_cache as ppc  # noqa: E402
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
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


@pytest.fixture(scope="module")
def nets():
    jnet = JaxNet(jax_gpt_configuration(vocab_size=VOCAB, d_model=32,
                                        n_heads=2, n_layers=2, max_length=64))
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    return jnet, pnet


def _shared_prompts(n_tails, prefix_len=16, tail_len=4, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, VOCAB, prefix_len).astype(np.int32)
    return [np.concatenate(
        [prefix, rng.integers(0, VOCAB, tail_len).astype(np.int32)])
        for _ in range(n_tails)]


def _engine(net, **kw):
    kw = dict(dict(n_slots=2, max_len=40, prompt_buckets=(8,), page_size=8,
                   prefill_chunk=8, prefix_cache=True), **kw)
    return DecodeEngine(net, device="cpu", **kw)


# ------------------------------------------------------------- host logic


@pytest.mark.parametrize("page,tenant", [(4, None), (8, "acme")])
def test_chain_keys_byte_equal(page, tenant):
    rng = np.random.default_rng(page)
    prompt = rng.integers(0, VOCAB, 37).astype(np.int32)
    memo_p, memo_j = [], []
    got = ppc.chain_keys(prompt, page, tenant, memo_p)
    assert got == jpc.chain_keys(prompt, page, tenant, memo_j)
    assert len(got) == 37 // page and memo_p == memo_j
    assert ppc.chain_keys(prompt, page, tenant, memo_p) == got  # memoized
    assert ppc.chain_keys(prompt, page, "other") != got
    assert ppc._digest(prompt[:page]) == jpc._digest(prompt[:page])
    assert ppc._chain_root(tenant) == jpc._chain_root(tenant)


def _view(nodes):
    return [(n.page_id, n.requests, n.children, n.chain, n.last_used)
            for n in nodes]


@pytest.mark.parametrize("max_pages", [None, 3])
def test_prefix_cache_follows_the_jax_class_call_for_call(max_pages):
    """A seeded random walk over lookup / acquire / insert / release /
    reclaim / match / clear on both classes: the same hits, page ids,
    refcounts, chain keys, LRU clocks, evictions and reclaimed pages."""
    rng = np.random.default_rng(11 if max_pages is None else 12)
    page = 4
    lock = threading.RLock()
    mine = ppc.PrefixCache(page, max_pages).bind_guard(lock)
    theirs = jpc.PrefixCache(page, max_pages).bind_guard(lock)
    prefixes = [rng.integers(0, VOCAB, 12).astype(np.int32) for _ in range(3)]
    next_page = [1]
    held = []   # (my nodes, their nodes) of live "requests"
    with lock:
        for step in range(120):
            op = rng.integers(0, 10)
            if op < 5:       # admit + prefill + promote one request
                pre = prefixes[rng.integers(0, 3)]
                tail = rng.integers(0, VOCAB, rng.integers(1, 9))
                prompt = np.concatenate([pre[:rng.choice([4, 8, 12])], tail]) \
                    .astype(np.int32)
                tenant = None if rng.random() < 0.8 else "t1"
                a = mine.lookup(prompt, [], tenant=tenant)
                b = theirs.lookup(prompt, [], tenant=tenant)
                assert _view(a) == _view(b)
                mine.acquire(a)
                theirs.acquire(b)
                n_pages = -(-len(prompt) // page)
                pages = [n.page_id for n in a]
                while len(pages) < n_pages:
                    pages.append(next_page[0])
                    next_page[0] += 1
                a2, fa = mine.insert(prompt, pages, a, tenant=tenant)
                b2, fb = theirs.insert(prompt, pages, b, tenant=tenant)
                assert _view(a2) == _view(b2) and fa == fb
                held.append((a2, b2))
            elif op < 8 and held:   # retire one
                a, b = held.pop(rng.integers(0, len(held)))
                mine.release(a)
                theirs.release(b)
            elif op == 8:           # pool pressure
                n = int(rng.integers(1, 4))
                assert mine.reclaim(n) == theirs.reclaim(n)
            else:
                probe = np.concatenate([prefixes[0], prefixes[1][:3]])
                assert _view(mine.match(probe)) == _view(theirs.match(probe))
            sa, sb = mine.stats(), theirs.stats()
            assert all(sa[k] == sb[k] for k in sa), (step, sa, sb)
            assert mine.cached_pages == theirs.cached_pages
        assert mine.stats()["insertions"] > 5
        assert mine.stats()["evictions"] > 0
        for a, b in held:
            mine.release(a)
            theirs.release(b)
        mine.clear()
        theirs.clear()
        assert mine.cached_pages == 0 == theirs.cached_pages


def test_prefix_cache_guard_and_unported_binds():
    """Mutating calls without the owner's lock fail hard; the binds of the
    observability and cluster tiers (ported now) chain and take effect."""
    lock = threading.RLock()
    cache = ppc.PrefixCache(4).bind_guard(lock)
    prompt = np.arange(9, dtype=np.int32)
    with pytest.raises(AssertionError, match="requires holding"):
        cache.lookup(prompt)
    with lock:
        assert cache.lookup(prompt) == []
        assert cache._max_hit_pages(9) == 2 and cache._max_hit_pages(8) == 1
    for bind, args in (("bind_recorder", (None,)), ("bind_version", ("v",)),
                       ("bind_directory", (None, "h"))):
        assert getattr(cache, bind)(*args) is cache
    assert cache.weight_version == "v" and cache._holder == "h"
    with lock:
        assert cache.chains() == []
    with pytest.raises(ValueError):
        ppc.PrefixCache(0)
    with pytest.raises(ValueError):
        ppc.PrefixCache(4, max_pages=-1)


# ------------------------------------------------------ through the engine


def test_prefix_hit_parity_and_stats(nets):
    """Two prompts sharing a 16-token prefix: the second binds the
    first's pages, skips the shared prefill, and both match the JAX
    engine's tokens and JAX generate; the stats agree with the JAX
    engine's."""
    jnet, pnet = nets
    pA, pB = _shared_prompts(2)
    jeng = JaxEngine(jnet, n_slots=2, max_len=40, prompt_buckets=(8,),
                     page_size=8, prefill_chunk=8, prefix_cache=True)
    eng = _engine(pnet)
    try:
        for p in (pA, pB):
            exp = jax_generate(jnet, p[None], 6, temperature=0.0)[0]
            np.testing.assert_array_equal(jeng.generate(p, 6), exp)
            np.testing.assert_array_equal(eng.generate(p, 6), exp)
        st, jst = eng.stats(), jeng.stats()
        pc, jp = st["prefix_cache"], jst["prefix_cache"]
        assert pc["hits"] == 1 and pc["misses"] == 1
        assert pc["hit_tokens"] == 16  # two 8-token pages
        for k in ("hits", "misses", "hit_tokens", "prompt_tokens",
                  "cached_pages", "pinned_pages", "insertions", "evictions"):
            assert pc[k] == jp[k], k
        assert st["prefix_hit_tokens_pct"] == jst["prefix_hit_tokens_pct"] > 0
        assert st["prefill_chunks"] == jst["prefill_chunks"]
    finally:
        jeng.shutdown()
        eng.shutdown()


def test_prefix_hit_kv_pages_bit_identical_to_cold_path(nets):
    """The pages a hit request attends through are BIT-identical to what
    a cold engine's prefill writes for the same prefix, and serving the
    hit never mutates them."""
    _, pnet = nets
    pA, pB = _shared_prompts(2, seed=5)

    def prefix_pages(eng, prompt):
        with eng._cond:
            nodes = eng._prefix_cache.lookup(prompt)
        assert nodes, "expected a cached prefix chain"
        pids = [n.page_id for n in nodes]
        return [pool[pids].clone() for cache in eng._caches for pool in cache]

    cold, hot = _engine(pnet), _engine(pnet)
    try:
        cold.generate(pA, 4)          # cold path only
        hot.generate(pA, 4)           # populates...
        before = prefix_pages(hot, pB)
        hot.generate(pB, 4)           # ...then HITS
        assert hot.stats()["prefix_cache"]["hits"] == 1
        after = prefix_pages(hot, pB)
        ref = prefix_pages(cold, pB)
        for b, a, r in zip(before, after, ref):
            assert torch.equal(a, b)   # the hit never writes them
            assert torch.equal(a, r)   # == cold path, bitwise
    finally:
        cold.shutdown()
        hot.shutdown()


def test_retire_while_shared_never_frees(nets):
    """Request A retires while B still decodes through the shared prefix
    pages: the pages survive, B stays exact, and afterwards only the
    cache holds pages."""
    jnet, pnet = nets
    pA, pB = _shared_prompts(2, seed=7)
    gate = threading.Event()

    def drag(phase, info):
        if phase == "pre_decode" and not gate.is_set():
            time.sleep(0.01)

    eng = _engine(pnet, step_hooks=[drag], decode_chunk=1)
    try:
        expA = jax_generate(jnet, pA[None], 3, temperature=0.0)[0]
        expB = jax_generate(jnet, pB[None], 12, temperature=0.0)[0]
        np.testing.assert_array_equal(eng.submit(pA, 3).result(timeout=120.0),
                                      expA)
        rb = eng.submit(pB, 12)  # hits A's (now cached) prefix
        while not rb.tokens:
            assert rb.error is None, rb.error
            time.sleep(0.005)
        assert eng.stats()["prefix_cache"]["cached_pages"] >= 2
        gate.set()
        np.testing.assert_array_equal(rb.result(timeout=120.0), expB)
        st = eng.stats()
        assert st["active_slots"] == 0
        assert st["pages_in_use"] == st["prefix_cache"]["cached_pages"]
        assert st["prefix_cache"]["pinned_pages"] <= 1  # interior node only
    finally:
        gate.set()
        eng.shutdown()


def test_lru_eviction_under_pool_pressure(nets):
    """When the free list cannot cover an admission, unreferenced cached
    pages are reclaimed (LRU) and the new request completes."""
    jnet, pnet = nets
    pA = _shared_prompts(1, seed=9)[0]          # 20 tokens -> 3 pages
    big = np.random.default_rng(11).integers(0, VOCAB, 9).astype(np.int32)
    eng = _engine(pnet, n_slots=1, prompt_buckets=(8, 16), pool_pages=4)
    try:
        expA = jax_generate(jnet, pA[None], 4, temperature=0.0)[0]
        np.testing.assert_array_equal(eng.generate(pA, 4), expA)
        cached = eng.stats()["prefix_cache"]["cached_pages"]
        assert cached >= 2
        # big needs max(16, 9+24-1)=32 positions -> 4 pages == the pool:
        # admission must evict the cache to proceed
        expBig = jax_generate(jnet, big[None], 24, temperature=0.0)[0]
        np.testing.assert_array_equal(eng.generate(big, 24), expBig)
        st = eng.stats()
        assert st["prefix_cache"]["evictions"] >= 1
        assert st["prefix_cache"]["cached_pages"] < cached + 3
    finally:
        eng.shutdown()


def test_max_pages_cap_and_page_ledger_balance(nets):
    """A `max_pages`-capped cache hands every cap-evicted page back to
    the free list: free + cached always equals the pool, and after a
    failure-driven rebuild the cache is empty and the ledger whole."""
    jnet, pnet = nets
    eng = _engine(pnet, n_slots=1, pool_pages=5,
                  prefix_cache={"max_pages": 1})
    try:
        for seed in range(4):  # distinct prefixes force cap evictions
            p = np.random.default_rng(100 + seed).integers(0, VOCAB, 18) \
                .astype(np.int32)
            exp = jax_generate(jnet, p[None], 3, temperature=0.0)[0]
            np.testing.assert_array_equal(eng.generate(p, 3), exp)
        pc = eng.stats()["prefix_cache"]
        assert pc["evictions"] >= 1 and pc["cached_pages"] <= 1
        with eng._cond:
            free = len(eng._free_pages)
        assert free + pc["cached_pages"] == eng.pool_pages, \
            "cap-driven eviction leaked a pool page"
        assert eng.stats()["pages_in_use"] == pc["cached_pages"]
        eng._reset_device_state()  # what a failed dispatch triggers
        st = eng.stats()
        assert st["prefix_cache"]["cached_pages"] == 0
        assert st["pages_in_use"] == 0
        assert sorted(eng._free_pages) == [1, 2, 3, 4, 5]
    finally:
        eng.shutdown()


def test_prefix_cache_with_one_shot_prompts_and_concurrent_hits(nets):
    """Short prompts prefill one-shot and still promote their full pages;
    three same-prefix requests in flight at once share them and stay
    exact."""
    jnet, pnet = nets
    prompts = _shared_prompts(4, prefix_len=8, tail_len=3, seed=15)
    eng = _engine(pnet, n_slots=3, prompt_buckets=(16,))
    try:
        exp0 = jax_generate(jnet, prompts[0][None], 5, temperature=0.0)[0]
        np.testing.assert_array_equal(eng.generate(prompts[0], 5), exp0)
        assert eng.stats()["prefills"] == 1
        assert eng.stats()["prefill_chunks"] == 0       # one-shot
        reqs = [eng.submit(p, 7) for p in prompts[1:]]
        for p, r in zip(prompts[1:], reqs):
            exp = jax_generate(jnet, p[None], 7, temperature=0.0)[0]
            np.testing.assert_array_equal(r.result(timeout=120.0), exp)
        pc = eng.stats()["prefix_cache"]
        assert pc["hits"] == 3 and pc["hit_tokens"] == 24
        assert eng.stats()["pages_in_use"] == pc["cached_pages"] == 1
    finally:
        eng.shutdown()
