"""The port's speculative decoding (`serving/speculative.py` and its
wiring in `DecodeEngine`) held against the JAX package on the CPU at
small size (vocab 48, d_model 32, 2 layers).

Greedy speculative decode must equal the JAX `generate`'s and the JAX
speculative engine's tokens exactly, for a draft that proposes garbage
and for the target as its own draft, under two admission orders; it
composes with EOS, the prefix cache, chunked prefill, GQA + RoPE + SwiGLU
and int8 KV. Sampled decode is deterministic per seed and its first
emitted token follows the target distribution (a Monte-Carlo
total-variation test; the two packages' random generators never agree,
so the port is held to the analytic distribution, not to JAX's draws).
Every engine is shut down in `finally`.
"""
import json

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
from deeplearning4j_tpu_torch.models.transformer import (  # noqa: E402
    generate,
)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving import DecodeEngine  # noqa: E402
from deeplearning4j_tpu_torch.serving.speculative import (  # noqa: E402
    SpeculativeDecoder,
    resolve_draft_net,
)
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


def _pair(seed=12345, **kw):
    kw = dict(dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2,
                   max_length=64, seed=seed), **kw)
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


@pytest.fixture(scope="module")
def drafts():
    # a DIFFERENT random net: its proposals are garbage to the target,
    # which is exactly what the exactness contract must survive
    return _pair(seed=999)


def _engine(net, **kw):
    kw = dict(dict(n_slots=2, max_len=32, prompt_buckets=(8,)), **kw)
    return DecodeEngine(net, device="cpu", **kw)


def _shared_prompts(n_tails, prefix_len=16, tail_len=4, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, VOCAB, prefix_len).astype(np.int32)
    return [np.concatenate(
        [prefix, rng.integers(0, VOCAB, tail_len).astype(np.int32)])
        for _ in range(n_tails)]


@pytest.mark.parametrize("draft_kind", ["garbage", "self"])
def test_spec_greedy_parity_two_orders(nets, drafts, draft_kind):
    """Greedy speculative decode equals JAX generate and the JAX
    speculative engine for any draft, under two admission orders with
    slot reuse."""
    jnet, pnet = nets
    jdraft, pdraft = ("self", "self") if draft_kind == "self" else drafts
    prompts = np.random.default_rng(17).integers(0, VOCAB, (4, 5)) \
        .astype(np.int32)
    expected = jax_generate(jnet, prompts, 8, temperature=0.0)
    jeng = JaxEngine(jnet, n_slots=2, max_len=32, prompt_buckets=(8,),
                     speculative={"draft": jdraft, "k": 3})
    try:
        jreqs = [jeng.submit(p, 8) for p in prompts]
        for r, e in zip(jreqs, expected):
            np.testing.assert_array_equal(r.result(timeout=120.0), e)
    finally:
        jeng.shutdown()
    for order in ([0, 1, 2, 3], [3, 1, 0, 2]):
        eng = _engine(pnet, speculative={"draft": pdraft, "k": 3})
        try:
            reqs = {i: eng.submit(prompts[i], 8) for i in order}
            for i in order:
                np.testing.assert_array_equal(
                    reqs[i].result(timeout=120.0), expected[i])
            st = eng.stats()
            assert st["speculative"]["verify_steps"] >= 3
            assert st["speculative"]["draft_is_target"] == \
                (draft_kind == "self")
            assert st["speculative"]["draft_prefills"] == 4
            assert st["pages_in_use"] == 0
        finally:
            eng.shutdown()


def test_spec_self_draft_accepts_all_and_multi_tokens(nets):
    """The target as its own draft, in f32: every consumable proposal is
    accepted, a verify step emits k+1 tokens per slot, parity holds, and
    the accept counters match the JAX engine's."""
    jnet, pnet = nets
    prompts = np.random.default_rng(19).integers(0, VOCAB, (3, 5)) \
        .astype(np.int32)
    expected = jax_generate(jnet, prompts, 10, temperature=0.0)
    jeng = JaxEngine(jnet, n_slots=2, max_len=32, prompt_buckets=(8,),
                     speculative={"draft": "self", "k": 3})
    eng = _engine(pnet, speculative={"draft": "self", "k": 3})
    try:
        for i in (1, 2, 0):
            jeng.generate(prompts[i], 10)
            np.testing.assert_array_equal(eng.generate(prompts[i], 10),
                                          expected[i])
        st, jst = eng.stats(), jeng.stats()
        assert st["spec_accept_rate"] == 100.0
        sp = st["speculative"]
        assert sp["accepted"] == sp["proposed"]
        # one request per step: of the 9 tokens after the prefill token,
        # two verify steps emit k+1 = 4 each and a plain step the last
        assert st["spec_tokens_per_step"] == 4.0
        for k in ("verify_steps", "proposed", "accepted", "emitted"):
            assert sp[k] == jst["speculative"][k], k
    finally:
        jeng.shutdown()
        eng.shutdown()


def test_spec_eos_retires_early_and_slot_reuses(nets):
    """EOS landing mid-verify drops the overshoot tokens, retires the
    slot, and the next occupant decodes exactly."""
    jnet, pnet = nets
    prompts = np.random.default_rng(23).integers(0, VOCAB, (2, 5)) \
        .astype(np.int32)
    full = jax_generate(jnet, prompts[:1], 12, temperature=0.0)[0]
    eos = int(full[4])
    eng = _engine(pnet, n_slots=1, eos_token=eos,
                  speculative={"draft": "self", "k": 3})
    try:
        got = eng.generate(prompts[0], 12)
        stop = int(np.argmax(full == eos))
        np.testing.assert_array_equal(got, full[:stop + 1])
        exp2 = jax_generate(jnet, prompts[1:2], 6, temperature=0.0)[0]
        if eos in exp2:
            exp2 = exp2[:int(np.argmax(exp2 == eos)) + 1]
        np.testing.assert_array_equal(eng.generate(prompts[1], 6), exp2)
        st = eng.stats()
        assert st["speculative"]["emitted"] == \
            st["tokens_generated"] - st["prefills"]
    finally:
        eng.shutdown()


def test_spec_composes_with_prefix_cache_chunked_prefill_gqa():
    """The full tier at once: GQA + RoPE + SwiGLU target and draft,
    chunked prefill of a shared prefix, a prefix hit, speculative verify:
    still equal to JAX generate."""
    kw = dict(n_heads=4, n_kv_heads=2, rope=True, ffn_activation="swiglu")
    jnet, pnet = _pair(**kw)
    _, pdraft = _pair(seed=55, **kw)
    pA, pB = _shared_prompts(2, seed=21, tail_len=6)
    eng = _engine(pnet, max_len=48, prompt_buckets=(4,), page_size=8,
                  prefill_chunk=8, prefix_cache=True,
                  speculative={"draft": pdraft, "k": 2})
    try:
        for p in (pA, pB):
            exp = jax_generate(jnet, p[None], 7, temperature=0.0)[0]
            np.testing.assert_array_equal(eng.generate(p, 7), exp)
        st = eng.stats()
        assert st["prefix_cache"]["hits"] == 1
        assert st["prefill_chunks"] >= 3
        # the draft's pools mirror every target chunk; the hit skips both
        assert st["speculative"]["draft_chunk_prefills"] \
            == st["prefill_chunks"]
    finally:
        eng.shutdown()


def test_int8_kv_chunked_prefill_speculative_and_prefix_reuse(nets):
    """int8 KV through the whole latency tier at once: quantized spans
    written a page at a time, draft pools quantized on their own, verify
    reading dequantized chunks, a prefix hit re-serving pages quantized
    by an earlier request; tokens equal the JAX engine's."""
    jnet, pnet = nets
    long_prompt = np.random.default_rng(1).integers(0, VOCAB, (1, 24)) \
        .astype(np.int32)
    exp = jax_generate(jnet, long_prompt, 6, temperature=0.0)[0]
    kw = dict(n_slots=2, max_len=48, prompt_buckets=(8,), page_size=8,
              prefill_chunk=8, prefix_cache=True,
              speculative={"draft": "self", "k": 3},
              quantize={"kv": "int8"})
    jeng = JaxEngine(jnet, **kw)
    eng = DecodeEngine(pnet, device="cpu", **kw)
    try:
        j1 = jeng.submit(long_prompt[0], 6).result(timeout=180.0)
        r1 = eng.submit(long_prompt[0], 6).result(timeout=180.0)
        r2 = eng.submit(long_prompt[0], 6).result(timeout=180.0)
        assert np.mean(r1 != exp) <= 0.2
        np.testing.assert_array_equal(r1, j1)
        np.testing.assert_array_equal(r1, r2)  # hit path == miss path
        st = eng.stats()
        assert st["speculative"]["verify_steps"] >= 1
        assert st["prefix_cache"]["hits"] >= 1
        assert st["kv_quant_bits"] == 8
        assert all(len(c) == 4 and c[0].dtype == torch.int8
                   for c in eng._spec._caches)
    finally:
        jeng.shutdown()
        eng.shutdown()


def test_spec_sampled_deterministic_per_seed(nets):
    """Sampled speculative decode is reproducible per request seed and
    varies across seeds; greedy neighbours in the same batch stay exact."""
    jnet, pnet = nets
    rng = np.random.default_rng(29)
    p = rng.integers(0, VOCAB, 5).astype(np.int32)
    g = rng.integers(0, VOCAB, 6).astype(np.int32)
    exp_g = jax_generate(jnet, g[None], 10, temperature=0.0)[0]
    eng = _engine(pnet, speculative={"draft": "self", "k": 3})
    try:
        a = eng.generate(p, 10, temperature=0.8, seed=3)
        greedy = eng.submit(g, 10)
        b = eng.generate(p, 10, temperature=0.8, seed=3)
        np.testing.assert_array_equal(greedy.result(timeout=120.0), exp_g)
        np.testing.assert_array_equal(a, b)
        assert a.shape == (10,) and a.min() >= 0 and a.max() < VOCAB
        others = [eng.generate(p, 10, temperature=0.8, seed=s)
                  for s in (4, 5, 6)]
        assert any(not np.array_equal(a, o) for o in others)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("k,wlimit", [(2, 10), (2, 0)])
def test_spec_sampled_distribution_faithful(nets, drafts, k, wlimit):
    """Leviathan exactness, Monte-Carlo pinned: with a draft whose
    distribution differs from the target's, the FIRST emitted token of a
    verify step is distributed as a vanilla sample from the target
    distribution p, whether the stop is a rejection, a run of accepted
    proposals, or forced by the write budget (`wlimit` 0). S slots with
    the same context and independent generators give S draws in one
    call."""
    _, pnet = nets
    _, pdraft = drafts
    S, T = 4096, 0.8
    eng = _engine(pnet, n_slots=S, max_len=16, page_size=8,
                  speculative={"draft": pdraft, "k": k})
    try:
        spec = eng._spec
        tok_id = 7
        tok = torch.full((S,), tok_id, dtype=torch.int64)
        pos = torch.zeros((S,), dtype=torch.int32)
        temps = np.full((S,), T, np.float32)
        active_np = np.ones((S,), bool)
        active = torch.from_numpy(active_np)
        wl = torch.full((S,), wlimit, dtype=torch.int32)
        table = np.zeros((S, eng._n_pages_max), np.int32)
        table[:, 0] = np.arange(1, S + 1)  # distinct pages: no aliasing
        table = torch.from_numpy(table)
        gens = [torch.Generator().manual_seed(s) for s in range(S)]
        spec._gens = [torch.Generator().manual_seed(10 ** 6 + s)
                      for s in range(S)]
        props, qd = spec.propose(table, tok, pos, temps, active, active_np,
                                 wl)
        assert props.shape == (S, k) and qd.shape == (S, k, VOCAB)
        _, new_pos, out, n_emit, oks = spec.verify(
            eng._bparams, eng._params, eng._caches, table, tok, pos, temps,
            gens, active, active_np, wl, props, qd)
        assert bool(oks.all())
        if wlimit == 0:   # no write budget: a vanilla step per slot
            assert bool((n_emit == 1).all()) and bool((new_pos == 1).all())
        else:
            assert int(n_emit.max()) > 1
        first = out[:, 0].numpy()
        # the analytic target distribution for the 1-token context [tok]:
        # softmax(logits / T); the softmax head's probabilities recover
        # the logits up to a constant, which softmax cancels
        probs = pnet.output(np.asarray([[tok_id]]))[0, -1].numpy()
        p_exact = np.exp(np.log(np.maximum(probs, 1e-30)) / T)
        p_exact /= p_exact.sum()
        emp = np.bincount(first, minlength=VOCAB).astype(np.float64) / S
        tv = 0.5 * np.abs(emp - p_exact).sum()
        # E[TV] of 4096 draws over 48 near-uniform bins is about 0.04; a
        # biased accept/resample rule (consulting the unconsumed accept
        # coin on forced stops, or emitting the residual there) shifts it
        # by 0.1 or more
        assert tv < 0.07, f"total-variation {tv:.3f} vs exact target"
        # the draft's own distribution is far from the target's: emitting
        # proposals unverified would fail this
        q_first = qd[:, 0].mean(dim=0).numpy()
        assert 0.5 * np.abs(q_first - p_exact).sum() > 0.1
    finally:
        eng.shutdown()


def test_draft_from_config_dict_and_bad_drafts(nets):
    """A config-JSON dict builds a fresh draft on the target's device;
    bad drafts, options and vocabularies raise."""
    jnet, pnet = nets
    conf = json.loads(pnet.conf.to_json())
    draft = resolve_draft_net(conf, pnet)
    assert isinstance(draft, MultiLayerNetwork) and draft is not pnet
    assert draft.device == pnet.device
    assert resolve_draft_net("self", pnet) is pnet
    assert resolve_draft_net(draft, pnet) is draft
    p = np.random.default_rng(31).integers(0, VOCAB, 5).astype(np.int32)
    eng = _engine(pnet, speculative={"draft": conf, "k": 2})
    try:
        np.testing.assert_array_equal(
            eng.generate(p, 6),
            generate(pnet, p[None], 6, temperature=0.0, device="cpu")[0])
        assert eng.stats()["speculative"]["k"] == 2
    finally:
        eng.shutdown()
    with pytest.raises(ValueError, match="needs a"):
        _engine(pnet, speculative={"k": 2})
    with pytest.raises(ValueError, match="unknown speculative draft"):
        _engine(pnet, speculative={"draft": "other"})
    with pytest.raises(ValueError, match="unknown speculative options"):
        _engine(pnet, speculative={"draft": "self", "depth": 2})
    with pytest.raises(ValueError, match="k must be >= 1"):
        _engine(pnet, speculative={"draft": "self", "k": 0})
    _, small_vocab = _pair(vocab_size=VOCAB - 8)
    with pytest.raises(ValueError, match="vocab"):
        _engine(pnet, speculative={"draft": small_vocab})
    with pytest.raises(NotImplementedError, match="A11"):
        SpeculativeDecoder(target_plan=None, target_net=pnet, draft_net=pnet,
                           k=2, n_slots=1, page=8, L_logical=16,
                           pool_pages=2, top_k=0, tp=object())
