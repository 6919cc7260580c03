"""Tensor-parallel decode in the port (`serving/tp_engine.py` and
`DecodeEngine(parallel=)`) held against the JAX package on the CPU, at
small size (vocab 48, d_model 32, 2 layers), on 8 CPU slots
(`parallel.mesh.set_local_slots(8, "cpu")`, the counterpart of the JAX
tests' forced host devices).

The port's tp=2 engine must give f32 greedy tokens identical to the JAX
package's whole-batch `generate` on the same weights (`params_from_jax`)
across chunked prefill, prefix hits, speculative decoding (self and a
separate draft), GQA + RoPE + SwiGLU and int8 KV (against the port's
single-device int8 engine, as the JAX test holds its int8 engine). Also
pinned, as in `tests/test_tp_engine.py`: the typed construction errors,
the stats schema, the `{tp_rank}` gauges through the gateway's metrics,
the per-slot byte accounting, `ModelServer` routing, the `[Q_t | K_t |
V_t]` permutation (equal to the JAX plan's), one contiguous pool tensor
per slot, and each shard's paged attention in its own slot. Every engine
is shut down in `finally`.
"""
import time
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    GPTPlan as JaxPlan,
    generate as jax_generate,
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.serving.tp_engine import (  # noqa: E402
    TPPlan as JaxTPPlan,
)
from deeplearning4j_tpu_torch.models.transformer import GPTPlan  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import paged_attention as pa  # noqa: E402
from deeplearning4j_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    DecodeEngine,
    ModelServer,
    PrefixDirectory,
    SlotMigratedError,
    observability,
)
from deeplearning4j_tpu_torch.serving.tp_engine import (  # noqa: E402
    TPPlan,
    tp_mesh,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)

VOCAB = 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_eight_slots():
    """One torch intra-op thread (the tier runs several xdist workers on
    one host) and 8 CPU slots while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = pmesh._SLOTS
    pmesh.set_local_slots(8, "cpu")
    yield
    pmesh._SLOTS = saved
    torch.set_num_threads(n)


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


def _prompts(n, t0, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, t0)) \
        .astype(np.int32)


def _engine(net, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("prompt_buckets", (8,))
    kw.setdefault("parallel", {"tp": 2})
    kw.setdefault("device", "cpu")
    return DecodeEngine(net, **kw)


def _run(eng, prompts, n):
    reqs = [eng.submit(p, n) for p in prompts]
    return [r.result(timeout=120.0) for r in reqs]


# ------------------------------------------------------------- parity
def test_tp_parity_and_prefix_hits(nets):
    """f32 tokens equal to the JAX `generate`; prefix-cache promotion and
    the hit path reuse head-split pages (the page table is host-global).
    Each shard's paged attention runs in its own slot."""
    jnet, pnet = nets
    prompts = _prompts(4, 20)
    expected = jax_generate(jnet, prompts, 6, temperature=0.0)
    eng = _engine(pnet, max_len=48, prefix_cache={}, page_size=8)
    pa.reset_counts()
    try:
        for p, e in zip(prompts, expected):
            np.testing.assert_array_equal(
                eng.submit(p, 6).result(timeout=120.0), e)
        np.testing.assert_array_equal(
            eng.submit(prompts[0], 6).result(timeout=120.0), expected[0])
        st = eng.stats()
    finally:
        eng.shutdown()
    assert st["tp_degree"] == 2
    assert st["prefix_cache"]["hits"] >= 1
    by_slot = pa.paged_attention_plain.calls_by_slot
    assert by_slot.get(0, 0) > 0 and by_slot.get(0) == by_slot.get(1)
    assert by_slot.get(None, 0) == 0


def test_tp_parity_chunked_prefill_gqa_rope_swiglu():
    """Chunked prefill x GQA x RoPE x SwiGLU: tp=2 divides Hkv=2, each
    slot's grouping is (H/2)/(Hkv/2) == H/Hkv."""
    jnet, pnet = _pair(n_heads=4, n_kv_heads=2, rope=True,
                       ffn_activation="swiglu")
    prompts = _prompts(2, 20, seed=1)
    expected = jax_generate(jnet, prompts, 6, temperature=0.0)
    eng = _engine(pnet, max_len=48, prompt_buckets=(4,), prefill_chunk=8,
                  page_size=8)
    try:
        outs = _run(eng, prompts, 6)
        st = eng.stats()
    finally:
        eng.shutdown()
    for e, o in zip(expected, outs):
        np.testing.assert_array_equal(e, o)
    assert st["prefill_chunks"] > 0


def test_tp_parity_int8_kv_matches_single_device_int8(nets):
    """int8 KV is quantized per (head, position), head-local: the tp=2
    int8 engine gives the single-device int8 engine's tokens."""
    _, pnet = nets
    prompts = _prompts(4, 5, seed=2)
    ref_eng = _engine(pnet, parallel=None, quantize={"kv": "int8"})
    try:
        ref = _run(ref_eng, prompts, 6)
    finally:
        ref_eng.shutdown()
    eng = _engine(pnet, quantize={"kv": "int8"})
    try:
        outs = _run(eng, prompts, 6)
        st = eng.stats()
    finally:
        eng.shutdown()
    for r, o in zip(ref, outs):
        np.testing.assert_array_equal(r, o)
    assert st["kv_quant_bits"] == 8
    assert st["tp_kv_bytes_per_token_per_shard"] * 2 \
        == st["kv_bytes_per_token"]


@pytest.mark.parametrize("draft", ["self", "separate"])
def test_tp_parity_speculative(nets, draft):
    """Speculative verify under tensor parallelism: a self-draft shares
    the engine's split params, a separate draft gets its own TPPlan; a
    garbage draft costs acceptance, never parity."""
    jnet, pnet = nets
    d = "self" if draft == "self" else _pair(seed=777, n_layers=1)[1]
    prompts = _prompts(4, 5, seed=3)
    expected = jax_generate(jnet, prompts, 6, temperature=0.0)
    eng = _engine(pnet, speculative={"draft": d, "k": 2})
    try:
        outs = _run(eng, prompts, 6)
        st = eng.stats()
        dtp = eng._spec._dtp
    finally:
        eng.shutdown()
    for e, o in zip(expected, outs):
        np.testing.assert_array_equal(e, o)
    if draft == "self":
        assert st["spec_accept_rate"] > 0 and dtp is eng._tp
    else:
        assert isinstance(dtp, TPPlan) and dtp is not eng._tp


# ------------------------------------------- construction-time errors
def test_invalid_tp_configs_raise_typed_errors_at_construction(nets):
    _, pnet = nets
    cases = [
        ({"tp": 4}, "must divide the head counts"),   # n_heads=2
        ({"pp": 2}, "unknown parallel keys"),
        ({"tp": "2"}, "must be a positive int"),
        ({"tp": 0}, "must be a positive int"),
        ({"tp": 16}, "needs 16 devices"),
    ]
    for cfg, frag in cases:
        with pytest.raises(ValueError, match=frag):
            _engine(pnet, parallel=cfg)
    with pytest.raises(ValueError, match="must be a dict"):
        _engine(pnet, parallel=7)
    with pytest.raises(ValueError, match="logprobs"):
        _engine(pnet, logprobs=2)


def test_tp_rejects_gqa_heads_moe_and_ffn_width():
    _, g = _pair(n_heads=4, n_kv_heads=2)
    with pytest.raises(ValueError, match="must divide the head counts"):
        _engine(g, parallel={"tp": 4})
    _, moe = _pair(moe_experts=4)
    with pytest.raises(ValueError, match="does not compose with MoE"):
        _engine(moe)
    _, odd = _pair()
    plan = GPTPlan(odd)
    odd._params[plan.block_is[0]]["W1"] = torch.zeros((32, 97))
    with pytest.raises(ValueError, match="must divide the FFN width"):
        TPPlan(odd, plan, 2)
    gpu = torch.device("cuda", 0)
    saved = pmesh._SLOTS
    pmesh._SLOTS = [gpu] * 2
    try:
        _, net = _pair()
        with pytest.raises(ValueError, match="not the network's device"):
            TPPlan(net, GPTPlan(net), 2)
    finally:
        pmesh._SLOTS = saved


# ------------------------------------------------ the plan's layout
def test_qkv_permutation_and_splits_match_the_jax_plan():
    """The column permutation is the JAX plan's; each slot's Wqkv block
    is [Q_t | K_t | V_t]; every slot owns one contiguous pool tensor."""
    jnet, pnet = _pair(n_heads=4, n_kv_heads=2)
    jplan = JaxTPPlan(jnet, JaxPlan(jnet), 2)
    tp = TPPlan(pnet, GPTPlan(pnet), 2)
    for i in tp._perms:
        np.testing.assert_array_equal(tp._perms[i], jplan._perms[i])
    assert [None if not isinstance(s, dict) else
            {k: tuple(v) for k, v in s.items()} for s in tp.param_specs] == \
        [None if not isinstance(s, dict) else
         {k: tuple(v) for k, v in s.items()} for s in jplan.param_specs]
    sp = tp.shard_params(pnet._params)
    i = tp.plan.block_is[0]
    W = pnet._params[i]["Wqkv"]
    hd = 8
    for t in range(2):
        shard = sp[i]["Wqkv"].shards[t]
        np.testing.assert_array_equal(shard[:, :2 * hd],
                                      W[:, 2 * hd * t:2 * hd * (t + 1)])
        np.testing.assert_array_equal(shard[:, 2 * hd:3 * hd],
                                      W[:, 32 + hd * t:32 + hd * (t + 1)])
    pool = torch.arange(5 * 2 * 8 * 4, dtype=torch.float32) \
        .reshape(5, 2, 8, 4)
    sh = tp.shard_pool(pool)
    assert [tuple(s.shape) for s in sh.shards] == [(5, 1, 8, 4)] * 2
    assert all(s.is_contiguous() for s in sh.shards)
    assert torch.equal(sh.shards[1], pool[:, 1:2])


# ------------------------------------------------ stats/metrics schema
def test_tp_stats_keys_are_schema_pinned(nets):
    _, pnet = nets
    assert {"tp_degree", "tp_kv_bytes_per_token_per_shard"} \
        <= observability.DECODE_ENGINE_STATS_KEYS
    eng = _engine(pnet, parallel=None)
    try:
        st = eng.stats()
        assert st["tp_degree"] == 1
        assert st["tp_kv_bytes_per_token_per_shard"] \
            == st["kv_bytes_per_token"]
        assert observability.DECODE_ENGINE_STATS_KEYS <= set(st)
    finally:
        eng.shutdown()


def test_tp_rank_labelled_gauges_through_gateway_metrics(nets):
    """Per-shard gauges carry a `{tp_rank}` label merged with the
    gateway's `{model}` label on the one scrape surface."""
    from deeplearning4j_tpu_torch.gateway import EntryPoint

    jnet, _ = nets
    ep = EntryPoint(serving={
        "generation": {"n_slots": 2, "max_len": 32, "prompt_buckets": (8,)},
        "parallel": {"tp": 2}}, device="cpu")
    try:
        ep.create_model("m", jnet.conf.to_json())
        ep._models["m"].set_param_tree(params_from_jax(
            ep._models["m"].conf,
            [{k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
        prompt = _prompts(1, 5)[0]
        out = np.asarray(ep.generate("m", prompt, 6, temperature=0.0, seed=0))
        np.testing.assert_array_equal(
            out, jax_generate(jnet, prompt[None], 6, temperature=0.0)[0])
        text = ep.metrics("m")
    finally:
        ep.shutdown()
    lines = [ln for ln in text.splitlines()
             if "tp_shard_kv_bytes_per_token" in ln and not ln.startswith("#")]
    assert len(lines) == 2, text
    for rank, ln in enumerate(sorted(lines)):
        assert f'tp_rank="{rank}"' in ln
        assert 'model="m"' in ln
    assert "stats_decode_engine_tp_degree" in text


# -------------------------------------------------- capacity accounting
def test_tp_halves_sharded_bytes_per_chip(nets):
    """Block matmuls and the pools' head axis divide by the degree;
    replicated tensors (embeddings, LNs, biases, the head) do not."""
    _, pnet = nets
    single = _engine(pnet, parallel=None)
    try:
        b1 = single.model_bytes_per_chip()
        pool1 = sum(x.nbytes for c in single._caches for x in c)
    finally:
        single.shutdown()
    eng = _engine(pnet)
    try:
        b2 = eng.model_bytes_per_chip()
        tp = eng._tp
        wpc = tp.weight_bytes_per_chip(pnet._params)
        shard_pool = sum(x.shard_nbytes() for c in eng._caches for x in c)
    finally:
        eng.shutdown()
    assert b2 < b1
    assert b2 - wpc == pool1 // 2 == shard_pool
    plan = GPTPlan(pnet)
    sharded = sum(v.nbytes for i in plan.block_is
                  for k, v in pnet._params[i].items()
                  if tuple(tp.param_specs[i][k]) != ())
    assert sharded > 0
    assert wpc == b1 - pool1 - sharded + sharded // 2


# ----------------------------------------------- server/pool composition
def test_model_server_routes_parallel_to_engine(nets):
    jnet, pnet = nets
    srv = ModelServer(pnet, generation={"n_slots": 2, "max_len": 32,
                                        "prompt_buckets": (8,)},
                      parallel={"tp": 2})
    try:
        prompt = _prompts(1, 5)[0]
        np.testing.assert_array_equal(
            srv.generate(prompt, 6, temperature=0.0, seed=0),
            jax_generate(jnet, prompt[None], 6, temperature=0.0)[0])
        assert srv._engine.stats()["tp_degree"] == 2
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="must be a dict"):
        ModelServer(pnet, parallel=[2])


def test_tp_mesh_is_cached_and_replicas_get_their_slots():
    """`tp_mesh` keeps one mesh per degree while the slots stay; a
    supervised replica of a tp=2 server is started with `--slots 2`."""
    from deeplearning4j_tpu_torch.serving.remote_replica import (
        ReplicaSupervisor,
    )

    m = tp_mesh(2)
    assert tp_mesh(2) is m and m.shape == {"tp": 2}
    sup = ReplicaSupervisor.__new__(ReplicaSupervisor)
    sup._python, sup._host, sup.ports = "python", "127.0.0.1", [1]
    sup._model_path, sup._scratch, sup.device = "m.zip", Path("."), "cpu"
    sup._serving = {"parallel": {"tp": 2}}
    sup._chaos = frozenset()
    cmd = sup._cmd(0)
    assert cmd[cmd.index("--slots") + 1] == "2"


# ------------------------------------------- handoffs out of and into tp>1
def _await(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    pytest.fail(f"timed out after {timeout:.0f}s waiting for {what}")


def _slow(phase, info):
    """A pre-decode drag on the sender, so the export lands mid-decode."""
    if phase == "pre_decode":
        time.sleep(0.02)


@pytest.mark.parametrize("src_tp,dst_tp,kv", [
    (2, 2, None), (2, 1, None), (1, 2, None), (2, 1, "int8")],
    ids=["tp2-to-tp2", "tp2-to-tp1", "tp1-to-tp2", "tp2-to-tp1-int8"])
def test_tp_warm_migration_across_degrees(nets, src_tp, dst_tp, kv):
    """A live slot exported mid-decode from an engine at one degree and
    resumed on an engine at another: the shipped pages are the whole
    head axis (each shard's pages joined on the way out, split on the way
    in), so the spliced tokens equal the uninterrupted run: the JAX
    `generate` in f32 (exact), the port's one-device int8 engine with
    int8 KV (exact: the same int8 pages and scales)."""
    jnet, pnet = nets
    prompt = _prompts(1, 13, seed=5)[0]
    kw = dict(page_size=8, decode_chunk=1, max_len=40)
    if kv:
        kw["quantize"] = {"kv": kv}
        ref = _engine(pnet, parallel=None, **kw)
        try:
            expected = ref.generate(prompt, 12)
        finally:
            ref.shutdown()
    else:
        expected = jax_generate(jnet, prompt[None], 12, temperature=0.0)[0]

    def par(tp):
        return {"tp": tp} if tp > 1 else None

    src = _engine(pnet, parallel=par(src_tp), step_hooks=[_slow], **kw)
    dst = _engine(pnet, parallel=par(dst_tp), **kw)
    try:
        req = src.submit(prompt, 12, timeout=120.0)
        _await(lambda: len(req.tokens) >= 3, 60.0, "3 tokens before export")
        assert src.migrate_slots(wait=10.0) == 1
        with pytest.raises(SlotMigratedError) as ei:
            req.result(timeout=60.0)
        payload = src.fetch_handoff(ei.value.handoff_id)
        assert payload["kind"] == "warm"
        assert all(np.asarray(b["k"]).shape[1] == 2
                   for b in payload["blocks"])  # every KV head shipped
        tail = dst.resume_generate(payload, timeout=120.0)
        out = np.concatenate([np.asarray(ei.value.tokens, np.int32),
                              np.asarray(tail, np.int32).reshape(-1)])
        np.testing.assert_array_equal(out, expected)
        assert src.commit_handoff(ei.value.handoff_id) is True
        assert src.stats()["pages_in_use"] == 0
        assert dst.stats()["migrations_in"] == 1
    finally:
        src.shutdown()
        dst.shutdown()


@pytest.mark.parametrize("holder_tp,fetcher_tp", [(2, 1), (1, 2)],
                         ids=["tp2-holder", "tp2-fetcher"])
def test_tp_cluster_prefix_fetch_across_degrees(nets, holder_tp,
                                                fetcher_tp):
    """A cluster prefix fetch between engines at different degrees: the
    holder's chain pages ship whole-head, the fetcher binds them into
    its own (split or unsplit) pools, and its tokens equal the JAX
    `generate` with the fetched pages skipping prefill."""
    jnet, pnet = nets
    p = _prompts(1, 21, seed=6)[0]
    expected = jax_generate(jnet, p[None], 6, temperature=0.0)[0]
    kw = dict(max_len=40, page_size=8, prefill_chunk=8, prefix_cache=True)
    d, peers = PrefixDirectory(), {}
    holder = _engine(pnet, parallel={"tp": 2} if holder_tp > 1 else None,
                     **kw)
    fetcher = _engine(pnet, parallel={"tp": 2} if fetcher_tp > 1 else None,
                      **kw)
    peers["a"], peers["b"] = holder, fetcher
    holder.bind_prefix_directory(d, "a", peers.get, frame_pages=1)
    fetcher.bind_prefix_directory(d, "b", peers.get, frame_pages=1)
    try:
        np.testing.assert_array_equal(holder.generate(p, 6), expected)
        np.testing.assert_array_equal(fetcher.generate(p, 6), expected)
        st = fetcher.stats()
        assert st["prefix_fetches"] == 1
        assert st["prefix_fetch_fallbacks"] == 0
        assert st["cluster_prefix_hit_tokens"] == 16
        assert holder.stats()["prefix_exports"] == 1
    finally:
        holder.shutdown()
        fetcher.shutdown()
