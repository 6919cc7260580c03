"""The port's KV handoff and live migration (`serving/kv_transfer.py`
and the engine's handoff half) held against the JAX package on the CPU
at small size (vocab 48, d_model 32, 2 layers, pages of 8 or 16).

- A request migrated mid-decode (warm: its pages, registers and
  sampling generator ship under a lease) and resumed on a peer emits the
  tokens of the uninterrupted run: greedy equal to the JAX package's
  `generate` in f32, across chunked prefill, a prefix-cache hit,
  speculative decoding and int8 KV (int8 and bf16: equal to an
  uninterrupted port engine of the same configuration, bit for bit), and
  sampled (temperature 1.0) equal to the uninterrupted sampled run.
- Queued requests export cold and re-prefill exactly; the prefill and
  decode roles and `DisaggCoordinator` serve with the colocated tokens.
- A flipped or truncated frame, stale weights and an expired lease are
  typed `KVTransferError`s that touch nothing; commit, abort and the TTL
  sweep free the leased pages exactly once.
- Across packages: both engines give the same weight digest, both
  checksum the same page bits alike (bf16 held as uint16 bits in the
  port), and a warm handoff (dense and int8) written by either package
  resumes in the other with the uninterrupted run's greedy tokens.

Every engine ends with its page ledger whole: free pages, pages owned by
slots and leases, and prefix-cache pages are `pool_pages` distinct ids.
"""
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    generate as jax_generate,
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.serving import DecodeEngine as JaxEngine  # noqa: E402
from deeplearning4j_tpu.serving import kv_transfer as jkv  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    DecodeEngine,
    DisaggCoordinator,
    KVTransferError,
    LeaseTable,
    SlotMigratedError,
    TenantQuotaExceededError,
)
from deeplearning4j_tpu_torch.serving import kv_transfer as pkv  # noqa: E402
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)

VOCAB = 48


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


def _pair(seed=12345, compute_dtype=None):
    jnet = JaxNet(jax_gpt_configuration(vocab_size=VOCAB, d_model=32,
                                        n_heads=2, n_layers=2, max_length=64,
                                        seed=seed))
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        compute_dtype=compute_dtype, device="cpu")
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
    # one token a scheduler step: the tests wait for "a few tokens" then
    # export, and fused decode runs would race the sequence to its end
    kw.setdefault("decode_chunk", 1)
    return DecodeEngine(net, device="cpu", **kw)


def _await(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    pytest.fail(f"timed out after {timeout:.0f}s waiting for {what}")


def _slow(dt=0.02):
    """A pre-decode drag for sender engines, so the export lands
    mid-decode."""
    def hook(phase, info):
        if phase == "pre_decode":
            time.sleep(dt)
    return hook


def _ledger_whole(eng):
    """Free pages, pages owned by slots and leases, and prefix-cache
    pages are `pool_pages` distinct ids: none freed twice, none lost."""
    with eng._cond:
        ids = list(eng._free_pages)
        for r in eng._slots:
            if r is not None and r.pages:
                ids += r.pages[r.n_shared:]
        for lease in eng._leases._leases.values():
            if lease.pages:
                ids += lease.pages[lease.n_shared:]
        if eng._prefix_cache is not None:
            ids += [n.page_id for n in eng._prefix_cache._nodes.values()]
    assert len(ids) == len(set(ids)) == eng.pool_pages, \
        (len(ids), len(set(ids)), eng.pool_pages)


def _shutdown(*engines):
    for eng in engines:
        _ledger_whole(eng)
        eng.shutdown()


def _migrate_one(src, dst, prompt, n_tokens, *, warm_tokens=2, **kw):
    """Submit on `src`, wait for `warm_tokens` tokens, migrate, resume
    on `dst`, splice. Returns (payload, tokens, handoff id)."""
    req = src.submit(prompt, n_tokens, timeout=120.0, **kw)
    if warm_tokens:
        _await(lambda: len(req.tokens) >= warm_tokens, 60.0,
               f"{warm_tokens} decode tokens before the migration")
    assert src.migrate_slots(wait=10.0) >= 1
    with pytest.raises(SlotMigratedError) as ei:
        req.result(timeout=60.0)
    redirect = ei.value
    payload = src.fetch_handoff(redirect.handoff_id)
    tail = dst.resume_generate(payload, timeout=120.0)
    out = np.concatenate([np.asarray(redirect.tokens, np.int32),
                          np.asarray(tail, np.int32).reshape(-1)])
    return payload, out, redirect.handoff_id


# ------------------------------------------------------ warm handoff parity
def test_warm_migration_mid_decode_argmax_exact_and_ledger_balanced(nets):
    jnet, pnet = nets
    prompt = _prompts(1, 5)[0]
    expected = jax_generate(jnet, prompt[None], 12, temperature=0.0)[0]
    src = _engine(pnet, step_hooks=[_slow()])
    dst = _engine(pnet)
    try:
        payload, out, hid = _migrate_one(src, dst, prompt, 12)
        assert payload["kind"] == "warm"
        assert int(payload["pages_shipped"]) >= 1
        np.testing.assert_array_equal(out, expected)
        assert src.commit_handoff(hid) is True
        assert src.commit_handoff(hid) is False
        s_src, s_dst = src.stats(), dst.stats()
        assert s_src["migrations_out"] == 1
        assert s_src["handoffs_committed"] == 1
        assert s_src["kv_transfer_bytes"] == pkv.payload_nbytes(payload) > 0
        assert s_src["handoff_leases"] == s_src["handoffs_unfetched"] == 0
        assert s_src["pages_in_use"] == 0, "sender leaked shipped pages"
        assert s_dst["migrations_in"] == 1 and s_dst["served"] == 1
        assert s_dst["pages_in_use"] == 0, "receiver leaked pages"
    finally:
        _shutdown(src, dst)


_VARIANTS = {
    "chunked-prefill": (dict(max_len=48, prompt_buckets=(4,),
                             prefill_chunk=8, page_size=8), 20, 8),
    "prefix-hit": (dict(max_len=40, page_size=8, prefill_chunk=8,
                        prefix_cache=True), 16, 8),
    "speculative": (dict(speculative={"draft": "self", "k": 3}), 5, 14),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_migration_parity_across_engine_variants(nets, variant):
    jnet, pnet = nets
    kw, t0, n = _VARIANTS[variant]
    prompt = _prompts(1, t0, seed=3)[0]
    expected = jax_generate(jnet, prompt[None], n, temperature=0.0)[0]
    src = _engine(pnet, step_hooks=[_slow()], **kw)
    dst = _engine(pnet, **kw)
    try:
        if variant == "prefix-hit":
            # warm the sender's cache: the migrated request is admitted
            # through a hit, on shared refcounted pages
            np.testing.assert_array_equal(src.generate(prompt, n), expected)
            _await(lambda: src.pending() == 0, 30.0, "warmup drain")
        _, out, hid = _migrate_one(src, dst, prompt, n)
        np.testing.assert_array_equal(out, expected)
        src.commit_handoff(hid)

        def leaked(eng):
            s = eng.stats()
            return s["pages_in_use"] \
                - s.get("prefix_cache", {}).get("cached_pages", 0)
        _await(lambda: leaked(src) == 0, 30.0, "sender ledger at zero")
        assert leaked(dst) == 0
    finally:
        _shutdown(src, dst)


@pytest.mark.parametrize("kw", [
    {"quantize": {"kv": "int8"}, "page_size": 8},
    {"page_size": 8, "bf16": True},
], ids=["int8", "bf16"])
def test_quantized_and_bf16_migration_bit_identical(kw):
    """int8 pages ship with their f32 scales, bf16 pages as uint16 bits
    named in the payload's "dtypes": the resumed run equals an
    uninterrupted port engine of the same configuration, bit for bit."""
    kw = dict(kw)
    bf16 = kw.pop("bf16", False)
    _, pnet = _pair(compute_dtype=torch.bfloat16 if bf16 else None)
    prompt = _prompts(1, 5, seed=7)[0]
    ref = _engine(pnet, **kw)
    try:
        expected = ref.generate(prompt, 10)
    finally:
        _shutdown(ref)
    src = _engine(pnet, step_hooks=[_slow()], **kw)
    dst = _engine(pnet, **kw)
    try:
        payload, out, hid = _migrate_one(src, dst, prompt, 10)
        if bf16:
            assert payload["dtypes"] == {"k": "bfloat16", "v": "bfloat16"}
            assert payload["blocks"][0]["k"].dtype == np.uint16
        else:
            assert payload["kv_quant"] == "int8"
            assert set(payload["blocks"][0]) == {"k", "v", "ks", "vs"}
        np.testing.assert_array_equal(out, expected)
        src.commit_handoff(hid)
    finally:
        _shutdown(src, dst)


def test_sampled_migration_keeps_the_stream(nets):
    """A sampled request (temperature 1.0) migrated mid-decode draws on
    from its shipped generator: its tokens equal the uninterrupted
    sampled run's with the same seed; a queued sampled request exported
    cold has drawn nothing and re-seeds to the same stream."""
    _, pnet = nets
    prompts = _prompts(2, 5, seed=31)
    ref = _engine(pnet)
    try:
        want = [ref.generate(p, 12, temperature=1.0, seed=40 + i)
                for i, p in enumerate(prompts)]
    finally:
        _shutdown(ref)
    src = _engine(pnet, n_slots=1, step_hooks=[_slow()])
    dst = _engine(pnet)
    try:
        reqs = [src.submit(p, 12, temperature=1.0, seed=40 + i,
                           timeout=120.0) for i, p in enumerate(prompts)]
        _await(lambda: len(reqs[0].tokens) >= 3, 60.0, "sampled tokens")
        assert src.migrate_slots(wait=10.0) == 2
        for i, req in enumerate(reqs):
            with pytest.raises(SlotMigratedError) as ei:
                req.result(timeout=60.0)
            payload = src.fetch_handoff(ei.value.handoff_id)
            assert payload["kind"] == ("warm", "cold")[i]
            assert ("sampler" in payload) == (i == 0)
            tail = dst.resume_generate(payload, timeout=120.0)
            np.testing.assert_array_equal(
                np.concatenate([ei.value.tokens, tail]), want[i])
            src.commit_handoff(ei.value.handoff_id)
    finally:
        _shutdown(src, dst)


def test_cold_export_of_queued_requests_reprefills_exact(nets):
    jnet, pnet = nets
    prompts = _prompts(2, 5, seed=5)
    expected = jax_generate(jnet, prompts, 16, temperature=0.0)
    src = _engine(pnet, n_slots=1, step_hooks=[_slow()])
    dst = _engine(pnet)
    try:
        reqs = [src.submit(p, 16, timeout=120.0) for p in prompts]
        _await(lambda: len(reqs[0].tokens) >= 2, 60.0, "the slot decoding")
        assert src.migrate_slots(wait=10.0) == 2
        kinds = []
        for i, req in enumerate(reqs):
            with pytest.raises(SlotMigratedError) as ei:
                req.result(timeout=60.0)
            payload = src.fetch_handoff(ei.value.handoff_id)
            kinds.append(payload["kind"])
            tail = dst.resume_generate(payload, timeout=120.0)
            np.testing.assert_array_equal(
                np.concatenate([ei.value.tokens, tail]), expected[i])
            src.commit_handoff(ei.value.handoff_id)
        assert kinds == ["warm", "cold"]
        assert src.stats()["pages_in_use"] == dst.stats()["pages_in_use"] == 0
    finally:
        _shutdown(src, dst)


# ------------------------------------------------------- disaggregated roles
def test_prefill_role_exports_decode_role_resumes(nets):
    jnet, pnet = nets
    prompt = _prompts(1, 5, seed=9)[0]
    expected = jax_generate(jnet, prompt[None], 8, temperature=0.0)[0]
    pre = _engine(pnet, role="prefill")
    dec = _engine(pnet, role="decode")
    try:
        req = pre.submit(prompt, 8, timeout=120.0)
        with pytest.raises(SlotMigratedError) as ei:
            req.result(timeout=60.0)
        payload = pre.fetch_handoff(ei.value.handoff_id)
        out = np.concatenate([ei.value.tokens,
                              dec.resume_generate(payload, timeout=120.0)])
        np.testing.assert_array_equal(out, expected)
        pre.commit_handoff(ei.value.handoff_id)
        with pytest.raises(KVTransferError, match="decode-role"):
            dec.submit(prompt, 4)
        with pytest.raises(KVTransferError, match="prefill-role"):
            pre.resume_generate(payload)
    finally:
        _shutdown(pre, dec)


def test_disagg_coordinator_parity_and_stats(nets):
    jnet, pnet = nets
    gen = {"n_slots": 2, "max_len": 32, "prompt_buckets": (8,)}
    prompts = _prompts(3, 5)
    expected = jax_generate(jnet, prompts, 6, temperature=0.0)
    co = DisaggCoordinator(pnet, server_kwargs={"generation": gen})
    try:
        for i in range(3):
            np.testing.assert_array_equal(
                co.generate(prompts[i], 6, timeout=120.0), expected[i])
        st = co.stats()
        assert st["disagg"] is True
        assert st["handoffs"] == 3 and st["fallbacks"] == 0
        assert st["kv_transfer_mbytes"] > 0
        assert st["kv_transfer_mbytes_per_sec"] > 0
        assert len(st["prefill"]) == len(st["decode"]) == 1
        for srv in co._servers:
            _ledger_whole(srv._engine)
    finally:
        co.shutdown()
    with pytest.raises(ValueError):
        DisaggCoordinator(pnet, decode_replicas=0)


# ------------------------------------------------ corruption and leases
def _flip_page(payload):
    out = dict(payload)
    blocks = [dict(b) for b in payload["blocks"]]
    k = np.array(blocks[0]["k"], copy=True)
    k.reshape(-1).view(np.uint8)[0] ^= 0xFF
    blocks[0]["k"] = k
    out["blocks"] = blocks
    return out


def _truncate(payload):
    out = dict(payload)
    out["blocks"] = [dict(b) for b in payload["blocks"]]
    out["blocks"][-1]["v"] = np.asarray(out["blocks"][-1]["v"])[:-1]
    return out


def test_corrupted_frames_refused_typed_original_still_resumes(nets):
    jnet, pnet = nets
    prompt = _prompts(1, 5, seed=13)[0]
    expected = jax_generate(jnet, prompt[None], 10, temperature=0.0)[0]
    src = _engine(pnet, step_hooks=[_slow()])
    dst = _engine(pnet)
    try:
        req = src.submit(prompt, 10, timeout=120.0)
        _await(lambda: len(req.tokens) >= 2, 60.0, "warm decode tokens")
        src.migrate_slots(wait=10.0)
        with pytest.raises(SlotMigratedError) as ei:
            req.result(timeout=60.0)
        payload = src.fetch_handoff(ei.value.handoff_id)
        with pytest.raises(KVTransferError, match="checksum"):
            dst.resume_generate(_flip_page(payload), timeout=60.0)
        with pytest.raises(KVTransferError):
            dst.resume_generate(_truncate(payload), timeout=60.0)
        assert dst.stats()["submitted"] == 0
        assert dst.stats()["pages_in_use"] == 0
        tail = dst.resume_generate(payload, timeout=120.0)
        np.testing.assert_array_equal(
            np.concatenate([ei.value.tokens, tail]), expected)
        src.commit_handoff(ei.value.handoff_id)
    finally:
        _shutdown(src, dst)


def test_lease_ttl_expiry_reclaims_orphaned_pages(nets):
    _, pnet = nets
    prompt = _prompts(1, 5, seed=17)[0]
    src = _engine(pnet, handoff_ttl=0.3, step_hooks=[_slow()])
    try:
        req = src.submit(prompt, 10, timeout=120.0)
        _await(lambda: len(req.tokens) >= 2, 60.0, "warm decode tokens")
        src.migrate_slots(wait=10.0)
        with pytest.raises(SlotMigratedError) as ei:
            req.result(timeout=60.0)
        assert src.stats()["handoff_leases"] == 1
        assert src.stats()["handoffs_unfetched"] == 1
        _await(lambda: src.stats()["handoffs_expired"] >= 1, 30.0,
               "the lease TTL sweep")
        s = src.stats()
        assert s["handoff_leases"] == 0
        assert s["pages_in_use"] == 0, "expired lease leaked pages"
        with pytest.raises(KVTransferError, match="expired"):
            src.fetch_handoff(ei.value.handoff_id)
        assert src.abort_handoff(ei.value.handoff_id) is False
    finally:
        _shutdown(src)


def test_stale_weights_refused_typed_and_abort_reclaims(nets):
    _, pnet = nets
    prompt = _prompts(1, 5, seed=19)[0]
    src = _engine(pnet, step_hooks=[_slow()])
    other = _engine(_pair(seed=999)[1])
    try:
        req = src.submit(prompt, 10, timeout=120.0)
        _await(lambda: len(req.tokens) >= 2, 60.0, "warm decode tokens")
        src.migrate_slots(wait=10.0)
        with pytest.raises(SlotMigratedError) as ei:
            req.result(timeout=60.0)
        payload = src.fetch_handoff(ei.value.handoff_id)
        with pytest.raises(KVTransferError, match="weight"):
            other.resume_generate(payload, timeout=60.0)
        assert src.abort_handoff(ei.value.handoff_id) is True
        s = src.stats()
        assert s["handoffs_aborted"] == 1 and s["pages_in_use"] == 0
    finally:
        _shutdown(src, other)


def test_tenant_kv_page_quota_sheds_typed_with_counters(nets):
    jnet, pnet = nets
    eng = _engine(pnet, page_size=8, qos={"tenants": {"t": {"max_pages": 1}}})
    prompt = _prompts(1, 8, seed=23)[0]
    expected = jax_generate(jnet, prompt[None], 8, temperature=0.0)[0]
    try:
        with pytest.raises(TenantQuotaExceededError, match="page"):
            eng.submit(prompt, 8, tenant="t")
        s = eng.stats()
        assert s["shed_page_quota"] == 1
        assert s["tenants"]["t"]["shed_page_quota"] == 1
        assert s["tenants"]["t"]["max_pages"] == 1
        assert s["tenants"]["t"]["pages_reserved"] == 0
        assert any(e["kind"] == "quota-shed"
                   for e in eng.flight_record()["events"])
        np.testing.assert_array_equal(
            eng.generate(prompt, 8, tenant="u", timeout=120.0), expected)
        eng.set_tenant_quota("t", max_pages=None)
        np.testing.assert_array_equal(
            eng.generate(prompt, 8, tenant="t", timeout=120.0), expected)
    finally:
        _shutdown(eng)


def test_lease_table_and_framing_match_the_jax_package():
    """`LeaseTable` grants, touches, resolves once and sweeps; a payload
    framed by either package reassembles and verifies in the other."""
    lt = LeaseTable(ttl=1.0)
    pay = pkv.build_payload(
        handoff_id="h1", kind="warm", weight_version="w", kv_quant=None,
        page_size=4, n_blocks=1, prompt=np.arange(6), n_tokens=3,
        temperature=0.0, seed=0, resumed_at=0, tokens=[1],
        blocks=[{"k": np.arange(5 * 8, dtype=np.float32).reshape(5, 2, 4),
                 "v": np.ones((5, 2, 4), np.float32)}], pages_shipped=5)
    lease = lt.grant(pay, pages=[3, 4], now=0.0)
    assert lt.unfetched() == 1 and lt.touch("h1", now=0.5) is lease
    assert lt.unfetched() == 0 and not lt.expired_pending(now=1.4)
    assert lt.sweep(now=1.6) == [lease] and lt.resolve("h1") is None
    with pytest.raises(ValueError):
        LeaseTable(ttl=0)
    for mod_a, mod_b in ((pkv, jkv), (jkv, pkv)):
        header = mod_a.payload_header(pay, skip_pages=2, frame_pages=2)
        frames = [mod_a.slice_frame(pay, f, skip_pages=2, frame_pages=2)
                  for f in range(header["n_frames"])]
        back = mod_b.verify_payload(mod_b.assemble_payload(header, frames))
        assert back["pages_omitted"] == 2 and back["pages_shipped"] == 3
        np.testing.assert_array_equal(back["blocks"][0]["k"],
                                      pay["blocks"][0]["k"][2:])
        with pytest.raises(mod_b.KVTransferError, match="order"):
            mod_b.assemble_payload(header, frames[::-1])


# ------------------------------------------------------- across packages
def test_weight_digests_equal_across_packages(nets):
    jnet, pnet = nets
    jeng = JaxEngine(jnet, n_slots=1, max_len=32, prompt_buckets=(8,))
    peng = _engine(pnet, n_slots=1)
    other = _engine(_pair(seed=7)[1], n_slots=1)
    try:
        assert peng._weight_version == jeng._weight_version
        assert other._weight_version != peng._weight_version
        assert peng.prefix_chains()["weight_version"] \
            == jeng.prefix_chains()["weight_version"]
    finally:
        jeng.shutdown()
        _shutdown(peng, other)


def test_page_checksums_and_block_sums_equal_on_the_same_bits():
    """f32, int8 and bf16 pages hash alike in both packages; a JAX
    payload of bf16 pages converts to the port's uint16 bits and back
    with the same checksums, and verifies in both."""
    rng = np.random.default_rng(3)
    f32 = rng.normal(size=(3, 2, 4, 8)).astype(np.float32)
    i8 = rng.integers(-127, 128, (3, 2, 8, 4)).astype(np.int8)
    bf = f32.astype(ml_dtypes.bfloat16)
    for arr in (f32, i8, f32[:, :, 0]):
        assert pkv.page_checksum(arr[1]) == jkv.page_checksum(arr[1])
        assert pkv._block_sums({"k": arr}) == jkv._block_sums({"k": arr})
    bits = bf.view(np.uint16)
    assert pkv.page_checksum(bits[0], "bfloat16") == jkv.page_checksum(bf[0])
    assert pkv.page_checksum(bits[0]) != jkv.page_checksum(bf[0])
    jp = jkv.build_payload(
        handoff_id="h", kind="warm", weight_version="w", kv_quant=None,
        page_size=8, n_blocks=1, prompt=np.arange(5), n_tokens=4,
        temperature=0.0, seed=0, resumed_at=0, tokens=[1],
        blocks=[{"k": bf, "v": bf[:, :, :, ::-1].copy()}], pages_shipped=3)
    pp = pkv.to_bits_payload(jp)
    assert pp["dtypes"] == {"k": "bfloat16", "v": "bfloat16"}
    assert pp["blocks"][0]["k"].dtype == np.uint16
    assert pkv._block_sums(pp["blocks"][0], pp["dtypes"]) == jp["sums"][0]
    assert pkv.verify_payload(pp) is pp
    assert pkv.verify_payload(jp) is jp  # an ml_dtypes leaf reads as is
    back = pkv.from_bits_payload(pp, ml_dtypes.bfloat16)
    assert "dtypes" not in back
    assert jkv._block_sums(back["blocks"][0]) == jp["sums"][0]
    assert jkv.verify_payload(back) is back
    t = pkv.leaf_to_tensor(pp["blocks"][0]["k"], "bfloat16")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), bf.astype(np.float32))
    leaf, dt = pkv.leaf_from_tensor(t)
    assert dt == "bfloat16" and np.array_equal(leaf, bits)


def _export_warm(eng, prompt, n, exc):
    req = eng.submit(prompt, n, timeout=120.0)
    _await(lambda: len(req.tokens) >= 2, 60.0, "warm decode tokens")
    eng.migrate_slots(wait=10.0)
    with pytest.raises(exc) as ei:
        req.result(timeout=60.0)
    return ei.value, eng.fetch_handoff(ei.value.handoff_id)


@pytest.mark.parametrize("kw", [{}, {"quantize": {"kv": "int8"},
                                     "page_size": 8}], ids=["dense", "int8"])
def test_warm_handoff_crosses_packages_both_ways(nets, kw):
    """A JAX engine's warm handoff resumes on a port engine, and a port
    engine's on a JAX engine (its bf16-free payload needs no
    conversion; `from_bits_payload` is applied as a caller would), with
    the uninterrupted run's greedy tokens; the senders' commits free
    every leased page."""
    from deeplearning4j_tpu.serving import (
        SlotMigratedError as JaxSlotMigratedError,
    )

    jnet, pnet = nets
    gen = dict(n_slots=2, max_len=32, prompt_buckets=(8,), decode_chunk=1)
    prompt = _prompts(1, 5, seed=29)[0]
    ref = _engine(pnet, **kw)
    try:
        want = ref.generate(prompt, 12)
    finally:
        _shutdown(ref)
    jeng = JaxEngine(jnet, step_hooks=[_slow(0.03)], **gen, **kw)
    peng = _engine(pnet, step_hooks=[_slow()], **kw)
    try:
        red, payload = _export_warm(jeng, prompt, 12, JaxSlotMigratedError)
        tail = peng.resume_generate(payload, timeout=120.0)
        np.testing.assert_array_equal(np.concatenate([red.tokens, tail]),
                                      want)
        assert jeng.commit_handoff(red.handoff_id)
        red, payload = _export_warm(peng, prompt, 12, SlotMigratedError)
        tail = jeng.resume_generate(
            pkv.from_bits_payload(payload, ml_dtypes.bfloat16),
            timeout=120.0)
        np.testing.assert_array_equal(np.concatenate([red.tokens, tail]),
                                      want)
        assert peng.commit_handoff(red.handoff_id)
        assert jeng.stats()["pages_in_use"] == 0
        assert peng.stats()["migrations_in"] == 1
    finally:
        jeng.shutdown()
        _shutdown(peng)


def test_a_jax_sampled_handoff_resumes_on_one_stream(nets):
    """A JAX engine's sampled handoff carries a threefry key, no torch
    generator: the port seeds the slot's generator from the key's two
    words, so the same payload always resumes with the same tokens."""
    from deeplearning4j_tpu.serving import (
        SlotMigratedError as JaxSlotMigratedError,
    )

    jnet, pnet = nets
    jeng = JaxEngine(jnet, n_slots=1, max_len=32, prompt_buckets=(8,),
                     decode_chunk=1, step_hooks=[_slow(0.03)])
    try:
        req = jeng.submit(_prompts(1, 5, seed=37)[0], 12, temperature=1.0,
                          seed=4, timeout=120.0)
        _await(lambda: len(req.tokens) >= 2, 60.0, "sampled tokens")
        jeng.migrate_slots(wait=10.0)
        with pytest.raises(JaxSlotMigratedError) as ei:
            req.result(timeout=60.0)
        payload = jeng.fetch_handoff(ei.value.handoff_id)
        assert "sampler" not in payload
        tails = []
        for _ in range(2):
            eng = _engine(pnet, n_slots=1)
            try:
                tails.append(eng.resume_generate(payload, timeout=120.0))
            finally:
                _shutdown(eng)
        np.testing.assert_array_equal(tails[0], tails[1])
        assert len(tails[0]) == 12 - len(ei.value.tokens)
        jeng.commit_handoff(ei.value.handoff_id)
    finally:
        jeng.shutdown()


def test_concurrent_migrations_keep_the_ledger_whole(nets):
    """Many requests, several migrated while others finish: every page
    is freed exactly once across the sender and the receiver."""
    jnet, pnet = nets
    prompts = _prompts(6, 5, seed=41)
    expected = jax_generate(jnet, prompts, 8, temperature=0.0)
    src = _engine(pnet, n_slots=3, step_hooks=[_slow(0.01)])
    dst = _engine(pnet, n_slots=3)
    results = {}
    try:
        reqs = [src.submit(p, 8, timeout=120.0) for p in prompts]
        _await(lambda: sum(len(r.tokens) for r in reqs) >= 4, 60.0,
               "some decoding")
        src.migrate_slots(wait=10.0)

        def finish(i, req):
            try:
                results[i] = req.result(timeout=60.0)
            except SlotMigratedError as e:
                tail = dst.resume_generate(src.fetch_handoff(e.handoff_id),
                                           timeout=120.0)
                results[i] = np.concatenate([e.tokens, tail])
                src.commit_handoff(e.handoff_id)

        threads = [threading.Thread(target=finish, args=(i, r))
                   for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        for i in range(6):
            np.testing.assert_array_equal(results[i], expected[i])
        assert src.stats()["pages_in_use"] == dst.stats()["pages_in_use"] == 0
    finally:
        _shutdown(src, dst)
