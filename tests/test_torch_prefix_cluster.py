"""The port's cluster prefix cache (`serving/prefix_directory.py`, the
prefix cache's publication and the engine's fetch path) held against the
JAX package on the CPU at small size (vocab 48, d_model 32, 2 layers,
pages of 8): chain keys and directory answers equal the JAX package's; a
prompt prefilled on one engine is fetched by another, which prefills only
the uncached suffix and emits the JAX package's greedy tokens (f32); a
refused, corrupted, cut or stale fetch degrades to cold prefill with the
same tokens; tenants stay apart; a cleared cache retracts; and
`DisaggCoordinator(prefix_cluster=True)` serves with delta handoffs and
affinity routing, with the same tokens as without. A JAX engine serves
as the holder of a port engine's fetch.
"""
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
from deeplearning4j_tpu.serving import (  # noqa: E402
    PrefixDirectory as JaxDirectory,
)
from deeplearning4j_tpu.serving import chain_keys as jax_chain_keys  # noqa: E402
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
    PrefixDirectory,
    TenantQuotaExceededError,
    chain_keys,
)
from deeplearning4j_tpu_torch.serving import kv_transfer  # noqa: E402
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


GEN = dict(n_slots=2, max_len=40, prompt_buckets=(8,), page_size=8,
           prefill_chunk=8, prefix_cache=True)


def _engine(net, **kw):
    return DecodeEngine(net, device="cpu", **dict(GEN, **kw))


def _prompt(n=21, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _expected(nets, p, n=6):
    return jax_generate(nets[0], p[None], n, temperature=0.0)[0]


def _close(*engines):
    """Shut down with every page ledger whole."""
    for eng in engines:
        with eng._cond:
            ids = list(eng._free_pages)
            for r in eng._slots:
                if r is not None and r.pages:
                    ids += r.pages[r.n_shared:]
            for lease in eng._leases._leases.values():
                if lease.pages:
                    ids += lease.pages[lease.n_shared:]
            ids += [n.page_id for n in eng._prefix_cache._nodes.values()]
        assert len(ids) == len(set(ids)) == eng.pool_pages
        eng.shutdown()


# -------------------------------------------------------------- chain keys
def test_chain_keys_deterministic_prefix_property_tenant_scoped():
    p = _prompt(24)
    assert chain_keys(p, 8) == chain_keys(np.array(p, np.int64), 8)
    assert len(chain_keys(p, 8)) == 3
    assert chain_keys(p, 8)[:2] == chain_keys(p[:16], 8)
    a, b = chain_keys(p, 8, tenant="alice"), chain_keys(p, 8, tenant="bob")
    assert set(a).isdisjoint(b) and set(a).isdisjoint(chain_keys(p, 8))
    q = p.copy()
    q[0] = (q[0] + 1) % VOCAB
    assert chain_keys(q, 8)[0] != chain_keys(p, 8)[0]


@pytest.mark.parametrize("tenant", [None, "alice"])
def test_chain_keys_equal_the_jax_packages(tenant):
    """The directory's address space is shared: the same (tenant,
    tokens) give the same keys in both packages."""
    p = _prompt(40, seed=5)
    for page in (4, 8, 16):
        assert chain_keys(p, page, tenant=tenant) \
            == jax_chain_keys(p, page, tenant=tenant)


# --------------------------------------------------------------- directory
def test_directory_publish_lookup_ttl_expiry():
    d = PrefixDirectory(ttl=10.0)
    p = _prompt(24)
    keys = chain_keys(p, 8)
    d.publish("wv1", 8, keys[:2], "host-a", now=0.0)
    hit = d.best_holder(p, now=1.0)
    assert hit == {"weight_version": "wv1", "page_size": 8, "depth": 2,
                   "holders": ["host-a"]}
    d.publish("wv1", 8, keys, "host-b", now=1.0)
    assert d.best_holder(p, now=2.0)["depth"] == 2
    assert d.best_holder(p, exclude=("host-a", "host-b"), now=2.0) is None
    assert d.best_holder(p, now=10.5)["holders"] == ["host-b"]
    assert d.sweep(now=12.0) >= 1
    assert d.best_holder(p, now=12.0) is None
    st = d.stats()
    assert st["directory_entries"] == 0 and st["expirations"] >= 1
    with pytest.raises(ValueError):
        PrefixDirectory(ttl=0)
    with pytest.raises(ValueError, match="page_size"):
        d.publish("wv1", 8, keys[:1], "h")
        d.publish("wv1", 16, keys[:1], "h")


def test_directory_matches_the_jax_directory_step_by_step():
    """The same publish, retract, drop and lookup sequence gives the same
    answers and counters in both packages."""
    p = _prompt(24)
    out = []
    for D, ck in ((PrefixDirectory, chain_keys),
                  (JaxDirectory, jax_chain_keys)):
        d, log = D(), []
        d.publish("wv-old", 8, ck(p, 8)[:2], "host-a")
        log.append(d.best_holder(p))
        d.publish("wv-new", 8, ck(p, 8)[:1], "host-b")
        d.publish("wv-new", 8, ck(p, 8, tenant="t")[:2], "host-c")
        log += [d.best_holder(p), d.best_holder(p, "t"),
                d.holders("wv-new", ck(p, 8)[0])]
        log.append(d.drop_holder("host-a"))
        log.append(d.best_holder(p))
        d.retract("wv-new", ck(p, 8)[:1], "host-b")
        log += [d.best_holder(p), d.deepest("wv-new", ck(p, 8, tenant="t"))]
        log.append(d.stats())
        out.append(log)
    assert out[0] == out[1]


def test_tenant_isolation_at_the_directory():
    d = PrefixDirectory()
    p = _prompt(24)
    d.publish("wv", 8, chain_keys(p, 8, tenant="alice")[:2], "host-a")
    assert d.best_holder(p, "alice") is not None
    assert d.best_holder(p, "bob") is None and d.best_holder(p) is None


def test_framed_delta_roundtrip_and_corruption_refusal():
    rng = np.random.default_rng(3)
    blocks = [{"k": rng.standard_normal((4, 8, 2, 4)).astype(np.float32),
               "v": rng.standard_normal((4, 8, 2, 4)).astype(np.float32)}]
    payload = kv_transfer.build_payload(
        handoff_id="h1", kind="prefix", weight_version="wv", kv_quant=None,
        page_size=8, n_blocks=1, prompt=_prompt(32), n_tokens=0,
        temperature=0.0, seed=0, resumed_at=0, tokens=[], blocks=blocks,
        pages_shipped=4)
    header = kv_transfer.payload_header(payload, skip_pages=2, frame_pages=1)
    assert header["pages_shipped"] == 2 and header["pages_omitted"] == 2
    assert header["n_frames"] == 2 and "blocks" not in header
    frames = [kv_transfer.slice_frame(payload, f, skip_pages=2,
                                      frame_pages=1) for f in range(2)]
    out = kv_transfer.verify_payload(
        kv_transfer.assemble_payload(header, frames), weight_version="wv",
        page_size=8, n_blocks=1, max_len=40, kinds=("prefix",))
    np.testing.assert_array_equal(out["blocks"][0]["k"], blocks[0]["k"][2:])
    clamped = kv_transfer.payload_header(payload, skip_pages=99)
    assert clamped["pages_shipped"] == 1 and clamped["pages_omitted"] == 3
    bad = [dict(fr) for fr in frames]
    bad[0]["blocks"] = [{"k": np.array(b["k"]), "v": np.array(b["v"])}
                        for b in frames[0]["blocks"]]
    bad[0]["blocks"][0]["k"][0, 0, 0, 0] += 1.0
    with pytest.raises(KVTransferError):
        kv_transfer.verify_payload(kv_transfer.assemble_payload(header, bad),
                                   kinds=("prefix",))
    with pytest.raises(KVTransferError):
        kv_transfer.assemble_payload(header, frames[:1])
    with pytest.raises(KVTransferError):
        kv_transfer.assemble_payload(header, frames[::-1])
    with pytest.raises(KVTransferError, match="refused"):
        kv_transfer.verify_payload(payload, kinds=("warm", "cold"))


# ----------------------------------------------------------- the fetch path
def _bound_pair(net, directory, peers, fetcher_peers=None, **fetch_kw):
    engA, engB = _engine(net), _engine(net)
    peers["a"], peers["b"] = engA, engB
    engA.bind_prefix_directory(directory, "a", peers.get, frame_pages=1)
    engB.bind_prefix_directory(directory, "b",
                               (fetcher_peers or peers).get, frame_pages=1,
                               **fetch_kw)
    return engA, engB


def test_cross_host_hit_parity_suffix_only_prefill(nets):
    p = _prompt(21)
    exp = _expected(nets, p)
    d = PrefixDirectory()
    engA, engB = _bound_pair(nets[1], d, {})
    try:
        np.testing.assert_array_equal(engA.generate(p, 6), exp)
        assert d.stats()["directory_entries"] == 2
        np.testing.assert_array_equal(engB.generate(p, 6), exp)
        stA, stB = engA.stats(), engB.stats()
        assert stB["prefix_fetches"] == 1
        assert stB["prefix_fetch_fallbacks"] == 0
        assert stB["prefix_fetch_bytes"] > 0 and stB["prefix_fetch_ms"] >= 0
        assert stA["prefix_exports"] == 1
        assert stA["prefill_chunks"] == 3 and stB["prefill_chunks"] == 1
        assert stB["cluster_prefix_hit_tokens"] == 16
        assert stB["cluster_prefix_hit_tokens_pct"] > 0
        assert len(d.best_holder(p)["holders"]) == 2
        kinds = {e["kind"] for e in engB.recorder.dump()["events"]}
        assert {"prefix-fetch", "prefix-publish"} <= kinds
        assert "prefix-export" in {e["kind"]
                                   for e in engA.recorder.dump()["events"]}
    finally:
        _close(engA, engB)


class _RefusingPeer:
    def __init__(self):
        self.calls = 0

    def export_prefix(self, *a, **kw):
        self.calls += 1
        raise ConnectionRefusedError("injected: holder unreachable")


def test_never_slower_fetch_failure_is_cold_prefill(nets):
    p = _prompt(21, seed=7)
    exp = _expected(nets, p)
    refuser = _RefusingPeer()
    engA, engB = _bound_pair(nets[1], PrefixDirectory(), {},
                             fetcher_peers={"a": refuser})
    try:
        np.testing.assert_array_equal(engA.generate(p, 6), exp)
        np.testing.assert_array_equal(engB.generate(p, 6), exp)
        st = engB.stats()
        assert refuser.calls == 1
        assert st["prefix_fetches"] == 0 and st["prefix_fetch_fallbacks"] == 1
        assert st["served"] == 1 and st["failures"] == 0
        assert st["prefill_chunks"] == 3
    finally:
        _close(engA, engB)


class _Saboteur:
    """A holder proxy that spoils its fetch: a flipped byte in the first
    frame, a holder gone after the header, or a header claiming other
    weights. Its sender-side abort still reaches the holder."""

    def __init__(self, engine, mode):
        self.engine, self.mode, self.sabotages = engine, mode, 0

    def export_prefix(self, *a, **kw):
        header = dict(self.engine.export_prefix(*a, **kw))
        if self.mode == "stale-version":
            self.sabotages += 1
            header["weight_version"] = "0" * 16
        return header

    def fetch_handoff_frame(self, handoff_id, frame, **kw):
        if self.mode == "die-after-header":
            self.sabotages += 1
            raise ConnectionResetError("injected: holder died mid-fetch")
        out = self.engine.fetch_handoff_frame(handoff_id, frame, **kw)
        if self.mode == "corrupt-frame" and frame == 0:
            self.sabotages += 1
            blocks = [dict(b) for b in out["blocks"]]
            k = np.array(blocks[0]["k"], copy=True)
            k.reshape(-1).view(np.uint8)[3] ^= 0x10
            blocks[0]["k"] = k
            out = dict(out, blocks=blocks)
        return out

    def commit_handoff(self, handoff_id):
        return self.engine.commit_handoff(handoff_id)

    def abort_handoff(self, handoff_id):
        return self.engine.abort_handoff(handoff_id)


@pytest.mark.parametrize("mode", ["corrupt-frame", "die-after-header",
                                  "stale-version"])
def test_sabotaged_fetch_degrades_typed_with_zero_failed_requests(nets, mode):
    p = _prompt(21, seed=11)
    exp = _expected(nets, p)
    d = PrefixDirectory()
    engA = _engine(nets[1])
    engA.bind_prefix_directory(d, "a", {"a": engA}.get, frame_pages=1)
    saboteur = _Saboteur(engA, mode)
    engB = _engine(nets[1])
    engB.bind_prefix_directory(d, "b", {"a": saboteur}.get, frame_pages=1)
    try:
        np.testing.assert_array_equal(engA.generate(p, 6), exp)
        np.testing.assert_array_equal(engB.generate(p, 6), exp)
        st = engB.stats()
        assert saboteur.sabotages >= 1
        assert st["prefix_fetches"] == 0 and st["prefix_fetch_fallbacks"] == 1
        assert st["served"] == 1 and st["failures"] == 0
        np.testing.assert_array_equal(engB.generate(p, 6), exp)
        # the holder's export lease was aborted, not left to its TTL
        assert engA.stats()["handoffs_aborted"] == 1
    finally:
        _close(engA, engB)


def test_fetch_respects_tenant_scoping_and_quota(nets):
    p = _prompt(21, seed=13)
    exp = _expected(nets, p)
    engA, engB = _bound_pair(nets[1], PrefixDirectory(), {})
    try:
        np.testing.assert_array_equal(engA.generate(p, 6, tenant="alice"),
                                      exp)
        np.testing.assert_array_equal(engB.generate(p, 6, tenant="bob"), exp)
        st = engB.stats()
        assert st["prefix_fetches"] == 0 and st["prefix_fetch_fallbacks"] == 0
        engB.set_tenant_quota("alice", max_pages=1)
        with pytest.raises(TenantQuotaExceededError):
            engB.generate(p, 6, tenant="alice")
        engB.set_tenant_quota("alice", max_pages=None)
        np.testing.assert_array_equal(engB.generate(p, 6, tenant="alice"),
                                      exp)
        assert engB.stats()["prefix_fetches"] >= 1
    finally:
        _close(engA, engB)


def test_clear_retracts_published_chains(nets):
    p = _prompt(21, seed=17)
    d = PrefixDirectory()
    eng = _engine(nets[1])
    eng.bind_prefix_directory(d, "a")
    try:
        eng.generate(p, 6)
        assert d.stats()["directory_entries"] == 2
        assert len(eng.prefix_chains()["chains"]) == 2
        assert eng.prefix_depth(p) == 2
        with eng._cond:
            eng._prefix_cache.clear()
        assert d.stats()["directory_entries"] == 0
        assert d.best_holder(p) is None
    finally:
        eng.shutdown()


def test_late_bind_announces_warm_chains(nets):
    """An engine bound after it warmed publishes what it holds."""
    p = _prompt(21, seed=19)
    eng = _engine(nets[1])
    try:
        eng.generate(p, 6)
        d = PrefixDirectory()
        eng.bind_prefix_directory(d, "late")
        assert d.best_holder(p)["holders"] == ["late"]
    finally:
        _close(eng)


def test_a_jax_engine_holds_what_a_port_engine_fetches(nets):
    """The fetch path across packages: a JAX engine prefills and
    publishes into the port's directory; a port engine on the same
    weights (the same digest) fetches the chain from it, frames and
    checksums and all, and prefills only the suffix."""
    jnet, pnet = nets
    p = _prompt(21, seed=23)
    exp = _expected(nets, p)
    d = PrefixDirectory()
    jeng = JaxEngine(jnet, **GEN)
    jeng.bind_prefix_directory(d, "jax")
    peng = _engine(pnet)
    peng.bind_prefix_directory(d, "port", {"jax": jeng}.get, frame_pages=1)
    try:
        np.testing.assert_array_equal(jeng.generate(p, 6), exp)
        np.testing.assert_array_equal(peng.generate(p, 6), exp)
        st = peng.stats()
        assert st["prefix_fetches"] == 1 and st["prefix_fetch_fallbacks"] == 0
        assert st["prefill_chunks"] == 1
        assert jeng.stats()["prefix_exports"] == 1
    finally:
        jeng.shutdown()
        _close(peng)


# ----------------------------------------------- disagg delta and affinity
def test_disagg_prefix_cluster_delta_and_affinity(nets):
    gen = {"n_slots": 2, "max_len": 40, "prompt_buckets": (8, 16, 24),
           "page_size": 8, "prefill_chunk": 8, "prefix_cache": True}
    rng = np.random.default_rng(0)
    shared = rng.integers(0, VOCAB, 17).astype(np.int32)
    prompts = [np.concatenate(
        [shared, rng.integers(0, VOCAB, 3).astype(np.int32)])
        for _ in range(3)]
    expected = jax_generate(nets[0], np.stack(prompts), 6, temperature=0.0)
    co = DisaggCoordinator(nets[1], prefill_replicas=2,
                           server_kwargs={"generation": gen},
                           prefix_cluster=True, frame_pages=1)
    try:
        for i, p in enumerate(prompts):
            np.testing.assert_array_equal(co.generate(p, 6, timeout=120.0),
                                          expected[i])
        st = co.stats()
        assert st["prefix_cluster"] is True
        assert st["handoffs"] == 3 and st["fallbacks"] == 0
        assert st["affinity_routes"] >= 1
        assert st["delta_pages_skipped"] >= 1
        assert st["directory_entries"] >= 1
    finally:
        co.shutdown()


def test_disagg_prefix_cluster_off_is_unchanged(nets):
    gen = {"n_slots": 2, "max_len": 32, "prompt_buckets": (8,)}
    p = _prompt(5, seed=2)
    co = DisaggCoordinator(nets[1], server_kwargs={"generation": gen})
    try:
        np.testing.assert_array_equal(co.generate(p, 6, timeout=120.0),
                                      _expected(nets, p))
        st = co.stats()
        assert st["prefix_cluster"] is False
        assert st["affinity_routes"] == st["delta_pages_skipped"] == 0
        assert co.prefix_directory is None
    finally:
        co.shutdown()
