"""The port's quantized serving tier (`serving/quantize.py`, the int8
branch of `ops/paged_attention.py`, `DecodeEngine(quantize={"kv":
"int8"})`) held against the JAX package on the CPU at small size.

Inputs are made with numpy from a seed and fed to both packages. The
quantizer must give the same int8 values and the same scales (rtol
1e-6). The port's plain int8 paged attention is pinned against the JAX
Pallas kernel in interpret mode and against the JAX oracle
(`paged_gather_quant` + `cached_attention_chunk`) at f32, atol = rtol =
2e-5 (the JAX package's own bound for that comparison). The int8 engine
is pinned against the JAX int8 engine with the same weights: pool
payloads within one int8 step on at most 0.1% of the written elements
(the two frameworks' f32 block math differs in the last bits, which can
move a borderline element across a rounding boundary), scales to rtol
1e-5, greedy tokens identical, argmax drift against f32 `generate` at
most 0.2.

The CUDA kernel runs only on the card: the `gpu`-marked test at the end
repeats the card check and skips without one.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    generate as jax_generate,
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.ops import attention as jatt  # noqa: E402
from deeplearning4j_tpu.ops.pallas_paged_attention import (  # noqa: E402
    paged_attention as jax_paged_attention,
)
from deeplearning4j_tpu.serving import DecodeEngine as JaxEngine  # noqa: E402
from deeplearning4j_tpu.serving import quantize as jqz  # noqa: E402
from deeplearning4j_tpu_torch.models.transformer import GPTPlan  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import paged_attention as pa  # noqa: E402
from deeplearning4j_tpu_torch.ops.attention import (  # noqa: E402
    paged_attention_chunk_auto,
    paged_attention_step_auto,
    paged_gather_quant,
)
from deeplearning4j_tpu_torch.serving import DecodeEngine  # noqa: E402
from deeplearning4j_tpu_torch.serving import quantize as qz  # noqa: E402
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
TOL = 2e-5


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


# ------------------------------------------------------ quantizer numerics


@pytest.mark.parametrize("shape,axis", [((3, 4, 16), -1), ((1, 2, 16, 8), 2),
                                        ((1, 2, 8, 16), 3)])
def test_quantize_heads_matches_jax(shape, axis):
    """The decode step's last-axis write and the prefill span's axis-2 /
    axis-3 layouts: same int8 values, same scales, and the same
    dequantized values as the JAX functions; one hot head included."""
    rng = np.random.default_rng(sum(shape) + axis)
    x = rng.normal(size=shape).astype(np.float32)
    x[:, 1] *= 100.0
    q, s = qz.quantize_heads(torch.from_numpy(x), axis=axis)
    jq, js = jqz.quantize_heads(jnp.asarray(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    deq = qz.dequantize_heads(q, s, axis=axis)
    np.testing.assert_allclose(
        deq.numpy(), np.asarray(jqz.dequantize_heads(jq, js, axis=axis)),
        rtol=1e-6)
    bound = np.expand_dims(s.numpy(), axis) / 2.0 + 1e-6
    assert np.all(np.abs(deq.numpy() - x) <= bound)
    assert qz.dequantize_heads(q, s, axis=axis,
                               dtype=torch.bfloat16).dtype == torch.bfloat16


def test_quantize_heads_zero_span_is_exact_zero():
    """An all-zero span quantizes with scale 1.0 and dequantizes to
    exactly 0.0: the trash page reads back as true zeros."""
    q, scale = qz.quantize_heads(torch.zeros((2, 3, 8)))
    assert (scale == 1.0).all() and (q == 0).all()
    assert (qz.dequantize_heads(q, scale) == 0.0).all()


def test_write_scale_pages_matches_jax_and_refuses_overrun():
    """Whole pages plus a partial tail land where the JAX scatter puts
    them; a tail that would run past its page raises."""
    rng = np.random.default_rng(5)
    sp = rng.uniform(0.5, 1.5, (5, 2, 4)).astype(np.float32)
    scol = rng.uniform(0.01, 0.02, (1, 2, 10)).astype(np.float32)
    got = torch.from_numpy(sp.copy())
    qz._write_scale_pages(got, torch.from_numpy(scol), [3, 1, 4], 0, 4)
    ref = jqz._write_scale_pages(jnp.asarray(sp), jnp.asarray(scol),
                                 jnp.asarray([3, 1, 4], jnp.int32),
                                 jnp.zeros((), jnp.int32), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    sub = torch.from_numpy(sp.copy())
    qz._write_scale_pages(sub, torch.from_numpy(scol[..., :2]), [2], 2, 4)
    ref = jqz._write_scale_pages(jnp.asarray(sp), jnp.asarray(scol[..., :2]),
                                 jnp.asarray([2], jnp.int32),
                                 jnp.asarray(2, jnp.int32), 4)
    np.testing.assert_array_equal(sub.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="past"):
        qz._write_scale_pages(sub, torch.from_numpy(scol[..., :3]), [2], 2, 4)


def test_kv_bytes_per_token_matches_jax(nets):
    _, pnet = nets
    geom = GPTPlan(pnet).kv_geometry()
    assert geom == [(2, 16), (2, 16)]
    for quant, itemsize in (("int8", 4), (None, 4), (None, 2)):
        assert qz.kv_bytes_per_token(geom, quant, itemsize) \
            == jqz.kv_bytes_per_token(geom, quant, itemsize)
    assert qz.kv_bytes_per_token(geom, "int8", 4) == 160


# ------------------------------------------------- int8 paged attention


def _quant_pools(rng, P, Hkv, hd, page):
    k_pool = rng.integers(-127, 128, (P + 1, Hkv, hd, page)).astype(np.int8)
    v_pool = rng.integers(-127, 128, (P + 1, Hkv, page, hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (P + 1, Hkv, page)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (P + 1, Hkv, page)).astype(np.float32)
    return k_pool, v_pool, ks, vs


def _port(q, k_pool, v_pool, ks, vs, pt, p0, active=None):
    return pa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(pt),
        torch.from_numpy(np.asarray(p0, np.int32)),
        active=None if active is None else torch.from_numpy(active),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)).numpy()


def _jax_kernel(q, k_pool, v_pool, ks, vs, pt, p0, active=None):
    return np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(pt), jnp.asarray(np.asarray(p0, np.int32)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        active=None if active is None else jnp.asarray(active),
        interpret=True))


def _jax_oracle(q, k_pool, v_pool, ks, vs, pt, p0):
    kd, vd = jatt.paged_gather_quant(
        jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(pt), jnp.float32)
    C = q.shape[1]
    qpos = jnp.asarray(p0)[:, None] + jnp.arange(C)[None, :]
    out = jax.vmap(jatt.cached_attention_chunk)(jnp.asarray(q), kd, vd, qpos)
    return np.asarray(out).reshape(q.shape)


@pytest.mark.parametrize("H,Hkv,C", [(2, 2, 1), (4, 2, 1), (4, 1, 3),
                                     (4, 2, 4)])
def test_int8_plain_matches_jax_kernel_and_oracle_fuzz(H, Hkv, C):
    """Scrambled page tables, a page shared by two slots, holes to the
    trash page, GQA groupings, decode and chunk widths: the port's plain
    int8 version equals the JAX int8 kernel (interpret mode) and the JAX
    oracle on every row."""
    rng = np.random.default_rng(300 + 100 * H + 10 * Hkv + C)
    S, hd, page, n_pages = 3, 8, 4, 4
    P = S * n_pages
    for _ in range(3):
        k_pool, v_pool, ks, vs = _quant_pools(rng, P, Hkv, hd, page)
        pt = rng.permutation(np.arange(1, P + 1)).reshape(S, n_pages) \
            .astype(np.int32)
        pt[1, 0] = pt[0, 0]
        pt[2, 2:] = 0
        p0 = np.array([int(rng.integers(0, n_pages * page - C)),
                       int(rng.integers(0, n_pages * page - C)),
                       int(rng.integers(0, 2 * page - C))], np.int32)
        q = rng.standard_normal((S, C, H, hd)).astype(np.float32)
        got = _port(q, k_pool, v_pool, ks, vs, pt, p0)
        np.testing.assert_allclose(
            got, _jax_kernel(q, k_pool, v_pool, ks, vs, pt, p0),
            rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            got, _jax_oracle(q, k_pool, v_pool, ks, vs, pt, p0),
            rtol=TOL, atol=TOL)


def test_int8_trash_stale_pages_and_inactive_lane():
    """Poisoned int8 pages and poisoned scale pages past each slot's
    position, and on the trash page, never move the output; an inactive
    lane gives zeros, as in the JAX kernel."""
    rng = np.random.default_rng(23)
    S, H, Hkv, hd, page, n_pages = 2, 2, 2, 4, 4, 4
    P = S * n_pages
    k_pool, v_pool, ks, vs = _quant_pools(rng, P, Hkv, hd, page)
    pt = (1 + np.arange(P)).reshape(S, n_pages).astype(np.int32)
    pos = np.array([2, 5], np.int32)
    q = rng.standard_normal((S, 1, H, hd)).astype(np.float32)
    base = _port(q, k_pool, v_pool, ks, vs, pt, pos)
    k2, v2, ks2, vs2 = k_pool.copy(), v_pool.copy(), ks.copy(), vs.copy()
    for pid in (0, 2, 3, 4, 7, 8):  # trash page + pages past the positions
        k2[pid], v2[pid] = 127, -127
        ks2[pid], vs2[pid] = 1e6, 1e6
    pt2 = pt.copy()
    pt2[0, 2:] = 0
    np.testing.assert_array_equal(_port(q, k2, v2, ks2, vs2, pt2, pos), base)
    active = np.array([True, False])
    got = _port(q, k_pool, v_pool, ks, vs, pt, pos, active)
    np.testing.assert_allclose(
        got, _jax_kernel(q, k_pool, v_pool, ks, vs, pt, pos, active),
        rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_array_equal(got[0], base[0])


def test_gather_quant_and_auto_entries_match_jax():
    """`paged_gather_quant` equals the JAX oracle's dense view, in f32
    and rounded to bf16; the `*_auto` entries with scales equal the JAX
    CPU path."""
    rng = np.random.default_rng(29)
    S, H, Hkv, hd, page, n_pages = 2, 4, 2, 8, 4, 2
    P = S * n_pages
    k_pool, v_pool, ks, vs = _quant_pools(rng, P, Hkv, hd, page)
    pt = rng.permutation(np.arange(1, P + 1)).reshape(S, n_pages) \
        .astype(np.int32)
    t = [torch.from_numpy(a) for a in (k_pool, v_pool, ks, vs, pt)]
    j = [jnp.asarray(a) for a in (k_pool, v_pool, ks, vs, pt)]
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        kd, vd = paged_gather_quant(*t, tdt)
        jkd, jvd = jatt.paged_gather_quant(*j, jdt)
        assert kd.dtype == tdt
        np.testing.assert_allclose(kd.float().numpy(),
                                   np.asarray(jkd, np.float32), rtol=1e-6)
        np.testing.assert_allclose(vd.float().numpy(),
                                   np.asarray(jvd, np.float32), rtol=1e-6)
    q = rng.standard_normal((S, 3, H, hd)).astype(np.float32)
    pos = np.array([2, 4], np.int32)
    got = paged_attention_chunk_auto(
        torch.from_numpy(q), t[0], t[1], t[4], torch.from_numpy(pos),
        k_scale=t[2], v_scale=t[3]).numpy()
    ref = np.asarray(jatt.paged_attention_chunk_auto(
        jnp.asarray(q), j[0], j[1], j[4], jnp.asarray(pos), k_scale=j[2],
        v_scale=j[3]))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    got = paged_attention_step_auto(
        torch.from_numpy(q[:, 0]), t[0], t[1], t[4], torch.from_numpy(pos),
        k_scale=t[2], v_scale=t[3]).numpy()
    ref = np.asarray(jatt.paged_attention_step_auto(
        jnp.asarray(q[:, 0]), j[0], j[1], j[4], jnp.asarray(pos),
        k_scale=j[2], v_scale=j[3]))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_int8_wrapper_checks_and_counts():
    """int8 pools need both scale pools, f32, of shape (P+1, Hkv, page);
    dense pools take none; a CPU call runs the plain version and launches
    no kernel."""
    rng = np.random.default_rng(31)
    S, H, Hkv, hd, page, n_pages = 2, 2, 2, 8, 4, 2
    k_pool, v_pool, ks, vs = _quant_pools(rng, S * n_pages, Hkv, hd, page)
    pt = (1 + np.arange(S * n_pages)).reshape(S, n_pages).astype(np.int32)
    q = rng.standard_normal((S, 1, H, hd)).astype(np.float32)
    pos = np.array([1, 6], np.int32)
    launches, calls = pa.paged_attention.launches, \
        pa.paged_attention_plain.calls
    _port(q, k_pool, v_pool, ks, vs, pt, pos)
    assert pa.paged_attention_plain.calls == calls + 1
    assert pa.paged_attention.launches == launches
    args = [torch.from_numpy(a) for a in (q, k_pool, v_pool, pt, pos)]
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        pa.paged_attention(*args, k_scale=torch.from_numpy(ks))
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        pa.paged_attention(args[0], args[1].float(), args[2].float(),
                           args[3], args[4], k_scale=torch.from_numpy(ks),
                           v_scale=torch.from_numpy(vs))
    with pytest.raises(ValueError, match=r"\(P\+1, Hkv, page\)"):
        pa.paged_attention(*args, k_scale=torch.from_numpy(ks[:, :, :2]),
                           v_scale=torch.from_numpy(vs))
    with pytest.raises(TypeError, match="float32"):
        pa.paged_attention(*args, k_scale=torch.from_numpy(ks).double(),
                           v_scale=torch.from_numpy(vs))


# ------------------------------------------------------ weight quantizer


def test_quantize_weight_int8_matches_jax():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(3, 16, 24)).astype(np.float32)
    w[:, :, 5] *= 50.0
    w[:, :, 7] = 0.0
    got = qz.quantize_weight_int8(torch.from_numpy(w))
    ref = jqz.quantize_weight_int8(jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=1e-6)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantize_net_weights_touches_only_matmul_weights(nets, mode):
    """Only the block projections (`BLOCK_MATMUL_KEYS`) and the head's
    `W` change, to the JAX package's values; embeddings, positional
    table, biases and LayerNorm parameters stay bitwise alone; the clone
    runs and the original is untouched."""
    jnet, pnet = nets
    assert qz.BLOCK_MATMUL_KEYS == jqz.BLOCK_MATMUL_KEYS
    before = [{k: v.clone() for k, v in p.items()} for p in pnet._params]
    clone = qz.quantize_net_weights(pnet, mode)
    jclone = jqz.quantize_net_weights(jnet, mode)
    want = params_from_jax(pnet.conf, [
        {k: np.asarray(v, np.float32) for k, v in p.items()}
        for p in jclone._params])
    plan = GPTPlan(pnet)
    touched = 0
    for i, (orig, new) in enumerate(zip(pnet._params, clone._params)):
        for key, w in orig.items():
            is_target = ((i in plan.block_is and key in qz.BLOCK_MATMUL_KEYS)
                         or (i == plan.out_i and key == "W")) and w.ndim >= 2
            if is_target:
                touched += 1
                assert not torch.equal(new[key], w), (mode, i, key)
                np.testing.assert_allclose(
                    new[key].float().numpy(),
                    np.asarray(want[i][key], np.float32), atol=1e-6)
            else:
                assert torch.equal(new[key], w), (mode, i, key)
            assert torch.equal(w, before[i][key])
    assert touched == 2 * 4 + 1
    ids = _prompts(2, 8, seed=5)
    out = clone.output(ids)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jclone.output(ids)),
                               atol=2e-5)
    with pytest.raises(ValueError, match="unknown weight quantization"):
        qz.quantize_net_weights(pnet, "int4")


def test_drift_report_matches_jax():
    rng = np.random.default_rng(3)
    out = rng.normal(size=(2, 6, VOCAB)).astype(np.float32)
    cand = out + 0.5 * rng.normal(size=out.shape).astype(np.float32)
    ids = _prompts(2, 6, seed=3)
    assert qz.drift_report(out, out.copy(), ids) \
        == jqz.drift_report(out, out.copy(), ids)
    got, ref = qz.drift_report(out, cand, ids), \
        jqz.drift_report(out, cand, ids)
    assert got.keys() == ref.keys()
    for k in got:
        assert abs(got[k] - ref[k]) <= 1e-6
    assert got["argmax_drift"] > 0 and got["ppl_delta"] != 0
    assert qz.argmax_drift_rate(out, -out) > 0.5
    assert abs(qz.perplexity(out, ids) - jqz.perplexity(out, ids)) <= 1e-6


# ------------------------------------------------- int8 KV decode engine


def _jax_pools(jeng):
    """A JAX engine's int8 pools as numpy 4-tuples, one per block."""
    return [tuple(np.asarray(a) for a in cache) for cache in jeng._caches]


def test_int8_engine_matches_jax_int8_engine(nets):
    """The same prompts, one at a time (so both engines hand out the same
    pages), through both int8 engines: pool payloads within one step on
    at most 0.1% of the written elements, scales to rtol 1e-5, greedy
    tokens identical; drift against f32 generate at most 0.2; the stats
    carry the quantization facts."""
    jnet, pnet = nets
    prompts = _prompts(4, 5)
    expected = jax_generate(jnet, prompts, 6, temperature=0.0)
    kw = dict(n_slots=2, max_len=32, prompt_buckets=(8,),
              quantize={"kv": "int8"})
    jeng = JaxEngine(jnet, **kw)
    eng = DecodeEngine(pnet, device="cpu", **kw)
    try:
        jouts = [jeng.submit(p, 6).result(timeout=120.0) for p in prompts]
        outs = [eng.submit(p, 6).result(timeout=120.0) for p in prompts]
        for o, j in zip(outs, jouts):
            np.testing.assert_array_equal(o, j)
        drift = np.mean([np.mean(o != e) for o, e in zip(outs, expected)])
        assert drift <= 0.2, f"int8 KV argmax drift {drift} vs f32"
        st = eng.stats()
        assert st["kv_quant_bits"] == 8
        assert st["kv_bytes_per_token"] == jeng.stats()["kv_bytes_per_token"]
        written = off_by_one = 0
        for cache, jcache in zip(eng._caches, _jax_pools(jeng)):
            kp, vp, ks, vs = cache
            assert kp.dtype == vp.dtype == torch.int8
            assert ks.dtype == vs.dtype == torch.float32
            for mine, theirs in ((kp, jcache[0]), (vp, jcache[1])):
                d = np.abs(mine[1:].numpy().astype(np.int32)
                           - theirs[1:].astype(np.int32))
                assert d.max() <= 1
                off_by_one += int((d == 1).sum())
                written += int((theirs[1:] != 0).sum())
            for mine, theirs in ((ks, jcache[2]), (vs, jcache[3])):
                np.testing.assert_allclose(mine[1:].numpy(), theirs[1:],
                                           rtol=1e-5)
        assert written > 0 and off_by_one <= 1e-3 * written
    finally:
        jeng.shutdown()
        eng.shutdown()


def test_engine_rejects_unknown_quantize_keys(nets):
    _, pnet = nets
    for bad in ({"kv": "int4"}, {"weights": "int8"}):
        with pytest.raises(ValueError):
            DecodeEngine(pnet, n_slots=2, max_len=32, prompt_buckets=(8,),
                         quantize=bad, device="cpu")


def test_dense_engine_reports_full_precision_stats(nets):
    _, pnet = nets
    eng = DecodeEngine(pnet, n_slots=2, max_len=32, prompt_buckets=(8,),
                       device="cpu")
    try:
        st = eng.stats()
        assert st["kv_quant_bits"] == 32 and st["kv_bytes_per_token"] == 512
        assert len(eng._caches[0]) == 2
    finally:
        eng.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_paged_attention_kernel_matches_plain(dtype):
    """On the card: the int8 kernel against the plain version in f32 that
    rounds the dequantized K/V to q's type, decode, verify (a ragged row
    tile) and chunk widths, MHA and GQA, an inactive lane; tolerance
    atol = rtol = 2e-4 (f32) / 4e-3 (bf16, the output's rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = pa.TOLERANCE[dt]
    rng = np.random.default_rng(37)
    hd, page, n_pages = 128, 128, 6
    for H, Hkv, C in [(8, 8, 1), (8, 2, 1), (8, 8, 5), (8, 2, 3), (8, 8, 64)]:
        S = 4 if C < 64 else 1
        k_pool, v_pool, ks, vs = _quant_pools(rng, S * n_pages, Hkv, hd, page)
        pt = rng.permutation(np.arange(1, S * n_pages + 1)) \
            .reshape(S, n_pages).astype(np.int32)
        pos = rng.integers(0, n_pages * page - C, S).astype(np.int32)
        active = np.ones(S, bool)
        active[0] = S == 1
        q = torch.from_numpy(rng.standard_normal((S, C, H, hd))
                             .astype(np.float32)).cuda().to(dt)
        kp, vp, kst, vst, ptt, post, act = (
            torch.from_numpy(a).cuda()
            for a in (k_pool, v_pool, ks, vs, pt, pos, active))
        launches = pa.paged_attention.launches
        got = pa.paged_attention(q, kp, vp, ptt, post, active=act,
                                 k_scale=kst, v_scale=vst)
        ref = pa.paged_attention_plain(q.float(), kp, vp, ptt, post, act,
                                       kst, vst, kv_dtype=dt)
        torch.cuda.synchronize()
        assert pa.paged_attention.launches == launches + 1
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol)
        if S > 1:
            assert (got[0] == 0).all()
