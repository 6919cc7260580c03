"""The port's paged attention (`deeplearning4j_tpu_torch/ops/paged_attention.py`)
held against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is
pinned here against the JAX package's Pallas kernel in interpret mode
(`paged_attention(..., interpret=True)`) and against the JAX CPU path of
`paged_attention_step_auto` / `paged_attention_chunk_auto` (gather +
dense attention), over fuzzed page tables, GQA groupings and chunk
widths, the trash page, stale pages and inactive lanes. Inputs are made
with numpy from a seed and fed to both as float32 / int32.

Tolerance: f32 atol = rtol = 1e-5 (the two frameworks sum in different
orders; the JAX package's own GQA paths differ by up to 3.6e-7).

The CUDA kernel itself runs only on the card: the `gpu`-marked tests at
the end hold it against its plain version there and skip without a card
(`python -m pytest -m gpu tests/test_torch_*.py` on the card).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops import attention as jatt  # noqa: E402
from deeplearning4j_tpu.ops.pallas_paged_attention import (  # noqa: E402
    paged_attention as jax_paged_attention,
)
from deeplearning4j_tpu_torch.ops import paged_attention as pa  # noqa: E402
from deeplearning4j_tpu_torch.ops.lstm import _tf32  # noqa: E402
from deeplearning4j_tpu_torch.ops.attention import (  # noqa: E402
    cached_attention_chunk,
    cached_attention_step,
    paged_attention_chunk_auto,
    paged_attention_step_auto,
    paged_gather,
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


TOL = 1e-5


def _inputs(rng, S, C, H, Hkv, hd, page, n_pages):
    P = S * n_pages
    k_pool = rng.standard_normal((P + 1, Hkv, hd, page)).astype(np.float32)
    v_pool = rng.standard_normal((P + 1, Hkv, page, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P + 1)).reshape(S, n_pages) \
        .astype(np.int32)
    q = rng.standard_normal((S, C, H, hd)).astype(np.float32)
    return q, k_pool, v_pool, pt


def _port(q, k_pool, v_pool, pt, p0, active=None):
    out = pa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(pt),
        torch.from_numpy(np.asarray(p0, np.int32)),
        active=None if active is None else torch.from_numpy(active))
    return out.numpy()


def _jax_kernel(q, k_pool, v_pool, pt, p0, active=None):
    return np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(pt), jnp.asarray(np.asarray(p0, np.int32)),
        active=None if active is None else jnp.asarray(active),
        interpret=True))


@pytest.mark.parametrize("H,Hkv,C", [(2, 2, 1), (4, 2, 1), (4, 1, 3),
                                     (4, 2, 4)])
def test_plain_matches_jax_kernel_fuzz(H, Hkv, C):
    """Scrambled page tables with holes (trash page) and cross-slot page
    sharing, positions straddling page boundaries: the port's plain
    version equals the JAX kernel (interpret mode) on every row."""
    rng = np.random.default_rng(100 * H + 10 * Hkv + C)
    S, hd, page, n_pages = 3, 8, 4, 4
    for _ in range(2):
        q, k_pool, v_pool, pt = _inputs(rng, S, C, H, Hkv, hd, page, n_pages)
        pt[1, 0] = pt[0, 0]
        pt[2, 2:] = 0
        p0 = np.array([int(rng.integers(0, n_pages * page - C)),
                       int(rng.integers(0, n_pages * page - C)),
                       int(rng.integers(0, 2 * page - C))], np.int32)
        np.testing.assert_allclose(_port(q, k_pool, v_pool, pt, p0),
                                   _jax_kernel(q, k_pool, v_pool, pt, p0),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("H,Hkv", [(2, 2), (4, 1)])
def test_step_auto_matches_jax_cpu_path(H, Hkv):
    """The decode entry point (C=1) against the JAX package's CPU path
    (gather + `cached_attention_step`), on the active rows; inactive
    lanes are zeros in the port."""
    rng = np.random.default_rng(3 + H)
    S, hd, page, n_pages = 4, 8, 4, 3
    q, k_pool, v_pool, pt = _inputs(rng, S, 1, H, Hkv, hd, page, n_pages)
    pos = np.array([0, 5, 11, 7], np.int32)
    active = np.array([True, True, False, True])
    ref = np.asarray(jatt.paged_attention_step_auto(
        jnp.asarray(q[:, 0]), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(active)))
    got = paged_attention_step_auto(
        torch.from_numpy(q[:, 0]), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(pt),
        torch.from_numpy(pos), torch.from_numpy(active)).numpy()
    np.testing.assert_allclose(got[active], ref[active], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[~active], 0.0)


@pytest.mark.parametrize("C", [2, 4, 8])
def test_chunk_auto_matches_jax_cpu_path(C):
    """The chunked-prefill entry point (S=1, chunk width C, padded tail
    past the prompt included) against the JAX CPU path (gather +
    `cached_attention_chunk`) and the JAX kernel."""
    rng = np.random.default_rng(20 + C)
    H, Hkv, hd, page, n_pages = 4, 2, 8, 4, 6
    q, k_pool, v_pool, pt = _inputs(rng, 1, C, H, Hkv, hd, page, n_pages)
    p0 = np.array([2 * C], np.int32)
    ref = np.asarray(jatt.paged_attention_chunk_auto(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(pt), jnp.asarray(p0)))
    got = paged_attention_chunk_auto(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(pt),
        torch.from_numpy(p0)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.reshape(q.shape),
                               _jax_kernel(q, k_pool, v_pool, pt, p0),
                               rtol=TOL, atol=TOL)


def test_trash_and_stale_pages_never_reach_output():
    """Garbage on the trash page and on pages past each slot's position
    (stale pages of a previous owner, table entries remapped to 0) must
    not move the output."""
    rng = np.random.default_rng(11)
    S, H, Hkv, hd, page, n_pages = 2, 2, 2, 4, 4, 4
    q, k_pool, v_pool, pt = _inputs(rng, S, 1, H, Hkv, hd, page, n_pages)
    pt = (1 + np.arange(S * n_pages)).reshape(S, n_pages).astype(np.int32)
    pos = np.array([2, 5], np.int32)
    base = _port(q, k_pool, v_pool, pt, pos)
    k2, v2 = k_pool.copy(), v_pool.copy()
    for pid in (0, 2, 3, 4, 7, 8):
        k2[pid] = 1e6
        v2[pid] = -1e6
    pt2 = pt.copy()
    pt2[0, 2:] = 0
    np.testing.assert_array_equal(_port(q, k2, v2, pt2, pos), base)
    np.testing.assert_allclose(base, _jax_kernel(q, k_pool, v_pool, pt, pos),
                               rtol=TOL, atol=TOL)


def test_inactive_lanes_give_zeros_like_jax_kernel():
    """`active=False` lanes are exact zeros, active lanes untouched; the
    all-inactive batch is all zeros. Same as the JAX kernel."""
    rng = np.random.default_rng(13)
    q, k_pool, v_pool, pt = _inputs(rng, 3, 1, 4, 2, 8, 4, 2)
    pos = np.array([3, 4, 7], np.int32)
    active = np.array([True, False, True])
    got = _port(q, k_pool, v_pool, pt, pos, active)
    np.testing.assert_allclose(got, _jax_kernel(q, k_pool, v_pool, pt, pos,
                                                active), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[1], 0.0)
    idle = _port(q, k_pool, v_pool, pt, pos, np.zeros(3, bool))
    np.testing.assert_array_equal(idle, 0.0)


def test_dense_primitives_match_jax():
    """`paged_gather`, `cached_attention_step` and `cached_attention_chunk`
    (the plain version's parts) against their JAX counterparts."""
    rng = np.random.default_rng(17)
    S, H, Hkv, hd, page, n_pages = 2, 4, 2, 8, 4, 3
    q, k_pool, v_pool, pt = _inputs(rng, S, 3, H, Hkv, hd, page, n_pages)
    kd, vd = paged_gather(torch.from_numpy(k_pool), torch.from_numpy(v_pool),
                          torch.from_numpy(pt))
    jkd, jvd = jatt.paged_gather(jnp.asarray(k_pool), jnp.asarray(v_pool),
                                 jnp.asarray(pt))
    np.testing.assert_array_equal(kd.numpy(), np.asarray(jkd))
    np.testing.assert_array_equal(vd.numpy(), np.asarray(jvd))
    pos = np.array([4, 9], np.int32)
    np.testing.assert_allclose(
        cached_attention_step(torch.from_numpy(q[:, 0]), kd, vd,
                              torch.from_numpy(pos)).numpy(),
        np.asarray(jatt.cached_attention_step(jnp.asarray(q[:, 0]), jkd, jvd,
                                              jnp.asarray(pos))),
        rtol=TOL, atol=TOL)
    qpos = np.array([5, 6, 7], np.int32)
    np.testing.assert_allclose(
        cached_attention_chunk(torch.from_numpy(q[1]), kd[1], vd[1],
                               torch.from_numpy(qpos)).numpy(),
        np.asarray(jatt.cached_attention_chunk(jnp.asarray(q[1]), jkd[1],
                                               jvd[1], jnp.asarray(qpos))),
        rtol=TOL, atol=TOL)


def test_cpu_tensors_run_plain_and_count():
    """A CPU call runs the plain version (its count rises) and launches
    no kernel; malformed inputs raise instead of running."""
    rng = np.random.default_rng(19)
    q, k_pool, v_pool, pt = _inputs(rng, 2, 1, 2, 2, 8, 4, 2)
    launches = pa.paged_attention.launches
    calls = pa.paged_attention_plain.calls
    _port(q, k_pool, v_pool, pt, np.array([1, 6], np.int32))
    assert pa.paged_attention_plain.calls == calls + 1
    assert pa.paged_attention.launches == launches
    with pytest.raises(ValueError, match="positions"):
        _port(q, k_pool, v_pool, pt, np.array([1, 2, 3], np.int32))
    with pytest.raises(ValueError, match="multiple"):
        _port(np.zeros((2, 1, 3, 8), np.float32), k_pool, v_pool, pt,
              np.array([1, 6], np.int32))


def _split_walk(q, k_pool, v_pool, pt, p0, active, ks, splits, tile):
    """A plain emulation of the kernels' walk (`csrc/paged_attention.cu`)
    in f64: per (slot, KV head, tile of `tile` (c, g) rows), the keys in
    slices of `ks` that never cross a page, split into `splits`
    contiguous ranges of slices; each range runs the online softmax on its
    own and leaves (m, l, acc); the merge rescales them to the largest m
    of the ranges that saw a key (l > 0). Inactive slots give 0."""
    S, C, H, hd = q.shape
    Hkv, page = k_pool.shape[1], k_pool.shape[3]
    n_pages, G = pt.shape[1], H // Hkv
    total = n_pages * page // ks
    per = -(-total // splits)
    out = np.zeros((S, C, H, hd))
    for s in range(S):
        if active is not None and not active[s]:
            continue
        for h in range(Hkv):
            for r0 in range(0, C * G, tile):
                rows = np.arange(r0, min(C * G, r0 + tile))
                qr = q[s, rows // G, h * G + rows % G].astype(np.float64)
                limit = p0[s] + rows // G
                live = min(total, (p0[s] + rows[-1] // G) // ks + 1)
                parts = []
                for sp in range(splits):
                    m = np.full(len(rows), -1e30)
                    l, acc = np.zeros(len(rows)), np.zeros((len(rows), hd))
                    for j in range(sp * per, min(live, sp * per + per)):
                        keys = j * ks + np.arange(ks)
                        pg = pt[s, keys // page]
                        kk = k_pool[pg, h, :, keys % page]        # (ks, hd)
                        vv = v_pool[pg, h, keys % page, :]        # (ks, hd)
                        sc = qr @ kk.T / np.sqrt(hd)
                        sc = np.where(keys[None] <= limit[:, None], sc, -1e30)
                        m_new = np.maximum(m, sc.max(axis=1))
                        pr = np.where(sc <= -5e29, 0.0,
                                      np.exp(sc - m_new[:, None]))
                        corr = np.exp(m - m_new)
                        l = l * corr + pr.sum(axis=1)
                        acc = acc * corr[:, None] + pr @ vv
                        m = m_new
                    parts.append((m, l, acc))
                M = np.max([np.where(pl > 0, pm, -1e30)
                            for pm, pl, _ in parts], axis=0)
                w = [np.where(pl > 0, np.exp(pm - M), 0.0)
                     for pm, pl, _ in parts]
                L = sum(wi * pl for wi, (_, pl, _) in zip(w, parts))
                A = sum(wi[:, None] * pa for wi, (_, _, pa) in zip(w, parts))
                safe = np.where(L > 0, L, 1.0)[:, None]
                o = np.where(L[:, None] > 0, A / safe, 0.0)
                out[s, rows // G, h * G + rows % G] = o
    return out


@pytest.mark.parametrize("page,ks,splits,tile", [
    (1, 1, 7, 1), (2, 2, 3, 4), (4, 4, 5, 2), (512, 64, 4, 16),
    (512, 64, 1, 64), (16, 16, 40, 8)])
def test_split_walk_matches_plain_and_jax_kernel(page, ks, splits, tile):
    """The kernels' split page walk, emulated in f64, equals the plain
    version and the JAX kernel (interpret mode): ragged positions (a
    slot at 0, slots ending mid-slice and mid-page), an inactive slot,
    GQA (4 query heads on 2 KV heads, C = 3 chunks folded as (c, g)
    rows), splits that see no live key and tiles whose last rows are
    ragged. Tolerance 1e-5 (f32 against f64 sums)."""
    rng = np.random.default_rng(page + 7 * splits)
    S, C, H, Hkv, hd = 4, 3, 4, 2, 8
    n_pages = max(2, 1024 // page) if page > 2 else 40 // page
    q, k_pool, v_pool, pt = _inputs(rng, S, C, H, Hkv, hd, page, n_pages)
    L = n_pages * page
    p0 = np.array([0, L // 2 + 1, L - C, 5], np.int32)
    active = np.array([True, True, True, False])
    got = _split_walk(q, k_pool, v_pool, pt, p0, active, ks, splits, tile)
    np.testing.assert_allclose(got, _port(q, k_pool, v_pool, pt, p0, active),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got, _jax_kernel(q, k_pool, v_pool, pt, p0, active), rtol=TOL,
        atol=TOL)


@pytest.mark.parametrize("bf16,int8,S,C,H,Hkv,hd,page,n_pages", [
    (True, False, 8, 1, 8, 8, 128, 128, 34),     # serve decode
    (True, False, 1, 256, 8, 8, 128, 128, 34),   # serve prefill chunk
    (True, True, 8, 5, 8, 8, 128, 128, 34),      # int8 verify
    (False, False, 1, 64, 4, 4, 256, 128, 8),    # f32, hd 256
    (True, True, 3, 1, 4, 2, 64, 1, 80),         # int8, page 1
    (True, False, 1, 256, 8, 2, 128, 512, 5),    # bf16, page 512, GQA
    (True, False, 1, 1, 1, 1, 128, 16, 512),     # one slot, one head
    (False, False, 1, 256, 8, 8, 128, 128, 34),  # f32 serve prefill chunk
    (False, True, 1, 256, 8, 8, 128, 128, 34),   # f32 q, int8 pools, chunk
    (False, False, 1, 256, 8, 2, 128, 128, 34),  # f32 chunk, GQA
    (False, True, 1, 256, 4, 2, 128, 512, 5),    # f32 q, int8, page 512, GQA
    (False, False, 1, 256, 8, 2, 128, 512, 5),   # f32 chunk, page 512, GQA
    (False, False, 1, 256, 8, 2, 128, 64, 68),   # f32 chunk, page 64, GQA
    (False, False, 8, 1, 8, 8, 128, 128, 34),    # f32 decode: scalar
    (False, False, 2, 5, 4, 4, 128, 128, 34),    # f32 verify C=5: scalar
    (False, False, 1, 40, 4, 4, 128, 2, 60),     # f32 chunk, page 2: scalar
])
def test_plan_covers_every_slice_once(bf16, int8, S, C, H, Hkv, hd, page,
                                      n_pages):
    """`plan` (the launch the wrapper gives the kernels): slices divide
    the page and fit the 32 KB staging budget, the splits' contiguous
    ranges cover every slice of a slot exactly once, tiles cover every
    (c, g) row, a tensor-core route is taken exactly when pages hold at
    least 64 positions, hd is 64, 128 or 256 and a KV head has 32 (c, g)
    rows or more ("mma" for bf16 q, "tf32" for f32 q, dense or int8
    pools: prefill chunks at C=256; decode and verify stay "scalar"),
    and the merge's warp holds every split's (m, l) (at most 32
    splits)."""
    p = pa.plan(bf16, int8, S, C, H, Hkv, hd, page, n_pages, 132)
    elem = 1 if int8 else 2 if bf16 else 4
    assert page % p.ks == 0 and p.ks * hd * elem <= 32768
    total = n_pages * page // p.ks
    per = -(-total // p.splits)
    covered = [j for sp in range(p.splits)
               for j in range(sp * per, min(total, sp * per + per))]
    assert covered == list(range(total))
    assert p.tiles * p.rows >= C * H // Hkv > (p.tiles - 1) * p.rows
    wide = page >= 64 and hd in (64, 128, 256) and C * H // Hkv >= 32
    assert p.route == (("mma" if bf16 else "tf32") if wide else "scalar")
    assert (p.ks, p.rows) == {"mma": (64, 64), "tf32": (32, 64)}.get(
        p.route, (p.ks, p.rows))
    assert 1 <= p.splits <= 32


def _mm_tf32(a, b, passes, chunk):
    """a @ b as the tf32 kernel forms it: operands rounded to TF32 (rna),
    three products with their small parts (a_small b_big + a_big b_small
    + a_big b_big) or one (big only), each `chunk`-wide run of the summed
    axis summed apart (a fresh accumulator) and the runs added in f32."""
    out = None
    for k0 in range(0, a.shape[-1], chunk):
        x, y = a[..., k0:k0 + chunk], b[..., k0:k0 + chunk, :]
        xb, yb = _tf32(x), _tf32(y)
        part = xb @ yb
        if passes == 3:
            part = (_tf32(x - xb) @ yb + xb @ _tf32(y - yb)) + part
        out = part if out is None else out + part
    return out


def _tf32_chunk(q, k_pool, v_pool, pt, p0, passes):
    """The f32 chunk with the tf32 kernel's products, emulated in torch:
    scores over 16-dim runs, P V over 32-key runs (a slice), P in f32;
    (c, g) rows per KV head as the kernel folds GQA."""
    S, C, H, hd = q.shape
    Hkv = k_pool.shape[1]
    G = H // Hkv
    kd, vd = paged_gather(k_pool, v_pool, pt)
    qg = q.reshape(S, C, Hkv, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(S, Hkv, C * G, hd)
    sc = _mm_tf32(qg, kd, passes, 16) / np.sqrt(hd)
    limit = (torch.from_numpy(p0).long()[:, None]
             + torch.arange(C)[None]).repeat_interleave(G, dim=1)
    keep = torch.arange(kd.shape[-1])[None, None, None, :] \
        <= limit[:, None, :, None]
    sc = torch.where(keep, sc, torch.full_like(sc, -1e30))
    p = torch.where(keep, torch.exp(sc - sc.amax(-1, keepdim=True)),
                    torch.zeros_like(sc))
    out = _mm_tf32(p, vd, passes, 32) / p.sum(-1, keepdim=True)
    return out.reshape(S, Hkv, C, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(S, C, H, hd)


def test_f32_tolerance_accepts_split_tf32_chunk_and_rejects_one_pass():
    """The f32 check of the tf32 chunk kernel (atol = rtol =
    TOLERANCE[float32] = 2e-4, as `chip_smoke.py` holds it) tells split
    TF32 from one TF32 pass: the chunk's products emulated on the CPU
    (C=64, 4 query heads on 2 KV heads, hd 128, pages of 64, scores of
    std ~2) stay within 0.1 of the tolerance of the JAX kernel (interpret
    mode) with three passes and land outside it with one."""
    rng = np.random.default_rng(5)
    S, C, H, Hkv, hd, page, n_pages = 1, 64, 4, 2, 128, 64, 6
    q, k_pool, v_pool, pt = _inputs(rng, S, C, H, Hkv, hd, page, n_pages)
    q = (2.0 * q).astype(np.float32)
    p0 = np.array([250], np.int32)
    ref = _jax_kernel(q, k_pool, v_pool, pt, p0)
    t = pa.TOLERANCE[torch.float32]
    units = {}
    for passes in (3, 1):
        got = _tf32_chunk(*(torch.from_numpy(a) for a in (q, k_pool, v_pool,
                                                          pt)),
                          p0, passes).numpy()
        units[passes] = float((np.abs(got - ref) / (t + t * np.abs(ref)))
                              .max())
    assert units[3] <= 0.1 and units[1] > 1.0, units


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_matches_plain(dtype):
    """MHA and GQA, decode (C=1) and chunk (C=64) widths, shuffled page
    tables, an inactive lane; one launch counted per call. The reference
    is the plain version in f32 on the same (cast up) inputs; tolerance
    atol = rtol = 2e-4 (f32) / 4e-3 (bf16, the output's rounding)."""
    _card()
    dt = getattr(torch, dtype)
    tol = pa.TOLERANCE[dt]
    rng = np.random.default_rng(23)
    hd, page, n_pages = 128, 128, 6
    for H, Hkv, C in [(8, 8, 1), (8, 2, 1), (8, 8, 64), (8, 2, 64)]:
        S = 4 if C == 1 else 1
        P = S * n_pages
        q = rng.standard_normal((S, C, H, hd)).astype(np.float32)
        k_pool = rng.standard_normal((P + 1, Hkv, hd, page)).astype(np.float32)
        v_pool = rng.standard_normal((P + 1, Hkv, page, hd)).astype(np.float32)
        pt = rng.permutation(np.arange(1, P + 1)).reshape(S, n_pages) \
            .astype(np.int32)
        pos = rng.integers(0, n_pages * page - C, S).astype(np.int32)
        active = np.ones(S, bool)
        active[0] = S == 1
        q_t, kp, vp = (torch.from_numpy(a).cuda().to(dt)
                       for a in (q, k_pool, v_pool))
        pt_t, pos_t = torch.from_numpy(pt).cuda(), torch.from_numpy(pos).cuda()
        act = torch.from_numpy(active).cuda()
        launches = pa.paged_attention.launches
        got = pa.paged_attention(q_t, kp, vp, pt_t, pos_t, active=act)
        ref = pa.paged_attention_plain(q_t.float(), kp.float(), vp.float(),
                                       pt_t, pos_t, act)
        torch.cuda.synchronize()
        assert pa.paged_attention.launches == launches + 1
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol)
        if S > 1:
            assert (got[0] == 0).all()


@pytest.mark.gpu
def test_paged_attention_kernel_refuses_what_it_does_not_take():
    """On a CUDA tensor the wrapper raises instead of falling back."""
    _card()
    q = torch.zeros((1, 1, 2, 8), device="cuda", dtype=torch.float16)
    kp = torch.zeros((2, 2, 8, 8), device="cuda", dtype=torch.float16)
    vp = torch.zeros((2, 2, 8, 8), device="cuda", dtype=torch.float16)
    pt = torch.ones((1, 1), device="cuda", dtype=torch.int32)
    pos = torch.zeros((1,), device="cuda", dtype=torch.int32)
    calls = pa.paged_attention_plain.calls
    with pytest.raises(TypeError, match="f32 or bf16"):
        pa.paged_attention(q, kp, vp, pt, pos)
    with pytest.raises(ValueError, match="one CUDA device"):
        pa.paged_attention(q.float(), kp.float().cpu(), vp.float(), pt, pos)
    assert pa.paged_attention_plain.calls == calls


@pytest.mark.gpu
@pytest.mark.parametrize("pools", ["float32", "bfloat16", "int8"])
def test_paged_attention_kernel_takes_any_page_and_head_dim(pools):
    """The shapes whose whole pages did not fit a block's shared memory
    before (bf16 pools at hd=256/page=256 and hd=128/page=512, f32 pools
    at hd=256/page=128) and the int8 pools' pages of 1 and 2 positions:
    the kernels walk key slices and launch at all of them, decode and
    chunk widths, held to the plain version in f32 (int8: dequantized
    K/V rounded to q's type), atol = rtol = 2e-4 (f32 q) / 4e-3 (bf16
    q)."""
    _card()
    rng = np.random.default_rng(29)
    qdt = torch.float32 if pools == "float32" else torch.bfloat16
    tol = pa.TOLERANCE[qdt]
    for hd, page, n_pages in ((256, 256, 5), (128, 512, 3), (256, 128, 6),
                              (64, 1, 70), (64, 2, 40)):
        for C, S in ((1, 3), (48, 1)):
            H, Hkv = 4, 2
            P = S * n_pages
            q = torch.from_numpy(rng.standard_normal((S, C, H, hd))
                                 .astype(np.float32)).cuda().to(qdt)
            pt = torch.from_numpy(rng.permutation(np.arange(1, P + 1))
                                  .reshape(S, n_pages).astype(np.int32)).cuda()
            pos = torch.from_numpy(rng.integers(
                0, n_pages * page - C + 1, S).astype(np.int32)).cuda()
            kshape, vshape = (P + 1, Hkv, hd, page), (P + 1, Hkv, page, hd)
            if pools == "int8":
                kp, vp = (torch.from_numpy(rng.integers(
                    -127, 128, sh).astype(np.int8)).cuda()
                    for sh in (kshape, vshape))
                ks, vs = (torch.from_numpy((0.005 + 0.015 * rng.random(
                    (P + 1, Hkv, page))).astype(np.float32)).cuda()
                    for _ in range(2))
                extra = dict(k_scale=ks, v_scale=vs)
                kd, vd = kp, vp
            else:
                kp, vp = (torch.from_numpy(rng.standard_normal(sh).astype(
                    np.float32)).cuda().to(qdt) for sh in (kshape, vshape))
                extra = {}
                kd, vd = kp.float(), vp.float()
            launches = pa.paged_attention.launches
            got = pa.paged_attention(q, kp, vp, pt, pos, **extra)
            ref = pa.paged_attention_plain(q.float(), kd, vd, pt, pos,
                                           kv_dtype=qdt, **extra)
            torch.cuda.synchronize()
            assert pa.paged_attention.launches == launches + 1
            torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("pools", ["float32", "int8"])
def test_f32_chunk_kernel_on_the_tf32_route(pools):
    """The split-TF32 chunk kernel (f32 q, C=256 and C=64, MHA and GQA, pages
    of 64, 128 and 512 positions, dense and int8 pools) against the plain
    version in f32, atol = rtol = 2e-4; every launch on the "tf32"
    route, a decode step of the same pools on "scalar"."""
    _card()
    rng = np.random.default_rng(31)
    tol = pa.TOLERANCE[torch.float32]
    for (C, H, Hkv, page, n_pages) in ((256, 8, 8, 128, 34),
                                       (256, 8, 2, 64, 68),
                                       (256, 8, 2, 512, 9),
                                       (64, 4, 2, 128, 8)):
        S, hd = 1, 128
        P = S * n_pages
        q = torch.from_numpy(rng.standard_normal((S, C, H, hd))
                             .astype(np.float32)).cuda()
        pt = torch.from_numpy(rng.permutation(np.arange(1, P + 1))
                              .reshape(S, n_pages).astype(np.int32)).cuda()
        pos = torch.tensor([n_pages * page - C - 7], dtype=torch.int32,
                           device="cuda")
        kshape, vshape = (P + 1, Hkv, hd, page), (P + 1, Hkv, page, hd)
        if pools == "int8":
            kp, vp = (torch.from_numpy(rng.integers(-127, 128, sh)
                                       .astype(np.int8)).cuda()
                      for sh in (kshape, vshape))
            extra = {name: torch.from_numpy((0.005 + 0.015 * rng.random(
                (P + 1, Hkv, page))).astype(np.float32)).cuda()
                for name in ("k_scale", "v_scale")}
        else:
            kp, vp = (torch.from_numpy(rng.standard_normal(sh).astype(
                np.float32)).cuda() for sh in (kshape, vshape))
            extra = {}
        pa.reset_counts()
        got = pa.paged_attention(q, kp, vp, pt, pos, **extra)
        step = pa.paged_attention(q[:, :1].contiguous(), kp, vp, pt, pos,
                                  **extra)
        ref = pa.paged_attention_plain(q, kp, vp, pt, pos, **extra)
        torch.cuda.synchronize()
        assert pa.paged_attention.launches_by_route == {
            (C, "tf32"): 1, (1, "scalar"): 1}
        assert step.shape == (S, 1, H, hd)
        torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
