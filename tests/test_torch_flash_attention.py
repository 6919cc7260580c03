"""The port's flash attention held against the JAX package on the CPU.

The plain forward and its autograd gradients (through `_FlashAttention`,
whose backward is the plain backward on CPU tensors) against the JAX
package's Pallas kernels in interpret mode and its blockwise attention,
at B=2, T=256, H=2, D=128, block 128, causal and non-causal, f32:
atol = rtol = 1e-5. `torch.autograd.gradcheck` of `_FlashAttention` in
f64 at a tiny shape. `multi_head_attention`'s routes: flash, blockwise
under a key mask, GQA, and the T > block_size case. The CUDA kernels run
only on the card: the `gpu`-marked test holds them to the plain versions
computed in f32 (`python -m pytest -m gpu tests/test_torch_*.py`). The
f32 kernels compute their products in split TF32: a CPU emulation of
those products (TF32 rounding by integer masking) shows that the f32
tolerance accepts three TF32 passes and rejects one, also with the score
products summed as the f32 clusters sum them at D = 256, 384 and 512, in
the forward and the backward (partials over 128-column slices, added in
f32 in rank order); with the tensor cores' truncation emulated too,
scores that cancel within a slice tell fresh accumulators from one
chained over the slice, and inputs whose V slices repeat tell cluster
members that add the partial scores in different orders. The bf16
backward kernels at D = 256 ("wgmma wide") and at D = 384 and 512
("wgmma cluster": two blocks, one column half each, whose partial scores
are added in rank order) are emulated in plain torch (their tile order,
the log2 domain, P and dS rounded to nearest bf16) and held to the JAX
package's backward in bf16 within the bf16 tolerance; the card check's
dS-rounding inputs tell a truncated dS, and its halves inputs tell a
block that adds the partials in its own order.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops import attention as jatt  # noqa: E402
from deeplearning4j_tpu.ops.pallas_attention import (  # noqa: E402
    flash_attention as jflash,
)
from deeplearning4j_tpu_torch.ops import attention as patt  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402


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
B, T, H, D = 2, 256, 2, 128


def _inputs(seed, shape=(B, T, H, D), n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_and_gradients_match_jax(causal):
    q, k, v, do = _inputs(0)
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def jf(a, b, c):
        return jflash(a, b, c, causal=causal, block_q=128, block_k=128,
                      interpret=True)

    ref = jf(jq, jk, jv)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) * do),
                      argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fa.reset_counts()
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    assert fa.flash_attention_plain_fwd.calls == 1
    assert fa.flash_attention_plain_bwd.calls == 1
    assert fa.flash_forward.launches == 0
    _close(out, ref)
    _close(out, jatt.blockwise_attention(jq, jk, jv, causal=causal,
                                         block_size=128))
    for got, want in zip((tq, tk, tv), jgrads):
        _close(got.grad, want)


@pytest.mark.parametrize("Dh", [256, 384, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_at_wide_heads_matches_jax(Dh, causal):
    """Head dims 256, 384 and 512 (the kernels' column-split and 32-key
    tiles on the card): the plain forward and its gradients against the JAX
    package's flash path in interpret mode (B=1, T=256, H=2, blocks of
    128), atol = rtol = 1e-5."""
    q, k, v, do = _inputs(10 + Dh, shape=(1, T, 2, Dh))
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def jf(a, b, c):
        return jflash(a, b, c, causal=causal, block_q=128, block_k=128,
                      interpret=True)

    ref = jf(jq, jk, jv)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) * do),
                      argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    _close(out, ref)
    for got, want in zip((tq, tk, tv), jgrads):
        _close(got.grad, want)


def test_plain_lse_is_the_row_logsumexp():
    """L = logsumexp of the scaled, causally masked scores, (B*H, T)."""
    q, k, v, _ = _inputs(1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = fa.flash_attention_plain_fwd(tq, tk, tv, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / np.sqrt(D)
    s = s.masked_fill(torch.ones(T, T).triu(1).bool(), float("-inf"))
    _close(lse, torch.logsumexp(s, -1).reshape(B * H, T))


def test_flash_autograd_gradcheck_f64():
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(rng.standard_normal((1, 8, 2, 4)))
            .requires_grad_() for _ in range(3)]
    for causal in (False, True):
        assert torch.autograd.gradcheck(
            lambda a, b, c: fa._FlashAttention.apply(a, b, c, causal, None),
            args, eps=1e-6, atol=1e-7)


def test_fully_masked_rows_give_zero_and_neg_inf():
    """Causal with Tq > Tk aligns queries to the end of the keys, so the
    first Tq - Tk rows see no key: O = 0 and L = NEG_INF there, the
    other rows equal the JAX package's full attention."""
    q, k, v = _inputs(6, shape=(1, 6, 2, 8), n=3)
    o, lse = fa.flash_attention_plain_fwd(
        *map(torch.from_numpy, (q, k[:, :2], v[:, :2])), causal=True)
    assert (o[:, :4] == 0).all()
    assert (lse.reshape(2, 6)[:, :4] == fa.NEG_INF).all()
    _close(o, jatt.full_attention(*map(jnp.asarray, (q, k[:, :2], v[:, :2])),
                                  causal=True))


def test_mha_routes_flash_for_long_unmasked_sequences():
    q, k, v, _ = _inputs(3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    fa.reset_counts()
    out = patt.multi_head_attention(tq, tk, tv, causal=True, block_size=128)
    assert fa.flash_attention_plain_fwd.calls == 1
    _close(out, jatt.multi_head_attention(*map(jnp.asarray, (q, k, v)),
                                          causal=True, block_size=128))
    fa.reset_counts()  # short sequences stay on full attention
    patt.multi_head_attention(tq, tk, tv, causal=True, block_size=256)
    assert fa.flash_attention_plain_fwd.calls == 0


def test_mha_key_mask_goes_blockwise():
    q, k, v, _ = _inputs(4)
    mask = np.ones((B, T), np.float32)
    mask[0, 200:] = 0
    mask[1, :17] = 0
    fa.reset_counts()
    out = patt.multi_head_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=True, block_size=128,
                                    key_mask=torch.from_numpy(mask))
    assert fa.flash_attention_plain_fwd.calls == 0
    _close(out, jatt.multi_head_attention(*map(jnp.asarray, (q, k, v)),
                                          causal=True, block_size=128,
                                          key_mask=jnp.asarray(mask)))
    _close(out, jatt.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=True, block_size=128,
                                         key_mask=jnp.asarray(mask)))


def test_mha_gqa_widens_for_flash_and_sums_grads():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, T, 4, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, 2, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, T, 4, D)).astype(np.float32)

    def jf(a, b, c):
        return jatt.multi_head_attention(a, b, c, causal=True,
                                         block_size=128)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) * do),
                      argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fa.reset_counts()
    out = patt.multi_head_attention(tq, tk, tv, causal=True, block_size=128)
    out.backward(torch.from_numpy(do))
    assert fa.flash_attention_plain_fwd.calls == 1
    _close(out, jf(jq, jk, jv))
    for got, want in zip((tq, tk, tv), jgrads):
        _close(got.grad, want)


def test_sequence_parallel_scope_is_refused():
    """A scope without a mesh is refused; over a 2-slot `seq` mesh the
    layers' attention is ring attention, equal to full attention."""
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="needs a mesh"):
        with patt.sequence_parallel_scope(mesh=None):
            pass
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 8), generator=g, dtype=torch.float64)
               for _ in range(3))
    mesh = make_mesh({"seq": 2}, devices=[torch.device("cpu")] * 2)
    with patt.sequence_parallel_scope(mesh):
        out = patt.multi_head_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, patt.full_attention(q, k, v, causal=True),
                               rtol=1e-12, atol=1e-12)


def test_causal_flash_needs_equal_lengths():
    q = torch.zeros((1, 256, 1, 128))
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.flash_attention(q, q[:, :128], q[:, :128], causal=True)


def test_error_in_tolerances_holds_each_row_to_its_scale():
    """The kernels' check: an exact copy reads 0; bf16 rounding of the
    outputs stays within the bound; an output that left out the last
    64-key tile is caught in O (row by row) and in L (absolute)."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(5, (1, 1024, 1, 128)))
    o, lse = fa.flash_attention_plain_fwd(q, k, v)
    for dt in (torch.float32, torch.bfloat16):
        assert fa.error_in_tolerances("O", o.clone(), o, dt) == 0.0
        assert fa.error_in_tolerances("L", lse.clone(), lse, dt) == 0.0
    assert fa.error_in_tolerances("O", o.bfloat16(), o, torch.bfloat16) <= 1
    o_cut, lse_cut = fa.flash_attention_plain_fwd(q, k[:, :-64], v[:, :-64])
    assert fa.error_in_tolerances("O", o_cut, o, torch.bfloat16) > 1
    assert fa.error_in_tolerances("L", lse_cut, lse, torch.bfloat16) > 1
    bad = o.clone()
    bad[0, 0, 0, 0] = float("nan")
    assert fa.error_in_tolerances("O", bad, o, torch.float32) == float("inf")


@pytest.mark.parametrize("tile", [0, 1])
def test_causal_rows_ignore_keys_after_their_diagonal_tile(tile):
    """What the causal forward kernel's skip rests on: with 128-row query
    tiles, the rows of query tile i are unchanged (O and L, exactly) when
    every key and value after tile i's diagonal tile is replaced by
    noise."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(8, (1, 384, 2, 128), 3))
    o, lse = fa.flash_attention_plain_fwd(q, k, v, causal=True)
    cut = 128 * (tile + 1)
    noise = torch.from_numpy(
        np.random.default_rng(9).standard_normal((2, 1, 384 - cut, 2, 128))
        .astype(np.float32) * 50)
    k2, v2 = k.clone(), v.clone()
    k2[:, cut:], v2[:, cut:] = noise[0], noise[1]
    o2, lse2 = fa.flash_attention_plain_fwd(q, k2, v2, causal=True)
    rows = slice(128 * tile, cut)
    torch.testing.assert_close(o2[:, rows], o[:, rows], rtol=0, atol=0)
    torch.testing.assert_close(lse2.reshape(2, 384)[:, rows],
                               lse.reshape(2, 384)[:, rows], rtol=0, atol=0)
    assert not torch.equal(o2[:, cut:], o[:, cut:])


def _plain_grads(q, k, v, do, o=None, lse=None):
    """(dQ, dK, dV) of the plain causal backward; O and L from the plain
    forward unless given."""
    if o is None:
        o, lse = fa.flash_attention_plain_fwd(q, k, v, causal=True)
    return fa.flash_attention_plain_bwd(q, k, v, o, lse, do, causal=True)


@pytest.mark.parametrize("tile", [0, 1, 2])
def test_causal_dq_rows_ignore_keys_after_their_diagonal_tile(tile):
    """What the D=128 dQ kernel's causal skip rests on: with 64-row query
    tiles (one consumer warpgroup's rows; a block's 128 rows are two) and
    64-key K/V tiles, dQ of query tile i is unchanged, exactly, when every
    key and value after tile i's diagonal tile is replaced by noise (O and
    L stay those of the clean keys, as the kernel receives them)."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(12, (1, 256, 2, 128)))
    o, lse = fa.flash_attention_plain_fwd(q, k, v, causal=True)
    dq = _plain_grads(q, k, v, do, o, lse)[0]
    cut = 64 * (tile + 1)
    noise = torch.from_numpy(
        np.random.default_rng(13).standard_normal((2, 1, 256 - cut, 2, 128))
        .astype(np.float32) * 50)
    k2, v2 = k.clone(), v.clone()
    k2[:, cut:], v2[:, cut:] = noise[0], noise[1]
    dq2 = _plain_grads(q, k2, v2, do, o, lse)[0]
    rows = slice(64 * tile, cut)
    torch.testing.assert_close(dq2[:, rows], dq[:, rows], rtol=0, atol=0)
    assert not torch.equal(dq2[:, cut:], dq[:, cut:])


@pytest.mark.parametrize("tile", [1, 2, 3])
def test_causal_dkv_columns_ignore_queries_before_their_diagonal_tile(tile):
    """What the D=128 dK/dV kernel's causal skip (its first query tile is
    the block's diagonal tile) rests on: with 64-key blocks and 64-query
    tiles, dK and dV of key tile j are unchanged, exactly, when the
    queries, dO, O (so dsum) and L of every query before tile j's diagonal
    tile are replaced by noise."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(14, (1, 256, 2, 128)))
    o, lse = fa.flash_attention_plain_fwd(q, k, v, causal=True)
    _, dk, dv = _plain_grads(q, k, v, do, o, lse)
    cut = 64 * tile
    rng = np.random.default_rng(15)
    noise = torch.from_numpy(
        rng.standard_normal((3, 1, cut, 2, 128)).astype(np.float32) * 50)
    q2, do2, o2, lse2 = q.clone(), do.clone(), o.clone(), lse.clone()
    q2[:, :cut], do2[:, :cut], o2[:, :cut] = noise[0], noise[1], noise[2]
    lse2.reshape(2, 256)[:, :cut] = torch.from_numpy(
        rng.standard_normal((2, cut)).astype(np.float32) * 5)
    _, dk2, dv2 = _plain_grads(q2, k, v, do2, o2, lse2)
    keys = slice(cut, cut + 64)
    torch.testing.assert_close(dk2[:, keys], dk[:, keys], rtol=0, atol=0)
    torch.testing.assert_close(dv2[:, keys], dv[:, keys], rtol=0, atol=0)
    assert not torch.equal(dk2[:, :cut], dk[:, :cut])
    assert not torch.equal(dv2[:, :cut], dv[:, :cut])


def test_stats_ready_copies_only_what_the_bulk_copies_cannot_read():
    """The backward wrappers hand L and dsum to the kernels as contiguous
    f32 with a 16-byte aligned base (the dK/dV kernel copies 64-float runs
    of them by the bulk-copy engine): such a tensor passes uncopied; a
    view whose base is off by one float, a strided view and a bf16 one
    are copied into fresh f32 memory with the same values."""
    lse = torch.randn(4, 256)
    assert fa._stats_ready(lse) is lse
    flat = torch.randn(4 * 256 + 1)
    for t in (flat[1:].reshape(4, 256), torch.randn(256, 4).t(),
              lse.bfloat16()):
        got = fa._stats_ready(t)
        assert got is not t and got.is_contiguous()
        assert got.dtype == torch.float32 and got.data_ptr() % 16 == 0
        assert torch.equal(got, t.float())


def test_kernel_ready_passes_qkv_slices_and_copies_the_rest():
    """The wrapper's stride and alignment check (the forward kernel's TMA
    maps need a unit D stride, a 16-byte aligned base and positive
    16-byte multiples for the other strides): q, k, v sliced from one
    fused qkv projection reach the kernels uncopied; a tensor with a
    non-unit D stride, a base off by one element, a t stride that is not
    a 16-byte multiple, or a broadcast (zero) stride is copied."""
    B, Tn, Hn, Dn = 2, 16, 4, 128
    qkv = torch.randn(B, Tn, 3 * Hn * Dn, dtype=torch.bfloat16)
    for i in range(3):
        t = qkv[..., i * Hn * Dn:(i + 1) * Hn * Dn].reshape(B, Tn, Hn, Dn)
        assert not t.is_contiguous() and fa._kernel_ready(t) is t
    plain = torch.randn(B, Tn, Hn, Dn, dtype=torch.bfloat16)
    assert fa._kernel_ready(plain) is plain
    flat = torch.randn(B * Tn * Hn * Dn + 8, dtype=torch.bfloat16)
    odd_t = torch.randn(B, Tn, Hn * Dn + 1, dtype=torch.bfloat16)
    copied = {
        "D stride 2": torch.randn(B, Tn, Hn, 2 * Dn,
                                  dtype=torch.bfloat16)[..., ::2],
        "base off by one element": flat[1:1 + B * Tn * Hn * Dn]
        .reshape(B, Tn, Hn, Dn),
        "t stride not 16-byte aligned": odd_t[..., :Hn * Dn]
        .reshape(B, Tn, Hn, Dn),
        "broadcast over t": torch.randn(B, 1, Hn, Dn, dtype=torch.bfloat16)
        .expand(B, Tn, Hn, Dn),
    }
    for what, t in copied.items():
        got = fa._kernel_ready(t)
        assert got is not t and got.is_contiguous(), what
        assert torch.equal(got, t), what


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero, as `cvt.rna.tf32.f32`: add half a unit of the 13 dropped
    bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(eq, a, b, passes):
    """The kernels' product `einsum(eq, a, b)` on the tensor cores: one
    TF32 pass on rounded operands, or three (split TF32: x = big + small,
    a_small b_big + a_big b_small + a_big b_big, small terms first), each
    TF32 product exact in f32 and summed in f32."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return torch.einsum(eq, ab, bb)
    small = torch.einsum(eq, _tf32(a - ab), bb) + torch.einsum(
        eq, ab, _tf32(b - bb))
    return small + torch.einsum(eq, ab, bb)


def _scores_tf32(a, b, passes, slice_cols):
    """The score product a.b^T over D ("bqhd,bkhd->bhqk") in TF32: over all
    of D at once, or (`slice_cols`) as the f32 clusters compute it at
    D > 128: one partial per slice of `slice_cols` columns (one cluster
    member's), the partials added in f32 in rank order."""
    eq = "bqhd,bkhd->bhqk"
    if slice_cols is None:
        return _mm_tf32(eq, a, b, passes)
    parts = [_mm_tf32(eq, a[..., c:c + slice_cols], b[..., c:c + slice_cols],
                      passes) for c in range(0, a.shape[-1], slice_cols)]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _emulated(q, k, v, do, causal, passes, slice_cols=None):
    """(O, L, dQ, dK, dV) of the f32 kernels' arithmetic with every product
    in TF32 (`passes` 1 or 3): the plain versions' formulas, f32 softmax,
    statistics and dsum, masked entries exactly 0. The score products (the
    forward's S, the backward's S recomputed and dP) are summed over
    slices of `slice_cols` columns when given (`_scores_tf32`)."""
    B, Tq, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    keep = fa._keep(Tq, k.shape[1], q.device)

    def scaled(s):
        return s.masked_fill(~keep, fa.NEG_INF) if causal else s

    s = scaled(_scores_tf32(q, k, passes, slice_cols) * scale)
    masked = s <= fa.NEG_INF / 2
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(masked, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = (_mm_tf32("bhqk,bkhd->bhqd", p, v, passes) / l).transpose(1, 2)
    lse = m + torch.log(l)
    s = scaled(_scores_tf32(q, k, passes, slice_cols) * scale)
    p = torch.exp(s - lse).masked_fill(masked, 0.0)
    dsum = (do * o).sum(dim=-1).transpose(1, 2)[..., None]
    ds = p * (_scores_tf32(do, v, passes, slice_cols) - dsum)
    return (o, lse.reshape(B * H, Tq),
            _mm_tf32("bhqk,bkhd->bqhd", ds, k, passes) * scale,
            _mm_tf32("bhqk,bqhd->bkhd", ds, q, passes) * scale,
            _mm_tf32("bhqk,bqhd->bkhd", p, do, passes))


def test_tf32_rounding_and_split():
    """`_tf32` keeps 10 mantissa bits, rounds to nearest with ties away
    from zero on either sign, and big + small rebuilds x to 2^-21 of it
    (the split the f32 kernels apply to every operand)."""
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10
    for sgn in (1.0, -1.0):
        x = sgn * torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -20,
                                1 + 3 * ulp / 4])
        want = sgn * torch.tensor([1 + ulp, 1.0, 1 + ulp])
        assert torch.equal(_tf32(x), want)
    assert torch.equal(_tf32(one), one)
    x = torch.from_numpy(np.random.default_rng(20).standard_normal(4096)
                         .astype(np.float32))
    big = _tf32(x)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert (x - big).abs().max() <= ulp / 2 * x.abs().max()
    rebuilt = big + _tf32(x - big)
    assert bool(((rebuilt - x).abs() <= 2.0 ** -21 * x.abs()).all())


@pytest.mark.parametrize("causal", [False, True])
def test_f32_tolerance_accepts_split_tf32_and_rejects_one_pass(causal):
    """The f32 check (`fa.error_in_tolerances`, TOLERANCE[float32]) can
    tell f32 from TF32: the kernels' products emulated in split TF32 stay
    within 0.1 of the tolerance of the plain f32 version (O, dQ, dK, dV
    row by row, L absolute), one TF32 pass lands outside it in every
    output (B=1, H=2, T=256, D=128; the phase-4 and training shapes made
    small)."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(30 + causal, (1, 256, 2, 128)))
    ro, rl = fa.flash_attention_plain_fwd(q, k, v, causal)
    ref = (ro, rl) + fa.flash_attention_plain_bwd(q, k, v, ro, rl, do,
                                                  causal)
    names = ("O", "L", "dQ", "dK", "dV")
    three = _emulated(q, k, v, do, causal, passes=3)
    one = _emulated(q, k, v, do, causal, passes=1)
    for name, got3, got1, want in zip(names, three, one, ref):
        assert fa.error_in_tolerances(name, got3, want,
                                      torch.float32) <= 0.1, name
        if name != "L":
            assert fa.error_in_tolerances(name, got1, want,
                                          torch.float32) > 1.0, name


@pytest.mark.parametrize("Dh", [256, 384, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_wide_head_tolerance_accepts_sliced_split_tf32(Dh, causal):
    """The f32 kernels at D = 256, 384 and 512 (clusters of D / 128
    blocks) sum each score product, the forward's and the backward's, as
    partials over 128-column slices, one per
    block, added in f32 in rank order: emulated so with three TF32 passes,
    O, dQ, dK and dV stay within 0.1 of the f32 tolerance of the plain f32
    version (L too), and with one pass each lands above it (B=1, H=2,
    T=256)."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(40 + Dh + causal, (1, 256, 2, Dh)))
    ro, rl = fa.flash_attention_plain_fwd(q, k, v, causal)
    ref = (ro, rl) + fa.flash_attention_plain_bwd(q, k, v, ro, rl, do,
                                                  causal)
    three = _emulated(q, k, v, do, causal, passes=3, slice_cols=128)
    one = _emulated(q, k, v, do, causal, passes=1, slice_cols=128)
    for name, got3, got1, want in zip(("O", "L", "dQ", "dK", "dV"), three,
                                      one, ref):
        assert fa.error_in_tolerances(name, got3, want,
                                      torch.float32) <= 0.1, name
        if name != "L":
            assert fa.error_in_tolerances(name, got1, want,
                                          torch.float32) > 1.0, name


def _rz(x):
    """f64 `x` rounded toward zero to f32."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _scores_tc(a, b, chained):
    """The score a.b^T (a, b: (T, D) f32) as the f32 clusters sum it at
    D > 128: one partial per 128-column slice (one cluster
    member's), computed as the tensor cores sum it, and the partials added
    in f32 in rank order. A partial takes, per k-step of 8, three m16n8k8
    passes (small terms first), each adding its exact products to the
    accumulator and truncating the sum to f32; a fresh accumulator every
    two k-steps added to the slice's running f32 sum, or (`chained`) one
    accumulator over all 128 columns. The slices run side by side as a
    batch."""
    T, D = a.shape
    a, b = (x.reshape(T, D // 128, 128).transpose(0, 1) for x in (a, b))
    ab, bb = _tf32(a), _tf32(b)
    parts = ((_tf32(a - ab), bb), (ab, _tf32(b - bb)), (ab, bb))
    acc = torch.zeros(D // 128, T, T)
    t = torch.zeros_like(acc)
    for k0 in range(0, 128, 8):
        for x, y in parts:
            t = _rz(t.double() + x[..., k0:k0 + 8].double()
                    @ y[..., k0:k0 + 8].double().transpose(1, 2))
        if not chained and k0 % 16 == 8:
            acc, t = acc + t, torch.zeros_like(t)
    partial = t if chained else acc
    total = partial[0]
    for p in partial[1:]:  # the members' partials, in rank order
        total = total + p
    return total


@pytest.mark.parametrize("Dh", [256, 384, 512])
def test_cancelling_scores_tell_a_chained_accumulator(Dh):
    """What the card check's cancelling case (`chip_smoke.
    flash_cancel_inputs`, a = 3) rests on: q = a r u + n / a, k = a s +
    n' / a (r, s a sign per query and per key, u = +1 on the first 64
    columns of each 128-column slice and -1 on the last 64), so each
    slice's running score sum climbs to about 64 a^2 and falls back.
    Scores summed as the f32 clusters sum them (tensor-core
    truncation emulated: `_scores_tc`), P, dS and the outputs in f64
    from them, against the plain backward in f64 (causal, B=1, H=1,
    T=256): fresh accumulators stay within 0.5 of the f32 tolerance in
    dQ, dK and dV, one accumulator chained over each slice lands above
    it in at least one."""
    rng = np.random.default_rng(50 + Dh)
    T, a = 256, 3.0
    r, s = (rng.choice([-1.0, 1.0], (T, 1)) for _ in range(2))
    u = np.tile(np.r_[np.ones(64), -np.ones(64)], Dh // 128)
    q = a * r * u + rng.standard_normal((T, Dh)) / a
    k = a * s + rng.standard_normal((T, Dh)) / a
    v, do = rng.standard_normal((2, T, Dh))
    q, k, v, do = (torch.from_numpy(x.astype(np.float32)) for x in
                   (q, k, v, do))
    wide = [x.double()[None, :, None] for x in (q, k, v, do)]
    o, lse = fa.flash_attention_plain_fwd(*wide[:3], causal=True)
    ref = fa.flash_attention_plain_bwd(*wide[:3], o, lse, wide[3],
                                       causal=True)
    scale = 1.0 / np.sqrt(Dh)
    keep = fa._keep(T, T, q.device)
    dsum = (wide[3] * o).sum(-1)[0, :, 0, None]
    dp = wide[3][0, :, 0] @ wide[2][0, :, 0].T
    worst = {}
    for chained in (False, True):
        scores = _scores_tc(q, k, chained)
        p = torch.exp(scores.double() * scale - lse[0, :, None])
        p = p.masked_fill(~keep, 0.0)
        ds = p * (dp - dsum)
        got = (ds @ wide[1][0, :, 0] * scale, ds.T @ wide[0][0, :, 0] * scale,
               p.T @ wide[3][0, :, 0])
        worst[chained] = max(
            fa.error_in_tolerances(n, g[None, :, None], w, torch.float32)
            for n, g, w in zip(("dQ", "dK", "dV"), got, ref))
    assert worst[False] <= 0.5 and worst[True] > 1.0, worst


def _scores_from_rank(a, b, first):
    """a.b^T (a, b: (T, D) f32) as one cluster member sums it: partials
    over 128-column slices added in f32 in rank order around the cluster
    from rank `first` (0 in every member of the kernels)."""
    parts = [a[:, c:c + 128] @ b[:, c:c + 128].T
             for c in range(0, a.shape[1], 128)]
    total = parts[first]
    for r in range(1, len(parts)):
        total = total + parts[(first + r) % len(parts)]
    return total


@pytest.mark.parametrize("Dh", [384, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_repeated_v_slices_tell_members_that_order_partials_apart(Dh,
                                                                  causal):
    """What the card check's forward slice bits rest on (`chip_smoke.
    flash_fwd_sliced_inputs`: q and k random, v's 128-column slices one
    slice repeated; B=1, H=1, T=256): member r's slice of O is softmax(S)
    v's slice r, with S as member r sums the partial scores. Members that
    all add them in rank order give bit-identical O slices; members that
    each start from their own rank give O slices that differ in bits,
    though each stays within the f32 tolerance of the plain forward, so
    only the bits tell. (At D = 256 both orders of two partials give the
    same f32 sum.)"""
    q, k, v, _ = _chip_smoke().flash_fwd_sliced_inputs(
        torch, 1, 256, 1, Dh, seed=Dh + causal, device="cpu")
    scale = 1.0 / np.sqrt(Dh)
    keep = fa._keep(256, 256, q.device)
    ref, _ = fa.flash_attention_plain_fwd(q, k, v, causal)

    def o_slice(first):
        s = _scores_from_rank(q[0, :, 0], k[0, :, 0], first) * scale
        if causal:
            s = s.masked_fill(~keep, fa.NEG_INF)
        return torch.softmax(s, dim=-1) @ v[0, :, 0, :128]

    ranked = [o_slice(0) for _ in range(Dh // 128)]
    own = [o_slice(r) for r in range(Dh // 128)]
    assert all(torch.equal(ranked[0], o) for o in ranked[1:])
    assert not all(torch.equal(own[0], o) for o in own[1:])
    for r, o in enumerate(own):
        want = ref[0, :, 0, 128 * r:128 * (r + 1)]
        assert fa.error_in_tolerances("O", o, want, torch.float32) <= 1.0


def _chip_smoke():
    """The card script as a module (it imports only the standard library
    at its top), for its input builders."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("Dh", [256, 384, 512])
def test_rounding_case_tells_a_truncated_p(Dh):
    """What the card check's P-rounding case (`chip_smoke.
    flash_rounding_inputs`) rests on: every tile of 32 keys holds the
    row's maximum score, so an online softmax rounds the same P as the
    plain forward (P against the row maximum); the P that gets rounded
    lies at least a fifth of a bf16 unit from a rounding midpoint; and
    the plain forward on the bf16 inputs (P rounded to nearest bf16
    before P V, l from the f32 P) and the same arithmetic with P
    truncated to bf16 differ in O by more than 16 times the bf16
    tolerance."""
    q, k, v = _chip_smoke().flash_rounding_inputs(torch, Dh, device="cpu")
    dt = torch.bfloat16
    s = fa._scores(q.float(), k.float(), False, 1.0 / np.sqrt(Dh))
    rowmax = s.amax(dim=-1, keepdim=True)
    tiles = s.reshape(*s.shape[:-1], -1, 32).amax(dim=-1)
    assert bool((tiles == rowmax).all())
    p = torch.exp(s - rowmax)
    ulps = p * 256  # P lies in [0.5, 1]: a bf16 unit is 1/256
    assert bool(((ulps - ulps.floor() - 0.5).abs() >= 0.2).all())
    ro, _ = fa.flash_attention_plain_fwd(q, k, v)
    trunc = (p.view(torch.int32) & ~0xFFFF).view(torch.float32)
    o = torch.einsum("bhqk,bkhd->bqhd", trunc, v.float()) \
        / p.sum(-1).transpose(1, 2)[..., None]
    assert fa.error_in_tolerances("O", o.to(dt), ro, dt) > 16.0


def _wide_bwd_emulated(q, k, v, do, o, lse, causal):
    """(dQ, dK, dV) of the bf16 backward kernels at D = 256 ("wgmma wide")
    in plain torch, on bf16 q, k, v, dO and the forward's O (bf16) and L:
    their tile order (dQ over key tiles of 32, taken in turn by two
    warpgroups whose f32 partials are added at the end; dK/dV over query
    tiles of 64; each tile's product added to an f32 accumulator in turn;
    tiles above the diagonal, which the kernels skip, add exact zeros),
    P = 2^(S * scale * log2(e) - L *
    log2(e)) with masked entries exactly 0, dS = P (dP - dsum) with dsum
    = rowsum(dO * O) in f32, P and dS rounded to nearest bf16 as the
    products' A operands, the scale applied to dQ and dK once at the end,
    every output rounded to bf16."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    Tq, Tk, D = q.shape[1], k.shape[1], q.shape[-1]
    scale = np.float32(1.0 / np.sqrt(D))
    c = torch.tensor(scale * np.float32(np.log2(np.e)))
    l2 = (lse.float() * float(np.float32(np.log2(np.e)))).reshape(
        q.shape[0], q.shape[2], Tq, 1)
    dsum = fa._dsum(o, do).reshape(q.shape[0], q.shape[2], Tq, 1)
    keep = fa._keep(Tq, Tk, q.device)
    bf = torch.bfloat16

    def tile(rows, cols):
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kf[:, cols])
        p = torch.exp2(s * c - l2[:, :, rows])
        if causal:
            p = p.masked_fill(~keep[rows][:, cols], 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, rows], vf[:, cols])
        return p, p * (dp - dsum[:, :, rows])

    part = [torch.zeros_like(qf), torch.zeros_like(qf)]
    for j in range(0, Tk, 32):
        cols = slice(j, j + 32)
        _, ds = tile(slice(0, Tq), cols)
        part[j // 32 % 2] += torch.einsum("bhqk,bkhd->bqhd", ds.to(bf).float(),
                                          kf[:, cols])
    dq = part[0] + part[1]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i in range(0, Tq, 64):
        rows = slice(i, i + 64)
        p, ds = tile(rows, slice(0, Tk))
        dv += torch.einsum("bhqk,bqhd->bkhd", p.to(bf).float(), dof[:, rows])
        dk += torch.einsum("bhqk,bqhd->bkhd", ds.to(bf).float(), qf[:, rows])
    return (dq * scale).to(bf), (dk * scale).to(bf), dv.to(bf)


@pytest.mark.parametrize("causal", [False, True])
def test_wide_backward_emulation_matches_jax(causal):
    """The arithmetic of the bf16 backward kernels at D = 256
    (`_wide_bwd_emulated`: their tile order, the log2 domain, P and dS
    rounded to nearest bf16 as A operands) against the JAX package's
    backward in bf16 (`_flash_mha_bwd` through `jax.grad`, Pallas in
    interpret mode, blocks of 128) on the same bf16 inputs (B=1, T=256,
    H=2): dQ, dK and dV row by row within `fa.error_in_tolerances`
    (TOLERANCE[bfloat16], 2^-6 of a row's scale)."""
    Dh = 256
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(60 + causal, (1, T, 2, Dh)))
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (q, k, v, do))

    def jf(a, b, c):
        return jflash(a, b, c, causal=causal, block_q=128, block_k=128,
                      interpret=True)

    jgrads = jax.grad(lambda a, b, c: jnp.sum(
        jf(a, b, c).astype(jnp.float32) * jdo.astype(jnp.float32)),
        argnums=(0, 1, 2))(jq, jk, jv)
    o, lse = fa.flash_attention_plain_fwd(q, k, v, causal)
    got = _wide_bwd_emulated(q, k, v, do, o, lse, causal)
    for name, g, want in zip(("dQ", "dK", "dV"), got, jgrads):
        ref = torch.from_numpy(np.array(want.astype(jnp.float32)))
        assert fa.error_in_tolerances(name, g, ref, torch.bfloat16) <= 1.0, \
            name


def _fma(a, b, c):
    """fmaf of f32 tensors, through f64 (where an f32 product is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _cluster_bwd_emulated(q, k, v, do, o, lse, causal, own_order=False):
    """(dQ, dK, dV) of the bf16 backward kernels at D = 384 and 512
    ("wgmma cluster") in plain torch, on bf16 q, k, v, dO and the
    forward's O (bf16) and L. A cluster's two blocks each compute the
    partial scores over their column half r (S_r = Q_r K_r^T and dP_r =
    dO_r V_r^T, f32) and form, from both in rank order, P = 2^(fma(S_0, c,
    fma(S_1, c, -L log2(e)))) with c = scale log2(e) (masked entries
    exactly 0) and dS = P (dP_0 + (dP_1 - dsum)), dsum = rowsum(dO * O) in
    f32; P and dS rounded to nearest bf16 as the products' A operands;
    each block accumulates its half of the outputs in the kernels' tile
    order (dQ over key tiles of 32, taken in turn by two warpgroups whose
    f32 partials are added at the end; dK/dV over query tiles of 32; tiles
    above the diagonal, which the kernels skip, add exact zeros); the scale
    applied to dQ and dK once at the end, every output rounded to bf16.
    With `own_order`, the block of rank 1 adds the partials in its own
    order (its own first), as a faulty kernel would."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    Bq, Tq, Hq, D = q.shape
    Tk = k.shape[1]
    halves = (slice(0, D // 2), slice(D // 2, D))
    scale = np.float32(1.0 / np.sqrt(D))
    c = torch.tensor(scale * np.float32(np.log2(np.e)))
    l2 = (lse.float() * float(np.float32(np.log2(np.e)))).reshape(
        Bq, Hq, Tq, 1)
    dsum = fa._dsum(o, do).reshape(Bq, Hq, Tq, 1)
    keep = fa._keep(Tq, Tk, q.device)
    bf = torch.bfloat16

    def partials(x, y, rows, cols):
        return [torch.einsum("bqhd,bkhd->bhqk", x[:, rows, :, hf],
                             y[:, cols, :, hf]) for hf in halves]

    def tile(rows, cols, rank):
        """P and dS of a tile as the block of `rank` forms them."""
        s, dp = partials(qf, kf, rows, cols), partials(dof, vf, rows, cols)
        if own_order and rank == 1:
            s, dp = s[::-1], dp[::-1]
        p = torch.exp2(_fma(s[0], c, _fma(s[1], c, -l2[:, :, rows])))
        if causal:
            p = p.masked_fill(~keep[rows][:, cols], 0.0)
        return p, p * (dp[0] + (dp[1] - dsum[:, :, rows]))

    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for rank, hf in enumerate(halves):
        part = [torch.zeros_like(qf[..., hf]) for _ in range(2)]
        for j in range(0, Tk, 32):
            cols = slice(j, j + 32)
            _, ds = tile(slice(0, Tq), cols, rank)
            part[j // 32 % 2] += torch.einsum(
                "bhqk,bkhd->bqhd", ds.to(bf).float(), kf[:, cols, :, hf])
        dq[..., hf] = part[0] + part[1]
        for i in range(0, Tq, 32):
            rows = slice(i, i + 32)
            p, ds = tile(rows, slice(0, Tk), rank)
            dv[..., hf] += torch.einsum("bhqk,bqhd->bkhd", p.to(bf).float(),
                                        dof[:, rows, :, hf])
            dk[..., hf] += torch.einsum("bhqk,bqhd->bkhd", ds.to(bf).float(),
                                        qf[:, rows, :, hf])
    return (dq * scale).to(bf), (dk * scale).to(bf), dv.to(bf)


@pytest.mark.parametrize("Dh", [384, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_cluster_backward_emulation_matches_jax(Dh, causal):
    """The arithmetic of the bf16 backward kernels at D = 384 and 512
    (`_cluster_bwd_emulated`: partial scores over the two column halves
    added in rank order, the log2 domain, P and dS rounded to nearest
    bf16, the kernels' tile order) against the JAX package's backward in
    bf16 (`jax.grad` of the Pallas flash attention in interpret mode,
    blocks of 128) on the same bf16 inputs (B=1, T=256, H=2): dQ, dK and
    dV row by row within `fa.error_in_tolerances` (2^-6 of a row's
    scale)."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(70 + Dh + causal, (1, T, 2, Dh)))
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (q, k, v, do))

    def jf(a, b, c):
        return jflash(a, b, c, causal=causal, block_q=128, block_k=128,
                      interpret=True)

    jgrads = jax.grad(lambda a, b, c: jnp.sum(
        jf(a, b, c).astype(jnp.float32) * jdo.astype(jnp.float32)),
        argnums=(0, 1, 2))(jq, jk, jv)
    o, lse = fa.flash_attention_plain_fwd(q, k, v, causal)
    got = _cluster_bwd_emulated(q, k, v, do, o, lse, causal)
    for name, g, want in zip(("dQ", "dK", "dV"), got, jgrads):
        ref = torch.from_numpy(np.array(want.astype(jnp.float32)))
        assert fa.error_in_tolerances(name, g, ref, torch.bfloat16) <= 1.0, \
            name


@pytest.mark.parametrize("Dh", [384, 512])
def test_cluster_halves_case_tells_an_order_fault(Dh):
    """What the card check's halves case (`chip_smoke.
    flash_halves_inputs`) rests on: with the column halves of q, k and dO
    equal (v's differ, so the two blocks' partial dP differ), a cluster
    whose blocks add the partials in one order gives dQ, dK and dV with
    bit-identical halves (each block forms the same P and dS, and its
    half of K, Q or dO is the other's), and one whose block of rank 1 adds
    them in its own order does not, in at least one output."""
    q, k, v, do = _chip_smoke().flash_halves_inputs(torch, 1, 256, 2, Dh,
                                                    device="cpu")
    o, lse = fa.flash_attention_plain_fwd(q, k, v, True)
    h = Dh // 2
    same = [torch.equal(g[..., :h], g[..., h:])
            for g in _cluster_bwd_emulated(q, k, v, do, o, lse, True)]
    assert all(same), same
    fault = [torch.equal(g[..., :h], g[..., h:])
             for g in _cluster_bwd_emulated(q, k, v, do, o, lse, True,
                                            own_order=True)]
    assert not all(fault), fault


@pytest.mark.parametrize("Dh", [256, 384, 512])
def test_ds_rounding_case_tells_a_truncated_ds(Dh):
    """What the card check's dS-rounding case (`chip_smoke.
    flash_ds_rounding_inputs`) rests on: every score is 0, so P = 1/128;
    every dS lies at least a fifth of a bf16 unit from a rounding
    midpoint; the plain backward on the bf16 tensors (dS rounded to
    nearest bf16 before its products) and the same arithmetic with dS
    truncated to bf16 differ by more than 16 bf16 tolerances in dQ
    (head 0) and in dK (head 1); and the kernels' arithmetic
    (`_wide_bwd_emulated` at D = 256, `_cluster_bwd_emulated` at 384 and
    512) gives the plain backward's outputs exactly."""
    q, k, v, do = _chip_smoke().flash_ds_rounding_inputs(torch, Dh,
                                                         device="cpu")
    dt = torch.bfloat16
    o, lse = fa.flash_attention_plain_fwd(q, k, v)
    s = fa._scores(q.float(), k.float(), False, 1.0 / np.sqrt(Dh))
    assert bool((s == 0).all())
    p = torch.exp(s - lse.reshape(1, 2, -1, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    dsum = fa._dsum(o, do).reshape(1, 2, -1, 1)
    ds = p * (dp - dsum)
    ulp = 2.0 ** (torch.floor(torch.log2(ds.abs())) - 7)  # a bf16 unit
    frac = ds.abs() / ulp
    assert bool(((frac - frac.floor() - 0.5).abs() >= 0.2).all())
    ref = fa.flash_attention_plain_bwd(q, k, v, o, lse, do)
    trunc = (ds.view(torch.int32) & ~0xFFFF).view(torch.float32)
    scale = 1.0 / np.sqrt(Dh)
    dq = torch.einsum("bhqk,bkhd->bqhd", trunc, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", trunc, q.float()) * scale
    assert fa.error_in_tolerances("dQ", dq[:, :, :1].to(dt),
                                  ref[0][:, :, :1], dt) > 16.0
    assert fa.error_in_tolerances("dK", dk[:, :, 1:].to(dt),
                                  ref[1][:, :, 1:], dt) > 16.0
    emulated = _wide_bwd_emulated if Dh == 256 else _cluster_bwd_emulated
    for got, want in zip(emulated(q, k, v, do, o, lse, False), ref):
        assert torch.equal(got, want)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_match_plain(dtype):
    """O, L, dQ, dK, dV of the kernels against the plain versions in f32
    on the same (cast up) inputs, causal and not, D = 128, 256, 384 and
    512, within `fa.error_in_tolerances` (O, dQ, dK, dV row by row, L
    absolute). One launch of each kernel per call."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    for Dh in (128, 256, 384, 512):
        for causal in (False, True):
            q, k, v, do = (torch.randn((2, 512, 2, Dh), generator=g,
                                       device="cuda").to(dt)
                           for _ in range(4))
            fa.reset_counts()
            o, lse = fa.flash_forward(q, k, v, causal, None, with_lse=True)
            dsum = fa._dsum(o, do)
            dq = fa.flash_bwd_dq(q, k, v, do, lse, dsum, causal, None)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, dsum, causal, None)
            torch.cuda.synchronize()
            assert (fa.flash_forward.launches, fa.flash_bwd_dq.launches,
                    fa.flash_bwd_dkv.launches) == (1, 1, 1)
            ro, rl = fa.flash_attention_plain_fwd(q.float(), k.float(),
                                                  v.float(), causal)
            # the backward on its own inputs: the forward kernel's O and L
            ref = (ro, rl) + fa.flash_attention_plain_bwd(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                causal)
            for name, got, want in zip(("O", "L", "dQ", "dK", "dV"),
                                       (o, lse, dq, dk, dv), ref):
                assert fa.error_in_tolerances(name, got, want, dt) <= 1.0


@pytest.mark.gpu
def test_wgmma_forward_on_qkv_slices_and_cross_lengths():
    """The bf16 D=128 forward (wgmma, TMA) against the plain version in
    f32: on q, k, v sliced from one fused qkv tensor (read through their
    strides, uncopied), causal; and with Tq != Tk, non-causal."""
    _card()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    qkv = torch.randn((2, 1024, 3 * 4 * 128), generator=g,
                      device="cuda").to(dt)
    q, k, v = (qkv[..., i * 512:(i + 1) * 512].reshape(2, 1024, 4, 128)
               for i in range(3))
    assert fa._kernel_ready(q) is q
    kq = torch.randn((2, 256, 4, 128), generator=g, device="cuda").to(dt)
    for qq, kk, vv, causal in ((q, k, v, True), (kq, k, v, False)):
        o, lse = fa.flash_forward(qq, kk, vv, causal, None, with_lse=True)
        ro, rl = fa.flash_attention_plain_fwd(qq.float(), kk.float(),
                                              vv.float(), causal)
        torch.cuda.synchronize()
        assert fa.error_in_tolerances("O", o, ro, dt) <= 1.0
        assert fa.error_in_tolerances("L", lse, rl, dt) <= 1.0


@pytest.mark.gpu
def test_wgmma_backward_cases_and_bits():
    """The bf16 D=128 backward kernels (wgmma, TMA) against the plain
    backward in f32 on the forward kernel's O and L, row by row within
    `fa.error_in_tolerances`: T=128 causal (a dQ block's only tile pair
    and a dK/dV block's diagonal tile alone), T=4096 causal (the far
    tiles), Tq=512 x Tk=1024 non-causal, and q, k, v sliced from one
    fused qkv tensor (read in place); each call twice, with identical
    bits (no atomics)."""
    _card()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(21)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(dt)
    qkv = r(2, 1024, 3 * 4 * 128)
    fused = [qkv[..., i * 512:(i + 1) * 512].reshape(2, 1024, 4, 128)
             for i in range(3)] + [r(2, 1024, 4, 128)]
    assert fa._kernel_ready(fused[0]) is fused[0]
    cases = [([r(1, 128, 2, 128) for _ in range(4)], True),
             ([r(1, 4096, 2, 128) for _ in range(4)], True),
             ([r(2, 512, 2, 128), r(2, 1024, 2, 128), r(2, 1024, 2, 128),
               r(2, 512, 2, 128)], False),
             (fused, True)]
    for (q, k, v, do), causal in cases:
        o, lse = fa.flash_forward(q, k, v, causal, None, with_lse=True)
        dsum = fa._dsum(o, do)
        runs = [(fa.flash_bwd_dq(q, k, v, do, lse, dsum, causal, None),)
                + fa.flash_bwd_dkv(q, k, v, do, lse, dsum, causal, None)
                for _ in range(2)]
        ref = fa.flash_attention_plain_bwd(q.float(), k.float(), v.float(),
                                           o.float(), lse, do.float(),
                                           causal)
        torch.cuda.synchronize()
        for name, a, b, want in zip(("dQ", "dK", "dV"), runs[0], runs[1],
                                    ref):
            assert torch.equal(a, b), name
            assert fa.error_in_tolerances(name, a, want, dt) <= 1.0, name


@pytest.mark.gpu
def test_tf32_kernels_cases_and_bits():
    """The f32 kernels at D=128 (split TF32 on the tensor cores, by their
    route counts) against the plain versions in f32, row by row within
    `fa.error_in_tolerances`: full and causal at T=512, Tq=512 x Tk=1024
    non-causal, and q, k, v sliced from one fused qkv tensor (read in
    place), causal; each backward twice, with identical bits."""
    _card()
    dt = torch.float32
    g = torch.Generator(device="cuda").manual_seed(31)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    qkv = r(2, 1024, 3 * 4 * 128)
    fused = [qkv[..., i * 512:(i + 1) * 512].reshape(2, 1024, 4, 128)
             for i in range(3)] + [r(2, 1024, 4, 128)]
    assert fa._kernel_ready(fused[0]) is fused[0]
    square = [r(2, 512, 2, 128) for _ in range(4)]
    cases = [(square, False), (square, True),
             ([r(2, 512, 2, 128), r(2, 1024, 2, 128), r(2, 1024, 2, 128),
               r(2, 512, 2, 128)], False),
             (fused, True)]
    for (q, k, v, do), causal in cases:
        fa.reset_counts()
        o, lse = fa.flash_forward(q, k, v, causal, None, with_lse=True)
        dsum = fa._dsum(o, do)
        runs = [(fa.flash_bwd_dq(q, k, v, do, lse, dsum, causal, None),)
                + fa.flash_bwd_dkv(q, k, v, do, lse, dsum, causal, None)
                for _ in range(2)]
        assert fa.launches_by_route == {("fwd", "tf32"): 1, ("dq", "tf32"): 2,
                                        ("dkv", "tf32"): 2}
        ro, rl = fa.flash_attention_plain_fwd(q, k, v, causal)
        ref = fa.flash_attention_plain_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        assert fa.error_in_tolerances("O", o, ro, dt) <= 1.0
        assert fa.error_in_tolerances("L", lse, rl, dt) <= 1.0
        for name, a, b, want in zip(("dQ", "dK", "dV"), runs[0], runs[1],
                                    ref):
            assert torch.equal(a, b), name
            assert fa.error_in_tolerances(name, a, want, dt) <= 1.0, name


@pytest.mark.gpu
def test_f32_wide_head_backward_cases_and_bits():
    """The f32 forward, dQ and dK/dV at D = 256, 384 and 512 (split-TF32
    clusters of D / 128 blocks, by their route counts; shared memory
    within the card's limit) against the plain versions in f32 (the
    backward on the forward kernel's O and L), row by row within
    `fa.error_in_tolerances`: T = 512 and 2048, causal and full, Tq=512 x
    Tk=1024 full, and q, k, v sliced from one fused qkv tensor; each
    backward twice, with identical bits. On inputs whose 128-column slices
    of q, k and dO repeat, each backward output's slices are
    bit-identical, and on inputs whose v slices repeat, O's are (every
    block of a cluster sums the partial scores in the same order)."""
    _card()
    from deeplearning4j_tpu_torch.ops.kernel_dispatch import smem_limit_bytes

    g = torch.Generator(device="cuda").manual_seed(41)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    lib = fa._library()
    cs = _chip_smoke()
    for Dh in (256, 384, 512):
        for kind in (0, 1, 2):
            assert lib.dl4j_flash_route(kind, 0, Dh) == 0  # "tf32 cluster"
            assert lib.dl4j_flash_smem_bytes(kind, 0, Dh) <= \
                smem_limit_bytes(torch.device("cuda"))
        qkv = r(1, 1024, 3 * 2 * Dh)
        fused = [qkv[..., i * 2 * Dh:(i + 1) * 2 * Dh].reshape(1, 1024, 2, Dh)
                 for i in range(3)] + [r(1, 1024, 2, Dh)]
        assert fa._kernel_ready(fused[0]) is fused[0]
        one = [r(1, 512, 2, 128) for _ in range(3)]
        sliced = [x.repeat(1, 1, 1, Dh // 128) for x in one]
        sliced.insert(2, r(1, 512, 2, Dh))  # q, k, v, dO: v's slices differ
        cases = [([r(1, T, 2, Dh) for _ in range(4)], causal)
                 for T in (512, 2048) for causal in (False, True)]
        v_sliced = list(cs.flash_fwd_sliced_inputs(torch, 1, 512, 2, Dh,
                                                   seed=Dh))
        cases += [([r(1, 512, 2, Dh), r(1, 1024, 2, Dh), r(1, 1024, 2, Dh),
                    r(1, 512, 2, Dh)], False),
                  (fused, True), (sliced, False), (sliced, True),
                  (v_sliced, False), (v_sliced, True)]
        for i, ((q, k, v, do), causal) in enumerate(cases):
            fa.reset_counts()
            o, lse = fa.flash_forward(q, k, v, causal, None, with_lse=True)
            dsum = fa._dsum(o, do)
            runs = [(fa.flash_bwd_dq(q, k, v, do, lse, dsum, causal, None),)
                    + fa.flash_bwd_dkv(q, k, v, do, lse, dsum, causal, None)
                    for _ in range(2)]
            assert fa.launches_by_route == {
                ("fwd", "tf32 cluster"): 1, ("dq", "tf32 cluster"): 2,
                ("dkv", "tf32 cluster"): 2}
            ro, rl = fa.flash_attention_plain_fwd(q, k, v, causal)
            ref = fa.flash_attention_plain_bwd(q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            assert fa.error_in_tolerances("O", o, ro,
                                          torch.float32) <= 1.0, (Dh, i)
            assert fa.error_in_tolerances("L", lse, rl,
                                          torch.float32) <= 1.0, (Dh, i)
            if v is v_sliced[2]:
                for c in range(128, Dh, 128):
                    assert torch.equal(o[..., :128],
                                       o[..., c:c + 128]), (Dh, i)
            for name, a, b, want in zip(("dQ", "dK", "dV"), runs[0], runs[1],
                                        ref):
                assert torch.equal(a, b), (Dh, i, name)
                assert fa.error_in_tolerances(name, a, want,
                                              torch.float32) <= 1.0, (Dh, i,
                                                                      name)
                if q is sliced[0]:
                    for c in range(128, Dh, 128):
                        assert torch.equal(a[..., :128],
                                           a[..., c:c + 128]), (Dh, i, name)


@pytest.mark.gpu
def test_wide_forward_cases_halves_and_routes():
    """The bf16 forward at D = 256, 384 and 512 (route "wgmma wide": two
    consumer warpgroups that split D; the backward takes "wgmma wide" at
    D = 256 and "wgmma cluster" at 384 and 512; shared memory within the
    card's limit) against the plain
    forward in f32, O row by row and L within `fa.error_in_tolerances`:
    causal at T = 128 and 192 (the first 64-row tiles, whose diagonal
    crosses two 32-key tiles at D = 384 and 512) and 2048, full with
    Tq=512 x Tk=1024, q, k, v sliced from one fused qkv tensor, and with
    v's column halves equal, where O's halves are bit-identical (both
    warpgroups form the same P)."""
    _card()
    from deeplearning4j_tpu_torch.ops.kernel_dispatch import smem_limit_bytes

    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(51)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(dt)
    lib = fa._library()
    for Dh in (256, 384, 512):
        assert fa.ROUTES[lib.dl4j_flash_route(0, 1, Dh)] == "wgmma wide"
        assert fa.ROUTES[lib.dl4j_flash_route(1, 1, Dh)] == (
            "wgmma wide" if Dh == 256 else "wgmma cluster")
        assert lib.dl4j_flash_smem_bytes(0, 1, Dh) <= \
            smem_limit_bytes(torch.device("cuda"))
        qkv = r(1, 1024, 3 * 2 * Dh)
        fused = [qkv[..., i * 2 * Dh:(i + 1) * 2 * Dh].reshape(1, 1024, 2, Dh)
                 for i in range(3)]
        assert fa._kernel_ready(fused[0]) is fused[0]
        halves = [r(1, 512, 2, Dh), r(1, 512, 2, Dh),
                  r(1, 512, 2, Dh // 2).repeat(1, 1, 1, 2)]
        cases = [([r(1, T, 2, Dh) for _ in range(3)], True)
                 for T in (128, 192, 2048)]
        cases += [([r(2, 512, 2, Dh), r(2, 1024, 2, Dh), r(2, 1024, 2, Dh)],
                   False), (fused, True), (halves, True)]
        for i, ((q, k, v), causal) in enumerate(cases):
            fa.reset_counts()
            o, lse = fa.flash_forward(q, k, v, causal, None, with_lse=True)
            assert fa.launches_by_route == {("fwd", "wgmma wide"): 1}
            ro, rl = fa.flash_attention_plain_fwd(q.float(), k.float(),
                                                  v.float(), causal)
            torch.cuda.synchronize()
            assert fa.error_in_tolerances("O", o, ro, dt) <= 1.0, (Dh, i)
            assert fa.error_in_tolerances("L", lse, rl, dt) <= 1.0, (Dh, i)
            if v is halves[2]:
                assert torch.equal(o[..., :Dh // 2], o[..., Dh // 2:]), Dh


@pytest.mark.gpu
def test_wide_backward_cases_bits_and_routes():
    """The bf16 backward at D = 256 (route "wgmma wide" for dQ and dK/dV)
    and at D = 384 and 512 ("wgmma cluster": clusters of two blocks, one
    column half each, whose partial scores meet in distributed shared
    memory; shared memory within the card's limit) against the plain
    backward in f32 on the forward kernel's O and L, row by row within
    `fa.error_in_tolerances`: causal at T = 64 (D = 256: one block alone),
    128 and 192 (the first diagonal tiles) and 2048, full at T = 192,
    Tq=512 x Tk=1024 full, and q, k, v sliced from one fused qkv tensor;
    each call twice, with identical bits (no atomics); at D = 384 and 512
    on `chip_smoke.flash_halves_inputs` dQ, dK and dV have bit-identical
    column halves (both blocks of a cluster form the same P and dS); on
    `chip_smoke.flash_ds_rounding_inputs` dQ and dK equal the plain
    backward on the bf16 tensors (dS rounded to nearest bf16)."""
    _card()
    from deeplearning4j_tpu_torch.ops.kernel_dispatch import smem_limit_bytes

    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(61)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(dt)
    lib = fa._library()
    cs = _chip_smoke()
    for Dh in (256, 384, 512):
        route = "wgmma wide" if Dh == 256 else "wgmma cluster"
        for kind in (1, 2):
            assert fa.ROUTES[lib.dl4j_flash_route(kind, 1, Dh)] == route
            assert lib.dl4j_flash_smem_bytes(kind, 1, Dh) <= \
                smem_limit_bytes(torch.device("cuda"))
        qkv = r(1, 1024, 3 * 2 * Dh)
        fused = [qkv[..., i * 2 * Dh:(i + 1) * 2 * Dh].reshape(1, 1024, 2,
                                                               Dh)
                 for i in range(3)] + [r(1, 1024, 2, Dh)]
        assert fa._kernel_ready(fused[0]) is fused[0]
        halves = cs.flash_halves_inputs(torch, 1, 512, 2, Dh, seed=Dh)
        cases = [([r(1, T, 2, Dh) for _ in range(4)], True)
                 for T in ((64, 128, 192, 2048) if Dh == 256
                           else (128, 192, 2048))]
        cases += [([r(1, 192, 2, Dh) for _ in range(4)], False),
                  ([r(2, 512, 2, Dh), r(2, 1024, 2, Dh), r(2, 1024, 2, Dh),
                    r(2, 512, 2, Dh)], False),
                  (fused, True)]
        if Dh > 256:
            cases += [(halves, False), (halves, True)]
        for i, ((q, k, v, do), causal) in enumerate(cases):
            fa.reset_counts()
            o, lse = fa.flash_forward(q, k, v, causal, None, with_lse=True)
            dsum = fa._dsum(o, do)
            runs = [(fa.flash_bwd_dq(q, k, v, do, lse, dsum, causal, None),)
                    + fa.flash_bwd_dkv(q, k, v, do, lse, dsum, causal, None)
                    for _ in range(2)]
            assert fa.launches_by_route == {("fwd", "wgmma wide"): 1,
                                            ("dq", route): 2,
                                            ("dkv", route): 2}
            ref = fa.flash_attention_plain_bwd(q.float(), k.float(),
                                               v.float(), o.float(), lse,
                                               do.float(), causal)
            torch.cuda.synchronize()
            for name, a, b, want in zip(("dQ", "dK", "dV"), runs[0], runs[1],
                                        ref):
                assert torch.equal(a, b), (Dh, i, name)
                assert fa.error_in_tolerances(name, a, want, dt) <= 1.0, \
                    (Dh, i, name)
                if q is halves[0]:
                    assert torch.equal(a[..., :Dh // 2],
                                       a[..., Dh // 2:]), (Dh, i, name)
        q, k, v, do = cs.flash_ds_rounding_inputs(torch, Dh)
        o, lse = fa.flash_forward(q, k, v, False, None, with_lse=True)
        dsum = fa._dsum(o, do)
        got = (fa.flash_bwd_dq(q, k, v, do, lse, dsum, False, None),) + \
            fa.flash_bwd_dkv(q, k, v, do, lse, dsum, False, None)
        ref = fa.flash_attention_plain_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        for name, a, want in zip(("dQ", "dK", "dV"), got, ref):
            assert torch.equal(a, want), (Dh, name)
