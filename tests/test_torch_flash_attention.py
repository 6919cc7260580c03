"""The port's flash attention held against the JAX package on the CPU.

The plain forward and its autograd gradients (through `_FlashAttention`,
whose backward is the plain backward on CPU tensors) against the JAX
package's Pallas kernels in interpret mode and its blockwise attention,
at B=2, T=256, H=2, D=128, block 128, causal and non-causal, f32:
atol = rtol = 1e-5. `torch.autograd.gradcheck` of `_FlashAttention` in
f64 at a tiny shape. `multi_head_attention`'s routes: flash, blockwise
under a key mask, GQA, and the T > block_size case. The CUDA kernels run
only on the card: the `gpu`-marked test holds them to the plain versions
computed in f32 (`python -m pytest -m gpu tests/test_torch_*.py`).
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
    q = torch.zeros((1, 8, 1, 8))
    with patt.sequence_parallel_scope(mesh=None):
        with pytest.raises(NotImplementedError, match="A12"):
            patt.multi_head_attention(q, q, q)


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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_match_plain(dtype):
    """O, L, dQ, dK, dV of the kernels against the plain versions in f32
    on the same (cast up) inputs, causal and not, D = 128 and 256, within
    `fa.error_in_tolerances` (O, dQ, dK, dV row by row, L absolute). One
    launch of each kernel per call."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    for Dh in (128, 256):
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
