"""Scaled-dot-product attention primitives (counterpart of
`deeplearning4j_tpu/ops/attention.py`).

Layouts are the JAX package's: q/k/v (B, T, H, D) for whole-sequence
attention; the decode layouts K (B, Hkv, D, L) and V (B, Hkv, L, D) for
cached attention; the paged pools K (P+1, Hkv, D, page) and
V (P+1, Hkv, page, D), page 0 the trash page, for paged attention.

`multi_head_attention` is the layers' entry to whole-sequence attention
and decides its route from shape and mask alone (ring attention inside a
`sequence_parallel_scope`), as the JAX package does: flash attention (`ops/flash_attention.py`) for unmasked sequences
longer than `block_size` that its kernels take, blockwise attention for
the other long sequences, full attention otherwise. The `*_auto`
functions are the serving path's entry to paged attention. Both dispatch
on the tensors' device, with no probe and no fallback: a CPU tensor runs
the plain PyTorch version, a CUDA tensor launches the hand-written
kernel or raises.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp()/where() NaN-free


def _round_bf16(x: np.float32) -> float:
    """`x` rounded to bfloat16 (to nearest, ties to even), as a float."""
    b = int(np.array([x], np.float32).view(np.uint32)[0])
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return float(np.array([b], np.uint32).view(np.float32)[0])


def _sqrt_d(d: int, dtype: torch.dtype) -> float:
    """sqrt(d) rounded to `dtype`, as the JAX package divides by
    `jnp.sqrt(jnp.asarray(d, q.dtype))`: the correctly rounded square
    root (numpy's; torch's CPU square root is not correctly rounded at
    every d, and this runs on the host for every attention call, slot
    threads included), bf16 and f16 through f32 as XLA computes them."""
    if dtype == torch.float64:
        return math.sqrt(d)
    if dtype == torch.float16:
        return float(np.sqrt(np.float16(d)))
    if dtype == torch.bfloat16:
        return _round_bf16(np.sqrt(np.float32(_round_bf16(np.float32(d)))))
    return float(np.sqrt(np.float32(d)))


def _causal_keep(Tq: int, Tk: int, device) -> torch.Tensor:
    iq = torch.arange(Tq, device=device)[:, None]
    ik = torch.arange(Tk, device=device)[None, :]
    return ik <= iq + (Tk - Tq)


def full_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                   causal: bool = False) -> torch.Tensor:
    """Plain softmax(QK^T/sqrt(d) + bias) V. q/k/v: (B, T, H, D); bias
    broadcastable to (B, H, Tq, Tk). Fully masked rows give 0."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / _sqrt_d(d, q.dtype)
    if bias is not None:
        s = s + bias.to(s.dtype)
    if causal:
        keep = _causal_keep(s.shape[-2], s.shape[-1], s.device)
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def full_attention_grouped(q, k, v, bias: Optional[torch.Tensor] = None,
                           causal: bool = False) -> torch.Tensor:
    """`full_attention` for grouped-query attention without repeating
    K/V: q (B, T, H, D) against k/v with Hkv heads (query head j reads
    KV head j // (H/Hkv))."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Tq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / _sqrt_d(D, q.dtype)
    if bias is not None:
        if bias.ndim == 4 and bias.shape[1] == H:
            bias = bias.reshape(B, Hkv, G, *bias.shape[2:])
        else:  # broadcasting head axis (a key-mask bias): keep it 1-wide
            bias = bias[:, :, None]
        s = s + bias.to(s.dtype)
    if causal:
        s = s.masked_fill(~_causal_keep(Tq, Tk, s.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    att = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return att.reshape(B, Tq, H, D)


def mask_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """(B, Tk) 1=valid key mask -> additive (B, 1, 1, Tk) attention bias."""
    keep = key_mask[:, None, None, :] > 0
    return torch.where(keep, 0.0, NEG_INF).to(
        key_mask.dtype if key_mask.is_floating_point() else torch.float32)


def attention_block_accum(carry, q, k, v, bias: Optional[torch.Tensor]):
    """One online-softmax step against a KV block. carry = (o, l, m): the
    running unnormalised output (B, Tq, H, D), softmax denominator
    (B, H, Tq) and row max (B, H, Tq); the attention output is o / l."""
    o, l, m = carry
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / _sqrt_d(d, q.dtype)
    if bias is not None:
        s = s + bias.to(s.dtype)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    # rows masked so far sit at m ~ NEG_INF: zero their weights so l stays
    # 0 and attention_finalize maps them to 0
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] \
        + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o_new, l_new, m_new


def _accum_init(q):
    B, Tq, H, D = q.shape
    o = torch.zeros((B, Tq, H, D), dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=q.dtype, device=q.device)
    m = torch.full((B, H, Tq), NEG_INF, dtype=q.dtype, device=q.device)
    return o, l, m


def attention_finalize(o, l):
    """o / l with fully-masked rows (l == 0) mapped to 0, not NaN."""
    l_t = l.transpose(1, 2)[..., None]
    return torch.where(l_t > 0, o / torch.where(l_t > 0, l_t, 1.0), 0.0)


def blockwise_attention(q, k, v, *, causal: bool = False,
                        key_mask: Optional[torch.Tensor] = None,
                        block_size: int = 512) -> torch.Tensor:
    """Exact attention by the online-softmax recurrence over KV blocks of
    `block_size` (a Python loop where the JAX package scans): scores
    O(Tq * block) at a time. q/k/v (B, T, H, D); key_mask (B, Tk), 1 =
    valid. Tq != Tk aligns the queries to the end of the keys."""
    B, Tk, H, D = k.shape
    Tq = q.shape[1]
    blk = min(block_size, Tk)
    if key_mask is None:
        key_mask = torch.ones((B, Tk), dtype=q.dtype, device=q.device)
    if Tk % blk:  # pad keys to a block multiple; padded keys masked off
        pad = blk - Tk % blk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        key_mask = torch.nn.functional.pad(key_mask, (0, pad))
    iq = torch.arange(Tq, device=q.device)
    causal_off = Tk - Tq  # the unpadded Tk, as full_attention
    carry = _accum_init(q)
    for j in range(k.shape[1] // blk):
        sl = slice(j * blk, (j + 1) * blk)
        bias = mask_bias(key_mask[:, sl])
        if causal:
            ik = j * blk + torch.arange(blk, device=q.device)
            keep = ik[None, :] <= iq[:, None] + causal_off
            bias = bias + torch.where(keep, 0.0, NEG_INF).to(bias.dtype)
        carry = attention_block_accum(carry, q, k[:, sl], v[:, sl], bias)
    o, l, _ = carry
    return attention_finalize(o, l)


_SEQ_PARALLEL: list = []


@contextmanager
def sequence_parallel_scope(mesh, axis_name: str = "seq",
                            batch_axis: Optional[str] = None):
    """Within this scope `multi_head_attention` (so every attention layer
    run inside it) computes by ring attention with the time axis split
    over `axis_name` of `mesh` (`parallel.sequence.ring_attention`), as
    `SequenceParallelWrapper`'s steps do."""
    if mesh is None or axis_name not in getattr(mesh, "shape", {}):
        raise ValueError(f"sequence_parallel_scope needs a mesh with a "
                         f"{axis_name!r} axis, got {mesh!r}")
    _SEQ_PARALLEL.append((mesh, axis_name, batch_axis))
    try:
        yield
    finally:
        _SEQ_PARALLEL.pop()


def _flash_route(q, k, causal: bool) -> bool:
    """The JAX package's shape and dtype test for the flash kernels:
    T a multiple of 128 (the smallest tile of its ladder), D % 128 == 0,
    f32 or bf16, causal only with Tq == Tk."""
    Tq, D = q.shape[1], q.shape[3]
    Tk = k.shape[1]
    return (Tq % 128 == 0 and Tk % 128 == 0 and D % 128 == 0
            and q.dtype in (torch.float32, torch.bfloat16)
            and (not causal or Tq == Tk))


def multi_head_attention(q, k, v, *, causal=False, key_mask=None,
                         block_size: Optional[int] = None):
    """Whole-sequence attention for the layer forward. Inside a
    `sequence_parallel_scope` every call is ring attention over the
    scope's mesh. Otherwise long sequences (longer than `block_size`)
    with no key mask go to `flash_attention` when its shape test passes
    (the kernels on a CUDA tensor, the plain version on a CPU tensor),
    other long sequences to `blockwise_attention`, short ones to full
    attention.

    GQA: `k`/`v` may carry fewer heads than `q`. Full attention groups
    them; the ring, flash and blockwise routes widen them with
    `repeat_interleave`, and autograd sums dK/dV over each group."""
    H, Hkv = q.shape[2], k.shape[2]

    def widened():
        if Hkv == H:
            return k, v
        g = H // Hkv
        return (torch.repeat_interleave(k, g, dim=2),
                torch.repeat_interleave(v, g, dim=2))

    if _SEQ_PARALLEL:
        from deeplearning4j_tpu_torch.parallel.sequence import ring_attention

        kf, vf = widened()
        mesh, axis_name, batch_axis = _SEQ_PARALLEL[-1]
        return ring_attention(q, kf, vf, mesh, axis_name=axis_name,
                              causal=causal, key_mask=key_mask,
                              batch_axis=batch_axis)

    long_seq = block_size is not None and k.shape[1] > block_size
    if long_seq and key_mask is None and _flash_route(q, k, causal):
        from deeplearning4j_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        kf, vf = widened()
        return flash_attention(q, kf, vf, causal=causal)
    if long_seq:
        kf, vf = widened()
        return blockwise_attention(q, kf, vf, causal=causal,
                                   key_mask=key_mask, block_size=block_size)
    bias = None if key_mask is None else mask_bias(key_mask)
    if Hkv != H:
        return full_attention_grouped(q, k, v, bias=bias, causal=causal)
    return full_attention(q, k, v, bias=bias, causal=causal)


def cached_attention_step(q, k_cache, v_cache, pos) -> torch.Tensor:
    """One decode step against decode-layout caches.

    `q`: (B, H, D); `k_cache`: (B, Hkv, D, L); `v_cache`: (B, Hkv, L, D);
    `pos`: the position of the token being consumed, an int (every row)
    or a (B,) tensor (every slot its own). Entries past a row's `pos` are
    masked. Returns (B, H*D)."""
    B, Hkv, D, L = k_cache.shape
    H = q.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bkgd,bkdl->bkgl", qg, k_cache) / _sqrt_d(D, q.dtype)
    idx = torch.arange(L, device=s.device)
    if isinstance(pos, torch.Tensor) and pos.ndim:
        keep = idx[None, None, None, :] <= pos[:, None, None, None]
    else:
        keep = idx <= int(pos)
    s = s.masked_fill(~keep, float("-inf"))
    w = torch.softmax(s, dim=-1)
    att = torch.einsum("bkgl,bkld->bkgd", w, v_cache)
    return att.reshape(B, H * D)


def cached_attention_chunk_batched(q, k_cache, v_cache,
                                   q_pos) -> torch.Tensor:
    """`cached_attention_chunk` over a leading slot axis (the JAX
    package's `jax.vmap(cached_attention_chunk)`): q (S, C, H, D) at
    positions q_pos (S, C) against k (S, Hkv, D, L) / v (S, Hkv, L, D).
    Returns (S, C, H*D)."""
    S, Hkv, D, L = k_cache.shape
    C, H = q.shape[1], q.shape[2]
    G = H // Hkv
    qg = q.reshape(S, C, Hkv, G, D).permute(0, 2, 3, 1, 4)  # (S,Hkv,G,C,D)
    s = torch.einsum("skgcd,skdl->skgcl", qg, k_cache) / _sqrt_d(D, q.dtype)
    keep = (torch.arange(L, device=s.device)[None, None, None, None, :]
            <= q_pos[:, None, None, :, None])
    s = s.masked_fill(~keep, float("-inf"))
    w = torch.softmax(s, dim=-1)
    att = torch.einsum("skgcl,skld->skgcd", w, v_cache)  # (S,Hkv,G,C,D)
    return att.permute(0, 3, 1, 2, 4).reshape(S, C, H * D)


def cached_attention_chunk(q, k_cache, v_cache, q_pos) -> torch.Tensor:
    """Chunked-prefill attention for ONE slot: q (C, H, D) at absolute
    positions `q_pos` (C,) against that slot's cache k (Hkv, D, L) /
    v (Hkv, L, D), which already holds the chunk's own K/V. Returns
    (C, H*D)."""
    q_pos = torch.as_tensor(q_pos, device=q.device)
    return cached_attention_chunk_batched(q[None], k_cache[None],
                                          v_cache[None], q_pos[None])[0]


def paged_gather(k_pool, v_pool, page_table):
    """Reassemble per-slot dense decode-layout caches from a paged pool:
    (S, Hkv, D, n_pages*page) / (S, Hkv, n_pages*page, D), logical
    position p at index p."""
    P, Hkv, D, page = k_pool.shape
    S, n_pages = page_table.shape
    idx = page_table.long()
    k = k_pool[idx]                              # (S, n, Hkv, D, page)
    k = k.permute(0, 2, 3, 1, 4).reshape(S, Hkv, D, n_pages * page)
    v = v_pool[idx]                              # (S, n, Hkv, page, D)
    v = v.permute(0, 2, 1, 3, 4).reshape(S, Hkv, n_pages * page, D)
    return k, v


def paged_gather_quant(k_pool, v_pool, k_scale, v_scale, page_table,
                       dtype: torch.dtype = torch.float32):
    """`paged_gather` over int8 pools: gather the int8 pages and their
    per-(head, position) f32 scale pages (`k_scale`/`v_scale`:
    (P+1, Hkv, page), riding the same page table), dequantize in f32 and
    return dense caches rounded to `dtype`. int8 zeros (the trash page)
    dequantize to exactly 0.0 under any scale."""
    P, Hkv, D, page = k_pool.shape
    S, n_pages = page_table.shape
    L = n_pages * page
    idx = page_table.long()
    k = k_pool[idx].float() * k_scale[idx][:, :, :, None, :]
    k = k.permute(0, 2, 3, 1, 4).reshape(S, Hkv, D, L)
    v = v_pool[idx].float() * v_scale[idx][..., None]
    v = v.permute(0, 2, 1, 3, 4).reshape(S, Hkv, L, D)
    return k.to(dtype), v.to(dtype)


def paged_attention_step(q, k_pool, v_pool, page_table, pos) -> torch.Tensor:
    """One decode step against a paged pool: gather, then
    `cached_attention_step` on the dense view. Returns (S, H*D)."""
    k, v = paged_gather(k_pool, v_pool, page_table)
    return cached_attention_step(q, k, v, pos)


def _positions(pos, S: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor) and pos.ndim:
        return pos
    return torch.full((S,), int(pos), dtype=torch.int32, device=device)


def paged_attention_step_auto(q, k_pool, v_pool, page_table, pos,
                              active=None, k_scale=None,
                              v_scale=None) -> torch.Tensor:
    """Paged decode attention on the serving path: q (S, H, D), per-slot
    positions `pos` (S,) int32, optional `active` (S,) bool (False lanes
    give zeros). int8 pools pass their f32 scale pools as
    `k_scale`/`v_scale` ((P+1, Hkv, page)). A CUDA tensor goes to the
    CUDA kernel, a CPU tensor to its plain version. Returns (S, H*D)."""
    from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention

    S, H, D = q.shape
    out = paged_attention(q[:, None].contiguous(), k_pool, v_pool,
                          page_table, _positions(pos, S, q.device),
                          active=active, k_scale=k_scale, v_scale=v_scale)
    return out.reshape(S, H * D)


def paged_attention_chunk_auto(q, k_pool, v_pool, page_table, pos0,
                               active=None, k_scale=None,
                               v_scale=None) -> torch.Tensor:
    """Chunk-width paged attention (chunked prefill, speculative
    verify): q (S, C, H, D), C contiguous queries per slot from position
    `pos0[s]`; row c attends to entries <= pos0[s] + c. Dispatches and
    takes int8 pools like `paged_attention_step_auto`. Returns
    (S, C, H*D)."""
    from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention

    S, C, H, D = q.shape
    out = paged_attention(q.contiguous(), k_pool, v_pool, page_table,
                          _positions(pos0, S, q.device), active=active,
                          k_scale=k_scale, v_scale=v_scale)
    return out.reshape(S, C, H * D)
