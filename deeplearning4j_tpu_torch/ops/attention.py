"""Scaled-dot-product attention primitives (counterpart of
`deeplearning4j_tpu/ops/attention.py`).

Layouts are the JAX package's: q/k/v (B, T, H, D) for whole-sequence
attention; the decode layouts K (B, Hkv, D, L) and V (B, Hkv, L, D) for
cached attention; the paged pools K (P+1, Hkv, D, page) and
V (P+1, Hkv, page, D), page 0 the trash page, for paged attention.

The `*_auto` functions are the serving path's entry to paged attention.
They dispatch on the tensors' device, with no probe and no fallback: a
CPU tensor runs the plain PyTorch version, a CUDA tensor launches the
hand-written kernel (`ops/paged_attention.py`) or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp()/where() NaN-free


def _sqrt_d(d: int, dtype: torch.dtype) -> float:
    """sqrt(d) rounded to `dtype`, as the JAX package divides by
    `jnp.sqrt(jnp.asarray(d, q.dtype))`."""
    return float(torch.tensor(float(d), dtype=dtype).sqrt())


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


def multi_head_attention(q, k, v, *, causal=False,
                         block_size: Optional[int] = None):
    """Whole-sequence attention for the layer forward, unmasked. The port
    carries the full-attention branch of the JAX dispatch; sequences
    longer than `block_size` go to the flash-attention kernel in the JAX
    package, which arrives with the training slice."""
    if block_size is not None and k.shape[1] > block_size:
        raise NotImplementedError(
            f"sequence length {k.shape[1]} > block_size {block_size} needs "
            "the flash-attention kernel, which is not ported yet "
            "(ROADMAP: GPT training slice, kernel rows 2-4)")
    if k.shape[2] != q.shape[2]:
        return full_attention_grouped(q, k, v, causal=causal)
    return full_attention(q, k, v, causal=causal)


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


def paged_attention_step(q, k_pool, v_pool, page_table, pos) -> torch.Tensor:
    """One decode step against a paged pool: gather, then
    `cached_attention_step` on the dense view. Returns (S, H*D)."""
    k, v = paged_gather(k_pool, v_pool, page_table)
    return cached_attention_step(q, k, v, pos)


def _positions(pos, S: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor) and pos.ndim:
        return pos
    return torch.full((S,), int(pos), dtype=torch.int32, device=device)


def _no_int8(k_scale, v_scale):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV pools (k_scale/v_scale) are not ported yet "
            "(ROADMAP: kernel row 1q, with the quantize tier)")


def paged_attention_step_auto(q, k_pool, v_pool, page_table, pos,
                              active=None, k_scale=None,
                              v_scale=None) -> torch.Tensor:
    """Paged decode attention on the serving path: q (S, H, D), per-slot
    positions `pos` (S,) int32, optional `active` (S,) bool (False lanes
    give zeros). A CUDA tensor goes to the CUDA kernel, a CPU tensor to
    its plain version. Returns (S, H*D)."""
    from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention

    _no_int8(k_scale, v_scale)
    S, H, D = q.shape
    out = paged_attention(q[:, None].contiguous(), k_pool, v_pool,
                          page_table, _positions(pos, S, q.device),
                          active=active)
    return out.reshape(S, H * D)


def paged_attention_chunk_auto(q, k_pool, v_pool, page_table, pos0,
                               active=None, k_scale=None,
                               v_scale=None) -> torch.Tensor:
    """Chunk-width paged attention (chunked prefill): q (S, C, H, D),
    C contiguous queries per slot from position `pos0[s]`; row c attends
    to entries <= pos0[s] + c. Dispatches like
    `paged_attention_step_auto`. Returns (S, C, H*D)."""
    from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention

    _no_int8(k_scale, v_scale)
    S, C, H, D = q.shape
    out = paged_attention(q.contiguous(), k_pool, v_pool, page_table,
                          _positions(pos0, S, q.device), active=active)
    return out.reshape(S, C, H * D)
