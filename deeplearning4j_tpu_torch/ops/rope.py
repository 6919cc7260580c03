"""Rotary position embeddings, rotate-half form (counterpart of
`deeplearning4j_tpu/ops/rope.py`).

Each head's feature pairs (x_a, x_b) rotate by angle pos * base^(-2a/hd),
computed in f32 and cast back to the input dtype. Keys enter the KV cache
already rotated at their absolute position; each decode step's query
rotates at the current position.
"""
from __future__ import annotations

import torch


def rope_angles(positions, head_dim: int, base: float = 10000.0,
                device=None):
    """cos/sin tables for `positions` (any shape P...): ((P..., hd/2) x 2),
    f32. `positions` may be a tensor (its device is used) or a Python
    int/sequence placed on `device`."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    half = head_dim // 2
    pos = torch.as_tensor(positions, device=device).to(torch.float32)
    inv = base ** (-torch.arange(half, dtype=torch.float32,
                                 device=pos.device) / half)
    ang = pos[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_rotate(x, cos, sin):
    """Rotate (..., T, H, hd) by per-position tables (..., T, hd/2), or a
    single position's (hd/2,) tables."""
    half = x.shape[-1] // 2
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    if cos.ndim == 1:            # single position: broadcast over heads
        c, s = cos, sin
    else:                        # (..., T, half) -> (..., T, 1, half)
        c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)
