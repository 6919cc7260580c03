"""Paged attention: the hand-written CUDA kernel, its wrapper, and its
plain PyTorch version.

Counterpart of `deeplearning4j_tpu/ops/pallas_paged_attention.py`: the
TPU kernel `_paged_kernel` becomes `csrc/paged_attention.cu` (route:
CUDA C++ for sm_90a, plain C interface, loaded with ctypes). The
source's header says how it is laid out and what bounds it.

`paged_attention` is the one entry point. Given CUDA tensors it checks
them, allocates the output and launches the kernel on the current
stream, raising if the launch fails. Given CPU tensors it runs
`paged_attention_plain`: `paged_gather` followed by the
`cached_attention_chunk` semantics of the JAX package's CPU path, with
inactive lanes zeroed so that kernel and plain agree on every row. There
is no probe, no fallback from the kernel to the plain version and no
switch to turn the kernel off.

Each function keeps a plain integer count: `paged_attention.launches`
(kernel launches, and `launches_by_chunk` keyed by the chunk width C)
and `paged_attention_plain.calls`. A run can set them to 0 and read them
after to show which path it took.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.attention import (
    cached_attention_chunk_batched,
    paged_gather,
)

# atol = rtol of the kernel against `paged_attention_plain` computed in f32
# on the same inputs (bf16 inputs cast up exactly). The kernel keeps scores,
# softmax state and accumulator in f32, so in bf16 it differs from that
# reference by the output's rounding (at most 2^-9 relative) and little else.
TOLERANCE = {torch.float32: 2e-4, torch.bfloat16: 4e-3}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_plain(q, k_pool, v_pool, page_table, positions,
                          active=None) -> torch.Tensor:
    """Plain PyTorch paged attention: q (S, C, H, hd) against the pools
    through `page_table`, row c of slot s attending to entries
    <= positions[s] + c; inactive lanes give zeros. Returns
    (S, C, H, hd) in q's dtype."""
    paged_attention_plain.calls += 1
    S, C, H, hd = q.shape
    kd, vd = paged_gather(k_pool, v_pool, page_table)
    qpos = positions.to(torch.int64)[:, None] \
        + torch.arange(C, device=q.device)[None, :]
    out = cached_attention_chunk_batched(q, kd, vd, qpos).reshape(q.shape)
    if active is not None:
        out = out * active.to(out.dtype)[:, None, None, None]
    return out


paged_attention_plain.calls = 0


def _check(q, k_pool, v_pool, page_table, positions, active):
    S, C, H, hd = q.shape
    if k_pool.ndim != 4 or v_pool.ndim != 4:
        raise ValueError("k_pool/v_pool must be (P+1, Hkv, hd, page) / "
                         "(P+1, Hkv, page, hd)")
    P1, Hkv, khd, page = k_pool.shape
    if khd != hd or tuple(v_pool.shape) != (P1, Hkv, page, hd):
        raise ValueError(
            f"pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)} do "
            f"not match q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if page_table.ndim != 2 or page_table.shape[0] != S:
        raise ValueError(f"page_table must be (S={S}, n_pages), got "
                         f"{tuple(page_table.shape)}")
    if tuple(positions.shape) != (S,):
        raise ValueError(f"positions must be (S={S},), got "
                         f"{tuple(positions.shape)}")
    if active is not None and tuple(active.shape) != (S,):
        raise ValueError(f"active must be (S={S},), got "
                         f"{tuple(active.shape)}")
    return S, C, H, hd, Hkv, page, page_table.shape[1]


def paged_attention(q, k_pool, v_pool, page_table, positions, *,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged attention for the decode step (C = 1) and chunked prefill
    (C = prefill_chunk). `q`: (S, C, H, hd); `k_pool`/`v_pool`:
    (P+1, Hkv, hd, page) / (P+1, Hkv, page, hd); `page_table`:
    (S, n_pages) int32; `positions`: (S,) int32; `active`: optional (S,)
    bool. Returns (S, C, H, hd) in q's dtype."""
    S, C, H, hd, Hkv, page, n_pages = _check(q, k_pool, v_pool, page_table,
                                             positions, active)
    tensors = [q, k_pool, v_pool, page_table, positions] \
        + ([] if active is None else [active])
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_plain(q, k_pool, v_pool, page_table,
                                     positions, active)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("paged_attention: all tensors must lie on one CUDA "
                         "device, or all on the CPU; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel takes f32 or bf16 q and "
                        f"pools of the same type, got {q.dtype} / "
                        f"{k_pool.dtype} / {v_pool.dtype}")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_table and positions must be int32")
    if active is not None and active.dtype != torch.bool:
        raise TypeError(f"active must be bool, got {active.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel takes contiguous tensors")
    if (hd * page * q.element_size()) % 16:
        raise ValueError(f"hd*page*itemsize = {hd * page * q.element_size()} "
                         "must be a multiple of 16 bytes (16-byte page loads)")
    lib = _library()
    from deeplearning4j_tpu_torch.ops.kernel_dispatch import smem_limit_bytes

    code = _DTYPE_CODE[q.dtype]
    smem = lib.dl4j_paged_attention_smem_bytes(code, C, H, Hkv, hd, page)
    limit = smem_limit_bytes(q.device)
    if smem > limit:
        raise ValueError(
            f"paged_attention kernel needs {smem} bytes of shared memory per "
            f"block at hd={hd}, page={page}, {q.dtype}; the card allows "
            f"{limit}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dl4j_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), positions.data_ptr(),
            None if active is None else active.data_ptr(), out.data_ptr(),
            code, S, C, H, Hkv, hd, page, n_pages,
            1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{rc} (S={S}, C={C}, H={H}, Hkv={Hkv}, hd={hd}, "
                           f"page={page}, smem={smem})")
    paged_attention.launches += 1
    paged_attention.launches_by_chunk[C] = \
        paged_attention.launches_by_chunk.get(C, 0) + 1
    return out


paged_attention.launches = 0
paged_attention.launches_by_chunk = {}


def _library() -> ctypes.CDLL:
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.load("paged_attention")
    fn = lib.dl4j_paged_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                       ci, ci, ctypes.c_float, vp]
        fn.restype = ci
        sm = lib.dl4j_paged_attention_smem_bytes
        sm.argtypes = [ci] * 6
        sm.restype = ctypes.c_size_t
    return lib


def reset_counts() -> None:
    """Set the kernel's launch counts and the plain version's call count
    to 0."""
    paged_attention.launches = 0
    paged_attention.launches_by_chunk = {}
    paged_attention_plain.calls = 0
