"""Paged attention: the hand-written CUDA kernels, their wrapper, and
their plain PyTorch version.

Counterpart of `deeplearning4j_tpu/ops/pallas_paged_attention.py`: the
TPU kernel `_paged_kernel` becomes `csrc/paged_attention.cu` (route:
CUDA C++ for sm_90a, plain C interface, loaded with ctypes). The key axis
is walked in slices that never cross a page, split over blocks, the
partial results merged by a second kernel; a tensor-core kernel takes
bf16 prefill chunks, a split-TF32 tensor-core kernel f32 ones, a scalar
one decode and verify; all take dense pools of q's type and int8 pools
with f32 scale pools (the quantized KV tier). The source's header says how they are laid out,
where the dequantization goes and what bounds them; `plan` says which
kernel and split a call gets.

`paged_attention` is the one entry point. Given CUDA tensors it checks
them, allocates the output and launches the kernels on the current
stream, raising if a launch fails. Given CPU tensors it runs
`paged_attention_plain`: `paged_gather` (or `paged_gather_quant`)
followed by the `cached_attention_chunk` semantics of the JAX package's
CPU path, with inactive lanes zeroed so that kernel and plain agree on
every row. There is no probe, no fallback from the kernel to the plain
version and no switch to turn the kernel off.

Each function keeps a plain integer count: `paged_attention.launches`
(calls that launched the kernels; `launches_by` splits them by
`(C, kind)`, the chunk width and "dense" or "int8", `launches_by_route`
by `(C, route)`, `plan`'s route) and
`paged_attention_plain.calls`; `paged_attention.launches_by_slot` and
`paged_attention_plain.calls_by_slot` split them by the SPMD slot that
made the call (`parallel.spmd.current_slot()`, None outside a per-slot
body), so a tensor-parallel run shows each shard's launches. A run can
set them to 0 and read them after to show which path it took. Several
engines' scheduler threads call these functions at once (a replica pool
in one process), so every increment is made under `_COUNT_LOCK`: a bare
`+=` is a read, an add and a write that a thread switch can split,
losing counts.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.ops.attention import (
    cached_attention_chunk_batched,
    paged_gather,
    paged_gather_quant,
)
from deeplearning4j_tpu_torch.ops.kernel_dispatch import current_slot

# atol = rtol of the kernel against `paged_attention_plain` computed in f32
# on the same inputs (bf16 inputs cast up exactly). The kernel keeps scores,
# softmax state and accumulator in f32, so in bf16 it differs from that
# reference by the output's rounding (at most 2^-9 relative) and little else.
# The int8 kernel is held to the same numbers against the plain version that
# rounds the dequantized K/V to q's type, as the kernel does (`kv_dtype`).
TOLERANCE = {torch.float32: 2e-4, torch.bfloat16: 4e-3}

_COUNT_LOCK = threading.Lock()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODE = {"scalar": 0, "mma": 1, "tf32": 2}


def paged_attention_plain(q, k_pool, v_pool, page_table, positions,
                          active=None, k_scale=None, v_scale=None,
                          kv_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain PyTorch paged attention: q (S, C, H, hd) against the pools
    through `page_table`, row c of slot s attending to entries
    <= positions[s] + c; inactive lanes give zeros. int8 pools come with
    their scale pools and are dequantized by `paged_gather_quant`, the
    dequantized values rounded to `kv_dtype` (default: q's type, the
    JAX package's rounding point) before the products. Returns
    (S, C, H, hd) in q's dtype."""
    slot = current_slot()
    with _COUNT_LOCK:
        paged_attention_plain.calls += 1
        by = paged_attention_plain.calls_by_slot
        by[slot] = by.get(slot, 0) + 1
    S, C, H, hd = q.shape
    if k_scale is not None:
        kd, vd = paged_gather_quant(k_pool, v_pool, k_scale, v_scale,
                                    page_table, kv_dtype or q.dtype)
        kd, vd = kd.to(q.dtype), vd.to(q.dtype)
    else:
        kd, vd = paged_gather(k_pool, v_pool, page_table)
    qpos = positions.to(torch.int64)[:, None] \
        + torch.arange(C, device=q.device)[None, :]
    out = cached_attention_chunk_batched(q, kd, vd, qpos).reshape(q.shape)
    if active is not None:
        out = out * active.to(out.dtype)[:, None, None, None]
    return out


paged_attention_plain.calls = 0
paged_attention_plain.calls_by_slot = {}


class Plan(NamedTuple):
    """How a call is launched: `route` "mma" (the bf16 tensor-core
    kernel), "tf32" (the split-TF32 tensor-core kernel, f32 q) or
    "scalar"; `ks` keys per slice; `rows` query rows per tile; `tiles`
    row tiles per (slot, KV head); `splits` blocks that share a tile's
    keys, each a contiguous range of slices (1: no merge)."""
    route: str
    ks: int
    rows: int
    tiles: int
    splits: int


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _tile_rows(rows: int) -> int:
    """Rows of a scalar tile: `rows` rounded up to a power of two, at most
    16."""
    return min(16, 1 << (rows - 1).bit_length())


@functools.lru_cache(maxsize=256)
def plan(bf16: bool, int8: bool, S: int, C: int, H: int, Hkv: int, hd: int,
         page: int, n_pages: int, sms: int) -> Plan:
    """The launch of one call on a card of `sms` SMs, from its arguments
    alone. Pages of at least 64 positions, hd in (64, 128, 256) and at
    least 32 (c, g) rows per KV head (prefill chunks, wide GQA groups)
    take a tensor-core kernel in 64-row tiles, dense or int8 pools alike:
    bf16 q the bf16 one ("mma") in 64-key slices, f32 q the split-TF32
    one ("tf32") in 32-key slices (f32 slices of 32 keys keep two stages
    of K and V with the query tile within the shared memory of one block,
    216 KB at hd 256). The rest (decode, verify, narrow GQA groups, small
    pages) take the scalar kernel in tiles of up to 16 rows and slices of
    min(page, 64) keys, fewer where a slice of K would pass 32 KB. The
    keys are split so that the grid holds about 2 (tensor-core) or 8
    (scalar) blocks per SM, each split at least 4 (tensor-core) or 2
    (scalar) slices, at most 32 splits (one lane each in the merge): the
    scalar kernel's tiles are short, and its blocks walk their slices one
    after another."""
    rows = C * (H // Hkv)
    elem = 1 if int8 else 2 if bf16 else 4
    if page >= 64 and hd in (64, 128, 256) and rows >= 32:
        route, ks, tr, per_sm, least = "mma" if bf16 else "tf32", \
            64 if bf16 else 32, 64, 2, 4
    else:
        cap = 32768 // (hd * elem)
        route, ks, tr, per_sm, least = "scalar", min(
            page, 64, 1 << (cap.bit_length() - 1)), _tile_rows(rows), 8, 2
    tiles = -(-rows // tr)
    slices = n_pages * page // ks
    splits = max(1, min(-(-per_sm * sms // (S * Hkv * tiles)),
                        slices // least, 32))
    return Plan(route, ks, tr, tiles, splits)


def _check(q, k_pool, v_pool, page_table, positions, active, k_scale,
           v_scale):
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
    int8 = k_pool.dtype == torch.int8 or v_pool.dtype == torch.int8
    if int8 != (k_scale is not None) or int8 != (v_scale is not None):
        raise ValueError("int8 pools need both k_scale and v_scale, and "
                         "pools of any other type take neither")
    if int8:
        if k_pool.dtype != v_pool.dtype:
            raise TypeError(f"int8 pools must both be int8, got "
                            f"{k_pool.dtype} / {v_pool.dtype}")
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != (P1, Hkv, page):
                raise ValueError(f"{name} must be (P+1, Hkv, page) = "
                                 f"{(P1, Hkv, page)}, got {tuple(sc.shape)}")
            if sc.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {sc.dtype}")
    return S, C, H, hd, Hkv, page, page_table.shape[1], int8


def paged_attention(q, k_pool, v_pool, page_table, positions, *,
                    active: Optional[torch.Tensor] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged attention for the decode step (C = 1), the speculative
    verify (C = k + 1) and chunked prefill (C = prefill_chunk). `q`:
    (S, C, H, hd) f32 or bf16; `k_pool`/`v_pool`: (P+1, Hkv, hd, page) /
    (P+1, Hkv, page, hd), of q's type, or int8 with `k_scale`/`v_scale`
    (P+1, Hkv, page) f32; `page_table`: (S, n_pages) int32; `positions`:
    (S,) int32; `active`: optional (S,) bool. Returns (S, C, H, hd) in
    q's dtype."""
    S, C, H, hd, Hkv, page, n_pages, int8 = _check(
        q, k_pool, v_pool, page_table, positions, active, k_scale, v_scale)
    tensors = [q, k_pool, v_pool, page_table, positions] \
        + [t for t in (active, k_scale, v_scale) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_plain(q, k_pool, v_pool, page_table,
                                     positions, active, k_scale, v_scale)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("paged_attention: all tensors must lie on one CUDA "
                         "device, or all on the CPU; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if q.dtype not in _DTYPE_CODE or not (
            int8 or (k_pool.dtype == q.dtype and v_pool.dtype == q.dtype)):
        raise TypeError(f"paged_attention kernel takes f32 or bf16 q and "
                        f"pools of the same type or int8, got {q.dtype} / "
                        f"{k_pool.dtype} / {v_pool.dtype}")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_table and positions must be int32")
    if active is not None and active.dtype != torch.bool:
        raise TypeError(f"active must be bool, got {active.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel takes contiguous tensors")
    # the kernels stage K and V rows with 16-byte copies
    if hd % 8 or (hd * k_pool.element_size()) % 16 or page & (page - 1):
        raise ValueError(
            f"paged_attention kernel takes hd a multiple of 8, hd*itemsize "
            f"a multiple of 16 bytes and a power-of-two page; got hd={hd}, "
            f"page={page}, pools {k_pool.dtype}")
    if any(t.data_ptr() % 16 for t in (k_pool, v_pool)):
        raise ValueError("paged_attention kernel takes pools that start on "
                         "a 16-byte boundary")
    lib = _library()
    from deeplearning4j_tpu_torch.ops.kernel_dispatch import smem_limit_bytes

    code = _DTYPE_CODE[q.dtype]
    p = plan(q.dtype == torch.bfloat16, int8, S, C, H, Hkv, hd, page,
             n_pages, torch.cuda.get_device_properties(
                 q.device).multi_processor_count)
    route = _ROUTE_CODE[p.route]
    smem = lib.dl4j_paged_attention_smem_bytes(code, int(int8), route,
                                               p.rows, hd, p.ks)
    limit = smem_limit_bytes(q.device)
    if smem > limit:
        raise ValueError(
            f"paged_attention kernel needs {smem} bytes of shared memory per "
            f"block at hd={hd}, page={page}, q {q.dtype}, pools "
            f"{k_pool.dtype} ({p}); the card allows {limit}")
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if p.splits > 1:
        rows = (p.splits, S, Hkv, C * (H // Hkv))
        part_acc = torch.empty(rows + (hd,), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(rows + (2,), dtype=torch.float32,
                              device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.dl4j_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), page_table.data_ptr(),
            positions.data_ptr(), _ptr(active), out.data_ptr(),
            _ptr(part_acc), _ptr(part_ml), code, int(int8), route, p.ks,
            p.splits, p.rows, S, C, H, Hkv, hd, page, n_pages,
            1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{rc} (S={S}, C={C}, H={H}, Hkv={Hkv}, hd={hd}, "
                           f"page={page}, pools {k_pool.dtype}, {p}, "
                           f"smem={smem})")
    _count_launch((C, "int8" if int8 else "dense"), p.route)
    return out


paged_attention.launches = 0
paged_attention.launches_by = {}
paged_attention.launches_by_route = {}
paged_attention.launches_by_slot = {}


def _count_launch(key, route: Optional[str] = None) -> None:
    """One launch of the kernels at `key` = (C, "dense" or "int8"), in
    the SPMD slot that made it, and (where given) on `plan`'s `route`."""
    slot = current_slot()
    with _COUNT_LOCK:
        paged_attention.launches += 1
        paged_attention.launches_by[key] = \
            paged_attention.launches_by.get(key, 0) + 1
        if route is not None:
            by_route = paged_attention.launches_by_route
            by_route[(key[0], route)] = by_route.get((key[0], route), 0) + 1
        by = paged_attention.launches_by_slot
        by[slot] = by.get(slot, 0) + 1


def _library() -> ctypes.CDLL:
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.load("paged_attention")
    fn = lib.dl4j_paged_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # q, pools, scales, page table, positions, active, out, partials;
        # dtype, int8, route, ks, splits, tile, S, C, H, Hkv, hd, page,
        # n_pages; scale; stream
        fn.argtypes = [vp] * 11 + [ci] * 13 + [ctypes.c_float, vp]
        fn.restype = ci
        sm = lib.dl4j_paged_attention_smem_bytes
        sm.argtypes = [ci] * 6
        sm.restype = ctypes.c_size_t
    return lib


def reset_counts() -> None:
    """Set the kernel's launch counts and the plain version's call count
    to 0."""
    with _COUNT_LOCK:
        paged_attention.launches = 0
        paged_attention.launches_by = {}
        paged_attention.launches_by_route = {}
        paged_attention.launches_by_slot = {}
        paged_attention_plain.calls = 0
        paged_attention_plain.calls_by_slot = {}
