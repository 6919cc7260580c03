"""Flash attention: the hand-written CUDA kernels (forward with the row
logsumexp, dQ, dK/dV), their wrappers, their plain PyTorch versions and
the `torch.autograd.Function` that ties them together.

Counterpart of `deeplearning4j_tpu/ops/pallas_attention.py`: the TPU
kernels `_flash_fwd_kernel`, `_flash_bwd_dq_kernel` and
`_flash_bwd_dkv_kernel` become `csrc/flash_attention.cu` (route: CUDA C++
for sm_90a, plain C interface, loaded with ctypes). The source's header
says how it is laid out and what bounds it.

`flash_attention(q, k, v, causal=, sm_scale=)` is the entry point:
exact attention over (B, T, H, D) tensors with no key mask. Given CPU
tensors it runs the plain versions; given CUDA tensors it launches the
kernels or raises. There is no probe and no fallback. When a gradient is
needed the call goes through `_FlashAttention`, whose forward also keeps
the row logsumexp L (B*H, Tq) f32 for the backward; otherwise the forward
writes no L, as the JAX package's inference primal does.

In f32 (`MultiLayerNetwork`'s default precision) every kernel runs on the
tensor cores in split TF32: each operand is split into two TF32 parts and
every product takes three TF32 passes, which keeps f32 accuracy (the
reference's HIGHEST precision). The f32 backward at D = 384 and 512 runs
as thread block clusters of D / 128 blocks, one 128-column slice each,
which add their partial scores through distributed shared memory
(`cluster_plan` says how many such clusters fit on the card at once).
The bf16 forward at D = 256, 384 and 512 ("wgmma wide") splits D over two
warpgroups of one block, which add their partial scores through shared
memory; the bf16 backward at D = 256 ("wgmma wide" too) keeps accumulators
over all of D in each of two warpgroups, and at D = 384 and 512 ("wgmma
cluster") it runs as thread block clusters of two such blocks, one column
half each, which add their partial scores through distributed shared
memory (`cluster_plan` reports these clusters too).

Counts: `flash_forward.launches`, `flash_bwd_dq.launches` and
`flash_bwd_dkv.launches` (kernel launches), `launches_by_route[(kind,
route)]` (the same by kernel family: kind "fwd", "dq" or "dkv"; route
"tf32", "tf32 cluster", "wgmma", "wgmma wide" or "wgmma cluster", as the
library reports it),
`flash_attention_plain_fwd.calls` and `flash_attention_plain_bwd.calls`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops.kernel_dispatch import mxu_dtype, stat_dtype

NEG_INF = -1e30

# Tolerance of the kernels against the plain versions computed in f32 on
# the same inputs (bf16 cast up exactly); see `error_in_tolerances`. O,
# dQ, dK and dV are held row by row (one row = one (b, t, h), over D): the
# row's largest error within TOLERANCE[dtype] times the row's scale, so
# rows of small values (a causal row that averages thousands of keys) are
# held to their own scale. A row's scale is its largest reference
# magnitude, or the median of those over the tensor's rows where that is
# larger: a row whose terms cancel (causal dQ row 0, where dS = P * (dP -
# dsum) is exactly 0 and the bf16 rounding of O inside dsum leaves a
# residue) is held to the tensor's typical scale. f32: the kernels and the
# plain version differ only in the order of their f32 sums. bf16: the
# kernels round each output to bf16 (relative error up to 2^-8) and P and
# dS before their products (up to 2^-8 per term, averaging out over the
# sums): a row stays within about 2^-7 of its largest entry, held at 2^-6.
# L is computed in f32 from the same inputs on both sides, whatever the
# dtype: it is held elementwise to L_TOLERANCE absolute. The f32 kernels
# compute their products in split TF32, which stays within a few hundredths
# of the f32 tolerance; a single TF32 pass (10-bit mantissas) lands several
# times outside it (tests/test_torch_flash_attention.py emulates both).
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
L_TOLERANCE = 1e-4

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (128, 256, 384, 512)
_FWD, _DQ, _DKV = 0, 1, 2
_KIND_NAMES = {_FWD: "fwd", _DQ: "dq", _DKV: "dkv"}
ROUTES = {0: "tf32 cluster", 1: "tf32", 2: "wgmma cluster", 3: "wgmma",
          4: "wgmma wide"}
launches_by_route: Dict[Tuple[str, str], int] = {}


def error_in_tolerances(name: str, got: torch.Tensor, ref: torch.Tensor,
                        dtype: torch.dtype) -> float:
    """How far a kernel's output `got` lies from its f32 reference `ref`,
    in units of its tolerance (the kernel passes at <= 1): for "L" the
    largest absolute error over L_TOLERANCE; for O, dQ, dK and dV the
    largest over rows of (the row's largest error) / (TOLERANCE[dtype] x
    the row's scale: its largest |ref|, at least the median of those over
    the rows). Non-finite output gives inf."""
    g, r = got.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    err = (g - r).abs()
    if name == "L":
        return err.max().item() / L_TOLERANCE
    scale = r.abs().amax(dim=-1)
    bound = TOLERANCE[dtype] * torch.maximum(scale, scale.median())
    row = err.amax(dim=-1)
    return torch.where(row == 0, 0.0, row / bound).max().item()


def _scale(D: int, sm_scale: Optional[float]) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(D)


def _keep(Tq: int, Tk: int, device) -> torch.Tensor:
    """Causal keep mask (Tq, Tk): key j visible to query i when j <= i."""
    iq = torch.arange(Tq, device=device)[:, None]
    ik = torch.arange(Tk, device=device)[None, :]
    return ik <= iq + (Tk - Tq)


def _scores(q, k, causal, scale):
    """(B, H, Tq, Tk) scaled scores in the statistic dtype, masked
    entries NEG_INF (the kernels' `_masked_scores`)."""
    sdt = stat_dtype(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(sdt), k.to(sdt)) * scale
    if causal:
        s = s.masked_fill(~_keep(s.shape[-2], s.shape[-1], s.device), NEG_INF)
    return s


def _rounded(x, dt):
    """`x` rounded to the products' operand type and back (bf16 rounds P
    and dS before their products; f32/f64 leave them as they are)."""
    return x.to(mxu_dtype(dt)).to(x.dtype)


def flash_attention_plain_fwd(q, k, v, causal: bool = False,
                              sm_scale: Optional[float] = None):
    """Plain forward: (O, L) with O (B, Tq, H, D) in q's dtype and L the
    row logsumexp (B*H, Tq) in the statistic dtype; rows with no visible
    key give O = 0 and L = NEG_INF."""
    flash_attention_plain_fwd.calls += 1
    B, Tq, H, D = q.shape
    scale = _scale(D, sm_scale)
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(s <= NEG_INF / 2, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", _rounded(p, q.dtype), v.to(s.dtype))
    o = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                      NEG_INF)
    return (o.transpose(1, 2).to(q.dtype),
            lse.reshape(B * H, Tq))


flash_attention_plain_fwd.calls = 0


def flash_attention_plain_bwd(q, k, v, o, lse, do, causal: bool = False,
                              sm_scale: Optional[float] = None):
    """Plain backward from the forward's O and L: (dQ, dK, dV) with
    P = exp(S - L), dsum = rowsum(dO * O), dS = P * (dO V^T - dsum)."""
    flash_attention_plain_bwd.calls += 1
    B, Tq, H, D = q.shape
    scale = _scale(D, sm_scale)
    s = _scores(q, k, causal, scale)
    sdt = s.dtype
    p = torch.exp(s - lse.reshape(B, H, Tq, 1).to(sdt))
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    dof = do.to(sdt)
    dsum = (dof * o.to(sdt)).sum(dim=-1).transpose(1, 2)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.to(sdt))
    ds = _rounded(p * (dp - dsum), q.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", _rounded(p, q.dtype), dof)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(sdt)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(sdt)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_plain_bwd.calls = 0


# --------------------------------------------------------------- kernels
def _library() -> ctypes.CDLL:
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.load("flash_attention")
    if lib.dl4j_flash_fwd.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        st = ctypes.POINTER(ctypes.c_longlong)
        # dtype, B, H, Tq, Tk, D, causal, scale, stream
        dims = [ci] * 7 + [cf, vp]
        lib.dl4j_flash_fwd.argtypes = [vp] * 5 + [st] + dims
        lib.dl4j_flash_bwd_dq.argtypes = [vp] * 7 + [st] + dims
        lib.dl4j_flash_bwd_dkv.argtypes = [vp] * 8 + [st] + dims
        for fn in (lib.dl4j_flash_fwd, lib.dl4j_flash_bwd_dq,
                   lib.dl4j_flash_bwd_dkv):
            fn.restype = ci
        lib.dl4j_flash_block_rows.argtypes = [ci, ci]
        lib.dl4j_flash_block_rows.restype = ci
        lib.dl4j_flash_smem_bytes.argtypes = [ci, ci, ci]
        lib.dl4j_flash_smem_bytes.restype = ctypes.c_size_t
        lib.dl4j_flash_route.argtypes = [ci, ci, ci]
        lib.dl4j_flash_route.restype = ci
        ip = ctypes.POINTER(ci)
        lib.dl4j_flash_cluster_plan.argtypes = [ci, ci, ci, ip, ip]
        lib.dl4j_flash_cluster_plan.restype = ci
    return lib


def _strides(*ts):
    vals = [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when the kernels can read it through its strides (unit
    stride along D, a 16-byte aligned base, and (b, t, h) strides that are
    positive multiples of 16 bytes, as TMA tensor maps need), else a
    contiguous copy in fresh (aligned) memory: `.contiguous()` would hand
    back a contiguous tensor whose base is misaligned as it is."""
    e = t.element_size()
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(t.stride(i) > 0 and (t.stride(i) * e) % 16 == 0
                  for i in range(3)))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _stats_ready(t: torch.Tensor) -> torch.Tensor:
    """An f32 (B*H, Tq) statistic (L or dsum) as the backward kernels read
    it: contiguous with a 16-byte aligned base (the bf16 dK/dV kernels
    copy runs of 64 or 32 floats of it with the bulk-copy engine), else a
    copy."""
    t = t.float()
    ok = t.is_contiguous() and t.data_ptr() % 16 == 0
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _check_cuda(q, k, v, causal):
    """Preconditions of the kernels; returns (lib, dtype code, B, H, Tq,
    Tk, D)."""
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA "
                         f"device, got {q.device} / {k.device} / {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernels take f32 or bf16 q/k/v of "
                        f"one type, got {q.dtype} / {k.dtype} / {v.dtype}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if tuple(k.shape) != (B, Tk, H, D) or tuple(v.shape) != (B, Tk, H, D):
        raise ValueError(f"k/v shapes {tuple(k.shape)} / {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)} (widen GQA K/V first)")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernels take head_dim D in "
                         f"{_HEAD_DIMS}, got {D}")
    lib = _library()
    code = _DTYPE_CODE[q.dtype]
    blk = lib.dl4j_flash_block_rows(code, D)
    for name, t in (("Tq", Tq), ("Tk", Tk)):
        if t % blk:
            raise ValueError(f"{name}={t} must be a multiple of {blk} for the "
                             f"{q.dtype} kernels at D={D}")
    from deeplearning4j_tpu_torch.ops.kernel_dispatch import smem_limit_bytes

    limit = smem_limit_bytes(q.device)
    for kind in (_FWD, _DQ, _DKV):
        need = lib.dl4j_flash_smem_bytes(kind, code, D)
        if need > limit:
            raise ValueError(f"flash_attention kernel {kind} needs {need} "
                             f"bytes of shared memory per block at D={D}, "
                             f"{q.dtype}; the card allows {limit}")
    return lib, code, B, H, Tq, Tk, D


def _raise_on(rc, what, shape):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"(q shape {shape})")


def _counted(wrapper, lib, kind, code, D):
    """One launch of `wrapper`'s kernel: its count and its route's."""
    wrapper.launches += 1
    key = (_KIND_NAMES[kind], ROUTES[lib.dl4j_flash_route(kind, code, D)])
    launches_by_route[key] = launches_by_route.get(key, 0) + 1


def flash_forward(q, k, v, causal: bool, sm_scale: Optional[float],
                  with_lse: bool):
    """Launch the forward kernel: (O, L or None)."""
    lib, code, B, H, Tq, Tk, D = _check_cuda(q, k, v, causal)
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    with torch.cuda.device(q.device):
        rc = lib.dl4j_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), _strides(q, k, v, o),
            code, B, H, Tq, Tk, D, int(causal), _scale(D, sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash forward", tuple(q.shape))
    _counted(flash_forward, lib, _FWD, code, D)
    return o, lse


flash_forward.launches = 0


def _dsum(o, do):
    """rowsum(dO * O) in f32, (B*H, Tq): a plain reduction outside the
    kernels, as in the reference."""
    B, Tq, H, _ = o.shape
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2) \
        .reshape(B * H, Tq).contiguous()


def flash_bwd_dq(q, k, v, do, lse, dsum, causal, sm_scale):
    """Launch the dQ kernel."""
    lib, code, B, H, Tq, Tk, D = _check_cuda(q, k, v, causal)
    q, k, v, do = (_kernel_ready(t) for t in (q, k, v, do))
    lse, dsum = _stats_ready(lse), _stats_ready(dsum)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        rc = lib.dl4j_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do, dq), code, B, H, Tq, Tk, D, int(causal),
            _scale(D, sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash dQ", tuple(q.shape))
    _counted(flash_bwd_dq, lib, _DQ, code, D)
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, dsum, causal, sm_scale):
    """Launch the dK/dV kernel."""
    lib, code, B, H, Tq, Tk, D = _check_cuda(q, k, v, causal)
    q, k, v, do = (_kernel_ready(t) for t in (q, k, v, do))
    lse, dsum = _stats_ready(lse), _stats_ready(dsum)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        rc = lib.dl4j_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, dk, dv), code, B, H, Tq, Tk, D,
            int(causal), _scale(D, sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash dK/dV", tuple(q.shape))
    _counted(flash_bwd_dkv, lib, _DKV, code, D)
    return dk, dv


flash_bwd_dkv.launches = 0


def cluster_plan(kind: str, D: int,
                 dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(blocks a cluster holds, clusters that fit on the card at once) of
    the backward kernel `kind` ("dq" or "dkv") in `dtype` at head dim D;
    (1, 0) where that kernel runs no clusters."""
    lib = _library()
    cluster, active = ctypes.c_int(), ctypes.c_int()
    code = {"dq": _DQ, "dkv": _DKV}[kind]
    rc = lib.dl4j_flash_cluster_plan(code, _DTYPE_CODE[dtype], D,
                                     ctypes.byref(cluster),
                                     ctypes.byref(active))
    if rc != 0:
        raise RuntimeError(f"flash cluster plan ({kind}, {dtype}, D={D}) "
                           f"failed: CUDA error {rc}")
    return cluster.value, active.value


def _on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU, False when on CUDA; mixed
    devices raise."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"flash_attention: all tensors on one CUDA device or "
                     f"all on the CPU, got {sorted(str(t.device) for t in ts)}")


class _FlashAttention(torch.autograd.Function):
    """Exact attention with the flash backward: kernels for CUDA tensors,
    the plain versions for CPU tensors (no try, no fallback)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float]):
        if _on_cpu(q, k, v):
            o, lse = flash_attention_plain_fwd(q, k, v, causal, sm_scale)
        else:
            o, lse = flash_forward(q, k, v, causal, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale = ctx.causal, ctx.sm_scale
        if _on_cpu(q, k, v, do):
            dq, dk, dv = flash_attention_plain_bwd(q, k, v, o, lse, do,
                                                   causal, sm_scale)
        else:
            dsum = _dsum(o, do)
            dq = flash_bwd_dq(q, k, v, do, lse, dsum, causal, sm_scale)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, dsum, causal, sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention, (B, T, H, D) layout, no key mask, differentiable.
    `sm_scale` defaults to 1/sqrt(D) as a Python float. Causal needs
    Tq == Tk. On the card the kernels also need D in (128, 256, 384,
    512), f32 or bf16, and T a multiple of 128 (bf16 at D >= 256: of 64);
    they raise otherwise."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal flash path requires Tq == Tk")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    if _on_cpu(q, k, v):
        return flash_attention_plain_fwd(q, k, v, causal, sm_scale)[0]
    return flash_forward(q, k, v, causal, sm_scale, with_lse=False)[0]


def reset_counts() -> None:
    """Set the kernels' launch counts and the plain versions' call counts
    to 0."""
    flash_forward.launches = 0
    flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = 0
    launches_by_route.clear()
    flash_attention_plain_fwd.calls = 0
    flash_attention_plain_bwd.calls = 0
