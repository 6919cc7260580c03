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

Counts: `flash_forward.launches`, `flash_bwd_dq.launches` and
`flash_bwd_dkv.launches` (kernel launches), `flash_attention_plain_fwd.calls`
and `flash_attention_plain_bwd.calls`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

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
# dtype: it is held elementwise to L_TOLERANCE absolute.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
L_TOLERANCE = 1e-4

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (128, 256)
_FWD, _DQ, _DKV = 0, 1, 2


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
    return lib


def _strides(*ts):
    vals = [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when the kernel can read it through its strides (unit
    stride along D, 16-byte aligned rows), else a contiguous copy."""
    e = t.element_size()
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all((t.stride(i) * e) % 16 == 0 for i in range(3)))
    return t if ok else t.contiguous()


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
                         f"{_HEAD_DIMS}, got {D} (ROADMAP: D > 256)")
    lib = _library()
    code = _DTYPE_CODE[q.dtype]
    blk = lib.dl4j_flash_block_rows(code, D)
    for name, t in (("Tq", Tq), ("Tk", Tk)):
        if t % blk or t % 128:
            raise ValueError(f"{name}={t} must be a multiple of 128 and of the "
                             f"kernel's tile of {blk} rows")
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
    flash_forward.launches += 1
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
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        rc = lib.dl4j_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do, dq), code, B, H, Tq, Tk, D, int(causal),
            _scale(D, sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash dQ", tuple(q.shape))
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, dsum, causal, sm_scale):
    """Launch the dK/dV kernel."""
    lib, code, B, H, Tq, Tk, D = _check_cuda(q, k, v, causal)
    q, k, v, do = (_kernel_ready(t) for t in (q, k, v, do))
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
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


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
    Tq == Tk. On the card the kernels also need D in (128, 256), f32 or
    bf16, and T a multiple of 128 and of their tile; they raise
    otherwise."""
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
    flash_attention_plain_fwd.calls = 0
    flash_attention_plain_bwd.calls = 0
