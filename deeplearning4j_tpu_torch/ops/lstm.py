"""The fused Graves LSTM: the hand-written CUDA forward and backward
kernels, their wrappers, their plain PyTorch versions and the
`torch.autograd.Function`s that tie them together.

Counterpart of `deeplearning4j_tpu/ops/pallas_lstm.py`: the TPU kernels
`_lstm_fwd_kernel`, `_lstm_bwd_kernel`, `_lstm_fwd_kernel_masked` and
`_lstm_bwd_kernel_masked` become `csrc/lstm.cu` (route: CUDA C++ for
sm_90a, plain C interface, loaded with ctypes): one persistent launch per
layer, direction and pass, the time loop inside it. A tile of batch rows
is a thread block cluster whose blocks meet at a cluster barrier once
per step, and the step's product runs on wgmma fed by TMA: in bf16, and
in f32 in split TF32 (each operand split into two TF32 parts, three
tensor-core passes, every 32-wide k chunk summed on a fresh accumulator
and added in f32: f32 accuracy, the reference's HIGHEST precision,
whatever `torch.backends.cuda.matmul.allow_tf32` says). The bf16
forward and backward at B <= 128 and H <= 1024 are one cooperative
launch each instead, whose blocks keep their slices of RW in shared
memory for the whole launch and wait for each other's h_t (dz[t]) on a
counter in global memory (`plan` reports which route a call gets). The
source's header says how each is laid out and what bounds it.

`lstm_fused(x, W, RW, b, peephole, h0, c0, mask=, reverse=)` is the entry
point (the JAX package's `lstm_fused_or_none` without the `None`): the
time-major input projection `xw = x W + b` runs outside the kernels, as a
PyTorch matmul; the kernels run the recurrence. Given CPU tensors the
wrappers `lstm_fwd`/`lstm_bwd` run the plain versions; given CUDA tensors
they launch the kernels or raise. There is no probe, no fallback and no
kill switch: the JAX package's `DL4J_TPU_NO_PALLAS_LSTM` and
`DL4J_TPU_LSTM_UNROLL` switches and its TPU-only shape preconditions are
not carried over. The kernels take B >= 1, T >= 1, f32 or bf16 and H up
to 2048; above that they raise before the launch (`MAX_H`), and
`nn.layers.recurrent.lstm_forward` sends such a layer to its plain step
loop instead (the JAX package's `lax.scan` route), chosen from the
arguments and counted in `lstm_forward.routes["loop"]`. The bf16
kernels take H a multiple of 8: the wrappers pad any other H with zero
units (`_padded_units`) and cut them off the results.

Rounding points are the Pallas kernels': carries and the gate chain in
the statistic type (f32; f64 for f64 input on the CPU), product operands
in the operand type (`mxu_dtype`: h rounded before its product, never
carried rounded), h_out, c, gates and dz stored in xw's type, dh0 and dc0
in the statistic type. The plain versions round at the same points, so
kernel and plain version differ only in the order of their f32 sums.

Counts: `launches[("fwd" | "bwd", masked, reverse)]` (kernel launches),
`launches_by_route[("fwd" | "bwd", route)]` (the same, by `plan`'s
route), `lstm_fwd_plain.calls` and `lstm_bwd_plain.calls`. Every
increment goes through `count`, under `_COUNT_LOCK`, so the counts stay
exact when several threads run LSTM networks at once (a `ModelServer`
with `max_concurrent > 1`): a bare `+=` is a read, an add and a write,
and two threads can lose one of their increments between them.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.kernel_dispatch import mxu_dtype, stat_dtype

# Tolerance of the kernels against the plain versions computed in f32 on
# the same inputs (bf16 cast up exactly), held row by row (one row = one
# (t, b) over the hidden units or the 4H gate columns; see
# `error_in_tolerances`): the row's largest error within TOLERANCE[dtype]
# times the row's largest reference magnitude (or the median row's, where
# larger). f32: the two sum in another order. bf16: both round every
# stored value to bf16 (2^-8 relative), and a value that lands near a
# rounding boundary may round the other way and carry into later steps
# through the rounded h; a row stays within about 2^-7, held at 2^-6.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The widest H the kernels take: the four gates of a unit sit in one
# thread's accumulator, and 16 blocks of 128 units is the most one
# cluster holds.
MAX_H = 2048

launches: Dict[Tuple[str, bool, bool], int] = {}
launches_by_route: Dict[Tuple[str, str], int] = {}

_COUNT_LOCK = threading.Lock()


def count(*items: Tuple[Any, Any]) -> None:
    """Add one to each (counter, key) of `items`, all under one hold of
    `_COUNT_LOCK`: a dict counter gains one at `key`, any other object in
    its attribute `key` (`count((lstm_fwd_plain, "calls"))`). The one
    helper for every LSTM launch, call and route count."""
    with _COUNT_LOCK:
        for counter, key in items:
            if isinstance(counter, dict):
                counter[key] = counter.get(key, 0) + 1
            else:
                setattr(counter, key, getattr(counter, key) + 1)


def error_in_tolerances(got: torch.Tensor, ref: torch.Tensor,
                        dtype: torch.dtype) -> float:
    """How far `got` lies from its f32 reference `ref`, in units of
    TOLERANCE[dtype] (the kernel passes at <= 1): the largest over rows
    (the last axis) of the row's largest error over the row's scale, its
    largest |ref| or the median of those, where larger. Non-finite output
    gives inf."""
    g, r = got.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    err = (g - r).abs().reshape(-1, g.shape[-1])
    scale = r.abs().reshape(-1, r.shape[-1]).amax(dim=-1)
    bound = TOLERANCE[dtype] * torch.maximum(scale, scale.median())
    row = err.amax(dim=-1)
    return torch.where(row == 0, 0.0, row / bound).max().item()


def _order(T: int, reverse: bool):
    """Time indices in the order the forward processes them."""
    return [T - 1 - s if reverse else s for s in range(T)]


# ------------------------------------------------------------------ plain
def lstm_fwd_plain(xw, rw, peep, h0, c0, mask=None, *, reverse=False,
                   with_stash=True):
    """Plain forward over xw (T, B, 4H), RW (H, 4H), peep (3, H), h0/c0
    (B, H), mask (T, B) or None, all of one dtype: (h_out (T, B, H), hT
    (B, H) masked else None, cT, h_sel (T, B, H) masked with stash else
    None, c (c_sel) (T, B, H) or None, gates (T, B, 4H) or None)."""
    count((lstm_fwd_plain, "calls"))
    T, B, G = xw.shape
    H = G // 4
    sdt, dt = stat_dtype(xw.dtype), mxu_dtype(xw.dtype)
    rwf = rw.to(dt).to(sdt)
    pI, pF, pO = (peep[j].to(sdt) for j in range(3))
    h, c = h0.to(sdt), c0.to(sdt)
    new = lambda *s: torch.empty(s, dtype=xw.dtype, device=xw.device)
    h_out = new(T, B, H)
    c_st = new(T, B, H) if with_stash else None
    h_st = new(T, B, H) if with_stash and mask is not None else None
    gates = new(T, B, G) if with_stash else None
    for t in _order(T, reverse):
        z = xw[t].to(sdt) + h.to(dt).to(sdt) @ rwf
        i = torch.sigmoid(z[:, :H] + pI * c)
        f = torch.sigmoid(z[:, H:2 * H] + pF * c)
        g = torch.tanh(z[:, 3 * H:])
        cn = f * c + i * g
        o = torch.sigmoid(z[:, 2 * H:3 * H] + pO * cn)
        hn = o * torch.tanh(cn)
        if mask is None:
            h, c, out = hn, cn, hn
        else:
            m = mask[t].to(sdt)[:, None]
            # hard select on m > 0; the output scales by m
            h = torch.where(m > 0, hn, h)
            c = torch.where(m > 0, cn, c)
            out = h * m
        h_out[t] = out
        if with_stash:
            c_st[t] = c
            gates[t] = torch.cat([i, f, o, g], dim=1)
            if h_st is not None:
                h_st[t] = h
    hT = None if mask is None else h.to(xw.dtype)
    return h_out, hT, c.to(xw.dtype), h_st, c_st, gates


lstm_fwd_plain.calls = 0


def lstm_bwd_plain(gates, c_st, dh_out, dhT, dcT, rw, peep, c0, mask=None,
                   *, reverse=False):
    """Plain backward from the forward's stash: (dz (T, B, 4H) in the
    gates' type, dhc0 (2, B, H) = (dh0, dc0) in the statistic type).
    `c_st` is the c stash (c_sel when masked); `dhT` is None unmasked."""
    count((lstm_bwd_plain, "calls"))
    T, B, G = gates.shape
    H = G // 4
    sdt, dt = stat_dtype(gates.dtype), mxu_dtype(gates.dtype)
    rwf = rw.to(dt).to(sdt)
    pI, pF, pO = (peep[j].to(sdt) for j in range(3))
    dh = torch.zeros((B, H), dtype=sdt, device=gates.device) \
        if dhT is None else dhT.to(sdt)
    dc = dcT.to(sdt)
    dz = torch.empty_like(gates)
    order = _order(T, reverse)
    for k in range(T - 1, -1, -1):
        t = order[k]
        gt = gates[t].to(sdt)
        i, f, o, g = gt[:, :H], gt[:, H:2 * H], gt[:, 2 * H:3 * H], gt[:, 3 * H:]
        c_prev = (c0 if k == 0 else c_st[order[k - 1]]).to(sdt)
        if mask is None:
            c_t = c_st[t].to(sdt)
            dh_new = dh_out[t].to(sdt) + dh
            dc_new = dc
            byp_h = byp_c = 0.0
        else:
            m = mask[t].to(sdt)[:, None]
            c_t = f * c_prev + i * g   # the candidate: the stash holds c_sel
            d_hsel = m * dh_out[t].to(sdt) + dh
            zero = torch.zeros_like(d_hsel)
            dh_new = torch.where(m > 0, d_hsel, zero)
            byp_h = torch.where(m > 0, zero, d_hsel)
            dc_new = torch.where(m > 0, dc, zero)
            byp_c = torch.where(m > 0, zero, dc)
        tc = torch.tanh(c_t)
        dzo = dh_new * tc * o * (1.0 - o)
        dct = dh_new * o * (1.0 - tc * tc) + dc_new + dzo * pO
        dzg = dct * i * (1.0 - g * g)
        dzi = dct * g * i * (1.0 - i)
        dzf = dct * c_prev * f * (1.0 - f)
        dz_t = torch.cat([dzi, dzf, dzo, dzg], dim=1)
        dz[t] = dz_t
        dh = dz_t.to(dt).to(sdt) @ rwf.T + byp_h
        dc = dct * f + dzi * pI + dzf * pF + byp_c
    return dz, torch.stack([dh, dc])


lstm_bwd_plain.calls = 0


# --------------------------------------------------------------- kernels
def _library() -> ctypes.CDLL:
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.load("lstm")
    if lib.dl4j_lstm_fwd.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # dtype, T, B, H, reverse, stream
        dims = [ci] * 5 + [vp]
        # xw, rwp, Hk, peep, c0, mask, hbuf, Bp, ldh, sync, h_out, hT, cT,
        # hsel, c_stash, gates
        lib.dl4j_lstm_fwd.argtypes = [vp, vp, ci, vp, vp, vp, vp, ci, ci, vp] \
            + [vp] * 6 + dims
        # gates, c, dh_out, dhT, dcT, mask, rw, rwp, peep, c0, dz, dzbuf,
        # dhc0, sync
        lib.dl4j_lstm_bwd.argtypes = [vp] * 14 + dims
        lib.dl4j_lstm_fwd.restype = ci
        lib.dl4j_lstm_bwd.restype = ci
        lib.dl4j_lstm_plan.argtypes = [ci] * 5 + [ctypes.POINTER(ci)]
        lib.dl4j_lstm_plan.restype = ctypes.c_size_t
    return lib


ROUTES = ("cooperative", "bf16 clusters", "tf32 clusters", "bf16 clusters",
          "cooperative")


class LaunchPlan(NamedTuple):
    """A kernel's launch on the current card: `route` (one of ROUTES),
    `smem` bytes of dynamic shared memory per block, `gx` x `gy` blocks
    (the grid's blocks x 1 for the cooperative kernels; blocks per
    cluster x row tiles for the others), `rows` per TMA box of h or dz[t]
    (the batch rounded up to 8; cooperative) or per tile, `active` blocks
    that can be resident at once (cooperative) or clusters that fit at
    once (0: refused), `cluster` blocks per cluster, `units` per block (8
    in the cooperative forward, 16 in the cooperative backward)."""
    route: str
    smem: int
    gx: int
    gy: int
    rows: int
    active: int
    cluster: int
    units: int

    @property
    def waves(self) -> float:
        """Waves of clusters at once (inf when none fits)."""
        return -(-self.gy // self.active) if self.active else math.inf


def plan(kind: str, dtype: torch.dtype, masked: bool, B: int,
         H: int) -> LaunchPlan:
    """The kernel's launch plan on the current card for (B, H)."""
    lib = _library()
    out = (ctypes.c_int * 7)()
    smem = lib.dl4j_lstm_plan(0 if kind == "fwd" else 1, _DTYPE_CODE[dtype],
                              int(masked), B, H, out)
    if smem == 0:
        raise RuntimeError(f"lstm {kind}: planning the launch failed")
    route, *rest = tuple(out)
    return LaunchPlan(ROUTES[route], int(smem), *rest)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_cuda(kind, ts, dtype, B, H, masked):
    """Preconditions of the kernels: one CUDA device, f32 or bf16, one
    type, contiguous; H at most MAX_H; the block's shared memory within
    the card's limit; for the cluster kernels a cluster that fits the
    card. Returns (the library, the plan)."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"lstm {kind}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"lstm {kind}: the kernels take tensors of one "
                            f"type, f32 or bf16; got {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lstm {kind}: a non-contiguous tensor of shape "
                             f"{tuple(t.shape)}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"lstm {kind}: the kernels take f32 or bf16, got "
                        f"{dtype}")
    if H > MAX_H:
        raise ValueError(
            f"lstm {kind} kernels refuse H={H} > {MAX_H}: the four gates of "
            f"a unit sit in one thread's accumulator, and 16 blocks of 128 "
            f"units is the most one cluster holds")
    from deeplearning4j_tpu_torch.ops.kernel_dispatch import smem_limit_bytes

    limit = smem_limit_bytes(dev)
    with torch.cuda.device(dev):
        p = plan(kind, dtype, masked, B, H)
    if p.smem > limit:
        raise ValueError(
            f"lstm {kind} kernel needs {p.smem} bytes of shared memory per "
            f"block at H={H}, B={B}, {dtype} ({p}); the card allows {limit}")
    if p.route != "cooperative" and p.active < 1:
        raise ValueError(
            f"lstm {kind} kernel refuses H={H}, B={B}, {dtype}: no cluster "
            f"of {p.cluster} blocks of {p.units} units fits the card ({p})")
    return _library(), p


def _raise_on(rc, kind, shape, p):
    if rc == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(
            f"lstm {kind} kernel launch refused: CUDA error 720 (cooperative "
            f"launch too large): a grid of {p.gx} x {p.gy} blocks at "
            f"{p.smem} bytes of shared memory each, {p.active} can be "
            f"resident (shape {shape})")
    if rc != 0:
        raise RuntimeError(f"lstm {kind} kernel launch failed: CUDA error "
                           f"{rc} (shape {shape}, {p})")


def _count(kind, masked, reverse, route):
    count((launches, (kind, bool(masked), bool(reverse))),
          (launches_by_route, (kind, route)))


def _ceil(x: int, m: int) -> int:
    return -(-x // m) * m


def _gates_padded(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 4H) -> (..., 4(H+n)): n zero units after each gate's H."""
    *lead, G = x.shape
    H = G // 4
    return F.pad(x.reshape(*lead, 4, H), (0, n)).reshape(*lead, 4 * (H + n))


def _gates_cut(x: torch.Tensor, H: int) -> torch.Tensor:
    """The first H units of each gate of (..., 4H'), contiguous."""
    *lead, G = x.shape
    return x.reshape(*lead, 4, G // 4)[..., :H].reshape(*lead, 4 * H)


def _padded_units(x: torch.Tensor, what: str, n: int) -> torch.Tensor:
    """`x` with n zero units appended: `what` "gates" (..., 4H), "units"
    (..., H), or "rw" (H, 4H). A unit with zero weights, bias, peepholes,
    carries and cotangents stays at 0 in both passes and adds 0 to every
    other unit, so the bf16 kernels (whose TMA rows and boxes need H a
    multiple of 8) run any H as the next multiple of 8."""
    if what == "rw":
        return _gates_padded(F.pad(x, (0, 0, 0, n)), n)
    return _gates_padded(x, n) if what == "gates" else F.pad(x, (0, n))


def _units_cut(x: Optional[torch.Tensor], H: int):
    return None if x is None else x[..., :H].contiguous()


def _rw_by_unit_group(rw: torch.Tensor, group: int = 64,
                      k_mult: int = 8) -> torch.Tensor:
    """RW (H, 4H) arranged for the forward kernels: (4 Hu, Hk) with Hu =
    H rounded up to 64 and Hk to `k_mult`, row 4 group G + group q + j
    holding column q H + group G + j of RW (gate q of unit group G + j)
    over k; zeros past H. One such group's 4 `group` rows are the B
    operand of one consumer warpgroup's product: groups of 64 units for
    the bf16 cluster forward (n = 256), of 32 for the split-TF32 one (n =
    128), of 8 for the cooperative one (n = 32: a block's slice)."""
    H = rw.shape[0]
    Hu, Hk = _ceil(H, 64), _ceil(H, k_mult)
    n = Hu // group
    out = torch.zeros((n, 4, group, Hk), dtype=rw.dtype, device=rw.device)
    r = F.pad(rw.reshape(H, 4, H), (0, Hu - H))    # (k, q, unit)
    out[..., :H] = r.reshape(H, 4, n, group).permute(2, 1, 3, 0)
    return out.reshape(4 * Hu, Hk)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero, as `cvt.rna.tf32.f32` does (non-finite values kept)."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _tf32_planes(x: torch.Tensor) -> torch.Tensor:
    """(2, *x.shape): x's TF32 big part and the TF32 rounding of the rest,
    x = big + small to 2^-22 of x (`sm90::split_tf32`): h0 for the
    split-TF32 forward's first product, RW for the backward's products
    (split once per launch)."""
    big = _tf32(x)
    return torch.stack([big, _tf32(torch.where(torch.isfinite(x), x - big,
                                               torch.zeros_like(x)))])


def lstm_fwd(xw, rw, peep, h0, c0, mask=None, *, reverse=False,
             with_stash=True):
    """The forward: `lstm_fwd_plain`'s contract. CPU tensors run the plain
    version; CUDA tensors launch the kernel (rows 5 and 7) or raise."""
    if xw.device.type == "cpu":
        return lstm_fwd_plain(xw, rw, peep, h0, c0, mask, reverse=reverse,
                              with_stash=with_stash)
    T, B, G = xw.shape
    H = G // 4
    if H % 8 and xw.dtype == torch.bfloat16:
        n = -H % 8
        h_out, hT, cT, h_st, c_st, gates = lstm_fwd(
            _padded_units(xw, "gates", n), _padded_units(rw, "rw", n),
            *(_padded_units(t, "units", n) for t in (peep, h0, c0)), mask,
            reverse=reverse, with_stash=with_stash)
        return (_units_cut(h_out, H), _units_cut(hT, H), _units_cut(cT, H),
                _units_cut(h_st, H), _units_cut(c_st, H),
                None if gates is None else _gates_cut(gates, H))
    masked = mask is not None
    ins = [xw, rw, peep, h0, c0] + ([mask] if masked else [])
    lib, p = _check_cuda("fwd", ins, xw.dtype, B, H, masked)
    new = lambda *s: torch.empty(s, dtype=xw.dtype, device=xw.device)
    h_out, cT = new(T, B, H), new(B, H)
    hT = new(B, H) if masked else None
    Hk, sync = _ceil(H, 8), None
    if p.route == "tf32 clusters":
        # h's TF32 planes (parity 0 holds h0's), RW arranged per 32-unit
        # group; the carries start in cT and hT
        Bp, ldh = B, _ceil(H, 4)
        hbuf = torch.zeros((4, B, ldh), dtype=xw.dtype, device=xw.device)
        hbuf[:2, :, :H] = _tf32_planes(h0)
        Hk = ldh
        rwp = _rw_by_unit_group(rw, 32, 4)
        cT.copy_(c0)
        if masked:
            hT.copy_(h0)
    else:
        # the ping-pong h buffer, then the cooperative kernel's step
        # counter, zeroed with it; RW arranged per unit group of a block
        Bp, ldh = _ceil(B, 128), _ceil(H, 128)
        scratch = torch.zeros(2 * Bp * ldh + 64, dtype=xw.dtype,
                              device=xw.device)
        hbuf = scratch[:2 * Bp * ldh].view(2, Bp, ldh)
        sync = scratch[2 * Bp * ldh:]
        hbuf[0, :B, :H] = h0
        rwp = _rw_by_unit_group(rw, 8 if p.route == "cooperative" else 64)
    c_st = new(T, B, H) if with_stash else None
    h_st = new(T, B, H) if with_stash and masked else None
    gates = new(T, B, G) if with_stash else None
    with torch.cuda.device(xw.device):
        rc = lib.dl4j_lstm_fwd(
            xw.data_ptr(), rwp.data_ptr(), Hk, peep.data_ptr(),
            c0.data_ptr(), _ptr(mask), hbuf.data_ptr(), Bp, ldh, _ptr(sync),
            h_out.data_ptr(), _ptr(hT), cT.data_ptr(), _ptr(h_st),
            _ptr(c_st), _ptr(gates), _DTYPE_CODE[xw.dtype], T, B, H,
            int(reverse), torch.cuda.current_stream(xw.device).cuda_stream)
    _raise_on(rc, "fwd", tuple(xw.shape), p)
    _count("fwd", masked, reverse, p.route)
    return h_out, hT, cT, h_st, c_st, gates


def lstm_bwd(gates, c_st, dh_out, dhT, dcT, rw, peep, c0, mask=None, *,
             reverse=False):
    """The backward: `lstm_bwd_plain`'s contract. CPU tensors run the
    plain version; CUDA tensors launch the kernel (rows 6 and 8) or
    raise."""
    if gates.device.type == "cpu":
        return lstm_bwd_plain(gates, c_st, dh_out, dhT, dcT, rw, peep, c0,
                              mask, reverse=reverse)
    T, B, G = gates.shape
    H = G // 4
    if H % 8 and gates.dtype == torch.bfloat16:
        n = -H % 8
        c_st, dh_out, dhT, dcT, peep, c0 = (
            None if t is None else _padded_units(t, "units", n)
            for t in (c_st, dh_out, dhT, dcT, peep, c0))
        dz, dhc0 = lstm_bwd(_padded_units(gates, "gates", n), c_st, dh_out,
                            dhT, dcT, _padded_units(rw, "rw", n), peep, c0,
                            mask, reverse=reverse)
        return _gates_cut(dz, H), _units_cut(dhc0, H)
    masked = mask is not None
    ins = [gates, c_st, dh_out, dcT, rw, peep, c0] \
        + ([dhT, mask] if masked else [])
    lib, p = _check_cuda("bwd", ins, gates.dtype, B, H, masked)
    dz = torch.empty_like(gates)
    dhc0 = torch.empty((2, B, H), dtype=torch.float32, device=gates.device)
    rwp = dzbuf = sync = None
    if p.route == "cooperative":
        # the step counter the blocks wait on, zeroed
        sync = torch.zeros(1, dtype=torch.int32, device=gates.device)
    elif p.route == "tf32 clusters":
        # RW's TF32 planes, a scratch for dz[t]'s; the dc carry starts as dcT
        rwp = _tf32_planes(rw)
        dzbuf = torch.empty((2, B, G), dtype=gates.dtype, device=gates.device)
        dhc0[1].copy_(dcT)
    with torch.cuda.device(gates.device):
        rc = lib.dl4j_lstm_bwd(
            gates.data_ptr(), c_st.data_ptr(), dh_out.data_ptr(), _ptr(dhT),
            dcT.data_ptr(), _ptr(mask), rw.data_ptr(), _ptr(rwp),
            peep.data_ptr(), c0.data_ptr(), dz.data_ptr(), _ptr(dzbuf),
            dhc0.data_ptr(), _ptr(sync),
            _DTYPE_CODE[gates.dtype], T, B, H, int(reverse),
            torch.cuda.current_stream(gates.device).cuda_stream)
    _raise_on(rc, "bwd", tuple(gates.shape), p)
    _count("bwd", masked, reverse, p.route)
    return dz, dhc0


# ---------------------------------------------------------- autograd
def _shifted(src, first, reverse):
    """The previous carry of every step: `first` (B, H) at the first
    processed step, the stash of the step processed before otherwise."""
    if reverse:
        return torch.cat([src[1:], first[None]], dim=0)
    return torch.cat([first[None], src[:-1]], dim=0)


def _batched_grads(dz, h_src, c_src, h0, c0, rw, peep, reverse,
                   gates=None):
    """The contractions over the whole (T*B) slab, outside the kernels:
    dRW = h_prev^T dz in the operand type (f32 accumulation), and the
    peephole sums in the statistic type. dpO's cell state is c (c_src)
    unmasked; masked (`gates` given) it is the candidate f c_prev + i g,
    rebuilt from the gates, since the stash keeps the selected carry."""
    T, B, G = dz.shape
    H = G // 4
    sdt, dt = stat_dtype(dz.dtype), mxu_dtype(dz.dtype)
    h_prev = _shifted(h_src, h0, reverse)
    drw = torch.matmul(h_prev.reshape(T * B, H).to(dt).T,
                       dz.reshape(T * B, G).to(dt))
    c_prev = _shifted(c_src, c0, reverse).to(sdt)
    if gates is None:
        c_o = c_src.to(sdt)
    else:
        c_o = gates[..., H:2 * H].to(sdt) * c_prev \
            + gates[..., :H].to(sdt) * gates[..., 3 * H:].to(sdt)
    dpeep = torch.stack([(dz[..., :H].to(sdt) * c_prev).sum(dim=(0, 1)),
                         (dz[..., H:2 * H].to(sdt) * c_prev).sum(dim=(0, 1)),
                         (dz[..., 2 * H:3 * H].to(sdt) * c_o).sum(dim=(0, 1))])
    return drw.to(rw.dtype), dpeep.to(peep.dtype)


class _LSTMCore(torch.autograd.Function):
    """(T, B, 4H) projected inputs -> (h_out (T, B, H), cT (B, H)); the
    backward runs the backward kernel, then the batched contractions."""

    @staticmethod
    def forward(ctx, xw, rw, peep, h0, c0, reverse):
        h_out, _, cT, _, c_st, gates = lstm_fwd(xw, rw, peep, h0, c0,
                                                reverse=reverse)
        ctx.save_for_backward(gates, c_st, h_out, rw, peep, h0, c0)
        ctx.reverse = reverse
        return h_out, cT

    @staticmethod
    def backward(ctx, dh_out, dcT):
        gates, c_st, h_out, rw, peep, h0, c0 = ctx.saved_tensors
        dz, dhc0 = lstm_bwd(gates, c_st, dh_out.contiguous(), None,
                            dcT.to(gates.dtype).contiguous(), rw, peep, c0,
                            reverse=ctx.reverse)
        drw, dpeep = _batched_grads(dz, h_out, c_st, h0, c0, rw, peep,
                                    ctx.reverse)
        return (dz, drw, dpeep, dhc0[0].to(h0.dtype), dhc0[1].to(c0.dtype),
                None)


class _LSTMCoreMasked(torch.autograd.Function):
    """Masked variant: -> (masked outputs (T, B, H), hT, cT). The stash
    keeps the selected carries; the mask has no gradient."""

    @staticmethod
    def forward(ctx, xw, rw, peep, h0, c0, mask, reverse):
        h_out, hT, cT, h_st, c_st, gates = lstm_fwd(xw, rw, peep, h0, c0,
                                                    mask, reverse=reverse)
        ctx.save_for_backward(gates, h_st, c_st, mask, rw, peep, h0, c0)
        ctx.reverse = reverse
        return h_out, hT, cT

    @staticmethod
    def backward(ctx, dh_out, dhT, dcT):
        gates, h_st, c_st, mask, rw, peep, h0, c0 = ctx.saved_tensors
        dt = gates.dtype
        dz, dhc0 = lstm_bwd(gates, c_st, dh_out.contiguous(),
                            dhT.to(dt).contiguous(), dcT.to(dt).contiguous(),
                            rw, peep, c0, mask, reverse=ctx.reverse)
        drw, dpeep = _batched_grads(dz, h_st, c_st, h0, c0, rw, peep,
                                    ctx.reverse, gates)
        return (dz, drw, dpeep, dhc0[0].to(h0.dtype), dhc0[1].to(c0.dtype),
                None, None)


def _lstm_fwd_op(xw, rw, peep, h0, c0, reverse):
    h_out, _, cT, *_ = lstm_fwd(xw, rw, peep, h0, c0, reverse=reverse,
                                with_stash=False)
    return h_out.contiguous(), cT.contiguous()


def _lstm_fwd_masked_op(xw, rw, peep, h0, c0, mask, reverse):
    h_out, hT, cT, *_ = lstm_fwd(xw, rw, peep, h0, c0, mask,
                                 reverse=reverse, with_stash=False)
    return h_out.contiguous(), hT.contiguous(), cT.contiguous()


# the inference forwards as registered ops (`dl4j::lstm_fwd`,
# `dl4j::lstm_fwd_masked`): `torch.export` cannot trace into the ctypes
# launch, so an exported network (`util.stablehlo_export`) holds each
# kernel as one op whose body is `lstm_fwd` (the kernel on CUDA tensors,
# counted; the plain version on CPU tensors)
lstm_fwd_op = torch.library.custom_op(
    "dl4j::lstm_fwd", _lstm_fwd_op, mutates_args=(),
    schema="(Tensor xw, Tensor rw, Tensor peep, Tensor h0, Tensor c0, "
           "bool reverse) -> (Tensor, Tensor)")
lstm_fwd_masked_op = torch.library.custom_op(
    "dl4j::lstm_fwd_masked", _lstm_fwd_masked_op, mutates_args=(),
    schema="(Tensor xw, Tensor rw, Tensor peep, Tensor h0, Tensor c0, "
           "Tensor mask, bool reverse) -> (Tensor, Tensor, Tensor)")


@lstm_fwd_op.register_fake
def _(xw, rw, peep, h0, c0, reverse):
    T, B, G = xw.shape
    return xw.new_empty((T, B, G // 4)), xw.new_empty((B, G // 4))


@lstm_fwd_masked_op.register_fake
def _(xw, rw, peep, h0, c0, mask, reverse):
    T, B, G = xw.shape
    return (xw.new_empty((T, B, G // 4)), xw.new_empty((B, G // 4)),
            xw.new_empty((B, G // 4)))


def lstm_fused(x, W, RW, b, peephole, h0, c0, *, mask=None,
               reverse: bool = False):
    """The LSTM over x (B, T, nIn) with W (nIn, 4H), RW (H, 4H), b (4H,),
    peephole (pI, pF, pO) or None, h0/c0 (B, H) or None, mask (B, T) or
    None: (out (B, T, H), (hT, cT)). hT is the last processed step's
    carry (`reverse` walks T-1..0). Differentiable in everything but the
    mask; without a gradient the forward writes no stash."""
    B, T, _ = x.shape
    H = RW.shape[0]
    # time-major input projection: one big matmul outside the kernels
    xw = (torch.einsum("bti,ig->tbg", x, W) + b).contiguous()
    if peephole is None:
        peep = torch.zeros((3, H), dtype=x.dtype, device=x.device)
    else:
        peep = torch.stack(list(peephole)).to(x.dtype)
    zh = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    h0 = zh if h0 is None else h0.to(x.dtype)
    c0 = zh if c0 is None else c0.to(x.dtype)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xw, RW, peep, h0, c0))
    if mask is not None:
        m = mask.transpose(0, 1).to(x.dtype).contiguous()
        if grad:
            h_tbh, hT, cT = _LSTMCoreMasked.apply(xw, RW, peep, h0, c0, m,
                                                  reverse)
        else:
            h_tbh, hT, cT = lstm_fwd_masked_op(xw, RW, peep, h0, c0, m,
                                               reverse)
    else:
        if grad:
            h_tbh, cT = _LSTMCore.apply(xw, RW, peep, h0, c0, reverse)
        else:
            h_tbh, cT = lstm_fwd_op(xw, RW, peep, h0, c0, reverse)
        hT = h_tbh[0] if reverse else h_tbh[-1]
    return h_tbh.transpose(0, 1), (hT, cT)


def reset_counts() -> None:
    """Set the kernels' launch counts and the plain versions' call counts
    to 0."""
    with _COUNT_LOCK:
        launches.clear()
        launches_by_route.clear()
        lstm_fwd_plain.calls = 0
        lstm_bwd_plain.calls = 0
