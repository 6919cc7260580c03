#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deeplearning4j_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, about 3-5 minutes on an H100

Phases, each of which makes the script exit non-zero when it fails:

1. card: `nvidia-smi` name and power limit, torch and CUDA versions;
2. build: every CUDA source of the port (`csrc/paged_attention.cu`,
   `csrc/flash_attention.cu`) with nvcc, one process per source, started
   together; build seconds and ptxas' registers and spills;
3. paged kernels: the paged-attention kernel against its plain PyTorch
   version on the card, TF32 off, at the serving shapes (decode C=1 with
   S=8 slots, 8 heads, head_dim 128, page 128, 34 pages per slot;
   prefill chunks C=256; GQA with 2 KV heads; f32 and bf16; shuffled page
   tables, the trash page, stale pages past the limit, an inactive lane);
   the reference is the plain version computed in f32 on the same inputs
   (bf16 cast up), tolerance atol = rtol = 2e-4 (f32) / 4e-3 (bf16);
4. flash kernels: forward (O and L), dQ and dK/dV against the plain
   versions computed in f32 on the same inputs (the backward's include
   the O and L the forward kernel gave), f32 and bf16, causal and not,
   D = 128 and 256, T = 512 and 4096, and a GQA call through
   `multi_head_attention` with autograd against the same call on the
   CPU; O, dQ, dK, dV held row by row (a row's largest error within
   `flash_attention.TOLERANCE`, 1e-4 f32 / 2^-6 bf16, of that row's
   largest reference magnitude, or of the median row's where larger),
   L within 1e-4 absolute;
5. parity: a 2-layer, full-width (d_model 1024) f32 GPT; the
   `DecodeEngine`'s greedy tokens on the card must equal whole-batch
   `generate` on the card for the same prompts (one-shot and chunked
   prefill);
6. training parity: a 1-layer full-width f32 GPT (d_model 1024, 8 heads,
   T=1024, attention_block_size=512, B=2) from one seed takes 3 Adam
   steps on the card through the flash kernels and 3 on the CPU through
   the plain versions: per-step losses within rtol 1e-5, parameters
   within rtol 1e-5 + atol 3e-5 (a tenth of the learning rate: Adam moves
   an element whose gradient is noise by up to lr whatever its size);
   one step with remat=True equals one with remat=False (atol 1e-6);
7. serve (main path 1): the full-width 8-layer bf16 GPT (vocab 256,
   d_model 1024, 8 heads, max_length 4224) behind `DecodeEngine(n_slots=8,
   page_size=128, prefill_chunk=256, prompt_buckets=(128,))` answers four
   128-token and two 4096-token prompts with 32-128 output tokens, three
   times over (median wall reported); the launch counts are set to 0 just
   before and read just after, and the kernel must have launched at C=1
   and C=256 with no call of the plain version; one more batch under
   torch.profiler gives the device's busy time and idle share;
8. train (main path 2): the full-width bf16 `gpt_long` network (vocab 256,
   d_model 1024, 8 heads of 128, 8 layers, max_length 4096,
   attention_block_size 512, Adam 3e-4, f32 masters) fed B=8 x T=4096
   batches made with numpy from a seed through `MultiLayerNetwork.fit`:
   1 warm-up step, then 5 timed steps (step ms, tokens/s, each loss, which
   must be finite, peak device memory); the flash launch counts are set
   to 0 just before the timed steps and read just after: 8 forward, 8 dQ
   and 8 dK/dV launches per step and no call of a plain version; one more
   step under torch.profiler gives the busy time, idle share and top
   kernels;
9. timing: the flash kernels are first held to their plain versions at
   the training shape twice: on q/k/v sliced from one fused qkv tensor,
   as the training path passes them, and on contiguous ones; then CUDA
   events around each launch (a GPU sleep queued first so
   host overhead is not counted), L2 flushed before each, median of 20
   after warm-up, for each kernel, its plain version and a library call
   (`scaled_dot_product_attention` on the gathered dense view for paged
   attention; SDPA's forward, and SDPA's forward+backward minus its
   forward for the two backward kernels together; the yardsticks, which
   the port never calls), beside the bound max(flops / 989 TFLOP/s,
   bytes / 3.35 TB/s) of this run's data.

Prints one JSON line of per-kernel numbers, then the card's
`nvidia-smi` line, then as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero and prints no result without a CUDA device or outside a
checkout of the repository. Weights and inputs are made from seeds.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import traceback

KERNEL_SOURCES = ("paged_attention", "flash_attention")
REPLACES = "deeplearning4j_tpu/ops/pallas_paged_attention.py:77"
FLASH_SOURCE = "deeplearning4j_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_attention_fwd": "deeplearning4j_tpu/ops/pallas_attention.py:97",
    "flash_attention_bwd_dq": "deeplearning4j_tpu/ops/pallas_attention.py:153",
    "flash_attention_bwd_dkv":
        "deeplearning4j_tpu/ops/pallas_attention.py:183"}
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SERVE_REPEATS = 3          # the serving batch runs this many times
SERVE = dict(vocab_size=256, d_model=1024, n_heads=8, n_layers=8,
             max_length=4224)
# bench.py gpt_long (bench.py:563-568)
TRAIN = dict(vocab_size=256, d_model=1024, n_heads=8, n_layers=8,
             max_length=4096, attention_block_size=512, dropout=0.0)
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 4096, 5


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- inputs
def paged_inputs(torch, *, S, C, H, Hkv, hd, page, n_pages, dtype, seed,
                 positions, inactive=(), garbage=True):
    """Pools, a shuffled page table, positions and an active mask. Pages
    past each slot's last live page are either remapped to the trash
    page 0 (odd slots) or left pointing at stale pages (even slots);
    both, and page 0, hold large garbage that must never reach an
    output."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    P = S * n_pages + 3
    k_pool = torch.randn((P + 1, Hkv, hd, page), generator=g, device=dev)
    v_pool = torch.randn((P + 1, Hkv, page, hd), generator=g, device=dev)
    perm = torch.randperm(P, generator=g, device=dev)[:S * n_pages] + 1
    pt = perm.reshape(S, n_pages).to(torch.int32)
    if garbage:
        k_pool[0], v_pool[0] = 1e4, -1e4
        for s in range(S):
            last = min(n_pages - 1, (positions[s] + C - 1) // page)
            tail = pt[s, last + 1:]
            if tail.numel():
                k_pool[tail.long()], v_pool[tail.long()] = 3e3, -3e3
                if s % 2:
                    pt[s, last + 1:] = 0
    q = torch.randn((S, C, H, hd), generator=g, device=dev)
    active = torch.ones((S,), dtype=torch.bool, device=dev)
    for s in inactive:
        active[s] = False
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return dict(q=q.to(dtype).contiguous(), k_pool=k_pool.to(dtype),
                v_pool=v_pool.to(dtype), page_table=pt.contiguous(),
                positions=pos, active=active)


def work(inp):
    """FLOPs and bytes this call needs on its data. Row c of an active
    slot s attends to min(positions[s]+c, L-1)+1 keys (QK and PV, 2 flops
    per MAC). Bytes: of each active slot, the K and V entries
    0..min(positions[s]+C-1, L-1) of every KV head, the page-table entries
    of the pages holding them and its q rows, each read once; the whole
    output written once; positions and the active mask."""
    q, kp = inp["q"], inp["k_pool"]
    S, C, H, hd = q.shape
    Hkv, page = kp.shape[1], kp.shape[3]
    L = inp["page_table"].shape[1] * page
    isz = q.element_size()
    pos = inp["positions"].tolist()
    act = inp["active"].tolist()
    flops = 0
    nbytes = q.numel() * isz + 4 * S + S       # output, positions, mask
    for s in range(S):
        if not act[s]:
            continue
        for c in range(C):
            flops += 4 * H * hd * (min(pos[s] + c, L - 1) + 1)
        last = min(pos[s] + C - 1, L - 1)
        nbytes += 2 * (last + 1) * Hkv * hd * isz   # K and V entries
        nbytes += 4 * (last // page + 1)              # page-table entries
        nbytes += C * H * hd * isz                    # q rows
    return flops, nbytes


def bound_ms(inp):
    flops, nbytes = work(inp)
    peak = PEAK_BF16_FLOPS if inp["q"].dtype.itemsize == 2 \
        else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops > t_bytes else "bytes")


def time_ms(torch, fn, iters=20, warmup=3):
    """Device time of `fn`: median over `iters` runs, each between two
    CUDA events and preceded by a write of 128 MB so K/V come from HBM,
    not L2. A GPU-side sleep is queued first, so the host has queued the
    whole run before the start event fires and host launch overhead is
    not counted."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # ~2 ms of GPU clock cycles
        flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


def ptxas_summary(text: str):
    """One line per kernel from nvcc's `-Xptxas=-v` output: its name
    (demangled by c++filt where there is one), registers, stack frame and
    spills."""
    out, names, fn, props = [], [], "?", ""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            props = ""
        elif "Function properties for" in line and i + 1 < len(lines):
            props = lines[i + 1].strip()
        elif "ptxas info" in line and "Used" in line:
            names.append(fn)
            out.append(f"{line.split(':', 1)[1].strip()}"
                       + (f"; {props}" if props else ""))
    if shutil.which("c++filt") and names:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    names = [n.replace("(anonymous namespace)::", "").split("(")[0]
             .removeprefix("void ") for n in names]
    return [f"{n}: {o}" for n, o in zip(names, out)]


def host_us(torch, fn, n=50):
    """Host time per call of `fn` (queueing only; the device runs
    behind)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t) / n
    torch.cuda.synchronize()
    return 1e6 * dt


# --------------------------------------------------------------- phases
def plain_f32(pa, inp):
    """The plain version in f32 on the call's inputs (bf16 cast up
    exactly): the reference the kernel is held to."""
    return pa.paged_attention_plain(
        inp["q"].float(), inp["k_pool"].float(), inp["v_pool"].float(),
        inp["page_table"], inp["positions"], inp["active"])


def phase_kernels(torch, pa):
    """Kernel against plain at the serving shapes."""
    tol = pa.TOLERANCE
    base = dict(H=8, hd=128, page=128, n_pages=34)
    decode_pos = [0, 1, 127, 128, 1000, 2047, 4222, 4351]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            dict(name="decode C=1 MHA", S=8, C=1, Hkv=8, positions=decode_pos,
                 inactive=(5,)),
            dict(name="chunk C=256 MHA", S=1, C=256, Hkv=8,
                 positions=[3840]),
            dict(name="decode C=1 GQA Hkv=2", S=8, C=1, Hkv=2,
                 positions=decode_pos, inactive=(2,)),
            dict(name="chunk C=256 GQA Hkv=2", S=1, C=256, Hkv=2,
                 positions=[1000]),
        ]
        for c in cases[-4:]:
            c["dtype"] = dtype
    for i, c in enumerate(cases):
        inp = paged_inputs(torch, S=c["S"], C=c["C"], H=base["H"],
                           Hkv=c["Hkv"], hd=base["hd"], page=base["page"],
                           n_pages=base["n_pages"], dtype=c["dtype"],
                           seed=100 + i, positions=c["positions"],
                           inactive=c.get("inactive", ()))
        out = pa.paged_attention(inp["q"], inp["k_pool"], inp["v_pool"],
                                 inp["page_table"], inp["positions"],
                                 active=inp["active"])
        ref = plain_f32(pa, inp)
        torch.cuda.synchronize()
        t = tol[c["dtype"]]
        err = (out.float() - ref).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
            out.float(), ref, atol=t, rtol=t)
        inactive_zero = all(bool((out[s] == 0).all())
                            for s in c.get("inactive", ()))
        log(f"  {c['name']:<24} {str(c['dtype']):<15} max_abs_err={err:.3e} "
            f"tol={t} {'ok' if ok and inactive_zero else 'FAIL'}")
        if not (ok and inactive_zero):
            raise AssertionError(f"kernel disagrees with plain: {c['name']} "
                                 f"{c['dtype']} max_abs_err={err}")


def phase_parity(torch, M):
    """f32 engine-vs-generate token parity, 2 layers at full width."""
    import numpy as np

    conf = M["gpt_configuration"](**{**SERVE, "n_layers": 2, "seed": 7})
    net = M["MultiLayerNetwork"](conf, device="cuda")
    net.init()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, SERVE["vocab_size"], t) for t in (100, 128, 600)]
    n_tok = [12, 10, 12]
    eng = M["DecodeEngine"](net, n_slots=4, page_size=128, prefill_chunk=256,
                            prompt_buckets=(128,), max_len=1024,
                            device="cuda")
    try:
        reqs = [eng.submit(p, n) for p, n in zip(prompts, n_tok)]
        got = [r.result(timeout=300) for r in reqs]
        st = eng.stats()
    finally:
        eng.shutdown()
    for p, n, g in zip(prompts, n_tok, got):
        exp = M["generate"](net, p[None], n, temperature=0.0,
                            device="cuda")[0]
        log(f"  prompt {len(p):>4}: engine {g.tolist()}")
        log(f"               generate {exp.tolist()}")
        if not np.array_equal(g, exp):
            raise AssertionError(f"f32 engine tokens differ from generate "
                                 f"for the {len(p)}-token prompt")
    if st["prefill_chunks"] < 3:
        raise AssertionError(f"expected chunked prefill, stats {st}")
    log(f"  f32 parity ok: {len(prompts)} prompts, decode_steps="
        f"{st['decode_steps']}, prefill_chunks={st['prefill_chunks']}")


def phase_serve(torch, M, pa, card):
    """The main path: full-width 8-layer bf16 GPT behind the engine."""
    import numpy as np

    conf = M["gpt_configuration"](**SERVE, seed=11)
    net = M["MultiLayerNetwork"](conf, dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device="cuda")
    net.init()
    eng = M["DecodeEngine"](net, n_slots=8, page_size=128, prefill_chunk=256,
                            prompt_buckets=(128,), max_len=4224,
                            device="cuda")
    rng = np.random.default_rng(11)
    V = SERVE["vocab_size"]
    prompts = [rng.integers(0, V, 128) for _ in range(4)] \
        + [rng.integers(0, V, 4096) for _ in range(2)]
    n_tok = [int(x) for x in rng.choice((32, 48, 64, 96, 128), 6)]
    walls = []
    try:
        eng.generate(prompts[0][:16], 4)  # warm-up: cuBLAS handles, caching
        torch.cuda.synchronize()
        before = eng.stats()
        pa.reset_counts()
        for _ in range(SERVE_REPEATS):
            t0 = time.perf_counter()
            reqs = [eng.submit(p, n) for p, n in zip(prompts, n_tok)]
            outs = [r.result(timeout=900) for r in reqs]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = dict(pa.paged_attention.launches_by_chunk)
        plain_calls = pa.paged_attention_plain.calls
        st = eng.stats()
        trace = traced_batch(torch, eng, prompts, n_tok)
    finally:
        eng.shutdown()
    for o, n in zip(outs, n_tok):
        if o.shape != (n,) or o.min() < 0 or o.max() >= V:
            raise AssertionError(f"bad output tokens {o.shape} for n={n}")
    steps = (st["decode_steps"] - before["decode_steps"]) // SERVE_REPEATS
    chunks = (st["prefill_chunks"] - before["prefill_chunks"]) // SERVE_REPEATS
    toks = int(sum(n_tok))
    wall = sorted(walls)[len(walls) // 2]
    log(f"  {len(prompts)} requests (prompts {[len(p) for p in prompts]}, "
        f"outputs {n_tok}), {SERVE_REPEATS} runs: wall s "
        f"{[round(w, 4) for w in walls]}; median {toks / wall:.1f} generated "
        f"tokens/s ({(toks + sum(len(p) for p in prompts)) / wall:.1f} "
        f"prompt+generated tokens/s), decode_steps={steps}, "
        f"prefill_chunks={chunks} per run [{card}]")
    log(f"  paged_attention launches by chunk width: {launches}; plain "
        f"calls: {plain_calls}")
    log(f"  traced batch (torch.profiler, not in tokens/s): {trace}")
    if launches.get(1, 0) == 0 or launches.get(256, 0) == 0:
        raise AssertionError(f"kernel not launched on both paths: {launches}")
    if plain_calls:
        raise AssertionError(f"plain version called {plain_calls} times on "
                             "the card's main path")
    return launches


def traced_batch(torch, eng, prompts, n_tok) -> str:
    """One more serving batch under torch.profiler (see `traced`). The
    serving batch itself is part of the main path: an engine failure or
    timeout propagates."""
    def run():
        for r in [eng.submit(p, n) for p, n in zip(prompts, n_tok)]:
            r.result(timeout=900)

    return traced(torch, run)


def traced(torch, run) -> str:
    """`run()` under torch.profiler: the device's busy time (union of
    kernel intervals), the host wall inside the trace, the idle share and
    the kernels with the most device time. The profiler is a reading
    only: one that cannot trace on this machine is reported, not fatal;
    a failure of `run` propagates."""
    from torch.profiler import ProfilerActivity, profile

    def not_measured(e):
        return f"device busy share not measured ({type(e).__name__}: {e})"

    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:  # a measurement aid, not part of the port
        return not_measured(e)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    try:
        prof.stop()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as e:  # a measurement aid, not part of the port
        return not_measured(e)
    if not dev:
        return "device busy share not measured (no device events traced)"
    busy, end = 0.0, None
    per_name: dict = {}
    for ev in sorted(dev, key=lambda ev: ev.time_range.start):
        a, b = ev.time_range.start, ev.time_range.end
        per_name[ev.name] = per_name.get(ev.name, 0.0) + (b - a)
        if end is None or a > end:
            busy += b - a
        elif b > end:
            busy += b - end
        end = b if end is None else max(end, b)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    short = [n.replace("void ", "").replace("(anonymous namespace)::", "")
             .split("(")[0][:72] for n, _ in top]
    return (f"device busy {busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms "
            f"wall, idle share {100 * (1 - busy / wall_us):.1f}%; top "
            "kernels by device ms: " + "; ".join(
                f"{n} {t / 1e3:.1f}" for n, (_, t) in zip(short, top)))


def phase_timing(torch, pa, launches):
    """Kernel / plain / library times at the serving shapes, bf16."""
    import torch.nn.functional as F

    shapes = [
        ("paged_attention_decode", 1,
         dict(S=8, C=1, H=8, Hkv=8, hd=128, page=128, n_pages=34,
              positions=[4160, 4160, 192, 192, 192, 192, 0, 0],
              inactive=(6, 7))),
        ("paged_attention_prefill_chunk", 256,
         dict(S=1, C=256, H=8, Hkv=8, hd=128, page=128, n_pages=34,
              positions=[3840])),
    ]
    rows = []
    for name, C, sh in shapes:
        inp = paged_inputs(torch, dtype=torch.bfloat16, seed=7, garbage=False,
                           **sh)
        args = (inp["q"], inp["k_pool"], inp["v_pool"], inp["page_table"],
                inp["positions"])
        out = pa.paged_attention(*args, active=inp["active"])
        ref = plain_f32(pa, inp)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        t = pa.TOLERANCE[torch.bfloat16]
        if not torch.allclose(out.float(), ref, atol=t, rtol=t):
            raise AssertionError(f"{name}: kernel disagrees with plain, "
                                 f"max_abs_err={err} (tolerance {t})")
        ms = time_ms(torch, lambda: pa.paged_attention(
            *args, active=inp["active"]))
        plain_ms = time_ms(torch, lambda: pa.paged_attention_plain(
            *args, inp["active"]))
        # yardstick: one library call on the gathered dense view
        from deeplearning4j_tpu_torch.ops.attention import paged_gather

        kd, vd = paged_gather(inp["k_pool"], inp["v_pool"],
                              inp["page_table"])
        S, Cq, H, hd = inp["q"].shape
        L = kd.shape[-1]
        qd = inp["q"].permute(0, 2, 1, 3).contiguous()      # (S, H, C, hd)
        kt = kd.transpose(-1, -2).contiguous()             # (S, Hkv, L, hd)
        qpos = inp["positions"][:, None].long() \
            + torch.arange(Cq, device="cuda")[None, :]
        mask = (torch.arange(L, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]               # (S, 1, C, L)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kt, vd, attn_mask=mask))
        host = host_us(torch, lambda: pa.paged_attention(
            *args, active=inp["active"]))
        b_ms, b_by = bound_ms(inp)
        row = {"name": name, "route": "cuda",
               "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
               "replaces": REPLACES, "launches": int(launches.get(C, 0)),
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"max_abs_err {err:.3e}; wrapper host time {host:.1f} us/call")
        rows.append(row)
    return rows


# ----------------------------------------------------- flash attention
def flash_errors(fa, got, ref, dtype, names=("O", "L", "dQ", "dK", "dV")):
    """(name, max abs error, error in units of its tolerance) of each
    output against its f32 reference (`fa.error_in_tolerances`: O, dQ,
    dK, dV row by row, L absolute)."""
    return [(n, (g.float() - r.float()).abs().max().item(),
             fa.error_in_tolerances(n, g, r, dtype))
            for n, g, r in zip(names, got, ref)]


def flash_check(torch, fa, got, ref, dtype, what,
                names=("O", "L", "dQ", "dK", "dV")):
    """Hold each output to its f32 reference within its tolerance; logs
    max abs error / error in tolerances; returns the largest abs error."""
    errs = flash_errors(fa, got, ref, dtype, names)
    ok = all(u <= 1.0 for *_, u in errs)
    log(f"  {what:<40} " + " ".join(f"{n} {e:.2e}/{u:.3f}"
                                    for n, e, u in errs)
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"flash kernels disagree with plain: {what}")
    return max(e for _, e, _ in errs)


def flash_inputs(torch, B, T, H, D, dtype, seed):
    """q, k, v and dO, (B, T, H, D), from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
            for _ in range(4)]


def flash_inputs_fused(torch, B, T, H, D, dtype, seed):
    """q, k, v sliced from one (B, T, 3*H*D) tensor as `TransformerBlock`
    slices its qkv projection (t-stride 3*H*D, no copy), and dO."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((B, T, 3 * H * D), generator=g,
                      device="cuda").to(dtype)
    d = H * D
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(B, T, H, D)
               for i in range(3))
    do = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
    return q, k, v, do


def flash_run(fa, q, k, v, do, causal):
    """The three kernels as the autograd function calls them."""
    o, lse = fa.flash_forward(q, k, v, causal, None, with_lse=True)
    dsum = fa._dsum(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, dsum, causal, None)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, dsum, causal, None)
    return o, lse, dq, dk, dv


def flash_plain_f32(fa, q, k, v, do, causal, got):
    """The plain versions in f32 on the kernels' inputs (cast up): the
    forward on q, k, v; the backward on q, k, v, dO and the O and L that
    the forward kernel gave (`got[:2]`), as the backward kernels receive
    them (their dsum comes from that O, rounded to the dtype)."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    o, lse = fa.flash_attention_plain_fwd(q, k, v, causal)
    return (o, lse) + fa.flash_attention_plain_bwd(
        q, k, v, got[0].float(), got[1], do, causal)


def phase_flash(torch, fa):
    """Flash kernels against their plain versions, and GQA through
    `multi_head_attention` (flash route, autograd) against the CPU."""
    from deeplearning4j_tpu_torch.ops.attention import multi_head_attention

    errs = {}
    cases = [(B, T, H, D, dt, causal)
             for dt in (torch.float32, torch.bfloat16)
             for D in (128, 256) for causal in (False, True)
             for (B, T, H) in ((2, 512, 2),)]
    cases += [(1, 4096, 2, 128, dt, True)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(1, 4096, 2, 256, torch.bfloat16, False)]
    for i, (B, T, H, D, dt, causal) in enumerate(cases):
        q, k, v, do = flash_inputs(torch, B, T, H, D, dt, seed=40 + i)
        got = flash_run(fa, q, k, v, do, causal)
        ref = flash_plain_f32(fa, q, k, v, do, causal, got)
        torch.cuda.synchronize()
        what = (f"B={B} T={T} H={H} D={D} {str(dt)[6:]} "
                f"{'causal' if causal else 'full'}")
        errs[dt] = max(errs.get(dt, 0.0), flash_check(torch, fa, got, ref,
                                                      dt, what))
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(77)
        q = torch.randn((1, 1024, 8, 128), generator=g, device="cuda")
        k, v = (torch.randn((1, 1024, 2, 128), generator=g, device="cuda")
                for _ in range(2))
        do = torch.randn((1, 1024, 8, 128), generator=g, device="cuda")
        outs = []
        # the same call on the same inputs on the CPU, where the plain
        # versions compute in f32 and round O, P and dS to dt as the kernels do
        for dev in ("cuda", "cpu"):
            leaves = [t.detach().to(dt).to(dev).requires_grad_()
                      for t in (q, k, v)]
            fa.reset_counts()
            o = multi_head_attention(*leaves, causal=True, block_size=512)
            o.backward(do.to(dt).to(dev))
            counts = (fa.flash_forward.launches, fa.flash_bwd_dq.launches,
                      fa.flash_bwd_dkv.launches,
                      fa.flash_attention_plain_fwd.calls)
            outs.append([o.detach().cpu()] + [t.grad.cpu() for t in leaves])
            if dev == "cuda" and counts != (1, 1, 1, 0):
                raise AssertionError(f"GQA flash route launches {counts}")
        flash_check(torch, fa, outs[0], outs[1], dt,
                    f"GQA H=8 Hkv=2 T=1024 {str(dt)[6:]} via MHA",
                    names=("O", "dQ", "dK", "dV"))
    return errs


# ------------------------------------------------------------- training
def gpt_batches(np, vocab, B, T, n, seed):
    ids = np.random.default_rng(seed).integers(0, vocab, (n, B, T + 1))
    return [(ids[i, :, :-1].astype(np.int32), ids[i, :, 1:].astype(np.int32))
            for i in range(n)]


def phase_train_parity(torch, M):
    """f32, 1 layer at full width: 3 Adam steps on the card (kernels)
    against 3 on the CPU (plain versions), from one seed; then one
    remat=True step against one remat=False step on the card."""
    import numpy as np

    kw = dict(vocab_size=256, d_model=1024, n_heads=8, n_layers=1,
              max_length=1024, attention_block_size=512, seed=5)
    batches = gpt_batches(np, 256, 2, 1024, 3, seed=5)
    cpu = M["MultiLayerNetwork"](M["gpt_configuration"](**kw), device="cpu")
    cpu.init()
    card = M["MultiLayerNetwork"](M["gpt_configuration"](**kw),
                                  device="cuda")
    card.set_param_tree([{k: v.clone() for k, v in p.items()}
                         for p in cpu._params])
    fa = M["fa"]
    fa.reset_counts()
    losses = {"cuda": [], "cpu": []}
    for x, y in batches:
        for net in (card, cpu):
            net.fit(M["DataSet"](x, y))
            losses[net.device.type].append(net.score_value)
    counts = (fa.flash_forward.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches, fa.flash_attention_plain_fwd.calls,
              fa.flash_attention_plain_bwd.calls)
    log(f"  losses card {losses['cuda']}")
    log(f"         cpu  {losses['cpu']}")
    log(f"  launches (fwd, dQ, dK/dV, plain fwd, plain bwd): {counts}")
    if counts != (3, 3, 3, 3, 3):
        raise AssertionError(f"expected 3 kernel launches on the card and 3 "
                             f"plain calls on the CPU, got {counts}")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    worst = 0.0
    for a, b in zip(card._params, cpu._params):
        for k in a:
            d = (a[k].cpu() - b[k]).abs()
            worst = max(worst, d.max().item())
            if not bool((d <= 3e-5 + 1e-5 * b[k].abs()).all()):
                raise AssertionError(f"param {k} differs card vs CPU by "
                                     f"{d.max().item()}")
    log(f"  params after 3 steps: max abs diff card vs CPU {worst:.3e} "
        "(rtol 1e-5 + atol 3e-5)")
    nets = []
    for remat in (False, True):
        net = M["MultiLayerNetwork"](M["gpt_configuration"](
            **{**kw, "remat": remat}), device="cuda")
        net.set_param_tree([{k: v.clone() for k, v in p.items()}
                            for p in cpu._params])
        net.fit(M["DataSet"](*batches[0]))
        nets.append(net)
    d = (nets[0].params() - nets[1].params()).abs().max().item()
    log(f"  remat step: loss {nets[0].score_value} vs {nets[1].score_value}"
        f", max param diff {d:.3e} (atol 1e-6)")
    if abs(nets[0].score_value - nets[1].score_value) > 1e-6 * abs(
            nets[0].score_value) or d > 1e-6:
        raise AssertionError("remat=True differs from remat=False")


def phase_train(torch, M, card):
    """Main path 2: full-width bf16 gpt_long training steps via fit."""
    import numpy as np

    fa = M["fa"]
    conf = M["gpt_configuration"](**TRAIN, seed=13)
    net = M["MultiLayerNetwork"](conf, dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device="cuda")
    net.init()
    batches = [M["DataSet"](x, y) for x, y in gpt_batches(
        np, TRAIN["vocab_size"], TRAIN_B, TRAIN_T, TRAIN_STEPS + 2, seed=13)]
    net.fit(batches[0])  # warm-up: cuBLAS handles, allocator, build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    step_ms, losses = [], []
    for ds in batches[1:TRAIN_STEPS + 1]:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(net.score_value)
    counts = {"fwd": fa.flash_forward.launches,
              "dq": fa.flash_bwd_dq.launches,
              "dkv": fa.flash_bwd_dkv.launches}
    plain = (fa.flash_attention_plain_fwd.calls,
             fa.flash_attention_plain_bwd.calls)
    peak = torch.cuda.max_memory_allocated()
    trace = traced(torch, lambda: net.fit(batches[-1]))
    med = sorted(step_ms)[len(step_ms) // 2]
    tokens = TRAIN_B * TRAIN_T
    log(f"  {TRAIN_STEPS} steps of B={TRAIN_B} x T={TRAIN_T}: step ms "
        f"{[round(t, 2) for t in step_ms]}; median {med:.2f} ms, "
        f"{tokens / med * 1e3:.1f} train tokens/s [{card}]")
    log(f"  losses {losses}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes)")
    log(f"  flash launches over the timed steps {counts}, plain calls "
        f"(fwd, bwd) {plain}")
    log(f"  traced step (torch.profiler, not in the step times): {trace}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    want = TRAIN["n_layers"] * TRAIN_STEPS
    if any(c != want for c in counts.values()) or any(plain):
        raise AssertionError(f"expected {want} launches of each flash kernel "
                             f"and no plain call, got {counts}, {plain}")
    del net
    torch.cuda.empty_cache()
    return counts


def flash_work(B, H, T, D, kind):
    """FLOPs and bytes of one causal launch at (B, H, T, D) bf16: the
    T(T+1)/2 visible (query, key) pairs per head, 2*D flops per pair and
    product (2 products forward, 3 for dQ, 4 for dK/dV); each input read
    once and each output written once (L and dsum f32)."""
    pairs = B * H * T * (T + 1) // 2
    slab = B * H * T * D * 2
    stats = B * H * T * 4
    if kind == "fwd":
        return 2 * 2 * D * pairs, 3 * slab + slab + stats
    if kind == "dq":
        return 3 * 2 * D * pairs, 4 * slab + 2 * stats + slab
    return 4 * 2 * D * pairs, 4 * slab + 2 * stats + 2 * slab


def phase_flash_timing(torch, fa, counts):
    """Flash kernels, plain versions and SDPA at the training shape."""
    import torch.nn.functional as F

    B, H, T, D = TRAIN_B, TRAIN["n_heads"], TRAIN_T, \
        TRAIN["d_model"] // TRAIN["n_heads"]
    # first as the training path hands them over: slices of the fused qkv
    # projection, read through their strides
    q, k, v, do = flash_inputs_fused(torch, B, T, H, D, torch.bfloat16,
                                     seed=8)
    if q.is_contiguous() or fa._kernel_ready(q) is not q:
        raise AssertionError("fused qkv slices should reach the kernels "
                             "uncopied")
    got = flash_run(fa, q, k, v, do, True)
    ref = flash_plain_f32(fa, q, k, v, do, True, got)
    err_fused = flash_check(
        torch, fa, got, ref, torch.bfloat16,
        f"B={B} T={T} H={H} D={D} bf16 causal, qkv slices")
    del q, k, v, do, got, ref
    torch.cuda.empty_cache()
    q, k, v, do = flash_inputs(torch, B, T, H, D, torch.bfloat16, seed=9)
    o, lse, dq, dk, dv = flash_run(fa, q, k, v, do, True)
    dsum = fa._dsum(o, do)
    ref = flash_plain_f32(fa, q, k, v, do, True, (o, lse))
    torch.cuda.synchronize()
    err = max(err_fused, flash_check(
        torch, fa, (o, lse, dq, dk, dv), ref, torch.bfloat16,
        f"B={B} T={T} H={H} D={D} bf16 causal (timed shape)"))
    del ref
    torch.cuda.empty_cache()
    ms = {"fwd": time_ms(torch, lambda: fa.flash_forward(q, k, v, True, None,
                                                         with_lse=True)),
          "dq": time_ms(torch, lambda: fa.flash_bwd_dq(q, k, v, do, lse, dsum,
                                                       True, None)),
          "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                         dsum, True, None))}
    plain_fwd = time_ms(torch, lambda: fa.flash_attention_plain_fwd(
        q, k, v, True), iters=10)
    plain_bwd = time_ms(torch, lambda: fa.flash_attention_plain_bwd(
        q, k, v, o, lse, do, True), iters=10)
    torch.cuda.empty_cache()
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(*leaves, is_causal=True).backward(dot)

    lib_bwd = time_ms(torch, sdpa_fwd_bwd) - lib_fwd
    rows = []
    for kind, name in (("fwd", "flash_attention_fwd"),
                       ("dq", "flash_attention_bwd_dq"),
                       ("dkv", "flash_attention_bwd_dkv")):
        flops, nbytes = flash_work(B, H, T, D, kind)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        b_ms = 1e3 * max(t_ops, t_bytes)
        row = {"name": name, "route": "cuda", "source": FLASH_SOURCE,
               "replaces": FLASH_REPLACES[name],
               "launches": int(counts[kind]), "max_abs_err": err,
               "ms": ms[kind],
               "plain_ms": plain_fwd if kind == "fwd" else plain_bwd,
               "bound_ms": b_ms,
               "bound_by": "operations" if t_ops > t_bytes else "bytes",
               "library_ms": lib_fwd if kind == "fwd" else lib_bwd}
        what = ("plain: the whole plain backward; library: SDPA fwd+bwd "
                "minus fwd, both backward kernels together") \
            if kind != "fwd" else "library: SDPA causal forward"
        log(f"  {name}: kernel {ms[kind]:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({row['bound_by']}), "
            f"{flops / ms[kind] / 1e9:.1f} TFLOP/s achieved ({what})")
        rows.append(row)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.transformer import (
        generate,
        gpt_configuration,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.serving.decode_engine import DecodeEngine

    M = dict(generate=generate, gpt_configuration=gpt_configuration,
             MultiLayerNetwork=MultiLayerNetwork, DecodeEngine=DecodeEngine,
             DataSet=DataSet, fa=fa)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi_line()
    log(f"[1/9] card: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    built = cuda_build.build(KERNEL_SOURCES)
    log(f"[2/9] build: {time.perf_counter() - t0:.1f} s for "
        f"{len(built)} source(s)")
    for name, res in built.items():
        for line in ptxas_summary(res.log):
            log(f"  {name}: {line}")

    log("[3/9] paged kernels against their plain versions (TF32 off)")
    phase_kernels(torch, pa)
    log("[4/9] flash kernels against their plain versions (TF32 off)")
    phase_flash(torch, fa)
    log("[5/9] f32 DecodeEngine vs generate, 2 layers, d_model 1024")
    phase_parity(torch, M)
    log("[6/9] f32 training, card (kernels) vs CPU (plain), 1 layer, "
        "d_model 1024, T=1024")
    phase_train_parity(torch, M)
    log("[7/9] serving the 8-layer bf16 GPT at full width")
    launches = phase_serve(torch, M, pa, card)
    log("[8/9] training the 8-layer bf16 gpt_long GPT at full width")
    flash_counts = phase_train(torch, M, card)
    log("[9/9] timing at the serving and training shapes (bf16)")
    rows = phase_timing(torch, pa, launches)
    rows += phase_flash_timing(torch, fa, flash_counts)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
