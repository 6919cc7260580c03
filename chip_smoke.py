#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deeplearning4j_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, about 2-4 minutes on an H100

Phases, each of which makes the script exit non-zero when it fails:

1. card: `nvidia-smi` name and power limit, torch and CUDA versions;
2. build: every CUDA kernel of the serving path from `csrc/` with nvcc
   (one process per source, started together), build seconds;
3. kernels: each kernel against its plain PyTorch version on the card,
   TF32 off, at the serving shapes (decode C=1 with S=8 slots, 8 heads,
   head_dim 128, page 128, 34 pages per slot; prefill chunks C=256; GQA
   with 2 KV heads; f32 and bf16; shuffled page tables, the trash page,
   stale pages past the limit, an inactive lane); the reference is the
   plain version computed in f32 on the same inputs (bf16 cast up), and
   the tolerance atol = rtol = 2e-4 (f32) / 4e-3 (bf16, the output's
   rounding);
4. parity: a 2-layer, full-width (d_model 1024) f32 GPT; the
   `DecodeEngine`'s greedy tokens on the card must equal whole-batch
   `generate` on the card for the same prompts (one-shot and chunked
   prefill);
5. serve: the full-width 8-layer bf16 GPT (vocab 256, d_model 1024,
   8 heads, max_length 4224) behind `DecodeEngine(n_slots=8,
   page_size=128, prefill_chunk=256, prompt_buckets=(128,))` answers
   four 128-token and two 4096-token prompts with 32-128 output tokens,
   three times over (median wall reported); the launch counts are set to
   0 just before and read just after, and
   the kernel must have launched at C=1 and C=256 with no call of the
   plain version; one more batch under torch.profiler gives the device's
   busy time and idle share;
6. timing: CUDA events around each launch (a GPU sleep queued first so
   host overhead is not counted), L2 flushed before each, median of 20
   after warm-up, for the kernel, its plain version and
   `torch.nn.functional.scaled_dot_product_attention` on the gathered
   dense view (the yardstick; the port never calls it), beside the
   bound max(flops / 989 TFLOP/s, bytes / 3.35 TB/s) of this run's data.

Prints one JSON line of per-kernel numbers, then the card's
`nvidia-smi` line, then as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero and prints no result without a CUDA device or outside a
checkout of the repository. Weights and inputs are made from seeds.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

KERNEL_SOURCES = ("paged_attention",)
REPLACES = "deeplearning4j_tpu/ops/pallas_paged_attention.py:77"
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SERVE_REPEATS = 3          # the serving batch runs this many times
SERVE = dict(vocab_size=256, d_model=1024, n_heads=8, n_layers=8,
             max_length=4224)


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
    """One more serving batch under torch.profiler: the device's busy time
    (union of kernel intervals), the batch's host wall inside the trace,
    the idle share, and the kernels with the most device time. The
    profiler is a reading only: one that cannot trace on this machine is
    reported, not fatal. The serving batch itself is part of the main path:
    an engine failure or timeout propagates."""
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
    for r in [eng.submit(p, n) for p, n in zip(prompts, n_tok)]:
        r.result(timeout=900)
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
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.models.transformer import (
        generate,
        gpt_configuration,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.serving.decode_engine import DecodeEngine

    M = dict(generate=generate, gpt_configuration=gpt_configuration,
             MultiLayerNetwork=MultiLayerNetwork, DecodeEngine=DecodeEngine)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi_line()
    log(f"[1/6] card: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    built = cuda_build.build(KERNEL_SOURCES)
    log(f"[2/6] build: {time.perf_counter() - t0:.1f} s for "
        f"{len(built)} source(s)")
    for name, res in built.items():
        for line in res.log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log(f"  {name}: {line.strip()}")

    log("[3/6] kernels against their plain versions (TF32 off)")
    phase_kernels(torch, pa)
    log("[4/6] f32 DecodeEngine vs generate, 2 layers, d_model 1024")
    phase_parity(torch, M)
    log("[5/6] serving the 8-layer bf16 GPT at full width")
    launches = phase_serve(torch, M, pa, card)
    log("[6/6] timing at the serving shapes (bf16)")
    rows = phase_timing(torch, pa, launches)
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
