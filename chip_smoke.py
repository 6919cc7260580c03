#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deeplearning4j_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, a few minutes on an H100

Phases, each of which makes the script exit non-zero when it fails:

1. card: `nvidia-smi` name and power limit, torch and CUDA versions;
2. build: every CUDA source of the port (`csrc/paged_attention.cu`,
   `csrc/flash_attention.cu`, `csrc/lstm.cu`, with the shared header
   `csrc/sm90.cuh`) with nvcc, one process per source, started together;
   build seconds and ptxas' registers and spills of every kernel, the
   wgmma kernels included;
3. paged kernels: the paged-attention kernel against its plain PyTorch
   version on the card, TF32 off, at the serving shapes (decode C=1 with
   S=8 slots, 8 heads, head_dim 128, page 128, 34 pages per slot;
   prefill chunks C=256; GQA with 2 KV heads; f32 and bf16; shuffled page
   tables, the trash page, stale pages past the limit, an inactive lane);
   the reference is the plain version computed in f32 on the same inputs
   (bf16 cast up), tolerance atol = rtol = 2e-4 (f32) / 4e-3 (bf16); also
   the ragged row tiles, C=5 and C=3 x 4 query heads per KV head, where
   the last tile of a block holds fewer rows than its width; then the
   int8 kernel on int8 pools with f32 scale pools (scales drawn in
   0.005-0.02) at decode C=1, verify C=5, chunks C=128 and C=256 and GQA
   at C=1 and C=3, q in f32 and bf16, against the plain version in f32
   that rounds the dequantized K/V to q's type as the kernel does, same
   tolerances, and at a decode with sharp scores (q x16: the softmax
   magnifies any error in the dequantized K); both families also at
   head_dim 256 with pages of 256 and 128, head_dim 128 with pages of 512,
   and head_dim 64 and 128 with pages of 1 and 2 positions (decode,
   verify and chunk widths);
4. flash kernels: forward (O and L), dQ and dK/dV against the plain
   versions computed in f32 on the same inputs (the backward's include
   the O and L the forward kernel gave), f32 and bf16, causal and not,
   D = 128, 256, 384 and 512, T = 128 (D = 128: one or two tiles), 512,
   2048 and 4096, Tq = 512 with Tk = 1024 (bf16 D = 128 runs the three
   wgmma kernels; f32 the split-TF32 kernels, but for the backward at
   D = 384 and 512); each backward run twice, with bit-identical dQ, dK
   and dV
   (no atomics); and a GQA call through
   `multi_head_attention` with autograd against the same call on the
   CPU; O, dQ, dK, dV held row by row (a row's largest error within
   `flash_attention.TOLERANCE`, 1e-4 f32 / 2^-6 bf16, of that row's
   largest reference magnitude, or of the median row's where larger),
   L within 1e-4 absolute;
5. parity: a 2-layer, full-width (d_model 1024) f32 GPT; the
   `DecodeEngine`'s greedy tokens on the card must equal whole-batch
   `generate` on the card for the same prompts (one-shot and chunked
   prefill); the engine with `prefix_cache=True, speculative={"draft":
   "self", "k": 4}` must give the same, cold and on a prefix hit; the
   same engine with `quantize={"kv": "int8"}` on the card is held to
   itself on the CPU (argmax drift at most 0.2, printed);
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
   128-token and two 4096-token prompts with 32-128 output tokens; the
   launch counts are set to 0 just before and read just after, and the
   dense kernel must have launched at C=1 and C=256 with no call of the
   plain version and no int8 launch; one more batch under
   torch.profiler gives the device's busy time and idle share;
8. serve (main path 3): the same network behind the same engine with
   `quantize={"kv": "int8"}, prefix_cache=True, speculative={"draft":
   "self", "k": 4}` serves shared-prefix chat traffic (one 1024-token
   prefix plus a unique 64-token tail per request, 32 or 64 output
   tokens): the first request alone, cold, then eight in one closed
   batch, which hit its pages; counts set to 0 before and read after:
   the int8 kernel must have launched at C=1 (draft steps), C=5 (verify)
   and at a prefill chunk width, the dense kernel and the plain version
   not at all; `prefix_hit_tokens_pct` > 0, `spec_tokens_per_step` > 1;
9. train (main path 2): the full-width bf16 `gpt_long` network (vocab 256,
   d_model 1024, 8 heads of 128, 8 layers, max_length 4096,
   attention_block_size 512, Adam 3e-4, f32 masters) fed B=8 x T=4096
   batches made with numpy from a seed through `MultiLayerNetwork.fit`:
   1 warm-up step, then 5 timed steps (step ms, tokens/s, each loss, which
   must be finite, peak device memory); the flash launch counts are set
   to 0 just before the timed steps and read just after: 8 forward, 8 dQ
   and 8 dK/dV launches per step, all on the wgmma route
   (`flash_attention.launches_by_route`), and no call of a plain version;
   one more step under torch.profiler gives the busy time, idle share and
   top kernels;
10. train f32 (path 2f): the same gpt_long network in f32
   (`compute_dtype=None`, `MultiLayerNetwork`'s default) at B=1 x T=4096:
   1 warm-up step, then 3 timed steps (step ms, tokens/s, losses, peak
   device memory); counts set to 0 before and read after: 8 forward, 8 dQ
   and 8 dK/dV launches per step, all on the split-TF32 route
   (`flash_attention.launches_by_route`), no plain call; one more step
   under torch.profiler;
11. LSTM kernels: the forward (with its training stash) and backward
   kernels, unmasked and masked, forward and reverse, against the plain
   versions on the card (TF32 off), f32 and bf16, every case of
   `lstm_cases` (H = 128 to 2048, a ragged 196 and odd 195 and 385, B = 8
   to 8192, T = 1 to 64, both bf16 forward routes, f32 at H=1024, B=2048
   and at H=2048; nonzero h0, c0 and peepholes; masks with ragged
   lengths, a row never masked, a row masked from t=0 and a hole; the
   backward on the forward kernel's own stash), every output held row by
   row (`lstm.error_in_tolerances`: 1e-4 f32, 2^-6 bf16, of the row's
   largest |ref|); the f32 kernels (split TF32, two forward passes a
   block at H=2048) run twice with bit-identical outputs, and the split-TF32
   forward and backward on one step whose product cancels (partial sums
   about 30 times the result: a tensor-core sum chained over all of K
   lands outside the tolerance) against the plain version in f64; H
   above 2048 refused before any launch, naming why;
   the launch plans (route, tile, cluster size, clusters that fit,
   waves) at the main paths' shapes; `lstm_fused` with autograd on the
   card against the same call on the CPU (out, hT, cT, dx, dW, dRW, db,
   dpeep, dh0, dc0);
12. LSTM training parity: a 2-layer f32 char-RNN (vocab 64, H=256, B=16,
   T=32, RMSPROP lr 0.01) from one set of weights, 3 steps on the card and
   on the CPU: losses rtol 1e-5, params rtol 1e-5 + atol 1e-4; a tBPTT
   fit (windows 12, 12 and a masked tail) and a bidirectional fit: losses
   rtol 1e-5; `rnn_time_step` on the card equals `output` within 1e-5;
13. train (main path 4): bench.py's `lstm_large` char-RNN at full width
   (vocab 256, two GravesLSTM(1024), RMSPROP, bf16 compute over f32
   masters, OneHotEncoder(256) on uint8 ids, B=2048 x T=64, seed 1):
   1 warm-up step, then 5 timed steps (step ms, samples/s, each loss,
   finite, peak device memory); counts set to 0 before and read after: 2
   forward and 2 backward unmasked launches per step, no masked launch,
   no call of a plain version; one more step under torch.profiler;
14. train (main path 4b): bench.py's `lstm` char-RNN at full width (vocab
   64, H=256, B=8192 x T=64) with tBPTT 24, one-hot rows as features:
   after a warm-up fit, one fit of one batch (wall time); counts: 4
   unmasked and 2 masked forward launches, the same backward, no plain
   call; one more fit under torch.profiler;
15. train f32 (path 4f): the `lstm_large` network of phase 13 with no
   `compute_dtype` (f32, `MultiLayerNetwork`'s default) at full width
   (B=2048 x T=64, H=1024, vocab 256, uint8 ids through the
   OneHotEncoder): 1 warm-up step, then 3 timed steps (step ms,
   samples/s, losses, peak device memory); counts set to 0 before and
   read after: 2 forward and 2 backward unmasked launches per step, all
   on the split-TF32 route (`lstm.launches_by_route`), no plain call; one
   more step under torch.profiler (idle share, top kernels);
16. timing: the flash kernels are first held to their plain versions at
   the training shape twice: on q/k/v sliced from one fused qkv tensor,
   as the training path passes them (the backward twice, bit-identical),
   and on contiguous ones; then CUDA
   events around each launch (a GPU sleep queued first so
   host overhead is not counted), L2 flushed before each, median of 20
   after warm-up, for each kernel, its plain version and a library call
   (`scaled_dot_product_attention` on the gathered dense view for paged
   attention, for int8 pools with the dequantization inside the timed
   region, since the kernel does it too; SDPA's forward, and SDPA's
   forward+backward minus its forward for the two backward kernels
   together; the yardsticks, which the port never calls), beside the bound max(flops / 989 TFLOP/s,
   bytes / 3.35 TB/s) of this run's data, and each flash kernel's
   achieved TFLOP/s beside the library's, also at head_dim 256, 384 and
   512 (B=2, H=4, T=2048) and for the f32 kernels at phase 6's shape (B=2,
   H=8, T=1024, D=128), at path 2f's (B=1, H=8, T=4096, with path 2f's
   launch counts) and at head dims 256, 384 and 512 (B=2, H=4, T=2048;
   the backward at 384 and 512 on the scalar kernels); SDPA in f32, TF32
   off; bound 3 x flops / 495 TFLOP/s for the split-TF32 route, the
   f32-FMA bound printed beside it; the
   int8 kernel also at a
   C=128 chunk; each paged
   case with its launch plan (route, slice, splits);
17. LSTM timing: rows 5-8 at main path 4's shape (T=64, B=2048, H=1024,
   unmasked) and main path 4b's window (T=24, B=8192, H=256, unmasked and
   masked), bf16, the same way, beside their plain versions, the bound
   (2*T*B*H*4H flops; each input read and each output written once) and
   cuDNN's LSTM as yardstick (`torch.nn.LSTM`: no peepholes, its own input
   GEMM; forward minus one input matmul, and fwd+bwd minus fwd), with
   each launch plan; the two bf16 forward routes at their boundary (T=64,
   H=1024, B=128 cooperative and B=129 clusters, with and without the
   stash); the f32 kernels (split TF32) at T=8, B=2048, H=1024, at path
   4f's shape (T=64, with its launch counts) and masked at path 4b's
   window, against cuDNN in f32 (TF32 off), bound 3 x flops / 495
   TFLOP/s or the bytes, the f32-FMA bound printed beside it; every
   row's outputs held to the plain versions within the tolerance first;
18. a sigmoid/tanh LSTM wider than the fused kernels take (H=2304 >
   `ops.lstm.MAX_H`): `lstm_forward` takes its step loop on the card
   (route counts set to 0 before and read after: loop > 0, fused 0, no
   kernel launch); one layer's outputs and gradients, f32 and bf16,
   against the f32 loop on the CPU; a GravesLSTM(2304) network's 2 SGD
   fit steps against the CPU (losses rtol 1e-5, params atol 1e-5).

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

KERNEL_SOURCES = ("paged_attention", "flash_attention", "lstm")
REPLACES = "deeplearning4j_tpu/ops/pallas_paged_attention.py:77"
FLASH_SOURCE = "deeplearning4j_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_attention_fwd": "deeplearning4j_tpu/ops/pallas_attention.py:97",
    "flash_attention_bwd_dq": "deeplearning4j_tpu/ops/pallas_attention.py:153",
    "flash_attention_bwd_dkv":
        "deeplearning4j_tpu/ops/pallas_attention.py:183"}
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SERVE_REPEATS = 1          # the serving batch runs this many times
SHARED_PREFIX, SHARED_TAIL, SHARED_REQUESTS = 1024, 64, 8
SERVE = dict(vocab_size=256, d_model=1024, n_heads=8, n_layers=8,
             max_length=4224)
# bench.py gpt_long (bench.py:563-568)
TRAIN = dict(vocab_size=256, d_model=1024, n_heads=8, n_layers=8,
             max_length=4096, attention_block_size=512, dropout=0.0)
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 4096, 5
# path 2f: the same network in f32 (MultiLayerNetwork's default precision)
TRAIN_F32_B, TRAIN_F32_STEPS = 1, 3


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- inputs
def paged_inputs(torch, *, S, C, H, Hkv, hd, page, n_pages, dtype, seed,
                 positions, inactive=(), garbage=True, int8=False,
                 q_scale=1.0):
    """Pools, a shuffled page table, positions and an active mask. Pages
    past each slot's last live page are either remapped to the trash
    page 0 (odd slots) or left pointing at stale pages (even slots);
    both, and page 0, hold large garbage that must never reach an
    output. `int8`: int8 pools drawn from -127..127 with f32 scale pools
    drawn from 0.005..0.02 (garbage pages: +-127 under scales of 1e3).
    `q_scale` multiplies q (sharp softmaxes: small errors in K show)."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    P = S * n_pages + 3
    scales = {}
    if int8:
        k_pool, v_pool = (
            torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
            for shape in ((P + 1, Hkv, hd, page), (P + 1, Hkv, page, hd)))
        for name in ("k_scale", "v_scale"):
            scales[name] = 0.005 + 0.015 * torch.rand(
                (P + 1, Hkv, page), generator=g, device=dev)
        junk = ((127, -127), (127, -127))
    else:
        k_pool = torch.randn((P + 1, Hkv, hd, page), generator=g, device=dev)
        v_pool = torch.randn((P + 1, Hkv, page, hd), generator=g, device=dev)
        junk = ((1e4, -1e4), (3e3, -3e3))
    perm = torch.randperm(P, generator=g, device=dev)[:S * n_pages] + 1
    pt = perm.reshape(S, n_pages).to(torch.int32)
    if garbage:
        k_pool[0], v_pool[0] = junk[0]
        for sc in scales.values():
            sc[0] = 1e3
        for s in range(S):
            last = min(n_pages - 1, (positions[s] + C - 1) // page)
            tail = pt[s, last + 1:]
            if tail.numel():
                k_pool[tail.long()], v_pool[tail.long()] = junk[1]
                for sc in scales.values():
                    sc[tail.long()] = 1e3
                if s % 2:
                    pt[s, last + 1:] = 0
    q = torch.randn((S, C, H, hd), generator=g, device=dev) * q_scale
    active = torch.ones((S,), dtype=torch.bool, device=dev)
    for s in inactive:
        active[s] = False
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    if not int8:
        k_pool, v_pool = k_pool.to(dtype), v_pool.to(dtype)
    return dict(q=q.to(dtype).contiguous(), k_pool=k_pool, v_pool=v_pool,
                page_table=pt.contiguous(), positions=pos, active=active,
                **scales)


def scale_kw(inp) -> dict:
    """The scale pools of int8 inputs as keywords; none for dense pools."""
    return {k: inp[k] for k in ("k_scale", "v_scale") if k in inp}


def work(inp):
    """FLOPs and bytes this call needs on its data. Row c of an active
    slot s attends to min(positions[s]+c, L-1)+1 keys (QK and PV, 2 flops
    per MAC). Bytes: of each active slot, the K and V entries
    0..min(positions[s]+C-1, L-1) of every KV head, the page-table entries
    of the pages holding them and its q rows, each read once; the whole
    output written once; positions and the active mask. int8 pools: 1
    byte per K/V element plus 4 per (KV head, position) scale of K and of
    V."""
    q, kp = inp["q"], inp["k_pool"]
    S, C, H, hd = q.shape
    Hkv, page = kp.shape[1], kp.shape[3]
    L = inp["page_table"].shape[1] * page
    isz, kvsz = q.element_size(), kp.element_size()
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
        nbytes += 2 * (last + 1) * Hkv * hd * kvsz  # K and V entries
        if "k_scale" in inp:
            nbytes += 2 * (last + 1) * Hkv * 4        # their scales
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
    exactly): the reference the kernel is held to. int8 pools are
    dequantized in f32 and rounded to q's type, as the kernel rounds
    them, before the f32 products."""
    return pa.paged_attention_plain(
        inp["q"].float(), inp["k_pool"] if "k_scale" in inp
        else inp["k_pool"].float(), inp["v_pool"] if "k_scale" in inp
        else inp["v_pool"].float(), inp["page_table"], inp["positions"],
        inp["active"], kv_dtype=inp["q"].dtype, **scale_kw(inp))


def paged_cases(torch):
    """The kernel checks: (name, keywords of `paged_inputs`). Dense pools
    at the serving widths and at the ragged row tiles; int8 pools at the
    decode, verify and chunk widths, MHA and GQA; both at head dims 64 and
    256 and pages of 1, 2, 256 and 512 positions."""
    base = dict(H=8, hd=128, page=128, n_pages=34)
    decode_pos = [0, 1, 127, 128, 1000, 2047, 4222, 4351]
    verify_pos = [0, 1, 125, 128, 1000, 2047, 4222, 4347]
    shapes = [
        ("decode C=1 MHA", dict(S=8, C=1, Hkv=8, positions=decode_pos,
                                inactive=(5,))),
        ("chunk C=256 MHA", dict(S=1, C=256, Hkv=8, positions=[3840])),
        ("decode C=1 GQA Hkv=2", dict(S=8, C=1, Hkv=2, positions=decode_pos,
                                      inactive=(2,))),
        ("chunk C=256 GQA Hkv=2", dict(S=1, C=256, Hkv=2, positions=[1000])),
        # ragged row tiles: 5 rows in tiles of 4, 12 rows in tiles of 8
        ("verify C=5 MHA", dict(S=8, C=5, Hkv=8, positions=verify_pos,
                                inactive=(5,))),
        ("verify C=3 GQA Hkv=2", dict(S=8, C=3, Hkv=2, positions=verify_pos,
                                      inactive=(2,))),
    ]
    # pages and head dims the kernels took whole before (shared memory
    # of whole pages): key slices now
    shapes += [
        ("hd=256 page=256 chunk C=256", dict(
            S=1, C=256, Hkv=8, hd=256, page=256, n_pages=9,
            positions=[1500])),
        ("hd=256 page=256 decode GQA", dict(
            S=4, C=1, Hkv=2, hd=256, page=256, n_pages=9,
            positions=[0, 300, 1500, 2047], inactive=(1,))),
        ("hd=128 page=512 chunk C=256 GQA", dict(
            S=1, C=256, Hkv=2, page=512, n_pages=5, positions=[1800])),
        ("hd=128 page=512 decode", dict(
            S=4, C=1, Hkv=8, page=512, n_pages=5,
            positions=[0, 511, 512, 2000])),
        ("hd=256 page=128 verify C=5", dict(
            S=4, C=5, H=4, Hkv=4, hd=256, n_pages=8,
            positions=[0, 127, 700, 1000])),
        ("hd=64 page=1 decode GQA", dict(
            S=3, C=1, H=4, Hkv=2, hd=64, page=1, n_pages=80,
            positions=[0, 40, 79])),
        ("hd=64 page=2 verify C=5 GQA", dict(
            S=3, C=5, H=4, Hkv=2, hd=64, page=2, n_pages=50,
            positions=[0, 40, 94])),
        ("hd=128 page=2 chunk C=40", dict(
            S=1, C=40, H=4, Hkv=4, page=2, n_pages=60, positions=[50])),
    ]
    int8_only = [
        ("chunk C=128 MHA", dict(S=1, C=128, Hkv=8, positions=[1024])),
        # scores of std ~14: the softmax magnifies any error in K, so the
        # rounding point of the dequantized values shows
        ("decode C=1 MHA sharp (q x16)", dict(
            S=4, C=1, Hkv=8, n_pages=12, positions=[5, 300, 900, 1400],
            q_scale=16.0)),
    ]
    cases = []
    for int8 in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for name, kw in shapes + (int8_only if int8 else []):
                cases.append((f"{'int8 ' if int8 else ''}{name}",
                              dict(base, **dict(kw, dtype=dtype, int8=int8))))
    return cases


def paged_case_error(torch, pa, kw, seed):
    """One kernel call against the plain version: (largest absolute
    error, largest error in units of atol + rtol * |ref| with the
    dtype's tolerance, whether finite and every inactive lane zero)."""
    inp = paged_inputs(torch, seed=seed, **kw)
    out = pa.paged_attention(inp["q"], inp["k_pool"], inp["v_pool"],
                             inp["page_table"], inp["positions"],
                             active=inp["active"], **scale_kw(inp))
    ref = plain_f32(pa, inp)
    torch.cuda.synchronize()
    t = pa.TOLERANCE[kw["dtype"]]
    diff = (out.float() - ref).abs()
    clean = bool(torch.isfinite(out.float()).all()) and all(
        bool((out[s] == 0).all()) for s in kw.get("inactive", ()))
    return (diff.max().item(), (diff / (t + t * ref.abs())).max().item(),
            clean)


def phase_kernels(torch, pa):
    """Kernels against plain at the serving shapes."""
    for i, (name, kw) in enumerate(paged_cases(torch)):
        err, units, clean = paged_case_error(torch, pa, kw, seed=100 + i)
        ok = clean and units <= 1.0
        log(f"  {name:<30} q {str(kw['dtype'])[6:]:<9} max_abs_err={err:.3e} "
            f"({units:.3f} of tolerance {pa.TOLERANCE[kw['dtype']]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with plain: {name} "
                                 f"{kw['dtype']} max_abs_err={err}")


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
    phase_parity_tier(torch, M, net, rng)


def phase_parity_tier(torch, M, net, rng):
    """The latency and quantization tier on the same f32 network: prefix
    cache + self-speculation give `generate`'s greedy tokens, cold and on
    a prefix hit; with int8 KV the card is held to the CPU."""
    import numpy as np

    V = SERVE["vocab_size"]
    prefix = rng.integers(0, V, 256)
    prompts = [np.concatenate([prefix, rng.integers(0, V, 40)])
               for _ in range(3)] + [rng.integers(0, V, 100)]
    n_tok = 12
    kw = dict(n_slots=4, page_size=128, prefill_chunk=256,
              prompt_buckets=(128,), max_len=1024, prefix_cache=True,
              speculative={"draft": "self", "k": 4})

    def serve(engine_net, device, **extra):
        eng = M["DecodeEngine"](engine_net, device=device, **kw, **extra)
        try:
            first = eng.generate(prompts[0], n_tok)     # cold: fills the cache
            reqs = [eng.submit(p, n_tok) for p in prompts[1:]]
            return [first] + [r.result(timeout=300) for r in reqs], \
                eng.stats()
        finally:
            eng.shutdown()

    got, st = serve(net, "cuda")
    for p, g in zip(prompts, got):
        exp = M["generate"](net, p[None], n_tok, temperature=0.0,
                            device="cuda")[0]
        if not np.array_equal(g, exp):
            raise AssertionError(
                f"prefix + speculative engine tokens differ from generate "
                f"for the {len(p)}-token prompt: {g.tolist()} vs "
                f"{exp.tolist()}")
    pc = st["prefix_cache"]
    if pc["hits"] < 2 or st["spec_tokens_per_step"] <= 1:
        raise AssertionError(f"expected prefix hits and multi-token verify "
                             f"steps, stats {st}")
    log(f"  prefix cache + self-speculation (k=4) == generate on "
        f"{len(prompts)} prompts: hits {pc['hits']}, misses {pc['misses']}, "
        f"spec_accept_rate {st['spec_accept_rate']}, spec_tokens_per_step "
        f"{st['spec_tokens_per_step']}")
    cpu = M["MultiLayerNetwork"](net.conf, device="cpu")
    cpu.set_param_tree([{k: v.cpu() for k, v in p.items()}
                        for p in net._params])
    card_toks, st8 = serve(net, "cuda", quantize={"kv": "int8"})
    cpu_toks, _ = serve(cpu, "cpu", quantize={"kv": "int8"})
    drift = float(np.mean([np.mean(a != b)
                           for a, b in zip(card_toks, cpu_toks)]))
    log(f"  int8 KV + prefix + speculation, card vs CPU: argmax drift "
        f"{drift:.4f} (bound 0.2), kv_bytes_per_token "
        f"{st8['kv_bytes_per_token']}, spec_accept_rate "
        f"{st8['spec_accept_rate']}")
    if drift > 0.2 or st8["kv_quant_bits"] != 8:
        raise AssertionError(f"int8 engine on the card drifts {drift} from "
                             "the CPU")


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
        launches = dict(pa.paged_attention.launches_by)
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
    if launches.get((1, "dense"), 0) == 0 \
            or launches.get((256, "dense"), 0) == 0:
        raise AssertionError(f"kernel not launched on both paths: {launches}")
    if plain_calls or any(kind != "dense" for _, kind in launches):
        raise AssertionError(f"plain version called {plain_calls} times, "
                             f"launches {launches}, on the card's main path")
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_serve_tier(torch, M, pa, card):
    """Main path 3: the same network behind int8 KV, the prefix cache and
    self-speculation, on shared-prefix chat traffic."""
    import numpy as np

    conf = M["gpt_configuration"](**SERVE, seed=11)
    net = M["MultiLayerNetwork"](conf, dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device="cuda")
    net.init()
    eng = M["DecodeEngine"](net, n_slots=8, page_size=128, prefill_chunk=256,
                            prompt_buckets=(128,), max_len=4224,
                            quantize={"kv": "int8"}, prefix_cache=True,
                            speculative={"draft": "self", "k": 4},
                            device="cuda")
    rng = np.random.default_rng(12)
    V = SERVE["vocab_size"]
    prefix = rng.integers(0, V, SHARED_PREFIX)
    prompts = [np.concatenate([prefix, rng.integers(0, V, SHARED_TAIL)])
               for _ in range(SHARED_REQUESTS + 1)]
    n_tok = [int(x) for x in rng.choice((32, 64), SHARED_REQUESTS + 1)]
    try:
        eng.generate(rng.integers(0, V, 16), 4)  # warm-up: cuBLAS handles
        torch.cuda.synchronize()
        before = eng.stats()
        pa.reset_counts()
        t0 = time.perf_counter()
        outs = [eng.generate(prompts[0], n_tok[0], timeout=600)]  # cold
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reqs = [eng.submit(p, n) for p, n in zip(prompts[1:], n_tok[1:])]
        outs += [r.result(timeout=900) for r in reqs]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(pa.paged_attention.launches_by)
        plain_calls = pa.paged_attention_plain.calls
        st = eng.stats()
        trace = traced_batch(torch, eng, prompts[1:], n_tok[1:])
    finally:
        eng.shutdown()
    for o, n in zip(outs, n_tok):
        if o.shape != (n,) or o.min() < 0 or o.max() >= V:
            raise AssertionError(f"bad output tokens {o.shape} for n={n}")
    pc0, pc = before["prefix_cache"], st["prefix_cache"]
    hit_pct = 100.0 * (pc["hit_tokens"] - pc0["hit_tokens"]) \
        / (pc["prompt_tokens"] - pc0["prompt_tokens"])
    sp0, sp = before["speculative"], st["speculative"]
    steps = sp["verify_steps"] - sp0["verify_steps"]
    per_step = (sp["emitted"] - sp0["emitted"]) / max(1, steps)
    accept = 100.0 * (sp["accepted"] - sp0["accepted"]) \
        / max(1, sp["proposed"] - sp0["proposed"])
    toks = int(sum(n_tok[1:]))
    log(f"  cold request ({len(prompts[0])}-token prompt, {n_tok[0]} "
        f"outputs): wall {t1 - t0:.4f} s; then {SHARED_REQUESTS} requests "
        f"in one closed batch (outputs {n_tok[1:]}): wall {t2 - t1:.4f} s, "
        f"{toks / (t2 - t1):.1f} generated tokens/s [{card}]")
    log(f"  spec_accept_rate {accept:.1f}%, spec_tokens_per_step "
        f"{per_step:.3f} over {steps} verify steps, prefix_hit_tokens_pct "
        f"{hit_pct:.1f}, kv_bytes_per_token {st['kv_bytes_per_token']} "
        f"(kv_quant_bits {st['kv_quant_bits']}), prefill_chunks "
        f"{st['prefill_chunks'] - before['prefill_chunks']}")
    log(f"  paged_attention launches by (chunk width, pools): {launches}; "
        f"plain calls: {plain_calls}")
    log(f"  traced batch (torch.profiler, not in tokens/s): {trace}")
    chunk_widths = [c for (c, kind), n in launches.items()
                    if kind == "int8" and c >= 128 and n > 0]
    if launches.get((1, "int8"), 0) == 0 \
            or launches.get((5, "int8"), 0) == 0 or not chunk_widths:
        raise AssertionError(f"int8 kernel not launched at the draft, verify "
                             f"and prefill-chunk widths: {launches}")
    if plain_calls or any(kind != "int8" for _, kind in launches):
        raise AssertionError(f"plain version called {plain_calls} times, "
                             f"launches {launches}, on the int8 main path")
    if not (hit_pct > 0 and per_step > 1):
        raise AssertionError(f"no prefix hit ({hit_pct}) or no multi-token "
                             f"verify step ({per_step})")
    del eng
    torch.cuda.empty_cache()
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


def sdpa_yardstick(torch, inp):
    """One library call that computes the same function: SDPA on the
    gathered dense view. For int8 pools the gather and dequantization
    run inside the timed function, since the kernel does them too."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops.attention import (
        paged_gather,
        paged_gather_quant,
    )

    Cq = inp["q"].shape[1]
    L = inp["page_table"].shape[1] * inp["k_pool"].shape[3]
    qd = inp["q"].permute(0, 2, 1, 3).contiguous()          # (S, H, C, hd)
    qpos = inp["positions"][:, None].long() \
        + torch.arange(Cq, device="cuda")[None, :]
    mask = (torch.arange(L, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]                   # (S, 1, C, L)
    if "k_scale" in inp:
        def dequantized():
            kd, vd = paged_gather_quant(
                inp["k_pool"], inp["v_pool"], inp["k_scale"], inp["v_scale"],
                inp["page_table"], inp["q"].dtype)
            return F.scaled_dot_product_attention(
                qd, kd.transpose(-1, -2), vd, attn_mask=mask)

        return dequantized
    kd, vd = paged_gather(inp["k_pool"], inp["v_pool"], inp["page_table"])
    kt = kd.transpose(-1, -2).contiguous()                  # (S, Hkv, L, hd)
    return lambda: F.scaled_dot_product_attention(qd, kt, vd, attn_mask=mask)


def phase_timing(torch, pa, launches):
    """Kernel / plain / library times at the serving shapes, bf16 q."""
    serving = dict(H=8, Hkv=8, hd=128, page=128, n_pages=34)
    decode = dict(S=8, C=1, positions=[4160, 4160, 192, 192, 192, 192, 0, 0],
                  inactive=(6, 7))
    chunk = dict(S=1, C=256, positions=[3840])
    # main path 3's slots: a 1088-token prompt and 32-64 outputs each
    tier_pos = [1100, 1110, 1120, 1130, 1140, 1100, 1110, 1120]
    shapes = [
        ("paged_attention_decode", "dense", decode),
        ("paged_attention_prefill_chunk", "dense", chunk),
        ("paged_attention_int8_decode", "int8", dict(S=8, C=1,
                                                     positions=tier_pos)),
        ("paged_attention_int8_verify", "int8", dict(S=8, C=5,
                                                     positions=tier_pos)),
        ("paged_attention_int8_prefill_chunk", "int8",
         dict(S=1, C=256, positions=[768])),
        ("paged_attention_int8_prefill_chunk_c128", "int8",
         dict(S=1, C=128, positions=[1024])),
    ]
    rows = []
    for name, kind, sh in shapes:
        kw = dict(serving, dtype=torch.bfloat16, seed=7, garbage=False, **sh)
        inp = paged_inputs(torch, int8=kind == "int8", **kw)
        args = (inp["q"], inp["k_pool"], inp["v_pool"], inp["page_table"],
                inp["positions"])
        sc = scale_kw(inp)
        out = pa.paged_attention(*args, active=inp["active"], **sc)
        ref = plain_f32(pa, inp)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        t = pa.TOLERANCE[torch.bfloat16]
        if not torch.allclose(out.float(), ref, atol=t, rtol=t):
            raise AssertionError(f"{name}: kernel disagrees with plain, "
                                 f"max_abs_err={err} (tolerance {t})")
        ms = time_ms(torch, lambda: pa.paged_attention(
            *args, active=inp["active"], **sc))
        plain_ms = time_ms(torch, lambda: pa.paged_attention_plain(
            *args, inp["active"], **sc))
        lib_ms = time_ms(torch, sdpa_yardstick(torch, inp))
        host = host_us(torch, lambda: pa.paged_attention(
            *args, active=inp["active"], **sc))
        b_ms, b_by = bound_ms(inp)
        row = {"name": name, "route": "cuda",
               "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
               "replaces": REPLACES,
               "launches": int(launches.get((sh["C"], kind), 0)),
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        extra = ""
        if kind == "int8":  # the dense kernel on bf16 pools, same positions
            dense = paged_inputs(torch, **kw)
            dense_ms = time_ms(torch, lambda: pa.paged_attention(
                dense["q"], dense["k_pool"], dense["v_pool"],
                dense["page_table"], dense["positions"],
                active=dense["active"]))
            extra = f", dense kernel on bf16 pools {dense_ms:.4f} ms"
        S, C, H, hd = inp["q"].shape
        Hkv, page = inp["k_pool"].shape[1], inp["k_pool"].shape[3]
        plan = pa.plan(True, kind == "int8", S, C, H, Hkv, hd, page,
                       inp["page_table"].shape[1],
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"max_abs_err {err:.3e}; wrapper host time {host:.1f} us/call"
            f"{extra}; {plan}")
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


def flash_same_bits(torch, fa, q, k, v, do, causal, got, what):
    """Run the backward kernels again on the same inputs and require dQ,
    dK and dV bit for bit equal to `got`'s (no atomics: each block writes
    its own rows in a fixed order)."""
    again = flash_run(fa, q, k, v, do, causal)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(got[2:], again[2:])]
    if not all(same):
        raise AssertionError(f"flash backward not bitwise deterministic "
                             f"(dQ, dK, dV equal: {same}): {what}")


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
    cases += [(1, 4096, 2, 128, torch.float32, False)]
    # one 128-row tile: the D = 128 kernels' diagonal tiles alone
    cases += [(2, 128, 2, 128, dt, causal)
              for dt in (torch.float32, torch.bfloat16)
              for causal in (False, True)]
    cases += [(1, 4096, 2, 256, torch.bfloat16, False)]
    # head dims 384 and 512: the output columns split over blocks, 32-key
    # streamed tiles (bf16), 16-key tiles (f32 forward), 16-row tiles (f32
    # backward, scalar)
    cases += [(1, 512, 2, D, dt, causal)
              for dt in (torch.float32, torch.bfloat16)
              for D in (384, 512) for causal in (False, True)]
    cases += [(1, 2048, 2, 512, torch.bfloat16, True)]
    for i, (B, T, H, D, dt, causal) in enumerate(cases):
        q, k, v, do = flash_inputs(torch, B, T, H, D, dt, seed=40 + i)
        got = flash_run(fa, q, k, v, do, causal)
        ref = flash_plain_f32(fa, q, k, v, do, causal, got)
        torch.cuda.synchronize()
        what = (f"B={B} T={T} H={H} D={D} {str(dt)[6:]} "
                f"{'causal' if causal else 'full'}")
        errs[dt] = max(errs.get(dt, 0.0), flash_check(torch, fa, got, ref,
                                                      dt, what))
        flash_same_bits(torch, fa, q, k, v, do, causal, got, what)
    for i, dt in enumerate((torch.float32, torch.bfloat16)):
        # queries and keys of different lengths: separate tensor maps and
        # key tiles past the query tiles
        q, do = flash_inputs(torch, 2, 512, 2, 128, dt, seed=70 + i)[:2]
        k, v = flash_inputs(torch, 2, 1024, 2, 128, dt, seed=72 + i)[:2]
        got = flash_run(fa, q, k, v, do, False)
        ref = flash_plain_f32(fa, q, k, v, do, False, got)
        torch.cuda.synchronize()
        what = f"B=2 Tq=512 Tk=1024 H=2 D=128 {str(dt)[6:]} full"
        errs[dt] = max(errs[dt], flash_check(torch, fa, got, ref, dt, what))
        flash_same_bits(torch, fa, q, k, v, do, False, got, what)
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


def phase_train(torch, M, card, compute_dtype, B, steps, seed, route):
    """Main path 2 (bf16 compute over f32 masters) or 2f (f32, the
    default): full-width gpt_long training steps via fit at B x T=4096:
    1 warm-up step, the median of `steps` timed steps, the flash launch
    counts over them (8 of each kernel a step, all on `route`, no plain
    call), one more step under torch.profiler."""
    import numpy as np

    fa = M["fa"]
    conf = M["gpt_configuration"](**TRAIN, seed=13)
    net = M["MultiLayerNetwork"](conf, dtype=torch.float32,
                                 compute_dtype=compute_dtype, device="cuda")
    net.init()
    batches = [M["DataSet"](x, y) for x, y in gpt_batches(
        np, TRAIN["vocab_size"], B, TRAIN_T, steps + 2, seed=seed)]
    net.fit(batches[0])  # warm-up: cuBLAS handles, allocator, build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    step_ms, losses = [], []
    for ds in batches[1:steps + 1]:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(net.score_value)
    counts = {"fwd": fa.flash_forward.launches,
              "dq": fa.flash_bwd_dq.launches,
              "dkv": fa.flash_bwd_dkv.launches}
    routes = dict(fa.launches_by_route)
    plain = (fa.flash_attention_plain_fwd.calls,
             fa.flash_attention_plain_bwd.calls)
    peak = torch.cuda.max_memory_allocated()
    trace = traced(torch, lambda: net.fit(batches[-1]))
    med = sorted(step_ms)[len(step_ms) // 2]
    tokens = B * TRAIN_T
    log(f"  {steps} steps of B={B} x T={TRAIN_T} "
        f"({str(compute_dtype or torch.float32)[6:]}): step ms "
        f"{[round(t, 2) for t in step_ms]}; median {med:.2f} ms, "
        f"{tokens / med * 1e3:.1f} train tokens/s [{card}]")
    log(f"  losses {losses}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes)")
    log(f"  flash launches over the timed steps {counts}, by route "
        f"{routes}, plain calls (fwd, bwd) {plain}")
    log(f"  traced step (torch.profiler, not in the step times): {trace}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    want = TRAIN["n_layers"] * steps
    if routes != {(k, route): want for k in counts} or any(plain):
        raise AssertionError(f"expected {want} launches of each flash kernel "
                             f"on the {route} route and no plain call, got "
                             f"{routes}, {plain}")
    del net
    torch.cuda.empty_cache()
    return counts


def flash_work(B, H, T, D, kind, e=2):
    """FLOPs and bytes of one causal launch at (B, H, T, D) with elements
    of `e` bytes: the T(T+1)/2 visible (query, key) pairs per head, 2*D
    flops per pair and product (2 products forward, 3 for dQ, 4 for
    dK/dV); each input read once and each output written once (L and
    dsum f32)."""
    pairs = B * H * T * (T + 1) // 2
    slab = B * H * T * D * e
    stats = B * H * T * 4
    if kind == "fwd":
        return 2 * 2 * D * pairs, 3 * slab + slab + stats
    if kind == "dq":
        return 3 * 2 * D * pairs, 4 * slab + 2 * stats + slab
    return 4 * 2 * D * pairs, 4 * slab + 2 * stats + 2 * slab


def phase_flash_timing(torch, fa, counts, counts_f32):
    """Flash kernels, plain versions and SDPA at the training shapes (bf16
    at path 2's, f32 at path 2f's with its launch counts)."""
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
    what = f"B={B} T={T} H={H} D={D} bf16 causal, qkv slices"
    err_fused = flash_check(torch, fa, got, ref, torch.bfloat16, what)
    flash_same_bits(torch, fa, q, k, v, do, True, got, what)
    del q, k, v, do, got, ref
    torch.cuda.empty_cache()
    rows = flash_rows(torch, fa, B, H, T, D, counts, err_fused, seed=9)
    # families no main path takes, each at a smaller sequence: bf16 head
    # dims 256, 384 and 512 (the mma.sync kernels); then the f32 kernels
    # (split TF32) at phase 6's shape and at path 2f's (with its launch
    # counts), against SDPA in f32 with TF32 off
    for D in (256, 384, 512):
        rows += flash_rows(torch, fa, 2, 4, 2048, D, {}, 0.0, seed=D)
    rows += flash_rows(torch, fa, 2, 8, 1024, 128, {}, 0.0, seed=32,
                       dtype=torch.float32)
    rows += flash_rows(torch, fa, TRAIN_F32_B, H, T, 128, counts_f32, 0.0,
                       seed=33, dtype=torch.float32, tag="_t4096")
    # f32 at head dims 256 (split TF32), 384 and 512 (split-TF32 forward,
    # scalar backward), the shapes of the bf16 rows above
    for D in (256, 384, 512):
        rows += flash_rows(torch, fa, 2, 4, 2048, D, {}, 0.0, seed=40 + D,
                           dtype=torch.float32)
    return rows


def flash_rows(torch, fa, B, H, T, D, counts, err, seed, dtype=None, tag=""):
    """The three kernels at (B, H, T, D) causal in `dtype` (bf16 unless
    given), held to the plain versions, then timed beside them, SDPA and
    the bound: one row each, named with `tag` appended. An f32 kernel on
    the split-TF32 route is bound by its three TF32 passes (3 x flops /
    495 TFLOP/s) or its bytes; the f32-FMA bound is logged beside it."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    q, k, v, do = flash_inputs(torch, B, T, H, D, dtype, seed=seed)
    o, lse, dq, dk, dv = flash_run(fa, q, k, v, do, True)
    dsum = fa._dsum(o, do)
    ref = flash_plain_f32(fa, q, k, v, do, True, (o, lse))
    torch.cuda.synchronize()
    err = max(err, flash_check(
        torch, fa, (o, lse, dq, dk, dv), ref, dtype,
        f"B={B} T={T} H={H} D={D} {str(dtype)[6:]} causal (timed shape)"))
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
    suffix = ("" if D == 128 else f"_d{D}") + ("_f32" if f32 else "") + tag
    lib = fa._library()
    for code, (kind, name) in enumerate((("fwd", "flash_attention_fwd"),
                                         ("dq", "flash_attention_bwd_dq"),
                                         ("dkv", "flash_attention_bwd_dkv"))):
        route = fa.ROUTES[lib.dl4j_flash_route(code, int(not f32), D)]
        flops, nbytes = flash_work(B, H, T, D, kind, q.element_size())
        t_ops = flops / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
        fma_ms = 1e3 * max(t_ops, nbytes / PEAK_BYTES)
        if route == "tf32":
            t_ops = 3 * flops / PEAK_TF32_FLOPS
        t_bytes = nbytes / PEAK_BYTES
        b_ms = 1e3 * max(t_ops, t_bytes)
        row = {"name": name + suffix, "route": "cuda", "source": FLASH_SOURCE,
               "replaces": FLASH_REPLACES[name],
               "launches": int(counts.get(kind, 0)), "max_abs_err": err,
               "ms": ms[kind],
               "plain_ms": plain_fwd if kind == "fwd" else plain_bwd,
               "bound_ms": b_ms,
               "bound_by": "operations" if t_ops > t_bytes else "bytes",
               "library_ms": lib_fwd if kind == "fwd" else lib_bwd}
        what = ("plain: the whole plain backward; library: SDPA fwd+bwd "
                "minus fwd, both backward kernels together") \
            if kind != "fwd" else "library: SDPA causal forward"
        lib_flops = flops if kind == "fwd" else sum(
            flash_work(B, H, T, D, k)[0] for k in ("dq", "dkv"))
        fma = f", f32-FMA bound {fma_ms:.4f} ms" if f32 else ""
        log(f"  {row['name']} (B={B} H={H} T={T} D={D}, "
            f"{str(dtype)[6:]}, {route}): kernel "
            f"{ms[kind]:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({row['bound_by']}{fma}), {flops / ms[kind] / 1e9:.1f} TFLOP/s "
            f"achieved, library {lib_flops / row['library_ms'] / 1e9:.1f} "
            f"TFLOP/s ({what})")
        rows.append(row)
    del q, k, v, do, o, lse, dq, dk, dv, qt, kt, vt, dot, leaves
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- LSTM
LSTM_SOURCE = "deeplearning4j_tpu_torch/csrc/lstm.cu"
LSTM_REPLACES = {
    ("fwd", False): "deeplearning4j_tpu/ops/pallas_lstm.py:67",
    ("bwd", False): "deeplearning4j_tpu/ops/pallas_lstm.py:109",
    ("fwd", True): "deeplearning4j_tpu/ops/pallas_lstm.py:160",
    ("bwd", True): "deeplearning4j_tpu/ops/pallas_lstm.py:221"}
# bench.py lstm_large (bench.py:407-422) and lstm (bench.py:393-404)
LSTM_LARGE = dict(vocab=256, hidden=1024, B=2048, T=64)
LSTM_SMALL = dict(vocab=64, hidden=256, B=8192, T=64, tbptt=24)
LSTM_STEPS = 5
LSTM_F32_STEPS = 3  # path 4f: the f32 lstm_large step
LSTM_PARITY_ATOL = 1e-4  # lr / 100 at the parity run's lr 0.01


def lstm_inputs(torch, T, B, H, dtype, seed, masked):
    """Projected inputs, RW, peepholes, nonzero h0/c0, cotangents and
    (masked) a (T, B) mask: ragged lengths, row 0 never masked, row 1
    masked from t=0, row 2 unmasked but for a hole in the middle."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * sc).to(dtype)

    inp = dict(xw=r(T, B, 4 * H), rw=r(H, 4 * H, sc=H ** -0.5),
               peep=r(3, H, sc=0.3), h0=r(B, H, sc=0.5), c0=r(B, H, sc=0.5),
               dh=r(T, B, H), dhT=r(B, H), dcT=r(B, H), mask=None)
    if masked:
        lens = torch.randint(0, T + 1, (B,), generator=g, device="cuda")
        m = (torch.arange(T, device="cuda")[:, None] < lens[None]).float()
        m[:, 0] = 1.0
        if B > 1:
            m[:, 1] = 0.0
        if B > 2:
            m[:, 2] = 1.0
            m[T // 2, 2] = 0.0
        inp["mask"] = m.to(dtype)
    return inp


def lstm_run(L, inp, reverse):
    """The forward kernel, and the backward kernel on its stash."""
    m = inp["mask"]
    got = L.lstm_fwd(inp["xw"], inp["rw"], inp["peep"], inp["h0"],
                     inp["c0"], m, reverse=reverse)
    bwd = L.lstm_bwd(got[5], got[4], inp["dh"],
                     None if m is None else inp["dhT"], inp["dcT"],
                     inp["rw"], inp["peep"], inp["c0"], m, reverse=reverse)
    return got, bwd


def lstm_plain_ref(L, inp, reverse, got):
    """The plain versions on the same inputs (math in f32 with the
    kernels' rounding points); the backward on the forward kernel's own
    stash."""
    m = inp["mask"]
    ref = L.lstm_fwd_plain(inp["xw"], inp["rw"], inp["peep"], inp["h0"],
                           inp["c0"], m, reverse=reverse)
    rb = L.lstm_bwd_plain(got[5], got[4], inp["dh"],
                          None if m is None else inp["dhT"], inp["dcT"],
                          inp["rw"], inp["peep"], inp["c0"], m,
                          reverse=reverse)
    return ref, rb


LSTM_OUTS = ("h_out", "hT", "cT", "h_sel", "c", "gates", "dz", "dhc0")


def lstm_case_units(torch, L, T, B, H, dtype, masked, reverse, seed):
    """One forward+backward kernel run against the plain versions:
    ({output: error in tolerances}, largest absolute error)."""
    inp = lstm_inputs(torch, T, B, H, dtype, seed, masked)
    got, bwd = lstm_run(L, inp, reverse)
    ref, rb = lstm_plain_ref(L, inp, reverse, got)
    torch.cuda.synchronize()
    units, err = {}, 0.0
    for n, a, b in zip(LSTM_OUTS, list(got) + list(bwd), list(ref) + list(rb)):
        if a is None:
            continue
        units[n] = L.error_in_tolerances(a, b, dtype)
        err = max(err, (a.float() - b.float()).abs().max().item())
    return units, err


def lstm_same_bits(torch, L, T, B, H, dtype, masked, reverse, seed):
    """The forward and backward kernels run twice on the same inputs must
    give the same bits (sums in a fixed order, no atomics)."""
    inp = lstm_inputs(torch, T, B, H, dtype, seed, masked)
    first = lstm_run(L, inp, reverse)
    second = lstm_run(L, inp, reverse)
    torch.cuda.synchronize()
    for n, a, b in zip(LSTM_OUTS, list(first[0]) + list(first[1]),
                       list(second[0]) + list(second[1])):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"LSTM {n} differs between two runs at "
                                 f"T={T} B={B} H={H} {dtype}")


def lstm_cancel_inputs(torch, kind, B, H, seed):
    """One step (T=1) whose recurrent product cancels: its partial sums
    along K climb to P (the sum of the products' magnitudes) and fall back
    to a result of a few hundredths of P, so that a sum that truncates as
    it goes (a tensor-core accumulator chained over all of K) is off by
    many times the f32 tolerance, while sums on fresh accumulators added
    in f32 stay far inside it.
    - fwd: h0 = (a, a (1 + 0.3 n)) with a in [0.5, 1], RW = (w, -w) with
      w = |0.16 n| over the two halves of K = H: z = -sum w a n, P ~ 50;
    - bwd: a stash with i = f and g = c_prev, so that dzi = dzf > 0
      exactly, and RW's rows (w, -w (1 + 0.3 n), 0, 0) over the gate
      blocks of K = 4H: dh0 = -sum dzf w n.
    Returns the arguments of lstm_fwd / lstm_bwd (f32, on the card)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device="cuda")

    zeros = lambda *shape: torch.zeros(shape, device="cuda")
    if kind == "fwd":
        a = u(0.5, 1.0, B, H // 2)
        w = (0.16 * n(H // 2, 4 * H)).abs()
        return (zeros(1, B, 4 * H), torch.cat([w, -w]), zeros(3, H),
                torch.cat([a, a * (1 + 0.3 * n(B, H // 2))], dim=1),
                u(-0.5, 0.5, B, H))
    c0, ig, og = u(0.2, 0.8, B, H), u(0.3, 0.7, B, H), u(0.3, 0.7, B, H)
    w = (0.1 * n(H, H)).abs()
    rw = torch.cat([w, -w * (1 + 0.3 * n(H, H)), zeros(H, 2 * H)], dim=1)
    return (torch.cat([ig, ig, og, c0], dim=1)[None], (2 * ig * c0)[None],
            u(0.5, 1.0, 1, B, H), None, u(0.5, 1.0, B, H), rw, zeros(3, H),
            c0)


def lstm_cancel_units(torch, L, kind, B=128, H=1024, seed=5):
    """The kernel (f32) on `lstm_cancel_inputs` against the plain version
    in f64: {output: error in units of TOLERANCE[float32]}."""
    args = lstm_cancel_inputs(torch, kind, B, H, seed)
    run, plain = (L.lstm_fwd, L.lstm_fwd_plain) if kind == "fwd" \
        else (L.lstm_bwd, L.lstm_bwd_plain)
    got = run(*args)
    ref = plain(*(None if t is None else t.double() for t in args))
    torch.cuda.synchronize()
    names = LSTM_OUTS[:6] if kind == "fwd" else LSTM_OUTS[6:]
    return {n: L.error_in_tolerances(a, b, torch.float32)
            for n, a, b in zip(names, got, ref) if a is not None}


def lstm_cases(torch):
    """(T, B, H, dtype, masked, reverse): every width of the two main
    paths' shapes and smaller ones, a ragged H (196: not a multiple of the
    8 units of a cooperative block, of the 16-wide k chunks or of the
    cluster kernels' 64- and 128-unit tiles), B = 37 and 300 (not
    multiples of the 128-row tiles; 300 gives three row tiles, the last
    ragged), H = 384 (a cluster of eight 64-unit forward tiles, two idle,
    and of four 128-unit backward tiles, one idle), T = 1, 2, 3, 9, 64,
    f32 and bf16, masked and not, forward and reverse; main paths 4 and
    4f's shape (T=64, B=2048, H=1024: waves of 16-block clusters through
    64 steps) in bf16 and f32, masked and not; the widths the
    kernels refused before: f32 at H=1024, B=2048 and at H=2048, bf16 at
    H=2048 (clusters of 16 blocks of 128 units, 64-row forward tiles) and
    an odd H (385 and 195: padded to a multiple of 8 by the wrappers), on
    both bf16 forward routes; and the cooperative forward's widest batch
    (B=128) beside the cluster forward's narrowest (B=129)."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for (T, B, H) in ((1, 8, 128), (2, 8, 256), (9, 37, 196),
                          (3, 300, 384), (64, 8, 1024)):
            for masked in (False, True):
                for reverse in (False, True):
                    cases.append((T, B, H, dt, masked, reverse))
        cases += [(64, 8192, 256, dt, masked, False)
                  for masked in (False, True)]
    bf = torch.bfloat16
    cases += [(64, 2048, 1024, dt, masked, False)
              for dt in (bf, torch.float32) for masked in (False, True)]
    cases += [(2, 2048, 1024, torch.float32, masked, False)
              for masked in (False, True)]
    cases += [(2, 64, 2048, torch.float32, True, True),
              (3, 256, 2048, bf, False, False), (3, 256, 2048, bf, True, True),
              (3, 300, 385, bf, False, True), (3, 300, 385, bf, True, False),
              (3, 8, 195, bf, True, False),
              (5, 128, 1024, bf, True, False),
              (5, 129, 1024, bf, False, True)]
    return cases


def lstm_plan_line(L, torch, kind, B, H, dtype=None, masked=False):
    """A kernel's launch plan at (B, H), as one line: route, tile, cluster
    size, clusters that fit at once and waves."""
    p = L.plan(kind, dtype or torch.bfloat16, masked, B, H)
    if p.route == "cooperative":
        return (f"cooperative: {p.gx} unit slices of {p.units} x {p.gy} "
                f"batch splits of {p.rows} rows, {p.active} blocks resident "
                f"at once, {p.smem} bytes of shared memory per block")
    return (f"{p.route}: tile {p.rows} rows x {p.units} units, cluster of "
            f"{p.cluster} blocks, {p.gy} row tiles (clusters), {p.active} "
            f"clusters fit at once, {p.waves} wave(s), {p.smem} bytes of "
            f"dynamic shared memory per block")


def phase_lstm_edges(torch, L):
    """The one width the kernels refuse: H above 2048 (the four gates of a
    unit sit in one thread's accumulator; 16 blocks of 128 units is the
    most one cluster holds), both passes, f32 and bf16, raised before any
    launch and naming why; and the launch plans at the main paths'
    shapes."""
    for dt in (torch.float32, torch.bfloat16):
        Hbad = L.MAX_H + 128
        inp = lstm_inputs(torch, 1, 8, Hbad, dt, 22, False)
        stash = L.lstm_fwd_plain(inp["xw"], inp["rw"], inp["peep"],
                                 inp["h0"], inp["c0"])
        for kind, call in (
                ("fwd", lambda: L.lstm_fwd(inp["xw"], inp["rw"], inp["peep"],
                                           inp["h0"], inp["c0"])),
                ("bwd", lambda: L.lstm_bwd(stash[5], stash[4], inp["dh"],
                                           None, inp["dcT"], inp["rw"],
                                           inp["peep"], inp["c0"]))):
            L.reset_counts()
            try:
                call()
            except ValueError as e:
                if L.launches:
                    raise AssertionError(f"{kind} launched before refusing")
                log(f"  {kind} {str(dt)[6:]} at H={Hbad} refused as expected: "
                    f"{e}")
            else:
                raise AssertionError(f"{kind} {dt} at H={Hbad} should be "
                                     f"refused")
    for kind in ("fwd", "bwd"):
        for B, H in ((2048, 1024), (8192, 256), (256, 1024), (256, 2048)):
            log(f"  {kind} bf16 B={B}, H={H}: "
                f"{lstm_plan_line(L, torch, kind, B, H)}")
        log(f"  {kind} f32 B=2048, H=1024: "
            f"{lstm_plan_line(L, torch, kind, 2048, 1024, torch.float32)}")


def phase_lstm_kernels(torch, L, M):
    """LSTM kernels against their plain versions, and the autograd path
    end to end (card kernels against the plain path on the CPU)."""
    errs = {}
    for i, (T, B, H, dt, masked, reverse) in enumerate(lstm_cases(torch)):
        units, err = lstm_case_units(torch, L, T, B, H, dt, masked, reverse,
                                     seed=200 + i)
        worst = max(units.values())
        errs[dt] = max(errs.get(dt, 0.0), err)
        padded = H + (-H % 8 if dt == torch.bfloat16 else 0)
        route = L.plan("fwd", dt, masked, B, padded).route
        log(f"  T={T:<2} B={B:<4} H={H:<4} {str(dt)[6:]:<8} "
            f"{'masked' if masked else 'plain '} "
            f"{'rev' if reverse else 'fwd'} max_abs_err={err:.3e} "
            f"worst {worst:.3f} of tolerance "
            f"({max(units, key=units.get)}) [{route}] "
            f"{'ok' if worst <= 1 else 'FAIL'}")
        if worst > 1:
            raise AssertionError(f"LSTM kernels disagree with plain: {units}")
    f32 = torch.float32
    for case in ((2, 2048, 1024, f32, False, False),
                 (9, 37, 196, f32, True, True), (2, 64, 2048, f32, True, True),
                 (3, 300, 385, f32, False, True)):
        lstm_same_bits(torch, L, *case, seed=40)
    log("  f32 (split-TF32 route): bits identical on rerun at "
        "B=2048 H=1024, B=37 H=196 masked reverse, B=64 H=2048, B=300 "
        "H=385")
    for kind in ("fwd", "bwd"):
        units = lstm_cancel_units(torch, L, kind)
        worst = max(units.values())
        log(f"  f32 {kind} on a cancelling product (partial sums ~30x the "
            f"result), against the plain version in f64: worst "
            f"{worst:.3f} of tolerance ({max(units, key=units.get)}) "
            f"{'ok' if worst <= 1 else 'FAIL'}")
        if worst > 1:
            raise AssertionError(f"LSTM {kind} on a cancelling product: "
                                 f"{units}")
    phase_lstm_edges(torch, L)
    phase_lstm_autograd(torch, L)
    return errs


def phase_lstm_autograd(torch, L):
    """`lstm_fused` with autograd on the card (kernels + batched
    contractions) against the same call on the CPU (plain versions):
    out, hT, cT and dx, dW, dRW, db, dpeep, dh0, dc0, row by row."""
    for dt in (torch.float32, torch.bfloat16):
        for masked in (False, True):
            for reverse in (False, True):
                T, B, NI, H = 12, 40, 64, 196
                g = torch.Generator().manual_seed(31)
                mk = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dt)
                vals = [mk(B, T, NI), mk(NI, 4 * H, sc=0.1),
                        mk(H, 4 * H, sc=H ** -0.5), mk(4 * H, sc=0.1),
                        mk(H, sc=0.3), mk(H, sc=0.3), mk(H, sc=0.3),
                        mk(B, H, sc=0.5), mk(B, H, sc=0.5)]
                wts = mk(B, T, H)
                mask = None
                if masked:
                    mask = (torch.arange(T)[None]
                            < torch.arange(B)[:, None] % (T + 1)).to(dt)
                res = []
                for dev in ("cuda", "cpu"):
                    leaves = [v.to(dev).requires_grad_() for v in vals]
                    x, W, RW, b, pI, pF, pO, h0, c0 = leaves
                    L.reset_counts()
                    out, (hT, cT) = L.lstm_fused(
                        x, W, RW, b, (pI, pF, pO), h0, c0, reverse=reverse,
                        mask=None if mask is None else mask.to(dev))
                    loss = (out.float() * wts.to(dev).float()).sum() \
                        + (hT.float() * cT.float()).sum()
                    loss.backward()
                    if dev == "cuda" and sum(L.launches.values()) != 2:
                        raise AssertionError(f"launches {L.launches}")
                    res.append([out.detach().cpu(), hT.detach().cpu(),
                                cT.detach().cpu()]
                               + [t.grad.cpu() for t in leaves])
                names = ("out", "hT", "cT", "dx", "dW", "dRW", "db", "dpI",
                         "dpF", "dpO", "dh0", "dc0")
                units = {n: L.error_in_tolerances(a, b, dt)
                         for n, a, b in zip(names, *res)}
                worst = max(units.values())
                log(f"  autograd {str(dt)[6:]:<8} "
                    f"{'masked' if masked else 'plain '} "
                    f"{'rev' if reverse else 'fwd'}: worst {worst:.3f} of "
                    f"tolerance ({max(units, key=units.get)}) "
                    f"{'ok' if worst <= 1 else 'FAIL'}")
                if worst > 1:
                    raise AssertionError(f"LSTM autograd card vs CPU: {units}")


def char_rnn_conf(M, vocab, hidden, seed=1, tbptt=0, bidirectional=False,
                  lr=0.1):
    """bench.py's char-RNN (`_lstm_train_bench`, bench.py:311-320):
    GravesLSTM -> GravesLSTM -> RnnOutputLayer(MCXENT, softmax), RMSPROP
    lr 0.1."""
    C, A, LF = M["conf"], M["Activation"], M["LossFunction"]
    first = C.GravesBidirectionalLSTM if bidirectional else C.GravesLSTM
    b = (C.NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
         .updater("rmsprop").list()
         .layer(first(n_in=vocab, n_out=hidden, activation=A.TANH))
         .layer(C.GravesLSTM(n_out=hidden, activation=A.TANH))
         .layer(C.RnnOutputLayer(n_out=vocab, loss=LF.MCXENT,
                                 activation=A.SOFTMAX))
         .set_input_type(C.InputType.recurrent(vocab)))
    if tbptt:
        b = b.t_bptt_forward_length(tbptt)
    return b.build()


def one_hot_batches(np, vocab, B, T, n, seed):
    """(one-hot f32 features (B, T, vocab), int32 next-char labels)."""
    ids = np.random.default_rng(seed).integers(0, vocab, (n, B, T + 1))
    eye = np.eye(vocab, dtype=np.float32)
    return [(eye[ids[i, :, :-1]], ids[i, :, 1:].astype(np.int32))
            for i in range(n)]


def phase_lstm_train_parity(torch, M):
    """f32 char-RNN (vocab 64, H=256, B=16, T=32) from one set of weights:
    3 RMSPROP steps on the card (kernels) against 3 on the CPU (plain);
    a tBPTT fit (windows 12, 12 and a masked tail); a bidirectional fit;
    rnn_time_step on the card against output. RMSPROP at lr 0.01: at the
    bench's 0.1 this batch of 16 diverges (loss 4.2, 9.3, 15.9), and
    RMSPROP's per-element step (~4.5 lr sign(g) at first) turns the two
    sides' summation-order differences into parameter differences of
    order lr * the gradients' relative error, which a diverging run
    amplifies."""
    import numpy as np

    L = M["lstm"]
    net_of = M["MultiLayerNetwork"]

    def pair(**kw):
        cpu = net_of(char_rnn_conf(M, 64, 256, seed=5, lr=0.01, **kw),
                     device="cpu")
        cpu.init()
        card = net_of(cpu.conf, device="cuda")
        card.set_param_tree([{k: v.clone() for k, v in p.items()}
                             for p in cpu._params])
        return card, cpu

    def train(nets, batches):
        losses = {"cuda": [], "cpu": []}
        L.reset_counts()
        for x, y in batches:
            for net in nets:
                net.fit(M["DataSet"](x, y))
                losses[net.device.type].append(net.score_value)
        return losses, dict(L.launches), (L.lstm_fwd_plain.calls,
                                          L.lstm_bwd_plain.calls)

    card, cpu = pair()
    losses, launches, plain = train((card, cpu),
                                    one_hot_batches(np, 64, 16, 32, 3, 5))
    log(f"  3 steps: losses card {losses['cuda']}")
    log(f"                 cpu  {losses['cpu']}")
    log(f"  launches {launches}; plain calls (fwd, bwd) on the CPU {plain}")
    if launches != {("fwd", False, False): 6, ("bwd", False, False): 6} \
            or plain != (6, 6):
        raise AssertionError(f"launches {launches}, plain {plain}")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    worst = 0.0
    for a, b in zip(card._params, cpu._params):
        for k in a:
            d = (a[k].cpu() - b[k]).abs()
            worst = max(worst, d.max().item())
            if not bool((d <= LSTM_PARITY_ATOL + 1e-5 * b[k].abs()).all()):
                raise AssertionError(f"param {k} differs card vs CPU by "
                                     f"{d.max().item()}")
    log(f"  params after 3 steps: max abs diff card vs CPU {worst:.3e} "
        f"(rtol 1e-5 + atol {LSTM_PARITY_ATOL} = lr/100)")
    for kw, what in (({"tbptt": 12}, "tBPTT 12 (windows 12, 12, 8+4 masked)"),
                     ({"bidirectional": True}, "bidirectional")):
        nets = pair(**kw)
        losses, launches, _ = train(nets, one_hot_batches(np, 64, 16, 32, 1,
                                                          6))
        log(f"  {what}: loss card {losses['cuda']} cpu {losses['cpu']}; "
            f"launches {launches}")
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
        if not any(m for (_, m, _) in launches) and "tbptt" in kw \
                or not any(r for (*_, r) in launches) and "tbptt" not in kw:
            raise AssertionError(f"expected masked (tBPTT) or reverse "
                                 f"(bidirectional) launches: {launches}")
    x, _ = one_hot_batches(np, 64, 16, 32, 1, 7)[0]
    full = card.output(x)
    steps = torch.cat([card.rnn_time_step(x[:, :5]),
                       card.rnn_time_step(x[:, 5:])], dim=1)
    d = (full - steps).abs().max().item()
    log(f"  rnn_time_step (5 steps + 27) vs output on the card: max abs diff "
        f"{d:.3e} (1e-5)")
    if d > 1e-5:
        raise AssertionError("rnn_time_step differs from output")


LSTM_WIDE = 2304  # wider than ops.lstm.MAX_H: the step loop's route


def lstm_wide_layer(torch, R, a, device, dtype):
    """`lstm_forward` of one sigmoid/tanh layer on numpy inputs `a` (cast
    to `dtype` on `device`): (out, hT, cT) and the gradients of
    sum(out * dout) in x, W, RW, b, the peepholes, h0 and c0, on the
    CPU in f32."""
    t = {k: torch.from_numpy(v).to(device=device, dtype=dtype)
         .requires_grad_() for k, v in a.items() if k not in ("mask", "dout")}
    out, (hT, cT) = R.lstm_forward(
        t["x"], t["W"], t["RW"], t["b"], (t["pI"], t["pF"], t["pO"]),
        torch.sigmoid, torch.tanh, t["h0"], t["c0"],
        torch.from_numpy(a["mask"]).to(device=device, dtype=dtype),
        gate_is_sigmoid=True, cell_is_tanh=True)
    (out * torch.from_numpy(a["dout"]).to(device=device, dtype=dtype)) \
        .sum().backward()
    return [v.detach().float().cpu() for v in (out, hT, cT)] \
        + [t[k].grad.float().cpu() for k in ("x", "W", "RW", "b", "pI",
                                              "pF", "pO", "h0", "c0")]


def phase_lstm_wide(torch, M):
    """Queue C1: a sigmoid/tanh LSTM wider than the fused kernels take
    (H=2304 > MAX_H) runs `lstm_forward`'s step loop on the card, as the
    JAX package runs its scan, chosen from the arguments: counts set to 0
    before each card run and read after (loop routes > 0, no fused route,
    no kernel launch, no plain-kernel call). One layer (B=4, T=3, masked),
    f32 and bf16: out, hT, cT and every gradient on the card against the
    f32 call on the CPU, row by row (`lstm.error_in_tolerances`: f32 within
    1e-4; bf16 within 2^-5, twice the kernels' bound, since the loop
    rounds every operation's result to bf16: the CPU's bf16 loop lies up
    to 1.5 x 2^-6 from the f32 one, printed beside the card's). Then a
    GravesLSTM(2304) -> RnnOutputLayer network,
    f32, SGD lr 0.1, 2 fit steps (B=8, T=16) on the card against the CPU
    from one set of weights: losses rtol 1e-5, parameters rtol 1e-5 +
    atol 1e-5."""
    import numpy as np

    from deeplearning4j_tpu_torch.nn.layers import recurrent as R

    L, H = M["lstm"], LSTM_WIDE

    def counted(run):
        R.lstm_forward.routes.update(fused=0, loop=0)
        L.reset_counts()
        res = run()
        counts = (dict(R.lstm_forward.routes), dict(L.launches),
                  L.lstm_fwd_plain.calls + L.lstm_bwd_plain.calls)
        if counts[0]["loop"] < 1 or counts[0]["fused"] or any(counts[1:]):
            raise AssertionError(f"H={H}: expected only the step loop, got "
                                 f"routes, launches, plain calls {counts}")
        return res, counts

    rng = np.random.default_rng(23)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    Bn, Tn, NI = 4, 3, 16
    a = dict(x=r(Bn, Tn, NI), W=r(NI, 4 * H, sc=0.3),
             RW=r(H, 4 * H, sc=H ** -0.5), b=r(4 * H, sc=0.1),
             pI=r(H, sc=0.1), pF=r(H, sc=0.1), pO=r(H, sc=0.1),
             h0=r(Bn, H, sc=0.5), c0=r(Bn, H, sc=0.5), dout=r(Bn, Tn, H),
             mask=(np.arange(Tn)[None] < np.array([3, 2, 3, 1])[:, None])
             .astype(np.float32))
    want = lstm_wide_layer(torch, R, a, "cpu", torch.float32)
    for dt, bound in ((torch.float32, 1.0), (torch.bfloat16, 2.0)):
        got, counts = counted(lambda: lstm_wide_layer(torch, R, a, "cuda",
                                                      dt))
        cpu = lstm_wide_layer(torch, R, a, "cpu", dt)
        units = [L.error_in_tolerances(g, w, dt) for g, w in zip(got, want)]
        own = max(L.error_in_tolerances(g, w, dt) for g, w in zip(cpu, want))
        log(f"  one layer H={H} {str(dt)[6:]}: routes, launches, plain "
            f"calls {counts}; out, hT, cT and 9 gradients vs the f32 loop on "
            f"the CPU: card worst {max(units):.3f}, CPU {own:.3f} x "
            f"{L.TOLERANCE[dt]:.3g} (bound {bound})")
        if max(units) > bound:
            raise AssertionError(f"H={H} {dt}: card differs from the f32 "
                                 f"loop ({units})")
    C, A, LF = M["conf"], M["Activation"], M["LossFunction"]
    conf = (C.NeuralNetConfiguration.Builder().seed(9).learning_rate(0.1)
            .updater("sgd").list()
            .layer(C.GravesLSTM(n_in=64, n_out=H, activation=A.TANH))
            .layer(C.RnnOutputLayer(n_out=64, loss=LF.MCXENT,
                                    activation=A.SOFTMAX))
            .set_input_type(C.InputType.recurrent(64)).build())
    cpu = M["MultiLayerNetwork"](conf, device="cpu")
    cpu.init()
    card = M["MultiLayerNetwork"](conf, device="cuda")
    card.set_param_tree([{k: v.clone() for k, v in p.items()}
                         for p in cpu._params])
    batches = one_hot_batches(np, 64, 8, 16, 2, seed=9)

    def fit(net):
        losses = []
        for x, y in batches:
            net.fit(M["DataSet"](x, y))
            losses.append(net.score_value)
        return losses

    lc, counts = counted(lambda: fit(card))
    lp = fit(cpu)
    worst = max((a_.cpu() - b_).abs().max().item()
                for pa, pb in zip(card._params, cpu._params)
                for a_, b_ in ((pa[k], pb[k]) for k in pa))
    log(f"  GravesLSTM({H}) network, 2 SGD steps: losses card {lc} cpu {lp}; "
        f"routes, launches, plain calls on the card {counts}; params max abs "
        f"diff {worst:.3e}")
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    for pa, pb in zip(card._params, cpu._params):
        for k in pa:
            d = (pa[k].cpu() - pb[k]).abs()
            if not bool((d <= 1e-5 + 1e-5 * pb[k].abs()).all()):
                raise AssertionError(f"param {k} differs card vs CPU by "
                                     f"{d.max().item()}")


def phase_lstm_train(torch, M, card, compute_dtype=None, steps=LSTM_STEPS,
                     route="bf16 clusters", seed=0):
    """Main path 4: bench.py lstm_large at full width (bf16 compute over
    f32 masters, uint8 ids through the OneHotEncoder); path 4f: the same
    network with no `compute_dtype` (f32, MultiLayerNetwork's default),
    through the split-TF32 kernels. `steps` timed steps after one warm-up
    step; every LSTM launch on `route`."""
    import numpy as np

    L = M["lstm"]
    V, H, B, T = (LSTM_LARGE[k] for k in ("vocab", "hidden", "B", "T"))
    net = M["MultiLayerNetwork"](char_rnn_conf(M, V, H, seed=1),
                                 dtype=torch.float32,
                                 compute_dtype=compute_dtype, device="cuda")
    net.init()
    net.set_normalizer(M["OneHotEncoder"](V))
    ids = np.random.default_rng(seed).integers(0, V, (steps + 2, B, T + 1))
    batches = [M["DataSet"](ids[i, :, :-1].astype(np.uint8),
                            ids[i, :, 1:].astype(np.int32))
               for i in range(steps + 2)]
    net.fit(batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L.reset_counts()
    step_ms, losses = [], []
    for ds in batches[1:steps + 1]:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(net.score_value)
    launches = dict(L.launches)
    routes = dict(L.launches_by_route)
    plain = (L.lstm_fwd_plain.calls, L.lstm_bwd_plain.calls)
    peak = torch.cuda.max_memory_allocated()
    trace = traced(torch, lambda: net.fit(batches[-1]))
    med = sorted(step_ms)[len(step_ms) // 2]
    log(f"  {steps} steps of B={B} x T={T}, H={H}, vocab {V}, "
        f"{'f32' if compute_dtype is None else str(compute_dtype)[6:]}: "
        f"step ms "
        f"{[round(t, 2) for t in step_ms]}; median {med:.2f} ms, "
        f"{B / med * 1e3:.1f} samples/s [{card}]")
    log(f"  losses {losses}; peak device memory {peak / 2**30:.2f} GiB "
        f"({peak} bytes)")
    log(f"  LSTM launches over the timed steps {launches}, by route "
        f"{routes}, plain calls (fwd, bwd) {plain}")
    log(f"  traced step (torch.profiler, not in the step times): {trace}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    want = {("fwd", False, False): 2 * steps, ("bwd", False, False): 2 * steps}
    want_routes = {("fwd", route): 2 * steps, ("bwd", route): 2 * steps}
    if launches != want or routes != want_routes or any(plain):
        raise AssertionError(f"expected {want} ({want_routes}) and no plain "
                             f"call, got {launches} ({routes}), {plain}")
    del net
    torch.cuda.empty_cache()
    return launches


def phase_lstm_tbptt(torch, M, card):
    """Main path 4b: bench.py lstm at full width with tBPTT 24. The one-hot
    rows are fed as (B, T, vocab) features: the JAX package windows 3-D
    features, not (B, T) ids that a normalizer expands."""
    import numpy as np

    L = M["lstm"]
    V, H, B, T, W = (LSTM_SMALL[k] for k in ("vocab", "hidden", "B", "T",
                                               "tbptt"))
    net = M["MultiLayerNetwork"](char_rnn_conf(M, V, H, seed=1, tbptt=W),
                                 dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device="cuda")
    net.init()
    (x0, y0), (x1, y1) = one_hot_batches(np, V, B, T, 2, 3)
    net.fit(M["DataSet"](x0, y0))   # warm-up
    torch.cuda.synchronize()
    L.reset_counts()
    t0 = time.perf_counter()
    net.fit(M["DataSet"](x1, y1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(L.launches)
    routes = dict(L.launches_by_route)
    plain = (L.lstm_fwd_plain.calls, L.lstm_bwd_plain.calls)
    trace = traced(torch, lambda: net.fit(M["DataSet"](x0, y0)))
    n_win = -(-T // W)
    log(f"  one fit of B={B} x T={T} (H={H}, vocab {V}) in {n_win} windows "
        f"of {W}: wall {1e3 * wall:.2f} ms, {B / wall:.1f} samples/s, loss "
        f"{net.score_value}, iteration {net.iteration} [{card}]")
    log(f"  LSTM launches {launches}, by route {routes}, plain calls "
        f"{plain}")
    log(f"  traced fit (torch.profiler, not in the wall time): {trace}")
    want = {("fwd", False, False): 4, ("bwd", False, False): 4,
            ("fwd", True, False): 2, ("bwd", True, False): 2}
    want_routes = {("fwd", "bf16 clusters"): 6, ("bwd", "bf16 clusters"): 6}
    if launches != want or routes != want_routes or any(plain) \
            or not np.isfinite(net.score_value):
        raise AssertionError(f"expected {want} ({want_routes}), no plain "
                             f"call and a finite loss: {launches} ({routes}), "
                             f"{plain}, {net.score_value}")
    del net
    torch.cuda.empty_cache()
    return launches


def lstm_work(kind, masked, T, B, H, e=2, stash=True):
    """FLOPs and bytes of one launch of `e`-byte elements: 2*T*B*H*4H
    flops for the recurrent product (the gate chain's elementwise work is
    not counted); each input read once, each output written once (dhc0
    f32; the forward's gates and c only with the training stash)."""
    G = 4 * H
    flops = 2 * T * B * H * G
    rw = H * G * e + 3 * H * e
    if kind == "fwd":
        nbytes = T * B * G * e + rw + 2 * B * H * e           # xw, RW, h0, c0
        nbytes += T * B * H * e + B * H * e                   # h_out, cT
        if stash:
            nbytes += T * B * G * e + T * B * H * e           # gates, c
        if masked:
            nbytes += T * B * e + B * H * e                   # mask, hT
            nbytes += T * B * H * e if stash else 0           # h_sel
    else:
        nbytes = T * B * G * e + 2 * T * B * H * e + rw       # gates, c, dh_out
        nbytes += B * H * e + B * H * e                       # dcT, c0
        nbytes += T * B * G * e + 2 * B * H * 4               # dz, dhc0
        if masked:
            nbytes += B * H * e + T * B * e                   # dhT, mask
    return flops, nbytes


def cudnn_lstm_ms(torch, T, B, H, f32=False):
    """Yardsticks from cuDNN's LSTM (`torch.nn.LSTM`, one layer, input
    size H, bf16, or fp16 where this torch's cuDNN path refuses bf16; f32
    with TF32 off when `f32`), which the port never calls. It has no
    peepholes and runs its own input GEMM, so it is not the same function:
    forward = cuDNN's forward minus one (T*B, H) @ (H, 4H) matmul;
    backward = cuDNN's forward+backward minus its forward. Returns (fwd,
    bwd, dtype)."""
    for dt in ((torch.float32,) if f32 else (torch.bfloat16, torch.float16)):
        lstm = torch.nn.LSTM(H, H).to(device="cuda", dtype=dt)
        lstm.flatten_parameters()
        x = torch.zeros((T, B, H), device="cuda", dtype=dt)
        try:  # a yardstick outside the port: another dtype where refused
            lstm(x[:1, :8])
            break
        except RuntimeError as e:
            log(f"  cuDNN LSTM in {dt}: {e}")
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((T, B, H), generator=g, device="cuda").to(dt)
    w = torch.randn((H, 4 * H), generator=g, device="cuda").to(dt)
    with torch.no_grad():
        fwd = time_ms(torch, lambda: lstm(x))
    mm = time_ms(torch, lambda: torch.matmul(x.reshape(T * B, H), w))
    xg = x.clone().requires_grad_()
    dy = torch.randn((T, B, H), generator=g, device="cuda").to(dt)

    def fwd_bwd():
        lstm(xg)[0].backward(dy)

    fb = time_ms(torch, fwd_bwd)
    return fwd - mm, fb - fwd, str(dt)[6:]


def phase_lstm_timing(torch, L, counts4, counts4b, counts4f):
    """Rows 5-8 at the main paths' shapes (bf16): path 4 runs the
    unmasked kernels at T=64, B=2048, H=1024; path 4b all four at a
    window of T=24, B=8192, H=256. Then the two bf16 forward routes at
    their boundary (T=64, H=1024: the cooperative kernel at B=128, the
    cluster kernel at B=129), and the f32 kernels (split TF32) at T=8,
    B=2048, H=1024, at path 4f's shape (T=64, with its launch counts) and
    masked at path 4b's window. An f32 row on the split-TF32 route is
    bound by its three TF32 passes (3 x flops / 495 TFLOP/s) or its
    bytes; the f32-FMA bound (flops / 67 TFLOP/s) is logged beside it.
    Every row's outputs are held to the plain versions first, as in phase
    11 (`lstm.error_in_tolerances`)."""
    shapes = [(64, 2048, 1024, False, counts4, torch.bfloat16),
              (LSTM_SMALL["tbptt"], 8192, 256, False, counts4b,
               torch.bfloat16),
              (LSTM_SMALL["tbptt"], 8192, 256, True, counts4b,
               torch.bfloat16),
              (64, 128, 1024, False, {}, torch.bfloat16),
              (64, 129, 1024, False, {}, torch.bfloat16),
              (8, 2048, 1024, False, {}, torch.float32),
              (64, 2048, 1024, False, counts4f, torch.float32),
              (LSTM_SMALL["tbptt"], 8192, 256, True, {}, torch.float32)]
    rows, yard = [], {}
    for T, B, H, masked, counts, dt in shapes:
        inp = lstm_inputs(torch, T, B, H, dt, 77, masked)
        got, bwd = lstm_run(L, inp, False)
        ref, rb = lstm_plain_ref(L, inp, False, got)
        torch.cuda.synchronize()
        err = {"fwd": max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, ref) if a is not None),
               "bwd": max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(bwd, rb))}
        units = {n: L.error_in_tolerances(a, b, dt) for n, a, b in
                 zip(LSTM_OUTS, list(got) + list(bwd), list(ref) + list(rb))
                 if a is not None}
        del ref, rb
        worst = max(units, key=units.get)
        log(f"  T={T} B={B} H={H} {str(dt)[6:]} "
            f"{'masked' if masked else 'plain'}: worst {units[worst]:.3f} "
            f"of tolerance ({worst}) "
            f"{'ok' if units[worst] <= 1 else 'FAIL'}")
        if units[worst] > 1:
            raise AssertionError(f"LSTM kernels disagree with plain at "
                                 f"T={T} B={B} H={H} {dt}: {units}")
        m = inp["mask"]
        fns = {
            "fwd": (lambda: L.lstm_fwd(inp["xw"], inp["rw"], inp["peep"],
                                       inp["h0"], inp["c0"], m),
                    lambda: L.lstm_fwd_plain(inp["xw"], inp["rw"],
                                             inp["peep"], inp["h0"],
                                             inp["c0"], m)),
            "bwd": (lambda: L.lstm_bwd(got[5], got[4], inp["dh"],
                                       None if m is None else inp["dhT"],
                                       inp["dcT"], inp["rw"], inp["peep"],
                                       inp["c0"], m),
                    lambda: L.lstm_bwd_plain(got[5], got[4], inp["dh"],
                                             None if m is None else inp["dhT"],
                                             inp["dcT"], inp["rw"],
                                             inp["peep"], inp["c0"], m))}
        f32 = dt == torch.float32
        if (T, B, H, f32) not in yard:
            yard[(T, B, H, f32)] = cudnn_lstm_ms(torch, T, B, H, f32)
        kinds = ("fwd", "bwd") if B in (2048, 8192) else ("fwd",)
        for j, kind in enumerate(kinds):
            ms = time_ms(torch, fns[kind][0])
            plain_ms = time_ms(torch, fns[kind][1], iters=5, warmup=1)
            e = 4 if f32 else 2
            flops, nbytes = lstm_work(kind, masked, T, B, H, e)
            peak = PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
            t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
            fma = ""
            if L.plan(kind, dt, masked, B, H).route == "tf32 clusters":
                fma = (f"; f32-FMA bound {1e3 * max(t_ops, t_bytes):.4f} "
                       f"ms")
                t_ops = 3 * flops / PEAK_TF32_FLOPS
            name = (f"lstm_{kind}{'_masked' if masked else ''}"
                    f"{'_f32' if f32 else ''}_t{T}_b{B}_h{H}")
            row = {"name": name, "route": "cuda", "source": LSTM_SOURCE,
                   "replaces": LSTM_REPLACES[(kind, masked)],
                   "launches": int(counts.get((kind, masked, False), 0)),
                   "max_abs_err": err[kind], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": 1e3 * max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops > t_bytes else "bytes",
                   "library_ms": yard[(T, B, H, f32)][j]}
            how = "forward minus its input matmul" if kind == "fwd" \
                else "fwd+bwd minus fwd"
            log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"cuDNN LSTM {row['library_ms']:.4f} ms "
                f"({yard[(T, B, H, f32)][2]}, {how}, no peepholes), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}{fma}), "
                f"{flops / ms / 1e9:.1f} TFLOP/s, max_abs_err "
                f"{err[kind]:.3e}, launches {row['launches']}; "
                f"{lstm_plan_line(L, torch, kind, B, H, dt, masked)}")
            rows.append(row)
        if B in (128, 129):  # the routes' boundary without the stash too
            ms = time_ms(torch, lambda: L.lstm_fwd(
                inp["xw"], inp["rw"], inp["peep"], inp["h0"], inp["c0"],
                with_stash=False))
            log(f"  lstm_fwd t{T} b{B} h{H} without the stash (inference): "
                f"{ms:.4f} ms [{L.plan('fwd', dt, False, B, H).route}]")
        del inp, got, bwd
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.normalizers import OneHotEncoder
    from deeplearning4j_tpu_torch.models.transformer import (
        generate,
        gpt_configuration,
    )
    from deeplearning4j_tpu_torch.nn import conf as nn_conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import lstm as L
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.ops.losses import LossFunction
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.serving.decode_engine import DecodeEngine

    M = dict(generate=generate, gpt_configuration=gpt_configuration,
             MultiLayerNetwork=MultiLayerNetwork, DecodeEngine=DecodeEngine,
             DataSet=DataSet, fa=fa, lstm=L, conf=nn_conf,
             OneHotEncoder=OneHotEncoder, Activation=Activation,
             LossFunction=LossFunction)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi_line()
    log(f"[1/18] card: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    built = cuda_build.build(KERNEL_SOURCES)
    log(f"[2/18] build: {time.perf_counter() - t0:.1f} s for "
        f"{len(built)} source(s)")
    for name, res in built.items():
        for line in ptxas_summary(res.log):
            log(f"  {name}: {line}")

    log("[3/18] paged kernels against their plain versions (TF32 off)")
    phase_kernels(torch, pa)
    log("[4/18] flash kernels against their plain versions (TF32 off)")
    phase_flash(torch, fa)
    log("[5/18] f32 DecodeEngine vs generate, 2 layers, d_model 1024")
    phase_parity(torch, M)
    log("[6/18] f32 training, card (kernels) vs CPU (plain), 1 layer, "
        "d_model 1024, T=1024")
    phase_train_parity(torch, M)
    log("[7/18] serving the 8-layer bf16 GPT at full width")
    launches = phase_serve(torch, M, pa, card)
    log("[8/18] serving it with int8 KV, the prefix cache and "
        "self-speculation on shared-prefix traffic")
    launches.update(phase_serve_tier(torch, M, pa, card))
    log("[9/18] training the 8-layer bf16 gpt_long GPT at full width")
    flash_counts = phase_train(torch, M, card, torch.bfloat16, TRAIN_B,
                               TRAIN_STEPS, 13, "wgmma")
    log("[10/18] path 2f: training the 8-layer gpt_long GPT in f32 "
        "(split-TF32 flash kernels)")
    flash_counts_f32 = phase_train(torch, M, card, None, TRAIN_F32_B,
                                   TRAIN_F32_STEPS, 14, "tf32")
    log("[11/18] LSTM kernels against their plain versions (TF32 off)")
    phase_lstm_kernels(torch, L, M)
    log("[12/18] f32 char-RNN training, card (kernels) vs CPU (plain), "
        "H=256")
    phase_lstm_train_parity(torch, M)
    log("[13/18] training the bf16 lstm_large char-RNN at full width")
    lstm_counts = phase_lstm_train(torch, M, card, torch.bfloat16)
    log("[14/18] training the bf16 lstm char-RNN with tBPTT 24 at full width")
    tbptt_counts = phase_lstm_tbptt(torch, M, card)
    log("[15/18] path 4f: training the lstm_large char-RNN in f32 "
        "(split-TF32 LSTM kernels)")
    f32_counts = phase_lstm_train(torch, M, card, None, LSTM_F32_STEPS,
                                  "tf32 clusters", seed=2)
    log("[16/18] timing at the serving and training shapes (bf16 and f32)")
    rows = phase_timing(torch, pa, launches)
    rows += phase_flash_timing(torch, fa, flash_counts,
                               flash_counts_f32)
    log("[17/18] timing the LSTM kernels at the char-RNN shapes (bf16 and "
        "f32)")
    rows += phase_lstm_timing(torch, L, lstm_counts, tbptt_counts,
                              f32_counts)
    log(f"[18/18] a GravesLSTM wider than the fused kernels (H={LSTM_WIDE}): "
        "the step loop, card vs CPU")
    phase_lstm_wide(torch, M)
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
