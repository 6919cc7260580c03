#!/usr/bin/env python3
"""Where the bf16 LSTM forward's step and the bf16 D=128 flash
backward's tiles go, on one NVIDIA card.

    python3 chip_phase_profile.py    # about a minute on an H100

Copies `deeplearning4j_tpu_torch/` into a temporary directory, plants
`clock64()` readings around the phases of the consumer warpgroups of
`lstm_fwd_cluster_kernel` (the copy's `csrc/lstm.cu`) and of
`flash_bwd_dq_wgmma_kernel` and `flash_bwd_dkv_wgmma_kernel` (its
`csrc/flash_attention.cu`; the checkout is never changed), builds it, and
runs:
- the LSTM forward at main path 4's shape (T=8, B=2048, H=1024) and main
  path 4b's window (B=8192, H=256, unmasked and masked). Block (0, 0)'s
  two consumer warpgroups print their SM cycles per step, averaged over
  the steps: the product (first chunk wait included), the wait for the xw
  tile, the cell phase, the output stores (thread 0's warpgroup issues
  them and waits for h_t) and the cluster barrier;
- the flash backward at main path 2's shape (B=8, H=8, T=4096, D=128,
  causal). Block (0, 0) (the longest rows of dQ, the longest columns of
  dK/dV) prints each consumer warpgroup's SM cycles per tile, averaged
  over its tiles: dQ: the wait for the K/V stage, S and dP (one commit),
  P and dS, the dQ product; dK/dV warpgroup 0: the stage wait, S^T, P^T,
  the hand-over (the wait for the P^T buffer and the stores), the dV
  product; warpgroup 1: the stage wait, dP^T, the wait for P^T, dS^T, the
  dK product.
The instrumented kernels are slower than the real ones by the readings'
cost; the shares, not the sums, are what it shows. Exits non-zero without
a CUDA device.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "deeplearning4j_tpu_torch"
# (text, replacement): each replaces the one occurrence of `text`
LSTM_EDITS = [
    ("""  uint32_t q = 0;  // chunks consumed before this step
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const bool last = s == a.T - 1;
""", """  uint32_t q = 0;  // chunks consumed before this step
  long long tp = 0, tx = 0, tc = 0, ts = 0, tb = 0;
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const bool last = s == a.T - 1;
    const long long t0 = clock64();
"""),
    ("""    sm90::mbar_wait(&sm.x_full, s & 1);
    // ---- cell phase""", """    const long long t1 = clock64();
    sm90::mbar_wait(&sm.x_full, s & 1);
    const long long t2 = clock64();
    // ---- cell phase"""),
    ("""    sm90::fence_proxy_async_smem();
    asm volatile("bar.sync 1, %0;\\n" ::"n"(kConsumers) : "memory");
    if (tid == 0) {""", """    const long long t3 = clock64();
    sm90::fence_proxy_async_smem();
    asm volatile("bar.sync 1, %0;\\n" ::"n"(kConsumers) : "memory");
    if (tid == 0) {"""),
    ("""    sm90::cluster_sync();
  }
  if (tid == 0) sm90::bulk_wait<0>();  // the last step's stash is stored
}""", """    const long long t4 = clock64();
    sm90::cluster_sync();
    tp += t1 - t0, tx += t2 - t1, tc += t3 - t2, ts += t4 - t3;
    tb += clock64() - t4;
  }
  if (tid == 0) sm90::bulk_wait<0>();  // the last step's stash is stored
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid % 128 == 0)
    printf("PHASES rows=%d H=%d masked=%d wg=%d: product %lld, xw wait "
           "%lld, cell %lld, stores %lld, barrier %lld cycles per step\\n",
           ROWS, a.H, (int)MASKED, wg, tp / a.T, tx / a.T, tc / a.T,
           ts / a.T, tb / a.T);
}"""),
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
]


def _clock(i: int, indent: int) -> str:
    """Reading c<i> of the SM clock, as a line of the given indent."""
    return " " * indent + f"const long long c{i} = clock64();\n"


def _tally(kind: str, names, store: str):
    """(declaration of the per-tile sums, their accumulation from readings
    c0 .. c<len(names)>, the print of their means before `store`, the
    consumer's final store)."""
    acc = [f"t{i}" for i in range(len(names))]
    decl = "  long long " + ", ".join(f"{x} = 0" for x in acc) \
        + ";\n  int tiles = 0;\n"
    add = "".join(f"{x} += c{i + 1} - c{i}; " for i, x in enumerate(acc)) \
        + "++tiles;\n"
    fmt = ", ".join(f"{x} %lld" for x in names)
    means = ", ".join(f"{x} / (tiles > 0 ? tiles : 1)" for x in acc)
    show = (f"  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 "
            f"== 0)\n    printf(\"PHASES {kind} wg=%d, %d tiles: {fmt} "
            f"cycles per tile\\n\", (int)(threadIdx.x / 128), tiles, {means});\n")
    return decl, add, show + store


_DQ = _tally("dQ", ["stage wait", "S and dP", "P and dS", "dQ product"],
             "  store_wg(dq, a.scale, a.out0, a.so0, b, h, q0, rl, t);")
_DV = _tally("dK/dV", ["stage wait", "S^T", "P^T", "hand-over",
                       "dV product"],
             "  store_wg(dv, 1.f, a.out1, a.so1, b, h, kj * kBwRows, rl, t);")
_DK = _tally("dK/dV", ["stage wait", "dP^T", "P^T wait", "dS^T",
                       "dK product"],
             "  store_wg(dk, a.scale, a.out0, a.so0, b, h, kj * kBwRows, rl, "
             "t);")
_WAIT_J = "    sm90::mbar_wait(&sm.full[st], (j / kBwStages) & 1);\n"
_WAIT_N = "    sm90::mbar_wait(&sm.full[st], (n / kBwStages) & 1);\n"
FLASH_EDITS = [
    # dQ consumer: stage wait, S and dP, P and dS, the dQ product
    ("  for (int i = 0; i < 64; ++i) dq[i] = 0.f;\n",
     "  for (int i = 0; i < 64; ++i) dq[i] = 0.f;\n" + _DQ[0]),
    (_WAIT_J + "    if (j < nk_wg) {\n",
     _clock(0, 4) + _WAIT_J + _clock(1, 4) + "    if (j < nk_wg) {\n"),
    ("      sm90::fence_regs(dp);\n      const bool diag",
     "      sm90::fence_regs(dp);\n" + _clock(2, 6) + "      const bool diag"),
    ("      pack16(p, s);\n", "      pack16(p, s);\n" + _clock(3, 6)),
    ("      issue_pb64(dq, p, sm.k[st][0]);  // dQ += dS K\n"
     "      sm90::wgmma_wait<0>();\n      sm90::fence_regs(dq);\n",
     "      issue_pb64(dq, p, sm.k[st][0]);  // dQ += dS K\n"
     "      sm90::wgmma_wait<0>();\n      sm90::fence_regs(dq);\n"
     + _clock(4, 6) + "      " + _DQ[1]),
    (_DQ[2].split("\n")[-1], _DQ[2]),
    # dK/dV warpgroup 0: stage wait, S^T, P^T, hand-over, the dV product
    ("  for (int i = 0; i < 64; ++i) dv[i] = 0.f;\n",
     "  for (int i = 0; i < 64; ++i) dv[i] = 0.f;\n" + _DV[0]),
    (_WAIT_N + "    sm90::wgmma_fence();\n    issue_s64(s, sm.k,",
     _clock(0, 4) + _WAIT_N + _clock(1, 4)
     + "    sm90::wgmma_fence();\n    issue_s64(s, sm.k,"),
    ("    sm90::fence_regs(s);\n    // P^T = ex2",
     "    sm90::fence_regs(s);\n" + _clock(2, 4) + "    // P^T = ex2"),
    ("    // hand P^T to warpgroup 1",
     _clock(3, 4) + "    // hand P^T to warpgroup 1"),
    ("    sm90::mbar_arrive(&sm.p_full[pb]);\n",
     "    sm90::mbar_arrive(&sm.p_full[pb]);\n" + _clock(4, 4)),
    ("    issue_pb64(dv, p, sm.dO[st][0]);  // dV += P^T dO\n"
     "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(dv);\n",
     "    issue_pb64(dv, p, sm.dO[st][0]);  // dV += P^T dO\n"
     "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(dv);\n"
     + _clock(5, 4) + "    " + _DV[1]),
    (_DV[2].split("\n")[-1], _DV[2]),
    # dK/dV warpgroup 1: stage wait, dP^T, the wait for P^T, dS^T, dK
    ("  for (int i = 0; i < 64; ++i) dk[i] = 0.f;\n",
     "  for (int i = 0; i < 64; ++i) dk[i] = 0.f;\n" + _DK[0]),
    (_WAIT_N + "    sm90::wgmma_fence();\n    issue_s64(dp, sm.v,",
     _clock(0, 4) + _WAIT_N + _clock(1, 4)
     + "    sm90::wgmma_fence();\n    issue_s64(dp, sm.v,"),
    ("    sm90::fence_regs(dp);\n    sm90::mbar_wait(&sm.p_full[pb], "
     "(n >> 1) & 1);\n",
     "    sm90::fence_regs(dp);\n" + _clock(2, 4)
     + "    sm90::mbar_wait(&sm.p_full[pb], (n >> 1) & 1);\n" + _clock(3, 4)),
    ("    pack16(p, dp);\n", "    pack16(p, dp);\n" + _clock(4, 4)),
    ("    issue_pb64(dk, p, sm.q[st][0]);  // dK += dS^T Q\n"
     "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(dk);\n",
     "    issue_pb64(dk, p, sm.q[st][0]);  // dK += dS^T Q\n"
     "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(dk);\n"
     + _clock(5, 4) + "    " + _DK[1]),
    (_DK[2].split("\n")[-1], _DK[2]),
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
]


def instrumented(src: str, edits) -> str:
    for text, new in edits:
        if src.count(text) != 1:
            raise RuntimeError(f"instrumentation anchor not found once: "
                               f"{text[:60]!r}")
        src = src.replace(text, new)
    return src


def run(root: str) -> None:
    """In the copy's process: the three LSTM forward launches, then the
    flash backward's two kernels at path 2's shape."""
    import torch

    sys.path[:0] = [root, REPO]
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import lstm as L

    for mod in (L, fa):
        if not mod.__file__.startswith(root):
            raise RuntimeError(f"ran {mod.__file__}")
    for T, B, H, masked in ((8, 2048, 1024, False), (8, 8192, 256, False),
                            (8, 8192, 256, True)):
        inp = cs.lstm_inputs(torch, T, B, H, torch.bfloat16, 77, masked)
        L.lstm_fwd(inp["xw"], inp["rw"], inp["peep"], inp["h0"], inp["c0"],
                   inp["mask"])
        torch.cuda.synchronize()
    q, k, v, do = cs.flash_inputs_fused(torch, cs.TRAIN_B, cs.TRAIN_T,
                                        cs.TRAIN["n_heads"], 128,
                                        torch.bfloat16, seed=8)
    o, lse = fa.flash_forward(q, k, v, True, None, with_lse=True)
    dsum = fa._dsum(o, do)
    fa.flash_bwd_dq(q, k, v, do, lse, dsum, True, None)
    torch.cuda.synchronize()
    fa.flash_bwd_dkv(q, k, v, do, lse, dsum, True, None)
    torch.cuda.synchronize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phase_profile: no CUDA device available", file=sys.stderr)
        return 2
    root = tempfile.mkdtemp(prefix="kernel_phases_")
    try:
        shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for name, edits in (("lstm", LSTM_EDITS),
                            ("flash_attention", FLASH_EDITS)):
            path = os.path.join(root, PKG, "csrc", f"{name}.cu")
            with open(path) as f:
                src = f.read()
            with open(path, "w") as f:
                f.write(instrumented(src, edits))
        code = (f"import sys; sys.path[:0] = [{root!r}, {REPO!r}]; "
                f"import chip_phase_profile as p; p.run({root!r})")
        p = subprocess.run([sys.executable, "-c", code], cwd=root,
                           capture_output=True, text=True, timeout=600)
        print(p.stdout, end="")
        if p.returncode != 0:
            print(p.stderr[-2000:], file=sys.stderr)
        return p.returncode
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
