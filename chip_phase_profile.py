#!/usr/bin/env python3
"""Where the LSTM kernels' steps and the flash kernels' tiles go (the bf16
backward at D=128, the f32 clusters at D=256-512), on one NVIDIA card.

    python3 chip_phase_profile.py    # about a minute on an H100
    python3 chip_phase_profile.py --package OLD/deeplearning4j_tpu_torch

`--package` instruments another copy of the package (an earlier
commit's, unpacked with `git archive`): its cooperative forward is
instrumented in the form that copy holds (the mma.sync kernel with its
grid barrier, or the wgmma kernel with its step counter).

Copies `deeplearning4j_tpu_torch/` into a temporary directory, plants
`clock64()` readings around the phases of the consumer warpgroups of
`lstm_fwd_kernel` (the cooperative forward), `lstm_fwd_cluster_kernel`,
`lstm_fwd_tf32_kernel` and `lstm_bwd_tf32_kernel` (the copy's
`csrc/lstm.cu`) and of
`flash_bwd_dq_wgmma_kernel`, `flash_bwd_dkv_wgmma_kernel` and the three
`flash_*_tf32_cluster_kernel` (its `csrc/flash_attention.cu`; the
checkout is never changed), builds it, and runs:
- the cooperative bf16 forward (B <= 128) at row 5's shape (T=64,
  B=128, H=1024; with and without the stash, and masked) and at path
  4s's window (T=50, B=32): block 0's consumer warpgroups print their SM
  cycles a step over the waits for the h[t-1] chunks (the TMA loads, and
  behind them the step counter), the product, the split-K hand-over, the
  xw wait, the cell phase, the arrival on the step counter and the stash
  stores; its producer warp the wait for the counter and the arming of
  the ring's stages. The mma.sync kernel it replaced (`--package` of an
  earlier commit): block (0, 0)'s warp 0 the h loads and products, the
  cell phase and the grid barrier;
- the LSTM forward at main path 4's shape (T=8, B=2048, H=1024) and main
  path 4b's window (B=8192, H=256, unmasked and masked). Block (0, 0)'s
  two consumer warpgroups print their SM cycles per step, averaged over
  the steps: the product (first chunk wait included), the wait for the xw
  tile, the cell phase, the output stores (thread 0's warpgroup issues
  them and waits for h_t) and the cluster barrier;
- the f32 (split-TF32) forward and backward at T=8, B=2048, H=1024 and
  masked at B=8192, H=256: block (0, 0)'s consumer warpgroups print
  their SM cycles a step: the stage waits, the RW splits, the products
  and the release with the f32 adds (each summed over the step's
  chunks), the cell phase, the cluster barrier and (backward) the dh
  carry's staging;
- the flash backward at main path 2's shape (B=8, H=8, T=4096, D=128,
  causal). Block (0, 0) (the longest rows of dQ, the longest columns of
  dK/dV) prints each consumer warpgroup's SM cycles per tile, averaged
  over its tiles: dQ: the wait for the K/V stage, S and dP (one commit),
  P and dS, the dQ product; dK/dV warpgroup 0: the stage wait, S^T, P^T,
  the hand-over (the wait for the P^T buffer and the stores), the dV
  product; warpgroup 1: the stage wait, dP^T, the wait for P^T, dS^T, the
  dK product;
- the f32 forward, dQ and dK/dV at D = 256, 384 and 512 (split-TF32
  clusters; B=2, H=4, T=2048, causal): each warp of block (0, 0, 0) (the
  longest rows of the forward and dQ, the longest columns of dK/dV; the
  cluster's first member) prints its SM cycles per streamed step: the
  stage wait, the in-place split, the partial scores, the cluster
  barrier, the exchange (the members' partials read and added) and the
  rest (the forward's softmax and P V; P, dS and the backward's output
  products).
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


# The cooperative bf16 forward (lstm_fwd_kernel, B <= 128): block 0's
# consumer warpgroups sum their SM cycles a step over the waits for the
# h[t-1] chunks, the product (wgmma), the split-K hand-over, the wait for
# the xw tile, the cell phase (gate chain and h_t stores), the arrival on
# the step counter (the proxy fence, the block barrier, thread 0's
# release) and the stash stores; its producer warp over the wait for the
# counter (every block's h_t) and the arming of the stages
COOP_EDITS = [
    ("""  float acc[4][16];
  for (int s = 0; s < a.T; ++s) {
""", """  float acc[4][16];
  long long pw = 0, pp = 0, ph = 0, px = 0, pc = 0, pa = 0, ps = 0;
  for (int s = 0; s < a.T; ++s) {
    const long long k0 = clock64();
    long long kw = 0;
"""),
    ("""      const uint32_t q = (uint32_t)s * nch + c, st = q % S;
      sm90::mbar_wait(&sm.full[st], (q / S) & 1);
      sm90::wgmma_fence();
""", """      const uint32_t q = (uint32_t)s * nch + c, st = q % S;
      const long long kw0 = clock64();
      sm90::mbar_wait(&sm.full[st], (q / S) & 1);
      kw += clock64() - kw0;
      sm90::wgmma_fence();
"""),
    ("    // the warpgroup's partial of accumulator element i",
     "    const long long k1 = clock64();\n"
     "    // the warpgroup's partial of accumulator element i"),
    ("""    // ---- cell phase: the gate chain of the thread's cells
    sm90::mbar_wait(&sm.x_full[s & 1], (s >> 1) & 1);
""", """    const long long k2 = clock64();
    // ---- cell phase: the gate chain of the thread's cells
    sm90::mbar_wait(&sm.x_full[s & 1], (s >> 1) & 1);
    const long long k3 = clock64();
"""),
    ("    // ---- h_t published: fenced",
     "    const long long k4 = clock64();\n    // ---- h_t published: fenced"),
    ("    // ---- the stash and the outputs, while the next h[t-1] is on its "
     "way\n",
     "    const long long k5 = clock64();\n"
     "    // ---- the stash and the outputs, while the next h[t-1] is on its "
     "way\n"),
    ("""        if (MASKED) st_pair(a.hT + (long long)r * H + u, hv[rr][0], hv[rr][1]);
      }
    }
  }
}
""", """        if (MASKED) st_pair(a.hT + (long long)r * H + u, hv[rr][0], hv[rr][1]);
      }
    }
    const long long k6 = clock64();
    pw += kw, pp += k1 - k0 - kw, ph += k2 - k1, px += k3 - k2;
    pc += k4 - k3, pa += k5 - k4, ps += k6 - k5;
  }
  if (blockIdx.x == 0 && tid % 128 == 0)
    printf("PHASES coop T=%d B=%d H=%d masked=%d stash=%d split=%d "
           "cluster=%d wg=%d: h waits %lld, product %lld, hand-over %lld, "
           "xw wait %lld, cell %lld, arrival %lld, stores %lld cycles per "
           "step\\n", a.T, B, H, (int)MASKED, (int)STASH, (int)split, C, wg,
           pw / a.T, pp / a.T, ph / a.T, px / a.T, pc / a.T, pa / a.T,
           ps / a.T);
}
"""),
    ("""  uint32_t q = 0;  // chunks armed before this one
""", """  uint32_t q = 0;  // chunks armed before this one
  long long fw = 0, fe = 0;
"""),
    ("""      sm90::mbar_wait_cluster(&sm.empty[st], ((q / S) & 1) ^ 1);
      sm90::mbar_expect_tx(&sm.full[st], abytes);
      if (c % C != rank) continue;""",
     """      const long long e0 = clock64();
      sm90::mbar_wait_cluster(&sm.empty[st], ((q / S) & 1) ^ 1);
      fe += clock64() - e0;
      sm90::mbar_expect_tx(&sm.full[st], abytes);
      if (c % C != rank) continue;"""),
    ("""        sm90::flag_wait(a.sync, gridDim.x * (unsigned)s);
""", """        const long long f0 = clock64();
        sm90::flag_wait(a.sync, gridDim.x * (unsigned)s);
        fw += clock64() - f0;
"""),
    ("""        sm90::tma_load_3d_multicast(sm.a[st], &m.h, &sm.full[st], mask,
                                    c * kChunk, 0, s & 1);
    }
  }
}
""", """        sm90::tma_load_3d_multicast(sm.a[st], &m.h, &sm.full[st], mask,
                                    c * kChunk, 0, s & 1);
    }
  }
  if (blockIdx.x == 0)
    printf("PHASES coop producer T=%d: counter wait %lld, stage arming "
           "%lld cycles per step\\n", a.T, fw / a.T, fe / a.T);
}
"""),
]
# The cooperative bf16 backward: block 0's consumer warpgroups sum their
# SM cycles a step over the cell phase (the gate chain from the stash in
# registers, the dz[t] stores), the publication (fence, block barrier,
# the arrival on the step counter), the issue of the next step's stash
# loads, the waits for the dz[t] stages (the TMA loads, and behind them
# the counter), the rest of the product (the wgmma commit groups, one a
# stage) and the hand-over with the dh carry; its producer warp the wait
# for the counter and the arming of the ring's stages
BWD_COOP_EDITS = [
    ("""  float acc[4][8];
  uint32_t q0 = 0;  // stages of earlier steps
  for (int s = 0; s < a.T; ++s) {
    const CoopStep sp(a, s);
""", """  float acc[4][8];
  uint32_t q0 = 0;  // stages of earlier steps
  long long pc = 0, pu = 0, pl = 0, pw = 0, pp = 0, ph = 0;
  for (int s = 0; s < a.T; ++s) {
    const CoopStep sp(a, s);
    const long long k0 = clock64();
    long long kw = 0;
"""),
    ("""    // ---- dz[t] published: fenced for the TMA loads that read it, then
""", """    const long long k1 = clock64();
    // ---- dz[t] published: fenced for the TMA loads that read it, then
"""),
    ("""    if (s + 1 < a.T) load_stash(s + 1);  // in flight during the product
""", """    const long long k2 = clock64();
    if (s + 1 < a.T) load_stash(s + 1);  // in flight during the product
    const long long k3 = clock64();
"""),
    ("""      const uint32_t q = q0 + c, st = q % S;
      sm90::mbar_wait(&sm.full[st], (q / S) & 1);
""", """      const uint32_t q = q0 + c, st = q % S;
      const long long kw0 = clock64();
      sm90::mbar_wait(&sm.full[st], (q / S) & 1);
      kw += clock64() - kw0;
"""),
    ("""    // this warpgroup's partial of accumulator element i (split K with
    // one stage: warpgroup 1 has none)
    auto part = [&](int i) { return n > 0 ? sum[i] : 0.f; };
    float peer[4] = {};""", """    const long long k4 = clock64();
    // this warpgroup's partial of accumulator element i (split K with
    // one stage: warpgroup 1 has none)
    auto part = [&](int i) { return n > 0 ? sum[i] : 0.f; };
    float peer[4] = {};"""),
    ("""          if (sp.first && live(rr, j))
            a.dhc0[(long long)(rb + 8 * rr) * H + u0 + 8 * j + e] =
                dhc[rr][j][e];
        }
  }
}
""", """          if (sp.first && live(rr, j))
            a.dhc0[(long long)(rb + 8 * rr) * H + u0 + 8 * j + e] =
                dhc[rr][j][e];
        }
    const long long k5 = clock64();
    pc += k1 - k0, pu += k2 - k1, pl += k3 - k2, pw += kw;
    pp += k4 - k3 - kw, ph += k5 - k4;
  }
  if (blockIdx.x == 0 && tid % 128 == 0)
    printf("PHASES bwd coop T=%d B=%d H=%d masked=%d split=%d stages=%d "
           "cluster=%d wg=%d: cell %lld, publish %lld, stash issue %lld, "
           "dz waits %lld, product %lld, hand-over %lld cycles per step\\n",
           a.T, B, H, (int)MASKED, (int)split, S, C, wg, pc / a.T, pu / a.T,
           pl / a.T, pw / a.T, pp / a.T, ph / a.T);
}
"""),
    ("""  const uint32_t cb = a.rows * kChunk * 2;  // bytes of a chunk's box
  uint32_t q = 0;  // stages armed so far
""", """  const uint32_t cb = a.rows * kChunk * 2;  // bytes of a chunk's box
  uint32_t q = 0;  // stages armed so far
  long long fw = 0, fe = 0;
"""),
    ("""      sm90::mbar_wait_cluster(&sm.empty[st], ((q / S) & 1) ^ 1);
      sm90::mbar_expect_tx(&sm.full[st], NB * cb);""", """      const long long e0 = clock64();
      sm90::mbar_wait_cluster(&sm.empty[st], ((q / S) & 1) ^ 1);
      fe += clock64() - e0;
      sm90::mbar_expect_tx(&sm.full[st], NB * cb);"""),
    ("""        sm90::flag_wait(a.sync, gridDim.x * (unsigned)(s + 1));
""", """        const long long f0 = clock64();
        sm90::flag_wait(a.sync, gridDim.x * (unsigned)(s + 1));
        fw += clock64() - f0;
"""),
    ("""          sm90::tma_load_3d_multicast(dst, &m.dz, &sm.full[st], mask, k0, 0,
                                      sp.t);
      }
    }
  }
}
""", """          sm90::tma_load_3d_multicast(dst, &m.dz, &sm.full[st], mask, k0, 0,
                                      sp.t);
      }
    }
  }
  if (blockIdx.x == 0)
    printf("PHASES bwd coop producer T=%d: counter wait %lld, stage arming "
           "%lld cycles per step\\n", a.T, fw / a.T, fe / a.T);
}
"""),
]
# The cooperative forward on mma.sync (h rows from L2, grid.sync), as the
# commits before its redesign hold it: block (0, 0)'s warp 0 sums its
# cycles a step over the h loads and products (one 16-row tile), the
# cell phase (xw loads, gate chain, stores) and the grid barrier
COOP_OLD_EDITS = [
    ("""                                         const bf16* hcur, bf16* hnext) {
  const int warp""", """                                         const bf16* hcur, bf16* hnext,
                                         long long& tp, long long& tc) {
  const int warp"""),
    ("""    float acc[4][4] = {};
    const bf16* rows = hcur""", """    float acc[4][4] = {};
    const long long k0 = clock64();
    const bf16* rows = hcur"""),
    ("""#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = tile * kRows""", """    const long long k1 = clock64();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = tile * kRows"""),
    ("""                                    acc[2][e], acc[3][e], hcur, hnext);
    }
""", """                                    acc[2][e], acc[3][e], hcur, hnext);
    }
    tp += k1 - k0, tc += clock64() - k1;
"""),
    ("""  DT* hb = static_cast<DT*>(a.hbuf);
  for (int s = 0; s < a.T; ++s) {""", """  DT* hb = static_cast<DT*>(a.hbuf);
  long long tp = 0, tc = 0, tb = 0;
  for (int s = 0; s < a.T; ++s) {"""),
    ("fwd_step<MASKED, STASH>(a, sm, t, s == a.T - 1, r0, nrows, hcur, hnext);",
     "fwd_step<MASKED, STASH>(a, sm, t, s == a.T - 1, r0, nrows, hcur, hnext,"
     " tp, tc);"),
    ("""    if (s + 1 < a.T) grid.sync();  // h_t visible; no block still reads h_{t-1}
  }
""", """    const long long k2 = clock64();
    if (s + 1 < a.T) grid.sync();  // h_t visible; no block still reads h_{t-1}
    tb += clock64() - k2;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    printf("PHASES coop (mma.sync) T=%d B=%d H=%d masked=%d stash=%d rows=%d: h "
           "loads and products %lld, cell %lld, grid barrier %lld cycles per "
           "step\\n", a.T, a.B, a.H, (int)MASKED, (int)STASH, a.rows,
           tp / a.T, tc / a.T, tb / a.T);
"""),
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
# the D=128 dK/dV consumers (the D=256 ones hold some of the same lines)
DVC = "__device__ __forceinline__ void dv_consumer("
DKC = "__device__ __forceinline__ void dk_consumer("
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
    (DVC, "    sm90::fence_regs(s);\n    // P^T = ex2",
     "    sm90::fence_regs(s);\n" + _clock(2, 4) + "    // P^T = ex2"),
    (DVC, "    // hand P^T to warpgroup 1",
     _clock(3, 4) + "    // hand P^T to warpgroup 1"),
    (DVC, "    sm90::mbar_arrive(&sm.p_full[pb]);\n",
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
    (DKC, "    sm90::fence_regs(dp);\n    sm90::mbar_wait(&sm.p_full[pb], "
     "(n >> 1) & 1);\n",
     "    sm90::fence_regs(dp);\n" + _clock(2, 4)
     + "    sm90::mbar_wait(&sm.p_full[pb], (n >> 1) & 1);\n" + _clock(3, 4)),
    (DKC, "    pack16(p, dp);\n", "    pack16(p, dp);\n" + _clock(4, 4)),
    ("    issue_pb64(dk, p, sm.q[st][0]);  // dK += dS^T Q\n"
     "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(dk);\n",
     "    issue_pb64(dk, p, sm.q[st][0]);  // dK += dS^T Q\n"
     "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(dk);\n"
     + _clock(5, 4) + "    " + _DK[1]),
    (_DK[2].split("\n")[-1], _DK[2]),
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
]


def _cl_tally(kind: str, names, at: str):
    """The bf16 cluster backward (`flash_bwd_*_cluster_kernel<D>`): the
    declaration of the per-tile sums, their accumulation from readings
    c0 .. c<len(names)>, and the print of their means before `at`: block
    (0, 0) of the cluster, both ranks, each consumer warpgroup."""
    decl, add, show = _tally(kind, names, at)
    show = show.replace(
        "blockIdx.x == 0 && blockIdx.y == 0",
        "blockIdx.x == 0 && blockIdx.y == 0 && D == 512").replace(
        f"PHASES {kind} wg=%d", f"PHASES cluster {kind} D=%d rank=%d wg=%d"
    ).replace("(int)(threadIdx.x / 128)",
              "D, (int)blockIdx.z, (int)(threadIdx.x / 128)")
    return decl, add, show


_CL_DQ = "__device__ __forceinline__ void cl_dq_consumer(ClDqSmem<D>& sm,"
_CL_DV = "__device__ __forceinline__ void cl_dv_consumer(ClDkvSmem<D>& sm,"
_CL_DK = "__device__ __forceinline__ void cl_dk_consumer(ClDkvSmem<D>& sm,"
_CLQ = _cl_tally("dQ", ["stage wait", "S and dP", "push", "exchange wait",
                        "P and dS", "dQ product"],
                 "  // every tile is exchanged: the exchange buffers hold the "
                 "two hand-overs")
_CLV = _cl_tally("dK/dV", ["push, next issue", "exchange wait", "P^T",
                           "hand-over", "dV product, next S^T"],
                 "  store_wg(dv, 1.f, static_cast<bf16*>(a.out1) + rank * "
                 "HALF, a.so1, b, h,")
_CLK = _cl_tally("dK/dV", ["push, next issue", "exchange wait",
                           "dsum, P^T wait", "dS^T", "dK product, next dP^T"],
                 "  store_wg(dk, a.scale, static_cast<bf16*>(a.out0) + rank "
                 "* HALF, a.so0, b,")
_RELEASE = "    if (l == 0) sm90::mbar_arrive(&sm.empty[st]);\n"
# the bf16 backward at D = 384 and 512 ("wgmma cluster"): per tile, each
# consumer warpgroup's stage wait, score product, the partial exchange
# (the pushes into the peer block, the wait for the peer's), the
# element-wise work and the output product
CLUSTER_BF16_EDITS = [
    (_CL_DQ, "  for (int i = 0; i < NO; ++i) dq[i] = 0.f;\n",
     "  for (int i = 0; i < NO; ++i) dq[i] = 0.f;\n" + _CLQ[0]),
    (_CL_DQ, "    sm90::mbar_wait(&sm.full[st], (j / NS) & 1);\n",
     _clock(0, 4) + "    sm90::mbar_wait(&sm.full[st], (j / NS) & 1);\n"
     + _clock(1, 4)),
    (_CL_DQ, "    sm90::fence_regs(dp);\n    // the partial scores meet",
     "    sm90::fence_regs(dp);\n" + _clock(2, 4)
     + "    // the partial scores meet"),
    (_CL_DQ, "    cl_meet(&sm.x_full[wg][m & 1],",
     _clock(3, 4) + "    cl_meet(&sm.x_full[wg][m & 1],"),
    (_CL_DQ, "    const bool diag = wide_diag(",
     _clock(4, 4) + "    const bool diag = wide_diag("),
    (_CL_DQ, "    wide_pack(p, s);\n", "    wide_pack(p, s);\n" + _clock(5, 4)),
    (_CL_DQ, "    sm90::fence_regs(dq);\n    if (l == 0)",
     "    sm90::fence_regs(dq);\n" + _clock(6, 4) + "    " + _CLQ[1]
     + "    if (l == 0)"),
    (_CLQ[2].split("\n")[-1], _CLQ[2]),
    (_CL_DV, "  for (int i = 0; i < HALF / 2; ++i) dv[i] = 0.f;\n",
     "  for (int i = 0; i < HALF / 2; ++i) dv[i] = 0.f;\n" + _CLV[0]),
    (_CL_DV, "    float* xs = sm.x[0][pb];\n",
     _clock(0, 4) + "    float* xs = sm.x[0][pb];\n"),
    (_CL_DV, "    cl_meet(&sm.x_full[0][pb],",
     _clock(1, 4) + "    cl_meet(&sm.x_full[0][pb],"),
    (_CL_DV, "    // P^T = ex2", _clock(2, 4) + "    // P^T = ex2"),
    (_CL_DV, "    // hand P^T to warpgroup 1",
     _clock(3, 4) + "    // hand P^T to warpgroup 1"),
    (_CL_DV, "    wide_pack(p, s);\n", "    wide_pack(p, s);\n" + _clock(4, 4)),
    (_CL_DV, _RELEASE, _clock(5, 4) + "    " + _CLV[1] + _RELEASE),
    (_CLV[2].split("\n")[-1], _CLV[2]),
    (_CL_DK, "  for (int i = 0; i < HALF / 2; ++i) dk[i] = 0.f;\n",
     "  for (int i = 0; i < HALF / 2; ++i) dk[i] = 0.f;\n" + _CLK[0]),
    (_CL_DK, "    float* xs = sm.x[1][pb];\n",
     _clock(0, 4) + "    float* xs = sm.x[1][pb];\n"),
    (_CL_DK, "    cl_meet(&sm.x_full[1][pb],",
     _clock(1, 4) + "    cl_meet(&sm.x_full[1][pb],"),
    (_CL_DK, "    const float* Ds = sm.dsum[st];\n",
     _clock(2, 4) + "    const float* Ds = sm.dsum[st];\n"),
    (_CL_DK, "    const float4* pt = reinterpret_cast<const float4*>(sm.pt[pb]);\n",
     _clock(3, 4)
     + "    const float4* pt = reinterpret_cast<const float4*>(sm.pt[pb]);\n"),
    (_CL_DK, "    wide_pack(p, d);\n", "    wide_pack(p, d);\n" + _clock(4, 4)),
    (_CL_DK, _RELEASE, _clock(5, 4) + "    " + _CLK[1] + _RELEASE),
    (_CLK[2].split("\n")[-1], _CLK[2]),
]


def _chunk_clocks(wait: str, split: str, product: str, add: str) -> tuple:
    """(text, instrumented text) of a split-TF32 consumer's chunk: the
    stage wait, the split of the RW tile, the three-pass product and the
    release with the f32 adds, each summed over the step's chunks."""
    text = wait + split + product + add
    new = (_clock(0, 6) + wait + _clock(1, 6) + split + _clock(2, 6)
           + product + _clock(3, 6) + add + _clock(4, 6)
           + "      tw += c1 - c0; tsp += c2 - c1; tm += c3 - c2; "
             "ta += c4 - c3;\n")
    return text, new


_TF_DECL = ("  long long tw = 0, tsp = 0, tm = 0, ta = 0, tc = 0, tb = 0, "
            "tst = 0;\n  int steps = 0;\n")


def _tf_show(kind: str) -> str:
    return ("  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 == 0)"
            "\n    printf(\"PHASES " + kind + " wg=%d, %d steps, %d chunks a "
            "pass: stage waits %lld, splits %lld, products %lld, release and "
            "adds %lld, cell phase %lld, barrier %lld, dh staging %lld cycles "
            "per step\\n\", (int)(threadIdx.x / 128), steps, nch, "
            "tw / steps, tsp / steps, tm / steps, ta / steps, tc / steps, "
            "tb / steps, tst / steps);\n")


_TFF = _chunk_clocks(
    "        sm90::mbar_wait(&sm.full[st], (q / S) & 1);\n",
    "        named_sync(2 + wg, 128);  // every warp is done with ws\n"
    "        split_tile<4 * 32 * kTfK, 128>(sm.w[st][wg], sm.ws[wg], wt);\n"
    "        named_sync(2 + wg, 128);  // the warpgroup's RW tile is split\n",
    "        tf_chunk(fresh, sm.a[st][0], sm.a[st][1], sm.w[st][wg], "
    "sm.ws[wg]);\n",
    "        if (c + 1 < nch)  // the pass's last stage is released after its "
    "cells\n          sm90::mbar_arrive_cluster(&sm.empty[st], wt / 8, "
    "releases);\n        add_chunk(z, fresh);\n")
_TFB = _chunk_clocks(
    "      sm90::mbar_wait(&sm.full[st], (q / S) & 1);\n", "",
    "      tf_chunk(fresh, sm.a[st][0] + a_off, sm.a[st][1] + a_off, "
    "sm.w[st][0],\n               sm.w[st][1]);\n",
    "      sm90::mbar_arrive_cluster(&sm.empty[st], wt / 8, releases);\n"
    "      add_chunk(dh, fresh);\n")
# the split-TF32 kernels (f32): per step, the stage waits, the RW splits,
# the products and the f32 adds summed over the step's chunks, the cell
# phase, the cluster barrier (and, backward, the dh carry's staging)
TF32_EDITS = [
    ("  float fresh[64], z[64];\n", "  float fresh[64], z[64];\n" + _TF_DECL),
    _TFF,
    ("      // ---- the product to shared memory (warps 0, 1",
     _clock(5, 6) + "      // ---- the product to shared memory (warps 0, 1"),
    ("      // the held stage goes back to the producer once every warp is "
     "done\n",
     _clock(6, 6) + "      tc += c6 - c5;\n"
     "      // the held stage goes back to the producer once every warp is "
     "done\n"),
    ("    sm90::cluster_sync();  // h_t is stored (and fenced for TMA) by "
     "all\n  }\n",
     _clock(7, 4) + "    sm90::cluster_sync();  // h_t is stored (and fenced "
     "for TMA) by all\n" + _clock(8, 4) + "    tb += c8 - c7; ++steps;\n"
     "  }\n" + _tf_show("tf32 fwd")),
    ("  float fresh[64], dh[64];\n", "  float fresh[64], dh[64];\n" + _TF_DECL),
    ("    const TfStep sp(a, s);\n    // ---- cell phase: dz[t]",
     "    const TfStep sp(a, s);\n" + _clock(5, 4)
     + "    // ---- cell phase: dz[t]"),
    ("    __syncwarp();\n    tile_to_acc(dh, dhw, 16 * w, g, tq);\n"
     "    sm90::fence_proxy_async();  // dz[t] is read back by TMA\n"
     "    sm90::cluster_sync();\n",
     _clock(6, 4) + "    __syncwarp();\n    tile_to_acc(dh, dhw, 16 * w, g, tq);\n"
     "    sm90::fence_proxy_async();  // dz[t] is read back by TMA\n"
     "    sm90::cluster_sync();\n" + _clock(7, 4)
     + "    tc += c6 - c5; tb += c7 - c6; ++steps;\n"),
    _TFB,
    ("ta += c4 - c3;\n    }\n    if (sp.first) {",
     "ta += c4 - c3;\n    }\n" + _clock(8, 4) + "    if (sp.first) {"),
    ("    acc_to_tile(dhw, dh, 16 * w, g, tq);\n    __syncwarp();\n  }\n}\n",
     "    acc_to_tile(dhw, dh, 16 * w, g, tq);\n    __syncwarp();\n"
     + _clock(9, 4) + "    tst += c9 - c8;\n  }\n" + _tf_show("tf32 bwd")
     + "}\n"),
]


def _cluster_edits(kind: str, wait: str, split: str, sync: str, sums: str,
                   last: str, end: str,
                   rest: str = "P, dS and products") -> list:
    """The f32 cluster backward (`kind` "dQ" or "dK/dV"): each warp of block
    (0, 0, 0) sums its SM cycles per streamed step over the step's phases:
    the stage wait (cp.async and the block barrier), the in-place split,
    the partial scores, the cluster barrier, the exchange (the C members'
    partials read and added), and P, dS and the output products (the last
    two 0 where the warp's rows skip the tile)."""
    names = ["stage wait", "split", "scores", "barrier", "exchange", rest]
    acc = [f"tk{i}" for i in range(len(names))]
    decl = "  long long " + ", ".join(f"{x} = 0" for x in acc) \
        + ";\n  int steps = 0;\n"
    add = "".join(f"{x} += ck{i + 1} - ck{i}; " for i, x in enumerate(acc))
    fmt = ", ".join(f"{x} %lld" for x in names)
    means = ", ".join(f"{x} / (steps > 0 ? steps : 1)" for x in acc)
    show = (f"  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && "
            f"threadIdx.x % 32 == 0)\n    printf(\"PHASES tf32 cluster "
            f"{kind} D=%d warp=%d, %d steps: {fmt} cycles per step\\n\", D, "
            f"(int)(threadIdx.x / 32), steps, {means});\n")

    def clock(i: int, indent: int) -> str:
        return " " * indent + f"const long long ck{i} = clock64();\n"

    head, rest = wait.split("\n", 1)
    return [
        (wait, decl + head + "\n" + clock(0, 4) + rest + clock(1, 4)),
        (split, split + clock(2, 4)),
        (sync, clock(3, 4) + sync + clock(4, 4)
         + "    long long ck5 = ck4;\n"),
        (sums, sums + "      ck5 = clock64();\n"),
        (last, last.replace("    }\n  }\n", "    }\n"
                            + "    const long long ck6 = live ? clock64() "
                            ": ck4;\n    " + add + "++steps;\n  }\n")),
        (end, end + show),
    ]


# the f32 kernels at D = 256, 384 and 512 (split-TF32 clusters)
CLUSTER_EDITS = _cluster_edits(
    "fwd",
    "  for (int kj = 0; kj < nk; ++kj) {\n"
    "    cp_async_wait<0>();  // the K, V slices of tile kj staged\n"
    "    __syncthreads();     // ... and every warp done with kj - 1\n",
    "    const TfStage kv = tc_split(sm, kj & 1);  // K, V\n",
    "    sm90::cluster_sync();  // every member's partial scores of tile kj "
    "stored\n",
    "      sum_partials<C>(sm.partial(kj), s);\n",
    "      warp_pb_tf32<NO, NS, LD, true>(o, s, kv.tile[1]);  // P V\n"
    "    }\n  }\n",
    "  sm90::cluster_sync();  // the peers have read this member's last "
    "partials\n  tf_fwd_store(o, m, lsum, a, bh, row, c0, blockIdx.z == 0);\n",
    rest="softmax and P V",
) + _cluster_edits(
    "dQ",
    "  for (int kj = 0; kj < nk; ++kj) {\n"
    "    cp_async_wait<0>();  // K, V of tile kj staged\n"
    "    __syncthreads();     // ... and every warp done with tile kj - 1\n",
    "    const TfStage kv = tc_split(sm, kj & 1);\n",
    "    sm90::cluster_sync();  // every member's partials of tile kj stored\n",
    "      sum_partials<C>(sm.partial(kj), s, dp);\n",
    "      warp_pb_tf32<NO, NS, LD, true>(dq, s, kv.tile[0]);  // dS K\n"
    "    }\n  }\n",
    "  sm90::cluster_sync();  // the peers have read this member's last "
    "partials\n  store_acc_tf32(dq, a.scale, a.out0, a.so0, b, h, row, c0);\n",
) + _cluster_edits(
    "dK/dV",
    "  for (int qi = q_first; qi < nq; ++qi) {\n"
    "    const int n = qi - q_first;\n"
    "    cp_async_wait<0>();  // Q, dO, L, dsum of tile qi staged\n"
    "    __syncthreads();     // ... and every warp done with tile qi - 1\n",
    "    const TfStage st = tc_split(sm, n & 1);\n",
    "    sm90::cluster_sync();  // every member's partials of tile qi stored\n",
    "      sum_partials<C>(sm.partial(n), s, dp);\n",
    "      warp_pb_tf32<NO, NS, LD, true>(dk, dp, st.tile[0]);  // dS^T Q\n"
    "    }\n  }\n",
    "  sm90::cluster_sync();  // the peers have read this member's last "
    "partials\n  store_acc_tf32(dk, a.scale, a.out0, a.so0, b, h, key, "
    "c0);\n",
)


def instrumented(src: str, edits) -> str:
    """`src` with each edit made: (text, new) replaces the one occurrence
    of `text`; (after, text, new) the first `text` after `after`'s one
    occurrence."""
    for *after, text, new in edits:
        at = 0
        if after:
            if src.count(after[0]) != 1:
                raise RuntimeError(f"instrumentation anchor not found once: "
                                   f"{after[0][:60]!r}")
            at = src.index(after[0])
        elif src.count(text) != 1:
            raise RuntimeError(f"instrumentation anchor not found once: "
                               f"{text[:60]!r}")
        i = src.find(text, at)
        if i < 0:
            raise RuntimeError(f"instrumentation text not found: "
                               f"{text[:60]!r}")
        src = src[:i] + new + src[i + len(text):]
    return src


def run(root: str) -> None:
    """In the copy's process: the cooperative forward at row 5's shape and
    at path 4s's window, the three LSTM forward launches, the f32 kernels
    and the flash backward's kernels."""
    import torch

    sys.path[:0] = [root, REPO]
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import lstm as L

    for mod in (L, fa):
        if not mod.__file__.startswith(root):
            raise RuntimeError(f"ran {mod.__file__}")
    for T, B, masked, stash in ((64, 128, False, True),
                                (64, 128, False, False),
                                (64, 128, True, True), (50, 32, False, True)):
        inp = cs.lstm_inputs(torch, T, B, 1024, torch.bfloat16, 76, masked)
        L.lstm_fwd(inp["xw"], inp["rw"], inp["peep"], inp["h0"], inp["c0"],
                   inp["mask"], with_stash=stash)
        torch.cuda.synchronize()
    # the bf16 backward at the same shapes (the cooperative kernel where
    # the package has one); the forward's prints come first
    for T, B, masked in ((50, 32, False), (64, 128, False), (64, 128, True)):
        inp = cs.lstm_inputs(torch, T, B, 1024, torch.bfloat16, 79, masked)
        cs.lstm_run(L, inp, False)
        torch.cuda.synchronize()
    for T, B, H, masked in ((8, 2048, 1024, False), (8, 8192, 256, False),
                            (8, 8192, 256, True)):
        inp = cs.lstm_inputs(torch, T, B, H, torch.bfloat16, 77, masked)
        L.lstm_fwd(inp["xw"], inp["rw"], inp["peep"], inp["h0"], inp["c0"],
                   inp["mask"])
        torch.cuda.synchronize()
    for T, B, H, masked in ((8, 2048, 1024, False), (8, 8192, 256, True)):
        inp = cs.lstm_inputs(torch, T, B, H, torch.float32, 78, masked)
        cs.lstm_run(L, inp, False)
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
    for D, dt in ((256, torch.float32), (384, torch.float32),
                  (512, torch.float32), (512, torch.bfloat16)):
        q, k, v, do = cs.flash_inputs(torch, 2, 2048, 4, D, dt, seed=D)
        o, lse = fa.flash_forward(q, k, v, True, None, with_lse=True)
        dsum = fa._dsum(o, do)
        fa.flash_bwd_dq(q, k, v, do, lse, dsum, True, None)
        torch.cuda.synchronize()
        fa.flash_bwd_dkv(q, k, v, do, lse, dsum, True, None)
        torch.cuda.synchronize()


def main(argv) -> int:
    """`chip_phase_profile.py [--package DIR]`: instrument the package at
    DIR (default: the checkout's; a copy of an earlier commit's package
    gets the cooperative forward in the form it holds there)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_phase_profile: no CUDA device available", file=sys.stderr)
        return 2
    pkg = os.path.join(REPO, PKG)
    if "--package" in argv:
        pkg = os.path.abspath(argv[argv.index("--package") + 1])
    root = tempfile.mkdtemp(prefix="kernel_phases_")
    try:
        shutil.copytree(pkg, os.path.join(root, PKG),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = os.path.join(root, PKG, "csrc", "lstm.cu")
        with open(path) as f:
            text = f.read()
        old_coop = "cg::this_grid()" in text
        has_bwd_coop = "lstm_bwd_coop_kernel" in text
        for name, edits in (
                ("lstm", LSTM_EDITS + TF32_EDITS
                 + (COOP_OLD_EDITS if old_coop else COOP_EDITS)
                 + (BWD_COOP_EDITS if has_bwd_coop else [])),
                ("flash_attention",
                 FLASH_EDITS + CLUSTER_EDITS + CLUSTER_BF16_EDITS)):
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
    sys.exit(main(sys.argv[1:]))
