#!/usr/bin/env python3
"""Mutation check of the kernels' correctness checks on one NVIDIA card:
does `chip_smoke.py`'s comparison against the plain versions catch a
kernel that is wrong?

    python3 chip_fault_check.py      # about 15 minutes on an H100
    python3 chip_fault_check.py "lstm f32"   # the faults named so only

For the unchanged sources and for each planted fault below, the script
copies `deeplearning4j_tpu_torch/` into a temporary directory, plants the
fault in the copy's `csrc/flash_attention.cu`, `csrc/paged_attention.cu`
or `csrc/lstm.cu` (the checkout is never changed), builds every copy with
nvcc in parallel, and then runs the faulted kernel family's check in one
process per copy (the unchanged copy runs all three):

- flash: the forward, dQ and dK/dV kernels on the cases below, bf16 (at
  D = 128 the wgmma kernels, at D = 256 the mma.sync ones) and f32 (the
  split-TF32 kernels at D = 128 and 256), held to the plain versions in
  f32 with `flash_attention.error_in_tolerances` (O, dQ, dK, dV row by
  row; L absolute; 2^-6 bf16, 1e-4 f32), as `chip_smoke.py` does. Beside
  it, each case is also read against the earlier bound (the largest
  absolute error within 2e-2 of the reference's largest magnitude), to
  show what that bound let through;
- paged: every case of `chip_smoke.paged_cases` (dense and int8 pools,
  decode, verify and chunk widths, the ragged row tiles, head dims 64 to
  256, pages of 1 to 512), read in units of the tolerance atol + rtol *
  |ref|; a non-finite output or a written inactive lane counts as
  infinite;
- lstm: every case of `chip_smoke.lstm_cases` (forward and backward
  kernels, f32 and bf16, masked and not, forward and reverse, both bf16
  forward routes, the ragged H=196, odd 195 and 385, B=37 and 300,
  H=384, 2048 and the main paths' widths), each output held row by row
  to the plain versions (`lstm.error_in_tolerances`), as phase 11 does,
  and the f32 kernels on one step whose product cancels
  (`chip_smoke.lstm_cancel_units`, against the plain version in f64).

The faults (`MUTATIONS`) drop tiles, terms or rows, and break each
mechanism of the Hopper kernels: the forward's diagonal mask on the wrong
tile and a K/V ring stage refilled before its release; the D = 128
backward's ring stages refilled before their release, P^T read before its
barrier, the diagonal mask on the wrong tile, the first visible Q tile off
by one, L and dsum of the neighbouring Q tile, and a far tile (40)
skipped; the f32 kernels' split TF32 (the small terms dropped, which is
one TF32 pass, and the big part not rounded by cvt.rna, which the tensor
cores then truncate, and the block's split pass over the streamed tiles
writing no small parts), their fresh accumulators overwriting the running
sums, each f32 kernel's diagonal tile skipped and its final K/V (or Q)
tile dropped; the paged walk's
split merge, key slices and int8 rounding point; the bf16 LSTM
backward's cluster barrier between its two phases, and its row tile
reading dz from the next tile's rows; the bf16 LSTM forward's h rows
loaded before the cluster barrier and its xw tile of the wrong step; the
f32 LSTM kernels' split TF32 (the small terms dropped, h_t's or dz[t]'s
small plane left stale, the other unit group's RW small parts, one
accumulator chained over all of K, which only the cancelling cases
show) and the forward's h rows loaded before the cluster barrier. A
fault that makes the kernel trap (an mbarrier wait that times out) fails
its check process, which counts as caught.

Arguments, if any, keep only the faults whose names contain one of them
(the unchanged sources always run). Prints a table and, as the last
line, one JSON object
`{"control_ok": ..., "mutants": [{"name", "caught", "caught_by_old_bound",
"worst": ...}]}`. Exits 0 when the unchanged kernels pass every case and
every planted fault fails at least one; non-zero otherwise, or without a
CUDA device.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "deeplearning4j_tpu_torch"
FLASH, PAGED, LSTM = "flash_attention", "paged_attention", "lstm"
# (B, T, H, D, causal, dtype): bf16, the training path's kernels at D = 128
# and the same templates at D = 256; f32, the split-TF32 kernels (path
# 2f's at D = 128)
CASES = [(2, 512, 2, 128, False, "bfloat16"), (2, 512, 2, 128, True,
                                               "bfloat16"),
         (1, 4096, 2, 128, True, "bfloat16"),
         (2, 512, 2, 256, True, "bfloat16"),
         (1, 4096, 2, 256, False, "bfloat16"),
         (2, 512, 2, 128, False, "float32"), (2, 512, 2, 128, True,
                                              "float32"),
         (1, 4096, 2, 128, True, "float32"),
         (1, 4096, 2, 128, False, "float32"),
         (2, 512, 2, 256, True, "float32")]
OLD_BOUND = 2e-2
# (name, source, anchor, edits): each edit (text, replacement) replaces the
# first `text` after `anchor`, in order
FWD = "void flash_fwd_consumer(WgFwdSmem& sm,"
FWDP = "flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,"
DQ = "flash_bwd_dq_mma_kernel(const Args a) {"
DKV = "flash_bwd_dkv_mma_kernel(const Args a) {"
DQW = "flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,"
DKVW = "flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,"
DQC = "__device__ __forceinline__ void dq_consumer("
DVC = "__device__ __forceinline__ void dv_consumer("
DKC = "__device__ __forceinline__ void dk_consumer("
MMA3 = "__device__ __forceinline__ void mma3("
SPLIT = "__device__ __forceinline__ void split_tf32("
SPLIT_TILE = "__device__ __forceinline__ void split_tile("
ADD_ACC = "__device__ __forceinline__ void add_acc("
FWDT = "flash_fwd_tf32_kernel(const Args a) {"
DQT = "flash_bwd_dq_tf32_kernel(const Args a) {"
DKVT = "flash_bwd_dkv_tf32_kernel(const Args a) {"
NK_TF = "const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB;"
SCAL = "paged_attention_kernel(const Call c) {"
PV = "// acc (TR, hd) = acc * corr + P . V"
STAGE = "__device__ __forceinline__ void stage_slice("
KVV = "__device__ __forceinline__ float kv_value("
MERGE = "paged_merge_kernel(const Call c) {"
CELL = "__device__ __forceinline__ void fwd_cell("
CONS = "__device__ void cluster_consumer(ClusterSmem& sm,"
PROD = "__device__ void cluster_producer(ClusterSmem& sm,"
FWDK = "lstm_fwd_kernel(const FwdArgs a) {"
FCONS = "__device__ void fwd_consumer(FwdClusterSmem<ROWS>& sm,"
TFC = "__device__ __forceinline__ void tf_chunk("
TFF = "__device__ void tf_fwd_consumer(TfFwdSmem& sm,"
TFB = "__device__ void tf_bwd_consumer(TfBwdSmem& sm,"
TF_PASSES = ("    if (kk == 0)\n"
             "      sm90::wgmma_m64n128k8_tf32_zero(d, das, dbb);  // a fresh "
             "accumulator\n"
             "    else\n"
             "      sm90::wgmma_m64n128k8_tf32(d, das, dbb, 1);\n"
             "    sm90::wgmma_m64n128k8_tf32(d, dab, dbs, 1);\n"
             "    sm90::wgmma_m64n128k8_tf32(d, dab, dbb, 1);\n")
DZ_SPLIT = ("        st_split(a.dzbuf, zp, zi, dzi);\n"
            "        st_split(a.dzbuf, zp, zi + H, dzf);\n"
            "        st_split(a.dzbuf, zp, zi + 2 * H, dzo);\n"
            "        st_split(a.dzbuf, zp, zi + 3 * H, dzg);\n")
MUTATIONS = [
    ("forward skips the last K/V tile", FLASH, FWDP, [
        ("const int nk = a.causal ? qi + 1 : a.Tk / kWgRows;",
         "const int nk = a.causal ? qi : a.Tk / kWgRows - 1;")]),
    ("forward drops P.V of the last K/V tile (L intact)", FLASH, FWD, [
        ("issue_pv(o, p, sm, s);", "if (j + 1 < nk) issue_pv(o, p, sm, s);")]),
    ("forward drops P.V of the second-to-last K/V tile (L intact)", FLASH,
     FWD, [("issue_pv(o, p, sm, s);",
            "if (j + 2 != nk) issue_pv(o, p, sm, s);")]),
    # far from the diagonal: only rows that see more than 2560 keys (the
    # T=4096 cases) lose 128 of them, a small change to rows of small values
    ("forward drops P.V of K/V tile 20 (L intact)", FLASH, FWD, [
        ("issue_pv(o, p, sm, s);", "if (j != 20) issue_pv(o, p, sm, s);")]),
    ("forward masks the first K/V tile as if diagonal, not the diagonal",
     FLASH, FWD, [("a.causal && j == nk - 1,", "a.causal && j == 0,")]),
    ("forward refills a K/V stage before its release (empty waits skipped)",
     FLASH, FWDP, [("sm90::mbar_wait(&sm.k_empty[s], par);", ""),
                   ("sm90::mbar_wait(&sm.v_empty[s], par);", "")]),
    ("dQ drops dS.K of K/V tile 40", FLASH, DQ, [
        ("warp_pb<NO, KB / 16, LD>(dq, s, K + c0);",
         "if (kj != 40) warp_pb<NO, KB / 16, LD>(dq, s, K + c0);")]),
    ("dV drops P^T.dO of Q tile 40", FLASH, DKV, [
        ("warp_pb<NO, KB / 16, LD>(dv, s, dO + c0);",
         "if (qi != 40) warp_pb<NO, KB / 16, LD>(dv, s, dO + c0);")]),
    ("dQ skips the last K/V tile", FLASH, DQ, [
        ("const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB;",
         "const int nk = a.causal ? (q0 + BLK) / KB - 1 : a.Tk / KB - 1;")]),
    ("dK/dV skips the last Q tile", FLASH, DKV, [
        ("const int nq = a.Tq / KB;", "const int nq = a.Tq / KB - 1;")]),
    ("dK drops the dsum term", FLASH, DKV, [
        ("s[j][e] *= dp[j][e] - Ds[8 * j + 2 * t + (e & 1)];",
         "s[j][e] *= dp[j][e];")]),
    ("dQ (wgmma) refills a K/V stage before its release", FLASH, DQW, [
        ("sm90::mbar_wait(&sm.empty[s], ((j / kBwStages) & 1) ^ 1);", "")]),
    ("dK/dV (wgmma) refills a Q/dO stage before its release", FLASH, DKVW, [
        ("sm90::mbar_wait(&sm.empty[s], ((n / kBwStages) & 1) ^ 1);", "")]),
    ("dK (wgmma) reads P^T before its barrier", FLASH, DKC, [
        ("sm90::mbar_wait(&sm.p_full[pb], (n >> 1) & 1);", "")]),
    ("dQ (wgmma) masks the first K/V tile, not the diagonal", FLASH, DQC, [
        ("const bool diag = a.causal && j == nk_wg - 1;",
         "const bool diag = a.causal && j == 0;")]),
    ("dK/dV (wgmma) masks the Q tile after the diagonal", FLASH, DVC, [
        ("const bool diag = a.causal && qi == kj;",
         "const bool diag = a.causal && qi == kj + 1;")]),
    ("dK/dV (wgmma) starts one Q tile after the diagonal", FLASH, DKVW, [
        ("const int q_first = a.causal ? kj : 0;",
         "const int q_first = a.causal ? kj + 1 : 0;")]),
    # tiles 0 <-> 1, 2 <-> 3, ...: always inside the tensor
    ("dK/dV (wgmma) takes L and dsum of the neighbouring Q tile", FLASH,
     DKVW, [("sm90::bulk_load(sm.lse[s], lse + r0,",
             "sm90::bulk_load(sm.lse[s], lse + (r0 ^ kBwRows),"),
            ("sm90::bulk_load(sm.dsum[s], dsum + r0,",
             "sm90::bulk_load(sm.dsum[s], dsum + (r0 ^ kBwRows),")]),
    ("dQ (wgmma) skips K/V tile 40", FLASH, DQC, [
        ("if (j < nk_wg) {", "if (j < nk_wg && j != 40) {")]),
    ("dV (wgmma) drops P^T.dO of Q tile 40", FLASH, DVC, [
        ("issue_pb64(dv, p, sm.dO[st][0]);",
         "if (qi != 40) issue_pb64(dv, p, sm.dO[st][0]);")]),
    ("f32 (TF32): the small terms dropped (one TF32 pass)", FLASH, MMA3, [
        ("  mma_tf32(d, a.small, b.big[0], b.big[1]);\n"
         "  mma_tf32(d, a.big, b.small[0], b.small[1]);\n", "")]),
    ("f32 (TF32): the big part not rounded by cvt.rna (truncated)", FLASH,
     SPLIT, [("big = tf32_rna(x);", "big = __float_as_uint(x);")],
     "sm90.cuh"),
    ("f32 (TF32): the block's split pass drops the small parts", FLASH,
     SPLIT_TILE, [("make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),\n"
                   "                       __uint_as_float(s[2]), "
                   "__uint_as_float(s[3])));",
                   "make_float4(0.f, 0.f, 0.f, 0.f));")]),
    ("f32 (TF32): a fresh accumulator overwrites the running sum", FLASH,
     ADD_ACC, [("acc[e] += t[e];", "acc[e] = t[e];")]),
    ("f32 forward (TF32) skips its diagonal K/V tile", FLASH, FWDT, [
        (NK_TF, "const int nk = a.causal ? (q0 + BLK) / KB - 1 : a.Tk / KB;")]),
    ("f32 forward (TF32) drops the final K/V tile", FLASH, FWDT, [
        (NK_TF, "const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB - 1;")]),
    ("f32 dQ (TF32) skips its diagonal K/V tile", FLASH, DQT, [
        (NK_TF, "const int nk = a.causal ? (q0 + BLK) / KB - 1 : a.Tk / KB;")]),
    ("f32 dQ (TF32) drops the final K/V tile", FLASH, DQT, [
        (NK_TF, "const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB - 1;")]),
    ("f32 dK/dV (TF32) starts one Q tile after the diagonal", FLASH, DKVT, [
        ("const int q_first = a.causal ? k0 / KB : 0;",
         "const int q_first = a.causal ? k0 / KB + 1 : 0;")]),
    ("f32 dK/dV (TF32) drops the final Q tile", FLASH, DKVT, [
        ("const int nq = a.Tq / KB;", "const int nq = a.Tq / KB - 1;")]),
    ("int8: V dequantized with the K scales", PAGED, PV, [
        ("if constexpr (kQuant) vsc = cVs[kk + x];",
         "if constexpr (kQuant) vsc = cKs[kk + x];")]),
    ("int8: the other slice buffer's K scale row", PAGED, SCAL, [
        ("const float* cKs = sKs + buf * ks;",
         "const float* cKs = sKs + (buf ^ 1) * ks;")]),
    ("int8: one slice's K scales skipped", PAGED, SCAL, [
        ("if constexpr (kQuant) ksc = cKs[kk];",
         "if constexpr (kQuant) ksc = j == 3 ? 1.f : cKs[kk];")]),
    ("paged: the last row of a ragged row tile never walked or written",
     PAGED, SCAL, [("const int tr = min(TR, R - r0);",
                    "const int tr = min(TR, R - r0) - (R - r0 < TR);")]),
    ("paged: a split's partial l dropped from the merge", PAGED, MERGE, [
        ("const float L = warp_sum(wp * lp);",
         "const float L = warp_sum(lane == 1 ? 0.f : wp * lp);")]),
    ("paged: a key slice read from the next page", PAGED, STAGE, [
        ("c.n_pages + key / page]",
         "c.n_pages + min(key / page + 1, c.n_pages - 1)]")]),
    ("paged: the int8 scale applied after the rounding to q's type", PAGED,
     KVV, [("return to_f32(from_f32<T>((float)v * scale));",
            "return to_f32(from_f32<T>((float)v)) * scale;")]),
    ("lstm: the input gate's peephole term dropped", LSTM, CELL, [
        ("const float i = sigm(zi + sm.peep[ul] * c);",
         "const float i = sigm(zi);")]),
    ("lstm: the masked select taken on the wrong side (c)", LSTM, CELL, [
        ("cs = mp ? cn : c;", "cs = mp ? c : cn;")]),
    ("lstm: backward c_prev at the first step not taken from c0", LSTM,
     CONS, [("sp.first ? a.c0 + (long long)r * H + u",
             "sp.first ? a.c + (long long)r * H + u")]),
    ("lstm: forward skips the grid barrier", LSTM, FWDK, [
        ("if (s + 1 < a.T) grid.sync();",
         "if (s + 1 < a.T && a.T < 0) grid.sync();")]),
    # f32 keeps a ragged H (196 = 128 + 68 units in two blocks)
    ("lstm: the last 4 units of a ragged f32 block never written", LSTM,
     TFF, [("      if (u < H) {\n        const float pI",
            "      if (u < (u0 + kTfFwdUnits > H ? H - 4 : H)) {\n"
            "        const float pI")]),
    # the consumers meet the cluster at the start of each step instead of
    # between the cell phase and the product: the barrier between the
    # phases is skipped, and the products read dz[t] before it is stored
    ("lstm: backward skips the cluster barrier between the phases", LSTM,
     CONS, [("    // ---- cell phase: dz[t] of this thread's rows and units",
             "    sm90::cluster_sync();"),
            ("    sm90::fence_proxy_async();  // dz[t] is read back by TMA\n"
             "    sm90::cluster_sync();\n", "")]),
    ("lstm: backward reads a row tile's dz from the next tile's rows", LSTM,
     PROD, [("c * kChunk, r0, sp.t);", "c * kChunk, r0 + kTileRows, sp.t);"),
            ("r0 + rank * slice, sp.t);",
             "r0 + kTileRows + rank * slice, sp.t);")]),
    # the consumers meet the cluster right after the product, before the
    # cell phase stores h_t: the producer then loads the h rows before they
    # are published (and fills the ring while the cell phase uses it)
    ("lstm: forward cluster reads h[t-1] before the barrier", LSTM, FCONS, [
        ("    // both warpgroups' products are done with the ring: it holds "
         "the tiles\n", "    sm90::cluster_sync();\n"),
        ("    sm90::cluster_sync();\n  }\n  if (tid == 0) "
         "sm90::bulk_wait<0>();",
         "  }\n  if (tid == 0) sm90::bulk_wait<0>();")]),
    ("lstm: forward uses the xw tile of step t+1 at step t", LSTM, FCONS, [
        ("u0 + 64 * gi, k, r0, t);",
         "u0 + 64 * gi, k, r0, min(t + 1, a.T - 1));")]),
    # the f32 LSTM kernels (split TF32 on wgmma)
    ("lstm f32 (TF32): the small terms dropped (one TF32 pass)", LSTM, TFC, [
        (TF_PASSES,
         "    if (kk == 0)\n"
         "      sm90::wgmma_m64n128k8_tf32_zero(d, dab, dbb);\n"
         "    else\n"
         "      sm90::wgmma_m64n128k8_tf32(d, dab, dbb, 1);\n")]),
    # each ping-pong buffer's small plane is written at steps 0 and 1 only
    ("lstm f32 (TF32): h_t's small plane left stale after step 1", LSTM,
     TFF, [("st_split(hnext, a.plane, (long long)r * a.ldh + u, hs);",
            "{ uint32_t b_, s_; sm90::split_tf32(hs, b_, s_);\n"
            "hnext[(long long)r * a.ldh + u] = __uint_as_float(b_);\n"
            "if (s < 2) hnext[a.plane + (long long)r * a.ldh + u] = "
            "__uint_as_float(s_); }")]),
    ("lstm f32 (TF32): dz[t]'s small plane left stale after step 0", LSTM,
     TFB, [(DZ_SPLIT,
            "        { const float v_[4] = {dzi, dzf, dzo, dzg};\n"
            "          for (int q_ = 0; q_ < 4; ++q_) {\n"
            "            uint32_t b_, s_; sm90::split_tf32(v_[q_], b_, s_);\n"
            "            a.dzbuf[zi + q_ * H] = __uint_as_float(b_);\n"
            "            if (s == 0) a.dzbuf[zp + zi + q_ * H] = "
            "__uint_as_float(s_);\n          } }\n")]),
    ("lstm f32 (TF32): the RW small parts of the other unit group", LSTM,
     TFF, [("sm.w[st][wg], sm.ws[wg]);", "sm.w[st][wg], sm.ws[wg ^ 1]);")]),
    # fresh zeroed at a step's first chunk, added once after its last
    ("lstm f32 (TF32): one accumulator chained over all of K", LSTM, TFC, [
        ("      sm90::wgmma_m64n128k8_tf32_zero(d, das, dbb);",
         "      sm90::wgmma_m64n128k8_tf32(d, das, dbb, 1);"),
        ("      tf_chunk(fresh, sm.a[st][0], sm.a[st][1], sm.w[st][wg], "
         "sm.ws[wg]);",
         "      if (c == 0) for (int i_ = 0; i_ < 64; ++i_) fresh[i_] = 0.f;\n"
         "      tf_chunk(fresh, sm.a[st][0], sm.a[st][1], sm.w[st][wg], "
         "sm.ws[wg]);"),
        ("      add_chunk(z, fresh);", "      if (c + 1 == nch) add_chunk(z, "
         "fresh);"),
        ("      tf_chunk(fresh, sm.a[st][0] + a_off,",
         "      if (c == 0) for (int i_ = 0; i_ < 64; ++i_) fresh[i_] = 0.f;\n"
         "      tf_chunk(fresh, sm.a[st][0] + a_off,"),
        ("      add_chunk(dh, fresh);", "      if (c + 1 == nch) add_chunk(dh, "
         "fresh);")]),
    # the consumers meet the cluster before the last pass's cell phase
    # stores its h_t: the producers then load those h rows of the next step
    # before they are published
    ("lstm f32 (TF32): the forward reads h[t-1] before the cluster barrier",
     LSTM, TFF, [
         ("      // ---- the product to shared memory (warps 0, 1",
          "      if (p == P - 1) sm90::cluster_sync();\n"
          "      // ---- the product to shared memory (warps 0, 1"),
         ("    sm90::cluster_sync();  // h_t is stored (and fenced for TMA) by "
          "all\n", "")]),
]


def log(*a):
    print(*a, flush=True)


def mutate(src: str, anchor: str, edits) -> str:
    for text, new in edits:
        at = src.index(anchor)
        i = src.index(text, at)
        src = src[:i] + new + src[i + len(text):]
    return src


def make_copy(root: str, mutation) -> str:
    """A copy of the package under `root`, with `mutation` planted (in
    `csrc/<family>.cu`, or in the file its fifth item names)."""
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if mutation is not None:
        name = mutation[4] if len(mutation) > 4 else mutation[1] + ".cu"
        path = os.path.join(root, PKG, "csrc", name)
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(mutate(src, mutation[2], mutation[3]))
    return root


def families(mutation):
    """The kernel families a copy builds and checks."""
    return (FLASH, PAGED, LSTM) if mutation is None else (mutation[1],)


def child_cmd(root: str, what: str, sources):
    code = (f"import sys; sys.path[:0] = [{root!r}, {REPO!r}]; "
            f"import chip_fault_check as c; c.{what}({tuple(sources)!r})")
    return [sys.executable, "-c", code]


def build(sources) -> None:
    from deeplearning4j_tpu_torch.ops import cuda_build

    cuda_build.build(sources)


def check(sources) -> None:
    """In a copy's process: run the families' cases, print one JSON line."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    if FLASH in sources:
        cases += flash_cases(torch, fa)
    if PAGED in sources:
        cases += paged_cases(torch)
    if LSTM in sources:
        cases += lstm_cases(torch)
    print(json.dumps({"package": fa.__file__, "cases": cases}), flush=True)


def paged_cases(torch):
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    cases = []
    for i, (name, kw) in enumerate(cs.paged_cases(torch)):
        _, units, clean = cs.paged_case_error(torch, pa, kw, seed=100 + i)
        if not clean or units != units:
            units = float("inf")
        cases.append({"case": f"paged {name} {str(kw['dtype'])[6:]}",
                      "units": {"out": units}, "old_units": None})
    return cases


def lstm_cases(torch):
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import lstm as L

    cases = []
    for i, (T, B, H, dt, masked, rev) in enumerate(cs.lstm_cases(torch)):
        units, _ = cs.lstm_case_units(torch, L, T, B, H, dt, masked, rev,
                                      seed=200 + i)
        units = {k: (float("inf") if v != v else v) for k, v in units.items()}
        cases.append({"case": f"lstm T={T} B={B} H={H} {str(dt)[6:]} "
                              f"{'masked' if masked else 'plain'} "
                              f"{'rev' if rev else 'fwd'}",
                      "units": units, "old_units": None})
    for kind in ("fwd", "bwd"):
        units = cs.lstm_cancel_units(torch, L, kind)
        units = {k: (float("inf") if v != v else v) for k, v in units.items()}
        cases.append({"case": f"lstm {kind} f32 cancelling product",
                      "units": units, "old_units": None})
    return cases


def flash_cases(torch, fa):
    import chip_smoke as cs

    cases = []
    for i, (B, T, H, D, causal, dtype) in enumerate(CASES):
        dt = getattr(torch, dtype)
        q, k, v, do = cs.flash_inputs(torch, B, T, H, D, dt, seed=60 + i)
        got = cs.flash_run(fa, q, k, v, do, causal)
        ref = cs.flash_plain_f32(fa, q, k, v, do, causal, got)
        errs = cs.flash_errors(fa, got, ref, dt)
        old = []
        for g, r in zip(got, ref):
            e = (g.float() - r).abs().max().item()
            old.append(e / (OLD_BOUND * r.abs().max().item())
                       if e == e and abs(e) != float("inf")
                       else float("inf"))
        cases.append({"case": f"B={B} T={T} H={H} D={D} {dtype} "
                              f"{'causal' if causal else 'full'}",
                      "units": {n: u for n, _, u in errs},
                      "old_units": max(old)})
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device available", file=sys.stderr)
        return 2
    only = sys.argv[1:]
    runs = [("unchanged", None)] + [
        (m[0], m) for m in MUTATIONS
        if not only or any(word in m[0] for word in only)]
    base = tempfile.mkdtemp(prefix="kernel_fault_")
    try:
        roots = [make_copy(os.path.join(base, str(i)), m)
                 for i, (_, m) in enumerate(runs)]
        builds = [subprocess.Popen(child_cmd(r, "build", families(m)), cwd=r,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r, (_, m) in zip(roots, runs)]
        for (name, _), p in zip(runs, builds):
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"build of '{name}' failed:\n{out}")
        results = []
        for (name, m), root in zip(runs, roots):
            p = subprocess.run(child_cmd(root, "check", families(m)), cwd=root,
                               capture_output=True, text=True, timeout=600)
            if p.returncode != 0:
                log(f"{name}: the check process failed (exit "
                    f"{p.returncode}): {p.stderr.strip()[-400:]}")
                results.append((name, None))
                continue
            res = json.loads(p.stdout.strip().splitlines()[-1])
            if not res["package"].startswith(root):
                raise RuntimeError(f"'{name}' ran {res['package']}")
            results.append((name, res["cases"]))
    finally:
        shutil.rmtree(base, ignore_errors=True)

    summary = []
    for name, cases in results:
        log(f"{name}:")
        if cases is None:  # a crash is caught too, but says nothing of the check
            summary.append({"name": name, "caught": True,
                            "caught_by_old_bound": True, "worst": None})
            continue
        for c in cases:
            log(f"  {c['case']:<40} " + " ".join(
                f"{n} {u:.3g}" for n, u in c["units"].items())
                + ("" if c["old_units"] is None
                   else f" | old bound {c['old_units']:.3g}"))
        worst = max(max(c["units"].values()) for c in cases)
        summary.append({"name": name, "caught": worst > 1.0,
                        "caught_by_old_bound": any(
                            c["old_units"] is not None
                            and c["old_units"] > 1.0 for c in cases),
                        "worst": worst})
    control = summary[0]
    ok = not control["caught"] and all(m["caught"] for m in summary[1:])
    log("unchanged kernels pass" if not control["caught"]
        else "the UNCHANGED kernels fail the check")
    for m in summary[1:]:
        log(f"  {m['name']}: {'caught' if m['caught'] else 'MISSED'} "
            f"(old bound: {'caught' if m['caught_by_old_bound'] else 'missed'})")
    print(json.dumps({"control_ok": not control["caught"],
                      "mutants": summary[1:]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
