#!/usr/bin/env python3
"""Mutation check of the kernels' correctness checks on one NVIDIA card:
does `chip_smoke.py`'s comparison against the plain versions catch a
kernel that is wrong?

    python3 chip_fault_check.py      # about 25 minutes on an H100
    python3 chip_fault_check.py "lstm f32"   # the faults named so only

For the unchanged sources and for each planted fault below, the script
copies `deeplearning4j_tpu_torch/` into a temporary directory, plants the
fault in the copy's `csrc/flash_attention.cu`, `csrc/paged_attention.cu`
or `csrc/lstm.cu`, in `nn/multilayer.py` for the training loop's finite
guard, or in `serving/` for the serving tier (the checkout is never
changed), builds every copy with
nvcc in parallel, and then runs the faulted family's check in one
process per copy (the unchanged copy runs every family a selected fault
belongs to):

- flash: the forward, dQ and dK/dV kernels on the cases below, bf16 (at
  D = 128 the wgmma kernels; at D = 256, 384 and 512 the "wgmma wide"
  forward; the "wgmma wide" backward at D = 256 and the "wgmma cluster"
  backward at D = 384 and 512) and f32 (the
  split-TF32 kernels at D = 128 and 256, and the cluster backward at
  D = 384 and 512), held to the plain versions in f32 with
  `flash_attention.error_in_tolerances` (O, dQ, dK, dV row by row; L
  absolute; 2^-6 bf16, 1e-4 f32), as `chip_smoke.py` does. Beside it,
  each case is also read against the earlier bound (the largest absolute
  error within 2e-2 of the reference's largest magnitude), to show what
  that bound let through. At f32 D = 384 and 512 also, as phase 4 does,
  inputs whose 128-column slices repeat (the clusters' output slices
  must be bit-identical: "slice bits", infinite when not) and inputs
  whose score products cancel within each slice, held to the plain
  versions in f64; at bf16 D = 256, 384 and 512, as phase 4 does, inputs
  whose V column halves are equal (O's halves must be bit-identical:
  "halves bits"), the P-rounding inputs (`chip_smoke.
  flash_rounding_inputs`, the forward alone against the plain forward on
  the bf16 tensors) and the dS-rounding inputs (`chip_smoke.
  flash_ds_rounding_inputs`, the three kernels against the plain versions
  on the bf16 tensors), and at D = 384 and 512 inputs whose q, k and dO
  column halves are equal (`chip_smoke.flash_halves_inputs`: the halves
  of dQ, dK and dV must be bit-identical, "halves bits");
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
  (`chip_smoke.lstm_cancel_units`, against the plain version in f64), and
  the cooperative bf16 forward on inputs whose rows 8-15 of every 16
  repeat rows 0-7 (`chip_smoke.lstm_mirror_units`, B = 64 and 128: the
  repeated rows must be bit-identical, "mirror bits");
- guard: `chip_smoke.py`'s phase 20 (path 4e, the training loop on the
  bf16 LSTM kernels), whose failed check counts as caught;
- server: `chip_smoke.py`'s phase 21 (path 5, the GPT behind
  `ModelServer` on the paged and flash kernels), whose failed check
  counts as caught;
- cnn: `chip_smoke.py`'s phase 22 (the CNN layers on the card against
  the CPU and numpy, path 6's LeNet and its parity), whose failed check
  counts as caught;
- moe: `chip_smoke.py`'s phase 23 (SelfAttention on the flash kernels,
  MoELayer against numpy, path 2m, the MoE engine against `generate`),
  whose failed check counts as caught;
- graph, pretrain: `chip_smoke.py`'s phases 24-26 (path 7's ResNet-50
  graph, the graph on the LSTM kernels against the list container, the
  CPU and numpy, pretraining against the CPU, numpy and the greedy
  reference), whose failed check counts as caught.

The faults (`MUTATIONS`) drop tiles, terms or rows, and break each
mechanism of the Hopper kernels: the forward's diagonal mask on the wrong
tile and a K/V ring stage refilled before its release; the bf16 forward
at D >= 256 ("wgmma wide"): one warpgroup adding the partial scores in
its own order (only the halves bits show it), the second of the two
diagonal key tiles left unmasked, the last 64-column box of K not
loaded, P truncated to bf16 instead of rounded (only the P-rounding
inputs show it), the last K/V tile skipped and a ring stage refilled
before its release; the bf16 backward at D = 256 ("wgmma wide"): each
kernel's ring stage refilled before its release, P^T read before its
barrier, dS (dQ) and dS^T (dK) truncated to bf16 instead of rounded
(only the dS-rounding inputs show it), the first key tile masked instead
of the diagonal ones (dQ), the Q tile after the diagonal masked (dK/dV),
dQ's partials stored without the peer warpgroup's, or read before the
barrier that orders their hand-over,
the last 64-column box of K (dQ) or dO (dK/dV) not loaded, dQ's last
K/V tile skipped, dK/dV's first visible Q tile off by one, and L and
dsum of the neighbouring Q tile; the bf16 backward at D = 384 and 512
("wgmma cluster"): the block of rank 1 adding the partial scores in its
own order (only the halves bits show it), the peer's partials read
before their arrival, the last 64-column box of a block's K half (dQ) or
dO half (dK/dV) not loaded, dS (dQ) and dS^T (dK) truncated to bf16
instead of rounded (only the dS-rounding inputs show it), the first key
tile masked instead of the diagonal ones (dQ), the diagonal Q tiles
masked one tile late (dK/dV), dK/dV's first visible Q tile off by one,
each kernel's ring stage refilled before its release, P^T read before
its barrier, dQ's last K/V tile skipped, and L and dsum of the
neighbouring Q tile; the D = 128
backward's ring stages refilled before their release, P^T read before its
barrier, the diagonal mask on the wrong tile, the first visible Q tile off
by one, L and dsum of the neighbouring Q tile, and a far tile (40)
skipped; the f32 kernels' split TF32 (the small terms dropped, which is
one TF32 pass, and the big part not rounded by cvt.rna, which the tensor
cores then truncate, and the block's split pass over the streamed tiles
writing no small parts), their fresh accumulators overwriting the running
sums, each f32 kernel's diagonal tile skipped and its final K/V (or Q)
tile dropped; the f32 cluster backward's exchange (a member that leaves
out one peer's partial scores, members that add the partials in
different orders, which only the slice bits show) and a score product
chained on one tensor-core accumulator over all of D (which only the
cancelling cases show); the paged walk's
split merge, key slices and int8 rounding point; the bf16 LSTM
backward's cluster barrier between its two phases, and its row tile
reading dz from the next tile's rows; the bf16 LSTM forward's h rows
loaded before the cluster barrier and its xw tile of the wrong step; the
f32 LSTM kernels' split TF32 (the small terms dropped, h_t's or dz[t]'s
small plane left stale, the other unit group's RW small parts, one
accumulator chained over all of K, which only the cancelling cases
show) and the forward's h rows loaded before the cluster barrier; the
cooperative bf16 forward's step barrier (the producers' wait on the step
counter skipped, or waiting for the previous step's count), an h chunk
read before its TMA arrival, one warpgroup adding the split-K partials
in its own order (which only the mirror bits show), the split-K
hand-over reading the warpgroup's own partials, the xw tile of step t+2
used at step t and the stash stored at the next step's position; the
training loop's finite guard: a non-finite step committed, every finite
step after the first skip skipped, the iteration held on a skip, and the
gradient norm without the first layer's gradients; the serving tier
(`serving/model_server.py`, `serving/decode_engine.py`): predict's
non-finite screen skipped, the breaker opening at the first failure
whatever its threshold, the engine swapping weights while slots are
occupied, and a reload that skips the canary; the CNN layers
(`nn/conf/layers.py`, `nn/conf/preprocessors.py`): SAME padding applied
symmetrically (the smaller pad on both sides, as a symmetric `padding=`
would), MAX pooling padded with 0 instead of -inf, the CnnToFeedForward
flatten in NCHW order instead of NHWC, and BatchNormalization's running
variance moved by the unbiased batch variance; the Switch MoE
(`parallel/experts.py`, `nn/multilayer.py`): capacity overflow not
dropped (every expert's capacity N), and the load-balancing term left
out of the training loss; the graph: ElementWiseVertex's ADD computing
the average, a topological sort that counts only each node's last input
(a vertex then runs before one of its inputs), and BatchNormalization's
running stats dropped by the graph's forward (never committed); layerwise
pretraining: the RBM free energy's visible term with the wrong sign, the
VAE's KL term left out of the negative ELBO, and `pretrain` training
every pretraining layer up to the current one again (an upstream layer
that should be frozen updated). A
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
# the training loop's finite guard (`nn/multilayer.py`), checked by
# `chip_smoke.py`'s phase 20 (path 4e) on the LSTM kernels
GUARD = "guard"
# the serving tier's defenses (`serving/model_server.py`,
# `serving/decode_engine.py`), checked by `chip_smoke.py`'s phase 21
# (path 5) on the paged and flash kernels
SERVER = "server"
# the graph (`nn/conf/computation_graph_configuration.py`,
# `nn/graph/computation_graph.py`) and layerwise pretraining (the RBM and
# VAE losses, `MultiLayerNetwork.pretrain`), both checked by
# `chip_smoke.py`'s phases 24-26 (ResNet-50, the graph on the LSTM
# kernels, pretraining on the card)
GRAPH, PRETRAIN = "graph", "pretrain"
# the CNN layers (`nn/conf/layers.py`, `nn/conf/preprocessors.py`),
# checked by `chip_smoke.py`'s phase 22 (no CUDA source of the port), and
# the Switch MoE (`parallel/experts.py`, the aux loss in
# `nn/multilayer.py`), checked by its phase 23 on the flash and paged
# kernels
CNN, MOE = "cnn", "moe"
# (B, T, H, D, causal, dtype): bf16, the training path's kernels at D = 128,
# the "wgmma wide" kernels at D = 256 and the "wgmma cluster" backward at
# D = 384 and 512 (T = 192: the first diagonal tiles; T = 1024 full: every
# tile unmasked); f32, the split-TF32 kernels (path 2f's at D = 128; the
# cluster backward at D = 384 and 512)
CASES = [(2, 512, 2, 128, False, "bfloat16"), (2, 512, 2, 128, True,
                                               "bfloat16"),
         (1, 4096, 2, 128, True, "bfloat16"),
         (2, 512, 2, 256, True, "bfloat16"),
         (1, 4096, 2, 256, False, "bfloat16"),
         (1, 192, 2, 384, True, "bfloat16"),
         (1, 2048, 2, 384, True, "bfloat16"),
         (1, 192, 2, 512, True, "bfloat16"),
         (1, 1024, 2, 512, False, "bfloat16"),
         (2, 512, 2, 128, False, "float32"), (2, 512, 2, 128, True,
                                              "float32"),
         (1, 4096, 2, 128, True, "float32"),
         (1, 4096, 2, 128, False, "float32"),
         (2, 512, 2, 256, True, "float32"),
         (1, 512, 2, 384, True, "float32"), (1, 512, 2, 384, False,
                                             "float32"),
         (1, 512, 2, 512, True, "float32"), (1, 1024, 2, 512, False,
                                             "float32")]
OLD_BOUND = 2e-2
# (name, source, anchor, edits): each edit (text, replacement) replaces the
# first `text` after `anchor`, in order
FWD = "void flash_fwd_consumer(WgFwdSmem& sm,"
FWDP = "flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,"
WIDE = "    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tq,"
WEXCH = "__device__ __forceinline__ void wide_exchange("
WDIAG = "__device__ __forceinline__ bool wide_diag("
WPACK = "__device__ __forceinline__ void wide_pack("
CLDQW = "flash_bwd_dq_cluster_kernel(const __grid_constant__ CUtensorMap tq,"
CLDKVW = "flash_bwd_dkv_cluster_kernel(const __grid_constant__ CUtensorMap tq,"
CLDQC = "__device__ __forceinline__ void cl_dq_consumer("
CLDVC = "__device__ __forceinline__ void cl_dv_consumer("
CLDKC = "__device__ __forceinline__ void cl_dk_consumer("
CLDP = "__device__ __forceinline__ float cl_dp("
CLMEET = "__device__ __forceinline__ void cl_meet("
DQW = "flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,"
DKVW = "flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,"
DQC = "__device__ __forceinline__ void dq_consumer("
DVC = "__device__ __forceinline__ void dv_consumer("
DKC = "__device__ __forceinline__ void dk_consumer("
WDQW = "flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,"
WDKVW = "flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tq,"
WDQC = "__device__ __forceinline__ void wide_dq_consumer("
WDVC = "__device__ __forceinline__ void wide_dv_consumer("
WDKC = "__device__ __forceinline__ void wide_dk_consumer("
WMEET = "__device__ __forceinline__ void dq_meet("
MMA3 = "__device__ __forceinline__ void mma3("
SPLIT = "__device__ __forceinline__ void split_tf32("
SPLIT_TILE = "__device__ __forceinline__ void split_tile("
ADD_ACC = "__device__ __forceinline__ void add_acc("
FWDT = "flash_fwd_tf32_kernel(const Args a) {"
DQT = "flash_bwd_dq_tf32_kernel(const Args a) {"
DKVT = "flash_bwd_dkv_tf32_kernel(const Args a) {"
NK_TF = "const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB;"
WABT = "__device__ __forceinline__ void warp_abt_tf32("
SUMR = "__device__ __forceinline__ void sum_ranks("
DQTC = "flash_bwd_dq_tf32_cluster_kernel(const Args a) {"
DKVTC = "flash_bwd_dkv_tf32_cluster_kernel(const Args a) {"
SCAL = "paged_attention_kernel(const Call c) {"
PV = "// acc (TR, hd) = acc * corr + P . V"
STAGE = "__device__ __forceinline__ void stage_slice("
KVV = "__device__ __forceinline__ float kv_value("
MERGE = "paged_merge_kernel(const Call c) {"
CELL = "__device__ void coop_consumer(CoopSmem& sm,"
CONS = "__device__ void cluster_consumer(ClusterSmem& sm,"
PROD = "__device__ void cluster_producer(ClusterSmem& sm,"
COOPP = "__device__ void coop_producer(CoopSmem& sm,"
COOPX = "__device__ __forceinline__ void coop_load_x(CoopSmem& sm,"
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
    # the bf16 forward at D >= 256 ("wgmma wide"); an order fault moves P
    # by an ulp in one warpgroup, which only the equal-V-halves cases show
    ("wide forward: warpgroup 1 adds the partial scores in its own order",
     FLASH, WEXCH, [("const float s0 = wg == 0 ? x[i + e] : y[e];",
                     "const float s0 = x[i + e];"),
                    ("const float s1 = wg == 0 ? y[e] : x[i + e];",
                     "const float s1 = y[e];")]),
    ("wide forward leaves the second diagonal key tile unmasked", FLASH,
     WDIAG, [("return causal && j >= nk - kWideRows / kb;",
              "return causal && j == nk - kWideRows / kb;")]),
    ("wide forward loads no last 64-column box of K", FLASH, WIDE, [
        ("tma_rows<Sm::BOXES>(sm.k[s][0],",
         "tma_rows<Sm::BOXES - 1>(sm.k[s][0],")]),
    ("wide forward truncates P to bf16 instead of rounding it", FLASH,
     WPACK, [("p[i / 2] = pack_bf16(x[i], x[i + 1]);",
              "p[i / 2] = (__float_as_uint(x[i]) >> 16) |\n"
              "      (__float_as_uint(x[i + 1]) & 0xffff0000u);")]),
    ("wide forward skips its last K/V tile", FLASH, WIDE, [
        ("const int nk = a.causal ? (q0 + kWideRows) / KB : a.Tk / KB;",
         "const int nk = a.causal ? (q0 + kWideRows) / KB - 1 "
         ": a.Tk / KB - 1;")]),
    ("wide forward refills a K/V stage before its release", FLASH, WIDE, [
        ("sm90::mbar_wait(&sm.k_empty[s], par);", ""),
        ("sm90::mbar_wait(&sm.v_empty[s], par);", "")]),
    # the bf16 backward at D = 256 ("wgmma wide"); a truncated dS shows
    # only on the dS-rounding inputs
    ("wide dQ refills a K/V stage before its release", FLASH, WDQW, [
        ("sm90::mbar_wait(&sm.empty[s], ((j / NS) & 1) ^ 1);", "")]),
    ("wide dK/dV refills a Q/dO stage before its release", FLASH, WDKVW, [
        ("sm90::mbar_wait(&sm.empty[s], ((n / NS) & 1) ^ 1);", "")]),
    ("wide dK reads P^T before its barrier", FLASH, WDKC, [
        ("sm90::mbar_wait(&sm.p_full[pb], (n >> 1) & 1);", "")]),
    ("wide dQ truncates dS to bf16 instead of rounding it", FLASH, WDQC, [
        ("wide_pack(p, s);",
         "for (int i_ = 0; i_ < 16; i_ += 2)\n"
         "        p[i_ / 2] = (__float_as_uint(s[i_]) >> 16) |\n"
         "                    (__float_as_uint(s[i_ + 1]) & 0xffff0000u);")]),
    ("wide dK truncates dS^T to bf16 instead of rounding it", FLASH, WDKC, [
        ("pack16(p, dp);",
         "for (int i_ = 0; i_ < 32; i_ += 2)\n"
         "      p[i_ / 2] = (__float_as_uint(dp[i_]) >> 16) |\n"
         "                  (__float_as_uint(dp[i_ + 1]) & 0xffff0000u);")]),
    ("wide dQ masks the first key tile, not the diagonal ones", FLASH, WDQC,
     [("const bool diag = wide_diag(a.causal, j, nk, KB);",
       "const bool diag = a.causal && j == 0;")]),
    ("wide dQ: a warpgroup stores its partial without the peer's", FLASH,
     WMEET, [("out[4 * i] = dq[KEEP + 4 * i] + y.x;",
              "out[4 * i] = dq[KEEP + 4 * i];")]),
    ("wide dQ: the partials meet before the barrier", FLASH, WMEET, [
        ("  sm90::named_bar_sync(1, 256);\n", "")]),
    ("wide dK/dV masks the Q tile after the diagonal", FLASH, WDVC, [
        ("const bool diag = a.causal && qi == kj;",
         "const bool diag = a.causal && qi == kj + 1;")]),
    ("wide dQ loads no last 64-column box of K", FLASH, WDQW, [
        ("tma_rows<kWbBoxes>(sm.k[s][0], &tk,",
         "tma_rows<kWbBoxes - 1>(sm.k[s][0], &tk,")]),
    ("wide dK/dV loads no last 64-column box of dO", FLASH, WDKVW, [
        ("tma_rows<kWbBoxes>(sm.dO[s][0], &tdo,",
         "tma_rows<kWbBoxes - 1>(sm.dO[s][0], &tdo,")]),
    ("wide dQ skips its last K/V tile", FLASH, WDQW, [
        ("const int nk = a.causal ? (q0 + kWbRows) / KB : a.Tk / KB;",
         "const int nk = a.causal ? (q0 + kWbRows) / KB - 1 : a.Tk / KB - 1;")]),
    ("wide dK/dV starts one Q tile after the diagonal", FLASH, WDKVW, [
        ("const int q_first = a.causal ? kj : 0;",
         "const int q_first = a.causal ? kj + 1 : 0;")]),
    # tiles 0 <-> 1, 2 <-> 3, ...: always inside the tensor
    ("wide dK/dV takes L and dsum of the neighbouring Q tile", FLASH, WDKVW, [
        ("sm90::bulk_load(sm.lse[s], lse + r0,",
         "sm90::bulk_load(sm.lse[s], lse + (r0 ^ kWbRows),"),
        ("sm90::bulk_load(sm.dsum[s], dsum + r0,",
         "sm90::bulk_load(sm.dsum[s], dsum + (r0 ^ kWbRows),")]),
    # the bf16 backward at D = 384 and 512 ("wgmma cluster"); an order fault
    # shows only on the equal-halves inputs, a truncated dS only on the
    # dS-rounding inputs
    ("cluster: the rank-1 block adds the partials in its own order", FLASH,
     CLDP, [("const float d0 = rank == 0 ? mine : peer;",
             "const float d0 = mine;"),
            ("const float d1 = rank == 0 ? peer : mine;",
             "const float d1 = peer;")]),
    ("cluster: the peer's partials read before their arrival", FLASH,
     CLMEET, [("  sm90::mbar_wait_cluster(bar, parity);\n", "")]),
    ("cluster dQ loads no last 64-column box of its K half", FLASH, CLDQW, [
        ("tma_rows<BOXES>(sm.k[s][0], &tk,",
         "tma_rows<BOXES - 1>(sm.k[s][0], &tk,")]),
    ("cluster dK/dV loads no last 64-column box of its dO half", FLASH,
     CLDKVW, [("tma_rows<BOXES>(sm.dO[s][0], &tdo,",
               "tma_rows<BOXES - 1>(sm.dO[s][0], &tdo,")]),
    ("cluster dQ truncates dS to bf16 instead of rounding it", FLASH, CLDQC, [
        ("    wide_pack(p, s);\n",
         "    for (int i_ = 0; i_ < 16; i_ += 2)\n"
         "      p[i_ / 2] = (__float_as_uint(s[i_]) >> 16) |\n"
         "                  (__float_as_uint(s[i_ + 1]) & 0xffff0000u);\n")]),
    ("cluster dK truncates dS^T to bf16 instead of rounding it", FLASH,
     CLDKC, [("    wide_pack(p, d);\n",
              "    for (int i_ = 0; i_ < 16; i_ += 2)\n"
              "      p[i_ / 2] = (__float_as_uint(d[i_]) >> 16) |\n"
              "                  (__float_as_uint(d[i_ + 1]) & 0xffff0000u);\n")]),
    ("cluster dQ masks the first key tile, not the diagonal ones", FLASH,
     CLDQC, [("const bool diag = wide_diag(a.causal, j, nk, kClTile);",
              "const bool diag = a.causal && j == 0;")]),
    ("cluster dK/dV masks the diagonal Q tiles one tile late", FLASH, CLDVC, [
        ("const bool diag = a.causal && qi < q_first + kWbRows / kClTile;",
         "const bool diag = a.causal && qi > q_first &&\n"
         "                      qi <= q_first + kWbRows / kClTile;")]),
    ("cluster dK/dV starts one Q tile after the diagonal", FLASH, CLDKVW, [
        ("const int q_first = a.causal ? k0 / kClTile : 0;",
         "const int q_first = a.causal ? k0 / kClTile + 1 : 0;")]),
    ("cluster dQ refills a K/V stage before its release", FLASH, CLDQW, [
        ("sm90::mbar_wait(&sm.empty[s], ((j / NS) & 1) ^ 1);", "")]),
    ("cluster dK/dV refills a Q/dO stage before its release", FLASH, CLDKVW, [
        ("sm90::mbar_wait(&sm.empty[s], ((n / NS) & 1) ^ 1);", "")]),
    ("cluster dK reads P^T before its barrier", FLASH, CLDKC, [
        ("    sm90::mbar_wait(&sm.p_full[pb], (n >> 1) & 1);\n", "")]),
    ("cluster dQ skips its last K/V tile", FLASH, CLDQW, [
        ("const int nk = a.causal ? (q0 + kWbRows) / kClTile : a.Tk / kClTile;",
         "const int nk = a.causal ? (q0 + kWbRows) / kClTile - 1\n"
         "                        : a.Tk / kClTile - 1;")]),
    # tiles 0 <-> 1, 2 <-> 3, ...: always inside the tensor
    ("cluster dK/dV takes L and dsum of the neighbouring Q tile", FLASH,
     CLDKVW, [("sm90::bulk_load(sm.lse[s], lse + r0,",
               "sm90::bulk_load(sm.lse[s], lse + (r0 ^ kClTile),"),
              ("sm90::bulk_load(sm.dsum[s], dsum + r0,",
               "sm90::bulk_load(sm.dsum[s], dsum + (r0 ^ kClTile),")]),
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
    # the f32 cluster backward at D = 384 and 512
    ("f32 cluster: a member leaves out one peer's partial scores", FLASH,
     SUMR, [("for (int r = 1; r < C; ++r) {",
             "for (int r = 2; r < C; ++r) {")]),
    # each member starts from its own rank: the same sum, other rounding,
    # so P and dS differ in their last bits between the members
    ("f32 cluster: the members add the partials in different orders", FLASH,
     SUMR, [("float4 x = sm90::ld_cluster_v4(p, 0);",
             "const uint32_t me_ = sm90::cluster_rank();\n"
             "  float4 x = sm90::ld_cluster_v4(p, me_);"),
            ("sm90::ld_cluster_v4(p, r);",
             "sm90::ld_cluster_v4(p, (me_ + r) % C);")]),
    ("f32 (TF32): a score product on one accumulator chained over all of D",
     FLASH, WABT, [("      float t[4] = {0.f, 0.f, 0.f, 0.f};\n"
                    "      mma3(t, a[0], b[0]);\n"
                    "      mma3(t, a[1], b[1]);\n"
                    "      add_acc(acc[j], t);\n",
                    "      mma3(acc[j], a[0], b[0]);\n"
                    "      mma3(acc[j], a[1], b[1]);\n")]),
    ("f32 dQ (TF32 cluster) skips its diagonal K/V tile", FLASH, DQTC, [
        (NK_TF, "const int nk = a.causal ? (q0 + BLK) / KB - 1 : a.Tk / KB;")]),
    ("f32 dQ (TF32 cluster) drops the final K/V tile", FLASH, DQTC, [
        (NK_TF, "const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB - 1;")]),
    ("f32 dK/dV (TF32 cluster) starts one Q tile after the diagonal", FLASH,
     DKVTC, [("const int q_first = a.causal ? k0 / KB : 0;",
              "const int q_first = a.causal ? k0 / KB + 1 : 0;")]),
    ("f32 dK/dV (TF32 cluster) drops the final Q tile", FLASH, DKVTC, [
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
        ("const float ig = sigm_fast(z(0) + pI[e] * cp);",
         "const float ig = sigm_fast(z(0));")]),
    ("lstm: the masked select taken on the wrong side (c)", LSTM, CELL, [
        ("cs = mv[rr] > 0.f ? cn : cp;", "cs = mv[rr] > 0.f ? cp : cn;")]),
    ("lstm: backward c_prev at the first step not taken from c0", LSTM,
     CONS, [("sp.first ? a.c0 + (long long)r * H + u",
             "sp.first ? a.c + (long long)r * H + u")]),
    # the cooperative forward's step barrier: the producers' wait for every
    # block's h_t on the step counter
    ("lstm: forward skips the grid barrier", LSTM, COOPP, [
        ("        sm90::flag_wait(a.sync, gridDim.x * (unsigned)s);\n", "")]),
    ("lstm coop: the step counter waited for at the previous step's count",
     LSTM, COOPP, [("sm90::flag_wait(a.sync, gridDim.x * (unsigned)s);",
                    "sm90::flag_wait(a.sync, gridDim.x * (unsigned)(s - 1));")]),
    # the consumers skip the full barrier of each step's last chunk
    ("lstm coop: an h chunk read before its TMA arrival", LSTM, CELL, [
        ("      sm90::mbar_wait(&sm.full[st], (q / S) & 1);",
         "      if (c + cstep < nch) sm90::mbar_wait(&sm.full[st], "
         "(q / S) & 1);")]),
    # only inputs whose rows repeat show it ("mirror bits")
    ("lstm coop: one warpgroup adds the split-K partials in its own order",
     LSTM, CELL, [
         ("          const float zp = split ? p + peer[2 * q4 + e] : p;",
          "          if (split && wg == 1)\n"
          "            return (p + (e ? xq[q4].y : xq[q4].x)) + "
          "peer[2 * q4 + e];\n"
          "          const float zp = split ? p + peer[2 * q4 + e] : p;")]),
    ("lstm coop: the split-K hand-over reads the warpgroup's own partials",
     LSTM, CELL, [("peer[i] = sm.xchg[1 - wg][i][wt];",
                   "peer[i] = sm.xchg[wg][i][wt];")]),
    ("lstm coop: the xw tile of step t+2 used at step t", LSTM, COOPX, [
        ("  const int t = a.reverse ? a.T - 1 - s : s, b = s & 1;",
         "  const int s2 = s + 2 < a.T ? s + 2 : s;\n"
         "  const int t = a.reverse ? a.T - 1 - s2 : s2, b = s & 1;")]),
    ("lstm coop: the stash stored at the next step's position", LSTM, CELL, [
        ("      const long long row = (long long)t * B + r, o = row * H + u;",
         "      const int tn = a.reverse ? (t > 0 ? t - 1 : t)\n"
         "                               : (t + 1 < a.T ? t + 1 : t);\n"
         "      const long long row = (long long)tn * B + r, o = row * H + u;")]),
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
    # the training loop's finite guard (`nn/multilayer.py`), each caught by
    # phase 20 (path 4e): the poisoned step's state, the guarded/unguarded
    # pairs, the iteration count, the health vector's norm
    ("guard commits a non-finite step", GUARD,
     "    def _fit_batch(self, ds: DataSet) -> None:", [
         ("            if health[2] >= 0.5:\n", "            if True:\n")],
     "nn/multilayer.py"),
    ("guard skips every finite step after the first skip", GUARD,
     "    def _fit_batch(self, ds: DataSet) -> None:", [
         ("            if health[2] >= 0.5:\n",
          "            if health[2] >= 0.5 and not self._sentinel.skips:\n")],
     "nn/multilayer.py"),
    ("guard: the iteration does not advance on a skip", GUARD,
     "    def _fit_batch(self, ds: DataSet) -> None:", [
         ("        self.iteration += 1\n",
          "        self.iteration += 1 if health is None or health[2] >= 0.5 "
          "else 0\n")],
     "nn/multilayer.py"),
    ("guard: the gradient norm leaves out the first layer", GUARD,
     "    def _health(loss, grads) -> torch.Tensor:", [
         ("        for _, g in _tree_items(grads):\n",
          "        for _, g in _tree_items(grads)[1:]:\n")],
     "nn/multilayer.py"),
    # the serving tier's defenses, each caught by phase 21 (path 5): the
    # non-finite live model, the breaker's ladder, the events around the
    # reload under decode, the poisoned candidate
    ("server: _execute skips the non-finite screen", SERVER,
     "    def _execute(self, batch: List[_Request]) -> List[np.ndarray]:", [
         ('            reason = non_finite_array_reason(out, "outputs")\n',
          "            reason = None\n")],
     "serving/model_server.py"),
    ("server: the breaker ignores its threshold", SERVER,
     "    def record_failure(self, probe: bool = False) -> None:", [
         ("self._consecutive_failures >= self.failure_threshold:",
          "self._consecutive_failures >= 1:")],
     "serving/model_server.py"),
    ("server: _maybe_swap swaps while slots are occupied", SERVER,
     "    def _maybe_swap(self) -> None:", [
         ("            if any(r is not None for r in self._slots):\n"
          "                return  # still draining: in-flight finish on old "
          "weights\n", "")],
     "serving/decode_engine.py"),
    ("server: reload skips the canary", SERVER,
     "    def reload(self, source, step: Optional[int] = None,", [
         ("                self._validate_candidate(candidate, canary)\n", "")],
     "serving/model_server.py"),
    # the CNN layers, each caught by phase 22: the conv and pooling
    # cases against numpy, LeNet's output against numpy, BatchNorm's
    # running stats against the biased batch statistics
    ("cnn: SAME padding symmetric", CNN, "class ConvolutionLayer(", [
        ("y = F.conv2d(_nchw(_pad_hw(x, pad)),",
         "y = F.conv2d(_nchw(_pad_hw(x, tuple((a, a) for a, _ in pad))),")],
     "nn/conf/layers.py"),
    ("cnn: MAX pooling padded with 0", CNN, "class SubsamplingLayer(", [
        ('xp = _pad_hw(x, pad, float("-inf"))', "xp = _pad_hw(x, pad)")],
     "nn/conf/layers.py"),
    ("cnn: CnnToFeedForward flattens NCHW", CNN,
     "class CnnToFeedForwardPreProcessor(", [
         ("        return x.reshape(x.shape[0], -1)",
          "        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)")],
     "nn/conf/preprocessors.py"),
    ("cnn: BatchNormalization's running var unbiased", CNN,
     "class BatchNormalization(", [
         ('"var": d * state["var"] + (1 - d) * var}',
          '"var": d * state["var"] + (1 - d) * var\n'
          '                         * (x.numel() // x.shape[-1])\n'
          '                         / (x.numel() // x.shape[-1] - 1)}')],
     "nn/conf/layers.py"),
    # the Switch MoE, each caught by phase 23: MoELayer against numpy
    # with overflow, the load-balancing term of the loss
    ("moe: capacity overflow not dropped", MOE,
     "def moe_apply_reference(", [
         ("    capacity = int(math.ceil(N / E * capacity_factor))",
          "    capacity = N")],
     "parallel/experts.py"),
    ("moe: the aux loss left out of the loss", MOE,
     "    def _loss_pure(self,", [
         ("            loss = loss + term\n", "            pass\n")],
     "nn/multilayer.py"),
    # the graph, each caught by phases 24-26: the numpy forward of
    # resnet_tiny, the topological order check, BatchNormalization's
    # running stats moving on path 7 and the conv-BN graph against the
    # list container
    ("graph: ElementWiseVertex ADD computes AVERAGE", GRAPH,
     "class ElementWiseVertex(", [
         ("            for x in inputs[1:]:\n                out = out + x\n"
          "            return out\n",
          "            for x in inputs[1:]:\n                out = out + x\n"
          "            return out / len(inputs)\n")],
     "nn/conf/computation_graph_configuration.py"),
    ("graph: a vertex runs before one of its inputs", GRAPH,
     "    def _topological_sort(self) -> List[str]:", [
         ("            for i in node.inputs:\n",
          "            for i in node.inputs[-1:]:\n")],
     "nn/conf/computation_graph_configuration.py"),
    ("graph: BatchNormalization's running stats not committed", GRAPH,
     "    def _forward_pure(self, params: Params, inputs", [
         ("                acts[name], new_state[name] = run_layer(",
          "                acts[name], _ = run_layer(")],
     "nn/graph/computation_graph.py"),
    # layerwise pretraining, each caught by phase 26: the RBM's CD loss
    # and gradient and the VAE's ELBO against numpy in f64, the
    # AutoEncoder stack against the greedy reference
    ("pretrain: RBM free energy's visible term with the wrong sign",
     PRETRAIN, "    def free_energy(self, params, v):", [
         ('        return -(v @ params["vb"]) - hidden_term',
          '        return (v @ params["vb"]) - hidden_term')],
     "nn/conf/layers.py"),
    ("pretrain: the VAE's KL term left out", PRETRAIN,
     "    def pretrain_loss(self, params, x, rng=None):", [
         ("        return torch.mean(kl - rec)",
          "        return torch.mean(-rec)")],
     "nn/conf/variational.py"),
    ("pretrain: an upstream frozen layer updated", PRETRAIN,
     "    def pretrain(self, iterator, epochs: int = 1) -> None:", [
         ("            self._pretrain_layer(i, i, layer, iterator, epochs, "
          "layer_input)\n",
          "            for j in range(i + 1):  # every pretraining layer so "
          "far\n"
          "                if hasattr(self.layers[j], \"pretrain_loss\"):\n"
          "                    self._pretrain_layer(\n"
          "                        j, j, self.layers[j], iterator, epochs,\n"
          "                        lambda ds, j=j: layer_input(ds, j))\n")],
     "nn/multilayer.py"),
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
    `csrc/<family>.cu`, or in the file its fifth item names: a CUDA
    source under `csrc/`, or a Python module by its path in the
    package)."""
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if mutation is not None:
        name = mutation[4] if len(mutation) > 4 else mutation[1] + ".cu"
        path = os.path.join(root, PKG, name) if name.endswith(".py") \
            else os.path.join(root, PKG, "csrc", name)
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(mutate(src, mutation[2], mutation[3]))
    return root


def families(mutation, selected):
    """The families a copy checks: a fault's own, or for the unchanged
    copy those of the selected faults."""
    if mutation is not None:
        return (mutation[1],)
    return tuple(sorted({m[1] for m in selected}))


def child_cmd(root: str, what: str, sources):
    code = (f"import sys; sys.path[:0] = [{root!r}, {REPO!r}]; "
            f"import chip_fault_check as c; c.{what}({tuple(sources)!r})")
    return [sys.executable, "-c", code]


def build(sources) -> None:
    """Build the CUDA sources the families need (the guard runs on the
    LSTM kernels, the server on the paged and flash kernels)."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    needs = {GUARD: (LSTM,), SERVER: (PAGED, FLASH), CNN: (),
             MOE: (PAGED, FLASH), GRAPH: (LSTM,), PRETRAIN: (LSTM,)}
    cuda_build.build(tuple(sorted({k for s in sources
                                   for k in needs.get(s, (s,))})))


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
    if GUARD in sources:
        cases += guard_cases(torch)
    if SERVER in sources:
        cases += server_cases(torch)
    if CNN in sources:
        cases += phase_cases(torch, "22", "the CNN layers and path 6",
                             lambda cs, M, card: (
                                 cs.phase_cnn_layers(torch, M),
                                 cs.phase_lenet(torch, M, card)))
    if MOE in sources:
        import deeplearning4j_tpu_torch.ops.paged_attention as pa

        cases += phase_cases(torch, "23", "SelfAttention, MoE, path 2m",
                             lambda cs, M, card: cs.phase_attention_moe(
                                 torch, M, pa, card))
    if {GRAPH, PRETRAIN} & set(sources):
        cases += phase_cases(
            torch, "24-26", "ResNet-50, the graph, pretraining",
            lambda cs, M, card: (cs.phase_resnet(torch, M, card),
                                 cs.phase_graph_lstm(torch, M, card),
                                 cs.phase_pretrain(torch, M, card)))
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


def guard_cases(torch):
    """`chip_smoke.py`'s phase 20 (path 4e) on the copy: passes, or its
    failed check counts as infinite."""
    import chip_smoke as cs

    try:
        cs.phase_lstm_4e(torch, cs.port_modules(), cs.nvidia_smi_line(),
                         float("nan"))
        units = 0.0
    except AssertionError as e:  # the check's verdict on this copy
        log(f"phase 20 failed: {str(e)[:300]}")
        units = float("inf")
    return [{"case": "path 4e (chip_smoke phase 20)",
             "units": {"phase 20": units}, "old_units": None}]


def server_cases(torch):
    """`chip_smoke.py`'s phase 21 (path 5, the GPT behind ModelServer) on
    the copy: passes, or its failed check counts as infinite."""
    import chip_smoke as cs

    try:
        cs.phase_server(torch, cs.port_modules(), cs.nvidia_smi_line())
        units = 0.0
    except AssertionError as e:  # the check's verdict on this copy
        log(f"phase 21 failed: {str(e)[:300]}")
        units = float("inf")
    return [{"case": "path 5 (chip_smoke phase 21)",
             "units": {"phase 21": units}, "old_units": None}]


def phase_cases(torch, phase: str, what: str, run):
    """A phase of `chip_smoke.py` on the copy: passes, or its failed
    check counts as infinite."""
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    try:
        run(cs, cs.port_modules(), cs.nvidia_smi_line())
        units = 0.0
    except AssertionError as e:  # the check's verdict on this copy
        log(f"phase {phase} failed: {str(e)[:300]}")
        units = float("inf")
    return [{"case": f"{what} (chip_smoke phase {phase})",
             "units": {f"phase {phase}": units}, "old_units": None}]


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
    for B in (64, 128):
        for masked in (False, True):
            units = cs.lstm_mirror_units(torch, L, 50, B, 1024, masked,
                                         seed=43)
            units = {k: (float("inf") if v != v else v)
                     for k, v in units.items()}
            cases.append({"case": f"lstm coop T=50 B={B} H=1024 "
                                  f"{'masked' if masked else 'plain'}, "
                                  "repeated rows",
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
    f32 = torch.float32
    for i, D in enumerate((384, 512)):
        # the clusters' output slices must agree bit for bit
        q, k, v, do = cs.flash_inputs_sliced(torch, 1, 512, 2, D,
                                             seed=90 + i)
        got = cs.flash_run(fa, q, k, v, do, True)
        ref = cs.flash_plain_f32(fa, q, k, v, do, True, got)
        units = {n: u for n, _, u in cs.flash_errors(fa, got, ref, f32)}
        units["slice bits"] = 0.0 if all(cs.flash_slices_equal(torch, got)) \
            else float("inf")
        cases.append({"case": f"B=1 T=512 H=2 D={D} float32 causal, "
                              "repeated slices",
                      "units": units, "old_units": None})
        # score products that cancel within a slice, against f64
        cases.append({"case": f"B=1 T=512 H=2 D={D} float32 causal, "
                              "cancelling",
                      "units": cs.flash_cancel_units(torch, fa, D, True,
                                                     seed=92 + i),
                      "old_units": None})
    bf = torch.bfloat16
    for i, D in enumerate((256, 384, 512)):
        # the bf16 forward's two warpgroups must hold the same P
        q, k, v, do = cs.flash_inputs(torch, 1, 512, 2, D, bf, seed=94 + i)
        v = v[..., :D // 2].repeat(1, 1, 1, 2)
        got = cs.flash_run(fa, q, k, v, do, True)
        ref = cs.flash_plain_f32(fa, q, k, v, do, True, got)
        units = {n: u for n, _, u in cs.flash_errors(fa, got, ref, bf)}
        units["halves bits"] = 0.0 if cs.flash_halves_equal(torch, got[0]) \
            else float("inf")
        cases.append({"case": f"B=1 T=512 H=2 D={D} bfloat16 causal, "
                              "equal V halves",
                      "units": units, "old_units": None})
        # P rounded to nearest bf16 before P V
        cases.append({"case": f"B=1 T=128 H=2 D={D} bfloat16 full, "
                              "P rounding",
                      "units": cs.flash_rounding_units(torch, fa, D),
                      "old_units": None})
        # dS rounded to nearest bf16 before dS K and dS^T Q
        cases.append({"case": f"B=1 T=128 H=2 D={D} bfloat16 full, "
                              "dS rounding",
                      "units": cs.flash_ds_rounding_units(torch, fa, D),
                      "old_units": None})
        if D > 256:
            # the backward cluster's blocks must form the same P and dS
            q, k, v, do = cs.flash_halves_inputs(torch, 1, 512, 2, D,
                                                 seed=99 + i)
            got = cs.flash_run(fa, q, k, v, do, True)
            ref = cs.flash_plain_f32(fa, q, k, v, do, True, got)
            units = {n: u for n, _, u in cs.flash_errors(fa, got, ref, bf)}
            units["halves bits"] = 0.0 if all(
                cs.flash_halves_equal(torch, g) for g in got[2:]) \
                else float("inf")
            cases.append({"case": f"B=1 T=512 H=2 D={D} bfloat16 causal, "
                                  "equal halves",
                          "units": units, "old_units": None})
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device available", file=sys.stderr)
        return 2
    only = sys.argv[1:]
    selected = [m for m in MUTATIONS
                if not only or any(word in m[0] for word in only)]
    runs = [("unchanged", None)] + [(m[0], m) for m in selected]
    base = tempfile.mkdtemp(prefix="kernel_fault_")
    try:
        roots = [make_copy(os.path.join(base, str(i)), m)
                 for i, (_, m) in enumerate(runs)]
        builds = [subprocess.Popen(child_cmd(r, "build", families(m, selected)), cwd=r,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r, (_, m) in zip(roots, runs)]
        for (name, _), p in zip(runs, builds):
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"build of '{name}' failed:\n{out}")
        results = []
        for (name, m), root in zip(runs, roots):
            p = subprocess.run(child_cmd(root, "check", families(m, selected)), cwd=root,
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
