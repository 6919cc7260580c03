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
  split-TF32 kernels at D = 128, and the cluster forward, dQ and dK/dV
  at D = 256, 384 and 512), held to the plain versions in f32 with
  `flash_attention.error_in_tolerances` (O, dQ, dK, dV row by row; L
  absolute; 2^-6 bf16, 1e-4 f32), as `chip_smoke.py` does. Beside it,
  each case is also read against the earlier bound (the largest absolute
  error within 2e-2 of the reference's largest magnitude), to show what
  that bound let through. At f32 D = 256, 384 and 512 also, as phase 4
  does, inputs whose 128-column slices of q, k and dO repeat (the
  backward clusters' output slices must be bit-identical: "slice bits",
  infinite when not), inputs whose v slices repeat (O's slices must be
  bit-identical: "slice bits") and inputs whose score products cancel
  within each slice, held to the plain versions in f64; at bf16 D = 256,
  384 and 512, as phase 4 does, inputs
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
  256, pages of 1 to 512, f32 q on a chunk with sharp scores), read in
  units of the tolerance atol + rtol * |ref|; a non-finite output or a
  written inactive lane counts as infinite;
- lstm: every case of `chip_smoke.lstm_cases` (forward and backward
  kernels, f32 and bf16, masked and not, forward and reverse, both bf16
  forward routes, the ragged H=196, odd 195 and 385, B=37 and 300,
  H=384, 2048 and the main paths' widths), each output held row by row
  to the plain versions (`lstm.error_in_tolerances`), as phase 11 does,
  and the f32 kernels on one step whose product cancels
  (`chip_smoke.lstm_cancel_units`, against the plain version in f64), and
  the cooperative bf16 forward and backward on inputs whose rows 8-15 of
  every 16 repeat rows 0-7 (`chip_smoke.lstm_mirror_units`, B = 64 and
  128: the repeated rows must be bit-identical, "mirror bits");
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
  reference), whose failed check counts as caught;
- disagg, qos: `chip_smoke.py`'s phases 27 and 28-29, whose failed
  check counts as caught;
- pool, stream: `chip_smoke.py`'s phases 30 and 31 (path 9, the replica
  pool; the streams and the exactly-once door on its pool), one run for
  both families, whose failed check counts as caught;
- multiprocess, etl: `chip_smoke.py`'s phases 42 and 43 (path 15, two
  processes training one GPT on the card, the sharded checkpoint, the
  export, the collectives across processes; path 16, a Keras import,
  CSV sequences, the broker, the streaming trainer, storage and the serve
  route), whose failed check counts as caught. The worker processes of a
  copy run that copy's package;
- wire: `chip_smoke.py`'s phases 32 and 33 (path 10, three replica
  processes behind a gateway; the wire's streams, claims, door and
  journal), whose failed check counts as caught. The replica processes
  of a copy run that copy's modules;
- nlp: `chip_smoke.py`'s phases 34 and 35 (path 11, Word2Vec at
  bench_word2vec_50k's shape with its checks; the NLP steps against the
  CPU and numpy, host-drawn fits against the CPU), whose failed check
  counts as caught;
- embed: `chip_smoke.py`'s phases 36 and 37 (path 12: DeepWalk, k-means
  and t-SNE on the card, the training UI; the Lloyd and t-SNE steps
  against the CPU and numpy, the TF32 guard, a hierarchical-softmax
  DeepWalk fit against the CPU, the weighted walks), whose failed check
  counts as caught;
- parallel: `chip_smoke.py`'s phases 38 and 39 (path 13: the wrapper and
  the device prefetcher on the GPT, the prefetcher at path 4e's shape
  behind a lagging copy stream, the averaging master against the same
  shards run one after another with its crash, NaN and straggler drills,
  the parameter server over TCP, FaultTolerantTrainer, the CLI; the
  wrapper over an 8-slot mesh of the card against the CPU), whose failed
  check counts as caught. The worker processes and the CLI of a copy
  run that copy's modules;
- spmd: `chip_smoke.py`'s phases 40 and 41 (path 14: tensor-parallel
  serving, the pipeline, ring and Ulysses attention, the expert-parallel
  MoE and the global view on slots of the card; the collectives and the
  bodies card against CPU, the pipeline with dropout against one
  device), whose failed check counts as caught.

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
tile dropped; the f32 clusters' exchange (a member that leaves out one
peer's partial scores, members that add the partials in different
orders, which only the slice bits show and which at D = 256, two
partials, gives the same sum) and a score product chained on one
tensor-core accumulator over all of D (which only the cancelling cases
show), in the forward and the backward, whose dQ and dK/dV clusters
also skip their diagonal tile and drop their final one; the f32 cluster
forward's diagonal K/V tile skipped, its final K/V tile dropped, each
member's softmax taken over its own partial scores (no exchange), and
one partial buffer instead of two (a race that opens only if a member
falls a whole step behind its peers); the paged walk's
split merge, key slices and int8 rounding point; the f32 chunk kernel's
split TF32 (the small parts dropped from the score product or from P.V,
which only the sharp chunk case shows), its score tile's keys in the
wrong order, int8 slices dequantized with the other stage's scales and
the last slice of a block's walk dropped; the bf16 LSTM
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
cooperative bf16 backward's step counter (not waited for, or waited for
at the previous step's count: dz[t] read before it is stored), a dz
stage read before its TMA arrival, a ring stage refilled before its
release, the block's RW slice one unit off, the split-K hand-over
reading the warpgroup's own partials and the next step's stash loaded
from the same step; the
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
that should be frozen updated); the replica pool
(`serving/replica_pool.py`): a failover that returns the failed
replica's partial tokens, a migrated slot's head spliced twice, a
rolling reload that skips the rollback after replica k's failed probe,
and a scale-down that removes its victim undrained; the streams and the
door (`serving/streaming.py`, `serving/exactly_once.py`): a
`TokenStream` that accepts a duplicate cursor and a `DedupCache` that
re-executes a completed id; the wire and the processes (`gateway.py`,
`serving/remote_replica.py`): a codec that sends every array as f32,
the remote `ServerClosedError` mapped to the terminal `ServerClosedError`
instead of a failover, a supervisor that never respawns, a gateway door
that re-executes a retried `fit`, and a stream pump that resumes one
token past the client's cursor; the NLP package (`nlp/kernels.py`,
`nlp/sequence_vectors.py`): the row clip dropped from `_scatter_clipped`
(both regimes), the negative-sampling cdf rounded to f32 (the tail of a
large table collapses), negatives equal to their context left unmasked,
the per-pair learning-rate decay lost (one rate a chunk), `glove_step`
reading the AdaGrad histories before the batch's add, and the pair
batcher sending its page-locked staging arrays without a copy; graph
embeddings, clustering and the UI (`clustering/tsne.py`,
`clustering/kmeans.py`, `graph/walks.py`, `ui/stats_listener.py`): the
t-SNE Gram product left to the caller's TF32 setting, the diagonal mask
dropped from the affinities, k-means' empty-cluster rule lost (an empty
centroid goes to 0), `labels_` taken from the centroids before the last
update, weighted walks that ignore the weights, and a `StatsListener`
that reads the device memory of the wrong device or reports a stale
host copy of the parameters; the data-parallel tier
(`parallel/device_prefetch.py`, `parallel/training_master.py`,
`parallel/wrapper.py`, `parallel/parameter_server.py`): a pinned staging
buffer refilled before its copy's event has completed, the master
averaging unweighted although `example_weighted` is set, a non-finite
worker result averaged in, the wrapper skipping the data-axis trim, the
tBPTT carries not restored after a batch's windows, and the parameter
server applying a duplicate idempotent (`V`) push. The SPMD half: `psum`
dropping a slot's partial, `ppermute` rotating the wrong way,
`shard_pool` splitting the page axis, the `[Q_t | K_t | V_t]`
permutation skipped, `bo` added before the all-reduce, the pipeline
skipping its last tick, `all_to_all` joining on its split axis, dropout
keyed by the local row, and the pipeline's trunk gradients scaled by
1/M. The multi-process half: one rank keeping its own gradient instead
of the sum, the psum across processes adding the slots out of order, and
the sharded restore skipping its manifest. Data and interop: the Keras
LSTM's gates copied in the wrong order, the sequence iterator dropping
its masks, and the stream's consumer skipping a record. A fault that makes the kernel trap (an mbarrier wait that times out) fails
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
# the cluster tier's in-process half: KV handoff and disaggregation
# (`serving/kv_transfer.py`, the engine's handoff), checked by
# `chip_smoke.py`'s phase 27 (path 8), and the QoS lanes with the early
# stopping saver, checked by its phases 28-29
DISAGG, QOS = "disagg", "qos"
# the replica pool tier (`serving/replica_pool.py`), checked by
# `chip_smoke.py`'s phase 30 (path 9), and the streams and the dedup door
# (`serving/streaming.py`, `serving/exactly_once.py`), checked by its
# phase 31 on path 9's pool; one run of both phases checks either family
POOL, STREAM = "pool", "stream"
# the wire and replicas as processes (`gateway.py`,
# `serving/remote_replica.py`), checked by `chip_smoke.py`'s phases 32-33
# (path 10: three replica processes on the card behind a gateway; the
# wire's streams, claims, door and journal)
WIRE = "wire"
# the NLP package (`nlp/kernels.py`, `nlp/sequence_vectors.py`), checked
# by `chip_smoke.py`'s phases 34-35 (path 11 and its checks; the NLP
# steps against the CPU and numpy)
NLP = "nlp"
# graph embeddings, clustering and the training UI (`graph/walks.py`,
# `clustering/kmeans.py`, `clustering/tsne.py`, `ui/stats_listener.py`),
# checked by `chip_smoke.py`'s phases 36-37 (path 12 and its parity phase)
EMBED = "embed"
# the data-parallel tier (`parallel/device_prefetch.py`,
# `parallel/training_master.py`, `parallel/wrapper.py`,
# `parallel/parameter_server.py`), checked by `chip_smoke.py`'s phases
# 38-39 (path 13 on the flash and LSTM kernels, the wrapper over an
# 8-slot mesh of the card)
PARALLEL = "parallel"
# the in-process SPMD half (`parallel/spmd.py`, `serving/tp_engine.py`,
# `models/transformer.py`'s shard hooks, `parallel/pipeline.py`,
# `parallel/pipeline_wrapper.py`), checked by `chip_smoke.py`'s phases
# 40-41 (path 14 on the paged and flash kernels, the collectives and the
# bodies card vs CPU)
SPMD = "spmd"
# the multi-process half (`parallel/multiprocess.py`, `parallel/spmd.py`
# across processes, `util/sharded_checkpoint.py`), checked by
# `chip_smoke.py`'s phase 42 (path 15: two processes on the card over
# gloo, the collectives across processes), and data and interop
# (`modelimport/keras.py`, `datavec/iterators.py`,
# `streaming/pipeline.py`), checked by its phase 43 (path 16)
MULTIPROCESS, ETL = "multiprocess", "etl"
# (B, T, H, D, causal, dtype): bf16, the training path's kernels at D = 128,
# the "wgmma wide" kernels at D = 256 and the "wgmma cluster" backward at
# D = 384 and 512 (T = 192: the first diagonal tiles; T = 1024 full: every
# tile unmasked); f32, the split-TF32 kernels (path 2f's at D = 128; the
# clusters at D = 256, 384 and 512)
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
         (2, 512, 2, 256, True, "float32"), (1, 1024, 2, 256, False,
                                             "float32"),
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
FWDTC = "flash_fwd_tf32_cluster_kernel(const Args a) {"
DKVTC = "flash_bwd_dkv_tf32_cluster_kernel(const Args a) {"
SCAL = "paged_attention_kernel(const Call c) {"
TFK = "paged_attention_tf32_kernel(const Call c) {"
DEQ32 = "__device__ __forceinline__ void dequantize_f32("
PV = "// acc (TR, hd) = acc * corr + P . V"
STAGE = "__device__ __forceinline__ void stage_slice("
KVV = "__device__ __forceinline__ float kv_value("
MERGE = "paged_merge_kernel(const Call c) {"
CELL = "__device__ void coop_consumer(CoopSmem& sm,"
BCONS = "__device__ void bwd_coop_consumer(BwdCoopSmem& sm,"
BPROD = "__device__ void bwd_coop_producer(BwdCoopSmem& sm,"
BKER = "    lstm_bwd_coop_kernel(const __grid_constant__ BwdCoopMaps maps,"
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
         "  mma_tf32(d, a.big, b.small[0], b.small[1]);\n", "")], "sm90.cuh"),
    ("f32 (TF32): the big part not rounded by cvt.rna (truncated)", FLASH,
     SPLIT, [("big = tf32_rna(x);", "big = __float_as_uint(x);")],
     "sm90.cuh"),
    ("f32 (TF32): the block's split pass drops the small parts", FLASH,
     SPLIT_TILE, [("make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),\n"
                   "                       __uint_as_float(s[2]), "
                   "__uint_as_float(s[3])));",
                   "make_float4(0.f, 0.f, 0.f, 0.f));")]),
    ("f32 (TF32): a fresh accumulator overwrites the running sum", FLASH,
     ADD_ACC, [("acc[e] += t[e];", "acc[e] = t[e];")], "sm90.cuh"),
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
    # the f32 cluster forward at D = 256, 384 and 512
    ("f32 forward (TF32 cluster) skips its diagonal K/V tile", FLASH,
     FWDTC, [(NK_TF,
              "const int nk = a.causal ? (q0 + BLK) / KB - 1 : a.Tk / KB;")]),
    ("f32 forward (TF32 cluster) drops the final K/V tile", FLASH, FWDTC, [
        (NK_TF, "const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB - 1;")]),
    ("f32 forward (TF32 cluster): each member's softmax over its own "
     "partial scores", FLASH, FWDTC, [
         ("      sum_partials<C>(sm.partial(kj), s);\n", "")]),
    ("f32 forward (TF32 cluster): one partial buffer instead of two", FLASH,
     FWDTC, [("put_partial(sm.partial(kj), s);",
              "put_partial(sm.partial(0), s);"),
             ("sum_partials<C>(sm.partial(kj), s);",
              "sum_partials<C>(sm.partial(0), s);")]),
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
    # the f32 chunk kernel (split TF32 on mma.sync)
    ("paged tf32: the small TF32 parts dropped from the score product",
     PAGED, TFK, [("          sm90::mma3(tacc, a[x], b);",
                   "          sm90::mma_tf32(tacc, a[x].big, b.big[0], "
                   "b.big[1]);")]),
    ("paged tf32: the small TF32 parts dropped from the P.V product",
     PAGED, TFK, [("          sm90::mma3(tacc[i], pa[kk], b);",
                   "          sm90::mma_tf32(tacc[i], pa[kk].big, b.big[0], "
                   "b.big[1]);")]),
    ("paged tf32: the score tile's keys not permuted (perm8 dropped)",
     PAGED, TFK, [("(k0 + 8 * x + t) * kLdk + 8 * n + perm8(g);",
                   "(k0 + 8 * x + t) * kLdk + 8 * n + g;")]),
    ("paged tf32: an int8 slice dequantized with the other stage's scales",
     PAGED, DEQ32, [("const float* sc = sm.rks[buf] + kk;",
                     "const float* sc = sm.rks[buf ^ 1] + kk;"),
                    ("const float sc = sm.rvs[buf][kk];",
                     "const float sc = sm.rvs[buf ^ 1][kk];")]),
    ("paged tf32: the last slice of a block's walk dropped", PAGED, TFK, [
        ("  for (int j = w.j0; j < w.j1; ++j) {",
         "  for (int j = w.j0; j < w.j1 - (w.j1 - w.j0 > 1); ++j) {")]),
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
    # the cooperative bf16 backward (B <= 128, H <= 1024)
    ("lstm bwd coop: dz[t] read without waiting for the step counter",
     LSTM, BPROD, [("        sm90::flag_wait(a.sync, gridDim.x * "
                    "(unsigned)(s + 1));\n", "")]),
    ("lstm bwd coop: the step counter waited for at the previous step's "
     "count", LSTM, BPROD, [
         ("sm90::flag_wait(a.sync, gridDim.x * (unsigned)(s + 1));",
          "sm90::flag_wait(a.sync, gridDim.x * (unsigned)s);")]),
    ("lstm bwd coop: a dz stage read before its TMA arrival", LSTM, BCONS, [
        ("      sm90::mbar_wait(&sm.full[st], (q / S) & 1);",
         "      if (c + cstep < nst) sm90::mbar_wait(&sm.full[st], "
         "(q / S) & 1);")]),
    ("lstm bwd coop: a ring stage refilled before its release", LSTM,
     BPROD, [("      sm90::mbar_wait_cluster(&sm.empty[st], "
              "((q / S) & 1) ^ 1);\n", "")]),
    ("lstm bwd coop: the RW slice one unit off", LSTM, BKER, [
        ("                        blockIdx.x * kBcUnits);",
         "                        blockIdx.x * kBcUnits + 1);")]),
    ("lstm bwd coop: the split-K hand-over reads the warpgroup's own "
     "partials", LSTM, BCONS, [("peer[i] = sm.xchg[1 - wg][i][wt];",
                                "peer[i] = sm.xchg[wg][i][wt];")]),
    ("lstm bwd coop: the next step's stash loaded from this step", LSTM,
     BCONS, [("if (s + 1 < a.T) load_stash(s + 1);",
              "if (s + 1 < a.T) load_stash(s);")]),
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
    # the KV handoff, each caught by phase 27: the corrupted last page
    # refused (8b), the page ledgers whole (8a-8c), warm resumes equal
    # to the colocated and uninterrupted runs (8a, 8b)
    ("disagg: verify_payload skips the last page's checksum", DISAGG,
     "def verify_payload(", [
         ("            for i in range(shipped):",
          "            for i in range(shipped - 1):")],
     "serving/kv_transfer.py"),
    ("disagg: commit_handoff frees the lease's pages twice", DISAGG,
     "    def commit_handoff(self, handoff_id: str) -> bool:", [
         ("            self._release_lease_locked(lease)\n",
          "            self._free_pages.extend((lease.pages or [])"
          "[lease.n_shared:])\n"
          "            self._release_lease_locked(lease)\n")],
     "serving/decode_engine.py"),
    ("disagg: a warm resume drops the pos register", DISAGG,
     "    def _import_into(self, slot: int, req: _GenRequest) -> None:", [
         ("        self._pos[slot] = pos\n", "")],
     "serving/decode_engine.py"),
    # the QoS lanes and the saver, each caught by phases 28-29: the
    # preempted request equal to its unpreempted run (f32), a migrated
    # request resumed where its receiver's bucket could not pay for it,
    # the best model restored from its zip
    ("qos: a preempted victim's tokens not folded into its prompt", QOS,
     "    def _maybe_preempt_locked(", [
         ("        if emitted > v.resumed_at:\n"
          "            v.prompt = np.concatenate(\n"
          "                [v.prompt, np.asarray(v.tokens[v.resumed_at:], "
          "np.int64)])\n", "")],
     "serving/decode_engine.py"),
    ("qos: resume_submit bills the tenant's token quota", QOS,
     "    def resume_submit(", [
         ("                tstate.submitted += 1\n",
          "                if tstate.rate:\n"
          "                    tstate.refill(now)\n"
          "                    if tstate.tokens < n_tokens:\n"
          "                        raise TenantQuotaExceededError(\n"
          "                            \"quota exhausted on resume\")\n"
          "                    tstate.tokens -= n_tokens\n"
          "                tstate.submitted += 1\n")],
     "serving/decode_engine.py"),
    ("qos: LocalFileModelSaver restores the latest model as the best", QOS,
     "class LocalFileModelSaver(", [
         ("    def get_best_model(self):\n"
          "        return self._load(self.best_path)",
          "    def get_best_model(self):\n"
          "        return self._load(self.latest_path)")],
     "earlystopping/saver.py"),
    # the replica pool, each caught by phase 30: every request of the
    # crash drill (9b) whole, the fingerprints after a rollback at
    # replica 2 (9c), the migrated decode equal to the uninterrupted run
    # and migrations >= 1 (9d)
    ("pool: failover returns the failed replica's partial tokens", POOL,
     "    def generate(self, prompt_ids, n_tokens: int, *,", [
         ("                rem = self._remaining(deadline)\n"
          "                try:\n",
          "                rem = self._remaining(deadline)\n"
          "                partial = []\n"
          "                sink = genkw.get(\"on_token\")\n"
          "\n"
          "                def collect(c, t, e=None):\n"
          "                    partial.append(t)\n"
          "                    if sink is not None:\n"
          "                        sink(c, t, e)\n"
          "\n"
          "                kw = dict(genkw, on_token=collect)\n"
          "                try:\n"),
         ("priority=priority, **genkw),", "priority=priority, **kw),"),
         ("                except SlotMigratedError as e:\n",
          "                except self._RETRYABLE:\n"
          "                    return np.asarray(partial, np.int32)\n"
          "                except SlotMigratedError as e:\n")],
     "serving/replica_pool.py"),
    ("pool: _resume_migrated splices the head twice", POOL,
     "    def _resume_migrated(self, victim: _Replica,", [
         ("        head = np.asarray(redirect.tokens, np.int32)\n",
          "        head = np.asarray(redirect.tokens, np.int32)\n"
          "        head = np.concatenate([head, head])\n")],
     "serving/replica_pool.py"),
    ("pool: rolling reload skips the rollback after replica k's failed "
     "probe", POOL,
     "    def rolling_reload(self, source,", [
         ("                for rep, old_net, was_stale in reversed(done):",
          "                for rep, old_net, was_stale in reversed(done[:0]):")],
     "serving/replica_pool.py"),
    ("pool: scale_down removes the victim undrained", POOL,
     "    def remove_replica(self, replica_id: int, *,", [
         ("        self._drain_replica(rep, drain_timeout, "
          "reason=\"scale-down\")\n"
          "        if rep.server.pending():",
          "        if False:")],
     "serving/replica_pool.py"),
    # the stream and the door, each caught by phase 31: the failed-over
    # stream's frames equal to the unary tokens, the retry answered from
    # the ring
    ("stream: TokenStream accepts a duplicate cursor", STREAM,
     "    def publish(self, cursor: int, token: int,", [
         ("            if cursor <= self._cursor:\n"
          "                self.duplicate_tokens_dropped += 1\n"
          "                return False\n",
          "            if cursor <= self._cursor:\n"
          "                self._ring.append((int(token), logprob))\n"
          "                self._cond.notify_all()\n"
          "                return True\n")],
     "serving/streaming.py"),
    # the wire and the processes, each caught by phases 32-33: the tokens'
    # dtype through the gateway (10a), the closing replica's refusals all
    # failovers (10e), the killed replica respawned (10b), the retried fit
    # answered from the door and the torn stream equal to unary (33)
    ("wire: the codec drops an array's dtype", WIRE,
     "def encode_array(a) -> Dict[str, str]:", [
         ("np.save(buf, _host_array(a), allow_pickle=False)",
          "np.save(buf, _host_array(a).astype(np.float32), "
          "allow_pickle=False)")],
     "gateway.py"),
    ("wire: ServerClosedError maps to a terminal error", WIRE,
     "_WIRE_ERRORS: Dict[str, type] = {", [
         ('"ServerClosedError": ServiceUnavailableError,',
          '"ServerClosedError": ServerClosedError,')],
     "serving/remote_replica.py"),
    ("wire: the supervisor never respawns", WIRE,
     "    def _monitor_loop(self) -> None:", [
         ("                    self._spawn(i)\n"
          "                    self.respawns += 1\n",
          "                    pass\n")],
     "serving/remote_replica.py"),
    ("wire: the door re-executes a retried fit", WIRE,
     "                            verdict, info = door.admit(", [
         ('if verdict == "cached":',
          'if verdict == "cached" and req["method"] != "fit":')],
     "gateway.py"),
    ("wire: the stream pump skips a frame on resume", WIRE,
     "            def _resume_stream(self, req, req_id):", [
         ("return self._pump(stream, cursor, req_id)",
          "return self._pump(stream, cursor + 1, req_id)")],
     "gateway.py"),
    # the NLP package, each caught by phases 34-35: the clip by the
    # clipped rows of `_scatter_clipped` and the skip-gram step against
    # numpy (35); the f32 cdf by the tail of the heavy-head table (34);
    # the unmasked negatives by `_ns_batch` with given negatives (35);
    # the alpha decay by the planted corpus's falling rates (34); the
    # history order by `glove_step` on duplicate rows (35); the staging
    # copy by the fit whose device lags behind the host (34)
    ("nlp: the row clip dropped from _scatter_clipped", NLP,
     "def _scatter_clipped(", [
         ("return table.add_(agg * _clip_scale(agg))",
          "return table.add_(agg)"),
         ("contrib = agg[ranks] * scale[ranks] * first[:, None]",
          "contrib = agg[ranks] * first[:, None]")],
     "nlp/kernels.py"),
    ("nlp: the NS cdf held in f32 (the tail collapses)", NLP,
     "    def _ns_device_state(self):", [
         ("torch.from_numpy(fixed.astype(np.int64))",
          "torch.from_numpy(fixed.astype(np.float32).astype(np.int64))")],
     "nlp/sequence_vectors.py"),
    ("nlp: negatives equal to the context left unmasked", NLP,
     "def _ns_targets(", [
         ("mask = torch.cat([one, (negs != context[:, None]).float()], dim=1)",
          "mask = torch.cat([one, torch.ones_like(negs, dtype=torch.float32)"
          "], dim=1)")],
     "nlp/kernels.py"),
    ("nlp: the per-pair alpha decay lost (one rate a chunk)", NLP,
     "    def _fit_vectorized(self,", [
         ("* (1.0 - (words_seen + pos) / total_words)",
          "* (1.0 - (words_seen + 0 * pos) / total_words)")],
     "nlp/sequence_vectors.py"),
    ("nlp: glove_step reads the histories before the add", NLP,
     "def glove_step(", [
         ("    hW.index_add_(0, rows, gWi ** 2)\n",
          "    sW, sWc, sb, sbc = (hW[rows].clone(), hWc[cols].clone(),\n"
          "                        hb[rows].clone(), hbc[cols].clone())\n"
          "    hW.index_add_(0, rows, gWi ** 2)\n"),
         ("torch.sqrt(hW[rows] + eps)", "torch.sqrt(sW + eps)"),
         ("torch.sqrt(hWc[cols] + eps)", "torch.sqrt(sWc + eps)"),
         ("torch.sqrt(hb[rows] + eps)", "torch.sqrt(sb + eps)"),
         ("torch.sqrt(hbc[cols] + eps)", "torch.sqrt(sbc + eps)")],
     "nlp/kernels.py"),
    ("nlp: the staging buffers sent without a copy", NLP,
     "def _send(a: np.ndarray, device: torch.device) -> torch.Tensor:", [
         ("    buf = torch.empty(a.shape, dtype=_TORCH_DTYPES[a.dtype], "
          "pin_memory=True)\n"
          "    buf.numpy()[...] = a\n"
          "    return buf.to(device, non_blocking=True)",
          "    return torch.from_numpy(a).to(device, non_blocking=True)")],
     "nlp/sequence_vectors.py"),
    # path 12, each caught by phases 36-37: the TF32 Gram by the t-SNE
    # step run with the caller's TF32 on (37); the unmasked diagonal by
    # the t-SNE step against numpy (37); the empty-cluster rule by the
    # Lloyd step's far centroid (37); the stale labels by the labels of
    # path 12's fit and of a one-iteration fit (36, 37); the unweighted
    # walks by the weighted-walk criterion (37); the listener's device
    # and its stale copy by the UI's system and parameter feeds (36)
    ("embed: the t-SNE Gram in TF32", EMBED,
     "def _affinities(", [
         ("    with full_f32():\n        num = torch.mm(Y, Y.T)",
          "    num = torch.mm(Y, Y.T)")],
     "clustering/tsne.py"),
    ("embed: the diagonal mask dropped from num", EMBED,
     "def _affinities(", [
         ("    num.fill_diagonal_(0.0)\n", "")],
     "clustering/tsne.py"),
    ("embed: k-means' empty-cluster rule lost", EMBED,
     "def _lloyd_step(", [
         ("    new_c = torch.where(counts[:, None] > 0,\n"
          "                        sums / torch.clamp(counts[:, None], "
          "min=1.0),\n"
          "                        centroids)",
          "    new_c = sums / torch.clamp(counts[:, None], min=1.0)")],
     "clustering/kmeans.py"),
    ("embed: labels_ from the pre-update centroids", EMBED,
     "    def fit(self, X)", [
         ("        _, assign, cost = _lloyd_step(Xd, c)\n"
          "        self.cost = float(cost)",
          "        self.cost = float(cost)")],
     "clustering/kmeans.py"),
    ("embed: weighted walks ignore the weights", EMBED,
     "class WeightedRandomWalkIterator(", [
         ("p = w / w.sum()", "p = np.full(len(w), 1.0 / len(w))")],
     "graph/walks.py"),
    ("embed: StatsListener reads the memory of the wrong device", EMBED,
     "    def iteration_done(self, model, iteration: int) -> None:", [
         ("_system_stats(self._model_device(model))",
          "_system_stats(torch.device(\"cpu\"))")],
     "ui/stats_listener.py"),
    ("embed: StatsListener reports a stale host copy of the parameters",
     EMBED,
     "    def iteration_done(self, model, iteration: int) -> None:", [
         ("params[name] = _array_stats(arr)",
          "params[name] = _array_stats(self.__dict__.setdefault("
          "f\"_host_{name}\", _host_array(arr)))")],
     "ui/stats_listener.py"),
    # path 13, each caught by phases 38-39: the early refill by 13b's
    # batches staged behind a lagging copy stream; the unweighted average
    # by 13c's tail window (shards of 8192, 8192 and 4096 examples)
    # against the shards run one after another; the non-finite result by
    # 13c's NaN drill; the skipped trim and the unrestored carries by
    # phase 39's wrapper checks; the duplicate push by 13d's retried V
    # push
    ("parallel: a pinned buffer refilled before its copy completes",
     PARALLEL, "    def _take(self, nbytes: int) -> torch.Tensor:", [
         ("        done.synchronize()\n", "")],
     "parallel/device_prefetch.py"),
    ("parallel: the master averages unweighted", PARALLEL,
     "    def _do_iteration(", [
         ("            if self.example_weighted:\n",
          "            if False:\n")],
     "parallel/training_master.py"),
    ("parallel: a non-finite worker result averaged in", PARALLEL,
     "    def _run_shard(", [
         ("            self._check_result_finite(result, wid, task.index)\n",
          "")],
     "parallel/training_master.py"),
    ("parallel: the wrapper skips the data-axis trim", PARALLEL,
     "    def _shard_batch(self, ds):", [
         ("        if usable == B:\n            return ds\n",
          "        return ds\n")],
     "parallel/wrapper.py"),
    ("parallel: tBPTT carries not restored after the windows", PARALLEL,
     "    def _fit_tbptt(self, ds) -> None:", [
         ("            net._tbptt_restore_carries(saved)\n",
          "            pass\n")],
     "parallel/wrapper.py"),
    ("parallel: the server applies a duplicate V push", PARALLEL,
     "    def _serve(self, conn) -> None:", [
         (",\n                                            request_id=rid)",
          ")")],
     "parallel/parameter_server.py"),
    # path 14, each caught by phases 40-41: the dropped partial, the
    # skipped permutation and the bias before the all-reduce by 14a's f32
    # tokens against one device (its biases are drawn, not zero); the
    # wrong-way ring by 14b's losses and the ring against whole-sequence
    # attention; the pool split on the page axis by 14a (the odd page
    # count does not split: the run raises); the missing last tick by 14b
    # (the last microbatch never reaches the output: the run raises); the
    # all-to-all joined on its split axis by Ulysses against whole-sequence
    # attention; dropout keyed by the local row by phase 41's pipeline
    # with dropout against one device; the trunk's gradients scaled by
    # 1/M by 14b's SGD step against net.fit (Adam's steps hide a scale)
    ("spmd: psum drops the last slot's partial", SPMD,
     "def _psum(x: torch.Tensor, axis_name):", [
         ("    for t in xs[1:]:\n", "    for t in xs[1:-1]:\n")],
     "parallel/spmd.py"),
    ("spmd: ppermute rotates the wrong way", SPMD,
     "def ppermute(x: torch.Tensor, axis_name, perm) -> torch.Tensor:", [
         ("    src = [i for i, j in perm if j == rank]\n",
          "    src = [j for i, j in perm if i == rank]\n")],
     "parallel/spmd.py"),
    ("spmd: shard_pool splits the page axis", SPMD,
     "    def shard_pool(self, x):", [
         ("        spec = P(*([None, TP_AXIS] + [None] * (x.ndim - 2)))\n",
          "        spec = P(*([TP_AXIS, None] + [None] * (x.ndim - 2)))\n")],
     "serving/tp_engine.py"),
    ("spmd: the [Q_t | K_t | V_t] permutation skipped", SPMD,
     "    def shard_params(self, params):", [
         ("                    v = v[:, perm.to(v.device)]\n",
          "                    pass\n")],
     "serving/tp_engine.py"),
    ("spmd: bo added before the all-reduce", SPMD,
     "def _block_out_proj(p, att, axis_name=None):", [
         ('    return _psum_partial(att @ p["Wo"], axis_name) + p["bo"]\n',
          '    return _psum_partial(att @ p["Wo"] + p["bo"], axis_name)\n')],
     "models/transformer.py"),
    ("spmd: the pipeline schedule skips its last tick", SPMD,
     "def pipeline_apply(", [
         ("    n_steps = S + M - 1\n", "    n_steps = S + M - 2\n")],
     "parallel/pipeline.py"),
    ("spmd: all_to_all joins on the split axis", SPMD,
     "def all_to_all(x: torch.Tensor, axis_name, split_axis: int,", [
         ("                          for t in xs], dim=concat_axis)\n",
          "                          for t in xs], dim=split_axis)\n")],
     "parallel/spmd.py"),
    ("spmd: dropout keyed by the local row", SPMD,
     "    def _loss_pipe(self, head_p,", [
         ("                    with row_offset_scope(row_off):\n",
          "                    with row_offset_scope(0):\n")],
     "parallel/pipeline_wrapper.py"),
    ("spmd: the pipeline's trunk gradients scaled by 1/M", SPMD,
     "    def _step(self, f, l, fm, lm):", [
         ("                                   g_trunk[j], net.iteration)\n",
          "                                   {n: g / self.microbatches\n"
          "                                    for n, g in g_trunk[j].items()},"
          "\n                                   net.iteration)\n")],
     "parallel/pipeline_wrapper.py"),
    # path 15, each caught by phase 42: the rank that keeps its own
    # gradient by the ranks' parameter digests (they must be
    # bit-identical); the psum across processes added out of slot order
    # by the collectives' outputs against one process, bit for bit; the
    # unverified manifest by the restore of a checkpoint with a flipped
    # byte, which must raise CheckpointCorruptError
    ("multiprocess: one rank keeps its own gradient, not the sum",
     MULTIPROCESS, "    def _step(self, ds) -> None:", [
         ("        vec = _sum_in_rank_order(vec)\n",
          "        summed = _sum_in_rank_order(vec)\n"
          "        vec = summed if process_index() == 0 else vec\n")],
     "parallel/multiprocess.py"),
    ("multiprocess: the psum across processes adds out of slot order",
     MULTIPROCESS, "def _psum(x: torch.Tensor, axis_name):", [
         ('    xs, _, dev = _collective("psum", x, axis_name)\n',
          '    xs, _, dev = _collective("psum", x, axis_name)\n'
          '    if _ctx("psum").rt.lay.multiprocess:\n'
          '        xs = xs[::-1]\n')],
     "parallel/spmd.py"),
    ("multiprocess: the sharded restore skips the manifest", MULTIPROCESS,
     "def restore_sharded_checkpoint(", [
         ("            verify_manifest(abspath)\n", "            pass\n")],
     "util/sharded_checkpoint.py"),
    # path 16, each caught by phase 43: the Keras gates in the wrong
    # order by the import against Keras's own forward in numpy; the
    # dropped masks by the batches' mask check; the skipped record by the
    # streamed fit's record count (the trainer waits for a fourth record
    # that never comes, then the count is short)
    ("etl: the Keras LSTM gates in the wrong order", ETL,
     "def _lstm_weights(", [
         ("            return np.concatenate([i, f, o, c], axis=-1)\n",
          "            return np.concatenate([i, f, c, o], axis=-1)\n")],
     "modelimport/keras.py"),
    ("etl: the sequence iterator drops the masks", ETL,
     "    def _emit(self, items) -> DataSet:", [
         ("        return DataSet(feats, labs,\n"
          "                       None if full else fmask,\n"
          "                       None if full and same else lmask)\n",
          "        return DataSet(feats, labs)\n")],
     "datavec/iterators.py"),
    ("etl: the consumer skips a record", ETL, "class KafkaSource:", [
        ("        for msg in self._consumer:\n"
         "            yield decode_dataset(msg.value)\n",
         "        for i, msg in enumerate(self._consumer):\n"
         "            if i != 1:\n"
         "                yield decode_dataset(msg.value)\n")],
     "streaming/pipeline.py"),
    ("stream: DedupCache re-executes a completed id", STREAM,
     "    def begin(self, request_id: str) -> Tuple[str, Any]:", [
         ("            ent = self._done.get(request_id)\n"
          "            if ent is not None:\n"
          "                self._hits += 1\n"
          "                return \"cached\", ent.outcome\n",
          "            ent = None\n")],
     "serving/exactly_once.py"),
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
             MOE: (PAGED, FLASH), GRAPH: (LSTM,), PRETRAIN: (LSTM,),
             DISAGG: (PAGED,), QOS: (PAGED, FLASH, LSTM),
             POOL: (PAGED, FLASH), STREAM: (PAGED, FLASH),
             WIRE: (PAGED, FLASH, LSTM), NLP: (), EMBED: (),
             PARALLEL: (FLASH, LSTM), SPMD: (PAGED, FLASH),
             MULTIPROCESS: (FLASH,), ETL: (LSTM,)}
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
    if DISAGG in sources:
        cases += phase_cases(torch, "27", "path 8, disaggregated",
                             lambda cs, M, card: disagg_run(torch, cs, M,
                                                            card))
    if QOS in sources:
        cases += phase_cases(torch, "28-29", "QoS, early stopping",
                             lambda cs, M, card: qos_run(torch, cs, M, card))
    if {POOL, STREAM} & set(sources):
        import deeplearning4j_tpu_torch.ops.paged_attention as pa

        cases += phase_cases(torch, "30-31", "path 9, streams, the door",
                             lambda cs, M, card: cs.phases_30_31(
                                 torch, M, pa, card, None))
    if WIRE in sources:
        import deeplearning4j_tpu_torch.ops.paged_attention as pa

        cases += phase_cases(torch, "32-33", "path 10, the wire",
                             lambda cs, M, card: cs.phases_32_33(
                                 torch, M, pa, card))
    if NLP in sources:
        cases += phase_cases(torch, "34-35", "path 11, the NLP steps",
                             lambda cs, M, card: cs.phases_34_35(
                                 torch, M, card))
    if EMBED in sources:
        cases += phase_cases(torch, "36-37", "path 12, its device parts",
                             lambda cs, M, card: cs.phases_36_37(
                                 torch, M, card))
    if PARALLEL in sources:
        cases += phase_cases(torch, "38-39", "path 13, data parallel",
                             lambda cs, M, card: cs.phases_38_39(
                                 torch, M, card))
    if SPMD in sources:
        import deeplearning4j_tpu_torch.ops.paged_attention as pa

        cases += phase_cases(torch, "40-41", "path 14, the SPMD half",
                             lambda cs, M, card: cs.phases_40_41(
                                 torch, M, pa, fa, card))
    if MULTIPROCESS in sources:
        cases += phase_cases(torch, "42", "path 15, two processes",
                             lambda cs, M, card: (
                                 cs.phase_two_processes(torch, M, card),
                                 cs.phase_collectives_across(torch, M,
                                                             card)))
    if ETL in sources:
        cases += phase_cases(torch, "43", "path 16, files to a served model",
                             lambda cs, M, card: cs.phase_etl(torch, M,
                                                              card))
    print(json.dumps({"package": fa.__file__, "cases": cases}), flush=True)


def disagg_run(torch, cs, M, card) -> None:
    """`chip_smoke.py`'s phase 27: path 8a, 8b and 8c."""
    import deeplearning4j_tpu_torch.ops.paged_attention as pa

    cs.phase_disagg(torch, M, pa, card)
    net, _ = cs.phase_migration(torch, M, pa, card)
    cs.phase_prefix_cluster(torch, M, pa, card, net)


def qos_run(torch, cs, M, card) -> None:
    """`chip_smoke.py`'s phases 28 and 29."""
    import deeplearning4j_tpu_torch.ops.paged_attention as pa

    net = cs.path1_net(torch, M, torch.bfloat16)
    cs.phase_qos(torch, M, pa, card, net)
    del net
    torch.cuda.empty_cache()
    cs.phase_extras(torch, M, card)


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
    for i, D in ((0, 384), (1, 512), (10, 256)):
        # the clusters' output slices must agree bit for bit: the
        # backward's on q, k, dO slices that repeat, O's on v slices
        for inputs, outs, what in ((cs.flash_inputs_sliced, slice(2, 5),
                                    "repeated slices"),
                                   (cs.flash_fwd_sliced_inputs, slice(0, 1),
                                    "repeated V slices")):
            q, k, v, do = inputs(torch, 1, 512, 2, D, seed=90 + i)
            got = cs.flash_run(fa, q, k, v, do, True)
            ref = cs.flash_plain_f32(fa, q, k, v, do, True, got)
            units = {n: u for n, _, u in cs.flash_errors(fa, got, ref, f32)}
            units["slice bits"] = 0.0 if all(
                cs.flash_slices_equal(torch, got[outs])) else float("inf")
            cases.append({"case": f"B=1 T=512 H=2 D={D} float32 causal, "
                                  + what,
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
                               capture_output=True, text=True, timeout=1800)
            if p.returncode != 0:
                log(f"{name}: the check process failed (exit "
                    f"{p.returncode}): {p.stderr.strip()[-400:]}")
                results.append((name, None))
                continue
            for line in p.stdout.splitlines():  # which check caught it
                if line.startswith("phase ") and " failed: " in line:
                    log(f"{name}: {line[:300]}")
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
