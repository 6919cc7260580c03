#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deeplearning4j_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, a few minutes on an H100
    python3 chip_smoke.py --lstm-timing [--package OLD/deeplearning4j_tpu_torch]
    python3 chip_smoke.py --flash-timing [--package OLD/deeplearning4j_tpu_torch]
    python3 chip_smoke.py --paged-timing [--package OLD/deeplearning4j_tpu_torch]
    python3 chip_smoke.py --path5    # phase 21 alone (about 1.5 minutes)
    python3 chip_smoke.py --phases-22-23   # the CNN and MoE phases alone
    python3 chip_smoke.py --phases-24-26   # the graph and pretraining phases
    python3 chip_smoke.py --phases-27-29   # the cluster half and A10b phases
    python3 chip_smoke.py --phases-30-31   # path 9: the replica pool tier
    python3 chip_smoke.py --phases-32-33   # path 10: the wire, processes
    python3 chip_smoke.py --phases-34-35   # path 11: Word2Vec, NLP parity
    python3 chip_smoke.py --phases-36-37   # path 12: DeepWalk, t-SNE, the UI
    python3 chip_smoke.py --phases-38-39   # path 13: data-parallel training
    python3 chip_smoke.py --phases-40-41   # path 14: the SPMD half
    python3 chip_smoke.py --phases-42-43   # paths 15-16: processes, data

`--lstm-timing` runs phase 17 alone (the LSTM source built, the rows
checked and timed, launch counts 0) on the checkout's package or, with
`--package`, on another copy of it (an earlier commit's, unpacked with
`git archive` into a git-ignored directory), and prints one JSON line of
the rows' times. Run it old/new/new/old in one call for a kernel A/B.
`--flash-timing` does the same for phase 16's f32 flash rows at head
dims 256-512 (B=2, H=4, T=2048, and paths 2fw's and 2fx's shapes;
`f32_cluster_rows`), `--paged-timing` for row 1's f32 chunk rows (C=256:
dense at path 1's shapes, int8 at one 14a shard's; `paged_f32_rows`).
`--path5` builds the paged and flash sources and runs phase 21 (path 5,
the GPT behind `ModelServer`) alone, then prints one JSON line of its
launch counts. `--phases-22-23` builds the paged and flash sources and
runs phases 22 and 23 alone (their rows and launch counts logged).
`--phases-24-26` builds the LSTM source and runs phases 24 to 26 alone,
then prints one JSON line of phase 25's launch counts. `--phases-27-29`
builds every source and runs phases 27 to 29 alone, then prints one JSON
line of their launch counts. `--phases-30-31` builds the paged and flash
sources and runs phase 7 (path 1, for its tokens/s) and phases 30 and 31
alone, then prints one JSON line of their launch counts. `--phases-32-33`
builds the paged and flash sources and runs phases 32 and 33 alone, then
times row 1's f32 rows and prints one JSON line of those rows and the
launch counts. `--phases-34-35` runs phases 34 and 35 alone (path 11 and
the NLP steps; no CUDA source of the port runs there) and prints one JSON
line of path 11's figures. `--phases-36-37` runs phases 36 and 37 alone
(path 12 and its parity phase; no CUDA source of the port runs there)
and prints one JSON line of path 12's figures. `--phases-38-39` builds
the flash and LSTM sources and runs phases 38 and 39 alone (path 13 and
its parity phase), then prints one JSON line of path 13's figures and
launch counts. `--phases-40-41` builds the paged and flash sources and
runs phases 40 and 41 alone (path 14 and its parity phase), then prints
one JSON line of path 14's figures and launch counts. `--phases-42-43`
builds the flash and LSTM sources and runs phases 42 and 43 alone (paths
15 and 16), then prints one JSON line of their figures and launch
counts.

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
   head_dim 256 with pages of 256 and 128, head_dim 128 with pages of 512
   and 64, and head_dim 64 and 128 with pages of 1 and 2 positions
   (decode, verify and chunk widths); f32 q also on a chunk with sharp
   scores over few keys (q x4 at position 600, GQA: one TF32 pass in
   either product falls outside the f32 tolerance there); every call on
   the route `paged_attention.plan` gives it (by
   `paged_attention.launches_by_route`), every C=256 chunk on a
   tensor-core route: "mma" for bf16 q, the split-TF32 kernel ("tf32")
   for f32 q, dense and int8 pools;
4. flash kernels: forward (O and L), dQ and dK/dV against the plain
   versions computed in f32 on the same inputs (the backward's include
   the O and L the forward kernel gave), f32 and bf16, causal and not,
   D = 128, 256, 384 and 512, T = 128 (D = 128: one or two tiles), 512,
   2048 and 4096, Tq = 512 with Tk = 1024 (bf16 D = 128 runs the three
   wgmma kernels; bf16 D >= 256 the "wgmma wide" forward, every launch
   of which must take that route, and the backward, every launch of
   which must take "wgmma wide" at D = 256 and "wgmma cluster" (clusters
   of two blocks, one column half each) at D = 384 and 512, also at T =
   128 and 192, the first 64-row tiles, where the diagonal crosses two
   32-row tiles at D = 384 and 512, and at D = 256 at T = 64, one 64-row
   block alone;
   f32 the split-TF32 kernels, at D = 256, 384 and 512 all three as
   clusters, every launch of which must take that route);
   each backward run twice, with bit-identical dQ, dK and dV (no
   atomics); at f32 D = 256, 384 and 512 also q/k/v sliced from one
   fused qkv tensor, inputs whose 128-column slices of q, k and dO repeat
   (the backward clusters' output slices must then be bit-identical:
   every block sums the partial scores in the same order), inputs whose
   v slices repeat (`flash_fwd_sliced_inputs`: O's slices must be
   bit-identical), and inputs whose score products cancel
   within each slice (partial sums many times the result), held to the
   plain versions in f64 (a score accumulator chained over a slice
   fails there); at bf16 D = 256, 384 and 512 also q/k/v sliced from one
   fused qkv tensor, inputs whose V column halves are equal (O's halves
   must then be bit-identical: both warpgroups form the same P from the
   two partial scores), at 384 and 512 inputs whose q, k and dO column
   halves are equal and v's are not (`flash_halves_inputs`: dQ's, dK's
   and dV's halves must then be bit-identical: both blocks of a backward
   cluster form the same P and dS from the two partial scores), the
   forward alone on inputs whose O shows
   whether P is rounded to nearest bf16 (`flash_rounding_inputs`), and
   the three kernels on inputs whose dQ and dK show whether dS is
   rounded to nearest bf16 (`flash_ds_rounding_inputs`); and
   a GQA call through
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
6. training parity: a 1-layer full-width f32 GPT (d_model 1024, 8 heads
   of 128, then 4 of 256 and 2 of 512 on "tf32 cluster", T=1024,
   attention_block_size=512, B=2) from one seed takes 3 Adam
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
   then path 1f: path 1's network with f32 parameters and no
   `compute_dtype` (`MultiLayerNetwork`'s default) behind path 1's engine
   (with `logprobs=1`) and traffic, after a warm-up, twice
   (`SERVE_F32_REPEATS`; tokens/s); counts set to 0 before and read
   after: every C=256 launch on the split-TF32 chunk kernel ("tf32" in
   `paged_attention.launches_by_route`), every decode launch on
   "scalar", nothing else, no call of a plain version; greedy tokens
   identical across the runs; the first generated token of a 4096-token
   prompt with its log-probability within `PATH1F_LOGPROB_ATOL` (1e-4)
   of the log of `net.output`'s last-position probability on the card;
   one traced batch (top kernels); its launches go into row 1's f32 rows;
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
   top kernels; then path 2w: the same network with 4 heads of 256
   (head dim 256, as Gemma's), B=2 x T=4096, 1 warm-up and 3 timed steps
   read the same way: 8 forward, 8 dQ and 8 dK/dV launches a step, all
   on the "wgmma wide" route, no plain call; then path 2x: the same
   network with 2 heads of 512, B=2 x T=4096, 1 warm-up and 3 timed
   steps read the same way: 8 forward launches a step on "wgmma wide",
   8 dQ and 8 dK/dV on "wgmma cluster", no plain call;
10. train f32 (path 2f): the same gpt_long network in f32
   (`compute_dtype=None`, `MultiLayerNetwork`'s default) at B=1 x T=4096:
   1 warm-up step, then 3 timed steps (step ms, tokens/s, losses, peak
   device memory); counts set to 0 before and read after: 8 forward, 8 dQ
   and 8 dK/dV launches per step, all on the split-TF32 route
   (`flash_attention.launches_by_route`), no plain call; one more step
   under torch.profiler; then paths 2fw and 2fx, the same f32 network
   with 4 heads of 256 and with 2 heads of 512, read the same way, all
   24 launches a step on "tf32 cluster";
11. LSTM kernels: the forward (with its training stash) and backward
   kernels, unmasked and masked, forward and reverse, against the plain
   versions on the card (TF32 off), f32 and bf16, every case of
   `lstm_cases` (H = 128 to 2048, a ragged 196 and odd 195 and 385, B = 8
   to 8192, T = 1 to 64, both bf16 forward routes, f32 at H=1024, B=2048
   and at H=2048; nonzero h0, c0 and peepholes; masks with ragged
   lengths, a row never masked, a row masked from t=0 and a hole; the
   backward on the forward kernel's own stash), every output held row by
   row (`lstm.error_in_tolerances`: 1e-4 f32, 2^-6 bf16, of the row's
   largest |ref|), and the forward without the stash beside it (h_out,
   hT, cT); the cooperative bf16 forward and backward at B = 1, 31, 32,
   33, 100, 128, H = 1024 and 196, masked and not, forward and reverse
   (`lstm_coop_cases`), each also run twice with bit-identical outputs
   (the forward with and without the stash, the backward on its stash)
   and every launch of both on "cooperative", and on inputs whose rows
   8-15 of every 16 repeat rows 0-7 (B = 64, where their warpgroups split
   K, and 128; T=50; the forward's inputs and the backward's cotangents):
   the repeated rows bit-identical; the f32 kernels (split TF32, two forward
   passes a block at H=2048) run twice with bit-identical outputs, and the
   split-TF32
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
   512 (B=2, H=4, T=2048; the bf16 forward and backward at each of them
   beside the time of the mma.sync kernel each replaced, PERF.md's; the
   backward at 384 and 512 logged with its clusters: blocks each and how
   many fit at once), at path 2w's shape (B=2, H=4, T=4096, D=256, with
   path 2w's launch counts) and path 2x's (B=2, H=2, T=4096, D=512, with
   path 2x's launch counts), and for the f32 kernels at
   phase 6's shape (B=2,
   H=8, T=1024, D=128), at path 2f's (B=1, H=8, T=4096, with path 2f's
   launch counts), at head dims 256, 384 and 512 (B=2, H=4, T=2048, on
   the cluster route, logged with their clusters: blocks each and how
   many fit at once, and beside the time of the grid-z kernel each
   replaced, PERF.md's) and at path 2fw's and 2fx's shapes (B=1, H=4,
   T=4096, D=256; B=1, H=2, T=4096, D=512; with their launch counts);
   SDPA in f32, TF32
   off; bound 3 x flops / 495 TFLOP/s for the split-TF32 routes, the
   f32-FMA bound printed beside it; the
   int8 kernel also at a
   C=128 chunk; each paged
   case with its launch plan (route, slice, splits);
17. LSTM timing: rows 5-8 at main path 4's shape (T=64, B=2048, H=1024,
   unmasked), main path 4b's window (T=24, B=8192, H=256, unmasked and
   masked) and main path 4s's window (T=50, B=32, H=1024: the cooperative
   forward with and without the stash, the cooperative backward) and its
   `output` (T=1000, B=32: the forward without the stash), bf16, the
   same way, beside their plain versions, the bound (2*T*B*H*4H flops;
   each input read and each output written once) and cuDNN's LSTM as
   yardstick (`torch.nn.LSTM`: no peepholes, its own input GEMM; forward
   minus one input matmul, and fwd+bwd minus fwd), with each launch plan;
   the two bf16 routes of each pass at their boundary (T=64, H=1024,
   B=128 cooperative: the forward with and without the stash, both
   passes masked and not; B=129 clusters, both passes; B=256 the cluster
   forward), the cooperative rows beside the time of the kernel they
   replaced where PERF.md has it (`LSTM_COOP_MMA_MS`,
   `LSTM_BWD_CLUSTER_MS`); the f32 kernels (split TF32) at T=8, B=2048,
   H=1024, at path
   4f's shape (T=64, with its launch counts) and masked at path 4b's
   window, against cuDNN in f32 (TF32 off), bound 3 x flops / 495
   TFLOP/s or the bytes, the f32-FMA bound printed beside it; every
   row's outputs held to the plain versions within the tolerance first;
18. a sigmoid/tanh LSTM wider than the fused kernels take (H=2304 >
   `ops.lstm.MAX_H`): `lstm_forward` takes its step loop on the card
   (route counts set to 0 before and read after: loop > 0, fused 0, no
   kernel launch); one layer's outputs and gradients, f32 and bf16,
   against the f32 loop on the CPU; a GravesLSTM(2304) network's 2 SGD
   fit steps against the CPU (losses rtol 1e-5, params atol 1e-5);
19. train (main path 4s): the `lstm_large` network of phase 13 (bf16
   compute over f32 masters, RMSPROP lr 0.1) fed the mini-batches of
   Deeplearning4j's GravesLSTMCharModellingExample: B=32 sequences of
   T=1000, tBPTT 50, one-hot rows as features, made from a seed: after a
   warm-up fit, 5 timed fits (median wall and its spread, samples/s,
   loss (finite), peak device memory); counts set to 0 before the first
   and read after it: 40 unmasked
   forward launches and 40 unmasked backward launches, all on
   "cooperative", nothing masked, no plain call; then one
   `output` of the batch from the network (its f32 masters, as the JAX
   package's `output` runs: 2 forward launches without the stash on "tf32
   clusters") and one from a bf16 copy of it (the same weights, `dtype=
   bfloat16`: 2 launches without the stash on "cooperative"), finite
   (B, T, vocab) probabilities; one more fit under
   torch.profiler (idle share, top kernels). It runs after phase 18, and
   its launch counts go into phase 17's rows at its window;
20. train (path 4e): the `lstm_large` network of phase 13 (bf16 compute
   over f32 masters, RMSPROP lr 0.1) through the training loop a
   Deeplearning4j user writes, fed f32 one-hot rows (B=2048 x T=64, as
   GravesLSTMCharModellingExample's CharacterIterator yields them):
   seeded DataSets merged, shuffled and split (`LSTM_4E`: 4 fit batches,
   1 for the step pairs, 1 held out); `fit(AsyncDataSetIterator(...))`
   with a `HealthSentinel`, `ScoreIterationListener`,
   `PerformanceListener` and `CheckpointListener(every 2, keep_last=2)`,
   one NaN in one row of the third batch: that step skipped (one skip,
   parameters and RMSPROP state bit-identical to before it, the
   iteration advanced), every other score finite; counts set to 0 before
   and read after: 2 + 2 launches a step on "bf16 clusters", no plain
   call; `evaluate` of the held-out batch (2 forwards without the stash
   on "tf32 clusters": `output` runs the f32 masters), its confusion
   matrix equal to numpy's from the card's `output` and totalling B*T;
   the newest verified checkpoint restored with `restore_model` (params
   and RMSPROP state equal to that step's, the same confusion matrix);
   3 guarded steps each bit-identical to an unguarded step of a clone
   from the same state on the same batch (both timed); the guard's
   health vector against `torch.linalg.vector_norm` (1e-4 relative) and
   on gradients of known values (exact norm, a NaN in the first layer
   caught); checkpoint save time; a traced guarded step; then a second
   `lstm_large` with `optimization_algo=LBFGS` fits one batch for 3
   iterations: its score falls and stays finite, every launch on "bf16
   clusters". Its launch counts go into phase 17's rows at its shape;
21. serve (path 5): path 1's network behind `ModelServer(max_batch_size=4,
   breaker_threshold=3, breaker_reset_timeout=1, generation=path 1's
   engine)`, counts set to 0 after a warm-up and read after the last
   server shuts down: 8 predicts of (1, 4096) token ids from 8 threads in
   fewer device steps than requests, each (1, 4096, 256), finite and
   within 1e-4 of `net.output` on its row alone (`output` runs the f32
   masters: the f32 flash forward on its split-TF32 route); path 1's six
   requests through `server.generate` from 6 threads (tokens/s beside
   path 1's), again with 4 predicts beside them (`pending()` > 0); one
   traced window; a candidate (the same network, its output bias raised
   by 40 on token 7) saved once to a `CheckpointStore` and reloaded while
   two long generations are in flight and two are queued (the scheduler
   parked by a step hook until the engine drains): the in-flight requests
   finish on the old weights (none all token 7, their tokens a
   continuation of their earlier run), the queued and later requests run
   on the candidate (all token 7), `model_version` 1, the recorder shows
   "drain", "swap complete" and the in-flight retirements between them;
   the reload's wall split by load and verify, canary, drain wait and
   swap; a NaN candidate refused (`ModelValidationError`, version kept)
   and a NaN live model's step failed by the non-finite screen; three
   failed steps open the breaker (closed, closed, open), predict and
   generate then fail fast with no device step, one probe after the
   reset timeout closes it; a second server with int8 weights and the
   drift gate on a (2, 512) eval set: its report at construction, a
   reload accepted, the same reload refused with the gate set below the
   drift it measured; `shutdown()` drains; `metrics_text()` carries the
   predict-latency and engine histograms, `flight_record()` the served,
   reload and breaker events; the paged kernel launched at C=1 and
   C=256 (bf16 pools, before the reload) and the f32 flash forward, no
   plain call. Its launch counts go into phase 16's rows;
22. the CNN layers and path 6 (f32 with TF32 off for the checks): each
   layer's forward and its input and parameter gradients on the card
   held to the same layer on the CPU, and its forward to this script's
   numpy f64 version (written here, not taken from the port), within
   1e-4 of the largest |reference| (`CNN_TOL`): convolutions in Truncate
   (pad 1), Same (4x4, and 3x3 at stride 2: pads split with the extra at
   the end), Strict (stride 2) and dilation 2; MAX, AVG, SUM and PNORM
   pooling with SAME padding on negative inputs; BatchNormalization
   (FF and NHWC) for 3 training steps, its running mean and variance
   against the biased batch statistics, then in eval mode; LRN (n=5);
   masked global MAX and AVG pooling. Then path 6: `lenet_configuration()`
   at bench_lenet's shape (`bench.py:202-232`: B=4096 28x28x1 uint8
   images from the port's `MnistDataSetIterator(4096, raw_uint8=True)`,
   the synthetic stand-in without cached MNIST, through
   `ImagePreProcessingScaler`, bf16 compute over f32 masters, Nesterovs
   lr 0.01 momentum 0.9): a warm-up step, then 5 timed steps (step ms,
   samples/s, losses finite and falling, peak device memory), one more
   under torch.profiler (idle share, top kernels, copy kernels); then
   LeNet in f32 on the card and on the CPU from one set of weights, 3
   steps at B=64 (losses rtol 1e-4, parameters 1e-5 + 1e-5 |ref|), and
   the card's `output` against a numpy forward (the flatten in (h, w, c)
   order) within 1e-4;
23. SelfAttention, MoE and path 2m: a non-causal `SelfAttention` of
   gpt_long's width (1024, 8 heads of 128, block_size 1024) at B=2,
   T=4096 in bf16 and in f32: output and every gradient on the flash
   route against the same layer on its plain route (full attention) in
   f32, within 2e-2 (bf16) / 1e-4 (f32) of the largest |reference| (dbk,
   0 in exact arithmetic, at dbv's scale), one launch of each flash
   kernel on "wgmma" / "tf32"; TokenEmbedding -> SelfAttention ->
   GlobalPoolingLayer(AVG) -> OutputLayer takes 3 bf16 fit steps (3
   launches of each kernel on "wgmma", no plain call); an `MoELayer`
   network in f32 against numpy with capacity overflow (the output
   within 1e-4, the load-balancing term of the training loss within
   1e-5); path 2m: gpt_long with `moe_experts=8` (capacity factor 1.25,
   aux weight 0.01), bf16 over f32 masters, B=8 x T=4096, Adam, as phase
   9 with 3 timed steps (8 launches of each flash kernel a step on
   "wgmma"), the load-balancing term and the dispatch's index kernels in
   the traced step; the same network in f32 at capacity factor 8 behind
   a `DecodeEngine`: two prompts (100 and 600 tokens) x 32 greedy tokens
   equal `generate`'s, with paged launches at C=1 and C=256 and no plain
   call. The non-causal flash rows at the SelfAttention shape (bf16 and
   f32) are timed as in phase 16 with its launches; path 2m's launches
   go into the causal rows at path 2's shape, its engine's into rows 1;
24. the graph builder and path 7: a residual DAG whose nodes are added
   before their inputs must come out of `GraphBuilder.build()` in an order
   that runs every node after its inputs (checked here, not by the
   package), and so must ResNet-50's; then path 7, `resnet_configuration(
   depth=50, n_classes=10)` as `bench_resnet50` builds it (`bench.py:256-
   295`: a ComputationGraph of 53 convolutions in SAME mode, each followed
   by BatchNormalization, and 16 residual add vertices; B=256 32x32x3
   uint8 images, seeded class templates plus noise, through
   `ImagePreProcessingScaler`, bf16 compute over f32 masters, Nesterovs lr
   0.1 momentum 0.9, l2 1e-4): a warm-up step, 5 timed steps (step ms,
   median and spread, samples/s, losses finite, peak device memory,
   `num_params`), one more under torch.profiler (idle share, top
   kernels); every BatchNormalization node's running mean must have moved;
   `output` of one batch ((256, 10) probabilities, finite, rows summing to
   1 within 1e-3) and `evaluate` of it (its accuracy equal to numpy's on
   that output, the confusion matrix totalling 256);
25. the graph on the LSTM kernels: path 4's char-RNN (vocab 256, two
   GravesLSTM(1024), RnnOutputLayer, RMSPROP lr 0.1, bf16 over f32
   masters, OneHotEncoder on uint8 ids, B=2048 x T=64) as a linear-chain
   ComputationGraph and as the list container, from one seed (the same
   flat parameters), 3 fit steps each on the same batches: 6 + 6
   unmasked launches (rows 5 and 6) each, no plain call, losses within
   1e-5 relative and parameters within lr / 1000 of each other; path 4b's
   char-RNN (vocab 64, H=256, B=8192 x T=48) as a graph with tBPTT 24 on
   ragged rows: 4 masked forward and 4 masked backward launches (rows 7
   and 8) in one fit, no plain call; an f32 masked tBPTT graph (vocab 64,
   H=256, B=16, T=30, windows of 12, SGD lr 0.1) on the card against the
   CPU for 2 fits (losses rtol 1e-5, parameters 1e-4 + 1e-5 |ref|) and
   its `rnn_time_step` in two chunks against its `output` (1e-5);
   `resnet_tiny_configuration()` in f32 on the card against the CPU for
   3 Nesterovs steps (losses rtol 1e-4, parameters and running stats
   1e-5 + 1e-5 |ref|), its `output` against this script's numpy forward
   (f64, in the script's own dependency order) within 1e-4, and a conv ->
   BN -> softmax chain as a graph against the list container on the card
   (parameters and running stats after 3 steps within 1e-6). Its
   launches go into rows 5-8 at path 4's and path 4b's shapes;
26. pretraining on the card: a VAE at Deeplearning4j's MNIST VAE
   example's widths (784 -> encoder 256, 256 -> z 2 -> decoder 256, 256,
   Bernoulli through a sigmoid, leaky ReLU, RMSPROP 1e-3, l2 1e-4,
   B=128) pretrains 60 steps on seeded binarised templates (5% of pixels
   flipped): its negative ELBO (eps = 0, a held-out batch) must fall by
   10%; DeepAutoEncoderExample's RBM stack (784-1000-500-250-100-30 and
   back, k=1, SGD 0.1, B=1000) pretrains 9 steps a layer: the first RBM's
   reconstruction error must fall by 10%; `pretrain_loss(rng=None)` and
   its gradient on the card against the CPU (f32, TF32 off: loss 1e-5
   relative, gradients 1e-4 of the largest |reference|) for the VAE and
   the first RBM, and against this script's numpy f64 versions (the RBM's
   CD-1 surrogate and gradient, the VAE's negative ELBO) within 1e-4; an
   AutoEncoder stack with no corruption (784 -> 256 tanh dense, frozen ->
   64 -> 16, SGD 0.1, B=128, 2 epochs of 4 batches) on the card against
   the CPU and against this script's greedy reference (f64 autograd,
   layer by layer) within 1e-5 + 1e-4 |ref|; ms per pretrain step of
   each;
27. path 8: path 1's network (bf16, its engine settings) disaggregated.
   8a: a `DisaggCoordinator` (one prefill-role, one decode-role
   `ModelServer`) beside one colocated `ModelServer`, bench_serve_disagg's
   two Poisson mixes at path 1's lengths (prompts of 4096 with 32 tokens
   out, prompts of 128 with 128 out; 6 requests each, greedy), then the
   decode-heavy mix with int8 KV: every request's tokens equal the
   colocated server's, one handoff a request, 0 fallbacks, the prefill
   server never decodes and the decode server never prefills; tokens/s of
   each, handoff MB and MB/s. 8b: a 4096-token prompt migrated
   (`migrate_slots`) after 16 of 64 tokens and resumed on a second engine:
   warm in bf16 and int8 (bit-identical to the uninterrupted run, whose
   top-2 log-probabilities it records), a sampled request (temperature
   1.0) warm (equal to its uninterrupted run), cold (re-prefill of prompt
   and emitted tokens: equal in f32 pools, asserted; in bf16 its first
   divergence and the top-2 margin there printed); export, verify and
   resume ms; page ledgers whole, nothing left in use. 8c: path 3's
   shared-prefix traffic (1024 shared + 64 own tokens, 8 requests) through
   `DisaggCoordinator(prefill_replicas=2, prefix_cluster=True)` and
   `prefix_cluster=False`: identical tokens, delta pages skipped, MB
   shipped full against delta. The paged kernel launched at C=1 and C=256,
   dense and int8;
28. QoS on path 1's engine: bench_serve_qos part A at path 1's width (24
   interactive requests of 128 + 32 tokens, Poisson arrivals; a flood
   tenant at 60 tokens/s, burst 24, from 2 threads sending 8-token batch
   requests; `preempt` and `slo_shed` on): the flooder meets only its own
   `TenantQuotaExceededError`, no interactive request fails; interactive
   p99 flooded against unloaded, the batch lane's share of tokens,
   preemptions; one preempted greedy batch request (n_slots 1) equal to
   its unpreempted run in f32 pools (asserted) and in bf16 (printed);
29. path 4's char-RNN (bf16 over f32 masters, B=2048 x T=64) through
   `EarlyStoppingTrainer` (3 epochs of 4 batches, a DataSetLossCalculator
   on 2 held-out batches, a LocalFileModelSaver): the best model restored
   from its zip computes in f32 (a zip holds no compute dtype, as in the
   JAX package) and, given the run's bf16 compute back, scores exactly
   what the result recorded; a
   `ProfilerListener(sync=True)`'s p50/p90 step ms; an `XlaTraceListener`
   over 2 iterations writes a Chrome trace holding the LSTM kernels;
   `assert_deterministic` bit-exact on path 2's GPT (B=2 x T=4096, 3
   steps, every flash launch on "wgmma") and on the char-RNN (3 steps);
   whether resnet_tiny is bit-exact under cuDNN's defaults, printed. Its
   launches go into rows 2-6;
30. path 9: path 1's network at 2 layers (`POOL_SERVE`: depth cut from 8
   for the run's time limit) and engine (bf16, `max_queue` 256) behind
   `ReplicaPool.from_net(net, 3)` on the one card (a (1, 16) probe and
   canary batch, probes every second, `breaker_reset_timeout` 1 s).
   9a: a 2-layer f32 GPT at path 1's width (TF32 off) gives through a
   3-replica pool the tokens of a single `ModelServer` for path 1's six
   requests (asserted equal); at full width in bf16, path 1's six
   requests from six client threads: tokens/s beside phase 7's, requests
   served per replica, 0 failovers, the paged launches equal to 8 layers
   times the engines' summed decode steps and prefill chunks (dense, at
   C=1 and C=256, no plain call), each request's tokens equal to a single
   server's or first diverging below a top-2 log-probability margin of
   0.05 (printed); a `pool.predict` of (1, 4096) launches the f32 flash
   forward once a layer and equals `net.output` within 1e-4. 9b: a
   `ReplicaCrashInjector` on replica 1 (its predict and engine steps)
   under 12 live requests of 128 + 32 tokens: 0 failed, failovers > 0,
   evicted, readmitted after the revival (walls printed); with every
   replica broken the pool answers the typed `ServiceUnavailableError`
   and recovers by itself. 9c: `rolling_reload(CheckpointStore(d))` of a
   candidate (seed 12, f32) that replica 2 cannot serve (its post-reload
   probe fails): replicas 0 and 1 rolled back, every weight digest
   unchanged; the same candidate under live traffic: 0 failed,
   `rolling_reloads == 1`, every replica on it, computing in f32 (the
   reloaded zip has no compute dtype; printed), its tokens equal to the
   candidate's in f32 behind its own engine; a
   `ReloadCorruptionInjector` candidate (NaN parameters) refused and
   rolled back, digests unchanged; `sync_net` restores path 1's
   weights. 9d: an `Autoscaler` (spawn: a `ModelServer` on `net.clone()`)
   under a `LoadSpikeInjector` of 16 clients scales up; the new replica
   enters evicted and the probes readmit it; 0 failed or shed spike
   requests; then a scale-down forced onto the replica decoding a
   4096-token prompt after 16 of 64 tokens migrates it (`migrations >=
   1`, `migration_fallbacks == 0`), the spliced tokens equal to the
   uninterrupted run, the scale-down ms printed;
31. streams and the exactly-once door on path 9's pool: a
   `pool.generate(..., on_token=registry.open(rid).publish)` of 48 tokens
   with a concurrent reader: the frames concatenate to the unary tokens;
   an attach at cursor 16 resumes there; a crash planted on the serving
   replica at cursor 16 fails over, the re-run's cursors 1..16 are
   dropped as duplicates and the frames stay contiguous and equal to the
   unary tokens; a ring of 8 overflows typed (`StreamBackpressureError`);
   an `ExactlyOnceDoor(journal_dir=...)` around `pool.generate` answers a
   retry from its ring with no paged launch and `double_executions == 0`;
   an admitted but incomplete journal record replays through a fresh door
   and its claim equals a direct run. Path 9's bf16 paged launches go
   into rows 1, its f32 predict into the f32 forward row at T=4096;
32. path 10: path 1's network at full width, its depth cut to 2 layers
   (`WIRE_SERVE`: f32, seed 11, written to a zip here and
   served by `load_model` over the wire) behind a port `GatewayServer`
   with `serving={"replicas": 3,
   "remote": ..., "generation": path 1's engine settings}`: three
   replica PROCESSES on the one card (`python -m
   deeplearning4j_tpu_torch.serving.remote_replica --device cuda`, the
   kernels built in this process first), each restoring the zip the
   pool wrote, so each decodes in f32 pools. 10a: path 1's six requests
   from six client threads through a `GatewayClient`: every request's
   tokens (int32) equal to one f32 `DecodeEngine` on the same zip in
   this process and to an in-process 3-replica pool on it (asserted;
   both timed before any replica process exists); tokens/s of the
   three (medians of 3 runs), the card's busy share over each window
   (`nvidia-smi --query-gpu=utilization.gpu` every 100 ms), no paged
   launch in this process; a (1, 4096) predict through the wire within
   1e-4 of `net.output`. 10b: kill -9 of replica 1 under live traffic
   (4 clients of 128 + 32 through the gateway): 0 failed, evicted,
   respawned and readmitted (times from the kill). 10c: a `ChaosProxy`
   partition of replica 2 (a drill pool over the same processes): 0
   failed, evicted, readmitted after the heal, the process never
   restarted. 10d: `rolling_reload` of the zip over the wire under live
   traffic: 0 failed, versions [1, 1, 1], no rollback, tokens after it
   equal the f32 engine's. 10e: a graceful stop (SIGTERM, the slot
   retired) of replica 0 under live predicts through the gateway: 0
   failed, and every refusal of the closing replica on a kept-alive
   connection is a failover (`ServiceUnavailableError`, the closing
   server's `ServerClosedError` mapped so, or `InferenceFailedError`).
   Path 10's launches are 10a's window: each replica writes its counts
   to its log on SIGUSR1, before the runs and after the predict, and
   their difference (dense, C=1 and C=256, no plain call) equals 8
   layers times its engine's decode steps and prefill chunks in the
   window; the predict's flash forward launched in a replica. Each
   process that stopped cleanly is held to the same rule over its life;
33. the wire on the card: a `GatewayServer` (exactly-once door with a
   journal) serving path 1's network in f32 and a small MLP: a
   `generate_stream` of 96 tokens torn after its first frame resumes
   and concatenates to the unary tokens; a `generate` whose client
   disconnected is claimed, equal to a direct run; a `fit` retried with
   its request id returns the same float (a new fit does not), with no
   double execution; a gateway restarted on the journal replays an
   admitted request that never completed, its claim equal to a direct
   run, nothing pending, no double execution. Path 10's and phase 33's
   paged launches (f32 pools) go into row 1's f32 rows, timed at path
   1's shapes; the replicas' f32 predict into the f32 forward row at
   T=4096;
34. path 11: `Word2Vec` skip-gram with negative sampling at
   bench_word2vec_50k's shape (`bench.py:1198-1221`: this script's copy
   of `_zipf_corpus(50_000, 50_000, 40)`, 2,000,000 words; layer_size
   128, window 5, negative 5, min_word_frequency 1, epochs 1, seed 1,
   batch_size 16384, scan_flushes 32) on the card: the vocabulary built
   by `Word2Vec.build_vocab` and from the corpus written to a file by
   `VocabConstructor.build_vocab_from_files`, which must take the native
   counter (`native.loader.route`) and give the same vocabulary (ms of
   both); a warm-up fit, then 3 timed passes, each ended by a
   synchronize: median wall, words/s, pairs/s, pairs and batches a pass;
   one more pass under torch.profiler (idle share, top kernels), and one
   with its host parts timed (encode, windows, staging, flushes, the
   rest, the final synchronize). Checks:
   the negatives drawn on the card from the fit's fixed-point cdf against
   the 0.75-power table (a chi-square, |z| < 6, and every one of the 1000
   rarest words drawn) and, on a table whose tail words sit below f32's
   resolution near 1, 90% of the tail drawn in 1e8 draws; two same-seed
   fits on the card (atomic adds) nearer by the tables' relative
   Frobenius difference than `W2V_ATOMIC_RATIO` times seeds 1 and 2, and
   their largest entry difference printed; under
   `torch.use_deterministic_algorithms` two
   same-seed fits bit-identical (their walls printed) and a fit whose
   device lags ~20 ms a flush behind the host bit-identical to a prompt
   one (the staging arrays are copied before they are sent); the
   planted-topic corpus separated by `tests/test_nlp.py`'s criterion, and
   its learning rates, read at the device step, strictly falling batch by
   batch inside its one chunk;
35. the NLP steps at path 11's shapes, each on the card and on the CPU
   against this script's numpy f64 version (`W2V_STEP_TOL`, TF32 off):
   `_scatter_clipped` in both regimes (V=50,000: the table-shaped
   accumulator; V=200,000: argsort and segment sums) with rows clipped,
   `skipgram_step`, `_ns_batch` with given negatives (some equal to their
   context, a partial batch), `cbow_step`, `infer_step`, `glove_step`
   with duplicate rows; then fits that draw everything on the host on a
   small planted corpus, card against CPU (`W2V_FIT_TOL`): CBOW with host
   negatives, hierarchical softmax, ParagraphVectors DBOW with
   hierarchical softmax (and `infer_vector`), GloVe;
36. path 12: a planted-partition graph with BlogCatalog's counts (10,312
   vertices, 333,983 undirected edges, 39 groups, each edge inside its
   vertex's group with probability 0.8; made from a seed), `DeepWalk`
   with the DeepWalk paper's d=128, w=10, t=40 and 2 walks a vertex (the
   paper's 80 cut, for time), negative 5, batch 16384, on the card: the
   walk wall (host Python), the fit wall and words/s, one more epoch
   under torch.profiler (idle share); `KMeansClustering(39)` of the
   10,312 vectors on the card twice (the fits identical, labels_ equal
   to `predict`, the NMI against the planted groups at least
   `EMBED_NMI_FLOOR`); exact `Tsne(perplexity=30, n_iter=1000)` of all
   of them on the card (the host perplexity search's wall, the median
   iteration, the KL history, which must fall after the lying phase,
   the peak device memory, and the share of each vertex's 10 nearest
   neighbours in the embedding that share its planted group, at least
   `EMBED_KNN_FLOOR`); then a `UIServer` with in-memory storage: a
   `StatsListener` reports 5 fit steps of a classifier of the vectors
   on the card through `RemoteUIStatsStorageRouter`, `/train/system`
   must carry device bytes in use above 0 (and the card's total as the
   limit), `/train/histograms` counts for every parameter, the last
   report the trained parameters' statistics; the 10,312 t-SNE points
   with their vertex ids go to `/tsne/upload`, which must answer 10,312
   points, and `/tsne` must render 10,312 (upload and render walls);
37. path 12's device parts on the card against the CPU (within
   `EMBED_STEP_TOL` of each output's largest value) and against this
   script's numpy f64 version (`EMBED_F64_TOL`), TF32 off: one Lloyd
   step at path 12's shape with an empty cluster (assignments equal to
   numpy's, the empty cluster's centroid kept), `_tsne_step` (lying and
   not) and `_tsne_kl` at N=2048; each again with the caller's
   `allow_tf32 = True`, bit-identical to TF32 off; a one-iteration
   k-means fit whose `labels_` and cost must be the returned
   centroids'; a DeepWalk fit with hierarchical softmax and no
   negatives, card against CPU (`W2V_FIT_TOL`); the weighted walks
   following their weights;
38. path 13, the data-parallel tier: (13a) `ParallelWrapper(net)` over
   the default mesh (the one card) trains bench_gpt_long's GPT at full
   width, depth cut to 2 layers (bf16 over f32, B=8 x T=4096), 5 steps
   through a `DevicePrefetchIterator`: 2 x 5 launches of each flash
   kernel, its losses within rtol 1e-5 and its parameters within 5 x lr
   (Adam) of `net.fit` of a clone on the card; (13b) the prefetcher at
   path 4e's shape (lstm_large, f32 one-hot batches from pageable
   memory): step ms and the traced idle share with path 4e's
   `AsyncDataSetIterator` and with the prefetcher, 2 x 6 LSTM launches
   each way, then every batch staged behind a copy stream that lags the
   host (~60 ms of GPU sleep before each copy) bit-identical to its host
   batch; (13c) `DistributedMultiLayer` with
   `ParameterAveragingTrainingMaster(num_workers=4,
   averaging_frequency=5)` trains bench_lstm's char-RNN (vocab 64, H=256,
   B=8192 x T=64, bf16, RMSPROP) over a full window and a tail of two
   batches and a half one: every worker thread's LSTM launches counted,
   the result within `PAR_RMSPROP_ATOL` of the same shards fit one after
   another and averaged example-weighted, a worker crash and a
   NaN-gradient worker (re-dispatched, nothing non-finite averaged in,
   the re-runs counted), a straggler past `worker_timeout` whose
   abandoned replica's device memory is released, and the window's wall
   against one network's fit; (13d) `ParameterServerParallelWrapper(
   workers=2)` against a `NetworkParameterServer` (every push counted,
   the net on the server's params, a duplicate idempotent push dropped),
   then 2 worker processes on the card pushing over TCP, one after the
   other, equal to the in-process store (rtol 1e-6, atol 1e-7); (13e)
   `FaultTolerantTrainer` over the master with a crash after the first
   window: one restart, finite parameters; (13f) `python -m
   deeplearning4j_tpu_torch.parallel.main --mode averaging` trains a
   saved zip on the card;
39. the wrapper over an 8-slot mesh of the card against the CPU (f32,
   TF32 off): a batch of 61 trained as its first 56 rows, a
   BatchNormalization net on the whole batch's statistics (card vs CPU
   within 1e-5; a per-slot average far off), a masked tBPTT char-RNN
   whose carries are restored after its windows (its output equal to
   `net.fit`'s network's), and the averaging master card vs CPU;
40. path 14, the in-process SPMD half on 8 slots of the card
   (`parallel.mesh.set_local_slots`): (14a) path 1's GPT at full width,
   depth cut to `P14_SERVE_LAYERS` (2 of 8) for the run's time limit,
   served at `parallel={"tp": 2}`, two 4096-token prompts (chunked
   prefill) and 64 tokens each: f32 tokens identical to one device, each
   shard launching the paged kernel as often as one device does (rows 1
   and 1q at Hkv/2 heads), int8 KV identical to one device's int8 and
   self-speculation identical to f32 `generate` (one 1024-token prompt,
   32 tokens), bf16 teacher-forced
   logits within `P14_LOGIT_TOL` with the first divergent generated step
   printed, tokens/s and the traced idle share against one device,
   weight bytes per slot, one request through a `GatewayServer` with
   `serving={"parallel": {"tp": 2}}`; (14b) `PipelineParallelWrapper`
   over pipe=4 trains TRAIN's GPT (bf16 over f32, B=8 x T=4096, 2 layers
   a stage, 4 microbatches) 3 steps, flash rows 2-4 launched in every
   stage, losses and params against `net.fit` of a clone (`P14_BF16_RTOL`,
   4 lr a step), step ms against path 2's; (14c) `SequenceParallelWrapper`
   over seq=2 trains a 2-layer full-width GPT (f32, B=4 x T=4096) 2 steps
   against `net.fit`, ring and Ulysses attention against whole-sequence
   attention at that shape; (14d) two `MoELayer(expert_axis="expert")`
   of 4 experts behind full-width blocks, f32, B=8 x T=1024, over
   expert=4 under `ParallelWrapper` against the replicated MoE; (14e)
   `ParallelWrapper(param_specs=...)` over {data 2, model 4}: steps
   bit-identical to `net.fit`;
41. the SPMD runtime on the card against CPU slots (f32, TF32 off): the
   collectives bit-identical, ring and Ulysses attention, the pipeline
   and the expert-parallel MoE within 1e-5, a tp=2 engine's tokens
   equal; a 4-stage pipeline with dropout 0.1 against one device under
   `row_offset_scope(0)` (losses within rtol 1e-5);
42. path 15, the multi-process half: the one-process reference
   (`ParallelWrapper` on TRAIN's GPT at full width, depth cut to
   `P15_LAYERS` (2 of 8) for the run's time limit, bf16 over f32, B=8 x
   T=4096, 3 SGD
   and 3 Adam steps), then two worker processes on the card joined by
   gloo over `tcp://localhost` (`--p15-worker`), each training the same
   nets on its 4 rows through `MultiProcessParallelWrapper` and saving a
   sharded checkpoint from both ranks before the last Adam step: the
   ranks' parameters bit-identical, SGD within `P15_SGD_TOL` of one
   process (the worst leaf's difference over its movement), Adam losses
   within `P15_LOSS_RTOL`, flash rows 2-4 launched on the "wgmma" route
   in each process; the checkpoint restored into this process (state bit
   for bit the ranks', then the last step against the uninterrupted
   two-process step) and, with a flipped byte, refused; the net's f32
   `output` at B=1 x T=4096 exported (`util.stablehlo_export`), loaded
   in a fresh process (`--p15-load`) and held to `output` (the "tf32"
   flash forward a layer there); the step ms of two processes against
   one; then psum, all_to_all, ppermute and all_gather in one body over 2
   processes x 2 slots of the card (`--p42-spmd`) against 4 slots in
   this process: both ranks' outputs bit-identical, gradients within
   1e-5;
43. path 16, from files to a served model: a tf.keras-style char model
   at bench_lstm's width (one-hot over 64 symbols, LSTM(256) with
   sigmoid gates, softmax Dense) written with h5py (or, on a machine
   without h5py, its layout held in memory), imported with
   `KerasModelImport` on the card and on the CPU (weights equal; f32
   outputs within `ETL_IMPORT_TOL` of each other and of this script's
   numpy forward of the Keras model); 4096 sequences of 32-64 steps
   written as CSV files, read through `CSVSequenceRecordReader` and
   `SequenceRecordReaderDataSetIterator` (ALIGN_END: masked) into 4
   batches of 1024, sent through the embedded broker into
   `StreamingTrainPipeline` in bf16 (the masked LSTM kernels, rows 7-8;
   losses finite and falling, every record seen); its checkpoint through
   `CheckpointStore.upload` to a `LocalStorage` and `download` into a
   fresh store; a `ServeRoute` on the restored network answering with
   `output` bit for bit.

Prints one JSON line of per-kernel numbers, then the card's
`nvidia-smi` line, then as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero and prints no result without a CUDA device or outside a
checkout of the repository. Weights and inputs are made from seeds.
"""
from __future__ import annotations

import gc
import json
import math
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
# the bf16 forward at head dims 256-512 before "wgmma wide" replaced it:
# the mma.sync kernel's time at B=2, H=4, T=2048, causal (PERF.md, PR 10;
# NVIDIA H100 80GB HBM3 at 700 W)
FLASH_FWD_MMA_MS = {256: 0.2193, 384: 0.5471, 512: 0.7686}
# the bf16 backward before "wgmma wide" (head dim 256) and "wgmma cluster"
# (384, 512) replaced it: the mma.sync kernels' times (dQ, dK/dV) at B=2,
# H=4, T=2048, causal (PERF.md section 6, in brackets; NVIDIA H100 80GB
# HBM3 at 700 W)
FLASH_BWD_MMA_MS = {256: {"dq": 0.3806, "dkv": 0.3897},
                    384: {"dq": 0.7328, "dkv": 0.7240},
                    512: {"dq": 1.2334, "dkv": 1.3158}}
# the f32 kernels at head dims 256-512 before "tf32 cluster" took them
# over: the grid-z forward (each block recomputing the full-D scores) and
# the D = 256 backward, at B=2, H=4, T=2048, causal (PERF.md section 6,
# in brackets; NVIDIA H100 80GB HBM3 at 700 W)
FLASH_F32_GRIDZ_MS = {256: {"fwd": 0.8867, "dq": 1.9498, "dkv": 2.4335},
                      384: {"fwd": 2.5333}, 512: {"fwd": 4.1168}}
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
# paths 2fw and 2fx: path 2f's network with 4 heads of 256 and with 2 of
# 512 (the f32 flash kernels on "tf32 cluster"), B and steps as path 2f's
TRAIN_2FW_HEADS, TRAIN_2FX_HEADS = 4, 2
# path 2w: the same network with 4 heads of 256 (the bf16 flash kernels
# at head dim 256)
TRAIN_WIDE_HEADS, TRAIN_WIDE_B, TRAIN_WIDE_STEPS = 4, 2, 3
# path 2x: the same network with 2 heads of 512 (the bf16 forward on
# "wgmma wide", the backward on "wgmma cluster")
TRAIN_2X_HEADS, TRAIN_2X_B, TRAIN_2X_STEPS = 2, 2, 3
TRAIN_2X_ROUTES = {"fwd": "wgmma wide", "dq": "wgmma cluster",
                   "dkv": "wgmma cluster"}
# path 5: path 1's network and engine behind ModelServer
SERVER_GEN = dict(n_slots=8, page_size=128, prefill_chunk=256,
                  prompt_buckets=(128,), max_len=4224)
SERVER_PREDICTS, SERVER_PREDICT_T = 8, 4096
SERVER_PREDICT_ATOL = 1e-4  # f32 probabilities, one row alone vs batched
SERVER_FAVOURED, SERVER_BIAS = 7, 40.0  # the reload candidate's tell
SERVER_INFLIGHT_TOKENS, SERVER_QUEUED_TOKENS = 128, 32
SERVER_PROMPT_T = (128, 4096)  # path 1's short and long prompts
SERVER_DRIFT_EVAL = (2, 512)


_T_IMPORT = time.perf_counter()


def log(*a):
    """Print a line; a phase header (`[n/43] ...`) carries the seconds
    since the script started, so the log shows each phase's wall."""
    if a and isinstance(a[0], str) and a[0][:1] == "[" and "/43]" in a[0][:8]:
        a = (f"{a[0]} (at {time.perf_counter() - _T_IMPORT:.1f} s)",) + a[1:]
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
    """(bound in ms, what bounds it, f32-FMA bound in ms or None). f32
    work is bounded by split TF32 on the tensor cores (3 products per
    f32 product), as the f32 flash rows are; the rate outside the tensor
    cores is returned beside it."""
    flops, nbytes = work(inp)
    t_bytes = nbytes / PEAK_BYTES
    if inp["q"].dtype.itemsize == 2:
        t_ops, fma_ms = flops / PEAK_BF16_FLOPS, None
    else:
        t_ops = 3 * flops / PEAK_TF32_FLOPS
        fma_ms = 1e3 * max(flops / PEAK_F32_FLOPS, t_bytes)
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops > t_bytes else "bytes"), fma_ms


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
    256 and pages of 1, 2, 64, 256 and 512 positions; f32 q also on a
    chunk with sharp scores."""
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
        ("hd=128 page=64 chunk C=256 GQA", dict(
            S=1, C=256, Hkv=2, page=64, n_pages=68, positions=[3000])),
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
    # the f32 chunk kernel (split TF32) on sharp scores over few keys: one
    # TF32 pass in either product lands outside the f32 tolerance here,
    # while a chunk over thousands of keys averages it away
    f32_only = [
        ("chunk C=256 GQA sharp (q x4)", dict(
            S=1, C=256, Hkv=2, n_pages=8, positions=[600], q_scale=4.0)),
    ]
    cases = []
    for int8 in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for name, kw in shapes + (int8_only if int8 else []) \
                    + (f32_only if dtype == torch.float32 else []):
                cases.append((f"{'int8 ' if int8 else ''}{name}",
                              dict(base, **dict(kw, dtype=dtype, int8=int8))))
    return cases


def paged_case_error(torch, pa, kw, seed):
    """One kernel call against the plain version: (largest absolute
    error, largest error in units of atol + rtol * |ref| with the
    dtype's tolerance, whether finite and every inactive lane zero).
    The call must take `paged_route(pa, kw)`, by the launch counts."""
    inp = paged_inputs(torch, seed=seed, **kw)
    before = dict(pa.paged_attention.launches_by_route)
    out = pa.paged_attention(inp["q"], inp["k_pool"], inp["v_pool"],
                             inp["page_table"], inp["positions"],
                             active=inp["active"], **scale_kw(inp))
    key = (kw["C"], paged_route(torch, pa, kw))
    if pa.paged_attention.launches_by_route.get(key, 0) \
            != before.get(key, 0) + 1:
        raise AssertionError(f"paged call at {kw} not launched on {key}: "
                             f"{pa.paged_attention.launches_by_route}")
    ref = plain_f32(pa, inp)
    torch.cuda.synchronize()
    t = pa.TOLERANCE[kw["dtype"]]
    diff = (out.float() - ref).abs()
    clean = bool(torch.isfinite(out.float()).all()) and all(
        bool((out[s] == 0).all()) for s in kw.get("inactive", ()))
    return (diff.max().item(), (diff / (t + t * ref.abs())).max().item(),
            clean)


def paged_route(torch, pa, kw) -> str:
    """The route `plan` gives a case of `paged_inputs` keywords: a C=256
    chunk on pages of 64 or more must get a tensor-core route, "mma"
    (bf16 q) or "tf32" (f32 q)."""
    bf16 = kw["dtype"] == torch.bfloat16
    route = pa.plan(bf16, kw.get("int8", False), kw["S"], kw["C"], kw["H"],
                    kw["Hkv"], kw["hd"], kw["page"], kw["n_pages"],
                    torch.cuda.get_device_properties(0)
                    .multi_processor_count).route
    if kw["C"] == 256 and kw["page"] >= 64 \
            and route != ("mma" if bf16 else "tf32"):
        raise AssertionError(f"a C=256 chunk planned on {route}: {kw}")
    return route


def phase_kernels(torch, pa):
    """Kernels against plain at the serving shapes, each call on the
    route its plan gives (f32 chunks: the split-TF32 kernel)."""
    for i, (name, kw) in enumerate(paged_cases(torch)):
        err, units, clean = paged_case_error(torch, pa, kw, seed=100 + i)
        ok = clean and units <= 1.0
        log(f"  {name:<30} q {str(kw['dtype'])[6:]:<9} max_abs_err={err:.3e} "
            f"({units:.3f} of tolerance {pa.TOLERANCE[kw['dtype']]}) "
            f"[{paged_route(torch, pa, kw)}] {'ok' if ok else 'FAIL'}")
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


def path1_requests(np):
    """Path 1's six requests, as phase 7 draws them."""
    rng = np.random.default_rng(11)
    V = SERVE["vocab_size"]
    prompts = [rng.integers(0, V, SERVER_PROMPT_T[0]) for _ in range(4)] \
        + [rng.integers(0, V, SERVER_PROMPT_T[1]) for _ in range(2)]
    n_tok = [int(x) for x in rng.choice((32, 48, 64, 96, 128), 6)]
    return prompts, n_tok


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
    V = SERVE["vocab_size"]
    prompts, n_tok = path1_requests(np)
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
    return launches, toks / wall


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


# path 1f: path 1's GPT with f32 parameters and no compute dtype
# (`MultiLayerNetwork`'s default, the precision of a reloaded candidate
# and of every replica process), behind path 1's engine and traffic
SERVE_F32_REPEATS = 2
# The first generated token's log-probability on the engine (the prompt
# prefilled in 256-token chunks through the split-TF32 chunk kernel)
# against the log of `net.output`'s last-position probability on the
# same prompt (the f32 flash forward, also split TF32), both on the card
# in f32 with TF32 off for the GEMMs: f32-accurate products in both, the
# f32 sums in other orders through 8 layers. A logit that moved by one
# TF32 pass (~5e-4 relative per product) would be off by 1e-3 or more
# (the CPU emulation in `tests/test_torch_paged_attention.py` puts one
# pass at 8x the kernels' 2e-4 on sharp scores); 1e-4 absolute keeps a
# tenfold margin over that and above the f32 order effects.
PATH1F_LOGPROB_ATOL = 1e-4


def phase_serve_f32(torch, M, pa, card):
    """Path 1f: the full-width 8-layer GPT of path 1 (vocab 256, d_model
    1024, 8 heads of 128) in f32 (no `compute_dtype`) behind path 1's
    engine (8 slots, pages of 128, prefill chunks of 256, `logprobs=1`),
    path 1's six requests (`path1_requests`) after a warm-up,
    `SERVE_F32_REPEATS` times; counts set to 0 before the runs and read
    after: every C=256 launch on "tf32", every decode launch on "scalar",
    no other key, no call of a plain version; greedy tokens identical
    across the runs; the first generated token of a 4096-token prompt
    with its log-probability within `PATH1F_LOGPROB_ATOL` of the log of
    `net.output`'s last-position probability; one traced batch. Returns
    {"paged": launches by (C, pools), "tok_s": generated tokens/s}."""
    import numpy as np

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    conf = M["gpt_configuration"](**SERVE, seed=11)
    net = M["MultiLayerNetwork"](conf, dtype=torch.float32, device="cuda")
    net.init()
    if net.compute_dtype is not None:
        raise AssertionError(f"path 1f: compute dtype {net.compute_dtype}")
    eng = M["DecodeEngine"](net, n_slots=8, page_size=128, prefill_chunk=256,
                            prompt_buckets=(128,), max_len=4224, logprobs=1,
                            device="cuda")
    V = SERVE["vocab_size"]
    prompts, n_tok = path1_requests(np)
    long = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    runs, walls, lps = [], [], []
    try:
        eng.generate(prompts[0][:16], 4)  # warm-up: cuBLAS handles, caching
        torch.cuda.synchronize()
        pa.reset_counts()
        fa.reset_counts()
        for _ in range(SERVE_F32_REPEATS):
            t0 = time.perf_counter()
            reqs = [eng.submit(p, n, logprobs=int(i == long))
                    for i, (p, n) in enumerate(zip(prompts, n_tok))]
            runs.append([r.result(timeout=900) for r in reqs])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            lps.append(reqs[long].logprob_values[0])
        by_route = dict(pa.paged_attention.launches_by_route)
        launches = dict(pa.paged_attention.launches_by)
        plain = (pa.paged_attention_plain.calls,
                 fa.flash_attention_plain_fwd.calls)
        trace = traced_batch(torch, eng, prompts, n_tok)
    finally:
        eng.shutdown()
    for o, n in zip(runs[0], n_tok):
        if o.shape != (n,) or o.min() < 0 or o.max() >= V:
            raise AssertionError(f"path 1f: bad output tokens {o.shape} "
                                 f"for n={n}")
    same = all(np.array_equal(a, b) for run in runs[1:]
               for a, b in zip(runs[0], run))
    with torch.no_grad():
        probs = net.output(prompts[long][None].astype(np.int32))
    tok = int(runs[0][long][0])
    want = math.log(float(probs[0, -1, tok]))
    diff = max(abs(lp["logprob"] - want) for lp in lps)
    toks = int(sum(n_tok))
    wall = sorted(walls)[len(walls) // 2]
    log(f"  {len(prompts)} requests (prompts {[len(p) for p in prompts]}, "
        f"outputs {n_tok}), {SERVE_F32_REPEATS} runs: wall s "
        f"{[round(w, 4) for w in walls]}; median {toks / wall:.1f} generated "
        f"tokens/s [{card}]")
    log(f"  paged launches by (C, route): {by_route}, by (C, pools): "
        f"{launches}; plain calls (paged, flash): {plain}; greedy tokens "
        f"identical across the runs: {same}")
    log(f"  first token of the {len(prompts[long])}-token prompt: {tok}, "
        f"log-probability {[lp['logprob'] for lp in lps]} on the engine, "
        f"{want!r} from net.output; largest difference {diff:.3e} "
        f"(tolerance {PATH1F_LOGPROB_ATOL})")
    log(f"  traced batch (torch.profiler, not in tokens/s): {trace}")
    if set(by_route) != {(256, "tf32"), (1, "scalar")} or any(plain) \
            or any(kind != "dense" for _, kind in launches):
        raise AssertionError(f"path 1f: expected C=256 chunks on 'tf32' and "
                             f"decode on 'scalar' only, no plain call: "
                             f"{by_route}, {launches}, {plain}")
    if not same:
        raise AssertionError("path 1f: greedy tokens differ between runs")
    if any(lp["token"] != tok for lp in lps) or diff > PATH1F_LOGPROB_ATOL:
        raise AssertionError(f"path 1f: first-token log-probability {lps} "
                             f"against {want} from net.output (token {tok})")
    del eng, net
    torch.cuda.empty_cache()
    return {"paged": launches, "tok_s": toks / wall}


def traced_batch(torch, eng, prompts, n_tok) -> str:
    """One more serving batch under torch.profiler (see `traced`). The
    serving batch itself is part of the main path: an engine failure or
    timeout propagates."""
    def run():
        for r in [eng.submit(p, n) for p, n in zip(prompts, n_tok)]:
            r.result(timeout=900)

    return traced(torch, run)


def traced(torch, run, per_name=None) -> str:
    """`run()` under torch.profiler: the device's busy time (union of
    kernel intervals), the host wall inside the trace, the idle share and
    the kernels with the most device time (and every kernel's device us,
    by name, into the dict `per_name` when one is given). The profiler is
    a reading only: one that cannot trace on this machine is reported,
    not fatal; a failure of `run` propagates."""
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
    per_name = {} if per_name is None else per_name
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


# path 1's serving shapes: 8 heads of 128, pages of 128, 34 pages a slot;
# a decode step of 8 slots (two long, four short, two inactive) and a
# prefill chunk of 256 at position 3840
PAGED_SERVING = dict(H=8, Hkv=8, hd=128, page=128, n_pages=34)
PAGED_SHAPES = {
    "decode": dict(S=8, C=1, positions=[4160, 4160, 192, 192, 192, 192, 0, 0],
                   inactive=(6, 7)),
    "chunk": dict(S=1, C=256, positions=[3840])}


def phase_timing(torch, pa, launches):
    """Kernel / plain / library times at the serving shapes, bf16 q."""
    serving = PAGED_SERVING
    decode, chunk = PAGED_SHAPES["decode"], PAGED_SHAPES["chunk"]
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
    return [paged_row(torch, pa, name, kind, dict(serving, **sh),
                      torch.bfloat16, launches.get((sh["C"], kind), 0))
            for name, kind, sh in shapes]


def paged_row(torch, pa, name, kind, shape, dtype, launches):
    """One kernels-line row of the paged kernel: held against its plain
    version in f32 on the same inputs, then kernel / plain / library
    times and the bound at `shape`, with q and the dense pools in
    `dtype`."""
    kw = dict(shape, dtype=dtype, seed=7, garbage=False)
    inp = paged_inputs(torch, int8=kind == "int8", **kw)
    args = (inp["q"], inp["k_pool"], inp["v_pool"], inp["page_table"],
            inp["positions"])
    sc = scale_kw(inp)
    out = pa.paged_attention(*args, active=inp["active"], **sc)
    ref = plain_f32(pa, inp)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    t = pa.TOLERANCE[dtype]
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
    b_ms, b_by, fma_ms = bound_ms(inp)
    row = {"name": name, "route": "cuda",
           "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
           "replaces": REPLACES, "launches": int(launches),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    extra = "" if fma_ms is None else f", f32-FMA bound {fma_ms:.4f} ms"
    if kind == "int8":  # the dense kernel on `dtype` pools, same positions
        dense = paged_inputs(torch, **kw)
        dense_ms = time_ms(torch, lambda: pa.paged_attention(
            dense["q"], dense["k_pool"], dense["v_pool"],
            dense["page_table"], dense["positions"],
            active=dense["active"]))
        extra += (f", dense kernel on {str(dtype).split('.')[-1]} pools "
                  f"{dense_ms:.4f} ms")
    S, C, H, hd = inp["q"].shape
    Hkv, page = inp["k_pool"].shape[1], inp["k_pool"].shape[3]
    plan = pa.plan(dtype == torch.bfloat16, kind == "int8", S, C, H, Hkv,
                   hd, page, inp["page_table"].shape[1],
                   torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max_abs_err {err:.3e}; wrapper host time {host:.1f} us/call"
        f"{extra}; {plan}")
    return row


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


def flash_inputs_sliced(torch, B, T, H, D, seed):
    """f32 q, k, v, dO (B, T, H, D) whose 128-column slices of q, k and dO
    repeat one slice (v's do not): the f32 backward at D > 128 gives each
    slice to one block of a cluster, and with these inputs every block's
    output slice (dQ = dS K, dK = dS^T Q, dV = P^T dO) is computed from
    bit-identical operands if the blocks share bit-identical P and dS,
    while the partial scores dO V^T of the slices differ, so their sum
    depends on its order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    one = [torch.randn((B, T, H, 128), generator=g, device="cuda")
           for _ in range(3)]
    q, k, do = (x.repeat(1, 1, 1, D // 128) for x in one)
    v = torch.randn((B, T, H, D), generator=g, device="cuda")
    return q, k, v, do


def flash_fwd_sliced_inputs(torch, B, T, H, D, seed, device="cuda"):
    """f32 q, k, v, dO (B, T, H, D) whose 128-column slices of v repeat one
    slice (q's and k's do not): the f32 forward at D > 128 gives each
    slice to one block of a cluster, and each block's slice of O = P V is
    computed from bit-identical operands if the blocks share bit-identical
    P (and the same m and l), while the partial scores of the slices
    differ, so their sum depends on its order."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, do = (torch.randn((B, T, H, D), generator=g, device=device)
                for _ in range(3))
    v = torch.randn((B, T, H, 128), generator=g,
                    device=device).repeat(1, 1, 1, D // 128)
    return q, k, v, do


def flash_halves_inputs(torch, B, T, H, D, seed=0, device="cuda"):
    """bf16 q, k, v, dO (B, T, H, D) whose column halves of q, k and dO are
    equal and v's are not: the bf16 backward at D = 384 and 512 gives each
    half to one block of a cluster, and the blocks' partial dP differ (v's
    halves do), so their sum depends on its order. If both blocks add the
    partials in one order they form the same P and dS, and each half of
    dQ = dS K, dK = dS^T Q and dV = P^T dO comes from the same operands as
    the other: bit-identical halves."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, do = (torch.randn((B, T, H, D // 2), generator=g, device=device)
                .repeat(1, 1, 1, 2) for _ in range(3))
    v = torch.randn((B, T, H, D), generator=g, device=device)
    return [t.to(torch.bfloat16) for t in (q, k, v, do)]


def flash_cancel_inputs(torch, B, T, H, D, seed, a=3.0):
    """f32 q, k, v, dO (B, T, H, D) whose score products cancel within each
    128-column slice: q = a r u + n / a, k = a s + n' / a, with r and s a
    random sign per query and per key and u = +1 on the first 64 columns of
    each slice, -1 on the last 64; each slice's running sum of q k climbs
    to about 64 a^2 and falls back to a term of a few units (f32 v and dO
    plain). A tensor-core accumulator chained over a slice truncates at
    that height on every k-step, which the check against the plain
    versions in f64 shows; fresh accumulators added in f32 stay well
    within the f32 tolerance (`tests/test_torch_flash_attention.py`
    emulates both)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def sign(n):
        return torch.randint(0, 2, (B, n, H, 1), generator=g,
                             device="cuda").float() * 2 - 1

    u = torch.ones(D, device="cuda")
    u.view(-1, 2, 64)[:, 1] = -1
    q = a * sign(T) * u + torch.randn((B, T, H, D), generator=g,
                                      device="cuda") / a
    k = a * sign(T) + torch.randn((B, T, H, D), generator=g,
                                  device="cuda") / a
    v, do = (torch.randn((B, T, H, D), generator=g, device="cuda")
             for _ in range(2))
    return q, k, v, do


def flash_rounding_inputs(torch, D, device="cuda"):
    """bf16 q, k, v (B=1, T=128, H=2, D), non-causal, whose O tells how
    the forward rounds P to bf16: q's rows are (a, 0, ..), even keys
    (1, 0, ..) and odd keys zero, so the scores are a / sqrt(D) and 0 and
    every key tile of an online softmax holds the row's maximum; P is 1
    for even keys and p = exp(-a / sqrt(D)) for odd keys, with a chosen
    so that p = 0.99121..., which rounds to nearest bf16 as 254/256 and
    truncates to 253/256 (0.24 of a bf16 unit from the midpoint, far
    beyond any f32 error of p); v is +1 on even keys and -1 on odd ones,
    so every output is (1 - bf16(p)) / (1 + p): about 0.0039 rounded and
    0.0059 truncated, 32 times the bf16 tolerance apart."""
    a = -math.log(253.75 / 256) * math.sqrt(D)
    q = torch.zeros((1, 128, 2, D), device=device)
    q[..., 0] = a
    k = torch.zeros_like(q)
    k[:, 0::2, :, 0] = 1.0
    v = torch.ones_like(q)
    v[:, 1::2] = -1.0
    return [t.to(torch.bfloat16) for t in (q, k, v)]


def flash_ds_rounding_inputs(torch, D, device="cuda"):
    """bf16 q, k, v, dO (B=1, T=128, H=2, D), non-causal, whose dQ (head 0)
    and dK (head 1) tell how the backward rounds dS to bf16. Every score
    is 0, so P = 1/128 and dS = P (dP - dsum) follows from v and dO alone.
    Head 0: q = 0, k = e0, dO = e0, v's column 0 -173 on every fourth key
    and 0 elsewhere, so O's column 0 is -43.25 and a row's dS is 173/512
    on 96 keys and -519/512 on 32. Head 1: k = 0, q = e0, v's column 0
    +43.25 on even keys and -43.25 on odd ones (O = 0), dO = c e0 with
    c = -3 on every fourth query and 1 elsewhere: a key's dS over the
    queries is the same pair of values, signed. 173/512 is a bf16 number;
    519/512 is not, and lies a quarter of a bf16 unit from the midpoint
    between 516/512 and 520/512: to nearest it rounds to 520/512,
    truncated to 516/512. So column 0 of dQ (head 0) and of dK (head 1) is
    (96 * 173 - 32 * 520) / 512 / sqrt(D) = -0.0625 / sqrt(D) with dS
    rounded and +0.1875 / sqrt(D) with it truncated, 256 bf16 tolerances
    apart; every product is exact in f32, and every other column of dQ
    and dK is 0."""
    T = 128
    q, k, v, do = (torch.zeros((1, T, 2, D), device=device)
                   for _ in range(4))
    k[:, :, 0, 0] = 1.0
    do[:, :, 0, 0] = 1.0
    v[:, 3::4, 0, 0] = -173.0
    q[:, :, 1, 0] = 1.0
    v[:, 0::2, 1, 0] = 43.25
    v[:, 1::2, 1, 0] = -43.25
    do[:, :, 1, 0] = 1.0
    do[:, 3::4, 1, 0] = -3.0
    return [t.to(torch.bfloat16) for t in (q, k, v, do)]


def flash_ds_rounding_units(torch, fa, D):
    """The bf16 kernels on `flash_ds_rounding_inputs` against the plain
    versions on the same bf16 tensors (f32 arithmetic, dS rounded to
    nearest bf16 before its products as the kernels must), the backward on
    the forward kernel's O and L: each output's error in units of its
    tolerance, by name."""
    q, k, v, do = flash_ds_rounding_inputs(torch, D)
    got = flash_run(fa, q, k, v, do, False)
    ref = fa.flash_attention_plain_fwd(q, k, v) + \
        fa.flash_attention_plain_bwd(q, k, v, got[0], got[1], do)
    torch.cuda.synchronize()
    return {n: u for n, _, u in flash_errors(fa, got, ref, torch.bfloat16)}


def flash_cancel_units(torch, fa, D, causal, seed):
    """The kernels on `flash_cancel_inputs` (B=1, T=512, H=2) against the
    plain versions in f64 (the backward on the forward kernel's O and L):
    each output's error in units of its f32 tolerance, by name."""
    q, k, v, do = flash_cancel_inputs(torch, 1, 512, 2, D, seed)
    got = flash_run(fa, q, k, v, do, causal)
    q, k, v, do = (t.double() for t in (q, k, v, do))
    o, lse = fa.flash_attention_plain_fwd(q, k, v, causal)
    ref = (o, lse) + fa.flash_attention_plain_bwd(
        q, k, v, got[0].double(), got[1].double(), do, causal)
    torch.cuda.synchronize()
    return {n: u for n, _, u in flash_errors(fa, got, ref, torch.float32)}


def flash_slices_equal(torch, outs):
    """Whether each output of `outs` has bit-identical 128-column slices
    (dQ, dK, dV on `flash_inputs_sliced`; O on
    `flash_fwd_sliced_inputs`)."""
    return [all(torch.equal(g[..., :128], g[..., i:i + 128])
                for i in range(128, g.shape[-1], 128)) for g in outs]


def flash_halves_equal(torch, o):
    """Whether an output's two column halves are bit-identical (see the
    equal-V-halves case of phase 4: each warpgroup of the bf16 forward at
    D >= 256 computes one half of O from its own copy of P; and the
    equal-halves case: each block of the bf16 backward's cluster at
    D = 384 and 512 computes one half of dQ, dK and dV)."""
    half = o.shape[-1] // 2
    return torch.equal(o[..., :half], o[..., half:])


def flash_rounding_units(torch, fa, D):
    """The bf16 forward on `flash_rounding_inputs` against the plain
    forward on the same bf16 tensors (f32 arithmetic, P rounded to
    nearest bf16 before P V as the kernel must): O's and L's errors in
    units of their tolerances, by name; the launch on the "wgmma wide"
    route."""
    q, k, v = flash_rounding_inputs(torch, D)
    fa.reset_counts()
    got = fa.flash_forward(q, k, v, False, None, with_lse=True)
    wide_routes_only(fa, 1, f"bf16 D={D}")
    ref = fa.flash_attention_plain_fwd(q, k, v)
    torch.cuda.synchronize()
    return {n: u for n, _, u in flash_errors(fa, got, ref, torch.bfloat16,
                                             names=("O", "L"))}


def cluster_routes_only(fa, n, what):
    """Require the launches since the counts were set to 0 to be `n` of
    each kernel, all on the "tf32 cluster" route (f32 at D >= 256)."""
    routes = dict(fa.launches_by_route)
    want = {(kind, "tf32 cluster"): n for kind in ("fwd", "dq", "dkv")}
    if routes != want:
        raise AssertionError(f"{what} routes {routes}")


def wide_routes_only(fa, n, what):
    """Require the forward launches since the counts were set to 0 to be
    `n`, all on the "wgmma wide" route (the bf16 forward at D >= 256)."""
    fwd = {key: c for key, c in fa.launches_by_route.items()
           if key[0] == "fwd"}
    if fwd != {("fwd", "wgmma wide"): n}:
        raise AssertionError(f"{what} forward routes {fwd}")


def bwd_routes_only(fa, D, n, what):
    """Require the backward launches since the counts were set to 0 to be
    `n` dQ and `n` dK/dV, all on the route of bf16 at head dim D: "wgmma
    wide" at D = 256, "wgmma cluster" at D = 384 and 512."""
    route = "wgmma wide" if D == 256 else "wgmma cluster"
    bwd = {key: c for key, c in fa.launches_by_route.items()
           if key[0] != "fwd"}
    if bwd != {("dq", route): n, ("dkv", route): n}:
        raise AssertionError(f"{what} backward routes {bwd}")


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
    # head dims 384 and 512: 32-row streamed tiles and clusters of two
    # blocks, one column half each (bf16 backward), clusters of D / 128
    # blocks (f32, from D = 256 on)
    cases += [(1, 512, 2, D, dt, causal)
              for dt in (torch.float32, torch.bfloat16)
              for D in (384, 512) for causal in (False, True)]
    cases += [(1, 2048, 2, 512, torch.bfloat16, True)]
    cases += [(1, 2048, 2, D, torch.float32, causal)
              for D in (256, 384, 512) for causal in (False, True)]
    # the bf16 forward at D >= 256 ("wgmma wide", 64-row blocks): the
    # first query tiles alone (T = 128; T = 192, three tiles), where at
    # D = 384 and 512 the diagonal crosses two 32-key tiles, and long rows
    cases += [(1, T, 2, D, torch.bfloat16, causal)
              for D in (256, 384, 512) for T in (128, 192)
              for causal in (False, True)]
    # the bf16 backward at D = 256 on T = 64: one 64-row block alone
    cases += [(1, 64, 2, 256, torch.bfloat16, causal)
              for causal in (False, True)]
    cases += [(1, T, 2, D, torch.bfloat16, True)
              for D in (256, 384) for T in (2048, 4096)]
    cases += [(1, 4096, 2, 512, torch.bfloat16, True)]

    def check(q, k, v, do, causal, dt, what):
        fa.reset_counts()
        got = flash_run(fa, q, k, v, do, causal)
        ref = flash_plain_f32(fa, q, k, v, do, causal, got)
        torch.cuda.synchronize()
        errs[dt] = max(errs.get(dt, 0.0), flash_check(torch, fa, got, ref,
                                                      dt, what))
        flash_same_bits(torch, fa, q, k, v, do, causal, got, what)
        D = q.shape[-1]
        if dt == torch.float32 and D > 128:
            cluster_routes_only(fa, 2, f"f32 D={D}")
        if dt == torch.bfloat16 and D > 128:
            wide_routes_only(fa, 2, f"bf16 D={D}")
            bwd_routes_only(fa, D, 2, f"bf16 D={D}")
        return got

    for i, (B, T, H, D, dt, causal) in enumerate(cases):
        q, k, v, do = flash_inputs(torch, B, T, H, D, dt, seed=40 + i)
        check(q, k, v, do, causal, dt,
              f"B={B} T={T} H={H} D={D} {str(dt)[6:]} "
              f"{'causal' if causal else 'full'}")
    # queries and keys of different lengths: separate tensor maps and key
    # tiles past the query tiles
    for i, (D, dt) in enumerate(((128, torch.float32),
                                 (128, torch.bfloat16),
                                 (384, torch.float32),
                                 (512, torch.float32),
                                 (256, torch.bfloat16),
                                 (384, torch.bfloat16),
                                 (512, torch.bfloat16),
                                 (256, torch.float32))):
        q, do = flash_inputs(torch, 2, 512, 2, D, dt, seed=70 + i)[:2]
        k, v = flash_inputs(torch, 2, 1024, 2, D, dt, seed=72 + i)[:2]
        check(q, k, v, do, False, dt,
              f"B=2 Tq=512 Tk=1024 H=2 D={D} {str(dt)[6:]} full")
    f32 = torch.float32
    for i, D in ((0, 384), (1, 512), (10, 256)):
        # the clusters on q/k/v read in place from one fused qkv tensor
        q, k, v, do = flash_inputs_fused(torch, 1, 1024, 2, D, f32,
                                         seed=84 + i)
        check(q, k, v, do, True, f32, f"B=1 T=1024 H=2 D={D} float32 "
                                      "causal, qkv slices")
        # every block of a cluster sums the partial scores in one order
        for causal in (False, True):
            q, k, v, do = flash_inputs_sliced(torch, 1, 512, 2, D,
                                              seed=86 + i)
            what = (f"B=1 T=512 H=2 D={D} float32 "
                    f"{'causal' if causal else 'full'}, repeated slices")
            got = check(q, k, v, do, causal, f32, what)
            same = flash_slices_equal(torch, got[2:])
            if not all(same):
                raise AssertionError(f"{what}: the 128-column slices of dQ, "
                                     f"dK, dV differ in bits ({same})")
            # the forward's members form one P: O's slices on V slices
            # that repeat
            q, k, v, do = flash_fwd_sliced_inputs(torch, 1, 512, 2, D,
                                                  seed=90 + i)
            what = (f"B=1 T=512 H=2 D={D} float32 "
                    f"{'causal' if causal else 'full'}, repeated V slices")
            got = check(q, k, v, do, causal, f32, what)
            if not all(flash_slices_equal(torch, got[:1])):
                raise AssertionError(f"{what}: the 128-column slices of O "
                                     "differ in bits")
        # score products that cancel within a slice, against f64
        units = flash_cancel_units(torch, fa, D, True, seed=88 + i)
        what = f"B=1 T=512 H=2 D={D} float32 causal, cancelling"
        log(f"  {what:<40} " + " ".join(f"{n} {u:.3f}"
                                        for n, u in units.items())
            + (" ok" if max(units.values()) <= 1.0 else " FAIL"))
        if max(units.values()) > 1.0:
            raise AssertionError(f"f32 D={D} cancelling scores: {units}")
    bf = torch.bfloat16
    for i, D in enumerate((256, 384, 512)):
        # the bf16 forward at D >= 256 on q/k/v read in place
        q, k, v, do = flash_inputs_fused(torch, 1, 1024, 2, D, bf,
                                         seed=94 + i)
        check(q, k, v, do, True, bf, f"B=1 T=1024 H=2 D={D} bfloat16 "
                                     "causal, qkv slices")
        # both warpgroups hold the same P: with v's column halves equal,
        # O's halves are bit-identical
        for causal in (False, True):
            q, k, v, do = flash_inputs(torch, 1, 512, 2, D, bf, seed=97 + i)
            v = v[..., :D // 2].repeat(1, 1, 1, 2)
            what = (f"B=1 T=512 H=2 D={D} bfloat16 "
                    f"{'causal' if causal else 'full'}, equal V halves")
            got = check(q, k, v, do, causal, bf, what)
            if not flash_halves_equal(torch, got[0]):
                raise AssertionError(f"{what}: O's column halves differ in "
                                     "bits")
        if D > 256:
            # both blocks of a backward cluster form the same P and dS from
            # the partials: with q's, k's and dO's column halves equal, the
            # halves of dQ, dK and dV are bit-identical
            for causal in (False, True):
                q, k, v, do = flash_halves_inputs(torch, 1, 512, 2, D,
                                                  seed=99 + i)
                what = (f"B=1 T=512 H=2 D={D} bfloat16 "
                        f"{'causal' if causal else 'full'}, equal halves")
                got = check(q, k, v, do, causal, bf, what)
                same = [flash_halves_equal(torch, g) for g in got[2:]]
                if not all(same):
                    raise AssertionError(f"{what}: the column halves of dQ, "
                                         f"dK, dV differ in bits ({same})")
        # P rounded to nearest bf16 before P V (the forward alone)
        units = flash_rounding_units(torch, fa, D)
        what = f"B=1 T=128 H=2 D={D} bfloat16 full, P rounding"
        log(f"  {what:<40} " + " ".join(f"{n} {u:.3f}"
                                        for n, u in units.items())
            + (" ok" if max(units.values()) <= 1.0 else " FAIL"))
        if max(units.values()) > 1.0:
            raise AssertionError(f"bf16 D={D} P rounding: {units}")
        # dS rounded to nearest bf16 before dS K and dS^T Q
        fa.reset_counts()
        units = flash_ds_rounding_units(torch, fa, D)
        bwd_routes_only(fa, D, 1, f"bf16 D={D}")
        what = f"B=1 T=128 H=2 D={D} bfloat16 full, dS rounding"
        log(f"  {what:<40} " + " ".join(f"{n} {u:.3f}"
                                        for n, u in units.items())
            + (" ok" if max(units.values()) <= 1.0 else " FAIL"))
        if max(units.values()) > 1.0:
            raise AssertionError(f"bf16 D={D} dS rounding: {units}")
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
    against 3 on the CPU (plain versions), from one seed, with 8 heads of
    128 ("tf32"), 4 of 256 and 2 of 512 ("tf32 cluster"); then one
    remat=True step against one remat=False step on the card."""
    import numpy as np

    kw = dict(vocab_size=256, d_model=1024, n_heads=8, n_layers=1,
              max_length=1024, attention_block_size=512, seed=5)
    batches = gpt_batches(np, 256, 2, 1024, 3, seed=5)
    fa = M["fa"]
    for n_heads in (8, 4, 2):
        cpu = M["MultiLayerNetwork"](M["gpt_configuration"](
            **{**kw, "n_heads": n_heads}), device="cpu")
        cpu.init()
        card = M["MultiLayerNetwork"](M["gpt_configuration"](
            **{**kw, "n_heads": n_heads}), device="cuda")
        card.set_param_tree([{k: v.clone() for k, v in p.items()}
                             for p in cpu._params])
        fa.reset_counts()
        losses = {"cuda": [], "cpu": []}
        for x, y in batches:
            for net in (card, cpu):
                net.fit(M["DataSet"](x, y))
                losses[net.device.type].append(net.score_value)
        counts = (fa.flash_forward.launches, fa.flash_bwd_dq.launches,
                  fa.flash_bwd_dkv.launches,
                  fa.flash_attention_plain_fwd.calls,
                  fa.flash_attention_plain_bwd.calls)
        route = "tf32" if n_heads == 8 else "tf32 cluster"
        what = f"{n_heads} heads of {kw['d_model'] // n_heads}"
        log(f"  {what}: losses card {losses['cuda']}")
        log(f"  {what}: losses cpu  {losses['cpu']}")
        log(f"  launches (fwd, dQ, dK/dV, plain fwd, plain bwd): {counts}, "
            f"by route {dict(fa.launches_by_route)}")
        if counts != (3, 3, 3, 3, 3) or set(fa.launches_by_route) != {
                (kind, route) for kind in ("fwd", "dq", "dkv")}:
            raise AssertionError(f"expected 3 kernel launches on the card "
                                 f"(route {route}) and 3 plain calls on the "
                                 f"CPU, got {counts}, "
                                 f"{fa.launches_by_route}")
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
        worst = 0.0
        for a, b in zip(card._params, cpu._params):
            for k in a:
                d = (a[k].cpu() - b[k]).abs()
                worst = max(worst, d.max().item())
                if not bool((d <= 3e-5 + 1e-5 * b[k].abs()).all()):
                    raise AssertionError(f"{n_heads} heads: param {k} "
                                         f"differs card vs CPU by "
                                         f"{d.max().item()}")
        log(f"  {what}: params after 3 steps: max abs diff card vs CPU "
            f"{worst:.3e} (rtol 1e-5 + atol 3e-5)")
        if n_heads == kw["n_heads"]:
            trained = cpu._params
    nets = []
    for remat in (False, True):
        net = M["MultiLayerNetwork"](M["gpt_configuration"](
            **{**kw, "remat": remat}), device="cuda")
        net.set_param_tree([{k: v.clone() for k, v in p.items()}
                            for p in trained])
        net.fit(M["DataSet"](*batches[0]))
        nets.append(net)
    d = (nets[0].params() - nets[1].params()).abs().max().item()
    log(f"  remat step: loss {nets[0].score_value} vs {nets[1].score_value}"
        f", max param diff {d:.3e} (atol 1e-6)")
    if abs(nets[0].score_value - nets[1].score_value) > 1e-6 * abs(
            nets[0].score_value) or d > 1e-6:
        raise AssertionError("remat=True differs from remat=False")


def phase_train(torch, M, card, compute_dtype, B, steps, seed, route,
                n_heads=TRAIN["n_heads"], moe_experts=0):
    """Main path 2 (bf16 compute over f32 masters), 2f (f32, the
    default), 2w (bf16, `n_heads` 4: head dim 256), 2x (bf16, `n_heads`
    2: head dim 512) or 2m (bf16, `moe_experts` 8: Switch MoE blocks):
    full-width gpt_long training steps via fit at B x T=4096: 1 warm-up
    step, the median of `steps` timed steps, the flash launch counts over
    them (8 of each kernel a step, all on `route`, or on `route[kind]`
    where it is a dict by kind, no plain call), one more step under
    torch.profiler. With MoE blocks also the load-balancing term (the
    train-mode score less the inference score on a timed batch, finite
    and positive) and the device ms of the dispatch's scatter/gather
    (the index kernels) in the traced step."""
    import numpy as np

    fa = M["fa"]
    conf = M["gpt_configuration"](**{**TRAIN, "n_heads": n_heads},
                                  moe_experts=moe_experts, seed=13)
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
    kernels: dict = {}
    trace = traced(torch, lambda: net.fit(batches[-1]), kernels)
    med = sorted(step_ms)[len(step_ms) // 2]
    tokens = B * TRAIN_T
    if moe_experts:
        aux = net.score(batches[1], train=True) \
            - net.score(batches[1], train=False)
        index_us = sum(t for n, t in kernels.items() if "index" in n.lower())
        log(f"  MoE ({moe_experts} experts, capacity factor "
            f"{conf.layers[1].moe_capacity_factor}, aux weight "
            f"{conf.layers[1].moe_aux_weight}): load-balancing term "
            f"{aux:.6f} of the loss; the dispatch's scatter/gather (index "
            f"kernels) {index_us / 1e3:.2f} ms of the traced step")
        if not (np.isfinite(aux) and aux > 0):
            raise AssertionError(f"MoE load-balancing term {aux}")
    log(f"  {steps} steps of B={B} x T={TRAIN_T}, {n_heads} heads of "
        f"{TRAIN['d_model'] // n_heads} "
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
    by_kind = route if isinstance(route, dict) else dict.fromkeys(counts,
                                                                   route)
    if routes != {(k, by_kind[k]): want for k in counts} or any(plain):
        raise AssertionError(f"expected {want} launches of each flash kernel "
                             f"on the {route} route and no plain call, got "
                             f"{routes}, {plain}")
    del net
    torch.cuda.empty_cache()
    return counts


def flash_work(B, H, T, D, kind, e=2, causal=True):
    """FLOPs and bytes of one launch at (B, H, T, D) with elements of `e`
    bytes: the T(T+1)/2 visible (query, key) pairs per head (T*T when not
    causal), 2*D flops per pair and product (2 products forward, 3 for
    dQ, 4 for dK/dV); each input read once and each output written once
    (L and dsum f32)."""
    pairs = B * H * T * (T + 1) // 2 if causal else B * H * T * T
    slab = B * H * T * D * e
    stats = B * H * T * 4
    if kind == "fwd":
        return 2 * 2 * D * pairs, 3 * slab + slab + stats
    if kind == "dq":
        return 3 * 2 * D * pairs, 4 * slab + 2 * stats + slab
    return 4 * 2 * D * pairs, 4 * slab + 2 * stats + 2 * slab


def phase_flash_timing(torch, fa, counts, counts_f32, counts_wide,
                       counts_2x, counts_2fw, counts_2fx):
    """Flash kernels, plain versions and SDPA at the training shapes (bf16
    at path 2's, path 2w's and path 2x's, f32 at path 2f's, 2fw's and
    2fx's, each with its launch counts)."""
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
    # bf16 head dims 256, 384 and 512 at a smaller sequence (the "wgmma
    # wide" forward; the "wgmma wide" backward at 256, the "wgmma cluster"
    # one at 384 and 512), then head dims 256 and 512 at path 2w's and
    # path 2x's shapes (with their launch counts); then the f32 kernels
    # (split TF32) at phase 6's shape and at path 2f's (with its launch
    # counts), against SDPA in f32 with TF32 off
    for D in (256, 384, 512):
        rows += flash_rows(torch, fa, 2, 4, 2048, D, {}, 0.0, seed=D)
    rows += flash_rows(torch, fa, TRAIN_WIDE_B, TRAIN_WIDE_HEADS, TRAIN_T,
                       TRAIN["d_model"] // TRAIN_WIDE_HEADS, counts_wide, 0.0,
                       seed=34, tag="_t4096")
    rows += flash_rows(torch, fa, TRAIN_2X_B, TRAIN_2X_HEADS, TRAIN_T,
                       TRAIN["d_model"] // TRAIN_2X_HEADS, counts_2x, 0.0,
                       seed=35, tag="_t4096")
    rows += flash_rows(torch, fa, 2, 8, 1024, 128, {}, 0.0, seed=32,
                       dtype=torch.float32)
    rows += flash_rows(torch, fa, TRAIN_F32_B, H, T, 128, counts_f32, 0.0,
                       seed=33, dtype=torch.float32, tag="_t4096")
    return rows + f32_cluster_rows(torch, fa, counts_2fw, counts_2fx)


def f32_cluster_rows(torch, fa, counts_2fw, counts_2fx):
    """The f32 kernels at head dims 256, 384 and 512 ("tf32 cluster") at
    the shape of the bf16 rows at those head dims (B=2, H=4, T=2048), then
    at path 2fw's and path 2fx's shapes with their launch counts."""
    rows = []
    for D in (256, 384, 512):
        rows += flash_rows(torch, fa, 2, 4, 2048, D, {}, 0.0, seed=40 + D,
                           dtype=torch.float32)
    for heads, counts, seed in ((TRAIN_2FW_HEADS, counts_2fw, 36),
                                (TRAIN_2FX_HEADS, counts_2fx, 37)):
        rows += flash_rows(torch, fa, TRAIN_F32_B, heads, TRAIN_T,
                           TRAIN["d_model"] // heads, counts, 0.0, seed=seed,
                           dtype=torch.float32, tag="_t4096")
    return rows


def flash_rows(torch, fa, B, H, T, D, counts, err, seed, dtype=None, tag="",
               causal=True):
    """The three kernels at (B, H, T, D), causal unless `causal` is
    False, in `dtype` (bf16 unless given), held to the plain versions,
    then timed beside them, SDPA and the bound: one row each, named with
    `tag` appended. An f32 kernel on
    a split-TF32 route ("tf32", "tf32 cluster") is bound by its three TF32
    passes (3 x flops / 495 TFLOP/s) or its bytes; the f32-FMA bound is
    logged beside it, and a cluster kernel's clusters (blocks each, how
    many fit on the card at once) too."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    q, k, v, do = flash_inputs(torch, B, T, H, D, dtype, seed=seed)
    o, lse, dq, dk, dv = flash_run(fa, q, k, v, do, causal)
    dsum = fa._dsum(o, do)
    ref = flash_plain_f32(fa, q, k, v, do, causal, (o, lse))
    torch.cuda.synchronize()
    err = max(err, flash_check(
        torch, fa, (o, lse, dq, dk, dv), ref, dtype,
        f"B={B} T={T} H={H} D={D} {str(dtype)[6:]} "
        f"{'causal' if causal else 'full'} (timed shape)"))
    del ref
    torch.cuda.empty_cache()
    ms = {"fwd": time_ms(torch, lambda: fa.flash_forward(q, k, v, causal, None,
                                                         with_lse=True)),
          "dq": time_ms(torch, lambda: fa.flash_bwd_dq(q, k, v, do, lse, dsum,
                                                       causal, None)),
          "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                         dsum, causal, None))}
    plain_fwd = time_ms(torch, lambda: fa.flash_attention_plain_fwd(
        q, k, v, causal), iters=10)
    plain_bwd = time_ms(torch, lambda: fa.flash_attention_plain_bwd(
        q, k, v, o, lse, do, causal), iters=10)
    torch.cuda.empty_cache()
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(*leaves,
                                       is_causal=causal).backward(dot)

    lib_bwd = time_ms(torch, sdpa_fwd_bwd) - lib_fwd
    rows = []
    suffix = ("" if D == 128 else f"_d{D}") + ("_f32" if f32 else "") + tag
    lib = fa._library()
    for code, (kind, name) in enumerate((("fwd", "flash_attention_fwd"),
                                         ("dq", "flash_attention_bwd_dq"),
                                         ("dkv", "flash_attention_bwd_dkv"))):
        route = fa.ROUTES[lib.dl4j_flash_route(code, int(not f32), D)]
        flops, nbytes = flash_work(B, H, T, D, kind, q.element_size(),
                                   causal)
        t_ops = flops / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
        fma_ms = 1e3 * max(t_ops, nbytes / PEAK_BYTES)
        if route.startswith("tf32"):
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
            if kind != "fwd" else "library: SDPA forward"
        lib_flops = flops if kind == "fwd" else sum(
            flash_work(B, H, T, D, k, causal=causal)[0]
            for k in ("dq", "dkv"))
        fma = f", f32-FMA bound {fma_ms:.4f} ms" if f32 else ""
        if kind == "fwd" and D in FLASH_FWD_MMA_MS and not f32 and T == 2048:
            fma += (f"; the mma.sync forward it replaced: "
                    f"{FLASH_FWD_MMA_MS[D]:.4f} ms (PERF.md, PR 10)")
        if kind != "fwd" and D in FLASH_BWD_MMA_MS and not f32 and T == 2048:
            fma += (f"; the mma.sync kernel it replaced: "
                    f"{FLASH_BWD_MMA_MS[D][kind]:.4f} ms (PERF.md)")
        if f32 and kind in FLASH_F32_GRIDZ_MS.get(D, {}) and T == 2048:
            fma += (f"; the grid-z kernel it replaced: "
                    f"{FLASH_F32_GRIDZ_MS[D][kind]:.4f} ms (PERF.md)")
        if route in ("tf32 cluster", "wgmma cluster"):
            fma += ("; clusters of %d blocks, %d fit at once"
                    % fa.cluster_plan(kind, D, dtype))
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
# path 4s: lstm_large fed Deeplearning4j's GravesLSTMCharModellingExample
# mini-batches (mini-batch 32, sequences of 1000, tBPTT 50)
LSTM_4S = dict(vocab=256, hidden=1024, B=32, T=1000, tbptt=50)
LSTM_4S_FITS = 5  # timed fits after the warm-up; the first is counted
# the cooperative forward on mma.sync with a grid barrier, which the wgmma
# kernel replaced: (T, B, masked, stash) -> ms on an H100 (PERF.md section
# 6; `chip_smoke.py --lstm-timing --package OLD` times an earlier package)
LSTM_COOP_MMA_MS = {(64, 128, False, True): 1.1039,
                    (64, 128, False, False): 0.9858}
# the bf16 cluster backward's time (PR 5's kernel) where the cooperative
# backward took over its shapes (PERF.md, T, B, masked: ms)
LSTM_BWD_CLUSTER_MS = {(50, 32, False): 2.3356}


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


def lstm_fwd_no_stash(L, inp, reverse):
    """The forward kernel without the training stash (inference): (h_out,
    hT, cT)."""
    return L.lstm_fwd(inp["xw"], inp["rw"], inp["peep"], inp["h0"],
                      inp["c0"], inp["mask"], reverse=reverse,
                      with_stash=False)[:3]


def lstm_case_units(torch, L, T, B, H, dtype, masked, reverse, seed):
    """One forward+backward kernel run, and one forward without the
    stash, against the plain versions: ({output: error in tolerances},
    largest absolute error)."""
    inp = lstm_inputs(torch, T, B, H, dtype, seed, masked)
    got, bwd = lstm_run(L, inp, reverse)
    lean = lstm_fwd_no_stash(L, inp, reverse)
    ref, rb = lstm_plain_ref(L, inp, reverse, got)
    torch.cuda.synchronize()
    units, err = {}, 0.0
    for n, a, b in zip(LSTM_OUTS + tuple(f"{n} (no stash)"
                                          for n in LSTM_OUTS[:3]),
                       list(got) + list(bwd) + list(lean),
                       list(ref) + list(rb) + list(ref[:3])):
        if a is None:
            continue
        units[n] = L.error_in_tolerances(a, b, dtype)
        err = max(err, (a.float() - b.float()).abs().max().item())
    return units, err


def lstm_same_bits(torch, L, T, B, H, dtype, masked, reverse, seed):
    """The forward and backward kernels, and the forward without the
    stash, run twice on the same inputs must give the same bits (sums in
    a fixed order, no atomics)."""
    inp = lstm_inputs(torch, T, B, H, dtype, seed, masked)
    runs = []
    for _ in range(2):
        got, bwd = lstm_run(L, inp, reverse)
        runs.append(list(got) + list(bwd)
                    + list(lstm_fwd_no_stash(L, inp, reverse)))
    torch.cuda.synchronize()
    names = LSTM_OUTS + tuple(f"{n} (no stash)" for n in LSTM_OUTS[:3])
    for n, a, b in zip(names, *runs):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"LSTM {n} differs between two runs at "
                                 f"T={T} B={B} H={H} {dtype}")


def lstm_mirror_units(torch, L, T, B, H, masked, seed):
    """The bf16 forward (with its stash and without) and the backward on
    its stash, on inputs whose rows 8-15 of every 16 repeat rows 0-7 (xw,
    h0, c0, the mask and the cotangents dh, dhT, dcT): the repeated rows
    must come out bit-identical, since every row's sums run in one order.
    In the cooperative kernels at B <= 64 the two warpgroups split K and
    each finishes one of the two rows of such a pair from both partials,
    so a warpgroup that adds them in its own order shows here, not
    against the tolerance. Also held to the plain versions: {output:
    error in tolerances, "mirror bits": 0, or inf when a pair
    differs}."""
    inp = lstm_inputs(torch, T, B, H, torch.bfloat16, seed, masked)
    src = torch.arange(B, device="cuda")
    src = torch.where(src % 16 >= 8, src - 8, src)
    inp["xw"], inp["dh"] = (inp[k][:, src].contiguous() for k in ("xw", "dh"))
    for k in ("h0", "c0", "dhT", "dcT"):
        inp[k] = inp[k][src].contiguous()
    if masked:
        inp["mask"] = inp["mask"][:, src].contiguous()
    got, bwd = lstm_run(L, inp, False)
    lean = lstm_fwd_no_stash(L, inp, False)
    ref, rb = lstm_plain_ref(L, inp, False, got)
    torch.cuda.synchronize()
    units = {n: L.error_in_tolerances(a, b, torch.bfloat16)
             for n, a, b in zip(LSTM_OUTS, list(got) + list(bwd),
                                list(ref) + list(rb)) if a is not None}
    same = True
    for t in list(got) + list(bwd) + list(lean):
        if t is not None:
            rows = t if t.dim() == 2 else t.transpose(0, 1)  # (B, ...)
            same &= torch.equal(rows, rows[src])
    units["mirror bits"] = 0.0 if same else math.inf
    return units


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
    both bf16 forward routes; the cooperative forward's widest batch
    (B=128) beside the cluster forward's narrowest (B=129); and its small
    batches (`lstm_coop_cases`)."""
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
    cases += [(T, B, H, bf, masked, reverse)
              for T, B, H, masked, reverse in lstm_coop_cases()]
    return cases


def lstm_coop_cases():
    """(T, B, H, masked, reverse) of the cooperative bf16 kernels' small
    batches: B = 1, 31, 32, 33 (the warpgroups split K at 64 rows or
    fewer; 31 and 33 are ragged in the 8-row boxes and the 16-row warp
    tiles), 100 and 128 (each warpgroup its own rows), at H = 1024 (the
    forward's 128 blocks of 8 units in clusters of 2, the backward's 64
    of 16 in clusters of 8) and the ragged 196 (padded to 200: 25 forward
    blocks padded to 32, 13 backward blocks, the last half idle, padded
    to 16), masked and not, forward and reverse; T = 20 walks the h
    ping-pong, the xw buffers and the backward's dz ring many times."""
    return [(20, B, H, masked, reverse) for H in (1024, 196)
            for B in (1, 31, 32, 33, 100, 128) for masked in (False, True)
            for reverse in (False, True)]


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
    bf = torch.bfloat16
    for T, B, H, masked, reverse in lstm_coop_cases():
        L.reset_counts()
        lstm_same_bits(torch, L, T, B, H, bf, masked, reverse, seed=41)
        if set(r for _, r in L.launches_by_route) != {"cooperative"}:
            raise AssertionError(f"B={B} H={H}: launches by route "
                                 f"{L.launches_by_route}, all expected on "
                                 "'cooperative' (forward and backward)")
    log(f"  bf16 cooperative forward and backward: bits identical on rerun "
        f"(the forward with and without the stash, the backward on its "
        f"stash) and every launch of both on 'cooperative' at B = 1, 31, "
        f"32, 33, 100, 128, H = 1024 and 196, masked and not, forward and "
        f"reverse ({len(lstm_coop_cases())} cases)")
    for B in (64, 128):
        for masked in (False, True):
            units = lstm_mirror_units(torch, L, 50, B, 1024, masked, seed=43)
            worst = max(units.values())
            log(f"  bf16 cooperative forward and backward, rows 8-15 of "
                f"every 16 "
                f"repeating rows 0-7, T=50 B={B} H=1024 "
                f"{'masked' if masked else 'plain'}: repeated rows "
                f"{'bit-identical' if units['mirror bits'] == 0 else 'DIFFER'}"
                f", worst {worst:.3f} of tolerance "
                f"{'ok' if worst <= 1 else 'FAIL'}")
            if worst > 1:
                raise AssertionError(f"LSTM mirrored rows: {units}")
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
                  lr=0.1, algo=None, iterations=1):
    """bench.py's char-RNN (`_lstm_train_bench`, bench.py:311-320):
    GravesLSTM -> GravesLSTM -> RnnOutputLayer(MCXENT, softmax), RMSPROP
    lr 0.1; `algo` a line-search optimization algorithm instead of SGD,
    `iterations` its iterations a batch."""
    C, A, LF = M["conf"], M["Activation"], M["LossFunction"]
    first = C.GravesBidirectionalLSTM if bidirectional else C.GravesLSTM
    b = C.NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
    if algo is not None:
        b = b.optimization_algo(algo).iterations(iterations)
    b = (b.updater("rmsprop").list()
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
    return launches, med


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


def phase_lstm_4s(torch, M, card):
    """Main path 4s: bench.py's lstm_large char-RNN at full width (vocab
    256, two GravesLSTM(1024), RMSPROP lr 0.1, bf16 compute over f32
    masters) fed the mini-batches of Deeplearning4j's
    GravesLSTMCharModellingExample: B=32 sequences of T=1000, tBPTT 50,
    one-hot rows as features (path 4b's reason). A warm-up fit, then
    `LSTM_4S_FITS` timed fits (the median wall and the spread), the first
    of them counted (20 windows: 40 unmasked forward launches and 40
    backward, all on "cooperative", nothing masked, no plain call), one
    `output` of the batch from the network (in its f32 masters, as the
    JAX package's `output` runs: 2 forward launches without the stash on
    "tf32 clusters") and one from a bf16 copy of it (`dtype=bfloat16`, the
    same weights: 2 on "cooperative"), and a traced fit. Returns the
    launch counts of the fit and of the bf16 output."""
    import numpy as np

    L = M["lstm"]
    V, H, B, T, W = (LSTM_4S[k] for k in ("vocab", "hidden", "B", "T",
                                           "tbptt"))
    net = M["MultiLayerNetwork"](char_rnn_conf(M, V, H, seed=1, tbptt=W),
                                 dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device="cuda")
    net.init()
    (x0, y0), (x1, y1) = one_hot_batches(np, V, B, T, 2, 4)
    net.fit(M["DataSet"](x0, y0))   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L.reset_counts()
    walls, fit = [], None
    for _ in range(LSTM_4S_FITS):
        t0 = time.perf_counter()
        net.fit(M["DataSet"](x1, y1))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        fit = fit or (dict(L.launches), dict(L.launches_by_route),
                      (L.lstm_fwd_plain.calls, L.lstm_bwd_plain.calls))
    wall = sorted(walls)[len(walls) // 2]
    peak = torch.cuda.max_memory_allocated()
    loss = net.score_value
    outs, inf = [], []
    lean = M["MultiLayerNetwork"](char_rnn_conf(M, V, H, seed=1, tbptt=W),
                                  dtype=torch.bfloat16, device="cuda")
    lean.init()
    lean.set_params(net.params())
    for model in (net, lean):
        L.reset_counts()
        outs.append(model.output(x1))
        torch.cuda.synchronize()
        inf.append((dict(L.launches), dict(L.launches_by_route),
                    (L.lstm_fwd_plain.calls, L.lstm_bwd_plain.calls)))
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    trace = traced(torch, lambda: net.fit(M["DataSet"](x0, y0)))
    n_win = -(-T // W)
    log(f"  {len(walls)} fits of B={B} x T={T} (H={H}, vocab {V}) in "
        f"{n_win} windows of {W}: wall median {1e3 * wall:.2f} ms (min "
        f"{1e3 * min(walls):.2f}, max {1e3 * max(walls):.2f}; "
        f"{[round(1e3 * w, 2) for w in walls]}), {B / wall:.1f} samples/s "
        f"at the median, loss {loss}, peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes) [{card}]")
    log(f"  LSTM launches over the first timed fit {fit[0]}, by route "
        f"{fit[1]}, plain calls {fit[2]}")
    for name, o, (launches, routes, plain) in zip(("f32 masters", "bf16 copy"),
                                                  outs, inf):
        log(f"  output ({name}) {tuple(o.shape)} {str(o.dtype)[6:]}: "
            f"launches {launches}, by route {routes}, plain calls {plain}")
    log(f"  outputs finite: {finite}")
    log(f"  traced fit (torch.profiler, not in the wall time): {trace}")
    n = 2 * n_win
    want = ({("fwd", False, False): n, ("bwd", False, False): n},
            {("fwd", "cooperative"): n, ("bwd", "cooperative"): n}, (0, 0))
    want_out = [({("fwd", False, False): 2}, {("fwd", route): 2}, (0, 0))
                for route in ("tf32 clusters", "cooperative")]
    if fit != want or inf != want_out or not np.isfinite(loss) \
            or not finite or any(tuple(o.shape) != (B, T, V) for o in outs):
        raise AssertionError(f"expected {want} in the fit and {want_out} in "
                             f"the outputs, a finite loss and finite outputs "
                             f"of shape {(B, T, V)}: {fit}, {inf}, {loss}, "
                             f"{finite}, {[tuple(o.shape) for o in outs]}")
    del net, lean
    torch.cuda.empty_cache()
    return {"fit": fit[0], "output": inf[1][0]}


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
    window of T=24, B=8192, H=256; path 4s the unmasked ones at a window
    of T=50, B=32, H=1024 (the cooperative forward, with the stash in
    `fit` and without it in `output`, and the cooperative backward; their
    launch counts are filled in by `lstm_4s_launches` once phase 19 has
    run). Then the
    two bf16 routes of each pass at their boundary (T=64, H=1024: the
    cooperative kernels at B=128, the forward with and without the stash,
    both masked and not, the cluster kernels at B=129, and the cluster
    forward at 256), and the f32 kernels (split
    TF32) at T=8, B=2048, H=1024, at path 4f's shape (T=64, with its
    launch counts) and masked at path 4b's window; last bench_lstm's full
    sequence (T=64, B=8192, H=256: path 13c-13e's shape, their launch
    counts added by `par_launches` once phase 38 has run). The cooperative rows
    print the replaced kernel's time beside theirs, where PERF.md has it
    (`LSTM_COOP_MMA_MS`, `LSTM_BWD_CLUSTER_MS`). An f32 row on the split-TF32 route is
    bound by its three TF32 passes (3 x flops / 495 TFLOP/s) or its
    bytes; the f32-FMA bound (flops / 67 TFLOP/s) is logged beside it.
    Every row's outputs are held to the plain versions first, as in phase
    11 (`lstm.error_in_tolerances`). Path 4e's launch counts are added to
    the rows at its shape by `lstm_4e_launches` once phase 20 has run."""
    shapes = [(64, 2048, 1024, False, counts4, torch.bfloat16),
              (LSTM_SMALL["tbptt"], 8192, 256, False, counts4b,
               torch.bfloat16),
              (LSTM_SMALL["tbptt"], 8192, 256, True, counts4b,
               torch.bfloat16),
              (LSTM_4S["tbptt"], LSTM_4S["B"], LSTM_4S["hidden"], False,
               {}, torch.bfloat16),
              (64, 128, 1024, False, {}, torch.bfloat16),
              (64, 128, 1024, True, {}, torch.bfloat16),
              (64, 129, 1024, False, {}, torch.bfloat16),
              (64, 256, 1024, False, {}, torch.bfloat16),
              (8, 2048, 1024, False, {}, torch.float32),
              (64, 2048, 1024, False, counts4f, torch.float32),
              (LSTM_SMALL["tbptt"], 8192, 256, True, {}, torch.float32),
              (PAR_LSTM["T"], PAR_LSTM["B"], PAR_LSTM["hidden"], False, {},
               torch.bfloat16),
              (ETL["T"], ETL["B"], ETL["hidden"], True, {}, torch.bfloat16)]
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
        del rb
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
        kinds = ("fwd", "bwd") if B in (2048, 8192, LSTM_4S["B"], ETL["B"],
                                        128, 129) else ("fwd",)
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
                f"{lstm_plan_line(L, torch, kind, B, H, dt, masked)}"
                + lstm_mma_note((T, B, masked, True), kind))
            rows.append(row)
        if B <= 129 and not masked:  # inference: no stash
            rows.append(lstm_nostash_row(torch, L, inp, T, B, H,
                                         yard[(T, B, H, False)][0]))
        del inp, got, bwd, ref
        torch.cuda.empty_cache()
    T, B, H = (LSTM_4S[k] for k in ("T", "B", "hidden"))
    inp = lstm_inputs(torch, T, B, H, torch.bfloat16, 77, False)
    rows.append(lstm_nostash_row(torch, L, inp, T, B, H,
                                 cudnn_lstm_ms(torch, T, B, H)[0]))
    # path 16's f32 answers (`output` on the imported model: the card
    # against the CPU, the serve route)
    T, B, H = ETL["T"], ETL["serve_B"], ETL["hidden"]
    inp = lstm_inputs(torch, T, B, H, torch.float32, 77, False)
    rows.append(lstm_nostash_row(torch, L, inp, T, B, H,
                                 cudnn_lstm_ms(torch, T, B, H, True)[0],
                                 torch.float32))
    return rows


def lstm_nostash_row(torch, L, inp, T, B, H, library_ms,
                     dt=None):
    """The forward without the training stash (inference; bf16 unless
    `dt`) on an unmasked case: held to the plain version
    (`lstm.error_in_tolerances`), then timed beside it; the row of the
    kernels line. An f32 row (split TF32) is bound by its three TF32
    passes or its bytes."""
    dt = dt or torch.bfloat16
    lean = lstm_fwd_no_stash(L, inp, False)
    ref = L.lstm_fwd_plain(inp["xw"], inp["rw"], inp["peep"], inp["h0"],
                           inp["c0"], with_stash=False)[:3]
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(lean, ref) if a is not None)
    units = max(L.error_in_tolerances(a, b, dt)
                for a, b in zip(lean, ref) if a is not None)
    if units > 1:
        raise AssertionError(f"LSTM forward without the stash disagrees "
                             f"with plain at T={T} B={B} H={H}: {units}")
    ms = time_ms(torch, lambda: L.lstm_fwd(
        inp["xw"], inp["rw"], inp["peep"], inp["h0"], inp["c0"],
        with_stash=False))
    plain_ms = time_ms(torch, lambda: L.lstm_fwd_plain(
        inp["xw"], inp["rw"], inp["peep"], inp["h0"], inp["c0"],
        with_stash=False), iters=5, warmup=1)
    f32 = dt == torch.float32
    flops, nbytes = lstm_work("fwd", False, T, B, H, 4 if f32 else 2,
                              stash=False)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    if f32:
        t_ops = 3 * flops / PEAK_TF32_FLOPS
    row = {"name": f"lstm_fwd_nostash{'_f32' if f32 else ''}_t{T}_b{B}_h{H}",
           "route": "cuda",
           "source": LSTM_SOURCE, "replaces": LSTM_REPLACES[("fwd", False)],
           "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "library_ms": library_ms}
    log(f"  {row['name']} (inference): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, cuDNN LSTM {library_ms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), worst {units:.3f} "
        f"of tolerance [{L.plan('fwd', dt, False, B, H).route}]"
        + ("" if f32 else lstm_mma_note((T, B, False, False), "fwd")))
    return row


def lstm_4s_launches(rows, counts) -> None:
    """Path 4s's launch counts into the timing rows at the shapes that made
    them: phase 19's `fit` (the window, T=50) and its bf16 `output` (the
    whole sequence, T=1000, without the stash)."""
    B, H = LSTM_4S["B"], LSTM_4S["hidden"]
    for name, run, key in (
            (f"lstm_fwd_t{LSTM_4S['tbptt']}_b{B}_h{H}", "fit", "fwd"),
            (f"lstm_bwd_t{LSTM_4S['tbptt']}_b{B}_h{H}", "fit", "bwd"),
            (f"lstm_fwd_nostash_t{LSTM_4S['T']}_b{B}_h{H}", "output", "fwd")):
        for row in rows:
            if row["name"] == name:
                row["launches"] = int(counts[run].get((key, False, False), 0))


# path 4e: lstm_large through the Deeplearning4j training loop, fed f32
# one-hot rows as GravesLSTMCharModellingExample's CharacterIterator yields
# them: 6 batches, 4 fit steps (the third batch poisoned), 1 for the
# guarded / unguarded step pairs, 1 held out for evaluate
LSTM_4E = dict(vocab=256, hidden=1024, B=2048, T=64, batches=6, seed=20)
LSTM_4E_POISONED = 2   # index of the fit batch that carries a NaN
LSTM_4E_PAIRS = 3      # guarded / unguarded step pairs from equal states
LSTM_4E_LBFGS = 3      # LBFGS iterations on one batch


class StepRecorder:
    """An iteration listener: the score at every iteration and copies of
    the parameters and the optimizer state at the iterations asked for."""

    def __init__(self, snap_at):
        self.snap_at = set(snap_at)
        self.scores, self.snaps = [], {}

    def iteration_done(self, model, iteration):
        self.scores.append(model.score_value)
        if iteration in self.snap_at:
            self.snaps[iteration] = train_state(model, copy=True)


def train_state(net, copy=False):
    """(parameters, optimizer state) of a network, cloned with `copy`."""
    c = (lambda t: t.clone()) if copy else (lambda t: t)
    return ([{k: c(v) for k, v in p.items()} for p in net._params],
            [{k: {sk: c(t) for sk, t in st.items()} for k, st in u.items()}
             for u in net.get_updater_state()])


def same_state(torch, a, b) -> bool:
    """Bit-identical parameters and optimizer state."""
    (pa, ua), (pb, ub) = a, b
    return (all(torch.equal(x[k], y[k]) for x, y in zip(pa, pb) for k in x)
            and all(torch.equal(x[k][sk], y[k][sk])
                    for x, y in zip(ua, ub) for k in x for sk in x[k]))


def launch_counts(L):
    return (dict(L.launches), dict(L.launches_by_route),
            (L.lstm_fwd_plain.calls, L.lstm_bwd_plain.calls))


def lstm_4e_data(np, DataSet):
    """Path 4e's batches: seeded ids as f32 one-hot DataSets, merged,
    shuffled and split (`DataSet.merge`, `shuffle`,
    `split_test_and_train`, `batch_by`): (fit batches, the pairs' batch,
    the held-out batch); one row of one fit batch carries a NaN."""
    V, B, T, n, seed = (LSTM_4E[k] for k in ("vocab", "B", "T", "batches",
                                             "seed"))
    ids = np.random.default_rng(seed).integers(0, V, (n * B, T + 1))
    eye = np.eye(V, dtype=np.float32)
    data = DataSet.merge([DataSet(eye[ids[i * B:(i + 1) * B, :-1]],
                                  ids[i * B:(i + 1) * B, 1:].astype(np.int32))
                          for i in range(n)])
    data.shuffle(seed)
    train, held = data.split_test_and_train((n - 1) * B)
    batches = train.batch_by(B)
    bad = batches[LSTM_4E_POISONED]
    bad.features = bad.features.copy()
    bad.features[7, 11, 3] = np.nan
    return batches[:-1], batches[-1], held


def phase_lstm_4e(torch, M, card, step4_ms):
    """Path 4e: bench.py's lstm_large at full width (bf16 compute over f32
    masters, RMSPROP) through the training loop a Deeplearning4j user
    writes: `fit(AsyncDataSetIterator(ListDataSetIterator(batches)))` with
    a `HealthSentinel` and `ScoreIterationListener`, `PerformanceListener`
    and `CheckpointListener(every 2, keep_last=2)` attached, one NaN in one
    row of the third batch; then `evaluate` on the held-out batch, the
    newest verified checkpoint restored with `restore_model`, guarded
    against unguarded steps, and LBFGS on a second network. Raises on any
    failed check; returns the launch counts of the fit, evaluate and the
    solver."""
    import tempfile

    import numpy as np

    L = M["lstm"]
    V, H, B, T = (LSTM_4E[k] for k in ("vocab", "hidden", "B", "T"))
    fit_batches, spare, held = lstm_4e_data(np, M["DataSet"])
    bad_it = LSTM_4E_POISONED + 1
    net = M["MultiLayerNetwork"](char_rnn_conf(M, V, H, seed=1),
                                 dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device="cuda")
    net.init()
    sentinel = M["HealthSentinel"]()
    net.set_health_sentinel(sentinel)
    tmp = tempfile.mkdtemp(prefix="path4e_")
    try:
        ckpt_dir = os.path.join(tmp, "ckpt")
        rec = StepRecorder((bad_it - 1, bad_it, len(fit_batches)))
        perf = M["PerformanceListener"](1)
        net.set_listeners(M["ScoreIterationListener"](1), perf,
                          M["CheckpointListener"](ckpt_dir,
                                                  every_n_iterations=2,
                                                  keep_last=2), rec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        L.reset_counts()
        t0 = time.perf_counter()
        net.fit(M["AsyncDataSetIterator"](
            M["ListDataSetIterator"](fit_batches), queue_size=2))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit = launch_counts(L)
        counters = sentinel.counters()
        skipped = same_state(torch, rec.snaps[bad_it - 1], rec.snaps[bad_it])
        log(f"  fit of {len(fit_batches)} batches of B={B} x T={T} (f32 "
            f"one-hot rows, vocab {V}, H={H}, bf16 compute) with the "
            f"sentinel and three listeners: {1e3 * fit_s:.2f} ms (two "
            f"checkpoint saves included); scores {rec.scores}; sentinel "
            f"{counters}; the poisoned step (iteration {bad_it}) left "
            f"params and RMSPROP state bit-identical: {skipped}; "
            f"PerformanceListener {perf.last_samples_per_sec:.1f} samples/s "
            f"[{card}]")
        log(f"  LSTM launches over the fit {fit[0]}, by route {fit[1]}, "
            f"plain calls {fit[2]}")
        n = 2 * len(fit_batches)
        want = ({("fwd", False, False): n, ("bwd", False, False): n},
                {("fwd", "bf16 clusters"): n, ("bwd", "bf16 clusters"): n},
                (0, 0))
        finite = [np.isfinite(v) for v in rec.scores]
        if (fit != want or not skipped or net.iteration != len(fit_batches)
                or counters["skips"] != 1
                or counters["steps"] != len(fit_batches)
                or finite != [i + 1 != bad_it for i in range(len(finite))]):
            raise AssertionError(
                f"path 4e fit: expected launches {want}, one skip at "
                f"iteration {bad_it} that leaves the state bit-identical, "
                f"iteration {len(fit_batches)} and every other score "
                f"finite; got {fit}, skipped state equal {skipped}, "
                f"iteration {net.iteration}, {counters}, {rec.scores}")

        L.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = net.evaluate(held)
        eval_s = time.perf_counter() - t0
        ev_counts = launch_counts(L)
        out = net.output(held.features)
        again = net.output(held.features)
        d2h = out.numel() * out.element_size()
        pred = out.float().cpu().numpy().argmax(-1)
        cm = np.zeros((V, V), np.int64)
        np.add.at(cm, (held.labels.reshape(-1), pred.reshape(-1)), 1)
        reruns_equal = torch.equal(out, again)
        del out, again
        log(f"  evaluate of the held-out batch: {1e3 * eval_s:.2f} ms wall, "
            f"{d2h} bytes device-to-host (the (B, T, vocab) f32 output), "
            f"accuracy {ev.accuracy():.6f}, confusion total "
            f"{int(ev.confusion_matrix.sum())}; launches {ev_counts[0]}, by "
            f"route {ev_counts[1]}, plain calls {ev_counts[2]}; two outputs "
            f"bit-identical: {reruns_equal}")
        want_ev = ({("fwd", False, False): 2}, {("fwd", "tf32 clusters"): 2},
                   (0, 0))
        if (not np.array_equal(ev.confusion_matrix, cm)
                or int(cm.sum()) != B * T or ev_counts != want_ev):
            raise AssertionError(
                f"path 4e evaluate: the confusion matrix must equal numpy's "
                f"from the card's output (total {B * T}) with launches "
                f"{want_ev}; equal {np.array_equal(ev.confusion_matrix, cm)}"
                f", total {int(cm.sum())}, launches {ev_counts}")

        store = M["CheckpointStore"](ckpt_dir, keep_last=2)
        t0 = time.perf_counter()
        back, step = store.load_latest_verified(
            lambda p: M["restore_model"](p, device="cuda"))
        restore_s = time.perf_counter() - t0
        restored = same_state(torch, rec.snaps[step], train_state(back))
        ev_back = back.evaluate(held)
        log(f"  restore_model of the newest verified checkpoint (steps "
            f"{store.steps()}): step {step} in {1e3 * restore_s:.2f} ms, "
            f"params and RMSPROP state equal to that step's: {restored}; "
            f"its evaluate gives the same confusion matrix: "
            f"{np.array_equal(ev_back.confusion_matrix, ev.confusion_matrix)}")
        if (step != len(fit_batches) or store.steps() != [2, 4]
                or not restored or back.iteration != step
                or not np.array_equal(ev_back.confusion_matrix,
                                      ev.confusion_matrix)):
            raise AssertionError(
                f"path 4e restore: step {step} of {store.steps()}, state "
                f"equal {restored}, iteration {back.iteration}")
        del back

        net.set_listeners()
        pairs, ms = [], {"guarded": [], "unguarded": []}
        L.reset_counts()
        for i in range(LSTM_4E_PAIRS):
            ref = net.clone()  # no sentinel: the unguarded step
            runs = [("unguarded", ref), ("guarded", net)]
            for what, model in (runs if i % 2 == 0 else runs[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.fit(spare)
                torch.cuda.synchronize()
                ms[what].append(1e3 * (time.perf_counter() - t0))
            pairs.append(same_state(torch, train_state(ref),
                                    train_state(net)))
            del ref
        pair_counts = launch_counts(L)
        med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
        h2d = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f, lab, fm, lm = net._batch_arrays(spare)
            torch.cuda.synchronize()
            h2d.append(1e3 * (time.perf_counter() - t0))
        h2d_bytes = spare.features.nbytes + spare.labels.nbytes
        loss, grads, _ = net._loss_and_grads(f, lab, fm, lm)
        health = net._health(loss, grads).cpu().numpy()
        norm = float(torch.linalg.vector_norm(torch.cat(
            [g[k].reshape(-1) for g in grads for k in sorted(g)])))
        # gradients of known values at the step's shapes: every leaf 0.5
        # (the norm is exact), then one NaN in the first layer's
        probe = [{k: torch.full_like(v, 0.5) for k, v in g.items()}
                 for g in grads]
        n_el = sum(v.numel() for g in probe for v in g.values())
        even = net._health(loss, probe).cpu().numpy()
        probe[0][sorted(probe[0])[0]].view(-1)[0] = float("nan")
        poisoned = net._health(loss, probe).cpu().numpy()
        del probe
        guard_ms = time_ms(torch, lambda: net._health(loss, grads).cpu())
        guard_host = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net._health(loss, grads).cpu()
            guard_host.append(1e3 * (time.perf_counter() - t0))
        guard_host = sorted(guard_host)[5]
        del f, lab, loss, grads
        log(f"  guarded step (commit) vs unguarded step from the same state "
            f"on the same batch, {LSTM_4E_PAIRS} pairs in turns: "
            f"bit-identical {pairs}; guarded ms {ms['guarded']}, median "
            f"{med['guarded']:.2f} = {B / med['guarded'] * 1e3:.1f} "
            f"samples/s; unguarded ms {ms['unguarded']}, median "
            f"{med['unguarded']:.2f}; phase 13's path 4 step (uint8 ids "
            f"through the OneHotEncoder) {step4_ms:.2f} ms; launches "
            f"{pair_counts[0]} [{card}]")
        log(f"  the batch's host-to-device transfer (`_batch_arrays`: "
            f"{h2d_bytes} bytes of f32 one-hot rows and int32 labels from "
            f"pageable memory): {[round(t, 2) for t in h2d]} ms")
        log(f"  the guard alone (the global norm, the (loss, grad_norm, ok) "
            f"vector and its one device-to-host read): device "
            f"{guard_ms:.4f} ms, host wall {guard_host:.4f} ms; grad_norm "
            f"{health[1]!r} against torch.linalg.vector_norm {norm!r}")
        log(f"  the guard on gradients of 0.5: {even!r} (norm "
            f"{0.5 * math.sqrt(n_el)!r}); with one NaN in the first layer's: "
            f"{poisoned!r}")
        if (not all(pairs) or health[2] != 1.0
                or abs(health[1] - norm) > 1e-4 * norm
                or abs(even[1] - 0.5 * math.sqrt(n_el)) > 1e-6 * even[1]
                or even[2] != 1.0 or poisoned[2] != 0.0):
            raise AssertionError(
                f"path 4e guard: committed guarded steps must equal "
                f"unguarded ones bit for bit ({pairs}), the health vector "
                f"must hold the gradient norm ({health} vs {norm}; "
                f"{even} vs {0.5 * math.sqrt(n_el)}) and see a NaN in any "
                f"layer ({poisoned})")

        timed = M["CheckpointStore"](os.path.join(tmp, "timed"), keep_last=1)
        save_ms = []
        for i in range(2):
            t0 = time.perf_counter()
            path = timed.save(i, lambda p: M["write_model"](net, p,
                                                            atomic=False))
            save_ms.append(1e3 * (time.perf_counter() - t0))
        n_state = sum(t.numel() * t.element_size() for t in
                      [v for p in net._params for v in p.values()]
                      + [t for u in net.get_updater_state()
                         for st in u.values() for t in st.values()])
        log(f"  checkpoint save (CheckpointStore.save of write_model: zip, "
            f"fsync, manifest): {[round(t, 2) for t in save_ms]} ms for "
            f"{n_state} bytes of params and RMSPROP state, "
            f"{os.path.getsize(path)} bytes on disk")
        trace = traced(torch, lambda: net.fit(spare))
        peak = torch.cuda.max_memory_allocated()
        log(f"  traced guarded step (torch.profiler): {trace}")
        log(f"  peak device memory over fit, evaluate, restore and the "
            f"pairs {peak / 2**30:.2f} GiB ({peak} bytes)")
        del net
        torch.cuda.empty_cache()

        snet = M["MultiLayerNetwork"](
            char_rnn_conf(M, V, H, seed=1, algo="lbfgs",
                          iterations=LSTM_4E_LBFGS),
            dtype=torch.float32, compute_dtype=torch.bfloat16, device="cuda")
        snet.init()
        first = snet.score(fit_batches[0])
        torch.cuda.reset_peak_memory_stats()
        L.reset_counts()
        t0 = time.perf_counter()
        snet.fit(fit_batches[0])
        torch.cuda.synchronize()
        lbfgs_s = time.perf_counter() - t0
        solver = launch_counts(L)
        last = snet.score_value
        speak = torch.cuda.max_memory_allocated()
        log(f"  LBFGS, {LSTM_4E_LBFGS} iterations on one batch: score "
            f"{first!r} -> {last!r}, {1e3 * lbfgs_s / LSTM_4E_LBFGS:.2f} ms "
            f"an iteration ({1e3 * lbfgs_s:.2f} ms), peak device memory "
            f"{speak / 2**30:.2f} GiB; launches {solver[0]}, by route "
            f"{solver[1]}, plain calls {solver[2]}")
        fwd = solver[0].get(("fwd", False, False), 0)
        bwd = solver[0].get(("bwd", False, False), 0)
        if (not np.isfinite(last) or not last < first or bwd < 2
                or fwd <= bwd or set(solver[0]) != {("fwd", False, False),
                                                    ("bwd", False, False)}
                or solver[1] != {("fwd", "bf16 clusters"): fwd,
                                 ("bwd", "bf16 clusters"): bwd}
                or any(solver[2])):
            raise AssertionError(
                f"path 4e LBFGS: the score must fall and stay finite "
                f"({first} -> {last}), with value-and-gradient and "
                f"value-only launches on \"bf16 clusters\" and no plain "
                f"call: {solver}")
        del snet
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"fit": fit[0], "evaluate": ev_counts[0], "solver": solver[0]}


def lstm_4e_launches(rows, counts) -> None:
    """Path 4e's launch counts added into the timing rows at its shape
    (T=64, B=2048, H=1024): the fit's and the solver's into the bf16 rows
    (the solver's value-only calls are forwards without the stash), and
    evaluate's into the f32 forward row (`output` runs the f32 masters)."""
    for name, key, runs in (
            ("lstm_fwd_t64_b2048_h1024", "fwd", ("fit", "solver")),
            ("lstm_bwd_t64_b2048_h1024", "bwd", ("fit", "solver")),
            ("lstm_fwd_f32_t64_b2048_h1024", "fwd", ("evaluate",))):
        for row in rows:
            if row["name"] == name:
                row["launches"] += sum(int(counts[r].get((key, False, False),
                                                         0)) for r in runs)


# ------------------------------------------------- path 5: ModelServer
def server_events(srv, kinds):
    """(kind, decision or state, monotonic t) of the server's flight
    recorder events of the given kinds, in order."""
    return [(e["kind"], e.get("decision", e.get("state")), e["t"])
            for e in srv.flight_record()["events"] if e["kind"] in kinds]


def timed_method(obj, name, into):
    """Wrap `obj.name` (on the instance) so each call adds its wall
    seconds to `into[name]`: a reading of where a reload's time goes."""
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            into[name] = into.get(name, 0.0) + time.perf_counter() - t0

    setattr(obj, name, wrapper)


def wait_for(pred, what, timeout=300.0):
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"path 5: timed out waiting for {what}")
        time.sleep(0.005)


def run_threads(fns, timeout=900.0):
    """Run each callable on its own thread; their results (or raised
    errors) in order."""
    import threading

    out = [None] * len(fns)

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # handed to the caller, which checks
            out[i] = e

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    return threads, out


def joined(threads, out, timeout=900.0):
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise AssertionError("path 5: a client thread did not finish")
    for r in out:
        if isinstance(r, BaseException):
            raise r
    return out


def phase_server(torch, M, card, path1_tok_s=None):
    """Path 5: path 1's network (the full-width 8-layer gpt_long GPT,
    bf16 compute over f32 masters) behind `ModelServer(max_batch_size=4,
    breaker_threshold=3, breaker_reset_timeout=1, generation=path 1's
    engine)`: concurrent predicts coalesced and held to `net.output` row
    by row, path 1's requests through `generate` with predicts beside
    them, a hot reload from a `CheckpointStore` under active decode, a
    poisoned candidate and a non-finite model refused, the breaker's
    ladder, a second server with int8 weights and the drift gate, the
    shutdown drain, metrics and the flight record. Raises on any failed
    check; returns the launch counts for the kernel rows."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    S = M["serving"]
    pa, fa = M["pa"], M["fa"]
    V = SERVE["vocab_size"]
    conf = M["gpt_configuration"](**SERVE, seed=11)
    net = M["MultiLayerNetwork"](conf, dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device="cuda")
    net.init()
    # the scheduler parks at its next decode step while `hold` is clear
    hold, parked = threading.Event(), threading.Event()
    hold.set()

    def park(phase, info):
        if phase == "pre_decode" and not hold.is_set():
            parked.set()
            if not hold.wait(300):
                raise TimeoutError("path 5: the scheduler was never released")

    srv = S.ModelServer(net, max_batch_size=4, breaker_threshold=3,
                        breaker_reset_timeout=1.0,
                        generation=dict(SERVER_GEN, step_hooks=[park]))
    prompts, n_tok = path1_requests(np)
    prng = np.random.default_rng(21)
    xs = [prng.integers(0, V, (1, SERVER_PREDICT_T)).astype(np.int32)
          for _ in range(SERVER_PREDICTS)]
    small = prng.integers(0, V, (1, SERVER_PROMPT_T[0])).astype(np.int32)
    tmp = tempfile.mkdtemp(prefix="path5_")
    closed = False
    t_phase = time.perf_counter()
    try:
        # warm-up: cuBLAS handles, the allocator, the engine; the first
        # served request donates the auto-canary
        srv.predict(xs[0])
        srv.generate(prompts[0][:16], 4)
        torch.cuda.synchronize()
        pa.reset_counts()
        fa.reset_counts()

        # -- predict: 8 concurrent requests of (1, 4096)
        b0 = srv.stats()["batches"]
        t0 = time.perf_counter()
        threads, out = run_threads([lambda x=x: srv.predict(x, timeout=600)
                                    for x in xs])
        preds = joined(threads, out)
        pred_wall = time.perf_counter() - t0
        steps = srv.stats()["batches"] - b0
        hist = srv.metrics.histogram("model_server_predict_latency_ms")
        log(f"  predict: {SERVER_PREDICTS} requests of (1, {SERVER_PREDICT_T}) "
            f"from {SERVER_PREDICTS} threads in {steps} device steps: wall "
            f"{1e3 * pred_wall:.2f} ms, {SERVER_PREDICTS / pred_wall:.2f} "
            f"rows/s ({SERVER_PREDICTS * SERVER_PREDICT_T / pred_wall:.1f} "
            f"tokens/s), server latency histogram p50 <= "
            f"{hist.quantile_bound(0.5)} ms, p99 <= "
            f"{hist.quantile_bound(0.99)} ms; output dtype "
            f"{preds[0].dtype} [{card}]")
        if steps >= SERVER_PREDICTS:
            raise AssertionError(f"path 5: {steps} device steps for "
                                 f"{SERVER_PREDICTS} predicts: no coalescing")
        for p in preds:
            if p.shape != (1, SERVER_PREDICT_T, V) or not np.isfinite(p).all():
                raise AssertionError(f"path 5: bad predict result {p.shape}")

        # -- generate: path 1's six requests, alone, then beside predicts
        t0 = time.perf_counter()
        threads, out = run_threads([lambda p=p, n=n: srv.generate(p, n)
                                    for p, n in zip(prompts, n_tok)])
        alone = joined(threads, out)
        gen_wall = time.perf_counter() - t0
        toks = int(sum(n_tok))
        side = f"; path 1's engine alone {path1_tok_s:.1f}" \
            if path1_tok_s else ""
        log(f"  generate: path 1's {len(prompts)} requests through "
            f"server.generate from {len(prompts)} threads: wall "
            f"{gen_wall:.4f} s, {toks / gen_wall:.1f} generated tokens/s"
            f"{side} [{card}]")
        pending = []
        t0 = time.perf_counter()
        gen_threads, gen_out = run_threads(
            [lambda p=p, n=n: srv.generate(p, n)
             for p, n in zip(prompts, n_tok)])
        pred_threads, pred_out = run_threads(
            [lambda x=x: srv.predict(x, timeout=600) for x in xs[:4]])
        while any(t.is_alive() for t in gen_threads):
            pending.append(srv.pending())
            time.sleep(0.01)
        mixed = joined(gen_threads, gen_out)
        mixed_wall = time.perf_counter() - t0
        joined(pred_threads, pred_out)
        log(f"  generate beside 4 predicts of (1, {SERVER_PREDICT_T}): wall "
            f"{mixed_wall:.4f} s, {toks / mixed_wall:.1f} generated tokens/s; "
            f"pending() up to {max(pending)}; the same tokens as alone: "
            f"{all(np.array_equal(a, b) for a, b in zip(alone, mixed))} "
            f"[{card}]")
        for o, n in zip(alone + mixed, n_tok + n_tok):
            if o.shape != (n,) or o.min() < 0 or o.max() >= V:
                raise AssertionError(f"path 5: bad tokens {o.shape} for n={n}")
        if max(pending) <= 0:
            raise AssertionError("path 5: pending() never counted a request")

        # one traced window of mixed traffic
        def window():
            joined(*run_threads(
                [lambda: srv.predict(xs[1], timeout=600),
                 lambda: srv.predict(xs[2], timeout=600),
                 lambda: srv.generate(prompts[0], 64),
                 lambda: srv.generate(prompts[1], 64)]))

        log(f"  traced window (2 predicts + 2 generates, torch.profiler): "
            f"{traced(torch, window)}")
        paged_bf16 = dict(pa.paged_attention.launches_by)

        # -- reload under active decode
        cand = net.clone()
        with torch.no_grad():
            cand._params[-1]["b"][SERVER_FAVOURED] += SERVER_BIAS
        store = M["CheckpointStore"](os.path.join(tmp, "store"))
        t0 = time.perf_counter()
        store.save(1, lambda p: M["write_model"](cand, p, save_updater=False,
                                                 atomic=False))
        save_s = time.perf_counter() - t0
        size = os.path.getsize(store.path_for(1))
        del cand
        torch.cuda.empty_cache()
        firsts = [threading.Event() for _ in range(2)]
        infl_threads, infl_out = run_threads(
            [lambda i=i: srv.generate(
                prompts[4 + i], SERVER_INFLIGHT_TOKENS,
                on_token=lambda c, t, e, i=i: firsts[i].set())
             for i in range(2)])
        wait_for(lambda: all(f.is_set() for f in firsts),
                 "the in-flight requests' first tokens")
        hold.clear()
        wait_for(parked.is_set, "the scheduler to park")
        q_threads, q_out = run_threads(
            [lambda i=i: srv.generate(prompts[i], SERVER_QUEUED_TOKENS)
             for i in range(2)])
        wait_for(lambda: srv.pending() == 4, "two in flight and two queued")
        engine = srv._engine
        parts: dict = {}
        timed_method(srv, "_load_candidate", parts)
        timed_method(srv, "_validate_candidate", parts)
        timed_method(engine, "_build", parts)
        t0 = time.perf_counter()
        r_threads, r_out = run_threads([lambda: srv.reload(store)])
        wait_for(lambda: engine._draining, "the engine to drain")
        hold.set()
        (version,) = joined(r_threads, r_out)
        reload_s = time.perf_counter() - t0
        inflight = joined(infl_threads, infl_out)
        queued = joined(q_threads, q_out)
        ev = server_events(srv, ("drain", "swap", "reload", "retire"))
        t_drain = next(t for k, _, t in ev if k == "drain")
        t_swap = next(t for k, d, t in ev if k == "swap")
        retired = sum(1 for k, _, t in ev if k == "retire"
                      and t_drain < t < t_swap)
        order = [(k, d) for k, d, _ in ev if k != "retire"]
        cdt = srv.net.compute_dtype
        later_pred = srv.predict(xs[3], timeout=600)
        later_gen = srv.generate(prompts[2], 16)
        fav = SERVER_FAVOURED
        # greedy: the earlier run's tokens are a prefix of the longer one's
        same_old = [np.array_equal(o[:min(len(o), len(a))],
                                   a[:min(len(o), len(a))])
                    for o, a in zip(inflight, alone[4:])]
        log(f"  reload: candidate saved once ({size} bytes, "
            f"{1e3 * save_s:.2f} ms); reload wall {1e3 * reload_s:.2f} ms = "
            f"load and verify {1e3 * parts.get('_load_candidate', 0):.2f} "
            f"ms, canary {1e3 * parts.get('_validate_candidate', 0):.2f} ms, "
            f"drain wait "
            f"{1e3 * (t_swap - t_drain - parts.get('_build', 0)):.2f} ms, "
            f"swap {1e3 * parts.get('_build', 0):.2f} ms; model_version "
            f"{version}; "
            f"candidate compute dtype "
            f"{cdt if cdt is not None else 'float32 (none in the zip)'} "
            f"[{card}]")
        log(f"  reload: events {order}; {retired} retirements between drain "
            f"and swap; in-flight outputs (first 8) "
            f"{[list(o[:8]) for o in inflight]}, equal to their earlier run "
            f"on the old weights {same_old}; queued outputs "
            f"{[list(o[:8]) for o in queued]}")
        if version != 1 or srv.stats()["model_version"] != 1:
            raise AssertionError(f"path 5: model_version {version} after "
                                 "one reload")
        if order[:3] != [("drain", None), ("swap", "complete"),
                         ("reload", "complete")] or retired < 2:
            raise AssertionError(f"path 5: the swap did not wait for the "
                                 f"in-flight requests: {order}, {retired} "
                                 "retired between drain and swap")
        if any(len(o) != SERVER_INFLIGHT_TOKENS or (o == fav).all()
               or not same for o, same in zip(inflight, same_old)):
            raise AssertionError("path 5: an in-flight request did not "
                                 "finish on the old weights")
        if any(len(o) != SERVER_QUEUED_TOKENS or not (o == fav).all()
               for o in queued) or not (later_gen == fav).all() \
                or not (later_pred.argmax(-1) == fav).all():
            raise AssertionError("path 5: a queued or later request did not "
                                 "run on the candidate")

        # -- rejections: a poisoned candidate, a non-finite live model
        bad = M["MultiLayerNetwork"](conf, dtype=torch.float32, device="cuda")
        bad.init()
        bad.set_params(torch.full_like(bad.params(), float("nan")))
        t0 = time.perf_counter()
        store.save(2, lambda p: M["write_model"](bad, p, save_updater=False,
                                                 atomic=False))
        nan_save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            srv.reload(store)
            raise AssertionError("path 5: the poisoned candidate was "
                                 "swapped in")
        except S.ModelValidationError as e:
            refused = str(e)
        refuse_s = time.perf_counter() - t0
        still = srv.predict(small, timeout=600)
        nan_srv = S.ModelServer(bad, breaker_threshold=1)
        try:
            nan_srv.predict(small, timeout=600)
            raise AssertionError("path 5: non-finite outputs were served")
        except S.InferenceFailedError as e:
            screened = str(e)
        finally:
            nan_srv.shutdown()
        log(f"  rejections: NaN candidate (saved in {1e3 * nan_save_s:.2f} "
            f"ms) refused in {1e3 * refuse_s:.2f} ms: {refused[:90]}; "
            f"model_version {srv.stats()['model_version']}; a non-finite "
            f"live model's step failed: {screened[:70]}")
        if srv.stats()["model_version"] != 1 \
                or not (still.argmax(-1) == fav).all() \
                or "non-finite" not in screened \
                or nan_srv.breaker.state != "open":
            raise AssertionError("path 5: a rejection changed what serves")
        del bad
        torch.cuda.empty_cache()

        # -- the breaker: three failed steps open it
        fails = {"left": 3}

        def fail_step(phase, info):
            if phase == "pre_step" and fails["left"] > 0:
                fails["left"] -= 1
                raise RuntimeError("injected step failure")

        srv.infer_hooks.append(fail_step)
        states = []
        for _ in range(3):
            try:
                srv.predict(small, timeout=600)
                raise AssertionError("path 5: an injected failure served")
            except S.ServingError as e:
                states.append((type(e).__name__, srv.breaker.state))
        failed = "InferenceFailedError"
        if states != [(failed, "closed"), (failed, "closed"),
                      (failed, "open")]:
            raise AssertionError(f"path 5: breaker ladder {states}")
        st0 = srv.stats()
        t0 = time.perf_counter()
        try:
            srv.predict(small, timeout=600)
            raise AssertionError("path 5: the open breaker let a predict in")
        except S.ServiceUnavailableError:
            fast_ms = 1e3 * (time.perf_counter() - t0)
        try:
            srv.generate(prompts[0], 4)
            raise AssertionError("path 5: the open breaker let a generate in")
        except S.ServiceUnavailableError:
            pass
        st1 = srv.stats()
        wait_for(lambda: srv.breaker.state == "half_open", "half-open", 30)
        srv.predict(small, timeout=600)  # the probe
        srv.infer_hooks.remove(fail_step)
        log(f"  breaker: states after each failed step {states}; fast fail "
            f"{fast_ms:.3f} ms; device steps while open "
            f"{st1['batches'] - st0['batches']} (predict), "
            f"{st1['generation']['decode_steps'] - st0['generation']['decode_steps']}"
            f" (decode); after the probe {srv.breaker.state} [{card}]")
        if st1["batches"] != st0["batches"] \
                or st1["generation"]["decode_steps"] \
                != st0["generation"]["decode_steps"] \
                or srv.breaker.state != "closed":
            raise AssertionError(f"path 5: breaker ladder {states}, "
                                 f"{srv.breaker.state}")

        # -- quantized weights behind the drift gate
        eval_ids = prng.integers(0, V, SERVER_DRIFT_EVAL).astype(np.int32)
        t0 = time.perf_counter()
        qsrv = S.ModelServer(net, quantize={"weights": "int8"},
                             canary=eval_ids[:1],
                             drift_gate={"eval_set": eval_ids,
                                         "max_argmax_drift": 1.0,
                                         "max_ppl_delta": float("inf")})
        try:
            built_s = time.perf_counter() - t0
            report0 = qsrv.stats()["drift"]
            qsrv.reload(store, step=1)
            report1 = qsrv.stats()["drift"]
            qsrv._drift_gate["max_argmax_drift"] = \
                report1["argmax_drift"] - 1e-3  # below the measured drift
            try:
                qsrv.reload(store, step=1)
                raise AssertionError("path 5: the drift gate let a breach in")
            except S.ModelValidationError as e:
                gated = str(e)
            qst = qsrv.stats()
        finally:
            qsrv.shutdown()
        log(f"  int8 weights: built and gated in {1e3 * built_s:.2f} ms, "
            f"drift at construction {report0}, of the candidate {report1}; "
            f"with the gate below it: {gated[:80]}; model_version "
            f"{qst['model_version']}, drift checks {qst['drift_gate_checks']}"
            f", failures {qst['drift_gate_failures']} [{card}]")
        if qst["model_version"] != 1 or qst["drift_gate_checks"] != 3 \
                or qst["drift_gate_failures"] != 1 \
                or qst["weight_bits"] != 8:
            raise AssertionError(f"path 5: drift gate ladder {qst}")

        # -- shutdown: drains and closes; metrics and the flight record
        drained = srv.shutdown(drain_timeout=120)
        closed = True
        launches = dict(pa.paged_attention.launches_by)
        routes = dict(fa.launches_by_route)
        plain = (pa.paged_attention_plain.calls,
                 fa.flash_attention_plain_fwd.calls,
                 fa.flash_attention_plain_bwd.calls)
        text = srv.metrics_text()
        dump = srv.flight_record()
        kinds = {e["kind"] for e in dump["events"]}
        served = sum(1 for r in dump["requests"] if r["decision"] == "served")
        log(f"  shutdown drained: {drained}; paged launches {launches} "
            f"(before the reload {paged_bf16}); flash launches by route "
            f"{routes}; plain calls (paged, flash fwd, flash bwd) {plain}; "
            f"flight record: {served} served timelines, events {sorted(kinds)}")
        if not drained:
            raise AssertionError("path 5: shutdown did not drain")
        for name in ("dl4j_model_server_predict_latency_ms_count",
                     "dl4j_decode_engine_generate_latency_ms_count",
                     "dl4j_decode_engine_ttft_ms_count"):
            if name not in text:
                raise AssertionError(f"path 5: {name} not in metrics_text")
        if not served or not {"reload", "breaker", "drain", "swap"} <= kinds:
            raise AssertionError(f"path 5: flight record events {kinds}")
        try:
            srv.predict(small)
            raise AssertionError("path 5: a closed server served")
        except S.ServerClosedError:
            pass

        # -- each predict held to the network's output on its row alone
        errs = [float(np.abs(p - net.output(x).cpu().numpy()).max())
                for p, x in zip(preds, xs)]
        log(f"  predict vs net.output on each row alone: max abs err "
            f"{max(errs):.3e} (tolerance {SERVER_PREDICT_ATOL})")
        if max(errs) > SERVER_PREDICT_ATOL:
            raise AssertionError(f"path 5: predict differs from output by "
                                 f"{max(errs)}")
        # the path went through the kernels: the dense paged kernel at
        # C=1 and C=256, the f32 flash forward on its split-TF32 route
        # (`output` runs the f32 masters), no plain call
        if plain != (0, 0, 0):
            raise AssertionError(f"path 5: plain calls {plain}")
        if paged_bf16.get((1, "dense"), 0) == 0 \
                or paged_bf16.get((256, "dense"), 0) == 0 \
                or any(kind != "dense" for _, kind in launches):
            raise AssertionError(f"path 5: paged launches {paged_bf16}")
        if routes.get(("fwd", "tf32"), 0) == 0 \
                or set(routes) != {("fwd", "tf32")}:
            raise AssertionError(f"path 5: flash launches {routes}")
        log(f"  path 5 wall {time.perf_counter() - t_phase:.1f} s")
    finally:
        if not closed:
            hold.set()
            srv.shutdown(drain_timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    del srv, net
    torch.cuda.empty_cache()
    return {"paged": paged_bf16, "flash": routes}


def serve5_launches(rows, counts) -> None:
    """Path 5's launch counts into the timing rows: the paged kernel's
    launches before the reload (bf16 pools) into rows 1 at C=1 and C=256,
    predict's and the canary's f32 flash forwards into the f32 forward
    row at T=4096."""
    for name, n in (
            ("paged_attention_decode", counts["paged"].get((1, "dense"), 0)),
            ("paged_attention_prefill_chunk",
             counts["paged"].get((256, "dense"), 0)),
            ("flash_attention_fwd_f32_t4096",
             counts["flash"].get(("fwd", "tf32"), 0))):
        for row in rows:
            if row["name"] == name:
                row["launches"] += int(n)


# ------------------------------------------ phase 22: CNN layers, path 6
# f32 with TF32 off: every layer output and gradient on the card within
# CNN_TOL of the largest |reference| (the same layer on the CPU, and this
# script's own numpy f64 version of the layer)
CNN_TOL = 1e-4
# bench.py bench_lenet (bench.py:202-232): B=4096 28x28x1 uint8 images
# through ImagePreProcessingScaler, bf16 compute over f32 masters,
# Nesterovs lr 0.01 momentum 0.9, 10 classes
LENET_B, LENET_STEPS, LENET_PARITY_B, LENET_PARITY_STEPS = 4096, 5, 64, 3


def np_same_pad(n, k, s, d=1):
    """SAME padding (lo, hi) of one axis, the extra pad at the end: this
    script's own copy of the rule, so that the check does not lean on
    the port's `util/conv_utils.py`."""
    ek = k + (k - 1) * (d - 1)
    total = max(0, (-(-n // s) - 1) * s + ek - n)
    return total // 2, total - total // 2


def np_windows(np, x, kernel, stride, dilation, pad, value):
    """(i, j, slab) for every kernel offset: the strided slab of the
    padded NHWC `x` that offset reads, (B, OH, OW, C)."""
    (t, b), (l, r) = pad
    xp = np.pad(x, ((0, 0), (t, b), (l, r), (0, 0)), constant_values=value)
    ekh = dilation[0] * (kernel[0] - 1) + 1
    ekw = dilation[1] * (kernel[1] - 1) + 1
    oh = (xp.shape[1] - ekh) // stride[0] + 1
    ow = (xp.shape[2] - ekw) // stride[1] + 1
    for i in range(kernel[0]):
        for j in range(kernel[1]):
            a, c = i * dilation[0], j * dilation[1]
            yield i, j, xp[:, a:a + stride[0] * (oh - 1) + 1:stride[0],
                           c:c + stride[1] * (ow - 1) + 1:stride[1], :]


def np_conv(np, x, W, b, stride, dilation, pad):
    out = 0.0
    for i, j, slab in np_windows(np, x, W.shape[:2], stride, dilation, pad,
                                 0.0):
        out = out + slab @ W[i, j]
    return out + b


def np_pool(np, x, kind, kernel, stride, pad, pnorm=2):
    """MAX pads with -inf; AVG divides by the whole window; SUM and
    PNORM pad with 0."""
    value = -np.inf if kind == "max" else 0.0
    slabs = [s for _, _, s in np_windows(np, x, kernel, stride, (1, 1), pad,
                                         value)]
    if kind == "max":
        return np.max(slabs, axis=0)
    if kind == "pnorm":
        return np.sum([np.abs(s) ** pnorm for s in slabs],
                      axis=0) ** (1.0 / pnorm)
    total = np.sum(slabs, axis=0)
    return total / len(slabs) if kind == "avg" else total


def np_lrn(np, x, k, n, alpha, beta):
    C = x.shape[-1]
    sq = np.pad(x * x, ((0, 0),) * 3 + ((n // 2, n - 1 - n // 2),))
    s = sum(sq[..., i:i + C] for i in range(n))
    return x / (k + alpha * s) ** beta


def np_global_pool(np, x, mask, kind):
    m = mask[:, :, None]
    if kind == "max":
        return np.where(m > 0, x, -np.inf).max(axis=1)
    return (x * m).sum(axis=1) / np.maximum(m.sum(axis=1), 1.0)


def np_lenet_probs(np, params, images):
    """LeNet's inference forward in f64 from the network's parameters:
    pixels / 255, two valid 5x5 convolutions each followed by 2x2 max
    pooling, the maps flattened in (h, w, c) order, dense ReLU, softmax."""
    p = [{k: v.detach().double().cpu().numpy() for k, v in q.items()}
         for q in params]
    h = (images.astype(np.float64) / 255.0).reshape(-1, 28, 28, 1)
    none = ((0, 0), (0, 0))
    for c in (0, 2):
        h = np_conv(np, h, p[c]["W"], p[c]["b"], (1, 1), (1, 1), none)
        h = np_pool(np, h, "max", (2, 2), (2, 2), none)
    h = np.maximum(h.reshape(h.shape[0], -1) @ p[4]["W"] + p[4]["b"], 0.0)
    z = h @ p[5]["W"] + p[5]["b"]
    z = np.exp(z - z.max(axis=1, keepdims=True))
    return z / z.sum(axis=1, keepdims=True)


def rel_err(np, got, ref) -> float:
    """Largest |got - ref| over the largest |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"shape {got.shape} != {ref.shape}")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def layer_run(torch, np, layer, params, x, device, *, state=None,
              train=False, mask=None):
    """The layer's forward in f32 on `device`, then the gradients of
    sum(out * ct) (ct from a seed) for the input and every parameter;
    with state, the new state. All as f64 numpy."""
    p = {k: torch.tensor(v, device=device, requires_grad=True)
         for k, v in params.items()}
    xx = torch.tensor(x, device=device, requires_grad=True)
    m = None if mask is None else torch.tensor(mask, device=device)
    new = {}
    if layer.stateful:
        st = {k: torch.tensor(v, device=device) for k, v in state.items()}
        out, new = layer.forward_with_state(p, st, xx, train=train, mask=m)
    else:
        out = layer.forward(p, xx, train=train, mask=m)
    ct = np.random.default_rng(0).standard_normal(tuple(out.shape))
    g = torch.autograd.grad(out, [xx, *p.values()],
                            torch.tensor(ct, dtype=out.dtype, device=device))
    res = {"out": out, "dx": g[0], **{f"d{k}": gk for k, gk in zip(p, g[1:])},
           **{f"state {k}": v for k, v in new.items()}}
    return {k: v.detach().double().cpu().numpy() for k, v in res.items()}


def cnn_layer_case(torch, np, what, layer, params, x, ref, **kw):
    """The layer on the card against itself on the CPU (forward, every
    gradient, new state) and its forward against `ref`, this script's
    numpy f64 version; each within CNN_TOL of the largest |reference|."""
    card = layer_run(torch, np, layer, params, x, "cuda", **kw)
    cpu = layer_run(torch, np, layer, params, x, "cpu", **kw)
    errs = {k: rel_err(np, card[k], cpu[k]) for k in card}
    errs["out vs numpy"] = rel_err(np, card["out"], ref)
    worst = max(errs.values())
    log(f"  {what:<34} worst {worst:.2e} (" + ", ".join(
        f"{k} {e:.1e}" for k, e in errs.items()) + ")")
    if not worst <= CNN_TOL:
        raise AssertionError(f"{what}: {errs} beyond {CNN_TOL}")
    return card


def phase_cnn_layers(torch, M):
    """Phase 22 (a): each CNN layer on the card in f32 against the CPU and
    against numpy."""
    import numpy as np

    C = M["conf"]
    rng = np.random.default_rng(22)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    ident = M["Activation"].IDENTITY
    for what, H, W, kw in (
            ("conv truncate pad 1", 13, 14, dict(padding=(1, 1))),
            ("conv same 4x4", 13, 14, dict(kernel=(4, 4),
                                           convolution_mode="same")),
            ("conv same stride 2", 14, 14, dict(stride=(2, 2),
                                                convolution_mode="same")),
            ("conv strict stride 2", 13, 15, dict(stride=(2, 2),
                                                  convolution_mode="strict")),
            ("conv dilation 2", 13, 14, dict(dilation=(2, 2))),
            ("conv same stride 2 dilation 2", 13, 14,
             dict(stride=(2, 2), dilation=(2, 2),
                  convolution_mode="same"))):
        kw = dict(dict(kernel=(3, 3), stride=(1, 1), padding=(0, 0),
                       dilation=(1, 1), convolution_mode="truncate"), **kw)
        layer = C.ConvolutionLayer(
            n_in=3, n_out=8, activation=ident, kernel=kw["kernel"],
            stride=kw["stride"], padding=kw["padding"],
            dilation=kw["dilation"],
            convolution_mode=C.ConvolutionMode(kw["convolution_mode"]))
        params = {"W": f32(*kw["kernel"], 3, 8) * 0.3, "b": f32(8) * 0.1}
        x = f32(2, H, W, 3)
        pad = tuple(np_same_pad(n, k, s, d) for n, k, s, d in zip(
            (H, W), kw["kernel"], kw["stride"], kw["dilation"])) \
            if kw["convolution_mode"] == "same" \
            else tuple((p, p) for p in kw["padding"])
        ref = np_conv(np, x.astype(np.float64), params["W"], params["b"],
                      kw["stride"], kw["dilation"], pad)
        cnn_layer_case(torch, np, what, layer, params, x, ref)
    x = f32(2, 8, 9, 4) - 3.0  # negative: a zero pad would win MAX
    pad = (np_same_pad(8, 3, 2), np_same_pad(9, 3, 2))
    for kind in ("max", "avg", "sum", "pnorm"):
        layer = C.SubsamplingLayer(pooling_type=C.PoolingType(kind),
                                   kernel=(3, 3), stride=(2, 2), pnorm=3,
                                   convolution_mode=C.ConvolutionMode.SAME)
        cnn_layer_case(torch, np, f"pool {kind} same 3x3 stride 2", layer,
                       {}, x, np_pool(np, x.astype(np.float64), kind, (3, 3),
                                      (2, 2), pad, 3))
    for shape in ((32, 16), (4, 6, 6, 8)):
        nf = shape[-1]
        layer = C.BatchNormalization(n_in=nf, n_out=nf, decay=0.8,
                                     activation=ident)
        params = {"gamma": 1 + 0.2 * f32(nf), "beta": 0.2 * f32(nf)}
        state = {"mean": f32(nf), "var": (0.5 + rng.random(nf)).astype(
            np.float32)}
        axes = tuple(range(len(shape) - 1))
        for step in range(3):
            x = 2 * f32(*shape) + 1
            xd = x.astype(np.float64)
            mean, var = xd.mean(axis=axes), xd.var(axis=axes)  # biased
            ref = (xd - mean) / np.sqrt(var + layer.eps) * params["gamma"] \
                + params["beta"]
            got = cnn_layer_case(
                torch, np, f"batchnorm {len(shape)}d train step {step + 1}",
                layer, params, x, ref, state=state, train=True)
            want = {"mean": 0.8 * state["mean"] + 0.2 * mean,
                    "var": 0.8 * state["var"] + 0.2 * var}
            for k in want:
                e = rel_err(np, got[f"state {k}"], want[k])
                if not e <= CNN_TOL:
                    raise AssertionError(f"batchnorm running {k} off the "
                                         f"biased batch statistics by {e}")
            state = {k: got[f"state {k}"].astype(np.float32) for k in want}
        x = f32(*shape)
        ref = (x - state["mean"]) / np.sqrt(state["var"] + layer.eps) \
            * params["gamma"] + params["beta"]
        cnn_layer_case(torch, np, f"batchnorm {len(shape)}d eval", layer,
                       params, x, ref, state=state)
    layer = C.LocalResponseNormalization(k=1.5, n=5, alpha=0.3, beta=0.75)
    x = f32(2, 5, 6, 7)
    cnn_layer_case(torch, np, "lrn n=5", layer, {}, x,
                   np_lrn(np, x.astype(np.float64), 1.5, 5, 0.3, 0.75))
    x = f32(3, 10, 16)
    mask = np.ones((3, 10), np.float32)
    mask[0, 6:] = 0
    mask[2, 1:] = 0
    for kind in ("max", "avg"):
        layer = C.GlobalPoolingLayer(pooling_type=C.PoolingType(kind))
        cnn_layer_case(torch, np, f"global pooling {kind}, masked", layer,
                       {}, x, np_global_pool(np, x.astype(np.float64), mask,
                                             kind), mask=mask)


def lenet_batches(M, B, n, seed):
    """n batches of B MNIST examples from the port's fetcher, as
    bench_lenet takes them (`bench.py:202-232`):
    `MnistDataSetIterator(B, raw_uint8=True)`, uint8 (B, 784) pixels and
    one-hot labels. Without cached MNIST under `DL4J_TPU_DATA_DIR` it is
    the fetcher's synthetic stand-in made from `seed`."""
    it = M["MnistDataSetIterator"](B, num_examples=B * n, seed=seed,
                                   raw_uint8=True)
    out = []
    while it.has_next():
        ds = it.next()
        out.append((ds.features, ds.labels))
    return out


def mnist_source(M) -> str:
    """Where `MnistDataSetIterator` takes its pixels from on this
    machine."""
    cache = M["fetchers"].DATA_DIR / "mnist"
    return (f"cached idx files under {cache}" if cache.exists()
            else "the fetcher's synthetic stand-in (no cached MNIST)")


def lenet_net(torch, M, device, compute_dtype=None):
    net = M["MultiLayerNetwork"](M["lenet_configuration"](),
                                 dtype=torch.float32,
                                 compute_dtype=compute_dtype, device=device)
    net.init()
    net.set_normalizer(M["ImagePreProcessingScaler"]())
    return net


def phase_lenet(torch, M, card):
    """Phase 22 (b): path 6 at bench_lenet's shape, then LeNet's card-vs-
    CPU f32 parity and its output against numpy."""
    import numpy as np

    DataSet = M["DataSet"]
    net = lenet_net(torch, M, "cuda", torch.bfloat16)
    batches = [DataSet(x, y) for x, y in lenet_batches(
        M, LENET_B, LENET_STEPS + 2, seed=6)]
    net.fit(batches[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for ds in batches[1:LENET_STEPS + 1]:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(net.score_value)
    peak = torch.cuda.max_memory_allocated()
    kernels: dict = {}
    trace = traced(torch, lambda: net.fit(batches[-1]), kernels)
    copies = {n: t for n, t in kernels.items() if "copy" in n.lower()}
    med = sorted(step_ms)[len(step_ms) // 2]
    log(f"  path 6: {LENET_STEPS} steps of B={LENET_B} 28x28x1 uint8 from "
        f"MnistDataSetIterator ({mnist_source(M)}; bf16 over f32 masters, "
        f"Nesterovs): step ms "
        f"{[round(t, 2) for t in step_ms]}; median {med:.2f} ms, "
        f"{LENET_B / med * 1e3:.1f} samples/s [{card}]")
    log(f"  losses {losses}; peak device memory {peak / 2**30:.3f} GiB "
        f"({peak} bytes)")
    log(f"  traced step (torch.profiler, not in the step times): {trace}")
    log(f"  copy kernels in the traced step: {len(copies)} kinds, "
        f"{sum(copies.values()) / 1e3:.3f} ms")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"LeNet losses not finite and falling: {losses}")
    del net
    torch.cuda.empty_cache()

    cpu = lenet_net(torch, M, "cpu")
    card_net = lenet_net(torch, M, "cuda")
    card_net.set_param_tree([{k: v.clone() for k, v in p.items()}
                             for p in cpu._params])
    got = {"card": [], "cpu": []}
    for x, y in lenet_batches(M, LENET_PARITY_B, LENET_PARITY_STEPS,
                              seed=23):
        for name, n in (("card", card_net), ("cpu", cpu)):
            n.fit(DataSet(x, y))
            got[name].append(n.score_value)
    np.testing.assert_allclose(got["card"], got["cpu"], rtol=1e-4)
    worst = 0.0
    for a, b in zip(card_net._params, cpu._params):
        for k in a:
            d = (a[k].cpu() - b[k]).abs()
            worst = max(worst, d.max().item())
            if not bool((d <= 1e-5 + 1e-5 * b[k].abs()).all()):
                raise AssertionError(f"LeNet param {k} differs card vs CPU "
                                     f"by {d.max().item()}")
    images = lenet_batches(M, 16, 1, seed=24)[0][0]
    e = rel_err(np, card_net.output(images).cpu().numpy(),
                np_lenet_probs(np, card_net._params, images))
    log(f"  f32 parity, B={LENET_PARITY_B}: losses card {got['card']} cpu "
        f"{got['cpu']} (rtol 1e-4), params max abs diff {worst:.3e} "
        f"(1e-5 + 1e-5 |ref|); output against numpy {e:.2e} "
        f"(tolerance {CNN_TOL})")
    if not e <= CNN_TOL:
        raise AssertionError(f"LeNet output off the numpy forward by {e}")


# ----------------------------- phase 23: SelfAttention, MoE, path 2m
# SelfAttention at gpt_long's width, non-causal: B=2, T=4096, 8 heads of
# 128, block_size 1024 (the flash route); held to the same layer on the
# plain route (block_size None: full attention, plain torch ops) in f32,
# each output and gradient within ATTN_TOL of its largest |reference|
ATTN = dict(n_in=1024, n_out=1024, n_heads=8, causal=False, block_size=1024)
ATTN_B, ATTN_T, ATTN_FIT_STEPS = 2, 4096, 3
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# path 2m: gpt_long with 8 Switch experts a block, capacity factor 1.25
# and aux weight 0.01 (the JAX package's defaults, Switch Transformer's);
# its engine check at capacity factor 8 = E (nothing overflows)
MOE_EXPERTS, MOE_STEPS, MOE_B = 8, 3, 8
MOE_SERVE_CF, MOE_SERVE_TOKENS = 8.0, 32


def attention_case(torch, M, dtype):
    """The non-causal SelfAttention layer in `dtype` on the flash route
    against its plain route in f32; returns the flash launches by
    (kind, route)."""
    import numpy as np

    C, fa = M["conf"], M["fa"]
    ident = M["Activation"].IDENTITY
    layer = C.SelfAttention(**ATTN, activation=ident)
    plain = C.SelfAttention(**{**ATTN, "block_size": None},
                            activation=ident)
    g = torch.Generator(device="cuda").manual_seed(23)
    it = C.InputType.recurrent(ATTN["n_in"], ATTN_T)
    params = {k: v.to(dtype) for k, v in
              layer.init_params(g, it, torch.float32).items()}
    params = {k: (v + 0.02 * torch.randn(v.shape, generator=g,
                                         device="cuda")).to(dtype)
              if k.startswith("b") else v for k, v in params.items()}
    x = torch.randn((ATTN_B, ATTN_T, ATTN["n_in"]), generator=g,
                    device="cuda").to(dtype)
    ct = torch.randn((ATTN_B, ATTN_T, ATTN["n_out"]), generator=g,
                     device="cuda").to(dtype)

    def run(lay, p, xx):
        p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xx = xx.detach().requires_grad_(True)
        out = lay.forward(p, xx)
        grads = torch.autograd.grad(out, [xx, *p.values()], ct.to(out.dtype))
        return {"out": out.detach(), "dx": grads[0],
                **{f"d{k}": gk for k, gk in zip(p, grads[1:])}}

    fa.reset_counts()
    got = run(layer, params, x)
    torch.cuda.synchronize()
    routes = dict(fa.launches_by_route)
    ref = run(plain, {k: v.float() for k, v in params.items()}, x.float())
    tol = ATTN_TOL[str(dtype)[6:]]
    # dbk is 0 in exact arithmetic (a key bias moves each softmax row by
    # a constant): it is held at the scale of dbv, the same shape's
    errs = {}
    for k in got:
        g, r = got[k].float().cpu().numpy(), ref[k].cpu().numpy()
        scale = max(np.abs(r).max(), np.abs(ref["dbv"].cpu().numpy()).max()
                    if k == "dbk" else 0.0)
        errs[k] = float(np.abs(g - r).max() / scale)
    worst = max(errs.values())
    log(f"  SelfAttention {str(dtype)[6:]} B={ATTN_B} T={ATTN_T} "
        f"{ATTN['n_heads']} heads of {ATTN['n_out'] // ATTN['n_heads']}, "
        f"non-causal: worst {worst:.2e} of tolerance {tol} (" +
        ", ".join(f"{k} {e:.1e}" for k, e in errs.items()) +
        f"); flash launches by route {routes}")
    if not worst <= tol:
        raise AssertionError(f"SelfAttention flash route off its plain "
                             f"route: {errs}")
    want = "wgmma" if dtype == torch.bfloat16 else "tf32"
    if routes != {(k, want): 1 for k in ("fwd", "dq", "dkv")}:
        raise AssertionError(f"expected one non-causal launch of each "
                             f"flash kernel on {want}, got {routes}")
    del got, ref, params, x, ct
    torch.cuda.empty_cache()
    return routes


def attention_fit(torch, M):
    """3 fit steps of TokenEmbedding -> SelfAttention(causal=False) ->
    GlobalPoolingLayer(AVG) -> OutputLayer in bf16: finite losses, 3
    launches of each flash kernel, no plain call."""
    import numpy as np

    C, fa = M["conf"], M["fa"]
    conf = (C.NeuralNetConfiguration.Builder().seed(23).learning_rate(1e-3)
            .updater("adam").list()
            .layer(M["TokenEmbedding"](n_in=256, n_out=ATTN["n_in"],
                                       max_length=ATTN_T))
            .layer(C.SelfAttention(**ATTN,
                                   activation=M["Activation"].IDENTITY))
            .layer(C.GlobalPoolingLayer(pooling_type=C.PoolingType.AVG))
            .layer(C.OutputLayer(n_out=16, activation="softmax"))
            .set_input_type(C.InputType.recurrent(256, ATTN_T)).build())
    net = M["MultiLayerNetwork"](conf, compute_dtype=torch.bfloat16,
                                 device="cuda")
    net.init()
    rng = np.random.default_rng(23)
    fa.reset_counts()
    losses = []
    for _ in range(ATTN_FIT_STEPS):
        net.fit(M["DataSet"](
            rng.integers(0, 256, (ATTN_B, ATTN_T)).astype(np.int32),
            np.eye(16, dtype=np.float32)[rng.integers(0, 16, ATTN_B)]))
        losses.append(net.score_value)
    routes = dict(fa.launches_by_route)
    plain = (fa.flash_attention_plain_fwd.calls,
             fa.flash_attention_plain_bwd.calls)
    log(f"  attention classifier, {ATTN_FIT_STEPS} bf16 fit steps: losses "
        f"{losses}; flash launches by route {routes}, plain {plain}")
    if not all(np.isfinite(losses)) or any(plain) or routes != {
            (k, "wgmma"): ATTN_FIT_STEPS for k in ("fwd", "dq", "dkv")}:
        raise AssertionError(f"attention classifier: losses {losses}, "
                             f"launches {routes}, plain {plain}")
    del net
    torch.cuda.empty_cache()
    return routes


def np_switch(np, x, p, capacity_factor, act):
    """Switch top-1 routing with a global capacity in token order, in
    f64: (y with overflow passed through, aux loss, dropped count)."""
    N = x.shape[0]
    E = p["router"].shape[1]
    cap = int(math.ceil(N / E * capacity_factor))
    z = x @ p["router"]
    top2 = np.sort(z, axis=1)[:, -2:]
    if not np.min(top2[:, 1] - top2[:, 0]) > 1e-4:
        raise ValueError("the MoE case's data leave two router logits of a "
                         "token within 1e-4: its routing is not decided")
    probs = np.exp(z - z.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    idx = probs.argmax(axis=1)
    y, taken = x.copy(), np.zeros(E, int)
    for n in range(N):
        e = idx[n]
        if taken[e] < cap:
            taken[e] += 1
            h = act(x[n] @ p["W1"][e] + p["b1"][e])
            y[n] = probs[n, e] * (h @ p["W2"][e] + p["b2"][e])
    frac = np.bincount(idx, minlength=E) / N
    aux = E * np.sum(frac * probs.mean(axis=0))
    return y, aux, N - int(taken.sum())


def moe_reference_case(torch, M):
    """An MoELayer network in f32 on the card against numpy: the output
    with capacity overflow (tokens past their expert's capacity pass
    through) and the load-balancing term of the training loss."""
    import numpy as np

    C = M["conf"]
    d, E, B, T = 64, 4, 4, 32
    conf = (C.NeuralNetConfiguration.Builder().seed(5).list()
            .layer(C.MoELayer(n_in=d, n_out=d, n_experts=E, hidden_mult=2,
                              capacity_factor=1.0))
            .layer(C.LossLayer(loss=M["LossFunction"].MSE,
                               activation=M["Activation"].IDENTITY))
            .set_input_type(C.InputType.recurrent(d)).build())
    net = M["MultiLayerNetwork"](conf, device="cuda")
    rng = np.random.default_rng(5)
    p = {"router": rng.standard_normal((d, E)) * 0.3,
         "W1": rng.standard_normal((E, d, 2 * d)) / 8,
         "b1": rng.standard_normal((E, 2 * d)) * 0.1,
         "W2": rng.standard_normal((E, 2 * d, d)) / 11,
         "b2": rng.standard_normal((E, d)) * 0.1}
    x = rng.standard_normal((B, T, d))
    p["router"][:, 0] += 0.5 * x.reshape(-1, d).mean(axis=0)  # skew: overflow
    net.set_param_tree([{k: torch.tensor(v, dtype=torch.float32)
                         for k, v in p.items()}, {}])
    x32 = x.astype(np.float32)
    labels = rng.standard_normal((B, T, d)).astype(np.float32)
    ds = M["DataSet"](x32, labels)
    got = net.output(x32).cpu().numpy()
    aux = net.score(ds, train=True) - net.score(ds, train=False)
    ref, ref_aux, dropped = np_switch(np, x32.astype(np.float64).reshape(
        -1, d), p, 1.0, lambda h: np.maximum(h, 0.0))
    e = rel_err(np, got, ref.reshape(B, T, d))
    want = conf.layers[0].aux_loss_weight * ref_aux
    log(f"  MoELayer f32 vs numpy ({dropped} of {B * T} tokens over "
        f"capacity): output {e:.2e} (tolerance {CNN_TOL}); load-balancing "
        f"term {aux:.7f} vs {want:.7f}")
    if dropped == 0 or not e <= CNN_TOL or abs(aux - want) > 1e-5:
        raise AssertionError(f"MoELayer off numpy: output {e}, aux {aux} vs "
                             f"{want}, {dropped} dropped")


def phase_moe_serve(torch, M, pa):
    """Phase 23 (c): the 8-layer MoE GPT in f32 at capacity factor 8:
    greedy engine tokens equal generate's for 2 prompts (one on the
    one-shot prefill, one chunked), through the paged kernels."""
    import numpy as np

    conf = M["gpt_configuration"](**{**SERVE, "max_length": 1024},
                                  moe_experts=MOE_EXPERTS, seed=17)
    for layer in conf.layers:
        if hasattr(layer, "moe_capacity_factor"):
            layer.moe_capacity_factor = MOE_SERVE_CF
    net = M["MultiLayerNetwork"](conf, device="cuda")
    net.init()
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, SERVE["vocab_size"], t) for t in (100, 600)]
    eng = M["DecodeEngine"](net, n_slots=2, page_size=128, prefill_chunk=256,
                            prompt_buckets=(128,), max_len=1024,
                            device="cuda")
    try:
        pa.reset_counts()
        reqs = [eng.submit(p, MOE_SERVE_TOKENS) for p in prompts]
        got = [r.result(timeout=600) for r in reqs]
        launches = dict(pa.paged_attention.launches_by)
        plain = pa.paged_attention_plain.calls
    finally:
        eng.shutdown()
    for p, g in zip(prompts, got):
        exp = M["generate"](net, p[None], MOE_SERVE_TOKENS, temperature=0.0,
                            device="cuda")[0]
        log(f"  MoE prompt {len(p):>4}: engine {g.tolist()}")
        if not np.array_equal(g, exp):
            raise AssertionError(f"MoE engine tokens differ from generate for "
                                 f"the {len(p)}-token prompt: {exp.tolist()}")
    log(f"  MoE engine == generate (f32, capacity factor {MOE_SERVE_CF}); "
        f"paged launches by (C, pools) {launches}, plain calls {plain}")
    if launches.get((1, "dense"), 0) == 0 \
            or launches.get((256, "dense"), 0) == 0 or plain:
        raise AssertionError(f"MoE serving: launches {launches}, plain "
                             f"{plain}")
    del eng, net
    torch.cuda.empty_cache()
    return launches


def phase_attention_moe(torch, M, pa, card):
    """Phase 23: SelfAttention (a), path 2m (b), MoE serving (c); returns
    the launch counts by path."""
    routes = {}
    for dtype in (torch.bfloat16, torch.float32):
        for key, n in attention_case(torch, M, dtype).items():
            routes[key] = routes.get(key, 0) + n
    for key, n in attention_fit(torch, M).items():
        routes[key] = routes.get(key, 0) + n
    moe_reference_case(torch, M)
    log(f"  path 2m: gpt_long with {MOE_EXPERTS} Switch experts a block")
    counts_2m = phase_train(torch, M, card, torch.bfloat16, MOE_B, MOE_STEPS,
                            24, "wgmma", moe_experts=MOE_EXPERTS)
    paged = phase_moe_serve(torch, M, pa)
    return {"attention": routes, "2m": counts_2m, "paged": paged}


def attention_moe_rows(torch, fa, counts):
    """The non-causal flash rows at the SelfAttention shape (bf16 and
    f32, with its launches), and path 2m's and its engine's launches into
    the causal bf16 rows at path 2's shape and the paged rows."""
    H, D = ATTN["n_heads"], ATTN["n_out"] // ATTN["n_heads"]
    att = counts["attention"]
    rows = flash_rows(torch, fa, ATTN_B, H, ATTN_T, D,
                      {k: n for (k, r), n in att.items() if r == "wgmma"},
                      0.0, seed=51, tag="_noncausal_t4096", causal=False)
    rows += flash_rows(torch, fa, ATTN_B, H, ATTN_T, D,
                       {k: n for (k, r), n in att.items() if r == "tf32"},
                       0.0, seed=52, dtype=torch.float32,
                       tag="_noncausal_t4096", causal=False)
    return rows


def moe_launches(rows, counts) -> None:
    """Path 2m's flash launches into the causal bf16 rows at its shape
    (path 2's), its engine's paged launches into rows 1."""
    adds = {"flash_attention_fwd": counts["2m"]["fwd"],
            "flash_attention_bwd_dq": counts["2m"]["dq"],
            "flash_attention_bwd_dkv": counts["2m"]["dkv"],
            "paged_attention_decode": counts["paged"].get((1, "dense"), 0),
            "paged_attention_prefill_chunk":
                counts["paged"].get((256, "dense"), 0)}
    for row in rows:
        row["launches"] += int(adds.get(row["name"], 0))


# ------------------------------ phase 24: path 7, ResNet-50 on CIFAR-10
# bench_resnet50 (bench.py:256-295): resnet_configuration(depth=50,
# n_classes=10), B=256 32x32x3 uint8 images through
# ImagePreProcessingScaler, bf16 compute over f32 masters, Nesterovs lr 0.1,
# momentum 0.9, l2 1e-4; seeded class templates plus noise as the data
RESNET_B, RESNET_STEPS, RESNET_HW = 256, 5, 32


def cifar_batches(np, B, n, seed, hw=RESNET_HW, classes=10):
    """Seeded CIFAR-shaped data: ten hw x hw x 3 uint8 class templates,
    each image its class's template plus uniform noise, one-hot labels."""
    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 256, (classes, hw, hw, 3))
    out = []
    for _ in range(n):
        y = rng.integers(0, classes, B)
        x = np.clip(templates[y] + rng.integers(-40, 41, (B, hw, hw, 3)),
                    0, 255)
        out.append((x.astype(np.uint8), np.eye(classes, dtype=np.float32)[y]))
    return out


def check_topological_order(conf) -> None:
    """Every node after all of its inputs, each node once."""
    pos = {n: i for i, n in enumerate(conf.topological_order)}
    if sorted(pos) != sorted(conf.nodes) \
            or len(pos) != len(conf.topological_order):
        raise AssertionError("topological order does not list every node "
                             "once")
    for name, node in conf.nodes.items():
        late = [i for i in node.inputs if i in pos and pos[i] > pos[name]]
        if late:
            raise AssertionError(f"node {name!r} runs before its inputs "
                                 f"{late}")


# device kernels by kind, from their names: the first kind whose words a
# kernel's name holds (lower case)
KERNEL_KINDS = (("convolution", ("conv", "cudnn", "xmma", "implicit",
                                 "wgrad", "dgrad", "fprop")),
                ("GEMM", ("gemm", "cutlass")),
                ("reduction", ("reduce",)),
                ("copy, pad, cat", ("copy", "pad", "cat")),
                ("element-wise", ("elementwise",)))


def kernel_kinds(per_name) -> str:
    """Device ms by kernel kind (`KERNEL_KINDS`) of a traced run."""
    ms: dict = {}
    for name, us in per_name.items():
        low = name.lower()
        kind = next((k for k, words in KERNEL_KINDS
                     if any(w in low for w in words)), "other")
        ms[kind] = ms.get(kind, 0.0) + us / 1e3
    return ", ".join(f"{k} {v:.1f} ms" for k, v in
                     sorted(ms.items(), key=lambda kv: -kv[1]))


def bn_means(net):
    return {n: net._layer_state[n]["mean"].clone()
            for n, layer in net._layer_slots()
            if type(layer).__name__ == "BatchNormalization"}


def out_of_order_dag(M):
    """A residual DAG whose nodes are added before their inputs (the add
    first, its second input's layer last), built without input types."""
    C = M["conf"]
    return (C.NeuralNetConfiguration.Builder().graph_builder()
            .add_inputs("in")
            .add_vertex("add", M["ElementWiseVertex"](), "b", "a")
            .add_layer("out", C.OutputLayer(n_in=4, n_out=2,
                                            activation="softmax"), "add")
            .add_layer("b", C.DenseLayer(n_in=4, n_out=4), "a")
            .add_layer("a", C.DenseLayer(n_in=4, n_out=4), "in")
            .set_outputs("out").build())


def phase_resnet(torch, M, card):
    """Phase 24: the builder's topological order, then path 7, ResNet-50
    at bench_resnet50's shape."""
    import numpy as np

    DataSet = M["DataSet"]
    check_topological_order(out_of_order_dag(M))
    conf = M["resnet_configuration"](depth=50, n_classes=10)
    check_topological_order(conf)
    net = M["ComputationGraph"](conf, dtype=torch.float32,
                                compute_dtype=torch.bfloat16, device="cuda")
    net.init()
    net.set_normalizer(M["ImagePreProcessingScaler"]())
    n_params = net.num_params()
    adds = sum(1 for n in conf.nodes.values() if n.vertex is not None)
    batches = [DataSet(x, y) for x, y in cifar_batches(
        np, RESNET_B, RESNET_STEPS + 3, seed=24)]
    before = bn_means(net)
    t0 = time.perf_counter()
    net.fit(batches[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for ds in batches[1:RESNET_STEPS + 1]:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(net.score_value)
    peak = torch.cuda.max_memory_allocated()
    kernels: dict = {}
    trace = traced(torch, lambda: net.fit(batches[-2]), kernels)
    after = bn_means(net)
    still = [n for n in before if torch.equal(before[n], after[n])]
    med = sorted(step_ms)[len(step_ms) // 2]
    log(f"  path 7: ResNet-50 ({len(conf.nodes)} nodes, {adds} residual "
        f"adds, {n_params} parameters), {RESNET_STEPS} steps of "
        f"B={RESNET_B} {RESNET_HW}x{RESNET_HW}x3 uint8 (bf16 over f32 "
        f"masters, Nesterovs): warm-up {1e3 * warm:.1f} ms; step ms "
        f"{[round(t, 2) for t in step_ms]}; median {med:.2f} ms (spread "
        f"{min(step_ms):.2f}-{max(step_ms):.2f}), "
        f"{RESNET_B / med * 1e3:.1f} samples/s [{card}]")
    log(f"  losses {losses}; peak device memory {peak / 2**30:.3f} GiB "
        f"({peak} bytes)")
    log(f"  traced step (torch.profiler, not in the step times): {trace}")
    log(f"  its device time by kernel kind: {kernel_kinds(kernels)}; "
        f"{len(kernels)} kernel names")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ResNet-50 losses not finite: {losses}")
    if still:
        raise AssertionError(f"BatchNormalization running stats of "
                             f"{len(still)} of {len(before)} nodes never "
                             f"moved: {still[:4]}")
    x, y = batches[-1].features, batches[-1].labels
    out = net.output(x)[0]
    probs = out.float().cpu().numpy()
    ev = net.evaluate(batches[-1])
    acc = float((probs.argmax(1) == y.argmax(1)).mean())
    log(f"  output {tuple(out.shape)} {out.dtype}, rows sum to 1 within "
        f"{np.abs(probs.sum(1) - 1).max():.2e}; evaluate: accuracy "
        f"{ev.accuracy():.4f} (numpy on output {acc:.4f}), confusion total "
        f"{int(ev.confusion_matrix.sum())}")
    if probs.shape != (RESNET_B, 10) or not np.isfinite(probs).all() \
            or np.abs(probs.sum(1) - 1).max() > 1e-3 \
            or int(ev.confusion_matrix.sum()) != RESNET_B \
            or abs(ev.accuracy() - acc) > 1e-9:
        raise AssertionError("ResNet-50 output or evaluate wrong")
    del net
    torch.cuda.empty_cache()


# ------------------------ phase 25: the graph on the LSTM kernels, parity
GRAPH_STEPS = 3  # fit steps of path 4's char-RNN as a graph and as a list


def char_rnn_graph_conf(M, vocab, hidden, seed=1, tbptt=0, lr=0.1,
                        updater="rmsprop"):
    """`char_rnn_conf`'s network as a linear-chain ComputationGraph (node
    names in chain order, so the flat parameters line up)."""
    C, A, LF = M["conf"], M["Activation"], M["LossFunction"]
    b = (C.NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
         .updater(updater).graph_builder().add_inputs("in")
         .add_layer("l0", C.GravesLSTM(n_out=hidden, activation=A.TANH),
                    "in")
         .add_layer("l1", C.GravesLSTM(n_out=hidden, activation=A.TANH),
                    "l0")
         .add_layer("out", C.RnnOutputLayer(n_out=vocab, loss=LF.MCXENT,
                                            activation=A.SOFTMAX), "l1")
         .set_outputs("out").set_input_types(C.InputType.recurrent(vocab)))
    if tbptt:
        b = b.t_bptt_forward_length(tbptt)
    return b.build()


def ragged_mask(np, B, T, seed):
    """(B, T) f32: row lengths from T/2 to T, some rows whole."""
    lens = np.random.default_rng(seed).integers(T // 2, T + 1, B)
    lens[::7] = T
    return (np.arange(T)[None] < lens[:, None]).astype(np.float32)


def graph_vs_list(torch, M, V, H, B, T, steps):
    """Path 4's char-RNN as a graph and as the list container, from the
    same parameters, `steps` fit steps each on the same batches: (losses,
    launches and step ms of each, largest parameter difference)."""
    import numpy as np

    L = M["lstm"]
    nets = {"graph": M["ComputationGraph"](char_rnn_graph_conf(M, V, H),
                                           dtype=torch.float32,
                                           compute_dtype=torch.bfloat16,
                                           device="cuda"),
            "list": M["MultiLayerNetwork"](char_rnn_conf(M, V, H, seed=1),
                                           dtype=torch.float32,
                                           compute_dtype=torch.bfloat16,
                                           device="cuda")}
    for n in nets.values():
        n.init()
        n.set_normalizer(M["OneHotEncoder"](V))
    if not torch.equal(nets["graph"].params(), nets["list"].params()):
        raise AssertionError("the graph's init differs from the list "
                             "container's")
    ids = np.random.default_rng(25).integers(0, V, (steps, B, T + 1))
    res = {}
    for name, net in nets.items():
        L.reset_counts()
        losses, ms = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            net.fit(M["DataSet"](ids[i, :, :-1].astype(np.uint8),
                                 ids[i, :, 1:].astype(np.int32)))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(net.score_value)
        res[name] = (losses, dict(L.launches), dict(L.launches_by_route),
                     (L.lstm_fwd_plain.calls, L.lstm_bwd_plain.calls), ms)
    diff = max(
        (nets["graph"]._params[n][k] - p[k]).abs().max().item()
        for (n, _), p in zip(nets["graph"]._layer_slots(),
                             nets["list"]._params) for k in p)
    del nets
    torch.cuda.empty_cache()
    return res, diff


def masked_graph_fit(torch, M, V, H, B, T, W):
    """Path 4b's char-RNN as a bf16 graph with tBPTT W on ragged rows
    (every window masked): (launches, routes, plain calls, loss)."""
    import numpy as np

    L = M["lstm"]
    net = M["ComputationGraph"](char_rnn_graph_conf(M, V, H, tbptt=W),
                                dtype=torch.float32,
                                compute_dtype=torch.bfloat16, device="cuda")
    net.init()
    (x, y), = one_hot_batches(np, V, B, T, 1, 26)
    mask = ragged_mask(np, B, T, 26)
    mds = M["MultiDataSet"]([x], [y], features_masks=[mask],
                            labels_masks=[mask])
    net.fit(mds)  # warm-up
    torch.cuda.synchronize()
    L.reset_counts()
    t0 = time.perf_counter()
    net.fit(mds)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    out = (dict(L.launches), dict(L.launches_by_route),
           (L.lstm_fwd_plain.calls, L.lstm_bwd_plain.calls),
           net.score_value, wall)
    del net
    torch.cuda.empty_cache()
    return out


def small_lstm_graph_parity(torch, M):
    """An f32 masked tBPTT graph (vocab 64, H=256, B=16, T=30, windows of
    12) on the card against the CPU for 2 fits; then rnn_time_step over
    the sequence against the full forward on the card."""
    import numpy as np

    V, H, B, T = 64, 256, 16, 30
    nets = {}
    for dev in ("cuda", "cpu"):
        nets[dev] = M["ComputationGraph"](
            char_rnn_graph_conf(M, V, H, seed=3, tbptt=12, lr=0.1,
                                updater="sgd"), dtype=torch.float32,
            device=dev)
        nets[dev].init()
    nets["cuda"].set_params(nets["cpu"].params())
    mask = ragged_mask(np, B, T, 27)
    losses = {"cuda": [], "cpu": []}
    for x, y in one_hot_batches(np, V, B, T, 2, 27):
        for dev, net in nets.items():
            net.fit(M["MultiDataSet"]([x], [y], features_masks=[mask],
                                      labels_masks=[mask]))
            losses[dev].append(net.score_value)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    worst = 0.0
    for name, p in nets["cpu"]._params.items():
        for k, v in p.items():
            d = (nets["cuda"]._params[name][k].cpu() - v).abs()
            worst = max(worst, d.max().item())
            if not bool((d <= 1e-4 + 1e-5 * v.abs()).all()):
                raise AssertionError(f"graph tBPTT param {name}.{k} differs "
                                     f"card vs CPU by {d.max().item()}")
    g = nets["cuda"]
    (x, _), = one_hot_batches(np, V, B, T, 1, 28)
    full = g.output(x)[0]
    streamed = torch.cat([g.rnn_time_step(x[:, :11])[0],
                          g.rnn_time_step(x[:, 11:])[0]], dim=1)
    e = (streamed - full).abs().max().item()
    log(f"  f32 masked tBPTT graph (H={H}, B={B}, T={T}, windows of 12): "
        f"losses card {losses['cuda']} cpu {losses['cpu']} (rtol 1e-5), "
        f"params max abs diff {worst:.3e} (1e-4 + 1e-5 |ref|); "
        f"rnn_time_step in two chunks against output {e:.3e} (1e-5)")
    if not e <= 1e-5:
        raise AssertionError(f"graph rnn_time_step off output by {e}")


def np_resnet_probs(np, net, images):
    """A ResNet graph's inference forward in f64 from the network's
    parameters and running stats, in this function's own dependency
    order: SAME convolutions, BatchNormalization on the running stats,
    ReLU, residual sums, global average pooling, dense softmax."""
    conf = net.conf
    p = {n: {k: v.detach().double().cpu().numpy() for k, v in d.items()}
         for n, d in net._params.items()}
    st = {n: {k: v.detach().double().cpu().numpy() for k, v in d.items()}
          for n, d in net._layer_state.items()}
    acts = {conf.network_inputs[0]: images.astype(np.float64)}

    def value(name):
        if name in acts:
            return acts[name]
        node = conf.nodes[name]
        xs = [value(i) for i in node.inputs]
        if node.vertex is not None:
            out = xs[0]
            for x in xs[1:]:
                out = out + x
        else:
            layer, x = node.layer, xs[0]
            kind = type(layer).__name__
            act = str(getattr(layer.activation, "value", layer.activation))
            if kind == "ConvolutionLayer":
                pad = tuple(np_same_pad(n, k, s) for n, k, s in zip(
                    x.shape[1:3], layer.kernel, layer.stride))
                out = np_conv(np, x, p[name]["W"], p[name]["b"],
                              layer.stride, (1, 1), pad)
            elif kind == "BatchNormalization":
                out = (x - st[name]["mean"]) / np.sqrt(
                    st[name]["var"] + layer.eps) * p[name]["gamma"] \
                    + p[name]["beta"]
            elif kind == "ActivationLayer":
                out = x
            elif kind == "GlobalPoolingLayer":  # no activation
                out = x.mean(axis=(1, 2))
                act = "identity"
            elif kind == "OutputLayer":
                z = x @ p[name]["W"] + p[name]["b"]
                z = np.exp(z - z.max(axis=1, keepdims=True))
                out = z / z.sum(axis=1, keepdims=True)
                act = "identity"
            else:
                raise AssertionError(f"numpy forward has no {kind}")
            if act == "relu":
                out = np.maximum(out, 0.0)
            elif act != "identity":
                raise AssertionError(f"numpy forward has no {act}")
        acts[name] = out
        return out

    return value(conf.network_outputs[0])


def conv_bn_chain(M, graph):
    """conv -> BatchNormalization -> dense softmax, as a graph or as the
    list container (node names in chain order)."""
    C = M["conf"]
    b = (C.NeuralNetConfiguration.Builder().seed(9).learning_rate(0.05)
         .updater("nesterovs").momentum(0.9))
    layers = [C.ConvolutionLayer(n_out=16, kernel=(3, 3), stride=(2, 2),
                                 convolution_mode="same",
                                 activation="identity"),
              C.BatchNormalization(activation="relu"),
              C.OutputLayer(n_out=10, activation="softmax")]
    it = C.InputType.convolutional(16, 16, 3)
    if not graph:
        lb = b.list()
        for layer in layers:
            lb = lb.layer(layer)
        return lb.set_input_type(it).build()
    gb = b.graph_builder().add_inputs("in")
    prev = "in"
    for name, layer in zip(("a_conv", "b_bn", "c_out"), layers):
        gb = gb.add_layer(name, layer, prev)
        prev = name
    return gb.set_outputs("c_out").set_input_types(it).build()


def resnet_tiny_parity(torch, M):
    """resnet_tiny in f32 on the card against the CPU for 3 Nesterovs
    steps (TF32 off), the card's output against the numpy forward, and a
    conv -> BN -> softmax chain as a graph against the list container on
    the card (parameters and running stats after 3 steps)."""
    import numpy as np

    DataSet = M["DataSet"]
    nets = {}
    for dev in ("cuda", "cpu"):
        nets[dev] = M["ComputationGraph"](M["resnet_tiny_configuration"](),
                                          dtype=torch.float32, device=dev)
        nets[dev].init()
    nets["cuda"].set_params(nets["cpu"].params())
    losses = {"cuda": [], "cpu": []}
    for x, y in cifar_batches(np, 32, 3, seed=29, hw=8):
        x = x.astype(np.float32) / 255.0
        for dev, net in nets.items():
            net.fit(DataSet(x, y))
            losses[dev].append(net.score_value)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    worst = 0.0
    for tree in ("_params", "_layer_state"):
        for name, d in getattr(nets["cpu"], tree).items():
            for k, v in d.items():
                got = getattr(nets["cuda"], tree)[name][k].cpu()
                diff = (got - v).abs()
                worst = max(worst, diff.max().item())
                if not bool((diff <= 1e-5 + 1e-5 * v.abs()).all()):
                    raise AssertionError(f"resnet_tiny {name}.{k} differs "
                                         f"card vs CPU by "
                                         f"{diff.max().item()}")
    x = cifar_batches(np, 16, 1, seed=30, hw=8)[0][0].astype(np.float32) \
        / 255.0
    e = rel_err(np, nets["cuda"].output(x)[0].cpu().numpy(),
                np_resnet_probs(np, nets["cuda"], x))
    chain = {"graph": M["ComputationGraph"](conv_bn_chain(M, True),
                                            device="cuda"),
             "list": M["MultiLayerNetwork"](conv_bn_chain(M, False),
                                            device="cuda")}
    chain["graph"].init()
    chain["list"].set_param_tree([chain["graph"]._params[n]
                                  for n in ("a_conv", "b_bn", "c_out")])
    for x, y in cifar_batches(np, 64, 3, seed=31, hw=16):
        for net in chain.values():
            net.fit(DataSet(x.astype(np.float32) / 255.0, y))
    cd = 0.0
    for i, n in enumerate(("a_conv", "b_bn", "c_out")):
        for tree in ("_params", "_layer_state"):
            mine = getattr(chain["graph"], tree)[n]
            theirs = getattr(chain["list"], tree)[i]
            if set(mine) != set(theirs):
                raise AssertionError(f"chain {n} {tree} names differ")
            for k in mine:
                cd = max(cd, (mine[k] - theirs[k]).abs().max().item())
    log(f"  resnet_tiny f32, B=32: losses card {losses['cuda']} cpu "
        f"{losses['cpu']} (rtol 1e-4), params and running stats max abs "
        f"diff {worst:.3e} (1e-5 + 1e-5 |ref|); output against numpy "
        f"{e:.2e} ({CNN_TOL}); conv -> BN -> softmax graph against the "
        f"list container, 3 steps: params and running stats max abs diff "
        f"{cd:.3e} (1e-6)")
    if not e <= CNN_TOL:
        raise AssertionError(f"resnet_tiny output off numpy by {e}")
    if not cd <= 1e-6:
        raise AssertionError(f"conv-BN graph differs from the list "
                             f"container by {cd}")


def phase_graph_lstm(torch, M, card):
    """Phase 25: path 4's char-RNN as a graph against the list container
    on rows 5-6, a masked tBPTT graph on rows 7-8, f32 graph parity with
    the CPU (LSTM and resnet_tiny); returns the launches by run."""
    import numpy as np

    V, H, B, T = (LSTM_LARGE[k] for k in ("vocab", "hidden", "B", "T"))
    res, diff = graph_vs_list(torch, M, V, H, B, T, GRAPH_STEPS)
    for name, (losses, launches, routes, plain, ms) in res.items():
        log(f"  {name}: losses {losses}; step ms "
            f"{[round(t, 2) for t in ms]}; LSTM launches {launches}, by "
            f"route {routes}, plain {plain} [{card}]")
        want = {("fwd", False, False): 2 * GRAPH_STEPS,
                ("bwd", False, False): 2 * GRAPH_STEPS}
        if launches != want or any(plain) or not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: expected {want}, no plain call "
                                 f"and finite losses: {launches}, {plain}, "
                                 f"{losses}")
    gl, ll = res["graph"][0], res["list"][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, ll))
    log(f"  graph against list container, {GRAPH_STEPS} bf16 RMSPROP "
        f"steps: losses max relative difference {rel:.3e} (1e-5), params "
        f"max abs difference {diff:.3e} (lr / 1000 = 1e-4)")
    if not (rel <= 1e-5 and diff <= 1e-4):
        raise AssertionError(f"graph and list container differ: losses "
                             f"{rel}, params {diff}")
    Vs, Hs, Bs, W = (LSTM_SMALL[k] for k in ("vocab", "hidden", "B",
                                             "tbptt"))
    launches, routes, plain, loss, wall = masked_graph_fit(
        torch, M, Vs, Hs, Bs, 2 * W, W)
    log(f"  masked tBPTT graph (path 4b's net, B={Bs} x T={2 * W}, windows "
        f"of {W}, ragged rows): one fit {wall:.2f} ms, loss {loss}; LSTM "
        f"launches {launches}, by route {routes}, plain {plain}")
    want = {("fwd", True, False): 4, ("bwd", True, False): 4}
    if launches != want or any(plain) or not np.isfinite(loss):
        raise AssertionError(f"masked graph: expected {want}, no plain "
                             f"call, a finite loss: {launches}, {plain}, "
                             f"{loss}")
    small_lstm_graph_parity(torch, M)
    resnet_tiny_parity(torch, M)
    return {"chain": res["graph"][1], "masked": launches}


def graph_launches(rows, counts) -> None:
    """Phase 25's launches into rows 5-8 at the shapes that made them:
    the char-RNN graph's at path 4's (T=64, B=2048, H=1024), the masked
    graph's at path 4b's window (T=24, B=8192, H=256)."""
    adds = {"lstm_fwd_t64_b2048_h1024": counts["chain"].get(
                ("fwd", False, False), 0),
            "lstm_bwd_t64_b2048_h1024": counts["chain"].get(
                ("bwd", False, False), 0),
            f"lstm_fwd_masked_t{LSTM_SMALL['tbptt']}_b8192_h256":
                counts["masked"].get(("fwd", True, False), 0),
            f"lstm_bwd_masked_t{LSTM_SMALL['tbptt']}_b8192_h256":
                counts["masked"].get(("bwd", True, False), 0)}
    for row in rows:
        row["launches"] += int(adds.get(row["name"], 0))


# ----------------------------------------- phase 26: pretraining on the card
# Deeplearning4j's MNIST VAE example: 784 -> encoder (256, 256) -> z 2 ->
# decoder (256, 256), Bernoulli reconstruction through a sigmoid, RMSPROP
# 1e-3, l2 1e-4, leaky ReLU, B=128; DeepAutoEncoderExample's RBM stack
# 784-1000-500-250-100-30 and back (k=1), B=1000
VAE_B, VAE_BATCHES, VAE_EPOCHS = 128, 20, 3
DAE_WIDTHS = (784, 1000, 500, 250, 100, 30)
DAE_B, DAE_BATCHES, DAE_EPOCHS = 1000, 3, 3
AE_B, AE_BATCHES, AE_EPOCHS, AE_LR = 128, 4, 2, 0.1


def binarised_templates(np, B, n, seed, d=784, classes=10):
    """Seeded MNIST-shaped binary data: ten 784-pixel binary templates,
    5% of each image's pixels flipped."""
    rng = np.random.default_rng(seed)
    templates = (rng.random((classes, d)) < 0.3).astype(np.float32)
    return [np.abs(templates[rng.integers(0, classes, B)]
                   - (rng.random((B, d)) < 0.05)).astype(np.float32)
            for _ in range(n)]


def vae_conf(M):
    C = M["conf"]
    return (C.NeuralNetConfiguration.Builder().seed(26).learning_rate(1e-3)
            .updater("rmsprop").l2(1e-4).activation("leakyrelu")
            .weight_init("xavier").list()
            .layer(C.VariationalAutoencoder(
                n_out=2, encoder_layer_sizes=(256, 256),
                decoder_layer_sizes=(256, 256), pzx_activation="identity",
                reconstruction_distribution=
                C.BernoulliReconstructionDistribution(activation="sigmoid")))
            .layer(C.OutputLayer(n_out=10, activation="softmax"))
            .set_input_type(C.InputType.feed_forward(784)).build())


def dae_conf(M):
    C = M["conf"]
    b = (C.NeuralNetConfiguration.Builder().seed(27).learning_rate(0.1)
         .list())
    widths = DAE_WIDTHS + DAE_WIDTHS[-2:0:-1]
    for n in widths[1:]:
        b = b.layer(C.RBM(n_out=n, k=1, activation="sigmoid"))
    return (b.layer(C.OutputLayer(n_out=784, loss="mse",
                                  activation="sigmoid"))
            .set_input_type(C.InputType.feed_forward(784)).build())


def np_softplus(np, z):
    return np.logaddexp(0.0, z)


def np_sigmoid(np, z):
    return 1.0 / (1.0 + np.exp(-z))


def np_rbm_cd(np, p, x):
    """A binary RBM's CD-1 surrogate on means, in f64, and its gradient:
    F(v) = -v.vb - sum softplus(v W + b), loss = mean(F(x) - F(v1)), v1
    the mean-field reconstruction (held fixed)."""
    W, b, vb = p["W"], p["b"], p["vb"]
    v1 = np_sigmoid(np, np_sigmoid(np, x @ W + b) @ W.T + vb)

    def free(v):
        return -(v @ vb) - np_softplus(np, v @ W + b).sum(axis=1)

    def dfree(v):
        h = np_sigmoid(np, v @ W + b)
        return {"W": -v.T @ h, "b": -h.sum(0), "vb": -v.sum(0)}

    n = x.shape[0]
    loss = float(np.mean(free(x) - free(v1)))
    g0, g1 = dfree(x), dfree(v1)
    return loss, {k: (g0[k] - g1[k]) / n for k in g0}


def np_vae_elbo(np, p, x, n_enc, n_dec, slope=0.01):
    """The VAE's negative ELBO at eps = 0 in f64 (leaky ReLU layers,
    Bernoulli through a sigmoid): mean(KL(q(z|x) || N(0, I)) - log p(x|
    z = mean))."""
    act = lambda z: np.where(z > 0, z, slope * z)
    h = x
    for i in range(n_enc):
        h = act(h @ p[f"eW{i}"] + p[f"eb{i}"])
    mean = h @ p["ezMeanW"] + p["ezMeanb"]
    log_var = h @ p["ezLogVarW"] + p["ezLogVarb"]
    kl = -0.5 * np.sum(1.0 + log_var - mean ** 2 - np.exp(log_var), axis=1)
    h = mean
    for i in range(n_dec):
        h = act(h @ p[f"dW{i}"] + p[f"db{i}"])
    pre = h @ p["pxzW"] + p["pxzb"]
    rec = np.sum(x * pre - np_softplus(np, pre), axis=1)
    return float(np.mean(kl - rec))


def loss_parity(torch, np, layer, params, x, what):
    """`pretrain_loss(params, x, rng=None)` and its gradient on the card
    against the CPU (f32, TF32 off): (loss rel, worst grad units)."""
    got = {}
    for dev in ("cuda", "cpu"):
        leaves = {k: torch.tensor(v, device=dev, requires_grad=True)
                  for k, v in params.items()}
        loss = layer.pretrain_loss(leaves, torch.tensor(x, device=dev), None)
        g = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
        got[dev] = (float(loss.detach()),
                    {k: np.zeros(v.shape) if gk is None
                     else gk.double().cpu().numpy()
                     for (k, v), gk in zip(params.items(), g)})
    lr = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    ge = max(rel_err(np, got["cuda"][1][k], got["cpu"][1][k])
             for k in params)
    if not (lr <= 1e-5 and ge <= 1e-4):
        raise AssertionError(f"{what} pretrain_loss card vs CPU: loss "
                             f"{lr}, gradients {ge}")
    return got["cpu"][0], got["cpu"][1], lr, ge


def timed_pretrain(torch, net, batches, epochs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(batches, epochs=epochs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ae_stack_conf(M):
    C = M["conf"]
    return (C.NeuralNetConfiguration.Builder().seed(28).learning_rate(AE_LR)
            .list()
            .layer(C.DenseLayer(n_out=256, activation="tanh"))
            .layer(C.AutoEncoder(n_out=64, corruption_level=0.0,
                                 activation="sigmoid"))
            .layer(C.AutoEncoder(n_out=16, corruption_level=0.0,
                                 activation="sigmoid"))
            .layer(C.OutputLayer(n_out=10, activation="softmax"))
            .set_input_type(C.InputType.feed_forward(784)).build())


def ref_greedy_ae(torch, params, xs):
    """The AutoEncoder stack's greedy pretraining written out here, in
    f64 on the CPU: the tanh dense layer frozen; AutoEncoder 1 trained
    first, AE_EPOCHS passes of SGD (lr AE_LR) on the mean squared error of
    sigmoid(sigmoid(x W + b) W^T + vb) against x, then AutoEncoder 2 the
    same way on AutoEncoder 1's output. Returns the final parameters."""
    p = [{k: v.detach().double().cpu().clone() for k, v in d.items()}
         for d in params]

    def feed(x, upto):
        h = torch.tanh(x @ p[0]["W"] + p[0]["b"])
        for j in range(1, upto):
            h = torch.sigmoid(h @ p[j]["W"] + p[j]["b"])
        return h

    for j in (1, 2):
        for _ in range(AE_EPOCHS):
            for x in xs:
                h_in = feed(torch.tensor(x, dtype=torch.float64), j)
                leaves = {k: v.clone().requires_grad_(True)
                          for k, v in p[j].items()}
                h = torch.sigmoid(h_in @ leaves["W"] + leaves["b"])
                r = torch.sigmoid(h @ leaves["W"].T + leaves["vb"])
                g = torch.autograd.grad(((r - h_in) ** 2).mean(),
                                        list(leaves.values()))
                p[j] = {k: v - AE_LR * gk
                        for (k, v), gk in zip(p[j].items(), g)}
    return p


def phase_pretrain(torch, M, card):
    """Phase 26: the VAE at the MNIST VAE example's widths, the
    DeepAutoEncoder RBM stack, pretrain_loss parity with the CPU and
    numpy, an uncorrupted AutoEncoder stack against the greedy
    reference."""
    import numpy as np

    DataSet, ListIt = M["DataSet"], M["ListDataSetIterator"]
    rng = np.random.default_rng(26)
    # VAE
    vae = M["MultiLayerNetwork"](vae_conf(M), device="cuda")
    vae.init()
    layer = vae.layers[0]
    xs = binarised_templates(np, VAE_B, VAE_BATCHES + 1, seed=26)
    held = torch.tensor(xs[-1], device="cuda")
    elbo = lambda: float(layer.pretrain_loss(vae._params[0], held, None))
    before = elbo()
    params = {k: (v.detach().cpu().numpy() + rng.normal(
        scale=0.1, size=tuple(v.shape)).astype(np.float32))
        for k, v in vae._params[0].items()}
    loss_c, _, lr_v, ge_v = loss_parity(torch, np, layer, params, xs[-1],
                                        "VAE")
    ref = np_vae_elbo(np, {k: v.astype(np.float64) for k, v in
                           params.items()}, xs[-1].astype(np.float64), 2, 2)
    e_np = abs(loss_c - ref) / abs(ref)
    wall = timed_pretrain(torch, vae, ListIt([DataSet(x, None)
                                              for x in xs[:-1]]), VAE_EPOCHS)
    after = elbo()
    n = VAE_BATCHES * VAE_EPOCHS
    log(f"  VAE 784-(256,256)-2-(256,256), B={VAE_B}, RMSPROP 1e-3: "
        f"negative ELBO (eps = 0, held-out batch) {before:.4f} -> "
        f"{after:.4f} over {n} steps, {1e3 * wall / n:.3f} ms a pretrain "
        f"step; last sampled score {vae.score_value:.4f} [{card}]; "
        f"pretrain_loss card vs CPU: loss {lr_v:.2e} (1e-5), gradients "
        f"{ge_v:.2e} (1e-4); against numpy f64 {e_np:.2e} (1e-4)")
    if not (e_np <= 1e-4 and after < 0.9 * before
            and np.isfinite(vae.score_value)):
        raise AssertionError(f"VAE: numpy {e_np}, ELBO {before} -> {after}")
    del vae
    # DeepAutoEncoder RBM stack
    dae = M["MultiLayerNetwork"](dae_conf(M), device="cuda")
    dae.init()
    rbm = dae.layers[0]
    xs = binarised_templates(np, DAE_B, DAE_BATCHES + 1, seed=27)
    held = torch.tensor(xs[-1], device="cuda")
    err0 = rbm.reconstruction_error(dae._params[0], held)
    params = {k: (v.detach().cpu().numpy() + rng.normal(
        scale=0.05, size=tuple(v.shape)).astype(np.float32))
        for k, v in dae._params[0].items()}
    loss_c, grads_c, lr_r, ge_r = loss_parity(torch, np, rbm, params,
                                              xs[-1], "RBM")
    ref_loss, ref_grads = np_rbm_cd(np, {k: v.astype(np.float64) for k, v
                                         in params.items()},
                                    xs[-1].astype(np.float64))
    e_rbm = max([abs(loss_c - ref_loss) / abs(ref_loss)]
                + [rel_err(np, grads_c[k], ref_grads[k]) for k in ref_grads])
    wall = timed_pretrain(torch, dae, ListIt([DataSet(x, None)
                                              for x in xs[:-1]]), DAE_EPOCHS)
    err1 = rbm.reconstruction_error(dae._params[0], held)
    n = (len(dae.layers) - 1) * DAE_BATCHES * DAE_EPOCHS
    log(f"  DeepAutoEncoder RBM stack {'-'.join(map(str, DAE_WIDTHS))} and "
        f"back (k=1), B={DAE_B}: first RBM's reconstruction error "
        f"{err0:.4f} -> {err1:.4f}; {n} pretrain steps, "
        f"{1e3 * wall / n:.3f} ms each; pretrain_loss card vs CPU: loss "
        f"{lr_r:.2e}, gradients {ge_r:.2e}; against numpy f64 {e_rbm:.2e} "
        f"(1e-4)")
    if not (e_rbm <= 1e-4 and err1 < 0.9 * err0
            and np.isfinite(dae.score_value)):
        raise AssertionError(f"RBM: numpy {e_rbm}, reconstruction error "
                             f"{err0} -> {err1}")
    del dae
    # uncorrupted AutoEncoder stack: card, CPU and the greedy reference
    xs = binarised_templates(np, AE_B, AE_BATCHES, seed=28)
    nets = {}
    for dev in ("cuda", "cpu"):
        nets[dev] = M["MultiLayerNetwork"](ae_stack_conf(M), device=dev)
        nets[dev].init()
    nets["cuda"].set_params(nets["cpu"].params())
    ref = ref_greedy_ae(torch, nets["cpu"]._params, xs)
    walls = {}
    for dev, net in nets.items():
        t0 = time.perf_counter()
        net.pretrain(ListIt([DataSet(x, None) for x in xs]),
                     epochs=AE_EPOCHS)
        if dev == "cuda":
            torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t0
    worst = {"cpu": 0.0, "ref": 0.0}
    for i, p in enumerate(nets["cuda"]._params):
        for k, v in p.items():
            got = v.double().cpu()
            for what, want in (("cpu", nets["cpu"]._params[i][k].double()),
                               ("ref", ref[i][k])):
                d = (got - want).abs()
                worst[what] = max(worst[what], d.max().item())
                if not bool((d <= 1e-5 + 1e-4 * want.abs()).all()):
                    raise AssertionError(f"AutoEncoder stack layer {i} {k} "
                                         f"off the {what} by "
                                         f"{d.max().item()}")
    n = 2 * AE_BATCHES * AE_EPOCHS
    log(f"  AutoEncoder stack 784-256(frozen)-64-16, corruption 0, SGD "
        f"{AE_LR}: {n} pretrain steps, {1e3 * walls['cuda'] / n:.3f} ms "
        f"each; card against CPU max abs {worst['cpu']:.3e}, against the "
        f"greedy f64 reference {worst['ref']:.3e} (1e-5 + 1e-4 |ref|)")


# ------------------------------------------- phase 27: path 8, disaggregated
# bench.py bench_serve_disagg's two Poisson mixes (bench.py:2026-2035,
# :2038) at path 1's prompt and output lengths (bench.py:1327-1333):
# (prompt length, tokens out), 6 requests each, greedy
DISAGG_MIXES = {"prefill_heavy": (4096, 32), "decode_heavy": (128, 128)}
DISAGG_REQUESTS, DISAGG_INTERARRIVAL = 6, 0.01
# path 8b: a 4096-token prompt migrated once `MIGRATE_AT` tokens are out
MIGRATE_PROMPT, MIGRATE_TOKENS, MIGRATE_AT = 4096, 64, 16
# phase 28: bench.py bench_serve_qos part A (bench.py:1772-1781) at path
# 1's width: 24 interactive requests (prompts of 128, 32 tokens out) with
# Poisson arrivals; a flood tenant quota'd at 60 tokens/s, burst 24, from
# 2 threads, sending bench_serve_qos's 8-token requests (a 32-token
# request could never fit a burst of 24)
QOS_INTERACTIVE, QOS_PROMPT, QOS_TOKENS = 24, 128, 32
QOS_FLOOD = dict(rate=60.0, burst=24.0, threads=2, tokens=8)
QOS_INTERARRIVAL = 0.01
QOS_PREEMPT_TOKENS = 64
# phase 29: path 4's char-RNN (LSTM_LARGE) through EarlyStoppingTrainer:
# 3 epochs of 4 batches, 2 held-out batches; assert_deterministic on path
# 2's GPT at B=2 x T=4096 and on the char-RNN, 3 steps each
ES_EPOCHS, ES_BATCHES, ES_HELD = 3, 4, 2
DET_STEPS, DET_GPT_B = 3, 2


def path1_net(torch, M, compute_dtype):
    """Path 1's GPT (phase 7's network: the same seed, so the same
    weights) in `compute_dtype` over f32 masters (None: f32)."""
    net = M["MultiLayerNetwork"](M["gpt_configuration"](**SERVE, seed=11),
                                 dtype=torch.float32,
                                 compute_dtype=compute_dtype, device="cuda")
    net.init()
    return net


def until(pred, what, timeout=600.0, tick=0.002):
    """Wait for `pred()`, polled every `tick` s, within `timeout` s, or
    fail naming `what`."""
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(tick)


def poisson_run(np, fn, prompts, n_tokens, seed, gap):
    """Each request on its own thread, started at seeded Poisson arrival
    times (mean gap `gap` s): (results in order, wall s, per-request
    latency s from its arrival)."""
    import threading

    arrivals = np.cumsum(np.random.default_rng(seed).exponential(
        gap, len(prompts)))
    out = [None] * len(prompts)
    done = [None] * len(prompts)
    t0 = time.perf_counter()

    def one(i):
        try:
            out[i] = fn(prompts[i], n_tokens)
        except BaseException as e:  # raised to the caller below
            out[i] = e
        done[i] = time.perf_counter()

    threads = []
    for i in range(len(prompts)):
        lag = t0 + arrivals[i] - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        threads.append(threading.Thread(target=one, args=(i,)))
        threads[-1].start()
    for t in threads:
        t.join(900.0)
        if t.is_alive():
            raise AssertionError("a request thread did not finish")
    wall = time.perf_counter() - t0
    for r in out:
        if isinstance(r, BaseException):
            raise r
    return out, wall, [done[i] - (t0 + arrivals[i])
                       for i in range(len(prompts))]


def ledger_whole(eng, what):
    """Free pages, pages owned by slots and leases, and prefix-cache
    pages are `pool_pages` distinct ids: none freed twice, none lost."""
    with eng._cond:
        ids = list(eng._free_pages)
        for r in eng._slots:
            if r is not None and r.pages:
                ids += r.pages[r.n_shared:]
        for lease in eng._leases._leases.values():
            if lease.pages:
                ids += lease.pages[lease.n_shared:]
        if eng._prefix_cache is not None:
            ids += [n.page_id for n in eng._prefix_cache._nodes.values()]
    if not len(ids) == len(set(ids)) == eng.pool_pages:
        raise AssertionError(f"{what}: page ledger broken ({len(ids)} ids, "
                             f"{len(set(ids))} distinct, pool "
                             f"{eng.pool_pages})")


def roles_check(co, what):
    """The prefill server only prefills, the decode server only decodes,
    and both ledgers are whole."""
    pre = co.prefill[0]._engine.stats()
    dec = co.decode[0]._engine.stats()
    if pre["decode_steps"] or not pre["prefills"] or dec["prefills"] \
            or not dec["decode_steps"]:
        raise AssertionError(f"{what}: roles crossed (prefill server "
                             f"{pre['prefills']} prefills, "
                             f"{pre['decode_steps']} decode steps; decode "
                             f"server {dec['prefills']} prefills, "
                             f"{dec['decode_steps']} decode steps)")
    for srv in co._servers:
        ledger_whole(srv._engine, what)
    return pre, dec


def disagg_mix(np, co, srv, prompts, n, seed, what, card):
    """One mix through the colocated server and the coordinator: the
    tokens must be equal; the tokens/s of each and the mix's handoff
    figures."""
    b0, s0, h0, f0 = (co.transfer_bytes, co.transfer_seconds, co.handoffs,
                      co.fallbacks)
    col, col_wall, _ = poisson_run(np, srv.generate, prompts, n, seed,
                                   DISAGG_INTERARRIVAL)
    dis, dis_wall, _ = poisson_run(np, co.generate, prompts, n, seed,
                                   DISAGG_INTERARRIVAL)
    for i, (a, b) in enumerate(zip(col, dis)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: request {i} disaggregated "
                                 f"{b[:8]}... != colocated {a[:8]}...")
    toks = sum(len(t) for t in col)
    mb = (co.transfer_bytes - b0) / 1e6
    secs = co.transfer_seconds - s0
    handoffs, fallbacks = co.handoffs - h0, co.fallbacks - f0
    log(f"  {what}: {len(prompts)} requests of {len(prompts[0])} + {n}: "
        f"colocated {toks / col_wall:.1f} tokens/s ({col_wall:.3f} s), "
        f"disaggregated {toks / dis_wall:.1f} tokens/s ({dis_wall:.3f} s), "
        f"ratio {col_wall / dis_wall:.3f}; handoffs {handoffs}, fallbacks "
        f"{fallbacks}; kv_transfer_mbytes {mb:.3f}, "
        f"{mb / secs if secs else 0.0:.1f} MB/s over {secs:.3f} s of "
        f"resume; tokens equal [{card}]")
    if handoffs != len(prompts) or fallbacks:
        raise AssertionError(f"{what}: {handoffs} handoffs, {fallbacks} "
                             "fallbacks")
    return mb, secs


def phase_disagg(torch, M, pa, card):
    """Path 8a: path 1's network behind a `DisaggCoordinator` (one
    prefill-role and one decode-role `ModelServer` on the card) and one
    colocated `ModelServer`, both with path 1's engine settings: the two
    mixes in bf16, then the decode-heavy one with int8 KV. Every
    disaggregated request's tokens equal the colocated server's; 0
    fallbacks; the roles stay apart. Returns the paged kernel's launches
    over the timed runs."""
    import numpy as np

    S = M["serving"]
    V = SERVE["vocab_size"]
    net = path1_net(torch, M, torch.bfloat16)
    rng = np.random.default_rng(27)
    mixes = {m: [rng.integers(0, V, t0) for _ in range(DISAGG_REQUESTS)]
             for m, (t0, _) in DISAGG_MIXES.items()}
    launches: dict = {}
    for kv in (None, "int8"):
        gen = dict(SERVER_GEN, max_queue=256)
        if kv:
            gen["quantize"] = {"kv": kv}
        srv = S.ModelServer(net, generation=gen)
        co = S.DisaggCoordinator(net, server_kwargs={"generation": gen})
        try:
            srv.generate(mixes["decode_heavy"][0][:16], 4)  # warm-up
            co.generate(mixes["decode_heavy"][0][:16], 4)
            torch.cuda.synchronize()
            pa.reset_counts()
            mbs = {}
            for m, (t0, n) in DISAGG_MIXES.items():
                if kv and m != "decode_heavy":
                    continue
                mbs[m] = disagg_mix(np, co, srv, mixes[m], n, 28,
                                    f"{m} {kv or 'bf16'}", card)
            got = dict(pa.paged_attention.launches_by)
            pre, dec = roles_check(co, f"path 8a {kv or 'bf16'}")
            st = co.stats()
        finally:
            co.shutdown()
            srv.shutdown()
        log(f"  {kv or 'bf16'} KV: paged launches {got}; prefill server "
            f"{pre['prefills']} prefills, {pre['prefill_chunks']} chunks, "
            f"{pre['migrations_out']} exports; decode server "
            f"{dec['decode_steps']} decode steps, {dec['migrations_in']} "
            f"imports; coordinator handoffs {st['handoffs']}, fallbacks "
            f"{st['fallbacks']}, kv_transfer_mbytes "
            f"{st['kv_transfer_mbytes']:.3f}, "
            f"{st['kv_transfer_mbytes_per_sec']:.1f} MB/s")
        kind = "int8" if kv else "dense"
        want = [(1, kind)] + ([] if kv else [(256, kind)])
        if any(got.get(k, 0) == 0 for k in want) \
                or any(k != kind for _, k in got):
            raise AssertionError(f"path 8a: paged kernel launches {got}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    del net
    torch.cuda.empty_cache()
    return launches


def resume_timed(dst, payload):
    """Resume `payload` on `dst`: (tail tokens, ms from the call to the
    first tail token)."""
    first = []

    def sink(cursor, tok, entry):
        if not first:
            first.append(time.perf_counter())

    t0 = time.perf_counter()
    tail = dst.resume_generate(payload, timeout=900, on_token=sink)
    return tail, 1e3 * (first[0] - t0)


def migrate_once(np, src, prompt, exc, **kw):
    """Submit on `src`, migrate once MIGRATE_AT tokens are out: (the
    redirect, its payload, export ms)."""
    req = src.submit(prompt, MIGRATE_TOKENS, timeout=900, **kw)
    until(lambda: len(req.tokens) >= MIGRATE_AT, "tokens before migration")
    t0 = time.perf_counter()
    src.migrate_slots(wait=120)
    try:
        req.result(timeout=120)
    except exc as e:
        ms = 1e3 * (time.perf_counter() - t0)
        return e, src.fetch_handoff(e.handoff_id), ms
    raise AssertionError("the request finished before its migration")


def cold_of(payload):
    """The degradation ladder's cold variant of a warm payload: no
    pages; the receiver re-prefills the prompt and the emitted tokens."""
    out = {k: v for k, v in payload.items()
           if k not in ("blocks", "sums", "dtypes")}
    out.update(kind="cold", blocks=[], sums=[], pages_shipped=0,
               pages_omitted=0)
    return out


def flip_last_page(np, payload):
    """A copy of `payload` with one byte of its last page of V flipped
    in its last block."""
    blocks = [dict(b) for b in payload["blocks"]]
    v = np.array(blocks[-1]["v"], copy=True)
    v[-1].reshape(-1).view(np.uint8)[5] ^= 0x40
    blocks[-1]["v"] = v
    return dict(payload, blocks=blocks)


def first_divergence(ref_tokens, ref_lp, got):
    for i, (a, b) in enumerate(zip(ref_tokens, got)):
        if a != b:
            tl = ref_lp[i]["top_logprobs"]
            return i, tl[0] - tl[1]
    return None


def phase_migration(torch, M, pa, card):
    """Path 8b: a 4096-token prompt migrated mid-decode between two of
    path 1's engines: warm in bf16 and int8 (bit-identical to the
    uninterrupted run), one sampled request (temperature 1.0) warm (its
    uninterrupted run's tokens), and cold (re-prefill): held to the
    uninterrupted run in f32 pools, its first divergence and the top-2
    margin there printed in bf16. Resume ms warm against cold; page
    ledgers. Returns the paged launches of the bf16 and int8 legs."""
    import numpy as np

    S = M["serving"]
    Eng = M["DecodeEngine"]
    V = SERVE["vocab_size"]
    prompt = np.random.default_rng(81).integers(0, V, MIGRATE_PROMPT)
    gen = dict(SERVER_GEN, logprobs=2)
    # f32 pools: the cold resume recomputes the KV and must reproduce
    net32 = path1_net(torch, M, None)
    src, dst = Eng(net32, **gen), Eng(net32, **gen)
    try:
        ref = src.generate(prompt, MIGRATE_TOKENS, logprobs=2)
        red, payload, _ = migrate_once(np, src, prompt, S.SlotMigratedError)
        warm, warm_ms = resume_timed(dst, payload)
        cold, cold_ms = resume_timed(dst, cold_of(payload))
        src.commit_handoff(red.handoff_id)
        for what, tail in (("warm", warm), ("cold", cold)):
            got = np.concatenate([red.tokens, tail])
            if not np.array_equal(got, ref["tokens"]):
                raise AssertionError(
                    f"path 8b f32 {what} resume: first divergence "
                    f"{first_divergence(ref['tokens'], ref['logprobs'], got)}")
        for e in (src, dst):
            ledger_whole(e, "path 8b f32")
        log(f"  f32 pools: warm resume {warm_ms:.1f} ms, cold (re-prefill "
            f"of {MIGRATE_PROMPT} + {len(red.tokens)}) {cold_ms:.1f} ms; "
            f"both equal the uninterrupted run [{card}]")
    finally:
        src.shutdown()
        dst.shutdown()
    del net32
    torch.cuda.empty_cache()
    net = path1_net(torch, M, torch.bfloat16)
    pa.reset_counts()
    for kv in (None, "int8"):
        g = dict(gen, quantize={"kv": kv}) if kv else gen
        src, dst = Eng(net, **g), Eng(net, **g)
        try:
            ref = src.generate(prompt, MIGRATE_TOKENS, logprobs=2)
            red, payload, export_ms = migrate_once(np, src, prompt,
                                                   S.SlotMigratedError)
            nbytes = M["kv_transfer"].payload_nbytes(payload)
            t0 = time.perf_counter()
            M["kv_transfer"].verify_payload(payload)
            verify_ms = 1e3 * (time.perf_counter() - t0)
            if kv is None:
                # one flipped byte in the last shipped page is refused,
                # typed, before anything binds
                try:
                    dst.resume_generate(flip_last_page(np, payload),
                                        timeout=900)
                except S.KVTransferError as e:
                    if "checksum" not in str(e):
                        raise AssertionError(f"path 8b: {e}")
                except S.ServingError as e:
                    raise AssertionError(f"path 8b: a corrupted last page "
                                         f"was accepted ({e})")
                else:
                    raise AssertionError("path 8b: a corrupted last page "
                                         "was accepted")
            warm, warm_ms = resume_timed(dst, payload)
            got = np.concatenate([red.tokens, warm])
            if not np.array_equal(got, ref["tokens"]):
                raise AssertionError(
                    f"path 8b {kv or 'bf16'} warm resume differs from the "
                    f"uninterrupted run: "
                    f"{first_divergence(ref['tokens'], ref['logprobs'], got)}")
            line = (f"  {kv or 'bf16'}: {payload['pages_shipped']} pages, "
                    f"{nbytes / 2**20:.1f} MiB; export (migrate_slots to "
                    f"redirect) {export_ms:.1f} ms, verify_payload "
                    f"{verify_ms:.1f} ms, warm resume {warm_ms:.1f} ms: "
                    "bit-identical")
            if kv is None:
                cold, cold_ms = resume_timed(dst, cold_of(payload))
                div = first_divergence(ref["tokens"], ref["logprobs"],
                                       np.concatenate([red.tokens, cold]))
                line += (f"; cold resume {cold_ms:.1f} ms: "
                         + ("equal" if div is None else
                            f"first divergence at token {div[0]}, top-2 "
                            f"log-probability margin there {div[1]:.4f}"))
            src.commit_handoff(red.handoff_id)
            if kv is None:
                # a sampled request keeps its generator through the move
                want = src.generate(prompt, MIGRATE_TOKENS, temperature=1.0,
                                    seed=3)
                red, payload, _ = migrate_once(np, src, prompt,
                                               S.SlotMigratedError,
                                               temperature=1.0, seed=3)
                tail, _ = resume_timed(dst, payload)
                src.commit_handoff(red.handoff_id)
                if not np.array_equal(np.concatenate([red.tokens, tail]),
                                      want):
                    raise AssertionError("path 8b: a sampled request "
                                         "migrated warm left its stream")
                line += "; sampled (temperature 1.0) warm: equal"
            for e in (src, dst):
                st = e.stats()
                if st["pages_in_use"] or st["handoff_leases"]:
                    raise AssertionError(f"path 8b: {st['pages_in_use']} "
                                         f"pages, {st['handoff_leases']} "
                                         "leases left")
                ledger_whole(e, "path 8b")
            log(line + f"; ledgers whole, pages in use 0 [{card}]")
        finally:
            src.shutdown()
            dst.shutdown()
    launches = dict(pa.paged_attention.launches_by)
    log(f"  paged launches (bf16 and int8 legs): {launches}")
    for k in ((1, "dense"), (256, "dense"), (1, "int8"), (256, "int8")):
        if not launches.get(k):
            raise AssertionError(f"path 8b: no paged launch at {k}: "
                                 f"{launches}")
    torch.cuda.empty_cache()
    return net, launches


def phase_prefix_cluster(torch, M, pa, card, net):
    """Path 8c: path 3's shared-prefix traffic (a 1024-token system
    prompt, 64-token tails; bench.py:1335-1340) through
    `DisaggCoordinator(prefill_replicas=2, prefix_cluster=True)` against
    `prefix_cluster=False`, sequentially: identical tokens, 0 fallbacks;
    the delta pages skipped and the MB shipped, full against delta."""
    import numpy as np

    S = M["serving"]
    V = SERVE["vocab_size"]
    rng = np.random.default_rng(83)
    shared = rng.integers(0, V, SHARED_PREFIX)
    prompts = [np.concatenate([shared, rng.integers(0, V, SHARED_TAIL)])
               for _ in range(SHARED_REQUESTS)]
    n_tok = [int(x) for x in rng.choice((32, 64), SHARED_REQUESTS)]
    gen = dict(SERVER_GEN, prefix_cache=True)
    outs, stats = {}, {}
    pa.reset_counts()
    for cluster in (False, True):
        co = S.DisaggCoordinator(net, prefill_replicas=2,
                                 server_kwargs={"generation": gen},
                                 prefix_cluster=cluster, frame_pages=8)
        try:
            t0 = time.perf_counter()
            outs[cluster] = [co.generate(p, n, timeout=900)
                             for p, n in zip(prompts, n_tok)]
            wall = time.perf_counter() - t0
            st = co.stats()
            fetches = sum(s.get("generation", {}).get("prefix_fetches", 0)
                          for s in st["prefill"] + st["decode"])
            for srv in co._servers:
                if srv._engine is not None:
                    ledger_whole(srv._engine, "path 8c")
        finally:
            co.shutdown()
        stats[cluster] = st
        log(f"  prefix_cluster={cluster}: {SHARED_REQUESTS} requests in "
            f"{wall:.3f} s; handoffs {st['handoffs']}, fallbacks "
            f"{st['fallbacks']}, kv_transfer_mbytes "
            f"{st['kv_transfer_mbytes']:.3f}, delta_pages_skipped "
            f"{st['delta_pages_skipped']}, affinity_routes "
            f"{st['affinity_routes']}, prefix fetches {fetches} [{card}]")
        if st["handoffs"] != SHARED_REQUESTS or st["fallbacks"]:
            raise AssertionError(f"path 8c: {st['handoffs']} handoffs, "
                                 f"{st['fallbacks']} fallbacks")
    for i, (a, b) in enumerate(zip(outs[False], outs[True])):
        if not np.array_equal(a, b):
            raise AssertionError(f"path 8c: request {i} differs with the "
                                 "cluster prefix cache")
    full, delta = (stats[c]["kv_transfer_mbytes"] for c in (False, True))
    log(f"  MB shipped full {full:.3f} against delta {delta:.3f} "
        f"({delta / full:.3f} of full); tokens identical")
    if not stats[True]["delta_pages_skipped"]:
        raise AssertionError("path 8c: no delta handoff skipped a page")
    return dict(pa.paged_attention.launches_by)


def phase_qos(torch, M, pa, card, net):
    """Phase 28: bench_serve_qos part A on path 1's engine: the flood
    tenant's requests meet only its own `TenantQuotaExceededError`, no
    interactive request fails; interactive p99 flooded against
    unloaded, the batch lane's share of tokens, preemptions. Then one
    preempted greedy batch request against its unpreempted run: equal in
    f32 pools (asserted), and in bf16 (printed)."""
    import threading

    import numpy as np

    S = M["serving"]
    V = SERVE["vocab_size"]
    rng = np.random.default_rng(28)
    prompts = [rng.integers(0, V, QOS_PROMPT) for _ in range(QOS_INTERACTIVE)]
    eng = M["DecodeEngine"](
        net, **dict(SERVER_GEN, max_queue=256, max_queued_pages=10 ** 9),
        qos={"tenants": {"flood": {"rate": QOS_FLOOD["rate"],
                                   "burst": QOS_FLOOD["burst"]}},
             "preempt": True, "slo_shed": True})

    def interactive(seed):
        out, wall, lats = poisson_run(
            np, lambda p, n: eng.generate(p, n, timeout=120, tenant="user",
                                          priority="interactive"),
            prompts, QOS_TOKENS, seed, QOS_INTERARRIVAL)
        if any(len(o) != QOS_TOKENS for o in out):
            raise AssertionError("phase 28: an interactive request came "
                                 "back short")
        return lats

    flood = {"served": 0, "quota": 0, "other": []}
    stop = threading.Event()

    def flooder():
        while not stop.is_set():
            try:
                eng.generate(prompts[0], QOS_FLOOD["tokens"], timeout=5.0,
                             tenant="flood", priority="batch")
                flood["served"] += 1
            except S.TenantQuotaExceededError as e:
                flood["quota"] += 1
                time.sleep(min(e.retry_after or 0.01, 0.05))
            except Exception as e:  # counted: the check below fails on it
                flood["other"].append(repr(e))

    try:
        interactive(1)  # warm-up
        pa.reset_counts()
        base = interactive(2)
        pre = eng.stats()
        threads = [threading.Thread(target=flooder)
                   for _ in range(QOS_FLOOD["threads"])]
        for t in threads:
            t.start()
        try:
            flooded = interactive(2)
            # the quota must have bitten: the flood runs on until it has
            until(lambda: flood["quota"] > 0, "a quota rejection", 60.0)
        finally:
            stop.set()
            for t in threads:
                t.join(60.0)
        post = eng.stats()
        launches = dict(pa.paged_attention.launches_by)
        ledger_whole(eng, "phase 28")
    finally:
        eng.shutdown()
    p99 = [float(np.percentile(x, 99)) * 1e3 for x in (base, flooded)]
    flood_toks = post["tenants"]["flood"]["tokens_generated"] \
        - pre["tenants"].get("flood", {}).get("tokens_generated", 0)
    total = post["tokens_generated"] - pre["tokens_generated"]
    log(f"  interactive p99 {p99[0]:.1f} ms unloaded, {p99[1]:.1f} ms "
        f"flooded (ratio {p99[1] / p99[0]:.3f}); p50 "
        f"{float(np.percentile(base, 50)) * 1e3:.1f} / "
        f"{float(np.percentile(flooded, 50)) * 1e3:.1f} ms; batch lane "
        f"{100.0 * flood_toks / max(1, total):.1f}% of {total} tokens; "
        f"flooder: {flood['served']} served, {flood['quota']} quota "
        f"rejections, {len(flood['other'])} other errors; preemptions "
        f"{post['preemptions'] - pre['preemptions']}, slo sheds "
        f"{post['slo_sheds']} [{card}]")
    if flood["other"] or not flood["quota"]:
        raise AssertionError(f"phase 28: the flooder met {flood['other'][:3]}"
                             f" ({flood['quota']} quota rejections)")
    # a migrated request is not billed again by its receiver: the
    # receiver's bucket could not pay for it
    billed = {"rate": 0.001, "burst": float(QOS_TOKENS)}
    src = M["DecodeEngine"](net, **SERVER_GEN,
                            qos={"tenants": {"billed": billed}})
    dst = M["DecodeEngine"](net, **SERVER_GEN,
                            qos={"tenants": {"billed": dict(billed,
                                                            burst=8.0)}})
    try:
        req = src.submit(prompts[5], QOS_TOKENS, tenant="billed")
        until(lambda: len(req.tokens) >= 4, "billed tokens")
        src.migrate_slots(wait=120)
        try:
            req.result(timeout=120)
            raise AssertionError("phase 28: the billed request finished "
                                 "before its migration")
        except S.SlotMigratedError as e:
            red = e
        try:
            tail = dst.resume_generate(src.fetch_handoff(red.handoff_id))
        except S.TenantQuotaExceededError as e:
            raise AssertionError(f"phase 28: the receiver billed a migrated "
                                 f"request ({e})")
        src.commit_handoff(red.handoff_id)
        if len(red.tokens) + len(tail) != QOS_TOKENS \
                or dst.stats()["tenants"]["billed"]["shed_quota"]:
            raise AssertionError("phase 28: the receiver billed a migrated "
                                 "request")
        for e in (src, dst):
            ledger_whole(e, "phase 28 migration")
    finally:
        src.shutdown()
        dst.shutdown()
    log(f"  a tenant's request migrated to an engine whose bucket holds "
        f"8 of its {QOS_TOKENS} tokens: resumed, not billed again")
    # one preempted batch request against its unpreempted run: greedy,
    # and sampled (its generator kept through the preemption; a random
    # network's greedy tokens may repeat one id, the sampled ones do not)
    for cdt in (None, torch.bfloat16):
        pnet = net if cdt is not None else path1_net(torch, M, None)
        e = M["DecodeEngine"](pnet, **dict(SERVER_GEN, n_slots=1),
                              qos={"preempt": True})
        try:
            for temp in (0.0, 1.0):
                p_batch, p_int = prompts[3], prompts[4]
                ref = e.generate(p_batch, QOS_PREEMPT_TOKENS,
                                 temperature=temp, seed=9)
                n0 = e.stats()["preemptions"]
                victim = e.submit(p_batch, QOS_PREEMPT_TOKENS,
                                  temperature=temp, seed=9, tenant="bulk",
                                  priority="batch")
                until(lambda: len(victim.tokens) >= 8, "batch tokens")
                e.generate(p_int, 8, tenant="live", priority="interactive")
                got = victim.result(timeout=120)
                n_pre = e.stats()["preemptions"] - n0
                same = np.array_equal(got, ref)
                log(f"  preempted {'greedy' if temp == 0 else 'sampled'} "
                    f"batch request ({'f32' if cdt is None else 'bf16'} "
                    f"pools, {n_pre} preemption, {len(set(ref.tolist()))} "
                    "distinct tokens): "
                    + ("equal to its unpreempted run" if same else
                       f"first divergence at token "
                       f"{int(np.flatnonzero(got != ref)[0])}"))
                if n_pre != 1 or (cdt is None and not same):
                    raise AssertionError(f"phase 28: {n_pre} preemptions, "
                                         f"equal {same}")
            ledger_whole(e, "phase 28 preemption")
        finally:
            e.shutdown()
        if cdt is None:
            del pnet
            torch.cuda.empty_cache()
    if not launches.get((1, "dense")):
        raise AssertionError(f"phase 28: paged launches {launches}")
    return launches


def trace_kernel_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events
            if str(e.get("cat", "")).lower() == "kernel"}


def phase_extras(torch, M, card):
    """Phase 29: `EarlyStoppingTrainer` drives path 4's char-RNN (bf16
    over f32 masters, B=2048 x T=64, f32 one-hot rows) for
    MaxEpochsTerminationCondition(3), 4 batches an epoch, a
    DataSetLossCalculator on 2 held-out batches and a LocalFileModelSaver:
    the best model restored from its zip scores what the result recorded;
    a ProfilerListener(sync=True) gives p50/p90 step ms, an
    XlaTraceListener over 2 iterations a Chrome trace holding the LSTM
    kernels. Then `assert_deterministic` bit-exact on path 2's GPT (B=2 x
    T=4096, 3 steps: the flash kernels) and on the char-RNN (3 steps: the
    LSTM kernels); resnet_tiny's verdict under cuDNN's defaults printed.
    Returns the LSTM and flash launch counts."""
    import tempfile

    import numpy as np

    ES, prof, det = M["earlystopping"], M["profiler"], M["determinism"]
    L, fa = M["lstm"], M["fa"]
    DataSet, It = M["DataSet"], M["ListDataSetIterator"]
    V, H, B, T = (LSTM_LARGE[k] for k in ("vocab", "hidden", "B", "T"))
    ids = np.random.default_rng(29).integers(0, V, (ES_BATCHES + ES_HELD, B,
                                                    T + 1))
    eye = np.eye(V, dtype=np.float32)
    batches = [DataSet(eye[i[:, :-1]], i[:, 1:].astype(np.int32))
               for i in ids]
    train, held = batches[:ES_BATCHES], batches[ES_BATCHES:]

    def char_rnn():
        net = M["MultiLayerNetwork"](char_rnn_conf(M, V, H, seed=1),
                                     dtype=torch.float32,
                                     compute_dtype=torch.bfloat16,
                                     device="cuda")
        net.init()
        return net

    net = char_rnn()
    net.fit(train[0])  # warm-up: handles, allocator
    torch.cuda.synchronize()
    timer = prof.ProfilerListener(sync=True)
    with tempfile.TemporaryDirectory() as d:
        tracer = prof.XlaTraceListener(os.path.join(d, "trace"),
                                       start_iteration=net.iteration + 5,
                                       num_iterations=2)
        net.set_listeners(timer, tracer)
        cfg = (ES.EarlyStoppingConfiguration.Builder()
               .epoch_termination_conditions(
                   ES.MaxEpochsTerminationCondition(ES_EPOCHS))
               .score_calculator(ES.DataSetLossCalculator(It(held)))
               .model_saver(ES.LocalFileModelSaver(os.path.join(d, "es")))
               .build())
        L.reset_counts()
        t0 = time.perf_counter()
        res = ES.EarlyStoppingTrainer(cfg, net, It(train)).fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        es_counts = (dict(L.launches), dict(L.launches_by_route))
        tracer.stop()
        names = trace_kernel_names(tracer.trace_path)
        best = res.best_model
        if best is None:
            raise AssertionError("phase 29: the saver restored no best "
                                 "model")
        # a zip holds no compute dtype: the best model loads computing in
        # f32, as the reference's does; given the run's bf16 compute back
        # it scores exactly what the result recorded
        restored_dtype = best.compute_dtype
        best.compute_dtype = torch.bfloat16
        rescore = ES.DataSetLossCalculator(It(held)).calculate_score(best)
        restored_device = str(best.device)
    s = timer.summary()
    lstm_names = sorted(n for n in names if "lstm" in n.lower())
    log(f"  early stopping: {res.termination_reason.value} "
        f"({res.termination_details}), {res.total_epochs} epochs in "
        f"{wall:.2f} s; held-out scores {res.score_vs_epoch}; best epoch "
        f"{res.best_model_epoch} ({res.best_model_score!r}), restored from "
        f"its zip on {restored_device} computing in {restored_dtype} (f32), "
        f"in bf16 scoring {rescore!r}; step ms p50 "
        f"{s['p50_ms']:.2f}, p90 {s['p90_ms']:.2f} over {s['iterations']} "
        f"intervals [{card}]")
    log(f"  LSTM launches {es_counts[0]}, by route {es_counts[1]}; traced "
        f"2 iterations: {len(names)} kernel names, LSTM kernels "
        f"{lstm_names[:4]}")
    if res.termination_reason.value != "epoch_termination_condition" \
            or res.total_epochs != ES_EPOCHS \
            or not all(np.isfinite(list(res.score_vs_epoch.values()))):
        raise AssertionError(f"phase 29: early stopping result {res}")
    if rescore != res.best_model_score or restored_dtype is not None:
        raise AssertionError(f"phase 29: the restored best model computes "
                             f"in {restored_dtype} and scores {rescore!r} in "
                             f"bf16, the result {res.best_model_score!r}")
    if net.listeners != [timer, tracer] or not lstm_names:
        raise AssertionError(f"phase 29: listeners {net.listeners}, LSTM "
                             f"kernels in the trace {lstm_names}")
    del net, best
    torch.cuda.empty_cache()
    # determinism on the kernels
    L.reset_counts()
    fa.reset_counts()
    t0 = time.perf_counter()
    det.assert_deterministic(char_rnn, train[:DET_STEPS])
    rnn_s = time.perf_counter() - t0
    lstm_counts = dict(L.launches)

    def gpt():
        net = M["MultiLayerNetwork"](M["gpt_configuration"](**TRAIN, seed=13),
                                     dtype=torch.float32,
                                     compute_dtype=torch.bfloat16,
                                     device="cuda")
        net.init()
        return net

    gbatches = [DataSet(x, y) for x, y in gpt_batches(
        np, TRAIN["vocab_size"], DET_GPT_B, TRAIN_T, DET_STEPS, seed=31)]
    t0 = time.perf_counter()
    det.assert_deterministic(gpt, gbatches)
    gpt_s = time.perf_counter() - t0
    flash_counts = {"fwd": fa.flash_forward.launches,
                    "dq": fa.flash_bwd_dq.launches,
                    "dkv": fa.flash_bwd_dkv.launches}
    routes = dict(fa.launches_by_route)
    want = 2 * DET_STEPS * TRAIN["n_layers"]
    if routes != {(k, "wgmma"): want for k in flash_counts}:
        raise AssertionError(f"phase 29: flash launches {routes}")
    log(f"  assert_deterministic bit-exact: char-RNN {DET_STEPS} steps x 2 "
        f"runs ({rnn_s:.1f} s, LSTM launches {lstm_counts}); path 2's GPT "
        f"B={DET_GPT_B} x T={TRAIN_T} {DET_STEPS} steps x 2 runs "
        f"({gpt_s:.1f} s, flash launches {routes})")
    # resnet_tiny under cuDNN's default algorithms: printed, not asserted
    cif = [DataSet(x.astype(np.float32) / 255.0, y)
           for x, y in cifar_batches(np, 64, DET_STEPS, seed=37, hw=8)]
    try:
        det.assert_deterministic(
            lambda: M["ComputationGraph"](M["resnet_tiny_configuration"](),
                                          device="cuda"), cif)
        verdict = "bit-exact"
    except AssertionError as e:
        verdict = f"not bit-exact ({e})"
    log(f"  resnet_tiny (f32, cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}, cudnn.deterministic "
        f"{torch.backends.cudnn.deterministic}), {DET_STEPS} steps x 2 "
        f"runs: {verdict}")
    torch.cuda.empty_cache()
    return {"es": es_counts[0], "det": lstm_counts}, flash_counts


def cluster_launches(rows, paged, extras) -> None:
    """Phases 27-29's launches into the timing rows: the paged kernel's
    at C=1 and C=256, dense and int8, into rows 1 and 1q; phase 29's
    LSTM launches (bf16, T=64, B=2048, H=1024) into rows 5-6, its flash
    launches (bf16, D=128, T=4096) into rows 2-4."""
    lstm, flash = extras
    adds = {"paged_attention_decode": paged.get((1, "dense"), 0),
            "paged_attention_prefill_chunk": paged.get((256, "dense"), 0),
            "paged_attention_int8_decode": paged.get((1, "int8"), 0),
            "paged_attention_int8_prefill_chunk": paged.get((256, "int8"), 0),
            "lstm_fwd_t64_b2048_h1024": sum(
                c.get(("fwd", False, False), 0) for c in lstm.values()),
            "lstm_bwd_t64_b2048_h1024": sum(
                c.get(("bwd", False, False), 0) for c in lstm.values()),
            "flash_attention_fwd": flash["fwd"],
            "flash_attention_bwd_dq": flash["dq"],
            "flash_attention_bwd_dkv": flash["dkv"]}
    for row in rows:
        row["launches"] += int(adds.get(row["name"], 0))


def phases_27_29(torch, M, pa, card):
    """Phases 27-29 in order; returns (paged launches, phase 29's)."""
    paged: dict = {}

    def add(counts):
        for k, n in counts.items():
            paged[k] = paged.get(k, 0) + n

    log("[27/43] path 8: path 1's GPT disaggregated (8a: the two mixes, "
        "bf16 and int8 KV, against a colocated server), live migration "
        "(8b: warm, cold, sampled, int8), the cluster prefix cache (8c)")
    add(phase_disagg(torch, M, pa, card))
    net, counts = phase_migration(torch, M, pa, card)
    add(counts)
    add(phase_prefix_cluster(torch, M, pa, card, net))
    log("[28/43] QoS on path 1's engine: a flood tenant under quota beside "
        "Poisson interactive traffic, preemption of the batch lane")
    add(phase_qos(torch, M, pa, card, net))
    del net
    torch.cuda.empty_cache()
    log("[29/43] early stopping, the profiler and assert_deterministic on "
        "the LSTM and flash kernels")
    extras = phase_extras(torch, M, card)
    return paged, extras


def phases_27_29_alone(torch, M, pa, cuda_build) -> int:
    """`--phases-27-29`: phases 27-29 alone (every source built first),
    then one JSON line of their launch counts."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.build(KERNEL_SOURCES)
    log(f"phases 27-29 alone [{card}]; build {time.perf_counter() - t0:.1f} "
        "s")
    paged, (lstm, flash) = phases_27_29(torch, M, pa, card)
    log(f"phases 27-29 {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card,
                      "paged": {",".join(map(str, k)): n
                                for k, n in paged.items()},
                      "lstm": {w: {",".join(map(str, k)): n
                                   for k, n in c.items()}
                               for w, c in lstm.items()},
                      "flash": flash}), flush=True)
    return 0


# ------------------------------------------- phases 30-31: path 9, the pool
# path 9: path 1's network and engine behind ReplicaPool.from_net(net, 3)
POOL_REPLICAS, POOL_PROBE_S = 3, 1.0
# path 9's network: path 1's width, depth cut 8 -> 2 layers (the run's
# time limit: 9c's zip write and rolling reload at 8 layers took ~60 s;
# at 4 layers phase 30 took 103 s of a 1067 s run)
POOL_SERVE = dict(SERVE, n_layers=2)
POOL_PROBE_T = 16           # the probe and canary batch: (1, 16) ids
POOL_PARITY_LAYERS = 2      # the f32 parity pool: path 1's width, 2 layers
POOL_MARGIN = 0.05          # a bf16 divergence must sit below this margin
# 9b-9c live traffic: clients sending prompts of 128 with 32 tokens out
POOL_CLIENTS, POOL_DRILL_TOKENS = 6, 32
# 9d: a load spike of 16 closed-loop clients (16-token requests) against
# 3 x 8 slots; the scale-down while a 4096-token prompt decodes 64 tokens
POOL_SPIKE, POOL_SPIKE_TOKENS = 16, 16
# phase 31: streams of 48 tokens, a crash or an attach at cursor 16, a
# ring of 8 for the overflow
STREAM_TOKENS, STREAM_K, STREAM_RING = 48, 16, 8


def pool_digests(M, pool):
    """Every replica's weight digest (the engine's: blake2b over the
    parameters' bytes)."""
    return [M["weight_digest"](r.server.net._params) for r in pool._replicas]


def engines_steps(pool):
    """Decode steps + prefill chunks of every replica's engine, by server
    id."""
    out = {}
    for srv in [r.server for r in pool._replicas]:
        eng = srv._engine
        if eng is not None:
            st = eng.stats()
            out[id(srv)] = st["decode_steps"] + st["prefill_chunks"]
    return out


def take_paged(pa, into=None):
    """The paged kernel's launches since the last reset (added to
    `into`), then the counts set to 0."""
    got = dict(pa.paged_attention.launches_by)
    plain = pa.paged_attention_plain.calls
    pa.reset_counts()
    if plain:
        raise AssertionError(f"path 9: the paged plain version ran {plain} "
                             "times on the card")
    if into is not None:
        for k, n in got.items():
            into[k] = into.get(k, 0) + n
    return got


def crash_hooks(crash):
    """An engine step hook firing `crash` (a ReplicaCrashInjector, whose
    own phase is the predict step's) at every prefill and decode step."""
    def hook(phase, info):
        if phase in ("pre_prefill", "pre_decode"):
            crash("pre_step", info)
    return hook


def client_load(pool, prompts, n, stop=None, rounds=None):
    """Closed-loop clients, one thread a prompt: each sends
    `pool.generate(prompt, n)` `rounds` times or until `stop` is set.
    Returns (threads, results, failures)."""
    import threading

    results, failures = [], []
    lock = threading.Lock()

    def run(p):
        done = 0
        while (rounds is None or done < rounds) \
                and not (stop is not None and stop.is_set()):
            try:
                out = pool.generate(p, n, timeout=600)
                with lock:
                    results.append(out)
            except Exception as e:  # counted: the caller fails on any
                with lock:
                    failures.append(repr(e))
            done += 1

    threads = [threading.Thread(target=run, args=(p,)) for p in prompts]
    for t in threads:
        t.start()
    return threads, results, failures


def joined_clients(threads, results, failures, n, what):
    for t in threads:
        t.join(900.0)
        if t.is_alive():
            raise AssertionError(f"{what}: a client thread did not finish")
    if failures:
        raise AssertionError(f"{what}: {len(failures)} failed requests: "
                             f"{failures[:3]}")
    bad = [o.shape for o in results if o.shape != (n,)]
    if bad:
        raise AssertionError(f"{what}: requests came back with shapes {bad}")
    return len(results)


def pool_parity_f32(torch, M, card):
    """9a's f32 leg: a 2-layer f32 GPT at path 1's width (TF32 off): path
    1's requests through a 3-replica pool equal a single ModelServer's."""
    import numpy as np

    S = M["serving"]
    V = SERVE["vocab_size"]
    net = M["MultiLayerNetwork"](
        M["gpt_configuration"](**dict(SERVE, n_layers=POOL_PARITY_LAYERS),
                               seed=30),
        dtype=torch.float32, device="cuda")
    net.init()
    prompts, n_tok = path1_requests(np)
    srv = S.ModelServer(net, generation=SERVER_GEN)
    try:
        single = joined(*run_threads([lambda p=p, n=n: srv.generate(p, n)
                                      for p, n in zip(prompts, n_tok)]))
    finally:
        srv.shutdown()
    pool = S.ReplicaPool.from_net(net, POOL_REPLICAS, probe_interval=30.0,
                                  server_kwargs={"generation": SERVER_GEN})
    try:
        pooled = joined(*run_threads([lambda p=p, n=n: pool.generate(p, n)
                                      for p, n in zip(prompts, n_tok)]))
        per = {k: v["generation"]["served"]
               for k, v in pool.stats()["replicas"].items()}
    finally:
        pool.shutdown(drain_timeout=60)
    for i, (a, b) in enumerate(zip(single, pooled)):
        if not np.array_equal(a, b):
            raise AssertionError(f"path 9a f32: request {i} through the pool "
                                 f"{b[:8]}... != the single server's "
                                 f"{a[:8]}...")
    log(f"  9a f32 ({POOL_PARITY_LAYERS} layers, TF32 off): path 1's "
        f"{len(prompts)} requests through the pool (served per replica "
        f"{per}) equal a single ModelServer's, token for token [{card}]")
    del net
    torch.cuda.empty_cache()


def phase_pool(torch, M, pa, card, path1_tok_s):
    """Path 9 (phase 30): path 1's network and engine behind
    `ReplicaPool.from_net(net, 3)` on one card: 9a routing, token parity
    and the f32 predict; 9b a crash drill and degraded mode; 9c rolling
    reloads (a rollback at replica 2, one under live traffic, a poisoned
    candidate); 9d the autoscaler under a load spike and a scale-down
    that migrates a live 4096-token decode. Returns (the pool, the
    bf16 paged launches, the f32 flash forward launches)."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    S, fa = M["serving"], M["fa"]
    V = SERVE["vocab_size"]
    n_layers = POOL_SERVE["n_layers"]
    pool_wall = time.perf_counter()
    pool_parity_f32(torch, M, card)

    net = M["MultiLayerNetwork"](M["gpt_configuration"](**POOL_SERVE,
                                                        seed=11),
                                 dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device="cuda")
    net.init()
    prompts, n_tok = path1_requests(np)
    toks = int(sum(n_tok))
    probe = np.random.default_rng(30).integers(0, V, (1, POOL_PROBE_T)) \
        .astype(np.int32)
    gen = dict(SERVER_GEN, max_queue=256)
    # the bf16 reference for 9a: one server (all six in one engine), with
    # the top-2 log-probabilities a divergence is read against
    ref = S.ModelServer(net, generation=dict(gen, logprobs=2))
    try:
        ref_out = joined(*run_threads(
            [lambda p=p, n=n: ref.generate(p, n, logprobs=2)
             for p, n in zip(prompts, n_tok)]))
    finally:
        ref.shutdown()
    skw = {"generation": gen, "canary": probe, "breaker_reset_timeout": 1.0}
    pool = S.ReplicaPool.from_net(
        net, POOL_REPLICAS, server_kwargs=skw, probe_batch=probe,
        probe_interval=POOL_PROBE_S, probe_timeout=60.0,
        watchdog_timeout=60.0, readmit_successes=2)
    spawned = []
    rows_paged, flash = {}, {}
    tmp = tempfile.mkdtemp(prefix="path9_")
    try:
        for rep in pool._replicas:  # warm-up: engines, cuBLAS handles
            rep.server.generate(prompts[0][:16], 4)
            rep.server.predict(probe)
        torch.cuda.synchronize()

        # -- 9a: path 1's requests from 6 client threads
        pa.reset_counts()
        before = engines_steps(pool)
        s0 = pool.stats()
        t0 = time.perf_counter()
        outs = joined(*run_threads([lambda p=p, n=n: pool.generate(
            p, n, timeout=900) for p, n in zip(prompts, n_tok)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = take_paged(pa, rows_paged)
        after = engines_steps(pool)
        steps = sum(after[k] - before.get(k, 0) for k in after)
        s1 = pool.stats()
        per = {k: v["generation"]["served"] - s0["replicas"][k][
            "generation"]["served"] for k, v in s1["replicas"].items()}
        log(f"  9a: path 1's {len(prompts)} requests from {len(prompts)} "
            f"threads through {POOL_REPLICAS} replicas: wall {wall:.4f} s, "
            f"{toks / wall:.1f} generated tokens/s"
            + (f" (path 1's 8-layer engine alone {path1_tok_s:.1f}, "
               f"ratio {toks / wall / path1_tok_s:.3f})"
               if path1_tok_s else "")
            + f"; served per replica {per}, failovers "
            f"{s1['failovers'] - s0['failovers']}; paged launches {got} = "
            f"{n_layers} layers x {steps} engine steps and chunks [{card}]")
        if s1["failovers"] != s0["failovers"] or sum(per.values()) != 6:
            raise AssertionError(f"path 9a: failovers or served per replica "
                                 f"{per} wrong")
        if sum(got.values()) != n_layers * steps or not got.get((1, "dense")) \
                or not got.get((256, "dense")) \
                or any(k != "dense" for _, k in got):
            raise AssertionError(f"path 9a: paged launches {got} against "
                                 f"{n_layers} x {steps} engine steps")
        worst = 0.0
        for i, (o, r, n) in enumerate(zip(outs, ref_out, n_tok)):
            if o.shape != (n,):
                raise AssertionError(f"path 9a: request {i} gave {o.shape}")
            div = first_divergence(r["tokens"], r["logprobs"], o)
            if div is not None:
                log(f"  9a: request {i} diverges from the single server at "
                    f"token {div[0]}, top-2 margin {div[1]:.4f}")
                if div[1] >= POOL_MARGIN:
                    raise AssertionError(f"path 9a: request {i} diverged at a "
                                         f"margin of {div[1]:.4f}")
                worst = max(worst, div[1])
        log(f"  9a bf16: every request equal to the single server's or "
            f"diverging below a top-2 margin of {POOL_MARGIN} (largest "
            f"{worst:.4f})")
        trace = traced(torch, lambda: joined(*run_threads(
            [lambda p=p, n=n: pool.generate(p, n, timeout=900)
             for p, n in zip(prompts, n_tok)])))
        log(f"  9a traced batch (torch.profiler, not in tokens/s): {trace}")
        fa.reset_counts()
        x = np.random.default_rng(31).integers(0, V, (1, SERVER_PREDICT_T)) \
            .astype(np.int32)
        t0 = time.perf_counter()
        pred = pool.predict(x, timeout=600)
        torch.cuda.synchronize()
        pred_ms = 1e3 * (time.perf_counter() - t0)
        flash = dict(fa.launches_by_route)
        want = net.output(x).float().cpu().numpy()
        err = float(np.abs(pred - want).max())
        log(f"  9a predict of (1, {SERVER_PREDICT_T}) through the pool: "
            f"{pred_ms:.2f} ms, flash launches {flash}, max |pool - "
            f"net.output| {err:.3g} [{card}]")
        if flash.get(("fwd", "tf32"), 0) != n_layers or err > SERVER_PREDICT_ATOL:
            raise AssertionError(f"path 9a: predict flash launches {flash}, "
                                 f"error {err}")

        # -- 9b: a crash under live generate traffic, then every replica
        rng = np.random.default_rng(32)
        crash = S.ReplicaCrashInjector()
        victim = pool._replicas[1].server
        victim.infer_hooks.append(crash)
        victim._engine.step_hooks.append(crash_hooks(crash))
        s0 = pool.stats()
        drill = [rng.integers(0, V, SERVER_PROMPT_T[0])
                 for _ in range(POOL_CLIENTS)]
        threads, res, fails = client_load(pool, drill, POOL_DRILL_TOKENS,
                                          rounds=2)
        until(lambda: victim._engine.stats()["active_slots"] > 0,
              "a live slot on replica 1", 120)
        t_crash = time.perf_counter()
        crash.crash()
        n = joined_clients(threads, res, fails, POOL_DRILL_TOKENS, "path 9b")
        until(lambda: pool.stats()["replicas"]["1"]["state"] == "evicted",
              "replica 1's eviction", 120)
        evict_s = time.perf_counter() - t_crash
        crash.revive()
        t1 = time.perf_counter()
        until(lambda: pool.healthy_replicas() == POOL_REPLICAS,
              "replica 1's readmission", 120)
        readmit_s = time.perf_counter() - t1
        s1 = pool.stats()
        fo = s1["failovers"] - s0["failovers"]
        log(f"  9b: {n} requests of {SERVER_PROMPT_T[0]} + "
            f"{POOL_DRILL_TOKENS} from {POOL_CLIENTS} clients, replica 1 "
            f"crashed under them: 0 failed, failovers {fo}, steps killed "
            f"{crash.steps_killed}; evicted {evict_s:.2f} s after the "
            f"crash, readmitted {readmit_s:.2f} s after the revival "
            f"(readmissions {s1['readmissions'] - s0['readmissions']}) "
            f"[{card}]")
        if fo < 1 or not crash.steps_killed \
                or s1["readmissions"] <= s0["readmissions"]:
            raise AssertionError("path 9b: no failover, no crash or no "
                                 "readmission")
        dead = S.ReplicaCrashInjector(crashed=True)
        for rep in pool._replicas:
            rep.server.infer_hooks.append(dead)
            rep.server._engine.step_hooks.append(crash_hooks(dead))
        until(lambda: pool.healthy_replicas() == 0, "every replica evicted",
              120)
        try:
            pool.generate(drill[0], 4, timeout=60)
        except S.ServiceUnavailableError as e:
            if "no healthy replica" not in str(e) or not e.retry_after:
                raise AssertionError(f"path 9b: degraded answer {e!r}")
        else:
            raise AssertionError("path 9b: a pool with every replica "
                                 "evicted served a request")
        dead.revive()
        t1 = time.perf_counter()
        until(lambda: pool.healthy_replicas() == POOL_REPLICAS,
              "the pool's recovery", 120)
        recover_s = time.perf_counter() - t1
        if pool.generate(drill[0], 4, timeout=120).shape != (4,):
            raise AssertionError("path 9b: no answer after the recovery")
        log(f"  9b: every replica broken: typed ServiceUnavailableError "
            f"(shed_unavailable {pool.stats()['shed_unavailable']}), "
            f"recovered by itself {recover_s:.2f} s after the revival")
        take_paged(pa, rows_paged)

        # -- 9c: rolling reloads from a CheckpointStore
        store = M["CheckpointStore"](tmp)
        cand = M["MultiLayerNetwork"](M["gpt_configuration"](**POOL_SERVE,
                                                             seed=12),
                                      dtype=torch.float32, device="cuda")
        cand.init()
        t0 = time.perf_counter()
        store.save(1, lambda p: M["write_model"](cand, p, atomic=False))
        save_s = time.perf_counter() - t0
        fp0 = pool_digests(M, pool)
        v2 = pool._replicas[2].server.model_version

        def refuse_candidate(phase, info):
            if phase == "pre_step" and info["model_version"] == v2 + 1:
                raise RuntimeError("replica 2 cannot serve the candidate")

        pool._replicas[2].server.infer_hooks.append(refuse_candidate)
        s0 = pool.stats()
        try:
            pool.rolling_reload(store, step=1, drain_timeout=120)
        except S.InferenceFailedError as e:
            if "post-reload probe" not in str(e):
                raise AssertionError(f"path 9c: {e!r}")
        else:
            raise AssertionError("path 9c: replica 2's failed probe did not "
                                 "stop the deploy")
        fp = pool_digests(M, pool)
        s1 = pool.stats()
        if fp != fp0 or s1["rollbacks"] != s0["rollbacks"] + 1 \
                or pool.healthy_replicas() != POOL_REPLICAS:
            raise AssertionError(f"path 9c: after replica 2's failed probe "
                                 f"the weights moved ({fp} != {fp0}) or the "
                                 "pool was not rolled back")
        log("  9c: a candidate replica 2 cannot serve: its post-reload probe "
            "failed, replicas 0 and 1 rolled back, every weight digest "
            "unchanged")
        stop = threading.Event()
        threads, res, fails = client_load(
            pool, [rng.integers(0, V, SERVER_PROMPT_T[0])
                      for _ in range(4)], POOL_DRILL_TOKENS, stop=stop)
        time.sleep(1.0)
        t0 = time.perf_counter()
        versions = pool.rolling_reload(store, step=1, drain_timeout=120)
        reload_s = time.perf_counter() - t0
        time.sleep(1.0)
        stop.set()
        n = joined_clients(threads, res, fails, POOL_DRILL_TOKENS, "path 9c")
        s2 = pool.stats()
        dtypes = sorted({str(r.server.net.compute_dtype or r.server.net.dtype)
                         for r in pool._replicas})
        log(f"  9c: rolling_reload under {n} live requests in "
            f"{reload_s:.2f} s (zip written in {save_s:.2f} s): 0 failed, "
            f"versions {versions}, rolling_reloads "
            f"{s2['rolling_reloads']}, migrations "
            f"{s2['migrations'] - s1['migrations']}, fallbacks "
            f"{s2['migration_fallbacks'] - s1['migration_fallbacks']}; "
            f"replicas compute in {dtypes} [{card}]")
        if s2["rolling_reloads"] != 1:
            raise AssertionError("path 9c: rolling_reloads != 1")
        fp1 = pool_digests(M, pool)
        if fp1 != [M["weight_digest"](cand._params)] * POOL_REPLICAS:
            raise AssertionError("path 9c: a replica is not on the candidate")
        # a reloaded candidate computes in f32: its tokens against the
        # candidate in f32 behind its own engine
        ref_eng = M["DecodeEngine"](cand, **SERVER_GEN)
        try:
            for p in (prompts[0], prompts[4]):
                a = ref_eng.generate(p, POOL_DRILL_TOKENS, timeout=600)
                b = pool.generate(p, POOL_DRILL_TOKENS, timeout=600)
                if not np.array_equal(a, b):
                    raise AssertionError(f"path 9c: tokens after the reload "
                                         f"{b[:8]}... != the f32 candidate's "
                                         f"{a[:8]}...")
        finally:
            ref_eng.shutdown()
        log(f"  9c: after the reload, prompts of {len(prompts[0])} and "
            f"{len(prompts[4])} give the f32 candidate's tokens")
        S.ReloadCorruptionInjector().poison_params(store, 2, cand)
        try:
            pool.rolling_reload(store, step=2, drain_timeout=120)
        except S.ModelValidationError as e:
            if "non-finite" not in str(e):
                raise AssertionError(f"path 9c: {e!r}")
        else:
            raise AssertionError("path 9c: a NaN candidate was deployed")
        s3 = pool.stats()
        if pool_digests(M, pool) != fp1 \
                or s3["rollbacks"] != s2["rollbacks"] + 1:
            raise AssertionError("path 9c: the poisoned candidate moved a "
                                 "replica's weights")
        log("  9c: a poisoned candidate (NaN parameters, manifest valid) "
            "refused by replica 0's canary, the pool rolled back, "
            "digests unchanged")
        del cand
        pool.sync_net(net)
        if pool_digests(M, pool) != fp0:
            raise AssertionError("path 9c: sync_net did not restore path 1's "
                                 "weights")
        take_paged(pa)  # f32 pools after the reload: not rows 1's launches

        # -- 9d: the autoscaler under a load spike, then a scale-down that
        # migrates a live decode
        def spawn():
            spawned.append(S.ModelServer(net.clone(), **skw))
            return spawned[-1]

        scaler = S.Autoscaler(pool, min_replicas=POOL_REPLICAS,
                              max_replicas=POOL_REPLICAS + 1, interval=0.25,
                              alpha=1.0, high_watermark=0.5,
                              low_watermark=0.05, hysteresis=2, cooldown=2.0,
                              drain_timeout=120, spawn=spawn,
                              dispose=lambda s: s.shutdown(drain_timeout=60))
        spike = S.LoadSpikeInjector(pool, prompt=drill[1],
                                    n_tokens=POOL_SPIKE_TOKENS,
                                    concurrency=POOL_SPIKE, timeout=600)
        s0 = pool.stats()
        t0 = time.perf_counter()
        scaler.start()
        spike.start()
        try:
            until(lambda: scaler.stats()["scale_ups"] >= 1, "a scale-up", 120)
            up_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            until(lambda: pool.healthy_replicas() == POOL_REPLICAS + 1,
                  "the new replica's readmission", 120)
            readmit_s = time.perf_counter() - t1
        finally:
            scaler.stop()
            spike.release()
        c = spike.counters()
        added = [e for e in pool.recorder.dump()["events"]
                 if e["kind"] == "add-replica"]
        log(f"  9d: a spike of {POOL_SPIKE} clients: scaled up after "
            f"{up_s:.2f} s (pressure {scaler.stats()['pressure']}), the "
            f"new replica entered {added[-1]['state'] if added else '?'} "
            f"and was readmitted {readmit_s:.2f} s later; spike served "
            f"{c['served']}, failures {c['failures']}, sheds {c['sheds']}, "
            f"p99 {1e3 * spike.p99():.1f} ms [{card}]")
        if c["failures"] or c["sheds"] or not added \
                or added[-1]["state"] != "evicted":
            raise AssertionError(f"path 9d: spike {c}, added {added}")
        take_paged(pa, rows_paged)
        long_p = prompts[4]
        uninterrupted = pool.generate(long_p, MIGRATE_TOKENS, timeout=600)
        seen = []
        res = {}

        def run():
            res["out"] = pool.generate(long_p, MIGRATE_TOKENS, timeout=600,
                                       on_token=lambda c, t, e=None:
                                       seen.append(t))

        t = threading.Thread(target=run)
        t.start()
        until(lambda: len(seen) >= MIGRATE_AT, "tokens before the "
              "scale-down", 300)

        def busy():
            for rid, r in pool.stats()["replicas"].items():
                if r.get("generation", {}).get("active_slots", 0) > 0:
                    return int(rid)
            return None

        scaler._pick_victim = busy
        at = len(seen)
        victim = scaler.scale_down()
        t.join(600)
        s1 = pool.stats()
        ms = scaler.stats()["last_scale_down_ms"]
        log(f"  9d: scale-down of replica {victim} after {at} of "
            f"{MIGRATE_TOKENS} tokens of a {len(long_p)}-token prompt: "
            f"{ms} ms, migrations {s1['migrations'] - s0['migrations']}, "
            f"fallbacks {s1['migration_fallbacks'] - s0['migration_fallbacks']}"
            f"; spliced tokens equal the uninterrupted run: "
            f"{np.array_equal(res.get('out'), uninterrupted)} [{card}]")
        if s1["migrations"] - s0["migrations"] < 1 \
                or s1["migration_fallbacks"] != s0["migration_fallbacks"] \
                or not np.array_equal(res.get("out"), uninterrupted):
            raise AssertionError("path 9d: the scale-down did not migrate "
                                 "the live decode bit-identically")
        if pool.n_replicas != POOL_REPLICAS:
            raise AssertionError(f"path 9d: {pool.n_replicas} replicas after "
                                 "the scale-down")
        take_paged(pa, rows_paged)
    except BaseException:
        pool.shutdown(drain_timeout=60)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 30 {time.perf_counter() - pool_wall:.1f} s")
    return pool, rows_paged, flash


def phase_streams(torch, M, pa, card, pool, rows_paged):
    """Phase 31: token streams and the exactly-once door on path 9's
    pool. Shuts the pool down."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    S = M["serving"]
    V = SERVE["vocab_size"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(33)
    p = rng.integers(0, V, SERVER_PROMPT_T[0])
    tmp = tempfile.mkdtemp(prefix="phase31_")
    try:
        for rep in pool._replicas:  # every engine built: the hooks below
            rep.server.generate(p[:16], 2, timeout=600)
        unary = pool.generate(p, STREAM_TOKENS, timeout=600)
        reg = S.StreamRegistry(ring=4 * STREAM_TOKENS)

        def read_all(stream, frames):
            cur = 0
            while True:
                toks, _, cur, body = stream.read(cur, timeout=300)
                frames.extend(toks)
                if body is not None and not toks:
                    return

        def streamed(rid, sink=None):
            stream = reg.open(rid)
            frames = []
            t = threading.Thread(target=read_all, args=(stream, frames))
            t.start()
            out = pool.generate(p, STREAM_TOKENS, timeout=600,
                                on_token=sink(stream) if sink
                                else stream.publish)
            reg.finish(stream, {"result": out.tolist()})
            t.join(300)
            if t.is_alive():
                raise AssertionError("phase 31: the reader did not finish")
            return stream, frames, out

        stream, frames, out = streamed("s1")
        if frames != out.tolist() or not np.array_equal(out, unary):
            raise AssertionError("phase 31: the frames differ from the "
                                 "unary tokens")
        again = reg.attach("s1")
        toks, _, cur, _ = again.read(STREAM_K, timeout=0)
        if toks != unary.tolist()[STREAM_K:] or cur != STREAM_TOKENS:
            raise AssertionError(f"phase 31: an attach at cursor {STREAM_K} "
                                 "did not resume there")
        # a crash planted on the serving replica once k tokens are out
        crashes = [S.ReplicaCrashInjector() for _ in pool._replicas]
        hooks = []
        for rep, inj in zip(pool._replicas, crashes):
            hooks.append(crash_hooks(inj))
            rep.server._engine.step_hooks.append(hooks[-1])
        engines = {rep.server._engine._thread: i
                   for i, rep in enumerate(pool._replicas)}
        crashed = []

        def crashing(stream):
            def sink(cursor, token, entry=None):
                stream.publish(cursor, token, entry)
                if cursor == STREAM_K and not crashed:
                    i = engines[threading.current_thread()]
                    crashed.append(i)
                    crashes[i].crash()
            return sink

        f0 = pool.stats()["failovers"]
        try:
            stream, frames, out = streamed("s2", crashing)
        finally:
            for inj in crashes:
                inj.revive()
            for rep, hook in zip(pool._replicas, hooks):
                rep.server._engine.step_hooks.remove(hook)
        fo = pool.stats()["failovers"] - f0
        log(f"  31: a stream of {STREAM_TOKENS} tokens with a concurrent "
            f"reader equals the unary tokens; an attach at cursor {STREAM_K} "
            f"resumes there; replica {crashed} crashed at cursor {STREAM_K}: "
            f"failovers {fo}, duplicates dropped "
            f"{stream.duplicate_tokens_dropped}, gaps "
            f"{stream.gap_tokens_dropped}, frames contiguous and equal to "
            f"unary: {frames == unary.tolist()} [{card}]")
        if fo < 1 or frames != out.tolist() or frames != unary.tolist() \
                or stream.duplicate_tokens_dropped < STREAM_K \
                or stream.gap_tokens_dropped:
            raise AssertionError("phase 31: the failed-over stream is not "
                                 "contiguous and deduplicated")
        small = S.StreamRegistry(ring=STREAM_RING)
        s = small.open("o1")
        pool.generate(p, STREAM_TOKENS, timeout=600, on_token=s.publish)
        try:
            s.read(0, timeout=0)
        except S.StreamBackpressureError:
            pass
        else:
            raise AssertionError("phase 31: a ring overflow was not typed")
        # the exactly-once door around pool.generate
        door = S.ExactlyOnceDoor(journal_dir=os.path.join(tmp, "door"))
        params = {"prompt": p.tolist(), "n_tokens": STREAM_TOKENS}

        def execute(method, prm):
            o = pool.generate(np.asarray(prm["prompt"]), prm["n_tokens"],
                              timeout=600)
            return {"result": o.tolist()}

        if door.admit("e1", "generate", params)[0] != "execute":
            raise AssertionError("phase 31: a fresh id was not executed")
        outcome = execute("generate", params)
        door.complete("e1", outcome)
        take_paged(pa, rows_paged)
        verdict, cached = door.admit("e1", "generate", params)
        retry = take_paged(pa)
        st = door.stats()["cache"]
        if verdict != "cached" or cached != outcome or retry \
                or st["double_executions"]:
            raise AssertionError(f"phase 31: the retry gave {verdict}, "
                                 f"launches {retry}, {st}")
        door.close()
        jdir = os.path.join(tmp, "orphan")
        j = S.RequestJournal(jdir)
        q = rng.integers(0, V, SERVER_PROMPT_T[0])
        j.admit("orphan", "generate", {"prompt": q.tolist(), "n_tokens": 24})
        j.close()
        door2 = S.ExactlyOnceDoor(journal_dir=jdir)
        n = door2.replay(execute)
        claim = door2.claim("orphan")["result"]
        direct = pool.generate(q, 24, timeout=600).tolist()
        st2 = door2.stats()
        door2.close()
        log(f"  31: the door: a retry answered from the ring (no paged "
            f"launch, double_executions {st['double_executions']}); an "
            f"admitted but incomplete journal record replayed through a "
            f"fresh door ({n} replay), its claim equal to a direct run: "
            f"{claim == direct}")
        if n != 1 or st2["replays"] != 1 or claim != direct:
            raise AssertionError("phase 31: the orphan's replay differs")
        take_paged(pa, rows_paged)
    finally:
        pool.shutdown(drain_timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 31 {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()


def phases_30_31(torch, M, pa, card, path1_tok_s):
    """Phases 30 and 31; returns the bf16 paged launches and the f32
    flash launches for the kernel rows."""
    log("[30/43] path 9: path 1's GPT behind ReplicaPool.from_net(net, 3): "
        "routing and parity, a crash drill, rolling reloads, the autoscaler")
    pool, paged, flash = phase_pool(torch, M, pa, card, path1_tok_s)
    log("[31/43] token streams and the exactly-once door on path 9's pool")
    phase_streams(torch, M, pa, card, pool, paged)
    return {"paged": paged, "flash": flash}


def phases_30_31_alone(torch, M, pa, cuda_build) -> int:
    """`--phases-30-31`: path 1 (phase 7, for its tokens/s) and phases 30
    and 31 alone (the paged and flash sources built first), then one JSON
    line of their launch counts."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.build(("paged_attention", "flash_attention"))
    log(f"phases 30-31 alone [{card}]; build {time.perf_counter() - t0:.1f} "
        "s")
    _, path1_tok_s = phase_serve(torch, M, pa, card)
    t1 = time.perf_counter()
    counts = phases_30_31(torch, M, pa, card, path1_tok_s)
    log(f"phases 30-31 {time.perf_counter() - t1:.1f} s; all "
        f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, **{
        k: {",".join(map(str, key)): n for key, n in v.items()}
        for k, v in counts.items()}}), flush=True)
    return 0


# ------------------------------------------ phases 32-33: path 10, the wire
# path 10: path 1's network behind a port GatewayServer whose model is
# served by 3 replica PROCESSES on the one card (serving={"replicas": 3,
# "remote": ...}), as bench_serve_pool's cross-process line
# (bench.py:1040-1076); path 1's six requests from six client threads
WIRE_REPLICAS = 3
# path 10's network: path 1's at full width, its depth cut 8 -> 2 layers
# so the whole run fits its time limit (its zips, written and restored by
# every replica process, took most of the phase's 287 s at 8 layers and
# of its 183 s at 4)
WIRE_SERVE = dict(SERVE, n_layers=2)
# the drills' live traffic: 4 clients sending prompts of 128 with 32
# tokens out through the gateway
WIRE_CLIENTS, WIRE_DRILL_TOKENS = 4, 32
# a replica restores the 2-layer zip (~0.3 GB with its optimizer state)
WIRE_SPAWN_S = 600.0
# phase 33: a stream of 96 tokens torn after its first frame
WIRE_STREAM_TOKENS = 96
# 10a: the single engine and the process pool each serve path 1's six
# requests this many times (tokens/s: the median run; the busy share over
# all of them)
WIRE_RUNS = 3
# the polling interval of phases 32-33's waits (a remote pool's stats
# are RPCs)
WIRE_TICK = 0.05


class BusySampler:
    """The card's busy share over a window, as `nvidia-smi
    --query-gpu=utilization.gpu` samples it every 100 ms (the percent of
    each sample period in which a kernel ran). `share` is None where
    nvidia-smi gave no sample."""

    def __enter__(self):
        self.samples = []
        self._proc = None
        if shutil.which("nvidia-smi"):
            self._proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        if self._proc is not None:
            self._proc.terminate()
            out, _ = self._proc.communicate(timeout=30)
            self.samples = [float(x) for x in out.split()
                            if x.replace(".", "", 1).isdigit()]
        return False

    @property
    def share(self):
        return (sum(self.samples) / len(self.samples) / 100.0
                if self.samples else None)


class WireTraffic:
    """`generate` through a gateway client with a pool's signature, for
    `client_load`."""

    def __init__(self, client, name):
        self.client, self.name = client, name

    def generate(self, prompt_ids, n_tokens, timeout=None):
        import numpy as np

        out = self.client.call("generate", name=self.name,
                               prompt_ids=prompt_ids, n_tokens=n_tokens,
                               timeout=timeout, _timeout=900.0)
        if out.dtype != np.int32:
            raise AssertionError(f"path 10: tokens came back as {out.dtype}")
        return out


def replica_steps(pool):
    """Decode steps + prefill chunks of each replica's engine, by pool
    replica id (from its server's stats over the wire)."""
    out = {}
    for rid, st in pool.stats()["replicas"].items():
        gen = st.get("generation") or {}
        out[int(rid)] = gen.get("decode_steps", 0) \
            + gen.get("prefill_chunks", 0)
    return out


def counts_now(RR, sup, scratch):
    """Each live replica's kernel counts so far, by slot: the counts line
    that SIGUSR1 makes it write to its log."""
    import signal

    out = {}
    for slot, proc in enumerate(sup._procs):
        path = os.path.join(scratch, f"replica-{slot}.log")
        n = len(RR.replica_launch_counts(path))
        os.kill(proc.pid, signal.SIGUSR1)
        until(lambda: len(RR.replica_launch_counts(path)) > n,
              f"replica {slot}'s counts line", 60, tick=WIRE_TICK)
        c = RR.replica_launch_counts(path)[-1]
        if c["pid"] != proc.pid or c["final"]:
            raise AssertionError(f"path 10: replica {slot} (pid {proc.pid})"
                                 f" wrote {c}")
        out[slot] = c
    return out


def diff_counts(b, a):
    """Launches by key in `b` less those in `a` (keys with 0 left out)."""
    return {k: v - a.get(k, 0) for k, v in b.items() if v != a.get(k, 0)}


def phase_wire_pool(torch, M, pa, card):
    """Path 10 (phase 32): path 1's network behind a GatewayServer whose
    model is served by 3 replica processes on the card. 10a: path 1's
    requests through the gateway, token-identical to one f32 engine on
    the same zip in this process; tokens/s beside that engine's and an
    in-process 3-replica pool's on the restored net; the card's busy
    share; a (1, 4096) predict. 10b: kill -9 of a replica under live
    traffic, respawn and readmission. 10c: a ChaosProxy partition of a
    replica. 10d: a rolling reload across the processes under live
    traffic. 10e: a replica stopped gracefully (SIGTERM) under live
    traffic, its closing server's refusal typed as a failover. Then each
    clean life's paged launches (the counts line it wrote as it stopped)
    against its engine's steps. Returns the replicas' launches in 10a's
    window (the difference of the counts lines each writes on SIGUSR1
    before and after it), by (C, pools) and (kind, route)."""
    import signal
    import tempfile
    import threading

    import numpy as np

    S, G, RR = M["serving"], M["gateway"], M["remote_replica"]
    V, n_layers = WIRE_SERVE["vocab_size"], WIRE_SERVE["n_layers"]
    t_phase = time.perf_counter()
    prompts, n_tok = path1_requests(np)
    toks = int(sum(n_tok))
    rng = np.random.default_rng(32)
    probe = rng.integers(0, V, (1, POOL_PROBE_T)).astype(np.int32)
    x = rng.integers(0, V, (1, SERVER_PREDICT_T)).astype(np.int32)
    scratch = tempfile.mkdtemp(prefix="path10_")
    gen = dict(SERVER_GEN, max_queue=256)
    pool_kw = dict(probe_batch=probe, probe_interval=POOL_PROBE_S,
                   probe_timeout=60.0, watchdog_timeout=60.0,
                   readmit_successes=2)
    serving = {"replicas": WIRE_REPLICAS, "generation": gen,
               "breaker_reset_timeout": 1.0, "pool": pool_kw,
               "remote": {"scratch_dir": scratch, "rpc_timeout": 900.0,
                          "admin_timeout": 900.0,
                          "supervisor_kwargs": {
                              "restart_backoff": 0.25, "poll_interval": 0.1,
                              "spawn_timeout": WIRE_SPAWN_S}}}

    def busy_line(b):
        return "not measured" if b.share is None else (
            f"{100 * b.share:.1f}% ({len(b.samples)} samples of 100 ms)")

    def served(fn):
        """Path 1's six requests from six threads through `fn`,
        WIRE_RUNS times: (the outputs of each run, wall s of each run,
        the card's busy share over all of them)."""
        outs, walls = [], []
        with BusySampler() as busy:
            for _ in range(WIRE_RUNS):
                t0 = time.perf_counter()
                outs.append(joined(*run_threads([
                    lambda p=p, n=n: fn(p, n, timeout=900)
                    for p, n in zip(prompts, n_tok)])))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        return outs, walls, busy

    def median(ws):
        return sorted(ws)[len(ws) // 2]

    # -- 10a: the f32 references in this process, from the zip the
    # replicas will serve, timed before any replica process exists
    conf = M["gpt_configuration"](**WIRE_SERVE, seed=11)
    ref_zip = os.path.join(scratch, "reference.zip")
    t0 = time.perf_counter()
    net = M["MultiLayerNetwork"](conf, device="cuda")
    net.init()
    M["write_model"](net, ref_zip)
    del net
    zip_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_net = M["restore_model"](ref_zip, device="cuda")
    restore_s = time.perf_counter() - t0
    if ref_net.compute_dtype is not None:
        raise AssertionError("path 10: the restored net has a compute dtype")
    want_pred = ref_net.output(x).float().cpu().numpy()
    eng = M["DecodeEngine"](ref_net, **SERVER_GEN)
    try:
        eng.generate(prompts[0][:16], 4)
        torch.cuda.synchronize()
        ref_runs, singles, busy1 = served(
            lambda p, n, timeout: eng.submit(p, n).result(timeout=timeout))
    finally:
        eng.shutdown()
    ref_out = ref_runs[0]
    ip = S.ReplicaPool.from_net(ref_net, WIRE_REPLICAS, probe_interval=30.0,
                                server_kwargs={"generation": SERVER_GEN})
    try:
        for rep in ip._replicas:
            rep.server.generate(prompts[0][:16], 4)
        torch.cuda.synchronize()
        ip_runs, inprocs, busy_ip = served(ip.generate)
    finally:
        ip.shutdown(drain_timeout=60)
    del ip, ref_net, eng
    torch.cuda.empty_cache()
    single_s, inproc_s = median(singles), median(inprocs)
    log(f"  10a: in this process, before any replica process exists: the "
        f"{n_layers}-layer net made and written to a zip in {zip_s:.2f} s, "
        f"restored (f32) in {restore_s:.2f} s; path 1's {len(prompts)} "
        f"requests from {len(prompts)} threads, {WIRE_RUNS} runs each: one "
        f"f32 engine, wall s {[round(w, 4) for w in singles]}, median "
        f"{toks / single_s:.1f} tokens/s, busy {busy_line(busy1)}; an "
        f"in-process {WIRE_REPLICAS}-replica pool on the restored net, wall "
        f"s {[round(w, 4) for w in inprocs]}, median "
        f"{toks / inproc_s:.1f} tokens/s, busy {busy_line(busy_ip)} "
        f"[{card}]")

    gw = G.GatewayServer(serving=serving, device="cuda").start()
    client = G.GatewayClient(port=gw.port, timeout=900.0)
    traffic = WireTraffic(client, "gpt")
    pool = None
    extra = []  # drill pools, proxies, clients: closed on the way out
    lives = {}  # (slot, pid) -> engine steps read before that life ended
    stops = []  # the live-traffic threads' stop events: set on the way out
    try:
        # -- the pool, through the gateway's entry point, on the same zip
        t0 = time.perf_counter()
        client.call("load_model", name="gpt", path=ref_zip)
        spawn_s = time.perf_counter() - t0
        pool = gw.entry._servers["gpt"]
        sup = pool.supervisor
        zip_path = os.path.join(scratch, "model.zip")
        t0 = time.perf_counter()
        for rep in pool._replicas:  # warm-up: engines, cuBLAS handles
            rep.server.generate(prompts[0][:16], 4, timeout=900)
            rep.server.predict(probe, timeout=900)
        warm_s = time.perf_counter() - t0
        log(f"  10: load_model over the wire spawned {WIRE_REPLICAS} "
            f"replica processes (pids {[p.pid for p in sup._procs]}, "
            f"device {sup.device}) in {spawn_s:.2f} s (the zip restored in "
            f"the gateway, written for the replicas and restored by each), "
            f"warmed in {warm_s:.2f} s [{card}]")

        # the process pool: path 1's six requests through the gateway,
        # then a (1, 4096) predict; the window's launches are the
        # difference of each replica's counts lines before and after it
        pa.reset_counts()
        c0 = counts_now(RR, sup, scratch)
        before = replica_steps(pool)
        s0 = pool.stats()
        runs, walls, busy = served(traffic.generate)
        wall = median(walls)
        after = replica_steps(pool)
        s1 = pool.stats()
        steps = {k: after[k] - before.get(k, 0) for k in after}
        per = {k: v["generation"]["served"] - s0["replicas"][k][
            "generation"]["served"] for k, v in s1["replicas"].items()}
        t0 = time.perf_counter()
        pred = client.call("predict", name="gpt", features=x, _timeout=900)
        pred_ms = 1e3 * (time.perf_counter() - t0)
        c1 = counts_now(RR, sup, scratch)
        here = dict(pa.paged_attention.launches_by)
        window = {slot: {kind: diff_counts(c1[slot][kind], c0[slot][kind])
                         for kind in ("paged", "flash")}
                  for slot in c1}
        log(f"  10a: the same through the gateway to {WIRE_REPLICAS} "
            f"replica processes, {WIRE_RUNS} runs: wall s "
            f"{[round(w, 4) for w in walls]}, median {toks / wall:.1f} "
            f"generated tokens/s; processes / engine {single_s / wall:.3f}, "
            f"processes / in-process pool {inproc_s / wall:.3f}; served per "
            f"replica {per}, engine steps and chunks per replica {steps}; "
            f"the card's busy share (nvidia-smi utilization.gpu) under the "
            f"processes {busy_line(busy)}; launches in this process {here}; "
            f"each replica's launches in the window (SIGUSR1 counts lines "
            f"before and after) {window} [{card}]")
        if here or pa.paged_attention_plain.calls:
            raise AssertionError(f"path 10a: the parent launched {here} "
                                 "(the replicas' engines must)")
        if sum(per.values()) != WIRE_RUNS * len(prompts) \
                or s1["failovers"] != s0["failovers"]:
            raise AssertionError(f"path 10a: served per replica {per}, "
                                 "failovers moved")
        for slot, w in window.items():
            got = sum(w["paged"].values())
            if got != n_layers * steps[slot] or c1[slot]["paged_plain"] \
                    or c1[slot]["flash_plain"] \
                    or set(w["paged"]) - {"1,dense", "256,dense"}:
                raise AssertionError(
                    f"path 10a: replica {slot} launched {w} in the window "
                    f"for {steps[slot]} engine steps and chunks")
        for outs in runs:
            for i, (o, r, q, n) in enumerate(zip(outs, ref_out, ip_runs[0],
                                                 n_tok)):
                if o.shape != (n,) or not np.array_equal(o, r) \
                        or not np.array_equal(q, r):
                    raise AssertionError(
                        f"path 10a: request {i} through the processes "
                        f"{o[:8]}... (in-process pool {q[:8]}...) != the f32 "
                        f"engine's {r[:8]}...")
        for outs in ref_runs[1:] + ip_runs[1:]:
            if not all(np.array_equal(o, r) for o, r in zip(outs, ref_out)):
                raise AssertionError("path 10a: a repeated reference run "
                                     "differs from the first")
        log(f"  10a: every request's tokens equal the single f32 engine's "
            f"(and the in-process pool's), token for token")
        err = float(np.abs(pred - want_pred).max())
        log(f"  10a: a predict of (1, {SERVER_PREDICT_T}) through the wire "
            f"{pred_ms:.2f} ms ({pred.dtype}), max |wire - net.output| "
            f"{err:.3g}")
        if pred.dtype != np.float32 or pred.shape != want_pred.shape \
                or err > SERVER_PREDICT_ATOL:
            raise AssertionError(f"path 10a: predict {pred.dtype} "
                                 f"{pred.shape}, error {err}")

        # -- 10b: kill -9 of replica 1 under live traffic
        drill = [rng.integers(0, V, SERVER_PROMPT_T[0])
                 for _ in range(WIRE_CLIENTS)]
        stop = threading.Event()
        stops.append(stop)
        threads, res, fails = client_load(traffic, drill, WIRE_DRILL_TOKENS,
                                          stop=stop)
        until(lambda: len(res) >= WIRE_CLIENTS, "traffic", 300, tick=WIRE_TICK)
        s0 = pool.stats()
        t_kill = time.perf_counter()
        killed = sup.kill(1)
        until(lambda: pool.stats()["replicas"]["1"]["state"]
              == "evicted", "replica 1's eviction", 120, tick=WIRE_TICK)
        evict_s = time.perf_counter() - t_kill
        until(lambda: sup.respawns >= 1 and sup.is_alive(1),
              "replica 1's respawn", 120, tick=WIRE_TICK)
        respawn_s = time.perf_counter() - t_kill
        until(lambda: pool.stats()["replicas"]["1"]["state"]
              == "healthy", "replica 1's readmission", WIRE_SPAWN_S,
              tick=WIRE_TICK)
        readmit_s = time.perf_counter() - t_kill
        n_before = len(res)
        until(lambda: len(res) >= n_before + WIRE_CLIENTS,
              "traffic after the readmission", 300, tick=WIRE_TICK)
        stop.set()
        n = joined_clients(threads, res, fails, WIRE_DRILL_TOKENS,
                           "path 10b")
        s1 = pool.stats()
        log(f"  10b: kill -9 of replica 1 (pid {killed}) under {n} live "
            f"requests of {SERVER_PROMPT_T[0]} + {WIRE_DRILL_TOKENS} "
            f"through the gateway: 0 failed, failovers "
            f"{s1['failovers'] - s0['failovers']}; evicted {evict_s:.2f} s, "
            f"respawned (pid {sup._procs[1].pid}) {respawn_s:.2f} s, "
            f"readmitted {readmit_s:.2f} s after the kill [{card}]")

        # -- 10c: a partition of replica 2, through a ChaosProxy in front
        # of its process (a drill pool over the same processes)
        proxy = S.ChaosProxy("127.0.0.1", sup.ports[2])
        extra.append(proxy)
        reps = [S.RemoteReplica("127.0.0.1", port, scratch_dir=scratch,
                                rpc_timeout=900.0)
                for port in (sup.ports[0], sup.ports[1], proxy.port)]
        dpool = S.RemoteReplicaPool(reps, scratch_dir=scratch, **pool_kw)
        extra.append(dpool)
        stop = threading.Event()
        stops.append(stop)
        threads, res, fails = client_load(dpool, drill, WIRE_DRILL_TOKENS,
                                          stop=stop)
        until(lambda: len(res) >= WIRE_CLIENTS, "traffic", 300, tick=WIRE_TICK)
        part = S.PartitionInjector(proxy)
        t0 = time.perf_counter()
        part.partition()
        until(lambda: dpool.stats()["replicas"]["2"]["state"]
              == "evicted", "replica 2's eviction", 120, tick=WIRE_TICK)
        evict_p = time.perf_counter() - t0
        n_before = len(res)
        until(lambda: len(res) >= n_before + WIRE_CLIENTS,
              "service from the other replicas", 300, tick=WIRE_TICK)
        t1 = time.perf_counter()
        part.heal()
        until(lambda: dpool.stats()["replicas"]["2"]["state"]
              == "healthy", "replica 2's readmission", 120,
              tick=WIRE_TICK)
        readmit_p = time.perf_counter() - t1
        stop.set()
        n = joined_clients(threads, res, fails, WIRE_DRILL_TOKENS,
                           "path 10c")
        if not sup.is_alive(2) or sup.respawns != 1:
            raise AssertionError("path 10c: the partition restarted a "
                                 "process (only its network was cut)")
        dpool.shutdown(drain_timeout=60)
        log(f"  10c: a ChaosProxy partition of replica 2 under {n} live "
            f"requests: 0 failed; evicted {evict_p:.2f} s after the cut, "
            f"readmitted {readmit_p:.2f} s after the heal; the process "
            f"never restarted [{card}]")

        # -- 10d: a rolling reload across the processes under live
        # traffic, through the gateway
        stop = threading.Event()
        stops.append(stop)
        threads, res, fails = client_load(traffic, drill, WIRE_DRILL_TOKENS,
                                          stop=stop)
        until(lambda: len(res) >= WIRE_CLIENTS, "traffic", 300, tick=WIRE_TICK)
        admin = G.GatewayClient(port=gw.port, timeout=900.0)
        extra.append(admin)
        t0 = time.perf_counter()
        versions = admin.call("rolling_reload", name="gpt", path=zip_path,
                              _timeout=1800.0)
        reload_s = time.perf_counter() - t0
        stop.set()
        n = joined_clients(threads, res, fails, WIRE_DRILL_TOKENS,
                           "path 10d")
        s2 = pool.stats()
        log(f"  10d: rolling_reload across the {WIRE_REPLICAS} processes "
            f"under {n} live requests in {reload_s:.2f} s (each replica "
            f"snapshots its weights to a zip, then reloads): 0 failed, "
            f"versions {versions}, rolling_reloads {s2['rolling_reloads']}, "
            f"rollbacks {s2['rollbacks']} [{card}]")
        if versions != [1] * WIRE_REPLICAS or s2["rolling_reloads"] != 1 \
                or s2["rollbacks"]:
            raise AssertionError(f"path 10d: versions {versions}, {s2}")
        for i, (p, n) in enumerate(zip(prompts, n_tok)):
            if i in (0, 4):  # after the reload: the f32 engine's tokens
                o = traffic.generate(p, n, timeout=900)
                if not np.array_equal(o, ref_out[i]):
                    raise AssertionError(f"path 10d: request {i} after the "
                                         "reload differs")

        # -- 10e: a graceful stop (SIGTERM) of replica 0 under live
        # predict traffic, while a generation is in flight on it: its
        # server drains that generation and refuses the rest typed, and
        # the pool fails over (the remote ServerClosedError is the replica
        # going away, not this pool closing)
        lp = drill[0]
        direct = S.RemoteReplica("127.0.0.1", sup.ports[0],
                                 scratch_dir=scratch, rpc_timeout=600.0)
        other = S.RemoteReplica("127.0.0.1", sup.ports[2],
                                scratch_dir=scratch, rpc_timeout=600.0)
        extra += [direct, other]
        b = replica_steps(pool)[2]
        long_ref = other.generate(lp, WIRE_STREAM_TOKENS, timeout=600)
        long_steps = replica_steps(pool)[2] - b  # the same request alone
        steps0 = replica_steps(pool)[0]
        pid0 = sup._procs[0].pid
        small = probe[:, :1]
        direct.predict(small, timeout=60)
        preds, pfails, long_out = [], [], []
        stop = threading.Event()
        stops.append(stop)

        def predict_load():
            while not stop.is_set():
                try:
                    preds.append(client.call("predict", name="gpt",
                                             features=probe, timeout=60,
                                             _timeout=120.0))
                except Exception as e:  # counted: the check fails on any
                    pfails.append(repr(e))

        pthreads = [threading.Thread(target=predict_load)
                    for _ in range(WIRE_CLIENTS)]
        for t in pthreads:
            t.start()
        until(lambda: len(preds) >= 10, "predict traffic", 120, tick=WIRE_TICK)
        longt = threading.Thread(target=lambda: long_out.append(
            direct.generate(lp, WIRE_STREAM_TOKENS, timeout=600)))
        longt.start()
        until(lambda: direct.stats()["generation"]["active_slots"] > 0,
              "the generation in flight on replica 0", 120, tick=0.005)
        stopper = threading.Thread(target=sup.retire_slot, args=(0,))
        stopper.start()  # SIGTERM, then waits for the exit
        # a kept-alive connection to the closing replica: every refusal
        # until the process is gone must be one the pool fails over on
        errs = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 120:
            try:
                direct.predict(small, timeout=60)
            except Exception as e:  # each refusal, checked below
                errs.append(e)
            if errs and not stopper.is_alive():
                break
        stopper.join(120)
        longt.join(600)
        until(lambda: pool.stats()["replicas"]["0"]["state"]
              == "evicted", "replica 0's eviction", 120, tick=WIRE_TICK)
        n_before = len(preds)
        until(lambda: len(preds) >= n_before + 10,
              "predicts after the stop", 120, tick=WIRE_TICK)
        stop.set()
        for t in pthreads:
            t.join(300)
        lives[(0, pid0)] = steps0 + long_steps
        kinds = {}
        for e in errs:
            kinds[type(e).__name__] = kinds.get(type(e).__name__, 0) + 1
        closed = sum("ServerClosedError" in str(e) for e in errs)
        drained = bool(long_out) and np.array_equal(long_out[0], long_ref)
        log(f"  10e: SIGTERM of replica 0 (pid {pid0}) with a generation of "
            f"{WIRE_STREAM_TOKENS} tokens in flight, under {len(preds)} live "
            f"predicts through the gateway: {len(pfails)} failed; the "
            f"in-flight generation drained, equal to replica 2's run: "
            f"{drained}; a kept-alive connection to it saw {kinds} ({closed} "
            f"of them the closing server's ServerClosedError) [{card}]")
        if pfails:
            raise AssertionError(f"path 10e: {len(pfails)} predicts failed: "
                                 f"{pfails[:3]}")
        bad = [e for e in errs if not isinstance(
            e, (S.ServiceUnavailableError, S.InferenceFailedError))]
        if bad or not closed or not drained:
            raise AssertionError(f"path 10e: the closing replica answered "
                                 f"{bad[:3]} ({closed} closed refusals), "
                                 f"drained: {drained}")
        # quiescent: the surviving lives' steps, then a clean shutdown
        steps = replica_steps(pool)
        for slot in (1, 2):
            lives[(slot, sup._procs[slot].pid)] = steps[slot]
    finally:
        for e in stops:
            e.set()
        for obj in reversed(extra):
            for m in ("shutdown", "close"):
                if hasattr(obj, m):
                    getattr(obj, m)()
                    break
        client.close()
        gw.stop(drain_timeout=60)
    # every process that stopped cleanly wrote its counts over its life
    # to its log: each life's launches against its engine's steps
    counts = {}
    for slot in range(WIRE_REPLICAS):
        for c in RR.replica_launch_counts(
                os.path.join(scratch, f"replica-{slot}.log")):
            if c["final"]:
                counts[(slot, c["pid"])] = c
    shutil.rmtree(scratch, ignore_errors=True)
    lines = []
    for (slot, pid), want_steps in sorted(lives.items()):
        c = counts.get((slot, pid))
        if c is None:
            raise AssertionError(f"path 10: replica {slot} (pid {pid}) "
                                 "wrote no launch counts")
        got = sum(c["paged"].values())
        lines.append(f"replica {slot} pid {pid}: paged {c['paged']} = "
                     f"{got} for {want_steps} engine steps and chunks, "
                     f"flash {c['flash']}")
        if got <= 0 or got != n_layers * want_steps or c["paged_plain"] \
                or c["flash_plain"] \
                or set(c["paged"]) - {"1,dense", "256,dense"}:
            raise AssertionError(f"path 10: replica {slot}'s counts {c} "
                                 f"against {n_layers} x {want_steps} steps")
    log("  10: over each clean life: " + "; ".join(lines))
    # path 10's launches: 10a's window, summed over the replicas
    total, flash = {}, {}
    for w in window.values():
        for k, v in w["paged"].items():
            total[k] = total.get(k, 0) + v
        for k, v in w["flash"].items():
            flash[k] = flash.get(k, 0) + v
    if not total.get("1,dense") or not total.get("256,dense") \
            or flash.get("fwd,tf32", 0) < n_layers:
        raise AssertionError(f"path 10: launches {total}, flash {flash}")
    log(f"  phase 32 {time.perf_counter() - t_phase:.1f} s")
    return {"paged": {(int(k.split(",")[0]), k.split(",")[1]): v
                      for k, v in total.items()},
            "flash": {tuple(k.split(",")): v for k, v in flash.items()}}


def phase_wire(torch, M, pa, card):
    """Phase 33: the wire on the card. Path 1's network (f32, created over
    the wire) behind a GatewayServer with the exactly-once door and a
    journal: `generate_stream` over TCP, torn after its first frame,
    concatenates to the unary tokens; `claim` returns the tokens of a
    `generate` whose client disconnected; a retried `fit` (a small MLP)
    with the same request id returns the same float; a gateway restarted
    on the journal replays an orphaned admitted request, with no double
    execution. Returns the paged launches (f32 pools)."""
    import json as _json
    import socket
    import tempfile

    import numpy as np

    G, S = M["gateway"], M["serving"]
    V = SERVE["vocab_size"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(33)
    p = rng.integers(0, V, SERVER_PROMPT_T[0]).astype(np.int32)
    q = rng.integers(0, V, SERVER_PROMPT_T[0]).astype(np.int32)
    orphan_p = rng.integers(0, V, SERVER_PROMPT_T[0]).astype(np.int32)
    conf = M["gpt_configuration"](**SERVE, seed=11)
    mlp = (M["conf"].NeuralNetConfiguration.Builder().seed(7)
           .learning_rate(0.3).list()
           .layer(M["conf"].DenseLayer(n_in=4, n_out=8))
           .layer(M["conf"].OutputLayer(n_in=8, n_out=3,
                                        activation="softmax",
                                        loss="mcxent")).build())
    xs = rng.normal(size=(24, 4)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 24)]
    tmp = tempfile.mkdtemp(prefix="phase33_")
    journal = os.path.join(tmp, "journal")
    serving = {"generation": SERVER_GEN}
    once = {"journal_dir": journal, "replay_timeout": 600.0}
    launches = {}
    gw = G.GatewayServer(serving=serving, exactly_once=once,
                         device="cuda").start()
    client = G.GatewayClient(port=gw.port, timeout=900.0, exactly_once=True)
    try:
        client.call("create_model", name="gpt", config=conf.to_json())
        client.call("create_model", name="m", config=mlp.to_json())
        client.call("generate", name="gpt", prompt_ids=p[:16], n_tokens=4)
        pa.reset_counts()
        unary = client.call("generate", name="gpt", prompt_ids=p,
                            n_tokens=WIRE_STREAM_TOKENS, _timeout=900.0)
        frames = 0
        with client.generate_stream("gpt", p, WIRE_STREAM_TOKENS,
                                    _timeout=900.0) as s:
            next(s)
            frames += 1
            s._conn.sock.shutdown(socket.SHUT_RDWR)  # the tear
            for _ in s:
                frames += 1
        st = gw.entry.streams.stats()
        log(f"  33: generate_stream of {WIRE_STREAM_TOKENS} tokens over TCP, "
            f"torn after its first frame: {frames} frames, resumes "
            f"{s.resumes} (server stream_resumes {st['stream_resumes']}), "
            f"equal to the unary tokens: "
            f"{np.array_equal(np.asarray(s.tokens), unary)} [{card}]")
        if unary.dtype != np.int32 or s.resumes < 1 \
                or not np.array_equal(np.asarray(s.tokens), unary):
            raise AssertionError(
                f"phase 33: the resumed stream {s.tokens[:8]}... != unary "
                f"{unary[:8]}... ({unary.dtype})")
        # a generate whose client disconnected, claimed afterwards
        direct = client.call("generate", name="gpt", prompt_ids=q,
                             n_tokens=WIRE_DRILL_TOKENS, _timeout=900.0)
        before = client.call("exactly_once_stats")["cache"]["executions"]
        raw = socket.create_connection(("127.0.0.1", gw.port), timeout=60)
        req = {"id": 1, "method": "generate", "request_id": "detached-1",
               "params": G.encode_value({"name": "gpt", "prompt_ids": q,
                                         "n_tokens": WIRE_DRILL_TOKENS})}
        raw.sendall((_json.dumps(req) + "\n").encode())
        raw.close()
        until(lambda: client.call("exactly_once_stats")["cache"][
            "executions"] > before, "the detached generate's admission",
            120, tick=WIRE_TICK)
        claimed = client.claim("detached-1", timeout=600.0)
        log(f"  33: a generate whose client disconnected, claimed: equal to "
            f"a direct run: {np.array_equal(claimed, direct)}")
        if not np.array_equal(claimed, direct):
            raise AssertionError("phase 33: the claimed tokens differ")
        # a retried fit answered from the door
        score = client.call("fit", name="m", features=xs, labels=ys)
        rid = client.last_request_id
        again = client.call("fit", _request_id=rid, name="m", features=xs,
                            labels=ys)
        fresh = client.call("fit", name="m", features=xs, labels=ys)
        eo = client.call("exactly_once_stats")
        log(f"  33: fit {score!r}, its retry {again!r}, a new fit {fresh!r}; "
            f"dedup hits {eo['cache']['dedup_hits']}, double executions "
            f"{eo['cache']['double_executions']}")
        if again != score or fresh == score \
                or eo["cache"]["double_executions"]:
            raise AssertionError("phase 33: the retried fit ran again")
        launches = dict(pa.paged_attention.launches_by)
    finally:
        client.close()
        gw.stop(drain_timeout=60)
    pa.reset_counts()
    # a crash after an admission: the journal holds an admitted request
    # that never completed; a gateway restarted on it replays the request
    j = S.RequestJournal(journal)
    j.admit("orphan-1", "generate", G.encode_value(
        {"name": "gpt", "prompt_ids": orphan_p,
         "n_tokens": WIRE_DRILL_TOKENS}))
    j.close()
    gw = G.GatewayServer(serving=serving, exactly_once=once,
                         device="cuda").start()
    client = G.GatewayClient(port=gw.port, timeout=900.0, exactly_once=True)
    try:
        client.call("create_model", name="gpt", config=conf.to_json())
        until(lambda: client.call("exactly_once_stats")["replays"] >= 1,
              "the journal replay", 600, tick=WIRE_TICK)
        got = client.claim("orphan-1", timeout=600.0)
        want = client.call("generate", name="gpt", prompt_ids=orphan_p,
                           n_tokens=WIRE_DRILL_TOKENS, _timeout=900.0)
        eo = client.call("exactly_once_stats")
        log(f"  33: a gateway restarted on the journal replayed the orphaned "
            f"request ({eo['replays']} replay, pending "
            f"{eo['journal']['pending']}, double executions "
            f"{eo['cache']['double_executions']}); its claim equals a direct "
            f"run: {np.array_equal(got, want)}")
        if not np.array_equal(got, want) or eo["journal"]["pending"] \
                or eo["cache"]["double_executions"]:
            raise AssertionError("phase 33: the journal replay failed")
        for k, v in pa.paged_attention.launches_by.items():
            launches[k] = launches.get(k, 0) + v
    finally:
        client.close()
        gw.stop(drain_timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    if pa.paged_attention_plain.calls or any(k != "dense"
                                             for _, k in launches):
        raise AssertionError(f"phase 33: launches {launches}")
    log(f"  phase 33 {time.perf_counter() - t_phase:.1f} s")
    return launches


WIRE_F32_ROWS = (("paged_attention_decode_f32", "decode"),
                 ("paged_attention_prefill_chunk_f32", "chunk"))


def wire_rows(torch, pa, by_path):
    """Row 1's f32 rows (path 10's replicas and phase 33 decode in f32
    pools: a zip holds no compute dtype), timed at path 1's serving
    shapes with f32 q and pools. `by_path`: each path's paged launches
    by (C, pools); a row's `launches` is their sum, and
    `launches_by_path` keeps them apart."""
    rows = []
    for name, which in WIRE_F32_ROWS:
        key = (PAGED_SHAPES[which]["C"], "dense")
        each = {path: int(paged.get(key, 0))
                for path, paged in by_path.items()}
        row = paged_row(torch, pa, name, "dense",
                        dict(PAGED_SERVING, **PAGED_SHAPES[which]),
                        torch.float32, sum(each.values()))
        row["launches_by_path"] = each
        rows.append(row)
    return rows


def phases_32_33(torch, M, pa, card):
    """Phases 32 and 33: `{"path 10": its replicas' launches in 10a's
    window, "phase 33": phase 33's}`, each `{"paged": {(C, pools): n},
    "flash": {(kind, route): n}}` (f32 pools)."""
    log(f"[32/43] path 10: path 1's GPT ({WIRE_SERVE['n_layers']} layers) "
        "behind a GatewayServer, "
        "served by 3 "
        "replica processes on the card: parity, tokens/s, kill -9, "
        "a partition, a rolling reload, a graceful stop")
    path10 = phase_wire_pool(torch, M, pa, card)
    log("[33/43] the wire on the card: a torn stream resumed, a claim, a "
        "retried fit, a journal replay after a restart")
    return {"path 10": path10,
            "phase 33": {"paged": phase_wire(torch, M, pa, card),
                         "flash": {}}}


def wire_paged(counts):
    """Each path's paged launches, from `phases_32_33`'s counts."""
    return {path: c["paged"] for path, c in counts.items()}


def phases_32_33_alone(torch, M, pa, cuda_build) -> int:
    """`--phases-32-33`: phases 32 and 33 alone (the paged and flash
    sources built first), then row 1's f32 rows and one JSON line of the
    rows and each path's launch counts."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.build(("paged_attention", "flash_attention"))
    log(f"phases 32-33 alone [{card}]; build {time.perf_counter() - t0:.1f} "
        "s")
    t1 = time.perf_counter()
    counts = phases_32_33(torch, M, pa, card)
    rows = wire_rows(torch, pa, wire_paged(counts))
    log(f"phases 32-33 {time.perf_counter() - t1:.1f} s; all "
        f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, "kernels": rows, **{
        path: {k: {",".join(map(str, key)): n for key, n in v.items()}
               for k, v in c.items()}
        for path, c in counts.items()}}), flush=True)
    return 0


# ------------------------------------ phases 34-35: path 11, Word2Vec
# bench_word2vec_50k (bench.py:1198-1221): skip-gram with negative
# sampling on a 50,000-type Zipf corpus of 2,000,000 words
W2V = dict(layer_size=128, window=5, negative=5, min_word_frequency=1,
           epochs=1, seed=1, batch_size=16384, scan_flushes=32)
W2V_CORPUS = (50_000, 50_000, 40)   # vocab, sentences, words a sentence
W2V_PASSES = 3
# Two fits from one seed on the card in torch's default mode:
# `index_add_` adds with atomics, so a row a batch hits more than once
# sums in another order, and the most frequent words' rows, clipped to a
# unit step every batch, carry those last bits on: the largest entry
# differences were 0.0317 and 0.147 in two runs on an H100, against 0.52
# for seeds 1 and 2. So the pair is held by the whole tables: the
# Frobenius norm of the difference of syn0 and syn1neg, over that of the
# tables, at most W2V_ATOMIC_RATIO of the same for seeds 1 and 2 in the
# same run. Under `torch.use_deterministic_algorithms` the fits must be
# bit-identical.
W2V_ATOMIC_RATIO = 0.25
# phase 35: a step on the card against the same step on the CPU and
# against this script's numpy f64 version: the largest |difference| within
# W2V_STEP_TOL of max(1, largest |reference|). The steps sum in f32, and
# at path 11's shapes one Zipf-frequent row takes ~30,000 of a batch's
# 98,304 updates: the f32 sum of those drifts from f64 by up to ~1e-5 of
# the row (7e-6 measured on the CPU), whatever the order. A planted fault
# moves the outputs by 1e-3 or more. Fits (every draw on the host), card
# against CPU, within W2V_FIT_TOL of the same.
W2V_STEP_TOL, W2V_FIT_TOL = 1e-4, 1e-4
# the lagging-device run: a GPU sleep of this many cycles (~20 ms) queued
# before every flush, so the device runs each flush's transfer well after
# the host has refilled its staging arrays
W2V_LAG_CYCLES = 40_000_000


def zipf_corpus(np, vocab_size, n_sentences, sent_len, seed=0):
    """bench.py's `_zipf_corpus` (`bench.py:1127-1134`): pre-tokenized
    sentences of Zipf-drawn words."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab_size + 1)
    probs /= probs.sum()
    words = np.array([f"w{i}" for i in range(vocab_size)])
    draws = rng.choice(vocab_size, (n_sentences, sent_len), p=probs)
    return [list(words[row]) for row in draws]


def topic_corpus(np, n_sentences=300, seed=0):
    """`tests/test_nlp.py`'s planted corpus: two disjoint topic
    vocabularies, words inside a topic co-occur, across topics never."""
    rng = np.random.default_rng(seed)
    topics = [["cat", "dog", "pet", "fur", "paw", "tail"],
              ["sun", "moon", "star", "sky", "orbit", "comet"]]
    return [list(rng.choice(topics[int(rng.integers(0, 2))], size=8))
            for _ in range(n_sentences)]


def topics_separate(w2v) -> bool:
    """`tests/test_nlp.py::test_word2vec_topic_separation`'s criterion."""
    nearest = [w for w, _ in w2v.words_nearest("sun", 3)]
    return (w2v.similarity("cat", "dog") > w2v.similarity("cat", "moon")
            and len(set(nearest) & {"moon", "star", "sky", "orbit",
                                    "comet"}) >= 2)


def tables_diff(torch, a, b):
    """(largest |difference|, Frobenius norm of the difference over that
    of `a`'s tables) between two fits' syn0 and syn1neg."""
    ta = [getattr(a.lookup_table, n) for n in ("syn0", "syn1neg")]
    tb = [getattr(b.lookup_table, n) for n in ("syn0", "syn1neg")]
    largest = max((x - y).abs().max().item() for x, y in zip(ta, tb))
    rel = math.sqrt(sum((x - y).double().pow(2).sum().item()
                        for x, y in zip(ta, tb))
                    / sum(x.double().pow(2).sum().item() for x in ta))
    return largest, rel


def counting_step(nlp, into):
    """The NS device step, counting its batches (host shapes only: no
    read of the device) into `into["batches"]`."""
    def step(*args):
        into["batches"] += args[2].shape[0]
        return nlp.kernels.skipgram_ns_scan(*args)
    return step


def recording_step(nlp, into):
    """The NS device step, recording each batch's learning rate (valid
    batches only; reads the device, for a small check)."""
    def step(*args):
        lrs, nv = args[7].cpu().numpy(), args[8].cpu().numpy()
        into.extend(lrs[nv > 0].tolist())
        return nlp.kernels.skipgram_ns_scan(*args)
    return step


def ns_draw_checks(torch, np, nlp, w2v, card):
    """The negatives the card draws (`kernels._draw_negatives` on the
    fit's fixed-point cdf, a fresh generator) against the 0.75-power
    table: a chi-square over words expected 5 times or more (the rest
    pooled), and every one of the 1000 rarest words drawn; then a table
    whose tail words sit below f32's resolution near 1 (a head of count
    1e10 over 2^14 words of count 1, each about 3.2e-8): with 1e8 draws
    at least 90% of the tail is drawn (an f32 cdf would give about half
    of the tail no slot at all)."""
    k = nlp.kernels
    cdf, _ = w2v._ns_device_state()
    p = w2v.vocab.unigram_table()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(101)
    counts = torch.zeros(len(p), dtype=torch.int64, device="cuda")
    n, chunk = 0, 1 << 22
    for _ in range(4):
        negs = k._draw_negatives(cdf, gen, chunk // 8, 8)
        counts += torch.bincount(negs.reshape(-1), minlength=len(p))
        n += chunk
    counts = counts.cpu().numpy().astype(np.float64)
    expected = n * p
    big = expected >= 5
    obs, exp = counts[big], expected[big]
    if not big.all():  # the words expected fewer than 5 times, pooled
        obs = np.append(obs, counts[~big].sum())
        exp = np.append(exp, expected[~big].sum())
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    dof = len(obs) - 1
    z = (chi2 - dof) / math.sqrt(2 * dof)
    rare = np.argsort(p, kind="stable")[:1000]
    rare_drawn = float((counts[rare] > 0).mean())
    log(f"  negatives on the card: {n} draws over V={len(p)}: chi-square "
        f"{chi2:.1f} on {dof} dof (z {z:.2f}); the 1000 rarest words "
        f"(expected {expected[rare].min():.1f}-{expected[rare].max():.1f} "
        f"draws each) drawn: {rare_drawn:.4f} [{card}]")
    if not (abs(z) < 6 and rare_drawn == 1.0):
        raise AssertionError(f"device negatives off the unigram table: "
                             f"z {z:.2f}, rarest drawn {rare_drawn}")
    cache = nlp.vocab.AbstractCache()
    cache.add_token(nlp.vocab.VocabWord("head", 1e10))
    n_tail = 1 << 14
    for i in range(n_tail):
        cache.add_token(nlp.vocab.VocabWord(f"t{i}", 1.0))
    cache.update_indices()
    sv = nlp.SequenceVectors(negative=5, device="cuda")
    sv.vocab, sv._unigram = cache, cache.unigram_table()
    cdf, _ = sv._ns_device_state()
    gen.manual_seed(102)
    tail_counts = torch.zeros(n_tail + 1, dtype=torch.int64, device="cuda")
    draws = 0
    while draws < 100_000_000:
        negs = k._draw_negatives(cdf, gen, 1 << 21, 8)
        tail_counts += torch.bincount(negs.reshape(-1), minlength=n_tail + 1)
        draws += 1 << 24
    drawn = (tail_counts[1:] > 0).float().mean().item()
    p_tail = float(cache.unigram_table()[1])
    log(f"  a head of count 1e10 over {n_tail} words of count 1 (p "
        f"{p_tail:.3g} each): {draws} draws reach {100 * drawn:.2f}% of "
        f"the tail (at least 90% required; "
        f"{100 * (1 - math.exp(-draws * p_tail)):.1f}% expected)")
    if not drawn >= 0.9:
        raise AssertionError(f"the tail collapsed: {drawn:.3f} of the "
                             "tail words drawn")


class deterministic_algorithms:
    """`torch.use_deterministic_algorithms(True)` inside the block (CUDA
    `index_add_` then sums in a fixed order), the earlier setting after
    it."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.was = self.torch.are_deterministic_algorithms_enabled()
        self.torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(self.was)


def same_tables(torch, a, b) -> bool:
    return all(torch.equal(getattr(a.lookup_table, n),
                           getattr(b.lookup_table, n))
               for n in ("syn0", "syn1neg"))


def host_breakdown(torch, nlp, w2v, sentences):
    """One more pass with the host pipeline's parts timed on the host
    clock (s): encoding the corpus to ids, the windows (`_window_pairs`),
    staging pairs (`add_pairs` less its flushes), the flushes (copies,
    transfers and the queued device steps; the device runs behind), the
    rest of the pass (sentence copies, chunking, subsampling, per-pair
    alphas), and the synchronize that ends it."""
    sv_mod = nlp.sequence_vectors
    cls, batcher = sv_mod.SequenceVectors, sv_mod._PairBatcher
    parts = dict.fromkeys(("encode", "windows", "staging", "flush"), 0.0)
    orig = (cls._encode_corpus, sv_mod._window_pairs, batcher.add_pairs,
            batcher.flush)

    def timed(fn, key, less=None):
        def run(*a, **k):
            t0 = time.perf_counter()
            before = parts[less] if less else 0.0
            try:
                return fn(*a, **k)
            finally:
                parts[key] += time.perf_counter() - t0 - (
                    parts[less] - before if less else 0.0)
        return run

    cls._encode_corpus = timed(orig[0], "encode")
    sv_mod._window_pairs = timed(orig[1], "windows")
    batcher.add_pairs = timed(orig[2], "staging", less="flush")
    batcher.flush = timed(orig[3], "flush")
    try:
        t0 = time.perf_counter()
        w2v.fit(sentences)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        (cls._encode_corpus, sv_mod._window_pairs, batcher.add_pairs,
         batcher.flush) = orig
    parts["rest"] = t1 - t0 - sum(parts.values())
    parts["synchronize"] = t2 - t1
    return {k: round(v, 4) for k, v in parts.items()}


def lagging_device_fit(torch, nlp, sentences, lag):
    """A Word2Vec fit whose device runs each flush's transfer late: with
    `lag`, a GPU sleep of W2V_LAG_CYCLES is queued before every flush, so
    the host refills its staging arrays while the transfer of the rows
    it flushed is still queued. A batcher that sends its staging arrays
    without a copy trains on the next batch's rows then."""
    batcher = nlp.sequence_vectors._PairBatcher
    orig = batcher.flush

    def flush(self):
        torch.cuda._sleep(W2V_LAG_CYCLES)
        return orig(self)

    w2v = nlp.Word2Vec(**{**W2V, "batch_size": 2048, "scan_flushes": 4},
                       device="cuda")
    if lag:
        batcher.flush = flush
    try:
        w2v.fit(sentences)
    finally:
        batcher.flush = orig
    torch.cuda.synchronize()
    return w2v


def phase_word2vec(torch, M, card):
    """Phase 34 (path 11): Word2Vec at bench_word2vec_50k's shape on the
    card, then its checks. Returns the path's figures."""
    import tempfile

    import numpy as np

    nlp, native = M["nlp"], M["native"]
    t0 = time.perf_counter()
    sentences = zipf_corpus(np, *W2V_CORPUS)
    n_words = sum(len(s) for s in sentences)
    log(f"  corpus: {len(sentences)} sentences, {n_words} words "
        f"({time.perf_counter() - t0:.1f} s to make)")
    t0 = time.perf_counter()
    built = native.native_available()  # g++ builds the library here
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "corpus.txt")
        with open(path, "w") as f:
            f.write("\n".join(" ".join(s) for s in sentences))
        t0 = time.perf_counter()
        files_vocab = nlp.VocabConstructor(1).build_vocab_from_files(
            [path], lowercase=False)
        files_ms = 1e3 * (time.perf_counter() - t0)
        route = native.loader.route
    w2v = nlp.Word2Vec(**W2V, device="cuda")
    t0 = time.perf_counter()
    w2v.build_vocab(sentences)
    vocab_ms = 1e3 * (time.perf_counter() - t0)
    V = w2v.vocab.num_words()
    same_vocab = [(v.word, v.count, v.index) for v in
                  files_vocab.vocab_words()] == \
        [(v.word, v.count, v.index) for v in w2v.vocab.vocab_words()]
    log(f"  vocabulary: V={V}; Word2Vec.build_vocab {vocab_ms:.1f} ms; "
        f"build_vocab_from_files {files_ms:.1f} ms on the {route} counter "
        f"route (the native library built by g++ in {build_s:.2f} s "
        f"before: {built}); the same vocabulary: {same_vocab}")
    if route != "native" or not same_vocab:
        raise AssertionError(f"vocabulary from files: route {route}, same "
                             f"as build_vocab: {same_vocab}")

    stats = {"batches": 0}
    w2v._ns_kernel = lambda: counting_step(nlp, stats)
    batcher = nlp.sequence_vectors._PairBatcher
    pairs = {"n": 0}
    orig_add = batcher.add_pairs

    def add_pairs(self, centers, contexts, alpha):
        pairs["n"] += len(centers)
        return orig_add(self, centers, contexts, alpha)

    w2v.fit(sentences[:300])  # warm-up: allocator, pinned blocks, cuBLAS
    torch.cuda.synchronize()
    walls, per_pass = [], []
    batcher.add_pairs = add_pairs
    try:
        for _ in range(W2V_PASSES):
            stats["batches"], pairs["n"] = 0, 0
            t0 = time.perf_counter()
            w2v.fit(sentences)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_pass.append((pairs["n"], stats["batches"]))
    finally:
        batcher.add_pairs = orig_add
    med = sorted(walls)[len(walls) // 2]
    n_pairs, n_batches = per_pass[len(per_pass) // 2]
    loss = w2v.mean_loss
    per_name: dict = {}
    trace = traced(torch, lambda: w2v.fit(sentences), per_name)
    figures = {"vocab_ms": round(vocab_ms, 1),
               "vocab_from_files_ms": round(files_ms, 1),
               "counter_route": route, "fit_s": round(med, 4),
               "words_per_s": round(n_words / med, 1),
               "pairs_per_s": round(n_pairs / med, 1),
               "pairs_per_pass": n_pairs, "batches_per_pass": n_batches}
    log(f"  path 11: fit walls {[round(t, 3) for t in walls]} s; median "
        f"{med:.3f} s = {n_words / med:.1f} words/s, "
        f"{n_pairs / med:.1f} pairs/s; {n_pairs} pairs in {n_batches} "
        f"batches of {W2V['batch_size']} a pass; mean loss {loss:.4f} "
        f"[{card}]")
    log(f"  traced pass (torch.profiler, not in the walls): {trace}")
    figures["host_s"] = host_breakdown(torch, nlp, w2v, sentences)
    log(f"  one more pass, its host parts (s, host clock): "
        f"{figures['host_s']}")
    if not (math.isfinite(loss) and loss > 0 and n_batches > 0):
        raise AssertionError(f"path 11: loss {loss}, {n_batches} batches")
    ns_draw_checks(torch, np, nlp, w2v, card)

    # the same seed twice on the card: apart only by the atomics' order;
    # under torch's deterministic algorithms, bit for bit, and so is a
    # fit whose device lags behind the host (each flush trains on the
    # rows it staged)
    fits = [nlp.Word2Vec(**{**W2V, "seed": seed}, device="cuda")
            for seed in (1, 1, 2)]
    for m in fits:
        m.fit(sentences)
    torch.cuda.synchronize()
    (same_seed, same_rel), (other_seed, other_rel) = (
        tables_diff(torch, fits[0], fits[1]),
        tables_diff(torch, fits[0], fits[2]))
    bits = int((fits[0].lookup_table.syn0 !=
                fits[1].lookup_table.syn0).sum().item())
    del fits
    det, det_walls = [], []
    with deterministic_algorithms(torch):
        for _ in range(2):
            m = nlp.Word2Vec(**W2V, device="cuda")
            m.build_vocab(sentences)
            t0 = time.perf_counter()
            m.fit(sentences)
            torch.cuda.synchronize()
            det_walls.append(time.perf_counter() - t0)
            det.append(m)
        det_equal = same_tables(torch, *det)
        del det
        small = sentences[:5000]
        lag_equal = same_tables(
            torch, lagging_device_fit(torch, nlp, small, False),
            lagging_device_fit(torch, nlp, small, True))
    figures.update(same_seed_max_diff=same_seed, same_seed_rel=same_rel,
                   other_seed_max_diff=other_seed, other_seed_rel=other_rel,
                   deterministic_fit_s=round(min(det_walls), 4))
    log(f"  same seed twice on the card: syn0/syn1neg max |diff| "
        f"{same_seed:.4g}, relative Frobenius {same_rel:.4g} ({bits} of "
        f"{V * W2V['layer_size']} syn0 entries differ); seeds 1 and 2: "
        f"{other_seed:.4g}, {other_rel:.4g} (ratio {same_rel / other_rel:.4g}"
        f", at most {W2V_ATOMIC_RATIO}); under "
        f"torch.use_deterministic_algorithms: "
        f"bit-identical {det_equal} (fit walls "
        f"{[round(t, 3) for t in det_walls]} s against {med:.3f}), and "
        f"the device lagging {W2V_LAG_CYCLES} cycles a flush against "
        f"prompt, 200,000 words: bit-identical {lag_equal}")
    if not (same_rel <= W2V_ATOMIC_RATIO * other_rel and det_equal
            and lag_equal):
        raise AssertionError(
            f"same-seed fits {same_rel} apart (seeds 1, 2: {other_rel}); "
            f"deterministic fits equal {det_equal}, the lagging fit equal "
            f"{lag_equal}")

    # the reference's topic separation, and the per-pair alpha decay
    lrs = []
    topic = nlp.Word2Vec(negative=5, layer_size=24, window=3, epochs=3,
                         batch_size=256, learning_rate=0.05, seed=7,
                         device="cuda")
    topic._ns_kernel = lambda: recording_step(nlp, lrs)
    topic.fit(topic_corpus(np))
    decays = (lrs[0] == float(np.float32(0.05))
              and all(x > y for x, y in zip(lrs, lrs[1:]))
              and lrs[-1] < 0.1 * lrs[0])
    log(f"  planted topics on the card: cat~dog "
        f"{topic.similarity('cat', 'dog'):.3f}, cat~moon "
        f"{topic.similarity('cat', 'moon'):.3f}, nearest to sun "
        f"{[w for w, _ in topic.words_nearest('sun', 3)]}; {len(lrs)} "
        f"batches' alphas {lrs[0]:.5f} .. {lrs[-1]:.6f}, strictly falling "
        f"within the one chunk: {decays}")
    if not (topics_separate(topic) and decays):
        raise AssertionError(f"planted topics: separated "
                             f"{topics_separate(topic)}, alpha decays "
                             f"{decays}")
    return figures


# numpy f64 versions of the NLP steps, written here from the JAX
# package's math (not taken from the port), for phase 35
def np_log_sigmoid(np, z):
    return -np.logaddexp(0.0, -z)


def np_scatter_clipped(np, table, idx, upd, clip=1.0):
    agg = np.zeros_like(table)
    np.add.at(agg, idx.reshape(-1), upd.reshape(-1, upd.shape[-1]))
    norms = np.linalg.norm(agg, axis=-1, keepdims=True)
    return table + agg * np.minimum(1.0, clip / np.maximum(norms, 1e-12))


def np_ll_loss(np, logits, labels, mask):
    ll = np.where(labels > 0, np_log_sigmoid(np, logits),
                  np_log_sigmoid(np, -logits))
    return -np.sum(ll * mask) / max(np.sum(mask), 1.0)


def np_pair_update(np, syn0, syn1, center, targets, labels, mask, lr):
    v, u = syn0[center], syn1[targets]
    logits = np.einsum("bd,bkd->bk", v, u)
    g = (labels - 1 / (1 + np.exp(-logits))) * mask * lr
    dv = np.einsum("bk,bkd->bd", g, u)
    du = g[..., None] * v[:, None, :]
    return (np_scatter_clipped(np, syn0, center, dv),
            np_scatter_clipped(np, syn1, targets, du),
            np_ll_loss(np, logits, labels, mask))


def np_cbow(np, syn0, syn1, ctx, cmask, targets, labels, tmask, lr):
    cv = syn0[ctx] * cmask[..., None]
    denom = np.maximum(cmask.sum(1, keepdims=True), 1.0)
    h = cv.sum(1) / denom
    u = syn1[targets]
    logits = np.einsum("bd,bkd->bk", h, u)
    g = (labels - 1 / (1 + np.exp(-logits))) * tmask * lr
    dh = np.einsum("bk,bkd->bd", g, u)
    du = g[..., None] * h[:, None, :]
    dctx = np.broadcast_to(dh[:, None, :], cv.shape) * cmask[..., None] \
        / denom[..., None]
    return (np_scatter_clipped(np, syn0, ctx, dctx),
            np_scatter_clipped(np, syn1, targets, du),
            np_ll_loss(np, logits, labels, tmask))


def np_infer(np, vec, syn1, targets, labels, mask, lr):
    u = syn1[targets]
    logits = np.einsum("d,bkd->bk", vec, u)
    g = (labels - 1 / (1 + np.exp(-logits))) * mask * lr
    return vec + np.einsum("bk,bkd->d", g, u), \
        np_ll_loss(np, logits, labels, mask)


def np_glove(np, W, b, hW, hb, Wc, bc, hWc, hbc, rows, cols, logX, fX, lr):
    W, b, hW, hb, Wc, bc, hWc, hbc = (a.copy() for a in (W, b, hW, hb, Wc,
                                                         bc, hWc, hbc))
    wi, wj = W[rows], Wc[cols]
    diff = (wi * wj).sum(1) + b[rows] + bc[cols] - logX
    wd = fX * diff
    gWi, gWj = wd[:, None] * wj, wd[:, None] * wi
    np.add.at(hW, rows, gWi ** 2)
    np.add.at(hWc, cols, gWj ** 2)
    np.add.at(hb, rows, wd ** 2)
    np.add.at(hbc, cols, wd ** 2)
    np.add.at(W, rows, -lr * gWi / np.sqrt(hW[rows] + 1e-8))
    np.add.at(Wc, cols, -lr * gWj / np.sqrt(hWc[cols] + 1e-8))
    np.add.at(b, rows, -lr * wd / np.sqrt(hb[rows] + 1e-8))
    np.add.at(bc, cols, -lr * wd / np.sqrt(hbc[cols] + 1e-8))
    return W, b, hW, hb, Wc, bc, hWc, hbc, 0.5 * np.mean(fX * diff ** 2)


def step_case(torch, np, what, run, ref, tol=W2V_STEP_TOL):
    """`run(device)` on the card and on the CPU against `ref` (numpy
    f64): each output within tol * max(1, max|ref|), card and CPU alike,
    and card within the same of CPU. Logs each output's worst error in
    those units; returns the worst."""
    card, cpu = run("cuda"), run("cpu")
    host = lambda g: (g.detach().cpu().double().numpy()
                      if isinstance(g, torch.Tensor)
                      else np.asarray(g, np.float64))
    units = []
    for g_card, g_cpu, r in zip(card, cpu, ref):
        r = np.asarray(r, np.float64)
        scale = tol * max(1.0, float(np.abs(r).max()))
        a, b = host(g_card), host(g_cpu)
        units.append(max(float(np.abs(a - r).max()),
                         float(np.abs(b - r).max()),
                         float(np.abs(a - b).max())) / scale)
    worst = max(units)
    log(f"  {what}: card and CPU against numpy f64, each output's worst "
        f"in units of the tolerance {[round(u, 4) for u in units]}")
    if not worst <= 1.0:
        raise AssertionError(f"{what}: {worst:.3g} times the tolerance")
    return worst


def phase_word2vec_parity(torch, M):
    """Phase 35: the NLP steps on the card against the CPU and numpy at
    path 11's shapes, then CBOW, hierarchical-softmax, ParagraphVectors
    and GloVe fits on the card against the CPU (TF32 off)."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    nlp = M["nlp"]
    k = nlp.kernels
    rng = np.random.default_rng(35)
    B, D, N = W2V["batch_size"], W2V["layer_size"], W2V["negative"]
    f32 = lambda a: np.asarray(a, np.float32)
    # a fresh copy each call: the steps update their tables in place
    T = lambda a, dev: torch.from_numpy(np.array(a)).to(dev)
    L = lambda a, dev: T(np.asarray(a, np.int64), dev)
    zipf = lambda V, shape: np.minimum(
        rng.zipf(1.3, shape) - 1, V - 1).astype(np.int64)

    # _scatter_clipped: both regimes, updates large enough that the clip
    # binds on the frequent rows
    for V, regime in ((50_000, "table-shaped accumulator"),
                      (200_000, "argsort + segment sum")):
        table = f32(0.3 * rng.standard_normal((V, D)))
        idx = zipf(V, (B,))
        upd = f32(0.05 * rng.standard_normal((B, D)))
        ref = np_scatter_clipped(np, table.astype(np.float64), idx,
                                 upd.astype(np.float64))
        clipped = int((np.linalg.norm(ref - table, axis=1) > 0.999).sum())
        step_case(torch, np, f"_scatter_clipped V={V} ({regime}; "
                  f"{clipped} rows clipped)",
                  lambda dev: [k._scatter_clipped(T(table, dev),
                                                  L(idx, dev),
                                                  T(upd, dev))], [ref])
        if clipped == 0:
            raise AssertionError("the _scatter_clipped case clips no row")

    V = W2V_CORPUS[0]
    syn0 = f32(0.3 * rng.standard_normal((V, D)))
    syn1 = f32(0.3 * rng.standard_normal((V, D)))
    center, context = zipf(V, (B,)), zipf(V, (B,))
    negs = zipf(V, (B, N))
    negs[::7, 2] = context[::7]  # negatives equal to their context
    nvalid = B - 1000
    targets = np.concatenate([context[:, None], negs], 1)
    labels = np.zeros((B, N + 1))
    labels[:, 0] = 1
    mask = np.concatenate([np.ones((B, 1)), (negs != context[:, None])], 1)
    mask[nvalid:] = 0
    lr = 0.025
    d64 = lambda *a: [np.asarray(x, np.float64) for x in a]
    ref = np_pair_update(np, *d64(syn0, syn1), center, targets, labels, mask,
                         lr)
    step_case(torch, np, f"skipgram_step B={B} K={N + 1} V={V}",
              lambda dev: k.skipgram_step(
                  T(syn0, dev), T(syn1, dev), L(center, dev),
                  L(targets, dev), T(f32(labels), dev), T(f32(mask), dev),
                  lr), ref)
    step_case(torch, np, f"_ns_batch with given negatives ({len(negs[::7])} "
              f"equal to their context, rows past {nvalid} masked)",
              lambda dev: k._ns_batch(
                  T(syn0, dev), T(syn1, dev), None, L(center, dev),
                  L(context, dev), None, lr,
                  torch.tensor(nvalid, device=dev), N,
                  negs=L(negs, dev))[:3], ref)
    W = 2 * W2V["window"]
    ctx = zipf(V, (B, W))
    cmask = (rng.random((B, W)) < 0.8).astype(np.float64)
    ref = np_cbow(np, *d64(syn0, syn1), ctx, cmask, targets, labels, mask, lr)
    step_case(torch, np, f"cbow_step B={B} W={W}",
              lambda dev: k.cbow_step(
                  T(syn0, dev), T(syn1, dev), L(ctx, dev),
                  T(f32(cmask), dev), L(targets, dev), T(f32(labels), dev),
                  T(f32(mask), dev), lr), ref)
    vec = f32(0.1 * rng.standard_normal(D))
    ref = np_infer(np, *d64(vec, syn1), targets[:512], labels[:512],
                   mask[:512], 0.05)
    step_case(torch, np, "infer_step 512 words",
              lambda dev: k.infer_step(
                  T(vec, dev), T(syn1, dev), L(targets[:512], dev),
                  T(f32(labels[:512]), dev), T(f32(mask[:512]), dev),
                  0.05), ref)
    Vg = 5000
    tabs = [f32(0.1 * rng.standard_normal((Vg, D))), f32(np.zeros(Vg)),
            f32(np.ones((Vg, D))), f32(np.ones(Vg)),
            f32(0.1 * rng.standard_normal((Vg, D))), f32(np.zeros(Vg)),
            f32(np.ones((Vg, D))), f32(np.ones(Vg))]
    rows, cols = zipf(Vg, (B,)), zipf(Vg, (B,))
    x = rng.uniform(0.5, 200.0, B)
    logX, fX = f32(np.log(x)), f32(np.minimum((x / 100.0) ** 0.75, 1.0))
    ref = np_glove(np, *d64(*tabs), rows, cols, *d64(logX, fX), 0.05)
    step_case(torch, np, f"glove_step B={B} V={Vg} (duplicate rows)",
              lambda dev: k.glove_step(
                  *[T(t, dev) for t in tabs], L(rows, dev), L(cols, dev),
                  T(logX, dev), T(fX, dev), 0.05), ref)

    # fits whose draws are all on the host: the card against the CPU
    corpus = topic_corpus(np, 400, seed=5)
    kw = dict(layer_size=32, window=3, batch_size=512, seed=7)
    docs = [(f"d{i}", " ".join(s)) for i, s in enumerate(corpus[:120])]
    fits = {
        "CBOW (host negatives)": lambda dev: nlp.Word2Vec(
            negative=5, elements_learning_algorithm="cbow", epochs=3,
            learning_rate=0.1, device=dev, **kw),
        "hierarchical softmax": lambda dev: nlp.Word2Vec(
            negative=0, use_hierarchic_softmax=True, epochs=3,
            learning_rate=0.05, device=dev, **kw),
        "ParagraphVectors DBOW HS": lambda dev: nlp.ParagraphVectors(
            negative=0, use_hierarchic_softmax=True, epochs=4,
            device=dev, **kw),
        "GloVe": lambda dev: nlp.Glove(layer_size=32, epochs=10,
                                       batch_size=256, device=dev),
    }
    for what, make in fits.items():
        got = {}
        for dev in ("cuda", "cpu"):
            m = make(dev)
            m.fit(docs if "Paragraph" in what else corpus)
            out = [m.lookup_table.syn0]
            if "Paragraph" in what:
                out.append(torch.from_numpy(
                    m.infer_vector("cat dog pet fur", steps=10)))
            got[dev] = out
        worst = max(
            (a.cpu() - b).abs().max().item()
            / (W2V_FIT_TOL * max(1.0, b.abs().max().item()))
            for a, b in zip(got["cuda"], got["cpu"]))
        log(f"  {what} fit, card against CPU: worst {worst:.3g} of "
            f"{W2V_FIT_TOL} x max(1, |ref|)")
        if not worst <= 1.0:
            raise AssertionError(f"{what}: card off the CPU by {worst:.3g} "
                                 "times the tolerance")


def phases_34_35(torch, M, card):
    """Phases 34 and 35; path 11's figures."""
    log("[34/43] path 11: Word2Vec skip-gram NS at bench_word2vec_50k's "
        "shape (V=50,000, 2,000,000 words, D=128, B=16384, 32 batches a "
        "flush) on the card")
    figures = phase_word2vec(torch, M, card)
    log("[35/43] the NLP steps and host-drawn fits, card against CPU and "
        "numpy (TF32 off)")
    phase_word2vec_parity(torch, M)
    return figures


def phases_34_35_alone(torch, M) -> int:
    """`--phases-34-35`: phases 34 and 35 alone (no CUDA source of the
    port runs there), then one JSON line of path 11's figures."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    log(f"phases 34-35 alone [{card}]")
    figures = phases_34_35(torch, M, card)
    log(f"phases 34-35 {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, "path 11": figures}), flush=True)
    return 0


# ---------------------------------------------------------------- path 12
# The graph: a planted partition with BlogCatalog's counts (Tang & Liu,
# KDD 2009; one of the DeepWalk paper's datasets, Perozzi et al., KDD
# 2014): 10,312 vertices, 333,983 undirected edges, 39 groups, 80% of the
# edges inside a group; made on the host from a seed (no dataset is
# downloaded).
EMBED_GRAPH = dict(n=10_312, edges=333_983, groups=39, p_in=0.8, seed=12)
# DeepWalk with the paper's settings (d=128, w=10, t=40; gamma=80 walks a
# vertex cut to 2, for time), negative 5, path 11's batch of 16384
EMBED_DW = dict(vector_size=128, window_size=10, walk_length=40,
                walks_per_vertex=2, negative=5, batch_size=16384, seed=12)
EMBED_TSNE = dict(perplexity=30.0, n_iter=1000, seed=12)  # the defaults
# floors set from a CPU rehearsal at the same shape (PERF.md §6: NMI
# 0.690, neighbour share 0.969), less a margin for the card's
# negatives, which are other draws: the NMI of k-means (K=39, one Lloyd
# iteration, the reference's stop rule) against the planted groups, and
# the share of each vertex's 10 nearest t-SNE neighbours in its group
EMBED_NMI_FLOOR = 0.6
EMBED_KNN_FLOOR = 0.85
EMBED_KNN = 10
EMBED_UI_STEPS = 5
# phase 37: a step on the card against the same step on the CPU, each
# output's largest |difference| within EMBED_STEP_TOL of its largest
# |value|; both against this script's numpy f64 version within
# EMBED_F64_TOL of the same (the f32 expansion |yi|² - 2 yi.yj + |yj|²
# and the sums' order put ~1e-6 there)
EMBED_STEP_TOL, EMBED_F64_TOL = 1e-5, 1e-4
EMBED_TSNE_N = 2048


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def planted_graph(np, Graph, n, edges, groups, p_in, seed):
    """(graph, group of each vertex, share of edges inside a group): each
    edge draws a vertex, then with probability p_in a partner in its
    group, else one outside it; self-loops and repeated pairs are
    dropped until `edges` distinct undirected edges remain."""
    rng = np.random.default_rng(seed)
    group = rng.permutation(np.arange(n) % groups)
    order = np.argsort(group, kind="stable")  # vertices grouped
    sizes = np.bincount(group, minlength=groups)
    offs = np.cumsum(sizes) - sizes
    m = int(edges * 1.25)
    src = rng.integers(0, n, m)
    gs = group[src]
    inside = rng.random(m) < p_in
    dst_in = order[offs[gs] + (rng.random(m) * sizes[gs]).astype(np.int64)]
    r = (rng.random(m) * (n - sizes[gs])).astype(np.int64)
    dst_out = order[np.where(r >= offs[gs], r + sizes[gs], r)]
    dst = np.where(inside, dst_in, dst_out)
    keep = src != dst
    a, b = np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]
    _, first = np.unique(a * n + b, return_index=True)
    first = np.sort(first)[:edges]
    if len(first) != edges:
        raise AssertionError(f"planted graph: {len(first)} of {edges} edges")
    a, b = a[first], b[first]
    g = Graph(n)
    for s, d in zip(a.tolist(), b.tolist()):
        g.add_edge(s, d)
    return g, group, float(np.mean(group[a] == group[b]))


def nmi(np, a, b) -> float:
    """Normalized mutual information of two labelings (the arithmetic
    mean of the entropies as the normalizer)."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    C = np.zeros((ai.max() + 1, bi.max() + 1))
    np.add.at(C, (ai, bi), 1.0)
    pij = C / C.sum()
    pi, pj = pij.sum(1), pij.sum(0)
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / np.outer(pi, pj)[nz])).sum())
    h = lambda p: float(-(p[p > 0] * np.log(p[p > 0])).sum())
    return mi / max((h(pi) + h(pj)) / 2, 1e-12)


def nearest_within_rounding(np, X, C, labels) -> bool:
    """Whether each label names a nearest centroid of `C`, by f64
    distances, up to f32 rounding of the expansion |x|² - 2 x.c + |c|²
    (1e-5 of |x|² + |c|², far above it): DeepWalk's vectors sit ~1e-3
    from their centroids, and two centroids can be within 1e-6, so an
    f32 argmin may take either."""
    X, C = X.astype(np.float64), C.astype(np.float64)
    x2, c2 = (X * X).sum(1), (C * C).sum(1)
    d2 = x2[:, None] - 2.0 * X @ C.T + c2[None]
    gap = d2[np.arange(len(X)), labels] - d2.min(1)
    return bool((gap <= 1e-5 * (x2 + c2.max())).all())


def embed_deepwalk(torch, M, g, dev):
    """Path 12's DeepWalk fit: (model, its walks, figures). The fit's
    walk and training parts are timed apart (the walks are host Python,
    the reference's `RandomWalkIterator`)."""
    dw = M["graph"].DeepWalk(**EMBED_DW, device=dev)
    sv, rec = dw._sv, {}
    fit = sv.fit

    def timed_fit(walks):
        rec["walks"], rec["t0"] = walks, time.perf_counter()
        fit(walks)
        sync(torch, dev)
        rec["t1"] = time.perf_counter()

    sv.fit = timed_fit
    t0 = time.perf_counter()
    try:
        dw.fit(g)
    finally:
        del sv.fit
    words = sum(len(w) for w in rec["walks"])
    fig = {"walks": len(rec["walks"]), "words": words,
           "walk_s": round(rec["t0"] - t0, 3),
           "fit_s": round(rec["t1"] - rec["t0"], 3),
           "words_per_s": round(words / (rec["t1"] - rec["t0"]), 1),
           "mean_loss": round(sv.mean_loss, 5)}
    if not (math.isfinite(sv.mean_loss) and sv.mean_loss > 0
            and dw.vocab.num_words() == g.num_vertices()):
        raise AssertionError(f"DeepWalk: loss {sv.mean_loss}, "
                             f"{dw.vocab.num_words()} vertices in the vocab")
    return dw, rec["walks"], fig


def embed_kmeans(torch, np, M, X, truth, dev):
    """k-means with K=39 of the DeepWalk vectors: figures; two same-seed
    fits identical, labels consistent with `predict`, the NMI against the
    planted groups at least EMBED_NMI_FLOOR."""
    K = EMBED_GRAPH["groups"]
    Xd = torch.from_numpy(X).to(dev)
    fits, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        fits.append(M["clustering"].KMeansClustering(
            K, seed=EMBED_GRAPH["seed"], device=dev).fit(Xd))
        walls.append(time.perf_counter() - t0)
    km = fits[0]
    same = (np.array_equal(fits[0].labels_, fits[1].labels_)
            and np.array_equal(fits[0].centroids, fits[1].centroids))
    consistent = nearest_within_rounding(np, X, km.centroids, km.labels_)
    score = nmi(np, truth, km.labels_)
    fig = {"fit_s": round(walls[0], 4), "fit_s_again": round(walls[1], 4),
           "iterations": km.n_iter_, "cost": km.cost, "nmi": round(score, 4)}
    log(f"  k-means K={K} on the card: fits {walls[0]:.3f} / "
        f"{walls[1]:.3f} s, {km.n_iter_} iterations, cost {km.cost:.4g}; "
        f"NMI against the planted groups {score:.4f} (floor "
        f"{EMBED_NMI_FLOOR}); same seed twice identical: {same}; labels_ "
        f"a nearest stored centroid within f32 rounding: {consistent} "
        f"({int((km.labels_ != km.predict(X)).sum())} differ from "
        "`predict`'s host f32 argmin)")
    if not (same and consistent and score >= EMBED_NMI_FLOOR):
        raise AssertionError(f"k-means: same-seed fits identical {same}, "
                             f"labels consistent {consistent}, NMI {score}")
    return km, fig


def embed_tsne(torch, np, M, X, truth, dev):
    """Exact t-SNE of every vector: (embedding, figures); the KL falls
    after the lying phase, and most of each vertex's nearest neighbours
    in the embedding share its planted group."""
    ts_mod = M["tsne"]
    ts = M["clustering"].Tsne(**EMBED_TSNE, device=dev)
    search, steps = {}, []
    probs = ts._input_probabilities

    def timed_probs(x):
        t0 = time.perf_counter()
        out = probs(x)
        search["s"] = time.perf_counter() - t0
        return out

    step = ts_mod._tsne_step

    def timed_step(*a):
        t0 = time.perf_counter()
        out = step(*a)
        sync(torch, dev)
        steps.append(time.perf_counter() - t0)
        return out

    ts._input_probabilities = timed_probs
    ts_mod._tsne_step = timed_step
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        Y = ts.fit_transform(X)
    finally:
        ts_mod._tsne_step = step
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    h = ts.error_history_
    lying = ts._stop_lying() // ts.error_every  # reports before it ends
    falls = all(map(math.isfinite, h)) and h[-1] < h[lying]
    Yd = torch.from_numpy(Y).to(dev)
    d = torch.cdist(Yd, Yd)
    d.fill_diagonal_(float("inf"))
    nbrs = d.topk(EMBED_KNN, largest=False).indices.cpu().numpy()
    del d
    share = float((truth[nbrs] == truth[:, None]).mean())
    med = sorted(steps)[len(steps) // 2]
    fig = {"wall_s": round(wall, 3), "search_s": round(search["s"], 3),
           "iteration_ms_median": round(1e3 * med, 4),
           "kl_history": [round(k, 4) for k in h],
           "knn_share": round(share, 4),
           "peak_device_mb": None if peak is None else round(peak / 2**20, 1)}
    log(f"  t-SNE of {len(X)} vectors ({EMBED_TSNE}): "
        f"{wall:.2f} s, the host perplexity search {search['s']:.2f} s, "
        f"an iteration {1e3 * med:.3f} ms (median); KL "
        f"{[round(k, 3) for k in h]}; after the lying phase it falls: "
        f"{falls}; {EMBED_KNN} nearest neighbours in the planted group: "
        f"{share:.4f} (floor {EMBED_KNN_FLOOR}); peak device memory "
        f"{fig['peak_device_mb']} MB")
    if not (falls and np.isfinite(Y).all() and Y.shape == (len(X), 2)
            and share >= EMBED_KNN_FLOOR):
        raise AssertionError(f"t-SNE: KL falls {falls}, shape {Y.shape}, "
                             f"neighbour share {share}")
    return Y, fig


def embed_ui(torch, np, M, X, truth, Y, vids):
    """The training UI on the card's host: a UIServer with in-memory
    storage, a StatsListener reporting a few fit steps of a classifier of
    the vectors on the card through the remote router, the system and
    histogram feeds checked, then the t-SNE points uploaded and
    rendered."""
    import urllib.request

    ui, C = M["ui"], M["conf"]
    server = ui.UIServer(port=0)
    try:
        storage = ui.InMemoryStatsStorage()
        server.attach(storage)
        base = f"http://127.0.0.1:{server.port}"
        router = ui.RemoteUIStatsStorageRouter(base)
        K = EMBED_GRAPH["groups"]
        conf = (C.NeuralNetConfiguration.Builder().seed(12)
                .learning_rate(0.05).list()
                .layer(C.DenseLayer(n_in=X.shape[1], n_out=256,
                                    activation=M["Activation"].RELU))
                .layer(C.OutputLayer(n_in=256, n_out=K,
                                     loss=M["LossFunction"].MCXENT,
                                     activation=M["Activation"].SOFTMAX))
                .build())
        net = M["MultiLayerNetwork"](conf, device="cuda")
        net.init()
        net.set_listeners(ui.StatsListener(router, session_id="path-12"))
        data = M["DataSet"](X, np.eye(K, dtype=np.float32)[truth])
        for _ in range(EMBED_UI_STEPS):
            net.fit(data)
        router.shutdown()
        get = lambda p: json.loads(urllib.request.urlopen(base + p).read())
        sysd = get("/train/system")
        hist = get("/train/histograms")
        latest = storage.get_latest_record("path-12", "stats").data
        named = dict(ui.StatsListener._named_params(net))
        current = all(latest["parameters"][n] ==
                      M["stats_listener"]._array_stats(a)
                      for n, a in named.items())
        counts_ok = set(hist["parameters"]) == set(named) and all(
            sum(hist["parameters"][n]["histogram_counts"]) == a.numel()
            for n, a in named.items())
        in_use = sysd["device_bytes_in_use"]
        limit = latest["system"].get("device_bytes_limit")
        total = torch.cuda.get_device_properties(0).total_memory
        payload = json.dumps({"coords": Y.tolist(),
                              "labels": [str(v) for v in vids]}).encode()
        t0 = time.perf_counter()
        req = urllib.request.Request(base + "/tsne/upload", data=payload,
                                     method="POST")
        up = json.loads(urllib.request.urlopen(req).read())
        upload_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        page = urllib.request.urlopen(base + "/tsne").read().decode()
        render_s = time.perf_counter() - t0
        circles = page.count("<circle")
    finally:
        server.stop()
    fig = {"reports": len(sysd["iterations"]),
           "device_bytes_in_use": in_use[-1] if in_use else None,
           "upload_s": round(upload_s, 4), "render_s": round(render_s, 4),
           "page_mb": round(len(page) / 2**20, 2),
           "dropped": router.dropped_count}
    log(f"  UI: {fig['reports']} reports through the remote router "
        f"({router.dropped_count} dropped); /train/system device bytes in "
        f"use {in_use}, limit {limit} (the card's {total}); histograms for "
        f"every parameter: {counts_ok}; the last report's statistics are "
        f"the trained parameters': {current}; /tsne/upload of {len(Y)} "
        f"points answered {up} in {upload_s:.3f} s; /tsne rendered "
        f"{circles} points in {render_s:.3f} s ({fig['page_mb']} MB)")
    if not (fig["reports"] == EMBED_UI_STEPS and in_use
            and all(b is not None and b > 0 for b in in_use)
            and limit == total and counts_ok and current
            and up.get("points") == len(Y) and circles == len(Y)):
        raise AssertionError(f"UI: reports {fig['reports']}, device bytes "
                             f"{in_use}, limit {limit}, histograms "
                             f"{counts_ok}, current {current}, upload {up}"
                             f", circles {circles}")
    return fig


def phase_embed(torch, M, card):
    """Phase 36 (path 12): the planted graph, DeepWalk on the card,
    k-means and exact t-SNE of its vectors on the card, the UI. Returns
    the path's figures."""
    import numpy as np

    t0 = time.perf_counter()
    g, group, inside = planted_graph(np, M["graph"].Graph, **EMBED_GRAPH)
    graph_s = time.perf_counter() - t0
    log(f"  planted graph: {g.num_vertices()} vertices, "
        f"{EMBED_GRAPH['edges']} edges ({100 * inside:.1f}% inside a "
        f"group), {EMBED_GRAPH['groups']} groups, built in {graph_s:.2f} s")
    dw, walks, fig_dw = embed_deepwalk(torch, M, g, "cuda")
    log(f"  DeepWalk: {fig_dw['walks']} walks of {EMBED_DW['walk_length']} "
        f"({fig_dw['words']} words) in {fig_dw['walk_s']} s of host "
        f"Python; the fit {fig_dw['fit_s']} s on the card = "
        f"{fig_dw['words_per_s']} words/s; mean loss {fig_dw['mean_loss']} "
        f"[{card}]")
    X = dw.lookup_table.syn0.float().cpu().numpy()
    vids = np.array([int(dw.vocab.word_at_index(i)) for i in range(len(X))])
    truth = group[vids]
    _, fig_km = embed_kmeans(torch, np, M, X, truth, "cuda")
    Y, fig_ts = embed_tsne(torch, np, M, X, truth, "cuda")
    fig_ui = embed_ui(torch, np, M, X, truth, Y, vids)
    trace = traced(torch, lambda: dw._sv.fit(walks))
    log(f"  one more DeepWalk epoch on the same walks under torch.profiler: "
        f"{trace}")
    return {"graph_s": round(graph_s, 3), "deepwalk": fig_dw,
            "deepwalk_traced": trace, "kmeans": fig_km, "tsne": fig_ts,
            "ui": fig_ui}


# numpy f64 versions of k-means' Lloyd step and t-SNE's step and KL,
# written here from the JAX package's math (not taken from the port), for
# phase 37
def np_lloyd(np, X, C):
    d2 = ((X * X).sum(1)[:, None] - 2.0 * X @ C.T + (C * C).sum(1)[None])
    a = d2.argmin(1)
    counts = np.bincount(a, minlength=len(C)).astype(np.float64)
    sums = np.zeros_like(C)
    np.add.at(sums, a, X)
    new = np.where(counts[:, None] > 0,
                   sums / np.maximum(counts, 1.0)[:, None], C)
    return new, a, d2.min(1).sum()


def np_tsne_num(np, Y):
    y2 = (Y * Y).sum(1)
    num = 1.0 / (1.0 + (y2[:, None] - 2.0 * Y @ Y.T + y2[None]))
    np.fill_diagonal(num, 0.0)
    return num


def np_tsne_step(np, Y, V, G, P, momentum, lr, min_gain):
    num = np_tsne_num(np, Y)
    Q = num / max(num.sum(), 1e-12)
    PQ = (P - np.maximum(Q, 1e-12)) * num
    grad = 4.0 * ((np.diag(PQ.sum(1)) - PQ) @ Y)
    G = np.maximum(np.where(grad * V > 0, G * 0.8, G + 0.2), min_gain)
    V = momentum * V - lr * G * grad
    Y = Y + V
    return Y - Y.mean(0), V, G


def np_tsne_kl(np, Y, P):
    num = np_tsne_num(np, Y)
    Q = num / max(num.sum(), 1e-12)
    return float((P * np.log(np.maximum(P, 1e-12)
                             / np.maximum(Q, 1e-12))).sum())


def embed_case(torch, np, what, run, ref):
    """`run(device)` on the card and on the CPU: each output's largest
    |difference| card against CPU within EMBED_STEP_TOL, and card and CPU
    against `ref` (numpy f64) within EMBED_F64_TOL, of the output's
    largest |ref|. Logs the worst of each in units of its tolerance; the
    card's outputs are returned."""
    card, cpu = run("cuda"), run("cpu")
    host = lambda g: (g.detach().cpu().double().numpy()
                      if isinstance(g, torch.Tensor)
                      else np.asarray(g, np.float64))
    units = []
    for a, b, r in zip(card, cpu, ref):
        a, b, r = host(a), host(b), np.asarray(r, np.float64)
        scale = max(float(np.abs(r).max()), 1e-30)
        units.append((float(np.abs(a - b).max()) / (EMBED_STEP_TOL * scale),
                      max(float(np.abs(a - r).max()),
                          float(np.abs(b - r).max()))
                      / (EMBED_F64_TOL * scale)))
    worst = max(max(u) for u in units)
    log(f"  {what}: card-CPU / against f64, in units of the tolerances "
        f"{[(round(x, 4), round(y, 4)) for x, y in units]}")
    if not worst <= 1.0:
        raise AssertionError(f"{what}: {worst:.3g} times the tolerance")
    return card


def tf32_on_equal(torch, what, run, want):
    """`run()` with the caller's TF32 on must give `want` (computed with
    it off) bit for bit: the function forces full f32 itself."""
    m = torch.backends.cuda.matmul
    m.allow_tf32 = True
    try:
        got = run()
    finally:
        m.allow_tf32 = False
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"  {what} with the caller's allow_tf32 = True: bit-identical to "
        f"TF32 off: {same}")
    if not same:
        raise AssertionError(f"{what}: TF32 reached the products")


def phase_embed_parity(torch, M):
    """Phase 37: path 12's device parts on the card against the CPU and
    numpy f64 (TF32 off), the TF32 guard, a hierarchical-softmax DeepWalk
    fit card against CPU, and the host parts' own checks."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    km_mod, ts_mod = M["kmeans"], M["tsne"]
    rng = np.random.default_rng(37)
    T = lambda a, dev: torch.from_numpy(np.array(a)).to(dev)

    # one Lloyd step at path 12's shape: 38 blobs, a centroid near each,
    # and a 39th far from every point (the empty-cluster rule)
    n, K = EMBED_GRAPH["n"], EMBED_GRAPH["groups"]
    D = EMBED_DW["vector_size"]
    centers = 3.0 * rng.standard_normal((K, D))
    X = (centers[rng.integers(0, K - 1, n)]
         + rng.standard_normal((n, D))).astype(np.float32)
    C = (centers + 0.5 * rng.standard_normal((K, D))).astype(np.float32)
    C[K - 1] = 15.0
    ref = np_lloyd(np, X.astype(np.float64), C.astype(np.float64))
    card = embed_case(torch, np, f"Lloyd step N={n} D={D} K={K} (one "
                      "empty cluster)",
                      lambda dev: km_mod._lloyd_step(T(X, dev), T(C, dev)),
                      ref)
    same_assign = np.array_equal(card[1].cpu().numpy(), ref[1])
    kept = torch.equal(card[0][K - 1].cpu(), torch.from_numpy(C[K - 1]))
    log(f"  assignments equal to numpy's: {same_assign}; the empty "
        f"cluster's centroid kept: {kept}")
    if not (same_assign and kept):
        raise AssertionError(f"Lloyd step: assignments {same_assign}, "
                             f"empty centroid kept {kept}")
    tf32_on_equal(torch, "the Lloyd step",
                  lambda: km_mod._lloyd_step(T(X, "cuda"), T(C, "cuda")),
                  card)
    # a fit of one iteration: labels_ and cost describe the centroids it
    # returns, not the seeds the step started from
    Xs = np.concatenate([rng.normal(size=(40, 2)) + c for c in
                         ((0, 0), (3, 0), (0, 3), (3, 3))]).astype(np.float32)
    km = M["clustering"].KMeansClustering(4, max_iterations=1, seed=2,
                                          device="cuda").fit(Xs)
    d = ((Xs[:, None, :] - km.centroids[None]) ** 2).sum(-1)
    d_seed = ((Xs[:, None, :] - km._seed_centroids(Xs)[None]) ** 2).sum(-1)
    moved = bool((d.argmin(1) != d_seed.argmin(1)).any())
    described = (np.array_equal(km.labels_, d.argmin(1))
                 and abs(km.cost - d.min(1).sum()) <= 1e-4 * d.min(1).sum())
    log(f"  a one-iteration fit: its step moved labels {moved}; labels_ and "
        f"cost those of the returned centroids: {described}")
    if not (moved and described):
        raise AssertionError(f"k-means labels_: moved {moved}, described "
                             f"{described}")

    # the t-SNE step and KL from identical inputs
    N = EMBED_TSNE_N
    Y = (5.0 * rng.standard_normal((N, 2))).astype(np.float32)
    V = (0.1 * rng.standard_normal((N, 2))).astype(np.float32)
    G = rng.uniform(0.5, 2.0, (N, 2)).astype(np.float32)
    P = rng.random((N, N))
    P = P + P.T
    np.fill_diagonal(P, 0.0)
    P = (P / P.sum()).astype(np.float32)
    f64 = lambda *a: [np.asarray(x, np.float64) for x in a]
    for exag, mom in ((12.0, 0.5), (1.0, 0.8)):
        Pe = (P * np.float32(exag)).astype(np.float32)
        ref = np_tsne_step(np, *f64(Y, V, G, Pe), mom, 200.0, 0.01)
        run = lambda dev: ts_mod._tsne_step(T(Y, dev), T(V, dev), T(G, dev),
                                            T(Pe, dev), mom, 200.0, 0.01)
        card = embed_case(torch, np, f"_tsne_step N={N} exaggeration "
                          f"{exag} momentum {mom}", run, ref)
        tf32_on_equal(torch, "the t-SNE step", lambda: run("cuda"), card)
    kl = lambda dev: [ts_mod._tsne_kl(T(Y, dev), T(P, dev))]
    card = embed_case(torch, np, f"_tsne_kl N={N}", kl,
                      [np_tsne_kl(np, *f64(Y, P))])
    tf32_on_equal(torch, "the t-SNE KL", lambda: kl("cuda"), card)

    # DeepWalk with hierarchical softmax and no negatives (every draw on
    # the host): card against CPU
    G_mod = M["graph"]
    g, _, _ = planted_graph(np, G_mod.Graph, 300, 2000, 6, 0.8, 5)
    fits = {}
    for dev in ("cuda", "cpu"):
        dw = G_mod.DeepWalk(vector_size=32, window_size=5, walk_length=20,
                            walks_per_vertex=2, negative=0,
                            use_hierarchic_softmax=True, batch_size=512,
                            seed=5, device=dev)
        dw.fit(g)
        fits[dev] = [dw.lookup_table.syn0, dw.lookup_table.syn1]
    worst = max((a.cpu() - b).abs().max().item()
                / (W2V_FIT_TOL * max(1.0, b.abs().max().item()))
                for a, b in zip(fits["cuda"], fits["cpu"]))
    log(f"  DeepWalk HS fit (300 vertices), card against CPU: syn0 and "
        f"syn1 worst {worst:.3g} of {W2V_FIT_TOL} x max(1, |ref|)")
    if not worst <= 1.0:
        raise AssertionError(f"DeepWalk HS: card off the CPU by {worst:.3g} "
                             "times the tolerance")

    # the weighted walks follow the weights (the reference's criterion)
    wg = G_mod.Graph(3, directed=True)
    for s, d_, w in ((0, 1, 100.0), (0, 2, 0.001), (1, 0, 1.0), (2, 0, 1.0)):
        wg.add_edge(s, d_, weight=w)
    walks = list(G_mod.WeightedRandomWalkIterator(wg, 30, seed=2))
    v1, v2 = (sum(w.count(v) for w in walks) for v in (1, 2))
    log(f"  weighted walks: vertex 1 (weight 100) visited {v1} times, "
        f"vertex 2 (weight 0.001) {v2}")
    if not v1 > 3 * v2:
        raise AssertionError(f"weighted walks ignore the weights: {v1}, {v2}")


def phases_36_37(torch, M, card):
    """Phases 36 and 37; path 12's figures."""
    log("[36/43] path 12: a planted graph with BlogCatalog's counts, "
        "DeepWalk (d=128, w=10, t=40, 2 walks a vertex), k-means (K=39) "
        "and exact t-SNE of its vectors on the card, the training UI")
    figures = phase_embed(torch, M, card)
    log("[37/43] path 12's device parts, card against CPU and numpy (TF32 "
        "off), the TF32 guard, a hierarchical-softmax DeepWalk fit")
    phase_embed_parity(torch, M)
    return figures


def phases_36_37_alone(torch, M) -> int:
    """`--phases-36-37`: phases 36 and 37 alone (no CUDA source of the
    port runs there), then one JSON line of path 12's figures."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    log(f"phases 36-37 alone [{card}]")
    figures = phases_36_37(torch, M, card)
    log(f"phases 36-37 {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, "path 12": figures}), flush=True)
    return 0


# ------------------------------------ phases 38-39: path 13, data parallel
# path 13a: ParallelWrapper over the default one-card mesh trains the GPT
# at bench_gpt_long's width (bench.py:563-568), depth cut 8 -> 2 layers
# for time, through a DevicePrefetchIterator; 13b: the prefetcher at path
# 4e's shape (lstm_large, f32 one-hot batches from pageable memory);
# 13c-13f: bench_lstm's char-RNN (bench.py:393-404: vocab 64, H=256,
# T=64, B=8192, bf16) under the averaging master (4 workers, 5 batches a
# window), the parameter server, FaultTolerantTrainer and the CLI
PAR_GPT = dict(TRAIN, n_layers=2)
PAR_GPT_STEPS = 5
PAR_GPT_LR = 3e-4          # gpt_configuration's Adam learning rate
PAR_4E_STEPS = 6           # 13b: steps timed with and without the prefetcher
PAR_LAG_CYCLES = 120_000_000  # 13b's lagging copy stream: ~60 ms a batch
PAR_LSTM = dict(vocab=64, hidden=256, B=8192, T=64, workers=4, freq=5)
PAR_LSTM_WINDOWS = 1       # full windows of workers x freq batches
PAR_LSTM_TAIL = 3          # then a tail window: two full batches, one half
# RMSPROP parity (ROADMAP queue C's caveat): lr / 1000
PAR_RMSPROP_ATOL = 1e-4
PAR_PS_BATCHES = 8         # 13d: batches through the in-process PS wrapper
PAR_STRAGGLER = dict(delay=6.0, timeout=4.0)  # seconds; a shard ~1.4 s
PAR_CLI_BATCHES = 10       # 13f: the CLI's data factory, B=512
PAR_DEV = "cuda"           # the device path 13 runs on


def par_device_args():
    """The worker processes' and the CLI's device flag: none for the card
    (their default)."""
    return [] if PAR_DEV == "cuda" else ["--device", PAR_DEV]


def par_lstm_batches(np, n_full, tail, seed, B=None, half_last=True):
    """bench_lstm's char-RNN batches: f32 one-hot (B, T, 64) features
    from pageable host memory, int32 next-char labels; `n_full` batches,
    then `tail` more, the last of them half as wide."""
    V, T = PAR_LSTM["vocab"], PAR_LSTM["T"]
    B = B or PAR_LSTM["B"]
    eye = np.eye(V, dtype=np.float32)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_full + tail):
        b = B // 2 if (half_last and tail and i == n_full + tail - 1) else B
        ids = rng.integers(0, V, (b, T + 1))
        out.append((eye[ids[:, :-1]], ids[:, 1:].astype(np.int32)))
    return out


def par13_cli_iterator():
    """Path 13f's data factory (`--data-factory chip_smoke:par13_cli_iterator`):
    bench_lstm's char-RNN batches at B=512."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )

    return ListDataSetIterator([DataSet(x, y) for x, y in par_lstm_batches(
        np, PAR_CLI_BATCHES, 0, seed=31, B=512)])


def flat_diff(torch, a, b) -> float:
    return (a.params() - b.params()).abs().max().item()


def par_13a(torch, M, card):
    """13a: ParallelWrapper(net) over the default mesh (one card) trains
    the 2-layer bf16 GPT 5 steps through a DevicePrefetchIterator; the
    flash kernels' launches are read around the wrapper's fit alone; its
    losses and parameters are held against `net.fit` of a clone on the
    same card over the same batches."""
    import numpy as np

    P, fa = M["parallel"], M["fa"]
    conf = M["gpt_configuration"](**PAR_GPT, seed=17,
                                  learning_rate=PAR_GPT_LR)
    net = M["MultiLayerNetwork"](conf, dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device=PAR_DEV)
    net.init()
    batches = [M["DataSet"](x, y) for x, y in gpt_batches(
        np, PAR_GPT["vocab_size"], TRAIN_B, TRAIN_T, PAR_GPT_STEPS + 1,
        seed=17)]
    net.fit(batches[0])  # warm-up: cuBLAS handles, the allocator
    ref = net.clone()
    mesh = P.make_mesh()
    pw = P.ParallelWrapper(net)
    rec = StepRecorder(())
    net.set_listeners(rec)
    it = M["device_prefetch"].DevicePrefetchIterator(
        M["ListDataSetIterator"](batches[1:]), depth=2, device=PAR_DEV)
    torch.cuda.synchronize()
    fa.reset_counts()
    t0 = time.perf_counter()
    pw.fit(it)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"fwd": fa.flash_forward.launches,
              "dq": fa.flash_bwd_dq.launches,
              "dkv": fa.flash_bwd_dkv.launches}
    routes = dict(fa.launches_by_route)
    plain = (fa.flash_attention_plain_fwd.calls,
             fa.flash_attention_plain_bwd.calls)
    ref_scores = []
    for ds in batches[1:]:
        ref.fit(ds)
        ref_scores.append(ref.score_value)
    d = flat_diff(torch, net, ref)
    same = d == 0.0 and rec.scores == ref_scores
    lr = PAR_GPT_LR
    log(f"  13a: ParallelWrapper over {mesh} ({mesh.size} slot) trained "
        f"{PAR_GPT['n_layers']} layers of bench_gpt_long's GPT (d_model "
        f"{PAR_GPT['d_model']}, {PAR_GPT['n_heads']} heads, B={TRAIN_B} x "
        f"T={TRAIN_T}, bf16 over f32) {PAR_GPT_STEPS} steps through the "
        f"device prefetcher ({it.staged} arrays staged) in {1e3 * wall:.1f} "
        f"ms ({1e3 * wall / PAR_GPT_STEPS:.2f} ms a step) [{card}]")
    log(f"      losses {rec.scores}; net.fit of a clone {ref_scores}; max "
        f"param diff {d:.3e} (bit-identical: {same}); flash launches "
        f"{counts}, by route {routes}, plain calls {plain}")
    want = PAR_GPT["n_layers"] * PAR_GPT_STEPS
    if routes != {(k, "wgmma"): want for k in counts} or any(plain):
        raise AssertionError(f"13a: expected {want} launches of each flash "
                             f"kernel on the wgmma route under "
                             f"ParallelWrapper, got {routes}, {plain}")
    # the same kernels, inputs and order: the runs agree to rounding; Adam
    # moves an element whose gradient is noise by up to lr a step, hence
    # the parameters' bound (phase 6's reasoning)
    if not np.allclose(rec.scores, ref_scores, rtol=1e-5, atol=0) \
            or d > PAR_GPT_STEPS * lr or net.iteration != ref.iteration:
        raise AssertionError(f"13a: wrapper losses {rec.scores} vs "
                             f"{ref_scores} (rtol 1e-5), params {d} (atol "
                             f"{PAR_GPT_STEPS * lr})")
    del net, ref, pw, it
    torch.cuda.empty_cache()
    return {"counts": counts, "step_ms": 1e3 * wall / PAR_GPT_STEPS,
            "bit_identical": same}


class LaggingCopies:
    """A DataSetIterator over `batches` that queues a GPU sleep on the
    prefetcher's copy stream before each batch is staged, so the copies
    lag the host: a pinned buffer refilled before its copy completes
    would show in the staged batch."""

    def __init__(self, torch, M, batches, cycles):
        self._torch, self.it = torch, None
        self._inner = M["ListDataSetIterator"](batches)
        self._cycles = cycles

    def __iter__(self):
        self._inner.reset()
        return self

    def __next__(self):
        if not self._inner.has_next():
            raise StopIteration
        with self._torch.cuda.stream(self.it.copy_stream):
            self._torch.cuda._sleep(self._cycles)
        return self._inner.next()

    def reset(self):
        self._inner.reset()

    def batch(self):
        return self._inner.batch()

    @property
    def async_supported(self):
        return False


def par_13b(torch, M, card):
    """13b: the prefetcher at path 4e's shape (bench_lstm_large's
    char-RNN, bf16 over f32, f32 one-hot (2048, 64, 256) batches from
    pageable memory): step ms and the device's idle share with path 4e's
    `AsyncDataSetIterator` and with `DevicePrefetchIterator`; then every
    staged batch against its host batch, bit for bit, behind a copy stream
    that lags the host."""
    import numpy as np

    L, DP = M["lstm"], M["device_prefetch"]
    V, H, B, T = (LSTM_LARGE[k] for k in ("vocab", "hidden", "B", "T"))
    net = M["MultiLayerNetwork"](char_rnn_conf(M, V, H, seed=1),
                                 dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device=PAR_DEV)
    net.init()
    data = [M["DataSet"](x, y) for x, y in one_hot_batches(
        np, V, B, T, PAR_4E_STEPS + 1, seed=23)]
    net.fit(data[0])
    runs = {}
    for name, make in (
            ("async (path 4e's)", lambda: M["AsyncDataSetIterator"](
                M["ListDataSetIterator"](data[1:]), queue_size=2)),
            ("device prefetch", lambda: DP.DevicePrefetchIterator(
                M["ListDataSetIterator"](data[1:]), depth=2,
                device=PAR_DEV))):
        torch.cuda.synchronize()
        L.reset_counts()
        t0 = time.perf_counter()
        net.fit(make())
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / PAR_4E_STEPS
        launches = dict(L.launches)
        trace = traced(torch, lambda: net.fit(make()))
        runs[name] = {"step_ms": ms, "launches": launches, "trace": trace}
        log(f"  13b: {PAR_4E_STEPS} steps of lstm_large (B={B} x T={T}, "
            f"vocab {V}, H={H}, f32 one-hot batches of "
            f"{data[1].features.nbytes / 2**20:.0f} MiB from pageable "
            f"memory) through the {name} iterator: {ms:.2f} ms a step; "
            f"LSTM launches {launches} [{card}]")
        log(f"      traced pass (torch.profiler): {trace}")
    n = 2 * PAR_4E_STEPS
    if runs["device prefetch"]["launches"] != {("fwd", False, False): n,
                                               ("bwd", False, False): n}:
        raise AssertionError(f"13b: expected {n} + {n} LSTM launches through "
                             f"the prefetcher, got {runs}")
    # the race check: copies lag the host by ~60 ms a batch
    lag = LaggingCopies(torch, M, data, PAR_LAG_CYCLES)
    it = DP.DevicePrefetchIterator(lag, depth=2, device=PAR_DEV)
    lag.it = it
    staged = [(torch.as_tensor(ds.features).clone(),
               torch.as_tensor(ds.labels).clone()) for ds in it]
    torch.cuda.synchronize()
    equal = [torch.equal(f, torch.from_numpy(d.features).to(PAR_DEV))
             and torch.equal(l, torch.from_numpy(d.labels).to(PAR_DEV))
             for (f, l), d in zip(staged, data)]
    log(f"  13b: {len(staged)} batches staged behind a lagging copy stream "
        f"(~{PAR_LAG_CYCLES / 2e9 * 1e3:.0f} ms of GPU sleep before each "
        f"copy): bit-identical to the host batches {equal}")
    if len(staged) != len(data) or not all(equal):
        raise AssertionError(f"13b: a staged batch differs from its host "
                             f"batch: {equal}")
    del net, staged, it
    torch.cuda.empty_cache()
    return {k: {"step_ms": v["step_ms"], "trace": v["trace"]}
            for k, v in runs.items()}, runs["device prefetch"]["launches"]


class LaunchesByWorker:
    """Attributes each LSTM kernel launch to the worker whose shard thread
    made it (`training_master.current_worker_id()`), by wrapping the
    module's launch-count helper for the length of a `with` block; the
    counts themselves are the module's."""

    def __init__(self, L, tm):
        self.L, self.tm = L, tm
        self.by = {}

    def __enter__(self):
        import threading

        lock, orig = threading.Lock(), self.L._count

        def spy(kind, masked, reverse, route):
            key = (self.tm.current_worker_id(), kind)
            with lock:
                self.by[key] = self.by.get(key, 0) + 1
            orig(kind, masked, reverse, route)

        self._orig = orig
        self.L._count = spy
        return self.by

    def __exit__(self, *exc):
        self.L._count = self._orig
        return False


def par_lstm_net(torch, M, seed=3):
    V, H = PAR_LSTM["vocab"], PAR_LSTM["hidden"]
    net = M["MultiLayerNetwork"](char_rnn_conf(M, V, H, seed=seed),
                                 dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device=PAR_DEV)
    net.init()
    return net


def par_sequential_reference(np, tm, start, windows):
    """The master's arithmetic done by hand: each window's batches dealt
    round robin to the workers, each shard fit one after another on a
    clone of the window's starting network, the flat parameters and
    updater states averaged example-weighted in f64."""
    net = start.clone()
    for batches in windows:
        n_w = min(PAR_LSTM["workers"], len(batches))
        shards = [batches[i::n_w] for i in range(n_w)]
        params, upd, w = [], [], []
        for shard in shards:
            rep = net.clone()
            for ds in shard:
                rep.fit(ds)
            params.append(rep.params().detach().cpu().numpy())
            upd.append(tm._flat_updater_state(rep))
            w.append(sum(ds.num_examples() for ds in shard))
        net.set_params(np.average(params, axis=0, weights=w))
        tm._set_updater_state_flat(net, np.average(upd, axis=0, weights=w))
        net.iteration += max(len(s) for s in shards)
    return net


def par_13c(torch, M, card, lstm_counts):
    """13c: DistributedMultiLayer with ParameterAveragingTrainingMaster(4
    workers, 5 batches a window) trains bench_lstm's char-RNN: the
    replicas on the card in 4 threads, every worker's LSTM launches
    counted; the averaged result against the same shards run one after
    another; a worker crash and a NaN-gradient worker (nothing
    non-finite averaged in, the re-runs counted); a straggler whose
    abandoned replica releases its device memory; the window's wall
    against one network fitting the same batches."""
    import numpy as np

    P, tm, L = M["parallel"], M["training_master"], M["lstm"]
    W, F = PAR_LSTM["workers"], PAR_LSTM["freq"]
    arrays = par_lstm_batches(np, PAR_LSTM_WINDOWS * W * F, PAR_LSTM_TAIL,
                              seed=29)
    batches = [M["DataSet"](x, y) for x, y in arrays]
    start = par_lstm_net(torch, M)
    start.fit(batches[-1])  # warm-up: handles, allocator at this shape
    start.iteration, start.epoch = 0, 0
    windows = [batches[i:i + W * F] for i in range(0, len(batches), W * F)]

    def master_run(injector=None, **kw):
        net = start.clone()
        worker = P.ParameterAveragingTrainingWorker(net)
        if injector is not None:
            worker.add_hook(injector)
        master = P.ParameterAveragingTrainingMaster(
            num_workers=W, averaging_frequency=F, worker=worker,
            collect_training_stats=True, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P.DistributedMultiLayer(net, master).fit(
            M["ListDataSetIterator"](batches))
        torch.cuda.synchronize()
        return net, master, time.perf_counter() - t0

    L.reset_counts()
    with LaunchesByWorker(L, tm) as by_worker:
        net, master, wall = master_run()
    launches = dict(L.launches)
    for k, v in launches.items():
        lstm_counts[k] = lstm_counts.get(k, 0) + v
    stats = master.get_training_stats()
    fits = sum(len(w) for w in windows)
    want = {("fwd", False, False): 2 * fits, ("bwd", False, False): 2 * fits}
    log(f"  13c: the averaging master, {W} workers x {F} batches a window "
        f"({len(windows)} windows, the tail's last batch of "
        f"{batches[-1].num_examples()}), bench_lstm's char-RNN (vocab "
        f"{PAR_LSTM['vocab']}, H={PAR_LSTM['hidden']}, B={PAR_LSTM['B']} x "
        f"T={PAR_LSTM['T']}, bf16, RMSPROP): {1e3 * wall:.1f} ms, score "
        f"{net.score_value:.6f}; LSTM launches {launches}, by worker "
        f"thread {by_worker} (None: autograd's device thread, which runs "
        f"every worker's backward); phases {dict((k, round(stats.total_ms(k), 1)) for k in stats.get_keys())} ms [{card}]")
    # each worker's forward launches: 2 layers x the batches it was
    # dealt (round robin within each window); the backward launches run
    # on autograd's device thread, which serves every worker (None)
    dealt = {w: 0 for w in range(W)}
    for win in windows:
        for i in range(len(win)):
            dealt[i % min(W, len(win))] += 1
    per_worker = {w: by_worker.get((w, "fwd"), 0) for w in range(W)}
    if launches != want or per_worker != {w: 2 * n for w, n in dealt.items()}:
        raise AssertionError(f"13c: expected {want} LSTM launches, "
                             f"forwards from every worker thread ({dealt} "
                             f"batches dealt); got {launches}, {by_worker}")
    ref = par_sequential_reference(np, tm, start, windows)
    d = flat_diff(torch, net, ref)
    log(f"  13c: the same shards one after another on the card, averaged "
        f"example-weighted: max param diff {d:.3e} (atol "
        f"{PAR_RMSPROP_ATOL}; bit-identical: {d == 0.0})")
    if d > PAR_RMSPROP_ATOL or net.iteration != ref.iteration:
        raise AssertionError(f"13c: averaged params differ from the "
                             f"sequential shards by {d}")
    # one network over the same batches, for the wall
    one = start.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one.fit(M["ListDataSetIterator"](batches))
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    log(f"  13c: one network fitting the same {fits} batches: "
        f"{1e3 * one_wall:.1f} ms (the master's windows "
        f"{wall / one_wall:.2f}x that)")
    drills = {}
    for name, inj in (("crash", P.WorkerCrashInjector(worker_id=2)),
                      ("nan", P.NaNGradientInjector(worker_id=1))):
        got, m, _ = master_run(inj)
        st = m.get_training_stats()
        dd = flat_diff(torch, got, net)
        finite = bool(torch.isfinite(got.params()).all())
        drills[name] = st.get_counters()
        log(f"  13c drill {name}: fired {inj.fired}, counters "
            f"{st.get_counters()}, params finite {finite}, max diff from "
            f"the healthy run {dd:.3e}")
        if inj.fired != 1 or not finite or dd > PAR_RMSPROP_ATOL \
                or st.get_count("worker_retries") != 1 \
                or (name == "nan" and st.get_count("nonfinite_results") != 1):
            raise AssertionError(f"13c drill {name}: {st.get_counters()}, "
                                 f"finite {finite}, diff {dd}")
    # a straggler: its shard times out and re-dispatches; its abandoned
    # thread fits one more minibatch, then lets its replica go
    del ref, one
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    slow = TrackedSlowWorker(P, worker_id=3, delay=PAR_STRAGGLER["delay"])
    got, m, swall = master_run(slow, worker_timeout=PAR_STRAGGLER["timeout"])
    held = torch.cuda.memory_allocated() - base
    t0 = time.perf_counter()
    slow.thread.join(60.0)  # its one more minibatch, then it bails out
    gc.collect()
    torch.cuda.synchronize()
    released = torch.cuda.memory_allocated() - base
    st = m.get_training_stats()
    dd = flat_diff(torch, got, net)
    log(f"  13c drill straggler (delay {PAR_STRAGGLER['delay']} s, timeout "
        f"{PAR_STRAGGLER['timeout']} s): {1e3 * swall:.0f} ms, counters "
        f"{st.get_counters()}; device memory above the start when fit "
        f"returned {held / 2**20:.1f} MiB, {released / 2**20:.1f} MiB after "
        f"{time.perf_counter() - t0:.2f} s (the new network's own "
        f"{got_bytes(got) / 2**20:.1f} MiB); max diff from the healthy run "
        f"{dd:.3e}")
    if st.get_count("worker_timeouts") < 1 or released > got_bytes(got) \
            or dd > PAR_RMSPROP_ATOL:
        raise AssertionError(f"13c straggler: {st.get_counters()}, memory "
                             f"{released} bytes above the start, diff {dd}")
    drills["straggler"] = st.get_counters()
    del got
    return {"wall_ms": 1e3 * wall, "one_net_ms": 1e3 * one_wall,
            "launches_by_worker": {str(k): v for k, v in by_worker.items()},
            "drills": drills}, net, start, batches


def TrackedSlowWorker(P, **kw):
    """A `SlowWorkerInjector` that keeps the thread it delayed, so the
    caller can wait for that abandoned shard thread to end."""
    import threading

    class Tracked(P.SlowWorkerInjector):
        thread = None

        def pre_update(self, ds, net):
            if self.remaining > 0 and (P.current_worker_id()
                                       == self.worker_id):
                self.thread = threading.current_thread()
            super().pre_update(ds, net)

    return Tracked(**kw)


def got_bytes(net) -> int:
    """Device bytes of a network's parameters and optimizer state."""
    n = sum(t.numel() * t.element_size() for p in net._params
            for t in p.values())
    n += sum(t.numel() * t.element_size() for u in net.get_updater_state()
             for st in u.values() for t in st.values())
    return n


def par_13d(torch, M, card, start, batches, lstm_counts):
    """13d: ParameterServerParallelWrapper(workers=2) on the card against
    a NetworkParameterServer over TCP (every push counted, the net ends on
    the server's params, a duplicate idempotent push dropped); then 2
    worker processes on the card push the fixture's deltas over TCP, one
    after the other, and the server's params equal the in-process store
    fed the same sequences."""
    import numpy as np

    PS, MP, L = M["parameter_server"], M["multiprocess"], M["lstm"]
    net = start.clone()
    srv = PS.NetworkParameterServer(net.params())
    try:
        client = PS.RemoteParameterServerClient(*srv.address, timeout=60.0)
        L.reset_counts()
        t0 = time.perf_counter()
        PS.ParameterServerParallelWrapper(net, workers=2, sync_frequency=1,
                                          server=client).fit(
            M["ListDataSetIterator"](batches[:PAR_PS_BATCHES]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(L.launches)
        for k, v in launches.items():
            lstm_counts[k] = lstm_counts.get(k, 0) + v
        pushes = srv.num_pushes
        equal = np.array_equal(net.params().cpu().numpy(), srv.pull())
        rid = "5e" * 16
        delta = np.full(srv.pull().shape, 0.25, np.float32)
        before = srv.pull()
        client.push_update(delta, request_id=rid)
        client.push_update(delta, request_id=rid)  # a retried push
        dup_ok = srv.num_pushes == pushes + 1 and np.array_equal(
            srv.pull(), (before + delta).astype(np.float32))
        client.close()
    finally:
        srv.close()
    log(f"  13d: ParameterServerParallelWrapper(workers=2) over TCP, "
        f"{PAR_PS_BATCHES} batches of B={PAR_LSTM['B']}: {1e3 * wall:.1f} "
        f"ms, {pushes} pushes, the net equals the server's params {equal}, "
        f"a duplicate V push dropped {dup_ok}; LSTM launches {launches} "
        f"[{card}]")
    n = 2 * PAR_PS_BATCHES
    if pushes != PAR_PS_BATCHES or not equal or not dup_ok \
            or launches != {("fwd", False, False): n,
                            ("bwd", False, False): n}:
        raise AssertionError(f"13d: pushes {pushes}, equal {equal}, "
                             f"duplicate dropped {dup_ok}, {launches}")
    # 2 worker processes on the card
    fix = MP._parity_fixture_net(PAR_DEV)
    init = fix.params().cpu().numpy()
    srv = PS.NetworkParameterServer(init)
    try:
        env = dict(os.environ)
        t0 = time.perf_counter()
        logs = []
        for w in range(2):
            cmd = [sys.executable, "-m",
                   "deeplearning4j_tpu_torch.parallel.parameter_server",
                   "localhost", str(srv.address[1]), str(w), "2", "1",
                   "train"] + par_device_args()
            procs, lg = MP.run_workers([cmd], env, timeout=300)
            if procs[0].returncode != 0:
                raise AssertionError(f"13d worker {w} failed: "
                                     f"{(lg[0] or '')[-2000:]}")
            logs += lg
        proc_wall = time.perf_counter() - t0
        tcp, proc_pushes = srv.pull(), srv.num_pushes
    finally:
        srv.close()
    store = PS.ParameterServer(init)
    feats, labels = MP._parity_fixture_data()
    for w in range(2):
        PS.run_worker_protocol(
            store, MP._parity_fixture_net(PAR_DEV),
            [M["DataSet"](feats[i], labels[i])
             for i in range(feats.shape[0]) if i % 2 == w], 1)
    d = float(np.abs(tcp - store.pull()).max())
    on_card = all(f"device={PAR_DEV}" in lg for lg in logs)
    log(f"  13d: 2 worker processes on the card ({on_card}) pushed "
        f"{proc_pushes} deltas over TCP in {proc_wall:.1f} s; the server's "
        f"params against the in-process store fed the same sequences: max "
        f"diff {d:.3e} (rtol 1e-6, atol 1e-7)")
    if proc_pushes != 6 or not on_card or not np.allclose(
            tcp, store.pull(), rtol=1e-6, atol=1e-7):
        raise AssertionError(f"13d processes: pushes {proc_pushes}, on the "
                             f"card {on_card}, diff {d}")
    return {"wall_ms": 1e3 * wall, "pushes": pushes,
            "process_pushes": proc_pushes, "process_diff": d}


def par_13e(torch, M, card, start, batches, lstm_counts):
    """13e: FaultTolerantTrainer over 13c's handle (the master on the
    card) with a FaultInjectionListener crash after the first window: it
    restores the newest verified checkpoint and finishes."""
    import tempfile

    P, L = M["parallel"], M["lstm"]
    net = start.clone()
    master = P.ParameterAveragingTrainingMaster(
        num_workers=PAR_LSTM["workers"], averaging_frequency=PAR_LSTM["freq"],
        collect_training_stats=True)
    handle = P.DistributedMultiLayer(net, master)
    first = PAR_LSTM["freq"] * PAR_LSTM_WINDOWS
    fault = P.FaultInjectionListener(fail_at_iteration=first + 1)
    net.set_listeners(fault)
    tmp = tempfile.mkdtemp(prefix="path13e_")
    try:
        trainer = P.FaultTolerantTrainer(
            handle, M["ListDataSetIterator"](batches),
            checkpoint_dir=os.path.join(tmp, "ck"), checkpoint_every=1,
            max_restarts=2)
        L.reset_counts()
        t0 = time.perf_counter()
        trainer.fit(epochs=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(L.launches)
        steps = trainer.checkpoint_store.steps()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k, v in launches.items():
        lstm_counts[k] = lstm_counts.get(k, 0) + v
    finite = bool(torch.isfinite(net.params()).all())
    log(f"  13e: FaultTolerantTrainer over the master, a crash at iteration "
        f"{first + 1}: restarts {trainer.restarts}, master counters "
        f"{master.get_training_stats().get_counters()}, iteration "
        f"{net.iteration}, checkpoints {steps}, params finite {finite}, "
        f"{1e3 * wall:.0f} ms; LSTM launches {launches} [{card}]")
    if fault.fired != 1 or trainer.restarts != 1 or not finite \
            or master.get_training_stats().get_count("restarts") != 1:
        raise AssertionError(f"13e: fired {fault.fired}, restarts "
                             f"{trainer.restarts}, finite {finite}")
    return {"restarts": trainer.restarts, "wall_ms": 1e3 * wall,
            "iteration": net.iteration}


def par_13f(torch, M, card, start):
    """13f: `python -m deeplearning4j_tpu_torch.parallel.main --mode
    averaging` trains a saved zip on the card (its default device)."""
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="path13f_")
    try:
        src, out = os.path.join(tmp, "in.zip"), os.path.join(tmp, "out.zip")
        M["write_model"](start, src)
        cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.main",
               "--model-path", src, "--data-factory",
               "chip_smoke:par13_cli_iterator", "--output-path", out,
               "--mode", "averaging", "--workers", "4", "--avg-frequency",
               "2"] + par_device_args()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__))]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        t0 = time.perf_counter()
        procs, logs = M["multiprocess"].run_workers([cmd], env, timeout=300)
        wall = time.perf_counter() - t0
        if procs[0].returncode != 0:
            raise AssertionError(f"13f: the CLI failed: "
                                 f"{(logs[0] or '')[-2000:]}")
        back = M["restore_model"](out, device=PAR_DEV)
        moved = float((back.params() - start.params()).abs().max())
        finite = bool(torch.isfinite(back.params()).all())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  13f: the CLI (--mode averaging, 4 workers, on the card) trained "
        f"the saved zip over {PAR_CLI_BATCHES} batches in {wall:.1f} s (the "
        f"process included): params moved by up to {moved:.3e}, finite "
        f"{finite}, iteration {back.iteration} [{card}]")
    if not finite or not moved > 0 or back.iteration <= start.iteration:
        raise AssertionError(f"13f: moved {moved}, finite {finite}, "
                             f"iteration {back.iteration}")
    return {"wall_s": wall}


def phase_parallel(torch, M, card):
    """Phase 38, path 13 (13a-13f). Returns (figures, launch counts by
    kernel row)."""
    figures, rows = {}, {}
    r = par_13a(torch, M, card)
    figures["13a"] = {k: v for k, v in r.items() if k != "counts"}
    rows["flash"] = r["counts"]
    figures["13b"], rows["4e"] = par_13b(torch, M, card)
    rows["13c"] = {}
    figures["13c"], net, start, batches = par_13c(torch, M, card,
                                                  rows["13c"])
    del net
    figures["13d"] = par_13d(torch, M, card, start, batches, rows["13c"])
    figures["13e"] = par_13e(torch, M, card, start, batches, rows["13c"])
    figures["13f"] = par_13f(torch, M, card, start)
    del start, batches
    torch.cuda.empty_cache()
    return figures, rows


def par_card_cpu_pair(torch, M, make_conf, graph=False):
    """The same network on the card and on the CPU, from one set of
    weights (the CPU's)."""
    cls = M["ComputationGraph"] if graph else M["MultiLayerNetwork"]
    cpu = cls(make_conf(), device="cpu")
    cpu.init()
    card = cls(make_conf(), device=PAR_DEV)
    card.init()
    card.set_params(cpu.params())
    card.set_layer_state(cpu._layer_state)
    return card, cpu


def phase_parallel_parity(torch, M):
    """Phase 39: the wrapper's global view and its bookkeeping on the
    card, over an 8-slot mesh of the one card, against the CPU (TF32 off;
    f32): a batch of 61 trimmed to 56 (equal to `net.fit` on the first 56
    rows); a BatchNormalization net (the whole batch's statistics, card
    against CPU within 1e-5, a per-slot average far off); a masked tBPTT
    char-RNN whose carries are restored after the windows (its output
    equals `net.fit`'s network's); and the averaging master on the parity
    fixture, card against CPU."""
    import numpy as np

    P, C, A, LF = M["parallel"], M["conf"], M["Activation"], M["LossFunction"]
    DS, tol = M["DataSet"], 1e-5
    card8 = P.make_mesh({"data": 8}, devices=[torch.device(PAR_DEV)] * 8)
    cpu8 = P.make_mesh({"data": 8}, devices=[torch.device("cpu")] * 8)
    rng = np.random.default_rng(39)
    # the trim
    X = rng.normal(size=(61, 6)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 61)]
    net = M["multiprocess"]._parity_fixture_net(PAR_DEV)
    ref = net.clone()
    P.ParallelWrapper(net, mesh=card8).fit(DS(X, Y))
    ref.fit(DS(X[:56], Y[:56]))
    d_trim = flat_diff(torch, net, ref)
    log(f"  trim: a batch of 61 over 8 slots trains as its first 56 rows: "
        f"max diff {d_trim:.3e} (atol 1e-6)")
    if d_trim > 1e-6:
        raise AssertionError(f"the wrapper's trim: {d_trim}")

    # BatchNormalization: the whole batch's statistics
    def bn_conf():
        return (C.NeuralNetConfiguration.Builder().seed(5).learning_rate(0.1)
                .updater("sgd").activation(A.TANH).list()
                .layer(C.DenseLayer(n_out=64))
                .layer(C.BatchNormalization())
                .layer(C.OutputLayer(n_out=3, loss=LF.MCXENT,
                                     activation=A.SOFTMAX))
                .set_input_type(C.InputType.feed_forward(6)).build())

    Xb = rng.normal(size=(64, 6)).astype(np.float32)
    Xb[:32] += 3.0
    Yb = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    card, cpu = par_card_cpu_pair(torch, M, bn_conf)
    start = card.clone()
    P.ParallelWrapper(card, mesh=card8).fit(DS(Xb, Yb))
    P.ParallelWrapper(cpu, mesh=cpu8).fit(DS(Xb, Yb))
    d_bn = float((card.params().cpu() - cpu.params()).abs().max())
    flats = []
    for s in range(8):
        rep = start.clone()
        rep.fit(DS(Xb[8 * s:8 * s + 8], Yb[8 * s:8 * s + 8]))
        flats.append(rep.params().cpu().numpy())
    d_slot = float(np.abs(np.mean(flats, axis=0)
                          - card.params().cpu().numpy()).max())
    log(f"  BatchNormalization over 8 slots: card vs CPU max diff "
        f"{d_bn:.3e} (atol {tol}); a per-slot average would differ by "
        f"{d_slot:.3e}")
    if d_bn > tol or d_slot < 100 * tol:
        raise AssertionError(f"BN global view: {d_bn}, per-slot {d_slot}")

    # masked tBPTT: the carries restored after the windows
    Xr = rng.normal(size=(16, 10, 5)).astype(np.float32)
    Yr = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (16, 10))]
    mask = np.ones((16, 10), np.float32)
    mask[3, 7:] = 0
    mask[:2, 2:] = 0

    def tbptt_conf():
        return (C.NeuralNetConfiguration.Builder().seed(31).learning_rate(0.1)
                .list()
                .layer(C.GravesLSTM(n_out=8, activation=A.TANH))
                .layer(C.RnnOutputLayer(n_out=4, loss=LF.MCXENT,
                                        activation=A.SOFTMAX))
                .set_input_type(C.InputType.recurrent(5))
                .t_bptt_forward_length(4).t_bptt_backward_length(4).build())

    card, cpu = par_card_cpu_pair(torch, M, tbptt_conf)
    ref = card.clone()
    P.ParallelWrapper(card, mesh=card8).fit(DS(Xr, Yr, mask, mask))
    P.ParallelWrapper(cpu, mesh=cpu8).fit(DS(Xr, Yr, mask, mask))
    ref.fit(DS(Xr, Yr, mask, mask))
    d_t = flat_diff(torch, card, ref)
    d_out = float((card.output(Xr) - ref.output(Xr)).abs().max())
    d_cpu = float((card.params().cpu() - cpu.params()).abs().max())
    carried = "h" in card._layer_state[0]
    log(f"  masked tBPTT over 8 slots: against net.fit params {d_t:.3e}, "
        f"output {d_out:.3e}; card vs CPU {d_cpu:.3e} (atol {tol}); a carry "
        f"left in the layer state: {carried}")
    if d_t > 1e-6 or d_out > 1e-6 or d_cpu > tol or carried:
        raise AssertionError(f"tBPTT under the wrapper: {d_t}, {d_out}, "
                             f"{d_cpu}, carried {carried}")

    # the averaging master, card against CPU
    feats, labels = M["multiprocess"]._parity_fixture_data()
    data = [DS(feats[i], labels[i]) for i in range(feats.shape[0])]
    nets = {}
    for where, dev in (("card", PAR_DEV), ("cpu", "cpu")):
        n = M["multiprocess"]._parity_fixture_net(dev)
        if where == "cpu":
            n.set_params(nets["card"][1])
        nets[where] = (n, n.params().detach().cpu().clone())
        P.DistributedMultiLayer(n, P.ParameterAveragingTrainingMaster(
            num_workers=2, averaging_frequency=2)).fit(
            M["ListDataSetIterator"](data), epochs=2)
    d_m = float((nets["card"][0].params().cpu()
                 - nets["cpu"][0].params()).abs().max())
    log(f"  the averaging master on the fixture, card vs CPU: max diff "
        f"{d_m:.3e} (atol {tol})")
    if d_m > tol:
        raise AssertionError(f"the master card vs CPU: {d_m}")


def par_launches(rows, counts) -> None:
    """Path 13's launch counts into the timing rows at the shapes that
    made them: 13a's flash launches into rows 2-4 at path 2's shape, 13b's
    LSTM launches into rows 5-6 at path 4's, 13c-13e's into rows 5-6 at
    bench_lstm's (T=64, B=8192, H=256)."""
    adds = {"flash_attention_fwd": counts["flash"]["fwd"],
            "flash_attention_bwd_dq": counts["flash"]["dq"],
            "flash_attention_bwd_dkv": counts["flash"]["dkv"],
            "lstm_fwd_t64_b2048_h1024": counts["4e"].get(
                ("fwd", False, False), 0),
            "lstm_bwd_t64_b2048_h1024": counts["4e"].get(
                ("bwd", False, False), 0),
            "lstm_fwd_t64_b8192_h256": counts["13c"].get(
                ("fwd", False, False), 0),
            "lstm_bwd_t64_b8192_h256": counts["13c"].get(
                ("bwd", False, False), 0)}
    for row in rows:
        row["launches"] += int(adds.get(row["name"], 0))


def phases_38_39(torch, M, card):
    """Phases 38 and 39; path 13's figures and launch counts."""
    log("[38/43] path 13: the data-parallel tier on the card (ParallelWrapper "
        "and the device prefetcher on the GPT, the prefetcher at path 4e's "
        "shape, the averaging master with its drills, the parameter server "
        "over TCP, FaultTolerantTrainer, the CLI)")
    t0 = time.perf_counter()
    figures, counts = phase_parallel(torch, M, card)
    log(f"  phase 38 {time.perf_counter() - t0:.1f} s")
    log("[39/43] the wrapper's global view and bookkeeping over an 8-slot "
        "mesh of the card, card against CPU (f32, TF32 off)")
    t0 = time.perf_counter()
    phase_parallel_parity(torch, M)
    log(f"  phase 39 {time.perf_counter() - t0:.1f} s")
    return figures, counts


def phases_38_39_alone(torch, M, cuda_build) -> int:
    """`--phases-38-39`: phases 38 and 39 alone (the flash and LSTM
    sources built first), then one JSON line of path 13's figures and
    launch counts."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.build(("flash_attention", "lstm"))
    log(f"phases 38-39 alone [{card}]; build {time.perf_counter() - t0:.1f} "
        "s")
    t0 = time.perf_counter()
    figures, counts = phases_38_39(torch, M, card)
    log(f"phases 38-39 {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, "path 13": figures, "launches": {
        k: {",".join(map(str, key)) if isinstance(key, tuple) else key: n
            for key, n in v.items()} for k, v in counts.items()}}),
        flush=True)
    return 0


def lstm_mma_note(key, kind) -> str:
    """The replaced kernel's time at a cooperative row's shape, where
    PERF.md has it: the mma.sync forward, the cluster backward."""
    if kind == "fwd":
        ms, what = LSTM_COOP_MMA_MS.get(key), "the mma.sync kernel"
    else:
        ms, what = LSTM_BWD_CLUSTER_MS.get(key[:3]), "the cluster backward"
    return "" if ms is None else f" ({what} it replaced: {ms} ms)"


def path5_alone(torch, M, cuda_build) -> int:
    """`--path5`: phase 21 alone on the checkout's package (the paged and
    flash sources built first), then one JSON line of its launch counts,
    `{"card": ..., "paged": {"C,pools": n}, "flash": {"kind,route": n}}`."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.build(("paged_attention", "flash_attention"))
    log(f"path 5 alone [{card}]; build {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = phase_server(torch, M, card)
    log(f"phase 21 {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, **{
        k: {",".join(map(str, key)): n for key, n in v.items()}
        for k, v in counts.items()}}), flush=True)
    return 0


def flash_timing_alone(torch, fa, cuda_build) -> int:
    """`--flash-timing`: phase 16's f32 rows at head dims 256-512
    (`f32_cluster_rows`) alone, on the package that was imported (launch
    counts 0: no main path runs), then one JSON line of their kernel
    times, `{"package": ..., "card": ..., "ms": {row: ms}}`."""
    card = nvidia_smi_line()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(fa.__file__)))
    log(f"flash timing of {pkg} [{card}]")
    cuda_build.build(["flash_attention"])
    rows = f32_cluster_rows(torch, fa, {}, {})
    print(json.dumps({"package": pkg, "card": card,
                      "ms": {r["name"]: r["ms"] for r in rows}}), flush=True)
    return 0


def paged_f32_rows(torch, pa):
    """Row 1's f32 chunk rows alone (launch counts 0: no main path runs):
    the dense chunk at path 1's shapes (`WIRE_F32_ROWS`' chunk row) and
    the int8 chunk at one 14a shard's shape (`P14_F32_ROWS`' chunk row),
    each held to its plain version and timed beside it, SDPA and the
    bound (`paged_row`)."""
    int8 = {name: shape for name, kind, shape in P14_F32_ROWS
            if kind == "int8" and shape["C"] == 256}
    return [paged_row(torch, pa, name, "dense",
                      dict(PAGED_SERVING, **PAGED_SHAPES[which]),
                      torch.float32, 0)
            for name, which in WIRE_F32_ROWS if which == "chunk"] + \
        [paged_row(torch, pa, name, "int8", dict(P14_SHARD, **shape),
                   torch.float32, 0) for name, shape in int8.items()]


def paged_timing_alone(torch, pa, cuda_build) -> int:
    """`--paged-timing`: row 1's f32 chunk rows (`paged_f32_rows`) alone,
    on the package that was imported, then one JSON line of their kernel
    times, `{"package": ..., "card": ..., "ms": {row: ms}}`."""
    card = nvidia_smi_line()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(pa.__file__)))
    log(f"paged timing of {pkg} [{card}]")
    cuda_build.build(["paged_attention"])
    rows = paged_f32_rows(torch, pa)
    print(json.dumps({"package": pkg, "card": card,
                      "ms": {r["name"]: r["ms"] for r in rows}}), flush=True)
    return 0


def lstm_timing_alone(torch, L, cuda_build) -> int:
    """`--lstm-timing`: phase 17 alone, on the package that was imported
    (launch counts 0: no main path runs), then one JSON line of its rows'
    kernel times, `{"package": ..., "card": ..., "ms": {row: ms}}`."""
    card = nvidia_smi_line()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(L.__file__)))
    log(f"LSTM timing of {pkg} [{card}]")
    cuda_build.build(["lstm"])
    rows = phase_lstm_timing(torch, L, {}, {}, {})
    print(json.dumps({"package": pkg, "card": card,
                      "ms": {r["name"]: r["ms"] for r in rows}}), flush=True)
    return 0


# ---------------------------------- phases 40-41: path 14, the SPMD half
# path 14: the JAX package's per-device bodies (tensor-parallel decode,
# GPipe, ring and Ulysses attention, the expert-parallel MoE) once per
# slot of one card (`parallel.mesh.set_local_slots`, `parallel.spmd`)
P14_SLOTS = 8
P14_DEV = "cuda"           # the device path 14's slots name
# 14a: SERVE's GPT at tp=2: two 4096-token prompts (chunked prefill),
# 64 tokens each; depth cut 8 -> 2 for the run's time limit (each layer
# is the same full-width block, sharded the same way: 2 layers launch
# every kernel shape and take every collective 8 do)
P14_PROMPT_T, P14_TOKENS = 4096, 64
P14_SERVE_LAYERS = 2
# 14a's int8 and self-speculation runs: one 1024-token prompt, 32 tokens
P14_SHORT_T, P14_SHORT_TOKENS = 1024, 32
P14_GEN = dict(n_slots=2, page_size=128, prefill_chunk=256,
               prompt_buckets=(128,), max_len=4224)
# bf16 logits, teacher-forced over P14_LOGIT_T tokens, tp=2 against one
# device: |diff| <= atol + rtol * max|logit| (the row-parallel products
# add two bf16-rounded partials where one device adds one sum)
P14_LOGIT_T, P14_LOGIT_TOL = 512, (0.05, 0.02)
P14_GATEWAY_T, P14_GATEWAY_TOKENS = 512, 16
# 14b: TRAIN's GPT (8 layers, B=8, T=4096, bf16 over f32 masters) over
# pipe=4 (2 layers a stage), 4 microbatches
P14_PIPE, P14_MICRO, P14_PIPE_STEPS = 4, 4, 3
# 14c: a 2-layer full-width GPT over seq=2, f32, B=4 x T=4096
P14_SEQ_LAYERS, P14_SEQ_B, P14_SEQ_STEPS = 2, 4, 2
# 14d: a full-width GPT block + a 4-expert MoELayer (expert_axis) x 2,
# f32, B=8 x T=1024, over expert=4; capacity factor 8: no overflow
P14_MOE = dict(E=4, B=8, T=1024, blocks=2, steps=3, capacity_factor=8.0)
# 14e: the global view, a 2-layer GPT over {data 2, model 4}, bf16
P14_GLOBAL = dict(n_layers=2, B=4, T=1024, steps=2)
# losses of the wrapped runs against net.fit of a clone on the card: f32
# runs to P14_F32_RTOL; bf16 pipeline microbatches to P14_BF16_RTOL (the
# matmuls see 2 rows where path 2's see 8, another bf16 rounding; the
# first card runs measured 1.5e-5); params to 4 lr a step (Adam maps a
# near-zero gradient's sign to a step of about lr, so two runs that round
# differently part by up to ~2 lr)
P14_F32_RTOL, P14_BF16_RTOL = 1e-4, 1e-3
# Adam steps each weight by about lr whatever its gradient, so the Adam
# runs cannot show a gradient scaled wrong or taken from part of the
# batch: one SGD step (lr 1) of each wrapper against net.fit holds the
# gradients themselves, the worst leaf's max |difference| over its max
# |step| to P14_GRAD_TOL (a gradient scaled by the microbatch count
# misses by 0.75). The first card run measured 7.8e-3 (14b, bf16),
# 1.9e-5 (14c, f32) and 7.1e-4 (14d, f32: the experts' products see
# their tokens grouped by expert, another order of the TF32 sums)
P14_GRAD_TOL = {"14b": 5e-2, "14c": 1e-3, "14d": 5e-3}


def p14_first_divergence(a, b):
    """The first generated step at which two token rows differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def p14_serve(torch, M, pa, net, prompts, parallel=None, trace=False,
              n_tokens=P14_TOKENS, **kw):
    """One 14a batch on a fresh engine (one warm-up request first): the
    tokens, wall, paged launches (by (C, kind) and by slot), plain
    calls, stats and bytes per slot."""
    t_build = time.perf_counter()
    eng = M["DecodeEngine"](net, parallel=parallel, device=P14_DEV,
                            **P14_GEN, **kw)
    try:
        eng.generate(prompts[0][:16], 4)  # warm-up: handles, allocator
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t_build
        pa.reset_counts()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, n_tokens) for p in prompts]
        toks = [r.result(timeout=900) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = dict(tokens=toks, wall=wall,
                   launches=dict(pa.paged_attention.launches_by),
                   by_slot=dict(pa.paged_attention.launches_by_slot),
                   plain=pa.paged_attention_plain.calls, stats=eng.stats(),
                   bytes=eng.model_bytes_per_chip(), tp=eng._tp)
        if trace:
            res["trace"] = traced(torch, lambda: [
                r.result(timeout=900) for r in
                [eng.submit(p, n_tokens) for p in prompts]])
    finally:
        eng.shutdown()
    log(f"  14a batch: parallel={parallel} {kw or ''}: engine and warm-up "
        f"{t_build:.2f} s, batch {res['wall']:.3f} s")
    return res


def p14_check_launches(what, single, tp):
    """Every shard launched the paged kernels the single engine launched,
    nothing ran plain, nothing launched outside a slot."""
    n1 = sum(single["launches"].values())
    if single["plain"] or tp["plain"] or n1 == 0:
        raise AssertionError(f"14a {what}: plain calls {single['plain']}, "
                             f"{tp['plain']}; single launches {n1}")
    if tp["by_slot"] != {0: n1, 1: n1} \
            or sum(tp["launches"].values()) != 2 * n1:
        raise AssertionError(f"14a {what}: tp=2 launches by slot "
                             f"{tp['by_slot']}, want {n1} on each shard")


def p14_logits(torch, M, net, tp, ids):
    """Teacher-forced logits of `ids` (1, T) through the prefill block
    math, on one device (`tp` None) or per tp slot."""
    from deeplearning4j_tpu_torch.models import transformer as TR
    from deeplearning4j_tpu_torch.serving.tp_engine import run_blocks

    plan = TR.GPTPlan(net)
    bp = plan.cast_blocks(net._params)
    sp = bp if tp is None else tp.shard_params(bp)
    T = ids.shape[1]
    qpos = torch.arange(T, device=P14_DEV)
    x = (bp[0]["W"][ids] + bp[0]["P"][:T]).to(plan.cdt)

    def blocks(p_, caches, x, shard, axis_name):
        for i in plan.block_is:
            p, layer = p_[i], plan.layers[i]
            q, k, v = TR._block_heads(layer, p, x, qpos, shard=shard)
            att = TR._prefill_block_attention(layer, q, k, v)
            x = TR._block_ffn(layer, p, x + TR._block_out_proj(
                p, att.reshape(1, T, -1), axis_name), axis_name)
        return x

    with torch.no_grad():
        x = run_blocks(tp, blocks, sp, [], x)
        return plan.final_logits(bp, net._params, x).float()


def p14a_serving(torch, M, pa, card):
    """14a: tensor-parallel serving of SERVE's GPT over 2 slots of the
    card, f32 tokens identical to one device; bf16 with a logit
    tolerance; int8 KV and self-speculation; bytes per slot; one request
    through the GatewayServer."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.transformer import GPTPlan
    from deeplearning4j_tpu_torch.serving.tp_engine import TPPlan

    V = SERVE["vocab_size"]
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, V, P14_PROMPT_T) for _ in range(2)]

    def gpt(cdt):
        """SERVE's GPT with every bias and LN shift drawn from the seed
        too (N(0, 0.02)): a bias added on the wrong side of an
        all-reduce then shows."""
        net = M["MultiLayerNetwork"](M["gpt_configuration"](
            **{**SERVE, "n_layers": P14_SERVE_LAYERS}, seed=41),
            dtype=torch.float32, compute_dtype=cdt, device=P14_DEV)
        net.init()
        g = torch.Generator(device=P14_DEV).manual_seed(41)
        with torch.no_grad():
            for p in net._params:
                for name, t in sorted(p.items()):
                    if name.startswith("b") or name.endswith("_b"):
                        t.add_(0.02 * torch.randn(t.shape, generator=g,
                                                  device=P14_DEV))
        return net

    out = {}
    net32 = gpt(None)
    s32 = p14_serve(torch, M, pa, net32, prompts)
    t32 = p14_serve(torch, M, pa, net32, prompts, {"tp": 2})
    p14_check_launches("f32", s32, t32)
    same = all(np.array_equal(a, b)
               for a, b in zip(s32["tokens"], t32["tokens"]))
    log(f"  14a f32: tp=2 tokens identical to one device: {same}; paged "
        f"launches one device {s32['launches']}, tp=2 by (C, kind) "
        f"{t32['launches']} and by slot {t32['by_slot']}; wall "
        f"{s32['wall']:.3f} s / {t32['wall']:.3f} s")
    if not same:
        at = [p14_first_divergence(a, b)
              for a, b in zip(s32["tokens"], t32["tokens"])]
        raise AssertionError(f"14a: f32 tp=2 tokens differ from one device "
                             f"at steps {at}")
    short = [prompts[0][:P14_SHORT_T]]
    i8 = p14_serve(torch, M, pa, net32, short, n_tokens=P14_SHORT_TOKENS,
                   quantize={"kv": "int8"})
    t8 = p14_serve(torch, M, pa, net32, short, {"tp": 2},
                   n_tokens=P14_SHORT_TOKENS, quantize={"kv": "int8"})
    p14_check_launches("int8", i8, t8)
    same8 = np.array_equal(i8["tokens"][0], t8["tokens"][0])
    spec = p14_serve(torch, M, pa, net32, short, {"tp": 2},
                     n_tokens=P14_SHORT_TOKENS,
                     speculative={"draft": "self", "k": 4})
    want_spec = M["generate"](net32, short[0][None], P14_SHORT_TOKENS,
                              temperature=0.0, device=P14_DEV)[0]
    same_spec = np.array_equal(spec["tokens"][0], want_spec)
    log(f"  14a int8 KV (f32 compute; a {P14_SHORT_T}-token prompt, "
        f"{P14_SHORT_TOKENS} tokens): tp=2 tokens identical to one "
        f"device's int8: {same8}, launches by slot {t8['by_slot']}; "
        f"self-speculation (k=4) at tp=2 identical to f32 `generate`: "
        f"{same_spec}, launches {spec['launches']}, accept rate "
        f"{spec['stats'].get('spec_accept_rate')}")
    if not (same8 and same_spec) or spec["plain"] \
            or set(spec["by_slot"]) != {0, 1}:
        raise AssertionError(f"14a: int8 {same8}, speculative {same_spec}, "
                             f"plain {spec['plain']}, {spec['by_slot']}")
    tp = TPPlan(net32, GPTPlan(net32), 2)
    full = sum(t.numel() * t.element_size() for p in net32._params
               for t in p.values())
    wpc = tp.weight_bytes_per_chip(net32._params)
    log(f"  14a bytes: weights {full} unsharded, {wpc} per slot at tp=2 "
        f"({wpc / full:.3f}); engine bytes per slot one device "
        f"{s32['bytes']}, tp=2 {t32['bytes']}")
    if not wpc < full or not t32["bytes"] < s32["bytes"]:
        raise AssertionError(f"14a: bytes per slot {wpc} vs {full}")
    ids = torch.as_tensor(prompts[0][None, :P14_LOGIT_T].astype(np.int64),
                          device=P14_DEV)
    tp_sh = t32["tp"]
    d32 = (p14_logits(torch, M, net32, None, ids)
           - p14_logits(torch, M, net32, tp_sh, ids)).abs().max().item()
    del net32
    torch.cuda.empty_cache()

    net16 = gpt(torch.bfloat16)
    s16 = p14_serve(torch, M, pa, net16, prompts, trace=True)
    t16 = p14_serve(torch, M, pa, net16, prompts, {"tp": 2}, trace=True)
    p14_check_launches("bf16", s16, t16)
    tp16 = TPPlan(net16, GPTPlan(net16), 2)
    l1 = p14_logits(torch, M, net16, None, ids)
    d16 = (l1 - p14_logits(torch, M, net16, tp16, ids)).abs().max().item()
    atol, rtol = P14_LOGIT_TOL
    bound = atol + rtol * l1.abs().max().item()
    div = [p14_first_divergence(a, b)
           for a, b in zip(s16["tokens"], t16["tokens"])]
    toks = 2 * P14_TOKENS
    log(f"  14a bf16: teacher-forced logits over {P14_LOGIT_T} tokens, "
        f"max |tp=2 - one device| {d16:.4e} (tolerance {bound:.4e}; f32 "
        f"{d32:.4e}); first divergent generated step per request {div}; "
        f"{toks / s16['wall']:.1f} generated tokens/s on one device, "
        f"{toks / t16['wall']:.1f} at tp=2 [{card}]")
    log(f"  14a traced batch, one device: {s16['trace']}")
    log(f"  14a traced batch, tp=2: {t16['trace']}")
    if not d16 <= bound:
        raise AssertionError(f"14a: bf16 logits differ by {d16} > {bound}")

    G = M["gateway"]
    gw = G.GatewayServer(serving={"generation": dict(P14_GEN),
                                  "parallel": {"tp": 2}},
                         device=P14_DEV).start()
    try:
        client = G.GatewayClient(port=gw.port, timeout=900.0)
        client.call("create_model", name="m",
                    config=json.loads(net16.conf.to_json()))
        gw.entry._models["m"].set_param_tree(net16._params)
        p = prompts[1][:P14_GATEWAY_T]
        got = client.call("generate", name="m", prompt_ids=p,
                          n_tokens=P14_GATEWAY_TOKENS, _timeout=900.0)
        st = gw.entry._servers["m"]._engine.stats()
        client.close()
    finally:
        gw.stop(drain_timeout=5.0)
    want = M["generate"](net16, p[None], P14_GATEWAY_TOKENS, temperature=0.0,
                         device=P14_DEV)[0]
    log(f"  14a gateway: one request over the wire at tp={st['tp_degree']}: "
        f"{got.tolist()[:8]}...; generate on one device: first divergent "
        f"step {p14_first_divergence(got, want)}")
    if st["tp_degree"] != 2 or got.shape != (P14_GATEWAY_TOKENS,):
        raise AssertionError(f"14a gateway: {st['tp_degree']}, {got.shape}")
    out.update({"f32_identical": same, "int8_identical": same8,
                "spec_identical": same_spec, "bf16_logit_maxdiff": d16,
                "tokens_per_s": {"one": toks / s16["wall"],
                                 "tp2": toks / t16["wall"]},
                "weight_bytes": {"unsharded": full, "per_slot": wpc}})
    # paged launches by (compute dtype, C, kind): the f32 runs and the
    # bf16 run go to different rows of the kernels line
    paged = {}
    for cdt, res in (("f32", t32), ("f32", t8), ("f32", spec),
                     ("bf16", t16)):
        for (C, kind), n in res["launches"].items():
            paged[(cdt, C, kind)] = paged.get((cdt, C, kind), 0) + n
    del net16
    torch.cuda.empty_cache()
    return out, paged


def p14_params_diff(torch, a, b) -> float:
    return max((x - y).abs().max().item()
               for pa_, pb in zip(a._params, b._params)
               for x, y in zip(pa_.values(), pb.values()))


def p14_fit_pair(torch, M, wrapper, net, ref, batches, name):
    """Train the wrapper and a clone's net.fit on the same batches: the
    step ms of each, the losses of each."""
    w_ms, r_ms, wl, rl = [], [], [], []
    for x, y in batches:
        ds = M["DataSet"](x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wrapper.fit(ds)
        torch.cuda.synchronize()
        w_ms.append(1e3 * (time.perf_counter() - t0))
        wl.append(net.score_value)
        t0 = time.perf_counter()
        ref.fit(ds)
        torch.cuda.synchronize()
        r_ms.append(1e3 * (time.perf_counter() - t0))
        rl.append(ref.score_value)
    log(f"  {name}: losses {wl} against net.fit {rl}; step ms "
        f"{[round(t, 1) for t in w_ms]} against "
        f"{[round(t, 1) for t in r_ms]}")
    return w_ms, r_ms, wl, rl


def p14_check_fit(torch, name, net, ref, wl, rl, rtol, lr, steps):
    import numpy as np

    dp = p14_params_diff(torch, net, ref)
    ptol = 4 * lr * steps
    log(f"  {name}: max |param diff| {dp:.3e} (tolerance {ptol:.1e}); loss "
        f"rtol {rtol:.0e}")
    if not (np.all(np.isfinite(wl))
            and np.allclose(wl, rl, rtol=rtol, atol=0) and dp <= ptol):
        raise AssertionError(f"{name}: losses {wl} vs {rl}, params {dp}")


def p14_grad_check(torch, M, name, net, wrap, batch, tol):
    """One SGD step (lr 1) of `wrap(net)` against net.fit of a clone on
    `batch`: each param moves by minus its gradient, so the worst leaf's
    max |wrapper - net.fit| over its max |net.fit step| is the wrapper's
    relative gradient error. A leaf that net.fit leaves still must stay
    still."""
    ref = net.clone()
    before = [{k: t.detach().clone() for k, t in p.items()}
              for p in net._params]
    ds = M["DataSet"](*batch)
    wrap(net).fit(ds)
    ref.fit(ds)
    worst, at = 0.0, None
    for i, (p0, pw, pr) in enumerate(zip(before, net._params, ref._params)):
        for k, t0 in p0.items():
            err = (pw[k] - pr[k]).abs().max().item()
            step = (pr[k] - t0).abs().max().item()
            r = err / step if step else (0.0 if err == 0 else float("inf"))
            if r >= worst:
                worst, at = r, f"{i}.{k}"
    log(f"  {name}: one SGD step (lr 1) against net.fit: worst leaf {at}, "
        f"max |param diff| / max |step| {worst:.3e} (tolerance {tol:.0e})")
    if not worst <= tol:
        raise AssertionError(f"{name}: the wrapper's gradients differ from "
                             f"net.fit's by {worst} of a step at {at}")
    return worst


def p14b_pipeline(torch, M, fa, card):
    """14b: PipelineParallelWrapper over pipe=4 slots trains TRAIN's GPT;
    the flash kernels launch in every stage."""
    import numpy as np

    P = M["parallel"]
    net = M["MultiLayerNetwork"](M["gpt_configuration"](**TRAIN, seed=42),
                                 dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device=P14_DEV)
    net.init()
    ref = net.clone()
    batches = gpt_batches(np, TRAIN["vocab_size"], TRAIN_B, TRAIN_T,
                          P14_PIPE_STEPS, seed=42)
    mesh = P.make_mesh({"pipe": P14_PIPE}, devices=[P14_DEV] * P14_PIPE)
    sgd = M["MultiLayerNetwork"](
        M["gpt_configuration"](**TRAIN, seed=42, updater="sgd",
                               learning_rate=1.0),
        dtype=torch.float32, compute_dtype=torch.bfloat16, device=P14_DEV)
    sgd.init()
    grad_err = p14_grad_check(
        torch, M, "14b", sgd, lambda n: P.PipelineParallelWrapper(
            n, mesh, microbatches=P14_MICRO), batches[0],
        P14_GRAD_TOL["14b"])
    del sgd
    pw = P.PipelineParallelWrapper(net, mesh, microbatches=P14_MICRO)
    k = pw.layers_per_stage
    fa.reset_counts()
    w_ms, r_ms, wl, rl = p14_fit_pair(torch, M, pw, net, ref, batches,
                                      "14b pipeline")
    by = dict(fa.launches_by_slot)
    want = P14_PIPE_STEPS * P14_MICRO * k
    per_stage = {kind: [by.get((kind, s), 0) for s in range(P14_PIPE)]
                 for kind in ("fwd", "dq", "dkv")}
    ref_n = {kind: by.get((kind, None), 0) for kind in ("fwd", "dq", "dkv")}
    log(f"  14b: {P14_PIPE} stages x {k} layers, {P14_MICRO} microbatches "
        f"of {TRAIN_B // P14_MICRO}; flash launches per stage {per_stage} "
        f"(want {want} each), net.fit's {ref_n}; median step "
        f"{sorted(w_ms)[1]:.1f} ms, path 2's (net.fit, B={TRAIN_B}) "
        f"{sorted(r_ms)[1]:.1f} ms [{card}]")
    if any(v != [want] * P14_PIPE for v in per_stage.values()) \
            or fa.flash_attention_plain_fwd.calls:
        raise AssertionError(f"14b: flash launches per stage {per_stage}")
    p14_check_fit(torch, "14b", net, ref, wl, rl, P14_BF16_RTOL, 3e-4,
                  P14_PIPE_STEPS)
    counts = {kind: sum(per_stage[kind]) for kind in per_stage}
    del net, ref, pw
    torch.cuda.empty_cache()
    return {"step_ms": sorted(w_ms)[1], "path2_ms": sorted(r_ms)[1],
            "losses": wl, "sgd_grad_err": grad_err}, counts


def p14c_sequence(torch, M, card):
    """14c: SequenceParallelWrapper over seq=2 trains a 2-layer
    full-width GPT at T=4096 (f32); ring and Ulysses attention against
    whole-sequence attention at that shape."""
    import numpy as np

    from deeplearning4j_tpu_torch.ops.attention import full_attention

    P = M["parallel"]
    conf = M["gpt_configuration"](**{**TRAIN, "n_layers": P14_SEQ_LAYERS},
                                  seed=43)
    net = M["MultiLayerNetwork"](conf, device=P14_DEV)
    net.init()
    ref = net.clone()
    batches = gpt_batches(np, TRAIN["vocab_size"], P14_SEQ_B, TRAIN_T,
                          P14_SEQ_STEPS, seed=43)
    mesh = P.make_mesh({"seq": 2}, devices=[P14_DEV] * 2)
    sgd = M["MultiLayerNetwork"](M["gpt_configuration"](
        **{**TRAIN, "n_layers": P14_SEQ_LAYERS}, seed=43, updater="sgd",
        learning_rate=1.0), device=P14_DEV)
    sgd.init()
    grad_err = p14_grad_check(
        torch, M, "14c", sgd, lambda n: P.SequenceParallelWrapper(n, mesh),
        batches[0], P14_GRAD_TOL["14c"])
    del sgd
    sp = P.SequenceParallelWrapper(net, mesh)
    torch.cuda.reset_peak_memory_stats()
    w_ms, r_ms, wl, rl = p14_fit_pair(torch, M, sp, net, ref, batches,
                                      "14c sequence parallel (ring)")
    peak = torch.cuda.max_memory_allocated()
    p14_check_fit(torch, "14c", net, ref, wl, rl, P14_F32_RTOL, 3e-4,
                  P14_SEQ_STEPS)
    del net, ref, sp
    torch.cuda.empty_cache()
    g = torch.Generator(device=P14_DEV).manual_seed(43)
    H, D = TRAIN["n_heads"], TRAIN["d_model"] // TRAIN["n_heads"]
    q, k, v = (torch.randn((P14_SEQ_B, TRAIN_T, H, D), generator=g,
                           device=P14_DEV) for _ in range(3))
    with torch.no_grad():
        want = full_attention(q, k, v, causal=True)
        errs = {}
        for fn in (P.ring_attention, P.ulysses_attention):
            errs[fn.__name__] = (fn(q, k, v, mesh, causal=True)
                                 - want).abs().max().item()
    log(f"  14c: ring and Ulysses against whole-sequence attention at "
        f"({P14_SEQ_B}, {TRAIN_T}, {H}, {D}) f32: max abs err {errs} "
        f"(tolerance 1e-4); peak memory of the wrapped steps "
        f"{peak / 2**30:.2f} GiB; median step {sorted(w_ms)[0]:.1f} ms "
        f"against net.fit's {sorted(r_ms)[0]:.1f} ms [{card}]")
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"14c: ring/Ulysses errors {errs}")
    del q, k, v, want
    torch.cuda.empty_cache()
    return {"step_ms": sorted(w_ms)[0], "fit_ms": sorted(r_ms)[0],
            "attention_err": errs, "sgd_grad_err": grad_err}


def p14d_experts(torch, M, card):
    """14d: MoELayers with expert_axis over expert=4 slots under
    ParallelWrapper, against the replicated MoE (net.fit of a clone)."""
    import numpy as np

    P, C = M["parallel"], M["conf"]
    d, V = TRAIN["d_model"], TRAIN["vocab_size"]

    def moe_net(updater, lr):
        b = (C.NeuralNetConfiguration.Builder().seed(44).learning_rate(lr)
             .updater(updater).list()
             .layer(M["TokenEmbedding"](n_in=V, n_out=d,
                                        max_length=P14_MOE["T"])))
        for _ in range(P14_MOE["blocks"]):
            b = (b.layer(C.TransformerBlock(n_in=d, n_out=d,
                                            n_heads=TRAIN["n_heads"],
                                            block_size=512))
                 .layer(C.MoELayer(
                     n_in=d, n_out=d, n_experts=P14_MOE["E"],
                     capacity_factor=P14_MOE["capacity_factor"],
                     expert_axis="expert")))
        conf = (b.layer(C.LayerNormalization(n_in=d, n_out=d))
                .layer(C.RnnOutputLayer(n_in=d, n_out=V,
                                        activation="softmax",
                                        loss="mcxent"))
                .set_input_type(C.InputType.recurrent(V)).build())
        net = M["MultiLayerNetwork"](conf, device=P14_DEV)
        net.init()
        return net

    mesh = P.make_mesh({"expert": P14_MOE["E"]},
                       devices=[P14_DEV] * P14_MOE["E"])
    batches = gpt_batches(np, V, P14_MOE["B"], P14_MOE["T"],
                          P14_MOE["steps"], seed=44)
    grad_err = p14_grad_check(
        torch, M, "14d", moe_net("sgd", 1.0),
        lambda n: P.ParallelWrapper(n, mesh=mesh), batches[0],
        P14_GRAD_TOL["14d"])
    net = moe_net("adam", 3e-4)
    ref = net.clone()
    pw = P.ParallelWrapper(net, mesh=mesh)
    w_ms, r_ms, wl, rl = p14_fit_pair(
        torch, M, pw, net, ref, batches, "14d expert parallel")
    p14_check_fit(torch, "14d", net, ref, wl, rl, 1e-3, 3e-4,
                  P14_MOE["steps"])
    log(f"  14d: median step {sorted(w_ms)[1]:.1f} ms over {P14_MOE['E']} "
        f"expert slots against the replicated MoE's "
        f"{sorted(r_ms)[1]:.1f} ms [{card}]")
    del net, ref, pw
    torch.cuda.empty_cache()
    return {"step_ms": sorted(w_ms)[1], "replicated_ms": sorted(r_ms)[1],
            "sgd_grad_err": grad_err}


def p14e_global_view(torch, M):
    """14e: ParallelWrapper(param_specs=...) over {data 2, model 4} on one
    card: every step bit-identical to net.fit."""
    import numpy as np

    P = M["parallel"]
    conf = M["gpt_configuration"](
        **{**TRAIN, "n_layers": P14_GLOBAL["n_layers"],
           "max_length": P14_GLOBAL["T"]}, seed=45)
    net = M["MultiLayerNetwork"](conf, dtype=torch.float32,
                                 compute_dtype=torch.bfloat16, device=P14_DEV)
    net.init()
    ref = net.clone()
    mesh = P.make_mesh({"data": 2, "model": 4}, devices=[P14_DEV] * 8)
    specs = {i: {"Wqkv": (None, "model"), "Wo": ("model", None),
                 "W1": (None, "model"), "W2": ("model", None)}
             for i in (1, 2)}
    pw = P.ParallelWrapper(net, mesh=mesh, param_specs=specs)
    for x, y in gpt_batches(np, TRAIN["vocab_size"], P14_GLOBAL["B"],
                            P14_GLOBAL["T"], P14_GLOBAL["steps"], seed=45):
        pw.fit(M["DataSet"](x, y))
        ref.fit(M["DataSet"](x, y))
        if net.score_value != ref.score_value:
            raise AssertionError(f"14e: {net.score_value} != "
                                 f"{ref.score_value}")
    same = all(torch.equal(a, b) for p, q in zip(net._params, ref._params)
               for a, b in zip(p.values(), q.values()))
    log(f"  14e: {P14_GLOBAL['steps']} steps over {dict(mesh.shape)} with "
        f"Megatron param_specs: bit-identical to net.fit: {same}")
    if not same:
        raise AssertionError("14e: the global view's params differ")
    del net, ref, pw
    torch.cuda.empty_cache()


def phase_spmd(torch, M, pa, fa, card):
    """Phase 40: path 14 on P14_SLOTS slots of the card."""
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh

    saved = pmesh._SLOTS
    pmesh.set_local_slots(P14_SLOTS, P14_DEV)
    try:
        t0 = time.perf_counter()
        a, paged = p14a_serving(torch, M, pa, card)
        log(f"  14a {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        b, flash = p14b_pipeline(torch, M, fa, card)
        log(f"  14b {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        c = p14c_sequence(torch, M, card)
        log(f"  14c {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        d = p14d_experts(torch, M, card)
        log(f"  14d {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        p14e_global_view(torch, M)
        log(f"  14e {time.perf_counter() - t0:.1f} s")
    finally:
        pmesh._SLOTS = saved
    return {"14a": a, "14b": b, "14c": c, "14d": d}, {"paged": paged,
                                                      "flash": flash}


def p41_collectives(torch, spmd, P, mesh_of):
    """The SPMD runtime's collectives on 4 slots of the card against 4
    CPU slots, same inputs: bit-identical (slot-order sums, copies)."""
    g = torch.Generator().manual_seed(46)
    x = torch.randn((16, 8, 6), generator=g)
    spec = P(("a", "b"))

    def body(t):
        return (spmd.psum(t, "b"), spmd.pmean(t, ("a", "b")),
                spmd.ppermute(t, "b", [(0, 1), (1, 0)]),
                spmd.all_to_all(t, "a", 1, 0, tiled=True),
                spmd.all_gather(t, ("a", "b"), axis=2, tiled=True))

    outs = {}
    for dev in (P14_DEV, "cpu"):
        fn = spmd.shard_map(body, mesh_of({"a": 2, "b": 2}, dev),
                            in_specs=(spec,), out_specs=(spec,) * 5)
        outs[dev] = [o.cpu() for o in fn(x.to(dev))]
    same = [torch.equal(a, b) for a, b in zip(outs[P14_DEV], outs["cpu"])]
    log(f"  collectives (psum, pmean, ppermute, all_to_all, all_gather) "
        f"card vs CPU bit-identical: {same}")
    if not all(same):
        raise AssertionError(f"phase 41: collectives differ: {same}")


def phase_spmd_parity(torch, M):
    """Phase 41: the SPMD runtime and the new bodies, card against CPU
    (f32, TF32 off): the collectives bit-identical; ring and Ulysses
    attention, the pipeline and the expert-parallel MoE to 1e-5; a tp=2
    DecodeEngine on slots of the card and on CPU slots, tokens
    identical."""
    import numpy as np

    from deeplearning4j_tpu_torch.parallel import experts as EX
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh
    from deeplearning4j_tpu_torch.parallel import spmd

    P = M["parallel"]

    def mesh_of(axes, dev):
        n = int(np.prod(list(axes.values())))
        return P.make_mesh(axes, devices=[dev] * n)

    p41_collectives(torch, spmd, spmd.P, mesh_of)
    g = torch.Generator().manual_seed(47)
    q, k, v = (torch.randn((2, 256, 4, 32), generator=g) for _ in range(3))
    W = torch.randn((4, 32, 32), generator=g) * 0.2
    xs = torch.randn((16, 32), generator=g)
    rw = torch.randn((32, 4), generator=g)
    ex = {"W1": torch.randn((4, 32, 64), generator=g) * 0.2,
          "W2": torch.randn((4, 64, 32), generator=g) * 0.2}
    res = {}
    for dev in (P14_DEV, "cpu"):
        m = mesh_of({"seq": 4}, dev)
        qq, kk, vv = (t.to(dev) for t in (q, k, v))
        r = [P.ring_attention(qq, kk, vv, m, causal=True),
             P.ulysses_attention(qq, kk, vv, m, causal=True),
             P.pipeline_apply(lambda p, t: torch.tanh(t @ p), W.to(dev),
                              xs.to(dev), mesh_of({"pipe": 4}, dev),
                              microbatches=4),
             EX.moe_apply(lambda p, t: torch.relu(t @ p["W1"]) @ p["W2"],
                          {n: t.to(dev) for n, t in ex.items()}, xs.to(dev),
                          rw.to(dev), mesh_of({"expert": 4}, dev),
                          capacity_factor=8.0)[0]]
        res[dev] = [t.cpu() for t in r]
    errs = [(a - b).abs().max().item() for a, b in zip(res[P14_DEV],
                                                       res["cpu"])]
    log(f"  ring, Ulysses, pipeline_apply, moe_apply card vs CPU: max abs "
        f"err {errs} (tolerance 1e-5)")
    if max(errs) > 1e-5:
        raise AssertionError(f"phase 41: bodies card vs CPU {errs}")
    conf = M["gpt_configuration"](vocab_size=64, d_model=256, n_heads=4,
                                  n_layers=2, max_length=64, seed=48)
    toks = {}
    saved = pmesh._SLOTS
    try:
        for dev in (P14_DEV, "cpu"):
            net = M["MultiLayerNetwork"](conf, device=dev)
            net.init() if dev == P14_DEV else net.set_param_tree(
                [{n: t.cpu() for n, t in p.items()} for p in card_params])
            if dev == P14_DEV:
                card_params = net._params
            pmesh.set_local_slots(2, dev)
            eng = M["DecodeEngine"](net, n_slots=2, max_len=48, page_size=8,
                                    prefill_chunk=8, prompt_buckets=(8,),
                                    parallel={"tp": 2}, device=dev)
            try:
                p = np.arange(20) % 64
                toks[dev] = eng.generate(p, 12)
            finally:
                eng.shutdown()
    finally:
        pmesh._SLOTS = saved
    log(f"  tp=2 DecodeEngine (chunked prefill), card vs CPU slots: "
        f"{toks[P14_DEV].tolist()} / {toks['cpu'].tolist()}")
    if not np.array_equal(toks[P14_DEV], toks["cpu"]):
        raise AssertionError("phase 41: tp=2 tokens differ card vs CPU")
    p41_pipeline_dropout(torch, M, mesh_of)


def p41_pipeline_dropout(torch, M, mesh_of):
    """A 4-stage pipeline with dropout 0.1 on the card against one device
    under `row_offset_scope(0)`: each microbatch draws its global rows'
    masks, so the losses agree to f32 summation order (rtol 1e-5); a
    stage keyed by its local row would miss by far more."""
    import numpy as np

    from deeplearning4j_tpu_torch.ops.rng_rows import row_offset_scope

    conf = M["gpt_configuration"](vocab_size=64, d_model=256, n_heads=2,
                                  n_layers=4, max_length=256, dropout=0.1,
                                  attention_block_size=128, seed=49)
    ref = M["MultiLayerNetwork"](conf, device=P14_DEV)
    ref.init()
    net = ref.clone()
    batches = [M["DataSet"](x, y) for x, y in gpt_batches(
        np, 64, 8, 256, 2, seed=49)]
    pw = M["parallel"].PipelineParallelWrapper(
        net, mesh_of({"pipe": 4}, P14_DEV))
    got, want = [], []
    for ds in batches:
        pw.fit(ds)
        got.append(net.score_value)
        with row_offset_scope(0):
            ref.fit(ds)
        want.append(ref.score_value)
    log(f"  pipeline with dropout 0.1 on the card: losses {got} against one "
        f"device under row_offset_scope(0) {want} (rtol 1e-5)")
    if not np.allclose(got, want, rtol=1e-5, atol=0):
        raise AssertionError(f"phase 41: pipeline dropout {got} vs {want}")


# path 14's paged launches by (compute dtype, C, kind) -> the kernels
# line's row: the bf16 rows of phase 1, the f32 rows of path 10
# (`WIRE_F32_ROWS`), and three rows only 14a's f32 runs reach, timed at
# the shape of one of its shards (Hkv/2 = 4 heads, 2 engine slots, the
# 1024-token prompt) by `spmd_rows`
P14_PAGED_ROWS = {
    ("bf16", 1, "dense"): "paged_attention_decode",
    ("bf16", 256, "dense"): "paged_attention_prefill_chunk",
    ("f32", 1, "dense"): "paged_attention_decode_f32",
    ("f32", 256, "dense"): "paged_attention_prefill_chunk_f32",
    ("f32", 5, "dense"): "paged_attention_verify_f32",
    ("f32", 1, "int8"): "paged_attention_int8_decode_f32",
    ("f32", 256, "int8"): "paged_attention_int8_prefill_chunk_f32"}
P14_SHARD = dict(H=4, Hkv=4, hd=128, page=128, n_pages=34)
P14_F32_ROWS = (
    ("paged_attention_verify_f32", "dense",
     dict(S=2, C=5, positions=[1040, 0], inactive=(1,))),
    ("paged_attention_int8_decode_f32", "int8",
     dict(S=2, C=1, positions=[1040, 0], inactive=(1,))),
    ("paged_attention_int8_prefill_chunk_f32", "int8",
     dict(S=1, C=256, positions=[768])))


def spmd_rows(torch, pa, rows, counts) -> list:
    """Path 14's launch counts into the timing rows: 14a's paged
    launches by compute dtype, chunk width and kind (at Hkv/2 heads a
    shard; a key with no row raises), 14b's flash launches into rows 2-4
    at path 2's shape (B=2 a microbatch). The f32 rows carry path 14's
    share in `launches_by_path`. Returns the rows only path 14 reaches,
    timed here."""
    adds = {"flash_attention_fwd": counts["flash"]["fwd"],
            "flash_attention_bwd_dq": counts["flash"]["dq"],
            "flash_attention_bwd_dkv": counts["flash"]["dkv"]}
    for key, n in counts["paged"].items():
        if key not in P14_PAGED_ROWS:
            raise AssertionError(f"path 14: paged launches {key} x {n} "
                                 "have no row in the kernels line")
        name = P14_PAGED_ROWS[key]
        adds[name] = adds.get(name, 0) + n
    new = [paged_row(torch, pa, name, kind, dict(P14_SHARD, **shape),
                     torch.float32, 0)
           for name, kind, shape in P14_F32_ROWS]
    f32 = {name for (cdt, _, _), name in P14_PAGED_ROWS.items()
           if cdt == "f32"}
    for row in rows + new:
        n = int(adds.pop(row["name"], 0))
        row["launches"] += n
        if row["name"] in f32:
            row.setdefault("launches_by_path", {})["path 14"] = n
    if any(adds.values()):
        raise AssertionError(f"path 14: launches {adds} matched no row")
    return new


def phases_40_41(torch, M, pa, fa, card):
    """Phases 40 and 41; path 14's figures and launch counts."""
    log("[40/43] path 14: the in-process SPMD half on slots of the card "
        "(tensor-parallel serving, the GPipe pipeline, ring and Ulysses "
        "sequence parallelism, the expert-parallel MoE, the global view)")
    t0 = time.perf_counter()
    figures, counts = phase_spmd(torch, M, pa, fa, card)
    log(f"  phase 40 {time.perf_counter() - t0:.1f} s")
    log("[41/43] the SPMD runtime's collectives and the new bodies, card "
        "against CPU (f32, TF32 off)")
    t0 = time.perf_counter()
    phase_spmd_parity(torch, M)
    log(f"  phase 41 {time.perf_counter() - t0:.1f} s")
    return figures, counts


def phases_40_41_alone(torch, M, pa, fa, cuda_build) -> int:
    """`--phases-40-41`: phases 40 and 41 alone (the paged and flash
    sources built first), then one JSON line of path 14's figures and
    launch counts."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.build(("paged_attention", "flash_attention"))
    log(f"phases 40-41 alone [{card}]; build {time.perf_counter() - t0:.1f} "
        "s")
    t0 = time.perf_counter()
    figures, counts = phases_40_41(torch, M, pa, fa, card)
    log(f"phases 40-41 {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, "path 14": figures, "launches": {
        "paged": {f"{d},{c},{k}": n
                  for (d, c, k), n in counts["paged"].items()},
        "flash": counts["flash"]}}, default=str), flush=True)
    return 0


# ---------------------------------- path 15: two processes train one GPT
# bench.py gpt_long's width (bench.py:563-568), bf16 compute over f32
# masters; a global batch of P15_B x T=4096 split over P15_PROCS worker
# processes on one card, joined by gloo over tcp://localhost (NCCL refuses
# two ranks on one device); depth cut 8 -> 2 for the run's time limit
# (every layer is the same full-width block: 2 layers launch every kernel
# shape 8 do, and the exchange is one flat gradient vector at any depth)
P15_PROCS, P15_B, P15_STEPS = 2, 8, 3
P15_LAYERS = 2
P15_SGD_LR = 0.1
P15_ADAM_LR = 3e-4          # gpt_configuration's Adam learning rate
# after 3 SGD steps: the worst leaf's max |2 processes - 1 process| over
# its max movement in the 1-process run (bf16 products over 4 rows
# against 8, the row sums split in two: rounding, as path 14b's bound)
P15_SGD_TOL = 5e-2
P15_LOSS_RTOL = 5e-3        # Adam losses, 2 processes against 1
# the step after the restore (1 process, from the ranks' state bit for
# bit) against the uninterrupted 2-process step: its loss, computed from
# that same state, to P15_RESUME_LOSS_RTOL (rounding of the row split);
# its parameters as the SGD check holds them, the worst leaf's max |diff|
# over its max movement in that step: sound runs read ~3e-2 (Adam turns
# the row split's rounding into steps of up to lr, ROADMAP queue C's
# caveat), a step skipped after the restore reads 1
P15_RESUME_LOSS_RTOL = 1e-4
P15_RESUME_TOL = 0.2
P15_EXPORT_T = 4096         # the f32 export at B=1: the "tf32" flash route
P15_EXPORT_ATOL = 1e-5      # f32 probabilities, exported against output
P15_TIMEOUT = 900           # seconds the worker processes may take


def p15_net(torch, M, which):
    """TRAIN's GPT (P15_LAYERS deep) in bf16 over f32 masters, SGD at
    P15_SGD_LR or Adam, from one seed (the same bits in every process on
    one card)."""
    from deeplearning4j_tpu_torch.nn.updater import Updater

    kw = dict(updater=Updater.SGD, learning_rate=P15_SGD_LR) \
        if which == "sgd" else {}
    conf = M["gpt_configuration"](**{**TRAIN, "n_layers": P15_LAYERS},
                                  seed=21, **kw)
    net = M["MultiLayerNetwork"](conf, dtype=torch.float32,
                                 compute_dtype=torch.bfloat16,
                                 device="cuda")
    net.init()
    return net


def p15_batches(np):
    return gpt_batches(np, TRAIN["vocab_size"], P15_B, TRAIN_T, P15_STEPS,
                       seed=42)


def p15_digest(torch, net, updater=False) -> str:
    """SHA-256 of the flat f32 parameters (and the updater state's leaves,
    in tree order)."""
    import hashlib

    h = hashlib.sha256(net.params().detach().float().cpu().numpy()
                       .tobytes())
    if updater:
        for _, st in sorted(((str(k), v) for k, v in (
                enumerate(net._upd_state) if isinstance(net._upd_state, list)
                else net._upd_state.items()))):
            for name in sorted(st):
                for sk in sorted(st[name]):
                    h.update(st[name][sk].detach().float().cpu().numpy()
                             .tobytes())
    return h.hexdigest()


def p15_flash_counts(fa) -> dict:
    return {"fwd": fa.flash_forward.launches, "dq": fa.flash_bwd_dq.launches,
            "dkv": fa.flash_bwd_dkv.launches,
            "by_route": {f"{k},{r}": n
                         for (k, r), n in fa.launches_by_route.items()},
            "plain": [fa.flash_attention_plain_fwd.calls,
                      fa.flash_attention_plain_bwd.calls]}


def p15_worker(torch, M, argv) -> int:
    """`--p15-worker <rank> <port> <dir>`: one of path 15's
    processes. Joins the process group, trains the SGD net, then the Adam
    net (a sharded checkpoint from every rank before the last step) on
    its rows of the global batches through MultiProcessParallelWrapper;
    rank 0 writes the flat parameters; prints one `P15_WORKER {json}`
    line: losses, step ms, digests, flash launches by route."""
    import numpy as np

    i = argv.index("--p15-worker")
    rank, port, out = int(argv[i + 1]), argv[i + 2], argv[i + 3]
    mp = M["multiprocess"]
    fa = M["fa"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mp.initialize_multiprocess(f"localhost:{port}", P15_PROCS, rank,
                               local_device_count=1)
    per = P15_B // P15_PROCS
    rows = slice(rank * per, (rank + 1) * per)
    res = {"rank": rank}
    try:
        fa.reset_counts()
        for which in ("sgd", "adam"):
            net = p15_net(torch, M, which)
            res[f"{which}_init"] = p15_digest(torch, net)
            pw = mp.MultiProcessParallelWrapper(net)
            ms, losses = [], []
            for k, (x, y) in enumerate(p15_batches(np)):
                if which == "adam" and k == P15_STEPS - 1:
                    pw.save_checkpoint(os.path.join(out, "ckpt"))
                    res["ckpt_digest"] = p15_digest(torch, net, True)
                    res["ckpt_iteration"] = net.iteration
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pw.fit(M["DataSet"](x[rows], y[rows]))
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                losses.append(net.score_value)
            res[f"{which}_ms"], res[f"{which}_losses"] = ms, losses
            res[f"{which}_digest"] = p15_digest(torch, net)
            res["route"] = pw.route
            if rank == 0:
                np.save(os.path.join(out, f"{which}.npy"),
                        net.params().detach().float().cpu().numpy())
            del pw, net
            torch.cuda.empty_cache()
        res["flash"] = p15_flash_counts(fa)
    finally:
        mp.shutdown_multiprocess()
    print("P15_WORKER " + json.dumps(res), flush=True)
    return 0


def p15_load_worker(torch, M, argv) -> int:
    """`--p15-load <artifact> <ids.npy> <out.npy>`: load the exported
    network in this fresh process (no network object), run it on the ids,
    write the output; prints `P15_LOAD {json}` with the flash launches."""
    import numpy as np

    from deeplearning4j_tpu_torch.util.stablehlo_export import (
        load_inference,
    )

    i = argv.index("--p15-load")
    art, ids, out = argv[i + 1], argv[i + 2], argv[i + 3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = M["fa"]
    fa.reset_counts()
    run = load_inference(art)
    t0 = time.perf_counter()
    y = run(np.load(ids))
    ms = 1e3 * (time.perf_counter() - t0)
    np.save(out, y)
    print("P15_LOAD " + json.dumps({"flash": p15_flash_counts(fa),
                                    "ms": ms}), flush=True)
    return 0


def p15_package_args(M) -> list:
    """`--package <the package this process runs>`, so that the worker
    processes import the same copy of the port (a fault check's)."""
    return ["--package",
            os.path.dirname(os.path.dirname(os.path.abspath(
                M["fa"].__file__)))]


def p15_worker_line(log_text, tag):
    for line in (log_text or "").splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    return None


def p15_leaf_ratio(torch, net, got, want, init):
    """The worst leaf's max |got - want| over its max |want - init|
    (flat f32 vectors in the net's parameter order)."""
    import numpy as np

    worst, at, off = 0.0, None, 0
    for i, p in enumerate(net._params):
        for k in sorted(p):
            n = p[k].numel()
            err = float(np.abs(got[off:off + n] - want[off:off + n]).max())
            step = float(np.abs(want[off:off + n] - init[off:off + n]).max())
            r = err / step if step else (0.0 if err == 0 else float("inf"))
            if r >= worst:
                worst, at = r, f"{i}.{k}"
            off += n
    return worst, at


def phase_two_processes(torch, M, card):
    """Path 15: two processes train one GPT on the card. The one-process
    reference first (ParallelWrapper on the global batches: 3 SGD and 3
    Adam steps), then two worker processes (`--p15-worker`) on cuda:0
    over gloo, each on its rows; held: the ranks' parameters
    bit-identical, SGD parameters within P15_SGD_TOL of the one process's
    step, Adam losses within P15_LOSS_RTOL, flash launches (rows 2-4, the
    "wgmma" route) in each process. Then the ranks' sharded checkpoint
    restored into this one process (parameters, updater state and
    iteration bit-identical to the ranks' at the save) takes the last
    step, held to the uninterrupted two-process step; last the net's f32
    `output` at B=1 x T=4096 exported, loaded in a fresh process
    (`--p15-load`) and held to `output`."""
    import tempfile

    import numpy as np

    mp, fa = M["multiprocess"], M["fa"]
    batches = p15_batches(np)
    figures, counts = {}, {"ref": {}, "workers": [], "export": {}}
    with tempfile.TemporaryDirectory(prefix="p15-") as out:
        fa.reset_counts()
        ref = {}
        for which in ("sgd", "adam"):
            net = p15_net(torch, M, which)
            ref[f"{which}_init_digest"] = p15_digest(torch, net)
            if which == "sgd":
                init = net.params().detach().float().cpu().numpy()
            pw = M["parallel"].ParallelWrapper(
                net, mesh=M["parallel"].make_mesh(devices=["cuda"]))
            ms, losses = [], []
            for x, y in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pw.fit(M["DataSet"](x, y))
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                losses.append(net.score_value)
            ref[f"{which}_ms"], ref[f"{which}_losses"] = ms, losses
            ref[which] = net.params().detach().float().cpu().numpy()
            if which == "sgd":
                tree = net
            else:
                del net, pw
        counts["ref"] = p15_flash_counts(fa)
        torch.cuda.empty_cache()
        port = mp.free_port()
        here = os.path.abspath(__file__)
        cmds = [[sys.executable, here, "--p15-worker", str(r), str(port),
                 out] + p15_package_args(M) for r in range(P15_PROCS)]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        t0 = time.perf_counter()
        procs, logs = mp.run_workers(cmds, env, timeout=P15_TIMEOUT)
        wall = time.perf_counter() - t0
        res = [p15_worker_line(text, "P15_WORKER") for text in logs]
        for r, (p, text, got) in enumerate(zip(procs, logs, res)):
            if p.returncode != 0 or got is None:
                raise AssertionError(f"path 15: worker {r} exited "
                                     f"{p.returncode}:\n{text[-3000:]}")
        for r, got in enumerate(res):
            log(f"  worker {r} ({got['route']} step): SGD losses "
                f"{got['sgd_losses']}, Adam losses {got['adam_losses']}; "
                f"step ms SGD {[round(t, 1) for t in got['sgd_ms']]}, Adam "
                f"{[round(t, 1) for t in got['adam_ms']]}; flash launches "
                f"{got['flash']}")
        log(f"  one process: SGD losses {ref['sgd_losses']}, Adam losses "
            f"{ref['adam_losses']}; step ms SGD "
            f"{[round(t, 1) for t in ref['sgd_ms']]}, Adam "
            f"{[round(t, 1) for t in ref['adam_ms']]}; flash launches "
            f"{counts['ref']}; the workers' wall {wall:.1f} s [{card}]")
        for key in ("sgd_init", "sgd_digest", "adam_init", "adam_digest",
                    "ckpt_digest"):
            if len({got[key] for got in res}) != 1:
                raise AssertionError(f"path 15: the ranks' {key} differ: "
                                     f"{[got[key] for got in res]}")
        if res[0]["sgd_init"] != ref["sgd_init_digest"] \
                or res[0]["adam_init"] != ref["adam_init_digest"]:
            raise AssertionError("path 15: the workers' initial parameters "
                                 "are not the one process's")
        two_sgd = np.load(os.path.join(out, "sgd.npy"))
        worst, at = p15_leaf_ratio(torch, tree, two_sgd, ref["sgd"], init)
        log(f"  SGD (lr {P15_SGD_LR}, {P15_STEPS} steps): two processes "
            f"against one, worst leaf {at}: max |diff| / max |movement| "
            f"{worst:.3e} (tolerance {P15_SGD_TOL:.0e}); ranks "
            "bit-identical")
        if not worst <= P15_SGD_TOL:
            raise AssertionError(f"path 15: SGD parameters differ from one "
                                 f"process by {worst} of a step at {at}")
        if not np.allclose(res[0]["adam_losses"], ref["adam_losses"],
                           rtol=P15_LOSS_RTOL, atol=0):
            raise AssertionError(f"path 15: Adam losses {res[0]['adam_losses']}"
                                 f" against {ref['adam_losses']}")
        for r, got in enumerate(res):
            fl = got["flash"]
            wg = {k: fl["by_route"].get(f"{k},wgmma", 0)
                  for k in ("fwd", "dq", "dkv")}
            if min(wg.values()) == 0 or fl["plain"] != [0, 0]:
                raise AssertionError(f"path 15: worker {r} launched the "
                                     f"flash kernels {fl}")
        counts["workers"] = [got["flash"] for got in res]
        # the sharded checkpoint of both ranks, restored into this process
        net = p15_net(torch, M, "adam")
        pw = M["parallel"].ParallelWrapper(
            net, mesh=M["parallel"].make_mesh(devices=["cuda"]))
        pw.load_checkpoint(os.path.join(out, "ckpt"))
        exact = (p15_digest(torch, net, True) == res[0]["ckpt_digest"]
                 and net.iteration == res[0]["ckpt_iteration"])
        saved = net.params().detach().float().cpu().numpy()
        fa.reset_counts()
        pw.fit(M["DataSet"](*batches[-1]))
        torch.cuda.synchronize()
        counts["resume"] = p15_flash_counts(fa)
        two_adam = np.load(os.path.join(out, "adam.npy"))
        resumed = net.params().detach().float().cpu().numpy()
        d_resume = float(np.abs(resumed - two_adam).max())
        # the worst leaf's |diff| over that step's movement, and the same
        # reading for a step skipped after the restore
        r_resume, at_resume = p15_leaf_ratio(torch, net, resumed, two_adam,
                                             saved)
        r_skipped, _ = p15_leaf_ratio(torch, net, saved, two_adam, saved)
        log(f"  sharded checkpoint (both ranks) restored into one process: "
            f"state bit-identical to the ranks' at the save {exact}; its "
            f"step against the uninterrupted two-process step: loss "
            f"{net.score_value} against {res[0]['adam_losses'][-1]} (rtol "
            f"{P15_RESUME_LOSS_RTOL:.0e}); max |param diff| {d_resume:.3e}; "
            f"worst leaf {at_resume}: max |diff| / max |movement| "
            f"{r_resume:.3e} (tolerance {P15_RESUME_TOL}; a skipped step "
            f"reads {r_skipped:.3e})")
        if not exact or not r_resume <= P15_RESUME_TOL or not np.isclose(
                net.score_value, res[0]["adam_losses"][-1],
                rtol=P15_RESUME_LOSS_RTOL, atol=0):
            raise AssertionError("path 15: the restored checkpoint does not "
                                 "resume the two-process run")
        # a flipped byte in the checkpoint: the restore must refuse it
        ck = os.path.join(out, "ckpt")
        victim = max((os.path.join(ck, f) for f in os.listdir(ck)),
                     key=os.path.getsize)
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        try:
            M["sharded_checkpoint"].restore_sharded_checkpoint(ck, net)
        except M["CheckpointCorruptError"]:
            log("  a flipped byte in the checkpoint: the restore refuses it "
                "(CheckpointCorruptError)")
        else:
            raise AssertionError("path 15: a corrupted sharded checkpoint "
                                 "restored without complaint")
        # the export of the net's f32 output, loaded in a fresh process
        ids = np.random.default_rng(7).integers(
            0, TRAIN["vocab_size"], (1, P15_EXPORT_T)).astype(np.int32)
        np.save(os.path.join(out, "ids.npy"), ids)
        fa.reset_counts()
        want = net.output(ids).detach().cpu().numpy()
        t0 = time.perf_counter()
        art = os.path.join(out, "gpt.pt2")
        blob = M["stablehlo_export"].export_inference(net, ids, path=art)
        t_export = time.perf_counter() - t0
        counts["export"] = p15_flash_counts(fa)
        p = subprocess.run([sys.executable, here, "--p15-load", art,
                            os.path.join(out, "ids.npy"),
                            os.path.join(out, "y.npy")]
                           + p15_package_args(M),
                           capture_output=True, text=True, env=env,
                           timeout=P15_TIMEOUT)
        loaded = p15_worker_line(p.stdout, "P15_LOAD")
        if p.returncode != 0 or loaded is None:
            raise AssertionError(f"path 15: the fresh process could not run "
                                 f"the export ({p.returncode}):\n"
                                 f"{(p.stdout + p.stderr)[-3000:]}")
        got = np.load(os.path.join(out, "y.npy"))
        d_export = float(np.abs(got - want).max())
        tf32 = loaded["flash"]["by_route"].get("fwd,tf32", 0)
        log(f"  export of the f32 output at B=1 x T={P15_EXPORT_T}: "
            f"{len(blob)} bytes in {t_export:.1f} s; loaded in a fresh "
            f"process: max |diff| against output {d_export:.3e} (tolerance "
            f"{P15_EXPORT_ATOL:.0e}), {loaded['ms']:.1f} ms, flash launches "
            f"there {loaded['flash']}")
        if d_export > P15_EXPORT_ATOL or tf32 != P15_LAYERS \
                or loaded["flash"]["plain"] != [0, 0]:
            raise AssertionError("path 15: the exported network disagrees "
                                 "with output or missed the flash kernel")
        counts["loaded"] = loaded["flash"]
        del net, pw
        torch.cuda.empty_cache()
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    figures = {
        "sgd_worst_leaf": worst, "resume_max_diff": d_resume,
        "resume_worst_leaf": r_resume, "skipped_step_worst_leaf": r_skipped,
        "export_max_diff": d_export,
        "step_ms_two_processes_sgd": med(res[0]["sgd_ms"]),
        "step_ms_one_process_sgd": med(ref["sgd_ms"]),
        "step_ms_two_processes_adam": med(res[0]["adam_ms"]),
        "step_ms_one_process_adam": med(ref["adam_ms"]),
        "adam_losses": res[0]["adam_losses"], "route": res[0]["route"],
        "card": card}
    log(f"  path 15: step ms (median of {P15_STEPS}) two processes "
        f"{figures['step_ms_two_processes_adam']:.1f} against one "
        f"{figures['step_ms_one_process_adam']:.1f} (Adam), "
        f"{figures['step_ms_two_processes_sgd']:.1f} against "
        f"{figures['step_ms_one_process_sgd']:.1f} (SGD) [{card}]")
    return figures, counts


# --------------------------------- the SPMD collectives across processes
P42_SLOTS = 2               # slots per process in the collectives check


def p42_collectives_worker(torch, M, argv) -> int:
    """`--p42-spmd <rank> <port> <out>`: a psum + all_to_all +
    ppermute + all_gather body over 2 processes x P42_SLOTS slots of the
    card, forward and backward (the loss weighted 1/world, the gradients
    summed in rank order); each rank writes its results."""
    import numpy as np

    i = argv.index("--p42-spmd")
    rank, port, out = int(argv[i + 1]), argv[i + 2], argv[i + 3]
    mp = M["multiprocess"]
    torch.backends.cuda.matmul.allow_tf32 = False
    mp.initialize_multiprocess(f"localhost:{port}", 2, rank,
                               local_device_count=P42_SLOTS)
    try:
        mesh = mp.global_mesh(axes={"a": 2 * P42_SLOTS})
        y, gx, gw = p42_collectives(torch, mesh, 0.5)
        gx, gw = mp._sum_in_rank_order(gx), mp._sum_in_rank_order(gw)
        np.savez(f"{out}.rank{rank}.npz", y=y.cpu().numpy(),
                 gx=gx.cpu().numpy(), gw=gw.cpu().numpy())
    finally:
        mp.shutdown_multiprocess()
    print("P42_SPMD ok", flush=True)
    return 0


def p42_collectives(torch, mesh, scale):
    from deeplearning4j_tpu_torch.parallel import spmd

    n = 2 * P42_SLOTS

    def body(x, w):
        y = x * w
        s = spmd.psum(y, "a")
        t = spmd.all_to_all(y, "a", split_axis=0, concat_axis=0, tiled=True)
        p = spmd.ppermute(t, "a", [(i, (i + 1) % n) for i in range(n)])
        g = spmd.all_gather(p.sum(0, keepdim=True), "a", tiled=True)
        return torch.tanh(s) + p.sum() + g.mean()

    gen = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn(16 * n, 64, generator=gen).cuda().requires_grad_()
    w = torch.randn(64, generator=gen).cuda().requires_grad_()
    y = spmd.shard_map(body, mesh, in_specs=(spmd.P("a"), spmd.P()),
                       out_specs=spmd.P("a"))(x, w)
    wt = torch.arange(y.numel(), device="cuda",
                      dtype=y.dtype).reshape(y.shape)
    ((y * wt).sum() * scale).backward()
    return y.detach(), x.grad, w.grad


def phase_collectives_across(torch, M, card):
    """The SPMD runtime's collectives across processes: the body of
    `p42_collectives` over 2 processes x 2 slots of the card against 4
    slots in this process, the outputs bit for bit (the sums run in
    global slot order), the gradients within 1e-5 of the largest."""
    import tempfile

    import numpy as np

    mp = M["multiprocess"]
    mesh = M["parallel"].make_mesh({"a": 2 * P42_SLOTS},
                                   devices=["cuda"] * (2 * P42_SLOTS))
    y, gx, gw = p42_collectives(torch, mesh, 1.0)
    with tempfile.TemporaryDirectory(prefix="p42-") as d:
        out = os.path.join(d, "spmd.npz")
        port = mp.free_port()
        here = os.path.abspath(__file__)
        procs, logs = mp.run_workers(
            [[sys.executable, here, "--p42-spmd", str(r), str(port), out]
             + p15_package_args(M) for r in range(2)],
            dict(os.environ, OMP_NUM_THREADS="1"), timeout=300)
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("the collectives across processes failed:\n"
                                 + "\n".join(t[-2000:] for t in logs))
        ranks = [np.load(f"{out}.rank{r}.npz") for r in range(2)]
        same = all(np.array_equal(got["y"], y.cpu().numpy())
                   for got in ranks)
        dg = max(float(np.abs(got[k] - r.cpu().numpy()).max()
                       / max(float(r.abs().max()), 1e-30))
                 for got in ranks for k, r in (("gx", gx), ("gw", gw)))
    log(f"  psum, all_to_all, ppermute, all_gather over 2 processes x "
        f"{P42_SLOTS} slots against {2 * P42_SLOTS} slots in one process: "
        f"both ranks' outputs bit-identical {same}; gradients max relative "
        f"diff "
        f"{dg:.3e} (tolerance 1e-5) [{card}]")
    if not same or dg > 1e-5:
        raise AssertionError("the SPMD collectives across processes differ "
                             "from one process")


def p15_launches(rows, counts) -> None:
    """Path 15's launch counts into rows 2-4: the bf16 "wgmma" launches
    of the one-process reference and the restored step (B=8 x T=4096,
    path 2's shape) and of the two workers (B=4 each) into the bf16 rows;
    the export's and the fresh process's f32 forwards (B=1 x T=4096) into
    the f32 forward row at T=4096."""
    adds = {}
    runs = [counts["ref"], counts["resume"]] + counts["workers"]
    for name, kind in (("flash_attention_fwd", "fwd"),
                       ("flash_attention_bwd_dq", "dq"),
                       ("flash_attention_bwd_dkv", "dkv")):
        adds[name] = sum(c["by_route"].get(f"{kind},wgmma", 0) for c in runs)
    adds["flash_attention_fwd_f32_t4096"] = sum(
        c["by_route"].get("fwd,tf32", 0)
        for c in (counts["export"], counts["loaded"]))
    for row in rows:
        row["launches"] += int(adds.get(row["name"], 0))


# ------------------------------- path 16: from files to a served model
# A tf.keras-style char model at bench_lstm's width (bench.py:393-404):
# one-hot inputs over 64 symbols -> LSTM(256, return_sequences=True),
# sigmoid gates, tanh cell -> Dense(64, softmax); sequences of 32-64
# steps as CSV files (one a sequence: 64 one-hot columns, then the next
# symbol), read with ALIGN_END so each batch carries masks; 4 batches of
# 1024 through the embedded broker into StreamingTrainPipeline (bf16 over
# f32 masters: the masked LSTM kernels, rows 7-8)
ETL = dict(vocab=64, hidden=256, B=1024, batches=4, T=64, min_T=32,
           serve_B=64, serve_records=4, seed=16)
ETL_IMPORT_TOL = 1e-4       # f32 outputs, card (kernels) against CPU
ETL_STREAM_TIMEOUT = 60     # seconds the streamed fit may take


class H5Layout(dict):
    """A group of a Keras HDF5 file held in memory: its attributes in
    `attrs`, its groups and datasets as items; the reading surface
    `KerasModelImport` uses (`modelimport.keras._open_h5`)."""

    def __init__(self, attrs=None, **items):
        super().__init__(items)
        self.attrs = dict(attrs or {})


def etl_write_h5(h5py, group, layout):
    for k, v in layout.attrs.items():
        group.attrs[k] = v
    for k, v in layout.items():
        if isinstance(v, H5Layout):
            etl_write_h5(h5py, group.create_group(k), v)
        else:
            group.create_dataset(k, data=v)


def etl_keras(np, path):
    """The Keras model: LSTM kernel (64, 1024), recurrent kernel (256,
    1024), bias (1024,) in Keras 2's i, f, c, o gate order; Dense (256,
    64). Written with h5py to `path` where h5py is installed, returning
    (path, "an HDF5 file"); on a machine without h5py (the card's has
    none), the same layout in memory (`H5Layout`), for
    `KerasModelImport` to read as it reads the file."""
    V, H = ETL["vocab"], ETL["hidden"]
    rng = np.random.default_rng(ETL["seed"])
    w = {"kernel": rng.normal(0, V ** -0.5, (V, 4 * H)),
         "recurrent_kernel": rng.normal(0, H ** -0.5, (H, 4 * H)),
         "bias": rng.normal(0, 0.1, (4 * H,)),
         "d_kernel": rng.normal(0, H ** -0.5, (H, V)),
         "d_bias": rng.normal(0, 0.1, (V,))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    cfg = {"class_name": "Sequential", "config": {"name": "char_model",
           "layers": [
               {"class_name": "LSTM", "config": {
                   "name": "lstm", "units": H, "activation": "tanh",
                   "recurrent_activation": "sigmoid",
                   "return_sequences": True,
                   "batch_input_shape": [None, None, V]}},
               {"class_name": "Dense", "config": {
                   "name": "dense", "units": V, "activation": "softmax"}}]}}
    names = lambda *n: np.array([x.encode() for x in n])  # noqa: E731
    layout = H5Layout(
        {"model_config": json.dumps(cfg).encode(),
         "training_config": json.dumps(
             {"loss": "categorical_crossentropy",
              "optimizer": {"class_name": "Adam"}}).encode()},
        model_weights=H5Layout(
            {"layer_names": names("lstm", "dense")},
            lstm=H5Layout({"weight_names": names(
                "kernel", "recurrent_kernel", "bias")},
                kernel=w["kernel"], recurrent_kernel=w["recurrent_kernel"],
                bias=w["bias"]),
            dense=H5Layout({"weight_names": names("kernel", "bias")},
                           kernel=w["d_kernel"], bias=w["d_bias"])))
    try:
        import h5py
    except ImportError:
        return layout, "the file's layout in memory (no h5py here)", w
    with h5py.File(path, "w") as f:
        etl_write_h5(h5py, f, layout)
    return path, "an HDF5 file written with h5py", w


def np_keras_char_model(np, w, x):
    """This script's own f64 numpy forward of the Keras model as Keras
    computes it (gates in Keras's i, f, c, o column order, sigmoid gates,
    tanh cell, no peepholes; then the softmax Dense), independent of the
    port's import."""
    x = x.astype(np.float64)
    B, T, _ = x.shape
    H = ETL["hidden"]
    K, R, b = (w[k].astype(np.float64)
               for k in ("kernel", "recurrent_kernel", "bias"))
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))  # noqa: E731
    h, c, outs = np.zeros((B, H)), np.zeros((B, H)), []
    for t in range(T):
        zi, zf, zc, zo = np.split(x[:, t] @ K + h @ R + b, 4, axis=1)
        c = sig(zf) * c + sig(zi) * np.tanh(zc)
        h = sig(zo) * np.tanh(c)
        outs.append(h)
    logits = np.stack(outs, 1) @ w["d_kernel"].astype(np.float64) \
        + w["d_bias"].astype(np.float64)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def etl_write_csvs(np, d):
    """ETL["batches"] x ETL["B"] sequence files: random lengths in
    [min_T, T], a random walk over the symbols; each line the step's
    one-hot (64 columns) then the next symbol."""
    rng = np.random.default_rng(ETL["seed"] + 1)
    V = ETL["vocab"]
    eye = [",".join("1" if j == i else "0" for j in range(V))
           for i in range(V)]
    paths = []
    for s in range(ETL["batches"] * ETL["B"]):
        n = int(rng.integers(ETL["min_T"], ETL["T"] + 1))
        ids = np.cumsum(rng.integers(-2, 3, n + 1)) % V
        p = os.path.join(d, f"seq_{s:05d}.csv")
        with open(p, "w") as f:
            f.write("".join(f"{eye[ids[t]]},{ids[t + 1]}\n"
                            for t in range(n)))
        paths.append(p)
    return paths


def phase_etl(torch, M, card):
    """Path 16: from files to a served model. The Keras file imported on
    the card and on the CPU (weights equal, f32 outputs within
    ETL_IMPORT_TOL, TF32 off); the CSV sequences read with
    `CSVSequenceRecordReader` and `SequenceRecordReaderDataSetIterator`
    (ALIGN_END: every batch masked); the batches through the embedded
    broker into `StreamingTrainPipeline` in bf16 (the masked LSTM
    kernels; every loss finite, the last below the first); the
    pipeline's checkpoint through `CheckpointStore.upload` to a
    `LocalStorage` and `download` into a fresh store; a `ServeRoute` on
    the network restored from it, whose answers equal the trained
    network's `output` bit for bit."""
    import tempfile

    import numpy as np

    L = M["lstm"]
    dv, st, cl = M["datavec"], M["streaming"], M["cloud"]
    KerasModelImport = M["modelimport"].KerasModelImport
    figures, counts = {}, {}
    with tempfile.TemporaryDirectory(prefix="etl-") as d:
        h5, how, weights = etl_keras(np, os.path.join(d, "char_model.h5"))
        t0 = time.perf_counter()
        net = KerasModelImport.import_keras_sequential_model_and_weights(
            h5, device="cuda")
        cpu = KerasModelImport.import_keras_sequential_model_and_weights(
            h5, device="cpu")
        t_import = time.perf_counter() - t0
        same_w = torch.equal(net.params().cpu(), cpu.params())
        recs = list(np.eye(ETL["vocab"], dtype=np.float32)[
            np.random.default_rng(3).integers(
                0, ETL["vocab"], (ETL["serve_records"], ETL["serve_B"],
                                  ETL["T"]))])
        L.reset_counts()
        a = net.output(recs[0]).cpu()
        b = cpu.output(recs[0])
        d_import = float((a - b).abs().max())
        counts["import"] = dict(L.launches)
        d_keras = float(np.abs(a.numpy() - np_keras_char_model(
            np, weights, recs[0])).max())
        log(f"  Keras import from {how} ({t_import:.2f} s, card and CPU): "
            f"{[type(l).__name__ for l in net.layers]}, weights equal "
            f"{same_w}; f32 output card against CPU max |diff| "
            f"{d_import:.3e}, against Keras's own forward in numpy f64 "
            f"{d_keras:.3e} (tolerance {ETL_IMPORT_TOL:.0e}); LSTM "
            f"launches {counts['import']}")
        if not same_w or max(d_import, d_keras) > ETL_IMPORT_TOL:
            raise AssertionError("path 16: the Keras import on the card "
                                 "disagrees with the CPU's")
        t0 = time.perf_counter()
        csvs = etl_write_csvs(np, d)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        it = dv.SequenceRecordReaderDataSetIterator(
            dv.CSVSequenceRecordReader(csvs), batch_size=ETL["B"],
            num_classes=ETL["vocab"], label_index=-1,
            alignment=dv.AlignmentMode.ALIGN_END)
        batches = list(it)
        t_read = time.perf_counter() - t0
        shapes = [b.features.shape for b in batches]
        masked = all(b.features_mask is not None for b in batches)
        log(f"  {len(csvs)} CSV sequences written in {t_write:.1f} s, read "
            f"into {len(batches)} batches {shapes} in {t_read:.1f} s "
            f"({len(csvs) / t_read:.0f} sequences/s), masked {masked}")
        if len(batches) != ETL["batches"] or not masked \
                or any(s != (ETL["B"], ETL["T"], ETL["vocab"])
                       for s in shapes):
            raise AssertionError(f"path 16: batches {shapes}, masked "
                                 f"{masked}")
        # through the embedded broker into the streaming trainer
        broker = st.embedded_kafka.EmbeddedKafkaBroker()
        try:
            topic = "char-train"
            source = st.KafkaSource(topic, broker.bootstrap_servers,
                                    client="embedded",
                                    auto_offset_reset="earliest")
            sink = st.KafkaSink(topic, broker.bootstrap_servers,
                                client="embedded")
            for b in batches:
                sink.send_dataset(b.features, b.labels, b.features_mask,
                                  b.labels_mask)
            net.compute_dtype = torch.bfloat16
            scores = []

            def until():
                """The broker's records until every batch has arrived."""
                n = 0
                for ds in source:
                    yield ds
                    n += 1
                    if n == ETL["batches"]:
                        return

            ckdir = os.path.join(d, "ckpt")
            pipe = st.StreamingTrainPipeline(
                net, until(), on_batch=lambda ev: scores.append(ev["score"]),
                checkpoint_dir=ckdir, checkpoint_every=2)
            L.reset_counts()
            t0 = time.perf_counter()
            pipe.start()
            pipe.join(ETL_STREAM_TIMEOUT)
            source.close()  # a stream short of its records ends here
            pipe.join(30)
            torch.cuda.synchronize()
            t_fit = time.perf_counter() - t0
            counts["stream"] = dict(L.launches)
        finally:
            source.close()
            sink.close()
            broker.close()
        log(f"  streamed fit: {pipe.batches_seen} batches in {t_fit:.2f} s "
            f"({pipe.batches_seen * ETL['B'] / t_fit:.0f} sequences/s), "
            f"losses {scores}; LSTM launches {counts['stream']}, routes "
            f"{dict(M['recurrent'].lstm_forward.routes)} [{card}]")
        fwd = counts["stream"].get(("fwd", True, False), 0)
        bwd = counts["stream"].get(("bwd", True, False), 0)
        if pipe.batches_seen != ETL["batches"] \
                or pipe.records_seen != ETL["batches"] or not np.all(
                np.isfinite(scores)) or not scores[-1] < scores[0] \
                or fwd < ETL["batches"] or bwd < ETL["batches"]:
            raise AssertionError(f"path 16: the streamed fit saw "
                                 f"{pipe.batches_seen} batches, losses "
                                 f"{scores}, masked launches {fwd}, {bwd}")
        # the checkpoint through storage, a fresh net, the serve route
        store = M["CheckpointStore"](ckdir)
        bucket = cl.LocalStorage(os.path.join(d, "bucket"))
        key = store.upload(bucket, key_prefix="runs/char")
        local = M["CheckpointStore"](os.path.join(d, "restored"))
        path = local.download(bucket, key_prefix="runs/char")
        fresh = M["restore_model"](path, device="cuda")
        same = torch.equal(fresh.params(), net.params())
        src, out = st.QueueSource(), st.QueueSink()
        for r in recs:
            src.put(r)
        src.close()
        L.reset_counts()
        route = st.ServeRoute(fresh, src, out)
        route.run()
        counts["serve"] = dict(L.launches)
        want = [net.output(r).cpu().numpy() for r in recs]
        equal = len(out.items) == len(recs) and all(
            np.array_equal(g, w) for g, w in zip(out.items, want))
        log(f"  checkpoint step {store.steps()[-1]} uploaded as {key!r}, "
            f"downloaded to {os.path.basename(str(path))}: parameters equal "
            f"{same}; ServeRoute served {route.served} records of "
            f"{recs[0].shape}, answers equal output {equal}; LSTM launches "
            f"{counts['serve']}")
        if not (same and equal):
            raise AssertionError("path 16: the downloaded model's answers "
                                 "differ from the trained network's")
        figures = {"import_max_diff": d_import, "keras_max_diff": d_keras,
                   "losses": scores,
                   "fit_s": t_fit, "read_s": t_read,
                   "sequences_per_s_read": len(csvs) / t_read,
                   "sequences_per_s_fit": pipe.batches_seen * ETL["B"] / t_fit,
                   "card": card}
    return figures, counts


def etl_launches(rows, counts) -> None:
    """Path 16's LSTM launches into the rows at its shapes: the streamed
    fit's masked bf16 forwards and backwards (T=64, B=1024, H=256) into
    rows 7-8 at that shape, the f32 answers of `output` (the card
    against the CPU, the serve route: T=64, B=64) into the f32 forward
    row without the stash at that shape."""
    T, B, H = ETL["T"], ETL["B"], ETL["hidden"]
    adds = {f"lstm_fwd_masked_t{T}_b{B}_h{H}":
            counts["stream"].get(("fwd", True, False), 0),
            f"lstm_bwd_masked_t{T}_b{B}_h{H}":
            counts["stream"].get(("bwd", True, False), 0),
            f"lstm_fwd_nostash_f32_t{T}_b{ETL['serve_B']}_h{H}":
            sum(c.get(("fwd", False, False), 0)
                for c in (counts["import"], counts["serve"]))}
    for row in rows:
        row["launches"] += int(adds.pop(row["name"], 0))
    if any(adds.values()):
        raise AssertionError(f"path 16: launches {adds} matched no row")


def phases_42_43(torch, M, card):
    """Phases 42 and 43; paths 15 and 16's figures and launch counts."""
    log("[42/43] path 15: two processes train one GPT on the card (gloo, "
        "MultiProcessParallelWrapper), the sharded checkpoint, the export; "
        "the SPMD collectives across processes")
    t0 = time.perf_counter()
    figures15, counts15 = phase_two_processes(torch, M, card)
    phase_collectives_across(torch, M, card)
    log(f"  phase 42 {time.perf_counter() - t0:.1f} s")
    log("[43/43] path 16: from files to a served model (Keras import, "
        "CSV sequences, the embedded broker, the streaming trainer, cloud "
        "storage, the serve route)")
    t0 = time.perf_counter()
    figures16, counts16 = phase_etl(torch, M, card)
    log(f"  phase 43 {time.perf_counter() - t0:.1f} s")
    return {"path 15": figures15, "path 16": figures16}, \
        {"path 15": counts15, "path 16": counts16}


def phases_42_43_alone(torch, M, cuda_build) -> int:
    """`--phases-42-43`: phases 42 and 43 alone (the flash and LSTM
    sources built first), then one JSON line of paths 15 and 16's figures
    and launch counts."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.build(("flash_attention", "lstm"))
    log(f"phases 42-43 alone [{card}]; build {time.perf_counter() - t0:.1f} "
        "s")
    t0 = time.perf_counter()
    figures, counts = phases_42_43(torch, M, card)
    log(f"phases 42-43 {time.perf_counter() - t0:.1f} s")
    counts["path 16"] = {k: {",".join(map(str, key)): n
                             for key, n in v.items()}
                         for k, v in counts["path 16"].items()}
    print(json.dumps({"card": card, **figures, "launches": counts},
                     default=str), flush=True)
    return 0


def port_modules() -> dict:
    """The port's entry points the phases drive, by name."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet,
        MultiDataSet,
    )
    from deeplearning4j_tpu_torch.datasets.iterators import (
        AsyncDataSetIterator,
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets import fetchers
    from deeplearning4j_tpu_torch.datasets.fetchers import (
        MnistDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        ImagePreProcessingScaler,
        OneHotEncoder,
    )
    from deeplearning4j_tpu_torch.models import (
        lenet_configuration,
        resnet_configuration,
        resnet_tiny_configuration,
    )
    from deeplearning4j_tpu_torch.models.transformer import (
        generate,
        gpt_configuration,
    )
    from deeplearning4j_tpu_torch.nn import conf as nn_conf
    from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import (  # noqa: E501
        ElementWiseVertex,
    )
    from deeplearning4j_tpu_torch.nn.conf.layers import TokenEmbedding
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import lstm as L
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.ops.losses import LossFunction
    from deeplearning4j_tpu_torch.optimize.health import HealthSentinel
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener,
        PerformanceListener,
        ScoreIterationListener,
    )
    from deeplearning4j_tpu_torch import serving
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.serving.decode_engine import (
        DecodeEngine,
        weight_digest,
    )
    from deeplearning4j_tpu_torch.util.checkpoint_store import (
        CheckpointCorruptError,
        CheckpointStore,
    )
    from deeplearning4j_tpu_torch.util.serialization import (
        restore_model,
        write_model,
    )
    from deeplearning4j_tpu_torch import earlystopping, gateway, profiler
    from deeplearning4j_tpu_torch import native, nlp
    from deeplearning4j_tpu_torch.serving import kv_transfer, remote_replica
    from deeplearning4j_tpu_torch.util import determinism
    from deeplearning4j_tpu_torch import clustering, graph, ui
    from deeplearning4j_tpu_torch.clustering import kmeans, tsne
    from deeplearning4j_tpu_torch.ui import stats_listener
    from deeplearning4j_tpu_torch import parallel
    from deeplearning4j_tpu_torch.parallel import (
        device_prefetch,
        multiprocess,
        parameter_server,
        training_master,
    )
    from deeplearning4j_tpu_torch import cloud, datavec, modelimport
    from deeplearning4j_tpu_torch import streaming
    from deeplearning4j_tpu_torch.nn.layers import recurrent
    from deeplearning4j_tpu_torch.streaming import embedded_kafka  # noqa: F401
    from deeplearning4j_tpu_torch.util import (
        sharded_checkpoint,
        stablehlo_export,
    )

    return dict(CheckpointCorruptError=CheckpointCorruptError,
                cloud=cloud, datavec=datavec, modelimport=modelimport,
                streaming=streaming, recurrent=recurrent,
                sharded_checkpoint=sharded_checkpoint,
                stablehlo_export=stablehlo_export, parallel=parallel, device_prefetch=device_prefetch,
                multiprocess=multiprocess, parameter_server=parameter_server,
                training_master=training_master, graph=graph, clustering=clustering, kmeans=kmeans,
                tsne=tsne, ui=ui, stats_listener=stats_listener,
                earlystopping=earlystopping, profiler=profiler,
                gateway=gateway, remote_replica=remote_replica,
                weight_digest=weight_digest,
                determinism=determinism, kv_transfer=kv_transfer,
                generate=generate, gpt_configuration=gpt_configuration,
                MultiLayerNetwork=MultiLayerNetwork, DecodeEngine=DecodeEngine,
                DataSet=DataSet, fa=fa, lstm=L, conf=nn_conf,
                OneHotEncoder=OneHotEncoder, Activation=Activation,
                LossFunction=LossFunction, HealthSentinel=HealthSentinel,
                AsyncDataSetIterator=AsyncDataSetIterator,
                ListDataSetIterator=ListDataSetIterator,
                ScoreIterationListener=ScoreIterationListener,
                PerformanceListener=PerformanceListener,
                CheckpointListener=CheckpointListener,
                CheckpointStore=CheckpointStore, restore_model=restore_model,
                write_model=write_model, serving=serving, pa=pa,
                lenet_configuration=lenet_configuration,
                ImagePreProcessingScaler=ImagePreProcessingScaler,
                TokenEmbedding=TokenEmbedding, MultiDataSet=MultiDataSet,
                ComputationGraph=ComputationGraph,
                ElementWiseVertex=ElementWiseVertex,
                resnet_configuration=resnet_configuration,
                resnet_tiny_configuration=resnet_tiny_configuration,
                fetchers=fetchers, MnistDataSetIterator=MnistDataSetIterator,
                nlp=nlp, native=native)


def phases_22_23_alone(torch, M, pa, fa, cuda_build) -> int:
    """`--phases-22-23`: the CNN and MoE phases alone (the paged and
    flash sources built first), their rows logged."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.build(("paged_attention", "flash_attention"))
    log(f"phases 22 and 23 alone [{card}]; build "
        f"{time.perf_counter() - t0:.1f} s")
    phase_cnn_layers(torch, M)
    phase_lenet(torch, M, card)
    counts = phase_attention_moe(torch, M, pa, card)
    rows = attention_moe_rows(torch, fa, counts)
    log(f"phases 22 and 23 {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, "kernels": rows}), flush=True)
    return 0


def phases_24_26_alone(torch, M, cuda_build) -> int:
    """`--phases-24-26`: the graph and pretraining phases alone (the LSTM
    source built first), then one JSON line of phase 25's launches."""
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.build(["lstm"])
    log(f"phases 24-26 alone [{card}]; build {time.perf_counter() - t0:.1f} "
        "s")
    phase_resnet(torch, M, card)
    counts = phase_graph_lstm(torch, M, card)
    phase_pretrain(torch, M, card)
    log(f"phases 24-26 {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, **{
        k: {",".join(map(str, key)): n for key, n in v.items()}
        for k, v in counts.items()}}), flush=True)
    return 0


def main(argv) -> int:
    """No arguments: every phase. `--lstm-timing [--package DIR]`: phase
    17 alone on the package at DIR (default: the checkout's), for an A/B
    of the LSTM kernels against an earlier commit's package;
    `--flash-timing [--package DIR]` the same for phase 16's f32 flash
    rows at head dims 256-512, `--paged-timing [--package DIR]` for row
    1's f32 chunk rows. `--path5`:
    phase 21 alone. `--phases-22-23`: phases 22 and 23 alone.
    `--phases-24-26`: phases 24 to 26 alone. `--phases-27-29`: phases 27
    to 29 alone. `--phases-30-31`: phase 7 and phases 30 and 31 alone.
    `--phases-32-33`: phases 32 and 33 alone. `--phases-34-35`: phases 34
    and 35 alone. `--phases-36-37`: phases 36 and 37 alone.
    `--phases-38-39`: phases 38 and 39 alone. `--phases-40-41`: phases
    40 and 41 alone. `--phases-42-43`: phases 42 and 43 alone.
    `--p15-worker`, `--p15-load` and `--p42-spmd` are the worker
    processes phase 42 starts."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if "--package" in argv:
        root = os.path.dirname(os.path.abspath(
            argv[argv.index("--package") + 1].rstrip("/")))
    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    M = port_modules()
    L = M["lstm"]
    if not L.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {L.__file__}, not the package in "
                           f"{root}")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--p15-worker" in argv:
        return p15_worker(torch, M, argv)
    if "--p15-load" in argv:
        return p15_load_worker(torch, M, argv)
    if "--p42-spmd" in argv:
        return p42_collectives_worker(torch, M, argv)
    if "--lstm-timing" in argv:
        return lstm_timing_alone(torch, L, cuda_build)
    if "--flash-timing" in argv:
        return flash_timing_alone(torch, fa, cuda_build)
    if "--paged-timing" in argv:
        return paged_timing_alone(torch, pa, cuda_build)
    if "--path5" in argv:
        return path5_alone(torch, M, cuda_build)
    if "--phases-22-23" in argv:
        return phases_22_23_alone(torch, M, pa, fa, cuda_build)
    if "--phases-24-26" in argv:
        return phases_24_26_alone(torch, M, cuda_build)
    if "--phases-27-29" in argv:
        return phases_27_29_alone(torch, M, pa, cuda_build)
    if "--phases-30-31" in argv:
        return phases_30_31_alone(torch, M, pa, cuda_build)
    if "--phases-32-33" in argv:
        return phases_32_33_alone(torch, M, pa, cuda_build)
    if "--phases-34-35" in argv:
        return phases_34_35_alone(torch, M)
    if "--phases-36-37" in argv:
        return phases_36_37_alone(torch, M)
    if "--phases-38-39" in argv:
        return phases_38_39_alone(torch, M, cuda_build)
    if "--phases-40-41" in argv:
        return phases_40_41_alone(torch, M, pa, fa, cuda_build)
    if "--phases-42-43" in argv:
        return phases_42_43_alone(torch, M, cuda_build)

    card = nvidia_smi_line()
    log(f"[1/43] card: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    built = cuda_build.build(KERNEL_SOURCES)
    log(f"[2/43] build: {time.perf_counter() - t0:.1f} s for "
        f"{len(built)} source(s)")
    for name, res in built.items():
        for line in ptxas_summary(res.log):
            log(f"  {name}: {line}")

    log("[3/43] paged kernels against their plain versions (TF32 off)")
    phase_kernels(torch, pa)
    log("[4/43] flash kernels against their plain versions (TF32 off)")
    phase_flash(torch, fa)
    log("[5/43] f32 DecodeEngine vs generate, 2 layers, d_model 1024")
    phase_parity(torch, M)
    log("[6/43] f32 training, card (kernels) vs CPU (plain), 1 layer, "
        "d_model 1024, T=1024")
    phase_train_parity(torch, M)
    log("[7/43] serving the 8-layer bf16 GPT at full width")
    launches, path1_tok_s = phase_serve(torch, M, pa, card)
    log("[8/43] serving it with int8 KV, the prefix cache and "
        "self-speculation on shared-prefix traffic")
    launches.update(phase_serve_tier(torch, M, pa, card))
    log("[8/43] path 1f: the same GPT in f32 (no compute dtype) behind "
        "path 1's engine (the split-TF32 chunk kernel)")
    path1f = phase_serve_f32(torch, M, pa, card)
    log("[9/43] training the 8-layer bf16 gpt_long GPT at full width")
    flash_counts = phase_train(torch, M, card, torch.bfloat16, TRAIN_B,
                               TRAIN_STEPS, 13, "wgmma")
    log("[9/43] path 2w: the same GPT with 4 heads of 256 (the bf16 "
        "\"wgmma wide\" flash kernels)")
    flash_counts_wide = phase_train(torch, M, card, torch.bfloat16,
                                    TRAIN_WIDE_B, TRAIN_WIDE_STEPS, 15,
                                    "wgmma wide", n_heads=TRAIN_WIDE_HEADS)
    log("[9/43] path 2x: the same GPT with 2 heads of 512 (the bf16 "
        "\"wgmma wide\" forward, the \"wgmma cluster\" backward)")
    flash_counts_2x = phase_train(torch, M, card, torch.bfloat16,
                                  TRAIN_2X_B, TRAIN_2X_STEPS, 16,
                                  TRAIN_2X_ROUTES, n_heads=TRAIN_2X_HEADS)
    log("[10/43] path 2f: training the 8-layer gpt_long GPT in f32 "
        "(split-TF32 flash kernels)")
    flash_counts_f32 = phase_train(torch, M, card, None, TRAIN_F32_B,
                                   TRAIN_F32_STEPS, 14, "tf32")
    log("[10/43] path 2fw: the same f32 GPT with 4 heads of 256 (the "
        "\"tf32 cluster\" flash kernels)")
    flash_counts_2fw = phase_train(torch, M, card, None, TRAIN_F32_B,
                                   TRAIN_F32_STEPS, 17, "tf32 cluster",
                                   n_heads=TRAIN_2FW_HEADS)
    log("[10/43] path 2fx: the same f32 GPT with 2 heads of 512 (the "
        "\"tf32 cluster\" flash kernels)")
    flash_counts_2fx = phase_train(torch, M, card, None, TRAIN_F32_B,
                                   TRAIN_F32_STEPS, 18, "tf32 cluster",
                                   n_heads=TRAIN_2FX_HEADS)
    log("[11/43] LSTM kernels against their plain versions (TF32 off)")
    phase_lstm_kernels(torch, L, M)
    log("[12/43] f32 char-RNN training, card (kernels) vs CPU (plain), "
        "H=256")
    phase_lstm_train_parity(torch, M)
    log("[13/43] training the bf16 lstm_large char-RNN at full width")
    lstm_counts, step4_ms = phase_lstm_train(torch, M, card, torch.bfloat16)
    log("[14/43] training the bf16 lstm char-RNN with tBPTT 24 at full width")
    tbptt_counts = phase_lstm_tbptt(torch, M, card)
    log("[15/43] path 4f: training the lstm_large char-RNN in f32 "
        "(split-TF32 LSTM kernels)")
    f32_counts, _ = phase_lstm_train(torch, M, card, None, LSTM_F32_STEPS,
                                     "tf32 clusters", seed=2)
    log("[16/43] timing at the serving and training shapes (bf16 and f32)")
    rows = phase_timing(torch, pa, launches)
    rows += phase_flash_timing(torch, fa, flash_counts, flash_counts_f32,
                               flash_counts_wide, flash_counts_2x,
                               flash_counts_2fw, flash_counts_2fx)
    log("[17/43] timing the LSTM kernels at the char-RNN shapes (bf16 and "
        "f32)")
    rows += phase_lstm_timing(torch, L, lstm_counts, tbptt_counts,
                              f32_counts)
    log(f"[18/43] a GravesLSTM wider than the fused kernels (H={LSTM_WIDE}): "
        "the step loop, card vs CPU")
    phase_lstm_wide(torch, M)
    log("[19/43] path 4s: the bf16 lstm_large char-RNN on "
        "GravesLSTMCharModellingExample's mini-batches (B=32 x T=1000, "
        "tBPTT 50)")
    lstm_4s_launches(rows, phase_lstm_4s(torch, M, card))
    log("[20/43] path 4e: the bf16 lstm_large char-RNN through the training "
        "loop (async iterator, health sentinel, listeners, checkpoints, "
        "evaluate, restore, LBFGS)")
    lstm_4e_launches(rows, phase_lstm_4e(torch, M, card, step4_ms))
    log("[21/43] path 5: the 8-layer bf16 GPT behind ModelServer (predict, "
        "generate, reload under decode, rejections, the breaker, quantized "
        "weights with the drift gate, shutdown)")
    serve5_launches(rows, phase_server(torch, M, card, path1_tok_s))
    log("[22/43] the CNN layers against the CPU and numpy (f32), path 6: "
        "LeNet at bench_lenet's shape, its f32 parity")
    phase_cnn_layers(torch, M)
    phase_lenet(torch, M, card)
    log("[23/43] SelfAttention on the non-causal flash kernels, MoELayer "
        "against numpy, path 2m: the MoE gpt_long GPT, MoE serving")
    counts = phase_attention_moe(torch, M, pa, card)
    rows += attention_moe_rows(torch, fa, counts)
    moe_launches(rows, counts)
    log("[24/43] path 7: ResNet-50 on CIFAR-10 at bench_resnet50's shape "
        "(a ComputationGraph, bf16, B=256)")
    phase_resnet(torch, M, card)
    log("[25/43] the graph on the LSTM kernels: path 4's char-RNN as a "
        "graph against the list container, a masked tBPTT graph, f32 "
        "graph parity with the CPU and numpy")
    graph_launches(rows, phase_graph_lstm(torch, M, card))
    log("[26/43] pretraining on the card: the MNIST VAE example's VAE, the "
        "DeepAutoEncoder RBM stack, an AutoEncoder stack")
    phase_pretrain(torch, M, card)
    cluster_launches(rows, *phases_27_29(torch, M, pa, card))
    # path 9's bf16 paged launches go into rows 1, its f32 predict into
    # the f32 forward row at T=4096, as path 5's
    serve5_launches(rows, phases_30_31(torch, M, pa, card, path1_tok_s))
    # path 10's replicas decode in f32 pools: row 1's f32 rows; their f32
    # predict into the f32 forward row at T=4096
    wire = phases_32_33(torch, M, pa, card)
    rows += wire_rows(torch, pa, dict(wire_paged(wire),
                                      **{"path 1f": path1f["paged"]}))
    serve5_launches(rows, {"paged": {}, "flash": wire["path 10"]["flash"]})
    log(f"  path 11: {json.dumps(phases_34_35(torch, M, card))}")
    log(f"  path 12: {json.dumps(phases_36_37(torch, M, card))}")
    path13, par_counts = phases_38_39(torch, M, card)
    log(f"  path 13: {json.dumps(path13)}")
    par_launches(rows, par_counts)
    path14, spmd_counts = phases_40_41(torch, M, pa, fa, card)
    log(f"  path 14: {json.dumps(path14, default=str)}")
    rows += spmd_rows(torch, pa, rows, spmd_counts)
    paths, etl_counts = phases_42_43(torch, M, card)
    log(f"  paths 15 and 16: {json.dumps(paths, default=str)}")
    p15_launches(rows, etl_counts["path 15"])
    etl_launches(rows, etl_counts["path 16"])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
