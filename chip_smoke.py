#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deeplearning4j_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, a few minutes on an H100
    python3 chip_smoke.py --lstm-timing [--package OLD/deeplearning4j_tpu_torch]
    python3 chip_smoke.py --path5    # phase 21 alone (about 1.5 minutes)
    python3 chip_smoke.py --phases-22-23   # the CNN and MoE phases alone
    python3 chip_smoke.py --phases-24-26   # the graph and pretraining phases

`--lstm-timing` runs phase 17 alone (the LSTM source built, the rows
checked and timed, launch counts 0) on the checkout's package or, with
`--package`, on another copy of it (an earlier commit's, unpacked with
`git archive` into a git-ignored directory), and prints one JSON line of
the rows' times. Run it old/new/new/old in one call for a kernel A/B.
`--path5` builds the paged and flash sources and runs phase 21 (path 5,
the GPT behind `ModelServer`) alone, then prints one JSON line of its
launch counts. `--phases-22-23` builds the paged and flash sources and
runs phases 22 and 23 alone (their rows and launch counts logged).
`--phases-24-26` builds the LSTM source and runs phases 24 to 26 alone,
then prints one JSON line of phase 25's launch counts.

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
   wgmma kernels; bf16 D >= 256 the "wgmma wide" forward, every launch
   of which must take that route, and the backward, every launch of
   which must take "wgmma wide" at D = 256 and "wgmma cluster" (clusters
   of two blocks, one column half each) at D = 384 and 512, also at T =
   128 and 192, the first 64-row tiles, where the diagonal crosses two
   32-row tiles at D = 384 and 512, and at D = 256 at T = 64, one 64-row
   block alone;
   f32 the split-TF32 kernels, the
   backward at D = 384 and 512 as clusters, all of whose f32 launches
   must take that route);
   each backward run twice, with bit-identical dQ, dK and dV (no
   atomics); at f32 D = 384 and 512 also q/k/v sliced from one fused qkv
   tensor, inputs whose 128-column slices repeat (the clusters' output
   slices must then be bit-identical: every block sums the partial
   scores in the same order), and inputs whose score products cancel
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
   largest |ref|), and the forward without the stash beside it (h_out,
   hT, cT); the cooperative bf16 forward at B = 1, 31, 32, 33, 100, H =
   1024 and 196, masked and not, forward and reverse (`lstm_coop_cases`),
   each also run twice with bit-identical outputs (with and without the
   stash, and the backward on its stash) and every forward launch on
   "cooperative", and on inputs whose rows 8-15 of every 16 repeat rows
   0-7 (B = 64, where its warpgroups split K, and 128; T=50): the
   repeated rows bit-identical; the f32 kernels (split TF32, two forward
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
   launch counts) and at head dims 256, 384 and 512 (B=2, H=4, T=2048;
   the backward at 384 and 512 on the cluster route, logged with its
   clusters: blocks each and how many fit at once); SDPA in f32, TF32
   off; bound 3 x flops / 495 TFLOP/s for the split-TF32 routes, the
   f32-FMA bound printed beside it; the
   int8 kernel also at a
   C=128 chunk; each paged
   case with its launch plan (route, slice, splits);
17. LSTM timing: rows 5-8 at main path 4's shape (T=64, B=2048, H=1024,
   unmasked), main path 4b's window (T=24, B=8192, H=256, unmasked and
   masked) and main path 4s's window (T=50, B=32, H=1024: the cooperative
   forward with and without the stash, the cluster backward) and its
   `output` (T=1000, B=32: the forward without the stash), bf16, the
   same way, beside their plain versions, the bound (2*T*B*H*4H flops;
   each input read and each output written once) and cuDNN's LSTM as
   yardstick (`torch.nn.LSTM`: no peepholes, its own input GEMM; forward
   minus one input matmul, and fwd+bwd minus fwd), with each launch plan;
   the two bf16 forward routes at their boundary (T=64, H=1024, B=128
   cooperative with and without the stash and masked, B=129 and 256
   clusters), the cooperative rows beside the time of the mma.sync
   kernel they replaced (`LSTM_COOP_MMA_MS`); the f32 kernels (split TF32) at T=8, B=2048,
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
   forward launches, all on "cooperative", and 40 unmasked backward
   launches on "bf16 clusters", nothing masked, no plain call; then one
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
   images, seeded class templates plus noise, through
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
   each.

Prints one JSON line of per-kernel numbers, then the card's
`nvidia-smi` line, then as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero and prints no result without a CUDA device or outside a
checkout of the repository. Weights and inputs are made from seeds.
"""
from __future__ import annotations

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


def flash_inputs_sliced(torch, B, T, H, D, seed):
    """f32 q, k, v, dO (B, T, H, D) whose 128-column slices of q, k and dO
    repeat one slice (v's do not): the f32 backward at D > 256 gives each
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


def flash_slices_equal(torch, got):
    """Whether each of dQ, dK, dV (`got[2:]`) has bit-identical 128-column
    slices (see `flash_inputs_sliced`)."""
    return [all(torch.equal(g[..., :128], g[..., i:i + 128])
                for i in range(128, g.shape[-1], 128)) for g in got[2:]]


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
    # blocks, one column half each (bf16 backward), 16-key tiles (f32
    # forward), clusters of D / 128 blocks (f32 backward)
    cases += [(1, 512, 2, D, dt, causal)
              for dt in (torch.float32, torch.bfloat16)
              for D in (384, 512) for causal in (False, True)]
    cases += [(1, 2048, 2, 512, torch.bfloat16, True)]
    cases += [(1, 2048, 2, D, torch.float32, causal)
              for D in (384, 512) for causal in (False, True)]
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
        if dt == torch.float32 and D > 256:
            routes = {key: n for key, n in fa.launches_by_route.items()
                      if key[0] != "fwd"}
            if routes != {("dq", "tf32 cluster"): 2,
                          ("dkv", "tf32 cluster"): 2}:
                raise AssertionError(f"f32 D={D} backward routes {routes}")
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
                                 (512, torch.bfloat16))):
        q, do = flash_inputs(torch, 2, 512, 2, D, dt, seed=70 + i)[:2]
        k, v = flash_inputs(torch, 2, 1024, 2, D, dt, seed=72 + i)[:2]
        check(q, k, v, do, False, dt,
              f"B=2 Tq=512 Tk=1024 H=2 D={D} {str(dt)[6:]} full")
    f32 = torch.float32
    for i, D in enumerate((384, 512)):
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
            same = flash_slices_equal(torch, got)
            if not all(same):
                raise AssertionError(f"{what}: the 128-column slices of dQ, "
                                     f"dK, dV differ in bits ({same})")
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
                       counts_2x):
    """Flash kernels, plain versions and SDPA at the training shapes (bf16
    at path 2's, path 2w's and path 2x's, f32 at path 2f's, each with its
    launch counts)."""
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
    # f32 at head dims 256 (split TF32), 384 and 512 (split-TF32 forward,
    # split-TF32 cluster backward), the shapes of the bf16 rows above
    for D in (256, 384, 512):
        rows += flash_rows(torch, fa, 2, 4, 2048, D, {}, 0.0, seed=40 + D,
                           dtype=torch.float32)
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
    """The bf16 forward (with its stash and without) on inputs whose rows
    8-15 of every 16 repeat rows 0-7 (xw, h0, c0 and the mask): the
    repeated rows must come out bit-identical, since every row's sums run
    in one order. In the cooperative kernel at B <= 64 the two warpgroups
    split K and each finishes one of the two rows of such a pair from
    both partials, so a warpgroup that adds them in its own order shows
    here, not against the tolerance. Also held to the plain version:
    {output: error in tolerances, "mirror bits": 0, or inf when a pair
    differs}."""
    inp = lstm_inputs(torch, T, B, H, torch.bfloat16, seed, masked)
    src = torch.arange(B, device="cuda")
    src = torch.where(src % 16 >= 8, src - 8, src)
    inp["xw"] = inp["xw"][:, src].contiguous()
    inp["h0"], inp["c0"] = inp["h0"][src].contiguous(), inp["c0"][src].contiguous()
    if masked:
        inp["mask"] = inp["mask"][:, src].contiguous()
    got = L.lstm_fwd(inp["xw"], inp["rw"], inp["peep"], inp["h0"],
                     inp["c0"], inp["mask"])
    lean = lstm_fwd_no_stash(L, inp, False)
    ref = L.lstm_fwd_plain(inp["xw"], inp["rw"], inp["peep"], inp["h0"],
                           inp["c0"], inp["mask"])
    torch.cuda.synchronize()
    units = {n: L.error_in_tolerances(a, b, torch.bfloat16)
             for n, a, b in zip(LSTM_OUTS, got, ref) if a is not None}
    same = True
    for t in list(got) + list(lean):
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
    """(T, B, H, masked, reverse) of the cooperative bf16 forward's small
    batches: B = 1, 31, 32, 33 (the warpgroups split K at 64 rows or
    fewer; 31 and 33 are ragged in the 8-row boxes and the 16-row warp
    tiles) and 100 (each warpgroup its own rows), at H = 1024 (128 blocks
    in clusters of 2) and the ragged 196 (25 blocks of 8 units padded to
    32, in clusters of 8), masked and not, forward and reverse; T = 20
    walks the h ping-pong and the two xw buffers many times."""
    return [(20, B, H, masked, reverse) for H in (1024, 196)
            for B in (1, 31, 32, 33, 100) for masked in (False, True)
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
        fwd = {r: n for (k, r), n in L.launches_by_route.items()
               if k == "fwd"}
        if set(fwd) != {"cooperative"}:
            raise AssertionError(f"B={B} H={H}: forward launches by route "
                                 f"{fwd}, all expected on 'cooperative'")
    log(f"  bf16 cooperative forward: bits identical on rerun (with and "
        f"without the stash, and the backward on its stash) and every "
        f"forward launch on 'cooperative' at B = 1, 31, 32, 33, 100, H = "
        f"1024 and 196, masked and not, forward and reverse "
        f"({len(lstm_coop_cases())} cases)")
    for B in (64, 128):
        for masked in (False, True):
            units = lstm_mirror_units(torch, L, 50, B, 1024, masked, seed=43)
            worst = max(units.values())
            log(f"  bf16 cooperative forward, rows 8-15 of every 16 "
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
    of them counted (20 windows: 40 unmasked forward launches on
    "cooperative", 40 backward on "bf16 clusters", nothing masked, no
    plain call), one
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
            {("fwd", "cooperative"): n, ("bwd", "bf16 clusters"): n}, (0, 0))
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
    `fit` and without it in `output`, and the cluster backward; their
    launch counts are filled in by `lstm_4s_launches` once phase 19 has
    run). Then the
    two bf16 forward routes at their boundary (T=64, H=1024: the
    cooperative kernel at B=128, with and without the stash and masked,
    the cluster kernel at B=129 and 256), and the f32 kernels (split
    TF32) at T=8, B=2048, H=1024, at path 4f's shape (T=64, with its
    launch counts) and masked at path 4b's window. The cooperative rows
    print the replaced mma.sync kernel's time beside theirs
    (`LSTM_COOP_MMA_MS`). An f32 row on the split-TF32 route is
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
        kinds = ("fwd", "bwd") if B in (2048, 8192, LSTM_4S["B"]) \
            else ("fwd",)
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
    return rows


def lstm_nostash_row(torch, L, inp, T, B, H, library_ms):
    """The bf16 forward without the training stash (inference) on an
    unmasked case: held to the plain version (`lstm.error_in_tolerances`),
    then timed beside it; the row of the kernels line."""
    lean = lstm_fwd_no_stash(L, inp, False)
    ref = L.lstm_fwd_plain(inp["xw"], inp["rw"], inp["peep"], inp["h0"],
                           inp["c0"], with_stash=False)[:3]
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(lean, ref) if a is not None)
    units = max(L.error_in_tolerances(a, b, torch.bfloat16)
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
    flops, nbytes = lstm_work("fwd", False, T, B, H, 2, stash=False)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    row = {"name": f"lstm_fwd_nostash_t{T}_b{B}_h{H}", "route": "cuda",
           "source": LSTM_SOURCE, "replaces": LSTM_REPLACES[("fwd", False)],
           "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "library_ms": library_ms}
    log(f"  {row['name']} (inference): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, cuDNN LSTM {library_ms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), worst {units:.3f} "
        f"of tolerance [{L.plan('fwd', torch.bfloat16, False, B, H).route}]"
        + lstm_mma_note((T, B, False, False), "fwd"))
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
    rng = np.random.default_rng(11)  # path 1's requests, as phase 7 draws them
    short_t, long_t = SERVER_PROMPT_T
    prompts = [rng.integers(0, V, short_t) for _ in range(4)] \
        + [rng.integers(0, V, long_t) for _ in range(2)]
    n_tok = [int(x) for x in rng.choice((32, 48, 64, 96, 128), 6)]
    prng = np.random.default_rng(21)
    xs = [prng.integers(0, V, (1, SERVER_PREDICT_T)).astype(np.int32)
          for _ in range(SERVER_PREDICTS)]
    small = prng.integers(0, V, (1, short_t)).astype(np.int32)
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


def lenet_batches(np, B, n, seed):
    """Seeded MNIST-shaped data: ten 28x28 uint8 class templates, each
    image its class's template plus uniform noise, one-hot labels."""
    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 256, (10, 784))
    out = []
    for _ in range(n):
        y = rng.integers(0, 10, B)
        x = np.clip(templates[y] + rng.integers(-60, 61, (B, 784)), 0, 255)
        out.append((x.astype(np.uint8), np.eye(10, dtype=np.float32)[y]))
    return out


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
        np, LENET_B, LENET_STEPS + 2, seed=22)]
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
    log(f"  path 6: {LENET_STEPS} steps of B={LENET_B} 28x28x1 uint8 "
        f"(bf16 over f32 masters, Nesterovs): step ms "
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
    for x, y in lenet_batches(np, LENET_PARITY_B, LENET_PARITY_STEPS,
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
    images = lenet_batches(np, 16, 1, seed=24)[0][0]
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


def lstm_mma_note(key, kind) -> str:
    """The replaced mma.sync kernel's time at a cooperative row's shape,
    where PERF.md has it."""
    ms = LSTM_COOP_MMA_MS.get(key) if kind == "fwd" else None
    return "" if ms is None else f" (the mma.sync kernel it replaced: {ms} ms)"


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
    from deeplearning4j_tpu_torch.serving.decode_engine import DecodeEngine
    from deeplearning4j_tpu_torch.util.checkpoint_store import (
        CheckpointStore,
    )
    from deeplearning4j_tpu_torch.util.serialization import (
        restore_model,
        write_model,
    )

    return dict(generate=generate, gpt_configuration=gpt_configuration,
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
                resnet_tiny_configuration=resnet_tiny_configuration)


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
    of the LSTM kernels against an earlier commit's package. `--path5`:
    phase 21 alone. `--phases-22-23`: phases 22 and 23 alone.
    `--phases-24-26`: phases 24 to 26 alone."""
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
    if "--lstm-timing" in argv:
        return lstm_timing_alone(torch, L, cuda_build)
    if "--path5" in argv:
        return path5_alone(torch, M, cuda_build)
    if "--phases-22-23" in argv:
        return phases_22_23_alone(torch, M, pa, fa, cuda_build)
    if "--phases-24-26" in argv:
        return phases_24_26_alone(torch, M, cuda_build)

    card = nvidia_smi_line()
    log(f"[1/26] card: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    built = cuda_build.build(KERNEL_SOURCES)
    log(f"[2/26] build: {time.perf_counter() - t0:.1f} s for "
        f"{len(built)} source(s)")
    for name, res in built.items():
        for line in ptxas_summary(res.log):
            log(f"  {name}: {line}")

    log("[3/26] paged kernels against their plain versions (TF32 off)")
    phase_kernels(torch, pa)
    log("[4/26] flash kernels against their plain versions (TF32 off)")
    phase_flash(torch, fa)
    log("[5/26] f32 DecodeEngine vs generate, 2 layers, d_model 1024")
    phase_parity(torch, M)
    log("[6/26] f32 training, card (kernels) vs CPU (plain), 1 layer, "
        "d_model 1024, T=1024")
    phase_train_parity(torch, M)
    log("[7/26] serving the 8-layer bf16 GPT at full width")
    launches, path1_tok_s = phase_serve(torch, M, pa, card)
    log("[8/26] serving it with int8 KV, the prefix cache and "
        "self-speculation on shared-prefix traffic")
    launches.update(phase_serve_tier(torch, M, pa, card))
    log("[9/26] training the 8-layer bf16 gpt_long GPT at full width")
    flash_counts = phase_train(torch, M, card, torch.bfloat16, TRAIN_B,
                               TRAIN_STEPS, 13, "wgmma")
    log("[9/26] path 2w: the same GPT with 4 heads of 256 (the bf16 "
        "\"wgmma wide\" flash kernels)")
    flash_counts_wide = phase_train(torch, M, card, torch.bfloat16,
                                    TRAIN_WIDE_B, TRAIN_WIDE_STEPS, 15,
                                    "wgmma wide", n_heads=TRAIN_WIDE_HEADS)
    log("[9/26] path 2x: the same GPT with 2 heads of 512 (the bf16 "
        "\"wgmma wide\" forward, the \"wgmma cluster\" backward)")
    flash_counts_2x = phase_train(torch, M, card, torch.bfloat16,
                                  TRAIN_2X_B, TRAIN_2X_STEPS, 16,
                                  TRAIN_2X_ROUTES, n_heads=TRAIN_2X_HEADS)
    log("[10/26] path 2f: training the 8-layer gpt_long GPT in f32 "
        "(split-TF32 flash kernels)")
    flash_counts_f32 = phase_train(torch, M, card, None, TRAIN_F32_B,
                                   TRAIN_F32_STEPS, 14, "tf32")
    log("[11/26] LSTM kernels against their plain versions (TF32 off)")
    phase_lstm_kernels(torch, L, M)
    log("[12/26] f32 char-RNN training, card (kernels) vs CPU (plain), "
        "H=256")
    phase_lstm_train_parity(torch, M)
    log("[13/26] training the bf16 lstm_large char-RNN at full width")
    lstm_counts, step4_ms = phase_lstm_train(torch, M, card, torch.bfloat16)
    log("[14/26] training the bf16 lstm char-RNN with tBPTT 24 at full width")
    tbptt_counts = phase_lstm_tbptt(torch, M, card)
    log("[15/26] path 4f: training the lstm_large char-RNN in f32 "
        "(split-TF32 LSTM kernels)")
    f32_counts, _ = phase_lstm_train(torch, M, card, None, LSTM_F32_STEPS,
                                     "tf32 clusters", seed=2)
    log("[16/26] timing at the serving and training shapes (bf16 and f32)")
    rows = phase_timing(torch, pa, launches)
    rows += phase_flash_timing(torch, fa, flash_counts, flash_counts_f32,
                               flash_counts_wide, flash_counts_2x)
    log("[17/26] timing the LSTM kernels at the char-RNN shapes (bf16 and "
        "f32)")
    rows += phase_lstm_timing(torch, L, lstm_counts, tbptt_counts,
                              f32_counts)
    log(f"[18/26] a GravesLSTM wider than the fused kernels (H={LSTM_WIDE}): "
        "the step loop, card vs CPU")
    phase_lstm_wide(torch, M)
    log("[19/26] path 4s: the bf16 lstm_large char-RNN on "
        "GravesLSTMCharModellingExample's mini-batches (B=32 x T=1000, "
        "tBPTT 50)")
    lstm_4s_launches(rows, phase_lstm_4s(torch, M, card))
    log("[20/26] path 4e: the bf16 lstm_large char-RNN through the training "
        "loop (async iterator, health sentinel, listeners, checkpoints, "
        "evaluate, restore, LBFGS)")
    lstm_4e_launches(rows, phase_lstm_4e(torch, M, card, step4_ms))
    log("[21/26] path 5: the 8-layer bf16 GPT behind ModelServer (predict, "
        "generate, reload under decode, rejections, the breaker, quantized "
        "weights with the drift gate, shutdown)")
    serve5_launches(rows, phase_server(torch, M, card, path1_tok_s))
    log("[22/26] the CNN layers against the CPU and numpy (f32), path 6: "
        "LeNet at bench_lenet's shape, its f32 parity")
    phase_cnn_layers(torch, M)
    phase_lenet(torch, M, card)
    log("[23/26] SelfAttention on the non-causal flash kernels, MoELayer "
        "against numpy, path 2m: the MoE gpt_long GPT, MoE serving")
    counts = phase_attention_moe(torch, M, pa, card)
    rows += attention_moe_rows(torch, fa, counts)
    moe_launches(rows, counts)
    log("[24/26] path 7: ResNet-50 on CIFAR-10 at bench_resnet50's shape "
        "(a ComputationGraph, bf16, B=256)")
    phase_resnet(torch, M, card)
    log("[25/26] the graph on the LSTM kernels: path 4's char-RNN as a "
        "graph against the list container, a masked tBPTT graph, f32 "
        "graph parity with the CPU and numpy")
    graph_launches(rows, phase_graph_lstm(torch, M, card))
    log("[26/26] pretraining on the card: the MNIST VAE example's VAE, the "
        "DeepAutoEncoder RBM stack, an AutoEncoder stack")
    phase_pretrain(torch, M, card)
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
