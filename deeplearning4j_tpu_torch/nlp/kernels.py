"""Embedding-training steps: the reference's native `AggregateSkipGram` /
`AggregateCBOW` ops (`models/embeddings/learning/impl/elements/
SkipGram.java:258`, `CBOW.java`; C++ in external libnd4j), on PyTorch.

Counterpart of `deeplearning4j_tpu/nlp/kernels.py`, whose steps are
jitted XLA scatters, not Pallas kernels: here they are plain torch ops on
the tables' device (gathers, `index_add_`, `torch.searchsorted`), and
each step updates its tables IN PLACE and returns them, where the JAX
steps return new (donated) buffers. Each function consumes a BATCH of
pairs as dense int64 index tensors. Negative sampling and hierarchical
softmax share one shape: a (B, K) target matrix with per-target binary
labels and a validity mask.

Where the card differs from the CPU: on CUDA, `index_add_` adds with
atomics, so the order of the additions into one row is not fixed, and
two runs with the same inputs can differ in the last bits of a row that a
batch hits more than once. A fit carries those bits on: the most
frequent words' rows take an update clipped to norm `_ROW_CLIP` every
batch, a fixed-length step whose direction the last bits turn, so two
same-seed fits at path 11's shape end up to a few hundredths, or a tenth,
apart in their largest entries (`chip_smoke.py` phase 34 measures it and
holds the whole tables' difference to `W2V_ATOMIC_RATIO` of two seeds').
Under `torch.use_deterministic_algorithms(True)`
torch's CUDA `index_add_` sums in a fixed order (by sorting), and a fit
on the card repeats bit for bit; the products here are element-wise
products and sums, not cuBLAS calls, so that mode needs no cuBLAS
workspace setting. On the CPU the additions run in index order, and a fit
repeats bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def require_partitionable_rng() -> None:
    """JAX PRNG plumbing: the JAX package warns when
    `jax_threefry_partitionable` is off, which voids its mesh-vs-single-
    chip parity of sharded negative draws. The port draws its negatives
    from a `torch.Generator` on the table's device and shards no draw
    (one process per card: `parallel.mesh`), so the flag has no
    counterpart."""
    raise NotImplementedError(
        "nlp.kernels.require_partitionable_rng is JAX PRNG plumbing with no "
        "counterpart in the port: negatives come from a torch.Generator "
        "on the table's device (ROADMAP queue C3, closed: not ported by "
        "design; ground rule 4)")


_ROW_CLIP = 1.0  # max L2 norm of one row's aggregated per-batch update


def _clip_scale(agg: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(agg, dim=-1, keepdim=True)
    return torch.clamp(_ROW_CLIP / torch.clamp(norms, min=1e-12), max=1.0)


def _scatter_clipped(table: torch.Tensor, idx: torch.Tensor,
                     upd: torch.Tensor) -> torch.Tensor:
    """table[idx] += upd in place, with the AGGREGATE per-row update
    clipped to `_ROW_CLIP`. A batch may hit one row hundreds of times
    (tiny vocabs, stop words); a plain summed scatter then applies an
    effective lr of lr x count, which diverges. Clipping the aggregate
    keeps minibatch-SGD semantics in the normal regime (update norms << 1)
    while bounding the pathological one.

    Two regimes, chosen by shape as in the JAX package:
    - the table-shaped accumulator (`index_add_` into zeros, clip per
      row, add): a few streaming passes over the table, no sort; used
      while the table has at most 8 rows per update row;
    - argsort + compact segment sum, for vocabularies far larger than the
      batch, where a table-sized temporary per call would cost more than
      the sort."""
    flat_idx = idx.reshape(-1)
    flat_upd = upd.reshape(-1, upd.shape[-1])
    if table.shape[0] <= 8 * flat_idx.numel():
        agg = torch.zeros_like(table).index_add_(0, flat_idx, flat_upd)
        return table.add_(agg * _clip_scale(agg))
    order = torch.argsort(flat_idx, stable=True)
    si = flat_idx[order]
    su = flat_upd[order]
    first = torch.ones_like(si, dtype=torch.bool)
    first[1:] = si[1:] != si[:-1]
    ranks = torch.cumsum(first, 0) - 1                 # compact segment ids
    agg = torch.zeros_like(su).index_add_(0, ranks, su)  # (B*K, D) compact
    scale = _clip_scale(agg)
    contrib = agg[ranks] * scale[ranks] * first[:, None]
    return table.index_add_(0, si, contrib)


def _log_likelihood_loss(logits, labels, mask):
    ll = torch.where(labels > 0, F.logsigmoid(logits), F.logsigmoid(-logits))
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _pair_update(syn0, syn1, center, targets, labels, mask, lr):
    """Shared skip-gram/HS update math (see skipgram_step)."""
    v = syn0[center]                                   # (B, D)
    u = syn1[targets]                                  # (B, K, D)
    logits = (v[:, None, :] * u).sum(-1)               # (B, K)
    g = (labels - torch.sigmoid(logits)) * mask * lr   # (B, K)
    dv = (g[..., None] * u).sum(1)                     # (B, D)
    du = g[..., None] * v[:, None, :]                  # (B, K, D)
    _scatter_clipped(syn0, center, dv)
    _scatter_clipped(syn1, targets, du)
    return syn0, syn1, _log_likelihood_loss(logits, labels, mask)


def skipgram_step(syn0, syn1, center, targets, labels, mask, lr):
    """One batched skip-gram update (negative sampling OR hierarchical
    softmax: the label/target semantics differ, the math is identical).

    syn0: (V, D) input vectors; syn1: (V', D) output weights
    center (B,) int64; targets (B, K) int64 rows of syn1
    labels (B, K) float 1/0; mask (B, K) float validity
    Returns (syn0, syn1, loss), the tables updated in place.
    """
    return _pair_update(syn0, syn1, center, targets, labels, mask, lr)


def _draw_negatives(cdf: torch.Tensor, gen: torch.Generator, B: int,
                    negative: int) -> torch.Tensor:
    """(B, negative) word ids drawn on the cdf's device by inverse cdf
    over the 0.75-power unigram table. `cdf` is uint32 FIXED POINT held in
    int64 (the host f64 cumsum times 2^32): f32 spacing near 1.0 (~6e-8)
    would round adjacent tail entries of a large vocabulary equal and so
    never draw those words; 2^-32 resolution does not."""
    u = torch.randint(0, 2 ** 32, (B, negative), dtype=torch.int64,
                      generator=gen, device=cdf.device)
    negs = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(negs, 0, cdf.shape[0] - 1)


def _ns_targets(context, negs, nvalid):
    """(targets, labels, mask) of an NS batch: the context word is the
    positive target, a negative equal to it is masked (word2vec skips it),
    and rows at or past `nvalid` are masked whole."""
    B, negative = negs.shape
    targets = torch.cat([context[:, None], negs], dim=1)
    one = torch.ones((B, 1), dtype=torch.float32, device=context.device)
    labels = torch.cat(
        [one, torch.zeros((B, negative), dtype=torch.float32,
                          device=context.device)], dim=1)
    mask = torch.cat([one, (negs != context[:, None]).float()], dim=1)
    rows = torch.arange(B, device=context.device) < nvalid
    return targets, labels, mask * rows[:, None]


def _ns_batch(syn0, syn1, gen, center, context, cdf, lr, nvalid, negative,
              negs: Optional[torch.Tensor] = None):
    """One NS batch with negatives drawn on the device from `gen` (or
    given as `negs`, which draws nothing): (syn0, syn1, loss, gen)."""
    if negs is None:
        negs = _draw_negatives(cdf, gen, center.shape[0], negative)
    targets, labels, mask = _ns_targets(context, negs, nvalid)
    syn0, syn1, loss = _pair_update(syn0, syn1, center, targets, labels,
                                    mask, lr)
    return syn0, syn1, loss, gen


def skipgram_ns_scan(syn0, syn1, centers, contexts, cdf, gen, loss_acc,
                     lrs, nvalids, negative
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Generator]:
    """K sequential NS batches, the device-side negative-sampling
    skip-gram step (the reference's native `AggregateSkipGram` inner
    loop; the JAX package's `lax.scan`). centers/contexts are (K, B)
    int64, lrs/nvalids (K,) per-batch learning rates and valid-row counts
    (a tail batch may be partial: rows at or past nvalid are masked), all
    on the tables' device. `gen` is the carried `torch.Generator` of the
    negative draws; `loss_acc` a 0-d running loss sum on the device, so
    the loop never reads the device from the host. The tables are
    updated in place: (syn0, syn1, loss_acc, gen)."""
    for k in range(centers.shape[0]):
        syn0, syn1, loss, gen = _ns_batch(syn0, syn1, gen, centers[k],
                                          contexts[k], cdf, lrs[k],
                                          nvalids[k], negative)
        loss_acc = loss_acc + loss
    return syn0, syn1, loss_acc, gen


def cbow_step(syn0, syn1, context, cmask, targets, labels, tmask, lr):
    """One batched CBOW update: the mean of the context vectors predicts
    the targets.

    context (B, W) int64 padded context windows; cmask (B, W) validity;
    targets/labels/tmask as in skipgram_step. (syn0, syn1, loss), in
    place.
    """
    cm = cmask[..., None]
    cv = syn0[context] * cm                            # (B, W, D)
    denom = torch.clamp(torch.sum(cmask, dim=1, keepdim=True), min=1.0)
    h = torch.sum(cv, dim=1) / denom                   # (B, D)
    u = syn1[targets]
    logits = (h[:, None, :] * u).sum(-1)
    g = (labels - torch.sigmoid(logits)) * tmask * lr
    dh = (g[..., None] * u).sum(1)                     # (B, D)
    du = g[..., None] * h[:, None, :]
    # word2vec.c adds the FULL hidden error to every context word; the
    # exact mean-pool gradient is 1/|ctx| of that, which batches better
    dctx = dh[:, None, :].expand_as(cv) * cm / denom[..., None]
    _scatter_clipped(syn0, context, dctx)
    _scatter_clipped(syn1, targets, du)
    return syn0, syn1, _log_likelihood_loss(logits, labels, tmask)


def infer_step(vec, syn1, targets, labels, mask, lr):
    """ParagraphVectors inference: update ONLY the inferred doc vector
    against frozen output weights (reference
    `ParagraphVectors.inferVector`): (new vec, loss)."""
    u = syn1[targets]                                  # (B, K, D)
    logits = (vec * u).sum(-1)
    g = (labels - torch.sigmoid(logits)) * mask * lr
    dv = (g[..., None] * u).sum((0, 1))
    return vec + dv, _log_likelihood_loss(logits, labels, mask)


def glove_step(W, b, hW, hb, Wc, bc, hWc, hbc, rows, cols, logX, fX, lr):
    """One batched GloVe AdaGrad update (reference `models/glove/Glove.java`
    + external `nd4j` AdaGrad; co-occurrence factorization
    J = sum f(X) (w_i.w~_j + b_i + b~_j - log X)^2).

    W/b + history hW/hb: main vectors; Wc/bc + hWc/hbc: context vectors.
    rows/cols (B,) int64; logX/fX (B,) float. Every table is updated in
    place; the histories take their whole batch's squared gradients,
    summed over duplicate rows, BEFORE they are read back at `rows` for
    the steps, as the JAX step's scatter then gather does.
    """
    wi, wj = W[rows], Wc[cols]
    diff = (wi * wj).sum(-1) + b[rows] + bc[cols] - logX
    wdiff = fX * diff                                   # (B,)
    gWi = wdiff[:, None] * wj
    gWj = wdiff[:, None] * wi
    gb = wdiff

    hW.index_add_(0, rows, gWi ** 2)
    hWc.index_add_(0, cols, gWj ** 2)
    hb.index_add_(0, rows, gb ** 2)
    hbc.index_add_(0, cols, gb ** 2)
    eps = 1e-8
    W.index_add_(0, rows, -lr * gWi / torch.sqrt(hW[rows] + eps))
    Wc.index_add_(0, cols, -lr * gWj / torch.sqrt(hWc[cols] + eps))
    b.index_add_(0, rows, -lr * gb / torch.sqrt(hb[rows] + eps))
    bc.index_add_(0, cols, -lr * gb / torch.sqrt(hbc[cols] + eps))
    loss = 0.5 * torch.mean(fX * diff ** 2)
    return W, b, hW, hb, Wc, bc, hWc, hbc, loss
