"""SequenceVectors: the generic embedding-training engine (reference
`models/sequencevectors/SequenceVectors.java:50`, `fit():161`; learning
algorithms SPI `models/embeddings/learning/` — `SkipGram.java`, `CBOW.java`).

Counterpart of `deeplearning4j_tpu/nlp/sequence_vectors.py`. The host
walks sequences, applies subsampling and the shrinking window, and packs
(center, targets, labels, mask) int32 batches; every full batch is one
scatter step on the tables' device (`nlp/kernels.py`, in place). Learning
rate decays linearly with words processed, as in the reference
(`SequenceVectors.java:260` alpha handling).

All of the host randomness (subsampling, shrinking windows, host
negatives, the chunking) is `np.random.default_rng(seed)`, as in the JAX
package, so the (center, context, alpha) stream is identical in both
packages. The negatives of the NS skip-gram path are drawn on the device
from a `torch.Generator` seeded from `seed` and carried across flushes
(where the JAX package carries a threefry key): that path's draws differ
from the JAX package's, and its results are compared by quality, not bit
for bit. `mesh=` (the JAX package's data-parallel training over a device
mesh) takes a `parallel.mesh.Mesh` on one device: after the JAX
package's check that the batch divides by the data axis, training is the
single-device path, which is what the sharded step computes; a mesh whose
slots in one process name several distinct devices raises (one process
per card: `parallel.mesh`).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp import kernels
from deeplearning4j_tpu_torch.nlp.lookup_table import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import (
    AbstractCache,
    VocabConstructor,
    build_huffman_tree,
)
from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device


class SequenceVectors:
    """Train element embeddings over sequences of tokens.

    elements_learning_algorithm: 'skipgram' | 'cbow'
    (reference `ElementsLearningAlgorithm` SPI). `device`: where the
    tables live and the steps run (the card unless the caller asks for
    the CPU).
    """

    def __init__(self,
                 layer_size: int = 100,
                 window: int = 5,
                 min_word_frequency: float = 1.0,
                 negative: int = 5,
                 use_hierarchic_softmax: bool = False,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 epochs: int = 1,
                 iterations: int = 1,
                 batch_size: int = 1024,
                 sampling: float = 0.0,
                 seed: int = 42,
                 elements_learning_algorithm: str = "skipgram",
                 scan_flushes: int = 32,
                 mesh=None,
                 data_axis: str = "data",
                 device="cuda"):
        if mesh is not None:
            mesh_dev = mesh.single_device("SequenceVectors(mesh=...)")
            if mesh_dev.type != resolve_device(device).type:
                raise ValueError(f"the mesh's device {mesh_dev} is not "
                                 f"device={device!r}")
            n = mesh.shape[data_axis]
            if batch_size % n != 0:
                raise ValueError(
                    f"batch_size {batch_size} must divide by the "
                    f"'{data_axis}' mesh axis size {n}")
        if negative <= 0 and not use_hierarchic_softmax:
            raise ValueError("need negative sampling (negative>0) and/or "
                             "hierarchical softmax")
        if negative > 0 and use_hierarchic_softmax and \
                elements_learning_algorithm == "cbow":
            raise NotImplementedError(
                "mixed HS+negative-sampling is only supported for skipgram")
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.iterations = iterations
        self.batch_size = batch_size
        self.sampling = sampling
        self.seed = seed
        self.algorithm = elements_learning_algorithm
        self.device = resolve_device(device)
        # NS fast path: how many flush-batches ride one device step
        self.scan_flushes = max(1, int(scan_flushes))
        self.vocab: Optional[AbstractCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        self._rng = np.random.default_rng(seed)
        self._keep_cache: Optional[np.ndarray] = None
        self._unigram: Optional[np.ndarray] = None
        self._unigram_cdf: Optional[np.ndarray] = None
        self._ns_cdf_dev = None  # device copy of the cdf (NS-on-device)
        self._ns_gen = None      # carried torch.Generator of device draws
        self._loss_sum = 0.0
        self._loss_batches = 0
        self._loss_dev = None
        self._loss_dev_count = 0
        self.mesh = mesh
        self.data_axis = data_axis

    # -- vocab/init ---------------------------------------------------------
    def build_vocab(self, sequences: Iterable[Sequence[str]]) -> None:
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(sequences)
        self._keep_cache = None
        if self.use_hs:
            build_huffman_tree(self.vocab)
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, seed=self.seed, use_hs=self.use_hs,
            negative=self.negative, device=self.device)
        if self.negative > 0:
            self._unigram = self.vocab.unigram_table()
            self._unigram_cdf = None
            self._ns_cdf_dev = None

    # -- training -----------------------------------------------------------
    def fit(self, sequences: Iterable[Sequence[str]]) -> None:
        seqs = [list(s) for s in sequences]
        if self.vocab is None:
            self.build_vocab(seqs)
        total_words = max(
            1.0, self.vocab.total_word_occurrences * self.epochs * self.iterations)
        self._reset_loss()
        batch = _PairBatcher(self)
        if self.algorithm == "skipgram" and self.negative > 0 \
                and not self.use_hs:
            # NS skip-gram (the common configuration — BASELINE config 4):
            # fully vectorized host pipeline, see _fit_vectorized
            self._fit_vectorized(seqs, total_words, batch)
            batch.flush()
            return
        words_seen = 0.0
        for _ in range(self.epochs * self.iterations):
            for seq in seqs:
                ids = self._to_ids(seq)
                if len(ids) < 2:
                    continue
                alpha = max(self.min_learning_rate,
                            self.learning_rate * (1.0 - words_seen / total_words))
                self._train_sequence(ids, alpha, batch)
                words_seen += len(ids)
        batch.flush()

    # chunk size (tokens) for the vectorized pipeline: big enough that the
    # per-chunk numpy fixed costs amortize, small enough that the (L, 2W)
    # windowing grid stays ~20 MB and alpha decay keeps per-chunk
    # granularity (the reference decays per sentence batch,
    # `SequenceVectors.java:260`)
    _CHUNK_TOKENS = 262_144

    def _encode_corpus(self, seqs):
        """token→id for the whole corpus in ONE pass (OOV dropped): flat
        int32 id array + per-sentence kept lengths. The per-token dict
        lookup — the irreducible host cost — happens exactly once per fit,
        not once per epoch, and everything downstream is numpy array math.
        This finishes the `AggregateSkipGram` replacement host-side
        (reference `SkipGram.java:216` made windowing a native op because
        interpreted per-pair loops cannot keep an accelerator fed)."""
        lookup = {vw.word: vw.index for vw in self.vocab.vocab_words()}
        flat: List[int] = []
        lens = np.empty(len(seqs), np.int64)
        for si, seq in enumerate(seqs):
            ids = [i for i in map(lookup.get, seq) if i is not None]
            flat.extend(ids)
            lens[si] = len(ids)
        return np.asarray(flat, np.int32), lens

    def _keep_probs(self) -> np.ndarray:
        """Per-vocab-index subsampling keep probability
        P(keep) = sqrt(t/f) + t/f (word2vec's formula), computed once per
        vocab and cached (both the vectorized and the per-sentence paths
        index this array, so the two cannot drift)."""
        if self._keep_cache is None:
            # vocab_words() is index-ordered, so position == vocab index
            counts = np.array([vw.count for vw in self.vocab.vocab_words()],
                              np.float64)
            f = counts / self.vocab.total_word_occurrences
            self._keep_cache = np.minimum(
                1.0, np.sqrt(self.sampling / f) + self.sampling / f)
        return self._keep_cache

    def _fit_vectorized(self, seqs, total_words: float,
                        batch: "_PairBatcher") -> None:
        """Corpus-level vectorized NS skip-gram training: encode once, then
        per epoch run chunked whole-corpus windowing (subsampling and the
        shrinking window drawn as arrays, sentence boundaries enforced by a
        mask) and ship the (center, context) id arrays straight to the
        device step (the per-sentence Python loop it replaces would leave
        the card waiting on the host)."""
        flat, lens = self._encode_corpus(seqs)
        if flat.size == 0:
            return
        starts = np.zeros(lens.size + 1, np.int64)
        np.cumsum(lens, out=starts[1:])
        keep = self._keep_probs() if self.sampling > 0 else None
        # chunk edges in sentence space, each chunk ~_CHUNK_TOKENS ids
        edges = [0]
        tok = 0
        for si in range(lens.size):
            tok += int(lens[si])
            if tok >= self._CHUNK_TOKENS:
                edges.append(si + 1)
                tok = 0
        if edges[-1] != lens.size:
            edges.append(lens.size)
        words_seen = 0.0
        for _ in range(self.epochs * self.iterations):
            for ci in range(len(edges) - 1):
                i, j = edges[ci], edges[ci + 1]
                ids = flat[starts[i]:starts[j]]
                lens_c = lens[i:j]
                if ids.size == 0:
                    continue
                if keep is not None:
                    m = self._rng.random(ids.size) < keep[ids]
                    sent_idx = np.repeat(np.arange(j - i), lens_c)
                    ids = ids[m]
                    lens_c = np.bincount(sent_idx[m], minlength=j - i)
                centers, contexts, counts = _window_pairs(
                    ids, lens_c, self.window, self._rng)
                if centers.size:
                    # per-PAIR linear alpha decay, indexed by the word
                    # position each pair's center occupies — finer than the
                    # reference's per-sentence decay
                    # (`SequenceVectors.java:260`), and in particular still
                    # decaying inside a single-chunk corpus
                    pos = np.repeat(np.arange(ids.size), counts)
                    alphas = np.maximum(
                        self.min_learning_rate,
                        self.learning_rate
                        * (1.0 - (words_seen + pos) / total_words)
                    ).astype(np.float32)
                    batch.add_pairs(centers, contexts, alphas)
                words_seen += float(ids.size)

    def _to_ids(self, seq: Sequence[str]) -> List[int]:
        keep = self._keep_probs() if self.sampling > 0 else None
        ids = []
        for tok in seq:
            i = self.vocab.index_of(tok)
            if i < 0:
                continue
            if keep is not None and self._rng.random() > keep[i]:
                continue
            ids.append(i)
        return ids

    def _train_sequence(self, ids: List[int], alpha: float, batch: "_PairBatcher"):
        window = self.window
        if self.algorithm == "skipgram" and self.negative > 0 \
                and not self.use_hs:
            # vectorized fast path (the common NS configuration): build the
            # whole sentence's (center, context) pair list with array ops —
            # the per-pair Python loop was the training bottleneck, not the
            # device step. (SequenceVectors.fit no longer comes here —
            # it runs the chunked corpus-level _fit_vectorized — but
            # ParagraphVectors DBOW word training still does, per document.)
            arr = np.asarray(ids, np.int32)
            centers, contexts, _ = _window_pairs(
                arr, np.array([len(ids)], np.int64), window, self._rng)
            batch.add_pairs(centers, contexts, alpha)
            return
        for pos, center in enumerate(ids):
            b = int(self._rng.integers(1, window + 1))  # shrinking window
            lo, hi = max(0, pos - b), min(len(ids), pos + b + 1)
            context = [ids[j] for j in range(lo, hi) if j != pos]
            if not context:
                continue
            if self.algorithm == "skipgram":
                for c in context:
                    batch.add_pair(center, c, alpha)
            elif self.algorithm == "cbow":
                batch.add_cbow(context, center, alpha)
            else:
                raise ValueError(self.algorithm)

    # hooks used by _PairBatcher ------------------------------------------
    def _kernels(self):
        """(skipgram_step, cbow_step) on the tables' device."""
        return kernels.skipgram_step, kernels.cbow_step

    def _ns_kernel(self):
        """The device-side negative-sampling skip-gram step (see
        `kernels.skipgram_ns_scan`)."""
        return kernels.skipgram_ns_scan

    def _ns_device_state(self):
        """(device cdf, carried generator) for on-device negative
        sampling. The cdf goes to the device as uint32 fixed point (f64
        cumsum x 2^32) held in int64, torch's uint32 support being thin:
        f32 would round adjacent tail entries of a large vocabulary
        equal, making those words unsampleable (see
        `kernels._draw_negatives`). The generator lives on the tables'
        device, seeded from `seed`, and carries its state across flushes
        and fits."""
        if self._unigram_cdf is None:
            self._unigram_cdf = np.cumsum(self._unigram)
        if self._ns_cdf_dev is None:
            fixed = np.minimum(np.round(self._unigram_cdf * 2.0 ** 32),
                               2.0 ** 32 - 1).astype(np.uint32)
            self._ns_cdf_dev = torch.from_numpy(fixed.astype(np.int64)).to(
                self.device)
        if self._ns_gen is None:
            self._ns_gen = torch.Generator(device=self.device)
            self._ns_gen.manual_seed(self.seed)
        return self._ns_cdf_dev, self._ns_gen

    def _sample_negatives(self, n) -> np.ndarray:
        """Draw from the 0.75-power unigram distribution. Inverse-CDF via
        searchsorted: O(log V) per draw and fully vectorizable — the
        per-pair `rng.choice(p=...)` it replaces rebuilt an O(V) sampler
        per call and dominated the whole training loop. `n` may be a shape
        tuple."""
        if self._unigram_cdf is None:
            self._unigram_cdf = np.cumsum(self._unigram)
        idx = np.searchsorted(self._unigram_cdf, self._rng.random(n))
        # cumsum rounding can leave cdf[-1] slightly below 1.0, in which
        # case a draw above it would index past the vocabulary
        return np.minimum(idx, len(self._unigram) - 1).astype(np.int32)

    def _reset_loss(self) -> None:
        """Zero ALL loss-accumulation state (host f64 sum, batch count, and
        the carried device accumulator) — every fit entry point must call
        this, or a prior fit's undrained device sum leaks into the next."""
        self._loss_sum, self._loss_batches = 0.0, 0
        self._loss_dev, self._loss_dev_count = None, 0

    def _record_loss(self, loss) -> None:
        """Accumulate WITHOUT a per-flush host read: a read per flush
        would wait for the device every flush and leave it idle while the
        host builds the next batch. The per-flush losses chain into ONE
        device scalar (an asynchronous add, never a list of tensors),
        which is folded into the host f64 sum every `_LOSS_FOLD` flushes
        with a single one-scalar read: an f32 running sum alone would stop
        absorbing small increments on very long runs."""
        self._loss_dev = loss if self._loss_dev is None else self._loss_dev + loss
        self._loss_batches += 1
        self._loss_dev_count += 1
        if self._loss_dev_count >= self._LOSS_FOLD:
            self._drain_loss()

    def _record_loss_acc(self, acc, n_batches: int = 1) -> None:
        """Store a step-carried running sum (the accumulation already
        happened inside the device step)."""
        self._loss_dev = acc
        self._loss_batches += n_batches
        self._loss_dev_count += n_batches
        if self._loss_dev_count >= self._LOSS_FOLD:
            self._drain_loss()

    _LOSS_FOLD = 256

    def _drain_loss(self) -> None:
        if self._loss_dev is not None:
            self._loss_sum += float(self._loss_dev.item())
            self._loss_dev = None
            self._loss_dev_count = 0

    @property
    def mean_loss(self) -> float:
        self._drain_loss()
        return self._loss_sum / max(self._loss_batches, 1)

    # -- query passthrough --------------------------------------------------
    def words_nearest(self, word, top_n: int = 10):
        return self.lookup_table.words_nearest(word, top_n)

    def similarity(self, w1: str, w2: str) -> float:
        return self.lookup_table.similarity(w1, w2)

    def get_word_vector(self, word: str):
        return self.lookup_table.vector(word)


def _window_pairs(ids: np.ndarray, lens: np.ndarray, window: int,
                  rng) -> tuple:
    """Skip-gram windowing over a chunk of concatenated sentences, fully
    vectorized: per-position shrinking windows b ~ U[1, window] drawn as one
    array, an (L, 2*window) index grid, and a validity mask that enforces
    both the window radius and same-sentence bounds. Returns aligned
    (centers, contexts) int32 arrays plus the per-position pair count —
    the host half of the reference's `AggregateSkipGram` native op
    (`SkipGram.java:216`)."""
    L = ids.size
    if L == 0:
        return (np.empty(0, np.int32),) * 2 + (np.empty(0, np.int64),)
    b = rng.integers(1, window + 1, L)  # shrinking windows
    offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    grid = np.arange(L)[:, None] + offs[None, :]
    ends = np.cumsum(lens)
    sent_of = np.repeat(np.arange(lens.size), lens)
    lo = (ends - lens)[sent_of][:, None]
    hi = ends[sent_of][:, None]
    valid = ((np.abs(offs)[None, :] <= b[:, None])
             & (grid >= lo) & (grid < hi))
    counts = valid.sum(1)
    centers = np.repeat(ids, counts)
    contexts = ids[grid[valid]]  # row-major: aligned with repeat
    return centers, contexts, counts


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


def _staging(shape, dtype, device: torch.device, fill=0) -> np.ndarray:
    """A host staging array of the batcher. For a card it is page-locked
    (a numpy view of pinned memory), so that a transfer from it is a
    true asynchronous DMA; `_send` therefore never sends it as it is."""
    if device.type != "cuda":
        return np.full(shape, fill, dtype)
    a = torch.empty(shape, dtype=_TORCH_DTYPES[np.dtype(dtype)],
                    pin_memory=True).numpy()
    a.fill(fill)
    return a


def _send(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A COPY of host array `a` on `device`. The flush sends its staging
    arrays, which the next batch overwrites as soon as the flush returns,
    while the device may not have run the transfer yet (a flush returns
    without waiting for the device). So the rows are first copied: on a
    card into a block of torch's pinned caching allocator, which is not
    handed out again until the transfer that reads it has run; on the CPU
    into a fresh array (`torch.from_numpy` alone would alias `a`)."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(a))
    buf = torch.empty(a.shape, dtype=_TORCH_DTYPES[a.dtype], pin_memory=True)
    buf.numpy()[...] = a
    return buf.to(device, non_blocking=True)


class _PairBatcher:
    """Accumulates training examples into fixed-shape host arrays and
    flushes them through the device steps (the tail batch is
    mask-padded)."""

    def __init__(self, sv: SequenceVectors):
        self.sv = sv
        B = sv.batch_size
        # target row count: negatives+1 (NS) and/or max code length (HS)
        self._max_codes = 0
        if sv.use_hs:
            self._max_codes = max((len(vw.codes)
                                   for vw in sv.vocab.vocab_words()), default=0)
        self.K = (sv.negative + 1 if sv.negative > 0 else 0) + self._max_codes
        self.W = 2 * sv.window
        dev = sv.device
        self.center = _staging(B, np.int32, dev)
        self.targets = _staging((B, self.K), np.int32, dev)
        self.labels = _staging((B, self.K), np.float32, dev)
        self.mask = _staging((B, self.K), np.float32, dev)
        self.context = _staging((B, self.W), np.int32, dev)
        self.cmask = _staging((B, self.W), np.float32, dev)
        # pair-mode staging: scan_k flush-batches accumulate and go to the
        # device as ONE transfer and one device step (the host's fixed
        # cost per flush is paid once for scan_k batches)
        self.scan_k = max(1, int(getattr(sv, "scan_flushes", 32)))
        self.pair_center = _staging(B * self.scan_k, np.int32, dev)
        self.pair_context = _staging(B * self.scan_k, np.int32, dev)
        self.row_alpha = _staging(self.scan_k, np.float32, dev, 0.025)
        self.alpha = 0.025
        self.n = 0
        # "pairs" = NS-only skip-gram fast path (negatives drawn on device,
        # flush sends two (scan_k, B) id arrays); "generic" = host-built
        # (B, K) target/label/mask rows (HS, CBOW, ParagraphVectors
        # add_pair). A batcher serves ONE mode for its lifetime.
        self._mode: Optional[str] = None

    def _fill_targets(self, row: int, predicted: int):
        """Targets for predicting word id `predicted`: NS = [pos, negs];
        HS = its Huffman path (labels = 1 - code)."""
        sv = self.sv
        k = 0
        if sv.negative > 0:
            self.targets[row, 0] = predicted
            self.labels[row, 0] = 1.0
            self.mask[row, 0] = 1.0
            negs = sv._sample_negatives(sv.negative)
            for ng in negs:
                k += 1
                self.targets[row, k] = ng
                self.labels[row, k] = 0.0
                # word2vec skips a negative that equals the positive
                self.mask[row, k] = 0.0 if ng == predicted else 1.0
            k += 1
        if sv.use_hs:
            vw = sv.vocab.element_at_index(predicted)
            for code, point in zip(vw.codes, vw.points):
                self.targets[row, k] = point
                self.labels[row, k] = 1.0 - code
                self.mask[row, k] = 1.0
                k += 1

    def add_pairs(self, centers: np.ndarray, contexts: np.ndarray,
                  alpha):
        """Bulk skip-gram add (NS-only fast path): stages just the
        (center, context) id pairs — negatives, labels, and masks are built
        on device by `skipgram_ns_scan`. `alpha` is a scalar or a per-pair
        array (the kernel applies one learning rate per flush-row of B
        pairs; an array alpha sets each row's rate from its first pair)."""
        if self._mode == "generic":
            raise RuntimeError("batcher already in generic mode")
        self._mode = "pairs"
        B = len(self.center)
        cap = len(self.pair_center)
        i, n_total = 0, len(centers)
        while i < n_total:
            take = min(cap - self.n, n_total - i)
            rows = slice(self.n, self.n + take)
            self.pair_center[rows] = centers[i:i + take]
            self.pair_context[rows] = contexts[i:i + take]
            r0, r1 = self.n // B, (self.n + take - 1) // B + 1
            if np.ndim(alpha) == 0:
                self.row_alpha[r0:r1] = alpha
            else:
                firsts = np.maximum(np.arange(r0, r1) * B, self.n) \
                    - self.n + i
                self.row_alpha[r0:r1] = alpha[firsts]
            self.n += take
            i += take
            if self.n == cap:
                self.flush()

    def add_pair(self, center: int, context: int, alpha: float):
        """Skip-gram: center predicts context. In the NS-only configuration
        this stages the raw pair for device-side sampling (same mode as
        add_pairs, so DBOW doc-pairs and word training share one batcher);
        with hierarchical softmax the targets are built host-side."""
        sv = self.sv
        if sv.negative > 0 and not sv.use_hs:
            if self._mode == "generic":
                raise RuntimeError("batcher already in generic mode")
            self._mode = "pairs"
            row = self.n
            self.pair_center[row] = center
            self.pair_context[row] = context
            self.row_alpha[row // len(self.center)] = alpha
            self.n += 1
            if self.n == len(self.pair_center):
                self.flush()
            return
        if self._mode == "pairs":
            raise RuntimeError("batcher already in pairs mode")
        self._mode = "generic"
        row = self.n
        self.center[row] = center
        self.targets[row] = 0
        self.labels[row] = 0
        self.mask[row] = 0
        self._fill_targets(row, context)
        self.alpha = alpha
        self.n += 1
        if self.n == len(self.center):
            self.flush()

    def add_cbow(self, context: List[int], center: int, alpha: float):
        if self._mode == "pairs":
            raise RuntimeError("batcher already in pairs mode")
        self._mode = "generic"
        row = self.n
        self.context[row] = 0
        self.cmask[row] = 0
        w = min(len(context), self.W)
        self.context[row, :w] = context[:w]
        self.cmask[row, :w] = 1.0
        self.targets[row] = 0
        self.labels[row] = 0
        self.mask[row] = 0
        self._fill_targets(row, center)
        self.alpha = alpha
        self.n += 1
        if self.n == len(self.center):
            self.flush()

    def flush(self):
        if self.n == 0:
            return
        sv = self.sv
        lt = sv.lookup_table
        dev = sv.device
        # the staging arrays go to the device as copies (`_send`): the
        # device step may run after the next batch has overwritten them
        send = lambda a: _send(a, dev)
        if self._mode == "pairs":
            cdf, gen = sv._ns_device_state()
            step = sv._ns_kernel()
            acc = (sv._loss_dev if sv._loss_dev is not None
                   else torch.zeros((), dtype=torch.float32, device=dev))
            B = len(self.center)
            n_rows = -(-self.n // B)  # batches actually represented
            # only the represented batches go: a batch past them would be
            # fully masked (nvalid 0) and change nothing but the draws
            nvalids = np.clip(self.n - np.arange(n_rows) * B, 0, B).astype(
                np.int32)
            lt.syn0, lt.syn1neg, new_acc, sv._ns_gen = step(
                lt.syn0, lt.syn1neg,
                send(self.pair_center[:n_rows * B]).long().view(n_rows, B),
                send(self.pair_context[:n_rows * B]).long().view(n_rows, B),
                cdf, gen, acc, send(self.row_alpha[:n_rows]), send(nvalids),
                sv.negative)
            sv._record_loss_acc(new_acc, n_batches=n_rows)
            self.n = 0
            return
        self.mask[self.n:] = 0.0
        self.cmask[self.n:] = 0.0
        lr = float(np.float32(self.alpha))
        syn1 = lt.syn1neg if sv.negative > 0 else lt.syn1
        skipgram_step, cbow_step = sv._kernels()
        if sv.use_hs and sv.negative > 0:
            # mixed mode: split columns — NS rows live in syn1neg, HS rows
            # in syn1; run two steps on the column slices
            ns_cols = sv.negative + 1
            center = send(self.center).long()
            targets = send(self.targets).long()
            labels, mask = send(self.labels), send(self.mask)
            lt.syn0, lt.syn1neg, loss1 = skipgram_step(
                lt.syn0, lt.syn1neg, center, targets[:, :ns_cols],
                labels[:, :ns_cols], mask[:, :ns_cols], lr)
            lt.syn0, lt.syn1, loss2 = skipgram_step(
                lt.syn0, lt.syn1, center, targets[:, ns_cols:],
                labels[:, ns_cols:], mask[:, ns_cols:], lr)
            sv._record_loss(loss1 + loss2)
        elif sv.algorithm == "cbow":
            lt.syn0, new_syn1, loss = cbow_step(
                lt.syn0, syn1, send(self.context).long(),
                send(self.cmask), send(self.targets).long(),
                send(self.labels), send(self.mask), lr)
            self._store_syn1(new_syn1)
            sv._record_loss(loss)
        else:
            lt.syn0, new_syn1, loss = skipgram_step(
                lt.syn0, syn1, send(self.center).long(),
                send(self.targets).long(), send(self.labels),
                send(self.mask), lr)
            self._store_syn1(new_syn1)
            sv._record_loss(loss)
        self.n = 0

    def _store_syn1(self, new_syn1):
        lt = self.sv.lookup_table
        if self.sv.negative > 0:
            lt.syn1neg = new_syn1
        else:
            lt.syn1 = new_syn1
