"""GloVe: co-occurrence counting + AdaGrad factorization (reference
`models/glove/Glove.java` (438 LoC) and the co-occurrence pipeline
`models/glove/count/` — `BinaryCoOccurrenceWriter.java` /
`BinaryCoOccurrenceReader.java` / `RoundCount.java`: count in memory up to
a cap, spill sorted binary shards to disk, merge-stream them back. The
AdaGrad inner loop is the `glove_step` scatter step).

Counterpart of `deeplearning4j_tpu/nlp/glove.py`: the co-occurrence
counter (and its spill files) is the JAX package's host code and gives
the same triples; the factorization runs on `device`, the card unless
the caller asks for the CPU.
"""
from __future__ import annotations

import heapq
import pathlib
import tempfile
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.kernels import glove_step
from deeplearning4j_tpu_torch.nlp.lookup_table import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache, VocabConstructor
from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device

# (wi, wj) packed into one int64 key: vocab ids are int32, so the pair
# orders lexicographically under the packed comparison — what keeps the
# spill shards and the k-way merge sorted by (row, col)
_SHARD_DTYPE = np.dtype([("key", "<i8"), ("val", "<f8")])
# shard values stay float64 — the in-memory dict accumulates Python floats
# (f64), and the merge must reproduce those sums before the single final
# rounding to f32, or spill-path training would drift a ULP from in-memory


class CooccurrenceCounter:
    """Co-occurrence accumulation with disk spilling (the reference's
    `glove/count/` machinery: `BinaryCoOccurrenceWriter` writes binary
    shards once memory fills, `RoundCount` tracks the merge rounds,
    `BinaryCoOccurrenceReader` streams them back).

    Counts accumulate in a dict until `memory_cap_pairs` DISTINCT pairs,
    then spill to a sorted binary shard (structured int64-key/float32-val,
    memory-mapped on read-back). `finalize()` k-way merge-streams every
    shard chunk-by-chunk — duplicate keys sum across shards — into one
    sorted on-disk triple returned as memmaps, so neither the corpus's
    distinct-pair count nor the merge has to fit in RAM; only the cap and
    the merge chunks do. `memory_cap_pairs=None` keeps everything in
    memory (same sorted output — the factorization is identical in
    practice, which is the parity test's contract; when one pair's
    occurrences straddle spill rounds, the k-way merge sums per-shard f64
    subtotals in a different association order than the in-memory running
    sum, so the final f32 count can differ by one ULP on unlucky
    corpora)."""

    _CHUNK = 1 << 16

    def __init__(self, memory_cap_pairs: Optional[int] = None,
                 spill_dir=None):
        if memory_cap_pairs is not None and memory_cap_pairs < 1:
            raise ValueError("memory_cap_pairs must be >= 1")
        self.memory_cap_pairs = memory_cap_pairs
        self._counts: Dict[Tuple[int, int], float] = {}
        self._shards: List[pathlib.Path] = []
        self._spill_dir = spill_dir
        self._tmpdir: Optional[tempfile.TemporaryDirectory] = None
        self.n_pairs = 0  # distinct pairs in the merged output (finalize)

    def add(self, wi: int, wj: int, w: float) -> None:
        key = (wi, wj)
        self._counts[key] = self._counts.get(key, 0.0) + w
        if (self.memory_cap_pairs is not None
                and len(self._counts) >= self.memory_cap_pairs):
            self._spill()

    # -- spill machinery ----------------------------------------------------
    def _dir(self) -> pathlib.Path:
        if self._spill_dir is not None:
            p = pathlib.Path(self._spill_dir)
            p.mkdir(parents=True, exist_ok=True)
            return p
        if self._tmpdir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="glove_cooc_")
        return pathlib.Path(self._tmpdir.name)

    def _spill(self) -> None:
        if not self._counts:
            return
        arr = np.empty(len(self._counts), _SHARD_DTYPE)
        arr["key"] = np.fromiter(
            ((wi << 32) | wj for wi, wj in self._counts),
            np.int64, len(self._counts))
        arr["val"] = np.fromiter(self._counts.values(), np.float64,
                                 len(self._counts))
        arr.sort(order="key")
        path = self._dir() / f"shard_{len(self._shards):05d}.npy"
        np.save(path, arr)
        self._shards.append(path)
        self._counts.clear()

    @classmethod
    def _iter_shard(cls, path) -> Iterator[Tuple[int, float]]:
        """Stream one sorted shard chunk-by-chunk (mmap: the OS pages in
        only the chunks in flight, the reference's streaming reader
        role)."""
        arr = np.load(path, mmap_mode="r")
        for s in range(0, arr.shape[0], cls._CHUNK):
            chunk = np.asarray(arr[s:s + cls._CHUNK])
            yield from zip(chunk["key"].tolist(), chunk["val"].tolist())

    def finalize(self):
        """(rows, cols, vals) sorted by (row, col) — plain arrays when
        nothing spilled, memmaps over one merged on-disk triple when
        shards exist."""
        if not self._shards:
            if not self._counts:
                raise ValueError(
                    "empty co-occurrence matrix (corpus too small?)")
            items = sorted(self._counts.items())
            rows = np.fromiter((k[0] for k, _ in items), np.int32,
                               len(items))
            cols = np.fromiter((k[1] for k, _ in items), np.int32,
                               len(items))
            vals = np.fromiter((v for _, v in items), np.float32,
                               len(items))
            self.n_pairs = len(items)
            return rows, cols, vals
        self._spill()  # flush the residue as the last shard
        out = self._dir()
        paths = {name: out / f"merged_{name}.bin"
                 for name in ("rows", "cols", "vals")}
        bufs = {name: [] for name in paths}
        n = 0

        def flush():
            for name, buf in bufs.items():
                if buf:
                    dt = np.float32 if name == "vals" else np.int32
                    # vals buffered as f64 partial sums; rounded here once
                    files[name].write(np.asarray(buf, dt).tobytes())
                    buf.clear()

        files = {name: open(p, "wb") for name, p in paths.items()}
        try:
            cur_key, cur_val = None, 0.0
            for key, val in heapq.merge(
                    *(self._iter_shard(p) for p in self._shards)):
                if key == cur_key:
                    cur_val += val  # same pair counted in several shards
                    continue
                if cur_key is not None:
                    bufs["rows"].append(cur_key >> 32)
                    bufs["cols"].append(cur_key & 0xFFFFFFFF)
                    bufs["vals"].append(cur_val)
                    n += 1
                    if n % self._CHUNK == 0:
                        flush()
                cur_key, cur_val = key, val
            if cur_key is not None:
                bufs["rows"].append(cur_key >> 32)
                bufs["cols"].append(cur_key & 0xFFFFFFFF)
                bufs["vals"].append(cur_val)
                n += 1
            flush()
        finally:
            for f in files.values():
                f.close()
        self.n_pairs = n
        rows = np.memmap(paths["rows"], np.int32, mode="r", shape=(n,))
        cols = np.memmap(paths["cols"], np.int32, mode="r", shape=(n,))
        vals = np.memmap(paths["vals"], np.float32, mode="r", shape=(n,))
        return rows, cols, vals

    def cleanup(self) -> None:
        """Drop the temp spill directory (no-op for user-provided dirs —
        their shards may be the reusable artifact)."""
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None


class Glove:
    def __init__(self,
                 layer_size: int = 100,
                 window: int = 5,
                 min_word_frequency: float = 1.0,
                 learning_rate: float = 0.05,
                 epochs: int = 25,
                 batch_size: int = 4096,
                 x_max: float = 100.0,
                 alpha: float = 0.75,
                 symmetric: bool = True,
                 seed: int = 42,
                 cooccurrence_memory_cap: Optional[int] = None,
                 spill_dir=None,
                 device="cuda"):
        """`cooccurrence_memory_cap`: max DISTINCT co-occurring pairs held
        in memory while counting; past it, sorted shards spill to
        `spill_dir` (or a temp dir) and merge-stream back — the reference's
        `BinaryCoOccurrenceWriter` path for corpora whose co-occurrence
        matrix exceeds RAM. None = count fully in memory. Training is
        identical in practice either way (both paths feed the
        factorization the same sorted pair order; counts straddling spill
        rounds may differ by one ULP from the in-memory running sum — see
        `CooccurrenceCounter`). `device`: where the factorization runs."""
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self.seed = seed
        self.cooccurrence_memory_cap = cooccurrence_memory_cap
        self.spill_dir = spill_dir
        self.device = resolve_device(device)
        self.vocab: Optional[AbstractCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        self.mean_loss = 0.0

    def fit(self, sequences: Iterable[Sequence[str]]) -> None:
        seqs = [list(s) for s in sequences]
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(seqs)
        V, D = self.vocab.num_words(), self.layer_size

        # ---- co-occurrence counting (reference glove/count/) --------------
        counter = CooccurrenceCounter(self.cooccurrence_memory_cap,
                                      self.spill_dir)
        for seq in seqs:
            ids = [self.vocab.index_of(t) for t in seq]
            ids = [i for i in ids if i >= 0]
            for pos, wi in enumerate(ids):
                for off in range(1, self.window + 1):
                    j = pos + off
                    if j >= len(ids):
                        break
                    w = 1.0 / off  # distance weighting, as in GloVe
                    counter.add(wi, ids[j], w)
                    if self.symmetric:
                        counter.add(ids[j], wi, w)
        rows, cols, vals = counter.finalize()

        try:
            self._factorize(V, D, rows, cols, vals)
        finally:
            # memmaps are consumed batch-by-batch inside _factorize; the
            # spill files can go once training is done
            del rows, cols, vals
            counter.cleanup()

        # final embedding = W + Wc (standard GloVe practice)
        self.lookup_table = InMemoryLookupTable(self.vocab, self.layer_size,
                                                seed=self.seed,
                                                device=self.device)
        self.lookup_table.syn0 = self._W + self._Wc
        del self._W, self._Wc

    def _factorize(self, V: int, D: int, rows, cols, vals) -> None:
        """AdaGrad factorization on the device; co-occurrence triples are
        indexed per batch (memmap-friendly: only each batch's pairs load
        into RAM), log/weighting computed per batch on the host. The
        final epoch's mean loss is summed on the device and read once."""
        rng = np.random.default_rng(self.seed)
        dev = self.device

        def init(shape):
            return torch.as_tensor((rng.random(shape) - 0.5) / D,
                                   dtype=torch.float32).to(dev)

        def send(a):  # a fresh host array each batch: no staging reuse
            return torch.from_numpy(a).to(dev, non_blocking=True)

        W, Wc = init((V, D)), init((V, D))
        b = torch.zeros(V, dtype=torch.float32, device=dev)
        bc = torch.zeros(V, dtype=torch.float32, device=dev)
        hW = torch.ones((V, D), dtype=torch.float32, device=dev)
        hWc = torch.ones((V, D), dtype=torch.float32, device=dev)
        hb = torch.ones(V, dtype=torch.float32, device=dev)
        hbc = torch.ones(V, dtype=torch.float32, device=dev)

        n = len(rows)
        B = min(self.batch_size, n)
        lr = float(np.float32(self.learning_rate))
        loss_sum, n_batches = None, 0
        for _ in range(self.epochs):
            order = rng.permutation(n)
            loss_sum, n_batches = None, 0
            for s in range(0, n - B + 1, B):  # drop ragged tail (reshuffled next epoch)
                idx = np.sort(order[s:s + B])  # sorted gather: memmap reads
                # stay near-sequential; batch membership (not order within
                # the batch) is what the shuffle needs
                v = np.asarray(vals[idx], np.float32)
                W, b, hW, hb, Wc, bc, hWc, hbc, loss = glove_step(
                    W, b, hW, hb, Wc, bc, hWc, hbc,
                    send(np.asarray(rows[idx], np.int64)),
                    send(np.asarray(cols[idx], np.int64)),
                    send(np.log(v)),
                    send(np.minimum((v / self.x_max) ** self.alpha,
                                    1.0).astype(np.float32)),
                    lr)
                loss = loss.double()
                loss_sum = loss if loss_sum is None else loss_sum + loss
                n_batches += 1
        # mean objective over the final epoch's batches
        self.mean_loss = (float(loss_sum.item()) / n_batches
                          if n_batches else 0.0)
        self._W, self._Wc = W, Wc

    # -- query passthrough --------------------------------------------------
    def words_nearest(self, word, top_n: int = 10):
        return self.lookup_table.words_nearest(word, top_n)

    def similarity(self, w1: str, w2: str) -> float:
        return self.lookup_table.similarity(w1, w2)

    def get_word_vector(self, word: str):
        return self.lookup_table.vector(word)
