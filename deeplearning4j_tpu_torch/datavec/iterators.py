"""RecordReader → DataSet/MultiDataSet iterator adapters.

Reference: `deeplearning4j-core/.../datasets/datavec/
RecordReaderDataSetIterator.java` (classification one-hot / regression column
ranges), `SequenceRecordReaderDataSetIterator.java` (two-reader label
alignment modes with masking), `RecordReaderMultiDataSetIterator.java`
(named readers + per-column-range subsets) — SURVEY §2.2.

Batches are assembled as numpy on the host; sequence batches are padded to
the longest sequence in the batch with (B, T) masks — the mask-based padding
strategy that keeps the step's shapes static per batch. (Counterpart of
`deeplearning4j_tpu/datavec/iterators.py`, copied: the batches are the
JAX package's numpy arrays; the network moves them to its device.)
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.datavec.records import (
    Record,
    RecordReader,
    SequenceRecordReader,
)


class _GeneratorIterator(DataSetIterator):
    """Bridges a generator (`_generate`) to the stateful
    has_next/next/reset contract that AsyncDataSetIterator's producer thread
    drives; reset() restarts from the underlying reader."""

    _gen = None
    _peeked = None

    def _generate(self):
        raise NotImplementedError

    def reset(self) -> None:
        self._gen = self._generate()
        self._peeked = None

    def has_next(self) -> bool:
        if self._gen is None:
            self.reset()
        if self._peeked is None:
            self._peeked = next(self._gen, None)
        return self._peeked is not None

    def next(self):
        if not self.has_next():
            raise StopIteration
        v, self._peeked = self._peeked, None
        return v

    def batch(self) -> int:
        return self.batch_size


def _one_hot(idx: float, n: int) -> np.ndarray:
    i = int(idx)
    if not 0 <= i < n:
        raise ValueError(f"label index {i} out of range [0, {n})")
    v = np.zeros(n, np.float32)
    v[i] = 1.0
    return v


def _num(rec: Record, lo: int, hi: int) -> List[float]:
    out = []
    for v in rec[lo:hi]:
        if isinstance(v, str):
            raise ValueError(
                f"non-numeric value {v!r} in feature columns [{lo}, {hi}) — "
                "string columns must be label columns or excluded")
        out.append(float(v))
    return out


class RecordReaderDataSetIterator(_GeneratorIterator):
    """Classification: `label_index` column one-hot to `num_classes`;
    regression: columns [label_index, label_index_to] are the targets
    (reference `RecordReaderDataSetIterator.java` constructors)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        if label_index is not None and not regression and num_classes is None:
            raise ValueError("classification requires num_classes")
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to if label_index_to is not None else label_index
        # string class labels are mapped to indices in first-seen order
        # (stable across epochs: readers restart deterministically)
        self._label_map: Dict[str, int] = {}

    def _class_index(self, v) -> float:
        if isinstance(v, str):
            idx = self._label_map.setdefault(v, len(self._label_map))
            if idx >= self.num_classes:
                raise ValueError(
                    f"found {len(self._label_map)} distinct string labels "
                    f"({sorted(self._label_map)}) but num_classes="
                    f"{self.num_classes}")
            return float(idx)
        return float(v)

    def _convert(self, rec: Record) -> Tuple[List[float], Optional[np.ndarray]]:
        li = self.label_index
        if li is None:
            return _num(rec, 0, len(rec)), None
        if li < 0:
            li = len(rec) + li
        hi = self.label_index_to if self.label_index_to is not None else li
        if hi < 0:
            hi = len(rec) + hi
        feats = _num(rec, 0, li) + _num(rec, hi + 1, len(rec))
        if self.regression:
            label = np.asarray([float(v) for v in rec[li:hi + 1]], np.float32)
        else:
            label = _one_hot(self._class_index(rec[li]), self.num_classes)
        return feats, label

    def _generate(self):
        batch_f: List[List[float]] = []
        batch_l: List[np.ndarray] = []
        for rec in self.reader:
            f, l = self._convert(rec)
            batch_f.append(f)
            if l is not None:
                batch_l.append(l)
            if len(batch_f) == self.batch_size:
                yield self._emit(batch_f, batch_l)
                batch_f, batch_l = [], []
        if batch_f:
            yield self._emit(batch_f, batch_l)

    def _emit(self, fs, ls) -> DataSet:
        return DataSet(np.asarray(fs, np.float32),
                       np.stack(ls) if ls else None)


class AlignmentMode(str, enum.Enum):
    """Two-reader sequence label alignment (reference
    `SequenceRecordReaderDataSetIterator.AlignmentMode`)."""

    EQUAL_LENGTH = "equal_length"
    ALIGN_START = "align_start"
    ALIGN_END = "align_end"


class SequenceRecordReaderDataSetIterator(_GeneratorIterator):
    """Sequence features (+ optionally separate sequence labels) → padded
    (B, T, F) batches with (B, T) masks.

    Single-reader mode: `label_index` column of each timestep record is the
    per-step label. Two-reader mode: `label_reader` supplies label sequences;
    when lengths differ, `alignment` places the shorter sequence at the
    start/end and masks the rest (reference `SequenceRecordReaderDataSetIterator.java`)."""

    def __init__(self, reader: SequenceRecordReader, batch_size: int,
                 num_classes: Optional[int] = None,
                 label_index: Optional[int] = None,
                 regression: bool = False,
                 label_reader: Optional[SequenceRecordReader] = None,
                 alignment: AlignmentMode = AlignmentMode.EQUAL_LENGTH):
        if label_reader is None and label_index is None:
            raise ValueError("need label_index (single-reader) or label_reader")
        if not regression and num_classes is None:
            raise ValueError("classification requires num_classes")
        self.reader = reader
        self.label_reader = label_reader
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.label_index = label_index
        self.regression = regression
        self.alignment = alignment

    # each item: (feat_seq (Tf, F), label_seq (Tl, L))
    def _items(self):
        if self.label_reader is None:
            for seq in self.reader:
                f_rows, l_rows = [], []
                for rec in seq:
                    li = self.label_index if self.label_index >= 0 else len(rec) + self.label_index
                    f_rows.append(_num(rec, 0, li) + _num(rec, li + 1, len(rec)))
                    l_rows.append(np.asarray([float(rec[li])], np.float32)
                                  if self.regression
                                  else _one_hot(float(rec[li]), self.num_classes))
                yield np.asarray(f_rows, np.float32), np.stack(l_rows)
        else:
            import itertools

            _END = object()
            for seq, lseq in itertools.zip_longest(
                    self.reader, self.label_reader, fillvalue=_END):
                if seq is _END or lseq is _END:
                    which = "label" if seq is _END else "feature"
                    raise ValueError(
                        f"{which} reader ran out of sequences before the "
                        "other — the two readers must yield the same number "
                        "of sequences")
                f = np.asarray([_num(r, 0, len(r)) for r in seq], np.float32)
                if self.regression:
                    l = np.asarray([[float(v) for v in r] for r in lseq], np.float32)
                else:
                    l = np.stack([_one_hot(float(r[0]), self.num_classes)
                                  for r in lseq])
                if self.alignment == AlignmentMode.EQUAL_LENGTH \
                        and f.shape[0] != l.shape[0]:
                    raise ValueError(
                        f"EQUAL_LENGTH alignment but feature seq has "
                        f"{f.shape[0]} steps and label seq {l.shape[0]} "
                        "(use ALIGN_START/ALIGN_END)")
                yield f, l

    def _generate(self):
        buf: List[Tuple[np.ndarray, np.ndarray]] = []
        for item in self._items():
            buf.append(item)
            if len(buf) == self.batch_size:
                yield self._emit(buf)
                buf = []
        if buf:
            yield self._emit(buf)

    def _emit(self, items) -> DataSet:
        B = len(items)
        T = max(max(f.shape[0], l.shape[0]) for f, l in items)
        F = items[0][0].shape[1]
        L = items[0][1].shape[1]
        feats = np.zeros((B, T, F), np.float32)
        labs = np.zeros((B, T, L), np.float32)
        fmask = np.zeros((B, T), np.float32)
        lmask = np.zeros((B, T), np.float32)
        at_end = self.alignment == AlignmentMode.ALIGN_END
        for b, (f, l) in enumerate(items):
            tf, tl = f.shape[0], l.shape[0]
            fo = T - tf if at_end else 0
            lo = T - tl if at_end else 0
            feats[b, fo:fo + tf] = f
            fmask[b, fo:fo + tf] = 1.0
            labs[b, lo:lo + tl] = l
            lmask[b, lo:lo + tl] = 1.0
        same = np.array_equal(fmask, lmask)
        full = bool(fmask.all())
        return DataSet(feats, labs,
                       None if full else fmask,
                       None if full and same else lmask)


class RecordReaderMultiDataSetIterator(_GeneratorIterator):
    """Named readers + per-column-range input/output subsets →
    `MultiDataSet` (reference `RecordReaderMultiDataSetIterator.java`
    builder: `addReader/addInput/addOutput/addOutputOneHot`).

    Build with the `add_*` methods, then iterate:

        it = (RecordReaderMultiDataSetIterator(batch_size=32)
              .add_reader("csv", reader)
              .add_input("csv", 0, 3)
              .add_output_one_hot("csv", 4, 10))
    """

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.readers: Dict[str, RecordReader] = {}
        self._inputs: List[Tuple[str, Optional[int], Optional[int]]] = []
        self._outputs: List[Tuple[str, Optional[int], Optional[int], Optional[int]]] = []

    def add_reader(self, name: str, reader: RecordReader):
        self.readers[name] = reader
        return self

    def add_input(self, name: str, col_from: Optional[int] = None,
                  col_to: Optional[int] = None):
        self._check(name)
        self._inputs.append((name, col_from, col_to))
        return self

    def add_output(self, name: str, col_from: Optional[int] = None,
                   col_to: Optional[int] = None):
        self._check(name)
        self._outputs.append((name, col_from, col_to, None))
        return self

    def add_output_one_hot(self, name: str, col: int, num_classes: int):
        self._check(name)
        self._outputs.append((name, col, col, num_classes))
        return self

    def _check(self, name: str):
        if name not in self.readers:
            raise ValueError(f"unknown reader {name!r}; add_reader first")

    def _cols(self, rec: Record, lo: Optional[int], hi: Optional[int],
              one_hot: Optional[int]) -> np.ndarray:
        lo = 0 if lo is None else lo
        hi = len(rec) - 1 if hi is None else hi
        if one_hot is not None:
            return _one_hot(float(rec[lo]), one_hot)
        return np.asarray(_num(rec, lo, hi + 1), np.float32)

    def _generate(self):
        if not self._inputs or not self._outputs:
            raise ValueError("need at least one input and one output subset")
        iters = {n: iter(r) for n, r in self.readers.items()}
        while True:
            rows_in: List[List[np.ndarray]] = [[] for _ in self._inputs]
            rows_out: List[List[np.ndarray]] = [[] for _ in self._outputs]
            n = 0
            try:
                for _ in range(self.batch_size):
                    recs = {name: next(it) for name, it in iters.items()}
                    for i, (name, lo, hi) in enumerate(self._inputs):
                        rows_in[i].append(self._cols(recs[name], lo, hi, None))
                    for i, (name, lo, hi, oh) in enumerate(self._outputs):
                        rows_out[i].append(self._cols(recs[name], lo, hi, oh))
                    n += 1
            except StopIteration:
                pass
            if n == 0:
                return
            yield MultiDataSet(features=[np.stack(r) for r in rows_in],
                               labels=[np.stack(r) for r in rows_out])
            if n < self.batch_size:
                return
