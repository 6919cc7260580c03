"""Record readers: sources of per-example value lists.

Reference surface: DataVec `RecordReader`/`SequenceRecordReader` as consumed
by `deeplearning4j-core/.../datasets/datavec/RecordReaderDataSetIterator.java`
(SURVEY §2.2). A record is a list of values (numbers or strings — DataVec's
`Writable`s); a sequence record is a list of records (one per timestep).

Readers are plain host-side iterators — no device work happens here. The
CSV hot path optionally goes through the C++ native parser
(`deeplearning4j_tpu_torch.native`) when the shared library is available,
mirroring how the reference's ETL is native-backed (DataVec on libnd4j
buffers); the pure-Python fallback is always present. (Counterpart of
`deeplearning4j_tpu/datavec/records.py`, copied: the port imports nothing
of the JAX package; the native parser is the port's `native`.)
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Union

Value = Union[float, int, str]
Record = List[Value]

_IMG_EXTS = (".ppm", ".pgm", ".npy")


def _coerce(token: str) -> Value:
    """CSV token → float where possible, else the raw string (the adapter
    layer decides how to use string columns, e.g. as labels)."""
    try:
        return float(token)
    except ValueError:
        return token


class RecordReader:
    """One record per example. Iterate, `reset()`, then iterate again."""

    def __iter__(self):
        self.reset()
        return self._iterate()

    def _iterate(self):
        raise NotImplementedError

    def reset(self) -> None:  # stateless readers need nothing
        pass


class SequenceRecordReader(RecordReader):
    """One sequence (list of per-timestep records) per example."""


class CollectionRecordReader(RecordReader):
    """Wraps an in-memory collection of records (reference
    `CollectionRecordReader` — used heavily in DataVec adapter tests)."""

    def __init__(self, records: Sequence[Record]):
        self.records = [list(r) for r in records]

    def _iterate(self):
        return iter([list(r) for r in self.records])


class CollectionSequenceRecordReader(SequenceRecordReader):
    """Wraps an in-memory collection of sequences."""

    def __init__(self, sequences: Sequence[Sequence[Record]]):
        self.sequences = [[list(r) for r in seq] for seq in sequences]

    def _iterate(self):
        return iter([[list(r) for r in seq] for seq in self.sequences])


class LineRecordReader(RecordReader):
    """Each line of each file is one single-value record (reference DataVec
    `LineRecordReader`)."""

    def __init__(self, paths: Union[str, Path, Sequence[Union[str, Path]]]):
        self.paths = _as_paths(paths)

    def _iterate(self):
        for p in self.paths:
            with open(p, "r") as f:
                for line in f:
                    yield [line.rstrip("\n")]


class CSVRecordReader(RecordReader):
    """CSV → records (reference DataVec `CSVRecordReader`): one record per
    line, numeric columns parsed to floats, others kept as strings.

    `skip_lines` drops header rows; `delimiter` defaults to ','. Parsing of
    all-numeric files goes through the C++ native parser when available."""

    def __init__(self, paths: Union[str, Path, Sequence[Union[str, Path]]] = (),
                 skip_lines: int = 0, delimiter: str = ","):
        self.paths = _as_paths(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def _iterate(self):
        from deeplearning4j_tpu_torch.native import csv_parse_numeric

        for p in self.paths:
            rows = csv_parse_numeric(p, self.skip_lines, self.delimiter)
            if rows is not None:  # native fast path (numeric-only file)
                # tolist() unboxes the whole matrix to plain floats in C —
                # iterating rows of np.float64 scalars would hand the boxing
                # cost right back to the per-record consumers
                yield from rows.tolist()
                continue
            with open(p, "r") as f:
                for i, line in enumerate(f):
                    if i < self.skip_lines:
                        continue
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    yield [_coerce(t) for t in line.split(self.delimiter)]


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence (reference DataVec
    `CSVSequenceRecordReader`): each line is one timestep."""

    def __init__(self, paths: Union[str, Path, Sequence[Union[str, Path]]] = (),
                 skip_lines: int = 0, delimiter: str = ","):
        self.paths = _as_paths(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def _iterate(self):
        for p in self.paths:
            inner = CSVRecordReader([p], self.skip_lines, self.delimiter)
            yield list(inner)


class ImageRecordReader(RecordReader):
    """Images → flat pixel records, label appended from the parent directory
    name (reference DataVec `ImageRecordReader` with `ParentPathLabelGenerator`).

    Zero-dependency formats only: `.npy` arrays and binary `.ppm`/`.pgm`
    (the environment has no image codec libraries; datasets cached by the
    fetchers use these formats)."""

    def __init__(self, height: int, width: int, channels: int = 1,
                 paths: Union[str, Path, Sequence[Union[str, Path]]] = (),
                 labels: Optional[List[str]] = None):
        self.height, self.width, self.channels = height, width, channels
        self.paths = _as_paths(paths, exts=_IMG_EXTS)
        # label vocabulary: provided, or inferred (sorted parent dir names)
        self.labels = (list(labels) if labels is not None
                       else sorted({p.parent.name for p in self.paths}))

    def _iterate(self):
        import numpy as np

        for p in self.paths:
            if p.suffix == ".npy":
                img = np.load(p)
            else:
                img = _read_pnm(p)
            img = np.asarray(img, np.float32).reshape(-1)
            expect = self.height * self.width * self.channels
            if img.shape[0] != expect:
                raise ValueError(
                    f"{p}: image has {img.shape[0]} values, expected "
                    f"{self.height}x{self.width}x{self.channels}={expect}")
            # tolist() unboxes to plain Python floats in one C call (list()
            # would create one np.float32 object per pixel)
            rec: Record = img.tolist()
            rec.append(float(self.labels.index(p.parent.name)))
            yield rec

    def num_labels(self) -> int:
        return len(self.labels)


def _as_paths(paths, exts: Optional[tuple] = None) -> List[Path]:
    """str/Path/dir/sequence → flat sorted file list (reference FileSplit)."""
    if isinstance(paths, (str, Path)):
        paths = [paths]
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files = sorted(f for f in p.rglob("*") if f.is_file())
            if exts:
                files = [f for f in files if f.suffix in exts]
            out.extend(files)
        else:
            out.append(p)
    return out


def _read_pnm(path: Path):
    """Binary PPM (P6) / PGM (P5) parser — pure stdlib."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    # header: magic, width, height, maxval — whitespace/comment separated
    tokens: List[bytes] = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: unsupported PNM magic {magic!r}")
    ch = 1 if magic == b"P5" else 3
    i += 1  # single whitespace after maxval
    dtype = np.uint8 if maxval < 256 else ">u2"
    arr = np.frombuffer(data, dtype=dtype, count=w * h * ch, offset=i)
    return arr.reshape(h, w, ch).astype(np.float32)
