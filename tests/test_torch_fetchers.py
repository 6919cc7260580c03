"""The dataset fetchers of the port (`datasets.fetchers`, `datasets.hdf5`)
against the JAX package's: every iterator's batches equal, array for array
and dtype for dtype, for the same seed, on the synthetic stand-ins and on
cached files written here (idx, gzipped idx, CSV, npz, HDF5); the data
files the port copies are byte-equal to the originals."""
import gzip
import hashlib
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu.datasets import hdf5 as jh
from deeplearning4j_tpu_torch.datasets import fetchers as tf
from deeplearning4j_tpu_torch.datasets import hdf5 as th

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the tier runs
    several pytest-xdist workers on one host, and torch's default of a
    thread per core in each of them oversubscribes the cores, so that
    every small op waits for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(it):
    out = []
    it.reset()
    while it.has_next():
        ds = it.next()
        out.append((ds.features, ds.labels))
    return out


def _same_batches(a, b):
    ba, bb = _batches(a), _batches(b)
    assert len(ba) == len(bb) > 0
    for (fa, la), (fb, lb) in zip(ba, bb):
        assert fa.dtype == fb.dtype and fa.shape == fb.shape
        np.testing.assert_array_equal(fa, fb)
        if la is None:
            assert lb is None
        else:
            assert la.dtype == lb.dtype
            np.testing.assert_array_equal(la, lb)


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """Both modules' DATA_DIR (read once, at import) pointed at one
    fresh directory."""
    monkeypatch.setattr(jf, "DATA_DIR", tmp_path)
    monkeypatch.setattr(tf, "DATA_DIR", tmp_path)
    return tmp_path


SYNTHETIC = [
    ("mnist", lambda m: m.MnistDataSetIterator(64, num_examples=300)),
    ("mnist test", lambda m: m.MnistDataSetIterator(100, num_examples=200,
                                                    train=False, seed=3)),
    ("mnist uint8", lambda m: m.MnistDataSetIterator(
        128, num_examples=300, raw_uint8=True)),
    ("iris", lambda m: m.IrisDataSetIterator(32)),
    ("iris seed", lambda m: m.IrisDataSetIterator(50, num_examples=90,
                                                  seed=11)),
    ("cifar", lambda m: m.CifarDataSetIterator(40, num_examples=120)),
    ("cifar flat test", lambda m: m.CifarDataSetIterator(
        50, num_examples=100, train=False, flatten=True)),
    ("lfw", lambda m: m.LFWDataSetIterator(16, num_examples=40)),
    ("lfw flat", lambda m: m.LFWDataSetIterator(
        10, num_examples=30, image_shape=(24, 20, 1), num_labels=4,
        flatten=True, seed=2)),
    ("curves", lambda m: m.CurvesDataSetIterator(32, num_examples=100)),
    ("digits", lambda m: m.DigitsDataSetIterator(256)),
    ("digits test ids", lambda m: m.DigitsDataSetIterator(
        100, train=False, one_hot=False)),
    ("patches", lambda m: m.RealPatchesDataSetIterator(500)),
    ("patches test uint8", lambda m: m.RealPatchesDataSetIterator(
        128, train=False, raw_uint8=True, one_hot=False)),
]


@pytest.mark.parametrize("name,make", SYNTHETIC, ids=[s[0] for s in SYNTHETIC])
def test_synthetic_and_packaged_batches_equal(name, make, data_dir):
    """With an empty cache each fetcher makes the same stand-in (or
    reads the same packaged npz) in both packages."""
    _same_batches(make(jf), make(tf))


def test_packaged_data_files_are_byte_copies():
    for name in ("digits_real.npz", "real_patches32.npz"):
        a = (REPO / "deeplearning4j_tpu/datasets/data" / name).read_bytes()
        b = (REPO / "deeplearning4j_tpu_torch/datasets/data" / name).read_bytes()
        assert hashlib.sha256(a).hexdigest() == hashlib.sha256(b).hexdigest()


def _write_idx(path: Path, images: np.ndarray, labels: np.ndarray,
               gz: bool) -> None:
    n, r, c = images.shape
    opener = gzip.open if gz else open
    with opener(str(path[0]) + (".gz" if gz else ""), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, r, c) + images.tobytes())
    with opener(str(path[1]) + (".gz" if gz else ""), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("raw_uint8", [False, True])
def test_cached_mnist_idx_files_read_the_same(data_dir, gz, raw_uint8):
    rng = np.random.default_rng(1)
    (data_dir / "mnist").mkdir()
    for train, n in ((True, 50), (False, 20)):
        stem = "train" if train else "t10k"
        _write_idx((data_dir / "mnist" / f"{stem}-images-idx3-ubyte",
                    data_dir / "mnist" / f"{stem}-labels-idx1-ubyte"),
                   rng.integers(0, 256, (n, 28, 28), dtype=np.uint8),
                   rng.integers(0, 10, n, dtype=np.uint8), gz)
    for train in (True, False):
        make = lambda m: m.MnistDataSetIterator(16, num_examples=40,
                                                train=train,
                                                raw_uint8=raw_uint8)
        _same_batches(make(jf), make(tf))
        f = _batches(make(tf))[0][0]
        assert f.dtype == (np.uint8 if raw_uint8 else np.float32)


def test_cached_iris_cifar_lfw_and_packaged_overrides_read_the_same(
        data_dir):
    rng = np.random.default_rng(2)
    (data_dir / "iris").mkdir()
    names = ["Iris-setosa", "Iris-versicolor", "Iris-virginica"]
    rows = [",".join(f"{v:.1f}" for v in rng.uniform(0, 8, 4))
            + f",{names[i % 3]}" for i in range(30)]
    (data_dir / "iris" / "iris.data").write_text("\n".join(rows) + "\n\n")
    (data_dir / "cifar10").mkdir()
    for split, n in (("train", 40), ("test", 12)):
        np.savez(data_dir / "cifar10" / f"{split}.npz",
                 images=rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
                 labels=rng.integers(0, 10, n))
    (data_dir / "lfw").mkdir()
    np.savez(data_dir / "lfw" / "data.npz",
             images=rng.integers(0, 256, (25, 12, 10, 3), dtype=np.uint8),
             labels=rng.integers(0, 5, 25))
    np.savez(data_dir / "digits_real.npz",
             images=rng.integers(0, 17, (1600, 64)),
             labels=rng.integers(0, 10, 1600))
    np.savez(data_dir / "real_patches32.npz",
             images=rng.integers(0, 256, (1600, 32, 32, 3), dtype=np.uint8),
             labels=rng.integers(0, 2, 1600))
    for make in (lambda m: m.IrisDataSetIterator(7, num_examples=25),
                 lambda m: m.CifarDataSetIterator(16, num_examples=30),
                 lambda m: m.CifarDataSetIterator(5, train=False,
                                                  flatten=True),
                 lambda m: m.LFWDataSetIterator(8, num_examples=20,
                                                flatten=True),
                 lambda m: m.DigitsDataSetIterator(700),
                 lambda m: m.DigitsDataSetIterator(64, train=False),
                 lambda m: m.RealPatchesDataSetIterator(800, raw_uint8=True),
                 lambda m: m.RealPatchesDataSetIterator(64, train=False)):
        _same_batches(make(jf), make(tf))


def test_data_dir_is_read_from_the_environment_at_import(tmp_path):
    code = ("from deeplearning4j_tpu_torch.datasets import fetchers; "
            "print(fetchers.DATA_DIR)")
    env = dict(os.environ, PYTHONPATH=str(REPO),
               DL4J_TPU_DATA_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(REPO),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)


def test_hdf5_minibatch_iterator_reads_both_layouts(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    sliced = tmp_path / "sliced.h5"
    with h5py.File(sliced, "w") as f:
        f["features"] = rng.standard_normal((23, 5)).astype(np.float64)
        f["labels"] = np.eye(3)[rng.integers(0, 3, 23)]
    per_batch = tmp_path / "per_batch.h5"
    with h5py.File(per_batch, "w") as f:
        for i in (0, 1, 2, 10):
            f[f"features_{i}"] = rng.standard_normal((4 + i, 6))
            if i != 2:
                f[f"labels_{i}"] = rng.integers(0, 2, (4 + i, 1))
    _same_batches(jh.HDF5MiniBatchDataSetIterator(sliced, batch_size=8),
                  th.HDF5MiniBatchDataSetIterator(sliced, batch_size=8))
    j = jh.HDF5MiniBatchDataSetIterator(per_batch)
    t = th.HDF5MiniBatchDataSetIterator(per_batch)
    _same_batches(j, t)
    assert len(_batches(t)) == 4
    t.reset()
    while t.has_next():
        t.next()
    with pytest.raises(StopIteration):
        t.next()
    empty = tmp_path / "empty.h5"
    with h5py.File(empty, "w") as f:
        f["other"] = np.zeros(3)
    with pytest.raises(ValueError, match="features"):
        th.HDF5MiniBatchDataSetIterator(empty)
