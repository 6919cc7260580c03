"""Benchmark dataset iterators: MNIST / CIFAR / Iris.

Reference: `deeplearning4j-core/.../datasets/fetchers/MnistDataFetcher.java:40`
(downloads + gunzips idx files, cached under ~/.deeplearning4j), iterators in
`datasets/iterator/impl/` (`MnistDataSetIterator`, `CifarDataSetIterator`,
`IrisDataSetIterator`).

This build runs in a zero-egress environment, so each fetcher first looks
for cached real data under `DL4J_TPU_DATA_DIR` (idx/npz files laid out like
the reference's cache) and otherwise generates a DETERMINISTIC synthetic
stand-in with the same shapes/classes — structured enough (glyph renderings,
class-conditional statistics) that training curves and accuracy targets
remain meaningful.

Counterpart of `deeplearning4j_tpu/datasets/fetchers.py`:
host code, a copy of the JAX package's with the port's imports; it gives
the same results.
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

DATA_DIR = Path(os.environ.get("DL4J_TPU_DATA_DIR", "~/.deeplearning4j_tpu")).expanduser()

# 7x5 digit glyphs used to synthesize MNIST-like images
_DIGIT_GLYPHS = [
    ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],  # 0
    ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],  # 1
    ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],  # 2
    ["01110", "10001", "00001", "00110", "00001", "10001", "01110"],  # 3
    ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],  # 4
    ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],  # 5
    ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],  # 6
    ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],  # 7
    ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],  # 8
    ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],  # 9
]


def _read_idx_images(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad idx magic {magic}"
        return np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad idx magic {magic}"
        return np.frombuffer(f.read(), np.uint8)


def _synthetic_mnist(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-like data: upscaled glyphs + jitter + noise."""
    rng = np.random.default_rng(seed)
    glyphs = np.zeros((10, 28, 28), np.float32)
    for d, rows in enumerate(_DIGIT_GLYPHS):
        bitmap = np.asarray([[int(c) for c in row] for row in rows], np.float32)
        up = np.kron(bitmap, np.ones((3, 3), np.float32))  # 21x15
        glyphs[d, 3:24, 6:21] = up
    labels = rng.integers(0, 10, n)
    imgs = np.zeros((n, 28, 28), np.float32)
    dx = rng.integers(-3, 4, n)
    dy = rng.integers(-3, 4, n)
    for i in range(n):
        g = np.roll(np.roll(glyphs[labels[i]], dy[i], axis=0), dx[i], axis=1)
        imgs[i] = g
    imgs = np.clip(imgs * rng.uniform(0.7, 1.0, (n, 1, 1)).astype(np.float32)
                   + 0.1 * rng.standard_normal((n, 28, 28)).astype(np.float32), 0, 1)
    return imgs.reshape(n, 784), np.eye(10, dtype=np.float32)[labels]


class MnistDataSetIterator(DataSetIterator):
    """MNIST iterator (reference `MnistDataSetIterator.java`): features are
    flattened 784-vectors in [0,1] (InputType.convolutional_flat(28,28,1)),
    labels one-hot 10."""

    def __init__(self, batch_size: int, num_examples: int = 60000,
                 train: bool = True, seed: int = 6, raw_uint8: bool = False):
        """`raw_uint8=True` yields unscaled uint8 pixels (0-255): 4x fewer
        bytes over the host link; pair with
        `net.set_normalizer(ImagePreProcessingScaler())` so the /255 scale
        runs on the device, inside the training step."""
        self.batch_size = batch_size
        self.train = train
        self.raw_uint8 = raw_uint8
        base = DATA_DIR / "mnist"
        img = base / ("train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte")
        lab = base / ("train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte")
        for suffix in ("", ".gz"):
            ip, lp = Path(str(img) + suffix), Path(str(lab) + suffix)
            if ip.exists() and lp.exists():
                images = _read_idx_images(ip)
                images = (images if raw_uint8
                          else images.astype(np.float32) / 255.0)
                labels = np.eye(10, dtype=np.float32)[_read_idx_labels(lp)]
                n = min(num_examples, len(images))
                self.features = images[:n].reshape(n, 784)
                self.labels = labels[:n]
                break
        else:
            n = min(num_examples, 60000 if train else 10000)
            self.features, self.labels = _synthetic_mnist(
                n, seed if train else seed + 10_000)
            if raw_uint8:
                self.features = np.clip(self.features * 255.0, 0, 255).astype(
                    np.uint8)
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.features)

    def next(self):
        lo = self._pos
        hi = min(lo + self.batch_size, len(self.features))
        self._pos = hi
        return DataSet(self.features[lo:hi], self.labels[lo:hi])

    def reset(self):
        self._pos = 0

    def batch(self):
        return self.batch_size


class IrisDataSetIterator(DataSetIterator):
    """Iris-shaped iterator (reference `IrisDataSetIterator.java`): 4
    features, 3 classes, 150 examples. Synthetic class-conditional Gaussians
    with Iris-like statistics when the CSV cache is absent."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150, seed: int = 6):
        self.batch_size = batch_size
        csv = DATA_DIR / "iris" / "iris.data"
        if csv.exists():
            rows = [l.strip().split(",") for l in csv.read_text().splitlines() if l.strip()]
            X = np.asarray([[float(v) for v in r[:4]] for r in rows], np.float32)
            names = sorted({r[4] for r in rows})
            y = np.asarray([names.index(r[4]) for r in rows])
        else:
            rng = np.random.default_rng(seed)
            means = np.asarray([[5.0, 3.4, 1.5, 0.2],
                                [5.9, 2.8, 4.3, 1.3],
                                [6.6, 3.0, 5.6, 2.0]], np.float32)
            stds = np.asarray([[0.35, 0.38, 0.17, 0.10],
                               [0.52, 0.31, 0.47, 0.20],
                               [0.64, 0.32, 0.55, 0.27]], np.float32)
            per = num_examples // 3
            X = np.concatenate([means[c] + stds[c] * rng.standard_normal((per, 4))
                                for c in range(3)]).astype(np.float32)
            y = np.repeat(np.arange(3), per)
        labels = np.eye(3, dtype=np.float32)[y]
        idx = np.random.default_rng(seed).permutation(len(X))
        self.features, self.labels = X[idx][:num_examples], labels[idx][:num_examples]
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.features)

    def next(self):
        lo = self._pos
        hi = min(lo + self.batch_size, len(self.features))
        self._pos = hi
        return DataSet(self.features[lo:hi], self.labels[lo:hi])

    def reset(self):
        self._pos = 0

    def batch(self):
        return self.batch_size


class CifarDataSetIterator(DataSetIterator):
    """CIFAR-10-shaped iterator (reference `CifarDataSetIterator.java`):
    32x32x3 images (NHWC, flattened optional), 10 classes. Synthetic
    class-conditional textures when the binary cache is absent."""

    def __init__(self, batch_size: int, num_examples: int = 50000,
                 train: bool = True, seed: int = 6, flatten: bool = False):
        self.batch_size = batch_size
        self.flatten = flatten
        npz = DATA_DIR / "cifar10" / ("train.npz" if train else "test.npz")
        if npz.exists():
            d = np.load(npz)
            imgs = d["images"].astype(np.float32) / 255.0
            y = d["labels"]
            n = min(num_examples, len(imgs))
            imgs, y = imgs[:n], y[:n]
        else:
            n = min(num_examples, 50000 if train else 10000)
            rng = np.random.default_rng(seed if train else seed + 1)
            y = rng.integers(0, 10, n)
            # class-conditional color + frequency texture
            base_colors = rng.uniform(0.2, 0.8, (10, 3)).astype(np.float32)
            freqs = np.arange(1, 11, dtype=np.float32)
            xx, yy = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32))
            imgs = np.empty((n, 32, 32, 3), np.float32)
            phases = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
            for i in range(n):
                c = y[i]
                tex = 0.5 + 0.5 * np.sin(2 * np.pi * freqs[c] * (xx + yy) + phases[i])
                imgs[i] = base_colors[c] * tex[..., None]
            imgs += 0.05 * rng.standard_normal(imgs.shape).astype(np.float32)
            imgs = np.clip(imgs, 0, 1)
        self.features = imgs.reshape(n, -1) if flatten else imgs
        self.labels = np.eye(10, dtype=np.float32)[y]
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.features)

    def next(self):
        lo = self._pos
        hi = min(lo + self.batch_size, len(self.features))
        self._pos = hi
        return DataSet(self.features[lo:hi], self.labels[lo:hi])

    def reset(self):
        self._pos = 0

    def batch(self):
        return self.batch_size


class LFWDataSetIterator(DataSetIterator):
    """LFW-shaped iterator (reference `LFWDataSetIterator.java`: Labeled
    Faces in the Wild — face images labeled by identity). Reads a cached
    `lfw/data.npz` (images uint8 NHWC + integer labels) when present;
    otherwise generates deterministic synthetic faces (per-identity facial
    geometry + lighting/pose jitter) — the zero-egress stand-in pattern all
    fetchers here share."""

    def __init__(self, batch_size: int, num_examples: int = 1000,
                 image_shape: Tuple[int, int, int] = (40, 40, 3),
                 num_labels: int = 10, seed: int = 6, flatten: bool = False):
        self.batch_size = batch_size
        self.flatten = flatten
        H, W, C = image_shape
        npz = DATA_DIR / "lfw" / "data.npz"
        if npz.exists():
            d = np.load(npz)
            imgs = d["images"].astype(np.float32) / 255.0
            y = d["labels"].astype(np.int64)
            num_labels = int(y.max()) + 1
            n = min(num_examples, len(imgs))
            imgs, y = imgs[:n], y[:n]
        else:
            n = num_examples
            rng = np.random.default_rng(seed)
            y = rng.integers(0, num_labels, n)
            # per-identity facial geometry (stable across examples)
            id_rng = np.random.default_rng(seed + 1)
            face_w = id_rng.uniform(0.55, 0.8, num_labels)
            face_h = id_rng.uniform(0.6, 0.85, num_labels)
            eye_dx = id_rng.uniform(0.12, 0.22, num_labels)
            eye_y = id_rng.uniform(0.35, 0.45, num_labels)
            mouth_y = id_rng.uniform(0.65, 0.75, num_labels)
            skin = id_rng.uniform(0.4, 0.9, (num_labels, C))
            xs, ys = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H))
            imgs = np.empty((n, H, W, C), np.float32)
            jx = rng.uniform(-0.08, 0.08, n)
            jy = rng.uniform(-0.08, 0.08, n)
            light = rng.uniform(0.75, 1.1, n)
            for i in range(n):
                c = y[i]
                ex, ey = xs - jx[i], ys - jy[i]
                face = ((ex / face_w[c]) ** 2 + (ey / face_h[c]) ** 2) < 1.0
                img = np.full((H, W), 0.08, np.float32)
                img[face] = 0.75
                for sx in (-1, 1):  # eyes
                    eye = ((ex - sx * eye_dx[c] * 2) ** 2
                           + (ey + (1 - 2 * eye_y[c])) ** 2) < 0.015
                    img[eye] = 0.1
                mouth = (np.abs(ey - (2 * mouth_y[c] - 1)) < 0.05) & (np.abs(ex) < 0.25)
                img[mouth] = 0.25
                imgs[i] = (img[..., None] * skin[c] * light[i])
            imgs = np.clip(imgs + 0.04 * rng.standard_normal(imgs.shape), 0, 1
                           ).astype(np.float32)
        self.num_labels = num_labels
        self.features = imgs.reshape(len(imgs), -1) if flatten else imgs
        self.labels = np.eye(num_labels, dtype=np.float32)[y]
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.features)

    def next(self):
        lo = self._pos
        hi = min(lo + self.batch_size, len(self.features))
        self._pos = hi
        return DataSet(self.features[lo:hi], self.labels[lo:hi])

    def reset(self):
        self._pos = 0

    def batch(self):
        return self.batch_size


class CurvesDataSetIterator(DataSetIterator):
    """Curves dataset iterator (reference `CurvesDataSetFetcher` /
    `deeplearning4j-core` curves resource: 784-dim synthetic curve images
    used by the deep-autoencoder pretraining examples). Generated here as
    smooth random Bezier-like strokes rasterized onto a 28x28 grid —
    unsupervised (labels == features, the autoencoder target convention)."""

    def __init__(self, batch_size: int, num_examples: int = 10000,
                 seed: int = 6):
        self.batch_size = batch_size
        rng = np.random.default_rng(seed)
        n = num_examples
        imgs = np.zeros((n, 28, 28), np.float32)
        t = np.linspace(0, 1, 64)
        for i in range(n):
            # quadratic Bezier with 3 random control points
            p = rng.uniform(3, 25, (3, 2))
            pts = ((1 - t)[:, None] ** 2 * p[0] +
                   2 * ((1 - t) * t)[:, None] * p[1] +
                   (t ** 2)[:, None] * p[2])
            xi = np.clip(pts[:, 0].astype(int), 0, 27)
            yi = np.clip(pts[:, 1].astype(int), 0, 27)
            imgs[i, yi, xi] = 1.0
        # slight blur (box) to make strokes smooth
        padded = np.pad(imgs, ((0, 0), (1, 1), (1, 1)))
        imgs = sum(padded[:, dy:dy + 28, dx:dx + 28]
                   for dy in range(3) for dx in range(3)) / 9.0
        self.features = np.clip(imgs, 0, 1).reshape(n, 784)
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.features)

    def next(self):
        lo = self._pos
        hi = min(lo + self.batch_size, len(self.features))
        self._pos = hi
        f = self.features[lo:hi]
        return DataSet(f, f.copy())  # autoencoder convention: target = input

    def reset(self):
        self._pos = 0

    def batch(self):
        return self.batch_size


class DigitsDataSetIterator(DataSetIterator):
    """REAL handwritten-digit pixels: the UCI optical-digits set (1,797
    8x8 grayscale images, 10 classes) committed to the repo as
    `tests/fixtures/digits_real.npz` — the zero-egress stand-in for the
    reference's downloaded-MNIST accuracy proof
    (`MnistDataFetcher.java:40`). Unlike the synthetic MNIST fallback,
    accuracy on this iterator is accuracy on real pixels.

    `train=True` yields the first 1,500 examples (pre-shuffled at export
    time), `train=False` the held-out 297."""

    _TRAIN = 1500

    def __init__(self, batch_size: int, train: bool = True,
                 one_hot: bool = True):
        # package data (works installed); DL4J_TPU_DATA_DIR overrides
        # like every other fetcher in this module
        cached = DATA_DIR / "digits_real.npz"
        p = cached if cached.exists() else (
            Path(__file__).resolve().parent / "data" / "digits_real.npz")
        data = np.load(p)
        X = data["images"].astype(np.float32) / 16.0   # 0..16 -> 0..1
        y = data["labels"].astype(np.int64)
        if train:
            X, y = X[:self._TRAIN], y[:self._TRAIN]
        else:
            X, y = X[self._TRAIN:], y[self._TRAIN:]
        self._X = X.reshape(len(X), 8, 8, 1)  # NHWC (the conv layout)
        self._y = (np.eye(10, dtype=np.float32)[y] if one_hot
                   else y.astype(np.int32))
        self.batch_size = batch_size
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._X)

    def next(self):
        lo, hi = self._pos, min(self._pos + self.batch_size, len(self._X))
        self._pos = hi
        return DataSet(self._X[lo:hi], self._y[lo:hi])

    def reset(self):
        self._pos = 0

    def batch(self):
        return self.batch_size

    def num_examples(self):
        return len(self._X)


class RealPatchesDataSetIterator(DataSetIterator):
    """REAL natural-image pixels at CIFAR geometry (32x32x3 uint8): 1,950
    patches cut stride-16 from the two real photographs that ship inside
    scikit-learn (`sklearn.datasets.load_sample_images`: china.jpg /
    flower.jpg), committed as `datasets/data/real_patches32.npz`,
    pre-shuffled at export, 2 balanced classes (source photograph).

    Role: the zero-egress stand-in for a real-CIFAR convergence fixture
    (reference `CifarDataSetIterator.java` downloads the archive; this
    environment has no egress, so the synthetic `CifarDataSetIterator`
    above covers throughput and THIS iterator covers learning on real
    pixels — a conv net must learn actual color/texture statistics to
    separate the classes). `train=True`: first 1,560 patches;
    `train=False`: the held-out 390."""

    _TRAIN = 1560

    def __init__(self, batch_size: int, train: bool = True,
                 one_hot: bool = True, raw_uint8: bool = False):
        cached = DATA_DIR / "real_patches32.npz"
        p = cached if cached.exists() else (
            Path(__file__).resolve().parent / "data" / "real_patches32.npz")
        data = np.load(p)
        X = data["images"]
        y = data["labels"].astype(np.int64)
        if train:
            X, y = X[:self._TRAIN], y[:self._TRAIN]
        else:
            X, y = X[self._TRAIN:], y[self._TRAIN:]
        # raw uint8 stages 4x fewer bytes; pair with ImagePreProcessingScaler
        self._X = X if raw_uint8 else X.astype(np.float32) / 255.0
        self._y = (np.eye(2, dtype=np.float32)[y] if one_hot
                   else y.astype(np.int32))
        self.batch_size = batch_size
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._X)

    def next(self):
        lo, hi = self._pos, min(self._pos + self.batch_size, len(self._X))
        self._pos = hi
        return DataSet(self._X[lo:hi], self._y[lo:hi])

    def reset(self):
        self._pos = 0

    def batch(self):
        return self.batch_size

    def num_examples(self):
        return len(self._X)
