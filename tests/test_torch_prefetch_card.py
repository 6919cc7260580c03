"""`parallel.device_prefetch.DevicePrefetchIterator` on the card (the
JAX package does not run there, so this file does not import it). The
tests skip without a CUDA device; run them there with
`python -m pytest -m gpu tests/test_torch_*.py`.

Every batch arrives on the card bit-identical to its host batch, with
the (min, max) of its integer labels taken on the host, also when the
copy stream lags the host (GPU sleeps queued on it before each copy): a
pinned staging buffer is never refilled before its copy has completed.
A network trained through the prefetcher equals one trained from the
host batches bit for bit.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.device_prefetch import (
    DevicePrefetchIterator,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs (several xdist
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _batches(n=8, B=64, F=4096, seed=1):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(B, F)).astype(np.float32),
                    rng.integers(0, 9, (B,)).astype(np.int32))
            for _ in range(n)]


class _Lagging(ListDataSetIterator):
    """Queues a GPU sleep on the prefetcher's copy stream before each
    batch is staged."""

    it = None

    def next(self):
        with torch.cuda.stream(self.it.copy_stream):
            torch.cuda._sleep(20_000_000)  # ~10 ms before the next copy
        return super().next()


@pytest.mark.gpu
def test_staged_batches_equal_host_batches_behind_a_lagging_copy(card):
    batches = _batches()
    lag = _Lagging(batches)
    it = DevicePrefetchIterator(lag, depth=2)
    lag.it = it
    got = [(ds.features.clone(), ds.labels.clone(),
            ds._value_ranges["labels"]) for ds in it]
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for (f, l, r), b in zip(got, batches):
        assert f.device.type == "cuda"
        assert torch.equal(f.cpu(), torch.from_numpy(b.features))
        assert torch.equal(l.cpu(), torch.from_numpy(b.labels))
        assert r == (int(b.labels.min()), int(b.labels.max()))
    assert it.staged == 2 * len(batches)


@pytest.mark.gpu
def test_training_through_the_prefetcher_equals_host_batches(card):
    conf = (C.NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .list().layer(C.DenseLayer(n_in=4096, n_out=32,
                                       activation="tanh"))
            .layer(C.OutputLayer(n_in=32, n_out=9, activation="softmax",
                                 loss="mcxent")).build())
    a = MultiLayerNetwork(conf, device="cuda")
    a.init()
    b = a.clone()
    batches = _batches(seed=2)
    a.fit(ListDataSetIterator(batches))
    b.fit(DevicePrefetchIterator(ListDataSetIterator(batches), depth=3))
    assert torch.equal(a.params(), b.params())
