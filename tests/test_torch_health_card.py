"""The training loop's guard and `evaluate` on the card, held to the
port's plain path on the CPU (the JAX package does not run on the card,
so this file does not import it). Both tests skip without a CUDA device;
run them there with `python -m pytest -m gpu tests/test_torch_*.py`.

- A guarded step on a NaN batch launches the LSTM kernels, applies no
  update (parameters and RMSPROP state bit-identical to before it) and
  still advances the iteration; the next, finite step is bit-identical
  to an unguarded step of a clone from the same state.
- `evaluate` of an f32 char-RNN (TF32 off) on the card against the same
  network on the CPU: the predictions may differ only where the CPU's
  top-two probability margin is under `MARGIN_TOL` (the f32 kernels'
  split-TF32 products agree with the plain version to about 1e-6 of a
  row's magnitude); the count of such positions is printed.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import lstm as L
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from deeplearning4j_tpu_torch.optimize.health import HealthSentinel

V, H, B, T = 32, 256, 64, 16
MARGIN_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs (several xdist
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _conf():
    return (C.NeuralNetConfiguration.Builder().seed(3).learning_rate(0.01)
            .updater("rmsprop").list()
            .layer(C.GravesLSTM(n_in=V, n_out=H, activation=Activation.TANH))
            .layer(C.RnnOutputLayer(n_out=V, loss=LossFunction.MCXENT,
                                    activation=Activation.SOFTMAX))
            .set_input_type(C.InputType.recurrent(V)).build())


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, V, (B, T + 1))
    return DataSet(np.eye(V, dtype=np.float32)[ids[:, :-1]],
                   ids[:, 1:].astype(np.int32))


def _state(net):
    return ([v for p in net._params for v in p.values()]
            + [t for u in net.get_updater_state() for st in u.values()
               for t in st.values()])


@pytest.mark.gpu
def test_guarded_step_skips_and_commits_on_the_card():
    _card()
    net = MultiLayerNetwork(_conf(), compute_dtype=torch.bfloat16)
    net.init()
    sentinel = HealthSentinel()
    net.set_health_sentinel(sentinel)
    net.fit(_batch(1))
    bad = _batch(2)
    bad.features[3, 5, 7] = np.nan
    before = [t.clone() for t in _state(net)]
    L.reset_counts()
    net.fit(bad)
    torch.cuda.synchronize()
    assert L.launches == {("fwd", False, False): 1, ("bwd", False, False): 1}
    assert (L.lstm_fwd_plain.calls, L.lstm_bwd_plain.calls) == (0, 0)
    assert all(torch.equal(a, b) for a, b in zip(before, _state(net)))
    assert net.iteration == 2 and sentinel.counters()["skips"] == 1
    assert not np.isfinite(net.score_value)
    ref = net.clone()
    ok = _batch(3)
    ref.fit(ok)
    net.fit(ok)
    assert all(torch.equal(a, b) for a, b in zip(_state(ref), _state(net)))
    assert net.iteration == 3 and sentinel.counters()["skips"] == 1


@pytest.mark.gpu
def test_evaluate_on_the_card_matches_the_cpu():
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = MultiLayerNetwork(_conf(), device="cpu")
    cpu.init()
    card = MultiLayerNetwork(_conf())
    card.init()
    card.set_params(cpu.params())
    data = [_batch(10 + i) for i in range(2)]
    L.reset_counts()
    ev_card = card.evaluate(ListDataSetIterator(data))
    assert L.launches_by_route == {("fwd", "tf32 clusters"): 2}
    ev_cpu = cpu.evaluate(ListDataSetIterator(data))
    differ, margins = 0, []
    for ds in data:
        p_cpu = cpu.output(ds.features).numpy()
        p_card = card.output(ds.features).cpu().numpy()
        top2 = np.sort(p_cpu, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        moved = p_cpu.argmax(-1) != p_card.argmax(-1)
        differ += int(moved.sum())
        margins += margin[moved].tolist()
    print(f"evaluate card vs CPU: {differ} of {2 * B * T} predictions "
          f"differ, top-two margins there {margins}")
    assert all(m < MARGIN_TOL for m in margins), margins
    diff = np.abs(ev_card.confusion_matrix - ev_cpu.confusion_matrix).sum()
    assert diff <= 2 * differ
    assert ev_card.confusion_matrix.sum() == 2 * B * T
