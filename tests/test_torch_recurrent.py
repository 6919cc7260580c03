"""The port's recurrent path held against the JAX package on the CPU.

A char-RNN (`GravesLSTM` -> `GravesLSTM` -> `RnnOutputLayer(MCXENT,
softmax)`, RMSPROP lr 0.1, the shape of `bench.py`'s `lstm` benchmark at
vocab 16, H=32, B=4, T=10) starts from the JAX network's weights and
optimizer state (`params_from_jax`, `updater_state_from_jax`); inputs are
made with numpy from a seed. On the CPU the port's fused LSTM runs the
kernels' plain versions; the JAX package runs its `lax.scan` path.

Tolerances (f32): outputs 1e-5 absolute (softmax probabilities); losses
rtol 1e-5; parameters rtol 1e-5 + atol 1e-4 (lr / 1000) after RMSPROP
steps. RMSPROP normalizes each element's step, lr * g / sqrt(E[g^2]): the
first one is about 4.5 * lr * sign(g) whatever g's size, so an element
whose gradient nearly cancels carries that gradient's relative rounding
error (the two packages sum in different orders) into a step of ~0.45,
and the next steps' losses move with it. Measured: parameters up to
1.2e-5 apart after 3 steps and 6.7e-5 after the bidirectional net's 2,
losses up to 2.4e-6 relative after 6 tBPTT windows.
"""
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.datasets.normalizers import (  # noqa: E402
    OneHotEncoder as JOneHot,
)
from deeplearning4j_tpu.nn import conf as jconf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.nn.updater import Updater as JUpdater  # noqa: E402
from deeplearning4j_tpu.ops.activations import (  # noqa: E402
    Activation as JAct,
)
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss  # noqa: E402
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.normalizers import (  # noqa: E402
    DataNormalization,
    OneHotEncoder,
)
from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import recurrent  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import lstm as plstm  # noqa: E402
from deeplearning4j_tpu_torch.ops.activations import Activation  # noqa: E402
from deeplearning4j_tpu_torch.ops.losses import LossFunction  # noqa: E402
from deeplearning4j_tpu_torch.util import serialization as pser  # noqa: E402


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


V, H, B, T = 16, 32, 4, 10


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_conf(tbptt=0, bidirectional=False, vocab=V, hidden=H, seed=1):
    first = jconf.GravesBidirectionalLSTM if bidirectional \
        else jconf.GravesLSTM
    b = (jconf.NeuralNetConfiguration.Builder()
         .seed(seed).learning_rate(0.1).updater(JUpdater.RMSPROP)
         .list()
         .layer(first(n_in=vocab, n_out=hidden, activation=JAct.TANH))
         .layer(jconf.GravesLSTM(n_out=hidden, activation=JAct.TANH))
         .layer(jconf.RnnOutputLayer(n_out=vocab, loss=JLoss.MCXENT,
                                     activation=JAct.SOFTMAX))
         .set_input_type(jconf.InputType.recurrent(vocab)))
    if tbptt:
        b = b.t_bptt_forward_length(tbptt)
    return b.build()


def _pair(**kw):
    """A JAX network and the port's network (CPU) carrying its weights
    and optimizer state, the port's configuration parsed from the JAX
    package's JSON."""
    jnet = JaxNet(_jax_conf(**kw))
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(pser.params_from_jax(pnet.conf,
                                             _np_tree(jnet._params)))
    pnet.set_updater_state(pser.updater_state_from_jax(
        pnet.conf, _np_tree(jnet._upd_state)))
    return jnet, pnet


def _ids(n, seed, vocab=V, b=B, t=T):
    return np.random.default_rng(seed).integers(0, vocab, (n, b, t + 1))


def _one_hot_batches(n, seed=0, t=T):
    ids = _ids(n, seed, t=t)
    eye = np.eye(V, dtype=np.float32)
    return [(eye[ids[i, :, :-1]], ids[i, :, 1:].astype(np.int32))
            for i in range(n)]


def _params_close(jnet, pnet, rtol=1e-5, atol=1e-4):
    for i, (a, b) in enumerate(zip(jnet._params, pnet._params)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"layer {i} {k}")


class _Scores:
    """Listener recording the score after every iteration (every tBPTT
    window)."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, net, it):
        self.scores.append(float(net.score_value))


def test_configuration_json_round_trips_both_ways():
    jc = _jax_conf(tbptt=4)
    pc = MultiLayerConfiguration.from_json(jc.to_json())
    assert isinstance(pc.layers[0], pconf.GravesLSTM)
    assert pc.layers[1].n_in == H and pc.tbptt_fwd_length == 4
    assert pc.to_json() == jc.to_json()
    built = (pconf.NeuralNetConfiguration.Builder()
             .seed(3).learning_rate(0.1).updater("rmsprop").list()
             .layer(pconf.GravesBidirectionalLSTM(
                 n_in=V, n_out=H, activation=Activation.TANH,
                 forget_gate_bias_init=2.0))
             .layer(pconf.RnnOutputLayer(n_out=V, loss=LossFunction.MCXENT,
                                         activation=Activation.SOFTMAX))
             .set_input_type(pconf.InputType.recurrent(V))
             .build())
    back = type(jc).from_json(built.to_json())
    assert isinstance(back.layers[0], jconf.GravesBidirectionalLSTM)
    assert back.to_json() == built.to_json()


def test_output_matches_jax():
    jnet, pnet = _pair()
    x, _ = _one_hot_batches(1, seed=3)[0]
    recurrent.lstm_forward.routes.update(fused=0, loop=0)
    got = pnet.output(x)
    assert recurrent.lstm_forward.routes == {"fused": 2, "loop": 0}
    assert got.shape == (B, T, V)
    np.testing.assert_allclose(got.numpy(), jnet.output(x), atol=1e-5)


def test_fit_rmsprop_matches_jax():
    jnet, pnet = _pair()
    plstm.reset_counts()
    jl, pl = [], []
    for x, y in _one_hot_batches(3):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        jl.append(jnet.score_value)
        pl.append(pnet.score_value)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _params_close(jnet, pnet)
    # two LSTM layers, one plain forward and backward each per step
    assert plstm.lstm_fwd_plain.calls == 6
    assert plstm.lstm_bwd_plain.calls == 6
    for a, b in zip(jnet._upd_state, pnet.get_updater_state()):
        for k in a:
            for sk in a[k]:
                np.testing.assert_allclose(b[k][sk].numpy(),
                                           np.asarray(a[k][sk]), rtol=1e-5,
                                           atol=1e-7)


def test_tbptt_with_padded_tail_window_matches_jax():
    """T=10 in windows of 4: 4, 4 and a tail of 2 padded to 4 and masked
    (the masked kernels' plain versions); per-window losses, the mean
    score and the params; the persistent state slots are restored."""
    jnet, pnet = _pair(tbptt=4)
    js, ps = _Scores(), _Scores()
    jnet.set_listeners(js)
    pnet.set_listeners(ps)
    plstm.reset_counts()
    for n, (x, y) in enumerate(_one_hot_batches(2, seed=5)):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   rtol=1e-5)
        if n == 0:
            # 6 sign-like RMSPROP steps amplify rounding chaotically
            # (5.3e-5 after 3 windows, 9.9e-4 after 6, while one fit from
            # synchronized state stays within 1.4e-5): params after 3
            _params_close(jnet, pnet)
    assert len(ps.scores) == 6 and pnet.iteration == 6
    np.testing.assert_allclose(ps.scores, js.scores, rtol=1e-5)
    assert pnet._layer_state == [{}, {}, {}]
    # per fit: 3 windows x 2 layers forward passes, one window masked
    assert plstm.lstm_fwd_plain.calls == 12
    assert plstm.lstm_bwd_plain.calls == 12


def test_path_4s_shape_from_a_shared_zip_matches_jax(tmp_path):
    """Main path 4s narrowed (lstm_large fed GravesLSTMCharModellingExample
    mini-batches: two GravesLSTM, RMSPROP lr 0.1, tBPTT 50, one-hot rows):
    here vocab 32, H=64, B=4, T=100, so one fit is two full windows. The
    port's network is restored from the JAX network's checkpoint zip;
    the params after the first window (taken by a listener) atol lr /
    1000, the losses of both windows and the final score rtol 1e-5; the
    fused LSTM's plain versions run 2 windows x 2 layers, unmasked. Only
    the first window's params are compared: a window of 50 steps sums
    gradients long enough that the second window's sign-like RMSPROP
    steps can move a few elements apart by more than lr / 1000 (the
    RMSPROP caveat of this module's docstring)."""
    Vn, Hn, Bn, Tn, W = 32, 64, 4, 100, 50

    class Snap(_Scores):
        def __init__(self):
            super().__init__()
            self.params = []

        def iteration_done(self, net, it):
            super().iteration_done(net, it)
            self.params.append([{k: np.array(v) for k, v in p.items()}
                                for p in net._params])

    jnet = JaxNet(_jax_conf(tbptt=W, vocab=Vn, hidden=Hn))
    jnet.init()
    path = str(tmp_path / "jax.zip")
    jser.write_model(jnet, path)
    pnet = pser.restore_multi_layer_network(path, device="cpu")
    js, ps = Snap(), Snap()
    jnet.set_listeners(js)
    pnet.set_listeners(ps)
    ids = _ids(1, 23, vocab=Vn, b=Bn, t=Tn)[0]
    x = np.eye(Vn, dtype=np.float32)[ids[:, :-1]]
    y = ids[:, 1:].astype(np.int32)
    plstm.reset_counts()
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    assert len(ps.scores) == 2 and pnet.iteration == 2
    np.testing.assert_allclose(ps.scores, js.scores, rtol=1e-5)
    np.testing.assert_allclose(pnet.score_value, jnet.score_value, rtol=1e-5)
    for i, (a, b) in enumerate(zip(js.params[0], ps.params[0])):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-4,
                                       err_msg=f"layer {i} {k}")
    assert plstm.lstm_fwd_plain.calls == 4 and plstm.lstm_bwd_plain.calls == 4


def test_tbptt_needs_per_timestep_labels():
    _, pnet = _pair(tbptt=4)
    x, y = _one_hot_batches(1)[0]
    with pytest.raises(ValueError, match="per-timestep labels"):
        pnet.fit(DataSet(x, y[:, 0]))
    assert pnet._layer_state == [{}, {}, {}]


def test_masked_dataset_matches_jax():
    """Ragged lengths (a row never masked, a row cut at 1, a hole)."""
    jnet, pnet = _pair()
    mask = (np.arange(T)[None] < np.array([[T], [1], [6], [9]])).astype(
        np.float32)
    mask[0, 4] = 0.0
    for x, y in _one_hot_batches(2, seed=7):
        jnet.fit(JDataSet(x, y, mask, mask))
        pnet.fit(DataSet(x, y, mask, mask))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   rtol=1e-5)
    _params_close(jnet, pnet)


def test_bidirectional_matches_jax():
    jnet, pnet = _pair(bidirectional=True)
    x, _ = _one_hot_batches(1, seed=8)[0]
    np.testing.assert_allclose(pnet.output(x).numpy(), jnet.output(x),
                               atol=1e-5)
    for x, y in _one_hot_batches(2, seed=9):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   rtol=1e-5)
    _params_close(jnet, pnet)
    with pytest.raises(ValueError, match="bidirectional"):
        pnet.rnn_time_step(x[:, 0])


def test_rnn_time_step_matches_jax_and_output():
    jnet, pnet = _pair()
    x, _ = _one_hot_batches(1, seed=11)[0]
    full = pnet.output(x).numpy()
    steps = [pnet.rnn_time_step(x[:, t]).numpy() for t in range(4)]
    jsteps = [jnet.rnn_time_step(x[:, t]) for t in range(4)]
    np.testing.assert_allclose(np.stack(steps, 1), np.stack(jsteps, 1),
                               atol=1e-5)
    state = pnet.rnn_get_previous_state()
    assert state["__pos__"] == 4 and set(state) == {0, 1, "__pos__"}
    rest = pnet.rnn_time_step(x[:, 4:]).numpy()       # a multi-step call
    np.testing.assert_allclose(rest, jnet.rnn_time_step(x[:, 4:]), atol=1e-5)
    np.testing.assert_allclose(np.concatenate([np.stack(steps, 1), rest], 1),
                               full, atol=1e-5)
    # back to step 4 from the saved state: the same continuation
    pnet.rnn_set_previous_state(state)
    again = pnet.rnn_time_step(x[:, 4:]).numpy()
    np.testing.assert_allclose(again, rest, atol=0)
    pnet.rnn_clear_previous_state()
    assert pnet.rnn_get_previous_state() == {"__pos__": 0}
    np.testing.assert_allclose(pnet.rnn_time_step(x).numpy(), full,
                               atol=1e-5)


def test_one_hot_encoder_uint8_ids_match_jax():
    """bench.py's wire format: uint8 char ids expanded on the device,
    sparse int32 labels; output, fit, and the id range check."""
    jnet, pnet = _pair()
    jnet.set_normalizer(JOneHot(V))
    pnet.set_normalizer(OneHotEncoder(V))
    ids = _ids(2, seed=13)
    x0 = ids[0, :, :-1].astype(np.uint8)
    np.testing.assert_allclose(pnet.output(x0).numpy(), jnet.output(x0),
                               atol=1e-5)
    for i in range(2):
        x, y = ids[i, :, :-1].astype(np.uint8), ids[i, :, 1:].astype(np.int32)
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   rtol=1e-5)
    _params_close(jnet, pnet)
    steps = [pnet.rnn_time_step(x0[:, t]).numpy() for t in range(3)]
    jsteps = [jnet.rnn_time_step(x0[:, t]) for t in range(3)]
    np.testing.assert_allclose(np.stack(steps), np.stack(jsteps), atol=1e-5)
    bad = x0.copy()
    bad[1, 2] = V
    with pytest.raises(ValueError, match="out of range"):
        pnet.fit(DataSet(bad, ids[0, :, 1:].astype(np.int32)))


def test_only_id_normalizers_attach():
    """A normalizer attaches when its whole transform runs on the device
    (the statistics normalizers since queue A2, as in the JAX package);
    one without a device transform is refused."""
    _, pnet = _pair()

    class HostOnly(DataNormalization):
        pass

    class Standardize(DataNormalization):
        supports_device = True

    with pytest.raises(ValueError, match="no device-side transform"):
        pnet.set_normalizer(HostOnly())
    pnet.set_normalizer(Standardize())
    assert isinstance(pnet.get_normalizer(), Standardize)
    pnet.set_normalizer(None)
    assert OneHotEncoder().fit(DataSet(np.array([[3, 7]]))).n_classes == 8


def test_checkpoints_round_trip_both_ways(tmp_path):
    jnet, pnet = _pair()
    for x, y in _one_hot_batches(2, seed=17):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    path = str(tmp_path / "port.zip")
    pser.write_model(pnet, path, normalizer=OneHotEncoder(V))
    back = jser.restore_multi_layer_network(path)
    assert back.iteration == 2
    _params_close(back, pnet, rtol=0, atol=0)
    for a, b in zip(back._upd_state, pnet.get_updater_state()):
        for k in a:
            for sk in a[k]:
                np.testing.assert_array_equal(np.asarray(a[k][sk]),
                                              b[k][sk].numpy())
    assert jser.restore_normalizer(path).n_classes == V
    jpath = str(tmp_path / "jax.zip")
    jser.write_model(jnet, jpath, normalizer=JOneHot(V))
    mine = pser.restore_multi_layer_network(jpath, device="cpu")
    _params_close(jnet, mine, rtol=0, atol=0)
    assert pser.restore_normalizer(jpath).n_classes == V
    # both go on training the same way
    x, y = _one_hot_batches(1, seed=19)[0]
    jnet.fit(JDataSet(x, y))
    mine.fit(DataSet(x, y))
    np.testing.assert_allclose(mine.score_value, jnet.score_value, rtol=1e-5)
    assert pser.restore_normalizer(str(tmp_path / "port.zip")) is not None
    os.remove(path)


def test_weight_init_statistics():
    """Init draws differ between the packages (torch generators against
    threefry keys); the layout and the statistics agree, and the forget
    gate's bias is exactly `forget_gate_bias_init`."""
    conf = (pconf.NeuralNetConfiguration.Builder().seed(5).list()
            .layer(pconf.GravesLSTM(n_in=64, n_out=128,
                                    forget_gate_bias_init=1.5))
            .layer(pconf.RnnOutputLayer(n_out=64, loss=LossFunction.MCXENT,
                                        activation=Activation.SOFTMAX))
            .set_input_type(pconf.InputType.recurrent(64)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    jn = JaxNet(jconf.MultiLayerConfiguration.from_json(conf.to_json()))
    jn.init()
    p, q = net._params[0], jn._params[0]
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in q.items()}
    b = p["b"].numpy()
    assert (b[128:256] == 1.5).all() and (b[:128] == 0).all() \
        and (b[256:] == 0).all()
    for k in ("pI", "pF", "pO"):
        assert (p[k] == 0).all()
    for k in ("W", "RW"):
        s, js = float(p[k].std()), float(np.std(np.asarray(q[k])))
        assert abs(s - js) < 0.05 * js, (k, s, js)


def _wide_inputs(Hn, seed, Bn=2, Tn=3, NI=8):
    """One GravesLSTM layer's inputs at width Hn (pre-activations of order
    one: RW ~ N(0, 1/Hn)), nonzero h0, c0 and peepholes, a ragged mask."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    lens = Tn - np.arange(Bn) % Tn  # Tn, Tn - 1, ...: ragged rows
    mask = (np.arange(Tn)[None] < lens[:, None]).astype(np.float32)
    return dict(x=r(Bn, Tn, NI), W=r(NI, 4 * Hn, sc=0.3),
                RW=r(Hn, 4 * Hn, sc=Hn ** -0.5), b=r(4 * Hn, sc=0.1),
                peep=[r(Hn, sc=0.1) for _ in range(3)], h0=r(Bn, Hn, sc=0.5),
                c0=r(Bn, Hn, sc=0.5), mask=mask, dout=r(Bn, Tn, Hn))


_WIDE_ARGS = ("x", "W", "RW", "b", "pI", "pF", "pO", "h0", "c0")


def _wide_port(a, device="cpu", dtype=torch.float32):
    """The port's lstm_forward on `a`: (out, hT, cT) and the gradients of
    sum(out * dout) in every input, as numpy f32."""
    t = {k: torch.from_numpy(a[k]).to(device=device, dtype=dtype)
         .requires_grad_() for k in ("x", "W", "RW", "b", "h0", "c0")}
    for k, v in zip(("pI", "pF", "pO"), a["peep"]):
        t[k] = torch.from_numpy(v).to(device=device, dtype=dtype) \
            .requires_grad_()
    out, (hT, cT) = recurrent.lstm_forward(
        t["x"], t["W"], t["RW"], t["b"], (t["pI"], t["pF"], t["pO"]),
        torch.sigmoid, torch.tanh, t["h0"], t["c0"],
        torch.from_numpy(a["mask"]).to(device=device, dtype=dtype),
        gate_is_sigmoid=True, cell_is_tanh=True)
    (out * torch.from_numpy(a["dout"]).to(device=device, dtype=dtype)) \
        .sum().backward()
    f = lambda v: v.detach().float().cpu().numpy()
    return [f(out), f(hT), f(cT)], [f(t[k].grad) for k in _WIDE_ARGS]


@pytest.mark.parametrize("over", [0, 1])
def test_lstm_above_max_h_takes_the_step_loop(over):
    """Queue C1: a sigmoid/tanh layer wider than the fused kernels take
    (H = MAX_H + 1) runs the plain step loop, as the JAX package runs its
    `lax.scan` where `lstm_fused_or_none` returns None; H = MAX_H stays on
    the fused route. The route is chosen from the arguments (no launch, no
    raise) and counted. Forward and the gradients in every input against
    the JAX package's `lstm_forward` (f32, B=2, T=3, masked): out, hT, cT
    atol 1e-5; gradients rtol 1e-4 + atol 2e-5 (sums over ~2048 terms in
    another order)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.layers.recurrent import (
        lstm_forward as jlstm_forward,
    )

    Hn = plstm.MAX_H + over
    a = _wide_inputs(Hn, seed=20 + over)

    def jf(x, W, RW, b, pI, pF, pO, h0, c0):
        return jlstm_forward(x, W, RW, b, (pI, pF, pO), jax.nn.sigmoid,
                             jnp.tanh, h0, c0, jnp.asarray(a["mask"]),
                             gate_is_sigmoid=True, cell_is_tanh=True)

    args = [jnp.asarray(a[k]) for k in ("x", "W", "RW", "b")] \
        + [jnp.asarray(p) for p in a["peep"]] \
        + [jnp.asarray(a["h0"]), jnp.asarray(a["c0"])]
    jout, (jh, jc) = jf(*args)
    jgrads = jax.grad(lambda *z: jnp.sum(jf(*z)[0] * a["dout"]),
                      argnums=tuple(range(9)))(*args)
    recurrent.lstm_forward.routes.update(fused=0, loop=0)
    plstm.reset_counts()
    outs, grads = _wide_port(a)
    want = {"fused": 0, "loop": 1} if over else {"fused": 1, "loop": 0}
    assert recurrent.lstm_forward.routes == want
    assert plstm.lstm_fwd_plain.calls == (0 if over else 1)
    assert not plstm.launches
    for got, ref, n in zip(outs, (jout, jh, jc), ("out", "hT", "cT")):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5,
                                   err_msg=n)
    for got, ref, n in zip(grads, jgrads, _WIDE_ARGS):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                   atol=2e-5, err_msg=f"d{n}")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


# The step loop in bf16 rounds every operation's result to bf16 (the
# kernels round only what they store): at H=2304 its outputs and
# gradients lie up to 1.5 x 2^-6 of a row's scale from the f32 loop's (dRW,
# whose T terms are summed in bf16; 0.4-0.9 elsewhere), on the card and on
# the CPU alike. A bf16 loop is held to the f32 loop within twice
# `ops.lstm.TOLERANCE[bf16]`, 2^-5.
LOOP_BF16_UNITS = 2.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graves_lstm_above_max_h_on_the_card(dtype):
    """A GravesLSTM layer at H=2304 on the card takes the step loop (no
    kernel launch, no raise) and matches the f32 loop on the CPU: out, hT,
    cT and every gradient held row by row with
    `ops.lstm.error_in_tolerances`, f32 within 1e-4, bf16 within
    LOOP_BF16_UNITS (the CPU's own bf16 loop is held to the same)."""
    _card()
    dt = getattr(torch, dtype)
    a = _wide_inputs(2304, seed=31, Bn=4, Tn=3, NI=16)
    ref = _wide_port(a, "cpu", torch.float32)
    bound = 1.0 if dt == torch.float32 else LOOP_BF16_UNITS
    for dev in ("cuda", "cpu"):
        recurrent.lstm_forward.routes.update(fused=0, loop=0)
        plstm.reset_counts()
        got = _wide_port(a, dev, dt)
        assert recurrent.lstm_forward.routes == {"fused": 0, "loop": 1}
        assert not plstm.launches and plstm.lstm_fwd_plain.calls == 0
        for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
            assert plstm.error_in_tolerances(torch.from_numpy(g),
                                             torch.from_numpy(r),
                                             dt) <= bound, dev
