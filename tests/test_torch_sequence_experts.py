"""The port's sequence parallelism (`parallel/sequence.py`: ring and
Ulysses attention, `SequenceParallelWrapper`), expert parallelism
(`parallel/experts.py`: `moe_apply`, `switch_ffn_sharded`, `MoELayer(
expert_axis=)` under `ParallelWrapper`) and `ParallelWrapper`'s
`param_specs` / `model` axis, held against the JAX package on the CPU on
slots of the CPU.

Tolerances: ring and Ulysses against the JAX full attention in f32 to
1e-5 (another order of summation); the sequence-parallel and
expert-parallel networks against the JAX package's single-device
training to its own tests' tolerances (losses rtol 2e-4; MoE params rtol
5e-4 / atol 5e-6); `moe_apply` under overflow against the JAX `moe_apply`
on the JAX tests' forced host devices (GShard capacity per source slot:
the same tokens drop) to 1e-5; the global view of `param_specs` and a
`model` axis bit-identical to `net.fit`.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.ops.attention import (  # noqa: E402
    full_attention as jax_full_attention,
    mask_bias as jax_mask_bias,
)
from deeplearning4j_tpu.parallel.experts import (  # noqa: E402
    moe_apply as jax_moe_apply,
    moe_apply_reference as jax_moe_reference,
)
from deeplearning4j_tpu.parallel.mesh import (  # noqa: E402
    make_mesh as jax_make_mesh,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    ParallelWrapper,
    SequenceParallelWrapper,
    ring_attention,
    ulysses_attention,
)
from deeplearning4j_tpu_torch.parallel import experts as pex  # noqa: E402
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs (the tier runs
    several xdist workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


def _mesh(axes):
    return make_mesh(axes, devices=[CPU] * int(np.prod(list(axes.values()))))


def _pair(jconf):
    jnet = dl4j.MultiLayerNetwork(jconf)
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    return jnet, pnet


def _qkv(B=2, T=16, H=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(3)]


# ------------------------------------------------- ring and Ulysses
@pytest.mark.parametrize("causal", [False, True])
def test_ring_and_ulysses_match_full_attention(causal):
    q, k, v = _qkv()
    want = np.asarray(jax_full_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    mesh = _mesh({"seq": 4})
    for fn in (ring_attention, ulysses_attention):
        got = fn(tq, tk, tv, mesh, causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ring_key_mask_dp_sp_mesh_and_ulysses_mask():
    """A key mask rides the ring with its K/V block; a {data, seq} mesh
    splits B over data as well; Ulysses all-gathers the mask."""
    q, k, v = _qkv(B=4, seed=1)
    mask = np.ones((4, 16), np.float32)
    mask[0, 10:] = 0
    mask[3, :5] = 0
    want = np.asarray(jax_full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=jax_mask_bias(jnp.asarray(mask))))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ring_attention(tq, tk, tv, _mesh({"data": 2, "seq": 4}),
                         key_mask=torch.from_numpy(mask), batch_axis="data")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got = ulysses_attention(tq, tk, tv, _mesh({"seq": 2}),
                            key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ring_gradients_match_full_attention():
    """One backward() through the ring: the K/V gradients rotate back."""
    q, k, v = _qkv(B=1, T=8, H=2, D=4, seed=2)

    def jloss(a, b, c):
        return jnp.sum(jax_full_attention(a, b, c, causal=True) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (ring_attention(*t, _mesh({"seq": 4}), causal=True) ** 2).sum() \
        .backward()
    for got, want in zip(t, jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def test_sequence_parallel_validation():
    q = torch.zeros((1, 6, 3, 4))
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        ring_attention(q, q, q, _mesh({"seq": 4}))
    with pytest.raises(ValueError, match="n_heads 3 not divisible"):
        ulysses_attention(q, q, q, _mesh({"seq": 2}))


def test_sequence_parallel_wrapper_matches_single_device():
    """Every attention layer by ring attention over 4 slots: the JAX
    package's single-device losses (rtol 2e-4)."""
    vocab, T = 17, 8
    jconf = jax_gpt_configuration(vocab_size=vocab, d_model=32, n_heads=2,
                                  n_layers=2, max_length=T, seed=9)
    jnet, pnet = _pair(jconf)
    sp = SequenceParallelWrapper(pnet, _mesh({"seq": 4}))
    rng = np.random.default_rng(5)
    for _ in range(3):
        ids = rng.integers(0, vocab, (8, T + 1))
        x = ids[:, :-1].astype(np.int32)
        y = np.eye(vocab, dtype=np.float32)[ids[:, 1:]]
        jnet.fit(JDataSet(x, y))
        sp.fit(DataSet(x, y))
        np.testing.assert_allclose(pnet.score_value,
                                   float(jnet.score_value), rtol=2e-4)
    with pytest.raises(ValueError, match="not divisible by the 'seq'"):
        sp.fit(DataSet(x[:, :6], y[:, :6]))
    with pytest.raises(NotImplementedError, match="masked sequences"):
        sp.fit(DataSet(x, y, np.ones((8, T), np.float32)))
    with pytest.raises(ValueError, match="no 'seq' axis"):
        SequenceParallelWrapper(pnet, _mesh({"data": 2}))
    with pytest.raises(ValueError, match="pure-sequence mesh"):
        SequenceParallelWrapper(pnet, _mesh({"seq": 2, "other": 2}))


# ------------------------------------------------------------ experts
def _ffn_np(E, D, H, seed=0):
    rng = np.random.default_rng(seed)
    return {"W1": (rng.normal(size=(E, D, H)) * 0.2).astype(np.float32),
            "W2": (rng.normal(size=(E, H, D)) * 0.2).astype(np.float32)}


def _jffn(p, x):
    return jax.nn.relu(x @ p["W1"]) @ p["W2"]


def _tffn(p, x):
    return torch.relu(x @ p["W1"]) @ p["W2"]


@pytest.mark.parametrize("passthrough", ["identity", "zero"])
def test_moe_apply_matches_the_reference_without_overflow(passthrough):
    E, D, H, N = 4, 8, 16, 64
    params = _ffn_np(E, D, H)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, D)).astype(np.float32)
    rw = rng.normal(size=(D, E)).astype(np.float32)
    jy, jaux = jax_moe_reference(
        _jffn, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x), jnp.asarray(rw), capacity_factor=float(2 * E),
        passthrough=passthrough)
    y, aux = pex.moe_apply(_tffn, {k: torch.from_numpy(v)
                                   for k, v in params.items()},
                           torch.from_numpy(x), torch.from_numpy(rw),
                           _mesh({"expert": E}), capacity_factor=float(2 * E),
                           passthrough=passthrough)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_apply_under_overflow_matches_the_jax_moe_apply():
    """Tight capacity on a {data, expert} mesh: the same tokens drop as
    in the JAX expert-parallel body (capacity per expert and source)."""
    E, D, H, N = 4, 8, 16, 64
    params = _ffn_np(E, D, H, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(N, D)).astype(np.float32)
    rw = (rng.normal(size=(D, E)) * 3).astype(np.float32)
    jmesh = jax_make_mesh({"data": 2, "expert": E},
                          devices=jax.devices()[:2 * E])
    jy, jaux = jax_moe_apply(
        _jffn, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x), jnp.asarray(rw), jmesh, capacity_factor=0.5,
        data_axis="data")
    y, aux = pex.moe_apply(_tffn, {k: torch.from_numpy(v)
                                   for k, v in params.items()},
                           torch.from_numpy(x), torch.from_numpy(rw),
                           _mesh({"data": 2, "expert": E}),
                           capacity_factor=0.5, data_axis="data")
    assert np.isclose(y.numpy(), x).all(axis=1).sum() > 0  # overflowed
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible by expert axis"):
        pex.moe_apply(_tffn, {k: torch.from_numpy(v)
                              for k, v in params.items()},
                      torch.zeros((12, D)), torch.from_numpy(rw),
                      _mesh({"data": 2, "expert": E}), data_axis="data")


def _moe_jconf(expert_axis, E=4, seed=1, tbptt=0):
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.conf.layers import (
        DenseLayer,
        MoELayer,
        RnnOutputLayer,
    )
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction

    b = (dl4j.NeuralNetConfiguration.Builder().seed(seed).learning_rate(0.05)
         .list()
         .layer(DenseLayer(n_in=6, n_out=16, activation=Activation.RELU))
         .layer(MoELayer(n_in=16, n_out=16, n_experts=E,
                         capacity_factor=float(2 * E),
                         expert_axis=expert_axis))
         .layer(RnnOutputLayer(n_in=16, n_out=3,
                               activation=Activation.SOFTMAX,
                               loss=LossFunction.MCXENT)))
    if tbptt:
        b = b.t_bptt_forward_length(tbptt)
    return b.set_input_type(InputType.recurrent(6)).build()


def _moe_data(B=16, T=4, seed=7):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, (B, T))
    x = (rng.normal(size=(B, T, 6)) * 0.3 + c[..., None]).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[c]


def test_expert_parallel_network_matches_single_device():
    """A MoELayer with expert_axis trained through ParallelWrapper over
    {data 2, expert 4}: the JAX package's single-device training (the
    same weights; the experts run one per slot and their aux loss
    reaches the training loss)."""
    x, y = _moe_data()
    jnet, _ = _pair(_moe_jconf(None))
    _, pnet = _pair(_moe_jconf("expert"))
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    pw = ParallelWrapper(pnet, mesh=_mesh({"data": 2, "expert": 4}))
    calls = []
    orig = pex.moe_apply

    def spy(*a, **kw):
        calls.append(kw.get("data_axis"))
        return orig(*a, **kw)

    pex.moe_apply = spy
    try:
        for _ in range(5):
            jnet.fit(JDataSet(x, y))
            pw.fit(DataSet(x, y))
    finally:
        pex.moe_apply = orig
    assert calls == ["data"] * 5
    assert np.isclose(pnet.score_value, float(jnet.score_value), rtol=2e-4)
    for jp, pp in zip(jnet._params, pnet._params):
        for k in jp:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=5e-4, atol=5e-6)


def test_expert_parallel_validation_trims_and_refusals():
    _, net = _pair(_moe_jconf("expert"))
    with pytest.raises(ValueError, match="expert_axis 'expert'"):
        ParallelWrapper(net, mesh=_mesh({"data": 8}))
    _, net2 = _pair(_moe_jconf("expert", E=2))
    with pytest.raises(ValueError, match="2 experts but mesh axis"):
        ParallelWrapper(net2, mesh=_mesh({"data": 2, "expert": 4}))
    _, tnet = _pair(_moe_jconf("expert", tbptt=4))
    with pytest.raises(NotImplementedError, match="truncated BPTT"):
        ParallelWrapper(tnet, mesh=_mesh({"data": 2, "expert": 4}))
    pw = ParallelWrapper(net, mesh=_mesh({"data": 2, "expert": 4}))
    x, y = _moe_data(B=6, T=4, seed=3)   # 24 tokens divide 8
    pw.fit(DataSet(x, y))
    assert net.iteration == 1 and np.isfinite(net.score_value)
    x3, y3 = _moe_data(B=6, T=3, seed=4)  # 18, 12, 6 tokens: dropped
    pw.fit(DataSet(x3, y3))
    assert net.iteration == 1
    with pytest.raises(NotImplementedError, match="masked sequences"):
        pw.fit(DataSet(x, y, np.ones((6, 4), np.float32)))


# ------------------------------------------- the global view on one device
def test_param_specs_and_model_axis_steps_equal_net_fit():
    """`param_specs` over a `model` axis is checked, then computed
    unsplit: every step bit-identical to `net.fit` of a clone."""
    vocab, T = 17, 8
    jconf = jax_gpt_configuration(vocab_size=vocab, d_model=32, n_heads=2,
                                  n_layers=2, max_length=T, seed=9)
    _, net = _pair(jconf)
    ref = net.clone()
    mesh = _mesh({"data": 4, "model": 2})
    pw = ParallelWrapper(net, mesh=mesh, param_specs={
        1: {"Wqkv": (None, "model"), "Wo": ("model", None)},
        2: {"W1": (None, "model"), "W2": ("model", None)}})
    rng = np.random.default_rng(0)
    for _ in range(2):
        ids = rng.integers(0, vocab, (8, T + 1))
        ds = DataSet(ids[:, :-1].astype(np.int32),
                     np.eye(vocab, dtype=np.float32)[ids[:, 1:]])
        pw.fit(ds)
        ref.fit(ds)
        assert net.score_value == ref.score_value
    for a, b in zip(ref._params, net._params):
        for k in a:
            assert torch.equal(a[k], b[k])
    with pytest.raises(ValueError, match="splits dimension 1"):
        ParallelWrapper(net, mesh=_mesh({"data": 1, "model": 3}),
                        param_specs={1: {"Wo": (None, "model")}})
