"""The port's SelfAttention layer held against the JAX package on the
CPU, where the JAX package's attention runs as its own tests run it (an
unmasked sequence longer than `block_size` goes to its blockwise
reference there; the port sends it to the flash route, whose plain
version runs on CPU tensors).

Cases: causal and not, grouped-query K/V, a key mask, longer than
`block_size` (flash route in the port) and `project_input=False`; the
forward and the gradients of a seeded cotangent (input and every
parameter) within rtol = atol = 1e-5 (f32). Then a small network,
TokenEmbedding -> SelfAttention(causal=False) -> GlobalPoolingLayer(AVG)
-> OutputLayer, trains 3 Adam steps in both packages from the JAX
network's weights: losses within 1e-5 and parameters within 1e-5 + lr/30
(Adam's caveat, `test_torch_training.py`), through the non-causal flash
route (its plain version counted) in the port.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers as jl  # noqa: E402
from deeplearning4j_tpu.nn.conf.inputs import InputType  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as pl  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)


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


TOL = dict(rtol=1e-5, atol=1e-5)
# name -> (layer kwargs, B, T, masked, flash route in the port)
CASES = {
    "full": (dict(n_in=16, n_out=16, n_heads=2), 2, 12, False, False),
    "causal": (dict(n_in=16, n_out=16, n_heads=4, causal=True), 2, 12,
               False, False),
    "gqa": (dict(n_in=16, n_out=16, n_heads=4, n_kv_heads=2), 2, 12, False,
            False),
    "masked_causal": (dict(n_in=16, n_out=24, n_heads=3, causal=True), 2, 12,
                      True, False),
    "masked_longer_than_block": (dict(n_in=16, n_out=16, n_heads=2,
                                      block_size=8), 2, 20, True, False),
    "unprojected": (dict(n_in=16, n_out=16, n_heads=2,
                         project_input=False), 2, 12, False, False),
    "flash_full": (dict(n_in=64, n_out=256, n_heads=2, block_size=128), 1,
                   256, False, True),
    "flash_causal_gqa": (dict(n_in=64, n_out=256, n_heads=2, n_kv_heads=1,
                              causal=True, block_size=128), 1, 256, False,
                         True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_self_attention_forward_and_grads(case):
    kw, B, T, masked, flash = CASES[case]
    jlayer, player = jl.SelfAttention(**kw), pl.SelfAttention(**kw)
    it = InputType.recurrent(kw["n_in"], T)
    rng = np.random.default_rng(0)
    # weights ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2): activations O(1)
    params = {k: (rng.standard_normal(np.shape(v))
                  * (np.shape(v)[0] ** -0.5 if np.ndim(v) == 2 else 0.1)
                  ).astype(np.float32)
              for k, v in jlayer.init_params(jax.random.PRNGKey(0),
                                             it).items()}
    x = rng.standard_normal((B, T, kw["n_in"])).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, T - 5:] = 0

    def jf(p, xx):
        return jlayer.forward(p, {}, xx, mask=None if mask is None
                              else jnp.asarray(mask))[0]

    jout, vjp = jax.vjp(jf, {k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x))
    ct = rng.standard_normal(jout.shape).astype(np.float32)
    jg_p, jg_x = vjp(jnp.asarray(ct))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    calls = fa.flash_attention_plain_fwd.calls
    out = player.forward(tp, tx, mask=None if mask is None
                         else torch.tensor(mask))
    assert (fa.flash_attention_plain_fwd.calls > calls) == flash
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    g = torch.autograd.grad(out, [*tp.values(), tx], torch.tensor(ct))
    for k, gk in zip(tp, g):
        np.testing.assert_allclose(gk.numpy(), np.asarray(jg_p[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(g[-1].numpy(), np.asarray(jg_x), **TOL)


def test_self_attention_rejects_what_the_jax_package_rejects():
    for kw in (dict(n_in=8, n_out=6, n_heads=2, project_input=False),
               dict(n_in=8, n_out=8, n_heads=3),
               dict(n_in=8, n_out=8, n_heads=2, n_kv_heads=1,
                    project_input=False),
               dict(n_in=8, n_out=8, n_heads=4, n_kv_heads=3)):
        with pytest.raises(ValueError) as want:
            jl.SelfAttention(**kw)
        with pytest.raises(ValueError) as got:
            pl.SelfAttention(**kw)
        assert str(got.value) == str(want.value)


def _classifier(C, L, V=16, T=256):
    return (C.NeuralNetConfiguration.Builder().seed(3).learning_rate(1e-3)
            .updater("adam").list()
            .layer(L.TokenEmbedding(n_in=V, n_out=128, max_length=T))
            .layer(C.SelfAttention(n_in=128, n_out=128, n_heads=1,
                                   causal=False, block_size=128,
                                   activation="identity"))
            .layer(C.GlobalPoolingLayer(pooling_type=C.PoolingType.AVG))
            .layer(C.OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(C.InputType.recurrent(V, T)).build())


def test_attention_classifier_trains_like_the_jax_package():
    jnet = JaxNet(_classifier(JC, jl))
    jnet.init()
    pnet = MultiLayerNetwork(_classifier(PC, pl), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, jnet._params))
    assert pnet.conf.to_json() == jnet.conf.to_json()
    rng = np.random.default_rng(1)
    calls = fa.flash_attention_plain_bwd.calls
    for _ in range(3):
        ids = rng.integers(0, 16, (2, 256)).astype(np.int32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 2)]
        jnet.fit(JDataSet(ids, y))
        pnet.fit(DataSet(ids, y))
        assert pnet.score_value == pytest.approx(jnet.score_value, rel=1e-5)
    assert fa.flash_attention_plain_bwd.calls == calls + 3
    for i, (jp, pp) in enumerate(zip(jnet._params, pnet._params)):
        for k in jp:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-5 + 1e-3 / 30,
                                       err_msg=f"layer {i} {k}")
