"""The port's Switch mixture of experts held against the JAX package on
the CPU, in f32: the routing (expert and keep mask) exactly, on router
logits drawn so that no two of a token's logits lie within 1e-4 of each
other; `switch_ffn`'s output and gradients within rtol = atol = 1e-5 and
its load-balancing loss within 1e-6, with capacity overflow, padding
masks and both passthroughs; `MoELayer` in a network; a 2-layer MoE GPT
(`gpt_configuration(moe_experts=4)`) trained 3 Adam steps from the JAX
network's weights, losses within 1e-6 (relative); greedy `generate`
tokens identical; and, at `moe_capacity_factor >= moe_experts` (capacity
N: nothing overflows, so a token's route does not depend on which
others share its call), each package's `DecodeEngine` equal to its own
`generate` and to the other's.
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    generate as jax_generate,
    gpt_configuration as jgpt,
)
from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers as jl  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.parallel import experts as jex  # noqa: E402
from deeplearning4j_tpu.serving import DecodeEngine as JaxEngine  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.models.transformer import (  # noqa: E402
    generate,
    gpt_configuration,
)
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as pl  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import aux_loss  # noqa: E402
from deeplearning4j_tpu_torch.parallel import experts as pex  # noqa: E402
from deeplearning4j_tpu_torch.serving import DecodeEngine  # noqa: E402
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
    updater_state_from_jax,
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


def _separated_inputs(N, D, E, seed, skew=0.0):
    """Tokens and a router whose logits keep every pair of a token's
    logits at least 1e-4 apart (redrawn until they do); `skew` biases
    the router toward expert 0 so that its capacity overflows."""
    rng = np.random.default_rng(seed)
    while True:
        x = rng.standard_normal((N, D)).astype(np.float32)
        router = rng.standard_normal((D, E)).astype(np.float32) * 0.5
        router[:, 0] += skew * x.mean(axis=0) / max(
            float(np.square(x.mean(axis=0)).sum()), 1e-6)
        logits = np.sort(x @ router, axis=1)
        if np.diff(logits, axis=1).min() > 1e-4:
            return x, router


def _experts(E, D, h, seed):
    rng = np.random.default_rng(seed)
    return {"W1": rng.standard_normal((E, D, h)).astype(np.float32) / D ** .5,
            "b1": rng.standard_normal((E, h)).astype(np.float32) * 0.1,
            "W2": rng.standard_normal((E, h, D)).astype(np.float32) / h ** .5,
            "b2": rng.standard_normal((E, D)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25])
def test_routing_is_exact(cf, masked):
    N, D, E = 40, 8, 4
    x, router = _separated_inputs(N, D, E, seed=1, skew=2.0)
    valid = None
    if masked:
        valid = np.ones(N, bool)
        valid[[3, 4, 17, 39]] = False
    cap = int(np.ceil(N / E * cf))
    jidx = jnp.argmax(jex.router_probs(jnp.asarray(x), jnp.asarray(router)),
                      axis=-1)
    pidx = torch.argmax(pex.router_probs(torch.tensor(x),
                                         torch.tensor(router)), dim=-1)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    jpos, jkeep = jex._dispatch_indices(
        jidx, E, cap, None if valid is None else jnp.asarray(valid))
    ppos, pkeep = pex._dispatch_indices(
        pidx, E, cap, None if valid is None else torch.tensor(valid))
    np.testing.assert_array_equal(pkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
    if cf < 1.25:
        assert not pkeep.all()  # something overflowed


@pytest.mark.parametrize("passthrough", ["identity", "zero"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cf", [0.75, 1.25])
def test_switch_ffn_output_grads_and_aux(cf, masked, passthrough):
    N, D, E, h = 48, 8, 4, 16
    x, router = _separated_inputs(N, D, E, seed=2, skew=1.0)
    params = dict(_experts(E, D, h, seed=3), router=router)
    tm = None
    if masked:
        tm = np.ones(N, np.float32)
        tm[-6:] = 0
    kw = dict(capacity_factor=cf, aux_weight=0.01, train=True,
              passthrough=passthrough)

    def jf(p, xx):
        from deeplearning4j_tpu.ops.aux_loss import aux_loss_scope

        with aux_loss_scope() as terms:
            y = jex.switch_ffn(p, xx, act=jax.nn.gelu,
                               token_mask=None if tm is None
                               else jnp.asarray(tm), **kw)
        return y, terms[0]

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (jy, jaux), vjp = jax.vjp(jf, jp, jnp.asarray(x))
    ct = np.random.default_rng(4).standard_normal(jy.shape).astype(
        np.float32)
    jg_p, jg_x = vjp((jnp.asarray(ct), jnp.ones_like(jaux)))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    with aux_loss.aux_loss_scope() as terms:
        y = pex.switch_ffn(tp, tx, act=lambda t: torch.nn.functional.gelu(
            t, approximate="tanh"), token_mask=None if tm is None
            else torch.tensor(tm), **kw)
    assert len(terms) == 1
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    assert float(terms[0].detach()) == pytest.approx(float(jaux), abs=1e-6)
    g = torch.autograd.grad((y * torch.tensor(ct)).sum() + terms[0],
                            [*tp.values(), tx])
    for k, gk in zip(tp, g):
        np.testing.assert_allclose(gk.numpy(), np.asarray(jg_p[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(g[-1].numpy(), np.asarray(jg_x), rtol=1e-5,
                               atol=1e-5)
    # no scope, or train=False: nothing is collected and nothing raises
    assert pex.switch_ffn(tp, tx, act=torch.relu, capacity_factor=cf,
                          aux_weight=0.01, train=True).shape == (N, D)


def test_expert_parallel_names_raise_naming_a12():
    for name in ("expert_mesh_scope", "current_expert_mesh", "moe_apply",
                 "switch_ffn_sharded"):
        with pytest.raises(NotImplementedError, match="queue A12"):
            fn = getattr(pex, name)
            fn(*([None] * (fn.__code__.co_argcount)))
    import deeplearning4j_tpu_torch.parallel as par

    with pytest.raises(NotImplementedError, match="queue A12"):
        par.ParallelWrapper


def _moe_net(C, L, **kw):
    return (C.NeuralNetConfiguration.Builder().seed(9).learning_rate(0.05)
            .updater("sgd").list()
            .layer(C.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.MoELayer(n_experts=3, hidden_mult=2, capacity_factor=1.0,
                              **kw))
            .layer(C.RnnOutputLayer(n_out=5, activation="softmax"))
            .set_input_type(C.InputType.recurrent(6)).build())


@pytest.mark.parametrize("expert_axis", [None, "expert"])
def test_moe_layer_network_trains_like_the_jax_package(expert_axis):
    """A MoELayer between dense layers, masked sequences, 3 SGD steps:
    losses 1e-6 and parameters 1e-5; `expert_axis` with no mesh runs
    the replicated path in both."""
    jnet = JaxNet(_moe_net(JC, jl, expert_axis=expert_axis))
    jnet.init()
    pnet = MultiLayerNetwork(_moe_net(PC, pl, expert_axis=expert_axis),
                             device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, jnet._params))
    assert pnet.conf.to_json() == jnet.conf.to_json()
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = rng.standard_normal((3, 7, 6)).astype(np.float32)
        y = rng.integers(0, 5, (3, 7)).astype(np.int32)
        m = np.ones((3, 7), np.float32)
        m[1, 5:] = 0
        jnet.fit(JDataSet(x, y, m, m))
        pnet.fit(DataSet(x, y, m, m))
        assert pnet.score_value == pytest.approx(jnet.score_value, rel=1e-6)
    for i, (jp, pp) in enumerate(zip(jnet._params, pnet._params)):
        for k in jp:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"layer {i} {k}")
    # score(train=True) carries the aux term, score(train=False) not
    ds_j, ds_p = JDataSet(x, y, m, m), DataSet(x, y, m, m)
    for train in (False, True):
        assert pnet.score(ds_p, train=train) == pytest.approx(
            jnet.score(ds_j, train=train), rel=1e-6)
    assert pnet.score(ds_p, train=True) > pnet.score(ds_p, train=False)


GPT = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=2, max_length=64,
           moe_experts=4)


def _gpt_pair(capacity_factor=None, **kw):
    kw = dict(GPT, **kw)
    jconf, pconf = jgpt(**kw), gpt_configuration(**kw)
    if capacity_factor is not None:  # the builder keeps the default
        for conf in (jconf, pconf):
            for layer in conf.layers:
                if hasattr(layer, "moe_capacity_factor"):
                    layer.moe_capacity_factor = capacity_factor
    jnet = JaxNet(jconf)
    jnet.init()
    pnet = MultiLayerNetwork(pconf, device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, jnet._params))
    return jnet, pnet


def test_moe_gpt_configuration_json_both_ways():
    text = jgpt(**GPT).to_json()
    assert gpt_configuration(**GPT).to_json() == text
    assert PC.MultiLayerConfiguration.from_json(text).to_json() == text
    assert json.loads(text)["layers"][1]["moe_experts"] == 4
    for C, L in ((JC, jl), (PC, pl)):
        with pytest.raises(ValueError, match="swiglu"):
            L.TransformerBlock(n_in=8, n_out=8, n_heads=2, moe_experts=2,
                               ffn_activation="swiglu")


def test_moe_gpt_trains_and_generates_like_the_jax_package():
    """3 Adam steps (losses 1e-6 relative, parameters 1e-5 + lr/30), then
    greedy generate: the same tokens. remat=True changes nothing for an
    MoE block (never recomputed)."""
    jnet, pnet = _gpt_pair(remat=True)
    pnet.set_updater_state(updater_state_from_jax(pnet.conf,
                                                  jnet._upd_state))
    rng = np.random.default_rng(0)
    for _ in range(3):
        ids = rng.integers(0, 32, (4, 17))
        x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        assert pnet.score_value == pytest.approx(jnet.score_value, rel=1e-6)
    for i, (jp, pp) in enumerate(zip(jnet._params, pnet._params)):
        for k in jp:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-5 + 3e-4 / 30,
                                       err_msg=f"layer {i} {k}")
    prompts = rng.integers(0, 32, (2, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        generate(pnet, prompts, 8, temperature=0.0, device="cpu"),
        jax_generate(jnet, prompts, 8, temperature=0.0))


def test_moe_engine_equals_generate_in_both_packages():
    """moe_capacity_factor = E: capacity N, nothing overflows, so the
    engine (per-step routing of its slots' tokens, one prompt a prefill)
    gives generate's tokens, in each package and across them."""
    jnet, pnet = _gpt_pair(capacity_factor=4.0)
    prompts = np.random.default_rng(1).integers(0, 32, (3, 6)).astype(
        np.int32)
    want = jax_generate(jnet, prompts, 7, temperature=0.0)
    np.testing.assert_array_equal(
        generate(pnet, prompts, 7, temperature=0.0, device="cpu"), want)
    jeng = JaxEngine(jnet, n_slots=2, max_len=32, prompt_buckets=(8,))
    try:
        got = [r.result(timeout=120.0)
               for r in [jeng.submit(p, 7) for p in prompts]]
    finally:
        jeng.shutdown()
    np.testing.assert_array_equal(np.stack(got), want)
    eng = DecodeEngine(pnet, n_slots=2, max_len=32, prompt_buckets=(8,),
                       device="cpu")
    try:
        got = [r.result(timeout=120.0)
               for r in [eng.submit(p, 7) for p in prompts]]
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(np.stack(got), want)
