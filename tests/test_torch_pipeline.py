"""The port's GPipe pipeline (`parallel/pipeline.py`) and
`PipelineParallelWrapper` (`parallel/pipeline_wrapper.py`) held against
the JAX package on the CPU, on slots of the CPU.

`pipeline_apply` is held against the JAX `pipeline_apply` on the JAX
tests' forced host devices (forward) and against `jax.grad` of the
sequential stages (backward), on the same stage weights. The wrapper
trains an 8-stage MLP (SGD and Adam), a 4-stage GPT trunk, a dp x pp GPT
and a dp x tp x pp GPT, each against the JAX package's single-device
`net.fit` from the same weights (`params_from_jax`), to the JAX
wrapper's own tolerances (f32: rtol 2e-4 / atol 2e-5 on losses, 3e-4 /
3e-5 on params). With dropout, the pipeline matches the port's
single-device training under `row_offset_scope(0)` (losses to 1e-6),
and a stage that keyed dropout by its local row would not. The refusals keep the JAX
wrapper's wording.
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
from deeplearning4j_tpu.parallel.mesh import (  # noqa: E402
    make_mesh as jax_make_mesh,
)
from deeplearning4j_tpu.parallel.pipeline import (  # noqa: E402
    pipeline_apply as jax_pipeline_apply,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.models.transformer import (  # noqa: E402
    gpt_configuration,
)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.ops.rng_rows import (  # noqa: E402
    row_offset_scope,
)
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    PipelineParallelWrapper,
    find_trunk,
    pipeline_apply,
    shard_stacked_params,
    stack_stage_params,
)
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
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=3e-4, atol=3e-5)


def _mesh(axes):
    return make_mesh(axes, devices=[CPU] * int(np.prod(list(axes.values()))))


# ------------------------------------------------------- pipeline_apply
def _stages(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return [{"W": (rng.normal(size=(d, d)) * 0.3).astype(np.float32),
             "b": (rng.normal(size=(d,)) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _jblock(p, x):
    return jnp.tanh(x @ p["W"] + p["b"])


def _tblock(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


@pytest.mark.parametrize("microbatches", [4, 8])
def test_pipeline_forward_parity(microbatches):
    """4 stages over 4 slots against the JAX pipeline on 4 forced host
    devices (f32, rtol 1e-5: the same math in another library)."""
    stages = _stages(4, 16)
    x = np.random.default_rng(1).normal(size=(32, 16)).astype(np.float32)
    jstacked = jax.tree.map(lambda *a: jnp.stack(a),
                            *[{k: jnp.asarray(v) for k, v in s.items()}
                              for s in stages])
    want = jax_pipeline_apply(
        _jblock, jstacked, jnp.asarray(x),
        jax_make_mesh({"pipe": 4}, devices=jax.devices()[:4]),
        microbatches=microbatches)
    stacked = stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
    got = pipeline_apply(_tblock, stacked, torch.from_numpy(x),
                         _mesh({"pipe": 4}), microbatches=microbatches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_pipeline_backward_parity():
    """One backward() through the pipeline (the reverse schedule) gives
    `jax.grad` of the sequential stages (f32, rtol 1e-4)."""
    stages = _stages(4, 8, seed=2)
    x = np.random.default_rng(3).normal(size=(16, 8)).astype(np.float32)

    def seq_loss(ps, xx):
        for p in ps:
            xx = _jblock(p, xx)
        return jnp.sum(xx ** 2)

    jg = jax.grad(seq_loss)([{k: jnp.asarray(v) for k, v in s.items()}
                             for s in stages], jnp.asarray(x))
    stacked = stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
    stacked = {k: v.requires_grad_(True) for k, v in stacked.items()}
    y = pipeline_apply(_tblock, stacked, torch.from_numpy(x),
                       _mesh({"pipe": 4}), microbatches=4)
    (y ** 2).sum().backward()
    for s in range(4):
        for k in ("W", "b"):
            np.testing.assert_allclose(stacked[k].grad[s].numpy(),
                                       np.asarray(jg[s][k]), rtol=1e-4,
                                       atol=1e-6)


def test_pipeline_2d_block_ctx_and_placed_stages():
    """dp x pp: each microbatch's rows split over `data`; the block sees
    its stage and the global row offset of its rows; pre-split stage
    params (`shard_stacked_params`) give the same result."""
    mesh = _mesh({"data": 2, "pipe": 2})
    stages = _stages(2, 4, seed=4)
    stacked = stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 4))
                         .astype(np.float32))
    seen = []

    def block(p, xb, stage, row):
        seen.append((stage, row, xb.shape[0]))
        return _tblock(p, xb)

    y = pipeline_apply(block, stacked, x, mesh, microbatches=2,
                       data_axis="data", block_ctx=True)
    ref = _tblock({k: v[1] for k, v in stacked.items()},
                  _tblock({k: v[0] for k, v in stacked.items()}, x))
    torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)
    # microbatch m of 4 rows, data shard i of 2: first global row 4m + 2i
    assert sorted(seen) == sorted((s, r, 2) for s in (0, 1)
                                  for r in (0, 2, 4, 6))
    placed = shard_stacked_params(stacked, mesh, "pipe")
    y2 = pipeline_apply(_tblock, placed, x, mesh, microbatches=2,
                        data_axis="data")
    assert torch.equal(y2, pipeline_apply(_tblock, stacked, x, mesh,
                                          microbatches=2, data_axis="data"))


def test_pipeline_validation_errors():
    stacked = stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s.items()}
         for s in _stages(4, 4)])
    x = torch.zeros((8, 4))
    mesh = _mesh({"data": 2, "pipe": 4})
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(_tblock, stacked, x, mesh, microbatches=3)
    with pytest.raises(ValueError, match="must differ"):
        pipeline_apply(_tblock, stacked, x, mesh, data_axis="pipe")
    with pytest.raises(ValueError, match="no 'other' axis"):
        pipeline_apply(_tblock, stacked, x, mesh, data_axis="other")
    with pytest.raises(ValueError, match="not divisible over data"):
        pipeline_apply(_tblock, stacked, torch.zeros((4, 4)), mesh,
                       microbatches=4, data_axis="data")
    with pytest.raises(ValueError, match="4 stages but mesh axis"):
        pipeline_apply(_tblock, stacked, x, _mesh({"pipe": 2}))


# ------------------------------------------------- the wrapper vs JAX
def _mlp_jconf(depth=8, width=32, n_in=12, n_out=5, seed=7,
               updater="sgd", lr=0.05):
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.conf import InputType
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction

    b = (dl4j.NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
         .updater(updater).list()
         .layer(DenseLayer(n_in=n_in, n_out=width,
                           activation=Activation.TANH)))
    for _ in range(depth):
        b = b.layer(DenseLayer(n_out=width, activation=Activation.TANH))
    return (b.layer(OutputLayer(n_out=n_out, loss=LossFunction.MCXENT,
                                activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(n_in)).build())


def _pair(jconf):
    jnet = dl4j.MultiLayerNetwork(jconf)
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    return jnet, pnet


def _mlp_data(n=64, n_in=12, n_out=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)]
    return [(x[i:i + 16], y[i:i + 16]) for i in range(0, n, 16)]


def _gpt_data(vocab=17, B=16, T=8, n=2, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (B, T + 1))
        out.append((ids[:, :-1].astype(np.int32),
                    np.eye(vocab, dtype=np.float32)[ids[:, 1:]]))
    return out


def _close_params(jnet, pnet, tol=PARAM_TOL):
    for jp, pp in zip(jnet._params, pnet._params):
        for k in jp:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       **tol)


def _train_both(jnet, pnet, pw, batches, epochs=1):
    jl, pl = [], []
    for _ in range(epochs):
        for x, y in batches:
            jnet.fit(JDataSet(x, y))
            jl.append(float(jnet.score_value))
            pw.fit(DataSet(x, y))
            pl.append(float(pnet.score_value))
    np.testing.assert_allclose(pl, jl, **LOSS_TOL)


def test_find_trunk_identifies_homogeneous_run():
    _, pnet = _pair(_mlp_jconf(depth=8))
    assert find_trunk(pnet, 8) == (1, 9)
    _, shallow = _pair(_mlp_jconf(depth=2))
    with pytest.raises(ValueError, match="pipeline-able trunk"):
        find_trunk(shallow, 8)


@pytest.mark.parametrize("updater,lr", [("sgd", 0.05), ("adam", 0.01)])
def test_pipeline_training_matches_single_device(updater, lr):
    """8 stages of one dense layer each: the losses and params of the
    JAX package's single-device training."""
    jnet, pnet = _pair(_mlp_jconf(updater=updater, lr=lr))
    pw = PipelineParallelWrapper(pnet, _mesh({"pipe": 8}))
    _train_both(jnet, pnet, pw, _mlp_data(), epochs=2)
    _close_params(jnet, pnet)
    out = pnet.output(_mlp_data()[0][0])
    assert out.shape == (16, 5) and torch.isfinite(out).all()


def test_pipeline_gpt_trunk_matches_single_device():
    """A TransformerBlock trunk (4 stages): head (the embedding) and tail
    (the final LN and the head) replicated; every stage runs the flash
    route (T > the attention block size) in its own slot."""
    vocab, T = 17, 256
    jconf = jax_gpt_configuration(vocab_size=vocab, d_model=128, n_heads=1,
                                  n_layers=4, max_length=T, seed=9,
                                  attention_block_size=128)
    jnet, pnet = _pair(jconf)
    pw = PipelineParallelWrapper(pnet, _mesh({"pipe": 4}))
    assert (pw.trunk_start, pw.trunk_end) == (1, 5)
    fa.reset_counts()
    _train_both(jnet, pnet, pw, _gpt_data(vocab=vocab, B=4, T=T, n=2))
    _close_params(jnet, pnet)
    by = fa.plain_calls_by_slot
    for kind in ("fwd", "bwd"):
        assert [by.get((kind, s), 0) for s in range(4)] == [2 * 4] * 4, by
        assert by.get((kind, None), 0) == 0


def test_pipeline_gpt_trunk_2d_dp_pp():
    vocab, T = 17, 8
    jconf = jax_gpt_configuration(vocab_size=vocab, d_model=32, n_heads=2,
                                  n_layers=2, max_length=T, seed=9)
    jnet, pnet = _pair(jconf)
    pw = PipelineParallelWrapper(pnet, _mesh({"data": 2, "pipe": 2}),
                                 data_axis="data")
    batch = _gpt_data(vocab=vocab, T=T, n=1)
    _train_both(jnet, pnet, pw, batch * 3)


def test_pipeline_gpt_3d_dp_tp_pp_matches_single_device():
    """dp x tp x pp: the model axis is checked and each stage computes the
    unsplit stage, the single-device math."""
    vocab, T = 17, 8
    jconf = jax_gpt_configuration(vocab_size=vocab, d_model=32, n_heads=2,
                                  n_layers=2, max_length=T, seed=9)
    jnet, pnet = _pair(jconf)
    pw = PipelineParallelWrapper(
        pnet, _mesh({"data": 2, "model": 2, "pipe": 2}), data_axis="data",
        model_axis="model")
    assert pw._model_specs["W2"] == ("model", None)
    _train_both(jnet, pnet, pw, _gpt_data(vocab=vocab, T=T, n=2))
    _close_params(jnet, pnet)


def test_pipeline_gpt_trunk_with_dropout_matches_single_device():
    """Dropout 0.1 on every block: the pipeline draws each global row's
    masks, the single-device step's under row_offset_scope(0). Losses
    to rtol 1e-6; params to atol 1e-5 (the microbatches sum the
    gradients in another order, and Adam turns a near-zero gradient
    into a step of about lr = 3e-4). A stage that keyed dropout by its
    local row would be off by far more (> 1e-4 in the first loss)."""
    from deeplearning4j_tpu_torch.parallel import pipeline_wrapper as pwm

    vocab, T = 17, 8

    def fresh():
        net = MultiLayerNetwork(gpt_configuration(
            vocab_size=vocab, d_model=32, n_heads=2, n_layers=4,
            max_length=T, dropout=0.1, seed=9), device="cpu")
        net.init()
        return net

    batches = [DataSet(x, y) for x, y in _gpt_data(vocab=vocab, T=T)]
    ref = fresh()
    ref_losses = []
    with row_offset_scope(0):
        for ds in batches:
            ref.fit(ds)
            ref_losses.append(ref.score_value)
    net = fresh()
    pw = PipelineParallelWrapper(net, _mesh({"pipe": 4}))
    losses = []
    for ds in batches:
        pw.fit(ds)
        losses.append(net.score_value)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6, atol=1e-7)
    for a, b in zip(ref._params, net._params):
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=1e-4, atol=1e-5)

    # the planted fault: every microbatch keyed at local row 0
    orig = pwm.pipeline_apply

    def local_rows(block_fn, *a, **kw):
        return orig(lambda p, x, s, r: block_fn(p, x, s, 0), *a, **kw)

    net2 = fresh()
    pw2 = PipelineParallelWrapper(net2, _mesh({"pipe": 4}))
    pwm.pipeline_apply = local_rows
    try:
        pw2.fit(batches[0])
    finally:
        pwm.pipeline_apply = orig
    assert abs(net2.score_value - ref_losses[0]) > 1e-4


def test_wrapper_refusals_keep_the_jax_wording():
    from deeplearning4j_tpu_torch.nn.conf import (
        GravesLSTM,
        InputType,
        NeuralNetConfiguration,
        RnnOutputLayer,
    )

    conf = (NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
            .list()
            .layer(GravesLSTM(n_in=8, n_out=16))
            .layer(RnnOutputLayer(n_out=8, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(InputType.recurrent(8))
            .t_bptt_forward_length(4).build())
    with pytest.raises(ValueError, match="tBPTT"):
        PipelineParallelWrapper(MultiLayerNetwork(conf, device="cpu"),
                                _mesh({"pipe": 8}))
    _, pnet = _pair(_mlp_jconf())
    with pytest.raises(ValueError, match="ComputationGraph"):
        PipelineParallelWrapper(object(), _mesh({"pipe": 8}))
    with pytest.raises(ValueError, match="no 'data' axis"):
        PipelineParallelWrapper(pnet, _mesh({"pipe": 8}), data_axis="data")
    with pytest.raises(ValueError, match="must differ"):
        PipelineParallelWrapper(pnet, _mesh({"pipe": 8}), data_axis="pipe")
    with pytest.raises(ValueError, match="model_axis 'pipe' must differ"):
        PipelineParallelWrapper(pnet, _mesh({"pipe": 8}),
                                model_axis="pipe")
    pw = PipelineParallelWrapper(pnet, _mesh({"pipe": 8}))
    x, y = _mlp_data()[0]
    with pytest.raises(ValueError, match="masked batches"):
        pw.fit(DataSet(x, y, None, np.ones((16,), np.float32)))
    # 20 rows: trimmed to 16, still trains
    rng = np.random.default_rng(0)
    pw.fit(ListDataSetIterator([DataSet(
        rng.standard_normal((20, 12)).astype(np.float32),
        np.eye(5, dtype=np.float32)[rng.integers(0, 5, 20)])]))
    assert np.isfinite(pnet.score_value)
