"""The port's training slice held against the JAX package on the CPU.

A 2-layer GPT (vocab 64, d_model 256, 2 heads of 128, T=256,
attention_block_size=128, so every block's attention takes the flash
route in the port and the blockwise route in the JAX package on the CPU)
starts from the JAX network's weights and Adam moments
(`params_from_jax`, `updater_state_from_jax`) and trains 3 steps in both
packages on batches made with numpy from a seed.

Tolerances (f32): per-step losses rtol 1e-5. Parameters rtol = 1e-5 and
atol = 1e-5 (1/30 of the learning rate 3e-4): Adam's step is about lr per
element whatever the gradient's size, so an element whose gradient is
near zero (the K bias, whose exact gradient is 0 under softmax shift
invariance, is the extreme) moves by a fraction of lr that depends on
the last bits of its gradient, and the two packages sum in different
orders. SGD parameters: rtol = atol = 1e-5. bf16 compute: losses rtol
2e-2 and parameters atol 3.6e-3 = 2 * 6 * lr: bf16 keeps 8 bits of
mantissa and the packages round at different places (the JAX package's
XLA fusions against PyTorch's eager ops), so gradients agree to a few
bf16 ulps; each of the six Adam steps moves an element by about lr at
most, so an element whose gradient is noise (the K bias again) may step
the other way in the other package.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    gpt_configuration as jgpt,
)
from deeplearning4j_tpu.nn import updater as jupd  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.ops import losses as jlosses  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.models.transformer import (  # noqa: E402
    gpt_configuration,
)
from deeplearning4j_tpu_torch.nn import updater as pupd  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf import layers as players  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.ops import losses as plosses  # noqa: E402
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


V, T, B = 64, 256, 2
GPT = dict(vocab_size=V, d_model=256, n_heads=2, n_layers=2, max_length=T,
           attention_block_size=128)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(compute_dtype=None, **kw):
    """A JAX network and the port's network carrying its weights and
    optimizer state."""
    jnet = JaxNet(jgpt(**{**GPT, **kw}),
                  compute_dtype=None if compute_dtype is None
                  else jnp.bfloat16)
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        compute_dtype=compute_dtype, device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, _np_tree(jnet._params)))
    pnet.set_updater_state(updater_state_from_jax(
        pnet.conf, _np_tree(jnet._upd_state)))
    return jnet, pnet


def _batches(n, seed=0):
    ids = np.random.default_rng(seed).integers(0, V, (n, B, T + 1))
    return [(ids[i, :, :-1].astype(np.int32), ids[i, :, 1:].astype(np.int32))
            for i in range(n)]


def _train_both(jnet, pnet, batches):
    jl, pl = [], []
    for x, y in batches:
        jnet.fit(JDataSet(x, y))
        jl.append(jnet.score_value)
        pnet.fit(DataSet(x, y))
        pl.append(pnet.score_value)
    return np.array(jl), np.array(pl)


def _params_close(jnet, pnet, rtol, atol):
    for i, (a, b) in enumerate(zip(jnet._params, pnet._params)):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"layer {i} {k}")


def test_fit_adam_f32_matches_jax():
    jnet, pnet = _pair()
    fa.reset_counts()
    jl, pl = _train_both(jnet, pnet, _batches(3))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _params_close(jnet, pnet, rtol=1e-5, atol=1e-5)
    for a, b in zip(jnet._upd_state, pnet.get_updater_state()):
        for k in a:
            for sk in a[k]:
                ref = np.asarray(a[k][sk])  # moments: 1e-4 of the largest
                np.testing.assert_allclose(b[k][sk].numpy(), ref, rtol=1e-4,
                                           atol=1e-4 * np.abs(ref).max())
    # every block's attention took the flash route (plain version on CPU)
    assert fa.flash_attention_plain_fwd.calls == 3 * 2
    assert fa.flash_attention_plain_bwd.calls == 3 * 2
    assert pnet.iteration == jnet.iteration == 3


def test_fit_sgd_f32_matches_jax():
    from deeplearning4j_tpu.nn.updater import Updater as JUpdater

    jnet, pnet = _pair(updater=JUpdater.SGD, learning_rate=0.05)
    jl, pl = _train_both(jnet, pnet, _batches(3, seed=1))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _params_close(jnet, pnet, rtol=1e-5, atol=1e-5)


def test_fit_bf16_compute_matches_jax_loosely():
    jnet, pnet = _pair(compute_dtype=torch.bfloat16)
    jl, pl = _train_both(jnet, pnet, _batches(6, seed=2))
    np.testing.assert_allclose(pl, jl, rtol=2e-2)
    _params_close(jnet, pnet, rtol=0, atol=3.6e-3)
    assert all(p[k].dtype == torch.float32 for p in pnet._params for k in p)


def test_output_longer_than_block_size_matches_jax():
    """T=256 > block_size=128: the case the serving slice raised on."""
    jnet, pnet = _pair()
    ids = np.random.default_rng(3).integers(0, V, (2, T)).astype(np.int32)
    np.testing.assert_allclose(pnet.output(ids).numpy(), jnet.output(ids),
                               rtol=1e-5, atol=1e-5)


def test_score_and_gradient_match_jax():
    jnet, pnet = _pair()
    x, y = _batches(1, seed=4)[0]
    assert abs(pnet.score(DataSet(x, y)) - jnet.score(JDataSet(x, y))) \
        < 1e-5 * 5
    pg, ps = pnet.compute_gradient_and_score(DataSet(x, y))
    jg, js = jnet.compute_gradient_and_score(JDataSet(x, y))
    assert abs(ps - js) < 1e-4
    np.testing.assert_allclose(pg, jg, rtol=1e-4, atol=1e-6)


def test_remat_equals_no_remat():
    """TransformerBlock(remat=True) recomputes the block in the backward
    (torch.utils.checkpoint), dropout masks included: one step gives the
    same loss, and the same params up to the order of the f32 gradient
    sums that cross the checkpoint (atol 1e-7)."""
    nets = []
    for remat in (False, True):
        net = MultiLayerNetwork(gpt_configuration(**{**GPT, "remat": remat,
                                                     "n_layers": 1,
                                                     "dropout": 0.1}),
                                device="cpu")
        net.init()
        net.fit(DataSet(*_batches(1, seed=5)[0]))
        nets.append(net)
    assert nets[0].score_value == nets[1].score_value
    torch.testing.assert_close(nets[0].params(), nets[1].params(), rtol=0,
                               atol=1e-7)


def test_fit_iterator_epochs_and_listeners():
    class Listener:
        def __init__(self):
            self.seen, self.epochs = [], 0

        def iteration_done(self, net, it):
            self.seen.append((it, net.score_value))

        def on_epoch_end(self, net):
            self.epochs += 1

    net = MultiLayerNetwork(gpt_configuration(16, d_model=16, n_heads=2,
                                              n_layers=1, max_length=16),
                            device="cpu")
    lis = Listener()
    net.set_listeners(lis)
    ids = np.random.default_rng(6).integers(0, 16, (8, 17))
    data = DataSet(ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))
    net.fit(ListDataSetIterator([data], batch_size=4), epochs=2)
    assert [s for s, _ in lis.seen] == [1, 2, 3, 4]
    assert lis.epochs == 2 and net.epoch == 2 and net.iteration == 4
    assert all(np.isfinite(v) for _, v in lis.seen)
    net.fit(ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32),
            scan_steps=4)
    assert net.iteration == 5
    with pytest.raises(ValueError, match="out of range"):
        net.fit(DataSet(data.features, data.labels + 16))


def test_unported_training_paths_raise_naming_the_queue():
    """What queues A2 and A9b ported now runs: layerwise pretraining
    (a network with no pretraining layer keeps its parameters),
    `evaluate`, the health sentinel, a normalizer refused (as the JAX
    package refuses it) by a network whose first layer consumes token
    ids, truncated BPTT and an LBFGS fit."""
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        ImagePreProcessingScaler,
    )
    from deeplearning4j_tpu_torch.optimize.health import HealthSentinel

    net = MultiLayerNetwork(gpt_configuration(16, d_model=16, n_heads=2,
                                              n_layers=1, max_length=16),
                            device="cpu")
    ids = np.random.default_rng(3).integers(0, 16, (2, 9))
    data = DataSet(ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))
    before = net.params().clone()
    net.pretrain(data)
    assert torch.equal(net.params(), before)
    ev = net.evaluate(data)
    assert ev.confusion_matrix.sum() == 16 and ev.num_classes == 16
    with pytest.raises(ValueError, match="integer token ids"):
        net.set_normalizer(ImagePreProcessingScaler())
    sentinel = HealthSentinel()
    net.set_health_sentinel(sentinel)
    net.fit(data)
    assert net.get_health_sentinel() is sentinel
    assert sentinel.counters()["steps"] == 1
    conf = gpt_configuration(16, d_model=16, n_heads=2, n_layers=1,
                             max_length=16)
    conf.tbptt_fwd_length = 4
    x = np.zeros((1, 16), np.int32)
    tnet = MultiLayerNetwork(conf, device="cpu")
    tnet.fit(x, x)   # truncated BPTT is ported: 4 windows of 4 steps
    assert tnet.iteration == 4 and np.isfinite(tnet.score_value)
    conf = MultiLayerConfiguration.from_json(conf.to_json())
    conf.tbptt_fwd_length = -1
    conf.global_conf.optimization_algo = type(
        conf.global_conf.optimization_algo)("lbfgs")
    lnet = MultiLayerNetwork(conf, device="cpu")
    lnet.fit(x, x)   # the line-search solvers are ported (queue A2)
    assert lnet.iteration == 1 and np.isfinite(lnet.score_value)


# ------------------------------------------------------------- updaters
_UPDATERS = ["sgd", "adam", "adamax", "nadam", "adadelta", "nesterovs",
             "adagrad", "rmsprop", "none"]


@pytest.mark.parametrize("name", _UPDATERS)
def test_apply_updater_matches_jax(name):
    rng = np.random.default_rng(7)
    cfg_j = jupd.UpdaterConfig(updater=jupd.Updater(name), learning_rate=0.01)
    cfg_p = pupd.UpdaterConfig.from_json(cfg_j.to_json())
    param = rng.standard_normal((5, 7)).astype(np.float32)
    grad = rng.standard_normal((5, 7)).astype(np.float32)
    state_j = {k: jnp.asarray(np.abs(rng.standard_normal((5, 7)))
                              .astype(np.float32))
               for k in jupd.init_updater_state(cfg_j, jnp.asarray(param))}
    state_p = {k: torch.from_numpy(np.array(v)) for k, v in state_j.items()}
    for it in (0, 3):
        lr = jupd.scheduled_lr(cfg_j, 0.01, jnp.asarray(it))
        new_j, upd_j = jupd.apply_updater(cfg_j, state_j, jnp.asarray(grad),
                                          lr, jnp.asarray(it))
        new_p, upd_p = pupd.apply_updater(cfg_p, state_p,
                                          torch.from_numpy(grad),
                                          pupd.scheduled_lr(cfg_p, 0.01, it),
                                          it)
        np.testing.assert_allclose(upd_p.numpy(), np.asarray(upd_j),
                                   rtol=1e-6, atol=1e-9)
        for k in new_j:
            np.testing.assert_allclose(new_p[k].numpy(), np.asarray(new_j[k]),
                                       rtol=1e-6, atol=1e-9)
        state_j = new_j


@pytest.mark.parametrize("policy", [p.value for p in jupd.LearningRatePolicy])
def test_scheduled_lr_matches_jax(policy):
    kw = dict(lr_policy=jupd.LearningRatePolicy(policy),
              lr_policy_decay_rate=0.9, lr_policy_power=0.75,
              lr_policy_steps=3.0, lr_schedule={2: 0.05, 5: 0.01})
    cfg_j = jupd.UpdaterConfig(**kw)
    cfg_p = pupd.UpdaterConfig.from_json(cfg_j.to_json())
    for it in (0, 1, 2, 4, 7):
        np.testing.assert_allclose(
            pupd.scheduled_lr(cfg_p, 0.1, it),
            float(jupd.scheduled_lr(cfg_j, 0.1, jnp.asarray(it))), rtol=1e-6)


@pytest.mark.parametrize("gn", [g.value for g in jupd.GradientNormalization])
def test_normalize_gradients_matches_jax(gn):
    rng = np.random.default_rng(8)
    grads = {k: rng.standard_normal(s).astype(np.float32) * 3
             for k, s in (("W", (6, 4)), ("b", (4,)))}
    cfg_j = jupd.UpdaterConfig(gradient_normalization=jupd.
                               GradientNormalization(gn),
                               gradient_normalization_threshold=0.5)
    cfg_p = pupd.UpdaterConfig.from_json(cfg_j.to_json())
    got = pupd.normalize_gradients(cfg_p, {k: torch.from_numpy(v)
                                           for k, v in grads.items()})
    want = jupd.normalize_gradients(cfg_j, {k: jnp.asarray(v)
                                            for k, v in grads.items()})
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_regularization_score_matches_jax():
    from deeplearning4j_tpu.nn.conf import layers as jlayers

    rng = np.random.default_rng(9)
    params = {"W": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    kw = dict(n_in=4, n_out=3, l1=0.01, l2=0.02, l1_bias=0.03, l2_bias=0.04)
    want = jupd.regularization_score([(jlayers.DenseLayer(**kw), {
        k: jnp.asarray(v) for k, v in params.items()})])
    got = pupd.regularization_score([(players.DenseLayer(**kw), {
        k: torch.from_numpy(v) for k, v in params.items()})])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------------- losses
_LOSS_ACTS = {
    "mse": "identity", "l1": "tanh", "l2": "identity", "xent": "sigmoid",
    "mcxent": "softmax", "negativeloglikelihood": "softmax",
    "cosine_proximity": "tanh", "hinge": "identity",
    "squared_hinge": "identity", "kl_divergence": "softmax",
    "mean_absolute_error": "identity",
    "mean_absolute_percentage_error": "identity",
    "mean_squared_logarithmic_error": "sigmoid", "poisson": "softplus"}


@pytest.mark.parametrize("loss", sorted(_LOSS_ACTS))
def test_loss_per_row_matches_jax(loss):
    rng = np.random.default_rng(10)
    pre = rng.standard_normal((6, 5)).astype(np.float32)
    if loss in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    elif loss in ("hinge", "squared_hinge"):
        labels = np.sign(rng.standard_normal((6, 5))).astype(np.float32)
    elif loss in ("xent", "mean_squared_logarithmic_error", "poisson"):
        labels = rng.uniform(0, 1, (6, 5)).astype(np.float32)
    else:
        labels = rng.standard_normal((6, 5)).astype(np.float32)
    act = _LOSS_ACTS[loss]
    got = plosses.loss_per_row(loss, act, torch.from_numpy(labels),
                               torch.from_numpy(pre))
    want = jlosses.loss_per_row(loss, act, jnp.asarray(labels),
                                jnp.asarray(pre))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    mask = (rng.uniform(size=6) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        float(plosses.loss_score(loss, act, torch.from_numpy(labels),
                                 torch.from_numpy(pre),
                                 torch.from_numpy(mask))),
        float(jlosses.loss_score(loss, act, jnp.asarray(labels),
                                 jnp.asarray(pre), jnp.asarray(mask))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("loss", ["mcxent", "negativeloglikelihood"])
def test_sparse_labels_match_jax_and_one_hot(loss):
    rng = np.random.default_rng(11)
    pre = rng.standard_normal((3, 4, 7)).astype(np.float32)
    ids = rng.integers(0, 7, (3, 4)).astype(np.int32)
    got = plosses.loss_per_row(loss, "softmax", torch.from_numpy(ids),
                               torch.from_numpy(pre))
    want = jlosses.loss_per_row(loss, "softmax", jnp.asarray(ids),
                                jnp.asarray(pre))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    dense = plosses.loss_per_row(loss, "softmax",
                                 torch.from_numpy(np.eye(7, dtype=np.float32)
                                                  [ids]),
                                 torch.from_numpy(pre))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="integer class-id"):
        plosses.loss_per_row("mse", "identity", torch.from_numpy(ids),
                             torch.from_numpy(pre))
    with pytest.raises(ValueError, match="out of range"):
        plosses.check_sparse_label_range(ids + 7, 7)
    mask = np.zeros((3, 4), np.float32)
    plosses.check_sparse_label_range(ids + 7, 7, mask=mask)  # all masked


def test_precision_wire_and_restore():
    from deeplearning4j_tpu_torch.nn.precision import (
        restore_dtypes,
        wire_asarray,
    )

    ids = np.array([[300.0, 7.9]], np.float32)
    assert wire_asarray(ids, torch.bfloat16, "cpu", as_ids=True).tolist() \
        == [[300, 7]]
    assert wire_asarray(ids, torch.bfloat16, "cpu").dtype == torch.bfloat16
    u8 = wire_asarray(np.zeros(3, np.uint8), torch.float32, "cpu")
    assert u8.dtype == torch.uint8
    tree = [{"a": torch.zeros(2, dtype=torch.bfloat16)}]
    back = restore_dtypes(tree, [{"a": torch.zeros(2)}])
    assert back[0]["a"].dtype == torch.float32


# -------------------------------------------------------------- dropout
def test_dropout_p0_is_exact_and_p_positive_is_inverted_and_seeded():
    layer = players.DenseLayer(n_in=64, n_out=8, dropout=0.0)
    x = torch.randn(256, 64)
    params = {"W": torch.eye(64)[:, :8].contiguous(), "b": torch.zeros(8)}
    assert torch.equal(layer.pre_output(params, x, train=True, rng=(1, 2)),
                       layer.pre_output(params, x))
    layer.dropout = 0.25
    ones = torch.ones(4096, 64)
    y = layer._maybe_dropout(ones, True, (7, 0, 3))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.all((y == 0) | (y == 1 / 0.75))
    assert abs(y.mean().item() - 1.0) < 0.02  # inverted: E[y] = x
    assert torch.equal(y, layer._maybe_dropout(ones, True, (7, 0, 3)))
    assert not torch.equal(y, layer._maybe_dropout(ones, True, (7, 1, 3)))
    assert torch.equal(layer._maybe_dropout(ones, False, (7, 0, 3)), ones)
