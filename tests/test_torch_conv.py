"""The port's convolution shape math and its CNN and general layers held
against the JAX package on the CPU.

Each layer is built with the same arguments in both packages and given
the same seeded numpy inputs and parameters; the forward and the
gradients of a seeded cotangent (input and parameters) must agree to
1e-5 (f32; rtol = atol = 1e-5). BatchNormalization's running stats after
3 training forwards to 1e-6. Dropout and DropConnect draws never equal
the JAX package's threefry draws, so they are held by their statistics:
the keep rate, the 1 / keep scale, and the same mask for the same rng.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn.conf import layers as jl  # noqa: E402
from deeplearning4j_tpu.util import conv_utils as jcu  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as pl  # noqa: E402
from deeplearning4j_tpu_torch.ops.activations import Activation  # noqa: E402
from deeplearning4j_tpu_torch.util import conv_utils as pcu  # noqa: E402


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


# ------------------------------------------------------------ conv_utils
@pytest.mark.parametrize("mode", ["strict", "truncate", "same"])
def test_conv_output_shapes_equal_the_jax_package(mode):
    """Every (in, kernel, stride, pad, dilation) of a small grid gives the
    same output size and padding in both packages; Strict's mismatches
    raise the same ValueError."""
    for n in (5, 7, 8, 28):
        for k in (1, 2, 3, 5):
            for s in (1, 2, 3):
                for p in (0, 1, 2):
                    for d in (1, 2):
                        args = (n, k, s, p)
                        try:
                            want = jcu.output_size_1d(
                                *args, jcu.ConvolutionMode(mode), d)
                        except ValueError as e:
                            with pytest.raises(ValueError) as got:
                                pcu.output_size_1d(
                                    *args, pcu.ConvolutionMode(mode), d)
                            assert str(got.value) == str(e)
                            continue
                        assert pcu.output_size_1d(
                            *args, pcu.ConvolutionMode(mode), d) == want
                        assert pcu.explicit_padding(
                            (n, n + 1), (k, k), (s, s), (p, p),
                            pcu.ConvolutionMode(mode), (d, d)) == \
                            jcu.explicit_padding(
                                (n, n + 1), (k, k), (s, s), (p, p),
                                jcu.ConvolutionMode(mode), (d, d))


def test_same_padding_puts_the_extra_pad_at_the_end():
    assert pcu.same_padding_1d(8, 4, 1) == (1, 2)
    assert pcu.same_padding_1d(8, 3, 2) == (0, 1)
    assert pcu.same_padding_1d(7, 3, 2, dilation=2) == (2, 2)


# -------------------------------------------------------------- helpers
def _params(jlayer, it, seed):
    """Seeded random parameters of the JAX layer's shapes (biases and BN
    gamma/beta included, so every gradient is exercised)."""
    p = jlayer.init_params(jax.random.PRNGKey(0), it) \
        if jlayer.has_params else {}
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(np.shape(v)) * 0.5
                + (1.0 if k == "gamma" else 0.0)).astype(np.float32)
            for k, v in p.items()}


def _jax_run(jlayer, params, state, x, train, mask=None):
    out, st = jlayer.forward({k: jnp.asarray(v) for k, v in params.items()},
                             state, jnp.asarray(x), train=train, rng=None,
                             mask=None if mask is None else jnp.asarray(mask))
    return out, st


def _check_forward_and_grads(jlayer, player, it, x, *, train=False,
                             mask=None, seed=0, state=None, tol=TOL,
                             int_input=False):
    """Forward and the vjp of a seeded cotangent, input and parameters,
    in both packages."""
    params = _params(jlayer, it, seed)
    jstate = state if state is not None else jlayer.init_state(it)

    def jf(p, xx):
        return _jax_run(jlayer, p, jstate, xx, train, mask)[0]

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx = jnp.asarray(x)
    if int_input:
        jout, vjp = jax.vjp(lambda p: jf(p, jx), jp)
    else:
        jout, vjp = jax.vjp(jf, jp, jx)
    ct = np.random.default_rng(seed + 1).standard_normal(
        jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=not int_input)
    tm = None if mask is None else torch.tensor(mask)
    if player.stateful:
        tstate = {k: torch.tensor(np.asarray(v))
                  for k, v in jstate.items()}
        out, _ = player.forward_with_state(tp, tstate, tx, train=train,
                                           mask=tm)
    else:
        out = player.forward(tp, tx, train=train, mask=tm)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    leaves = list(tp.values()) + ([] if int_input else [tx])
    if not leaves:
        return
    g = torch.autograd.grad(out, leaves, torch.tensor(ct), allow_unused=True)
    for k, gk in zip(tp, g):
        np.testing.assert_allclose(gk.numpy(), np.asarray(jgrads[0][k]),
                                   err_msg=k, **tol)
    if not int_input:
        np.testing.assert_allclose(g[-1].numpy(), np.asarray(jgrads[1]),
                                   err_msg="input", **tol)


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(name, **kw):
    """The layer class `name` built with the same arguments in both
    packages (enum arguments given by value)."""
    jkw, pkw = {}, {}
    for k, v in kw.items():
        if k in ("convolution_mode", "pooling_type"):
            enum_name = "ConvolutionMode" if k == "convolution_mode" \
                else "PoolingType"
            jkw[k] = getattr(jcu, enum_name)(v)
            pkw[k] = getattr(pcu, enum_name)(v)
        elif k in ("activation", "expert_activation"):
            from deeplearning4j_tpu.ops.activations import (
                Activation as JAct,
            )
            jkw[k], pkw[k] = JAct(v), Activation(v)
        else:
            jkw[k] = pkw[k] = v
    return getattr(jl, name)(**jkw), getattr(pl, name)(**pkw)


def _cnn(h, w, c):
    from deeplearning4j_tpu.nn.conf.inputs import InputType

    return InputType.convolutional(h, w, c)


# ---------------------------------------------------------------- layers
CONV_CASES = {
    "truncate": dict(kernel=(3, 3), stride=(1, 1), padding=(1, 1),
                     convolution_mode="truncate"),
    "same_k4": dict(kernel=(4, 4), stride=(1, 1), convolution_mode="same"),
    "same_stride2": dict(kernel=(3, 3), stride=(2, 2),
                         convolution_mode="same"),
    "strict_stride2": dict(kernel=(3, 3), stride=(2, 2), padding=(0, 0),
                           convolution_mode="strict"),
    "dilation2": dict(kernel=(3, 3), stride=(1, 1), dilation=(2, 2),
                      convolution_mode="truncate"),
    "same_dilation2_stride2": dict(kernel=(3, 2), stride=(2, 2),
                                   dilation=(2, 2), convolution_mode="same"),
    "relu": dict(kernel=(5, 5), stride=(1, 1), activation="relu"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_forward_and_grads(case):
    kw = dict(CONV_CASES[case])
    kw.setdefault("activation", "identity")
    jlayer, player = _both("ConvolutionLayer", n_in=3, n_out=4, **kw)
    H, W = (9, 9) if "strict" in case else (8, 10)
    _check_forward_and_grads(jlayer, player, _cnn(H, W, 3), _x((2, H, W, 3)))


@pytest.mark.parametrize("mode", ["truncate", "same"])
@pytest.mark.parametrize("pool", ["max", "avg", "sum", "pnorm"])
def test_subsampling_forward_and_grads(pool, mode):
    """The four pooling types, with SAME's asymmetric padding (MAX pads
    with -inf; AVG divides by the whole window) and with explicit
    padding in Truncate mode; 3x3 windows at stride 2 on 7x8 maps, so
    windows overlap and SAME pads both sides."""
    jlayer, player = _both("SubsamplingLayer", pooling_type=pool,
                           kernel=(3, 3), stride=(2, 2),
                           padding=(1, 1) if mode == "truncate" else (0, 0),
                           convolution_mode=mode, pnorm=3)
    x = _x((2, 7, 8, 3)) - (0.0 if pool != "max" else 1.5)  # max: negative
    _check_forward_and_grads(jlayer, player, _cnn(7, 8, 3), x)


def test_max_pool_pads_with_minus_infinity():
    """All-negative inputs under SAME padding: a zero pad would win the
    border windows."""
    _, player = _both("SubsamplingLayer", pooling_type="max", kernel=(2, 2),
                      stride=(2, 2), convolution_mode="same")
    x = -1.0 - torch.rand(1, 3, 3, 1)
    y = player.forward({}, x)
    assert y.shape == (1, 2, 2, 1) and (y < 0).all()


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("shape", [(4, 5), (3, 4, 5, 6)], ids=["ff", "cnn"])
def test_batch_norm_forward_and_grads(shape, train):
    """Train mode (batch statistics, the shifted one-pass variance about a
    non-zero running mean) and eval mode (running stats), FF and NHWC."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType

    nf = shape[-1]
    jlayer, player = _both("BatchNormalization", n_in=nf, n_out=nf,
                           activation="identity")
    it = InputType.feed_forward(nf) if len(shape) == 2 \
        else _cnn(shape[1], shape[2], nf)
    rng = np.random.default_rng(11)
    state = {"mean": jnp.asarray(rng.standard_normal(nf).astype(np.float32)),
             "var": jnp.asarray(rng.uniform(0.5, 2, nf).astype(np.float32))}
    _check_forward_and_grads(jlayer, player, it, _x(shape) * 2 + 1,
                             train=train, state=state)


def test_batch_norm_running_stats_after_three_steps():
    """The biased batch variance and decay * old + (1 - decay) * batch:
    3 training forwards from the initial state, stats to 1e-6."""
    jlayer, player = _both("BatchNormalization", n_in=6, n_out=6,
                           decay=0.8, activation="identity")
    it = _cnn(4, 4, 6)
    params = _params(jlayer, it, 5)
    jst = jlayer.init_state(it)
    pst = player.init_state(it)
    for i in range(3):
        x = _x((3, 4, 4, 6), seed=20 + i) * 3 + 2
        _, jst = _jax_run(jlayer, params, jst, x, True)
        _, pst = player.forward_with_state(
            {k: torch.tensor(v) for k, v in params.items()}, pst,
            torch.tensor(x), train=True)
    for k in ("mean", "var"):
        np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # F.batch_norm's unbiased running variance would differ here
    assert not np.allclose(pst["var"].numpy(), 1.0)


def test_batch_norm_lock_gamma_beta_and_flags():
    jlayer, player = _both("BatchNormalization", n_in=3, n_out=3,
                           lock_gamma_beta=True, activation="identity")
    _check_forward_and_grads(jlayer, player, _cnn(2, 2, 3), _x((2, 2, 2, 3)),
                             train=True)
    bn = pl.BatchNormalization(n_in=3)
    assert bn.param_flags("gamma") == {"is_bias": False,
                                       "regularizable": False}
    assert bn.param_flags("beta") == {"is_bias": True, "regularizable": False}


@pytest.mark.parametrize("n", [3, 4, 5])
def test_local_response_normalization(n):
    jlayer, player = _both("LocalResponseNormalization", n=n, alpha=0.3,
                           beta=0.75, k=1.5)
    _check_forward_and_grads(jlayer, player, _cnn(3, 4, 7),
                             _x((2, 3, 4, 7)))


@pytest.mark.parametrize("pool", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("masked", [False, True])
def test_global_pooling_rnn_with_mask(pool, masked):
    from deeplearning4j_tpu.nn.conf.inputs import InputType

    jlayer, player = _both("GlobalPoolingLayer", pooling_type=pool, pnorm=3)
    mask = None
    if masked:
        mask = np.ones((3, 6), np.float32)
        mask[0, 4:] = 0
        mask[2, 1:] = 0
    _check_forward_and_grads(jlayer, player, InputType.recurrent(5, 6),
                             _x((3, 6, 5)), mask=mask)


@pytest.mark.parametrize("pool", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_cnn(pool):
    jlayer, player = _both("GlobalPoolingLayer", pooling_type=pool, pnorm=2)
    _check_forward_and_grads(jlayer, player, _cnn(3, 4, 5), _x((2, 3, 4, 5)))


@pytest.mark.parametrize("name,kw", [
    ("ActivationLayer", dict(activation="tanh")),
    ("ActivationLayer", dict(activation="softmax")),
    ("LossLayer", dict(activation="sigmoid")),
    ("DropoutLayer", dict(dropout=0.5)),
], ids=["activation_tanh", "activation_softmax", "loss", "dropout_eval"])
def test_parameter_free_layers(name, kw):
    from deeplearning4j_tpu.nn.conf.inputs import InputType

    jlayer, player = _both(name, **kw)
    _check_forward_and_grads(jlayer, player, InputType.feed_forward(6),
                             _x((4, 6)))


def test_loss_layer_scores_equal():
    from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
    from deeplearning4j_tpu_torch.ops.losses import LossFunction as PLoss

    from deeplearning4j_tpu.ops.activations import Activation as JAct

    jlayer = jl.LossLayer(loss=JLoss.MCXENT, activation=JAct.SOFTMAX)
    player = pl.LossLayer(loss=PLoss.MCXENT, activation=Activation.SOFTMAX)
    x = _x((5, 4))
    labels = np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 1]]
    want = float(jlayer.loss_score({}, jnp.asarray(x), jnp.asarray(labels)))
    got = float(player.loss_score({}, torch.tensor(x), torch.tensor(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(
        player.score_array({}, torch.tensor(x), torch.tensor(labels)).numpy(),
        np.asarray(jlayer.score_array({}, jnp.asarray(x),
                                      jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("shape", [(5,), (5, 1)])
def test_embedding_layer(shape):
    from deeplearning4j_tpu.nn.conf.inputs import InputType

    jlayer, player = _both("EmbeddingLayer", n_in=7, n_out=3,
                           activation="tanh")
    ids = np.array([0, 6, 3, 3, 1]).reshape(shape).astype(np.int32)
    _check_forward_and_grads(jlayer, player, InputType.feed_forward(7), ids,
                             int_input=True)


# --------------------------------------------------- dropout statistics
def test_dropout_layer_statistics():
    """Keep rate 1 - p, kept values scaled by 1 / (1 - p), the same mask
    for the same rng and another for another rng."""
    layer = pl.DropoutLayer(dropout=0.3)
    x = torch.ones(200, 500)
    y = layer.forward({}, x, train=True, rng=(1, 2, 3))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(y, layer.forward({}, x, train=True, rng=(1, 2, 3)))
    assert not torch.equal(y, layer.forward({}, x, train=True,
                                            rng=(1, 2, 4)))
    assert torch.equal(layer.forward({}, x, train=False, rng=(1, 2, 3)), x)


def test_drop_connect_masks_the_weights_not_the_input():
    """DropConnect: the dense layer's W takes the mask (keep rate, 1/keep
    scale, deterministic per rng) while the input is left whole; without
    training it is the plain product."""
    layer = pl.DenseLayer(n_in=300, n_out=400, dropout=0.25,
                          use_drop_connect=True,
                          activation=Activation.IDENTITY)
    W = torch.ones(300, 400)
    p = {"W": W, "b": torch.zeros(400)}
    x = torch.eye(300)  # rows of the output are rows of the masked W
    y = layer.pre_output(p, x, train=True, rng=(7, 0, 1))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(y, layer.pre_output(p, x, train=True, rng=(7, 0, 1)))
    assert torch.equal(layer.pre_output(p, x, train=False), x @ W)
    # input dropout instead: a dropped input unit zeroes a whole row
    plain = pl.DenseLayer(n_in=300, n_out=400, dropout=0.25,
                          activation=Activation.IDENTITY)
    rows = plain.pre_output(p, x, train=True, rng=(7, 0, 1))
    assert ((rows == 0).all(dim=1) | (rows != 0).all(dim=1)).all()
