"""The port's transformer modules held against the JAX package at small
size (vocab 48, d_model 32, 2 layers): `layer_norm`, `rope_rotate`,
`full_attention(_grouped)`, `_block_heads`, `_block_ffn`,
`MultiLayerNetwork.output`, greedy `generate`, and a checkpoint zip
written by the JAX package and restored by the port.

Weights are bridged from the JAX network (`params_from_jax`), never
drawn from a shared seed. Inputs are made with numpy from a seed and fed
to both sides as float32 / int32. f32 tolerance: atol = rtol = 1e-5.
Greedy tokens must be identical.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtr  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers as jlayers  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.ops import attention as jatt  # noqa: E402
from deeplearning4j_tpu.ops import rope as jrope  # noqa: E402
from deeplearning4j_tpu.util.serialization import write_model  # noqa: E402
from deeplearning4j_tpu_torch.models import transformer as ptr  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as players  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import attention as patt  # noqa: E402
from deeplearning4j_tpu_torch.ops import rope as prope  # noqa: E402
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    CheckpointCorruptError,
    params_from_jax,
    restore_multi_layer_network,
)

TOL = 1e-5
VOCAB = 48
VARIANTS = {
    "gelu_mha": dict(n_heads=2),
    "swiglu_rope_gqa": dict(n_heads=4, n_kv_heads=2, rope=True,
                            ffn_activation="swiglu"),
}


def _pair(**kw):
    """A JAX network and the port's network carrying its weights."""
    kw = dict(dict(vocab_size=VOCAB, d_model=32, n_layers=2, max_length=64),
              **kw)
    jnet = JaxNet(jtr.gpt_configuration(**kw))
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    return jnet, pnet


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return _pair(**VARIANTS[request.param])


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    _close(players.layer_norm(*map(torch.from_numpy, (x, g, b))),
           jlayers.layer_norm(*map(jnp.asarray, (x, g, b))))


def test_rope_rotate_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 100
    cos, sin = prope.rope_angles(torch.from_numpy(pos), 16)
    jcos, jsin = jrope.rope_angles(jnp.asarray(pos), 16)
    _close(cos, jcos)
    _close(prope.rope_rotate(torch.from_numpy(x), cos, sin),
           jrope.rope_rotate(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("Hkv", [4, 2])
def test_full_attention_matches_jax(Hkv):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, Hkv, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, Hkv, 8)).astype(np.float32)
    fp = patt.full_attention if Hkv == 4 else patt.full_attention_grouped
    fj = jatt.full_attention if Hkv == 4 else jatt.full_attention_grouped
    for causal in (False, True):
        _close(fp(*map(torch.from_numpy, (q, k, v)), causal=causal),
               fj(*map(jnp.asarray, (q, k, v)), causal=causal))


def test_block_heads_and_ffn_match_jax(pair):
    jnet, pnet = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    for i in (1, 2):
        jl, pl = jnet.layers[i], pnet.layers[i]
        for got, ref in zip(
                ptr._block_heads(pl, pnet._params[i], torch.from_numpy(x),
                                 torch.from_numpy(pos)),
                jtr._block_heads(jl, jnet._params[i], jnp.asarray(x),
                                 jnp.asarray(pos))):
            _close(got, ref)
        _close(ptr._block_ffn(pl, pnet._params[i], torch.from_numpy(x)),
               jtr._block_ffn(jl, jnet._params[i], jnp.asarray(x)))


def test_flat_params_match_jax_ravel_order(pair):
    jnet, pnet = pair
    np.testing.assert_array_equal(pnet.params().numpy(), jnet.params())


def test_output_matches_jax(pair):
    jnet, pnet = pair
    ids = np.random.default_rng(4).integers(0, VOCAB, (3, 9)).astype(np.int32)
    _close(pnet.output(ids), jnet.output(ids))


def test_greedy_generate_matches_jax(pair):
    jnet, pnet = pair
    prompts = np.random.default_rng(5).integers(0, VOCAB, (3, 6)) \
        .astype(np.int32)
    expected = jtr.generate(jnet, prompts, 8, temperature=0.0)
    got = ptr.generate(pnet, prompts, 8, temperature=0.0, device="cpu")
    np.testing.assert_array_equal(got, expected)
    full = ptr.generate(pnet, prompts, 8, temperature=0.0,
                        include_prompt=True, device="cpu")
    np.testing.assert_array_equal(full, np.concatenate([prompts, got], 1))


def test_sampled_generate_deterministic_and_top_k():
    """Sampled decoding: the same seed gives the same tokens, and top_k=1
    truncates to the greedy argmax (torch generators never reproduce JAX
    keys, so no token equality with the JAX package is asked)."""
    _, pnet = _pair(n_heads=2)
    prompts = np.random.default_rng(6).integers(0, VOCAB, (2, 4))
    a = ptr.generate(pnet, prompts, 10, temperature=1.0, seed=3,
                     device="cpu")
    b = ptr.generate(pnet, prompts, 10, temperature=1.0, seed=3,
                     device="cpu")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        ptr.generate(pnet, prompts, 10, temperature=0.7, top_k=1, seed=9,
                     device="cpu"),
        ptr.generate(pnet, prompts, 10, temperature=0.0, device="cpu"))
    logits = torch.tensor([[0.0, 5.0, 4.0, -1.0]])
    kept = ptr._top_k_filter(logits, 2)
    assert torch.isinf(kept[0, [0, 3]]).all() and kept[0, 1] == 5.0


def test_jax_written_zip_restores_to_same_logits(tmp_path):
    jnet, _ = _pair(**VARIANTS["swiglu_rope_gqa"])
    path = tmp_path / "gpt.zip"
    write_model(jnet, path)
    pnet = restore_multi_layer_network(path, device="cpu")
    ids = np.random.default_rng(7).integers(0, VOCAB, (2, 7)).astype(np.int32)
    _close(pnet.output(ids), jnet.output(ids))
    path.write_bytes(path.read_bytes()[:100])
    with pytest.raises(CheckpointCorruptError):
        restore_multi_layer_network(path, device="cpu")


def test_weight_init_statistics():
    """Init draws from a torch generator: checked by its statistics
    (xavier std sqrt(2/(fan_in+fan_out)), positional table std 0.02, LN
    ones/zeros), and reproducible per seed."""
    conf = ptr.gpt_configuration(vocab_size=256, d_model=256, n_heads=4,
                                 n_layers=1, max_length=512)
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    W = net._params[1]["Wqkv"]
    assert abs(W.std().item() / np.sqrt(2.0 / (256 + 768)) - 1) < 0.02
    assert abs(W.mean().item()) < 2e-3
    assert abs(net._params[0]["P"].std().item() / 0.02 - 1) < 0.02
    assert (net._params[1]["ln1_g"] == 1).all()
    assert (net._params[1]["bqkv"] == 0).all()
    again = MultiLayerNetwork(conf, device="cpu")
    again.init()
    assert torch.equal(again.params(), net.params())
