"""Configuration JSON round-trips between the JAX package and the port
(`deeplearning4j_tpu_torch/nn/conf`): a `gpt_configuration` written by
either package parses in the other and re-serializes to the same text,
for the gelu/MHA stack and the swiglu + RoPE + GQA stack."""
import json

import numpy as np
import pytest

pytest.importorskip("jax")

from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (  # noqa: E402
    MultiLayerConfiguration as JaxConf,
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

VARIANTS = {
    "gelu_mha": dict(vocab_size=48, d_model=32, n_heads=2, n_layers=2,
                     max_length=64),
    "swiglu_rope_gqa": dict(vocab_size=48, d_model=32, n_heads=4,
                            n_layers=2, max_length=64, n_kv_heads=2,
                            rope=True, ffn_activation="swiglu"),
    "flagship_width": dict(vocab_size=256, d_model=1024, n_heads=8,
                           n_layers=8, max_length=4224),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_jax_json_parses_and_reserializes_equal(name):
    text = jax_gpt_configuration(**VARIANTS[name]).to_json()
    assert MultiLayerConfiguration.from_json(text).to_json() == text


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_port_json_parses_in_jax_and_reserializes_equal(name):
    text = gpt_configuration(**VARIANTS[name]).to_json()
    assert JaxConf.from_json(text).to_json() == text


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_builders_write_the_same_json(name):
    assert gpt_configuration(**VARIANTS[name]).to_json() == \
        jax_gpt_configuration(**VARIANTS[name]).to_json()


def test_unported_layer_type_is_refused_by_name():
    """Every layer type of the JAX package parses now (the pretraining
    family, queue A9b, was the last); a type neither package knows is
    refused naming it."""
    from deeplearning4j_tpu.models.lenet import lenet_configuration
    from deeplearning4j_tpu.nn import conf as JC

    text = lenet_configuration().to_json()
    assert MultiLayerConfiguration.from_json(text).to_json() == text
    jconf = (JC.NeuralNetConfiguration.Builder().list()
             .layer(JC.AutoEncoder(n_in=4, n_out=3))
             .layer(JC.OutputLayer(n_in=3, n_out=2)).build())
    text = jconf.to_json()
    assert MultiLayerConfiguration.from_json(text).to_json() == text
    with pytest.raises(KeyError, match="unknown layer type 'capsule'"):
        MultiLayerConfiguration.from_json(text.replace('"autoencoder"',
                                                       '"capsule"'))


@pytest.mark.parametrize("kw,match", [
    # MoE blocks were ported with queue A9: they build and run now
    pytest.param({"moe_experts": 2}, None, id="kw0-A9"),
    pytest.param({"remat": True}, None, id="kw1-training slice")])
def test_unported_block_options_parse_but_refuse_to_run(kw, match):
    """moe_experts > 0 and remat=True configurations round-trip, build
    and run (MoE ported with queue A9, remat with the training slice);
    an option still to port would raise NotImplementedError naming its
    ROADMAP item when built."""
    text = jax_gpt_configuration(vocab_size=16, d_model=16, n_heads=2,
                                 n_layers=1, max_length=8, **kw).to_json()
    conf = MultiLayerConfiguration.from_json(text)
    assert json.loads(conf.to_json()) == json.loads(text)
    net = MultiLayerNetwork(conf, device="cpu")
    if match is None:
        net.init()
        assert net.output(np.zeros((1, 8), np.int32)).shape == (1, 8, 16)
        return
    with pytest.raises(NotImplementedError, match=match):
        net.init()
