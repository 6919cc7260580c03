"""Checkpoint zips between the port and the JAX package, with the
optimizer state: a zip written by either package restores in the other
(`coefficients.npy`, `updaterState.npy` in ravel order, `meta.json` with
the iteration and epoch), and both then take one more Adam step to
equal parameters (the f32 tolerance of tests/test_torch_training.py:
rtol = atol = 1e-5, stated there)."""
import io
import json
import zipfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.flatten_util import ravel_pytree  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    gpt_configuration as jgpt,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.util import serialization as pser  # noqa: E402

V, T, B = 32, 256, 2
GPT = dict(vocab_size=V, d_model=128, n_heads=1, n_layers=1, max_length=T,
           attention_block_size=128)


def _batches(n, seed):
    ids = np.random.default_rng(seed).integers(0, V, (n, B, T + 1))
    return [(ids[i, :, :-1].astype(np.int32), ids[i, :, 1:].astype(np.int32))
            for i in range(n)]


def _port_net_like(jnet):
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(pser.params_from_jax(
        pnet.conf, jax.tree.map(np.asarray, jnet._params)))
    pnet.set_updater_state(pser.updater_state_from_jax(
        pnet.conf, jax.tree.map(np.asarray, jnet._upd_state)))
    return pnet


def _assert_same(jnet, pnet):
    for a, b in zip(jnet._params, pnet._params):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    assert (jnet.iteration, jnet.epoch) == (pnet.iteration, pnet.epoch)


def test_port_written_zip_restores_in_jax_and_trains_on(tmp_path):
    jnet = JaxNet(jgpt(**GPT))
    jnet.init()
    pnet = _port_net_like(jnet)
    for x, y in _batches(2, seed=0):
        pnet.fit(DataSet(x, y))
    path = tmp_path / "port.zip"
    pser.write_model(pnet, path)
    with zipfile.ZipFile(path) as z:
        assert set(z.namelist()) >= {"configuration.json", "coefficients.npy",
                                     "updaterState.npy", "layerState.npy",
                                     "meta.json"}
        meta = json.loads(z.read("meta.json"))
        upd = np.load(io.BytesIO(z.read("updaterState.npy")))
    assert meta["iteration"] == 2 and meta["dtype"] == "float32"
    restored = jser.restore_multi_layer_network(path)
    assert upd.shape == ravel_pytree(restored._upd_state)[0].shape
    np.testing.assert_array_equal(restored.params(), pnet.params().numpy())
    x, y = _batches(1, seed=1)[0]
    restored.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    _assert_same(restored, pnet)


def test_jax_written_zip_restores_in_port_and_trains_on(tmp_path):
    jnet = JaxNet(jgpt(**GPT))
    jnet.init()
    for x, y in _batches(2, seed=2):
        jnet.fit(JDataSet(x, y))
    path = tmp_path / "jax.zip"
    jser.write_model(jnet, path)
    pnet = pser.restore_multi_layer_network(path, device="cpu")
    assert pnet.iteration == 2
    np.testing.assert_array_equal(pnet.params().numpy(), jnet.params())
    for a, b in zip(jnet._upd_state, pnet.get_updater_state()):
        for k in a:
            for sk in a[k]:
                np.testing.assert_array_equal(b[k][sk].numpy(),
                                              np.asarray(a[k][sk]))
    x, y = _batches(1, seed=3)[0]
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    _assert_same(jnet, pnet)
    fresh = pser.restore_multi_layer_network(path, load_updater=False,
                                             device="cpu")
    assert all((t == 0).all() for layer in fresh.get_updater_state()
               for st in layer.values() for t in st.values())


def test_port_round_trip_and_damage(tmp_path):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jgpt(**GPT).to_json()), device="cpu")
    net.init()
    net.fit(DataSet(*_batches(1, seed=4)[0]))
    path = tmp_path / "m.zip"
    pser.write_model(net, path)
    back = pser.restore_multi_layer_network(path, device="cpu")
    assert torch.equal(back.params(), net.params()) and back.iteration == 1
    for a, b in zip(net.get_updater_state(), back.get_updater_state()):
        for k in a:
            for sk in a[k]:
                assert torch.equal(a[k][sk], b[k][sk])
    assert not any(p.name.startswith(".") for p in tmp_path.iterdir())
    path.write_bytes(path.read_bytes()[:200])
    with pytest.raises(pser.CheckpointCorruptError):
        pser.restore_multi_layer_network(path, device="cpu")
