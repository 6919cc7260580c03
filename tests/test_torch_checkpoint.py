"""Checkpoint zips between the port and the JAX package, with the
optimizer state: a zip written by either package restores in the other
(`coefficients.npy`, `updaterState.npy` in ravel order, `meta.json` with
the iteration and epoch), and both then take one more Adam step to
equal parameters (the f32 tolerance of tests/test_torch_training.py:
rtol = atol = 1e-5, stated there). A ComputationGraph's zip (ResNet's
tiny network after Nesterovs steps: node-keyed parameters, optimizer
state and BatchNormalization state, flattened in sorted node order)
crosses both ways with identical values and then trains on to the same
parameters and running stats (1e-5); `restore_model` reads the model
type, and the typed restores refuse the other type."""
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


def _graph_pair_after_steps(n_steps):
    from deeplearning4j_tpu.models.resnet import resnet_tiny_configuration
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    jnet = JGraph(resnet_tiny_configuration(n_classes=4))
    jnet.init()
    for x, y in _images(n_steps, seed=10):
        jnet.fit(JDataSet(x, y))
    return jnet


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, 4)])
            for _ in range(n)]


def _assert_graph_trees_equal(jnet, pnet):
    np.testing.assert_array_equal(pnet.params().numpy(), jnet.params())
    for name, st in jnet._upd_state.items():
        for k in st:
            for sk in st[k]:
                np.testing.assert_array_equal(
                    pnet._upd_state[name][k][sk].numpy(),
                    np.asarray(st[k][sk]), err_msg=f"{name} {k}.{sk}")
    for name, st in jnet._layer_state.items():
        for k in st:
            np.testing.assert_array_equal(pnet._layer_state[name][k].numpy(),
                                          np.asarray(st[k]))
    assert (jnet.iteration, jnet.epoch) == (pnet.iteration, pnet.epoch)


def _train_on_and_compare(jnet, pnet):
    for x, y in _images(2, seed=11):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    for name, jp in jnet._params.items():
        for k in jp:
            np.testing.assert_allclose(pnet._params[name][k].numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} {k}")
    for name, st in jnet._layer_state.items():
        for k in st:
            np.testing.assert_allclose(pnet._layer_state[name][k].numpy(),
                                       np.asarray(st[k]), rtol=1e-5,
                                       atol=1e-5)


def test_jax_written_graph_zip_restores_in_port_and_trains_on(tmp_path):
    jnet = _graph_pair_after_steps(2)
    path = tmp_path / "graph.zip"
    jser.write_model(jnet, path)
    pnet = pser.restore_computation_graph(path, device="cpu")
    _assert_graph_trees_equal(jnet, pnet)
    assert type(pser.restore_model(path, device="cpu")).__name__ == \
        "ComputationGraph"
    _train_on_and_compare(jnet, pnet)


def test_port_written_graph_zip_restores_in_jax_and_trains_on(tmp_path):
    from deeplearning4j_tpu_torch.models.resnet import (
        resnet_tiny_configuration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    pnet = ComputationGraph(resnet_tiny_configuration(n_classes=4),
                            device="cpu")
    pnet.init()
    for x, y in _images(2, seed=12):
        pnet.fit(DataSet(x, y))
    path = tmp_path / "graph.zip"
    pser.write_model(pnet, path)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
    assert meta["model_type"] == "ComputationGraph"
    jnet = jser.restore_computation_graph(path)
    _assert_graph_trees_equal(jnet, pnet)
    assert type(jser.restore_model(path)).__name__ == "ComputationGraph"
    back = pser.restore_model(path, device="cpu")
    assert torch.equal(back.params(), pnet.params())
    _train_on_and_compare(jnet, pnet)


def test_typed_restores_refuse_the_other_model_type(tmp_path):
    jnet = _graph_pair_after_steps(1)
    graph_zip = tmp_path / "graph.zip"
    jser.write_model(jnet, graph_zip)
    with pytest.raises(ValueError, match="restore_computation_graph"):
        pser.restore_multi_layer_network(graph_zip, device="cpu")
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jgpt(**GPT).to_json()), device="cpu")
    mln_zip = tmp_path / "mln.zip"
    pser.write_model(net, mln_zip)
    with pytest.raises(ValueError, match="restore_multi_layer_network"):
        pser.restore_computation_graph(mln_zip, device="cpu")
    assert isinstance(pser.restore_model(mln_zip, device="cpu"),
                      MultiLayerNetwork)
    graph_zip.write_bytes(graph_zip.read_bytes()[:300])
    with pytest.raises(pser.CheckpointCorruptError):
        pser.restore_computation_graph(graph_zip, device="cpu")
