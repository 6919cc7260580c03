"""ResNet on the port's ComputationGraph held against the JAX package on
the CPU.

Every depth (18 to 152, the CIFAR and ImageNet stems) and the tiny test
network write the JAX package's JSON, which parses back in both
packages; the node types the builder resolves are the JAX package's.
ResNet-50 has the JAX package's parameter count (shapes from
`jax.eval_shape`, nothing drawn) and 16 residual add vertices. The tiny
network from the JAX network's weights: its forward within 1e-6, then 3
Nesterovs steps in f32 with per-step losses within 1e-5 relative and the
parameters and every BatchNormalization running mean and variance within
1e-5 (rtol = atol); the running stats move on every step and are
committed once a step. Init is held by its statistics: ReLU init's
standard deviation sqrt(2 / fan_in) within 10%.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.models import resnet as jresnet  # noqa: E402
from deeplearning4j_tpu.nn.graph import (  # noqa: E402
    ComputationGraph as JGraph,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.models import resnet as presnet  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import (  # noqa: E402,E501
    ComputationGraphConfiguration,
    ElementWiseVertex,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.util import serialization as pser  # noqa: E402

TOL = 1e-5


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


CONFIGS = {
    "resnet18": dict(depth=18), "resnet34": dict(depth=34),
    "resnet50": dict(depth=50), "resnet101": dict(depth=101),
    "resnet152": dict(depth=152, n_classes=100),
    "resnet18-imagenet": dict(depth=18, height=64, width=64),
    "resnet50-narrow": dict(depth=50, stage_filters=(8, 16, 32, 64)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_resnet_configurations_write_the_jax_json(name):
    text = jresnet.resnet_configuration(**CONFIGS[name]).to_json()
    port = presnet.resnet_configuration(**CONFIGS[name])
    assert port.to_json() == text
    assert ComputationGraphConfiguration.from_json(text).to_json() == text
    from deeplearning4j_tpu.nn.conf.computation_graph_configuration import (
        ComputationGraphConfiguration as JConf,
    )

    assert JConf.from_json(port.to_json()).to_json() == text


def test_resnet_tiny_json_and_unknown_depth():
    assert presnet.resnet_tiny_configuration().to_json() == \
        jresnet.resnet_tiny_configuration().to_json()
    with pytest.raises(ValueError, match="unsupported resnet depth"):
        presnet.resnet_configuration(depth=42)


def _jax_param_count(conf) -> int:
    """The JAX package's parameter count from `jax.eval_shape` of each
    layer's init (nothing is drawn)."""
    total = 0
    for name in conf.topological_order:
        node = conf.nodes[name]
        if not (node.is_layer and node.layer.has_params):
            continue
        it = conf.resolved_types.get(node.inputs[0])
        if node.preprocessor is not None:
            it = node.preprocessor.output_type(it)
        shapes = jax.eval_shape(
            lambda k, layer=node.layer, it=it: layer.init_params(
                k, it, jnp.float32), jax.random.PRNGKey(0))
        total += sum(math.prod(s.shape) for s in shapes.values())
    return total


def test_resnet50_parameter_count_and_residual_adds():
    conf = presnet.resnet_configuration(depth=50, n_classes=10)
    g = ComputationGraph(conf, device="cpu")
    g.init()
    n = g.num_params()
    assert n == _jax_param_count(jresnet.resnet_configuration(depth=50,
                                                              n_classes=10))
    assert 20_000_000 < n < 30_000_000
    adds = [name for name, node in conf.nodes.items()
            if isinstance(node.vertex, ElementWiseVertex)]
    assert len(adds) == 16 and all(a.endswith("_add") for a in adds)
    assert sum(1 for _, layer in g._layer_slots()
               if type(layer).__name__ == "ConvolutionLayer") == 53
    assert set(g._layer_state["stem_bn"]) == {"mean", "var"}


def test_resnet_imagenet_stem_resolved_types():
    kw = dict(depth=18, n_classes=10, height=64, width=64)
    port = presnet.resnet_configuration(**kw)
    ref = jresnet.resnet_configuration(**kw)
    assert "stem_pool" in port.nodes
    it = port.resolved_types["stem_pool"]
    assert (it.height, it.width) == (16, 16)
    assert {k: str(v) for k, v in port.resolved_types.items()} == \
        {k: str(v) for k, v in ref.resolved_types.items()}


def _cifar_like(n, seed, h=8, w=8, c=3, classes=10):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    X = rng.normal(size=(n, h, w, c)).astype(np.float32) * 0.5
    X += y[:, None, None, None] / classes
    return X, np.eye(classes, dtype=np.float32)[y]


def test_resnet_tiny_trains_as_the_jax_package_with_running_stats():
    jnet = JGraph(jresnet.resnet_tiny_configuration())
    jnet.init()
    pnet = ComputationGraph(presnet.resnet_tiny_configuration(), device="cpu")
    pnet.set_param_tree(pser.params_from_jax(pnet.conf, jnet._params))
    pnet.set_layer_state(pser.params_from_jax(pnet.conf, jnet._layer_state))
    X, y = _cifar_like(16, seed=0)
    np.testing.assert_allclose(pnet.output(X)[0].numpy(), jnet.output(X)[0],
                               rtol=1e-6, atol=1e-6)
    assert pnet.summary() == jnet.summary()
    prev = pnet._layer_state["s1u0_proj_bn"]["mean"].clone()
    for step in range(3):
        x, t = _cifar_like(16, seed=step + 1)
        jnet.fit(JDataSet(x, t))
        pnet.fit(DataSet(x, t))
        assert pnet.score_value == pytest.approx(jnet.score_value, rel=TOL)
        now = pnet._layer_state["s1u0_proj_bn"]["mean"]
        assert not torch.equal(now, prev)
        prev = now.clone()
    for name, jp in jnet._params.items():
        for k in jp:
            np.testing.assert_allclose(pnet._params[name][k].numpy(),
                                       np.asarray(jp[k]), rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {k}")
    for name, js in jnet._layer_state.items():
        for k in js:
            np.testing.assert_allclose(pnet._layer_state[name][k].numpy(),
                                       np.asarray(js[k]), rtol=TOL, atol=TOL,
                                       err_msg=f"{name} state {k}")
    np.testing.assert_allclose(pnet.output(X)[0].numpy(), jnet.output(X)[0],
                               rtol=TOL, atol=1e-6)


def test_resnet_tiny_bf16_keeps_f32_masters_and_stats():
    g = ComputationGraph(presnet.resnet_tiny_configuration(),
                         compute_dtype=torch.bfloat16, device="cpu")
    g.init()
    for step in range(2):
        g.fit(DataSet(*_cifar_like(8, seed=step)))
        assert np.isfinite(g.score_value)
    assert all(v.dtype == torch.float32 for p in g._params.values()
               for v in p.values())
    assert g._layer_state["stem_bn"]["var"].dtype == torch.float32


def test_resnet_init_statistics():
    g = ComputationGraph(presnet.resnet_configuration(
        depth=18, stage_filters=(16, 32, 64, 128)), device="cpu")
    g.init()
    W = g._params["s3u1_a_conv"]["W"]        # 3x3x128x128, ReLU init
    fan_in = W.shape[0] * W.shape[1] * W.shape[2]
    assert float(W.std()) == pytest.approx(math.sqrt(2.0 / fan_in), rel=0.1)
    assert float(W.mean()) == pytest.approx(0.0, abs=0.01)
    assert torch.equal(g._params["s3u1_a_bn"]["gamma"],
                       torch.ones(128))
