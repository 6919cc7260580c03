"""The port's inference export (`util.stablehlo_export`: a torch
`ExportedProgram` written by `torch.export.save`) against the JAX
package's StableHLO export, on the same weights.

Held: the loaded artifact equals the network's `output` bit for bit
(tolerance 0, CPU) and the JAX package's exported artifact within 1e-6
(f32); the normalizer and the wire dtype are inside; the artifact is
frozen (training on does not change it); a graph exports with its inputs
and outputs. The kernels that `output` reaches are registered ops
(`dl4j::flash_attention_fwd`, `dl4j::lstm_fwd`, `dl4j::lstm_fwd_masked`)
and the exported graph holds each as one op, whose body on a CPU tensor
is the plain version (counted)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    DenseLayer,
    GravesLSTM,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu.ops.activations import Activation  # noqa: E402
from deeplearning4j_tpu.util import stablehlo_export as jexp  # noqa: E402

from deeplearning4j_tpu_torch.datasets.normalizers import (  # noqa: E402
    ImagePreProcessingScaler,
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
from deeplearning4j_tpu_torch.ops import lstm as plstm  # noqa: E402
from deeplearning4j_tpu_torch.util import stablehlo_export as pexp  # noqa: E402
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs (the tier runs
    several pytest-xdist workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(conf):
    jnet = dl4j.MultiLayerNetwork(conf)
    jnet.init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, jnet._params))
    return jnet, pnet


def _mlp():
    return (dl4j.NeuralNetConfiguration.Builder().seed(5).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_in=12, n_out=16, activation=Activation.RELU))
            .layer(OutputLayer(n_in=16, n_out=3,
                               activation=Activation.SOFTMAX))
            .build())


def _data(n=64):
    rng = np.random.default_rng(0)
    c = rng.integers(0, 3, n)
    x = (rng.normal(size=(n, 12)) * 0.4 + c[:, None]).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[c]


def test_mln_round_trip_against_the_jax_export(tmp_path):
    jnet, pnet = _pair(_mlp())
    x, y = _data()
    pnet.fit(x, y)
    jnet.fit(JDataSet(x, y))
    p = tmp_path / "serve.pt2"
    blob = pexp.export_inference(pnet, x[:8], path=str(p))
    assert p.read_bytes() == blob and len(blob) > 100
    run = pexp.load_inference(str(p))
    got = run(x[:8])
    np.testing.assert_array_equal(got, pnet.output(x[:8]).numpy())
    jrun = jexp.load_inference(jexp.export_inference(jnet, x[:8]))
    np.testing.assert_allclose(got, jrun(x[:8]), rtol=TOL, atol=TOL)
    # frozen: training on does not change the artifact
    pnet.fit(*_data(32))
    np.testing.assert_array_equal(got, run(x[:8]))
    assert not np.array_equal(got, pnet.output(x[:8]).numpy())


def test_the_normalizer_and_the_wire_dtype_are_inside():
    """uint8 wire + the /255 normalizer: the artifact takes the raw wire
    dtype and matches output() bit for bit (and the JAX package's)."""
    conf = (dl4j.NeuralNetConfiguration.Builder().seed(2).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_in=8, n_out=8, activation=Activation.RELU))
            .layer(OutputLayer(n_in=8, n_out=2,
                               activation=Activation.SOFTMAX))
            .build())
    from deeplearning4j_tpu.datasets.normalizers import (
        ImagePreProcessingScaler as JScaler,
    )

    jnet, pnet = _pair(conf)
    jnet.set_normalizer(JScaler())
    pnet.set_normalizer(ImagePreProcessingScaler())
    raw = np.arange(32, dtype=np.uint8).reshape(4, 8)
    run = pexp.load_inference(pexp.export_inference(pnet, raw))
    np.testing.assert_array_equal(run(raw), pnet.output(raw).numpy())
    np.testing.assert_allclose(run(raw), np.asarray(jnet.output(raw)),
                               rtol=TOL, atol=TOL)


def test_a_graph_exports_with_its_inputs():
    from deeplearning4j_tpu.nn.conf.computation_graph_configuration import (
        MergeVertex,
    )
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import (  # noqa: E501
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = (dl4j.NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .graph_builder()
            .add_inputs("a", "b")
            .add_layer("da", DenseLayer(n_in=4, n_out=8), "a")
            .add_layer("db", DenseLayer(n_in=6, n_out=8), "b")
            .add_vertex("m", MergeVertex(), "da", "db")
            .add_layer("out", OutputLayer(n_in=16, n_out=2,
                                          activation=Activation.SOFTMAX),
                       "m")
            .set_outputs("out").build())
    jnet = JGraph(conf)
    jnet.init()
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, jnet._params))
    rng = np.random.default_rng(0)
    xa = rng.normal(size=(8, 4)).astype(np.float32)
    xb = rng.normal(size=(8, 6)).astype(np.float32)
    got = pexp.load_inference(pexp.export_inference(pnet, [xa, xb]))(xa, xb)
    want = pnet.output(xa, xb)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_allclose(got[0], np.asarray(jnet.output(xa, xb)[0]),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="2 inputs"):
        pexp.export_inference(pnet, [xa])


def test_platforms_name_the_devices_the_artifact_is_built_for():
    _, pnet = _pair(_mlp())
    x, _ = _data(4)
    run = pexp.load_inference(pexp.export_inference(
        pnet, x, platforms=("cuda", "cpu")))
    np.testing.assert_array_equal(run(x), pnet.output(x).numpy())
    with pytest.raises(ValueError, match="asked for"):
        pexp.export_inference(pnet, x, platforms=("cuda",))


def test_a_gpt_exports_the_flash_kernel_as_one_op():
    """A GPT past its attention block size: `output` takes the flash
    route, and the exported graph holds `dl4j::flash_attention_fwd`, one
    a layer; the loaded artifact runs it (the plain version on the CPU,
    counted) and equals output bit for bit."""
    conf = gpt_configuration(vocab_size=32, d_model=256, n_heads=2,
                             n_layers=2, max_length=256,
                             attention_block_size=128, seed=4)
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    ids = np.random.default_rng(1).integers(0, 32, (1, 256)).astype(np.int32)
    blob = pexp.export_inference(net, ids)
    import io

    graph = str(torch.export.load(io.BytesIO(blob)).graph)
    assert graph.count("dl4j.flash_attention_fwd") == 2
    run = pexp.load_inference(blob)
    calls = fa.flash_attention_plain_fwd.calls
    got = run(ids)
    assert fa.flash_attention_plain_fwd.calls == calls + 2
    np.testing.assert_array_equal(got, net.output(ids).numpy())


def test_an_lstm_exports_the_fused_forward_as_one_op():
    """A GravesLSTM char model (sigmoid gates, tanh cell): the exported
    graph holds `dl4j::lstm_fwd`; the masked forward is
    `dl4j::lstm_fwd_masked` (exported through `lstm_fused` with a mask).
    Both equal the JAX package's outputs within 1e-6."""
    conf = (dl4j.NeuralNetConfiguration.Builder().seed(6).learning_rate(0.1)
            .list()
            .layer(GravesLSTM(n_in=5, n_out=8, activation=Activation.TANH))
            .layer(RnnOutputLayer(n_in=8, n_out=5,
                                  activation=Activation.SOFTMAX))
            .build())
    jnet, pnet = _pair(conf)
    x = np.random.default_rng(2).normal(size=(3, 7, 5)).astype(np.float32)
    blob = pexp.export_inference(pnet, x)
    import io

    assert "dl4j.lstm_fwd.default" in str(torch.export.load(
        io.BytesIO(blob)).graph)
    calls = plstm.lstm_fwd_plain.calls
    got = pexp.load_inference(blob)(x)
    assert plstm.lstm_fwd_plain.calls == calls + 1
    np.testing.assert_array_equal(got, pnet.output(x).numpy())
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), rtol=TOL,
                               atol=TOL)

    p = pnet._params[0]

    class Masked(torch.nn.Module):
        def forward(self, xx, m):
            return plstm.lstm_fused(xx, p["W"], p["RW"], p["b"],
                                    None, None, None, mask=m)[0]

    m = torch.ones((3, 7))
    m[1, 4:] = 0.0
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ep = torch.export.export(Masked(), (xt, m))
        assert "dl4j.lstm_fwd_masked.default" in str(ep.graph)
        np.testing.assert_array_equal(ep.module()(xt, m).numpy(),
                                      Masked()(xt, m).numpy())
