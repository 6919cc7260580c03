"""The port stands alone: importing `deeplearning4j_tpu_torch`, serving
from it (also with int8 KV, the prefix cache and speculative decoding,
and behind `ModelServer` with a hot reload),
training with it (fit through the flash-attention route, a checkpoint
written and restored) and running the recurrent path (a GravesLSTM
char-RNN fit with truncated BPTT, then streamed with rnn_time_step on
uint8 ids through the OneHotEncoder; the training loop with an async
iterator, the health sentinel, listeners and checkpoints, then evaluate,
restore, a statistics normalizer and an LBFGS fit; a CNN with
BatchNormalization state through a checkpoint, LeNet, a SelfAttention
classifier on the flash route, an MoE GPT trained and generated from;
ResNet's tiny network as a ComputationGraph fit, saved and restored, a
masked tBPTT graph streamed with rnn_time_step, an AutoEncoder, RBM and
VAE stack pretrained layer by layer, a gradient check)
loads neither `jax` nor any module of `deeplearning4j_tpu`, and
its entry points run on the card by default, raising where there is
none rather than carrying on quietly on the CPU."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.transformer import (
    generate,
    gpt_configuration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import DecodeEngine, ModelServer
from deeplearning4j_tpu_torch.util.serialization import (
    restore_multi_layer_network,
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


REPO = Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import deeplearning4j_tpu_torch
    from deeplearning4j_tpu_torch.models.transformer import (
        generate, gpt_configuration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    from deeplearning4j_tpu_torch.util import serialization  # noqa: F401

    net = MultiLayerNetwork(gpt_configuration(16, d_model=16, n_heads=2,
                                              n_layers=1, max_length=32),
                            device="cpu")
    net.init()
    prompt = np.arange(5) % 16
    eng = DecodeEngine(net, n_slots=1, max_len=24, prompt_buckets=(8,),
                       prefill_chunk=8, page_size=8, device="cpu")
    try:
        got = eng.generate(np.arange(12) % 16, 3)
    finally:
        eng.shutdown()
    want = generate(net, (np.arange(12) % 16)[None], 3, temperature=0.0,
                    device="cpu")[0]
    assert (got == want).all(), (got, want)

    # the latency and quantization tier: int8 KV, prefix cache, a draft
    from deeplearning4j_tpu_torch.serving import (  # noqa: F401
        prefix_cache, quantize, speculative)
    eng = DecodeEngine(net, n_slots=2, max_len=24, prompt_buckets=(4,),
                       prefill_chunk=8, page_size=8, device="cpu",
                       quantize={"kv": "int8"}, prefix_cache=True,
                       speculative={"draft": "self", "k": 2})
    try:
        first = eng.generate(np.arange(12) % 16, 3)
        again = eng.generate(np.arange(12) % 16, 3)
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert (first == again).all(), (first, again)
    assert stats["prefix_cache"]["hits"] == 1, stats
    assert stats["speculative"]["verify_steps"] >= 1, stats
    assert stats["kv_quant_bits"] == 8, stats

    import os
    import tempfile
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.util.serialization import (
        restore_multi_layer_network, write_model)

    tnet = MultiLayerNetwork(gpt_configuration(16, d_model=128, n_heads=1,
                                               n_layers=1, max_length=256,
                                               attention_block_size=128),
                             device="cpu")
    ids = np.arange(2 * 257).reshape(2, 257) % 16
    data = DataSet(ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))
    tnet.fit(ListDataSetIterator([data]), epochs=2)
    assert tnet.iteration == 2 and np.isfinite(tnet.score_value)
    assert fa.flash_attention_plain_bwd.calls == 2
    with tempfile.TemporaryDirectory() as d:
        write_model(tnet, os.path.join(d, "m.zip"))
        back = restore_multi_layer_network(os.path.join(d, "m.zip"),
                                           device="cpu")
    assert back.iteration == 2

    from deeplearning4j_tpu_torch.datasets.normalizers import OneHotEncoder
    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.ops import lstm
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.ops.losses import LossFunction

    rconf = (C.NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
             .updater("rmsprop").list()
             .layer(C.GravesLSTM(n_in=8, n_out=16, activation=Activation.TANH))
             .layer(C.RnnOutputLayer(n_out=8, loss=LossFunction.MCXENT,
                                     activation=Activation.SOFTMAX))
             .set_input_type(C.InputType.recurrent(8))
             .t_bptt_forward_length(3).build())
    rnet = MultiLayerNetwork(rconf, device="cpu")
    ids = np.arange(2 * 8).reshape(2, 8) % 8
    rnet.fit(DataSet(np.eye(8, dtype=np.float32)[ids[:, :-1]],
                     ids[:, 1:].astype(np.int32)))   # 3 tBPTT windows
    assert rnet.iteration == 3 and np.isfinite(rnet.score_value)
    assert lstm.lstm_bwd_plain.calls == 3
    rnet.set_normalizer(OneHotEncoder(8))             # uint8 ids from here
    assert rnet.rnn_time_step(ids[:, 0].astype(np.uint8)).shape == (2, 8)

    # the training loop: async iterator, sentinel, listeners, checkpoints,
    # evaluate, restore, a statistics normalizer and a line-search solver
    from deeplearning4j_tpu_torch import eval as _eval  # noqa: F401
    from deeplearning4j_tpu_torch.datasets.iterators import (
        AsyncDataSetIterator)
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        NormalizerStandardize)
    from deeplearning4j_tpu_torch.optimize import (
        CheckpointListener, HealthSentinel, ScoreIterationListener)
    from deeplearning4j_tpu_torch.util.checkpoint_store import (
        CheckpointStore)
    from deeplearning4j_tpu_torch.util.serialization import restore_model

    lnet = MultiLayerNetwork(rconf, device="cpu")
    lnet.set_health_sentinel(HealthSentinel())
    with tempfile.TemporaryDirectory() as d:
        lnet.set_listeners(ScoreIterationListener(1),
                           CheckpointListener(d, every_n_iterations=1))
        x = np.eye(8, dtype=np.float32)[ids[:, :-1]]
        y = ids[:, 1:].astype(np.int32)
        lnet.fit(AsyncDataSetIterator(ListDataSetIterator(
            [DataSet(x, y)] * 2)))
        assert lnet.evaluate(DataSet(x, y)).confusion_matrix.sum() == 14
        back, step = CheckpointStore(d).load_latest_verified(
            lambda p: restore_model(p, device="cpu"))
    assert step == 6 and back.iteration == 6
    back.set_normalizer(NormalizerStandardize().fit(DataSet(x, y)))
    back.conf.global_conf.optimization_algo = type(
        back.conf.global_conf.optimization_algo)("lbfgs")
    back.conf.tbptt_fwd_length = 0
    back.fit(DataSet(x, y))
    assert back.iteration == 7 and np.isfinite(back.score_value)

    # serving behind ModelServer: predict, generate, a hot reload from a
    # checkpoint store, the breaker, metrics and the flight recorder
    from deeplearning4j_tpu_torch.serving import ModelServer
    srv = ModelServer(net, generation={"n_slots": 1, "max_len": 24,
                                       "prompt_buckets": (8,)})
    try:
        probs = srv.predict((np.arange(10) % 16)[None])
        tokens = srv.generate(np.arange(5) % 16, 3)
        with tempfile.TemporaryDirectory() as d:
            store = CheckpointStore(d)
            store.save(1, lambda tmp: write_model(net, tmp, atomic=False))
            assert srv.reload(store) == 1
        assert (srv.generate(np.arange(5) % 16, 3) == tokens).all()
        assert "dl4j_model_server_predict_latency_ms" in srv.metrics_text()
        assert srv.flight_record()["events"]
    finally:
        assert srv.shutdown()
    assert probs.shape == (1, 10, 16)
    # the CNN and MoE slice: LeNet, a CNN with BatchNormalization state
    # through a checkpoint, a SelfAttention classifier on the flash route, an
    # MoE GPT trained, generated from and served
    from deeplearning4j_tpu_torch.models import lenet_configuration
    from deeplearning4j_tpu_torch.nn.conf import preprocessors  # noqa: F401
    from deeplearning4j_tpu_torch.nn.conf.layers import TokenEmbedding
    from deeplearning4j_tpu_torch.ops import aux_loss  # noqa: F401
    from deeplearning4j_tpu_torch.parallel import experts  # noqa: F401
    from deeplearning4j_tpu_torch.util import conv_utils  # noqa: F401

    cnet = MultiLayerNetwork(lenet_configuration(), device="cpu")
    imgs = (np.arange(2 * 784).reshape(2, 784) % 255).astype(np.uint8)
    cnet.fit(DataSet(imgs, np.eye(10, dtype=np.float32)[[1, 2]]))
    assert np.isfinite(cnet.score_value)
    bconf = (C.NeuralNetConfiguration.Builder().seed(1).list()
             .layer(C.ConvolutionLayer(n_out=2, kernel=(3, 3)))
             .layer(C.BatchNormalization(activation="identity"))
             .layer(C.OutputLayer(n_out=3, activation="softmax"))
             .set_input_type(C.InputType.convolutional_flat(6, 6, 1))
             .build())
    bnet = MultiLayerNetwork(bconf, device="cpu")
    bnet.fit(DataSet(np.ones((4, 36), np.float32),
                     np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]))
    with tempfile.TemporaryDirectory() as d:
        write_model(bnet, os.path.join(d, "b.zip"))
        bback = restore_multi_layer_network(os.path.join(d, "b.zip"),
                                            device="cpu")
    assert (bback._layer_state[1]["var"] == bnet._layer_state[1]["var"]).all()
    anet = MultiLayerNetwork(
        C.NeuralNetConfiguration.Builder().list()
        .layer(TokenEmbedding(n_in=16, n_out=128, max_length=256))
        .layer(C.SelfAttention(n_in=128, n_out=128, block_size=128))
        .layer(C.GlobalPoolingLayer())
        .layer(C.OutputLayer(n_out=2, activation="softmax"))
        .set_input_type(C.InputType.recurrent(16)).build(), device="cpu")
    calls = fa.flash_attention_plain_fwd.calls
    anet.fit(DataSet((np.arange(512).reshape(2, 256) % 16).astype(np.int32),
                     np.eye(2, dtype=np.float32)))
    assert fa.flash_attention_plain_fwd.calls > calls
    mnet = MultiLayerNetwork(gpt_configuration(16, d_model=16, n_heads=2,
                                               n_layers=1, max_length=32,
                                               moe_experts=2), device="cpu")
    ids = np.arange(2 * 9).reshape(2, 9) % 16
    mnet.fit(DataSet(ids[:, :-1].astype(np.int32),
                     ids[:, 1:].astype(np.int32)))
    assert generate(mnet, ids[:, :4], 3, temperature=0.0,
                    device="cpu").shape == (2, 3)

    # the graph and pretraining slice: ResNet's tiny network as a graph
    # through a checkpoint, a masked tBPTT graph streamed, a pretrained
    # AutoEncoder / RBM / VAE stack, a gradient check
    import torch
    from deeplearning4j_tpu_torch import gradientcheck
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models import resnet_tiny_configuration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util import time_series  # noqa: F401
    from deeplearning4j_tpu_torch.util.serialization import (
        restore_computation_graph)

    gnet = ComputationGraph(resnet_tiny_configuration(n_classes=2),
                            device="cpu")
    gnet.fit(DataSet(np.ones((2, 8, 8, 3), np.float32),
                     np.eye(2, dtype=np.float32)))
    with tempfile.TemporaryDirectory() as d:
        write_model(gnet, os.path.join(d, "g.zip"))
        gback = restore_computation_graph(os.path.join(d, "g.zip"),
                                          device="cpu")
    assert torch.equal(gback.params(), gnet.params())
    tconf = (C.NeuralNetConfiguration.Builder().seed(1).graph_builder()
             .add_inputs("in")
             .add_layer("lstm", C.GravesLSTM(n_in=8, n_out=16), "in")
             .add_layer("out", C.RnnOutputLayer(n_in=16, n_out=8,
                                                activation="softmax"), "lstm")
             .set_outputs("out").t_bptt_forward_length(3).build())
    tnet = ComputationGraph(tconf, device="cpu")
    mask = np.ones((2, 7), np.float32)
    mask[1, 5:] = 0
    tids = np.arange(16).reshape(2, 8) % 8
    x = np.eye(8, dtype=np.float32)[tids[:, :-1]]
    tnet.fit(MultiDataSet([x], [tids[:, 1:].astype(np.int32)],
                          features_masks=[mask], labels_masks=[mask]))
    calls = lstm.lstm_bwd_plain.calls
    assert tnet.iteration == 3 and calls >= 6
    assert tnet.rnn_time_step(x)[0].shape == (2, 7, 8)
    pconf = (C.NeuralNetConfiguration.Builder().seed(2).list()
             .layer(C.AutoEncoder(n_out=6))
             .layer(C.RBM(n_out=4))
             .layer(C.VariationalAutoencoder(n_out=2))
             .layer(C.OutputLayer(n_out=2, activation="softmax"))
             .set_input_type(C.InputType.feed_forward(8)).build())
    pnet = MultiLayerNetwork(pconf, device="cpu")
    pnet.pretrain(DataSet(np.eye(8, dtype=np.float32), None), epochs=2)
    assert np.isfinite(pnet.score_value)
    gc = MultiLayerNetwork(pconf, dtype=torch.float64, device="cpu")
    assert gradientcheck.check_gradients(
        gc, DataSet(np.eye(8), np.eye(2)[np.arange(8) % 2]), subset=20)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "deeplearning4j_tpu"
                    or m.startswith("deeplearning4j_tpu."))
    print("LEAKED", leaked)
    sys.exit(1 if leaked else 0)
""")


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


def test_no_port_source_names_jax():
    """No module of the port, and none of its card scripts
    (`chip_*.py`), imports jax or the JAX package."""
    bad = []
    for path in [*(REPO / "deeplearning4j_tpu_torch").rglob("*.py"),
                 *REPO.glob("chip_*.py")]:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")) and (
                    s.split()[1].split(".")[0] in ("jax", "deeplearning4j_tpu")):
                bad.append(f"{path.name}: {s}")
    assert not bad, bad


def _tiny_net(device):
    conf = gpt_configuration(16, d_model=16, n_heads=2, n_layers=1,
                             max_length=32)
    return MultiLayerNetwork(conf, device=device)


def test_entry_points_default_to_the_card():
    """Without `device`, each entry point asks for CUDA: on a machine
    without a card it raises; with one it runs there."""
    cpu_net = _tiny_net("cpu")
    cpu_net.init()
    # ModelServer serves on its network's device, and so does the engine
    # it builds: a CPU network is served on the CPU
    srv = ModelServer(cpu_net, generation={"n_slots": 1, "max_len": 24,
                                           "prompt_buckets": (8,)})
    try:
        assert srv.generate(np.arange(3), 2).shape == (2,)
        assert srv._engine.device.type == "cpu"
    finally:
        srv.shutdown()
    if torch.cuda.is_available():
        assert MultiLayerNetwork(cpu_net.conf).device.type == "cuda"
        with pytest.raises(ValueError, match="lives on"):
            DecodeEngine(cpu_net)
        with pytest.raises(ValueError, match="lives on"):
            generate(cpu_net, np.zeros((1, 3), np.int32), 2)
        return
    conf = cpu_net.conf
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(cpu_net)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cpu_net, np.zeros((1, 3), np.int32), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_multi_layer_network(REPO / "no-such.zip")
    from deeplearning4j_tpu_torch.models import resnet_tiny_configuration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.serialization import (
        restore_computation_graph,
    )

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputationGraph(resnet_tiny_configuration())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_computation_graph(REPO / "no-such.zip")
