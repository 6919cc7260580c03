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
VAE stack pretrained layer by layer, a gradient check; early stopping,
the determinism check and a profiler trace; QoS lanes, a warm migration,
a cluster prefix fetch and disaggregated serving; the gateway wire, a
remote replica behind a chaos proxy; a MNIST fetcher batch, a Word2Vec
fit, the native word count and a serialized table; a DeepWalk fit,
k-means and t-SNE of its vectors, a StatsListener reporting into a
UIServer; the data-parallel tier: ParallelWrapper over an 8-slot mesh
fed by the device prefetcher, the averaging master with a crash drill,
the parameter server over TCP, a fault-tolerant restart, parallel early
stopping and an export; and `parallel.main` run as a module; the
multi-process tier: a two-process fit over gloo, a sharded checkpoint,
an export loaded back; data and interop: CSV sequences through datavec,
a Keras import, a streamed fit through the embedded broker, a checkpoint
through cloud storage)
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

    # the training-loop extras and the cluster tier's in-process half:
    # early stopping through a zip saver, the determinism check, a
    # torch.profiler trace, QoS lanes, a warm migration, a cluster
    # prefix fetch and disaggregated serving
    from deeplearning4j_tpu_torch import earlystopping as ES
    from deeplearning4j_tpu_torch import profiler
    from deeplearning4j_tpu_torch.serving import (
        DisaggCoordinator, PrefixDirectory, SlotMigratedError)
    from deeplearning4j_tpu_torch.util.determinism import (
        assert_deterministic)

    held = ListDataSetIterator([DataSet(x, y)])
    with tempfile.TemporaryDirectory() as d:
        cfg = (ES.EarlyStoppingConfiguration.Builder()
               .epoch_termination_conditions(
                   ES.MaxEpochsTerminationCondition(2))
               .score_calculator(ES.DataSetLossCalculator(held))
               .model_saver(ES.LocalFileModelSaver(d)).build())
        res = ES.EarlyStoppingTrainer(cfg, MultiLayerNetwork(rconf,
                                                             device="cpu"),
                                      ListDataSetIterator([DataSet(x, y)])
                                      ).fit()
        assert res.total_epochs == 2 and res.best_model is not None
        with profiler.trace_capture(d):
            with profiler.trace_annotation("phase"):
                torch.ones(2).sum()
    assert_deterministic(lambda: MultiLayerNetwork(rconf, device="cpu"),
                         [DataSet(x, y)])
    gen = {"n_slots": 2, "max_len": 24, "prompt_buckets": (8,),
           "page_size": 8, "prefill_chunk": 8, "prefix_cache": True,
           "decode_chunk": 1}
    src = DecodeEngine(net, device="cpu", qos={"preempt": True}, **gen)
    dst = DecodeEngine(net, device="cpu", **gen)
    pd = PrefixDirectory()
    src.bind_prefix_directory(pd, "src", {"src": src}.get)
    dst.bind_prefix_directory(pd, "dst", {"src": src}.get)
    try:
        prompt = np.arange(12) % 16
        want = src.generate(prompt, 6, priority="batch")
        assert (dst.generate(prompt, 6) == want).all()
        assert dst.stats()["prefix_fetches"] == 1
        req = src.submit(prompt, 6)
        while not req.tokens:
            pass
        src.migrate_slots(wait=10.0)
        try:
            tail = req.result()[len(req.tokens):]
            head = req.tokens
        except SlotMigratedError as e:
            head = e.tokens
            tail = dst.resume_generate(src.fetch_handoff(e.handoff_id))
        assert (np.concatenate([head, tail]) == want).all()
    finally:
        src.shutdown()
        dst.shutdown()
    co = DisaggCoordinator(net, server_kwargs={"generation": gen})
    try:
        assert (co.generate(prompt, 6) == want).all()
    finally:
        co.shutdown()

    # the wire: a gateway serving the GPT, a client, a remote replica
    # reached through a chaos proxy, and the cross-process pool's module
    from deeplearning4j_tpu_torch.gateway import GatewayClient, GatewayServer
    from deeplearning4j_tpu_torch.serving import (
        ChaosProxy, RemoteReplica, ReplicaEntryPoint, spawn_replica_pool)
    from deeplearning4j_tpu_torch.serving import remote_replica  # noqa: F401

    rep_ep = ReplicaEntryPoint(serving={"generation": gen}, device="cpu")
    rep_ep.serve_net(net)
    gw = GatewayServer(entry_point=rep_ep).start()
    proxy = ChaosProxy("127.0.0.1", gw.port)
    rep = RemoteReplica("127.0.0.1", proxy.port)
    client = GatewayClient(port=gw.port)
    try:
        assert (rep.generate(prompt, 6) == want).all()
        assert client.call("health")["ok"]
    finally:
        client.close()
        rep.shutdown()
        proxy.close()
        gw.stop(drain_timeout=5.0)
    assert callable(spawn_replica_pool)

    # the dataset fetchers and the NLP package: a MNIST batch through the
    # uint8 scaler, a Word2Vec fit (the NS path's device draws), the
    # native word count and a serialized table read back
    from deeplearning4j_tpu_torch.datasets.fetchers import (
        MnistDataSetIterator)
    from deeplearning4j_tpu_torch.datasets import hdf5  # noqa: F401
    from deeplearning4j_tpu_torch.native import loader
    from deeplearning4j_tpu_torch.nlp import (
        Word2Vec, WordVectorSerializer)
    ds = MnistDataSetIterator(16, num_examples=32, raw_uint8=True).next()
    assert ds.features.dtype == np.uint8 and ds.features.shape == (16, 784)
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(30)]
    corpus = [" ".join(words[j] for j in rng.integers(0, 30, 10))
              for _ in range(40)]
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "c.txt"), "w") as f:
            f.write("\\n".join(corpus))
        w2v = Word2Vec(layer_size=8, window=2, negative=2, batch_size=64,
                       device="cpu")
        w2v.fit(corpus)
        vocab = w2v.vocab.words()
        from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor
        files_vocab = VocabConstructor().build_vocab_from_files(
            [os.path.join(d, "c.txt")])
        assert sorted(files_vocab.words()) == sorted(vocab)
        assert loader.route in ("native", "python")
        WordVectorSerializer.write_lookup_table(w2v.lookup_table,
                                                os.path.join(d, "t.npz"))
        back = WordVectorSerializer.read_lookup_table(
            os.path.join(d, "t.npz"), device="cpu")
        assert back.vocab.words() == vocab
    assert np.isfinite(w2v.mean_loss)

    # graph embeddings, clustering and the training UI: a DeepWalk fit,
    # k-means and t-SNE of its vectors, the vectors written, a
    # StatsListener reporting through the remote router into a UIServer,
    # a t-SNE upload
    import json
    import urllib.request
    from deeplearning4j_tpu_torch.clustering import (
        BarnesHutTsne, KMeansClustering, Tsne)
    from deeplearning4j_tpu_torch.graph import (
        DeepWalk, Graph, GraphVectorSerializer)
    from deeplearning4j_tpu_torch.ui import (
        InMemoryStatsStorage, RemoteUIStatsStorageRouter, StatsListener,
        UIServer)
    from deeplearning4j_tpu_torch.util.berkeley import Counter
    g = Graph.from_edge_list([(i, (i + 1) % 12) for i in range(12)]
                             + [(0, 6)], n_vertices=12)
    dw = DeepWalk(vector_size=8, window_size=2, walk_length=8,
                  walks_per_vertex=2, negative=2, batch_size=64,
                  device="cpu")
    dw.fit(g)
    vecs = dw.lookup_table.syn0.numpy()
    km = KMeansClustering(3, device="cpu").fit(vecs)
    assert (km.labels_ == km.predict(vecs)).all()
    emb = Tsne(perplexity=3.0, n_iter=30, device="cpu").fit_transform(vecs)
    assert emb.shape == (12, 2) and BarnesHutTsne().theta == 0.5
    with tempfile.TemporaryDirectory() as d:
        GraphVectorSerializer.write_graph_vectors(dw, os.path.join(d, "g"))
        assert GraphVectorSerializer.read_graph_vectors(
            os.path.join(d, "g"))[1] == list(range(12))
    Counter().increment_count("a")
    ui = UIServer(port=0)
    storage = InMemoryStatsStorage()
    ui.attach(storage)
    base = f"http://127.0.0.1:{ui.port}"
    router = RemoteUIStatsStorageRouter(base)
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer, NeuralNetConfiguration, OutputLayer)
    unet = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(1).list()
        .layer(DenseLayer(n_in=8, n_out=4))
        .layer(OutputLayer(n_in=4, n_out=3)).build(), device="cpu")
    unet.init()
    unet.set_listeners(StatsListener(router))
    unet.fit(DataSet(vecs, np.eye(3, dtype=np.float32)[km.labels_]))
    router.shutdown()
    assert storage.list_session_ids()
    req = urllib.request.Request(base + "/tsne/upload", method="POST",
                                 data=json.dumps({"coords": emb.tolist()})
                                 .encode())
    assert json.loads(urllib.request.urlopen(req).read())["points"] == 12
    ui.stop()

    # the data-parallel tier on the CPU
    import torch
    from deeplearning4j_tpu_torch.parallel import (
        DistributedMultiLayer, EarlyStoppingParallelTrainer,
        FaultInjectionListener, FaultTolerantTrainer, ParallelWrapper,
        ParameterAveragingTrainingMaster, ParameterAveragingTrainingWorker,
        ParameterServerParallelWrapper, WorkerCrashInjector, make_mesh)
    from deeplearning4j_tpu_torch.parallel.device_prefetch import (
        DevicePrefetchIterator)
    from deeplearning4j_tpu_torch.parallel.export import batch_and_export
    from deeplearning4j_tpu_torch.parallel.parameter_server import (
        NetworkParameterServer, RemoteParameterServerClient)
    from deeplearning4j_tpu_torch import earlystopping as ES
    pnet = unet.clone()
    pdata = [DataSet(vecs, np.eye(3, dtype=np.float32)[km.labels_])] * 4
    mesh = make_mesh({"data": 4}, devices=[torch.device("cpu")] * 4)
    ParallelWrapper(pnet, mesh=mesh).fit(DevicePrefetchIterator(
        ListDataSetIterator(pdata), device="cpu"))
    assert pnet.iteration == unet.iteration + 4
    worker = ParameterAveragingTrainingWorker(pnet)
    crash = WorkerCrashInjector(worker_id=1)
    worker.add_hook(crash)
    master = ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=2, worker=worker,
        collect_training_stats=True)
    DistributedMultiLayer(pnet, master).fit(ListDataSetIterator(pdata))
    assert crash.fired == 1
    assert master.get_training_stats().get_count("worker_retries") == 1
    srv = NetworkParameterServer(pnet.params())
    client = RemoteParameterServerClient(*srv.address)
    ParameterServerParallelWrapper(pnet, workers=2, server=client).fit(
        ListDataSetIterator(pdata))
    assert srv.num_pushes == 4
    client.close()
    srv.close()
    with tempfile.TemporaryDirectory() as d:
        pnet.set_listeners(FaultInjectionListener(pnet.iteration + 2))
        ft = FaultTolerantTrainer(pnet, ListDataSetIterator(pdata),
                                  checkpoint_dir=os.path.join(d, "ck"),
                                  checkpoint_every=1)
        ft.fit(epochs=1)
        assert ft.restarts == 1
        pnet.set_listeners()
        assert len(batch_and_export(pdata, os.path.join(d, "x"), 6)) == 8
    cfg = (ES.EarlyStoppingConfiguration.Builder()
           .epoch_termination_conditions(ES.MaxEpochsTerminationCondition(2))
           .model_saver(ES.InMemoryModelSaver()).build())
    assert EarlyStoppingParallelTrainer(
        cfg, pnet, ListDataSetIterator(pdata), mesh=mesh).fit() \
        .total_epochs == 2

    # the in-process SPMD half (A12b): slots, tensor-parallel serving,
    # ring attention, the pipeline and the expert-parallel MoE
    from deeplearning4j_tpu_torch.parallel import (
        PipelineParallelWrapper, ring_attention, spmd)
    from deeplearning4j_tpu_torch.parallel.experts import moe_apply
    from deeplearning4j_tpu_torch.parallel.mesh import set_local_slots
    from deeplearning4j_tpu_torch.serving.tp_engine import TPPlan  # noqa
    set_local_slots(2, "cpu")
    tnet = MultiLayerNetwork(gpt_configuration(16, d_model=16, n_heads=2,
                                               n_layers=2, max_length=16),
                             device="cpu")
    tnet.init()
    eng = DecodeEngine(tnet, n_slots=1, max_len=12, prompt_buckets=(4,),
                       parallel={"tp": 2}, device="cpu")
    assert eng.generate(np.arange(3), 2).shape == (2,)
    eng.shutdown()
    two = make_mesh({"seq": 2}, devices=[torch.device("cpu")] * 2)
    qkv = torch.ones((1, 4, 2, 8))
    assert ring_attention(qkv, qkv, qkv, two).shape == (1, 4, 2, 8)
    ids = np.zeros((4, 4), np.int32)
    PipelineParallelWrapper(tnet, make_mesh(
        {"pipe": 2}, devices=[torch.device("cpu")] * 2)).fit(
        DataSet(ids, np.eye(16, dtype=np.float32)[ids]))
    ex = make_mesh({"expert": 2}, devices=[torch.device("cpu")] * 2)
    y, _ = moe_apply(lambda p, t: t @ p["W"], {"W": torch.ones((2, 8, 8))},
                     torch.ones((4, 8)), torch.ones((8, 2)), ex)
    assert y.shape == (4, 8) and spmd.current_slot() is None

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


_MAIN_SCRIPT = textwrap.dedent("""
    import os
    import runpy
    import sys
    import tempfile
    import numpy as np
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "pw_factory.py"), "w") as f:
        f.write(
            "import numpy as np\\n"
            "from deeplearning4j_tpu_torch.datasets.dataset import DataSet\\n"
            "from deeplearning4j_tpu_torch.datasets.iterators import "
            "ListDataSetIterator\\n"
            "def make():\\n"
            "    rng = np.random.default_rng(0)\\n"
            "    return ListDataSetIterator([DataSet(\\n"
            "        rng.normal(size=(8, 4)).astype(np.float32),\\n"
            "        np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])\\n"
            "        for _ in range(4)])\\n")
    sys.path.insert(0, d)
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer, NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.serialization import (
        restore_model, write_model)
    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(1).list()
        .layer(DenseLayer(n_in=4, n_out=8))
        .layer(OutputLayer(n_in=8, n_out=3)).build(), device="cpu")
    net.init()
    write_model(net, os.path.join(d, "in.zip"))
    for mode in ("wrapper", "averaging", "ps"):
        sys.argv = ["deeplearning4j_tpu_torch.parallel.main",
                    "--model-path", os.path.join(d, "in.zip"),
                    "--data-factory", "pw_factory:make",
                    "--output-path", os.path.join(d, mode + ".zip"),
                    "--mode", mode, "--device", "cpu"]
        try:
            runpy.run_module("deeplearning4j_tpu_torch.parallel.main",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        out = restore_model(os.path.join(d, mode + ".zip"), device="cpu")
        assert not np.allclose(out.params().numpy(), net.params().numpy())
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "deeplearning4j_tpu"
                    or m.startswith("deeplearning4j_tpu."))
    print("LEAKED", leaked)
    sys.exit(1 if leaked else 0)
""")


def test_parallel_main_as_a_module_imports_neither():
    """`python -m deeplearning4j_tpu_torch.parallel.main` (run the way
    `-m` runs it, through runpy) trains a saved zip in each mode on the
    CPU without loading jax or the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _MAIN_SCRIPT], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


_A12C_A14_SCRIPT = textwrap.dedent("""
    import json
    import os
    import sys
    import tempfile
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.cloud import LocalStorage
    from deeplearning4j_tpu_torch.datavec import (
        AlignmentMode, CSVSequenceRecordReader,
        SequenceRecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    from deeplearning4j_tpu_torch.parallel import multiprocess as mp
    from deeplearning4j_tpu_torch.streaming import (
        KafkaSink, KafkaSource, StreamingTrainPipeline)
    from deeplearning4j_tpu_torch.streaming.embedded_kafka import (
        EmbeddedKafkaBroker)
    from deeplearning4j_tpu_torch.util import sharded_checkpoint
    from deeplearning4j_tpu_torch.util.checkpoint_store import (
        CheckpointStore)
    from deeplearning4j_tpu_torch.util.stablehlo_export import (
        export_inference, load_inference)

    LEAK = ("import sys; leaked = sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'deeplearning4j_tpu')); "
            "print('WORKER LEAKED', leaked)")
    d = tempfile.mkdtemp()
    # two processes over gloo, each checking what it loaded
    port = mp.free_port()
    out = os.path.join(d, "p.npy")
    worker = ("import sys; from deeplearning4j_tpu_torch.parallel "
              "import multiprocess as mp; mp._parity_worker_main("
              "sys.argv[1:]); " + LEAK)
    procs, logs = mp.run_workers(
        [[sys.executable, "-c", worker, str(r), "2", f"localhost:{port}",
          "2", out, "--device", "cpu"] for r in range(2)],
        dict(os.environ, OMP_NUM_THREADS="1"), timeout=90)
    assert all(p.returncode == 0 for p in procs), logs
    assert all("WORKER LEAKED []" in log for log in logs), logs
    net = mp._parity_fixture_net(device="cpu")
    sharded_checkpoint.save_sharded_checkpoint(os.path.join(d, "ck"), net)
    sharded_checkpoint.restore_sharded_checkpoint(os.path.join(d, "ck"),
                                                  net)
    x = np.zeros((2, 6), np.float32)
    run = load_inference(export_inference(net, x))
    assert np.array_equal(run(x), net.output(x).numpy())

    # a Keras model held in memory (an h5py-shaped layout), CSV sequences,
    # the embedded broker, the streaming trainer, cloud storage
    class Layout(dict):
        def __init__(self, attrs, **items):
            super().__init__(items)
            self.attrs = attrs
    cfg = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "LSTM", "config": {
            "name": "lstm", "units": 4, "activation": "tanh",
            "recurrent_activation": "sigmoid", "return_sequences": True,
            "batch_input_shape": [None, None, 3]}},
        {"class_name": "Dense", "config": {"name": "dense", "units": 3,
                                           "activation": "softmax"}}]}}
    rng = np.random.default_rng(0)
    w = lambda *s: rng.normal(size=s).astype(np.float32)
    model = Layout({"model_config": json.dumps(cfg).encode()},
                   model_weights=Layout(
                       {"layer_names": np.array([b"lstm", b"dense"])},
                       lstm=Layout({"weight_names": np.array(
                           [b"kernel", b"recurrent_kernel", b"bias"])},
                           kernel=w(3, 16), recurrent_kernel=w(4, 16),
                           bias=w(16)),
                       dense=Layout({"weight_names": np.array(
                           [b"kernel", b"bias"])}, kernel=w(4, 3),
                           bias=w(3))))
    knet = KerasModelImport.import_keras_sequential_model_and_weights(
        model, device="cpu")
    paths = []
    for s in range(4):
        p = os.path.join(d, f"s{s}.csv")
        with open(p, "w") as f:
            f.write("".join(f"{t % 3 == 0:d},{t % 3 == 1:d},"
                            f"{t % 3 == 2:d},{(t + 1) % 3}\\n"
                            for t in range(2 + s)))
        paths.append(p)
    it = SequenceRecordReaderDataSetIterator(
        CSVSequenceRecordReader(paths), batch_size=2, num_classes=3,
        label_index=-1, alignment=AlignmentMode.ALIGN_END)
    broker = EmbeddedKafkaBroker()
    sink = KafkaSink("t", broker.bootstrap_servers, client="embedded")
    for b in it:
        sink.send_dataset(b.features, b.labels, b.features_mask,
                          b.labels_mask)
    src = KafkaSource("t", broker.bootstrap_servers, client="embedded",
                      auto_offset_reset="earliest", poll_timeout_s=0.2)
    def two():
        for i, ds in enumerate(src):
            assert ds.features_mask is not None
            yield ds
            if i == 1:
                return
    pipe = StreamingTrainPipeline(knet, two(),
                                  checkpoint_dir=os.path.join(d, "sk"))
    pipe.run()
    src.close()
    sink.close()
    broker.close()
    assert pipe.batches_seen == 2
    key = CheckpointStore(os.path.join(d, "sk")).upload(
        LocalStorage(os.path.join(d, "bucket")))
    assert key.endswith(".zip")
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "deeplearning4j_tpu"
                    or m.startswith("deeplearning4j_tpu."))
    print("LEAKED", leaked)
    sys.exit(1 if leaked else 0)
""")


def test_multiprocess_tier_and_data_interop_import_neither():
    """Two gloo processes train, a sharded checkpoint and an export
    round-trip, a Keras model imports, CSV sequences stream through the
    embedded broker into the trainer and its checkpoint goes to storage:
    neither this process nor the workers load jax or the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _A12C_A14_SCRIPT],
                       cwd=str(REPO), env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


def test_no_port_source_names_jax():
    """No module of the port, none of its card scripts (`chip_*.py`) and
    not its thread stress check imports jax or the JAX package."""
    bad = []
    for path in [*(REPO / "deeplearning4j_tpu_torch").rglob("*.py"),
                 *REPO.glob("chip_*.py"), REPO / "spmd_thread_stress.py"]:
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
    from deeplearning4j_tpu_torch.nlp import Glove, ParagraphVectors, Word2Vec
    from deeplearning4j_tpu_torch.nlp.lookup_table import InMemoryLookupTable
    from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache

    from deeplearning4j_tpu_torch.clustering import KMeansClustering, Tsne
    from deeplearning4j_tpu_torch.graph import DeepWalk

    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.parallel.device_prefetch import (
        DevicePrefetchIterator,
    )

    for make in (Word2Vec, ParagraphVectors, Glove,
                 lambda: InMemoryLookupTable(AbstractCache(), 4),
                 lambda: KMeansClustering(3), Tsne, DeepWalk, make_mesh,
                 lambda: DevicePrefetchIterator(ListDataSetIterator([]))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
