"""The port's streaming train and serve routes
(`deeplearning4j_tpu_torch.streaming`) and its embedded broker against
the JAX package's.

Held: the broker's wire and the records are the JAX package's (either
package's producer feeds either package's broker and consumer; the
records' bytes are equal); a stream trains the port's network as it
trains the JAX package's from the same weights (f32, losses within 1e-6
and parameters within 1e-6 after the stream); the quarantine and the
durable checkpoints behave the same (the same quarantined positions, a
restart resumes from the same step, and the checkpoint zip loads in the
JAX package); the serve route answers with `output` exactly; a record
may carry masks, which the port's consumer keeps and the JAX package's
leaves. `client="kafka"` raises as the reference does without
kafka-python, which is not installed."""
import os
import sys
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu.streaming import embedded_kafka as jek  # noqa: E402
from deeplearning4j_tpu.streaming import pipeline as jpl  # noqa: E402
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402

from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.parallel.multiprocess import (  # noqa: E402
    run_workers,
)
from deeplearning4j_tpu_torch.streaming import embedded_kafka as pek  # noqa: E402
from deeplearning4j_tpu_torch.streaming import pipeline as ppl  # noqa: E402
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


def _pair(seed=3):
    conf = (dl4j.NeuralNetConfiguration.Builder().seed(seed)
            .learning_rate(0.1).list()
            .layer(DenseLayer(n_in=4, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=3))
            .build())
    jnet = dl4j.MultiLayerNetwork(conf)
    jnet.init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, jnet._params))
    return jnet, pnet


def _batches(n, seed=0, rows=8):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
            for _ in range(n)]


def _drain(source, n):
    got = []
    for ds in source:
        got.append(ds)
        if len(got) == n:
            source.close()
    return got


@pytest.mark.parametrize("producer,broker", [("port", "jax"),
                                             ("jax", "port")])
def test_either_packages_producer_talks_to_either_broker(producer, broker):
    """The wire is unchanged: records produced through one package's
    client into the other package's broker are the same bytes, and both
    packages' consumers read them back."""
    pkgs = {"port": (pek, ppl), "jax": (jek, jpl)}
    b = pkgs[broker][0].EmbeddedKafkaBroker()
    try:
        sink = pkgs[producer][1].KafkaSink("t", b.bootstrap_servers,
                                           client="embedded")
        sent = _batches(4)
        for f, l in sent:
            sink.send_dataset(f, l)
        assert b.topic_size("t") == 4
        for _, pl in pkgs.values():
            got = _drain(pl.KafkaSource("t", b.bootstrap_servers,
                                        client="embedded",
                                        poll_timeout_s=0.2,
                                        auto_offset_reset="earliest"), 4)
            for (f, l), ds in zip(sent, got):
                np.testing.assert_array_equal(ds.features, f)
                np.testing.assert_array_equal(ds.labels, l)
        sink.close()
    finally:
        b.close()
    f, l = sent[0]
    assert ppl.encode_dataset(f, l) == jpl.encode_dataset(f, l)


def test_records_may_carry_masks():
    """A masked record: the port decodes its masks; the JAX package's
    decoder reads the (features, labels) pair it has always read."""
    rng = np.random.default_rng(1)
    f = rng.standard_normal((2, 5, 3)).astype(np.float32)
    l = rng.standard_normal((2, 5, 2)).astype(np.float32)
    m = np.array([[0, 1, 1, 1, 1], [1, 1, 1, 1, 1]], np.float32)
    rec = ppl.encode_dataset(f, l, m, m)
    ds = ppl.decode_dataset(rec)
    for got, want in ((ds.features, f), (ds.labels, l),
                      (ds.features_mask, m), (ds.labels_mask, m)):
        np.testing.assert_array_equal(got, want)
    only_f = ppl.decode_dataset(ppl.encode_dataset(f, l, m, None))
    assert only_f.labels_mask is None
    np.testing.assert_array_equal(only_f.features_mask, m)
    jds = jpl.decode_dataset(rec)
    np.testing.assert_array_equal(jds.features, f)
    assert jds.features_mask is None
    plain = ppl.decode_dataset(jpl.encode_dataset(f, l))
    assert plain.features_mask is None and plain.labels_mask is None


def test_a_stream_trains_like_the_jax_package():
    """The same six batches through the broker into both packages'
    StreamingTrainPipeline (in a background thread): every score and the
    final parameters within 1e-6."""
    jnet, pnet = _pair()
    results = {}
    for name, (ek, pl, net) in {"port": (pek, ppl, pnet),
                                "jax": (jek, jpl, jnet)}.items():
        b = ek.EmbeddedKafkaBroker()
        try:
            sink = pl.KafkaSink("train", b.bootstrap_servers,
                                client="embedded")
            for f, l in _batches(6, seed=2, rows=16):
                sink.send_dataset(f, l)
            src = pl.KafkaSource("train", b.bootstrap_servers,
                                 client="embedded", poll_timeout_s=0.2,
                                 auto_offset_reset="earliest")
            scores = []
            pipe = pl.StreamingTrainPipeline(
                net, src, on_batch=lambda s: scores.append(s["score"]))
            pipe.start()
            deadline = time.time() + 60
            while pipe.batches_seen < 6 and time.time() < deadline:
                time.sleep(0.02)
            src.close()
            pipe.join(timeout=10)
            assert pipe.batches_seen == 6 and net.iteration == 6
            results[name] = scores
            sink.close()
        finally:
            b.close()
    np.testing.assert_allclose(results["port"], results["jax"], rtol=TOL)
    np.testing.assert_allclose(pnet.params().numpy(),
                               np.asarray(jnet.params()), rtol=TOL, atol=TOL)


def test_quarantine_and_checkpoints_match_the_jax_package(tmp_path):
    """A stream with a NaN record and a record of the wrong width: both
    packages quarantine the same positions and keep training; the port's
    checkpoints resume a restarted pipeline at the same step as the JAX
    package's, and its zip loads in the JAX package."""
    def stream():
        out = []
        for i, (f, l) in enumerate(_batches(6, seed=4)):
            if i == 1:
                f = f.copy()
                f[0, 0] = np.nan
            if i == 3:
                f = f[:, :3]
            out.append((f, l))
        return out

    jnet, pnet = _pair(seed=5)
    seen = {}
    for name, (pl, net, cls) in {"port": (ppl, pnet, DataSet),
                                 "jax": (jpl, jnet, JDataSet)}.items():
        d = tmp_path / name
        pipe = pl.StreamingTrainPipeline(
            net, [cls(f, l) for f, l in stream()],
            checkpoint_dir=d / "ck", checkpoint_every=2,
            quarantine_dir=d / "q")
        pipe.run()
        q = pipe.quarantine
        positions = [(q.load(i)[1]["provenance"]["stream_position"],
                      q.load(i)[1]["provenance"]["stage"])
                     for i in range(len(q))]
        seen[name] = (pipe.batches_seen, pipe.records_seen, positions,
                      pipe.checkpoint_store.steps())
    assert seen["port"] == seen["jax"]
    assert [p for p, _ in seen["port"][2]] == [1, 3]
    np.testing.assert_allclose(pnet.params().numpy(),
                               np.asarray(jnet.params()), rtol=TOL, atol=TOL)
    # restart: both resume from the newest verified checkpoint
    j2, p2 = _pair(seed=6)
    jr = jpl.StreamingTrainPipeline(j2, [], checkpoint_dir=tmp_path / "jax"
                                    / "ck")
    pr = ppl.StreamingTrainPipeline(p2, [], checkpoint_dir=tmp_path / "port"
                                    / "ck")
    assert pr.resumed_from_step == jr.resumed_from_step == pnet.iteration
    np.testing.assert_array_equal(p2.params().numpy(), pnet.params().numpy())
    step = pr.checkpoint_store.steps()[-1]
    back = jser.restore_model(pr.checkpoint_store.path_for(step))
    np.testing.assert_array_equal(np.asarray(back.params()),
                                  pnet.params().numpy())


def test_the_serve_route_answers_with_output():
    """ServeRoute on a bare network: each record's answer is `output` on
    it, as host numpy, in order; published through the broker it is the
    JAX package's answer within 1e-6."""
    jnet, pnet = _pair(seed=7)
    feats = [f for f, _ in _batches(3, seed=8)]
    q, out = ppl.QueueSource(), ppl.QueueSink()
    for f in feats:
        q.put(f)
    q.close()
    route = ppl.ServeRoute(pnet, q, out).start()
    route.join(timeout=30)
    assert route.served == 3 and route.shed == 0
    for got, f in zip(out.items, feats):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, pnet.output(f).numpy())
        np.testing.assert_allclose(got, np.asarray(jnet.output(f)),
                                   rtol=TOL, atol=TOL)
    b = pek.EmbeddedKafkaBroker()
    try:
        sink = ppl.KafkaSink("preds", b.bootstrap_servers, client="embedded")
        q2 = ppl.QueueSource()
        q2.put(feats[0])
        q2.close()
        ppl.ServeRoute(pnet, q2, sink).run()
        import io

        src = jpl.KafkaSource("preds", b.bootstrap_servers,
                              client="embedded", poll_timeout_s=0.2,
                              auto_offset_reset="earliest")
        for msg in src._consumer:
            pred = np.load(io.BytesIO(msg.value), allow_pickle=False)
            break
        src.close()
        np.testing.assert_array_equal(pred, out.items[0])
        sink.close()
    finally:
        b.close()


def test_a_producer_in_another_process():
    """The port's producer entry (`python -m
    deeplearning4j_tpu_torch.streaming.embedded_kafka`) in another OS
    process feeds this process's broker, as the JAX package's does: the
    same records the JAX package's producer sends."""
    b = pek.EmbeddedKafkaBroker()
    try:
        procs, logs = run_workers(
            [[sys.executable, "-m",
              "deeplearning4j_tpu_torch.streaming.embedded_kafka",
              b.bootstrap_servers, "xs", "4"]],
            dict(os.environ, OMP_NUM_THREADS="1"), timeout=60)
        assert procs[0].returncode == 0, (logs[0] or "")[-2000:]
        assert "KAFKA_PRODUCER_DONE 4" in logs[0]
        got = _drain(ppl.KafkaSource("xs", b.bootstrap_servers,
                                     client="embedded", poll_timeout_s=0.2,
                                     auto_offset_reset="earliest"), 4)
        rng = np.random.default_rng(7)  # the producer's draws
        for ds in got:
            f = rng.standard_normal((8, 4)).astype(np.float32)
            lab = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
            np.testing.assert_array_equal(ds.features, f)
            np.testing.assert_array_equal(ds.labels, lab)
    finally:
        b.close()


@pytest.mark.parametrize("client", ["kafka", "nope", "auto"])
def test_client_choice_matches_the_reference(client):
    """`kafka` needs kafka-python (not installed): both packages raise the
    same ImportError; an unknown client is the same ValueError; `auto`
    falls back to the embedded broker in both."""
    def run(ek, pl):
        b = ek.EmbeddedKafkaBroker()
        try:
            src = pl.KafkaSource("t", b.bootstrap_servers, client=client)
            kind = type(src._consumer).__name__
            src.close()
            return kind
        except Exception as e:
            return type(e).__name__, str(e)
        finally:
            b.close()

    assert run(pek, ppl) == run(jek, jpl)
