"""The training UI of the port (`deeplearning4j_tpu_torch.ui`) on the CPU: a
counterpart of every test of `tests/test_ui.py` (but the time sources,
which are parallel training's), and against the JAX package's: the same
records in both packages' servers give identical JSON at every route and
identical pages; each package's `RemoteUIStatsStorageRouter` posts into
the other's `UIServer`; each package's `FileStatsStorage` reads the
other's file; the statistics of the same parameters are identical; and a
bf16 network's histograms come through."""
import json
import logging
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ui as JU
import deeplearning4j_tpu_torch.ui as TU
from deeplearning4j_tpu.ui import components as jcomp
from deeplearning4j_tpu.ui import stats_listener as jsl
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.eval.evaluation_tools import EvaluationTools
from deeplearning4j_tpu_torch.eval.roc import ROC
from deeplearning4j_tpu_torch.nn.conf import (
    DenseLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from deeplearning4j_tpu_torch.ui import (
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    StatsListener,
    StatsRecord,
    UIServer,
)
from deeplearning4j_tpu_torch.ui import components as tcomp
from deeplearning4j_tpu_torch.ui import stats_listener as tsl


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


ROUTES = ("/", "/train", "/train/overview", "/train/overview/data",
          "/train/sessions", "/train/model", "/train/model/page",
          "/train/model/data", "/train/system", "/train/histograms",
          "/train/histograms/page", "/tsne", "/tsne/data", "/train/flow",
          "/train/activations")


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _conf(seed=1, n_in=4):
    return (NeuralNetConfiguration.Builder()
            .seed(seed).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_out=8, activation=Activation.TANH))
            .layer(OutputLayer(n_out=2, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(n_in))
            .build())


def _train_with_listener(storage, n_iters=5, **net_kw):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(X[:, 0] > 0).astype(int)]
    net = MultiLayerNetwork(_conf(), device="cpu", **net_kw)
    net.init()
    listener = StatsListener(storage, session_id="sess-test")
    net.set_listeners(listener)
    net.fit(ListDataSetIterator([DataSet(X, y)] * n_iters, batch_size=64))
    return net


def test_stats_listener_populates_storage():
    storage = InMemoryStatsStorage()
    _train_with_listener(storage)
    assert storage.list_session_ids() == ["sess-test"]
    stats = storage.get_records("sess-test", type_id="stats")
    assert len(stats) == 5
    assert all(np.isfinite(r.data["score"]) for r in stats)
    p = stats[-1].data["parameters"]
    assert "0_W" in p and "mean_magnitude" in p["0_W"]
    assert len(p["0_W"]["histogram_counts"]) == 20
    static = storage.get_records("sess-test", type_id="static_info")
    assert static[0].data["n_params"] == 4 * 8 + 8 + 8 * 2 + 2
    assert static[0].data["model_class"] == "MultiLayerNetwork"
    # a CPU model: host stats only, as the reference on its CPU backend
    system = stats[-1].data["system"]
    assert system["host_rss_mb"] > 0
    assert "device_bytes_in_use" not in system


def test_listener_reports_the_current_parameters():
    """Each report reads the parameters as they are now: the last
    record's statistics are those of the trained network."""
    storage = InMemoryStatsStorage()
    net = _train_with_listener(storage, n_iters=3)
    last = storage.get_records("sess-test", type_id="stats")[-1]
    first = storage.get_records("sess-test", type_id="stats")[0]
    for name, arr in StatsListener._named_params(net):
        assert last.data["parameters"][name] == tsl._array_stats(arr)
    assert first.data["parameters"]["0_W"] != last.data["parameters"]["0_W"]


def test_array_stats_match_the_reference():
    rng = np.random.default_rng(3)
    for a in (rng.normal(size=(17, 5)).astype(np.float32),
              rng.uniform(-2, 3, size=300).astype(np.float32)):
        assert tsl._array_stats(torch.from_numpy(a)) == jsl._array_stats(a)
    assert tsl._array_stats(torch.zeros(0)) == {}


def test_bf16_network_histograms_come_through():
    storage = InMemoryStatsStorage()
    net = _train_with_listener(storage, n_iters=2, dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    stats = storage.get_records("sess-test", type_id="stats")
    assert len(stats) == 2
    params = dict(StatsListener._named_params(net))
    assert params["0_W"].dtype == torch.bfloat16
    for name, st in stats[-1].data["parameters"].items():
        assert sum(st["histogram_counts"]) == params[name].numel()
        assert st == jsl._array_stats(params[name].float().numpy())


def test_system_stats_route_by_the_model_device():
    assert "device_bytes_in_use" not in tsl._system_stats(None)
    assert "device_bytes_in_use" not in tsl._system_stats(torch.device("cpu"))
    net = MultiLayerNetwork(_conf(), device="cpu")
    net.init()
    assert StatsListener._model_device(net) == torch.device("cpu")
    if torch.cuda.is_available():
        s = tsl._system_stats(torch.device("cuda"))
        assert s["device_bytes_limit"] > 0 and s["device_bytes_in_use"] >= 0


def test_file_stats_storage_roundtrip(tmp_path):
    path = tmp_path / "stats.jsonl"
    storage = FileStatsStorage(path)
    _train_with_listener(storage, n_iters=3)
    reread = FileStatsStorage(path)
    recs = reread.get_records("sess-test", type_id="stats")
    assert len(recs) == 3
    assert recs[0].data["iteration"] == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_file_storage_reads_the_other_packages_file(tmp_path, writer):
    W, R = (JU, TU) if writer == "jax" else (TU, JU)
    path = tmp_path / "stats.jsonl"
    storage = W.FileStatsStorage(path)
    recs = [W.StatsRecord("s1", "stats", "w0", 1000.0 + i,
                          {"iteration": i, "score": 0.5 / (i + 1)})
            for i in range(4)]
    for r in recs:
        storage.put_record(r)
    storage.put_record(W.StatsRecord("s2", "static_info", "w1", 2000.0,
                                     {"n_params": 7}))
    reread = R.FileStatsStorage(path)
    assert reread.list_session_ids() == ["s1", "s2"]
    got = reread.get_records("s1", type_id="stats")
    assert [r.to_json() for r in got] == [r.to_json() for r in recs]
    assert reread.list_workers("s2") == ["w1"]
    # both packages append the same bytes
    other = tmp_path / "other.jsonl"
    mirror = R.FileStatsStorage(other)
    for r in recs:
        mirror.put_record(R.StatsRecord.from_json(r.to_json()))
    assert other.read_bytes() == b"".join(
        (r.to_json() + "\n").encode() for r in recs)


def test_storage_listener_callbacks():
    storage = InMemoryStatsStorage()
    seen = []
    storage.register_stats_listener(seen.append)
    storage.put_record(StatsRecord("s", "stats", "w", time.time(), {"x": 1}))
    assert len(seen) == 1 and seen[0].data == {"x": 1}
    storage.deregister_stats_listener(seen.append)
    storage.put_record(StatsRecord("s", "stats", "w", time.time(), {"x": 2}))
    assert len(seen) == 1


def test_ui_server_endpoints_and_remote_post():
    server = UIServer(port=0)
    try:
        storage = InMemoryStatsStorage()
        server.attach(storage)
        _train_with_listener(storage, n_iters=4)
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(f"{base}/train/overview") as r:
            page = r.read().decode()
        assert "Score vs iteration" in page
        with urllib.request.urlopen(f"{base}/train/overview/data") as r:
            data = json.loads(r.read())
        assert data["session_id"] == "sess-test"
        assert len(data["iterations"]) == 4
        assert any(data["param_mean_magnitudes"])
        with urllib.request.urlopen(f"{base}/train/model") as r:
            model = json.loads(r.read())
        assert model["static"]["model_class"] == "MultiLayerNetwork"

        router = RemoteUIStatsStorageRouter(base)
        router.put_record(StatsRecord("remote-sess", "stats", "w0",
                                      time.time(), {"iteration": 1,
                                                    "score": 0.5}))
        router.shutdown()
        assert "remote-sess" in storage.list_session_ids()
    finally:
        server.stop()


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_routers_post_into_the_other_packages_server(direction):
    R, S = (TU, JU) if direction == "torch->jax" else (JU, TU)
    server = S.UIServer(port=0)
    try:
        storage = S.InMemoryStatsStorage()
        server.attach(storage)
        router = R.RemoteUIStatsStorageRouter(
            f"http://127.0.0.1:{server.port}")
        sent = [R.StatsRecord("x-sess", "stats", "w0", 1.5 + i,
                              {"iteration": i, "score": 1.0 / (i + 1)})
                for i in range(3)]
        for r in sent:
            router.put_record(r)
        router.shutdown()
        got = storage.get_records("x-sess")
        assert [r.to_json() for r in got] == [r.to_json() for r in sent]
        assert router.dropped_count == 0
    finally:
        server.stop()


def test_evaluation_tools_html(tmp_path):
    from deeplearning4j_tpu.eval.evaluation import Evaluation as JEval
    from deeplearning4j_tpu.eval.evaluation_tools import (
        EvaluationTools as JTools)

    rng = np.random.default_rng(0)
    probs = rng.random(200)
    labels = (probs + rng.normal(scale=0.3, size=200) > 0.5).astype(float)
    roc = ROC(threshold_steps=50)
    roc.eval(labels, probs)
    p = tmp_path / "roc.html"
    EvaluationTools.export_roc_charts_to_html_file(roc, p)
    html = p.read_text()
    assert "AUC" in html and "polyline" in html

    ev, jev = Evaluation(), JEval()
    for e in (ev, jev):
        e.eval(np.eye(2)[[0, 1, 1, 0]], np.eye(2)[[0, 1, 0, 0]])
    p2 = tmp_path / "eval.html"
    EvaluationTools.export_evaluation_to_html_file(ev, p2)
    assert "Confusion matrix" in p2.read_text()
    assert EvaluationTools.evaluation_html(ev) == JTools.evaluation_html(jev)


def _dsl_tree(C):
    line = C.ChartLine(title="score").add_series("s", [0, 1, 2],
                                                 [3.0, 2.0, 1.0])
    table = C.ComponentTable(header=["k", "v"], rows=[["acc", "0.9"]])
    return (C.ComponentDiv().add(line).add(table)
            .add(C.ComponentText(text="note & <tag>"))
            .add(C.ChartScatter(title="pts").add_series(
                "a", [0, 1], [1, 0], labels=["p", "q"]))
            .add(C.ChartHistogram(title="h").add_bin(0, 1, 5)
                 .add_bin(1, 2, 3)))


def test_ui_components_dsl_round_trip():
    div = _dsl_tree(tcomp)
    restored = tcomp.Component.from_json(div.to_json())
    assert isinstance(restored, tcomp.ComponentDiv)
    html_doc = tcomp.render_html(restored, title="report")
    assert "<svg" in html_doc and "polyline" in html_doc
    assert "note &amp; &lt;tag&gt;" in html_doc
    assert "<table" in html_doc and "acc" in html_doc


def test_components_give_the_reference_json_and_html():
    a, b = _dsl_tree(jcomp), _dsl_tree(tcomp)
    assert b.to_json() == a.to_json()
    for kw in ({}, {"title": "t", "refresh_seconds": 5},
               {"refresh_seconds": 0.5}):
        assert tcomp.render_html(b, **kw) == jcomp.render_html(a, **kw)
    # each package reads the other's JSON
    assert tcomp.render_html(tcomp.Component.from_json(a.to_json())) == \
        jcomp.render_html(jcomp.Component.from_json(b.to_json()))


def test_ui_system_histogram_tsne_modules():
    storage = InMemoryStatsStorage()
    server = UIServer(port=0)
    try:
        server.attach(storage)
        conf = (NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
                .list().layer(DenseLayer(n_in=4, n_out=8))
                .layer(OutputLayer(n_in=8, n_out=2,
                                   activation=Activation.SOFTMAX)).build())
        net = MultiLayerNetwork(conf, device="cpu")
        net.init()
        net.set_listeners(StatsListener(storage))
        rng = np.random.default_rng(0)
        x = rng.normal(size=(32, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
        for _ in range(4):
            net.fit(DataSet(x, y))

        base = f"http://127.0.0.1:{server.port}"
        sysd = json.loads(urllib.request.urlopen(f"{base}/train/system").read())
        assert len(sysd["iterations"]) == 4
        assert sysd["host_rss_mb"][-1] and sysd["host_rss_mb"][-1] > 0
        hist = json.loads(
            urllib.request.urlopen(f"{base}/train/histograms").read())
        assert hist["parameters"] and all(
            st["histogram_counts"] for st in hist["parameters"].values())
        page = urllib.request.urlopen(
            f"{base}/train/histograms/page").read().decode()
        assert "<svg" in page and "rect" in page

        code, resp = _post(base, "/tsne/upload",
                           {"coords": [[0.0, 1.0], [1.0, 0.0]],
                            "labels": ["a", "b"]})
        assert code == 200 and resp["points"] == 2
        tsne_page = urllib.request.urlopen(f"{base}/tsne").read().decode()
        assert "circle" in tsne_page
    finally:
        server.stop()


def test_tsne_upload_rejects_malformed():
    server = UIServer(port=0)
    try:
        base = f"http://127.0.0.1:{server.port}"
        for bad in ({"coords": ["ab", "cd"]},
                    {"coords": [[0.0, 1.0]], "labels": ["a", "b"]},
                    {"labels": ["a"]}):
            code, resp = _post(base, "/tsne/upload", bad)
            assert code == 400 and resp["error"].startswith("bad upload")
        code, _ = _post(base, "/tsne/upload",
                        {"coords": [[0.0, 1.0], [1.0, 0.0]],
                         "labels": ["alpha", "beta"]})
        assert code == 200
        page = urllib.request.urlopen(f"{base}/tsne").read().decode()
        assert "alpha" in page and "beta" in page
    finally:
        server.stop()


def test_component_div_sees_post_add_mutation():
    chart = tcomp.ChartLine(title="t")
    div = tcomp.ComponentDiv().add(chart)
    chart.add_series("late", [0, 1, 2], [1, 2, 3])
    html_doc = tcomp.render_html(div)
    assert "polyline" in html_doc and "late" in html_doc


def test_flow_and_activation_listeners():
    from deeplearning4j_tpu_torch.models.lenet import lenet_configuration
    from deeplearning4j_tpu_torch.ui.flow import (
        ConvolutionalIterationListener, FlowListener)

    storage = InMemoryStatsStorage()
    server = UIServer(port=0)
    try:
        server.attach(storage)
        net = MultiLayerNetwork(lenet_configuration(), device="cpu")
        net.init()
        conv = ConvolutionalIterationListener(storage, frequency=1)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(4, 784)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
        conv.set_probe(x)
        net.set_listeners(FlowListener(storage), conv)
        net.fit(DataSet(x, y))

        base = f"http://127.0.0.1:{server.port}"
        flow = urllib.request.urlopen(f"{base}/train/flow").read().decode()
        assert "ConvolutionLayer" in flow and "<rect" in flow
        acts = urllib.request.urlopen(
            f"{base}/train/activations").read().decode()
        assert "<svg" in acts and acts.count("<rect") > 50
        rec = storage.get_latest_record("conv-session", type_id="activations")
        assert all(0.0 <= v <= 1.0 for ch in rec.data["channels"]
                   for row in ch for v in row)
    finally:
        server.stop()


def test_flow_listener_on_a_graph():
    from deeplearning4j_tpu_torch.models import resnet_tiny_configuration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ui.flow import FlowListener

    storage = InMemoryStatsStorage()
    g = ComputationGraph(resnet_tiny_configuration(), device="cpu")
    FlowListener(storage).iteration_done(g, 1)
    nodes = storage.get_latest_record("flow-session", "flow").data["nodes"]
    assert [n["name"] for n in nodes] == \
        list(g.conf.topological_order)
    assert any(n["inputs"] for n in nodes)


def test_param_and_gradient_listener(tmp_path):
    from deeplearning4j_tpu_torch.optimize.listeners import (
        ParamAndGradientIterationListener)

    conf = (NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
            .list().layer(DenseLayer(n_in=4, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=2,
                               activation=Activation.SOFTMAX)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    out = tmp_path / "pg.tsv"
    net.set_listeners(ParamAndGradientIterationListener(frequency=2,
                                                        file_path=str(out)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    for _ in range(4):
        net.fit(DataSet(x, y))
    lines = out.read_text().strip().split("\n")
    assert lines[0].startswith("iteration\tscore")
    assert len(lines) == 1 + 8
    row = lines[1].split("\t")
    assert row[2] == "0_W" and float(row[1]) > 0
    assert all(np.isfinite(float(v)) for v in row[3:])


def test_live_pages_serve_valid_js_and_model_series():
    server = UIServer(port=0)
    try:
        storage = InMemoryStatsStorage()
        server.attach(storage)
        _train_with_listener(storage, n_iters=3)
        base = f"http://127.0.0.1:{server.port}"
        for path, feed in (("/train/overview", "/train/overview/data"),
                           ("/train/model/page", "/train/model/data")):
            with urllib.request.urlopen(base + path) as r:
                page = r.read().decode()
            js = re.search(r"<script>(.*?)</script>", page, re.S).group(1)
            assert "{{" not in js and "}}" not in js
            assert js.count("{") == js.count("}")
            assert f"fetch('{feed}')" in js
            assert "setInterval(refresh" in js
        with urllib.request.urlopen(f"{base}/train/model/data") as r:
            d1 = json.loads(r.read())
        assert d1["latest_iteration"] is not None
        assert d1["params"]
        series = next(iter(d1["params"].values()))
        assert len(series["mean_magnitude"]) == len(d1["iterations"])
        _train_with_listener(storage, n_iters=5)
        with urllib.request.urlopen(f"{base}/train/model/data") as r:
            d2 = json.loads(r.read())
        assert len(d2["iterations"]) > len(d1["iterations"])
        with urllib.request.urlopen(f"{base}/train/histograms/page") as r:
            hist = r.read().decode()
        assert 'http-equiv="refresh"' in hist
    finally:
        server.stop()


def test_same_records_give_identical_json_and_pages():
    """Both packages' servers over the same records (stats from a port
    network's run, flow and activation captures, a t-SNE upload): every
    route answers the same bytes."""
    from deeplearning4j_tpu_torch.ui.flow import FlowListener

    src = InMemoryStatsStorage()
    net = _train_with_listener(src, n_iters=3)
    FlowListener(src).iteration_done(net, 3)
    src.put_record(StatsRecord(
        "conv-session", "activations", "w0", time.time(),
        {"iteration": 3, "channels": [[[0.0, 0.5], [1.0, 0.25]]]}))
    records = [r for sid in src.list_session_ids()
               for r in src.get_records(sid)]
    servers = [JU.UIServer(port=0), TU.UIServer(port=0)]
    try:
        bases = []
        for M, s in zip((JU, TU), servers):
            st = M.InMemoryStatsStorage()
            for r in records:
                st.put_record(M.StatsRecord.from_json(r.to_json()))
            s.attach(st)
            bases.append(f"http://127.0.0.1:{s.port}")
        upload = {"coords": [[0.5, -1.0], [2.0, 3.5], [1e-3, 7.0]],
                  "labels": ["v0", "v<1>", "v2"]}
        for b in bases:
            assert _post(b, "/tsne/upload", upload) == (200, {"ok": True,
                                                              "points": 3})
        for path in ROUTES + ("/no/such/page",):
            a, b = _get(bases[0], path), _get(bases[1], path)
            assert a == b, path
            assert a[0] == (404 if path == "/no/such/page" else 200)
        assert _get(bases[1], "/tsne")[1].count(b"<circle") == 3
    finally:
        for s in servers:
            s.stop()


def test_get_instance_attach_detach_and_stop():
    s = UIServer.get_instance(port=0)
    try:
        assert UIServer.get_instance() is s
        st = InMemoryStatsStorage()
        s.attach(st)
        s.attach(st)
        assert s._storages == [st]
        st.put_record(StatsRecord("a", "stats", "w", 1.0, {"iteration": 1}))
        base = f"http://127.0.0.1:{s.port}"
        assert json.loads(_get(base, "/train/sessions")[1]) == \
            {"sessions": ["a"]}
        s.detach(st)
        code, body = _post(base, "/remote/receive", {})
        assert code == 400
        rec = StatsRecord("b", "stats", "w", 1.0, {})
        req = urllib.request.Request(base + "/remote/receive",
                                     data=rec.to_json().encode(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 503
    finally:
        s.stop()
    assert UIServer._instance is None


def test_remote_router_counts_drops_and_warns_rate_limited(caplog):
    router = RemoteUIStatsStorageRouter("http://127.0.0.1:9",
                                        queue_size=2, retries=1,
                                        timeout=0.2, backoff=0.01,
                                        warn_every=60.0)
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        for i in range(30):
            router.put_record(StatsRecord("s", "stats", "w", time.time(),
                                          {"i": i}))
        deadline = time.time() + 15
        while router.dropped_count < 5 and time.time() < deadline:
            time.sleep(0.05)
    router.shutdown()
    assert router.dropped_count >= 5
    warnings = [r for r in caplog.records
                if "dropping stats records" in r.message]
    assert len(warnings) == 1, "drop warning must be rate-limited"


def test_remote_router_retries_transient_post_failure():
    router = RemoteUIStatsStorageRouter("http://127.0.0.1:9",
                                        retries=3, backoff=0.01)
    calls = {"n": 0}
    delivered = []

    def flaky(body):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConnectionError("transient")
        delivered.append(body)

    router._post_once = flaky
    router.put_record(StatsRecord("s", "stats", "w", time.time(), {"x": 1}))
    deadline = time.time() + 10
    while not delivered and time.time() < deadline:
        time.sleep(0.02)
    router.shutdown()
    assert calls["n"] == 2 and len(delivered) == 1
    assert router.dropped_count == 0
