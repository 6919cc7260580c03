"""The port's gateway (`deeplearning4j_tpu_torch.gateway`) held against
the JAX package's on the CPU: the wire codec gives the same strings in
both packages; the JAX package's gateway robustness cases pass against
the port's server; one zip written from a JAX network, loaded into a JAX
and a port `GatewayServer`, answers the other package's `GatewayClient`
the same both ways (`predict` to 1e-5, greedy `generate` token for
token, `fit`'s score to 1e-6, `evaluate` equal); a stream over TCP
concatenates to the unary result and resumes after a tear; the
exactly-once door returns a retried `fit`'s float and lets a client
`claim` a generation whose connection died; a restarted gateway replays
a journaled request.
"""
import json
import signal
import socket
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu import gateway as jgw  # noqa: E402
from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.ops.activations import Activation  # noqa: E402
from deeplearning4j_tpu.ops.losses import LossFunction  # noqa: E402
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402
from deeplearning4j_tpu_torch import gateway as pgw  # noqa: E402
from deeplearning4j_tpu_torch.gateway import (  # noqa: E402
    EntryPoint,
    GatewayClient,
    GatewayError,
    GatewayServer,
    encode_value,
)
from deeplearning4j_tpu_torch.models.transformer import (  # noqa: E402
    generate,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving.exactly_once import (  # noqa: E402
    RequestJournal,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    restore_model,
)

VOCAB = 48
WEDGE_GUARD_S = 120
GEN = {"n_slots": 2, "max_len": 48, "prompt_buckets": (8,)}


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


@pytest.fixture(autouse=True)
def _wedge_guard():
    """A wire test that wedges dies by SIGALRM instead of eating the
    tier's time."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def boom(signum, frame):
        raise TimeoutError(
            f"gateway test exceeded the {WEDGE_GUARD_S} s wedge guard")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(WEDGE_GUARD_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _conf(seed=7):
    return (dl4j.NeuralNetConfiguration.Builder()
            .seed(seed).learning_rate(0.3)
            .list()
            .layer(DenseLayer(n_in=4, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=3,
                               activation=Activation.SOFTMAX,
                               loss=LossFunction.MCXENT))
            .build())


def _gpt_conf(seed=12345):
    return jax_gpt_configuration(vocab_size=VOCAB, d_model=32, n_heads=2,
                                 n_layers=2, max_length=64, seed=seed)


def _data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, n)
    x = (rng.normal(size=(n, 4)) + c[:, None]).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[c]


def _prompt(t0=5, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, t0).astype(
        np.int32)


def _server(**kw):
    kw.setdefault("device", "cpu")
    return GatewayServer(**kw).start()


def _raw_conn(port, timeout=30.0):
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    return s, s.makefile("rwb")


def _await(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    pytest.fail(f"timed out after {timeout:.0f}s waiting for {what}")


def _slow(dt=0.02):
    """A pre-decode drag: one token per ~dt keeps a generation in flight
    long enough for a tear or a disconnect to land mid-stream."""
    def hook(phase, info):
        if phase == "pre_decode":
            time.sleep(dt)
    return hook


# ------------------------------------------------------------ the codec
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "bool", "uint16"])
def test_codec_strings_equal_the_jax_package(dtype):
    """`encode_array` gives the JAX package's string for the same array,
    and each package decodes the other's to the same values and dtype."""
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(3, 5)) * 100).astype(dtype)
    s = pgw.encode_array(a)
    assert s == jgw.encode_array(a)
    for got in (pgw.decode_value(jgw.encode_array(a)),
                jgw.decode_value(s)):
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)
    nested = {"x": [a, {"y": a[:1]}], "n": 3}
    assert json.dumps(pgw.encode_value(nested)) \
        == json.dumps(jgw.encode_value(nested))


def test_codec_sends_a_tensor_as_its_host_copy():
    """A torch result leaves as its host copy; a 16-bit float tensor as
    its f32 copy (the npy format has no bf16), so a JAX client decodes
    it."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7
    assert pgw.encode_value(t) == jgw.encode_array(t.numpy())
    b = t.to(torch.bfloat16)
    got = jgw.decode_value(pgw.encode_value({"r": b}))["r"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, b.float().numpy())
    assert pgw.encode_value(np.float32(1.5)) == 1.5


# ------------------------------------------------------- request bounds
def test_oversized_request_typed_error_then_close():
    server = _server(max_request_bytes=1024)
    try:
        s, f = _raw_conn(server.port)
        f.write(b'{"pad": "' + b"x" * 4096 + b'"}\n')
        f.flush()
        resp = json.loads(f.readline())
        assert resp["error_type"] == "RequestTooLargeError"
        assert "max_request_bytes" in resp["error"]
        assert f.readline() == b""
        f.close()
        s.close()
    finally:
        server.stop()


def test_request_at_the_bound_still_served():
    server = _server(max_request_bytes=4096)
    try:
        s, f = _raw_conn(server.port)
        req = {"id": 1, "method": "score", "params": {"name": "nope"}}
        f.write((json.dumps(req) + "\n").encode())
        f.flush()
        resp = json.loads(f.readline())
        assert resp["id"] == 1 and resp["error_type"] == "KeyError"
        f.close()
        s.close()
    finally:
        server.stop()


# ---------------------------------------------------- silent/dead clients
def test_silent_client_released_by_recv_timeout():
    server = _server(recv_timeout=0.3)
    try:
        s = socket.create_connection(("127.0.0.1", server.port), timeout=30)
        s.settimeout(10.0)
        t0 = time.monotonic()
        assert s.recv(1) == b"", "server should close the idle connection"
        assert time.monotonic() - t0 < 5.0
        s.close()
    finally:
        server.stop()


def test_mid_request_disconnect_leaves_server_alive():
    server = _server(recv_timeout=0.5)
    try:
        s, f = _raw_conn(server.port)
        f.write(b'{"id": 1, "method": "scor')
        f.flush()
        s.close()
        client = GatewayClient(port=server.port)
        with pytest.raises(GatewayError, match="no model"):
            client.call("score", name="ghost")
        client.close()
    finally:
        server.stop()


def test_disconnect_while_response_pending():
    server = _server()
    try:
        x, _ = _data()
        setup = GatewayClient(port=server.port)
        setup.call("create_model", name="m", config=_conf().to_json())
        s, f = _raw_conn(server.port)
        req = {"id": 1, "method": "predict",
               "params": encode_value({"name": "m", "features": x})}
        f.write((json.dumps(req) + "\n").encode())
        f.flush()
        s.close()
        time.sleep(0.3)
        out = setup.call("predict", name="m", features=x)
        assert out.shape == (24, 3)
        setup.close()
    finally:
        server.stop()


# ------------------------------------------------------ concurrent load
def test_concurrent_clients_all_served():
    server = _server()
    try:
        x, _ = _data()
        boot = GatewayClient(port=server.port)
        boot.call("create_model", name="m", config=_conf().to_json())
        boot.close()
        results, errors = [], []
        lock = threading.Lock()

        def worker():
            try:
                c = GatewayClient(port=server.port)
                for _ in range(3):
                    out = c.call("predict", name="m", features=x)
                    with lock:
                        results.append(out.shape)
                c.close()
            except Exception as e:  # surfaced below
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert results == [(24, 3)] * 12
    finally:
        server.stop()


# --------------------------------------------------- typed error payloads
def test_malformed_json_typed_error_connection_alive():
    server = _server()
    try:
        s, f = _raw_conn(server.port)
        f.write(b"this is not json\n")
        f.flush()
        resp = json.loads(f.readline())
        assert resp["id"] is None and "error" in resp
        assert resp["error_type"] == "JSONDecodeError"
        f.write((json.dumps({"id": 2, "method": "score",
                             "params": {"name": "n"}}) + "\n").encode())
        f.flush()
        assert json.loads(f.readline())["id"] == 2
        f.close()
        s.close()
    finally:
        server.stop()


def test_client_surfaces_typed_gateway_error():
    server = _server()
    try:
        client = GatewayClient(port=server.port)
        with pytest.raises(GatewayError, match="no model") as ei:
            client.call("score", name="ghost")
        assert ei.value.error_type == "KeyError"
        assert isinstance(ei.value, RuntimeError)
        client.close()
    finally:
        server.stop()


@pytest.mark.chaos
def test_overload_shed_surfaces_retry_after_through_gateway():
    from deeplearning4j_tpu_torch.serving import SlowInferenceInjector

    server = _server(serving={"max_queue": 1, "max_batch_size": 2,
                              "batch_window": 0.0})
    try:
        x, _ = _data()
        boot = GatewayClient(port=server.port)
        boot.call("create_model", name="m", config=_conf().to_json())
        boot.call("predict", name="m", features=x)
        slow = SlowInferenceInjector(delay=0.6)
        server.entry._servers["m"].infer_hooks.append(slow)
        sheds, lock = [], threading.Lock()

        def flood():
            c = GatewayClient(port=server.port)
            try:
                c.call("predict", name="m", features=x)
            except GatewayError as e:
                with lock:
                    sheds.append(e)
            c.close()

        threads = [threading.Thread(target=flood) for _ in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.02)
        slow.release()
        for t in threads:
            t.join()
        assert sheds, "no request was shed through the gateway"
        assert all(e.error_type == "ServerOverloadedError" for e in sheds)
        assert all(e.retry_after and e.retry_after > 0 for e in sheds)
        boot.close()
    finally:
        server.stop()


@pytest.mark.chaos
def test_reload_corrupt_checkpoint_via_gateway_keeps_serving():
    from deeplearning4j_tpu_torch.serving import ReloadCorruptionInjector
    from deeplearning4j_tpu_torch.util.checkpoint_store import (
        CheckpointStore,
    )
    from deeplearning4j_tpu_torch.util.serialization import write_model

    server = _server(serving=True)
    try:
        x, y = _data()
        client = GatewayClient(port=server.port)
        client.call("create_model", name="m", config=_conf().to_json())
        client.call("fit", name="m", features=x, labels=y, epochs=3)
        before = client.call("predict", name="m", features=x)
        with tempfile.TemporaryDirectory() as d:
            store = CheckpointStore(d)
            net2 = MultiLayerNetwork(server.entry._models["m"].conf,
                                     device="cpu")
            net2.init()
            path = store.save(1, lambda tmp: write_model(net2, tmp,
                                                         atomic=False))
            ReloadCorruptionInjector().corrupt_payload(path)
            with pytest.raises(GatewayError) as ei:
                client.call("reload_model", name="m", path=d, step=1)
            assert ei.value.error_type == "CheckpointCorruptError"
            after = client.call("predict", name="m", features=x)
            np.testing.assert_allclose(after, before, atol=1e-6)
            assert client.call("server_stats",
                               name="m")["model_version"] == 0
        client.close()
    finally:
        server.stop()


# --------------------------------------------------- client-side retries
def test_idempotent_call_retries_over_fresh_connection():
    server = _server()
    try:
        x, _ = _data()
        client = GatewayClient(port=server.port)
        client.call("create_model", name="m", config=_conf().to_json())
        client._sock.shutdown(socket.SHUT_WR)
        time.sleep(0.1)
        out = client.call("predict", name="m", features=x)
        assert out.shape == (24, 3)
        client.close()
    finally:
        server.stop()


def test_non_idempotent_call_never_retries():
    server = _server()
    try:
        x, y = _data()
        client = GatewayClient(port=server.port)
        client.call("create_model", name="m", config=_conf().to_json())
        client._sock.shutdown(socket.SHUT_WR)
        time.sleep(0.1)
        with pytest.raises((ConnectionError, OSError)):
            client.call("fit", name="m", features=x, labels=y)
        client.close()
    finally:
        server.stop()


def test_explicit_idempotent_override_enables_retry(tmp_path):
    server = _server()
    try:
        client = GatewayClient(port=server.port)
        client.call("create_model", name="m", config=_conf().to_json())
        client._sock.shutdown(socket.SHUT_WR)
        time.sleep(0.1)
        name = client.call("save_model", _idempotent=True, name="m",
                           path=str(tmp_path / "retry_model.zip"))
        assert name.endswith(".zip")
        client.close()
    finally:
        server.stop()


def test_entrypoint_shutdown_not_remotely_invokable():
    server = _server(serving=True)
    try:
        x, _ = _data()
        client = GatewayClient(port=server.port)
        client.call("create_model", name="m", config=_conf().to_json())
        with pytest.raises(GatewayError) as ei:
            client.call("shutdown")
        assert ei.value.error_type == "AttributeError"
        out = client.call("predict", name="m", features=x)
        assert out.shape == (24, 3)
        assert client.call("server_stats", name="m")["served"] == 1
        client.close()
    finally:
        server.stop()


def test_every_gateway_rpc_has_a_classified_retry_story():
    """Every public method of the port's entry points is classified in
    the port's `serving.exactly_once` ledger, as in the JAX package."""
    import inspect

    from deeplearning4j_tpu_torch.serving.exactly_once import (
        DEDUPED_RPCS,
        JOURNALED_RPCS,
        SIDE_EFFECT_FREE_RPCS,
    )
    from deeplearning4j_tpu_torch.serving.remote_replica import (
        ReplicaEntryPoint,
    )

    assert not DEDUPED_RPCS & SIDE_EFFECT_FREE_RPCS
    classified = DEDUPED_RPCS | SIDE_EFFECT_FREE_RPCS
    for cls in (EntryPoint, ReplicaEntryPoint):
        exposed = {
            name for name, member in inspect.getmembers(cls)
            if callable(member) and not name.startswith("_")
            and name not in cls._RPC_EXCLUDED
        }
        assert not exposed - classified, sorted(exposed - classified)
    assert JOURNALED_RPCS <= classified


def test_serving_tier_survives_stop_start_cycle():
    server = _server(serving=True)
    try:
        x, _ = _data()
        client = GatewayClient(port=server.port)
        client.call("create_model", name="m", config=_conf().to_json())
        client.call("predict", name="m", features=x)
        client.close()
        server.stop()
        server.start()
        client = GatewayClient(port=server.port)
        out = client.call("predict", name="m", features=x)
        assert out.shape == (24, 3)
        assert client.call("server_stats", name="m")["served"] == 1
        client.close()
    finally:
        server.stop()


# ------------------------------------------------- the entry point's device
def test_entry_point_builds_on_its_device_and_defaults_to_the_card():
    """Models created or loaded through the wire live on the entry
    point's device; without `device` it asks for the card, which raises
    where there is none. `serving={"parallel": ...}` (A12b, ported)
    needs its slots: with one exposed, tp=2 is the engine's ValueError
    at the first generate."""
    ep = EntryPoint(device="cpu")
    ep.create_model("m", _conf().to_json())
    assert ep._models["m"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EntryPoint()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GatewayServer()
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh

    tp = EntryPoint(serving={"parallel": {"tp": 2},
                             "generation": {"n_slots": 1, "max_len": 16,
                                            "prompt_buckets": (8,)}},
                    device="cpu")
    tp.create_model("m", _gpt_conf().to_json())
    saved = pmesh._SLOTS
    pmesh.set_local_slots(1, "cpu")
    try:
        with pytest.raises(Exception, match="needs 2 devices"):
            tp.generate("m", np.zeros(4, np.int32), 2)
    finally:
        pmesh._SLOTS = saved
        tp.shutdown()
    for bad, match in (({"replicas": 0}, "replicas"),
                       ({"pool": {"probe_interval": 1.0}}, "pool"),
                       ({"autoscale": True}, "autoscale"),
                       ({"disagg": True, "replicas": 2}, "disagg")):
        with pytest.raises(ValueError, match=match):
            EntryPoint(serving=bad, device="cpu").create_model(
                "m", _conf().to_json())


# ---------------------------------------------------- cross-package wire
@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    """One MLP zip and one GPT zip, each written from a JAX network."""
    d = tmp_path_factory.mktemp("cross")
    mlp = JaxNet(_conf())
    mlp.init()
    gpt = JaxNet(_gpt_conf())
    gpt.init()
    jser.write_model(mlp, d / "mlp.zip")
    jser.write_model(gpt, d / "gpt.zip")
    return d / "mlp.zip", d / "gpt.zip"


def _pair_of_servers(**serving):
    """(JAX server, port server) with the serving tier on each."""
    jsrv = jgw.GatewayServer(serving=serving).start()
    psrv = GatewayServer(serving=serving, device="cpu").start()
    return jsrv, psrv


DIRECTIONS = ("jax-client-port-server", "port-client-jax-server")


def _client_for(direction, jsrv, psrv):
    if direction == "jax-client-port-server":
        return jgw.GatewayClient(port=psrv.port), jgw.GatewayError
    return GatewayClient(port=jsrv.port), GatewayError


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cross_package_predict_fit_evaluate(zips, direction):
    """The same zip behind a JAX and a port gateway: the other package's
    client gets `predict` within 1e-5 of the same-package answer,
    `fit`'s score within 1e-6 and `evaluate` equal."""
    mlp, _ = zips
    x, y = _data(seed=4)
    jsrv, psrv = _pair_of_servers()
    try:
        cross, err = _client_for(direction, jsrv, psrv)
        same = jgw.GatewayClient(port=jsrv.port) \
            if direction == "port-client-jax-server" \
            else GatewayClient(port=psrv.port)
        # the reference answers on each server: the JAX client on the
        # JAX server and the port client on the port server
        ref = jgw.GatewayClient(port=jsrv.port)
        port = GatewayClient(port=psrv.port)
        for c in (ref, port):
            assert c.call("load_model", name="m", path=str(mlp)) == "m"
        want = ref.call("predict", name="m", features=x)
        got_cross = cross.call("predict", name="m", features=x)
        got_same = same.call("predict", name="m", features=x)
        assert got_cross.dtype == np.float32 and got_cross.shape == (24, 3)
        np.testing.assert_allclose(got_cross, want, atol=1e-5)
        np.testing.assert_allclose(got_same, want, atol=1e-5)
        ev_j = ref.call("evaluate", name="m", features=x, labels=y)
        ev_p = port.call("evaluate", name="m", features=x, labels=y)
        assert ev_p == ev_j
        s_j = ref.call("fit", name="m", features=x, labels=y)
        s_p = port.call("fit", name="m", features=x, labels=y)
        assert isinstance(s_p, float)
        assert s_p == pytest.approx(s_j, abs=1e-6, rel=1e-6)
        np.testing.assert_allclose(
            cross.call("predict", name="m", features=x),
            ref.call("predict", name="m", features=x), atol=1e-5)
        with pytest.raises(err) as ei:
            cross.call("score", name="ghost")
        assert ei.value.error_type == "KeyError"
        for c in (cross, same, ref, port):
            c.close()
    finally:
        jsrv.stop()
        psrv.stop()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cross_package_greedy_generate_token_identical(zips, direction):
    """A GPT zip written by the JAX package, served by both packages'
    gateways through their decode engines: the other package's client
    gets the same greedy tokens as `generate` on the port network, and
    as the JAX gateway's."""
    _, gpt = zips
    jsrv, psrv = _pair_of_servers(generation=GEN)
    try:
        cross, _ = _client_for(direction, jsrv, psrv)
        ref = jgw.GatewayClient(port=jsrv.port)
        port = GatewayClient(port=psrv.port)
        for c in (ref, port):
            c.call("load_model", name="g", path=str(gpt))
        net = restore_model(gpt, device="cpu")
        for seed, n in ((0, 8), (1, 12)):
            p = _prompt(seed=seed)
            want = generate(net, p[None], n, temperature=0.0,
                            device="cpu")[0]
            got = cross.call("generate", name="g", prompt_ids=p, n_tokens=n,
                             _timeout=120.0)
            np.testing.assert_array_equal(np.asarray(got), want)
            np.testing.assert_array_equal(
                np.asarray(ref.call("generate", name="g", prompt_ids=p,
                                    n_tokens=n, _timeout=120.0)), want)
        for c in (cross, ref, port):
            c.close()
    finally:
        jsrv.stop()
        psrv.stop()


# ------------------------------------------------------------ streams
def _gpt_server(generation=None, **kw):
    gen = dict(GEN)
    gen.update(generation or {})
    server = GatewayServer(serving={"generation": gen}, device="cpu", **kw)
    server.entry.create_model("g", _gpt_conf().to_json())
    return server.start()


def test_stream_over_tcp_concatenates_to_unary():
    server = _gpt_server(generation={"decode_chunk": 1,
                                     "step_hooks": [_slow(0.01)]},
                         stream_coalesce=0.0)
    try:
        client = GatewayClient(port=server.port)
        p = _prompt()
        unary = np.asarray(client.call("generate", name="g", prompt_ids=p,
                                       n_tokens=16, seed=11,
                                       _timeout=120.0))
        frames = 0
        with client.generate_stream("g", p, 16, seed=11,
                                    _timeout=120.0) as s:
            for frame in s:
                frames += 1
                assert frame["cursor"] == len(s.tokens)
        np.testing.assert_array_equal(np.asarray(s.tokens), unary)
        assert frames >= 2, "no incremental delivery"
        client.close()
    finally:
        server.stop()


@pytest.mark.chaos
def test_torn_stream_resumes_at_cursor_bit_identical():
    server = _gpt_server(generation={"decode_chunk": 1,
                                     "step_hooks": [_slow(0.01)]})
    try:
        client = GatewayClient(port=server.port)
        p = _prompt()
        unary = np.asarray(client.call("generate", name="g", prompt_ids=p,
                                       n_tokens=16, seed=11,
                                       _timeout=120.0))
        with client.generate_stream("g", p, 16, seed=11,
                                    _timeout=120.0) as s:
            next(s)
            s._conn.sock.shutdown(socket.SHUT_RDWR)
            for _ in s:
                pass
        np.testing.assert_array_equal(np.asarray(s.tokens), unary)
        assert s.resumes >= 1
        assert server.entry.streams.stats()["stream_resumes"] >= 1
        client.close()
    finally:
        server.stop()


def test_jax_client_streams_from_the_port_gateway(zips):
    """The JAX package's `_GenStream` reads the port's frames: the
    concatenation equals the port's unary tokens."""
    _, gpt = zips
    server = GatewayServer(serving={"generation": GEN},
                           device="cpu").start()
    try:
        client = jgw.GatewayClient(port=server.port)
        client.call("load_model", name="g", path=str(gpt))
        p = _prompt(seed=2)
        unary = np.asarray(client.call("generate", name="g", prompt_ids=p,
                                       n_tokens=10, _timeout=120.0))
        with client.generate_stream("g", p, 10, _timeout=120.0) as s:
            for _ in s:
                pass
        np.testing.assert_array_equal(np.asarray(s.tokens), unary)
        client.close()
    finally:
        server.stop()


# -------------------------------------------------------- exactly once
def test_stamped_fit_retry_returns_original_outcome():
    server = _server(exactly_once=True)
    try:
        x, y = _data()
        client = GatewayClient(port=server.port, exactly_once=True)
        client.call("create_model", name="m", config=_conf().to_json())
        score = client.call("fit", name="m", features=x, labels=y)
        rid = client.last_request_id
        assert client.call("fit", _request_id=rid, name="m",
                           features=x, labels=y) == score
        # a fresh stamp trains again and scores differently
        assert client.call("fit", name="m", features=x, labels=y) != score
        st = client.call("exactly_once_stats")
        assert st["cache"]["dedup_hits"] >= 1
        assert st["cache"]["double_executions"] == 0
        client.close()
    finally:
        server.stop()


def test_exactly_once_client_retries_fit_over_dead_connection():
    server = _server(exactly_once=True)
    try:
        x, y = _data()
        client = GatewayClient(port=server.port, exactly_once=True)
        client.call("create_model", name="m", config=_conf().to_json())
        client._sock.shutdown(socket.SHUT_WR)
        time.sleep(0.1)
        assert isinstance(client.call("fit", name="m", features=x,
                                      labels=y), float)
        client.close()
    finally:
        server.stop()


def test_disconnect_mid_generate_parks_result_for_claim():
    gen = {"n_slots": 2, "max_len": 32, "prompt_buckets": (8,),
           "decode_chunk": 1, "step_hooks": [_slow()]}
    server = GatewayServer(serving={"generation": gen}, exactly_once=True,
                           device="cpu").start()
    try:
        boot = GatewayClient(port=server.port, exactly_once=True)
        boot.call("create_model", name="m", config=_gpt_conf().to_json())
        prompt = _prompt()
        expected = generate(server.entry._models["m"], prompt[None], 8,
                            temperature=0.0, device="cpu")[0]
        rid = "detached-gen-1"
        before = boot.call("exactly_once_stats")["cache"]["executions"]
        s = socket.create_connection(("127.0.0.1", server.port),
                                     timeout=30.0)
        req = {"id": 1, "method": "generate", "request_id": rid,
               "params": encode_value({"name": "m", "prompt_ids": prompt,
                                       "n_tokens": 8})}
        s.sendall((json.dumps(req) + "\n").encode())
        s.close()
        _await(lambda: boot.call(
                   "exactly_once_stats")["cache"]["executions"] > before,
               30.0, "the detached generate to pass the door")
        out = boot.claim(rid, timeout=60.0)
        np.testing.assert_array_equal(np.asarray(out), expected)
        with pytest.raises(GatewayError) as ei:
            boot.claim("nobody-sent-this")
        assert ei.value.error_type == "UnknownRequestError"
        boot.close()
    finally:
        server.stop()


def test_journal_replay_completes_accepted_request_after_restart(tmp_path):
    """A journaled admit left by a dead gateway replays on the next
    start once its model is installed; the client claims the tokens,
    with no double execution."""
    prompt = _prompt(seed=3)
    rid = "preboot-gen-1"
    j = RequestJournal(tmp_path)
    j.admit(rid, "generate", encode_value({"name": "m", "prompt_ids": prompt,
                                           "n_tokens": 6}))
    j.close()
    server = GatewayServer(
        serving={"generation": {"n_slots": 2, "max_len": 32,
                                "prompt_buckets": (8,)}},
        exactly_once={"journal_dir": tmp_path, "replay_timeout": 120.0},
        device="cpu").start()
    try:
        client = GatewayClient(port=server.port, exactly_once=True)
        time.sleep(0.2)
        assert client.call("exactly_once_stats")["replays"] == 0
        client.call("create_model", name="m", config=_gpt_conf().to_json())
        expected = generate(server.entry._models["m"], prompt[None], 6,
                            temperature=0.0, device="cpu")[0]
        _await(lambda: client.call("exactly_once_stats")["replays"] >= 1,
               120.0, "the journal replay")
        out = client.claim(rid, timeout=60.0)
        np.testing.assert_array_equal(np.asarray(out), expected)
        st = client.call("exactly_once_stats")
        assert st["journal"]["pending"] == 0
        assert st["cache"]["double_executions"] == 0
        client.close()
    finally:
        server.stop()
