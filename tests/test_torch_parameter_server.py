"""The port's parameter server (`parallel.parameter_server`): the
in-process store and its retrying client, the TCP wire against the JAX
package's, and worker processes, on the CPU.

The wire is the JAX package's byte for byte (1-byte op, big-endian u64
length, f32 payload; `P`/`R`, `U`/`A`, `V` with a 32-byte hex id, `Q`),
so either package's client pushes to either package's server, and a
duplicate `V` push is dropped by either server. Worker processes are
`python -m deeplearning4j_tpu_torch.parallel.parameter_server ...
--device cpu` on the shared tiny fixture (at most 2 at a time, each
bounded to 30 s). Tolerances: the TCP result equals the in-process store
fed the same pull/fit/push sequences to 1e-6 relative / 1e-7 absolute
(the JAX package's own transport-parity tolerance); the hammer's
aggregate is exact.
"""
import logging
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu.parallel import parameter_server as jps  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.parallel import parameter_server as pps  # noqa: E402
from deeplearning4j_tpu_torch.parallel.fault_tolerance import (  # noqa: E402
    ParameterServerStallInjector,
)
from deeplearning4j_tpu_torch.parallel.multiprocess import (  # noqa: E402
    _parity_fixture_data,
    _parity_fixture_net,
    free_port,
    run_workers,
)
from deeplearning4j_tpu_torch.parallel.parameter_server import (  # noqa: E402
    NetworkParameterServer,
    ParameterServer,
    ParameterServerParallelWrapper,
    ParameterServerTimeoutError,
    RemoteParameterServerClient,
    RetryingParameterServerClient,
)

LOGGER = "deeplearning4j_tpu_torch"
WORKER_TIMEOUT = 30


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
def _bounded_wall():
    t0 = time.monotonic()
    yield
    assert time.monotonic() - t0 < 90.0


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# --------------------------------------------------------- the store
def test_parameter_server_push_dedup():
    ps = ParameterServer(np.zeros(2, np.float32))
    ps.push_update(np.ones(2, np.float32), request_id="a" * 32)
    ps.push_update(np.ones(2, np.float32), request_id="a" * 32)  # dropped
    ps.push_update(np.ones(2, np.float32), request_id="b" * 32)
    assert ps.num_pushes == 2
    np.testing.assert_allclose(ps.pull(), 2 * np.ones(2))


def test_stalled_ps_raises_after_bounded_backoff(caplog):
    store = ParameterServer(np.zeros(4, np.float32))
    stalled = ParameterServerStallInjector(store, stall_after=1)
    client = RetryingParameterServerClient(stalled, timeout=0.1,
                                           max_retries=2, backoff=0.01)
    try:
        np.testing.assert_allclose(client.pull(), np.zeros(4))
        with caplog.at_level(logging.WARNING, logger=LOGGER):
            with pytest.raises(ParameterServerTimeoutError):
                client.push_update(np.ones(4, np.float32))
        assert client.attempts == 1 + 3
        assert client.timeouts == 3
        assert stalled.stalled_requests >= 1
        assert any("ParameterServerStallInjector: stalling" in r.message
                   for r in caplog.records)
        assert any("backing off" in r.message for r in caplog.records)
    finally:
        stalled.release()


def _fixture_batches():
    feats, labels = _parity_fixture_data()
    return [DataSet(feats[i], labels[i]) for i in range(feats.shape[0])]


def test_ps_wrapper_surfaces_stall_instead_of_deadlocking():
    net = _parity_fixture_net("cpu")
    stalled = ParameterServerStallInjector(
        ParameterServer(_np(net.params())), stall_after=2)
    psw = ParameterServerParallelWrapper(net, workers=2, sync_frequency=1,
                                         server=stalled,
                                         request_timeout=0.2, max_retries=1,
                                         retry_backoff=0.01)
    try:
        with pytest.raises(ParameterServerTimeoutError):
            psw.fit(ListDataSetIterator(_fixture_batches()), epochs=2)
    finally:
        stalled.release()


def test_retrying_client_recovers_from_transient_stall():
    store = ParameterServer(np.zeros(3, np.float32))

    class BriefStall:
        def __init__(self):
            self.calls = 0

        def pull(self):
            self.calls += 1
            if self.calls == 1:
                time.sleep(0.3)
            return store.pull()

        def push_update(self, delta):
            store.push_update(delta)

    client = RetryingParameterServerClient(BriefStall(), timeout=0.1,
                                           max_retries=2, backoff=0.01)
    np.testing.assert_allclose(client.pull(), np.zeros(3))
    assert client.timeouts == 1 and client.attempts == 2


def test_abandoned_push_attempts_commit_at_most_once():
    store = ParameterServer(np.zeros(2, np.float32))
    stalled = ParameterServerStallInjector(store, stall_after=0,
                                           stall_seconds=0.4)
    client = RetryingParameterServerClient(stalled, timeout=0.05,
                                           max_retries=2, backoff=0.01)
    with pytest.raises(ParameterServerTimeoutError):
        client.push_update(np.ones(2, np.float32))
    time.sleep(0.8)
    assert stalled.stalled_requests == 3
    assert store.num_pushes == 1
    np.testing.assert_allclose(store.pull(), np.ones(2))


def test_retrying_client_reuses_dispatcher_thread():
    store = ParameterServer(np.zeros(2, np.float32))
    client = RetryingParameterServerClient(store, timeout=1.0)
    for _ in range(5):
        client.pull()
        client.push_update(np.ones(2, np.float32))
    d = client._dispatcher
    assert d is not None and not d.abandoned
    assert store.num_pushes == 5
    client.close()


# ------------------------------------------------------------ the wire
class _Recorder:
    """A socket stand-in that records what is sent."""

    def __init__(self):
        self.sent = b""

    def sendall(self, b):
        self.sent += b


def test_wire_frames_equal_the_jax_packages():
    """`_send_msg` writes the JAX package's bytes for every op."""
    payload = np.arange(5, dtype=np.float32).tobytes()
    for op, body in ((b"P", b""), (b"R", payload), (b"U", payload),
                     (b"A", b""), (b"V", b"f" * 32 + payload), (b"Q", b"")):
        a, b = _Recorder(), _Recorder()
        pps._send_msg(a, op, body)
        jps._send_msg(b, op, body)
        assert a.sent == b.sent
        assert a.sent[:9] == op + len(body).to_bytes(8, "big")


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "port"), ("jax", "port"), ("port", "jax"), ("jax", "jax")])
def test_either_client_pushes_to_either_server(client_pkg, server_pkg):
    """Pull, push (`U`), an idempotent push (`V`) and its duplicate,
    which either server drops; quit (`Q`)."""
    S = pps if server_pkg == "port" else jps
    C = pps if client_pkg == "port" else jps
    init = np.arange(8, dtype=np.float32)
    srv = S.NetworkParameterServer(init)
    try:
        c = C.RemoteParameterServerClient(*srv.address, timeout=10.0)
        np.testing.assert_array_equal(c.pull(), init)
        c.push_update(np.full(8, 0.25, np.float32))
        rid = "ab" * 16
        c.push_update(np.full(8, 0.5, np.float32), request_id=rid)
        c.push_update(np.full(8, 0.5, np.float32), request_id=rid)  # dup
        np.testing.assert_array_equal(c.pull(), init + 0.75)
        assert srv.num_pushes == 2
        c.close()
    finally:
        srv.close()


def test_retrying_client_over_tcp_is_idempotent():
    """The retrying client sends `V` pushes to a remote store: each
    logical push lands once."""
    srv = NetworkParameterServer(np.zeros(4, np.float32))
    try:
        client = RetryingParameterServerClient(
            RemoteParameterServerClient(*srv.address, timeout=5.0),
            timeout=5.0)
        for _ in range(3):
            client.push_update(np.ones(4, np.float32))
        np.testing.assert_array_equal(srv.pull(), np.full(4, 3.0))
        assert srv.num_pushes == 3
        client.close()
    finally:
        srv.close()


def test_wrapper_trains_against_tcp_server():
    """The wrapper's worker threads train through the network client:
    every push arrives (6 batches x 2 epochs, sync 1) and the trained
    net takes the server's aggregate."""
    net = _parity_fixture_net("cpu")
    srv = NetworkParameterServer(net.params())
    try:
        client = RemoteParameterServerClient(*srv.address)
        ParameterServerParallelWrapper(net, workers=2, sync_frequency=1,
                                       server=client).fit(
            ListDataSetIterator(_fixture_batches()), epochs=2)
        assert srv.num_pushes == 12
        np.testing.assert_array_equal(_np(net.params()), srv.pull())
        assert not np.allclose(srv.pull(),
                               _np(_parity_fixture_net("cpu").params()))
        client.close()
    finally:
        srv.close()


# ------------------------------------------------------ worker processes
def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(__import__("pathlib").Path(__file__).resolve().parents[1])]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _cmd(port, w, n_workers, sync_freq, mode, *extra):
    return [sys.executable, "-m",
            "deeplearning4j_tpu_torch.parallel.parameter_server",
            "localhost", str(port), str(w), str(n_workers), str(sync_freq),
            mode, *extra, "--device", "cpu"]


def _run(cmds):
    procs, logs = run_workers(cmds, _env(), timeout=WORKER_TIMEOUT)
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, (lg or "")[-3000:]
    return logs


def test_two_os_processes_match_in_process_store(tmp_path):
    """Two worker processes train against the TCP server one after the
    other (a deterministic async schedule); the result equals the same
    sequences applied to an in-process store by `mode local` from the
    server's exact initial params: the transport changes no value."""
    net = _parity_fixture_net("cpu")
    init = _np(net.params())
    np.save(tmp_path / "init.npy", init)
    srv = NetworkParameterServer(init)
    try:
        logs = []
        for w in range(2):
            logs += _run([_cmd(srv.address[1], w, 2, 1, "train")])
        assert all("DONE train" in lg and "device=cpu" in lg for lg in logs)
        tcp = srv.pull()
        assert srv.num_pushes == 6
    finally:
        srv.close()
    _run([_cmd(0, 0, 2, 1, "local", str(tmp_path / "ref.npy"),
               str(tmp_path / "init.npy"))])
    np.testing.assert_allclose(tcp, np.load(tmp_path / "ref.npy"),
                               rtol=1e-6, atol=1e-7)


def test_concurrent_processes_lose_no_pushes():
    srv = NetworkParameterServer(np.zeros(16, np.float32))
    try:
        _run([_cmd(srv.address[1], w, 2, 1, "hammer") for w in range(2)])
        assert srv.num_pushes == 100
        np.testing.assert_array_equal(srv.pull(),
                                      np.full(16, 50.0, np.float32))
    finally:
        srv.close()


def test_sync_frequency_batches_per_push():
    """sync_frequency=2 over 3 batches a worker: 2 pushes each (one of
    them the tail), so 4 in all."""
    net = _parity_fixture_net("cpu")
    srv = NetworkParameterServer(net.params())
    try:
        logs = _run([_cmd(srv.address[1], w, 2, 2, "train")
                     for w in range(2)])
        assert all("DONE train" in lg for lg in logs)
        assert srv.num_pushes == 4
    finally:
        srv.close()


def test_worker_process_defaults_to_the_card():
    """Without `--device` the worker asks for the card: where there is
    none it fails at startup instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is satisfied")
    srv = NetworkParameterServer(np.zeros(
        _np(_parity_fixture_net("cpu").params()).shape, np.float32))
    try:
        cmd = _cmd(srv.address[1], 0, 1, 1, "train")[:-2]
        procs, logs = run_workers([cmd], _env(), timeout=WORKER_TIMEOUT)
        assert procs[0].returncode != 0
        assert "no CUDA device" in logs[0]
        assert srv.num_pushes == 0
    finally:
        srv.close()


def test_free_port_is_bindable():
    port = free_port()
    s = socket.socket()
    try:
        s.bind(("localhost", port))
    finally:
        s.close()


def test_server_survives_a_torn_connection():
    """A client that dies mid-message costs its own connection only."""
    srv = NetworkParameterServer(np.zeros(4, np.float32))
    try:
        raw = socket.create_connection(srv.address)
        raw.sendall(b"U" + (64).to_bytes(8, "big") + b"\0" * 10)
        raw.close()
        c = RemoteParameterServerClient(*srv.address, timeout=5.0)
        c.push_update(np.ones(4, np.float32))
        np.testing.assert_array_equal(c.pull(), np.ones(4))
        assert srv.num_pushes == 1
        c.close()
    finally:
        srv.close()


def test_hammer_threads_in_process():
    """Four threads, each with its own client, hammer one server: every
    push lands exactly once."""
    srv = NetworkParameterServer(np.zeros(8, np.float32))
    try:
        def hammer():
            c = RemoteParameterServerClient(*srv.address, timeout=10.0)
            for _ in range(25):
                c.push_update(np.full(8, 0.5, np.float32))
            c.close()

        ts = [threading.Thread(target=hammer) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert srv.num_pushes == 100
        np.testing.assert_array_equal(srv.pull(), np.full(8, 50.0))
    finally:
        srv.close()
