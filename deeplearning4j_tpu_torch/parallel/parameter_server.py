"""Asynchronous data-parallel training via a parameter server
(counterpart of `deeplearning4j_tpu/parallel/parameter_server.py`).

Reference: `deeplearning4j-scaleout-parallelwrapper-parameter-server/...
/ParameterServerParallelWrapper.java:39`, which embeds an Aeron
`MediaDriver` (:160), starts a `ParameterServerNode` plus one
`ParameterServerClient` per worker (:215-218); workers asynchronously push
gradients / pull parameters.

The store is host numpy, as in the JAX package: a worker replica (a
`net.clone()` on the net's device, on its own thread) pulls the flat
parameter vector to the host, fits `sync_frequency` minibatches on the
device, and pushes (new - pulled) as a host delta. The network transport
(`NetworkParameterServer`, `RemoteParameterServerClient`) speaks the JAX
package's wire byte for byte: a 1-byte op, a big-endian u64 payload
length, an f32 payload (`P` pull -> `R` params, `U` push -> `A` ack, `V`
idempotent push: a 32-byte hex request id then the delta -> `A`, `Q`
quit), so either package's client pushes to either package's server.
`python -m deeplearning4j_tpu_torch.parallel.parameter_server ...
[--device cuda|cpu]` is the worker process of the TCP tests and of the
card's run; it trains on the card unless asked for the CPU.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, List, Optional, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,
    ListDataSetIterator,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _host(flat) -> np.ndarray:
    """A flat parameter vector (a tensor on any device, or an array) as a
    host numpy array."""
    if hasattr(flat, "detach"):
        return flat.detach().cpu().numpy()
    return np.asarray(flat)


class ParameterServer:
    """Shared parameter store with delta aggregation (reference: external
    `nd4j-parameter-server-node` — push gradient / pull params)."""

    _SEEN_PUSH_IDS_MAX = 1024

    def __init__(self, initial_params: np.ndarray):
        self._params = np.array(initial_params, copy=True)
        self._lock = threading.Lock()
        self._pushes = 0
        from collections import OrderedDict

        self._seen_push_ids: "OrderedDict[str, None]" = OrderedDict()

    def pull(self) -> np.ndarray:
        with self._lock:
            return self._params.copy()

    def push_update(self, delta: np.ndarray,
                    request_id: Optional[str] = None) -> None:
        """Apply a worker's accumulated parameter delta (async, hogwild-ish:
        no barrier, last-writer ordering is whatever the scheduler does —
        same semantics as the reference's async PS).

        `request_id` makes the push IDEMPOTENT: a retry re-delivering the
        same logical push (its first attempt timed out but eventually
        committed anyway) is dropped instead of double-applying the delta.
        The dedup window keeps the most recent ids, bounded in memory."""
        with self._lock:
            if request_id is not None:
                if request_id in self._seen_push_ids:
                    logger.warning("parameter server: dropped duplicate "
                                   "push %s", request_id)
                    return
                self._seen_push_ids[request_id] = None
                while len(self._seen_push_ids) > self._SEEN_PUSH_IDS_MAX:
                    self._seen_push_ids.popitem(last=False)
            self._params += delta
            self._pushes += 1

    @property
    def num_pushes(self) -> int:
        with self._lock:
            return self._pushes


class ParameterServerTimeoutError(RuntimeError):
    """A parameter-server request kept timing out across bounded
    exponential-backoff retries — raised instead of deadlocking the
    worker on a stalled server."""


class _RequestDispatcher:
    """Single reusable daemon thread serving a client's store requests.
    When a request exceeds its timeout the dispatcher is marked abandoned
    and replaced (the stuck thread unwinds on its own once the store
    unblocks, then exits) — the healthy path reuses one thread instead of
    spawning one per pull/push."""

    def __init__(self):
        self.requests: "queue.Queue" = queue.Queue()
        self.abandoned = False
        threading.Thread(target=self._loop, daemon=True,
                         name="ps-client-dispatch").start()

    def submit(self, fn: Callable) -> "queue.Queue":
        box: "queue.Queue" = queue.Queue(maxsize=1)
        self.requests.put((fn, box))
        return box

    def _loop(self) -> None:
        while True:
            fn, box = self.requests.get()
            if fn is None:
                return
            try:
                box.put(("ok", fn()))
            except BaseException as e:  # noqa: BLE001 — ferried to caller
                box.put(("err", e))
            if self.abandoned:
                return

    def close(self) -> None:
        self.requests.put((None, None))


class RetryingParameterServerClient:
    """Timeout/retry decorator for ANY pull/push parameter-server store —
    the in-process `ParameterServer`, a `RemoteParameterServerClient`, or
    a chaos wrapper (`ParameterServerStallInjector`).

    Each request is served by a reusable dispatcher thread and must
    answer within `timeout` seconds; a late/stalled attempt is abandoned
    and retried after exponential backoff
    (`backoff × backoff_multiplier^attempt`), at most `max_retries`
    retries. Exhaustion raises `ParameterServerTimeoutError` — a stalled
    server can cost bounded wall-clock, never a deadlocked training run.
    `ConnectionError`/`OSError` (transport hiccups, e.g. a socket timeout
    from a remote client) retry under the same budget; other exceptions
    are re-raised immediately (they are bugs, not stalls).

    Retried pushes carry a per-logical-push `request_id` when the store's
    `push_update` accepts one (all stores in this module do), so an
    abandoned attempt that eventually commits anyway cannot double-apply
    the delta — retries are exactly-once against such stores, and
    at-least-once against foreign stores without dedup support.

    One client serves ONE calling thread (the reference wires a
    `ParameterServerClient` per worker for the same reason): concurrent
    callers would serialize on the single dispatcher and count each
    other's queue time against their own timeout. Give each worker its
    own client over the shared store, as
    `ParameterServerParallelWrapper` does."""

    def __init__(self, store, timeout: float = 5.0, max_retries: int = 3,
                 backoff: float = 0.05, backoff_multiplier: float = 2.0):
        if timeout <= 0:
            raise ValueError("timeout must be positive")
        self._store = store
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff = backoff
        self.backoff_multiplier = backoff_multiplier
        self.attempts = 0   # total request attempts (observability)
        self.timeouts = 0   # attempts that timed out / errored transiently
        self._dispatcher: Optional[_RequestDispatcher] = None
        import inspect

        try:
            params = inspect.signature(store.push_update).parameters
            self._push_idempotent = (
                "request_id" in params
                or any(p.kind is p.VAR_KEYWORD for p in params.values()))
        except (TypeError, ValueError):
            self._push_idempotent = False

    def _call(self, name: str, fn: Callable):
        delay = self.backoff
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            self.attempts += 1
            d = self._dispatcher
            if d is None or d.abandoned:
                d = self._dispatcher = _RequestDispatcher()
            box = d.submit(fn)
            try:
                kind, val = box.get(timeout=self.timeout)
            except queue.Empty:
                d.abandoned = True
                self._dispatcher = None
                self.timeouts += 1
                last = ParameterServerTimeoutError(
                    f"parameter-server {name} timed out after "
                    f"{self.timeout}s (attempt {attempt + 1}/"
                    f"{self.max_retries + 1})")
                logger.warning("%s; backing off %.3fs", last, delay)
            else:
                if kind == "ok":
                    return val
                if not isinstance(val, (ConnectionError, OSError)):
                    raise val
                self.timeouts += 1
                last = val
                logger.warning(
                    "parameter-server %s failed (%s: %s); backing off "
                    "%.3fs (attempt %d/%d)", name, type(val).__name__, val,
                    delay, attempt + 1, self.max_retries + 1)
            if attempt < self.max_retries:
                time.sleep(delay)
                delay *= self.backoff_multiplier
        raise ParameterServerTimeoutError(
            f"parameter-server {name} gave up after "
            f"{self.max_retries + 1} attempts (last: {last})") from last

    def pull(self) -> np.ndarray:
        return self._call("pull", self._store.pull)

    def push_update(self, delta: np.ndarray) -> None:
        if self._push_idempotent:
            import uuid

            rid = uuid.uuid4().hex
            self._call("push", lambda: self._store.push_update(
                delta, request_id=rid))
        else:
            self._call("push", lambda: self._store.push_update(delta))

    @property
    def num_pushes(self) -> int:
        return self._store.num_pushes

    def shutdown(self) -> None:
        """Stop the dispatcher thread WITHOUT closing the wrapped store —
        the teardown for per-worker clients sharing one store."""
        if self._dispatcher is not None and not self._dispatcher.abandoned:
            self._dispatcher.close()
        self._dispatcher = None

    def close(self) -> None:
        self.shutdown()
        closer = getattr(self._store, "close", None)
        if closer is not None:
            closer()


def run_worker_protocol(store, replica, batches, sync_frequency: int) -> None:
    """THE worker half of the PS contract — pull, fit `sync_frequency`
    minibatches locally, push (new - pulled) as a delta, flush the tail.
    One definition shared by the in-process wrapper threads and both
    OS-process CLI modes, so the transport-parity test compares transports
    and can never drift on protocol details (sync cadence, tail flush)."""
    pending = 0
    pulled: Optional[np.ndarray] = None
    for ds in batches:
        if pending == 0:
            pulled = store.pull()
            replica.set_params(pulled)
        replica.fit(ds)
        pending += 1
        if pending >= sync_frequency:
            store.push_update(_host(replica.params()) - pulled)
            pending = 0
    if pending and pulled is not None:
        store.push_update(_host(replica.params()) - pulled)


class ParameterServerParallelWrapper:
    """Async multi-worker trainer (reference
    `ParameterServerParallelWrapper.java`).

    Each worker thread owns a model replica; it pulls current params, fits
    `sync_frequency` minibatches locally, then pushes (new - pulled) as a
    delta. Batches are distributed round-robin via a bounded queue (the
    reference uses `MagicQueue`-style per-worker queues).
    """

    _STOP = object()

    def __init__(self, net, workers: int = 2, sync_frequency: int = 1,
                 queue_capacity: int = 8, server=None,
                 request_timeout: Optional[float] = None,
                 max_retries: int = 3, retry_backoff: float = 0.05):
        """`server`: any object with the ParameterServer pull/push contract
        — pass a `RemoteParameterServerClient` to train against a
        `NetworkParameterServer` in another process/host (the reference's
        `ParameterServerClient`-per-worker wiring,
        `ParameterServerParallelWrapper.java:215-218`). Default: a fresh
        in-process store seeded from the net.

        `request_timeout`: when set, every worker pull/push goes through a
        `RetryingParameterServerClient` with this per-request timeout and
        `max_retries`/`retry_backoff` exponential backoff — a stalled
        server makes the run RAISE `ParameterServerTimeoutError` after
        bounded wall-clock instead of deadlocking the worker threads."""
        if workers < 1:
            raise ValueError("workers must be >= 1")
        net._ensure_init()
        self.net = net
        self.workers = workers
        self.sync_frequency = max(1, sync_frequency)
        self._queues: List[queue.Queue] = [
            queue.Queue(maxsize=queue_capacity) for _ in range(workers)]
        self.server = (ParameterServer(_host(net.params())) if server is None
                       else server)
        self._retry_conf = (request_timeout, max_retries, retry_backoff)
        # the master's own client (final pull); each worker thread builds
        # its own in _worker_loop — a RetryingParameterServerClient serves
        # one thread (see its docstring)
        self._client = self._make_client()
        self._worker_errors: List[BaseException] = []
        self._threads: List[threading.Thread] = []

    def _make_client(self):
        request_timeout, max_retries, retry_backoff = self._retry_conf
        if request_timeout is None:
            return self.server
        return RetryingParameterServerClient(
            self.server, timeout=request_timeout,
            max_retries=max_retries, backoff=retry_backoff)

    def _check_worker_failure(self) -> None:
        if self._worker_errors:
            # re-raise the worker's own exception (e.g.
            # ParameterServerTimeoutError) so callers handle the real cause
            raise self._worker_errors[0]

    def _dispatch(self, ds, idx: int) -> None:
        """Bounded put that never blocks forever on a dead consumer: if
        the target worker thread died (e.g. its PS client gave up), its
        error surfaces here instead of wedging fit() on a full queue."""
        q = self._queues[idx]
        while True:
            try:
                q.put(ds, timeout=0.2)
                return
            except queue.Full:
                if not self._threads[idx].is_alive():
                    self._check_worker_failure()
                    raise RuntimeError(
                        f"ps-worker-{idx} died without draining its queue")

    def fit(self, data: Union[DataSet, DataSetIterator],
            epochs: int = 1) -> None:
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])

        self._worker_errors = []
        self._threads = [
            threading.Thread(target=self._worker_loop, args=(w,),
                             daemon=True, name=f"ps-worker-{w}")
            for w in range(self.workers)]
        for t in self._threads:
            t.start()
        n_batches = 0
        try:
            for _ in range(epochs):
                data.reset()
                for ds in data:
                    self._dispatch(ds, n_batches % self.workers)
                    n_batches += 1
        finally:
            for w, q in enumerate(self._queues):
                while True:  # deliver STOP unless the consumer is gone
                    try:
                        q.put(self._STOP, timeout=0.2)
                        break
                    except queue.Full:
                        if not self._threads[w].is_alive():
                            break
            for t in self._threads:
                t.join()
        self._check_worker_failure()
        # final model = server state (reference copies PS params back)
        self.net.set_params(self._client.pull())
        self.net.iteration += n_batches
        logger.info("parameter server: %d batches, %d pushes",
                    n_batches, self.server.num_pushes)

    def _worker_loop(self, idx: int) -> None:
        client = None
        try:
            client = self._make_client()  # per-worker (reference wiring)
            replica = self.net.clone()
            q = self._queues[idx]

            def batches():
                while True:
                    item = q.get()
                    if item is self._STOP:
                        return
                    yield item

            run_worker_protocol(client, replica, batches(),
                                self.sync_frequency)
            # propagate the last score for listener/reporting purposes
            if replica.score_value is not None:
                self.net.score_value = replica.score_value
        except BaseException as e:  # noqa: BLE001 — surfaced by fit()
            logger.warning("ps-worker-%d died: %s: %s", idx,
                           type(e).__name__, e)
            self._worker_errors.append(e)
        finally:
            # dispatcher-only shutdown: the wrapped store is SHARED
            if isinstance(client, RetryingParameterServerClient):
                client.shutdown()


# ---------------------------------------------------------------------------
# Network transport (the Aeron role)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("parameter-server peer closed")
        buf += chunk
    return buf


def _send_msg(sock, op: bytes, payload: bytes = b"") -> None:
    import struct

    sock.sendall(op + struct.pack(">Q", len(payload)) + payload)


def _recv_msg(sock):
    import struct

    op = _recv_exact(sock, 1)
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    return op, _recv_exact(sock, n)


class NetworkParameterServer:
    """TCP-served `ParameterServer` (the role of the reference's embedded
    Aeron `MediaDriver` + `ParameterServerNode`,
    `ParameterServerParallelWrapper.java:160-218`). Aeron is reliable
    UDP; a plain TCP stream gives the same reliable push/pull contract
    without vendoring Aeron's MediaDriver, and the protocol (1-byte opcode +
    length-prefixed f32 payload) keeps the wire format trivial for a
    faster transport to replace.

    Serves PULL (current params) and PUSH (delta accumulate) from any
    number of clients/processes/hosts; one handler thread per client."""

    def __init__(self, initial_params: np.ndarray, host: str = "localhost",
                 port: int = 0):
        import socket

        self._store = ParameterServer(_host(initial_params))
        self._dtype = np.float32
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen()
        self.address = self._sock.getsockname()  # (host, port)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True,
                                               name="ps-accept")
        self._accept_thread.start()

    # store passthroughs (the server process reads its own aggregate)
    def pull(self) -> np.ndarray:
        return self._store.pull()

    @property
    def num_pushes(self) -> int:
        return self._store.num_pushes

    def _accept_loop(self) -> None:
        import socket

        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="ps-conn")
            t.start()
            self._threads.append(t)

    def _serve(self, conn) -> None:
        try:
            while True:
                op, payload = _recv_msg(conn)
                if op == b"P":                      # pull
                    params = self._store.pull().astype(self._dtype)
                    _send_msg(conn, b"R", params.tobytes())
                elif op == b"U":                    # push delta
                    delta = np.frombuffer(payload, self._dtype)
                    self._store.push_update(delta.astype(np.float64)
                                            .astype(self._dtype))
                    _send_msg(conn, b"A")           # ack: delta applied
                elif op == b"V":                    # idempotent push:
                    rid = payload[:32].decode()     # 32-byte hex id + delta
                    delta = np.frombuffer(payload[32:], self._dtype)
                    self._store.push_update(delta.astype(np.float64)
                                            .astype(self._dtype),
                                            request_id=rid)
                    _send_msg(conn, b"A")
                elif op == b"Q":
                    return
                else:
                    raise ValueError(f"unknown parameter-server op {op!r}")
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


class RemoteParameterServerClient:
    """Client with the SAME pull/push contract as the in-process
    `ParameterServer` (reference `ParameterServerClient`) — so
    `ParameterServerParallelWrapper(server=...)` and any external process
    can train against a networked server. Push is synchronous through the
    ack (reliable delivery, matching Aeron's reliable-stream semantics);
    asynchrony lives in the training protocol (no barrier between
    workers), not in dropped updates.

    `timeout`: per-socket-operation timeout in seconds — a stalled or
    dead server raises `socket.timeout` (an OSError) instead of blocking
    recv forever; wrap in `RetryingParameterServerClient` for bounded
    backoff-and-retry on top. Any socket error (including a timeout)
    DISCARDS the connection — the length-prefixed stream may hold a
    half-consumed reply, so the next request transparently reconnects on
    a clean stream instead of desyncing the protocol. A mis-sequenced
    reply on a supposedly-clean stream raises ConnectionError (also
    retryable) rather than poisoning every later request."""

    def __init__(self, host: str, port: int,
                 timeout: Optional[float] = None):
        self._host = host
        self._port = port
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock = None
        with self._lock:
            self._connect()

    def _connect(self) -> None:
        import socket

        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        if self._timeout is not None:
            sock.settimeout(self._timeout)
        sock.connect((self._host, self._port))
        self._sock = sock

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _request(self, op: bytes, payload: bytes, expect: bytes):
        with self._lock:
            try:
                if self._sock is None:
                    self._connect()
                _send_msg(self._sock, op, payload)
                reply_op, reply = _recv_msg(self._sock)
            except (ConnectionError, OSError):
                self._drop_sock()
                raise
            if reply_op != expect:
                # protocol desync (e.g. a reply from a request abandoned
                # before the reconnect logic existed server-side) — start
                # over on a fresh stream and let the retry layer re-call
                self._drop_sock()
                raise ConnectionError(
                    f"unexpected parameter-server reply {reply_op!r} "
                    f"(expected {expect!r}); reconnecting")
            return reply

    def pull(self) -> np.ndarray:
        payload = self._request(b"P", b"", expect=b"R")
        return np.frombuffer(payload, np.float32).copy()

    def push_update(self, delta: np.ndarray,
                    request_id: Optional[str] = None) -> None:
        """`request_id` (32-char hex): server-side duplicate suppression
        for retried pushes (see `ParameterServer.push_update`)."""
        payload = np.asarray(delta, np.float32).tobytes()
        if request_id is None:
            self._request(b"U", payload, expect=b"A")
        else:
            self._request(b"V", request_id.encode()[:32].ljust(32) + payload,
                          expect=b"A")

    @property
    def num_pushes(self) -> int:  # server-side stat; clients don't track
        return -1

    def close(self) -> None:
        with self._lock:
            try:
                if self._sock is not None:
                    _send_msg(self._sock, b"Q")
            except OSError:
                pass
            self._drop_sock()


# ---------------------------------------------------------------------------
# OS-process worker entry (test and card rig for the network transport)


def _network_worker_main(argv=None) -> None:
    """Train the shared parity fixture against a NetworkParameterServer in
    ANOTHER process: `python -m deeplearning4j_tpu_torch.parallel.
    parameter_server <host> <port> <worker_id> <n_workers> <sync_frequency>
    <mode> [<out.npy> [<init.npy>]] [--device cuda|cpu]` (the card unless
    `--device cpu`).

    mode 'train': pull -> fit this worker's slice of the fixture stream
    (round-robin, the wrapper's dispatch order) -> push deltas every
    `sync_frequency` batches: the real worker protocol over TCP.
    mode 'hammer': push 50 constant 0.5-deltas (exactly representable, so
    the aggregate under CONCURRENT pushes has one correct answer: proves
    the per-connection handler threads neither drop nor double-apply).
    mode 'local': no network at all: run EVERY worker's sequence against
    an in-process ParameterServer (initial params from <init.npy> when
    given) and save the final params to <out.npy>; the parity test diffs
    this against the TCP result, isolating the transport."""
    import sys

    from deeplearning4j_tpu_torch.parallel.multiprocess import (
        _parity_fixture_data,
        _parity_fixture_net,
    )

    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    host, port, wid, n_workers, sync_freq, mode = args[:6]
    port, wid = int(port), int(wid)
    n_workers, sync_freq = int(n_workers), int(sync_freq)

    def shard(feats, labels, w):
        return [DataSet(feats[i], labels[i])
                for i in range(feats.shape[0]) if i % n_workers == w]

    if mode == "local":
        init = (np.load(args[7]) if len(args) > 7
                else _host(_parity_fixture_net(device).params()))
        store = ParameterServer(init)
        feats, labels = _parity_fixture_data()
        for w in range(n_workers):
            run_worker_protocol(store, _parity_fixture_net(device),
                                shard(feats, labels, w), sync_freq)
        np.save(args[6], store.pull())
        print("PS_LOCAL_REF_DONE")
        return

    client = RemoteParameterServerClient(host, port)
    if mode == "hammer":
        size = len(client.pull())
        for _ in range(50):
            client.push_update(np.full((size,), 0.5, np.float32))
        client.close()
        print(f"PS_WORKER_{wid}_DONE hammer")
        return

    net = _parity_fixture_net(device)
    feats, labels = _parity_fixture_data()
    run_worker_protocol(client, net, shard(feats, labels, wid), sync_freq)
    client.close()
    print(f"PS_WORKER_{wid}_DONE train score={net.score_value:.6f} "
          f"device={net.device}")


if __name__ == "__main__":
    _network_worker_main()
