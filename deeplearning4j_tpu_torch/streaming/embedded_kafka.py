"""Embedded Kafka-style broker: the reference's test-infra strategy.

Reference: `dl4j-streaming` ships a REAL Kafka client
(`NDArrayKafkaClient.java`) and proves it against an in-process broker
(`EmbeddedKafkaCluster.java` / `EmbeddedZookeeper.java`) — no external
cluster in CI. This environment cannot vendor `kafka-python` (no
package installs), so the embedded tier IS the exercised transport: a
TCP broker with append-only topic logs, offset-based fetch with long
polling, and producer/consumer clients that duck-type the subset of the
`kafka-python` API the streaming pipeline uses (`producer.send(topic,
bytes)`, consumer iteration yielding records with `.value`). The
`KafkaSource`/`KafkaSink` serde framing and consume loops run unchanged
over either client, so swapping in the real package is a one-line
`client="kafka"`.

Wire protocol (length-framed like the parameter-server transport):
  1-byte opcode + u64 payload length + payload
  P <u16 topic-len><topic><payload>      -> A <u64 offset>
  F <u16 topic-len><topic><u64 offset><f64 max-wait-s>
                                         -> M <u32 count>{<u64 len><bytes>}*
  Q                                      -> (close)
"""
from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.parallel.parameter_server import (
    _recv_exact,
    _recv_msg,
    _send_msg,
)


class EmbeddedKafkaBroker:
    """In-process broker: append-only log per topic, any number of
    concurrent producers/consumers over TCP (one handler thread per
    connection, condition-variable long polling for fetches)."""

    def __init__(self, host: str = "localhost", port: int = 0):
        import socket

        self._topics: Dict[str, List[bytes]] = {}
        self._lock = threading.Lock()
        self._data = threading.Condition(self._lock)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen()
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._stop = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="kafka-accept").start()

    @property
    def bootstrap_servers(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    def topic_size(self, topic: str) -> int:
        with self._lock:
            return len(self._topics.get(topic, ()))

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
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="kafka-conn").start()

    def _serve(self, conn) -> None:
        try:
            while True:
                op, payload = _recv_msg(conn)
                if op == b"P":
                    (tl,) = struct.unpack(">H", payload[:2])
                    topic = payload[2:2 + tl].decode()
                    record = payload[2 + tl:]
                    with self._data:
                        log = self._topics.setdefault(topic, [])
                        log.append(record)
                        offset = len(log) - 1
                        self._data.notify_all()
                    _send_msg(conn, b"A", struct.pack(">Q", offset))
                elif op == b"F":
                    (tl,) = struct.unpack(">H", payload[:2])
                    topic = payload[2:2 + tl].decode()
                    offset, max_wait = struct.unpack(
                        ">Qd", payload[2 + tl:2 + tl + 16])
                    with self._data:
                        if len(self._topics.get(topic, ())) <= offset:
                            self._data.wait(timeout=max_wait)
                        # slice only the tail: copying the whole log per
                        # poll would be O(topic) inside the producer lock
                        records = self._topics.get(topic, [])[offset:]
                    body = struct.pack(">I", len(records)) + b"".join(
                        struct.pack(">Q", len(r)) + r for r in records)
                    _send_msg(conn, b"M", body)
                elif op == b"S":
                    (tl,) = struct.unpack(">H", payload[:2])
                    topic = payload[2:2 + tl].decode()
                    with self._lock:
                        n = len(self._topics.get(topic, ()))
                    _send_msg(conn, b"Z", struct.pack(">Q", n))
                elif op == b"Q":
                    return
                else:
                    raise ValueError(f"unknown broker op {op!r}")
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


def _connect(bootstrap_servers: str):
    import socket

    host, port = bootstrap_servers.rsplit(":", 1)
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.connect((host, int(port)))
    return s


class EmbeddedKafkaProducer:
    """kafka-python-shaped producer for the embedded broker."""

    def __init__(self, bootstrap_servers: str):
        self._sock = _connect(bootstrap_servers)
        self._lock = threading.Lock()

    def send(self, topic: str, value: bytes) -> int:
        t = topic.encode()
        with self._lock:
            _send_msg(self._sock, b"P",
                      struct.pack(">H", len(t)) + t + value)
            op, payload = _recv_msg(self._sock)
        if op != b"A":
            raise ValueError(f"produce not acknowledged: {op!r}")
        return struct.unpack(">Q", payload)[0]

    def flush(self) -> None:  # sends are synchronous through the ack
        pass

    def close(self) -> None:
        try:
            _send_msg(self._sock, b"Q")
            self._sock.close()
        except OSError:
            pass


class _Record:
    __slots__ = ("value",)

    def __init__(self, value: bytes):
        self.value = value


class EmbeddedKafkaConsumer:
    """kafka-python-shaped consumer: iterate records with long polling;
    `close()` ends the iteration at the next poll.

    `auto_offset_reset` matches kafka-python's semantics AND its default:
    'latest' starts at the topic's current end (only records produced
    after subscribing are seen), 'earliest' replays from offset 0 — so
    code developed against the embedded client behaves identically when
    `client='auto'` resolves to the real package."""

    def __init__(self, topic: str, bootstrap_servers: str,
                 poll_timeout_s: float = 0.5,
                 auto_offset_reset: str = "latest"):
        if auto_offset_reset not in ("latest", "earliest"):
            raise ValueError("auto_offset_reset must be 'latest' or "
                             f"'earliest', got {auto_offset_reset!r}")
        self._topic = topic
        self._sock = _connect(bootstrap_servers)
        self._poll = poll_timeout_s
        self._closed = threading.Event()
        if auto_offset_reset == "latest":
            t = topic.encode()
            _send_msg(self._sock, b"S", struct.pack(">H", len(t)) + t)
            op, payload = _recv_msg(self._sock)
            if op != b"Z":
                raise ValueError(f"unexpected size reply {op!r}")
            self._offset = struct.unpack(">Q", payload)[0]
        else:
            self._offset = 0

    def __iter__(self):
        t = self._topic.encode()
        while not self._closed.is_set():
            _send_msg(self._sock, b"F",
                      struct.pack(">H", len(t)) + t
                      + struct.pack(">Qd", self._offset, self._poll))
            op, payload = _recv_msg(self._sock)
            if op != b"M":
                raise ValueError(f"unexpected fetch reply {op!r}")
            (count,) = struct.unpack(">I", payload[:4])
            pos = 4
            for _ in range(count):
                (n,) = struct.unpack(">Q", payload[pos:pos + 8])
                pos += 8
                record = payload[pos:pos + n]
                pos += n
                self._offset += 1
                yield _Record(record)

    def close(self) -> None:
        self._closed.set()
        # don't close the socket here: a fetch may be in flight on the
        # iterating thread; the Q on garbage-collect / broker close ends it

    def shutdown(self) -> None:
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass


def _produce_worker_main() -> None:
    """OS-process producer for the cross-process test:
    `python -m deeplearning4j_tpu_torch.streaming.embedded_kafka <host:port>
    <topic> <n_batches>` — serializes real DataSets through KafkaSink
    from ANOTHER process, proving the TCP framing beyond thread scope."""
    import sys

    import numpy as np

    from deeplearning4j_tpu_torch.streaming.pipeline import KafkaSink

    servers, topic, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
    sink = KafkaSink(topic, bootstrap_servers=servers, client="embedded")
    rng = np.random.default_rng(7)
    for i in range(n):
        feats = rng.standard_normal((8, 4)).astype(np.float32)
        labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        sink.send_dataset(feats, labels)
    print(f"KAFKA_PRODUCER_DONE {n}")


if __name__ == "__main__":
    _produce_worker_main()
