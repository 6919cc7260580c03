"""Streaming pipeline implementation (reference `dl4j-streaming`, §2.4;
counterpart of `deeplearning4j_tpu/streaming/pipeline.py`, host code
copied: the port imports nothing of the JAX package).

The records are the JAX package's bytes (`encode_dataset`), and the
embedded broker's wire is unchanged, so either package's producer feeds
either package's pipeline. The train route feeds the network's own `fit`
step, on the network's device; the serve route answers with
`net.output`, brought to the host as numpy."""
from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

logger = logging.getLogger("deeplearning4j_tpu_torch")

_STOP = object()


class QueueSource:
    """In-process source: producers `put()` items, the pipeline consumes.
    `close()` ends the stream."""

    def __init__(self, maxsize: int = 64):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)

    def put(self, item, timeout: Optional[float] = None) -> None:
        self._q.put(item, timeout=timeout)

    def close(self) -> None:
        self._q.put(_STOP)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            yield item


class QueueSink:
    """In-process sink collecting emitted items."""

    def __init__(self):
        self.items = []
        self._lock = threading.Lock()

    def __call__(self, item) -> None:
        with self._lock:
            self.items.append(item)


def _resolve_client(client: str) -> str:
    """Client dispatch rule, shared by consumer and producer factories:
    `'kafka'` = the real kafka-python package; `'embedded'` = the in-repo
    broker (`streaming/embedded_kafka.py`, the reference's
    `EmbeddedKafkaCluster` strategy); `'auto'` = kafka if importable,
    embedded otherwise. Both clients expose the same consumed surface
    (including `auto_offset_reset` semantics), so the serde/consume loops
    are identical either way."""
    if client == "auto":
        try:
            import kafka  # type: ignore # noqa: F401

            return "kafka"
        except ImportError:
            return "embedded"
    if client in ("kafka", "embedded"):
        return client
    raise ValueError(f"unknown kafka client {client!r} "
                     "(choose 'kafka', 'embedded', or 'auto')")


def _make_consumer(topic: str, bootstrap_servers: str, client: str,
                   **kwargs):
    if _resolve_client(client) == "kafka":
        from kafka import KafkaConsumer  # type: ignore

        return KafkaConsumer(topic, bootstrap_servers=bootstrap_servers,
                             **kwargs)
    from deeplearning4j_tpu_torch.streaming.embedded_kafka import (
        EmbeddedKafkaConsumer,
    )

    return EmbeddedKafkaConsumer(topic, bootstrap_servers, **kwargs)


def _make_producer(bootstrap_servers: str, client: str, **kwargs):
    if _resolve_client(client) == "kafka":
        from kafka import KafkaProducer  # type: ignore

        return KafkaProducer(bootstrap_servers=bootstrap_servers, **kwargs)
    from deeplearning4j_tpu_torch.streaming.embedded_kafka import (
        EmbeddedKafkaProducer,
    )

    return EmbeddedKafkaProducer(bootstrap_servers, **kwargs)


def encode_dataset(feats, labels, features_mask=None,
                   labels_mask=None) -> bytes:
    """(features, labels) → one Kafka record (the reference serializes
    NDArray pairs per message, `NDArrayKafkaClient.java`): the two arrays
    as the JAX package writes them. With masks, the two masks follow
    (an empty array for an absent one); the JAX package's
    `decode_dataset` reads the pair and leaves them, so a masked record
    reaches it unmasked."""
    import io

    buf = io.BytesIO()
    np.save(buf, np.asarray(feats), allow_pickle=False)
    np.save(buf, np.asarray(labels), allow_pickle=False)
    if features_mask is not None or labels_mask is not None:
        for m in (features_mask, labels_mask):
            np.save(buf, np.zeros((0,), np.float32) if m is None
                    else np.asarray(m), allow_pickle=False)
    return buf.getvalue()


def decode_dataset(record: bytes) -> DataSet:
    """One record → DataSet, with its masks when the record carries
    them."""
    import io

    buf = io.BytesIO(record)
    feats = np.load(buf, allow_pickle=False)
    labels = np.load(buf, allow_pickle=False)
    masks = [None, None]
    if buf.tell() < len(record):
        for i in range(2):
            m = np.load(buf, allow_pickle=False)
            masks[i] = None if m.size == 0 else m
    return DataSet(feats, labels, masks[0], masks[1])


class KafkaSource:
    """Kafka topic → DataSet stream (reference `NDArrayKafkaClient.java`).
    `client='auto'` uses kafka-python when installed and the embedded
    broker client otherwise (the exercised path in this image)."""

    def __init__(self, topic: str, bootstrap_servers: str = "localhost:9092",
                 client: str = "auto", **consumer_kwargs):
        self._consumer = _make_consumer(topic, bootstrap_servers, client,
                                        **consumer_kwargs)

    def close(self) -> None:
        self._consumer.close()

    def __iter__(self):
        for msg in self._consumer:
            yield decode_dataset(msg.value)


class KafkaSink:
    """Stream → Kafka topic: `__call__` publishes single arrays
    (predictions, the serve route); `send_dataset` publishes
    (features, labels) training pairs consumed by `KafkaSource`."""

    def __init__(self, topic: str, bootstrap_servers: str = "localhost:9092",
                 client: str = "auto", **producer_kwargs):
        self._producer = _make_producer(bootstrap_servers, client,
                                        **producer_kwargs)
        self._topic = topic

    def __call__(self, item) -> None:
        import io

        buf = io.BytesIO()
        np.save(buf, np.asarray(item), allow_pickle=False)
        self._producer.send(self._topic, buf.getvalue())

    def send_dataset(self, feats, labels, features_mask=None,
                     labels_mask=None) -> None:
        self._producer.send(self._topic, encode_dataset(
            feats, labels, features_mask, labels_mask))

    def flush(self) -> None:
        self._producer.flush()

    def close(self) -> None:
        close = getattr(self._producer, "close", None)
        if close is not None:
            close()


Source = Iterable
Sink = Callable[[Any], None]


class StreamingTrainPipeline:
    """Online training route: DataSet stream → `net.fit` per batch
    (reference `SparkStreamingPipeline.java` train role). Runs inline with
    `run()` or in the background with `start()`/`join()`.

    A streaming trainer is the longest-lived fit loop in the repo and the
    stream itself is not replayable, so durable checkpoints matter more
    here than anywhere: pass `checkpoint_dir` (+ `checkpoint_every`
    batches) and the pipeline commits the net through
    `util/checkpoint_store.CheckpointStore` (atomic publish + integrity
    manifest + keep-last GC) every N batches and once more at clean
    stream end. On construction it restores the newest VERIFIED
    checkpoint in place (params, updater/layer state, iteration/epoch
    clocks), so a restarted consumer resumes where the last durable
    commit left off — corrupt/partial checkpoints from a mid-save kill
    are skipped backwards automatically.

    Poison-batch quarantine: a stream is exposed to upstream data bugs a
    curated dataset never sees, and one NaN record must not kill a
    long-lived consumer. Pass `quarantine_dir` and every record is
    screened (`optimize.health.non_finite_batch_reason`) BEFORE it
    reaches the fit dispatch; poisoned records — and records whose fit
    raises, or whose step the attached `HealthSentinel` skipped as
    non-finite — are written to the quarantine directory with a
    provenance sidecar (reason, stream position, wall-clock) and the
    pipeline keeps consuming. The quarantine is bounded
    (`max_quarantined`): a stream that is ALL poison raises
    `QuarantineFullError` — an outage, not noise. Sentinel escalation
    signals (`DivergenceRollback`, `TrainingDivergedError`) always
    propagate: divergence is a run-level event, not a per-record one."""

    def __init__(self, net, source: Source, on_batch: Optional[Sink] = None,
                 checkpoint_dir=None, checkpoint_every: int = 0,
                 keep_last: int = 3, resume: bool = True,
                 quarantine_dir=None, max_quarantined: int = 256):
        self.net = net
        self.source = source
        self.on_batch = on_batch
        self.batches_seen = 0
        self.records_seen = 0
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.checkpoint_every = checkpoint_every
        self.checkpoint_store = None
        self.resumed_from_step: Optional[int] = None
        self.quarantine = None
        if quarantine_dir is not None:
            from deeplearning4j_tpu_torch.optimize.health import BatchQuarantine

            self.quarantine = BatchQuarantine(quarantine_dir,
                                              max_records=max_quarantined)
        if checkpoint_dir is not None:
            from deeplearning4j_tpu_torch.util.checkpoint_store import (
                CheckpointStore,
            )

            self.checkpoint_store = CheckpointStore(checkpoint_dir,
                                                    keep_last=keep_last)
            if resume and self.checkpoint_store.steps():
                self._restore_last_good()

    def _restore_last_good(self) -> None:
        from deeplearning4j_tpu_torch.util.serialization import restore_model

        net = self.net
        restored, step = self.checkpoint_store.load_latest_verified(
            lambda p: restore_model(p, device=net.device))
        net._ensure_init()
        net.set_params(restored.params())
        net._upd_state = restored._upd_state
        net._layer_state = restored._layer_state
        net.iteration = restored.iteration
        net.epoch = restored.epoch
        self.resumed_from_step = step
        logger.warning("streaming trainer resumed from checkpoint step %d",
                       step)

    def _checkpoint(self) -> None:
        from deeplearning4j_tpu_torch.util.serialization import write_model

        # the store owns the atomic commit; atomic=False skips a second
        # temp+fsync+replace inside the writer
        self.checkpoint_store.save(
            self.net.iteration,
            lambda tmp: write_model(self.net, tmp, atomic=False))

    def _fit_screened(self, ds) -> bool:
        """Fit one record behind the quarantine screen; returns True when
        the record contributed a training step (clean fit — the step may
        still have been SKIPPED by an attached sentinel, in which case
        the record is quarantined for triage but counts as consumed)."""
        from deeplearning4j_tpu_torch.optimize.health import (
            DivergenceRollback,
            TrainingDivergedError,
            non_finite_batch_reason,
        )

        pos = self.records_seen - 1
        reason = non_finite_batch_reason(ds)
        if reason is not None:
            self.quarantine.quarantine(
                ds, reason, {"stream_position": pos, "stage": "pre-fit"})
            return False
        try:
            self.net.fit(ds)
        except (DivergenceRollback, TrainingDivergedError):
            raise  # run-level divergence escalation, not a record problem
        except Exception as e:
            self.quarantine.quarantine(
                ds, f"fit failed: {type(e).__name__}: {e}",
                {"stream_position": pos, "stage": "fit"})
            logger.warning("streaming trainer: quarantined record %d "
                           "whose fit raised %s; pipeline continues", pos,
                           type(e).__name__)
            return False
        sentinel = getattr(self.net, "get_health_sentinel",
                           lambda: None)()
        if sentinel is not None and sentinel.last_step_skipped:
            # finite features but a non-finite loss/gradient (e.g. an
            # overflow-scale record): the fused guard dropped the update;
            # keep the record for triage
            self.quarantine.quarantine(
                ds, "non-finite loss/gradient (step skipped by sentinel)",
                {"stream_position": pos, "stage": "step"})
        return True

    def run(self) -> None:
        for item in self.source:
            ds = item if isinstance(item, DataSet) else DataSet(*item)
            self.records_seen += 1
            if self.quarantine is not None:
                if not self._fit_screened(ds):
                    continue  # quarantined; the pipeline keeps running
            else:
                self.net.fit(ds)
            self.batches_seen += 1
            if (self.checkpoint_store is not None and self.checkpoint_every
                    and self.batches_seen % self.checkpoint_every == 0):
                self._checkpoint()
            if self.on_batch is not None:
                self.on_batch({"batch": self.batches_seen,
                               "score": self.net.score_value})
        if self.checkpoint_store is not None and self.batches_seen:
            self._checkpoint()  # final durable commit at clean stream end

    def start(self) -> "StreamingTrainPipeline":
        def _guard():
            try:
                self.run()
            except BaseException as e:  # surfaced via .error / join()
                self.error = e

        self._thread = threading.Thread(target=_guard, daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            if self.error is not None:
                raise self.error


class ServeRoute:
    """Model-serving route: feature stream → predictions → sink (reference
    `DL4jServeRouteBuilder.java`).

    `net` may be a bare network (`output()` per record, answered as host
    numpy) or a `serving.ModelServer` — then every
    record rides the robust serving tier (admission control, deadlines,
    circuit breaker, hot reload under live traffic) and a typed shed
    (`ServingError`) costs a counted drop + optional `on_shed` callback
    instead of killing the route: a stream consumer must outlive an
    overload or breaker-open window. `served`/`shed` expose the
    counts; `request_timeout` stamps each record's deadline."""

    def __init__(self, net, source: Source, sink: Sink,
                 on_shed: Optional[Callable[[Any, Exception], None]] = None,
                 request_timeout: Optional[float] = None):
        self.net = net
        self.source = source
        self.sink = sink
        self.on_shed = on_shed
        self.request_timeout = request_timeout
        self.served = 0
        self.shed = 0
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        from deeplearning4j_tpu_torch.serving.model_server import (
            ModelServer,
            ServerClosedError,
            ServingError,
        )

        server = self.net if isinstance(self.net, ModelServer) else None
        for feats in self.source:
            feats = np.asarray(feats, np.float32)
            if server is None:
                self.sink(self.net.output(feats).detach().cpu().numpy())
                self.served += 1
                continue
            try:
                out = server.predict(feats, timeout=self.request_timeout)
            except ServerClosedError:
                raise  # route's backend is gone: a route-level event
            except ServingError as e:
                self.shed += 1
                logger.warning("serve route: record shed (%s: %s); "
                               "route continues", type(e).__name__, e)
                if self.on_shed is not None:
                    self.on_shed(feats, e)
                continue
            self.sink(out)
            self.served += 1

    def start(self) -> "ServeRoute":
        def _guard():
            try:
                self.run()
            except BaseException as e:
                self.error = e

        self._thread = threading.Thread(target=_guard, daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            if self.error is not None:
                raise self.error
