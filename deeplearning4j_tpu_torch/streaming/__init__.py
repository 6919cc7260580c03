"""Streaming train/serve pipelines.

Reference: `dl4j-streaming` (SURVEY §2.4) — Kafka/Camel routes feeding
online training and model serving (`DL4jServeRouteBuilder.java`,
`SparkStreamingPipeline.java`). Counterpart of `deeplearning4j_tpu.streaming`:
sources/sinks are plain Python callables/iterables bridged through a
bounded queue; the train route feeds the SAME step as offline `fit()` on
the network's device, and the serve route runs `output()`.
Kafka transport (`KafkaSource`/`KafkaSink`) dispatches between the real
kafka-python client (`client='kafka'`, when installed) and the in-repo
embedded TCP broker (`streaming/embedded_kafka.py`) — the reference's
`EmbeddedKafkaCluster.java` strategy — so the wire serde and consume
loops are exercised end-to-end without an external cluster.
"""
from deeplearning4j_tpu_torch.streaming.pipeline import (
    KafkaSink,
    KafkaSource,
    QueueSink,
    QueueSource,
    ServeRoute,
    StreamingTrainPipeline,
)

__all__ = [
    "KafkaSink",
    "KafkaSource",
    "QueueSink",
    "QueueSource",
    "ServeRoute",
    "StreamingTrainPipeline",
]
