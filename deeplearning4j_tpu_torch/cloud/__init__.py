"""Cloud dataset/model storage + cluster provisioning descriptors.

Reference: `deeplearning4j-aws` (SURVEY §2.4) — S3 dataset IO
(`S3Uploader.java`, `BaseS3DataSetIterator.java`) and EC2 cluster
provisioning (`ClusterSetup.java`). TPU-native equivalents: an object-store
abstraction with a local-filesystem backend (always available) and a gated
GCS backend, plus a TPU-pod provisioning descriptor that renders the
`gcloud` commands (provisioning itself is infrastructure, not framework —
the descriptor keeps it scriptable and testable without egress).
Counterpart of `deeplearning4j_tpu.cloud`, host code copied.
"""
from deeplearning4j_tpu_torch.cloud.storage import (
    DataSetStorage,
    GCSStorage,
    LocalStorage,
    StorageDataSetIterator,
)
from deeplearning4j_tpu_torch.cloud.provision import TpuPodSpec

__all__ = [
    "DataSetStorage",
    "GCSStorage",
    "LocalStorage",
    "StorageDataSetIterator",
    "TpuPodSpec",
]
