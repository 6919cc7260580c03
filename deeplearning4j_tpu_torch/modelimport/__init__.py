"""Keras model import (counterpart of `deeplearning4j_tpu.modelimport`)."""
from deeplearning4j_tpu_torch.modelimport.keras import (
    InvalidKerasConfigurationException,
    KerasModelImport,
    UnsupportedKerasConfigurationException,
)

__all__ = [
    "KerasModelImport",
    "InvalidKerasConfigurationException",
    "UnsupportedKerasConfigurationException",
]
