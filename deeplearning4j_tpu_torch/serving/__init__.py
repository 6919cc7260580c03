"""Serving tier — counterpart of `deeplearning4j_tpu.serving`: the
continuous-batching `DecodeEngine` and the typed serving errors."""
from deeplearning4j_tpu_torch.serving.decode_engine import DecodeEngine  # noqa: F401
from deeplearning4j_tpu_torch.serving.model_server import (  # noqa: F401
    DeadlineExceededError,
    InferenceFailedError,
    OutOfPagesError,
    ServerClosedError,
    ServerOverloadedError,
    ServingError,
)
