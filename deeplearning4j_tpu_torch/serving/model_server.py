"""Typed serving errors and the prompt-bucket helper (the part of
`deeplearning4j_tpu/serving/model_server.py` the decode engine needs,
copied so the port imports nothing of the JAX package). `ModelServer`
itself comes with the serving cluster tier (ROADMAP queue A11)."""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base class for every typed serving-tier give-up."""


class ServerOverloadedError(ServingError):
    """Admission control shed this request: the bounded queue is full.
    `retry_after` (seconds) estimates when capacity frees up."""

    def __init__(self, msg: str, retry_after: float = 0.1):
        super().__init__(msg)
        self.retry_after = retry_after


class OutOfPagesError(ServerOverloadedError):
    """The decode engine's paged KV pool cannot reserve enough pages for
    this request right now: memory-side admission control shed it at
    the door. `retry_after` estimates when enough pages free up."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before (or while) it could be
    served."""


class InferenceFailedError(ServingError):
    """The device step for this request raised, or produced non-finite
    outputs."""


class ServerClosedError(ServingError):
    """The server is shut (or shutting) down; no new requests are
    admitted and unfinished queued requests fail with this."""


def _bucket(n: int, max_batch: int) -> int:
    """Next power-of-two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)
