"""The process's first call of the CPU's vector math, made once and alone
(no JAX file of this name: the JAX package has no such race).

torch sends the CPU's f32 and f64 unary math (sqrt, exp, log, ...) to
MKL's vector math library, which sets itself up at its first call in a
process; several threads making that first call at once sometimes get a
12-bit result (sqrt(8) = 2.82763671875: `spmd_thread_stress.py`).
`settle_host_math` makes that call on the calling thread, under a lock,
once per process. Importing `deeplearning4j_tpu_torch` calls it, so it
runs before any of the port's thread pools can start (the `shard_map`
slots, the averaging master's workers, the `ModelServer` executors, the
replica pool, the async iterators, the streaming routes, the embedded
broker, the gloo workers); after it, calls from any thread give one
thread's bits.
"""
from __future__ import annotations

import threading

import torch

_LOCK = threading.Lock()
_ready = False


def settle_host_math() -> None:
    """Make the process's first CPU vector-math call, once."""
    global _ready
    if _ready:
        return
    with _LOCK:
        if not _ready:
            torch.exp(torch.zeros(1))
            _ready = True


def host_math_settled() -> bool:
    return _ready
