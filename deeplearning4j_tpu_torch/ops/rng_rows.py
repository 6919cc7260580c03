"""Batch-row-indexed dropout scope: partition-invariant dropout masks
(counterpart of `deeplearning4j_tpu/ops/rng_rows.py`).

Inside `row_offset_scope(offset)` dropout draws each batch row's mask
from its own generator, seeded from (the configuration's seed, the
iteration, the layer, the dropout site and the GLOBAL row index
`offset + local row`), and from nothing about how the batch was split.
A GPipe microbatch (`parallel/pipeline_wrapper.py`) then draws exactly
the masks those rows get when the whole batch runs on one device under
`row_offset_scope(0)`. The JAX package folds the row into a threefry
key; the port seeds one `torch.Generator` per row (the bits differ
between the packages, the invariance is the same).

Outside any scope the offset is None and dropout stays one bulk draw
over the whole tensor (`nn.conf.layers.dropout`).

The scope is thread-local, as the aux-loss scope is: training masters
run on worker threads, and the SPMD runtime (`parallel/spmd.py`) hands
the caller's offset to each slot thread.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_STATE = threading.local()


@contextmanager
def row_offset_scope(offset):
    """Within the block, the batch rows dropout sees are global rows
    [offset, offset + local rows)."""
    prev = getattr(_STATE, "offset", None)
    _STATE.offset = offset
    try:
        yield
    finally:
        _STATE.offset = prev


def current_row_offset():
    """The active slice's first global row index, or None."""
    return getattr(_STATE, "offset", None)
