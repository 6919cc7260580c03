"""Auxiliary losses added in the middle of a network (counterpart of
`deeplearning4j_tpu/ops/aux_loss.py`).

A layer may add a loss term that is not a function of the network's
output, as the Switch MoE load-balancing loss is. `MultiLayerNetwork`
runs its forward inside `aux_loss_scope()` and adds the collected terms
to the loss; `add_aux_loss` outside a scope (plain inference) does
nothing. The scopes are thread-local, so the threads of a server or an
async iterator never see each other's terms.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_tls = threading.local()


def _stack() -> list:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


@contextmanager
def aux_loss_scope():
    """Collects the aux-loss terms added inside the block; yields the
    list (sum it after the forward)."""
    terms: list = []
    stack = _stack()
    stack.append(terms)
    try:
        yield terms
    finally:
        stack.pop()


def add_aux_loss(term) -> None:
    """Called by a layer during its forward; a no-op with no scope
    active."""
    stack = _stack()
    if stack:
        stack[-1].append(term)
