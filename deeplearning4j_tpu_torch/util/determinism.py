"""Determinism checking (counterpart of
`deeplearning4j_tpu/util/determinism.py`).

The reference has no race detector: the JVM relies on `synchronized` and
blocking queues. Its analogue here is a determinism check: two same-seed
runs must produce bit-identical parameters, and any divergence means
nondeterminism crept in (host threads feeding batches out of order,
unseeded randomness, a reduction whose order changes between runs, such
as a kernel that accumulates with atomics).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def assert_deterministic(net_factory: Callable[[], object],
                         batches: Sequence, epochs: int = 1,
                         atol: float = 0.0) -> None:
    """Train two independently constructed networks on the same batches
    and assert their parameters are equal (bit-exact by default).

    net_factory: () -> initialized network (fresh parameters each call,
    the same seed through its configuration); batches: a list of
    DataSets."""
    from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator

    runs = []
    for _ in range(2):
        net = net_factory()
        net.fit(ListDataSetIterator(list(batches)), epochs=epochs)
        runs.append(net.params().detach().float().cpu())
    a, b = runs
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(
            "training diverged (non-finite parameters) — determinism "
            "cannot be assessed; lower the learning rate first")
    if atol == 0.0:
        if not torch.equal(a, b):
            diff = (a - b).abs()
            mism = int((a != b).sum())
            raise AssertionError(
                f"nondeterministic training: params differ at "
                f"{mism}/{a.numel()} positions "
                f"(max |diff| = {float(diff.max()):.3e})")
    else:
        # numpy's assert_allclose, as the reference calls it: rtol 1e-7
        torch.testing.assert_close(a, b, atol=atol, rtol=1e-7)
