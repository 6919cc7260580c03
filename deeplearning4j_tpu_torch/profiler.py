"""Profiling and tracing hooks on `torch.profiler` (counterpart of
`deeplearning4j_tpu/profiler.py`).

- `ProfilerListener`: an `IterationListener` that takes the wall clock
  of every iteration (with `sync=True` it waits for the card first, so
  an interval covers the device work of the step it timed) and sums
  them up in percentiles.
- `XlaTraceListener` (the reference's name, kept): records a
  `torch.profiler` trace over an iteration window and exports it as a
  Chrome trace; it records CUDA kernel activity and host ranges, not
  XLA ops.
- `trace_annotation`: names a host phase in the trace
  (`torch.profiler.record_function`); `trace_capture` records one over a
  with-block.
"""
from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _sync(device) -> None:
    """Wait for the card's queued work on `device`; nothing on the CPU."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_file(log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(log_dir, f"trace-{os.getpid()}-"
                                 f"{time.monotonic_ns()}.json")


class ProfilerListener(IterationListener):
    """Per-iteration wall-clock capture.

    `sync=True` waits for the card (`torch.cuda.synchronize` on the
    model's device) at every iteration, so an interval covers the device
    step it timed; it costs one wait an iteration and defeats queueing
    ahead, so it is for profiling runs. On the CPU there is nothing to
    wait for."""

    def __init__(self, sync: bool = False, log_every: int = 0):
        self.sync = sync
        self.log_every = log_every
        self.durations_ms: List[float] = []
        self._last: Optional[float] = None

    def iteration_done(self, model, iteration: int) -> None:
        if self.sync:
            _sync(getattr(model, "device", None))
        now = time.perf_counter()
        if self._last is not None:
            ms = (now - self._last) * 1000.0
            self.durations_ms.append(ms)
            if self.log_every and len(self.durations_ms) % self.log_every == 0:
                logger.info("iteration %d: %.2f ms/step (mean over last %d)",
                            iteration,
                            float(np.mean(self.durations_ms[-self.log_every:])),
                            self.log_every)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self.durations_ms:
            return {}
        d = np.asarray(self.durations_ms)
        return {
            "iterations": int(d.size),
            "mean_ms": float(d.mean()),
            "p50_ms": float(np.percentile(d, 50)),
            "p90_ms": float(np.percentile(d, 90)),
            "p99_ms": float(np.percentile(d, 99)),
            "max_ms": float(d.max()),
        }

    def reset(self) -> None:
        self.durations_ms = []
        self._last = None


class XlaTraceListener(IterationListener):
    """Records a `torch.profiler` trace over iterations
    [start_iteration, start_iteration + num_iterations) and exports it as
    a Chrome trace (`trace-*.json`, viewable in Perfetto or
    chrome://tracing) into `log_dir`; `trace_path` names the file. It
    records CUDA kernel activity and host ranges, not XLA: the name is
    the JAX package's."""

    def __init__(self, log_dir: str, start_iteration: int = 5,
                 num_iterations: int = 5):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.num_iterations = num_iterations
        self._active = False
        self._prof = None
        self.completed = False
        self.trace_path: Optional[str] = None

    def iteration_done(self, model, iteration: int) -> None:
        import torch

        if (not self._active and not self.completed
                and iteration >= self.start_iteration):
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
            self._active = True
            self._until = iteration + self.num_iterations
        elif self._active and iteration >= self._until:
            # wait first, so the trace holds the steps' device work
            _sync(getattr(model, "device", None))
            self._finish()

    def _finish(self) -> None:
        self._prof.__exit__(None, None, None)
        self.trace_path = _trace_file(self.log_dir)
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self._active = False
        self.completed = True
        logger.info("torch.profiler trace written to %s", self.trace_path)

    def stop(self) -> None:
        """Force-stop an in-flight trace (e.g. training ended early)."""
        if self._active:
            self._finish()


@contextmanager
def trace_annotation(name: str):
    """Names a host-side phase in the profiler timeline (reference
    analogue: the per-phase wall-clock keys of `SparkTrainingStats`)."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextmanager
def trace_capture(log_dir: str):
    """Record a `torch.profiler` trace over the with-block and export it
    as a Chrome trace into `log_dir` (the block-scoped sibling of
    `XlaTraceListener`). The profiler always stops, even when the block
    raises."""
    import torch

    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        path = _trace_file(log_dir)
        prof.export_chrome_trace(path)
        logger.info("torch.profiler trace written to %s", path)
