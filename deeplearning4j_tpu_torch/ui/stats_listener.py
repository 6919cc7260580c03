"""StatsListener: training telemetry capture (reference
`deeplearning4j-ui-model/.../ui/stats/BaseStatsListener.java:273`
`iterationDone` — score, timings, memory, param/gradient/update histograms
and mean magnitudes, learning rates — encoded there via Agrona SBE
flyweights; here as plain JSON records into a StatsStorageRouter).

Counterpart of `deeplearning4j_tpu/ui/stats_listener.py`, writing the
same records. Device note: histogram/magnitude summaries pull parameters
to the host (one device-to-host read per parameter per report, bf16 cast
to f32 first: numpy has no bf16), so they run every `report_frequency`
iterations only; device memory comes from `torch.cuda` for a model whose
parameters live on a card."""
from __future__ import annotations

import time
import uuid
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ui.storage import StatsRecord, StatsStorageRouter


def _host_array(arr) -> np.ndarray:
    """`arr` (a tensor on any device, or array-like) as host numpy."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(arr)


def _array_stats(arr, n_bins: int = 20) -> Dict[str, Any]:
    a = _host_array(arr).ravel()
    if a.size == 0:
        return {}
    hist, edges = np.histogram(a, bins=n_bins)
    return {
        "mean_magnitude": float(np.mean(np.abs(a))),
        "mean": float(np.mean(a)),
        "stdev": float(np.std(a)),
        "min": float(np.min(a)),
        "max": float(np.max(a)),
        "histogram_counts": hist.tolist(),
        "histogram_min": float(edges[0]),
        "histogram_max": float(edges[-1]),
    }


def _system_stats(device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Host + device memory snapshot (the reference's system page feeds:
    JVM memory + GC via JMX, `BaseStatsListener.java:356-370`; here process
    RSS + the card's memory in use and its total when `device` is a CUDA
    device, the device the model's parameters live on)."""
    out: Dict[str, Any] = {}
    try:
        # current RSS, not ru_maxrss: the peak can only grow, which would
        # hide exactly the leak-vs-plateau signal this page exists to show
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["host_rss_mb"] = float(line.split()[1]) / 1024.0
                    break
    except OSError:
        try:
            import resource
            import sys

            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # ru_maxrss is KiB on Linux but BYTES on macOS
            scale = 1024.0 * 1024.0 if sys.platform == "darwin" else 1024.0
            out["host_rss_peak_mb"] = peak / scale
        except Exception:
            pass
    if device is not None and device.type == "cuda":
        out["device_bytes_in_use"] = int(torch.cuda.memory_allocated(device))
        out["device_bytes_limit"] = int(
            torch.cuda.get_device_properties(device).total_memory)
    try:
        import gc

        # collector activity per report window (the reference records GC
        # count/time deltas via JMX, `BaseStatsListener.java:356-370`; the
        # CPython analogue is cycle-collector runs per generation — a
        # rising gen-2 rate during fit() flags host-side churn)
        stats = gc.get_stats()  # ONE snapshot: both series must agree
        out["gc_collections"] = [s["collections"] for s in stats]
        out["gc_collected"] = [s["collected"] for s in stats]
    except Exception:
        pass
    return out


class StatsListener:
    """Attach with `net.set_listeners(StatsListener(storage))`."""

    def __init__(self, router: StatsStorageRouter,
                 report_frequency: int = 1,
                 session_id: Optional[str] = None,
                 worker_id: str = "worker-0",
                 collect_histograms: bool = True):
        self.router = router
        self.report_frequency = max(1, report_frequency)
        self.session_id = session_id or f"session-{uuid.uuid4().hex[:12]}"
        self.worker_id = worker_id
        self.collect_histograms = collect_histograms
        self._last_time: Optional[float] = None
        self._examples = 0
        self._static_sent = False

    # listener SPI ----------------------------------------------------------
    def record_batch(self, n_examples: int) -> None:
        self._examples += n_examples

    def iteration_done(self, model, iteration: int) -> None:
        if not self._static_sent:
            self._send_static(model)
        if iteration % self.report_frequency != 0:
            return
        now = time.time()
        dt_ms = ((now - self._last_time) * 1000.0 / self.report_frequency
                 if self._last_time is not None else None)
        self._last_time = now
        data: Dict[str, Any] = {
            "iteration": iteration,
            "score": model.score_value,
            "iteration_ms": dt_ms,
            "examples_seen": self._examples,
        }
        if self.collect_histograms and getattr(model, "_params", None) is not None:
            params: Dict[str, Any] = {}
            for i, p in enumerate(self._named_params(model)):
                name, arr = p
                params[name] = _array_stats(arr)
            data["parameters"] = params
        data["system"] = _system_stats(self._model_device(model))
        self.router.put_record(StatsRecord(
            session_id=self.session_id, type_id="stats",
            worker_id=self.worker_id, timestamp=now, data=data))

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass

    # helpers ---------------------------------------------------------------
    @staticmethod
    def _model_device(model) -> Optional[torch.device]:
        """The device the model's parameters live on (the port's networks
        keep it as `device`)."""
        dev = getattr(model, "device", None)
        return None if dev is None else torch.device(dev)

    @staticmethod
    def _named_params(model):
        ps = model._params
        if isinstance(ps, dict):  # ComputationGraph: name → {param: arr}
            for vname, d in ps.items():
                for pname, arr in d.items():
                    yield f"{vname}_{pname}", arr
        else:                     # MultiLayerNetwork: list of dicts
            for i, d in enumerate(ps):
                for pname, arr in d.items():
                    yield f"{i}_{pname}", arr

    def _send_static(self, model) -> None:
        """Session metadata (reference sends model config/class/param count
        as the init report)."""
        self._static_sent = True
        try:
            n_params = int(model.num_params())
        except Exception:
            n_params = -1
        self.router.put_record(StatsRecord(
            session_id=self.session_id, type_id="static_info",
            worker_id=self.worker_id, timestamp=time.time(),
            data={"model_class": type(model).__name__,
                  "n_params": n_params,
                  "n_layers": len(getattr(model, "layers", []) or [])}))
