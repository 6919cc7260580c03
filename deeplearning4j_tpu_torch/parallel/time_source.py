"""Cross-node time sources for training stats alignment: a host copy of
`deeplearning4j_tpu/parallel/time_source.py` (pure Python).

Reference: `spark/time/TimeSource.java` / `NTPTimeSource.java` /
`TimeSourceProvider.java` (SURVEY §2.4) — executors stamp their stats with
NTP-corrected time so the Spark master can align per-phase timelines across
nodes. Equivalents here: `SystemTimeSource` (wall clock),
`MonotonicTimeSource` (drift-free intervals with a wall-clock anchor), and
`NTPTimeSource` (SNTP query when the network allows it; without egress
construction fails fast unless an offset is injected, e.g. measured
out-of-band by the cluster launcher).
"""
from __future__ import annotations

import os
import struct
import time
from typing import Optional


class TimeSource:
    """`current_time_millis()` contract (reference `TimeSource.java`)."""

    def current_time_millis(self) -> int:
        raise NotImplementedError


class SystemTimeSource(TimeSource):
    def current_time_millis(self) -> int:
        return int(time.time() * 1000)


class MonotonicTimeSource(TimeSource):
    """Wall-clock anchor + monotonic deltas: immune to NTP step
    adjustments mid-run (interval math stays consistent)."""

    def __init__(self):
        self._anchor_wall_ms = time.time() * 1000.0
        self._anchor_mono = time.monotonic()

    def current_time_millis(self) -> int:
        return int(self._anchor_wall_ms
                   + (time.monotonic() - self._anchor_mono) * 1000.0)


class NTPTimeSource(TimeSource):
    """SNTP-corrected clock (reference `NTPTimeSource.java`).

    `offset_ms` injects a known offset without any network IO. Otherwise a
    single SNTP query runs against `server` at construction; environments
    without egress get an immediate OSError instead of a silent wrong
    clock."""

    NTP_EPOCH_DELTA = 2208988800  # 1900 → 1970 seconds

    def __init__(self, server: str = "pool.ntp.org", port: int = 123,
                 timeout: float = 5.0, offset_ms: Optional[float] = None):
        if offset_ms is not None:
            self.offset_ms = float(offset_ms)
        else:
            self.offset_ms = self._query_offset(server, port, timeout)
        self._base = MonotonicTimeSource()

    @staticmethod
    def _query_offset(server: str, port: int, timeout: float) -> float:
        import socket

        pkt = b"\x1b" + 47 * b"\0"
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(timeout)
            t0 = time.time()
            s.sendto(pkt, (server, port))
            data, _ = s.recvfrom(512)
            t3 = time.time()
        secs, frac = struct.unpack("!II", data[40:48])
        server_time = secs - NTPTimeSource.NTP_EPOCH_DELTA + frac / 2 ** 32
        # offset per SNTP with t1≈t2≈server_time: midpoint correction
        return ((server_time - t0) + (server_time - t3)) / 2.0 * 1000.0

    def current_time_millis(self) -> int:
        return int(self._base.current_time_millis() + self.offset_ms)


class TimeSourceProvider:
    """Picks the time source (reference `TimeSourceProvider.java`: system
    property `timesource`; here env var `DL4J_TPU_TIMESOURCE` =
    system|monotonic|ntp)."""

    _instance: Optional[TimeSource] = None

    @classmethod
    def get_instance(cls) -> TimeSource:
        if cls._instance is None:
            kind = os.environ.get("DL4J_TPU_TIMESOURCE", "monotonic").lower()
            if kind == "system":
                cls._instance = SystemTimeSource()
            elif kind == "ntp":
                cls._instance = NTPTimeSource()
            else:
                cls._instance = MonotonicTimeSource()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None
