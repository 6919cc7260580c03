"""Remote stats routing (reference
`deeplearning4j-core/.../api/storage/impl/RemoteUIStatsStorageRouter.java`:
HTTP POSTs stats records to a remote UI's receiver module
`ui/module/remote/RemoteReceiverModule.java`).

Counterpart of `deeplearning4j_tpu/ui/remote.py`: it posts the same
bodies, so it feeds either package's `UIServer`."""
from __future__ import annotations

import json
import logging
import queue
import threading
import time
import urllib.request
from typing import Optional

from deeplearning4j_tpu_torch.ui.storage import StatsRecord, StatsStorageRouter

logger = logging.getLogger("deeplearning4j_tpu_torch")


class RemoteUIStatsStorageRouter(StatsStorageRouter):
    """Asynchronously POSTs records to `<url>/remote/receive` (background
    thread + bounded queue, mirroring the reference's async posting with
    retry backoff — `RemoteUIStatsStorageRouter.java` retries with
    exponential delay and counts what it sheds).

    Stats delivery is best-effort by design — a slow/unreachable UI must
    never stall training — but loss is OBSERVABLE, never silent:
    `dropped_count` exposes how many records were discarded (full queue,
    or POST retries exhausted), and a rate-limited warning (at most one
    per `warn_every` seconds, with the running total) lands in the log
    the moment shedding starts. Transient POST failures retry `retries`
    times with bounded exponential backoff (`backoff ×2^attempt`)."""

    def __init__(self, url: str, queue_size: int = 1000,
                 retries: int = 3, timeout: float = 5.0,
                 backoff: float = 0.1, warn_every: float = 30.0):
        self.url = url.rstrip("/") + "/remote/receive"
        self.retries = retries
        self.timeout = timeout
        self.backoff = backoff
        self.warn_every = warn_every
        self._q: "queue.Queue[Optional[StatsRecord]]" = queue.Queue(queue_size)
        self._dropped = 0
        self._drop_lock = threading.Lock()
        # -inf, not 0.0: monotonic's origin is arbitrary (host uptime),
        # and the FIRST drop must always warn
        self._last_warn = -float("inf")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def dropped_count(self) -> int:
        """Records discarded so far (queue overflow + exhausted POSTs)."""
        return self._dropped

    def _record_drop(self, why: str) -> None:
        with self._drop_lock:
            self._dropped += 1
            total = self._dropped
            now = time.monotonic()
            warn = now - self._last_warn >= self.warn_every
            if warn:
                self._last_warn = now
        if warn:
            logger.warning(
                "remote UI router: dropping stats records (%s); %d "
                "dropped so far — the UI at %s is slow or unreachable",
                why, total, self.url)

    def put_record(self, record: StatsRecord) -> None:
        try:
            self._q.put_nowait(record)
        except queue.Full:
            self._record_drop("queue full")

    def shutdown(self, timeout: float = 10.0) -> None:
        self._q.put(None)
        self._thread.join(timeout)

    def _post_once(self, body: bytes) -> None:
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            r.read()

    def _run(self) -> None:
        while True:
            rec = self._q.get()
            if rec is None:
                return
            body = rec.to_json().encode()
            for attempt in range(self.retries):
                try:
                    self._post_once(body)
                    break
                except Exception as e:
                    if attempt == self.retries - 1:
                        self._record_drop(
                            f"POST failed {self.retries}x, last: "
                            f"{type(e).__name__}")
                    else:
                        # bounded exponential backoff between attempts;
                        # the bounded queue absorbs the stall (overflow
                        # sheds with its own counter, never blocks)
                        time.sleep(self.backoff * (2 ** attempt))
