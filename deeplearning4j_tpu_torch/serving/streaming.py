"""Resumable token streaming: per-request emitted-token rings
(counterpart of `deeplearning4j_tpu/serving/streaming.py`: host
bookkeeping only, the same cursors, ring, TTL and stats keys).

The streaming tier's contract: a token, once emitted by
a decode slot, is delivered to the consumer EXACTLY once and in order —
across torn connections, slow consumers, replica failovers, and live
KV migrations — or the consumer gets a typed error telling it how to
recover. The pieces:

- **`TokenStream`** — one bounded ring per in-flight generation. The
  decode engine's emission hook `publish()`es every token under a
  monotonic **cursor** (= tokens emitted so far, 1-based); `publish` is
  O(1), never blocks, and never raises into the scheduler loop. The
  ring retains the most recent `capacity` tokens so a reconnecting
  consumer can replay from its last cursor; a consumer that fell out
  of the window gets a typed `StreamBackpressureError` and falls back
  to the exactly-once parked outcome (`claim`).
- **Cursor dedup IS the exactly-once delivery mechanism**: a publish at
  a cursor ≤ the stream's high-water mark is dropped and counted
  (`duplicate_tokens_dropped`). A replica-pool failover re-runs the
  seeded generation from scratch and re-publishes cursors 1..k into
  the SAME stream; a warm KV migration resumes at k+1 on the peer.
  Either way the consumer-visible sequence is append-only — zero
  duplicates, zero gaps, concatenation identical to the unary result.
- **`StreamRegistry`** — the gateway's keyed map of live + recently
  finished streams. `resume_stream(request_id, cursor)` attaches here;
  finished streams linger for `ttl` seconds so a terminal frame lost
  on the wire can still be replayed, then a lazy sweep (no background
  thread) retires them to the dedup door's parked-outcome path.

Slow consumers are shed, never accommodated: the scheduler-side
`publish` drops the OLDEST ring entries on overflow (the slot keeps
decoding at full speed), and it is the *pump* — the gateway handler
thread feeding one socket — that discovers the lag and sheds the
consumer with a typed error. A stalled reader can therefore never pin
a decode slot or stall other slots' emission.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.serving.model_server import ServingError


class StreamBackpressureError(ServingError):
    """The consumer's cursor fell out of the bounded emitted-token ring
    (it stalled while the slot kept decoding) — the stream cannot be
    resumed losslessly from the ring. The generation itself is NOT
    lost: the outcome parks behind the exactly-once door and
    `claim(request_id)` recovers the full sequence. `retry_after`
    hints when the parked outcome should be ready."""

    def __init__(self, msg: str, retry_after: float = 0.5):
        super().__init__(msg)
        self.retry_after = retry_after


class TokenStream:
    """One request's bounded emitted-token ring.

    `publish(cursor, token)` is called from the decode engine's
    scheduler loop: O(1), lock held for a few appends, never blocks on
    a consumer, never raises. `read(cursor)` is called from a gateway
    handler thread pumping one socket: blocks (bounded) for new tokens
    and replays retained history for resumes. `finish(body)` parks the
    terminal wire body (result or typed error + trace) on the stream;
    it is idempotent — the first body wins, so the handler-side worker
    (which holds the trace-enriched body) and the bare execution path
    can both call it safely."""

    def __init__(self, request_id: str, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("stream ring capacity must be >= 1")
        self.request_id = request_id
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # set by finish(); lets a coalescing read() linger without
        # taking a wakeup per published token (publish never sets it)
        self._finished = threading.Event()
        # ring of (token, logprob-entry-or-None); guarded by: _lock
        self._ring: collections.deque = collections.deque()
        self._base = 0  # cursor of the oldest retained token, minus 1; guarded by: _lock
        self._cursor = 0  # tokens published so far (high-water mark); guarded by: _lock
        self._body: Optional[dict] = None  # terminal wire body; guarded by: _lock
        self.duplicate_tokens_dropped = 0  # guarded by: _cond
        self.gap_tokens_dropped = 0  # guarded by: _cond
        self.finished_at: Optional[float] = None  # guarded by: _cond

    # -- producer side (decode engine emission hook) -----------------------
    def publish(self, cursor: int, token: int,
                logprob: Optional[dict] = None) -> bool:
        """Record one emitted token under its absolute cursor.

        Returns True when the token advanced the stream; False when it
        was dropped as a duplicate (cursor ≤ high-water mark — a
        failover re-run or migration replay re-emitting history) or as
        an out-of-order gap (counted loudly; must never happen from a
        single slot's ordered emission)."""
        with self._cond:
            if cursor <= self._cursor:
                self.duplicate_tokens_dropped += 1
                return False
            if cursor != self._cursor + 1:
                # a gap would desync every downstream cursor — refuse
                # the token rather than deliver out of order
                self.gap_tokens_dropped += 1
                return False
            self._ring.append((int(token), logprob))
            self._cursor = cursor
            while len(self._ring) > self.capacity:
                self._ring.popleft()
                self._base += 1
            self._cond.notify_all()
            return True

    def finish(self, body: dict) -> bool:
        """Park the terminal wire body. Idempotent: the first call
        wins; returns True exactly once."""
        with self._cond:
            first = self._body is None
            if first:
                self._body = dict(body)
                self.finished_at = time.monotonic()
            self._cond.notify_all()
            self._finished.set()
            return first

    # -- consumer side (gateway pump) --------------------------------------
    @property
    def cursor(self) -> int:
        with self._lock:
            return self._cursor

    @property
    def done(self) -> bool:
        with self._lock:
            return self._body is not None

    def read(self, cursor: int, timeout: Optional[float] = None,
             linger: float = 0.0
             ) -> Tuple[List[int], Optional[list], int, Optional[dict]]:
        """Everything published past `cursor`, blocking up to `timeout`
        for the first new token. Returns `(tokens, logprobs, new_cursor,
        terminal_body)` — `logprobs` is None unless any returned token
        carries a logprob entry; `terminal_body` is None until the
        stream finished. An empty `tokens` with a body means the
        consumer is fully drained and the body is the terminal frame.

        `linger` > 0 keeps waiting that long AFTER the first new token
        so follow-ups batch into one frame — per-token frame writes are
        the streaming goodput tax. The linger sleeps on the `finished`
        event (publish never touches it), so it costs ZERO wakeups per
        token and aborts the instant the stream finishes: the terminal
        body is never delayed by coalescing.

        Raises `StreamBackpressureError` when `cursor` fell out of the
        ring — the consumer must fall back to the parked outcome."""
        toks, lps, new_cursor, body = self._read_locked(cursor, timeout)
        if linger > 0 and toks and body is None:
            self._finished.wait(linger)
            return self._read_locked(cursor, timeout=0.0)
        return toks, lps, new_cursor, body

    def _read_locked(self, cursor: int, timeout: Optional[float]
                     ) -> Tuple[List[int], Optional[list], int,
                                Optional[dict]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if cursor < self._base:
                    raise StreamBackpressureError(
                        f"stream {self.request_id!r}: cursor {cursor} fell "
                        f"out of the {self.capacity}-token ring (oldest "
                        f"retained cursor is {self._base + 1}) — the "
                        "consumer stalled past the replay window; claim "
                        "the parked outcome instead")
                if cursor < self._cursor:
                    start = cursor - self._base
                    entries = list(itertools.islice(
                        self._ring, start, len(self._ring)))
                    toks = [t for t, _ in entries]
                    lps = [lp for _, lp in entries]
                    if not any(lp is not None for lp in lps):
                        lps = None
                    return toks, lps, self._cursor, self._body
                if self._body is not None:
                    return [], None, cursor, self._body
                if deadline is None:
                    self._cond.wait()
                else:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return [], None, cursor, None
                    self._cond.wait(left)


class StreamRegistry:
    """The gateway's keyed map of token streams.

    `open()` is called once per `generate_stream` execution (re-opening
    a LIVE stream attaches to it — that is how a replica-pool failover
    re-run keeps publishing into the same ring); `attach()` serves
    `resume_stream`; a lazy TTL sweep (piggybacked on open/attach, no
    background thread) retires finished streams and folds their dedup
    counters into the registry totals. `stats()` matches
    `observability.STREAMING_STATS_KEYS` and is registered into the
    serving tier's MetricsRegistry for Prometheus exposition."""

    def __init__(self, ring: int = 1024, ttl: float = 120.0):
        if ttl <= 0:
            raise ValueError("stream ttl must be > 0")
        self.ring = int(ring)
        self.ttl = float(ttl)
        self._lock = threading.Lock()
        self._streams: Dict[str, TokenStream] = {}  # guarded by: _lock
        self._opened = 0  # guarded by: _lock
        self._finished = 0  # guarded by: _lock
        self._resumes = 0  # guarded by: _lock
        self._sheds = 0  # guarded by: _lock
        self._dups_retired = 0  # dropped dups of swept streams; guarded by: _lock

    def _sweep_locked(self) -> None:
        now = time.monotonic()
        dead = [rid for rid, s in self._streams.items()
                if s.finished_at is not None
                and now - s.finished_at > self.ttl]
        for rid in dead:
            self._dups_retired += \
                self._streams.pop(rid).duplicate_tokens_dropped

    def open(self, request_id: str) -> TokenStream:
        """Get-or-create the stream for one execution. A live stream is
        returned as-is (failover re-runs keep the ring and its cursor
        high-water mark — dedup depends on it); a finished one is
        replaced, since a re-execution past the door is a genuinely new
        attempt."""
        rid = str(request_id)
        with self._lock:
            self._sweep_locked()
            stream = self._streams.get(rid)
            if stream is not None and stream.finished_at is None:
                return stream
            if stream is not None:
                self._dups_retired += stream.duplicate_tokens_dropped
            stream = TokenStream(rid, capacity=self.ring)
            self._streams[rid] = stream
            self._opened += 1
            return stream

    def get(self, request_id: str) -> Optional[TokenStream]:
        with self._lock:
            self._sweep_locked()
            return self._streams.get(str(request_id))

    def attach(self, request_id: str) -> Optional[TokenStream]:
        """A resuming consumer re-joins its stream; None when the
        stream aged out (the caller falls back to the parked
        outcome)."""
        with self._lock:
            self._sweep_locked()
            stream = self._streams.get(str(request_id))
            if stream is not None:
                self._resumes += 1
            return stream

    def finish(self, stream: TokenStream, body: dict) -> bool:
        """Park `body` as `stream`'s terminal frame (idempotent) and
        count the finish exactly once."""
        first = stream.finish(body)
        if first:
            with self._lock:
                self._finished += 1
        return first

    def shed(self, stream: TokenStream) -> None:
        """Count one slow-consumer shed (the pump detached; the
        generation keeps running and its outcome parks)."""
        with self._lock:
            self._sheds += 1

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            live = [s for s in self._streams.values()
                    if s.finished_at is None]
            dups = self._dups_retired + sum(
                s.duplicate_tokens_dropped
                for s in self._streams.values())
            return {
                "streams_active": len(live),
                "streams_opened": self._opened,
                "streams_finished": self._finished,
                "stream_resumes": self._resumes,
                "stream_backpressure_sheds": self._sheds,
                "duplicate_tokens_dropped": dups,
                "ring_capacity": self.ring,
                "ttl_s": self.ttl,
            }
