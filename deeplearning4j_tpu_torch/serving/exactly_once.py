"""Exactly-once serving: idempotency keys, a durable request journal,
and detach/reclaim across gateway crashes (counterpart of
`deeplearning4j_tpu/serving/exactly_once.py`). The journal's records are
byte-compatible with the JAX package's: JSON lines with sorted keys and
the `crc32_hex` of the canonical record, the same segment names,
rotation and garbage collection, so a journal directory written by
either package replays in the other. Outcomes are plain JSON-able
bodies (token ids as int lists), never tensors.

Three legs share one `request_id` spine (client-minted, stamped on every
gateway call):

- **Idempotency-keyed dedup** (`DedupCache`) — a bounded, TTL'd
  completed-result ring plus an in-flight registry. ANY wire-level retry
  of a stamped request — including the historically non-retryable
  `fit`/`reload_model`/`resume_generate` — returns the ORIGINAL outcome
  instead of re-executing, so the client-side `_IDEMPOTENT` whitelist
  collapses into one dedup door and a seeded `generate` retry stops
  recomputing the whole rollout.
- **Detach/reclaim** — a connection lost mid-`generate` no longer wastes
  the decode: the handler keeps executing, the outcome parks in the
  cache (completion happens BEFORE the reply is written), and the
  reconnecting client `claim(request_id)`s it. Typed
  `ResultPendingError` (+ retry_after) while still executing, typed
  `UnknownRequestError` once the outcome ages past the TTL.
- **Durable intake journal** (`RequestJournal`) — accepted
  generate/predict/fit requests append to a CRC'd, fsync'd WAL built on
  `util.checkpoint_store`'s atomic-commit/checksum machinery
  (journal-at-admission, mark-complete on reply, segment rotation + GC).
  On gateway restart, unfinished journaled requests replay through fresh
  prefill — same seed, argmax-identical — so a kill -9 of the gateway
  under live traffic completes every accepted request exactly once.

The promise is *exactly-once observable behavior*: at-least-once
delivery (journal replay + client retries) with at-most-once side
effects (the dedup door), bounded by the TTL — a client must reclaim a
detached outcome within `ttl` seconds.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.serving.model_server import ServingError
from deeplearning4j_tpu_torch.util.checkpoint_store import crc32_hex, fsync_dir

logger = logging.getLogger("deeplearning4j_tpu_torch")


# ---------------------------------------------------------------------------
# RPC-contract classification (pinned by tests/test_gateway_robustness):
# every public gateway entry-point method must appear in EXACTLY one set.
# A new RPC that is in neither fails the contract test — nobody ships an
# endpoint without deciding its retry story.

# Side-effectful (or install-like) methods whose retry-safety comes FROM
# the dedup door: a stamped retry returns the parked outcome, never
# re-executes.
DEDUPED_RPCS = frozenset({
    "fit", "create_model", "load_model", "reload_model", "rolling_reload",
    "resume_generate",
    # streaming: a reconnect must re-attach to the live ring (or claim
    # the parked outcome), never start a second decode of the sequence
    "generate_stream",
    # remote-replica entry-point extras (install-like)
    "serve_net", "restore_snapshot",
})

# Documented side-effect-free: safe to blindly re-execute even WITHOUT
# the door (read-only, resolve-by-id, or seeded-deterministic). The door
# still dedups them when stamped — a generate retry returns the parked
# rollout instead of recomputing it — but correctness never depends on it.
SIDE_EFFECT_FREE_RPCS = frozenset({
    "predict", "evaluate", "score", "generate", "save_model",
    "server_stats", "pool_stats", "autoscaler_stats", "metrics",
    "flight_record", "set_tenant_quota", "migrate_slots",
    "fetch_handoff", "commit_handoff", "abort_handoff",
    # cluster prefix cache: reads (header/frame/depth/chains) plus
    # export_prefix, whose re-execution grants a fresh lease the
    # orphaned original's TTL sweep unpins
    "fetch_handoff_header", "fetch_handoff_frame", "prefix_depth",
    "prefix_chains", "export_prefix",
    # streaming: re-attach-by-id + cursor dedup in the ring — a replayed
    # resume can only re-deliver frames the client already trimmed
    "resume_stream",
    # remote-replica entry-point extras (reads)
    "health", "snapshot_model", "replica_metrics",
})

# The subset of deduped traffic that also journals at admission: the
# data-path requests a gateway crash must not lose, plus fit (whose
# durable complete record is what makes a post-restart retry return the
# original outcome instead of training twice).
JOURNALED_RPCS = frozenset({"generate", "generate_stream", "predict",
                            "fit"})


# ---------------------------------------------------------------------------
# typed errors (join the serving error taxonomy)


class ResultPendingError(ServingError):
    """The request is still executing (the original submission, or a
    crash-recovery replay, holds the in-flight slot): come back with
    `claim(request_id)` after `retry_after` seconds."""

    def __init__(self, msg: str, retry_after: float = 0.05):
        super().__init__(msg)
        self.retry_after = float(retry_after)


class UnknownRequestError(ServingError):
    """No record of this request_id: never admitted here, or its
    completed outcome aged out of the dedup ring (TTL / capacity). The
    at-most-once promise is TTL-bounded — reclaim within the window."""


# ---------------------------------------------------------------------------
# leg 1: the dedup door's completed-result ring + in-flight registry


class _Entry:
    __slots__ = ("outcome", "expires_at", "durable")

    def __init__(self, outcome: dict, expires_at: float, durable: bool):
        self.outcome = outcome
        self.expires_at = expires_at
        self.durable = durable


class DedupCache:
    """Bounded TTL'd completed-result ring + in-flight registry.

    Thread-safe. `begin(request_id)` verdicts:

    - ``("cached", outcome)`` — finished already; return the parked
      outcome verbatim.
    - ``("pending", retry_after)`` — some handler (or the replay loop)
      owns the execution right now.
    - ``("execute", None)`` — the caller now OWNS the execution and must
      call `complete` (park the outcome) or `abandon` (a shed the client
      should genuinely re-attempt) exactly once.

    Entries expire `ttl` seconds after completion; the ring is bounded
    at `capacity` (oldest completion evicted first)."""

    def __init__(self, capacity: int = 1024, ttl: float = 300.0,
                 pending_retry_after: float = 0.05):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if ttl <= 0:
            raise ValueError("ttl must be > 0")
        self.capacity = int(capacity)
        self.ttl = float(ttl)
        self.pending_retry_after = float(pending_retry_after)
        self._lock = threading.Lock()
        # completion-ordered ring of finished outcomes — guarded by: _lock
        self._done: "collections.OrderedDict[str, _Entry]" = \
            collections.OrderedDict()
        # request_id -> monotonic start time — guarded by: _lock
        self._inflight: Dict[str, float] = {}
        # counters — guarded by: _lock
        self._hits = 0
        self._executions = 0
        self._expired = 0
        self._evicted = 0
        self._double_executions = 0
        self._loaded = 0

    def _sweep_locked(self, now: float) -> None:
        # completion order == expiry order (uniform ttl), so expired
        # entries cluster at the front of the ring
        while self._done:
            rid, ent = next(iter(self._done.items()))
            if ent.expires_at > now:
                break
            del self._done[rid]
            self._expired += 1

    def begin(self, request_id: str) -> Tuple[str, Any]:
        now = time.monotonic()
        with self._lock:
            self._sweep_locked(now)
            ent = self._done.get(request_id)
            if ent is not None:
                self._hits += 1
                return "cached", ent.outcome
            if request_id in self._inflight:
                return "pending", self.pending_retry_after
            self._inflight[request_id] = now
            self._executions += 1
            return "execute", None

    def complete(self, request_id: str, outcome: dict,
                 durable: bool = False) -> None:
        """Park `outcome` (a wire response body, no "id") and release
        the in-flight slot."""
        now = time.monotonic()
        with self._lock:
            self._inflight.pop(request_id, None)
            if request_id in self._done:
                # two executors raced past begin() — impossible through
                # one door, so count it loudly rather than hide it
                self._double_executions += 1
                del self._done[request_id]
            self._done[request_id] = _Entry(outcome, now + self.ttl, durable)
            while len(self._done) > self.capacity:
                self._done.popitem(last=False)
                self._evicted += 1

    def abandon(self, request_id: str) -> None:
        """Release the in-flight slot WITHOUT caching: the outcome was a
        shed (carries retry_after) and the client's retry is a genuine
        new attempt, not a duplicate."""
        with self._lock:
            self._inflight.pop(request_id, None)

    def load(self, request_id: str, outcome: dict) -> None:
        """Preload a durable completed outcome at startup (journal
        replay of the at-most-once promise across a crash): counted as
        neither a hit nor an execution."""
        now = time.monotonic()
        with self._lock:
            if request_id in self._done:
                return
            self._done[request_id] = _Entry(outcome, now + self.ttl, True)
            self._loaded += 1
            while len(self._done) > self.capacity:
                self._done.popitem(last=False)
                self._evicted += 1

    def claim(self, request_id: str) -> dict:
        """The detach/reclaim edge: the parked outcome of a request
        whose client disconnected mid-reply. Typed `ResultPendingError`
        while it is still executing, typed `UnknownRequestError` when
        there is no record (never admitted, or aged past the TTL)."""
        now = time.monotonic()
        with self._lock:
            self._sweep_locked(now)
            ent = self._done.get(request_id)
            if ent is not None:
                self._hits += 1
                return ent.outcome
            inflight = request_id in self._inflight
        if inflight:
            raise ResultPendingError(
                f"request {request_id!r} is still executing; claim it "
                f"again in {self.pending_retry_after:.3g}s",
                retry_after=self.pending_retry_after)
        raise UnknownRequestError(
            f"no record of request {request_id!r}: never admitted here, "
            f"or its outcome aged past the {self.ttl:.3g}s TTL")

    def stats(self) -> dict:
        with self._lock:
            return {
                "completed": len(self._done),
                "inflight": len(self._inflight),
                "capacity": self.capacity,
                "ttl_s": self.ttl,
                "dedup_hits": self._hits,
                "executions": self._executions,
                "expired": self._expired,
                "evicted": self._evicted,
                "double_executions": self._double_executions,
                "durable_loaded": self._loaded,
            }


# ---------------------------------------------------------------------------
# leg 3: the durable intake journal (WAL on checkpoint_store discipline)


class _Segment:
    __slots__ = ("path", "open_ids", "n_records", "last_write")

    def __init__(self, path: Path):
        self.path = path
        self.open_ids: set = set()  # admits not yet completed
        self.n_records = 0
        self.last_write = time.monotonic()


class RequestJournal:
    """Append-only WAL of accepted journaled requests.

    Record format: one JSON object per line,
    ``{"crc": <crc32_hex of the canonical "rec" JSON>, "rec": {...}}``
    — the same checksum primitive checkpoint manifests use, so a torn
    tail (the kill -9 signature) or a flipped byte is refused by the
    CRC, skipped, and counted rather than replayed as garbage. ``rec``
    carries ``kind`` ("admit" | "complete"), ``seq``, ``request_id``,
    and for admits the method + wire-encoded params; completes carry
    the wire outcome body (or ``"void": true`` for shed outcomes a
    retry should genuinely re-attempt).

    Durability: every append flushes + fsyncs before returning, and a
    freshly created segment fsyncs its directory (the
    `util.checkpoint_store` atomic-commit discipline). Segments rotate
    at `segment_max_records`; a segment is GC'd once every admit in it
    has completed AND its newest record is older than `gc_ttl` — the
    durable dedup outcomes must outlive the in-memory ring's TTL
    promise, not vanish the moment the ledger balances."""

    _SEG_FMT = "journal-{:08d}.wal"

    def __init__(self, root, *, segment_max_records: int = 512,
                 gc_ttl: float = 300.0, fsync: bool = True):
        if segment_max_records < 1:
            raise ValueError("segment_max_records must be >= 1")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.segment_max_records = int(segment_max_records)
        self.gc_ttl = float(gc_ttl)
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        # everything below guarded by: _lock
        self._segments: List[_Segment] = []
        self._fh = None  # open append handle of the current segment
        self._seq = 0
        self._pending: Dict[str, dict] = {}  # admits without a complete
        self._admit_seg: Dict[str, _Segment] = {}
        # request_id -> (wall completion time, outcome | None for void)
        self._completed: Dict[str, Tuple[float, Optional[dict]]] = {}
        self._completed_methods: Dict[str, str] = {}
        self.appends = 0
        self.completes = 0
        self.torn_skipped = 0
        self.corrupt_skipped = 0
        self.gc_segments = 0
        self.loaded_pending = 0
        self.loaded_completed = 0
        self._load_locked()

    # -- record codec -------------------------------------------------------
    @staticmethod
    def _encode(rec: dict) -> bytes:
        body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        line = json.dumps({"crc": crc32_hex(body.encode("utf-8")),
                           "rec": rec},
                          sort_keys=True, separators=(",", ":"))
        return line.encode("utf-8") + b"\n"

    @staticmethod
    def _decode(line: bytes) -> dict:
        obj = json.loads(line)
        rec = obj["rec"]
        body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        if crc32_hex(body.encode("utf-8")) != obj["crc"]:
            raise ValueError("record CRC mismatch")
        if rec.get("kind") not in ("admit", "complete") \
                or "request_id" not in rec:
            raise ValueError("malformed journal record")
        return rec

    # -- load / replay scan ---------------------------------------------
    def _segment_paths(self) -> List[Path]:
        return sorted(p for p in self.root.iterdir()
                      if p.name.startswith("journal-")
                      and p.name.endswith(".wal"))

    def _load_locked(self) -> None:
        paths = self._segment_paths()
        for pi, path in enumerate(paths):
            seg = _Segment(path)
            try:
                # segment names embed the seq at open time; folding them
                # into the counter keeps fresh segment names from ever
                # colliding with an old (possibly empty) file
                self._seq = max(self._seq,
                                int(path.name[len("journal-"):-len(".wal")]))
            except ValueError:
                pass
            try:
                raw = path.read_bytes()
            except OSError as e:
                logger.warning("journal: unreadable segment %s skipped: %s",
                               path.name, e)
                self.corrupt_skipped += 1
                continue
            lines = [ln for ln in raw.split(b"\n") if ln.strip()]
            for li, line in enumerate(lines):
                try:
                    rec = self._decode(line)
                except (ValueError, KeyError, TypeError) as e:
                    # the very last line of the very last segment is the
                    # kill -9 torn-write signature; anything else is
                    # damage (counted separately, chaos-drilled)
                    if pi == len(paths) - 1 and li == len(lines) - 1:
                        self.torn_skipped += 1
                        logger.warning(
                            "journal: torn tail record in %s skipped "
                            "(%s) — the request was never durably "
                            "admitted", path.name, e)
                    else:
                        self.corrupt_skipped += 1
                        logger.warning(
                            "journal: corrupt record %d in %s skipped "
                            "(%s)", li, path.name, e)
                    continue
                seg.n_records += 1
                self._seq = max(self._seq, int(rec.get("seq", 0)))
                self._apply_locked(rec, seg)
            # loaded segments age from NOW (monotonic, like appends): a
            # wall-clock mtime cannot be compared against monotonic time
            seg.last_write = time.monotonic()
            self._segments.append(seg)
        self.loaded_pending = len(self._pending)
        self.loaded_completed = len(self._completed)

    def _apply_locked(self, rec: dict, seg: _Segment) -> None:
        rid = str(rec["request_id"])
        if rec["kind"] == "admit":
            if rid in self._pending or rid in self._completed:
                return  # duplicate admit: idempotent
            self._pending[rid] = rec
            self._admit_seg[rid] = seg
            seg.open_ids.add(rid)
        else:  # complete
            admit_seg = self._admit_seg.pop(rid, None)
            if admit_seg is not None:
                admit_seg.open_ids.discard(rid)
            admit = self._pending.pop(rid, None)
            if admit is not None:
                self._completed_methods[rid] = str(admit.get("method", ""))
            outcome = None if rec.get("void") else rec.get("outcome")
            self._completed[rid] = (float(rec.get("t", time.time())),
                                    outcome)

    # -- append path ------------------------------------------------------
    def _open_segment_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError as e:
                logger.warning("journal: segment close failed: %s", e)
        path = self.root / self._SEG_FMT.format(self._seq + 1)
        self._fh = open(path, "ab")
        # a new WAL segment must itself survive power loss before the
        # records inside it can claim to
        fsync_dir(self.root)
        self._segments.append(_Segment(path))

    def _append_locked(self, rec: dict) -> None:
        # _fh is not None implies _segments[-1] is the live segment
        if self._fh is None \
                or self._segments[-1].n_records >= self.segment_max_records:
            self._open_segment_locked()
        seg = self._segments[-1]
        self._fh.write(self._encode(rec))
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        seg.n_records += 1
        seg.last_write = time.monotonic()
        return None

    def admit(self, request_id: str, method: str, params: dict) -> bool:
        """Journal an accepted request BEFORE it executes. Idempotent:
        a retry or replay of an already-journaled id appends nothing."""
        request_id = str(request_id)
        with self._lock:
            if request_id in self._pending or request_id in self._completed:
                return False
            self._seq += 1
            rec = {"kind": "admit", "seq": self._seq,
                   "request_id": request_id, "method": str(method),
                   "params": params, "t": time.time()}
            self._append_locked(rec)
            seg = self._segments[-1]
            self._pending[request_id] = rec
            self._admit_seg[request_id] = seg
            seg.open_ids.add(request_id)
            self.appends += 1
            return True

    def complete(self, request_id: str, outcome: Optional[dict],
                 void: bool = False) -> bool:
        """Mark a journaled request done (outcome = the wire response
        body), or resolve it VOID (a shed the client should genuinely
        retry — no durable dedup entry). No-op for ids this journal
        never admitted (non-journaled methods ride the in-memory ring
        only)."""
        request_id = str(request_id)
        with self._lock:
            if request_id not in self._pending:
                return False
            self._seq += 1
            rec = {"kind": "complete", "seq": self._seq,
                   "request_id": request_id, "t": time.time()}
            if void:
                rec["void"] = True
            else:
                rec["outcome"] = outcome
            self._append_locked(rec)
            admit = self._pending.pop(request_id)
            self._completed_methods[request_id] = \
                str(admit.get("method", ""))
            seg = self._admit_seg.pop(request_id, None)
            if seg is not None:
                seg.open_ids.discard(request_id)
            self._completed[request_id] = (
                time.time(), None if void else outcome)
            self.completes += 1
            self._gc_locked()
            return True

    # -- GC / ledger balance ----------------------------------------------
    def _gc_locked(self) -> None:
        now = time.monotonic()
        wall_now = time.time()
        keep: List[_Segment] = []
        for seg in self._segments:
            is_current = seg is self._segments[-1]
            if not is_current and not seg.open_ids \
                    and now - seg.last_write > self.gc_ttl:
                try:
                    seg.path.unlink()
                except OSError as e:
                    logger.warning("journal: segment GC of %s failed: %s",
                                   seg.path.name, e)
                    keep.append(seg)
                    continue
                self.gc_segments += 1
            else:
                keep.append(seg)
        self._segments = keep
        # the in-memory completed ledger obeys the same horizon, or a
        # long-lived gateway grows it without bound
        expired = [rid for rid, (t, _) in self._completed.items()
                   if wall_now - t > self.gc_ttl]
        for rid in expired:
            del self._completed[rid]
            self._completed_methods.pop(rid, None)

    def gc(self) -> int:
        """Run a GC pass now; returns how many segments remain on disk."""
        with self._lock:
            self._gc_locked()
            return len(self._segments)

    # -- replay-side reads --------------------------------------------------
    def pending_records(self) -> List[dict]:
        """Admits with no complete, oldest first — the crash-recovery
        replay work list."""
        with self._lock:
            return sorted(self._pending.values(),
                          key=lambda r: int(r.get("seq", 0)))

    def completed_outcomes(self) -> Dict[str, dict]:
        """request_id -> durable outcome body for non-void completes —
        preloaded into the dedup ring at startup so a post-restart retry
        of an already-executed fit returns the original outcome."""
        with self._lock:
            return {rid: outcome
                    for rid, (_, outcome) in self._completed.items()
                    if outcome is not None}

    def completed_by_method(self) -> Dict[str, int]:
        """How many durable completes each method holds (the crash
        drill's exactly-once arithmetic: executions after restart +
        durable completes before it == total requests)."""
        with self._lock:
            out: Dict[str, int] = {}
            for m in self._completed_methods.values():
                out[m] = out.get(m, 0) + 1
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "pending": len(self._pending),
                "completed": len(self._completed),
                "segments": len(self._segments),
                "appends": self.appends,
                "completes": self.completes,
                "torn_skipped": self.torn_skipped,
                "corrupt_skipped": self.corrupt_skipped,
                "gc_segments": self.gc_segments,
                "loaded_pending": self.loaded_pending,
                "loaded_completed": self.loaded_completed,
            }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError as e:
                    logger.warning("journal: close failed: %s", e)
                self._fh = None


# ---------------------------------------------------------------------------
# the door: one dedup gate + journal + replay, shared by every stamped RPC


class ExactlyOnceDoor:
    """The gateway's single dedup door.

    Handler contract (see `gateway.GatewayServer`): `admit` BEFORE
    dispatch; on "execute" the handler owns the request and must call
    `complete` with the response body (everything but "id") BEFORE the
    reply is written — so a client that disconnected mid-response can
    still `claim` the parked outcome. Outcomes carrying `retry_after`
    (sheds) resolve the ledger VOID and are never cached: the client's
    retry is a genuine new attempt.

    With `journal_dir`, admits of `JOURNALED_RPCS` hit the WAL before
    execution and durable completes preload the dedup ring at
    construction — at-most-once survives the process."""

    def __init__(self, journal_dir=None, capacity: int = 1024,
                 ttl: float = 300.0, pending_retry_after: float = 0.05,
                 journal_kwargs: Optional[dict] = None):
        self.cache = DedupCache(capacity=capacity, ttl=ttl,
                                pending_retry_after=pending_retry_after)
        self.journal: Optional[RequestJournal] = None
        self._lock = threading.Lock()
        self._replays = 0  # guarded by: _lock
        if journal_dir is not None:
            kw = dict(journal_kwargs or {})
            kw.setdefault("gc_ttl", ttl)
            self.journal = RequestJournal(journal_dir, **kw)
            for rid, outcome in self.journal.completed_outcomes().items():
                self.cache.load(rid, outcome)

    def admit(self, request_id: str, method: str,
              params: dict) -> Tuple[str, Any]:
        request_id = str(request_id)
        verdict, info = self.cache.begin(request_id)
        if verdict == "execute" and self.journal is not None \
                and method in JOURNALED_RPCS:
            self.journal.admit(request_id, method, params or {})
        return verdict, info

    def complete(self, request_id: str, outcome: dict,
                 retryable: bool = False) -> None:
        request_id = str(request_id)
        if retryable:
            self.cache.abandon(request_id)
            if self.journal is not None:
                self.journal.complete(request_id, None, void=True)
            return
        self.cache.complete(request_id, outcome)
        if self.journal is not None:
            self.journal.complete(request_id, outcome)

    def claim(self, request_id: str) -> dict:
        return self.cache.claim(str(request_id))

    def pending_records(self) -> List[dict]:
        if self.journal is None:
            return []
        return self.journal.pending_records()

    def replay(self, execute: Callable[[str, dict], dict],
               ready: Optional[Callable[[str, dict], bool]] = None) -> int:
        """Run unfinished journaled admits through
        ``execute(method, wire_params) -> wire outcome body``. `ready`
        (when given) defers records whose prerequisites — typically the
        named model — are not installed yet. Each replayed request rides
        the same dedup door as live traffic, so a reconnecting client's
        retry and the replay loop can never both execute one id."""
        done = 0
        for rec in self.pending_records():
            method = str(rec.get("method", ""))
            params = rec.get("params") or {}
            if ready is not None and not ready(method, params):
                continue
            rid = str(rec["request_id"])
            verdict, _ = self.cache.begin(rid)
            if verdict != "execute":
                continue  # a live retry beat us to it, or already done
            outcome = execute(method, params)
            retryable = isinstance(outcome, dict) and "error" in outcome \
                and "retry_after" in outcome
            self.complete(rid, outcome, retryable=retryable)
            with self._lock:
                self._replays += 1
            done += 1
        return done

    def stats(self) -> dict:
        with self._lock:
            replays = self._replays
        out = {"cache": self.cache.stats(), "replays": replays,
               "journal": self.journal.stats()
               if self.journal is not None else None}
        if self.journal is not None:
            out["completed_by_method"] = self.journal.completed_by_method()
        return out

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()
