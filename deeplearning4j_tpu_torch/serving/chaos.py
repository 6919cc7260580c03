"""Serving-tier chaos injectors, in-process half (counterpart of
`deeplearning4j_tpu/serving/chaos.py`). They drive the serving ladders
end to end:

- overload → typed shed → recovery (`SlowInferenceInjector`),
- breaker open → half-open probe → close (`BrokenModelInjector`),
- reload-of-corrupt-candidate → rejection with the previous model still
  serving (`ReloadCorruptionInjector`),

and the REPLICA-level ladders of `serving/replica_pool.py`:

- replica crash mid-flight → failover serves the request, probe loop
  evicts, revival re-admits (`ReplicaCrashInjector`),
- replica wedged inside a device step → watchdog eviction, hedged
  requests won by the healthy replica (`ReplicaHangInjector`),
- corrupted rolling-reload candidate → pool-wide rollback
  (`ReloadCorruptionInjector`, reused per replica),

plus the journal, KV-transfer and prefix-fetch damage of the
exactly-once and cluster tiers, and the tenant-flood and load-spike
load generators of the QoS and autoscaling drills.

`SlowInferenceInjector`, `BrokenModelInjector`, `ReplicaCrashInjector`
and `ReplicaHangInjector` plug into `ModelServer(infer_hooks=[...])`,
called as `hook(phase, info)` at `pre_step`/`post_step` around every
device step (predict batches and the engine's generation steps alike).
`ReloadCorruptionInjector` damages checkpoint artifacts on disk; its
`poison_params` writes the port's zip, which the JAX package also reads.

The network injectors drive the cross-process pool: `ChaosProxy` is a
man-in-the-middle in front of one gateway endpoint (partition, latency,
slow-loris, garbage and mid-response reset), the injectors built on it
name one fault each, and `SlowConsumerInjector` stalls a streaming
consumer on a gateway client.
"""
from __future__ import annotations

import contextlib
import logging
import socket
import struct
import threading
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")


class InjectedServingFault(RuntimeError):
    """Raised by `BrokenModelInjector` inside the device step — the
    server must translate it into a typed `InferenceFailedError` and
    count it toward the circuit breaker, exactly like a real failure."""


class SlowInferenceInjector:
    """Deterministic serving straggler: every device step sleeps `delay`
    seconds while `active`. With a delay ≫ the request arrival interval
    the bounded queue fills and admission control MUST shed — the
    overload drill. `release()` ends the slowdown (recovery phase);
    `steps` counts affected dispatches."""

    def __init__(self, delay: float = 0.2):
        self.delay = delay
        self.active = True
        self.steps = 0

    def release(self) -> None:
        self.active = False

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "pre_step" and self.active:
            self.steps += 1
            time.sleep(self.delay)


class BrokenModelInjector:
    """Model breakage on demand: while `active`, every device step
    raises `InjectedServingFault` (mode='raise') or flags the step so a
    test double can poison outputs. Drives the breaker ladder: failures
    accumulate → breaker opens → `heal()` → the half-open probe succeeds
    → breaker closes. `failures` counts injected faults."""

    def __init__(self, mode: str = "raise"):
        if mode not in ("raise",):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.active = True
        self.failures = 0
        self._lock = threading.Lock()

    def heal(self) -> None:
        self.active = False

    def break_again(self) -> None:
        self.active = True

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "pre_step" and self.active:
            with self._lock:
                self.failures += 1
            raise InjectedServingFault(
                "injected model breakage (serving chaos)")


class ReplicaCrashInjector:
    """Simulated replica process death. Plug into ONE replica's
    `infer_hooks`; after `crash()` every device step on that replica
    raises `InjectedServingFault` — the shape of a replica whose
    process died with requests in flight (in-flight work errors, the
    pool fails the request over, the probe loop evicts). `revive()`
    brings the 'process' back so re-admission can be drilled.
    `steps_killed` counts dispatches the crash ate."""

    def __init__(self, crashed: bool = False):
        self.crashed = crashed
        self.steps_killed = 0
        self._lock = threading.Lock()

    def crash(self) -> None:
        self.crashed = True

    def revive(self) -> None:
        self.crashed = False

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "pre_step" and self.crashed:
            with self._lock:
                self.steps_killed += 1
            raise InjectedServingFault(
                "injected replica crash (replica-pool chaos)")


class ReplicaHangInjector:
    """Wedged replica: while `active`, every device step on the wired
    replica BLOCKS (no error, no progress — the failure deadlines
    cannot reach, because the hang is inside the accelerator dispatch).
    Drives the pool's watchdog-eviction and hedging ladders: the probe
    loop's watchdog reads the silence as a hang, and a hedged request
    is won by the healthy replica while this one sits. `release()`
    unblocks every waiter (test teardown MUST call it, or the replica's
    executor thread sleeps forever); `hangs` counts trapped steps."""

    def __init__(self):
        self.active = True
        self.hangs = 0
        self._lock = threading.Lock()
        self._released = threading.Event()

    def release(self) -> None:
        self.active = False
        self._released.set()

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "pre_step" and self.active:
            with self._lock:
                self.hangs += 1
            self._released.wait()


class ReloadCorruptionInjector:
    """Damage a hot-reload candidate on disk before the server loads it.

    Three corruption families, matching how real candidates go bad:

    - `corrupt_payload(path)` — flip bytes mid-payload WITHOUT touching
      the manifest: integrity verification must catch the drift
      (`CheckpointCorruptError`) before any bytes are trusted.
    - `truncate(path)` — cut the payload short (killed copy/download);
      same typed outcome.
    - `poison_params(store, step, net)` — the insidious one: write a
      VALID, manifest-consistent checkpoint whose parameters are all
      NaN. It loads cleanly; only the server's canary validation can
      catch it (`ModelValidationError`).

    `corruptions` counts injected damages."""

    def __init__(self):
        self.corruptions = 0

    def corrupt_payload(self, path) -> Path:
        path = Path(path)
        data = bytearray(path.read_bytes())
        mid = len(data) // 2
        for i in range(mid, min(mid + 16, len(data))):
            data[i] ^= 0xFF
        path.write_bytes(bytes(data))
        self.corruptions += 1
        return path

    def truncate(self, path, keep: int = 100) -> Path:
        path = Path(path)
        path.write_bytes(path.read_bytes()[:keep])
        self.corruptions += 1
        return path

    def poison_params(self, store, step: int, net) -> Path:
        """Commit a manifest-consistent checkpoint of `net` with every
        parameter NaN into `store` at `step` — the candidate that MUST
        be stopped by canary validation, not by integrity checks."""
        from deeplearning4j_tpu_torch.util.serialization import write_model

        # a clone, so the live net is never touched
        clone = net.clone()
        clone.set_params(torch.full_like(clone.params(), float("nan")))
        path = store.save(step,
                          lambda tmp_path: write_model(clone, tmp_path,
                                                       atomic=False))
        self.corruptions += 1
        return path


class JournalCorruptionInjector:
    """Damage an exactly-once request journal on disk
    (`serving/exactly_once.RequestJournal`) between gateway
    incarnations — the disk hazards replay must survive typed, never
    as a double execution or a crash at load:

    - `torn_tail(journal_dir)` — truncate the NEWEST segment mid-way
      through its last record: the shape of `kill -9` landing between
      `write()` and a completed line. Replay must count it
      `torn_skipped` and carry on; the half-written admit is a request
      the client never got an ack for, so dropping it is correct.
    - `corrupt_record(journal_dir, index)` — flip bytes inside a
      COMMITTED record of the OLDEST segment (bit-rot, a bad sector):
      the CRC must refuse it (`corrupt_skipped`), and every other
      record in the segment must still replay.

    `corruptions` counts injected damages."""

    def __init__(self):
        self.corruptions = 0

    @staticmethod
    def _segments(journal_dir) -> list:
        segs = sorted(Path(journal_dir).glob("journal-*.wal"))
        if not segs:
            raise FileNotFoundError(
                f"no journal segments under {journal_dir}")
        return segs

    def torn_tail(self, journal_dir) -> Path:
        """Cut the newest segment's last record in half — a torn write."""
        path = self._segments(journal_dir)[-1]
        data = path.read_bytes()
        lines = data.splitlines(keepends=True)
        if not lines:
            raise ValueError(f"segment {path} is empty — nothing to tear")
        last = lines[-1]
        path.write_bytes(b"".join(lines[:-1]) + last[: max(1, len(last) // 2)])
        self.corruptions += 1
        return path

    def corrupt_record(self, journal_dir, index: int = 0) -> Path:
        """Flip bytes inside committed record `index` of the oldest
        segment WITHOUT touching its length — the CRC, not the line
        framing, must catch this one."""
        path = self._segments(journal_dir)[0]
        lines = path.read_bytes().splitlines(keepends=True)
        if not 0 <= index < len(lines):
            raise IndexError(f"record {index} not in {path} "
                             f"({len(lines)} records)")
        rec = bytearray(lines[index])
        # flip payload bytes mid-line; keep the trailing newline intact
        mid = len(rec) // 2
        for i in range(mid, min(mid + 8, len(rec) - 1)):
            rec[i] ^= 0x5A
        lines[index] = bytes(rec)
        path.write_bytes(b"".join(lines))
        self.corruptions += 1
        return path


class KVTransferCorruptionInjector:
    """Damage a KV handoff payload between `fetch_handoff` and
    `resume_generate` — the wire hazards a migrated slot must survive
    typed (`KVTransferError` → re-prefill fallback), never as wrong
    tokens.

    Three corruption families, matching how real transfers go bad:

    - `flip_page(payload)` — XOR bytes inside one shipped KV page
      (bit-rot / a bad NIC): the per-page checksum must refuse it.
    - `truncate(payload)` — drop the tail pages of every block (a
      transfer killed mid-flight): the span/shape validation must
      refuse it.
    - `expire_lease(server, handoff_id)` — resolve the lease out from
      under the receiver (the TTL sweep racing a slow resume): the
      NEXT fetch must answer the typed unknown-lease error.

    Every method works on a COPY of the payload dicts it mutates, so
    the sender's leased original stays intact — exactly like a wire
    that corrupts in transit without touching the source buffers.
    `corruptions` counts injected damages."""

    def __init__(self):
        self.corruptions = 0

    @staticmethod
    def _copy(payload: dict) -> dict:
        out = dict(payload)
        out["blocks"] = [dict(b) for b in payload.get("blocks", [])]
        return out

    def flip_page(self, payload: dict, block: int = 0,
                  tensor: str = "k", page: int = 0) -> dict:
        """One shipped page's bytes flipped; checksums untouched."""
        out = self._copy(payload)
        arr = np.array(out["blocks"][block][tensor])  # private copy
        flat = arr.view(np.uint8).reshape(-1)
        flat[: min(16, flat.size)] ^= 0xFF
        out["blocks"][block][tensor] = arr
        self.corruptions += 1
        return out

    def truncate(self, payload: dict, keep: int = 0) -> dict:
        """Every block's page arrays cut to `keep` pages — but
        `pages_shipped` still claims the original count, like a frame
        that stopped arriving mid-transfer."""
        out = self._copy(payload)
        for blk in out["blocks"]:
            for name, arr in blk.items():
                blk[name] = np.array(arr[:keep])
        self.corruptions += 1
        return out

    def expire_lease(self, server, handoff_id: str) -> None:
        """Kill the lease mid-flight (the receiver already fetched; the
        sender reclaims as if the TTL swept it)."""
        server.abort_handoff(handoff_id)
        self.corruptions += 1


class PrefixFetchSaboteur:
    """Wire hazards on the cluster-prefix fetch path: wraps a holder
    server (the `peers` resolver hands the fetching engine THIS object
    instead) and damages the framed transfer in one of three ways a
    real deployment produces. The contract under every mode is the
    same — the fetching engine degrades to cold prefill with ZERO
    failed requests, counting `prefix_fetch_fallbacks`, never binding
    damaged pages.

    - ``mode="corrupt-frame"`` — one frame's page bytes flipped in
      transit: the reassembled payload's per-page checksum refuses it.
    - ``mode="die-after-header"`` — the holder vanishes between the
      header and the first frame (kill -9 mid-fetch): the fetcher sees
      a raw `ConnectionError`.
    - ``mode="stale-version"`` — the header claims a `weight_version`
      the holder no longer serves (a rolling reload landed between
      directory lookup and fetch): `verify_payload` refuses the skew.

    `sabotages` counts injected damages."""

    def __init__(self, holder, mode: str = "corrupt-frame"):
        if mode not in ("corrupt-frame", "die-after-header",
                        "stale-version"):
            raise ValueError(f"unknown sabotage mode {mode!r}")
        self._holder = holder
        self.mode = mode
        self.sabotages = 0

    def __getattr__(self, name):
        return getattr(self._holder, name)

    def export_prefix(self, *a, **kw) -> dict:
        header = self._holder.export_prefix(*a, **kw)
        if self.mode == "stale-version":
            header = dict(header)
            header["weight_version"] = "stale-" * 2 + "deadbeef"
            self.sabotages += 1
        return header

    def fetch_handoff_frame(self, handoff_id: str, frame: int,
                            **kw) -> dict:
        if self.mode == "die-after-header":
            self.sabotages += 1
            raise ConnectionResetError(
                "injected: holder died between header and frame 0")
        out = self._holder.fetch_handoff_frame(handoff_id, frame, **kw)
        if self.mode == "corrupt-frame" and frame == 0:
            out = dict(out)
            out["blocks"] = [dict(b) for b in out["blocks"]]
            blk = out["blocks"][0]
            name = next(iter(blk))
            arr = np.array(blk[name])
            flat = arr.view(np.uint8).reshape(-1)
            flat[: min(16, flat.size)] ^= 0xFF
            blk[name] = arr
            self.sabotages += 1
        return out


class TenantFloodInjector:
    """One tenant floods the serving tier with batch-priority generate
    traffic — the multi-tenant isolation drill. `concurrency` threads
    hammer `target.generate(...)` under the flooding tenant's identity
    until `release()`; per-outcome counters record what the flooder got
    back. The QoS contract under drill: the flooder's rejections are its
    OWN `TenantQuotaExceededError` (with retry_after), never anyone
    else's `ServerOverloadedError`, and other tenants' interactive p99
    stays within 2x unloaded. `target` is anything with the generate
    signature (DecodeEngine, ModelServer, ReplicaPool, RemoteReplica)."""

    def __init__(self, target, tenant: str = "flooder",
                 prompt=None, n_tokens: int = 8,
                 concurrency: int = 4, timeout: float = 5.0):
        self.target = target
        self.tenant = tenant
        self.prompt = (np.arange(8, dtype=np.int32)
                       if prompt is None else np.asarray(prompt, np.int32))
        self.n_tokens = int(n_tokens)
        self.concurrency = int(concurrency)
        self.timeout = float(timeout)
        self.active = True
        self.served = 0           # guarded by: _lock
        self.quota_rejections = 0  # guarded by: _lock
        self.sheds = 0            # guarded by: _lock
        self.other_errors = 0     # guarded by: _lock
        self._lock = threading.Lock()
        self._threads: list = []

    def start(self) -> "TenantFloodInjector":
        for i in range(self.concurrency):
            t = threading.Thread(target=self._flood,
                                 name=f"tenant-flood-{self.tenant}-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _flood(self) -> None:
        from deeplearning4j_tpu_torch.serving.model_server import ServingError, TenantQuotaExceededError

        while self.active:
            try:
                self.target.generate(self.prompt, self.n_tokens,
                                     timeout=self.timeout,
                                     tenant=self.tenant, priority="batch")
                with self._lock:
                    self.served += 1
            except TenantQuotaExceededError as err:
                with self._lock:
                    self.quota_rejections += 1
                # back off as told — a well-behaved flooder; the drill
                # for a non-compliant one just shrinks this sleep
                time.sleep(min(getattr(err, "retry_after", 0.01) or 0.01,
                               0.05))
            except ServingError:
                with self._lock:
                    self.sheds += 1
            # deliberate: a chaos load generator
            # counts whatever the target throws; killing the flood
            # thread on a surprise would end the drill early
            except Exception:
                with self._lock:
                    self.other_errors += 1

    def release(self) -> None:
        self.active = False
        for t in self._threads:
            t.join(timeout=self.timeout + 5.0)
        self._threads = []

    def counters(self) -> dict:
        with self._lock:
            return {"served": self.served,
                    "quota_rejections": self.quota_rejections,
                    "sheds": self.sheds,
                    "other_errors": self.other_errors}


class LoadSpikeInjector:
    """A sudden sustained jump in interactive arrivals — the autoscale
    drill's stimulus. `concurrency` closed-loop threads submit
    interactive generate traffic under distinct tenants until
    `release()`, recording each request's latency so the drill can
    check p99 against the unloaded baseline while the autoscaler reacts
    (scale-up on pressure, scale-down after the spike, zero failed
    requests through both transitions)."""

    def __init__(self, target, prompt=None, n_tokens: int = 8,
                 concurrency: int = 8, tenant: str = "spike",
                 timeout: float = 10.0):
        self.target = target
        self.prompt = (np.arange(8, dtype=np.int32)
                       if prompt is None else np.asarray(prompt, np.int32))
        self.n_tokens = int(n_tokens)
        self.concurrency = int(concurrency)
        self.tenant = tenant
        self.timeout = float(timeout)
        self.active = True
        self.served = 0       # guarded by: _lock
        self.failures = 0     # guarded by: _lock
        self.sheds = 0        # guarded by: _lock
        self.latencies: list = []  # guarded by: _lock
        self._lock = threading.Lock()
        self._threads: list = []

    def start(self) -> "LoadSpikeInjector":
        for i in range(self.concurrency):
            t = threading.Thread(target=self._drive, args=(i,),
                                 name=f"load-spike-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _drive(self, i: int) -> None:
        from deeplearning4j_tpu_torch.serving.model_server import ServerOverloadedError, ServingError

        while self.active:
            t0 = time.monotonic()
            try:
                self.target.generate(self.prompt, self.n_tokens,
                                     timeout=self.timeout,
                                     tenant=f"{self.tenant}-{i}",
                                     priority="interactive")
                with self._lock:
                    self.served += 1
                    self.latencies.append(time.monotonic() - t0)
            except ServerOverloadedError as err:
                with self._lock:
                    self.sheds += 1
                time.sleep(min(getattr(err, "retry_after", 0.01) or 0.01,
                               0.05))
            except ServingError:
                with self._lock:
                    self.failures += 1
            # deliberate: the spike must
            # keep driving through any surprise — an uncounted crash of
            # a load thread would silently thin the load
            except Exception:
                with self._lock:
                    self.failures += 1

    def release(self) -> None:
        self.active = False
        for t in self._threads:
            t.join(timeout=self.timeout + 5.0)
        self._threads = []

    def p99(self) -> float:
        with self._lock:
            lats = sorted(self.latencies)
        if not lats:
            return 0.0
        return lats[min(len(lats) - 1, int(0.99 * len(lats)))]

    def counters(self) -> dict:
        with self._lock:
            return {"served": self.served, "failures": self.failures,
                    "sheds": self.sheds, "n_latencies": len(self.latencies)}


# -- network chaos (cross-process replica pool) ---------------------------

class ChaosProxy:
    """Network-fault man-in-the-middle for ONE gateway endpoint: point
    a `RemoteReplica` at `proxy.port` instead of the replica's real
    port and every wire hazard becomes injectable without touching the
    replica process. Modes (exactly one active; `heal()` returns to
    clean forwarding):

    - ``forward``   — transparent TCP relay (the healthy baseline)
    - ``partition`` — existing connections are RESET (SO_LINGER 0) and
      new ones reset right after accept: the filtered-network shape a
      pool must answer with eviction, then re-admission after `heal()`
    - ``latency``   — each response chunk is delayed `delay` seconds
      before forwarding (slow network, alive replica)
    - ``slowloris`` — responses dribble one byte per `interval`: the
      connection is alive but the response never completes inside any
      reasonable deadline
    - ``garbage``   — responses are replaced with bytes that do not
      parse as a gateway response line (protocol corruption)
    - ``reset``     — the connection is RESET the moment a response
      chunk arrives: death mid-response, the ambiguous failure retries
      must respect

    The proxy accepts on an ephemeral port (`.port`) at construction;
    `close()` tears everything down. Thread-safe."""

    _MODES = frozenset({"forward", "partition", "latency", "slowloris",
                        "garbage", "reset"})
    GARBAGE_LINE = b"!!chaos-garbage-not-a-gateway-response!!\n"

    def __init__(self, upstream_host: str, upstream_port: int,
                 listen_host: str = "127.0.0.1"):
        self._upstream = (upstream_host, upstream_port)
        self._mode = "forward"  # guarded by: _lock
        self._delay = 0.0
        self._interval = 0.05
        self._lock = threading.Lock()
        self._conns: list = []  # guarded by: _lock
        self._closed = False  # guarded by: _lock
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, 0))
        self._listener.listen(64)
        self.host = listen_host
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"chaos-proxy-{self.port}").start()

    # -- mode control ------------------------------------------------------
    def _set_mode(self, mode: str) -> None:
        if mode not in self._MODES:
            raise ValueError(f"unknown chaos mode {mode!r}")
        with self._lock:
            self._mode = mode

    def heal(self) -> None:
        self._set_mode("forward")

    def partition(self) -> None:
        """Cut the replica off: reset every live connection and every
        future one until `heal()`."""
        self._set_mode("partition")
        with self._lock:
            conns, self._conns = self._conns, []
        for s in conns:
            self._reset_close(s)

    def inject_latency(self, delay: float) -> None:
        self._delay = float(delay)
        self._set_mode("latency")

    def inject_slowloris(self, interval: float = 0.05) -> None:
        self._interval = float(interval)
        self._set_mode("slowloris")

    def inject_garbage(self) -> None:
        self._set_mode("garbage")

    def inject_reset(self) -> None:
        self._set_mode("reset")

    # -- plumbing ----------------------------------------------------------
    @staticmethod
    def _reset_close(sock) -> None:
        """Close with SO_LINGER 0 — the peer sees RST, not FIN: real
        partition/crash behavior, not a polite shutdown."""
        with contextlib.suppress(OSError):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
        with contextlib.suppress(OSError):
            sock.close()

    def _accept_loop(self) -> None:
        # the suppress ends this loop when close() shuts the listener
        with contextlib.suppress(OSError):
            while True:
                client, _ = self._listener.accept()
                threading.Thread(target=self._open_link, args=(client,),
                                 daemon=True).start()

    def _open_link(self, client) -> None:
        with self._lock:
            refuse = self._closed or self._mode == "partition"
        if refuse:
            self._reset_close(client)
            return
        try:
            upstream = socket.create_connection(self._upstream,
                                                timeout=10.0)
        except OSError as e:
            logger.info("chaos proxy: upstream %s:%d unreachable (%s)",
                        self._upstream[0], self._upstream[1],
                        type(e).__name__)
            self._reset_close(client)
            return
        with self._lock:
            if self._closed:
                self._reset_close(client)
                self._reset_close(upstream)
                return
            self._conns += [client, upstream]
        threading.Thread(target=self._pump, args=(client, upstream, False),
                         daemon=True).start()
        threading.Thread(target=self._pump, args=(upstream, client, True),
                         daemon=True).start()

    # pump recv poll tick: a linger-0 close from the sibling pump (or
    # partition()/close()) cannot tear the kernel socket down — and so
    # cannot emit its RST — while this thread is parked inside recv()
    # on the same fd; the syscall holds the last reference.  Bounded
    # recv waits mean a closed socket is noticed within one tick, the
    # reference drops, and the deferred RST actually reaches the peer.
    _PUMP_POLL = 0.25

    def _pump(self, src, dst, response_path: bool) -> None:
        # OSErrors end the link (either side vanishing is normal here)
        with contextlib.suppress(OSError):
            src.settimeout(self._PUMP_POLL)
            while True:
                try:
                    data = src.recv(65536)
                # idle poll tick, not a failure: re-enter recv so a concurrently closed socket raises and ends the link
                except TimeoutError:
                    continue
                if not data:
                    break
                mode = self._mode
                if mode == "partition":
                    break
                if response_path and mode == "latency":
                    time.sleep(self._delay)
                elif response_path and mode == "slowloris":
                    for i in range(len(data)):
                        if self._mode != "slowloris":
                            dst.sendall(data[i:])
                            break
                        time.sleep(self._interval)
                        dst.sendall(data[i:i + 1])
                    continue
                elif response_path and mode == "garbage":
                    dst.sendall(self.GARBAGE_LINE)
                    continue
                elif response_path and mode == "reset":
                    self._reset_close(dst)
                    self._reset_close(src)
                    break
                dst.sendall(data)
        self._reset_close(src)
        self._reset_close(dst)
        with self._lock:
            for s in (src, dst):
                if s in self._conns:
                    self._conns.remove(s)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns, self._conns = self._conns, []
        with contextlib.suppress(OSError):
            self._listener.close()
        for s in conns:
            self._reset_close(s)


class PartitionInjector:
    """Network partition of one replica: every connection through the
    proxy is reset until `heal()` — the pool must evict on failed
    probes and re-admit after `readmit_successes` passes post-heal.
    `partitions` counts injections."""

    def __init__(self, proxy: ChaosProxy):
        self.proxy = proxy
        self.partitions = 0

    def partition(self) -> None:
        self.partitions += 1
        self.proxy.partition()

    def heal(self) -> None:
        self.proxy.heal()


class NetworkLatencyInjector:
    """Slow network to one replica: responses arrive `delay` seconds
    late. Below the caller deadline this is a tail-latency drill
    (hedging); above it, a deadline drill. `release()` restores clean
    forwarding."""

    def __init__(self, proxy: ChaosProxy, delay: float = 0.2):
        self.proxy = proxy
        self.delay = delay

    def inject(self) -> None:
        self.proxy.inject_latency(self.delay)

    def release(self) -> None:
        self.proxy.heal()


class SlowLorisInjector:
    """Byte-at-a-time responses: the connection looks alive while the
    response never completes inside any reasonable deadline — the
    drill proving read deadlines (not liveness checks) bound a call."""

    def __init__(self, proxy: ChaosProxy, interval: float = 0.05):
        self.proxy = proxy
        self.interval = interval

    def inject(self) -> None:
        self.proxy.inject_slowloris(self.interval)

    def release(self) -> None:
        self.proxy.heal()


class GarbageResponseInjector:
    """Protocol corruption: responses are replaced with bytes that do
    not parse as a gateway response line. The client must answer with
    the typed protocol error (mapped to retryable sickness), never a
    hang or an unhandled decode crash."""

    def __init__(self, proxy: ChaosProxy):
        self.proxy = proxy

    def inject(self) -> None:
        self.proxy.inject_garbage()

    def release(self) -> None:
        self.proxy.heal()


class ConnectionResetInjector:
    """Death mid-response: the connection is RESET the moment response
    bytes arrive — the ambiguous failure (did the side effect land?)
    that only idempotent calls may retry."""

    def __init__(self, proxy: ChaosProxy):
        self.proxy = proxy

    def inject(self) -> None:
        self.proxy.inject_reset()

    def release(self) -> None:
        self.proxy.heal()


class SlowConsumerInjector:
    """A streaming consumer that reads `read_frames` frames and then
    stops draining — the slow-consumer drill for `generate_stream`.

    The contract under drill: the decode slot keeps emitting at full
    speed (a stalled socket must never block the scheduler loop or
    other requests), the gateway pump sheds THIS consumer once a frame
    write stalls past `stream_send_timeout`, and the consumer's
    recovery ladder is typed the whole way down — ring replay on
    reconnect while the cursor is retained, `StreamBackpressureError`
    + parked-outcome `claim` once it fell out. `run()` executes one
    stalled consumption end to end and returns the outcome record;
    counters aggregate across runs. `client` is a `GatewayClient`
    against a server with streaming enabled."""

    def __init__(self, client, name: str, prompt=None,
                 n_tokens: int = 8, read_frames: int = 1,
                 stall: float = 1.0, **gen_kw):
        self.client = client
        self.name = name
        self.prompt = (np.arange(8, dtype=np.int32)
                       if prompt is None else np.asarray(prompt, np.int32))
        self.n_tokens = int(n_tokens)
        self.read_frames = int(read_frames)
        self.stall = float(stall)
        self.gen_kw = gen_kw
        self.runs = 0             # guarded by: _lock
        self.stalls = 0           # guarded by: _lock
        self.completions = 0      # guarded by: _lock
        self.backpressure_errors = 0  # guarded by: _lock
        self.other_errors = 0     # guarded by: _lock
        self._lock = threading.Lock()

    def run(self) -> dict:
        from deeplearning4j_tpu_torch.gateway import GatewayError

        with self._lock:
            self.runs += 1
        stream = self.client.generate_stream(
            self.name, self.prompt, self.n_tokens, **self.gen_kw)
        frames = 0
        outcome = {"error_type": None}
        try:
            for _ in stream:
                frames += 1
                if frames == self.read_frames and self.stall > 0:
                    with self._lock:
                        self.stalls += 1
                    # the stall: the socket stays open but nothing
                    # drains — the server-side pump, not the decode
                    # slot, must absorb this
                    time.sleep(self.stall)
            with self._lock:
                self.completions += 1
        except GatewayError as err:
            outcome["error_type"] = err.error_type
            with self._lock:
                if err.error_type == "StreamBackpressureError":
                    self.backpressure_errors += 1
                else:
                    self.other_errors += 1
        finally:
            stream.close()
        outcome.update(frames=frames, resumes=stream.resumes,
                       tokens=list(stream.tokens),
                       request_id=stream.request_id)
        return outcome

    def counters(self) -> dict:
        with self._lock:
            return {"runs": self.runs, "stalls": self.stalls,
                    "completions": self.completions,
                    "backpressure_errors": self.backpressure_errors,
                    "other_errors": self.other_errors}
