"""Serving-tier observability: request tracing, metrics registry and
flight recorder for the `ModelServer` -> `DecodeEngine` stack
(counterpart of `deeplearning4j_tpu/serving/observability.py`, pure
Python, copied so the port imports nothing of the JAX package).

- **Request tracing** (`Trace`/`Span`): a ``trace_id`` minted at the
  first serving layer a request enters (or joined from an upstream
  layer through the thread-local `use_trace`/`current_trace`), with
  typed spans (queue-wait, admission, prefix-bind, prefill chunks,
  decode, device steps) on `time.monotonic()` timestamps and the
  decision that ended them (``served`` / a typed-error class name).
  The request object carries the trace across the executor and
  scheduler thread hops; every `ServingError` carries its timeline
  (`attach_trace`).
- **Metrics registry** (`MetricsRegistry`): counters, gauges (bindable
  to a callable) and fixed-bucket histograms, plus `register_stats`
  adapters that pull the components' ``stats()`` dicts into one
  `snapshot()` and a Prometheus-style `exposition()` text. Metric names
  and the ``dl4j`` namespace are the JAX package's, so a scraper reads
  the same text from either package.
- **Flight recorder** (`FlightRecorder`): bounded rings of completed
  request timelines, of timelines that ended in a typed failure (a burst
  of successes cannot push a postmortem out), and of scheduler events
  (admissions, retirements, breaker transitions, reloads, swaps).

Every recording call is host-side arithmetic on host values: nothing
here may receive a device tensor, whose formatting would wait for the
device. ``DL4J_TPU_NO_TRACING=1`` turns host recording off (spans become
no-ops on the shared `NULL_TRACE`, the recorder drops writes); it
switches no kernel. With ``DL4J_TPU_XLA_SPAN_ANNOTATIONS=1`` (the JAX
package's name for the switch), `Trace.span` and `annotation` also name
the phase as ``serve:<name>`` in a `torch.profiler` capture through
`torch.profiler.record_function`.
"""
from __future__ import annotations

import os
import threading
import time
from bisect import bisect_right
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "Counter", "FlightRecorder", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TRACE", "Span", "Trace", "attach_trace", "current_trace",
    "graft_remote_trace", "maybe_trace", "new_trace_id", "tracing_enabled",
    "use_trace", "wire_trace_context",
]

_KILL_ENV = "DL4J_TPU_NO_TRACING"
_XLA_ANNOTATE_ENV = "DL4J_TPU_XLA_SPAN_ANNOTATIONS"


def tracing_enabled() -> bool:
    """The kill switch: ``DL4J_TPU_NO_TRACING=1`` turns every trace
    into `NULL_TRACE` and every recorder write into a no-op — the
    baseline side of the in-bench ``tracing_overhead_pct`` A/B."""
    return os.environ.get(_KILL_ENV, "") not in ("1", "true", "yes")


def _xla_annotations_enabled() -> bool:
    return os.environ.get(_XLA_ANNOTATE_ENV, "") in ("1", "true", "yes")


def _record_function(name: str):
    import torch

    return torch.profiler.record_function(f"serve:{name}")


def annotation(name: str):
    """A ``serve:<name>`` `torch.profiler.record_function` context when
    ``DL4J_TPU_XLA_SPAN_ANNOTATIONS=1``, else a free no-op — lets
    serving internals name themselves in a `torch.profiler` capture
    without paying for the context manager when no one is looking."""
    if _xla_annotations_enabled():
        return _record_function(name)
    return _NullContext()


def new_trace_id() -> str:
    return os.urandom(8).hex()


# -- spans / traces --------------------------------------------------------

class Span:
    """One typed interval on a request timeline. ``decision`` is how it
    ended: None (still open / informational event), ``"ok"``, or the
    layer's verdict (``"served"``, a typed-error class name,
    ``"evicted"``, ``"rolled-back"``)."""

    __slots__ = ("name", "t0", "t1", "decision", "attrs")

    def __init__(self, name: str, t0: float, t1: Optional[float] = None,
                 decision: Optional[str] = None,
                 attrs: Optional[dict] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.decision = decision
        self.attrs = attrs

    def to_dict(self) -> dict:
        d = {"name": self.name, "t0": self.t0,
             "t1": self.t1 if self.t1 is not None else self.t0}
        if self.decision is not None:
            d["decision"] = self.decision
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class Trace:
    """A request's causal timeline: a ``trace_id`` plus a bounded,
    thread-safe list of `Span`s (monotonic-clock timestamps — compare
    within a process, not across hosts). Spans are appended from
    several threads (gateway handler, pool hedges, server executor,
    engine scheduler); `to_dict` orders them by start time, which is
    causal order for the single request they all describe."""

    MAX_SPANS = 512

    __slots__ = ("trace_id", "decision", "_spans", "_lock", "_dropped",
                 "created_at", "created_mono")

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self.decision: Optional[str] = None
        # the trace's WALL-CLOCK ANCHOR: the same instant read on both
        # clocks. Span timestamps stay monotonic (immune to NTP steps),
        # and the (mono, wall) pair lets another process convert them —
        # remote spans are grafted into a local timeline by going
        # remote-monotonic → wall → local-monotonic through the two
        # anchors (`graft_remote_trace`)
        self.created_at = time.time()
        self.created_mono = time.monotonic()
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._dropped = 0

    def _append(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) >= self.MAX_SPANS:
                self._dropped += 1
                return
            self._spans.append(span)

    @contextmanager
    def span(self, name: str, **attrs):
        """Record ``name`` over the with-block. An escaping exception
        stamps the span's decision with the exception class name and
        re-raises; otherwise the decision is ``"ok"`` (callers may
        overwrite via the yielded span). With
        ``DL4J_TPU_XLA_SPAN_ANNOTATIONS=1`` the block is also wrapped
        in `torch.profiler.record_function`, naming the phase in any
        active `torch.profiler` capture."""
        sp = Span(name, time.monotonic(), attrs=attrs or None)
        self._append(sp)
        try:
            if _xla_annotations_enabled():
                with _record_function(name):
                    yield sp
            else:
                yield sp
        except BaseException as e:
            sp.t1 = time.monotonic()
            sp.decision = type(e).__name__
            raise
        sp.t1 = time.monotonic()
        if sp.decision is None:
            sp.decision = "ok"

    def event(self, name: str, **attrs) -> None:
        """A point-in-time mark (zero-width span)."""
        self._append(Span(name, time.monotonic(), attrs=attrs or None))

    def add_timed(self, name: str, t0: float, t1: float,
                  decision: Optional[str] = None, **attrs) -> None:
        """Record an interval measured by the caller (e.g. queue-wait
        from a request's ``enqueued_at`` to its admission)."""
        self._append(Span(name, t0, t1, decision, attrs or None))

    def finish(self, decision: str) -> None:
        self.decision = decision

    def to_dict(self) -> dict:
        with self._lock:
            spans = sorted(self._spans, key=lambda s: s.t0)
            out = {"trace_id": self.trace_id,
                   "anchor": {"mono": self.created_mono,
                              "wall": self.created_at},
                   "spans": [s.to_dict() for s in spans]}
            if self.decision is not None:
                out["decision"] = self.decision
            if self._dropped:
                out["dropped_spans"] = self._dropped
            return out

    def __bool__(self) -> bool:
        return True


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _NullTrace:
    """Shared no-op trace returned by `maybe_trace` when the kill
    switch is set — callers record unconditionally and pay one falsy
    method call instead of branching everywhere."""

    __slots__ = ()
    trace_id = None
    decision = None
    _null_ctx = _NullContext()

    def span(self, name, **attrs):
        return self._null_ctx

    def event(self, name, **attrs):
        pass

    def add_timed(self, name, t0, t1, decision=None, **attrs):
        pass

    def finish(self, decision):
        pass

    def to_dict(self):
        return None

    def __bool__(self):
        return False


NULL_TRACE = _NullTrace()

_tls = threading.local()


def current_trace() -> Optional[Trace]:
    """The trace bound to this thread by `use_trace` (None outside)."""
    return getattr(_tls, "trace", None)


@contextmanager
def use_trace(trace):
    """Bind `trace` to the current thread so downstream layers on the
    same synchronous call chain (`maybe_trace`) join it instead of
    minting their own — how the gateway's trace_id reaches the engine
    without threading a parameter through every signature."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    try:
        yield trace
    finally:
        _tls.trace = prev


def maybe_trace(trace=None):
    """Resolve the trace for a request entering a serving layer: an
    explicit one wins, else the thread-local one (an upstream layer's),
    else mint a fresh `Trace` — or `NULL_TRACE` when kill-switched."""
    t = trace if trace is not None else current_trace()
    if t is not None:
        return t
    return Trace() if tracing_enabled() else NULL_TRACE


def attach_trace(err: BaseException, trace) -> None:
    """Stamp ``trace_id`` and the serialized timeline onto a
    `ServingError` (best-effort — same idiom as the pool's replica_id
    tagging) so in-process callers and the gateway error payload both
    carry the timeline. A batch-shared exception instance can be
    stamped by several waiter threads; last writer wins, and each
    writer's timeline names the same batch, so any of them serves the
    postmortem."""
    if not trace:
        return
    try:
        err.trace_id = trace.trace_id
        err.trace = trace.to_dict()
    # best-effort attachment: a slotted or exotic exception type that
    # rejects new attributes must not turn error delivery itself into a
    # second failure
    except Exception:
        pass


# -- cross-process trace propagation ---------------------------------------

def wire_trace_context(trace) -> Optional[dict]:
    """The trace context a gateway client sends alongside a request so
    the remote server JOINS the caller's trace instead of minting its
    own: the trace_id plus the LOCAL wall-clock anchor (informational —
    the remote side answers with its own anchor, which is what the
    caller grafts by). None for no/null traces: the request travels
    context-free and the remote side keeps its historical minting."""
    if not trace or getattr(trace, "trace_id", None) is None:
        return None
    ctx = {"trace_id": trace.trace_id}
    mono = getattr(trace, "created_mono", None)
    wall = getattr(trace, "created_at", None)
    if mono is not None and wall is not None:
        ctx["anchor"] = {"mono": mono, "wall": wall}
    return ctx


def graft_remote_trace(trace, remote: Optional[dict], **attrs) -> int:
    """Splice a REMOTE process's serialized trace (`Trace.to_dict()`
    shipped over the gateway wire) into the local `trace` as spans on
    the local monotonic clock, so a cross-process request still reads
    as ONE causally-ordered timeline in the flight recorder.

    Clock conversion rides the wall-clock anchors both traces carry:
    ``local_t = remote_t + ((r_wall - r_mono) - (l_wall - l_mono))`` —
    remote-monotonic → shared wall time → local-monotonic. Accurate to
    the hosts' wall-clock skew (NTP-level; fine for ms-scale serving
    spans — docs/observability.md states the caveat). Every grafted
    span carries ``remote=True`` plus caller `attrs` (e.g. the replica
    endpoint), and the remote decision lands as a zero-width
    ``remote-decision`` event. Returns the number of spans grafted;
    anchorless remote payloads graft 0 spans but still record one
    ``remote-trace`` marker naming the remote trace_id."""
    if not trace or not isinstance(remote, dict):
        return 0
    r_anchor = remote.get("anchor") or {}
    l_mono = getattr(trace, "created_mono", None)
    l_wall = getattr(trace, "created_at", None)
    r_mono, r_wall = r_anchor.get("mono"), r_anchor.get("wall")
    if None in (l_mono, l_wall, r_mono, r_wall):
        trace.event("remote-trace", remote_trace_id=remote.get("trace_id"),
                    anchorless=True, **attrs)
        return 0
    offset = (r_wall - r_mono) - (l_wall - l_mono)
    grafted = 0
    for sp in remote.get("spans", ()):
        if not isinstance(sp, dict) or "t0" not in sp:
            continue
        sp_attrs = dict(sp.get("attrs") or {})
        sp_attrs.update(attrs)
        sp_attrs["remote"] = True
        trace.add_timed(sp.get("name", "remote"),
                        sp["t0"] + offset,
                        sp.get("t1", sp["t0"]) + offset,
                        sp.get("decision"), **sp_attrs)
        grafted += 1
    decision = remote.get("decision")
    if decision is not None:
        trace.event("remote-decision", decision=decision,
                    remote_trace_id=remote.get("trace_id"), **attrs)
    return grafted


# -- metrics registry ------------------------------------------------------

class Counter:
    """Monotonic counter. One uncontended lock per `inc` — cheap
    against the ~ms-scale operations it counts."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v


class Gauge:
    """Point-in-time value: either `set()` by the owner or bound to a
    zero-argument callable sampled at snapshot time (how queue depth /
    pages-in-use track the live scheduler state without a write on
    every transition)."""

    __slots__ = ("name", "_v", "_fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self._v = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        self._v = v

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            # a gauge reads live component state that may be
            # mid-teardown; a scrape must report None, never propagate
            # the component's failure
            except Exception:
                return None
        return self._v


#: upper bounds (ms) for latency histograms — bounded cardinality by
#: construction, wide enough for queue-wait through whole-generate.
DEFAULT_LATENCY_BUCKETS_MS = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


class Histogram:
    """Fixed-bucket histogram (`buckets` are inclusive upper bounds;
    one implicit +Inf bucket). `observe` is a bisect plus two adds
    under an uncontended lock.

    **p99-excursion auto-dump** (`enable_excursion`): an observation
    landing past the histogram's own live `quantile` bound fires the
    configured hook OUTSIDE the lock with ``(value, bound, trace)`` —
    the engine wires this to `FlightRecorder.pin`, so the excursion
    request's full timeline lands in the failures ring the moment the
    tail event happens, instead of being reconstructed from counters
    after the fact. The bound is computed from the bucket counts
    BEFORE the new observation (an excursion cannot raise the bar it
    is judged against) and only once `min_count` observations exist
    (a cold histogram's 'p99' is noise)."""

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum", "_lock",
                 "_exc_quantile", "_exc_min_count", "_exc_hook")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS):
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()
        self._exc_quantile = 0.99
        self._exc_min_count = 50
        self._exc_hook: Optional[Callable] = None

    def enable_excursion(self, quantile: float = 0.99,
                         min_count: int = 50,
                         hook: Optional[Callable] = None) -> None:
        """Arm the excursion hook: observations past the live
        `quantile` bound (once `min_count` observations exist) call
        ``hook(value, bound, trace)`` outside the histogram lock."""
        if not 0.0 < quantile < 1.0:
            raise ValueError("excursion quantile must be in (0, 1)")
        if min_count < 1:
            raise ValueError("excursion min_count must be >= 1")
        self._exc_quantile = float(quantile)
        self._exc_min_count = int(min_count)
        self._exc_hook = hook

    def _quantile_bound_locked(self, q: float) -> Optional[float]:
        """Smallest bucket upper bound covering quantile `q` of the
        recorded observations — None when the quantile falls in the
        implicit +Inf bucket (no finite bar to judge against)."""
        if not self._count:
            return None
        target = q * self._count
        cum = 0
        for bound, cnt in zip(self.buckets, self._counts):
            cum += cnt
            if cum >= target:
                return bound
        return None

    def quantile_bound(self, q: float) -> Optional[float]:
        """Public read of the live bucket-quantile bound (telemetry,
        tests, the bench's excursion line)."""
        with self._lock:
            return self._quantile_bound_locked(q)

    def observe(self, v: float, trace=None) -> None:
        i = bisect_right(self.buckets, v)
        fire_bound = None
        with self._lock:
            if self._exc_hook is not None \
                    and self._count >= self._exc_min_count:
                bound = self._quantile_bound_locked(self._exc_quantile)
                if bound is not None and v > bound:
                    fire_bound = bound
            self._counts[i] += 1
            self._count += 1
            self._sum += v
        if fire_bound is not None:
            # outside the lock: the hook appends to recorder rings and
            # must not serialize every concurrent observe behind it
            self._exc_hook(v, fire_bound, trace)

    def snapshot(self) -> dict:
        with self._lock:
            return {"buckets": list(self.buckets),
                    "counts": list(self._counts),
                    "count": self._count,
                    "sum": round(self._sum, 3)}


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _flatten_numeric(prefix: str, obj, out: List) -> None:
    if isinstance(obj, bool):
        out.append((prefix, int(obj)))
    elif isinstance(obj, (int, float)):
        out.append((prefix, obj))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten_numeric(f"{prefix}_{_sanitize(str(k))}", v, out)
    # strings / lists / None are identity or timeline data, not metrics


class MetricsRegistry:
    """Named counters/gauges/histograms plus ``stats()`` adapters.

    `snapshot()` is the one structured view — first-class instruments
    under ``counters``/``gauges``/``histograms`` and every registered
    component's ad-hoc ``stats()`` dict under ``components``.
    `exposition()` renders the same data as Prometheus text; numeric
    leaves of component stats become gauges with underscore-joined
    paths, so today's counters are scrapeable without re-plumbing each
    one as a first-class instrument."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._stats_fns: Dict[str, Callable[[], dict]] = {}

    # get-or-create: layers can share one registry without coordinating
    # construction order
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, fn)
            elif fn is not None:
                g._fn = fn
            return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, buckets)
            return h

    def register_stats(self, name: str, fn: Callable[[], dict]) -> None:
        """Adopt a component's existing ``stats()`` provider under
        ``components[name]`` in the snapshot."""
        with self._lock:
            self._stats_fns[name] = fn

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
            stats_fns = dict(self._stats_fns)
        components = {}
        for name, fn in stats_fns.items():
            try:
                components[name] = fn()
            # a dying component must not take the whole metrics
            # snapshot down; its slot names the failure instead
            except Exception as e:
                components[name] = {"error": type(e).__name__}
        return {
            "counters": {n: c.value for n, c in counters.items()},
            "gauges": {n: g.value for n, g in gauges.items()},
            "histograms": {n: h.snapshot() for n, h in hists.items()},
            "components": components,
        }

    def exposition(self, namespace: str = "dl4j",
                   labels: Optional[dict] = None) -> str:
        """Prometheus-style text exposition of `snapshot()`."""
        snap = self.snapshot()
        lab = ""
        if labels:
            lab = "{" + ",".join(
                f'{_sanitize(str(k))}="{v}"'
                for k, v in sorted(labels.items())) + "}"
        lines: List[str] = []

        def emit(name, kind, value):
            # a series may embed its OWN labels in the registered name
            # (e.g. 'x{tp_rank="0"}' — per-shard gauges register one
            # series per rank); split them off before sanitizing and
            # merge with the call-level labels so the exposition stays
            # one metric name with several labelled series
            own = ""
            if "{" in name:
                name, own = name.split("{", 1)
                own = own.rstrip("}")
            full = f"{namespace}_{_sanitize(name)}"
            merged = lab
            if own:
                merged = lab[:-1] + "," + own + "}" if lab \
                    else "{" + own + "}"
            lines.append(f"# TYPE {full} {kind}")
            lines.append(f"{full}{merged} {value}")

        for name, v in sorted(snap["counters"].items()):
            emit(name, "counter", v)
        for name, v in sorted(snap["gauges"].items()):
            if v is not None:
                emit(name, "gauge", v)
        for name, h in sorted(snap["histograms"].items()):
            full = f"{namespace}_{_sanitize(name)}"
            lines.append(f"# TYPE {full} histogram")
            cum = 0
            for bound, cnt in zip(h["buckets"], h["counts"]):
                cum += cnt
                if labels:
                    le = lab[:-1] + f',le="{bound}"}}'
                else:
                    le = f'{{le="{bound}"}}'
                lines.append(f"{full}_bucket{le} {cum}")
            if labels:
                le = lab[:-1] + ',le="+Inf"}'
            else:
                le = '{le="+Inf"}'
            lines.append(f"{full}_bucket{le} {h['count']}")
            lines.append(f"{full}_sum{lab} {h['sum']}")
            lines.append(f"{full}_count{lab} {h['count']}")
        flat: List = []
        for comp, stats in sorted(snap["components"].items()):
            _flatten_numeric(_sanitize(comp), stats, flat)
        for name, v in flat:
            emit(f"stats_{name}", "gauge", v)
        return "\n".join(lines) + "\n"


# -- flight recorder -------------------------------------------------------

class FlightRecorder:
    """Bounded rings of (a) completed request timelines, (b) timelines
    that ended in a typed failure (the auto-snapshot ring: success
    traffic cannot push a postmortem out before anyone looks), and
    (c) scheduler/control-plane events. Traces are stored by reference
    and serialized at `dump()` time, so spans recorded after the
    initial `record` (e.g. a pool-level failover wrapping a replica's
    already-recorded attempt) still appear in the dump.

    Sizing: the defaults (256 requests / 64 failures / 1024 events)
    hold a few seconds of saturated decode traffic — see
    docs/observability.md for the arithmetic. All writes are O(1) deque
    appends and respect the `tracing_enabled` kill switch."""

    def __init__(self, capacity: int = 256, failure_capacity: int = 64,
                 event_capacity: int = 1024):
        self._lock = threading.Lock()
        self._requests = deque(maxlen=capacity)
        self._failures = deque(maxlen=failure_capacity)
        self._events = deque(maxlen=event_capacity)

    def record(self, trace, decision: str, kind: str = "request",
               **attrs) -> None:
        """Ring a completed request timeline. ``decision`` is the
        verdict that ended it (``served`` or a typed-error class name);
        non-served timelines are also pinned in the failures ring."""
        if not trace or not tracing_enabled():
            return
        entry = {"kind": kind, "decision": decision,
                 "wall_time": time.time(), "trace": trace}
        if attrs:
            entry["attrs"] = attrs
        with self._lock:
            self._requests.append(entry)
            if decision != "served":
                self._failures.append(entry)

    def pin(self, trace, decision: str, kind: str = "excursion",
            **attrs) -> None:
        """Pin a request timeline in the FAILURES ring without a
        request completion — the p99-excursion auto-dump: the latency
        histogram's excursion hook calls this the moment an
        observation lands past the quantile bound, so the tail
        request's full span timeline survives success traffic (the
        failures ring is the one a burst of served requests cannot
        push a postmortem out of). Also rings a matching control-plane
        event carrying the trace id."""
        if not trace or not tracing_enabled():
            return
        entry = {"kind": kind, "decision": decision,
                 "wall_time": time.time(), "trace": trace}
        if attrs:
            entry["attrs"] = attrs
        with self._lock:
            self._failures.append(entry)
        self.event(kind, decision=decision,
                   trace_id=getattr(trace, "trace_id", None), **attrs)

    def event(self, kind: str, **attrs) -> None:
        """Ring a scheduler/control-plane event (admission, retirement,
        page reclaim, probe verdict, breaker transition, chaos)."""
        if not tracing_enabled():
            return
        e = {"kind": kind, "t": time.monotonic(), "wall_time": time.time()}
        if attrs:
            e.update(attrs)
        with self._lock:
            self._events.append(e)

    @staticmethod
    def _ser(entry: dict) -> dict:
        out = {k: v for k, v in entry.items() if k != "trace"}
        tr = entry["trace"]
        out["trace"] = tr.to_dict() if hasattr(tr, "to_dict") else tr
        return out

    def dump(self) -> dict:
        with self._lock:
            requests = list(self._requests)
            failures = list(self._failures)
            events = list(self._events)
        return {
            "requests": [self._ser(e) for e in requests],
            "failures": [self._ser(e) for e in failures],
            "events": events,
            "capacity": {"requests": self._requests.maxlen,
                         "failures": self._failures.maxlen,
                         "events": self._events.maxlen},
        }


# -- stats-schema contracts ------------------------------------------------
# The key sets the serving layers' ``stats()`` dicts promise in the
# JAX package (tests and external scrapers rely on them), copied as
# they are. Layers may ADD keys; removing or renaming one is a breaking
# change. The port's `ModelServer` carries every MODEL_SERVER_STATS_KEYS
# key (tests/test_torch_model_server.py) and its `DecodeEngine` every
# DECODE_ENGINE_STATS_KEYS key, the QoS, KV-transfer and cluster-prefix
# keys included (tests/test_torch_qos.py); `tp_degree` is the engine's
# tensor-parallel degree (`serving/tp_engine.py`), 1 without one.

MODEL_SERVER_STATS_KEYS = frozenset({
    "served", "batches", "batch_fill_pct", "shed_overload",
    "shed_deadline", "shed_unavailable", "failures", "reloads",
    "reload_rejections", "breaker_state", "breaker_opens",
    "model_version", "queued", "in_flight", "queue_depth",
    "ewma_latency_ms",
    # quantized serving tier: weight precision actually serving (32 /
    # 16 / 8) and the drift-gate verdict counters — all numeric, so
    # `_flatten_numeric` carries them into the Prometheus exposition
    "weight_bits", "drift_gate_checks", "drift_gate_failures",
})

DECODE_ENGINE_STATS_KEYS = frozenset({
    "submitted", "served", "shed_overload", "shed_out_of_pages",
    "shed_deadline", "shed_unavailable", "failures", "prefills",
    "prefill_chunks", "decode_steps", "tokens_generated",
    "slot_occupancy_pct", "n_slots", "active_slots", "queued", "swaps",
    "max_len", "page_size", "pool_pages", "pages_in_use",
    "pages_in_use_peak", "queued_page_demand", "max_queued_pages",
    # quantized KV tier: bits per cache element actually allocated
    # (8 = int8 pools, else the compute dtype's width) and the
    # per-generated-token KV byte cost including the scale sidecar
    "kv_quant_bits", "kv_bytes_per_token",
    # tensor-parallel tier: mesh degree (1 = single-device engine, so
    # capacity dashboards never branch on key presence) and the
    # per-shard slice of kv_bytes_per_token — each device's actual
    # per-token KV residency under head sharding
    "tp_degree", "tp_kv_bytes_per_token_per_shard",
    # multi-tenant QoS tier: batch-lane preemptions, SLO-infeasible
    # sheds, quota rejections, and the per-tenant sub-dicts (keyed by
    # tenant name; each value pins TENANT_STATS_KEYS)
    "preemptions", "slo_sheds", "shed_quota", "tenants",
    # KV transfer tier (`serving.kv_transfer`): page-quota sheds, slots
    # exported/imported as leased handoffs, lease resolutions by
    # outcome, live leases, and total payload bytes shipped out
    "shed_page_quota", "migrations_out", "migrations_in",
    "handoffs_committed", "handoffs_aborted", "handoffs_expired",
    "handoff_leases", "handoffs_unfetched", "kv_transfer_bytes",
    # cluster prefix cache tier (`serving.prefix_directory`): fetches
    # landed vs degraded to cold prefill, wire bytes/latency of prefix
    # page pulls, chains exported to peers, and prompt tokens whose
    # prefill was skipped via pages fetched from ANOTHER host (the
    # cluster-level hit ratio next to the local prefix_hit_tokens_pct)
    "prefix_fetches", "prefix_fetch_fallbacks", "prefix_fetch_bytes",
    "prefix_fetch_ms", "prefix_exports", "cluster_prefix_hit_tokens",
    "cluster_prefix_hit_tokens_pct",
})

# Per-tenant counters nested under DecodeEngine ``stats()["tenants"]``
# — one dict per tenant name the engine has seen (quota'd or not).
TENANT_STATS_KEYS = frozenset({
    "submitted", "served", "shed_quota", "tokens_generated",
    "preemptions", "rate", "burst", "tokens",
    # KV page quota tier: page-ceiling rejections, the configured
    # ceiling (None = unlimited), and the tenant's live page footprint
    "shed_page_quota", "max_pages", "pages_reserved",
    # batch-lane weighted-fair queueing: this tenant's stride share
    # (1.0 default; weight 2 earns twice the admitted span of weight 1)
    "weight",
})

REPLICA_POOL_STATS_KEYS = frozenset({
    "n_replicas", "healthy_replicas", "pool_in_flight",
    "admission_budget", "served", "failovers", "hedges_fired",
    "hedge_wins", "evictions", "readmissions", "rolling_reloads",
    "rollbacks", "shed_overload", "shed_unavailable", "ewma_latency_ms",
    "replicas",
    # elasticity tier: replicas added/drained-out by the autoscaler (or
    # an operator) since construction
    "replicas_added", "replicas_removed",
    # live decode-state migration: redirects resumed on a peer vs
    # degraded to the full re-prefill fallback
    "migrations", "migration_fallbacks",
    # cluster prefix cache: dispatches steered to a chain holder within
    # the affinity margin, and the shared directory's live entry count
    # (0 when no directory is bound)
    "affinity_routes", "directory_entries",
})

# `Autoscaler.stats()` — registered under the pool's metrics registry
# as component "autoscaler", so the gateway `metrics` exposition and
# `autoscaler_stats` RPC both carry it.
AUTOSCALER_STATS_KEYS = frozenset({
    "autoscale_events", "scale_ups", "scale_downs",
    "autoscale_failures", "samples", "pressure", "pressure_ewma",
    "min_replicas", "max_replicas", "cooldown_remaining",
    "last_decision",
    # migrate-then-drain shrink: wall time of the most recent
    # scale-down — the regression alarm for "scale_down no longer
    # blocks on the longest in-flight generation"
    "last_scale_down_ms",
})

# `ExactlyOnceDoor.stats()["cache"]` (`serving.exactly_once`) — the
# gateway `exactly_once_stats` RPC returns the enclosing dict verbatim;
# the ledger counters the crash/reclaim drills and the bench assert on.
EXACTLY_ONCE_STATS_KEYS = frozenset({
    "completed", "inflight", "capacity", "ttl_s", "dedup_hits",
    "executions", "expired", "evicted", "double_executions",
    "durable_loaded",
})

POOL_REPLICA_STATS_KEYS = frozenset({
    "state", "consecutive_failures", "evictions", "stale",
}) | MODEL_SERVER_STATS_KEYS

# `StreamRegistry.stats()` (`serving.streaming`) — registered under the
# serving tier's metrics as component "streaming" by the first streamed
# request, so the gateway `metrics` exposition carries the resumable-
# streaming counters (`stream_resumes`, backpressure sheds, the cursor
# dedup totals) the chaos drills and bench assert on.
STREAMING_STATS_KEYS = frozenset({
    "streams_active", "streams_opened", "streams_finished",
    "stream_resumes", "stream_backpressure_sheds",
    "duplicate_tokens_dropped", "ring_capacity", "ttl_s",
})
