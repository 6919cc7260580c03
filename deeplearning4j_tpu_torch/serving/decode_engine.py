"""Continuous-batching decode engine: paged KV cache + chunked prefill
over slotted iteration-level scheduling (counterpart of
`deeplearning4j_tpu/serving/decode_engine.py`, its core).

- **One paged KV pool per block**, allocated once and updated in place:
  K `(P+1, Hkv, hd, page)`, V `(P+1, Hkv, page, hd)`. Page 0 is the
  trash page that absorbs the writes of inactive slots; every other page
  belongs to one request at a time. A per-slot page table
  `(S, n_pages_max)` int32 lives on the device. Attention goes through
  `ops.attention.paged_attention_step_auto` / `paged_attention_chunk_auto`:
  on the card the hand-written CUDA kernel walks the page table in
  place; on the CPU the plain version gathers and attends.
- **Memory-side admission control**: a request reserves
  `ceil(span / page)` pages at submit, takes them at admission, and
  returns them at retirement, expiry or failure. Past
  `max_queued_pages` of queued demand, `submit` sheds with the typed
  `OutOfPagesError`.
- **int8 KV** (`quantize={"kv": "int8"}`, `serving/quantize.py`): the
  pools hold int8 elements plus f32 scale pools `(P+1, Hkv, page)` riding
  the same page table; K/V are quantized per (head, position) at every
  cache write and dequantized at the read site, inside the int8 kernel's
  page walk on the card.
- **Prefix cache** (`prefix_cache=True` or a dict of
  `serving.prefix_cache.PrefixCache` arguments): prompts sharing a
  page-aligned prefix bind the SAME resident pool pages; a hit request
  prefills only from its first uncached page boundary, through the
  chunk path. Cached pages are refcounted, never written, and reclaimed
  LRU-first when the free list cannot cover an admission.
- **Speculative decoding** (`speculative={"draft": net | "self" | config
  dict, "k": 4}`, `serving.speculative.SpeculativeDecoder`): a draft
  model proposes k tokens per slot and the target verifies them in one
  (k+1)-wide chunk per slot; greedy emission stays equal to `generate`
  for any draft. The draft keeps its own pools behind the same page
  table.
- **One decode step advances every slot**; per-slot positions and an
  active mask make one step correct for any mix of lengths. With
  `decode_chunk > 1` the scheduler runs up to that many steps back to
  back, reading the tokens back once, whenever no scheduling event can
  fall inside the run.
- **Prefill**: prompts up to the largest bucket prefill in one pass with
  the same block math as `generate`; longer prompts prefill in
  `prefill_chunk`-token chunks through the paged kernel, at most
  `prefill_chunk_budget` chunks per scheduler iteration, interleaved
  with decode steps.
- **A host scheduler thread** admits, drives prefill chunks and decode
  steps, retires on EOS / max tokens / deadline, and delivers tokens.

- **The serving seams `ModelServer` drives**: an optional shared
  `CircuitBreaker` (`breaker=`) checked at the door and acquired at
  admission, credited at retirement and debited at every failure;
  request timelines, a flight recorder and a metrics registry
  (`recorder=`, `metrics=`, `excursion=`; `serving/observability.py`);
  per-token log-probabilities (`logprobs=K`, of the unscaled f32
  log-softmax at every sampler site) and `on_token` sinks; `pending()`;
  and `drain_and_swap(net)`, which lets the in-flight requests finish
  on the old weights, swaps, and admits the queued ones on the new.

- **QoS** (`qos={"tenants", "default", "preempt", "slo_shed"}`): per-
  tenant token buckets charged at submit (`TenantQuotaExceededError`,
  the tenant's own, never a co-tenant's overload), per-tenant page
  ceilings, an SLO estimator that sheds a provably late request before
  prefill, interactive-first admission with a stride-scheduled
  (weighted-fair) batch lane, and preemption of decoding batch slots:
  the victim's tokens fold into its prompt, its pages are promoted into
  the prefix cache, its sampling generator is kept, and it rejoins the
  queue front.
- **KV handoff and live migration** (`serving/kv_transfer.py`): a
  `role="prefill"` engine exports every finished prefill under a lease
  instead of decoding; `migrate_slots()` exports every in-flight request
  (decoding slots warm with their pages, queued and mid-prefill ones
  cold). Waiters get the `SlotMigratedError` redirect; `fetch_handoff`,
  `commit_handoff`, `abort_handoff` and `resume_generate` move the
  request to a peer. Leased pages are freed exactly once: by commit,
  abort or the TTL sweep. Handoffs carry the weight digest (the JAX
  package's, byte for byte) and are refused typed on a mismatch.
- **The cluster prefix cache** (`bind_prefix_directory`): promoted chains
  publish into a `PrefixDirectory`; a local miss with a directory hit
  fetches the chain's pages from the holder (`export_prefix`, framed,
  checksummed) on the submit thread, single-flight per chain; any
  failure degrades to cold prefill.

Greedy decode equals whole-batch `models.transformer.generate` (the two
share the per-block helpers) regardless of admission order, page/slot
reuse, prefill chunking, preemption or a warm migration. Sampled
requests keep their `torch.Generator` through preemption and warm
handoff, so their tokens equal the uninterrupted run's.

- **Tensor parallelism** (`parallel={"tp": N}`, `serving/tp_engine.py`):
  the block stack of every step runs once per slot of an N-slot `tp`
  mesh (`parallel.mesh.set_local_slots`), each slot with its share of
  the heads and FFN width and its own contiguous `(P+1, Hkv/N, ...)`
  pools; the page table, free list, refcounts and prefix-cache
  promotions stay host-global. `logprobs` with `tp > 1` is refused, as
  in the JAX package.
"""
from __future__ import annotations

import collections
import hashlib
import logging
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving import observability
from deeplearning4j_tpu_torch.serving.model_server import (
    DeadlineExceededError,
    InferenceFailedError,
    OutOfPagesError,
    ServerClosedError,
    ServerOverloadedError,
    ServiceUnavailableError,
    ServingError,
    TenantQuotaExceededError,
    _bucket,
)
from deeplearning4j_tpu_torch.serving.quantize import (
    _write_scale_pages,
    kv_bytes_per_token,
    quantize_heads,
)
from deeplearning4j_tpu_torch.util.concurrency import assert_owned

logger = logging.getLogger("deeplearning4j_tpu_torch")

def _parallel_degree(parallel) -> int:
    """The tensor-parallel degree asked for; degree 1 is this engine."""
    if parallel is None:
        return 1
    if not isinstance(parallel, dict):
        raise ValueError('parallel must be a dict like {"tp": N}')
    unknown = set(parallel) - {"tp"}
    if unknown:
        raise ValueError("unknown parallel keys: %s" % sorted(unknown))
    tp = parallel.get("tp", 1)
    if not isinstance(tp, int) or isinstance(tp, bool) or tp < 1:
        raise ValueError("parallel['tp'] must be a positive int, got %r"
                         % (tp,))
    return tp


def _validate_qos(qos) -> None:
    if qos is None:
        return
    if not isinstance(qos, dict):
        raise ValueError(
            'qos must be a dict like {"tenants": {...}, "default": {...}, '
            '"preempt": bool, "slo_shed": bool}')
    unknown = set(qos) - {"tenants", "default", "preempt", "slo_shed"}
    if unknown:
        raise ValueError("unknown qos keys: %s" % sorted(unknown))
    for name, spec in {**(qos.get("tenants") or {}),
                       "default": qos.get("default") or {}}.items():
        bad = set(spec) - {"rate", "burst", "max_pages", "weight"}
        if bad:
            raise ValueError("unknown qos tenant keys for %r: %s"
                             % (name, sorted(bad)))
        if spec.get("rate") is not None and float(spec["rate"]) <= 0:
            raise ValueError("qos tenant %r rate must be > 0" % (name,))
        if spec.get("max_pages") is not None and int(spec["max_pages"]) < 1:
            raise ValueError("qos tenant %r max_pages must be >= 1"
                             % (name,))
        if spec.get("weight") is not None and float(spec["weight"]) <= 0:
            raise ValueError("qos tenant %r weight must be > 0" % (name,))


def weight_digest(params) -> str:
    """Content digest of a network's parameters, byte for byte the JAX
    engine's: blake2b (8 bytes) over the leaves in layer order, parameter
    names sorted within a layer (`jax.tree_util.tree_leaves` order), each
    as its dtype name, `str(shape)` and bytes. The port keeps every
    parameter in the JAX package's layout, so the same weights give the
    same digest in both packages; a handoff whose digest differs is
    refused."""
    h = hashlib.blake2b(digest_size=8)

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from leaves(v)
        elif tree is not None:
            yield tree

    for leaf in leaves(params):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            arr = t.numpy()
            name, raw = str(arr.dtype), arr.tobytes()
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(raw)
    return h.hexdigest()


class _GenRequest:
    """One generation request: queued -> (shed | admitted into a slot,
    prefilled one-shot or chunk by chunk) -> decoding -> (completed |
    expired | failed | exported). `n_pages` is the reservation taken at
    submit, `pages` the pool pages held from admission to retirement,
    `prefill_pos` the next chunk offset while mid-prefill. With a prefix
    cache, `hit_len` prompt positions ride shared pages: the first
    `n_shared` entries of `pages`, refcounted through `nodes`; only
    `pages[n_shared:]` are this request's to free. `digests` memoizes
    the prompt's per-page digests. `probe` is the breaker token taken at
    admission, `trace` the request's timeline across the caller and
    scheduler threads, `sink` the `on_token` callback, and `logprobs`
    the top-K entries asked for, collected in `logprob_values`.

    QoS and handoff state: `tenant` and `priority` ("interactive" or
    "batch"); a preempted request folds its emitted tokens into `prompt`
    and `resumed_at` marks the fold, so its logical span stays
    `len(prompt) - resumed_at + n_tokens`. `gen` is the live sampling
    generator, kept through preemption and shipped with a handoff.
    `handoff` marks a prefill-role request, `import_state` a validated
    inbound warm payload, `prefix_import` a fetched cluster-prefix
    bundle bound at admission."""

    __slots__ = ("prompt", "n_tokens", "temperature", "seed", "deadline",
                 "event", "tokens", "error", "n_pages", "pages", "prefill_pos",
                 "hit_len", "n_shared", "nodes", "digests", "enqueued_at",
                 "probe", "trace", "sink", "logprobs", "logprob_values",
                 "tenant", "priority", "resumed_at", "preempted", "gen",
                 "handoff", "import_state", "prefix_import")

    def __init__(self, prompt: np.ndarray, n_tokens: int,
                 temperature: float, seed: int, deadline: Optional[float],
                 tenant: Optional[str] = None,
                 priority: str = "interactive"):
        self.prompt = prompt
        self.n_tokens = n_tokens
        self.temperature = temperature
        self.seed = seed
        self.deadline = deadline
        self.tenant = tenant
        self.priority = priority
        self.resumed_at = 0
        self.preempted = 0
        self.gen: Optional[torch.Generator] = None
        self.handoff = False
        self.import_state: Optional[dict] = None
        self.prefix_import: Optional[dict] = None
        self.event = threading.Event()
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self.n_pages = 0
        self.pages: Optional[List[int]] = None
        self.prefill_pos: Optional[int] = None
        self.hit_len = 0
        self.n_shared = 0
        self.nodes: Optional[list] = None
        self.digests: list = []
        self.enqueued_at = time.monotonic()
        self.probe = False
        self.trace = observability.NULL_TRACE
        self.sink: Optional[Callable] = None
        self.logprobs = 0
        self.logprob_values: List[dict] = []

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) >= self.deadline

    def finish(self, error: Optional[BaseException] = None) -> None:
        self.error = error
        self.event.set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until done: the generated tokens (1-D int32, shorter
        than n_tokens only on EOS) or the typed `ServingError`."""
        wait = timeout
        if wait is None and self.deadline is not None:
            wait = max(0.0, self.deadline - time.monotonic()) + 30.0
        if not self.event.wait(wait):
            raise InferenceFailedError(
                "generation request was never completed (engine stalled)")
        if self.error is not None:
            raise self.error
        return np.asarray(self.tokens, np.int32)


class _TenantState:
    """One tenant's QoS ledger: a token bucket over requested tokens
    (charged at submit, so a flood meets its own wall before it takes
    queue room), an optional page ceiling, the batch lane's weight, and
    the counters `stats()["tenants"]` publishes. Guarded by the owning
    engine's `_cond`."""

    __slots__ = ("rate", "burst", "tokens", "last_refill", "submitted",
                 "served", "shed_quota", "shed_page_quota",
                 "tokens_generated", "preemptions", "max_pages", "weight")

    def __init__(self, rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_pages: Optional[int] = None,
                 weight: Optional[float] = None):
        self.rate = None if rate is None else float(rate)
        self.burst = float(burst) if burst is not None \
            else (self.rate if self.rate else 0.0)
        self.tokens = self.burst
        self.max_pages = None if max_pages is None else int(max_pages)
        self.weight = 1.0 if weight is None else float(weight)
        self.last_refill = time.monotonic()
        self.submitted = 0
        self.served = 0
        self.shed_quota = 0
        self.shed_page_quota = 0
        self.tokens_generated = 0
        self.preemptions = 0

    def refill(self, now: float) -> None:
        # elapsed clamps at 0: a ledger made mid-admission carries a
        # last_refill after the door's `now`
        if self.rate:
            self.tokens = min(
                self.burst,
                self.tokens + max(0.0, now - self.last_refill) * self.rate)
        self.last_refill = now

    def counters(self) -> dict:
        # rate and burst stay None for unquota'd tenants: 0.0 would read
        # as "zero allowance"
        return {"submitted": self.submitted, "served": self.served,
                "shed_quota": self.shed_quota,
                "shed_page_quota": self.shed_page_quota,
                "tokens_generated": self.tokens_generated,
                "preemptions": self.preemptions,
                "rate": self.rate, "burst": self.burst or None,
                "tokens": round(self.tokens, 3),
                "max_pages": self.max_pages,
                "weight": self.weight}


def _write_pages(kp, vp, kcol, vrow, wpids, woff: int, page: int) -> None:
    """Write one contiguous prefill span (1, Hkv, hd, W) / (1, Hkv, W, hd)
    into pool pages `wpids` (host ints), in place: floor(W/page) whole
    pages, then a partial tail at in-page offset `woff`. The JAX package
    writes with `dynamic_update_slice`, which clamps the start index;
    slicing here would write past the page instead, so a span that does
    not fit raises."""
    W = kcol.shape[3]
    nfull = W // page
    for j in range(nfull):
        kp[wpids[j]] = kcol[0, :, :, j * page:(j + 1) * page]
        vp[wpids[j]] = vrow[0, :, j * page:(j + 1) * page, :]
    rem = W - nfull * page
    if rem:
        if woff + rem > page:
            raise ValueError(f"prefill span of {rem} at page offset {woff} "
                             f"runs past the {page}-entry page")
        kp[wpids[nfull], :, :, woff:woff + rem] = kcol[0, :, :, nfull * page:]
        vp[wpids[nfull], :, woff:woff + rem, :] = vrow[0, :, nfull * page:, :]


def _new_pools(plan, pool_pages: int, page: int, kv_quant: Optional[str],
               device) -> list:
    """Fresh paged pools for every block of `plan`: (K, V) in the compute
    dtype, or for int8 KV (K, V, K scales, V scales) with int8 payloads
    and f32 scale pools (P+1, Hkv, page). +1: page 0 is the trash page
    for masked writes. Scales start at 1.0, so an unwritten entry
    dequantizes to exactly 0.0 in one multiply, as a real all-zero write
    would."""
    P = pool_pages
    caches = []
    for hkv, hd in plan.kv_geometry():
        dt = torch.int8 if kv_quant else plan.cdt
        cache = (torch.zeros((P + 1, hkv, hd, page), dtype=dt, device=device),
                 torch.zeros((P + 1, hkv, page, hd), dtype=dt, device=device))
        if kv_quant:
            cache += tuple(torch.ones((P + 1, hkv, page), dtype=torch.float32,
                                      device=device) for _ in range(2))
        caches.append(cache)
    return caches


def _scales(cache) -> dict:
    """The scale-pool keywords of one block's pools for the `*_auto`
    attention entries: empty for dense pools."""
    return {"k_scale": cache[2], "v_scale": cache[3]} if len(cache) == 4 \
        else {}


def _write_span(cache, kcol, vrow, wpids, woff: int, page: int) -> None:
    """Write one prefill span into one block's pools, in place
    (`_write_pages`); int8 pools take the span quantized per (head,
    position) and its scales (`quantize._write_scale_pages`)."""
    if len(cache) == 4:
        kcol, kscol = quantize_heads(kcol, axis=2)
        vrow, vscol = quantize_heads(vrow, axis=3)
        _write_scale_pages(cache[2], kscol, wpids, woff, page)
        _write_scale_pages(cache[3], vscol, wpids, woff, page)
    _write_pages(cache[0], cache[1], kcol, vrow, wpids, woff, page)


def _write_step(cache, pids, loff, k, v) -> None:
    """Write one position per slot, k/v (S, Hkv, hd), at in-page offsets
    `loff` of pool pages `pids`, in place (where the JAX package donates
    the pools through jit). Masked lanes all land on trash page 0:
    duplicate indices there are harmless, nothing reads page 0 unmasked.
    int8 pools take the write quantized per head; the scale lands at the
    SAME (page, head, offset) as the payload, so the trash page masks
    both together."""
    if len(cache) == 4:
        k, ksc = quantize_heads(k)
        v, vsc = quantize_heads(v)
        cache[2][pids, :, loff] = ksc
        cache[3][pids, :, loff] = vsc
    cache[0][pids, :, :, loff] = k
    cache[1][pids, :, loff, :] = v


def _lp_math(logits, chosen, k: int):
    """(chosen-token log-probability, top-k log-probabilities, their ids)
    of the unscaled f32 log-softmax: a report on the model, not on the
    temperature or top-k sampling transform, so greedy and sampled
    requests read the same numbers. The top k come from a stable
    descending sort: equal values keep the lower id first, the order
    `jax.lax.top_k` gives them in the JAX package."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = lsm.gather(-1, chosen.long()[..., None])[..., 0]
    top_v, top_i = torch.sort(lsm, dim=-1, descending=True, stable=True)
    return chosen_lp, top_v[..., :k], top_i[..., :k]


def _host(lp):
    """A logprob triple on the host (numpy), or None."""
    return None if lp is None else tuple(t.cpu().numpy() for t in lp)


def _dispatched(thunk):
    """Run one device dispatch including its host read-back, tagging any
    exception so the caller can tell a failed dispatch (which may have
    left the in-place pools half-written) from a later failure."""
    try:
        return thunk()
    except Exception as e:
        e._dispatch_failure = True
        raise


class DecodeEngine:
    """Continuous-batching generation over `n_slots` decode slots backed
    by a paged KV pool (see the module docstring). Arguments as in the
    JAX package: `max_len` caps prompt + output and sizes the page table;
    `page_size` is the pow-2 KV page length; `pool_pages` the allocatable
    pages (default `n_slots * ceil(max_len / page)`); `max_queued_pages`
    the queued page demand allowed to wait (default 4 x pool);
    `prompt_buckets` the one-shot prefill pad lengths; `prefill_chunk`
    the pow-2 chunk width of chunked prefill; `prefill_chunk_budget`
    chunks per scheduler iteration; `max_queue` the bounded queue;
    `eos_token` retires a slot early; `top_k` applies to sampled
    requests; `step_hooks` are called as `hook(phase, info)` around
    prefill and decode dispatches; `decode_chunk` the longest run of
    decode steps between token read-backs (ignored under `speculative`:
    the verify step is the multi-token dispatch). `prefix_cache`,
    `speculative` and `quantize` as in the module docstring. `breaker`
    is an optional `CircuitBreaker` shared with a `ModelServer`:
    admission is refused while it is open and device failures count.
    `recorder` and `metrics` are a shared `FlightRecorder` and
    `MetricsRegistry` (a standalone engine builds its own); `excursion`
    arms the generate-latency histogram's p99-excursion pin (None: on at
    the defaults, False: off, or ``{"quantile", "min_count"}``).
    `logprobs=K` lets requests ask for up to K top log-probabilities
    per token (not with `speculative`). `qos`, `role` ("both",
    "prefill" or "decode") and `handoff_ttl` (seconds a leased handoff
    waits for its receiver) as in the module docstring; `parallel` is
    None or ``{"tp": N}`` (tensor parallelism over the process's first N
    slots). `device` defaults to the card and must be the network's
    device."""

    def __init__(self, net, *, n_slots: int = 4,
                 max_len: Optional[int] = None,
                 page_size: int = 128,
                 pool_pages: Optional[int] = None,
                 max_queued_pages: Optional[int] = None,
                 prompt_buckets: Sequence[int] = (32, 64, 128),
                 prefill_chunk: int = 256,
                 prefill_chunk_budget: int = 1,
                 max_queue: int = 64,
                 default_timeout: Optional[float] = None,
                 eos_token: Optional[int] = None,
                 top_k: int = 0,
                 step_hooks: Sequence[Callable] = (),
                 decode_chunk: int = 4,
                 prefix_cache=None,
                 speculative: Optional[dict] = None,
                 quantize: Optional[dict] = None,
                 breaker=None,
                 recorder=None,
                 metrics=None,
                 excursion=None,
                 logprobs: int = 0,
                 parallel: Optional[dict] = None,
                 qos: Optional[dict] = None,
                 role: str = "both",
                 handoff_ttl: float = 30.0,
                 device="cuda"):
        from deeplearning4j_tpu_torch.ops.kernel_dispatch import (
            resolve_device,
        )
        from deeplearning4j_tpu_torch.serving.kv_transfer import LeaseTable

        if role not in ("both", "prefill", "decode"):
            raise ValueError('role must be "both", "prefill" or "decode", '
                             "got %r" % (role,))
        if handoff_ttl <= 0:
            raise ValueError("handoff_ttl must be > 0")
        self._tp_degree = _parallel_degree(parallel)
        self._tp = None  # TPPlan, built per (re)build when the degree > 1
        _validate_qos(qos)
        if logprobs < 0:
            raise ValueError("logprobs must be >= 0")
        if logprobs and self._tp_degree > 1:
            raise ValueError(
                "logprobs=K cannot combine with tensor parallelism yet "
                "(the top-K gather is not sharded)")
        if logprobs and speculative:
            raise ValueError(
                "logprobs=K cannot combine with speculative decoding: "
                "accepted draft tokens have no single per-step target "
                "distribution to report")
        if excursion not in (None, False) and not isinstance(excursion, dict):
            raise ValueError("excursion must be None, False, or a dict")
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if decode_chunk < 1:
            raise ValueError("decode_chunk must be >= 1")
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError("page_size must be a power of two")
        if prefill_chunk < 1 or prefill_chunk & (prefill_chunk - 1):
            raise ValueError("prefill_chunk must be a power of two")
        if prefill_chunk_budget < 1:
            raise ValueError("prefill_chunk_budget must be >= 1")
        if pool_pages is not None and pool_pages < 1:
            raise ValueError("pool_pages must be >= 1")
        if max_queued_pages is not None and max_queued_pages < 0:
            raise ValueError("max_queued_pages must be >= 0")
        if quantize is not None:
            unknown = set(quantize) - {"kv"}
            if unknown:
                raise ValueError("unknown quantize keys: %s"
                                 % sorted(unknown))
            if quantize.get("kv") not in (None, "int8"):
                raise ValueError("quantize['kv'] must be 'int8', got %r"
                                 % (quantize.get("kv"),))
        self._kv_quant = "int8" if quantize and quantize.get("kv") == "int8" \
            else None
        self._logprobs_k = int(logprobs)
        self._prefix_cache_cfg = prefix_cache
        self._speculative_cfg = dict(speculative) if speculative else None
        self.device = resolve_device(device)
        if net.device != self.device:
            raise ValueError(f"DecodeEngine on {self.device} but the network "
                             f"lives on {net.device}")
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.default_timeout = default_timeout
        self.eos_token = eos_token
        self.top_k = top_k
        self.decode_chunk = decode_chunk
        self.prefill_chunk_budget = prefill_chunk_budget
        self.step_hooks: List[Callable] = list(step_hooks)
        self.breaker = breaker
        self._requested_max_len = max_len
        self._requested_page_size = page_size
        self._requested_pool_pages = pool_pages
        self._requested_max_queued_pages = max_queued_pages
        self._requested_prefill_chunk = prefill_chunk
        self._prompt_buckets = tuple(sorted(set(int(b)
                                                for b in prompt_buckets)))
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()  # guarded by: _cond
        self._slots: List[Optional[_GenRequest]] = [None] * n_slots  # guarded by: _cond
        self._closed = False  # guarded by: _cond
        self._kill = False  # guarded by: _cond
        # drain_and_swap: admission pauses while _draining; the scheduler
        # swaps to _swap_net once every slot is empty
        self._draining = False  # guarded by: _cond
        self._swap_net = None  # guarded by: _cond
        self._swap_in_progress = False  # guarded by: _cond
        self._swap_error: Optional[BaseException] = None  # guarded by: _cond
        self._swap_done = threading.Event()
        self._step_ewma = 0.01  # guarded by: _cond
        self._pages_demand_queued = 0  # guarded by: _cond
        # QoS: per-tenant buckets, the preemption and SLO-shed switches,
        # the SLO estimator's queue-wait and prefill-chunk EWMAs (the
        # decode-step EWMA above is shared with retry_after)
        self._qos_cfg = dict(qos) if qos else None
        q = self._qos_cfg or {}
        self._preempt_enabled = qos is not None \
            and q.get("preempt", True) is not False
        self._slo_shed_enabled = qos is not None \
            and q.get("slo_shed", True) is not False
        self._default_quota = dict(q.get("default") or {}) or None
        self._tenants: dict = {}  # guarded by: _cond
        for name, spec in (q.get("tenants") or {}).items():
            self._tenants[name] = _TenantState(
                rate=spec.get("rate"), burst=spec.get("burst"),
                max_pages=spec.get("max_pages"), weight=spec.get("weight"))
        # batch-lane stride scheduling: a tenant's pass advances by its
        # admitted span over its weight; the floor keeps an idle tenant
        # from banking credit
        self._wfq_pass: dict = {}  # guarded by: _cond
        self._wfq_floor = 0.0  # guarded by: _cond
        self._queue_wait_ewma = 0.0  # guarded by: _cond
        self._chunk_ewma = 0.0  # guarded by: _cond
        # KV handoff: the role, the sender's lease ledger and the
        # scheduler's migrate-everything switch
        self._role = role
        self._leases = LeaseTable(ttl=handoff_ttl)  # guarded by: _cond
        self._migrate_all = False  # guarded by: _cond
        # cluster prefix cache: all None until bind_prefix_directory
        self._prefix_directory = None
        self._holder_id: Optional[str] = None
        self._prefix_peers = None
        self._prefix_fetch_frame_pages = 8
        self._prefix_fetch_timeout = 5.0
        self._prefix_min_fetch_pages = 1
        # export_prefix work parked for the scheduler thread, the only
        # thread that reads the pools between dispatches
        self._prefix_exports: collections.deque = collections.deque()  # guarded by: _cond
        # single flight: chains with a fetch in progress, and fetched
        # bundles still on their way to the cache
        self._prefix_fetching: set = set()  # guarded by: _cond
        self._prefix_fetch_ready: dict = {}  # guarded by: _cond
        # counters
        self.submitted = 0  # guarded by: _cond
        self.served = 0  # guarded by: _cond
        self.shed_overload = 0  # guarded by: _cond
        self.shed_out_of_pages = 0  # guarded by: _cond
        self.shed_deadline = 0  # guarded by: _cond
        self.shed_unavailable = 0  # guarded by: _cond
        self.failures = 0  # guarded by: _cond
        self.swaps = 0  # guarded by: _cond
        self.prefills = 0  # guarded by: _cond
        self.prefill_chunks = 0  # guarded by: _cond
        self.decode_steps = 0  # guarded by: _cond
        self.active_slot_steps = 0  # guarded by: _cond
        self.tokens_generated = 0  # guarded by: _cond
        self.pages_in_use_peak = 0  # guarded by: _cond
        # latency-tier counters (prefix cache + speculative decoding)
        self.prompt_tokens = 0  # guarded by: _cond
        self.prefix_hits = 0  # guarded by: _cond
        self.prefix_misses = 0  # guarded by: _cond
        self.prefix_hit_tokens = 0  # guarded by: _cond
        self.spec_steps = 0  # guarded by: _cond
        self.spec_proposed = 0  # guarded by: _cond
        self.spec_accepted = 0  # guarded by: _cond
        self.spec_emitted = 0  # guarded by: _cond
        # QoS counters
        self.preemptions = 0  # guarded by: _cond
        self.slo_sheds = 0  # guarded by: _cond
        self.shed_quota = 0  # guarded by: _cond
        self.shed_page_quota = 0  # guarded by: _cond
        # KV handoff counters
        self.migrations_out = 0  # guarded by: _cond
        self.migrations_in = 0  # guarded by: _cond
        self.handoffs_committed = 0  # guarded by: _cond
        self.handoffs_aborted = 0  # guarded by: _cond
        self.handoffs_expired = 0  # guarded by: _cond
        self.kv_transfer_bytes = 0  # guarded by: _cond
        # cluster prefix counters
        self.prefix_fetches = 0  # guarded by: _cond
        self.prefix_fetch_fallbacks = 0  # guarded by: _cond
        self.prefix_fetch_bytes = 0  # guarded by: _cond
        self.prefix_fetch_seconds = 0.0  # guarded by: _cond
        self.prefix_exports_served = 0  # guarded by: _cond
        self.cluster_prefix_hit_tokens = 0  # guarded by: _cond
        # observability: a ModelServer-owned engine shares the server's
        # recorder and registry (one flight_record / metrics surface); a
        # standalone engine gets its own
        self.recorder = recorder if recorder is not None \
            else observability.FlightRecorder()
        self.metrics = metrics if metrics is not None \
            else observability.MetricsRegistry()
        self.metrics.register_stats("decode_engine", self.stats)
        self._gen_latency_hist = self.metrics.histogram(
            "decode_engine_generate_latency_ms")
        # time to first token, observed at every request's first token
        self._ttft_hist = self.metrics.histogram("decode_engine_ttft_ms")
        if excursion is not False:
            exc_cfg = dict(excursion) if excursion else {}
            self._gen_latency_hist.enable_excursion(
                quantile=float(exc_cfg.get("quantile", 0.99)),
                min_count=int(exc_cfg.get("min_count", 50)),
                hook=lambda v, bound, trace: self.recorder.pin(
                    trace, "excursion", latency_ms=round(v, 3),
                    bound_ms=round(bound, 3)))
        self.metrics.gauge("decode_engine_queued", lambda: len(self._queue))
        self.metrics.gauge(
            "decode_engine_pages_in_use",
            lambda: self.pool_pages - len(self._free_pages))
        if self._tp_degree > 1:
            # per-shard gauges carry a {tp_rank} label; the shards are
            # symmetric, so every rank reports the same KV residency
            for _r in range(self._tp_degree):
                self.metrics.gauge(
                    'decode_engine_tp_shard_kv_bytes_per_token'
                    '{tp_rank="%d"}' % _r,
                    lambda: self._kv_bytes_per_token // self._tp_degree)
        if self.breaker is not None \
                and getattr(self.breaker, "on_event", None) is None:
            # a standalone engine rings breaker transitions itself; a
            # server-owned breaker already feeds the shared recorder
            self.breaker.on_event = lambda state: self.recorder.event(
                "breaker", state=state)
        self._build(net)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="decode-engine-scheduler")
        self._thread.start()

    # -- device machinery --------------------------------------------------
    def _build(self, net) -> None:
        """Page geometry, compute-dtype parameters and fresh device state
        for `net`."""
        from deeplearning4j_tpu_torch.models.transformer import GPTPlan

        plan = GPTPlan(net)
        L = self._requested_max_len or plan.emb.max_length
        if plan.emb.positional:
            L = min(L, plan.emb.max_length)
        if L < 2:
            raise ValueError(f"max_len {L} leaves no room to decode")
        S = self.n_slots
        buckets = tuple(b for b in self._prompt_buckets if b <= L) or \
            (min(32, L),)
        # the logical per-slot cache length is max_len rounded up to a
        # whole number of pages and (when chunking can activate) of
        # prefill chunks, so every padded prefill width fits the row
        page = _bucket(L, self._requested_page_size)
        C = self._requested_prefill_chunk
        chunk_enabled = C < L
        M = max(page, C) if chunk_enabled else page
        L_logical = -(-L // M) * M
        n_pages_max = L_logical // page
        pool_pages = self._requested_pool_pages or S * n_pages_max
        max_queued_pages = self._requested_max_queued_pages
        if max_queued_pages is None:
            max_queued_pages = 4 * pool_pages
        # tensor-parallel plan: the geometry is checked here (at
        # construction and at every weight swap), a typed ValueError
        # before any request runs
        tp = None
        if self._tp_degree > 1:
            from deeplearning4j_tpu_torch.serving.tp_engine import TPPlan

            tp = TPPlan(net, plan, self._tp_degree)
        self._tp = tp
        self._plan = plan
        self._net = net
        self._params = net._params
        # compute-dtype copies made once: the steps reuse them; under
        # tensor parallelism the blocks' copies are split over the slots
        self._bparams = plan.cast_blocks(net._params)
        self._sparams = tp.shard_params(self._bparams) if tp is not None \
            else self._bparams
        self.max_len = L
        self.page_size = page
        self.pool_pages = pool_pages
        self.max_queued_pages = max_queued_pages
        self.prefill_chunk = C
        self._chunk_enabled = chunk_enabled
        self._n_pages_max = n_pages_max
        self._L_logical = L_logical
        self.prompt_buckets = buckets
        itemsize = torch.empty((), dtype=plan.cdt).element_size()
        self._kv_quant_bits = 8 if self._kv_quant else 8 * itemsize
        self._kv_bytes_per_token = kv_bytes_per_token(
            plan.kv_geometry(), self._kv_quant, itemsize)
        self._rows = torch.arange(S, device=self.device)
        # the served weights' digest: handoffs carry it and are refused
        # on a mismatch, so KV computed under other weights never binds
        self._weight_version = weight_digest(net._params)
        # latency tier: prefix cache + speculative decoder are built with
        # the geometry
        self._prefix_cache = None
        if self._prefix_cache_cfg is not None \
                and self._prefix_cache_cfg is not False:
            from deeplearning4j_tpu_torch.serving.prefix_cache import (
                PrefixCache,
            )

            pc_kw = {} if self._prefix_cache_cfg is True \
                else dict(self._prefix_cache_cfg)
            self._prefix_cache = PrefixCache(page, **pc_kw) \
                .bind_guard(self._cond).bind_recorder(self.recorder) \
                .bind_version(self._weight_version)
            if self._prefix_directory is not None:
                # a rebuild keeps the cluster membership: the fresh cache
                # publishes under the new weight version as it warms
                self._prefix_cache.bind_directory(self._prefix_directory,
                                                  self._holder_id)
        self._spec = None
        if self._speculative_cfg is not None:
            from deeplearning4j_tpu_torch.serving.speculative import (
                SpeculativeDecoder,
                resolve_draft_net,
            )

            cfg = dict(self._speculative_cfg)
            draft = cfg.pop("draft", None)
            if draft is None:
                draft = cfg.pop("net", None)  # alias; both given ->
                # "net" survives into the unknown-option check below
            k = int(cfg.pop("k", 4))
            if cfg:
                raise ValueError(
                    f"unknown speculative options {sorted(cfg)}")
            self._spec = SpeculativeDecoder(
                target_plan=plan, target_net=net,
                draft_net=resolve_draft_net(draft, net), k=k, n_slots=S,
                page=page, L_logical=L_logical, pool_pages=pool_pages,
                top_k=self.top_k, kv_quant=self._kv_quant,
                target_bparams=self._bparams, tp=tp,
                tp_params=self._sparams if tp is not None else None)
        self._reset_device_state()

    def _reset_device_state(self) -> None:
        """Fresh page pools, page table and per-slot state. Callers
        guarantee no slot holds a request; queued requests keep their
        reservations (they hold no device state)."""
        S, dev, P = self.n_slots, self.device, self.pool_pages
        self._caches = _new_pools(self._plan, P, self.page_size,
                                  self._kv_quant, dev)
        if self._tp is not None:
            # the pools' head axis (axis 1 of every pool) split over the
            # slots: each owns Hkv/N heads of every page
            self._caches = [tuple(self._tp.shard_pool(x) for x in c)
                            for c in self._caches]
        self._page_table = torch.zeros((S, self._n_pages_max),
                                       dtype=torch.int32, device=dev)
        self._tok = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._pos = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._temps = np.zeros((S,), np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * S
        with self._cond:
            self._free_pages = list(range(P, 0, -1))  # guarded by: _cond
            self._active = np.zeros((S,), bool)  # guarded by: _cond
            if self._prefix_cache is not None:
                # the pools just rebuilt: every cached page id is stale
                self._prefix_cache.clear()
            # leased page ids index the pools that just went: their
            # ownership is void (the free list is whole again), but the
            # payloads stay fetchable for a receiver mid-resume
            self._leases.invalidate_pages()
        if self._spec is not None:
            self._spec.reset_state()

    def _embed(self, ids, positions):
        """Token (+ positional) embedding in the compute dtype; positions
        past the learned table are clamped to its last row (they only
        occur on masked pad or inactive lanes)."""
        emb, bp = self._plan.emb, self._bparams
        x = bp[0]["W"][ids]
        if emb.positional:
            x = x + bp[0]["P"][positions.clamp(max=emb.max_length - 1).long()]
        return x.to(self._plan.cdt)

    def _first_token(self, slot: int, req: _GenRequest, logits, t0: int):
        """Draw a request's first token from its prefill logits and arm
        the slot: token, position, sampling generator, temperature. A
        fresh request's generator is seeded with its seed; a preempted or
        cold-resumed one keeps drawing from the generator it carries, so
        its stream goes on where it stopped. Returns (token, finite
        flag, logprob triple or None)."""
        from deeplearning4j_tpu_torch.models.transformer import _sample_logits

        gen = req.gen if req.gen is not None else \
            torch.Generator(device=self.device).manual_seed(req.seed)
        req.gen = gen
        tok0 = _sample_logits(logits, gen, req.temperature, self.top_k)
        self._tok[slot] = tok0[0]
        self._pos[slot] = t0
        self._gens[slot] = gen
        self._temps[slot] = req.temperature
        lp = _lp_math(logits, tok0, self._logprobs_k) \
            if self._logprobs_k else None
        return tok0[0], torch.isfinite(logits.float()).all(), lp

    @torch.no_grad()
    def _prefill_math(self, slot: int, req: _GenRequest, ids: np.ndarray,
                      wpids: List[int]):
        """One-shot prefill of one prompt padded to `ids` (1, bucket):
        the same block math as `generate`'s prefill, K/V written into
        the slot's pages. Returns the first token, its finite flag and
        its logprob triple (None without logprobs)."""
        from deeplearning4j_tpu_torch.models.transformer import (
            _block_ffn,
            _block_heads,
            _block_out_proj,
            _prefill_block_attention,
        )

        from deeplearning4j_tpu_torch.serving.tp_engine import run_blocks

        plan, dev, page = self._plan, self.device, self.page_size
        P = ids.shape[1]
        t0 = req.prompt.shape[0]
        qpos = torch.arange(P, device=dev)
        x = self._embed(torch.as_tensor(ids, device=dev), qpos)

        def blocks(bp, caches, x, shard, axis_name):
            for bi, i in enumerate(plan.block_is):
                p, layer = bp[i], plan.layers[i]
                q, k, v = _block_heads(layer, p, x, qpos, shard=shard)
                att = _prefill_block_attention(layer, q, k, v)
                x = _block_ffn(layer, p, x + _block_out_proj(
                    p, att.reshape(1, P, -1), axis_name), axis_name)
                _write_span(caches[bi], k.permute(0, 2, 3, 1),
                            v.permute(0, 2, 1, 3), wpids, 0, page)
            return x

        x = run_blocks(self._tp, blocks, self._sparams, self._caches, x)
        logits = plan.final_logits(self._bparams, self._params,
                                   x[0, t0 - 1][None])
        return self._first_token(slot, req, logits, t0)

    @torch.no_grad()
    def _prefill_chunk_math(self, slot: int, req: _GenRequest,
                            ids: np.ndarray, off: int, woff: int,
                            wpids: List[int], final: bool):
        """One prefill chunk at absolute positions off..off+W-1: write
        its K/V into `wpids`, then attend through the slot's page row
        (the chunk sees itself through the cache, which is exactly
        causal). Returns (first token or None, finite flag, logprob
        triple or None)."""
        from deeplearning4j_tpu_torch.models.transformer import (
            _block_ffn,
            _block_heads,
            _block_out_proj,
        )
        from deeplearning4j_tpu_torch.ops.attention import (
            paged_attention_chunk_auto,
        )

        from deeplearning4j_tpu_torch.serving.tp_engine import run_blocks

        plan, dev, page = self._plan, self.device, self.page_size
        W = ids.shape[1]
        qpos = off + torch.arange(W, device=dev)
        x = self._embed(torch.as_tensor(ids, device=dev), qpos)
        page_row = self._page_table[slot:slot + 1]
        pos0 = torch.tensor([off], dtype=torch.int32, device=dev)

        def blocks(bp, caches, x, shard, axis_name):
            for bi, i in enumerate(plan.block_is):
                p, layer = bp[i], plan.layers[i]
                q, k, v = _block_heads(layer, p, x, qpos, shard=shard)
                cache = caches[bi]
                _write_span(cache, k.permute(0, 2, 3, 1),
                            v.permute(0, 2, 1, 3), wpids, woff, page)
                att = paged_attention_chunk_auto(q, cache[0], cache[1],
                                                 page_row, pos0,
                                                 **_scales(cache))
                x = _block_ffn(layer, p, x + _block_out_proj(
                    p, att.reshape(1, W, -1), axis_name), axis_name)
            return x

        x = run_blocks(self._tp, blocks, self._sparams, self._caches, x)
        ok = torch.isfinite(x.float()).all()
        if not final:
            return None, ok, None
        t0 = req.prompt.shape[0]
        r = min(max(t0 - 1 - off, 0), W - 1)
        logits = plan.final_logits(self._bparams, self._params,
                                   x[0, r][None])
        tok0, ok_logits, lp = self._first_token(slot, req, logits, t0)
        return tok0, ok & ok_logits, lp

    @torch.no_grad()
    def _decode_math(self, active_t):
        """Advance every slot one token. Inactive slots keep their token
        and position, and their cache writes go to the trash page 0, so a
        reallocated page is never corrupted. Returns (tokens (S,),
        per-slot finite flags (S,), logprob triple or None)."""
        from deeplearning4j_tpu_torch.models.transformer import (
            _block_ffn,
            _block_heads,
            _block_out_proj,
            _sample_logits,
        )
        from deeplearning4j_tpu_torch.ops.attention import (
            paged_attention_step_auto,
        )

        from deeplearning4j_tpu_torch.serving.tp_engine import run_blocks

        plan, page = self._plan, self.page_size
        tok, pos, table = self._tok, self._pos, self._page_table
        x = self._embed(tok, pos)
        wpos = pos.clamp(max=self._L_logical - 1).long()
        lpage, loff = wpos // page, wpos % page
        pids = torch.where(active_t, table[self._rows, lpage].long(), 0)

        def blocks(bp, caches, x, shard, axis_name):
            for bi, i in enumerate(plan.block_is):
                p, layer = bp[i], plan.layers[i]
                q, k, v = _block_heads(layer, p, x[:, None, :],
                                       pos[:, None], shard=shard)
                q, k, v = q[:, 0], k[:, 0], v[:, 0]
                cache = caches[bi]
                _write_step(cache, pids, loff, k, v)
                att = paged_attention_step_auto(q, cache[0], cache[1],
                                                table, pos, active_t,
                                                **_scales(cache))
                x = _block_ffn(layer, p, x + _block_out_proj(
                    p, att, axis_name), axis_name)
            return x

        x = run_blocks(self._tp, blocks, self._sparams, self._caches, x)
        logits = plan.final_logits(self._bparams, self._params, x)
        nxt = torch.argmax(logits, dim=-1)
        for s in np.flatnonzero((self._temps > 0) & self._active):
            nxt[s] = _sample_logits(logits[s:s + 1], self._gens[s],
                                    float(self._temps[s]), self.top_k)[0]
        self._tok = torch.where(active_t, nxt, tok)
        self._pos = torch.where(active_t, pos + 1, pos)
        ok = torch.isfinite(logits.float()).all(dim=-1) | ~active_t
        lp = _lp_math(logits, self._tok, self._logprobs_k) \
            if self._logprobs_k else None
        return self._tok, ok, lp

    # -- paging arithmetic -------------------------------------------------
    def _bucket_for(self, t0: int) -> int:
        for b in self.prompt_buckets:
            if b >= t0:
                return b
        return _bucket(t0, self.max_len)  # pow-2 fallback past the buckets

    def _is_chunked(self, t0: int) -> bool:
        return self._chunk_enabled and t0 > self.prompt_buckets[-1] \
            and t0 > self.prefill_chunk

    def _prefill_width(self, t0: int) -> int:
        C = self.prefill_chunk
        return -(-t0 // C) * C if self._is_chunked(t0) \
            else self._bucket_for(t0)

    def _pages_for(self, t0: int, n_tokens: int) -> int:
        """Pages a request must hold: its padded prefill width or its
        prompt + output KV span, whichever is larger (the last generated
        token is never written back, hence n_tokens - 1)."""
        span = max(self._prefill_width(t0), t0 + n_tokens - 1)
        return -(-span // self.page_size)

    def _pages_for_hit(self, t0: int, n_tokens: int) -> int:
        """Total LOGICAL pages of a prefix-hit request (shared + owned):
        the hit path suffix-prefills in chunks whose padded tail never
        runs past page * ceil(t0 / page), so the span is just the KV the
        request actually writes — always <= the cold `_pages_for`."""
        return -(-(t0 + n_tokens - 1) // self.page_size)

    def _free_request_pages_locked(self, req: _GenRequest) -> None:
        """Drop the request's page references: owned pages return to the
        free list; shared (cached) pages only lose this request's
        refcount — the cache keeps them resident until LRU reclaim, and a
        prefix another slot still shares is never freed here."""
        assert_owned(self._cond, "DecodeEngine._free_request_pages_locked")
        if req.nodes:
            self._prefix_cache.release(req.nodes)
            req.nodes = None
        if req.pages:
            self._free_pages.extend(req.pages[req.n_shared:])
        req.pages = None

    def _promote_prefix_locked(self, req: _GenRequest) -> None:
        """After a successful prefill, publish the prompt's fully covered
        pages into the prefix cache so the NEXT same-prefix request
        shares them (the request itself keeps decoding on them; page
        ownership moves to the cache, refcounted)."""
        assert_owned(self._cond, "DecodeEngine._promote_prefix_locked")
        if self._prefix_cache is None or req.pages is None:
            return
        req.nodes, freed = self._prefix_cache.insert(req.prompt, req.pages,
                                                     req.nodes or [],
                                                     tenant=req.tenant)
        req.n_shared = len(req.nodes)
        # pages evicted to respect the cache's max_pages cap go straight
        # back to the pool — a cap-driven eviction must never leak
        self._free_pages.extend(freed)

    # -- observability -----------------------------------------------------
    def _finish_obs(self, req: _GenRequest,
                    err: Optional[BaseException] = None, **attrs) -> None:
        """Terminal path of one request: stamp the timeline's decision,
        attach it to the typed error, ring the flight recorder, deliver.
        Host-side work only."""
        decision = "served" if err is None else type(err).__name__
        req.trace.finish(decision)
        if err is not None:
            observability.attach_trace(err, req.trace)
        self.recorder.record(req.trace, decision, kind="generate",
                             tokens=len(req.tokens), **attrs)
        req.finish(err)

    def _shed_obs(self, trace, err: BaseException, **attrs) -> None:
        """Door-shed path (no request handle yet): finish the timeline
        with the typed decision and pin it in the failures ring."""
        decision = type(err).__name__
        trace.finish(decision)
        observability.attach_trace(err, trace)
        self.recorder.record(trace, decision, kind="generate", **attrs)

    def _emit_token(self, req: _GenRequest, lp=None, lp_idx: int = 0) -> None:
        """Bookkeeping for the token just appended to `req.tokens`: its
        logprob entry (when the request asked for K > 0; `lp` is the
        host (chosen, top values, top ids) batch, `lp_idx` this token's
        row), the time to first token, and the request's `on_token`
        sink. A raising sink is a consumer bug: it is logged and
        detached, and the unary result still delivers."""
        if lp is not None and req.logprobs:
            kk = req.logprobs
            chosen, top_v, top_i = lp
            req.logprob_values.append({
                "token": int(req.tokens[-1]),
                "logprob": float(chosen[lp_idx]),
                "top_tokens": [int(t) for t in top_i[lp_idx][:kk]],
                "top_logprobs": [float(v) for v in top_v[lp_idx][:kk]],
            })
        if len(req.tokens) == 1 and req.resumed_at == 0 \
                and not req.preempted:
            # a resumed or preempted request paid its time to first
            # token where it started
            self._ttft_hist.observe(
                1e3 * (time.monotonic() - req.enqueued_at), trace=req.trace)
        sink = req.sink
        if sink is not None:
            entry = req.logprob_values[-1] \
                if req.logprobs and req.logprob_values else None
            try:
                sink(len(req.tokens), req.tokens[-1], entry)
            # a broken sink costs the consumer its stream, not the engine
            # its loop: logged, detached, decoding goes on
            except Exception:
                logger.exception(
                    "decode engine: token sink failed; detaching it")
                req.sink = None

    def flight_record(self) -> dict:
        """The flight recorder's dump (request timelines and scheduler
        events), shared with the owning `ModelServer` when there is
        one."""
        return self.recorder.dump()

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def metrics_text(self, labels=None) -> str:
        return self.metrics.exposition(labels=labels)

    # -- public surface ----------------------------------------------------
    def submit(self, prompt_ids, n_tokens: int, *,
               temperature: float = 0.0, seed: int = 0,
               timeout: Optional[float] = None,
               tenant: Optional[str] = None,
               priority: str = "interactive",
               logprobs: int = 0,
               on_token: Optional[Callable] = None) -> _GenRequest:
        """Admit one generation request (non-blocking). Typed give-ups:
        `ServerOverloadedError` (queue full), `OutOfPagesError` (queued
        page demand over `max_queued_pages`), `TenantQuotaExceededError`
        (this tenant's own token or page budget is spent),
        `DeadlineExceededError` (already expired, or the SLO estimate
        proves it cannot be met), `ServiceUnavailableError` (breaker
        open), `ServerClosedError`; on a decode-role engine
        `KVTransferError`. `priority` is "interactive" or "batch": the
        batch lane fills idle slots and yields them under interactive
        pressure. `logprobs=K` (at most the engine's `logprobs`) asks for
        per-token logprob entries; `on_token(cursor, token, entry)` is
        called from the scheduler thread per emitted token and must not
        block. `request.result()` blocks for the tokens."""
        if priority not in ("interactive", "batch"):
            raise ValueError(f"priority must be 'interactive' or 'batch', "
                             f"got {priority!r}")
        if logprobs < 0:
            raise ValueError("logprobs must be >= 0")
        if logprobs > self._logprobs_k:
            raise ValueError(
                f"logprobs={logprobs} exceeds the engine's configured "
                f"logprobs={self._logprobs_k} — build the engine with "
                "logprobs=K to enable per-token logprob returns")
        prompt = np.asarray(prompt_ids)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError(f"submit expects one 1-D prompt of token ids, "
                             f"got shape {prompt.shape}")
        if n_tokens < 1:
            raise ValueError("n_tokens must be >= 1")
        T0 = prompt.shape[0]
        if T0 + n_tokens > self.max_len:
            raise ValueError(
                f"prompt ({T0}) + n_tokens ({n_tokens}) exceeds the engine's "
                f"max_len {self.max_len} — raise max_len or shorten the "
                "request")
        need = self._pages_for(T0, n_tokens)
        if need > self.pool_pages:
            raise ValueError(
                f"request needs {need} KV pages of {self.page_size} tokens "
                f"but the pool holds only {self.pool_pages} — raise "
                "pool_pages or shorten the request")
        if self._role == "decode":
            from deeplearning4j_tpu_torch.serving.kv_transfer import (
                KVTransferError,
            )

            raise KVTransferError(
                "decode-role engine accepts only resume_generate handoffs, "
                "not fresh prompts — route prefills to a prefill-role "
                "replica")
        trace = observability.maybe_trace()
        with self._cond:
            if self._closed:  # before the breaker: a closed engine says
                # "closed" (terminal), not "retry later"
                err = ServerClosedError("decode engine is shut down")
                self._shed_obs(trace, err)
                raise err
        if self.breaker is not None:
            try:
                self.breaker.reject_if_open()
            except ServiceUnavailableError as e:
                with self._cond:
                    self.shed_unavailable += 1
                self._shed_obs(trace, e)
                raise
        timeout = self.default_timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        req = _GenRequest(prompt.astype(np.int64), int(n_tokens),
                          float(temperature), int(seed), deadline,
                          tenant=tenant, priority=priority)
        req.n_pages = need
        req.trace = trace
        req.logprobs = int(logprobs)
        req.sink = on_token
        # a prefill-role engine never decodes: the finished prefill
        # leaves under a lease and the caller is redirected
        req.handoff = self._role == "prefill"
        if self._prefix_directory is not None \
                and self._prefix_peers is not None:
            # the cluster fetch rides the submit thread: wire work never
            # stalls the scheduler. _admit binds the verified bundle, or
            # drops it and prefills cold
            req.prefix_import = self._fetch_prefix_for(req.prompt, tenant)
        with self._cond:
            if self._closed:
                err = ServerClosedError("decode engine is shut down")
                self._shed_obs(trace, err)
                raise err
            now = time.monotonic()
            # door order: expired entries are swept and the request's own
            # deadline judged before any capacity verdict; then the
            # tenant's own quota, the SLO estimate, and only then the
            # shared queue and page limits
            if len(self._queue) >= self.max_queue \
                    or (self._pages_demand_queued
                        and self._pages_demand_queued + need
                        > self.max_queued_pages):
                self._sweep_expired_locked(now)
            if deadline is not None and deadline <= now:
                self.shed_deadline += 1
                err = DeadlineExceededError(
                    "deadline expired before admission; request shed at "
                    "the door")
                self._shed_obs(trace, err)
                raise err
            tstate = self._tenant_locked(tenant)
            if tstate is not None and tstate.rate:
                tstate.refill(now)
                if tstate.tokens < n_tokens:
                    tstate.shed_quota += 1
                    self.shed_quota += 1
                    retry = max(0.001,
                                (n_tokens - tstate.tokens) / tstate.rate)
                    err = TenantQuotaExceededError(
                        f"tenant {tenant!r} token-rate quota exhausted "
                        f"({tstate.tokens:.0f} of {n_tokens} tokens "
                        f"available at {tstate.rate:.0f} tok/s); retry "
                        f"in {retry:.3f}s", retry_after=retry)
                    self._shed_obs(trace, err, tenant=tenant,
                                   bucket_tokens=round(tstate.tokens, 1),
                                   rate=tstate.rate, n_tokens=int(n_tokens))
                    self.recorder.event(
                        "quota-shed", tenant=tenant,
                        bucket_tokens=round(tstate.tokens, 1),
                        rate=tstate.rate, n_tokens=int(n_tokens))
                    raise err
            if tstate is not None and tstate.max_pages is not None:
                # the tenant's reservations (queued and resident) may not
                # pass max_pages; recomputed from the live queue and
                # slots, so the count cannot leak
                live = self._tenant_pages_locked(tenant)
                if live + need > tstate.max_pages:
                    tstate.shed_page_quota += 1
                    self.shed_page_quota += 1
                    retry = max(0.001, self._step_ewma
                                * (len(self._queue) + 1))
                    err = TenantQuotaExceededError(
                        f"tenant {tenant!r} KV page quota exhausted "
                        f"({live} of {tstate.max_pages} pages reserved; "
                        f"{need} more needed); retry in {retry:.3f}s",
                        retry_after=retry)
                    self._shed_obs(trace, err, tenant=tenant,
                                   pages_reserved=live,
                                   max_pages=tstate.max_pages,
                                   pages_needed=need)
                    self.recorder.event(
                        "quota-shed", tenant=tenant, resource="pages",
                        pages_reserved=live, max_pages=tstate.max_pages,
                        pages_needed=need)
                    raise err
            if self._slo_shed_enabled and deadline is not None \
                    and self.decode_steps:
                # can the request provably not meet its deadline? The
                # estimate rests on observed EWMAs: the queue wait, its
                # prefill chunks and its tokens
                n_chunks = -(-T0 // self.prefill_chunk) \
                    if self._is_chunked(T0) else 1
                est = self._queue_wait_ewma \
                    + n_chunks * self._chunk_ewma \
                    + n_tokens * self._step_ewma
                if now + est > deadline:
                    self.slo_sheds += 1
                    err = DeadlineExceededError(
                        f"deadline unmeetable: needs ~{est:.3f}s "
                        f"(queue {self._queue_wait_ewma:.3f}s + "
                        f"{n_chunks} prefill chunks + {n_tokens} decode "
                        f"steps) but only {max(0.0, deadline - now):.3f}s "
                        "remain; shed before prefill")
                    self._shed_obs(trace, err, estimate_s=round(est, 4),
                                   queue_wait_ewma_s=round(
                                       self._queue_wait_ewma, 4),
                                   prefill_chunks=n_chunks,
                                   step_ewma_s=round(self._step_ewma, 5))
                    self.recorder.event(
                        "slo-shed", tenant=tenant, estimate_s=round(est, 4),
                        queue_wait_ewma_s=round(self._queue_wait_ewma, 4),
                        prefill_chunks=n_chunks,
                        step_ewma_s=round(self._step_ewma, 5),
                        budget_s=round(max(0.0, deadline - now), 4))
                    raise err
            if len(self._queue) >= self.max_queue:
                self.shed_overload += 1
                retry = max(0.001, self._step_ewma
                            * (len(self._queue) / self.n_slots + 1))
                err = ServerOverloadedError(
                    f"generation queue full ({self.max_queue} pending); "
                    f"retry in {retry:.3f}s", retry_after=retry)
                self._shed_obs(trace, err, queue_depth=len(self._queue))
                raise err
            if self._pages_demand_queued \
                    and self._pages_demand_queued + need \
                    > self.max_queued_pages:
                # a lone waiter always queues: only aggregate demand sheds
                self.shed_out_of_pages += 1
                held = self.pool_pages - len(self._free_pages)
                n_live = sum(1 for r in self._slots if r is not None)
                retry = max(0.001, self._step_ewma
                            * (len(self._queue) + n_live + 1))
                err = OutOfPagesError(
                    f"KV page pool exhausted ({held}/{self.pool_pages} pages "
                    f"in use, {self._pages_demand_queued} queued demand of "
                    f"{self.max_queued_pages} allowed; {need} more needed); "
                    f"retry in {retry:.3f}s", retry_after=retry)
                demand = self._pages_demand_queued
                self._shed_obs(trace, err, pages_needed=need,
                               pages_in_use=held, queued_page_demand=demand,
                               max_queued_pages=self.max_queued_pages)
                self.recorder.event(
                    "shed", error="OutOfPagesError", pages_needed=need,
                    pages_in_use=held, queued_page_demand=demand,
                    max_queued_pages=self.max_queued_pages)
                raise err
            # the bucket is debited only once every door has passed: a
            # request shed by a shared limit must not burn its budget
            if tstate is not None:
                if tstate.rate:
                    tstate.tokens -= n_tokens
                tstate.submitted += 1
            self._pages_demand_queued += need
            self.submitted += 1
            self._queue.append(req)
            trace.event("enqueue", queue_depth=len(self._queue),
                        pages_reserved=need, prompt_len=int(T0),
                        n_tokens=int(n_tokens))
            self._cond.notify_all()
        return req

    def _tenant_locked(self, tenant: Optional[str]):
        """This tenant's ledger (made on first sight with the `default`
        quota), or None for untenanted traffic, which is unlimited."""
        assert_owned(self._cond, "DecodeEngine._tenant_locked")
        if tenant is None:
            return None
        state = self._tenants.get(tenant)
        if state is None:
            spec = self._default_quota or {}
            state = _TenantState(rate=spec.get("rate"),
                                 burst=spec.get("burst"),
                                 max_pages=spec.get("max_pages"),
                                 weight=spec.get("weight"))
            self._tenants[tenant] = state
        return state

    def _tenant_pages_locked(self, tenant: str) -> int:
        """Pages reserved by `tenant`: queued demand plus every resident
        request's reservation."""
        assert_owned(self._cond, "DecodeEngine._tenant_pages_locked")
        return sum(r.n_pages for r in self._queue if r.tenant == tenant) \
            + sum(r.n_pages for r in self._slots
                  if r is not None and r.tenant == tenant)

    def _sweep_expired_locked(self, now: float) -> None:
        """Shed every already-expired queued request with its own
        `DeadlineExceededError`, releasing its page reservation and any
        prefix pins a delta handoff took."""
        assert_owned(self._cond, "DecodeEngine._sweep_expired_locked")
        if not any(r.expired(now) for r in self._queue):
            return
        keep: collections.deque = collections.deque()
        for req in self._queue:
            if req.expired(now):
                self._pages_demand_queued -= req.n_pages
                self._free_request_pages_locked(req)
                self.shed_deadline += 1
                req.trace.add_timed("queue-wait", req.enqueued_at, now,
                                    decision="expired")
                self._finish_obs(req, DeadlineExceededError(
                    "deadline expired while queued; request shed before "
                    "prefill"))
            else:
                keep.append(req)
        self._queue = keep

    def set_tenant_quota(self, tenant: str, rate: Optional[float] = None,
                         burst: Optional[float] = None,
                         max_pages: Optional[int] = None,
                         weight: Optional[float] = None) -> None:
        """Install (or with `rate=None` clear) a tenant's token-rate
        quota, with `max_pages` its page ceiling (None clears it) and
        with `weight` its batch-lane share (None keeps it). The bucket
        restarts full; the counters survive."""
        if weight is not None and float(weight) <= 0:
            raise ValueError("tenant weight must be > 0")
        with self._cond:
            state = self._tenant_locked(tenant)
            state.rate = None if rate is None else float(rate)
            state.burst = float(burst) if burst is not None \
                else (state.rate if state.rate else 0.0)
            state.tokens = state.burst
            state.max_pages = None if max_pages is None else int(max_pages)
            if weight is not None:
                state.weight = float(weight)
            state.last_refill = time.monotonic()
        self.recorder.event("quota-set", tenant=tenant, rate=rate,
                            burst=burst, max_pages=max_pages, weight=weight)

    # -- cluster prefix cache (prefix_directory) ----------------------------
    def bind_prefix_directory(self, directory, holder_id: str,
                              peers: Optional[Callable] = None, *,
                              fetch_timeout: float = 5.0,
                              frame_pages: int = 8,
                              min_fetch_pages: int = 1) -> "DecodeEngine":
        """Join a cluster `PrefixDirectory`: the prefix cache publishes
        its promoted chains under `holder_id` (and retracts on evict and
        clear), and with `peers` a local miss with a directory hit
        fetches the chain's pages from the holder instead of
        prefilling them. `peers(holder_id)` gives an engine-shaped handle
        (`export_prefix`, `fetch_handoff_frame`, `commit_handoff`,
        `abort_handoff`) or None. Any fetch failure degrades to cold
        prefill. Chainable."""
        with self._cond:
            self._prefix_directory = directory
            self._holder_id = str(holder_id)
            self._prefix_peers = peers
            self._prefix_fetch_timeout = float(fetch_timeout)
            self._prefix_fetch_frame_pages = max(1, int(frame_pages))
            self._prefix_min_fetch_pages = max(1, int(min_fetch_pages))
            if self._prefix_cache is not None:
                self._prefix_cache.bind_directory(directory, self._holder_id)
                chains = self._prefix_cache.chains()
                if chains:  # a late bind announces what is already warm
                    directory.publish(self._weight_version, self.page_size,
                                      chains, self._holder_id)
        return self

    def prefix_depth(self, prompt_ids, tenant: Optional[str] = None) -> int:
        """Fully covered resident prefix pages this engine holds for
        `prompt_ids` under its current weights: what a delta sender asks
        before choosing `skip_pages`."""
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        with self._cond:
            if self._prefix_cache is None:
                return 0
            return len(self._prefix_cache.match(prompt, tenant=tenant))

    def prefix_chains(self) -> dict:
        """Every resident chain key under the current weights: the
        pull-mode directory refresh."""
        with self._cond:
            chains = [] if self._prefix_cache is None \
                else self._prefix_cache.chains()
            return {"weight_version": self._weight_version,
                    "page_size": self.page_size, "chains": chains}

    def export_prefix(self, prompt_ids, have_pages: int = 0,
                      tenant: Optional[str] = None,
                      frame_pages: Optional[int] = None,
                      timeout: Optional[float] = None) -> dict:
        """Holder side of a cluster prefix fetch: the resident chain
        pages for `prompt_ids` past the receiver's `have_pages`, leased
        as a ``kind="prefix"`` handoff; returns its framed header. The
        pool read runs on the scheduler thread (a parked work item);
        this caller waits up to `timeout`. `KVTransferError` when the
        chain is no longer resident past `have_pages`."""
        from deeplearning4j_tpu_torch.serving.kv_transfer import (
            KVTransferError,
        )

        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        item = {"prompt": prompt, "have": max(0, int(have_pages)),
                "tenant": tenant, "frame_pages": frame_pages,
                "done": threading.Event(), "result": None, "error": None}
        with self._cond:
            if self._closed:
                raise ServerClosedError("decode engine is shut down")
            self._prefix_exports.append(item)
            self._cond.notify_all()
        wait = self._prefix_fetch_timeout if timeout is None \
            else float(timeout)
        if not item["done"].wait(wait):
            raise KVTransferError(
                f"prefix export timed out after {wait:.1f}s (scheduler "
                "busy); fall back to cold prefill")
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _touch_lease(self, handoff_id: str):
        from deeplearning4j_tpu_torch.serving.kv_transfer import (
            KVTransferError,
        )

        assert_owned(self._cond, "DecodeEngine._touch_lease")
        lease = self._leases.touch(handoff_id)
        if lease is None:
            raise KVTransferError(
                f"unknown or expired handoff lease {handoff_id!r}; fall "
                "back to re-prefill from the prompt")
        return lease

    def fetch_handoff_header(self, handoff_id: str, skip_pages: int = 0,
                             frame_pages: Optional[int] = None) -> dict:
        """The blockless header of any leased handoff, advanced by
        `skip_pages` pages the receiver holds (delta transfer). Extends
        the lease."""
        from deeplearning4j_tpu_torch.serving import kv_transfer

        with self._cond:
            lease = self._touch_lease(handoff_id)
            return kv_transfer.payload_header(
                lease.payload, skip_pages=skip_pages,
                frame_pages=frame_pages)

    def fetch_handoff_frame(self, handoff_id: str, frame: int,
                            skip_pages: int = 0,
                            frame_pages: Optional[int] = None) -> dict:
        """One bounded frame of a leased handoff (host numpy slicing).
        Extends the lease, so a receiver mid-drain cannot lose the race
        against the sweep."""
        from deeplearning4j_tpu_torch.serving import kv_transfer

        with self._cond:
            lease = self._touch_lease(handoff_id)
            return kv_transfer.slice_frame(
                lease.payload, frame, skip_pages=skip_pages,
                frame_pages=frame_pages)

    def _fetch_prefix_for(self, prompt: np.ndarray,
                          tenant: Optional[str]) -> Optional[dict]:
        """Submit-thread cluster prefix fetch: on a local miss with a
        directory hit, pull the chain's missing pages from a holder and
        return a verified ``{"payload", "have", "depth", "source"}``
        bundle for `_admit` to bind. Returns None, never raises, on any
        miss, skew or wire failure: the request then prefills cold."""
        t0 = int(prompt.shape[0])
        page = self.page_size
        cap = max(0, (t0 - 1) // page)
        if cap < self._prefix_min_fetch_pages:
            return None
        with self._cond:
            if self._prefix_cache is None:
                return None
            local = len(self._prefix_cache.match(prompt, tenant=tenant))
        if cap - local < self._prefix_min_fetch_pages:
            return None
        hit = self._prefix_directory.best_holder(
            prompt, tenant, exclude=(self._holder_id,))
        if hit is None or hit["weight_version"] != self._weight_version \
                or int(hit["page_size"]) != page:
            return None
        depth = min(int(hit["depth"]), cap)
        if depth - local < self._prefix_min_fetch_pages:
            return None
        holder = hit["holders"][0]
        # single flight per chain: one admit pulls the pages, the rest
        # wait (bounded by the fetch timeout) and re-check the cache
        sf_key = (hit["weight_version"], tenant,
                  np.asarray(prompt[:depth * page], np.int32).tobytes())
        sf_deadline = time.monotonic() + self._prefix_fetch_timeout
        with self._cond:
            while sf_key in self._prefix_fetching:
                remaining = sf_deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            if self._prefix_cache is None:
                return None
            local = len(self._prefix_cache.match(prompt, tenant=tenant))
            if depth - local < self._prefix_min_fetch_pages:
                return None  # the winner's bind covers this request
            ready = self._prefix_fetch_ready.get(sf_key)
            if ready is not None:
                bundle, expires = ready
                if time.monotonic() < expires:
                    # the winner's bundle is still on its way to the
                    # cache: share it; later binds are dropped stale
                    self.recorder.event("prefix-fetch", decision="reused",
                                        depth=depth)
                    return dict(bundle)
                del self._prefix_fetch_ready[sf_key]
            self._prefix_fetching.add(sf_key)
        bundle = None
        try:
            bundle = self._fetch_prefix_chain(prompt, tenant, depth, local,
                                              holder)
            return bundle
        finally:
            with self._cond:
                if bundle is not None:
                    now = time.monotonic()
                    for k in [k for k, (_, exp)
                              in self._prefix_fetch_ready.items()
                              if exp <= now]:
                        del self._prefix_fetch_ready[k]
                    self._prefix_fetch_ready[sf_key] = (
                        bundle, now + self._prefix_fetch_timeout)
                self._prefix_fetching.discard(sf_key)
                self._cond.notify_all()

    def _fetch_prefix_chain(self, prompt, tenant, depth, local,
                            holder) -> Optional[dict]:
        """The wire leg of `_fetch_prefix_for`, under the chain's single
        flight: export, frames, verify, commit."""
        from deeplearning4j_tpu_torch.serving import kv_transfer

        page = self.page_size
        start = time.monotonic()
        header = None
        peer = None
        try:
            peer = self._prefix_peers(holder)
            if peer is None:
                return None
            header = peer.export_prefix(
                [int(x) for x in prompt[:depth * page]],
                have_pages=local, tenant=tenant,
                frame_pages=self._prefix_fetch_frame_pages,
                timeout=self._prefix_fetch_timeout)
            frames = [peer.fetch_handoff_frame(
                          header["handoff_id"], i, skip_pages=0,
                          frame_pages=header["frame_pages"])
                      for i in range(int(header["n_frames"]))]
            payload = kv_transfer.assemble_payload(header, frames)
            payload = kv_transfer.verify_payload(
                payload, weight_version=self._weight_version,
                kv_quant=self._kv_quant, page_size=page,
                n_blocks=len(self._caches), max_len=self.max_len,
                kinds=("prefix",))
        # the fetch is never load-bearing: any failure (wire fault,
        # refusal, corruption) degrades to cold prefill, its cause
        # recorded, not raised
        except Exception as e:
            if header is not None:
                try:
                    peer.abort_handoff(header["handoff_id"])
                # best effort on a peer that may be gone: its TTL sweep
                # unpins regardless
                except Exception:
                    pass
            with self._cond:
                self.prefix_fetch_fallbacks += 1
            self.recorder.event(
                "prefix-fetch", decision="fallback", holder=holder,
                depth=depth, have=local, error=type(e).__name__)
            logger.warning("cluster prefix fetch from %s failed (%s: %s); "
                           "cold prefill", holder, type(e).__name__, e)
            return None
        try:
            peer.commit_handoff(header["handoff_id"])
        # the commit only unpins early on the holder; its lease TTL
        # unpins regardless
        except Exception:
            logger.warning("prefix fetch commit_handoff(%s) failed; the "
                           "holder's lease sweep will unpin",
                           header["handoff_id"])
        dt = time.monotonic() - start
        nbytes = kv_transfer.payload_nbytes(payload)
        with self._cond:
            self.prefix_fetches += 1
            self.prefix_fetch_bytes += nbytes
            self.prefix_fetch_seconds += dt
        omitted = int(payload.get("pages_omitted", 0))
        self.recorder.event(
            "prefix-fetch", decision="fetched", holder=holder, depth=depth,
            have=local, pages=int(payload["pages_shipped"]),
            skipped=omitted, bytes=nbytes, ms=round(1e3 * dt, 2))
        return {"payload": payload, "have": omitted, "depth": depth,
                "source": holder}

    # -- KV handoff (kv_transfer) -------------------------------------------
    def migrate_slots(self, wait: Optional[float] = 5.0) -> int:
        """Export every in-flight request (queued, mid-prefill,
        decoding) as a leased handoff: each waiter's `result()` raises
        the `SlotMigratedError` redirect. Returns the number of requests
        marked; waits up to `wait` seconds for the scheduler's pass
        (None or 0: do not wait). An empty engine migrates nothing."""
        with self._cond:
            if self._closed:
                raise ServerClosedError("decode engine is shut down")
            n = len(self._queue) \
                + sum(1 for r in self._slots if r is not None)
            if n == 0:
                return 0
            self._migrate_all = True
            self._cond.notify_all()
            if wait:
                deadline = time.monotonic() + wait
                while self._migrate_all or self._queue \
                        or any(r is not None for r in self._slots):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(min(remaining, 0.05))
        return n

    def fetch_handoff(self, handoff_id: str) -> dict:
        """The leased payload for `handoff_id` (extends the lease).
        `KVTransferError` for an unknown or expired lease."""
        with self._cond:
            return self._touch_lease(handoff_id).payload

    def commit_handoff(self, handoff_id: str) -> bool:
        """The receiver resumed: release the lease and free its pages
        here. False when the lease is already resolved or expired."""
        with self._cond:
            lease = self._leases.resolve(handoff_id)
            if lease is None:
                return False
            self._release_lease_locked(lease)
            self.handoffs_committed += 1
            self._cond.notify_all()
        self.recorder.event("handoff-commit", handoff_id=handoff_id)
        return True

    def abort_handoff(self, handoff_id: str) -> bool:
        """The transfer failed downstream: reclaim the leased pages now
        rather than at the TTL. False when already resolved."""
        with self._cond:
            lease = self._leases.resolve(handoff_id)
            if lease is None:
                return False
            self._release_lease_locked(lease)
            self.handoffs_aborted += 1
            self._cond.notify_all()
        self.recorder.event("handoff-abort", handoff_id=handoff_id)
        return True

    def resume_submit(self, payload: dict,
                      timeout: Optional[float] = None, *,
                      on_token: Optional[Callable] = None) -> _GenRequest:
        """Admit a fetched handoff payload: validate it against this
        engine's weights and geometry (`KVTransferError` on any mismatch
        or corruption, with nothing touched), then queue a request whose
        shipped pages re-bind at admission (warm) or that re-prefills
        from the prompt (cold). The deadline is the smaller of the
        sender's remaining budget and `timeout`. The tenant's token
        quota is not billed again (the sender billed it); its page
        ceiling applies."""
        from deeplearning4j_tpu_torch.serving.kv_transfer import (
            KVTransferError,
            verify_payload,
        )

        if self._role == "prefill":
            raise KVTransferError(
                "prefill-role engine does not accept KV handoffs — route "
                "resumes to a decode-capable replica")
        payload = verify_payload(
            payload, weight_version=self._weight_version,
            kv_quant=self._kv_quant, page_size=self.page_size,
            n_blocks=len(self._caches), max_len=self.max_len)
        prompt = np.asarray(payload["prompt"], np.int64)
        n_tokens = int(payload["n_tokens"])
        rems = [t for t in (payload.get("deadline_remaining"), timeout)
                if t is not None]
        if not rems and self.default_timeout is not None:
            rems = [self.default_timeout]
        deadline = time.monotonic() + min(rems) if rems else None
        req = _GenRequest(prompt, n_tokens, float(payload["temperature"]),
                          int(payload["seed"]), deadline,
                          tenant=payload.get("tenant"),
                          priority=payload.get("priority") or "interactive")
        if req.priority not in ("interactive", "batch"):
            req.priority = "interactive"
        req.trace = observability.maybe_trace()
        req.tokens = [int(t) for t in payload["tokens"]]
        req.resumed_at = int(payload["resumed_at"])
        req.preempted = int(payload["preempted"])
        req.logprobs = int(payload.get("logprobs", 0) or 0)
        if req.logprobs > self._logprobs_k:
            raise KVTransferError(
                f"handoff requests logprobs={req.logprobs} but the "
                f"receiving engine was built with logprobs="
                f"{self._logprobs_k}")
        req.logprob_values = list(payload.get("logprob_values") or [])
        req.sink = on_token
        req.gen = self._restore_generator(payload)
        omitted = 0
        if payload["kind"] == "cold":
            # fold the emitted tokens into the prompt, as a preemption
            # does: the re-prefill reproduces the sequence
            if len(req.tokens) > req.resumed_at:
                req.prompt = np.concatenate(
                    [req.prompt, np.asarray(req.tokens[req.resumed_at:],
                                            np.int64)])
                req.resumed_at = len(req.tokens)
            req.n_pages = self._pages_for(
                req.prompt.shape[0], max(1, n_tokens - req.resumed_at))
        else:
            req.import_state = payload
            omitted = int(payload.get("pages_omitted", 0))
            span = prompt.shape[0] + max(1, n_tokens - req.resumed_at) - 1
            req.n_pages = max(-(-span // self.page_size),
                              omitted + int(payload["pages_shipped"]))
        if req.n_pages > self.pool_pages:
            raise KVTransferError(
                f"handoff needs {req.n_pages} KV pages but the receiving "
                f"pool holds only {self.pool_pages}")
        with self._cond:
            if self._closed:
                err = ServerClosedError("decode engine is shut down")
                self._shed_obs(req.trace, err)
                raise err
            now = time.monotonic()
            if deadline is not None and deadline <= now:
                self.shed_deadline += 1
                err = DeadlineExceededError(
                    "deadline expired before handoff admission")
                self._shed_obs(req.trace, err)
                raise err
            if len(self._queue) >= self.max_queue:
                self.shed_overload += 1
                retry = max(0.001, self._step_ewma
                            * (len(self._queue) / self.n_slots + 1))
                err = ServerOverloadedError(
                    f"generation queue full ({self.max_queue} pending); "
                    f"retry in {retry:.3f}s", retry_after=retry)
                self._shed_obs(req.trace, err)
                raise err
            tstate = self._tenant_locked(req.tenant)
            if tstate is not None:
                if tstate.max_pages is not None:
                    live = self._tenant_pages_locked(req.tenant)
                    if live + req.n_pages > tstate.max_pages:
                        tstate.shed_page_quota += 1
                        self.shed_page_quota += 1
                        err = TenantQuotaExceededError(
                            f"tenant {req.tenant!r} KV page quota "
                            f"exhausted ({live} of {tstate.max_pages} pages "
                            f"reserved; {req.n_pages} more needed)",
                            retry_after=max(0.001, self._step_ewma))
                        self._shed_obs(req.trace, err, tenant=req.tenant)
                        self.recorder.event(
                            "quota-shed", tenant=req.tenant,
                            resource="pages", pages_reserved=live,
                            max_pages=tstate.max_pages,
                            pages_needed=req.n_pages)
                        raise err
                tstate.submitted += 1
            if omitted:
                # delta handoff: the first `omitted` pages are this
                # engine's resident prefix chain; pin them now so an
                # eviction cannot race the bind
                have = [] if self._prefix_cache is None else \
                    self._prefix_cache.match(prompt, tenant=req.tenant)
                if len(have) < omitted:
                    err = KVTransferError(
                        f"delta handoff omits {omitted} prefix pages but "
                        f"only {len(have)} are resident here; re-send "
                        "without skip_pages")
                    self._shed_obs(req.trace, err, tenant=req.tenant)
                    raise err
                have = have[:omitted]
                self._prefix_cache.acquire(have)
                req.nodes = have
                req.n_shared = omitted
            self.submitted += 1
            self._pages_demand_queued += req.n_pages
            self._queue.append(req)
            req.trace.event("resume-enqueue", kind=payload["kind"],
                            handoff_id=payload["handoff_id"],
                            pages_shipped=int(payload["pages_shipped"]),
                            emitted=len(req.tokens))
            self._cond.notify_all()
        return req

    def resume_generate(self, payload: dict,
                        timeout: Optional[float] = None, *,
                        on_token: Optional[Callable] = None):
        """Blocking `resume_submit`: returns only the tail tokens this
        engine generates (the caller splices them after the redirect's
        `tokens`); with logprobs, ``{"tokens", "logprobs"}`` of the
        tail."""
        req = self.resume_submit(payload, timeout=timeout, on_token=on_token)
        already = len(req.tokens)
        already_lp = len(req.logprob_values)
        out = req.result()
        if req.logprobs:
            return {"tokens": out[already:],
                    "logprobs": list(req.logprob_values[already_lp:])}
        return out[already:]

    def _sampler_state(self, req: _GenRequest) -> Optional[dict]:
        """A request's live generator state for a payload, or None."""
        if req.gen is None:
            return None
        return {"state": req.gen.get_state().numpy().copy(),
                "device": self.device.type}

    def _restore_generator(self, payload: dict) -> Optional[torch.Generator]:
        """The generator a resumed request draws from: the shipped state
        on the same kind of device; else, for a payload that carries
        emitted tokens, one seeded from its two-word key (see
        `kv_transfer`'s docstring); None for a request that has drawn
        nothing yet (it is seeded with its seed at its first token)."""
        sampler = payload.get("sampler")
        if sampler is not None and sampler.get("device") == self.device.type:
            gen = torch.Generator(device=self.device)
            gen.set_state(torch.as_tensor(
                np.asarray(sampler["state"], np.uint8)))
            return gen
        if not payload["tokens"]:
            return None
        k = np.asarray(payload.get("key", np.zeros(2)), np.uint64).reshape(-1)
        seed = (int(k[0]) << 32 | int(k[1])) % (1 << 63) if k.size >= 2 \
            else int(payload["seed"])
        return torch.Generator(device=self.device).manual_seed(seed)

    def generate(self, prompt_ids, n_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None,
                 tenant: Optional[str] = None,
                 priority: str = "interactive", logprobs: int = 0,
                 on_token: Optional[Callable] = None):
        """Blocking convenience: submit + wait. Returns the generated
        tokens (1-D int32; shorter than `n_tokens` only on EOS), or with
        `logprobs=K > 0` a dict ``{"tokens", "logprobs"}`` with one entry
        (chosen-token logprob and the top K) per generated token."""
        req = self.submit(prompt_ids, n_tokens, temperature=temperature,
                          seed=seed, timeout=timeout, tenant=tenant,
                          priority=priority, logprobs=logprobs,
                          on_token=on_token)
        out = req.result()
        if logprobs:
            return {"tokens": out, "logprobs": list(req.logprob_values)}
        return out

    def pending(self) -> int:
        """Queued + in-slot generation requests: the engine's share of
        `ModelServer.pending()`."""
        with self._cond:
            return len(self._queue) \
                + sum(1 for r in self._slots if r is not None)

    def stats(self) -> dict:
        with self._cond:
            queued = len(self._queue)
            active = sum(1 for r in self._slots if r is not None)
            held = self.pool_pages - len(self._free_pages)
            demand = self._pages_demand_queued
            used_positions = 0
            for r in self._slots:
                if r is None:
                    continue
                t0 = r.prompt.shape[0]
                used_positions += min(r.prefill_pos, t0) \
                    if r.prefill_pos is not None \
                    else t0 + len(r.tokens) - r.resumed_at
            tenants = {name: state.counters()
                       for name, state in sorted(self._tenants.items())}
            for name, counters in tenants.items():
                counters["pages_reserved"] = self._tenant_pages_locked(name)
            out = {"submitted": self.submitted, "served": self.served,
                   "shed_overload": self.shed_overload,
                   "shed_out_of_pages": self.shed_out_of_pages,
                   "shed_deadline": self.shed_deadline,
                   "shed_unavailable": self.shed_unavailable,
                   "failures": self.failures, "prefills": self.prefills,
                   "prefill_chunks": self.prefill_chunks,
                   "decode_steps": self.decode_steps,
                   "tokens_generated": self.tokens_generated,
                   "swaps": self.swaps,
                   "tp_degree": self._tp_degree,
                   "tp_kv_bytes_per_token_per_shard":
                       self._kv_bytes_per_token // self._tp_degree,
                   # QoS: zero and empty without qos, so the schema never
                   # branches on key presence
                   "preemptions": self.preemptions,
                   "slo_sheds": self.slo_sheds,
                   "shed_quota": self.shed_quota,
                   "shed_page_quota": self.shed_page_quota,
                   "tenants": tenants,
                   # KV handoff
                   "migrations_out": self.migrations_out,
                   "migrations_in": self.migrations_in,
                   "handoffs_committed": self.handoffs_committed,
                   "handoffs_aborted": self.handoffs_aborted,
                   "handoffs_expired": self.handoffs_expired,
                   "handoff_leases": len(self._leases),
                   "handoffs_unfetched": self._leases.unfetched(),
                   "kv_transfer_bytes": self.kv_transfer_bytes,
                   # cluster prefix cache: zero while no directory is bound
                   "prefix_fetches": self.prefix_fetches,
                   "prefix_fetch_fallbacks": self.prefix_fetch_fallbacks,
                   "prefix_fetch_bytes": self.prefix_fetch_bytes,
                   "prefix_fetch_ms": round(
                       1e3 * self.prefix_fetch_seconds, 2),
                   "prefix_exports": self.prefix_exports_served,
                   "cluster_prefix_hit_tokens":
                       self.cluster_prefix_hit_tokens,
                   "cluster_prefix_hit_tokens_pct": round(
                       100.0 * self.cluster_prefix_hit_tokens
                       / self.prompt_tokens, 1) if self.prompt_tokens
                       else 0.0}
            steps, slot_steps = self.decode_steps, self.active_slot_steps
        out.update({
            "slot_occupancy_pct": round(
                100.0 * slot_steps / (steps * self.n_slots), 1)
            if steps else 0.0,
            "n_slots": self.n_slots, "active_slots": active,
            "queued": queued, "max_len": self.max_len,
            "page_size": self.page_size, "pool_pages": self.pool_pages,
            "pages_in_use": held, "pages_in_use_peak": self.pages_in_use_peak,
            "queued_page_demand": demand,
            "max_queued_pages": self.max_queued_pages,
            "page_fragmentation_pct": round(
                100.0 * (1.0 - used_positions / (held * self.page_size)), 1)
            if held else 0.0,
            "prefill_chunk": self.prefill_chunk,
            "kv_quant_bits": self._kv_quant_bits,
            "kv_bytes_per_token": self._kv_bytes_per_token,
            "prompt_buckets": list(self.prompt_buckets)})
        with self._cond:
            if self._prefix_cache is not None:
                hit_pct = (100.0 * self.prefix_hit_tokens / self.prompt_tokens
                           if self.prompt_tokens else 0.0)
                out["prefix_hit_tokens_pct"] = round(hit_pct, 1)
                out["prefix_cache"] = dict(
                    self._prefix_cache.stats(),
                    hits=self.prefix_hits, misses=self.prefix_misses,
                    hit_tokens=self.prefix_hit_tokens,
                    prompt_tokens=self.prompt_tokens)
            if self._spec is not None:
                rate = (100.0 * self.spec_accepted / self.spec_proposed
                        if self.spec_proposed else 0.0)
                per_step = (self.spec_emitted / self.spec_steps
                            if self.spec_steps else 0.0)
                out["spec_accept_rate"] = round(rate, 1)
                out["spec_tokens_per_step"] = round(per_step, 3)
                out["speculative"] = dict(
                    self._spec.stats(), verify_steps=self.spec_steps,
                    proposed=self.spec_proposed, accepted=self.spec_accepted,
                    emitted=self.spec_emitted)
        return out

    def drain_and_swap(self, net, timeout: Optional[float] = None) -> None:
        """Hot-reload seam: pause admission, let every in-flight request
        finish on the current weights (its KV pages were computed with
        them), swap to `net`, and resume admission: queued requests
        decode on the new weights. Raises `ServingError` when the drain
        does not finish within `timeout` (the old weights keep serving),
        and the swap's own error (e.g. `net` is not a GPT network) with
        the old weights still serving."""
        with self._cond:
            if self._closed:
                raise ServerClosedError("decode engine is shut down")
            self._swap_net = net
            self._swap_error = None
            self._swap_done.clear()
            self._draining = True
            self._cond.notify_all()
        self.recorder.event("drain", reason="weight-swap")
        if not self._swap_done.wait(timeout):
            with self._cond:
                # the scheduler may already be past the _swap_net check
                # and building: only a swap it has not picked up is
                # abandoned
                abandon = not self._swap_in_progress \
                    and not self._swap_done.is_set()
                if abandon:  # resume serving the old weights
                    self._swap_net = None
                    self._draining = False
                    self._cond.notify_all()
            if abandon:
                raise ServingError(
                    f"decode engine drain did not complete within "
                    f"{timeout}s (long in-flight generations); old "
                    "weights still serving")
            self._swap_done.wait()  # the build is running: see it out
        err = self._swap_error
        if err is not None:
            raise err

    def model_bytes_per_chip(self) -> int:
        """Bytes this engine keeps on one slot: the network's parameters
        plus every KV pool and scale pool. Under parallel={"tp": N} the
        split matmul slices and the pools' head axis each divide by N
        (the replicated tensors do not)."""
        pool_bytes = sum(x.numel() * x.element_size()
                         for c in self._caches
                         for x in c) // self._tp_degree
        if self._tp is not None:
            return self._tp.weight_bytes_per_chip(self._net._params) \
                + pool_bytes
        weight_bytes = sum(
            t.numel() * t.element_size()
            for p in self._net._params
            for t in (p.values() if isinstance(p, dict) else ()))
        return weight_bytes + pool_bytes

    def shutdown(self, drain_timeout: float = 10.0) -> bool:
        """Stop admission (`ServerClosedError` for queued and new
        requests), let in-flight generations finish for up to
        `drain_timeout` seconds, then fail the rest. Returns True on a
        clean drain. Idempotent."""
        deadline = time.monotonic() + drain_timeout
        drained = True
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            while any(r is not None for r in self._slots):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    drained = False
                    self._kill = True
                    self._cond.notify_all()
                    break
                self._cond.wait(min(remaining, 0.05))
        self._thread.join(max(0.0, deadline - time.monotonic()) + 5.0)
        if not drained:
            logger.warning("decode engine: shutdown drain timed out with "
                           "generations still in flight")
        return drained

    # -- scheduler ---------------------------------------------------------
    def _hook(self, phase: str, info: dict) -> None:
        for hook in self.step_hooks:
            hook(phase, info)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and not self._kill \
                        and not self._work_pending():
                    self._cond.wait(0.05)
                if self._kill:
                    self._fail_all_locked(ServerClosedError(
                        "engine shut down before this request finished"))
                    self._abort_pending_swap_locked()
                    return
                if self._closed:
                    while self._queue:
                        req = self._queue.popleft()
                        self._pages_demand_queued -= req.n_pages
                        self._free_request_pages_locked(req)
                        self._finish_obs(req, ServerClosedError(
                            "engine shut down before this request could be "
                            "served"))
                    self._drain_prefix_exports_locked(ServerClosedError(
                        "decode engine is shut down"))
                    if not any(r is not None for r in self._slots):
                        self._abort_pending_swap_locked()
                        self._cond.notify_all()
                        return
            try:
                # a drained engine swaps before anything is admitted, so
                # the queued requests start on the new weights
                self._maybe_swap()
                if not self._draining and not self._closed:
                    self._admit()
                self._expire_in_flight()
                self._step_migrations()
                self._serve_prefix_exports()
                self._sweep_leases()
                self._step_prefills()
                self._step_active()
            # the scheduler must survive: the iteration's failure fails
            # every in-flight request typed and the device state rebuilds
            except Exception:
                logger.exception("decode engine: scheduler iteration "
                                 "failed; failing in-flight requests")
                with self._cond:
                    self._fail_all_locked(InferenceFailedError(
                        "decode engine scheduler failure"))
                self._reset_device_state()

    def _abort_pending_swap_locked(self) -> None:
        """A scheduler exit (shutdown or kill) with a drain pending
        releases the `drain_and_swap` caller, which would otherwise wait
        on a dead scheduler."""
        assert_owned(self._cond, "DecodeEngine._abort_pending_swap_locked")
        if self._draining or self._swap_net is not None:
            self._swap_net = None
            self._draining = False
            self._swap_error = ServerClosedError(
                "engine shut down while draining for a weight swap")
            self._swap_done.set()

    def _work_pending(self) -> bool:
        if any(r is not None for r in self._slots):
            return True
        if self._draining:
            return True  # reach _maybe_swap with every slot empty
        if self._migrate_all or self._leases.expired_pending():
            return True  # reach the migration pass or the lease sweep
        if self._prefix_exports:
            return True  # a peer waits on a prefix export
        return bool(self._queue)

    def _fail_all_locked(self, err: BaseException) -> None:
        assert_owned(self._cond, "DecodeEngine._fail_all_locked")
        self._drain_prefix_exports_locked(err)
        while self._queue:
            req = self._queue.popleft()
            self._pages_demand_queued -= req.n_pages
            self._free_request_pages_locked(req)
            self._finish_obs(req, err)  # never took a breaker token
        for s, req in enumerate(self._slots):
            if req is not None:
                self._slots[s] = None
                self._active[s] = False
                self._free_request_pages_locked(req)
                if self.breaker is not None:
                    # hand the request's breaker token back: a dropped
                    # half-open probe would wedge the shared breaker
                    self.breaker.record_failure(req.probe)
                self._finish_obs(req, err)
        self._cond.notify_all()

    def _select_head_locked(self) -> int:
        """Index of the next request to admit: the first queued
        interactive request when there is one (it jumps a page-blocked
        batch head); else the batch request whose tenant holds the
        lowest stride-scheduling pass (weighted fair; FIFO within a
        tenant, untenanted batch traffic on one shared ledger)."""
        assert_owned(self._cond, "DecodeEngine._select_head_locked")
        best = 0
        best_pass = None
        for i, r in enumerate(self._queue):
            if r.priority == "interactive":
                return i
            p = self._wfq_pass.get(r.tenant, self._wfq_floor)
            if best_pass is None or p < best_pass:
                best, best_pass = i, p
        return best

    def _wfq_charge_locked(self, req: _GenRequest) -> None:
        """Advance the admitted batch request's tenant pass: its virtual
        start is max(own pass, floor), charged by its span over the
        tenant's weight; the floor moves to the winner's start."""
        assert_owned(self._cond, "DecodeEngine._wfq_charge_locked")
        state = self._tenant_locked(req.tenant)
        weight = state.weight if state is not None else 1.0
        start = max(self._wfq_pass.get(req.tenant, self._wfq_floor),
                    self._wfq_floor)
        span = float(max(1, int(req.n_tokens)))
        self._wfq_pass[req.tenant] = start + span / max(weight, 1e-9)
        self._wfq_floor = start

    def _maybe_preempt_locked(self, head: _GenRequest, reason: str):
        """Send one decoding batch-lane slot back to the queue so a
        blocked interactive head can take its slot and pages. The
        victim's emitted tokens fold into its prompt (`resumed_at` marks
        the fold), its prompt's full pages are promoted into the prefix
        cache so the re-prefill re-binds them, it keeps its sampling
        generator, and it rejoins the queue front. Mid-prefill slots are
        never preempted: their pages hold partial KV. Returns ``(victim,
        old_probe, reason, slot)`` or None."""
        assert_owned(self._cond, "DecodeEngine._maybe_preempt_locked")
        if not self._preempt_enabled or head.priority != "interactive" \
                or head.expired():
            return None
        best = None
        for s in range(self.n_slots):
            v = self._slots[s]
            if v is None or v.priority != "batch":
                continue
            if v.prefill_pos is not None or not self._active[s]:
                continue  # mid-prefill KV is partial: not promotable
            if v.n_tokens - len(v.tokens) < 1:
                continue  # retiring on its own this iteration
            if best is None or \
                    len(v.tokens) < len(self._slots[best].tokens):
                best = s  # least progress = least re-prefill to redo
        if best is None:
            return None
        v = self._slots[best]
        old_probe = v.probe
        # promote only the current prompt's full pages: the latest
        # token's KV is not written yet
        self._promote_prefix_locked(v)
        self._free_request_pages_locked(v)
        self._slots[best] = None
        self._active[best] = False
        emitted = len(v.tokens)
        if emitted > v.resumed_at:
            v.prompt = np.concatenate(
                [v.prompt, np.asarray(v.tokens[v.resumed_at:], np.int64)])
        v.resumed_at = emitted
        v.prefill_pos = None
        v.hit_len = 0
        v.n_shared = 0
        v.nodes = None
        v.digests = []
        v.probe = False
        v.preempted += 1
        v.n_pages = self._pages_for(v.prompt.shape[0],
                                    max(1, v.n_tokens - emitted))
        self._pages_demand_queued += v.n_pages
        self._queue.appendleft(v)
        self.preemptions += 1
        ts = self._tenants.get(v.tenant)
        if ts is not None:
            ts.preemptions += 1
        self.recorder.event(
            "preempt", slot=best, reason=reason, tenant=v.tenant,
            victim_emitted=emitted, victim_remaining=v.n_tokens - emitted,
            head_tenant=head.tenant, free_pages=len(self._free_pages),
            head_need_pages=head.n_pages)
        self._cond.notify_all()
        return (v, old_probe, reason, best)

    def _admit(self) -> None:
        """Move queued requests into free slots. Head selection is
        priority-aware (`_select_head_locked`); a slot- or page-blocked
        interactive head preempts a decoding batch slot. Otherwise the
        head waits when the free list cannot cover its pages, after
        unreferenced prefix-cache pages were reclaimed LRU-first. With a
        prefix hit (local, or fetched from a cluster holder) the cached
        chain binds into the slot's page table and prefill starts at the
        first uncached page boundary; a warm handoff re-binds its shipped
        pages and decodes at once. A short cold prompt prefills one-shot
        at once; a long or prefix-hit one is parked mid-prefill for
        `_step_prefills`. With a breaker, each admission takes a token."""
        while True:
            preempt = None
            with self._cond:
                if not self._queue:
                    return
                free = [s for s in range(self.n_slots)
                        if self._slots[s] is None]
                head_idx = self._select_head_locked()
                head = self._queue[head_idx]
                nodes: list = []
                pim = None
                pre_pinned = False
                need = head.n_pages
                if not free:
                    # a full house: the batch lane yields a slot to an
                    # interactive head, or everyone waits
                    preempt = self._maybe_preempt_locked(head, "slots")
                    if preempt is None:
                        return
                elif not head.expired():
                    if head.import_state is not None and head.nodes:
                        # delta handoff: its chain pages were pinned at
                        # resume_submit; only the shipped tail is fresh
                        nodes = head.nodes
                        pre_pinned = True
                        need = head.n_pages - len(nodes)
                    elif self._prefix_cache is not None \
                            and head.import_state is None:
                        nodes = self._prefix_cache.lookup(
                            head.prompt, head.digests, tenant=head.tenant)
                        pim = head.prefix_import
                        if pim is not None:
                            pay = pim["payload"]
                            if pay["weight_version"] \
                                    != self._weight_version \
                                    or int(pay["page_size"]) \
                                    != self.page_size \
                                    or not (int(pim["have"]) <= len(nodes)
                                            < int(pim["depth"])):
                                # the bundle went stale between submit
                                # and admission: drop it, prefill covers
                                head.prefix_import = pim = None
                                self.recorder.event(
                                    "prefix-fetch", decision="dropped",
                                    have=len(nodes))
                        if nodes or pim is not None:
                            # a resumed request spans only its remaining
                            # tokens past the extended prompt
                            need = self._pages_for_hit(
                                head.prompt.shape[0],
                                max(1, head.n_tokens - head.resumed_at)) \
                                - len(nodes)
                    if need > len(self._free_pages) \
                            and self._prefix_cache is not None:
                        # pool pressure: release idle cached pages (LRU,
                        # leaf-first); the head's own chain is pinned
                        self._prefix_cache.acquire(nodes)
                        try:
                            reclaimed = self._prefix_cache.reclaim(
                                need - len(self._free_pages))
                        finally:
                            self._prefix_cache.release(nodes)
                        self._free_pages.extend(reclaimed)
                        if reclaimed:
                            self.recorder.event(
                                "page-reclaim", pages=len(reclaimed),
                                free_after=len(self._free_pages))
                    if need > len(self._free_pages):
                        preempt = self._maybe_preempt_locked(head, "pages")
                        if preempt is None:
                            return
                if preempt is None:
                    req = head
                    del self._queue[head_idx]
                    self._pages_demand_queued -= req.n_pages
                    if req.priority != "interactive":
                        self._wfq_charge_locked(req)
            if preempt is not None:
                victim, old_probe, reason, vslot = preempt
                if self.breaker is not None:
                    # a preemption is a scheduling decision: the victim's
                    # device work was healthy
                    self.breaker.record_success(old_probe)
                victim.trace.event("preempt", reason=reason, slot=vslot,
                                   emitted=len(victim.tokens))
                continue
            now = time.monotonic()
            if req.expired(now):
                with self._cond:
                    self.shed_deadline += 1
                    self._free_request_pages_locked(req)
                req.trace.add_timed("queue-wait", req.enqueued_at, now,
                                    decision="expired")
                self._finish_obs(req, DeadlineExceededError(
                    "deadline expired while queued; request shed before "
                    "prefill"))
                continue
            req.trace.add_timed("queue-wait", req.enqueued_at, now)
            with self._cond:
                self._queue_wait_ewma = 0.8 * self._queue_wait_ewma \
                    + 0.2 * (now - req.enqueued_at)
            if self.breaker is not None:
                try:
                    req.probe = self.breaker.acquire()
                except ServiceUnavailableError as e:
                    with self._cond:
                        self.shed_unavailable += 1
                        self._free_request_pages_locked(req)
                    self._finish_obs(req, e)
                    continue
            slot = free[0]
            with self._cond:
                if pre_pinned:
                    req.n_shared = len(nodes)  # acquired at resume_submit
                elif nodes:
                    self._prefix_cache.acquire(nodes)
                    req.nodes = nodes
                    req.n_shared = len(nodes)
                    req.hit_len = len(nodes) * self.page_size
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += req.hit_len
                elif self._prefix_cache is not None:
                    self.prefix_misses += 1
                self.prompt_tokens += int(req.prompt.shape[0])
                req.pages = [n.page_id for n in nodes] + \
                    [self._free_pages.pop() for _ in range(need)]
                held = self.pool_pages - len(self._free_pages)
                self.pages_in_use_peak = max(self.pages_in_use_peak, held)
            if nodes:
                req.trace.event("prefix-bind", shared_pages=req.n_shared,
                                hit_tokens=req.hit_len)
            req.trace.event("admission", slot=slot, pages=len(req.pages),
                            shared_pages=req.n_shared, pages_in_use=held)
            self.recorder.event("admit", slot=slot, pages=len(req.pages),
                                hit_tokens=req.hit_len, pages_in_use=held,
                                tenant=req.tenant, priority=req.priority)
            row = np.zeros((self._n_pages_max,), np.int32)
            row[:len(req.pages)] = req.pages
            self._page_table[slot] = torch.from_numpy(row).to(self.device)
            if req.prefix_import is not None:
                # fetched cluster pages land in the fresh tail pages and
                # promote as if prefilled here; a failure keeps the
                # local hit
                self._bind_prefix_import(req)
            if req.import_state is not None:
                # shipped KV re-binds into the slot: no prefill
                try:
                    self._import_into(slot, req)
                except Exception as e:
                    self._import_failure(slot, req, e)
                continue
            if req.hit_len or pim is not None \
                    or self._is_chunked(req.prompt.shape[0]):
                # `pim` forces the chunk path even when its bind failed:
                # the hit-style allocation cannot cover a one-shot
                # prefill's padded bucket
                with self._cond:
                    req.prefill_pos = req.hit_len
                    self._slots[slot] = req  # active once the last chunk lands
                continue
            try:
                self._prefill_into(slot, req)
            except Exception as e:
                self._prefill_failure(slot, req, e, attached=False)

    def _prefill_into(self, slot: int, req: _GenRequest) -> None:
        page = self.page_size
        t0 = req.prompt.shape[0]
        bucket = self._bucket_for(t0)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :t0] = req.prompt
        wpids = req.pages[:-(-bucket // page)]
        info = {"slot": slot, "bucket": bucket, "t0": t0}
        self._hook("pre_prefill", info)

        def run():
            tok0, ok, lp = self._prefill_math(slot, req, ids, wpids)
            # the one host read-back of this dispatch (the logprob
            # triple, when asked for, follows once the device is done)
            first, ok = torch.stack([tok0, ok.long()]).tolist()
            return first, ok, _host(lp)

        tp0 = time.monotonic()
        first, ok, lp0 = _dispatched(run)
        tp1 = time.monotonic()
        req.trace.add_timed("prefill", tp0, tp1, bucket=bucket,
                            prompt_len=t0)
        if not ok:
            raise InferenceFailedError(
                "model produced non-finite logits during prefill")
        if self._spec is not None:
            # mirror the prompt into the draft's pools (same pages, same
            # padded ids) so proposing can start from a complete context
            _dispatched(lambda: self._spec.prefill_one_shot(ids, wpids))
        self._hook("post_prefill", info)
        with self._cond:
            self.prefills += 1
            self.tokens_generated += 1
            # a one-shot prefill grounds the SLO estimator as one chunk
            self._chunk_ewma = 0.8 * self._chunk_ewma + 0.2 * (tp1 - tp0)
            self._promote_prefix_locked(req)
        if self._spec is not None:
            self._spec.seed_slot(slot, req.seed)
        req.tokens.append(first)
        self._emit_token(req, lp0)
        # a preempted request re-prefills with its tokens folded in, so
        # this first token may already be its last
        if len(req.tokens) >= req.n_tokens or first == self.eos_token:
            self._retire(slot, req, attached=False)
            return
        if req.handoff:
            # prefill role: the fresh KV leaves under a lease
            self._export_slot(slot, req, attached=False, reason="disagg")
            return
        with self._cond:
            self._slots[slot] = req
            self._active[slot] = True

    def _step_prefills(self) -> None:
        """Drive pending chunked prefills, at most `prefill_chunk_budget`
        chunks per scheduler iteration."""
        budget = self.prefill_chunk_budget
        for s in range(self.n_slots):
            if budget <= 0:
                return
            req = self._slots[s]
            if req is None or req.prefill_pos is None:
                continue
            self._prefill_chunk_into(s, req)
            budget -= 1

    def _prefill_chunk_into(self, slot: int, req: _GenRequest) -> None:
        C, page = self.prefill_chunk, self.page_size
        off = req.prefill_pos
        t0 = req.prompt.shape[0]
        rem = t0 - off
        final = rem <= C
        if not final or C < page:
            W = C
        else:
            # final chunk padded only to the next page multiple (<= C): a
            # prefix-hit suffix must never write past page * ceil(t0 /
            # page), which its reservation covers
            W = -(-rem // page) * page
        ids = np.zeros((1, W), np.int64)
        take = min(W, rem)
        ids[0, :take] = req.prompt[off:off + take]
        if W >= page:
            pids = req.pages[off // page: off // page + W // page]
            woff = 0
        else:
            pids = [req.pages[off // page]]
            woff = off % page
        info = {"slot": slot, "t0": t0, "chunk": W, "chunk_off": off,
                "final": final}
        self._hook("pre_prefill", info)

        def run():
            tok0, ok, lp = self._prefill_chunk_math(slot, req, ids, off,
                                                    woff, pids, final)
            if tok0 is None:
                return None, bool(ok), None
            first, ok = torch.stack([tok0, ok.long()]).tolist()
            return first, ok, _host(lp)

        tp0 = time.monotonic()
        try:
            first, ok, lp0 = _dispatched(run)
            tp1 = time.monotonic()
            req.trace.add_timed("prefill-chunk", tp0, tp1, chunk_off=off,
                                width=W, final=final)
            if not ok:
                raise InferenceFailedError(
                    "model produced non-finite activations during chunked "
                    "prefill")
            if self._spec is not None:
                _dispatched(lambda: self._spec.prefill_chunk(
                    self._page_table[slot:slot + 1], ids, off, woff, pids))
        except Exception as e:
            self._prefill_failure(slot, req, e, attached=True)
            return
        self._hook("post_prefill", info)
        with self._cond:
            self.prefill_chunks += 1
            self._chunk_ewma = 0.8 * self._chunk_ewma + 0.2 * (tp1 - tp0)
        if not final:
            req.prefill_pos = off + C
            return
        req.prefill_pos = None
        with self._cond:
            self.prefills += 1
            self.tokens_generated += 1
            self._promote_prefix_locked(req)
        if self._spec is not None:
            self._spec.seed_slot(slot, req.seed)
        req.tokens.append(first)
        self._emit_token(req, lp0)
        if len(req.tokens) >= req.n_tokens or first == self.eos_token:
            self._retire(slot, req)
            return
        if req.handoff:
            self._export_slot(slot, req, attached=True, reason="disagg")
            return
        with self._cond:
            self._active[slot] = True

    def _prefill_failure(self, slot: int, req: _GenRequest,
                         e: BaseException, *, attached: bool) -> None:
        """Free the slot and pages and fail the request typed. A failed
        dispatch may have left the in-place pools half-written, which
        backs every in-flight slot: those fail too and the state
        rebuilds."""
        if self.breaker is not None:
            self.breaker.record_failure(req.probe)
        with self._cond:
            self.failures += 1
            if attached:
                self._slots[slot] = None
                self._active[slot] = False
            self._free_request_pages_locked(req)
            self._cond.notify_all()
        err = e if isinstance(e, ServingError) else InferenceFailedError(
            f"prefill failed: {type(e).__name__}: {e}")
        logger.warning("decode engine: prefill failure (%s)", err)
        self._finish_obs(req, err, phase="prefill")
        if getattr(e, "_dispatch_failure", False):
            self._fail_occupied_slots(InferenceFailedError(
                "paged KV pool lost to a failed prefill dispatch"))
            self._reset_device_state()

    def _fail_occupied_slots(self, err: BaseException) -> None:
        with self._cond:
            for s, r in enumerate(self._slots):
                if r is not None:
                    self._slots[s] = None
                    self._active[s] = False
                    r.pages = None  # the pools rebuild wholesale after this
                    r.nodes = None  # ... and the prefix cache clears
                    if self.breaker is not None:
                        self.breaker.record_failure(r.probe)
                    self._finish_obs(r, err)
            self._cond.notify_all()

    def _retire(self, slot: int, req: _GenRequest, *,
                attached: bool = True) -> None:
        """Successful completion: free the slot and its pages, credit the
        breaker, deliver."""
        with self._cond:
            if attached:
                self._slots[slot] = None
                self._active[slot] = False
            self._free_request_pages_locked(req)
            self.served += 1
            ts = self._tenants.get(req.tenant)
            if ts is not None:
                ts.served += 1
                ts.tokens_generated += len(req.tokens)
            self._cond.notify_all()
        if self.breaker is not None:
            self.breaker.record_success(req.probe)
        # the trace rides along so a p99 excursion can pin this request's
        # timeline in the failures ring
        self._gen_latency_hist.observe(
            1e3 * (time.monotonic() - req.enqueued_at), trace=req.trace)
        self.recorder.event("retire", slot=slot, tokens=len(req.tokens))
        self._finish_obs(req)

    # -- KV handoff and live migration (kv_transfer) -------------------------
    def _read_pages(self, pages: List[int]):
        """Host copies of pool pages `pages` from every block: (blocks,
        dtypes) in the payload's form (bf16 leaves as uint16 bits)."""
        from deeplearning4j_tpu_torch.serving.kv_transfer import (
            leaf_from_tensor,
        )

        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        names = ("k", "v", "ks", "vs") if self._kv_quant else ("k", "v")
        blocks, dtypes = [], {}
        for c in self._caches:
            blk = {}
            for name, arr in zip(names, c):
                blk[name], dt = leaf_from_tensor(arr[idx])
                if dt is not None:
                    dtypes[name] = dt
            blocks.append(blk)
        return blocks, dtypes

    def _write_payload_pages(self, payload: dict, pages: List[int],
                             lo: int = 0, n: Optional[int] = None) -> None:
        """Scatter shipped pages `lo:lo+n` of every block of `payload`
        into pool pages `pages`, in place. A leaf of another dtype or
        shape than the pool raises before anything is written."""
        from deeplearning4j_tpu_torch.serving.kv_transfer import (
            KVTransferError,
            leaf_to_tensor,
        )

        dtypes = payload.get("dtypes") or {}
        names = ("k", "v", "ks", "vs") if self._kv_quant else ("k", "v")
        n = len(pages) if n is None else n
        srcs = []
        for blk, c in zip(payload["blocks"], self._caches):
            for name, arr in zip(names, c):
                src = leaf_to_tensor(np.asarray(blk[name])[lo:lo + n],
                                     dtypes.get(name))
                if src.dtype != arr.dtype \
                        or tuple(src.shape[1:]) != tuple(arr.shape[1:]) \
                        or src.shape[0] != len(pages):
                    raise KVTransferError(
                        f"handoff tensor {name!r} is {src.dtype} "
                        f"{tuple(src.shape)}; this pool takes {arr.dtype} "
                        f"({len(pages)}, {', '.join(map(str, arr.shape[1:]))})")
                srcs.append((arr, src))
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        for arr, src in srcs:
            arr[idx] = src.to(self.device)

    def _payload_common(self, req: _GenRequest) -> dict:
        seed = int(req.seed)
        return dict(
            weight_version=self._weight_version, kv_quant=self._kv_quant,
            page_size=self.page_size, n_blocks=len(self._caches),
            prompt=req.prompt, n_tokens=req.n_tokens,
            temperature=req.temperature, seed=seed,
            resumed_at=req.resumed_at, tokens=req.tokens,
            # the words of the JAX package's PRNGKey(seed)
            key=np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                           np.uint32),
            tenant=req.tenant, priority=req.priority,
            preempted=req.preempted, logprobs=req.logprobs,
            logprob_values=list(req.logprob_values),
            sampler=self._sampler_state(req),
            deadline_remaining=None if req.deadline is None
            else max(0.0, req.deadline - time.monotonic()))

    def _export_slot(self, slot: int, req: _GenRequest, *,
                     attached: bool = True, reason: str = "migrate") -> None:
        """Scheduler-thread export: this slot's decode state (the used KV
        pages of every block with the int8 scales, the position and
        last-token registers, the live sampling generator, the emitted
        transcript) into a leased payload; release the slot and finish
        the request with the `SlotMigratedError` redirect. Page ownership
        moves to the lease."""
        from deeplearning4j_tpu_torch.serving import kv_transfer

        pos = int(self._pos[slot])
        tok = int(self._tok[slot])
        temp = float(self._temps[slot])
        used = min(-(-pos // self.page_size), len(req.pages))
        blocks, dtypes = self._read_pages(req.pages[:used])
        handoff_id = kv_transfer.LeaseTable.new_id()
        payload = kv_transfer.build_payload(
            handoff_id=handoff_id, kind="warm", blocks=blocks,
            pages_shipped=used, pos=pos, tok=tok, temp=temp, dtypes=dtypes,
            **self._payload_common(req))
        nbytes = kv_transfer.payload_nbytes(payload)
        with self._cond:
            self._leases.grant(payload, pages=req.pages,
                               n_shared=req.n_shared, nodes=req.nodes)
            req.pages = None  # ownership moved to the lease
            req.nodes = None
            if attached:
                self._slots[slot] = None
                self._active[slot] = False
            self.migrations_out += 1
            self.kv_transfer_bytes += nbytes
            self._cond.notify_all()
        if self.breaker is not None:
            # an export is a routing decision: the device work was healthy
            self.breaker.record_success(req.probe)
        req.trace.event("migrate-out", handoff_id=handoff_id, slot=slot,
                        pos=pos, pages_shipped=used, bytes=nbytes,
                        reason=reason)
        self.recorder.event("migrate-out", handoff_id=handoff_id, slot=slot,
                            pos=pos, pages_shipped=used, bytes=nbytes,
                            reason=reason)
        self._finish_obs(req, kv_transfer.SlotMigratedError(
            f"slot exported under lease {handoff_id} ({reason}); fetch the "
            "handoff and resume on a peer",
            handoff_id=handoff_id, tokens=list(req.tokens)))

    def _export_cold(self, req: _GenRequest, *, reason: str) -> None:
        """Export a request that holds no complete KV (queued, or parked
        mid-prefill) as a cold handoff: the peer re-prefills from the
        prompt with the same seed (and the same generator, when it had
        drawn)."""
        from deeplearning4j_tpu_torch.serving import kv_transfer

        handoff_id = kv_transfer.LeaseTable.new_id()
        payload = kv_transfer.build_payload(
            handoff_id=handoff_id, kind="cold", blocks=[], pages_shipped=0,
            **self._payload_common(req))
        with self._cond:
            self._leases.grant(payload)
            self.migrations_out += 1
            self._cond.notify_all()
        req.trace.event("migrate-out", handoff_id=handoff_id, kind="cold",
                        reason=reason)
        self.recorder.event("migrate-out", handoff_id=handoff_id,
                            handoff_kind="cold", reason=reason)
        self._finish_obs(req, kv_transfer.SlotMigratedError(
            f"request exported cold under lease {handoff_id} ({reason}); "
            "resume re-prefills from the prompt on a peer",
            handoff_id=handoff_id, tokens=list(req.tokens)))

    def _step_migrations(self) -> None:
        """The migrate-everything pass armed by `migrate_slots()`:
        decoding slots export warm, queued and mid-prefill requests cold
        (partial KV is never shipped)."""
        with self._cond:
            if not self._migrate_all:
                return
            self._migrate_all = False
            queued = list(self._queue)
            self._queue.clear()
            for r in queued:
                self._pages_demand_queued -= r.n_pages
                self._free_request_pages_locked(r)  # delta-pin release
            parked, decoding = [], []
            for s, r in enumerate(self._slots):
                if r is None:
                    continue
                if self._active[s] and r.prefill_pos is None:
                    decoding.append((s, r))
                else:
                    parked.append((s, r))
            for s, r in parked:
                self._slots[s] = None
                self._active[s] = False
                self._free_request_pages_locked(r)
            self._cond.notify_all()
        for r in queued:
            self._export_cold(r, reason="migrate")
        for _, r in parked:
            if self.breaker is not None:
                self.breaker.record_success(r.probe)
            self._export_cold(r, reason="migrate")
        for s, r in decoding:
            self._export_slot(s, r, attached=True, reason="migrate")

    def _drain_prefix_exports_locked(self, err: BaseException) -> None:
        """Release every parked `export_prefix` waiter with `err`."""
        assert_owned(self._cond, "DecodeEngine._drain_prefix_exports_locked")
        while self._prefix_exports:
            item = self._prefix_exports.popleft()
            item["error"] = err
            item["done"].set()

    def _serve_prefix_exports(self) -> None:
        """Scheduler-thread service of parked `export_prefix` items: read
        the chain's pages, lease them (the lease pins the chain nodes
        while the receiver drains frames) and hand the framed header to
        the waiting caller."""
        from deeplearning4j_tpu_torch.serving import kv_transfer

        while True:
            with self._cond:
                if not self._prefix_exports:
                    return
                item = self._prefix_exports.popleft()
                nodes = [] if self._prefix_cache is None else \
                    self._prefix_cache.match(item["prompt"],
                                             tenant=item["tenant"])
                depth = len(nodes)
                have = item["have"]
                if depth <= have:
                    item["error"] = kv_transfer.KVTransferError(
                        f"prefix chain no longer resident here beyond "
                        f"{have} pages (holds {depth}); the directory entry "
                        "was stale — fall back to cold prefill")
                    item["done"].set()
                    continue
                self._prefix_cache.acquire(nodes)
                pages = [n.page_id for n in nodes]
            try:
                blocks, dtypes = self._read_pages(pages[have:])
                handoff_id = kv_transfer.LeaseTable.new_id()
                payload = kv_transfer.build_payload(
                    handoff_id=handoff_id, kind="prefix",
                    weight_version=self._weight_version,
                    kv_quant=self._kv_quant, page_size=self.page_size,
                    n_blocks=len(self._caches),
                    prompt=item["prompt"][:depth * self.page_size],
                    n_tokens=0, temperature=0.0, seed=0, resumed_at=0,
                    tokens=[], blocks=blocks, pages_shipped=depth - have,
                    pages_omitted=have, tenant=item["tenant"],
                    source=self._holder_id, dtypes=dtypes)
                header = kv_transfer.payload_header(
                    payload, frame_pages=item["frame_pages"]
                    or self._prefix_fetch_frame_pages)
            # the export fails typed on its waiter, never in the loop;
            # the pins release like an aborted lease
            except Exception as e:
                with self._cond:
                    self._prefix_cache.release(nodes)
                    self._cond.notify_all()
                item["error"] = e if isinstance(e, ServingError) else \
                    kv_transfer.KVTransferError(
                        f"prefix export failed: {type(e).__name__}: {e}")
                item["done"].set()
                continue
            nbytes = kv_transfer.payload_nbytes(payload)
            with self._cond:
                # n_shared == len(pages): resolving the lease releases the
                # pins and frees nothing (the cache owns these pages)
                self._leases.grant(payload, pages=pages,
                                   n_shared=len(pages), nodes=nodes)
                self.prefix_exports_served += 1
                self._cond.notify_all()
            item["result"] = header
            item["done"].set()
            self.recorder.event("prefix-export", holder=self._holder_id,
                                handoff_id=handoff_id, pages=depth - have,
                                skipped=have, bytes=nbytes)

    def _sweep_leases(self) -> None:
        """Orphan reclamation: a receiver that died or never committed
        lets its lease expire, and its pages come home here."""
        now = time.monotonic()
        with self._cond:
            if not self._leases.expired_pending(now):
                return
            for lease in self._leases.sweep(now):
                self._release_lease_locked(lease)
                self.handoffs_expired += 1
                self.recorder.event("lease-expired",
                                    handoff_id=lease.handoff_id)
            self._cond.notify_all()

    def _release_lease_locked(self, lease) -> None:
        """Return a resolved lease's pages to the pool, once per lease:
        owned pages to the free list, prefix pins released."""
        assert_owned(self._cond, "DecodeEngine._release_lease_locked")
        if lease.nodes:
            self._prefix_cache.release(lease.nodes)
            lease.nodes = None
        if lease.pages:
            self._free_pages.extend(lease.pages[lease.n_shared:])
        lease.pages = None

    def _bind_prefix_import(self, req: _GenRequest) -> None:
        """Bind a verified cluster prefix fetch into this request's
        pages: scatter the shipped chain pages into the pools, insert the
        chain into the local prefix cache (publishing it as a local
        promotion would), and extend the hit so suffix prefill starts at
        the fetched depth. A failed scatter drops the bundle and keeps
        the local hit."""
        pim, req.prefix_import = req.prefix_import, None
        payload = pim["payload"]
        page = self.page_size
        have = req.n_shared            # local chain pages already bound
        depth = int(pim["depth"])
        omitted = int(payload.get("pages_omitted", 0))
        shipped = int(payload["pages_shipped"])
        off = have - omitted           # leading shipped pages held here
        n_new = depth - have
        if off < 0 or off + n_new > shipped or n_new <= 0:
            self.recorder.event("prefix-fetch", decision="dropped",
                                have=have, depth=depth, skipped=omitted)
            return
        try:
            self._write_payload_pages(payload, req.pages[have:depth], off,
                                      n_new)
        # never slower: a failed scatter falls back to prefilling from
        # the local hit (nothing was written: the checks come first)
        except Exception as e:
            with self._cond:
                self.prefix_fetch_fallbacks += 1
            self.recorder.event("prefix-fetch", decision="bind-failed",
                                error=type(e).__name__)
            logger.warning("cluster prefix bind failed (%s: %s); "
                           "prefilling from the local hit",
                           type(e).__name__, e)
            return
        with self._cond:
            pnodes, freed = self._prefix_cache.insert(
                req.prompt[:depth * page], req.pages[:depth],
                req.nodes or [], tenant=req.tenant)
            self._free_pages.extend(freed)
            gained = (len(pnodes) - have) * page
            req.nodes = pnodes
            req.n_shared = len(pnodes)
            req.hit_len = len(pnodes) * page
            if have == 0:
                # a local miss the cluster hit: count it as a hit
                self.prefix_hits += 1
                self.prefix_misses -= 1
            self.prefix_hit_tokens += gained
            self.cluster_prefix_hit_tokens += gained
            self._cond.notify_all()
        req.trace.event("prefix-fetch-bind", pages=len(pnodes) - have,
                        hit_tokens=req.hit_len, source=pim["source"])
        self.recorder.event("prefix-fetch", decision="bound",
                            holder=pim["source"], pages=len(pnodes) - have,
                            hit_tokens=req.hit_len)

    def _import_into(self, slot: int, req: _GenRequest) -> None:
        """Re-bind a validated warm handoff into a free slot: scatter the
        shipped pages into every block's pools (and scales), restore the
        position, last-token and temperature registers and the sampling
        generator, promote the prompt's full pages into the prefix cache,
        and activate: the next decode step continues the sequence."""
        payload = req.import_state
        shipped = int(payload["pages_shipped"])
        omitted = int(payload.get("pages_omitted", 0))
        # delta handoff: the first `omitted` pages are the resident chain
        # pinned at resume_submit; the shipped pages land after them
        self._write_payload_pages(payload,
                                  req.pages[omitted:omitted + shipped])
        pos = int(payload["pos"])
        self._pos[slot] = pos
        self._tok[slot] = int(payload["tok"])
        self._temps[slot] = float(payload["temp"])
        if req.gen is None:
            req.gen = torch.Generator(device=self.device).manual_seed(
                req.seed)
        self._gens[slot] = req.gen
        with self._cond:
            req.import_state = None
            self._slots[slot] = req
            self._active[slot] = True
            self.migrations_in += 1
            self._promote_prefix_locked(req)
            held = self.pool_pages - len(self._free_pages)
            self.pages_in_use_peak = max(self.pages_in_use_peak, held)
            self._cond.notify_all()
        if self._spec is not None:
            # the draft's pools hold nothing for this slot: greedy
            # verify rejects its proposals until it re-warms, so the
            # tokens stay the target's
            self._spec.seed_slot(slot, req.seed)
        req.trace.event("migrate-in", slot=slot, pages_shipped=shipped,
                        pos=pos)
        self.recorder.event("migrate-in", slot=slot,
                            handoff_id=payload["handoff_id"],
                            pages_shipped=shipped, pos=pos)

    def _import_failure(self, slot: int, req: _GenRequest,
                        e: BaseException) -> None:
        """A failed import fails only its own request (the other slots'
        KV is intact); the breaker token returns as a success: a
        transfer failure is wire trouble, not model sickness."""
        from deeplearning4j_tpu_torch.serving.kv_transfer import (
            KVTransferError,
        )

        if self.breaker is not None:
            self.breaker.record_success(req.probe)
        with self._cond:
            self.failures += 1
            self._slots[slot] = None
            self._active[slot] = False
            self._free_request_pages_locked(req)
            self._cond.notify_all()
        err = e if isinstance(e, ServingError) else KVTransferError(
            f"KV import failed: {type(e).__name__}: {e}")
        logger.warning("decode engine: KV import failure (%s)", err)
        self._finish_obs(req, err, phase="import")

    def _expire_in_flight(self) -> None:
        """Shed expired queued requests, and free the slot and pages of
        an expired in-flight one (decoding or mid-prefill)."""
        now = time.monotonic()
        with self._cond:
            self._sweep_expired_locked(now)
        for s in range(self.n_slots):
            req = self._slots[s]
            if req is not None and req.expired(now):
                with self._cond:
                    self._slots[s] = None
                    self._active[s] = False
                    self._free_request_pages_locked(req)
                    self.shed_deadline += 1
                    self._cond.notify_all()
                if self.breaker is not None:
                    # the device work so far was healthy: expiry is a
                    # deadline event, not a model failure
                    self.breaker.record_success(req.probe)
                self._finish_obs(req, DeadlineExceededError(
                    f"deadline expired after {len(req.tokens)} of "
                    f"{req.n_tokens} tokens; slot freed"))

    def _chunk_eligible(self, live, now: float) -> bool:
        """Several decode steps may run between read-backs only when no
        scheduling event can land inside the run: every live request
        needs a full run more tokens, no deadline can expire in it, no
        prompt is mid-prefill, and (with an EOS token) nobody waits for a
        slot."""
        if self.decode_chunk <= 1:
            return False
        with self._cond:
            if any(r is not None and r.prefill_pos is not None
                   for r in self._slots):
                return False
            if self.eos_token is not None and self._queue:
                return False
            margin = 2.0 * self.decode_chunk * max(self._step_ewma, 1e-4)
        for _, r in live:
            if r.n_tokens - len(r.tokens) < self.decode_chunk:
                return False
            if r.deadline is not None and r.deadline - now < margin:
                return False
        return True

    def _decode_failure(self, live, e: BaseException) -> None:
        err = e if isinstance(e, ServingError) else InferenceFailedError(
            f"decode step failed: {type(e).__name__}: {e}")
        logger.warning("decode engine: decode failure (%s)", err)
        with self._cond:
            self.failures += len(live)
        for s, req in live:
            if self.breaker is not None:
                self.breaker.record_failure(req.probe)
            with self._cond:
                self._slots[s] = None
                self._active[s] = False
                self._free_request_pages_locked(req)
                self._cond.notify_all()
            self._finish_obs(req, err, phase="decode")
        if getattr(e, "_dispatch_failure", False):
            self._fail_occupied_slots(InferenceFailedError(
                "paged KV pool lost to a failed decode dispatch"))
            self._reset_device_state()

    def _retire_or_poison(self, s: int, req: _GenRequest, toks, oks,
                          n_steps: int, lps=None) -> None:
        """Append one slot's tokens from a decode run until done (count
        or EOS; overshoot is dropped with the slot) or until a non-finite
        step fails the request while healthy neighbours keep decoding.
        `lps` is the slot's per-step (chosen, top values, top ids)
        logprob batch when the engine computes logprobs."""
        for t in range(n_steps):
            if not oks[t]:
                with self._cond:
                    self.failures += 1
                    self._slots[s] = None
                    self._active[s] = False
                    self._free_request_pages_locked(req)
                    self._cond.notify_all()
                if self.breaker is not None:
                    self.breaker.record_failure(req.probe)
                self._finish_obs(req, InferenceFailedError(
                    "model produced non-finite logits during decode"),
                    phase="decode")
                return
            tok = int(toks[t])
            req.tokens.append(tok)
            self._emit_token(req, lps, t)
            with self._cond:
                self.tokens_generated += 1
            if len(req.tokens) >= req.n_tokens or tok == self.eos_token:
                self._retire(s, req)
                return

    def _step_active_spec(self, live) -> bool:
        """One speculative iteration: the draft proposes k tokens per
        slot, the target verifies them in one batched chunk — up to k+1
        tokens per slot. Returns False (the caller takes the plain step)
        when no live slot has the write budget to speculate."""
        spec = self._spec
        k = spec.k
        # a slot can commit m speculative tokens only while its writes
        # stay within the reserved span: pos + m <= t0 + n_tokens - 2
        # (the last token is never written back). With pos = t0 + len - 1
        # that cap is rem - 1 (rem = tokens still to emit), so a slot
        # with rem >= 2 can still accept; when EVERY slot is down to its
        # final token the plain step is strictly cheaper
        if all(r.n_tokens - len(r.tokens) < 2 for _, r in live):
            return False
        wl = np.zeros((self.n_slots,), np.int32)
        for s, r in live:
            # resumed_at keeps the limit at the original span: a
            # preempted request's prompt absorbed its emitted tokens
            wl[s] = r.prompt.shape[0] - r.resumed_at + r.n_tokens - 2
        info = {"active": len(live), "step": self.decode_steps,
                "spec": True, "k": k}
        t0c = time.monotonic()
        try:
            self._hook("pre_decode", info)

            def run():
                active_np = self._active.copy()
                active_t = torch.from_numpy(active_np).to(self.device)
                wlimit = torch.from_numpy(wl).to(self.device)
                props, qd = spec.propose(self._page_table, self._tok,
                                         self._pos, self._temps, active_t,
                                         active_np, wlimit)
                self._tok, self._pos, out, n_emit, oks = spec.verify(
                    self._sparams, self._params, self._caches,
                    self._page_table, self._tok, self._pos, self._temps,
                    self._gens, active_t, active_np, wlimit, props, qd)
                # the one host read-back of the iteration
                return (out.cpu().numpy(), n_emit.cpu().numpy(),
                        oks.cpu().numpy())

            out, n_emit, oks = _dispatched(run)
            self._hook("post_decode", info)
            t1c = time.monotonic()
        except Exception as e:
            self._decode_failure(live, e)
            return True
        emitted = int(sum(max(1, int(n_emit[s])) for s, _ in live))
        with self._cond:
            self._step_ewma = (0.8 * self._step_ewma
                               + 0.2 * (t1c - t0c)
                               * len(live) / max(1, emitted))
            self.decode_steps += 1
            self.active_slot_steps += len(live)
            self.spec_steps += 1
            for s, r in live:
                # proposals that could actually be consumed: the device
                # cap is m_cap = wlimit - pos = rem - 1, so accepted
                # (= n_emit - 1 <= m_cap) never exceeds this count and
                # the accept RATE stays a true <= 100% ratio
                self.spec_proposed += min(
                    k, max(0, r.n_tokens - len(r.tokens) - 1))
                self.spec_accepted += max(0, int(n_emit[s]) - 1)
        delivered = 0
        for s, req in live:
            n = max(1, int(n_emit[s]))
            req.trace.add_timed("spec-verify", t0c, t1c, k=k, emitted=n,
                                active=len(live))
            before = len(req.tokens)
            self._retire_or_poison(s, req, out[s, :n], np.repeat(oks[s], n),
                                   n)
            delivered += len(req.tokens) - before
        with self._cond:
            # spec_tokens_per_step counts DELIVERED tokens: those appended
            # to requests, not device emissions — a mid-verify EOS's
            # dropped overshoot must not inflate it
            self.spec_emitted += delivered
        return True

    def _step_active(self) -> None:
        live = [(s, r) for s, r in enumerate(self._slots)
                if r is not None and r.prefill_pos is None]
        if not live:
            return
        if self._spec is not None and self._step_active_spec(live):
            return
        t0 = time.monotonic()
        n_steps = self.decode_chunk if self._spec is None \
            and self._chunk_eligible(live, t0) else 1
        info = {"active": len(live), "step": self.decode_steps,
                "chunk": n_steps}
        try:
            self._hook("pre_decode", info)

            def run():
                active_t = torch.from_numpy(self._active.copy()).to(
                    self.device)
                steps = [self._decode_math(active_t) for _ in range(n_steps)]
                toks = torch.stack([t for t, _, _ in steps])
                oks = torch.stack([o for _, o, _ in steps])
                lps = None
                if self._logprobs_k:
                    lps = tuple(torch.stack([lp[j] for _, _, lp in steps])
                                for j in range(3))
                # the one host read-back per run: (n_steps, S) tokens and
                # per-step finite flags (the logprob triple, when asked
                # for, follows once the device is done)
                return toks.cpu().numpy(), oks.cpu().numpy(), _host(lps)

            toks, oks, lps = _dispatched(run)
            self._hook("post_decode", info)
        except Exception as e:
            self._decode_failure(live, e)
            return
        t1 = time.monotonic()
        with self._cond:
            self._step_ewma = 0.8 * self._step_ewma \
                + 0.2 * (t1 - t0) / n_steps
            self.decode_steps += n_steps
            self.active_slot_steps += len(live) * n_steps
        for s, req in live:
            req.trace.add_timed("decode", t0, t1, steps=n_steps,
                                active=len(live))
            lp_s = None if lps is None else \
                (lps[0][:, s], lps[1][:, s], lps[2][:, s])
            self._retire_or_poison(s, req, toks[:, s], oks[:, s], n_steps,
                                   lps=lp_s)

    def _maybe_swap(self) -> None:
        """Once a drain has emptied every slot, swap to the pending net:
        rebuild the geometry, the pools, the prefix cache and the draft
        for it, unless it is the very net the pools were built under
        (`ModelServer.restore_model`'s rollback), which keeps them. Queued
        requests are re-reserved against the new geometry; one that no
        longer fits fails typed. A failed build keeps the old weights
        serving and hands its error to `drain_and_swap`."""
        if not self._draining:
            return
        with self._cond:
            if any(r is not None for r in self._slots):
                return  # still draining: in-flight finish on old weights
            net = self._swap_net
            if net is None:  # drain abandoned (timeout in drain_and_swap)
                self._draining = False
                return
            # claimed: from here the swap completes or fails and sets
            # _swap_done; a timing-out drain_and_swap waits it out
            self._swap_in_progress = True
        try:
            if net is self._net:
                with self._cond:
                    self.swaps += 1
                self.recorder.event("swap", decision="preserved-pools")
                return
            self._build(net)
            misfit = []
            with self._cond:
                self.swaps += 1
                keep: collections.deque = collections.deque()
                reserved = 0
                while self._queue:
                    r = self._queue.popleft()
                    r.digests = []  # page digests of the old geometry
                    # delta pins name the pre-swap cache, whose pages
                    # were reclaimed wholesale: drop, never release
                    r.nodes = None
                    r.n_shared = 0
                    if r.import_state is not None:
                        # a queued warm handoff's KV was computed under
                        # the old weights: it must not bind
                        misfit.append(r)
                        continue
                    if r.prompt.shape[0] - r.resumed_at + r.n_tokens \
                            > self.max_len:
                        misfit.append(r)
                        continue
                    r.n_pages = self._pages_for(
                        r.prompt.shape[0], max(1, r.n_tokens - r.resumed_at))
                    if r.n_pages > self.pool_pages or \
                            reserved + r.n_pages > self.max_queued_pages:
                        misfit.append(r)
                        continue
                    reserved += r.n_pages
                    keep.append(r)
                self._queue = keep
                self._pages_demand_queued = reserved
            from deeplearning4j_tpu_torch.serving.kv_transfer import (
                KVTransferError,
            )

            for r in misfit:
                if r.import_state is not None:
                    self._finish_obs(r, KVTransferError(
                        "queued KV handoff refused: the engine's weights "
                        "swapped while it waited; fall back to re-prefill"))
                    continue
                self._finish_obs(r, ServingError(
                    f"request (prompt {r.prompt.shape[0]} + n_tokens "
                    f"{r.n_tokens}) no longer fits the swapped engine's "
                    f"max_len {self.max_len} / {self.pool_pages}-page "
                    "pool"))
            self.recorder.event("swap", decision="complete",
                                misfit=len(misfit))
        # a rejected swap keeps the old weights serving; the error goes
        # to drain_and_swap's caller
        except Exception as e:
            with self._cond:
                self._swap_error = e
            self.recorder.event("swap", decision="rejected",
                                error=type(e).__name__)
            logger.warning("decode engine: weight swap rejected (%s); "
                           "old weights still serving", e)
        finally:
            with self._cond:
                self._swap_net = None
                self._draining = False
                self._swap_in_progress = False
                self._cond.notify_all()
            self._swap_done.set()
