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

Greedy decode equals whole-batch `models.transformer.generate` (the two
share the per-block helpers) regardless of admission order, page/slot
reuse or prefill chunking.

Not ported yet (ROADMAP queue A11): tensor parallelism (`parallel`),
QoS (`qos`, `tenant`, `priority="batch"`), the disaggregated roles
(`role`, `handoff_ttl`), KV handoff and migration, and the cluster
prefix directory. Passing any of those options raises
`NotImplementedError`, and so do their methods.
"""
from __future__ import annotations

import collections
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
    _a11,
    _bucket,
)
from deeplearning4j_tpu_torch.serving.quantize import (
    _write_scale_pages,
    kv_bytes_per_token,
    quantize_heads,
)
from deeplearning4j_tpu_torch.util.concurrency import assert_owned

logger = logging.getLogger("deeplearning4j_tpu_torch")

# JAX DecodeEngine options this port does not carry yet, with their
# defaults; any other value raises NotImplementedError
_UNPORTED_OPTIONS = {"parallel": None, "qos": None, "role": "both",
                     "handoff_ttl": 30.0}
_UNPORTED_SUBMIT = {"tenant": None, "priority": "interactive"}


def _refuse_unported(where: str, given: dict, table: dict) -> None:
    for name, value in given.items():
        if name not in table:
            raise TypeError(f"{where} got an unexpected keyword argument "
                            f"{name!r}")
        if value != table[name]:
            raise _a11(f"{where}({name}=...)")


class _GenRequest:
    """One generation request: queued -> (shed | admitted into a slot,
    prefilled one-shot or chunk by chunk) -> decoding -> (completed |
    expired | failed). `n_pages` is the reservation taken at submit,
    `pages` the pool pages held from admission to retirement,
    `prefill_pos` the next chunk offset while mid-prefill. With a prefix
    cache, `hit_len` prompt positions ride shared pages: the first
    `n_shared` entries of `pages`, refcounted through `nodes`; only
    `pages[n_shared:]` are this request's to free. `digests` memoizes
    the prompt's per-page digests. `probe` is the breaker token taken at
    admission, `trace` the request's timeline across the caller and
    scheduler threads, `sink` the `on_token` callback, and `logprobs`
    the top-K entries asked for, collected in `logprob_values`."""

    __slots__ = ("prompt", "n_tokens", "temperature", "seed", "deadline",
                 "event", "tokens", "error", "n_pages", "pages", "prefill_pos",
                 "hit_len", "n_shared", "nodes", "digests", "enqueued_at",
                 "probe", "trace", "sink", "logprobs", "logprob_values")

    def __init__(self, prompt: np.ndarray, n_tokens: int,
                 temperature: float, seed: int, deadline: Optional[float]):
        self.prompt = prompt
        self.n_tokens = n_tokens
        self.temperature = temperature
        self.seed = seed
        self.deadline = deadline
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
    per token (not with `speculative`). `device` defaults to the card
    and must be the network's device."""

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
                 device="cuda",
                 **options):
        from deeplearning4j_tpu_torch.ops.kernel_dispatch import (
            resolve_device,
        )

        _refuse_unported("DecodeEngine", options, _UNPORTED_OPTIONS)
        if logprobs < 0:
            raise ValueError("logprobs must be >= 0")
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
        self._plan = plan
        self._net = net
        self._params = net._params
        # compute-dtype copies made once: the steps reuse them
        self._bparams = plan.cast_blocks(net._params)
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
                .bind_guard(self._cond)
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
                target_bparams=self._bparams)
        self._reset_device_state()

    def _reset_device_state(self) -> None:
        """Fresh page pools, page table and per-slot state. Callers
        guarantee no slot holds a request; queued requests keep their
        reservations (they hold no device state)."""
        S, dev, P = self.n_slots, self.device, self.pool_pages
        self._caches = _new_pools(self._plan, P, self.page_size,
                                  self._kv_quant, dev)
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
        the slot: token, position, sampling generator, temperature.
        Returns (token, finite flag, logprob triple or None)."""
        from deeplearning4j_tpu_torch.models.transformer import _sample_logits

        gen = torch.Generator(device=self.device).manual_seed(req.seed)
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

        plan, bp, dev = self._plan, self._bparams, self.device
        P = ids.shape[1]
        t0 = req.prompt.shape[0]
        qpos = torch.arange(P, device=dev)
        x = self._embed(torch.as_tensor(ids, device=dev), qpos)
        for bi, i in enumerate(plan.block_is):
            p, layer = bp[i], plan.layers[i]
            q, k, v = _block_heads(layer, p, x, qpos)
            att = _prefill_block_attention(layer, q, k, v)
            x = _block_ffn(layer, p, x + _block_out_proj(
                p, att.reshape(1, P, -1)))
            _write_span(self._caches[bi], k.permute(0, 2, 3, 1),
                        v.permute(0, 2, 1, 3), wpids, 0, self.page_size)
        logits = plan.final_logits(bp, self._params, x[0, t0 - 1][None])
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

        plan, bp, dev = self._plan, self._bparams, self.device
        W = ids.shape[1]
        qpos = off + torch.arange(W, device=dev)
        x = self._embed(torch.as_tensor(ids, device=dev), qpos)
        page_row = self._page_table[slot:slot + 1]
        pos0 = torch.tensor([off], dtype=torch.int32, device=dev)
        for bi, i in enumerate(plan.block_is):
            p, layer = bp[i], plan.layers[i]
            q, k, v = _block_heads(layer, p, x, qpos)
            cache = self._caches[bi]
            _write_span(cache, k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3),
                        wpids, woff, self.page_size)
            att = paged_attention_chunk_auto(q, cache[0], cache[1], page_row,
                                             pos0, **_scales(cache))
            x = _block_ffn(layer, p, x + _block_out_proj(
                p, att.reshape(1, W, -1)))
        ok = torch.isfinite(x.float()).all()
        if not final:
            return None, ok, None
        t0 = req.prompt.shape[0]
        r = min(max(t0 - 1 - off, 0), W - 1)
        logits = plan.final_logits(bp, self._params, x[0, r][None])
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

        plan, bp, page = self._plan, self._bparams, self.page_size
        tok, pos = self._tok, self._pos
        x = self._embed(tok, pos)
        wpos = pos.clamp(max=self._L_logical - 1).long()
        lpage, loff = wpos // page, wpos % page
        pids = torch.where(active_t, self._page_table[self._rows, lpage].long(),
                           0)
        for bi, i in enumerate(plan.block_is):
            p, layer = bp[i], plan.layers[i]
            q, k, v = _block_heads(layer, p, x[:, None, :], pos[:, None])
            q, k, v = q[:, 0], k[:, 0], v[:, 0]
            cache = self._caches[bi]
            _write_step(cache, pids, loff, k, v)
            att = paged_attention_step_auto(q, cache[0], cache[1],
                                            self._page_table, pos, active_t,
                                            **_scales(cache))
            x = _block_ffn(layer, p, x + _block_out_proj(p, att))
        logits = plan.final_logits(bp, self._params, x)
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
                                                     req.nodes or [])
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
        if len(req.tokens) == 1:
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
               timeout: Optional[float] = None, logprobs: int = 0,
               on_token: Optional[Callable] = None,
               **options) -> _GenRequest:
        """Admit one generation request (non-blocking). Typed give-ups:
        `ServerOverloadedError` (queue full), `OutOfPagesError` (queued
        page demand over `max_queued_pages`), `DeadlineExceededError`,
        `ServiceUnavailableError` (breaker open), `ServerClosedError`.
        `logprobs=K` (at most the engine's `logprobs`) asks for per-token
        logprob entries; `on_token(cursor, token, entry)` is called from
        the scheduler thread per emitted token and must not block.
        `request.result()` blocks for the tokens."""
        _refuse_unported("DecodeEngine.submit", options, _UNPORTED_SUBMIT)
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
                          float(temperature), int(seed), deadline)
        req.n_pages = need
        req.trace = trace
        req.logprobs = int(logprobs)
        req.sink = on_token
        with self._cond:
            if self._closed:
                err = ServerClosedError("decode engine is shut down")
                self._shed_obs(trace, err)
                raise err
            now = time.monotonic()
            # expired entries are swept before any capacity verdict: a
            # queue padded with dead requests is not real backpressure
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
            self._pages_demand_queued += need
            self.submitted += 1
            self._queue.append(req)
            trace.event("enqueue", queue_depth=len(self._queue),
                        pages_reserved=need, prompt_len=int(T0),
                        n_tokens=int(n_tokens))
            self._cond.notify_all()
        return req

    def _sweep_expired_locked(self, now: float) -> None:
        """Shed every already-expired queued request with its own
        `DeadlineExceededError`, releasing its page reservation."""
        assert_owned(self._cond, "DecodeEngine._sweep_expired_locked")
        if not any(r.expired(now) for r in self._queue):
            return
        keep: collections.deque = collections.deque()
        for req in self._queue:
            if req.expired(now):
                self._pages_demand_queued -= req.n_pages
                self.shed_deadline += 1
                req.trace.add_timed("queue-wait", req.enqueued_at, now,
                                    decision="expired")
                self._finish_obs(req, DeadlineExceededError(
                    "deadline expired while queued; request shed before "
                    "prefill"))
            else:
                keep.append(req)
        self._queue = keep

    def generate(self, prompt_ids, n_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None, logprobs: int = 0,
                 on_token: Optional[Callable] = None, **options):
        """Blocking convenience: submit + wait. Returns the generated
        tokens (1-D int32; shorter than `n_tokens` only on EOS), or with
        `logprobs=K > 0` a dict ``{"tokens", "logprobs"}`` with one entry
        (chosen-token logprob and the top K) per generated token."""
        req = self.submit(prompt_ids, n_tokens, temperature=temperature,
                          seed=seed, timeout=timeout, logprobs=logprobs,
                          on_token=on_token, **options)
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
                    if r.prefill_pos is not None else t0 + len(r.tokens)
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
                   # the QoS lane (ROADMAP queue A11) is not ported: no
                   # request is preempted or shed by an SLO or a quota
                   "preemptions": 0, "slo_sheds": 0, "shed_quota": 0,
                   "shed_page_quota": 0}
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

    # -- not ported yet (ROADMAP queue A11) ---------------------------------
    def model_bytes_per_chip(self) -> int:
        raise _a11("DecodeEngine.model_bytes_per_chip")

    def set_tenant_quota(self, tenant, rate=None, burst=None,
                         max_pages=None, weight=None) -> None:
        raise _a11("DecodeEngine.set_tenant_quota (QoS)")

    def bind_prefix_directory(self, directory, holder_id, peers=None, **kw):
        raise _a11("DecodeEngine.bind_prefix_directory (cluster prefix "
                   "cache)")

    def prefix_depth(self, prompt_ids, tenant=None) -> int:
        raise _a11("DecodeEngine.prefix_depth (cluster prefix cache)")

    def prefix_chains(self) -> dict:
        raise _a11("DecodeEngine.prefix_chains (cluster prefix cache)")

    def export_prefix(self, prompt_ids, have_pages=0, tenant=None,
                      frame_pages=None, timeout=None) -> dict:
        raise _a11("DecodeEngine.export_prefix (cluster prefix cache)")

    def fetch_handoff(self, handoff_id) -> dict:
        raise _a11("DecodeEngine.fetch_handoff (KV handoff)")

    def fetch_handoff_header(self, handoff_id, skip_pages=0,
                             frame_pages=None) -> dict:
        raise _a11("DecodeEngine.fetch_handoff_header (KV handoff)")

    def fetch_handoff_frame(self, handoff_id, frame, skip_pages=0,
                            frame_pages=None) -> dict:
        raise _a11("DecodeEngine.fetch_handoff_frame (KV handoff)")

    def commit_handoff(self, handoff_id) -> bool:
        raise _a11("DecodeEngine.commit_handoff (KV handoff)")

    def abort_handoff(self, handoff_id) -> bool:
        raise _a11("DecodeEngine.abort_handoff (KV handoff)")

    def resume_submit(self, payload, timeout=None, *, on_token=None):
        raise _a11("DecodeEngine.resume_submit (KV handoff)")

    def resume_generate(self, payload, timeout=None, *, on_token=None):
        raise _a11("DecodeEngine.resume_generate (KV handoff)")

    def migrate_slots(self, wait=5.0) -> int:
        raise _a11("DecodeEngine.migrate_slots (live migration)")

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
                        self._finish_obs(req, ServerClosedError(
                            "engine shut down before this request could be "
                            "served"))
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
        return bool(self._queue)

    def _fail_all_locked(self, err: BaseException) -> None:
        assert_owned(self._cond, "DecodeEngine._fail_all_locked")
        while self._queue:
            req = self._queue.popleft()
            self._pages_demand_queued -= req.n_pages
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

    def _admit(self) -> None:
        """Move queued requests (FIFO) into free slots. An expired head is
        shed before any device work; a head the free list cannot cover
        waits for a retirement, after unreferenced prefix-cache pages
        were reclaimed LRU-first (caching never shrinks effective
        capacity). With a prefix hit, the longest cached chain binds into
        the slot's page table (refcounts bumped), only the uncached tail
        takes fresh pages, and prefill starts at the first uncached page
        boundary. A short cold prompt prefills one-shot at once; a long
        or prefix-hit one is parked mid-prefill for `_step_prefills`.
        With a breaker, each admission takes a token (the half-open probe
        is one request), and an open breaker fails the head typed."""
        while True:
            with self._cond:
                if not self._queue:
                    return
                free = [s for s in range(self.n_slots)
                        if self._slots[s] is None]
                if not free:
                    return
                head = self._queue[0]
                nodes: list = []
                need = head.n_pages
                if not head.expired():
                    if self._prefix_cache is not None:
                        # only the scheduler thread mutates the cache, so
                        # this lookup stays valid through the bind; a
                        # page-blocked head retries every iteration — its
                        # chunk digests are memoized on the request
                        nodes = self._prefix_cache.lookup(head.prompt,
                                                          head.digests)
                        if nodes:
                            need = self._pages_for_hit(
                                head.prompt.shape[0], head.n_tokens) \
                                - len(nodes)
                        if need > len(self._free_pages):
                            # pool pressure: release idle cached pages
                            # (LRU, leaf-first) — the head's own hit chain
                            # is pinned so reclaim cannot eat it
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
                        return
                req = self._queue.popleft()
                self._pages_demand_queued -= req.n_pages
            now = time.monotonic()
            if req.expired(now):
                with self._cond:
                    self.shed_deadline += 1
                req.trace.add_timed("queue-wait", req.enqueued_at, now,
                                    decision="expired")
                self._finish_obs(req, DeadlineExceededError(
                    "deadline expired while queued; request shed before "
                    "prefill"))
                continue
            req.trace.add_timed("queue-wait", req.enqueued_at, now)
            if self.breaker is not None:
                try:
                    req.probe = self.breaker.acquire()
                except ServiceUnavailableError as e:
                    with self._cond:
                        self.shed_unavailable += 1
                    self._finish_obs(req, e)
                    continue
            slot = free[0]
            with self._cond:
                if nodes:
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
                                hit_tokens=req.hit_len, pages_in_use=held)
            row = np.zeros((self._n_pages_max,), np.int32)
            row[:len(req.pages)] = req.pages
            self._page_table[slot] = torch.from_numpy(row).to(self.device)
            if req.hit_len or self._is_chunked(req.prompt.shape[0]):
                with self._cond:
                    # hit requests always ride the chunk path: suffix
                    # prefill starts at the first uncached page boundary
                    # and attends over the shared pages through the
                    # slot's page row
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
        req.trace.add_timed("prefill", tp0, time.monotonic(),
                            bucket=bucket, prompt_len=t0)
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
            self._promote_prefix_locked(req)
        if self._spec is not None:
            self._spec.seed_slot(slot, req.seed)
        req.tokens.append(first)
        self._emit_token(req, lp0)
        if len(req.tokens) >= req.n_tokens or first == self.eos_token:
            self._retire(slot, req, attached=False)
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
            req.trace.add_timed("prefill-chunk", tp0, time.monotonic(),
                                chunk_off=off, width=W, final=final)
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
            self._cond.notify_all()
        if self.breaker is not None:
            self.breaker.record_success(req.probe)
        # the trace rides along so a p99 excursion can pin this request's
        # timeline in the failures ring
        self._gen_latency_hist.observe(
            1e3 * (time.monotonic() - req.enqueued_at), trace=req.trace)
        self.recorder.event("retire", slot=slot, tokens=len(req.tokens))
        self._finish_obs(req)

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
            wl[s] = r.prompt.shape[0] + r.n_tokens - 2
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
                    self._bparams, self._params, self._caches,
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
                    if r.prompt.shape[0] + r.n_tokens > self.max_len:
                        misfit.append(r)
                        continue
                    r.n_pages = self._pages_for(r.prompt.shape[0],
                                                r.n_tokens)
                    if r.n_pages > self.pool_pages or \
                            reserved + r.n_pages > self.max_queued_pages:
                        misfit.append(r)
                        continue
                    reserved += r.n_pages
                    keep.append(r)
                self._queue = keep
                self._pages_demand_queued = reserved
            for r in misfit:
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
