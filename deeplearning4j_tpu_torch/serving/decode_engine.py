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

Greedy decode equals whole-batch `models.transformer.generate` (the two
share the per-block helpers) regardless of admission order, page/slot
reuse or prefill chunking.

Not ported yet (ROADMAP): prefix cache, speculative decoding, int8 KV,
tensor parallelism, QoS, KV handoff and migration, logprobs, breaker
and observability. Passing any of those options raises
`NotImplementedError`.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.model_server import (
    DeadlineExceededError,
    InferenceFailedError,
    OutOfPagesError,
    ServerClosedError,
    ServerOverloadedError,
    ServingError,
    _bucket,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")

# JAX DecodeEngine options this port does not carry yet, with their
# defaults; any other value raises NotImplementedError
_UNPORTED_OPTIONS = {
    "breaker": None, "prefix_cache": None, "speculative": None,
    "recorder": None, "metrics": None, "quantize": None, "excursion": None,
    "parallel": None, "qos": None, "role": "both", "handoff_ttl": 30.0,
    "logprobs": 0,
}
_UNPORTED_SUBMIT = {"tenant": None, "priority": "interactive",
                    "logprobs": 0, "on_token": None}


def _refuse_unported(where: str, given: dict, table: dict) -> None:
    for name, value in given.items():
        if name not in table:
            raise TypeError(f"{where} got an unexpected keyword argument "
                            f"{name!r}")
        if value != table[name]:
            raise NotImplementedError(
                f"{where}({name}=...) is not ported yet (ROADMAP queue A8 "
                "latency/quantization tier, A11 serving cluster tier)")


class _GenRequest:
    """One generation request: queued -> (shed | admitted into a slot,
    prefilled one-shot or chunk by chunk) -> decoding -> (completed |
    expired | failed). `n_pages` is the reservation taken at submit,
    `pages` the pool pages held from admission to retirement,
    `prefill_pos` the next chunk offset while mid-prefill."""

    __slots__ = ("prompt", "n_tokens", "temperature", "seed", "deadline",
                 "event", "tokens", "error", "n_pages", "pages", "prefill_pos")

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
    decode steps between token read-backs. `device` defaults to the card
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
                 device="cuda",
                 **options):
        from deeplearning4j_tpu_torch.ops.kernel_dispatch import (
            resolve_device,
        )

        _refuse_unported("DecodeEngine", options, _UNPORTED_OPTIONS)
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
        self._step_ewma = 0.01  # guarded by: _cond
        self._pages_demand_queued = 0  # guarded by: _cond
        # counters
        self.submitted = 0  # guarded by: _cond
        self.served = 0  # guarded by: _cond
        self.shed_overload = 0  # guarded by: _cond
        self.shed_out_of_pages = 0  # guarded by: _cond
        self.shed_deadline = 0  # guarded by: _cond
        self.failures = 0  # guarded by: _cond
        self.prefills = 0  # guarded by: _cond
        self.prefill_chunks = 0  # guarded by: _cond
        self.decode_steps = 0  # guarded by: _cond
        self.active_slot_steps = 0  # guarded by: _cond
        self.tokens_generated = 0  # guarded by: _cond
        self.pages_in_use_peak = 0  # guarded by: _cond
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
        self._kv_bytes_per_token = sum(2 * hkv * hd * itemsize
                                       for hkv, hd in plan.kv_geometry())
        self._rows = torch.arange(S, device=self.device)
        self._reset_device_state()

    def _reset_device_state(self) -> None:
        """Fresh page pools, page table and per-slot state. Callers
        guarantee no slot holds a request; queued requests keep their
        reservations (they hold no device state)."""
        plan, S, dev = self._plan, self.n_slots, self.device
        page, P = self.page_size, self.pool_pages
        caches = []
        for hkv, hd in plan.kv_geometry():
            # +1: page 0 is the trash page for masked writes
            caches.append(
                (torch.zeros((P + 1, hkv, hd, page), dtype=plan.cdt,
                             device=dev),
                 torch.zeros((P + 1, hkv, page, hd), dtype=plan.cdt,
                             device=dev)))
        self._caches = caches
        self._page_table = torch.zeros((S, self._n_pages_max),
                                       dtype=torch.int32, device=dev)
        self._tok = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._pos = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._temps = np.zeros((S,), np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * S
        with self._cond:
            self._free_pages = list(range(P, 0, -1))  # guarded by: _cond
            self._active = np.zeros((S,), bool)  # guarded by: _cond

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
        the slot: token, position, sampling generator, temperature."""
        from deeplearning4j_tpu_torch.models.transformer import _sample_logits

        gen = torch.Generator(device=self.device).manual_seed(req.seed)
        tok0 = _sample_logits(logits, gen, req.temperature, self.top_k)
        self._tok[slot] = tok0[0]
        self._pos[slot] = t0
        self._gens[slot] = gen
        self._temps[slot] = req.temperature
        return tok0[0], torch.isfinite(logits.float()).all()

    @torch.no_grad()
    def _prefill_math(self, slot: int, req: _GenRequest, ids: np.ndarray,
                      wpids: List[int]):
        """One-shot prefill of one prompt padded to `ids` (1, bucket):
        the same block math as `generate`'s prefill, K/V written into
        the slot's pages. Returns the first token and its finite flag."""
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
            kp, vp = self._caches[bi]
            _write_pages(kp, vp, k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3),
                         wpids, 0, self.page_size)
        logits = plan.final_logits(bp, self._params, x[0, t0 - 1][None])
        return self._first_token(slot, req, logits, t0)

    @torch.no_grad()
    def _prefill_chunk_math(self, slot: int, req: _GenRequest,
                            ids: np.ndarray, off: int, woff: int,
                            wpids: List[int], final: bool):
        """One prefill chunk at absolute positions off..off+W-1: write
        its K/V into `wpids`, then attend through the slot's page row
        (the chunk sees itself through the cache, which is exactly
        causal). Returns (first token or None, finite flag)."""
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
            kp, vp = self._caches[bi]
            _write_pages(kp, vp, k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3),
                         wpids, woff, self.page_size)
            att = paged_attention_chunk_auto(q, kp, vp, page_row, pos0)
            x = _block_ffn(layer, p, x + _block_out_proj(
                p, att.reshape(1, W, -1)))
        ok = torch.isfinite(x.float()).all()
        if not final:
            return None, ok
        t0 = req.prompt.shape[0]
        r = min(max(t0 - 1 - off, 0), W - 1)
        logits = plan.final_logits(bp, self._params, x[0, r][None])
        tok0, ok_logits = self._first_token(slot, req, logits, t0)
        return tok0, ok & ok_logits

    @torch.no_grad()
    def _decode_math(self, active_t):
        """Advance every slot one token. Inactive slots keep their token
        and position, and their cache writes go to the trash page 0, so a
        reallocated page is never corrupted. Returns (tokens (S,),
        per-slot finite flags (S,))."""
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
            kp, vp = self._caches[bi]
            # in place, where the JAX package donates the pools through
            # jit; inactive lanes all land on trash page 0 (duplicate
            # indices there are harmless: nothing reads page 0 unmasked)
            kp[pids, :, :, loff] = k
            vp[pids, :, loff, :] = v
            att = paged_attention_step_auto(q, kp, vp, self._page_table, pos,
                                            active_t)
            x = _block_ffn(layer, p, x + _block_out_proj(p, att))
        logits = plan.final_logits(bp, self._params, x)
        nxt = torch.argmax(logits, dim=-1)
        for s in np.flatnonzero((self._temps > 0) & self._active):
            nxt[s] = _sample_logits(logits[s:s + 1], self._gens[s],
                                    float(self._temps[s]), self.top_k)[0]
        self._tok = torch.where(active_t, nxt, tok)
        self._pos = torch.where(active_t, pos + 1, pos)
        ok = torch.isfinite(logits.float()).all(dim=-1) | ~active_t
        return self._tok, ok

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

    def _free_request_pages_locked(self, req: _GenRequest) -> None:
        if req.pages:
            self._free_pages.extend(req.pages)
        req.pages = None

    # -- public surface ----------------------------------------------------
    def submit(self, prompt_ids, n_tokens: int, *,
               temperature: float = 0.0, seed: int = 0,
               timeout: Optional[float] = None, **options) -> _GenRequest:
        """Admit one generation request (non-blocking). Typed give-ups:
        `ServerOverloadedError` (queue full), `OutOfPagesError` (queued
        page demand over `max_queued_pages`), `DeadlineExceededError`,
        `ServerClosedError`. `request.result()` blocks for the tokens."""
        _refuse_unported("DecodeEngine.submit", options, _UNPORTED_SUBMIT)
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
        timeout = self.default_timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        req = _GenRequest(prompt.astype(np.int64), int(n_tokens),
                          float(temperature), int(seed), deadline)
        req.n_pages = need
        with self._cond:
            if self._closed:
                raise ServerClosedError("decode engine is shut down")
            now = time.monotonic()
            if deadline is not None and deadline <= now:
                self.shed_deadline += 1
                raise DeadlineExceededError(
                    "deadline expired before admission; request shed at "
                    "the door")
            if len(self._queue) >= self.max_queue:
                self.shed_overload += 1
                retry = max(0.001, self._step_ewma
                            * (len(self._queue) / self.n_slots + 1))
                raise ServerOverloadedError(
                    f"generation queue full ({self.max_queue} pending); "
                    f"retry in {retry:.3f}s", retry_after=retry)
            if self._pages_demand_queued \
                    and self._pages_demand_queued + need \
                    > self.max_queued_pages:
                # a lone waiter always queues: only aggregate demand sheds
                self.shed_out_of_pages += 1
                held = self.pool_pages - len(self._free_pages)
                n_live = sum(1 for r in self._slots if r is not None)
                retry = max(0.001, self._step_ewma
                            * (len(self._queue) + n_live + 1))
                raise OutOfPagesError(
                    f"KV page pool exhausted ({held}/{self.pool_pages} pages "
                    f"in use, {self._pages_demand_queued} queued demand of "
                    f"{self.max_queued_pages} allowed; {need} more needed); "
                    f"retry in {retry:.3f}s", retry_after=retry)
            self._pages_demand_queued += need
            self.submitted += 1
            self._queue.append(req)
            self._cond.notify_all()
        return req

    def generate(self, prompt_ids, n_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience: submit + wait for the tokens."""
        return self.submit(prompt_ids, n_tokens, temperature=temperature,
                           seed=seed, timeout=timeout).result()

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
                   "failures": self.failures, "prefills": self.prefills,
                   "prefill_chunks": self.prefill_chunks,
                   "decode_steps": self.decode_steps,
                   "tokens_generated": self.tokens_generated}
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
            "kv_bytes_per_token": self._kv_bytes_per_token,
            "prompt_buckets": list(self.prompt_buckets)})
        return out

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
                    return
                if self._closed:
                    while self._queue:
                        req = self._queue.popleft()
                        self._pages_demand_queued -= req.n_pages
                        req.finish(ServerClosedError(
                            "engine shut down before this request could be "
                            "served"))
                    if not any(r is not None for r in self._slots):
                        self._cond.notify_all()
                        return
            try:
                if not self._closed:
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

    def _work_pending(self) -> bool:
        return any(r is not None for r in self._slots) or bool(self._queue)

    def _fail_all_locked(self, err: BaseException) -> None:
        while self._queue:
            req = self._queue.popleft()
            self._pages_demand_queued -= req.n_pages
            req.finish(err)
        for s, req in enumerate(self._slots):
            if req is not None:
                self._slots[s] = None
                self._active[s] = False
                self._free_request_pages_locked(req)
                req.finish(err)
        self._cond.notify_all()

    def _admit(self) -> None:
        """Move queued requests (FIFO) into free slots. An expired head is
        shed before any device work; a head the free list cannot cover
        waits for a retirement. A short prompt prefills one-shot at once;
        a long one is parked mid-prefill for `_step_prefills`."""
        while True:
            with self._cond:
                if not self._queue:
                    return
                free = [s for s in range(self.n_slots)
                        if self._slots[s] is None]
                if not free:
                    return
                head = self._queue[0]
                if not head.expired() and head.n_pages > len(self._free_pages):
                    return
                req = self._queue.popleft()
                self._pages_demand_queued -= req.n_pages
                if req.expired():
                    self.shed_deadline += 1
                    req.finish(DeadlineExceededError(
                        "deadline expired while queued; request shed before "
                        "prefill"))
                    continue
                slot = free[0]
                req.pages = [self._free_pages.pop()
                             for _ in range(req.n_pages)]
                self.pages_in_use_peak = max(
                    self.pages_in_use_peak,
                    self.pool_pages - len(self._free_pages))
            row = np.zeros((self._n_pages_max,), np.int32)
            row[:len(req.pages)] = req.pages
            self._page_table[slot] = torch.from_numpy(row).to(self.device)
            if self._is_chunked(req.prompt.shape[0]):
                with self._cond:
                    req.prefill_pos = 0
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
            tok0, ok = self._prefill_math(slot, req, ids, wpids)
            # the one host read-back of this dispatch
            return torch.stack([tok0, ok.long()]).tolist()

        first, ok = _dispatched(run)
        if not ok:
            raise InferenceFailedError(
                "model produced non-finite logits during prefill")
        self._hook("post_prefill", info)
        with self._cond:
            self.prefills += 1
            self.tokens_generated += 1
        req.tokens.append(first)
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
            # final chunk padded only to the next page multiple (<= C)
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
            tok0, ok = self._prefill_chunk_math(slot, req, ids, off, woff,
                                                pids, final)
            if tok0 is None:
                return None, bool(ok)
            return torch.stack([tok0, ok.long()]).tolist()

        try:
            first, ok = _dispatched(run)
            if not ok:
                raise InferenceFailedError(
                    "model produced non-finite activations during chunked "
                    "prefill")
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
        req.tokens.append(first)
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
        req.finish(err)
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
                    r.finish(err)
            self._cond.notify_all()

    def _retire(self, slot: int, req: _GenRequest, *,
                attached: bool = True) -> None:
        """Successful completion: free the slot and its pages, deliver."""
        with self._cond:
            if attached:
                self._slots[slot] = None
                self._active[slot] = False
            self._free_request_pages_locked(req)
            self.served += 1
            self._cond.notify_all()
        req.finish()

    def _expire_in_flight(self) -> None:
        """Shed expired queued requests, and free the slot and pages of
        an expired in-flight one (decoding or mid-prefill)."""
        now = time.monotonic()
        with self._cond:
            keep = collections.deque()
            for req in self._queue:
                if req.expired(now):
                    self._pages_demand_queued -= req.n_pages
                    self.shed_deadline += 1
                    req.finish(DeadlineExceededError(
                        "deadline expired while queued; request shed before "
                        "prefill"))
                else:
                    keep.append(req)
            self._queue = keep
            for s in range(self.n_slots):
                req = self._slots[s]
                if req is not None and req.expired(now):
                    self._slots[s] = None
                    self._active[s] = False
                    self._free_request_pages_locked(req)
                    self.shed_deadline += 1
                    self._cond.notify_all()
                    req.finish(DeadlineExceededError(
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
                self._slots[s] = None
                self._active[s] = False
                self._free_request_pages_locked(req)
                req.finish(err)
            self._cond.notify_all()
        if getattr(e, "_dispatch_failure", False):
            self._fail_occupied_slots(InferenceFailedError(
                "paged KV pool lost to a failed decode dispatch"))
            self._reset_device_state()

    def _retire_or_poison(self, s: int, req: _GenRequest, toks, oks,
                          n_steps: int) -> None:
        """Append one slot's tokens from a decode run until done (count
        or EOS; overshoot is dropped with the slot) or until a non-finite
        step fails the request while healthy neighbours keep decoding."""
        for t in range(n_steps):
            if not oks[t]:
                with self._cond:
                    self.failures += 1
                    self._slots[s] = None
                    self._active[s] = False
                    self._free_request_pages_locked(req)
                    self._cond.notify_all()
                req.finish(InferenceFailedError(
                    "model produced non-finite logits during decode"))
                return
            tok = int(toks[t])
            req.tokens.append(tok)
            with self._cond:
                self.tokens_generated += 1
            if len(req.tokens) >= req.n_tokens or tok == self.eos_token:
                self._retire(s, req)
                return

    def _step_active(self) -> None:
        live = [(s, r) for s, r in enumerate(self._slots)
                if r is not None and r.prefill_pos is None]
        if not live:
            return
        t0 = time.monotonic()
        n_steps = self.decode_chunk if self._chunk_eligible(live, t0) else 1
        info = {"active": len(live), "step": self.decode_steps,
                "chunk": n_steps}
        try:
            self._hook("pre_decode", info)

            def run():
                active_t = torch.from_numpy(self._active.copy()).to(
                    self.device)
                steps = [self._decode_math(active_t) for _ in range(n_steps)]
                toks = torch.stack([t for t, _ in steps])
                oks = torch.stack([o for _, o in steps])
                # the one host read-back per run: (n_steps, S) tokens and
                # per-step finite flags
                return toks.cpu().numpy(), oks.cpu().numpy()

            toks, oks = _dispatched(run)
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
            self._retire_or_poison(s, req, toks[:, s], oks[:, s], n_steps)
