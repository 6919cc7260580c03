"""Quantized inference tier: int8 paged KV cache + int8/bf16 weight
serving (counterpart of `deeplearning4j_tpu/serving/quantize.py`).

The serving decode path is bound by the KV bytes it reads. This module
halves them against bf16: K/V are quantized to **symmetric per-head int8
at cache-write time** and dequantized at the read site — inside the page
walk of the CUDA kernel on the card (`csrc/paged_attention.cu`, int8
pages and scale rows staged, dequantized where the products read them)
and in `ops.attention.paged_gather_quant`, the plain version, on the CPU.

**Scale layout.** Pools stay in the decode layouts with int8 elements —
K `(P+1, Hkv, hd, page)`, V `(P+1, Hkv, page, hd)` — plus two small f32
scale pools `(P+1, Hkv, page)`: one scale per (page, head, position).
Per-position granularity (not per-page) is what makes the page pools
soundly *appendable*: the decode step writes one position into a page
that already holds earlier positions, and a coarser per-page scale
could only absorb the new abs-max by re-scaling (rewriting) the old
int8 entries or clipping against a stale bound. One f32 scalar per
(head, position) costs ``4/hd`` of the int8 payload (~3% at hd=128) and
rides the SAME page table / free list / refcounts as the payload pools —
PrefixCache sharing, speculative draft pools and trash-page masking
(int8 zeros dequantize to exact 0.0) all work unchanged.

The writes are plain torch ops, in place on the pools; `torch.round`
rounds half to even as `jnp.round` does, and the quotient is the f32
division `x / scale`, not a multiply by a reciprocal, so both packages
quantize a value to the same int8.

**Weight quantization** (`quantize_net_weights`) follows the LLM.int8
per-output-channel recipe (Dettmers et al., 2022): symmetric int8 over
the contraction axis, stored dequantized-to-bf16 so every serving path
runs unmodified; ``"bf16"`` is the plain cast. Embeddings, positional
tables, biases and LayerNorm parameters keep full precision.

**Drift gates** (`drift_report`): argmax disagreement and perplexity
delta of a candidate against a reference on a pinned eval set (numpy).
`ModelServer(quantize={"weights": ...}, drift_gate={...})` enforces them
at construction and on every reload candidate, after the canary and
before the swap (`serving/model_server.py`, `_check_drift_gate`).

Not carried over: the JAX package's `int8_kv_enabled` and its
``DL4J_TPU_NO_INT8_KV`` environment switch. This package has no switch
that turns a kernel or a tier off: an engine built with
``quantize={"kv": "int8"}`` has int8 pools.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

#: block-parameter matmul weights eligible for weight quantization
#: (attention projections + FFN/SwiGLU); everything else — embedding,
#: positional table, biases, LayerNorm gains — keeps full precision
BLOCK_MATMUL_KEYS = ("Wqkv", "Wo", "W1", "W2", "W3")


# -- int8 KV quantization ---------------------------------------------------

def quantize_heads(x: torch.Tensor, axis: int = -1):
    """Symmetric per-head int8 quantization of one KV write span.

    Reduces abs-max over `axis` (the head_dim axis of the span — the
    last axis for the decode step's (S, Hkv, hd) single-position write,
    axis 2 / 3 for the prefill span's lane-last (1, Hkv, hd, W) /
    (1, Hkv, W, hd) layouts), yielding one f32 scale per (head,
    position). Returns ``(q, scale)`` with ``q`` int8 in [-127, 127]
    and ``scale = abs_max / 127`` (1.0 for all-zero spans, so dequant
    is exact 0.0 — the trash-page convention). Round-trip error is
    bounded by scale/2 per element."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale.unsqueeze(axis))
    return q.clamp(-127.0, 127.0).to(torch.int8), scale


def dequantize_heads(q: torch.Tensor, scale: torch.Tensor, axis: int = -1,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Inverse of `quantize_heads`: broadcast the per-(head, position)
    scale back over `axis`. The plain read path
    (`ops.attention.paged_gather_quant`) inlines exactly this."""
    out = q.float() * scale.unsqueeze(axis)
    return out if dtype is None else out.to(dtype)


def _write_scale_pages(sp, scol, wpids, woff: int, page: int) -> None:
    """Write one prefill span's per-position scales (1, Hkv, W) into the
    f32 scale pool (P+1, Hkv, page), in place — the write discipline of
    `decode_engine._write_pages` with the position axis last:
    floor(W/page) whole pages, then a partial tail at in-page offset
    `woff`, which raises if it would run past the page."""
    W = scol.shape[2]
    nfull = W // page
    for j in range(nfull):
        sp[wpids[j]] = scol[0, :, j * page:(j + 1) * page]
    rem = W - nfull * page
    if rem:
        if woff + rem > page:
            raise ValueError(f"prefill span of {rem} at page offset {woff} "
                             f"runs past the {page}-entry page")
        sp[wpids[nfull], :, woff:woff + rem] = scol[0, :, nfull * page:]


def kv_bytes_per_token(kv_geometry: Sequence[Tuple[int, int]],
                       kv_quant: Optional[str],
                       cache_itemsize: int) -> int:
    """Resident KV bytes one generated token adds across all blocks —
    the number `stats()["kv_bytes_per_token"]` reports. int8 pools pay
    1 byte/element plus the f32 scale sidecar (2 heads-worth of 4-byte
    scalars per position — ``8·Hkv`` vs the payload's ``2·Hkv·hd``, i.e.
    a 4/hd overhead); full-precision pools pay ``cache_itemsize`` per
    element. `kv_geometry` is `GPTPlan.kv_geometry()`: per-block
    (Hkv, hd) pairs."""
    total = 0
    for Hkv, hd in kv_geometry:
        if kv_quant == "int8":
            total += 2 * Hkv * hd + 2 * Hkv * 4
        else:
            total += 2 * Hkv * hd * cache_itemsize
    return total


# -- weight quantization ----------------------------------------------------

def quantize_weight_int8(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 fake-quantization of one matmul
    weight, stored dequantized-to-bf16. The scale reduces over axis -2 —
    the contraction (input) dimension — so each output channel keeps its
    own dynamic range. Works for 2-D (d_in, d_out) and any
    leading-batched layout."""
    wf = torch.as_tensor(w).float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(wf / scale).clamp(-127.0, 127.0)
    return (q * scale).to(torch.bfloat16)


def quantize_net_weights(net, mode: str):
    """Clone `net` with its transformer matmul weights quantized.

    ``mode="int8"``: per-output-channel symmetric int8
    (`quantize_weight_int8`), dequantized to bf16 values and kept in the
    network's parameter dtype — every serving path runs unmodified on
    the quantized clone. ``mode="bf16"``: plain
    bf16 cast of the same weight set. Both quantize the block
    projections (`BLOCK_MATMUL_KEYS`) and the output head's ``W``;
    embeddings, positional tables, biases and LayerNorm parameters keep
    full precision. The original `net` is untouched."""
    if mode not in ("int8", "bf16"):
        raise ValueError(
            f'unknown weight quantization mode {mode!r} — expected '
            '"int8" or "bf16"')
    from deeplearning4j_tpu_torch.models.transformer import GPTPlan
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    plan = GPTPlan(net)
    to_bf16 = quantize_weight_int8 if mode == "int8" \
        else (lambda w: w.to(torch.bfloat16))

    def cast(w):
        # the values are bf16's; they go back into the parameter dtype,
        # because PyTorch multiplies an f32 activation by a bf16 weight
        # only after an explicit cast, where JAX promotes
        return to_bf16(w).to(w.dtype)

    params = [dict(p) for p in net._params]
    for i in plan.block_is:
        for key in BLOCK_MATMUL_KEYS:
            w = params[i].get(key)
            if w is not None and w.ndim >= 2:
                params[i][key] = cast(w)
    out_w = params[plan.out_i].get("W")
    if out_w is not None and out_w.ndim >= 2:
        params[plan.out_i]["W"] = cast(out_w)
    clone = MultiLayerNetwork(net.conf, dtype=net.dtype,
                              compute_dtype=net.compute_dtype,
                              device=net.device)
    clone.init()  # allocates layer state; params replaced wholesale
    clone._params = params
    return clone


# -- drift gates -------------------------------------------------------------

def _log_softmax(out: np.ndarray) -> np.ndarray:
    m = out.max(axis=-1, keepdims=True)
    lse = m + np.log(np.exp(out - m).sum(axis=-1, keepdims=True))
    return out - lse


def argmax_drift_rate(ref_out: np.ndarray, cand_out: np.ndarray) -> float:
    """Token-disagreement rate between two models' outputs (B, T, V)
    over a pinned eval set: the fraction of positions whose greedy
    (argmax) token differs. Greedy decode emits exactly these argmaxes,
    so a 0.0 rate means the candidate serves identical greedy tokens on
    the eval set."""
    ref = np.argmax(np.asarray(ref_out), axis=-1)
    cand = np.argmax(np.asarray(cand_out), axis=-1)
    return float(np.mean(ref != cand))


def perplexity(out: np.ndarray, ids: np.ndarray) -> float:
    """Next-token perplexity of `ids` (B, T) under model outputs `out`
    (B, T, V): position t's output scores token t+1. `out` is treated
    as unnormalized logits (log-softmax applied here); already-
    normalized log-probs pass through unchanged, so the DELTA between
    two models is well-defined either way."""
    out = np.asarray(out, np.float64)
    ids = np.asarray(ids)
    logp = _log_softmax(out[:, :-1, :])
    B, Tm1 = ids.shape[0], ids.shape[1] - 1
    nll = -logp[np.arange(B)[:, None], np.arange(Tm1)[None, :],
                ids[:, 1:]]
    return float(np.exp(nll.mean()))


def drift_report(ref_out: np.ndarray, cand_out: np.ndarray,
                 ids: np.ndarray) -> dict:
    """The drift numbers of one (reference, candidate) pair on the
    pinned eval set: argmax disagreement rate plus the perplexity delta
    (candidate - reference; positive = worse)."""
    rate = argmax_drift_rate(ref_out, cand_out)
    ppl_ref = perplexity(ref_out, ids)
    ppl_cand = perplexity(cand_out, ids)
    return {"argmax_drift": round(rate, 6),
            "ppl_ref": round(ppl_ref, 6),
            "ppl_cand": round(ppl_cand, 6),
            "ppl_delta": round(ppl_cand - ppl_ref, 6)}


def __getattr__(name):
    if name in ("KV_KILL_ENV", "int8_kv_enabled"):
        raise NotImplementedError(
            f"serving.quantize.{name} is not carried over: the port has no "
            "switch that turns a tier off (ROADMAP queue C3, closed: not "
            "ported by design; ground rule 4: no kill switch)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
