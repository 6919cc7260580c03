"""KV-page shipping between decode engines: wire format, leases, disagg
(counterpart of `deeplearning4j_tpu/serving/kv_transfer.py`: the same
payload fields, page layouts, checksums, frames, leases and degradation
ladder, so a handoff written by either package verifies and resumes in
the other).

A serialized handoff payload carries everything a peer needs to resume a
generation mid-sequence with the same output: the used KV pages of every
block (K `(n, Hkv, hd, page)`, V `(n, Hkv, page, hd)`, and for int8 pools
the f32 scales `(n, Hkv, page)`), the page span, the slot's position and
last-token registers, the sampling state, and the emitted transcript.

Fault discipline, because the wire is the failure domain:

- **Leases with TTL**: the sender never frees shipped pages on export; a
  lease holds them (and any prefix-cache pins) until the receiver
  commits or aborts, or the TTL runs out. Pages are freed exactly once.
- **Per-page checksums**: every page slice is hashed at build and again
  at import; a corrupted frame is a typed `KVTransferError`, never
  silently wrong tokens.
- **Degradation ladder**: any transfer failure maps to a typed error and
  the caller falls back to re-prefill from the prompt.

**How a bf16 leaf is held.** numpy has no bfloat16 of its own. The JAX
package ships `ml_dtypes` bfloat16 arrays, and `page_checksum` hashes the
dtype's name ("bfloat16"), the shape and the bytes. This package holds a
bf16 leaf as a numpy ``uint16`` array of the same bits and names its
logical dtype in the payload's ``"dtypes"`` field (``{"k": "bfloat16",
"v": "bfloat16"}``); `page_checksum(page, dtype="bfloat16")` then hashes
exactly what the JAX package hashes, so the sums agree bit for bit
without `ml_dtypes`. A leaf whose numpy dtype already says "bfloat16" (a
JAX payload, where `ml_dtypes` is installed) is read as it is.
`to_bits_payload` and `from_bits_payload` convert between the two forms.

**Sampling state.** The payload's ``"key"`` field is the JAX package's
two-word threefry key. This package samples from a `torch.Generator` per
slot and ships its state in an extra ``"sampler"`` field (the generator's
state bytes and its device type), which the JAX package ignores; a warm
resume on the same kind of device continues that stream exactly. Its own
``"key"`` is ``[0, seed]``, the words of ``PRNGKey(seed)``. A payload
without a usable ``"sampler"`` (one the JAX package wrote) seeds the
slot's generator with ``(key[0] << 32 | key[1]) mod 2**63``, so the same
payload always resumes the same stream. Greedy requests do not draw.

Consumers: `DisaggCoordinator` (prefill-role servers ship freshly
computed KV to decode-role servers) and live migration
(`DecodeEngine.migrate_slots`).
"""
from __future__ import annotations

import hashlib
import logging
import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.serving.model_server import (
    DeadlineExceededError,
    ServerClosedError,
    ServingError,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")

WIRE_VERSION = 1

# payload fields every well-formed handoff must carry (block arrays are
# validated separately — their shapes depend on kind/quantization)
_REQUIRED_FIELDS = (
    "version", "handoff_id", "kind", "weight_version", "kv_quant",
    "page_size", "n_blocks", "prompt", "n_tokens", "temperature",
    "seed", "resumed_at", "tokens", "pages_shipped", "blocks", "sums",
)


class KVTransferError(ServingError):
    """A KV handoff could not be completed or trusted: checksum
    mismatch, truncated frame, expired/unknown lease, weight-version or
    geometry skew, or a role refusal. Always recoverable by the
    fallback ladder — re-prefill from the prompt reproduces the exact
    output."""


class SlotMigratedError(ServingError):
    """Not a failure: a redirect. The engine exported this request's
    decode state under a lease instead of finishing it; the caller
    should fetch the handoff payload with `fetch_handoff(handoff_id)`,
    resume it on a peer, and splice `tokens` (everything emitted before
    export) in front of the peer's tail."""

    def __init__(self, message: str, handoff_id: str = "",
                 tokens: Optional[List[int]] = None,
                 source: Optional[str] = None):
        super().__init__(message)
        self.handoff_id = handoff_id
        self.tokens = list(tokens or [])
        self.source = source

    def wire_payload(self) -> dict:
        # rides the gateway error frame so a remote caller can rebuild
        # the redirect with its routing fields intact
        return {"handoff_id": self.handoff_id,
                "tokens": [int(t) for t in self.tokens],
                "source": self.source}


# ---------------------------------------------------------------------------
# checksums + payload build/verify


BF16 = "bfloat16"


def page_checksum(page: np.ndarray, dtype: Optional[str] = None) -> str:
    """Stable 64-bit content hash of one page slice (dtype- and
    shape-sensitive, so a truncated or re-typed frame can never collide
    with the original). `dtype` names the logical dtype of a leaf held as
    bits (``"bfloat16"`` for a uint16 array); by default the array's own
    dtype name is hashed."""
    arr = np.ascontiguousarray(page)
    h = hashlib.blake2b(digest_size=8)
    h.update((dtype or str(arr.dtype)).encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def _block_sums(block: Dict[str, np.ndarray],
                dtypes: Optional[Dict[str, str]] = None
                ) -> Dict[str, List[str]]:
    dtypes = dtypes or {}
    return {name: [page_checksum(arr[i], dtypes.get(name))
                   for i in range(arr.shape[0])]
            for name, arr in block.items()}


def leaf_from_tensor(t):
    """A pool slice (torch tensor) as a host numpy leaf and its logical
    dtype name: bf16 as uint16 bits with ``"bfloat16"``, anything else
    as itself with None."""
    import torch

    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    return t.numpy(), None


def leaf_to_tensor(arr, dtype: Optional[str] = None):
    """A payload leaf as a CPU tensor: uint16 bits named ``"bfloat16"``
    (or an array whose dtype says bfloat16) become a bf16 tensor of the
    same bits; anything else keeps its dtype."""
    import torch

    arr = np.ascontiguousarray(arr)
    if (dtype or str(arr.dtype)) == BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def to_bits_payload(payload: dict) -> dict:
    """A payload whose bf16 leaves are held as uint16 bits with their
    logical dtype in ``"dtypes"`` (this package's form), from one whose
    leaves carry a bfloat16 numpy dtype (the JAX package's, through
    `ml_dtypes`). The checksums are unchanged."""
    out = dict(payload)
    dtypes = dict(payload.get("dtypes") or {})
    blocks = []
    for block in payload.get("blocks", ()):
        nb = {}
        for name, arr in block.items():
            arr = np.asarray(arr)
            if str(arr.dtype) == BF16:
                arr = arr.view(np.uint16)
                dtypes[name] = BF16
            nb[name] = arr
        blocks.append(nb)
    out["blocks"] = blocks
    if dtypes:
        out["dtypes"] = dtypes
    return out


def from_bits_payload(payload: dict, bfloat16) -> dict:
    """The inverse of `to_bits_payload`: leaves named ``"bfloat16"`` in
    ``"dtypes"`` viewed as the numpy dtype `bfloat16` the caller supplies
    (`ml_dtypes.bfloat16`, which this package does not import), and the
    ``"dtypes"`` field dropped. The checksums are unchanged."""
    dtypes = payload.get("dtypes") or {}
    out = {k: v for k, v in payload.items() if k != "dtypes"}
    out["blocks"] = [
        {name: (np.asarray(arr).view(bfloat16) if dtypes.get(name) == BF16
                else np.asarray(arr))
         for name, arr in block.items()}
        for block in payload.get("blocks", ())]
    return out


def payload_nbytes(payload: dict) -> int:
    """Wire-side KV bytes of a handoff (pages + scales, excluding the
    scalar envelope) — the numerator of kv_transfer_mbytes_per_sec."""
    return sum(int(arr.nbytes)
               for block in payload.get("blocks", ())
               for arr in block.values())


def build_payload(*, handoff_id: str, kind: str, weight_version: str,
                  kv_quant: Optional[str], page_size: int, n_blocks: int,
                  prompt: np.ndarray, n_tokens: int, temperature: float,
                  seed: int, resumed_at: int, tokens: List[int],
                  blocks: List[Dict[str, np.ndarray]],
                  pages_shipped: int, pos: int = 0, tok: int = 0,
                  key: Optional[np.ndarray] = None, temp: float = 0.0,
                  tenant: Optional[str] = None, priority: str = "normal",
                  preempted: int = 0,
                  deadline_remaining: Optional[float] = None,
                  source: Optional[str] = None,
                  logprobs: int = 0,
                  logprob_values: Optional[List[dict]] = None,
                  pages_omitted: int = 0,
                  dtypes: Optional[Dict[str, str]] = None,
                  sampler: Optional[dict] = None) -> dict:
    """Assemble one handoff payload (checksums computed here). All
    leaves are plain scalars / lists / numpy arrays, so the gateway's
    recursive codec ships it without a custom frame type.

    `pages_omitted` is the DELTA-transfer contract: the shipped blocks
    cover logical pages ``[pages_omitted, pages_omitted +
    pages_shipped)`` of the sequence; the receiver supplies the first
    `pages_omitted` pages from its own resident prefix chain (and must
    refuse the payload, typed, if it cannot).

    `dtypes` names the logical dtype of leaves held as bits (see the
    module docstring); `sampler` is the slot's sampling-generator state
    (``{"state": uint8 array, "device": "cuda" | "cpu"}``)."""
    payload = {
        "version": WIRE_VERSION,
        "handoff_id": handoff_id,
        # "warm" = KV pages ride along; "cold" = re-prefill;
        # "prefix" = prompt-prefix pages only (cluster prefix fetch)
        "kind": kind,
        "weight_version": weight_version,
        "kv_quant": kv_quant,
        "page_size": int(page_size),
        "n_blocks": int(n_blocks),
        "prompt": np.asarray(prompt, np.int32),
        "n_tokens": int(n_tokens),
        "temperature": float(temperature),
        "seed": int(seed),
        "tenant": tenant,
        "priority": priority,
        "resumed_at": int(resumed_at),
        "preempted": int(preempted),
        "tokens": [int(t) for t in tokens],
        "deadline_remaining": (None if deadline_remaining is None
                               else float(deadline_remaining)),
        "pos": int(pos),
        "tok": int(tok),
        "key": (np.zeros((2,), np.uint32) if key is None
                else np.asarray(key, np.uint32)),
        "temp": float(temp),
        "pages_shipped": int(pages_shipped),
        "pages_omitted": int(pages_omitted),
        "blocks": blocks,
        "sums": [_block_sums(b, dtypes) for b in blocks],
        "source": source,
        # streaming/logprobs state rides the handoff so the peer keeps
        # emitting per-step entries under the same cursor
        "logprobs": int(logprobs),
        "logprob_values": list(logprob_values or []),
    }
    if dtypes:
        payload["dtypes"] = dict(dtypes)
    if sampler is not None:
        payload["sampler"] = sampler
    return payload


def verify_payload(payload: dict, *, weight_version: Optional[str] = None,
                   kv_quant: Optional[str] = "unchecked",
                   page_size: Optional[int] = None,
                   n_blocks: Optional[int] = None,
                   max_len: Optional[int] = None,
                   kinds=("warm", "cold")) -> dict:
    """Validate a handoff payload structurally and against the
    receiving engine's geometry, then re-verify every page checksum.
    Raises the typed `KVTransferError` on ANY discrepancy — a payload
    that fails here has touched no engine state. `kinds` is the
    caller's acceptance policy: `resume_submit` takes warm/cold, the
    cluster prefix-fetch path takes only "prefix" — a payload of the
    wrong kind is refused typed, never half-bound."""
    if not isinstance(payload, dict):
        raise KVTransferError(
            f"malformed handoff payload: expected dict, got "
            f"{type(payload).__name__}")
    missing = [f for f in _REQUIRED_FIELDS if f not in payload]
    if missing:
        raise KVTransferError(
            f"truncated handoff payload: missing fields {missing}")
    if int(payload["version"]) != WIRE_VERSION:
        raise KVTransferError(
            f"handoff wire version {payload['version']} != "
            f"{WIRE_VERSION}")
    if payload["kind"] not in ("warm", "cold", "prefix"):
        raise KVTransferError(
            f"unknown handoff kind {payload['kind']!r}")
    if payload["kind"] not in kinds:
        raise KVTransferError(
            f"handoff kind {payload['kind']!r} refused here "
            f"(acceptable: {list(kinds)})")
    if weight_version is not None \
            and payload["weight_version"] != weight_version:
        raise KVTransferError(
            "stale-weights handoff refused: sender weight version "
            f"{payload['weight_version']} != receiver {weight_version}")
    if kv_quant != "unchecked" and payload["kv_quant"] != kv_quant:
        raise KVTransferError(
            f"KV quantization mismatch: sender {payload['kv_quant']!r} "
            f"!= receiver {kv_quant!r}")
    if page_size is not None and int(payload["page_size"]) != page_size:
        raise KVTransferError(
            f"page-size mismatch: sender {payload['page_size']} != "
            f"receiver {page_size}")
    if n_blocks is not None and int(payload["n_blocks"]) != n_blocks:
        raise KVTransferError(
            f"block-count mismatch: sender {payload['n_blocks']} != "
            f"receiver {n_blocks}")
    prompt = np.asarray(payload["prompt"])
    if prompt.ndim != 1 or prompt.size == 0:
        raise KVTransferError("handoff prompt must be a non-empty 1-D "
                              f"array, got shape {prompt.shape}")
    n_tok = int(payload["n_tokens"])
    resumed_at = int(payload["resumed_at"])
    if not 0 <= resumed_at <= n_tok:
        raise KVTransferError(
            f"handoff resumed_at={resumed_at} outside [0, {n_tok}]")
    if len(payload["tokens"]) > n_tok:
        raise KVTransferError(
            f"handoff carries {len(payload['tokens'])} emitted tokens "
            f"but n_tokens={n_tok}")
    if max_len is not None:
        span = prompt.shape[0] + max(1, n_tok - resumed_at) - 1
        if span > max_len:
            raise KVTransferError(
                f"handoff span {span} exceeds receiver max_len "
                f"{max_len}")
    shipped = int(payload["pages_shipped"])
    omitted = int(payload.get("pages_omitted", 0))
    if omitted < 0:
        raise KVTransferError(
            f"handoff pages_omitted={omitted} must be >= 0")
    blocks = payload["blocks"]
    sums = payload["sums"]
    if payload["kind"] == "cold":
        if shipped != 0 or blocks:
            raise KVTransferError("cold handoff must carry zero pages")
        return payload
    if shipped <= 0:
        raise KVTransferError(
            f"{payload['kind']} handoff carries zero shipped pages")
    if len(blocks) != len(sums):
        raise KVTransferError(
            f"truncated handoff: {len(blocks)} blocks vs "
            f"{len(sums)} checksum sets")
    if n_blocks is not None and len(blocks) != n_blocks:
        raise KVTransferError(
            f"truncated handoff: {len(blocks)} blocks shipped, "
            f"receiver has {n_blocks}")
    dtypes = payload.get("dtypes") or {}
    for bi, (block, ref) in enumerate(zip(blocks, sums)):
        if set(block) != set(ref):
            raise KVTransferError(
                f"handoff block {bi} tensors {sorted(block)} != "
                f"checksummed {sorted(ref)}")
        for name, arr in block.items():
            arr = np.asarray(arr)
            if arr.shape[0] != shipped or len(ref[name]) != shipped:
                raise KVTransferError(
                    f"truncated handoff: block {bi} tensor {name!r} "
                    f"ships {arr.shape[0]} pages / {len(ref[name])} "
                    f"sums, expected {shipped}")
            for i in range(shipped):
                got = page_checksum(arr[i], dtypes.get(name))
                if got != ref[name][i]:
                    raise KVTransferError(
                        f"corrupted handoff frame: block {bi} tensor "
                        f"{name!r} page {i} checksum {got} != "
                        f"{ref[name][i]}")
    return payload


# ---------------------------------------------------------------------------
# delta framing — ship only what the receiver lacks, in bounded frames
#
# A 32k-token handoff serialized as ONE message is both a memory spike
# and an all-or-nothing wire unit. The frame protocol splits a leased
# payload into a blockless HEADER (scalars + per-page checksums) plus N
# bounded FRAMES of page slices, and lets the receiver skip the leading
# pages it already holds for the sequence's prefix chain
# (`pages_omitted`). The header's checksums are sliced to exactly the
# shipped span, so `verify_payload` on the reassembled payload re-proves
# every page end-to-end — a frame corrupted, duplicated, reordered, or
# dropped in transit is a typed refusal, never silently-wrong tokens.

_FRAME_META = ("n_frames", "frame_pages")


def payload_header(payload: dict, *, skip_pages: int = 0,
                   frame_pages: Optional[int] = None) -> dict:
    """Blockless copy of a leased payload, advanced by `skip_pages`
    already-held pages and annotated with the frame schedule
    (`n_frames`, `frame_pages`). The caller clamps `skip_pages` to what
    the receiver proved it holds; this function clamps it to the
    shipped span (at least one page always ships — the resume point's
    page is never elidable)."""
    shipped = int(payload["pages_shipped"])
    skip = max(0, min(int(skip_pages), shipped - 1))
    fp = shipped - skip if frame_pages is None else int(frame_pages)
    if fp < 1:
        raise KVTransferError(f"frame_pages must be >= 1, got {fp}")
    header = {k: v for k, v in payload.items() if k != "blocks"}
    header["sums"] = [{name: sums[skip:] for name, sums in ref.items()}
                      for ref in payload["sums"]]
    header["pages_shipped"] = shipped - skip
    header["pages_omitted"] = int(payload.get("pages_omitted", 0)) + skip
    header["n_frames"] = -(-(shipped - skip) // fp)
    header["frame_pages"] = fp
    return header


def slice_frame(payload: dict, frame: int, *, skip_pages: int = 0,
                frame_pages: Optional[int] = None) -> dict:
    """One bounded frame of a leased payload: page slices
    ``[skip + frame*fp, skip + (frame+1)*fp)`` of every block tensor.
    Stateless — the receiver passes back the (skip, frame_pages) pair
    from its header, so the sender keeps no per-receiver cursor."""
    shipped = int(payload["pages_shipped"])
    skip = max(0, min(int(skip_pages), shipped - 1))
    fp = shipped - skip if frame_pages is None else int(frame_pages)
    if fp < 1:
        raise KVTransferError(f"frame_pages must be >= 1, got {fp}")
    n_frames = -(-(shipped - skip) // fp)
    if not 0 <= int(frame) < n_frames:
        raise KVTransferError(
            f"frame {frame} outside [0, {n_frames}) for "
            f"{shipped - skip} shipped pages / {fp} per frame")
    lo = skip + int(frame) * fp
    hi = min(skip + (int(frame) + 1) * fp, shipped)
    return {"handoff_id": payload["handoff_id"],
            "frame": int(frame), "n_frames": n_frames,
            "blocks": [{name: np.asarray(arr)[lo:hi]
                        for name, arr in block.items()}
                       for block in payload["blocks"]]}


def assemble_payload(header: dict, frames: List[dict]) -> dict:
    """Reassemble a full payload from a header plus its frames,
    checking identity, order, and page-count closure. The result still
    goes through `verify_payload` (checksums) before anything binds."""
    n_frames = int(header.get("n_frames", 0))
    if len(frames) != n_frames:
        raise KVTransferError(
            f"truncated framed handoff: {len(frames)} frames received, "
            f"header promised {n_frames}")
    n_blocks = int(header["n_blocks"])
    for i, fr in enumerate(frames):
        if fr.get("handoff_id") != header["handoff_id"]:
            raise KVTransferError(
                f"framed handoff identity mismatch at frame {i}: "
                f"{fr.get('handoff_id')!r} != {header['handoff_id']!r}")
        if int(fr.get("frame", -1)) != i:
            raise KVTransferError(
                f"framed handoff out of order: got frame "
                f"{fr.get('frame')} at position {i}")
        if len(fr.get("blocks", ())) != n_blocks:
            raise KVTransferError(
                f"framed handoff frame {i} carries "
                f"{len(fr.get('blocks', ()))} blocks, expected {n_blocks}")
    payload = {k: v for k, v in header.items() if k not in _FRAME_META}
    if n_frames == 0:
        payload["blocks"] = []
        return payload
    names = list(frames[0]["blocks"][0].keys()) if n_blocks else []
    blocks = []
    for bi in range(n_blocks):
        blocks.append({
            name: np.concatenate(
                [np.asarray(fr["blocks"][bi][name]) for fr in frames],
                axis=0)
            for name in names})
    payload["blocks"] = blocks
    shipped = int(header["pages_shipped"])
    for bi, block in enumerate(blocks):
        for name, arr in block.items():
            if arr.shape[0] != shipped:
                raise KVTransferError(
                    f"framed handoff block {bi} tensor {name!r} "
                    f"reassembles {arr.shape[0]} pages, header promised "
                    f"{shipped}")
    return payload


# ---------------------------------------------------------------------------
# leases


class _Lease:
    """One granted handoff on the sender: the payload (fetchable until
    resolution) plus the page/prefix-pin ownership that must be freed
    exactly once — by commit, abort, or TTL expiry."""

    __slots__ = ("handoff_id", "payload", "pages", "n_shared", "nodes",
                 "created_at", "expires_at", "fetched")

    def __init__(self, handoff_id, payload, pages, n_shared, nodes,
                 now, ttl):
        self.handoff_id = handoff_id
        self.payload = payload
        self.pages = pages          # full page list (incl. shared prefix)
        self.n_shared = n_shared    # leading pages owned by cache nodes
        self.nodes = nodes          # acquired prefix-cache pins, if any
        self.created_at = now
        self.expires_at = now + ttl
        # the receiver has fetched the payload at least once: the bytes
        # left this process, so a sender dying afterward costs only the
        # commit (TTL-irrelevant), not the resume
        self.fetched = False


class LeaseTable:
    """Sender-side ledger of in-flight handoffs. NOT self-locking: the
    owning engine guards every call with its scheduler condvar (the
    same lock that guards the free-page list the leases feed back
    into), so grant/resolve/sweep are atomic with page accounting."""

    def __init__(self, ttl: float = 30.0):
        if ttl <= 0:
            raise ValueError(f"lease ttl must be > 0, got {ttl}")
        self.ttl = float(ttl)
        self._leases: Dict[str, _Lease] = {}

    def __len__(self) -> int:
        return len(self._leases)

    @staticmethod
    def new_id() -> str:
        return uuid.uuid4().hex

    def grant(self, payload: dict, *, pages: Optional[List[int]] = None,
              n_shared: int = 0, nodes: Optional[list] = None,
              now: Optional[float] = None) -> _Lease:
        now = time.monotonic() if now is None else now
        lease = _Lease(payload["handoff_id"], payload, pages, n_shared,
                       nodes, now, self.ttl)
        self._leases[lease.handoff_id] = lease
        return lease

    def get(self, handoff_id: str) -> Optional[_Lease]:
        return self._leases.get(handoff_id)

    def touch(self, handoff_id: str,
              now: Optional[float] = None) -> Optional[_Lease]:
        """Extend a lease's TTL (called on fetch, so a slow receiver
        that is still actively resuming cannot lose the race against
        the sweep)."""
        lease = self._leases.get(handoff_id)
        if lease is not None:
            now = time.monotonic() if now is None else now
            lease.expires_at = now + self.ttl
            lease.fetched = True
        return lease

    def unfetched(self) -> int:
        """Leases whose payload no receiver has fetched yet — the count
        a migrate-then-drain must wait on (bounded) before the sender
        may be disposed, or every export degrades to a fallback."""
        return sum(1 for lease in self._leases.values()
                   if not lease.fetched)

    def resolve(self, handoff_id: str) -> Optional[_Lease]:
        """Pop a lease (commit or abort — the caller frees the pages).
        Idempotent: a second resolve returns None."""
        return self._leases.pop(handoff_id, None)

    def expired_pending(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return any(lease.expires_at <= now
                   for lease in self._leases.values())

    def sweep(self, now: Optional[float] = None) -> List[_Lease]:
        """Pop and return every expired lease (orphan reclamation: the
        receiver died or never committed; the caller reclaims pages)."""
        now = time.monotonic() if now is None else now
        dead = [hid for hid, lease in self._leases.items()
                if lease.expires_at <= now]
        return [self._leases.pop(hid) for hid in dead]

    def invalidate_pages(self) -> None:
        """Device-state reset on the sender: the pools the leased pages
        index into were rebuilt wholesale, so page ownership is void —
        but payloads stay fetchable (they are host copies; a receiver
        mid-resume still gets valid bytes)."""
        for lease in self._leases.values():
            lease.pages = None
            lease.n_shared = 0
            lease.nodes = None


# ---------------------------------------------------------------------------
# disaggregated serving


class DisaggCoordinator:
    """Prefill/decode disaggregation behind one server-shaped facade.

    Prefill-role servers run chunked prefill into their paged pools and
    export the finished slot as a handoff (never entering the decode
    loop); decode-role servers accept `resume_generate` imports and run
    only the C=1 decode step. `generate` routes: prefill → fetch the
    exported handoff → resume on a decode server → splice the tails.

    The degradation ladder is the coordinator's contract: if shipping
    fails (corruption, expiry, dead decode server), the whole flow
    retries once from a fresh prefill — same seed, identical output.
    When that also fails the typed error propagates; nothing is ever
    silently absorbed.

    When disagg pays: prefill-heavy mixes (long prompts, short
    completions) keep decode replicas' batch lanes dense instead of
    stalling them behind compute-bound prefills. Decode-heavy mixes pay
    the wire cost for nothing — stay colocated (see
    `bench.py serve_disagg`).
    """

    def __init__(self, net, *, prefill_replicas: int = 1,
                 decode_replicas: int = 1, server_kwargs: Optional[dict] = None,
                 prefix_cluster: bool = False, affinity_margin: int = 2,
                 frame_pages: int = 8):
        from deeplearning4j_tpu_torch.serving.model_server import ModelServer

        if prefill_replicas < 1 or decode_replicas < 1:
            raise ValueError(
                "disagg needs >= 1 prefill and >= 1 decode replica, got "
                f"{prefill_replicas}/{decode_replicas}")
        kw = dict(server_kwargs or {})
        gen = kw.pop("generation", None)
        gen = {} if gen in (None, True) else dict(gen)
        gen.pop("role", None)

        def _server(role, first):
            g = dict(gen)
            g["role"] = role
            return ModelServer(net if first else net.clone(),
                               generation=g, **kw)

        self.prefill = [_server("prefill", i == 0)
                        for i in range(prefill_replicas)]
        self.decode = [_server("decode", False)
                       for _ in range(decode_replicas)]
        self._servers = self.prefill + self.decode
        self._lock = threading.Lock()
        self._rr_prefill = 0
        self._rr_decode = 0
        self._closed = False
        self.handoffs = 0
        self.fallbacks = 0
        self.transfer_bytes = 0
        self.transfer_seconds = 0.0
        # cluster-global prefix cache: one directory across both roles,
        # so a system prompt prefilled on prefill-0 is fetchable by
        # prefill-1 (skipping its prefill) and delta handoffs to decode
        # servers skip pages the receiver already holds
        self._prefix_cluster = bool(prefix_cluster)
        self._affinity_margin = int(affinity_margin)
        self._frame_pages = int(frame_pages)
        self.affinity_routes = 0      # guarded by: _lock
        self.delta_pages_skipped = 0  # guarded by: _lock
        self.prefix_directory = None
        self._holders: Dict[str, object] = {}
        if self._prefix_cluster:
            from deeplearning4j_tpu_torch.serving.prefix_directory import (
                PrefixDirectory,
            )

            self.prefix_directory = PrefixDirectory()
            for i, srv in enumerate(self.prefill):
                self._holders[f"prefill-{i}"] = srv
            for i, srv in enumerate(self.decode):
                self._holders[f"decode-{i}"] = srv
            for holder_id, srv in self._holders.items():
                srv.bind_prefix_directory(
                    self.prefix_directory, holder_id,
                    peers=self._holders.get,
                    frame_pages=self._frame_pages)

    # -- routing ----------------------------------------------------------

    def _next(self, servers: list, which: str, prompt=None,
              tenant: Optional[str] = None) -> tuple:
        with self._lock:
            if self._closed:
                raise ServerClosedError("disagg coordinator is shut down")
            if which == "prefill":
                i = self._rr_prefill = (self._rr_prefill + 1) % len(servers)
            else:
                i = self._rr_decode = (self._rr_decode + 1) % len(servers)
        if prompt is not None:
            j = self._affine(servers, which, prompt, tenant)
            if j is not None:
                return j, servers[j]
        return i, servers[i]

    def _affine(self, servers: list, which: str, prompt,
                tenant: Optional[str]) -> Optional[int]:
        """Prefix-affinity override of round-robin: when the directory
        names a server in this role as holding the prompt's deepest
        cached chain AND that server is no more than `affinity_margin`
        pending requests busier than the least-loaded one, route to the
        holder — its prefill covers only the uncached suffix. Load
        always wins past the margin: a hot holder must not become a
        hotspot."""
        if self.prefix_directory is None:
            return None
        hit = self.prefix_directory.best_holder(
            np.asarray(prompt), tenant)
        if hit is None:
            return None
        mine = [int(h.split("-", 1)[1]) for h in hit["holders"]
                if h.startswith(which + "-")]
        mine = [j for j in mine if j < len(servers)]
        if not mine:
            return None
        loads = [s.pending() for s in servers]
        floor = min(loads)
        best = min((j for j in mine
                    if loads[j] <= floor + self._affinity_margin),
                   key=lambda j: loads[j], default=None)
        if best is None:
            return None
        with self._lock:
            self.affinity_routes += 1
        self.prefill[0].recorder.event(
            "affinity-route", role=which, holder=f"{which}-{best}",
            depth_pages=hit["depth"], pending=loads[best])
        return best

    @property
    def net(self):
        return self.prefill[0].net

    def generate(self, prompt_ids, n_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None,
                 tenant: Optional[str] = None,
                 priority: str = "interactive") -> np.ndarray:
        deadline = None if timeout is None else time.monotonic() + timeout

        def remaining():
            if deadline is None:
                return None
            rem = deadline - time.monotonic()
            if rem <= 0:
                raise DeadlineExceededError(
                    "deadline expired during disagg handoff")
            return rem

        last_err: Optional[BaseException] = None
        avoid_decode = -1
        for round_ in range(2):  # ladder: one full re-prefill retry
            _, psrv = self._next(self.prefill, "prefill",
                                 prompt=prompt_ids, tenant=tenant)
            try:
                toks = psrv.generate(
                    np.asarray(prompt_ids), int(n_tokens),
                    temperature=temperature, seed=seed,
                    timeout=remaining(), tenant=tenant, priority=priority)
                return toks  # finished at prefill (n_tokens==1 / EOS)
            except SlotMigratedError as redirect:
                try:
                    return self._resume(psrv, redirect, remaining,
                                        avoid_decode)
                except DeadlineExceededError:
                    raise
                except ServingError as e:
                    last_err = e
                    avoid_decode = self._rr_decode
                    with self._lock:
                        self.fallbacks += 1
                    logger.warning(
                        "disagg transfer failed (%s: %s); %s", type(e).__name__,
                        e, "re-prefilling" if round_ == 0 else "giving up")
        raise KVTransferError(
            f"disagg handoff failed twice; last error: {last_err}")

    def _resume(self, psrv, redirect: SlotMigratedError, remaining,
                avoid_decode: int) -> np.ndarray:
        i, dsrv = self._next(self.decode, "decode")
        if i == avoid_decode and len(self.decode) > 1:
            i, dsrv = self._next(self.decode, "decode")
        if self._prefix_cluster:
            payload, skipped = self._fetch_framed(
                psrv, redirect.handoff_id, dsrv)
        else:
            payload = psrv.fetch_handoff(redirect.handoff_id)
            skipped = 0
        t0 = time.monotonic()
        try:
            tail = dsrv.resume_generate(payload, timeout=remaining())
        except KVTransferError:
            if not skipped:
                raise
            # the decode server's resident prefix vanished between the
            # depth probe and admit (eviction race) — one full re-fetch,
            # same handoff, before the outer ladder re-prefills
            payload, skipped = self._fetch_framed(
                psrv, redirect.handoff_id, dsrv, skip=0)
            tail = dsrv.resume_generate(payload, timeout=remaining())
        dt = time.monotonic() - t0
        try:
            psrv.commit_handoff(redirect.handoff_id)
        except ServingError:
            # commit is an optimization (early page reclaim); the lease
            # TTL sweep reclaims regardless, so a lost commit is logged
            # and absorbed — the request already has its tokens
            logger.warning("disagg commit_handoff(%s) failed; lease "
                           "sweep will reclaim", redirect.handoff_id)
        with self._lock:
            self.handoffs += 1
            self.transfer_bytes += payload_nbytes(payload)
            self.transfer_seconds += dt
            self.delta_pages_skipped += skipped
        return np.concatenate(
            [np.asarray(redirect.tokens, np.int32),
             np.asarray(tail, np.int32)])

    def _fetch_framed(self, psrv, handoff_id: str, dsrv,
                      skip: Optional[int] = None) -> tuple:
        """Delta-framed handoff fetch: probe the receiver for how many
        leading pages of this sequence's prefix chain it already holds,
        then pull only the remainder in bounded frames. Returns
        ``(payload, pages_skipped)``; checksums re-verify the
        reassembled payload at admit, so a bad frame is a typed refusal
        upstream of any binding."""
        header = psrv.fetch_handoff_header(
            handoff_id, frame_pages=self._frame_pages)
        if skip is None:
            already = int(header.get("pages_omitted", 0))
            have = dsrv.prefix_depth(header["prompt"],
                                     header.get("tenant"))
            skip = max(0, int(have) - already)
        if skip:
            base = int(header.get("pages_omitted", 0))
            header = psrv.fetch_handoff_header(
                handoff_id, skip_pages=skip,
                frame_pages=self._frame_pages)
            # the sender clamps skip to shipped-1 (the resume point's
            # page always ships); honor its clamp so the frame requests
            # and the skipped-page count both match the wire truth
            skip = int(header.get("pages_omitted", 0)) - base
        frames = [psrv.fetch_handoff_frame(
                      handoff_id, f, skip_pages=skip,
                      frame_pages=header["frame_pages"])
                  for f in range(int(header["n_frames"]))]
        return assemble_payload(header, frames), int(skip)

    # -- server-shaped facade (gateway RPC surface) ------------------------

    def predict(self, x, timeout: Optional[float] = None) -> np.ndarray:
        _, srv = self._next(self.prefill, "prefill")
        return srv.predict(x, timeout=timeout)

    def pending(self) -> int:
        return sum(s.pending() for s in self._servers)

    def stats(self) -> dict:
        with self._lock:
            mb = self.transfer_bytes / 1e6
            secs = self.transfer_seconds
            out = {
                "disagg": True,
                "prefill_replicas": len(self.prefill),
                "decode_replicas": len(self.decode),
                "handoffs": self.handoffs,
                "fallbacks": self.fallbacks,
                "kv_transfer_mbytes": mb,
                "kv_transfer_mbytes_per_sec": mb / secs if secs else 0.0,
                "prefix_cluster": self._prefix_cluster,
                "affinity_routes": self.affinity_routes,
                "delta_pages_skipped": self.delta_pages_skipped,
            }
        if self.prefix_directory is not None:
            out.update(self.prefix_directory.stats())
        out["prefill"] = [s.stats() for s in self.prefill]
        out["decode"] = [s.stats() for s in self.decode]
        return out

    def set_tenant_quota(self, tenant: str, rate=None, burst=None,
                         max_pages=None, weight=None) -> None:
        for s in self._servers:
            s.set_tenant_quota(tenant, rate=rate, burst=burst,
                               max_pages=max_pages, weight=weight)

    def flight_record(self) -> dict:
        return self.prefill[0].flight_record()

    def metrics_text(self, labels=None) -> str:
        return "".join(s.metrics_text(labels) for s in self._servers)

    def shutdown(self, drain_timeout: float = 10.0) -> bool:
        with self._lock:
            if self._closed:
                return True
            self._closed = True
        ok = True
        for s in self._servers:
            ok = s.shutdown(drain_timeout=drain_timeout) and ok
        return ok
