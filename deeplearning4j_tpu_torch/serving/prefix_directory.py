"""Cluster-wide prefix directory: who holds which prompt-prefix chain
(counterpart of `deeplearning4j_tpu/serving/prefix_directory.py`: host
bookkeeping only, the same keys, TTLs and lock discipline).

The prefix cache made a shared system prompt free *within* one
engine; this directory makes it free *across* engines. Every promoted
prefix chain is published here as a content-addressed key — the
cumulative rolling chain digest from `prefix_cache.chain_keys`, which
is identical on every host for the same (tenant, token) prefix — and a
router or an admitting engine can ask "who already holds the KV for
this prompt's longest page-aligned prefix?".

Keying discipline:

- **weight_version first.** Entries live under the publisher's weight
  digest, so a rolling reload atomically strands the old version's
  entries instead of `clear()`-ing the world: lookups from engines on
  the new weights simply never see them, and the stale generation ages
  out (TTL) or is dropped when the publisher's cache clears
  (`drop_holder`). A fetched page can therefore never bind under the
  wrong weights even before the transfer layer re-verifies.
- **tenant inside the key.** `chain_keys` folds the tenant into the
  chain root, so one tenant's published prefixes are unreachable from
  another tenant's lookups — isolation holds at the directory, not
  just at the fetch.
- **TTL per (key, holder).** A dead host stops refreshing; its entries
  expire lazily on lookup and eagerly on `sweep`. In-process pools
  (threads, not hosts) may pass ``ttl=None`` — their publishers retract
  synchronously on evict/clear, so aging is redundant.

Thread-safety: self-locking on a private leaf lock. Publishers call
under their engine's scheduler lock (engine lock -> directory lock is
the only ordering; the directory never calls back out), routers call
from arbitrary threads.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional

import numpy as np


class PrefixDirectory:
    """Maps (weight_version, chain key) -> the set of holders with that
    prefix chain resident, TTL'd per holder.

    Parameters
    ----------
    ttl : seconds a published entry stays live without a refresh;
        ``None`` disables aging (in-process pools whose publishers
        retract synchronously).
    """

    def __init__(self, ttl: Optional[float] = None):
        if ttl is not None and ttl <= 0:
            raise ValueError(f"directory ttl must be > 0 or None, got {ttl}")
        self.ttl = None if ttl is None else float(ttl)
        self._lock = threading.Lock()
        # weight_version -> {"page_size": int,
        #                    "keys": {chain_key: {holder: expires_at|None}}}
        self._versions: Dict[str, dict] = {}  # guarded by: _lock
        self.publishes = 0    # guarded by: _lock
        self.retracts = 0     # guarded by: _lock
        self.expirations = 0  # guarded by: _lock

    # -- publication -------------------------------------------------------
    def publish(self, weight_version: str, page_size: int,
                keys: Iterable[str], holder: str,
                now: Optional[float] = None) -> None:
        """Register `holder` as having each chain key resident under
        `weight_version`. Refreshes the TTL of already-published keys."""
        now = time.monotonic() if now is None else now
        expires = None if self.ttl is None else now + self.ttl
        with self._lock:
            ver = self._versions.setdefault(
                weight_version, {"page_size": int(page_size), "keys": {}})
            if ver["page_size"] != int(page_size):
                raise ValueError(
                    f"prefix directory: weight version {weight_version} "
                    f"already published with page_size {ver['page_size']}, "
                    f"got {page_size}")
            for key in keys:
                ver["keys"].setdefault(key, {})[holder] = expires
                self.publishes += 1

    def retract(self, weight_version: str, keys: Iterable[str],
                holder: str) -> None:
        """Remove `holder` from each chain key (evict-side hook)."""
        with self._lock:
            ver = self._versions.get(weight_version)
            if ver is None:
                return
            for key in keys:
                holders = ver["keys"].get(key)
                if holders is None or holder not in holders:
                    continue
                del holders[holder]
                self.retracts += 1
                if not holders:
                    del ver["keys"][key]
            if not ver["keys"]:
                del self._versions[weight_version]

    def drop_holder(self, holder: str) -> int:
        """Remove every entry naming `holder` — a cleared cache, an
        evicted replica, or a rebuilt engine retracts wholesale.
        Returns the number of entries dropped."""
        dropped = 0
        with self._lock:
            for wv in list(self._versions):
                keys = self._versions[wv]["keys"]
                for key in list(keys):
                    if holder in keys[key]:
                        del keys[key][holder]
                        dropped += 1
                        if not keys[key]:
                            del keys[key]
                if not keys:
                    del self._versions[wv]
            self.retracts += dropped
        return dropped

    # -- lookup ------------------------------------------------------------
    def _live_holders_locked(self, ver: dict, key: str,
                             now: float) -> List[str]:
        holders = ver["keys"].get(key)
        if not holders:
            return []
        out = []
        for holder, expires in list(holders.items()):
            if expires is not None and expires <= now:
                del holders[holder]
                self.expirations += 1
                continue
            out.append(holder)
        if not holders:
            del ver["keys"][key]
        return out

    def holders(self, weight_version: str, key: str,
                now: Optional[float] = None) -> List[str]:
        """Live holders of one chain key (expired entries pruned)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ver = self._versions.get(weight_version)
            if ver is None:
                return []
            return self._live_holders_locked(ver, key, now)

    def deepest(self, weight_version: str, keys: List[str],
                exclude: Iterable[str] = (),
                now: Optional[float] = None):
        """Walk `keys` (shallow -> deep chain order) and return
        ``(depth_pages, holders)`` for the DEEPEST key with a live
        holder not in `exclude`, or ``(0, [])``."""
        now = time.monotonic() if now is None else now
        excluded = set(exclude)
        with self._lock:
            ver = self._versions.get(weight_version)
            if ver is None:
                return 0, []
            for i in range(len(keys) - 1, -1, -1):
                live = [h for h in
                        self._live_holders_locked(ver, keys[i], now)
                        if h not in excluded]
                if live:
                    return i + 1, live
        return 0, []

    def best_holder(self, prompt: np.ndarray, tenant: Optional[str] = None,
                    *, exclude: Iterable[str] = (),
                    now: Optional[float] = None) -> Optional[dict]:
        """Router-side lookup: compute the prompt's chain keys for every
        published (weight_version, page_size) generation and return the
        deepest live match as ``{"weight_version", "page_size", "depth",
        "holders"}``, or None. Depth is capped one page short of the
        prompt end (`_max_hit_pages` semantics: the final position is
        always recomputed live)."""
        from deeplearning4j_tpu_torch.serving.prefix_cache import chain_keys

        prompt = np.asarray(prompt)
        t0 = int(prompt.shape[0])
        with self._lock:
            groups = [(wv, ver["page_size"])
                      for wv, ver in self._versions.items()]
        best = None
        for wv, page in groups:
            cap = max(0, (t0 - 1) // page)
            if cap == 0:
                continue
            keys = chain_keys(prompt, page, tenant=tenant)[:cap]
            depth, live = self.deepest(wv, keys, exclude=exclude, now=now)
            if depth and (best is None or depth > best["depth"]):
                best = {"weight_version": wv, "page_size": page,
                        "depth": depth, "holders": live}
        return best

    # -- maintenance -------------------------------------------------------
    def sweep(self, now: Optional[float] = None) -> int:
        """Eagerly prune every expired entry; returns the count."""
        if self.ttl is None:
            return 0
        now = time.monotonic() if now is None else now
        pruned = 0
        with self._lock:
            for wv in list(self._versions):
                keys = self._versions[wv]["keys"]
                for key in list(keys):
                    holders = keys[key]
                    for holder, expires in list(holders.items()):
                        if expires is not None and expires <= now:
                            del holders[holder]
                            pruned += 1
                    if not holders:
                        del keys[key]
                if not keys:
                    del self._versions[wv]
            self.expirations += pruned
        return pruned

    def stats(self) -> dict:
        with self._lock:
            entries = sum(len(ver["keys"])
                          for ver in self._versions.values())
            return {"directory_entries": entries,
                    "directory_versions": len(self._versions),
                    "publishes": self.publishes,
                    "retracts": self.retracts,
                    "expirations": self.expirations}
