"""Refcounted shared-prefix KV cache over the decode engine's paged pool
(counterpart of `deeplearning4j_tpu/serving/prefix_cache.py`: host
bookkeeping only, numpy and hashlib, the same keys, refcounts, eviction
order, weight-version tags and directory publication).

Production chat traffic is dominated by requests sharing a long system
prompt, yet a paged decode engine without it re-prefills that prefix per
request — the largest remaining lever on the generate path. The page
tables make sharing a refcount away: resident KV pages are already
position-indexed and write-masked, so two slots whose prompts share a
page-aligned prefix can point their page-table rows at the SAME pool
pages. This module is the bookkeeping for that sharing (PagedAttention-
style prefix caching, Kwon et al., SOSP '23):

- **keying**: a prompt is cut into page-size token chunks and hashed as
  a ROLLING CHAIN — each node's key is (parent node, chunk digest), so
  a chunk's identity includes everything before it and two prompts
  share a node only when their entire prefix up to that page matches.
  Digests are collision-guarded by an exact token comparison on lookup.
- **refcounting**: a node's page is held by `requests` (slots currently
  bound to it) plus the cache itself while the node is resident. The
  engine frees a page ONLY when it is neither bound nor cached —
  retiring a request whose prefix another slot still shares can never
  free the shared pages.
- **read-only sharing / copy-on-write at page granularity**: only pages
  FULLY covered by the prompt are ever cached, and a binding request
  recomputes its prompt from the first uncached page boundary into
  freshly allocated pages — shared pages are never written (decode
  writes land at positions >= t0, past every cached page), so the
  "copy" of copy-on-write is free: divergence starts in a new page.
- **LRU eviction under pressure**: when the engine's free list cannot
  cover an admission, `reclaim` releases unreferenced cached pages
  leaf-first in LRU order — caching borrows idle pages, it never
  reduces the pool's effective capacity (`OutOfPagesError` semantics
  are unchanged).
- **invalidation**: `clear()` drops every node; the engine calls it
  whenever the paged pools rebuild (weight swap via `drain_and_swap`,
  post-failure recovery) so stale pages can never serve new weights.
  A swap back to the SAME net object the pools were built under — the
  canary ladder's rollback (`ModelServer.restore_model` hands back the
  exact old net) — skips the rebuild entirely and PRESERVES the cache:
  the pages were computed under precisely those weights, so a failed
  deploy no longer pays a cold prefix cache on top of the rollback.
- **quantized pools**: with the engine's int8 KV tier
  (`quantize={"kv": "int8"}`, serving/quantize.py) cached pages hold
  int8 payloads plus their f32 scale-pool rows. Sharing is unchanged —
  the scale pages ride the same page table and refcounts — and a
  prefix hit re-serves pages exactly as quantized by the request that
  wrote them, so hit and miss paths decode identical values.

Thread-safety: externally synchronized — every method is called by the
`DecodeEngine` under its scheduler condition lock.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.util.concurrency import assert_owned


class _PrefixNode:
    """One cached page of prompt KV: `page_id` in the engine's pool,
    `tokens` the page's exact token content (collision guard),
    `requests` the number of slots currently bound to it, `children`
    how many cached nodes extend this chain (a node with children can
    not be evicted — its descendants would become unreachable pages).
    `chain` is the node's CLUSTER identity — the cumulative content
    digest of everything up to and including this page (see
    `chain_keys`) — and `version` the weight digest its KV was computed
    under."""

    __slots__ = ("seq", "parent", "page_id", "tokens", "requests",
                 "children", "last_used", "key", "chain", "version")

    def __init__(self, seq: int, parent: Optional["_PrefixNode"],
                 page_id: int, tokens: np.ndarray, key,
                 chain: str = "", version: Optional[str] = None):
        self.seq = seq
        self.parent = parent
        self.page_id = page_id
        self.tokens = tokens
        self.requests = 0
        self.children = 0
        self.last_used = 0
        self.key = key
        self.chain = chain
        self.version = version


def _digest(tokens: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(tokens, np.int32).tobytes(),
                           digest_size=16).digest()


def _chain_root(tenant: Optional[str]) -> bytes:
    """Seed of the cumulative chain digest. The tenant is folded in
    HERE, at the root, so every downstream chain key — and therefore
    every directory entry — is tenant-scoped: one tenant's published
    prefixes are simply unreachable from another tenant's lookups."""
    h = hashlib.blake2b(b"dl4j-prefix-chain-v1", digest_size=16)
    if tenant is not None:
        h.update(b"\x00tenant\x00" + str(tenant).encode())
    return h.digest()


def chain_keys(prompt: np.ndarray, page_size: int,
               tenant: Optional[str] = None,
               digest_cache: Optional[list] = None) -> List[str]:
    """Instance-independent cumulative content keys, one per FULL page
    of `prompt`: ``key[i] = H(key[i-1] || digest(chunk_i))`` rooted at
    the tenant-scoped seed. Two hosts compute identical keys for
    identical (tenant, token-prefix) pairs — the directory's address
    space. `digest_cache` memoizes per-chunk digests exactly like
    `PrefixCache.lookup`'s."""
    prompt = np.asarray(prompt)
    page = int(page_size)
    run = _chain_root(tenant)
    out: List[str] = []
    for i in range(int(prompt.shape[0]) // page):
        if digest_cache is not None and i < len(digest_cache):
            dig = digest_cache[i]
        else:
            dig = _digest(np.ascontiguousarray(
                prompt[i * page:(i + 1) * page], np.int32))
            if digest_cache is not None:
                digest_cache.append(dig)
        run = hashlib.blake2b(run + dig, digest_size=16).digest()
        out.append(run.hex())
    return out


class PrefixCache:
    """Refcounted chain cache mapping page-aligned prompt prefixes to
    resident pool pages (see module docstring).

    Parameters
    ----------
    page_size : the engine's KV page length (positions per page) — the
        sharing granularity.
    max_pages : optional cap on resident cached pages. On insert past
        the cap the LRU unpinned tail is evicted first; if everything
        is pinned the new chunk is simply not cached. None = bounded
        only by pool pressure (`reclaim`).
    """

    def __init__(self, page_size: int, max_pages: Optional[int] = None):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if max_pages is not None and max_pages < 0:
            raise ValueError("max_pages must be >= 0 (or None)")
        self.page_size = page_size
        self.max_pages = max_pages
        # the owner's lock (`bind_guard`); None until bound. Mutating
        # methods assert the calling thread holds it (under tests)
        self._guard = None
        self._nodes: dict = {}   # guarded by: _guard [external] — (parent_seq, digest) -> _PrefixNode
        self._seq = 0  # guarded by: _guard [external]
        self._clock = 0  # guarded by: _guard [external]
        # tenant-scoped chain roots: tenant -> synthetic root seq (None
        # tenant keeps the historic root 0; others draw from the same
        # counter as nodes, so roots and nodes can never collide). A
        # request can only ever walk chains grown from ITS tenant's
        # root — cross-tenant page binding is structurally impossible
        self._roots: dict = {}  # guarded by: _guard [external]
        # structural counters (hit/miss/token accounting lives on the
        # engine, which counts once per BINDING — a page-blocked queue
        # head re-runs lookup every scheduler iteration)
        self.insertions = 0  # guarded by: _guard [external]
        self.evictions = 0  # guarded by: _guard [external]
        self._recorder = None  # optional FlightRecorder (engine's)
        # weight-version tag (`bind_version`): every cached page holds
        # KV computed under exactly these weights. The engine re-binds
        # the tag on every (re)build — shipped pages from a KV handoff
        # may only promote here after the transfer layer proved the
        # sender's version equal (kv_transfer.verify_payload)
        self.weight_version: Optional[str] = None
        # optional cluster directory (`bind_directory`): promotions
        # publish their chain keys, evictions retract, clear drops the
        # holder wholesale — the in-process push half of the protocol
        self._directory = None
        self._holder: Optional[str] = None

    def bind_guard(self, lock) -> "PrefixCache":
        """Register the owner's lock. Every mutating method then runs
        `assert_owned` against it under tests, turning a silently-racy
        unlocked call into a hard failure."""
        self._guard = lock
        return self

    def bind_recorder(self, recorder) -> "PrefixCache":
        """Register the owner's flight recorder: cache invalidations and
        cap-driven eviction bursts land in the scheduler-event ring (its
        lock is a leaf, so emitting under the engine's condition lock is
        deadlock-free)."""
        self._recorder = recorder
        return self

    def bind_version(self, version: Optional[str]) -> "PrefixCache":
        """Tag the cache with the serving weights' content digest (the
        key under which cached KV is valid). Nodes are STAMPED with the
        version live at their insert and `lookup` only walks nodes
        matching the CURRENT tag — so re-binding to a different version
        invalidates every older entry without dropping it, and binding
        BACK to the original version (a rollback to the same weights)
        makes those entries hittable again: the pages were computed
        under exactly those weights."""
        self.weight_version = version
        return self

    def bind_directory(self, directory, holder: str) -> "PrefixCache":
        """Register the cluster prefix directory and this cache's
        holder id: every promotion publishes its chain keys, every
        eviction retracts, `clear()` drops the holder wholesale. The
        directory's lock is a leaf — publishing under the engine's
        condition lock is deadlock-free."""
        self._directory = directory
        self._holder = holder
        return self

    # -- introspection -----------------------------------------------------
    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    def stats(self) -> dict:
        return {"cached_pages": len(self._nodes),
                "pinned_pages": sum(1 for n in self._nodes.values()
                                    if n.requests or n.children),
                "insertions": self.insertions,
                "evictions": self.evictions,
                "page_size": self.page_size,
                "max_pages": self.max_pages,
                "weight_version": self.weight_version}

    # -- lookup / binding --------------------------------------------------
    def _max_hit_pages(self, t0: int) -> int:
        """A hit never covers the whole prompt: position t0-1 must be
        recomputed so the first-token logits (and the decode state they
        seed) come from a live prefill — cap the match at the last page
        boundary strictly before t0-1's page end."""
        return max(0, (t0 - 1) // self.page_size)

    def _root_seq(self, tenant: Optional[str]) -> int:
        """Synthetic root seq for a tenant's chain space (None keeps
        the historic root 0). Allocated from the node counter, so a
        tenant root can never alias a node seq."""
        if tenant is None:
            return 0
        root = self._roots.get(tenant)
        if root is None:
            self._seq += 1
            root = self._roots[tenant] = self._seq
        return root

    def _walk(self, prompt: np.ndarray, cap: int,
              digest_cache: Optional[list],
              tenant: Optional[str]) -> List[_PrefixNode]:
        """Shared chain walk for `lookup`/`match`: longest cached chain
        matching `prompt`'s first `cap` pages under `tenant`'s root,
        current weight version only. Touches matched LRU clocks."""
        page = self.page_size
        out: List[_PrefixNode] = []
        parent_seq = self._root_seq(tenant)
        for i in range(cap):
            chunk = np.ascontiguousarray(prompt[i * page:(i + 1) * page],
                                         np.int32)
            if digest_cache is not None and i < len(digest_cache):
                dig = digest_cache[i]
            else:
                dig = _digest(chunk)
                if digest_cache is not None:
                    digest_cache.append(dig)
            node = self._nodes.get((parent_seq, dig))
            if node is None or node.version != self.weight_version \
                    or not np.array_equal(node.tokens, chunk):
                break
            out.append(node)
            parent_seq = node.seq
        self._clock += 1
        for node in out:
            node.last_used = self._clock
        return out

    def lookup(self, prompt: np.ndarray,
               digest_cache: Optional[list] = None,
               tenant: Optional[str] = None) -> List[_PrefixNode]:
        """Longest cached chain matching `prompt`'s page-aligned prefix
        (possibly empty), capped at `_max_hit_pages`. Touches the
        matched nodes' LRU clocks; does NOT take references — pair with
        `acquire` under the same lock before any other cache call can
        run. `digest_cache`: a caller-owned list memoizing the prompt's
        per-chunk digests — a page-blocked queue head re-runs lookup
        every scheduler iteration, and the prompt is immutable, so
        hashing it once is enough."""
        assert_owned(self._guard, "PrefixCache.lookup")
        t0 = int(prompt.shape[0])
        return self._walk(prompt, self._max_hit_pages(t0), digest_cache,
                          tenant)

    def match(self, prompt: np.ndarray,
              tenant: Optional[str] = None) -> List[_PrefixNode]:
        """Longest cached chain over EVERY full page of `prompt` — no
        `_max_hit_pages` cap, because the caller is not binding a slot:
        used by the cluster export path (a peer asking for exactly the
        pages it saw in the directory) and by delta-transfer depth
        queries."""
        assert_owned(self._guard, "PrefixCache.match")
        t0 = int(prompt.shape[0])
        return self._walk(prompt, t0 // self.page_size, None, tenant)

    def chains(self) -> List[str]:
        """Chain keys of every resident node at the CURRENT weight
        version — the pull-mode directory refresh payload
        (`prefix_chains` RPC)."""
        assert_owned(self._guard, "PrefixCache.chains")
        return [n.chain for n in self._nodes.values()
                if n.version == self.weight_version and n.chain]

    def acquire(self, nodes: List[_PrefixNode]) -> None:
        assert_owned(self._guard, "PrefixCache.acquire")
        for node in nodes:
            node.requests += 1

    def release(self, nodes: List[_PrefixNode]) -> None:
        assert_owned(self._guard, "PrefixCache.release")
        for node in nodes:
            node.requests -= 1
            assert node.requests >= 0, "prefix-cache refcount underflow"

    # -- insertion ---------------------------------------------------------
    def insert(self, prompt: np.ndarray, pages: List[int],
               held: List[_PrefixNode], tenant: Optional[str] = None):
        """Promote the prompt's fully-covered pages into the cache after
        a successful prefill. `pages` is the request's LOGICAL page list
        (shared prefix pages first, then owned pages); `held` the nodes
        the request already references (its admission-time hit). New
        nodes are created only ON TOP of the held chain and only from
        the request's OWN pages: if another request already cached a
        deeper chunk with a different page, promotion stops there — a
        chain's pages always share one numeric lineage, never a mix of
        two requests' prefills. Returns `(nodes, freed)`: the full node
        list the request now holds one reference on (callers replace
        their held list with it; ownership of the promoted pages
        transfers to the cache), and the page ids of any nodes evicted
        to respect `max_pages` — the CALLER must return those to its
        free list, or each cap-driven eviction would leak a pool page."""
        assert_owned(self._guard, "PrefixCache.insert")
        page = self.page_size
        t0 = int(prompt.shape[0])
        cacheable = t0 // page  # pages fully covered by the prompt
        nodes = list(held)
        freed: List[int] = []
        parent = held[-1] if held else None
        chain = (bytes.fromhex(parent.chain) if parent is not None
                 and parent.chain else _chain_root(tenant))
        self._clock += 1
        published: List[str] = []
        for i in range(len(held), cacheable):
            parent_seq = (parent.seq if parent is not None
                          else self._root_seq(tenant))
            chunk = np.ascontiguousarray(prompt[i * page:(i + 1) * page],
                                         np.int32)
            dig = _digest(chunk)
            key = (parent_seq, dig)
            if key in self._nodes:
                # raced by another request's promotion of the same
                # prefix: its page is canonical for future lookups, ours
                # stays privately owned — do not extend past it with a
                # mixed-lineage chain
                break
            if self.max_pages is not None \
                    and len(self._nodes) >= self.max_pages:
                evicted = self._evict_one(protect=nodes)
                if evicted is None:
                    break  # cap reached, everything pinned: skip caching
                freed.append(evicted)
            chain = hashlib.blake2b(chain + dig, digest_size=16).digest()
            self._seq += 1
            node = _PrefixNode(self._seq, parent, int(pages[i]), chunk,
                               key, chain=chain.hex(),
                               version=self.weight_version)
            node.requests = 1  # the promoting request's reference
            node.last_used = self._clock
            if parent is not None:
                parent.children += 1
            self._nodes[key] = node
            nodes.append(node)
            parent = node
            self.insertions += 1
            published.append(node.chain)
        if freed and self._recorder is not None:
            # cap pressure displaced resident prefixes — one aggregated
            # event per promotion, not one per page
            self._recorder.event("prefix-cache", decision="cap-evict",
                                 pages=len(freed),
                                 cached_pages=len(self._nodes))
        if published and self._directory is not None:
            # publish-on-promotion: the cluster learns this holder has
            # the chain the moment it becomes shareable locally
            self._directory.publish(self.weight_version, page,
                                    published, self._holder)
            if self._recorder is not None:
                self._recorder.event("prefix-publish",
                                     pages=len(published),
                                     holder=self._holder)
        return nodes, freed

    # -- eviction ----------------------------------------------------------
    def _evict_one(self, protect: List[_PrefixNode] = ()) -> Optional[int]:
        """Evict the least-recently-used unpinned LEAF node (no bound
        requests, no cached children, not in `protect`); returns its
        page id or None when nothing is evictable. Leaf-first keeps
        every resident chain reachable from its root."""
        best = None
        protected = {id(n) for n in protect}
        for node in self._nodes.values():
            if node.requests or node.children or id(node) in protected:
                continue
            if best is None or node.last_used < best.last_used:
                best = node
        if best is None:
            return None
        del self._nodes[best.key]
        if best.parent is not None:
            best.parent.children -= 1
        self.evictions += 1
        if self._directory is not None and best.chain:
            # retract-on-evict: the directory must never advertise a
            # chain whose pages are back on the free list
            self._directory.retract(best.version, (best.chain,),
                                    self._holder)
        return best.page_id

    def reclaim(self, n_pages: int) -> List[int]:
        """Release up to `n_pages` cached pages (LRU leaf-first) back to
        the caller's free list — the admission-pressure valve that keeps
        caching from ever shrinking effective pool capacity. Pinned
        pages (bound requests or interior chain nodes) are never
        touched."""
        assert_owned(self._guard, "PrefixCache.reclaim")
        freed: List[int] = []
        while len(freed) < n_pages:
            pid = self._evict_one()
            if pid is None:
                break
            freed.append(pid)
        return freed

    def clear(self) -> None:
        """Drop every node WITHOUT returning pages (the engine rebuilds
        its free list wholesale after a pool rebuild — weight swap or
        post-failure recovery — which is the only time this runs). A
        stale page can never serve new weights."""
        assert_owned(self._guard, "PrefixCache.clear")
        dropped = len(self._nodes)
        self._nodes.clear()
        self._roots.clear()
        if self._directory is not None:
            self._directory.drop_holder(self._holder)
        if dropped and self._recorder is not None:
            self._recorder.event("prefix-cache", decision="invalidate",
                                 dropped=dropped)
