"""Paged KV-cache management (PagedAttention-style, Kwon et al. 2023).

Host side: a page allocator with per-request page tables, free-list
accounting, and the look-ahead reservation API the interruption-free engine
needs (§4.3: KV slots for k future decode steps are preallocated so the
k-step fused decode program never synchronises with the host).

Copy-on-write prefix caching (``prefix_cache=True``): full pages are indexed
by a chained token-block hash so a new request whose prompt shares a prefix
with an earlier one maps the shared pages read-only into its block table
(``lock_prefix``) instead of recomputing the prefill. Pages carry refcounts;
a write into a shared or indexed page goes through ``ensure_writable`` which
swaps in a private copy (CoW). Pages of retired requests stay cached while
unreferenced and are reclaimed LRU-first only under pool pressure —
reclamation is transparent to admission (``free_pages`` counts them).

Tiered page lifecycle (DESIGN.md §9): every HBM page moves through an
explicit state machine ``FREE → HBM_ACTIVE → HBM_CACHED → FREE`` tracked in
``_tier`` and validated on every transition. With a host tier configured
(``host_pool``), an LRU-cold cached page is *demoted* instead of dropped:
its digest moves to a host-DRAM :class:`HostPageStore` (numpy; fp32
exactness oracle or int8 with per-tensor stored scales) and the page's KV
content is captured through the manager's migration queue
(``drain_demotions`` / ``complete_demotion`` — the engine owns the device
reads so the async engine can batch them into its single per-super-iteration
``device_get``). A prefix match that lands on host-tier entries schedules
*promotions*: ``lock_prefix`` takes fresh HBM pages, re-indexes the digests,
and hands the dequantized payloads back via ``drain_promotions`` for the
engine to scatter into the pools before the next program reads them.

Device side: per-layer page pools ``(num_pages, page_size, Hkv, Dh)`` as
torch tensors. The plain read/write path lives here; the CUDA paged-decode
kernel (``repro_torch.kernels.paged_decode``) consumes the same layout.
Unlike the functional JAX reference, the pools are updated in place: a
write or a CoW copy mutates the tensor it is given and returns it.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (GQA_KINDS, MLA_KINDS,
                                      RECURRENT_KINDS, ArchConfig)
from repro_torch.core.device import to_device


# Single source of truth for the serving page size: engine, simulator and
# the fig1/fig6 benchmarks all reference this so predicted and executed
# KV-read geometry cannot drift apart.
DEFAULT_PAGE_SIZE = 16

KV_QUANT_MODES = ("none", "int8")


class PageTier:
    """Lifecycle states of an HBM page (DESIGN.md §9). ``HOST_CACHED`` is a
    *digest* state, not a page state: the page id itself has returned to
    FREE while the block content lives in the :class:`HostPageStore`."""
    FREE = "free"                # on the free list, content undefined
    HBM_ACTIVE = "hbm_active"    # referenced by >= 1 block table
    HBM_CACHED = "hbm_cached"    # ref==0, indexed, reclaimable via LRU
    HOST_CACHED = "host_cached"  # digest only: content demoted to host DRAM


_TIER_TRANSITIONS = {
    (PageTier.FREE, PageTier.HBM_ACTIVE),        # allocate / CoW / promote
    (PageTier.HBM_ACTIVE, PageTier.HBM_CACHED),  # last ref dropped, indexed
    (PageTier.HBM_ACTIVE, PageTier.FREE),        # last ref dropped, private
    (PageTier.HBM_CACHED, PageTier.HBM_ACTIVE),  # prefix hit resurrects
    (PageTier.HBM_CACHED, PageTier.FREE),        # demoted to host / evicted
}


@dataclass
class PagePoolConfig:
    num_pages: int
    page_size: int = DEFAULT_PAGE_SIZE


@dataclass
class HostPoolConfig:
    """Host-DRAM demotion tier. ``num_pages`` caps resident host blocks
    (LRU-evicted beyond that); ``quant`` picks the stored format — ``none``
    keeps fp32 (byte-exact round-trips, the equivalence oracle), ``int8``
    stores symmetric per-tensor quantized pages with their scales (~4x
    denser, error budget pinned in DESIGN.md §9)."""
    num_pages: int
    quant: str = "none"

    def __post_init__(self):
        if self.quant not in KV_QUANT_MODES:
            raise ValueError(
                f"HostPoolConfig: quant={self.quant!r} not in "
                f"{KV_QUANT_MODES}")


def _quantize_int8(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-tensor int8: scale = absmax/127 (1.0 for an all-zero
    page so dequantization never divides by zero)."""
    scale = np.float32(np.max(np.abs(arr)) / 127.0) or np.float32(1.0)
    q = np.clip(np.rint(arr / scale), -127, 127).astype(np.int8)
    return q, scale


class HostPageStore:
    """Host-DRAM block store backing the ``HOST_CACHED`` tier.

    Maps chain digests to per-layer page payloads (numpy; ``None`` for
    recurrent layers). Entries start *pending* — reserved at demotion time,
    filled when the engine's batched device read lands
    (:meth:`PagedKVCacheManager.complete_demotion`) — and only ready
    entries are matchable or evictable, so a probe can never promote a
    block whose capture is still in flight."""

    def __init__(self, cfg: HostPoolConfig):
        self.cfg = cfg
        self.quant = cfg.quant
        # digest -> list over layers of None | (payload_k, payload_v)
        # where payload_* is np.ndarray (fp32) or (int8 array, scale).
        # Value None marks a pending (reserved, not yet captured) entry.
        self._blocks: "OrderedDict[bytes, Optional[list]]" = OrderedDict()
        self.evictions = 0            # ready entries dropped for capacity

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, key: bytes) -> bool:
        return key in self._blocks

    def ready(self, key: bytes) -> bool:
        return self._blocks.get(key) is not None

    def ready_count(self) -> int:
        return sum(1 for v in self._blocks.values() if v is not None)

    def reserve(self, key: bytes) -> bool:
        """Claim a slot for an incoming demotion; False when the store is
        full of pending captures (the caller falls back to plain eviction).
        Ready LRU entries are dropped to make room."""
        if key in self._blocks:
            self._blocks[key] = None     # re-demotion overwrites stale data
            self._blocks.move_to_end(key)
            return True
        while len(self._blocks) >= self.cfg.num_pages:
            victim = next((k for k, v in self._blocks.items()
                           if v is not None), None)
            if victim is None:
                return False
            del self._blocks[victim]
            self.evictions += 1
        self._blocks[key] = None
        return True

    def put(self, key: bytes, layers: list):
        """Fill a reserved entry with captured page content (list over
        layers of ``None`` or ``(k_page, v_page)`` float arrays)."""
        if key not in self._blocks:
            return                        # reservation was evicted meanwhile
        stored = []
        for layer in layers:
            if layer is None:
                stored.append(None)
                continue
            pair = []
            for arr in layer:
                arr = np.asarray(arr, np.float32)
                pair.append(_quantize_int8(arr) if self.quant == "int8"
                            else arr)
            stored.append(tuple(pair))
        self._blocks[key] = stored
        self._blocks.move_to_end(key)

    def take(self, key: bytes) -> list:
        """Pop a ready entry, dequantized to fp32 (promotion payload)."""
        stored = self._blocks.pop(key)
        out = []
        for layer in stored:
            if layer is None:
                out.append(None)
                continue
            pair = []
            for item in layer:
                if self.quant == "int8":
                    q, scale = item
                    pair.append(q.astype(np.float32) * scale)
                else:
                    pair.append(item)
            out.append(tuple(pair))
        return out

    def discard(self, key: bytes):
        self._blocks.pop(key, None)


def block_keys(token_ids, page_size: int) -> List[bytes]:
    """Chained SHA-256 digests, one per *full* page of ``token_ids`` —
    digest i commits to every token in blocks 0..i, so a match at block
    i implies the whole prefix matches. A cryptographic digest (not
    Python's 64-bit ``hash``) keys the index: a collision would map a
    wrong page into a block table and silently serve wrong KV. Shared by
    the live manager and the cluster simulator's routing-signal index —
    one hashing convention, so sim and real prefix affinity agree."""
    ids = np.asarray(token_ids, dtype=np.int64)
    keys: List[bytes] = []
    prev = b""
    for i in range(len(ids) // page_size):
        blk = ids[i * page_size:(i + 1) * page_size].tobytes()
        prev = hashlib.sha256(prev + blk).digest()
        keys.append(prev)
    return keys


@dataclass
class PrefixCacheStats:
    lookups: int = 0             # lock_prefix calls against the index
    lookup_tokens: int = 0       # prompt tokens those lookups covered
    hit_requests: int = 0        # lookups that matched >= 1 page
    hit_tokens: int = 0          # prompt tokens served from cached pages
    cow_copies: int = 0          # shared pages privatised before a write
    evictions: int = 0           # cached blocks dropped (content lost)
    pages_allocated: int = 0     # fresh pages handed out (excl. CoW copies)
    # tier migration counters (0 unless a host tier is configured)
    demotions: int = 0           # HBM_CACHED blocks moved to the host tier
    promotions: int = 0          # host blocks copied back into HBM pages
    host_hit_requests: int = 0   # lookups served partly from the host tier
    host_hit_tokens: int = 0     # hit_tokens subset served via promotion
    host_evictions: int = 0      # host-tier blocks dropped for capacity

    @property
    def hit_rate(self) -> float:
        """Token-level hit rate over all prefix lookups."""
        return self.hit_tokens / max(1, self.lookup_tokens)


class PagedKVCacheManager:
    """Host-side allocator. Pages are identified by int indices into the
    device pools; page 0 is reserved as the null page (padding in block
    tables), matching common paged-attention implementations.

    With ``prefix_cache=True`` the manager additionally keeps per-page
    refcounts, a chained block-hash index over full pages, and an LRU of
    unreferenced cached pages. Shared pages are read-only: the engine must
    route any write that lands in an existing page through
    :meth:`ensure_writable` and apply the returned (src, dst) device copies
    before dispatching the program that writes.

    With ``host_pool`` set (requires ``prefix_cache``), LRU reclamation
    demotes block content to the :class:`HostPageStore` instead of dropping
    it, and prefix matches against host-resident digests schedule
    promotions back into fresh HBM pages. The manager is pure bookkeeping:
    it queues migrations, the engine moves the bytes
    (:meth:`drain_demotions` / :meth:`complete_demotion` /
    :meth:`drain_promotions`)."""

    def __init__(self, pool: PagePoolConfig, *, prefix_cache: bool = False,
                 host_pool: Optional[HostPoolConfig] = None):
        self.pool = pool
        self.page_size = pool.page_size
        self.prefix_cache = prefix_cache
        self._free: List[int] = list(range(pool.num_pages - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}
        # prefix-cache state (empty and inert when prefix_cache=False)
        self._ref: Dict[int, int] = {}              # page -> live refcount
        self._page_hash: Dict[int, bytes] = {}      # page -> chain digest
        self._hash_index: Dict[bytes, int] = {}     # chain digest -> page
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # ref==0, cached
        self.stats = PrefixCacheStats()
        # tier state machine: every non-null page id has an explicit tier;
        # transitions are validated against _TIER_TRANSITIONS
        self._tier: Dict[int, str] = {
            p: PageTier.FREE for p in range(1, pool.num_pages)}
        if host_pool is not None and host_pool.num_pages > 0:
            if not prefix_cache:
                raise ValueError(
                    "host_pool requires prefix_cache=True: the host tier "
                    "stores hash-indexed prefix blocks")
            self.host: Optional[HostPageStore] = HostPageStore(host_pool)
        else:
            self.host = None
        # migration queues, serviced by the engine between dispatches:
        # demotions carry (page, digest) pairs whose HBM content must be
        # captured before the page is rewritten; promotions carry
        # (page, digest, fp32 payload) ready to scatter into the pools.
        self._pending_demotions: List[Tuple[int, bytes]] = []
        self._pending_promotions: List[Tuple[int, bytes, list]] = []
        self._promo_pages: Dict[int, bytes] = {}    # page -> queued digest

    # ------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        """Pages available to new allocations. Unreferenced cached pages
        count as free — eviction is transparent to admission."""
        return len(self._free) + len(self._lru)

    @property
    def used_pages(self) -> int:
        """Pages actively referenced by at least one request."""
        return (self.pool.num_pages - 1) - self.free_pages

    @property
    def cached_pages(self) -> int:
        """Pages retained in the hash index (referenced or evictable)."""
        return len(self._page_hash)

    @property
    def shared_pages(self) -> int:
        """Pages mapped into more than one request's block table."""
        return sum(1 for c in self._ref.values() if c > 1)

    def utilization(self) -> float:
        return self.used_pages / max(1, self.pool.num_pages - 1)

    def tier_counts(self) -> Dict[str, int]:
        """Page/block population per lifecycle tier. HBM tiers count page
        ids; ``host_cached`` counts ready host-store blocks (pending
        captures excluded — they are not matchable yet)."""
        counts = {PageTier.FREE: 0, PageTier.HBM_ACTIVE: 0,
                  PageTier.HBM_CACHED: 0}
        for t in self._tier.values():
            counts[t] += 1
        counts[PageTier.HOST_CACHED] = \
            self.host.ready_count() if self.host else 0
        return counts

    def prefix_stats(self) -> dict:
        if self.host is not None:
            self.stats.host_evictions = self.host.evictions
        d = {k: getattr(self.stats, k)
             for k in ("lookups", "lookup_tokens", "hit_requests",
                       "hit_tokens", "cow_copies", "evictions",
                       "pages_allocated", "demotions", "promotions",
                       "host_hit_requests", "host_hit_tokens",
                       "host_evictions")}
        d["hit_rate"] = self.stats.hit_rate
        d["cached_pages"] = self.cached_pages
        d["shared_pages"] = self.shared_pages
        d["tiers"] = self.tier_counts()
        # engines may disable a requested cache (e.g. recurrent blocks);
        # stream/summary consumers need the effective setting, not the flag
        d["enabled"] = self.prefix_cache
        d["host_tier"] = self.host is not None
        return d

    def pages_needed(self, rid: int, new_tokens: int) -> int:
        """Extra pages ``rid``'s table needs to hold ``new_tokens`` more
        tokens (0 when the current tail page has room)."""
        cur = self._lengths.get(rid, 0)
        cur_pages = len(self._tables.get(rid, []))
        need_pages = -(-(cur + new_tokens) // self.page_size)
        return max(0, need_pages - cur_pages)

    def can_allocate(self, rid: int, new_tokens: int) -> bool:
        """Whether :meth:`allocate` of ``new_tokens`` for ``rid`` would
        succeed against the current free pool."""
        return self.pages_needed(rid, new_tokens) <= self.free_pages

    def can_admit(self, requests_new_tokens: Dict[int, int]) -> bool:
        """Whether the combined footprint ``{rid: new_tokens}`` fits the
        free pool — the policies' admission check."""
        need = sum(self.pages_needed(r, n)
                   for r, n in requests_new_tokens.items())
        return need <= self.free_pages

    # ---------------------------------------------------------- allocation
    def _set_tier(self, page: int, new: str):
        """Validated lifecycle transition — an illegal edge is always a
        manager bug, so fail loudly instead of corrupting the ledger."""
        old = self._tier[page]
        if old == new:
            return
        if (old, new) not in _TIER_TRANSITIONS:
            raise AssertionError(
                f"illegal page-tier transition {old} -> {new} (page {page})")
        self._tier[page] = new

    def _cancel_promotion(self, page: int):
        """Drop a queued promotion whose target page was reclaimed before
        the payload was scattered — the content is lost (plain eviction);
        demoting a page that never materialised in HBM would capture
        garbage."""
        key = self._promo_pages.pop(page)
        self._pending_promotions = [
            e for e in self._pending_promotions if e[0] != page]
        self.stats.promotions -= 1
        self.stats.evictions += 1
        return key

    def _take_page(self) -> int:
        """Pop a fresh page, reclaiming the LRU cached page if the free
        list is empty. With a host tier the reclaimed block is *demoted* —
        its digest moves to the host store and the page's content is queued
        for capture — instead of evicted. Raises MemoryError when the pool
        is truly out."""
        if self._free:
            return self._free.pop()
        if self._lru:
            page, _ = self._lru.popitem(last=False)
            key = self._page_hash.pop(page)
            del self._hash_index[key]
            if page in self._promo_pages:
                self._cancel_promotion(page)
            elif self.host is not None and self.host.reserve(key):
                self._pending_demotions.append((page, key))
                self.stats.demotions += 1
            else:
                self.stats.evictions += 1
            self._set_tier(page, PageTier.FREE)
            return page
        raise MemoryError("KV pool exhausted")

    def _activate(self, page: int, ref: int = 1):
        """Bind a page just popped by :meth:`_take_page` to a block table."""
        self._ref[page] = ref
        self._set_tier(page, PageTier.HBM_ACTIVE)

    def _release_page(self, page: int):
        """Drop one reference; an unreferenced page returns to the free
        list, or — when it backs a cached prefix block — to the LRU."""
        self._ref[page] = self._ref.get(page, 1) - 1
        if self._ref[page] > 0:
            return
        del self._ref[page]
        if page in self._page_hash:
            self._lru[page] = None
            self._set_tier(page, PageTier.HBM_CACHED)
        else:
            self._free.append(page)
            self._set_tier(page, PageTier.FREE)

    def allocate(self, rid: int, new_tokens: int) -> List[int]:
        """Extend `rid`'s table to cover `new_tokens` more tokens. Returns
        the newly assigned pages. Raises MemoryError when the pool is out."""
        need = self.pages_needed(rid, new_tokens)
        if need > self.free_pages:
            raise MemoryError(
                f"KV pool exhausted: need {need}, free {self.free_pages}")
        tbl = self._tables.setdefault(rid, [])
        new = [self._take_page() for _ in range(need)]
        for p in new:
            self._activate(p)
        self.stats.pages_allocated += need
        tbl.extend(new)
        self._lengths[rid] = self._lengths.get(rid, 0) + new_tokens
        return new

    def reserve_lookahead(self, rids: List[int], k: int,
                          headroom: int = 0) -> bool:
        """Preallocate pages covering k future decode tokens for every
        request (paper §4.3). All-or-nothing. ``headroom`` pages must remain
        available *after* the reservation — the engine budgets the CoW
        copies the decode append may still trigger, so privatisation can
        never hit an exhausted pool mid-dispatch."""
        need = sum(self.pages_needed(r, k) for r in rids)
        if need + headroom > self.free_pages:
            return False
        for r in rids:
            self.allocate(r, k)
            self._lengths[r] -= k     # reserved, not yet written
        return True

    def commit_tokens(self, rid: int, n: int):
        """Mark n reserved tokens as written. Committing past the request's
        allocated pages means the device program wrote unowned memory — that
        is always an engine bug (a dropped reserve_lookahead result), so
        fail loudly instead of corrupting the ledger."""
        new_len = self._lengths.get(rid, 0) + n
        if new_len > len(self._tables.get(rid, ())) * self.page_size:
            raise MemoryError(
                f"commit_tokens({rid}, {n}): length {new_len} exceeds "
                f"allocated pages ({len(self._tables.get(rid, ()))})")
        self._lengths[rid] = new_len

    def free(self, rid: int):
        """Release every page of ``rid``'s table (retire/preempt/reject).
        Dereferenced pages return to the free list, except cached prefix
        pages which move to the LRU and stay servable until evicted.
        Idempotent — an unknown ``rid`` is a no-op."""
        for p in self._tables.pop(rid, []):
            self._release_page(p)
        self._lengths.pop(rid, None)

    # ------------------------------------------------------ prefix caching
    def _block_keys(self, token_ids) -> List[bytes]:
        return block_keys(token_ids, self.page_size)

    def match_prefix(self, token_ids) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``token_ids`` at page granularity.
        Returns (matched_tokens, pages); does not take references. Blocks
        resident only in the host tier report page id ``-1`` (a
        placeholder — :meth:`lock_prefix` replaces it with a freshly
        promoted HBM page)."""
        return self.match_prefix_keys(self._block_keys(token_ids))

    def _match_chain(self, keys: List[bytes]) -> List[Tuple[str, int]]:
        """Longest indexed chain as (tier, page) pairs; host-tier entries
        (ready only — in-flight captures are unmatchable) carry page -1."""
        chain: List[Tuple[str, int]] = []
        for key in keys:
            page = self._hash_index.get(key)
            if page is not None:
                chain.append((PageTier.HBM_CACHED, page))
            elif self.host is not None and self.host.ready(key):
                chain.append((PageTier.HOST_CACHED, -1))
            else:
                break
        return chain

    def match_prefix_keys(self, keys: List[bytes]) -> Tuple[int, List[int]]:
        """:meth:`match_prefix` against precomputed chain digests
        (``block_keys``) — the cluster router hashes a prompt once and
        probes every replica's index with the same keys. Host-tier blocks
        count toward the match (the router's prefix-affinity signal must
        see demoted prefixes, or demotion would silently break warm-replica
        routing — and the optimistic ``_SimPrefixIndex`` parity with it)."""
        chain = self._match_chain(keys)
        return len(chain) * self.page_size, [p for _, p in chain]

    def lock_prefix(self, rid: int, token_ids) -> int:
        """Map the longest cached prefix of ``token_ids`` read-only into
        ``rid``'s (empty) block table, taking one reference per page.
        Returns the number of prompt tokens covered — capped at
        ``len(token_ids) - 1`` so at least one suffix token is recomputed
        (its logits are needed to sample the first output; when the whole
        page-aligned prompt is cached the final write triggers CoW).

        Host-tier blocks in the chain are *promoted*: each takes a fresh
        HBM page (queued for the engine to fill via
        :meth:`drain_promotions`), is re-indexed under its digest, and maps
        into the table like an HBM hit. HBM blocks in the chain are
        referenced *before* any promotion allocates, so a promotion's
        ``_take_page`` can never demote a page of the very chain being
        locked. If the pool cannot supply a promotion page the chain is
        truncated at that block — a shorter hit, never a failure."""
        if not self.prefix_cache or self._tables.get(rid):
            return 0
        self.stats.lookups += 1
        self.stats.lookup_tokens += len(token_ids)
        keys = self._block_keys(token_ids)
        chain = self._match_chain(keys)
        if min(len(chain) * self.page_size, len(token_ids) - 1) <= 0:
            return 0
        # pass 1: protect the chain's HBM pages from promotion-driven
        # reclamation by taking their references up front
        for tier, page in chain:
            if tier is not PageTier.HOST_CACHED:
                if page in self._lru:
                    del self._lru[page]
                    self._set_tier(page, PageTier.HBM_ACTIVE)
                self._ref[page] = self._ref.get(page, 0) + 1
        # pass 2: promote host blocks in chain order; truncate on pressure
        table: List[int] = []
        host_pages = 0
        for i, (tier, page) in enumerate(chain):
            if tier is not PageTier.HOST_CACHED:
                table.append(page)
                continue
            try:
                fresh = self._take_page()
            except MemoryError:
                for t2, p2 in chain[i:]:       # undo pass-1 refs past here
                    if t2 is not PageTier.HOST_CACHED:
                        self._release_page(p2)
                chain = chain[:i]
                break
            self._activate(fresh)
            key = keys[i]
            self._page_hash[fresh] = key
            self._hash_index[key] = fresh
            self._pending_promotions.append((fresh, key,
                                             self.host.take(key)))
            self._promo_pages[fresh] = key
            self.stats.promotions += 1
            host_pages += 1
            table.append(fresh)
        matched = min(len(chain) * self.page_size, len(token_ids) - 1)
        if matched <= 0:
            return 0
        self._tables[rid] = table
        self._lengths[rid] = matched
        self.stats.hit_requests += 1
        self.stats.hit_tokens += matched
        if host_pages:
            self.stats.host_hit_requests += 1
            # tokens actually served by promoted blocks: full pages, minus
            # the cap when the chain's last block is host-resident
            host_tokens = host_pages * self.page_size
            if chain and chain[-1][0] is PageTier.HOST_CACHED:
                host_tokens -= len(chain) * self.page_size - matched
            self.stats.host_hit_tokens += host_tokens
        return matched

    # -------------------------------------------------- tier migration API
    def drain_demotions(self) -> List[Tuple[int, bytes]]:
        """Hand the queued (page, digest) demotions to the engine. The
        engine must capture each page's pool content *before* the next
        device op that may rewrite it (the page is already back on the
        free list) and return the bytes via :meth:`complete_demotion`."""
        out, self._pending_demotions = self._pending_demotions, []
        return out

    def complete_demotion(self, key: bytes, layers: list):
        """Store a captured page payload (list over layers of ``None`` or
        ``(k_page, v_page)`` arrays) under its digest; the block becomes
        matchable/promotable from the host tier."""
        if self.host is not None:
            self.host.put(key, layers)

    def drain_promotions(self) -> List[Tuple[int, bytes, list]]:
        """Hand the queued (page, digest, fp32 payload) promotions to the
        engine, which must scatter the payloads into the device pools
        before dispatching any program that reads those pages."""
        out, self._pending_promotions = self._pending_promotions, []
        for page, _, _ in out:
            self._promo_pages.pop(page, None)
        return out

    def insert_prefix(self, rid: int, token_ids):
        """Index ``rid``'s full pages under their block hashes (called once
        the content is final, i.e. at prefill completion). First writer
        wins: a block already indexed by another page is left alone — the
        duplicate pages stay private and die with their request."""
        if not self.prefix_cache:
            return
        tbl = self._tables.get(rid, [])
        for i, key in enumerate(self._block_keys(token_ids)):
            if i >= len(tbl) or key in self._hash_index:
                continue
            page = tbl[i]
            if page in self._page_hash:      # already indexed (matched page)
                continue
            self._page_hash[page] = key
            self._hash_index[key] = page

    def cow_pages_needed(self, rid: int, pos: int) -> int:
        """Extra pages a write starting at token ``pos`` would consume for
        copy-on-write (0 or 1 — only the first touched page can be shared;
        later pages are freshly allocated)."""
        return 1 if self._cow_target(rid, pos) is not None else 0

    def _cow_target(self, rid: int, pos: int) -> Optional[int]:
        tbl = self._tables.get(rid, ())
        idx = pos // self.page_size
        if idx >= len(tbl):
            return None
        page = tbl[idx]
        if self._ref.get(page, 1) > 1 or page in self._page_hash:
            return idx
        return None

    def ensure_writable(self, rid: int, pos: int) -> List[Tuple[int, int]]:
        """Privatise the page a write at token position ``pos`` would land
        in, when that page is shared (ref > 1) or indexed by the prefix
        cache. Returns device copies to apply as (src_page, dst_page) —
        the caller must execute them on the pools *before* the write."""
        idx = self._cow_target(rid, pos)
        if idx is None:
            return []
        tbl = self._tables[rid]
        old = tbl[idx]
        new = self._take_page()
        self._activate(new)
        tbl[idx] = new
        self._release_page(old)
        self.stats.cow_copies += 1
        return [(old, new)]

    def page_table(self, rid: int) -> List[int]:
        """Copy of ``rid``'s block table (page ids, in token order);
        empty for an unknown ``rid``."""
        return list(self._tables.get(rid, []))

    def length(self, rid: int) -> int:
        """Committed token count of ``rid`` (reserved-but-unwritten
        look-ahead slots excluded)."""
        return self._lengths.get(rid, 0)

    def padded_tables(self, rids: List[int], max_pages: int) -> np.ndarray:
        """(B, max_pages) int32 block-table matrix, null-page padded. A
        table wider than ``max_pages`` is always a caller bug (a stale
        width bucket); truncating it would silently drop KV pages from the
        dispatch and serve wrong attention context, so fail loudly."""
        out = np.zeros((len(rids), max_pages), np.int32)
        for i, r in enumerate(rids):
            tbl = self._tables.get(r, [])
            if len(tbl) > max_pages:
                raise ValueError(
                    f"padded_tables: request {r} spans {len(tbl)} pages > "
                    f"max_pages={max_pages}; a truncated block table would "
                    "serve wrong KV")
            out[i, :len(tbl)] = tbl
        return out


# ---------------------------------------------------------------------------
# Device pools + plain read/write (the CUDA kernels read the same layout)
# ---------------------------------------------------------------------------
def init_page_pools(cfg: ArchConfig, pool: PagePoolConfig,
                    dtype=torch.float32, *, device="cpu"):
    """Per-attention-layer (k_pages, v_pages) tensors on ``device``, or
    (ckv_pages (N, ps, r), krope_pages (N, ps, rope)) latent pools for an
    MLA layer. Recurrent layers (SSM/xLSTM) hold None — their state is O(1) and lives
    in the per-slot cache. Page 0 is the reserved null page: block tables
    pad with it and inactive slots write into it. An unknown kind is an
    error, not a silent stateless layer."""
    pools = []
    for kind in cfg.block_pattern:
        if kind in GQA_KINDS:
            shape = (pool.num_pages, pool.page_size, cfg.num_kv_heads,
                     cfg.head_dim)
            pools.append((torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device)))
        elif kind in MLA_KINDS:
            shape_c = (pool.num_pages, pool.page_size, cfg.kv_lora_rank)
            shape_r = (pool.num_pages, pool.page_size, cfg.qk_rope_dim)
            pools.append((torch.zeros(shape_c, dtype=dtype, device=device),
                          torch.zeros(shape_r, dtype=dtype, device=device)))
        elif kind in RECURRENT_KINDS:
            pools.append(None)
        else:
            raise ValueError(f"init_page_pools: unknown block kind {kind!r}")
    return pools


def copy_pool_pages(pools, copies: List[Tuple[int, int]]):
    """Apply CoW page copies (src, dst) to every attention layer's pools,
    in place. Host-triggered device ops only — no blocking reads, so the
    async engine can enqueue them between dispatches. Returns ``pools``."""
    if not copies:
        return pools
    dev = next(p[0].device for p in pools if p is not None)
    src = to_device([s for s, _ in copies], dev, torch.long)
    dst = to_device([d for _, d in copies], dev, torch.long)
    for p in pools:
        if p is not None:
            for pages in p:
                pages.index_copy_(0, dst, pages.index_select(0, src))
    return pools


def write_kv_page(pages: torch.Tensor, kv: torch.Tensor,
                  page_ids: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """Scatter new tokens into pages, in place. kv (B, T, ...) with
    page_ids/offsets (B, T) addressing (page, slot) per token."""
    flat = kv.reshape((-1,) + tuple(kv.shape[2:]))
    pages.index_put_((page_ids.reshape(-1).long(),
                      offsets.reshape(-1).long()), flat.to(pages.dtype))
    return pages


def gather_kv(pages: torch.Tensor, table: torch.Tensor,
              length: int) -> torch.Tensor:
    """Reference gather: (pages (N,ps,...), table (n_pages,)) -> (L, ...)."""
    ps = pages.shape[1]
    n = -(-length // ps)
    gathered = pages[table[:n].long()]              # (n, ps, ...)
    return gathered.reshape((-1,) + tuple(pages.shape[2:]))[:length]
