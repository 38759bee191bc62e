"""Paged KV-cache bookkeeping: the block allocator and the prefix index.

The port's own copy of the host half of the reference's ``serve/kvpool.py``
(framework-free; the handoff wire format comes with the disaggregation
slice, ROADMAP Q3).

  * ``KVBlockPool`` — fixed-size physical pages over the device-resident KV
    pool, refcounted so requests sharing a prompt prefix map the *same*
    physical pages.  Sharing is copy-on-write at page granularity: only
    *full* prompt pages enter the prefix index, and decode always appends
    into pages the slot owns exclusively.
  * ``chain_keys`` — rolling content hash per page (each key commits to the
    whole token prefix, not just its own chunk).
  * ``ColdTier`` — the host-memory tier that evicted prefix pages spill to
    and fault back from.

Physical page 0 is reserved as a scratch page: device programs point every
unused/retired block-table entry at it, so released decode rows and padded
logical pages scatter harmlessly instead of corrupting live pages.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.locks import make_lock

SCRATCH_PAGE = 0


def chain_keys(tokens: np.ndarray, page_size: int) -> List[bytes]:
    """Rolling hash per *full* page of ``tokens``.

    ``key[i]`` commits to tokens ``[0, (i+1)*page_size)``, so equal keys imply
    equal prefixes — a lookup never needs to re-verify token content.
    ``tokens`` must be a contiguous int32 array: the engines normalize every
    prompt once, at submission, so this admission-path helper does no
    conversion of its own.
    """
    out: List[bytes] = []
    h = b""
    for i in range(len(tokens) // page_size):
        chunk = tokens[i * page_size:(i + 1) * page_size]
        h = hashlib.blake2b(h + chunk.tobytes(), digest_size=16).digest()
        out.append(h)
    return out


class KVBlockPool:
    """Refcounted page allocator with a hash-keyed prefix index.

    States of a physical page:
      * **free** — on the free stack, content meaningless.
      * **active** — refcount > 0; owned by one slot, or shared read-only by
        several slots through the prefix index (full prompt pages only).
      * **cached** — refcount == 0 but still indexed by its chain key: a
        reusable prefix kept warm until pool pressure evicts it (LRU) to the
        cold tier.
    """

    def __init__(self, num_pages: int, page_size: int,
                 prefix_cache: bool = True):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the scratch page)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        # The engine loop allocates/evicts while router threads probe() and
        # cluster/bench threads read stats(): one internal lock covers every
        # mutable structure and counter.  The spill callback passed to
        # alloc()/evict_one() runs *under* this lock and must not call back
        # into the pool.
        self._lock = make_lock("KVBlockPool._lock")
        # Lowest-numbered free page first: deterministic like SlotTable.
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # guarded-by: _lock
        self._refs = np.zeros(num_pages, np.int64)   # guarded-by: _lock
        self._chain_of: Dict[int, bytes] = {}        # guarded-by: _lock
        self._index: Dict[bytes, int] = {}           # guarded-by: _lock
        self._cached: "OrderedDict[int, bytes]" = OrderedDict()  # guarded-by: _lock
        # Stats (host-side; read by engine.stats()).
        self.hit_pages = 0          # guarded-by: _lock
        self.lookup_pages = 0       # guarded-by: _lock
        self.faults = 0             # guarded-by: _lock
        self.spills = 0             # guarded-by: _lock
        # Accounting-drift counters: non-zero means a caller bug, but the
        # pool degrades (alloc -> None / unref ignored) instead of killing
        # the engine thread that hit it.
        self.alloc_failures = 0     # guarded-by: _lock
        self.unref_underflows = 0   # guarded-by: _lock

    # -- capacity ------------------------------------------------------------
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def cached_count(self) -> int:
        with self._lock:
            return len(self._cached)

    def available(self) -> int:
        """Pages obtainable right now (free + evictable cached)."""
        with self._lock:
            return len(self._free) + len(self._cached)

    def active_count(self) -> int:
        with self._lock:
            return int((self._refs > 0).sum())

    # -- alloc / refcounting -------------------------------------------------
    def alloc(self, n: int,
              evict_cb: Optional[Callable[[int, bytes], None]] = None
              ) -> Optional[List[int]]:
        """Take ``n`` pages, evicting LRU cached prefixes when the free stack
        runs dry (``evict_cb(page, chain)`` spills content *before* reuse).
        Returns None — and takes nothing — if the pool cannot satisfy ``n``.

        This sits on the serve hot path, so it must never throw on internal
        accounting drift: if ``available()`` over-promised (a refcount bug
        upstream), the partially-taken pages are rolled back onto the free
        stack and the call degrades to None — the engine's deferred-admission
        path retries later instead of the decode thread dying."""
        with self._lock:
            if len(self._free) + len(self._cached) < n:
                return None
            got: List[int] = []
            while len(got) < n:
                if self._free:
                    got.append(self._free.pop())
                    continue
                if self._evict_locked(evict_cb) is None:
                    # available() promised a page that isn't there: roll back
                    # (pop order reversed restores the original stack), defer.
                    while got:
                        self._free.append(got.pop())
                    self.alloc_failures += 1
                    return None
            for p in got:
                self._refs[p] = 1
            return got

    def ref(self, page: int) -> None:
        with self._lock:
            if self._refs[page] == 0:
                self._cached.pop(page, None)
            self._refs[page] += 1

    def unref(self, page: int) -> None:
        with self._lock:
            if self._refs[page] <= 0:
                # Double-unref is an upstream bug, but the page is already
                # free/cached — count it and carry on rather than kill the
                # engine thread mid-decode.
                self.unref_underflows += 1
                return
            self._refs[page] -= 1
            if self._refs[page] > 0:
                return
            chain = self._chain_of.get(page)
            if chain is not None and self.prefix_cache:
                self._cached[page] = chain       # keep warm, LRU order
                self._cached.move_to_end(page)
            else:
                self._forget(page)
                self._free.append(page)

    def _forget(self, page: int) -> None:  # requires: _lock
        chain = self._chain_of.pop(page, None)
        if chain is not None and self._index.get(chain) == page:
            del self._index[chain]

    # -- prefix index ----------------------------------------------------------
    def lookup(self, chain: bytes) -> Optional[int]:
        """Hot hit: returns the page or None.  NOTE: this does *not* pin the
        page — between this call and a later ``ref()``, ``alloc()`` on
        another thread may evict a cached page and hand it to a different
        slot (the ref would then pin someone else's KV).  Callers that
        intend to use the page must call :meth:`lookup_and_ref` instead;
        bare lookup is only safe for stats/affinity probes and
        single-threaded tests."""
        with self._lock:
            self.lookup_pages += 1
            page = self._index.get(chain)
            if page is None:
                return None
            self.hit_pages += 1
            if page in self._cached:
                self._cached.move_to_end(page)   # touched: most-recently-used
            return page

    def lookup_and_ref(self, chain: bytes) -> Optional[int]:
        """Atomic hot hit + pin: hit counters, LRU touch, and the refcount
        increment all happen in one critical section, so a concurrent
        ``alloc()`` can never evict the page between the index read and the
        pin (the lookup()-then-ref() race: the evicted page gets handed to
        another slot and the late ref() pins foreign KV)."""
        with self._lock:
            self.lookup_pages += 1
            page = self._index.get(chain)
            if page is None:
                return None
            self.hit_pages += 1
            if self._refs[page] == 0:
                self._cached.pop(page, None)     # pinned: off the LRU
            self._refs[page] += 1
            return page

    def probe(self, chain: bytes) -> bool:
        """Whether a chain is hot-indexed, *without* touching LRU order or
        hit counters — a read-only affinity probe for the cluster router
        (a probe that refreshed LRU recency would let routing queries keep
        pages alive that no request ever reused)."""
        with self._lock:
            return chain in self._index

    def register(self, chain: bytes, page: int) -> None:
        """Index a freshly-computed full prompt page.  First writer wins: if
        the chain is already indexed (two identical prompts prefilled
        concurrently), the duplicate page stays private to its slot."""
        with self._lock:
            if not self.prefix_cache or chain in self._index:
                return
            self._index[chain] = page
            self._chain_of[page] = chain

    def note_fault(self) -> None:
        """Count a cold-tier fault-in (backends call this instead of poking
        the counter, which would race the engine loop)."""
        with self._lock:
            self.faults += 1

    def _evict_locked(self,
                      evict_cb: Optional[Callable[[int, bytes], None]] = None
                      ) -> Optional[Tuple[int, bytes]]:  # requires: _lock
        if not self._cached:
            return None
        page, chain = self._cached.popitem(last=False)
        if evict_cb is not None:
            evict_cb(page, chain)
            self.spills += 1
        self._forget(page)
        self._free.append(page)
        return page, chain

    def evict_one(self, evict_cb: Optional[Callable[[int, bytes], None]] = None
                  ) -> Optional[Tuple[int, bytes]]:
        """Evict the LRU cached page to the free stack, spilling first.
        ``evict_cb`` runs under the pool lock: it must not re-enter the
        pool (the paged backend's spill only reads device pages and feeds
        the cold tier / sidecar, which are separate lock domains)."""
        with self._lock:
            return self._evict_locked(evict_cb)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "pages": self.num_pages,
                "free": len(self._free),
                "cached": len(self._cached),
                "active": int((self._refs > 0).sum()),
                "prefix_hit_pages": self.hit_pages,
                "prefix_lookup_pages": self.lookup_pages,
                "faults": self.faults,
                "spills": self.spills,
                "alloc_failures": self.alloc_failures,
                "unref_underflows": self.unref_underflows,
            }


class ColdTier:
    """Host-memory tier for spilled KV pages (paper advice #3).

    The engine inserts a spilled page's blob *synchronously* (fresh device
    copies), then the sidecar executor stages it to host memory and
    ``replace``s the entry in place — so a prefix hit racing an in-flight
    spill always finds the blob, and a failed/dropped staging task degrades
    to keeping the device copies (never a dangling wait).  Capacity is
    counted in pages; over capacity the LRU entry is dropped (a lost cold
    prefix is just a future recompute)."""

    def __init__(self, capacity_pages: int = 256):
        self.capacity = capacity_pages
        self._lock = make_lock("ColdTier._lock")
        self._store: "OrderedDict[bytes, Any]" = OrderedDict()  # guarded-by: _lock
        self.dropped = 0        # guarded-by: _lock
        self.rejected = 0       # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def put(self, chain: bytes, blob: Any) -> None:
        with self._lock:
            if self.capacity <= 0:
                # A zero-capacity tier accepts nothing: inserting and then
                # immediately dropping the same entry would skew ``dropped``
                # (which counts entries that lost an LRU race).
                self.rejected += 1
                return
            self._store[chain] = blob
            self._store.move_to_end(chain)
            # capacity >= 1 and the new entry sits at the MRU end, so the
            # LRU pop below can never evict the entry just inserted.
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
                self.dropped += 1

    def replace(self, chain: bytes, blob: Any) -> None:
        """Swap an entry's payload (device copies -> host-staged tensors)
        without bumping LRU order; a no-op if the entry was dropped or
        faulted back meanwhile."""
        with self._lock:
            if chain in self._store:
                self._store[chain] = blob

    def take(self, chain: bytes) -> Optional[Any]:
        """Pop a blob (it is moving back to the hot tier); None on miss."""
        with self._lock:
            return self._store.pop(chain, None)

    def contains(self, chain: bytes) -> bool:
        with self._lock:
            return chain in self._store

    def blobs(self) -> List[Any]:
        """The payloads held now, LRU first (for checks that every entry
        reached host memory)."""
        with self._lock:
            return list(self._store.values())
