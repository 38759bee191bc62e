"""Decode-state backends behind ``PagedEngine`` (counterpart of the
reference's ``serve/backends.py``).

``CacheBackend`` is the contract between the admission plane (the engine:
slots, queue, mirrors, results) and the cache substrate (pool, block
tables, device programs).  This slice ports ``PagedKVBackend``: refcounted
pages in the model dtype or int8, block tables, chain-key copy-on-write
prefix reuse, and LRU spill of cached prefix pages to the ``ColdTier`` with
fault-in on a later hit.  Left for later slices, each raising
``NotImplementedError`` naming its ROADMAP item: the snapshot backend for
recurrent/SWA archs, handoff export/import and speculative verify.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.model import ModelConfig
from repro_torch.config.run import ServeConfig
from repro_torch.models.attention import KV_QUANT_MODES
from repro_torch.models.transformer import (
    init_paged_decode_state, supports_paging)
from repro_torch.serve import programs
from repro_torch.serve.kvpool import (
    SCRATCH_PAGE, ColdTier, KVBlockPool, chain_keys)
from repro_torch.serve.scheduler import Request

_NO_HANDOFF = ("KV handoff export/import (disaggregated and cluster serving) "
               "is not ported yet (ROADMAP Q3)")


def _flatten(tree: Dict[str, Any]) -> Tuple[Dict[str, Any], List[Any]]:
    """A nested dict's leaves in a fixed order, and its skeleton (the same
    dicts, empty ones included, with every leaf replaced by None)."""
    leaves: List[Any] = []

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = None
                leaves.append(v)
        return out
    return walk(tree), leaves


def _unflatten(skeleton: Dict[str, Any], leaves) -> Dict[str, Any]:
    """Inverse of ``_flatten``."""
    it = iter(leaves)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else next(it)
                for k, v in node.items()}
    return walk(skeleton)


def make_backend(cfg: ModelConfig, scfg: ServeConfig) -> "CacheBackend":
    """Pick the decode-state discipline for an arch: block-table KV paging
    when the arch supports it."""
    if supports_paging(cfg):
        return PagedKVBackend(cfg, scfg)
    raise NotImplementedError(
        f"{cfg.arch_id}: the snapshot backend for recurrent/SWA/enc-dec "
        "archs is not ported yet (ROADMAP Q7)")


class CacheBackend:
    """The decode-state management contract behind ``PagedEngine``.

    One instance per engine; ``bind(engine)`` wires the back-reference
    before ``build_device_plane`` builds the programs and allocates
    ``engine.states``.  Device-touching methods run on the engine loop
    thread; the hit counters are guarded by ``engine._lock`` because
    ``stats()`` may race the loop."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig):
        self.cfg, self.scfg = cfg, scfg
        self.engine: Any = None
        self._prompt_tokens = 0       # guarded-by: engine._lock
        self._hit_tokens = 0          # guarded-by: engine._lock

    def bind(self, engine) -> None:
        self.engine = engine

    def build_device_plane(self) -> None:
        """Build the programs and set ``engine.states``."""
        raise NotImplementedError

    def decode_step(self) -> np.ndarray:
        """One batched decode dispatch; returns the (B,) sampled tokens."""
        raise NotImplementedError

    def admit(self, req: Request) -> Optional[int]:
        """Reuse what the cache holds, prefill the rest, join the batch.
        Returns the first sampled token, or None when admission must defer
        for resources."""
        raise NotImplementedError

    def release(self, req: Optional[Request], slot: int) -> None:
        """Give back whatever the backend reserved for a slot."""
        raise NotImplementedError

    def stats(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- handoff (disaggregated / cluster serving) -----------------------------
    def export_handoff(self, req: Request, rid: int, max_new_tokens: int,
                       first_token: int):
        """Package a freshly-admitted request's decode state for transport
        (the prefill endpoint's half)."""
        raise NotImplementedError(_NO_HANDOFF)

    def import_handoff(self, req: Request, h) -> Optional[int]:
        """Splice a transported decode state into the batch (the decode
        endpoint's half)."""
        raise NotImplementedError(_NO_HANDOFF)

    def _count_hit(self, prompt_len: int, hit_tokens: int) -> None:
        with self.engine._lock:
            self._prompt_tokens += prompt_len
            self._hit_tokens += hit_tokens

    def _hit_rate(self) -> float:
        with self.engine._lock:
            hit, prompt = self._hit_tokens, self._prompt_tokens
        return hit / prompt if prompt else 0.0


class PagedKVBackend(CacheBackend):
    """Block-table KV paging: refcounted pages, chain-key CoW prefix reuse,
    tiered spill/fault.  See ``serve.kvpool`` for the host-side allocator
    and the cold tier."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig):
        super().__init__(cfg, scfg)
        if scfg.max_seq_len % scfg.page_size:
            raise ValueError(f"max_seq_len ({scfg.max_seq_len}) must be a "
                             f"multiple of page_size ({scfg.page_size})")
        if scfg.kv_quant not in KV_QUANT_MODES:
            raise ValueError(f"kv_quant={scfg.kv_quant!r}: expected one of "
                             f"{KV_QUANT_MODES}")
        self.page_size = scfg.page_size
        self.pages_per_seq = scfg.max_seq_len // scfg.page_size
        num_pages = scfg.num_pages or (scfg.max_batch * self.pages_per_seq + 1)
        if num_pages < self.pages_per_seq + 1:
            raise ValueError(
                f"num_pages ({num_pages}) must cover one full sequence "
                f"({self.pages_per_seq}) plus the scratch page")
        self.pool = KVBlockPool(num_pages, scfg.page_size,
                                prefix_cache=scfg.prefix_cache)
        self.cold = ColdTier(scfg.cold_pages) if scfg.cold_pages > 0 else None
        self._table = np.full((scfg.max_batch, self.pages_per_seq),
                              SCRATCH_PAGE, np.int32)

    def build_device_plane(self) -> None:
        eng = self.engine
        self._admit_prog = programs.paged_admit_program(
            self.cfg, eng.policy, self.scfg.max_seq_len)
        self._decode_prog = programs.paged_decode_program(self.cfg,
                                                          eng.policy)
        # Page movers of the tiered plane: copy a page out for spilling
        # (fresh tensors, safe to stage on the sidecar) / write a faulted
        # page back in place.
        self._read_page_prog = programs.read_page_program()
        self._write_page_prog = programs.write_page_program()
        eng.states = init_paged_decode_state(
            self.cfg, self.pool.num_pages, self.page_size,
            kv_quant=self.scfg.kv_quant, device=eng.device)

    # -- tiered-memory plane ---------------------------------------------------
    def _spill(self, page: int, chain: bytes) -> None:
        """Evict a cached prefix page: copy its K/V (and scales) out of
        every pool into the cold tier, then let the sidecar stage the
        copies to host memory (``ColdTier.replace``).  ``alloc`` calls this
        on the engine thread before it hands the page out, so the copies
        are enqueued on the stream before any later program rewrites the
        page; the decode loop never waits for the device->host copy (advice
        #2), and a failed or dropped staging task leaves the device copies
        in place — never a dangling entry."""
        if self.cold is None:
            return
        eng = self.engine
        blob = self._read_page_prog(eng.states, page)
        self.cold.put(chain, blob)
        skeleton, leaves = _flatten(blob)
        eng.executor.submit(
            f"kv.spill/{chain.hex()[:8]}",
            functools.partial(self._cold_stage, chain, skeleton), *leaves)

    def _cold_stage(self, chain: bytes, skeleton, *host_leaves) -> None:
        # Runs on the sidecar once every leaf sits in host memory: the cold
        # entry becomes true host-tier memory.
        self.cold.replace(chain, _unflatten(skeleton, host_leaves))

    def _fault_in(self, chain: bytes) -> Optional[int]:
        """Bring a cold prefix page back into the pool.  Returns the hot
        page (ref'd for the caller) or None on a miss / full pool."""
        if self.cold is None or not self.cold.contains(chain):
            return None
        blob = self.cold.take(chain)
        if blob is None:
            return None
        got = self.pool.alloc(1, evict_cb=self._spill)
        if got is None:
            self.cold.put(chain, blob)          # no room: stay cold
            return None
        page = got[0]
        eng = self.engine
        self._write_page_prog(eng.states, page, blob)
        self.pool.register(chain, page)
        self.pool.note_fault()
        return page

    # -- admission -------------------------------------------------------------
    def _match_prefix(self, req: Request, chains: List[bytes]) -> List[int]:
        """Longest chain of *full* prompt pages already resident (hot hit)
        or spilled (cold fault-in).  Always leaves >= 1 token to prefill so
        the admit program has a real last-token logit to sample from."""
        limit = (len(req.prompt) - 1) // self.page_size
        pages: List[int] = []
        for chain in chains[:limit]:
            # Atomic hit + pin (a lookup()/ref() pair races alloc()).
            page = self.pool.lookup_and_ref(chain)
            if page is not None:
                pages.append(page)
                continue
            page = self._fault_in(chain)        # alloc() already ref'd it
            if page is None:
                break
            pages.append(page)
        return pages

    def prepare_probe(self, prompt: np.ndarray) -> List[bytes]:
        """Per-request probe handle: the prompt's chain keys (``prompt`` a
        contiguous int32 array)."""
        return chain_keys(prompt, self.page_size)

    def probe(self, handle) -> Tuple[int, int]:
        """Leading chain keys resident here (hot index or cold tier),
        *without* mutating LRU order or hit counters — the cluster
        router's affinity probe."""
        n = 0
        for chain in (handle or []):
            if self.pool.probe(chain) or \
                    (self.cold is not None and self.cold.contains(chain)):
                n += 1
            else:
                break
        return n, n * self.page_size

    def _register_prefix(self, req: Request, chains: List[bytes],
                         pages: List[int], n_hit: int) -> None:
        """Index the freshly-prefilled full prompt pages for future sharing."""
        for i in range(n_hit, len(req.prompt) // self.page_size):
            self.pool.register(chains[i], pages[i])

    def _reserve_pages(self, req: Request, chains: List[bytes],
                       need: int) -> Optional[Tuple[List[int], int]]:
        """Prefix-match (hot hit or cold fault-in), allocate the remainder
        (spilling evicted prefix pages), update hit accounting.  Returns
        ``(pages, n_hit)``, or None when admission must defer — hit refs
        are rolled back so decode can free pages in the meantime."""
        hit_pages = self._match_prefix(req, chains)
        n_hit = len(hit_pages)
        new_pages = self.pool.alloc(need - n_hit, evict_cb=self._spill)
        if new_pages is None:
            for p in hit_pages:
                self.pool.unref(p)
            return None
        pages = hit_pages + new_pages
        req.pages = pages
        req.prefix_hit_tokens = n_hit * self.page_size
        self._count_hit(len(req.prompt), n_hit * self.page_size)
        return pages, n_hit

    def _install_slot(self, req: Request, pages: List[int]) -> int:
        """Acquire a decode slot and point its block-table row at pages."""
        slot = self.engine.slots.acquire(req)
        row = np.full(self.pages_per_seq, SCRATCH_PAGE, np.int32)
        row[:len(pages)] = pages
        self._table[slot] = row
        return slot

    def admit(self, req: Request) -> Optional[int]:
        """Prefix-match, allocate, bucket-prefill the suffix through the
        paged admit program."""
        eng = self.engine
        pg, M = self.page_size, self.pages_per_seq
        L = len(req.prompt)
        need = -(-(L + req.max_new_tokens) // pg)
        chains = (chain_keys(req.prompt, pg) if self.scfg.prefix_cache
                  else [])
        got = self._reserve_pages(req, chains, need)
        if got is None:
            return None
        pages, n_hit = got
        hit_len = n_hit * pg

        slot = self._install_slot(req, pages)
        row = self._table[slot]
        # Hit pages scatter to the scratch page (never rewrite shared pages).
        assign = np.full(M, SCRATCH_PAGE, np.int32)
        assign[n_hit:len(pages)] = pages[n_hit:]

        suffix = req.prompt[hit_len:]
        # Clamp the suffix bucket so hit_len + S never wraps the solo cache.
        S = max(min(eng.scheduler.bucket_for(len(suffix)),
                    self.scfg.max_seq_len - hit_len), len(suffix), 1)
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(suffix)] = suffix
        positions = (hit_len + np.arange(S, dtype=np.int32))[None, :]
        dev = eng.device
        sp = req.sampling
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "positions": torch.from_numpy(positions).to(dev),
                 "length": L,
                 "hit_len": hit_len,
                 "table": torch.from_numpy(row.copy()).to(dev),
                 "assign": torch.from_numpy(assign).to(dev),
                 "slot": slot,
                 "temp": float(sp.temperature),
                 "top_k": int(sp.top_k),
                 "top_p": float(sp.top_p)}
        tok = self._admit_prog(eng.params, eng.states, batch, eng._gen,
                               eng._mirrors)
        if self.scfg.prefix_cache:
            self._register_prefix(req, chains, pages, n_hit)
        return int(tok[0])

    # -- decode / release ------------------------------------------------------
    def decode_step(self) -> np.ndarray:
        eng = self.engine
        # One host->device copy of the block table per step; every layer
        # reads the same device tensor.
        table = torch.from_numpy(self._table).to(eng.device,
                                                 non_blocking=True)
        toks = self._decode_prog(eng.params, eng.states, eng._gen,
                                 eng._mirrors, table, eng._any_stochastic())
        # The step's data dependency: host bookkeeping (outputs, EOS, stop
        # sequences) consumes every slot's token before the next step.
        return toks.cpu().numpy().copy()

    def release(self, req: Optional[Request], slot: int) -> None:
        if req is not None:
            for p in req.pages:
                self.pool.unref(p)      # shared pages stay; private ones free
            req.pages = []
        # Point the retired row at the scratch page: its mirrors keep
        # advancing through the fixed-shape decode, and those garbage writes
        # must never land in a page that gets reallocated.
        self._table[slot] = SCRATCH_PAGE

    def stats(self) -> Dict[str, Any]:
        return {"kv_pool": self.pool.stats(),
                "cold_pages": len(self.cold) if self.cold is not None else 0,
                "prefix_hit_rate": self._hit_rate()}
