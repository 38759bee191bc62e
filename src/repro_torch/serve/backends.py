"""Decode-state backends behind ``PagedEngine`` (counterpart of the
reference's ``serve/backends.py``).

``CacheBackend`` is the contract between the admission plane (the engine:
slots, queue, mirrors, results) and the cache substrate (pool, block
tables, device programs).  This slice ports ``PagedKVBackend``: refcounted
pages, block tables and chain-key copy-on-write prefix reuse.  Left for
later slices, each raising ``NotImplementedError`` naming its ROADMAP item:
the snapshot backend for recurrent/SWA archs, the cold tier (spill and
fault-in), handoff export/import and speculative verify.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.model import ModelConfig
from repro_torch.config.run import ServeConfig
from repro_torch.models.transformer import (
    init_paged_decode_state, supports_paging)
from repro_torch.serve import programs
from repro_torch.serve.kvpool import SCRATCH_PAGE, KVBlockPool, chain_keys
from repro_torch.serve.scheduler import Request

_NO_HANDOFF = ("KV handoff export/import (disaggregated and cluster serving) "
               "is not ported yet (ROADMAP Q3)")


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
    """Block-table KV paging: refcounted pages, chain-key CoW prefix reuse.
    See ``serve.kvpool`` for the host-side allocator."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig):
        super().__init__(cfg, scfg)
        if scfg.kv_quant == "int8":
            raise NotImplementedError(
                "kv_quant='int8' pages need the quantized paged-attention "
                "kernel K2 (ROADMAP Q1)")
        if scfg.kv_quant != "none":
            raise ValueError(f"kv_quant={scfg.kv_quant!r}: expected 'none'")
        if scfg.cold_pages > 0:
            raise NotImplementedError(
                f"cold_pages={scfg.cold_pages}: the spill/fault-in tier is "
                "not ported yet (ROADMAP Q2); pass cold_pages=0")
        if scfg.max_seq_len % scfg.page_size:
            raise ValueError(f"max_seq_len ({scfg.max_seq_len}) must be a "
                             f"multiple of page_size ({scfg.page_size})")
        self.page_size = scfg.page_size
        self.pages_per_seq = scfg.max_seq_len // scfg.page_size
        num_pages = scfg.num_pages or (scfg.max_batch * self.pages_per_seq + 1)
        if num_pages < self.pages_per_seq + 1:
            raise ValueError(
                f"num_pages ({num_pages}) must cover one full sequence "
                f"({self.pages_per_seq}) plus the scratch page")
        self.pool = KVBlockPool(num_pages, scfg.page_size,
                                prefix_cache=scfg.prefix_cache)
        self._table = np.full((scfg.max_batch, self.pages_per_seq),
                              SCRATCH_PAGE, np.int32)

    def build_device_plane(self) -> None:
        eng = self.engine
        self._admit_prog = programs.paged_admit_program(
            self.cfg, eng.policy, self.scfg.max_seq_len)
        self._decode_prog = programs.paged_decode_program(self.cfg,
                                                          eng.policy)
        eng.states = init_paged_decode_state(
            self.cfg, self.pool.num_pages, self.page_size,
            kv_quant=self.scfg.kv_quant, device=eng.device)

    # -- admission -------------------------------------------------------------
    def _match_prefix(self, req: Request, chains: List[bytes]) -> List[int]:
        """Longest chain of *full* prompt pages already resident.  Always
        leaves >= 1 token to prefill so the admit program has a real
        last-token logit to sample from."""
        limit = (len(req.prompt) - 1) // self.page_size
        pages: List[int] = []
        for chain in chains[:limit]:
            # Atomic hit + pin (a lookup()/ref() pair races alloc()).
            page = self.pool.lookup_and_ref(chain)
            if page is None:
                break
            pages.append(page)
        return pages

    def _register_prefix(self, req: Request, chains: List[bytes],
                         pages: List[int], n_hit: int) -> None:
        """Index the freshly-prefilled full prompt pages for future sharing."""
        for i in range(n_hit, len(req.prompt) // self.page_size):
            self.pool.register(chains[i], pages[i])

    def _reserve_pages(self, req: Request, chains: List[bytes],
                       need: int) -> Optional[Tuple[List[int], int]]:
        """Prefix-match, allocate the remainder, update hit accounting.
        Returns ``(pages, n_hit)``, or None when admission must defer — hit
        refs are rolled back so decode can free pages in the meantime."""
        hit_pages = self._match_prefix(req, chains)
        n_hit = len(hit_pages)
        new_pages = self.pool.alloc(need - n_hit)
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
                "prefix_hit_rate": self._hit_rate()}
