"""Serving configs: the engine-mode enum and ``ServeConfig``.

The port's own copy of the reference package's ``config/run.py`` (only the
serve half; training, mesh and offload configs come with later slices).
Fields nothing in the port reads yet come with the slice that reads them
(disaggregation, the cluster, the drafter, the snapshot pool); the fields
of features the port rejects (speculative decoding, engine modes) are kept
so a caller hears which ROADMAP item is missing.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class EngineMode(str, enum.Enum):
    """Which serve engine ``repro_torch.serve.make_engine`` builds."""
    FIXED = "fixed"
    CONTINUOUS = "continuous"
    PAGED = "paged"
    DISAGGREGATED = "disaggregated"
    CLUSTER = "cluster"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs.  ``max_batch`` is the fixed decode width (slot count);
    the admission plane fills/evicts slots between decode steps."""
    max_batch: int = 8
    max_seq_len: int = 1024          # decode-state capacity per slot
    temperature: float = 0.0         # 0 -> greedy
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # Continuous-batching admission plane
    max_queue: int = 64              # bounded request queue (backpressure)
    eos_id: int = -1                 # -1 -> no EOS eviction
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    result_shards: int = 4           # ShardedStore endpoints for results
    stats_every: int = 64            # engine-stats snapshot period (steps)
    # Paged KV-cache (PagedEngine): fixed-size pages + block tables instead
    # of a dense per-slot cache; memory scales with live tokens.
    page_size: int = 16              # tokens per physical KV page
    num_pages: int = 0               # pool size; 0 -> full residency for
    #                                  every slot (max_batch * pages_per_seq)
    prefix_cache: bool = True        # hash-keyed prefix page sharing (CoW)
    kv_quant: str = "none"           # "none" | "int8" (per-entry/head scales)
    cold_pages: int = 256            # host-tier spill capacity; 0 disables
    #                                  the tiered-memory plane
    speculative: bool = False        # speculative decoding (ROADMAP Q4)
    # Engine selection (EngineMode): "" -> "continuous".
    engine_mode: str = ""
