"""``repro_torch.serve`` — the ported serving plane.

  * ``scheduler`` — ``Request`` / ``SlotTable`` / ``Scheduler`` /
    ``QueueFull``: the host-side admission plane.
  * ``programs``  — the dense/paged x admit/decode device programs.
  * ``engines``   — ``ContinuousEngine`` and ``PagedEngine``.
  * ``backends``  — ``CacheBackend`` / ``PagedKVBackend`` under
    ``PagedEngine``.
  * ``factory``   — ``make_engine(cfg, model, scfg)`` keyed on
    ``EngineMode``.
  * ``sampler`` / ``kvpool`` — sampling and the page pool bookkeeping.
"""
from repro_torch.config.run import EngineMode
from repro_torch.serve.backends import CacheBackend, PagedKVBackend, make_backend
from repro_torch.serve.engines import ContinuousEngine, PagedEngine
from repro_torch.serve.factory import make_engine, resolve_engine_mode
from repro_torch.serve.kvpool import KVBlockPool
from repro_torch.serve.sampler import SamplingParams
from repro_torch.serve.scheduler import QueueFull, Request

__all__ = [
    "CacheBackend", "ContinuousEngine", "EngineMode", "KVBlockPool",
    "PagedEngine", "PagedKVBackend", "QueueFull", "Request",
    "SamplingParams", "make_backend", "make_engine", "resolve_engine_mode",
]
