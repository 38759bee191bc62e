"""Host-side admission plane: request objects, slot table, bounded queue.

The port's own copy of the reference's ``serve/scheduler.py`` (it never
touches a device buffer, so it carries over unchanged apart from the
frontend embeddings, whose models are not ported yet).  Everything in here
runs on the host between device steps — admission, slot recycling, length
bucketing.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.config.model import (
    MIX_ATTN_LOCAL, MIX_RGLRU, MIX_RWKV6, ModelConfig)
from repro_torch.config.run import ServeConfig
from repro_torch.runtime.locks import make_lock
from repro_torch.serve.sampler import SamplingParams


class QueueFull(RuntimeError):
    """Raised on submit when the bounded admission queue is at capacity."""


StopSpec = Union[None, int, Sequence[int], Sequence[Sequence[int]]]


def normalize_stop(stop: StopSpec) -> Tuple[Tuple[int, ...], ...]:
    """Canonicalize a user-facing stop spec into a tuple of token-id
    sequences.  Accepts None, a single token id, one sequence of ids, or a
    list of sequences; every sequence must be non-empty (an empty stop
    sequence would finish every request at its first token)."""
    if stop is None:
        return ()
    if isinstance(stop, (int, np.integer)):
        return ((int(stop),),)
    seqs = []
    for item in stop:
        if isinstance(item, (int, np.integer)):
            # flat sequence of ids: the whole spec is ONE stop sequence
            return (tuple(int(t) for t in stop),)
        if len(item) == 0:
            raise ValueError("stop sequences must be non-empty")
        seqs.append(tuple(int(t) for t in item))
    return tuple(seqs)


def hit_stop_at(output: Sequence[int], stop: Tuple[Tuple[int, ...], ...],
                new_from: int = 0) -> Optional[int]:
    """Index one past the end of the *earliest* stop sequence completing at
    or after ``new_from``, or None.

    ``new_from`` is the output length before the newest tokens landed, plus
    one — i.e. the smallest end index a not-yet-seen stop could have.  With
    one token per step that reduces to the old ends-the-output suffix check;
    with a multi-token speculative accept the scan catches a stop sequence
    completing *inside* the chunk (including one whose head was emitted in
    earlier steps and whose tail spans the accept boundary), so the caller
    can truncate mid-chunk instead of over-generating to the chunk edge."""
    best = None
    for seq in stop:
        n = len(seq)
        if not n:
            continue
        for e in range(max(n, new_from), len(output) + 1):
            if tuple(output[e - n:e]) == seq:
                best = e if best is None else min(best, e)
                break
    return best


def hit_stop(output: Sequence[int],
             stop: Tuple[Tuple[int, ...], ...]) -> bool:
    """Whether the generated output ends with any stop sequence.  Host-side
    check after a single-token decode step — token-id sequences only (string
    matching would need the tokenizer on the serve plane)."""
    return hit_stop_at(output, stop, len(output)) is not None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32, contiguous
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    submitted_at: float = dataclasses.field(default_factory=time.time)
    first_token_at: float = 0.0
    finished_at: float = 0.0
    slot: int = -1
    output: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)  # paged backend
    prefix_hit_tokens: int = 0
    stop: Tuple[Tuple[int, ...], ...] = ()   # normalized stop sequences
    # Streaming: called with each token id as it is committed (host-side,
    # engine loop thread, after stop/EOS/budget truncation).  Disabled on
    # the first exception it raises.
    on_token: Optional[Callable[[int], None]] = None

    @property
    def done(self) -> bool:
        return self.finished_at > 0.0


class SlotTable:
    """Fixed-width slot bookkeeping for the decode batch.

    Admission always takes the *lowest* free index and eviction returns it,
    so slot assignment is deterministic — the admission/eviction ordering
    tests pin this down.
    """

    def __init__(self, width: int):
        self.width = width
        # Mutations come from the engine loop thread; free_count()/active()
        # are also read by router/cluster threads collecting signals.
        self._lock = make_lock("SlotTable._lock")
        self._req: List[Optional[Request]] = [None] * width  # guarded-by: _lock
        self._free: List[int] = list(range(width))           # guarded-by: _lock
        heapq.heapify(self._free)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def acquire(self, req: Request) -> int:
        with self._lock:
            slot = heapq.heappop(self._free)
            self._req[slot] = req
        req.slot = slot
        return slot

    def release(self, slot: int) -> None:
        with self._lock:
            assert self._req[slot] is not None, f"slot {slot} already free"
            self._req[slot] = None
            heapq.heappush(self._free, slot)

    def get(self, slot: int) -> Optional[Request]:
        with self._lock:
            return self._req[slot]

    def active(self) -> List[Request]:
        with self._lock:
            return [r for r in self._req if r is not None]


def needs_exact_prefill(cfg: ModelConfig) -> bool:
    """Archs whose decode state a right-padded prefill would pollute.

    Recurrent mixers fold every (pad) token into O(1) state, and SWA ring
    caches can be fully overwritten by pads; global-attention caches only
    need the pads' entries invalidated, which the bucket prefill does.

    Tradeoff: exact-prefill archs ignore ``prefill_buckets`` and retrace the
    admit program once per *distinct prompt length* (a compile stall on each
    new length, and an unbounded trace cache on a long-lived server).
    Callers serving such archs should quantize prompt lengths themselves, or
    accept the compile cost.
    """
    return (any(k in (MIX_RGLRU, MIX_RWKV6, MIX_ATTN_LOCAL)
                for k in cfg.pattern)
            or cfg.mlp_kind == "rwkv_cmix")


class Scheduler:
    """Host-side admission queue: bounded FIFO + prefill length bucketing."""

    def __init__(self, scfg: ServeConfig, exact_buckets: bool = False):
        self.max_queue = scfg.max_queue
        self.buckets = tuple(sorted(scfg.prefill_buckets))
        self.exact = exact_buckets
        self.capacity = scfg.max_seq_len
        # Producers push from submit() threads while the engine loop pops;
        # depth() feeds router signals from yet other threads.
        self._lock = make_lock("Scheduler._lock")
        self._dq: "deque[Request]" = deque()    # guarded-by: _lock

    def push(self, req: Request) -> None:
        with self._lock:
            if len(self._dq) >= self.max_queue:
                raise QueueFull(
                    f"admission queue full ({self.max_queue}); "
                    "retry after step()")
            self._dq.append(req)

    def push_front(self, req: Request) -> None:
        """Requeue at the head (admission deferred on resource shortage);
        deliberately exempt from the max_queue bound — the request was
        already admitted to the queue once."""
        with self._lock:
            self._dq.appendleft(req)

    def pop(self) -> Request:
        with self._lock:
            return self._dq.popleft()

    def remove(self, req: Request) -> bool:
        """Withdraw a queued request (cluster preemption / pull-back).
        Returns False if the request was not in the queue."""
        with self._lock:
            try:
                self._dq.remove(req)
                return True
            except ValueError:
                return False

    def depth(self) -> int:
        with self._lock:
            return len(self._dq)

    def empty(self) -> bool:
        with self._lock:
            return not self._dq

    def bucket_for(self, length: int) -> int:
        """Bucketed prefill length, clamped to the decode-state capacity.

        The clamp lives here (not at call sites) so *every* caller gets
        buckets that cannot ring-wrap the prefill: a bucket larger than
        capacity would silently drop the head of the prompt's cache.
        """
        b = length
        if not self.exact:
            for cand in self.buckets:
                if cand >= length:
                    b = cand
                    break
        return max(min(b, self.capacity), length, 1)
