"""Serve engines: continuous batching and the paged KV-cache engine
(counterpart of the reference's ``serve/engines.py``).

  * **Fast path (device)** — the programs in ``serve.programs``: bucket
    prefill (batch 1), batched decode (always ``max_batch`` wide) and slot
    insertion, run eagerly on the model's device.
  * **Admission plane (host)** — ``serve.scheduler``: between decode steps,
    finished requests are evicted, freed slots recycled, and queued
    requests prefilled solo and spliced into the running batch.
  * **Bookkeeping (sidecar)** — latency records and periodic stats go
    through ``BackgroundExecutor``; the step loop never blocks on them.
  * **Results** — completed generations land in a ``ShardedStore``.

Left for later slices, each rejected with ``NotImplementedError`` naming
its ROADMAP item: speculative decoding, handoff import (disaggregated and
cluster serving) and the fixed-batch baseline.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config.model import ModelConfig
from repro_torch.config.run import ServeConfig
from repro_torch.core.endpoint import ShardedStore
from repro_torch.core.executor import BackgroundExecutor
from repro_torch.models.transformer import (
    ExecPolicy, Transformer, init_decode_state)
from repro_torch.runtime.locks import make_lock, make_rlock
from repro_torch.serve import programs
from repro_torch.serve.backends import make_backend
from repro_torch.serve.sampler import SamplingParams
from repro_torch.serve.scheduler import (
    hit_stop, needs_exact_prefill, normalize_stop, QueueFull, Request,
    Scheduler, SlotTable)


class ContinuousEngine:
    """Continuous-batching engine over a dense per-slot KV cache.

    ``model`` is a ``Transformer``; the engine runs on the device its
    parameters live on (the card, unless the caller built it on the CPU)."""

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 scfg: ServeConfig, policy: ExecPolicy = ExecPolicy(),
                 executor: Optional[BackgroundExecutor] = None,
                 result_endpoints: Optional[Sequence[Any]] = None):
        if scfg.speculative:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP Q4)")
        self.cfg, self.scfg = cfg, scfg
        self.params = model.tree()
        self.device = self.params["embed"].device
        self.policy = policy
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)

        B = scfg.max_batch
        self.slots = SlotTable(B)
        self.scheduler = Scheduler(scfg, exact_buckets=needs_exact_prefill(cfg))
        # Per-slot mirrors live on the device (see programs.decode_program);
        # the host only keeps what its eviction logic reads.
        dev = self.device
        self._mirrors = {
            "tok": torch.zeros(B, dtype=torch.int32, device=dev),
            "pos": torch.zeros(B, dtype=torch.int32, device=dev),
            "temp": torch.zeros(B, dtype=torch.float32, device=dev),
            "top_k": torch.zeros(B, dtype=torch.int32, device=dev),
            "top_p": torch.ones(B, dtype=torch.float32, device=dev),
        }
        self._eos = np.full(B, -1, np.int32)
        self._host_temps = np.zeros(B, np.float32)
        self._build_device_plane()

        # Sidecar plane + sharded result store.
        self._own_executor = executor is None
        self.executor = executor or BackgroundExecutor(
            num_threads=2, max_inflight=8, backpressure="block")
        endpoints = (list(result_endpoints) if result_endpoints is not None
                     else [dict() for _ in range(max(1, scfg.result_shards))])
        self.store = ShardedStore(endpoints)
        self._shard_balance = self.store.balance()
        # One lock covers everything mutated by the engine loop and read from
        # other threads (records, stats_log, step/token counters).
        self._lock = make_lock("ContinuousEngine._lock")
        self.records: List[Dict[str, Any]] = []        # guarded-by: _lock
        self.stats_log: List[Dict[str, Any]] = []      # guarded-by: _lock

        self._rid = itertools.count()
        self._requests: Dict[int, Request] = {}        # guarded-by: _admission
        self._steps = 0                                # guarded-by: _lock
        self._tokens_out = 0                           # guarded-by: _lock
        self._cb_errors = 0                            # guarded-by: _lock
        # Set-once close latch: checked lock-free on the hot step path, set
        # under _admission so no submit() can slip past a closing engine.
        self._closed = threading.Event()
        self._loop_error: Optional[BaseException] = None  # guarded-by: _lock
        # Serializes the step loop against close()/failure teardown (RLock:
        # the step exception path re-enters via _fail_pending).  submit()
        # does not take it — a producer must never stall behind a device
        # step — so queue admission vs. teardown has its own small lock.
        self._lifecycle = make_rlock("ContinuousEngine._lifecycle")
        self._admission = make_lock("ContinuousEngine._admission")

    def _build_device_plane(self) -> None:
        """Dense programs over per-slot caches; ``PagedEngine`` overrides
        this with block-table programs over a shared page pool."""
        cfg, scfg = self.cfg, self.scfg
        self._admit_prog = programs.admit_program(
            cfg, self.policy, scfg.max_seq_len)
        self._decode_prog = programs.decode_program(cfg, self.policy)
        self.states = init_decode_state(cfg, scfg.max_batch,
                                        capacity=scfg.max_seq_len,
                                        device=self.device)

    # -- request lifecycle ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               stop=None,
               on_token: Optional[Callable[[int], None]] = None) -> int:
        """Enqueue a request; returns its rid.  The prompt is normalized
        here, once, to a contiguous int32 host array.  ``on_token``, if
        given, is called with each token id as it is committed (engine loop
        thread); a raising callback is disabled after its first exception."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        prompt = np.ascontiguousarray(prompt)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.scfg.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len ({self.scfg.max_seq_len})")
        req = Request(next(self._rid), prompt, max_new_tokens,
                      sampling or SamplingParams.from_config(self.scfg),
                      stop=normalize_stop(stop), on_token=on_token)
        with self._admission:
            if self._closed.is_set():
                raise RuntimeError("engine is closed; no new submissions")
            self.scheduler.push(req)      # raises QueueFull at capacity
            self._requests[req.rid] = req
        return req.rid

    def _admit(self) -> int:
        """Fill free slots from the queue: solo bucket prefill, sample the
        first token, splice the state into the running batch."""
        admitted = 0
        while self.slots.free_count() and not self.scheduler.empty():
            req = self.scheduler.pop()
            tok0 = self._admit_one(req)
            if tok0 is None:            # resource shortage (paged engine):
                self.scheduler.push_front(req)   # retry after evictions free
                break                            # pages on later steps
            sp = req.sampling
            slot = req.slot
            req.first_token_at = time.time()
            req.output.append(tok0)
            admitted += 1
            self._eos[slot] = sp.eos_id
            self._host_temps[slot] = sp.temperature
            self._deliver(req, len(req.output) - 1)
            if (sp.eos_id >= 0 and tok0 == sp.eos_id) \
                    or req.max_new_tokens <= 1 \
                    or hit_stop(req.output, req.stop):
                self._release_slot(slot)  # finished during admission
                self._finish(req)
        return admitted

    def _admit_one(self, req: Request) -> Optional[int]:
        """Acquire a slot and run the admit program for one request.
        Returns the first sampled token, or None if admission must wait."""
        L = len(req.prompt)
        S = self.scheduler.bucket_for(L)
        toks = np.zeros((1, S), np.int32)
        toks[0, :L] = req.prompt
        positions = np.arange(S, dtype=np.int32)[None, :]
        sp = req.sampling
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "positions": torch.from_numpy(positions).to(self.device),
                 "length": L,
                 "temp": float(sp.temperature),
                 "top_k": int(sp.top_k),
                 "top_p": float(sp.top_p)}
        slot = self.slots.acquire(req)
        tok = self._admit_prog(self.params, self.states, batch, slot,
                               self._gen, self._mirrors)
        return int(tok[0])

    def _deliver(self, req: Request, start: int) -> None:
        """Stream ``req.output[start:]`` to the request's ``on_token``
        callback; a raising callback is disabled, not fatal."""
        cb = req.on_token
        if cb is None:
            return
        try:
            for t in req.output[start:]:
                cb(int(t))
        except Exception:
            req.on_token = None
            with self._lock:
                self._cb_errors += 1

    def _any_stochastic(self) -> bool:
        """Whether some slot samples: decided on the host's copy of the
        temperatures, so the decode step never reads a device flag."""
        return bool((self._host_temps > 0.0).any())

    def _release_slot(self, slot: int) -> None:
        self.slots.release(slot)
        # Zero the freed slot's temperature so an all-greedy batch regains
        # the cheap argmax sampling path.
        if self._host_temps[slot] > 0.0:
            self._host_temps[slot] = 0.0
            self._mirrors["temp"][slot] = 0.0

    def _decode_device(self) -> np.ndarray:
        """Run the decode program; returns the (B,) sampled tokens."""
        toks = self._decode_prog(self.params, self.states, self._gen,
                                 self._mirrors, self._any_stochastic())
        # The step's data dependency: host bookkeeping (outputs, EOS, stop
        # sequences) consumes every slot's token before the next step.
        return toks.cpu().numpy().copy()

    def _decode_once(self) -> bool:
        """One batched decode step over all slots + per-slot evictions."""
        active = self.slots.active()
        if not active:
            return False
        toks = self._decode_device()
        for req in active:
            slot = req.slot
            tok = int(toks[slot])
            req.output.append(tok)
            with self._lock:
                self._tokens_out += 1
            self._deliver(req, len(req.output) - 1)
            if (self._eos[slot] >= 0 and tok == self._eos[slot]) \
                    or len(req.output) >= req.max_new_tokens \
                    or hit_stop(req.output, req.stop):
                self._release_slot(slot)
                self._finish(req)
        self._after_step()
        return True

    def _after_step(self) -> None:
        with self._lock:
            self._steps += 1
            steps = self._steps
        if self.scfg.stats_every and steps % self.scfg.stats_every == 0:
            snap = self.stats()
            self.executor.submit("serve.stats", self._append_stats, snap)

    def _append_stats(self, snap: Dict[str, Any]) -> None:
        with self._lock:
            self.stats_log.append(snap)

    def step(self) -> bool:
        """Admit + one decode step.  Returns False once fully idle.

        An exception out of the decode loop is terminal for every in-flight
        request: it is recorded and every pending request gets a terminal
        error record before re-raising."""
        with self._lifecycle:
            if self._closed.is_set():
                return False
            try:
                admitted = self._admit()
                return self._decode_once() or admitted > 0
            except Exception as e:
                with self._lock:
                    self._loop_error = e
                self._fail_pending(
                    f"decode loop died: {type(e).__name__}: {e}")
                raise

    def run(self) -> None:
        """Drive until queue and slots are empty (the serve loop)."""
        while self.step():
            pass

    def _finish(self, req: Request) -> None:
        done_at = time.time()
        payload = {
            "rid": req.rid,
            "tokens": list(req.output),
            "prompt_len": int(len(req.prompt)),
            "ttft_s": req.first_token_at - req.submitted_at,
            "e2e_s": done_at - req.submitted_at,
        }
        # Submit BEFORE marking the request done: a concurrent
        # result(rid, wait=True) that observes req.done must find the record
        # covered by its drain().
        self.executor.submit(f"serve.record/{req.rid}", self._record, payload)
        req.finished_at = done_at

    def _record(self, payload: Dict[str, Any]) -> None:
        self.store.put(f"req/{payload['rid']}", payload)
        with self._lock:
            self.records.append(payload)

    def _fail_pending(self, reason: str) -> None:
        """Terminate every unfinished request with an error record (on
        close() and on decode-loop death), so a ``result(wait=True)`` waiter
        always finds a terminal record."""
        with self._admission:
            pending = [r for r in self._requests.values() if not r.done]
            for req in pending:
                if req.slot >= 0 and self.slots.get(req.slot) is req:
                    self._release_slot(req.slot)
                done_at = time.time()
                self._record({
                    "rid": req.rid,
                    "tokens": list(req.output),
                    "prompt_len": int(len(req.prompt)),
                    "ttft_s": (req.first_token_at - req.submitted_at
                               if req.first_token_at else 0.0),
                    "e2e_s": done_at - req.submitted_at,
                    "error": reason,
                })
                req.finished_at = done_at
            while not self.scheduler.empty():
                self.scheduler.pop()

    # -- results / introspection ----------------------------------------------
    def result(self, rid: int, wait: bool = True) -> Dict[str, Any]:
        """Fetch a completed generation from the sharded result store."""
        if wait and not self.executor.drain():
            raise TimeoutError(
                f"sidecar drain timed out before req/{rid} was recorded")
        with self._admission:
            req = self._requests.get(rid)
        if req is not None and not req.done:
            with self._lock:
                loop_error = self._loop_error
            if loop_error is not None:
                raise RuntimeError(
                    f"request {rid} cannot complete: the decode loop died"
                ) from loop_error
            raise RuntimeError(
                f"request {rid} is still queued/decoding; drive step()/run() "
                "to completion before fetching its result")
        return self.store.get(f"req/{rid}")

    def request(self, rid: int) -> Request:
        with self._admission:
            return self._requests[rid]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            steps, tokens = self._steps, self._tokens_out
            cb_errors = self._cb_errors
        s = {
            "steps": steps,
            "tokens_out": tokens,
            "active": len(self.slots.active()),
            "queued": self.scheduler.depth(),
            "free_slots": self.slots.free_count(),
            "result_shards": self._shard_balance,
        }
        if cb_errors:
            s["callback_errors"] = cb_errors
        return s

    def cache_bytes(self) -> int:
        """Resident KV-cache bytes (dense per-slot buffers or paged pools)."""
        total = 0

        def visit(tree):
            nonlocal total
            for key, leaf in tree.items():
                if isinstance(leaf, dict):
                    visit(leaf)
                elif key in ("k", "v", "kp", "vp", "ksc", "vsc"):
                    total += leaf.numel() * leaf.element_size()
        visit(self.states)
        return total

    def close(self) -> None:
        """Shut down: fail whatever is still pending with terminal records,
        then drain the sidecar (result records and cold-tier staging
        tasks)."""
        with self._lifecycle:       # wait out any in-flight step first
            if not self._closed.is_set():
                with self._admission:
                    self._closed.set()
                self._fail_pending("engine closed before completion")
        self.executor.drain()
        if self._own_executor:
            self.executor.shutdown(drain=False)

    def generate(self, prompts: List[np.ndarray], max_new_tokens: int
                 ) -> Dict[int, Request]:
        """Submit a list of prompts and drive to completion.  Returns
        {index -> Request}."""
        out: Dict[int, Request] = {}
        for i, p in enumerate(prompts):
            while True:
                try:
                    rid = self.submit(p, max_new_tokens)
                    break
                except QueueFull:
                    self.step()           # make room: drain one decode step
            out[i] = self.request(rid)
        self.run()
        self.executor.drain()
        return out


class PagedEngine(ContinuousEngine):
    """Continuous batching over a decode-state backend picked per arch by
    ``make_backend`` — here ``PagedKVBackend``: a physical page pool per
    attention layer with a host-side block table (resident memory follows
    the live token count) and rolling-hash CoW prefix reuse.  Every decode
    step's attention goes through the paged-attention kernel unless the
    policy says ``use_kernel=False``."""

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 scfg: ServeConfig, policy: ExecPolicy = ExecPolicy(),
                 executor: Optional[BackgroundExecutor] = None,
                 result_endpoints: Optional[Sequence[Any]] = None,
                 handoff_endpoints: Optional[Sequence[Any]] = None):
        if handoff_endpoints is not None:
            raise NotImplementedError(
                "the handoff-import plane (disaggregated and cluster "
                "serving) is not ported yet (ROADMAP Q3)")
        self.backend = make_backend(cfg, scfg)  # validates page geometry
        self.page_size = scfg.page_size
        super().__init__(cfg, model, scfg, policy, executor,
                         result_endpoints)

    def _build_device_plane(self) -> None:
        self.backend.bind(self)
        self.backend.build_device_plane()

    @property
    def pool(self):
        """The backend's cache substrate (``KVBlockPool``)."""
        return self.backend.pool

    @property
    def cold(self):
        """The backend's cold tier (``ColdTier``), or None."""
        return self.backend.cold

    def _admit_one(self, req: Request) -> Optional[int]:
        return self.backend.admit(req)

    def _decode_device(self) -> np.ndarray:
        return self.backend.decode_step()

    def _release_slot(self, slot: int) -> None:
        self.backend.release(self.slots.get(slot), slot)
        super()._release_slot(slot)

    def stats(self) -> Dict[str, Any]:
        s = super().stats()
        s.update(self.backend.stats())
        s["resident_cache_bytes"] = self.cache_bytes()
        return s
