"""Background sidecar executor — paper G2 as infrastructure.

The port's copy of the reference's ``core/executor.py``.  Runs
latency-insensitive work (result records, engine stats, cold-tier page
staging) on host threads so the device step loop never blocks.  Properties
the paper's doctrine requires:

  * **Non-blocking submit** with device->host staging inside the worker:
    the caller hands over CUDA tensors it will not write again (the spill
    path's fresh page copies, enqueued on the current stream) and returns
    at once; the worker copies each into pinned host memory with
    ``non_blocking=True``, records a CUDA event after the copies and waits
    on that event on its own thread, then calls the task with the host
    tensors.  Nothing synchronizes the caller's thread.
  * **Bounded queue + backpressure policy** — an overloaded sidecar must not
    grow unbounded (the cost model's G2-overload case); policies: "block"
    (checkpoints — correctness), "drop_oldest" (metrics — lossy ok).
  * **Failure isolation** — a sidecar task failure (e.g. a flaky replication
    peer) is recorded and retried; it never propagates into the step loop.
    This is the fault-tolerance contract: background-plane failures are
    soft-degradations, not training failures.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.runtime.locks import make_condition, make_lock


def _stage_to_host(args: tuple) -> tuple:
    """Worker half of the staging contract: every CUDA tensor in ``args``
    becomes a pinned host copy, complete when this returns; other arguments
    pass through unchanged.  The copies go to this thread's current stream
    of the tensors' device, the default stream the engine's programs run
    on, so they follow the work that produced the tensors; one event after
    the last copy is waited on here."""
    out = []
    device = None
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            host.copy_(a, non_blocking=True)
            device, a = a.device, host
        out.append(a)
    if device is not None:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    return tuple(out)


@dataclasses.dataclass
class TaskRecord:
    name: str
    submitted_at: float
    started_at: float = 0.0
    finished_at: float = 0.0
    error: Optional[str] = None
    retries: int = 0

    @property
    def wait_s(self) -> float:
        return (self.started_at or time.time()) - self.submitted_at

    @property
    def run_s(self) -> float:
        return max(0.0, self.finished_at - self.started_at)


class _Task:
    __slots__ = ("name", "fn", "args", "record", "done", "result", "max_retries")

    def __init__(self, name, fn, args, max_retries):
        self.name = name
        self.fn = fn
        self.args = args
        self.record = TaskRecord(name, time.time())
        self.done = threading.Event()
        self.result = None
        self.max_retries = max_retries


class BackgroundExecutor:
    """Thread-pool sidecar with bounded queue and failure isolation."""

    def __init__(self, num_threads: int = 2, max_inflight: int = 4,
                 backpressure: str = "block", max_retries: int = 2):
        assert backpressure in ("block", "drop_oldest", "reject")
        self.backpressure = backpressure
        self.max_retries = max_retries
        self._q: "queue.Queue[_Task]" = queue.Queue(maxsize=max_inflight)
        # _lock guards history/drop accounting; _cv guards in-flight counts.
        # They are never nested — keep it that way, or the lock-order
        # sanitizer will record an edge between them.
        self._lock = make_lock("BackgroundExecutor._lock")
        self._history: List[TaskRecord] = []    # guarded-by: _lock
        self._stop = threading.Event()
        self._dropped = 0                       # guarded-by: _lock
        # In-flight accounting for drain(): counts accepted-but-unfinished
        # tasks under a condition variable (queue.Queue.unfinished_tasks is
        # undocumented, and join() has no timeout).
        self._cv = make_condition("BackgroundExecutor._cv")
        self._inflight = 0                      # guarded-by: _cv
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"sidecar-{i}")
            for i in range(num_threads)]
        for t in self._threads:
            t.start()

    # -- submission -----------------------------------------------------------
    def submit(self, name: str, fn: Callable, *args: Any) -> _Task:
        """Non-blocking (subject to backpressure policy).  ``args`` may be
        CUDA tensors — host staging happens on the worker thread."""
        task = _Task(name, fn, args, self.max_retries)
        with self._cv:
            rejected = self._stop.is_set()
            if not rejected:
                self._inflight += 1   # count before enqueue: no drain races
        if rejected:
            # After shutdown no worker will ever run this; fail it out
            # immediately so callers waiting on task.done cannot hang.
            task.record.error = "rejected: executor shut down"
            task.record.finished_at = time.time()
            task.done.set()
            with self._lock:
                self._dropped += 1
                self._history.append(task.record)
            return task
        while True:
            try:
                self._q.put_nowait(task)
                return task
            except queue.Full:
                if self.backpressure == "block":
                    self._q.put(task)
                    return task
                if self.backpressure == "reject":
                    task.record.error = "rejected: queue full"
                    task.done.set()
                    with self._lock:
                        self._dropped += 1
                        self._history.append(task.record)
                    self._finish_one()
                    return task
                # drop_oldest
                try:
                    old = self._q.get_nowait()
                    old.record.error = "dropped: backpressure"
                    old.done.set()
                    with self._lock:
                        self._dropped += 1
                        self._history.append(old.record)
                    self._finish_one()
                except queue.Empty:
                    pass

    def _finish_one(self) -> None:
        with self._cv:
            self._inflight -= 1
            self._cv.notify_all()

    def _worker(self):
        while not self._stop.is_set():
            try:
                task = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            task.record.started_at = time.time()
            host_args = ()
            try:
                host_args = _stage_to_host(task.args)
            except Exception as e:  # staging failure
                task.record.error = f"staging: {e}"
            if task.record.error is None:
                for attempt in range(task.max_retries + 1):
                    try:
                        task.result = task.fn(*host_args)
                        task.record.error = None
                        break
                    except Exception as e:
                        task.record.error = f"{type(e).__name__}: {e}"
                        task.record.retries = attempt
            task.record.finished_at = time.time()
            task.done.set()
            with self._lock:
                self._history.append(task.record)
            self._finish_one()        # after history: drain()==True implies
            self._q.task_done()       # records are visible

    # -- introspection / lifecycle ----------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Wait (with timeout) until every accepted task has finished —
        the checkpoint barrier at shutdown.  ``queue.join()`` semantics, but
        interruptible: returns False if work is still in flight at timeout."""
        with self._cv:
            return self._cv.wait_for(lambda: self._inflight == 0, timeout)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            hist = list(self._history)
            dropped = self._dropped
        ok = [r for r in hist if r.error is None]
        failed = [r for r in hist if r.error is not None]
        return {
            "completed": len(ok),
            "failed": len(failed),
            "dropped": dropped,
            "mean_wait_s": sum(r.wait_s for r in ok) / len(ok) if ok else 0.0,
            "mean_run_s": sum(r.run_s for r in ok) / len(ok) if ok else 0.0,
            "errors": [r.error for r in failed][:8],
        }

    def shutdown(self, drain: bool = True):
        """Stop the workers.  Idempotent: a second call is a no-op sweep.

        With ``drain=False`` any queued-but-unstarted task is failed out
        (error recorded, ``done`` set, counted in ``_inflight``'s release)
        so a later ``drain()`` or ``task.done.wait()`` cannot hang on work
        no worker will ever run."""
        if drain:
            self.drain()
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        # Workers have exited (or timed out mid-task); cancel what never
        # started so every accepted task still reaches a terminal state.
        while True:
            try:
                task = self._q.get_nowait()
            except queue.Empty:
                break
            task.record.error = "cancelled: executor shut down"
            task.record.finished_at = time.time()
            task.done.set()
            with self._lock:
                self._dropped += 1
                self._history.append(task.record)
            self._finish_one()
