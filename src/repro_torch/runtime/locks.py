"""Lock-order sanitizer: named lock domains + a global acquisition graph.

The port's own copy of the reference package's ``runtime/locks.py`` (it is
framework-free, and the port shares no module with the reference).

The serve plane is a real concurrent system — engine step-loop threads,
cluster drivers, sidecar workers — with several lock *domains* (every
``ContinuousEngine._lock`` is one domain, regardless of how many engine
instances exist).  A deadlock needs a cycle in the domain-level
acquired-while-holding graph, so that graph is the thing to check:

  * **Runtime half (this module)** — ``make_lock``/``make_rlock``/
    ``make_condition`` factories return plain ``threading`` primitives in
    production; with ``REPRO_LOCK_SANITIZER=1`` they return ``OrderedLock``
    wrappers that record, per thread, which domain was acquired while which
    others were held, into the process-global ``LockOrderGraph`` — and raise
    ``LockOrderError`` the moment an edge closes a cycle, *whether or not*
    the schedule actually deadlocked.  The threaded tier-1 tests run with
    the sanitizer on, so deadlock potential fails tests, not production.
  * **Static half** — the reference package's ``analysis.lockorder`` extracts nested
    ``with self._x: ... with self._y:`` pairs from the AST and cross-checks
    the same graph structure without running anything.

Domain names are ``ClassName._attr`` by convention, matching what the static
pass derives from the source, so the two halves report against the same
vocabulary.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple


def sanitizer_enabled() -> bool:
    """Whether lock factories should return sanitizing wrappers.  Read per
    call (not at import), so tests can flip the env var per test."""
    return os.environ.get("REPRO_LOCK_SANITIZER", "") == "1"


class LockOrderError(RuntimeError):
    """An acquisition closed a cycle in the lock-order graph (deadlock
    potential), or two halves of the analyzer disagree about an edge."""


class LockOrderGraph:
    """Domain-level acquired-while-holding graph with cycle detection.

    Edges are ``held -> acquired``.  ``add_edge`` raises ``LockOrderError``
    if the new edge would close a cycle; ``check`` re-verifies the whole
    graph (used by the static pass, which batches edges).  The graph is its
    own lock domain — it is mutated from every sanitized thread — but its
    internal lock is always a leaf (nothing is acquired under it), so it can
    never participate in the cycles it detects."""

    def __init__(self) -> None:
        self._edges: Dict[str, Set[str]] = {}
        # witness: (holder, acquired) -> where the edge was first seen
        self._where: Dict[Tuple[str, str], str] = {}
        self._mu = threading.Lock()

    def edges(self) -> Dict[str, Set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def witness(self, held: str, acquired: str) -> str:
        with self._mu:
            return self._where.get((held, acquired), "?")

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src -> dst over current edges (caller holds _mu)."""
        stack: List[Tuple[str, List[str]]] = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def add_edge(self, held: str, acquired: str, where: str = "runtime"
                 ) -> None:
        """Record ``acquired`` taken while ``held`` is held.  Raises on a
        cycle, leaving the graph unchanged so later checks stay meaningful."""
        if held == acquired:
            raise LockOrderError(
                f"lock domain {held!r} acquired while already held "
                f"(distinct instance) at {where}: same-domain nesting has "
                "no defined order and can deadlock across threads")
        with self._mu:
            if self._path(acquired, held) is not None:
                back = self._path(acquired, held) or [acquired, held]
                wit = " ; ".join(
                    f"{a}->{b} @ {self._where.get((a, b), '?')}"
                    for a, b in zip(back, back[1:]))
                raise LockOrderError(
                    f"lock-order cycle: acquiring {acquired!r} while "
                    f"holding {held!r} at {where}, but the reverse chain "
                    f"already exists: {wit}")
            self._edges.setdefault(held, set()).add(acquired)
            self._where.setdefault((held, acquired), where)

    def check(self) -> None:
        """Verify the accumulated graph is acyclic (defense in depth: every
        ``add_edge`` already refuses cycle-closing edges)."""
        with self._mu:
            edges = {k: set(v) for k, v in self._edges.items()}
        state: Dict[str, int] = {}      # 0=visiting, 1=done

        def visit(node: str, path: List[str]) -> None:
            state[node] = 0
            for nxt in edges.get(node, ()):
                if state.get(nxt) == 0:
                    cyc = path[path.index(nxt):] + [nxt] \
                        if nxt in path else [node, nxt]
                    raise LockOrderError(
                        "lock-order cycle: " + " -> ".join(cyc))
                if nxt not in state:
                    visit(nxt, path + [nxt])
            state[node] = 1

        for node in list(edges):
            if node not in state:
                visit(node, [node])


_GLOBAL_GRAPH = LockOrderGraph()
# Per-thread stack of held (domain, instance-id) pairs, shared by every
# OrderedLock: instance ids distinguish a legal RLock re-entry from two
# *different* instances of one domain nested (which has no defined order).
_HELD = threading.local()


def order_graph() -> LockOrderGraph:
    """The process-global runtime order graph (tests assert on it)."""
    return _GLOBAL_GRAPH


def reset_order_graph() -> LockOrderGraph:
    """Fresh global graph (test isolation); returns the new graph."""
    global _GLOBAL_GRAPH
    _GLOBAL_GRAPH = LockOrderGraph()
    return _GLOBAL_GRAPH


def _held_stack() -> List[Tuple[str, int]]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = []
        _HELD.stack = stack
    return stack


class OrderedLock:
    """Drop-in ``threading.Lock``/``RLock`` wrapper that records domain-level
    acquisition order.  Edges are recorded *before* blocking on the inner
    lock, so a cycle is reported even on schedules that happen not to
    deadlock.  Re-entrant acquisitions (RLock) record nothing — re-taking a
    domain you already hold orders nothing new."""

    def __init__(self, name: str, inner=None, *, reentrant: bool = False,
                 graph: Optional[LockOrderGraph] = None):
        self.name = name
        self._reentrant = reentrant
        self._inner = inner if inner is not None else (
            threading.RLock() if reentrant else threading.Lock())
        self._graph = graph if graph is not None else _GLOBAL_GRAPH

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stack = _held_stack()
        me = (self.name, id(self))
        reentry = self._reentrant and me in stack
        if not reentry and blocking:
            # A non-blocking try-acquire cannot deadlock; only blocking
            # acquisitions order the graph.
            for held in {name for name, _ in stack}:
                self._graph.add_edge(held, self.name, where="runtime")
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            stack.append(me)
        return ok

    def release(self) -> None:
        self._inner.release()
        stack = _held_stack()
        # Remove the innermost occurrence: Condition.wait releases out of
        # LIFO order relative to other locks the thread still holds.
        me = (self.name, id(self))
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == me:
                del stack[i]
                break

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return locked() if locked is not None else False


def make_lock(name: str) -> threading.Lock:
    """A named mutual-exclusion lock; sanitized when REPRO_LOCK_SANITIZER=1.
    ``name`` is the lock's *domain* (``ClassName._attr``): every instance
    created under the same name shares one node in the order graph."""
    if sanitizer_enabled():
        return OrderedLock(name)
    return threading.Lock()


def make_rlock(name: str) -> threading.RLock:
    """A named re-entrant lock (see ``make_lock``)."""
    if sanitizer_enabled():
        return OrderedLock(name, reentrant=True)
    return threading.RLock()


def make_condition(name: str) -> threading.Condition:
    """A condition variable over a named lock.  ``Condition`` drives the
    wrapped lock through acquire/release only, which ``OrderedLock``
    implements — wait() re-acquisition records edges like any other
    acquisition."""
    return threading.Condition(make_lock(name))
