"""lockdep — the runtime lock-order witness (zlint ZL002's dynamic twin)
(namesake: ``zhpe_ompi_tpu/utils/lockdep.py``; the port's own copy).

The AST rule proves what it can SEE (``with`` nesting); interprocedural
orders — a request completed under ``ch.lock`` taking ``Request._lock``,
a failure listener walking ``_rndv_lock`` from under the state lock —
only show up at runtime.  This module is the lockdep/TSan idiom applied
to this codebase's own locks: an opt-in instrumented ``Lock``/``RLock``
that records the per-thread acquisition-order graph while the test
suite runs, detects inversion cycles AT ACQUIRE TIME, and feeds the
conftest session gate (zero cycles across the full tier-1 run).

Semantics (classic lockdep):

- Locks are witnessed by ROLE, not instance: every ``TcpProc`` names
  its rendezvous lock ``tcp.TcpProc._rndv_lock`` — an order proven on
  one proc's locks indicts the same nesting on every proc's.
- Holding A while acquiring B adds the edge A→B; an edge that closes a
  cycle in the global graph is an inversion — recorded with both
  nestings' stack summaries, NEVER raised into the victim thread (the
  suite must finish; the session gate does the failing).
- Same-role nesting (two Requests' ``_lock`` held together) is skipped:
  ordering WITHIN a role needs per-instance identity, which is out of
  scope — exactly like the reference lockdep's lock-class model.

Zero overhead when off: ``lock()``/``rlock()`` return the RAW
``threading`` primitive unless the witness is enabled (``ZMPI_LOCKDEP=1``
in the environment, or :func:`enable` — the conftest turns it on for
the suite; users and benchmarks run plain locks).
"""

from __future__ import annotations

import os
import threading

_ENV = "ZMPI_LOCKDEP"

#: module state: enabled flag resolved once at import from the env (the
#: conftest sets it before the transports import); tests flip it with
#: enable()/disable() around their own lock constructions
_enabled = os.environ.get(_ENV, "0").strip().lower() not in (
    "", "0", "false", "no", "off")


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


class LockGraph:
    """One acquisition-order graph: edges, first-witness sites, cycles.

    The default process-global graph backs every witnessed lock the
    transports create; tests seeding deliberate inversions use a
    PRIVATE graph so the session gate stays meaningful."""

    def __init__(self) -> None:
        self._edges: set[tuple[str, str]] = set()
        self._succ: dict[str, set[str]] = {}
        self._cycles: list[str] = []
        self._mu = threading.Lock()
        self._tls = threading.local()

    # -- per-thread held stack ------------------------------------------

    def _stack(self) -> list[str]:
        try:
            return self._tls.stack
        except AttributeError:
            stack = self._tls.stack = []
            return stack

    # -- recording -------------------------------------------------------

    def acquired(self, name: str) -> None:
        """Called AFTER a witnessed lock is taken: add held→name edges,
        checking each NEW edge for a cycle, then push."""
        stack = self._stack()
        for held in stack:
            if held == name:
                continue  # same-role nesting: out of the class model
            if (held, name) in self._edges:
                continue  # warm path: known edge, no lock, no walk
            self._add_edge(held, name)
        stack.append(name)

    def released(self, name: str) -> None:
        stack = self._stack()
        # remove the LAST occurrence: out-of-order releases (rare but
        # legal) must not strip a different hold of the same role
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def _add_edge(self, a: str, b: str) -> None:
        with self._mu:
            if (a, b) in self._edges:
                return
            # does b already reach a?  then a→b closes an inversion
            path = self._find_path(b, a)
            self._edges.add((a, b))
            self._succ.setdefault(a, set()).add(b)
            if path is not None:
                cycle = [a, b] + path[1:]
                self._cycles.append(
                    " -> ".join(cycle)
                    + f"  (new edge {a} -> {b} closes the cycle; "
                    f"thread {threading.current_thread().name} held "
                    f"{a} while acquiring {b})"
                )

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        """DFS src→dst over recorded edges; returns the node path."""
        seen = {src}
        stack: list[tuple[str, list[str]]] = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._succ.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- inspection ------------------------------------------------------

    def cycles(self) -> list[str]:
        with self._mu:
            return list(self._cycles)

    def edges(self) -> set[tuple[str, str]]:
        with self._mu:
            return set(self._edges)

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._succ.clear()
            self._cycles.clear()


#: the process-global graph every transport lock reports into
_default_graph = LockGraph()


def cycles() -> list[str]:
    """Inversion cycles the default graph witnessed (the session gate)."""
    return _default_graph.cycles()


def edges() -> set[tuple[str, str]]:
    return _default_graph.edges()


def reset() -> None:
    _default_graph.reset()


class WitnessLock:
    """An instrumented ``threading.Lock`` reporting into a graph."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str, graph: LockGraph | None = None):
        self.name = name
        self._graph = graph if graph is not None else _default_graph
        self._inner = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._graph.acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._graph.released(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<WitnessLock {self.name} {self._inner!r}>"


class WitnessRLock(WitnessLock):
    """Reentrant variant: re-acquisitions by the owning thread neither
    add edges nor double-push the role (one stack entry per outermost
    hold, like the reference lockdep's recursion depth)."""

    _factory = staticmethod(threading.RLock)

    def __init__(self, name: str, graph: LockGraph | None = None):
        super().__init__(name, graph)
        self._depth = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            d = getattr(self._depth, "n", 0)
            self._depth.n = d + 1
            if d == 0:
                self._graph.acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        d = getattr(self._depth, "n", 1) - 1
        self._depth.n = d
        if d == 0:
            self._graph.released(self.name)

    def locked(self) -> bool:
        """``threading.RLock`` grows ``.locked()`` only on 3.14+ —
        probe instead, so the wrapper's surface does not depend on the
        witness being off.  Owned-by-us is read from the depth; a free
        lock is detected by a transient non-blocking acquire on the
        RAW inner lock (never recorded into the graph)."""
        if getattr(self._depth, "n", 0) > 0:
            return True
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True


def lock(name: str, graph: LockGraph | None = None):
    """A ``threading.Lock`` — witnessed under ``name`` when the
    witness is enabled, the RAW primitive (zero overhead) when not."""
    if not _enabled:
        return threading.Lock()
    return WitnessLock(name, graph)


def rlock(name: str, graph: LockGraph | None = None):
    """``threading.RLock``, same contract as :func:`lock`."""
    if not _enabled:
        return threading.RLock()
    return WitnessRLock(name, graph)
