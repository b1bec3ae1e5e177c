"""Tag-matching engine — the receive-side heart of the PML (namesake:
``zhpe_ompi_tpu/pt2pt/matching.py``; the port's own copy).

Re-design of ob1's matching logic (``pml_ob1_recvfrag.c:295-513``): posted
receives are matched against incoming envelopes on (source, tag,
communicator id), with MPI wildcards ANY_SOURCE / ANY_TAG and the standard
ordering guarantee — messages from the same source match posted receives in
arrival order (per-source FIFO via sequence numbers).

The Python engine indexes both queues by **(cid, src) hash bins** (the
reference keeps per-peer queues for the same reason — ob1's
``mca_pml_ob1_comm_proc_t``): an envelope consults only its own bin
plus the per-cid wildcard bin instead of scanning every posted receive
in the process, and a posted receive consults only its source's
unexpected bin (or, for ANY_SOURCE, an arrival-ordered merge across
the cid's bins).  Ordering is preserved exactly — entries carry a
global monotonic stamp: per-source FIFO is bin order, ANY_SOURCE
matches in true cross-source arrival order, and wildcard-vs-specific
posted receives merge by post order.  The scan work is visible:
``match_comparisons`` counts entry inspections and
``match_unexpected_max_depth`` watermarks the unexpected backlog, so a
matching regression shows up as a counter delta, not a mystery
slowdown.

:class:`NativeMatchingEngine` is the same contract with the queue walk in
C++ (``native/zompi_native.cpp``'s ``zompi_match_*``, one posted list and
one unexpected queue, each walked in order): :func:`make_matching_engine`
gives it to every new endpoint, and the Python engine when a switch
(``ZOMPI_NATIVE=0``, the MCA var ``native_kernels``) selects it.  As in the
namesake, the native engine keeps no ``match_comparisons`` tally and no
:meth:`MatchingEngine.debug_rows` snapshot.

Pure host logic with no transport dependency, unit-testable in isolation
exactly like the reference's datatype engine tests (SURVEY.md §4) — the
transport layer feeds :meth:`MatchingEngine.incoming`, the API layer calls
:meth:`MatchingEngine.post_recv`.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

from ..runtime import peruse
from ..runtime import spc
from ..utils import lockdep

ANY_SOURCE = -1
ANY_TAG = -1


@dataclass
class Envelope:
    src: int
    tag: int
    cid: int
    seq: int  # per-(src, cid) sequence number, assigned by the sender


@dataclass
class PostedRecv:
    src: int  # may be ANY_SOURCE
    tag: int  # may be ANY_TAG
    cid: int
    on_match: Callable[[Envelope, Any], None]

    def matches(self, env: Envelope) -> bool:
        if self.cid != env.cid:
            return False
        if self.src != ANY_SOURCE and self.src != env.src:
            return False
        if self.tag != ANY_TAG and self.tag != env.tag:
            return False
        return True


class MatchingEngine:
    """Per-rank matching state: posted-receive bins + unexpected-message
    bins (the two queues of pml_ob1_recvfrag.c:325,426, indexed by
    (cid, src) like ob1's per-peer comm procs).  Entries carry a global
    monotonic stamp so merged scans reproduce the single-queue order
    EXACTLY: per-source FIFO, cross-source arrival order for
    ANY_SOURCE, post order for wildcard-vs-specific posted receives."""

    def __init__(self) -> None:
        self._lock = lockdep.lock("matching.MatchingEngine._lock")
        self._stamp = itertools.count()
        # (cid, src) -> deque[(stamp, PostedRecv)]; src may be
        # ANY_SOURCE (the per-cid wildcard bin)
        self._posted_bins: dict[tuple[int, int], deque] = {}
        # cid -> src -> deque[(stamp, Envelope, payload)]
        self._unexp_bins: dict[int, dict[int, deque]] = {}
        self._posted_n = 0
        self._unexp_n = 0

    # -- bin walks (lock held) -------------------------------------------

    def _drop_unexp(self, cid: int, src: int, i: int) -> None:
        bins = self._unexp_bins[cid]
        q = bins[src]
        del q[i]
        self._unexp_n -= 1
        if not q:
            del bins[src]
            if not bins:
                del self._unexp_bins[cid]

    def _take_unexpected(self, probe: PostedRecv, remove: bool):
        """Earliest-ARRIVED unexpected message matching ``probe``:
        ``(env, payload, comparisons)`` or ``(None, None,
        comparisons)``.  A specific source scans one bin in arrival
        order; ANY_SOURCE heap-merges the cid's bins by arrival stamp
        (a tag-mismatched head only advances its own bin, so no bin's
        internal order is disturbed)."""
        bins = self._unexp_bins.get(probe.cid)
        comparisons = 0
        if not bins:
            return None, None, 0
        if probe.src != ANY_SOURCE:
            q = bins.get(probe.src)
            if not q:
                return None, None, 0
            for i, (_, env, payload) in enumerate(q):
                comparisons += 1
                if probe.matches(env):
                    if remove:
                        self._drop_unexp(probe.cid, probe.src, i)
                    return env, payload, comparisons
            return None, None, comparisons
        heap = [(q[0][0], src, 0) for src, q in bins.items() if q]
        heapq.heapify(heap)
        while heap:
            _, src, i = heapq.heappop(heap)
            q = bins[src]
            _, env, payload = q[i]
            comparisons += 1
            if probe.matches(env):
                if remove:
                    self._drop_unexp(probe.cid, src, i)
                return env, payload, comparisons
            if i + 1 < len(q):
                heapq.heappush(heap, (q[i + 1][0], src, i + 1))
        return None, None, comparisons

    def _take_posted(self, env: Envelope):
        """Earliest-POSTED receive matching ``env``: the specific
        (cid, src) bin merged with the cid's ANY_SOURCE wildcard bin
        by post stamp — ``(posted, comparisons)`` with the entry
        removed, or ``(None, comparisons)``."""
        b_spec = self._posted_bins.get((env.cid, env.src))
        b_wild = self._posted_bins.get((env.cid, ANY_SOURCE))
        comparisons = 0
        i = j = 0
        while True:
            cand_s = b_spec[i] if b_spec and i < len(b_spec) else None
            cand_w = b_wild[j] if b_wild and j < len(b_wild) else None
            if cand_s is None and cand_w is None:
                return None, comparisons
            if cand_w is None or (cand_s is not None
                                  and cand_s[0] < cand_w[0]):
                posted = cand_s[1]
                comparisons += 1
                if posted.matches(env):
                    del b_spec[i]
                    self._posted_n -= 1
                    if not b_spec:
                        del self._posted_bins[(env.cid, env.src)]
                    return posted, comparisons
                i += 1
            else:
                posted = cand_w[1]
                comparisons += 1
                if posted.matches(env):
                    del b_wild[j]
                    self._posted_n -= 1
                    if not b_wild:
                        del self._posted_bins[(env.cid, ANY_SOURCE)]
                    return posted, comparisons
                j += 1

    # -- public surface ---------------------------------------------------

    def post_recv(self, src: int, tag: int, cid: int,
                  on_match: Callable[[Envelope, Any], None]) -> None:
        """Post a receive; matches an unexpected message immediately if one
        is waiting (ordered: earliest matching unexpected wins)."""
        if peruse.active:
            peruse.fire(peruse.REQ_ACTIVATE, src=src, tag=tag, cid=cid)
        posted = PostedRecv(src, tag, cid, on_match)
        with self._lock:
            env, payload, comparisons = self._take_unexpected(
                posted, remove=True)
            if env is None:
                self._posted_bins.setdefault((cid, src), deque()).append(
                    (next(self._stamp), posted))
                self._posted_n += 1
        if comparisons:
            spc.record("match_comparisons", comparisons)
        # events fire outside the lock (subscribers may re-enter the engine)
        if env is None:
            if peruse.active:
                peruse.fire(peruse.REQ_INSERT_IN_POSTED_Q,
                            src=src, tag=tag, cid=cid)
            return
        if peruse.active:
            peruse.fire(peruse.MSG_REMOVE_FROM_UNEX_Q,
                        src=env.src, tag=env.tag, cid=env.cid, seq=env.seq)
            peruse.fire(peruse.REQ_MATCH_UNEX,
                        src=env.src, tag=env.tag, cid=env.cid, seq=env.seq)
        on_match(env, payload)

    def incoming(self, env: Envelope, payload: Any) -> None:
        """Deliver an arriving message: match the earliest posted receive or
        park it on the unexpected queue."""
        if peruse.active:
            peruse.fire(peruse.MSG_ARRIVED,
                        src=env.src, tag=env.tag, cid=env.cid, seq=env.seq)
        depth = 0
        with self._lock:
            posted, comparisons = self._take_posted(env)
            if posted is None:
                self._unexp_bins.setdefault(env.cid, {}).setdefault(
                    env.src, deque()).append(
                        (next(self._stamp), env, payload))
                self._unexp_n += 1
                depth = self._unexp_n
        if comparisons:
            spc.record("match_comparisons", comparisons)
        if posted is None:
            spc.record("match_unexpected_max_depth", depth)
            if peruse.active:
                peruse.fire(peruse.MSG_INSERT_IN_UNEX_Q, src=env.src,
                            tag=env.tag, cid=env.cid, seq=env.seq)
            return
        if peruse.active:
            peruse.fire(peruse.REQ_REMOVE_FROM_POSTED_Q, src=env.src,
                        tag=env.tag, cid=env.cid, seq=env.seq)
            peruse.fire(peruse.MSG_MATCH_POSTED_REQ, src=env.src,
                        tag=env.tag, cid=env.cid, seq=env.seq)
        posted.on_match(env, payload)

    def probe(self, src: int, tag: int, cid: int) -> Envelope | None:
        """MPI_Iprobe: peek the earliest matching unexpected envelope."""
        probe_req = PostedRecv(src, tag, cid, lambda e, p: None)
        with self._lock:
            env, _payload, comparisons = self._take_unexpected(
                probe_req, remove=False)
        if comparisons:
            spc.record("match_comparisons", comparisons)
        return env

    def extract(self, src: int, tag: int, cid: int
                ) -> tuple[Envelope, Any] | None:
        """MPI_Improbe's dequeue: remove and return the earliest matching
        unexpected message — once extracted it can only be received
        through the returned handle (MPI_Mrecv semantics)."""
        probe_req = PostedRecv(src, tag, cid, lambda e, p: None)
        with self._lock:
            env, payload, comparisons = self._take_unexpected(
                probe_req, remove=True)
        if comparisons:
            spc.record("match_comparisons", comparisons)
        if env is None:
            return None
        return env, payload

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "posted": self._posted_n,
                "unexpected": self._unexp_n,
            }

    def stats_excluding(self, srcs, cids=()) -> dict[str, int]:
        """Queue depths NOT attributable to `srcs` or `cids`: posted
        receives named on one of the sources (abandoned by
        typed-failure delivery) or posted/parked on one of the cids
        (a revoked channel never delivers again), and unexpected
        messages sent from one of the sources or carried on one of the
        cids.  The ft-aware quiescence view — a dead peer's or revoked
        channel's rows can never drain, so a recovery-time checkpoint
        must not wait on them.  ANY_SOURCE posted receives are
        unattributable by source and counted unless their cid is
        exempt."""
        excl = {int(s) for s in srcs}
        excl_cids = {int(c) for c in cids}
        with self._lock:
            return {
                "posted": sum(
                    len(q)
                    for (cid, src), q in self._posted_bins.items()
                    if src not in excl and cid not in excl_cids
                ),
                "unexpected": sum(
                    len(q)
                    for cid, bins in self._unexp_bins.items()
                    if cid not in excl_cids
                    for src, q in bins.items()
                    if src not in excl
                ),
            }

    def debug_rows(self) -> tuple[list, list]:
        """Forensic snapshot for recv-timeout diagnostics:
        ``(posted [(src, tag, cid)...], unexpected [(src, tag, cid,
        seq)...])`` in no particular order."""
        with self._lock:
            posted = [
                (p.src, p.tag, p.cid)
                for q in self._posted_bins.values()
                for _, p in q
            ]
            unexpected = [
                (e.src, e.tag, e.cid, e.seq)
                for bins in self._unexp_bins.values()
                for q in bins.values()
                for _, e, _p in q
            ]
        return posted, unexpected


class NativeMatchingEngine:
    """Same contract as :class:`MatchingEngine`, with the queue walk in C++
    (the native analog of ob1's match loops).  Payloads and callbacks stay
    in Python, referenced by opaque keys handed through the C ABI."""

    def __init__(self) -> None:
        import ctypes

        from .. import native

        lib = native.load()
        if lib is None:
            raise RuntimeError(
                f"native kernels switched off ({native.disabled_by})")
        self._ctypes = ctypes
        self._lib = lib
        self._h = lib.zompi_match_create()
        self._lock = lockdep.lock("matching.NativeMatchingEngine._lock")
        self._next_key = 1
        self._payloads: dict[int, Any] = {}
        self._callbacks: dict[int, Callable[[Envelope, Any], None]] = {}

    def __del__(self):  # pragma: no cover - interpreter teardown timing
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.zompi_match_destroy(h)
            self._h = None

    def post_recv(self, src: int, tag: int, cid: int,
                  on_match: Callable[[Envelope, Any], None]) -> None:
        ct = self._ctypes
        env = (ct.c_int64 * 4)()
        pkey = ct.c_uint64()
        if peruse.active:
            peruse.fire(peruse.REQ_ACTIVATE, src=src, tag=tag, cid=cid)
        with self._lock:
            key = self._next_key
            self._next_key += 1
            self._callbacks[key] = on_match
            hit = self._lib.zompi_match_post(
                self._h, src, tag, cid, key, env, ct.byref(pkey))
            if hit:
                del self._callbacks[key]
                payload = self._payloads.pop(pkey.value)
        # events fire outside the lock (subscribers may re-enter the engine)
        if hit:
            matched = Envelope(env[0], env[1], env[2], env[3])
            if peruse.active:
                peruse.fire(peruse.MSG_REMOVE_FROM_UNEX_Q, src=matched.src,
                            tag=matched.tag, cid=matched.cid, seq=matched.seq)
                peruse.fire(peruse.REQ_MATCH_UNEX, src=matched.src,
                            tag=matched.tag, cid=matched.cid, seq=matched.seq)
            on_match(matched, payload)
        elif peruse.active:
            peruse.fire(peruse.REQ_INSERT_IN_POSTED_Q,
                        src=src, tag=tag, cid=cid)

    def incoming(self, env: Envelope, payload: Any) -> None:
        ct = self._ctypes
        rkey = ct.c_uint64()
        if peruse.active:
            peruse.fire(peruse.MSG_ARRIVED,
                        src=env.src, tag=env.tag, cid=env.cid, seq=env.seq)
        depth = 0
        with self._lock:
            key = self._next_key
            self._next_key += 1
            self._payloads[key] = payload
            hit = self._lib.zompi_match_incoming(
                self._h, env.src, env.tag, env.cid, env.seq, key,
                ct.byref(rkey))
            if hit:
                del self._payloads[key]
                cb = self._callbacks.pop(rkey.value)
            else:
                # _payloads holds exactly the unexpected payloads: its
                # size is the backlog the Python engine watermarks
                depth = len(self._payloads)
        if not hit:
            spc.record("match_unexpected_max_depth", depth)
            if peruse.active:
                peruse.fire(peruse.MSG_INSERT_IN_UNEX_Q, src=env.src,
                            tag=env.tag, cid=env.cid, seq=env.seq)
            return
        if peruse.active:
            peruse.fire(peruse.REQ_REMOVE_FROM_POSTED_Q, src=env.src,
                        tag=env.tag, cid=env.cid, seq=env.seq)
            peruse.fire(peruse.MSG_MATCH_POSTED_REQ, src=env.src,
                        tag=env.tag, cid=env.cid, seq=env.seq)
        cb(env, payload)

    def probe(self, src: int, tag: int, cid: int) -> Envelope | None:
        """MPI_Iprobe: peek the earliest matching unexpected envelope."""
        env = (self._ctypes.c_int64 * 4)()
        with self._lock:
            hit = self._lib.zompi_match_probe(self._h, src, tag, cid, env)
        return Envelope(env[0], env[1], env[2], env[3]) if hit else None

    def extract(self, src: int, tag: int, cid: int
                ) -> tuple[Envelope, Any] | None:
        """MPI_Improbe's dequeue (see :meth:`MatchingEngine.extract`)."""
        ct = self._ctypes
        env = (ct.c_int64 * 4)()
        pkey = ct.c_uint64()
        with self._lock:
            hit = self._lib.zompi_match_extract(
                self._h, src, tag, cid, env, ct.byref(pkey))
            payload = self._payloads.pop(pkey.value) if hit else None
        if hit:
            return Envelope(env[0], env[1], env[2], env[3]), payload
        return None

    def stats(self) -> dict[str, int]:
        ct = self._ctypes
        p, u = ct.c_int64(), ct.c_int64()
        with self._lock:
            self._lib.zompi_match_stats(self._h, ct.byref(p), ct.byref(u))
        return {"posted": p.value, "unexpected": u.value}

    def stats_excluding(self, srcs, cids=()) -> dict[str, int]:
        """Native twin of :meth:`MatchingEngine.stats_excluding`: the
        queue walk happens in C against the same engine handle."""
        ct = self._ctypes
        excl = sorted(int(s) for s in srcs)
        excl_cids = sorted(int(c) for c in cids)
        arr = (ct.c_int64 * max(1, len(excl)))(*(excl or [0]))
        carr = (ct.c_int64 * max(1, len(excl_cids)))(*(excl_cids or [0]))
        p, u = ct.c_int64(), ct.c_int64()
        with self._lock:
            self._lib.zompi_match_stats_excluding(
                self._h, arr, len(excl), carr, len(excl_cids),
                ct.byref(p), ct.byref(u))
        return {"posted": p.value, "unexpected": u.value}


def make_matching_engine():
    """The matching engine of a new endpoint: the native C++ engine when
    ``native.load()`` gives the library, the Python engine when a switch
    selects it (selection mirrors MCA component fallback).  A failed
    build raises."""
    from .. import native

    if native.available():
        return NativeMatchingEngine()
    return MatchingEngine()
