"""Bookmark checkpoint coordination — crcp/bkmrk analog (namesake:
``zhpe_ompi_tpu/ft/crcp.py``; the port's own copy).

The reference's ``ompi/mca/crcp/bkmrk`` counts messages per peer pair and
exchanges the counts ("bookmarks") when a checkpoint is requested: if
rank i has sent more to rank j than j has received, the channel holds
in-flight data that must be drained before the snapshot is consistent.

Host-plane redesign: per-pair send/receive counters fed by the same
interposition hook the vprotocol logger uses, and a
:meth:`BookmarkCoordinator.quiescent` check that a checkpoint call can
gate on — making :mod:`zhpe_ompi_tpu_torch.runtime.checkpoint`'s "checkpoint at
a quiescent point" contract verifiable per channel instead of assumed.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from ..core import errors
from ..pt2pt.matching import ANY_SOURCE, ANY_TAG
from ..pt2pt.universe import LocalUniverse, RankContext


class BookmarkedContext:
    """RankContext proxy counting per-peer traffic."""

    def __init__(self, ctx: RankContext, coord: "BookmarkCoordinator"):
        self._ctx = ctx
        self._coord = coord
        self.rank = ctx.rank
        self.size = ctx.size

    def send(self, obj: Any, dest: int, tag: int = 0, cid: int = 0) -> None:
        self._ctx.send(obj, dest, tag, cid)
        self._coord._count_send(self.rank, dest)

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             cid: int = 0) -> Any:
        value, status = self._ctx.recv(source, tag, cid, return_status=True)
        self._coord._count_recv(status.source, self.rank)
        return value

    def sendrecv(self, obj: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG, cid: int = 0):
        rreq = self._ctx.irecv(source, recvtag, cid)
        sreq = self._ctx.isend(obj, dest, sendtag, cid)
        self._coord._count_send(self.rank, dest)
        value = rreq.wait()
        # deferred wire engine: the send completes (and the caller's
        # buffer is reusable) only at request completion, not at isend
        sreq.wait()
        self._coord._count_recv(rreq.status.source, self.rank)
        return value

    def barrier(self) -> None:
        self._ctx.barrier()


class BookmarkCoordinator:
    """Per-pair traffic bookmarks for a universe."""

    def __init__(self, uni: LocalUniverse):
        self._uni = uni
        n = uni.size
        self._sent = np.zeros((n, n), dtype=np.int64)
        self._recvd = np.zeros((n, n), dtype=np.int64)
        self._lock = threading.Lock()

    def wrap(self, ctx: RankContext) -> BookmarkedContext:
        return BookmarkedContext(ctx, self)

    def _count_send(self, src: int, dst: int) -> None:
        with self._lock:
            self._sent[src, dst] += 1

    def _count_recv(self, src: int, dst: int) -> None:
        with self._lock:
            self._recvd[src, dst] += 1

    def bookmarks(self) -> tuple[np.ndarray, np.ndarray]:
        """(sent, received) matrices — entry [i, j] counts i→j messages."""
        with self._lock:
            return self._sent.copy(), self._recvd.copy()

    def in_flight(self) -> np.ndarray:
        """Per-channel outstanding message counts (sent − received).
        FT-aware: channels touching a failed rank are exempt (zeroed) —
        a dead endpoint can never drain them, and the rollback owns
        whatever was in flight there."""
        sent, recvd = self.bookmarks()
        fl = sent - recvd
        state = getattr(self._uni, "ft_state", None)
        if state is not None:
            dead = sorted(state.failed())
            if dead:
                fl[dead, :] = 0
                fl[:, dead] = 0
        return fl

    def quiescent(self) -> bool:
        """True when every channel is drained — the bkmrk go/no-go
        decision for a consistent checkpoint."""
        return bool(np.all(self.in_flight() == 0))

    def require_quiescent(self) -> None:
        fl = self.in_flight()
        if np.any(fl != 0):
            pairs = [
                f"{i}->{j}:{int(fl[i, j])}"
                for i, j in zip(*np.nonzero(fl))
            ]
            raise errors.InternalError(
                "checkpoint requested on non-quiescent channels: "
                + ", ".join(pairs)
            )


class DistributedBookmarks:
    """Per-process bookmark counters with a collective quiescence check —
    the wire-plane form of the protocol (round-3 unweld): each rank keeps
    only its OWN row (`sent[j]`, `recvd[j]`), and :meth:`exchange` allgathers
    the rows at checkpoint time — exactly the reference's bkmrk handshake
    (``crcp_bkmrk_pml.c`` exchanges bookmarks between peers when a
    checkpoint is requested, because no shared matrix can exist across
    processes)."""

    def __init__(self, ctx):
        self._ctx = ctx
        n = ctx.size
        self.sent = np.zeros(n, dtype=np.int64)    # my sends, by dest
        self.recvd = np.zeros(n, dtype=np.int64)   # my receives, by source
        self._lock = threading.Lock()

    def wrap(self, ctx=None) -> "BookmarkedContext":
        """Proxy whose counters feed this rank's local rows."""
        return BookmarkedContext(ctx or self._ctx, self)

    # BookmarkedContext hooks (same interface as BookmarkCoordinator)
    def _count_send(self, src: int, dst: int) -> None:
        with self._lock:
            self.sent[dst] += 1

    def _count_recv(self, src: int, dst: int) -> None:
        with self._lock:
            self.recvd[src] += 1

    def exchange(self) -> tuple[np.ndarray, np.ndarray]:
        """Collective: gather every rank's rows into the full (sent,
        received) matrices — entry [i, j] counts i→j messages.

        FT-aware: with failed peers the full-membership allgather would
        wedge on the corpse, so on an ft endpoint the rows ALWAYS travel
        over a consensus-shrunk survivor endpoint (every survivor calls
        exchange collectively at checkpoint time, so the internal shrink
        is collective too).  Always: branching on LOCAL failure
        knowledge would let a survivor that has not yet seen an
        in-flight notice post the full-membership allgather while its
        peers run the consensus — divergent collective paths that
        deadlock.  The consensus round is the price of uniformity; with
        no failures it degenerates to a full-membership agreement and
        the "shrunk" endpoint IS the full job.  The dead ranks' rows
        stay zero; :meth:`in_flight` exempts their channels entirely —
        acked-failed peers' rows are the rollback's business, not
        quiescence's."""
        with self._lock:
            mine = (self.sent.tolist(), self.recvd.tolist())
        n = self._ctx.size
        state = getattr(self._ctx, "ft_state", None)
        if state is None:
            rows = self._ctx.allgather(mine)
            sent = np.array([r[0] for r in rows], dtype=np.int64)
            recvd = np.array([r[1] for r in rows], dtype=np.int64)
            return sent, recvd
        sh = self._ctx.shrink()
        rows = sh.allgather(mine)
        sent = np.zeros((n, n), dtype=np.int64)
        recvd = np.zeros((n, n), dtype=np.int64)
        for dense, row in enumerate(rows):
            parent = sh.group.ranks[dense]
            sent[parent] = row[0]
            recvd[parent] = row[1]
        return sent, recvd

    def in_flight(self) -> np.ndarray:
        """Collective: per-channel outstanding counts (sent[i,j] −
        recvd[j,i]).  Channels touching a failed rank are exempt
        (zeroed): no drain can ever clear them."""
        sent, recvd = self.exchange()
        fl = sent - recvd.T
        state = getattr(self._ctx, "ft_state", None)
        if state is not None:
            dead = sorted(state.failed())
            if dead:
                fl[dead, :] = 0
                fl[:, dead] = 0
        return fl

    def quiescent(self) -> bool:
        """Collective go/no-go: every channel drained on every rank."""
        return bool(np.all(self.in_flight() == 0))

    def require_quiescent(self) -> None:
        fl = self.in_flight()
        if np.any(fl != 0):
            pairs = [
                f"{i}->{j}:{int(fl[i, j])}"
                for i, j in zip(*np.nonzero(fl))
            ]
            raise errors.InternalError(
                "checkpoint requested on non-quiescent channels: "
                + ", ".join(pairs)
            )
