"""Pessimistic message logging — vprotocol/pessimist + pml/v analog (namesake:
``zhpe_ompi_tpu/ft/vprotocol.py``; the port's own copy).

The reference wraps the PML with a logging protocol
(``ompi/mca/vprotocol/pessimist``): every *sent* payload is retained by
the sender (sender-based logging) and every nondeterministic *delivery
event* (which message matched which receive, crucial for MPI_ANY_SOURCE /
MPI_ANY_TAG) is logged synchronously before the application sees it.
After a failure, a restarted process replays its receives from the
partners' payload logs in the exact logged order — no other rank rolls
back (the whole point of the *pessimistic* flavor).

Host-plane redesign: :class:`UniverseLogger` wraps rank contexts with the
same two logs, and :meth:`UniverseLogger.replay_context` manufactures a
stand-in context that serves receives from the logs in recorded order and
swallows already-delivered sends — restart a rank's function against it
and it recomputes its state deterministically while the survivors stay
untouched.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from ..core import errors
from ..pt2pt.matching import ANY_SOURCE, ANY_TAG
from ..pt2pt.requests import Status, _payload_bytes
from ..pt2pt.universe import LocalUniverse, RankContext, _eager_copy


@dataclass
class _RankLog:
    """One rank's logs."""

    # sender-based payload log, send order: (dest, tag, payload)
    sends: list[tuple[int, int, Any]] = field(default_factory=list)
    # receiver event log, delivery order: (source, tag, payload)
    # (the reference logs (source, clock) and fetches the payload from the
    # sender's log at replay; in-process we retain the payload directly —
    # same information, flat layout)
    recvs: list[tuple[int, int, Any]] = field(default_factory=list)


class LoggedContext:
    """RankContext proxy that logs sends and delivery events.

    Only the blocking surface is wrapped (send/recv/sendrecv/barrier) —
    the reference's vprotocol equally forces nonblocking requests through
    a logged completion path (pml_v intercepts request completion)."""

    def __init__(self, ctx: RankContext, log: _RankLog, lock: threading.Lock):
        self._ctx = ctx
        self._log = log
        self._lock = lock
        self.rank = ctx.rank
        self.size = ctx.size

    def send(self, obj: Any, dest: int, tag: int = 0, cid: int = 0) -> None:
        with self._lock:
            self._log.sends.append((dest, tag, _eager_copy(obj)))
        self._ctx.send(obj, dest, tag, cid)

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             cid: int = 0, **kwargs) -> Any:
        # the logger always needs the status (resolved source/tag below);
        # whether the CALLER gets it too is their return_status
        want_status = kwargs.pop("return_status", False)
        value, status = self._ctx.recv(
            source, tag, cid, return_status=True, **kwargs
        )
        # log the RESOLVED source/tag — this is the nondeterminism that
        # must be pinned for ANY_SOURCE/ANY_TAG replay
        with self._lock:
            self._log.recvs.append(
                (status.source, status.tag, _eager_copy(value))
            )
        return (value, status) if want_status else value

    def sendrecv(self, obj: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG, cid: int = 0):
        with self._lock:
            self._log.sends.append((dest, sendtag, _eager_copy(obj)))
        rreq = self._ctx.irecv(source, recvtag, cid)
        sreq = self._ctx.isend(obj, dest, sendtag, cid)
        value = rreq.wait()
        sreq.wait()  # deferred engine: reuse gates on send completion
        with self._lock:
            self._log.recvs.append(
                (rreq.status.source, rreq.status.tag, _eager_copy(value))
            )
        return value

    def barrier(self) -> None:
        self._ctx.barrier()


class ReplayContext:
    """Deterministic stand-in for a restarted rank: receives come from the
    event log in logged order; sends up to the logged count are swallowed
    (their effects were already delivered before the failure)."""

    def __init__(self, rank: int, size: int, log: _RankLog):
        self.rank = rank
        self.size = size
        self._log = log
        self._recv_pos = 0
        self._send_pos = 0

    def send(self, obj: Any, dest: int, tag: int = 0, cid: int = 0) -> None:
        if self._send_pos < len(self._log.sends):
            ldest, ltag, _ = self._log.sends[self._send_pos]
            if (ldest, ltag) != (dest, tag):
                raise errors.InternalError(
                    f"replay divergence: send #{self._send_pos} was to "
                    f"({ldest},{ltag}), replayed ({dest},{tag})"
                )
            self._send_pos += 1
            return
        raise errors.InternalError(
            "replay ran past the send log; live handoff needs the "
            "universe transport (restart-to-live is the multi-host "
            "runtime's job)"
        )

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             cid: int = 0, return_status: bool = False,
             timeout: float | None = None, poll: bool = False) -> Any:
        # timeout/poll are accepted for live-surface signature parity and
        # ignored: replay is instantaneous and cannot fail mid-wait
        if self._recv_pos >= len(self._log.recvs):
            raise errors.InternalError("replay ran past the receive log")
        lsource, ltag, payload = self._log.recvs[self._recv_pos]
        if source != ANY_SOURCE and source != lsource:
            raise errors.InternalError(
                f"replay divergence: recv #{self._recv_pos} came from "
                f"{lsource}, replayed asks {source}"
            )
        if tag != ANY_TAG and tag != ltag:
            raise errors.InternalError(
                f"replay divergence: recv #{self._recv_pos} had tag "
                f"{ltag}, replayed asks {tag}"
            )
        self._recv_pos += 1
        value = _eager_copy(payload)
        if return_status:
            # the logged resolved (source, tag) IS the status — the
            # replayed caller sees the same shape as the live surface
            return value, Status(
                source=lsource, tag=ltag,
                count_bytes=_payload_bytes(value),
            )
        return value

    def sendrecv(self, obj: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG, cid: int = 0):
        self.send(obj, dest, sendtag, cid)
        return self.recv(source, recvtag, cid)

    def barrier(self) -> None:
        """Barriers are deterministic control flow — nothing to replay."""

    @property
    def sends_done(self) -> bool:
        return self._send_pos >= len(self._log.sends)

    @property
    def recvs_done(self) -> bool:
        return self._recv_pos >= len(self._log.recvs)

    @property
    def fully_replayed(self) -> bool:
        return (self._recv_pos == len(self._log.recvs)
                and self._send_pos == len(self._log.sends))


class RejoinContext:
    """Restarted-rank context that crosses the replay/live boundary: while
    the pessimistic log still has entries, operations replay from it (the
    :class:`ReplayContext` contract — sends swallowed, receives served in
    logged order); once a log runs dry, the SAME call falls through to a
    live endpoint — the restarted rank rejoins the (possibly shrunken)
    universe mid-program.  This is the piece the reference leaves to the
    restart runtime: logged history first, live traffic after."""

    def __init__(self, replay: ReplayContext, live):
        self._replay = replay
        self._live = live
        self.rank = live.rank
        self.size = live.size

    def send(self, obj: Any, dest: int, tag: int = 0, cid: int = 0) -> None:
        if not self._replay.sends_done:
            return self._replay.send(obj, dest, tag, cid)
        return self._live.send(obj, dest, tag, cid)

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             cid: int = 0, **kwargs) -> Any:
        if not self._replay.recvs_done:
            # kwargs (return_status in particular) forward to replay too:
            # the return SHAPE must not change when the log runs dry
            return self._replay.recv(source, tag, cid, **kwargs)
        return self._live.recv(source, tag, cid, **kwargs)

    def sendrecv(self, obj: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG, cid: int = 0):
        self.send(obj, dest, sendtag, cid)
        return self.recv(source, recvtag, cid)

    def barrier(self) -> None:
        # during replay barriers are deterministic control flow (no-op);
        # once live, the rejoined rank must synchronize for real
        if self._replay.fully_replayed:
            self._live.barrier()

    @property
    def fully_replayed(self) -> bool:
        return self._replay.fully_replayed


class ProcessLogger:
    """Pessimistic logging for ONE rank of a wire (multi-process) job —
    the round-3 unweld: each process owns exactly its own log, as the
    reference's sender-based logging does (no cross-process log registry
    can exist).  Restart-side replay uses the same :class:`ReplayContext`;
    fetching surviving peers' payload logs is the restart runtime's job,
    exactly as in the reference."""

    def __init__(self, ep):
        self._ep = ep
        self.log = _RankLog()
        self._lock = threading.Lock()

    def wrap(self) -> LoggedContext:
        return LoggedContext(self._ep, self.log, self._lock)

    def replay_context(self) -> ReplayContext:
        return ReplayContext(self._ep.rank, self._ep.size, self.log)

    def rejoin_context(self, live_ep) -> "RejoinContext":
        """Replay this rank's log, then continue live on `live_ep`."""
        return RejoinContext(self.replay_context(), live_ep)

    def event_counts(self) -> tuple[int, int]:
        return len(self.log.sends), len(self.log.recvs)


class UniverseLogger:
    """Attach pessimistic logging to a universe."""

    def __init__(self, uni: LocalUniverse):
        self._uni = uni
        self._logs = [_RankLog() for _ in range(uni.size)]
        self._locks = [threading.Lock() for _ in range(uni.size)]

    def wrap(self, ctx: RankContext) -> LoggedContext:
        return LoggedContext(
            ctx, self._logs[ctx.rank], self._locks[ctx.rank]
        )

    def run_logged(self, fn: Callable, timeout: float = 60.0) -> list[Any]:
        """universe.run with every rank's context wrapped."""
        return self._uni.run(lambda ctx: fn(self.wrap(ctx)), timeout)

    def replay_context(self, rank: int) -> ReplayContext:
        """A deterministic replay context for one (restarted) rank."""
        if not 0 <= rank < self._uni.size:
            raise errors.RankError(f"rank {rank} out of range")
        return ReplayContext(rank, self._uni.size, self._logs[rank])

    def rejoin_context(self, rank: int, live_ep=None) -> "RejoinContext":
        """Replay rank's log, then continue LIVE — by default on the
        universe's own context for that rank (the restarted rank takes
        its old slot back; pass `live_ep` to rejoin elsewhere, e.g. a
        shrunken endpoint)."""
        if live_ep is None:
            live_ep = self._uni.contexts[rank]
        return RejoinContext(self.replay_context(rank), live_ep)

    def event_counts(self, rank: int) -> tuple[int, int]:
        log = self._logs[rank]
        return len(log.sends), len(log.recvs)
