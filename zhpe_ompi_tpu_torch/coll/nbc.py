"""Nonblocking collectives: libnbc-style round schedules on the host
plane (namesake: ``zhpe_ompi_tpu/coll/nbc.py``; the port's own copy).

The reference ships a full nonblocking collective engine that compiles each
collective into a *schedule* of rounds — every round a set of send/recv/op
actions, progressed round-at-a-time by the request machinery
(``ompi/mca/coll/libnbc/nbc.c:1-80``, ``nbc_internal.h``).  This module is
that engine re-designed for Python: a schedule is a **generator** that
yields one round's sub-requests at a time; :class:`SchedRequest` advances
the generator whenever every yielded request has completed (the
NBC_PROGRESS analog), and the generator's return value completes the
collective's request.  The generator form subsumes libnbc's
NBC_Sched_send/recv/op/copy/barrier primitives: sequential yields ARE the
round barriers, and arbitrary Python between yields is the op/copy rounds.

The reducing schedules (``iallreduce``, ``ireduce``, ``iscan``,
``iexscan``, ``ireduce_scatter``) complete with the caller's kind, as the
blocking collectives of :mod:`~zhpe_ompi_tpu_torch.coll.host` return it (a
tensor, a numpy array or a Python number); the others complete with the
payloads as the transport delivered them.

All schedules run over the same endpoint surface as
:mod:`zhpe_ompi_tpu_torch.coll.host` (universe RankContext, TcpProc) and use its
per-instance collective tags (:func:`~zhpe_ompi_tpu_torch.coll.host._next_tag`):
every collective — blocking or not — stamps its wire traffic with a
sequence number that is identical on every rank (same program order) and
unique per instance, so arbitrarily-overlapping schedules can never
cross-match (libnbc's ``schedule->tag`` mechanism).
"""

from __future__ import annotations

from typing import Any, Generator

from ..core import errors
from ..pt2pt.requests import Request
from ..runtime import ztrace
from . import host as H

# Nonblocking barrier's base kind tag (blocking barrier has its own
# reserved cid; the nonblocking one lives in the collective tag space).
TAG_IBARRIER = 0x7E0A


class SchedRequest(Request):
    """A collective request driven by a round-schedule generator.

    The generator yields lists of sub-requests (one list per round); it is
    resumed with the list of their payloads once all complete.  Its return
    value becomes this request's value.  Progress is weak (driven from
    wait/test), like every request in this framework.

    Revoke-aware (ULFM): on an ft-enabled endpoint, every progress tick
    and every round boundary checks whether the collective channel has
    been revoked — a rank parked inside a multi-round schedule (its
    partner died and will never send) aborts with typed ``Revoked`` as
    soon as the revocation lands, instead of discovering it only at its
    next pt2pt op (which, parked mid-wait, would be never).  The
    recovering rank triggers this by revoking the collective cid
    (``ep.revoke(coll.host.COLL_CID)``), the MPIX_Comm_revoke idiom.
    """

    __slots__ = ("_gen", "_round", "_endpoint_progress", "_ft_state",
                 "_coll_cid", "_tspan")

    def __init__(self, gen: Generator, endpoint_progress=None,
                 ft_state=None, coll_cid: int = H.COLL_CID,
                 trace_rank: int = -1, trace_op: "str | None" = None):
        super().__init__(progress=self._advance)
        self._gen = gen
        self._round: list[Request] = []
        self._endpoint_progress = endpoint_progress
        self._ft_state = ft_state
        self._coll_cid = coll_cid
        # tracing plane: one COLL span per schedule, issue → clean
        # completion (an aborted schedule records no span — the
        # missing span is the postmortem signal, like han's)
        self._tspan = ztrace.begin(
            ztrace.COLL, trace_rank, op=trace_op or "nbc", sched="nbc",
        ) if ztrace.active else None
        self._kick()

    def _finish(self, value) -> None:
        self.complete(value)
        if self._tspan is not None:
            self._tspan.end()
            self._tspan = None

    def _kick(self) -> None:
        """Start the schedule: run until the first yield (round 0 posted)."""
        try:
            self._round = list(next(self._gen))
        except StopIteration as stop:
            self._finish(stop.value)

    def _check_revoked(self) -> None:
        if self._ft_state is not None \
                and self._ft_state.is_revoked(self._coll_cid):
            raise errors.Revoked(
                f"collective schedule aborted: cid={self._coll_cid} "
                f"revoked mid-schedule", cid=self._coll_cid,
            )

    def _advance(self) -> None:
        """NBC_PROGRESS: if the current round is fully complete, feed the
        results back and post the next round(s).  Driving sub-request
        progress matters on the deferred engine: a parked isend whose
        peer died (or whose cid was revoked) classifies from ITS
        progress tick, and the typed error a sub-request completed with
        aborts the schedule at the round boundary — waitall observes
        the failure at completion, never a wedge."""
        if self.done:
            return
        self._check_revoked()
        if self._endpoint_progress is not None:
            self._endpoint_progress()
        for r in self._round:
            if not r.done and r._progress is not None:
                r._progress()
        while not self.done and all(r.done for r in self._round):
            self._check_revoked()  # round boundary
            err = next((r.error for r in self._round
                        if r.error is not None), None)
            if err is not None:
                # a sub-request completed ERRORED (typed peer death /
                # revocation from the deferred engine): the schedule
                # cannot make progress — abort typed, like the revoke
                # path, and surface the error at this request's wait
                self._gen.close()
                self.complete_error(err)
                return
            values = [r._value for r in self._round]
            try:
                self._round = list(self._gen.send(values))
            except StopIteration as stop:
                self._finish(stop.value)
            except BaseException as e:
                # the schedule body itself failed (e.g. a sub-send
                # raising at issue time): that error is the request's
                # PERMANENT outcome — without recording it, a later
                # test()/wait() would resume the dead generator into a
                # StopIteration(None) and report silent success
                self.complete_error(e)
                raise


def _start(ctx, gen, op: "str | None" = None) -> SchedRequest:
    if op is None and ztrace.active:
        # the public i<op> wrapper one frame up names the schedule —
        # resolved only while tracing is armed (disarmed calls pay
        # nothing for a label nobody records)
        import sys

        op = sys._getframe(1).f_code.co_name
    return SchedRequest(
        gen,
        endpoint_progress=getattr(ctx, "progress", None),
        ft_state=getattr(ctx, "ft_state", None),
        trace_rank=getattr(ctx, "rank", -1),
        trace_op=op,
    )


# ---------------------------------------------------------------- ibarrier


def ibarrier(ctx) -> SchedRequest:
    """Nonblocking dissemination barrier (the shape of
    coll_base_barrier.c's doubling, one yield per round)."""
    def sched():
        n, rank = ctx.size, ctx.rank
        tag = H._next_tag(ctx, TAG_IBARRIER)
        k = 1
        while k < n:
            rreq = ctx.irecv((rank - k) % n, tag=tag, cid=H.COLL_CID)
            sreq = ctx.isend(b"", (rank + k) % n, tag=tag, cid=H.COLL_CID)
            yield [rreq, sreq]
            k <<= 1
        return None

    return _start(ctx, sched())


# ------------------------------------------------------------------ ibcast


def ibcast(ctx, obj: Any = None, root: int = 0) -> SchedRequest:
    """Nonblocking binomial broadcast; request value is the payload."""
    def sched():
        size, rank = ctx.size, ctx.rank
        payload = obj
        if size > 1:
            tag = H._next_tag(ctx, H.TAG_BCAST)
            vrank = (rank - root) % size
            if vrank != 0:
                parent = ((vrank & (vrank - 1)) + root) % size
                (payload,) = (yield [
                    ctx.irecv(parent, tag=tag, cid=H.COLL_CID)
                ])
            sends = []
            mask = 1
            while mask < size:
                if vrank & (mask - 1) == 0 and vrank | mask != vrank:
                    child = vrank | mask
                    if child < size:
                        sends.append(ctx.isend(
                            payload, (child + root) % size,
                            tag=tag, cid=H.COLL_CID,
                        ))
                mask <<= 1
            if sends:
                yield sends
        return payload

    return _start(ctx, sched())


# -------------------------------------------------------------- iallreduce


def iallreduce(ctx, value: Any, op) -> SchedRequest:
    """Nonblocking recursive-doubling allreduce with the non-power-of-two
    fold — the same schedule as the blocking variant, one yield per
    communication round."""
    def sched():
        size, rank = ctx.size, ctx.rank
        acc = value
        if size == 1:
            return acc
        tag = H._next_tag(ctx, H.TAG_ALLREDUCE)
        pof2 = 1
        while pof2 * 2 <= size:
            pof2 *= 2
        rem = size - pof2
        if rank < 2 * rem:
            if rank % 2 == 0:
                yield [ctx.isend(acc, rank + 1, tag=tag,
                                 cid=H.COLL_CID)]
                newrank = -1
            else:
                (other,) = (yield [
                    ctx.irecv(rank - 1, tag=tag, cid=H.COLL_CID)
                ])
                acc = H._ordered(op, other, acc)
                newrank = rank // 2
        else:
            newrank = rank - rem
        if newrank >= 0:
            mask = 1
            while mask < pof2:
                pnew = newrank ^ mask
                partner = pnew * 2 + 1 if pnew < rem else pnew + rem
                rreq = ctx.irecv(partner, tag=tag,
                                 cid=H.COLL_CID)
                sreq = ctx.isend(acc, partner, tag=tag,
                                 cid=H.COLL_CID)
                other, _ = (yield [rreq, sreq])
                if partner < rank:
                    acc = H._ordered(op, other, acc)
                else:
                    acc = H._ordered(op, acc, other)
                mask <<= 1
        if rank < 2 * rem:
            if rank % 2 == 0:
                (acc,) = (yield [
                    ctx.irecv(rank + 1, tag=tag, cid=H.COLL_CID)
                ])
            else:
                yield [ctx.isend(acc, rank - 1, tag=tag,
                                 cid=H.COLL_CID)]
        return H._like(acc, value)

    return _start(ctx, sched())


# -------------------------------------------------------------- iallgather


def iallgather(ctx, value: Any) -> SchedRequest:
    """Nonblocking ring allgather; request value is the rank-indexed list."""
    def sched():
        size, rank = ctx.size, ctx.rank
        out: list = [None] * size
        out[rank] = value
        tag = H._next_tag(ctx, H.TAG_ALLGATHER)
        right, left = (rank + 1) % size, (rank - 1) % size
        blk = (rank, value)
        for _ in range(size - 1):
            rreq = ctx.irecv(left, tag=tag, cid=H.COLL_CID)
            sreq = ctx.isend(blk, right, tag=tag, cid=H.COLL_CID)
            got, _ = (yield [rreq, sreq])
            out[got[0]] = got[1]
            blk = got
        return out

    return _start(ctx, sched())


# --------------------------------------------------------------- ialltoall


def ialltoall(ctx, values: list) -> SchedRequest:
    """Nonblocking pairwise-exchange alltoall; request value is the
    rank-indexed receive list."""
    if len(values) != ctx.size:
        raise errors.ArgError(f"ialltoall needs {ctx.size} blocks")

    def sched():
        size, rank = ctx.size, ctx.rank
        out: list = [None] * size
        out[rank] = values[rank]
        tag = H._next_tag(ctx, H.TAG_ALLTOALL)
        for i in range(1, size):
            sendto = (rank + i) % size
            recvfrom = (rank - i) % size
            rreq = ctx.irecv(recvfrom, tag=tag, cid=H.COLL_CID)
            sreq = ctx.isend(values[sendto], sendto, tag=tag,
                             cid=H.COLL_CID)
            got, _ = (yield [rreq, sreq])
            out[recvfrom] = got
        return out

    return _start(ctx, sched())


# ----------------------------------------------------------------- ireduce


def ireduce(ctx, value: Any, op, root: int = 0) -> SchedRequest:
    """Nonblocking reduce (binomial for commutative ops, in-order linear
    otherwise); request value significant at root."""
    def sched_linear():
        size, rank = ctx.size, ctx.rank
        tag = H._next_tag(ctx, H.TAG_REDUCE)
        if rank != root:
            yield [ctx.isend(value, root, tag=tag, cid=H.COLL_CID)]
            return None
        acc = None
        for r in range(size):
            if r == root:
                contrib = value
            else:
                (contrib,) = (yield [
                    ctx.irecv(r, tag=tag, cid=H.COLL_CID)
                ])
            acc = contrib if acc is None else H._ordered(op, acc, contrib)
        return H._like(acc, value)

    def sched_binomial():
        size, rank = ctx.size, ctx.rank
        tag = H._next_tag(ctx, H.TAG_REDUCE)
        vrank = (rank - root) % size
        acc = value
        mask = 1
        while mask < size:
            if vrank & mask:
                parent = ((vrank & ~mask) + root) % size
                yield [ctx.isend((vrank, acc), parent, tag=tag,
                                 cid=H.COLL_CID)]
                return None
            child = vrank | mask
            if child < size:
                (got,) = (yield [
                    ctx.irecv((child + root) % size, tag=tag,
                              cid=H.COLL_CID)
                ])
                acc = H._ordered(op, acc, got[1])
            mask <<= 1
        return H._like(acc, value)

    if ctx.size == 1:
        def sched_one():
            return value
            yield  # pragma: no cover - makes this a generator

        return _start(ctx, sched_one())
    gen = (sched_linear() if not getattr(op, "commute", True)
           else sched_binomial())
    return _start(ctx, gen)


# --------------------------------------------------------- igather/iscatter


def igather(ctx, value: Any, root: int = 0) -> SchedRequest:
    """Nonblocking linear gather; request value is the list at root."""
    def sched():
        size, rank = ctx.size, ctx.rank
        tag = H._next_tag(ctx, H.TAG_GATHER)
        if rank != root:
            yield [ctx.isend(value, root, tag=tag, cid=H.COLL_CID)]
            return None
        out = [None] * size
        out[root] = value
        others = [r for r in range(size) if r != root]
        reqs = [ctx.irecv(r, tag=tag, cid=H.COLL_CID)
                for r in others]
        vals = yield reqs
        for r, v in zip(others, vals):
            out[r] = v
        return out

    return _start(ctx, sched())


def iscatter(ctx, values: list | None = None, root: int = 0) -> SchedRequest:
    """Nonblocking linear scatter; request value is this rank's block."""
    if ctx.rank == root and (values is None or len(values) != ctx.size):
        raise errors.ArgError(
            f"iscatter root needs {ctx.size} blocks, got "
            f"{'None' if values is None else len(values)}"
        )

    def sched():
        size, rank = ctx.size, ctx.rank
        tag = H._next_tag(ctx, H.TAG_SCATTER)
        if rank == root:
            reqs = [ctx.isend(values[r], r, tag=tag, cid=H.COLL_CID)
                    for r in range(size) if r != root]
            if reqs:
                yield reqs
            return values[root]
        (blk,) = (yield [ctx.irecv(root, tag=tag, cid=H.COLL_CID)])
        return blk

    return _start(ctx, sched())


# ------------------------------------------------- v-variant schedules
# (libnbc's nbc_iallgatherv.c / nbc_ialltoallv.c set — round-3 fill-in)


def iallgatherv(ctx, value: Any) -> SchedRequest:
    """Nonblocking ring allgatherv: blocks carry their sizes, so the
    schedule is the allgather ring verbatim (nbc_iallgatherv.c shape)."""
    def sched():
        size, rank = ctx.size, ctx.rank
        out: list = [None] * size
        out[rank] = value
        if size == 1:
            return out
        tag = H._next_tag(ctx, H.TAG_ALLGATHERV)
        right, left = (rank + 1) % size, (rank - 1) % size
        blk = (rank, value)
        for _ in range(size - 1):
            rreq = ctx.irecv(left, tag=tag, cid=H.COLL_CID)
            sreq = ctx.isend(blk, right, tag=tag, cid=H.COLL_CID)
            got, _ = (yield [rreq, sreq])
            out[got[0]] = got[1]
            blk = got
        return out

    return _start(ctx, sched())


def ialltoallv(ctx, sendbuf, counts: list, displs: list | None = None
               ) -> SchedRequest:
    """Nonblocking pairwise alltoallv over a flat buffer + counts
    (nbc_ialltoallv.c shape); request value is the rank-indexed recv
    list."""
    blocks = H._blocks_from(sendbuf, counts, displs, ctx.size)

    def sched():
        size, rank = ctx.size, ctx.rank
        out: list = [None] * size
        out[rank] = blocks[rank]
        tag = H._next_tag(ctx, H.TAG_ALLTOALLV)
        for i in range(1, size):
            sendto = (rank + i) % size
            recvfrom = (rank - i) % size
            rreq = ctx.irecv(recvfrom, tag=tag, cid=H.COLL_CID)
            sreq = ctx.isend(blocks[sendto], sendto, tag=tag,
                             cid=H.COLL_CID)
            got, _ = (yield [rreq, sreq])
            out[recvfrom] = got
        return out

    return _start(ctx, sched())


def igatherv(ctx, value: Any, root: int = 0) -> SchedRequest:
    """Nonblocking linear gatherv (variable-size blocks)."""
    def sched():
        size, rank = ctx.size, ctx.rank
        tag = H._next_tag(ctx, H.TAG_GATHERV)
        if rank != root:
            yield [ctx.isend(value, root, tag=tag, cid=H.COLL_CID)]
            return None
        out = [None] * size
        out[root] = value
        others = [r for r in range(size) if r != root]
        vals = yield [ctx.irecv(r, tag=tag, cid=H.COLL_CID)
                      for r in others]
        for r, v in zip(others, vals):
            out[r] = v
        return out

    return _start(ctx, sched())


def iscatterv(ctx, sendbuf=None, counts: list | None = None,
              displs: list | None = None, root: int = 0) -> SchedRequest:
    """Nonblocking linear scatterv (flat buffer + counts at root)."""
    if ctx.rank == root:
        if sendbuf is None or counts is None:
            raise errors.ArgError(
                f"iscatterv root needs a buffer and {ctx.size} counts"
            )
        blocks = H._blocks_from(sendbuf, counts, displs, ctx.size)

    def sched():
        size, rank = ctx.size, ctx.rank
        tag = H._next_tag(ctx, H.TAG_SCATTERV)
        if rank == root:
            reqs = [ctx.isend(blocks[r], r, tag=tag, cid=H.COLL_CID)
                    for r in range(size) if r != root]
            if reqs:
                yield reqs
            return blocks[root]
        (blk,) = (yield [ctx.irecv(root, tag=tag, cid=H.COLL_CID)])
        return blk

    return _start(ctx, sched())


# ------------------------------------------------ scan/exscan schedules
# (nbc_iscan.c / nbc_iexscan.c: linear chain, one neighbor hop per rank)


def iscan(ctx, value: Any, op) -> SchedRequest:
    """Nonblocking inclusive prefix reduction (chain schedule)."""
    def sched():
        rank = ctx.rank
        tag = H._next_tag(ctx, H.TAG_SCAN)
        acc = value
        if rank > 0:
            (prev,) = (yield [
                ctx.irecv(rank - 1, tag=tag, cid=H.COLL_CID)
            ])
            acc = H._ordered(op, prev, acc)
        if rank + 1 < ctx.size:
            yield [ctx.isend(acc, rank + 1, tag=tag, cid=H.COLL_CID)]
        return H._like(acc, value)

    return _start(ctx, sched())


def iexscan(ctx, value: Any, op) -> SchedRequest:
    """Nonblocking exclusive prefix reduction; rank 0's value is None."""
    def sched():
        rank = ctx.rank
        tag = H._next_tag(ctx, H.TAG_SCAN)
        prev = None
        if rank > 0:
            (prev,) = (yield [
                ctx.irecv(rank - 1, tag=tag, cid=H.COLL_CID)
            ])
        if rank + 1 < ctx.size:
            mine = value if prev is None else H._ordered(op, prev, value)
            yield [ctx.isend(mine, rank + 1, tag=tag, cid=H.COLL_CID)]
        return None if prev is None else H._like(prev, value)

    return _start(ctx, sched())


# --------------------------------------------- reduce_scatter schedules
# (nbc_ireduce_scatter.c: reduce + scatterv pipeline)


def ireduce_scatter(ctx, values: list, op) -> SchedRequest:
    """Nonblocking blockwise reduce + scatter: `values` is the
    rank-indexed block list; request value is this rank's fully-reduced
    block."""
    if len(values) != ctx.size:
        raise errors.ArgError(f"ireduce_scatter needs {ctx.size} blocks")

    def sched():
        size, rank = ctx.size, ctx.rank
        if size == 1:
            return values[0]
        # binomial reduce of the block list to rank 0 (in-order combines)
        tag = H._next_tag(ctx, H.TAG_RSCAT)
        acc = list(values)
        vrank = rank
        mask = 1
        while mask < size:
            if vrank & mask:
                yield [ctx.isend((vrank, acc), vrank & ~mask, tag=tag,
                                 cid=H.COLL_CID)]
                break
            child = vrank | mask
            if child < size:
                (got,) = (yield [
                    ctx.irecv(child, tag=tag, cid=H.COLL_CID)
                ])
                acc = H._combine(op, acc, got[1])
            mask <<= 1
        # scatter the reduced blocks from rank 0
        stag = H._next_tag(ctx, H.TAG_SCATTER)
        if rank == 0:
            reqs = [ctx.isend(acc[r], r, tag=stag, cid=H.COLL_CID)
                    for r in range(1, size)]
            if reqs:
                yield reqs
            return H._like(acc[0], values[0])
        (blk,) = (yield [ctx.irecv(0, tag=stag, cid=H.COLL_CID)])
        return H._like(blk, values[rank])

    return _start(ctx, sched())


def ireduce_scatter_block(ctx, values: list, op) -> SchedRequest:
    """Nonblocking reduce_scatter_block: equal block counts — the MPI
    surface distinction; the schedule is shared."""
    return ireduce_scatter(ctx, values, op)


# ----------------------------------------------- neighbor collectives
# (nbc_ineighbor_allgather.c / nbc_ineighbor_alltoall.c: one round of
# irecv from every in-neighbor + isend to every out-neighbor)


def ineighbor_allgather(ctx, value: Any, sources: list[int],
                        destinations: list[int]) -> SchedRequest:
    """Nonblocking neighbor allgather over explicit neighbor lists (the
    dist_graph adjacency): sends `value` to every destination, returns
    the in-neighbor-ordered list of received values."""
    def sched():
        tag = H._next_tag(ctx, H.TAG_NEIGHBOR)
        rreqs = [ctx.irecv(s, tag=tag, cid=H.COLL_CID) for s in sources]
        sreqs = [ctx.isend(value, d, tag=tag, cid=H.COLL_CID)
                 for d in destinations]
        vals = yield rreqs + sreqs
        return list(vals[: len(rreqs)])

    return _start(ctx, sched())


def ineighbor_alltoall(ctx, values: list, sources: list[int],
                       destinations: list[int]) -> SchedRequest:
    """Nonblocking neighbor alltoall: values[i] goes to destinations[i];
    returns the in-neighbor-ordered received list."""
    if len(values) != len(destinations):
        raise errors.ArgError(
            "ineighbor_alltoall needs one value per destination"
        )

    def sched():
        tag = H._next_tag(ctx, H.TAG_NEIGHBOR)
        rreqs = [ctx.irecv(s, tag=tag, cid=H.COLL_CID) for s in sources]
        sreqs = [ctx.isend(v, d, tag=tag, cid=H.COLL_CID)
                 for v, d in zip(values, destinations)]
        vals = yield rreqs + sreqs
        return list(vals[: len(rreqs)])

    return _start(ctx, sched())


class NonblockingCollectives:
    """Mixin: the MPI_Ix surface for host endpoints (pairs with
    :class:`zhpe_ompi_tpu_torch.coll.host.HostCollectives`)."""

    def ibarrier(self) -> SchedRequest:
        return ibarrier(self)

    def ibcast(self, obj: Any = None, root: int = 0) -> SchedRequest:
        return ibcast(self, obj, root)

    def iallreduce(self, value: Any, op) -> SchedRequest:
        return iallreduce(self, value, op)

    def iallgather(self, value: Any) -> SchedRequest:
        return iallgather(self, value)

    def ialltoall(self, values: list) -> SchedRequest:
        return ialltoall(self, values)

    def ireduce(self, value: Any, op, root: int = 0) -> SchedRequest:
        return ireduce(self, value, op, root)

    def igather(self, value: Any, root: int = 0) -> SchedRequest:
        return igather(self, value, root)

    def iscatter(self, values: list | None = None, root: int = 0
                 ) -> SchedRequest:
        return iscatter(self, values, root)

    def iallgatherv(self, value: Any) -> SchedRequest:
        return iallgatherv(self, value)

    def ialltoallv(self, sendbuf, counts: list,
                   displs: list | None = None) -> SchedRequest:
        return ialltoallv(self, sendbuf, counts, displs)

    def igatherv(self, value: Any, root: int = 0) -> SchedRequest:
        return igatherv(self, value, root)

    def iscatterv(self, sendbuf=None, counts: list | None = None,
                  displs: list | None = None, root: int = 0
                  ) -> SchedRequest:
        return iscatterv(self, sendbuf, counts, displs, root)

    def iscan(self, value: Any, op) -> SchedRequest:
        return iscan(self, value, op)

    def iexscan(self, value: Any, op) -> SchedRequest:
        return iexscan(self, value, op)

    def ireduce_scatter(self, values: list, op) -> SchedRequest:
        return ireduce_scatter(self, values, op)

    def ireduce_scatter_block(self, values: list, op) -> SchedRequest:
        return ireduce_scatter_block(self, values, op)

    def ineighbor_allgather(self, value: Any, sources: list[int],
                            destinations: list[int]) -> SchedRequest:
        return ineighbor_allgather(self, value, sources, destinations)

    def ineighbor_alltoall(self, values: list, sources: list[int],
                           destinations: list[int]) -> SchedRequest:
        return ineighbor_alltoall(self, values, sources, destinations)

    # blocking neighbor collectives (MPI_Neighbor_allgather/alltoall):
    # the schedule run to completion — same layering the reference gets
    # from nbc_ineighbor_* + wait
    def neighbor_allgather(self, value: Any, sources: list[int],
                           destinations: list[int]) -> list:
        return ineighbor_allgather(self, value, sources,
                                   destinations).wait()

    def neighbor_alltoall(self, values: list, sources: list[int],
                          destinations: list[int]) -> list:
        return ineighbor_alltoall(self, values, sources,
                                  destinations).wait()
