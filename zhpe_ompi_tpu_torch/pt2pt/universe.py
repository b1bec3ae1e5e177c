"""Local universe: thread-ranks with full MPI pt2pt semantics (namesake:
``zhpe_ompi_tpu/pt2pt/universe.py``; the port's own copy).

The host-plane counterpart of the SPMD device plane — the analog of running
N ranks over btl/self + btl/sm on one node.  Each rank is a thread with its
own matching engine and mailbox; payloads stay by-reference inside the
process except where MPI's buffer-reuse contract needs a copy: a numpy
array is copied and a tensor cloned, on its own device (a CUDA tensor
stays on the card: this plane moves no bytes to the host, as the namesake
passes device arrays through unchanged).

Protocol design mirrors ob1's eager/rendezvous split
(``pml_ob1_sendreq.h:385-414``): messages up to ``pt2pt_eager_limit`` travel
with their envelope and the send completes immediately (buffered); larger
messages send an RTS, the payload is handed over only after the receiver
matches and returns a CTS — so an un-matched large send correctly blocks and
the sender's buffer stays live until delivery.

What waits for modules not ported yet, against the namesake:

- ``LocalUniverse(ft=True)`` (the shared ``FailureState``, the heartbeat
  board, the ring detector, ``respawn_rank``) and the ULFM methods of
  :class:`RankContext` (``failure_ack``, ``failure_get_acked``,
  ``agree``, ``shrink``, ``revoke``) raise ``UnsupportedError`` naming
  ``ft/ulfm.py`` (ROADMAP queue A item 4).  ``ft_state`` is always None,
  so the namesake's failure-classifying receive paths are not here.
- The MPI_T pvars ``pt2pt_posted_recvs``/``pt2pt_unexpected_msgs``
  (``_register_queue_pvars``) wait for ``tools/mpit.py`` (item 7); the
  depth they read, :func:`_queue_depth`, is here.
"""

from __future__ import annotations

import itertools
import queue
import threading
import weakref
from typing import Any, Callable

import numpy as np
import torch

from ..coll.host import HostCollectives
from ..coll.nbc import NonblockingCollectives
from ..core import errhandler as errh
from ..core import errors
from ..ft import ulfm
from ..mca import var as mca_var
from ..runtime import spc
from ..runtime import ztrace
from ..utils import lockdep
from ..utils import memchecker
from . import matching
from .matching import ANY_SOURCE, ANY_TAG, Envelope
from .requests import Request

mca_var.register(
    "pt2pt_eager_limit", 64 * 1024,
    "Message size (bytes) up to which sends complete eagerly "
    "(btl_eager_limit analog)",
    type=int,
)

_EAGER = "eager"
_RTS = "rts"
_CTS = "cts"
_DATA = "data"


class _RndvToken:
    """Out-of-band marker for a rendezvous announce sitting in the matching
    engine — a private type so no user payload can be mistaken for it."""

    __slots__ = ("sender_rank", "rndv_id")

    def __init__(self, sender_rank: int, rndv_id: int):
        self.sender_rank = sender_rank
        self.rndv_id = rndv_id


def _payload_nbytes(obj: Any) -> int:
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    try:
        return len(obj)
    except TypeError:
        return 64


def _eager_copy(obj: Any) -> Any:
    """Copy mutable buffers so the sender may reuse them immediately: a
    numpy array is copied, a tensor cloned on its own device."""
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    return obj  # immutables


class _Message:
    """MPI_Message analog: a matched-but-unreceived message handle."""

    __slots__ = ("envelope", "payload", "consumed")

    def __init__(self, envelope: Envelope, payload: Any):
        self.envelope = envelope
        self.payload = payload
        self.consumed = False


class PersistentRequest:
    """MPI persistent request: created inactive, re-armed by start(),
    completed by wait/test like any request (cf. MCA_PML_CALL(start))."""

    def __init__(self, start_fn: Callable[[], "Request"]):
        self._start_fn = start_fn
        self._active: Request | None = None

    def start(self) -> "PersistentRequest":
        if self._active is not None and not self._active.done:
            raise errors.RequestError(
                "persistent request started while still active"
            )
        self._active = self._start_fn()
        return self

    def wait(self, timeout: float | None = None):
        if self._active is None:
            raise errors.RequestError("wait on an inactive persistent request")
        value = self._active.wait(timeout)
        self.status = self._active.status
        self._active = None  # back to inactive, re-armable
        return value

    def test(self):
        if self._active is None:
            raise errors.RequestError("test on an inactive persistent request")
        flag, value = self._active.test()
        if flag:
            self.status = self._active.status
            self._active = None
        return flag, value


class RankContext(errh.HasErrhandler, ulfm.UlfmEndpointAPI,
                  HostCollectives, NonblockingCollectives):
    """One rank's endpoint: the MPI API surface of the host plane.
    Collectives come from :class:`~zhpe_ompi_tpu_torch.coll.host
    .HostCollectives` (blocking) and :class:`~zhpe_ompi_tpu_torch.coll.nbc
    .NonblockingCollectives` (MPI_Ix round schedules) — written over
    send/recv, the way the reference's coll_base and libnbc ride the PML."""

    #: no ULFM failure state until ft/ulfm.py is ported (see module doc)
    ft_state = None

    def __init__(self, universe: "LocalUniverse", rank: int):
        self.universe = universe
        self.rank = rank
        self.size = universe.size
        self.engine = matching.make_matching_engine()
        self.mailbox: queue.Queue = queue.Queue()
        self._seq = itertools.count()
        # rndv_id -> (payload, send Request, Envelope, trace ctx|None)
        self._pending_rndv: dict[int, tuple] = {}
        self._rndv_ids = itertools.count()
        self._lock = lockdep.lock("pt2pt.RankContext._lock")

    def boot_token_of(self, rank: int) -> str:
        """Locality identity for the han topology layer: thread ranks
        share one process, so the whole universe is ONE locality group."""
        if not 0 <= rank < self.size:
            raise errors.RankError(f"rank {rank} out of range")
        return f"uni-{id(self.universe):x}"

    def numa_token_of(self, rank: int) -> str:
        """NUMA-domain identity: thread ranks share one process and
        therefore one affinity mask — the whole universe is one domain."""
        if not 0 <= rank < self.size:
            raise errors.RankError(f"rank {rank} out of range")
        return "0"

    # -- internals -------------------------------------------------------

    def _mbox(self, dest: int) -> queue.Queue:
        if not 0 <= dest < self.size:
            raise errors.RankError(f"rank {dest} out of range")
        return self.universe.contexts[dest].mailbox

    def _trace_deliver(self, kind: str, env: Envelope, tctx,
                       **fields) -> None:
        """Receiver half of the thread-plane trace propagation: the
        mailbox tuple carried the sender's span context, so the
        deliver/cts span parents on the sender's send span exactly like
        the socket plane's."""
        if tctx is None or not ztrace.active:
            return
        ztrace.instant(kind, self.rank, parent=tctx[1], trace=tctx[0],
                       src=env.src, tag=env.tag, cid=env.cid,
                       seq=int(tctx[2]), transport="thread", **fields)

    def progress(self) -> None:
        """Drain the mailbox (opal_progress analog, weak progress)."""
        while True:
            try:
                kind, *rest = self.mailbox.get_nowait()
            except queue.Empty:
                return
            if kind == _EAGER:
                env, payload, tctx = rest
                self._trace_deliver(ztrace.DELIVER, env, tctx)
                self.engine.incoming(env, payload)
            elif kind == _RTS:
                # rendezvous announce: enters matching with a token the
                # receive-side callback turns into a CTS (irecv.on_match)
                env, sender_rank, rndv_id, tctx = rest
                self._trace_deliver(ztrace.CTS, env, tctx)
                self.engine.incoming(env, _RndvToken(sender_rank, rndv_id))
            elif kind == _CTS:
                rndv_id, dest_rank, req_token = rest
                with self._lock:
                    entry = self._pending_rndv.pop(rndv_id, None)
                if entry is not None:
                    payload, sreq, env, tctx = entry
                    # copy at handoff: the send completes now, so the
                    # sender may reuse its buffer before the receiver
                    # drains the message
                    self._mbox(dest_rank).put(
                        (_DATA, req_token, _eager_copy(payload), env,
                         tctx))
                    sreq.complete()
            elif kind == _DATA:
                req_token, payload, env, tctx = rest
                self._trace_deliver(ztrace.DELIVER, env, tctx,
                                    leg="data")
                req_token(payload)

    # -- sends -----------------------------------------------------------

    def isend(self, obj: Any, dest: int, tag: int = 0, cid: int = 0,
              poll: bool = False) -> Request:
        """MPI_Isend (cf. mca_pml_ob1_send's protocol switch,
        pml_ob1_sendreq.h:385-414)."""
        if tag < 0:
            raise errors.TagError(f"negative tag {tag}")
        # memchecker annotation point (ompi/mpi/c/send.c:53-55 analog)
        memchecker.check_send_buffer(obj, "isend")
        env = Envelope(self.rank, tag, cid, next(self._seq))
        nbytes = _payload_nbytes(obj)
        spc.record("pt2pt_sends", 1)
        spc.record("pt2pt_bytes_sent", nbytes)
        # tracing plane (armed only): the send span's context rides the
        # mailbox tuple — the thread plane's "wire"
        tctx = None
        if ztrace.active and not poll:
            tspan = ztrace.begin(ztrace.SEND, self.rank, dest=dest,
                                 tag=tag, cid=cid, seq=env.seq)
            tctx = ztrace.wire_context(tspan.sid, env.seq)
        eager_limit = int(mca_var.get("pt2pt_eager_limit", 64 * 1024))
        req = Request(progress=self.progress)
        if nbytes <= eager_limit:
            self._mbox(dest).put((_EAGER, env, _eager_copy(obj), tctx))
            req.complete()
            if tctx is not None:
                tspan.end(transport="thread")
        else:
            rndv_id = next(self._rndv_ids)
            with self._lock:
                self._pending_rndv[rndv_id] = (obj, req, env, tctx)
            self._mbox(dest).put((_RTS, env, self.rank, rndv_id, tctx))
            if tctx is not None:
                tspan.end(transport="thread-rndv")
        return req

    def send(self, obj: Any, dest: int, tag: int = 0, cid: int = 0,
             poll: bool = False) -> None:
        """MPI_Send: blocking (completes when the buffer is reusable)."""
        self.isend(obj, dest, tag, cid, poll=poll).wait()

    # -- receives --------------------------------------------------------

    def irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              cid: int = 0, poll: bool = False) -> Request:
        """MPI_Irecv."""
        req = Request(progress=self.progress)

        def on_match(env: Envelope, payload: Any) -> None:
            if isinstance(payload, _RndvToken):
                def deliver(data, env=env):
                    req.complete(data, source=env.src, tag=env.tag)

                self.universe.contexts[payload.sender_rank].mailbox.put(
                    (_CTS, payload.rndv_id, self.rank, deliver)
                )
            else:
                req.complete(payload, source=env.src, tag=env.tag)

        self.engine.post_recv(source, tag, cid, on_match)
        return req

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             cid: int = 0, timeout: float | None = None,
             return_status: bool = False, poll: bool = False):
        """MPI_Recv.  ``timeout`` bounds the wait (``RequestError`` when
        it passes)."""
        trecv = None
        if ztrace.active and not poll:
            trecv = ztrace.begin(ztrace.RECV, self.rank, src=source,
                                 tag=tag, cid=cid)
        req = self.irecv(source, tag, cid)
        value = req.wait(timeout)
        if trecv is not None:
            # the matched envelope, not the posted wildcard
            trecv.end(src=req.status.source, tag=req.status.tag)
        if return_status:
            return value, req.status
        return value

    def probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              cid: int = 0):
        """MPI_Iprobe: non-blocking; returns an Envelope or None."""
        self.progress()
        return self.engine.probe(source, tag, cid)

    def improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                cid: int = 0):
        """MPI_Improbe: like probe but MATCHES the message — it is removed
        from the unexpected queue and only retrievable via
        :func:`mrecv` on the returned handle."""
        self.progress()
        hit = self.engine.extract(source, tag, cid)
        if hit is None:
            return None
        env, payload = hit
        if isinstance(payload, _RndvToken):
            # rendezvous announce: pull the payload over before handing out
            done: list[Any] = []

            def deliver(data):
                done.append(data)

            self.universe.contexts[payload.sender_rank].mailbox.put(
                (_CTS, payload.rndv_id, self.rank, deliver)
            )
            while not done:
                self.progress()
                self.universe.contexts[payload.sender_rank].progress()
            payload = done[0]
        return _Message(env, payload)

    def mrecv(self, message: "_Message"):
        """MPI_Mrecv: complete a matched-probe message."""
        if message.consumed:
            raise errors.RequestError("message already received")
        message.consumed = True
        return message.payload

    # -- persistent requests (MPI_Send_init / MPI_Recv_init / MPI_Start) --

    def send_init(self, obj: Any, dest: int, tag: int = 0, cid: int = 0):
        """MPI_Send_init: persistent send."""
        return PersistentRequest(lambda: self.isend(obj, dest, tag, cid))

    def recv_init(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                  cid: int = 0):
        """MPI_Recv_init: persistent receive."""
        return PersistentRequest(lambda: self.irecv(source, tag, cid))

    def sendrecv(self, obj: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG, cid: int = 0):
        """MPI_Sendrecv.  The send side is waited too: a rendezvous send
        still parked when the recv returns pins the caller's object, and
        returning without waiting it would break the buffer-reuse
        contract."""
        rreq = self.irecv(source, recvtag, cid)
        sreq = self.isend(obj, dest, sendtag, cid)
        value = rreq.wait()
        sreq.wait()
        return value

    def barrier(self) -> None:
        """Host-plane dissemination barrier over send/recv."""
        n = self.size
        k = 1
        while k < n:
            dest = (self.rank + k) % n
            src = (self.rank - k) % n
            rreq = self.irecv(src, tag=0x7FFF - 1, cid=0x7FFF)
            sreq = self.isend(b"", dest, tag=0x7FFF - 1, cid=0x7FFF)
            rreq.wait()
            sreq.wait()
            k <<= 1


# Live-universe tracking for the queue-depth readers (checkpoint
# quiescence now, the MPI_T pvars with tools/mpit.py).  Weak references:
# readers must observe universes, not keep them alive.
_live_universes: weakref.WeakSet = weakref.WeakSet()


def _queue_depth(key: str, exempt_acked_failed: bool = False) -> int:
    """Aggregate queue depth (``"posted"`` or ``"unexpected"``) across
    live universes.  ``exempt_acked_failed`` is the checkpoint quiescence
    view of the namesake, which leaves out the rows of acknowledged-failed
    ranks and revoked cids; a port universe has no failure state, so
    there is nothing to exempt and both views count every row."""
    total = 0
    for uni in list(_live_universes):
        for c in uni.contexts:
            total += c.engine.stats()[key]
    return total


class LocalUniverse:
    """N thread-ranks on one host (btl/self+sm analog).  ``ft=True``
    raises ``UnsupportedError`` until ``ft/ulfm.py`` is ported."""

    def __init__(self, size: int, ft: bool = False):
        if size < 1:
            raise errors.ArgError("size must be >= 1")
        if ft:
            raise ulfm._waits_for_ft("LocalUniverse(ft=True)")
        self.size = size
        self.ft_state = None
        self.contexts = [RankContext(self, r) for r in range(size)]
        _live_universes.add(self)

    def close(self) -> None:
        """Drop this universe from the live set the queue-depth readers
        walk (the port's explicit teardown; the namesake relies on the
        weak set alone)."""
        _live_universes.discard(self)

    def start_failure_detector(self, period: float | None = None,
                               timeout: float | None = None) -> None:
        raise ulfm._waits_for_ft("the failure detector")

    def respawn_rank(self, rank: int) -> RankContext:
        raise ulfm._waits_for_ft("respawn_rank")

    def run(self, fn: Callable[[RankContext], Any], timeout: float = 60.0
            ) -> list[Any]:
        """SPMD-launch fn(ctx) on every rank thread; returns per-rank
        results; re-raises the first rank exception."""
        results: list[Any] = [None] * self.size
        excs: list[BaseException | None] = [None] * self.size

        def runner(r):
            try:
                results[r] = fn(self.contexts[r])
            except BaseException as e:  # noqa: BLE001 - propagated below
                excs[r] = e

        threads = [
            threading.Thread(target=runner, args=(r,), daemon=True)
            for r in range(self.size)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
            if t.is_alive():
                raise errors.InternalError(
                    "universe.run timed out (deadlock between ranks?)"
                )
        for e in excs:
            if e is not None:
                raise e
        return results
