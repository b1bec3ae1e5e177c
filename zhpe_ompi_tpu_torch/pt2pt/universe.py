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

``ft=True`` arms the ULFM machinery (``ft/ulfm.py``): a shared
``FailureState``, a heartbeat board the ring detector reads, typed failure
delivery from ``recv``/``irecv``/``sendrecv``, ``respawn_rank`` and
tolerant ``run`` semantics, as in the namesake.

The first universe registers the MPI_T state pvars
``pt2pt_posted_recvs``/``pt2pt_unexpected_msgs`` (``tools/mpit.py``), which
read :func:`_queue_depth`.
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
from .requests import Request, Status, _payload_bytes

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
    Collectives come from :class:`~zhpe_ompi_tpu_torch.coll.host.HostCollectives`
    (blocking) and :class:`~zhpe_ompi_tpu_torch.coll.nbc.NonblockingCollectives`
    (MPI_Ix round schedules) — written over send/recv, the way the
    reference's coll_base and libnbc ride the PML.  On an ft-enabled
    universe the ULFM surface (:class:`~zhpe_ompi_tpu_torch.ft.ulfm
    .UlfmEndpointAPI`) is live too, and failures classify as typed
    ``ProcFailed``/``Revoked`` through the attached errhandler
    disposition (communicator default: MPI_ERRORS_ARE_FATAL)."""

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

    @property
    def ft_state(self):
        """The universe's shared ULFM failure state (None unless the
        universe was built with ft=True)."""
        return self.universe.ft_state

    def boot_token_of(self, rank: int) -> str:
        """Locality identity for the han topology layer: thread ranks
        share one process, so the whole universe is trivially ONE
        locality group (the same-host case the reference's coll/han
        reads from the RTE's proc locality)."""
        if not 0 <= rank < self.size:
            raise errors.RankError(f"rank {rank} out of range")
        return f"uni-{id(self.universe):x}"

    def numa_token_of(self, rank: int) -> str:
        """NUMA-domain identity for the nested (three-level) topology:
        thread ranks share one process and therefore one affinity mask
        — the whole universe is one domain (emulated multi-domain
        layouts on the thread plane use the han ``groups`` override)."""
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
        mailbox tuple carried the sender's span context (no wire — the
        context rides in-memory), so the deliver/cts span parents on
        the sender's send span exactly like the socket plane's."""
        if tctx is None or not ztrace.active:
            return
        # zlint: disable=ZL010 -- kind arrives via this helper's parameter; both call sites pass the documented ztrace.DELIVER/CTS constants
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
                # else: the park was poisoned-and-released (sendrecv
                # classified the partner dead/revoked) — the send
                # already completed errored; a late CTS must neither
                # crash this progress loop nor deliver a payload whose
                # buffer the caller reclaimed at the typed raise
            elif kind == _DATA:
                req_token, payload, env, tctx = rest
                # leg="data": the rendezvous message already paired at
                # its CTS leg — unlike the tcp plane, this deliver
                # carries the USER envelope (no protocol cid), so the
                # pairing pass needs the marker to not consume a
                # second recv for the same message
                self._trace_deliver(ztrace.DELIVER, env, tctx,
                                    leg="data")
                req_token(payload)

    # -- sends -----------------------------------------------------------

    def isend(self, obj: Any, dest: int, tag: int = 0, cid: int = 0,
              poll: bool = False) -> Request:
        """MPI_Isend (cf. mca_pml_ob1_send's protocol switch,
        pml_ob1_sendreq.h:385-414).  ``poll=True`` marks a
        framework-internal send: typed failures raise directly, bypassing
        the errhandler disposition (the same contract as ``recv``)."""
        if tag < 0:
            raise errors.TagError(f"negative tag {tag}")
        state = self.universe.ft_state
        if state is not None and state.is_revoked(cid):
            # a revoked cid poisons sends on every rank (MPIX_Comm_revoke);
            # route per disposition (FATAL aborts, RETURN raises typed)
            exc = errors.Revoked(f"send on revoked cid={cid}", cid=cid)
            if poll:
                raise exc
            # a recovering user handler returns a value, but isend's
            # contract is a Request (send() calls .wait() on it) — ride
            # the recovery result on a pre-completed one
            recovered = Request()
            recovered.complete(self.call_errhandler(exc))
            return recovered
        if state is not None and state.is_failed(dest):
            # send to a known-failed rank is typed PROC_FAILED, exactly
            # like the wire plane — without this, a rendezvous-size send
            # would park its RTS in the dead rank's mailbox and wait()
            # would spin until the run's deadlock timeout (the
            # stall-vs-death ambiguity the ft path exists to remove)
            exc = errors.ProcFailed(
                f"rank {dest} is known failed "
                f"(cause: {state.cause_of(dest)})",
                failed_ranks=state.failed(),
            )
            if poll:
                raise exc
            recovered = Request()
            recovered.complete(self.call_errhandler(exc))
            return recovered
        # memchecker annotation point (ompi/mpi/c/send.c:53-55 analog)
        memchecker.check_send_buffer(obj, "isend")
        env = Envelope(self.rank, tag, cid, next(self._seq))
        nbytes = _payload_nbytes(obj)
        spc.record("pt2pt_sends", 1)
        spc.record("pt2pt_bytes_sent", nbytes)
        # tracing plane (armed only): the send span's context rides the
        # mailbox tuple — the thread plane's "wire" — so the receiver's
        # deliver span parents on it exactly like the socket plane's
        tctx = None
        if ztrace.active and not poll:
            tspan = ztrace.begin(ztrace.SEND, self.rank, dest=dest,
                                 tag=tag, cid=cid, seq=env.seq)
            tctx = ztrace.wire_context(tspan.sid, env.seq)
        eager_limit = int(mca_var.get("pt2pt_eager_limit", 64 * 1024))
        req = Request(progress=self.progress)
        if state is not None and nbytes > eager_limit:
            # a parked rendezvous send is failure-aware on an ft universe
            # (as the wire plane's isend is): a destination that dies, or
            # a cid revoked, before the CTS completes it typed from the
            # waiter's progress tick and releases the parked payload — a
            # corpse never CTSes, so a bare wait() (send(), or a shrunken
            # endpoint's sendrecv) would otherwise park forever
            req = Request(progress=lambda: self._poll_rndv_send(
                req, dest, cid), dispatch=None if poll
                else self.call_errhandler)
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

    def _poll_rndv_send(self, req, dest: int, cid: int) -> None:
        """Progress tick of a parked rendezvous send on an ft universe:
        drive this rank's progress (the CTS rides our mailbox), then
        classify the two poisons a park can never outlive."""
        self.progress()
        if req.done:
            return
        state = self.universe.ft_state
        exc = None
        if state.is_revoked(cid):
            exc = errors.Revoked(f"send on revoked cid={cid}", cid=cid)
        elif state.is_failed(dest):
            exc = errors.ProcFailed(
                f"rank {dest} failed before matching a rendezvous send "
                f"(cause: {state.cause_of(dest)})",
                failed_ranks=state.failed(),
            )
        if exc is not None and req.complete_error(exc):
            self._release_parked_sends(req)

    def _release_parked_sends(self, req) -> None:
        """Drop any parked rendezvous entry pinned for ``req``: a
        poisoned/abandoned send's payload must neither stay pinned for
        the universe lifetime nor be delivered by a LATE CTS carrying
        the caller's post-failure mutations (the _CTS handler treats a
        released id as a no-op)."""
        with self._lock:
            dead = [k for k, entry in self._pending_rndv.items()
                    if entry[1] is req]
            for k in dead:
                del self._pending_rndv[k]

    # -- receives --------------------------------------------------------

    def irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              cid: int = 0, poll: bool = False) -> Request:
        """MPI_Irecv.  On an ft universe the request is failure-aware:
        classification (revoked cid, named dead source, ANY_SOURCE
        pending semantics) completes it ERRORED — typed, from the
        waiter's progress tick, mirroring the wire plane's SendRequest
        path — so a waitall parked on a corpse observes ``ProcFailed``
        at completion instead of wedging; a message matched after
        classification re-enters the engine for a retry (the
        abandoned/re-inject contract of ``recv``)."""
        state = self.universe.ft_state
        if state is None:
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

        abandoned = [False]
        # delivery may land from the SENDER's progress thread (the
        # rendezvous CTS handoff): the abandon decision must serialize
        # with it, the same lock discipline _ft_recv applies
        abandon_lock = threading.Lock()
        box: list[Request] = []

        def deliver(env: Envelope, payload: Any) -> None:
            with abandon_lock:
                if abandoned[0]:
                    self.engine.incoming(env, payload)
                    return
                box[0].complete(payload, source=env.src, tag=env.tag)

        def on_match_ft(env: Envelope, payload: Any) -> None:
            if isinstance(payload, _RndvToken):
                def handoff(data, env=env):
                    deliver(env, data)

                self.universe.contexts[payload.sender_rank].mailbox.put(
                    (_CTS, payload.rndv_id, self.rank, handoff)
                )
            else:
                deliver(env, payload)

        def prog() -> None:
            self.progress()
            req = box[0]
            if req.done:
                return
            exc = ulfm.classify_recv_failure(state, source, cid)
            if exc is None:
                return
            # final drain: the dead rank's last messages may already
            # sit in our mailbox — death must not eat delivered data
            self.progress()
            with abandon_lock:
                if req.done:
                    return
                abandoned[0] = True
            req.complete_error(exc)

        box.append(Request(
            progress=prog,
            dispatch=None if poll else self.call_errhandler,
        ))
        self.engine.post_recv(source, tag, cid, on_match_ft)
        return box[0]

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             cid: int = 0, timeout: float | None = None,
             return_status: bool = False, poll: bool = False):
        """MPI_Recv.  On an ft-enabled universe a receive blocked on a
        dead rank raises typed ``ProcFailed`` (named source) or
        ``ProcFailedPending`` (ANY_SOURCE with an unacknowledged
        failure) through the errhandler disposition, instead of hanging
        until the run's deadlock timeout — callers can distinguish stall
        from death.  ``poll=True`` marks a framework-internal receive:
        classification raises directly, bypassing the disposition."""
        if self.universe.ft_state is not None:
            return self._ft_recv(source, tag, cid, timeout,
                                 return_status, poll)
        trecv = None
        if ztrace.active and not poll:
            trecv = ztrace.begin(ztrace.RECV, self.rank, src=source,
                                 tag=tag, cid=cid)
        req = self.irecv(source, tag, cid)
        value = req.wait(timeout)
        if trecv is not None:
            # the matched envelope, not the posted wildcard: a span
            # recording src=-1 forever would lie to the merged timeline
            trecv.end(src=req.status.source, tag=req.status.tag)
        if return_status:
            return value, req.status
        return value

    def _ft_classify(self, source: int, cid: int
                     ) -> errors.MpiError | None:
        """Typed failure for a receive that cannot complete, or None."""
        return ulfm.classify_recv_failure(self.universe.ft_state,
                                          source, cid)

    def _ft_recv(self, source: int, tag: int, cid: int,
                 timeout: float | None, return_status: bool, poll: bool):
        """Receive with live-failure classification.  Delivery runs only
        from this rank's own progress() (single-threaded), so the
        abandoned/re-inject contract needs no extra locking: a message
        matched after classification re-enters the engine for a retry
        (e.g. after failure_ack)."""
        import time

        box: list[Any] = []
        envs: list[Envelope] = []
        done = threading.Event()
        abandoned = [False]
        # eager delivery is single-threaded (this rank's progress()),
        # but a rendezvous CTS handoff completes on the SENDER's
        # progress thread — the abandon decision must serialize with
        # delivery or a payload landing in the classification window is
        # consumed yet neither returned nor re-injected (silent loss)
        abandon_lock = threading.Lock()

        def deliver(env: Envelope, payload: Any) -> None:
            with abandon_lock:
                if abandoned[0]:
                    self.engine.incoming(env, payload)
                    return
                box.append(payload)
                envs.append(env)
                done.set()

        def on_match(env: Envelope, payload: Any) -> None:
            if isinstance(payload, _RndvToken):
                def handoff(data, env=env):
                    deliver(env, data)

                self.universe.contexts[payload.sender_rank].mailbox.put(
                    (_CTS, payload.rndv_id, self.rank, handoff)
                )
            else:
                deliver(env, payload)

        exc: errors.MpiError | None = None
        trecv = None
        if ztrace.active and not poll:
            trecv = ztrace.begin(ztrace.RECV, self.rank, src=source,
                                 tag=tag, cid=cid)
        self.engine.post_recv(source, tag, cid, on_match)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while not done.is_set():
            self.progress()
            if done.is_set():
                break
            exc = self._ft_classify(source, cid)
            if exc is None and deadline is not None \
                    and time.monotonic() > deadline:
                exc = errors.InternalError(
                    f"recv timeout (src={source}, tag={tag}, cid={cid})"
                )
            if exc is not None:
                # final drain: the dead rank's last messages may already
                # sit in our mailbox — death must not eat delivered data
                self.progress()
                with abandon_lock:
                    if done.is_set():
                        exc = None
                    else:
                        abandoned[0] = True
                break
            done.wait(0.0005)
        if exc is not None:
            if poll:
                raise exc
            return self.call_errhandler(exc)
        value, env = box[0], envs[0]
        if trecv is not None:
            trecv.end(src=env.src, tag=env.tag)
        if return_status:
            return value, Status(
                source=env.src, tag=env.tag,
                count_bytes=_payload_bytes(value),
            )
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
        :func:`mrecv` on the returned handle (thread-safe hand-off, the
        reason mprobe exists)."""
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
        """MPI_Send_init: persistent send (reference: pml start interface,
        ompi/mca/pml/pml.h:491-528's pml_start)."""
        return PersistentRequest(lambda: self.isend(obj, dest, tag, cid))

    def recv_init(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                  cid: int = 0):
        """MPI_Recv_init: persistent receive."""
        return PersistentRequest(lambda: self.irecv(source, tag, cid))

    def sendrecv(self, obj: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG, cid: int = 0):
        """MPI_Sendrecv.  On an ft universe the receive side runs the
        classified path, so a partner that dies mid-exchange surfaces
        typed ProcFailed instead of wedging the wait — collectives built
        over sendrecv (ring allgather et al.) inherit failure delivery.

        The SEND side is observed too (ZL001): a rendezvous send still
        parked when the recv returns pins the caller's object in
        ``_pending_rndv`` — returning without waiting it breaks the
        buffer-reuse contract (the receiver would see post-return
        mutations), and a discarded request's outcome can never be
        seen.  On the ft path the wait classifies: a send partner that
        dies before matching surfaces through the errhandler
        disposition instead of wedging (dest and source may be
        DIFFERENT ranks in a ring shift — the recv completing proves
        nothing about dest's liveness)."""
        state = self.universe.ft_state
        if state is not None:
            sreq = self.isend(obj, dest, sendtag, cid)
            try:
                value = self.recv(source, recvtag, cid)
            except BaseException as e:
                # the exchange is dead (the classified recv raised):
                # this caller will never observe the send's outcome —
                # release its parked payload (no pin, no late CTS
                # delivering post-failure mutations) and mark it
                # terminal before re-raising
                self._release_parked_sends(sreq)
                sreq.complete_error(errors.ProcFailed(
                    f"sendrecv aborted by its receive side: {e}",
                    failed_ranks=state.failed(),
                ))
                raise
            while not sreq.done:
                self.progress()  # the rendezvous CTS handoff rides
                if sreq.done:    # OUR mailbox — progress must tick
                    break
                # classify BOTH poisons, mirroring isend's issue-time
                # checks: a dead partner never CTSes, and a revoke
                # makes the live partner's classified recv abandon
                # without CTSing — either way this park can never
                # complete on its own
                exc = None
                if state.is_revoked(cid):
                    exc = errors.Revoked(
                        f"send on revoked cid={cid}", cid=cid)
                elif state.is_failed(dest):
                    exc = errors.ProcFailed(
                        f"rank {dest} failed before matching "
                        f"sendrecv's send",
                        failed_ranks=state.failed(),
                    )
                if exc is not None:
                    poisoned = sreq.complete_error(exc)
                    # drop the parked payload either way: a corpse
                    # never CTSes (the pin would last forever) and a
                    # revoked-but-live partner's late CTS must not
                    # ship post-raise buffer mutations
                    self._release_parked_sends(sreq)
                    if poisoned:
                        self.call_errhandler(exc)
                    break
                sreq._done.wait(0.002)
            if sreq.error is None:
                sreq.wait()
            return value
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
            # a zero-byte send is always eager (born-complete), but the
            # request is still observed: an issue-time classification
            # (known-failed dest on an ft universe) must not vanish
            sreq = self.isend(b"", dest, tag=0x7FFF - 1, cid=0x7FFF)
            rreq.wait()
            sreq.wait()
            k <<= 1


# Live-universe tracking for the queue-depth readers (checkpoint
# quiescence, the MPI_T pvars of tools/mpit.py).  Weak references:
# readers must observe universes, not keep them alive.
_live_universes: weakref.WeakSet = weakref.WeakSet()


def _queue_depth(key: str, exempt_acked_failed: bool = False) -> int:
    """Aggregate queue depth across live universes.  With
    ``exempt_acked_failed`` (the checkpoint quiescence view), rows
    attributable to acknowledged-failed ranks are left out — the dead
    rank's own queues (it can never drain them), posted receives NAMED
    on it (abandoned by the typed-failure classification), and
    unexpected messages FROM it (rolled back, not drained) — and so are
    rows parked on REVOKED cids: a revoked channel never delivers again
    (recv on it raises ``Revoked``), so a schedule aborted by
    revocation must not wedge quiescence for the rest of the job's
    life.  Otherwise a checkpoint during recovery could never be
    declared quiescent."""
    total = 0
    for uni in list(_live_universes):
        state = uni.ft_state if exempt_acked_failed else None
        dead = state.acked() if state is not None else frozenset()
        revoked = state.revoked_cids() if state is not None else frozenset()
        for c in uni.contexts:
            if c.rank in dead:
                continue
            if dead or revoked:
                total += c.engine.stats_excluding(dead, revoked)[key]
            else:
                total += c.engine.stats()[key]
    return total


_pvars_registered = False


def _register_queue_pvars() -> None:
    global _pvars_registered
    if _pvars_registered:
        return
    from ..tools import mpit

    mpit.register_pvar(
        "pt2pt_posted_recvs", lambda: _queue_depth("posted"),
        klass=mpit.PVAR_STATE,
        description="posted receives across all live universes",
    )
    mpit.register_pvar(
        "pt2pt_unexpected_msgs", lambda: _queue_depth("unexpected"),
        klass=mpit.PVAR_STATE,
        description="unexpected-queue depth across all live universes",
    )
    _pvars_registered = True


class LocalUniverse:
    """N thread-ranks on one host (btl/self+sm analog).

    ``ft=True`` arms the ULFM machinery: a shared
    :class:`~zhpe_ompi_tpu_torch.ft.ulfm.FailureState`, a heartbeat board the
    ring detector reads, typed failure delivery from ``recv``, and
    tolerant ``run`` semantics (a rank killed by the fault-injection
    harness does not abort the surviving ranks' run)."""

    def __init__(self, size: int, ft: bool = False):
        if size < 1:
            raise errors.ArgError("size must be >= 1")
        self.size = size
        self.ft_state = ulfm.FailureState(size) if ft else None
        self.ft_board = ulfm.HeartbeatBoard(size) if ft else None
        self.ft_detectors: list[ulfm.RingDetector] = []
        self.contexts = [RankContext(self, r) for r in range(size)]
        _live_universes.add(self)
        _register_queue_pvars()

    def close(self) -> None:
        """Drop this universe from the live set the queue-depth readers
        walk (the port's explicit teardown; the namesake relies on the
        weak set alone)."""
        _live_universes.discard(self)

    # -- failure detection (ULFM ring detector over the beat board) ------

    def start_failure_detector(self, period: float | None = None,
                               timeout: float | None = None) -> None:
        """Start one ring-detector daemon thread per rank (requires
        ft=True).  Callers own shutdown via stop_failure_detector —
        test fixtures must not leak heartbeat threads."""
        if self.ft_state is None:
            raise errors.UnsupportedError(
                "failure detector needs a universe built with ft=True"
            )
        if self.ft_detectors:
            return
        for r in range(self.size):
            det = ulfm.RingDetector(
                r, self.size, self.ft_state,
                transport=ulfm.BoardTransport(self.ft_board, r),
                muted=(lambda r=r: self.ft_board.is_dead(r)),
                period=period, timeout=timeout,
                name=f"hb-uni-{id(self) & 0xFFFF:x}-{r}",
            )
            det.start()
            self.ft_detectors.append(det)

    def stop_failure_detector(self) -> None:
        for det in self.ft_detectors:
            det.stop()
        self.ft_detectors = []

    # -- respawn (grow back to full size after a failure) ----------------

    def respawn_rank(self, rank: int) -> RankContext:
        """Replace a failed rank's universe slot with a FRESH context —
        the MPI_Comm_spawn blocking-recovery idiom on the thread plane.
        The fresh context gets a new mailbox and matching engine (no
        stale pre-death frames can ever match its receives) and adopts a
        survivor's collective/agreement sequence counters, so its next
        collective on the full-size surface tags identically to the
        survivors'.  The failure record is cleared LAST (after the slot
        swap), so a survivor released by ``wait_restored`` can only ever
        see the replacement context."""
        if self.ft_state is None:
            raise errors.UnsupportedError(
                "respawn needs a universe built with ft=True"
            )
        if not 0 <= rank < self.size:
            raise errors.RankError(f"rank {rank} out of range")
        if not self.ft_state.is_failed(rank):
            raise errors.ArgError(
                f"rank {rank} is not failed; nothing to respawn"
            )
        fresh = RankContext(self, rank)
        donor = next(
            (self.contexts[r] for r in self.ft_state.live() if r != rank),
            None,
        )
        if donor is not None:
            fresh._coll_seq = getattr(donor, "_coll_seq", 0)
            fresh._agree_seq = getattr(donor, "_agree_seq", 0)
        self.contexts[rank] = fresh
        if self.ft_board is not None:
            self.ft_board.revive(rank)
        self.ft_state.restore(rank)
        return fresh

    def run(self, fn: Callable[[RankContext], Any], timeout: float = 60.0
            ) -> list[Any]:
        """SPMD-launch fn(ctx) on every rank thread; returns per-rank
        results; re-raises the first rank exception.  Under ft=True a
        rank's exit is recorded in the failure state (receivers blocked
        on it classify ProcFailed), and RankKilled — injected death — is
        an expected outcome, not a run failure."""
        results: list[Any] = [None] * self.size
        excs: list[BaseException | None] = [None] * self.size

        def runner(r):
            try:
                results[r] = fn(self.contexts[r])
            except BaseException as e:  # noqa: BLE001 - propagated below
                excs[r] = e
            finally:
                if self.ft_state is not None:
                    if self.ft_board is not None:
                        self.ft_board.kill(r)
                    e = excs[r]
                    if isinstance(e, ulfm.RankKilled):
                        # "mute" deaths are left for the detector to
                        # discover (the hang/partition scenario)
                        if e.mode != "mute":
                            self.ft_state.mark_failed(r, cause="killed")
                    else:
                        self.ft_state.mark_failed(
                            r, cause="exit" if e is None else "crash"
                        )

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
            if e is not None and not (
                self.ft_state is not None
                and isinstance(e, ulfm.RankKilled)
            ):
                # an injected death is an expected outcome only when the
                # universe is ft-armed; on a plain universe nothing
                # records it, so swallowing it would report success on a
                # run that never completed
                raise e
        if self.ft_state is not None:
            # end-of-run "exit" marks exist so receivers blocked on an
            # already-finished rank classify ProcFailed MID-run; once
            # the job is over a clean exit is not a process failure —
            # forget it, so the universe is reusable for another run.
            # Killed/crashed ranks stay failed (recovery owns them).
            for r in range(self.size):
                if excs[r] is None and self.ft_state.cause_of(r) == "exit":
                    self.ft_state.restore(r)
                    if self.ft_board is not None:
                        self.ft_board.revive(r)
        return results
