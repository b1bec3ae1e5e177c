"""TCP transport — the btl/tcp analog of the host plane (namesake:
``zhpe_ompi_tpu/pt2pt/tcp.py``; the port's own copy).

The reference reaches remote nodes through ``opal/mca/btl/tcp`` (endpoint
address exchange via the modex, a listening socket per proc, lazy
connection establishment, length-framed sends drained by the progress
engine).  This module is that wire for the port's host plane:

- **modex**: rank 0 is the rendezvous point (the PMIx server analog);
  every rank connects, publishes its listen address, and receives the
  address book (cf. the business-card exchange in ompi_mpi_init.c:667).
- **endpoints**: one listening socket per proc, full-mesh connections
  established lazily on first send and cached (btl_tcp_endpoint.c shape).
- **framing**: 4-byte length + DSS-packed (src, tag, cid, seq, payload);
  contiguous arrays and CPU tensors leave as out-of-band memoryview
  segments of the caller's buffers (``tcp_zero_copy_min``), and payloads
  above ``tcp_eager_limit`` (1 MiB) take the RTS/CTS rendezvous over a
  dedicated data connection.  The frames are the namesake's byte for
  byte, so port and JAX-package ranks share one universe.
- **matching**: incoming frames feed the same matching engine the local
  universe uses.
- **selection**: per-peer transport dispatch at the send seam — self →
  sm → tcp: rank-to-self takes the loopback shortcut, a same-boot peer
  that advertised a shared-memory segment rides the mmap ring
  (``pt2pt/sm.py``, chosen while ``sm_priority`` exceeds
  ``tcp_priority``), everything else — remote hosts, ``sm=0`` peers —
  rides the sockets.  A peer that advertised a segment this rank cannot
  ride (another boot id, an unmappable segment) degrades loudly: every
  such send counts in ``sm_fallback_tcp_sends`` and the ``btl_tcp``
  stream says why (an unmappable segment always, a boot mismatch at
  verbosity 2).  An ``sm=0`` peer advertises nothing: its TCP is
  intended and not counted, as in the namesake.  The ``sm`` MCA var
  defaults to 1, as in the namesake; ``sm_boot_id``/``sm_numa_id`` pin
  the locality a rank advertises (emulated hosts and NUMA domains for
  the han layer).
- **payloads**: host payloads only.  A tensor on any device but the CPU
  given to ``send``/``isend`` raises dss's typed ``TypeError_`` (naming
  the ``.cpu()`` to make) before any frame or ring slot is written;
  nothing here copies a tensor to the host.
- **fault tolerance** (``ft=True``, ``ft/ulfm.py``): the ring heartbeat
  detector over framed beats, the ULFM control family (``FT_*_CID``
  frames: heartbeats, failure notices, revokes, agreement results,
  goodbyes, JOIN re-modex) flooded over a log-degree overlay, typed
  ``ProcFailed``/``Revoked`` classification on every send, receive and
  deferred request, ``sever``/``mute`` (the fault-injection hooks) and a
  respawned rank's rejoin from an explicit ``rejoin_book``.  On the sm
  plane a stopped ring consumer is peer death, the death listener unmaps
  the ring, the orderly goodbye rides the ring after every data frame,
  and a rejoiner's card is scrubbed (it rides TCP).

``TcpProc`` mirrors :class:`~zhpe_ompi_tpu_torch.pt2pt.universe
.RankContext`'s API (send/recv/probe/sendrecv/barrier and the host and
nonblocking collectives).

- **the PMIx store** (``runtime/pmix.py``): ``pmix=``/``namespace=``
  run the modex through the store (``card:<rank>`` put, commit, fence,
  get), ``rejoin=True`` re-modexes a respawned rank from the store at
  the recovery window's generation, elastic ``live_ranks`` start a
  proper subset of the slots, and ``metrics``/``trace`` publish
  snapshots and span buffers there through ``spc.MetricsPublisher``
  (an explicit ``True`` without a store raises ``ArgError``; the
  ``ZMPI_METRICS``/``ZMPI_TRACE`` environment requests degrade loudly).

- **the intercomm and one-sided seams**: ``bridge_endpoint``/
  ``bridge_send`` carry ``comm/dpm_wire.py``'s cross-group frames;
  ``sm_rma_region``/``sm_release_region``/``sm_direct_to`` give
  ``osc/direct.py`` its region files and its per-peer direct decision.

The first proc up registers the MPI_T state pvars ``tcp_posted_recvs``/
``tcp_unexpected_msgs`` (``tools/mpit.py``) over :func:`_wire_queue_depth`.
"""


from __future__ import annotations

import collections
import itertools
import os
import queue
import random
import socket
import struct
import threading
import time
import weakref
from typing import Any

import numpy as np
import torch

from ..coll.host import HostCollectives, _han_route
from ..coll.nbc import NonblockingCollectives
from ..core import errhandler as errh
from ..core import errors
from ..ft import ulfm
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..runtime import flightrec
from ..runtime import spc
from ..runtime import ztrace
from ..utils import dss
from ..utils import lockdep
from . import engine_mux
from . import matching
from . import overlay
from . import sm as sm_mod
from .matching import ANY_SOURCE, ANY_TAG, Envelope
from .requests import Request, SendRequest, Status, _payload_bytes

_stream = mca_output.open_stream("btl_tcp")

_LEN = struct.Struct("<I")

mca_var.register(
    "tcp_eager_limit", 1 << 20,
    "Serialized size (bytes) above which TCP sends use RTS/CTS rendezvous "
    "instead of eager delivery (bounds receiver-side unexpected-queue "
    "memory, the ob1 eager_limit contract on the wire plane)",
    type=int,
)
mca_var.register(
    "tcp_zero_copy_min", 0,
    "Array payload size (bytes) at/above which contiguous ndarray "
    "payloads ride the out-of-band zero-copy frame path (dss.pack_frames "
    "memoryview segments over sendmsg); 0 = every contiguous array",
    type=int,
)
mca_var.register(
    "tcp_priority", 20,
    "Endpoint-selection priority of the tcp transport (btl_tcp_priority "
    "shape): a same-host peer rides the shared-memory ring only while "
    "sm_priority exceeds this — raise it above sm_priority to force the "
    "wire path per-pair without tearing the rings down",
    type=int,
)
mca_var.register(
    "tcp_rndv_push_workers", 4,
    "Rendezvous data-push executor threads per proc: a burst of large "
    "sends queues its CTS-released pushes on this bounded pool instead "
    "of spawning one thread per transfer",
    type=int,
)

# category derivation (tools/mpit.py): the wire plane's vars and
# counters — tcp_*, btl_tcp_*, rndv_* — are ONE family
mca_var.register_family("tcp")
mca_var.register_family("btl_tcp", "tcp")
mca_var.register_family("rndv", "tcp")


# sendmsg gathers header+segments in one syscall; platforms without it
# (or a socket object that declines) fall back to sequential sendall
_HAS_SENDMSG = hasattr(socket.socket, "sendmsg")
# stay well under IOV_MAX (typically 1024) per sendmsg call
_IOV_BATCH = 256

# rendezvous control channels (outside the user cid space)
_RNDV_CTS_CID = 0x7FFA
_RNDV_DATA_CID = 0x7FF9
# wire sentinel of an RTS announce (first element of a 4-tuple payload;
# the remaining elements are sender_rank, rndv_id, nbytes)
_RTS_MARK = "__zmpi_rndv_rts__"
# fair-share rendezvous drain: a channel yields its push-pool worker
# after this many items whenever another channel is queued behind it
_PUSH_RR_QUANTUM = 8


# eager/rendezvous switch sizing — the shared estimator (one
# implementation for the transport switch AND the han SPC accounting)
from ..utils.payload import payload_size_estimate as _payload_size  # noqa: E402


def _byte_views(segments) -> list[memoryview]:
    """Normalize a segment list to flat uint8 memoryviews (sendmsg wants
    byte buffers; ndarray data views carry their own shape/format)."""
    views = []
    for seg in segments:
        v = seg if isinstance(seg, memoryview) else memoryview(seg)
        if v.format != "B" or v.ndim != 1:
            v = v.cast("B")
        views.append(v)
    return views


def _send_frame(sock: socket.socket, payload) -> int:
    """Emit one length-framed message from `payload` — bytes, or a
    sequence of buffer segments sent VECTORED via ``socket.sendmsg``
    (no header+body concatenation, no frame-assembly copy; the btl
    iovec discipline).  Returns — and counts in ``tcp_bytes_sent`` —
    the actual on-wire byte total including the 4-byte length header."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        segments = (payload,)
    else:
        segments = payload
    views = _byte_views(segments)
    total = sum(v.nbytes for v in views)
    bufs = [memoryview(_LEN.pack(total))]
    bufs += [v for v in views if v.nbytes]
    if _HAS_SENDMSG:
        while bufs:
            n = sock.sendmsg(bufs[:_IOV_BATCH])
            # advance past what the kernel took (a short write leaves a
            # suffix of the iovec; blocking sockets never return 0)
            while n:
                head = bufs[0]
                if n >= head.nbytes:
                    n -= head.nbytes
                    bufs.pop(0)
                else:
                    bufs[0] = head[n:]
                    n = 0
    else:  # pragma: no cover - every target platform has sendmsg
        for v in bufs:
            sock.sendall(v)
    spc.record("tcp_bytes_sent", total + _LEN.size)
    return total + _LEN.size


def _recv_exact_into(sock: socket.socket, n: int,
                     idle_retry: bool = False) -> bytearray | None:
    """Read exactly n bytes into ONE preallocated writable buffer via
    ``recv_into`` — no accumulate-then-copy; the returned bytearray is
    dedicated to this frame, so dss.unpack_from may alias it."""
    buf = bytearray(n)
    if n == 0:
        return buf
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:])
        except socket.timeout:
            if idle_retry and got == 0:
                # a QUIET connection is not a dead one: the drain's
                # steady state must outlive any socket timeout.  A
                # timeout with PARTIAL bytes read still raises — a peer
                # wedged mid-frame would desync the length framing.
                continue
            raise
        if not k:
            return None
        got += k
    return buf


def _recv_frame(sock: socket.socket,
                idle_retry: bool = False) -> bytearray | None:
    header = _recv_exact_into(sock, _LEN.size, idle_retry=idle_retry)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    body = _recv_exact_into(sock, length)
    if body is not None:
        spc.record("tcp_bytes_recvd", length + _LEN.size)
    return body


class _Backoff:
    """Exponential connect backoff with deterministic per-caller jitter,
    bounded by a total budget — shared by the modex rendezvous and lazy
    endpoint establishment so a slow-starting peer is retried patiently
    (no thundering herd) but never past the deadline."""

    START, CAP = 0.01, 0.5

    def __init__(self, budget: float, seed: int):
        self.stop_at = time.monotonic() + budget
        self.delay = self.START
        self._jitter = random.Random(seed)

    def expired(self, lookahead: float = 0.0) -> bool:
        return time.monotonic() + lookahead >= self.stop_at

    def sleep(self) -> None:
        time.sleep(min(
            self.delay * (0.5 + self._jitter.random()),
            max(0.0, self.stop_at - time.monotonic()),
        ))
        self.delay = min(self.delay * 2, self.CAP)


class _LoopbackFallback(Exception):
    """Payload type outside the fast-copy universe: take the full
    serialize/deserialize cycle (which also owns the error surface for
    unpackable types)."""


def _loopback_copy(obj: Any, _depth: int = 0):
    """Single defensive copy for rank-to-self delivery, with the SAME
    type mapping the DSS round trip applies (tuple stays tuple,
    bytearray lands as bytes, numpy scalars as 0-d arrays) — the
    receiver must see the pre-mutation value even if the sender reuses
    its buffer immediately, but nothing needs to be serialized to
    cross a process boundary that isn't there."""
    if obj is None or isinstance(obj, (bool, str, bytes)):
        return obj  # immutable: by-reference IS value semantics
    if isinstance(obj, float):
        # np.float64 subclasses float and DSS delivers it as plain float
        return obj if type(obj) is float else float(obj)
    if isinstance(obj, int):
        return obj if type(obj) is int else int(obj)  # IntEnum et al.
    if isinstance(obj, bytearray):
        return bytes(obj)
    if isinstance(obj, np.ndarray):
        # ascontiguousarray already materializes a fresh array for
        # non-contiguous input — exactly one copy either way
        return np.ascontiguousarray(obj) \
            if not obj.flags.c_contiguous else obj.copy()
    if isinstance(obj, np.generic):
        return np.asarray(obj).copy()
    if isinstance(obj, torch.Tensor):
        # the DSS round trip of a CPU tensor is a CPU tensor (send()
        # refused every other tensor before reaching here)
        return obj.detach().clone()
    if _depth >= 16:
        raise _LoopbackFallback  # absurd nesting: let dss arbitrate
    if isinstance(obj, (list, tuple)):
        return type(obj)(_loopback_copy(o, _depth + 1) for o in obj)
    if isinstance(obj, dict):
        return {
            _loopback_copy(k, _depth + 1): _loopback_copy(v, _depth + 1)
            for k, v in obj.items()
        }
    raise _LoopbackFallback


def _refuse_device(obj: Any, _depth: int = 0) -> None:
    """Raise dss's typed error for any tensor in ``obj`` (to container
    depth 16) that the wire cannot carry — on a device other than the CPU,
    or of a dtype numpy lacks — before a send writes any frame."""
    if isinstance(obj, torch.Tensor):
        dss.refuse_tensor(obj)
    elif _depth < 16:
        if isinstance(obj, (list, tuple)):
            for o in obj:
                _refuse_device(o, _depth + 1)
        elif isinstance(obj, dict):
            for k, v in obj.items():
                _refuse_device(k, _depth + 1)
                _refuse_device(v, _depth + 1)



class _PushPool:
    """Bounded rendezvous-push executor: CTS-released bulk pushes queue
    here instead of spawning one thread per transfer, so a burst of
    large sends cannot grow the thread count without bound (the
    reference bounds its rndv pipeline by the send-request freelist).
    Workers start lazily up to the cap and exit at close()."""

    def __init__(self, name: str, max_workers: int):
        self._q: queue.Queue = queue.Queue()
        self._threads: list[threading.Thread] = []
        self._lock = lockdep.lock("tcp._PushPool._lock")
        self._idle = 0
        self._closed = False
        self._name = name
        self._max = max(1, max_workers)

    def submit(self, fn) -> None:
        with self._lock:
            if self._closed:
                # post-close CTS (late-matching peer): a one-shot thread
                # completes the transfer — TRACKED, so the leak gate
                # still sees it if it wedges on a dead peer
                t = threading.Thread(
                    target=fn, daemon=True, name=f"{self._name}-late"
                )
                self._threads.append(t)
                t.start()
                return
            self._q.put(fn)
            if self._idle == 0 and len(self._threads) < self._max:
                t = threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"{self._name}-{len(self._threads)}",
                )
                self._threads.append(t)
                t.start()

    def _worker(self) -> None:
        while True:
            with self._lock:
                self._idle += 1
            fn = self._q.get()  # blocking; close() wakes via sentinel
            with self._lock:
                self._idle -= 1
            if fn is None:
                return  # close() sentinel
            try:
                fn()
            # zlint: disable=ZL004 -- _push_rndv catches every escape itself and completes the request errored; this is the worker's don't-die backstop
            except Exception:  # noqa: BLE001 - push_data logs its own
                pass

    def close(self, timeout: float) -> None:
        with self._lock:
            first = not self._closed
            self._closed = True
            threads = list(self._threads)
        if first:
            # one sentinel per worker: each consumes exactly one and
            # exits once the queued pushes ahead of it drain
            for t in threads:
                if t.is_alive():
                    self._q.put(None)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def backlog(self) -> int:
        """Queued-but-unclaimed work items — the fair-share rotation
        reads this: a channel drain yields its worker only when some
        OTHER channel is actually waiting for one."""
        return self._q.qsize()

    def alive_threads(self) -> list[threading.Thread]:
        with self._lock:
            return [t for t in self._threads if t.is_alive()]


# every proc's pool, weakly: the conftest leak gate asserts each pool
# drained at close() without keeping closed procs alive
_live_push_pools: weakref.WeakSet = weakref.WeakSet()


def live_push_threads() -> list[str]:
    """Names of rendezvous-push worker threads still alive across all
    (weakly tracked) procs — the test-suite hygiene gate's view."""
    return [
        t.name
        for pool in list(_live_push_pools)
        for t in pool.alive_threads()
    ]


class _OutChannel:
    """Per-destination deferred-send FIFO — the send side of the
    nonblocking progress engine.  ``isend`` enqueues its work here and
    returns; push-pool workers drain each channel strictly in order, so
    deferred frames to one peer can never reorder among themselves (the
    per-source FIFO the matching engine assumes), and blocking sends
    FENCE on the channel before writing the socket inline (ordering
    across both send paths).  ``draining`` marks the single worker that
    owns the queue; the empty→non-empty transition submits one."""

    __slots__ = ("lock", "queue", "draining")

    def __init__(self):
        self.lock = lockdep.lock("tcp._OutChannel.lock")
        # items: (work, request, finish) — `work()` performs the send;
        # `finish` marks the item whose success completes the request
        # (an RTS item carries its rendezvous request only for the
        # poisoned-while-parked skip; the DATA push completes it)
        self.queue: collections.deque = collections.deque()
        self.draining = False

    def busy(self) -> bool:
        with self.lock:
            return bool(self.queue) or self.draining


# every proc, weakly: the hygiene gate walks CLOSED procs asserting no
# incomplete deferred SendRequest and no orphaned parked-rndv
# descriptor survived teardown (open procs legitimately hold both)
_live_procs: weakref.WeakSet = weakref.WeakSet()


def live_incomplete_send_requests() -> list[str]:
    """Deferred SendRequests still incomplete on CLOSED procs — the
    test-suite hygiene gate's view (close() drains the in-flight set
    bounded, then completes leftovers errored; sever() abandons them
    errored immediately — either way nothing may stay incomplete)."""
    out = []
    for proc in list(_live_procs):
        if not proc._closed.is_set():
            continue
        for req in list(proc._inflight):
            if not req.done:
                out.append(f"rank{proc.rank}: incomplete deferred send")
    return out


def orphaned_rndv_descriptors() -> list[str]:
    """Parked rendezvous descriptors left on CLOSED procs — the gate's
    view of the park table (a descriptor nobody will ever push pins the
    caller's buffers forever)."""
    out = []
    for proc in list(_live_procs):
        if not proc._closed.is_set():
            continue
        with proc._rndv_lock:
            ids = sorted(proc._pending_rndv)
        out += [f"rank{proc.rank}: parked rndv id={i}" for i in ids]
    return out


def _wire_queue_depth(key: str) -> int:
    """Matching-queue depth across every OPEN wire proc in this
    process — the state-pvar twin of universe.py's thread-plane
    readers, so the metrics publisher's snapshot carries live queue
    depths for socket ranks too."""
    total = 0
    for proc in list(_live_procs):
        if proc._closed.is_set():
            continue
        total += proc.engine.stats()[key]
    return total


_wire_pvars_registered = False


def _register_wire_pvars() -> None:
    global _wire_pvars_registered
    if _wire_pvars_registered:
        return
    from ..tools import mpit

    mpit.register_pvar(
        "tcp_posted_recvs", lambda: _wire_queue_depth("posted"),
        klass=mpit.PVAR_STATE,
        description="posted receives across this process's open wire "
                    "procs",
    )
    mpit.register_pvar(
        "tcp_unexpected_msgs", lambda: _wire_queue_depth("unexpected"),
        klass=mpit.PVAR_STATE,
        description="unexpected-queue depth across this process's open "
                    "wire procs",
    )
    _wire_pvars_registered = True


class TcpProc(errh.HasErrhandler, ulfm.UlfmEndpointAPI, HostCollectives,
              NonblockingCollectives):
    """One process's endpoint in a TCP universe of `size` ranks.
    Collectives come from :class:`~zhpe_ompi_tpu_torch.coll.host
    .HostCollectives` and :class:`~zhpe_ompi_tpu_torch.coll.nbc
    .NonblockingCollectives`, so socket-connected ranks
    bcast/allreduce/iallreduce exactly like thread ranks.

    Construction is collective: every rank calls with the same coordinator
    address; rank 0 binds it as the rendezvous socket, the rest connect
    with retry.  `host` is this rank's reachable address.  The namesake's
    keyword arguments are all accepted with its contracts: ``pmix=``
    replaces the coordinator with the store-served modex (see the module
    doc).
    ``sm`` (default: the ``sm`` MCA var, 1) creates this rank's ring
    segment when ``size`` > 1; ``sm_boot_id``/``sm_numa_id`` override the
    host and NUMA-domain tokens its card advertises.  ``ft=True`` arms
    the ULFM machinery (``ft/ulfm.py``): a per-process ``FailureState``,
    the ring heartbeat detector over framed beats, the failure-notice,
    revoke, agreement and goodbye floods, and typed failure delivery on
    every send and receive path; ``rejoin_book`` respawns this rank into
    a running ft job (the JOIN re-modex)."""

    def __init__(self, rank: int, size: int,
                 coordinator: tuple[str, int] = ("127.0.0.1", 0),
                 host: str = "127.0.0.1", timeout: float = 30.0,
                 on_coordinator_bound=None,
                 external_coordinator: bool = False,
                 ft: bool = False,
                 rejoin_book: list | None = None,
                 sm: bool | None = None,
                 sm_boot_id: str | None = None,
                 sm_numa_id: str | None = None,
                 pmix: "tuple[str, int] | str | None" = None,
                 namespace: str = "default",
                 rejoin: bool = False,
                 rejoin_gen: int = 0,
                 rejoin_ranks: "list[int] | None" = None,
                 metrics: bool | None = None,
                 trace: bool | None = None,
                 live_ranks: "list[int] | None" = None):
        if size < 1:
            raise errors.ArgError("size must be >= 1")
        # elastic membership (the DVM resize contract): the universe is
        # `size` slots but only `live_ranks` started — the rest wire up
        # as pre-acknowledged departures (the orderly-BYE state), so
        # collectives ride a shrunken endpoint over the live set and a
        # later grow FT_JOINs an absent slot exactly like a recovery
        # window's replacement
        self._live_ranks: frozenset[int] | None = None
        if live_ranks is not None:
            live = frozenset(int(r) for r in live_ranks)
            if live != frozenset(range(size)):
                if rank not in live:
                    raise errors.ArgError(
                        f"live_ranks must include this rank ({rank})")
                if not live <= frozenset(range(size)):
                    raise errors.ArgError(
                        "live_ranks outside the universe size")
                if pmix is None or not ft:
                    raise errors.ArgError(
                        "elastic membership (live_ranks a proper "
                        "subset) needs the store-served wire-up and "
                        "fault tolerance: pass pmix=(host, port) and "
                        "ft=True (the ZMPI_ELASTIC_LIVE contract)")
                self._live_ranks = live
        # metrics plane: explicit opt-in (ctor arg) or the ZMPI_METRICS
        # environment contract a DVM job launched with metrics=True
        # exports.  Publishing needs a store — an explicit metrics=True
        # without one is a caller contract error, an env-driven request
        # degrades loudly (the env may be fleet-global).
        if metrics is None:
            metrics = os.environ.get("ZMPI_METRICS", "") not in ("", "0")
            env_metrics = True
        else:
            metrics = bool(metrics)
            env_metrics = False
        if metrics and pmix is None:
            if not env_metrics:
                raise errors.ArgError(
                    "metrics=True publishes through the PMIx store: "
                    "pass pmix=(host, port) (the ZMPI_PMIX contract)"
                )
            mca_output.emit(
                _stream,
                "rank %s: ZMPI_METRICS set but no PMIx store to "
                "publish into; metrics plane disabled", rank,
            )
            metrics = False
        self._metrics_on = metrics
        # tracing plane: rides the metrics publisher (the trace buffer
        # publishes as trace:<job>:<rank> next to the snapshots), so
        # trace needs metrics needs a store.  Explicit trace=True
        # without the metrics plane is a caller contract error; the
        # env-driven ZMPI_TRACE request degrades loudly.
        if trace is None:
            trace = os.environ.get("ZMPI_TRACE", "") not in ("", "0")
            env_trace = True
        else:
            trace = bool(trace)
            env_trace = False
        if trace and not metrics:
            if not env_trace:
                raise errors.ArgError(
                    "trace=True publishes span buffers through the "
                    "metrics publisher: pass metrics=True and "
                    "pmix=(host, port) (the ZMPI_TRACE contract)"
                )
            mca_output.emit(
                _stream,
                "rank %s: ZMPI_TRACE set but the metrics plane is off; "
                "tracing plane disabled", rank,
            )
            trace = False
        self._trace_on = trace
        self._metrics_pub: spc.MetricsPublisher | None = None
        if (rejoin_book is not None or rejoin) and not ft:
            raise errors.ArgError(
                "rejoin_book (respawn into an existing job) requires ft=True"
            )
        if rejoin and pmix is None:
            raise errors.ArgError(
                "rejoin=True re-modexes through the name-served PMIx "
                "store: pass pmix=(host, port) (the ZMPI_PMIX contract)"
            )
        # PMIx-served wire-up (runtime/pmix.py): the modex rides
        # put/commit/fence/get verbs against a resident server instead of
        # the per-job rendezvous coordinator, and a respawned rank
        # (rejoin=True) fetches the name-served address book from the
        # same store — no in-process survivor handoff.
        if isinstance(pmix, str):
            pmix_host, pmix_port = pmix.rsplit(":", 1)
            pmix = (pmix_host, int(pmix_port))
        self._pmix_addr: tuple[str, int] | None = \
            (pmix[0], int(pmix[1])) if pmix is not None else None
        self._pmix_ns = str(namespace)
        # batched-recovery window metadata (ZMPI_REJOIN_GEN/_RANKS): the
        # ranks respawned ALONGSIDE us this window, whose store cards we
        # must read at the window's bumped generation — the corpse's
        # generation-old card would satisfy a plain get and strand both
        # replacements dialing each other's dead addresses
        self._rejoin_gen = int(rejoin_gen)
        self._rejoin_ranks = frozenset(
            int(r) for r in (rejoin_ranks or ()))
        self.rank = rank
        self.size = size
        # ULFM state precedes the accept loop: drain threads consult it
        self.ft_state = ulfm.FailureState(size) if ft else None
        self._ft_dead = False
        self._detector: ulfm.RingDetector | None = None
        self.engine = matching.make_matching_engine()
        self._seq = itertools.count()
        self._rndv_ids = itertools.count(1)
        # rndv_id -> parked data-frame segments.  send() parks COPIES
        # (its buffer-reuse contract holds at return); isend parks the
        # DESCRIPTOR — the caller's own buffers, pinned by the
        # SendRequest until the CTS-released push completes.
        self._pending_rndv: dict[int, list] = {}
        # rndv_id -> (dest, SendRequest-or-None): who the transfer is
        # for (peer death poisons it) and which request its push
        # completes (None for blocking sends)
        self._rndv_meta: dict[int, tuple[int, Any]] = {}
        # rndv_id -> parent send-span sid, populated only while the
        # tracing plane is armed
        self._rndv_trace: dict[int, int] = {}
        self._rndv_lock = lockdep.lock("tcp.TcpProc._rndv_lock")
        # deferred-send progress engine: per-destination FIFO channels
        # drained by the push-pool workers, plus the in-flight request
        # registry the hygiene gate inspects after close()
        self._out_channels: dict[int, _OutChannel] = {}
        self._out_lock = lockdep.lock("tcp.TcpProc._out_lock")
        self._inflight: weakref.WeakSet = weakref.WeakSet()
        self._push_pool = _PushPool(
            f"rndv-push-{rank}",
            int(mca_var.get("tcp_rndv_push_workers", 4)),
        )
        _live_push_pools.add(self._push_pool)
        # ONE multiplexed channel engine per proc reads the listener and
        # every connection; created with the listener below
        self._chan_engine: engine_mux.ChannelEngine | None = None
        self._flood_threads: list[threading.Thread] = []
        self._flood_lock = lockdep.lock("tcp.TcpProc._flood_lock")
        self._dup_conns: list[socket.socket] = []  # crossed-connect extras
        self._timeout = timeout
        self._conns: dict[int, socket.socket] = {}
        self._conn_lock = lockdep.lock("tcp.TcpProc._conn_lock")
        # guards the per-socket lock registry only
        self._send_lock = lockdep.lock("tcp.TcpProc._send_lock")
        self._sock_locks: weakref.WeakKeyDictionary = \
            weakref.WeakKeyDictionary()  # socket -> its framing lock
        self._closed = threading.Event()
        self._torn_down = False  # close() ran (sever() only sets _closed)
        self._incoming_cv = threading.Condition()
        _live_procs.add(self)
        # shared-memory plane (btl/sm analog): create OUR inbound-ring
        # segment before the modex so the card advertises a segment that
        # already exists — a peer that got the book maps it with no
        # handshake and no transport-switch reordering window.  Respawned
        # (rejoin) ranks stay TCP (the "spawn joins stay TCP" cohort
        # contract): survivors scrub the joiner's card
        self._sm_seg: sm_mod.SmSegment | None = None
        self._sm_senders: dict[int, sm_mod.SmSender | None] = {}
        self._sm_declined: set[int] = set()  # advertised sm, not ridden
        self._sm_lock = lockdep.lock("tcp.TcpProc._sm_lock")
        self._sm_boot = sm_boot_id or sm_mod.boot_token()
        # NUMA-domain token: constructor override for per-rank emulation,
        # else the sm_numa_id MCA var / sysfs derivation — advertised next
        # to the pyshm card item
        self._sm_numa = (
            str(sm_numa_id).strip().replace(":", "_")[:64]
            if sm_numa_id else sm_mod.numa_token()
        )
        sm_on = bool(int(mca_var.get("sm", 1))) if sm is None else bool(sm)
        if sm_on and size > 1 and rejoin_book is None and not rejoin:
            try:
                self._sm_seg = sm_mod.SmSegment(
                    rank, size, on_frame=self._sm_incoming
                )
            except OSError as e:
                mca_output.emit(
                    _stream,
                    "rank %s: sm segment unavailable (%s); host plane "
                    "degrades to TCP", rank, e,
                )
        # rejoin handshake state: survivor JOIN_ACKs carrying their
        # collective/agreement counters + crash epoch (see _announce_join)
        self._join_cv = threading.Condition()
        self._join_acks: dict[int, tuple[int, int, int]] = {}

        try:
            # listening socket (btl_tcp's per-proc endpoint)
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((host, 0))
            self._listener.listen(size + 4)
            self.address = self._listener.getsockname()

            self._chan_engine = engine_mux.ChannelEngine(f"tcp-r{rank}")
            self._chan_engine.add_listener(self._listener,
                                           self._on_accept)
            self._chan_engine.start()

            # modex: address-book exchange through the coordinator.
            # `on_coordinator_bound(addr)` fires on rank 0 after the
            # rendezvous socket is bound but BEFORE the blocking gather —
            # the hook a launcher uses to forward an ephemeral coordinator
            # address to the other ranks.
            self._on_coordinator_bound = on_coordinator_bound
            # external_coordinator: a launcher hosts the rendezvous —
            # rank 0 joins as a client instead of binding it itself
            self._external_coordinator = external_coordinator
            if rejoin and rejoin_book is None:
                # name-served rejoin: the survivors' cards live in the
                # job's PMIx namespace — fetch the book from the store
                # and publish OUR fresh endpoint (generation-tagged: the
                # daemon bumped the namespace generation when it opened
                # this recovery window, so the new card is provably not
                # the corpse's)
                rejoin_book = self._pmix_rejoin_book(timeout)
            if rejoin_book is not None:
                # respawned rank: no modex rendezvous exists anymore —
                # adopt the survivors' address book with OUR fresh
                # endpoint in the old slot; the JOIN announce below
                # re-modexes the survivors.  Only the (host, port)
                # prefix is adopted: the survivors' pre-crash sm cards
                # point at rings whose peer half died with the old
                # incarnation, and rejoiners ride TCP anyway.
                self._peer_cards = [list(a[:2]) for a in rejoin_book]
                self.address_book = [tuple(a[:2]) for a in rejoin_book]
                self.address_book[rank] = tuple(self.address)
            elif self._pmix_addr is not None:
                self.address_book = self._modex_pmix(timeout)
            else:
                self.address_book = self._modex(coordinator, timeout)
            if self._live_ranks is not None:
                # absent slots are pre-acknowledged departures from the
                # first moment: named traffic to them classifies typed,
                # the detector ring skips them, shrink excludes them —
                # and a grow's FT_JOIN restores them like any rejoiner
                for r in range(size):
                    if r != rank and r not in self._live_ranks:
                        self.ft_state.mark_departed(r)
            mca_output.verbose(
                5, _stream, "rank %d up at %s; book=%s", rank, self.address,
                self.address_book,
            )
            _register_wire_pvars()
            if self._metrics_on:
                # rank-side metrics publisher: periodic generation-
                # tagged snapshots into the job's namespace, final
                # flush at close() — started after the modex so the
                # namespace provably exists
                self._metrics_pub = spc.MetricsPublisher(
                    self._pmix_addr, self._pmix_ns, rank,
                    trace=self._trace_on)
                self._metrics_pub.start()
            if ft:
                # peer death ⇒ ring teardown: the sm transport unmaps its
                # ring into a corpse the moment classification learns of
                # it (detector, transport error, notice flood, goodbye)
                self.ft_state.add_failure_listener(self._sm_peer_dead)
                # peer death ⇒ typed completion of every parked isend
                # toward it (queued frames AND parked rndv descriptors):
                # a waitall must observe ProcFailed, never wedge
                self.ft_state.add_failure_listener(self._fail_inflight)
                if self._metrics_pub is not None:
                    # typed classification ⇒ this survivor's flight-
                    # recorder window ships to the store (the FT_CLASS
                    # event is already the ring's tail: FailureState
                    # records before it notifies listeners)
                    self.ft_state.add_failure_listener(
                        self._metrics_pub.on_classification)
                if rejoin_book is not None:
                    # announce BEFORE the detector starts: beats toward a
                    # survivor that has not yet swapped in the fresh
                    # endpoint would ride (and warm) a stale address
                    self._announce_join(timeout)
                # ring heartbeat detector over framed beats: this rank
                # emits to its nearest live predecessor, observes its
                # nearest live successor, floods suspicion
                self._detector = ulfm.RingDetector(
                    rank, size, self.ft_state,
                    transport=ulfm.WireTransport(rank, size, self._ft_emit),
                    flood=self._ft_flood,
                    muted=lambda: self._ft_dead,
                    name=f"hb-tcp-{rank}",
                )
                self._detector.start()
        except BaseException:
            # a proc that never finished wiring up still owns a reader
            # thread (and, on ft, a JOIN or detector), and nobody will
            # ever call close() on a constructor that raised — the
            # zero-leak lifecycle contract is honored HERE, whichever
            # construction step failed
            if self._metrics_pub is not None:
                self._metrics_pub.stop()
                self._metrics_pub = None
            if self._detector is not None:
                self._detector.stop()
            if self._chan_engine is not None:
                self._chan_engine.close(1.0)
            self._push_pool.close(0.0)
            self._closed.set()
            if self._sm_seg is not None:
                self._sm_seg.close()
            raise

    def _frame_objs(self, tag: int, cid: int, seq: int, obj: Any,
                    tctx: "tuple[int, int, int] | None"
                    ) -> tuple:
        """The DSS frame-header values of one data frame.  While the
        tracing plane is armed (``tctx`` non-None) the compact
        ``(trace_id, parent_sid, seq)`` context rides as an OPTIONAL
        sixth value — receivers parent their deliver span on it; with
        tracing off the frame is the unchanged five-value shape, zero
        bytes of trace overhead on the wire (the A/B contract the OSU
        ``--trace`` row gates)."""
        if tctx is None:
            return (self.rank, tag, cid, seq, obj)
        # the header growth is the context's own encoding (pack() adds
        # one count varint byte for the single extra value)
        spc.record("trace_wire_context_bytes", len(dss.pack(tctx)) - 1)
        return (self.rank, tag, cid, seq, obj, tctx)

    def _trace_ingest(self, vals: list, transport: str) -> None:
        """Receiver half of the wire-propagated trace context: a
        six-value frame parents a DELIVER span (or, for a rendezvous
        RTS announce, the receiver-side CTS leg) on the sender's send
        span.  Malformed foreign contexts degrade silently — a drain
        loop must never raise over an optional tool field."""
        if len(vals) <= 5 or not ztrace.active:
            return
        ctx = ztrace.parse_wire_context(vals[5])
        if ctx is None:
            return
        src, tag, cid, _seq, payload = vals[:5]
        is_rts = (isinstance(payload, tuple) and len(payload) == 4
                  and payload[0] == _RTS_MARK)
        ztrace.instant(
            ztrace.CTS if is_rts else ztrace.DELIVER, self.rank,
            parent=ctx[1], trace=ctx[0], src=int(src), tag=int(tag),
            cid=int(cid), seq=int(ctx[2]), transport=transport,
        )

    def _framed_send(self, sock: socket.socket, frame) -> None:
        """Frames must not interleave on ONE socket, but independent
        sockets must not serialize behind each other — above all for the
        heartbeat path: a data send blocked on a wedged peer holding a
        global lock would starve this rank's own beats and get it
        falsely suspected.  Per-socket granularity is the contract.
        `frame` is bytes or a segment sequence (vectored framing)."""
        with self._send_lock:
            lock = self._sock_locks.get(sock)
            if lock is None:
                lock = self._sock_locks[sock] = lockdep.lock(
                    "tcp.TcpProc._sock_framing_lock")
        with lock:
            _send_frame(sock, frame)

    # -- shared-memory plane (btl/sm analog) ----------------------------

    def _sm_tx(self, dest: int) -> sm_mod.SmSender | None:
        """Per-peer transport selection, memoized: the sm ring when the
        peer advertised a same-boot segment AND sm outranks tcp
        (``sm_priority > tcp_priority``, the btl priority ladder), else
        None (TCP).  The decision is made ONCE per peer — a direction
        is all-ring or all-wire, so per-source FIFO needs no cross-
        transport sequence numbers."""
        if self._sm_seg is None:
            return None
        try:
            with self._sm_lock:
                if dest in self._sm_senders:
                    return self._sm_senders[dest]
                sender = self._sm_activate(dest)
                self._sm_senders[dest] = sender
                return sender
        except sm_mod.ConsumerStopped as e:
            # first contact raced the peer's sever/close: a STOPPED
            # consumer is never coming back.  On an ft proc that is peer
            # DEATH (the sm twin of connection reset), classified OUTSIDE
            # _sm_lock: the death listener (_sm_peer_dead) re-takes it.
            # Without fault tolerance the pair degrades to TCP loudly.
            with self._sm_lock:
                self._sm_senders[dest] = None  # pinned to TCP
            if self.ft_state is not None:
                mca_output.verbose(
                    5, _stream,
                    "rank %s: first contact found rank %s's ring "
                    "consumer stopped (%s): classifying peer death",
                    self.rank, dest, e,
                )
                self._mark_transport_death(dest)
            else:
                mca_output.emit(
                    _stream,
                    "rank %s: sm segment of rank %s already stopped "
                    "(%s); pair degrades to TCP", self.rank, dest, e,
                )
                self._sm_declined.add(dest)
            return None

    def _sm_activate(self, dest: int) -> sm_mod.SmSender | None:
        if int(mca_var.get("sm_priority", 90)) <= \
                int(mca_var.get("tcp_priority", 20)):
            return None  # policy, not degradation: nothing to count
        cards = getattr(self, "_peer_cards", None)
        if cards is None or dest >= len(cards):
            return None
        card = sm_mod.parse_card(cards[dest])
        if card is None:
            return None  # peer runs sm=0 / is a C rank: intended TCP
        boot, name = card
        if boot != self._sm_boot:
            # mismatched boot id: the advertised /dev/shm namespace is
            # not provably ours — degrade loudly (counted per send)
            mca_output.verbose(
                2, _stream,
                "rank %s: rank %s advertised an sm segment on boot %s, "
                "not this rank's %s; pair degrades to TCP", self.rank,
                dest, boot, self._sm_boot,
            )
            self._sm_declined.add(dest)
            return None
        # peer class decides the ring capacity the owner materializes:
        # a provably different NUMA domain makes this a leader-to-leader
        # pair; unknown/absent/malformed tokens stay intra (full-size
        # ring, always correct)
        peer_numa = sm_mod.parse_numa(cards[dest])
        klass = sm_mod.CLASS_INTRA
        if peer_numa not in (None, sm_mod.NUMA_MALFORMED) \
                and peer_numa != self._sm_numa:
            klass = sm_mod.CLASS_LEADER
        try:
            sender = sm_mod.SmSender(name, src_rank=self.rank,
                                     dest_rank=dest, ring_class=klass)
        except sm_mod.ConsumerStopped:
            raise  # _sm_tx classifies it outside _sm_lock
        except (OSError, errors.MpiError) as e:
            mca_output.emit(
                _stream,
                "rank %s: sm segment of rank %s unmappable (%s); pair "
                "degrades to TCP", self.rank, dest, e,
            )
            self._sm_declined.add(dest)
            return None
        mca_output.verbose(
            5, _stream, "rank %d: sm ring to rank %d active (%s)",
            self.rank, dest, name,
        )
        return sender

    def _sm_abort(self, dest: int):
        """The ring-full spin's abort probe: a local close ends the wait,
        and on an ft proc so does the peer's classified death (typed
        ``ProcFailed`` out of the spin)."""
        state = self.ft_state
        closed = self._closed

        def abort():
            if closed.is_set():
                raise errors.InternalError(
                    f"sm send to rank {dest} on a closed proc"
                )
            if state is not None and state.is_failed(dest):
                raise errors.ProcFailed(
                    f"rank {dest} failed during an sm ring send",
                    failed_ranks=state.failed(),
                )

        return abort

    def _sm_send(self, smtx: sm_mod.SmSender, obj: Any, dest: int,
                 tag: int, cid: int, seq: int, nbytes: int,
                 tctx: "tuple[int, int, int] | None" = None,
                 objs: tuple | None = None) -> None:
        """One frame onto the peer's ring — the `_send_frame`-shaped
        seam of the sm plane.  Small frames pack their DSS header
        straight into the slot (``pack_frames_into``); larger ones take
        the fragment pipeline.  A full ring blocks HERE (backpressure,
        bounded by the stall timeout, with the peer's death classifying
        out of the spin)."""
        abort = self._sm_abort(dest)
        abort()
        oob_min = int(mca_var.get("tcp_zero_copy_min", 0))
        deadline = time.monotonic() + self._timeout
        wire = None
        # direct (single-slot) only for SMALL frames: a mid-size message
        # is faster as a fragment pipeline — the peer's copy-out overlaps
        # our remaining copy-ins
        if objs is None:
            objs = self._frame_objs(tag, cid, seq, obj, tctx)
        if nbytes + 512 <= min(smtx.slot_bytes, 32 << 10):
            wire = smtx.send_direct(objs, oob_min, deadline, abort)
            nfrags = 1
        if wire is None:
            header, oob = dss.pack_frames(*objs, oob_min=oob_min)
            wire, nfrags = smtx.send_frame(header, oob, deadline, abort)
        spc.record("sm_bytes_sent", wire)
        spc.record("sm_eager_sends" if nfrags == 1 else "sm_frag_sends",
                   1)

    def _sm_incoming(self, src_ring: int, frame: bytearray) -> None:
        """Poll-thread delivery: one assembled frame in a dedicated
        writable buffer — same contract as the socket drain, one
        matching engine for both transports (an array record decodes to
        a CPU tensor viewing ``frame``, never the ring slot)."""
        try:
            vals = dss.unpack_from(frame)
            src, tag, cid, seq, payload = vals[:5]
        except (errors.MpiError, ValueError) as e:
            mca_output.emit(
                _stream,
                "rank %s: undecodable sm frame from ring %s: %s",
                self.rank, src_ring, e,
            )
            return
        if self.ft_state is not None and cid in (
            ulfm.FT_HB_CID, ulfm.FT_NOTICE_CID, ulfm.FT_REVOKE_CID,
            ulfm.FT_AGREE_PUB_CID, ulfm.FT_BYE_CID, ulfm.FT_DVM_CID,
        ):
            # the FT control family beats over TCP by design, with ONE
            # exception: the orderly-departure BYE of an sm peer rides
            # its ring so it trails every data frame already produced
            # (the per-direction FIFO the goodbye contract needs)
            self._ft_ctrl(cid, src, payload)
            return
        self._trace_ingest(vals, "sm")
        env = Envelope(src, tag, cid, seq)
        with self._incoming_cv:
            self.engine.incoming(env, payload)
            self._incoming_cv.notify_all()

    def _sm_peer_dead(self, rank: int, _cause: str) -> None:
        """Failure-listener hook (``FailureState.add_failure_listener``):
        a dead peer's consumer is never coming back — unmap our ring
        into it and pin the pair to TCP permanently (a respawned
        incarnation rides TCP per the cohort contract)."""
        with self._sm_lock:
            stale = self._sm_senders.get(rank)
            self._sm_senders[rank] = None
            self._sm_declined.discard(rank)
        if stale is not None:
            stale.close()

    def _sm_quiesce(self, deadline: float) -> None:
        """Bounded wait for peers to consume-and-deliver our outbound
        ring frames: a goodbye that rides TCP could otherwise overtake
        ring data still in flight and reclassify delivered messages as
        lost.  A peer whose poll loop already stopped can never drain —
        skip it."""
        with self._sm_lock:
            senders = [s for s in self._sm_senders.values()
                       if s is not None]
        for s in senders:
            # close-path drain: the CONSUMING peer needs the CPU more
            # than this poll does — 2 ms granularity merely coarsens
            # close by a hair
            while s.pending() and not s.peer_stopped() \
                    and time.monotonic() < deadline:
                time.sleep(0.002)

    def _sm_teardown(self) -> None:
        with self._sm_lock:
            senders = [s for s in self._sm_senders.values()
                       if s is not None]
            self._sm_senders = {r: None for r in self._sm_senders}
        for s in senders:
            s.close()
        if self._sm_seg is not None:
            self._sm_seg.close()


    # -- ULFM control plane ---------------------------------------------

    def _ft_emit(self, dest: int) -> None:
        """One heartbeat frame to `dest` (best-effort: a beat that cannot
        be delivered is evidence, not an error)."""
        if self._ft_dead or self._closed.is_set() \
                or self.ft_state.is_failed(dest):
            return
        frame = dss.pack(self.rank, 0, ulfm.FT_HB_CID, 0, b"")
        try:
            # short connect deadline: the detector thread must never park
            # in a connect retry, or our OWN beats stop and the observer
            # falsely suspects us
            sock = self._endpoint(dest, deadline=4 * self._detector.period
                                  if self._detector else 0.5)
            self._framed_send(sock, frame)
        except (OSError, errors.MpiError) as e:
            if isinstance(e, (ConnectionRefusedError, ConnectionResetError,
                              BrokenPipeError)):
                # connection refused/reset IS peer death, not a stall
                self._mark_transport_death(dest)

    def _flood(self, cid: int, payload: Any, name: str) -> None:
        """Best-effort ULFM control-plane flood to every live peer, on a
        one-shot daemon thread: no flooding caller — the detector loop
        (which must keep beating or its OWN observer falsely suspects
        it), a rank mid-recovery revoking a cid, a completing agreement
        — may stall behind serial connect deadlines to unreachable
        peers.  An undeliverable frame is dropped: the peer's own
        detector/recovery path covers it.  Threads are TRACKED so an
        orderly close() can flush them before tearing the wire down —
        an agreement announce racing its own rank's close would strand
        survivors in a round nobody can finish (sever(), a crash,
        still abandons them by design)."""
        t = threading.Thread(
            target=self._flood_sync, args=(cid, payload),
            daemon=True, name=f"{name}-{self.rank}",
        )
        with self._flood_lock:
            # registered BEFORE start so a concurrent close() cannot
            # miss it; the prune must therefore keep registered-but-
            # unstarted threads (ident is None until start()) or a
            # sibling's prune could silently un-track this flood
            self._flood_threads = [
                x for x in self._flood_threads
                if x.ident is None or x.is_alive()
            ]
            self._flood_threads.append(t)
        try:
            t.start()
        except BaseException:
            # never-started floods must not stay tracked (close()'s
            # RuntimeError-tolerant join would retry them to deadline)
            with self._flood_lock:
                if t in self._flood_threads:
                    self._flood_threads.remove(t)
            raise

    def _overlay_targets(self) -> list[int]:
        """This rank's log-degree flood fan-out: skip-ring overlay
        neighbors over the CURRENT live view (:mod:`.overlay`).
        Failed/departed ranks drop out of the member list, so the
        overlay is rebuilt from survivors at shrink by construction —
        no membership protocol, every rank derives the same graph.
        Live peers the old all-pairs flood would have dialed are
        counted in ``tcp_deferred_dials`` (the scaling gate's
        no-silent-fallback evidence)."""
        live = [r for r in range(self.size)
                if r == self.rank or not self.ft_state.is_failed(r)]
        nbrs = overlay.neighbors(self.rank, live)
        skipped = (len(live) - 1) - len(nbrs)
        if skipped > 0:
            spc.record("tcp_deferred_dials", skipped)
        return nbrs

    def _flood_sync(self, cid: int, payload: Any) -> None:
        # overlay fan-out, not all-pairs: receivers relay FRESH facts
        # to THEIR neighbors (_ft_ctrl's gossip-once), so coverage is
        # total while per-event frames stay O(n·log n) universe-wide
        frame = dss.pack(self.rank, 0, cid, 0, payload)
        for r in self._overlay_targets():
            try:
                sock = self._endpoint(r, deadline=1.0)
                self._framed_send(sock, frame)
                spc.record("ft_overlay_hops")
            except (OSError, errors.MpiError):
                pass

    def _ft_flood(self, failed: frozenset) -> None:
        """Propagate suspicion: failure notices to every live rank.
        Entries are ``[rank, cause]`` pairs so a typed classification
        (a device fault) survives the wire; causes that are only LOCAL
        evidence (a detector suspicion, a transport reset) travel as
        second-hand "notice" — the receiver did not observe them, and
        the zero-false-positive gate must keep its meaning.  Receivers
        also accept bare ranks (the pre-pair wire shape)."""
        causes = dict(self.ft_state.failed_with_causes())
        pairs = []
        for r in sorted(int(r) for r in failed):
            cause = causes.get(r, "notice")
            if cause not in ("device", "goodbye"):
                cause = "notice"
            pairs.append([r, cause])
        self._flood(ulfm.FT_NOTICE_CID, pairs, "hb-flood")

    def flood_device_fault(self, fault=None) -> None:
        """Device-plane classification → the same notice flood a
        transport death rides (the ``DeviceLivenessProbe`` on_fault
        hook).  The fault's own ranks are flooded as explicit
        ``device`` pairs — the flood must carry the root cause even if
        a concurrent symptom (this rank's own sm teardown classifying
        as transport death on a peer) wins the mark_failed race
        somewhere (receivers refine circumstantial causes)."""
        if self._ft_dead or self._closed.is_set():
            return
        causes = dict(self.ft_state.failed_with_causes())
        for r in getattr(fault, "failed_ranks", None) or ():
            causes[int(r)] = "device"
        pairs = []
        for r in sorted(causes):
            cause = causes[r]
            if cause not in ("device", "goodbye"):
                cause = "notice"
            pairs.append([int(r), cause])
        self._flood(ulfm.FT_NOTICE_CID, pairs, "device-fault")

    def _mark_transport_death(self, dest: int) -> None:
        """Classify a transport-evidenced death (connection reset /
        refused past backoff / sm consumer stopped) AND flood the
        notice, exactly as the detector floods its suspicions: without
        propagation every rank discovers the corpse independently, and
        a ring observer can false-positive its NEW observed before
        that rank redirects its beats away from the corpse (the
        reconfiguration grace race, observed under scheduler noise)."""
        if self.ft_state.mark_failed(dest, cause="transport") \
                and not self._ft_dead and not self._closed.is_set():
            self._ft_flood(self.ft_state.failed())

    def _agree_announce(self, seq: int, result) -> None:
        """Flood a completed agreement's value into the live peers'
        result registries (the recovery channel of :func:`ulfm.agree`):
        a survivor the dead coordinator never reached adopts the value
        from its registry instead of waiting out a round nobody can
        finish — and a re-elected coordinator gathering from an
        already-departed participant converges the same way.  The value
        is carried verbatim (DSS-packable): a bool for the flag
        AND-reduction, a [pairs, epoch] list for the failed-set
        agreement — coercion here would hand adopters of a failed-set
        result a bare flag they cannot unpack."""
        self._flood(ulfm.FT_AGREE_PUB_CID, [int(seq), result],
                    "agree-pub")

    def _ft_ctrl(self, cid: int, src: int, payload: Any) -> None:
        """Control frames intercepted before the matching engine."""
        if cid == ulfm.FT_HB_CID:
            if self._detector is not None:
                self._detector.transport.on_beat(src)
        elif cid == ulfm.FT_NOTICE_CID:
            # entries are [rank, cause] pairs (typed causes — "device"
            # — survive the wire; see _ft_flood) or bare ranks (the
            # pre-pair shape: second-hand "notice")
            fresh = []
            for entry in payload:
                if isinstance(entry, (list, tuple)):
                    r, cause = int(entry[0]), str(entry[1])
                    if cause == "goodbye":
                        if self.ft_state.mark_departed(r):
                            fresh.append([r, cause])
                    elif self.ft_state.mark_failed(r, cause=cause):
                        fresh.append([r, cause])
                    elif cause == "device":
                        # the typed classification lost the race to a
                        # downstream symptom (the wedged rank's sm
                        # teardown classifies as transport death on
                        # peers mid-send): adopt the root cause
                        self.ft_state.refine_cause(r, cause)
                else:
                    r = int(entry)
                    if self.ft_state.mark_failed(r, cause="notice"):
                        fresh.append([r, "notice"])
            if fresh and not self._ft_dead and not self._closed.is_set():
                # gossip-once relay onto OUR overlay neighbors: the
                # origin only dialed ITS log-degree fan-out, so a
                # non-neighbor survivor learns through relays; mark_*
                # returning False for known facts bounds each rank to
                # one relay per fact and terminates the flood
                self._flood(ulfm.FT_NOTICE_CID, fresh, "notice-gossip")
        elif cid == ulfm.FT_REVOKE_CID:
            if self.ft_state.revoke(int(payload)) \
                    and not self._ft_dead and not self._closed.is_set():
                # newly-learned revocation: relay (overlay gossip)
                self._flood(ulfm.FT_REVOKE_CID, int(payload),
                            "revoke-gossip")
        elif cid == ulfm.FT_AGREE_PUB_CID:
            seq, result = payload
            # verbatim: agreement values are typed by their protocol
            # (bool for agree(), [pairs, epoch] for agree_failed_set())
            if self.ft_state.record_agreement(int(seq), result) \
                    and not self._ft_dead and not self._closed.is_set():
                # newly-adopted announce: relay so survivors outside
                # the coordinator's overlay fan-out converge too
                self._flood(ulfm.FT_AGREE_PUB_CID,
                            [int(seq), result], "agree-gossip")
        elif cid == ulfm.FT_DVM_CID:
            # authoritative fault event from the runtime daemon (zprted
            # waitpid-watched the corpse exit, or a parent daemon saw a
            # whole subtree's link drop): OS truth, not suspicion —
            # classify immediately, before any heartbeat window
            # expires.  The daemon tree floods every survivor itself
            # (each daemon notifies the ranks IT hosts), so no onward
            # relay is needed.  A third entry value names the cause
            # ("daemon-tree" = the rank died WITH its host daemon).
            fresh = 0
            for entry in payload:
                if isinstance(entry, (list, tuple)):
                    r = int(entry[0])
                    cause = str(entry[2]) if len(entry) > 2 \
                        else "daemon"
                else:
                    r, cause = int(entry), "daemon"
                if self.ft_state.mark_failed(r, cause=cause):
                    fresh += 1
            if fresh:
                spc.record("dvm_fault_events", fresh)
        elif cid == ulfm.FT_BYE_CID:
            # relay newly-learned departures onward (gossip-once): the
            # departing rank goodbyes only its CONNECTED peers, so a
            # survivor it never dialed would otherwise re-learn the rank
            # the hard way — ring reconfiguration adopts it as observed
            # successor, sees no beats, and scores a detector false
            # positive for a clean exit.  mark_departed returns False
            # for anything already known, so each rank relays a given
            # departure at most once and the flood terminates.
            fresh = [int(r) for r in payload
                     if self.ft_state.mark_departed(int(r))]
            if fresh and not self._ft_dead and not self._closed.is_set():
                self._flood(ulfm.FT_BYE_CID, fresh, "bye-gossip")

    def _announce_join(self, timeout: float) -> None:
        """Re-modex for a respawned rank (the JOIN half of the recovery
        pipeline): dial every presumed-live survivor from the inherited
        address book, announce the fresh endpoint, and adopt the
        survivors' collective/agreement sequence counters and crash
        epoch from their JOIN_ACKs — so the replacement's next full-size
        collective tags identically to the survivors' and a post-rejoin
        shrink can never reuse an earlier generation's cid window.  The
        pipeline contract is that respawn happens at a survivor barrier
        (post-rollback), so the ack'd counters are stable."""
        frame = dss.pack(self.rank, 0, ulfm.FT_JOIN_CID, 0,
                         ["join", self.rank, list(self.address)])
        reached = 0
        for r in range(self.size):
            if r == self.rank or r in self._rejoin_ranks:
                # a fellow replacement of the SAME recovery window needs
                # no JOIN from us: both sides already hold each other's
                # FRESH generation-tagged cards from the store, neither
                # has the other marked failed, and dialing a sibling
                # still mid-construction would race its wiring
                continue
            if self.ft_state.is_failed(r):
                # a known-dead or elastic-absent slot: nothing to
                # announce to (its placeholder address dials nowhere)
                continue
            try:
                sock = self._endpoint(r, deadline=min(2.0, timeout))
                self._framed_send(sock, frame)
                reached += 1
            except (OSError, errors.MpiError):
                continue  # a peer that is itself gone: its own recovery
        if reached == 0:
            raise errors.InternalError(
                "rejoin: no survivor reachable for the JOIN re-modex"
            )
        deadline = time.monotonic() + timeout
        with self._join_cv:
            while not self._join_acks:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise errors.InternalError(
                        "rejoin: no JOIN_ACK from any survivor"
                    )
                self._join_cv.wait(min(left, 0.05))
            acks = list(self._join_acks.values())
        self._coll_seq = max(a[0] for a in acks)
        self._agree_seq = max(a[1] for a in acks)
        self.ft_state.raise_epoch(max(a[2] for a in acks))

    def _ft_join(self, conn: socket.socket, src: int, payload: Any) -> None:
        """JOIN/re-modex control family (runs on the drain thread, which
        is the one place the carrying connection is in hand).  "join": a
        respawned rank announces its fresh endpoint — swap it in as the
        canonical connection (the pre-crash cached socket is a severed
        corpse), update the address book, clear the failure record so
        classification stops typing the rank dead, give the detector a
        fresh beat window, and ack with our counters.  "ack": the
        survivor's reply, collected by _announce_join."""
        kind = payload[0]
        if kind == "join":
            if getattr(self, "address_book", None) is None:
                # a JOIN landing while THIS endpoint is still wiring up
                # (possible only from another mid-recovery incarnation):
                # nothing to swap yet — our book comes generation-fresh
                # from the store, and the joiner's lazy connects still
                # reach us through the listener
                return
            jrank = int(payload[1])
            addr = tuple(payload[2][:2])
            with self._conn_lock:
                stale = self._conns.get(jrank)
                self._conns[jrank] = conn
            if stale is not None and stale is not conn:
                # the severed pre-crash socket: its drain already exited
                # on the RST; EOF-then-close per the fd-reuse contract
                try:
                    stale.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    stale.close()
                except OSError:
                    pass
            self.address_book[jrank] = addr
            cards = getattr(self, "_peer_cards", None)
            if cards is not None and jrank < len(cards):
                # scrub the dead incarnation's sm card: the respawned
                # rank rides TCP (cohort contract) and must not count
                # as a silent sm fallback either
                cards[jrank] = list(addr)
            with self._sm_lock:
                self._sm_senders[jrank] = None
                self._sm_declined.discard(jrank)
            # membership change: the joiner's locality card was just
            # scrubbed, so the next hierarchical collective must
            # re-derive the groups (the rejoiner is a singleton now)
            from ..coll import han as han_mod

            han_mod.invalidate(self)
            if self._detector is not None:
                self._detector.transport.grace(jrank)
            self.ft_state.restore(jrank)
            ack = ["ack", self.rank, int(getattr(self, "_coll_seq", 0)),
                   int(getattr(self, "_agree_seq", 0)),
                   int(self.ft_state.crash_epoch())]
            try:
                self._framed_send(conn, dss.pack(
                    self.rank, 0, ulfm.FT_JOIN_CID, 0, ack))
            except OSError:
                pass  # the joiner died again: its next respawn's business
        elif kind == "ack":
            with self._join_cv:
                self._join_acks[int(payload[1])] = (
                    int(payload[2]), int(payload[3]), int(payload[4]))
                self._join_cv.notify_all()

    def revoke(self, cid: int) -> None:
        """MPIX_Comm_revoke on the wire: poison locally, flood the
        notice so every live rank's pending and future operations on
        this cid raise ``Revoked``.  Local state is poisoned before the
        flood thread starts, so the revoking rank's own operations fail
        fast and the caller's RECOVERY path never stalls behind the
        flood's connect deadlines."""
        state = self.ft_state
        if state is None:
            raise errors.UnsupportedError(
                "revoke needs fault tolerance enabled (ft=True)"
            )
        state.revoke(cid)
        self._flood(ulfm.FT_REVOKE_CID, int(cid), "revoke-flood")

    def sever(self) -> None:
        """Simulate process death (the fault-injection hook): heartbeats
        stop and every socket is torn down abruptly — no quiescence, no
        goodbye — so peers see connection reset exactly like a crash."""
        self._ft_dead = True
        if self._metrics_pub is not None:
            # a crash publishes nothing more — no final flush (a clean
            # final snapshot from a corpse would lie to the fleet); the
            # thread still dies with the proc (the publisher leak gate)
            self._metrics_pub.abort()
            self._metrics_pub = None
        if self._detector is not None:
            self._detector.stop(join_timeout=0.0)
        self._closed.set()
        # a crash abandons its in-flight deferred sends and parked
        # rendezvous descriptors: waiters unblock ERRORED (typed) and
        # the hygiene gate sees no incomplete request / orphaned park
        self._abandon_inflight("proc severed (simulated crash) with "
                               "sends in flight")
        # a crash abandons its pushes: mark the pool closed so idle
        # workers exit (the hygiene gate counts worker threads)
        self._push_pool.close(0.0)
        if self._sm_seg is not None:
            # consumption stops (the crash contract) but the segment
            # FILE survives — a real crash cleans nothing up; the final
            # harness close()/launcher sweep owns the unlink
            self._sm_seg.sever()
        # the channel engine dies with the proc (a crash reads nothing
        # more); stopping it before the RST closes below means no
        # reader is parked on an fd about to be freed
        if self._chan_engine is not None:
            self._chan_engine.close(1.0)
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self._conns.values()) + self._dup_conns
            self._conns.clear()
            self._dup_conns = []
        for sock in conns:
            try:
                # RST on close (SO_LINGER 0): peers must observe a reset,
                # not an orderly shutdown — this is a crash, not a close
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0),
                )
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def mute(self) -> None:
        """Simulate a hang/partition: heartbeats stop, sockets stay up —
        only the failure detector can discover this death."""
        self._ft_dead = True

    def boot_token_of(self, rank: int) -> str | None:
        """Locality identity of ``rank`` as the modex advertised it (the
        boot half of the ``(boot_id, segment)`` card ``pt2pt/sm.py``
        publishes): equal tokens = provably the same host.  None =
        unknown (``sm=0`` peers, C ranks), which the han topology layer
        groups as its own singleton locality.  Own rank reads its OWN
        relayed card, so every rank derives the identical groups."""
        cards = getattr(self, "_peer_cards", None)
        if cards is None or not 0 <= rank < len(cards):
            return None
        card = sm_mod.parse_card(cards[rank])
        return card[0] if card is not None else None

    def numa_token_of(self, rank: int):
        """NUMA-domain identity of ``rank`` as the modex advertised it
        (the ``pynuma:`` card item): a token string, None when absent
        (the host degrades to one domain), or the
        :data:`~zhpe_ompi_tpu_torch.pt2pt.sm.NUMA_MALFORMED` sentinel."""
        cards = getattr(self, "_peer_cards", None)
        if cards is None or not 0 <= rank < len(cards):
            return None
        return sm_mod.parse_numa(cards[rank])

    def sm_segment_stats(self) -> dict | None:
        """Demand-mapping introspection of this proc's OWN segment:
        materialized inbound ring sources, the bitmap-derived logical
        footprint, and the actual tmpfs page bytes.  None when the sm
        plane is off."""
        seg = self._sm_seg
        if seg is None:
            return None
        return {
            "materialized": seg.materialized(),
            "footprint_bytes": seg.footprint_bytes(),
            "physical_bytes": seg.physical_bytes(),
        }

    # -- one-sided plane seam (osc/direct.py) ----------------------------

    def sm_rma_region(self, nbytes: int):
        """Allocate an RMA region (window/symmetric-heap backing) in
        this proc's sm segment namespace; None when the sm plane is
        off — the window then rides the AM path everywhere."""
        if self._sm_seg is None:
            return None
        return self._sm_seg.alloc_rma_region(nbytes)

    def sm_release_region(self, region) -> None:
        if self._sm_seg is not None:
            self._sm_seg.release_rma_region(region)
        else:  # segment already torn down: best-effort unlink
            region.close(unlink=True)

    def sm_direct_to(self, dest: int) -> bool:
        """The one-sided plane's per-peer seam decision: True when the
        transport ladder selected the sm ring for `dest` (same boot, sm
        priority, not declined/failed) — the decision the two-sided send
        seam memoized, so a direction is direct for RMA iff its data
        channel rides the rings.  Rank-to-self is direct whenever the
        sm plane is on (the owner maps its own region trivially)."""
        if dest == self.rank:
            return self._sm_seg is not None
        return self._sm_tx(dest) is not None

    def resource_stats(self) -> dict:
        """Per-rank live transport resources: ``sockets`` counts cached
        peer connections (canonical + crossed dups), ``channels`` the
        engine's registered readers (sockets plus inbound-accepted
        conns), ``threads`` the transport-owned reader/push threads (ONE
        engine reader regardless of connection count)."""
        with self._conn_lock:
            socks = len(self._conns) + len(self._dup_conns)
        eng = self._chan_engine
        chans = eng.channel_count() if eng is not None else 0
        threads = 1 if eng is not None and not eng.closed else 0
        threads += len(self._push_pool.alive_threads())
        return {"sockets": socks, "channels": chans,
                "threads": threads}

    # -- wire-up ---------------------------------------------------------

    def _my_card(self) -> list:
        """This rank's modex business card: ``[host, port]`` plus
        capability items — the sm segment advertisement and, beside it,
        the NUMA-domain token (extra items are relayed verbatim and
        ignored by consumers that only dial sockets)."""
        card = list(self.address)
        if self._sm_seg is not None:
            card.append(self._sm_seg.card(self._sm_boot))
            card.append(sm_mod.numa_card_item(self._sm_numa))
        return card

    def _modex_pmix(self, timeout: float) -> list[tuple[str, int]]:
        """Business-card exchange through the name-served PMIx store
        (runtime/pmix.py):
        put our card under ``card:<rank>``, commit, fence the
        namespace, then get every peer's card — get-until-published
        blocking means no rank ever races a slower peer's publish.
        A resident DVM hosts the store across jobs, so this path pays
        no per-job rendezvous infrastructure at all."""
        from ..runtime import pmix as pmix_mod

        client = pmix_mod.PmixClient(self._pmix_addr, timeout=timeout)
        try:
            # elastic jobs fence over the STARTED set only (the
            # namespace size is the initial live count — absent slots
            # would park the barrier forever); their cards are
            # placeholders until a grow's FT_JOIN announces the truth
            live = self._live_ranks
            client.ensure_ns(self._pmix_ns,
                             self.size if live is None else len(live))
            client.put(self._pmix_ns, self.rank, f"card:{self.rank}",
                       self._my_card())
            client.commit(self._pmix_ns, self.rank)
            client.fence(self._pmix_ns, self.rank, timeout)
            book = [
                client.get(self._pmix_ns, f"card:{r}", timeout)
                if live is None or r in live else ["0.0.0.0", 0]
                for r in range(self.size)
            ]
        except errors.MpiError as e:
            return self.call_errhandler(errors.InternalError(
                f"pmix modex via {self._pmix_addr} "
                f"ns={self._pmix_ns!r}: {e}"
            ))
        finally:
            client.close()
        self._peer_cards = [list(a) for a in book]
        return [tuple(a[:2]) for a in book]

    def _pmix_rejoin_book(self, timeout: float) -> list:
        """The respawned rank's half of the name-served rejoin: publish
        OUR fresh card FIRST (so co-replacements blocked on this
        window's generation release), then read the book — survivors'
        cards plain, but ranks respawned in the SAME recovery window
        (``rejoin_ranks``) at ``min_generation=rejoin_gen``: a plain
        get would be satisfied by the corpse's generation-old card and
        both replacements would dial each other's dead addresses with
        nothing ever healing the books (JOIN announces to a dead
        address are skipped, not relayed).  Publish-before-read keeps
        the batch deadlock-free.  The JOIN announce to the survivors
        still rides the FT_JOIN wire family unchanged."""
        from ..runtime import pmix as pmix_mod

        client = pmix_mod.PmixClient(self._pmix_addr, timeout=timeout)
        try:
            client.put(self._pmix_ns, self.rank, f"card:{self.rank}",
                       self._my_card())
            client.commit(self._pmix_ns, self.rank)
            book = []
            for r in range(self.size):
                if self._live_ranks is not None \
                        and r not in self._live_ranks:
                    # an absent elastic slot: no card to wait for (a
                    # retired slot's STALE card must not be dialed)
                    book.append(["0.0.0.0", 0])
                    continue
                min_gen = self._rejoin_gen \
                    if r != self.rank and r in self._rejoin_ranks else 0
                book.append(client.get(self._pmix_ns, f"card:{r}",
                                       timeout, min_generation=min_gen))
        finally:
            client.close()
        return book

    def _modex(self, coordinator: tuple[str, int], timeout: float
               ) -> list[tuple[str, int]]:
        if self.rank == 0 and not self._external_coordinator:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(coordinator)
            srv.listen(self.size + 4)
            self.coordinator_address = srv.getsockname()
            if self._on_coordinator_bound is not None:
                self._on_coordinator_bound(self.coordinator_address)
            book: list[Any] = [None] * self.size
            book[0] = self._my_card()
            peers = []
            srv.settimeout(timeout)
            for _ in range(self.size - 1):
                conn, _addr = srv.accept()
                [peer_rank, addr] = dss.unpack(_recv_frame(conn))
                book[peer_rank] = addr
                peers.append(conn)
            payload = dss.pack(book)
            for conn in peers:
                _send_frame(conn, payload)
                conn.close()
            srv.close()
            # the RELAYED book keeps every card verbatim (C peers read
            # capability items); the LOCAL book normalizes to
            # (host, port) — the full cards are kept for the sm
            # transport's endpoint selection
            self._peer_cards = [list(a) for a in book]
            return [tuple(a[:2]) for a in book]
        cli = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        cli.settimeout(timeout)
        deadline_err = None
        # backoff bounded by the modex deadline: a slow-starting
        # coordinator is retried patiently but never past `timeout` —
        # distinguishing "not up yet" from "never coming" by the total
        # budget, not a fixed attempt count
        backoff = _Backoff(timeout, self.rank ^ 0x5EED)
        connected = False
        while not backoff.expired():
            try:
                cli.connect(coordinator)
                connected = True
                break
            except OSError as e:
                deadline_err = e
                cli.close()
                backoff.sleep()
                cli = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                cli.settimeout(timeout)
        if not connected:
            # transport failure routes through the errhandler disposition
            # (ompi_errhandler_invoke at the transport boundary,
            # errhandler.h:94-136): FATAL raises JobAbort, RETURN hands
            # the typed error back to the caller
            exc = errors.InternalError(
                f"modex: cannot reach coordinator {coordinator}: "
                f"{deadline_err}"
            )
            # FATAL raises JobAbort, RETURN raises exc; a user handler's
            # return value becomes the API result (the error-recovery
            # contract of core/errhandler.py)
            return self.call_errhandler(exc)
        _send_frame(cli, dss.pack(self.rank, self._my_card()))
        [book] = dss.unpack(_recv_frame(cli))
        cli.close()
        # normalize at the boundary: C ranks' cards may carry extra
        # capability items beyond (host, port); keep the raw cards for
        # the sm transport's endpoint selection
        self._peer_cards = [list(a) for a in book]
        return [tuple(a[:2]) for a in book]

    def _on_accept(self, conn: socket.socket) -> None:
        """Inbound connection off the channel engine's listener: the
        first frame announces the peer — a bare rank for in-group
        peers, ["b", bridge_cid, rank] for a rank of a REMOTE group
        connecting across an intercomm bridge (dpm, namespaced so
        remote rank numbers cannot collide with local ones in the
        connection cache), or ["d"] for a rendezvous bulk-data
        connection — so the channel starts in a HELLO state and
        retargets itself onto the steady-state frame handler."""
        self._chan_engine.add_channel(
            conn, f"hello:{conn.fileno()}", self._on_hello_frame)

    def _on_hello_frame(self, chan, frame) -> None:
        conn = chan.sock
        [hello] = dss.unpack(frame)
        if isinstance(hello, (list, tuple)) and hello[0] == "d":
            # rendezvous bulk-data connection: drain it, but never
            # register it for sends (control and bulk stay separate)
            with self._conn_lock:
                self._dup_conns.append(conn)
            chan.name = f"data:{conn.fileno()}"
        else:
            if isinstance(hello, (list, tuple)):
                key = ("b", hello[1], hello[2])
            else:
                key = hello
            with self._conn_lock:
                self._conns.setdefault(key, conn)
            chan.name = f"peer:{key}"
        chan.on_frame = self._on_wire_frame

    def _on_wire_frame(self, chan, frame) -> None:
        """One framed message off the channel engine — the per-frame
        body of the old per-connection drain loop (same dispatch,
        same log-and-keep-draining posture: a failing matching
        callback must not kill the channel, every later message on
        this connection would silently vanish)."""
        conn = chan.sock
        # unpack_from: array payloads become writable views over the
        # frame's dedicated recv_into buffer — the zero-copy receive
        # half (the frame bytearray stays alive via the views)
        vals = dss.unpack_from(frame)
        src, tag, cid, seq, payload = vals[:5]
        if self.ft_state is not None and cid == ulfm.FT_JOIN_CID:
            # rejoin/re-modex: needs the carrying connection (the
            # joiner's fresh socket becomes the canonical endpoint)
            self._ft_join(conn, src, payload)
            return
        if self.ft_state is not None and cid in (
            ulfm.FT_HB_CID, ulfm.FT_NOTICE_CID, ulfm.FT_REVOKE_CID,
            ulfm.FT_AGREE_PUB_CID, ulfm.FT_BYE_CID, ulfm.FT_DVM_CID,
        ):
            # ULFM control plane: heartbeats / failure notices /
            # revoke floods never enter the matching engine
            self._ft_ctrl(cid, src, payload)
            return
        self._trace_ingest(vals, "tcp")
        env = Envelope(src, tag, cid, seq)
        try:
            with self._incoming_cv:
                self.engine.incoming(env, payload)
                self._incoming_cv.notify_all()
        except Exception as e:  # noqa: BLE001 - log, keep draining
            mca_output.emit(
                _stream,
                "rank %s: matching callback failed for (src=%s tag=%s "
                "cid=%s): %s: %s", self.rank, src, tag, cid,
                type(e).__name__, e,
            )

    def _endpoint(self, dest: int,
                  deadline: float | None = None) -> socket.socket:
        with self._conn_lock:
            sock = self._conns.get(dest)
        if sock is not None:
            return sock
        if self.ft_state is not None and self.ft_state.is_failed(dest):
            raise errors.ProcFailed(
                f"rank {dest} is known failed",
                failed_ranks=self.ft_state.failed(),
            )
        # lazy connection establishment (btl_tcp_endpoint shape) with
        # exponential backoff + jitter bounded by a total deadline: a
        # peer still wiring up is retried, not misclassified as dead.
        # Cards may carry extra
        # capability items beyond (host, port), so the connect address is
        # always the 2-prefix.
        addr = tuple(self.address_book[dest][:2])
        budget = self._timeout if deadline is None else deadline
        backoff = _Backoff(budget, (self.rank << 16) ^ dest)
        sock = None
        while True:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.settimeout(max(0.05, min(self._timeout, budget)))
            try:
                sock.connect(addr)
                break
            except OSError as e:
                try:
                    sock.close()
                except OSError:
                    pass
                state = self.ft_state
                if state is not None and state.is_failed(dest):
                    raise errors.ProcFailed(
                        f"rank {dest} failed while connecting",
                        failed_ranks=state.failed(),
                    ) from e
                if state is None and isinstance(
                    e, (ConnectionRefusedError, ConnectionResetError)
                ):
                    # non-ft: the peer advertised this port through the
                    # modex, so its listener WAS bound — refused now
                    # means it is gone, and without ft there is no
                    # rejoin path that could re-bind it: fail fast
                    raise
                if backoff.expired(lookahead=backoff.delay):
                    if state is not None and isinstance(
                        e, (ConnectionRefusedError, ConnectionResetError)
                    ):
                        # refused past the backoff budget: the peer's
                        # listener is gone — that is death, not a stall
                        self._mark_transport_death(dest)
                        raise errors.ProcFailed(
                            f"rank {dest} unreachable "
                            f"(connection refused/reset): {e}",
                            failed_ranks=state.failed(),
                        ) from e
                    raise
                backoff.sleep()
        # the connect BUDGET must not become the socket's steady-state
        # timeout
        sock.settimeout(self._timeout)
        _send_frame(sock, dss.pack(self.rank))
        spc.record("tcp_lazy_connects")
        with self._conn_lock:
            existing = self._conns.get(dest)
            if existing is not None:
                # simultaneous connect: the peer may have ALREADY
                # registered our socket as ITS canonical endpoint —
                # closing it here would RST the peer's first frames.
                # Keep both crossed connections; each side sends only on
                # its registered one, so per-source FIFO is preserved.
                self._dup_conns.append(sock)
                self._chan_engine.add_channel(
                    sock, f"peer:{dest}-x", self._on_wire_frame)
                return existing
            self._conns[dest] = sock
        self._chan_engine.add_channel(
            sock, f"peer:{dest}", self._on_wire_frame)
        return sock

    def bridge_endpoint(self, cid: int, dest: int,
                        addr: tuple[str, int]) -> socket.socket:
        """Lazy connection to rank `dest` of a REMOTE group across an
        intercomm bridge (``comm/dpm_wire.py``) — cached under the bridge
        cid so remote rank numbering stays disjoint from the in-group
        book."""
        key = ("b", cid, dest)
        with self._conn_lock:
            sock = self._conns.get(key)
        if sock is not None:
            return sock
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(self._timeout)
        sock.connect(tuple(addr))
        _send_frame(sock, dss.pack(["b", cid, self.rank]))
        spc.record("tcp_lazy_connects")
        with self._conn_lock:
            existing = self._conns.get(key)
            if existing is not None:
                # crossed-connection rule: never close a socket whose
                # hello the peer may have registered (see _endpoint)
                self._dup_conns.append(sock)
                self._chan_engine.add_channel(
                    sock, f"bridge:{cid}:{dest}-x", self._on_wire_frame)
                return existing
            self._conns[key] = sock
        self._chan_engine.add_channel(
            sock, f"bridge:{cid}:{dest}", self._on_wire_frame)
        return sock

    def bridge_send(self, obj: Any, cid: int, dest: int,
                    addr: tuple[str, int], tag: int = 0) -> None:
        """Send to a remote-group rank across a bridge; frames carry the
        bridge cid so matching stays isolated from in-group traffic.  A
        CUDA tensor is refused as by :meth:`send` (dss packs host
        buffers only)."""
        seq = next(self._seq)
        header, oob = dss.pack_frames(
            self.rank, tag, cid, seq, obj,
            oob_min=int(mca_var.get("tcp_zero_copy_min", 0)),
        )
        sock = self.bridge_endpoint(cid, dest, addr)
        self._framed_send(sock, [header, *oob])
        if oob:
            spc.record("tcp_zero_copy_sends", 1)
            spc.record("tcp_copy_bytes_avoided",
                       sum(v.nbytes for v in oob))

    # -- MPI surface (RankContext-compatible) ----------------------------

    def send(self, obj: Any, dest: int, tag: int = 0, cid: int = 0,
             poll: bool = False) -> None:
        """Length-framed send: eager below ``tcp_eager_limit``, RTS/CTS
        rendezvous above it (ob1's protocol split on the wire — an
        unmatched multi-GB send must park at the SENDER, not in the
        receiver's unexpected queue).  The rendezvous payload is
        serialized at send time, so the MPI buffer-reuse contract holds
        the moment this returns.  A tensor the wire cannot carry (not on
        the CPU, or of a dtype numpy lacks) raises dss's ``TypeError_``
        before any frame is written.

        ``poll=True`` marks a framework-internal send: typed failures
        raise directly, bypassing the errhandler disposition."""
        if not 0 <= dest < self.size:
            raise errors.RankError(f"rank {dest} out of range")
        if tag < 0:
            raise errors.TagError(f"negative tag {tag}")
        _refuse_device(obj)
        if flightrec.active and not poll:
            # the postmortem ring: user-facing traffic only
            flightrec.record(flightrec.SEND, rank=self.rank, dest=dest,
                             tag=tag, cid=cid)
        state = self.ft_state
        if state is not None and state.is_revoked(cid):
            # before ANY delivery path, the loopback fast path included:
            # a revoked cid poisons sends to self like any other
            exc: errors.MpiError = errors.Revoked(
                f"send on revoked cid={cid}", cid=cid
            )
            if poll:
                raise exc
            return self.call_errhandler(exc)
        seq = next(self._seq)
        # tracing plane (armed only): the send span opens here and its
        # wire context rides the frame header; an error path that never
        # ends the span leaves it unrecorded
        tspan = tctx = None
        if ztrace.active and not poll:
            tspan = ztrace.begin(ztrace.SEND, self.rank, dest=dest,
                                 tag=tag, cid=cid, seq=seq)
            tctx = ztrace.wire_context(tspan.sid, seq)
            if tctx is None:
                tspan = None  # a disarm raced begin(): send untraced
        if dest == self.rank:
            self._deliver_self(obj, tag, cid, seq, tspan, tctx)
            return
        nbytes = _payload_size(obj)
        # deferred frames queued toward this peer drain FIRST: blocking
        # sends write the socket inline, and per-source FIFO must hold
        # across both send paths (isend then send may not reorder)
        try:
            self._send_fence(dest)
        except errors.InternalError as exc:
            if poll:
                raise
            return self.call_errhandler(exc)
        # per-peer transport dispatch (the btl selection seam): the sm
        # ring wins for same-boot peers by priority; everything below is
        # the TCP path the pair degrades to
        smtx = self._sm_tx(dest)
        if smtx is not None:
            try:
                spins0 = sm_mod.thread_full_spins() \
                    if tspan is not None else 0
                self._sm_send(smtx, obj, dest, tag, cid, seq, nbytes,
                              tctx=tctx)
                if tspan is not None:
                    # bp: the span's duration includes ring-full
                    # backpressure (this thread's spins only)
                    tspan.end(transport="sm",
                              bp=sm_mod.thread_full_spins() > spins0)
                return
            except errors.ProcFailed as exc:
                if poll:
                    raise
                return self.call_errhandler(exc)
            except sm_mod.ConsumerStopped as e:
                # the ring's owner stopped consuming: on an ft proc that
                # IS peer death — the sm twin of connection reset (the
                # detector/BYE may simply not have landed yet); classify
                # instead of surfacing a bare transport error
                if state is None:
                    if poll:
                        raise
                    return self.call_errhandler(e)
                self._mark_transport_death(dest)
                exc = errors.ProcFailed(
                    f"rank {dest} failed (sm ring consumer stopped): "
                    f"{e}", failed_ranks=state.failed(),
                )
                if poll:
                    raise exc from e
                return self.call_errhandler(exc)
            except errors.InternalError as exc:
                # wedged/closed ring: a transport failure — the same
                # disposition routing a TCP stall gets
                if poll:
                    raise
                return self.call_errhandler(exc)
        if dest in self._sm_declined:
            # the peer advertised an sm endpoint we could not ride
            # (boot mismatch, unmappable segment): visible, not silent
            spc.record("sm_fallback_tcp_sends", 1)
        limit = int(mca_var.get("tcp_eager_limit", 1 << 20))
        try:
            if nbytes > limit:
                self._send_rndv(obj, dest, tag, cid, seq, nbytes,
                                tctx=tctx,
                                parent=tspan.sid if tspan is not None
                                else None)
                if tspan is not None:
                    tspan.end(transport="rndv")
                return
            # eager zero-copy: array/bytes payloads leave as out-of-band
            # memoryview segments of the CALLER's buffers, gathered by
            # sendmsg — the blocking send completes only after the
            # kernel has the bytes, so buffer reuse stays safe
            header, oob = dss.pack_frames(
                *self._frame_objs(tag, cid, seq, obj, tctx),
                oob_min=int(mca_var.get("tcp_zero_copy_min", 0)),
            )
            sock = self._endpoint(dest)
            self._framed_send(sock, [header, *oob])
            if oob:
                spc.record("tcp_zero_copy_sends", 1)
                spc.record("tcp_copy_bytes_avoided",
                           sum(v.nbytes for v in oob))
            if tspan is not None:
                tspan.end(transport="tcp")
        except errors.ProcFailed as exc:
            # peer death classified by the endpoint layer: route through
            # the attached disposition (FATAL aborts, RETURN raises typed)
            if poll:
                raise
            return self.call_errhandler(exc)
        except OSError as e:
            if state is None or not isinstance(
                e, (ConnectionRefusedError, ConnectionResetError,
                    BrokenPipeError)
            ):
                # a stalled send (timeout on a live but slow peer) is NOT
                # death — only reset/refused/pipe is; the endpoint layer
                # already re-raised non-death errors raw, honor that here
                raise
            self._mark_transport_death(dest)
            exc = errors.ProcFailed(
                f"send to rank {dest} failed: {e}",
                failed_ranks=state.failed(),
            )
            if poll:
                raise exc from e
            return self.call_errhandler(exc)

    def _deliver_self(self, obj: Any, tag: int, cid: int, seq: int,
                      tspan, tctx) -> None:
        """Loopback shortcut (btl/self): ONE defensive copy with the DSS
        type mapping instead of the full serialize/deserialize round trip
        — the receiver still sees the pre-mutation value if the sender
        reuses its buffer immediately."""
        nbytes = _payload_size(obj)
        try:
            payload = _loopback_copy(obj)
            spc.record("tcp_loopback_fast_deliveries", 1)
            spc.record("tcp_copy_bytes_avoided", nbytes)
        except _LoopbackFallback:
            frame = dss.pack(self.rank, tag, cid, seq, obj)
            payload = dss.unpack(frame)[4]
        env = Envelope(self.rank, tag, cid, seq)
        with self._incoming_cv:
            self.engine.incoming(env, payload)
            self._incoming_cv.notify_all()
        if tspan is not None:
            # no wire: the deliver span parents directly
            ztrace.instant(ztrace.DELIVER, self.rank,
                           parent=tspan.sid, trace=tctx[0],
                           src=self.rank, tag=tag, cid=cid, seq=seq,
                           transport="self")
            tspan.end(transport="self")

    def _push_rndv(self, rndv_id: int, dest: int, req=None) -> None:
        """CTS-released bulk push over a dedicated per-transfer data
        connection (hello ["d"]).  Runs on a push-pool worker over its
        OWN socket: the drain must keep reading while this send blocks
        (drain stuck in a writer = bidirectional deadlock), and the bulk
        write must not hold the control socket's framing lock — a tiny
        CTS queued behind a multi-MB sendall re-creates the same
        deadlock one level up; ob1 separates its channels for the same
        reason.  ``req`` is the isend path's SendRequest: the push's
        outcome completes it (the blocking path passes None — its
        buffer-reuse contract was settled by the park copy)."""
        data_sock = None
        err: BaseException | None = None
        sent = False
        tparent = None
        t0_ns = 0
        if ztrace.active:
            with self._rndv_lock:
                tparent = self._rndv_trace.get(rndv_id)
            t0_ns = time.monotonic_ns()
        try:
            with self._rndv_lock:
                frame_segs = self._pending_rndv.get(rndv_id)
                if frame_segs is not None and req is not None \
                        and not req.done:
                    # push in flight: owned ATOMICALLY with the frame
                    # read, under the same lock the failure listener
                    # holds — no window where both sides claim it
                    req._owned = True
            if frame_segs is None or (req is not None and req.done):
                # poisoned/abandoned while parked (revoke, peer death,
                # sever): the poisoner owns the request's completion
                return
            data_sock = socket.socket(
                socket.AF_INET, socket.SOCK_STREAM
            )
            data_sock.settimeout(self._timeout)
            data_sock.connect(tuple(self.address_book[dest][:2]))
            _send_frame(data_sock, dss.pack(["d"]))
            _send_frame(data_sock, frame_segs)
            sent = True
        except BaseException as e:  # noqa: BLE001 - typed at the req
            # ANY escape (not just OSError) must complete the request:
            # the finally below drops the park entries, so a request
            # left incomplete here could never be completed by the
            # failure listener or the close-time abandon sweep again
            err = e
            mca_output.emit(
                _stream,
                "rank %s: rendezvous data push to %s failed: %s",
                self.rank, dest, e,
            )
        finally:
            if data_sock is not None:
                try:
                    data_sock.close()
                except OSError:
                    pass
            # always release the entry: close()'s quiesce loop would
            # otherwise spin its full timeout on a dead transfer
            with self._rndv_lock:
                self._pending_rndv.pop(rndv_id, None)
                self._rndv_meta.pop(rndv_id, None)
                self._rndv_trace.pop(rndv_id, None)
            if sent and tparent is not None and ztrace.active:
                # the CTS-released bulk leg, duration included —
                # parented on the originating send span
                ztrace.record_span(ztrace.PUSH, self.rank, t0_ns,
                                   time.monotonic_ns(), parent=tparent,
                                   dest=dest)
            if req is not None:
                if sent:
                    req.complete()
                elif err is not None:
                    req.complete_error(self._deferred_exc(err, dest))

    def _park_rndv(self, obj: Any, dest: int, seq: int,
                   req=None, tctx=None, parent=None) -> tuple[int, list]:
        """Serialize and park one rendezvous transfer; returns
        ``(rndv_id, oob_segments)``.  The blocking path (``req=None``)
        parks one defensive ``bytes()`` copy per payload block — its
        buffer-reuse contract holds the moment send() returns; the
        isend path parks the DESCRIPTOR (the caller's own memoryview
        segments, zero copies) because its contract is deferred to
        request completion.  While tracing is armed the DATA frame
        carries the send span's wire context (the receiver's deliver
        span parents on it) and ``parent`` seeds the push leg's span."""
        rndv_id = next(self._rndv_ids)
        header, oob = dss.pack_frames(
            *self._frame_objs(rndv_id, _RNDV_DATA_CID, seq, obj, tctx),
            oob_min=int(mca_var.get("tcp_zero_copy_min", 0)),
        )
        if parent is not None:
            with self._rndv_lock:
                self._rndv_trace[rndv_id] = int(parent)
        if req is None:
            segments = [header] + [bytes(v) for v in oob]
            spc.record("tcp_rndv_park_copy_bytes",
                       sum(v.nbytes for v in oob))
        else:
            segments = [header, *oob]
            req._pinned = segments
            spc.record("rndv_park_bytes_avoided",
                       sum(v.nbytes for v in oob))
        with self._rndv_lock:
            self._pending_rndv[rndv_id] = segments
            self._rndv_meta[rndv_id] = (dest, req)
        spc.record("tcp_rndv_sends", 1)
        if oob:
            spc.record("tcp_zero_copy_sends", 1)
            spc.record("tcp_copy_bytes_avoided",
                       sum(v.nbytes for v in oob))

        def on_cts(_env, _payload):
            self._push_pool.submit(
                lambda: self._push_rndv(rndv_id, dest, req))

        with self._incoming_cv:
            self.engine.post_recv(dest, rndv_id, _RNDV_CTS_CID, on_cts)
        return rndv_id, oob

    def _send_rndv(self, obj: Any, dest: int, tag: int, cid: int,
                   seq: int, nbytes: int, tctx=None,
                   parent=None) -> None:
        """RTS/CTS rendezvous: serialize the payload now (buffer-reuse
        contract), park the data frame locally, announce with a small RTS
        carrying the envelope; the receiver's CTS — handled in the drain
        thread — releases the data on a dedicated (rndv_id, cid) channel."""
        rndv_id, _oob = self._park_rndv(obj, dest, seq, tctx=tctx,
                                        parent=parent)
        rts = dss.pack(
            *self._frame_objs(
                tag, cid, seq, (_RTS_MARK, self.rank, rndv_id, nbytes),
                tctx),
        )
        sock = self._endpoint(dest)
        self._framed_send(sock, rts)
        if parent is not None and ztrace.active:
            # the announce leg, parented on the send span
            ztrace.instant(ztrace.RTS, self.rank, parent=parent,
                           dest=dest, tag=tag, cid=cid, seq=seq,
                           nbytes=nbytes)

    def _resolve_rndv(self, env: Envelope, payload: Any, deliver) -> bool:
        """If `payload` is an RTS marker, pull the real payload over
        (post the data recv, then CTS) and call ``deliver(env, data)``
        when it lands; returns True when a rendezvous was initiated."""
        if not (isinstance(payload, tuple) and len(payload) == 4
                and payload[0] == _RTS_MARK):
            return False
        _, sender, rndv_id, _nbytes = payload

        def on_data(_env2, data):
            deliver(env, data)

        # may be called from a drain thread (engine entry points are
        # internally locked; _incoming_cv is NOT re-acquired here because
        # matching callbacks already run under it)
        self.engine.post_recv(sender, rndv_id, _RNDV_DATA_CID, on_data)
        cts = dss.pack(self.rank, rndv_id, _RNDV_CTS_CID, next(self._seq),
                       b"")
        sock = self._endpoint(sender)
        self._framed_send(sock, cts)
        return True

    # -- deferred-contract nonblocking send engine -----------------------

    def _channel(self, dest: int) -> _OutChannel:
        ch = self._out_channels.get(dest)
        if ch is None:
            with self._out_lock:
                ch = self._out_channels.setdefault(dest, _OutChannel())
        return ch

    def _enqueue_deferred(self, dest: int, req, work,
                          finish: bool = True) -> None:
        """Queue one unit of deferred send work for ``dest`` and make
        sure exactly one worker owns the channel's drain."""
        ch = self._channel(dest)
        with ch.lock:
            ch.queue.append((work, req, finish))
            start = not ch.draining
            if start:
                ch.draining = True
        if start:
            self._push_pool.submit(
                lambda: self._drain_channel(ch, dest))

    def _drain_channel(self, ch: _OutChannel, dest: int) -> None:
        """Push-pool worker body: drain one destination's deferred
        frames strictly in order; a failing item completes its request
        ERRORED (typed) and the drain keeps going — later frames to a
        dead peer fail fast on their own, and frames to a live peer
        behind a transient error still deliver.

        Fair-share: the drain owns its worker for at most
        ``_PUSH_RR_QUANTUM`` items while other channels queue on the
        pool — then it re-submits itself to the BACK of the pool queue
        (round-robin across destinations), so one peer's bulk
        rendezvous stream cannot starve another tenant's.  ``draining``
        stays True across the rotation: the single-owner invariant (and
        the per-destination FIFO it guards) holds."""
        done = 0
        while True:
            rotate = False
            with ch.lock:
                if not ch.queue:
                    ch.draining = False
                    return
                if done >= _PUSH_RR_QUANTUM \
                        and self._push_pool.backlog() > 0:
                    rotate = True
                else:
                    work, req, finish = ch.queue.popleft()
                    if req is not None:
                        # ownership set ATOMICALLY with the pop: a
                        # failure classifier either sees the item still
                        # queued (and errors it) or sees it owned —
                        # never a window where a delivered send gets
                        # poisoned (observed: a peer recv'd the frame,
                        # finished, and its goodbye beat the worker to
                        # the completion)
                        req._owned = True
            if rotate:
                spc.record("tcp_push_rr_rotations")
                self._push_pool.submit(
                    lambda: self._drain_channel(ch, dest))
                return
            done += 1
            if req is not None and req.done:
                continue  # poisoned while parked (revoke/death/abandon)
            try:
                work()
            except BaseException as e:  # noqa: BLE001 - typed at the req
                if req is not None:
                    req.complete_error(self._deferred_exc(e, dest))
                    # a failed RTS leaves its rendezvous data parked
                    # with a TERMINAL request: nothing will ever push
                    # it — release it here or it pins the caller's
                    # buffers until close()'s sweep
                    self._release_rndv_for(req)
                continue
            if finish and req is not None:
                req.complete()
            elif req is not None:
                # RTS sent, data still parked awaiting the CTS: the
                # park machinery owns the request again
                req._owned = False

    def _release_rndv_for(self, req) -> None:
        """Drop parked rendezvous state pinned for ``req``: once the
        request is terminal (its RTS failed on the engine), the park
        can never be pushed — a late CTS for the id is already a
        no-op in the CTS handler, and the conftest orphan gate would
        otherwise only be saved by close()'s known-failed re-sweep."""
        with self._rndv_lock:
            dead = [rid for rid, (_, r) in self._rndv_meta.items()
                    if r is req]
            for rid in dead:
                self._pending_rndv.pop(rid, None)
                self._rndv_meta.pop(rid, None)
                self._rndv_trace.pop(rid, None)


    def _deferred_exc(self, e: BaseException, dest: int):
        """Typed completion error for a deferred send that failed on
        the progress engine — the same classification the blocking
        send path applies, observed at wait() instead of at the call."""
        state = self.ft_state
        if isinstance(e, sm_mod.ConsumerStopped) and state is not None:
            self._mark_transport_death(dest)
            return errors.ProcFailed(
                f"rank {dest} failed (sm ring consumer stopped): {e}",
                failed_ranks=state.failed(),
            )
        if isinstance(e, errors.MpiError):
            return e
        if isinstance(e, OSError):
            if state is not None and isinstance(
                e, (ConnectionRefusedError, ConnectionResetError,
                    BrokenPipeError)
            ):
                self._mark_transport_death(dest)
                return errors.ProcFailed(
                    f"deferred send to rank {dest} failed: {e}",
                    failed_ranks=state.failed(),
                )
            return errors.InternalError(
                f"deferred send to rank {dest} failed: {e}")
        return errors.InternalError(
            f"deferred send to rank {dest} failed: "
            f"{type(e).__name__}: {e}")

    def _send_fence(self, dest: int) -> None:
        """Order a direct (caller-thread) send behind every deferred
        frame already queued toward ``dest``: blocking sends write the
        socket/ring inline, so an in-flight isend to the same peer must
        drain first or per-source FIFO breaks across the two send
        paths.  No channel (the common all-blocking case) costs one
        dict probe."""
        ch = self._out_channels.get(dest)
        if ch is None or not ch.busy():
            return
        deadline = time.monotonic() + self._timeout
        # bounded backoff, not a sub-ms spin: the push-pool worker
        # draining this channel needs the very quanta a hot poll would
        # steal on a 1-CPU host — first waits
        # stay tight so an almost-drained channel costs ~nothing
        delay = 0.0002
        while ch.busy():
            if time.monotonic() > deadline:
                raise errors.InternalError(
                    f"deferred-send queue to rank {dest} failed to "
                    "drain within the stall timeout")
            time.sleep(delay)
            delay = min(delay * 2, 0.005)

    def _arm_isend_poison(self, req, dest: int, cid: int,
                          rndv_id: int | None = None) -> None:
        """Weak-progress poisoning for a parked isend: a revoke flood
        (via the cid alias machinery) or peer death arriving while the
        frame waits its turn completes the request typed from the
        waiter's own progress tick.  Death also lands eagerly through
        the _fail_inflight failure listener; this RETRYING tick is the
        backstop (the one-shot listener may find the frame transiently
        owned — e.g. the RTS mid-send — and skip it) and the revoke
        path.  A poisoned rendezvous request also releases its parked
        descriptor (``rndv_id``): a park nobody will ever push must
        not pin the caller's buffers or stall the close quiesce."""
        state = self.ft_state
        if state is None:
            return

        def fail(exc) -> None:
            if rndv_id is not None:
                with self._rndv_lock:
                    if req._owned:
                        return  # CTS push started: transport owns it
                    self._pending_rndv.pop(rndv_id, None)
                    self._rndv_meta.pop(rndv_id, None)
                    self._rndv_trace.pop(rndv_id, None)
            req.complete_error(exc)

        def prog():
            if req.done or req._owned:
                # a worker is mid-send: its outcome (delivered, or a
                # transport error classified typed) is authoritative
                return
            if state.is_revoked(cid):
                fail(errors.Revoked(
                    f"isend on revoked cid={cid}", cid=cid))
            elif state.is_failed(dest):
                fail(errors.ProcFailed(
                    f"rank {dest} failed with an isend in flight "
                    f"(cause: {state.cause_of(dest)})",
                    failed_ranks=state.failed()))

        req._progress = prog

    def _fail_inflight(self, rank: int, cause: str) -> None:
        """Failure-listener hook (``FailureState.add_failure_listener``):
        a peer's death completes every parked isend toward it as typed
        ``ProcFailed`` — queued channel frames and parked rendezvous
        descriptors both — so waitall loops observe the failure instead
        of wedging on a corpse (the deferred twin of the blocking
        path's discovery-at-send classification)."""
        state = self.ft_state
        if state is None:
            return
        exc = errors.ProcFailed(
            f"rank {rank} failed with isends in flight (cause: {cause})",
            failed_ranks=state.failed(),
        )
        ch = self._out_channels.get(rank)
        if ch is not None:
            with ch.lock:
                # under ch.lock: an item is either still queued HERE
                # (error it — it will be skipped at pop) or already
                # popped-and-owned by a worker (its outcome is
                # authoritative); never both
                for _work, req, _finish in ch.queue:
                    if req is not None and not req._owned:
                        req.complete_error(exc)
        with self._rndv_lock:
            doomed = [(rid, meta[1])
                      for rid, meta in self._rndv_meta.items()
                      if meta[0] == rank
                      and (meta[1] is None or not meta[1]._owned)]
            for rid, _req in doomed:
                self._pending_rndv.pop(rid, None)
                self._rndv_meta.pop(rid, None)
                self._rndv_trace.pop(rid, None)
        for _rid, req in doomed:
            if req is not None:
                req.complete_error(exc)

    def _rndv_undelivered(self) -> bool:
        """Parked transfers still owed to the peers — the close-quiesce
        predicate.  Blocking-send parks (no request) are always owed;
        an isend park whose request already completed ERRORED (revoked
        or failed while parked — no CTS is ever coming) can never
        drain and must not stall the quiesce for the full timeout."""
        with self._rndv_lock:
            if not self._pending_rndv:
                return False
            for rid in self._pending_rndv:
                meta = self._rndv_meta.get(rid)
                if meta is None or meta[1] is None or not meta[1].done:
                    return True
            return False

    def _abandon_inflight(self, why: str) -> None:
        """Drain-or-abandon teardown of the in-flight set: complete
        every still-parked deferred send ERRORED (waiters unblock
        typed) and drop the parked descriptors (the hygiene gate's
        zero-orphan contract) — sever() abandons immediately (crash
        semantics), close() calls this only after its bounded quiesce
        gave every frame its chance to drain."""
        exc = errors.InternalError(why)
        for ch in list(self._out_channels.values()):
            with ch.lock:
                items = list(ch.queue)
                ch.queue.clear()
            for _work, req, _finish in items:
                if req is not None:
                    req.complete_error(exc)
        with self._rndv_lock:
            metas = list(self._rndv_meta.values())
            self._pending_rndv.clear()
            self._rndv_meta.clear()
            self._rndv_trace.clear()
        for _dest, req in metas:
            if req is not None:
                req.complete_error(exc)

    def _isend_eager(self, obj: Any, dest: int, tag: int, cid: int,
                     seq: int, dispatch, tctx=None):
        """Eager deferred send: pin the caller's buffers (pack_frames
        memoryview segments — zero copies) and queue the vectored
        sendmsg on the progress engine; the request completes when the
        kernel has the bytes."""
        header, oob = dss.pack_frames(
            *self._frame_objs(tag, cid, seq, obj, tctx),
            oob_min=int(mca_var.get("tcp_zero_copy_min", 0)),
        )
        segments = [header, *oob]
        req = SendRequest(pinned=segments, dispatch=dispatch)
        self._arm_isend_poison(req, dest, cid)
        self._inflight.add(req)
        spc.record("tcp_isend_deferred", 1)
        if oob:
            spc.record("tcp_zero_copy_sends", 1)
            spc.record("tcp_copy_bytes_avoided",
                       sum(v.nbytes for v in oob))

        def work():
            sock = self._endpoint(dest)
            self._framed_send(sock, segments)

        self._enqueue_deferred(dest, req, work, finish=True)
        return req

    def _isend_rndv(self, obj: Any, dest: int, tag: int, cid: int,
                    seq: int, nbytes: int, dispatch, tctx=None,
                    parent=None):
        """Rendezvous deferred send: the RTS parks only the DESCRIPTOR
        — the caller's buffers pinned by the request, no copy-at-park —
        and the receiver's CTS releases a push of those buffers
        directly over the data socket.  The request completes when the
        push has the bytes in the kernel (or errored, typed, when the
        push fails, the proc closes first, or the peer dies / the cid is
        revoked while parked)."""
        req = SendRequest(dispatch=dispatch)
        self._inflight.add(req)
        spc.record("tcp_isend_deferred", 1)
        rndv_id, _oob = self._park_rndv(obj, dest, seq, req=req,
                                        tctx=tctx, parent=parent)
        self._arm_isend_poison(req, dest, cid, rndv_id=rndv_id)
        rts = dss.pack(
            *self._frame_objs(
                tag, cid, seq, (_RTS_MARK, self.rank, rndv_id, nbytes),
                tctx),
        )
        if parent is not None and ztrace.active:
            ztrace.instant(ztrace.RTS, self.rank, parent=parent,
                           dest=dest, tag=tag, cid=cid, seq=seq,
                           nbytes=nbytes)

        def send_rts():
            sock = self._endpoint(dest)
            self._framed_send(sock, rts)

        # the RTS rides the ordered channel (it IS the matchable
        # message — per-source FIFO with every eager frame before it);
        # its write does NOT complete the request — the data push does
        self._enqueue_deferred(dest, req, send_rts, finish=False)
        return req

    def _isend_sm(self, smtx: sm_mod.SmSender, obj: Any, dest: int,
                  tag: int, cid: int, seq: int, nbytes: int, dispatch,
                  tctx=None):
        """Shared-memory deferred send.  Ring backpressure already IS
        the in-flight bound, so a small frame tries the single-slot
        copy-in NONBLOCKING and is born complete when it lands; a frame
        the ring's free slots already cover streams inline (still
        nonblocking); otherwise a producer continuation parks on the
        progress engine instead of blocking the caller."""
        req = SendRequest(dispatch=dispatch)
        self._arm_isend_poison(req, dest, cid)
        ch = self._out_channels.get(dest)
        idle = ch is None or not ch.busy()
        oob_min = int(mca_var.get("tcp_zero_copy_min", 0))
        frame_objs = self._frame_objs(tag, cid, seq, obj, tctx)
        if idle and nbytes + 512 <= min(smtx.slot_bytes, 32 << 10):
            try:
                wire = smtx.send_direct(
                    frame_objs, oob_min,
                    time.monotonic(), None,
                )
            except sm_mod.RingFull:
                pass  # park the continuation below
            except (errors.MpiError, OSError) as e:
                req.complete_error(self._deferred_exc(e, dest))
                return req
            else:
                if wire is not None:
                    spc.record("sm_bytes_sent", wire)
                    spc.record("sm_eager_sends", 1)
                    req.complete()
                    return req
                # frame does not fit one slot: fragment pipeline below
        prebuilt = None
        if idle:
            # the ring has room for ALL of the frame: run the fragment
            # pipeline inline — the copy-in never waits on the consumer
            prebuilt = dss.pack_frames(*frame_objs, oob_min=oob_min)
            try:
                done = smtx.try_send_frame(*prebuilt)
            except (errors.MpiError, OSError) as e:
                req.complete_error(self._deferred_exc(e, dest))
                return req
            if done is not None:
                wire, nfrags = done
                spc.record("sm_bytes_sent", wire)
                spc.record("sm_eager_sends" if nfrags == 1
                           else "sm_frag_sends", 1)
                req.complete()
                return req
        self._inflight.add(req)
        spc.record("tcp_isend_deferred", 1)

        def work():
            if prebuilt is not None:
                # stream the SAME header/segments once the ring drains
                # (no second DSS pack on the backpressured path)
                self._sm_send_prebuilt(smtx, dest, *prebuilt)
            else:
                # frame_objs already accounted its wire-context bytes
                self._sm_send(smtx, obj, dest, tag, cid, seq, nbytes,
                              objs=frame_objs)

        self._enqueue_deferred(dest, req, work, finish=True)
        return req

    def _sm_send_prebuilt(self, smtx: sm_mod.SmSender, dest: int,
                          header, oob) -> None:
        """Parked-continuation body for an sm isend whose frame was
        already serialized for the nonblocking attempt: the blocking
        fragment pipeline over the same pinned segments."""
        deadline = time.monotonic() + self._timeout
        wire, nfrags = smtx.send_frame(header, oob, deadline,
                                       self._sm_abort(dest))
        spc.record("sm_bytes_sent", wire)
        spc.record("sm_eager_sends" if nfrags == 1 else "sm_frag_sends",
                   1)

    def isend(self, obj: Any, dest: int, tag: int = 0, cid: int = 0,
              poll: bool = False):
        """True MPI_Isend: the buffer-reuse contract is DEFERRED to
        request completion.  The caller's buffers are pinned (no eager
        copy, no rendezvous park copy) and handed to the per-proc
        progress engine — per-destination FIFO channels drained by the
        push-pool workers (eager: queued sendmsg; rendezvous: RTS parks
        the descriptor, CTS pushes the pinned buffers over the data
        socket; sm: slot copy-in, or a parked producer continuation when
        the ring is full).  ``wait()``/``test()`` gate buffer reuse and surface
        failures at completion: on an ft proc a revoked cid or
        known-failed destination returns an ERRORED request (never a
        synchronous raise), an in-flight send whose peer dies completes
        as ``ProcFailed``, and a revoke flood poisons parked sends.  A
        tensor the wire cannot carry raises dss's ``TypeError_`` here,
        before anything is queued.  ``poll=True`` marks a framework-internal send: errors raise raw
        at wait, bypassing the errhandler disposition."""
        if not 0 <= dest < self.size:
            raise errors.RankError(f"rank {dest} out of range")
        if tag < 0:
            raise errors.TagError(f"negative tag {tag}")
        _refuse_device(obj)
        if flightrec.active and not poll:
            flightrec.record(flightrec.SEND, rank=self.rank, dest=dest,
                             tag=tag, cid=cid, nb=True)
        dispatch = None if poll else self.call_errhandler
        state = self.ft_state
        if state is not None and state.is_revoked(cid):
            return SendRequest.errored(
                errors.Revoked(f"isend on revoked cid={cid}", cid=cid),
                dispatch=dispatch,
            )
        if state is not None and state.is_failed(dest):
            return SendRequest.errored(
                errors.ProcFailed(
                    f"rank {dest} is known failed "
                    f"(cause: {state.cause_of(dest)})",
                    failed_ranks=state.failed(),
                ),
                dispatch=dispatch,
            )
        seq = next(self._seq)
        # tracing plane (armed only): the deferred send span is an
        # instant at dispatch — the rendezvous push/deliver legs carry
        # the durations — and its context rides every frame below
        tspan = tctx = None
        if ztrace.active and not poll:
            tspan = ztrace.begin(ztrace.SEND, self.rank, dest=dest,
                                 tag=tag, cid=cid, seq=seq, nb=True)
            tctx = ztrace.wire_context(tspan.sid, seq)
            if tctx is None:
                tspan = None  # a disarm raced begin(): send untraced
        if dest == self.rank:
            # loopback (btl/self): the single defensive copy IS
            # completion — born complete, exactly like the blocking path
            self._deliver_self(obj, tag, cid, seq, tspan, tctx)
            return SendRequest.completed()
        nbytes = _payload_size(obj)
        smtx = self._sm_tx(dest)
        if smtx is not None:
            req = self._isend_sm(smtx, obj, dest, tag, cid, seq,
                                 nbytes, dispatch, tctx=tctx)
            if tspan is not None:
                tspan.end(transport="sm")
            return req
        if dest in self._sm_declined:
            spc.record("sm_fallback_tcp_sends", 1)
        limit = int(mca_var.get("tcp_eager_limit", 1 << 20))
        if nbytes > limit:
            req = self._isend_rndv(obj, dest, tag, cid, seq, nbytes,
                                   dispatch, tctx=tctx,
                                   parent=tspan.sid if tspan is not None
                                   else None)
            if tspan is not None:
                tspan.end(transport="rndv")
            return req
        req = self._isend_eager(obj, dest, tag, cid, seq, dispatch,
                                tctx=tctx)
        if tspan is not None:
            tspan.end(transport="tcp")
        return req

    def irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              cid: int = 0, poll: bool = False):
        """Nonblocking matched receive returning a Request (a rendezvous
        message completes it when its data lands).  On an ft proc the
        request is failure-aware: classification (revoked cid, named
        dead source, ANY_SOURCE pending semantics) completes it ERRORED
        — typed, from the waiter's progress tick — and a message matched
        after classification re-enters the engine for a retry.
        ``poll=True`` marks a framework-internal receive (the agreement
        protocol's frame waits): typed errors raise raw at wait/test,
        bypassing the errhandler disposition."""
        state = self.ft_state
        abandoned = [False]
        req = Request(dispatch=None if poll else self.call_errhandler) \
            if state is not None else Request()

        def finalize(env: Envelope, payload: Any) -> None:
            # runs while _incoming_cv is held (all engine entry points
            # in this class take it), so `abandoned` is consistent
            if abandoned[0]:
                self.engine.incoming(env, payload)
                return
            req.complete(payload, source=env.src, tag=env.tag)

        def on_match(env: Envelope, payload: Any) -> None:
            if self._resolve_rndv(env, payload, finalize):
                return
            finalize(env, payload)

        with self._incoming_cv:
            self.engine.post_recv(source, tag, cid, on_match)
        if state is not None:
            def prog():
                if req.done:
                    return
                exc = ulfm.classify_recv_failure(state, source, cid)
                if exc is None:
                    return
                with self._incoming_cv:
                    if req.done:
                        return
                    abandoned[0] = True
                req.complete_error(exc)

            req._progress = prog
        return req

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             cid: int = 0, timeout: float | None = None,
             return_status: bool = False, poll: bool = False) -> Any:
        """Blocking matched receive, bounded by ``timeout`` (default: the
        proc's stall timeout).  On timeout the posted receive is
        abandoned and any message it steals afterwards is re-injected into
        the matching engine, so a retry can still find it.

        Timeout disposition: a timeout dispatches through the endpoint's
        errhandler (FATAL aborts, RETURN raises the typed error) —
        UNLESS ``poll=True``, which marks a framework-internal polling
        receive whose timeout is an expected outcome: it raises
        ``InternalError`` directly."""
        timeout = self._timeout if timeout is None else timeout
        if flightrec.active and not poll:
            flightrec.record(flightrec.RECV, rank=self.rank, src=source,
                             tag=tag, cid=cid)
        # tracing plane: the recv span covers post → completion; an
        # error/timeout path never ends it
        trecv = None
        if ztrace.active and not poll:
            trecv = ztrace.begin(ztrace.RECV, self.rank, src=source,
                                 tag=tag, cid=cid)
        result: list[Any] = []
        envs: list[Envelope] = []
        done = threading.Event()
        abandoned = [False]

        def finalize(env: Envelope, payload: Any) -> None:
            # always invoked while _incoming_cv is held (all engine entry
            # points in this class take it), so `abandoned` is consistent
            if abandoned[0]:
                self.engine.incoming(env, payload)
                return
            result.append(payload)
            envs.append(env)
            done.set()

        def on_match(env: Envelope, payload: Any) -> None:
            # a rendezvous RTS resolves asynchronously; `finalize` then
            # runs when the data lands (same abandoned/re-inject contract)
            if self._resolve_rndv(env, payload, finalize):
                return
            finalize(env, payload)

        state = self.ft_state
        if state is not None:
            # revocation poisons pending AND future receives
            fail_exc = ulfm.classify_recv_failure(state, source, cid)
            if isinstance(fail_exc, errors.Revoked):
                if poll:
                    raise fail_exc
                return self.call_errhandler(fail_exc)
        with self._incoming_cv:
            self.engine.post_recv(source, tag, cid, on_match)
        fail_exc = None
        if state is None:
            completed = done.wait(timeout)
        else:
            # sliced wait so peer death classifies promptly: a receive
            # blocked on a rank that dies mid-wait must surface typed
            # ProcFailed, not ride out the full stall timeout
            wait_deadline = time.monotonic() + timeout
            while True:
                if done.wait(0.02):
                    break
                fail_exc = ulfm.classify_recv_failure(state, source, cid)
                if fail_exc is not None or time.monotonic() > wait_deadline:
                    break
            completed = done.is_set()
        if not completed:
            with self._incoming_cv:
                if not done.is_set():
                    abandoned[0] = True
            if not done.is_set():
                if fail_exc is not None:
                    if poll:
                        raise fail_exc
                    return self.call_errhandler(fail_exc)
                # diagnosis: is the message parked unexpected while our
                # posted recv failed to match it? (queue snapshots exist
                # on the Python engine only)
                hit = self.engine.probe(source, tag, cid)
                posted, unexpected = [], []
                rows = getattr(self.engine, "debug_rows", None)
                if rows is not None:
                    posted, unexpected = rows()
                exc = errors.InternalError(
                    f"tcp recv timeout (src={source}, tag={tag}, "
                    f"cid={cid}); probe={hit}; stats={self.engine.stats()}"
                    f"; unexpected={unexpected}; posted={posted}"
                )
                if poll:
                    raise exc  # expected poll outcome, not an error
                return self.call_errhandler(exc)
        if trecv is not None:
            trecv.end(src=envs[0].src, tag=envs[0].tag)
        if return_status:
            env = envs[0]
            return result[0], Status(
                source=env.src, tag=env.tag,
                count_bytes=_payload_bytes(result[0]),
            )
        return result[0]

    def probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              cid: int = 0):
        return self.engine.probe(source, tag, cid)

    def sendrecv(self, obj: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG, cid: int = 0):
        self.send(obj, dest, sendtag, cid)
        return self.recv(source, recvtag, cid)

    def barrier(self) -> None:
        """Dissemination barrier over the wire (two-level over the
        locality groups when the han layer is selected — the same
        dispatch seam the host collectives run through)."""
        han = _han_route(self, "barrier")
        if han is not None:
            return han.barrier(self)
        n = self.size
        k = 1
        while k < n:
            self.send(b"", (self.rank + k) % n, tag=0x7FFD, cid=0x7FFD)
            self.recv(source=(self.rank - k) % n, tag=0x7FFD, cid=0x7FFD)
            k <<= 1

    def close(self) -> None:
        """Quiesce, then tear down.  Queued isend frames and parked
        rendezvous payloads exist only here until the workers (or the
        receiver's CTS) move them, so the deferred-send channels and
        outstanding rendezvous sends drain first (ompi_mpi_finalize's
        quiesce-before-teardown contract), bounded by the stall timeout;
        leftovers are abandoned ERRORED at the end.  On an ft proc the
        control floods still in flight are flushed first, and an orderly
        goodbye (``FT_BYE_CID``) tells the survivors this rank is
        leaving; a severed proc (a simulated crash) says nothing, but
        its segment, reader and sockets are still released here."""
        if self._torn_down:
            return
        self._torn_down = True
        # metrics final flush first, while the store and our state are
        # both fully alive: stop() publishes one last snapshot
        # (final=True) so a job shorter than one publish interval is
        # still fleet-visible, then joins the publisher
        if self._metrics_pub is not None:
            self._metrics_pub.stop()
            self._metrics_pub = None
        # control floods next: an in-flight agreement announce or
        # revoke notice must reach the peers before the wire comes down
        # (a closing rank that takes its announce to the grave strands
        # survivors waiting to adopt it).  Bounded: each flood's
        # per-peer connect deadline is 1 s, and a wedged flood must not
        # hang shutdown.
        flood_deadline = time.monotonic() + 5.0
        with self._flood_lock:
            floods = list(self._flood_threads)
        for t in floods:
            while True:
                try:
                    t.join(max(0.0, flood_deadline - time.monotonic()))
                    break
                except RuntimeError:
                    # registered but not yet started (the flood's
                    # spawner is between append and start()): wait it
                    # into existence, bounded by the same deadline
                    if time.monotonic() >= flood_deadline:
                        break
                    time.sleep(0.001)
        if self.ft_state is not None:
            # re-sweep known-dead peers' in-flight sends before waiting
            # on them: a one-shot failure-listener sweep may have found
            # a frame transiently owned (RTS mid-send) and skipped it
            for r in self.ft_state.failed():
                self._fail_inflight(int(r), "known failed at close")
        deadline = time.monotonic() + self._timeout
        while time.monotonic() < deadline and any(
                ch.busy() for ch in list(self._out_channels.values())):
            time.sleep(0.005)
        while self._rndv_undelivered() and time.monotonic() < deadline:
            time.sleep(0.005)
        if self.ft_state is not None and not self._ft_dead:
            # the goodbye rides TCP while data may still sit in peers'
            # rings: wait (bounded) for our outbound rings to drain so
            # the BYE cannot overtake delivered-but-unread ring frames
            # — the per-socket-FIFO ordering argument, restored across
            # the transport split
            self._sm_quiesce(min(deadline, time.monotonic() + 5.0))
        if self.ft_state is not None and not self._ft_dead:
            # orderly departure: tell the survivors we are LEAVING, so
            # their detectors reconfigure the ring instead of suspecting
            # us via missed beats (cause="goodbye", pre-acknowledged:
            # never a detector false positive, and never a pending gate
            # on survivors' wildcard receives — finalize skew is not a
            # crash) — the goodbye the crash paths (sever/mute)
            # deliberately omit.  Per-socket FIFO puts the goodbye after
            # every frame already sent, so no delivered message is
            # reclassified as lost.
            goodbye = dss.pack(self.rank, 0, ulfm.FT_BYE_CID, 0,
                               [self.rank])
            # sm peers get the goodbye THROUGH their ring: it then
            # trails every data frame this direction ever produced
            # (exact per-direction FIFO — the same argument per-socket
            # ordering makes below), and it reaches peers the data
            # plane never warmed a TCP connection for
            ring_done: set[int] = set()
            with self._sm_lock:
                ring_peers = [(r, s) for r, s in self._sm_senders.items()
                              if s is not None]
            for r, smtx in ring_peers:
                if self.ft_state.is_failed(r):
                    continue
                try:
                    smtx.send_frame(goodbye, [],
                                    time.monotonic() + 2.0, None)
                    ring_done.add(r)
                except errors.MpiError:
                    pass  # wedged/stopped ring: fall through to TCP
            # remaining peers: only ALREADY-CONNECTED ones get the
            # goodbye directly — they are the ones holding delivered
            # frames the notice must trail, and our observer is among
            # them by construction (we beat toward it over a cached
            # socket).  Dialing fresh connections just to say goodbye
            # would stall shutdown on refused-connect retries for peers
            # already gone; recipients gossip the BYE onward
            # (_ft_ctrl), so never-connected survivors still learn.
            with self._conn_lock:
                connected = list(self._conns.items())
            for r, sock in connected:
                if not isinstance(r, int) or r in ring_done \
                        or r == self.rank or self.ft_state.is_failed(r):
                    # tuple keys are intercomm-bridge peers: a DIFFERENT
                    # job's rank namespace, where our departing rank
                    # number would poison their unrelated local rank
                    continue
                try:
                    self._framed_send(sock, goodbye)
                except OSError:
                    pass  # peer already gone: nothing to notify
        # the heartbeat thread stops only NOW: the goodbye above already
        # reconfigured the peers' rings, and our beats had to stay alive
        # through the quiesce so nobody suspected us mid-shutdown.  It
        # must still stop before teardown (no emitting into dying
        # sockets; fixtures assert no detector thread leaks).
        if self._detector is not None:
            self._detector.stop()
        self._closed.set()
        # shutdown() first, close() only after the reader thread exits:
        # closing a socket another thread is reading frees the fd number
        # while that thread may still be about to read it — a NEW socket
        # reusing the fd would have its bytes stolen.  shutdown delivers
        # EOF on the still-valid fd; the engine's close() joins the reader.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self._conns.values()) + self._dup_conns
            self._conns.clear()
            self._dup_conns = []
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        deadline = time.monotonic() + 5.0
        if self._chan_engine is not None:
            self._chan_engine.close(max(0.0, deadline - time.monotonic()))
        # the rendezvous-push pool drains with the proc: the quiesce loop
        # above already waited out pending transfers
        self._push_pool.close(max(0.0, deadline - time.monotonic()))
        # whatever the bounded quiesce could not deliver is abandoned
        # ERRORED now: no SendRequest may stay incomplete and no parked
        # descriptor may survive a closed proc
        self._abandon_inflight(
            "proc closed with undeliverable sends in flight")
        # sm plane last: poll thread joined, peer mappings unmapped, own
        # segment unlinked (rings live exactly as long as their proc)
        self._sm_teardown()
        # han tag-window registrations die with the proc
        from . import groups as groups_mod

        groups_mod.release(self)
        try:
            self._listener.close()
        except OSError:
            pass
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass

