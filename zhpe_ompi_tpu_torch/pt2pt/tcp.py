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

``TcpProc`` mirrors :class:`~zhpe_ompi_tpu_torch.pt2pt.universe
.RankContext`'s API (send/recv/probe/sendrecv/barrier and the host and
nonblocking collectives).

What is not ported yet, against the namesake — each raises
``UnsupportedError`` naming the module it waits for:

- **fault tolerance** (``ft/ulfm.py``): ``ft=True``,
  ``rejoin``/``rejoin_book``, elastic ``live_ranks``, and
  ``revoke``/``sever``/``mute`` and the other ULFM methods (with them the
  sm plane's death listener, :meth:`TcpProc._sm_peer_dead`, which is
  ported but registered by nothing yet).
- **the PMIx store** (``runtime/pmix.py``, item 4): ``pmix=`` (the
  store-served modex and rejoin), and ``metrics``/``trace``, which
  publish through it (an explicit ``True`` raises; the ``ZMPI_METRICS``
  and ``ZMPI_TRACE`` environment requests degrade loudly, as the
  namesake's do without a store).
- ``_register_wire_pvars`` and its queue-depth reader wait for
  ``tools/mpit.py``; ``bridge_endpoint``/``bridge_send``, the intercomm
  seam, wait for ``comm/dpm.py`` — a bridge peer's hello is still
  understood on the wire; the one-sided seam (the namesake's
  ``sm_rma_region``, ``sm_direct_to``) is not here: it waits for
  ``osc/direct.py``.
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
            # _push_rndv catches every escape itself and completes its
            # request errored; this is the worker's don't-die backstop
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


def _waits_for_pmix(what: str) -> errors.UnsupportedError:
    return errors.UnsupportedError(
        f"{what} needs the PMIx store (runtime/pmix.py), which the PyTorch "
        "port has not ported yet")


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
    keyword arguments are all accepted; those that need a module the port
    lacks raise ``UnsupportedError`` naming it (see the module doc).
    ``sm`` (default: the ``sm`` MCA var, 1) creates this rank's ring
    segment when ``size`` > 1; ``sm_boot_id``/``sm_numa_id`` override the
    host and NUMA-domain tokens its card advertises."""

    #: no ULFM failure state until ft/ulfm.py is ported (see module doc)
    ft_state = None

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
        if pmix is not None:
            raise _waits_for_pmix("pmix= (the store-served modex)")
        if ft or rejoin or rejoin_book is not None:
            raise ulfm._waits_for_ft(
                "ft=True" if ft else "rejoining a job (rejoin/rejoin_book)")
        if live_ranks is not None \
                and frozenset(int(r) for r in live_ranks) != \
                frozenset(range(size)):
            raise ulfm._waits_for_ft("elastic membership (live_ranks)")
        if metrics:
            raise _waits_for_pmix("metrics=True")
        if trace:
            raise _waits_for_pmix("trace=True")
        for env, plane in (("ZMPI_METRICS", "metrics"),
                           ("ZMPI_TRACE", "tracing")):
            if metrics is None and trace is None \
                    and os.environ.get(env, "") not in ("", "0"):
                mca_output.emit(
                    _stream,
                    "rank %s: %s set but no PMIx store to publish into; "
                    "%s plane disabled", rank, env, plane,
                )
        self.rank = rank
        self.size = size
        self.engine = matching.make_matching_engine()
        self._seq = itertools.count()
        self._rndv_ids = itertools.count(1)
        # rndv_id -> parked data-frame segments.  send() parks COPIES
        # (its buffer-reuse contract holds at return); isend parks the
        # DESCRIPTOR — the caller's own buffers, pinned by the
        # SendRequest until the CTS-released push completes.
        self._pending_rndv: dict[int, list] = {}
        # rndv_id -> (dest, SendRequest-or-None): who the transfer is
        # for and which request its push completes (None for blocking
        # sends)
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
        self._dup_conns: list[socket.socket] = []  # crossed-connect extras
        self._timeout = timeout
        self._conns: dict[int, socket.socket] = {}
        self._conn_lock = lockdep.lock("tcp.TcpProc._conn_lock")
        # guards the per-socket lock registry only
        self._send_lock = lockdep.lock("tcp.TcpProc._send_lock")
        self._sock_locks: weakref.WeakKeyDictionary = \
            weakref.WeakKeyDictionary()  # socket -> its framing lock
        self._closed = threading.Event()
        self._incoming_cv = threading.Condition()
        _live_procs.add(self)
        # shared-memory plane (btl/sm analog): create OUR inbound-ring
        # segment before the modex so the card advertises a segment that
        # already exists — a peer that got the book maps it with no
        # handshake and no transport-switch reordering window
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
        if sm_on and size > 1:
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
            self.address_book = self._modex(coordinator, timeout)
            mca_output.verbose(
                5, _stream, "rank %d up at %s; book=%s", rank, self.address,
                self.address_book,
            )
        except BaseException:
            # a proc that never finished wiring up still owns a reader
            # thread, and nobody will ever call close() on a constructor
            # that raised — the zero-leak lifecycle contract is honored
            # HERE, whichever construction step failed
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
            # first contact raced the peer's close: its consumer is never
            # coming back; without fault tolerance the pair degrades to
            # TCP loudly (the namesake classifies peer death here on an
            # ft proc)
            with self._sm_lock:
                self._sm_senders[dest] = None  # pinned to TCP
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
        """The ring-full spin's abort probe: a local close ends the wait
        (the namesake also classifies a failed peer here on ft procs)."""
        closed = self._closed

        def abort():
            if closed.is_set():
                raise errors.InternalError(
                    f"sm send to rank {dest} on a closed proc"
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
        bounded by the stall timeout)."""
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
        self._trace_ingest(vals, "sm")
        env = Envelope(src, tag, cid, seq)
        with self._incoming_cv:
            self.engine.incoming(env, payload)
            self._incoming_cv.notify_all()

    def _sm_peer_dead(self, rank: int, _cause: str) -> None:
        """Failure-listener hook (the namesake registers it with its
        ``FailureState``; nothing registers it until ``ft/ulfm.py`` is
        ported): a dead peer's consumer is never coming back — unmap our
        ring into it and pin the pair to TCP."""
        with self._sm_lock:
            stale = self._sm_senders.get(rank)
            self._sm_senders[rank] = None
            self._sm_declined.discard(rank)
        if stale is not None:
            stale.close()

    def _sm_teardown(self) -> None:
        with self._sm_lock:
            senders = [s for s in self._sm_senders.values()
                       if s is not None]
            self._sm_senders = {r: None for r in self._sm_senders}
        for s in senders:
            s.close()
        if self._sm_seg is not None:
            self._sm_seg.close()


    # -- what waits for modules not ported yet -----------------------------

    def sever(self) -> None:
        """Simulated process death (the fault-injection hook) waits for
        fault tolerance."""
        raise ulfm._waits_for_ft("sever")

    def mute(self) -> None:
        """Simulated hang (the fault-injection hook) waits for fault
        tolerance."""
        raise ulfm._waits_for_ft("mute")

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
        # unpack_from: array payloads become writable views over the
        # frame's dedicated recv_into buffer — the zero-copy receive
        # half (the frame bytearray stays alive via the views)
        vals = dss.unpack_from(frame)
        src, tag, cid, seq, payload = vals[:5]
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
        # lazy connection establishment (btl_tcp_endpoint shape) with
        # exponential backoff + jitter bounded by a total deadline: a
        # peer still wiring up is retried.  Cards may carry extra
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
                if isinstance(e, (ConnectionRefusedError,
                                  ConnectionResetError)):
                    # the peer advertised this port through the modex, so
                    # its listener WAS bound — refused now means it is
                    # gone (no rejoin path without ft): fail fast
                    raise
                if backoff.expired(lookahead=backoff.delay):
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


    # -- MPI surface (RankContext-compatible) ----------------------------


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
            except errors.InternalError as exc:
                # wedged/stopped/closed ring: a transport failure — the
                # same disposition routing a TCP stall gets
                if poll:
                    raise
                return self.call_errhandler(exc)
        if dest in self._sm_declined:
            # the peer advertised an sm endpoint we could not ride
            # (boot mismatch, unmappable segment): visible, not silent
            spc.record("sm_fallback_tcp_sends", 1)
        limit = int(mca_var.get("tcp_eager_limit", 1 << 20))
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
        # sendmsg — the blocking send completes only after the kernel has
        # the bytes, so buffer reuse stays safe
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
        the progress engine, observed at wait() instead of at the call."""
        if isinstance(e, errors.MpiError):
            return e
        if isinstance(e, OSError):
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
        push fails or the proc closes first)."""
        req = SendRequest(dispatch=dispatch)
        self._inflight.add(req)
        spc.record("tcp_isend_deferred", 1)
        rndv_id, _oob = self._park_rndv(obj, dest, seq, req=req,
                                        tctx=tctx, parent=parent)
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
        failures at completion.  A tensor the wire cannot carry raises
        dss's ``TypeError_`` here, before anything is queued.
        ``poll=True`` marks a framework-internal send: errors raise raw
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
        message completes it when its data lands)."""
        req = Request()

        def on_match(env: Envelope, payload: Any) -> None:
            if self._resolve_rndv(env, payload, finalize):
                return
            finalize(env, payload)

        def finalize(env: Envelope, payload: Any) -> None:
            req.complete(payload, source=env.src, tag=env.tag)

        with self._incoming_cv:
            self.engine.post_recv(source, tag, cid, on_match)
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

        with self._incoming_cv:
            self.engine.post_recv(source, tag, cid, on_match)
        if not done.wait(timeout):
            with self._incoming_cv:
                if not done.is_set():
                    abandoned[0] = True
            if not done.is_set():
                # diagnosis: is the message parked unexpected while our
                # posted recv failed to match it?
                hit = self.engine.probe(source, tag, cid)
                posted, unexpected = self.engine.debug_rows()
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
        leftovers are abandoned ERRORED at the end."""
        if self._closed.is_set():
            return
        deadline = time.monotonic() + self._timeout
        while time.monotonic() < deadline and any(
                ch.busy() for ch in list(self._out_channels.values())):
            time.sleep(0.005)
        while self._rndv_undelivered() and time.monotonic() < deadline:
            time.sleep(0.005)
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

