"""PMIx-analog key-value server — the name-served modex of the runtime plane
(namesake: ``zhpe_ompi_tpu/runtime/pmix.py``; the port's own copy).

In the reference the entire wire-up rendezvous lives OUT of tree: ``mpirun``
is a symlink to the external ``prte`` binary and OpenPMIx is an empty
submodule (SURVEY.md critical facts; ``.gitmodules:4-11``).  Every rank is a
PMIx *client*: it ``put``\\ s its business card under its process name,
``commit``\\ s, enters a ``fence`` across the namespace, and ``get``\\ s its
peers' cards — with get-until-published blocking semantics, so a late
reader simply waits for the publisher instead of erroring (the
``PMIx_Get`` contract the reference's modex rides).

This module is that server IN tree, with the real verb semantics:

- **namespace = jobid**: every job's keys live in their own namespace;
  a resident DVM (:mod:`.dvm`) hosts ONE store across many jobs, so a
  second job launched into the daemon re-pays none of the rendezvous
  infrastructure.
- **put → commit**: puts stage locally to the rank's scratch; nothing is
  visible to peers until ``commit`` publishes the batch (the
  PMIx_Put/PMIx_Commit split).
- **fence**: a namespace-wide barrier (``PMIx_Fence`` with collect
  semantics — by the time it releases, every rank's committed data is
  published and gettable).
- **get(ns, key)**: blocks until the key is published or the deadline
  passes — a joiner never races the publisher.
- **generation-tagged entries**: every published value carries the
  namespace's generation at commit time.  A respawned rank's fresh card
  (published in the bumped generation of its recovery window) is
  distinguishable from the corpse's, and ``get_meta`` exposes the tag.

Three surfaces share one :class:`PmixStore`:

- in-process (the store object itself — thread ranks, unit tests),
- :class:`PmixServer` — the store behind a length-framed DSS wire (one
  multiplexed channel engine serves every connection; blocking verbs
  park as waiter RECORDS a single completer thread answers),
- :class:`PmixClient` — the rank-side verbs over one persistent socket.

Hygiene is observable like every other plane's: servers register weakly
(:func:`live_servers` must be empty once tests close them) and a closed
server must hold zero namespace state (:func:`stale_namespaces` — the
daemon destroys a job's namespace when the job ends).

The frames are the port's ``utils/dss``, byte for byte the namesake's, so
a port client talks to a JAX-package server and the reverse.  A value
stored as a numpy array comes back through the wire as a CPU tensor
(dss's decode in the port); the in-process store hands back exactly the
object that was put.  The store and the server touch no device.

SPC counters (recorded by the STORE, i.e. in the server/daemon process):
``pmix_puts`` / ``pmix_gets`` / ``pmix_fences`` — see
:mod:`zhpe_ompi_tpu_torch.runtime.spc` for the full table.
"""

from __future__ import annotations

import socket
import threading
import time
import weakref
from typing import Any

from ..core import errors
from ..mca import output as mca_output
from . import spc

_stream = mca_output.open_stream("pmix")

# hygiene registries (read by the tests' hygiene asserts)
_live_servers: weakref.WeakSet = weakref.WeakSet()
_live_stores: weakref.WeakSet = weakref.WeakSet()


def live_servers() -> list[str]:
    """PMIx servers still listening — must be [] after tests/daemons
    close theirs (a leaked listener holds a port for the whole suite)."""
    return [
        f"pmix-server:{srv.address[0]}:{srv.address[1]}"
        for srv in list(_live_servers)
        if not srv.closed
    ]


def stale_metric_keys() -> list[str]:
    """Published ``metrics:*`` / ``flightrec:*`` / ``metrics_base:*``
    / ``trace:*`` / ``tracesync:*`` keys still held in any tracked
    store at session end — namespace destroy drops a job's whole
    keyspace, so anything here is an observability-plane leak (a
    publisher outliving its job, or a bench namespace nobody tore
    down)."""
    out = []
    for store in list(_live_stores):
        for ns in store.namespaces():
            for key in store.lookup(ns):
                if key.startswith(("metrics:", "flightrec:",
                                   "metrics_base:", "trace:",
                                   "tracesync:")):
                    out.append(f"pmix-key:{ns}:{key}")
    return out


def stale_namespaces() -> list[str]:
    """Namespace state still held in any tracked store at session end —
    the daemon destroys a job's namespace when the job ends and
    ``close()`` clears the rest, so anything still here after the suite
    is leaked rendezvous state (an unstopped daemon, or a job whose
    namespace was never torn down)."""
    out = []
    for store in list(_live_stores):
        out += [f"pmix-ns:{ns}" for ns in store.namespaces()]
    return out


# -- the ztune table plane (tools/ztune <-> coll/ztable) ----------------
#
# ztune distills a swept decision table and publishes it HERE, under a
# well-known namespace/key, so every subsequent job launched on the same
# DVM resolves the tuned table for ITS topology at init with zero
# re-sweeping (coll/ztable.py fetches through ``fetch_tuned_table``).

ZTUNE_NS = "ztune"
ZTUNE_KEY = "tuned_table"
#: the publishing "rank" — the table has one writer (the sweep harness),
#: so the namespace is size 1 and rank 0 owns the put/commit.
ZTUNE_RANK = 0


def publish_tuned_table(store, text: str) -> None:
    """Publish a ztune-distilled decision table under the well-known
    ztune key.  ``store`` is anything with the shared verb surface —
    a :class:`PmixStore` (in-process) or :class:`PmixClient` (a sweep
    harness publishing into a live zprted's store over the wire)."""
    store.ensure_ns(ZTUNE_NS, 1)
    store.put(ZTUNE_NS, ZTUNE_RANK, ZTUNE_KEY, str(text))
    store.commit(ZTUNE_NS, ZTUNE_RANK)


def fetch_tuned_table(address: "tuple[str, int] | str",
                      timeout: float = 5.0) -> "str | None":
    """Fetch the published tuned table from the store at ``address``,
    or None.  NEVER raises: a DVM with no published table, an
    unreachable/closed store, or a mid-job store loss all degrade to
    None — the caller's file/builtin ladder applies (the loud-
    degradation contract; reported at verbose level, not an error)."""
    client = None
    try:
        client = PmixClient(address, timeout=timeout)
        published = client.lookup(ZTUNE_NS, ZTUNE_KEY)
    except (errors.MpiError, OSError, ValueError) as e:
        mca_output.verbose(
            1, _stream,
            "ztune table fetch from %r failed (%s); file/builtin "
            "decisions apply", address, e,
        )
        return None
    finally:
        if client is not None:
            client.close()
    text = published.get(ZTUNE_KEY)
    if isinstance(text, str) and text:
        spc.record("tuned_table_store_fetches")
        return text
    return None


def stale_tuned_tables() -> list[str]:
    """ztune table state still published in a tracked store at session
    end — a DVM's ``stop()`` (via ``store.close()``) or an explicit
    ``destroy_ns(ZTUNE_NS)`` drops it; anything here is a sweep that
    published into a store nobody tore down."""
    out = []
    for store in list(_live_stores):
        for ns in store.namespaces():
            if ns == ZTUNE_NS:
                out.append(
                    f"pmix-ztune:{ns}:{sorted(store.lookup(ns))}"
                )
    return out


def parse_addr(address: "tuple[str, int] | str") -> tuple[str, int]:
    """Normalize a ``"host:port"`` string or ``(host, port)`` pair —
    one parser for every runtime-plane client/server address."""
    if isinstance(address, str):
        host, port = address.rsplit(":", 1)
        return (host, int(port))
    return (address[0], int(address[1]))


def conn_alive(conn) -> bool:
    """Non-blocking liveness check on a served connection: a peer that
    closed (EOF readable) or reset is DEAD; a peer with nothing to say
    is alive.  The admission queue polls this so a queued launch whose
    client died is reaped instead of wedging the queue head — the
    check never consumes protocol bytes (``MSG_PEEK``) and never
    blocks (``select`` with a zero timeout)."""
    import select

    try:
        readable, _, _ = select.select([conn], [], [], 0)
        if not readable:
            return True
        return conn.recv(1, socket.MSG_PEEK) != b""
    except OSError:
        return False


class _PrefixedConn:
    """A served socket with a few already-buffered bytes in front: the
    channel engine may have read a partial NEXT frame before a streamed
    op detached the connection, and those bytes must reach the detached
    thread's blocking ``_recv_frame`` loop first.  ``recv_into``/
    ``recv`` consume the prefix (peeks don't), everything else —
    sends, fileno, close — delegates to the real socket, so the wrapper
    can stand in for the connection everywhere a handler passes it
    on."""

    def __init__(self, sock: socket.socket, prefix: bytes):
        self._sock = sock
        self._prefix = bytes(prefix)

    def recv_into(self, buf, nbytes: int = 0) -> int:
        if self._prefix:
            view = memoryview(buf)
            n = min(len(self._prefix), nbytes or view.nbytes)
            view[:n] = self._prefix[:n]
            self._prefix = self._prefix[n:]
            return n
        return self._sock.recv_into(buf, nbytes) if nbytes \
            else self._sock.recv_into(buf)

    def recv(self, bufsize: int, flags: int = 0) -> bytes:
        if self._prefix:
            if flags & socket.MSG_PEEK:
                return self._prefix[:bufsize]
            out, self._prefix = (self._prefix[:bufsize],
                                 self._prefix[bufsize:])
            return out
        return self._sock.recv(bufsize, flags)

    def __getattr__(self, name: str):
        return getattr(self._sock, name)


class FramedRpcServer:
    """Shared scaffold of the runtime plane's framed-RPC servers (the
    PMIx store wire and the zprted control port): one SO_REUSEADDR
    listener (a daemon restarted onto a just-stopped predecessor's
    port must ride over the TIME_WAIT corpse), ``["ok", value]``/
    ``["err", msg]`` reply enveloping, and the shutdown close ladder.

    Connections are NOT served thread-per-connection: every framed
    channel of one server multiplexes onto its single
    :class:`~zhpe_ompi_tpu_torch.pt2pt.engine_mux.ChannelEngine` reader, and
    fast verbs dispatch inline on the engine thread (they are O(1)
    store/daemon state transitions).  Two escape hatches keep the
    blocking
    shapes working without parking the engine:

    - **streamed ops** (:attr:`_STREAMED_OPS`, or
      :meth:`_wants_stream`) own their connection for its whole life —
      the zprted ``launch``/``attach``/``lifeline`` shape.  The channel
      detaches from the engine (partial-frame bytes ride along via
      :class:`_PrefixedConn`) and a dedicated thread runs the classic
      blocking serve loop; thread count is bounded by op KIND and tree
      fan-out, not client count.
    - **deferred ops** (:meth:`_defer_request`) take ownership of the
      REPLY and return True — the PMIx ``get``/``fence`` shape, where a
      completer thread answers when the store state lands.

    Subclasses implement :meth:`_handle_request`; it returns the reply
    value, raises ``MpiError`` for an errored reply, or returns
    :attr:`STREAMED` when it already emitted its own frames.
    :meth:`_after_reply` (default True) may return False to stop
    serving the connection after a reply (the stop RPC's shape).
    """

    #: sentinel: the handler streamed its own reply frames
    STREAMED = object()
    #: ops whose handler owns the connection for its whole life
    _STREAMED_OPS: frozenset = frozenset()

    def __init__(self, host: str, port: int, name: str,
                 backlog: int = 64):
        from ..pt2pt import engine_mux

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._srv.bind((host, port))
        except OSError:
            self._srv.close()
            raise
        self._srv.listen(backlog)
        self.address: tuple[str, int] = self._srv.getsockname()
        self.closed = False
        self._rpc_name = name
        self._conns: list[socket.socket] = []
        self._conn_locks: dict[socket.socket, threading.Lock] = {}
        self._rpc_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._engine = engine_mux.ChannelEngine(
            f"{name}-{self.address[1]}")
        self._engine.add_listener(self._srv, self._rpc_accept)
        self._engine.start()

    def _handle_request(self, req: list, conn, conn_lock) -> Any:
        raise NotImplementedError

    def _after_reply(self, req: list) -> bool:
        return True

    def _wants_stream(self, op) -> bool:
        """Should this op detach the connection to a dedicated
        blocking-serve thread?  Default: membership in
        :attr:`_STREAMED_OPS`."""
        return op in self._STREAMED_OPS

    def _defer_request(self, req: list, conn, conn_lock) -> bool:
        """Take ownership of the reply for a blocking verb (a completer
        answers later) — return True to do so.  Default: nothing
        defers."""
        return False

    # -- engine-side serving ----------------------------------------------

    def _rpc_accept(self, conn: socket.socket) -> None:
        with self._rpc_lock:
            self._conns.append(conn)
            self._conn_locks[conn] = threading.Lock()
        self._engine.add_channel(
            conn, f"rpc:{conn.fileno()}", self._on_req_frame,
            on_close=self._on_chan_close)

    def _on_chan_close(self, chan) -> None:
        self._drop_conn(chan.sock)

    def _drop_conn(self, conn) -> None:
        with self._rpc_lock:
            if conn in self._conns:
                self._conns.remove(conn)
            self._conn_locks.pop(conn, None)
        try:
            conn.close()
        except OSError:
            pass

    def _on_req_frame(self, chan, frame) -> None:
        from ..pt2pt.tcp import _send_frame
        from ..utils import dss

        conn = chan.sock
        [req] = dss.unpack(frame)
        op = req[0] if isinstance(req, (list, tuple)) and req else None
        with self._rpc_lock:
            conn_lock = self._conn_locks.get(conn)
        if conn_lock is None:
            conn_lock = threading.Lock()
        if self._wants_stream(op):
            # the handler owns this connection now: hand any
            # partially-buffered next frame over with it
            leftover = self._engine.detach(conn)
            t = threading.Thread(
                target=self._serve_detached,
                args=(conn, conn_lock, req, leftover), daemon=True,
                name=f"{self._rpc_name}-conn-{self.address[1]}",
            )
            with self._rpc_lock:
                self._threads = [x for x in self._threads
                                 if x.is_alive()]
                self._threads.append(t)
            t.start()
            return
        if self._defer_request(req, conn, conn_lock):
            return  # a completer owns the reply
        reply = self._run_handler(req, conn, conn_lock)
        if reply is None:
            return  # STREAMED: the handler emitted its own frames
        alive = True
        try:
            with conn_lock:
                _send_frame(conn, dss.pack(reply))
        except OSError:
            alive = False  # client went away mid-reply: its problem
        if not alive or not self._after_reply(req):
            self._engine.discard(conn)
            self._drop_conn(conn)

    def _run_handler(self, req: list, conn, conn_lock
                     ) -> "list | None":
        try:
            out = self._handle_request(req, conn, conn_lock)
            if out is self.STREAMED:
                return None
            return ["ok", out]
        except errors.MpiError as e:
            return ["err", str(e)]
        except Exception as e:  # noqa: BLE001 - a malformed request
            # must error the REPLY, not silently kill the serving loop
            return ["err", f"{type(e).__name__}: {e}"]

    def _serve_detached(self, conn, conn_lock, first_req,
                        leftover: bytes) -> None:
        """The classic blocking serve loop, for connections a streamed
        op took over (first request pre-consumed by the engine)."""
        from ..pt2pt.tcp import _recv_frame, _send_frame
        from ..utils import dss

        rconn = _PrefixedConn(conn, leftover) if leftover else conn
        req = first_req
        try:
            while not self.closed:
                reply = self._run_handler(req, rconn, conn_lock)
                if reply is not None:
                    with conn_lock:
                        _send_frame(conn, dss.pack(reply))
                if reply is not None and not self._after_reply(req):
                    return
                frame = _recv_frame(rconn)
                if frame is None:
                    return
                [req] = dss.unpack(frame)
        except OSError:
            return  # client went away mid-request: its own problem
        finally:
            self._drop_conn(conn)

    def close(self) -> None:
        """The shutdown ladder: close the listener, shutdown() every
        connection (EOF wakes the engine's channels AND any detached
        blocking serve loop), join the engine reader BEFORE freeing the
        fds (the fd-reuse byte-stealing hazard), then bounded-join the
        detached threads (skipping the calling thread: a stop RPC
        closes from its own handler)."""
        if self.closed:
            return
        self.closed = True
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._rpc_lock:
            conns = list(self._conns)
            self._conns = []
            self._conn_locks.clear()
            threads = list(self._threads)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        deadline = time.monotonic() + 5.0
        self._engine.close(max(0.0, deadline - time.monotonic()))
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        me = threading.current_thread()
        for t in threads:
            if t is me:
                continue
            t.join(max(0.0, deadline - time.monotonic()))


class _Namespace:
    """One job's keyspace: size, staged puts per rank, published KV with
    generation tags, and the fence epoch machinery."""

    __slots__ = ("size", "generation", "staged", "kv", "fence_epoch",
                 "fence_entered")

    def __init__(self, size: int):
        self.size = size
        self.generation = 0
        self.staged: dict[int, dict[str, Any]] = {}
        # key -> (generation, value)
        self.kv: dict[str, tuple[int, Any]] = {}
        self.fence_epoch = 0
        self.fence_entered: set[int] = set()


class PmixStore:
    """The namespace-scoped KV store itself — usable in-process (the
    daemon and unit tests hold it directly) and behind
    :class:`PmixServer`'s wire.  All verbs are thread-safe; blocking
    verbs (``get``, ``fence``) park on the store condition."""

    #: this store exposes the non-blocking probe surface
    #: (try_get_meta/fence_enter/fence_done) a PmixServer's deferred
    #: wire verbs ride — a RoutedStore does NOT (its get forwards
    #: upstream over a blocking connection), so its server detaches
    #: blocking verbs to threads instead (bounded by LOCAL rank count)
    supports_deferred_verbs = True

    def __init__(self):
        self._ns: dict[str, _Namespace] = {}
        self._cv = threading.Condition()
        self.open = True
        # coherence hooks for a store that fronts a DAEMON TREE
        # (runtime/dvmtree.py): the root daemon sets these so every
        # generation bump / namespace destroy — whichever surface it
        # arrived through (wire verb, respawn RPC, resize) — rides the
        # tree links down as cache invalidations.  Called OUTSIDE the
        # store lock, after the mutation is visible.
        self.on_generation: "Any | None" = None
        self.on_destroy: "Any | None" = None
        _live_stores.add(self)

    # -- namespace lifecycle ---------------------------------------------

    def ensure_ns(self, ns: str, size: int) -> None:
        """Create ``ns`` (idempotent).  A size mismatch on an existing
        namespace is a caller bug — two different jobs may not share a
        name."""
        with self._cv:
            have = self._ns.get(ns)
            if have is None:
                self._ns[ns] = _Namespace(int(size))
            elif have.size != int(size):
                raise errors.ArgError(
                    f"pmix: namespace {ns!r} exists with size {have.size}, "
                    f"not {size}"
                )

    def destroy_ns(self, ns: str) -> bool:
        """Drop a job's keyspace (the daemon calls this when the job
        ends; PMIx_server_deregister_nspace shape).  Waiters blocked in
        get/fence on it observe the drop and error out."""
        with self._cv:
            existed = self._ns.pop(ns, None) is not None
            self._cv.notify_all()
        if existed and self.on_destroy is not None:
            self.on_destroy(ns)
        return existed

    def namespaces(self) -> list[str]:
        with self._cv:
            return sorted(self._ns)

    def clear(self) -> None:
        with self._cv:
            self._ns.clear()
            self._cv.notify_all()

    def _require(self, ns: str) -> _Namespace:
        space = self._ns.get(ns)
        if space is None:
            raise errors.ArgError(f"pmix: unknown namespace {ns!r}")
        return space

    # -- verbs ------------------------------------------------------------

    def put(self, ns: str, rank: int, key: str, value: Any) -> None:
        """Stage ``key=value`` in the rank's scratch — invisible to
        peers until :meth:`commit` (the PMIx_Put contract)."""
        with self._cv:
            space = self._require(ns)
            space.staged.setdefault(int(rank), {})[str(key)] = value
        spc.record("pmix_puts")

    def commit(self, ns: str, rank: int) -> int:
        """Publish the rank's staged puts, tagging each entry with the
        namespace's CURRENT generation; returns that generation."""
        with self._cv:
            space = self._require(ns)
            staged = space.staged.pop(int(rank), {})
            gen = space.generation
            for key, value in staged.items():
                space.kv[key] = (gen, value)
            self._cv.notify_all()
            return gen

    def get(self, ns: str, key: str, timeout: float = 30.0,
            min_generation: int = 0) -> Any:
        """Blocking get-until-published: waits for ``key`` to appear (at
        or above ``min_generation`` — a recovery window can insist on a
        FRESH card, not the corpse's) or raises after ``timeout``."""
        value, _gen = self.get_meta(ns, key, timeout, min_generation)
        return value

    def get_meta(self, ns: str, key: str, timeout: float = 30.0,
                 min_generation: int = 0) -> tuple[Any, int]:
        """:meth:`get` plus the entry's generation tag."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                space = self._ns.get(ns)
                if space is None:
                    raise errors.ArgError(f"pmix: unknown namespace {ns!r}")
                hit = space.kv.get(str(key))
                if hit is not None and hit[0] >= int(min_generation):
                    spc.record("pmix_gets")
                    return hit[1], hit[0]
                left = deadline - time.monotonic()
                if left <= 0 or not self.open:
                    raise errors.InternalError(
                        f"pmix: get({ns!r}, {key!r}) not published within "
                        f"{timeout}s"
                    )
                self._cv.wait(min(left, 0.25))

    def try_get_meta(self, ns: str, key: str, min_generation: int = 0
                     ) -> "tuple[Any, int] | None":
        """Non-blocking probe behind the deferred wire ``get``: the
        ``(value, generation)`` hit, or None while unpublished.  Raises
        exactly what a blocking :meth:`get_meta` poll would — unknown
        namespace is an error, not a wait."""
        with self._cv:
            space = self._ns.get(ns)
            if space is None:
                raise errors.ArgError(f"pmix: unknown namespace {ns!r}")
            hit = space.kv.get(str(key))
            if hit is not None and hit[0] >= int(min_generation):
                spc.record("pmix_gets")
                return hit[1], hit[0]
            return None

    def fence_enter(self, ns: str, rank: int) -> "tuple | None":
        """Deferred-fence entry: register ``rank`` in the namespace's
        current fence epoch NOW (the rank counts from the moment its
        request arrived, exactly as the blocking verb's entry did).
        Returns None when this entry COMPLETES the fence, else an
        opaque token for :meth:`fence_done`."""
        with self._cv:
            space = self._require(ns)
            epoch = space.fence_epoch
            space.fence_entered.add(int(rank))
            if len(space.fence_entered) >= space.size:
                space.fence_epoch += 1
                space.fence_entered = set()
                self._cv.notify_all()
                spc.record("pmix_fences")
                return None
            return (space, epoch)

    def fence_done(self, ns: str, token: tuple) -> bool:
        """Poll a deferred fence: True once the entered epoch advanced.
        Raises when the namespace was destroyed mid-fence (same message
        the blocking verb raises)."""
        space, epoch = token
        with self._cv:
            if self._ns.get(ns) is not space:
                raise errors.InternalError(
                    f"pmix: namespace {ns!r} destroyed mid-fence"
                )
            if space.fence_epoch > epoch:
                spc.record("pmix_fences")
                return True
            return False

    def fence_status(self, ns: str) -> tuple[int, int]:
        """``(entered, size)`` of the namespace's current fence epoch —
        the deferred verb's timeout diagnostics."""
        with self._cv:
            space = self._ns.get(ns)
            if space is None:
                return (0, 0)
            return (len(space.fence_entered), space.size)

    def fence(self, ns: str, rank: int, timeout: float = 30.0) -> None:
        """Namespace-wide barrier: blocks until every rank of ``ns`` has
        entered this fence epoch.  Committed data published before the
        fence is gettable by everyone after it (PMIx_Fence w/ collect)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            space = self._require(ns)
            epoch = space.fence_epoch
            space.fence_entered.add(int(rank))
            if len(space.fence_entered) >= space.size:
                space.fence_epoch += 1
                space.fence_entered = set()
                self._cv.notify_all()
                spc.record("pmix_fences")
                return
            while True:
                live = self._ns.get(ns)
                if live is not space:
                    raise errors.InternalError(
                        f"pmix: namespace {ns!r} destroyed mid-fence"
                    )
                if space.fence_epoch > epoch:
                    spc.record("pmix_fences")
                    return
                left = deadline - time.monotonic()
                if left <= 0 or not self.open:
                    raise errors.InternalError(
                        f"pmix: fence on {ns!r} incomplete within "
                        f"{timeout}s ({len(space.fence_entered)}/"
                        f"{space.size} entered)"
                    )
                self._cv.wait(min(left, 0.25))

    def lookup(self, ns: str, prefix: str | None = None
               ) -> dict[str, Any]:
        """Non-blocking introspection over a namespace's PUBLISHED keys
        (optionally prefix-filtered) — the daemon's metrics aggregation
        and the hygiene gates read through this.  Unlike :meth:`get`
        it never waits and never counts in ``pmix_gets`` (it is a
        store-side view, not rank verb traffic); an unknown namespace
        is an empty dict, not an error."""
        with self._cv:
            space = self._ns.get(ns)
            if space is None:
                return {}
            return {
                key: value for key, (_gen, value) in space.kv.items()
                if prefix is None or key.startswith(prefix)
            }

    def bump_generation(self, ns: str) -> int:
        """Open a new generation window (the daemon bumps ONCE per
        respawn batch, so N replacements of one recovery window publish
        under the same tag)."""
        with self._cv:
            space = self._require(ns)
            space.generation += 1
            gen = space.generation
        if self.on_generation is not None:
            self.on_generation(ns, gen)
        return gen

    def generation(self, ns: str) -> int:
        with self._cv:
            return self._require(ns).generation

    def stat(self) -> dict:
        """Introspection snapshot (the zmpi-info / gate view)."""
        with self._cv:
            return {
                ns: {
                    "size": sp.size,
                    "generation": sp.generation,
                    "keys": len(sp.kv),
                    "staged_ranks": len(sp.staged),
                }
                for ns, sp in self._ns.items()
            }

    def close(self) -> None:
        """Unblock every parked get/fence (they error out) and drop the
        namespace state — the server owns calling this at teardown."""
        with self._cv:
            self.open = False
            self._ns.clear()
            self._cv.notify_all()


class PmixServer(FramedRpcServer):
    """The store behind a wire: a length-framed DSS request/response
    protocol on one listening socket, every connection multiplexed on
    the server's one channel engine.  Fast verbs dispatch inline on
    the engine thread; the blocking verbs (``get``-until-published,
    ``fence``) are DEFERRED — the request parks as a waiter record and
    ONE completer thread answers when the store condition fires, so a
    thousand parked ranks cost a thousand list entries, not a thousand
    threads.  A server fronting a :class:`~zhpe_ompi_tpu_torch.runtime.
    dvmtree.RoutedStore` (no probe surface — its get blocks on an
    upstream connection) detaches blocking verbs to per-connection
    threads instead, bounded by the daemon's LOCAL rank count.

    Request frame: ``dss.pack([op, *args])``; response frame:
    ``dss.pack(["ok", value])`` or ``dss.pack(["err", message])``.
    """

    #: the blocking store verbs a completer answers asynchronously
    _DEFERRED_OPS = frozenset({"get", "fence"})

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 store: PmixStore | None = None):
        self.store = store if store is not None else PmixStore()
        self._deferrable = bool(
            getattr(self.store, "supports_deferred_verbs", False))
        self._waiters: list[dict] = []
        self._completer: threading.Thread | None = None
        super().__init__(host, port, "pmix")
        if self._deferrable:
            self._completer = threading.Thread(
                target=self._complete_loop, daemon=True,
                name=f"pmix-completer-{self.address[1]}",
            )
            self._completer.start()
        _live_servers.add(self)

    def _handle_request(self, req: list, conn, conn_lock) -> Any:
        return self._dispatch(req)

    def _wants_stream(self, op) -> bool:
        # a RoutedStore's get/fence block on upstream forwards: those
        # connections go thread-backed (the pre-engine shape, bounded
        # by this daemon's local ranks, never by universe size)
        return (not self._deferrable and op in self._DEFERRED_OPS) \
            or super()._wants_stream(op)

    # -- deferred get/fence (the scale seam) ------------------------------

    def _defer_request(self, req: list, conn, conn_lock) -> bool:
        if not self._deferrable or req[0] not in self._DEFERRED_OPS:
            return False
        now = time.monotonic()
        if req[0] == "get":
            timeout = float(req[3])
            waiter = {"op": "get", "ns": req[1], "key": str(req[2]),
                      "min_gen": int(req[4]), "timeout": timeout,
                      "deadline": now + timeout,
                      "conn": conn, "lock": conn_lock}
        else:  # fence: ENTER now — the rank counts from request arrival
            timeout = float(req[3])
            try:
                token = self.store.fence_enter(req[1], int(req[2]))
            except errors.MpiError as e:
                self._deferred_reply(conn, conn_lock, ["err", str(e)])
                return True
            if token is None:  # this entry completed the fence
                self._deferred_reply(conn, conn_lock, ["ok", True])
                return True
            waiter = {"op": "fence", "ns": req[1], "token": token,
                      "timeout": timeout, "deadline": now + timeout,
                      "conn": conn, "lock": conn_lock}
        # probe once inline: the already-published get (the common
        # case) answers without waiting a completer tick
        reply = self._poll_waiter(waiter)
        if reply is not None:
            self._deferred_reply(conn, conn_lock, reply)
            return True
        with self.store._cv:
            self._waiters.append(waiter)
        return True

    def _poll_waiter(self, w: dict) -> "list | None":
        """One non-blocking look at a parked verb: the reply envelope
        once it can answer (success, store error, or deadline), else
        None — error MESSAGES match the blocking verbs byte-for-byte
        (clients diagnose by text)."""
        try:
            if w["op"] == "get":
                hit = self.store.try_get_meta(w["ns"], w["key"],
                                              w["min_gen"])
                if hit is not None:
                    return ["ok", [hit[0], hit[1]]]
            else:
                if self.store.fence_done(w["ns"], w["token"]):
                    return ["ok", True]
        except errors.MpiError as e:
            return ["err", str(e)]
        except Exception as e:  # noqa: BLE001 - a poisoned waiter must
            # error ITS reply, not kill the completer every verb rides
            return ["err", f"{type(e).__name__}: {e}"]
        if time.monotonic() >= w["deadline"] or not self.store.open:
            if w["op"] == "get":
                return ["err",
                        f"pmix: get({w['ns']!r}, {w['key']!r}) not "
                        f"published within {w['timeout']}s"]
            entered, size = self.store.fence_status(w["ns"])
            return ["err",
                    f"pmix: fence on {w['ns']!r} incomplete within "
                    f"{w['timeout']}s ({entered}/{size} entered)"]
        return None

    def _deferred_reply(self, conn, conn_lock, reply: list) -> None:
        from ..pt2pt.tcp import _send_frame
        from ..utils import dss

        try:
            with conn_lock:
                _send_frame(conn, dss.pack(reply))
        except OSError:
            pass  # client went away mid-wait: its own problem

    def _complete_loop(self) -> None:
        """ONE thread answers every parked get/fence: it sleeps on the
        store condition (publishes/fences/destroys notify it) and polls
        each waiter OUTSIDE the condition — the store verbs take it
        internally."""
        cv = self.store._cv
        while not self.closed:
            with cv:
                cv.wait(0.05)
                waiters = list(self._waiters)
            done = []
            for w in waiters:
                reply = self._poll_waiter(w)
                if reply is not None:
                    done.append((w, reply))
            if not done:
                continue
            with cv:
                for w, _reply in done:
                    if w in self._waiters:
                        self._waiters.remove(w)
            for w, reply in done:
                self._deferred_reply(w["conn"], w["lock"], reply)
        # shutdown: every still-parked waiter errors out (the store is
        # closed, so _poll_waiter answers the timeout/closed envelope)
        with cv:
            waiters, self._waiters = list(self._waiters), []
        for w in waiters:
            reply = self._poll_waiter(w)
            if reply is not None:
                self._deferred_reply(w["conn"], w["lock"], reply)

    def _dispatch(self, req: list) -> Any:
        op = req[0]
        s = self.store
        if op == "put":
            s.put(req[1], int(req[2]), req[3], req[4])
            return True
        if op == "commit":
            return s.commit(req[1], int(req[2]))
        if op == "get":
            value, gen = s.get_meta(req[1], req[2], float(req[3]),
                                    int(req[4]))
            return [value, gen]
        if op == "fence":
            s.fence(req[1], int(req[2]), float(req[3]))
            return True
        if op == "mkns":
            s.ensure_ns(req[1], int(req[2]))
            return True
        if op == "destroy":
            return s.destroy_ns(req[1])
        if op == "bumpgen":
            return s.bump_generation(req[1])
        if op == "generation":
            return s.generation(req[1])
        if op == "lookup":
            return s.lookup(req[1], req[2] if len(req) > 2 else None)
        if op == "stat":
            return s.stat()
        if op == "ping":
            return "pong"
        raise errors.ArgError(f"pmix: unknown verb {op!r}")

    def close(self) -> None:
        if self.closed:
            return
        # unblock parked get/fence waiters FIRST (they error out), then
        # run the shared listener/connection/engine shutdown ladder
        self.store.close()
        super().close()
        if self._completer is not None:
            self._completer.join(5.0)


class PmixClient:
    """Rank-side verbs over ONE persistent connection (the PMIx client
    handle).  Synchronous request/response; a lock serializes callers so
    the framing never interleaves."""

    def __init__(self, address: tuple[str, int] | str,
                 timeout: float = 30.0):
        self.address = parse_addr(address)
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        try:
            self._sock.connect(self.address)
        except OSError as e:
            self._sock.close()
            raise errors.InternalError(
                f"pmix: cannot reach server at {self.address}: {e}"
            ) from e

    def _call(self, req: list, wait: float | None = None) -> Any:
        from ..pt2pt.tcp import _recv_frame, _send_frame
        from ..utils import dss

        with self._lock:
            # a blocking verb (get/fence) parks server-side for up to its
            # own deadline: the socket must outwait it, not cut it short
            self._sock.settimeout((wait or 0.0) + self._timeout)
            try:
                _send_frame(self._sock, dss.pack(req))
                frame = _recv_frame(self._sock)
            except OSError as e:
                raise errors.InternalError(
                    f"pmix: server connection lost mid-{req[0]}: {e}"
                ) from e
        if frame is None:
            raise errors.InternalError(
                f"pmix: server closed the connection mid-{req[0]}"
            )
        [status, value] = dss.unpack(frame)[0]
        if status != "ok":
            raise errors.InternalError(f"pmix {req[0]}: {value}")
        return value

    # -- verbs ------------------------------------------------------------

    def ensure_ns(self, ns: str, size: int) -> None:
        self._call(["mkns", ns, int(size)])

    def destroy_ns(self, ns: str) -> bool:
        return bool(self._call(["destroy", ns]))

    def put(self, ns: str, rank: int, key: str, value: Any) -> None:
        self._call(["put", ns, int(rank), str(key), value])

    def commit(self, ns: str, rank: int) -> int:
        return int(self._call(["commit", ns, int(rank)]))

    def get(self, ns: str, key: str, timeout: float = 30.0,
            min_generation: int = 0) -> Any:
        value, _gen = self.get_meta(ns, key, timeout, min_generation)
        return value

    def get_meta(self, ns: str, key: str, timeout: float = 30.0,
                 min_generation: int = 0) -> tuple[Any, int]:
        out = self._call(["get", ns, str(key), float(timeout),
                          int(min_generation)], wait=timeout)
        return out[0], int(out[1])

    def fence(self, ns: str, rank: int, timeout: float = 30.0) -> None:
        self._call(["fence", ns, int(rank), float(timeout)], wait=timeout)

    def lookup(self, ns: str, prefix: str | None = None) -> dict:
        """Non-blocking prefix view over a namespace's published keys
        (:meth:`PmixStore.lookup` over the wire) — the ``tools/ztrace``
        collector reads ``trace:*`` buffers through this without
        blocking on ranks that never published."""
        return self._call(["lookup", ns, prefix])

    def bump_generation(self, ns: str) -> int:
        return int(self._call(["bumpgen", ns]))

    def generation(self, ns: str) -> int:
        return int(self._call(["generation", ns]))

    def stat(self) -> dict:
        return self._call(["stat"])

    def ping(self) -> bool:
        return self._call(["ping"]) == "pong"

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
