"""zprted — the persistent runtime daemon (PRRTE/DVM analog; namesake:
``zhpe_ompi_tpu/runtime/dvm.py``, the port's own copy).

In the reference, ``mpirun`` is a symlink to the external ``prte`` binary
(``ompi/tools/mpirun/Makefile.am:11-15``): a *resident* runtime hosts the
PMIx server, launches jobs into itself, watches its children, and owns
fault notification — none of which lives in the MPI tree.  This module is
that daemon IN tree, the elastic-launcher / coordinator-service layer the
fault-tolerance planes built toward:

- **resident PMIx store** (:mod:`.pmix`): one server outlives every job;
  ``zmpirun --dvm`` launches a job into the running VM and the ranks
  modex through the store — no per-job rendezvous coordinator, no name
  server, no launcher interpreter start-up.
- **authoritative fault events**: the daemon ``waitpid``-watches every
  child (one *blocking* ``wait()`` thread per proc — no polling in the
  hot path) and, the moment a rank of an ft job dies, floods an
  ``FT_DVM_CID`` control frame to every survivor.  That is OS truth —
  the corpse's exit status — feeding the same
  :class:`~zhpe_ompi_tpu_torch.ft.ulfm.FailureState` as the ring heartbeats,
  marking the rank failed (``cause="daemon"``) before a single detector
  timeout expires.
- **relaunch RPC**: :func:`~zhpe_ompi_tpu_torch.ft.recovery.daemon_respawn`
  asks the daemon to exec a fresh OS process into a dead rank's slot;
  the replacement FT_JOINs the name-served job (``TcpProc(rejoin=True)``
  fetches the book from the store), closing the recovery pipeline over
  real processes end to end.  One respawn RPC may carry N victims — the
  namespace generation is bumped ONCE, so the whole batch joins the
  same recovery window.

Wire protocol (control port; length-framed DSS, request/response with
streaming for ``launch``): requests are ``["launch", spec]``,
``["respawn", job, ranks]``, ``["pids", job]``, ``["stat"]``,
``["metrics", job[, rank]]``, ``["ping"]``, ``["stop"]``.  A launch
streams ``["job", id]``, then ``["io", rank, label, line]`` /
``["note", text]`` frames, and finally ``["exit", rc]``.

The daemon is also the metrics plane's aggregation point: ranks
launched with ``metrics=True`` (``ZMPI_METRICS=1``) publish
generation-tagged ``metrics:<job>:<rank>`` snapshots into the resident
store, the ``metrics`` RPC serves per-rank / per-job / job-aggregated
views with staleness stamps, and — off by default, ``--metrics-port``
to enable — an HTTP ``GET /metrics`` listener emits the whole store's
counter plane as Prometheus text exposition
(``zmpi_spc_<name>{job="...",rank="..."} value``), so the han/sm/wire/
FT counters the benches gate on are scrapeable from a live fleet.

Job semantics mirror ``zmpirun``: non-ft jobs keep MPI_Abort teardown
(first nonzero exit kills the rest); ft jobs keep running — death is an
event for the survivors' recovery pipeline, not a job teardown.

Hygiene is observable: every in-process daemon registers weakly
(:func:`live_dvms` must be empty once tests stop theirs), daemon
*processes* are found by cmdline scan (:func:`orphaned_daemon_processes`),
and a stopping daemon destroys its jobs' namespaces and sweeps their
``/dev/shm`` artifacts exactly as the ``zmpirun`` session sweep does.

CLI (the ``zprted`` entrypoint)::

    python -m zhpe_ompi_tpu_torch.runtime.dvm [--host H] [--port P] [--pmix-port Q]

prints ``zprted ready dvm=H:P pmix=H:Q`` once both listeners are up, and
runs until SIGTERM/SIGINT or a ``stop`` RPC.
"""

from __future__ import annotations

import argparse
import itertools
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import weakref
from typing import Any

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from . import dvmtree
from . import flightrec
from . import pmix as pmix_mod
from . import spc
from . import ztrace

_stream = mca_output.open_stream("dvm")

mca_var.register(
    "dvm_job_timeout", 600.0,
    "Default wall-clock deadline (seconds) for a daemon-hosted job "
    "that did not pass its own timeout: a wedged rank set may not park "
    "a zprted launch handler forever",
    type=float,
)

mca_var.register(
    "dvm_admission_policy", "fifo",
    "Launch-admission ordering on a daemon: 'fifo' admits in arrival "
    "order, 'priority' by descending launch priority= (ties by "
    "arrival) — re-evaluated each time a slot frees, so a late "
    "high-priority arrival preempts the QUEUE order (never a running "
    "job)",
)

mca_var.register(
    "dvm_max_concurrent_jobs", 0,
    "Concurrently RUNNING jobs a daemon admits; excess launches BLOCK "
    "as tickets in the admission queue (the client streams [queued, "
    "position] frames while it waits) until a running job completes; "
    "<= 0 is unbounded (the single-tenant default)",
    type=int,
)

_TERM_GRACE = 2.0  # seconds between SIGTERM and SIGKILL on teardown

# IOF-drain deadline at job exit: once every child is dead its pipes
# are at EOF, so a drain finishes after finitely many reads — but a
# drain thread STARVED by scheduler load past a short per-thread join
# loses the rank's final lines to a client that stopped reading at the
# exit frame (the TestDvmMultiVictimRecovery finalize-skew flake: the
# last SURVIVOR-OK line raced the exit frame under full-suite load).
# One generous SHARED deadline covers starvation; only a leaked
# grandchild holding a dead child's pipe open can exhaust it, and that
# pathology is reported loudly instead of surfacing as truncation.
_IOF_DRAIN_GRACE = 30.0

_live_dvms: weakref.WeakSet = weakref.WeakSet()


def live_dvms() -> list[str]:
    """In-process daemons still listening — must be [] once tests stop
    theirs (a leaked daemon holds two ports and a PMIx store)."""
    return [
        f"dvm:{d.address[0]}:{d.address[1]}"
        for d in list(_live_dvms)
        if not d.stopped
    ]


def orphaned_daemon_processes() -> list[str]:
    """The port's zprted processes still alive on this host (cmdline
    scan of ``python -m zhpe_ompi_tpu_torch.runtime.dvm``): no daemon
    subprocess may outlive the test that spawned it.  Other test
    processes' daemons are host-wide too, so a caller running beside
    them checks the pids it started."""
    out = []
    try:
        pids = [p for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return out  # no /proc: nothing to scan
    for pid in pids:
        if int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                args = [a.decode("utf-8", "replace")
                        for a in f.read().split(b"\0") if a]
        except OSError:
            continue  # raced an exit
        # match ACTUAL port daemon invocations only ("python -m
        # zhpe_ompi_tpu_torch.runtime.dvm ...") — a substring match would
        # flag any shell/pytest line that merely MENTIONS the module, and
        # the JAX package's daemons (its own module path) are its scan's
        if any(a == "zhpe_ompi_tpu_torch.runtime.dvm" for a in args):
            out.append(f"pid {pid}: {' '.join(args)}")
    return out


_live_metrics_http: weakref.WeakSet = weakref.WeakSet()


def live_metrics_listeners() -> list[str]:
    """Metrics HTTP listeners still bound — must be [] once every
    daemon's stop() ran (the scrape endpoint dies with its daemon)."""
    return [
        f"metrics-http:{h.address[0]}:{h.address[1]}"
        for h in list(_live_metrics_http)
        if not h.closed
    ]


class MetricsHttpListener:
    """Minimal HTTP/1.0 server for ``GET /metrics``: one accept loop,
    one short-lived thread per request, Prometheus text exposition
    rendered by the owning daemon.  Deliberately tiny — no keep-alive,
    no routing beyond /metrics, request read bounded — because its
    whole contract is "a scraper can poll this port"."""

    def __init__(self, dvm: "Dvm", host: str, port: int):
        self._dvm = dvm
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._srv.bind((host, port))
        except OSError:
            self._srv.close()
            raise
        self._srv.listen(8)
        self.address: tuple[str, int] = self._srv.getsockname()
        self.closed = False
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._acceptor = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"dvm-metrics-http-{self.address[1]}",
        )
        self._acceptor.start()
        _live_metrics_http.add(self)

    def _accept_loop(self) -> None:
        while not self.closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self._threads = [t for t in self._threads if t.is_alive()]
                t = threading.Thread(
                    target=self._serve, args=(conn,), daemon=True,
                    name=f"dvm-metrics-req-{self.address[1]}",
                )
                self._threads.append(t)
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(5.0)
            data = b""
            while b"\r\n\r\n" not in data and len(data) < 8192:
                chunk = conn.recv(1024)
                if not chunk:
                    return
                data += chunk
            line = data.split(b"\r\n", 1)[0].decode("ascii", "replace")
            parts = line.split()
            path = parts[1] if len(parts) >= 2 else ""
            if parts and parts[0] == "GET" \
                    and path.split("?", 1)[0] == "/metrics":
                body = self._dvm.prometheus().encode("utf-8")
                head = (
                    "HTTP/1.0 200 OK\r\n"
                    "Content-Type: text/plain; version=0.0.4; "
                    "charset=utf-8\r\n"
                    f"Content-Length: {len(body)}\r\n\r\n"
                )
            else:
                body = b"not found\n"
                head = ("HTTP/1.0 404 Not Found\r\n"
                        "Content-Type: text/plain\r\n"
                        f"Content-Length: {len(body)}\r\n\r\n")
            conn.sendall(head.encode("ascii") + body)
        except OSError:
            return  # scraper went away mid-request: its own problem
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
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
        deadline = time.monotonic() + 5.0
        self._acceptor.join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))


def _pkg_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    ))


def _sweep_shm(session: str) -> None:
    """Session-directory cleanup for one session tag (the zmpirun sweep,
    shared prefix scheme): killed ranks never unlink their rings."""
    try:
        for f in os.listdir("/dev/shm"):
            if f.startswith((f"zompi_ring_{session}_",
                             f"zompi_shm_{session}_",
                             f"zompi_pyring_{session}_")):
                try:
                    os.unlink(os.path.join("/dev/shm", f))
                except OSError:
                    pass
    except OSError:
        pass


def _tree_query(addr: tuple[str, int]) -> dict:
    """One ``treeinfo`` RPC against a daemon (the attach-time
    discovery: parent store address + depth)."""
    cli = DvmClient(addr, timeout=30.0)
    try:
        return cli.treeinfo()
    finally:
        cli.close()


_live_admission: weakref.WeakSet = weakref.WeakSet()


def queued_admission_tickets() -> list[str]:
    """Tickets still parked in any daemon's admission queue — must be
    [] at session end: a leaked ticket means a
    launch handler died without cancel/release and the queue head is
    wedged forever."""
    out: list[str] = []
    for q in list(_live_admission):
        out += q.queued()
    return out


class _AdmissionTicket:
    """One launch's place in the admission queue: enqueue order,
    priority, and admission state."""

    def __init__(self, seq: int, priority: int):
        self.seq = seq
        self.priority = int(priority)
        self.t0 = time.monotonic()
        self.admitted = False
        self.was_queued = False


class _AdmissionQueue:
    """Explicit launch admission — the bare serializing lock's convoy
    made a POLICY.  An ordered ticket queue (fifo by arrival, or
    priority-then-arrival, per ``dvm_admission_policy``) bounded by
    ``dvm_max_concurrent_jobs``: excess launches BLOCK as tickets here
    (their clients stream ``[queued, position]`` frames) instead of
    convoying blindly on a mutex.  :meth:`setup` is the short job-setup
    critical section (id / namespace / placement / spawn loop — one
    job at a time, exactly the old lock's scope); an ADMITTED ticket
    additionally holds a concurrency slot until :meth:`release` at job
    end.  The respawn/resize RPCs take ``setup()`` directly — they
    ride their job's admission (that job is already running) so they
    can never queue behind a blocked launch, and a queued launch holds
    NO lock at all, so it cannot interleave a resizing job's
    membership."""

    def __init__(self):
        self._cv = threading.Condition()
        self._setup = threading.Lock()
        self._waiting: list[_AdmissionTicket] = []
        self._running = 0
        self._seq = itertools.count()
        self._closed = False
        _live_admission.add(self)

    def setup(self) -> threading.Lock:
        """The job-setup serialization lock (a context manager)."""
        return self._setup

    def enqueue(self, priority: int = 0) -> _AdmissionTicket:
        with self._cv:
            t = _AdmissionTicket(next(self._seq), priority)
            self._waiting.append(t)
            return t

    def _order(self) -> list[_AdmissionTicket]:
        # policy read PER evaluation: flipping the MCA var reorders the
        # live queue, it never needs a daemon restart
        if str(mca_var.get("dvm_admission_policy", "fifo")) \
                == "priority":
            return sorted(self._waiting,
                          key=lambda t: (-t.priority, t.seq))
        return sorted(self._waiting, key=lambda t: t.seq)

    def _admissible(self, ticket: _AdmissionTicket) -> bool:
        cap = int(mca_var.get("dvm_max_concurrent_jobs", 0))
        order = self._order()
        return bool(order) and order[0] is ticket \
            and (cap <= 0 or self._running < cap)

    def _position(self, ticket: _AdmissionTicket) -> int:
        for i, t in enumerate(self._order()):
            if t is ticket:
                return i + 1
        return 0

    def admit(self, ticket: _AdmissionTicket, alive=None,
              on_position=None) -> float | None:
        """Block until ``ticket`` is admitted.  Returns the seconds it
        waited, or None when ``alive()`` reported the client dead (the
        ticket is cancelled — a dead client's queued job is reaped,
        never left to wedge the queue head).  ``on_position(pos)``
        fires outside the queue lock whenever the queued position
        changes.  Raises InternalError when the queue closes under a
        waiter (daemon stop)."""
        notified = None
        while True:
            with self._cv:
                if self._closed:
                    self._discard(ticket)
                    raise errors.InternalError(
                        "zprted: daemon stopping — launch not admitted")
                if self._admissible(ticket):
                    self._waiting.remove(ticket)
                    ticket.admitted = True
                    self._running += 1
                    self._cv.notify_all()
                    return time.monotonic() - ticket.t0
                ticket.was_queued = True
                pos = self._position(ticket)
            # callbacks OUTSIDE the lock: a blocking client socket must
            # never wedge every other launch's admission
            if alive is not None and not alive():
                self.cancel(ticket)
                return None
            if on_position is not None and pos != notified:
                notified = pos
                on_position(pos)
            with self._cv:
                if not self._closed and not self._admissible(ticket) \
                        and self._position(ticket) == notified:
                    self._cv.wait(0.25)

    def cancel(self, ticket: _AdmissionTicket) -> None:
        with self._cv:
            self._discard(ticket)
            self._cv.notify_all()

    def _discard(self, ticket: _AdmissionTicket) -> None:
        if ticket in self._waiting:
            self._waiting.remove(ticket)

    def release(self, ticket: _AdmissionTicket) -> None:
        """Job over (or launch failed): free the concurrency slot and
        wake the queue.  Idempotent, and reaps a never-admitted ticket
        too — the one release in the launch handler's ``finally``
        covers every exit path."""
        with self._cv:
            if ticket.admitted:
                ticket.admitted = False
                self._running -= 1
            else:
                self._discard(ticket)
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def stat_view(self) -> dict:
        with self._cv:
            return {
                "policy": str(mca_var.get("dvm_admission_policy",
                                          "fifo")),
                "cap": int(mca_var.get("dvm_max_concurrent_jobs", 0)),
                "running": self._running,
                "waiting": len(self._waiting),
            }

    def queued(self) -> list[str]:
        with self._cv:
            return [f"admission-ticket:seq={t.seq}:prio={t.priority}"
                    for t in self._waiting]


class _Job:
    """One launched job: its procs (latest incarnation per rank), exit
    bookkeeping, and the IOF client connection.  On a TREE the root
    holds the authoritative copy — ``procs`` are its LOCAL ranks only,
    remote ranks live in ``remote_alive``/``remote_pids`` fed by
    ``exited``/``spawned`` frames riding up the links, and
    ``placement`` maps every rank to the daemon hosting it.  A child
    daemon holds a thin mirror (``conn=None``): local procs plus the
    spawn metadata its ``_rank_env`` needs."""

    def __init__(self, job_id: str, size: int, cmds: list[list[str]],
                 ft: bool, mca: list, session: str, conn, conn_lock,
                 metrics: bool = False, trace: bool = False):
        self.id = job_id
        self.size = size
        self.cmds = cmds
        self.ft = ft
        self.mca = mca
        self.metrics = metrics
        self.trace = trace
        self.session = session
        self.conn = conn              # IOF/exit stream target
        self.conn_lock = conn_lock
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.procs: dict[int, subprocess.Popen] = {}
        self.rcs: dict[int, int] = {}
        self.superseded: dict[int, list[subprocess.Popen]] = {}
        self.live = 0
        self.fail_rc: int | None = None
        self.stopping = False
        self.io_broken = False
        self.done = threading.Event()
        self.drains: list[threading.Thread] = []
        self.watchers: list[threading.Thread] = []
        # tree bookkeeping (root side)
        self.placement: dict[int, str] = {}
        # tenancy: this job got (and keeps) an exclusive daemon subtree
        self.exclusive = False
        self.remote_alive: set[int] = set()
        self.remote_pids: dict[int, int] = {}
        # elastic bookkeeping: the CURRENT live membership target
        # (size is the launch-time max), and the resize event sequence
        self.elastic = False
        self.target: set[int] = set(range(size))
        self.resize_seq = 0

    def alive_ranks(self) -> list[int]:
        """LOCAL ranks with a live OS process on THIS daemon."""
        with self.lock:
            return sorted(r for r, p in self.procs.items()
                          if p.poll() is None)

    def live_count(self) -> int:
        with self.lock:
            return self.live

    def stat_view(self) -> dict:
        """Point-in-time job summary — under ``lock``, so a stat RPC
        never iterates ``target`` while a resize mutates it."""
        with self.lock:
            return {"size": self.size, "ft": self.ft,
                    "live": self.live, "elastic": self.elastic,
                    "target": sorted(self.target),
                    "placement": [[int(r), d] for r, d in
                                  sorted(self.placement.items())],
                    "done": self.done.is_set()}

    def retired(self, rank: int) -> bool:
        """A slot the daemon itself retired (elastic shrink): its exit
        — even a SIGTERM from the escalation ladder — is a requested
        departure, not a job failure.  Call under ``lock``."""
        return self.elastic and rank not in self.target


class Dvm(pmix_mod.FramedRpcServer):
    """The resident daemon: PMIx store + control RPC + child watching.
    Constructible in-process (tests, benchmarks) or via the ``zprted``
    CLI as its own OS process.  The control port rides the shared
    framed-RPC scaffold (:class:`~zhpe_ompi_tpu_torch.runtime.pmix.
    FramedRpcServer`): fast control verbs dispatch inline on the
    channel engine; the connection-owning shapes (``launch`` streams
    ``[job]``/``[io]``/``[note]``/``[exit]`` frames, ``attach`` serves
    a child daemon's tree link for its life, ``lifeline`` parks until
    daemon death) plus the slow membership RPCs (``respawn``/
    ``resize`` hold spawn-confirmation windows) detach to dedicated
    threads — bounded by tree fan-out and op kind, never by universe
    size."""

    _STREAMED_OPS = frozenset(
        {"launch", "attach", "lifeline", "respawn", "resize"})

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 pmix_port: int = 0, session_tag: str | None = None,
                 metrics_port: int | None = None,
                 parent: "tuple[str, int] | str | None" = None):
        self.host = host
        self._parent_addr = pmix_mod.parse_addr(parent) \
            if parent is not None else None
        self._parent_link: dvmtree.TreeLink | None = None
        self._children: dict[str, dvmtree.ChildLink] = {}
        self._tree_lock = threading.Lock()
        self.tree_depth = 0
        if self._parent_addr is None:
            # ROOT (or single-daemon) mode: the authoritative store,
            # with its generation/destroy mutations broadcast down the
            # tree as cache invalidations whichever surface they
            # arrived through (wire verb, respawn RPC, resize)
            self.store = pmix_mod.PmixStore()
            self.store.on_generation = self._on_store_generation
            self.store.on_destroy = self._on_store_destroy
        else:
            # CHILD mode: learn the parent's store address, then serve
            # OUR ranks from the routed (leaf-cached) verb surface — a
            # rank only ever talks to ITS host's daemon
            meta = _tree_query(self._parent_addr)
            self.tree_depth = int(meta.get("depth", 0)) + 1
            self.store = dvmtree.RoutedStore(tuple(meta["pmix"]))
        self.pmix = pmix_mod.PmixServer(host, pmix_port, store=self.store)
        self.metrics_http: MetricsHttpListener | None = None
        try:
            super().__init__(host, port, "dvm", backlog=16)
        except OSError:
            self.pmix.close()
            raise
        if metrics_port is not None:
            # scrape endpoint OFF by default: binding a port is an
            # explicit operator decision (--metrics-port)
            try:
                self.metrics_http = MetricsHttpListener(
                    self, host, int(metrics_port))
            except OSError:
                self.pmix.close()
                super().close()
                raise
        self.session = session_tag or f"d{self.address[1]}"
        self.id = f"{host}:{self.address[1]}"
        self._stop_evt = threading.Event()
        self._jobs: dict[str, _Job] = {}
        self._job_ids = itertools.count(1)
        self._lock = threading.Lock()
        # launch-RPC admission is an explicit QUEUE: job setup — id
        # allocation, namespace creation, placement, and the spawn
        # loop — still happens one job at a time (setup()), but
        # admission ORDER is policy (dvm_admission_policy) and
        # admission COUNT is bounded (dvm_max_concurrent_jobs), with
        # excess launches parked as tickets streaming [queued, pos]
        # frames (the wait for a job's exit never holds anything;
        # admitted jobs still RUN concurrently)
        self._admission = _AdmissionQueue()
        # ordered daemon membership for placement: this daemon first,
        # children (and their subtrees) in attach order (root only)
        self._placement_ids: list[str] = [self.id]
        self._stopping_tree = False
        if self._parent_addr is not None:
            info = {"id": self.id, "control": list(self.address),
                    "pmix": list(self.pmix.address)}
            try:
                self._parent_link = dvmtree.TreeLink(
                    self._parent_addr, info,
                    on_down=self._handle_down,
                    on_lost=self._parent_lost)
                self._parent_link.start()
            except BaseException:
                self.pmix.close()
                super().close()
                raise
        _live_dvms.add(self)
        mca_output.verbose(
            1, _stream, "zprted up: dvm=%s:%d pmix=%s:%d session=%s "
            "depth=%d", host, self.address[1], host,
            self.pmix.address[1], self.session, self.tree_depth,
        )

    # -- wire ------------------------------------------------------------

    @property
    def stopped(self) -> bool:
        return self.closed

    def _wants_stream(self, op) -> bool:
        # a CHILD daemon relays job-level RPCs to the root over a
        # blocking upstream call — that wait belongs on a detached
        # thread, never on the engine every other client rides
        if self._parent_link is not None and op in (
                "stat", "pids", "metrics"):
            return True
        return super()._wants_stream(op)

    def _handle_request(self, req: list, conn, conn_lock) -> Any:
        if req[0] == "launch":
            self._handle_launch(req[1], conn, conn_lock)
            return self.STREAMED
        if req[0] == "attach":
            return self._handle_attach(req[1], conn, conn_lock)
        if req[0] == "lifeline":
            # a daemon-hosted rank parks one connection here for its
            # whole life: daemon death closes it, and the rank's
            # lifeline thread exits the process — a dead daemon's
            # subtree takes its ranks with it (the PRRTE contract)
            from ..pt2pt.tcp import _recv_frame

            try:
                while not self.closed:
                    if _recv_frame(conn) is None:
                        break
            except OSError:
                pass
            return self.STREAMED
        return self._dispatch(req)

    def _after_reply(self, req: list) -> bool:
        if req[0] == "stop":
            self.stop()
            return False
        return True

    def _dispatch(self, req: list) -> Any:
        op = req[0]
        if op == "ping":
            return "pong"
        if op == "treeinfo":
            with self._tree_lock:
                daemons = list(self._placement_ids)
            return {
                "id": self.id,
                "pmix": list(self.pmix.address),
                "depth": self.tree_depth,
                "root": self._parent_link is None,
                "daemons": daemons,
            }
        if op == "stop":
            return True
        if self._parent_link is not None and op in (
                "stat", "pids", "metrics", "respawn", "resize"):
            # a CHILD daemon relays job-level RPCs toward the root (a
            # rank only ever talks to ITS host's daemon — its
            # ZMPI_DVM respawn/resize calls land here and climb)
            return self._relay_up(req)
        if op == "stat":
            with self._lock:
                jobs = {j.id: j.stat_view()
                        for j in self._jobs.values()}
            with self._tree_lock:
                daemons = list(self._placement_ids)
            counters = spc.snapshot()
            return {
                "jobs": jobs,
                "pmix": self.store.stat(),
                "daemons": daemons,
                "admission": self._admission.stat_view(),
                "dvm_jobs_launched": counters.get("dvm_jobs_launched", 0),
                "dvm_fault_events": counters.get("dvm_fault_events", 0),
                "dvm_respawns": counters.get("dvm_respawns", 0),
                "dvm_resizes": counters.get("dvm_resizes", 0),
                "dvm_tree_forwards": counters.get("dvm_tree_forwards", 0),
                "dvm_store_cache_hits":
                    counters.get("dvm_store_cache_hits", 0),
                # scale-out-fabric gates: a REAL-process tree's scaling
                # tests can only see the root daemon's counters through
                # this RPC (each zprted has its own spc registry)
                "pmix_gets": counters.get("pmix_gets", 0),
                "dvm_tree_routed_launches":
                    counters.get("dvm_tree_routed_launches", 0),
                "store_leaf_cache_hits":
                    counters.get("store_leaf_cache_hits", 0),
                "store_leaf_cache_misses":
                    counters.get("store_leaf_cache_misses", 0),
            }
        if op == "pids":
            job = self._job(req[1])
            with job.lock:
                pids = dict(job.remote_pids)
                pids.update({int(r): p.pid
                             for r, p in job.procs.items()})
            return pids
        if op == "metrics":
            return self._metrics_view(
                str(req[1]), None if len(req) < 3 or req[2] is None
                else int(req[2]))
        if op == "respawn":
            return self._handle_respawn(req[1], [int(r) for r in req[2]])
        if op == "resize":
            return self._handle_resize(str(req[1]), int(req[2]))
        raise errors.ArgError(f"zprted: unknown request {op!r}")

    def _relay_up(self, req: list) -> Any:
        # the wait must outlast the ROOT's own worst case — a shrink
        # holds its full retire grace, a grow/respawn its remote spawn
        # confirmation window — or the relay would time out an RPC the
        # root goes on to apply (and a retry would double-apply)
        cli = DvmClient(self._parent_addr, timeout=60.0)
        try:
            return cli._call(req, wait=120.0)
        finally:
            cli.close()

    def _job(self, job_id: str) -> _Job:
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise errors.ArgError(f"zprted: unknown job {job_id!r}")
        return job

    # -- tree links (parent/child daemon plumbing) ------------------------

    def _handle_attach(self, info: dict, conn, conn_lock) -> Any:
        """A child daemon's persistent tree link: register it, reply
        with our store coordinates, then SERVE the link on this
        handler thread — upward frames dispatch until EOF, and EOF
        without a prior orderly detach IS the child's death."""
        from ..pt2pt.tcp import _recv_frame, _send_frame
        from ..utils import dss

        child = dvmtree.ChildLink(info, conn, conn_lock)
        # registration and the handshake reply are ONE atomic step
        # under the link's send lock: registered-before-reply means a
        # launch racing the attach either misses the child entirely or
        # sees it fully placeable, and holding conn_lock across both
        # means no broadcast can slip a down-frame onto the wire AHEAD
        # of the ["ok", ...] the child's constructor is parked on
        reply = ["ok", {"pmix": list(self.pmix.address),
                        "depth": self.tree_depth, "id": self.id}]
        with conn_lock:
            with self._tree_lock:
                self._children[child.id] = child
            self._daemon_up([child.id], via_child=None)
            _send_frame(conn, dss.pack(reply))
        mca_output.verbose(
            1, _stream, "tree: child daemon %s attached (depth %d)",
            child.id, self.tree_depth + 1,
        )
        try:
            while not self.closed:
                frame = _recv_frame(conn)
                if frame is None:
                    break
                [msg] = dss.unpack(frame)
                if msg[0] != "up":
                    continue  # foreign frame shape on a tree link
                self._handle_up(child, str(msg[1]), msg[2])
        except OSError:
            pass
        finally:
            with self._tree_lock:
                self._children.pop(child.id, None)
            if not child.detached and not self.closed:
                self._child_lost(child)
        return self.STREAMED

    def _daemon_up(self, ids: list[str], via_child) -> None:
        """New daemon(s) joined the subtree: remember which link leads
        to them, then report up — the ROOT appends them to the
        placement order."""
        ids = [str(i) for i in ids]
        if via_child is not None:
            via_child.daemons.update(ids)
        if self._parent_link is not None:
            try:
                self._parent_link.send_up("daemon-up", ids)
            except OSError:
                pass  # parent gone: _parent_lost owns the teardown
            return
        with self._tree_lock:
            for i in ids:
                if i not in self._placement_ids:
                    self._placement_ids.append(i)

    def _daemons_detached(self, ids: list[str], via_child) -> None:
        """Orderly daemon retirement (the detach contract — no ranks
        re-classified): prune the subtree from the delivering link's
        membership and relay toward the root, which drops it from the
        placement order so no later launch targets a stopped daemon."""
        ids = [str(i) for i in ids]
        if via_child is not None:
            via_child.daemons.difference_update(ids)
        if self._parent_link is not None:
            try:
                self._parent_link.send_up("daemon-detached", ids)
            except OSError:
                pass  # parent gone: _parent_lost owns the teardown
            return
        with self._tree_lock:
            self._placement_ids = [d for d in self._placement_ids
                                   if d not in ids]

    def _handle_up(self, child, kind: str, payload: Any) -> None:
        """One upward frame from a child link.  An intermediate daemon
        relays job traffic toward the root; the root applies it."""
        if kind == "daemon-up":
            self._daemon_up(list(payload), via_child=child)
            return
        if kind == "detach":
            # orderly child shutdown: EOF that follows is not a death —
            # and the ROOT must unlearn the subtree (relayed as
            # daemon-detached so intermediate hops prune too; a stale
            # placement entry would strand the next launch's spawns)
            child.detached = True
            self._daemons_detached(sorted(child.daemons),
                                   via_child=None)
            return
        if kind == "daemon-detached":
            self._daemons_detached([str(d) for d in payload],
                                   via_child=child)
            return
        if kind == "daemon-down":
            if self._parent_link is not None:
                try:
                    self._parent_link.send_up(kind, payload)
                except OSError:
                    pass
                return
            self._daemons_lost([str(d) for d in payload])
            return
        if self._parent_link is not None:
            # io / exited / spawned climb to the root unchanged
            try:
                self._parent_link.send_up(kind, payload)
            except OSError:
                pass
            return
        if kind == "io":
            job = self._jobs.get(str(payload[0]))
            if job is not None:
                self._stream(job, ["io", int(payload[1]),
                                   str(payload[2]), payload[3]])
        elif kind == "exited":
            job = self._jobs.get(str(payload[0]))
            if job is not None:
                self._remote_exited(job, int(payload[1]),
                                    int(payload[2]))
        elif kind == "spawned":
            job = self._jobs.get(str(payload[0]))
            if job is not None:
                self._remote_spawned(job, {int(r): int(p)
                                           for r, p in
                                           payload[1].items()})
        else:
            mca_output.emit(
                _stream, "tree: unknown upward frame %r from %s — "
                "dropped", kind, child.id,
            )

    def _handle_down(self, kind: str, payload: Any) -> None:
        """One downward frame from the parent link (child side).
        Broadcast kinds re-broadcast to our own children FIRST (a
        kill that parks in its TERM grace locally must not delay the
        grandchild subtree by a whole level), then apply locally;
        routed kinds unwrap toward their target daemon."""
        if kind in ("gen", "nsdown", "fault", "kill", "kill-ranks",
                    "jobdone"):
            self._broadcast_down(kind, payload)
        if kind == "route":
            target, inner_kind, inner = str(payload[0]), \
                str(payload[1]), payload[2]
            if target == self.id:
                self._handle_down(inner_kind, inner)
                return
            link = self._link_for(target)
            if link is None:
                mca_output.emit(
                    _stream, "tree: no route to daemon %s for %r — "
                    "frame dropped", target, inner_kind,
                )
                return
            try:
                link.send_down("route", payload)
            except OSError:
                pass  # link death handled by its serving thread
            return
        if kind == "spawn":
            self._spawn_remote(payload)
        elif kind == "gen":
            if isinstance(self.store, dvmtree.RoutedStore):
                # the frame CARRIES the new generation: it raises the
                # leaf bucket's floor, so a fetch in flight across this
                # invalidation can never re-warm the cache with the
                # pre-bump incarnation's value
                gen = int(payload[1]) if len(payload) > 1 else None
                self.store.invalidate_ns(str(payload[0]), gen=gen)
        elif kind == "nsdown":
            if isinstance(self.store, dvmtree.RoutedStore):
                self.store.forget_ns(str(payload[0]))
        elif kind == "fault":
            job = self._jobs.get(str(payload[0]))
            if job is not None:
                self._notify_local_ranks(
                    job, [(int(r), int(rc)) for r, rc in payload[1]],
                    str(payload[2]))
        elif kind == "kill":
            job = self._jobs.get(str(payload[0]))
            if job is not None:
                self._teardown_job(job, rc=int(payload[1]))
        elif kind == "kill-ranks":
            self._kill_local_ranks(str(payload[0]),
                                   [int(r) for r in payload[1]])
        elif kind == "jobdone":
            job_id = str(payload[0])
            with self._lock:
                job = self._jobs.pop(job_id, None)
            if job is not None:
                _sweep_shm(job.session)
            if isinstance(self.store, dvmtree.RoutedStore):
                self.store.forget_ns(job_id)
        else:
            mca_output.emit(
                _stream, "tree: unknown downward frame %r — dropped",
                kind,
            )

    def _link_for(self, daemon_id: str):
        with self._tree_lock:
            for link in self._children.values():
                if daemon_id in link.daemons:
                    return link
        return None

    def _broadcast_down(self, kind: str, payload: Any) -> None:
        with self._tree_lock:
            links = list(self._children.values())
        for link in links:
            try:
                link.send_down(kind, payload)
            except OSError:
                pass  # link death handled by its serving thread

    def _send_tree(self, daemon_id: str, kind: str, payload: Any
                   ) -> None:
        """Targeted downward frame: handle locally or route through
        the child link whose subtree holds ``daemon_id``."""
        if daemon_id == self.id:
            self._handle_down(kind, payload)
            return
        link = self._link_for(daemon_id)
        if link is None:
            raise errors.InternalError(
                f"zprted tree: no route to daemon {daemon_id}")
        link.send_down("route", [daemon_id, kind, payload])

    def _child_lost(self, child) -> None:
        """A child link died without an orderly detach: every daemon in
        that subtree is gone, and with it every rank the subtree
        hosted.  The report climbs to the root, which classifies and
        floods."""
        subtree = sorted(child.daemons)
        mca_output.emit(
            _stream, "tree: child daemon %s LOST (subtree %s)",
            child.id, subtree,
        )
        if self._parent_link is not None:
            try:
                self._parent_link.send_up("daemon-down", subtree)
            except OSError:
                pass
            return
        self._daemons_lost(subtree)

    def _daemons_lost(self, ids: list[str]) -> None:
        """ROOT policy for a dead daemon subtree: drop it from
        placement, mark every rank it hosted failed
        (cause="daemon-tree"), flood the classification down the
        SURVIVING tree, and keep the exit accounting coherent — those
        ranks will never report ``exited``."""
        ids = set(ids)
        with self._tree_lock:
            self._placement_ids = [d for d in self._placement_ids
                                   if d not in ids]
        with self._lock:
            jobs = list(self._jobs.values())
        for job in jobs:
            with job.lock:
                victims = sorted(
                    r for r, d in job.placement.items()
                    if d in ids and r in job.remote_alive
                )
                for r in victims:
                    job.remote_alive.discard(r)
                    job.rcs[r] = -9
                    job.live -= 1
                    job.remote_pids.pop(r, None)
                last = job.live == 0
                stopping = job.stopping
                if victims and not stopping and job.fail_rc is None:
                    job.fail_rc = 137  # 128 + SIGKILL: the subtree died
            if not victims:
                continue
            if job.ft and not stopping:
                # _fault records the DAEMON_FAULT flightrec event
                self._fault(job, [(r, -9) for r in victims],
                            cause="daemon-tree")
            elif not stopping:
                flightrec.record(flightrec.DAEMON_FAULT, job=job.id,
                                 deaths=victims, cause="daemon-tree")
                self._stream(job, [
                    "note",
                    f"zprted: daemon subtree {sorted(ids)} died taking "
                    f"ranks {victims}; terminating job {job.id}\n"])
                self._teardown_job(job, rc=137)
                continue
            if last and not stopping:
                job.done.set()

    def _parent_lost(self) -> None:
        """This daemon's parent link died.  The root has (or will)
        declare this whole subtree dead — a daemon serving a store it
        can no longer reach must not keep ranks half-alive, so tear
        the local jobs down and stop."""
        if self.closed or self._stopping_tree:
            return
        mca_output.emit(
            _stream, "tree: parent daemon at %s lost — stopping this "
            "subtree", self._parent_addr,
        )
        self.stop()

    # -- root-store coherence hooks ---------------------------------------

    def _on_store_generation(self, ns: str, gen: int) -> None:
        self._broadcast_down("gen", [ns, int(gen)])

    def _on_store_destroy(self, ns: str) -> None:
        self._broadcast_down("nsdown", [ns])

    # -- metrics aggregation ----------------------------------------------

    def _metrics_ranks(self, ns: str) -> dict[int, dict]:
        """Per-rank published metrics of one namespace, staleness-
        stamped (``staleness_s``: daemon wall clock minus the
        snapshot's publish stamp), with each rank's flight-recorder
        window attached when one was published."""
        now = time.time()
        ranks: dict[int, dict] = {}
        for key, payload in self.store.lookup(ns, "metrics:").items():
            try:
                rank = int(key.rsplit(":", 1)[1])
                rec = dict(payload)
            except (ValueError, TypeError):
                continue  # foreign key shape: not a publisher's
            rec["staleness_s"] = max(0.0, now - float(rec.get("t", now)))
            ranks[rank] = rec
        for key, win in self.store.lookup(ns, "flightrec:").items():
            try:
                rank = int(key.rsplit(":", 1)[1])
            except ValueError:
                continue
            ranks.setdefault(rank, {})["flightrec"] = win
        return ranks

    def _metrics_view(self, ns: str, rank: int | None = None):
        """The ``metrics`` RPC: one rank's record, or the whole job —
        every rank's record plus the job-aggregated counter view
        (counters summed, watermarks maxed)."""
        ranks = self._metrics_ranks(ns)
        if not ranks:
            raise errors.ArgError(
                f"zprted metrics: no metrics published for job {ns!r} "
                "(launch with metrics=True / ZMPI_METRICS=1)")
        if rank is not None:
            if rank not in ranks:
                raise errors.ArgError(
                    f"zprted metrics: rank {rank} of job {ns!r} has "
                    "published nothing")
            return ranks[rank]
        aggregate: dict[str, int] = {}
        watermarks: set[str] = set()
        for rec in ranks.values():
            watermarks.update(rec.get("watermark") or ())
            for name, value in (rec.get("counters") or {}).items():
                if name in watermarks:
                    aggregate[name] = max(aggregate.get(name, 0), value)
                else:
                    aggregate[name] = aggregate.get(name, 0) + value
        return {"job": ns, "ranks": ranks, "aggregate": aggregate}

    @staticmethod
    def _prom_name(name: str) -> str:
        """Metric-name charset is [a-zA-Z0-9_:]; anything else (a
        templated family like ``comm_<name>_coll_calls`` instantiated
        with a dashed communicator name) collapses to ``_`` — one bad
        counter name must not invalidate the whole scrape body."""
        return re.sub(r"[^a-zA-Z0-9_:]", "_", name)

    @staticmethod
    def _prom_label(value: str) -> str:
        """Label-value escaping per the text exposition format
        (backslash, double-quote, newline)."""
        return (str(value).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def prometheus(self) -> str:
        """Text exposition of every namespace's published snapshots:
        ``zmpi_spc_<counter>{job="...",rank="..."} value`` plus a
        staleness gauge per rank — the ``GET /metrics`` body.  Samples
        are grouped by METRIC family (one contiguous block after each
        TYPE line, the exposition format's rule), not by rank — strict
        OpenMetrics-mode scrapers reject interleaved families."""
        # metric -> (kind, [sample lines]); insertion builds the rows,
        # emission walks families sorted
        families: dict[str, tuple[str, list[str]]] = {}

        def sample(metric: str, kind: str, labels: str, value) -> None:
            fam = families.setdefault(metric, (kind, []))
            fam[1].append(f"{metric}{labels} {value}")

        for ns in self.store.namespaces():
            ranks = self._metrics_ranks(ns)
            for rank in sorted(ranks):
                rec = ranks[rank]
                counters = rec.get("counters") or {}
                watermarks = set(rec.get("watermark") or ())
                labels = (f'{{job="{self._prom_label(ns)}",'
                          f'rank="{rank}"}}')
                for name in sorted(counters):
                    sample(f"zmpi_spc_{self._prom_name(name)}",
                           "gauge" if name in watermarks else "counter",
                           labels, counters[name])
                if "staleness_s" in rec:
                    sample("zmpi_metrics_age_seconds", "gauge", labels,
                           f"{rec['staleness_s']:.3f}")
        lines: list[str] = []
        for metric in sorted(families):
            kind, rows = families[metric]
            lines.append(f"# TYPE {metric} {kind}")
            lines.extend(rows)
        return "\n".join(lines) + ("\n" if lines else "")

    def _stream(self, job: _Job, payload: list) -> None:
        """One frame to the job's IOF client; a departed client must
        never wedge the daemon (output is dropped, children keep
        draining so their pipes never block)."""
        from ..pt2pt.tcp import _send_frame
        from ..utils import dss

        if job.io_broken or job.conn is None:
            # a child daemon's thin job mirror has no IOF client: its
            # lines ride the tree link up instead (_drain_iof)
            return
        try:
            with job.conn_lock:
                _send_frame(job.conn, dss.pack(payload))
        except OSError:
            job.io_broken = True

    # -- launch ----------------------------------------------------------

    def _rank_env(self, job: _Job, rank: int,
                  rejoin: "tuple[int, list[int]] | None" = None) -> dict:
        """The ZMPI_* contract of a daemon-hosted rank: PMIx-served
        modex (no coordinator address at all), the daemon's own address
        for the relaunch RPC, and the per-job session tag the /dev/shm
        sweep keys on.  Stale ZMPI_* from the daemon's OWN launch
        environment is scrubbed — a daemon started under zmpirun must
        not leak its launcher's contract into its children."""
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("ZMPI_")}
        env.update({
            "ZMPI_RANK": str(rank),
            "ZMPI_SIZE": str(job.size),
            "ZMPI_PMIX": f"{self.host}:{self.pmix.address[1]}/{job.id}",
            "ZMPI_DVM": f"{self.host}:{self.address[1]}",
            "ZMPI_JOB": job.id,
            "ZMPI_SESSION": job.session,
            # the rank parks one connection on OUR control port for its
            # whole life: daemon death severs it and the rank exits —
            # a dead daemon's subtree takes its ranks with it
            "ZMPI_LIFELINE": f"{self.host}:{self.address[1]}",
        })
        if job.ft:
            env["ZMPI_FT"] = "1"
        if job.elastic:
            # elastic membership contract: the endpoint universe is the
            # launch-time max, the CURRENT live set rides here (absent
            # ranks wire up as pre-acknowledged departures), and the
            # rank's elastic session skips resize events at or below
            # the one it was born into
            env["ZMPI_ELASTIC_LIVE"] = ",".join(
                str(r) for r in sorted(job.target))
            env["ZMPI_ELASTIC_SEEN"] = str(job.resize_seq - 1)
        if job.metrics:
            # the opt-in metrics plane: every rank of this job runs the
            # spc publisher against the resident store
            env["ZMPI_METRICS"] = "1"
        if job.trace:
            # the tracing plane rides the metrics publisher: every
            # rank arms its span recorder and ships trace:<job>:<rank>
            env["ZMPI_TRACE"] = "1"
        if rejoin is not None:
            # recovery-window metadata: the bumped namespace generation
            # and the whole batch of co-respawned ranks, so each
            # replacement reads its siblings' cards at the FRESH
            # generation (the corpse's old card must not satisfy it)
            gen, batch = rejoin
            env["ZMPI_REJOIN"] = "1"
            env["ZMPI_REJOIN_GEN"] = str(gen)
            env["ZMPI_REJOIN_RANKS"] = ",".join(str(r) for r in batch)
        pkg_root = _pkg_root()
        parts = env.get("PYTHONPATH", "").split(os.pathsep)
        if pkg_root not in parts:
            env["PYTHONPATH"] = os.pathsep.join(
                [pkg_root] + [p for p in parts if p])
        for name, value in job.mca or ():
            env[f"ZMPI_MCA_{name}"] = str(value)
        return env

    def _spawn_rank(self, job: _Job, rank: int,
                    rejoin: "tuple[int, list[int]] | None" = None
                    ) -> subprocess.Popen:
        p = subprocess.Popen(
            job.cmds[rank],
            env=self._rank_env(job, rank, rejoin=rejoin),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True,  # isolate from the daemon's signals
        )
        for stream, label in ((p.stdout, ""), (p.stderr, ":err")):
            t = threading.Thread(
                target=self._drain_iof, args=(job, rank, label, stream),
                daemon=True, name=f"dvm-iof-{job.id}-{rank}{label}",
            )
            t._dvm_proc = p  # the incarnation this drain serves
            t.start()
            job.drains.append(t)
        w = threading.Thread(
            target=self._watch_child, args=(job, rank, p),
            daemon=True, name=f"dvm-wait-{job.id}-{rank}",
        )
        w.start()
        job.watchers.append(w)
        return p

    def _drain_iof(self, job: _Job, rank: int, label: str, stream) -> None:
        for line in iter(stream.readline, ""):
            if self._parent_link is not None:
                try:
                    self._parent_link.send_up(
                        "io", [job.id, rank, label, line])
                except OSError:
                    break  # parent gone: _parent_lost tears us down
            else:
                self._stream(job, ["io", rank, label, line])
        stream.close()

    def _spawn_ranks(self, job: _Job, ranks: list[int],
                     rejoin: "tuple[int, list[int]] | None" = None
                     ) -> dict[int, int]:
        """Spawn ``ranks`` per the job's placement: local slots exec on
        THIS daemon, remote slots ride ``spawn`` frames down the tree
        to their hosts.  Returns the LOCAL pids (remote pids arrive as
        ``spawned`` frames)."""
        by_daemon: dict[str, list[int]] = {}
        for r in ranks:
            by_daemon.setdefault(
                job.placement.get(r, self.id), []).append(r)
        pids: dict[int, int] = {}
        local = by_daemon.pop(self.id, [])
        if local:
            with job.lock:
                for rank in local:
                    p = self._spawn_rank(job, rank, rejoin=rejoin)
                    job.procs[rank] = p
                    job.live += 1
                    pids[rank] = p.pid
        for daemon_id, rs in by_daemon.items():
            with job.lock:
                for r in rs:
                    if r not in job.remote_alive:
                        job.remote_alive.add(r)
                        job.live += 1
            try:
                # counted per remote spawn frame: the scaling gates
                # assert launch fan-out rides the tree, not root-direct
                spc.record("dvm_tree_routed_launches")
                self._send_tree(daemon_id, "spawn", {
                    "job": job.id, "size": job.size,
                    "cmds": {r: job.cmds[r] for r in rs},
                    "ranks": rs, "ft": job.ft,
                    "mca": [list(m) for m in (job.mca or [])],
                    "session": job.session, "metrics": job.metrics,
                    "trace": job.trace, "elastic": job.elastic,
                    "live": sorted(job.target),
                    "seen": job.resize_seq - 1,
                    "rejoin": None if rejoin is None
                    else [int(rejoin[0]), [int(r) for r in rejoin[1]]],
                })
            except errors.MpiError:
                # no route (the daemon died between placement and this
                # spawn): roll the phantom ranks back OUT of the live
                # accounting — ranks never spawned never report
                # exited, and job.live must still reach 0
                with job.lock:
                    for r in rs:
                        if r in job.remote_alive:
                            job.remote_alive.discard(r)
                            job.live -= 1
                    job.cv.notify_all()
                raise
        return pids

    def _spawn_remote(self, payload: dict) -> None:
        """Child side of a ``spawn`` frame: materialize (or extend) the
        thin local job mirror, exec the ranks, report their pids up."""
        job_id = str(payload["job"])
        size = int(payload["size"])
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                job = _Job(
                    job_id, size, [None] * size, bool(payload["ft"]),
                    [tuple(m) for m in (payload.get("mca") or [])],
                    str(payload["session"]), None, None,
                    metrics=bool(payload.get("metrics")),
                    trace=bool(payload.get("trace")),
                )
                self._jobs[job_id] = job
        job.elastic = bool(payload.get("elastic"))
        job.target = set(int(r) for r in (payload.get("live")
                                          or range(size)))
        job.resize_seq = int(payload.get("seen", -1)) + 1
        rejoin = payload.get("rejoin")
        rejoin = None if rejoin is None else (
            int(rejoin[0]), [int(r) for r in rejoin[1]])
        ranks = [int(r) for r in payload["ranks"]]
        pids: dict[int, int] = {}
        with job.lock:
            for rank in ranks:
                job.cmds[rank] = [str(a) for a in
                                  payload["cmds"][rank]]
                old = job.procs.get(rank)
                if old is not None and old.poll() is None:
                    # a respawn over a wedged local incarnation: the
                    # declared-dead process is killed first (the PRRTE
                    # contract the root applies to ITS local ranks too)
                    try:
                        os.killpg(os.getpgid(old.pid), signal.SIGKILL)
                    except (OSError, ProcessLookupError):
                        pass
                if old is not None \
                        and not getattr(old, "_dvm_accounted", False):
                    old._dvm_accounted = True
                    job.superseded.setdefault(rank, []).append(old)
                p = self._spawn_rank(job, rank, rejoin=rejoin)
                job.procs[rank] = p
                pids[rank] = p.pid
        if self._parent_link is not None:
            try:
                self._parent_link.send_up("spawned", [job_id, pids])
            except OSError:
                pass

    def _remote_spawned(self, job: _Job, pids: dict[int, int]) -> None:
        """ROOT accounting for a child's spawn report: remember the
        pids, wake respawn/resize waiters."""
        with job.lock:
            job.remote_pids.update(pids)
            for r in pids:
                if r not in job.remote_alive:
                    job.remote_alive.add(r)
                    job.live += 1
            job.cv.notify_all()

    def _remote_exited(self, job: _Job, rank: int, rc: int) -> None:
        """ROOT accounting for a remote rank's death (OS truth riding
        up the tree), then the same policy fork the local watcher
        takes: ft jobs flood the fault, non-ft jobs abort."""
        with job.lock:
            if rank not in job.remote_alive:
                return  # stale report (a superseded incarnation)
            job.remote_alive.discard(rank)
            job.remote_pids.pop(rank, None)
            job.rcs[rank] = rc
            job.live -= 1
            last = job.live == 0
            stopping = job.stopping
            if rc != 0 and not stopping and job.fail_rc is None \
                    and not job.retired(rank):
                job.fail_rc = 128 - rc if rc < 0 else rc
            job.cv.notify_all()
        self._exit_policy(job, rank, rc, last, stopping)

    @staticmethod
    def _resolve_cmd(argv: list) -> list[str]:
        argv = [str(a) for a in argv]
        return [sys.executable] + argv if argv[0].endswith(".py") \
            else argv

    def _handle_launch(self, spec: dict, conn, conn_lock) -> None:
        if self._parent_link is not None:
            raise errors.ArgError(
                "zprted: launch must target the ROOT daemon of the "
                "tree (this zprted runs with --parent; respawn/resize/"
                "stat relay up, launch does not)")
        apps = spec.get("apps")
        if apps:
            # MPMD into the VM: consecutive rank blocks per app context
            # (mixed C/Python jobs share the store-served wire-up)
            if any(int(cnt) < 1 for cnt, _ in apps):
                raise errors.ArgError(
                    "zprted launch: every app context needs n >= 1")
            n = sum(int(cnt) for cnt, _ in apps)
            cmds: list[list[str]] = []
            for cnt, argv in apps:
                cmds.extend([self._resolve_cmd(argv)] * int(cnt))
        else:
            n = int(spec["n"])
            if n < 1:
                raise errors.ArgError("zprted launch: n must be >= 1")
            cmds = [self._resolve_cmd(spec["argv"])] * n
        max_size = int(spec.get("max_size") or n)
        if max_size < n:
            raise errors.ArgError(
                f"zprted launch: max_size {max_size} below n {n}")
        elastic = max_size > n
        if elastic and not spec.get("ft"):
            raise errors.ArgError(
                "zprted launch: an elastic job (max_size > n) grows "
                "and shrinks through the FT_JOIN/BYE machinery — it "
                "requires ft=True")
        if elastic and apps:
            raise errors.ArgError(
                "zprted launch: elastic jobs are single-app (grown "
                "slots reuse the one argv)")
        if elastic:
            # the C shim speaks the store verbs but not the resize
            # event stream (ElasticSession is the worker-side half of
            # the contract) — an elastic C job would wedge its modex
            # fence against the absent slots.  "Python" means a .py
            # argv (resolved onto this interpreter) or an explicit
            # python interpreter spelling — not interpreter-path
            # equality, which would reject venv launches.
            head = os.path.basename(cmds[0][0])
            if cmds[0][0] != sys.executable \
                    and not head.startswith("python"):
                raise errors.ArgError(
                    "zprted launch: elastic jobs are Python-only "
                    "(the worker must run an "
                    "ft.recovery.ElasticSession)")
        if elastic:
            cmds = cmds + [cmds[0]] * (max_size - n)
        timeout = spec.get("timeout")
        priority = int(spec.get("priority") or 0)
        policy = str(spec.get("placement")
                     or mca_var.get("dvm_placement", "pack"))
        # admission is a QUEUE, not a convoy: the ticket blocks here —
        # streaming [queued, pos] frames so the client knows where it
        # stands — until the policy order and the concurrency cap both
        # admit it; a dead client's ticket is reaped (conn_alive), and
        # only then does setup() serialize the actual job setup
        ticket = self._admission.enqueue(priority)
        try:
            wait_s = self._admission.admit(
                ticket,
                alive=lambda: pmix_mod.conn_alive(conn),
                on_position=lambda pos: self._queued_frame(
                    conn, conn_lock, pos))
            if wait_s is None:
                mca_output.verbose(
                    1, _stream, "launch: queued client died — ticket "
                    "reaped, launch dropped")
                return
            if ticket.was_queued:
                spc.record("dvm_jobs_queued")
                spc.record("dvm_queue_wait_ms", int(wait_s * 1000))
            with self._admission.setup():
                with self._lock:
                    job_id = f"job{next(self._job_ids)}"
                    job = _Job(
                        job_id, max_size, cmds, bool(spec.get("ft")),
                        [tuple(m) for m in (spec.get("mca") or [])],
                        f"{self.session}_{job_id}",
                        conn, conn_lock,
                        metrics=bool(spec.get("metrics")),
                        # trace implies metrics (the publisher ships
                        # the span buffers): a trace-only launch gets
                        # both
                        trace=bool(spec.get("trace")),
                    )
                    if job.trace:
                        job.metrics = True
                    job.elastic = elastic
                    job.target = set(range(n))
                    self._jobs[job_id] = job
                # the namespace IS the jobid: ranks modex through the
                # resident store with zero per-job rendezvous
                # infrastructure.  Its size is the INITIAL live count
                # (the modex fence barriers the starters; grown ranks
                # rejoin without fencing).
                try:
                    self.store.ensure_ns(job_id, n)
                    with self._tree_lock:
                        daemons = list(self._placement_ids)
                    with self._lock:
                        live = [j for j in self._jobs.values()
                                if j is not job
                                and not j.done.is_set()]
                        busy: dict[str, int] = {}
                        for j in live:
                            for d in set(j.placement.values()):
                                busy[d] = busy.get(d, 0) + 1
                    placement, fell_back = dvmtree.place_job(
                        sorted(job.target), daemons, busy, policy)
                    if fell_back:
                        spc.record("dvm_placement_fallbacks")
                        self._stream(job, [
                            "note",
                            "zprted: exclusive placement unavailable "
                            "(no free daemon) — falling back to "
                            "spread\n"])
                    job.placement = placement
                    job.exclusive = policy == "exclusive" \
                        and not fell_back
                    # the per-job audit: prove this tenant's runtime
                    # state disjoint from every live co-tenant's
                    # before a single rank spawns
                    dvmtree.audit_placement(
                        {"id": job.id, "session": job.session,
                         "daemons": sorted(set(placement.values())),
                         "exclusive": job.exclusive},
                        [{"id": j.id, "session": j.session,
                          "daemons": sorted(set(
                              j.placement.values())),
                          "exclusive": j.exclusive}
                         for j in live])
                    self._stream(job, ["job", job_id])
                    self._spawn_ranks(job, sorted(job.target),
                                      rejoin=None)
                except errors.MpiError:
                    # half-spawned job (a daemon died between
                    # placement and its spawn frame) or a failed
                    # audit: the already-started ranks, the namespace,
                    # and the _jobs entry must not leak for the
                    # daemon's lifetime
                    self._teardown_job(job, rc=1)
                    self._finalize_job(job)
                    raise
                spc.record("dvm_jobs_launched")
            self._run_admitted(job, job_id, timeout)
        finally:
            # the one release covers every exit path: a finished job
            # frees its concurrency slot, a failed/errored launch its
            # ticket — either way the queue wakes
            self._admission.release(ticket)

    def _queued_frame(self, conn, conn_lock, pos: int) -> None:
        """One ``[queued, position]`` frame to a still-waiting launch
        client (no _Job exists yet, so this bypasses _stream).  Old
        clients ignore unknown stream kinds — the frame is additive."""
        from ..pt2pt.tcp import _send_frame
        from ..utils import dss

        try:
            with conn_lock:
                _send_frame(conn, dss.pack(["queued", int(pos)]))
        except OSError:
            pass  # admit()'s alive() poll reaps the dead client

    def _run_admitted(self, job: _Job, job_id: str,
                      timeout) -> None:
        # a job with no deadline of its own still may not park this
        # handler forever on a wedged rank set
        timeout = timeout if timeout \
            else float(mca_var.get("dvm_job_timeout", 600.0))
        if not job.done.wait(timeout):
            self._stream(job, ["note",
                               f"zprted: job {job_id} timeout after "
                               f"{timeout}s; killing it\n"])
            self._teardown_job(job, rc=124)
        # IOF flushes before the exit frame: each drain exits at its
        # stream's EOF, which the children's deaths guarantee.  The
        # joins share ONE generous deadline (_IOF_DRAIN_GRACE) instead
        # of a short per-thread bound: a drain starved by scheduler
        # load must not lose a rank's final lines to a client that
        # stops reading at the exit frame (the finalize-skew flake);
        # a drain STILL live past the deadline means a leaked
        # grandchild holds a dead child's pipe — reported loudly,
        # never as silent truncation.
        drain_deadline = time.monotonic() + _IOF_DRAIN_GRACE
        for t in list(job.drains):
            t.join(timeout=max(0.0, drain_deadline - time.monotonic()))
        straggler = [t.name for t in job.drains if t.is_alive()]
        if straggler:
            self._stream(job, [
                "note",
                f"zprted: IOF drain(s) {straggler} still live "
                f"{_IOF_DRAIN_GRACE:.0f}s after job {job.id} ended "
                "(a child's pipe is held open — leaked grandchild?); "
                "trailing output may be truncated\n"])
        with job.lock:
            if job.stopping:
                # abort/timeout teardown: the first failure (or 124) is
                # the job's code — the zmpirun contract
                rc = int(job.fail_rc or 0)
            else:
                # ran to completion: judge each rank by its LATEST
                # incarnation — a respawned-over corpse's exit status
                # is recovery history, not a job failure, and a
                # RETIRED elastic slot's exit (even the escalation
                # ladder's SIGTERM) was a requested departure
                bad = [c for r, c in job.rcs.items()
                       if c != 0 and not job.retired(r)]
                rc = (128 - bad[0] if bad[0] < 0 else int(bad[0])) \
                    if bad else 0
        self._stream(job, ["exit", rc])
        self._finalize_job(job)

    # -- child watching / fault events -----------------------------------

    def _watch_child(self, job: _Job, rank: int,
                     p: subprocess.Popen) -> None:
        """One BLOCKING waitpid per child — the daemon's failure source
        is the OS, not a timeout.  On a tree CHILD the exit climbs to
        the root (which owns accounting and policy); the root and the
        single-daemon shape account locally."""
        rc = p.wait()
        with job.lock:
            # exit accounting happens EXACTLY once per proc: here, or in
            # the respawn RPC's corpse-adoption path if it won the race
            if getattr(p, "_dvm_accounted", False):
                return
            p._dvm_accounted = True
            current = job.procs.get(rank) is p
            if self._parent_link is None:
                if current:
                    job.rcs[rank] = rc
                job.live -= 1
                last = job.live == 0
                stopping = job.stopping
                if current and rc != 0 and not stopping \
                        and job.fail_rc is None \
                        and not job.retired(rank):
                    # signal death → 128+sig (the shell convention)
                    job.fail_rc = 128 - rc if rc < 0 else rc
                job.cv.notify_all()
        if self._parent_link is not None:
            if current:
                # flush THIS incarnation's IOF drains before reporting
                # the exit: the tree link is FIFO, so once the tails
                # are on the wire the root streams them before it can
                # account the death and emit the job's exit frame (a
                # dead child's pipes are at EOF — the join waits out
                # scheduler starvation under the same shared grace as
                # the root's exit-frame joins, never a live stream)
                drain_deadline = time.monotonic() + _IOF_DRAIN_GRACE
                for t in list(job.drains):
                    if getattr(t, "_dvm_proc", None) is p:
                        t.join(timeout=max(
                            0.0, drain_deadline - time.monotonic()))
                try:
                    self._parent_link.send_up(
                        "exited", [job.id, rank, int(rc)])
                except OSError:
                    pass  # parent gone: _parent_lost tears us down
            return
        if current:
            self._exit_policy(job, rank, rc, last, stopping)
        elif last and not stopping:
            job.done.set()

    def _exit_policy(self, job: _Job, rank: int, rc: int, last: bool,
                     stopping: bool) -> None:
        """The fork every rank death takes at the accounting daemon:
        ft jobs flood an authoritative fault event (death is a
        recovery input, the job keeps running); non-ft jobs abort
        (MPI_Abort semantics, the zmpirun contract)."""
        if rc != 0 and not stopping:
            norm = 128 - rc if rc < 0 else rc
            if job.ft:
                # authoritative fault event: the survivors learn NOW,
                # from OS truth, not after a heartbeat window
                self._fault(job, [(rank, rc)], cause="daemon")
            else:
                self._stream(job, ["note",
                                   f"zprted: rank {rank} exited with "
                                   f"code {norm}; terminating job "
                                   f"{job.id}\n"])
                self._teardown_job(job, rc=norm)
                return
        if last and not stopping:
            job.done.set()

    def _fault(self, job: _Job, deaths: list, cause: str = "daemon"
               ) -> None:
        """Authoritative fault event, routed BOTH ways: record it,
        notify the survivors THIS daemon hosts, and flood the
        classification down every child link — each daemon of the tree
        notifies its own ranks, so the whole job learns without the
        root dialing every survivor socket itself."""
        spc.record("dvm_fault_events", len(deaths))
        flightrec.record(flightrec.DAEMON_FAULT, job=job.id,
                         deaths=[int(r) for r, _ in deaths],
                         cause=cause)
        mca_output.verbose(
            2, _stream, "job %s: rank(s) %s died (cause=%s); flooding "
            "fault event", job.id, [r for r, _ in deaths], cause,
        )
        self._notify_local_ranks(job, deaths, cause)
        self._broadcast_down(
            "fault",
            [job.id, [[int(r), int(rc)] for r, rc in deaths], cause])

    def _notify_local_ranks(self, job: _Job, deaths: list,
                            cause: str) -> None:
        """FT_DVM_CID to every survivor THIS daemon hosts, addressed
        from the name-served cards (leaf-cached on a tree child — the
        flood costs the root nothing per rank)."""
        from ..pt2pt.tcp import _send_frame
        from ..ft import ulfm
        from ..utils import dss

        dead = {int(r) for r, _ in deaths}
        hello = dss.pack(["d", -1])
        frame = dss.pack(-1, 0, ulfm.FT_DVM_CID, 0,
                         [[int(r), int(rc), str(cause)]
                          for r, rc in deaths])

        def notify(rank):
            # the card lookup rides INSIDE the per-rank thread: one
            # not-yet-modexed survivor's get timeout must not delay
            # the already-modexed survivors' notifications
            try:
                card = self.store.get(job.id, f"card:{rank}",
                                      timeout=0.25)
            except errors.MpiError:
                return  # not modexed yet: nothing to notify
            try:
                sock = socket.create_connection(
                    (card[0], int(card[1])), 2.0)
            except OSError:
                return  # also dying: its own watcher's course
            try:
                _send_frame(sock, hello)
                _send_frame(sock, frame)
            except OSError:
                pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass

        # one short-lived thread per survivor: the whole point of this
        # event is beating the heartbeat window, so a co-dying rank's
        # connect timeout (or a not-yet-modexed card) must not serialize
        # ahead of the survivors still waiting to hear
        for r in job.alive_ranks():
            if r in dead:
                continue
            threading.Thread(
                target=notify, args=(r,),
                daemon=True, name=f"dvm-fault-{job.id}-{r}",
            ).start()

    def _kill_local_ranks(self, job_id: str, ranks: list[int],
                          sig=signal.SIGTERM) -> None:
        """Signal THIS daemon's procs for ``ranks`` (retire
        escalation / tree-wide teardown helpers)."""
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            return
        with job.lock:
            procs = [job.procs[r] for r in ranks if r in job.procs]
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), sig)
                except (OSError, ProcessLookupError):
                    pass

    def _handle_respawn(self, job_id: str, ranks: list[int]) -> list[int]:
        """The relaunch RPC: exec a fresh OS process per victim.  ONE
        generation bump covers the whole batch — N replacements of one
        recovery window publish their fresh cards under the same tag
        and FT_JOIN the same name-served job.  On a tree, each victim
        respawns on the daemon that PLACED it: local slots exec here,
        remote slots ride spawn frames down and their pids ride back
        up."""
        job = self._job(job_id)
        if job.done.is_set():
            raise errors.ArgError(
                f"zprted: job {job_id} already completed")
        if not ranks:
            return []
        batch = sorted(set(int(r) for r in ranks))
        # respawn IS job setup: it reads placement/target and ships
        # membership env (ZMPI_ELASTIC_*) — riding its job's admission
        # (the setup lock directly, never the launch queue) keeps it
        # from observing a resize's half-applied state, and a QUEUED
        # launch can never interleave it (tickets hold no lock)
        with self._admission.setup():
            return self._respawn_admitted(job, job_id, batch)

    def _respawn_admitted(self, job: _Job, job_id: str,
                          batch: list[int]) -> list[int]:
        # validate the WHOLE batch before spawning any of it: a bad
        # rank must not leave a half-respawned recovery window
        for rank in batch:
            if not 0 <= rank < job.size:
                raise errors.ArgError(
                    f"zprted respawn: rank {rank} outside job "
                    f"{job_id} (size {job.size})")
            if job.elastic and rank not in job.target:
                raise errors.ArgError(
                    f"zprted respawn: rank {rank} is outside job "
                    f"{job_id}'s live membership — a retired slot "
                    "grows back through the resize RPC")
        local = [r for r in batch
                 if job.placement.get(r, self.id) == self.id]
        remote = [r for r in batch if r not in local]
        with job.lock:
            for rank in local:
                old = job.procs.get(rank)
                if old is not None and old.poll() is None:
                    # a victim the survivors AGREED dead whose OS
                    # process still exists is wedged (deadlock,
                    # SIGSTOP, half-dead) — the PRRTE contract kills
                    # the declared-dead incarnation before respawning,
                    # it never refuses the recovery
                    try:
                        os.killpg(os.getpgid(old.pid), signal.SIGKILL)
                    except (OSError, ProcessLookupError):
                        pass
                    try:
                        # zlint: disable=ZL002 -- the respawn batch is atomic under job.lock by design (generation window + exit accounting); the reap of a SIGKILLed corpse is bounded to 5 s
                        old.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        raise errors.InternalError(
                            f"zprted respawn: wedged rank {rank} of "
                            f"{job_id} survived SIGKILL")
            for rank in local:
                old = job.procs.get(rank)
                if old is not None:
                    if not getattr(old, "_dvm_accounted", False):
                        # adopt the corpse's exit before its watcher
                        # does: the once-per-proc accounting contract
                        old._dvm_accounted = True
                        job.rcs[rank] = old.returncode
                        job.live -= 1
                    job.superseded.setdefault(rank, []).append(old)
            for rank in batch:
                # the replacement's exit judges the slot from here on —
                # and a wedged REMOTE incarnation's stale pid must not
                # satisfy the confirmation wait below (its daemon
                # SIGKILLs it without an exited report)
                job.rcs.pop(rank, None)
                if rank in remote:
                    job.remote_pids.pop(rank, None)
        gen = self.store.bump_generation(job_id)
        local_pids = self._spawn_ranks(job, batch, rejoin=(gen, batch))
        self._await_remote_pids(job, remote, "respawn")
        spc.record("dvm_respawns", len(batch))
        # root-side respawn event: the soak harness's MTTR postmortem
        # reads the daemon's own flight recorder, not a rank's
        flightrec.record(flightrec.RESPAWN, job=job_id,
                         ranks=[int(r) for r in batch],
                         generation=int(gen))
        with job.lock:
            return [local_pids.get(r, job.remote_pids.get(r))
                    for r in batch]

    def _await_remote_pids(self, job: _Job, ranks: list[int],
                           what: str, timeout: float = 20.0) -> None:
        """Block until every remote rank's hosting daemon confirmed
        its spawn (the ``spawned`` frame repopulates
        ``job.remote_pids``)."""
        if not ranks:
            return
        deadline = time.monotonic() + timeout
        with job.cv:
            while not all(r in job.remote_pids for r in ranks):
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = [r for r in ranks
                               if r not in job.remote_pids]
                    raise errors.InternalError(
                        f"zprted {what}: daemons hosting ranks "
                        f"{missing} never confirmed the spawn")
                job.cv.wait(min(left, 0.25))

    # -- elastic resize ---------------------------------------------------

    def _publish_resize(self, job: _Job, seq: int, kind: str,
                        ranks: list[int], gen: int) -> None:
        """One resize event into the job's namespace — the worker-side
        elastic sessions consume the ``resize:<seq>`` stream in order
        (rank 0 of the live endpoint reads it and broadcasts, so the
        whole job applies each event at one loop boundary)."""
        self.store.put(job.id, -1, f"resize:{seq}", {
            "seq": int(seq), "kind": str(kind),
            "ranks": [int(r) for r in ranks],
            "live": sorted(job.target), "generation": int(gen),
        })
        self.store.commit(job.id, -1)

    def _handle_resize(self, job_id: str, new_n: int) -> dict:
        """The resize RPC: grow spawns fresh ranks into a bumped
        store generation (they FT_JOIN the live job exactly like a
        recovery window's replacements); shrink retires the highest
        live ranks through the orderly-BYE path (they observe the
        event, close, and exit 0).  Rides the admission lock: a resize
        is job setup and may not interleave with a launch."""
        job = self._job(job_id)
        if not job.ft:
            raise errors.ArgError(
                "zprted resize: only ft jobs resize (grow rides "
                "FT_JOIN, shrink rides the orderly BYE)")
        if job.done.is_set():
            raise errors.ArgError(
                f"zprted: job {job_id} already completed")
        new_n = int(new_n)
        if not 1 <= new_n <= job.size:
            raise errors.ArgError(
                f"zprted resize: size {new_n} outside 1..{job.size} "
                "(the launch max_size)")
        with self._admission.setup():
            with job.lock:
                target = set(job.target)
            delta = new_n - len(target)
            if delta == 0:
                return {"job": job_id, "size": new_n, "grown": [],
                        "retired": [], "seq": None,
                        "generation": self.store.generation(job_id)}
            with job.lock:
                seq = job.resize_seq
                job.resize_seq = seq + 1
            sp = ztrace.begin(ztrace.RESIZE, -1, job=job_id,
                              delta=delta) if ztrace.active else None
            if delta > 0:
                grown = sorted(r for r in range(job.size)
                               if r not in target)[:delta]
                # ONE generation bump for the whole grow window (the
                # respawn-batch contract): every new rank publishes its
                # card under the fresh tag, and the bump rides the tree
                # links down as cache invalidations
                gen = self.store.bump_generation(job_id)
                with self._tree_lock:
                    daemons = list(self._placement_ids)
                with job.lock:
                    job.target |= set(grown)
                    # fresh placement over the CURRENT daemon list —
                    # a re-grown slot must not inherit a placement
                    # entry pointing at a daemon that since detached —
                    # restricted to the job's CLAIMED subtree while
                    # any of it survives: a grown slot of an
                    # exclusive/spread tenant must not land on a
                    # co-tenant's daemons
                    prev_placement = {r: job.placement.get(r)
                                      for r in grown}
                    claimed = set(job.placement.values())
                    pool = [d for d in daemons if d in claimed] \
                        or daemons
                    for i, r in enumerate(grown):
                        job.placement[r] = pool[i % len(pool)]
                try:
                    local_pids = self._spawn_ranks(job, grown,
                                                   rejoin=(gen, grown))
                    self._await_remote_pids(
                        job, [r for r in grown
                              if r not in local_pids],
                        "resize grow")
                except errors.MpiError:
                    # a failed grow must not poison the RUNNING job:
                    # restore the pre-grow membership and seq before
                    # re-raising, so survivors never see (and block
                    # on) an event whose ranks will never FT_JOIN.
                    # The event publishes only AFTER confirmation; the
                    # spare generation bump is a harmless cache
                    # invalidation.
                    with job.lock:
                        job.target -= set(grown)
                        for r, d in prev_placement.items():
                            if d is None:
                                job.placement.pop(r, None)
                            else:
                                job.placement[r] = d
                        job.resize_seq = seq
                    raise
                self._publish_resize(job, seq, "grow", grown, gen)
                retired: list[int] = []
            else:
                retired = sorted(target)[delta:]
                gen = self.store.generation(job_id)
                with job.lock:
                    job.target -= set(retired)
                self._publish_resize(job, seq, "shrink", retired, gen)
                self._await_retire(job, retired)
                grown = []
            spc.record("dvm_resizes")
            flightrec.record(
                flightrec.RESIZE, job=job_id,
                kind="grow" if delta > 0 else "shrink",
                ranks=grown or retired, generation=int(gen))
            if sp is not None:
                sp.end(generation=int(gen), delta=delta)
        mca_output.verbose(
            1, _stream, "job %s resized to %d (%s %s, generation %d)",
            job_id, new_n, "grew" if delta > 0 else "retired",
            grown or retired, gen,
        )
        return {"job": job_id, "size": new_n, "grown": grown,
                "retired": retired, "seq": seq,
                "generation": int(gen)}

    def _await_retire(self, job: _Job, ranks: list[int],
                      grace: float = 15.0) -> None:
        """Retiring ranks exit THEMSELVES: the elastic session observes
        the shrink event at its next loop boundary, says an orderly
        BYE, and exits 0.  Halfway through the grace window the daemon
        escalates to SIGTERM; a rank that still won't leave is noted
        loudly and left to the accounting (a later grow over its slot
        SIGKILLs it like any wedged incarnation)."""
        deadline = time.monotonic() + grace
        escalated = False
        while True:
            with job.lock:
                waiting = [
                    r for r in ranks
                    if r in job.remote_alive
                    or (r in job.procs
                        and job.procs[r].poll() is None)
                ]
            if not waiting:
                return
            now = time.monotonic()
            if now > deadline:
                self._stream(job, [
                    "note",
                    f"zprted: resize: retiring ranks {waiting} did "
                    f"not exit within {grace}s\n"])
                return
            if not escalated and now > deadline - grace / 2:
                escalated = True
                self._kill_local_ranks(job.id, waiting)
                self._broadcast_down("kill-ranks", [job.id, waiting])
            with job.cv:
                job.cv.wait(0.1)

    # -- teardown ---------------------------------------------------------

    def _teardown_job(self, job: _Job, rc: int) -> None:
        with job.lock:
            job.stopping = True
            if job.fail_rc is None or rc == 124:
                job.fail_rc = rc
            procs = list(job.procs.values())
            remote = bool(job.remote_alive)
        if self._parent_link is None and remote:
            # tree-wide teardown: every daemon kills its local procs;
            # their exits ride up and drain remote_alive
            self._broadcast_down("kill", [job.id, int(rc)])
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGTERM)
                except (OSError, ProcessLookupError):
                    pass
        grace_end = time.monotonic() + _TERM_GRACE
        for p in procs:
            try:
                p.wait(timeout=max(0.0, grace_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    pass
                p.wait()
        if self._parent_link is None and remote:
            deadline = time.monotonic() + 2 * _TERM_GRACE
            with job.cv:
                while job.remote_alive \
                        and time.monotonic() < deadline:
                    job.cv.wait(0.1)
        job.done.set()

    def _finalize_job(self, job: _Job) -> None:
        """End-of-job hygiene: reap superseded corpses, drop the
        namespace (the destroy hook broadcasts the invalidation), tell
        the tree the job is over, sweep the job's /dev/shm artifacts
        (killed ranks never unlink their own rings)."""
        with job.lock:
            leftovers = [p for ps in job.superseded.values() for p in ps]
        for p in leftovers:
            try:
                p.wait(timeout=1.0)
            except subprocess.TimeoutExpired:
                pass
        if self._parent_link is None:
            # only the ROOT owns the namespace lifecycle (a stopping
            # child must not destroy a job still running elsewhere);
            # the destroy hook broadcasts the invalidation
            self.store.destroy_ns(job.id)
            self._broadcast_down("jobdone", [job.id])
        elif isinstance(self.store, dvmtree.RoutedStore):
            self.store.forget_ns(job.id)
        _sweep_shm(job.session)
        with self._lock:
            self._jobs.pop(job.id, None)

    def stop(self) -> None:
        """Orderly daemon shutdown: kill every live job, drop the store,
        close both listeners (the shared shutdown ladder), sweep the
        session."""
        if self.closed:
            return
        self._stopping_tree = True
        # queued launches first: every waiter raises (the client gets
        # an err frame) instead of parking on a queue nobody will
        # ever advance again
        self._admission.close()
        with self._lock:
            jobs = list(self._jobs.values())
        # local jobs die BEFORE the goodbye: their exits ride the
        # still-open parent link, so the root's accounting drains
        # instead of stranding the ranks in remote_alive forever
        for job in jobs:
            self._teardown_job(job, rc=143)
            self._finalize_job(job)
        if self._parent_link is not None:
            # the watchers' exited frames must be ON the wire before
            # the goodbye (the procs are dead, so the joins are
            # bounded hygiene, not waits on live children)
            for job in jobs:
                for w in job.watchers:
                    if w is not threading.current_thread():
                        w.join(timeout=5.0)
            # orderly goodbye before the listener closes: the parent
            # must not classify this shutdown as a lost subtree, and
            # the root unlearns this daemon from placement
            self._parent_link.detach()
        if self.metrics_http is not None:
            self.metrics_http.close()
        self.pmix.close()
        super().close()
        _sweep_shm(self.session)
        self._stop_evt.set()

    def close(self) -> None:
        """The RPC-scaffold name for :meth:`stop` — a Dvm closed like a
        bare server still tears its jobs down."""
        self.stop()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the daemon is stopped (RPC or signal)."""
        return self._stop_evt.wait(timeout)


class DvmClient:
    """Client handle to a running daemon — ``zmpirun --dvm`` and the
    recovery pipeline's relaunch RPC both speak through this."""

    def __init__(self, address: tuple[str, int] | str,
                 timeout: float = 30.0):
        self.address = pmix_mod.parse_addr(address)
        self._timeout = timeout
        self.last_job_id: str | None = None
        #: last [queued, pos] frame seen by launch() — None until the
        #: daemon actually parks the launch in its admission queue
        self.last_queue_position: int | None = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        try:
            self._sock.connect(self.address)
        except OSError as e:
            self._sock.close()
            raise errors.InternalError(
                f"zprted: no daemon at {self.address}: {e}"
            ) from e

    def _call(self, req: list, wait: float | None = None) -> Any:
        from ..pt2pt.tcp import _recv_frame, _send_frame
        from ..utils import dss

        self._sock.settimeout((wait or 0.0) + self._timeout)
        try:
            _send_frame(self._sock, dss.pack(req))
            frame = _recv_frame(self._sock)
        except OSError as e:
            raise errors.InternalError(
                f"zprted: daemon connection lost mid-{req[0]}: {e}"
            ) from e
        if frame is None:
            raise errors.InternalError(
                f"zprted: daemon closed the connection mid-{req[0]}")
        [status, value] = dss.unpack(frame)[0]
        if status != "ok":
            raise errors.InternalError(f"zprted {req[0]}: {value}")
        return value

    def launch(self, n: int, argv: list[str] | None = None,
               mca: list | None = None, ft: bool = False,
               timeout: float | None = None, tag_output: bool = True,
               stdout=None, stderr=None, metrics: bool = False,
               trace: bool = False, max_size: int | None = None,
               apps: list | None = None, priority: int = 0,
               placement: str | None = None) -> int:
        """Launch an n-rank job into the resident VM; streams its IOF
        and returns the job exit code (the ``zmpirun`` surface, minus
        the per-job launcher).  ``max_size`` (> n) makes the job
        ELASTIC: the endpoint universe is max_size, ranks n..max_size-1
        start absent, and the ``resize`` RPC grows/shrinks the live
        membership while the job runs.  ``apps`` replaces ``argv`` for
        MPMD into the VM: ``[(n1, argv1), (n2, argv2), ...]`` launches
        consecutive rank blocks per context (mixed C/Python jobs share
        the store-served wire-up); ``n`` is ignored when given.
        ``priority`` orders this launch in the daemon's admission
        queue under dvm_admission_policy=priority (higher first);
        ``placement`` overrides the daemon's dvm_placement policy for
        this job (pack/spread/exclusive).  While the launch waits in
        the admission queue the daemon streams ``[queued, pos]``
        frames — mirrored into :attr:`last_queue_position` and noted
        on ``stderr``."""
        from ..pt2pt.tcp import _recv_frame, _send_frame
        from ..utils import dss

        stdout = stdout if stdout is not None else sys.stdout
        stderr = stderr if stderr is not None else sys.stderr
        if (argv is None) == (apps is None):
            raise errors.ArgError(
                "zprted launch: pass exactly one of argv / apps")
        spec = {"n": int(n),
                "argv": [str(a) for a in (argv or [])],
                "apps": None if apps is None else
                [[int(cnt), [str(a) for a in ctx]]
                 for cnt, ctx in apps],
                "mca": [list(m) for m in (mca or [])], "ft": bool(ft),
                "timeout": timeout, "metrics": bool(metrics),
                "trace": bool(trace),
                "max_size": None if max_size is None else int(max_size),
                "priority": int(priority),
                "placement": None if placement is None
                else str(placement)}
        self.last_queue_position = None
        # no client-imposed deadline without an explicit job timeout:
        # the daemon enforces its own (tunable) dvm_job_timeout and
        # ALWAYS sends the exit frame, and a daemon crash surfaces as
        # EOF/reset — a hard-coded recv timeout here would desync from
        # a raised server-side limit and abandon a healthy job's IOF
        self._sock.settimeout(timeout + 30.0 if timeout else None)
        try:
            _send_frame(self._sock, dss.pack(["launch", spec]))
            while True:
                frame = _recv_frame(self._sock)
                if frame is None:
                    raise errors.InternalError(
                        "zprted: daemon vanished mid-job")
                [msg] = dss.unpack(frame)
                kind = msg[0]
                if kind == "job":
                    self.last_job_id = msg[1]
                elif kind == "io":
                    _, rank, label, line = msg
                    sink = stderr if label else stdout
                    if tag_output:
                        sink.write(f"[{rank}{label}] {line}")
                    else:
                        sink.write(line)
                    sink.flush()
                elif kind == "note":
                    stderr.write(msg[1])
                    stderr.flush()
                elif kind == "queued":
                    self.last_queue_position = int(msg[1])
                    stderr.write(
                        f"zprted: launch queued at position "
                        f"{self.last_queue_position}\n")
                    stderr.flush()
                elif kind == "exit":
                    return int(msg[1])
                elif kind == "err":
                    raise errors.InternalError(f"zprted launch: {msg[1]}")
        except OSError as e:
            raise errors.InternalError(
                f"zprted: daemon connection lost mid-job: {e}") from e

    def respawn(self, job_id: str, ranks: list[int],
                timeout: float = 30.0) -> list[int]:
        return self._call(["respawn", str(job_id),
                           [int(r) for r in ranks]], wait=timeout)

    def resize(self, job_id: str, n: int,
               timeout: float = 30.0) -> dict:
        """Elastic resize of a running ft job: grow spawns fresh ranks
        that FT_JOIN the live job, shrink retires the highest live
        ranks through the orderly-BYE path.  Returns the applied
        event (grown/retired ranks, event seq, store generation)."""
        return self._call(["resize", str(job_id), int(n)],
                          wait=timeout)

    def treeinfo(self) -> dict:
        """This daemon's tree coordinates: id, store address, depth,
        whether it is the root, and (at the root) the placement-order
        daemon list."""
        return self._call(["treeinfo"])

    def pids(self, job_id: str) -> dict[int, int]:
        return {int(r): int(p)
                for r, p in self._call(["pids", str(job_id)]).items()}

    def stat(self) -> dict:
        return self._call(["stat"])

    def metrics(self, job_id: str, rank: int | None = None,
                timeout: float = 10.0) -> dict:
        """Fleet-visible metrics: one rank's published snapshot, or the
        whole job's per-rank + aggregated view (staleness-stamped)."""
        req: list = ["metrics", str(job_id)]
        if rank is not None:
            req.append(int(rank))
        return self._call(req, wait=timeout)

    def ping(self) -> bool:
        return self._call(["ping"]) == "pong"

    def stop(self) -> bool:
        return bool(self._call(["stop"]))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def main(args: list[str] | None = None) -> int:
    """The ``zprted`` CLI: start a daemon, announce its ports, run until
    signalled or stopped by RPC."""
    ap = argparse.ArgumentParser(
        prog="zprted",
        description="Persistent runtime daemon (PRRTE/DVM analog): "
                    "hosts the PMIx store, launches zmpirun --dvm jobs, "
                    "watches children, floods fault events, respawns "
                    "ranks.",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="control (RPC) port; 0 = ephemeral")
    ap.add_argument("--pmix-port", type=int, default=0,
                    help="PMIx store port; 0 = ephemeral")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="bind the HTTP GET /metrics scrape endpoint "
                         "(Prometheus text exposition) on this port; "
                         "0 = ephemeral; off by default")
    ap.add_argument("--parent", default=None, metavar="HOST:PORT",
                    help="attach this daemon as a CHILD of an existing "
                         "zprted (its control port): store verbs route "
                         "up the tree, launch/fault/invalidation "
                         "traffic rides the persistent link — one "
                         "zprted per host, ranks talk to theirs")
    ns = ap.parse_args(args)
    dvm = Dvm(ns.host, ns.port, ns.pmix_port,
              metrics_port=ns.metrics_port, parent=ns.parent)
    extra = ""
    if dvm.metrics_http is not None:
        extra = (f" metrics={dvm.host}:"
                 f"{dvm.metrics_http.address[1]}")
    if ns.parent:
        extra += f" parent={ns.parent} depth={dvm.tree_depth}"
    print(f"zprted ready dvm={dvm.host}:{dvm.address[1]} "
          f"pmix={dvm.host}:{dvm.pmix.address[1]}{extra}", flush=True)

    def on_signal(signum, _frame):
        dvm.stop()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    dvm.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
