"""Dynamic process management over the wire plane — multi-process dpm
(namesake: ``zhpe_ompi_tpu/comm/dpm_wire.py``).

The reference's dpm launches and connects REAL processes through PMIx
(``ompi/dpm/dpm.c:774`` spawns via PMIx_Spawn; connect/accept rendezvous
through published port names).  This module's dpm is real in the same
sense:

- **ports** are live rendezvous sockets; their name is ``host:port``
  (the reference's port name is likewise a PMIx-routable address string).
- **connect/accept** bridge two *independent TcpProc groups* — possibly
  in different OS processes — by exchanging address books through the
  port and minting a bridge CID; data then flows directly between group
  members over lazily-established bridge connections
  (:meth:`~zhpe_ompi_tpu_torch.pt2pt.tcp.TcpProc.bridge_send`).
- **spawn** forks genuine child processes (``multiprocessing``), wires
  them into their own TcpProc universe, and connects the two universes
  with an intercommunicator — the MPI_Comm_spawn shape: parent group ↔
  child group, children find the bridge via :func:`child_parent` (the
  MPI_Comm_get_parent analog).

Intercomm collectives come from
:class:`~zhpe_ompi_tpu_torch.coll.inter.InterCollectives` — the same
coll/inter composition the thread-plane bridge uses.

The rendezvous frames (address books, the bridge cid) and the bridge's
data frames are the namesake's, so a port group connects to a JAX-package
group.  ``spawn`` keeps the namesake's default ``method="spawn"``: a child
forked from a process that has touched CUDA cannot use the card, and a
fresh interpreter re-imports torch (seconds per child).
"""

from __future__ import annotations

import multiprocessing as mp
import secrets
import socket
from typing import Any, Callable

from ..coll.inter import InterCollectives
from ..core import errors
from ..pt2pt.matching import ANY_SOURCE, ANY_TAG
from ..pt2pt.tcp import TcpProc, _recv_frame, _send_frame
from ..utils import dss

# Bridge CIDs live far above intra-group cids; random high bits make
# independent accepting groups collision-free without negotiation.
_BRIDGE_CID_BASE = 0x40000


def _new_bridge_cid() -> int:
    return _BRIDGE_CID_BASE + secrets.randbits(40)


class Port:
    """An open MPI port: a live rendezvous listener (MPI_Open_port)."""

    def __init__(self, host: str = "127.0.0.1"):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(8)
        addr = self._srv.getsockname()
        self.name = f"{addr[0]}:{addr[1]}"

    def close(self) -> None:
        """MPI_Close_port."""
        try:
            self._srv.close()
        except OSError:
            pass


def open_port(host: str = "127.0.0.1") -> Port:
    """MPI_Open_port: mint a connectable rendezvous name."""
    return Port(host)


# -- name publishing (MPI_Publish_name / Lookup_name / Unpublish_name) ----
#
# The reference routes these through a PMIx server that outlasts any one
# rank (the separate ``ompi-server`` daemon).  A launcher hosts that
# registry and exports its address as ZMPI_NAMESERVER (``tools/mpirun.py``
# does, as the namesake's zmpirun does); without one there is no server
# and these raise.

def _name_server_request(req: list) -> Any:
    import os

    addr = os.environ.get("ZMPI_NAMESERVER")
    if not addr:
        raise errors.InternalError(
            "MPI name publishing needs a name server: run under zmpirun "
            "(which hosts one) or unset service names and exchange port "
            "names out of band"
        )
    host, port = addr.rsplit(":", 1)
    cli = socket.create_connection((host, int(port)), timeout=10.0)
    try:
        _send_frame(cli, dss.pack(req))
        [out] = dss.unpack(_recv_frame(cli))
        return out
    finally:
        cli.close()


def publish_name(service: str, port_name: str) -> None:
    """MPI_Publish_name: service -> port name, visible to every rank of
    the job (and to other jobs launched with the same name server)."""
    _name_server_request(["pub", service, port_name])


def lookup_name(service: str) -> str:
    """MPI_Lookup_name; raises if the service is not published."""
    out = _name_server_request(["look", service])
    if out is None:
        raise errors.ArgError(f"service {service!r} is not published")
    return out


def unpublish_name(service: str) -> None:
    """MPI_Unpublish_name; raises (MPI_ERR_SERVICE shape) when the
    service was never published — matching lookup_name."""
    if not _name_server_request(["unpub", service]):
        raise errors.ArgError(f"service {service!r} is not published")


class TcpIntercomm(InterCollectives):
    """Intercommunicator between two TcpProc groups (possibly in
    different OS processes).  MPI addressing: send/recv name ranks of the
    REMOTE group; the bridge cid isolates matching from in-group
    traffic."""

    def __init__(self, proc: TcpProc, remote_book: list[tuple[str, int]],
                 cid: int, info=None):
        from ..core import info as info_mod

        self._ctx = proc
        self._proc = proc
        self._remote_book = [tuple(a) for a in remote_book]
        self.cid = cid
        self.info = info_mod.coerce(info)

    @property
    def rank(self) -> int:
        return self._proc.rank

    @property
    def size(self) -> int:
        """Local group size."""
        return self._proc.size

    @property
    def remote_size(self) -> int:
        return len(self._remote_book)

    def send(self, obj: Any, dest: int, tag: int = 0) -> None:
        if not 0 <= dest < self.remote_size:
            raise errors.RankError(f"remote rank {dest} out of range")
        self._proc.bridge_send(
            obj, self.cid, dest, self._remote_book[dest], tag
        )

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             timeout: float | None = None) -> Any:
        return self._proc.recv(source, tag, cid=self.cid, timeout=timeout)

    def disconnect(self) -> None:
        """MPI_Comm_disconnect: quiesce (collective over the local
        group)."""
        self._proc.barrier()


def accept(port: Port | None, proc: TcpProc,
           timeout: float = 30.0) -> TcpIntercomm:
    """MPI_Comm_accept — collective over `proc`'s group; rank 0 owns the
    port (others pass None) and blocks until a connector arrives."""
    if proc.rank == 0:
        if port is None:
            raise errors.ArgError("accept: rank 0 must pass the open port")
        port._srv.settimeout(timeout)
        conn, _ = port._srv.accept()
        [remote_book] = dss.unpack(_recv_frame(conn))
        cid = _new_bridge_cid()
        _send_frame(conn, dss.pack([list(a) for a in proc.address_book],
                                   cid))
        conn.close()
        payload = (remote_book, cid)
    else:
        payload = None
    remote_book, cid = proc.bcast(payload, root=0)
    return TcpIntercomm(proc, remote_book, cid)


def connect(name: str, proc: TcpProc,
            timeout: float = 30.0) -> TcpIntercomm:
    """MPI_Comm_connect — collective over `proc`'s group; rank 0
    rendezvouses with the port owner."""
    if proc.rank == 0:
        host, port_no = name.rsplit(":", 1)
        cli = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        cli.settimeout(timeout)
        import time

        err = None
        for _ in range(200):  # the acceptor may not be listening yet
            try:
                cli.connect((host, int(port_no)))
                break
            except OSError as e:
                err = e
                time.sleep(0.05)
                cli.close()
                cli = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                cli.settimeout(timeout)
        else:
            raise errors.InternalError(
                f"connect: cannot reach port {name}: {err}"
            )
        _send_frame(cli, dss.pack([list(a) for a in proc.address_book]))
        [remote_book, cid] = dss.unpack(_recv_frame(cli))
        cli.close()
        payload = (remote_book, cid)
    else:
        payload = None
    remote_book, cid = proc.bcast(payload, root=0)
    return TcpIntercomm(proc, remote_book, cid)


# ---------------------------------------------------------------- spawn

def _free_port_addr(host: str = "127.0.0.1") -> tuple[str, int]:
    """Reserve an ephemeral port number for the child universe's modex
    coordinator (the launcher-assigns-the-PMIx-URI step)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind((host, 0))
    addr = s.getsockname()
    s.close()
    return addr


def _child_bootstrap(rank: int, n: int, coord_addr, parent_port: str,
                     target: Callable) -> None:
    """Entry point of a spawned child process: build the child universe,
    connect back to the parent's port, run the user main."""
    proc = TcpProc(rank, n, coordinator=tuple(coord_addr))
    try:
        parent = connect(parent_port, proc)
        target(proc, parent)
    finally:
        proc.close()


class SpawnHandle:
    """Owner of the spawned processes (the reference's children outlive
    the call under prte's supervision; here the parent supervises)."""

    def __init__(self, procs: list[mp.Process]):
        self._procs = procs

    def join(self, timeout: float = 60.0) -> None:
        """Wait for every child to exit; raises if any failed."""
        for p in self._procs:
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                raise errors.InternalError("spawned child hung")
        bad = [p.exitcode for p in self._procs if p.exitcode != 0]
        if bad:
            raise errors.InternalError(
                f"spawned children exited nonzero: {bad}"
            )


def spawn(proc: TcpProc, target: Callable, n_children: int,
          timeout: float = 30.0, info=None, method: str = "spawn"
          ) -> tuple[TcpIntercomm, SpawnHandle]:
    """MPI_Comm_spawn over real processes — collective over the parent
    group.  Launches `n_children` OS processes running
    ``target(child_proc, parent_intercomm)``, wires them into their own
    TcpProc universe, and returns the parent↔child intercommunicator plus
    a supervision handle.

    ``method="spawn"`` (default) execs fresh interpreters — the same
    contract as a launcher — so it is safe in a parent that has touched
    CUDA (a forked child of such a parent cannot use the card); the
    target must be a picklable module-level function.  ``method="fork"``
    is opt-in for fork-safe callers that need closure targets: forking a
    multithreaded process is a latent deadlock, so opting in warns."""
    if method == "fork":
        import warnings

        warnings.warn(
            "dpm_wire.spawn(method='fork') can deadlock children when the "
            "parent holds locks in background threads, and a forked child "
            "of a process that initialized CUDA cannot use the card; "
            "prefer the default method='spawn'",
            RuntimeWarning, stacklevel=2,
        )
    ctx = mp.get_context(method)
    if proc.rank == 0:
        port = open_port()
        coord_addr = _free_port_addr()
        procs = [
            ctx.Process(
                target=_child_bootstrap,
                args=(r, n_children, coord_addr, port.name, target),
                daemon=True,
            )
            for r in range(n_children)
        ]
        for p in procs:
            p.start()
        handle = SpawnHandle(procs)
    else:
        port = None
        handle = SpawnHandle([])
    icomm = accept(port, proc, timeout=timeout)
    if port is not None:
        port.close()
    from ..core import info as info_mod

    icomm.info = info_mod.coerce(info)  # launch hints (PMIx_Spawn analog)
    return icomm, handle
