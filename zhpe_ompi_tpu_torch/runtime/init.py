"""Runtime init/finalize (namesake: ``zhpe_ompi_tpu/runtime/init.py``).

The reference's init sequence (``ompi/runtime/ompi_mpi_init.c:384``) is:
OPAL init → RTE/PMIx wire-up → open frameworks → select PML → modex →
build COMM_WORLD → add_procs → coll select.  With one process per GPU it
collapses to:

    init() → [adopt the caller's process group | join from torchrun's
           environment | a one-rank world on an in-process store]
           → COMM_WORLD, COMM_SELF, the world mesh → init hooks

``torch.distributed``'s store is the modex; per-communicator coll selection
is lazy, and so is NCCL's communicator creation (no group is bound to a
device), so ``init`` costs one process group and one one-rank group.

The host plane (launcher-started multi-process jobs) has its own entry:
:func:`host_init` reads the ``ZMPI_*`` coordinator contract and wires the
process into a ``pt2pt/tcp.TcpProc`` universe (``host_world``,
``host_finalize``).  ``ZMPI_PMIX`` (a daemon-hosted job) modexes through
the daemon's PMIx store instead (``runtime/pmix.py``), ``ZMPI_FT=1``
builds the endpoint with fault tolerance on (``ft/ulfm.py``), and
``ZMPI_LIFELINE`` (``_arm_lifeline``) ends a daemon-hosted rank when its
daemon dies.  The ``sm`` MCA var keeps
its default (1): ranks on one host exchange their frames through the
shared-memory rings of ``pt2pt/sm.py``, and ``ZMPI_MCA_sm=0`` puts every
pair on TCP.
"""

from __future__ import annotations

import os
import threading
import time

import torch
import torch.distributed as dist
import torch.distributed.distributed_c10d as c10d

from ..comm import communicator as comm_mod
from ..comm.communicator import Communicator
from ..comm.group import Group
from ..core import errors
from ..ft import ulfm
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..parallel import mesh as mesh_mod
from . import spc

_stream = mca_output.open_stream("runtime")

_global = {
    "initialized": False,
    "finalized": False,
    "world": None,
    "self": None,
    "mesh": None,
    "init_time": None,
    "created_pg": False,
    "watcher": None,
}
_lock = threading.Lock()
_inits = [0]


def initialized() -> bool:
    return _global["initialized"]


def _backend_of(device) -> str:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise errors.ArgError(f"unsupported device {device!r}")


def _env_world_size() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def _join_from_env(distributed: bool | None) -> bool:
    """Whether :func:`init` joins from torchrun's environment contract:
    ``distributed``, else the ``rte_distributed_init`` var where it was
    set, else whether the environment names a world of more than one
    rank.  A one-rank world under such an environment would train alone
    without a word, so that combination raises."""
    if distributed is None:
        var = mca_var.lookup("rte_distributed_init")
        if var is not None and var.source != mca_var.VarSource.DEFAULT:
            distributed = bool(var.value)
        else:
            distributed = _env_world_size() > 1
    if not distributed and _env_world_size() > 1:
        raise errors.ArgError(
            f"WORLD_SIZE={_env_world_size()} names a multi-rank job, but init "
            "was told not to join it (distributed=False or "
            "rte_distributed_init=0): unset WORLD_SIZE for a one-rank world")
    return bool(distributed)


def init(device=None, axis_name: str = "world",
         distributed: bool | None = None) -> Communicator:
    """MPI_Init analog; returns COMM_WORLD.  Idempotent.

    A process group the caller already made is adopted as the world.
    Otherwise one is made: from torchrun's environment contract when
    ``distributed`` (default: the ``rte_distributed_init`` var if set,
    else whether ``WORLD_SIZE`` in the environment exceeds 1), else a
    one-rank world on an in-process store; a multi-rank ``WORLD_SIZE``
    with ``distributed`` false raises.  ``device`` (default CUDA, which
    must exist; ``"cpu"`` for gloo) picks the backend of a group made
    here; with CUDA, ``torch.cuda.set_device(LOCAL_RANK)`` runs first."""
    with _lock:
        if _global["initialized"]:
            return _global["world"]
        t0 = time.perf_counter()
        created = False
        if not dist.is_initialized():
            backend = _backend_of(device)
            distributed = _join_from_env(distributed)
            if backend == "nccl":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            if distributed:
                mesh_mod.distributed_initialize(backend)
            else:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
            created = True
        try:
            world = Communicator(name="MPI_COMM_WORLD")
            # COMM_SELF: this rank alone, on a group of its own; the
            # partition holds every rank's (the btl/self analog)
            _inits[0] += 1
            me = dist.get_rank()
            self_pg = comm_mod.new_group(f"zmpi_self.{me}.{_inits[0]}", [me],
                                         world.backend)
            self_comm = Communicator(
                self_pg, name="MPI_COMM_SELF",
                partition=[Group([i]) for i in range(world.size)])
            m = mesh_mod.world_mesh(axis_name=axis_name)
            watcher = None
            if world.size > 1:
                watcher = ulfm.RevocationWatcher(c10d._get_default_store())
        except BaseException:
            if created:
                dist.destroy_process_group()
            raise
        _global.update(
            initialized=True, finalized=False, world=world, self=self_comm,
            mesh=m, init_time=time.perf_counter() - t0, created_pg=created,
            watcher=watcher,
        )
        spc.record("init_count", 1)
        mca_output.verbose(
            1, _stream, "initialized: rank %d of %d on %s, %.1fms",
            world.rank, world.size, world.backend, _global["init_time"] * 1e3,
        )
    # hook interposition, bottom of init (ompi/mca/hook semantics) — outside
    # the lock so a hook may call back into the (idempotent) runtime API
    from ..hook import run_init_hooks

    run_init_hooks(world)
    return world


def world() -> Communicator:
    if not _global["initialized"]:
        raise errors.NotInitializedError()
    return _global["world"]


def comm_self() -> Communicator:
    if not _global["initialized"]:
        raise errors.NotInitializedError()
    return _global["self"]


def world_mesh():
    if not _global["initialized"]:
        raise errors.NotInitializedError()
    return _global["mesh"]


def finalize() -> None:
    """MPI_Finalize analog: the finalize hooks, then the revocation
    watcher stops, and the process group goes if :func:`init` made it
    (a group the caller made stays, less init's COMM_SELF group)."""
    from ..hook import run_finalize_hooks

    run_finalize_hooks()
    with _lock:
        if _global["watcher"] is not None:
            _global["watcher"].stop()
        if _global["initialized"] and dist.is_initialized():
            if _global["created_pg"]:
                dist.destroy_process_group()
            else:
                dist.destroy_process_group(_global["self"].pg)
            comm_mod.forget_destroyed()
        _global.update(
            initialized=False, finalized=True, world=None, self=None,
            mesh=None, created_pg=False, watcher=None,
        )


def is_finalized() -> bool:
    return _global["finalized"]


# -- host plane (launcher-started multi-process jobs) ----------------------

_host = {"proc": None}
_host_lock = threading.Lock()


def host_init(timeout: float = 30.0):
    """Wire this process into a launcher-started host-plane universe.

    Reads the ``ZMPI_RANK``/``ZMPI_SIZE``/``ZMPI_COORD_HOST``/
    ``ZMPI_COORD_PORT`` environment contract (``ZMPI_COORD_EXTERNAL=1``:
    the launcher hosts the rendezvous, so rank 0 joins it as a client) —
    the one ``tools/mpirun.py`` exports — and performs the TcpProc
    modex, mirroring the reference's ``ompi_rte_init`` → PMIx_Init
    connect step (``ompi_mpi_init.c:508``).  A daemon-hosted rank reads
    ``ZMPI_PMIX=host:port/namespace`` instead (the resident daemon,
    ``runtime/dvm.py``, exports it) and modexes through the daemon's
    store; ``ZMPI_REJOIN``/``ZMPI_REJOIN_GEN``/``ZMPI_REJOIN_RANKS`` make
    it a respawned replacement, ``ZMPI_ELASTIC_LIVE`` an elastic job's
    live slots, and ``ZMPI_LIFELINE`` ends the process when the daemon
    dies.  A missing or malformed variable raises
    ``NotInitializedError``.  Idempotent; returns this process's
    :class:`~zhpe_ompi_tpu_torch.pt2pt.tcp.TcpProc` endpoint.
    ``ZMPI_FT=1`` builds it with ``ft=True`` (the ULFM surface: failure
    ack, agree, shrink, revoke); the ``sm`` MCA var (default 1:
    same-host ranks ride the shared-memory rings) applies as to any
    ``TcpProc``.
    """
    with _host_lock:
        if _host["proc"] is not None:
            return _host["proc"]
        pmix_uri = os.environ.get("ZMPI_PMIX")
        try:
            rank = int(os.environ["ZMPI_RANK"])
            size = int(os.environ["ZMPI_SIZE"])
            if pmix_uri is None:
                chost = os.environ["ZMPI_COORD_HOST"]
                cport = int(os.environ["ZMPI_COORD_PORT"])
        except (KeyError, ValueError) as e:
            raise errors.NotInitializedError(
                f"host_init: bad ZMPI_* contract ({e}) — export "
                "ZMPI_RANK/SIZE/COORD_HOST/COORD_PORT (or ZMPI_PMIX for "
                "a daemon-hosted job)"
            ) from None
        from ..pt2pt.tcp import TcpProc

        # ZMPI_FT=1: the endpoint carries the ULFM machinery (failure
        # state, ring detector, typed failure delivery); a daemon-hosted
        # ft job needs it for the daemon's fault events to land in
        ft = os.environ.get("ZMPI_FT") == "1"
        t0 = time.perf_counter()
        if pmix_uri is not None:
            # PMIx-served wire-up (the daemon hosts the store): ZMPI_PMIX
            # is "host:port/namespace"; a respawned replacement
            # additionally carries ZMPI_REJOIN=1 and re-modexes through
            # the store
            if "/" not in pmix_uri or ":" not in pmix_uri.split("/")[0]:
                raise errors.NotInitializedError(
                    f"host_init: malformed ZMPI_PMIX {pmix_uri!r} — "
                    "expected host:port/namespace (zprted exports this)"
                )
            addr, ns = pmix_uri.rsplit("/", 1)
            rejoin_ranks = os.environ.get("ZMPI_REJOIN_RANKS", "")
            elastic_live = os.environ.get("ZMPI_ELASTIC_LIVE", "")
            proc = TcpProc(
                rank, size, pmix=addr, namespace=ns, timeout=timeout,
                ft=ft, rejoin=os.environ.get("ZMPI_REJOIN") == "1",
                rejoin_gen=int(os.environ.get("ZMPI_REJOIN_GEN", 0)),
                rejoin_ranks=[int(r) for r in rejoin_ranks.split(",")
                              if r],
                # elastic jobs: only the live slots started (the rest
                # wire up as pre-acknowledged departures a later grow
                # restores) — the DVM resize contract
                live_ranks=[int(r) for r in elastic_live.split(",")
                            if r] or None,
            )
            lifeline = os.environ.get("ZMPI_LIFELINE")
            if lifeline:
                _arm_lifeline(lifeline)
            # warm the tuned decision-table cache from the daemon's
            # store (coll/ztable.py; negative-cached, never raises), so
            # the first collective pays no fetch
            from ..coll import ztable

            ztable.prefetch()
        else:
            proc = TcpProc(
                rank, size, coordinator=(chost, cport), timeout=timeout,
                ft=ft,
                external_coordinator=os.environ.get(
                    "ZMPI_COORD_EXTERNAL") == "1",
            )
        _host["proc"] = proc
        spc.record("init_count", 1)
        mca_output.verbose(
            1, _stream, "host plane up: rank %d/%d in %.1fms", rank, size,
            (time.perf_counter() - t0) * 1e3,
        )
        return proc


def _arm_lifeline(address: str) -> None:
    """Park one connection on the host daemon's control port for this
    process's whole life (the ``ZMPI_LIFELINE`` contract): the daemon
    never replies, and the connection dying means the daemon died —
    a rank must not outlive the daemon that owns its store, its fault
    routing, and its exit accounting (the PRRTE local-procs-die-with-
    their-prted contract, made explicit).  Exit code 143 mirrors the
    SIGTERM teardown the daemon itself would have applied."""
    import socket
    import sys

    from ..pt2pt.tcp import _recv_frame, _send_frame
    from ..utils import dss

    host, port = address.rsplit(":", 1)
    try:
        sock = socket.create_connection((host, int(port)), 10.0)
        _send_frame(sock, dss.pack(["lifeline"]))
        sock.settimeout(None)
    except OSError:
        # the daemon is already gone: the modex above only succeeded
        # against a live store, so this is a teardown race — exit the
        # way the severed lifeline would have made us
        os._exit(143)

    def watch():
        try:
            while True:
                if _recv_frame(sock) is None:
                    break
        except OSError:
            pass
        try:
            sys.stderr.write(
                "zmpi: host daemon lifeline severed — exiting\n")
            sys.stderr.flush()
        except OSError:
            # stderr IS the daemon's IOF pipe: a dead daemon broke it
            # too, and the farewell must never outrank the exit
            pass
        os._exit(143)

    t = threading.Thread(target=watch, daemon=True,
                         name="zmpi-lifeline")
    t.start()
    _host["lifeline"] = (sock, t)


def host_world():
    """The TcpProc endpoint created by :func:`host_init` (or None)."""
    return _host["proc"]


def host_finalize() -> None:
    with _host_lock:
        proc, _host["proc"] = _host["proc"], None
        if proc is not None:
            proc.close()
