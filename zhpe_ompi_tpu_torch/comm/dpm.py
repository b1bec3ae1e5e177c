"""Dynamic process management — spawn / connect / accept / intercomms
(namesake: ``zhpe_ompi_tpu/comm/dpm.py``).

Re-design of ``ompi/dpm`` (SURVEY.md §2.3, 1.9k LoC): the reference
implements MPI_Comm_spawn and MPI_Comm_connect/accept over PMIx — publish a
port name, rendezvous out-of-band, allocate a bridge CID, wire the two
process groups into an inter-communicator.  The host-plane analog keeps
exactly that shape with the thread-rank universe playing the process group:

- ports are names in a process-global registry (the PMIx publish/lookup
  plane);
- an inter-communicator is a reserved CID plus direct handles to the remote
  group's matching engines — sends enqueue into the remote rank's mailbox
  with the bridge CID, receives match on it locally (the same envelope
  protocol as intra-universe pt2pt);
- ``spawn`` builds a fresh child universe, runs the child main on its rank
  threads, and hands both sides the bridge (children reach it via
  :func:`get_parent`, the MPI_Comm_get_parent analog).

On the device plane, "spawning" means constructing a new process group
over more GPUs — a launcher operation, not a program-level one; the host
plane is where MPI's dynamic semantics live, mirroring how the reference
funnels all of dpm through the out-of-band PMIx plane rather than the
BTLs.  The thread plane's wire is its mailboxes, so objects cross the
bridge as the port's intra-universe pt2pt carries them (numpy arrays and
CPU tensors alike, copied at send).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable

from ..coll.inter import InterCollectives
from ..core import errors
from ..pt2pt.matching import ANY_SOURCE, ANY_TAG, Envelope
from ..pt2pt.universe import _EAGER, LocalUniverse, RankContext, _eager_copy

# bridge CIDs live above any intra-universe cid; process-global so any two
# universes in the process agree without negotiation (the reference runs a
# CID allocation protocol over the bridge — ompi_comm_nextcid)
_BRIDGE_CID_BASE = 0x40000
_bridge_cids = itertools.count(_BRIDGE_CID_BASE)
_registry_lock = threading.Lock()

# PMIx publish/lookup analog: port name -> rendezvous state
_ports: dict[str, dict[str, Any]] = {}
_port_names = itertools.count()

# The parent bridge and the collective-slot state hang off the universe
# OBJECT (attributes), not an id()-keyed global dict: id() values are
# reused after garbage collection, which would hand a fresh universe a
# stale parent, and a global registry would pin universes forever.
_PARENT_ATTR = "_zmpi_dpm_parent"
_SLOT_ATTR = "_zmpi_dpm_slots"


class Intercomm(InterCollectives):
    """Per-rank handle to an inter-communicator: a local group and a remote
    group bridged by a dedicated CID (cf. ompi_intercomm_create).
    Collectives across the bridge come from
    :class:`~zhpe_ompi_tpu_torch.coll.inter.InterCollectives` (the coll/inter
    composition)."""

    def __init__(self, ctx: RankContext, remote: LocalUniverse, cid: int,
                 info=None):
        from ..core import info as info_mod

        self._ctx = ctx
        self._remote = remote
        self.cid = cid
        self._seq = itertools.count()
        self.info = info_mod.coerce(info)

    @property
    def rank(self) -> int:
        return self._ctx.rank

    @property
    def size(self) -> int:
        """Local group size."""
        return self._ctx.size

    @property
    def remote_size(self) -> int:
        return self._remote.size

    def send(self, obj: Any, dest: int, tag: int = 0) -> None:
        """Send to rank `dest` OF THE REMOTE GROUP (MPI intercomm
        semantics: ranks always address the other side).  Delivery is
        eager into the remote mailbox — the bridge is the DCN/out-of-band
        analog, not the high-volume data plane."""
        if not 0 <= dest < self._remote.size:
            raise errors.RankError(f"remote rank {dest} out of range")
        env = Envelope(self._ctx.rank, tag, self.cid, next(self._seq))
        self._remote.contexts[dest].mailbox.put(
            (_EAGER, env, _eager_copy(obj), None)  # no trace context
        )

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Any:
        """Receive from the remote group on the bridge CID."""
        return self._ctx.recv(source=source, tag=tag, cid=self.cid)

    def disconnect(self) -> None:
        """MPI_Comm_disconnect: quiesce the bridge (collective over the
        local group)."""
        self._ctx.barrier()


def _collective_slot(uni: LocalUniverse, ctx: RankContext,
                     build: Callable[[], Any]) -> Any:
    """Rank 0 runs `build`, every rank returns its value — the analog of
    the reference resolving dpm state over a PMIx fence.  If `build`
    raises on rank 0, the other ranks will block until the universe's run
    timeout (the same hang an un-matched MPI_Comm_accept produces)."""
    with _registry_lock:
        slots = getattr(uni, _SLOT_ATTR, None)
        if slots is None:
            slots = {"seq": itertools.count(), "values": {}}
            setattr(uni, _SLOT_ATTR, slots)
    if ctx.rank == 0:
        value = build()
        with _registry_lock:
            key = next(slots["seq"])
            slots["values"][key] = value
        for r in range(1, ctx.size):
            ctx.send(key, dest=r, tag=0x3FE, cid=0x3FE)
    else:
        key = ctx.recv(source=0, tag=0x3FE, cid=0x3FE)
        with _registry_lock:
            value = slots["values"][key]
    ctx.barrier()
    if ctx.rank == 0:
        with _registry_lock:
            slots["values"].pop(key, None)
    return value


def spawn(uni: LocalUniverse, ctx: RankContext, child_main: Callable,
          n_children: int, timeout: float = 60.0, info=None):
    """MPI_Comm_spawn analog — collective over the parent universe.
    Accepts an MPI_Info of launch hints (stored on the intercomm; the
    reference forwards these to PMIx_Spawn).

    Creates a fresh `n_children`-rank universe, starts
    ``child_main(child_ctx)`` on each rank thread, and returns
    ``(intercomm, handle)``: `intercomm` bridges parent→children;
    ``handle.join()`` collects the children's return values (the reference
    has no join — processes outlive the call — but threads need an owner).
    Children reach the parent bridge via :func:`get_parent`."""

    def build():
        child = LocalUniverse(n_children)
        cid = next(_bridge_cids)
        setattr(child, _PARENT_ATTR, (uni, cid))

        results: list[Any] = [None] * n_children
        excs: list[BaseException | None] = [None] * n_children

        def runner(r):
            try:
                results[r] = child_main(child.contexts[r])
            except BaseException as e:  # noqa: BLE001 - surfaced in join
                excs[r] = e

        threads = [
            threading.Thread(target=runner, args=(r,), daemon=True)
            for r in range(n_children)
        ]
        for t in threads:
            t.start()

        class Handle:
            def join(self, to: float = timeout):
                for t in threads:
                    t.join(to)
                    if t.is_alive():
                        raise errors.InternalError("spawned children hung")
                for e in excs:
                    if e is not None:
                        raise e
                return results

        return (child, cid, Handle())

    child, cid, handle = _collective_slot(uni, ctx, build)
    return Intercomm(ctx, child, cid, info=info), handle


def get_parent(child_ctx: RankContext) -> Intercomm | None:
    """MPI_Comm_get_parent: the bridge to the universe that spawned this
    one, or None for a root universe.  Returns the SAME communicator
    object on every call (the MPI contract) — a fresh handle per call
    would reset the inter-collective sequence tags and deadlock the
    second collective against the parent's persistent handle."""
    cached = getattr(child_ctx, "_zmpi_parent_icomm", None)
    if cached is not None:
        return cached
    entry = getattr(child_ctx.universe, _PARENT_ATTR, None)
    if entry is None:
        return None
    parent_uni, cid = entry
    icomm = Intercomm(child_ctx, parent_uni, cid)
    child_ctx._zmpi_parent_icomm = icomm
    return icomm


def open_port() -> str:
    """MPI_Open_port: mint a connectable name (PMIx publish analog)."""
    name = f"zmpi-port-{next(_port_names)}"
    with _registry_lock:
        _ports[name] = {"accept_ready": threading.Event(), "accept": None,
                        "bridge": None, "done": threading.Event()}
    return name


def close_port(name: str) -> None:
    with _registry_lock:
        _ports.pop(name, None)


def _port(name: str) -> dict[str, Any]:
    with _registry_lock:
        port = _ports.get(name)
    if port is None:
        raise errors.ArgError(f"unknown port {name!r}")
    return port


def accept(name: str, uni: LocalUniverse, ctx: RankContext,
           timeout: float = 30.0) -> Intercomm:
    """MPI_Comm_accept — collective over the accepting universe; blocks
    until a connector arrives on the port."""

    def build():
        port = _port(name)
        port["accept"] = uni
        port["accept_ready"].set()
        if not port["done"].wait(timeout):
            raise errors.InternalError(f"accept on {name!r} timed out")
        return port["bridge"]  # (connector_uni, cid)

    remote, cid = _collective_slot(uni, ctx, build)
    return Intercomm(ctx, remote, cid)


def connect(name: str, uni: LocalUniverse, ctx: RankContext,
            timeout: float = 30.0) -> Intercomm:
    """MPI_Comm_connect — collective over the connecting universe; blocks
    until the port's owner calls accept."""

    def build():
        port = _port(name)
        if not port["accept_ready"].wait(timeout):
            raise errors.InternalError(f"no accept on {name!r}")
        cid = next(_bridge_cids)
        port["bridge"] = (uni, cid)
        accept_uni = port["accept"]
        port["done"].set()
        return (accept_uni, cid)

    remote, cid = _collective_slot(uni, ctx, build)
    return Intercomm(ctx, remote, cid)
