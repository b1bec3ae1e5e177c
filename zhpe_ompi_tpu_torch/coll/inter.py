"""Intercommunicator collectives — coll/inter analog (namesake:
``zhpe_ompi_tpu/coll/inter.py``; the port's own copy).

The reference composes a dedicated module for every intercommunicator
(``ompi/mca/coll/inter/coll_inter.c:124-129``); its algorithms all share
one shape: *intra*-collective to the local leader, a leader↔leader
exchange across the bridge, *intra*-broadcast of the remote result.  This
mixin is that composition over any intercomm exposing

- ``rank`` / ``size`` (local group), ``remote_size``
- ``send(obj, dest, tag)`` / ``recv(source, tag)`` addressing the REMOTE
  group (MPI intercomm semantics)
- ``_ctx`` — the local-group endpoint with the
  :class:`~zhpe_ompi_tpu_torch.coll.host.HostCollectives` surface

so it works identically for thread-bridge and wire intercomms (the
namesake's ``comm/dpm.Intercomm`` and ``comm/dpm_wire.TcpIntercomm``,
which the port builds with ``comm/dpm.py``, ROADMAP queue A item 5; any
object with that surface works now).

Rooted operations follow MPI's intercomm addressing: ranks in the root's
group pass ``root=ROOT`` (the root itself) or ``root=PROC_NULL`` (its
peers); ranks in the other group pass the root's rank within the remote
group — exactly MPI_ROOT / MPI_PROC_NULL (mpi.h semantics).
"""

from __future__ import annotations

from typing import Any

from ..core import errors

# MPI_ROOT / MPI_PROC_NULL sentinels (distinct from ANY_SOURCE == -1)
ROOT = -3
PROC_NULL = -2

# Tag space for inter-collective traffic on the bridge cid (leader
# exchanges); instance-sequenced like coll/host's _next_tag.
_TAG_INTER = 0x7D00


class InterCollectives:
    """Mixin: the MPI intercommunicator collective surface."""

    def _inter_tag(self) -> int:
        """Same program order on every rank of BOTH groups (MPI collective
        call-order rule), so overlapping inter collectives cannot
        cross-match on the bridge."""
        seq = getattr(self, "_inter_coll_seq", 0)
        self._inter_coll_seq = seq + 1
        return ((seq % 0x8000) << 16) | _TAG_INTER

    # -- barrier ----------------------------------------------------------

    def barrier(self) -> None:
        """Inter-group barrier: local barriers bracketing a leader↔leader
        exchange (coll_inter's shape)."""
        tag = self._inter_tag()
        self._ctx.barrier()
        if self.rank == 0:
            self.send(b"", 0, tag=tag)
            self.recv(source=0, tag=tag)
        self._ctx.barrier()

    # -- bcast ------------------------------------------------------------

    def bcast(self, obj: Any = None, root: int = PROC_NULL) -> Any:
        """Intercomm broadcast: data moves from the root (one group) to
        every rank of the OTHER group.  Returns the payload in the
        receiving group; returns `obj` unchanged in the root's group."""
        tag = self._inter_tag()
        if root == ROOT:
            self.send(obj, 0, tag=tag)  # to the remote leader
            return obj
        if root == PROC_NULL:
            return obj
        if not 0 <= root < self.remote_size:
            raise errors.RankError(f"intercomm bcast root {root} invalid")
        # receiving group: leader takes delivery, intra-bcast fans out
        payload = None
        if self.rank == 0:
            payload = self.recv(source=root, tag=tag)
        return self._ctx.bcast(payload, root=0)

    # -- allreduce --------------------------------------------------------

    def allreduce(self, value: Any, op) -> Any:
        """Intercomm allreduce: every rank receives the reduction of the
        REMOTE group's contributions (MPI semantics).  Local intra-reduce
        to the leader, leaders swap, intra-bcast of the remote result."""
        tag = self._inter_tag()
        mine = self._ctx.reduce(value, op, root=0, algorithm="auto")
        if self.rank == 0:
            self.send(mine, 0, tag=tag)
            theirs = self.recv(source=0, tag=tag)
        else:
            theirs = None
        return self._ctx.bcast(theirs, root=0)

    # -- allgather --------------------------------------------------------

    def allgather(self, value: Any) -> list:
        """Intercomm allgather: every rank receives the remote group's
        rank-indexed contributions."""
        tag = self._inter_tag()
        mine = self._ctx.gather(value, root=0)
        if self.rank == 0:
            self.send(mine, 0, tag=tag)
            theirs = self.recv(source=0, tag=tag)
        else:
            theirs = None
        return self._ctx.bcast(theirs, root=0)

    # -- rooted reduce / gather / scatter ---------------------------------

    def reduce(self, value: Any, op, root: int = PROC_NULL) -> Any:
        """Intercomm reduce: the root receives the reduction of the remote
        group's data.  Root group passes ROOT/PROC_NULL (their `value` is
        not part of the reduction — MPI semantics); the other group
        reduces and its leader ships the result."""
        tag = self._inter_tag()
        if root == ROOT:
            return self.recv(source=0, tag=tag)
        if root == PROC_NULL:
            return None
        if not 0 <= root < self.remote_size:
            raise errors.RankError(f"intercomm reduce root {root} invalid")
        acc = self._ctx.reduce(value, op, root=0, algorithm="auto")
        if self.rank == 0:
            self.send(acc, root, tag=tag)
        return None

    def gather(self, value: Any = None, root: int = PROC_NULL) -> list | None:
        """Intercomm gather: root receives the remote group's rank-indexed
        values."""
        tag = self._inter_tag()
        if root == ROOT:
            return self.recv(source=0, tag=tag)
        if root == PROC_NULL:
            return None
        if not 0 <= root < self.remote_size:
            raise errors.RankError(f"intercomm gather root {root} invalid")
        gathered = self._ctx.gather(value, root=0)
        if self.rank == 0:
            self.send(gathered, root, tag=tag)
        return None

    def scatter(self, values: list | None = None, root: int = PROC_NULL):
        """Intercomm scatter: root's rank-indexed list (one block per
        REMOTE rank) lands blockwise across the remote group."""
        tag = self._inter_tag()
        if root == ROOT:
            if values is None or len(values) != self.remote_size:
                raise errors.ArgError(
                    f"intercomm scatter root needs {self.remote_size} "
                    f"blocks"
                )
            self.send(values, 0, tag=tag)
            return None
        if root == PROC_NULL:
            return None
        if not 0 <= root < self.remote_size:
            raise errors.RankError(f"intercomm scatter root {root} invalid")
        blocks = None
        if self.rank == 0:
            blocks = self.recv(source=root, tag=tag)
        return self._ctx.scatter(blocks, root=0)
