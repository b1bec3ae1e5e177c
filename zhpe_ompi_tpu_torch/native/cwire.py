"""A port rank's side of a C rank's rooted collectives (the ABI shim's
``MPI_Bcast``, ``MPI_Gatherv`` and ``MPI_Scatterv`` on ``MPI_COMM_WORLD``).

The shim (``zompi_mpi.cpp``) runs its collectives over point-to-point
frames of the host plane's wire: on WORLD's collective context id
(``0x7FFC``), with the tag ``(seq % 0x8000) << 16 | opcode``, where ``seq``
counts WORLD's collectives in program order (``CommObj::coll_seq``).  The
port's own host collectives (``coll/host.py``) use another context id and
other opcodes, so a port rank joins a C rank's collective through this
class, which keeps the same count and sends and receives the same frames:

- ``scatterv(root)``: the root sends each rank its block (linear);
- ``gatherv(value, root)``: each rank sends its block to the root;
- ``bcast(value, root)``: a binomial tree over ranks relative to the root
  (``coll_base_bcast.c``'s shape): a rank receives from its parent and
  forwards to its children, whichever plane they run on.

Every rank of the job must call the same collectives in the same order, as
MPI requires; the port ranks' own host collectives do not move the count.
"""

from __future__ import annotations

from typing import Any

COLL_CID = 0x7FFC  # WORLD's collective context id in the shim
OP_BCAST = 0x7E01
OP_GATHERV = 0x7E0A
OP_SCATTERV = 0x7E0B


class CWorld:
    """The shim's WORLD collectives as seen from a port ``TcpProc``."""

    def __init__(self, proc) -> None:
        self.proc = proc
        self.seq = 0

    def _tag(self, opcode: int) -> int:
        tag = ((self.seq % 0x8000) << 16) | opcode
        self.seq += 1
        return tag

    def scatterv(self, root: int, timeout: float | None = None) -> Any:
        """This rank's block of the root's ``MPI_Scatterv`` (a CPU
        tensor of the root's datatype)."""
        return self.proc.recv(source=root, tag=self._tag(OP_SCATTERV),
                              cid=COLL_CID, timeout=timeout)

    def gatherv(self, value: Any, root: int) -> None:
        """This rank's block of the root's ``MPI_Gatherv``; ``value``
        must hold the root's ``recvcounts[rank]`` elements of its
        ``recvtype``."""
        self.proc.send(value, dest=root, tag=self._tag(OP_GATHERV),
                       cid=COLL_CID)

    def bcast(self, value: Any, root: int,
              timeout: float | None = None) -> Any:
        """The root's ``MPI_Bcast`` buffer: received from this rank's
        parent in the binomial tree and forwarded to its children (the
        root passes ``value``; other ranks pass None)."""
        n, me = self.proc.size, self.proc.rank
        tag = self._tag(OP_BCAST)
        vrank = (me - root) % n
        if vrank != 0:
            parent = ((vrank & (vrank - 1)) + root) % n
            value = self.proc.recv(source=parent, tag=tag, cid=COLL_CID,
                                   timeout=timeout)
        mask = 1
        while mask < n:
            if (vrank & (mask - 1)) == 0 and (vrank | mask) != vrank:
                child = vrank | mask
                if child < n:
                    self.proc.send(value, dest=(child + root) % n, tag=tag,
                                   cid=COLL_CID)
            mask <<= 1
        return value
