"""Communicators over ``torch.distributed`` process groups
(namesake: ``zhpe_ompi_tpu/comm/communicator.py``).

Semantic shift from the JAX package, stated once here.  There, one Python
object under a single controller describes a communicator for ALL devices
of a mesh axis, and "rank" is a traced value inside ``shard_map``.  Here the
reference's own model returns: one process per GPU, each holding its own
communicator object over one ``torch.distributed`` process group, with
``rank`` and ``size`` as plain ints.  A communicator over one dimension of
a ``DeviceMesh`` is ``Communicator(mesh.get_group(dim))``.

A one-rank group is legal and still dispatches through ``comm_select``
(``tuned``, whose ``xla`` route is the ``nccl`` component): that is how a
single GPU runs the framework path.

The collective function table (``comm.coll``) is composed per communicator,
per operation from the coll framework's components by priority, mirroring
``mca_coll_base_comm_select.c:108-152``; every MPI collective method goes
through it.  ``shift``, ``permute`` and ``ppermute`` are the SPMD plane's
point-to-point (``pt2pt/spmd.py``).  ``split``, ``shrink``, ``revoke``,
``agree`` and ``run`` are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Any

import torch
import torch.distributed as dist

from .. import ops as _ops
from ..core import attributes
from ..core import errhandler as errh
from ..core import errors
from ..core import info as info_mod
from ..mca import output as mca_output
from ..pt2pt import spmd as _spmd
from .group import Group

_stream = mca_output.open_stream("comm")

_cid_lock = threading.Lock()
_next_cid = [0]


def _alloc_cid() -> int:
    """CID allocation (cf. ompi_comm_nextcid): process-local and monotonic;
    every rank creates its communicators in the same order, so the numbers
    agree across ranks."""
    with _cid_lock:
        cid = _next_cid[0]
        _next_cid[0] += 1
        return cid


class Communicator(errh.HasErrhandler, attributes.AttrHost):
    """A communicator over one ``torch.distributed`` process group.

    ``pg`` defaults to the default (world) group, which the caller has set
    up with ``dist.init_process_group``.  Carries an
    :class:`~zhpe_ompi_tpu_torch.core.info.Info` of hints, an attachable
    errhandler (default MPI_ERRORS_ARE_FATAL, the reference's communicator
    default) and keyval attribute caching."""

    _default_errhandler = errh.ERRORS_ARE_FATAL

    def __init__(self, pg=None, name: str | None = None, info=None) -> None:
        if not dist.is_initialized():
            raise errors.NotInitializedError(
                "torch.distributed is not initialized: call "
                "dist.init_process_group before building a Communicator"
            )
        self.pg = pg if pg is not None else dist.group.WORLD
        self.group = Group(dist.get_process_group_ranks(self.pg))
        self.rank = dist.get_rank(self.pg)
        self.size = dist.get_world_size(self.pg)
        self.backend = str(dist.get_backend(self.pg))
        self.cid = _alloc_cid()
        self.name = name or f"comm{self.cid}"
        self.attributes: dict[Any, Any] = {}
        self.info = info_mod.coerce(info)
        self._coll: dict[str, tuple] | None = None
        # set by pt2pt/spmd once a full-group batched P2P call has run
        self._p2p_ready = False
        mca_output.verbose(
            5, _stream, "created %s: rank %d of %d on %s",
            self.name, self.rank, self.size, self.backend,
        )

    # -- construction of new communicators ------------------------------

    def dup(self, name: str | None = None) -> "Communicator":
        """MPI_Comm_dup: same ranks, a fresh process group and CID;
        attributes propagate through their keyvals' copy callbacks.
        Collective over the whole world, as ``dist.new_group`` is."""
        pg = dist.new_group(ranks=list(self.group.ranks), backend=self.backend)
        new = Communicator(pg, name, self.info.dup())
        self._copy_attrs_to(new)
        return new

    def free(self) -> None:
        """MPI_Comm_free: runs attribute delete callbacks."""
        self._delete_all_attrs()

    def set_info(self, info) -> None:
        """MPI_Comm_set_info: replace the hint set."""
        self.info = info_mod.coerce(info)

    # -- collective dispatch --------------------------------------------

    @property
    def coll(self) -> dict:
        """Per-communicator collective table, composed on first use
        (mca_coll_base_comm_select semantics)."""
        if self._coll is None:
            from ..coll.framework import comm_select

            self._coll = comm_select(self)
        return self._coll

    def _coll_call(self, opname: str, *args, **kwargs):
        # errors at the dispatch boundary route through the attached
        # errhandler (OMPI_ERRHANDLER_INVOKE at the binding layer)
        return self._errhandler_guard(
            self._coll_call_inner, opname, *args, **kwargs
        )

    def _coll_call_inner(self, opname: str, *args, **kwargs):
        entry = self.coll.get(opname)
        if entry is None:
            raise errors.UnsupportedError(
                f"no coll component provides {opname} for {self.name}"
            )
        fn, _ = entry
        return fn(self, *args, **kwargs)

    @property
    def device(self) -> torch.device:
        """Where this communicator's own buffers live (a barrier token with
        no caller data): the current CUDA device on NCCL, else the CPU."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def allreduce(self, x, op=None, **kw):
        return self._coll_call("allreduce", x, op or _ops.SUM, **kw)

    def reduce(self, x, op=None, root: int = 0, **kw):
        return self._coll_call("reduce", x, op or _ops.SUM, root, **kw)

    def bcast(self, x, root: int = 0, **kw):
        return self._coll_call("bcast", x, root, **kw)

    def barrier(self, token=None):
        return self._coll_call("barrier", token)

    def allgather(self, x, **kw):
        return self._coll_call("allgather", x, **kw)

    def alltoall(self, x, **kw):
        return self._coll_call("alltoall", x, **kw)

    def reduce_scatter(self, x, op=None, **kw):
        return self._coll_call("reduce_scatter", x, op or _ops.SUM, **kw)

    def reduce_scatter_block(self, x, op=None, **kw):
        return self._coll_call("reduce_scatter_block", x, op or _ops.SUM,
                               **kw)

    def alltoallv(self, x, counts, **kw):
        """MPI_Alltoallv with a static count matrix: ``counts[i][j]`` rows
        go from rank i to rank j; ``x`` is (size, max_send, ...) padded
        blocks, result is (size, max_recv, ...) padded blocks."""
        return self._coll_call("alltoallv", x, counts, **kw)

    def scan(self, x, op=None, **kw):
        return self._coll_call("scan", x, op or _ops.SUM, **kw)

    def exscan(self, x, op=None, **kw):
        return self._coll_call("exscan", x, op or _ops.SUM, **kw)

    def gather(self, x, root: int = 0, **kw):
        return self._coll_call("gather", x, root, **kw)

    def scatter(self, x, root: int = 0, **kw):
        return self._coll_call("scatter", x, root, **kw)

    def allgatherv(self, x, counts, **kw):
        return self._coll_call("allgatherv", x, counts, **kw)

    # -- point-to-point (SPMD plane) -------------------------------------

    def shift(self, x, offset: int, wrap: bool = True):
        """Uniform-shift sendrecv (MPI_Sendrecv in a ring / MPI_Cart_shift):
        every rank sends its buffer to (rank+offset) and receives from
        (rank-offset).  With wrap=False the ends get zeros (MPI_PROC_NULL)."""
        return _spmd.shift(self, x, offset, wrap=wrap)

    def permute(self, x, dest_of: list[int]):
        """General static sendrecv: dest_of[i] is where comm rank i's buffer
        goes (-1 = sends nowhere); ranks nobody targets receive zeros."""
        return _spmd.sendrecv(self, x, dest_of)

    def ppermute(self, x, pairs):
        """Comm-relative collective permute (the BTL of the SPMD plane)."""
        return _spmd.ppermute(self, x, pairs)

    def __repr__(self):  # pragma: no cover
        return (f"Communicator({self.name}, rank={self.rank}, "
                f"size={self.size}, backend={self.backend})")
