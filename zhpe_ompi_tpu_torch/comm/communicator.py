"""Communicators over ``torch.distributed`` process groups
(namesake: ``zhpe_ompi_tpu/comm/communicator.py``).

Semantic shift from the JAX package, stated once here.  There, one Python
object under a single controller describes a communicator for ALL devices
of a mesh axis: "rank" is a traced value inside ``shard_map``, and
``split(colors)`` returns ONE object holding every sub-communicator of the
partition.  Here the reference's own model returns: one process per GPU,
each holding its own communicator object over one ``torch.distributed``
process group, with ``rank`` and ``size`` as plain ints.  A communicator
over one dimension of a ``DeviceMesh`` is ``Communicator(mesh.get_group(dim))``.
So:

- ``split(colors, keys)`` still takes the colour of every rank of the
  communicator (the same list on every rank: what ``ompi_comm_split``
  gathers), and each rank gets the communicator of its own colour; the
  whole partition is kept in ``comm.partition`` (world ranks), so
  ``is_partitioned``, ``uniform_size`` and ``index_groups`` describe it
  as in the JAX package.  ``create_from_group(group)`` gives the members
  of ``group`` its communicator and every other rank the complement's,
  as the JAX package's two-group partition does; ``shrink(failed)`` is
  that over the survivors.  ``failed`` names ranks of this communicator.
- Every construction (``dup``, ``split``, ``create_from_group``,
  ``shrink``) is collective over the communicator it starts from
  (MPI_Comm_dup and MPI_Comm_split are), and only the members of a new
  group create it.  Its process group is named from the parent group's
  agreed id (``gid``, the process group's name) and the number of
  children made over that group before it, counted per process group and
  advanced only by these constructors, so groups made by different
  subsets of the world never meet under one store prefix, and two dups
  never share a name.  Members must make children of a group in the same
  order, as MPI requires of collective constructors.  Wrapping a process
  group (``Communicator(pg)``) is local and advances nothing: every
  wrapper of one group shares its ``gid`` and its child count.
- ``revoke`` revokes the group: every communicator over its process
  group, here at once and on the other ranks through the default group's
  store (``ft/ulfm.py``); the check at the top of every collective is a
  local set lookup.
- ``agree`` and ``shrink`` take the failed ranks from ``failed`` or from
  a bound failure state; the agreement is one all-reduce over the live
  ranks (over a cached survivors' communicator when some have failed),
  which runs on a revoked communicator too, as MPIX_Comm_agree does.
- ``run(fn, *args)`` is ``shard_map``'s per-process counterpart: this
  rank's dim-0 block of each argument in, every rank's output gathered
  along dim 0 out.  ``axis_index`` and ``size_traced`` have no counterpart
  (there is no traced axis: ``rank`` and ``size`` are ints).

A one-rank group is legal and still dispatches through ``comm_select``
(``tuned``, whose ``xla`` route is the ``nccl`` component): that is how a
single GPU runs the framework path.

The collective function table (``comm.coll``) is composed per communicator,
per operation from the coll framework's components by priority, mirroring
``mca_coll_base_comm_select.c:108-152``; every MPI collective method goes
through it, past the PMPI interposition point (``tools/pmpi.py``).
``_coll_call_inner`` is also the collectives' counting seam: while a
``coll/monitoring`` window is armed or a profiler records, each call runs
in a ``zmpi.coll.<op>`` profiler range and is counted into the armed
tallies (calls, payload bytes, host time).
``shift``, ``permute`` and ``ppermute`` are the SPMD plane's point-to-point
(``pt2pt/spmd.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Sequence

import torch
import torch.distributed as dist
import torch.distributed.distributed_c10d as c10d
from torch.distributed.constants import default_pg_timeout

from .. import ops as _ops
from ..coll import monitoring
from ..core import attributes
from ..core import errhandler as errh
from ..core import errors
from ..core import info as info_mod
from ..ft import ulfm
from ..mca import output as mca_output
from ..pt2pt import spmd as _spmd
from ..runtime import spc, ztrace
from ..tools import pmpi
from .group import Group

_stream = mca_output.open_stream("comm")

_cid_lock = threading.Lock()
_next_cid = [0]
# gid (a live process group's name) -> what the collective constructors
# over that group made in this process: the group itself, the number of
# children named so far, and agree()'s survivors' communicators by dead set
_lineage: dict[str, dict] = {}


def _alloc_cid() -> int:
    """CID allocation (cf. ompi_comm_nextcid): process-local and monotonic.
    Ranks need not agree on it; ``Communicator.gid`` is the agreed id."""
    with _cid_lock:
        cid = _next_cid[0]
        _next_cid[0] += 1
        return cid


def forget_destroyed() -> None:
    """Drop the lineage (and the revocation) of every process group that
    ``torch.distributed`` has since destroyed, so a group made later
    under the same name starts afresh."""
    live = c10d._world.pg_names
    with _cid_lock:
        gone = [gid for gid, st in _lineage.items() if st["pg"] not in live]
        for gid in gone:
            del _lineage[gid]
    for gid in gone:
        ulfm.forget_group(gid)


def _lineage_of(pg) -> tuple[str, dict]:
    """The agreed id of ``pg`` and its lineage in this process."""
    gid = str(c10d._get_process_group_name(pg))
    with _cid_lock:
        state = _lineage.get(gid)
    if state is None or state["pg"] is not pg:
        forget_destroyed()
        with _cid_lock:
            state = _lineage.setdefault(
                gid, {"pg": pg, "children": 0, "survivors": {}})
    return gid, state


def new_group(name: str, ranks: Sequence[int], backend: str):
    """A process group over the world ranks ``ranks`` (group rank i is
    ``ranks[i]``) named ``name``, made by its members only: unlike
    ``dist.new_group``, whose default name is a per-process creation count
    and so needs every rank of the world to call it for every group, the
    name here is given by the caller and agreed by the members.  It is
    registered with ``torch.distributed`` as ``dist.new_group`` registers
    its groups, so every ``dist`` call takes it."""
    ranks = [int(r) for r in ranks]
    me = dist.get_rank()
    if me not in ranks:
        raise errors.InternalError(f"rank {me} is not in the new group {ranks}")
    default = c10d._get_default_group()
    if default.bound_device_id is not None and dist.get_world_size() > 1:
        # an eagerly bound default group makes NCCL split every new group
        # from it, which needs every rank of the world at each creation
        raise errors.UnsupportedError(
            "the default process group is bound to a device (init_process_group"
            "(device_id=...)): sub-communicators need every rank of the world "
            "at each creation; initialize it without device_id")
    pg, _ = c10d._new_process_group_helper(
        len(ranks), ranks.index(me), ranks, backend, c10d._get_default_store(),
        name, timeout=default_pg_timeout)
    c10d._world.pg_group_ranks[pg] = {g: i for i, g in enumerate(ranks)}
    return pg


class Communicator(errh.HasErrhandler, attributes.AttrHost):
    """A communicator over one ``torch.distributed`` process group.

    ``pg`` defaults to the default (world) group, which ``runtime.init()``
    or the caller (``dist.init_process_group``) has set up.  Carries an
    :class:`~zhpe_ompi_tpu_torch.core.info.Info` of hints, an attachable
    errhandler (default MPI_ERRORS_ARE_FATAL, the reference's communicator
    default) and keyval attribute caching.  ``partition`` lists, as
    groups of world ranks, every communicator of the split this one came
    from (default: this communicator's own group alone).  Building one
    over a process group is local: the collective step is making the
    group."""

    _default_errhandler = errh.ERRORS_ARE_FATAL

    def __init__(self, pg=None, name: str | None = None, info=None,
                 partition: list[Group] | None = None) -> None:
        if not dist.is_initialized():
            raise errors.NotInitializedError(
                "torch.distributed is not initialized: call "
                "zhpe_ompi_tpu_torch.runtime.init() (or dist.init_process_group) "
                "before building a Communicator"
            )
        self.pg = pg if pg is not None else dist.group.WORLD
        self.group = Group(dist.get_process_group_ranks(self.pg))
        self.rank = dist.get_rank(self.pg)
        self.size = dist.get_world_size(self.pg)
        self.backend = str(dist.get_backend(self.pg))
        self.cid = _alloc_cid()
        self.gid, self._lineage = _lineage_of(self.pg)
        self.name = name or f"comm{self.cid}"
        self.partition = list(partition) if partition else [self.group]
        self.attributes: dict[Any, Any] = {}
        self.info = info_mod.coerce(info)
        self._coll: dict[str, tuple] | None = None
        # set by pt2pt/spmd once a full-group batched P2P call has run
        self._p2p_ready = False
        ulfm.track(self)
        mca_output.verbose(
            5, _stream, "created %s (%s): rank %d of %d on %s",
            self.name, self.gid, self.rank, self.size, self.backend,
        )

    # -- shape/introspection --------------------------------------------

    @property
    def is_partitioned(self) -> bool:
        return len(self.partition) > 1

    @property
    def uniform_size(self) -> int | None:
        sizes = {g.size for g in self.partition}
        return sizes.pop() if len(sizes) == 1 else None

    @property
    def index_groups(self) -> list[list[int]] | None:
        """The partition's groups as lists of world ranks (None for one
        group holding the whole world in rank order)."""
        if not self.is_partitioned and self.partition[0].ranks == tuple(
            range(dist.get_world_size())
        ):
            return None
        return [list(g.ranks) for g in self.partition]

    # -- construction of new communicators ------------------------------

    def _child_tag(self) -> str:
        """The agreed name stem of the next group made from this
        communicator's process group (every member makes its children in
        the same order)."""
        with _cid_lock:
            n = self._lineage["children"]
            self._lineage["children"] = n + 1
        return f"{self.gid}.{n}"

    def dup(self, name: str | None = None) -> "Communicator":
        """MPI_Comm_dup: same ranks and partition, a fresh process group and
        CID, no info hints (as the JAX package's dup); attributes propagate
        through their keyvals' copy callbacks.  Collective over this
        communicator only."""
        pg = new_group(self._child_tag(), self.group.ranks, self.backend)
        new = Communicator(pg, name, partition=self.partition)
        self._copy_attrs_to(new)
        return new

    def free(self) -> None:
        """MPI_Comm_free: runs attribute delete callbacks."""
        self._delete_all_attrs()

    def split_type(self, split_type: str = "shared",
                   keys: Sequence[int] | None = None,
                   name: str | None = None) -> "Communicator":
        """MPI_Comm_split_type: "shared" groups the ranks that share a host
        (MPI_COMM_TYPE_SHARED); on one host this is one group (== dup).
        The hosts are gathered over this communicator."""
        if split_type != "shared":
            raise errors.ArgError(f"unknown split_type {split_type!r}")
        import socket

        hosts: list = [None] * self.size
        dist.all_gather_object(hosts, socket.gethostname(), group=self.pg)
        order = sorted(set(hosts))
        return self.split([order.index(h) for h in hosts], keys, name)

    def split(self, colors: Sequence[int], keys: Sequence[int] | None = None,
              name: str | None = None) -> "Communicator":
        """MPI_Comm_split: ``colors[i]`` is the colour of rank i of this
        communicator, the same list on every rank (UNDEFINED/-1 is not
        supported: use a colour); ``keys`` orders the ranks within each new
        group (ties by old rank).  Returns this rank's communicator."""
        if len(colors) != self.size:
            raise errors.ArgError(f"need {self.size} colors, got {len(colors)}")
        keys = list(keys) if keys is not None else [0] * self.size
        if len(keys) != self.size:
            raise errors.ArgError(f"need {self.size} keys, got {len(keys)}")
        buckets: dict[int, list[int]] = {}
        for r in range(self.size):
            buckets.setdefault(int(colors[r]), []).append(r)
        tag = self._child_tag()
        groups = {}
        for color in sorted(buckets):
            members = sorted(buckets[color], key=lambda r: (keys[r], r))
            groups[color] = Group(self.group.global_of_rank(r) for r in members)
        mine = int(colors[self.rank])
        pg = new_group(f"{tag}.{mine}", groups[mine].ranks, self.backend)
        return Communicator(pg, name, partition=list(groups.values()))

    def create_from_group(self, group: Group, name: str | None = None
                          ) -> "Communicator":
        """MPI_Comm_create_from_group-style: ``group`` (world ranks, all in
        this communicator) gets its communicator and every other rank the
        complement's, in this communicator's rank order: the JAX package's
        two-group partition, each rank keeping its own."""
        for r in group.ranks:
            if self.group.rank_of_global(r) < 0:
                raise errors.GroupError(
                    f"rank {r} of the group is not in {self.name}")
        rest = [r for r in self.group.ranks if group.rank_of_global(r) < 0]
        parts = [group] + ([Group(rest)] if rest else [])
        tag = self._child_tag()
        me = self.group.global_of_rank(self.rank)
        k = 0 if group.rank_of_global(me) >= 0 else 1
        pg = new_group(f"{tag}.{k}", parts[k].ranks, self.backend)
        return Communicator(pg, name, partition=parts)

    # -- ULFM (MPIX_Comm_revoke / _shrink / _agree / _failure_ack) --------

    def bind_failure_state(self, state) -> "Communicator":
        """Attach a failure state (an object with ``failed()``, ``ack()``
        and ``acked()``, as ``ft/ulfm.FailureState``) so shrink(), agree()
        and failure_ack() can consult the live failure view."""
        self._ft_state = state
        return self

    @property
    def ft_state(self):
        return getattr(self, "_ft_state", None)

    def revoke(self) -> None:
        """MPIX_Comm_revoke: poison this communicator's group — every
        pending and future operation on a communicator over its process
        group raises ``Revoked`` — here at once, and on the other ranks
        when their revocation watcher next polls the store
        (``ft/ulfm.py``)."""
        ulfm.revoke_group(self.gid)
        spc.record("comm_revokes")
        if self.size > 1:
            ulfm.publish_revocation(c10d._get_default_store(), self.gid)
        mca_output.verbose(5, _stream, "revoked %s (cid=%d, gid=%s)",
                           self.name, self.cid, self.gid)

    def is_revoked(self) -> bool:
        return ulfm.is_revoked(self.cid)

    def _failed_ranks(self, failed) -> set[int]:
        if failed is None:
            if self.ft_state is None:
                raise errors.ArgError(
                    "no failed ranks given and no failure state bound "
                    "(bind_failure_state)"
                )
            failed = self.ft_state.failed()
        return {int(r) for r in failed}

    def shrink(self, failed=None, name: str | None = None
               ) -> "Communicator":
        """MPIX_Comm_shrink: a fresh communicator (new, unrevoked cid) over
        the survivors, in their old rank order.  ``failed`` (ranks of this
        communicator) defaults to the bound failure state's view; a rank
        listed as failed that still calls gets the complement's
        communicator, as in the JAX package's partition."""
        dead = self._failed_ranks(failed)
        survivors = [self.group.global_of_rank(r) for r in range(self.size)
                     if r not in dead]
        if not survivors:
            raise errors.ProcFailed("no survivors to shrink onto",
                                    failed_ranks=dead)
        sp = ztrace.begin(ztrace.SHRINK, self.rank, failed=sorted(dead)) \
            if ztrace.active else None
        new = self.create_from_group(
            Group(survivors), name or f"{self.name}_shrunk"
        )
        if self.ft_state is not None:
            new.bind_failure_state(self.ft_state)
        if sp is not None:
            sp.end(survivors=len(survivors))
        return new

    def agree(self, flag: bool = True, contributions=None,
              failed=None) -> bool:
        """MPIX_Comm_agree: the AND of ``flag`` over the LIVE ranks, each
        rank contributing its own.  ``contributions`` (a dict or sequence
        by rank, the same on every rank) is the JAX package's single-
        controller form: its live entries are folded into ``flag`` first.
        Dead participants are excluded, so agreement completes despite
        their death; it runs on a revoked communicator too."""
        if failed is None:
            failed = (self.ft_state.failed()
                      if self.ft_state is not None else ())
        dead = frozenset(int(r) for r in failed)
        if self.rank in dead:
            raise errors.ProcFailed(
                f"rank {self.rank} of {self.name} is in the failed set",
                failed_ranks=dead)
        acc = bool(flag)
        if contributions is not None:
            items = (contributions.items()
                     if isinstance(contributions, dict)
                     else enumerate(contributions))
            for rank, contrib in items:
                if int(rank) in dead:
                    continue
                acc = acc and bool(contrib)
        comm = self
        if dead:
            comm = self._lineage["survivors"].get(dead)
            if comm is None:
                # named by the dead set, not the child count, which the
                # dead ranks no longer advance
                live = [self.group.global_of_rank(r) for r in range(self.size)
                        if r not in dead]
                tag = f"{self.gid}.live-" + "-".join(map(str, sorted(dead)))
                comm = Communicator(new_group(tag, live, self.backend),
                                    name=f"{self.name}_agree")
                self._lineage["survivors"][dead] = comm
        sp = ztrace.begin(ztrace.AGREE, self.rank) if ztrace.active else None
        # the table's allreduce itself, past the revoked check
        fn, _ = comm.coll["allreduce"]
        flag_t = torch.tensor([int(acc)], dtype=torch.int32, device=comm.device)
        out = bool(fn(comm, flag_t, _ops.LAND).item())
        if sp is not None:
            sp.end(result=out)
        return out

    def failure_ack(self) -> None:
        """MPIX_Comm_failure_ack on the bound failure state."""
        if self.ft_state is None:
            raise errors.ArgError("no failure state bound")
        self.ft_state.ack()

    def failure_get_acked(self) -> Group:
        """MPIX_Comm_failure_get_acked: acknowledged-failed ranks."""
        if self.ft_state is None:
            raise errors.ArgError("no failure state bound")
        return Group(sorted(self.ft_state.acked()))

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
        if ulfm.is_revoked(self.cid):
            raise errors.Revoked(
                f"{opname} on revoked communicator {self.name}",
                cid=self.cid,
            )
        entry = self.coll.get(opname)
        if entry is None:
            raise errors.UnsupportedError(
                f"no coll component provides {opname} for {self.name}"
            )
        fn, _ = entry
        if monitoring.active or ztrace.profiler_recording():
            return self._coll_call_watched(opname, fn, args, kwargs)
        # PMPI interposition point (the weak-symbol MPI_X = PMPI_X analog,
        # ompi/mpi/c/send.c:37-39): tools see the call before the MCA path
        if pmpi.active():
            return pmpi.dispatch(opname, self, fn, args, kwargs)
        return fn(self, *args, **kwargs)

    def _coll_call_watched(self, opname: str, fn, args, kwargs):
        """The dispatch while a ``coll/monitoring`` window is armed or a
        profiler records: the call runs inside a ``zmpi.coll.<op>``
        profiler range, and its payload bytes and host nanoseconds go into
        the armed tallies."""
        with ztrace.profiler_range(f"zmpi.coll.{opname}"):
            t0 = time.perf_counter_ns()
            if pmpi.active():
                out = pmpi.dispatch(opname, self, fn, args, kwargs)
            else:
                out = fn(self, *args, **kwargs)
            ns = time.perf_counter_ns() - t0
        if monitoring.active:
            monitoring.note(opname, self.cid, args[0] if args else None, ns)
        return out

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

    # -- host-side execution helpers -------------------------------------

    def _block(self, x, dim):
        x = torch.as_tensor(x)
        if dim is None:
            return x
        if x.shape[dim] % self.size:
            raise errors.CountError(
                f"dim {dim} ({x.shape[dim]}) does not split over {self.size} ranks")
        return x.chunk(self.size, dim=dim)[self.rank]

    def run(self, fn, *args, in_specs=None, out_specs=None):
        """``shard_map``'s per-process counterpart: ``fn`` runs on this
        rank's block of each argument and every rank's outputs are gathered
        back, so each rank returns what the JAX package's ``run`` returns.
        ``in_specs``/``out_specs``: None shards every argument/output on
        dim 0; otherwise one entry per argument/output, 0 for dim 0 or None
        for replicated (passed whole, returned as this rank computed it)."""
        specs = in_specs if in_specs is not None else [0] * len(args)
        out = fn(*(self._block(a, d) for a, d in zip(args, specs)))
        single = not isinstance(out, (tuple, list))
        outs = [out] if single else list(out)
        ospecs = out_specs if out_specs is not None else [0] * len(outs)
        if single and not isinstance(ospecs, (tuple, list)):
            ospecs = [ospecs]
        gathered = [o if d is None else self.allgather(o)
                    for o, d in zip(outs, ospecs)]
        return gathered[0] if single else type(out)(gathered)

    def device_put_sharded(self, x, spec=None):
        """This rank's dim-0 block (or dim ``spec``) of a host array, on
        this communicator's device."""
        return self._block(x, 0 if spec is None else spec).to(self.device)

    def __repr__(self):  # pragma: no cover
        return (f"Communicator({self.name}, rank={self.rank}, "
                f"size={self.size}, backend={self.backend})")
