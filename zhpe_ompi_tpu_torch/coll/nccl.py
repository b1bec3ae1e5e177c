"""coll/nccl — native ``torch.distributed`` collectives.

Stands in for the JAX package's ``coll/tpu.py``: where that component
lowers each operation to the XLA collective the TPU runs on ICI, this one
hands it to the process group's own backend — NCCL on GPUs (NVLink within
a host), gloo on CPU tensors, which the tests use.  The component is
named ``nccl`` whichever of the two backs the group; ``comm.backend``
says which one does.  It is ``coll/tuned``'s ``xla`` route.

- allreduce: SUM, MAX and MIN map to ``dist.all_reduce`` with the op's
  ``reduce_op`` hint (``coll/tpu.py:94-101``).  LAND, LOR and LXOR are
  re-expressed arithmetically so they still ride one native collective, as
  at ``coll/tpu.py:102-107``: LAND = MIN(x≠0), LOR = MAX(x≠0), LXOR =
  SUM(x≠0) mod 2.  Every other op (PROD, bitwise, MINLOC/MAXLOC, user
  ops) takes the algorithm layer's recursive doubling
  (``coll/algorithms.py``), as at ``coll/tpu.py:109``; NCCL's own PROD is
  not used, so PROD computes exactly as in the JAX package.
- bcast, allgather(v), alltoall(v) and reduce_scatter with a ``reduce_op``
  hint are the native ``dist`` calls; reduce_scatter with any other op,
  scan and exscan take the algorithm layer's recursive forms.
- reduce, gather and scatter keep the JAX package's SPMD shapes: reduce is
  the allreduce (significant at root), gather the allgather, and scatter
  this rank's flat chunk of root's buffer after a bcast.
- barrier all-reduces a token and returns an int32 zero computed from it.

NCCL has no bool reduction: bool tensors are reduced and moved as int32
or bytes.  Collectives are functional, as in the JAX package: the input
tensor is left untouched and a new tensor is returned.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import errors
from ..pt2pt.spmd import wire
from . import algorithms as alg
from .framework import CollComponent, CollModule

_NATIVE_BACKENDS = ("nccl", "gloo")

# The one-element all-reduce the device-plane fault loop runs
# (parallel/mesh.py arms it through utils/deadline.run_probe, which
# prepends the internal-watchdog preamble, so ``os``, ``sys``, ``time``
# are in scope): a wedged GPU participant surfaces as an indefinite hang,
# so the probe lives where it can be killed — a subprocess — and dies from
# the inside at its deadline even if the outer kill is delayed.  The child
# makes a one-rank group of its own on the card PROBE_DEVICE_ENV names
# (NCCL), or on the CPU (gloo) when it says "cpu".  ``ZMPI_DEVICE_WEDGE``
# is the fault-injection hook: the child wedges INSIDE the collective
# region, after the group is up and before the all-reduce, so the whole
# classification ladder is drillable without real hardware loss.

#: wedge-injection hook read by the probe child.  WEDGE_ALL wedges every
#: probe child of the process; a rank number wedges only probes launched
#: FOR that rank (PROBE_RANK_ENV).  The all-sentinel is non-numeric, so a
#: rank-number value never doubles as the process-wide switch.
WEDGE_ENV = "ZMPI_DEVICE_WEDGE"
WEDGE_ALL = "all"
PROBE_RANK_ENV = "ZMPI_PROBE_RANK"
PROBE_DEVICE_ENV = "ZMPI_PROBE_DEVICE"

PROBE_SRC = (
    "import json\n"
    "_t=[time.perf_counter()]\n"
    "def _lap():\n"
    "    _t.append(time.perf_counter())\n"
    "    return _t[-1]-_t[-2]\n"
    "import torch\n"
    "import torch.distributed as dist\n"
    "_s={'import': _lap()}\n"
    f"_d=os.environ.get({PROBE_DEVICE_ENV!r}, 'cpu')\n"
    "if _d=='cpu':\n"
    "    backend, dev = 'gloo', torch.device('cpu')\n"
    "else:\n"
    "    backend, dev = 'nccl', torch.device('cuda', int(_d))\n"
    "    torch.cuda.set_device(dev)\n"
    "x=torch.ones(1, device=dev)\n"
    "_s['context']=_lap()\n"
    "dist.init_process_group(backend, store=dist.HashStore(), rank=0, "
    "world_size=1)\n"
    "_s['group']=_lap()\n"
    f"_w=os.environ.get({WEDGE_ENV!r})\n"
    f"if _w is not None and _w in ({WEDGE_ALL!r}, os.environ.get("
    f"{PROBE_RANK_ENV!r}, '')):\n"
    "    time.sleep(3600)  # the injected wedge: hang mid-collective\n"
    "dist.all_reduce(x)\n"
    "total=float(x.item())\n"
    "_s['allreduce']=_lap()\n"
    "name=torch.cuda.get_device_name(dev) if dev.type=='cuda' else 'cpu'\n"
    "dist.destroy_process_group()\n"
    "_s['destroy']=_lap()\n"
    "print(json.dumps({'n':1,'backend':backend,'device':name,"
    "'allreduce':total,'seconds':_s}))\n"
)


def _all_reduce(comm, x, reduce_op):
    if x.dtype == torch.bool:
        return _all_reduce(comm, x.to(torch.int32), reduce_op).to(torch.bool)
    out = x.clone()
    dist.all_reduce(out, op=reduce_op, group=comm.pg)
    return out


def _all_gather(comm, x):
    """(n * x.shape[0], ...) of every rank's x in rank order."""
    out = x.new_empty((comm.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(wire(out), wire(x), group=comm.pg)
    return out


def allreduce(comm, x, op):
    if op.reduce_op is not None:
        return _all_reduce(comm, x, op.reduce_op)
    R = dist.ReduceOp
    name = op.name
    if name in ("MPI_LAND", "MPI_LOR", "MPI_LXOR"):
        flag = (x != 0).to(torch.int32)
        if name == "MPI_LAND":
            return _all_reduce(comm, flag, R.MIN).to(x.dtype)
        if name == "MPI_LOR":
            return _all_reduce(comm, flag, R.MAX).to(x.dtype)
        return (_all_reduce(comm, flag, R.SUM) % 2).to(x.dtype)
    # PROD / bitwise / MINLOC / MAXLOC / user ops: algorithmic path
    return alg.allreduce_recursive_doubling(comm, x, op)


def reduce(comm, x, op, root=0):
    # the allreduce everywhere is the result at root, as in the JAX package
    return allreduce(comm, x, op)


def bcast(comm, x, root=0):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(wire(out), src=comm.group.global_of_rank(root),
                   group=comm.pg)
    return out


def barrier(comm, token=None):
    t = alg._barrier_token(comm, token)
    return alg._seal_token(_all_reduce(comm, t, dist.ReduceOp.SUM))


def allgather(comm, x):
    return _all_gather(comm, alg._stack_shape(x))


def allgatherv(comm, x, counts):
    n = comm.size
    mx = max(counts)
    x = alg._pad_rows(x, mx - x.shape[0])
    g = _all_gather(comm, x).reshape((n, mx) + tuple(x.shape[1:]))
    return torch.cat([g[i, :counts[i]] for i in range(n)], dim=0)


def alltoall(comm, x):
    n = comm.size
    if x.shape[0] % n:
        raise errors.CountError(
            f"alltoall needs dim0 divisible by comm size {n}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(wire(out), wire(x), group=comm.pg)
    return out


def alltoallv(comm, x, counts):
    """Padded alltoallv on the native all_to_all: ``x`` is (n, max_send,
    ...) blocks, ``counts`` the n x n static matrix; validation, padding
    and count-masking are shared with the algorithmic transport
    (``alg.alltoallv_prepare``, cf. coll_base_alltoallv.c:125)."""
    blocks, _ = alg.alltoallv_prepare(comm, x, counts)
    out = torch.empty_like(blocks)
    dist.all_to_all_single(wire(out), wire(blocks), group=comm.pg)
    return out


def reduce_scatter(comm, x, op):
    n = comm.size
    if op.reduce_op is None:
        return alg.reduce_scatter_recursive_halving(comm, x, op)
    if x.shape[0] % n:
        raise errors.CountError(
            f"reduce_scatter needs dim0 divisible by comm size {n}")
    if x.dtype == torch.bool:
        return reduce_scatter(comm, x.to(torch.int32), op).to(torch.bool)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=op.reduce_op,
                               group=comm.pg)
    return out


def reduce_scatter_block(comm, x, op):
    # MPI_Reduce_scatter_block (equal counts) — reduce_scatter's contract
    return reduce_scatter(comm, x, op)


def scan(comm, x, op):
    return alg.scan_recursive_doubling(comm, x, op)


def exscan(comm, x, op):
    return alg.exscan_recursive_doubling(comm, x, op)


def gather(comm, x, root=0):
    return allgather(comm, x)


def scatter(comm, x, root=0):
    # take own chunk of root's buffer after a single-collective bcast
    buf, _ = alg._chunked(bcast(comm, x, root), comm.size)
    return buf[comm.rank]


class NcclCollComponent(CollComponent):
    name = "nccl"
    default_priority = 40

    def available(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    def comm_query(self, comm) -> CollModule | None:
        if comm.backend not in _NATIVE_BACKENDS:
            return None
        return CollModule(
            allreduce=allreduce,
            reduce=reduce,
            bcast=bcast,
            barrier=barrier,
            allgather=allgather,
            allgatherv=allgatherv,
            alltoall=alltoall,
            alltoallv=alltoallv,
            reduce_scatter=reduce_scatter,
            reduce_scatter_block=reduce_scatter_block,
            scan=scan,
            exscan=exscan,
            gather=gather,
            scatter=scatter,
        )
