"""Coll framework: per-communicator, per-operation module composition
(namesake: ``zhpe_ompi_tpu/coll/framework.py``).

Re-design of ``ompi/mca/coll``'s selection machinery
(``coll_base_comm_select.c:108-152``): every admitted component is queried for
a per-communicator module; the communicator's collective table then takes each
*operation* from the highest-priority module that provides it.

Three components, as in the JAX package: ``tuned`` (priority 50, the
decision layer over ``coll/algorithms.py``), ``nccl`` (40, the counterpart
of the JAX package's ``coll/tpu``: the process group's native collectives,
and ``tuned``'s ``xla`` route) and ``basic`` (10, linear algorithms).  When
``coll_monitoring_enable`` is set, ``coll/monitoring.py`` wraps every entry
of the composed table, whichever component won it, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

from ..core import errors
from ..mca import component as mca_component
from ..mca import output as mca_output

COLL_OPS = (
    "allreduce",
    "reduce",
    "bcast",
    "barrier",
    "allgather",
    "allgatherv",
    "alltoall",
    "alltoallv",
    "reduce_scatter",
    "reduce_scatter_block",
    "scan",
    "exscan",
    "gather",
    "scatter",
)

_stream = mca_output.open_stream("coll")


class CollModule:
    """Per-communicator module: attributes named after COLL_OPS entries hold
    callables ``fn(comm, ...)`` or None (op not provided)."""

    def __init__(self, **ops: Callable):
        for name in COLL_OPS:
            setattr(self, name, ops.get(name))


class CollComponent(mca_component.Component):
    framework_name = "coll"

    def comm_query(self, comm) -> CollModule | None:
        """Return a module for this communicator, or None to decline
        (cf. component comm_query in coll_base_comm_select.c)."""
        raise NotImplementedError


def coll_framework() -> mca_component.Framework:
    from .basic import BasicCollComponent
    from .nccl import NcclCollComponent
    from .tuned import TunedCollComponent

    fw = mca_component.build_framework(
        "coll", "collective operations",
        [NcclCollComponent, TunedCollComponent, BasicCollComponent])
    fw.open()
    return fw


def comm_select(comm) -> dict[str, tuple[Callable, str]]:
    """Compose the per-op table for a communicator."""
    fw = coll_framework()
    queried = []
    for comp in fw.admitted():  # descending priority
        mod = comp.comm_query(comm)
        if mod is not None:
            queried.append((comp, mod))
            mca_output.verbose(
                5, _stream, "comm %s: component %s available", comm.name,
                comp.name,
            )
    if not queried:
        raise errors.InternalError(
            f"no coll component available for {comm.name}"
        )
    table: dict[str, tuple[Callable, str]] = {}
    for opname in COLL_OPS:
        for comp, mod in queried:
            fn = getattr(mod, opname, None)
            if fn is not None:
                table[opname] = (fn, comp.name)
                break
    # monitoring interposition (coll/monitoring analog): wrap the composed
    # table so counters see every call regardless of which component won
    from . import monitoring

    if monitoring.enabled():
        table = {
            opname: (monitoring.wrap(opname, fn, comm.name), comp_name)
            for opname, (fn, comp_name) in table.items()
        }
    return table
