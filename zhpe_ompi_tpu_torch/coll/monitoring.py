"""coll/monitoring — transparent collective interposition (namesake:
``zhpe_ompi_tpu/coll/monitoring.py``).

Re-design of the reference's monitoring components (``ompi/mca/coll/
monitoring``, ``ompi/mca/common/monitoring``): when enabled, every
collective call is counted (calls and payload bytes, per operation and per
communicator) before delegating to the real implementation.  Counters land
in the SPC store (``spc.snapshot()``).

PyTorch runs eagerly, so every call is counted (the JAX package counts a
collective once per trace under ``jit``).  The table is wrapped when a
communicator composes it (``coll/framework.comm_select``): set
``coll_monitoring_enable`` before a communicator's first collective.
"""

from __future__ import annotations

from typing import Callable

from ..mca import var as mca_var
from ..runtime import spc
from ..utils.payload import payload_nbytes as _nbytes

mca_var.register(
    "coll_monitoring_enable", False,
    "Interpose monitoring counters on every collective call",
    type=bool,
)


def enabled() -> bool:
    return bool(mca_var.get("coll_monitoring_enable", False))


def wrap(opname: str, fn: Callable, comm_name: str) -> Callable:
    def monitored(comm, x, *args, **kwargs):
        nbytes = _nbytes(x)
        spc.record(f"coll_{opname}_calls", 1)
        spc.record(f"coll_{opname}_bytes", nbytes)
        spc.record(f"comm_{comm_name}_coll_calls", 1)
        return fn(comm, x, *args, **kwargs)

    monitored.__name__ = f"monitored_{opname}"
    return monitored
