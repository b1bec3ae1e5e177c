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

The port adds a window mode, which needs no table composed under the var:
:func:`arm` returns a :class:`Tally` that, until :func:`disarm`, gathers
the calls, payload bytes and host nanoseconds of every collective (or of
those on the given communicators) by operation, at the one dispatch point
every collective passes (``Communicator._coll_call_inner``).  Arming is
refcounted and sets the bare module attribute ``active``, which the
dispatch point checks before paying anything (the ``runtime/ztrace`` and
``runtime/peruse`` discipline): while nothing is armed a call costs one
false boolean.  The tallies feed no SPC counter.
"""

from __future__ import annotations

import threading
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


#: hot-path gate: ``Communicator._coll_call_inner`` checks this bare module
#: attribute; True while any :class:`Tally` is armed
active = False

_arm_lock = threading.Lock()
_armed: list["Tally"] = []


class Tally:
    """Calls, payload bytes and host nanoseconds of the collectives by
    operation (``ops[name] = [calls, bytes, ns]``), from :func:`arm` to
    :func:`disarm`; those on the communicators whose ``cid`` is in
    ``cids`` alone, when given (ranks in threads of one process each count
    their own, and a call from autograd's device thread counts for the
    communicator it runs on)."""

    __slots__ = ("ops", "cids")

    def __init__(self, cids: frozenset | None):
        self.ops: dict[str, list[int]] = {}
        self.cids = cids

    def add(self, opname: str, nbytes: int, ns: int) -> None:
        row = self.ops.get(opname)
        if row is None:
            row = self.ops[opname] = [0, 0, 0]
        row[0] += 1
        row[1] += nbytes
        row[2] += ns

    @property
    def calls(self) -> int:
        return sum(r[0] for r in self.ops.values())

    @property
    def nbytes(self) -> int:
        return sum(r[1] for r in self.ops.values())

    @property
    def host_s(self) -> float:
        return sum(r[2] for r in self.ops.values()) / 1e9


def arm(comms=None) -> Tally:
    """Start a window: a fresh :class:`Tally` that every collective call
    (on one of ``comms`` alone, when given) adds to until :func:`disarm`;
    sets ``active``."""
    global active
    tally = Tally(None if comms is None else frozenset(c.cid for c in comms))
    with _arm_lock:
        _armed.append(tally)
        active = True
    return tally


def disarm(tally: Tally) -> None:
    """End ``tally``'s window; ``active`` falls with the last one."""
    global active
    with _arm_lock:
        if tally in _armed:
            _armed.remove(tally)
        active = bool(_armed)


def armed_count() -> int:
    """Live windows: a test's teardown asserts this is 0 (and ``active``
    False) once every window it opened is closed."""
    with _arm_lock:
        return len(_armed)


def note(opname: str, cid: int, x, ns: int) -> None:
    """One collective call of ``opname`` on the communicator ``cid`` with
    payload ``x``, which held the host ``ns`` nanoseconds, into every
    armed tally it belongs to."""
    nbytes = _nbytes(x)
    with _arm_lock:
        for t in _armed:
            if t.cids is None or cid in t.cids:
                t.add(opname, nbytes, ns)
