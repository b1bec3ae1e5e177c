"""spml — the SHMEM put/get transport framework (namesake:
``zhpe_ompi_tpu/shmem/spml.py``).

The transports register as MCA components, admission respects
``ZMPI_MCA_spml`` include/exclude lists, and selection is the
highest-priority admitted component that supports the endpoint:

- **device** (prio 100): device communicators, the symmetric heap in GPU
  memory with put/get/AMO epochs on DeviceWindow schedules
  (``shmem/device.py``).
- **direct** (80): thread-universe ranks share an address space —
  numpy-view put/get.
- **mmap** (60): socket ranks that are all processes on ONE host —
  mapped tmpfs segments with the port's native atomics
  (``shmem/segment.py``, ``native/zompi_native.cpp``).
- **am** (40): any wire endpoint — the symmetric heap attaches to a
  dynamic window of the direct-map osc plane (``shmem/api.py``'s
  ``_AmBackend`` over ``osc/direct.py``): same-host peers get mapped
  load/store and lock-word AMOs, everything else rides active messages.

``shmem_pe(ep)`` is shmem_init: select, build the backend and wrap it in
a :class:`~zhpe_ompi_tpu_torch.shmem.api.ShmemPE`; the device transport
returns the epoch-API :class:`~zhpe_ompi_tpu_torch.shmem.device.DeviceHeap`.
"""

from __future__ import annotations

import threading

from ..core import errors
from ..mca import component as mca_component

_DEFAULT_HEAP = 1 << 20


def _is_thread_ctx(ep) -> bool:
    return hasattr(ep, "universe")


def _is_wire_ep(ep) -> bool:
    return hasattr(ep, "address_book")


def _all_same_host(ep) -> bool:
    """True when every rank's endpoint address is one host — the mmap
    component's precondition."""
    hosts = {h for h, _ in ep.address_book}
    return len(hosts) == 1


class SpmlComponent(mca_component.Component):
    framework_name = "spml"

    def supports(self, ep) -> bool:
        raise NotImplementedError

    def make(self, ep, heap_bytes: int):
        raise NotImplementedError


class DeviceSpml(SpmlComponent):
    """The fast-fabric spml: symmetric heap in GPU memory.  Highest
    priority: when the endpoint is a device communicator the device plane
    is the point."""

    name = "device"
    default_priority = 100
    wraps_pe = False  # returns the epoch-API DeviceHeap, not a ShmemPE

    def supports(self, ep) -> bool:
        # unpartitioned communicators over process groups only: a split
        # communicator's schedules would name ranks of one group only
        return hasattr(ep, "pg") and not getattr(ep, "is_partitioned", False)

    def make(self, ep, heap_bytes: int):
        from .device import DeviceHeap

        return DeviceHeap(ep, heap_bytes)


class DirectSpml(SpmlComponent):
    name = "direct"
    default_priority = 80

    def supports(self, ep) -> bool:
        return _is_thread_ctx(ep)

    def make(self, ep, heap_bytes: int):
        from .api import _DirectBackend, _ShmemUniverseState

        uni = ep.universe
        # universe-shared state, created once by whichever PE gets here
        # first (construction is collective; the lock makes it exactly
        # one).  The heap size is fixed per universe, like the
        # reference's SHMEM_SYMMETRIC_SIZE: replacing the state would
        # orphan every live PE's symmetric addresses.
        with _universe_lock(uni):
            state = getattr(uni, "_shmem_state", None)
            if state is None:
                state = _ShmemUniverseState(ep.size, heap_bytes)
                uni._shmem_state = state
            elif state.arenas[0].nbytes < heap_bytes:
                raise errors.ArgError(
                    f"symmetric heap is fixed per universe "
                    f"({state.arenas[0].nbytes}B); cannot grow to "
                    f"{heap_bytes}B after first shmem_init"
                )
        return _DirectBackend(ep, state)


_universe_locks: dict[int, threading.Lock] = {}
_universe_guard = threading.Lock()


def _universe_lock(uni) -> threading.Lock:
    with _universe_guard:
        return _universe_locks.setdefault(id(uni), threading.Lock())


class MmapSpml(SpmlComponent):
    name = "mmap"
    default_priority = 60

    def supports(self, ep) -> bool:
        return _is_wire_ep(ep) and _all_same_host(ep)

    def make(self, ep, heap_bytes: int):
        from .segment import MmapBackend

        return MmapBackend(ep, heap_bytes)


class AmSpml(SpmlComponent):
    name = "am"
    default_priority = 40

    def supports(self, ep) -> bool:
        return _is_wire_ep(ep)

    def make(self, ep, heap_bytes: int):
        from .api import _AmBackend

        return _AmBackend(ep, heap_bytes)


def spml_framework() -> mca_component.Framework:
    return mca_component.build_framework(
        "spml", "SHMEM put/get transports",
        (DeviceSpml, DirectSpml, MmapSpml, AmSpml),
    )


def select_spml(ep) -> SpmlComponent:
    """Highest-priority admitted component that supports this endpoint.
    Selection depends only on facts every rank shares (the endpoint's
    type), so every rank picks the same component without negotiation."""
    fw = spml_framework()
    candidates = [
        c for c in fw.admitted() if isinstance(c, SpmlComponent)
        and c.supports(ep)
    ]
    if not candidates:
        raise errors.InternalError(
            f"no spml component supports endpoint {type(ep).__name__} "
            f"(admitted: {[c.name for c in fw.admitted()]})"
        )
    return max(candidates, key=lambda c: c.priority)


def shmem_pe(ep, heap_bytes: int = _DEFAULT_HEAP):
    """shmem_init: spml-selected PE construction (collective over the
    endpoint's group).  Host transports wrap in the imperative ShmemPE;
    a device communicator gets the epoch-API DeviceHeap."""
    from .api import ShmemPE

    comp = select_spml(ep)
    backend = comp.make(ep, heap_bytes)
    if not getattr(comp, "wraps_pe", True):
        return backend
    return ShmemPE(ep, backend)
