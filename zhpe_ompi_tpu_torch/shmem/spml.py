"""spml — the SHMEM put/get transport framework (namesake:
``zhpe_ompi_tpu/shmem/spml.py``).

The transports register as MCA components, admission respects
``ZMPI_MCA_spml`` include/exclude lists, and selection is the
highest-priority admitted component that supports the endpoint:

- **device** (prio 100): device communicators, the symmetric heap in GPU
  memory with put/get/AMO epochs on DeviceWindow schedules
  (``shmem/device.py``).
- **direct** (80, thread-universe ranks), **mmap** (60, same-host socket
  ranks) and **am** (40, any wire endpoint): the host-plane transports.
  They are registered by name, so admission and the ``zmpi-info`` listing
  see them, but building one raises ``UnsupportedError``: they need the
  host-plane PE (``shmem/api.py``), which waits for the port's host plane.

``shmem_pe(ep)`` is shmem_init: select and build.  The device transport
returns the epoch-API :class:`~zhpe_ompi_tpu_torch.shmem.device.DeviceHeap`.
"""

from __future__ import annotations

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

    def supports(self, ep) -> bool:
        # unpartitioned communicators over process groups only: a split
        # communicator's schedules would name ranks of one group only
        return hasattr(ep, "pg") and not getattr(ep, "is_partitioned", False)

    def make(self, ep, heap_bytes: int):
        from .device import DeviceHeap

        return DeviceHeap(ep, heap_bytes)


class _HostSpml(SpmlComponent):
    def make(self, ep, heap_bytes: int):
        raise errors.UnsupportedError(
            f"spml '{self.name}' builds a host-plane PE, which needs "
            "shmem/api.py (not ported yet); only the 'device' spml is ported")


class DirectSpml(_HostSpml):
    name = "direct"
    default_priority = 80

    def supports(self, ep) -> bool:
        return _is_thread_ctx(ep)


class MmapSpml(_HostSpml):
    name = "mmap"
    default_priority = 60

    def supports(self, ep) -> bool:
        return _is_wire_ep(ep) and _all_same_host(ep)


class AmSpml(_HostSpml):
    name = "am"
    default_priority = 40

    def supports(self, ep) -> bool:
        return _is_wire_ep(ep)


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
    """shmem_init: the spml-selected PE (collective over the endpoint's
    group).  A device communicator gets a DeviceHeap."""
    return select_spml(ep).make(ep, heap_bytes)
