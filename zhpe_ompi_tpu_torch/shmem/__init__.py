"""OpenSHMEM-analog PGAS layer (namesake: ``zhpe_ompi_tpu/shmem``).

- :mod:`.memheap` — deterministic first-fit symmetric allocator: the same
  allocation sequence on every PE yields the same offsets.
- :mod:`.api` — the host-plane PE API (put/get/p/g, AMOs, wait_until,
  locks, broadcast/collect/reductions, barrier) over three substrates:
  thread ranks (``direct``), same-host processes over mapped tmpfs
  segments with native atomics (``mmap``, :mod:`.segment`), and any wire
  endpoint over the direct-map osc plane (``am``).
- :mod:`.device` — the device-plane heap (symmetric objects in GPU
  memory, put/get/AMO epochs on DeviceWindow schedules).
- :mod:`.spml` — the transport framework as MCA components with priority
  selection; :func:`shmem_pe` is the spml-selected shmem_init.
"""

from .api import (  # noqa: F401
    ShmemPE,
    shmem_mapped_pe,
    shmem_universe,
    shmem_wire_pe,
)
from .device import DeviceHeap, DevicePE, DeviceSym  # noqa: F401
from .memheap import SymmetricHeapAllocator  # noqa: F401
from .spml import shmem_pe  # noqa: F401
