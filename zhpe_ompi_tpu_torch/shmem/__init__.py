"""OpenSHMEM-analog PGAS layer (namesake: ``zhpe_ompi_tpu/shmem``).  Ported
so far: the symmetric allocator (``memheap``), the device-plane heap
(``device``) and the spml selection with its ``device`` rung (``spml``).
The host-plane PE (``api``, ``segment``) waits for the host plane."""

from .device import DeviceHeap, DevicePE, DeviceSym  # noqa: F401
from .memheap import SymmetricHeapAllocator  # noqa: F401
from .spml import shmem_pe  # noqa: F401
