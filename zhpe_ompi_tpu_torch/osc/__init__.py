"""One-sided communication (namesake: ``zhpe_ompi_tpu/osc``): host-plane
windows (thread ranks: ``window.HostWindow``; wire endpoints: the
active-message ``am.AmWindow`` and the direct-map ``direct.DirectWindow``
over sm RMA regions) and SPMD device windows (``spmd_window``)."""
from .direct import DirectWindow, allocate_window, create_dynamic_window
from .spmd_window import DeviceWindow
from .window import LOCK_EXCLUSIVE, LOCK_SHARED, HostWindow

__all__ = ["HostWindow", "DeviceWindow", "DirectWindow",
           "allocate_window", "create_dynamic_window",
           "LOCK_SHARED", "LOCK_EXCLUSIVE"]
