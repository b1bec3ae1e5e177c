"""One-sided communication (namesake: ``zhpe_ompi_tpu/osc``).  Ported so
far: the device-plane window (``osc/spmd_window.py``).  The host-plane
windows (``window``, ``am``, ``direct``) wait for the host plane."""

from .spmd_window import DeviceWindow

__all__ = ["DeviceWindow"]
