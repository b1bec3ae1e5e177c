"""memchecker — buffer-definedness checking at API entry (namesake:
``zhpe_ompi_tpu/utils/memchecker.py``; the port's own copy).

Re-design of ``opal/mca/memchecker/valgrind``: the reference annotates
every MPI entry point with valgrind client requests so reads of undefined
send buffers are reported at the API boundary (``ompi/mpi/c/send.c:53-55``).
Without valgrind's shadow memory, the host-plane equivalents of
"undefined" are checkable directly:

- NaN payloads in float buffers (the common "used uninitialized/poisoned
  memory" symptom in numeric code);
- non-contiguous receive views whose writes would be lost.

Off by default (valgrind component is, too); enable with the
``memchecker_enable`` MCA var or ``ZMPI_MCA_memchecker_enable=1``.  Wired
into the host-plane ``isend``.

A torch tensor is checked with torch ops on its own device (a CUDA
tensor's NaN scan runs on the card; nothing is copied to the host).
Numpy arrays and other array-likes are checked as the namesake checks
them; objects ``np.asarray`` cannot take are exempt, as there.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core import errors
from ..mca import var as mca_var

mca_var.register(
    "memchecker_enable", False,
    "Check buffer definedness (NaN poison, layout) at API entry "
    "(memchecker/valgrind analog)",
    type=bool,
)


def enabled() -> bool:
    return bool(mca_var.get("memchecker_enable", False))


def _nan_error(where: str) -> errors.MpiError:
    return errors.MpiError(
        f"{where}: send buffer contains NaN (undefined data?)",
        errclass=errors.ERR_BUFFER,
    )


def check_send_buffer(obj: Any, where: str) -> None:
    """Raise if `obj` looks undefined.  Called at send-side API entry when
    enabled (cf. memchecker annotations in ompi/mpi/c/send.c:53-55)."""
    if not enabled():
        return
    if isinstance(obj, torch.Tensor):
        if (obj.is_floating_point() or obj.is_complex()) and obj.numel() \
                and bool(torch.isnan(obj).any()):
            raise _nan_error(where)
        return
    arr = None
    if isinstance(obj, np.ndarray):
        arr = obj
    else:
        # anything non-arraylike (pickled control messages) is exempt
        try:
            if hasattr(obj, "dtype") and hasattr(obj, "shape"):
                arr = np.asarray(obj)
        except Exception:
            return
    if arr is None:
        return
    if arr.dtype.kind == "f" and arr.size and bool(np.isnan(arr).any()):
        raise _nan_error(where)


def check_recv_buffer(arr: Any, where: str) -> None:
    """Raise if a receive-side target buffer is unusable (the reference
    marks recv buffers addressable-but-undefined; here the checkable
    hazard is a non-contiguous view whose writes would vanish)."""
    if not enabled():
        return
    contiguous = True
    if isinstance(arr, np.ndarray):
        contiguous = bool(arr.flags["C_CONTIGUOUS"])
    elif isinstance(arr, torch.Tensor):
        contiguous = arr.is_contiguous()
    if not contiguous:
        raise errors.MpiError(
            f"{where}: receive buffer is a non-contiguous view; writes "
            "through a flat view would be lost",
            errclass=errors.ERR_BUFFER,
        )
