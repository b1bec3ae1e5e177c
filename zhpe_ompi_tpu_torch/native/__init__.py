"""Native host kernels (namesake: ``zhpe_ompi_tpu/native``).  Ported so
far: the shared-mapping atomics, ``zompi_shm_amo`` and ``zompi_shm_fence``
(``shm_amo.cpp``), with the namesake's type and operation codes.

They are the atomicity domain of every cross-process word the one-sided
and PGAS planes share: an sm RMA region's lock word (``pt2pt/sm.py``)
and a mapped symmetric heap's AMOs (``shmem/segment.py``).  The JAX
package takes the same words with its own copy of these two functions, so
a region mapped by ranks of both packages has one domain.

:func:`load` compiles ``shm_amo.cpp`` with ``g++`` on first use into
``csrc/_build/`` (beside the CUDA kernels; the library's name carries a
hash of the source and flags) and loads it with ``ctypes``.  The
namesake's switches select the ``flock`` fallback on purpose: the MCA var
``native_kernels`` (``ZMPI_MCA_native_kernels=0``) or ``ZOMPI_NATIVE=0``
make :func:`load` return None.  A build that fails raises: it never falls
back quietly to the other domain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from .._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "shm_amo.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# type codes: the enum of shm_amo.cpp (and of the namesake's
# zompi_native.cpp); the operation codes are its callers' (pt2pt/sm.py,
# shmem/segment.py)
TYPE_CODES = {
    "int8": 0, "uint8": 1, "int16": 2, "uint16": 3, "int32": 4,
    "uint32": 5, "int64": 6, "uint64": 7, "float32": 8, "float64": 9,
}

_lock = threading.Lock()
_loaded = False
lib: ctypes.CDLL | None = None
#: why :func:`load` returned None (a switch), or None when it loaded.
disabled_by: str | None = None


def _so_path() -> str:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libshm_amo-{digest.hexdigest()[:16]}.so")


def _declare(dll: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    dll.zompi_shm_amo.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, i64, i64,
        ctypes.c_double, ctypes.c_double, ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_double),
    ]
    dll.zompi_shm_amo.restype = ctypes.c_int
    dll.zompi_shm_fence.argtypes = []
    dll.zompi_shm_fence.restype = None
    dll.zompi_shm_abi_version.argtypes = []
    dll.zompi_shm_abi_version.restype = ctypes.c_int


def build() -> str:
    """Compile the library if it is missing; returns its path.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    so = _so_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"shm_amo.cpp: g++ did not run: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(
            f"shm_amo.cpp: g++ rc {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent builder never sees a part
    return so


def load() -> ctypes.CDLL | None:
    """The loaded AMO library, built on first use; None when a switch
    selects the ``flock`` domain (``disabled_by`` says which)."""
    global _loaded, lib, disabled_by
    if _loaded:
        return lib
    with _lock:
        if _loaded:
            return lib
        if os.environ.get("ZOMPI_NATIVE", "1") in ("0", "false", "no"):
            disabled_by = "ZOMPI_NATIVE=0"
        else:
            from ..mca import var as mca_var

            enabled = mca_var.register(
                "native_kernels", True,
                "Use the native (C++) host-plane kernels: here the "
                "cross-process atomics of sm RMA regions and mapped "
                "symmetric heaps (0 selects flock critical sections)",
            )
            if not enabled.value:
                disabled_by = "MCA var native_kernels"
            else:
                dll = ctypes.CDLL(build())
                _declare(dll)
                if dll.zompi_shm_abi_version() != 1:
                    raise RuntimeError("shm_amo: ABI version mismatch")
                lib = dll
        _loaded = True
        return lib


def reset() -> None:
    """Forget the load decision, so the next :func:`load` reads the
    switches again (tests that flip ``native_kernels``)."""
    global _loaded, lib, disabled_by
    with _lock:
        _loaded, lib, disabled_by = False, None, None
