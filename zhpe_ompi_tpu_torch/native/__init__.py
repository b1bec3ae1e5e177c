"""Native (C++) host kernels and the C ABI shim (namesake:
``zhpe_ompi_tpu/native``; the port's own copies of its sources).

- ``zompi_native.cpp``: the kernel library of the host plane's hot paths,
  a flat C ABI loaded with ``ctypes`` (ABI version 3, the namesake's):
  datatype pack/unpack and the resumable partial packs
  (``datatype/convertor.py``), the reduction table ``zompi_reduce``
  (``ops``), the tag-matching engine ``zompi_match_*``
  (``pt2pt/matching.NativeMatchingEngine``), and the shared-mapping
  atomics ``zompi_shm_amo``/``zompi_shm_fence``, the atomicity domain of
  every cross-process word the one-sided and PGAS planes share (an sm RMA
  region's lock word, ``pt2pt/sm.py``; a mapped symmetric heap's AMOs,
  ``shmem/segment.py``).  The JAX package takes the same words with its own
  copy of these functions, so a region mapped by ranks of both packages has
  one domain.
- ``zompi_mpi.cpp``/``zompi_mpi.h``, ``zompi_shmem.cpp``/``zompi_shmem.h``
  and the PMPI layer ``zompi_pmpi.h``/``zompi_pmpi.inc``: the ``mpi.h`` and
  ``shmem.h`` compatible C ABI over the host plane's wire (the DSS framing
  of ``utils/dss.py``, the modex, the dissemination barrier and the RTS/CTS
  rendezvous of ``pt2pt/tcp.py``, the PMIx store verbs of
  ``runtime/pmix.py``).  A C rank built against it joins a universe of port
  ranks; ``tools/zmpicc.py`` is its wrapper compiler.

Both are compiled by ``g++`` on first use into ``csrc/_build/`` (beside the
CUDA kernels, listed in ``.gitignore``), never into the package directory.
Each library's name carries a hash of its sources, its headers and its
flags, so an edited source is rebuilt and a stale library is never loaded.
One process builds a library at a time (a lock file beside it), into a
temporary file named by pid and thread that is renamed in place.

The namesake's switches select the Python paths on purpose: the MCA var
``native_kernels`` (``ZMPI_MCA_native_kernels=0``) or ``ZOMPI_NATIVE=0``
make :func:`load` return None, and :data:`disabled_by` says which.  A build
that fails raises with the compiler's output: it never falls back quietly.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time

from .._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "zompi_native.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 3

# op / type codes: the enums of zompi_native.cpp (the namesake's)
OP_CODES = {
    "MPI_SUM": 0,
    "MPI_PROD": 1,
    "MPI_MAX": 2,
    "MPI_MIN": 3,
    "MPI_BAND": 4,
    "MPI_BOR": 5,
    "MPI_BXOR": 6,
    "MPI_LAND": 7,
    "MPI_LOR": 8,
    "MPI_LXOR": 9,
}
TYPE_CODES = {
    "int8": 0,
    "uint8": 1,
    "int16": 2,
    "uint16": 3,
    "int32": 4,
    "uint32": 5,
    "int64": 6,
    "uint64": 7,
    "float32": 8,
    "float64": 9,
}

_lock = threading.Lock()
_loaded = False
lib: ctypes.CDLL | None = None
#: why :func:`load` returned None (a switch), or None when it loaded.
disabled_by: str | None = None
#: seconds each library's ``g++`` took in this process, by library
#: ("zompi", "zompi_mpi"); a library found built is not listed.
build_seconds: dict[str, float] = {}


def _hashed_path(stem: str, sources, flags) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{stem}{digest.hexdigest()[:16]}.so")


def _compile(so: str, cmd_head: list[str], sources: list[str],
             cmd_tail: list[str], label: str, key: str) -> str:
    """Run ``g++`` into ``so`` unless it exists.  Other processes wait on
    the library's lock file instead of compiling the same source; the
    output goes to a temporary name (pid and thread) renamed in place."""
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(so + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if os.path.exists(so):
                return so
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    cmd_head + ["-o", tmp] + sources + cmd_tail,
                    capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as exc:
                raise RuntimeError(f"{label}: g++ did not run: {exc}") from exc
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{label}: g++ rc {proc.returncode}:\n{proc.stderr}")
            os.replace(tmp, so)  # atomic: no process sees a partial file
            build_seconds[key] = time.perf_counter() - t0
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return so


def _so_path() -> str:
    return _hashed_path("libzompi-", [_SRC], _FLAGS)


def build() -> str:
    """Compile the kernel library if it is missing; returns its path.
    Raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    return _compile(_so_path(), ["g++", *_FLAGS], [_SRC], [],
                    os.path.basename(_SRC), "zompi")


def _declare(dll: ctypes.CDLL) -> None:
    i64, u64, vp = ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p
    i64p, u64p = ctypes.POINTER(i64), ctypes.POINTER(u64)
    dll.zompi_pack.argtypes = [vp, vp, i64p, i64, i64, i64]
    dll.zompi_pack.restype = None
    dll.zompi_unpack.argtypes = [vp, vp, i64p, i64, i64, i64]
    dll.zompi_unpack.restype = None
    dll.zompi_pack_partial.argtypes = [vp, vp, i64p, i64, i64, i64, i64, i64]
    dll.zompi_pack_partial.restype = i64
    dll.zompi_unpack_partial.argtypes = [vp, i64, vp, i64p, i64, i64, i64, i64]
    dll.zompi_unpack_partial.restype = i64
    dll.zompi_reduce.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp, i64]
    dll.zompi_reduce.restype = ctypes.c_int
    dll.zompi_match_create.argtypes = []
    dll.zompi_match_create.restype = vp
    dll.zompi_match_destroy.argtypes = [vp]
    dll.zompi_match_destroy.restype = None
    dll.zompi_match_post.argtypes = [vp, i64, i64, i64, u64, i64p, u64p]
    dll.zompi_match_post.restype = ctypes.c_int
    dll.zompi_match_incoming.argtypes = [vp, i64, i64, i64, i64, u64, u64p]
    dll.zompi_match_incoming.restype = ctypes.c_int
    dll.zompi_match_probe.argtypes = [vp, i64, i64, i64, i64p]
    dll.zompi_match_probe.restype = ctypes.c_int
    dll.zompi_match_extract.argtypes = [vp, i64, i64, i64, i64p, u64p]
    dll.zompi_match_extract.restype = ctypes.c_int
    dll.zompi_match_stats.argtypes = [vp, i64p, i64p]
    dll.zompi_match_stats.restype = None
    dll.zompi_match_stats_excluding.argtypes = [
        vp, i64p, i64, i64p, i64, i64p, i64p,
    ]
    dll.zompi_match_stats_excluding.restype = None
    dll.zompi_shm_amo.argtypes = [
        vp, ctypes.c_int, ctypes.c_int, i64, i64,
        ctypes.c_double, ctypes.c_double, i64p, ctypes.POINTER(ctypes.c_double),
    ]
    dll.zompi_shm_amo.restype = ctypes.c_int
    dll.zompi_shm_fence.argtypes = []
    dll.zompi_shm_fence.restype = None
    dll.zompi_abi_version.argtypes = []
    dll.zompi_abi_version.restype = ctypes.c_int


def load() -> ctypes.CDLL | None:
    """The loaded kernel library, built on first use; None when a switch
    selects the Python paths (:data:`disabled_by` says which).  A failed
    build raises."""
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
                "Use the native (C++) host-plane kernels for datatype "
                "pack/unpack, reductions, tag matching and the "
                "cross-process atomics of sm RMA regions and mapped "
                "symmetric heaps (0 selects the Python paths and flock "
                "critical sections)",
            )
            if not enabled.value:
                disabled_by = "MCA var native_kernels"
            else:
                dll = ctypes.CDLL(build())
                _declare(dll)
                if dll.zompi_abi_version() != ABI_VERSION:
                    raise RuntimeError("zompi_native: ABI version mismatch")
                lib = dll
        _loaded = True
        return lib


def available() -> bool:
    """True when :func:`load` gives the library (no switch is set)."""
    return load() is not None


def reset() -> None:
    """Forget the load decision, so the next :func:`load` reads the
    switches again (tests that flip ``native_kernels``)."""
    global _loaded, lib, disabled_by
    with _lock:
        _loaded, lib, disabled_by = False, None, None


# -- C ABI shim (zompi_mpi.h + zompi_shmem.h / libzompi_mpi_<hash>.so) ----

_MPI_SRCS = [os.path.join(_HERE, "zompi_mpi.cpp"),
             os.path.join(_HERE, "zompi_shmem.cpp")]
_MPI_HDRS = [os.path.join(_HERE, "zompi_mpi.h"),
             os.path.join(_HERE, "zompi_shmem.h"),
             # the PMPI layer: zompi_mpi.cpp includes the .inc, and user
             # code sees the .h; both key the rebuild hash
             os.path.join(_HERE, "zompi_pmpi.inc"),
             os.path.join(_HERE, "zompi_pmpi.h")]
_MPI_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
# -lrt: shm_open/shm_unlink live in librt on pre-2.34 glibc; linking it
# here keeps zmpicc users free of the dependency (newer glibc ignores it)
_MPI_LIBS = ("-lrt",)


def mpi_shim_path() -> str:
    """Where :func:`build_mpi_shim` puts the shim for these sources."""
    return _hashed_path("libzompi_mpi_", _MPI_SRCS + _MPI_HDRS,
                        _MPI_FLAGS + _MPI_LIBS)


def build_mpi_shim() -> str:
    """Build ``libzompi_mpi_<hash>.so`` (the ``mpi.h`` + ``shmem.h``
    compatible C ABI over the host plane) if it is missing; returns its
    path.  Raises ``RuntimeError`` with the compiler's output on a failed
    build: a C ABI has no Python fallback, and no switch turns it off."""
    return _compile(mpi_shim_path(), ["g++", *_MPI_FLAGS], _MPI_SRCS,
                    list(_MPI_LIBS), "zompi_mpi.cpp", "zompi_mpi")


def mpi_header_dir() -> str:
    """Directory holding ``zompi_mpi.h`` (``-I`` for C users)."""
    return _HERE
