"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` into its own shared library, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/lib<name>-<hash>.so <name>.cu

No PyTorch header is compiled, so a build takes seconds where
``torch.utils.cpp_extension.load`` takes minutes.  No ``-lcuda`` either:
the kernels that use TMA reach ``cuTensorMapEncodeTiled`` through
``cudaGetDriverEntryPoint`` (``csrc/sm90.cuh``).  The library's name
carries a hash of its source, of every shared header ``csrc/*.cuh`` and of
the flags, so an edited kernel or header is rebuilt and a stale library is
never loaded.  Libraries go to ``zhpe_ompi_tpu_torch/csrc/_build/``
(listed in ``.gitignore``).  :func:`build` starts one ``nvcc`` per source,
all at once.  Nothing here runs at import time: a module imports this and
calls :func:`load` inside the function that launches its kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .runtime import ztrace

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
KERNEL_SOURCES = ("fused_norm", "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
_thread_counts = threading.local()


def count_launch(fn) -> None:
    """One kernel launch by the wrapper ``fn``: its ``launches`` count
    rises by one under a lock (ranks in threads launch concurrently), and
    so does the calling thread's own tally (:func:`thread_launches`)."""
    with _count_lock:
        fn.launches += 1
    counts = getattr(_thread_counts, "counts", None)
    if counts is None:
        counts = _thread_counts.counts = {}
    counts[fn.__name__] = counts.get(fn.__name__, 0) + 1


def kernel_range(fn):
    """Decorate the kernel wrapper ``fn``: while a ``torch.profiler``
    profile records, each call runs inside a profiler range
    (``runtime/ztrace.profiler_range``) named ``zmpi.kernel.<wrapper>``
    (on the kernel and the plain paths
    alike), which puts the launch beside its kernel in the trace; else a
    call costs one check (``runtime/ztrace.profiler_recording``)."""
    name = f"zmpi.kernel.{fn.__name__}"

    @functools.wraps(fn)
    def ranged(*args, **kwargs):
        if not ztrace.profiler_recording():
            return fn(*args, **kwargs)
        with ztrace.profiler_range(name):
            return fn(*args, **kwargs)

    return ranged


def thread_launches() -> dict[str, int]:
    """The calling thread's kernel launches so far, by wrapper name (a
    rank thread's own launches, whatever the other ranks launch)."""
    return dict(getattr(_thread_counts, "counts", None) or {})
#: nvcc's report (registers, shared memory, spills) of each build this
#: process ran, by source name.
build_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cuda):
        return cuda
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
        "are compiled on first use and need the CUDA toolkit")


def _target(name: str) -> tuple[str, str]:
    """The source of ``name`` and the path of its library, named by a hash
    of the source, of every ``csrc/*.cuh`` header and of the flags."""
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0" + fh.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together.  Returns the seconds each build took
    (0.0 for a library already built).  Raises on any failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    started = {}
    seconds = {}
    for name in names:
        src, out = _target(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed.
    ``signatures`` maps each C function to ``(restype, argtypes)``; they are
    declared once, when the library is first loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_target(name)[1])
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib
