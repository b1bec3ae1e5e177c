"""Cross-process shared-memory symmetric heap — the sshmem/mmap component
(namesake: ``zhpe_ompi_tpu/shmem/segment.py``).

The reference's OSHMEM deploys the symmetric heap as a file-backed mapped
segment every PE on the node attaches (``oshmem/mca/sshmem/mmap``), with
AMOs executed natively against the mapping (``oshmem/mca/atomic/basic``).
This module is that design for launcher-started OS processes:

- :class:`MappedSegment` — one PE's heap: a file in ``/dev/shm`` (tmpfs)
  created by its owner, ``mmap``-ed by every other PE of the job.
- :class:`MmapBackend` — the :class:`~zhpe_ompi_tpu_torch.shmem.api.ShmemPE`
  substrate: put/get are direct loads/stores into the peer's mapping (no
  message, no target-side service loop — true shared-memory PGAS), AMOs
  go through the port's ``zompi_shm_amo`` (__atomic builtins, coherent
  across processes; ``native/zompi_native.cpp``, the namesake's entry point
  and codes, so a JAX-package PE's AMOs on the same word are one
  domain) with an ``flock``-serialized fallback when ``native_kernels``
  or ``ZOMPI_NATIVE=0`` select it, and distributed locks are ``flock``
  on per-offset lock files.

Wire-up control (segment-name exchange, barriers, collectives) rides the
TcpProc endpoint — the reference's PMIx/scoll split: data through shared
memory, control out-of-band.

Use :func:`zhpe_ompi_tpu_torch.shmem.api.shmem_mapped_pe` to construct; all
PEs must run on one host (callers on different hosts need the AM backend,
``shmem_wire_pe``).
"""

from __future__ import annotations

import fcntl
import mmap
import os
import secrets
import shutil
import tempfile

import numpy as np

from ..core import errors
from .memheap import SymmetricHeapAllocator

from .. import native as _native_mod

_INT_KINDS = "iu"
_AMO_KIND_CODES = {"add": 0, "swap": 1, "cas": 2, "set": 3, "fetch": 4}
# dtype -> zompi type code: derived from the one authoritative table
_TYPE_CODES = {np.dtype(k): v for k, v in _native_mod.TYPE_CODES.items()}


def _segment_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


class MappedSegment:
    """A file-backed mapped heap segment (one PE's symmetric heap)."""

    def __init__(self, path: str, size: int, create: bool):
        self.path = path
        self.size = size
        self.owner = create
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        self._fd = os.open(path, flags, 0o600)
        if create:
            os.ftruncate(self._fd, size)
        self._mm = mmap.mmap(self._fd, size)
        # writable uint8 view of the whole mapping; .ctypes.data is the
        # mapping base address the native AMOs operate on
        self.array = np.frombuffer(self._mm, dtype=np.uint8)
        self.base = self.array.ctypes.data

    def close(self) -> None:
        if self._mm is not None:
            self.array = None
            try:
                self._mm.close()
            except BufferError:
                # a caller still holds a view from pe.local(); leave the
                # mapping alive (the OS reclaims it at process exit) rather
                # than turning teardown into a crash
                pass
            else:
                os.close(self._fd)
            self._mm = None
            if self.owner:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass


class MmapBackend:
    """ShmemPE substrate over per-PE mapped segments (sshmem/mmap +
    atomic/basic).  Collective construction over the endpoint `ep`."""

    def __init__(self, ep, heap_bytes: int, seg_dir: str | None = None):
        self._ep = ep
        base_dir = seg_dir or _segment_dir()
        token = ep.bcast(
            secrets.token_hex(4) if ep.rank == 0 else None, root=0
        )
        self._lock_dir = os.path.join(base_dir, f"zshm_{token}_locks")
        if ep.rank == 0:
            os.makedirs(self._lock_dir, exist_ok=True)
        my_path = os.path.join(base_dir, f"zshm_{token}_pe{ep.rank}")
        self._segs: list[MappedSegment | None] = [None] * ep.size
        self._segs[ep.rank] = MappedSegment(my_path, heap_bytes, create=True)
        ep.barrier()  # every segment exists and is sized
        for r in range(ep.size):
            if r != ep.rank:
                self._segs[r] = MappedSegment(
                    os.path.join(base_dir, f"zshm_{token}_pe{r}"),
                    heap_bytes, create=False,
                )
        from .. import native

        self._native = native.load()
        self._allocator = SymmetricHeapAllocator(heap_bytes)
        self._lock_fds: dict[int, int] = {}  # offset -> fd holding flock
        self._amo_fallback_fd: int | None = None
        ep.barrier()  # all attached before any RMA can land

    # -- views -----------------------------------------------------------

    def _view(self, sym, pe: int) -> np.ndarray:
        if not 0 <= pe < self._ep.size:
            raise errors.RankError(f"PE {pe} out of range")
        raw = self._segs[pe].array[sym.offset : sym.offset + sym.nbytes]
        return raw.view(sym.dtype).reshape(sym.shape)

    def local_view(self, sym) -> np.ndarray:
        return self._view(sym, self._ep.rank)

    # -- RMA: direct loads/stores into the peer's mapping ----------------

    def put(self, sym, value, pe: int) -> None:
        self._view(sym, pe)[...] = value

    def get(self, sym, pe: int) -> np.ndarray:
        return self._view(sym, pe).copy()

    def p(self, sym, value, pe: int, index: int) -> None:
        self._view(sym, pe).reshape(-1)[index] = value

    def g(self, sym, pe: int, index: int):
        return self._view(sym, pe).reshape(-1)[index].copy()

    def iput(self, sym, values: np.ndarray, pe: int, tst: int,
             sst: int) -> None:
        n = (values.size + sst - 1) // sst
        self._view(sym, pe).reshape(-1)[: n * tst : tst] = values[::sst]

    def iget(self, sym, pe: int, n: int, sst: int) -> np.ndarray:
        return self._view(sym, pe).reshape(-1)[: n * sst : sst].copy()

    def put_nbi(self, sym, value, pe: int) -> None:
        """shmem_put_nbi: mapped stores are coherent once issued, so the
        nonblocking form completes immediately (legal — nbi promises
        completion no later than quiet)."""
        self.put(sym, value, pe)

    def get_nbi(self, sym, pe: int, target: np.ndarray) -> None:
        target.reshape(-1)[...] = self._view(sym, pe).reshape(-1)

    # -- AMOs ------------------------------------------------------------

    def amo(self, sym, kind: str, pe: int, index: int, value=None,
            compare=None):
        if not 0 <= pe < self._ep.size:
            raise errors.RankError(f"PE {pe} out of range")
        dt = sym.dtype
        # Both AMO paths must agree: the native path computes a raw address,
        # so an unchecked index would write outside the symmetric array
        # (silent cross-process corruption), while numpy indexing in the
        # fallback would wrap negatives / raise on overflow.  Validate once
        # here so the semantics cannot diverge.
        n_elems = sym.nbytes // dt.itemsize
        if not 0 <= index < n_elems:
            raise errors.ArgError(
                f"AMO index {index} out of range for symmetric array of "
                f"{n_elems} elements"
            )
        code = _TYPE_CODES.get(dt)
        if self._native is not None and code is not None:
            import ctypes

            addr = self._segs[pe].base + sym.offset + index * dt.itemsize
            vi = ci = 0
            vf = cf = 0.0
            if dt.kind in _INT_KINDS:
                vi = int(value) if value is not None else 0
                ci = int(compare) if compare is not None else 0
            else:
                vf = float(value) if value is not None else 0.0
                cf = float(compare) if compare is not None else 0.0
            oi = ctypes.c_int64(0)
            of = ctypes.c_double(0.0)
            rc = self._native.zompi_shm_amo(
                ctypes.c_void_p(addr), code, _AMO_KIND_CODES[kind],
                vi, ci, vf, cf, ctypes.byref(oi), ctypes.byref(of),
            )
            if rc == 0:
                if dt.kind in _INT_KINDS:
                    # c_int64 readback is signed; reinterpret the bits for
                    # unsigned dtypes (uint64 >= 2**63 comes back negative)
                    old = np.int64(oi.value).astype(dt) if dt.kind == "u" \
                        else dt.type(oi.value)
                    return old
                return dt.type(of.value)
        # fallback: flock-serialized read-modify-write (correct across
        # processes, slower; also the path for exotic dtypes)
        with self._flocked(self._amo_lock_fd()):
            v = self._view(sym, pe).reshape(-1)
            old = v[index].copy()
            if kind == "add":
                v[index] = old + value
            elif kind in ("swap", "set"):
                v[index] = value
            elif kind == "cas":
                # bit comparison, matching the native path's documented
                # CAS-on-bits semantics (-0.0 != 0.0, NaN == same-NaN)
                if old.tobytes() == np.asarray(compare, dt).tobytes():
                    v[index] = value
            elif kind != "fetch":
                raise errors.InternalError(f"unknown AMO {kind!r}")
            return old

    def _amo_lock_fd(self) -> int:
        if self._amo_fallback_fd is None:
            path = os.path.join(self._lock_dir, "amo")
            self._amo_fallback_fd = os.open(path, os.O_RDWR | os.O_CREAT,
                                            0o600)
        return self._amo_fallback_fd

    class _flocked:
        def __init__(self, fd: int):
            self._fd = fd

        def __enter__(self):
            fcntl.flock(self._fd, fcntl.LOCK_EX)

        def __exit__(self, *exc):
            fcntl.flock(self._fd, fcntl.LOCK_UN)

    # -- distributed locks: flock on per-offset lock files ---------------

    def _lock_path(self, offset: int) -> str:
        return os.path.join(self._lock_dir, f"off{offset}")

    def set_lock(self, sym) -> None:
        fd = os.open(self._lock_path(sym.offset), os.O_RDWR | os.O_CREAT,
                     0o600)
        fcntl.flock(fd, fcntl.LOCK_EX)
        self._lock_fds[sym.offset] = fd

    def clear_lock(self, sym) -> None:
        fd = self._lock_fds.pop(sym.offset, None)
        if fd is None:
            raise errors.InternalError("clear_lock without set_lock")
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)

    def test_lock(self, sym) -> bool:
        fd = os.open(self._lock_path(sym.offset), os.O_RDWR | os.O_CREAT,
                     0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        self._lock_fds[sym.offset] = fd
        return True

    # -- symmetric allocation: lockstep allocators + barriers ------------

    def alloc_collective(self, pe_api, nbytes: int,
                         align: int = 64) -> int:
        self._ep.barrier()
        off = self._allocator.alloc(nbytes, align)
        self._ep.barrier()
        return off

    def free_collective(self, pe_api, offset: int) -> None:
        self._ep.barrier()
        self._allocator.free(offset)
        self._ep.barrier()

    def quiet(self) -> None:
        """Stores to the mapping are coherent once issued; a full fence
        orders them against subsequent signaling stores."""
        if self._native is not None:
            self._native.zompi_shm_fence()

    def close(self) -> None:
        self._ep.barrier()
        for seg in self._segs:
            if seg is not None:
                seg.close()
        for fd in self._lock_fds.values():
            os.close(fd)
        self._lock_fds.clear()
        if self._amo_fallback_fd is not None:
            os.close(self._amo_fallback_fd)
            self._amo_fallback_fd = None
        self._ep.barrier()
        if self._ep.rank == 0:
            shutil.rmtree(self._lock_dir, ignore_errors=True)
