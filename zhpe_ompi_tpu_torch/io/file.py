"""MPI_File over the datatype engine (namesake: ``zhpe_ompi_tpu/io/file.py``).

Reference anatomy: ``ompi/mca/io/ompio/io_ompio_file_open.c`` (open/modes),
``common_ompio_file_view.c`` (the (disp, etype, filetype) view decode),
``common_ompio_file_read/write.c`` (individual IO through the convertor),
``fcoll/two_phase`` (collective aggregation), ``sharedfp/lockedfile``
(shared pointer).  This module re-designs all four for a single-controller
machine:

- The view's filetype tiles across the file; element byte offsets come from
  the SAME ``byte_index_map`` the message convertor uses — one engine for
  wire and disk, as OMPIO reuses ``opal_convertor``.
- Per-rank individual file pointers and per-rank views live in one File
  object (the controller holds all ranks).
- Collective write_all/read_all computes every rank's (offset, length)
  runs, sorts and coalesces adjacent extents, then issues few large
  pread/pwrite calls — the two-phase optimization without the exchange
  phase (no inter-process data movement exists to optimize away).
- The shared file pointer is an integer under a lock (sharedfp/sm analog).

What the port adds, against the namesake: a buffer written may be a numpy
array or a tensor (:func:`buffer_bytes`: a CUDA tensor is copied to the
host explicitly, a bfloat16 one moves its bits); what is read comes back
as numpy of the etype's dtype, as in the namesake, except for a
``BFLOAT16`` etype, which numpy lacks: that comes back as a CPU bfloat16
tensor (:func:`etype_values`).  Views decode through the port's
``datatype/convertor.byte_index_map``, so the bytes on disk are the
namesake's for the same calls.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..core import errhandler
from ..core import errors
from ..datatype import convertor
from ..datatype.predefined import BYTE, Datatype
from . import fs as fs_mod

MODE_RDONLY = 0x01
MODE_RDWR = 0x02
MODE_WRONLY = 0x04
MODE_CREATE = 0x08
MODE_EXCL = 0x10
MODE_APPEND = 0x20
MODE_DELETE_ON_CLOSE = 0x40


def buffer_bytes(buf) -> np.ndarray:
    """A buffer's bytes as a flat uint8 numpy array: numpy as it lies in
    memory, a CPU tensor as a view of its storage, a tensor on another
    device copied to the host first (any dtype, bfloat16 included)."""
    if isinstance(buf, torch.Tensor):
        t = buf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        return t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(buf).reshape(-1).view(np.uint8)


def _np_dtype(etype):
    """The numpy dtype an etype's values read back as, None for raw
    bytes (a derived etype), or ``torch.bfloat16``."""
    td = getattr(etype, "torch_dtype", None)
    if td is None:
        return None
    if td == torch.bfloat16:
        return td
    return torch.empty(0, dtype=td).numpy().dtype


def etype_values(raw: np.ndarray, etype):
    """File bytes read through a view as the etype's values: numpy of its
    dtype, a CPU bfloat16 tensor for ``BFLOAT16``, raw bytes otherwise."""
    dt = _np_dtype(etype)
    if dt is None:
        return raw
    if dt == torch.bfloat16:
        return torch.from_numpy(raw).view(torch.bfloat16)
    return raw.view(dt)


def _os_flags(mode: int) -> int:
    rw = mode & (MODE_RDONLY | MODE_RDWR | MODE_WRONLY)
    if rw == MODE_RDONLY:
        flags = os.O_RDONLY
    elif rw == MODE_WRONLY:
        flags = os.O_WRONLY
    elif rw == MODE_RDWR:
        flags = os.O_RDWR
    else:
        raise errors.ArgError("exactly one of RDONLY/RDWR/WRONLY required")
    if mode & MODE_CREATE:
        flags |= os.O_CREAT
    if mode & MODE_EXCL:
        flags |= os.O_EXCL
    # MODE_APPEND deliberately does NOT map to O_APPEND: Linux pwrite on an
    # O_APPEND fd ignores its offset, which would corrupt every view-computed
    # write.  MPI_MODE_APPEND means "file pointers start at EOF" — handled
    # in File.__init__.
    return flags


class _View:
    """One rank's (disp, etype, filetype) triple, pre-decoded into the
    byte positions of one filetype tile (common_ompio_file_view.c)."""

    def __init__(self, disp: int, etype: Datatype, filetype: Datatype):
        if filetype.size % max(etype.size, 1) != 0:
            raise errors.TypeError_(
                f"filetype size {filetype.size} is not a multiple of etype "
                f"size {etype.size}"
            )
        self.disp = disp
        self.etype = etype
        self.filetype = filetype
        self.etypes_per_tile = filetype.size // etype.size if etype.size else 0
        # byte positions of one tile's accessible bytes, in pack order
        self.tile_positions = convertor.byte_index_map(filetype, 1)
        self.tile_extent = filetype.extent

    def byte_offsets(self, start_etype: int, count: int) -> np.ndarray:
        """Absolute file byte offsets for `count` etypes starting at etype
        index `start_etype` (int64 array of count*etype.size entries)."""
        esz = self.etype.size
        if count == 0 or esz == 0:
            return np.empty(0, dtype=np.int64)
        e = np.arange(start_etype, start_etype + count, dtype=np.int64)
        tiles = e // self.etypes_per_tile
        within = e % self.etypes_per_tile
        segs = self.tile_positions.reshape(self.etypes_per_tile, esz)
        return (
            self.disp + tiles[:, None] * self.tile_extent + segs[within]
        ).ravel()


class _MappedRequest:
    """Framework request surface (wait/test/done) over an async fbtl
    transfer, with a completion transform applied on the waiter's thread
    (typed view for reads, etype count for writes)."""

    def __init__(self, inner, fn):
        self._inner = inner
        self._fn = fn

    @property
    def done(self) -> bool:
        return self._inner.done

    def test(self):
        flag, value = self._inner.test()
        return (True, self._fn(value)) if flag else (False, None)

    def wait(self, timeout: float | None = None):
        return self._fn(self._inner.wait(timeout))


# Shared nonblocking engine for File and WireFile (MPI_File_iread/iwrite
# over the async fbtl; reference ompi/mpi/c/file_iwrite.c:38 +
# fbtl_posix_ipreadv.c): the SAME MCA-selected fcoll strategy the
# blocking path uses, submitted to the worker pool — one
# sort/coalesce/unpermute engine for both paths.

def iread_offsets(async_fbtl, fcoll, fbtl, fd: int, offsets: np.ndarray,
                  etype):
    inner = async_fbtl.submit(
        lambda: fcoll.read(fbtl, fd, [offsets])[0])
    return _MappedRequest(inner, lambda raw: etype_values(raw, etype))


def iwrite_offsets(async_fbtl, fcoll, fbtl, fd: int, offsets: np.ndarray,
                   data: np.ndarray, count: int):
    # defensive copy: the worker reads `data` later, after this call has
    # returned — the caller is free to reuse its buffer immediately
    data = data.copy()
    inner = async_fbtl.submit(
        lambda: fcoll.write(fbtl, fd, [(offsets, data)]))
    return _MappedRequest(inner, lambda _nbytes: count)


class File(errhandler.HasErrhandler):
    """MPI_File analog; one object serves every rank of `comm`.

    Accepts an MPI_Info of hints (MPI_File_open's info argument); files
    default to MPI_ERRORS_RETURN (the reference's file default)."""

    _default_errhandler = errhandler.ERRORS_RETURN

    def __init__(self, comm, path: str, mode: int = MODE_RDONLY,
                 info=None):
        from ..core import info as info_mod

        self.comm = comm
        self.path = path
        self.mode = mode
        self.info = info_mod.coerce(info)
        self.name = f"file:{path}"
        self._fs = fs_mod.select_fs()
        from . import fbtl as fbtl_mod
        from . import fcoll as fcoll_mod

        self._fbtl = fbtl_mod.select_fbtl()
        self._fcoll = fcoll_mod.select_fcoll()
        self._fd = self._fs.open(path, _os_flags(mode))
        n = comm.size if comm is not None else 1
        self._views = [_View(0, BYTE, BYTE) for _ in range(n)]
        # MPI_MODE_APPEND: all pointers start at EOF (etype = BYTE at open)
        start = self._fs.size(self._fd) if mode & MODE_APPEND else 0
        self._pointers = [start] * n  # individual, in etype units
        self._shared = start  # shared pointer, etype units of rank-0's view
        self._lock = threading.Lock()
        self._closed = False

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        if not self._closed:
            # quiesce in-flight nonblocking IO first: closing the fd
            # under an async transfer would let a recycled fd number
            # receive the stale write (the reference completes pending
            # aio before the fd dies)
            if hasattr(self, "_ifbtl"):
                self._ifbtl.close()
            self._fs.close(self._fd)
            self._closed = True
            if self.mode & MODE_DELETE_ON_CLOSE:
                self._fs.delete(self.path)

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise errors.ArgError("file is closed")

    # -- view (MPI_File_set_view / get_view) ------------------------------

    def set_view(self, disp: int, etype: Datatype,
                 filetype: Datatype | None = None,
                 rank: int | None = None) -> None:
        """Set the view for one rank, or every rank when rank is None (the
        common collective case where all ranks pass the same triple)."""
        self._check_open()
        view = _View(disp, etype, filetype or etype)
        with self._lock:
            if rank is None:
                self._views = [view] * len(self._views)
                self._pointers = [0] * len(self._pointers)
                self._shared = 0
            else:
                self._views[rank] = view
                self._pointers[rank] = 0

    def get_view(self, rank: int = 0) -> tuple[int, Datatype, Datatype]:
        v = self._views[rank]
        return v.disp, v.etype, v.filetype

    # -- byte-level engine ------------------------------------------------

    def _read_offsets(self, offsets: np.ndarray) -> np.ndarray:
        """Single-rank offset read, routed through fcoll -> fbtl (the
        OMPIO layering: strategy schedules, byte-transfer layer moves)."""
        return self._fcoll.read(self._fbtl, self._fd, [offsets])[0]

    def _write_offsets(self, offsets: np.ndarray, data: np.ndarray) -> None:
        self._fcoll.write(self._fbtl, self._fd, [(offsets, data)])

    def _as_bytes(self, buf, view: _View, count: int) -> np.ndarray:
        data = buffer_bytes(buf)
        need = count * view.etype.size
        if data.size < need:
            raise errors.TruncateError(
                f"buffer {data.size}B < {need}B ({count} etypes)"
            )
        return data[:need]

    # -- explicit-offset IO (MPI_File_read_at / write_at) -----------------

    def read_at(self, offset: int, count: int, rank: int = 0) -> np.ndarray:
        """Read `count` etypes at etype-offset `offset` through the rank's
        view; returns an array of the etype's numpy dtype (or raw bytes)."""
        self._check_open()
        v = self._views[rank]
        raw = self._read_offsets(v.byte_offsets(offset, count))
        return etype_values(raw, v.etype)

    def _full_count(self, buf, v: _View) -> int:
        """Etype count of a whole buffer; rejects trailing partial etypes
        (same contract for every write entry point)."""
        nbytes = buffer_bytes(buf).nbytes
        if v.etype.size and nbytes % v.etype.size:
            raise errors.TypeError_(
                f"buffer ({nbytes}B) is not a whole number of etypes "
                f"({v.etype.size}B)"
            )
        return nbytes // v.etype.size if v.etype.size else 0

    def write_at(self, offset: int, buf, count: int | None = None,
                 rank: int = 0) -> int:
        """Write `count` etypes (default: full buffer) at etype-offset
        `offset`; returns etypes written."""
        self._check_open()
        v = self._views[rank]
        if count is None:
            count = self._full_count(buf, v)
        data = self._as_bytes(buf, v, count)
        self._write_offsets(v.byte_offsets(offset, count), data)
        return count

    # -- nonblocking IO (MPI_File_iread/iwrite[_at]) ----------------------
    # Reference: ompi/mpi/c/file_iwrite.c:38 returning an ompio request
    # over the async fbtl (fbtl_posix_ipwritev.c).  The returned request
    # is the framework Request surface (wait/test); IO proceeds on the
    # fbtl worker while the caller computes.

    def _async_fbtl(self):
        from . import fbtl as fbtl_mod

        if not hasattr(self, "_ifbtl"):
            self._ifbtl = fbtl_mod.AsyncFbtl(self._fbtl)
        return self._ifbtl

    def iread_at(self, offset: int, count: int, rank: int = 0):
        """MPI_File_iread_at: request completing with the etype array."""
        self._check_open()
        v = self._views[rank]
        return iread_offsets(self._async_fbtl(), self._fcoll, self._fbtl,
                             self._fd, v.byte_offsets(offset, count),
                             v.etype)

    def iwrite_at(self, offset: int, buf, count: int | None = None,
                  rank: int = 0):
        """MPI_File_iwrite_at: request completing with etypes written."""
        self._check_open()
        v = self._views[rank]
        if count is None:
            count = self._full_count(buf, v)
        return iwrite_offsets(self._async_fbtl(), self._fcoll, self._fbtl,
                              self._fd, v.byte_offsets(offset, count),
                              self._as_bytes(buf, v, count), count)

    def iread(self, count: int, rank: int = 0):
        """MPI_File_iread: nonblocking at the individual pointer (which
        advances immediately, per MPI's nonblocking-pointer contract)."""
        with self._lock:
            off = self._pointers[rank]
            self._pointers[rank] += count
        return self.iread_at(off, count, rank)

    def iwrite(self, buf, count: int | None = None, rank: int = 0):
        v = self._views[rank]
        if count is None:
            count = self._full_count(buf, v)
        with self._lock:
            off = self._pointers[rank]
            self._pointers[rank] += count
        return self.iwrite_at(off, buf, count, rank)

    # -- individual-pointer IO (MPI_File_read / write) --------------------

    def read(self, count: int, rank: int = 0) -> np.ndarray:
        with self._lock:
            off = self._pointers[rank]
            self._pointers[rank] += count
        return self.read_at(off, count, rank)

    def write(self, buf, count: int | None = None, rank: int = 0) -> int:
        v = self._views[rank]
        if count is None:
            count = self._full_count(buf, v)
        with self._lock:
            off = self._pointers[rank]
            self._pointers[rank] += count
        return self.write_at(off, buf, count, rank)

    def seek(self, offset: int, rank: int = 0) -> None:
        with self._lock:
            self._pointers[rank] = offset

    def tell(self, rank: int = 0) -> int:
        with self._lock:
            return self._pointers[rank]

    # -- shared-pointer IO (MPI_File_read/write_shared) -------------------

    def write_shared(self, buf, count: int | None = None) -> int:
        """Atomic fetch-and-add on the shared pointer then write through
        rank 0's view (sharedfp semantics: ordering is first-come)."""
        v = self._views[0]
        if count is None:
            count = self._full_count(buf, v)
        with self._lock:
            off = self._shared
            self._shared += count
        return self.write_at(off, buf, count, rank=0)

    def read_shared(self, count: int) -> np.ndarray:
        with self._lock:
            off = self._shared
            self._shared += count
        return self.read_at(off, count, rank=0)

    # -- collective IO (MPI_File_write_all / read_all) --------------------

    def write_all(self, bufs: list) -> int:
        """Every rank writes its buffer at its individual pointer through
        its view; extents from all ranks are sorted and coalesced into few
        large writes (the fcoll/two_phase aggregation, minus the exchange
        phase a single controller doesn't need).  Returns total etypes."""
        self._check_open()
        if len(bufs) != len(self._views):
            raise errors.ArgError(
                f"need one buffer per rank ({len(self._views)})"
            )
        per_rank, total = self._resolve_write_all(bufs, copy=False)
        # the selected fcoll strategy owns the aggregation shape
        self._fcoll.write(self._fbtl, self._fd, per_rank)
        return total

    def _resolve_write_all(self, bufs: list, copy: bool):
        """Shared write_all/iwrite_all body: per-rank counts, bytes and
        offsets resolved and pointers advanced under one lock (copy=True
        detaches the data for a worker that reads it later)."""
        per_rank, total = [], 0
        with self._lock:
            for r, buf in enumerate(bufs):
                v = self._views[r]
                count = self._full_count(buf, v)
                data = self._as_bytes(buf, v, count)
                offs = v.byte_offsets(self._pointers[r], count)
                self._pointers[r] += count
                per_rank.append((offs, data.copy() if copy else data))
                total += count
        return per_rank, total

    def _resolve_read_all(self, counts: list[int]):
        """Shared read_all/iread_all body: per-rank offsets + dtypes,
        pointers advanced under one lock."""
        offs_list, etypes = [], []
        with self._lock:
            for r, count in enumerate(counts):
                v = self._views[r]
                offs_list.append(v.byte_offsets(self._pointers[r], count))
                self._pointers[r] += count
                etypes.append(v.etype)
        return offs_list, etypes

    # -- nonblocking collective IO (MPI_File_iwrite_all/iread_all) -------
    # Single-controller forms: pointers advance at call time; the whole
    # aggregated pass retires on the async worker (the reference's
    # ompio iread_all over libnbc, collapsed to one submission because
    # no exchange phase exists on a single controller).

    def iwrite_all(self, bufs: list):
        self._check_open()
        if len(bufs) != len(self._views):
            raise errors.ArgError(
                f"need one buffer per rank ({len(self._views)})"
            )
        per_rank, total = self._resolve_write_all(bufs, copy=True)
        inner = self._async_fbtl().submit(
            self._fcoll.write, self._fbtl, self._fd, per_rank)
        return _MappedRequest(inner, lambda _: total)

    def iread_all(self, counts: list[int]):
        self._check_open()
        if len(counts) != len(self._views):
            raise errors.ArgError("need one count per rank")
        offs_list, etypes = self._resolve_read_all(counts)
        inner = self._async_fbtl().submit(
            self._fcoll.read, self._fbtl, self._fd, offs_list)
        return _MappedRequest(inner, lambda raws: [
            etype_values(raw, et) for raw, et in zip(raws, etypes)
        ])

    def read_all(self, counts: list[int]) -> list[np.ndarray]:
        """Collective read: rank r reads counts[r] etypes at its pointer.
        One aggregated pass over the file, then scatter to per-rank
        buffers."""
        self._check_open()
        if len(counts) != len(self._views):
            raise errors.ArgError("need one count per rank")
        per_rank_offs = []
        with self._lock:
            for r, count in enumerate(counts):
                v = self._views[r]
                per_rank_offs.append(v.byte_offsets(self._pointers[r], count))
                self._pointers[r] += count
        raws = self._fcoll.read(self._fbtl, self._fd, per_rank_offs)
        return [etype_values(raw, self._views[r].etype)
                for r, raw in enumerate(raws)]

    # -- size management --------------------------------------------------

    def get_size(self) -> int:
        self._check_open()
        return self._fs.size(self._fd)

    def set_size(self, size: int) -> None:
        self._check_open()
        self._fs.resize(self._fd, size)

    def preallocate(self, size: int) -> None:
        """MPI_File_preallocate: ensure `size` bytes exist."""
        self._check_open()
        if self._fs.size(self._fd) < size:
            self._fs.resize(self._fd, size)

    def sync(self) -> None:
        self._check_open()
        self._fs.sync(self._fd)


def delete(path: str) -> None:
    """MPI_File_delete."""
    fs_mod.select_fs().delete(path)
