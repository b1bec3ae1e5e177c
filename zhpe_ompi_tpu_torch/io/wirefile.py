"""MPI-IO for multi-process jobs — ompio over the wire plane (namesake:
``zhpe_ompi_tpu/io/wirefile.py``).

``io/file.py`` is the single-controller OMPIO analog (one File object
sees every rank).  This module is the same surface for launcher-started
OS processes, where each rank holds only its own state and coordination
must be explicit — the deployment the reference's ompio actually runs in:

- **individual / explicit-offset IO**: each rank's view maps etype
  offsets to file byte offsets (``_View.byte_offsets``) and pwrites
  through fs/posix — no coordination needed.
- **shared file pointer**: the ``sharedfp/lockedfile`` component
  (``ompi/mca/sharedfp/lockedfile``): the pointer lives in a sidecar
  file next to the data file, and fetch-and-add runs under ``flock`` —
  correct across processes with no server rank.
- **collective IO** (``write_all``/``read_all``): every rank ships its
  (offsets, bytes) run list to an aggregator over the endpoint, which
  drives the SAME fcoll component (two-phase coalescing) the
  single-controller path uses — one aggregation strategy, two planes.

Collective calls are collective over the endpoint's whole group; the
sidecar is created at open and removed at close by rank 0.

What the port adds, against the namesake: buffers and results as in
``io/file.py`` (tensors written, a CUDA one copied to the host; numpy
read back, a CPU bfloat16 tensor for a ``BFLOAT16`` etype).  The sidecar
(``<path>.zshfp``, twenty ASCII digits under ``flock``) and the bytes on
disk are the namesake's, so port and JAX-package ranks of one job share
one file and one shared pointer.  The aggregation exchange rides the
port's host collectives, whose arrays arrive as CPU tensors; they are
taken back to numpy before they meet the fcoll strategy.
"""

from __future__ import annotations

import fcntl
import os

import numpy as np

from ..core import errhandler, errors
from ..core import info as info_mod
from ..datatype import Datatype
from .file import (
    BYTE,
    buffer_bytes,
    etype_values,
    MODE_APPEND,
    MODE_CREATE,
    MODE_DELETE_ON_CLOSE,
    MODE_RDONLY,
    MODE_RDWR,
    MODE_WRONLY,
    _os_flags,
    _View,
)
from . import fbtl as fbtl_mod
from . import fcoll as fcoll_mod
from . import fs as fs_mod


def _np(value) -> np.ndarray:
    """An array the host collectives delivered (a CPU tensor, or numpy
    for a dtype torch lacks) as numpy."""
    import torch

    return value.numpy() if isinstance(value, torch.Tensor) \
        else np.asarray(value)


class _ReservedCtx:
    """Endpoint proxy carrying a privately RESERVED collective-sequence
    window.  Nonblocking collective IO runs its body (gather/alltoall/
    scatter/barrier) on a worker thread, so tags must be drawn at CALL
    time, in program order, exactly like coll/nbc.py's schedules — a
    body drawing from the live endpoint at execution time would race
    any other collective on the same endpoint.  The proxy owns its own
    ``_coll_seq`` (starting at the window reserved by the caller) and
    delegates everything else to the real endpoint."""

    #: seq numbers consumed by ONE collective-IO op on every rank,
    #: regardless of path (write: gather|alltoall; read adds the reply
    #: round) — uniform so all ranks' live counters advance identically
    WINDOW = 4

    def __init__(self, ep, start: int):
        object.__setattr__(self, "_ep", ep)
        object.__setattr__(self, "_coll_seq", start)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_ep"), name)

    def __setattr__(self, name, value):
        if name == "_coll_seq":
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_ep"), name, value)

    @classmethod
    def reserve(cls, ep) -> "_ReservedCtx":
        """Reserve the window on the caller thread (call time)."""
        start = getattr(ep, "_coll_seq", 0)
        ep._coll_seq = start + cls.WINDOW
        return cls(ep, start)

class SharedPointerFile:
    """sharedfp/lockedfile: the shared pointer as ASCII in a sidecar
    file, updated under an exclusive flock."""

    def __init__(self, path: str, create: bool, initial: int = 0):
        self.path = path
        if create:
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                if os.fstat(fd).st_size == 0:
                    os.write(fd, f"{initial:020d}".encode())
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)

    def fetch_add(self, n: int) -> int:
        fd = os.open(self.path, os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            cur = int(os.pread(fd, 20, 0) or b"0")
            os.pwrite(fd, f"{cur + n:020d}".encode(), 0)
            return cur
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def set(self, value: int) -> None:
        fd = os.open(self.path, os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            os.pwrite(fd, f"{value:020d}".encode(), 0)
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def get(self) -> int:
        fd = os.open(self.path, os.O_RDONLY)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            return int(os.pread(fd, 20, 0) or b"0")
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class WireFile(errhandler.HasErrhandler):
    """One rank's handle on a collectively-opened file (MPI_File for
    launcher jobs).  `ep` is the rank's endpoint (TcpProc)."""

    _default_errhandler = errhandler.ERRORS_RETURN

    def __init__(self, ep, path: str, mode: int = MODE_RDONLY, info=None):
        self.ep = ep
        self.path = path
        self.mode = mode
        self.info = info_mod.coerce(info)
        self.name = f"wirefile:{path}"
        self._fs = fs_mod.select_fs()
        self._fbtl = fbtl_mod.select_fbtl()
        self._fcoll = fcoll_mod.select_fcoll()
        # rank 0 creates; the others open the existing file (CREATE/EXCL
        # are collective-open semantics, not per-rank O_CREAT races)
        from .file import MODE_EXCL

        if ep.rank == 0:
            self._fd = self._fs.open(path, _os_flags(mode))
            ep.barrier()
        else:
            ep.barrier()  # file exists (if CREATE) before others open
            self._fd = self._fs.open(
                path, _os_flags(mode & ~(MODE_CREATE | MODE_EXCL)))
        start = self._fs.size(self._fd) if mode & MODE_APPEND else 0
        self._view = _View(0, BYTE, BYTE)
        self._pointer = start
        self._shfp = SharedPointerFile(
            path + ".zshfp", create=(ep.rank == 0), initial=start
        )
        ep.barrier()  # sidecar initialized before any shared-pointer op
        self._closed = False

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        if hasattr(self, "_ifbtl"):
            self._ifbtl.close()  # no async transfer may outlive the fd
        self._fs.close(self._fd)
        self._closed = True
        self.ep.barrier()  # all IO complete before any teardown
        if self.ep.rank == 0:
            self._shfp.unlink()
            if self.mode & MODE_DELETE_ON_CLOSE:
                self._fs.delete(self.path)
        self.ep.barrier()

    def __enter__(self) -> "WireFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise errors.ArgError("file is closed")

    # -- view ------------------------------------------------------------

    def set_view(self, disp: int, etype: Datatype,
                 filetype: Datatype | None = None) -> None:
        """This rank's (disp, etype, filetype); collective by MPI contract
        (every rank calls, each with its own triple)."""
        self._check_open()
        self._view = _View(disp, etype, filetype or etype)
        self._pointer = 0
        self.ep.barrier()
        if self.ep.rank == 0:
            self._shfp.set(0)
        self.ep.barrier()

    def get_view(self) -> tuple[int, Datatype, Datatype]:
        v = self._view
        return v.disp, v.etype, v.filetype

    # -- byte helpers ----------------------------------------------------

    def _as_bytes(self, buf, count: int) -> np.ndarray:
        data = buffer_bytes(buf)
        need = count * self._view.etype.size
        if data.size < need:
            raise errors.TruncateError(
                f"buffer {data.size}B < {need}B ({count} etypes)"
            )
        return data[:need]

    def _full_count(self, buf) -> int:
        nbytes = buffer_bytes(buf).nbytes
        esz = self._view.etype.size
        if esz and nbytes % esz:
            raise errors.TypeError_(
                f"buffer ({nbytes}B) is not a whole number of etypes"
            )
        return nbytes // esz if esz else 0

    # -- explicit offset / individual pointer ----------------------------

    def read_at(self, offset: int, count: int) -> np.ndarray:
        self._check_open()
        offs = self._view.byte_offsets(offset, count)
        raw = self._fcoll.read(self._fbtl, self._fd, [offs])[0]
        return etype_values(raw, self._view.etype)

    def write_at(self, offset: int, buf, count: int | None = None) -> int:
        self._check_open()
        if count is None:
            count = self._full_count(buf)
        data = self._as_bytes(buf, count)
        offs = self._view.byte_offsets(offset, count)
        self._fcoll.write(self._fbtl, self._fd, [(offs, data)])
        return count

    def read(self, count: int) -> np.ndarray:
        off, self._pointer = self._pointer, self._pointer + count
        return self.read_at(off, count)

    def write(self, buf, count: int | None = None) -> int:
        if count is None:
            count = self._full_count(buf)
        off, self._pointer = self._pointer, self._pointer + count
        return self.write_at(off, buf, count)

    def seek(self, offset: int) -> None:
        self._pointer = offset

    def tell(self) -> int:
        return self._pointer

    # -- nonblocking (MPI_File_iread/iwrite[_at]) ------------------------
    # Same async fbtl as the in-process path (file_iwrite.c:38 over
    # fbtl_posix_ipwritev.c): IO retires on a worker thread; the caller
    # overlaps compute and completes through wait/test.

    def _async_fbtl(self):
        if not hasattr(self, "_ifbtl"):
            self._ifbtl = fbtl_mod.AsyncFbtl(self._fbtl)
        return self._ifbtl

    def iread_at(self, offset: int, count: int):
        from .file import iread_offsets

        self._check_open()
        return iread_offsets(self._async_fbtl(), self._fcoll, self._fbtl,
                             self._fd,
                             self._view.byte_offsets(offset, count),
                             self._view.etype)

    def iwrite_at(self, offset: int, buf, count: int | None = None):
        from .file import iwrite_offsets

        self._check_open()
        if count is None:
            count = self._full_count(buf)
        return iwrite_offsets(self._async_fbtl(), self._fcoll, self._fbtl,
                              self._fd,
                              self._view.byte_offsets(offset, count),
                              self._as_bytes(buf, count), count)

    def iread(self, count: int):
        off, self._pointer = self._pointer, self._pointer + count
        return self.iread_at(off, count)

    # -- nonblocking collective IO (MPI_File_iwrite_all/iread_all) -------
    # The reference backs these with libnbc-scheduled collectives
    # (ompi/mca/io/ompio's *_all_begin/_end + iread_all); here the whole
    # collective body (aggregation exchange + fbtl transfers) retires on
    # the async worker while the caller computes — every rank of the
    # group must call it, exactly like the blocking form, and pointers
    # advance at call time per the MPI nonblocking contract.

    def iwrite_all(self, buf, count: int | None = None):
        from .file import _MappedRequest

        self._check_open()
        if count is None:
            count = self._full_count(buf)
        data = self._as_bytes(buf, count).copy()
        offs = self._view.byte_offsets(self._pointer, count)
        self._pointer += count
        ctx = _ReservedCtx.reserve(self.ep)  # tags drawn at CALL time
        inner = self._async_fbtl().submit(
            self._write_all_offsets, offs, data, ctx)
        return _MappedRequest(inner, lambda _: count)

    def iread_all(self, count: int):
        from .file import _MappedRequest

        self._check_open()
        offs = self._view.byte_offsets(self._pointer, count)
        self._pointer += count
        ctx = _ReservedCtx.reserve(self.ep)  # tags drawn at CALL time
        inner = self._async_fbtl().submit(self._read_all_offsets, offs,
                                          ctx)
        return _MappedRequest(inner, lambda raw: raw)

    def iwrite(self, buf, count: int | None = None):
        if count is None:
            count = self._full_count(buf)
        off, self._pointer = self._pointer, self._pointer + count
        return self.iwrite_at(off, buf, count)

    # -- shared pointer (sharedfp/lockedfile) ----------------------------

    def write_shared(self, buf, count: int | None = None) -> int:
        if count is None:
            count = self._full_count(buf)
        off = self._shfp.fetch_add(count)
        return self.write_at(off, buf, count)

    def read_shared(self, count: int) -> np.ndarray:
        off = self._shfp.fetch_add(count)
        return self.read_at(off, count)

    def seek_shared(self, offset: int) -> None:
        """Collective: every rank calls with the same offset."""
        self.ep.barrier()
        if self.ep.rank == 0:
            self._shfp.set(offset)
        self.ep.barrier()

    def tell_shared(self) -> int:
        return self._shfp.get()

    # -- collective IO: fcoll over the endpoint --------------------------
    #
    # Aggregator count = fcoll_wire_aggregators (default 1).  With 1,
    # runs ship to rank 0, which drives the selected fcoll component —
    # the classic two-phase shape.  With A > 1, this is the vulcan shape
    # (ompi/mca/fcoll/vulcan): stripes of fcoll_dynamic_stripe bytes are
    # owned round-robin by A aggregator ranks, every rank alltoalls each
    # stripe's runs to its owner, and the owners write their disjoint
    # stripe sets concurrently (one process each).

    def _num_aggregators(self) -> int:
        from ..mca import var as mca_var

        mca_var.register(
            "fcoll_wire_aggregators", 1,
            "Aggregator ranks for wire-plane collective IO (1 = two-phase "
            "single aggregator; >1 = vulcan stripe-round-robin)",
            type=int,
        )
        return max(1, min(int(mca_var.get("fcoll_wire_aggregators", 1)),
                          self.ep.size))

    def _stripe_owner(self, offs: np.ndarray, naggr: int) -> np.ndarray:
        from ..mca import var as mca_var

        stripe = int(mca_var.get("fcoll_dynamic_stripe", 4 * 1024 * 1024))
        return (offs // stripe) % naggr

    def write_all(self, buf, count: int | None = None) -> int:
        """Collective write at each rank's individual pointer."""
        self._check_open()
        if count is None:
            count = self._full_count(buf)
        data = self._as_bytes(buf, count).copy()
        offs = self._view.byte_offsets(self._pointer, count)
        self._pointer += count
        self._write_all_offsets(offs, data,
                                ctx=_ReservedCtx.reserve(self.ep))
        return count

    def _write_all_offsets(self, offs: np.ndarray, data: np.ndarray,
                           ctx=None) -> None:
        """The collective write body (offsets already resolved): the
        shared engine for write_all and iwrite_all.  ``ctx`` is the
        tag-drawing endpoint view (a _ReservedCtx when running on a
        worker); collectives go through the free functions so the
        reserved sequence window is honored."""
        from ..coll import host as hostc

        ctx = self.ep if ctx is None else ctx
        naggr = self._num_aggregators()
        if naggr == 1:
            gathered = hostc.gather(ctx, (offs, data), root=0)
            if self.ep.rank == 0:
                self._fcoll.write(self._fbtl, self._fd,
                                  [(_np(o), _np(d)) for o, d in gathered])
        else:
            owner = self._stripe_owner(offs, naggr)
            outbox = [
                (offs[owner == a], data[owner == a]) if a < naggr else None
                for a in range(self.ep.size)
            ]
            inbox = hostc.alltoall(ctx, outbox)
            if self.ep.rank < naggr:
                mine = [(_np(p[0]), _np(p[1])) for p in inbox
                        if p is not None]
                self._fcoll.write(self._fbtl, self._fd, mine)
        # completion sync: a token allgather DRAWN FROM THE RESERVED
        # WINDOW — the endpoint's fixed-tag barrier (0x7FFD, no
        # sequence) would cross-match between overlapping nonblocking
        # collective bodies
        hostc.allgather(ctx, 0)

    def read_all(self, count: int) -> np.ndarray:
        """Collective read at each rank's individual pointer."""
        self._check_open()
        offs = self._view.byte_offsets(self._pointer, count)
        self._pointer += count
        return self._read_all_offsets(offs,
                                      ctx=_ReservedCtx.reserve(self.ep))

    def _read_all_offsets(self, offs: np.ndarray, ctx=None) -> np.ndarray:
        """The collective read body (offsets already resolved): the
        shared engine for read_all and iread_all; ``ctx`` as in
        :meth:`_write_all_offsets`."""
        from ..coll import host as hostc

        ctx = self.ep if ctx is None else ctx
        naggr = self._num_aggregators()
        if naggr == 1:
            all_offs = hostc.gather(ctx, offs, root=0)
            if self.ep.rank == 0:
                raws = self._fcoll.read(self._fbtl, self._fd,
                                        [_np(o) for o in all_offs])
                raw = hostc.scatter(ctx, raws, root=0)
            else:
                raw = hostc.scatter(ctx, None, root=0)
            raw = _np(raw)
        else:
            owner = self._stripe_owner(offs, naggr)
            outbox = [
                offs[owner == a] if a < naggr else None
                for a in range(self.ep.size)
            ]
            inbox = hostc.alltoall(ctx, outbox)
            if self.ep.rank < naggr:
                reqs = [_np(o) if o is not None else np.empty(0, np.int64)
                        for o in inbox]
                raws = self._fcoll.read(self._fbtl, self._fd, reqs)
            else:
                raws = [None] * self.ep.size
            back = hostc.alltoall(ctx, raws)
            raw = np.empty(offs.size, dtype=np.uint8)
            for a in range(naggr):
                routed = int((owner == a).sum())
                piece = None if back[a] is None else _np(back[a])
                got = 0 if piece is None else int(piece.size)
                if got != routed:
                    # A short or missing reply must never surface the
                    # uninitialized np.empty bytes as file data.
                    raise errors.TruncateError(
                        f"aggregator {a} returned {got} bytes for "
                        f"{routed} requested"
                    )
                if routed:
                    raw[owner == a] = piece
        return etype_values(raw, self._view.etype)

    # -- size management -------------------------------------------------

    def get_size(self) -> int:
        self._check_open()
        return self._fs.size(self._fd)

    def set_size(self, size: int) -> None:
        """Collective."""
        self._check_open()
        self.ep.barrier()
        if self.ep.rank == 0:
            self._fs.resize(self._fd, size)
        self.ep.barrier()

    def sync(self) -> None:
        """MPI_File_sync: flush this rank then barrier (collective)."""
        self._check_open()
        self._fs.sync(self._fd)
        self.ep.barrier()
