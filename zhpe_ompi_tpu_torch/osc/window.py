"""One-sided communication (RMA windows) — host plane (namesake:
``zhpe_ompi_tpu/osc/window.py``).

Re-design of ``ompi/mca/osc/rdma`` (SURVEY.md §2.3, §3.5): the reference
drives BTL put/get/atomics directly against registered remote memory
(``osc_rdma_comm.c:98,455,616``).  In the thread-rank universe, every rank's
window buffer IS directly addressable — put/get are memory copies with no
target-side involvement (the literal meaning of RDMA), and accumulate takes
a per-target lock for atomicity (the btl_atomic_op analog).

Synchronization epochs:
- ``fence``   — active target, collective (MPI_Win_fence)
- ``lock/unlock`` — passive target (MPI_Win_lock SHARED/EXCLUSIVE)
- ``post/start/complete/wait_sync`` — PSCW generalized active target

In-process visibility is immediate (stronger than MPI requires); the epoch
calls still enforce the ordering contract so programs written against them
stay correct on the multi-host transport.

What the port adds, against the namesake: window memory is a numpy array
or a CPU tensor (its ``numpy()`` view, so RMA writes land in the
tensor); origin buffers may be tensors, a CUDA one copied to the host
explicitly (:func:`rma_util.host_array`); ``get`` takes an optional
``out=`` tensor (a CUDA one is filled host to card) and otherwise hands
numpy back, as the namesake does; accumulate runs the port's torch ops
on the numpy operands (:func:`rma_util.apply_op`).
"""

from __future__ import annotations

import threading

import numpy as np

from .. import ops as zops
from ..core import errhandler as errh
from ..core import errors
from ..core import info as info_mod
from ..runtime import spc
from . import rma_util

LOCK_SHARED = 1
LOCK_EXCLUSIVE = 2


class _RwLock:
    """Reader-writer lock for passive-target epochs: SHARED holders
    coexist, EXCLUSIVE serializes, FIFO hand-off so writers are not
    starved by a stream of late readers (the AM plane's lock manager
    semantics)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._waiting_writers = 0

    def acquire(self, exclusive: bool) -> None:
        with self._cond:
            if exclusive:
                self._waiting_writers += 1
                self._cond.wait_for(
                    lambda: not self._writer and self._readers == 0
                )
                self._waiting_writers -= 1
                self._writer = True
            else:
                # queue behind any waiting writer (no reader starvation
                # of writers)
                self._cond.wait_for(
                    lambda: not self._writer
                    and self._waiting_writers == 0
                )
                self._readers += 1

    def release(self, exclusive: bool) -> None:
        with self._cond:
            if exclusive:
                self._writer = False
            else:
                self._readers -= 1
            self._cond.notify_all()


class _WinRegistry:
    """Universe-level shared state for one window id."""

    def __init__(self, size: int):
        self.buffers: list[np.ndarray | None] = [None] * size
        # atomic-op serialization (accumulate/CAS): plain mutexes
        self.locks = [threading.RLock() for _ in range(size)]
        # passive-target epochs (MPI_Win_lock): reader-writer semantics
        self.epoch_locks = [_RwLock() for _ in range(size)]
        # dynamic-window state (create_dynamic/attach): per-rank attached
        # regions keyed by displacement (built here, not lazily — lazy init
        # from racing rank threads would clobber attachments)
        self.dynamic: list[dict[int, np.ndarray]] = [
            dict() for _ in range(size)
        ]
        self.dynamic_next = [0] * size
        # PSCW state: per-rank exposure epoch counter (incremented by
        # post) and the identity set of origins completed this epoch
        self.cond = threading.Condition()
        self.post_epochs = [0] * size
        self.completed_by: list[set[int]] = [set() for _ in range(size)]
        self.expected_origins: list[set[int] | None] = [None] * size


class HostWindow(errh.HasErrhandler, rma_util.FetchOpMixin):
    """Per-rank handle to a collectively-created window.

    Windows default to MPI_ERRORS_RETURN (the reference's win default)
    and accept an Info of hints; "no_locks" (an MPI-reserved window key)
    disables the passive-target path."""

    _default_errhandler = errh.ERRORS_RETURN

    _registries: dict[tuple[int, int], _WinRegistry] = {}
    _reg_lock = threading.Lock()
    _next_id = [0]

    @classmethod
    def create(cls, ctx, local_buffer: np.ndarray,
               info=None) -> "HostWindow":
        """MPI_Win_create: collective over the universe."""
        local_buffer = rma_util.window_buffer(local_buffer)
        if not local_buffer.flags["C_CONTIGUOUS"]:
            # reshape(-1) on a non-contiguous array returns a COPY; RMA
            # writes would silently vanish
            raise errors.WinError(
                "window buffer must be C-contiguous (RMA writes go through "
                "a flat view)"
            )
        # collective id agreement: rank 0 allocates, broadcasts over pt2pt
        if ctx.rank == 0:
            with cls._reg_lock:
                win_id = cls._next_id[0]
                cls._next_id[0] += 1
                cls._registries[(id(ctx.universe), win_id)] = _WinRegistry(
                    ctx.size
                )
            for r in range(1, ctx.size):
                ctx.send(win_id, dest=r, tag=0x7FFE, cid=0x7FFE)
        else:
            win_id = ctx.recv(source=0, tag=0x7FFE, cid=0x7FFE)
        reg = cls._registries[(id(ctx.universe), win_id)]
        reg.buffers[ctx.rank] = local_buffer
        ctx.barrier()
        return cls(ctx, win_id, reg, info=info)

    def __init__(self, ctx, win_id: int, reg: _WinRegistry, info=None):
        self.ctx = ctx
        self.win_id = win_id
        self._reg = reg
        self.info = info_mod.coerce(info)
        self.name = f"win{win_id}"
        self._held: dict[int, list[int]] = {}  # target -> lock types held
        self._started: list[int] = []  # PSCW access-epoch targets
        self._seen_post = [0] * ctx.size  # last observed exposure epoch

    # -- communication ---------------------------------------------------

    def _target_buf(self, target: int) -> np.ndarray:
        buf = self._reg.buffers[target]
        if buf is None:
            raise errors.WinError(f"rank {target} has no window buffer")
        return buf

    def put(self, data, target: int, offset: int = 0) -> None:
        """MPI_Put: direct write into the target's window."""
        from ..utils import memchecker

        memchecker.check_send_buffer(data, "MPI_Put")
        data = rma_util.host_array(data)
        buf = self._target_buf(target)
        flat = buf.reshape(-1)
        n = data.size
        if offset < 0 or offset + n > flat.size:
            raise errors.WinError(
                f"put of {n} at {offset} overruns window of {flat.size}"
            )
        spc.record("osc_puts", 1)
        spc.record("osc_bytes_put", int(data.nbytes))
        flat[offset : offset + n] = data.reshape(-1).astype(flat.dtype)

    def get(self, target: int, offset: int = 0, count: int | None = None,
            out=None) -> np.ndarray:
        """MPI_Get: direct read of the target's window (into ``out`` when
        given, see :func:`rma_util.deliver`)."""
        buf = self._target_buf(target).reshape(-1)
        count = buf.size - offset if count is None else count
        if offset < 0 or offset + count > buf.size:
            raise errors.WinError("get overruns window")
        spc.record("osc_gets", 1)
        return rma_util.deliver(buf[offset : offset + count].copy(), out)

    def accumulate(self, data, target: int, offset: int = 0,
                   op: zops.Op = zops.SUM) -> None:
        """MPI_Accumulate: atomic read-modify-write (btl_atomic_op analog:
        per-target lock serializes concurrent accumulates)."""
        from ..utils import memchecker

        memchecker.check_send_buffer(data, "MPI_Accumulate")
        data = rma_util.host_array(data)
        flat = self._target_buf(target).reshape(-1)
        n = data.size
        if offset < 0 or offset + n > flat.size:
            raise errors.WinError("accumulate overruns window")
        with self._reg.locks[target]:
            cur = flat[offset : offset + n]
            flat[offset : offset + n] = rma_util.apply_op(
                op, data.reshape(-1).astype(flat.dtype), cur
            )

    def get_accumulate(self, data, target: int, offset: int = 0,
                       op: zops.Op = zops.SUM) -> np.ndarray:
        """MPI_Get_accumulate: fetch-and-op."""
        from ..utils import memchecker

        memchecker.check_send_buffer(data, "MPI_Get_accumulate")
        data = rma_util.host_array(data)
        flat = self._target_buf(target).reshape(-1)
        n = data.size
        if offset < 0 or offset + n > flat.size:
            raise errors.WinError(
                f"get_accumulate of {n} at {offset} overruns window of "
                f"{flat.size}"
            )
        with self._reg.locks[target]:
            old = flat[offset : offset + n].copy()
            flat[offset : offset + n] = rma_util.apply_op(
                op, data.reshape(-1).astype(flat.dtype), old
            )
        return old

    def compare_and_swap(self, value, compare, target: int, offset: int = 0):
        """MPI_Compare_and_swap (single element)."""
        flat = self._target_buf(target).reshape(-1)
        if not 0 <= offset < flat.size:
            raise errors.WinError(
                f"compare_and_swap offset {offset} outside window of "
                f"{flat.size}"
            )
        with self._reg.locks[target]:
            old = flat[offset].copy()
            if old == compare:
                flat[offset] = value
        return old

    # -- request-based RMA (MPI_Rput/Rget/Raccumulate family) -------------
    # In-process RMA completes immediately (direct memory); the request
    # form exists so programs written against it are portable to the AM
    # plane, where rget/rget_accumulate genuinely overlap.

    def rput(self, data, target: int, offset: int = 0):
        """MPI_Rput."""
        self.put(data, target, offset)
        return rma_util.completed_request()

    def raccumulate(self, data, target: int, offset: int = 0,
                    op: zops.Op = zops.SUM):
        """MPI_Raccumulate."""
        self.accumulate(data, target, offset, op)
        return rma_util.completed_request()

    def rget(self, target: int, offset: int = 0, count: int | None = None):
        """MPI_Rget."""
        return rma_util.completed_request(self.get(target, offset, count))

    def rget_accumulate(self, data, target: int, offset: int = 0,
                        op: zops.Op = zops.SUM):
        """MPI_Rget_accumulate."""
        return rma_util.completed_request(
            self.get_accumulate(data, target, offset, op)
        )

    # -- synchronization -------------------------------------------------

    def fence(self) -> None:
        """MPI_Win_fence: collective epoch boundary."""
        self.ctx.barrier()

    def lock(self, target: int, lock_type: int = LOCK_EXCLUSIVE) -> None:
        """MPI_Win_lock (passive target): genuine reader-writer
        semantics — SHARED holders coexist, EXCLUSIVE serializes."""
        if self.info.get_bool("no_locks"):
            raise errors.WinError(
                "window created with no_locks=true (MPI info assertion)"
            )
        self._reg.epoch_locks[target].acquire(
            lock_type == LOCK_EXCLUSIVE
        )
        self._held.setdefault(target, []).append(lock_type)

    def unlock(self, target: int) -> None:
        held = self._held.get(target)
        if not held:
            raise errors.WinError(f"unlock of {target} without lock")
        lock_type = held.pop()
        self._reg.epoch_locks[target].release(
            lock_type == LOCK_EXCLUSIVE
        )

    def lock_all(self) -> None:
        """MPI_Win_lock_all: shared access epoch at every target; locks are
        taken in rank order so concurrent lock_all calls cannot deadlock."""
        for t in range(self.ctx.size):
            self.lock(t, LOCK_SHARED)

    def unlock_all(self) -> None:
        for t in range(self.ctx.size):
            self.unlock(t)

    def flush(self, target: int | None = None) -> None:
        """MPI_Win_flush: in-process operations are already visible."""

    def flush_all(self) -> None:
        """MPI_Win_flush_all."""

    def flush_local(self, target: int | None = None) -> None:
        """MPI_Win_flush_local."""

    # -- allocation variants ---------------------------------------------

    @classmethod
    def allocate(cls, ctx, nbytes: int, dtype=np.uint8) -> "HostWindow":
        """MPI_Win_allocate: the window owns its buffer."""
        buf = np.zeros(nbytes // np.dtype(dtype).itemsize, dtype)
        win = cls.create(ctx, buf)
        win.base = buf
        return win

    @classmethod
    def allocate_shared(cls, ctx, nbytes: int, dtype=np.uint8
                        ) -> "HostWindow":
        """MPI_Win_allocate_shared: all ranks' buffers are directly
        loadable/storable by every rank (shared_query).  In-process every
        window is already shared; this variant exposes the direct view."""
        win = cls.allocate(ctx, nbytes, dtype)
        win._shared = True
        return win

    def shared_query(self, target: int) -> np.ndarray:
        """MPI_Win_shared_query: the target's buffer for direct load/store
        (only windows from allocate_shared)."""
        if not getattr(self, "_shared", False):
            raise errors.WinError(
                "shared_query requires a window from allocate_shared"
            )
        return self._target_buf(target)

    # -- dynamic windows --------------------------------------------------
    # MPI_Win_create_dynamic + attach/detach (reference: osc/rdma's dynamic
    # region tree, ompi_osc_rdma_attach).  Dynamic windows are
    # BYTE-addressed, as MPI's are (displacements against MPI_BOTTOM):
    # dyn_put writes raw bytes into the target's attached region, dyn_get
    # returns bytes — the window resolves (displacement -> region) and
    # writes through to the user's array, never a copy.

    @classmethod
    def create_dynamic(cls, ctx) -> "HostWindow":
        """MPI_Win_create_dynamic: starts with no memory."""
        win = cls.create(ctx, np.zeros(0, np.uint8))
        win._is_dynamic = True
        return win

    def attach(self, region: np.ndarray) -> int:
        """Attach local memory; returns the displacement other ranks use
        to address it (MPI hands out the raw address; a handle is the safe
        equivalent)."""
        if not getattr(self, "_is_dynamic", False):
            raise errors.WinError("attach requires a dynamic window")
        region = rma_util.window_buffer(region)
        if not region.flags["C_CONTIGUOUS"]:
            raise errors.WinError("attached region must be C-contiguous")
        me = self.ctx.rank
        disp = self._reg.dynamic_next[me]
        self._reg.dynamic_next[me] += max(1, region.nbytes)
        self._reg.dynamic[me][disp] = region
        return disp

    def detach(self, disp: int) -> None:
        regions = self._reg.dynamic[self.ctx.rank]
        if disp not in regions:
            raise errors.WinError(f"no region attached at {disp}")
        del regions[disp]

    def _resolve_dynamic(self, target: int, disp: int, nbytes: int
                         ) -> tuple[np.ndarray, int]:
        for base, region in self._reg.dynamic[target].items():
            if base <= disp and disp + nbytes <= base + region.nbytes:
                return region.reshape(-1).view(np.uint8), disp - base
        raise errors.WinError(
            f"RMA [{disp}, {disp + nbytes}) outside attached regions of "
            f"rank {target}"
        )

    def dyn_put(self, data, target: int, disp: int) -> None:
        """Put into a dynamic window: raw bytes of `data` land at byte
        displacement `disp` of the target's attached memory (write-through
        to the attached array)."""
        raw = np.frombuffer(
            np.ascontiguousarray(rma_util.host_array(data)).tobytes(),
            np.uint8)
        with self._reg.locks[target]:
            view, off = self._resolve_dynamic(target, disp, raw.size)
            view[off : off + raw.size] = raw

    def dyn_get(self, target: int, disp: int, nbytes: int) -> np.ndarray:
        """Get raw bytes from the target's attached memory."""
        with self._reg.locks[target]:
            view, off = self._resolve_dynamic(target, disp, nbytes)
            return view[off : off + nbytes].copy()

    # PSCW generalized active target (MPI_Win_post/start/complete/wait)
    def post(self, origins: list[int] | None = None) -> None:
        """Open an exposure epoch for `origins` (default: all other
        ranks).  The origin IDENTITIES are recorded — wait_sync completes
        only when exactly these origins have completed (counting alone
        would let an uninvited origin satisfy the epoch)."""
        origins = (
            [r for r in range(self.ctx.size) if r != self.ctx.rank]
            if origins is None else list(origins)
        )
        reg = self._reg
        me = self.ctx.rank
        with reg.cond:
            reg.completed_by[me].clear()
            reg.expected_origins[me] = set(origins)
            reg.post_epochs[me] += 1
            reg.cond.notify_all()

    def start(self, targets: list[int], timeout: float = 10.0) -> None:
        """Open an access epoch: wait for each target to post a NEW epoch
        (epoch counters, so back-to-back epochs can't race)."""
        reg = self._reg
        with reg.cond:
            for t in targets:
                if not reg.cond.wait_for(
                    lambda t=t: reg.post_epochs[t] > self._seen_post[t],
                    timeout=timeout,
                ):
                    raise errors.WinError("start: target never posted")
                self._seen_post[t] = reg.post_epochs[t]
        self._started = list(targets)

    def complete(self) -> None:
        """Close the access epoch: notify every started target that this
        origin's RMA operations are done (with the origin's identity)."""
        reg = self._reg
        me = self.ctx.rank
        with reg.cond:
            for t in self._started:
                reg.completed_by[t].add(me)
            reg.cond.notify_all()
        self._started = []

    def wait_sync(self, timeout: float = 10.0) -> None:
        """Close the exposure epoch: block until exactly the posted
        origins have called complete()."""
        reg = self._reg
        me = self.ctx.rank
        with reg.cond:
            expected = reg.expected_origins[me]
            if expected is None:
                raise errors.WinError("wait_sync without a post")
            if not reg.cond.wait_for(
                lambda: expected <= reg.completed_by[me],
                timeout=timeout,
            ):
                missing = expected - reg.completed_by[me]
                raise errors.WinError(
                    f"wait_sync: origins {sorted(missing)} never completed"
                )
            reg.completed_by[me].clear()
            reg.expected_origins[me] = None

    def free(self) -> None:
        """MPI_Win_free: collective; the registry entry is dropped so
        buffers/locks don't leak for the process lifetime."""
        self.ctx.barrier()
        self._reg.buffers[self.ctx.rank] = None
        self.ctx.barrier()
        with HostWindow._reg_lock:
            HostWindow._registries.pop(
                (id(self.ctx.universe), self.win_id), None
            )
