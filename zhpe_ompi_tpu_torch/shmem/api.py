"""OpenSHMEM-analog PE API (reference: ``oshmem/shmem/c``, 56 files;
namesake: ``zhpe_ompi_tpu/shmem/api.py``).

A PE is a rank of either plane, selected the way the reference's spml
framework selects its transport (``oshmem/mca/spml``):

- **direct** (thread universe — the sshmem/mmap analog): every PE maps
  the symmetric heap, so put/get are numpy view writes with per-PE locks
  for the atomics, exactly the shape of ``spml/ucx`` put/get +
  ``atomic/basic`` over a mapped segment.
- **AM over the wire** (TcpProc/DCN — the spml-over-network path): the
  symmetric heap is a local arena attached to an
  :class:`~zhpe_ompi_tpu_torch.osc.am.AmWindow` dynamic window; put/get/AMOs
  are active messages applied by the target's service loop: PGAS does
  not require sharing an address space.

Collectives follow ``scoll/basic`` (linear/binomial over pt2pt) and are
written against the endpoint surface only, so they run over either plane
unchanged — the layering ``scoll/mpi`` gets by riding the MPI collective
stack.

What the port adds, against the namesake: the symmetric heap is host
memory and every value handed back is numpy, as in the namesake; values
put may be tensors (a CUDA one is copied to the host explicitly), and
``get`` takes an ``out=`` tensor (a CUDA one is filled host to card).
Values the port's pt2pt delivers as CPU tensors (the collectives' blocks)
are taken back to numpy before they meet the heap.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..core import errors
from ..mca import var as mca_var
from ..osc.rma_util import deliver, host_array
from ..pt2pt.universe import LocalUniverse, RankContext
from ..runtime import spc
from . import memheap as memheap_mod
from .memheap import SymmetricHeapAllocator

_DEFAULT_HEAP = 1 << 20  # 1 MiB per PE; SHMEM_SYMMETRIC_SIZE analog

mca_var.register(
    "shmem_quiet_timeout", 0.0,
    "Seconds shmem_quiet waits for each pending nonblocking get before "
    "raising (0 = wait forever, the spec's block-until-complete "
    "semantics; positive values trade spec compliance for typed errors "
    "on peer death)",
    type=float,
)


class SymArray:
    """Handle to a symmetric allocation: same offset/shape/dtype on every
    PE.  Valid on any PE of the universe that allocated it."""

    __slots__ = ("offset", "shape", "dtype", "nbytes", "_uni")

    def __init__(self, offset: int, shape: tuple, dtype, nbytes: int, uni):
        self.offset = offset
        self.shape = shape
        self.dtype = np.dtype(dtype)
        self.nbytes = nbytes
        self._uni = uni


class _ShmemUniverseState:
    """Universe-shared: the per-PE heap arenas and their atomic locks."""

    def __init__(self, n_pes: int, heap_bytes: int):
        self.arenas = [
            np.zeros(heap_bytes, dtype=np.uint8) for _ in range(n_pes)
        ]
        self.locks = [threading.RLock() for _ in range(n_pes)]
        # symmetric allocators advance in lockstep (same call sequence on
        # every PE); one shared instance keeps them trivially identical
        self.allocator = SymmetricHeapAllocator(heap_bytes)
        self.alloc_lock = threading.Lock()
        # distributed locks (shmem_set_lock): keyed by symmetric offset
        self.dist_locks: dict[int, threading.RLock] = {}
        self.dist_lock_guard = threading.Lock()


class _DirectBackend:
    """Shared-address-space substrate (sshmem/mmap analog): remote heaps
    are directly addressable numpy views."""

    def __init__(self, ctx: RankContext, state: _ShmemUniverseState):
        self._ctx = ctx
        self._state = state

    def _view(self, sym: SymArray, pe: int) -> np.ndarray:
        if not 0 <= pe < self._ctx.size:
            raise errors.RankError(f"PE {pe} out of range")
        raw = self._state.arenas[pe][sym.offset : sym.offset + sym.nbytes]
        return raw.view(sym.dtype).reshape(sym.shape)

    def local_view(self, sym: SymArray) -> np.ndarray:
        return self._view(sym, self._ctx.rank)

    def put(self, sym: SymArray, value, pe: int) -> None:
        self._view(sym, pe)[...] = value

    def get(self, sym: SymArray, pe: int) -> np.ndarray:
        return self._view(sym, pe).copy()

    def p(self, sym: SymArray, value, pe: int, index: int) -> None:
        self._view(sym, pe).reshape(-1)[index] = value

    def g(self, sym: SymArray, pe: int, index: int):
        return self._view(sym, pe).reshape(-1)[index].copy()

    def iput(self, sym: SymArray, values: np.ndarray, pe: int,
             tst: int, sst: int) -> None:
        n = (values.size + sst - 1) // sst
        self._view(sym, pe).reshape(-1)[: n * tst : tst] = values[::sst]

    def iget(self, sym: SymArray, pe: int, n: int, sst: int) -> np.ndarray:
        return self._view(sym, pe).reshape(-1)[: n * sst : sst].copy()

    def put_nbi(self, sym: SymArray, value, pe: int) -> None:
        """shmem_put_nbi: in-process stores complete immediately — legal,
        since nbi only promises completion no later than quiet."""
        self.put(sym, value, pe)

    def get_nbi(self, sym: SymArray, pe: int, target: np.ndarray) -> None:
        target.reshape(-1)[...] = self._view(sym, pe).reshape(-1)

    def amo(self, sym: SymArray, kind: str, pe: int, index: int,
            value=None, compare=None):
        """Atomic read-modify-write; returns the pre-op value."""
        with self._state.locks[pe]:
            v = self._view(sym, pe).reshape(-1)
            old = v[index].copy()
            if kind == "add":
                v[index] = old + value
            elif kind == "swap":
                v[index] = value
            elif kind == "cas":
                if old == compare:
                    v[index] = value
            elif kind == "set":
                v[index] = value
            elif kind == "fetch":
                pass
            else:
                raise errors.InternalError(f"unknown AMO {kind!r}")
            return old

    # -- distributed locks ------------------------------------------------

    def _dist_lock(self, sym: SymArray) -> threading.RLock:
        with self._state.dist_lock_guard:
            return self._state.dist_locks.setdefault(
                sym.offset, threading.RLock()
            )

    def set_lock(self, sym: SymArray) -> None:
        self._dist_lock(sym).acquire()

    def clear_lock(self, sym: SymArray) -> None:
        self._dist_lock(sym).release()

    def test_lock(self, sym: SymArray) -> bool:
        return self._dist_lock(sym).acquire(blocking=False)

    # -- symmetric allocation ---------------------------------------------

    def alloc_collective(self, pe_api: "ShmemPE", nbytes: int,
                         align: int = memheap_mod.ALIGN) -> int:
        def action():
            with self._state.alloc_lock:
                return self._state.allocator.alloc(nbytes, align)

        return pe_api._rank0_collective(action)

    def free_collective(self, pe_api: "ShmemPE", offset: int) -> None:
        def action():
            with self._state.alloc_lock:
                self._state.allocator.free(offset)

        pe_api._rank0_collective(action)

    def quiet(self) -> None:
        """In-process writes complete immediately."""

    def close(self) -> None:
        """Nothing to tear down: arenas die with the universe."""


class _AmBackend:
    """Wire substrate: the symmetric heap is a local arena attached to
    a dynamic window; remote access is active messages — EXCEPT to
    same-host peers, where the arena is an sm-segment RMA region and
    the whole put/get/``*_nbi``/AMO family rides ``osc/direct.py``'s
    mapped load/store path (the spml seam of the direct-map plane;
    ``osc_direct=0`` forces AM everywhere)."""

    def __init__(self, ep, heap_bytes: int):
        from ..osc.direct import create_dynamic_window

        self._ep = ep
        # (request, target buffer, dtype) of get_nbi ops completing at quiet
        self._pending_gets: list[tuple] = []
        self._win = create_dynamic_window(ep)
        # region-backed when the sm plane is on: the returned arena IS
        # the mapped region's data bytes, so a same-host peer's direct
        # stores and this PE's local loads share one coherent mapping
        base, self.arena = self._win.attach_symmetric(heap_bytes)
        if base != 0:
            raise errors.InternalError(
                "symmetric arena must be the first attachment"
            )
        # every PE runs an identical allocator in lockstep (collective,
        # deterministic call sequence) — the symmetric-address contract
        self._allocator = SymmetricHeapAllocator(heap_bytes)
        ep.barrier()

    def _disp(self, sym: SymArray, index: int = 0) -> int:
        return sym.offset + index * sym.dtype.itemsize

    def local_view(self, sym: SymArray) -> np.ndarray:
        raw = self.arena[sym.offset : sym.offset + sym.nbytes]
        return raw.view(sym.dtype).reshape(sym.shape)

    def put(self, sym: SymArray, value, pe: int) -> None:
        buf = np.empty(sym.shape, sym.dtype)
        buf[...] = value
        self._win.dyn_put(buf, pe, self._disp(sym))

    def get(self, sym: SymArray, pe: int) -> np.ndarray:
        raw = self._win.dyn_get(pe, self._disp(sym), sym.nbytes)
        return raw.view(sym.dtype).reshape(sym.shape).copy()

    def p(self, sym: SymArray, value, pe: int, index: int) -> None:
        buf = np.empty((), sym.dtype)
        buf[...] = value
        self._win.dyn_put(buf, pe, self._disp(sym, index))

    def g(self, sym: SymArray, pe: int, index: int):
        raw = self._win.dyn_get(pe, self._disp(sym, index),
                                sym.dtype.itemsize)
        return raw.view(sym.dtype)[0]

    def iput(self, sym: SymArray, values: np.ndarray, pe: int,
             tst: int, sst: int) -> None:
        self._win.dyn_iput(
            values[::sst].astype(sym.dtype), pe, self._disp(sym), tst
        )

    def iget(self, sym: SymArray, pe: int, n: int, sst: int) -> np.ndarray:
        return self._win.dyn_iget(pe, self._disp(sym), n, sym.dtype, sst)

    def amo(self, sym: SymArray, kind: str, pe: int, index: int,
            value=None, compare=None):
        return self._win.dyn_amo(
            pe, self._disp(sym, index), kind, sym.dtype,
            value=value, compare=compare,
        )

    # -- implicit-handle nonblocking RMA (shmem_put_nbi/get_nbi) ----------

    def put_nbi(self, sym: SymArray, value, pe: int) -> None:
        """shmem_put_nbi: the AM put is already fire-and-forget (payload
        serialized at send time, applied by the target's service loop);
        remote completion is deferred to quiet — exactly the nbi
        contract, so this IS the nonblocking form."""
        self.put(sym, value, pe)

    def get_nbi(self, sym: SymArray, pe: int, target: np.ndarray) -> None:
        """shmem_get_nbi: post the reply recv and return immediately; the
        caller's `target` buffer is filled at quiet (never earlier — the
        deferred scatter makes the completion point deterministic).
        Target validation happens at the ShmemPE dispatch level."""
        req = self._win.dyn_get_nbi(pe, self._disp(sym), sym.nbytes)
        self._pending_gets.append((req, target, sym.dtype))

    # -- distributed locks: home PE 0 arbitrates per-offset ---------------

    def set_lock(self, sym: SymArray) -> None:
        self._win.dist_lock(0, sym.offset)

    def clear_lock(self, sym: SymArray) -> None:
        self._win.dist_unlock(0, sym.offset)

    def test_lock(self, sym: SymArray) -> bool:
        return self._win.dist_trylock(0, sym.offset)

    # -- symmetric allocation ---------------------------------------------

    def alloc_collective(self, pe_api: "ShmemPE", nbytes: int,
                         align: int = memheap_mod.ALIGN) -> int:
        """Every PE advances its own allocator — identical deterministic
        call sequences keep offsets symmetric; the bracketing barriers are
        the shmem_malloc synchronization."""
        self._ep.barrier()
        off = self._allocator.alloc(nbytes, align)
        self._ep.barrier()
        return off

    def free_collective(self, pe_api: "ShmemPE", offset: int) -> None:
        self._ep.barrier()
        self._allocator.free(offset)
        self._ep.barrier()

    def quiet(self) -> None:
        """shmem_quiet: complete pending nbi gets (wait the replies,
        scatter into the callers' buffers), then flush outstanding AM
        puts (ack round-trip).  A failing get must not abandon the rest:
        every pending op is still driven and the put flush still runs;
        the first error re-raises after the drain."""
        # shmem_quiet must block until completion; 0 = wait forever (the
        # spec's semantics), a positive value bounds the wait for jobs
        # preferring typed errors over peer-death hangs
        tmo = float(mca_var.get("shmem_quiet_timeout", 0.0)) or None
        pending, self._pending_gets = self._pending_gets, []
        first_err = None
        for req, target, dt in pending:
            try:
                raw = req.wait(tmo)
                target.reshape(-1)[...] = raw.view(dt)
            except Exception as e:  # noqa: BLE001 — drain must continue
                if first_err is None:
                    first_err = e
        try:
            self._win.flush_all()
        except Exception as e:  # noqa: BLE001
            if first_err is None:
                first_err = e
        if first_err is not None:
            raise first_err

    def close(self) -> None:
        """Collective teardown: free the dynamic window."""
        self._win.free()


class ShmemPE:
    """One PE's API handle — the surface of ``shmem.h``."""

    def __init__(self, ctx, backend):
        self._ctx = ctx
        self._backend = backend

    # -- identity --------------------------------------------------------

    def my_pe(self) -> int:
        return self._ctx.rank

    def n_pes(self) -> int:
        return self._ctx.size

    def finalize(self) -> None:
        """shmem_finalize: collective backend teardown (uniform across
        direct/mmap/am substrates)."""
        self._backend.close()

    # -- symmetric memory ------------------------------------------------

    def _rank0_collective(self, action):
        """Rank 0 runs `action`; the outcome — value or error — is
        broadcast so an allocator failure raises on EVERY PE instead of
        deadlocking the others in recv (collective error agreement)."""
        self.barrier_all()
        if self._ctx.rank == 0:
            try:
                outcome = ("ok", action())
            except errors.MpiError as e:
                outcome = ("err", type(e).__name__, str(e))
            for r in range(1, self._ctx.size):
                self._ctx.send(outcome, dest=r, tag=0x7FF0, cid=0x7FF0)
        else:
            outcome = self._ctx.recv(source=0, tag=0x7FF0, cid=0x7FF0)
        self.barrier_all()
        if outcome[0] == "err":
            cls = getattr(errors, outcome[1], errors.MpiError)
            raise cls(outcome[2])
        return outcome[1]

    def shmalloc(self, shape, dtype=np.float64,
                 align: int | None = None) -> SymArray:
        """Collective symmetric allocation (shmem_malloc: synchronizes
        all PEs; identical offsets fall out of lockstep allocators).
        ``align`` is the shmem_align contract — raise the 64-byte floor
        (e.g. page alignment); the request sequence stays identical on
        every PE, so offsets stay symmetric."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        dt = np.dtype(dtype)
        nbytes = int(np.prod(shape or (1,))) * dt.itemsize
        off = self._backend.alloc_collective(
            self, nbytes, align if align else memheap_mod.ALIGN)
        return SymArray(off, shape, dt, nbytes, self._backend)

    def shfree(self, sym: SymArray) -> None:
        """Collective free."""
        self._backend.free_collective(self, sym.offset)

    def local(self, sym: SymArray) -> np.ndarray:
        """This PE's instance of the symmetric object (writable view)."""
        return self._backend.local_view(sym)

    # -- RMA (spml analog) -----------------------------------------------

    def put(self, sym: SymArray, value, pe: int) -> None:
        """shmem_put: one-sided write of the full object (or a broadcastable
        slice) into the target PE's instance."""
        spc.record("shmem_puts", 1)
        self._backend.put(sym, host_array(value), pe)

    def get(self, sym: SymArray, pe: int, out=None) -> np.ndarray:
        """shmem_get: one-sided read of the target PE's instance (into
        ``out`` when given, a tensor on the card or the CPU)."""
        spc.record("shmem_gets", 1)
        return deliver(self._backend.get(sym, pe), out)

    def p(self, sym: SymArray, value, pe: int, index: int = 0) -> None:
        """shmem_p: single-element put."""
        self._backend.p(sym, host_array(value), pe, index)

    def g(self, sym: SymArray, pe: int, index: int = 0):
        """shmem_g: single-element get."""
        return self._backend.g(sym, pe, index)

    def iput(self, sym: SymArray, values, pe: int, tst: int = 1,
             sst: int = 1) -> None:
        """shmem_iput: strided put (target stride tst, source stride sst)."""
        values = host_array(values).reshape(-1)
        self._backend.iput(sym, values, pe, tst, sst)

    def iget(self, sym: SymArray, pe: int, n: int,
             target: np.ndarray | None = None, tst: int = 1,
             sst: int = 1) -> np.ndarray:
        """shmem_iget: fetch n elements from the remote instance at source
        stride `sst`; when `target` is given, scatter them at target
        stride `tst` (the OpenSHMEM target-stride contract); otherwise
        return them densely."""
        got = self._backend.iget(sym, pe, n, sst)
        if target is None:
            return got
        if not target.flags["C_CONTIGUOUS"]:
            # reshape(-1) on a non-contiguous target returns a COPY and
            # the scattered writes would silently vanish
            raise errors.ArgError(
                "iget target must be C-contiguous (strided writes go "
                "through a flat view)"
            )
        target.reshape(-1)[: n * tst : tst] = got
        return target

    def put_nbi(self, sym: SymArray, value, pe: int) -> None:
        """shmem_put_nbi (``oshmem/shmem/c/shmem_put_nb.c``): implicit-
        handle nonblocking put; completion no later than quiet/barrier_all.
        The source `value` is consumed before return (serialized or
        stored), so the caller may reuse it immediately."""
        spc.record("shmem_puts_nbi", 1)
        self._backend.put_nbi(sym, host_array(value), pe)

    def get_nbi(self, sym: SymArray, pe: int, target: np.ndarray) -> None:
        """shmem_get_nbi (``oshmem/shmem/c/shmem_get_nb.c``): start a
        fetch of PE `pe`'s instance into `target`; `target` contents are
        undefined until quiet/barrier_all.  `target` is an OUT parameter
        and is validated HERE so every backend rejects identically (the
        AMO-dispatch precedent): it must be a writable C-contiguous
        ndarray of the symmetric object's dtype and element count —
        coercion would fill a temporary the caller never sees, and a
        dtype mismatch would fail far away inside quiet."""
        spc.record("shmem_gets_nbi", 1)
        if not isinstance(target, np.ndarray):
            raise errors.ArgError(
                "get_nbi target is an out parameter and must be a numpy "
                f"array, not {type(target).__name__}"
            )
        if target.dtype != sym.dtype or target.nbytes != sym.nbytes:
            raise errors.ArgError(
                f"get_nbi target ({target.dtype}, {target.nbytes}B) does "
                f"not match symmetric object ({sym.dtype}, {sym.nbytes}B)"
            )
        if not target.flags["C_CONTIGUOUS"] or not target.flags["WRITEABLE"]:
            raise errors.ArgError(
                "get_nbi target must be writable and C-contiguous (the "
                "deferred scatter goes through a flat view)"
            )
        self._backend.get_nbi(sym, pe, target)

    def fence(self) -> None:
        """shmem_fence: ordering of puts to each PE — both substrates
        deliver per-origin in order (views / per-connection FIFO)."""

    def quiet(self) -> None:
        """shmem_quiet: completion of all outstanding puts."""
        self._backend.quiet()

    # -- atomics (atomic framework analog) -------------------------------

    def _amo(self, sym: SymArray, kind: str, pe: int, index: int,
             value=None, compare=None):
        """Single AMO dispatch: index bounds are validated HERE so every
        backend (mmap raw-address, AM displacement, direct view) rejects
        out-of-range identically — a backend computing addr/disp from an
        unchecked index would touch a neighboring symmetric allocation."""
        n_elems = sym.nbytes // sym.dtype.itemsize
        if not 0 <= index < n_elems:
            raise errors.ArgError(
                f"AMO index {index} out of range for symmetric array of "
                f"{n_elems} elements"
            )
        if isinstance(value, torch.Tensor):
            value = host_array(value)[()]
        if isinstance(compare, torch.Tensor):
            compare = host_array(compare)[()]
        return self._backend.amo(sym, kind, pe, index, value=value,
                                 compare=compare)

    def atomic_add(self, sym: SymArray, value, pe: int, index: int = 0
                   ) -> None:
        self._amo(sym, "add", pe, index, value=value)

    def atomic_fetch_add(self, sym: SymArray, value, pe: int,
                         index: int = 0):
        return self._amo(sym, "add", pe, index, value=value)

    def atomic_inc(self, sym: SymArray, pe: int, index: int = 0) -> None:
        self.atomic_add(sym, 1, pe, index)

    def atomic_fetch_inc(self, sym: SymArray, pe: int, index: int = 0):
        return self.atomic_fetch_add(sym, 1, pe, index)

    def atomic_swap(self, sym: SymArray, value, pe: int, index: int = 0):
        return self._amo(sym, "swap", pe, index, value=value)

    def atomic_compare_swap(self, sym: SymArray, cond, value, pe: int,
                            index: int = 0):
        return self._amo(sym, "cas", pe, index, value=value, compare=cond)

    def atomic_fetch(self, sym: SymArray, pe: int, index: int = 0):
        return self._amo(sym, "fetch", pe, index)

    def atomic_set(self, sym: SymArray, value, pe: int, index: int = 0
                   ) -> None:
        self._amo(sym, "set", pe, index, value=value)

    # -- point synchronization -------------------------------------------

    def wait_until(self, sym: SymArray, op: str, value, index: int = 0,
                   timeout: float = 10.0) -> None:
        """shmem_wait_until: poll local memory until `local[index] op value`.
        ops: eq, ne, gt, ge, lt, le."""
        import operator

        cmp = {"eq": operator.eq, "ne": operator.ne, "gt": operator.gt,
               "ge": operator.ge, "lt": operator.lt, "le": operator.le}[op]
        deadline = time.monotonic() + timeout
        v = self.local(sym).reshape(-1)
        while not cmp(v[index], value):
            if time.monotonic() > deadline:
                raise errors.InternalError(
                    f"wait_until timed out: {v[index]} {op} {value}"
                )
            # zlint: disable=ZL003 -- shmem_wait_until IS a memory poll by OpenSHMEM spec; timeout-bounded
            time.sleep(0)  # yield to writer threads

    # -- distributed locks -----------------------------------------------

    def set_lock(self, sym: SymArray) -> None:
        """shmem_set_lock on a symmetric lock variable."""
        self._backend.set_lock(sym)

    def clear_lock(self, sym: SymArray) -> None:
        self._backend.clear_lock(sym)

    def test_lock(self, sym: SymArray) -> bool:
        """shmem_test_lock: True if acquired."""
        return self._backend.test_lock(sym)

    # -- collectives (scoll/basic analog) --------------------------------

    def barrier_all(self) -> None:
        """shmem_barrier_all: the OpenSHMEM spec requires completion of
        all outstanding remote updates BEFORE the synchronization — an
        implicit quiet (on the AM backend a put may still be in flight
        when the pt2pt barrier alone completes)."""
        self._backend.quiet()
        self._ctx.barrier()

    def broadcast(self, sym: SymArray, root: int = 0) -> None:
        """shmem_broadcast: root's instance overwrites every PE's."""
        me = self._ctx.rank
        if me == root:
            data = self.local(sym).copy()
            for r in range(self._ctx.size):
                if r != root:
                    self._ctx.send(data, dest=r, tag=0x7FF1, cid=0x7FF0)
        else:
            data = self._ctx.recv(source=root, tag=0x7FF1, cid=0x7FF0)
            self.local(sym)[...] = host_array(data)
        self.barrier_all()

    def fcollect(self, dest: SymArray, src: SymArray) -> None:
        """shmem_fcollect: concatenate every PE's src (equal sizes) into
        every PE's dest, PE order."""
        n = self._ctx.size
        me = self._ctx.rank
        mine = self.local(src).reshape(-1)
        if dest.nbytes != src.nbytes * n:
            raise errors.CountError("fcollect dest must hold n_pes * src")
        out = self.local(dest).reshape(-1)
        chunk = mine.size
        # ring allgather over pt2pt
        block = mine.copy()
        out[me * chunk : (me + 1) * chunk] = block
        for step in range(n - 1):
            src_pe = (me - 1 - step) % n
            block = self._ctx.sendrecv(
                block, dest=(me + 1) % n, source=(me - 1) % n,
                sendtag=0x7F2, recvtag=0x7F2, cid=0x7FF0,
            )
            block = host_array(block)
            out[src_pe * chunk : (src_pe + 1) * chunk] = block
        self.barrier_all()

    def collect(self, dest: SymArray, src: SymArray,
                counts: Sequence[int]) -> None:
        """shmem_collect: variable contribution sizes (counts[pe] elements
        of src used)."""
        n = self._ctx.size
        me = self._ctx.rank
        mine = self.local(src).reshape(-1)[: counts[me]].copy()
        gathered: list[Any] = [None] * n
        gathered[me] = mine
        for step in range(1, n):
            dest_pe = (me + step) % n
            src_pe = (me - step) % n
            got = self._ctx.sendrecv(
                mine, dest=dest_pe, source=src_pe,
                sendtag=0x7F3, recvtag=0x7F3, cid=0x7FF0,
            )
            gathered[src_pe] = host_array(got)
        flat = np.concatenate(gathered)
        self.local(dest).reshape(-1)[: flat.size] = flat
        self.barrier_all()

    def _reduce_to_all(self, dest: SymArray, src: SymArray, fn) -> None:
        """Linear reduce at PE 0 + broadcast — the scoll/basic shape; PE
        order is preserved so non-commutative user extensions stay
        deterministic."""
        n = self._ctx.size
        me = self._ctx.rank
        acc = self.local(src).copy()
        if me == 0:
            for r in range(1, n):
                other = self._ctx.recv(source=r, tag=0x7F4, cid=0x7FF0)
                acc = fn(acc, host_array(other))
            for r in range(1, n):
                self._ctx.send(acc, dest=r, tag=0x7F6, cid=0x7FF0)
        else:
            self._ctx.send(acc, dest=0, tag=0x7F4, cid=0x7FF0)
            acc = host_array(
                self._ctx.recv(source=0, tag=0x7F6, cid=0x7FF0))
        self.local(dest)[...] = acc
        self.barrier_all()

    def sum_to_all(self, dest: SymArray, src: SymArray) -> None:
        self._reduce_to_all(dest, src, np.add)

    def max_to_all(self, dest: SymArray, src: SymArray) -> None:
        self._reduce_to_all(dest, src, np.maximum)

    def min_to_all(self, dest: SymArray, src: SymArray) -> None:
        self._reduce_to_all(dest, src, np.minimum)

    def prod_to_all(self, dest: SymArray, src: SymArray) -> None:
        self._reduce_to_all(dest, src, np.multiply)

    def and_to_all(self, dest: SymArray, src: SymArray) -> None:
        self._reduce_to_all(dest, src, np.bitwise_and)

    def or_to_all(self, dest: SymArray, src: SymArray) -> None:
        self._reduce_to_all(dest, src, np.bitwise_or)

    def xor_to_all(self, dest: SymArray, src: SymArray) -> None:
        self._reduce_to_all(dest, src, np.bitwise_xor)

    def alltoall(self, dest: SymArray, src: SymArray) -> None:
        """shmem_alltoall: block i of src goes to PE i's dest block me."""
        n = self._ctx.size
        me = self._ctx.rank
        s = self.local(src).reshape(n, -1)
        d = self.local(dest).reshape(n, -1)
        d[me] = s[me]
        for step in range(1, n):
            dest_pe = (me + step) % n
            src_pe = (me - step) % n
            got = self._ctx.sendrecv(
                s[dest_pe].copy(), dest=dest_pe, source=src_pe,
                sendtag=0x7F5, recvtag=0x7F5, cid=0x7FF0,
            )
            d[src_pe] = host_array(got)
        self.barrier_all()


def shmem_universe(n_pes: int, heap_bytes: int = _DEFAULT_HEAP
                   ) -> tuple[LocalUniverse, list[ShmemPE]]:
    """Create a PE universe: the shmem analog of
    :func:`zhpe_ompi_tpu_torch.pt2pt.universe.LocalUniverse` construction +
    symmetric-heap attach (shmem_init)."""
    uni = LocalUniverse(n_pes)
    state = _ShmemUniverseState(n_pes, heap_bytes)
    pes = [ShmemPE(ctx, _DirectBackend(ctx, state)) for ctx in uni.contexts]
    return uni, pes


def shmem_wire_pe(ep, heap_bytes: int = _DEFAULT_HEAP) -> ShmemPE:
    """shmem_init over a wire endpoint (TcpProc): collective — every rank
    of the endpoint's group must call it.  The symmetric heap lives in
    this process; remote PEs reach it through the AM window."""
    return ShmemPE(ep, _AmBackend(ep, heap_bytes))


def shmem_mapped_pe(ep, heap_bytes: int = _DEFAULT_HEAP,
                    seg_dir: str | None = None) -> ShmemPE:
    """shmem_init over mapped segments (the sshmem/mmap component):
    collective over a wire endpoint whose ranks are OS processes on ONE
    host.  Every PE's heap is a tmpfs file all others mmap, so put/get
    are direct loads/stores and AMOs are native lock-free atomics on the
    mapping — no service loop in the data path.  Control (wire-up,
    barriers) rides the endpoint."""
    from .segment import MmapBackend

    return ShmemPE(ep, MmapBackend(ep, heap_bytes, seg_dir))
