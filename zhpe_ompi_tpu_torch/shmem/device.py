"""Device-plane PGAS: the symmetric heap resident in GPU memory (namesake:
``zhpe_ompi_tpu/shmem/device.py``).

- The **symmetric heap** is a set of per-dtype arenas: on each rank, one
  flat tensor per dtype on the communicator's device (the data never
  leaves it; :meth:`DeviceHeap.read` gathers it for checking).
- **Symmetric allocation** is deterministic: every PE runs the same
  ``shmalloc`` sequence against the same first-fit allocator
  (``memheap.py``), so remote offsets are computed, never exchanged.
- **put/get/AMO epochs** run on :class:`~zhpe_ompi_tpu_torch.osc.spmd_window.DeviceWindow`
  static schedules (the SPMD plane's permute); ``barrier`` is the window
  fence's dissemination barrier.

Target PEs are static per-rank schedules: a ``pe_of`` argument is a list
indexed by rank, an int (every rank the same), or a callable
``f(rank, n_pes) -> target``; ``-1`` means "this rank does not take part".
Every rank runs every operation of an epoch, as under the namesake's
``shard_map``.  Handles are functional, as in the namesake: an operation
returns the updated :class:`DevicePE` and leaves the old one as it was.

Selected through the spml framework at priority 100 ("device"):
``spml.shmem_pe(device_comm)`` returns a :class:`DeviceHeap`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .. import ops as zops
from ..core import errors
from ..osc.spmd_window import DeviceWindow
from .memheap import SymmetricHeapAllocator


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


@dataclass(frozen=True)
class DeviceSym:
    """A symmetric allocation: (arena key, element offset, shape, dtype).
    The same descriptor is valid on every PE."""

    arena: str
    offset: int  # in elements
    shape: tuple
    dtype: Any

    @property
    def elems(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _normalize_pe_of(pe_of, n: int) -> list[int]:
    if callable(pe_of):
        pe_of = [pe_of(r, n) for r in range(n)]
    elif isinstance(pe_of, int):
        pe_of = [pe_of] * n
    pe_of = list(pe_of)
    if len(pe_of) != n:
        raise errors.ArgError(f"pe_of needs {n} entries, got {len(pe_of)}")
    for t in pe_of:
        if not -1 <= t < n:
            raise errors.RankError(f"target PE {t} out of range")
    return pe_of


class DevicePE:
    """The in-epoch handle: the communicator and this PE's arenas."""

    def __init__(self, comm, arenas: dict):
        self.comm = comm
        self.arenas = arenas  # key -> (elems,) tensor

    def my_pe(self) -> int:
        return self.comm.rank

    def n_pes(self) -> int:
        return self.comm.size

    # -- local access ----------------------------------------------------

    def local(self, sym: DeviceSym):
        """This PE's copy of the allocation (a new tensor)."""
        flat = self.arenas[sym.arena]
        return flat[sym.offset:sym.offset + sym.elems].reshape(sym.shape).clone()

    def local_set(self, sym: DeviceSym, value) -> "DevicePE":
        flat = self.arenas[sym.arena]
        val = torch.as_tensor(value, dtype=flat.dtype, device=flat.device).reshape(-1)
        if val.numel() != sym.elems:
            val = val.broadcast_to((sym.elems,))
        new = flat.clone()
        new[sym.offset:sym.offset + sym.elems] = val
        return self._with(sym.arena, new)

    def _with(self, key: str, new_arena) -> "DevicePE":
        arenas = dict(self.arenas)
        arenas[key] = new_arena
        return DevicePE(self.comm, arenas)

    def _window(self, sym: DeviceSym) -> DeviceWindow:
        return DeviceWindow(self.comm, self.arenas[sym.arena])

    def _value(self, sym: DeviceSym, value):
        flat = self.arenas[sym.arena]
        return torch.as_tensor(value, dtype=flat.dtype, device=flat.device)

    # -- RMA epochs ------------------------------------------------------

    def put(self, sym: DeviceSym, value, pe_of) -> "DevicePE":
        """Every rank r puts ``value`` (its local tensor, sym-shaped) into
        PE ``pe_of[r]``'s allocation."""
        n = self.n_pes()
        targets = _normalize_pe_of(pe_of, n)
        val = self._value(sym, value).reshape(-1)
        # bounds against the allocation, not the arena: the window spans
        # the whole arena, so an oversized value would overwrite the next
        # symmetric allocation
        if val.numel() > sym.elems:
            raise errors.ArgError(
                f"put of {val.numel()} elems into allocation of {sym.elems}"
            )
        win = self._window(sym).put(val, targets, [sym.offset] * n)
        return self._with(sym.arena, win.shard)

    def get(self, sym: DeviceSym, pe_of, count: int | None = None,
            offset: int = 0):
        """Every rank r reads PE ``pe_of[r]``'s allocation (or ``count``
        elements at element ``offset`` of it)."""
        n = self.n_pes()
        sources = _normalize_pe_of(pe_of, n)
        cnt = sym.elems if count is None else count
        if not 0 <= offset <= sym.elems or offset + cnt > sym.elems:
            raise errors.ArgError(
                f"get of {cnt} elems at offset {offset} overruns "
                f"allocation of {sym.elems}"
            )
        return self._window(sym).get(
            sources, [sym.offset + offset] * n, cnt)

    def add(self, sym: DeviceSym, value, pe_of, index: int = 0
            ) -> "DevicePE":
        """shmem_atomic_add as a schedule: rank r adds its ``value`` into
        element ``index`` of PE ``pe_of[r]``'s allocation.  Unique targets
        go through ``DeviceWindow.accumulate`` (one permute); colliding
        targets (the "everyone bumps one counter" idiom) through the
        combining form: each rank's contribution in a one-hot length-n
        vector, one allreduce, and each PE adds its own total."""
        n = self.n_pes()
        targets = _normalize_pe_of(pe_of, n)
        if not 0 <= index < sym.elems:
            raise errors.ArgError(
                f"AMO index {index} out of range for allocation of "
                f"{sym.elems} elements"
            )
        if self._has_collision(targets):
            return self._add_combining(sym, value, targets, index)
        val = self._value(sym, value).reshape(1)
        win = self._window(sym).accumulate(
            val, targets, [sym.offset + index] * n)
        return self._with(sym.arena, win.shard)

    def fadd(self, sym: DeviceSym, value, pe_of, index: int = 0):
        """shmem_atomic_fetch_add: returns (old, updated pe).  Unique
        targets read before the add in the same epoch; colliding targets
        fetch in rank order: rank r sees the pre-epoch value plus the
        contributions of lower-ranked PEs to the same target."""
        n = self.n_pes()
        targets = _normalize_pe_of(pe_of, n)
        if self._has_collision(targets):
            old = self._prefix_fetch(sym, value, targets, index)
            return old, self.add(sym, value, targets, index)
        old = self.get(sym, targets, count=1, offset=index)
        return old, self.add(sym, value, targets, index)

    @staticmethod
    def _has_collision(targets: list[int]) -> bool:
        live = [t for t in targets if t >= 0]
        return len(live) != len(set(live))

    def _amo_vectors(self, sym: DeviceSym, value, targets: list[int]):
        """(my rank, my target, active, my contribution): the static
        schedule read at this rank."""
        my = self.comm.rank
        active = targets[my] >= 0
        t = targets[my] if active else 0
        val = self._value(sym, value).reshape(())
        contrib = val if active else torch.zeros_like(val)
        return my, t, active, contrib

    def _add_combining(self, sym: DeviceSym, value, targets: list[int],
                       index: int) -> "DevicePE":
        n = self.n_pes()
        flat = self.arenas[sym.arena]
        my, t, _active, contrib = self._amo_vectors(sym, value, targets)
        onehot = torch.zeros((n,), dtype=flat.dtype, device=flat.device)
        onehot[t] += contrib
        totals = self.comm.allreduce(onehot, zops.SUM)
        new = flat.clone()
        new[sym.offset + index] += totals[my]
        return self._with(sym.arena, new)

    def _prefix_fetch(self, sym: DeviceSym, value, targets: list[int],
                      index: int):
        """The old value rank r observes under rank-order combining: the
        target's pre-epoch element plus the contributions of ranks < r
        aimed at the same target.  Idle (-1) ranks fetch 0."""
        if not 0 <= index < sym.elems:
            raise errors.ArgError(
                f"AMO index {index} out of range for allocation of "
                f"{sym.elems} elements"
            )
        n = self.n_pes()
        my, t, active, contrib = self._amo_vectors(sym, value, targets)
        elem = self.arenas[sym.arena][sym.offset + index]
        both = self.comm.allgather(
            torch.stack([elem.to(contrib.dtype), contrib])[None]).reshape(n, 2)
        elems, vals = both[:, 0], both[:, 1]
        before_me = [r for r in range(my)
                     if targets[r] >= 0 and targets[r] == t]
        prefix = vals[before_me].sum() if before_me else torch.zeros_like(contrib)
        old = (elems[t] + prefix) if active else torch.zeros_like(contrib)
        return old.reshape(1)

    # -- collectives (the scoll analog, on the framework's collectives) --

    def broadcast(self, sym: DeviceSym, root: int = 0) -> "DevicePE":
        """shmem_broadcast: root's instance overwrites every PE's."""
        if not 0 <= root < self.n_pes():
            raise errors.RankError(f"root PE {root} out of range")
        data = self.comm.bcast(self.local(sym), root=root)
        return self.local_set(sym, data)

    def fcollect(self, dest: DeviceSym, src: DeviceSym) -> "DevicePE":
        """shmem_fcollect: every PE's src (equal sizes) concatenated into
        every PE's dest, in PE order."""
        n = self.n_pes()
        if dest.elems != src.elems * n:
            raise errors.CountError(
                f"fcollect dest must hold n_pes * src "
                f"({dest.elems} != {n} * {src.elems})"
            )
        gathered = self.comm.allgather(self.local(src).reshape(-1))
        return self.local_set(dest, gathered.reshape(-1))

    def reduce_to_all(self, dest: DeviceSym, src: DeviceSym, op=None
                      ) -> "DevicePE":
        """shmem_<op>_to_all: elementwise reduction of every PE's src into
        every PE's dest."""
        if dest.elems != src.elems:
            raise errors.CountError("reduce dest/src size mismatch")
        red = self.comm.allreduce(self.local(src),
                                  op if op is not None else zops.SUM)
        return self.local_set(dest, red)

    def alltoall(self, dest: DeviceSym, src: DeviceSym) -> "DevicePE":
        """shmem_alltoall: PE i's block j lands in PE j's block i."""
        n = self.n_pes()
        if src.elems % n or dest.elems != src.elems:
            raise errors.CountError(
                f"alltoall needs equal dest/src with elems divisible "
                f"by {n}"
            )
        moved = self.comm.alltoall(
            self.local(src).reshape(n, src.elems // n))
        return self.local_set(dest, moved.reshape(-1))

    def barrier(self) -> "DevicePE":
        """shmem_barrier_all: the dissemination barrier; no pass over the
        heap (the arenas are handed on as they are)."""
        from ..coll import algorithms as alg

        alg.barrier_dissemination(self.comm)
        return DevicePE(self.comm, dict(self.arenas))


class DeviceHeap:
    """Owner of the symmetric heap on this rank: the allocators, the arena
    tensors and the epoch runner."""

    plane = "device"

    def __init__(self, comm, heap_bytes: int = 1 << 20):
        if getattr(comm, "is_partitioned", False):
            raise errors.CommError(
                "device PGAS requires an unpartitioned communicator "
                "(one group spanning the axis)"
            )
        self.comm = comm
        self.heap_bytes = int(heap_bytes)
        self._allocators: dict[str, SymmetricHeapAllocator] = {}
        self._arenas: dict[str, torch.Tensor] = {}

    # -- symmetric allocation (deterministic; memheap contract) ----------

    def shmalloc(self, shape, dtype, align: int | None = None
                 ) -> DeviceSym:
        """Deterministic symmetric allocation of ``shape`` elements of
        ``dtype`` (a ``torch.dtype`` or a numpy dtype); ``align`` is the
        shmem_align contract.  A dtype's arena (``heap_bytes`` on this
        rank's device) is made at its first allocation."""
        if isinstance(shape, int):
            shape = (shape,)
        dt = _torch_dtype(dtype)
        key = str(dt)
        if key not in self._allocators:
            self._allocators[key] = SymmetricHeapAllocator(self.heap_bytes)
            self._arenas[key] = torch.zeros(
                self.heap_bytes // dt.itemsize, dtype=dt,
                device=self.comm.device)
        nbytes = int(np.prod(shape)) * dt.itemsize
        off_bytes = self._allocators[key].alloc(
            nbytes, align if align else 64)
        return DeviceSym(key, off_bytes // dt.itemsize, tuple(shape), dt)

    def shfree(self, sym: DeviceSym) -> None:
        self._allocators[sym.arena].free(sym.offset * sym.dtype.itemsize)

    # -- epochs ----------------------------------------------------------

    def epoch(self, fn: Callable, *args):
        """Run ``fn(pe, *args) -> (pe, out)`` on every PE and commit the
        updated arenas.  Each of ``args`` is split along dim 0, this rank
        taking its block, and ``out`` (a tensor with a leading dim, or
        None) is gathered along dim 0 from every PE: ``Communicator.run``'s
        form of the namesake's ``shard_map``."""
        from ..runtime import spc

        committed: dict = {}

        def body(*xs):
            pe, out = fn(DevicePE(self.comm, dict(self._arenas)), *xs)
            committed.update(pe.arenas)
            if out is None:
                out = torch.zeros((1, 1), device=self.comm.device)
            return out

        spc.record("pgas_device_epochs")
        out = self.comm.run(body, *args)
        self._arenas = {k: committed[k] for k in self._arenas}
        return out

    def read(self, sym: DeviceSym) -> np.ndarray:
        """Every PE's copy of the allocation, (n,) + shape, on the host
        (the checking path: the data stays on the device otherwise)."""
        mine = self._arenas[sym.arena][sym.offset:sym.offset + sym.elems]
        every = self.comm.allgather(mine[None]).cpu()
        if every.dtype == torch.bfloat16:
            every = every.float()
        return every.numpy().reshape((self.comm.size,) + sym.shape)

    def finalize(self) -> None:
        self._arenas.clear()
        self._allocators.clear()
