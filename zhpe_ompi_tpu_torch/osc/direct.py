"""Direct-map one-sided plane — sm-segment-backed RMA windows (namesake:
``zhpe_ompi_tpu/osc/direct.py``).

The reference's fabric story is an RDMA/atomics BTL (``opal/mca/btl/ofi``
put/get/atomic verbs feeding ``osc/rdma``): true one-sided transfers
that never wake the target's CPU.  Our AM plane (``osc/am.py``) is the
networked fallback — every ``put`` pays a pack/matching-engine/dispatch
round trip even between same-host ranks that already share demand-mapped
``/dev/shm`` segments.  This module closes that gap:

- **Window creation** (the ``allocate`` path — exactly the path osc/rdma
  prefers, where the window owns its memory) places the backing buffer
  inside an **RMA region** of the owner's sm segment
  (:meth:`~zhpe_ompi_tpu.pt2pt.sm.SmSegment.alloc_rma_region`: its own
  ``<segment>.w<idx>`` file with a lock-word header) and advertises
  ``(boot, region file, dtype, count)`` through a collective descriptor
  exchange at create time.
- **Origins** decide per target, ONCE, by the transport ladder
  (:meth:`TcpProc.sm_direct_to` — the same memoized decision the
  two-sided send seam made): eligible targets are mmap-ed and ``put`` /
  ``get`` execute as direct load/store (ndarray slice assignment; numpy
  handles strided sources natively, the ``pack_frames_into`` staging
  shape).  Cross-host targets, revoked channels, and known-failed peers
  fall back LOUDLY to the unchanged AM path — counted in
  ``osc_am_fallbacks``, never silent.
- **Fetch-atomics** (``accumulate``/``get_accumulate``/
  ``compare_and_swap``/``fetch_and_op``) ride the region header's LOCK
  WORD (native ``__atomic`` CAS + futex park; see
  :class:`~zhpe_ompi_tpu.pt2pt.sm.RmaMapping`).  The target's AM service
  applies ITS atomics under the same word (``osc/am.py::_win_atomic``),
  so mixed-topology windows keep one atomicity domain.
- **Passive target** (``lock``/``unlock``/``lock_all``) maps to the
  shared/exclusive counts in the region header with blocked waiters
  parked on the header's generation FUTEX (the sm doorbell idiom — no
  polling wait).  AM origins lock through the owner's service, which
  grants against the same header words and records queued waiters in
  the header's ``amq`` count; a direct unlock that observes it pokes
  the owner with a ``lock_scan`` AM.
- **FT coexistence** follows the sm plane's contract: peer death unmaps
  the dead rank's region via a ``FailureState`` failure listener and
  RECOVERS its lock-word contribution (held mutex, shared count, writer
  word, waiting-writer slot) at classification —
  :meth:`RmaMapping.recover_dead`; ``sever()`` leaves files in place
  (the crash contract; the final harness close owns the sweep).

``shmem/api.py``'s wire backend rides the same seam through
:meth:`DirectWindow.attach_symmetric`: the symmetric heap arena is a
region, so the ``shmem_put``/``shmem_get``/``*_nbi`` family and the
typed AMOs get the direct path for free.

Counters (``runtime/spc.py``): ``osc_direct_puts`` / ``osc_direct_gets``
/ ``osc_direct_atomics`` / ``osc_direct_bytes`` rise on the direct path;
``osc_am_fallbacks`` counts direct-capable windows routing an op to AM.
The OSU ``--plane osc`` ladder gates on direct bytes strictly rising
while ``osc_am_applied`` and wire ``tcp_bytes_sent`` stay flat.

What the port adds, against the namesake: the region files, their header
and their lock word are the namesake's (``pt2pt/sm.py``; the lock word's
CAS is the port's ``native/zompi_native.cpp``), so a JAX-package origin
maps a port-owned window and the reverse; origin buffers may be tensors
(a CUDA one copied to the host explicitly), ``get`` and
:func:`window_bcast` take an ``out=`` tensor (a CUDA one is filled host
to card from the mapped load), and accumulate runs the port's torch ops
on the mapped numpy view (:func:`rma_util.apply_op`).
"""

from __future__ import annotations

import os

import numpy as np

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..pt2pt import sm as sm_mod
from ..runtime import spc
from ..utils import lockdep
from . import rma_util
from .am import (
    AM_CID,
    LOCK_EXCLUSIVE,
    AmService,
    AmWindow,
    _AmWinState,
)

_stream = mca_output.open_stream("osc_direct")

mca_var.register(
    "osc_direct", 1,
    "Direct-map one-sided plane: 1 = back allocated windows and "
    "symmetric heaps with sm-segment RMA regions and run same-host "
    "put/get/atomics as direct load/store against the mapped region "
    "(lock-word atomics, futex passive-target locks), 0 = route every "
    "window through the active-message plane (the forced-AM reference "
    "mode the OSU osc ladder's byte-identical gate runs)",
    type=int,
)


def direct_enabled() -> bool:
    return bool(int(mca_var.get("osc_direct", 1)))


class _DirectTarget:
    """One origin's direct view of one target's region: the mapping
    plus the window-typed flat view (dtype comes from the TARGET's
    descriptor — matching the AM plane's target-side cast)."""

    __slots__ = ("mapping", "flat")

    def __init__(self, mapping: sm_mod.RmaMapping, dtype):
        self.mapping = mapping
        self.flat = mapping.view(dtype)


class DirectWindow(AmWindow):
    """AmWindow with a per-target direct-map fast path.

    The AM plane stays the universal substrate — every window is
    registered with the owner's service, so a MIXED topology (some
    origins direct, some AM) needs no negotiation: each origin simply
    maps what it can reach and sends the rest.  All counters split
    accordingly."""

    def __init__(self, ep, svc: AmService, win_id: int, st: _AmWinState,
                 local_buffer: np.ndarray, info=None):
        super().__init__(ep, svc, win_id, st, local_buffer, info=info)
        self._region: sm_mod.RmaRegion | None = None
        self._descs: list = [None] * ep.size
        self._maps: dict[int, _DirectTarget | None] = {}
        self._dlock = lockdep.lock("osc.DirectWindow._dlock")
        self._listener_armed = False
        self._enabled = direct_enabled()
        # symmetric-heap (dynamic-window) direct state
        self._sym: tuple[int, int, sm_mod.RmaRegion | None] | None = None
        self._sym_descs: list = []
        self._sym_maps: dict[int, sm_mod.RmaMapping | None] = {}

    # -- creation ---------------------------------------------------------

    @classmethod
    def create(cls, ep, local_buffer: np.ndarray, info=None,
               region: sm_mod.RmaRegion | None = None) -> "DirectWindow":
        """MPI_Win_create, collective: the AmWindow registration plus
        the region-descriptor allgather.  `region`, when given, IS the
        backing store of `local_buffer` (the allocate path built the
        buffer as a view over it)."""
        local_buffer = rma_util.window_buffer(local_buffer)
        if not local_buffer.flags["C_CONTIGUOUS"]:
            raise errors.WinError(
                "window buffer must be C-contiguous (RMA writes go "
                "through a flat view)"
            )
        svc = AmService.ensure(ep)
        win_id = ep.bcast(
            next(svc.win_ids) if ep.rank == 0 else None, root=0
        )
        st = _AmWinState(ep.size, local_buffer.reshape(-1))
        st.region = region
        svc.windows[win_id] = st
        win = cls(ep, svc, win_id, st, local_buffer, info=info)
        win._region = region
        desc = None
        if region is not None:
            desc = (ep.boot_token_of(ep.rank), region.name,
                    local_buffer.dtype.str,
                    int(local_buffer.reshape(-1).size))
        win._descs = ep.allgather(desc)
        if region is not None:
            win._maps[ep.rank] = _DirectTarget(region,
                                               local_buffer.dtype)
        ep.barrier()  # every rank registered before any RMA can arrive
        state = getattr(ep, "ft_state", None)
        if state is not None:
            state.add_failure_listener(win._on_peer_death)
            win._listener_armed = True
        return win

    @classmethod
    def allocate(cls, ep, nbytes: int, dtype=np.uint8,
                 info=None) -> "DirectWindow":
        """MPI_Win_allocate: the window owns its buffer — placed inside
        an RMA region of this proc's sm segment when the plane is on
        (``osc_direct``), a private array otherwise (then every op to
        this rank rides AM, and so do ops FROM this rank)."""
        dt = np.dtype(dtype)
        count = nbytes // dt.itemsize
        region = None
        alloc = getattr(ep, "sm_rma_region", None)
        if direct_enabled() and alloc is not None:
            region = alloc(count * dt.itemsize)
        if region is not None:
            buf = region.view(dt)[:count]
        else:
            buf = np.zeros(count, dt)
        win = cls.create(ep, buf, info=info, region=region)
        win.base = buf
        return win

    @classmethod
    def create_dynamic(cls, ep) -> "DirectWindow":
        """MPI_Win_create_dynamic (the shmem substrate): attach the
        symmetric arena with :meth:`attach_symmetric` to get the
        direct path."""
        win = cls.create(ep, np.zeros(0, np.uint8))
        win._is_dynamic = True
        return win

    # -- the per-target seam decision -------------------------------------

    @property
    def _direct_capable(self) -> bool:
        return any(d is not None for d in self._descs)

    def _am_fallback(self) -> None:
        """A direct-capable window routed an op to the AM path: LOUD,
        never silent (cross-host target, revoked cid, known-failed
        peer, unmappable region).  Windows with no region anywhere —
        the plane off, sm off — are plain AM windows, not fallbacks."""
        if self._direct_capable:
            spc.record("osc_am_fallbacks", 1)

    def _revoked(self) -> bool:
        """Checked per OP, not per decision: a revoke landing AFTER a
        target was mapped must route the op to the AM path, where it
        classifies as typed ``Revoked`` — post-revoke direct load/store
        silently mutating a poisoned window would break ULFM."""
        state = getattr(self.ep, "ft_state", None)
        return state is not None and state.is_revoked(AM_CID)

    def _map_peer_region(self, target: int, desc,
                         what: str) -> sm_mod.RmaMapping | None:
        """The ONE seam decision (shared by window and symmetric-heap
        maps): descriptor present, plane on, peer alive, provably the
        same /dev/shm namespace, the transport ladder picked the sm
        ring — then mmap the region, degrading LOUDLY on failure."""
        if desc is None or not self._enabled:
            return None
        state = getattr(self.ep, "ft_state", None)
        if state is not None and state.is_failed(target):
            return None
        boot, name = desc[0], desc[1]
        mine = self.ep.boot_token_of(self.ep.rank)
        if mine is None or boot != mine:
            return None  # not provably one /dev/shm namespace
        if not self.ep.sm_direct_to(target):
            return None  # the transport ladder said wire
        try:
            return sm_mod.RmaMapping(
                os.path.join(sm_mod.segment_dir(), name),
                my_rank=self.ep.rank,
            )
        except (OSError, errors.MpiError) as e:
            mca_output.emit(
                _stream,
                "rank %s: %s of rank %s unmappable (%s); target "
                "degrades to the AM path", self.ep.rank, what, target,
                e,
            )
            return None

    def _try_map(self, target: int) -> _DirectTarget | None:
        desc = self._descs[target] if target < len(self._descs) else None
        mapping = self._map_peer_region(target, desc, "rma region")
        if mapping is None:
            return None
        return _DirectTarget(mapping, np.dtype(desc[2]))

    def _direct(self, target: int) -> _DirectTarget | None:
        """The memoized per-target decision: the mapped region, or None
        (AM path).  Decided once — a direction is all-direct or all-AM,
        exactly like the two-sided transport ladder.  Revocation is the
        exception: it poisons EVERY subsequent op back to the AM path
        (which raises typed), mapped or not."""
        if self._revoked():
            return None
        with self._dlock:
            if target in self._maps:
                return self._maps[target]
        dm = self._try_map(target)
        with self._dlock:
            if target not in self._maps:
                self._maps[target] = dm
            elif dm is not None:
                # lost a race with another thread (or a death listener
                # pinning to AM): theirs is the decision
                dm.mapping.close()
            return self._maps[target]

    def _abort_for(self, target: int):
        """Failure-awareness hook for region lock/atomic waits: a
        target entering the FailureState classifies typed out of the
        futex wait instead of riding the stall timeout."""
        state = getattr(self.ep, "ft_state", None)
        if state is None:
            return None

        def abort():
            if state.is_failed(target):
                raise errors.ProcFailed(
                    f"rank {target} failed during a direct-map window "
                    f"operation (cause: {state.cause_of(target)})",
                    failed_ranks=state.failed(),
                )
        return abort

    # -- FT: unmap + lock-word recovery at classification -----------------

    def _on_peer_death(self, rank: int, _cause: str) -> None:
        """FailureState listener: the dead rank's region is unmapped
        (its target pinned to AM, where ops classify typed at issue),
        and its lock-word contribution is recovered in EVERY region
        this rank can reach — the window's own region first (we may be
        the lock target the corpse was holding), then live mappings
        (we may be parked on a futex the corpse would have woken)."""
        with self._dlock:
            stale = self._maps.get(rank)
            self._maps[rank] = None
            sym_stale = self._sym_maps.get(rank)
            self._sym_maps[rank] = None
            live = [dt.mapping for r, dt in self._maps.items()
                    if dt is not None and r != rank]
            live += [m for r, m in self._sym_maps.items()
                     if m is not None and r != rank]
        for region in (self._region, (self._sym or (0, 0, None))[2]):
            if region is not None:
                region.recover_dead(rank)
        for mapping in live:
            try:
                mapping.recover_dead(rank)
            except errors.MpiError:  # owner also tearing down
                pass
        if self.st.region is not None:
            # the corpse may have been blocking (or BEEN) an AM-origin
            # lock waiter queued at OUR service: recovery wakes only
            # the gen-futex (direct) waiters — no unlock/lock_scan
            # message will ever arrive for the queued ones, so re-scan
            # (which also drops the corpse's own queued request)
            self.svc._scan_region_waiters(self.st)
        if stale is not None:
            stale.mapping.close()
        if sym_stale is not None:
            sym_stale.close()

    # -- communication ----------------------------------------------------

    def put(self, data, target: int, offset: int = 0) -> None:
        """MPI_Put: direct store into the mapped region (immediately
        visible — stronger than MPI requires), or the AM path."""
        dm = self._direct(target)
        if dm is None:
            if target != self.ep.rank:
                self._am_fallback()
            return super().put(data, target, offset)
        from ..utils import memchecker

        memchecker.check_send_buffer(data, "MPI_Put")
        data = rma_util.host_array(data)
        flat = dm.flat
        n = data.size
        if offset < 0 or offset + n > flat.size:
            raise errors.WinError(
                f"put of {n} at {offset} overruns window of {flat.size}"
            )
        flat[offset:offset + n] = data.reshape(-1).astype(flat.dtype,
                                                  copy=False)
        nbytes = int(n * flat.dtype.itemsize)
        spc.record("osc_puts", 1)
        spc.record("osc_bytes_put", int(data.nbytes))
        spc.record("osc_direct_puts", 1)
        spc.record("osc_direct_bytes", nbytes)

    def get(self, target: int, offset: int = 0, count: int | None = None,
            out=None) -> np.ndarray:
        """MPI_Get: direct load from the mapped region, or AM; into
        ``out`` when given (a tensor is filled straight from the
        mapping, host to card for a CUDA one)."""
        dm = self._direct(target)
        if dm is None:
            if target != self.ep.rank:
                self._am_fallback()
            return super().get(target, offset, count, out=out)
        flat = dm.flat
        if offset < 0 or offset > flat.size:
            raise errors.WinError(
                f"get offset {offset} outside window of {flat.size}"
            )
        count = flat.size - offset if count is None else count
        if count < 0 or offset + count > flat.size:
            raise errors.WinError("get overruns window")
        spc.record("osc_gets", 1)
        spc.record("osc_direct_gets", 1)
        spc.record("osc_direct_bytes", int(count * flat.dtype.itemsize))
        if out is not None:
            return rma_util.deliver(flat[offset:offset + count], out)
        return flat[offset:offset + count].copy()

    def accumulate(self, data, target: int, offset: int = 0,
                   op=None) -> None:
        """MPI_Accumulate: read-modify-write under the region LOCK WORD
        (the btl_atomic_op analog — cross-process, shared with the
        target's AM service)."""
        from .. import ops as zops

        op = zops.SUM if op is None else op
        dm = self._direct(target)
        if dm is None:
            if target != self.ep.rank:
                self._am_fallback()
            return super().accumulate(data, target, offset, op)
        from ..utils import memchecker

        memchecker.check_send_buffer(data, "MPI_Accumulate")
        data = rma_util.host_array(data)
        flat = dm.flat
        n = data.size
        if offset < 0 or offset + n > flat.size:
            raise errors.WinError("accumulate overruns window")
        with dm.mapping.atomic(abort=self._abort_for(target)):
            cur = flat[offset:offset + n]
            flat[offset:offset + n] = rma_util.apply_op(
                op, data.reshape(-1).astype(flat.dtype, copy=False), cur
            )
        spc.record("osc_direct_atomics", 1)
        spc.record("osc_direct_bytes", int(n * flat.dtype.itemsize))

    def get_accumulate(self, data, target: int, offset: int = 0,
                       op=None) -> np.ndarray:
        """MPI_Get_accumulate: fetch-and-op under the lock word."""
        from .. import ops as zops

        op = zops.SUM if op is None else op
        dm = self._direct(target)
        if dm is None:
            if target != self.ep.rank:
                self._am_fallback()
            return super().get_accumulate(data, target, offset, op)
        from ..utils import memchecker

        memchecker.check_send_buffer(data, "MPI_Get_accumulate")
        data = rma_util.host_array(data)
        flat = dm.flat
        n = data.size
        if offset < 0 or offset + n > flat.size:
            raise errors.WinError(
                f"get_accumulate of {n} at {offset} overruns window of "
                f"{flat.size}"
            )
        with dm.mapping.atomic(abort=self._abort_for(target)):
            old = flat[offset:offset + n].copy()
            flat[offset:offset + n] = rma_util.apply_op(
                op, data.reshape(-1).astype(flat.dtype, copy=False), old
            )
        spc.record("osc_direct_atomics", 1)
        spc.record("osc_direct_bytes", int(n * flat.dtype.itemsize))
        return old

    def compare_and_swap(self, value, compare, target: int,
                         offset: int = 0):
        """MPI_Compare_and_swap under the lock word."""
        dm = self._direct(target)
        if dm is None:
            if target != self.ep.rank:
                self._am_fallback()
            return super().compare_and_swap(value, compare, target,
                                            offset)
        flat = dm.flat
        if not 0 <= offset < flat.size:
            raise errors.WinError(
                f"compare_and_swap offset {offset} outside window of "
                f"{flat.size}"
            )
        with dm.mapping.atomic(abort=self._abort_for(target)):
            old = flat[offset].copy()
            if old == compare:
                flat[offset] = value
        spc.record("osc_direct_atomics", 1)
        spc.record("osc_direct_bytes", int(flat.dtype.itemsize))
        return old

    # -- request-based RMA ------------------------------------------------
    # rput/raccumulate inherit (they call the polymorphic put/
    # accumulate); the async-RPC fetches short-circuit to born-complete
    # requests on the direct path — a mapped load IS the completion.

    def rget(self, target: int, offset: int = 0,
             count: int | None = None):
        if self._direct(target) is not None:
            return rma_util.completed_request(
                self.get(target, offset, count))
        if target != self.ep.rank:
            self._am_fallback()
        return super().rget(target, offset, count)

    def rget_accumulate(self, data, target: int, offset: int = 0,
                        op=None):
        from .. import ops as zops

        op = zops.SUM if op is None else op
        if self._direct(target) is not None:
            return rma_util.completed_request(
                self.get_accumulate(data, target, offset, op))
        if target != self.ep.rank:
            self._am_fallback()
        return super().rget_accumulate(data, target, offset, op)

    # -- synchronization --------------------------------------------------

    def flush(self, target: int | None = None) -> None:
        """MPI_Win_flush: direct stores are visible at issue — only AM
        targets with outstanding fire-and-forget ops need the ack
        round trip."""
        targets = list(self._dirty) if target is None else [target]
        for t in targets:
            if t != self.ep.rank and t in self._dirty:
                self._rpc(t, ("flush", self.win_id))
                self._dirty.discard(t)

    def lock(self, target: int, lock_type: int = LOCK_EXCLUSIVE) -> None:
        """MPI_Win_lock (passive target): shared/exclusive counts in
        the region header, blocked waiters parked on the generation
        FUTEX — no target-side involvement, no polling.  AM targets
        keep the service lock manager (which, for region-backed
        windows, grants against the same header)."""
        if self.info.get_bool("no_locks"):
            raise errors.WinError(
                "window created with no_locks=true (MPI info assertion)"
            )
        dm = self._direct(target)
        if dm is None:
            if target != self.ep.rank:
                self._am_fallback()
            return super().lock(target, lock_type)
        dm.mapping.lock(self.ep.rank, lock_type == LOCK_EXCLUSIVE,
                        abort=self._abort_for(target))
        self._held.setdefault(target, []).append(lock_type)

    def unlock(self, target: int) -> None:
        """MPI_Win_unlock: direct stores completed at issue, so the
        direct path releases the header counts and — when the owner's
        service has AM waiters queued (the header's amq count) — pokes
        it with a ``lock_scan`` so their grants retry."""
        dm = self._direct(target)
        if dm is None:
            return super().unlock(target)
        held = self._held.get(target)
        if not held:
            raise errors.WinError(f"unlock of {target} without lock")
        held.pop()
        amq = dm.mapping.unlock(self.ep.rank)
        if amq:
            self._send(target, ("lock_scan", self.win_id))

    # -- the symmetric-heap (shmem) seam ----------------------------------

    def attach_symmetric(self, nbytes: int) -> tuple[int, np.ndarray]:
        """Collective: attach this rank's symmetric arena, backed by an
        RMA region when the plane is on.  Returns ``(disp, arena)`` —
        the dynamic-window displacement plus the writable uint8 arena.
        The ``dyn_*`` family then takes the direct path to every
        same-host peer (the shmem put/get/*_nbi/AMO substrate)."""
        if not getattr(self, "_is_dynamic", False):
            raise errors.WinError(
                "attach_symmetric requires a dynamic window"
            )
        region = None
        alloc = getattr(self.ep, "sm_rma_region", None)
        if self._enabled and alloc is not None:
            region = alloc(int(nbytes))
        arena = region.data if region is not None \
            else np.zeros(int(nbytes), np.uint8)
        disp = self.attach(arena)
        self._sym = (disp, int(nbytes), region)
        if region is not None:
            # the arena region's lock word is the window's atomicity
            # domain: the service's dyn_amo and the direct dyn_amo
            # serialize on it
            self.st.region = region
        desc = None
        if region is not None:
            desc = (self.ep.boot_token_of(self.ep.rank), region.name)
        self._sym_descs = self.ep.allgather(desc)
        self.ep.barrier()
        return disp, arena

    def _sym_direct(self, target: int, disp: int, nbytes: int
                    ) -> sm_mod.RmaMapping | None:
        """The dyn-op seam decision: the target's mapped arena region
        when the span lies inside the symmetric arena and the ladder
        says direct, else None (AM)."""
        if self._sym is None:
            return None
        base, length, _ = self._sym
        if disp < base or disp + nbytes > base + length:
            return None  # outside the symmetric arena: AM resolves it
        if self._revoked():
            return None  # every op re-routes to AM, which raises typed
        if target == self.ep.rank:
            return self._sym[2]
        with self._dlock:
            if target in self._sym_maps:
                return self._sym_maps[target]
        desc = self._sym_descs[target] \
            if target < len(self._sym_descs) else None
        mapping = self._map_peer_region(target, desc, "symmetric arena")
        with self._dlock:
            if target not in self._sym_maps:
                self._sym_maps[target] = mapping
            elif mapping is not None:
                mapping.close()
            return self._sym_maps[target]

    def _sym_u8(self, mapping: sm_mod.RmaMapping, disp: int,
                nbytes: int) -> np.ndarray:
        base = self._sym[0]
        off = disp - base
        return mapping.data[off:off + nbytes]

    def dyn_put(self, data, target: int, disp: int) -> None:
        data = rma_util.host_array(data)
        raw = np.frombuffer(np.ascontiguousarray(data).tobytes(),
                            np.uint8)
        mapping = self._sym_direct(target, disp, raw.size)
        if mapping is None:
            self._am_sym_fallback(target)
            return super().dyn_put(data, target, disp)
        self._sym_u8(mapping, disp, raw.size)[...] = raw
        spc.record("osc_direct_puts", 1)
        spc.record("osc_direct_bytes", int(raw.size))

    def dyn_get(self, target: int, disp: int, nbytes: int) -> np.ndarray:
        mapping = self._sym_direct(target, disp, nbytes)
        if mapping is None:
            self._am_sym_fallback(target)
            return super().dyn_get(target, disp, nbytes)
        out = self._sym_u8(mapping, disp, nbytes).copy()
        spc.record("osc_direct_gets", 1)
        spc.record("osc_direct_bytes", int(nbytes))
        return out

    def _am_sym_fallback(self, target: int) -> None:
        """A direct-capable symmetric heap routed a dyn op to AM:
        loud, never silent (same contract as the window ops)."""
        if self._sym is not None and self._sym[2] is not None \
                and target != self.ep.rank:
            spc.record("osc_am_fallbacks", 1)

    def dyn_iput(self, values: np.ndarray, target: int, disp: int,
                 tst: int = 1) -> None:
        values = np.ascontiguousarray(rma_util.host_array(values)
                                      ).reshape(-1)
        span = ((values.size - 1) * tst + 1) * values.itemsize \
            if values.size else 0
        mapping = self._sym_direct(target, disp, span)
        if mapping is None:
            self._am_sym_fallback(target)
            return super().dyn_iput(values, target, disp, tst)
        typed = self._sym_u8(mapping, disp, span).view(values.dtype)
        typed[:values.size * tst:tst] = values
        spc.record("osc_direct_puts", 1)
        spc.record("osc_direct_bytes", int(values.nbytes))

    def dyn_iget(self, target: int, disp: int, n: int, dtype,
                 sst: int = 1) -> np.ndarray:
        dt = np.dtype(dtype)
        span = ((n - 1) * sst + 1) * dt.itemsize if n else 0
        mapping = self._sym_direct(target, disp, span)
        if mapping is None:
            self._am_sym_fallback(target)
            return super().dyn_iget(target, disp, n, dtype, sst)
        typed = self._sym_u8(mapping, disp, span).view(dt)
        out = typed[:n * sst:sst].copy()
        spc.record("osc_direct_gets", 1)
        spc.record("osc_direct_bytes", int(out.nbytes))
        return out

    def dyn_get_nbi(self, target: int, disp: int, nbytes: int):
        """Nonblocking get: the direct path completes at issue (mapped
        load) — legal, since nbi only promises completion no later
        than quiet."""
        mapping = self._sym_direct(target, disp, nbytes)
        if mapping is None:
            self._am_sym_fallback(target)
            return super().dyn_get_nbi(target, disp, nbytes)
        out = self._sym_u8(mapping, disp, nbytes).copy()
        spc.record("osc_direct_gets", 1)
        spc.record("osc_direct_bytes", int(nbytes))
        return rma_util.completed_request(out)

    def dyn_amo(self, target: int, disp: int, kind: str, dtype,
                value=None, compare=None):
        """Typed atomic at a byte displacement, under the arena
        region's lock word — one atomicity domain with the owner's AM
        service (``_win_atomic``)."""
        dt = np.dtype(dtype)
        mapping = self._sym_direct(target, disp, dt.itemsize)
        if mapping is None:
            self._am_sym_fallback(target)
            return super().dyn_amo(target, disp, kind, dtype,
                                   value=value, compare=compare)
        typed = self._sym_u8(mapping, disp, dt.itemsize).view(dt)
        with mapping.atomic(abort=self._abort_for(target)):
            old = typed[0].copy()
            if kind == "add":
                typed[0] = old + value
            elif kind in ("swap", "set"):
                typed[0] = value
            elif kind == "cas":
                if old == compare:
                    typed[0] = value
            elif kind != "fetch":
                raise errors.InternalError(f"unknown AMO {kind!r}")
        spc.record("osc_direct_atomics", 1)
        spc.record("osc_direct_bytes", int(dt.itemsize))
        return old

    # -- teardown ---------------------------------------------------------

    def free(self) -> None:
        """MPI_Win_free: quiesce, drop the registration, unmap every
        origin mapping, and — after the final barrier proved every
        origin is out — unlink the owner's region file(s)."""
        if self._listener_armed:
            state = getattr(self.ep, "ft_state", None)
            if state is not None:
                state.remove_failure_listener(self._on_peer_death)
            self._listener_armed = False
        self.flush_all()
        self.ep.barrier()
        self.svc.windows.pop(self.win_id, None)
        with self._dlock:
            maps = [dt for dt in self._maps.values() if dt is not None]
            sym_maps = [m for m in self._sym_maps.values()
                        if m is not None]
            self._maps = {}
            self._sym_maps = {}
        for dt in maps:
            if dt.mapping is not self._region:
                dt.mapping.close()
        sym_region = (self._sym or (0, 0, None))[2]
        for m in sym_maps:
            if m is not sym_region:
                m.close()
        self.ep.barrier()
        if self._region is not None:
            self.ep.sm_release_region(self._region)
            self._region = None
            self.st.region = None
        if sym_region is not None:
            self.ep.sm_release_region(sym_region)
            self._sym = None
            self.st.region = None


# ------------------------------------------------ stage handoff -------
# The PSCW region-doorbell follow-on: active-target epochs whose
# post/complete signals ride the region header's doorbell words
# (pt2pt/sm.py `_RH_POSTS`/`_RH_COMPLETES`, futex-parked) instead of AM
# messages.  The serving plane's pipeline stages hand KV/activation
# blocks down the chain through these, and weight broadcast rides the
# same direct path — the tiny epoch signal is the ONLY non-payload
# traffic, and it never touches the wire or the matching engine.

TAG_HANDOFF = 0x7D0B


class StageHandoff:
    """Persistent pre-mapped handoff schedule for ONE pipeline-stage
    pair (producer → consumer) over a :class:`DirectWindow`.

    Construction is the persistent half, done ONCE: the producer
    pre-maps the consumer's region (the same memoized seam decision
    every direct op rides), both sides exchange their verdicts in one
    handshake message, and the pair pins a mode for life — unanimous
    DIRECT (doorbell epochs), or AM PSCW on both sides (loud:
    ``osc_am_fallbacks``; a split-brain schedule where one side waits
    on a doorbell the other never rings cannot arise).  Every epoch
    after that is pure doorbell::

        consumer: hoff.post()      # expose; rings the post word
        producer: hoff.start()     # futex-parks on the post word
                  hoff.put(kv, off)  # direct store into the region
                  hoff.complete()  # rings the complete word
        consumer: hoff.wait()      # futex-parks on the complete word

    Doorbell generations are snapshotted at construction
    (:meth:`~zhpe_ompi_tpu.pt2pt.sm.RmaMapping.doorbell_gens`), so a
    schedule rebuilt over a reused region never consumes a stale ring.
    Peer death classifies typed out of both parks (the window's
    ``_abort_for`` hook), never a bare timeout."""

    def __init__(self, win: DirectWindow, producer: int, consumer: int,
                 timeout: float = 10.0):
        if producer == consumer:
            raise errors.WinError("stage handoff needs two ranks")
        me = win.ep.rank
        if me not in (producer, consumer):
            raise errors.WinError(
                f"rank {me} is not part of stage pair "
                f"({producer} -> {consumer})")
        self.win = win
        self.producer, self.consumer = int(producer), int(consumer)
        self.peer = self.consumer if me == self.producer \
            else self.producer
        if me == self.consumer:
            mapping = win._region  # the exposed region is OUR OWN
        else:
            dm = win._direct(self.consumer)
            mapping = dm.mapping if dm is not None else None
        mine = mapping is not None
        # Snapshot doorbell generations BEFORE the handshake: the peer
        # cannot ring until its own handshake completes, and that needs
        # our message — so a pre-handshake snapshot can never absorb the
        # consumer's first post() (a post-handshake one can, and the
        # producer would then park for a generation that never comes).
        gens = mapping.doorbell_gens() if mine else (0, 0)
        theirs = win.ep.sendrecv(
            mine, self.peer, source=self.peer, sendtag=TAG_HANDOFF,
            recvtag=TAG_HANDOFF)
        self.direct = bool(mine and theirs)
        self._mapping = mapping if self.direct else None
        if not self.direct:
            # one side could not map: BOTH pin to the AM PSCW path —
            # loud on any direct-capable window, never silent
            win._am_fallback()
            mca_output.verbose(
                1, _stream, "stage pair (%d -> %d): doorbell "
                "unavailable (local=%s peer=%s); AM PSCW epochs",
                self.producer, self.consumer, mine, theirs,
            )
            self._posts_seen = self._completes_seen = 0
        else:
            self._posts_seen, self._completes_seen = gens
        self.timeout = float(timeout)
        self.epochs = 0

    # -- consumer side ---------------------------------------------------

    def post(self) -> None:
        """Expose the next epoch to the producer."""
        if self.win.ep.rank != self.consumer:
            raise errors.WinError("post() is the consumer's verb")
        if not self.direct:
            return self.win.post([self.producer])
        self._mapping.post_epoch()
        spc.record("osc_doorbell_posts", 1)

    def wait(self) -> None:
        """Park until the producer completed the epoch."""
        if self.win.ep.rank != self.consumer:
            raise errors.WinError("wait() is the consumer's verb")
        if not self.direct:
            return self.win.wait_sync(self.timeout)
        self._completes_seen = self._mapping.await_complete(
            self._completes_seen, self.timeout,
            abort=self.win._abort_for(self.producer))
        self.epochs += 1

    def recv(self, offset: int = 0, count: int | None = None
             ) -> np.ndarray:
        """Consumer-side read of the landed epoch payload (a local
        load — the producer already stored it into OUR region)."""
        return self.win.get(self.consumer, offset, count)

    # -- producer side ---------------------------------------------------

    def start(self) -> None:
        """Park until the consumer exposed the epoch."""
        if self.win.ep.rank != self.producer:
            raise errors.WinError("start() is the producer's verb")
        if not self.direct:
            return self.win.start([self.consumer],
                                  timeout=self.timeout)
        self._posts_seen = self._mapping.await_post(
            self._posts_seen, self.timeout,
            abort=self.win._abort_for(self.consumer))

    def put(self, data, offset: int = 0) -> None:
        """Stage payload into the consumer's region (direct store on
        the doorbell path; the window's loud AM fallback otherwise)."""
        if self.win.ep.rank != self.producer:
            raise errors.WinError("put() is the producer's verb")
        self.win.put(data, self.consumer, offset)

    def complete(self) -> None:
        """Ring the completion doorbell — direct stores are visible at
        issue, so the bump IS the epoch's completion signal."""
        if self.win.ep.rank != self.producer:
            raise errors.WinError("complete() is the producer's verb")
        if not self.direct:
            return self.win.complete()
        self._mapping.complete_epoch()
        spc.record("osc_doorbell_completes", 1)
        self.epochs += 1


def pipeline_schedule(win: DirectWindow, stages: list[int] | None = None,
                      timeout: float = 10.0) -> dict[str, StageHandoff]:
    """The whole pipeline's persistent schedule in one call: for a
    stage chain (default: every rank in order) each rank builds its
    upstream and downstream :class:`StageHandoff` pairs — ``{"up":
    handoff-from-previous-stage, "down": handoff-to-next-stage}``
    (absent at the chain's ends).  Handshakes pair by construction
    order: every rank builds its UP pair before its DOWN pair."""
    stages = list(range(win.ep.size)) if stages is None else list(stages)
    me = win.ep.rank
    if me not in stages:
        return {}
    i = stages.index(me)
    out: dict[str, StageHandoff] = {}
    if i > 0:
        out["up"] = StageHandoff(win, stages[i - 1], me,
                                 timeout=timeout)
    if i + 1 < len(stages):
        out["down"] = StageHandoff(win, me, stages[i + 1],
                                   timeout=timeout)
    return out


def window_bcast(win: DirectWindow, data=None, root: int = 0,
                 count: int | None = None, out=None) -> np.ndarray:
    """Weight broadcast riding the RMA direct path: the root stores
    the payload into its OWN window region, and every rank pulls it
    with a window ``get`` — a direct mapped load for every same-host
    rank (``osc_direct_bytes`` carries the payload; a cross-host rank
    degrades loudly to an AM get).  One tiny collective bcast carries
    the element count — the control plane; the payload plane is pure
    RMA.  The serving loop's remesh leg re-broadcasts weights onto a
    survivor or post-resize mesh through this.  ``data`` may be a tensor
    (a CUDA one is copied to the host); ``out``, a tensor, receives the
    pull (see :meth:`DirectWindow.get`)."""
    if win.ep.rank == root:
        arr = np.ascontiguousarray(rma_util.host_array(data))
        flat = arr.reshape(-1)
        win.put(flat, root)  # the owner's own region: a local store
        n = win.ep.bcast(int(flat.size), root=root)
    else:
        n = win.ep.bcast(None, root=root)
    win.ep.barrier()  # the store happened-before every pull
    return win.get(root, 0, n if count is None else count, out=out)


def allocate_window(ctx, nbytes: int, dtype=np.uint8, info=None):
    """MPI_Win_allocate with component selection (the
    osc_rdma_component priority scheme): direct memory for
    thread-universe ranks, the direct-map plane for wire endpoints
    (which degrades per rank to AM when the sm plane is off)."""
    from .window import HostWindow

    if hasattr(ctx, "universe"):
        return HostWindow.allocate(ctx, nbytes, dtype)
    return DirectWindow.allocate(ctx, nbytes, dtype=dtype, info=info)


def create_dynamic_window(ep) -> DirectWindow:
    """The shmem symmetric-heap substrate: a direct-map dynamic window
    over any endpoint.  Endpoints without the sm region seam (no
    ``sm_rma_region`` — thread ranks, sm=0 procs) degrade per rank to
    a plain arena inside the same window, so the AM behavior of the
    pre-direct plane is preserved exactly."""
    return DirectWindow.create_dynamic(ep)
