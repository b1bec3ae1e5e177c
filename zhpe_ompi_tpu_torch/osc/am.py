"""One-sided communication over the wire plane — the osc/rdma analog
(namesake: ``zhpe_ompi_tpu/osc/am.py``).

The reference's ``osc/rdma`` exists precisely to run RMA over a network:
it drives BTL put/get/atomics against *registered remote memory*
(``ompi/mca/osc/rdma/osc_rdma_comm.c:729-828``), with the target CPU not
involved in the data path.  A TCP/DCN host plane has no RDMA NIC, so the
faithful re-design is the reference's *other* networked path — osc
active-message style (``osc/pt2pt`` lineage): every RMA operation is a
small typed message applied at the target by a service loop fed from the
same matching engine pt2pt uses.  This file is that design:

- :class:`AmService` — one service thread per endpoint, receiving on a
  reserved (cid, tag) channel and applying window operations in arrival
  order.  Per-origin FIFO (TCP in-order delivery + per-source matching
  order) makes a ``flush`` ack prove all earlier operations from that
  origin are applied — the completion semantics osc/rdma gets from BTL
  ordering.
- :class:`AmWindow` — the MPI window API (put/get/accumulate/
  get_accumulate/compare_and_swap, fence/lock/PSCW, dynamic windows)
  with the same surface as the in-process
  :class:`~zhpe_ompi_tpu.osc.window.HostWindow`, so programs and tests
  run unchanged over socket-connected (DCN) ranks.

Component selection mirrors the reference's osc priority scheme
(``osc_rdma_component.c:231-236``): :func:`create_window` picks the
direct-memory component for thread-universe ranks (the osc/sm analog —
buffers are literally addressable) and the AM component for wire
endpoints.

Accumulate ops travel by name and must be predefined — exactly MPI's own
rule for MPI_Accumulate (user ops are invalid there), which is what makes
target-side application well-defined.

Lock semantics: the target-side lock manager is a real reader-writer
queue — SHARED grants coexist, EXCLUSIVE serializes.

What the port adds, against the namesake: messages ride the port's
``utils/dss``, which decodes an array record to a CPU tensor; the service
and the origin turn every decoded array back into numpy (:func:`_np`), so
window memory and every result handed back is numpy, as in the namesake,
and the wire is the namesake's (a port rank and a JAX-package rank serve
each other's windows).  Origin buffers may be tensors, a CUDA one copied
to the host explicitly; ``get``/``rget``'s value can land in an ``out=``
tensor.  bfloat16 does not cross: dss refuses it at the origin, before a
message leaves (the namesake sends an ``ml_dtypes`` array as raw
``'<V2'`` voids its target cannot cast, so its put fails at the target);
move the bits through an int16 window instead.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any

import numpy as np

from .. import ops as zops
from ..core import errhandler as errh
from ..core import errors
from ..core import info as info_mod
from ..runtime import spc
from . import rma_util


def _np(value):
    """A decoded wire value as the namesake hands it back: a tensor as
    numpy (a 0-d one as a numpy scalar), anything else as given."""
    import torch

    if isinstance(value, torch.Tensor):
        arr = value.numpy()
        return arr[()] if arr.ndim == 0 else arr
    return value

LOCK_SHARED = 1
LOCK_EXCLUSIVE = 2

# Reserved host-plane channel for one-sided traffic (below the collective
# tag space; cf. MCA_COLL_BASE_TAG numbering).
AM_CID = 0x7FFB
AM_REQ_TAG = 1  # all requests; replies use per-call tags >= 0x100


def _win_atomic(st: "_AmWinState"):
    """The window's atomicity domain: the region LOCK WORD when the
    window is direct-map backed (cross-process — direct origins take
    the same word), the process-local apply lock otherwise."""
    return st.apply_lock if st.region is None else st.region.atomic()


class _LockManager:
    """Target-side reader-writer lock queue for one window.

    Grants are replies; the service loop never blocks on a lock — requests
    that cannot be granted are queued and granted on unlock (the shape of
    osc/rdma's lock queue, ``osc_rdma_passive_target.c``)."""

    def __init__(self):
        self.shared_holders: set[int] = set()
        self.exclusive_holder: int | None = None
        self.waiters: deque[tuple[int, int, int]] = deque()  # (origin, type, reply_tag)

    def try_grant(self, origin: int, lock_type: int) -> bool:
        if lock_type == LOCK_EXCLUSIVE:
            if self.exclusive_holder is None and not self.shared_holders:
                self.exclusive_holder = origin
                return True
            return False
        # shared: any number of readers, but not under a writer
        if self.exclusive_holder is None:
            self.shared_holders.add(origin)
            return True
        return False

    def release(self, origin: int, lock_type: int) -> list[tuple[int, int]]:
        """Release and return [(origin, reply_tag)] grants to send."""
        if lock_type == LOCK_EXCLUSIVE:
            if self.exclusive_holder != origin:
                raise errors.WinError(
                    f"unlock: rank {origin} does not hold the exclusive lock"
                )
            self.exclusive_holder = None
        else:
            if origin not in self.shared_holders:
                raise errors.WinError(
                    f"unlock: rank {origin} holds no shared lock"
                )
            self.shared_holders.discard(origin)
        grants = []
        while self.waiters:
            w_origin, w_type, w_tag = self.waiters[0]
            if self.try_grant(w_origin, w_type):
                self.waiters.popleft()
                grants.append((w_origin, w_tag))
                if w_type == LOCK_EXCLUSIVE:
                    break  # writer got it; nothing else can follow
            else:
                break
        return grants


class _AmWinState:
    """Per-(endpoint, window) state: the target-side buffer + epoch
    bookkeeping, shared between the API object and the service loop."""

    def __init__(self, size: int, buffer: np.ndarray):
        self.buffer = buffer  # flat view target ops write through
        self.apply_lock = threading.Lock()  # serializes local vs AM applies
        # direct-map plane (osc/direct.py): the region whose lock word
        # is the window's cross-process atomicity domain, or None for a
        # plain (process-private) window.  When set, the service's
        # atomics and lock grants run against the region header so
        # direct origins and AM origins serialize on the same words.
        self.region = None
        self.region_waiters: deque[tuple[int, int, int]] = deque()
        self.lockman = _LockManager()
        # dynamic windows
        self.dynamic: dict[int, np.ndarray] = {}
        self.dynamic_next = 0
        # distributed (shmem_set_lock-style) per-key lock managers
        self.dist_locks: dict[int, _LockManager] = {}
        # PSCW: origin side records posts received from targets; target
        # side records which origins completed this exposure epoch
        self.cond = threading.Condition()
        self.posts_from: dict[int, int] = {}     # target -> epoch count
        self.completed_by: set[int] = set()       # origins done this epoch
        self.expected_origins: set[int] | None = None


class AmService:
    """Per-endpoint active-message service loop (the target-side progress
    of osc; runs only on wire endpoints, which have background drain
    threads feeding the matching engine)."""

    def __init__(self, ep):
        self.ep = ep
        self.windows: dict[int, _AmWinState] = {}
        self.win_ids = itertools.count()  # meaningful on rank 0 only
        self.reply_tags = itertools.count(0x100)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        # stop the loop before the endpoint's sockets go away
        orig_close = ep.close

        def close_with_am():
            self.shutdown()
            orig_close()

        ep.close = close_with_am

    @classmethod
    def ensure(cls, ep) -> "AmService":
        svc = getattr(ep, "_am_service", None)
        if svc is None:
            svc = cls(ep)
            ep._am_service = svc
        return svc

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(1.0)

    # -- the service loop -------------------------------------------------

    # which message element carries the reply tag, per RPC op — error
    # replies must never guess (a guessed msg[-1] could collide with an
    # unrelated RPC's tag, e.g. a lock key that happens to be >= 0x100)
    _REPLY_TAG_INDEX = {
        "get": 4, "get_acc": 5, "cas": 5, "flush": 2, "lock": 3,
        "dlock": 3, "dtrylock": 3, "dyn_get": 4, "dyn_iget": 6,
        "dyn_amo": 7,
    }

    def _serve(self) -> None:
        from ..mca import output as mca_output

        stream = mca_output.open_stream("osc_am")
        while not self._stop.is_set():
            try:
                msg, status = self.ep.recv(
                    tag=AM_REQ_TAG, cid=AM_CID, timeout=0.25,
                    return_status=True, poll=True,
                )
            except errors.InternalError:
                continue  # poll timeout: check _stop and re-post
            except (errors.ProcFailed, errors.Revoked):
                # a PEER died (the service's wildcard recv classifies
                # under ULFM's ANY_SOURCE pending semantics until the
                # app acks) — peer death is not SERVICE death: the loop
                # must keep serving the survivors' RMA.  The classify
                # raises immediately, so pace the retry (the recv's
                # 0.25 s cadence) instead of spinning on it.
                if self._stop.wait(0.05):
                    return
                continue
            except Exception:
                return  # endpoint torn down
            try:
                self._dispatch(msg, status.source)
            except errors.MpiError as e:
                # target-side failure travels back on the reply tag when
                # the op is an RPC; fire-and-forget ops (put/acc/unlock/
                # dyn_put/...) have no reply channel — log the loss
                idx = self._REPLY_TAG_INDEX.get(msg[0])
                if idx is not None:
                    self._reply(status.source, msg[idx],
                                ("err", type(e).__name__, str(e)))
                else:
                    mca_output.emit(
                        stream,
                        "one-sided %r from rank %s failed at the target: "
                        "%s: %s", msg[0], status.source,
                        type(e).__name__, e,
                    )

    def _reply(self, origin: int, tag: int, payload: Any) -> None:
        self.ep.send(payload, origin, tag=tag, cid=AM_CID)

    # -- direct-map (region-backed) lock bridge ---------------------------
    # AM origins locking a direct-map window must exclude DIRECT origins
    # manipulating the region header — the service grants against the
    # same shared words, queues what it cannot grant (never blocking the
    # loop), and counts queued waiters in the region's amq word so a
    # direct unlock knows to poke us with a "lock_scan".

    def _region_lock_request(self, st: _AmWinState, origin: int,
                             lock_type: int, reply_tag: int) -> None:
        excl = lock_type == LOCK_EXCLUSIVE
        granted = False
        with st.cond:  # waiter-queue guard
            with st.region.atomic():
                if not st.region_waiters and st.region.try_lock(
                        origin, excl):
                    granted = True
                else:
                    if excl:
                        st.region.mark_waiting(origin)
                    st.region.amq_adjust(+1)
                    st.region_waiters.append(
                        (origin, lock_type, reply_tag))
        if granted:
            self._reply(origin, reply_tag, ("ok", None))

    def _scan_region_waiters(self, st: _AmWinState) -> None:
        grants = []
        state = getattr(self.ep, "ft_state", None)
        with st.cond:
            while st.region_waiters:
                origin, lock_type, tag = st.region_waiters[0]
                excl = lock_type == LOCK_EXCLUSIVE
                with st.region.atomic():
                    if state is not None and state.is_failed(origin):
                        # a dead waiter must not absorb a grant (its
                        # WAITW slot was cleared at classification)
                        st.region.amq_adjust(-1)
                        st.region_waiters.popleft()
                        continue
                    if st.region.try_lock(origin, excl):
                        st.region.amq_adjust(-1)
                        st.region_waiters.popleft()
                        grants.append((origin, tag))
                        if excl:
                            break  # writer got it; nothing can follow
                    else:
                        break
        for origin, tag in grants:
            self._reply(origin, tag, ("ok", None))

    def _win(self, win_id: int) -> _AmWinState:
        st = self.windows.get(win_id)
        if st is None:
            raise errors.WinError(f"unknown window id {win_id}")
        return st

    def _dispatch(self, msg: tuple, origin: int) -> None:
        op = msg[0]
        if op == "put":
            _, win_id, offset, data = msg
            st = self._win(win_id)
            apply_put(st, offset, _np(data))
            spc.record("osc_am_applied", 1)
        elif op == "get":
            _, win_id, offset, count, reply_tag = msg
            st = self._win(win_id)
            with st.apply_lock:
                out = read_window(st, offset, count)
            self._reply(origin, reply_tag, ("ok", out))
        elif op == "acc":
            _, win_id, offset, opname, data = msg
            st = self._win(win_id)
            apply_acc(st, offset, zops.lookup(opname), _np(data))
        elif op == "get_acc":
            _, win_id, offset, opname, data, reply_tag = msg
            st = self._win(win_id)
            old = apply_acc(st, offset, zops.lookup(opname), _np(data))
            self._reply(origin, reply_tag, ("ok", old))
        elif op == "cas":
            _, win_id, offset, compare, value, reply_tag = msg
            compare, value = _np(compare), _np(value)
            st = self._win(win_id)
            with _win_atomic(st):
                flat = st.buffer
                if not 0 <= offset < flat.size:
                    raise errors.WinError(
                        f"compare_and_swap offset {offset} outside window"
                    )
                old = flat[offset].copy()
                if old == compare:
                    flat[offset] = value
            self._reply(origin, reply_tag, ("ok", old))
        elif op == "flush":
            # per-origin FIFO: every earlier op from `origin` has been
            # dispatched by the time we see its flush
            _, win_id, reply_tag = msg
            self._reply(origin, reply_tag, ("ok", None))
        elif op == "lock":
            _, win_id, lock_type, reply_tag = msg
            st = self._win(win_id)
            if st.region is not None:
                # direct-map window: grant against the region header so
                # AM origins and direct origins exclude each other
                self._region_lock_request(st, origin, lock_type,
                                          reply_tag)
            # FIFO fairness: an immediate grant only when nobody is queued
            # — otherwise new SHARED requests would starve a waiting writer
            elif not st.lockman.waiters and st.lockman.try_grant(
                origin, lock_type
            ):
                self._reply(origin, reply_tag, ("ok", None))
            else:
                st.lockman.waiters.append((origin, lock_type, reply_tag))
        elif op == "unlock":
            _, win_id, lock_type = msg
            st = self._win(win_id)
            if st.region is not None:
                st.region.unlock(origin)
                self._scan_region_waiters(st)
            else:
                for w_origin, w_tag in st.lockman.release(origin,
                                                          lock_type):
                    self._reply(w_origin, w_tag, ("ok", None))
        elif op == "lock_scan":
            # a DIRECT origin's unlock saw queued AM waiters (the
            # region's amq word): re-try grants — the header words
            # changed without any message this loop could observe
            _, win_id = msg
            st = self._win(win_id)
            if st.region is not None:
                self._scan_region_waiters(st)
        elif op == "post":
            # target announced an exposure epoch to us (we are an origin)
            _, win_id = msg
            st = self._win(win_id)
            with st.cond:
                st.posts_from[origin] = st.posts_from.get(origin, 0) + 1
                st.cond.notify_all()
        elif op == "complete":
            # an origin finished its access epoch at us (we are a target)
            _, win_id = msg
            st = self._win(win_id)
            with st.cond:
                st.completed_by.add(origin)
                st.cond.notify_all()
        elif op == "dyn_put":
            _, win_id, disp, raw = msg
            raw = _np(raw)
            st = self._win(win_id)
            with st.apply_lock:
                view, off = resolve_dynamic(st, disp, raw.size)
                view[off : off + raw.size] = raw
        elif op == "dyn_get":
            _, win_id, disp, nbytes, reply_tag = msg
            st = self._win(win_id)
            with st.apply_lock:
                view, off = resolve_dynamic(st, disp, nbytes)
                out = view[off : off + nbytes].copy()
            self._reply(origin, reply_tag, ("ok", out))
        elif op == "dyn_iput":
            # strided typed put into an attached region (shmem_iput shape)
            _, win_id, disp, tst, values = msg
            values = _np(values)
            st = self._win(win_id)
            with st.apply_lock:
                span = ((values.size - 1) * tst + 1) * values.itemsize
                view, off = resolve_dynamic(st, disp, span)
                typed = view[off : off + span].view(values.dtype)
                typed[: values.size * tst : tst] = values
        elif op == "dyn_iget":
            # strided typed get from an attached region (shmem_iget shape)
            _, win_id, disp, sst, n, dtstr, reply_tag = msg
            st = self._win(win_id)
            dt = np.dtype(dtstr)
            with st.apply_lock:
                span = ((n - 1) * sst + 1) * dt.itemsize
                view, off = resolve_dynamic(st, disp, span)
                typed = view[off : off + span].view(dt)
                out = typed[: n * sst : sst].copy()
            self._reply(origin, reply_tag, ("ok", out))
        elif op == "dyn_amo":
            # typed atomic at a byte displacement (shmem AMO set; the
            # service loop is the atomicity domain, like BTL atomics)
            _, win_id, disp, kind, value, compare, dtstr, reply_tag = msg
            value, compare = _np(value), _np(compare)
            st = self._win(win_id)
            dt = np.dtype(dtstr)
            with _win_atomic(st):
                view, off = resolve_dynamic(st, disp, dt.itemsize)
                typed = view[off : off + dt.itemsize].view(dt)
                old = typed[0].copy()
                if kind == "add":
                    typed[0] = old + value
                elif kind == "swap":
                    typed[0] = value
                elif kind == "cas":
                    if old == compare:
                        typed[0] = value
                elif kind == "set":
                    typed[0] = value
                elif kind == "fetch":
                    pass
                else:
                    raise errors.InternalError(f"unknown AMO {kind!r}")
            self._reply(origin, reply_tag, ("ok", old))
        elif op == "dlock":
            # distributed lock (shmem_set_lock): per-offset lock manager
            # at the home PE; blocking requests queue for a grant reply
            _, win_id, key, reply_tag = msg
            st = self._win(win_id)
            man = st.dist_locks.setdefault(key, _LockManager())
            if not man.waiters and man.try_grant(origin, LOCK_EXCLUSIVE):
                self._reply(origin, reply_tag, ("ok", None))
            else:
                man.waiters.append((origin, LOCK_EXCLUSIVE, reply_tag))
        elif op == "dtrylock":
            _, win_id, key, reply_tag = msg
            st = self._win(win_id)
            man = st.dist_locks.setdefault(key, _LockManager())
            self._reply(
                origin, reply_tag,
                ("ok", man.try_grant(origin, LOCK_EXCLUSIVE)),
            )
        elif op == "dunlock":
            _, win_id, key = msg
            st = self._win(win_id)
            man = st.dist_locks.setdefault(key, _LockManager())
            for w_origin, w_tag in man.release(origin, LOCK_EXCLUSIVE):
                self._reply(w_origin, w_tag, ("ok", None))
        else:
            raise errors.InternalError(f"unknown AM op {op!r}")


# -- target-side apply helpers (shared by the service loop and the local
#    fast path, under the state's apply lock) ------------------------------


def apply_put(st: _AmWinState, offset: int, data: np.ndarray) -> None:
    with st.apply_lock:
        flat = st.buffer
        n = data.size
        if offset < 0 or offset + n > flat.size:
            raise errors.WinError(
                f"put of {n} at {offset} overruns window of {flat.size}"
            )
        flat[offset : offset + n] = data.reshape(-1).astype(flat.dtype)


def read_window(st: _AmWinState, offset: int, count: int | None
                ) -> np.ndarray:
    flat = st.buffer
    if offset < 0 or offset > flat.size:
        raise errors.WinError(
            f"get offset {offset} outside window of {flat.size}"
        )
    count = flat.size - offset if count is None else count
    if count < 0 or offset + count > flat.size:
        raise errors.WinError("get overruns window")
    return flat[offset : offset + count].copy()


def apply_acc(st: _AmWinState, offset: int, op: zops.Op, data: np.ndarray
              ) -> np.ndarray:
    with _win_atomic(st):
        flat = st.buffer
        n = data.size
        if offset < 0 or offset + n > flat.size:
            raise errors.WinError("accumulate overruns window")
        old = flat[offset : offset + n].copy()
        flat[offset : offset + n] = rma_util.apply_op(
            op, data.reshape(-1).astype(flat.dtype), old
        )
        return old


def resolve_dynamic(st: _AmWinState, disp: int, nbytes: int
                    ) -> tuple[np.ndarray, int]:
    for base, region in st.dynamic.items():
        if base <= disp and disp + nbytes <= base + region.nbytes:
            return region.reshape(-1).view(np.uint8), disp - base
    raise errors.WinError(
        f"RMA [{disp}, {disp + nbytes}) outside attached regions"
    )


class AmWindow(errh.HasErrhandler, rma_util.FetchOpMixin):
    """MPI window over a wire endpoint — HostWindow-compatible surface.
    Defaults to MPI_ERRORS_RETURN (the reference's window default);
    honors the "no_locks" info assertion."""

    _default_errhandler = errh.ERRORS_RETURN

    @classmethod
    def create(cls, ep, local_buffer: np.ndarray, info=None) -> "AmWindow":
        """MPI_Win_create, collective over the endpoint's group."""
        local_buffer = rma_util.window_buffer(local_buffer)
        if not local_buffer.flags["C_CONTIGUOUS"]:
            raise errors.WinError(
                "window buffer must be C-contiguous (RMA writes go through "
                "a flat view)"
            )
        svc = AmService.ensure(ep)
        win_id = ep.bcast(
            next(svc.win_ids) if ep.rank == 0 else None, root=0
        )
        st = _AmWinState(ep.size, local_buffer.reshape(-1))
        svc.windows[win_id] = st
        ep.barrier()  # every rank registered before any RMA can arrive
        return cls(ep, svc, win_id, st, local_buffer, info=info)

    def __init__(self, ep, svc: AmService, win_id: int, st: _AmWinState,
                 local_buffer: np.ndarray, info=None):
        self.ctx = ep  # HostWindow-compatible attribute
        self.ep = ep
        self.svc = svc
        self.win_id = win_id
        self.st = st
        self.local_buffer = local_buffer
        self.info = info_mod.coerce(info)
        self.name = f"amwin{win_id}"
        self._held: dict[int, list[int]] = {}  # target -> lock types held
        self._dirty: set[int] = set()  # targets with unflushed ops
        self._started: list[int] = []
        self._seen_post: dict[int, int] = {}

    # -- plumbing ---------------------------------------------------------

    def _send(self, target: int, msg: tuple) -> None:
        self.ep.send(msg, target, tag=AM_REQ_TAG, cid=AM_CID)

    def _classify_target(self, target: int):
        """Typed issue-time classification (the isend contract):
        an RPC toward a KNOWN-failed target or over a revoked channel
        raises ``ProcFailed``/``Revoked`` instead of burning the RPC
        timeout into a bare-timeout error.  Returns the FailureState
        (None on non-ft endpoints) for the wait loop's re-checks."""
        state = getattr(self.ep, "ft_state", None)
        if state is None:
            return None
        state.check_revoked(AM_CID)
        if state.is_failed(target):
            raise errors.ProcFailed(
                f"one-sided target rank {target} is known failed "
                f"(cause: {state.cause_of(target)})",
                failed_ranks=state.failed(),
            )
        return state

    def _rpc(self, target: int, msg_head: tuple, timeout: float = 30.0):
        """Request expecting a reply: post the reply recv, send, wait.
        The wait is FAILURE-AWARE, not deadline-only: a target that
        enters the FailureState (or a revoke landing) mid-wait raises
        typed within one slice instead of a bare 30 s timeout."""
        state = self._classify_target(target)
        reply_tag = next(self.svc.reply_tags)
        rreq = self.ep.irecv(source=target, tag=reply_tag, cid=AM_CID)
        self._send(target, msg_head + (reply_tag,))
        deadline = time.monotonic() + timeout
        while True:
            try:
                out = rreq.wait(min(0.5, max(0.05, deadline
                                             - time.monotonic())))
                break
            except errors.RequestError:
                # slice lapsed: classify before the next park — the
                # request itself also completes ERRORED on a NEW
                # classification (the failure-aware irecv), this
                # covers targets that were failed/revoked already
                if state is not None:
                    self._classify_target(target)
                if time.monotonic() >= deadline:
                    raise
        if out[0] == "err":
            cls_ = getattr(errors, out[1], errors.MpiError)
            raise cls_(out[2])
        return _np(out[1])

    # -- communication ----------------------------------------------------

    def put(self, data, target: int, offset: int = 0) -> None:
        """MPI_Put: fire-and-forget AM; completion at flush/fence/unlock."""
        from ..utils import memchecker

        memchecker.check_send_buffer(data, "MPI_Put")
        data = rma_util.host_array(data)
        spc.record("osc_puts", 1)
        spc.record("osc_bytes_put", int(data.nbytes))
        if target == self.ep.rank:
            apply_put(self.st, offset, data)
            return
        self._send(target, ("put", self.win_id, offset, data))
        self._dirty.add(target)

    def get(self, target: int, offset: int = 0, count: int | None = None,
            out=None) -> np.ndarray:
        """MPI_Get (synchronous here: the reply IS the completion); into
        ``out`` when given (:func:`rma_util.deliver`)."""
        spc.record("osc_gets", 1)
        if target == self.ep.rank:
            with self.st.apply_lock:
                return rma_util.deliver(
                    read_window(self.st, offset, count), out)
        return rma_util.deliver(
            self._rpc(target, ("get", self.win_id, offset, count)), out)

    def accumulate(self, data, target: int, offset: int = 0,
                   op: zops.Op = zops.SUM) -> None:
        """MPI_Accumulate: applied atomically at the target (the service
        loop is the serialization point, as BTL atomics are in osc/rdma).
        Predefined ops only — MPI's own accumulate rule."""
        from ..utils import memchecker

        memchecker.check_send_buffer(data, "MPI_Accumulate")
        data = rma_util.host_array(data)
        if target == self.ep.rank:
            apply_acc(self.st, offset, op, data)
            return
        self._send(target, ("acc", self.win_id, offset, op.name, data))
        self._dirty.add(target)

    def get_accumulate(self, data, target: int, offset: int = 0,
                       op: zops.Op = zops.SUM) -> np.ndarray:
        """MPI_Get_accumulate: fetch-and-op."""
        from ..utils import memchecker

        memchecker.check_send_buffer(data, "MPI_Get_accumulate")
        data = rma_util.host_array(data)
        if target == self.ep.rank:
            return apply_acc(self.st, offset, op, data)
        return self._rpc(
            target, ("get_acc", self.win_id, offset, op.name, data)
        )

    def compare_and_swap(self, value, compare, target: int, offset: int = 0):
        """MPI_Compare_and_swap (single element)."""
        if target == self.ep.rank:
            with _win_atomic(self.st):
                flat = self.st.buffer
                if not 0 <= offset < flat.size:
                    raise errors.WinError(
                        f"compare_and_swap offset {offset} outside window "
                        f"of {flat.size}"
                    )
                old = flat[offset].copy()
                if old == compare:
                    flat[offset] = value
            return old
        return self._rpc(
            target, ("cas", self.win_id, offset, compare, value)
        )

    # -- request-based RMA (MPI_Rput/Rget/Raccumulate family) -------------

    def _async_rpc(self, target: int, msg_head: tuple):
        """RPC returning a Request that completes with the reply — the
        request-based RMA substrate (true overlap: the reply recv is
        posted, the request fires, the caller waits whenever it wants)."""
        from ..pt2pt.requests import Request

        self._classify_target(target)  # typed at issue, like _rpc
        reply_tag = next(self.svc.reply_tags)
        inner = self.ep.irecv(source=target, tag=reply_tag, cid=AM_CID)
        req = Request()

        def progress():
            if not inner.done:
                return
            out = inner._value
            if out[0] == "err":
                cls_ = getattr(errors, out[1], errors.MpiError)
                raise cls_(out[2])
            req.complete(_np(out[1]), source=target)

        req._progress = progress
        self._send(target, msg_head + (reply_tag,))
        return req

    def rput(self, data, target: int, offset: int = 0):
        """MPI_Rput: the request completes at LOCAL completion — the AM
        payload is serialized at send time, so the buffer is immediately
        reusable (remote completion still requires flush/unlock, per the
        MPI contract)."""
        self.put(data, target, offset)
        return rma_util.completed_request()

    def raccumulate(self, data, target: int, offset: int = 0,
                    op: zops.Op = zops.SUM):
        """MPI_Raccumulate: local completion, like rput."""
        self.accumulate(data, target, offset, op)
        return rma_util.completed_request()

    def rget(self, target: int, offset: int = 0, count: int | None = None):
        """MPI_Rget: returns a Request completing with the data — the
        genuinely asynchronous one (overlap computation with the fetch)."""
        if target == self.ep.rank:
            with self.st.apply_lock:
                out = read_window(self.st, offset, count)
            return rma_util.completed_request(out)
        return self._async_rpc(target, ("get", self.win_id, offset, count))

    def rget_accumulate(self, data, target: int, offset: int = 0,
                        op: zops.Op = zops.SUM):
        """MPI_Rget_accumulate: asynchronous fetch-and-op."""
        data = rma_util.host_array(data)
        if target == self.ep.rank:
            return rma_util.completed_request(
                apply_acc(self.st, offset, op, data)
            )
        return self._async_rpc(
            target, ("get_acc", self.win_id, offset, op.name, data)
        )

    # -- synchronization --------------------------------------------------

    def flush(self, target: int | None = None) -> None:
        """MPI_Win_flush: ack round-trip; per-origin FIFO at the target
        proves every earlier op from this origin is applied."""
        targets = (
            list(self._dirty) if target is None else [target]
        )
        for t in targets:
            if t == self.ep.rank:
                continue
            self._rpc(t, ("flush", self.win_id))
            self._dirty.discard(t)

    def flush_all(self) -> None:
        self.flush(None)

    def flush_local(self, target: int | None = None) -> None:
        """MPI_Win_flush_local: AM payloads are serialized at send time,
        so local completion is immediate."""

    def fence(self) -> None:
        """MPI_Win_fence: everyone completes their outgoing epoch, then a
        barrier closes the exposure epoch."""
        self.flush_all()
        self.ep.barrier()

    def lock(self, target: int, lock_type: int = LOCK_EXCLUSIVE) -> None:
        """MPI_Win_lock: request to the target's lock manager; blocks
        until granted.  SHARED locks genuinely coexist."""
        if self.info.get_bool("no_locks"):
            raise errors.WinError(
                "window created with no_locks=true (MPI info assertion)"
            )
        self._rpc(target, ("lock", self.win_id, lock_type))
        self._held.setdefault(target, []).append(lock_type)

    def unlock(self, target: int) -> None:
        """MPI_Win_unlock: flush then release (unlock completes all ops)."""
        held = self._held.get(target)
        if not held:
            raise errors.WinError(f"unlock of {target} without lock")
        if target in self._dirty:
            self._rpc(target, ("flush", self.win_id))
            self._dirty.discard(target)
        lock_type = held.pop()
        self._send(target, ("unlock", self.win_id, lock_type))

    def lock_all(self) -> None:
        """MPI_Win_lock_all: shared epoch at every target, rank order."""
        for t in range(self.ep.size):
            self.lock(t, LOCK_SHARED)

    def unlock_all(self) -> None:
        for t in range(self.ep.size):
            self.unlock(t)

    # -- PSCW -------------------------------------------------------------

    def post(self, origins: list[int] | None = None) -> None:
        """MPI_Win_post: open an exposure epoch for `origins` and tell
        each of them (identity-checked — wait_sync completes only when
        exactly these origins have completed)."""
        origins = (
            [r for r in range(self.ep.size) if r != self.ep.rank]
            if origins is None else list(origins)
        )
        st = self.st
        with st.cond:
            st.completed_by.clear()
            st.expected_origins = set(origins)
        for o in origins:
            self._send(o, ("post", self.win_id))

    def start(self, targets: list[int], timeout: float = 10.0) -> None:
        """MPI_Win_start: wait for a fresh post from every target."""
        st = self.st
        with st.cond:
            for t in targets:
                seen = self._seen_post.get(t, 0)
                if not st.cond.wait_for(
                    lambda t=t, s=seen: st.posts_from.get(t, 0) > s,
                    timeout=timeout,
                ):
                    raise errors.WinError("start: target never posted")
                self._seen_post[t] = st.posts_from[t]
        self._started = list(targets)

    def complete(self) -> None:
        """MPI_Win_complete: flush RMA to every started target, then
        notify them."""
        for t in self._started:
            if t != self.ep.rank and t in self._dirty:
                self._rpc(t, ("flush", self.win_id))
                self._dirty.discard(t)
            self._send(t, ("complete", self.win_id))
        self._started = []

    def wait_sync(self, timeout: float = 10.0) -> None:
        """MPI_Win_wait: block until exactly the posted origins completed."""
        st = self.st
        with st.cond:
            if st.expected_origins is None:
                raise errors.WinError("wait_sync without a post")
            if not st.cond.wait_for(
                lambda: st.expected_origins <= st.completed_by,
                timeout=timeout,
            ):
                missing = st.expected_origins - st.completed_by
                raise errors.WinError(
                    f"wait_sync: origins {sorted(missing)} never completed"
                )
            st.completed_by.clear()
            st.expected_origins = None

    # -- allocation variants ----------------------------------------------

    @classmethod
    def allocate(cls, ep, nbytes: int, dtype=np.uint8) -> "AmWindow":
        """MPI_Win_allocate."""
        buf = np.zeros(nbytes // np.dtype(dtype).itemsize, dtype)
        win = cls.create(ep, buf)
        win.base = buf
        return win

    @classmethod
    def allocate_shared(cls, ep, nbytes: int, dtype=np.uint8):
        """MPI_Win_allocate_shared requires a shared-memory communicator;
        wire endpoints are by definition not one (MPI_Comm_split_type
        would put them in different SHARED groups)."""
        raise errors.WinError(
            "allocate_shared is invalid over a wire endpoint: no common "
            "shared memory (split_type(SHARED) semantics)"
        )

    # -- dynamic windows --------------------------------------------------

    @classmethod
    def create_dynamic(cls, ep) -> "AmWindow":
        """MPI_Win_create_dynamic."""
        win = cls.create(ep, np.zeros(0, np.uint8))
        win._is_dynamic = True
        return win

    def attach(self, region: np.ndarray) -> int:
        """Attach local memory; the returned displacement is what remote
        ranks address (exchanged out-of-band by the caller, as MPI
        addresses are)."""
        if not getattr(self, "_is_dynamic", False):
            raise errors.WinError("attach requires a dynamic window")
        region = rma_util.window_buffer(region)
        if not region.flags["C_CONTIGUOUS"]:
            raise errors.WinError("attached region must be C-contiguous")
        st = self.st
        with st.apply_lock:
            disp = st.dynamic_next
            st.dynamic_next += max(1, region.nbytes)
            st.dynamic[disp] = region
        return disp

    def detach(self, disp: int) -> None:
        st = self.st
        with st.apply_lock:
            if disp not in st.dynamic:
                raise errors.WinError(f"no region attached at {disp}")
            del st.dynamic[disp]

    def dyn_put(self, data, target: int, disp: int) -> None:
        raw = np.frombuffer(
            np.ascontiguousarray(rma_util.host_array(data)).tobytes(),
            np.uint8)
        if target == self.ep.rank:
            with self.st.apply_lock:
                view, off = resolve_dynamic(self.st, disp, raw.size)
                view[off : off + raw.size] = raw
            return
        self._send(target, ("dyn_put", self.win_id, disp, raw))
        self._dirty.add(target)

    def dyn_get(self, target: int, disp: int, nbytes: int) -> np.ndarray:
        if target == self.ep.rank:
            with self.st.apply_lock:
                view, off = resolve_dynamic(self.st, disp, nbytes)
                return view[off : off + nbytes].copy()
        return self._rpc(target, ("dyn_get", self.win_id, disp, nbytes))

    # -- typed/strided/atomic dynamic ops (the shmem substrate) -----------

    def dyn_iput(self, values: np.ndarray, target: int, disp: int,
                 tst: int = 1) -> None:
        """Strided typed put (shmem_iput): values land at target stride
        `tst` elements starting at byte displacement `disp`."""
        values = np.ascontiguousarray(rma_util.host_array(values)
                                      ).reshape(-1)
        if target == self.ep.rank:
            with self.st.apply_lock:
                span = ((values.size - 1) * tst + 1) * values.itemsize
                view, off = resolve_dynamic(self.st, disp, span)
                typed = view[off : off + span].view(values.dtype)
                typed[: values.size * tst : tst] = values
            return
        self._send(target, ("dyn_iput", self.win_id, disp, tst, values))
        self._dirty.add(target)

    def dyn_iget(self, target: int, disp: int, n: int, dtype,
                 sst: int = 1) -> np.ndarray:
        """Strided typed get (shmem_iget): n elements at source stride
        `sst` from byte displacement `disp`."""
        dt = np.dtype(dtype)
        if target == self.ep.rank:
            with self.st.apply_lock:
                span = ((n - 1) * sst + 1) * dt.itemsize
                view, off = resolve_dynamic(self.st, disp, span)
                return view[off : off + span].view(dt)[: n * sst : sst].copy()
        return self._rpc(
            target, ("dyn_iget", self.win_id, disp, sst, n, dt.str)
        )

    def dyn_get_nbi(self, target: int, disp: int, nbytes: int):
        """Nonblocking dynamic get (the shmem_get_nbi substrate,
        ``oshmem/shmem/c/shmem_get_nb.c``): returns a Request completing
        with the raw bytes — the reply recv is posted and the caller
        overlaps compute until it waits (normally at shmem_quiet)."""
        if target == self.ep.rank:
            with self.st.apply_lock:
                view, off = resolve_dynamic(self.st, disp, nbytes)
                return rma_util.completed_request(
                    view[off : off + nbytes].copy())
        return self._async_rpc(target, ("dyn_get", self.win_id, disp, nbytes))

    def dyn_amo(self, target: int, disp: int, kind: str, dtype,
                value=None, compare=None):
        """Typed atomic (shmem AMO): add/swap/cas/set/fetch at a byte
        displacement; returns the old value."""
        dt = np.dtype(dtype)
        return self._rpc(
            target,
            ("dyn_amo", self.win_id, disp, kind, value, compare, dt.str),
        )

    # -- distributed per-key locks (shmem_set_lock substrate) -------------

    def dist_lock(self, target: int, key: int,
                  timeout: float = 30.0) -> None:
        self._rpc(target, ("dlock", self.win_id, key), timeout=timeout)

    def dist_trylock(self, target: int, key: int) -> bool:
        return self._rpc(target, ("dtrylock", self.win_id, key))

    def dist_unlock(self, target: int, key: int) -> None:
        self._send(target, ("dunlock", self.win_id, key))

    def free(self) -> None:
        """MPI_Win_free: collective; quiesce then drop the registration."""
        self.flush_all()
        self.ep.barrier()
        self.svc.windows.pop(self.win_id, None)
        self.ep.barrier()


def create_window(ctx, local_buffer: np.ndarray):
    """Component selection (osc_rdma_component.c:231-236 analog): direct
    memory for thread-universe ranks (osc/sm — highest priority where
    buffers are addressable), AM over the wire otherwise."""
    from .window import HostWindow

    if hasattr(ctx, "universe"):
        return HostWindow.create(ctx, local_buffer)
    return AmWindow.create(ctx, local_buffer)
