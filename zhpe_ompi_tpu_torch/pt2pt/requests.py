"""Request objects — ``ompi_request_t`` re-designed (namesake:
``zhpe_ompi_tpu/pt2pt/requests.py``; the port's own copy).

The reference couples requests to the progress engine through wait_sync
(``ompi/request/request.h:399-414``); here a request is a small state machine
completed by transport callbacks, and ``wait`` drives the caller's progress
loop (MPI weak-progress semantics: progress happens inside MPI calls).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable

from ..core import errors
from ..utils import lockdep


@dataclass
class Status:
    """MPI_Status analog.  ``count_bytes`` is the received payload size
    (array/bytes payloads; -1 when unsized), feeding :func:`get_count`."""

    source: int = -1
    tag: int = -1
    error: int = 0
    cancelled: bool = False
    count_bytes: int = -1


UNDEFINED = -1  # MPI_UNDEFINED


def get_count(status: Status, datatype) -> int:
    """MPI_Get_count: whole elements of `datatype` in the message;
    UNDEFINED when the byte count is unknown or not a whole multiple
    (mpi-standard semantics)."""
    size = getattr(datatype, "size", 0)
    if status.count_bytes < 0:
        return UNDEFINED
    if size <= 0:
        # MPI: zero-size datatype receives 0 elements of a 0-byte
        # message; anything else is not a whole count
        return 0 if status.count_bytes == 0 else UNDEFINED
    if status.count_bytes % size:
        return UNDEFINED
    return status.count_bytes // size


def _payload_bytes(value) -> int:
    """Byte size of a received payload, -1 for unsized Python objects."""
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:  # ndarray AND memoryview land here
        return int(nbytes)
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    return -1


class Request:
    __slots__ = ("_done", "_value", "status", "_lock", "_progress",
                 "_cancel_fn", "_error", "_dispatch", "__weakref__")

    def __init__(self, progress: Callable[[], None] | None = None,
                 cancel_fn: Callable[["Request"], bool] | None = None,
                 dispatch: Callable | None = None):
        self._done = threading.Event()
        self._value: Any = None
        self.status = Status()
        # witnessed: completion runs under TRANSPORT locks (the drain
        # worker's ch.lock, the push's _rndv_lock) — the interprocedural
        # order the static rule cannot see
        self._lock = lockdep.lock("pt2pt.Request._lock")
        self._progress = progress
        self._cancel_fn = cancel_fn
        self._error: Any = None
        self._dispatch = dispatch

    # -- completion (called by transports) -------------------------------

    def complete(self, value: Any = None, source: int = -1, tag: int = -1
                 ) -> bool:
        """Complete successfully; returns False when the request already
        completed.  First completion wins: a transport callback racing a
        failure classifier (peer death poisoning a parked send) must not
        flip an already-observed outcome."""
        with self._lock:
            if self._done.is_set():
                return False
            self._value = value
            self.status.source = source
            self.status.tag = tag
            self.status.count_bytes = _payload_bytes(value)
            self._done.set()
            return True

    def complete_error(self, exc) -> bool:
        """Complete ERRORED with a typed exception: ``wait``/``test``
        then raise it (or route it through the endpoint's errhandler
        disposition when the request was built with ``dispatch``) —
        the MPI contract that a failed nonblocking operation surfaces
        its error at completion, not at the next blocking call.  First
        completion wins, like :meth:`complete`."""
        with self._lock:
            if self._done.is_set():
                return False
            self._error = exc
            self.status.error = 1
            self._done.set()
            return True

    @property
    def error(self):
        """The typed failure this request completed with (None while
        incomplete or on success) — the raw, un-dispatched view
        framework loops (nbc round schedules) read at round boundaries."""
        return self._error

    def _resolve(self):
        """Completed-request outcome: raise/dispatch the error, or
        return the value.  The errhandler dispatch runs EXACTLY ONCE —
        a recovering user handler's side effects must not repeat on
        every wait()/test() poll of the same request; its return value
        (or the exception it raised) is cached as the request's
        permanent outcome."""
        if self._error is None:
            return self._value
        if self._dispatch is None:
            raise self._error  # poll path: raw typed raise, idempotent
        with self._lock:
            dispatch, self._dispatch = self._dispatch, None
        if dispatch is None:
            # already dispatched (a concurrent waiter won the swap):
            # re-read the OUTCOME under the lock — the winner may have
            # cached a recovery value (error cleared) or the dispatched
            # exception; a racing read between its swap and its cache
            # write sees the original typed error, which is still a
            # sane raise (never `raise None`)
            with self._lock:
                if self._error is None:
                    return self._value
                raise self._error
        try:
            # FATAL aborts, RETURN raises typed, a user handler's
            # return value becomes the result (the same disposition
            # contract blocking send/recv apply at the call site)
            value = dispatch(self._error)
        except BaseException as e:
            with self._lock:
                self._error = e
            raise
        with self._lock:
            self._value = value
            self._error = None
        return value

    # -- user side --------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def test(self):
        """MPI_Test: (flag, value-or-None); non-blocking, drives progress.
        A request that completed ERRORED raises (or dispatches) its typed
        error here, like :meth:`wait`."""
        if not self._done.is_set() and self._progress is not None:
            self._progress()
        if self._done.is_set():
            return True, self._resolve()
        return False, None

    def wait(self, timeout: float | None = None):
        """MPI_Wait: drive progress until complete; returns the payload.
        A request that completed ERRORED raises (or dispatches) its
        typed error — deferred operations surface failure at completion."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        # weak progress needs a short tick; a completion-driven request
        # (transport callback sets the event) parks in long slices —
        # sub-ms polling wakeups measurably steal scheduler quanta from
        # the very threads doing the completing on oversubscribed hosts
        step = 0.0005 if self._progress is not None else 0.05
        while not self._done.is_set():
            if self._progress is not None:
                self._progress()
            if self._done.is_set():
                break
            if deadline is not None and time.monotonic() > deadline:
                raise errors.RequestError("wait timed out")
            self._done.wait(step)
        return self._resolve()

    def cancel(self) -> bool:
        """MPI_Cancel: succeeds only if the request hasn't matched yet."""
        if self._done.is_set():
            return False
        if self._cancel_fn is not None and self._cancel_fn(self):
            self.status.cancelled = True
            self._done.set()
            return True
        return False


class SendRequest(Request):
    """A deferred-contract nonblocking send (true ``MPI_Isend``
    semantics): ``isend`` PINS the caller's buffers — ``pinned`` holds
    the ``dss.pack_frames`` memoryview segments referencing them, zero
    copies — and hands them to the transport's progress engine; the
    request completes only once the kernel (or the peer's ring) has the
    bytes.  The buffer-reuse contract is therefore deferred to
    completion: mutating the buffer before ``wait()`` returns is
    undefined, mutating it after is guaranteed invisible to the
    receiver.  An in-flight send whose peer dies (or whose cid is
    revoked) completes ERRORED with the same typed exception the
    blocking path raises."""

    __slots__ = ("_pinned", "_owned")

    def __init__(self, pinned=None, progress: Callable | None = None,
                 dispatch: Callable | None = None):
        super().__init__(progress=progress, dispatch=dispatch)
        self._pinned = pinned
        # transport ownership flag: True while a worker is actively
        # sending this frame — failure classifiers must then leave the
        # outcome to the transport (a peer's orderly goodbye racing the
        # gap between a delivered sendmsg and complete() must not error
        # an already-delivered send); reverts to False for an RTS whose
        # rendezvous data is still parked awaiting the CTS
        self._owned = False

    @classmethod
    def completed(cls) -> "SendRequest":
        """A born-complete send (loopback / ring copy-in already done)."""
        req = cls()
        req.complete()
        return req

    @classmethod
    def errored(cls, exc, dispatch: Callable | None = None
                ) -> "SendRequest":
        """A send that cannot be posted (revoked cid, known-failed
        destination): an errored Request instead of a synchronous raise,
        so nbc/han waitall loops observe the typed error at completion
        like the MPI contract says."""
        req = cls(dispatch=dispatch)
        req.complete_error(exc)
        return req


class GeneralizedRequest(Request):
    """MPI generalized requests (``ompi/request/grequest.h:29-61``): a
    user-defined operation that completes through the standard request
    machinery.  ``start`` registers the user's query/free/cancel
    callbacks; the code running the operation calls :meth:`complete` (the
    MPI_Grequest_complete analog); wait/test then behave like any request.

    - ``query_fn(extra_state, status)`` runs when the completed request
      is inspected (wait/test), letting the user fill the status — called
      exactly once per completion, per the spec.
    - ``free_fn(extra_state)`` runs when the request is freed (after a
      successful wait).
    - ``cancel_fn(extra_state, completed)`` implements MPI_Cancel.
    """

    __slots__ = ("_query_fn", "_free_fn", "_gcancel_fn", "_extra",
                 "_queried", "_freed")

    @classmethod
    def start(cls, query_fn: Callable | None = None,
              free_fn: Callable | None = None,
              cancel_fn: Callable | None = None,
              extra_state: Any = None) -> "GeneralizedRequest":
        """MPI_Grequest_start."""
        return cls(query_fn, free_fn, cancel_fn, extra_state)

    def __init__(self, query_fn=None, free_fn=None, cancel_fn=None,
                 extra_state=None):
        super().__init__(cancel_fn=self._do_cancel)
        self._query_fn = query_fn
        self._free_fn = free_fn
        self._gcancel_fn = cancel_fn
        self._extra = extra_state
        self._queried = False
        self._freed = False

    def _do_cancel(self, _req) -> bool:
        if self._gcancel_fn is not None:
            return bool(self._gcancel_fn(self._extra, self.done))
        return False

    def _run_query(self) -> None:
        if self._queried or self._query_fn is None:
            return
        self._queried = True
        self._query_fn(self._extra, self.status)

    def test(self):
        flag, value = super().test()
        if flag:
            self._run_query()
            self.free()  # a successful MPI_Test frees, like MPI_Wait
        return flag, value

    def wait(self, timeout: float | None = None):
        value = super().wait(timeout)
        self._run_query()
        self.free()
        return value

    def free(self) -> None:
        """MPI_Request_free on a completed generalized request."""
        if not self._freed and self._free_fn is not None:
            self._freed = True
            self._free_fn(self._extra)


def wait_all(requests, timeout: float | None = None):
    """MPI_Waitall."""
    return [r.wait(timeout) for r in requests]


def wait_any(requests):
    """MPI_Waitany: (index, value) of the first completed request.
    Polls with a bounded exponential backoff: ``test()`` drives each
    request's progress, so the first sweeps stay tight for fast
    completions, but a long park must not hot-spin — sub-ms wakeups
    steal scheduler quanta from the completing threads on
    oversubscribed hosts."""
    import time

    delay = 0.0002
    while True:
        for i, r in enumerate(requests):
            flag, val = r.test()
            if flag:
                return i, val
        time.sleep(delay)
        delay = min(delay * 2, 0.005)


def test_all(requests):
    """MPI_Testall."""
    results = [r.test() for r in requests]
    if all(f for f, _ in results):
        return True, [v for _, v in results]
    return False, None
