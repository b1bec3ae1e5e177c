"""Attachable error handlers (reference: ``ompi/errhandler/errhandler.h:94-136``).

The reference attaches an ``ompi_errhandler_t`` to every communicator,
window, and file; failures route through ``OMPI_ERRHANDLER_INVOKE`` to the
object's handler — MPI_ERRORS_ARE_FATAL aborts the job,
MPI_ERRORS_RETURN hands the code back to the caller, and user handlers
run a callback first.  Python-native dispositions:

- :data:`ERRORS_ARE_FATAL` — escalate to :class:`JobAbort` (the
  MPI_Abort path: unrecoverable, carries the failing object's name).
- :data:`ERRORS_RETURN` — re-raise the typed ``MpiError`` to the caller
  (the exception IS the returned error code; ``errclass`` carries the
  MPI numbering).
- a user callable ``handler(obj, exc)`` — runs first; whatever it
  returns becomes the API result (error recovery), or it may re-raise.

Objects mix in :class:`HasErrhandler` and wrap fallible entry points in
``self._errhandler_guard(...)``.
"""

from __future__ import annotations

from typing import Any, Callable

from . import errors


class JobAbort(BaseException):
    """MPI_ERRORS_ARE_FATAL's abort: deliberately NOT an MpiError (it must
    not be caught by error-class handlers, like the reference's abort
    path bypassing the errhandler machinery)."""

    def __init__(self, obj_name: str, exc: errors.MpiError):
        super().__init__(
            f"MPI_ERRORS_ARE_FATAL: aborting after "
            f"{type(exc).__name__} on {obj_name}: {exc}"
        )
        self.errclass = exc.errclass
        self.cause = exc
        # ULFM causes carry the failed-rank set through the abort so the
        # launcher can report WHO died, not just that something did
        self.failed_ranks = tuple(getattr(exc, "failed_ranks", ()))


class Errhandler:
    """An attachable disposition (MPI_Errhandler)."""

    def __init__(self, fn: Callable[[Any, errors.MpiError], Any] | None,
                 name: str):
        self._fn = fn
        self.name = name

    def invoke(self, obj, exc: errors.MpiError):
        if self._fn is None:  # ERRORS_RETURN
            raise exc
        return self._fn(obj, exc)


def _fatal(obj, exc: errors.MpiError):
    raise JobAbort(getattr(obj, "name", repr(obj)), exc)


#: MPI_ERRORS_ARE_FATAL (the reference's default for communicators)
ERRORS_ARE_FATAL = Errhandler(_fatal, "MPI_ERRORS_ARE_FATAL")
#: MPI_ERRORS_RETURN (the reference's default for windows/files)
ERRORS_RETURN = Errhandler(None, "MPI_ERRORS_RETURN")


def create(fn: Callable[[Any, errors.MpiError], Any],
           name: str = "user_errhandler") -> Errhandler:
    """MPI_Comm_create_errhandler: wrap a user callback."""
    return Errhandler(fn, name)


class HasErrhandler:
    """Mixin: per-object errhandler attachment + the invoke guard."""

    _errhandler: Errhandler | None = None
    _default_errhandler: Errhandler = ERRORS_ARE_FATAL

    def set_errhandler(self, handler: Errhandler) -> None:
        """MPI_{Comm,Win,File}_set_errhandler."""
        if not isinstance(handler, Errhandler):
            raise errors.ArgError("expected an Errhandler")
        self._errhandler = handler

    def get_errhandler(self) -> Errhandler:
        return self._errhandler or self._default_errhandler

    def call_errhandler(self, exc: errors.MpiError):
        """MPI_Comm_call_errhandler: route a caller-detected error through
        the attached disposition."""
        return self.get_errhandler().invoke(self, exc)

    def _errhandler_guard(self, fn: Callable, *args, **kwargs):
        """Run an API body; failures route through the attached handler
        (OMPI_ERRHANDLER_INVOKE at the binding layer)."""
        try:
            return fn(*args, **kwargs)
        except errors.MpiError as e:
            return self.get_errhandler().invoke(self, e)
