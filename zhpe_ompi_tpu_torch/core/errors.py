"""Error model: MPI-style error classes and exceptions.

The PyTorch port's own copy of ``zhpe_ompi_tpu/core/errors.py`` (the port
imports nothing of the JAX package).  Re-design of the reference's error
machinery
(``ompi/errhandler/errhandler.h``, error codes in ``ompi/include/mpi.h.in``).
The reference attaches error handlers to communicators/windows/files and maps
every failure to an integer error class; here the Python-native idiom is an
exception hierarchy that still carries the MPI error class so tooling and
tests can assert on codes.
"""

from __future__ import annotations

# MPI error classes (numbering follows the MPI standard; the reference defines
# these in ompi/include/mpi.h.in).
SUCCESS = 0
ERR_BUFFER = 1
ERR_COUNT = 2
ERR_TYPE = 3
ERR_TAG = 4
ERR_COMM = 5
ERR_RANK = 6
ERR_REQUEST = 7
ERR_ROOT = 8
ERR_GROUP = 9
ERR_OP = 10
ERR_TOPOLOGY = 11
ERR_DIMS = 12
ERR_ARG = 13
ERR_UNKNOWN = 14
ERR_TRUNCATE = 15
ERR_OTHER = 16
ERR_INTERN = 17
ERR_IN_STATUS = 18
ERR_PENDING = 19
ERR_NO_MEM = 34
ERR_WIN = 45
ERR_KEYVAL = 48
ERR_NOT_INITIALIZED = 60
ERR_UNSUPPORTED = 52
# ULFM fault-tolerance classes (numbering follows the reference fork's
# MPIX_ERR_* extension slots in ompi/include/mpi.h.in)
ERR_PROC_ABORTED = 74
ERR_PROC_FAILED = 75
ERR_PROC_FAILED_PENDING = 76
ERR_REVOKED = 77
# device-plane fault class (no reference slot: the reference watches
# processes only — a wedged accelerator participant is this repro's
# extension, carved from the same MPIX_ERR_* block)
ERR_DEVICE_FAULT = 78

_ERROR_STRINGS = {
    SUCCESS: "MPI_SUCCESS: no error",
    ERR_BUFFER: "MPI_ERR_BUFFER: invalid buffer pointer",
    ERR_COUNT: "MPI_ERR_COUNT: invalid count argument",
    ERR_TYPE: "MPI_ERR_TYPE: invalid datatype argument",
    ERR_TAG: "MPI_ERR_TAG: invalid tag argument",
    ERR_COMM: "MPI_ERR_COMM: invalid communicator",
    ERR_RANK: "MPI_ERR_RANK: invalid rank",
    ERR_REQUEST: "MPI_ERR_REQUEST: invalid request",
    ERR_ROOT: "MPI_ERR_ROOT: invalid root",
    ERR_GROUP: "MPI_ERR_GROUP: invalid group",
    ERR_OP: "MPI_ERR_OP: invalid reduce operation",
    ERR_TOPOLOGY: "MPI_ERR_TOPOLOGY: invalid topology",
    ERR_DIMS: "MPI_ERR_DIMS: invalid dimension argument",
    ERR_ARG: "MPI_ERR_ARG: invalid argument",
    ERR_UNKNOWN: "MPI_ERR_UNKNOWN: unknown error",
    ERR_TRUNCATE: "MPI_ERR_TRUNCATE: message truncated",
    ERR_OTHER: "MPI_ERR_OTHER: known error not in list",
    ERR_INTERN: "MPI_ERR_INTERN: internal error",
    ERR_IN_STATUS: "MPI_ERR_IN_STATUS: error code in status",
    ERR_PENDING: "MPI_ERR_PENDING: pending request",
    ERR_WIN: "MPI_ERR_WIN: invalid window",
    ERR_KEYVAL: "MPI_ERR_KEYVAL: invalid key value",
    ERR_NOT_INITIALIZED: "MPI_ERR_NOT_INITIALIZED: runtime not initialized",
    ERR_UNSUPPORTED: "MPI_ERR_UNSUPPORTED_OPERATION: unsupported operation",
    ERR_PROC_ABORTED: "MPIX_ERR_PROC_ABORTED: process aborted",
    ERR_PROC_FAILED: "MPIX_ERR_PROC_FAILED: process failed",
    ERR_PROC_FAILED_PENDING:
        "MPIX_ERR_PROC_FAILED_PENDING: pending failure blocks a wildcard "
        "receive; acknowledge with failure_ack to continue",
    ERR_REVOKED: "MPIX_ERR_REVOKED: communicator revoked",
    ERR_DEVICE_FAULT:
        "ZMPIX_ERR_DEVICE_FAULT: a device-plane participant missed its "
        "liveness deadline (wedged collective, lost accelerator)",
}


def error_string(errclass: int) -> str:
    """MPI_Error_string equivalent."""
    return _ERROR_STRINGS.get(errclass, f"unknown error class {errclass}")


class MpiError(Exception):
    """Base exception carrying an MPI error class."""

    errclass = ERR_UNKNOWN

    def __init__(self, message: str = "", errclass: int | None = None):
        if errclass is not None:
            self.errclass = errclass
        super().__init__(message or error_string(self.errclass))


class CommError(MpiError):
    errclass = ERR_COMM


class RankError(MpiError):
    errclass = ERR_RANK


class RootError(MpiError):
    errclass = ERR_ROOT


class TagError(MpiError):
    errclass = ERR_TAG


class CountError(MpiError):
    errclass = ERR_COUNT


class TypeError_(MpiError):
    errclass = ERR_TYPE


class OpError(MpiError):
    errclass = ERR_OP


class GroupError(MpiError):
    errclass = ERR_GROUP


class ArgError(MpiError):
    errclass = ERR_ARG


class TruncateError(MpiError):
    errclass = ERR_TRUNCATE


class RequestError(MpiError):
    errclass = ERR_REQUEST


class WinError(MpiError):
    errclass = ERR_WIN


class KeyvalError(MpiError):
    errclass = ERR_KEYVAL


class ResourceError(MpiError):
    errclass = ERR_NO_MEM


class InternalError(MpiError):
    errclass = ERR_INTERN


class NotInitializedError(MpiError):
    errclass = ERR_NOT_INITIALIZED


class UnsupportedError(MpiError):
    errclass = ERR_UNSUPPORTED


class ProcFailed(MpiError):
    """MPIX_ERR_PROC_FAILED: a named peer the operation depends on is dead
    (the ULFM live-failure path — distinct from a stall/timeout).  Carries
    the set of global ranks known failed when it was raised."""

    errclass = ERR_PROC_FAILED

    def __init__(self, message: str = "", failed_ranks=(),
                 errclass: int | None = None):
        super().__init__(message, errclass)
        self.failed_ranks = tuple(sorted(int(r) for r in failed_ranks))


class ProcFailedPending(ProcFailed):
    """MPIX_ERR_PROC_FAILED_PENDING: a wildcard (ANY_SOURCE) receive
    cannot complete because an unacknowledged failure means the awaited
    sender may be dead.  ``failure_ack`` re-enables wildcard receives
    (the ULFM pending contract)."""

    errclass = ERR_PROC_FAILED_PENDING


class DeviceFault(ProcFailed):
    """ZMPIX_ERR_DEVICE_FAULT: a device-plane participant missed its
    liveness deadline — the device-plane twin of :class:`ProcFailed`
    (a subclass, so every host-plane recovery path that catches typed
    process failure recovers device faults too).  Carries the probe's
    structured outcome (``kind`` in "hung"/"deadline"/"error") so a
    postmortem can tell an outer kill from an internal watchdog expiry."""

    errclass = ERR_DEVICE_FAULT

    def __init__(self, message: str = "", failed_ranks=(),
                 kind: str = "deadline"):
        super().__init__(message, failed_ranks)
        self.kind = str(kind)


class PlacementViolation(InternalError):
    """A multi-tenant placement audit failed: two live jobs on one DVM
    tree were caught sharing state that the tenancy contract requires
    disjoint — sm-segment session prefixes, PMIx namespaces, or (for
    exclusive placements) daemon subtrees.  Typed so the daemon can
    count it (``dvm_placement_audit_failures``) and fail the offending
    launch loudly rather than let two tenants corrupt each other.
    Carries the two job ids and which property collided."""

    def __init__(self, message: str = "", jobs=(),
                 prop: str = "unknown"):
        super().__init__(message)
        self.jobs = tuple(str(j) for j in jobs)
        self.prop = str(prop)


class Revoked(MpiError):
    """MPIX_ERR_REVOKED: the communicator (cid) was revoked — every
    pending and future operation on it must raise on all live ranks."""

    errclass = ERR_REVOKED

    def __init__(self, message: str = "", cid: int = -1):
        super().__init__(message)
        self.cid = cid
