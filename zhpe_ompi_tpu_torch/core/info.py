"""MPI_Info objects (reference: ``ompi/info/info.h:41``).

The reference's ``ompi_info_t`` is an opaque ordered key/value store with
bounded key/value lengths, dup semantics, and reserved-key conventions
("no_locks", "same_size", ...).  Objects that accept hints — communicators,
windows, files, spawn — take an :class:`Info` and consult
:meth:`Info.get_bool` for the keys they honor; unrecognized keys are
preserved (MPI's required behavior) so hints survive dup/propagation.
"""

from __future__ import annotations

from . import errors

MAX_KEY = 255    # MPI_MAX_INFO_KEY
MAX_VAL = 1024   # MPI_MAX_INFO_VAL


class Info:
    """MPI_Info: ordered string->string hints."""

    # The singleton "no info" object (MPI_INFO_NULL analog) is module-level
    # NULL below; MPI_INFO_ENV is create_env().

    def __init__(self, items: dict[str, str] | None = None):
        self._kv: dict[str, str] = {}
        if items:
            for k, v in items.items():
                self.set(k, v)

    # -- the MPI surface --------------------------------------------------

    def set(self, key: str, value) -> None:
        """MPI_Info_set (values stringified, as MPI's are strings)."""
        if not key or len(key) > MAX_KEY:
            raise errors.ArgError(f"info key length invalid: {key!r}")
        value = str(value)
        if len(value) > MAX_VAL:
            raise errors.ArgError("info value too long")
        self._kv[key] = value

    def get(self, key: str, default: str | None = None) -> str | None:
        """MPI_Info_get: the value, or `default` when unset."""
        return self._kv.get(key, default)

    def get_bool(self, key: str, default: bool = False) -> bool:
        """Hint lookup in MPI's boolean convention ("true"/"false")."""
        v = self._kv.get(key)
        if v is None:
            return default
        return v.strip().lower() in ("true", "1", "yes")

    def delete(self, key: str) -> None:
        """MPI_Info_delete: deleting an unset key is an error (MPI rule)."""
        if key not in self._kv:
            raise errors.KeyvalError(f"info key {key!r} not set")
        del self._kv[key]

    def nkeys(self) -> int:
        """MPI_Info_get_nkeys."""
        return len(self._kv)

    def nthkey(self, n: int) -> str:
        """MPI_Info_get_nthkey (insertion order, as the reference's)."""
        keys = list(self._kv)
        if not 0 <= n < len(keys):
            raise errors.ArgError(f"info has {len(keys)} keys, asked {n}")
        return keys[n]

    def dup(self) -> "Info":
        """MPI_Info_dup."""
        return Info(dict(self._kv))

    def items(self):
        return self._kv.items()

    def __contains__(self, key: str) -> bool:
        return key in self._kv

    def __repr__(self) -> str:
        return f"Info({self._kv!r})"


#: MPI_INFO_NULL: shared empty, read-only by convention
NULL = Info()


def coerce(info) -> Info:
    """Accept Info, dict, or None at API boundaries."""
    if info is None:
        return NULL
    if isinstance(info, Info):
        return info
    if isinstance(info, dict):
        return Info({k: str(v) for k, v in info.items()})
    raise errors.ArgError(f"expected Info/dict/None, got {type(info)}")


def create_env() -> Info:
    """MPI_INFO_ENV analog: execution-environment facts."""
    import os
    import sys

    info = Info()
    info.set("command", sys.argv[0] if sys.argv else "")
    info.set("maxprocs", os.environ.get("ZMPI_MAXPROCS", "1"))
    info.set("arch", sys.platform)
    return info
