"""fs framework — filesystem operation components (namesake:
``zhpe_ompi_tpu/io/fs.py``).

Analog of OMPIO's ``fs`` sub-framework (``ompi/mca/fs/{ufs,lustre,...}``):
a component supplies open/pread/pwrite/resize/sync/delete primitives; the
File layer above is filesystem-agnostic.  One component ships (posix, the
``fs/ufs`` analog); parallel filesystems would register siblings selected
by priority or ``ZMPI_MCA_fs=...``.
"""

from __future__ import annotations

import os

from ..core import errors
from ..mca import component as mca_component


class FsComponent(mca_component.Component):
    framework_name = "fs"

    def open(self, path: str, flags: int) -> int:
        raise NotImplementedError

    def close(self, fd: int) -> None:
        raise NotImplementedError

    def pread(self, fd: int, nbytes: int, offset: int) -> bytes:
        raise NotImplementedError

    def pwrite(self, fd: int, data, offset: int) -> int:
        raise NotImplementedError

    def size(self, fd: int) -> int:
        raise NotImplementedError

    def resize(self, fd: int, size: int) -> None:
        raise NotImplementedError

    def sync(self, fd: int) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError


class PosixFs(FsComponent):
    """fs/ufs analog over POSIX fds (pread/pwrite are atomic at-offset ops,
    the property the fbtl/posix component relies on)."""

    name = "posix"
    default_priority = 10

    def open(self, path: str, flags: int) -> int:
        try:
            return os.open(path, flags, 0o644)
        except FileExistsError:
            raise errors.ArgError(f"file exists: {path}")
        except FileNotFoundError:
            raise errors.ArgError(f"no such file: {path}")
        except PermissionError:
            raise errors.ArgError(f"permission denied: {path}")

    def close(self, fd: int) -> None:
        os.close(fd)

    def pread(self, fd: int, nbytes: int, offset: int) -> bytes:
        return os.pread(fd, nbytes, offset)

    def pwrite(self, fd: int, data, offset: int) -> int:
        return os.pwrite(fd, data, offset)

    def size(self, fd: int) -> int:
        return os.fstat(fd).st_size

    def resize(self, fd: int, size: int) -> None:
        os.ftruncate(fd, size)

    def sync(self, fd: int) -> None:
        os.fsync(fd)

    def delete(self, path: str) -> None:
        try:
            os.unlink(path)
        except FileNotFoundError:
            raise errors.ArgError(f"no such file: {path}")


def fs_framework() -> mca_component.Framework:
    return mca_component.build_framework(
        "fs", "filesystem operations", (PosixFs,)
    )


def select_fs() -> FsComponent:
    return fs_framework().select_one()
