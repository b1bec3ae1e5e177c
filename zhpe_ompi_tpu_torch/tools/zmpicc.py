"""``zmpicc`` — the mpicc wrapper-compiler analog
(namesake: ``zhpe_ompi_tpu/tools/zmpicc.py``).

The reference's ``mpicc``/``mpifort`` (``ompi/tools/wrappers``) are thin
drivers that inject the MPI include/lib flags around the underlying
compiler.  This is that surface for the port's C ABI shim
(``native/zompi_mpi.cpp``): it builds ``libzompi_mpi_<hash>.so`` into
``csrc/_build/`` if it is missing, then runs the real compiler (``$ZMPI_CC``,
default ``gcc``) with ``-I<header dir> -L<lib dir> -lzompi_mpi_<hash>
-Wl,-rpath,<lib dir>`` appended.  A C rank built so joins a job of port
ranks: the shim speaks the host plane's wire.

    python -m zhpe_ompi_tpu_torch.tools.zmpicc ring.c -o ring
    python -m zhpe_ompi_tpu_torch.tools.zmpicc --showme     # print flags

``--showme`` (and ``--showme:compile`` / ``--showme:link``) mirror the
reference wrapper's introspection flags, so build systems can read the
flags without running the wrapper per file.
"""

from __future__ import annotations

import os
import subprocess
import sys


def compile_flags() -> list[str]:
    """Header flags only; never builds the shim (a per-file ``zmpicc -c``
    or a ``--showme:compile`` configure probe must be cheap)."""
    from .. import native

    return ["-I", native.mpi_header_dir()]


def link_flags() -> list[str]:
    """Library flags; builds ``libzompi_mpi_<hash>.so`` if it is
    missing."""
    from .. import native

    so = native.build_mpi_shim()
    libdir = os.path.dirname(so)
    libname = os.path.basename(so)[3:].rsplit(".so", 1)[0]
    return ["-L", libdir, f"-l{libname}", f"-Wl,-rpath,{libdir}",
            "-pthread"]


def main(args: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if args is None else args)
    cc = os.environ.get("ZMPI_CC", "gcc")
    if args and args[0].startswith("--showme"):
        which = args[0].partition(":")[2]
        if which == "compile":
            out = compile_flags()
        elif which == "link":
            out = link_flags()
        else:
            out = [cc] + compile_flags() + link_flags()
        print(" ".join(out))
        return 0
    if not args:
        print("zmpicc: no input files (try --showme)", file=sys.stderr)
        return 1
    cmd = [cc] + args + compile_flags()
    # link flags only when this invocation links (no -c/-S/-E)
    if not any(a in ("-c", "-S", "-E") for a in args):
        cmd += link_flags()
    return subprocess.call(cmd)


if __name__ == "__main__":
    sys.exit(main())
