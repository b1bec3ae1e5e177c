"""zmpi-info — component/parameter/counter introspection CLI
(namesake: ``zhpe_ompi_tpu/tools/info.py``).

Re-design of ``ompi_info`` (``ompi/tools/ompi_info`` — SURVEY.md §2.6):
dumps the framework/component registry with priorities and availability, the
full MCA variable table with current values and their sources (the MPI_T
cvar surface), and every MPI_T performance variable with its value (the
pvar surface: ``tools/mpit.py``'s universe, the documented SPC counters and
the registered state pvars).  The coll framework lists ``nccl`` where the
namesake lists ``tpu``.

Usage::

    python -m zhpe_ompi_tpu_torch.tools.info            # everything
    python -m zhpe_ompi_tpu_torch.tools.info --components
    python -m zhpe_ompi_tpu_torch.tools.info --params [prefix]
    python -m zhpe_ompi_tpu_torch.tools.info --pvars
    python -m zhpe_ompi_tpu_torch.tools.info --json
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_everything():
    """Import all in-tree components so their frameworks/vars register
    (the analog of opening every MCA framework)."""
    from ..coll.framework import coll_framework

    coll_framework()
    from ..io.fbtl import fbtl_framework
    from ..io.fcoll import fcoll_framework
    from ..io.fs import fs_framework

    fs_framework()
    fbtl_framework()
    fcoll_framework()
    from ..shmem.spml import spml_framework

    spml_framework()
    from ..coll import host  # registers host_coll_* vars  # noqa: F401
    from ..pt2pt import tcp  # registers tcp_* vars  # noqa: F401
    from ..pt2pt import universe  # registers pt2pt vars  # noqa: F401
    from ..parallel import mesh  # registers rte vars  # noqa: F401
    from ..coll import monitoring  # registers monitoring vars  # noqa: F401
    from ..utils import memchecker  # registers memchecker vars  # noqa: F401
    from ..runtime import dvm  # registers dvm_* daemon vars  # noqa: F401
    from ..runtime import dvmtree  # registers tree/placement vars  # noqa: F401
    from .. import native

    native.load()  # registration happens inside load(), not at import


def gather(prefix: str | None = None) -> dict:
    _load_everything()
    from .. import __version__
    from ..mca import component as mca_component
    from ..mca import var as mca_var
    from ..coll import tuned
    from . import mpit

    data = {
        "version": __version__,
        "package": "zhpe_ompi_tpu_torch",
        "frameworks": mca_component.info(),
        "profiles": tuned.profiles(),
        "params": [
            {
                "name": v.name,
                "value": v.value,
                "source": v.source.name,
                "default": v.default,
                "type": v.type.__name__,
                "description": v.description,
            }
            for v in mca_var.registry.all_vars()
            if prefix is None or v.name.startswith(prefix)
        ],
        "pvars": {name: d.reader()
                  for name, d in sorted(mpit.pvar_defs().items())},
    }
    return data


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="zmpi-info", description=__doc__)
    p.add_argument("--components", action="store_true")
    p.add_argument("--params", nargs="?", const="", metavar="PREFIX")
    p.add_argument("--pvars", action="store_true")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    show_all = not (args.components or args.params is not None or args.pvars)
    data = gather(args.params or None)

    if args.json:
        print(json.dumps(data, indent=2, default=str))
        return 0

    print(f"zhpe_ompi_tpu_torch {data['version']}")
    if show_all or args.components:
        print("\n== Frameworks / components ==")
        for fw in data["frameworks"]:
            print(f"  {fw['framework']}: {fw['description']}")
            for c in fw["components"]:
                avail = "" if c["available"] else "  (unavailable)"
                print(
                    f"    {c['name']:<12} priority={c['priority']:<4} "
                    f"v{c['version']}{avail}"
                )
    if show_all or args.params is not None:
        print("\n== MCA parameters ==")
        for v in data["params"]:
            print(
                f"  {v['name']:<40} = {v['value']!r:<16} "
                f"[{v['source']}] {v['description']}"
            )
    if show_all or args.pvars:
        print("\n== Shipped decision profiles (coll_tuned_dynamic_rules) ==")
        for name, path in data["profiles"].items():
            print(f"  {name:<12} {path}")
        print("\n== Performance variables (MPI_T) ==")
        for k, val in sorted(data["pvars"].items()):
            print(f"  {k:<40} = {val}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
