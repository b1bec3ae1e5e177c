"""``zmpi-checkpoint`` — the opal-checkpoint / opal-restart CLI analog
(namesake: ``zhpe_ompi_tpu/tools/checkpoint.py``).

The reference ships command-line checkpoint tooling
(``opal/tools/opal-checkpoint``, ``opal-restart``) on top of its crs
framework.  This CLI is that surface over the framework's async
checkpointer (``runtime/checkpoint.py``):

    python -m zhpe_ompi_tpu_torch.tools.checkpoint list <dir>
    python -m zhpe_ompi_tpu_torch.tools.checkpoint inspect <dir> [--step N]
    python -m zhpe_ompi_tpu_torch.tools.checkpoint prune <dir> --keep K

``list`` prints available steps; ``inspect`` loads one snapshot into host
memory and prints its tree structure (leaf shapes/dtypes) — on the CPU by
design, because it prints structure and computes nothing, so it needs no
card; ``prune`` applies the retention policy offline (the
opal-checkpoint -s housekeeping role).  The layout is the port's
``runtime/checkpoint.Checkpointer`` directory (``tree.json``, not the
namesake's pickled treedef).
Restore-into-a-program stays programmatic (``Checkpointer.restore``) —
process-image restart does not transfer to this platform; the snapshot
IS the restartable state.
"""

from __future__ import annotations

import argparse
import os
import sys


def _list(directory: str) -> int:
    from ..runtime.checkpoint import Checkpointer

    ck = Checkpointer(directory)
    steps = ck.all_steps()
    if not steps:
        print(f"no checkpoints in {directory}")
        return 1
    for s in steps:
        d = os.path.join(directory, f"step_{s}")
        size = 0
        if os.path.isdir(d):
            size = sum(
                os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
            )
        print(f"step {s:8d}  {size / 1e6:8.2f} MB")
    print(f"latest: {ck.latest_step()}")
    return 0


def _inspect(directory: str, step: int | None) -> int:
    """Print one snapshot's tree structure.  It reads on the CPU by
    design: it prints structure and computes nothing, so it needs no
    card."""
    from ..runtime.checkpoint import Checkpointer
    from ..utils.payload import tree_flatten

    ck = Checkpointer(directory)
    # placements None: every array leaf lands in host memory
    state, step = ck.restore(step)
    print(f"step {step}:")
    # the namesake's leaf order (a dict's leaves by its sorted keys)
    leaves, treedef = tree_flatten(state)
    print(f"  tree: {treedef}")
    total = 0
    for i, leaf in enumerate(leaves):
        shape = getattr(leaf, "shape", ())
        dtype = getattr(leaf, "dtype", type(leaf).__name__)
        nbytes = getattr(leaf, "nbytes", 0)
        total += nbytes
        print(f"  leaf[{i}]: shape={tuple(shape)} dtype={dtype}")
    print(f"  total: {total / 1e6:.2f} MB in {len(leaves)} leaves")
    return 0


def _prune(directory: str, keep: int) -> int:
    import shutil

    from ..runtime.checkpoint import Checkpointer

    ck = Checkpointer(directory)
    steps = ck.all_steps()
    # --keep 0 means keep none: drop every step (steps[:-0] would be []).
    drop = steps[:-keep] if keep > 0 else list(steps)
    for s in drop:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)
        print(f"pruned step {s}")
    print(f"kept {min(len(steps), keep)} of {len(steps)}")
    return 0


def main(args: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="zmpi-checkpoint",
        description="Checkpoint housekeeping CLI (opal-checkpoint analog)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_list = sub.add_parser("list")
    p_list.add_argument("dir")
    p_ins = sub.add_parser("inspect")
    p_ins.add_argument("dir")
    p_ins.add_argument("--step", type=int, default=None)
    p_pr = sub.add_parser("prune")
    p_pr.add_argument("dir")
    p_pr.add_argument("--keep", type=int, required=True,
                      help="checkpoints to retain (0 prunes everything)")
    ns = ap.parse_args(args)
    if ns.cmd == "prune" and ns.keep < 0:
        ap.error(f"--keep must be >= 0, got {ns.keep}")
    if ns.cmd == "list":
        return _list(ns.dir)
    if ns.cmd == "inspect":
        return _inspect(ns.dir, ns.step)
    return _prune(ns.dir, ns.keep)


if __name__ == "__main__":
    sys.exit(main())
