"""The readings that the limits of ``correct`` are set from, for one cell
at its own size on the card: the program's numbers over many seeds, the
control's (the architecture's reference in float8, in the program's
place) and a planted fault's, all in one process, one JSON line per reading::

    python -m gpubench.readings --workload gpt2-xl.train-s1024 \
        --seeds 11,12,13 --control 3 --half 3 [--out FILE]

``--control N`` reads the control on the first N seeds, ``--half N`` the
fault "half of the batch left out, the mean taken over the rest" (the
program fed the first half of each batch's rows, or of its positions where
a batch holds one row: attention is causal, so the first half of a
sequence is a whole sequence of its own), and ``--unchanged N`` the fault
"a step that returns its state unchanged" (after each step the weights
are drawn again and Adam's state is dropped).  The benchmark's own
runs read none of these.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from . import cells, check, harness, inputs


def _emit(line: dict, out) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    if out is not None:
        out.write(text + "\n")
        out.flush()


def _program(cell, seed, dev, part=None, plant=None) -> dict:
    """The program's readings of its first steps; ``part`` feeds the step
    part of each batch, ``plant`` wraps the step with a fault."""
    prog = harness.build(cell, seed, dev, trace=False)
    if plant is not None:
        prog.step = plant(prog.step, cell, seed, dev)
    try:
        return harness.first_steps(prog, cell, seed, dev, part)
    finally:
        del prog
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def unchanged(step, cell, seed, dev):
    """The fault "a step that returns its state unchanged": each step runs,
    then its parameters are drawn again and Adam's state is dropped."""

    leaves = cell.leaves(seed, dev)

    def frozen(params, opt_state, tokens, targets):
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        with torch.no_grad():
            for n in leaves.names:
                params[n].copy_(leaves.draw(n))
        opt_state.state.clear()
        return params, opt_state, loss

    return frozen


def half_of(cell):
    """The fault's feed: the first half of the rows, or of the positions
    where a batch is one row."""
    if cell.batch >= 2:
        return lambda t: t[: cell.batch // 2]
    return lambda t: t[:, : cell.model["seq"] // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gpubench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--half", type=int, default=0)
    ap.add_argument("--unchanged", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(cells.ROOT))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload, Path(args.root))
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("gpubench.readings: no CUDA device", file=sys.stderr)
        return 2
    from zhpe_ompi_tpu_torch.runtime import init as rt

    out = open(args.out, "a") if args.out else None
    rt.init(device=args.device)
    try:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            prog = _program(cell, seed, dev)
            t1 = time.perf_counter()
            batches = inputs.make_batches(cell.traffic, cell.model["vocab"], seed)
            leaves = cell.leaves(seed, dev)
            ref = cell.reference.readings(cell.model, leaves, batches, cell.checked_steps)
            t2 = time.perf_counter()
            base = {"cell": cell.name, "seed": seed}
            _emit(dict(base, kind="program", numbers=check.numbers(prog, ref),
                       program=prog, reference=ref, program_s=t1 - t0,
                       reference_s=t2 - t1), out)
            if i < args.control:
                ctl = cell.reference.readings(cell.model, leaves, batches,
                                              cell.checked_steps, precision="fp8")
                _emit(dict(base, kind="control", numbers=check.numbers(ctl, ref),
                           control=ctl, control_s=time.perf_counter() - t2), out)
            if i < args.half:
                half = _program(cell, seed, dev, half_of(cell))
                _emit(dict(base, kind="half_batch", numbers=check.numbers(half, ref),
                           program=half), out)
            if i < args.unchanged:
                same = _program(cell, seed, dev, plant=unchanged)
                _emit(dict(base, kind="unchanged", numbers=check.numbers(same, ref),
                           program=same), out)
    finally:
        rt.finalize()
        if out is not None:
            out.close()
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench.readings: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
