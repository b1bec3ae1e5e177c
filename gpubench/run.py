"""Run one cell of the benchmark and print its result as the last line of
standard output::

    python -m gpubench.run --workload gpt2-xl.train-s1024 --seed 7 \
        --seconds 51 --trace 0

from the root of a checkout, on a machine with an NVIDIA GPU.  ``--trace
0`` prints the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics from a run that profiles a slice of the window.  Without a card,
or with fewer cards than the cell asks for, it prints no result and exits
with 2; if JAX or the JAX package is loaded once the window has closed, it
exits with 3.  The numbers compared with the reference are the last lines
of standard error, and the last key of the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import cells  # noqa: E402

#: build and kernel caches, at fixed paths inside the checkout
CACHE = cells.ROOT / "_out" / "cache"


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip() or f"unread (rc {out.returncode})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from . import harness

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                         T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: JAX or the JAX package is loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    m = result["metrics"]
    print(f"card: {_power_limit()}", file=sys.stderr)
    print(f"window: {result['attempted']} steps, {result['failed']} failed",
          file=sys.stderr)
    if "mfu_pct" in m:
        print(f"mfu_pct {m['mfu_pct']['value']} of the card's published bf16 "
              f"peak, at the power limit above", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
