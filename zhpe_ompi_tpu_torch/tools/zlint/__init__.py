"""zlint — the codebase's own AST concurrency-and-protocol analyzer
(namesake: ``zhpe_ompi_tpu/tools/zlint/__init__.py``).

The reference leans on toolchain-level introspection (the MCA var
registry with registered defaults, SPC counters that are
documentation-bearing by contract, ``opal/mca/memchecker``'s
out-of-tree sanitizer wiring); this package applies the same
discipline to the invariants THIS codebase's hardest bugs violated:
lock-order inversions at the ``ch.lock``/``_rndv_lock`` seam,
fire-and-forget isends whose typed error was never observed,
hot-polling waits that poison 1-CPU hosts, MCA fallback literals
drifting from registered defaults, and decision paths that raise
instead of degrading loudly.

Run it::

    python -m zhpe_ompi_tpu_torch.tools.zlint [paths...]

Each rule documents the real historical bug it guards against (see
``rules.py``).  Inline suppressions require a reason::

    something_sanctioned()  # zlint: disable=ZL003 -- why it is sanctioned

Grandfathered findings live in the checked-in annotated baseline file
(``baseline.txt`` next to this module), one justified entry per line.
The runtime half of the discipline — the lock-order witness the AST
cannot prove — is ``zhpe_ompi_tpu_torch/utils/lockdep.py``.
"""

from .engine import Finding, lint_paths, run  # noqa: F401
from .rules import all_rules  # noqa: F401
