"""The comparison that decides ``correct``: the program's readings of its
first steps against the reference's, as three numbers, each held to a
limit of the cell's.

- ``loss_gap``: the largest gap, in nats, between the program's loss and
  the reference's over the steps compared.
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient (as Adam got it: its first moment after one
  step over 1 - beta1) and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf.
- ``change_gap``: the same for the norm of each leaf's change over the
  steps compared, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (Adam moves those by round-off alone).
"""

from __future__ import annotations

import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
#: a leaf whose first reference gradient is under this share of the median
#: leaf's is left out of change_gap
QUIET_LEAF = 1e-3


def _rel_gap(prog: dict, ref: dict, leaves) -> float:
    floor = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor) for n in leaves)


def numbers(prog: dict, ref: dict) -> dict:
    """The three numbers of program readings ``prog`` against reference
    readings ``ref`` (each as ``reference.common.readings`` returns)."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides followed different numbers of steps")
    leaves = list(ref["grad_norms"])
    gmed = statistics.median(ref["grad_norms"].values())
    moving = [n for n in leaves if ref["grad_norms"][n] >= QUIET_LEAF * gmed]
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": _rel_gap(prog["grad_norms"], ref["grad_norms"], leaves),
        "change_gap": _rel_gap(prog["change_norms"], ref["change_norms"], moving),
    }


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {n: {"value": nums[n], "limit": float(limits[n])} for n in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
