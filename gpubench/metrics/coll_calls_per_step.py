"""Calls per window step into the collectives layer (``Communicator`` ->
``coll/tuned`` -> ``coll/nccl``), counted by the benchmark's wrapper of the
communicators it hands the step."""

UNIT = "calls"


def read(run):
    t = run.window.tally
    if t is None:
        return None
    return t["calls"] / run.steps
