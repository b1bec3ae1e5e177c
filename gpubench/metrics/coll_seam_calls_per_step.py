"""Calls per window step into the framework's collectives, counted by the
program at its one dispatch point (``Communicator._coll_call_inner``,
through the ``coll/monitoring`` window the step arms given ``timings=``)."""

UNIT = "calls"


def read(run):
    t = run.window.timings
    if not t or "coll_calls" not in t:
        return None
    return t["coll_calls"] / run.steps
