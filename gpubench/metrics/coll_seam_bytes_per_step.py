"""Payload GB per window step handed to the framework's collectives,
counted at the dispatch point (``Communicator._coll_call_inner``) from the
step's ``timings=`` dict."""

UNIT = "GB"


def read(run):
    t = run.window.timings
    if not t or "coll_bytes" not in t:
        return None
    return t["coll_bytes"] / 1e9 / run.steps
