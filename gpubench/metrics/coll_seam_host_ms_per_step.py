"""Host ms per window step inside the framework's collectives, timed by
the program at the dispatch point (``Communicator._coll_call_inner``) from
the step's ``timings=`` dict."""

UNIT = "ms"


def read(run):
    t = run.window.timings
    if not t or "coll_host_s" not in t:
        return None
    return 1e3 * t["coll_host_s"] / run.steps
