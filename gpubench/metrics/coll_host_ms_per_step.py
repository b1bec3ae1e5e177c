"""Host ms per window step spent inside the calls into the collectives
layer, timed by the benchmark's wrapper of the communicators."""

UNIT = "ms"


def read(run):
    t = run.window.tally
    if t is None or not t["calls"]:
        return None
    return 1e3 * t["host_s"] / run.steps
