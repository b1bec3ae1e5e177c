"""Ms per window step in the step's ``loss`` phase (the forward of
``ops/fused_ce.token_ce``), on the card the CUDA stream's span between the
phase's events, from the step's ``timings=`` dict."""

UNIT = "ms"


def read(run):
    t = run.window.timings
    if not t or "loss" not in t:
        return None
    return 1e3 * t["loss"] / run.steps
