"""Host ms per window step in the ``optimizer`` phase (``torch.optim.Adam``
inside the step), from the step's ``timings=`` dict."""

UNIT = "ms"


def read(run):
    t = run.window.timings
    if not t or "optimizer" not in t:
        return None
    return 1e3 * t["optimizer"] / run.steps
