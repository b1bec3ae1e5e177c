"""Ms per window step in the step's ``sync`` phase
(``models/transformer._sync_grads``: the gradients' and the loss's
allreduces and their means), on the card the CUDA stream's span between
the phase's events, from the step's ``timings=`` dict."""

UNIT = "ms"


def read(run):
    t = run.window.timings
    if not t or "sync" not in t:
        return None
    return 1e3 * t["sync"] / run.steps
