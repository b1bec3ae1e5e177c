"""Ms per window step in the step's ``backward`` phase
(``torch.autograd.grad`` of ``loss_fn``: the kernels' backwards and the
gradient sums of the stacked leaves), on the card the CUDA stream's span
between the phase's events, from the step's ``timings=`` dict."""

UNIT = "ms"


def read(run):
    t = run.window.timings
    if not t or "backward" not in t:
        return None
    return 1e3 * t["backward"] / run.steps
