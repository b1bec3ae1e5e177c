"""Ms per window step in ``make_train_step_optax``'s ``forward`` phase
(``models/transformer.forward_hidden``: the embedding gather to the final
layernorm), on the card the CUDA stream's span between the phase's events,
from the step's ``timings=`` dict."""

UNIT = "ms"


def read(run):
    t = run.window.timings
    if not t or "forward" not in t:
        return None
    return 1e3 * t["forward"] / run.steps
