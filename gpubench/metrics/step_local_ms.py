"""Host ms per window step in ``make_train_step_optax``'s ``local`` phase
(loss, autograd, ``_sync_grads``), from its ``timings=`` dict, which
synchronises the device at each phase boundary."""

UNIT = "ms"


def read(run):
    t = run.window.timings
    if not t or "local" not in t:
        return None
    return 1e3 * t["local"] / run.steps
