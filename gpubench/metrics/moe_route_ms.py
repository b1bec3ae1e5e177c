"""Ms per window step in the MoE layers' routing, permutation and combine
(``models/lfm2_moe.moe_ffn``, the forward's), on the card the CUDA
stream's span between events around them, from the step's ``timings=``
dict (``moe_route_s``)."""

UNIT = "ms"


def read(run):
    t = run.window.timings
    if not t or "moe_route_s" not in t:
        return None
    return 1e3 * t["moe_route_s"] / run.steps
