"""The held experts' grouped products (``torch._grouped_mm`` in
``models/lfm2_moe``: CUTLASS's grouped GEMM, ``GroupProblemShape`` in its
name, and the small kernel that lays out its problems): percent of their
least time, at the architecture's ``moe_gemm_work`` (18 rows D Fe FLOPs a
step: forward, input and weight gradient of W1, W3 and W2) with rows the
window's mean ``moe_rows`` a step, over their device time in the profiled
steps."""

UNIT = "%"
NEEDLES = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(run):
    work = getattr(run.cell.arch, "moe_gemm_work", None)
    t, tr = run.window.timings, run.window.trace
    if work is None or not t or not t.get("moe_rows") or tr is None or run.peaks is None:
        return None
    found = tr.kernel(*NEEDLES)
    if found is None or not run.window.profiled:
        return None
    step = work(run.cell.model, t["moe_rows"] / run.steps)
    return 100.0 * len(run.window.profiled) * step.least_seconds(*run.peaks) / found[0]
