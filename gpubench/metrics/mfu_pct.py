"""The whole step's share of the card's published dense bf16 peak: model
FLOPs (the architecture's ``model_flops_per_step``; for GPT
``gpubench.flops.model_flops_per_step``: 6 per matmul parameter per token
plus causal attention, nothing for recomputation) of the window's steps
outside the profiled slice, over their host-clock seconds."""

UNIT = "%"


def read(run):
    if run.peaks is None:
        return None
    times = run.unprofiled_times
    if not times:
        return None
    return 100.0 * len(times) * run.cell.model_flops_per_step() / sum(times) / run.peaks[0]
