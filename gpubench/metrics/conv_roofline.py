"""The short convolution's depthwise kernels (``F.conv1d`` with one group
a channel in ``models/lfm2_moe``: ``conv_depthwise2d_*``, forward, input
gradient and weight gradient): percent of their least time, by bytes, at
the architecture's ``conv_work`` ((B S, D) in every conv layer), over their
device time in the profiled steps."""

UNIT = "%"
NEEDLES = ("conv_depthwise2d",)


def read(run):
    work = getattr(run.cell.arch, "conv_work", None)
    tr = run.window.trace
    if work is None or tr is None or run.peaks is None or not run.window.profiled:
        return None
    found = tr.kernel(*NEEDLES)
    if found is None:
        return None
    step = work(run.cell.model, run.cell.batch)
    return 100.0 * len(run.window.profiled) * step.least_seconds(*run.peaks) / found[0]
