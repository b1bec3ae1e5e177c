"""``ops/fused_norm``'s kernels (``ln_fwd_*`` and ``ln_bwd_*`` of
``csrc/fused_norm.cu``, the register and the generic paths alike): percent
of the least time of their calls, by bytes (``gpubench.flops.ln_fwd`` and
``ln_bwd`` at the architecture's norm shape), over their device time
together."""

from gpubench import flops

UNIT = "%"


def work(run) -> tuple[flops.Work, flops.Work]:
    """The forward's and the backward's work of one call."""
    shape = run.cell.norm_shape()
    return flops.ln_fwd(**shape), flops.ln_bwd(**shape)


def read(run):
    tr = run.window.trace
    if tr is None or run.peaks is None:
        return None
    fwd, bwd = tr.kernel("ln_fwd_reg", "ln_fwd_generic"), tr.kernel("ln_bwd_reg", "ln_bwd_generic")
    if fwd is None or bwd is None:
        return None
    w_fwd, w_bwd = work(run)
    least = (fwd[1] * w_fwd.least_seconds(*run.peaks)
             + bwd[1] * w_bwd.least_seconds(*run.peaks))
    return 100.0 * least / (fwd[0] + bwd[0])
