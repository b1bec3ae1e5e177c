"""``ops/fused_norm``'s kernels (``ln_fwd_*`` and ``ln_bwd_*`` of
``csrc/fused_norm.cu``, the register and the generic paths alike): percent
of the least time of their calls, by bytes (``gpubench.flops.ln_fwd`` and
``ln_bwd``), over their device time together."""

from gpubench import flops

UNIT = "%"


def read(run):
    tr = run.window.trace
    if tr is None or run.peaks is None:
        return None
    fwd, bwd = tr.kernel("ln_fwd_reg", "ln_fwd_generic"), tr.kernel("ln_bwd_reg", "ln_bwd_generic")
    if fwd is None or bwd is None:
        return None
    m = run.cell.model
    rows = run.cell.batch * m["seq"]
    least = (fwd[1] * flops.ln_fwd(rows, m["d_model"]).least_seconds(*run.peaks)
             + bwd[1] * flops.ln_bwd(rows, m["d_model"]).least_seconds(*run.peaks))
    return 100.0 * least / (fwd[0] + bwd[0])
