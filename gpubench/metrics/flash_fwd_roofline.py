"""``ops/flash_attention``'s forward kernel (``flash_fwd_kernel`` of
``csrc/flash_attention.cu``): percent of its least time, by the causal
forward's work (``gpubench.flops.flash_fwd``), over its device time in the
trace, at the cell's shape."""

from gpubench import flops

UNIT = "%"


def read(run):
    m = run.cell.model
    heads = m["n_heads"]
    work = flops.flash_fwd(run.cell.batch, m["seq"], heads, m["d_model"] // heads)
    return run.kernel_roofline(("flash_fwd_kernel",), work)
