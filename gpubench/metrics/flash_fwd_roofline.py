"""``ops/flash_attention``'s forward kernel (``flash_fwd_kernel`` of
``csrc/flash_attention.cu``): percent of its least time, by the causal
forward's work (``gpubench.flops.flash_fwd``) at the architecture's
attention shape, over its device time in the trace."""

from gpubench import flops

UNIT = "%"


def work(run) -> flops.Work:
    return flops.flash_fwd(**run.cell.attention_shape())


def read(run):
    return run.kernel_roofline(("flash_fwd_kernel",), work(run))
