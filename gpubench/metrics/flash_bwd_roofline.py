"""``ops/flash_attention``'s backward (``flash_bwd_dq_kernel`` and
``flash_bwd_dkv_kernel`` of ``csrc/flash_attention_bwd.cu``, taken
together): percent of the least time of one causal backward
(``gpubench.flops.flash_bwd``, S recomputed once, at the architecture's
attention shape) per dq launch, over the two kernels' device time."""

from gpubench import flops

UNIT = "%"


def work(run) -> flops.Work:
    return flops.flash_bwd(**run.cell.attention_shape())


def read(run):
    tr = run.window.trace
    dq = tr.kernel("flash_bwd_dq_kernel") if tr is not None else None
    if dq is None or run.peaks is None:
        return None
    secs, _ = tr.kernel("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    return 100.0 * dq[1] * work(run).least_seconds(*run.peaks) / secs
