"""Percent of the profiled steps' span in which no operation ran on the
device: 1 - (union of the device's kernel and copy intervals / the span)."""

UNIT = "%"


def read(run):
    tr = run.window.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
