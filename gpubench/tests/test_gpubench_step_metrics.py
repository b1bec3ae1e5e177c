"""The readers of the step's own phases and of the collectives counted at
the program's dispatch point, on a hand-built record, and in a traced run
on the CPU at a tiny width."""

import time

import pytest

from gpubench import harness
from gpubench.cells import Cell, metric_readers

#: reader -> (the timings key it reads, the value it gives of 3.0 over 6 steps)
READERS = {
    "step_fwd_ms": ("forward", 500.0),
    "step_loss_ms": ("loss", 500.0),
    "step_bwd_ms": ("backward", 500.0),
    "step_sync_ms": ("sync", 500.0),
    "coll_seam_calls_per_step": ("coll_calls", 0.5),
    "coll_seam_bytes_per_step": ("coll_bytes", 0.5e-9),
    "coll_seam_host_ms_per_step": ("coll_host_s", 500.0),
}
UNITS = {"step_fwd_ms": "ms", "step_loss_ms": "ms", "step_bwd_ms": "ms",
         "step_sync_ms": "ms", "coll_seam_calls_per_step": "calls",
         "coll_seam_bytes_per_step": "GB", "coll_seam_host_ms_per_step": "ms"}


def _record(timings):
    cell = Cell("c", {}, {"as_run": {}}, {"seq": 8, "batch": 1, "remat": False})
    w = harness.Window(times=[0.1] * 6, timings=timings)
    return harness.RunRecord(cell, w, None)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_value_and_none_without_its_key(name):
    mod = metric_readers()[name]
    key, want = READERS[name]
    assert mod.UNIT == UNITS[name]
    assert mod.read(_record({key: 3.0})) == pytest.approx(want)
    # the parent's step, which keeps only "local" and "optimizer"
    assert mod.read(_record({"local": 3.0, "optimizer": 1.0})) is None
    assert mod.read(_record(None)) is None


def test_traced_run_reports_the_seam_beside_the_wrapper(tiny):
    r = harness.run(tiny, 2**31 + 9, 0.3, True, "cpu", time.perf_counter())
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"] is True
    assert m["coll_seam_calls_per_step"] == m["coll_calls_per_step"] == 4 * 2 + 14
    # the tiny cell's bytes a step: the f32 gradients of 19,616 parameters
    # over dp and the 3,232 replicated over tp, two f32 losses, and four
    # bf16 (4, 16, 32) activations a layer
    assert m["coll_seam_bytes_per_step"] == pytest.approx(
        (4 * (19616 + 3232) + 2 * 4 + 8 * 4 * 16 * 32 * 2) / 1e9)
    assert 0 < m["coll_seam_host_ms_per_step"] <= m["coll_host_ms_per_step"]
    parts = m["step_fwd_ms"] + m["step_loss_ms"] + m["step_bwd_ms"] + m["step_sync_ms"]
    assert parts == pytest.approx(m["step_local_ms"], rel=1e-9)
