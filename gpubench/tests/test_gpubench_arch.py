"""The architecture interface: the GPT path through it reads, bit for bit,
what the harness read before it (golden values recorded at the tiny cell
from the harness as it was), and a second architecture that comes in by
new files alone runs a step through the harness."""

import hashlib
import json
import time

from gpubench import cells, flops, harness, inputs

from .conftest import DATA


def test_gpt_path_reads_the_golden_values(tiny):
    gold = json.loads((DATA / "golden" / "gpt-tiny.json").read_text())
    seed = gold["seed"]
    leaves = tiny.leaves(seed, "cpu")
    assert list(leaves.names) == list(gold["leaves"])
    for name in leaves.names:
        t = leaves.draw(name)
        assert list(t.shape) == gold["leaves"][name]["shape"]
        assert hashlib.sha256(t.numpy().tobytes()).hexdigest() == gold["leaves"][name]["sha256"]
    batches = inputs.make_batches(tiny.traffic, tiny.model["vocab"], seed)
    for precision, key in (("f32", "reference"), ("fp8", "control")):
        assert tiny.reference.readings(tiny.model, leaves, batches, tiny.checked_steps,
                                       precision) == gold[key]
    assert tiny.model_flops_per_step() == gold["model_flops_per_step"]
    record = harness.RunRecord(tiny, harness.Window(), None)
    readers = cells.metric_readers()
    work = {"flash_fwd": readers["flash_fwd_roofline"].work(record),
            "flash_bwd": readers["flash_bwd_roofline"].work(record)}
    work["ln_fwd"], work["ln_bwd"] = readers["ln_roofline"].work(record)
    assert work == {k: flops.Work(*v) for k, v in gold["work"].items()}


def test_a_second_architecture_runs_a_step():
    cell = cells.load_cell("tiny-untied.tiny-s16", DATA)
    assert cell.leaves(3, "cpu").names[-1] == "head"
    r = harness.run(cell, 2**31 + 3, 0.01, False, "cpu", time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
