"""The control: the reference computed in float8 and put in the program's
place must come out not correct, where the program comes out correct.  On
the CPU at a tiny width; on the card at each cell's own size."""

import json

import pytest

from gpubench import cells, check, readings

from .conftest import DATA


def _lines(capsys, argv):
    assert readings.main(argv) == 0
    return [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]


def test_control_and_faults_fail_where_the_program_passes(tiny, capsys):
    lines = _lines(capsys, ["--workload", "tiny.tiny-s16", "--root", str(DATA),
                            "--seeds", "21,22,2147483659", "--control", "3",
                            "--half", "3", "--unchanged", "3", "--device", "cpu"])
    limits = tiny.workload["limits"]
    by_kind = {}
    for line in lines:
        ok, _ = check.verdict(line["numbers"], limits)
        by_kind.setdefault(line["kind"], []).append(ok)
    assert by_kind == {"program": [True] * 3, "control": [False] * 3,
                       "half_batch": [False] * 3, "unchanged": [False] * 3}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gpt2-xl.train-s1024",
                                  "mpt-7b-storywriter.train-s32768"])
def test_control_fails_at_the_cells_size(card, capsys, name):
    cell = cells.load_cell(name)
    lines = _lines(capsys, ["--workload", name, "--seeds", "31,32,33",
                            "--control", "3", "--half", "3"])
    for line in lines:
        ok, _ = check.verdict(line["numbers"], cell.workload["limits"])
        assert ok == (line["kind"] == "program"), line
