"""The port's ztune (``tools/ztune.py``, its harness copy
``benchmarks/osu_zmpi.py``) against the JAX package's: the same swept
cells distill to the same table text (the counter-gated regression gate
included), the same tables parse to the same sections and problems,
``check_table`` accepts the repository's ``benchmarks/ztune_cpu8.table``
(read only), and a mini sweep on the port's thread harness publishes a
table into a port store that a second job adopts.
"""

import os
import subprocess
import sys

import pytest

import test_ztune as ref
from test_torch_dvm_tree import _port_runtime_hygiene  # noqa: F401 - autouse
from zhpe_ompi_tpu.coll import tuned as jtuned  # noqa: F401 - alg validator
from zhpe_ompi_tpu.coll import ztable as jztable
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu.tools import ztune as jztune
from zhpe_ompi_tpu_torch.coll import tuned as ttuned
from zhpe_ompi_tpu_torch.coll import ztable as tztable
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.runtime import pmix as tpmix
from zhpe_ompi_tpu_torch.runtime import spc as tspc
from zhpe_ompi_tpu_torch.tools import ztune as tztune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "benchmarks", "ztune_cpu8.table")
cell = ref.TestDistill._cell

CELL_SETS = {
    "merge": [cell(1024), cell(4096), cell(16384, cand_wires={
        "ring": 90, "recursive_doubling": 70})],
    "planted": [cell(1024), cell(4096, winner="recursive_doubling")],
    "all-rejected": [cell(1024, cand_wires={"ring": 500,
                                            "recursive_doubling": 600})],
    "unswept": [cell(1024, winner="bruck"), cell(4096)],
}


@pytest.mark.parametrize("name", sorted(CELL_SETS))
def test_distill_and_format_give_the_namesakes_table(name):
    cells = CELL_SETS[name]
    out = {}
    for tool, spc in ((tztune, tspc), (jztune, jspc)):
        base = spc.read("tuned_regression_rejects")
        d = tool.distill(cells)
        geo = {k: tool.geometry_for(cells, k) for k in d}
        out[tool] = (tool.format_table(d, geo, note="n"), d,
                     spc.read("tuned_regression_rejects") - base)
    assert out[tztune] == out[jztune]
    if name == "planted":
        assert out[tztune][2] == 1
        assert ("allreduce", 0, 4096, "builtin") in \
            out[tztune][1][(4, 4, 1)]["rules"]


MALFORMED = """[topology 4 4 1]
allreduce 0 0 ring
bogus line
geometry sm_ring_bytes -4
geometry sm_ring_bytes many
allreduce x 0 ring
reduce 0 0 no_such_alg
[topology 4
allreduce 0 0 ring
[topology * * *]
geometry sm_leader_ring_bytes 262144
"""


@pytest.mark.parametrize("which", ["fixture", "malformed"])
def test_tables_parse_as_the_namesakes(which):
    text = open(FIXTURE, encoding="utf-8").read() if which == "fixture" \
        else MALFORMED
    tp, jp = [], []
    assert tztable.parse_table(text, "<t>", tp) == \
        jztable.parse_table(text, "<t>", jp)
    assert tp == jp
    assert bool(tp) == (which == "malformed")


def test_check_table_accepts_the_repository_fixture(tmp_path, capsys):
    before = open(FIXTURE, "rb").read()
    assert tztune.check_table(FIXTURE) == 0
    assert open(FIXTURE, "rb").read() == before
    bad = tmp_path / "bad.table"
    bad.write_text(MALFORMED)
    assert tztune.check_table(str(bad)) == 1
    assert "bogus" in capsys.readouterr().out
    assert tztune.check_table(str(tmp_path / "nope.table")) == 1
    res = subprocess.run(
        [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.ztune", "--check",
         FIXTURE], env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def clean_tables(monkeypatch):
    monkeypatch.delenv("ZMPI_PMIX", raising=False)
    tztable.invalidate_cache()
    yield
    tvar.unset("coll_tuned_topology")
    tztable.invalidate_cache()


def test_mini_sweep_publishes_a_table_a_second_job_adopts(clean_tables,
                                                          monkeypatch):
    swept0 = tspc.read("ztune_cells_swept")
    cells = tztune.sweep(topos=("flat",), ops=("allreduce",),
                         min_bytes=1024, max_bytes=1024, iters=1, trials=1)
    assert tspc.read("ztune_cells_swept") - swept0 == 4  # auto, flat, 2
    assert len(cells) == 1
    d = tztune.distill(cells)
    (op, _cmin, _bmin, winner), = d[(4, 4, 1)]["rules"]
    m = cells[0]["modes"]
    assert op == "allreduce" and winner == "ring"  # 6n < 8n wire
    assert m["rule:ring"]["wire"] < min(m["flat"]["wire"], m["auto"]["wire"])
    text = tztune.format_table(
        d, {(4, 4, 1): tztune.geometry_for(cells, (4, 4, 1))})
    srv = tpmix.PmixServer()
    try:
        tztune.publish(f"{srv.address[0]}:{srv.address[1]}", text)
        monkeypatch.setenv("ZMPI_PMIX",
                           f"{srv.address[0]}:{srv.address[1]}/jobns")
        tztable.invalidate_cache()
        fetches = tspc.read("tuned_table_store_fetches")
        tztable.prefetch()  # what host_init does under ZMPI_PMIX
        assert tspc.read("tuned_table_store_fetches") == fetches + 1
        tvar.set_var("coll_tuned_topology", "4:4:1")
        assert tztable.resolve_rule("allreduce", 4, 4096,
                                    tztable.job_topology_key()) == "ring"
        assert tztable.table_geometry("sm_ring_bytes", (4, 4, 1)) == 262144
        assert tspc.read("ztune_cells_swept") - swept0 == 4  # no re-sweep
    finally:
        srv.store.destroy_ns(tpmix.ZTUNE_NS)
        srv.close()
    assert ttuned._valid_rule_alg("allreduce", "ring")
    assert tztune.orphaned_sweep_processes() == []
