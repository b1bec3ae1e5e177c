"""The port's zlint (``zhpe_ompi_tpu_torch/tools/zlint``) against the JAX
package's: the reference's trip/clean fixture matrix
(``tests/test_zlint.py``) gives the same rule ids and stable keys in
both engines, suppressions and the baseline behave alike, and the port's
own package lints clean with an empty baseline and a reason on every
suppression.
"""

import os
import re

import pytest

import test_zlint as ref
from zhpe_ompi_tpu.tools.zlint import engine as jengine
from zhpe_ompi_tpu.tools.zlint import rules as jrules
from zhpe_ompi_tpu_torch.tools.zlint import __main__ as tcli
from zhpe_ompi_tpu_torch.tools.zlint import engine as tengine
from zhpe_ompi_tpu_torch.tools.zlint import rules as trules

PORT_PKG = os.path.dirname(os.path.dirname(os.path.abspath(
    __import__("zhpe_ompi_tpu_torch").__file__))) + "/zhpe_ompi_tpu_torch"

#: (rule, trip, clean, extra files) rows of the reference's matrix
MATRIX = next(m for m in ref.TestRuleMatrix.test_trip_and_clean.pytestmark
              if m.name == "parametrize").args[1]


def _lint_both(tmp_path, src, extra=None, baseline_text=None):
    """Lint the same files with both engines: [(rule, key)] each, plus
    the counts of suppressed, baselined and stale entries."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "snippet.py").write_text(src)
    for name, body in (extra or {}).items():
        (tmp_path / name).write_text(body)
    baseline = None
    if baseline_text is not None:
        baseline = str(tmp_path.parent / f"{tmp_path.name}.baseline")
        with open(baseline, "w") as fh:
            fh.write(baseline_text)
    out = []
    for eng in (tengine, jengine):
        res = eng.lint_paths([str(tmp_path)], baseline=baseline)
        out.append(([(f.rule, f.key()) for f in res.findings],
                    res.suppressed, res.baselined, res.stale_baseline))
    return out


@pytest.mark.parametrize("row", range(len(MATRIX)))
def test_fixture_matrix_gives_the_namesakes_findings(tmp_path, row):
    rule, trip, clean, extra = MATRIX[row]
    port, jax = _lint_both(tmp_path / "trip", trip, extra)
    assert port == jax
    assert rule in {r for r, _ in port[0]}
    port, jax = _lint_both(tmp_path / "clean", clean, extra)
    assert port == jax
    assert rule not in {r for r, _ in port[0]}


SUPPRESSED = """
import time

def spin(flag):
    while not flag.is_set():
        time.sleep(0)  # zlint: disable=ZL003 -- bounded by the caller
"""

REASONLESS = SUPPRESSED.replace(" -- bounded by the caller", "")

ABOVE = """
import time

def spin(flag):
    while not flag.is_set():
        # zlint: disable=ZL003 -- bounded by the caller
        time.sleep(0)
"""


@pytest.mark.parametrize("src,baseline", [
    (SUPPRESSED, None), (REASONLESS, None), (ABOVE, None),
    (ref.TRIP_ZL003, "snippet.py|ZL003|spin|sleep:0 -- grandfathered\n"),
    (ref.TRIP_ZL003, "snippet.py|ZL003|spin|sleep:0\n"),
    (ref.CLEAN_ZL003, "snippet.py|ZL003|gone|sleep:0 -- stale\n"),
], ids=["inline", "reasonless", "line-above", "baselined", "unjustified",
        "stale"])
def test_suppressions_and_baseline_match_the_namesake(tmp_path, src, baseline):
    port, jax = _lint_both(tmp_path / "s", src, baseline_text=baseline)
    assert port == jax


def test_rule_table_and_decision_functions_keep_their_names():
    assert [r[0] for r in trules.rule_table()] == \
        [r[0] for r in jrules.rule_table()]
    assert trules.LoudDegradation.DECISION_FUNCS == \
        jrules.LoudDegradation.DECISION_FUNCS
    assert all("PR " not in g for _, _, g in trules.rule_table())


def test_port_package_lints_clean_with_an_empty_baseline(monkeypatch):
    seen = {}
    monkeypatch.setattr(tcli, "run", lambda paths, baseline: seen.update(
        paths=paths, baseline=baseline) or 0)
    assert tcli.main([]) == 0  # the CLI's default scan is the port
    assert [os.path.realpath(p) for p in seen["paths"]] == \
        [os.path.realpath(PORT_PKG)]
    assert seen["baseline"] == tengine.default_baseline_path()
    res = tengine.lint_paths([PORT_PKG], baseline=seen["baseline"])
    assert res.files > 100, "scan set suspiciously small"
    assert not res.findings, "\n".join(f.render() for f in res.findings)
    assert not res.stale_baseline
    assert res.baselined == 0
    assert tengine.load_baseline(tengine.default_baseline_path()) == {}
    assert res.suppressed >= 1  # the sanctioned sites exist


def test_every_suppression_in_the_port_has_a_reason():
    pattern = re.compile(r"#\s*zlint:\s*disable=")
    found = 0
    for root, _dirs, names in os.walk(PORT_PKG):
        for name in names:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name), encoding="utf-8") as fh:
                for line in fh:
                    if pattern.search(line) and "zlint/" not in root:
                        found += 1
                        assert re.search(r"--\s*\S", line), line
    assert found >= 10


def test_the_anchors_hit_the_ports_modules():
    """The cross-file rules find their anchor modules in the port's scan
    (runtime/spc.py, mca/var.py, runtime/flightrec.py, runtime/ztrace.py)
    and the decision functions exist there."""
    mods = [tengine.Module(p, open(p, encoding="utf-8").read())
            for p in tengine._walk_py([PORT_PKG])]
    keys = {m.path_key for m in mods}
    for anchor in ("runtime/spc.py", "mca/var.py", "runtime/flightrec.py",
                   "runtime/ztrace.py", "coll/tuned.py", "coll/han.py",
                   "coll/ztable.py", "models/inferloop.py"):
        assert f"zhpe_ompi_tpu_torch/{anchor}" in keys, anchor
    defined = {n.name for m in mods for n in __import__("ast").walk(m.tree)
               if n.__class__.__name__ == "FunctionDef"}
    # the port's coll/tuned inlines the namesake's _load_rules and
    # _dynamic_rule into decide; every other decision function is there
    assert set(trules.LoudDegradation.DECISION_FUNCS) - defined == {
        "_load_rules", "_dynamic_rule"}


def test_cli_lists_the_rules(capsys):
    assert tcli.main(["--list-rules"]) == 0
    assert "ZL010" in capsys.readouterr().out
