"""Cells, configurations, traffic mixes and metrics are files found by
name: a new one is picked up with no edit to a file that is there; and the
files agree with ``BENCHMARK.json`` and with their published sources."""

import json
import shutil

import pytest

from gpubench import cells

from .conftest import DATA

REPO = cells.ROOT.parent


def _copy(tmp_path):
    root = tmp_path / "bench"
    for sub in ("configs", "traffic", "workloads", "metrics", "arch", "reference"):
        shutil.copytree(cells.ROOT / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_new_files_are_found_without_edits(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "gpt2-xl.json").read_text())
    cfg["as_run"]["n_layers"] = 24
    (root / "configs" / "gpt2-xl-half.json").write_text(json.dumps(cfg))
    (root / "traffic" / "train-s512.json").write_text(json.dumps(
        {"seq": 512, "batch": 24, "remat": True, "pool": 4}))
    wl = json.loads((root / "workloads" / "gpt2-xl.train-s1024.json").read_text())
    wl.update(config="gpt2-xl-half", traffic="train-s512")
    (root / "workloads" / "gpt2-xl-half.train-s512.json").write_text(json.dumps(wl))
    (root / "metrics" / "steps_seen.py").write_text(
        'UNIT = "steps"\n\n\ndef read(run):\n    return run.steps\n')
    # an architecture: its module, its reference, a configuration naming it
    # and a cell of that configuration
    for sub, name in (("arch", "gpt_untied.py"), ("reference", "gpt_untied.py"),
                      ("configs", "tiny-untied.json"), ("traffic", "tiny-s16.json"),
                      ("workloads", "tiny-untied.tiny-s16.json")):
        shutil.copy(DATA / sub / name, root / sub / name)
    cell = cells.load_cell("gpt2-xl-half.train-s512", root)
    assert cell.model["n_layers"] == 24 and cell.model["seq"] == 512
    assert cell.model["remat"] is True and cell.batch == 24
    toy = cells.load_cell("tiny-untied.tiny-s16", root)
    assert toy.arch.__file__ == str(root / "arch" / "gpt_untied.py")
    assert toy.reference.__file__ == str(root / "reference" / "gpt_untied.py")
    params = toy.leaves(5, "cpu").all()
    assert set(params) == set(cell.arch.LEAVES) | {"head"}
    assert toy.model_flops_per_step() == cells.load_cell("tiny.tiny-s16", DATA).model_flops_per_step()
    readers = cells.metric_readers(root)
    assert readers["steps_seen"].UNIT == "steps"
    assert set(cells.metric_readers()) < set(readers)
    assert all(p.read_bytes() == b for p, b in before.items())


def test_unknown_or_malformed_names_are_refused():
    with pytest.raises(FileNotFoundError):
        cells.load_cell("no-such-model.train")
    with pytest.raises(ValueError):
        cells.load_cell("../configs/gpt2-xl")


def _benchmark():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_matches_the_files():
    bench = _benchmark()
    readers = cells.metric_readers()
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert w["name"] == f'{w["config"]}.{w["traffic"]}'
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.workload["chips"] == w["chips"]
        assert cell.workload["why"] == w["why"]
        assert configs[w["config"]]["file"] == f'gpubench/configs/{w["config"]}.json'
        for name in cell.workload["end_to_end"]:
            listed = e2e[name].get("workloads")
            assert listed is None or w["name"] in listed
        for name, m in e2e.items():
            if w["name"] in m.get("workloads", [w["name"]]):
                assert name in cell.workload["end_to_end"]
    for m in bench["per_layer"]:
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"]
        assert m["moves"] in e2e
    assert set(readers) == {m["name"] for m in bench["per_layer"]}


@pytest.mark.parametrize("name", ["gpt2-xl", "mpt-7b-storywriter"])
def test_config_as_run_follows_its_source(name):
    cfg = json.loads((cells.ROOT / "configs" / f"{name}.json").read_text())
    bench = {c["name"]: c for c in _benchmark()["configs"]}[name]
    assert bench["source"] == cfg["source"] and bench["reduced"] == cfg["reduced"]
    for field, key in cfg["from_source"].items():
        same = cfg["as_run"][field] == cfg["published"][key]
        assert same != (key in cfg["reduced"]), (field, key)
    run = cfg["as_run"]
    assert run["d_model"] % run["n_heads"] == 0
    assert run["vocab"] % run["ce_chunk"] == 0
    for key in ("source", "reduced", "assumed", "departures", "deployment"):
        assert cfg[key] is not None
