"""Cells, configurations, traffic mixes and per-layer metric readers, each
found by its name as a file of its own under the benchmark's folder:

- ``workloads/<cell>.json``: the configuration and traffic it pairs, its
  chips, why it exists, the end-to-end metrics it reports, how many of its
  first steps the reference follows, and the limits of its comparison;
- ``configs/<config>.json``: the published configuration, what was cut or
  assumed, and ``as_run``, the port's ``transformer.Config`` fields;
- ``traffic/<traffic>.json``: the training job (sequence length, batch,
  remat, the pool of distinct batches);
- ``metrics/<metric>.py``: a reader with ``UNIT`` and ``read(run)``.

A later change adds a cell, a configuration, a traffic mix or a metric by
adding its file; none of these needs an edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _name(kind: str, name: str) -> str:
    if not _NAME.fullmatch(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def _load(root: Path, folder: str, name: str) -> dict:
    path = root / folder / f"{_name(folder, name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {name!r} in {root / folder}")
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def model(self) -> dict:
        """The port's ``transformer.Config`` fields as the cell runs them."""
        return dict(self.config["as_run"], seq=self.traffic["seq"],
                    remat=bool(self.traffic["remat"]))

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])

    @property
    def checked_steps(self) -> int:
        return int(self.workload["checked_steps"])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic, from ``root``."""
    wl = _load(root, "workloads", name)
    return Cell(name, wl, _load(root, "configs", wl["config"]),
                _load(root, "traffic", wl["traffic"]))


def metric_readers(root: Path = ROOT) -> dict:
    """Every per-layer metric reader under ``root/metrics``, by name: the
    module's ``UNIT`` and ``read``."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = _name("metric", path.stem)
        spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out
