"""Cells, configurations, traffic mixes and per-layer metric readers, each
found by its name as a file of its own under the benchmark's folder:

- ``workloads/<cell>.json``: the configuration and traffic it pairs, its
  chips, why it exists, the end-to-end metrics it reports, how many of its
  first steps the reference follows, and the limits of its comparison;
- ``configs/<config>.json``: the published configuration, what was cut or
  assumed, its ``architecture``, and ``as_run``, the sizes as the
  architecture's step takes them;
- ``traffic/<traffic>.json``: the training job (sequence length, batch,
  remat, the pool of distinct batches);
- ``metrics/<metric>.py``: a reader with ``UNIT`` and ``read(run)``;
- ``arch/<architecture>.py``: the architecture's leaves, the port's step
  for it, its work counts and its kernels' shapes; its plain reference is
  ``reference/<architecture>.py``.

A later change adds a cell, a configuration, a traffic mix, a metric or an
architecture by adding its files; none of these needs an edit to a file
that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

from . import inputs

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


def _module(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(f"{prefix}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_code(folder: str, name: str, root: Path = ROOT):
    """The module ``folder/<name>.py`` under ``root``, or under the
    benchmark's own folder where ``root`` has none (a folder of test data
    that brings its own cells but not their architectures)."""
    for base in (root, ROOT):
        path = base / folder / f"{_name(folder, name)}.py"
        if path.is_file():
            return _module(path, f"gpubench_{folder}")
    raise FileNotFoundError(f"no {name!r} in {root / folder}")


@dataclass(frozen=True)
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    #: the architecture's module (``arch/<name>.py``) and its reference's
    arch: object = None
    reference: object = None

    @property
    def model(self) -> dict:
        """The configuration's ``as_run`` sizes with the traffic's sequence
        length and remat, as the architecture's step takes them."""
        return dict(self.config["as_run"], seq=self.traffic["seq"],
                    remat=bool(self.traffic["remat"]))

    def leaves(self, seed: int, device) -> inputs.Leaves:
        return inputs.Leaves(self.arch, self.model, seed, device)

    def model_flops_per_step(self) -> float:
        return self.arch.model_flops_per_step(self.model, self.batch)

    def attention_shape(self) -> dict:
        return self.arch.attention_shape(self.model, self.batch)

    def norm_shape(self) -> dict:
        return self.arch.norm_shape(self.model, self.batch)

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])

    @property
    def checked_steps(self) -> int:
        return int(self.workload["checked_steps"])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic, architecture and
    reference, from ``root``."""
    wl = _load(root, "workloads", name)
    config = _load(root, "configs", wl["config"])
    arch = config["architecture"]
    return Cell(name, wl, config, _load(root, "traffic", wl["traffic"]),
                load_code("arch", arch, root), load_code("reference", arch, root))


def metric_readers(root: Path = ROOT) -> dict:
    """Every per-layer metric reader under ``root/metrics``, by name: the
    module's ``UNIT`` and ``read``."""
    return {_name("metric", path.stem): _module(path, "gpubench_metric")
            for path in sorted((root / "metrics").glob("*.py"))}
