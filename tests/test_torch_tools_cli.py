"""The port's ``zmpi-info`` and ``zmpi-checkpoint`` CLIs
(``tools/info.py``, ``tools/checkpoint.py``) against the JAX package's.

- info: the JSON lists every framework with the port's components
  (``coll/nccl`` where the namesake lists ``coll/tpu``), the same MCA
  variable set where the two packages share modules, and one pvar row
  for each MPI_T pvar (``mpit.pvar_get_num()``).
- checkpoint: ``list``, ``inspect`` and ``prune`` over a port
  ``Checkpointer`` directory print what the namesake's print over its own
  directory of the same states (``inspect`` reads on the CPU).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from zhpe_ompi_tpu.runtime import checkpoint as jckpt
from zhpe_ompi_tpu.tools import checkpoint as jcli
from zhpe_ompi_tpu.tools import info as jinfo
from zhpe_ompi_tpu_torch.runtime import checkpoint as tckpt
from zhpe_ompi_tpu_torch.tools import checkpoint as tcli
from zhpe_ompi_tpu_torch.tools import info as tinfo
from zhpe_ompi_tpu_torch.tools import mpit as tmpit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_info_json_lists_the_ports_components_and_every_pvar():
    rc, out = _run(tinfo.main, ["--json"])
    assert rc == 0
    data = json.loads(out)
    assert len(data["pvars"]) == tmpit.pvar_get_num()
    assert data["package"] == "zhpe_ompi_tpu_torch"
    comps = {f["framework"]: {c["name"] for c in f["components"]}
             for f in data["frameworks"]}
    jdata = json.loads(_run(jinfo.main, ["--json"])[1])
    jcomps = {f["framework"]: {c["name"] for c in f["components"]}
              for f in jdata["frameworks"]}
    # the frameworks info opens itself (other tests of a worker may have
    # registered more in either package's registry)
    opened = {"coll", "fs", "fbtl", "fcoll", "spml"}
    assert opened <= set(comps) and opened <= set(jcomps)
    assert comps["coll"] == jcomps["coll"] - {"tpu"} | {"nccl"}
    for fw in opened - {"coll"}:
        assert comps[fw] == jcomps[fw], fw
    assert {p["name"] for p in data["params"]} >= {
        "coll", "tcp_eager_limit", "sm", "coll_tuned_dynamic_rules",
        "spc_publish_interval_ms"}
    rc, text = _run(tinfo.main, ["--pvars"])
    assert rc == 0 and "spc_tcp_bytes_sent" in text


def test_info_cli_process():
    res = subprocess.run(
        [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.info",
         "--components"], env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "nccl" in res.stdout and "tpu " not in res.stdout


STATES = [
    {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                "b": np.zeros(4, np.float32)}},
    {"params": {"w": np.ones((3, 4), np.float32),
                "b": np.full(4, 2.0, np.float32)}},
    {"params": {"w": np.full((3, 4), 3.0, np.float32),
                "b": np.ones(4, np.float32)}},
]


def _mb_free(text):
    """A listing without its sizes (the two packages' file sets differ:
    tree.json against the namesake's pickled treedef)."""
    return [line.split("  ")[0].split(" in /")[0]
            for line in text.splitlines()]


@pytest.mark.parametrize("keep", [1, 0])
def test_checkpoint_cli_matches_the_namesake(tmp_path, keep):
    out = {}
    for name, ck_mod, cli in (("port", tckpt, tcli), ("jax", jckpt, jcli)):
        d = str(tmp_path / name)
        # no quiescence check: universes other tests of this worker left
        # live are no concern of the CLI
        ck = ck_mod.Checkpointer(d, keep=5, check_quiescent=False)
        for i, state in enumerate(STATES):
            ck.save(10 * (i + 1), state, blocking=True)
        listed = _run(cli.main, ["list", d])
        inspected = _run(cli.main, ["inspect", d, "--step", "20"])
        pruned = _run(cli.main, ["prune", d, "--keep", str(keep)])
        after = _run(cli.main, ["list", d])
        out[name] = (listed[0], _mb_free(listed[1]), inspected[0],
                     [ln for ln in inspected[1].splitlines()
                      if "leaf[" in ln], pruned, after[0],
                     _mb_free(after[1]))
    # the namesake's inspect flattens restore()'s (state, step) tuple, so
    # it prints the step as one more leaf; the port prints the state's
    jleaves = out["jax"][3]
    assert jleaves[-1].endswith("shape=() dtype=int")
    out["jax"] = out["jax"][:3] + (jleaves[:-1],) + out["jax"][4:]
    assert out["port"] == out["jax"]
    leaves = out["port"][3]
    assert "leaf[0]: shape=(4,) dtype=float32" in leaves[0]
    assert "leaf[1]: shape=(3, 4) dtype=float32" in leaves[1]
    assert out["port"][5] == (0 if keep else 1)
