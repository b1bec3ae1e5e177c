"""The port's fault-storm soak harness (``tools/zsoak.py``) against the
JAX package's: one ``random.Random(seed)`` gives the same cycle plan in
both packages and on every replay, the placement the harness predicts
with ``dvmtree.place_job`` is the namesake's over the same inputs, the
worker programs import only the port, and (``slow``, as the namesake's
``tests/test_stress.py`` storm is) three seeded cycles on a port daemon
tree finish with zero invariant violations.
"""

import os
import random
import subprocess
import sys
import types

import pytest

from zhpe_ompi_tpu.runtime import dvmtree as jdvmtree
from zhpe_ompi_tpu.tools import zsoak as jzsoak
from zhpe_ompi_tpu_torch.runtime import dvmtree as tdvmtree
from zhpe_ompi_tpu_torch.tools import zsoak as tzsoak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plan(mod, seed, cycles=40, daemons=4, ranks=3):
    """The harness's cycle plan for ``seed`` without building a tree:
    ``plan`` reads only the harness's rng and arguments."""
    fake = types.SimpleNamespace(
        rng=random.Random(seed),
        args=types.SimpleNamespace(cycles=cycles, daemons=daemons,
                                   ranks=ranks))
    return mod._Harness.plan(fake)


@pytest.mark.parametrize("seed", [0, 3, 7, 1234])
def test_seeded_plan_replays_identically_and_as_the_namesake(seed):
    port = _plan(tzsoak, seed)
    assert port == _plan(tzsoak, seed)
    assert port == _plan(jzsoak, seed)
    assert {p["shape"] for p in port} == {"storm", "queue", "daemon"}
    assert _plan(tzsoak, seed, daemons=2) == _plan(jzsoak, seed, daemons=2)


@pytest.mark.parametrize("policy", ["pack", "spread", "exclusive"])
def test_predicted_placement_is_the_namesakes(policy):
    rng = random.Random(11)
    daemons = ["127.0.0.1:%d" % (7000 + i) for i in range(4)]
    for _ in range(20):
        busy = {d: rng.randrange(3) for d in daemons if rng.random() < 0.5}
        ranks = list(range(rng.randrange(1, 9)))
        assert tdvmtree.place_job(ranks, daemons, busy, policy) == \
            jdvmtree.place_job(ranks, daemons, busy, policy)


def test_worker_programs_run_the_port():
    assert set(tzsoak._PROGRAMS) == set(jzsoak._PROGRAMS)
    for name, body in tzsoak._PROGRAMS.items():
        assert "import zhpe_ompi_tpu_torch as zmpi" in body, name
        assert "zhpe_ompi_tpu " not in body and "jax" not in body, name


@pytest.mark.slow
def test_three_cycle_storm_clean(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.zsoak",
         "--cycles", "3", "--seed", "3", "--workdir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "violations=0" in res.stdout, res.stdout
