"""The PyTorch port stands alone: no jax, no JAX package, no silent CPU.

- An AST scan of every file of ``zhpe_ompi_tpu_torch/`` and of
  ``chip_smoke.py`` finds no import of ``jax``, of ``zhpe_ompi_tpu`` or of
  the root ``benchmarks`` package, the JAX package's harness
  (``zhpe_ompi_tpu_torch`` is the port itself and allowed, its
  ``benchmarks`` subpackage among it).
- Importing every module of the port in a fresh interpreter loads none of
  them.
- An entry point called with the default device on a host without CUDA
  raises instead of running on the CPU.
- ``chip_smoke.py`` fails, and prints no result, without a CUDA device and
  when it stands alone in a directory.
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "zhpe_ompi_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    # the root ``benchmarks`` package is the JAX package's harness (its
    # osu_zmpi imports zhpe_ompi_tpu); the port has its own inside it
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "zhpe_ompi_tpu", "benchmarks")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__",) and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import zhpe_ompi_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    port.__path__, prefix='zhpe_ompi_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zhpe_ompi_tpu', 'benchmarks'))\n"
        "assert not bad, bad\n"
        "print('imported', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15, proc.stdout


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    cfg = tfm.Config()
    np_params = {"embed": np.zeros((cfg.vocab, cfg.d_model), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.params_from_numpy(np_params, cfg)


def _run_smoke(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
