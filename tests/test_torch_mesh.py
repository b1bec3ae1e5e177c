"""The PyTorch port's ``parallel/mesh.py`` against the JAX package's.

- ``make_mesh`` at dp2 x tp2 (4 gloo ranks) and dp2 x tp2 x sp2 (8 gloo
  ranks; ``tests/_torch_dist_worker.py mesh``, one spawn per layout): each
  dimension's group equals the one ``_groups`` makes (the row-major layout
  ``make_train_step`` uses), its allreduce of rank + 1 sums that group,
  each rank's coordinate is its row-major index, and ``world_mesh`` is
  every rank in order.
- ``survivor_mesh`` with the failed indices of ``SURVIVOR_CASES`` along
  each axis gives the layout of world ranks that the JAX package's gives
  as device ids, over a mesh of as many CPU devices in the same order.
- ``probe_device_plane`` on the CPU (gloo): "ok" with the child's report;
  with ``ZMPI_DEVICE_WEDGE`` naming the probed rank (or "all") it returns
  "deadline" within its timeout; ``device_probe_rounds`` and
  ``device_probe_misses`` count as in the JAX package.  Without a CUDA
  device the default (CUDA) probe raises.
- ``distributed_initialize`` without torchrun's variables raises
  ``NotInitializedError``, and by default (NCCL) without a CUDA device
  it raises too, making nothing; a mesh whose size is not the world's raises
  ``ArgError``.
"""

import json
import os

import numpy as np
import pytest

import jax
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from zhpe_ompi_tpu.parallel import mesh as jmesh
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.parallel import mesh as tmesh
from zhpe_ompi_tpu_torch.runtime import spc

from _torch_dist_worker import MESH_DIMS, SURVIVOR_CASES, run_ranks


@pytest.fixture(scope="module", params=[4, 8], ids=["dp2xtp2", "dp2xtp2xsp2"])
def layout(request, tmp_path_factory):
    world = request.param
    results, outs = run_ranks("mesh", world, tmp_path_factory.mktemp(f"mesh{world}"))
    for rc, text in results:
        assert rc == 0, text[-3000:]
    return world, outs


def test_make_mesh_groups_are_the_train_step_layout(layout):
    world, outs = layout
    dims = MESH_DIMS[world]
    for r, o in enumerate(outs):
        for name in dims:
            np.testing.assert_array_equal(o[f"mesh_{name}"], o[f"groups_{name}"])
            assert r in o[f"mesh_{name}"]
            assert o[f"sum_{name}"].tolist() == [float(sum(o[f"mesh_{name}"]) +
                                                       len(o[f"mesh_{name}"]))]
        assert o["coord"].tolist() == o["at"].tolist()
        assert list(np.unravel_index(r, list(dims.values()))) == o["coord"].tolist()
        assert o["world_mesh"].tolist() == list(range(world))


def test_survivor_mesh_matches_jax(layout):
    world, outs = layout
    dims = MESH_DIMS[world]
    devs = np.array(jax.devices()[:world]).reshape(tuple(dims.values()))
    jm = Mesh(devs, tuple(dims))
    ids = {d.id: i for i, d in enumerate(jax.devices()[:world])}
    for axis, failed in SURVIVOR_CASES[world]:
        sm = jmesh.survivor_mesh(jm, failed, axis)
        want = np.vectorize(lambda d: ids[d.id])(sm.devices)
        for o in outs:
            np.testing.assert_array_equal(o[f"survivor_{axis}"], want)


def test_survivor_mesh_checks_its_arguments(tmp_path):
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        m = tmesh.make_mesh({"dp": 1, "tp": 1})
        with pytest.raises(errors.ArgError):
            tmesh.survivor_mesh(m, [0])
        with pytest.raises(errors.ArgError):
            tmesh.survivor_mesh(m, [], "sp")
        assert tmesh.survivor_mesh(m, []).mesh.tolist() == [[0]]
        with pytest.raises(errors.ArgError):
            tmesh.make_mesh({"dp": 2})
        assert tmesh.world_devices() == [torch.device("cpu")]
    finally:
        dist.destroy_process_group()


def test_distributed_initialize_needs_the_env_contract(monkeypatch):
    for k in tmesh.ENV_CONTRACT:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(errors.NotInitializedError, match="RANK"):
        tmesh.distributed_initialize("gloo")
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_distributed_initialize_defaults_to_nccl_and_needs_cuda(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.distributed_initialize()
    assert not dist.is_initialized()


def test_probe_ok_on_the_cpu():
    spc.reset()
    kind, detail = tmesh.probe_device_plane(device="cpu")
    assert kind == "ok", detail
    report = json.loads(detail)
    seconds = report.pop("seconds")
    assert report == {"n": 1, "backend": "gloo", "device": "cpu", "allreduce": 1.0}
    assert sorted(seconds) == ["allreduce", "context", "destroy", "group", "import"]
    assert all(0.0 <= s < 60.0 for s in seconds.values()), seconds
    assert (spc.read("device_probe_rounds"), spc.read("device_probe_misses")) == (1, 0)


@pytest.mark.parametrize("wedge,rank", [("all", None), ("3", 3)])
def test_wedged_probe_misses_its_deadline(wedge, rank):
    spc.reset()
    env = dict(os.environ, ZMPI_DEVICE_WEDGE=wedge)
    kind, detail = tmesh.probe_device_plane(timeout=30, deadline=6, env=env,
                                            rank=rank, device="cpu")
    assert kind == "deadline", detail
    assert (spc.read("device_probe_rounds"), spc.read("device_probe_misses")) == (1, 1)
    from zhpe_ompi_tpu_torch.utils import deadline

    assert deadline.orphaned_probe_processes() == []


def test_wedge_of_another_rank_leaves_the_probe_alone():
    env = dict(os.environ, ZMPI_DEVICE_WEDGE="1")
    kind, detail = tmesh.probe_device_plane(env=env, rank=0, device="cpu")
    assert kind == "ok", detail


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_probe_defaults_to_cuda():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.probe_device_plane()
