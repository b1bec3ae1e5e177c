"""The PyTorch port's runtime (``runtime/init.py`` and the hook framework)
against the JAX package's.

- Before ``init``, ``world``, ``comm_self`` and ``world_mesh`` raise
  ``NotInitializedError``, as in the JAX package.
- In process, at one rank (``device="cpu"``): ``init`` makes a one-rank
  gloo world on an in-process store and returns COMM_WORLD; it is
  idempotent; COMM_SELF is this rank alone with a partition of one group
  per rank (the JAX package's shape); ``finalize`` runs the finalize hooks
  and destroys the group ``init`` made, leaving ``torch.distributed`` as
  it found it.  A group the caller made is adopted and left in place.
  With no CUDA device, ``init()`` raises and makes nothing.  Under a
  ``WORLD_SIZE`` above 1, ``init`` joins the job by default and refuses
  ``distributed=False`` (or the var set false): no one-rank world.
- The comm_method hook prints the world's layout, then the coll component
  of each operation in the JAX package's order (``COLL_OPS``), at most
  ``hook_comm_method_max`` rows; at finalize it prints the SPC counters.
- Four gloo ranks spawned through torchrun's environment contract
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
  ``LOCAL_RANK``; ``tests/_torch_dist_worker.py runtime``, where
  ``init(device="cpu")`` is not told to join): the world's
  rank and size, an allreduce over it and over COMM_SELF, the world mesh,
  and the state after ``finalize``.
"""

import socket

import numpy as np
import pytest

import torch
import torch.distributed as dist

from zhpe_ompi_tpu.coll import framework as jframework
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.mca import var as mca_var
from zhpe_ompi_tpu_torch.runtime import init as rt
from zhpe_ompi_tpu_torch.runtime import spc

from _torch_dist_worker import run_ranks


@pytest.fixture(autouse=True)
def clean_runtime(monkeypatch):
    """Each test starts and ends with no runtime and no process group."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    spc.reset()
    yield
    if rt.initialized():
        rt.finalize()
    if dist.is_initialized():
        dist.destroy_process_group()
    spc.reset()


@pytest.mark.parametrize("fn", [rt.world, rt.comm_self, rt.world_mesh])
def test_not_initialized_before_init(fn):
    assert not rt.initialized()
    with pytest.raises(errors.NotInitializedError):
        fn()


def test_init_one_rank_in_process():
    w = rt.init(device="cpu")
    assert rt.initialized() and not rt.is_finalized()
    assert rt.init(device="cpu") is w is rt.world()
    assert (w.name, w.rank, w.size, w.backend) == ("MPI_COMM_WORLD", 0, 1, "gloo")
    cs = rt.comm_self()
    assert (cs.name, cs.size, len(cs.partition), cs.uniform_size) == (
        "MPI_COMM_SELF", 1, 1, 1)
    assert cs.pg is not w.pg
    assert rt.world_mesh().mesh.tolist() == [0]
    assert rt.world_mesh().mesh_dim_names == ("world",)
    assert spc.read("init_count") == 1
    assert w.allreduce(torch.tensor([3.0])).tolist() == [3.0]
    rt.finalize()
    assert not rt.initialized() and rt.is_finalized()
    assert not dist.is_initialized()


def test_init_adopts_the_callers_group(tmp_path):
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    w = rt.init(device="cpu")
    assert w.pg is dist.group.WORLD
    rt.finalize()
    assert dist.is_initialized()
    dist.destroy_process_group()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_init_without_cuda_raises_and_makes_nothing():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.init()
    assert not rt.initialized() and not dist.is_initialized()


@pytest.mark.parametrize("how", ["default", "distributed_false", "var_false"])
def test_a_multi_rank_env_never_gets_a_one_rank_world(monkeypatch, how):
    """Under WORLD_SIZE > 1, init joins from the environment by default
    (here it lacks MASTER_ADDR, so that raises) and refuses to be told
    not to: no one-rank world is made either way."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    kwargs = {"distributed": False} if how == "distributed_false" else {}
    if how == "var_false":
        mca_var.set_var("rte_distributed_init", False)
    try:
        want = errors.NotInitializedError if how == "default" else errors.ArgError
        with pytest.raises(want, match="MASTER_ADDR|WORLD_SIZE=4"):
            rt.init(device="cpu", **kwargs)
    finally:
        mca_var.unset("rte_distributed_init")
    assert not rt.initialized() and not dist.is_initialized()


def test_comm_method_lines(capsys):
    mca_var.set_var("hook_comm_method_enable", True)
    mca_var.set_var("hook_comm_method_max", 5)
    try:
        rt.init(device="cpu")
        err = capsys.readouterr().err.splitlines()
        lines = [ln.split("] ", 1)[1] for ln in err if "comm_method" in ln]
        assert lines[0] == ("comm_method: world of 1 rank(s) [0] on cpu "
                            "device(s), backend gloo, this rank 0")
        assert lines[1] == "comm_method: MPI_COMM_WORLD coll selection:"
        rows = [ln.split()[1] for ln in lines[2:]]
        assert rows == list(jframework.COLL_OPS[:5])
        assert all(ln.endswith("-> tuned") for ln in lines[2:])
        rt.finalize()
        err = capsys.readouterr().err
        assert "comm_method: SPC at finalize: init_count=1" in err
    finally:
        mca_var.unset("hook_comm_method_enable")
        mca_var.unset("hook_comm_method_max")


def test_hooks_stay_quiet_by_default(capsys):
    rt.init(device="cpu")
    rt.finalize()
    assert "comm_method" not in capsys.readouterr().err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "ZMPI_MCA_hook_comm_method_enable": "1"}
    results, outs = run_ranks("runtime", 4, tmp_path_factory.mktemp("rt"),
                              env=env)
    for rc, text in results:
        assert rc == 0, text[-3000:]
    return results, outs


def test_four_ranks_through_the_env_contract(four_ranks):
    results, outs = four_ranks
    for r, o in enumerate(outs):
        assert not bool(o["before"]) and bool(o["idempotent"])
        assert o["world"].tolist() == [r, 4]
        assert o["world_sum"].tolist() == [10.0]
        assert o["self"].tolist() == [0, 1, 4, 1]
        assert o["self_sum"].tolist() == [r + 1.0]
        assert o["mesh"].tolist() == [0, 1, 2, 3]
        assert int(o["init_count"]) == 1 and bool(o["is_zmpi_world"])
        # finalize: not initialized, finalized, the group init made is gone
        assert o["after"].tolist() == [False, True, False]


def test_four_ranks_print_their_layout(four_ranks):
    results, _ = four_ranks
    for r, (_, text) in enumerate(results):
        assert (f"comm_method: world of 4 rank(s) [0, 1, 2, 3] on cpu "
                f"device(s), backend gloo, this rank {r}") in text
