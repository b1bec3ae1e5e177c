"""The PyTorch port's communicator and coll framework on gloo (CPU).

- ``comm_select`` composes every collective from ``tuned`` (priority 50),
  whose ``xla`` route is the ``nccl`` component (gloo-backed here);
  allreduce with SUM/MAX/MIN/LAND/LOR/LXOR on two gloo ranks equals numpy,
  and bcast is native.
- An op the JAX package sends to its algorithm layer (``coll/tpu.py:109``:
  PROD, bitwise, MINLOC) computes through ``coll/algorithms.py`` and
  equals numpy.
- Errors at the dispatch boundary are typed and, by default, fatal.
- The ``coll`` MCA variable's include/exclude list is honoured, from the
  API layer and from ``ZMPI_MCA_coll`` in the environment.

Multi-rank cases run as separate processes joined through a FileStore in
the test's own directory, each join bounded by a timeout.
"""

import numpy as np
import pytest

import torch
import torch.distributed as dist

import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch.coll import framework
from zhpe_ompi_tpu_torch.core import errhandler as errh
from zhpe_ompi_tpu_torch.core import errors

from _torch_dist_worker import run_ranks


@pytest.fixture
def world1(tmp_path, monkeypatch):
    """A one-rank gloo world in this process."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_comm_select_composes_nccl_component_on_gloo(world1, monkeypatch):
    from zhpe_ompi_tpu_torch.coll import nccl

    comm = zmpi.Communicator(name="w")
    assert (comm.rank, comm.size, comm.backend) == (0, 1, "gloo")
    assert comm.group.ranks == (0,)
    table = comm.coll
    assert set(table) == set(framework.COLL_OPS)
    assert {c for _, c in table.values()} == {"tuned"}
    assert [c.name for c in framework.coll_framework().admitted()] == [
        "tuned", "nccl", "basic"]
    # tuned's "xla" route is the nccl component: SUM goes native
    native = []
    monkeypatch.setattr(nccl, "_all_reduce", lambda *a: native.append(a) or a[1])
    comm.allreduce(torch.ones(4))
    assert len(native) == 1


@pytest.mark.parametrize("op,fn", [
    (zmpi.SUM, lambda a: a), (zmpi.MAX, lambda a: a), (zmpi.MIN, lambda a: a),
    (zmpi.LAND, lambda a: (a != 0).astype(a.dtype)),
    (zmpi.LOR, lambda a: (a != 0).astype(a.dtype)),
    (zmpi.LXOR, lambda a: (a != 0).astype(a.dtype)),
])
def test_one_rank_allreduce(world1, op, fn):
    """``fn``: the native route's answer (coll/nccl re-expresses the
    logical ops as flags).  Through the composed table, tuned sends the
    logical ops to recursive doubling, which at one rank returns the one
    contribution as it came, as the JAX package's does."""
    from zhpe_ompi_tpu_torch.coll import nccl

    comm = zmpi.Communicator()
    x = np.array([0, 3, -2, 5], np.int32)
    got = nccl.allreduce(comm, torch.from_numpy(x.copy()), op)
    np.testing.assert_array_equal(got.numpy(), fn(x))
    got = comm.allreduce(torch.from_numpy(x.copy()), op)
    np.testing.assert_array_equal(got.numpy(), x)


def test_non_native_op_raises_typed_error(world1):
    """An op without a native reduction (PROD, bitwise) no longer raises: it
    computes through the algorithm layer, as in the JAX package."""
    comm = zmpi.Communicator()
    comm.set_errhandler(errh.ERRORS_RETURN)
    x = torch.tensor([2.0, -3.0, 0.5])
    np.testing.assert_array_equal(comm.allreduce(x, zmpi.PROD).numpy(), x.numpy())
    flags = torch.tensor([6, 3, 0], dtype=torch.int32)
    np.testing.assert_array_equal(comm.allreduce(flags, zmpi.BAND).numpy(),
                                  flags.numpy())


def test_non_native_op_is_fatal_by_default(world1):
    """The communicator default is MPI_ERRORS_ARE_FATAL, as in the JAX
    package: a typed error at the dispatch boundary arrives wrapped in a
    JobAbort."""
    comm = zmpi.Communicator()
    with pytest.raises(errh.JobAbort) as info:
        comm._coll_call("neighbor_allgather", torch.ones(4))
    assert info.value.errclass == errors.ERR_UNSUPPORTED


def test_unprovided_collective_is_unsupported(world1):
    comm = zmpi.Communicator()
    comm.set_errhandler(errh.ERRORS_RETURN)
    with pytest.raises(errors.UnsupportedError, match="no coll component"):
        comm._coll_call("neighbor_allgather", torch.ones(4))


@pytest.mark.parametrize("spec,selected", [("nccl", True), ("^nccl", False)])
def test_mca_coll_include_exclude(world1, spec, selected):
    """``selected``: whether the nccl component is in the composed table
    (with it excluded, tuned serves every op and basic backs it up)."""
    from zhpe_ompi_tpu_torch.mca import var as mca_var

    framework.coll_framework()  # registers the "coll" variable
    mca_var.set_var("coll", spec)
    try:
        comm = zmpi.Communicator()
        components = {c for _, c in comm.coll.values()}
        assert components == ({"nccl"} if selected else {"tuned"})
        np.testing.assert_array_equal(
            comm.allreduce(torch.ones(3), zmpi.PROD).numpy(), 1.0)
    finally:
        mca_var.unset("coll")


def test_dup_gets_fresh_cid_and_copies_attributes(world1):
    from zhpe_ompi_tpu_torch.core import attributes

    comm = zmpi.Communicator()
    kv = attributes.create_keyval(attributes.DUP_FN)
    comm.set_attr(kv, "hint")
    new = comm.dup()
    assert new.cid != comm.cid and new.size == comm.size
    assert new.get_attr(kv) == (True, "hint")
    np.testing.assert_array_equal(new.allreduce(torch.ones(3)).numpy(), 1.0)


def test_communicator_needs_initialized_distributed():
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    with pytest.raises(errors.NotInitializedError):
        zmpi.Communicator()


def test_two_gloo_ranks_allreduce_equals_numpy(tmp_path):
    results, outs = run_ranks("allreduce", 2, tmp_path)
    for rc, log in results:
        assert rc == 0, log
    xs = np.stack([o["x"] for o in outs])
    fs = np.stack([o["flags"] for o in outs]) != 0
    want = {
        "MPI_SUM": xs.sum(0), "MPI_MAX": xs.max(0), "MPI_MIN": xs.min(0),
        "MPI_LAND": fs.all(0).astype(np.int32),
        "MPI_LOR": fs.any(0).astype(np.int32),
        "MPI_LXOR": (fs.sum(0) % 2).astype(np.int32),
    }
    for o in outs:
        for name, w in want.items():
            # float sums of two terms are exact in either order
            np.testing.assert_array_equal(o[name], w, err_msg=name)
        np.testing.assert_array_equal(o["bcast"], outs[1]["x"])
        np.testing.assert_array_equal(o["input_untouched"], o["x"])
        assert list(o["coll_components"]) == ["tuned"]
        # the ops the algorithm layer computes
        np.testing.assert_allclose(o["MPI_PROD"], xs.prod(0), rtol=1e-6)
        np.testing.assert_array_equal(
            o["MPI_BAND"], np.bitwise_and(*[p["ints"] for p in outs]))
        vals = np.stack([p["x"] for p in outs])
        np.testing.assert_array_equal(o["MINLOC_v"], vals.min(0))
        np.testing.assert_array_equal(o["MINLOC_i"], vals.argmin(0))


def test_mca_coll_exclude_from_environment(tmp_path):
    results, outs = run_ranks("select", 1, tmp_path,
                              env={"ZMPI_MCA_coll": "^nccl,tuned,basic"})
    rc, log = results[0]
    assert rc != 0 and "no coll component available" in log, log
    assert outs[0] is None
