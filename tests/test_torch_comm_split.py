"""The PyTorch port's communicator construction and ULFM methods against
the JAX package's.

Four gloo ranks, one spawn (``tests/_torch_dist_worker.py split``):

- **dup of disjoint sub-communicators** (a fault of the port's first
  ``dup``): ranks 0-1 and 2-3 each dup their own half, twice; every dup
  allreduces within its half only (3 on ranks 0-1, 7 on ranks 2-3); a
  wrapper of the half built on rank 0 alone shifts no later dup's name.
- ``split`` with the colours and keys of ``SPLIT_CASES``, against the JAX
  ``split`` of a 4-device axis of the 8-device CPU mesh: membership and
  rank order (the partition, and each rank's place in it) and the
  ``allreduce`` of rank + 1 within each group.  The JAX package's traced
  ``rank()`` ignores a keys reorder when the split leaves one group
  (``zhpe_ompi_tpu/comm/communicator.py``, ``rank``: an unpartitioned
  communicator returns ``axis_index``), so ranks are held against its
  rank table, which follows the partition.
- ``create_from_group``, ``split_type("shared")`` (one host: one group)
  and ``shrink(failed=[2])`` likewise; ``agree`` with the same
  contributions and failed ranks; ``run`` and ``device_put_sharded``.
- ``revoke`` on rank 0 is seen by every rank within 10 s, and the next
  collective raises ``Revoked`` everywhere.

In process, at one rank: ``dup`` drops the info hints in both packages,
and the failure-state methods behave alike.  Results are exact (integers
and sums of small integers in f32).
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import zhpe_ompi_tpu as jz
import zhpe_ompi_tpu_torch as tz
from zhpe_ompi_tpu.comm.group import Group as JGroup
from zhpe_ompi_tpu_torch.core import errhandler as errh
from zhpe_ompi_tpu_torch.core import errors

from _torch_dist_worker import (AGREE_CASES, CREATE_GROUP, SHRINK_FAILED,
                                SPLIT_CASES, flat_partition, run_ranks)

WORLD = 4


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    results, outs = run_ranks("split", WORLD, tmp_path_factory.mktemp("split"))
    for rc, text in results:
        assert rc == 0, text[-3000:]
    return outs


@functools.lru_cache(maxsize=None)
def _jax_axis_comm():
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, WORLD), ("a", "w"))
    return jz.Communicator(mesh, "w")


def _jax_facts(sub):
    """Partition, rank of each axis index, and each index's allreduce of
    index + 1 within its group."""
    x = sub.device_put_sharded(jnp.arange(1.0, WORLD + 1.0).reshape(WORLD, 1))
    sums = np.asarray(sub.run(lambda v: sub.allreduce(v), x)).reshape(-1)
    return flat_partition(sub.partition), sub._rank_table.copy(), sums


def _check(outs, prefix, jax_sub):
    part, rank_table, sums = _jax_facts(jax_sub)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[f"{prefix}_partition"], part)
        assert int(o[f"{prefix}_rank"]) == rank_table[r]
        group = next(g for g in jax_sub.partition if r in g.ranks)
        np.testing.assert_array_equal(o[f"{prefix}_ranks"], group.ranks)
        np.testing.assert_array_equal(o[f"{prefix}_sum"], [sums[r]])


@pytest.mark.parametrize("key", ["c1_dup1", "c1_dup2", "c1_dup1_again"])
def test_dups_of_disjoint_subcommunicators_stay_apart(outs, key):
    scale = 10.0 if key.endswith("again") else 1.0
    for r, o in enumerate(outs):
        want = (3.0 if r < 2 else 7.0) * scale
        np.testing.assert_array_equal(o[key], [want])


def test_an_extra_wrapper_on_one_rank_shifts_no_dup(outs):
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["c1_after_extra_wrapper"],
                                      [3.0 if r < 2 else 7.0])


@pytest.mark.parametrize("name,colors,keys", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_matches_jax(outs, name, colors, keys):
    _check(outs, name, _jax_axis_comm().split(colors, keys))


def test_create_from_group_matches_jax(outs):
    _check(outs, "create", _jax_axis_comm().create_from_group(JGroup(CREATE_GROUP)))


def test_split_type_shared_matches_jax(outs):
    _check(outs, "shared", _jax_axis_comm().split_type("shared"))


def test_shrink_matches_jax(outs):
    _check(outs, "shrink", _jax_axis_comm().shrink(failed=SHRINK_FAILED))


@pytest.mark.parametrize("name,contributions,failed", AGREE_CASES,
                         ids=[c[0] for c in AGREE_CASES])
def test_agree_matches_jax(outs, name, contributions, failed):
    want = _jax_axis_comm().agree(True, contributions=contributions,
                                  failed=failed)
    for r, o in enumerate(outs):
        if r in failed:
            assert f"agree_{name}" not in o
            continue
        assert bool(o[f"agree_{name}"]) == want
        assert bool(o[f"agree_{name}_table"]) == want


def test_run_and_device_put_sharded_match_jax(outs):
    comm = _jax_axis_comm()
    want = np.asarray(comm.run(lambda v: comm.allreduce(v) * 2,
                               comm.device_put_sharded(jnp.arange(8.0))))
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["run"], want)
        np.testing.assert_array_equal(o["put"], np.arange(8.0)[2 * r:2 * r + 2])


def test_revoke_reaches_every_rank(outs):
    for o in outs:
        assert bool(o["revoke_seen"]) and float(o["revoke_seen_s"]) < 10.0
        assert bool(o["revoke_raised"])


# -- one rank, in process ------------------------------------------------------


@pytest.fixture
def world1(tmp_path, monkeypatch):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield tz.Communicator(name="w1")
    finally:
        dist.destroy_process_group()
        from zhpe_ompi_tpu_torch.ft import ulfm

        ulfm.reset_revocations()


def test_dup_drops_info_hints_in_both_packages(world1):
    jcomm = jz.Communicator(_jax_axis_comm().mesh, "w", info={"k": "v"})
    tcomm = tz.Communicator(world1.pg, info={"k": "v"})
    assert dict(jcomm.dup().info.items()) == dict(tcomm.dup().info.items()) == {}
    assert dict(tcomm.info.items()) == {"k": "v"}


class _State:
    """A failure state: ranks failed, and acknowledged on ack()."""

    def __init__(self, failed):
        self._failed, self._acked = set(failed), set()

    def failed(self):
        return set(self._failed)

    def ack(self):
        self._acked = set(self._failed)

    def acked(self):
        return set(self._acked)


def test_failure_state_methods_match_jax(world1):
    jcomm = jz.Communicator(_jax_axis_comm().mesh, "w")
    for comm in (jcomm, world1):
        with pytest.raises((jz.errors.ArgError, errors.ArgError)):
            comm.failure_ack()
        with pytest.raises((jz.errors.ArgError, errors.ArgError)):
            comm.shrink()
    jcomm.bind_failure_state(_State([]))
    world1.bind_failure_state(_State([]))
    for comm in (jcomm, world1):
        comm.failure_ack()
    assert (jcomm.failure_get_acked().ranks == world1.failure_get_acked().ranks
            == ())
    shrunk = world1.shrink()
    assert shrunk.ft_state is world1.ft_state
    assert shrunk.allreduce(torch.ones(2)).tolist() == [1.0, 1.0]
    assert world1.agree(True) is True and world1.agree(False) is False


def test_revoke_raises_revoked_and_agree_still_runs(world1):
    world1.set_errhandler(errh.ERRORS_RETURN)
    assert not world1.is_revoked()
    world1.revoke()
    assert world1.is_revoked()
    with pytest.raises(errors.Revoked) as ei:
        world1.barrier()
    assert ei.value.cid == world1.cid
    assert world1.agree(True) is True
    fresh = world1.shrink(failed=[])
    assert not fresh.is_revoked()
    assert fresh.allreduce(torch.tensor([2.0])).tolist() == [2.0]


def test_wrappers_of_one_group_share_its_lineage(world1):
    """Building a Communicator over a group advances nothing; dups made
    through either wrapper take the group's next child names in turn, and
    a revoke reaches every wrapper of the group."""
    extra = tz.Communicator(world1.pg, name="extra")
    assert extra.gid == world1.gid
    a, b, c = world1.dup(), extra.dup(), world1.dup()
    assert [d.gid for d in (a, b, c)] == [
        f"{world1.gid}.{i}" for i in range(3)]
    for d in (a, b, c):
        assert d.allreduce(torch.tensor([5.0])).tolist() == [5.0]
    b.revoke()
    assert b.is_revoked() and tz.Communicator(b.pg).is_revoked()
    assert not (a.is_revoked() or c.is_revoked() or world1.is_revoked())


def test_split_checks_its_arguments(world1):
    with pytest.raises(errors.ArgError):
        world1.split([0, 1])
    with pytest.raises(errors.ArgError):
        world1.split_type("numa")
    with pytest.raises(errors.GroupError):
        world1.create_from_group(tz.Group([3]))
