"""The PyTorch port's decision layer, tables, op checks and datatypes
against the JAX package's.

- ``coll/tuned.decide`` returns the namesake's algorithm for the same
  (operation, comm size, message bytes, reduction op), with the builtin
  fixed decisions, with a forced algorithm and with a rules file; ``xla``
  is the native route in both.
- ``coll/ztable.parse_table`` parses the same sections, rules, geometry
  and problems from the same texts (headers, wildcards, malformed and
  quarantined lines), and ``resolve_rule`` picks the same rule per
  topology key; with ``ZMPI_PMIX`` set, a table published into the PMIx
  store answers first in both packages, and an unreachable store leaves
  the file rung in charge.
- each communicator's memo of decisions follows a change of an MCA
  variable and a rewrite of the rules file.
- ``ops.check_datatype``, ``identity_for`` and ``op_reduce`` agree with
  the namesake for every predefined op, and the predefined datatypes have
  the namesake's names, sizes and extents, bound to their ``torch.dtype``.
"""

import os
import time
import types

import numpy as np
import pytest

import torch
import torch.distributed as dist

import zhpe_ompi_tpu as jz
from zhpe_ompi_tpu.coll import tuned as jtuned
from zhpe_ompi_tpu.coll import ztable as jzt
from zhpe_ompi_tpu.datatype import predefined as jdt
from zhpe_ompi_tpu.mca import var as jvar

import zhpe_ompi_tpu_torch as tz
from zhpe_ompi_tpu_torch.coll import tuned as ttuned
from zhpe_ompi_tpu_torch.coll import ztable as tzt
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.datatype import predefined as tdt
from zhpe_ompi_tpu_torch.mca import var as tvar

SIZES = (1, 2, 3, 4, 8)
NBYTES = (4, 16 * 1024 - 4, 16 * 1024, 1024 * 1024 - 4, 1024 * 1024,
          4 * 1024 * 1024)
OPNAMES = ("SUM", "MAX", "PROD", "BAND", "MINLOC", "NONCOMM")


def _op(pkg, name):
    if name == "NONCOMM":
        return pkg.ops.create_op(lambda a, b: a, commute=False, name="nc")
    return getattr(pkg.ops, name)


def _decisions():
    out_j, out_t = [], []
    for opname, table in ttuned._ALG_TABLES.items():
        reduces = opname in ttuned._OPS_WITH_REDUCTION
        for n in SIZES:
            for nbytes in NBYTES:
                for opn in (OPNAMES if reduces else (None,)):
                    if opname == "barrier":
                        xj = xt = None
                    else:
                        xj = np.empty(nbytes // 4, np.float32)
                        xt = torch.empty(nbytes // 4, dtype=torch.float32)
                    jop = _op(jz, opn) if opn else None
                    top = _op(tz, opn) if opn else None
                    key = (opname, n, nbytes, opn)
                    out_j.append((key, jtuned.decide(
                        opname, types.SimpleNamespace(uniform_size=n), xj, jop)))
                    out_t.append((key, ttuned.decide(
                        opname, types.SimpleNamespace(size=n), xt, top)))
    return out_j, out_t


@pytest.fixture
def both_vars():
    """Set an MCA variable in both packages' registries for one test."""
    names = []

    def set_both(name, value):
        names.append(name)
        jvar.set_var(name, value)
        tvar.set_var(name, value)

    jtuned._register_params()
    ttuned._register_params()
    yield set_both
    for name in names:
        jvar.unset(name)
        tvar.unset(name)
    jtuned.invalidate_rules_cache()
    ttuned.invalidate_rules_cache()


def test_decide_matches_namesake_builtin():
    jtuned._register_params()
    ttuned._register_params()
    out_j, out_t = _decisions()
    assert out_t == out_j
    assert {alg for _, alg in out_t} >= {"xla", "recursive_doubling", "ring",
                                          "rabenseifner", "linear", "binomial",
                                          "scatter_allgather",
                                          "recursive_halving"}


def test_decide_matches_namesake_forced(both_vars):
    both_vars("coll_tuned_allreduce_algorithm", "ring")
    both_vars("coll_tuned_bcast_algorithm", "knomial")
    both_vars("coll_tuned_small_msg", 64)
    out_j, out_t = _decisions()
    assert out_t == out_j
    assert ("allreduce", 4, 4, "SUM") in {k for k, a in out_t if a == "ring"}


RULES = """\
# a topology-scoped table
allreduce 0 0 ring
allreduce 4 16384 rabenseifner
bcast 2 1024 knomial
reduce 0 0 builtin
alltoall 3 0 bruck
allreduce 0 0 han
[topology 2 * *]
allreduce 0 0 linear
geometry sm_ring_bytes 65536
[topology 2 2 2]
bcast 0 0 chain
[topology x 2]
allreduce 0 0 ring
[topology * * *]
scan 0 0 linear
allreduce 0 0 nonexistent
gather 0 notanumber ring
geometry bogus 12
"""


def test_parse_table_matches_namesake():
    for text in (RULES, "", "allreduce 1 2\n[topology 1 1\nbcast 0 0 binary\n",
                 "[topology 0 1 1]\nbcast 0 0 binary\n"):
        pj, pt = [], []
        assert tzt.parse_table(text, "t", pt) == jzt.parse_table(text, "t", pj)
        assert pt == pj
    assert len(tzt.parse_table(RULES)) == 3


@pytest.mark.parametrize("topology", ["", "2:2:2", "2:1:1", "3:1:1", "bad"])
def test_rules_file_matches_namesake(both_vars, tmp_path, topology):
    path = tmp_path / "rules.table"
    path.write_text(RULES)
    both_vars("coll_tuned_dynamic_rules", str(path))
    both_vars("coll_tuned_topology", topology)
    out_j, out_t = _decisions()
    assert out_t == out_j
    key = tzt.job_topology_key()
    assert key == jzt.job_topology_key()
    for opname in ("allreduce", "bcast", "reduce", "scan", "alltoall"):
        for n in SIZES:
            assert (tzt.resolve_rule(opname, n, 20000, key)
                    == jzt.resolve_rule(opname, n, 20000, key))


def test_store_rung_raises_until_pmix_is_ported(both_vars, monkeypatch, tmp_path):
    """The store rung (``ZMPI_PMIX``): a table published into a PMIx store
    answers before the rules file in both packages, with the same
    decisions; an unreachable store is fetched once, negative-cached and
    leaves the file rung in charge, never raising."""
    import socket

    from zhpe_ompi_tpu_torch.runtime import pmix as tpmix
    from zhpe_ompi_tpu_torch.runtime import spc as tspc

    file_rules = tmp_path / "file.table"
    file_rules.write_text("allreduce 0 0 recursive_doubling\n")
    both_vars("coll_tuned_dynamic_rules", str(file_rules))
    both_vars("coll_tuned_topology", "2:2:2")
    srv = tpmix.PmixServer()
    try:
        tpmix.publish_tuned_table(srv.store, RULES)
        monkeypatch.setenv("ZMPI_PMIX", f"127.0.0.1:{srv.address[1]}/job")
        for zt in (jzt, tzt):
            zt.invalidate_cache()
        f0 = tspc.read("tuned_table_store_fetches")
        assert tzt.active() and jzt.active()
        out_j, out_t = _decisions()
        assert out_t == out_j
        key = tzt.job_topology_key()
        for opname in ("allreduce", "bcast", "reduce", "scan", "alltoall"):
            for n in SIZES:
                assert (tzt.resolve_rule(opname, n, 20000, key)
                        == jzt.resolve_rule(opname, n, 20000, key))
        # the store's table ([topology 2 * *]), not the file's, answered
        assert tzt.resolve_rule("allreduce", 4, 20000, key) == "linear"
        assert tspc.read("tuned_table_store_fetches") - f0 == 1  # cached
        srv.store.destroy_ns(tpmix.ZTUNE_NS)
    finally:
        srv.close()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    monkeypatch.setenv("ZMPI_PMIX", f"127.0.0.1:{dead}/job")
    for zt in (jzt, tzt):
        zt.invalidate_cache()
    assert tzt.resolve_rule("allreduce", 4, 64) == "recursive_doubling"
    assert jzt.resolve_rule("allreduce", 4, 64) == "recursive_doubling"
    assert tzt.table_geometry("sm_ring_bytes") is None
    assert ttuned.decide("allreduce", types.SimpleNamespace(size=4),
                         torch.empty(16), tz.PROD) == jtuned.decide(
        "allreduce", types.SimpleNamespace(uniform_size=4),
        np.empty(16, np.float32), jz.PROD)
    for zt in (jzt, tzt):
        zt.invalidate_cache()


def test_no_profile_is_shipped():
    assert ttuned.profiles() == {}


@pytest.fixture
def world1(tmp_path, monkeypatch):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_memoised_decisions_follow_vars_and_rules_file(world1, both_vars,
                                                       tmp_path, monkeypatch):
    comm = tz.Communicator()
    chosen = []
    monkeypatch.setattr(ttuned, "decide", lambda *a, **k: chosen.append(a[0])
                        or "linear")
    x = torch.arange(4.0)
    for _ in range(3):
        comm.allreduce(x, tz.PROD)
    assert chosen == ["allreduce"]  # decided once, then memoised
    both_vars("coll_tuned_allreduce_algorithm", "ring")
    comm.allreduce(x, tz.PROD)
    assert len(chosen) == 2  # a changed MCA variable drops the memo
    path = tmp_path / "rules.table"
    path.write_text("allreduce 0 0 ring\n")
    both_vars("coll_tuned_dynamic_rules", str(path))
    comm.allreduce(x, tz.PROD)
    comm.allreduce(x, tz.PROD)
    assert len(chosen) == 3
    time.sleep(0.01)
    path.write_text("allreduce 0 0 linear   # rewritten\n")
    comm.allreduce(x, tz.PROD)
    assert len(chosen) == 4  # a rewritten rules file drops it too
    comm.allreduce(x, tz.SUM)
    assert len(chosen) == 5  # another reduction op is another decision


# -- ops and datatypes ------------------------------------------------------

DTYPES = [("MPI_FLOAT", np.float32, torch.float32),
          ("MPI_DOUBLE", np.float64, torch.float64),
          ("MPI_INT32_T", np.int32, torch.int32),
          ("MPI_INT64_T", np.int64, torch.int64),
          ("MPI_INT8_T", np.int8, torch.int8),
          ("MPI_UINT8_T", np.uint8, torch.uint8),
          ("MPI_C_BOOL", np.bool_, torch.bool)]
OP_NAMES = sorted(tz.ops.PREDEFINED)


@pytest.mark.parametrize("opname", OP_NAMES)
def test_check_datatype_matches_namesake(opname):
    top, jop = tz.ops.lookup(opname), jz.ops.lookup(opname)
    for name in sorted(tdt._ALL):
        tdtype, jdtype = tdt.lookup(name), jdt.lookup(name)
        try:
            jop.check_datatype(jdtype)
            want = None
        except jz.errors.OpError:
            want = "OpError"
        try:
            top.check_datatype(tdtype)
            got = None
        except terrors.OpError:
            got = "OpError"
        assert got == want, (opname, name)


@pytest.mark.parametrize("opname", OP_NAMES)
def test_identity_for_matches_namesake(opname):
    top, jop = tz.ops.lookup(opname), jz.ops.lookup(opname)
    for _, np_dt, t_dt in DTYPES:
        try:
            want = jop.identity_for(np_dt)
        except jz.errors.OpError:
            with pytest.raises(terrors.OpError):
                top.identity_for(t_dt)
            continue
        got = top.identity_for(t_dt)
        assert got == want and type(got) is type(np.asarray(want).item()), (
            opname, np_dt, got, want)


@pytest.mark.parametrize("opname", [n for n in OP_NAMES if "LOC" not in n])
def test_op_reduce_matches_namesake(opname):
    rng = np.random.default_rng(7)
    top, jop = tz.ops.lookup(opname), jz.ops.lookup(opname)
    for name, np_dt, t_dt in DTYPES:
        a = rng.integers(0, 5, 16).astype(np_dt)
        b = rng.integers(0, 5, 16).astype(np_dt)
        try:
            want = jz.ops.op_reduce(jop, a, b, jdt.lookup(name))
        except jz.errors.OpError:
            with pytest.raises(terrors.OpError):
                tz.ops.op_reduce(top, torch.from_numpy(a), torch.from_numpy(b),
                                 tdt.lookup(name))
            continue
        got = tz.ops.op_reduce(top, torch.from_numpy(a), torch.from_numpy(b),
                               tdt.lookup(name))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{opname} {name}")


def test_minloc_op_reduce_matches_namesake():
    v = np.array([3.0, 1.0, 2.0, 2.0], np.float32)
    w = np.array([1.0, 1.0, 5.0, 2.0], np.float32)
    iv = np.array([0, 5, 2, 9], np.int32)
    iw = np.array([4, 1, 7, 3], np.int32)
    pair = tdt.lookup("MPI_FLOAT_INT")
    for name in ("MPI_MINLOC", "MPI_MAXLOC"):
        jdt_pair = jdt.lookup("MPI_FLOAT_INT")
        a = np.zeros(4, jdt_pair.np_dtype)
        b = np.zeros(4, jdt_pair.np_dtype)
        a["value"], a["index"], b["value"], b["index"] = v, iv, w, iw
        want = jz.ops.op_reduce(jz.ops.lookup(name), a, b, jdt_pair)
        gv, gi = tz.ops.op_reduce(tz.ops.lookup(name),
                                  (torch.from_numpy(v), torch.from_numpy(iv)),
                                  (torch.from_numpy(w), torch.from_numpy(iw)),
                                  pair)
        np.testing.assert_array_equal(gv.numpy(), want["value"])
        np.testing.assert_array_equal(gi.numpy(), want["index"])


def test_predefined_datatypes_match_namesake():
    assert set(tdt._ALL) == set(jdt._ALL)
    for name, t in tdt._ALL.items():
        j = jdt._ALL[name]
        assert (t.size, t.extent, t.lb, t.ub, t.is_contiguous) == (
            j.size, j.extent, j.lb, j.ub, j.is_contiguous), name
        assert type(t).__name__ == type(j).__name__
        if isinstance(t, tdt.BasicDatatype):
            assert t.kind == np.dtype(j.np_dtype).kind or name == "MPI_BFLOAT16"
    assert tdt.BFLOAT16.torch_dtype is torch.bfloat16
    for _, np_dt, t_dt in DTYPES:
        assert tdt.from_torch_dtype(t_dt).name == jdt.from_np_dtype(np_dt).name
    assert tdt.from_torch_dtype(torch.bfloat16) is tdt.BFLOAT16
