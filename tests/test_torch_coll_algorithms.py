"""The PyTorch port's collective algorithms against the JAX package's.

Every algorithm of ``zhpe_ompi_tpu_torch/coll/algorithms.py`` (allreduce
×6, bcast ×9, reduce ×7, allgather ×6, alltoall ×5, alltoallv, reduce_scatter
×4, reduce_scatter_block ×4, scan/exscan ×4, barrier ×6, gather/scatter ×5,
allgatherv) and every collective method of the port's ``Communicator``
(through the composed ``tuned`` → ``nccl``/algorithm table), at comm sizes
3 and 4, against its namesake in ``zhpe_ompi_tpu`` run under ``shard_map``
on a sub-mesh of the same size of the suite's 8 CPU devices.

The inputs, the cases and the ops come from ``tests/_torch_dist_worker.py``
(``coll_inputs``, ``coll_cases``, ``case_ops``): SUM, PROD and MAX on f32
blocks, MINLOC on (value, index) pairs with ties where the JAX algorithm
takes a pair, and a non-commutative user op (``2a + b``) through the
communicator, which ``tuned`` sends to the rank-ordered linear algorithm in
both packages.  Rooted algorithms run at roots 0 and n − 1.  Each rank's
result is compared, the partial values a rooted reduce or gather leaves on
non-root ranks included: the port runs the same schedule with Python
branches where the JAX package masks with ``jnp.where``.  Tolerance: rtol
1e-6 (the same f32 operations in the same order).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import zhpe_ompi_tpu as jz
from zhpe_ompi_tpu import compat
from zhpe_ompi_tpu.coll import algorithms as jalg

from _torch_dist_worker import (case_ops, coll_cases, coll_inputs,
                                noncommutative, run_ranks)

SIZES = (3, 4)
_KEYS = ("x", "xp", "loc_v", "loc_i", "xv", "xg")


def _run_case(fn, name, kind, kw, t, ops, counts, gv_counts, res):
    """One case of ``coll_cases`` on the JAX side, in ``shard_map``."""
    for opname in case_ops(name, kind):
        key = name if opname is None else f"{name}/{opname}"
        if kind == "red":
            if opname == "MINLOC":
                x = (t["loc_v"], t["loc_i"])
            else:
                x = t["xp"] if opname == "PROD" else t["x"]
            r = fn(x, ops[opname], **kw)
        elif kind == "plain":
            r = fn(t["x"], **kw)
        elif kind == "atv":
            r = fn(t["xv"], counts)
        elif kind == "agv":
            r = fn(t["xg"], gv_counts)
        else:
            r = fn()
        if isinstance(r, tuple):
            res[key + "#v"], res[key + "#i"] = r[0][None], r[1][None]
        else:
            res[key] = jnp.asarray(r)[None]


@functools.lru_cache(maxsize=None)
def _jax_results(n):
    """Every case's result on every rank, (n, ...) per key, from one jitted
    shard_map program over n CPU devices."""
    inp = coll_inputs(n)
    counts, gv_counts = inp["counts"].tolist(), inp["gv_counts"].tolist()
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    comm = jz.Communicator(mesh, "x", name=f"port_coll{n}")
    ops = {k: getattr(jz.ops, k) for k in ("SUM", "PROD", "MAX", "MINLOC")}
    ops["NONCOMM"] = jz.ops.create_op(noncommutative, commute=False, name="nc")
    cases = {name: (fn_name, kind, kw) for name, fn_name, kind, kw in coll_cases(n)}

    def fns(name):
        fn_name = cases[name][0]
        if name.startswith("comm."):
            return getattr(comm, fn_name)
        return functools.partial(getattr(jalg, fn_name), comm)

    def body(*arrs):
        t = {k: a[0] for k, a in zip(_KEYS, arrs)}
        res = {}
        for name, (_, kind, kw) in cases.items():
            _run_case(fns(name), name, kind, kw, t, ops, counts, gv_counts, res)
        return res

    f = jax.jit(compat.shard_map(body, mesh=mesh,
                                 in_specs=tuple(P("x") for _ in _KEYS),
                                 out_specs=P("x"), check_vma=False))
    return {k: np.asarray(v) for k, v in f(*(inp[k] for k in _KEYS)).items()}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Every case's result on every rank of the port, one gloo world per
    size."""
    out = {}
    for n in SIZES:
        d = tmp_path_factory.mktemp(f"coll{n}")
        results, outs = run_ranks("coll", n, d)
        for rc, log in results:
            assert rc == 0, log
        out[n] = outs
    return out


def _keys(n):
    return [f"{name}/{op}" if op else name
            for name, _, kind, _ in coll_cases(n) for op in case_ops(name, kind)]


@pytest.mark.parametrize("n", SIZES)
def test_every_algorithm_has_a_case(n):
    from zhpe_ompi_tpu_torch.coll import algorithms as palg

    names = {c[1] for c in coll_cases(n) if not c[0].startswith("comm.")}
    public = {k for k, v in vars(palg).items()
              if callable(v) and not k.startswith("_")
              and getattr(v, "__module__", "") == palg.__name__}
    # the prepare step is exercised by both alltoallv transports
    assert public - names == {"alltoallv_prepare"}
    assert names <= public
    assert public == {k for k, v in vars(jalg).items()
                      if callable(v) and not k.startswith("_")
                      and getattr(v, "__module__", "") == jalg.__name__}


@pytest.mark.parametrize("case", [pytest.param((n, key), id=f"n{n}-{key}")
                                  for n in SIZES for key in _keys(n)])
def test_matches_jax_namesake(port_results, case):
    n, key = case
    want = _jax_results(n)
    outs = port_results[n]
    parts = [k for k in want if k == key or k.startswith(key + "#")]
    assert parts, key
    for part in parts:
        for rank in range(n):
            got = outs[rank][part]
            assert got.shape == want[part][rank].shape, (part, rank)
            np.testing.assert_allclose(got, want[part][rank], rtol=1e-6,
                                       atol=0, err_msg=f"{part} rank {rank}")


def test_communicator_collectives_route_through_tuned(port_results):
    for n in SIZES:
        for out in port_results[n]:
            assert list(out["coll_components"]) == ["tuned"]
