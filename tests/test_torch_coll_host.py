"""The port's host-plane collectives (``coll/host``, ``coll/nbc``,
``coll/inter``) against the JAX package's, at 3 and 4 thread ranks.

Every flat collective and every nonblocking one runs on the same numpy
inputs (a fixed seed) in a JAX-package ``LocalUniverse`` with its ops and
in a port ``LocalUniverse`` with the port's torch ops — once with the
numpy inputs, once with the equal CPU tensors — and the results agree
exactly (integer-valued float64 and int64 data: every combine order gives
the same bits).  The case table covers the binomial, pipelined (segment
forced small) and linear paths, recursive doubling and the ring allreduce
(``host_coll_large_msg`` forced small), pairwise and Bruck alltoall (the
second through a rules table), a non-commutative user op and blockwise
list reductions.  The result kinds the port's docstring states are held:
a reduction returns the kind it was given.

Also held: the coll/han seam on the thread plane (one locality group:
``coll_han_enable=on`` and a ``han`` rules line fall back to the flat
algorithm loudly, counted in ``han_flat_fallbacks`` as in the namesake;
``auto`` and ``off`` are flat and count nothing; ``coll/han`` itself is
held in ``tests/test_torch_han.py``), and ``InterCollectives`` over a
two-group bridge built from two thread universes' contexts.
"""

import contextlib

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu.pt2pt.universe import LocalUniverse as JUniverse
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.coll import host as thost
from zhpe_ompi_tpu_torch.coll import inter as tinter
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse as TUniverse


@pytest.fixture(scope="module", autouse=True)
def _no_queue_left_behind():
    """The JAX package's universes built here hold no message or receive
    when this file is done (its quiescence check reads every live one),
    and none of the port's stays live."""
    import gc

    from zhpe_ompi_tpu.pt2pt import universe as juni
    from zhpe_ompi_tpu_torch.pt2pt import universe as tuni

    before = [juni._queue_depth(k) for k in ("posted", "unexpected")]
    yield
    gc.collect()
    after = [juni._queue_depth(k) for k in ("posted", "unexpected")]
    assert all(a <= b for a, b in zip(after, before)), (after, before)
    assert [tuni._queue_depth(k) for k in ("posted", "unexpected")] == [0, 0]


def _inputs(n, seed=5):
    rng = np.random.default_rng(seed + n)
    return {
        "v": [rng.integers(-6, 7, (7,)).astype(np.float64) for _ in range(n)],
        "i": [rng.integers(-9, 10, (5,)).astype(np.int64) for _ in range(n)],
        "big": [rng.integers(-3, 4, (3000,)).astype(np.float64) for _ in range(n)],
        "blocks": [[rng.integers(0, 5, (3,)).astype(np.int64) for _ in range(n)]
                   for _ in range(n)],
    }


def _noncomm(mod):
    return mod.create_op(lambda a, b: a * 2 + b, commute=False)


# each case: prog(ctx, ops, wrap, inp) with wrap turning a numpy input into
# the kind under test (identity for numpy, torch.from_numpy for tensors)
def _c(fn, **vars_):
    return fn, vars_


CASES = {
    "bcast": _c(lambda c, o, w, d: c.bcast(w(d["v"][1]) if c.rank == 1 else None, root=1)),
    "bcast_pipeline": _c(lambda c, o, w, d: c.bcast(
        w(d["big"][0]) if c.rank == 0 else None, algorithm="pipeline"),
        host_coll_segment=4096),
    "reduce_sum": _c(lambda c, o, w, d: c.reduce(w(d["v"][c.rank]), o.SUM, root=c.size - 1)),
    "reduce_noncomm": _c(lambda c, o, w, d: c.reduce(w(d["v"][c.rank]), _noncomm(o), root=1)),
    "reduce_pipeline": _c(lambda c, o, w, d: c.reduce(
        w(d["big"][c.rank]), o.SUM, root=1, algorithm="pipeline"), host_coll_segment=2048),
    "reduce_blocks": _c(lambda c, o, w, d: c.reduce(
        [w(b) for b in d["blocks"][c.rank]], o.MAX, root=0)),
    "allreduce_sum": _c(lambda c, o, w, d: c.allreduce(w(d["v"][c.rank]), o.SUM)),
    "allreduce_max_int": _c(lambda c, o, w, d: c.allreduce(w(d["i"][c.rank]), o.MAX)),
    "allreduce_noncomm": _c(lambda c, o, w, d: c.allreduce(w(d["v"][c.rank]), _noncomm(o))),
    "allreduce_ring": _c(lambda c, o, w, d: c.allreduce(w(d["big"][c.rank]), o.SUM),
                         host_coll_large_msg=1024),
    "allreduce_ring_prod": _c(lambda c, o, w, d: c.allreduce(
        w(np.sign(d["big"][c.rank]) + 1), o.PROD), host_coll_large_msg=1024),
    "allreduce_scalar": _c(lambda c, o, w, d: c.allreduce(c.rank + 1, o.SUM)),
    "allgather": _c(lambda c, o, w, d: c.allgather(w(d["i"][c.rank]))),
    "gather": _c(lambda c, o, w, d: c.gather(w(d["i"][c.rank]), root=2)),
    "scatter": _c(lambda c, o, w, d: c.scatter(
        [w(x) for x in d["i"]] if c.rank == 0 else None, root=0)),
    "alltoall": _c(lambda c, o, w, d: c.alltoall([w(b) for b in d["blocks"][c.rank]])),
    "alltoall_bruck": _c(lambda c, o, w, d: c.alltoall([w(b) for b in d["blocks"][c.rank]]),
                         rules="alltoall 0 0 bruck\n"),
    "gatherv": _c(lambda c, o, w, d: c.gatherv(w(d["v"][c.rank][: c.rank + 1]), root=0)),
    "scatterv": _c(lambda c, o, w, d: c.scatterv(
        w(d["big"][0][:20]) if c.rank == 1 else None,
        list(range(1, c.size + 1)) if c.rank == 1 else None, root=1)),
    "allgatherv": _c(lambda c, o, w, d: c.allgatherv(w(d["v"][c.rank][: c.rank + 2]))),
    "alltoallv": _c(lambda c, o, w, d: c.alltoallv(
        w(d["big"][c.rank][:30]), [r + 1 for r in range(c.size)])),
    "scan": _c(lambda c, o, w, d: c.scan(w(d["v"][c.rank]), o.SUM)),
    "scan_noncomm": _c(lambda c, o, w, d: c.scan(w(d["v"][c.rank]), _noncomm(o))),
    "exscan": _c(lambda c, o, w, d: c.exscan(w(d["i"][c.rank]), o.SUM)),
    "reduce_scatter": _c(lambda c, o, w, d: c.reduce_scatter(
        [w(b) for b in d["blocks"][c.rank]], o.SUM)),
    "ibarrier": _c(lambda c, o, w, d: c.ibarrier().wait(10.0)),
    "ibcast": _c(lambda c, o, w, d: c.ibcast(w(d["v"][2]) if c.rank == 2 else None,
                                               root=2).wait(10.0)),
    "iallreduce": _c(lambda c, o, w, d: c.iallreduce(w(d["v"][c.rank]), o.SUM).wait(10.0)),
    "iallreduce_noncomm": _c(lambda c, o, w, d: c.iallreduce(
        w(d["v"][c.rank]), _noncomm(o)).wait(10.0)),
    "iallgather": _c(lambda c, o, w, d: c.iallgather(w(d["i"][c.rank])).wait(10.0)),
    "ialltoall": _c(lambda c, o, w, d: c.ialltoall(
        [w(b) for b in d["blocks"][c.rank]]).wait(10.0)),
    "ireduce": _c(lambda c, o, w, d: c.ireduce(w(d["v"][c.rank]), o.SUM, root=1).wait(10.0)),
    "ireduce_noncomm": _c(lambda c, o, w, d: c.ireduce(
        w(d["v"][c.rank]), _noncomm(o), root=0).wait(10.0)),
    "igather": _c(lambda c, o, w, d: c.igather(w(d["i"][c.rank]), root=1).wait(10.0)),
    "iscatter": _c(lambda c, o, w, d: c.iscatter(
        [w(x) for x in d["i"]] if c.rank == 2 else None, root=2).wait(10.0)),
    "iallgatherv": _c(lambda c, o, w, d: c.iallgatherv(w(d["v"][c.rank][: c.rank + 1])).wait(10.0)),
    "ialltoallv": _c(lambda c, o, w, d: c.ialltoallv(
        w(d["big"][c.rank][:30]), [c.size - r for r in range(c.size)]).wait(10.0)),
    "igatherv": _c(lambda c, o, w, d: c.igatherv(w(d["i"][c.rank][: c.rank + 1]), root=0).wait(10.0)),
    "iscatterv": _c(lambda c, o, w, d: c.iscatterv(
        w(d["big"][1][:12]) if c.rank == 0 else None,
        [1] * (c.size - 1) + [12 - (c.size - 1)] if c.rank == 0 else None,
        root=0).wait(10.0)),
    "iscan": _c(lambda c, o, w, d: c.iscan(w(d["i"][c.rank]), o.SUM).wait(10.0)),
    "iexscan": _c(lambda c, o, w, d: c.iexscan(w(d["v"][c.rank]), _noncomm(o)).wait(10.0)),
    "ireduce_scatter": _c(lambda c, o, w, d: c.ireduce_scatter(
        [w(b) for b in d["blocks"][c.rank]], o.SUM).wait(10.0)),
    "neighbor": _c(lambda c, o, w, d: (
        c.neighbor_allgather(w(d["i"][c.rank]), [(c.rank - 1) % c.size],
                             [(c.rank + 1) % c.size]),
        c.ineighbor_alltoall([w(d["i"][c.rank]), w(d["v"][c.rank])],
                             [(c.rank + 1) % c.size, (c.rank - 1) % c.size],
                             [(c.rank - 1) % c.size, (c.rank + 1) % c.size]).wait(10.0))),
}
REDUCING = {"reduce_sum", "reduce_noncomm", "reduce_pipeline", "reduce_blocks",
            "allreduce_sum", "allreduce_max_int", "allreduce_noncomm",
            "allreduce_ring", "allreduce_ring_prod", "allreduce_scalar", "scan",
            "scan_noncomm", "exscan", "reduce_scatter", "iallreduce",
            "iallreduce_noncomm", "ireduce", "ireduce_noncomm", "iscan", "iexscan",
            "ireduce_scatter"}


@contextlib.contextmanager
def _vars(tmp_path, **settings):
    """Set MCA vars in both packages' registries (``rules``: a rules table
    both read through ``coll_tuned_dynamic_rules``)."""
    settings = dict(settings)
    if "rules" in settings:
        path = tmp_path / "rules.txt"
        path.write_text(settings.pop("rules"))
        settings["coll_tuned_dynamic_rules"] = str(path)
    saved = []
    for name, value in settings.items():
        for reg in (tvar, jvar):
            saved.append((reg, name, reg.get(name)))
            reg.set_var(name, value)
    try:
        yield
    finally:
        for reg, name, value in reversed(saved):
            reg.set_var(name, value)


def _plain(x):
    """A result as nested Python lists/numbers, with its array kind noted."""
    if isinstance(x, torch.Tensor):
        return ("array", x.tolist())
    if isinstance(x, np.ndarray):
        return ("array", x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, bytes):
        return ("bytes", len(x))
    return x


def _run(universe, n, prog, timeout=60.0):
    uni = universe(n)
    try:
        return uni.run(prog, timeout=timeout)
    finally:
        if hasattr(uni, "close"):
            uni.close()


def _kinds(x, acc):
    if isinstance(x, (list, tuple)):
        for v in x:
            _kinds(v, acc)
    elif x is not None:
        acc.add(type(x).__name__ if not isinstance(x, np.generic) else "npscalar")
    return acc


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_matches_namesake(case, n, tmp_path):
    fn, settings = CASES[case]
    d = _inputs(n)
    with _vars(tmp_path, **settings):
        ref = _run(JUniverse, n, lambda c: fn(c, jops, lambda a: a, d))
        port_np = _run(TUniverse, n, lambda c: fn(c, tops, lambda a: a, d))
        port_t = _run(TUniverse, n, lambda c: fn(c, tops, torch.from_numpy, d))
    assert _plain(port_np) == _plain(ref)
    assert _plain(port_t) == _plain(ref)
    if case in REDUCING and case != "allreduce_scalar":
        # the caller's kind comes back: numpy for numpy, tensors for tensors
        assert _kinds(port_np, set()) <= {"ndarray", "npscalar"}, case
        assert _kinds(port_t, set()) == {"Tensor"}, case
    if case == "allreduce_scalar":
        assert all(type(v) is int for v in port_np)


def test_pipelined_bcast_returns_tensors_at_non_roots(tmp_path):
    d = _inputs(3)
    with _vars(tmp_path, host_coll_segment=1000):
        res = _run(TUniverse, 3, lambda c: c.bcast(
            d["big"][0] if c.rank == 0 else None, algorithm="pipeline"))
    assert isinstance(res[0], np.ndarray)
    assert all(isinstance(r, torch.Tensor) for r in res[1:])
    assert all(np.array_equal(np.asarray(r), d["big"][0]) for r in res)


def test_ring_allreduce_of_tensor_keeps_dtype_and_shape(tmp_path, monkeypatch):
    calls = []
    ring = thost._allreduce_ring
    monkeypatch.setattr(thost, "_allreduce_ring",
                        lambda *a: calls.append(1) or ring(*a))
    with _vars(tmp_path, host_coll_large_msg=256):
        res = _run(TUniverse, 4, lambda c: c.allreduce(
            torch.full((16, 33), c.rank + 1, dtype=torch.int32), tops.SUM))
    assert len(calls) == 4  # every rank took the ring
    for r in res:
        assert r.dtype == torch.int32 and r.shape == (16, 33)
        assert bool((r == 10).all())


def test_minloc_pairs_combine_whole():
    res = _run(TUniverse, 3, lambda c: c.allreduce(
        (torch.tensor([3.0 - c.rank, 1.0 + c.rank]), torch.tensor([c.rank, c.rank])),
        tops.MINLOC))
    for vals, idx in res:
        assert vals.tolist() == [1.0, 1.0] and idx.tolist() == [2, 0]


@pytest.mark.parametrize("a,b", [(np.float64(1.5), np.float64(2.5)),
                                 (1.5, 2.5), (3, 4), (np.int32(3), np.int32(4)),
                                 (np.complex128(1 + 2j), np.complex128(3j)),
                                 (True, False)])
def test_scalar_partials_cross_the_wire_as_the_namesakes(a, b):
    """A scalar reduction's partial result is a numpy scalar, as the
    namesake's ufunc gives, so it crosses the wire in the same dss record
    (10 bytes for a float64, where a 0-d tensor took 16); the value and
    its dtype are the namesake's."""
    from zhpe_ompi_tpu.coll import host as jhost
    from zhpe_ompi_tpu.utils import dss as jdss
    from zhpe_ompi_tpu_torch.utils import dss as tdss

    names = ("LOR", "LAND") if isinstance(a, bool) else \
        ("SUM", "PROD") if isinstance(a, (complex, np.complexfloating)) \
        else ("SUM", "MAX")
    for jop, top in ((getattr(jops, n), getattr(tops, n)) for n in names):
        want = jhost._combine(jop, a, b)
        got = thost._combine(top, a, b)
        assert isinstance(got, np.generic) and got.dtype == np.asarray(want).dtype
        assert got == want
        assert len(tdss.pack(got)) == len(jdss.pack(want))


def test_han_seam(tmp_path):
    """A thread universe is one locality group: a forced han (``on``, or a
    ``han`` rules line) runs the flat algorithm and counts the fallback on
    every rank, in both packages alike; ``auto`` and ``off`` count none."""
    from zhpe_ompi_tpu.runtime import spc as jspc
    from zhpe_ompi_tpu_torch.runtime import spc as tspc

    def fallbacks(universe, ops_mod, spc_mod):
        before = spc_mod.read("han_flat_fallbacks")
        uni = universe(4)
        try:
            out = uni.run(lambda c: (c.allreduce(c.rank, ops_mod.SUM),
                                     c.bcast("b" if c.rank == 2 else None, root=2)),
                          timeout=30.0)
        finally:
            if hasattr(uni, "close"):
                uni.close()
        assert out == [(6, "b")] * 4
        return spc_mod.read("han_flat_fallbacks") - before

    both = ((TUniverse, tops, tspc), (JUniverse, jops, jspc))
    with _vars(tmp_path, coll_han_enable="on"):
        assert [fallbacks(*b) for b in both] == [8, 8]  # allreduce + bcast, 4 ranks
    with _vars(tmp_path, rules="allreduce 0 0 han\n"):
        assert [fallbacks(*b) for b in both] == [4, 4]  # the rule names allreduce only
    with _vars(tmp_path, coll_han_enable="off"):
        assert [fallbacks(*b) for b in both] == [0, 0]
    assert [fallbacks(*b) for b in both] == [0, 0]


def test_topology_key_and_store_rung(tmp_path, monkeypatch):
    from zhpe_ompi_tpu_torch.coll import han as than

    uni = TUniverse(4)
    try:
        assert than.topology_key(uni.contexts[0]) == (1, 1, 4)

        class Wire:
            size, rank = 3, 0

            def boot_token_of(self, r):
                return None

        assert than.topology_key(Wire()) == (3, 3, 1)
        with _vars(tmp_path, coll_tuned_topology="2:2:2"):
            assert than.topology_key(Wire()) == (2, 2, 2)
    finally:
        uni.close()
    # the store rung under ZMPI_PMIX: a table published into a PMIx store
    # routes the host plane's allreduce in both packages (a flat algorithm
    # named by a rule; its answer unchanged), and an unreachable store
    # degrades to the builtin decision without raising
    from zhpe_ompi_tpu.coll import ztable as jztable
    from zhpe_ompi_tpu_torch.coll import ztable as tztable
    from zhpe_ompi_tpu_torch.runtime import pmix as tpmix

    def routed(U, ops):
        uni = U(4)
        try:
            return uni.run(lambda c: (c.allreduce(np.arange(4) * (c.rank + 1),
                                                  ops.SUM).tolist(),
                                      thost._rule_alg(c, "allreduce")
                                      if U is TUniverse else None))
        finally:
            if hasattr(uni, "close"):
                uni.close()

    srv = tpmix.PmixServer()
    try:
        tpmix.publish_tuned_table(srv.store, "allreduce 0 0 ring\n")
        for env, want in ((f"127.0.0.1:{srv.address[1]}/job", "ring"),
                          ("127.0.0.1:1/job", None)):
            monkeypatch.setenv("ZMPI_PMIX", env)
            for zt in (jztable, tztable):
                zt.invalidate_cache()
            port = routed(TUniverse, tops)
            ref = routed(JUniverse, jops)
            assert [p[0] for p in port] == [r[0] for r in ref] == \
                [[0, 10, 20, 30]] * 4
            assert {p[1] for p in port} == {want}, (env, port)
        srv.store.destroy_ns(tpmix.ZTUNE_NS)
    finally:
        srv.close()
        for zt in (jztable, tztable):
            zt.invalidate_cache()


class _Bridge(tinter.InterCollectives):
    """A thread-plane intercomm: two universes' contexts, ``send``/``recv``
    addressing the remote group through a shared mailbox universe."""

    def __init__(self, ctx, bridge_ctx, offset, remote_offset, remote_size):
        self._ctx = ctx
        self.rank, self.size = ctx.rank, ctx.size
        self.remote_size = remote_size
        self._b, self._off, self._roff = bridge_ctx, offset, remote_offset

    def send(self, obj, dest, tag=0):
        self._b.send(obj, self._roff + dest, tag=tag, cid=5)

    def recv(self, source=-1, tag=-1):
        src = source if source < 0 else self._roff + source
        return self._b.recv(src, tag=tag, cid=5, timeout=10.0)


def test_intercomm_collectives_over_two_thread_groups():
    a, b, br = TUniverse(2), TUniverse(3), TUniverse(5)
    try:
        eps = [_Bridge(a.contexts[r], br.contexts[r], 0, 2, 3) for r in range(2)] + \
              [_Bridge(b.contexts[r], br.contexts[2 + r], 2, 0, 2) for r in range(3)]
        import threading

        out = [None] * 5

        def go(i):
            ep = eps[i]
            out[i] = (ep.allreduce(torch.tensor([float(i + 1)]), tops.SUM).tolist(),
                      sorted(ep.allgather(i)))

        ts = [threading.Thread(target=go, args=(i,)) for i in range(5)]
        [t.start() for t in ts]
        [t.join(30.0) for t in ts]
        assert all(o is not None for o in out), out
        assert [o[0] for o in out] == [[12.0]] * 2 + [[3.0]] * 3
        assert [o[1] for o in out] == [[2, 3, 4]] * 2 + [[0, 1]] * 3
    finally:
        for u in (a, b, br):
            u.close()
