"""The port's host-plane PGAS layer (``shmem/api.py``: ``ShmemPE``,
``shmem_universe``, ``shmem_mapped_pe``, ``shmem_wire_pe``;
``shmem/segment.py``: ``MappedSegment``, ``MmapBackend``; the spml's
``direct``, ``mmap`` and ``am`` rungs), held against the JAX package's.

One PE program (seeded numpy inputs) runs on each substrate of each
package and the results compare equal, exactly (int64, int32, float64):
symmetric allocation offsets, put/get/p/g, strided iput/iget,
put_nbi/get_nbi completed at quiet, the AMO set (add, fetch-add, inc,
swap, compare-swap, fetch, set), wait_until, the distributed lock, and
the collectives (broadcast, fcollect, collect, the reductions,
alltoall).

- ``direct``: a 4-PE thread universe (``shmem_universe``, and
  ``shmem_pe`` on a thread rank picks ``direct``);
- ``mmap``: 4 same-host ``TcpProc`` ranks (``shmem_pe`` picks ``mmap``);
- ``am``: 4 ``TcpProc`` ranks with sm on (``shmem_wire_pe``: the arena is
  an sm RMA region, so the dyn family rides ``osc/direct``) and with sm
  off (active messages only).

Mixed jobs (ranks 0 and 2 the port's, 1 and 3 the JAX package's) share
one mapped heap and one wire heap: every PE's AMOs on PE 0's counter are
exact with both packages on the native atomics, and the port's PE and the
namesake's read the same bytes.  The port's PEs take tensors as values
and ``get(out=tensor)``.
"""

from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu.pt2pt.tcp import TcpProc as JTcpProc
from zhpe_ompi_tpu.shmem import api as japi
from zhpe_ompi_tpu.shmem import spml as jspml
from zhpe_ompi_tpu_torch.pt2pt import sm as tsm
from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc
from zhpe_ompi_tpu_torch.runtime import spc
from zhpe_ompi_tpu_torch.shmem import api as tapi
from zhpe_ompi_tpu_torch.shmem import spml as tspml

from _torch_dist_worker import run_tcp_threads
from test_torch_osc import _data, _equal

JAX = NS(name="jax", api=japi, spml=jspml, Proc=JTcpProc)
PORT = NS(name="port", api=tapi, spml=tspml, Proc=TcpProc)
N = 4
MIXED = [TcpProc, JTcpProc, TcpProc, JTcpProc]


@pytest.fixture(scope="module", autouse=True)
def _heap_hygiene():
    yield
    assert tsm.orphaned_ring_files() == []


def _ns(p):
    return PORT if isinstance(p, TcpProc) else JAX


def pe_program(pe):
    """The PE program every substrate runs; returns what it saw."""
    me, n = pe.my_pe(), pe.n_pes()
    a = pe.shmalloc(8, np.int64)
    b = pe.shmalloc((2, 4), np.float64)
    c = pe.shmalloc(1, np.int64)
    lk = pe.shmalloc(1, np.int64)
    src = pe.shmalloc(4, np.int32)
    dst = pe.shmalloc(4 * n, np.int32)
    tot = pe.shmalloc(4, np.int32)
    pe.local(a)[...] = 0
    pe.local(c)[...] = 0
    pe.local(src)[...] = _data(me, 4, np.int32)
    pe.barrier_all()
    pe.put(b, _data(me, 8, np.float64).reshape(2, 4), (me + 1) % n)
    pe.p(a, me * 10 + 1, (me + 2) % n, index=4 + me)
    pe.iput(a, np.arange(2, dtype=np.int64) + 100 * me, (me + 1) % n,
            tst=2, sst=1)
    pe.barrier_all()
    got_b = pe.get(b, (me + 3) % n)
    got_g = pe.g(a, (me + 2) % n, index=me)
    strided = pe.iget(a, (me + 1) % n, 2, sst=2)
    target = np.zeros(8, np.int64)
    pe.get_nbi(a, (me + 3) % n, target)
    pe.quiet()
    pe.barrier_all()
    # the fetch-adds interleave across PEs: each PE sees distinct olds
    olds = [pe.atomic_fetch_add(c, 2, 0) for _ in range(5)]
    pe.atomic_inc(c, 0)
    pe.atomic_add(c, 3, 0)
    pe.barrier_all()
    counter = pe.atomic_fetch(c, 0)
    pe.barrier_all()
    if me == 0:
        swapped = pe.atomic_swap(c, 7, 0)
        cas_hit = pe.atomic_compare_swap(c, 7, 9, 0)
        cas_miss = pe.atomic_compare_swap(c, 7, 11, 0)
        pe.atomic_set(c, 42, 0)
    pe.barrier_all()
    final = pe.atomic_fetch(c, 0)
    pe.barrier_all()
    for _ in range(3):
        pe.set_lock(lk)
        v = pe.g(c, 0)
        pe.p(c, v + 1, 0)
        pe.quiet()
        pe.clear_lock(lk)
    pe.barrier_all()
    locked = pe.g(c, 0)
    if me == 1:
        pe.p(a, 5, 0, index=7)
        pe.quiet()
    if me == 0:
        pe.wait_until(a, "eq", 5, index=7)
    pe.barrier_all()
    pe.broadcast(src, root=2)
    pe.fcollect(dst, src)
    pe.sum_to_all(tot, src)
    pe.max_to_all(tot, src)
    pe.barrier_all()
    out = dict(offsets=[s.offset for s in (a, b, c, lk, src, dst, tot)],
               got_b=got_b, got_g=got_g, strided=strided, nbi=target,
               olds=len({int(x) for x in olds}), counter=int(counter),
               final=int(final), locked=int(locked),
               a=pe.local(a).copy(), src=pe.local(src).copy(),
               dst=pe.local(dst).copy(), tot=pe.local(tot).copy())
    if me == 0:
        out.update(swapped=int(swapped), hit=int(cas_hit),
                   miss=int(cas_miss))
    pe.barrier_all()
    pe.shfree(dst)
    return out


def _check(res):
    assert res[0]["counter"] == N * (5 * 2 + 1 + 3)
    assert res[0]["final"] == 42 and res[0]["locked"] == 42 + 3 * N
    assert (res[0]["swapped"], res[0]["hit"], res[0]["miss"]) == \
        (N * 14, 7, 9)


def _thread(P, heap=1 << 14):
    uni, pes = P.api.shmem_universe(N, heap_bytes=heap)
    try:
        return uni.run(lambda ctx: pe_program(pes[ctx.rank]), timeout=60.0)
    finally:
        getattr(uni, "close", lambda: None)()


def test_direct_substrate_thread_universe():
    jres, tres = _thread(JAX), _thread(PORT)
    _equal(jres, tres)
    _check(tres)


def _wire(kinds, make, **kw):
    def prog(p):
        pe = make(_ns(p), p)
        try:
            return pe_program(pe)
        finally:
            pe.finalize()

    return run_tcp_threads(len(kinds), prog, kinds=kinds, **kw)


SUBSTRATES = {
    "mmap": (lambda P, p: P.spml.shmem_pe(p, heap_bytes=1 << 14),
             dict(sm=True, sm_boot_id="shmemboot")),
    "am_direct": (lambda P, p: P.api.shmem_wire_pe(p, heap_bytes=1 << 14),
                  dict(sm=True, sm_boot_id="shmemboot")),
    "am_wire": (lambda P, p: P.api.shmem_wire_pe(p, heap_bytes=1 << 14),
                dict(sm=False)),
}


@pytest.mark.parametrize("substrate", list(SUBSTRATES))
def test_wire_substrates_match_the_namesake(substrate):
    make, kw = SUBSTRATES[substrate]
    jres = _wire([JTcpProc] * N, make, **kw)
    d0 = spc.read("osc_direct_bytes")
    tres = _wire([TcpProc] * N, make, **kw)
    moved = spc.read("osc_direct_bytes") - d0
    _equal(jres, tres)
    _check(tres)
    assert (moved > 0) == (substrate == "am_direct")


@pytest.mark.parametrize("substrate", ["mmap", "am_direct"])
def test_mixed_job_shares_one_heap(substrate):
    """Two port PEs and two JAX-package PEs on one heap: PE 0's counter
    (a port PE's heap) takes all four PEs' AMOs through one domain."""
    make, kw = SUBSTRATES[substrate]
    base = _thread(JAX)
    mixed = _wire(MIXED, make, **kw)
    _equal(base, mixed)
    _check(mixed)


def test_spml_picks_the_host_rungs():
    def prog(p):
        P = _ns(p)
        comp = P.spml.select_spml(p)
        pe = P.spml.shmem_pe(p, heap_bytes=4096)
        name = type(pe._backend).__name__
        pe.finalize()
        return comp.name, name

    res = run_tcp_threads(2, prog, kinds=[TcpProc, TcpProc], sm=True,
                          sm_boot_id="onehost")
    assert res == [("mmap", "MmapBackend")] * 2
    from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse

    uni = LocalUniverse(2)
    try:
        got = uni.run(lambda ctx: (tspml.select_spml(ctx).name,
                                   type(tspml.shmem_pe(ctx, 4096)).__name__))
    finally:
        uni.close()
    assert got == [("direct", "ShmemPE")] * 2
    assert tspml.AmSpml().supports(object()) is False


def test_port_pe_takes_tensors():
    uni, pes = tapi.shmem_universe(2, heap_bytes=4096)

    def prog(ctx):
        pe = pes[ctx.rank]
        x = pe.shmalloc(4, np.float32)
        pe.local(x)[...] = 0
        pe.barrier_all()
        pe.put(x, torch.arange(4, dtype=torch.float32) + ctx.rank, 1 - ctx.rank)
        pe.barrier_all()
        pe.atomic_add(x, torch.tensor(2.0), 0, index=3)
        pe.barrier_all()
        out = torch.zeros(4)
        assert pe.get(x, ctx.rank, out=out) is out
        pe.barrier_all()
        return out.tolist()

    try:
        res = uni.run(prog)
    finally:
        uni.close()
    assert res == [[1.0, 2.0, 3.0, 8.0], [0.0, 1.0, 2.0, 3.0]]
