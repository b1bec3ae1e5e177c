"""The port's direct-map one-sided plane (``osc/direct.py``), its sm RMA
regions (``pt2pt/sm.py``: ``RmaMapping``, ``RmaRegion``,
``SmSegment.alloc_rma_region``), the ``TcpProc`` seams
(``sm_rma_region``, ``sm_release_region``, ``sm_direct_to``) and the
shared-mapping atomics (``native/zompi_native.cpp``), held against the JAX
package's.

- The region header is the namesake's byte for byte: a region created by
  either package reads back with the other's geometry, and two fresh
  regions of the same shape have identical header bytes.
- Both packages take one atomicity domain on the default (native)
  switches: the port's AMO library loads, a JAX-package origin and a
  port origin lock and CAS the same word of one region, and
  ``recover_dead`` of either package frees a lock the other took.
  ``ZOMPI_NATIVE=0`` selects the flock domain on purpose, and a failed
  build raises.
- ``same(prog)``: a 4-rank ``TcpProc`` universe (sm on, one boot id) of
  each package runs put/get/accumulate/get_accumulate/compare_and_swap,
  exclusive passive target, ``StageHandoff`` doorbell epochs over
  ``pipeline_schedule``, ``window_bcast`` and the symmetric-heap dyn
  family; the results compare equal, and every op rides the direct path
  (``osc_direct_*`` rise, ``osc_am_fallbacks`` does not).
- Mixed jobs (ranks 0 and 2 the port's, 1 and 3 the JAX package's): a
  JAX-package origin on a port-owned region and the reverse, atomics and
  locks from all four ranks on each region, exact; ``osc_direct=0`` (the
  forced-AM mode) gives the same bytes with no direct traffic.
"""

import os
from types import SimpleNamespace as NS

import numpy as np
import pytest

from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu.osc import direct as jdirect
from zhpe_ompi_tpu.pt2pt import sm as jsm
from zhpe_ompi_tpu.pt2pt.tcp import TcpProc as JTcpProc
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu_torch import native as tnative
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.osc import direct as tdirect
from zhpe_ompi_tpu_torch.pt2pt import sm as tsm
from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc
from zhpe_ompi_tpu_torch.runtime import spc

from _torch_dist_worker import run_tcp_threads
from test_torch_osc import _data, _equal

JAX = NS(name="jax", direct=jdirect, ops=jops, Proc=JTcpProc, spc=jspc,
         sm=jsm)
PORT = NS(name="port", direct=tdirect, ops=tops, Proc=TcpProc, spc=spc,
          sm=tsm)
N = 4
MIXED = [TcpProc, JTcpProc, TcpProc, JTcpProc]
DIRECT = ("osc_direct_puts", "osc_direct_gets", "osc_direct_atomics",
          "osc_direct_bytes", "osc_am_fallbacks", "osc_doorbell_posts",
          "osc_doorbell_completes")


@pytest.fixture(scope="module", autouse=True)
def _region_hygiene():
    yield
    assert tsm.orphaned_ring_files() == []
    assert tsm.live_poll_threads() == []


def _ns(p):
    return PORT if isinstance(p, TcpProc) else JAX


def run(kinds, prog, boot="directboot", **kw):
    return run_tcp_threads(len(kinds), lambda p: prog(_ns(p), p),
                           kinds=kinds, sm=True, sm_boot_id=boot, **kw)


def counters(P):
    return {k: P.spc.read(k) for k in DIRECT}


def same(prog):
    out = []
    for P in (JAX, PORT):
        c0 = counters(P)
        res = run([P.Proc] * N, prog)
        c1 = counters(P)
        out.append((res, {k: c1[k] - c0[k] for k in DIRECT}))
    (jres, jd), (tres, td) = out
    for a, b in zip(jres, tres):
        _equal(a, b)
    assert jd == td, (jd, td)
    return tres, td


# -- the region and its atomicity domain -------------------------------


def test_region_header_is_the_namesakes_byte_for_byte():
    tseg = tsm.SmSegment(1, 3, on_frame=lambda *a: None)
    jseg = jsm.SmSegment(1, 3, on_frame=lambda *a: None)
    try:
        treg, jreg = tseg.alloc_rma_region(5000), jseg.alloc_rma_region(5000)
        assert treg.name.endswith(".w0") and os.path.exists(treg.path)
        for path in (treg.path, jreg.path):
            tm, jm = tsm.RmaMapping(path, 2), jsm.RmaMapping(path, 2)
            try:
                got = [(m.owner_rank, m.nprocs, m.data_len, m.data_off)
                       for m in (tm, jm)]
                assert got == [(1, 3, 5000, 4096)] * 2
            finally:
                tm.close()
                jm.close()
        with open(treg.path, "rb") as f:
            theader = f.read(4096)
        with open(jreg.path, "rb") as f:
            jheader = f.read(4096)
        assert theader == jheader
        assert tsm._rma_hdr_len(3) == jsm._rma_hdr_len(3) == 4096
        tseg.release_rma_region(treg)
        assert not os.path.exists(treg.path)
    finally:
        tseg.close()
        jseg.close()


def test_one_atomicity_domain_with_the_jax_package():
    """Port and JAX mappings of one region take the same native word:
    exclusive locks exclude each other, shared ones coexist, and
    recover_dead of either package frees the other's dead holder."""
    assert tnative.load() is not None and jsm._native_amo() is not None
    seg = tsm.SmSegment(0, 4, on_frame=lambda *a: None)
    try:
        reg = seg.alloc_rma_region(64)
        tm, jm = tsm.RmaMapping(reg.path, 1), jsm.RmaMapping(reg.path, 2)
        assert tm._use_native and jm._use_native and reg._use_native
        jm.lock(2, exclusive=True)
        with pytest.raises(terrors.InternalError, match="timed out"):
            tm.lock(1, exclusive=False, timeout=0.2)
        assert tm.holder_state(2) == tsm._LK_EXCL
        # the JAX origin "died" holding it: the port recovers its words
        assert tm.recover_dead(2)
        tm.lock(1, exclusive=False)
        jm.lock(3, exclusive=False)
        assert reg._ld(tsm._RH_READERS) == 2
        tm.unlock(1)
        jm.unlock(3)
        tm.lock(1, exclusive=True)
        assert jm.recover_dead(1) and jm.holder_state(1) == jsm._LK_NONE
        # the region lock word itself: a word the JAX side holds is the
        # port's too (its CAS fails), and recovery frees it
        with jm.atomic():
            assert tm._amo32(tsm._RH_MUTEX, tsm._AMO_CAS, value=2,
                             compare=0) != 0
        with tm.atomic():
            pass
        tm.close()
        jm.close()
        seg.release_rma_region(reg)
    finally:
        seg.close()


@pytest.fixture
def amo_switches(monkeypatch):
    """Each case reads the switches afresh (``native.reset``); the
    default load decision is restored after."""
    monkeypatch.delenv("ZOMPI_NATIVE", raising=False)
    tnative.reset()
    yield monkeypatch
    monkeypatch.undo()
    tvar.unset("native_kernels")
    tnative.reset()


@pytest.mark.parametrize("switch", ["env", "var"])
def test_flock_domain_is_a_switch(amo_switches, switch):
    if switch == "env":
        amo_switches.setenv("ZOMPI_NATIVE", "0")
    else:
        tvar.set_var("native_kernels", 0)
    assert tnative.load() is None
    assert tnative.disabled_by == {"env": "ZOMPI_NATIVE=0",
                                   "var": "MCA var native_kernels"}[switch]
    seg = tsm.SmSegment(0, 2, on_frame=lambda *a: None)
    try:
        reg = seg.alloc_rma_region(8)
        m = tsm.RmaMapping(reg.path, 1)
        assert not m._use_native and not reg._use_native
        with m.atomic():
            pass
        m.lock(1, True)
        with pytest.raises(terrors.InternalError, match="timed out"):
            reg.lock(0, False, timeout=0.2)
        assert reg.recover_dead(1)
        reg.lock(0, False)
        reg.unlock(0)
        m.close()
    finally:
        seg.close()


def test_a_failed_build_raises(amo_switches, tmp_path):
    bad = tmp_path / "shm_amo.cpp"
    bad.write_text("this is not C++\n")
    amo_switches.setattr(tnative, "_SRC", str(bad))
    amo_switches.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ rc"):
        tnative.load()
    assert tnative.lib is None


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16",
                                   "int32", "uint32", "int64", "uint64",
                                   "float32", "float64"])
def test_amo_library_matches_the_namesakes(dtype):
    """Every kind on every type code, the port's library against the
    namesake's, on words of one mapping (both sides see the other's
    stores: the same memory, the same results)."""
    import ctypes

    from zhpe_ompi_tpu import native as jnative

    jlib, tlib = jnative.load(), tnative.load()
    dt = np.dtype(dtype)
    code = tnative.TYPE_CODES[dtype]
    assert code == jnative.TYPE_CODES[dtype]
    buf = np.zeros(2, dt)
    vals = [5, 3, 7, 2] if dt.kind in "iu" else [1.5, -0.25, 2.0, 3.0]
    seen = []
    for lib, slot in ((jlib, 0), (tlib, 1)):
        addr = buf.ctypes.data + slot * dt.itemsize
        for kind, v, c in ((0, vals[0], 0), (0, vals[1], 0),
                           (2, vals[2], vals[0] + vals[1]), (2, 9, 0),
                           (1, vals[3], 0), (3, vals[0], 0), (4, 0, 0)):
            oi, of = ctypes.c_int64(0), ctypes.c_double(0.0)
            isint = dt.kind in "iu"
            rc = lib.zompi_shm_amo(
                ctypes.c_void_p(addr), code, kind,
                int(v) if isint else 0, int(c) if isint else 0,
                0.0 if isint else float(v), 0.0 if isint else float(c),
                ctypes.byref(oi), ctypes.byref(of))
            assert rc == 0
            seen.append(oi.value if isint else of.value)
    half = len(seen) // 2
    assert seen[:half] == seen[half:]
    assert buf[0] == buf[1]
    tlib.zompi_shm_fence()


# -- the window plane ----------------------------------------------------


def test_direct_window_ops_handoff_and_bcast():
    def prog(P, p):
        r, n = p.rank, p.size
        win = P.direct.allocate_window(p, 8 * n * 4, np.float32)
        assert win._direct_capable
        win.fence()
        win.put(_data(r, 8, np.float32), (r + 1) % n, 8 * r)
        win.fence()
        got = win.get((r + 1) % n, 8 * r, 8)
        win.accumulate(_data(r + 5, 8, np.float32), (r + 2) % n, 8 * r,
                       P.ops.MAX)
        old = win.get_accumulate(_data(r + 6, 8, np.float32), (r + 3) % n,
                                 8 * r, P.ops.SUM)
        win.fence()
        win.lock(0)
        v = win.get(0, 0, 1)
        win.put(v + 1.0, 0, 0)
        win.unlock(0)
        win.fence()
        cas = win.compare_and_swap(np.float32(-1.0), np.float32(12345.0),
                                   1, 0)
        win.fence()
        # doorbell epochs down the pipeline 0 -> 1 -> 2 -> 3
        sched = P.direct.pipeline_schedule(win, timeout=10.0)
        for epoch in range(3):
            if "up" in sched:
                sched["up"].post()
                sched["up"].wait()
                blk = sched["up"].recv(0, 4)
            else:
                blk = np.full(4, epoch, np.float32)
            if "down" in sched:
                sched["down"].start()
                sched["down"].put(blk + 1, 0)
                sched["down"].complete()
            p.barrier()
        last = win.get(r, 0, 4)
        bc = P.direct.window_bcast(
            win, _data(99, 24, np.float32) if r == 0 else None, root=0)
        win.fence()
        win.free()
        return got, old, cas, last, bc, all(
            h.direct for h in sched.values())

    res, delta = same(prog)
    assert all(x[5] for x in res)
    np.testing.assert_array_equal(res[3][4], _data(99, 24, np.float32))
    assert res[3][3].tolist() == [5.0] * 4  # 2 + three hops
    assert delta["osc_am_fallbacks"] == 0
    assert delta["osc_doorbell_posts"] == delta["osc_doorbell_completes"] \
        == 9
    assert delta["osc_direct_bytes"] > 3 * 24 * 4


def test_symmetric_heap_dyn_family_rides_the_direct_path():
    def prog(P, p):
        r, n = p.rank, p.size
        win = P.direct.create_dynamic_window(p)
        disp, arena = win.attach_symmetric(256)
        p.barrier()
        tgt = (r + 1) % n
        win.dyn_put(np.arange(4, dtype=np.int64) + 10 * r, tgt, disp)
        win.dyn_iput(np.array([r, r, r], np.int32), tgt, disp + 64, tst=2)
        p.barrier()
        raw = win.dyn_get((r + 2) % n, disp, 32)
        strided = win.dyn_iget((r + 3) % n, disp + 64, 3, np.int32, sst=2)
        nbi = win.dyn_get_nbi(tgt, disp, 8).wait()
        olds = [int(win.dyn_amo(0, disp + 128, "add", np.int64, value=3))
                for _ in range(4)]
        p.barrier()
        total = int(win.dyn_amo(0, disp + 128, "fetch", np.int64))
        p.barrier()
        win.free()
        return raw, strided, nbi, min(olds) >= 0, total

    res, delta = same(prog)
    assert res[0][4] == 48
    assert delta["osc_am_fallbacks"] == 0 and delta["osc_direct_atomics"] \
        == 4 * 4 + 4


@pytest.mark.parametrize("owner", ["port", "jax"])
def test_mixed_origins_on_one_region(owner):
    """A JAX-package origin on a port-owned region and the reverse: rank 0
    owns the window's counted words (a port rank, or a JAX rank when the
    kinds are swapped), and all four ranks hit them with direct atomics
    and exclusive locks of both packages."""
    kinds = MIXED if owner == "port" else MIXED[::-1]

    def prog(P, p):
        win = P.direct.allocate_window(p, 8 * 4, np.int64)
        win.fence()
        for _ in range(30):
            win.accumulate(np.array([1], np.int64), 0, 0, P.ops.SUM)
            win.fetch_and_op(np.int64(2), 0, 1)
            win.lock(0)
            v = win.get(0, 2, 1)
            win.put(v + 1, 0, 2)
            win.unlock(0)
        win.fence()
        out = win.get(0, 0, 4)
        mapped = win._direct(0) is not None
        native = win._direct(0).mapping._use_native
        win.fence()
        win.free()
        return out, mapped, native

    t0, j0 = spc.read("osc_direct_atomics"), jspc.read("osc_direct_atomics")
    f0, g0 = spc.read("osc_am_fallbacks"), jspc.read("osc_am_fallbacks")
    res = run(kinds, prog)
    for out, mapped, native in res:
        assert out.tolist() == [120, 240, 120, 0]
        assert mapped and native
    assert spc.read("osc_direct_atomics") - t0 >= 2 * 60
    assert jspc.read("osc_direct_atomics") - j0 >= 2 * 60
    assert spc.read("osc_am_fallbacks") == f0
    assert jspc.read("osc_am_fallbacks") == g0


@pytest.fixture
def both_vars():
    tvar.set_var("osc_direct", 0)
    jvar.set_var("osc_direct", 0)
    yield
    tvar.unset("osc_direct")
    jvar.unset("osc_direct")


def test_forced_am_mode_gives_the_same_bytes(both_vars):
    def prog(P, p):
        win = P.direct.allocate_window(p, 64 * 4, np.float32)
        assert not win._direct_capable
        bc = P.direct.window_bcast(
            win, _data(7, 64, np.float32) if p.rank == 0 else None, root=0)
        win.fence()
        win.free()
        return bc

    b0 = spc.read("osc_direct_bytes")
    a0 = jspc.read("osc_direct_bytes")
    res = run(MIXED, prog)
    for bc in res:
        np.testing.assert_array_equal(bc, _data(7, 64, np.float32))
    assert spc.read("osc_direct_bytes") == b0
    assert jspc.read("osc_direct_bytes") == a0


def test_tcp_seams_follow_the_transport_ladder():
    """``sm_direct_to`` is the two-sided seam's memoized ring decision:
    direct to itself, never across boot ids, and to a same-boot peer
    exactly when the ladder gave that peer a ring (which an overloaded
    peer's handshake may decline, loudly — the decision is compared, not
    assumed)."""
    def prog(P, p):
        region = p.sm_rma_region(128)
        p.alltoall([np.full(2, p.rank, np.int64)] * p.size)
        seams = [p.sm_direct_to(d) for d in range(p.size)]
        ladder = [d == p.rank or p._sm_tx(d) is not None
                  for d in range(p.size)]
        p.sm_release_region(region)
        return seams, os.path.exists(region.path), ladder

    res = run_tcp_threads(
        3, lambda p: prog(_ns(p), p), kinds=[TcpProc, JTcpProc, TcpProc],
        sm=True, kwargs_by_rank={2: {"sm_boot_id": "elsewhere"},
                                 0: {"sm_boot_id": "here"},
                                 1: {"sm_boot_id": "here"}})
    for seams, exists, ladder in res:
        assert seams == ladder and exists is False
    assert res[0][0][0] and res[1][0][1] and res[2][0][2]
    assert not (res[0][0][2] or res[1][0][2] or res[2][0][0]
                or res[2][0][1])
    off = run_tcp_threads(2, lambda p: p.sm_rma_region(8), sm=False)
    assert off == [None, None]
