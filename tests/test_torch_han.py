"""The port's hierarchical host collectives (``coll/han``) and locality
groups (``pt2pt/groups``), held against the flat algorithms and against
the JAX package's ``coll/han`` on the same numpy inputs.

- Locality groups: a thread universe is one group; over the wire the
  groups follow the boot ids the sm cards advertise (``sm_boot_id``
  pins emulate hosts); an ``sm=0`` rank is a singleton.
- ``GroupView``: relative ranks and status translation, a tag window
  disjoint from the parent's collectives, window sequences that survive
  view recreation.
- Every han op (allreduce small, segmented and pipelined; bcast and
  reduce from every root; barrier; allgather; reduce_scatter; alltoall
  with the pairwise and the Bruck leader exchange; alltoallv) at the
  2×2 and 3-2-1 groupings on thread universes: equal to the flat
  algorithm and to the namesake (integer-valued float64 data, exact in
  every combine order; random float32 data against the namesake's bits).
- The NUMA level (allreduce, bcast, barrier) at 1×2×2 and 2×2×2.
- The decision layer: ``auto`` flat on the thread plane, ``on`` over a
  degenerate topology falls back loudly (``han_flat_fallbacks``), ``off``
  never engages, a ``han`` rules line selects it, an explicit algorithm
  outranks it.
- The wire (``TcpProc`` universes in threads): all ops forced on at 2×2,
  han alltoall's ``tcp_bytes_sent`` below flat's at equal payload, the
  NUMA level through ``sm_numa_id`` pins, and ``moe_host_ffn`` on a 2×2
  universe against the JAX package's on the same inputs.
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.coll import han as jhan
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu.models import moe as jmoe
from zhpe_ompi_tpu.pt2pt.tcp import TcpProc as JTcpProc
from zhpe_ompi_tpu.pt2pt.universe import LocalUniverse as JUniverse
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.coll import han as than
from zhpe_ompi_tpu_torch.coll import host as thost
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.models import moe as tmoe
from zhpe_ompi_tpu_torch.pt2pt import groups as tgroups
from zhpe_ompi_tpu_torch.pt2pt import sm as tsm
from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc
from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse as TUniverse
from zhpe_ompi_tpu_torch.runtime import spc

from _torch_dist_worker import run_tcp_threads as run_wire

RANK_TIMEOUT = 20.0
GROUPS = {"2x2": [[0, 1], [2, 3]], "3-2-1": [[0, 1, 2], [3, 4], [5]]}
NESTS = {"1x2x2": [[[0, 1], [2, 3]]], "2x2x2": [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]}


@pytest.fixture(scope="module", autouse=True)
def _port_han_hygiene():
    yield
    assert tgroups.leaked_tag_windows() == []
    assert tgroups.live_election_threads() == []
    assert tsm.orphaned_ring_files() == []
    assert tsm.live_poll_threads() == []
    assert tsm.segment_audit_failures() == []


@pytest.fixture
def port_vars():
    """Snapshot/restore both packages' MCA registries around a test."""
    saved = [(reg, {v.name: (v._value, v._source) for v in reg.registry.all_vars()})
             for reg in (tvar, jvar)]
    yield tvar
    for reg, snap in saved:
        for v in reg.registry.all_vars():
            if v.name in snap:
                v._value, v._source = snap[v.name]


def _set(**settings):
    for reg in (tvar, jvar):
        for name, value in settings.items():
            reg.set_var(name, value)


def _run(universe, n, prog):
    uni = universe(n)
    try:
        return uni.run(prog, timeout=60.0)
    finally:
        if hasattr(uni, "close"):
            uni.close()


def boots_2x2():
    return {0: {"sm_boot_id": "hostaaaa"}, 1: {"sm_boot_id": "hostaaaa"},
            2: {"sm_boot_id": "hostbbbb"}, 3: {"sm_boot_id": "hostbbbb"}}


def _plain(x):
    """A result as nested Python values, arrays as ("array", dtype, bytes)
    so float results compare to the bit."""
    if isinstance(x, (torch.Tensor, np.ndarray, jnp.ndarray)):
        a = np.asarray(x)
        return ("array", a.dtype.str, a.shape, a.tobytes())
    if isinstance(x, np.generic):
        return _plain(np.asarray(x))
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# ------------------------------------------------------- locality groups


def test_thread_universe_is_one_group():
    for g in _run(TUniverse, 4, tgroups.locality_groups):
        assert g == [[0, 1, 2, 3]]

    class Bare:
        rank, size = 0, 3

    assert tgroups.locality_groups(Bare()) == [[0], [1], [2]]


def test_wire_groups_follow_boot_ids():
    interleaved = {0: {"sm_boot_id": "aaaa"}, 1: {"sm_boot_id": "bbbb"},
                   2: {"sm_boot_id": "aaaa"}, 3: {"sm_boot_id": "bbbb"}}
    for g in run_wire(4, tgroups.locality_groups, boots_2x2()):
        assert g == GROUPS["2x2"]
    for g in run_wire(4, tgroups.locality_groups, interleaved):
        assert g == [[0, 2], [1, 3]]


def test_sm_off_rank_is_a_singleton():
    kw = boots_2x2()
    kw[1] = {"sm": False}
    for g in run_wire(4, tgroups.locality_groups, kw):
        assert g == [[0], [1], [2, 3]]


# ------------------------------------------------------------- GroupView


def test_group_view_translation():
    def prog(ctx):
        if ctx.rank == 0:
            with pytest.raises(errors.ArgError):
                tgroups.GroupView(ctx, [1, 3], window=7)
            return None
        if ctx.rank not in (1, 3):
            return None
        view = tgroups.GroupView(ctx, [1, 3], window=7)
        assert view.size == 2 and view.parent_rank(view.rank) == ctx.rank
        if ctx.rank == 1:
            assert view.rank == 0
            view.send(("hi", 42), 1, tag=5)
            return view.recv(source=1, tag=6)
        got, status = view.recv(source=0, tag=5, return_status=True)
        assert status.source == 0  # the RELATIVE source
        view.send(got, 0, tag=6)
        return got

    res = _run(TUniverse, 4, prog)
    assert res[1] == res[3] == ("hi", 42)


def test_tag_windows_disjoint_and_sequences_kept():
    """han collectives interleaved with flat ones on the parent (same base
    tags, same sequence values: only the window cid separates them), and
    views rebuilt every round continue their window's sequence."""
    def prog(ctx):
        out = []
        for _ in range(3):
            than.invalidate(ctx)
            out.append(than.allreduce(ctx, ctx.rank + 1, tops.SUM, groups=GROUPS["2x2"]))
            out.append(thost.allreduce(ctx, ctx.rank + 1, tops.SUM))
        return out

    assert _run(TUniverse, 4, prog) == [[10] * 6] * 4


# ----------------------------------------------- every han op, both ways


def _inputs(n, seed=11):
    rng = np.random.default_rng(seed + n)
    return {
        "i": [rng.integers(-9, 10, (7,)).astype(np.float64) for _ in range(n)],
        "f": [rng.standard_normal(300).astype(np.float32) for _ in range(n)],
        "big": [rng.integers(-5, 6, (100,)).astype(np.float64) for _ in range(n)],
        "blocks": [[rng.integers(0, 9, (3,)).astype(np.int64) for _ in range(n)]
                   for _ in range(n)],
        "flatbuf": [rng.integers(0, 9, (n * (n + 1) // 2,)).astype(np.int64)
                    for _ in range(n)],
    }


def _counts(n):
    return list(range(1, n + 1))


# case: (prog(H, O, c, d, g, w) with H a han-shaped module, vars); the flat
# run passes H = _Flat (coll/host with the groups argument dropped)
HAN_CASES = {
    "allreduce": (lambda H, O, c, d, g, w: H.allreduce(c, w(d["i"][c.rank]), O.SUM, groups=g), {}),
    "allreduce_f32": (lambda H, O, c, d, g, w: H.allreduce(c, w(d["f"][c.rank]), O.SUM, groups=g), {}),
    "allreduce_segmented": (
        lambda H, O, c, d, g, w: H.allreduce(c, w(d["big"][c.rank]), O.SUM, groups=g),
        {"host_coll_large_msg": 256, "coll_han_inter_segment": 64, "coll_han_pipeline": "off"}),
    "allreduce_pipelined": (
        lambda H, O, c, d, g, w: H.allreduce(c, w(d["big"][c.rank]), O.MAX, groups=g),
        {"host_coll_large_msg": 256, "coll_han_inter_segment": 64}),
    "bcast": (lambda H, O, c, d, g, w: [
        H.bcast(c, w(d["i"][root]) if c.rank == root else None, root, groups=g)
        for root in range(c.size)], {}),
    "reduce": (lambda H, O, c, d, g, w: [
        H.reduce(c, w(d["i"][c.rank]), O.SUM, root, groups=g) for root in range(c.size)], {}),
    "barrier": (lambda H, O, c, d, g, w: [H.barrier(c, groups=g) for _ in range(3)], {}),
    "allgather": (lambda H, O, c, d, g, w: H.allgather(c, w(d["i"][c.rank]), groups=g), {}),
    "reduce_scatter": (lambda H, O, c, d, g, w: H.reduce_scatter(
        c, [w(b) for b in d["blocks"][c.rank]], O.SUM, groups=g), {}),
    "alltoall": (lambda H, O, c, d, g, w: H.alltoall(
        c, [w(b) for b in d["blocks"][c.rank]], groups=g), {}),
    "alltoall_bruck": (lambda H, O, c, d, g, w: H.alltoall(
        c, [w(b) for b in d["blocks"][c.rank]], groups=g), {"coll_han_alltoall_bruck_min": 2}),
    "alltoallv": (lambda H, O, c, d, g, w: H.alltoallv(
        c, w(d["flatbuf"][c.rank]), _counts(c.size), groups=g), {}),
}


class _Flat:
    """coll/host's flat algorithm under han's signature (groups dropped)."""

    def __init__(self, host):
        self.h = host

    def __getattr__(self, name):
        def call(ctx, *a, groups=None, **k):
            if name == "barrier":
                return ctx.barrier()
            return getattr(self.h, name)(ctx, *a, **k)
        return call


def _ident(x):
    return x


@pytest.mark.parametrize("grouping", list(GROUPS))
@pytest.mark.parametrize("case", list(HAN_CASES))
def test_han_op_against_flat_and_namesake(port_vars, case, grouping):
    prog, settings = HAN_CASES[case]
    g = GROUPS[grouping]
    n = sum(len(x) for x in g)
    d = _inputs(n)
    _set(**settings)
    lead0 = spc.read("coll_han_leader_elections")
    port = _run(TUniverse, n, lambda c: _plain(prog(than, tops, c, d, g, torch.from_numpy)))
    port_np = _run(TUniverse, n, lambda c: _plain(prog(than, tops, c, d, g, _ident)))
    ref = _run(JUniverse, n, lambda c: _plain(prog(jhan, jops, c, d, g, _ident)))
    assert spc.read("coll_han_leader_elections") > lead0
    assert port == ref, case
    assert port_np == ref, case
    if case != "allreduce_f32":  # integer-valued data: flat gives the same bits
        flat = _run(TUniverse, n, lambda c: _plain(prog(_Flat(thost), tops, c, d, g,
                                                        torch.from_numpy)))
        assert port == flat, case
    if case == "allreduce_pipelined":
        assert spc.read("coll_han_pipelined") > 0


NUMA_CASES = ("allreduce", "allreduce_segmented", "bcast", "barrier")


@pytest.mark.parametrize("nest", list(NESTS))
@pytest.mark.parametrize("case", NUMA_CASES)
def test_numa_level_against_flat_and_namesake(port_vars, case, nest):
    prog, settings = HAN_CASES[case]
    g = NESTS[nest]
    n = sum(len(dom) for h in g for dom in h)
    d = _inputs(n)
    _set(**settings)
    numa0 = spc.read("coll_han_numa_collectives")
    port = _run(TUniverse, n, lambda c: _plain(prog(than, tops, c, d, g, torch.from_numpy)))
    ref = _run(JUniverse, n, lambda c: _plain(prog(jhan, jops, c, d, g, _ident)))
    flat = _run(TUniverse, n, lambda c: _plain(prog(_Flat(thost), tops, c, d, g,
                                                    torch.from_numpy)))
    assert port == ref == flat, case
    assert spc.read("coll_han_numa_collectives") > numa0


def test_noncommutative_op_refused():
    noncomm = tops.create_op(lambda a, b: a * 2 + b, commute=False)

    def prog(ctx):
        with pytest.raises(errors.ArgError, match="commutative"):
            than.allreduce(ctx, ctx.rank, noncomm, groups=GROUPS["2x2"])
        return True

    assert _run(TUniverse, 4, prog) == [True] * 4


# ------------------------------------------------------------- decision


def test_auto_on_the_thread_plane_stays_flat():
    inter0, fb0 = spc.read("coll_han_inter_bytes"), spc.read("han_flat_fallbacks")
    assert _run(TUniverse, 4, lambda c: float(thost.allreduce(
        c, np.full(4, 1.0), tops.SUM)[0])) == [4.0] * 4
    assert spc.read("coll_han_inter_bytes") == inter0
    assert spc.read("han_flat_fallbacks") == fb0


def test_forced_on_over_a_degenerate_topology_falls_back_loudly(port_vars, tmp_path):
    """``on``, or a ``han`` rules line, over one locality group: the flat
    algorithm runs and every rank counts the fallback."""
    tvar.set_var("coll_han_enable", "on")
    fb0 = spc.read("han_flat_fallbacks")
    assert _run(TUniverse, 4, lambda c: c.allreduce(c.rank + 1, tops.SUM)) == [10] * 4
    assert spc.read("han_flat_fallbacks") - fb0 == 4
    tvar.set_var("coll_han_enable", "auto")
    rules = tmp_path / "han.rules"
    rules.write_text("allreduce 0 0 han\n")
    tvar.set_var("coll_tuned_dynamic_rules", str(rules))
    fb0 = spc.read("han_flat_fallbacks")
    assert _run(TUniverse, 4, lambda c: c.allreduce(c.rank + 1, tops.SUM)) == [10] * 4
    assert spc.read("han_flat_fallbacks") - fb0 == 4


def test_off_never_engages_and_auto_engages_on_a_qualified_wire(port_vars):
    def prog(p):
        out = p.allreduce(np.full(256, float(p.rank + 1)), tops.SUM)
        p.barrier()
        return float(out[0]), p.allgather(p.rank * 2)

    tvar.set_var("coll_han_enable", "off")
    inter0 = spc.read("coll_han_inter_bytes")
    assert run_wire(4, prog, boots_2x2()) == [(10.0, [0, 2, 4, 6])] * 4
    assert spc.read("coll_han_inter_bytes") == inter0
    tvar.set_var("coll_han_enable", "auto")
    intra0, fb0 = spc.read("coll_han_intra_bytes"), spc.read("han_flat_fallbacks")
    assert run_wire(4, prog, boots_2x2()) == [(10.0, [0, 2, 4, 6])] * 4
    assert spc.read("coll_han_inter_bytes") > inter0
    assert spc.read("coll_han_intra_bytes") > intra0
    assert spc.read("han_flat_fallbacks") == fb0


def test_rules_line_selects_han_where_auto_would_not(port_vars, tmp_path):
    """A 2+1 topology (one multi-rank group) auto rejects; an
    ``allreduce 2 4096 han`` line engages han above 4096 bytes only."""
    rules = tmp_path / "han.rules"
    rules.write_text("allreduce 2 4096 han\n")
    tvar.set_var("coll_tuned_dynamic_rules", str(rules))
    kw = {0: {"sm_boot_id": "aaaa"}, 1: {"sm_boot_id": "aaaa"}, 2: {"sm_boot_id": "bbbb"}}
    inter0 = spc.read("coll_han_inter_bytes")
    small = run_wire(3, lambda p: float(p.allreduce(np.full(8, 1.0), tops.SUM)[0]), kw)
    assert small == [3.0] * 3 and spc.read("coll_han_inter_bytes") == inter0
    large = run_wire(3, lambda p: float(p.allreduce(np.full(1024, 1.0), tops.SUM)[0]), kw)
    assert large == [3.0] * 3 and spc.read("coll_han_inter_bytes") > inter0


def test_explicit_algorithm_outranks_han(port_vars):
    tvar.set_var("coll_han_enable", "on")
    inter0 = spc.read("coll_han_inter_bytes")

    def prog(p):
        arr = np.arange(64, dtype=np.float64)
        out = thost.bcast(p, arr if p.rank == 0 else None, 0, algorithm="pipeline")
        return float(out[5])

    assert run_wire(4, prog, boots_2x2()) == [5.0] * 4
    assert spc.read("coll_han_inter_bytes") == inter0


# ----------------------------------------------------------------- wire


def test_all_ops_forced_on_over_the_wire(port_vars):
    tvar.set_var("coll_han_enable", "on")
    fb0 = spc.read("han_flat_fallbacks")

    def prog(p):
        r = p.rank
        out = {"ar": float(p.allreduce(torch.full((16,), float(r + 1)), tops.SUM)[0]),
               "bc": p.bcast(("payload", 9) if r == 1 else None, 1),
               "red": p.reduce(r + 1, tops.SUM, 2)}
        p.barrier()
        out["ag"] = p.allgather(chr(ord("a") + r))
        out["rs"] = float(p.reduce_scatter(
            [np.full(2, float(r + 1 + b)) for b in range(4)], tops.SUM)[0])
        out["a2a"] = [int(x) for x in p.alltoall([torch.tensor(r * 10 + d) for d in range(4)])]
        return out

    for r, out in enumerate(run_wire(4, prog, boots_2x2())):
        assert out["ar"] == 10.0 and out["bc"] == ("payload", 9)
        assert out["red"] == (10 if r == 2 else None)
        assert out["ag"] == ["a", "b", "c", "d"] and out["rs"] == 10.0 + 4 * r
        assert out["a2a"] == [s * 10 + r for s in range(4)]
    assert spc.read("han_flat_fallbacks") == fb0


def test_han_alltoall_wire_bytes_below_flat(port_vars):
    laps, w = 4, 64

    def run_once():
        def prog(p):
            blocks = [np.full(w, float(p.rank * 10 + d)) for d in range(4)]
            p.barrier()
            b0 = spc.read("tcp_bytes_sent")
            for _ in range(laps):
                out = p.alltoall(blocks)
            p.barrier()
            for s in range(4):
                np.testing.assert_array_equal(np.asarray(out[s]), np.full(w, float(s * 10 + p.rank)))
            return spc.read("tcp_bytes_sent") - b0

        return max(run_wire(4, prog, boots_2x2()))

    tvar.set_var("coll_han_enable", "off")
    flat_bytes = run_once()
    tvar.set_var("coll_han_enable", "on")
    fb0, ib0 = spc.read("han_flat_fallbacks"), spc.read("coll_han_alltoall_inter_bytes")
    han_bytes = run_once()
    assert spc.read("han_flat_fallbacks") == fb0
    assert spc.read("coll_han_alltoall_inter_bytes") > ib0
    assert 0 < han_bytes < flat_bytes, (han_bytes, flat_bytes)


def test_numa_level_through_sm_numa_id_pins(port_vars):
    """One boot id, ``sm_numa_id`` pinned to two domains of two ranks:
    the nested groups follow the pins, and auto runs allreduce, bcast
    and barrier three-level (the domain leaders' rings take the leader
    class)."""
    kw = {r: {"sm_boot_id": "onehost", "sm_numa_id": "d0" if r < 2 else "d1"}
          for r in range(4)}
    numa0, dl0 = spc.read("coll_han_numa_collectives"), spc.read("coll_han_dleader_bytes")

    def prog(p):
        nested = tgroups.locality_groups(p, nested=True)
        a = p.allreduce(torch.full((8,), float(p.rank + 1)), tops.SUM)
        b = p.bcast("x" if p.rank == 3 else None, 3)
        p.barrier()
        return nested, float(a[0]), b

    for nested, a, b in run_wire(4, prog, kw):
        assert nested == [[[0, 1], [2, 3]]] and a == 10.0 and b == "x"
    assert spc.read("coll_han_numa_collectives") - numa0 >= 3 * 4
    assert spc.read("coll_han_dleader_bytes") > dl0


def test_moe_host_ffn_on_a_2x2_han_universe():
    """``moe_host_ffn`` on 2 emulated hosts of 2 ranks: both transposes
    take han's alltoall (auto), and ``y`` and the kept mask agree with
    the JAX package's ``moe_host_ffn`` on the same inputs (rtol 2e-5,
    atol 2e-6: f32 products summed in another order)."""
    rng = np.random.default_rng(909)
    n, D, F, T, cf = 4, 32, 64, 16, 1.25
    inp = {"router": (rng.standard_normal((D, n)) * D ** -0.5).astype(np.float32),
           "w_in": (rng.standard_normal((n, D, F)) * D ** -0.5).astype(np.float32),
           "w_out": (rng.standard_normal((n, F, D)) * F ** -0.5).astype(np.float32)}
    x = rng.standard_normal((n * T, D)).astype(np.float32)

    def port(p):
        y, keep = tmoe.moe_host_ffn(
            p, tmoe.moe_params_from_numpy(inp, device="cpu", ep_rank=p.rank),
            torch.from_numpy(x[p.rank * T:(p.rank + 1) * T]), capacity_factor=cf)
        return y.numpy(), keep.numpy()

    def ref(p):
        r = p.rank
        prm = {"router": jnp.asarray(inp["router"]), "w_in": jnp.asarray(inp["w_in"][r:r + 1]),
               "w_out": jnp.asarray(inp["w_out"][r:r + 1])}
        y, keep = jmoe.moe_host_ffn(p, prm, jnp.asarray(x[r * T:(r + 1) * T]),
                                    capacity_factor=cf)
        return np.asarray(y), np.asarray(keep)

    a2a0, fb0 = spc.read("coll_han_alltoall_collectives"), spc.read("han_flat_fallbacks")
    got = run_wire(n, port, boots_2x2())
    assert spc.read("coll_han_alltoall_collectives") - a2a0 == 2 * n
    assert spc.read("han_flat_fallbacks") == fb0
    want = run_wire(n, ref, boots_2x2(), kinds=[JTcpProc] * n)
    for (y, keep), (jy, jkeep) in zip(got, want):
        assert keep.tolist() == jkeep.tolist()
        np.testing.assert_allclose(y, jy, rtol=2e-5, atol=2e-6)
