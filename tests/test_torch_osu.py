"""The port's OSU harness (``zhpe_ompi_tpu_torch/benchmarks/osu_zmpi.py``)
against its namesake (``benchmarks/osu_zmpi.py``).

Every test of ``tests/test_osu.py`` has its case here, at the same small
size, and runs the ladder in both packages (the namesake's slow tests are
slow here too).  Each case checks what the namesake's test checks, on the
port's rows, and holds the two packages' ladders to each other:

- the rows' keys, and their ``op`` and ``bytes`` columns, are equal;
- the counters the namesake's gates read (``spc`` deltas around the
  ladder, each package's own registry) are equal where the count is
  deterministic: the han, NUMA and alltoall phase counters, the one-sided
  counters, the deferred engine's counters, and the trace A/B's wire
  bytes of its quiesced measured bodies (both packages speak one wire,
  so these match byte for byte).  Whole-ladder ring and wire bytes
  (wire-up frames carry ephemeral ports; under load a few bytes move),
  the scale ladder's sockets and flood frames (they race with the
  detector) and an armed trace window's spans are held to the gates'
  own verdicts instead;
- a gate that trips in the namesake trips in the port: the wedged probe
  under ``WEDGE_ALL`` raises ``SystemExit`` in both.

The port adds: ``bench_collective`` on four gloo ranks
(``tests/_torch_dist_worker.py osu``), whose ``bytes`` column is the
namesake's count rule and whose top rung's results equal the JAX package's
collectives on the same numpy input, the allreduce under every forced
algorithm too; the trace A/B and the elastic resize ladder in both
packages; the slow reproduction of the open fault C15 (a grow before the
launch sessions exist) in both; the CLI with ``--device cpu``; and the
device ladders' refusal without CUDA.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import zhpe_ompi_tpu as jz
from benchmarks import osu_zmpi as josu
from test_osu import _check
from test_torch_dvm_tree import _port_runtime_hygiene  # noqa: F401 - autouse
from zhpe_ompi_tpu.coll import tpu as jtpu
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu_torch.benchmarks import osu_zmpi as tosu
from zhpe_ompi_tpu_torch.coll import nccl as tnccl
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.runtime import spc as tspc

from _torch_dist_worker import OSU_MAX, OSU_OPS, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = NS(name="jax", osu=josu, spc=jspc, var=jvar)
PORT = NS(name="port", osu=tosu, spc=tspc, var=tvar)
WIRE = ("tcp_bytes_sent", "tcp_bytes_recvd", "sm_bytes_sent")


@pytest.fixture
def both_vars():
    """Snapshot and restore both packages' MCA registries."""
    saved = [(reg, {v.name: (v._value, v._source)
                    for v in reg.registry.all_vars()})
             for reg in (jvar, tvar)]
    yield
    for reg, snap in saved:
        for v in reg.registry.all_vars():
            if v.name in snap:
                v._value, v._source = snap[v.name]


def both(name, *args, counters=(), **kw):
    """Run ladder ``name`` in the JAX package, then in the port; each
    package's ``spc`` deltas of ``counters`` around its run.  The rows'
    keys and their op and bytes columns must agree.  Returns the port's
    rows, both packages' deltas and the JAX package's rows."""
    out = []
    for P in (JAX, PORT):
        base = {c: P.spc.read(c) for c in counters}
        rows = getattr(P.osu, name)(*args, **kw)
        out.append((rows, {c: P.spc.read(c) - base[c] for c in counters}))
    (jrows, jd), (trows, td) = out
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [(r["op"], r.get("bytes")) for r in trows] == \
        [(r["op"], r.get("bytes")) for r in jrows]
    return trows, jd, td, jrows


def test_pt2pt_rows():
    rows, *_ = both("bench_pt2pt", max_size=64, iters=3)
    _check(rows, "pt2pt_pingpong")


def test_tcp_rows():
    rows, jd, td, _ = both("bench_tcp", max_size=64, iters=3, counters=WIRE)
    _check(rows, "tcp_pingpong")
    assert td["sm_bytes_sent"] == jd["sm_bytes_sent"] == 0
    assert td["tcp_bytes_sent"] > 0 and jd["tcp_bytes_sent"] > 0


def test_pt2pt_bw_rows():
    rows, *_ = both("bench_pt2pt", max_size=64, iters=4, bw=True, window=4)
    _check(rows, "pt2pt_bw")


def test_tcp_bw_rows():
    rows, jd, td, _ = both("bench_tcp", max_size=64, iters=4, bw=True,
                           window=4, counters=WIRE)
    _check(rows, "tcp_bw")
    assert td["sm_bytes_sent"] == jd["sm_bytes_sent"] == 0


def test_host_allreduce_rows():
    rows, jd, td, _ = both("bench_host_coll", "allreduce", "auto",
                           max_size=1 << 10, iters=2, nprocs=2, counters=WIRE)
    _check(rows, "host_allreduce")
    # sm pinned off: the rings carry nothing in either package
    assert td["sm_bytes_sent"] == jd["sm_bytes_sent"] == 0
    assert td["tcp_bytes_sent"] > 0 and jd["tcp_bytes_sent"] > 0


@pytest.mark.parametrize("max_bytes,min_bytes", [(4096, 4), (4 << 20, 4),
                                                 (1 << 20, 1 << 10), (3, 4)])
def test_sizes_ladder(max_bytes, min_bytes):
    s = tosu._sizes(max_bytes, min_bytes)
    assert s == josu._sizes(max_bytes, min_bytes)
    if s:
        assert s[0] == min_bytes and s[-1] <= max_bytes
        assert all(b == a * 4 for a, b in zip(s, s[1:]))


@pytest.mark.slow
def test_zero_copy_path_taken_across_ladder():
    """Every rung of a 3-point ladder over sockets takes the zero-copy
    send path in both packages, by the same counts."""
    sizes = [64 << 10, 1 << 20, 4 << 20]
    for nbytes in sizes:
        payload = np.zeros(nbytes // 8, np.float64)
        deltas = []
        for P in (JAX, PORT):
            zc0 = P.spc.read("tcp_zero_copy_sends")
            av0 = P.spc.read("tcp_copy_bytes_avoided")

            def prog(p, payload=payload):
                if p.rank == 0:
                    p.send(payload, dest=1, tag=1)
                    return np.asarray(p.recv(source=1, tag=2,
                                             timeout=60.0)).nbytes
                got = p.recv(source=0, tag=1, timeout=60.0)
                p.send(got, dest=0, tag=2)
                return None

            res = P.osu._run_tcp_ranks(2, prog, sm=False)
            assert res[0] == payload.nbytes
            zc = P.spc.read("tcp_zero_copy_sends") - zc0
            av = P.spc.read("tcp_copy_bytes_avoided") - av0
            assert zc >= 2 and av >= 2 * nbytes, (P.name, nbytes, zc, av)
            deltas.append((zc, av))
        assert deltas[0] == deltas[1]


def test_sm_pt2pt_rows():
    rows, jd, td, _ = both("bench_sm", max_size=64, iters=3,
                           counters=WIRE + ("sm_fallback_tcp_sends",))
    _check(rows, "sm_pingpong")
    assert td["sm_fallback_tcp_sends"] == jd["sm_fallback_tcp_sends"] == 0
    assert td["sm_bytes_sent"] > 0 and jd["sm_bytes_sent"] > 0


def test_sm_host_allreduce_rows():
    rows, jd, td, _ = both("bench_host_coll", "allreduce", "auto",
                           max_size=1 << 10, iters=2, nprocs=2, sm=True,
                           counters=WIRE + ("sm_fallback_tcp_sends",))
    _check(rows, "sm_host_allreduce")
    assert td["sm_fallback_tcp_sends"] == jd["sm_fallback_tcp_sends"] == 0
    assert td["sm_bytes_sent"] > 0 and jd["sm_bytes_sent"] > 0


@pytest.mark.slow
def test_sm_ladder_no_silent_tcp_fallback():
    """Every rung's bytes cross the rings in both packages, by equal
    counts, with no send fallen back to TCP."""
    for nbytes in [4 << 10, 64 << 10, 1 << 20, 4 << 20]:
        payload = np.zeros(nbytes // 8, np.float64)
        sent = []
        for P in (JAX, PORT):
            fb0 = P.spc.read("sm_fallback_tcp_sends")
            sent0 = P.spc.read("sm_bytes_sent")

            def prog(p, payload=payload):
                if p.rank == 0:
                    p.send(payload, dest=1, tag=1)
                    return np.asarray(p.recv(source=1, tag=2,
                                             timeout=60.0)).nbytes
                got = p.recv(source=0, tag=1, timeout=60.0)
                p.send(got, dest=0, tag=2)
                return None

            res = P.osu._run_tcp_ranks(2, prog, sm=True)
            assert res[0] == payload.nbytes
            assert P.spc.read("sm_fallback_tcp_sends") == fb0, P.name
            sent.append(P.spc.read("sm_bytes_sent") - sent0)
            assert sent[-1] >= 2 * nbytes, (P.name, nbytes)
        assert sent[0] == sent[1]


@pytest.mark.slow
def test_sm_bench_gate_trips_on_forced_fallback():
    """A pair with mismatched boot ids moves ``sm_fallback_tcp_sends`` in
    both packages: the counter the ladders' gates refuse."""
    for P in (JAX, PORT):
        fb0 = P.spc.read("sm_fallback_tcp_sends")

        def prog(p):
            p.send(np.zeros(64), dest=1 - p.rank, tag=1)
            p.recv(source=1 - p.rank, tag=1, timeout=30.0)
            p.barrier()

        P.osu._run_tcp_ranks(2, prog, sm=True, kwargs_by_rank={
            1: {"sm_boot_id": "0badc0ffee00"}})
        assert P.spc.read("sm_fallback_tcp_sends") > fb0, P.name


HAN_EQUAL = ("han_flat_fallbacks", "coll_han_inter_bytes",
             "coll_han_intra_bytes", "coll_han_leader_elections",
             "coll_han_pipelined", "sm_fallback_tcp_sends",
             "sm_rings_materialized")


def test_han_rows_thread_harness():
    """The flat, han and han-pipeline legs' rows in both packages, with
    equal han phase counters and ring bytes (the gates inside
    ``bench_han`` hold in each)."""
    rows, jd, td, _ = both("bench_han", max_size=1 << 11, iters=2,
                           real_procs=False, counters=HAN_EQUAL)
    for prefix in ("flat_host_allreduce", "han_host_allreduce",
                   "flat_host_bcast", "han_host_bcast",
                   "han_pipe_host_allreduce", "han_pipe_host_bcast"):
        sub = [r for r in rows if r["op"] == prefix]
        assert sub, f"no rows for {prefix}"
        for r in sub:
            assert r["bytes"] > 0 and r["latency_us"] > 0
            assert np.isfinite(r["bandwidth_MBps"])
    assert td == jd
    assert td["han_flat_fallbacks"] == 0 < td["coll_han_inter_bytes"]


A2A_EQUAL = ("han_flat_fallbacks", "coll_han_alltoall_collectives",
             "coll_han_alltoall_inter_bytes", "coll_han_alltoall_leader_msgs",
             "coll_han_inter_bytes", "coll_han_intra_bytes",
             "sm_fallback_tcp_sends")


def test_alltoall_rows_thread_harness():
    rows, jd, td, _ = both("bench_alltoall", max_size=1 << 11, iters=2,
                           real_procs=False, counters=A2A_EQUAL)
    for prefix in ("flat_host_alltoall", "han_host_alltoall",
                   "flat_host_alltoallv", "han_host_alltoallv"):
        sub = [r for r in rows if r["op"] == prefix]
        assert sub, f"no rows for {prefix}"
        for r in sub:
            assert r["bytes"] > 0 and r["latency_us"] > 0
            assert np.isfinite(r["bandwidth_MBps"])
    assert td == jd
    assert td["coll_han_alltoall_collectives"] > 0


@pytest.mark.slow
def test_alltoall_ladder_real_procs():
    rows, *_ = both("bench_alltoall", max_size=1 << 16, iters=3,
                    real_procs=True)
    assert any(r["op"] == "han_host_alltoall" for r in rows)
    assert any(r["op"] == "flat_host_alltoallv" for r in rows)


OVERLAP_GATES = ("tcp_isend_deferred", "rndv_park_bytes_avoided",
                 "tcp_rndv_park_copy_bytes")


def test_overlap_rows_and_counter_gates(both_vars):
    """The ishift overlap ladder with the eager limit lowered in both
    packages, so the rendezvous gates run inside a small ladder: the
    deferred engine's counters (the blocking legs' park copies among them)
    are equal."""
    for P in (JAX, PORT):
        P.var.set_var("tcp_eager_limit", 16 << 10)
    rows, jd, td, _ = both("bench_overlap", max_size=1 << 16, iters=4,
                           window=4, counters=OVERLAP_GATES)
    assert rows
    for r in rows:
        assert r["op"] == "tcp_ishift_overlap"
        assert 0.0 <= r["overlap"] <= 1.0
        assert r["blocking_overlap"] <= 0.05
        assert np.isfinite(r["bandwidth_MBps"])
    assert any(r["bytes"] > (16 << 10) for r in rows)
    assert td == jd and td["rndv_park_bytes_avoided"] > 0


def test_scale_rows_thread_plane(both_vars):
    out = {}
    for P in (JAX, PORT):
        out[P.name] = P.osu.bench_scale(ns=(8, 16), reps=1, launch_ranks=0)
    # lazy dials, sockets and flood frames race with the wire-up and the
    # detector; the ladder's gates bound them in each package
    rows = out["port"]
    assert [sorted(r) for r in rows] == [sorted(r) for r in out["jax"]]
    assert [(r["op"], r["n"]) for r in rows] == \
        [(r["op"], r["n"]) for r in out["jax"]]
    wire = [r for r in rows if r["op"] == "scale-wireup"]
    flood = [r for r in rows if r["op"] == "scale-flood"]
    assert [r["n"] for r in wire] == [8, 16]
    assert [r["n"] for r in flood] == [8, 16]
    for r in wire:
        assert r["wireup_ms"] > 0 and r["lazy_connects"] > 0
    for r in flood:
        assert r["classify_ms"] > 0 and r["flood_frames"] > 0


@pytest.mark.slow
def test_scale_ladder_with_launch_depth_rungs(both_vars):
    for P in (JAX, PORT):
        rows = P.osu.bench_scale()
        launch = [r for r in rows if r["op"] == "scale-launch"]
        assert [r["depth"] for r in launch] == [0, 1, 3]
        deep = launch[-1]
        assert deep["cache_hits"] > 0 and deep["routed_launches"] > 0
        assert deep["root_gets"] < launch[0]["root_gets"]


@pytest.mark.slow
def test_overlap_ladder_real_sizes():
    for P in (JAX, PORT):
        rows = P.osu.bench_overlap(max_size=4 << 20, iters=10, window=8)
        big = [r for r in rows if r["bytes"] >= 256 << 10]
        assert big
        for r in big:
            assert r["overlap"] > 0.5, (P.name, r)
            assert r["blocking_overlap"] <= 0.05, (P.name, r)


@pytest.mark.slow
def test_han_ladder_no_silent_flat_fallback_real_procs():
    rows, *_ = both("bench_han", max_size=1 << 18, iters=3,
                    real_procs=True)
    assert any(r["op"] == "han_host_allreduce" for r in rows)
    assert any(r["op"] == "flat_host_allreduce" for r in rows)


NUMA_EQUAL = ("han_flat_fallbacks", "han_numa_fallbacks",
              "coll_han_numa_collectives", "coll_han_dleader_bytes",
              "coll_han_inter_bytes", "coll_han_intra_bytes",
              "coll_han_leader_elections", "sm_frag_sends",
              "sm_fallback_tcp_sends", "sm_rings_materialized")


def test_numa_rows_thread_harness():
    rows, jd, td, _ = both("bench_numa", max_size=256 << 10, iters=1,
                           nprocs=8, hosts=2, domains=2, real_procs=False,
                           trials=1, counters=NUMA_EQUAL)
    for prefix in ("flat_host_allreduce", "han2dom_host_allreduce",
                   "han3_host_allreduce", "flat_host_bcast",
                   "han2dom_host_bcast", "han3_host_bcast"):
        sub = [r for r in rows if r["op"] == prefix]
        assert sub, f"no rows for {prefix}"
        for r in sub:
            assert r["bytes"] >= 256 << 10
            assert r["latency_us"] > 0
            assert np.isfinite(r["bandwidth_MBps"])
    assert td == jd
    assert td["han_numa_fallbacks"] == 0 < td["coll_han_numa_collectives"]


@pytest.mark.slow
def test_numa_ladder_real_procs():
    rows, *_ = both("bench_numa", max_size=1 << 20, iters=2, nprocs=8,
                    hosts=2, domains=2, real_procs=True, trials=2)
    assert any(r["op"] == "han3_host_allreduce" for r in rows)
    assert any(r["op"] == "han2dom_host_allreduce" for r in rows)


def _concurrently(fns):
    """Run the callables in threads of their own; each one's return value
    or exception, in order."""
    import threading

    out = [None] * len(fns)

    def run(i, fn):
        try:
            out[i] = ("ok", fn())
        except BaseException as e:  # noqa: BLE001 - returned to the test
            out[i] = ("raised", e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not any(t.is_alive() for t in threads)
    return out


def test_device_probe_row_gates():
    """The probe row on a healthy plane: the JAX package's on its CPU
    devices, the port's on gloo (``device="cpu"``), both at once."""
    got = _concurrently([
        lambda: josu.bench_device_probe(rounds=1),
        lambda: tosu.bench_device_probe(rounds=1, device="cpu")])
    assert [kind for kind, _ in got] == ["ok", "ok"], got
    jrows, trows = (rows for _, rows in got)
    assert sorted(trows[0]) == sorted(jrows[0])
    for rows in (jrows, trows):
        assert len(rows) == 1
        r = rows[0]
        assert r["op"] == "device_probe"
        assert r["rounds"] >= 1
        assert r["misses"] == 0
        assert r["device_faults"] == 0
        assert r["probe_latency_ms"] > 0


def test_device_probe_gate_trips_on_wedged_plane(monkeypatch, both_vars):
    """A wedged plane (the probe child's wedge hook) fails the run loudly
    in both packages instead of shipping a row."""
    assert tnccl.WEDGE_ENV == jtpu.WEDGE_ENV
    monkeypatch.setenv(tnccl.WEDGE_ENV, tnccl.WEDGE_ALL)
    for P in (JAX, PORT):
        P.var.set_var("device_probe_timeout", 20.0)
        P.var.set_var("device_probe_deadline", 6.0)
    got = _concurrently([
        lambda: josu.bench_device_probe(rounds=1),
        lambda: tosu.bench_device_probe(rounds=1, device="cpu")])
    for kind, value in got:
        assert kind == "raised" and isinstance(value, SystemExit), got


OSC_EQUAL = ("osc_direct_bytes", "osc_direct_puts", "osc_direct_gets",
             "osc_direct_atomics", "osc_am_fallbacks", "osc_am_applied")


def test_osc_rows_thread_harness(both_vars):
    rows, jd, td, _ = both("bench_osc", max_size=1024, iters=3,
                           counters=OSC_EQUAL)
    ops_seen = {r["op"] for r in rows}
    assert {"osc_direct_put", "osc_direct_get", "osc_direct_fetch_op",
            "osc_am_put", "osc_am_get",
            "osc_am_fetch_op"} <= ops_seen
    for r in rows:
        assert r["bytes"] > 0
        assert r["latency_us"] > 0
        assert np.isfinite(r["bandwidth_MBps"])
    assert td == jd
    assert td["osc_am_fallbacks"] == 0 < td["osc_direct_bytes"]


@pytest.mark.slow
def test_osc_ladder_real_procs(both_vars):
    rows, *_ = both("bench_osc", max_size=1 << 17, iters=5,
                    real_procs=True)
    direct_puts = [r for r in rows if r["op"] == "osc_direct_put"]
    assert len(direct_puts) >= 4


# -------------------------------------------------- the port's additions


def test_trace_rows_match_byte_for_byte():
    """The trace A/B: the disarmed measured bodies' wire bytes are equal
    in the two packages, byte for byte, with no span and no context byte;
    the armed rows record spans in both (each package's ladder gates that
    an armed body grows the wire by exactly its context bytes).  Spans of
    other threads of the process may land in an armed window, so the
    armed counts are not compared."""
    rows, _, _, jrows = both("bench_trace", max_size=1024, iters=3)
    for mine, theirs in zip(rows, jrows):
        if mine["op"].endswith("_off"):
            assert mine["wire_bytes"] == theirs["wire_bytes"], (mine, theirs)
            assert mine["spans"] == mine["ctx_bytes"] == 0
        else:
            assert mine["spans"] > 0 and theirs["spans"] > 0
            assert mine["ctx_bytes"] > 0 and theirs["ctx_bytes"] > 0


def test_resize_round_trips_against_a_resident_daemon():
    """One grow 2 -> 4 and one shrink 4 -> 2 of an ft job on a resident
    daemon of the port, each counted by ``dvm_resizes``; the first grow
    waits until both launch ranks built their sessions (the open fault
    C15, held below)."""
    r0 = tspc.read("dvm_resizes")
    rows = tosu.bench_resize(reps=1)
    assert [r["mode"] for r in rows] == ["grow 2->4 (spawn-confirmed RTT)",
                                         "shrink 4->2 (retire-confirmed RTT)"]
    assert tspc.read("dvm_resizes") - r0 == 2
    for r in rows:
        assert r["op"] == "resize" and r["nprocs"] == 4 and r["reps"] == 1
        assert 0 < r["best_ms"] <= r["median_ms"]


_EARLY_GROW_PROG = """
import os, sys, time
import numpy as np
import {pkg} as zmpi
from {pkg} import ops
from {pkg}.ft import recovery

ep = zmpi.host_init()
launch = os.environ.get("ZMPI_ELASTIC_SEEN") == "-1"
print(f"init rank={{ep.rank}} launch={{launch}}", flush=True)
if launch and ep.rank == 0:
    # rank 0 is slow to build its session: it waits until the grown
    # ranks are up, while rank 1 builds its own at once
    while not os.path.exists(sys.argv[1]):
        time.sleep(0.05)
ses = recovery.ElasticSession(ep)
print(f"session rank={{ep.rank}} live={{ses.live.size}}", flush=True)
seen, deadline = 0, time.monotonic() + 20.0
while True:
    stop = 1.0 if (seen >= 1 or time.monotonic() > deadline) else 0.0
    out = ses.live.allreduce(np.array([1.0, stop]), ops.SUM)
    if out[1] > 0:
        break
    act = ses.step()
    if act in ("retire", "halt"):
        break
    seen += act == "resized"
ses.close()
zmpi.host_finalize()
"""


@pytest.mark.slow
@pytest.mark.parametrize("pkg", ["zhpe_ompi_tpu", "zhpe_ompi_tpu_torch"])
def test_a_grow_before_the_launch_sessions_are_built_kills_the_job(
        tmp_path, pkg):
    """ROADMAP C15, open in both packages: an elastic job launched
    2-live-of-4 on a resident daemon, grown to 4 while launch rank 0 has
    not built its ``ElasticSession`` yet (rank 1 has).  The grown ranks'
    FT_JOIN and constructor shrink meet the launch ranks' constructor
    agreement, whose failed set still holds them, and the job dies.
    ``bench_resize`` in the port therefore grows only after both launch
    ranks built their sessions; the namesake's does not wait, and fails
    the same way when its grow comes early."""
    import importlib
    import io
    import threading
    import time

    dvm_mod = importlib.import_module(f"{pkg}.runtime.dvm")
    prog = tmp_path / "early_grow.py"
    prog.write_text(f"import sys\nsys.path.insert(0, {REPO!r})\n"
                    + _EARLY_GROW_PROG.format(pkg=pkg))
    flag = tmp_path / "grown"
    out, err, done = io.StringIO(), io.StringIO(), {}
    d = dvm_mod.Dvm()
    try:
        cli = dvm_mod.DvmClient(d.address)
        t = threading.Thread(target=lambda: done.setdefault("rc", cli.launch(
            2, [str(prog), str(flag)], ft=True, max_size=4, timeout=90.0,
            mca=[("ft_detector_period", "2.0"),
                 ("ft_detector_timeout", "60.0")],
            stdout=out, stderr=err)), daemon=True)
        t.start()

        def wait(cond, what):
            deadline = time.monotonic() + 60.0
            while not cond():
                assert time.monotonic() < deadline, (what, out.getvalue(),
                                                     err.getvalue())
                time.sleep(0.05)

        wait(lambda: out.getvalue().count("launch=True") == 2, "launch init")
        ctl = dvm_mod.DvmClient(d.address)
        job_id = next(iter(ctl.stat()["jobs"]))
        evt = ctl.resize(job_id, 4, timeout=60.0)
        assert evt["grown"] == [2, 3], evt
        wait(lambda: out.getvalue().count("launch=False") == 2, "grown init")
        flag.write_text("")
        t.join(timeout=150.0)
        assert not t.is_alive(), (out.getvalue(), err.getvalue())
        ctl.close()
        cli.close()
    finally:
        d.stop()
    # the fault: the job does not finish, and a grown rank died of the
    # stale membership (or waited for an agreement no launch rank ran)
    assert done.get("rc") != 0, (out.getvalue(), err.getvalue())
    assert "session rank=2" not in out.getvalue()
    assert any(s in err.getvalue() for s in (
        "is not a survivor of the shrink", "no frame from rank 0")), \
        err.getvalue()


@pytest.fixture(scope="module")
def gloo_ladder(tmp_path_factory):
    results, outs = run_ranks("osu", 4, tmp_path_factory.mktemp("osu"),
                              timeout=180)
    for rc, log in results:
        assert rc == 0, log
    return outs


def _jax_top(op, n, count):
    """The JAX package's ``op`` on the namesake's rung input
    ``arange(n * count).reshape(n, count)`` over n CPU devices, row r
    being rank r's result."""
    comm = jz.Communicator(Mesh(np.asarray(jax.devices()[:n]), ("x",)), "x",
                           name="port_osu")
    xs = comm.device_put_sharded(
        jnp.arange(n * count, dtype=jnp.float32).reshape(n, count))
    if op == "bcast":
        per_dev = lambda s: comm.bcast(s.reshape(count), 0)  # noqa: E731
    else:
        per_dev = lambda s: getattr(comm, op)(s.reshape(count))  # noqa: E731
    out = jax.jit(lambda a: comm.run(per_dev, a))(xs)
    return np.asarray(out).reshape(n, -1)


def test_collective_ladder_on_gloo_ranks(gloo_ladder):
    """``bench_collective`` at four gloo ranks: each rung's ``bytes`` is
    the namesake's count rule (at least one element per rank, rounded up
    to a multiple of the size), in float32 and bfloat16 and under a
    forced algorithm; the top rung's result on every rank equals the JAX
    package's collective on the same input."""
    n = 4
    for tag in [f"{op}_auto_float32" for op in OSU_OPS] + [
            "allreduce_auto_bfloat16", "allreduce_ring_float32"]:
        itemsize = 2 if tag.endswith("bfloat16") else 4
        want = []
        for nbytes in josu._sizes(OSU_MAX):
            count = max(n, nbytes // itemsize)
            want.append(-(-count // n) * n * itemsize)
        keys = "algorithm,bandwidth_MBps,bytes,latency_us,op"
        for out in gloo_ladder:
            assert out[f"{tag}_bytes"].tolist() == want, tag
            assert set(out[f"{tag}_keys"].tolist()) == {keys}
            assert (out[f"{tag}_latency_us"] > 0).all()
    count = OSU_MAX // 4
    for op in OSU_OPS:
        ref = _jax_top(op, n, count)
        for r, out in enumerate(gloo_ladder):
            np.testing.assert_array_equal(out[f"{op}_top"], ref[r], err_msg=op)


def test_every_forced_allreduce_on_gloo_ranks(gloo_ladder):
    """Each allreduce algorithm of ``coll/tuned`` forced at four gloo
    ranks (on the card one rank runs them, where each but ``xla`` returns
    its input): its ladder's ``bytes`` is the namesake's count rule and
    its top rung's result on every rank equals the JAX package's
    allreduce on the same input."""
    from zhpe_ompi_tpu_torch.coll import tuned

    n, count = 4, OSU_MAX // 4
    want = [-(-max(n, b // 4) // n) * n * 4 for b in josu._sizes(OSU_MAX)]
    ref = _jax_top("allreduce", n, count)
    algs = list(tuned._ALG_TABLES["allreduce"])
    assert len(algs) == 7 and "xla" in algs
    for alg in algs:
        for r, out in enumerate(gloo_ladder):
            assert out[f"allreduce_{alg}_float32_bytes"].tolist() == want, alg
            assert (out[f"allreduce_{alg}_float32_latency_us"] > 0).all()
            np.testing.assert_array_equal(out[f"allreduce_{alg}_top"], ref[r],
                                          err_msg=alg)


def test_device_ladders_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tosu.bench_collective("allreduce", max_size=64, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tosu.bench_device_probe(rounds=1)


def test_cli_pt2pt_json_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "zhpe_ompi_tpu_torch.benchmarks.osu_zmpi",
         "--op", "pt2pt", "--max-size", "64", "--iters", "3", "--json",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert [r["bytes"] for r in rows] == [8, 16, 64]
    _check(rows, "pt2pt_pingpong")
