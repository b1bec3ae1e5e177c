"""The port's ztrace CLI and mpisync (``tools/ztrace.py``,
``tools/mpisync.py``) against the JAX package's: the same span payloads
give the same merged timeline, happens-before check, Chrome trace and
critical-path report; the same injected clock skew gives the same
offsets on thread ranks; the collective form recovers the skew on port
``TcpProc`` ranks; ``publish_clock_sync`` and ``collect`` round-trip
through a port ``Dvm``'s store.
"""

import threading
import time

import pytest
import torch

import test_ztrace as ref
from test_torch_dvm_tree import _port_runtime_hygiene  # noqa: F401 - autouse
from test_torch_tcp import run_tcp
from test_torch_ulfm import release_universes
from zhpe_ompi_tpu.pt2pt.universe import LocalUniverse as JUniverse
from zhpe_ompi_tpu.tools import mpisync as jmpisync
from zhpe_ompi_tpu.tools import ztrace as jztrace
from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc
from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse as TUniverse
from zhpe_ompi_tpu_torch.runtime import dvm as tdvm
from zhpe_ompi_tpu_torch.runtime import ztrace as tztrace_rt
from zhpe_ompi_tpu_torch.tools import mpisync as tmpisync
from zhpe_ompi_tpu_torch.tools import ztrace as tztrace

P, S = ref._payload, ref._span


def _scenarios():
    """Span payloads of the namesake's merged-timeline tests, by name."""
    def late(recv_t0, sid):
        return [P(0, 50.0, 0, [S(sid, "send", 0, 2_000_000, 2_000_000,
                                 dest=1, tag=1, cid=0),
                               S(sid + 30, "coll", 0, 0, 5_000_000,
                                 op="allreduce")]),
                P(1, 50.0, 0, [S(sid + 10, "deliver", 1, 3_000_000,
                                 3_000_000, parent=sid, src=0, tag=1, cid=0),
                               S(sid + 20, "recv", 1, recv_t0, 4_000_000,
                                 src=0, tag=1, cid=0),
                               S(sid + 31, "coll", 1, 1_000_000, 5_000_000,
                                 op="allreduce")])]

    return {
        "skewed": ([P(0, 100.0, 0, [S(11, "send", 0, 10**9, 10**9, dest=1,
                                      tag=1, cid=0)]),
                    P(1, 99.5, 0, [S(21, "deliver", 1, 6 * 10**8, 6 * 10**8,
                                     parent=11, src=0, tag=1, cid=0)])],
                   [0.0, -0.9005]),
        "chrome": ([P(0, 10.0, 0, [S(11, "send", 0, 0, 1000, dest=1, tag=1,
                                     cid=0)]),
                    P(1, 10.0, 0, [S(21, "deliver", 1, 5_000_000, 5_000_000,
                                     parent=11, src=0, tag=1, cid=0)])], None),
        "late-sender": (late(0, 100), None),
        "late-receiver": (late(3_900_000, 200), None),
        "recovery": ([P(0, 9.0, 0, [
            S(1, "ft_class", 0, 1_000_000, 1_000_000, failed=2,
              cause="daemon"),
            S(2, "agree", 0, 2_000_000, 4_000_000),
            S(3, "shrink", 0, 4_000_000, 5_000_000, gen=1),
            S(4, "respawn", 0, 5_000_000, 95_000_000, via="daemon")])], None),
        "backpressure": ([P(0, 5.0, 0, [
            S(11, "send", 0, 2_000_000, 9_000_000, dest=1, tag=1, cid=0,
              transport="sm", bp=True),
            S(41, "coll", 0, 0, 10_000_000, op="bcast")]),
            P(1, 5.0, 0, [
                S(21, "deliver", 1, 9_500_000, 9_500_000, parent=11, src=0,
                  tag=1, cid=0),
                S(31, "recv", 1, 0, 9_900_000, src=0, tag=1, cid=0),
                S(42, "coll", 1, 0, 10_000_000, op="bcast")])], None),
    }


@pytest.mark.parametrize("name", sorted(_scenarios()))
def test_merge_report_and_chrome_trace_match_the_namesake(name):
    payloads, offsets = _scenarios()[name]
    out = {}
    for tool in (tztrace, jztrace):
        spans = tool.corrected_spans(payloads, offsets)
        out[tool.__name__.split(".")[0]] = (
            spans, tool.happens_before_violations(spans),
            tool.chrome_trace(payloads, offsets),
            tool.critical_path_report(payloads, offsets))
    assert out["zhpe_ompi_tpu_torch"] == out["zhpe_ompi_tpu"]
    spans, violations, doc, report = out["zhpe_ompi_tpu_torch"]
    tids = {e["tid"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert tids == {p["rank"] for p in payloads}
    if name == "skewed":
        assert not violations
        assert tztrace.happens_before_violations(
            tztrace.corrected_spans(payloads))
    if name.startswith("late"):
        assert name in report and "straggler rank 1" in report


def test_port_thread_plane_trace_merges_causally():
    tztrace_rt.clear()
    tztrace_rt.arm()
    try:
        uni = TUniverse(2)

        def main(ctx):
            if ctx.rank == 0:
                ctx.send(torch.arange(8.0), dest=1, tag=1)
            else:
                ctx.recv(source=0, tag=1, timeout=10.0)
            return True

        assert uni.run(main) == [True, True]
        uni.close()
        payload = tztrace_rt.payload(0)
    finally:
        tztrace_rt.disarm()
        tztrace_rt.clear()
    spans = tztrace.corrected_spans([payload])
    assert {s["kind"] for s in spans} >= {"send", "deliver"}
    assert not tztrace.happens_before_violations(spans)
    assert tztrace.chrome_trace([payload]) == jztrace.chrome_trace([payload])


def _ticking_skewed_clock(skew):
    """A deterministic clock: every read advances one shared tick of
    1 ms, rank r reads it plus ``skew[r]``.  The sync protocol orders the
    reads, so both packages see the same values."""
    lock, tick = threading.Lock(), [0]

    def clock(rank):
        with lock:
            tick[0] += 1
            return tick[0] * 1e-3 + skew[rank]
    return clock


def test_same_injected_skew_gives_the_namesakes_offsets():
    skew = [0.0, 0.2, -0.4, 0.05]
    port = tmpisync.sync_clocks(TUniverse(4), rounds=6,
                                clock=_ticking_skewed_clock(skew))
    jax = jmpisync.sync_clocks(JUniverse(4), rounds=6,
                               clock=_ticking_skewed_clock(skew))
    release_universes()
    assert port == jax
    assert port[0] == 0.0
    for r in range(1, 4):
        assert abs(port[r] - skew[r]) < 2e-3, port


def test_collective_form_recovers_skew_on_port_tcp_ranks():
    skew = [0.0, 0.35, -0.15]

    def prog(p):
        return tmpisync.sync_clocks(
            p, rounds=8, clock=lambda _r, p=p: time.monotonic() + skew[p.rank])

    res = run_tcp([TcpProc] * 3, prog)
    assert res[1] is None and res[2] is None
    for r in (1, 2):
        assert abs(res[0][r] - skew[r]) < 0.05, res[0]


def test_publish_clock_sync_and_collect_through_a_port_dvm():
    d = tdvm.Dvm()
    try:
        pmix_addr = ("127.0.0.1", d.pmix.address[1])
        outs, excs = [None, None], [None, None]

        def main(rank):
            try:
                proc = TcpProc(rank, 2, pmix=pmix_addr, namespace="jobsync",
                               metrics=True, trace=True, sm=False)
                try:
                    proc.send(torch.arange(4.0), dest=1 - rank, tag=2)
                    proc.recv(source=1 - rank, tag=2)
                    outs[rank] = tztrace.publish_clock_sync(proc, rounds=4)
                    proc.barrier()
                finally:
                    proc.close()
            except BaseException as e:  # noqa: BLE001 - asserted below
                excs[rank] = e

        ts = [threading.Thread(target=main, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
            assert not t.is_alive()
        assert not any(excs), excs
        assert outs[1] is None and len(outs[0]) == 2
        payloads, offsets = tztrace.collect(pmix_addr, "jobsync")
        assert offsets == [float(v) for v in outs[0]]
        assert sorted(p["rank"] for p in payloads) == [0, 1]
        spans = tztrace.corrected_spans(payloads, offsets)
        assert {"send", "deliver"} <= {s["kind"] for s in spans}
        assert not tztrace.happens_before_violations(spans)
        assert tztrace.chrome_trace(payloads, offsets) == \
            jztrace.chrome_trace(payloads, offsets)
        d.store.destroy_ns("jobsync")
    finally:
        d.stop()
