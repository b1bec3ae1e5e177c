"""The PyTorch port's observability substrate against the JAX package's:
``runtime/spc``, ``runtime/peruse``, ``runtime/flightrec``,
``runtime/ztrace``, ``utils/deadline``, ``utils/payload`` and
``coll/monitoring``.

The same call sequence goes into both packages' modules and must leave the
same counters, events and spans (timestamps, and trace ids drawn from the
clock, excepted).  Payloads are numpy arrays for the JAX package and the
same arrays as torch tensors for the port.  The port's counter table
(``runtime/spc.py``'s docstring) must document every counter the port's
source records, as a name or as a templated family; its copy of the
table parser must read both packages' tables as the JAX package's
``tools/zlint`` parser does.  Everything is exact.
"""

import os
import pathlib
import re
import threading
import time

import numpy as np
import pytest

import torch
import torch.distributed as dist

from zhpe_ompi_tpu.coll import monitoring as jmon
from zhpe_ompi_tpu.runtime import flightrec as jfr
from zhpe_ompi_tpu.runtime import peruse as jperuse
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu.runtime import ztrace as jzt
from zhpe_ompi_tpu.tools.zlint import rules as jrules
from zhpe_ompi_tpu.utils import deadline as jdl
from zhpe_ompi_tpu.utils import payload as jpay
from zhpe_ompi_tpu_torch.coll import monitoring as tmon
from zhpe_ompi_tpu_torch.runtime import flightrec as tfr
from zhpe_ompi_tpu_torch.runtime import peruse as tperuse
from zhpe_ompi_tpu_torch.runtime import spc as tspc
from zhpe_ompi_tpu_torch.runtime import ztrace as tzt
from zhpe_ompi_tpu_torch.utils import deadline as tdl
from zhpe_ompi_tpu_torch.utils import payload as tpay

PORT = pathlib.Path(__file__).resolve().parent.parent / "zhpe_ompi_tpu_torch"


@pytest.fixture(autouse=True)
def fresh_counters():
    jspc.reset()
    tspc.reset()
    yield
    jspc.reset()
    tspc.reset()


def _spc_sequence(spc):
    spc.record("a")
    spc.record("a", 4)
    spc.record("max_bytes_in_collective", 10)
    spc.record("max_bytes_in_collective", 3)
    first = (spc.read("a"), spc.read("missing"), spc.snapshot())
    epoch = spc.reset_epoch()
    spc.reset()
    return first, spc.snapshot(), spc.reset_epoch() - epoch


def test_spc_sequence_matches_jax():
    assert _spc_sequence(tspc) == _spc_sequence(jspc)
    assert tspc.WATERMARK == jspc.WATERMARK


def test_counter_parser_reads_both_tables_as_zlint_does():
    for doc in (tspc.__doc__, jspc.__doc__):
        assert tspc.parse_counter_doc(doc) == jrules.parse_counter_doc(doc)


def test_every_recorded_counter_is_documented():
    """Every ``spc.record`` name in the port's source: literal names are
    documented names, f-string names instances of documented families."""
    recorded = set()
    for path in PORT.rglob("*.py"):
        for m in re.finditer(r'spc\.record\(\s*(f?)"([^"]+)"', path.read_text()):
            name = m.group(2)
            recorded.add(re.sub(r"\{[^}]*\}", "<x>", name) if m.group(1) else name)
    assert recorded, "no counter found in the port's source"
    _, families = tspc.parse_counter_doc(tspc.__doc__)
    templates = {re.sub(r"<[^<>]*>", "<x>", t) for t in families}
    for name in recorded:
        if "<x>" in name:
            assert name in templates, name
        else:
            assert name in tspc.documented_counters(), name


def test_metrics_publisher_waits_for_pmix():
    """The publisher (the PMIx store is ported): one port and one JAX
    publisher into one store ship snapshots of the same shape — the
    start-of-life and the final one, every documented counter zero-filled
    — and stop leaves no publisher thread and its flight-recorder arm
    released."""
    from zhpe_ompi_tpu_torch.runtime import pmix as tpmix

    srv = tpmix.PmixServer()
    try:
        got = {}
        for name, spc in (("port", tspc), ("jax", jspc)):
            srv.store.ensure_ns(name, 1)
            pub = spc.MetricsPublisher(srv.address, name, 0)
            pub.start()
            deadline = time.monotonic() + 10.0
            while not srv.store.lookup(name, "metrics:"):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            pub.stop()
            got[name] = srv.store.lookup(name, "metrics:")[f"metrics:{name}:0"]
            assert spc.live_publisher_threads() == []
            assert not got[name]["counters"].keys() ^ (
                spc.documented_counters() | set(spc.snapshot()))
            srv.store.destroy_ns(name)
        assert got["port"].keys() == got["jax"].keys()
        assert got["port"]["final"] is True and got["port"]["seq"] >= 1
        assert got["port"]["interval_ms"] == got["jax"]["interval_ms"] == 1000
        assert got["port"]["counters"]["spc_publishes"] >= 2
        assert tfr.active is False
    finally:
        srv.close()


def _peruse_sequence(peruse):
    seen = []

    def cb(event, **info):
        seen.append((event, tuple(sorted(info.items()))))

    states = [peruse.active]
    peruse.subscribe(peruse.MSG_ARRIVED, cb)
    states.append(peruse.active)
    peruse.fire(peruse.MSG_ARRIVED, src=1, tag=7)
    peruse.fire(peruse.REQ_COMPLETE, src=2, tag=8)
    peruse.unsubscribe(peruse.MSG_ARRIVED, cb)
    peruse.fire(peruse.MSG_ARRIVED, src=3, tag=9)
    states.append(peruse.active)
    with pytest.raises(ValueError):
        peruse.subscribe("no_such_event", cb)
    return seen, states, peruse.ALL_EVENTS


def test_peruse_sequence_matches_jax():
    assert _peruse_sequence(tperuse) == _peruse_sequence(jperuse)


def _flightrec_sequence(fr, spc, peruse):
    rec = fr.FlightRecorder(capacity=8)
    for i in range(11):
        rec.record(fr.SEND if i % 2 else fr.RECV, dest=i, tag=i * 3)
    win = [{k: v for k, v in e.items() if k != "t_ns"} for e in rec.window()]
    last = [{k: v for k, v in e.items() if k != "t_ns"} for e in rec.window(2)]
    dropped = spc.read("flightrec_events_dropped")
    fr.arm()
    armed = (fr.active, peruse.active)
    fr.record(fr.REVOKE, cid=5, plane="device")
    peruse.fire(peruse.MSG_MATCH_POSTED_REQ, src=4, tag=2)
    module = [{k: v for k, v in e.items() if k != "t_ns"}
              for e in fr.window()[-2:]]
    fr.disarm()
    fr.clear()
    return (win, last, dropped, rec.total(), rec.capacity, armed, module,
            fr.active, fr.ALL_EVENTS)


def test_flightrec_sequence_matches_jax():
    tfr.clear()
    jfr.clear()
    assert (_flightrec_sequence(tfr, tspc, tperuse)
            == _flightrec_sequence(jfr, jspc, jperuse))


def _strip(span):
    return {k: v for k, v in span.items() if k not in ("t0", "t1", "trace", "sid",
                                                       "parent")}


def _ztrace_sequence(zt, spc):
    rec = zt.SpanRecorder(capacity=16)
    for i in range(20):
        rec.record(zt.SEND, i % 3, 10 + i, 20 + i, dest=i)
    ring = [_strip(s) for s in rec.window()]
    payload = rec.payload(2)
    shape = (payload["rank"], payload["dropped"], len(payload["spans"]))
    counts = (spc.read("trace_spans_recorded"), spc.read("trace_spans_dropped"))
    off = (zt.record_span(zt.SEND, 0, 1, 2), zt.begin(zt.COLL, 0).end(),
           zt.instant(zt.FT_CLASS, 0))
    zt.clear()
    zt.arm()
    with zt.phase_span("intra", 1, level=0) as live:
        pass
    try:
        with zt.phase_span("aborted", 1):
            raise RuntimeError("phase failed")
    except RuntimeError:
        pass
    child = zt.begin(zt.SHRINK, 2, parent=live.sid, failed=[1])
    child.end(survivors=3)
    zt.instant(zt.AGREE, 2, result=True)
    spans = [_strip(s) for s in zt.window()]
    parented = zt.window()[1]["parent"] == zt.window()[0]["sid"]
    ctx = zt.wire_context(live.sid, 4)
    wire = (ctx[1:] == (live.sid, 4), zt.wire_context(None, 1),
            zt.parse_wire_context((1, 2, 3)), zt.parse_wire_context((1, "x", 3)))
    zt.disarm()
    state = (zt.active, zt.armed_count())
    zt.clear()
    return ring, shape, counts, off, spans, parented, wire, state, zt.ALL_KINDS


def test_ztrace_sequence_matches_jax():
    tzt.clear()
    jzt.clear()
    assert _ztrace_sequence(tzt, tspc) == _ztrace_sequence(jzt, jspc)


def test_probe_preamble_and_outcomes_match_jax():
    assert tdl.watchdog_preamble() == jdl.watchdog_preamble()
    assert tdl.PROBE_DEADLINE_RC == jdl.PROBE_DEADLINE_RC
    cases = [("print('hello')", 10, 5), ("import sys; sys.exit(7)", 10, 5),
             ("time.sleep(30)", 10, 1), ("time.sleep(30)", 1, 0)]
    for src, timeout, dl in cases:
        t = tdl.run_probe(src, timeout, dl)
        j = jdl.run_probe(src, timeout, dl)
        assert t[0] == j[0], (src, t, j)
        if t[0] != "error":
            assert t == j
    assert tdl.orphaned_probe_processes() == []


def test_watchdog_matches_jax():
    for dl in (tdl, jdl):
        fired = threading.Event()
        with dl.Watchdog(0.05, fired.set, name="w") as wd:
            assert dl.live_watchdog_threads() == ["w"]
            assert fired.wait(5)
        assert wd.expired
        quiet = threading.Event()
        with dl.Watchdog(5.0, quiet.set) as wd2:
            pass
        assert not wd2.expired and not quiet.is_set()
        time.sleep(0.05)
        assert dl.live_watchdog_threads() == []


_NESTS = [
    lambda a: a(np.zeros((3, 4), np.float32)),
    lambda a: (a(np.zeros(5, np.int64)), [a(np.ones((2, 2), np.float16)), None]),
    lambda a: {"x": a(np.zeros(7, np.int32)), "y": (a(np.zeros((), np.float64)),)},
    lambda a: 3.5,
    lambda a: [b"abcd", "xyz", {"k": a(np.zeros(2, np.uint8))}],
    lambda a: None,
]


@pytest.mark.parametrize("nest", _NESTS)
def test_payload_sizes_match_jax(nest):
    j, t = nest(np.asarray), nest(torch.from_numpy)
    assert tpay.payload_nbytes(t) == jpay.payload_nbytes(j)
    assert tpay.payload_size_estimate(t) == jpay.payload_size_estimate(j)


def _monitoring_sequence(mon, spc, a):
    out = []

    def fn(comm, x, op, root=0):
        out.append((op, root))
        return x

    wrapped = mon.wrap("reduce", fn, "c7")
    wrapped(None, a(np.zeros(6, np.float32)), "sum", root=1)
    wrapped(None, (a(np.zeros(2, np.int32)), a(np.zeros(2, np.int32))), "min")
    return out, spc.snapshot(), wrapped.__name__, mon.enabled()


def test_monitoring_matches_jax():
    assert (_monitoring_sequence(tmon, tspc, torch.from_numpy)
            == _monitoring_sequence(jmon, jspc, np.asarray))


def test_monitoring_interposes_on_the_composed_table(tmp_path, monkeypatch):
    """With ``coll_monitoring_enable`` set, a communicator's table counts
    every collective, whichever component won it."""
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.mca import var as mca_var

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    mca_var.set_var("coll_monitoring_enable", True)
    try:
        comm = zmpi.Communicator(name="mon")
        comm.allreduce(torch.ones(4))
        comm.allreduce(torch.ones(2, dtype=torch.float64))
        comm.bcast(torch.ones(3))
        assert all(fn.__name__.startswith("monitored_")
                   for fn, _ in comm.coll.values())
        assert {k: v for k, v in tspc.snapshot().items()
                if k.startswith(("coll_", "comm_mon"))} == {
            "coll_allreduce_calls": 2, "coll_allreduce_bytes": 32,
            "coll_bcast_calls": 1, "coll_bcast_bytes": 12,
            "comm_mon_coll_calls": 3}
    finally:
        mca_var.unset("coll_monitoring_enable")
        dist.destroy_process_group()
    assert not tmon.enabled()
