"""The port's fleet-visible metrics plane against the JAX package's: the
rank-side ``spc.MetricsPublisher`` (``runtime/spc.py``), ``TcpProc``'s
``metrics=``/``trace=`` contract (``pt2pt/tcp.py``), and the daemon's
``metrics`` RPC and Prometheus scrape endpoint (``runtime/dvm.py``).

- ``TestPublisher``: the interval floor, the final flush at close (every
  documented counter zero-filled into each snapshot), the crash path
  without a final flush, the trace buffer shipped beside the snapshot,
  and the error contract (explicit ``metrics=True``/``trace=True``
  without a store raise ``ArgError``; the environment requests degrade
  loudly) — each in both packages where it applies.
- ``TestDvmMetricsRpc`` and ``TestMetricsHttp``: per-rank, per-job and
  aggregate views of port ranks' snapshots, and the exposition format.
- One snapshot's Prometheus text and aggregate view are equal between
  the two packages' daemons.

- The namesake's slow end-to-end drill with port ranks: a kill -9 and
  the survivors' flight-recorder windows and scrape (``slow``, as the
  namesake's is).

The snapshots' ``pvars`` table carries the registered state pvars
(``tools/mpit.py``), as the namesake's does.  The autouse hygiene fixture is ``test_torch_dvm_tree``'s.
"""

import re
import socket
import threading
import time

import pytest
import torch

from test_torch_dvm_tree import JAX, PORT
from test_torch_dvm_tree import _port_runtime_hygiene  # noqa: F401 - autouse
from zhpe_ompi_tpu.pt2pt import tcp as jtcp
from zhpe_ompi_tpu_torch.pt2pt import tcp as ttcp
from zhpe_ompi_tpu_torch.runtime import dvm as tdvm
from zhpe_ompi_tpu_torch.runtime import pmix as tpmix
from zhpe_ompi_tpu_torch.runtime import spc as tspc

TCP = {"jax": jtcp, "port": ttcp}


def run_metrics_job(dvm, n=2, ns="jobmet", trace=False):
    """n port ``TcpProc`` ranks in threads, modexed through the daemon's
    store with the publisher armed; returns once every rank closed (the
    final flush published)."""
    pmix_addr = ("127.0.0.1", dvm.pmix.address[1])
    excs = [None] * n

    def main(rank):
        try:
            proc = ttcp.TcpProc(rank, n, pmix=pmix_addr, namespace=ns,
                                metrics=True, trace=trace, sm=False)
            try:
                proc.send(torch.arange(64.0), dest=(rank + 1) % n, tag=3)
                proc.recv(source=(rank - 1) % n, tag=3)
                proc.barrier()
            finally:
                proc.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            excs[rank] = e

    threads = [threading.Thread(target=main, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "metrics job rank hung"
    for e in excs:
        if e is not None:
            raise e


# ================================ publisher =================================


@pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])
def test_interval_floor_is_hard(P):
    held = P.var.get("spc_publish_interval_ms")
    P.var.set_var("spc_publish_interval_ms", 50)
    d = P.dvm.Dvm()
    try:
        pub = P.spc.MetricsPublisher(("127.0.0.1", d.pmix.address[1]),
                                     "default", 0)
        assert pub.interval == P.spc.PUBLISH_FLOOR_S == 0.25
        pub.stop()  # never started: releases its client socket
    finally:
        d.stop()
        P.var.set_var("spc_publish_interval_ms", held)
    assert P.spc.live_publisher_threads() == []


def test_publish_final_flush_and_hygiene():
    d = tdvm.Dvm()
    pubs0 = tspc.read("spc_publishes")
    try:
        run_metrics_job(d, n=2, ns="jobflush")
        entries = d.store.lookup("jobflush", "metrics:")
        assert set(entries) == {"metrics:jobflush:0", "metrics:jobflush:1"}
        for payload in entries.values():
            assert payload["final"] is True
            assert payload["interval_ms"] >= 250
            assert not tspc.documented_counters() - set(payload["counters"])
            assert payload["counters"]["tcp_bytes_sent"] > 0
            assert payload["counters"]["spc_publishes"] >= 1
            # state pvars ride the snapshot
            assert "tcp_posted_recvs" in payload["pvars"]
            assert payload["watermark"] == sorted(
                n for n in payload["counters"] if n in tspc.WATERMARK)
        assert tspc.read("spc_publishes") - pubs0 >= 2
        assert tspc.live_publisher_threads() == []
        d.store.destroy_ns("jobflush")
        assert tpmix.stale_metric_keys() == []
    finally:
        d.stop()


def test_trace_buffer_ships_beside_the_snapshot():
    d = tdvm.Dvm()
    try:
        run_metrics_job(d, n=2, ns="jobtrace", trace=True)
        traces = d.store.lookup("jobtrace", "trace:")
        assert set(traces) == {"trace:jobtrace:0", "trace:jobtrace:1"}
        for key, buf in traces.items():
            assert buf["rank"] == int(key.rsplit(":", 1)[1])
            assert buf["spans"], buf
        d.store.destroy_ns("jobtrace")
    finally:
        d.stop()


def test_sever_kills_publisher_without_final_flush():
    d = tdvm.Dvm()
    try:
        proc = ttcp.TcpProc(0, 1, pmix=("127.0.0.1", d.pmix.address[1]),
                            namespace="jobsev", metrics=True, sm=False)
        deadline = time.monotonic() + 10.0
        while not d.store.lookup("jobsev", "metrics:") \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        proc.sever()
        proc.close()
        assert tspc.live_publisher_threads() == []
        payload = d.store.lookup("jobsev", "metrics:")["metrics:jobsev:0"]
        assert payload["final"] is False
        d.store.destroy_ns("jobsev")
    finally:
        d.stop()


@pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])
def test_metrics_and_trace_contracts(P, monkeypatch):
    tcp = TCP[P.name]
    msgs = []
    for kwargs in (dict(metrics=True), dict(trace=True),
                   dict(trace=True, metrics=False)):
        with pytest.raises(P.errors.ArgError) as e:
            tcp.TcpProc(0, 1, sm=False, **kwargs)
        msgs.append(str(e.value))
    assert "ZMPI_PMIX contract" in msgs[0] and "ZMPI_TRACE" in msgs[1]
    monkeypatch.setenv("ZMPI_METRICS", "1")
    monkeypatch.setenv("ZMPI_TRACE", "1")
    proc = tcp.TcpProc(0, 1, sm=False)  # coordinator modex, no store
    try:
        assert proc._metrics_pub is None
        assert not proc._metrics_on and not proc._trace_on
    finally:
        proc.close()


# ============================ daemon metrics RPC ============================


def test_per_rank_job_and_aggregate_views():
    d = tdvm.Dvm()
    try:
        run_metrics_job(d, n=2, ns="jobrpc")
        cli = tdvm.DvmClient(d.address)
        try:
            view = cli.metrics("jobrpc")
            assert view["job"] == "jobrpc" and set(view["ranks"]) == {0, 1}
            for rec in view["ranks"].values():
                assert rec["staleness_s"] >= 0.0
            assert view["aggregate"]["tcp_bytes_sent"] == sum(
                r["counters"]["tcp_bytes_sent"]
                for r in view["ranks"].values())
            assert cli.metrics("jobrpc", 1)["counters"] == \
                view["ranks"][1]["counters"]
            with pytest.raises(PORT.errors.MpiError, match="rank 7"):
                cli.metrics("jobrpc", 7)
            with pytest.raises(PORT.errors.MpiError, match="no metrics"):
                cli.metrics("no_such_job")
        finally:
            cli.close()
        d.store.destroy_ns("jobrpc")
    finally:
        d.stop()


_PROM_LINE = re.compile(r'^(zmpi_[a-z0-9_]+)\{job="([^"]+)",rank="(\d+)"\} '
                        r'(-?\d+(?:\.\d+)?)$')


def _http_get(addr, path="/metrics"):
    s = socket.create_connection(addr, 5.0)
    try:
        s.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    finally:
        s.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return head.decode(), body.decode()


def test_scrape_endpoint_prometheus_exposition():
    d = tdvm.Dvm(metrics_port=0)
    try:
        assert d.metrics_http is not None
        run_metrics_job(d, n=2, ns="jobhttp")
        head, body = _http_get(d.metrics_http.address)
        assert "200 OK" in head
        samples, families = {}, []
        for line in body.splitlines():
            if line.startswith("#"):
                assert line.startswith("# TYPE zmpi_")
                continue
            m = _PROM_LINE.match(line)
            assert m, f"unparseable exposition line: {line!r}"
            samples[(m.group(1), m.group(2), m.group(3))] = m.group(4)
            if not families or families[-1] != m.group(1):
                families.append(m.group(1))
        assert len(families) == len(set(families))
        for rank in ("0", "1"):
            for c in tspc.documented_counters():
                assert (f"zmpi_spc_{c}", "jobhttp", rank) in samples
            assert ("zmpi_metrics_age_seconds", "jobhttp", rank) in samples
        assert "404" in _http_get(d.metrics_http.address, "/nope")[0]
        d.store.destroy_ns("jobhttp")
    finally:
        d.stop()
    assert tdvm.live_metrics_listeners() == []
    off = tdvm.Dvm()
    try:
        assert off.metrics_http is None  # off by default
    finally:
        off.stop()


def _snapshot(rank):
    counters = {"tcp_bytes_sent": 100 + rank, "dvm_queue_wait_ms": 7 * rank,
                "comm_my-comm_coll_calls": 3, "infer_requests_served": rank}
    return {"seq": 1, "t": time.time() + 3600.0, "interval_ms": 1000,
            "final": True, "counters": counters,
            "watermark": ["dvm_queue_wait_ms"], "pvars": {}}


def test_prometheus_text_and_views_match_namesake():
    """The same published snapshots in both packages' daemons give the
    same exposition text and the same metrics views."""
    got = {}
    for P in (JAX, PORT):
        d = P.dvm.Dvm()
        try:
            d.store.ensure_ns('job"x', 2)
            for r in range(2):
                d.store.put('job"x', r, f'metrics:job"x:{r}', _snapshot(r))
                d.store.commit('job"x', r)
            view = d._metrics_view('job"x')
            got[P.name] = (d.prometheus(), view["aggregate"],
                           sorted(view["ranks"]))
            d.store.destroy_ns('job"x')
        finally:
            d.stop()
    assert got["port"] == got["jax"]
    text = got["port"][0]
    assert 'zmpi_spc_comm_my_comm_coll_calls{job="job\\"x",rank="1"} 3' in text
    assert "# TYPE zmpi_spc_dvm_queue_wait_ms gauge" in text
    assert got["port"][1]["tcp_bytes_sent"] == 201
    assert got["port"][1]["dvm_queue_wait_ms"] == 7


# ===================== end-to-end acceptance (slow) ========================


_E2E_PROG = '''
import os, signal, sys
sys.path.insert(0, {repo!r})
import torch
import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch.runtime.pmix import PmixClient

VICTIM = int(os.environ["TEST_VICTIM"])
proc = zmpi.host_init()
rank, job = proc.rank, os.environ["ZMPI_JOB"]
proc.barrier()
# survivor-to-survivor traffic so every ring has send/recv/match events
peer = {{0: 1, 1: 0, 2: 3, 3: 2}}[rank]
proc.send(torch.arange(32.0) * rank, dest=peer, tag=5)
got = proc.recv(source=peer, tag=5)
proc.barrier()
if rank == VICTIM:
    os.kill(os.getpid(), signal.SIGKILL)
assert proc.ft_state.wait_failed(VICTIM, timeout=15.0), "no classification"
# park until the parent has read the published windows out of the store
cl = PmixClient(os.environ["ZMPI_PMIX"].rsplit("/", 1)[0])
try:
    cl.get(job, "release", timeout=60.0)
finally:
    cl.close()
print(f"SURVIVOR-OK rank={{rank}} sum={{float(got.sum())}}", flush=True)
zmpi.host_finalize()
'''


@pytest.mark.slow
def test_kill9_survivor_windows_and_scrape(tmp_path, monkeypatch):
    """TestMetricsPlaneEndToEnd's counterpart: a daemon-launched 4-rank ft
    port job publishes metrics; the metrics RPC and ``GET /metrics`` serve
    every documented counter per rank; after a kill -9 each survivor's
    flight-recorder window lands in the store with the daemon's
    classification of the victim as its tail entry."""
    import io
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = tmp_path / "metrics_e2e.py"
    prog.write_text(_E2E_PROG.format(repo=repo))
    victim = 2
    monkeypatch.setenv("TEST_VICTIM", str(victim))
    d = tdvm.Dvm(metrics_port=0)
    try:
        cli = tdvm.DvmClient(d.address)
        out, err, result = io.StringIO(), io.StringIO(), {}

        def run_job():
            result["rc"] = cli.launch(
                4, [str(prog)], ft=True, metrics=True, timeout=120.0,
                mca=[("ft_detector_period", "2.0"),
                     ("ft_detector_timeout", "60.0"),
                     ("spc_publish_interval_ms", "50")],
                stdout=out, stderr=err)

        t = threading.Thread(target=run_job, daemon=True)
        base_puts = tspc.read("pmix_puts")
        t.start()
        deadline = time.monotonic() + 60.0
        while cli.last_job_id is None and time.monotonic() < deadline:
            time.sleep(0.1)
        job = cli.last_job_id
        assert job, err.getvalue()
        survivors = sorted({0, 1, 2, 3} - {victim})
        view, poll = None, tdvm.DvmClient(d.address)
        try:
            while time.monotonic() < deadline:
                try:
                    view = poll.metrics(job)
                except PORT.errors.MpiError:
                    view = None
                if view is not None and all(
                        "flightrec" in view["ranks"].get(r, {})
                        for r in survivors):
                    break
                time.sleep(0.25)
        finally:
            poll.close()
        assert view is not None, (out.getvalue(), err.getvalue())
        doc = tspc.documented_counters()
        for r in survivors:
            rec = view["ranks"][r]
            assert not doc - set(rec["counters"])
            assert rec["counters"]["spc_publishes"] >= 1
            assert rec["interval_ms"] >= 250
            assert rec["flightrec"]["anchor_mono_ns"] > 0
            window = rec["flightrec"]["events"]
            assert window[-1]["type"] == "ft_class"
            assert window[-1]["rank"] == victim
            assert window[-1]["cause"] == "daemon"
            assert {"send", "recv"} <= {e["type"] for e in window}
        head, body = _http_get(d.metrics_http.address)
        assert "200 OK" in head
        for r in survivors:
            for c in sorted(doc):
                pat = f'zmpi_spc_{c}{{job="{job}",rank="{r}"}} '
                assert any(line.startswith(pat) for line in body.splitlines())
        d.store.put(job, 99, "release", True)
        d.store.commit(job, 99)
        t.join(90)
        assert not t.is_alive(), "job never exited"
        assert result["rc"] == 137, (out.getvalue(), err.getvalue())
        assert len(re.findall(r"SURVIVOR-OK rank=(\d+)", out.getvalue())) == 3
        assert tspc.read("pmix_puts") - base_puts > 4
        deadline = time.monotonic() + 5.0
        while tpmix.stale_metric_keys() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert tpmix.stale_metric_keys() == []
        cli.stop()
        cli.close()
    finally:
        d.stop()
