"""The port's resident runtime (``runtime/dvm.py``) and its routed daemon
tree (``runtime/dvmtree.py``) against the JAX package's.

- **pure planners**: ``plan_tree`` (fanout -1 to 3, 1 to 9 daemons) and
  ``block_placement`` give the namesake's outputs on one table of inputs.
- **routed store**: the namesake's ``TestRoutedStore`` run on each
  package (``P`` is the package's namespace): writes forward up, reads
  cache at the leaf, generation bumps invalidate, lookups never cache,
  first readers single-flight; plus the port's ``RoutedStore`` in front
  of a JAX-package ``PmixServer``.
- **in-process daemons, thread-fast**: the namesake's ``TestTreeLaunch``,
  ``TestDaemonFaultThreadFast`` and ``TestElasticResize`` on the port's
  daemons with port jobs (real rank processes that ``import
  zhpe_ompi_tpu_torch``).
- **mixed daemons**: the port's ``Dvm`` launches a JAX-package job, and
  the JAX package's ``Dvm`` launches a port job; each job modexes through
  the store and reaches a 4-rank allreduce.
- **slow, real daemon processes** (marked ``slow`` as the namesake's
  are): the kill-a-daemon drill and the resize under traffic over a tree
  of ``python -m zhpe_ompi_tpu_torch.runtime.dvm --parent`` processes.

An autouse fixture checks after each test that no port daemon, PMIx
server, routed-store cache, admission ticket, placement-audit failure,
metrics publisher or namespace is left.  The daemon *processes* a test
starts are checked by their pids: other test processes' daemons are
host-wide.
"""

import io
import os
import signal
import textwrap
import threading
import time
import types

import pytest

from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu.runtime import dvm as jdvm
from zhpe_ompi_tpu.runtime import dvmtree as jdvmtree
from zhpe_ompi_tpu.runtime import pmix as jpmix
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.runtime import dvm as tdvm
from zhpe_ompi_tpu_torch.runtime import dvmtree as tdvmtree
from zhpe_ompi_tpu_torch.runtime import pmix as tpmix
from zhpe_ompi_tpu_torch.runtime import spc as tspc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(name="jax", dvm=jdvm, dvmtree=jdvmtree,
                            pmix=jpmix, spc=jspc, errors=jerrors, var=jvar)
PORT = types.SimpleNamespace(name="port", dvm=tdvm, dvmtree=tdvmtree,
                             pmix=tpmix, spc=tspc, errors=terrors, var=tvar)
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])

#: the ft launch's heartbeat window, as in the namesake's drills: only
#: the daemon's own fault routing can classify a death in time
FT_MCA = [("ft_detector_period", "2.0"), ("ft_detector_timeout", "60.0")]


def _port_runtime_leftovers() -> list[str]:
    from zhpe_ompi_tpu_torch.models import inferloop as til

    return (tdvm.live_dvms() + tdvm.live_metrics_listeners()
            + tdvm.queued_admission_tickets()
            + tdvmtree.stale_cache_state()
            + tdvmtree.placement_audit_failures()
            + tpmix.live_servers() + tpmix.stale_namespaces()
            + tspc.live_publisher_threads()
            + til.live_worker_threads() + til.parked_tickets())


@pytest.fixture(autouse=True)
def _port_runtime_hygiene():
    yield
    deadline = time.monotonic() + 5.0
    while _port_runtime_leftovers() and time.monotonic() < deadline:
        time.sleep(0.05)  # a stopping daemon's threads wind down
    assert _port_runtime_leftovers() == []
    assert jdvm.live_dvms() == [] and jpmix.live_servers() == []


def script(tmp_path, body: str, name: str = "prog.py") -> str:
    p = tmp_path / name
    p.write_text("import sys\n" f"sys.path.insert(0, {REPO!r})\n"
                 + textwrap.dedent(body))
    return str(p)


def bg_launch(addr, n, argv, dvm=tdvm, **kw):
    """Launch ``argv`` on ``n`` ranks from a background thread: the
    handle's ``res`` gets ``rc`` (or ``error``) when the job ends."""
    cli = dvm.DvmClient(addr)
    out, err, res = io.StringIO(), io.StringIO(), {}
    kw.setdefault("timeout", 120.0)

    def run():
        try:
            res["rc"] = cli.launch(n, argv, stdout=out, stderr=err, **kw)
        except Exception as e:  # noqa: BLE001 - surfaced by finish()
            res["error"] = str(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return {"cli": cli, "thread": t, "out": out, "err": err, "res": res}


def finish(h, timeout=150.0):
    h["thread"].join(timeout=timeout)
    assert not h["thread"].is_alive(), (h["out"].getvalue(),
                                        h["err"].getvalue())
    h["cli"].close()
    return h["res"]


def wait_for(pred, timeout=60.0, msg="condition never held"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, msg() if callable(msg) else msg
        time.sleep(0.02)


# --------------------------------------------------------------- planning


def test_plan_tree_matches_namesake():
    for fanout in (-1, 0, 1, 2, 3):
        for n in range(1, 10):
            assert tdvmtree.plan_tree(n, fanout) == \
                jdvmtree.plan_tree(n, fanout), (n, fanout)
    assert tdvmtree.plan_tree(7, fanout=2) == [None, 0, 0, 1, 1, 2, 2]


def test_plan_tree_default_rides_mca_var():
    tvar.set_var("dvm_tree_fanout", 3)
    try:
        assert tdvmtree.plan_tree(5) == [None, 0, 0, 0, 1]
    finally:
        tvar.unset("dvm_tree_fanout")


@pytest.mark.parametrize("nranks", [0, 1, 2, 4, 6, 7, 9])
def test_block_placement_matches_namesake(nranks):
    for daemons in (["a"], ["a", "b"], ["a", "b", "c"], list("abcdefg")):
        got = tdvmtree.block_placement(list(range(nranks)), daemons)
        assert got == jdvmtree.block_placement(list(range(nranks)), daemons)
    with pytest.raises(terrors.MpiError):
        tdvmtree.block_placement([0, 1], [])


# ----------------------------------------------------------- routed store


def _pair(P, server=None):
    srv = (server or P).pmix.PmixServer()
    return srv, P.dvmtree.RoutedStore(srv.address, timeout=10.0)


@BOTH
def test_routed_forward_writes_and_cache_reads(P):
    srv, routed = _pair(P)
    try:
        f0 = P.spc.read("dvm_tree_forwards")
        h0 = P.spc.read("dvm_store_cache_hits")
        routed.ensure_ns("job", 1)
        routed.put("job", 0, "card:0", ["h", 1])
        routed.commit("job", 0)
        assert routed.get("job", "card:0", timeout=5.0) == ["h", 1]
        hits_after_miss = P.spc.read("dvm_store_cache_hits") - h0
        assert routed.get("job", "card:0", timeout=5.0) == ["h", 1]
        assert P.spc.read("dvm_store_cache_hits") - h0 == \
            hits_after_miss + 1
        assert P.spc.read("dvm_tree_forwards") > f0
        assert srv.store.get("job", "card:0", timeout=1.0) == ["h", 1]
        assert routed.cached_keys() == ["job:card:0"]
    finally:
        routed.close()
        srv.close()
    assert P.dvmtree.stale_cache_state() == []


@BOTH
def test_routed_generation_bump_invalidates(P):
    srv, routed = _pair(P)
    try:
        routed.ensure_ns("job", 1)
        routed.put("job", 0, "k", "old")
        routed.commit("job", 0)
        assert routed.get("job", "k", timeout=5.0) == "old"
        gen = srv.store.bump_generation("job")
        routed.invalidate_ns("job")
        srv.store.put("job", 0, "k", "new")
        srv.store.commit("job", 0)
        assert routed.get("job", "k", timeout=5.0,
                          min_generation=gen) == "new"
        # without the invalidation, a min_generation read still
        # bypasses a generation-old cache entry
        srv.store.bump_generation("job")
        srv.store.put("job", 0, "k", "newer")
        srv.store.commit("job", 0)
        assert routed.get_meta("job", "k", timeout=5.0,
                               min_generation=2) == ("newer", 2)
    finally:
        routed.close()
        srv.close()


@BOTH
def test_routed_lookup_never_cached(P):
    srv, routed = _pair(P)
    try:
        routed.ensure_ns("job", 1)
        routed.put("job", -1, "resize:0", {"seq": 0})
        routed.commit("job", -1)
        assert list(routed.lookup("job", "resize:")) == ["resize:0"]
        srv.store.put("job", -1, "resize:1", {"seq": 1})
        srv.store.commit("job", -1)
        assert sorted(routed.lookup("job", "resize:")) == \
            ["resize:0", "resize:1"]
        assert routed.cached_keys() == []
    finally:
        routed.close()
        srv.close()


@BOTH
def test_routed_single_flight_coalesces_first_readers(P):
    srv, routed = _pair(P)
    try:
        routed.ensure_ns("job", 4)
        g0 = P.spc.read("pmix_gets")
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(
                routed.get("job", "late", timeout=10.0)))
            for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        srv.store.put("job", 0, "late", 42)
        srv.store.commit("job", 0)
        for t in threads:
            t.join(timeout=10.0)
        assert results == [42, 42, 42, 42]
        assert P.spc.read("pmix_gets") - g0 == 1
    finally:
        routed.close()
        srv.close()


@BOTH
def test_routed_close_drops_cache(P):
    srv, routed = _pair(P)
    routed.ensure_ns("job", 1)
    routed.put("job", 0, "k", 1)
    routed.commit("job", 0)
    routed.get("job", "k", timeout=5.0)
    routed.close()
    srv.close()
    assert routed.cached_keys() == []
    assert P.dvmtree.stale_cache_state() == []
    with pytest.raises(P.errors.MpiError):
        routed.get("job", "k", timeout=0.5)


def test_port_routed_store_fronts_a_namesake_server():
    """The port's leaf cache in front of the JAX package's store: the
    wire between them is the namesake's."""
    srv, routed = _pair(PORT, server=JAX)
    try:
        routed.ensure_ns("mix", 1)
        routed.put("mix", 0, "card:0", ["h", 7])
        routed.commit("mix", 0)
        assert routed.get("mix", "card:0", timeout=5.0) == ["h", 7]
        assert routed.get("mix", "card:0", timeout=5.0) == ["h", 7]
        assert routed.cached_keys() == ["mix:card:0"]
        assert srv.store.lookup("mix") == {"card:0": ["h", 7]}
        assert routed.destroy_ns("mix")
    finally:
        routed.close()
        srv.close()


# ------------------------------------------------- in-process tree launch


def _allgather_prog(tmp_path, n, tag=""):
    return script(tmp_path, f"""
        import zhpe_ompi_tpu_torch as zmpi

        proc = zmpi.host_init()
        vals = proc.allgather(proc.rank + 1)
        assert list(vals) == list(range(1, {n} + 1)), vals
        print(f"{tag}rank {{proc.rank}} OK", flush=True)
        zmpi.host_finalize()
    """, name=f"allgather{tag}{n}.py")


def test_six_ranks_over_three_daemons(tmp_path):
    """A launch at the root places rank blocks across the tree;
    child-hosted ranks modex through their daemon's routed store."""
    tree = tdvmtree.spawn_tree(3, fanout=2, in_process=True)
    try:
        assert [n["dvm"].tree_depth for n in tree.nodes] == [0, 1, 1]
        h0 = tspc.read("dvm_store_cache_hits")
        f0 = tspc.read("dvm_tree_forwards")
        cli = tdvm.DvmClient(tree.root_address)
        out, err = io.StringIO(), io.StringIO()
        rc = cli.launch(6, [_allgather_prog(tmp_path, 6)], timeout=120.0,
                        stdout=out, stderr=err)
        assert rc == 0, (out.getvalue(), err.getvalue())
        assert out.getvalue().count("OK") == 6
        assert tspc.read("dvm_store_cache_hits") > h0
        assert tspc.read("dvm_tree_forwards") > f0
        info = cli.treeinfo()
        assert info["root"] and len(info["daemons"]) == 3
        cli.close()
    finally:
        tree.stop()


def test_depth2_chain_and_detached_leaf(tmp_path):
    """fanout=1 builds root<-mid<-leaf: a job spread over the chain
    computes; then the leaf stops in order, the root unlearns it, and the
    next launch places nothing on it."""
    tree = tdvmtree.spawn_tree(3, fanout=1, in_process=True)
    try:
        assert [n["dvm"].tree_depth for n in tree.nodes] == [0, 1, 2]
        cli = tdvm.DvmClient(tree.root_address)
        out = io.StringIO()
        rc = cli.launch(3, [_allgather_prog(tmp_path, 3)], timeout=120.0,
                        stdout=out, stderr=io.StringIO())
        assert rc == 0, out.getvalue()
        assert out.getvalue().count("OK") == 3
        tree.nodes[2]["dvm"].stop()
        wait_for(lambda: len(cli.treeinfo()["daemons"]) == 2, 10.0,
                 lambda: cli.treeinfo())
        out = io.StringIO()
        rc = cli.launch(2, [_allgather_prog(tmp_path, 2)], timeout=120.0,
                        stdout=out, stderr=io.StringIO())
        assert rc == 0, out.getvalue()
        assert out.getvalue().count("OK") == 2
        cli.close()
    finally:
        tree.stop()


@BOTH
def test_launch_must_target_root_and_child_relays(P, tmp_path):
    tree = P.dvmtree.spawn_tree(2, in_process=True)
    try:
        child = P.dvm.DvmClient(tree.addresses()[1])
        with pytest.raises(P.errors.MpiError, match="must target the ROOT"):
            child.launch(1, [str(tmp_path / "x.py")], timeout=30.0,
                         stdout=io.StringIO(), stderr=io.StringIO())
        info = child.treeinfo()
        assert info["depth"] == 1 and not info["root"]
        stat = child.stat()  # relayed: the root's job table
        assert stat["jobs"] == {} and len(stat["daemons"]) == 2
        child.close()
    finally:
        tree.stop()


@BOTH
def test_launch_validation(P):
    d = P.dvm.Dvm()
    try:
        cli = P.dvm.DvmClient(d.address)
        msgs = []
        for call in (
                lambda: cli.launch(1, ["/bin/true"], ft=True, max_size=2,
                                   timeout=30.0, stdout=io.StringIO(),
                                   stderr=io.StringIO()),
                lambda: cli.resize("job999", 2),
                lambda: cli.launch(1, ["x.py"], max_size=2, timeout=30.0,
                                   stdout=io.StringIO(),
                                   stderr=io.StringIO()),
                lambda: cli.launch(3, ["x.py"], ft=True, max_size=2,
                                   timeout=30.0, stdout=io.StringIO(),
                                   stderr=io.StringIO())):
            with pytest.raises(P.errors.MpiError) as e:
                call()
            msgs.append(str(e.value))
        assert "Python-only" in msgs[0] and "unknown job" in msgs[1]
        assert "ft=True" in msgs[2] and "below n" in msgs[3]
        assert cli.ping() is True
        cli.close()
    finally:
        d.stop()


def test_concurrent_launches_one_daemon(tmp_path):
    progs = [_allgather_prog(tmp_path, 2, tag=f"J{i} ") for i in range(2)]
    d = tdvm.Dvm()
    try:
        hs = [bg_launch(d.address, 2, [progs[i]]) for i in range(2)]
        ids = set()
        for i, h in enumerate(hs):
            assert finish(h) == {"rc": 0}, h["err"].getvalue()
            ids.add(h["cli"].last_job_id)
            assert h["out"].getvalue().count(f"J{i} rank") == 2
        assert len(ids) == 2
    finally:
        d.stop()


# --------------------------------------------------- fault routing (fast)


_FAULT_PROG = """
import os
import time

import torch

import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch.runtime import pmix as pmix_mod

victims = set(int(r) for r in sys.argv[1].split(","))
proc = zmpi.host_init()
proc.barrier()
print(f"READY rank={proc.rank}", flush=True)
if proc.rank in victims:
    # a victim idles until its daemon's death takes it (the lifeline)
    time.sleep(120.0)
    raise SystemExit(0)
deadline = time.monotonic() + 30.0
while time.monotonic() < deadline:
    if all(proc.ft_state.is_failed(v) for v in victims):
        break
    time.sleep(0.01)
else:
    print(f"TIMEOUT rank={proc.rank}", flush=True)
    raise SystemExit(1)
ts = time.time()
causes = sorted(set(proc.ft_state.cause_of(v) for v in victims))
# the store still serves through this rank's surviving daemon
addr, ns = os.environ["ZMPI_PMIX"].rsplit("/", 1)
cli = pmix_mod.PmixClient(addr, timeout=10.0)
assert cli.get(ns, "card:0", timeout=10.0)
cli.close()
proc.failure_ack()
sh = proc.shrink()
total = float(sh.allreduce(torch.tensor(float(proc.rank), dtype=torch.float64),
                           zmpi.SUM))
print(f"SURVIVOR-OK rank={proc.rank} ts={ts:.3f} "
      f"causes={','.join(causes)} total={total}", flush=True)
zmpi.host_finalize()
"""


def _parse_survivors(text):
    import re

    return re.findall(r"SURVIVOR-OK rank=(\d+) ts=([\d.]+) causes=([\w,-]+) "
                      r"total=([\d.-]+)", text)


def test_child_link_loss_classifies_subtree(tmp_path):
    """Severing a child's parent link without a detach is a daemon death
    to the root: the subtree's ranks are marked failed
    (cause="daemon-tree") on every survivor, which shrink and compute."""
    prog = script(tmp_path, _FAULT_PROG)
    tree = tdvmtree.spawn_tree(2, in_process=True)
    try:
        h = bg_launch(tree.root_address, 4, [prog, "2,3"], ft=True,
                      mca=FT_MCA)
        wait_for(lambda: h["out"].getvalue().count("READY") == 4, 90.0,
                 lambda: (h["out"].getvalue(), h["err"].getvalue()))
        t_cut = time.time()
        tree.nodes[1]["dvm"]._parent_link.close()
        res = finish(h)
        text = h["out"].getvalue()
        survivors = _parse_survivors(text)
        assert len(survivors) == 2, (text, h["err"].getvalue())
        for rank, ts, causes, total in survivors:
            assert int(rank) in (0, 1) and causes == "daemon-tree"
            assert float(ts) - t_cut < 2.0
            assert float(total) == 1.0
        assert res == {"rc": 137}
    finally:
        tree.stop()


# ------------------------------------------------- elastic resize (fast)


ELASTIC_PROG = """
import os
import time

import torch

import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch.ft import recovery

ep = zmpi.host_init()
ses = recovery.ElasticSession(ep)
deadline = time.monotonic() + float(os.environ.get("TEST_ELASTIC_S", "30"))
stop_after = int(os.environ.get("TEST_ELASTIC_STOP_AFTER", "999"))
resizes = 0
while True:
    n = ses.live.size
    want_stop = 1.0 if (time.monotonic() > deadline
                        or resizes >= stop_after) else 0.0
    out = ses.live.allreduce(torch.tensor([1.0, want_stop],
                                          dtype=torch.float64), zmpi.SUM)
    assert float(out[0]) == n, (out, n)
    if float(out[1]) > 0:
        break
    act = ses.step()
    if act in ("retire", "halt"):
        print(f"RETIRE rank={ep.rank}", flush=True)
        break
    if act == "resized":
        resizes += 1
        print(f"RESIZED rank={ep.rank} live={ses.live.size}", flush=True)
ses.close()
zmpi.host_finalize()
"""


def run_elastic(tmp_path, daemon_addr, n, max_size, resizes):
    """Launch the elastic worker, apply ``resizes`` (a list of new sizes)
    from a second client; returns (rc, stdout, stderr, events)."""
    h = bg_launch(daemon_addr, n, [script(tmp_path, ELASTIC_PROG)],
                  ft=True, max_size=max_size, timeout=180.0, mca=FT_MCA)
    ctl = tdvm.DvmClient(daemon_addr)
    try:
        wait_for(lambda: ctl.stat()["jobs"], 60.0, lambda: h["err"].getvalue())
        job_id = next(iter(ctl.stat()["jobs"]))
        events, live = [], n
        for new_n in resizes:
            wait_for(lambda: ctl.stat()["jobs"][job_id]["live"] == live,
                     90.0, lambda: (ctl.stat(), h["out"].getvalue(),
                                    h["err"].getvalue()))
            time.sleep(1.0)  # a few allreduce iterations in between
            events.append(ctl.resize(job_id, new_n, timeout=90.0))
            live = new_n
    finally:
        ctl.close()
        res = finish(h, 200.0)
    return res.get("rc"), h["out"].getvalue(), h["err"].getvalue(), events


def test_grow_then_shrink_under_allreduce(tmp_path, monkeypatch):
    """2 -> 4 -> 2 while an allreduce loop runs; every generation's
    collectives stay correct (the worker asserts sum == live size)."""
    monkeypatch.setenv("TEST_ELASTIC_S", "60")
    monkeypatch.setenv("TEST_ELASTIC_STOP_AFTER", "2")
    r0 = tspc.read("dvm_resizes")
    d = tdvm.Dvm()
    try:
        rc, out, err, events = run_elastic(tmp_path, d.address, n=2,
                                           max_size=4, resizes=[4, 2])
        assert rc == 0, (out, err)
        assert events[0]["grown"] == [2, 3]
        assert events[1]["retired"] == [2, 3]
        assert events[0]["generation"] == events[1]["generation"] == 1
        assert events[0]["seq"] == 0 and events[1]["seq"] == 1
        assert out.count("RESIZED rank=0 live=4") == 1, out
        assert out.count("RESIZED rank=0 live=2") == 1, out
        assert out.count("RETIRE") == 2, out
        assert tspc.read("dvm_resizes") - r0 == 2
    finally:
        d.stop()


# ----------------------------------------------------------- mixed daemons


_MIXED_PROG = {
    "port": """
        import torch
        import zhpe_ompi_tpu_torch as zmpi

        p = zmpi.host_init()
        total = p.allreduce(torch.tensor([float(p.rank + 1)]), zmpi.SUM)
        print(f"MIXED rank={p.rank} size={p.size} total={float(total[0])}",
              flush=True)
        zmpi.host_finalize()
    """,
    "jax": """
        import numpy as np
        import zhpe_ompi_tpu as zmpi
        from zhpe_ompi_tpu import ops

        p = zmpi.host_init()
        total = p.allreduce(np.array([float(p.rank + 1)]), ops.SUM)
        print(f"MIXED rank={p.rank} size={p.size} total={float(total[0])}",
              flush=True)
        zmpi.host_finalize()
    """,
}


@pytest.mark.parametrize("daemon,job", [("port", "jax"), ("jax", "port")])
def test_mixed_daemon_and_job(tmp_path, daemon, job):
    """One package's daemon hosts the other package's job: the ranks
    modex through the daemon's store (the store verbs and the control
    frames are the namesake's) and reach a 4-rank allreduce."""
    D = PORT if daemon == "port" else JAX
    prog = script(tmp_path, _MIXED_PROG[job], name=f"mixed_{job}.py")
    g0 = D.spc.read("pmix_gets")
    d = D.dvm.Dvm()
    try:
        cli = D.dvm.DvmClient(d.address)
        out, err = io.StringIO(), io.StringIO()
        rc = cli.launch(4, [prog], timeout=120.0, stdout=out, stderr=err)
        assert rc == 0, (out.getvalue(), err.getvalue())
        lines = sorted(l.split("] ", 1)[1] for l in
                       out.getvalue().splitlines() if "MIXED" in l)
        assert lines == [f"MIXED rank={r} size=4 total=10.0"
                         for r in range(4)]
        stat = cli.stat()
        assert stat["dvm_jobs_launched"] >= 1 and stat["pmix"] == {}
        assert D.spc.read("pmix_gets") - g0 == 16  # 4 ranks x 4 cards
        cli.stop()
        cli.close()
    finally:
        d.stop()


# ------------------------------------------- real daemon processes (slow)


def _own_daemons_gone(tree):
    procs = [n["proc"] for n in tree.nodes if n.get("proc") is not None]
    deadline = time.monotonic() + 10.0
    while any(p.poll() is None for p in procs) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    return all(p.poll() is not None for p in procs)


@pytest.mark.slow
def test_sigkill_leaf_daemon(tmp_path):
    """A 3-daemon tree of port daemon processes hosts a 6-rank ft job;
    SIGKILL of a leaf daemon kills its two ranks through the lifeline,
    every survivor classifies exactly those (cause="daemon-tree") in
    < 2 s, and the survivors shrink and allreduce."""
    prog = script(tmp_path, _FAULT_PROG)
    tree = tdvmtree.spawn_tree(3, fanout=2, in_process=False)
    try:
        h = bg_launch(tree.root_address, 6, [prog, "4,5"], ft=True,
                      timeout=180.0, mca=FT_MCA)
        wait_for(lambda: h["out"].getvalue().count("READY") == 6, 90.0,
                 lambda: (h["out"].getvalue(), h["err"].getvalue()))
        ctl = tdvm.DvmClient(tree.root_address)
        job_id = next(iter(ctl.stat()["jobs"]))
        victim_pids = [p for r, p in ctl.pids(job_id).items() if r in (4, 5)]
        assert len(victim_pids) == 2
        t_kill = time.time()
        tree.kill_node(2, signal.SIGKILL)
        res = finish(h, 150.0)
        survivors = _parse_survivors(h["out"].getvalue())
        assert len(survivors) == 4, (h["out"].getvalue(), h["err"].getvalue())
        for rank, ts, causes, total in survivors:
            assert causes == "daemon-tree"
            assert float(ts) - t_kill < 2.0
            assert float(total) == 6.0
        assert res == {"rc": 137}
        wait_for(lambda: not any(os.path.exists(f"/proc/{p}")
                                 for p in victim_pids), 5.0,
                 "victim ranks outlived their daemon")
        ctl.close()
    finally:
        tree.stop()
    assert _own_daemons_gone(tree)


@pytest.mark.slow
def test_grow_shrink_over_tree_of_daemon_processes(tmp_path, monkeypatch):
    """Resize under traffic over port daemon processes: 4 -> 6 -> 3."""
    monkeypatch.setenv("TEST_ELASTIC_S", "90")
    monkeypatch.setenv("TEST_ELASTIC_STOP_AFTER", "2")
    tree = tdvmtree.spawn_tree(2, in_process=False)
    try:
        rc, out, err, _ = run_elastic(tmp_path, tree.root_address, n=4,
                                      max_size=6, resizes=[6, 3])
        assert rc == 0, (out, err)
        assert out.count("RESIZED rank=0 live=6") == 1, out
        assert out.count("RESIZED rank=0 live=3") == 1, out
        assert out.count("RETIRE") == 3, out
    finally:
        tree.stop()
    assert _own_daemons_gone(tree)
