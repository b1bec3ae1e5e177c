"""The port's multi-tenant daemon (``runtime/dvm.py``'s admission queue,
``runtime/dvmtree.py``'s placement ladder and audit) against the JAX
package's.

- **unit, both packages** (``P`` is the package's namespace): the
  namesake's admission-queue cases (no cap, FIFO under a cap with the
  position callbacks, priority reordering, the dead-client reap, close
  under a waiter), the placement audit's typed violations and the sweep
  isolation.  The placement ladder (``place_job`` over pack, spread,
  exclusive, an oversubscribed tree and its typed errors) and the
  admission order are compared between the packages on one table of
  inputs.
- **in-process daemons, thread-fast, port only**: the namesake's
  ``TestAdmissionDaemon`` and ``TestPlacementDaemon`` on the port's
  daemons; their rank programs are bare scripts (admission and placement
  are daemon-side machinery).
- **slow** (as the namesake's): the two-tenant drill with port ranks.

The autouse hygiene fixture is ``test_torch_dvm_tree``'s.
"""

import os
import socket
import threading
import time

import pytest

from test_torch_dvm_tree import JAX, PORT, bg_launch, finish, script, wait_for
from test_torch_dvm_tree import _port_runtime_hygiene  # noqa: F401 - autouse
from zhpe_ompi_tpu_torch.runtime import dvm as tdvm
from zhpe_ompi_tpu_torch.runtime import dvmtree as tdvmtree
from zhpe_ompi_tpu_torch.runtime import spc as tspc

BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])


@pytest.fixture
def pvars():
    """Snapshot/restore both packages' MCA registries; returns a setter
    that sets one var in a package."""
    saved = [(P.var, {v.name: (v._value, v._source)
                      for v in P.var.registry.all_vars()})
             for P in (JAX, PORT)]

    def set_(P, name, value):
        P.var.set_var(name, value)

    yield set_
    for reg, snap in saved:
        for v in reg.registry.all_vars():
            if v.name in snap:
                v._value, v._source = snap[v.name]


_PARK_BODY = """
import os, time
deadline = time.monotonic() + 60.0
while not os.path.exists(sys.argv[1]):
    assert time.monotonic() < deadline, "parker never released"
    time.sleep(0.02)
"""

_APPEND_BODY = """
with open(sys.argv[1], "a") as f:
    f.write(sys.argv[2] + chr(10))
"""


# ---------------------------------------------------- admission queue (unit)


@BOTH
def test_no_cap_admits_immediately(P, pvars):
    q = P.dvm._AdmissionQueue()
    t1, t2 = q.enqueue(), q.enqueue()
    assert q.admit(t1) is not None and q.admit(t2) is not None
    assert not t1.was_queued and not t2.was_queued
    assert q.stat_view()["running"] == 2
    q.release(t1)
    q.release(t2)
    assert q.stat_view()["running"] == 0


def _cap_fifo(P):
    q = P.dvm._AdmissionQueue()
    t1 = q.enqueue()
    assert q.admit(t1) is not None
    t2, t3 = q.enqueue(), q.enqueue()
    admitted, positions = [], {2: [], 3: []}

    def waiter(ticket, tag):
        q.admit(ticket, on_position=lambda p: positions[tag].append(p))
        admitted.append(tag)

    threading.Thread(target=waiter, args=(t2, 2), daemon=True).start()
    wait_for(lambda: positions[2] == [1], 10.0)
    threading.Thread(target=waiter, args=(t3, 3), daemon=True).start()
    wait_for(lambda: positions[3] == [2], 10.0)
    view = q.stat_view()
    assert admitted == []
    q.release(t1)
    wait_for(lambda: admitted == [2], 10.0)
    q.release(t2)
    wait_for(lambda: admitted == [2, 3], 10.0)
    q.release(t3)
    assert q.queued() == []
    return view, admitted, positions


def test_cap_blocks_fifo_order_as_the_namesake(pvars):
    got = {}
    for P in (JAX, PORT):
        pvars(P, "dvm_max_concurrent_jobs", 1)
        got[P.name] = _cap_fifo(P)
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"policy": "fifo", "cap": 1, "running": 1,
                              "waiting": 2}


def _priority(P):
    q = P.dvm._AdmissionQueue()
    t1 = q.enqueue(priority=0)
    assert q.admit(t1) is not None
    low = q.enqueue(priority=1)
    admitted, low_pos = [], []

    def wait_low():
        q.admit(low, on_position=low_pos.append)
        admitted.append("low")

    threading.Thread(target=wait_low, daemon=True).start()
    wait_for(lambda: low_pos[-1:] == [1], 10.0)
    high = q.enqueue(priority=9)

    def wait_high():
        q.admit(high)
        admitted.append("high")

    threading.Thread(target=wait_high, daemon=True).start()
    wait_for(lambda: low_pos[-1:] == [2], 10.0)
    q.release(t1)
    wait_for(lambda: admitted == ["high"], 10.0)
    q.release(high)
    wait_for(lambda: admitted == ["high", "low"], 10.0)
    q.release(low)
    # the low ticket heard its demotion (1 -> 2); whether it hears its
    # promotion back to 1 before admission depends on the wake order
    return admitted, low_pos[:2]


def test_priority_reorders_live_queue_as_the_namesake(pvars):
    got = {}
    for P in (JAX, PORT):
        pvars(P, "dvm_max_concurrent_jobs", 1)
        pvars(P, "dvm_admission_policy", "priority")
        got[P.name] = _priority(P)
    assert got["port"] == got["jax"] == (["high", "low"], [1, 2])


@BOTH
def test_dead_client_ticket_cancelled(P, pvars):
    pvars(P, "dvm_max_concurrent_jobs", 1)
    q = P.dvm._AdmissionQueue()
    t1 = q.enqueue()
    assert q.admit(t1) is not None
    t2 = q.enqueue()
    assert q.admit(t2, alive=lambda: False) is None
    assert q.queued() == []
    q.release(t1)
    q.release(t2)


@BOTH
def test_close_raises_under_waiter(P, pvars):
    pvars(P, "dvm_max_concurrent_jobs", 1)
    q = P.dvm._AdmissionQueue()
    t1 = q.enqueue()
    assert q.admit(t1) is not None
    t2, res = q.enqueue(), {}

    def waiter():
        try:
            q.admit(t2)
        except P.errors.MpiError as e:
            res["error"] = str(e)

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    wait_for(lambda: q.stat_view()["waiting"] == 1, 10.0)
    q.close()
    th.join(timeout=10.0)
    assert "stopping" in res["error"]
    assert q.queued() == []
    q.release(t1)


# ------------------------------------------------ placement ladder (unit)


DAEMONS = ["h:1", "h:2", "h:3", "h:4"]
PLACE_CASES = [
    ([0, 1], {}, "pack"),
    ([0, 1, 2, 3, 4], {}, "pack"),
    ([0, 1], {"h:1": 2, "h:2": 1}, "spread"),
    ([0, 1], {"h:1": 1, "h:3": 1}, "spread"),
    (list(range(8)), {}, "spread"),
    (list(range(9)), {"h:2": 3}, "spread"),
    ([0], {"h:1": 1}, "exclusive"),
    ([0, 1, 2], {"h:4": 1}, "exclusive"),
    ([0, 1], {d: 1 for d in DAEMONS}, "exclusive"),
]


@pytest.mark.parametrize("ranks,busy,policy", PLACE_CASES)
def test_place_job_matches_namesake(ranks, busy, policy):
    got = tdvmtree.place_job(ranks, DAEMONS, dict(busy), policy)
    assert got == JAX.dvmtree.place_job(ranks, DAEMONS, dict(busy), policy)
    placed, fell_back = got
    assert sorted(placed) == ranks
    assert set(placed.values()) <= set(DAEMONS)
    assert fell_back == (policy == "exclusive"
                         and all(busy.get(d) for d in DAEMONS))


def test_spread_tenants_disjoint_while_capacity():
    a, _ = tdvmtree.place_job([0, 1], DAEMONS, {}, "spread")
    b, _ = tdvmtree.place_job([0, 1], DAEMONS,
                              {d: 1 for d in a.values()}, "spread")
    assert not (set(a.values()) & set(b.values())), (a, b)


@BOTH
def test_place_job_typed_errors(P):
    with pytest.raises(P.errors.ArgError, match="unknown policy"):
        P.dvmtree.place_job([0], DAEMONS, {}, "anywhere")
    with pytest.raises(P.errors.InternalError, match="no daemons"):
        P.dvmtree.place_job([0], [], {}, "pack")


def _jobs():
    return ({"id": "job1", "session": "d1_job1", "daemons": ["h:1"],
             "exclusive": False},
            {"id": "job2", "session": "d1_job2", "daemons": ["h:2"],
             "exclusive": False})


@BOTH
@pytest.mark.parametrize("shape,prop,match", [
    ("namespace", "namespace", "cid windows"),
    ("session", "session", "sm segments"),
    ("subtree", "subtree", "exclusive subtree")])
def test_audit_violations_typed_and_counted(P, shape, prop, match):
    a, b = _jobs()
    P.dvmtree.audit_placement(a, [b])  # disjoint tenants pass
    assert P.dvmtree.placement_audit_failures() == []
    if shape == "namespace":
        b["id"] = a["id"]
    elif shape == "session":
        b["session"] = a["session"] + "_sub"
    else:
        a["exclusive"] = True
        b["daemons"] = ["h:1", "h:2"]
    before = P.spc.read("dvm_placement_audit_failures")
    try:
        with pytest.raises(P.errors.PlacementViolation, match=match) as e:
            P.dvmtree.audit_placement(a, [b])
        assert e.value.prop == prop
        assert set(e.value.jobs) == {a["id"], b["id"]}
        assert P.dvmtree.placement_audit_failures()
        assert P.spc.read("dvm_placement_audit_failures") == before + 1
    finally:
        P.dvmtree.clear_placement_audit_failures()


@BOTH
def test_sweep_isolation(P):
    collide = P.dvmtree._sessions_collide
    assert not collide("d1_job1", "d1_job10")
    assert not collide("d1_job2", "d1_job21")
    assert collide("d1_job1", "d1_job1")
    assert collide("d1_job1", "d1_job1_x") and collide("d1_job1_x", "d1_job1")
    if not os.path.isdir("/dev/shm"):
        return
    tag = f"zt{P.name}{os.getpid()}"
    mine = f"/dev/shm/zompi_ring_{tag}_job1_0_0"
    sibling = f"/dev/shm/zompi_ring_{tag}_job10_0_0"
    for p in (mine, sibling):
        open(p, "w").close()
    try:
        P.dvm._sweep_shm(f"{tag}_job1")
        assert not os.path.exists(mine) and os.path.exists(sibling)
    finally:
        for p in (mine, sibling):
            if os.path.exists(p):
                os.unlink(p)


# -------------------------------------- daemon integration (thread-fast)


def _park(tmp_path, addr, flag, **kw):
    h = bg_launch(addr, 1, [script(tmp_path, _PARK_BODY, "park.py"), flag],
                  **kw)
    wait_for(lambda: h["cli"].last_job_id is not None
             or not h["thread"].is_alive(), 30.0, "parker never started")
    return h


def test_fifo_order_and_queued_frames(tmp_path, pvars):
    pvars(PORT, "dvm_max_concurrent_jobs", 1)
    append = script(tmp_path, _APPEND_BODY, "append.py")
    log, flag = str(tmp_path / "order.log"), str(tmp_path / "flag")
    q0 = tspc.read("dvm_jobs_queued")
    d = tdvm.Dvm()
    try:
        parker = _park(tmp_path, d.address, flag)
        h2 = bg_launch(d.address, 1, [append, log, "J2"])
        wait_for(lambda: h2["cli"].last_queue_position == 1, 30.0)
        h3 = bg_launch(d.address, 1, [append, log, "J3"])
        wait_for(lambda: h3["cli"].last_queue_position == 2, 30.0)
        cli = tdvm.DvmClient(d.address)
        assert cli.stat()["admission"] == {"policy": "fifo", "cap": 1,
                                           "running": 1, "waiting": 2}
        # a queued launch holds no setup lock (respawn/resize take it)
        lock = d._admission.setup()
        assert lock.acquire(timeout=2.0)
        lock.release()
        cli.close()
        assert "queued at position 1" in h2["err"].getvalue()
        assert "queued at position 2" in h3["err"].getvalue()
        open(flag, "w").close()
        for h in (parker, h2, h3):
            assert finish(h) == {"rc": 0}
        with open(log) as f:
            assert f.read().split() == ["J2", "J3"]
        assert tspc.read("dvm_jobs_queued") - q0 == 2
    finally:
        d.stop()


def test_priority_preempts_fifo(tmp_path, pvars):
    pvars(PORT, "dvm_max_concurrent_jobs", 1)
    pvars(PORT, "dvm_admission_policy", "priority")
    append = script(tmp_path, _APPEND_BODY, "append.py")
    log, flag = str(tmp_path / "order.log"), str(tmp_path / "flag")
    d = tdvm.Dvm()
    try:
        parker = _park(tmp_path, d.address, flag)
        low = bg_launch(d.address, 1, [append, log, "LOW"], priority=1)
        wait_for(lambda: low["cli"].last_queue_position == 1, 30.0)
        high = bg_launch(d.address, 1, [append, log, "HIGH"], priority=9)
        wait_for(lambda: low["cli"].last_queue_position == 2, 30.0)
        assert high["cli"].last_queue_position == 1
        open(flag, "w").close()
        for h in (parker, high, low):
            assert finish(h) == {"rc": 0}
        with open(log) as f:
            assert f.read().split() == ["HIGH", "LOW"]
    finally:
        d.stop()


def test_dead_queued_client_reaped(tmp_path, pvars):
    """A raw client queues behind a running job and dies: its ticket is
    reaped, the next launch admits, the ghost's job never runs."""
    from zhpe_ompi_tpu_torch.pt2pt.tcp import _recv_frame, _send_frame
    from zhpe_ompi_tpu_torch.utils import dss

    pvars(PORT, "dvm_max_concurrent_jobs", 1)
    append = script(tmp_path, _APPEND_BODY, "append.py")
    flag = str(tmp_path / "flag")
    launched0 = tspc.read("dvm_jobs_launched")
    d = tdvm.Dvm()
    try:
        parker = _park(tmp_path, d.address, flag)
        s = socket.create_connection(d.address, 10.0)
        _send_frame(s, dss.pack(["launch", {
            "n": 1, "argv": [append, str(tmp_path / "ghost"), "G"],
            "mca": [], "ft": False, "timeout": 30.0}]))
        deadline = time.monotonic() + 30.0
        while True:
            frame = _recv_frame(s)
            assert frame is not None and time.monotonic() < deadline
            [msg] = dss.unpack(frame)
            if msg[0] == "queued":
                break
        s.close()
        wait_for(lambda: tdvm.queued_admission_tickets() == [], 30.0,
                 "dead client's ticket never reaped")
        h3 = bg_launch(d.address, 1, [append, str(tmp_path / "l3"), "J3"])
        open(flag, "w").close()
        assert finish(parker) == {"rc": 0} and finish(h3) == {"rc": 0}
        assert tspc.read("dvm_jobs_launched") - launched0 == 2
        assert not os.path.exists(str(tmp_path / "ghost"))
    finally:
        d.stop()


def test_spread_tenants_disjoint_subtrees(tmp_path):
    park = script(tmp_path, _PARK_BODY, "park.py")
    flag = str(tmp_path / "flag")
    tree = tdvmtree.spawn_tree(4, in_process=True)
    try:
        addr = tree.root_address
        hs = []
        for _ in range(2):
            h = bg_launch(addr, 2, [park, flag], placement="spread")
            wait_for(lambda: h["cli"].last_job_id is not None, 30.0)
            hs.append(h)
        cli = tdvm.DvmClient(addr)
        jobs = cli.stat()["jobs"]
        cli.close()
        d1, d2 = ({d for _, d in jobs[h["cli"].last_job_id]["placement"]}
                  for h in hs)
        assert d1 and d2 and not (d1 & d2), (d1, d2)
        open(flag, "w").close()
        for h in hs:
            assert finish(h) == {"rc": 0}
    finally:
        tree.stop()


def test_exclusive_fallback_loud_then_audit_protects(tmp_path):
    """One daemon, one live pack tenant: an exclusive launch finds no
    free daemon and falls back to spread loudly (a note and
    ``dvm_placement_fallbacks``).  An exclusive tenant then holds its
    subtree: a second exclusive launch fails with the typed audit
    violation."""
    park = script(tmp_path, _PARK_BODY, "park.py")
    flag, flag2 = str(tmp_path / "flag"), str(tmp_path / "flag2")
    fb0 = tspc.read("dvm_placement_fallbacks")
    d = tdvm.Dvm()
    try:
        h1 = _park(tmp_path, d.address, flag)
        h2 = _park(tmp_path, d.address, flag, placement="exclusive")
        assert "falling back to spread" in h2["err"].getvalue()
        assert tspc.read("dvm_placement_fallbacks") - fb0 == 1
        assert tdvmtree.placement_audit_failures() == []
        open(flag, "w").close()
        assert finish(h1) == {"rc": 0} and finish(h2) == {"rc": 0}
        h3 = _park(tmp_path, d.address, flag2, placement="exclusive")
        cli = tdvm.DvmClient(d.address)
        try:
            with pytest.raises(PORT.errors.MpiError,
                               match="exclusive subtree"):
                cli.launch(1, [park, flag2], placement="exclusive",
                           timeout=30.0)
        finally:
            cli.close()
        assert tdvmtree.placement_audit_failures()
        open(flag2, "w").close()
        assert finish(h3) == {"rc": 0}
    finally:
        tdvmtree.clear_placement_audit_failures()  # the intentional trip
        d.stop()


# ------------------------------------------ two-tenant drill (slow, real)


_TENANT_A_BODY = """
import time
import torch
import zhpe_ompi_tpu_torch as zmpi

victim = int(sys.argv[1])
proc = zmpi.host_init()
proc.barrier()
print(f"READY rank={proc.rank}", flush=True)
if proc.rank == victim:
    time.sleep(300.0)
    raise SystemExit(0)
deadline = time.monotonic() + 60.0
while not proc.ft_state.is_failed(victim):
    assert time.monotonic() < deadline
    time.sleep(0.01)
cause = proc.ft_state.cause_of(victim)
proc.failure_ack()
total = float(proc.shrink().allreduce(torch.tensor(1.0, dtype=torch.float64),
                                      zmpi.SUM))
print(f"SURVIVOR-OK rank={proc.rank} cause={cause} total={total}", flush=True)
zmpi.host_finalize()
"""

_TENANT_B_BODY = """
import os, time
import torch
import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch.runtime import spc

flag = sys.argv[1]
proc = zmpi.host_init()
proc.barrier()
print(f"READY rank={proc.rank}", flush=True)
iters, deadline = 0, time.monotonic() + 90.0
while True:
    assert time.monotonic() < deadline, "never released"
    stop = proc.rank == 0 and os.path.exists(flag)
    total = float(proc.allreduce(
        torch.tensor(2.0 if stop else 1.0, dtype=torch.float64), zmpi.SUM))
    assert total in (float(proc.size), float(proc.size) + 1.0), total
    iters += 1
    if total > float(proc.size):
        break
    time.sleep(0.02)
assert not proc.ft_state.failed(), proc.ft_state.failed()
assert spc.read("dvm_fault_events") == 0, "tenant saw a foreign fault"
print(f"CLEAN-OK rank={proc.rank} iters={iters}", flush=True)
zmpi.host_finalize()
"""


@pytest.mark.slow
def test_fault_in_job_a_invisible_to_job_b(tmp_path):
    """Kill -9 a rank of tenant A mid-loop: tenant B (ft, checked
    allreduces, a disjoint subtree) sees no fault event; both rcs are
    exactly the fault plan's."""
    import signal

    prog_a = script(tmp_path, _TENANT_A_BODY, "a.py")
    prog_b = script(tmp_path, _TENANT_B_BODY, "b.py")
    flag, victim = str(tmp_path / "flag"), 1
    mca = [("ft_detector_period", "2.0"), ("ft_detector_timeout", "60.0")]
    tree = tdvmtree.spawn_tree(3, in_process=True)
    try:
        addr = tree.root_address
        h_b = bg_launch(addr, 2, [prog_b, flag], ft=True, mca=mca,
                        placement="spread", timeout=150.0)
        wait_for(lambda: h_b["out"].getvalue().count("READY") == 2, 60.0)
        h_a = bg_launch(addr, 2, [prog_a, str(victim)], ft=True, mca=mca,
                        placement="exclusive", timeout=150.0)
        wait_for(lambda: h_a["out"].getvalue().count("READY") == 2, 60.0)
        cli = tdvm.DvmClient(addr)
        jobs = cli.stat()["jobs"]
        da, db = ({d for _, d in jobs[h["cli"].last_job_id]["placement"]}
                  for h in (h_a, h_b))
        assert da and db and not (da & db), (da, db)
        os.kill(cli.pids(h_a["cli"].last_job_id)[victim], signal.SIGKILL)
        cli.close()
        wait_for(lambda: "SURVIVOR-OK" in h_a["out"].getvalue(), 90.0)
        open(flag, "w").close()
        assert finish(h_a) == {"rc": 137}
        assert finish(h_b) == {"rc": 0}
        assert "SURVIVOR-OK rank=0 cause=daemon total=1.0" \
            in h_a["out"].getvalue()
        text_b = h_b["out"].getvalue() + h_b["err"].getvalue()
        assert "CLEAN-OK rank=0" in text_b
        assert "SURVIVOR" not in text_b and "fault" not in text_b
    finally:
        tree.stop()
