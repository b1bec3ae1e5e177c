"""``zsoak`` — the multi-tenant fault-storm soak harness
(namesake: ``zhpe_ompi_tpu/tools/zsoak.py``).

The tenancy layer's acceptance tool (multi-job tenancy under a fault
soak): build a REAL daemon tree (in-process root so the harness
shares its flight recorder and SPC registry, ``zprted --parent`` OS
processes for the killable children), then drive ``--cycles`` seeded
storms of overlapping tenant jobs through it —

- a **sentinel** tenant every cycle: a non-ft job looping checked
  allreduces for the whole fault window; any fault leakage (a note, a
  wrong sum, a nonzero rc) is a cross-tenant isolation violation;
- **rank kill**: ``kill -9`` a victim rank's OS process mid-job — the
  survivors must classify ``cause=daemon`` off the hosting daemon's
  waitpid truth, shrink, and finish (job rc 137);
- **daemon kill**: SIGKILL a whole ``zprted`` child hosting half an
  exclusive-placement job — the root classifies the subtree
  (``cause=daemon-tree``), the co-tenant sentinel on disjoint daemons
  must never hear about it, and the dead daemon is replaced before
  the next cycle;
- **recover**: the full pipeline in-band — a victim suicides, the
  survivors respawn it through the daemon's relaunch RPC, the
  replacement rejoins, rc 0;
- **elastic**: grow/shrink resizes under allreduce traffic, rc 0;
- **queue storm**: cap the daemon at one concurrent job
  (``dvm_max_concurrent_jobs=1``) and race three launches — excess
  launches must park with ``[queued, pos]`` frames and every job must
  still run to rc 0 in admission order.

Every choice — cycle shapes, victim ranks, priorities — comes from ONE
``random.Random(seed)``, so a failing storm replays exactly from its
seed.  Placement is part of the determinism contract: the harness
PREDICTS each placed job's daemon map with
:func:`~zhpe_ompi_tpu_torch.runtime.dvmtree.place_job` and treats a mismatch
with the daemon's actual placement as a violation.

At the end the harness asserts the conftest-style invariants (zero
queued admission tickets, zero placement-audit failures, zero live
daemons/listeners/prober threads, zero stale namespaces or routed
caches, zero ``/dev/shm`` residue under the root's session, every job
rc explained by its cycle's fault plan) and prints a per-fault MTTR
postmortem: detect/respawn/resize legs out of the shared flight
recorder's window (:func:`~zhpe_ompi_tpu_torch.ft.recovery.mttr_legs`)
merged with the harness's own injection stamps, plus the daemon's
stat-RPC counter aggregates and any fleet-visible metrics snapshots
the fault jobs published.  Fault jobs also launch with ``trace=True``,
so their ranks' ztrace buffers ride the metrics publisher into the
root store (surviving the kill -9 victim) and the postmortem prints a
ztrace-MERGED per-fault timeline — the recovery legs (agree / shrink /
respawn / checkpoint-restore rollback) as clock-corrected spans with
the critical-path leg named.  The MTTR table is REPORT-ONLY by design:
a 1-CPU container measures ordering truth, not latency truth.

One more per-cycle invariant: the root PMIx store's state is
serialized (namespace → sorted published keys) before the storms
start, and every cycle must return the store to that byte-identical
baseline — a leaked job namespace, trace buffer, or metrics key is
residue, and residue is a violation.

Usage::

    python -m zhpe_ompi_tpu_torch.tools.zsoak --cycles 50 --seed 7

Exit code 0 means zero invariant violations; 1 lists them.
"""

from __future__ import annotations

import argparse
import glob
import io
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from typing import Any

from ..core import errors
from ..ft import recovery
from ..mca import var as mca_var
from ..parallel import mesh as mesh_mod
from ..pt2pt import sm as sm_mod
from ..runtime import dvm as dvm_mod
from ..runtime import dvmtree
from ..runtime import flightrec
from ..runtime import pmix as pmix_mod
from ..runtime import spc

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_FT_MCA = [("ft_detector_period", "2.0"),
           ("ft_detector_timeout", "60.0")]

# -- worker programs (argv-driven: child daemons can't see per-job env) ------

# sentinel: argv = token, flagfile, min_iters.  Loops CHECKED allreduces
# until the driver raises the flag (and at least min_iters), so the
# collective plane is provably healthy across a co-tenant's whole fault
# window; exits 1 on its own 120s safety deadline.
_SENTINEL_PROG = """
import os
import time

import numpy as np

import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch import ops

tok, flag, min_iters = sys.argv[1], sys.argv[2], int(sys.argv[3])
proc = zmpi.host_init()
proc.barrier()
print(f"READY rank={proc.rank} tok={tok}", flush=True)
deadline = time.monotonic() + 120.0
iters = 0
while True:
    if time.monotonic() > deadline:
        print(f"SENTINEL-TIMEOUT rank={proc.rank} tok={tok}", flush=True)
        raise SystemExit(1)
    # the stop decision rides the allreduce: only rank 0 polls the
    # flag and contributes +1, so EVERY rank learns of it in the SAME
    # iteration — an each-rank-polls exit would let a rank that saw
    # the flag first leave a peer wedged mid-collective
    stop = proc.rank == 0 and iters >= min_iters \\
        and flag != "-" and os.path.exists(flag)
    total = float(np.asarray(proc.allreduce(
        np.float64(2.0 if stop else 1.0), ops.SUM)))
    assert total in (float(proc.size), float(proc.size) + 1.0), \\
        (total, proc.size)
    iters += 1
    if total > float(proc.size) or (flag == "-" and iters >= min_iters):
        break
    time.sleep(0.02)
print(f"CLEAN-OK rank={proc.rank} tok={tok} iters={iters}", flush=True)
zmpi.host_finalize()
"""

# park: argv = token, victims (csv).  Victims idle until the harness's
# kill -9 (rank kill) or their daemon's death (daemon kill) takes them;
# survivors wait for the typed classification, ack, shrink, compute.
_PARK_PROG = """
import time

import numpy as np

import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch import ops

tok = sys.argv[1]
victims = set(int(r) for r in sys.argv[2].split(","))
proc = zmpi.host_init()
proc.barrier()
print(f"READY rank={proc.rank} tok={tok}", flush=True)
if proc.rank in victims:
    time.sleep(300.0)
    raise SystemExit(0)
deadline = time.monotonic() + 60.0
while time.monotonic() < deadline:
    if all(proc.ft_state.is_failed(v) for v in victims):
        break
    time.sleep(0.01)
else:
    print(f"PARK-TIMEOUT rank={proc.rank} tok={tok}", flush=True)
    raise SystemExit(1)
causes = sorted(set(proc.ft_state.cause_of(v) for v in victims))
proc.failure_ack()
sh = proc.shrink()
total = float(np.asarray(sh.allreduce(np.float64(proc.rank), ops.SUM)))
print(f"SURVIVOR-OK rank={proc.rank} tok={tok} "
      f"causes={','.join(causes)} total={total}", flush=True)
zmpi.host_finalize()
"""

# recover: argv = token, victim, ckpt_dir.  The victim suicides after
# the checkpoint barrier; survivors run the daemon-relaunch pipeline;
# the replacement (ZMPI_REJOIN=1, same argv) restores and rejoins the
# full-size allreduce — the whole job exits 0.
_RECOVER_PROG = """
import os
import signal
import time

import numpy as np

import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch import ops
from zhpe_ompi_tpu_torch.core import errhandler as errh
from zhpe_ompi_tpu_torch.ft import recovery
from zhpe_ompi_tpu_torch.runtime.checkpoint import Checkpointer

tok, victim, ckpt = sys.argv[1], int(sys.argv[2]), sys.argv[3]
proc = zmpi.host_init()
proc.set_errhandler(errh.ERRORS_RETURN)
ck = Checkpointer(os.path.join(ckpt, f"r{proc.rank}"),
                  check_quiescent=False)

if os.environ.get("ZMPI_REJOIN") == "1":
    state, step = recovery.rollback(ck)
    assert step == 1 and state["x"] == float(proc.rank)
    total = proc.allreduce(np.float64(state["x"]), ops.SUM)
    print(f"REJOIN-OK rank={proc.rank} tok={tok} "
          f"total={float(np.asarray(total))}", flush=True)
    zmpi.host_finalize()
    sys.exit(0)

ck.save(1, {"x": float(proc.rank)}, blocking=True)
proc.barrier()
print(f"READY rank={proc.rank} tok={tok}", flush=True)
if proc.rank == victim:
    os.kill(os.getpid(), signal.SIGKILL)
assert proc.ft_state.wait_failed(victim, timeout=30.0), "never classified"

def rollback_fn(shrunk):
    state, step = recovery.rollback(ck)
    assert step == 1 and state["x"] == float(proc.rank)

shrunk, victims = recovery.respawn_victims(
    proc, recovery.daemon_respawn, rollback_fn=rollback_fn)
assert victims == [victim], victims
assert recovery.await_rejoin(proc, victim, timeout=30.0), "no rejoin"
total = proc.allreduce(np.float64(proc.rank), ops.SUM)
print(f"SURVIVOR-OK rank={proc.rank} tok={tok} "
      f"total={float(np.asarray(total))}", flush=True)
zmpi.host_finalize()
"""

# elastic: argv = token, run_s, stop_after.  The test-suite resize
# shape: checked allreduce loop, collective stop after stop_after
# applied resizes.
_ELASTIC_PROG = """
import time

import numpy as np

import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch import ops
from zhpe_ompi_tpu_torch.ft import recovery

tok, run_s, stop_after = sys.argv[1], float(sys.argv[2]), int(sys.argv[3])
ep = zmpi.host_init()
ses = recovery.ElasticSession(ep)
print(f"READY rank={ep.rank} tok={tok}", flush=True)
deadline = time.monotonic() + run_s
resizes = 0
while True:
    n = ses.live.size
    want_stop = 1.0 if (time.monotonic() > deadline
                        or resizes >= stop_after) else 0.0
    out = ses.live.allreduce(np.array([1.0, want_stop]), ops.SUM)
    assert np.isclose(out[0], n), (out, n)
    if out[1] > 0:
        break
    act = ses.step()
    if act in ("retire", "halt"):
        print(f"RETIRE rank={ep.rank} tok={tok}", flush=True)
        break
    if act == "resized":
        resizes += 1
        print(f"RESIZED rank={ep.rank} tok={tok} live={ses.live.size}",
              flush=True)
ses.close()
zmpi.host_finalize()
"""

_PROGRAMS = {"sentinel": _SENTINEL_PROG, "park": _PARK_PROG,
             "recover": _RECOVER_PROG, "elastic": _ELASTIC_PROG}


def _write_programs(workdir: str) -> dict[str, str]:
    paths = {}
    for name, body in _PROGRAMS.items():
        p = os.path.join(workdir, f"{name}.py")
        with open(p, "w") as f:
            f.write("import sys\nsys.path.insert(0, %r)\n%s"
                    % (_REPO, body))
        paths[name] = p
    return paths


# -- the tree (in-process root + killable subprocess children) ---------------


def _spawn_child(host: str, parent: tuple[str, int],
                 timeout: float = 60.0) -> dict:
    cmd = [sys.executable, "-m", "zhpe_ompi_tpu_torch.runtime.dvm",
           "--host", host, "--parent", f"{parent[0]}:{parent[1]}"]
    env = dict(os.environ)
    parts = env.get("PYTHONPATH", "").split(os.pathsep)
    if _REPO not in parts:
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO] + [p for p in parts if p])
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    ready = dvmtree._read_ready_line(p, timeout)
    addr = pmix_mod.parse_addr(ready.split("dvm=")[1].split()[0])
    return {"address": addr, "proc": p, "id": f"{addr[0]}:{addr[1]}"}


class _SoakTree:
    """Root :class:`~zhpe_ompi_tpu_torch.runtime.dvm.Dvm` in-process (shared
    flightrec/SPC — the postmortem plane), children as real ``zprted``
    subprocesses in a flat star (every child killable independently,
    no innocent grandchild rides a murdered parent down)."""

    def __init__(self, n_daemons: int, host: str = "127.0.0.1"):
        self.host = host
        self.root = dvm_mod.Dvm(host=host)
        self.children: list[dict] = []
        try:
            for _ in range(max(0, n_daemons - 1)):
                self.children.append(
                    _spawn_child(host, self.root.address))
            self._await_size(n_daemons)
        except BaseException:
            self.stop()
            raise

    def _await_size(self, n: int, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while len(self.root._placement_ids) < n:
            if time.monotonic() > deadline:
                raise errors.InternalError(
                    f"zsoak: root knows {len(self.root._placement_ids)}"
                    f"/{n} daemons")
            time.sleep(0.01)

    def daemon_ids(self) -> list[str]:
        return list(self.root._placement_ids)

    def child_ids(self) -> set[str]:
        return {c["id"] for c in self.children
                if c["proc"].poll() is None}

    def kill_child(self, daemon_id: str) -> None:
        for c in self.children:
            if c["id"] == daemon_id:
                c["proc"].send_signal(signal.SIGKILL)
                c["proc"].wait(timeout=10.0)
                return
        raise errors.ArgError(f"zsoak: no child daemon {daemon_id!r}")

    def replace_dead(self, target: int, timeout: float = 60.0) -> None:
        """Reap dead children and grow the star back to ``target``
        daemons, then wait until the root can place on all of them."""
        self.children = [c for c in self.children
                         if c["proc"].poll() is None]
        deadline = time.monotonic() + timeout
        while len(self.root._placement_ids) > 1 + len(self.children):
            # the root still lists a corpse: wait for the lost-child
            # sweep so the respawn below isn't racing the removal
            if time.monotonic() > deadline:
                break
            time.sleep(0.01)
        while 1 + len(self.children) < target:
            self.children.append(
                _spawn_child(self.host, self.root.address))
        self._await_size(target)

    def stop(self) -> None:
        for c in reversed(self.children):
            p = c["proc"]
            if p.poll() is not None:
                continue
            try:
                cli = dvm_mod.DvmClient(c["address"], timeout=10.0)
                try:
                    cli.stop()
                finally:
                    cli.close()
            except errors.MpiError:
                pass
            try:
                p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.root.stop()


# -- one launched tenant job -------------------------------------------------


class _TenantJob:
    """One launch riding its own client socket + thread, with the
    cycle's fault plan attached (``expect`` is the rc set that plan
    explains)."""

    def __init__(self, harness: "_Harness", name: str, n: int,
                 argv: list[str], expect: set[int], *, ft: bool = False,
                 metrics: bool = False, trace: bool = False,
                 placement: str | None = None,
                 priority: int = 0, max_size: int | None = None,
                 timeout: float = 150.0):
        self.name = name
        self.expect = expect
        self.out = io.StringIO()
        self.err = io.StringIO()
        self.result: dict[str, Any] = {}
        self.cli = dvm_mod.DvmClient(harness.tree.root.address)
        mca = list(_FT_MCA) if ft else None

        def run():
            try:
                self.result["rc"] = self.cli.launch(
                    n, argv, ft=ft, mca=mca, metrics=metrics,
                    trace=trace, placement=placement, priority=priority,
                    max_size=max_size, timeout=timeout,
                    stdout=self.out, stderr=self.err)
            except errors.MpiError as e:
                self.result["error"] = str(e)

        self.thread = threading.Thread(target=run, daemon=True,
                                       name=f"zsoak-{name}")
        self.thread.start()

    @property
    def job_id(self) -> str | None:
        return self.cli.last_job_id

    def wait_output(self, needle: str, count: int,
                    timeout: float = 90.0) -> bool:
        deadline = time.monotonic() + timeout
        while self.out.getvalue().count(needle) < count:
            if time.monotonic() > deadline or not self.thread.is_alive() \
                    and self.out.getvalue().count(needle) < count:
                return False
            time.sleep(0.02)
        return True

    def finish(self, timeout: float = 180.0) -> int | None:
        self.thread.join(timeout=timeout)
        self.cli.close()
        if self.thread.is_alive():
            return None
        return self.result.get("rc")


# -- the harness -------------------------------------------------------------


class _Harness:
    def __init__(self, args):
        self.args = args
        self.rng = random.Random(args.seed)
        self.workdir = args.workdir
        self.progs = _write_programs(self.workdir)
        self.tree = _SoakTree(args.daemons)
        self.violations: list[str] = []
        self.injections: list[dict] = []   # {job, kind, t_wall, cycle}
        self.metrics_snaps: list[dict] = []
        self.trace_snaps: list[dict] = []  # {job, name, payloads}
        self.fault_jobs = 0
        self.counters0 = spc.snapshot()
        # the pre-storm store baseline every cycle must return to,
        # byte-identical (namespace → sorted published keys)
        self.store_baseline = self.store_snapshot()

    # -- small utilities --------------------------------------------------

    def violate(self, msg: str) -> None:
        self.violations.append(msg)
        print(f"zsoak: VIOLATION: {msg}", file=sys.stderr, flush=True)

    def check_rc(self, cycle: int, job: _TenantJob) -> None:
        rc = job.finish()
        if rc is None:
            why = job.result.get("error", "never completed")
            self.violate(f"cycle {cycle}: job {job.name}: {why} "
                         f"(expected rc in {sorted(job.expect)}); "
                         f"stderr={job.err.getvalue()!r}")
            return
        if rc not in job.expect:
            self.violate(
                f"cycle {cycle}: job {job.name}: rc {rc} not explained "
                f"by its fault plan (expected {sorted(job.expect)}); "
                f"out={job.out.getvalue()!r} err={job.err.getvalue()!r}")

    def check_sentinel(self, cycle: int, job: _TenantJob) -> None:
        self.check_rc(cycle, job)
        text = job.out.getvalue() + job.err.getvalue()
        for needle in ("SURVIVOR", "fault", "TIMEOUT"):
            if needle in text:
                self.violate(
                    f"cycle {cycle}: sentinel {job.name} saw cross-"
                    f"tenant fault traffic ({needle!r}): {text!r}")
                break

    def stat(self) -> dict:
        cli = dvm_mod.DvmClient(self.tree.root.address)
        try:
            return cli.stat()
        finally:
            cli.close()

    def placement_of(self, job_id: str, timeout: float = 30.0
                     ) -> dict[int, str]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            view = self.stat()["jobs"].get(job_id)
            if view and view.get("placement"):
                return {int(r): d for r, d in view["placement"]}
            time.sleep(0.05)
        return {}

    def busy_map(self) -> dict[str, int]:
        busy: dict[str, int] = {}
        for view in self.stat()["jobs"].values():
            if view.get("done"):
                continue
            for d in {d for _, d in view.get("placement", [])}:
                busy[d] = busy.get(d, 0) + 1
        return busy

    def inject(self, job_id: str | None, kind: str, cycle: int) -> None:
        self.injections.append({"job": job_id, "kind": kind,
                                "cycle": cycle, "t_wall": time.time()})

    def store_snapshot(self) -> str:
        """The root PMIx store's state, serialized deterministically:
        namespace → sorted published key names, canonical JSON.  Two
        equal store states produce byte-identical snapshots, so cycle
        residue is a string comparison."""
        store = self.tree.root.store
        snap = {}
        for ns in store.namespaces():
            try:
                snap[ns] = sorted(store.lookup(ns))
            except errors.MpiError:
                snap[ns] = ["<lookup-failed>"]
        return json.dumps(snap, sort_keys=True)

    def check_store_residue(self, cycle: int) -> None:
        """End-of-cycle invariant: the store must return to the
        pre-storm baseline, byte-identical.  A short grace window
        absorbs namespace-teardown lag; whatever remains after it is
        residue — a leaked job namespace, trace buffer, or metrics
        key — and residue is a violation."""
        deadline = time.monotonic() + 5.0
        while True:
            snap = self.store_snapshot()
            if snap == self.store_baseline:
                return
            if time.monotonic() > deadline:
                break
            time.sleep(0.1)
        base = json.loads(self.store_baseline)
        now = json.loads(snap)
        added = {
            ns: sorted(set(keys) - set(base.get(ns, [])))
            for ns, keys in now.items()
            if set(keys) - set(base.get(ns, []))
        }
        removed = {
            ns: sorted(set(keys) - set(now.get(ns, [])))
            for ns, keys in base.items()
            if set(keys) - set(now.get(ns, []))
        }
        self.violate(
            f"cycle {cycle}: PMIx store residue — end-of-cycle "
            f"snapshot is not byte-identical to the pre-storm "
            f"baseline (added={added}, removed={removed})")

    def grab_traces(self, job: _TenantJob, expect: int = 1) -> None:
        """Best-effort ztrace payload grab from the IN-PROCESS root
        store while the fault job's namespace is still alive: the
        ``trace:<job>:<rank>`` buffers ride the metrics publisher, so
        a kill -9 victim's last window survives it.  Waits briefly for
        a window that contains the fault classification (the publisher
        cadence lags the recovery)."""
        if job.job_id is None:
            return
        store = self.tree.root.store
        deadline = time.monotonic() + 8.0
        payloads: list[dict] = []
        while time.monotonic() < deadline:
            try:
                found = store.lookup(job.job_id, "trace:")
            except errors.MpiError:
                return
            payloads = [v for _, v in sorted(found.items())
                        if isinstance(v, dict)]
            if len(payloads) >= expect and any(
                    s.get("kind") == "ft_class"
                    for p in payloads for s in p.get("spans", ())):
                break
            time.sleep(0.2)
        if payloads:
            self.trace_snaps.append(
                {"job": job.job_id, "name": job.name,
                 "payloads": payloads})

    def grab_metrics(self, job: _TenantJob) -> None:
        """Best-effort fleet-visible snapshot while the fault job is
        still live (its namespace — and the published flightrec
        windows riding it — dies with the job)."""
        if job.job_id is None:
            return
        try:
            cli = dvm_mod.DvmClient(self.tree.root.address)
            try:
                agg = cli.metrics(job.job_id, timeout=5.0)
            finally:
                cli.close()
            self.metrics_snaps.append(
                {"job": job.job_id, "name": job.name,
                 "aggregate": agg.get("aggregate", agg)})
        except errors.MpiError:
            pass

    # -- cycle shapes -----------------------------------------------------

    def plan(self) -> list[dict]:
        plans = []
        for i in range(self.args.cycles):
            r = self.rng.random()
            if r < 0.18 and self.args.daemons >= 3:
                shape = "daemon"
            elif r < 0.36:
                shape = "queue"
            else:
                shape = "storm"
            plan = {"cycle": i, "shape": shape}
            if shape == "storm":
                plan["scenario"] = self.rng.choice(
                    ["rank_kill", "recover", "elastic", "rank_kill"])
                plan["victim"] = self.rng.randrange(
                    1, max(2, int(self.args.ranks)))
            elif shape == "queue":
                plan["policy"] = self.rng.choice(["fifo", "priority"])
                plan["priorities"] = [0, 5, 3] \
                    if plan["policy"] == "priority" else [0, 0, 0]
            plans.append(plan)
        return plans

    def run_cycle(self, plan: dict) -> None:
        shape = plan["shape"]
        print(f"zsoak: cycle {plan['cycle'] + 1}/{self.args.cycles} "
              f"shape={shape}"
              + (f" scenario={plan['scenario']}"
                 if shape == "storm" else ""), flush=True)
        if shape == "storm":
            self.cycle_storm(plan)
        elif shape == "daemon":
            self.cycle_daemon(plan)
        else:
            self.cycle_queue(plan)
        leftovers = dvm_mod.queued_admission_tickets()
        if leftovers:
            self.violate(f"cycle {plan['cycle']}: admission tickets "
                         f"leaked mid-run: {leftovers}")
        self.check_store_residue(plan["cycle"])

    def cycle_storm(self, plan: dict) -> None:
        i, scenario, victim = plan["cycle"], plan["scenario"], \
            plan["victim"]
        flag = os.path.join(self.workdir, f"flag_{i}")
        tok_s, tok_a = f"c{i}s", f"c{i}a"
        sentinel = _TenantJob(
            self, f"c{i}-sentinel", 2,
            [self.progs["sentinel"], tok_s, flag, "3"], {0})
        try:
            nr = int(self.args.ranks)  # --ranks: overlay soak scale
            if scenario == "rank_kill":
                job = _TenantJob(
                    self, f"c{i}-rank_kill", nr,
                    [self.progs["park"], tok_a, str(victim)], {137},
                    ft=True, metrics=True, trace=True,
                    placement="spread")
                self.drive_rank_kill(i, job, victim, n=nr)
            elif scenario == "recover":
                ckpt = os.path.join(self.workdir, f"ckpt_{i}")
                job = _TenantJob(
                    self, f"c{i}-recover", nr,
                    [self.progs["recover"], tok_a, str(victim), ckpt],
                    {0}, ft=True, metrics=True, trace=True)
                self.drive_recover(i, job, n=nr)
            else:  # elastic
                job = _TenantJob(
                    self, f"c{i}-elastic", 2,
                    [self.progs["elastic"], tok_a, "60", "2"], {0},
                    ft=True, max_size=4)
                self.drive_elastic(i, job)
            self.check_rc(i, job)
        finally:
            with open(flag, "w"):
                pass
        self.check_sentinel(i, sentinel)

    def drive_rank_kill(self, i: int, job: _TenantJob,
                        victim: int, n: int = 3) -> None:
        if not job.wait_output("READY", n):
            self.violate(f"cycle {i}: rank_kill job never got READY: "
                         f"{job.out.getvalue()!r} "
                         f"{job.err.getvalue()!r}")
            return
        job_id = job.job_id
        try:
            cli = dvm_mod.DvmClient(self.tree.root.address)
            try:
                pid = cli.pids(job_id).get(victim)
            finally:
                cli.close()
        except errors.MpiError as e:
            self.violate(f"cycle {i}: pids RPC failed: {e}")
            return
        if not pid:
            self.violate(f"cycle {i}: no pid for victim rank {victim}")
            return
        self.inject(job_id, "rank_kill", i)
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError as e:
            self.violate(f"cycle {i}: kill -9 {pid} failed: {e}")
            return
        if job.wait_output("SURVIVOR-OK", n - 1):
            self.grab_traces(job, expect=n - 1)
            self.grab_metrics(job)
            self.fault_jobs += 1

    def drive_recover(self, i: int, job: _TenantJob,
                      n: int = 3) -> None:
        # the victim kills itself right after READY: just witness the
        # pipeline far enough to snapshot the fleet-visible window
        deadline = time.monotonic() + 30.0
        while job.job_id is None and job.thread.is_alive() \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        self.inject(job.job_id, "suicide", i)
        if job.wait_output("SURVIVOR-OK", n - 1, timeout=120.0):
            self.grab_traces(job, expect=n - 1)
            self.grab_metrics(job)
            self.fault_jobs += 1

    def drive_elastic(self, i: int, job: _TenantJob) -> None:
        deadline = time.monotonic() + 60.0
        while job.job_id is None:
            if time.monotonic() > deadline or not job.thread.is_alive():
                self.violate(f"cycle {i}: elastic job never admitted: "
                             f"{job.err.getvalue()!r}")
                return
            time.sleep(0.05)
        job_id = job.job_id
        try:
            cli = dvm_mod.DvmClient(self.tree.root.address)
            try:
                for new_n, live in ((4, 2), (2, 4)):
                    deadline = time.monotonic() + 60.0
                    while True:
                        view = cli.stat()["jobs"].get(job_id)
                        if view is not None and view["live"] == live:
                            break
                        if time.monotonic() > deadline \
                                or view is None:
                            self.violate(
                                f"cycle {i}: elastic live never "
                                f"reached {live}")
                            return
                        time.sleep(0.1)
                    time.sleep(0.3)
                    cli.resize(job_id, new_n, timeout=90.0)
            finally:
                cli.close()
        except errors.MpiError as e:
            self.violate(f"cycle {i}: resize failed: {e}")

    def cycle_daemon(self, plan: dict) -> None:
        i = plan["cycle"]
        flag = os.path.join(self.workdir, f"flag_{i}")
        sentinel = _TenantJob(
            self, f"c{i}-sentinel", 2,
            [self.progs["sentinel"], f"c{i}s", flag, "3"], {0})
        try:
            if not sentinel.wait_output("READY", 2):
                self.violate(f"cycle {i}: sentinel never READY: "
                             f"{sentinel.err.getvalue()!r}")
                return
            # predict the exclusive job's placement from the daemon's
            # own policy function over the SAME inputs — determinism is
            # an invariant, so a mismatch with reality is a violation
            daemons = self.tree.daemon_ids()
            predicted, fell_back = dvmtree.place_job(
                list(range(4)), daemons, self.busy_map(), "exclusive")
            child_hosted = sorted(
                r for r, d in predicted.items()
                if d in self.tree.child_ids())
            victims = []
            if child_hosted and not fell_back:
                doomed = predicted[child_hosted[0]]
                victims = sorted(r for r, d in predicted.items()
                                 if d == doomed)
            if not victims or len(victims) == 4:
                # the tree is too contended for a survivable daemon
                # kill this cycle: degrade to a plain rank kill, still
                # under exclusive placement (deterministic from the
                # same prediction)
                job = _TenantJob(
                    self, f"c{i}-daemon(rank)", 4,
                    [self.progs["park"], f"c{i}a", "1"], {137},
                    ft=True, metrics=True, placement="exclusive")
                self.drive_rank_kill(i, job, 1, n=4)
            else:
                job = _TenantJob(
                    self, f"c{i}-daemon_kill", 4,
                    [self.progs["park"], f"c{i}a",
                     ",".join(str(v) for v in victims)], {137},
                    ft=True, metrics=True, trace=True,
                    placement="exclusive")
                if not job.wait_output("READY", 4):
                    self.violate(
                        f"cycle {i}: daemon_kill job never READY: "
                        f"{job.out.getvalue()!r} "
                        f"{job.err.getvalue()!r}")
                    self.check_rc(i, job)
                    return
                actual = self.placement_of(job.job_id)
                if actual and actual != predicted:
                    self.violate(
                        f"cycle {i}: placement not deterministic — "
                        f"predicted {predicted}, daemon placed "
                        f"{actual}")
                self.inject(job.job_id, "daemon_kill", i)
                try:
                    self.tree.kill_child(doomed)
                except errors.MpiError as e:
                    self.violate(f"cycle {i}: daemon kill failed: {e}")
                if job.wait_output("SURVIVOR-OK", 4 - len(victims)):
                    self.grab_traces(job, expect=4 - len(victims))
                    self.grab_metrics(job)
                    self.fault_jobs += 1
            self.check_rc(i, job)
        finally:
            with open(flag, "w"):
                pass
        self.check_sentinel(i, sentinel)
        self.tree.replace_dead(self.args.daemons)

    def cycle_queue(self, plan: dict) -> None:
        i = plan["cycle"]
        saved_cap = mca_var.get("dvm_max_concurrent_jobs", 0)
        saved_policy = mca_var.get("dvm_admission_policy", "fifo")
        mca_var.set_var("dvm_max_concurrent_jobs", 1)
        mca_var.set_var("dvm_admission_policy", plan["policy"])
        jobs = []
        try:
            for k, prio in enumerate(plan["priorities"]):
                jobs.append(_TenantJob(
                    self, f"c{i}-q{k}", 2,
                    [self.progs["sentinel"], f"c{i}q{k}", "-", "2"],
                    {0}, priority=prio))
                time.sleep(0.15)  # deterministic enqueue order
            for job in jobs:
                self.check_rc(i, job)
        finally:
            mca_var.set_var("dvm_max_concurrent_jobs", saved_cap)
            mca_var.set_var("dvm_admission_policy", saved_policy)
        queued = [j.name for j in jobs
                  if j.cli.last_queue_position is not None]
        if not queued:
            self.violate(
                f"cycle {i}: cap=1 with 3 overlapping launches parked "
                f"nobody — no [queued, pos] frame ever streamed")

    # -- end-of-run invariants + report -----------------------------------

    def final_invariants(self) -> None:
        checks = [
            ("queued admission tickets",
             dvm_mod.queued_admission_tickets()),
            ("placement-audit failures",
             dvmtree.placement_audit_failures()),
            ("live in-process daemons", dvm_mod.live_dvms()),
            ("orphaned zprted processes",
             dvm_mod.orphaned_daemon_processes()),
            ("live metrics listeners",
             dvm_mod.live_metrics_listeners()),
            ("stale routed-store caches", dvmtree.stale_cache_state()),
            ("live PMIx servers", pmix_mod.live_servers()),
            ("stale PMIx namespaces", pmix_mod.stale_namespaces()),
            ("live device-prober threads",
             mesh_mod.live_prober_threads()),
            ("live respawn threads", recovery.live_respawn_threads()),
            ("orphaned sm ring files", sm_mod.orphaned_ring_files()),
        ]
        for what, found in checks:
            if found:
                self.violate(f"end of run: {what} leaked: {found}")
        session = self.tree.root.session
        residue = glob.glob(f"/dev/shm/*{session}*")
        if residue:
            self.violate(
                f"end of run: /dev/shm residue under session "
                f"{session!r}: {residue}")
        for c in self.tree.children:
            if c["proc"].poll() is None:
                self.violate(
                    f"end of run: child daemon {c['id']} still alive")

    def report(self) -> None:
        counters = spc.snapshot()

        def delta(name: str) -> int:
            return counters.get(name, 0) - self.counters0.get(name, 0)

        print("\nzsoak: daemon counter aggregates (stat RPC plane):")
        for name in ("dvm_jobs_launched", "dvm_jobs_queued",
                     "dvm_queue_wait_ms", "dvm_fault_events",
                     "dvm_respawns", "dvm_resizes",
                     "dvm_placement_fallbacks",
                     "dvm_placement_audit_failures"):
            print(f"  {name:32s} {delta(name)}")
        legs = recovery.mttr_legs(flightrec.window(None),
                                  flightrec.anchors())
        print(f"\nzsoak: per-fault MTTR postmortem ({len(legs)} fault "
              f"event(s); report-only — ordering truth, not latency "
              f"truth):")
        print(f"  {'job':8s} {'cause':12s} {'deaths':10s} "
              f"{'detect_ms':>10s} {'rollback_ms':>12s} "
              f"{'respawn_ms':>11s} {'shrink_ms':>10s} {'grow_ms':>9s}")
        injected = {inj["job"]: inj for inj in self.injections
                    if inj["job"] is not None}
        for rec in legs:
            inj = injected.get(rec["job"])
            detect = "" if inj is None else \
                f"{(rec['t_fault'] - inj['t_wall']) * 1000:.1f}"
            ms = rec["legs_ms"]

            def leg(name: str) -> str:
                return "" if name not in ms else f"{ms[name]:.1f}"

            print(f"  {str(rec['job']):8s} {str(rec['cause']):12s} "
                  f"{str(rec['deaths']):10s} {detect:>10s} "
                  f"{leg('rollback'):>12s} {leg('respawn'):>11s} "
                  f"{leg('shrink'):>10s} {leg('grow'):>9s}")
        if self.trace_snaps:
            from . import ztrace as ztrace_tool

            print(f"\nzsoak: ztrace-merged per-fault timelines "
                  f"({len(self.trace_snaps)} fault job(s); "
                  f"clock-corrected spans, critical-path leg named):")
            for snap in self.trace_snaps[-4:]:
                spans = ztrace_tool.corrected_spans(snap["payloads"],
                                                    None)
                recoveries = ztrace_tool._recovery_legs(spans)
                if not recoveries:
                    print(f"  {snap['name']}: no recovery spans in "
                          f"the published windows")
                    continue
                for rec in recoveries:
                    print(f"  {snap['name']}: victim {rec['victim']} "
                          f"({rec['cause']}), "
                          f"{len(rec['legs'])} leg span(s)")
                    for s in sorted(rec["legs"],
                                    key=lambda s: s["ts"]):
                        mark = "  <-- critical path" \
                            if s is rec["longest"] else ""
                        print(f"    {s['kind']:8s} rank {s['tid']} "
                              f"{s['dur'] * 1e3:9.2f} ms{mark}")
        if self.metrics_snaps:
            print(f"\nzsoak: fleet-visible metrics snapshots "
                  f"({len(self.metrics_snaps)} fault job(s)):")
            for snap in self.metrics_snaps[-3:]:
                agg = snap["aggregate"] or {}
                keys = {k: agg[k] for k in sorted(agg)
                        if k.startswith(("dvm_", "ft_", "coll_"))
                        and agg[k]}
                print(f"  {snap['name']}: {keys}")


def main(args: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="zsoak",
        description="multi-tenant DVM fault-storm soak harness "
                    "(seeded, deterministic; exit 0 = zero invariant "
                    "violations)")
    ap.add_argument("--cycles", type=int, default=5,
                    help="storm cycles to run (default 5)")
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed: the whole storm replays from it")
    ap.add_argument("--daemons", type=int, default=4,
                    help="tree size: 1 in-process root + N-1 zprted "
                         "subprocess children (default 4)")
    ap.add_argument("--ranks", type=int, default=3,
                    help="fault-storm job size: ranks per rank_kill/"
                         "recover job (default 3) — raise it to soak "
                         "the log-degree FT overlay at scale (e.g. "
                         "--ranks 128 floods a 128-member universe "
                         "per storm)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir for worker programs/checkpoints "
                         "(default: a fresh temp dir)")
    ns = ap.parse_args(args)
    if ns.cycles < 1 or ns.daemons < 2 or ns.ranks < 3:
        ap.error("--cycles >= 1, --daemons >= 2 and --ranks >= 3")
    if ns.workdir is None:
        import tempfile

        ns.workdir = tempfile.mkdtemp(prefix="zsoak_")
    os.makedirs(ns.workdir, exist_ok=True)
    t0 = time.monotonic()
    flightrec.arm()
    harness = None
    try:
        harness = _Harness(ns)
        for plan in harness.plan():
            harness.run_cycle(plan)
    finally:
        try:
            if harness is not None:
                harness.tree.stop()
        finally:
            flightrec.disarm()
    if harness is None:
        return 1
    harness.final_invariants()
    harness.report()
    took = time.monotonic() - t0
    if harness.violations:
        print(f"\nzsoak: FAILED seed={ns.seed} cycles={ns.cycles} — "
              f"{len(harness.violations)} violation(s) in {took:.1f}s "
              f"(replay: --cycles {ns.cycles} --seed {ns.seed}):",
              flush=True)
        for v in harness.violations:
            print(f"  - {v}", flush=True)
        return 1
    print(f"\nzsoak: OK seed={ns.seed} cycles={ns.cycles} "
          f"faults={harness.fault_jobs} violations=0 in {took:.1f}s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
