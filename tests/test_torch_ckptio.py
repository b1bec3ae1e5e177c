"""The port's collective checkpoint plane (``io/ckptio.py``, ``io/fbtl.py``
and ``ft/inject``'s checkpoint seams) held against the JAX package's.

Every test is a counterpart of one of ``tests/test_ckptio.py`` (its class
and test name say which) and runs the same program on the same numpy state
on both packages: ``same(run)`` calls ``run(P)`` with ``P`` the JAX
package's namespace, then the port's, and the outcomes must be equal —
manifest entries (leaf, rank, file, offset, length, digest), restored
values (exactly), restored steps, the stats of ``last_stats`` and the
deltas of the SPC counters.  The port's state is the same numpy arrays as
CPU tensors, and its restores name the CPU (the port restores to the card
by default).

Port only: the ``FtTrainLoop`` overlap run (the namesake drives its own
loop), restore placements, and bfloat16 leaves beside the namesake's
``ml_dtypes.bfloat16`` arrays (the same bytes and digests).

Left out: ``TestRollbackLegInstrumentation::test_mttr_legs_name_the_rollback``
(the namesake's own run of it fails in the repo's test runs; ROADMAP queue
C item 7).  ``TestCkptCrashDrillDvm``'s counterpart runs port rank
processes under the port's daemon, marked ``slow`` as the namesake's is.
"""

import threading
import time
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from zhpe_ompi_tpu.core import errhandler as jerrh
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.ft import inject as jinject
from zhpe_ompi_tpu.io import ckptio as jckptio
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu.runtime import flightrec as jflightrec
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu_torch.core import errhandler as terrh
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.ft import inject as tinject
from zhpe_ompi_tpu_torch.ft import ulfm as tulfm
from zhpe_ompi_tpu_torch.io import ckptio as tckptio
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.runtime import flightrec as tflightrec
from zhpe_ompi_tpu_torch.runtime import spc as tspc

import test_torch_ulfm
from test_torch_ulfm import _port_ft_hygiene  # noqa: F401 - autouse fixture

JAX = types.SimpleNamespace(
    name="jax", ckptio=jckptio, inject=jinject, errors=jerrors, errh=jerrh,
    var=jvar, spc=jspc, flightrec=jflightrec, uni=test_torch_ulfm.JAX,
    leaf=lambda a: a, where=())
PORT = types.SimpleNamespace(
    name="port", ckptio=tckptio, inject=tinject, errors=terrors, errh=terrh,
    var=tvar, spc=tspc, flightrec=tflightrec, uni=test_torch_ulfm.PORT,
    leaf=torch.from_numpy, where=("cpu",))

CKPT_COUNTERS = ("ckpt_bytes_written", "ckpt_shards_written",
                 "ckpt_gather_bytes", "ckpt_delta_skips",
                 "ckpt_integrity_rejects", "ckpt_degraded_restores",
                 "ckpt_restore_bytes", "ckpt_write_retries",
                 "ckpt_write_deadline_failures")


@pytest.fixture(autouse=True)
def _no_stale_jax_universes():
    """Retire the thread universes earlier files of this xdist worker left
    in the JAX package's live set (its ``LocalUniverse`` has no
    ``close()``): the JAX side's quiescence check reads every live one, so
    a posted receive another file abandoned would fail this file's saves
    (ROADMAP C7)."""
    from zhpe_ompi_tpu.pt2pt import universe as juniverse

    for uni in list(juniverse._live_universes):
        juniverse._live_universes.discard(uni)
    yield


def same(run):
    """``run(P)`` on the JAX package, then on the port; equal outcomes."""
    ref = run(JAX)
    got = run(PORT)
    assert got == ref, (got, ref)
    return got


@pytest.fixture()
def both_vars():
    """Snapshot/restore both packages' MCA registries around a test."""
    saved = [(reg, {v.name: (v._value, v._source)
                    for v in reg.registry.all_vars()})
             for reg in (tvar, jvar)]
    yield
    for reg, snap in saved:
        for v in reg.registry.all_vars():
            if v.name in snap:
                v._value, v._source = snap[v.name]


def set_vars(**kv):
    for P in (JAX, PORT):
        for k, v in kv.items():
            P.var.set_var(k, v)


def _state(P, scale=1.0):
    """The namesake's small replicated state (leaf 0 = 'b', leaf 1 = 'w'),
    in ``P``'s leaf kind."""
    return {
        "b": P.leaf(np.arange(16, dtype=np.float32) * np.float32(scale)),
        "w": P.leaf(np.arange(64, dtype=np.float32) * np.float32(scale)
                    + np.float32(1.0)),
    }


def _values(tree):
    """A restored tree as plain lists (exact comparison across packages)."""
    return {k: np.asarray(v).tolist() for k, v in sorted(tree.items())}


def _restore(P, ck, step=None):
    got, s = ck.restore(step, *P.where)
    return _values(got), s


def _counters(P, before):
    return {k: P.spc.read(k) - before[k] for k in CKPT_COUNTERS}


def _before(P):
    return {k: P.spc.read(k) for k in CKPT_COUNTERS}


def _manifest(P, directory, step):
    m = P.ckptio._read_manifest(f"{directory}/step_{step}")
    return None if m is None else {
        "world": m["world"], "n_leaves": m["n_leaves"], "gen": m["gen"],
        "leaves": m["leaves"], "shards": m["shards"]}


def _hygiene(P):
    return (P.ckptio.live_writer_threads(), P.ckptio.orphaned_shard_temps(),
            P.ckptio.incomplete_manifests())


def _quiet(P, timeout=10.0):
    """Wait for abandoned wedged write attempts to finish their sleeps."""
    deadline = time.monotonic() + timeout
    while P.ckptio.live_writer_threads():
        assert time.monotonic() < deadline
        time.sleep(0.05)


# -- TestManifestAndDigest -----------------------------------------------


def test_roundtrip_and_manifest_shape(tmp_path):
    def run(P):
        d = tmp_path / P.name
        ck = P.ckptio.CollectiveCheckpointer(str(d))
        before = _before(P)
        ck.save(3, _state(P), blocking=True)
        return (ck.all_steps(), _restore(P, ck), _manifest(P, d, 3),
                ck.in_flight, _hygiene(P), _counters(P, before))

    got = same(run)
    assert got[2]["world"] == 1 and len(got[2]["shards"]) == 2
    assert all(len(e["digest"]) == 32 for e in got[2]["shards"])
    assert got[4] == ([], [], [])


def test_bfloat16_leaves_have_the_namesakes_bytes(tmp_path):
    """A bfloat16 tensor's shards are the bytes (and digests) of the
    namesake's ``ml_dtypes.bfloat16`` array; restore gives it back."""
    a = np.random.default_rng(3).standard_normal(37).astype(np.float32)
    jck = jckptio.CollectiveCheckpointer(str(tmp_path / "jax"))
    jck.save(1, {"h": a.astype(ml_dtypes.bfloat16), "x": a}, blocking=True)
    tck = tckptio.CollectiveCheckpointer(str(tmp_path / "port"))
    h = torch.from_numpy(a).to(torch.bfloat16)
    tck.save(1, {"h": h, "x": torch.from_numpy(a)}, blocking=True)
    assert _manifest(PORT, tmp_path / "port", 1) == \
        _manifest(JAX, tmp_path / "jax", 1)
    got, _ = tck.restore(shardings="cpu")
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], h)


def test_async_save_overlaps_then_drains(tmp_path):
    def run(P):
        ck = P.ckptio.CollectiveCheckpointer(str(tmp_path / P.name))
        release = threading.Event()

        def slow_write(seam, rank, **info):
            if seam == "write":
                release.wait(5.0)

        remove = P.ckptio.install_fault_hook(slow_write)
        P.flightrec.arm()
        try:
            ck.save(1, _state(P), blocking=False)
            parked = ck.in_flight
            release.set()
            ck.wait()
            kinds = [e["type"] for e in P.flightrec.window()]
        finally:
            P.flightrec.disarm()
            P.flightrec.clear()
            remove()
        return (parked, ck.in_flight, "ckpt_begin" in kinds,
                "ckpt_commit" in kinds, _restore(P, ck),
                P.ckptio.live_writer_threads())

    assert same(run)[:4] == (True, False, True, True)


def test_torn_shard_rejected_loudly_degrades(tmp_path):
    def run(P):
        d = tmp_path / P.name
        ck = P.ckptio.CollectiveCheckpointer(str(d))
        ck.save(1, _state(P, 1.0), blocking=True)
        ck.save(2, _state(P, 2.0), blocking=True)
        P.inject.corrupt_ckpt_shard(str(d), step=2, leaf=1, rank=0)
        before = _before(P)
        got = _restore(P, ck)
        with pytest.raises(P.errors.ArgError):
            ck.restore(2, *P.where)
        return got, _counters(P, before)

    got, counters = same(run)
    assert got[1] == 1 and counters["ckpt_degraded_restores"] == 1
    assert counters["ckpt_integrity_rejects"] >= 1


def test_delta_checkpoint_relinks_unchanged_shards(tmp_path):
    def run(P):
        d = tmp_path / P.name
        ck = P.ckptio.CollectiveCheckpointer(str(d))
        s1 = _state(P, 1.0)
        ck.save(1, s1, blocking=True)
        before = _before(P)
        ck.save(2, {"b": s1["b"], "w": s1["w"] + 5.0}, blocking=True)
        return _manifest(P, d, 2), _counters(P, before), _restore(P, ck)

    m2, counters, _ = same(run)
    assert counters["ckpt_delta_skips"] == 1
    by_leaf = {e["leaf"]: e for e in m2["shards"]}
    assert by_leaf[0]["file"].startswith("step_1/")
    assert by_leaf[1]["file"].startswith("step_2/")


def test_delta_descendant_of_torn_base_also_rejected(tmp_path):
    def run(P):
        d = tmp_path / P.name
        ck = P.ckptio.CollectiveCheckpointer(str(d))
        ck.save(0, _state(P, 3.0), blocking=True)
        ck.save(1, _state(P, 1.0), blocking=True)
        ck.save(2, _state(P, 1.0), blocking=True)
        P.inject.corrupt_ckpt_shard(str(d), step=2, leaf=0, rank=0)
        return _restore(P, ck)

    assert same(run)[1] == 0


def test_delta_disabled_rewrites_everything(both_vars, tmp_path):
    set_vars(ckpt_delta=0)

    def run(P):
        d = tmp_path / P.name
        ck = P.ckptio.CollectiveCheckpointer(str(d))
        ck.save(1, _state(P), blocking=True)
        before = _before(P)
        ck.save(2, _state(P), blocking=True)
        return _manifest(P, d, 2), _counters(P, before)

    m2, counters = same(run)
    assert counters["ckpt_delta_skips"] == 0
    assert all(e["file"].startswith("step_2/") for e in m2["shards"])


def test_retention_keeps_delta_referenced_steps(tmp_path):
    def run(P):
        ck = P.ckptio.CollectiveCheckpointer(str(tmp_path / P.name), keep=2)
        for step in (1, 2, 3, 4):
            ck.save(step, _state(P), blocking=True)
        return ck.all_steps(), _restore(P, ck)

    assert same(run)[0] == [1, 3, 4]


def test_incomplete_step_is_invisible_and_healable(tmp_path):
    def run(P):
        d = tmp_path / P.name
        ck = P.ckptio.CollectiveCheckpointer(str(d))
        ck.save(1, _state(P), blocking=True)

        def die_at_manifest(seam, rank, **info):
            if seam == "manifest":
                raise OSError("injected crash before the rename")

        remove = P.ckptio.install_fault_hook(die_at_manifest)
        try:
            with pytest.raises(P.errors.MpiError):
                ck.save(2, _state(P, 2.0), blocking=True)
        finally:
            remove()
        steps = ck.all_steps()
        torn = [p.rsplit("/", 1)[-1] for p in P.ckptio.incomplete_manifests()
                if p.startswith(str(d))]
        got = _restore(P, ck)
        return steps, torn, got, P.ckptio.incomplete_manifests()

    steps, torn, got, after = same(run)
    assert steps == [1] and torn == ["step_2"] and got[1] == 1
    assert after == []


# -- TestDeadlineBoundedWriter --------------------------------------------


def test_wedged_attempt_expires_then_retry_lands(both_vars, tmp_path):
    set_vars(ckpt_write_deadline_s=0.15)

    def run(P):
        plan = P.inject.FaultPlan(seed=5).ckpt_wedge_write(0, hold_s=0.8,
                                                           times=1)
        ck = P.ckptio.CollectiveCheckpointer(str(tmp_path / P.name))
        before = _before(P)
        with plan.arm_ckpt(0):
            ck.save(1, _state(P), blocking=True)
        out = _counters(P, before), _restore(P, ck)
        _quiet(P)
        return out

    counters, _ = same(run)
    assert counters["ckpt_write_retries"] == 1
    assert counters["ckpt_write_deadline_failures"] == 0


def test_wedge_exhausts_budget_typed_failure(both_vars, tmp_path):
    set_vars(ckpt_write_deadline_s=0.1, ckpt_write_retries=1)

    def run(P):
        plan = P.inject.FaultPlan(seed=6).ckpt_wedge_write(0, hold_s=0.5,
                                                           times=8)
        ck = P.ckptio.CollectiveCheckpointer(str(tmp_path / P.name))
        before = _before(P)
        with plan.arm_ckpt(0):
            with pytest.raises(P.ckptio.CheckpointWriteError):
                ck.save(1, _state(P), blocking=True)
        steps = ck.all_steps()
        ck.heal()
        with pytest.raises(P.errors.ArgError):
            ck.restore(None, *P.where)
        _quiet(P)
        return _counters(P, before), steps, P.ckptio.incomplete_manifests()

    counters, steps, torn = same(run)
    assert counters["ckpt_write_deadline_failures"] == 1
    assert steps == [] and torn == []


def test_transient_write_error_is_retried(tmp_path):
    def run(P):
        attempts = []

        def flaky(seam, rank, **info):
            if seam == "write":
                attempts.append(info.get("attempt"))
                if len(attempts) == 1:
                    raise OSError("injected transient EIO")

        ck = P.ckptio.CollectiveCheckpointer(str(tmp_path / P.name))
        before = _before(P)
        remove = P.ckptio.install_fault_hook(flaky)
        try:
            ck.save(1, _state(P), blocking=True)
        finally:
            remove()
        return attempts, _counters(P, before), _restore(P, ck)

    attempts, counters, _ = same(run)
    assert attempts == [0, 1] and counters["ckpt_write_retries"] == 1


def test_abandoned_universes_are_retired_before_a_save(tmp_path):
    """A thread-plane program that leaves a receive posted (as a faulted
    run does) keeps its universe in the live set ``quiesce_check`` reads;
    the JAX package's universe has no ``close()`` and stayed there until
    the cyclic collector ran, so the single-writer saves above failed
    ``checkpoint at non-quiescent point`` on a worker that had run
    ``tests/test_torch_ulfm.py`` first.  ``release_universes`` (every ft
    test's teardown) retires both packages' universes, and the next
    save is quiescent."""
    def run(P):
        uni = P.uni.universe(2)

        def prog(ctx):
            if ctx.rank == 1:
                ctx.irecv(source=0, tag=99)  # posted, never matched

        uni.run(prog)
        posted = P.uni.uni_mod._queue_depth("posted")
        test_torch_ulfm.release_universes()
        after = P.uni.uni_mod._queue_depth("posted")
        ck = P.ckptio.CollectiveCheckpointer(str(tmp_path / P.name))
        ck.save(1, _state(P), blocking=True)
        return posted >= 1, after, ck.all_steps()

    assert same(run) == (True, 0, [1])


# -- TestCollectiveTwoPhase: 4 ft TcpProc ranks in threads, 2 emulated hosts


BOOTS = {0: {"sm_boot_id": "hosta"}, 1: {"sm_boot_id": "hosta"},
         2: {"sm_boot_id": "hostb"}, 3: {"sm_boot_id": "hostb"}}


def _ckpt(P, p, directory):
    ck = P.ckptio.CollectiveCheckpointer(str(directory), ep=p,
                                         check_quiescent=False,
                                         drain_timeout=30.0)
    ck.bind(p)
    return ck


def _run4(P, prog, timeout=60.0):
    return test_torch_ulfm.run_tcp_ft(P.uni, 4, prog, timeout=timeout,
                                      kwargs_by_rank=BOOTS)


def _stats(stats):
    return {k: sorted(v) if isinstance(v, set) else v
            for k, v in stats.items()}


def test_wire_shape_and_collective_roundtrip(both_vars, tmp_path):
    """The manifest at 4 thread ranks: each shard's rank, offset, length
    and digest equal to the namesake's; every rank restores the state."""
    def run(P):
        d = tmp_path / P.name
        before = _before(P)

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            ck = _ckpt(P, p, d)
            ck.save(1, _state(P), blocking=True)
            return _stats(ck.last_stats), _restore(P, ck)

        res = _run4(P, prog)
        return res, _manifest(P, d, 1), _counters(P, before)

    res, m, counters = same(run)
    assert [r[0]["gather_dests"] for r in res] == [[], [0], [], [2]]
    assert m["world"] == 4 and len(m["shards"]) == 8
    assert counters["ckpt_gather_bytes"] == 2 * (16 + 64)
    assert counters["ckpt_bytes_written"] == 64 + 256


def test_collective_delta_sends_nothing_new(both_vars, tmp_path):
    def run(P):
        d = tmp_path / P.name

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            ck = _ckpt(P, p, d)
            ck.save(1, _state(P), blocking=True)
            p.barrier()
            gb0 = P.spc.read("ckpt_gather_bytes")
            ck.save(2, _state(P), blocking=True)
            p.barrier()
            gb1 = P.spc.read("ckpt_gather_bytes")
            return (ck.last_stats["gather_sends"],
                    ck.last_stats["delta_skips"], gb1 - gb0,
                    _restore(P, ck))

        return _run4(P, prog), _manifest(P, d, 2)

    res, m = same(run)
    assert all(r[:3] == (0, 2, 0) and r[3][1] == 2 for r in res)
    assert all(e["file"].startswith("step_1/") for e in m["shards"])


def _crash_seam(P, plan, directory, victim):
    def prog(p):
        p.set_errhandler(P.errh.ERRORS_RETURN)
        ck = _ckpt(P, p, directory)
        ck.save(0, _state(P, 1.0), blocking=True)
        with plan.arm_ckpt(p.rank, ep=p, state=p.ft_state):
            ck.save(1, _state(P, 2.0), blocking=True)
        assert p.ft_state.wait_failed(victim, timeout=15.0)
        p.failure_ack()
        got = _restore(P, ck)
        return got, ck.all_steps()

    return prog


@pytest.mark.parametrize("seam,victim", [("aggregate", 2), ("write", 0)],
                         ids=["kill_aggregator_mid_exchange",
                              "kill_writer_mid_stream"])
def test_kill_seam_degrades_to_the_complete_step(both_vars, tmp_path, seam,
                                                 victim):
    """The crash-seam drills: rank 2 (host B's aggregator) dies after
    collecting one shard, or rank 0 (an aggregator and the committer) dies
    inside its first fbtl write; step 1 never commits and the survivors
    restore step 0."""
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.8)

    def run(P):
        d = tmp_path / P.name
        plan = P.inject.FaultPlan(seed=21)
        if seam == "aggregate":
            plan.ckpt_kill_aggregator(victim, after_shards=1)
        else:
            plan.ckpt_kill_writer(victim, after_writes=0)
        res = _run4(P, _crash_seam(P, plan, d, victim), timeout=90.0)
        return res, P.ckptio.incomplete_manifests()

    res, torn = same(run)
    assert res[victim] == "killed" and torn == []
    for r in set(range(4)) - {victim}:
        assert res[r][0][1] == 0 and res[r][1] == [0]


def test_restore_under_concurrent_rank_failure(both_vars, tmp_path):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.8)

    def run(P):
        d = tmp_path / P.name
        plan = P.inject.FaultPlan(seed=23).kill_rank(3, after_ops=1)
        before = _before(P)

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            ck = _ckpt(P, p, d)
            ck.save(0, _state(P, 1.0), blocking=True)
            ck.save(1, _state(P, 2.0), blocking=True)
            if p.rank == 0:
                P.inject.corrupt_ckpt_shard(str(d), step=1, leaf=1, rank=2)
            p.barrier()
            inj = plan.arm(p)
            try:
                inj.send(p.rank, dest=(p.rank + 1) % 4, tag=1)
                inj.recv(source=(p.rank - 1) % 4, tag=1, timeout=10.0)
            except P.errors.ProcFailed:
                pass
            assert p.ft_state.wait_failed(3, timeout=15.0)
            p.failure_ack()
            return _restore(P, ck)

        res = _run4(P, prog, timeout=90.0)
        return res, _counters(P, before)["ckpt_degraded_restores"]

    res, degraded = same(run)
    assert res[3] == "killed" and degraded == 3
    assert all(res[r][1] == 0 for r in (0, 1, 2))


# -- TestFtLoopOverlap --------------------------------------------------------


def _one_rank(P):
    class Stub:
        rank, size = 0, 1
        ft_state = P.uni.ulfm.FailureState(1)
    return Stub()


def test_serial_cadence_contract_unchanged(tmp_path):
    from zhpe_ompi_tpu.models import ftloop as jftloop
    from zhpe_ompi_tpu_torch.models import ftloop as tftloop

    def run(P):
        loop_mod = jftloop if P is JAX else tftloop
        ck = P.ckptio.CollectiveCheckpointer(str(tmp_path / P.name), keep=20,
                                             check_quiescent=False)
        loop = loop_mod.FtTrainLoop(
            _one_rank(P), step_fn=lambda ep, state, i: (state, 0.0),
            state={"w": P.leaf(np.zeros(8, np.float32))},
            checkpointer=ck, ckpt_every=2)
        loop.run(5)
        return ck.all_steps()

    assert same(run) == [0, 2, 4, 5]


def test_ftloop_overlaps_async_saves_and_drains(tmp_path):
    """Port only: ``FtTrainLoop`` with a ``CollectiveCheckpointer`` binds
    and saves without blocking, counts ``ckpt_async_overlapped``, and its
    last ``wait`` drains the stream: nothing left behind."""
    from zhpe_ompi_tpu_torch.models.ftloop import FtTrainLoop

    def step_fn(ep, state, i):
        w = state["w"]
        return {"w": w - 0.1 * (w - 1.0)}, float(w.mean())

    def slow_write(seam, rank, **info):
        if seam == "write":
            time.sleep(0.1)

    ck = tckptio.CollectiveCheckpointer(str(tmp_path), keep=20,
                                        check_quiescent=False)
    assert ck.async_capable
    over0 = tspc.read("ckpt_async_overlapped")
    remove = tckptio.install_fault_hook(slow_write)
    try:
        loop = FtTrainLoop(_one_rank(PORT), step_fn=step_fn,
                           state={"w": torch.zeros(256)},
                           checkpointer=ck, ckpt_every=1)
        state, losses = loop.run(4)
    finally:
        remove()
    assert len(losses) == 4
    assert tspc.read("ckpt_async_overlapped") > over0
    assert not ck.in_flight and ck.latest_step() == 4
    assert _hygiene(PORT) == ([], [], [])
    got, step = ck.restore(shardings="cpu")
    assert step == 4 and torch.equal(got["w"], state["w"])


def test_restore_places_leaves_by_prefix_tree(tmp_path):
    """Port only: ``shardings`` is a device for every leaf or a pytree of
    devices, a prefix of the state's structure; a mismatch raises."""
    ck = tckptio.CollectiveCheckpointer(str(tmp_path))
    state = {"params": _state(PORT), "step": torch.tensor(3)}
    ck.save(1, state, blocking=True)
    got, _ = ck.restore(shardings={"params": "cpu", "step": "meta"})
    assert got["params"]["w"].device.type == "cpu"
    assert got["step"].device.type == "meta"
    with pytest.raises(terrors.ArgError, match="structure"):
        ck.restore(shardings={"other": "cpu"})
    with pytest.raises(terrors.ArgError, match="dtype"):
        ck.save(2, {"s": np.asarray(["text"])}, blocking=True)
    assert tulfm.live_detectors() == []


# ---------------------------------- the real-process crash drill (slow)


_DVM_CKPT_DRILL_PROG = '''
import os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch.core import errhandler as errh
from zhpe_ompi_tpu_torch.ft import inject, recovery
from zhpe_ompi_tpu_torch.ft.inject import FaultPlan
from zhpe_ompi_tpu_torch.io import ckptio
from zhpe_ompi_tpu_torch.io.ckptio import CollectiveCheckpointer
from zhpe_ompi_tpu_torch.models.ftloop import FtTrainLoop
from zhpe_ompi_tpu_torch.runtime import flightrec, spc

DIM = 256
STEPS = 6
SEAM = os.environ.get("TEST_CKPT_SEAM", "")
VICTIM = int(os.environ.get("TEST_CKPT_VICTIM", "-1"))
AFTER = int(os.environ.get("TEST_CKPT_AFTER", "1"))
CKPT_DIR = os.environ["TEST_CKPT"]

proc = zmpi.host_init()
proc.set_errhandler(errh.ERRORS_RETURN)
flightrec.arm()

rng = np.random.default_rng(7)  # same seed: replicated SPMD state
target = torch.from_numpy(rng.normal(size=DIM).astype(np.float32))
first_life = os.environ.get("ZMPI_REJOIN") != "1"


def step_fn(ep, state, i):
    w = state["w"]
    grad = (2.0 / w.numel()) * (w - target)
    loss = float(((w - target) ** 2).mean())
    # one collective per step: survivors discover faults typed here
    total = ep.allreduce(torch.tensor(loss, dtype=torch.float64), zmpi.SUM)
    return {{"w": w - 0.1 * grad}}, float(total) / ep.size


# slow the aggregator's stream (well under the deadline) so checkpoint
# drains overlap the next training step
if proc.rank == 0:
    def _slow(seam, rank, **info):
        if seam == "write":
            time.sleep(0.05)
    ckptio.install_fault_hook(_slow)

if SEAM and proc.rank == VICTIM and first_life:
    # first incarnation only: the replacement must not re-kill itself
    plan = FaultPlan(seed=11).ckpt_fault(VICTIM, SEAM, after=AFTER,
                                         action="kill9")
    plan.arm_ckpt(proc.rank, ep=proc, state=proc.ft_state).__enter__()

ck = CollectiveCheckpointer(CKPT_DIR, keep=20, check_quiescent=False)
loop = FtTrainLoop(proc, step_fn=step_fn,
                   state={{"w": torch.zeros(DIM)}},
                   checkpointer=ck, ckpt_every=1,
                   respawner=recovery.daemon_respawn,
                   shardings_fn=lambda ep: "cpu")
state, losses = loop.run(STEPS)
window = flightrec.window()
restores = [e for e in window if e["type"] == flightrec.CKPT_RESTORE]
flightrec.disarm()
print(f"CKPT-OK rank={{proc.rank}} size={{proc.size}} "
      f"recoveries={{loop.recoveries}} steps={{len(losses)}} "
      f"final={{losses[-1]:.6f}} "
      f"overlapped={{spc.read('ckpt_async_overlapped')}} "
      f"restores={{len(restores)}}", flush=True)
zmpi.host_finalize()
'''


def _ckpt_drill(tmp_path, seam, victim=1):
    """The drill's 4 rank processes under the port's daemon; returns the
    ranks' CKPT-OK rows."""
    import io
    import os
    import re

    from zhpe_ompi_tpu_torch.runtime import dvm as tdvm

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tag = seam or "ref"
    prog = tmp_path / f"ckpt_drill_{tag}.py"
    prog.write_text(_DVM_CKPT_DRILL_PROG.format(repo=repo))
    env = {"TEST_CKPT": str(tmp_path / f"ckpt_{tag}"), "TEST_CKPT_SEAM": seam,
           "TEST_CKPT_VICTIM": str(victim) if seam else "-1",
           "TEST_CKPT_AFTER": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    d = tdvm.Dvm()
    try:
        cli = tdvm.DvmClient(d.address)
        out, err = io.StringIO(), io.StringIO()
        rc = cli.launch(4, [str(prog)], ft=True, timeout=240.0,
                        mca=[("ft_detector_period", "0.2"),
                             ("ft_detector_timeout", "5.0"),
                             ("flightrec_capacity", "16384")],
                        stdout=out, stderr=err)
        assert rc == 0, (out.getvalue(), err.getvalue())
        cli.stop()
        cli.close()
    finally:
        d.stop()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return re.findall(r"CKPT-OK rank=(\d+) size=(\d+) recoveries=(\d+) "
                      r"steps=(\d+) final=([\d.]+) overlapped=(\d+) "
                      r"restores=(\d+)", out.getvalue())


@pytest.mark.slow
def test_kill9_mid_gather_recovers_and_matches(tmp_path):
    """TestCkptCrashDrillDvm's counterpart: 4 port rank processes under
    the port's daemon train with async collective checkpoints; kill -9 of
    rank 1 at the gather seam (first incarnation only): the survivors
    shrink, roll back from the newest complete step, the daemon respawns
    the rank, and the run ends at full size with the fault-free run's
    losses, rank for rank."""
    ref = {int(r[0]): float(r[4]) for r in _ckpt_drill(tmp_path, "")}
    assert sorted(ref) == [0, 1, 2, 3]
    rows = {int(r[0]): r for r in _ckpt_drill(tmp_path, "gather")}
    assert sorted(rows) == [0, 1, 2, 3], rows
    for rank, (_, size, recov, steps, final, _, restores) in rows.items():
        assert int(size) == 4 and int(steps) == 6
        assert abs(float(final) - ref[rank]) < 1e-5
        assert int(restores) >= 1
        if rank != 1:
            assert int(recov) >= 1
