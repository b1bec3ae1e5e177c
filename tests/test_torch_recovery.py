"""The port's recovery pipeline (``ft/recovery.py``) and the fault plan's
checkpoint seams (``ft/inject.py``) held against the JAX package's.

- ``rollback``: the restored state and step, the ``ckpt_restore`` flight
  recorder event with its bytes, the hygiene registry of touched
  directories and its orphaned-partial scan.
- ``await_rejoin`` on an endpoint and on a bare ``FailureState``;
  ``spawn_replacement``/``RespawnHandle`` (results, re-raised failures,
  the join timeout, the live-thread registry); ``respawn_rank`` and
  ``LocalUniverse.respawn_rank`` refusals; ``respawn_victims`` without
  fault tolerance.
- ``mttr_legs`` over the same flight-recorder windows gives the same
  legs in both packages.
- The runtime half: ``daemon_respawn`` and ``ElasticSession`` keep the
  namesake's error contract, and ``ElasticSession`` reads resize events
  from a store as the namesake's does (the real-process respawns are in
  ``tests/test_torch_ulfm.py``).  The checkpoint seams
  ``ckpt_fault``, ``arm_ckpt``, ``CkptSeamContext`` and
  ``corrupt_ckpt_shard`` (``io/ckptio.py``) build the namesake's
  schedules.
"""

import os
import threading
import time

import numpy as np
import pytest

from zhpe_ompi_tpu.ft import recovery as jrecovery
from zhpe_ompi_tpu.ft import ulfm as julfm
from zhpe_ompi_tpu.pt2pt import universe as juniverse
from zhpe_ompi_tpu.runtime import checkpoint as jcheckpoint
from zhpe_ompi_tpu.runtime import flightrec as jflightrec
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.ft import inject as tinject
from zhpe_ompi_tpu_torch.ft import recovery as trecovery
from zhpe_ompi_tpu_torch.ft import ulfm as tulfm
from zhpe_ompi_tpu_torch.pt2pt import universe as tuniverse
from zhpe_ompi_tpu_torch.runtime import checkpoint as tcheckpoint
from zhpe_ompi_tpu_torch.runtime import flightrec as tflightrec
from zhpe_ompi_tpu_torch.utils import deadline as tdeadline

PKGS = [(jrecovery, julfm, jcheckpoint, jflightrec),
        (trecovery, tulfm, tcheckpoint, tflightrec)]


@pytest.fixture(autouse=True)
def _port_ft_hygiene():
    fps = tulfm.false_positive_count()
    yield
    tulfm.clear_expected_failures()
    assert tulfm.false_positive_count() == fps
    assert tulfm.live_detectors() == []
    assert trecovery.live_respawn_threads() == []
    assert tdeadline.live_watchdog_threads() == []
    assert tdeadline.orphaned_probe_processes() == []


def same(run):
    ref = run(*PKGS[0])
    got = run(*PKGS[1])
    assert got == ref, (got, ref)
    return got


def test_rollback_restores_and_records_the_leg(tmp_path):
    def run(recovery, ulfm, checkpoint, flightrec):
        d = str(tmp_path / recovery.__name__.split(".")[0])
        ck = checkpoint.Checkpointer(d, check_quiescent=False)
        ck.save(4, {"w": np.arange(8, dtype=np.float32), "s": 3},
                blocking=True)
        flightrec.arm()
        try:
            state, step = recovery.rollback(ck)
            window = flightrec.window()
        finally:
            flightrec.disarm()
            flightrec.clear()
        evt = [e for e in window if e["type"] == flightrec.CKPT_RESTORE][-1]
        return (step, np.asarray(state["w"]).tolist(), state["s"],
                evt["step"], os.path.abspath(d) in recovery._RECOVERY_DIRS,
                recovery.orphaned_checkpoint_partials())

    got = same(run)
    assert got[:3] == (4, list(range(8)), 3) and got[3] == 4 and got[4]
    assert got[5] == []


def test_orphaned_partials_are_found(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    trecovery.register_recovery_dir(str(d))
    (d / "step_3.tmp").mkdir()
    try:
        assert trecovery.orphaned_checkpoint_partials() == [
            str(d / "step_3.tmp")]
    finally:
        (d / "step_3.tmp").rmdir()
    assert trecovery.orphaned_checkpoint_partials() == []


def test_await_rejoin_on_an_endpoint_and_a_bare_state():
    def run(recovery, ulfm, *_):
        st = ulfm.FailureState(3)
        st.mark_failed(1, cause="killed")

        class Ep:
            ft_state = st

        early = recovery.await_rejoin(Ep(), 1, timeout=0.05)
        t = threading.Timer(0.05, lambda: st.restore(1))
        t.start()
        try:
            late = recovery.await_rejoin(st, 1, timeout=5.0)
        finally:
            t.join()
        return early, late

    assert same(run) == (False, True)


def test_spawn_replacement_results_failures_and_registry():
    def run(recovery, ulfm, *_):
        ok = recovery.spawn_replacement(lambda: 41 + 1, rank=3)
        bad = recovery.spawn_replacement(
            lambda: (_ for _ in ()).throw(ValueError("second death")),
            rank=2)
        out = [ok.result(timeout=10.0), ok.rank]
        with pytest.raises(ValueError, match="second death"):
            bad.result(timeout=10.0)
        gate = threading.Event()
        slow = recovery.spawn_replacement(gate.wait, rank=1, name="slow-1")
        with pytest.raises(Exception, match="did not finish"):
            slow.result(timeout=0.05)
        out.append([t.name for t in recovery.live_respawn_threads()])
        gate.set()
        slow.result(timeout=10.0)
        out.append(recovery.live_respawn_threads())
        return out

    assert same(run) == [42, 3, ["slow-1"], []]


def test_respawn_refusals():
    def run(recovery, ulfm, checkpoint, flightrec):
        uni_mod = juniverse if recovery is jrecovery else tuniverse
        out = []
        plain = uni_mod.LocalUniverse(2)
        ft_uni = uni_mod.LocalUniverse(3, ft=True)
        for call in (lambda: plain.respawn_rank(1),
                     lambda: ft_uni.respawn_rank(7),
                     lambda: ft_uni.respawn_rank(1),
                     lambda: recovery.respawn_victims(
                         plain.contexts[0], lambda v: None)):
            try:
                call()
                out.append(None)
            except Exception as e:  # noqa: BLE001 - the class is the outcome
                out.append(type(e).__name__)
        for u in (plain, ft_uni):
            getattr(u, "close", lambda: None)()
        return out

    assert same(run) == ["UnsupportedError", "RankError", "ArgError",
                         "UnsupportedError"]


def test_respawn_rank_takes_the_slot_and_adopts_counters():
    def run(recovery, ulfm, *_):
        uni_mod = juniverse if recovery is jrecovery else tuniverse
        uni = uni_mod.LocalUniverse(3, ft=True)
        try:
            uni.contexts[0]._coll_seq = 5
            uni.contexts[0]._agree_seq = 2
            old = uni.contexts[2]
            uni.ft_state.mark_failed(2, cause="killed")
            h = recovery.respawn_rank(
                uni, 2, lambda ctx: (ctx.rank, ctx._coll_seq,
                                     ctx._agree_seq))
            out = h.result(timeout=10.0)
            return (out, uni.contexts[2] is not old,
                    sorted(uni.ft_state.failed()),
                    uni.ft_board.is_dead(2))
        finally:
            getattr(uni, "close", lambda: None)()

    assert same(run) == ((2, 5, 2), True, [], False)


def test_mttr_legs_match_on_the_same_window():
    t0 = 1_000_000_000
    window = [
        {"type": "ft_class", "t_ns": t0 - 10, "rank": 1, "cause": "device"},
        {"type": "device_fault", "t_ns": t0, "rank": 1, "kind": "deadline"},
        {"type": "ckpt_restore", "t_ns": t0 + 2_000_000, "step": 4,
         "bytes": 320},
        {"type": "respawn", "t_ns": t0 + 5_000_000, "ranks": [1]},
        {"type": "resize", "t_ns": t0 + 6_000_000, "kind": "shrink"},
        {"type": "daemon_fault", "t_ns": t0 + 9_000_000, "job": "j",
         "cause": "killed", "deaths": [2]},
        {"type": "respawn", "t_ns": t0 + 12_000_000, "job": "j"},
        {"type": "resize", "t_ns": t0 + 13_000_000, "kind": "grow",
         "job": "j"},
    ]
    anchors = (1700000000.0, t0)
    for job in (None, "j"):
        got = trecovery.mttr_legs(window, anchors, job=job)
        assert got == jrecovery.mttr_legs(window, anchors, job=job)
    legs = trecovery.mttr_legs(window, anchors)
    assert legs[0]["legs_ms"] == {"rollback": 2.0, "respawn": 5.0,
                                  "shrink": 6.0}
    assert legs[0]["rollback_step"] == 4 and legs[0]["rollback_bytes"] == 320
    assert legs[1]["legs_ms"] == {"respawn": 3.0, "grow": 4.0}


def test_what_waits_for_the_runtime_half_raises_naming_it(tmp_path, monkeypatch):
    """The runtime half is ported: ``daemon_respawn`` and
    ``ElasticSession`` keep the namesake's error contract (the same types
    and messages) without a daemon, and ``ElasticSession`` reads the
    daemon's ``resize:<seq>`` events from a store as the namesake's does
    (one live rank's window, probing only the next dense seq)."""
    from zhpe_ompi_tpu.core import errors as jerrors
    from zhpe_ompi_tpu.runtime import pmix as jpmix
    from zhpe_ompi_tpu_torch.runtime import pmix as tpmix

    for k in ("ZMPI_DVM", "ZMPI_JOB", "ZMPI_PMIX", "ZMPI_ELASTIC_SEEN"):
        monkeypatch.delenv(k, raising=False)
    for call in (lambda rec: rec.daemon_respawn([1]),
                 lambda rec: rec.daemon_respawn([1], dvm=("127.0.0.1", 1))):
        with pytest.raises(terrors.UnsupportedError) as port:
            call(trecovery)
        with pytest.raises(jerrors.UnsupportedError) as ref:
            call(jrecovery)
        assert str(port.value) == str(ref.value)

    def events(recovery, ulfm, pmix, errors):
        class Ep:
            rank, size = 0, 1
            ft_state = ulfm.FailureState(1)

            def shrink(self):
                return self

        msgs = []
        for kw in ({}, {"store": object()}):
            with pytest.raises((errors.UnsupportedError, errors.ArgError)) as e:
                recovery.ElasticSession(Ep(), **kw)
            msgs.append((type(e.value).__name__, str(e.value)))
        store = pmix.PmixStore()
        store.ensure_ns("job", 1)
        ses = recovery.ElasticSession(Ep(), store=store, ns="job", seen=0)
        seen = [ses.event()]
        for seq, kind in ((2, "grow"), (1, "shrink"), (10, "grow")):
            store.put("job", -1, f"resize:{seq}",
                      {"seq": seq, "kind": kind, "ranks": [3],
                       "live": [0], "generation": seq})
            store.commit("job", -1)
            seen.append(ses.event())
        ses.close()
        store.close()
        return msgs, seen

    got = events(trecovery, tulfm, tpmix, terrors)
    assert got == events(jrecovery, julfm, jpmix, jerrors)
    assert got[1] == [None, None, {"seq": 1, "kind": "shrink", "ranks": [3],
                                   "live": [0], "generation": 1},
                      {"seq": 1, "kind": "shrink", "ranks": [3], "live": [0],
                       "generation": 1}]
    # the checkpoint seams no longer wait (io/ckptio.py is ported; its
    # drills are in tests/test_torch_ckptio.py): the schedules they build
    # are the namesake's
    from zhpe_ompi_tpu.core import errors as jerrors
    from zhpe_ompi_tpu.ft import inject as jinject

    def seams(inject, errs):
        plan = inject.FaultPlan(seed=1)
        plan.ckpt_fault(0, "write")
        plan.ckpt_kill_aggregator(1, after_shards=2)
        plan.ckpt_kill_writer(2)
        plan.ckpt_wedge_write(0, hold_s=0.1, times=2)
        with plan.arm_ckpt(3):
            pass
        with pytest.raises(errs.ArgError, match="no complete checkpoint"):
            inject.corrupt_ckpt_shard(str(tmp_path))
        return ([plan.ckpt_faults_for(r) for r in range(4)],
                plan.ckpt_victims)

    assert seams(tinject, terrors) == seams(jinject, jerrors)


def test_respawn_victims_batches_and_reenters_on_thread_ranks():
    """One agree -> shrink -> rollback -> respawn pass over two victims
    (the namesake's respawn_victims), run on both packages."""
    n = 4

    def run(recovery, ulfm, checkpoint, flightrec):
        uni_mod = juniverse if recovery is jrecovery else tuniverse
        uni = uni_mod.LocalUniverse(n, ft=True)
        for v in (1, 2):
            uni.ft_state.mark_failed(v, cause="killed")
        handles: dict = {}
        rolled = []

        def second_life(ctx):
            for v in (1, 2):
                assert ctx.ft_state.wait_restored(v, timeout=10.0)
            ctx.barrier()
            return ctx.rank

        def prog(ctx):
            if ctx.rank in (1, 2):
                return None
            shrunk, victims = recovery.respawn_victims(
                ctx, lambda vs: handles.update(
                    recovery.respawn_ranks(uni, vs, second_life)),
                rollback_fn=lambda sh: rolled.append(sh.size))
            for v in victims:
                assert recovery.await_rejoin(ctx, v, timeout=10.0)
            ctx.barrier()
            return victims, shrunk.size, shrunk.rank

        try:
            res = uni.run(prog, timeout=60.0)
            seconds = {v: h.result(timeout=30.0) for v, h in handles.items()}
        finally:
            getattr(uni, "close", lambda: None)()
        return res, seconds, sorted(rolled), sorted(uni.ft_state.failed())

    res, seconds, rolled, failed = same(run)
    assert res[0] == ([1, 2], 2, 0) and res[3] == ([1, 2], 2, 1)
    assert seconds == {1: 1, 2: 2} and rolled == [2, 2] and failed == []


def test_live_respawn_threads_prunes_finished_threads():
    h = trecovery.spawn_replacement(lambda: time.sleep(0.01), rank=0)
    h.result(timeout=10.0)
    assert trecovery.live_respawn_threads() == []
