"""The port's ULFM plane (``ft/ulfm.py``, the ft paths of
``pt2pt/universe.py`` and ``pt2pt/tcp.py``, ``ft/inject.py``) held against
the JAX package's.

Every test is a counterpart of one of ``tests/test_ulfm.py`` (its class and
test name say which) and runs the same program under the same seeded
``FaultPlan`` on both packages: ``both(run)`` calls ``run(P)`` with ``P``
the JAX package's namespace and then the port's, and the discrete outcomes
— victims, failed sets and causes, generations, agreed values, survivors'
results and renumbering — must be equal.  Where the namesake's outcome is
timing-dependent (which survivor's detector fired first), both must fall
in the set the namesake's test allows.

The real-process DVM drills (the namesake's ``TestDvmRealProcessRecovery``
and ``TestDvmMultiVictimRecovery``) run port rank processes under the
port's daemon.  Left out, with what they wait for: the device-plane
``Communicator`` ULFM (held in ``tests/test_torch_comm_split.py``) and the
passive-lock drill (``osc/direct.py``).

An autouse fixture checks, after each test, that no port detector,
prober, watchdog or respawn thread is alive, that no probe child is
orphaned, that the port's false-positive count did not move, and it
closes the port universes the test opened.
"""

import threading
import time
import types

import numpy as np
import pytest

from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.coll import han as jhan
from zhpe_ompi_tpu.coll import host as jcoll_host
from zhpe_ompi_tpu.core import errhandler as jerrh
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.ft import recovery as jrecovery
from zhpe_ompi_tpu.ft import ulfm as julfm
from zhpe_ompi_tpu.ft.inject import FaultPlan as JFaultPlan
from zhpe_ompi_tpu.ft.inject import replay_rejoin as jreplay_rejoin
from zhpe_ompi_tpu.ft.vprotocol import UniverseLogger as JUniverseLogger
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu.pt2pt import groups as jgroups
from zhpe_ompi_tpu.pt2pt import requests as jrequests
from zhpe_ompi_tpu.pt2pt import tcp as jtcp
from zhpe_ompi_tpu.pt2pt import universe as juniverse
from zhpe_ompi_tpu.runtime import checkpoint as jcheckpoint
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.coll import han as than
from zhpe_ompi_tpu_torch.coll import host as tcoll_host
from zhpe_ompi_tpu_torch.core import errhandler as terrh
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.ft import recovery as trecovery
from zhpe_ompi_tpu_torch.ft import ulfm as tulfm
from zhpe_ompi_tpu_torch.ft.inject import FaultPlan as TFaultPlan
from zhpe_ompi_tpu_torch.ft.inject import replay_rejoin as treplay_rejoin
from zhpe_ompi_tpu_torch.ft.vprotocol import UniverseLogger as TUniverseLogger
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.parallel import mesh as tmesh
from zhpe_ompi_tpu_torch.pt2pt import groups as tgroups
from zhpe_ompi_tpu_torch.pt2pt import requests as trequests
from zhpe_ompi_tpu_torch.pt2pt import sm as tsm
from zhpe_ompi_tpu_torch.pt2pt import tcp as ttcp
from zhpe_ompi_tpu_torch.pt2pt import universe as tuniverse
from zhpe_ompi_tpu_torch.runtime import checkpoint as tcheckpoint
from zhpe_ompi_tpu_torch.runtime import spc as tspc
from zhpe_ompi_tpu_torch.utils import deadline as tdeadline

N = 4
ANY_SOURCE = -1

_PORT_UNIVERSES: list = []
_JAX_UNIVERSES: list = []


def _port_universe(n, ft=False):
    uni = tuniverse.LocalUniverse(n, ft=ft)
    _PORT_UNIVERSES.append(uni)
    return uni


def _jax_universe(n, ft=False):
    uni = juniverse.LocalUniverse(n, ft=ft)
    _JAX_UNIVERSES.append(uni)
    return uni


def release_universes():
    """Close the port's universes and retire the JAX package's from its
    live set.  A faulted program abandons posted receives and unexpected
    messages in its universe; the JAX package's ``LocalUniverse`` has no
    ``close()``, so it stays in the live set its ``quiesce_check`` reads
    until the cyclic collector frees it — and until then every
    checkpoint ``save`` on this worker (``tests/test_torch_ckptio.py``'s
    single-writer saves among them) raises ``checkpoint at non-quiescent
    point``."""
    for uni in _PORT_UNIVERSES:
        uni.stop_failure_detector()
        uni.close()
    _PORT_UNIVERSES.clear()
    for uni in _JAX_UNIVERSES:
        uni.stop_failure_detector()
        juniverse._live_universes.discard(uni)
    _JAX_UNIVERSES.clear()


JAX = types.SimpleNamespace(
    name="jax", ops=jops, errh=jerrh, errors=jerrors, ulfm=julfm,
    recovery=jrecovery, FaultPlan=JFaultPlan, replay_rejoin=jreplay_rejoin,
    UniverseLogger=JUniverseLogger, var=jvar, tcp=jtcp, TcpProc=jtcp.TcpProc,
    universe=_jax_universe, uni_mod=juniverse,
    Checkpointer=jcheckpoint.Checkpointer, checkpoint=jcheckpoint,
    coll_host=jcoll_host, groups=jgroups, han=jhan, spc=jspc,
    requests=jrequests,
)
PORT = types.SimpleNamespace(
    name="port", ops=tops, errh=terrh, errors=terrors, ulfm=tulfm,
    recovery=trecovery, FaultPlan=TFaultPlan, replay_rejoin=treplay_rejoin,
    UniverseLogger=TUniverseLogger, var=tvar, tcp=ttcp, TcpProc=ttcp.TcpProc,
    universe=_port_universe, uni_mod=tuniverse,
    Checkpointer=tcheckpoint.Checkpointer, checkpoint=tcheckpoint,
    coll_host=tcoll_host, groups=tgroups, han=than, spc=tspc,
    requests=trequests,
)


def both(run):
    """``run(P)`` on the JAX package, then on the port: (ref, got)."""
    ref = run(JAX)
    got = run(PORT)
    return ref, got


def same(run):
    """``both(run)`` whose outcomes must be equal; returns the port's."""
    ref, got = both(run)
    assert got == ref, (got, ref)
    return got


@pytest.fixture(autouse=True)
def _port_ft_hygiene():
    """The port's ft gates around each test (the repo's session gate in
    tests/conftest.py watches the JAX package only)."""
    fps = tulfm.false_positive_count()
    yield
    release_universes()
    tulfm.clear_expected_failures()
    assert tulfm.false_positive_count() == fps
    assert tulfm.live_detectors() == []
    assert tmesh.live_prober_threads() == []
    assert tdeadline.live_watchdog_threads() == []
    assert trecovery.live_respawn_threads() == []
    assert tdeadline.orphaned_probe_processes() == []
    assert ttcp.live_push_threads() == []
    assert ttcp.orphaned_rndv_descriptors() == []
    assert tsm.orphaned_ring_files() == []
    assert tsm.live_poll_threads() == []


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


def run_tcp_ft(P, n, fn, timeout=60.0, proc_timeout=15.0, sm=None,
               kwargs_by_rank=None):
    """n ft-enabled ``P.TcpProc`` ranks in threads over a localhost
    coordinator (the namesake's ``run_tcp_ft``); a rank killed by a fault
    plan returns "killed"."""
    return run_mixed_ft([P.TcpProc] * n, lambda p, _P: fn(p), sm=sm,
                        timeout=timeout, proc_timeout=proc_timeout,
                        kwargs_by_rank=kwargs_by_rank)


# -- TestErrorClasses / TestFailureState --------------------------------------


def test_jobabort_carries_failed_ranks():
    def run(P):
        abort = P.errh.JobAbort(
            "comm0", P.errors.ProcFailed("dead", failed_ranks=[2]))
        return abort.failed_ranks, abort.errclass

    assert same(run) == ((2,), terrors.ERR_PROC_FAILED)


def test_failure_state_mark_ack_restore():
    def run(P):
        st = P.ulfm.FailureState(4)
        out = [st.live(), st.mark_failed(2, cause="killed"),
               st.mark_failed(2), st.live(), sorted(st.unacked())]
        st.ack()
        out += [sorted(st.acked()), sorted(st.unacked())]
        st.restore(2)
        out += [st.is_failed(2), st.live(), st.crash_epoch()]
        return out

    assert same(run)[-2:] == [[0, 1, 2, 3], 1]


def test_failure_state_wait_failed():
    def run(P):
        st = P.ulfm.FailureState(2)
        t = threading.Timer(0.05, lambda: st.mark_failed(1))
        t.start()
        try:
            got = st.wait_failed(1, timeout=5.0)
        finally:
            t.join()
        return got, st.wait_failed(0, timeout=0.05)

    assert same(run) == (True, False)


def test_failure_state_revocation_and_causes():
    def run(P):
        st = P.ulfm.FailureState(4)
        st.revoke(7)
        out = [st.is_revoked(7), st.is_revoked(8)]
        try:
            st.check_revoked(7)
        except P.errors.Revoked as e:
            out.append(("revoked", e.cid))
        st.alias_cid(0x7100, 7)
        out.append(sorted(st.revoked_cids()))
        st.mark_failed(1, cause="transport")
        out += [st.refine_cause(1, "device"), st.cause_of(1),
                st.refine_cause(1, "daemon"), st.cause_of(1)]
        st.mark_departed(3)
        out += [st.crash_count(), st.crash_epoch(), sorted(st.acked()),
                st.failed_with_causes()]
        return out

    got = same(run)
    assert got[2] == ("revoked", 7) and got[3] == [7, 0x7100]
    assert got[4:8] == [True, "device", False, "device"]


def test_agree_tags_cids_and_shrink_windows_match():
    """The wire constants are the namesake's, value for value."""
    for name in ("FT_HB_CID", "FT_NOTICE_CID", "FT_REVOKE_CID",
                 "FT_AGREE_CID", "FT_AGREE_PUB_CID", "FT_BYE_CID",
                 "FT_JOIN_CID", "FT_DVM_CID", "_AGREE_TAG",
                 "_SHRINK_CID_BASE", "_SHRINK_CID_STRIDE"):
        assert getattr(tulfm, name) == getattr(julfm, name), name
    for seq in (0, 1, 7, 0xFFFFF, 0x100003):
        assert tulfm._agree_tags(seq) == julfm._agree_tags(seq)
    for gen, cid in ((0, 0), (1, 0x7FFE), (3, 0x12345)):
        assert tulfm._shrink_cid(gen, cid) == julfm._shrink_cid(gen, cid)
    pairs = [[[1, "notice"], [2, "device"]], 1]
    other = [[[1, "daemon"], [3, "goodbye"]], 2]
    assert tulfm._combine_failed_sets(pairs, other) == \
        julfm._combine_failed_sets(pairs, other)


# -- TestUniverseFailureDelivery -----------------------------------------------


def test_named_source_death_is_typed():
    def run(P):
        uni = P.universe(2, ft=True)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            if ctx.rank == 0:
                with pytest.raises(P.errors.ProcFailed) as ei:
                    ctx.recv(source=1, tag=7, timeout=10.0)
                return ("survived", sorted(ei.value.failed_ranks))
            return None

        return uni.run(prog)

    assert same(run)[0] == ("survived", [1])


def test_any_source_death_is_pending():
    def run(P):
        uni = P.universe(3, ft=True)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            if ctx.rank == 0:
                with pytest.raises(P.errors.ProcFailedPending):
                    ctx.recv(source=ANY_SOURCE, tag=7, timeout=10.0)
                return "pending-seen"
            return None

        return uni.run(prog)[0]

    assert same(run) == "pending-seen"


def test_ack_reenables_wildcard_and_message_survives():
    def run(P):
        uni = P.universe(3, ft=True)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            if ctx.rank == 0:
                ctx.universe.ft_state.wait_failed(2, timeout=10.0)
                with pytest.raises(P.errors.ProcFailedPending):
                    ctx.recv(source=ANY_SOURCE, tag=7, timeout=10.0)
                ctx.failure_ack()
                acked = ctx.failure_get_acked().ranks
                ctx.send(b"", 1, tag=8)
                return acked, ctx.recv(source=ANY_SOURCE, tag=7,
                                       timeout=10.0)
            if ctx.rank == 1:
                ctx.recv(source=0, tag=8, timeout=10.0)
                ctx.send("late", 0, tag=7)
            return None

        return uni.run(prog)[0]

    assert same(run) == ((2,), "late")


def test_dead_ranks_delivered_messages_survive():
    def run(P):
        uni = P.universe(2, ft=True)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            if ctx.rank == 1:
                ctx.send("parting-gift", 0, tag=5)
                return None
            ctx.universe.ft_state.wait_failed(1, timeout=10.0)
            return ctx.recv(source=1, tag=5, timeout=10.0)

        return uni.run(prog)[0]

    assert same(run) == "parting-gift"


def test_send_to_dead_rank_is_typed():
    def run(P):
        uni = P.universe(2, ft=True)
        plan = P.FaultPlan(seed=0).kill_rank(1, after_ops=0)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(ctx)
            if ctx.rank == 1:
                inj.send(b"", 0, tag=1)
            ctx.universe.ft_state.wait_failed(1, timeout=10.0)
            with pytest.raises(P.errors.ProcFailed):
                ctx.send(np.zeros(100_000), 1, tag=2)  # rendezvous size
            return "typed"

        return uni.run(prog), uni.ft_state.cause_of(1)

    assert same(run) == (["typed", None], "killed")


def test_plain_timeout_still_a_stall():
    def run(P):
        uni = P.universe(2, ft=True)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            if ctx.rank == 0:
                with pytest.raises(P.errors.InternalError, match="timeout"):
                    ctx.recv(source=1, tag=9, timeout=0.2)
            ctx.barrier()
            return True

        return uni.run(prog)

    assert same(run) == [True, True]


# -- TestUniverseReuse ---------------------------------------------------------


def test_ft_universe_reusable_after_clean_run():
    def run(P):
        uni = P.universe(2, ft=True)

        def prog(ctx):
            ctx.send(ctx.rank, 1 - ctx.rank, tag=1)
            return ctx.recv(source=1 - ctx.rank, tag=1, timeout=10.0)

        first = uni.run(prog)
        failed = sorted(uni.ft_state.failed())
        return first, failed, uni.run(prog)

    assert same(run) == ([1, 0], [], [1, 0])


def test_killed_rank_stays_failed_after_run():
    def run(P):
        uni = P.universe(2, ft=True)
        plan = P.FaultPlan(seed=0).kill_rank(1, after_ops=0)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(ctx)
            if ctx.rank == 1:
                inj.send(b"", 0, tag=1)
            return True

        res = uni.run(prog)
        return res, sorted(uni.ft_state.failed()), uni.ft_state.cause_of(1)

    assert same(run) == ([True, None], [1], "killed")


# -- TestErrhandlerDispositions -------------------------------------------------


def _kill_and_recv(ctx, plan):
    inj = plan.arm(ctx)
    if ctx.rank == 1:
        inj.send(b"x", 0, tag=1)  # op 1; next op dies
        inj.recv(source=0, tag=2, timeout=10.0)


def test_errors_are_fatal_aborts():
    def run(P):
        uni = P.universe(2, ft=True)
        plan = P.FaultPlan(seed=0).kill_rank(1, after_ops=1)

        def prog(ctx):
            _kill_and_recv(ctx, plan)
            if ctx.rank == 0:
                ctx.recv(source=1, tag=3, timeout=10.0)
            return True

        with pytest.raises(P.errh.JobAbort) as ei:
            uni.run(prog)
        return (type(ei.value.cause).__name__, ei.value.failed_ranks)

    assert same(run) == ("ProcFailed", (1,))


def test_errors_return_raises_typed():
    def run(P):
        uni = P.universe(2, ft=True)
        plan = P.FaultPlan(seed=0).kill_rank(1, after_ops=1)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            _kill_and_recv(ctx, plan)
            if ctx.rank == 0:
                with pytest.raises(P.errors.ProcFailed):
                    ctx.recv(source=1, tag=3, timeout=10.0)
                return "typed"
            return None

        return uni.run(prog)

    assert same(run) == ["typed", None]


def test_user_handler_recovers_by_shrinking():
    def run(P):
        n = 3
        uni = P.universe(n, ft=True)
        plan = P.FaultPlan(seed=0).kill_rank(2, after_ops=0)

        def recover(ctx, exc):
            assert isinstance(exc, P.errors.ProcFailed)
            ctx.failure_ack()
            sh = ctx.shrink()
            return ("recovered",
                    float(sh.allreduce(np.float64(ctx.rank), P.ops.SUM)))

        def prog(ctx):
            inj = plan.arm(ctx)
            if ctx.rank == 2:
                inj.send(b"", 0, tag=1)
            ctx.set_errhandler(P.errh.create(recover))
            ctx.universe.ft_state.wait_failed(2, timeout=10.0)
            return ctx.recv(source=2, tag=1, timeout=10.0)

        return uni.run(prog)

    res = same(run)
    assert res[0] == res[1] == ("recovered", 1.0)


# -- TestRingDetector -----------------------------------------------------------


def test_detector_discovers_muted_rank(both_vars):
    set_vars(ft_detector_period=0.02, ft_detector_timeout=0.15)

    def run(P):
        uni = P.universe(N, ft=True)
        plan = P.FaultPlan(seed=5).kill_rank(2, after_ops=1, mode="mute")
        uni.start_failure_detector()
        try:
            def prog(ctx):
                ctx.set_errhandler(P.errh.ERRORS_RETURN)
                inj = plan.arm(ctx)
                if ctx.rank == 2:
                    inj.send(b"", 3, tag=1)
                    inj.recv(source=3, tag=2, timeout=10.0)
                assert ctx.universe.ft_state.wait_failed(2, timeout=10.0)
                return ctx.universe.ft_state.cause_of(2)

            res = uni.run(prog)
        finally:
            uni.stop_failure_detector()
        return res, uni.ft_detectors

    res = same(run)
    assert res == (["detector", "detector", None, "detector"], [])


def test_clean_run_no_suspicions(both_vars):
    set_vars(ft_detector_period=0.02, ft_detector_timeout=0.3)

    def run(P):
        before = P.ulfm.false_positive_count()
        uni = P.universe(N, ft=True)
        uni.start_failure_detector()
        try:
            def prog(ctx):
                for lap in range(3):
                    ctx.send(ctx.rank, (ctx.rank + 1) % N, tag=lap)
                    ctx.recv(source=(ctx.rank - 1) % N, tag=lap,
                             timeout=10.0)
                return True

            res = uni.run(prog)
            sus = [d.suspicions for d in uni.ft_detectors]
        finally:
            uni.stop_failure_detector()
        return res, sus, P.ulfm.false_positive_count() - before

    assert same(run) == ([True] * N, [[]] * N, 0)


def test_detectors_shut_down(both_vars):
    def run(P):
        uni = P.universe(2, ft=True)
        uni.start_failure_detector()
        alive = any(d.is_alive() for d in uni.ft_detectors)
        uni.stop_failure_detector()
        return alive, uni.ft_detectors, [
            t.name for t in threading.enumerate()
            if "hb-uni" in (t.name or "")]

    assert same(run) == (True, [], [])


# -- TestAgree ------------------------------------------------------------------


def test_agree_excludes_dead_participant():
    def run(P):
        uni = P.universe(3, ft=True)
        plan = P.FaultPlan(seed=0).kill_rank(2, after_ops=0)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(ctx)
            if ctx.rank == 2:
                inj.send(b"", 0, tag=1)
            ctx.universe.ft_state.wait_failed(2, timeout=10.0)
            return ctx.agree(True)

        return uni.run(prog)

    assert same(run) == [True, True, None]


def test_agree_ands_flags():
    def run(P):
        uni = P.universe(3, ft=True)
        return uni.run(lambda ctx: ctx.agree(ctx.rank != 1))

    assert same(run) == [False, False, False]


def test_agree_survives_coordinator_death():
    def run(P):
        uni = P.universe(3, ft=True)
        plan = P.FaultPlan(seed=0).kill_rank(0, after_ops=0)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(ctx)
            if ctx.rank == 0:
                inj.send(b"", 1, tag=1)
            ctx.universe.ft_state.wait_failed(0, timeout=10.0)
            return ctx.agree(True)

        return uni.run(prog)

    assert same(run) == [None, True, True]


def test_agree_survives_partial_result_delivery():
    def run(P):
        uni = P.universe(4, ft=True)
        plan = P.FaultPlan(seed=0).kill_rank(0, after_ops=0)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            if ctx.rank == 0:
                gather_tag, result_tag = P.ulfm._agree_tags(0)
                acc = True
                for r in (1, 2, 3):
                    contrib = ctx.recv(source=r, tag=gather_tag,
                                       cid=P.ulfm.FT_AGREE_CID,
                                       timeout=10.0, poll=True)
                    acc = acc and bool(contrib[1])
                ctx.send((0, acc), 3, tag=result_tag,
                         cid=P.ulfm.FT_AGREE_CID, poll=True)
                plan.arm(ctx).die()
            return ctx.agree(ctx.rank != 2)

        return uni.run(prog)

    assert same(run) == [None, False, False, False]


# -- TestShrunkEndpoint ---------------------------------------------------------


def test_shrunk_renumbering_and_collectives():
    def run(P):
        uni = P.universe(4, ft=True)
        uni.ft_state.mark_failed(1, cause="killed")

        def prog(ctx):
            if ctx.rank == 1:
                return None
            sh = ctx.shrink()
            got = sh.allgather(ctx.rank)
            sh.barrier()
            return (sh.rank, sh.size, list(got), sh._gen)

        return uni.run(prog)

    res = same(run)
    assert [r[:3] if r else r for r in res] == [
        (0, 3, [0, 2, 3]), None, (1, 3, [0, 2, 3]), (2, 3, [0, 2, 3])]


def test_shrunk_wildcard_recv_despite_unacked_failure():
    def run(P):
        uni = P.universe(3, ft=True)
        uni.ft_state.mark_failed(2, cause="killed")

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            if ctx.rank == 2:
                return None
            sh = ctx.shrink()
            if sh.rank == 1:
                sh.send(b"hello", 0, tag=4)
                return "sent"
            return sh.recv(source=ANY_SOURCE, tag=4, timeout=10.0)

        return uni.run(prog)

    assert same(run) == [b"hello", "sent", None]


def test_shrunk_sendrecv_partner_death_is_typed():
    def run(P):
        uni = P.universe(3, ft=True)
        uni.ft_state.mark_failed(2, cause="killed")

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            if ctx.rank == 2:
                return None
            sh = ctx.shrink()
            if sh.rank == 1:
                return "left"
            with pytest.raises(P.errors.ProcFailed):
                sh.sendrecv(b"x", dest=1, source=1, sendtag=1, recvtag=1)
            return "typed"

        return uni.run(prog)

    assert same(run) == ["typed", "left", None]


def test_non_survivor_cannot_shrink_and_plain_endpoints_refuse():
    def run(P):
        st = P.ulfm.FailureState(2)
        st.mark_failed(0, cause="killed")

        class FakeEp:
            rank, size, ft_state = 0, 2, st

        out = []
        with pytest.raises(P.errors.ProcFailed):
            P.ulfm.ShrunkEndpoint(FakeEp(), [1], generation=1)
        uni = P.universe(2)
        for call in (uni.contexts[0].shrink, uni.contexts[0].failure_ack):
            with pytest.raises(P.errors.UnsupportedError) as ei:
                call()
            out.append("ft=True" in str(ei.value))
        return out

    assert same(run) == [True, True]


# -- TestFaultPlan ---------------------------------------------------------------


def test_fault_plan_deterministic_from_seed_and_bad_args():
    for seed in (42, 43, 7):
        a = TFaultPlan(seed=seed).random_kill(8, max_ops=16)
        b = JFaultPlan(seed=seed).random_kill(8, max_ops=16)
        assert a._kills == b._kills and a.victims == b.victims
    p = TFaultPlan(seed=5).kill_ranks([1, 2], after_ops=3, respawn=True) \
        .wedge_device(3, after_steps=2)
    assert (p.victims, p.respawn_victims, p.device_victims) == (
        frozenset({1, 2}), frozenset({1, 2}), frozenset({3}))
    for bad in (lambda P: P.FaultPlan().kill_rank(0, after_ops=-1),
                lambda P: P.FaultPlan().kill_rank(0, 1, mode="nuke"),
                lambda P: P.FaultPlan().wedge_device(0, after_steps=-1)):
        for P in (JAX, PORT):
            with pytest.raises(P.errors.ArgError):
                bad(P)


def test_op_counting():
    def run(P):
        uni = P.universe(2, ft=True)
        plan = P.FaultPlan(seed=0).kill_rank(0, after_ops=3)

        def prog(ctx):
            inj = plan.arm(ctx)
            if ctx.rank == 0:
                inj.send(b"a", 1, tag=1)
                inj.send(b"b", 1, tag=2)
                inj.recv(source=1, tag=3, timeout=10.0)
                inj.send(b"c", 1, tag=4)
                return "unreachable"
            ctx.recv(source=0, tag=1, timeout=10.0)
            ctx.recv(source=0, tag=2, timeout=10.0)
            ctx.send(b"z", 0, tag=3)
            return "peer-done"

        return uni.run(prog), uni.ft_state.cause_of(0)

    assert same(run) == ([None, "peer-done"], "killed")


def test_kill_fires_inside_collective():
    def run(P):
        uni = P.universe(2, ft=True)
        plan = P.FaultPlan(seed=0).kill_rank(1, after_ops=0)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(ctx)
            if ctx.rank == 1:
                inj.allgather(ctx.rank)
                return "unreachable"
            try:
                ctx.allgather(ctx.rank)
            except P.errors.MpiError:
                pass
            return "survivor"

        return uni.run(prog), uni.ft_state.cause_of(1)

    assert same(run) == (["survivor", None], "killed")


@pytest.mark.parametrize("after_ops", [0, 1, 2])
def test_kill_inside_a_ring_allreduce(after_ops):
    """The kill lands inside a host allreduce (large enough for the
    ring) at a seeded op count of its reduce-scatter, where no survivor
    can finish (a kill in the allgather lets some finish, by timing);
    every survivor ends typed, acks, shrinks and sums the survivors'
    contributions exactly."""
    n = 4

    def run(P):
        uni = P.universe(n, ft=True)
        plan = P.FaultPlan(seed=3).kill_rank(2, after_ops=after_ops)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(ctx)
            kind = "completed"
            try:
                inj.allreduce(np.full(70_000, float(ctx.rank + 1)),
                              P.ops.SUM)
            except P.errors.ProcFailed:
                kind = "failed"
                ctx.revoke(P.coll_host.COLL_CID)
            except P.errors.Revoked:
                kind = "revoked"
            assert ctx.ft_state.wait_failed(2, timeout=10.0)
            ctx.failure_ack()
            sh = ctx.shrink()
            total = sh.allreduce(np.full(8, float(ctx.rank + 1)), P.ops.SUM)
            return kind != "completed", sh.size, float(np.asarray(total)[0])

        return uni.run(prog, timeout=60.0)

    res = same(run)
    assert res[2] is None
    assert all(res[r] == (True, 3, 7.0) for r in (0, 1, 3))


# -- TestEndToEndRecovery -------------------------------------------------------


def test_recovery_pipeline():
    APP_CID = 5

    def run(P):
        uni = P.universe(N, ft=True)
        plan = P.FaultPlan(seed=7).kill_rank(2, after_ops=2)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(ctx)
            observed = None
            try:
                for lap in range(2):
                    inj.send(ctx.rank, dest=(ctx.rank + 1) % N, tag=lap,
                             cid=APP_CID)
                    inj.recv(source=(ctx.rank - 1) % N, tag=lap,
                             cid=APP_CID, timeout=10.0)
            except P.errors.ProcFailed as e:
                observed = e
            if observed is None:
                try:
                    ctx.recv(source=2, tag=99, cid=APP_CID, timeout=10.0)
                except P.errors.ProcFailed as e:
                    observed = e
            assert observed is not None and 2 in observed.failed_ranks
            ctx.failure_ack()
            agreed = ctx.agree(True)
            if ctx.rank == 0:
                ctx.revoke(APP_CID)
            saw_revoked = False
            for _ in range(2000):
                try:
                    ctx.recv(source=(ctx.rank - 1) % N, tag=77,
                             cid=APP_CID, timeout=0.01)
                except P.errors.Revoked:
                    saw_revoked = True
                    break
                except P.errors.MpiError:
                    continue
            sh = ctx.shrink()
            total = sh.allreduce(np.float64(ctx.rank), P.ops.SUM)
            return (agreed, saw_revoked, sh.rank, sh.size, float(total))

        return uni.run(prog, timeout=60.0)

    res = same(run)
    assert res[2] is None
    for new_rank, old_rank in enumerate([0, 1, 3]):
        assert res[old_rank] == (True, True, new_rank, 3, 4.0)


def test_send_to_revoked_cid_raises():
    def run(P):
        uni = P.universe(2, ft=True)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            ctx.revoke(11)
            with pytest.raises(P.errors.Revoked):
                ctx.send(b"x", 1 - ctx.rank, tag=1, cid=11)
            return True

        return uni.run(prog)

    assert same(run) == [True, True]


def test_user_handler_recovers_revoked_send():
    def run(P):
        uni = P.universe(2, ft=True)
        seen = []

        def handler(obj, exc):
            seen.append(exc.cid)
            return "recovered"

        def prog(ctx):
            ctx.set_errhandler(P.errh.create(handler))
            ctx.revoke(13)
            req = ctx.isend(b"x", 1 - ctx.rank, tag=1, cid=13)
            assert req.wait() == "recovered"
            ctx.send(b"y", 1 - ctx.rank, tag=2, cid=13)
            return True

        return uni.run(prog), seen

    assert same(run) == ([True, True], [13] * 4)


# -- TestRejoin -------------------------------------------------------------------


def test_replay_then_live_continuation():
    def run(P):
        uni = P.universe(2, ft=True)
        logger = P.UniverseLogger(uni)
        plan = P.FaultPlan(seed=3).kill_rank(1, after_ops=2)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            w = plan.arm(logger.wrap(ctx))
            if ctx.rank == 0:
                w.send(7, dest=1, tag=1)
                assert w.recv(source=1, tag=2, timeout=10.0) == 14
                with pytest.raises(P.errors.ProcFailed):
                    ctx.recv(source=1, tag=3, timeout=10.0)
                return "survived"
            got = w.recv(source=0, tag=1, timeout=10.0)
            w.send(got * 2, dest=0, tag=2)
            w.recv(source=0, tag=3, timeout=10.0)
            return "unreachable"

        res = uni.run(prog)
        failed = uni.ft_state.is_failed(1)
        rj = P.replay_rejoin(logger, 1, uni.contexts[1])
        out = [res, failed, uni.ft_state.is_failed(1),
               rj.recv(source=0, tag=1)]
        rj.send(14, dest=0, tag=2)
        out.append(rj.fully_replayed)
        rj.send("back-online", dest=0, tag=9)
        out.append(uni.contexts[0].recv(source=1, tag=9, timeout=10.0))
        return out

    assert same(run) == [["survived", None], True, False, 7, True,
                         "back-online"]


def test_return_status_shape_survives_replay():
    def run(P):
        uni = P.universe(2, ft=True)
        logger = P.UniverseLogger(uni)

        def prog(ctx):
            w = logger.wrap(ctx)
            if ctx.rank == 0:
                w.send(5, dest=1, tag=1)
                return None
            value, status = w.recv(source=ANY_SOURCE, tag=1,
                                   timeout=10.0, return_status=True)
            return (value, status.source, status.tag)

        res = uni.run(prog)
        rj = logger.rejoin_context(1)
        value, status = rj.recv(source=ANY_SOURCE, tag=1,
                                return_status=True)
        return res, (value, status.source, status.tag), rj.fully_replayed

    assert same(run) == ([None, (5, 0, 1)], (5, 0, 1), True)


# -- TestTcpUlfm ------------------------------------------------------------------


def test_tcp_severed_rank_recovery(both_vars):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.8)
    n = 3

    def run(P):
        plan = P.FaultPlan(seed=1).kill_rank(2, after_ops=1)

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(p)
            try:
                inj.send(p.rank, dest=(p.rank + 1) % n, tag=1)
                inj.recv(source=(p.rank - 1) % n, tag=1, timeout=10.0)
            except P.errors.ProcFailed:
                pass
            assert p.ft_state.wait_failed(2, timeout=10.0)
            p.failure_ack()
            agreed = p.agree(True)
            sh = p.shrink()
            total = sh.allreduce(np.float64(p.rank), P.ops.SUM)
            return (agreed, sh.rank, sh.size, float(total))

        return run_tcp_ft(P, n, prog)

    assert same(run) == [(True, 0, 2, 1.0), (True, 1, 2, 1.0), "killed"]


def test_tcp_recovery_with_array_payloads_rides_fast_path(both_vars):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.4)
    n = 3

    def run(P):
        plan = P.FaultPlan(seed=21).kill_rank(2, after_ops=1)
        zc0 = P.spc.read("tcp_zero_copy_sends")

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(p)
            block = np.full(2048, float(p.rank + 1))
            try:
                inj.send((p.rank, block), dest=(p.rank + 1) % n, tag=1)
                inj.recv(source=(p.rank - 1) % n, tag=1, timeout=10.0)
            except P.errors.ProcFailed:
                pass
            assert p.ft_state.wait_failed(2, timeout=10.0)
            p.failure_ack()
            assert p.agree(True) is True
            sh = p.shrink()
            total = sh.allreduce(np.full(2048, float(p.rank + 1)),
                                 P.ops.SUM)
            return (sh.size, float(np.asarray(total)[0]))

        res = run_tcp_ft(P, n, prog, sm=False)
        return res, P.spc.read("tcp_zero_copy_sends") > zc0

    assert same(run) == ([(2, 3.0), (2, 3.0), "killed"], True)


def test_tcp_kill_during_sm_rings_torn_down_and_survivors_ride_sm(
        both_vars):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.4)
    n = 3

    def run(P):
        plan = P.FaultPlan(seed=31).kill_rank(2, after_ops=1)
        fb0 = P.spc.read("sm_fallback_tcp_sends")

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(p)
            try:
                inj.send(np.arange(1024.0) * p.rank,
                         dest=(p.rank + 1) % n, tag=1)
                inj.recv(source=(p.rank - 1) % n, tag=1, timeout=10.0)
            except P.errors.ProcFailed:
                pass
            assert p.ft_state.wait_failed(2, timeout=10.0)
            deadline = time.monotonic() + 5.0
            while p._sm_senders.get(2, "unset") is not None \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            torn = p._sm_senders.get(2, "unset") is None
            p.failure_ack()
            assert p.agree(True) is True
            sh = p.shrink()
            before = P.spc.read("sm_bytes_sent")
            total = sh.allreduce(np.full(2048, float(p.rank + 1)),
                                 P.ops.SUM)
            delta = P.spc.read("sm_bytes_sent") - before
            return (sh.size, float(np.asarray(total)[0]), torn, delta > 0)

        res = run_tcp_ft(P, n, prog, sm=True)
        return res, P.spc.read("sm_fallback_tcp_sends") - fb0

    assert same(run) == ([(2, 3.0, True, True)] * 2 + ["killed"], 0)


def test_tcp_muted_rank_found_by_detector_only(both_vars):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.4)
    n = 3

    def run(P):
        plan = P.FaultPlan(seed=2).kill_rank(1, after_ops=1, mode="mute")

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(p)
            inj.send(p.rank, dest=(p.rank + 1) % n, tag=1)
            inj.recv(source=(p.rank - 1) % n, tag=1, timeout=10.0)
            assert p.ft_state.wait_failed(1, timeout=10.0)
            return p.ft_state.cause_of(1)

        return run_tcp_ft(P, n, prog)

    ref, got = both(run)
    for res in (ref, got):
        assert res[1] == "killed"
        assert set(res[0::2]) <= {"detector", "notice"}


def test_tcp_agree_completes_under_fatal_disposition(both_vars):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.4)
    n = 3

    def run(P):
        plan = P.FaultPlan(seed=3).kill_rank(0, after_ops=0)

        def prog(p):
            inj = plan.arm(p)
            if p.rank == 0:
                inj.send(b"", 1, tag=1)
            if p.rank == 1:
                assert p.ft_state.wait_failed(0, timeout=10.0)
                p.send(b"go", 2, tag=2)
            if p.rank == 2:
                p.recv(source=1, tag=2, timeout=10.0)
            return p.agree(True)

        return run_tcp_ft(P, n, prog)

    assert same(run) == ["killed", True, True]


def test_tcp_agree_survives_partial_result_delivery_wire(both_vars):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.8)
    n = 3

    def run(P):
        plan = P.FaultPlan(seed=4).kill_rank(0, after_ops=0, mode="mute")

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            if p.rank == 0:
                gather_tag, result_tag = P.ulfm._agree_tags(0)
                acc = True
                for r in (1, 2):
                    contrib = p.recv(source=r, tag=gather_tag,
                                     cid=P.ulfm.FT_AGREE_CID,
                                     timeout=10.0, poll=True)
                    acc = acc and bool(contrib[1])
                p.send((0, acc), 2, tag=result_tag,
                       cid=P.ulfm.FT_AGREE_CID, poll=True)
                plan.arm(p).die()
            return p.agree(p.rank != 2)

        return run_tcp_ft(P, n, prog)

    assert same(run) == ["killed", False, False]


def test_tcp_self_send_on_revoked_cid_raises(both_vars):
    def run(P):
        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            p.revoke(21)
            with pytest.raises(P.errors.Revoked):
                p.send(b"x", p.rank, tag=1, cid=21)
            req = p.isend(b"x", p.rank, tag=1, cid=21)
            return req.done and isinstance(req.error, P.errors.Revoked)

        return run_tcp_ft(P, 1, prog)

    assert same(run) == [True]


def test_tcp_clean_staggered_close_no_false_positive(both_vars):
    set_vars(ft_detector_period=0.02, ft_detector_timeout=0.15)

    def run(P):
        before = P.ulfm.false_positive_count()

        def prog(p):
            p.barrier()
            if p.rank == 1:
                time.sleep(0.5)
                return p.ft_state.cause_of(0)
            return True

        res = run_tcp_ft(P, 2, prog)
        return res, P.ulfm.false_positive_count() - before

    assert same(run) == ([True, "goodbye"], 0)


def test_tcp_clean_close_does_not_gate_wildcards(both_vars):
    n = 3

    def run(P):
        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            p.barrier()
            if p.rank == 0:
                return True
            if p.rank == 2:
                p.ft_state.wait_failed(0, timeout=10.0)
                p.send("late", 1, tag=6)
                return "sent"
            p.ft_state.wait_failed(0, timeout=10.0)
            return (p.ft_state.cause_of(0),
                    p.recv(source=ANY_SOURCE, tag=6, timeout=10.0))

        return run_tcp_ft(P, n, prog)

    assert same(run) == [True, ("goodbye", "late"), "sent"]


def test_tcp_revoke_floods_over_wire(both_vars):
    def run(P):
        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            p.barrier()
            if p.rank == 0:
                p.revoke(13)
                p.barrier()
                return True
            for _ in range(200):
                try:
                    p.recv(source=0, tag=1, cid=13, timeout=0.05)
                except P.errors.Revoked:
                    p.barrier()
                    return True
                except P.errors.MpiError:
                    continue
            return False

        return run_tcp_ft(P, 2, prog)

    assert same(run) == [True, True]


# -- TestKillDuringHan / TestKillDuringHanAlltoall / TestKillDuringNumaHan ------

BOOTS = {0: {"sm_boot_id": "hosta"}, 1: {"sm_boot_id": "hosta"},
         2: {"sm_boot_id": "hostb"}, 3: {"sm_boot_id": "hostb"}}


@pytest.mark.parametrize("victim,after_ops,seed", [(3, 0, 41), (2, 1, 42)],
                         ids=["nonleader_intra", "leader_inter"])
def test_kill_during_han(both_vars, victim, after_ops, seed):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.4,
             coll_han_enable="on")
    n = 4

    def run(P):
        plan = P.FaultPlan(seed=seed).kill_rank(victim, after_ops=after_ops)

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(p)
            observed = None
            try:
                inj.allreduce(np.full(64, float(p.rank + 1)), P.ops.SUM)
            except P.errors.ProcFailed as e:
                observed = e
                p.revoke(P.coll_host.COLL_CID)
            except P.errors.Revoked as e:
                observed = e
            assert observed is not None
            assert p.ft_state.wait_failed(victim, timeout=10.0)
            p.failure_ack()
            assert p.agree(True) is True
            sh = p.shrink()
            rebuilt = P.groups.locality_groups(sh)
            total = sh.allreduce(np.full(8, float(p.rank + 1)), P.ops.SUM)
            return (sh.size, rebuilt, float(np.asarray(total)[0]),
                    type(observed).__name__)

        return run_tcp_ft(P, n, prog, kwargs_by_rank=BOOTS)

    ref, got = both(run)
    survivors = [r for r in range(n) if r != victim]
    expect_total = float(sum(r + 1 for r in survivors))
    for res in (ref, got):
        assert res[victim] == "killed"
        for r in survivors:
            assert res[r][:3] == (3, [[0, 1], [2]], expect_total), res[r]
        assert "ProcFailed" in [res[r][3] for r in survivors]


def test_revoke_poisons_parked_han_phases(both_vars):
    set_vars(coll_han_enable="on")

    def run(P):
        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            if p.rank == 0:
                time.sleep(0.6)
                p.revoke(P.coll_host.COLL_CID)
                return "revoked"
            try:
                p.allreduce(np.full(64, 1.0), P.ops.SUM)
            except P.errors.Revoked:
                return "typed"
            return "completed"

        return run_tcp_ft(P, 4, prog, kwargs_by_rank=BOOTS)

    assert same(run) == ["revoked", "typed", "typed", "typed"]


def _survivor_alltoall(P, p, sh):
    out = sh.alltoall([np.full(4, float(p.rank * 10 + d))
                       for d in range(sh.size)])
    return [float(np.asarray(b)[0]) for b in out]


def _alltoall_prog(P, plan, victim, n, threads):
    def prog(p):
        p.set_errhandler(P.errh.ERRORS_RETURN)
        inj = plan.arm(p)
        observed = None
        blocks = [np.full(16, float(p.rank * 10 + d)) for d in range(n)]
        try:
            if threads:
                P.han.alltoall(inj, blocks, groups=[[0, 1], [2, 3]])
            else:
                inj.alltoall(blocks)
        except P.errors.ProcFailed as e:
            observed = e
            p.revoke(P.coll_host.COLL_CID)
        except P.errors.Revoked as e:
            observed = e
        assert observed is not None
        assert p.ft_state.wait_failed(victim, timeout=10.0)
        p.failure_ack()
        assert p.agree(True) is True
        sh = p.shrink()
        return (sh.size, _survivor_alltoall(P, p, sh),
                type(observed).__name__)

    return prog


def _check_alltoall_survivors(res, victim, n=4):
    survivors = [r for r in range(n) if r != victim]
    for j, r in enumerate(survivors):
        size, got, _kind = res[r]
        assert size == n - 1
        assert got == [float(survivors[s] * 10 + j) for s in range(n - 1)]
    assert "ProcFailed" in [res[r][2] for r in survivors]


@pytest.mark.parametrize("victim,after_ops,seed", [(3, 0, 61), (2, 1, 62)],
                         ids=["nonleader_intra", "leader_inter"])
def test_wire_kill_during_han_alltoall(both_vars, victim, after_ops, seed):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.4,
             coll_han_enable="on")

    def run(P):
        plan = P.FaultPlan(seed=seed).kill_rank(victim, after_ops=after_ops)
        return run_tcp_ft(P, 4, _alltoall_prog(P, plan, victim, 4, False),
                          kwargs_by_rank=BOOTS)

    ref, got = both(run)
    for res in (ref, got):
        assert res[victim] == "killed"
        _check_alltoall_survivors(res, victim)


@pytest.mark.parametrize("victim,after_ops,seed", [(3, 0, 63), (2, 1, 64)],
                         ids=["nonleader_intra", "leader_inter"])
def test_thread_kill_during_han_alltoall(victim, after_ops, seed):
    def run(P):
        plan = P.FaultPlan(seed=seed).kill_rank(victim, after_ops=after_ops)
        uni = P.universe(4, ft=True)
        return uni.run(_alltoall_prog(P, plan, victim, 4, True),
                       timeout=60.0)

    ref, got = both(run)
    for res in (ref, got):
        assert res[victim] is None
        _check_alltoall_survivors(res, victim)
    assert [r[:2] if r else r for r in got] == \
        [r[:2] if r else r for r in ref]


def test_kill_in_intra_domain_phase_then_shrink_rebuilds_nested(both_vars):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.4,
             coll_han_enable="on", coll_han_numa_level="on")
    kw = {r: {"sm_boot_id": "numahost", "sm_numa_id": f"d{r // 2}"}
          for r in range(4)}
    victim = 3

    def run(P):
        plan = P.FaultPlan(seed=77).kill_rank(victim, after_ops=0)

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(p)
            observed = None
            try:
                inj.allreduce(np.full(64, float(p.rank + 1)), P.ops.SUM)
            except P.errors.ProcFailed as e:
                observed = e
                p.revoke(P.coll_host.COLL_CID)
            except P.errors.Revoked as e:
                observed = e
            assert observed is not None
            assert p.ft_state.wait_failed(victim, timeout=10.0)
            p.failure_ack()
            assert p.agree(True) is True
            sh = p.shrink()
            nested = P.groups.locality_groups(sh, nested=True)
            total = sh.allreduce(np.full(8, float(p.rank + 1)), P.ops.SUM)
            return (sh.size, nested, float(np.asarray(total)[0]),
                    type(observed).__name__)

        return run_tcp_ft(P, 4, prog, kwargs_by_rank=kw)

    ref, got = both(run)
    for res in (ref, got):
        assert res[victim] == "killed"
        for r in (0, 1, 2):
            assert res[r][:3] == (3, [[[0, 1], [2]]], 6.0), res[r]
        assert "ProcFailed" in [res[r][3] for r in (0, 1, 2)]


# -- TestAgreeFailedSet / TestRevokeAwareSchedules ---------------------------------


def test_agree_failed_set_union_of_divergent_knowledge():
    def run(P):
        uni = P.universe(3, ft=True)
        uni.ft_state.mark_failed(2, cause="killed")

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            if ctx.rank == 2:
                return None
            failed, gen = P.recovery.agree_failed_set(ctx)
            return (sorted(failed), failed.get(2), gen)

        return uni.run(prog)

    assert same(run) == [([2], "killed", 1)] * 2 + [None]


def test_generation_monotonic_across_rejoin():
    def run(P):
        st = P.ulfm.FailureState(4)
        out = [st.mark_failed(2, cause="killed"), st.crash_epoch()]
        st.restore(2)
        out.append(st.crash_epoch())
        st.mark_failed(3, cause="killed")
        out.append(st.crash_epoch())
        st.raise_epoch(1)
        out.append(st.crash_epoch())
        return out

    assert same(run) == [True, 1, 1, 2, 2]


def test_parked_schedule_aborts_on_revoke():
    def run(P):
        uni = P.universe(2, ft=True)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            if ctx.rank == 0:
                req = ctx.iallreduce(np.float64(1.0), P.ops.SUM)
                with pytest.raises(P.errors.Revoked) as ei:
                    req.wait(timeout=10.0)
                return ("aborted", ei.value.cid == P.coll_host.COLL_CID)
            time.sleep(0.05)
            ctx.revoke(P.coll_host.COLL_CID)
            return "revoked"

        res = uni.run(prog)
        revoked = uni.ft_state.revoked_cids()
        raw = sum(c.engine.stats()["posted"] for c in uni.contexts)
        exempt = sum(c.engine.stats_excluding((), revoked)["posted"]
                     for c in uni.contexts)
        saved = set(P.uni_mod._live_universes)
        P.uni_mod._live_universes.clear()
        P.uni_mod._live_universes.add(uni)
        try:
            P.checkpoint.quiesce_check()  # the revoked rows are exempt
        finally:
            P.uni_mod._live_universes.clear()
            for u in saved:
                P.uni_mod._live_universes.add(u)
        return res, P.coll_host.COLL_CID in revoked, raw >= 1, exempt

    assert same(run) == ([("aborted", True), "revoked"], True, True, 0)


# -- TestCheckpointRestartRecovery --------------------------------------------------


def test_thread_recovery_pipeline(tmp_path):
    def run(P):
        n = N
        uni = P.universe(n, ft=True)
        ck = P.Checkpointer(str(tmp_path / P.name), check_quiescent=False)
        plan = P.FaultPlan(seed=11).kill_then_respawn(2, after_ops=2)
        victim = next(iter(plan.respawn_victims))
        handles = []

        def replacement(new_ctx):
            state_, step = P.recovery.rollback(ck)
            vec = np.asarray(state_["vec"])
            total = new_ctx.allreduce(np.float64(vec[victim]), P.ops.SUM)
            return step, float(total)

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(ctx)
            contrib = np.float64(ctx.rank + 1)
            total0 = float(ctx.allreduce(contrib, P.ops.SUM))
            vec = ctx.allgather(float(contrib))
            if ctx.rank == 0:
                ck.save(1, {"vec": np.asarray(vec)}, blocking=True)
            ctx.barrier()
            observed = None
            try:
                for lap in range(2):
                    inj.send(ctx.rank, dest=(ctx.rank + 1) % n,
                             tag=30 + lap)
                    inj.recv(source=(ctx.rank - 1) % n, tag=30 + lap,
                             timeout=10.0)
            except P.errors.ProcFailed as e:
                observed = e
            if observed is None:
                try:
                    ctx.recv(source=victim, tag=99, timeout=10.0)
                except P.errors.ProcFailed as e:
                    observed = e
            assert observed is not None and victim in observed.failed_ranks
            ctx.failure_ack()
            failed, gen = P.recovery.agree_failed_set(ctx)
            sh = ctx.shrink()
            state_, step = P.recovery.rollback(ck)
            vec2 = np.asarray(state_["vec"])
            sh.barrier()
            if sh.rank == 0:
                handles.append(
                    P.recovery.respawn_rank(uni, victim, replacement))
            assert P.recovery.await_rejoin(ctx, victim, timeout=15.0)
            total = ctx.allreduce(np.float64(vec2[ctx.rank]), P.ops.SUM)
            return (total0, float(total), sorted(failed), gen, sh.size,
                    step)

        res = uni.run(prog, timeout=60.0)
        second = handles[0].result(timeout=30.0)
        return (res, len(handles), second, sorted(uni.ft_state.failed()),
                P.recovery.live_respawn_threads(),
                P.recovery.orphaned_checkpoint_partials())

    res, nh, second, failed, threads, partials = same(run)
    assert res[2] is None and nh == 1 and second == (1, 10.0)
    assert all(res[r] == (10.0, 10.0, [2], 1, 3, 1) for r in (0, 1, 3))
    assert failed == [] and threads == [] and partials == []


def test_tcp_recovery_pipeline(both_vars, tmp_path):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=1.0)
    n = N

    def run(P):
        ck = P.Checkpointer(str(tmp_path / P.name), check_quiescent=False)
        plan = P.FaultPlan(seed=13).kill_then_respawn(2, after_ops=2)
        victim = next(iter(plan.respawn_victims))
        book_box: dict = {}
        rolled_back = [threading.Event() for _ in range(n)]
        handle_box: list = []

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            if p.rank == 0:
                book_box["book"] = list(p.address_book)
            inj = plan.arm(p)
            contrib = np.float64(p.rank + 1)
            total0 = float(p.allreduce(contrib, P.ops.SUM))
            vec = p.allgather(float(contrib))
            if p.rank == 0:
                ck.save(1, {"vec": np.asarray(vec)}, blocking=True)
            p.barrier()
            observed = None
            try:
                for lap in range(2):
                    inj.send(p.rank, dest=(p.rank + 1) % n, tag=30 + lap)
                    inj.recv(source=(p.rank - 1) % n, tag=30 + lap,
                             timeout=10.0)
            except P.errors.ProcFailed as e:
                observed = e
            if observed is None:
                try:
                    p.recv(source=victim, tag=99, timeout=10.0)
                except P.errors.ProcFailed as e:
                    observed = e
            assert observed is not None
            p.failure_ack()
            failed, _gen = P.recovery.agree_failed_set(p)
            sh = p.shrink()
            state_, step = P.recovery.rollback(ck)
            vec2 = np.asarray(state_["vec"])
            sh.barrier()
            rolled_back[p.rank].set()
            assert P.recovery.await_rejoin(p, victim, timeout=20.0)
            total = float(p.allreduce(np.float64(vec2[p.rank]), P.ops.SUM))
            return (total0, total, sorted(failed), sh.size, step)

        def spawn_when_survivors_ready():
            for r in range(n):
                if r != victim:
                    assert rolled_back[r].wait(30.0)

            def second_life():
                p2 = P.TcpProc(victim, n, rejoin_book=book_box["book"],
                               timeout=15.0, ft=True)
                try:
                    state_, step = P.recovery.rollback(ck)
                    vec = np.asarray(state_["vec"])
                    return step, float(
                        p2.allreduce(np.float64(vec[victim]), P.ops.SUM))
                finally:
                    p2.close()

            handle_box.append(P.recovery.spawn_replacement(
                second_life, rank=victim, name=f"tcp-respawn-{victim}"))

        watcher = threading.Thread(target=spawn_when_survivors_ready,
                                   daemon=True)
        watcher.start()
        res = run_tcp_ft(P, n, prog, timeout=90.0)
        watcher.join(5.0)
        second = handle_box[0].result(timeout=30.0)
        return (res, second, P.recovery.live_respawn_threads(),
                P.recovery.orphaned_checkpoint_partials())

    res, second, threads, partials = same(run)
    assert res[2] == "killed" and second == (1, 10.0)
    assert all(res[r] == (10.0, 10.0, [2], 3, 1) for r in (0, 1, 3))
    assert threads == [] and partials == []


def test_divergent_knowledge_unified_over_wire(both_vars):
    n = 3

    def run(P):
        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            p.barrier()
            if p.rank == 2:
                P.ulfm.expect_failure(p.ft_state, 2)
                p.mute()
                return "gone"
            if p.rank == 0:
                P.ulfm.expect_failure(p.ft_state, 2)
                p.ft_state.mark_failed(2, cause="transport")
                p.failure_ack()
            sh = p.shrink()
            total = sh.allreduce(np.float64(p.rank), P.ops.SUM)
            return (sh.rank, sh.size, tuple(sh.group.ranks), float(total))

        return run_tcp_ft(P, n, prog)

    assert same(run) == [(0, 2, (0, 1), 1.0), (1, 2, (0, 1), 1.0), "gone"]


# -- TestKillWithInflightIsend ---------------------------------------------------


def test_kill_with_inflight_isend_typed_completion_no_wedge(both_vars):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.8)

    def run(P):
        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            if p.rank == 1:
                p.recv(source=0, tag=1, timeout=10.0)
                P.ulfm.expect_failure(p.ft_state, 1)
                p.sever()
                return "severed"
            p.send(0, dest=1, tag=1)
            big = np.zeros((1 << 17) + 16, np.float64)
            reqs = [p.isend(big, dest=1, tag=2)]
            reqs += [p.isend(b"x" * 2048, dest=1, tag=3) for _ in range(4)]
            outcomes = []
            for r in reqs:
                try:
                    r.wait(20.0)
                    outcomes.append("ok")
                except P.errors.ProcFailed:
                    outcomes.append("failed")
            deadline = time.monotonic() + 10.0
            while p._pending_rndv and time.monotonic() < deadline:
                time.sleep(0.01)
            return (outcomes, len(p._pending_rndv),
                    P.tcp.orphaned_rndv_descriptors())

        return run_tcp_ft(P, 2, prog, sm=False)

    ref, got = both(run)
    for res in (ref, got):
        outcomes, parked_after, orphans = res[0]
        assert outcomes[0] == "failed"
        assert all(o in ("ok", "failed") for o in outcomes)
        assert parked_after == 0 and orphans == [] and res[1] == "severed"


def test_isend_to_known_failed_rank_errored_request(both_vars):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=0.8)

    def run(P):
        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            if p.rank == 1:
                p.recv(source=0, tag=1, timeout=10.0)
                P.ulfm.expect_failure(p.ft_state, 1)
                p.sever()
                return "severed"
            p.send(0, dest=1, tag=1)
            deadline = time.monotonic() + 10.0
            while not p.ft_state.is_failed(1) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            req = p.isend(b"late", dest=1, tag=4)
            out = (p.ft_state.is_failed(1), req.done,
                   type(req.error).__name__)
            with pytest.raises(P.errors.ProcFailed):
                P.requests.wait_all([req])
            return out

        return run_tcp_ft(P, 2, prog, sm=False)

    assert same(run) == [(True, True, "ProcFailed"), "severed"]


# -- TestBatchedRespawn -------------------------------------------------------------


def test_two_victims_one_pass():
    n = 5

    def run(P):
        uni = P.universe(n, ft=True)
        plan = P.FaultPlan(seed=17).kill_ranks([1, 3], after_ops=1,
                                               respawn=True)
        handles: dict = {}

        def second_life(new_ctx):
            for v in (1, 3):
                assert new_ctx.ft_state.wait_restored(v, timeout=20.0)
            return float(new_ctx.allreduce(np.float64(new_ctx.rank),
                                           P.ops.SUM))

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(ctx)
            try:
                inj.send(ctx.rank, dest=(ctx.rank + 1) % n, tag=1)
                inj.recv(source=(ctx.rank - 1) % n, tag=1, timeout=10.0)
            except P.errors.ProcFailed:
                pass
            for v in (1, 3):
                assert ctx.ft_state.wait_failed(v, timeout=10.0)

            def respawner(victims):
                assert victims == [1, 3]
                handles.update(
                    P.recovery.respawn_ranks(uni, victims, second_life))

            shrunk, victims = P.recovery.respawn_victims(ctx, respawner)
            for v in victims:
                assert P.recovery.await_rejoin(ctx, v, timeout=20.0)
            total = ctx.allreduce(np.float64(ctx.rank), P.ops.SUM)
            return (victims, shrunk.size, float(total))

        res = uni.run(prog, timeout=60.0)
        return (res, sorted(handles),
                [handles[v].result(timeout=30.0) for v in sorted(handles)],
                sorted(uni.ft_state.failed()))

    res, hs, seconds, failed = same(run)
    assert res[1] is None and res[3] is None
    assert all(res[r] == ([1, 3], 3, 10.0) for r in (0, 2, 4))
    assert hs == [1, 3] and seconds == [10.0, 10.0] and failed == []


def test_failure_during_recovery_reenters_at_agree():
    n = 4

    def run(P):
        uni = P.universe(n, ft=True)
        plan = P.FaultPlan(seed=19).kill_then_respawn(2, after_ops=1)
        handles: dict = {}
        late_killed = threading.Event()

        def second_life(new_ctx):
            for v in (2, 3):
                assert new_ctx.ft_state.wait_restored(v, timeout=20.0)
            return float(new_ctx.allreduce(np.float64(new_ctx.rank),
                                           P.ops.SUM))

        def prog(ctx):
            ctx.set_errhandler(P.errh.ERRORS_RETURN)
            inj = plan.arm(ctx)
            try:
                inj.send(ctx.rank, dest=(ctx.rank + 1) % n, tag=1)
                inj.recv(source=(ctx.rank - 1) % n, tag=1, timeout=10.0)
            except P.errors.ProcFailed:
                pass
            assert ctx.ft_state.wait_failed(2, timeout=10.0)
            passes = [0]

            def rollback_fn(shrunk):
                passes[0] += 1
                if ctx.rank == 3 and passes[0] == 1:
                    P.ulfm.expect_failure(ctx.ft_state, 3)
                    late_killed.set()
                    raise P.ulfm.RankKilled(3)
                shrunk.barrier()

            def respawner(victims):
                handles.update(
                    P.recovery.respawn_ranks(uni, victims, second_life))

            shrunk, victims = P.recovery.respawn_victims(
                ctx, respawner, rollback_fn=rollback_fn)
            for v in victims:
                assert P.recovery.await_rejoin(ctx, v, timeout=20.0)
            total = ctx.allreduce(np.float64(ctx.rank), P.ops.SUM)
            return (victims, shrunk.size, passes[0] >= 2, float(total))

        res = uni.run(prog, timeout=60.0)
        return (res, late_killed.is_set(), sorted(handles),
                [handles[v].result(timeout=30.0) for v in sorted(handles)],
                sorted(uni.ft_state.failed()))

    res, late, hs, seconds, failed = same(run)
    assert res[2] is None and res[3] is None
    assert res[0] == res[1] == ([2, 3], 2, True, 6.0)
    assert late and hs == [2, 3] and seconds == [6.0, 6.0] and failed == []


# -- the port's own difference: failure-aware rendezvous sends on threads -----


def test_rendezvous_send_to_a_rank_that_dies_completes_typed():
    """A thread-plane rendezvous send parked toward a rank that dies
    before its CTS completes typed ``ProcFailed`` and releases the parked
    payload (the wire plane's isend contract).  The namesake's request
    has no failure classification and its ``wait()`` never returns
    (ROADMAP queue C), so this runs on the port alone."""
    uni = _port_universe(2, ft=True)
    big = np.zeros(100_000)  # above pt2pt_eager_limit: rendezvous

    def prog(ctx):
        ctx.set_errhandler(terrh.ERRORS_RETURN)
        if ctx.rank == 1:
            ctx.recv(source=0, tag=1, timeout=10.0)
            return None  # exits without matching tag 2
        req = ctx.isend(big, 1, tag=2)
        ctx.send(b"go", 1, tag=1)
        with pytest.raises(terrors.ProcFailed):
            req.wait(timeout=10.0)
        with pytest.raises(terrors.ProcFailed):
            ctx.send(big, 1, tag=3)
        return len(ctx._pending_rndv)

    assert uni.run(prog) == [0, None]


# -- mixed universes (used by tests/test_torch_tcp.py and test_torch_sm.py) --


def run_mixed_ft(kinds, fn, sm=False, timeout=60.0, proc_timeout=15.0,
                 kwargs_by_rank=None, **kw):
    """One ft universe of ``len(kinds)`` ranks in threads, ``kinds[r]``
    the TcpProc class of rank r (the port's or the JAX package's);
    ``fn(p, P)`` gets the rank's proc and its package namespace; ``kw``
    and ``kwargs_by_rank[r]`` go to the constructors.  A rank a fault
    plan kills returns "killed"; "dead" procs (severed, or muted with
    their sockets up) are closed at the end."""
    n = len(kinds)
    ready = threading.Event()
    addr = [None]
    results, excs, procs = [None] * n, [None] * n, [None] * n

    def publish(a):
        addr[0] = a
        ready.set()

    def main(r):
        P = PORT if kinds[r] is ttcp.TcpProc else JAX
        proc = None
        rkw = dict(kw, **(kwargs_by_rank or {}).get(r, {}))
        try:
            if r == 0:
                proc = kinds[0](0, n, coordinator=("127.0.0.1", 0),
                                on_coordinator_bound=publish, sm=sm,
                                ft=True, timeout=proc_timeout, **rkw)
            else:
                assert ready.wait(proc_timeout)
                proc = kinds[r](r, n, coordinator=addr[0], sm=sm, ft=True,
                                timeout=proc_timeout, **rkw)
            procs[r] = proc
            try:
                results[r] = fn(proc, P)
            except P.ulfm.RankKilled:
                results[r] = "killed"
        except BaseException as e:  # noqa: BLE001 - re-raised below
            excs[r] = e
            ready.set()
        finally:
            if proc is not None and not proc._ft_dead:
                proc.close()
            elif proc is not None and proc._detector is not None:
                proc._detector.stop()

    threads = [threading.Thread(target=main, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "tcp rank hung"
    for p in procs:
        if p is not None and p._ft_dead:
            p.close()
    for e in excs:
        if e is not None:
            raise e
    return results


MIXED_N = 70_000  # f32 280 KB > host_coll_large_msg: the ring allreduce


def mixed_ft_program(victim, how):
    """The cross-package ft program: a revoke flood each way, one death
    (``how`` = "kill": a FaultPlan kill mid-ring; "device": the victim
    floods its own device fault, then is severed), failure ack, agree,
    agree_failed_set, shrink and a ring allreduce on the survivors."""

    def prog(p, P):
        import torch

        port = P is PORT
        r = p.rank
        p.set_errhandler(P.errh.ERRORS_RETURN)
        p.barrier()
        # a revoke floods across the packages: port rank 0 revokes 13,
        # JAX-package rank 1 revokes 14; every rank sees both typed
        if r == 0:
            p.revoke(13)
        if r == 1:
            p.revoke(14)
        seen = set()
        deadline = time.monotonic() + 10.0
        while len(seen) < 2 and time.monotonic() < deadline:
            for cid in (13, 14):
                if cid in seen:
                    continue
                try:
                    p.recv(source=(r + 1) % 4, tag=1, cid=cid, timeout=0.02)
                except P.errors.Revoked:
                    seen.add(cid)
                except P.errors.MpiError:
                    pass
        p.barrier()
        # every survivor is past the barrier before the victim can die: a
        # victim severed while a peer has not yet read its last barrier
        # message is classified inside that peer's barrier
        if r == victim:
            for peer in range(4):
                if peer != victim:
                    p.recv(source=peer, tag=3, timeout=10.0)
        else:
            p.send(r, dest=victim, tag=3)
        plan = P.FaultPlan(seed=5)
        if how == "kill":
            plan.kill_rank(victim, after_ops=1)
        inj = plan.arm(p)
        if how == "device" and r == victim:
            P.ulfm.expect_failure(p.ft_state, victim)
            p.flood_device_fault(P.errors.DeviceFault(
                "wedged", failed_ranks=[victim]))
            time.sleep(0.5)
            p.sever()
            return "killed"
        try:
            inj.send(r, dest=(r + 1) % 4, tag=2)
            inj.recv(source=(r - 1) % 4, tag=2, timeout=10.0)
        except P.errors.ProcFailed:
            pass
        assert p.ft_state.wait_failed(victim, timeout=10.0)
        if how == "device":
            deadline = time.monotonic() + 10.0
            while p.ft_state.cause_of(victim) != "device" \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
        cause = p.ft_state.cause_of(victim)
        p.failure_ack()
        agreed = p.agree(r != 3)
        failed, gen = P.recovery.agree_failed_set(p)
        sh = p.shrink()
        x = (np.arange(MIXED_N, dtype=np.float32) * 0.001 * (r + 1)
             - 0.37 * r)
        total = sh.allreduce(torch.from_numpy(x) if port else x, P.ops.SUM)
        return (sorted(seen), cause, agreed, sorted(failed.items()), gen,
                sh.rank, sh.size, tuple(sh.group.ranks),
                np.asarray(total).tobytes())

    return prog


def check_mixed_ft(res, victim, how):
    survivors = [r for r in range(4) if r != victim]
    assert res[victim] == "killed"
    rows = [res[r] for r in survivors]
    for k, row in enumerate(rows):
        seen, cause, agreed, failed, gen, srank, ssize, group, _ = row
        assert seen == [13, 14]
        if how == "device":
            assert cause == "device"
        else:
            assert cause in ("transport", "notice", "detector"), cause
        assert agreed is (3 not in survivors)
        assert [f[0] for f in failed] == [victim]
        assert (srank, ssize, group) == (k, 3, tuple(survivors))
    # agree, agree_failed_set, shrink and the ring allreduce agree to the
    # bit on every survivor, whichever package it runs
    assert len({(row[2], tuple(row[3]), row[4], row[8]) for row in rows}) == 1
    want = sum(np.arange(MIXED_N, dtype=np.float32) * 0.001 * (r + 1)
               - 0.37 * r for r in survivors)
    np.testing.assert_allclose(np.frombuffer(rows[0][8], np.float32), want,
                               rtol=1e-5, atol=1e-3)


# ------------------------------------ the real-process DVM drills (port)


_DVM_RECOVERY_PROG = '''
import os, signal, sys, time
sys.path.insert(0, {repo!r})
import torch
import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch.core import errhandler as errh
from zhpe_ompi_tpu_torch.ft import recovery
from zhpe_ompi_tpu_torch.runtime import spc
from zhpe_ompi_tpu_torch.runtime.checkpoint import Checkpointer

VICTIM = int(os.environ["TEST_VICTIM"])
CKPT = os.environ["TEST_CKPT"]

proc = zmpi.host_init()
proc.set_errhandler(errh.ERRORS_RETURN)
ck = Checkpointer(os.path.join(CKPT, f"r{{proc.rank}}"),
                  check_quiescent=False)


def total_of(x):
    return float(proc.allreduce(torch.tensor(x, dtype=torch.float64),
                                zmpi.SUM))


if os.environ.get("ZMPI_REJOIN") == "1":
    # second life: restore from the snapshot, join the full-size op
    state, step = recovery.rollback(ck)
    assert step == 1 and state["x"] == float(proc.rank)
    print(f"REJOIN-OK rank={{proc.rank}} total={{total_of(state['x'])}}",
          flush=True)
    zmpi.host_finalize()
    sys.exit(0)

ck.save(1, {{"x": float(proc.rank)}}, blocking=True)
proc.barrier()  # checkpoint published before anyone dies
t0 = time.monotonic()
if proc.rank == VICTIM:
    os.kill(os.getpid(), signal.SIGKILL)  # kill -9: no cleanup, no goodbye
# the daemon's waitpid event classifies the corpse long before the
# (deliberately huge) heartbeat window could
assert proc.ft_state.wait_failed(VICTIM, timeout=10.0), "never classified"
latency = time.monotonic() - t0
cause = proc.ft_state.cause_of(VICTIM)


def rollback_fn(shrunk):
    state, step = recovery.rollback(ck)
    assert step == 1 and state["x"] == float(proc.rank)


shrunk, victims = recovery.respawn_victims(
    proc, recovery.daemon_respawn, rollback_fn=rollback_fn)
assert victims == [VICTIM], victims
assert recovery.await_rejoin(proc, VICTIM, timeout=30.0), "no rejoin"
total = total_of(float(proc.rank))
events = spc.read("dvm_fault_events")
print(f"SURVIVOR-OK rank={{proc.rank}} cause={{cause}} "
      f"latency={{latency:.3f}} events={{events}} total={{total}}",
      flush=True)
zmpi.host_finalize()
'''

_DVM_MULTI_VICTIM_PROG = '''
import os, signal, sys
sys.path.insert(0, {repo!r})
import torch
import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch.core import errhandler as errh
from zhpe_ompi_tpu_torch.ft import recovery

VICTIMS = sorted(int(x) for x in os.environ["TEST_VICTIMS"].split(","))
proc = zmpi.host_init()
proc.set_errhandler(errh.ERRORS_RETURN)


def total_of(x):
    return float(proc.allreduce(torch.tensor(x, dtype=torch.float64),
                                zmpi.SUM))


if os.environ.get("ZMPI_REJOIN") == "1":
    # fellow replacements of ONE recovery window: each read the other's
    # card at the window's bumped generation
    print(f"REJOIN-OK rank={{proc.rank}} total={{total_of(float(proc.rank))}}",
          flush=True)
    zmpi.host_finalize()
    sys.exit(0)
proc.barrier()
if proc.rank in VICTIMS:
    os.kill(os.getpid(), signal.SIGKILL)
for v in VICTIMS:
    assert proc.ft_state.wait_failed(v, timeout=10.0), f"victim {{v}}?"
shrunk, victims = recovery.respawn_victims(proc, recovery.daemon_respawn)
assert victims == VICTIMS, (victims, VICTIMS)
for v in VICTIMS:
    assert recovery.await_rejoin(proc, v, timeout=30.0), f"no rejoin {{v}}"
print(f"SURVIVOR-OK rank={{proc.rank}} total={{total_of(float(proc.rank))}}",
      flush=True)
zmpi.host_finalize()
'''

DVM_FT_MCA = [("ft_detector_period", "2.0"), ("ft_detector_timeout", "60.0")]


def _dvm_launch(prog_text, tmp_path, name):
    """Launch the port program on 4 ft ranks of an in-process port
    daemon; returns (rc, stdout, stderr, the daemon's counter deltas and
    its store's namespaces after the job)."""
    import io
    import os

    from zhpe_ompi_tpu_torch.runtime import dvm as tdvm

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = tmp_path / name
    prog.write_text(prog_text.format(repo=repo))
    before = tspc.snapshot()
    d = tdvm.Dvm()
    try:
        cli = tdvm.DvmClient(d.address)
        out, err = io.StringIO(), io.StringIO()
        rc = cli.launch(4, [str(prog)], ft=True, timeout=120.0,
                        mca=DVM_FT_MCA, stdout=out, stderr=err)
        stat = cli.stat()
        cli.stop()
        cli.close()
    finally:
        d.stop()
    assert tdvm.live_dvms() == []
    deltas = {k: stat[k] - before.get(k, 0)
              for k in ("dvm_fault_events", "dvm_respawns")}
    return rc, out.getvalue(), err.getvalue(), deltas, stat["pmix"]


def test_dvm_kill9_daemon_event_shrink_rollback_respawn(tmp_path, monkeypatch):
    """TestDvmRealProcessRecovery's counterpart: a daemon-hosted 4-rank
    port job survives kill -9 through the daemon's authoritative fault
    event (cause "daemon", well inside the heartbeat window), shrink,
    checkpoint rollback, the daemon's relaunch, the replacement's rejoin
    through the store, and a full-size allreduce."""
    import re

    victim = 2
    monkeypatch.setenv("TEST_VICTIM", str(victim))
    monkeypatch.setenv("TEST_CKPT", str(tmp_path / "ckpt"))
    rc, text, err, deltas, namespaces = _dvm_launch(
        _DVM_RECOVERY_PROG, tmp_path, "recover.py")
    assert rc == 0, (text, err)
    survivors = re.findall(
        r"SURVIVOR-OK rank=(\d+) cause=(\w+) latency=([\d.]+) "
        r"events=(\d+) total=([\d.]+)", text)
    assert len(survivors) == 3, text
    for rank, cause, latency, events, total in survivors:
        assert int(rank) != victim and cause == "daemon"
        assert float(latency) < 1.5 and int(events) >= 1
        assert float(total) == 6.0
    assert re.findall(r"REJOIN-OK rank=(\d+) total=([\d.]+)", text) == [
        (str(victim), "6.0")], text
    assert deltas == {"dvm_fault_events": 1, "dvm_respawns": 1}
    assert namespaces == {}  # the job's namespace went with it


def test_dvm_two_victims_one_daemon_window(tmp_path, monkeypatch):
    """TestDvmMultiVictimRecovery's counterpart: two ranks die, one
    agree/shrink/daemon-respawn pass recovers both, and the two
    replacements resolve each other through the window's bumped
    generation."""
    import re

    monkeypatch.setenv("TEST_VICTIMS", "1,2")
    rc, text, err, deltas, namespaces = _dvm_launch(
        _DVM_MULTI_VICTIM_PROG, tmp_path, "recover2.py")
    assert rc == 0, (text, err)
    totals = re.findall(r"(SURVIVOR|REJOIN)-OK rank=(\d+) total=([\d.]+)",
                        text)
    assert len(totals) == 4, text
    assert sorted(r for k, r, _ in totals if k == "REJOIN") == ["1", "2"]
    assert all(t == "6.0" for _, _, t in totals), text
    assert deltas == {"dvm_fault_events": 2, "dvm_respawns": 2}
    assert namespaces == {}
