"""The port's device-plane fault tolerance held against the JAX package's:
the liveness probe (``parallel/mesh.DeviceLivenessProbe``, its killable
CPU child), the background ``DeviceProber``, the wedge plan
(``ft/inject.WedgedDevice``), the wedge and mixed-storm drills over ft
``TcpProc`` universes, and ``models/ftloop.FtTrainLoop`` — the counterparts
of ``tests/test_ft_device.py`` (and of ``tests/test_tenancy.py``'s
``TestDeviceProber``), each program run on both packages where both can
run it.

The wedge drill's optimizer is plain SGD on both sides (the namesake's
uses ``parallel/zero.py``, held on its own in tests/test_torch_zero.py);
the drill's discrete outcomes and its arithmetic against the fault-free
reference are the same checks.

``FtTrainLoop`` at a small transformer (2 layers, d_model 64, vocab 256,
seq 32, f32) on four thread ranks of an ft ``LocalUniverse`` on the CPU:

- the fault-free run equals the JAX package's data-parallel arithmetic
  (per step the mean of the four ranks' ``jax.value_and_grad`` gradients
  of ``loss_fn``, then SGD) on the same numpy parameters, within
  ``tests/test_torch_train.py``'s tolerance (rtol 2e-4, atol 2e-6);
- a kill inside step 3's gradient allreduce (``kill_then_respawn``) and a
  wedge entering step 3 (``wedge_device``, a stub probe keyed to the
  wedge as the namesake's ``_wedge_probe``) both end at full size with
  the fault-free run's final parameters, bit for bit;
- the JAX package's ``FtTrainLoop`` under the same plans records the same
  recoveries, rollback step and loss-history lengths.

``TestDeviceFaultTrainRecoveryDvm``'s counterpart runs 3 port rank
processes under the port's daemon (``runtime/dvm.py``), the wedged one
respawned by it; ``slow``, as the namesake's is.

An autouse fixture checks after each test that no port detector,
prober, watchdog or respawn thread is alive, that no probe child is
orphaned and that the port's false-positive count did not move.
"""

import os
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.coll import tpu as jcoll_tpu
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.ft import ulfm as julfm
from zhpe_ompi_tpu.ft.inject import FaultPlan as JFaultPlan
from zhpe_ompi_tpu.ft.inject import WedgedDevice as JWedgedDevice
from zhpe_ompi_tpu.models import ftloop as jftloop
from zhpe_ompi_tpu.models import transformer as jt
from zhpe_ompi_tpu.parallel import mesh as jmesh
from zhpe_ompi_tpu.runtime import checkpoint as jcheckpoint
from zhpe_ompi_tpu.runtime import flightrec as jflightrec
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu_torch.coll import nccl as tcoll_nccl
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.ft import recovery as trecovery
from zhpe_ompi_tpu_torch.ft import ulfm as tulfm
from zhpe_ompi_tpu_torch.ft.inject import FaultPlan as TFaultPlan
from zhpe_ompi_tpu_torch.ft.inject import WedgedDevice as TWedgedDevice
from zhpe_ompi_tpu_torch.models import ftloop as tftloop
from zhpe_ompi_tpu_torch.models import transformer as tt
from zhpe_ompi_tpu_torch.parallel import mesh as tmesh
from zhpe_ompi_tpu_torch.runtime import checkpoint as tcheckpoint
from zhpe_ompi_tpu_torch.runtime import flightrec as tflightrec
from zhpe_ompi_tpu_torch.runtime import spc as tspc
from zhpe_ompi_tpu_torch.utils import deadline as tdeadline

from test_torch_ulfm import (  # noqa: F401
    JAX, PORT, both_vars, release_universes, run_tcp_ft, set_vars)

@pytest.fixture(autouse=True)
def _port_ft_hygiene():
    fps = tulfm.false_positive_count()
    yield
    release_universes()
    tulfm.clear_expected_failures()
    # device-fault events must not outlive the test in either package's
    # flight recorder: a later test's mttr_legs would anchor on them
    jflightrec.clear()
    tflightrec.clear()
    os.environ.pop(tcoll_nccl.WEDGE_ENV, None)
    assert tulfm.false_positive_count() == fps
    assert tulfm.live_detectors() == []
    assert tmesh.live_prober_threads() == []
    assert tdeadline.live_watchdog_threads() == []
    assert trecovery.live_respawn_threads() == []
    assert tdeadline.orphaned_probe_processes() == []


def _stub_probe(spc, kind="deadline", detail="stub", calls=None):
    def probe(timeout=None, deadline=None):
        if calls is not None:
            calls.append(kind)
        spc.record("device_probe_rounds")
        if kind in ("hung", "deadline"):
            spc.record("device_probe_misses")
        return kind, detail

    return probe


def _wedge_probe(spc, wedge, miss_kind="deadline"):
    """The namesake's ``_wedge_probe``: the child hangs only for the rank
    whose device wedged; every healthy rank's probe answers ok."""

    def probe(timeout=None, deadline=None):
        spc.record("device_probe_rounds")
        if wedge.fired:
            spc.record("device_probe_misses")
            return miss_kind, "wedged participant"
        return "ok", '{"n": 1, "platform": "stub"}'

    return probe


DEV = [  # (errors, ulfm, mesh, spc, flightrec, FaultPlan, WedgedDevice)
    (jerrors, julfm, jmesh, jspc, jflightrec, JFaultPlan, JWedgedDevice),
    (terrors, tulfm, tmesh, tspc, tflightrec, TFaultPlan, TWedgedDevice),
]


def same(run):
    ref = run(*DEV[0])
    got = run(*DEV[1])
    assert got == ref, (got, ref)
    return got


# -- TestDeviceFaultType / TestClassify ---------------------------------------


def test_device_fault_typed_class_and_family():
    def run(errors, *_):
        e = errors.DeviceFault("wedged", failed_ranks=[2], kind="hung")
        return (e.errclass, isinstance(e, errors.ProcFailed),
                e.failed_ranks, e.kind,
                "DEVICE_FAULT" in errors.error_string(errors.ERR_DEVICE_FAULT))

    assert same(run)[1:] == (True, (2,), "hung", True)


def test_miss_classifies_device_cause_into_failure_state():
    def run(errors, ulfm, mesh, spc, *_):
        state = ulfm.FailureState(4)
        before = spc.read("device_faults")
        faults = []
        probe = mesh.DeviceLivenessProbe(
            state=state, rank=2, on_fault=faults.append, enable=True)
        fault = probe.classify("deadline", "probe hit its deadline")
        return (type(fault).__name__, state.is_failed(2),
                state.cause_of(2), faults == [fault],
                spc.read("device_faults") - before)

    assert same(run) == ("DeviceFault", True, "device", True, 1)


def test_flightrec_event_is_typed():
    def run(errors, ulfm, mesh, spc, flightrec, *_):
        state = ulfm.FailureState(2)
        probe = mesh.DeviceLivenessProbe(state=state, rank=1, enable=True)
        flightrec.arm()
        try:
            probe.classify("hung", "outer kill")
            window = flightrec.window()
        finally:
            flightrec.disarm()
            # a fault event left in the ring would anchor a later
            # test's mttr_legs (the JAX package's test_ckptio reads it)
            flightrec.clear()
        kinds = [e["type"] for e in window]
        evt = [e for e in window if e["type"] == flightrec.DEVICE_FAULT][-1]
        return (evt["rank"], evt["kind"], flightrec.FT_CLASS in kinds)

    assert same(run) == (1, "hung", True)


# -- TestGuard -------------------------------------------------------------------


def test_fast_region_no_probe_no_fault():
    def run(errors, ulfm, mesh, spc, *_):
        calls = []
        probe = mesh.DeviceLivenessProbe(
            state=ulfm.FailureState(2), rank=0, enable=True,
            probe_fn=_stub_probe(spc, calls=calls), deadline=5.0)
        with probe.guard():
            pass
        return calls, probe.fault

    assert same(run) == ([], None)


def test_wedged_region_probes_and_classifies():
    def run(errors, ulfm, mesh, spc, *_):
        state = ulfm.FailureState(2)
        release = threading.Event()
        probe = mesh.DeviceLivenessProbe(
            state=state, rank=0, enable=True,
            probe_fn=_stub_probe(spc, "deadline"), deadline=0.05,
            on_fault=lambda f: release.set())
        with probe.guard():
            assert release.wait(10.0), "guard never classified"
        return state.cause_of(0), probe.fault.kind

    assert same(run) == ("device", "deadline")


def test_ok_probes_never_classify_a_slow_region():
    def run(errors, ulfm, mesh, spc, *_):
        state = ulfm.FailureState(2)
        calls = []
        probe = mesh.DeviceLivenessProbe(
            state=state, rank=0, enable=True,
            probe_fn=_stub_probe(spc, "ok", calls=calls), deadline=0.05,
            grace=2)
        hold = threading.Event()
        with probe.guard():
            deadline = time.monotonic() + 10.0
            while len(calls) < 2 and time.monotonic() < deadline:
                hold.wait(0.02)
        return len(calls) >= 2, probe.fault, state.is_failed(0)

    assert same(run) == (True, None, False)


def test_disabled_guard_is_a_noop():
    def run(errors, ulfm, mesh, spc, *_):
        calls = []
        probe = mesh.DeviceLivenessProbe(
            state=ulfm.FailureState(2), rank=0, enable=False,
            probe_fn=_stub_probe(spc, calls=calls), deadline=0.01)
        with probe.guard():
            time.sleep(0.1)
        return calls, probe.fault

    assert same(run) == ([], None)


def test_region_finishing_during_probe_is_not_classified():
    def run(errors, ulfm, mesh, spc, *_):
        state = ulfm.FailureState(2)
        probing = threading.Event()
        finish = threading.Event()

        def slow_probe(timeout=None, deadline=None):
            probing.set()
            finish.wait(10.0)
            return "deadline", "late miss"

        probe = mesh.DeviceLivenessProbe(
            state=state, rank=0, enable=True, probe_fn=slow_probe,
            deadline=0.05)
        wd = probe.guard()
        wd.arm()
        assert probing.wait(10.0)
        wd._disarmed.set()
        finish.set()
        wd._thread.join(5.0)
        return wd._thread.is_alive(), probe.fault, state.is_failed(0)

    assert same(run) == (False, None, False)


def test_probe_deadline_separates_region_and_child_deadlines():
    """The port's ``probe_deadline``: the region deadline arms the guard,
    the child gets its own (longer) internal deadline."""
    seen = []

    def probe_fn(timeout=None, deadline=None):
        seen.append((timeout, deadline))
        return "ok", "{}"

    probe = tmesh.DeviceLivenessProbe(
        state=tulfm.FailureState(1), rank=0, enable=True, probe_fn=probe_fn,
        deadline=0.05, probe_deadline=7.0, timeout=9.0, grace=1)
    with probe.guard():
        deadline = time.monotonic() + 10.0
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
    assert seen[0] == (9.0, 7.0) and probe.fault is None
    assert tmesh.DeviceLivenessProbe(deadline=3.0).probe_deadline == 3.0


# -- TestProbeChild (the real killable child, on the CPU) --------------------------


def test_healthy_plane_answers_ok():
    import json

    kind, detail = tmesh.probe_device_plane(timeout=90.0, deadline=60.0,
                                            device="cpu")
    assert kind == "ok", detail
    info = json.loads(detail)
    assert info["n"] == 1 and info["backend"] == "gloo"
    assert tdeadline.orphaned_probe_processes() == []


def test_wedge_hook_is_scoped_to_the_wedged_rank(monkeypatch):
    monkeypatch.setenv(tcoll_nccl.WEDGE_ENV, "2")
    kind, detail = tmesh.probe_device_plane(timeout=60.0, deadline=30.0,
                                            rank=0, device="cpu")
    assert kind == "ok", (kind, detail)
    kind, _ = tmesh.probe_device_plane(timeout=60.0, deadline=8.0, rank=2,
                                       device="cpu")
    assert kind == "deadline", kind
    assert tdeadline.orphaned_probe_processes() == []


def test_wedged_probe_through_the_guard_classifies(monkeypatch):
    """The guard's default probe is the real child: a rank whose wedge
    hook is set misses and classifies itself; ``device="cpu"`` keeps it
    off the card."""
    monkeypatch.setenv(tcoll_nccl.WEDGE_ENV, "1")
    state = tulfm.FailureState(2)
    released = threading.Event()
    probe = tmesh.DeviceLivenessProbe(
        state=state, rank=1, enable=True, deadline=0.05,
        probe_deadline=8.0, timeout=60.0, device="cpu",
        on_fault=lambda f: released.set())
    before = tspc.read("device_probe_misses")
    with probe.guard():
        assert released.wait(60.0), "the wedged child never classified"
    assert state.cause_of(1) == "device" and probe.fault.kind == "deadline"
    assert tspc.read("device_probe_misses") - before == 1
    assert tdeadline.orphaned_probe_processes() == []


# -- TestWedgePlan ------------------------------------------------------------------


def test_unscheduled_rank_never_fires():
    def run(errors, ulfm, mesh, spc, flightrec, FaultPlan, WedgedDevice):
        plan = FaultPlan().wedge_device(1, after_steps=0)
        wedge = plan.arm_device(0)
        for _ in range(10):
            wedge.tick()
        return wedge.fired

    assert same(run) is False


@pytest.mark.parametrize("pkg", [0, 1], ids=["jax", "port"])
def test_fire_parks_until_release_then_raises_typed(pkg):
    errors, ulfm, _, _, _, _, WedgedDevice = DEV[pkg]
    env = (jcoll_tpu if pkg == 0 else tcoll_nccl).WEDGE_ENV
    state = ulfm.FailureState(4)
    wedge = WedgedDevice(2, after_steps=1, state=state)
    out = {}

    def victim():
        try:
            wedge.tick()
            wedge.tick()
        except errors.DeviceFault as e:
            out["fault"] = e

    t = threading.Thread(target=victim, daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while not wedge.fired and time.monotonic() < deadline:
        time.sleep(0.01)
    assert wedge.fired and "fault" not in out
    assert os.environ.get(env) == "2"
    wedge.release(errors.DeviceFault("classified", failed_ranks=[2]))
    t.join(5.0)
    assert not t.is_alive()
    assert out["fault"].failed_ranks == (2,)
    assert os.environ.get(env) is None
    ulfm.clear_expected_failures()


def test_hold_wedge_ignores_release():
    wedge = TWedgedDevice(1, after_steps=0, hold=True)
    unwound = threading.Event()

    def victim():
        try:
            wedge.tick()
        except terrors.DeviceFault:
            unwound.set()

    t = threading.Thread(target=victim, daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while not wedge.fired and time.monotonic() < deadline:
        time.sleep(0.01)
    wedge.release()
    assert not unwound.wait(0.3)
    os.environ.pop(tcoll_nccl.WEDGE_ENV, None)


# -- TestDeviceProber (tests/test_tenancy.py) -----------------------------------------


class _FakeProbe:
    def __init__(self, errors):
        self.errors = errors
        self.rank = 0
        self.fault = None
        self.probes = 0
        self.wedged = False
        self.classified = []

    def probe_once(self):
        self.probes += 1
        return ("hung", "fake-wedge") if self.wedged else ("ok", "")

    def classify(self, kind, detail):
        self.classified.append((kind, detail))
        self.fault = self.errors.DeviceFault(
            detail, failed_ranks=(self.rank,), kind=kind)


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


def test_prober_interval_zero_is_off():
    def run(errors, ulfm, mesh, *_):
        prober = mesh.DeviceProber(_FakeProbe(errors), interval_ms=0)
        prober.start()
        return prober.running, mesh.live_prober_threads()

    assert same(run) == (False, [])


def test_prober_out_of_region_wedge_classifies_once():
    def run(errors, ulfm, mesh, spc, *_):
        probe = _FakeProbe(errors)
        prober = mesh.DeviceProber(probe, interval_ms=10)
        f0 = spc.read("device_probe_faults")
        prober.start()
        try:
            running = prober.running
            assert _wait(lambda: probe.probes >= 2)
            probe.wedged = True
            assert _wait(lambda: probe.classified)
            time.sleep(0.1)
            out = (running, probe.classified,
                   spc.read("device_probe_faults") - f0)
        finally:
            prober.stop()
        return out + (mesh.live_prober_threads(),)

    assert same(run) == (True, [("hung", "fake-wedge")], 1, [])


def test_prober_region_silences_background_probing():
    def run(errors, ulfm, mesh, *_):
        probe = _FakeProbe(errors)
        prober = mesh.DeviceProber(probe, interval_ms=10)
        prober.start()
        try:
            with prober.region():
                time.sleep(0.05)
                before = probe.probes
                time.sleep(0.15)
                quiet = probe.probes == before
            resumed = _wait(lambda: probe.probes > before)
        finally:
            prober.stop()
        return quiet, resumed, mesh.live_prober_threads()

    assert same(run) == (True, True, [])


# -- TestDeviceWedgeRecoveryThreadPlane (over ft TcpProc ranks) -----------------------


def _train_setup(rank, dim=8):
    return np.random.default_rng(100 + rank).normal(size=dim).astype(
        np.float32)


def _local_grad(w, target):
    loss = float(np.mean((w - target) ** 2))
    return loss, ((2.0 / w.size) * (w - target)).astype(np.float32)


def test_wedge_classify_flood_shrink_rollback_resume(both_vars, tmp_path):
    """4 ft TcpProc ranks train with SGD on a mean gradient; rank 2's
    device wedges entering step 3; its own guard classifies
    ``cause="device"``, the flood reaches every survivor, which revokes,
    shrinks, rolls back to the step-2 snapshot and finishes at 3 ranks —
    matching the fault-free reference arithmetic."""
    set_vars(ft_detector_period=0.05, ft_detector_timeout=60.0)
    n, victim, wedge_at, steps, dim, lr = 4, 2, 2, 6, 8, 0.1

    def run(P):
        spc = P.spc
        mesh = jmesh if P is JAX else tmesh
        plan = P.FaultPlan(seed=9).wedge_device(victim, after_steps=wedge_at)
        faults0 = spc.read("device_faults")

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            target = _train_setup(p.rank, dim)
            ck = P.Checkpointer(str(tmp_path / P.name / f"r{p.rank}"),
                                keep=10, check_quiescent=False)
            wedge = plan.arm_device(p.rank, state=p.ft_state)
            probe = mesh.DeviceLivenessProbe(
                state=p.ft_state, rank=p.rank, enable=True,
                probe_fn=_wedge_probe(spc, wedge), deadline=0.3)
            probe.on_fault = lambda f: (p.flood_device_fault(f),
                                        wedge.release(f))
            w = np.zeros(dim, np.float32)
            losses, step = [], 0

            def sgd_step(ep, w):
                loss, grad = _local_grad(w, target)
                total = np.asarray(ep.allreduce(grad, P.ops.SUM))
                return w - lr * (total / ep.size).astype(np.float32), loss

            try:
                while step < steps:
                    with probe.guard():
                        wedge.tick()
                        w, loss = sgd_step(p, w)
                    step += 1
                    losses.append(loss)
                    ck.save(step, {"w": w}, blocking=True)
                return ("clean", losses)
            except P.errors.DeviceFault as e:
                # the declared-dead incarnation goes as a killed process
                # would: no orderly goodbye (a goodbye through the rings
                # can overtake the device notice's gossip relay and pin
                # the cause at "goodbye" — in both packages)
                p.sever()
                return ("wedged", step, p.rank in e.failed_ranks)
            except (P.errors.ProcFailed, P.errors.ProcFailedPending,
                    P.errors.Revoked):
                p.revoke(P.coll_host.COLL_CID)
                assert p.ft_state.wait_failed(victim, timeout=10.0)
                deadline = time.monotonic() + 10.0
                while p.ft_state.cause_of(victim) != "device" \
                        and time.monotonic() < deadline:
                    time.sleep(0.02)
                cause = p.ft_state.cause_of(victim)
                p.failure_ack()
                sh = p.shrink()
                snap, ck_step = ck.restore()
                w = np.asarray(snap["w"])
                del losses[ck_step:]
                step = ck_step
                while step < steps:
                    w, loss = sgd_step(sh, w)
                    step += 1
                    losses.append(loss)
                sh.barrier()
                return ("survivor", cause, ck_step, sh.size, losses,
                        w.tolist())

        res = run_tcp_ft(P, n, prog)
        return res, spc.read("device_faults") - faults0

    ref, got = run(JAX), run(PORT)
    for res, faults in (ref, got):
        assert res[victim] == ("wedged", wedge_at, True)
        survivors = [r for r in range(n) if r != victim]
        for r in survivors:
            assert res[r][:4] == ("survivor", "device", wedge_at, 3)
        assert faults == 1
    # the reference arithmetic: 2 steps at 4 ranks, 4 at the survivors
    w = np.zeros(dim, np.float32)
    want_losses = []
    for ranks, k in ((list(range(n)), wedge_at),
                     ([0, 1, 3], steps - wedge_at)):
        for _ in range(k):
            want_losses.append(_local_grad(w, _train_setup(0, dim))[0])
            g = np.sum([_local_grad(w, _train_setup(r, dim))[1]
                        for r in ranks], axis=0)
            w = w - lr * (g / len(ranks)).astype(np.float32)
    for res, _ in (ref, got):
        np.testing.assert_allclose(res[0][4], want_losses, rtol=1e-5)
        np.testing.assert_allclose(res[0][5], w, rtol=1e-5)
    assert got[0][0][4] == ref[0][0][4]


def test_mixed_host_and_device_storm(both_vars):
    set_vars(ft_detector_period=0.05, ft_detector_timeout=60.0)
    n, kill_victim, wedge_victim = 4, 1, 3

    def run(P):
        mesh = jmesh if P is JAX else tmesh
        plan = P.FaultPlan(seed=11).kill_rank(kill_victim, after_ops=0) \
            .wedge_device(wedge_victim, after_steps=0)

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            wedge = plan.arm_device(p.rank, state=p.ft_state)
            probe = mesh.DeviceLivenessProbe(
                state=p.ft_state, rank=p.rank, enable=True,
                probe_fn=_wedge_probe(P.spc, wedge, "hung"), deadline=0.3)
            probe.on_fault = lambda f: (p.flood_device_fault(f),
                                        wedge.release(f))
            inj = plan.arm(p)
            try:
                with probe.guard():
                    wedge.tick()
                    inj.allreduce(np.full(8, float(p.rank + 1)), P.ops.SUM)
            except P.errors.DeviceFault as e:
                return ("wedged", p.rank in e.failed_ranks)
            except (P.errors.ProcFailed, P.errors.ProcFailedPending,
                    P.errors.Revoked):
                p.revoke(P.coll_host.COLL_CID)
            assert p.ft_state.wait_failed(kill_victim, timeout=10.0)
            assert p.ft_state.wait_failed(wedge_victim, timeout=10.0)
            deadline = time.monotonic() + 10.0
            while p.ft_state.cause_of(wedge_victim) != "device" \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            cause = p.ft_state.cause_of(wedge_victim)
            p.failure_ack()
            sh = p.shrink()
            total = sh.allreduce(np.full(4, 1.0), P.ops.SUM)
            return (cause, sh.size, float(np.asarray(total)[0]))

        return run_tcp_ft(P, n, prog)

    got = run(PORT)
    assert got == run(JAX)
    assert got == [("device", 2, 2.0), "killed", ("device", 2, 2.0),
                   ("wedged", True)]


def _wedge_agree_gap(P, survivor_probe_s):
    """4 ft thread ranks, one host allreduce per step under the guard; rank
    2's device wedges entering step 1.  The victim's probe misses after
    0.3 s, the survivors' answer ok after ``survivor_probe_s`` (on the card
    their real children take 8-11 s and still run when the victim's child
    misses).  Returns each survivor's ms from the classification to the
    start of its failed-set agreement."""
    mesh = jmesh if P is JAX else tmesh
    plan = P.FaultPlan(seed=9).wedge_device(2, after_steps=1)
    stamps: dict = {}

    def prog(p):
        p.set_errhandler(P.errh.ERRORS_RETURN)
        wedge = plan.arm_device(p.rank, state=p.ft_state)

        def probe_fn(timeout=None, deadline=None):
            time.sleep(0.3 if wedge.fired else survivor_probe_s)
            return ("deadline", "wedged") if wedge.fired else ("ok", "{}")

        probe = mesh.DeviceLivenessProbe(state=p.ft_state, rank=p.rank,
                                         enable=True, probe_fn=probe_fn,
                                         deadline=0.2, grace=2)

        def on_fault(f):
            stamps.setdefault("class", time.monotonic())
            wedge.release(f)

        probe.on_fault = on_fault
        try:
            for _ in range(3):
                with probe.guard():
                    wedge.tick()
                    p.allreduce(np.ones(4), P.ops.SUM)
        except P.errors.DeviceFault as e:
            if p.rank in e.failed_ranks:
                return "victim"
            p.revoke(P.coll_host.COLL_CID)
        except P.errors.ProcFailed:
            p.revoke(P.coll_host.COLL_CID)
        except P.errors.Revoked:
            pass
        stamps[p.rank] = time.monotonic()
        p.failure_ack()
        P.recovery.agree_failed_set(p)
        return "survivor"

    uni = P.uni_mod.LocalUniverse(4, ft=True)
    try:
        res = uni.run(prog, timeout=60.0)
    finally:
        if hasattr(uni, "close"):
            uni.close()
    tulfm.clear_expected_failures()
    assert res == ["survivor", "survivor", "victim", "survivor"]
    return [(stamps[r] - stamps["class"]) * 1e3 for r in (0, 1, 3)]


def test_wedge_survivors_agree_gap_is_the_guards_disarm_join(both_vars):
    """ROADMAP queue C item 6's wedge gap, isolated on the CPU in both
    packages: a wedge's survivors start agreeing ~1.0 s after the
    classification only while their own guard's probe is still running.  Each survivor's guard
    exit then waits out ``Watchdog.disarm``'s 0.5 s join of the probing
    watchdog thread, and the rank released by a peer's revoke waits two of
    them (0.5 s, then 1.0 s); with probes that have returned, the survivors
    agree at once.  The same in both packages: the design's tidy-up join,
    not a fault of the port."""
    set_vars(ft_detector_period=0.05, ft_detector_timeout=60.0)
    for P in (JAX, PORT):
        slow = _wedge_agree_gap(P, survivor_probe_s=2.0)
        fast = _wedge_agree_gap(P, survivor_probe_s=0.0)
        assert min(slow) >= 450.0 and max(slow) >= 950.0, (P.name, slow)
        assert max(fast) < 450.0, (P.name, fast)


# -- TestFtTrainLoop (plumbing, no fault) ---------------------------------------------


class _Stub:
    def __init__(self, ulfm):
        self.rank, self.size = 0, 1
        self.ft_state = ulfm.FailureState(1)


LOOPS = [(jftloop, jcheckpoint.Checkpointer, julfm, jerrors),
         (tftloop, tcheckpoint.Checkpointer, tulfm, terrors)]


def _np_step_fn(target):
    def step_fn(ep, state, i):
        w = np.asarray(state["w"])
        loss, grad = _local_grad(w, target)
        return {"w": w - 0.1 * grad}, loss
    return step_fn


def test_ftloop_runs_steps_and_checkpoints(tmp_path):
    out = []
    for k, (ftloop, Ck, ulfm, _) in enumerate(LOOPS):
        loop = ftloop.FtTrainLoop(
            _Stub(ulfm), step_fn=_np_step_fn(_train_setup(0)),
            state={"w": np.zeros(8, np.float32)},
            checkpointer=Ck(str(tmp_path / str(k)), keep=10,
                            check_quiescent=False),
            ckpt_every=2)
        _, losses = loop.run(5)
        out.append((losses, loop.ckpt.all_steps()))
    assert out[1] == out[0]
    assert out[1][1] == [0, 2, 4, 5] and out[1][0][-1] < out[1][0][0]


def test_ftloop_restore_resumes_the_exact_trajectory(tmp_path):
    ftloop, Ck, ulfm, _ = LOOPS[1]
    step_fn = _np_step_fn(_train_setup(0))
    ck = Ck(str(tmp_path), keep=20, check_quiescent=False)
    first = ftloop.FtTrainLoop(_Stub(ulfm), step_fn=step_fn,
                               state={"w": np.zeros(8, np.float32)},
                               checkpointer=ck, ckpt_every=1)
    first.run(8)
    second = ftloop.FtTrainLoop(_Stub(ulfm), step_fn=step_fn,
                                state={"w": np.zeros(8, np.float32)},
                                checkpointer=ck, ckpt_every=1)
    second.restore(None)
    second.state, step = ck.restore(6)
    second.step_i = step
    second.run(8)
    np.testing.assert_allclose(second.losses, first.losses[6:8], rtol=1e-6)


def test_ftloop_rejoin_restore_threads_shardings_fn(tmp_path, monkeypatch):
    ftloop, Ck, ulfm, _ = LOOPS[1]
    step_fn = _np_step_fn(_train_setup(0))
    ck = Ck(str(tmp_path), check_quiescent=False)
    ftloop.FtTrainLoop(_Stub(ulfm), step_fn=step_fn,
                       state={"w": np.zeros(8, np.float32)},
                       checkpointer=ck, ckpt_every=1).run(2)
    seen = []
    orig = ck.restore

    def spying_restore(step=None, placements=None):
        seen.append(placements)
        return orig(step, placements)

    ck.restore = spying_restore
    monkeypatch.setenv("ZMPI_REJOIN", "1")
    loop = ftloop.FtTrainLoop(
        _Stub(ulfm), step_fn=step_fn, state={"w": np.zeros(8, np.float32)},
        checkpointer=ck, ckpt_every=1, shardings_fn=lambda ep: {"w": "cpu"})
    loop.run(2)
    assert seen == [{"w": "cpu"}] and loop.step_i == 2
    assert isinstance(loop.state["w"], (torch.Tensor, np.ndarray))


def test_ftloop_typed_fault_without_respawner_is_loud(tmp_path):
    for k, (ftloop, Ck, ulfm, errors) in enumerate(LOOPS):
        def step_fn(ep, state, i, errors=errors):
            raise errors.ProcFailed("peer died", failed_ranks=[1])

        loop = ftloop.FtTrainLoop(
            _Stub(ulfm), step_fn=step_fn, state={"x": 1},
            checkpointer=Ck(str(tmp_path / str(k)), check_quiescent=False))
        with pytest.raises(errors.UnsupportedError):
            loop.run(1)


def test_ftloop_own_device_fault_reraises(tmp_path):
    for k, (ftloop, Ck, ulfm, errors) in enumerate(LOOPS):
        def step_fn(ep, state, i, errors=errors):
            raise errors.DeviceFault("me", failed_ranks=[0])

        loop = ftloop.FtTrainLoop(
            _Stub(ulfm), step_fn=step_fn, state={"x": 1},
            checkpointer=Ck(str(tmp_path / str(k)), check_quiescent=False),
            respawner=lambda victims: None)
        with pytest.raises(errors.DeviceFault):
            loop.run(1)


# -- FtTrainLoop driving the small transformer on four thread ranks ----------------

SMALL = dict(vocab=256, d_model=64, n_heads=4, d_ff=128, n_layers=2, seq=32)
BATCH, LR, STEPS, CKPT_EVERY, FAULT_STEP = 2, 1e-2, 6, 2, 3
VICTIM = 2
RTOL, ATOL = 2e-4, 2e-6  # tests/test_torch_train.py's


def _np_params():
    cfg = jt.Config(**SMALL, dtype=jnp.float32, flash=False, fused_ln=False)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, {k: np.asarray(v) for k, v in params.items()}


def _batch(rank):
    rng = np.random.default_rng(1000 + rank)
    shape = (BATCH, SMALL["seq"])
    return (rng.integers(0, SMALL["vocab"], shape).astype(np.int64),
            rng.integers(0, SMALL["vocab"], shape).astype(np.int64))


def _jax_step_fn(cfg, rank, wrap=None):
    tokens, targets = _batch(rank)
    vg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, jnp.asarray(tokens, jnp.int32),
                             jnp.asarray(targets, jnp.int32), cfg)))

    def step_fn(ep, params, i):
        names = sorted(params)
        loss, g = vg({k: jnp.asarray(np.asarray(params[k])) for k in names})
        flat = np.concatenate([np.asarray(g[k]).reshape(-1) for k in names])
        comm = wrap(ep, i) if wrap is not None else ep
        total = np.asarray(comm.allreduce(flat, jops.SUM))
        out, off = {}, 0
        for k in names:
            p = np.asarray(params[k])
            out[k] = p - (LR / ep.size) * total[off:off + p.size].reshape(
                p.shape)
            off += p.size
        return out, float(loss)

    return step_fn


def _port_step_fn(cfg, rank, wrap=None):
    tokens, targets = _batch(rank)
    return tftloop.make_dp_step(cfg, tokens, targets, LR, device="cpu",
                                wrap=wrap)


class _RecordingCheckpointer:
    """Mixin: remember every restored step (the rollback step)."""

    def restore(self, step=None, *args):
        out = super().restore(step, *args)
        self.restored.append(int(out[1]))
        return out


def _recording(Ck, directory):
    cls = type("RecCk", (_RecordingCheckpointer, Ck), {})
    ck = cls(directory, keep=10, check_quiescent=False)
    ck.restored = []
    return ck


def _run_ftloop(pkg, fault, tmp_path):
    """One 4-rank run of FtTrainLoop on a thread universe of package
    ``pkg`` ("jax"/"port") under ``fault`` (None, "kill", "wedge").
    Returns per rank (first life and replacement) the final parameters
    as numpy, the losses, the recoveries and the restored steps."""
    P = JAX if pkg == "jax" else PORT
    ftloop = jftloop if pkg == "jax" else tftloop
    mesh = jmesh if pkg == "jax" else tmesh
    cfg_j, np_params = _np_params()
    if pkg == "jax":
        cfg = cfg_j
        make_step = _jax_step_fn
        init = dict(np_params)
        _jax_step_fn(cfg, 0)(_Local1(), init, 0)  # compile before threads
    else:
        cfg = tt.Config(**SMALL, dtype=torch.float32)
        make_step = _port_step_fn
        init = tt.params_from_numpy(np_params, cfg, device="cpu")
    uni = P.universe(4, ft=True)
    uni.start_failure_detector(period=0.05, timeout=30.0)
    plan = P.FaultPlan(seed=23)
    if fault == "kill":
        # dies at its 2nd pt2pt op of step 3's gradient allreduce: inside
        # the ring's reduce-scatter, so no survivor completes the step
        plan.kill_then_respawn(VICTIM, after_ops=1)
    elif fault == "wedge":
        plan.wedge_device(VICTIM, after_steps=FAULT_STEP)
    handles = {}
    root = tmp_path / f"{pkg}-{fault}"

    def make_loop(ctx, first_life):
        wrap = None
        if fault == "kill" and first_life and ctx.rank == VICTIM:
            # only the victim's allreduce runs on the counted surface (a
            # proxy keeps its own collective sequence number, so a
            # survivor's live window must not go through one)
            def wrap(ep, i):
                return plan.arm(ep) if i == FAULT_STEP else ep
        wedge = plan.arm_device(ctx.rank, state=ctx.ft_state) \
            if first_life else None
        probe = None
        if fault == "wedge":
            stub = wedge if wedge is not None \
                else types.SimpleNamespace(fired=False)
            probe = mesh.DeviceLivenessProbe(
                state=ctx.ft_state, rank=ctx.rank, enable=True,
                probe_fn=_wedge_probe(P.spc, stub), deadline=0.5)
        return ftloop.FtTrainLoop(
            ctx, step_fn=make_step(cfg, ctx.rank, wrap),
            state=dict(init),
            checkpointer=_recording(P.Checkpointer,
                                    str(root / f"r{ctx.rank}")),
            ckpt_every=CKPT_EVERY, probe=probe, wedge=wedge,
            respawner=respawner)

    def outcome(loop, tag):
        state = {k: np.asarray(v) for k, v in loop.state.items()}
        return (tag, state, list(loop.losses), loop.recoveries,
                list(loop.ckpt.restored))

    def replacement(ctx):
        ctx.set_errhandler(P.errh.ERRORS_RETURN)
        loop = make_loop(ctx, first_life=False)
        loop.restore()
        loop.run(STEPS)
        return outcome(loop, "replacement")

    def respawner(victims):
        handles.update(P.recovery.respawn_ranks(uni, victims, replacement))

    def prog(ctx):
        ctx.set_errhandler(P.errh.ERRORS_RETURN)
        loop = make_loop(ctx, first_life=True)
        try:
            loop.run(STEPS)
        except P.errors.DeviceFault as e:
            return ("wedged", ctx.rank in e.failed_ranks)
        return outcome(loop, "done")

    eager = P.var.get("pt2pt_eager_limit")
    if pkg == "jax" and fault is not None:
        # the namesake's thread-plane rendezvous send has no failure
        # classification: a survivor whose ring send parks toward the
        # killed or wedged rank waits in ShrunkEndpoint.sendrecv forever
        # (ROADMAP queue C).  Eager chunks keep its runs from that wait.
        P.var.set_var("pt2pt_eager_limit", 1 << 24)
    try:
        res = uni.run(prog, timeout=120.0)
        second = {v: h.result(timeout=60.0) for v, h in handles.items()}
    finally:
        uni.stop_failure_detector()
        getattr(uni, "close", lambda: None)()  # the port's explicit teardown
        P.var.set_var("pt2pt_eager_limit", eager)
    return res, second, sorted(uni.ft_state.failed())


class _Local1:
    """A one-rank endpoint for compiling the JAX step before threads."""
    rank, size = 0, 1

    def allreduce(self, x, op):
        return x


@pytest.fixture(scope="module")
def ftloop_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ftloop")
    out = {}
    for fault in (None, "kill", "wedge"):
        out[("port", fault)] = _run_ftloop("port", fault, tmp)
    for fault in (None, "kill", "wedge"):
        out[("jax", fault)] = _run_ftloop("jax", fault, tmp)
    tulfm.clear_expected_failures()
    julfm.clear_expected_failures()
    return out


def _final(res, second):
    """Per rank the parameters that rank ended with (a replacement's for
    the victim's slot)."""
    out = []
    for r, x in enumerate(res):
        if isinstance(x, tuple) and x[0] == "done":
            out.append(x[1])
        else:
            out.append(second[r][1])
    return out


def test_ftloop_fault_free_matches_jax_data_parallel_arithmetic(ftloop_runs):
    res, second, failed = ftloop_runs[("port", None)]
    assert second == {} and failed == []
    finals = _final(res, second)
    cfg, params = _np_params()
    grad_fns = []
    for r in range(4):
        tokens, targets = _batch(r)
        grad_fns.append(jax.jit(jax.grad(
            lambda p, t=tokens, y=targets: jt.loss_fn(
                p, jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32),
                cfg))))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    for _ in range(STEPS):
        gs = [g(p) for g in grad_fns]
        p = {k: p[k] - LR * sum(g[k] for g in gs) / 4 for k in p}
    for r in range(4):
        for k in p:
            np.testing.assert_allclose(finals[r][k], np.asarray(p[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    for r in range(1, 4):
        for k in p:
            np.testing.assert_array_equal(finals[r][k], finals[0][k])
    assert all(x[3] == 0 and len(x[2]) == STEPS for x in res)


@pytest.mark.parametrize("fault", ["kill", "wedge"])
def test_ftloop_recovers_to_full_size_with_fault_free_parameters(
        ftloop_runs, fault):
    base = _final(*ftloop_runs[("port", None)][:2])
    res, second, failed = ftloop_runs[("port", fault)]
    assert failed == [] and sorted(second) == [VICTIM]
    finals = _final(res, second)
    for r in range(4):
        for k in base[0]:
            np.testing.assert_array_equal(finals[r][k], base[0][k],
                                          err_msg=f"{fault} rank {r} {k}")
    rollback = (FAULT_STEP // CKPT_EVERY) * CKPT_EVERY
    for r in range(4):
        if r == VICTIM:
            tag, _, losses, recoveries, restored = second[r]
            assert (tag, recoveries, restored) == ("replacement", 0,
                                                   [rollback])
            assert len(losses) == STEPS - rollback
        else:
            tag, _, losses, recoveries, restored = res[r]
            assert (tag, recoveries, restored) == ("done", 1, [rollback])
            assert len(losses) == STEPS
    if fault == "kill":
        assert res[VICTIM] is None
    else:
        assert res[VICTIM] == ("wedged", True)
    base_losses = ftloop_runs[("port", None)][0][0][2]
    assert res[0][2] == base_losses


@pytest.mark.parametrize("fault", [None, "kill", "wedge"])
def test_ftloop_jax_package_records_the_same_recoveries(ftloop_runs, fault):
    def discrete(run):
        res, second, failed = run
        rows = []
        for x in res:
            rows.append(x if not (isinstance(x, tuple) and x[0] == "done")
                        else (x[0], len(x[2]), x[3], x[4]))
        sec = {v: (s[0], len(s[2]), s[3], s[4]) for v, s in second.items()}
        return rows, sec, failed

    assert discrete(ftloop_runs[("port", fault)]) == \
        discrete(ftloop_runs[("jax", fault)])


# ------------------------------ the real-process DVM drill (slow) ----------


_DVM_DEVICE_DRILL_PROG = '''
import os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch.core import errhandler as errh
from zhpe_ompi_tpu_torch.ft import recovery
from zhpe_ompi_tpu_torch.ft.inject import FaultPlan
from zhpe_ompi_tpu_torch.models.ftloop import FtTrainLoop
from zhpe_ompi_tpu_torch.parallel import mesh as mesh_mod
from zhpe_ompi_tpu_torch.runtime.checkpoint import Checkpointer

DIM = 8
STEPS = 6
WEDGE_RANK = int(os.environ.get("TEST_WEDGE_RANK", "-1"))

proc = zmpi.host_init()
proc.set_errhandler(errh.ERRORS_RETURN)
rng = np.random.default_rng(100 + proc.rank)
target = torch.from_numpy(rng.normal(size=DIM).astype(np.float32))
observed = {{}}


def step_fn(ep, state, i):
    w = torch.as_tensor(state["w"])  # a restored snapshot holds arrays
    loss = float(((w - target) ** 2).mean())
    grad = (2.0 / w.numel()) * (w - target)
    total = ep.allreduce(grad, zmpi.SUM)
    return {{"w": w - 0.1 * total / ep.size}}, loss


def remesh_fn(ep, state):
    # where the agreed cause is known: sample it for the gate
    if WEDGE_RANK >= 0 and proc.rank != WEDGE_RANK:
        c = proc.ft_state.cause_of(WEDGE_RANK)
        if c:
            observed.setdefault("cause", c)


plan = FaultPlan(seed=3)
if WEDGE_RANK >= 0 and os.environ.get("ZMPI_REJOIN") != "1":
    # the first incarnation only: a replacement re-arming the schedule
    # would wedge itself at the same step forever
    plan.wedge_device(WEDGE_RANK, after_steps=2)
# hold=True: the victim never unwinds (healthy heartbeats, hung device)
# until the recovery's respawn SIGKILLs it
wedge = plan.arm_device(proc.rank, state=proc.ft_state, hold=True)
probe = mesh_mod.DeviceLivenessProbe(
    state=proc.ft_state, rank=proc.rank, enable=True, device="cpu",
    timeout=float(os.environ.get("TEST_PROBE_TIMEOUT", "40")),
    deadline=float(os.environ.get("TEST_PROBE_DEADLINE", "8")))
loop = FtTrainLoop(
    proc, step_fn=step_fn, state={{"w": torch.zeros(DIM)}},
    checkpointer=Checkpointer(
        os.path.join(os.environ["TEST_CKPT"], f"r{{proc.rank}}"),
        keep=20, check_quiescent=False),
    ckpt_every=1, probe=probe, wedge=wedge,
    respawner=recovery.daemon_respawn, remesh_fn=remesh_fn)
state, losses = loop.run(STEPS)
print(f"TRAIN-OK rank={{proc.rank}} size={{proc.size}} "
      f"recoveries={{loop.recoveries}} steps={{len(losses)}} "
      f"final={{losses[-1]:.6f}} cause={{observed.get('cause', '-')}}",
      flush=True)
zmpi.host_finalize()
'''


def _dvm_device_drill(tmp_path, wedge):
    import io
    import re

    from zhpe_ompi_tpu_torch.runtime import dvm as tdvm

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tag = "wedge" if wedge else "ref"
    prog = tmp_path / f"drill_{tag}.py"
    prog.write_text(_DVM_DEVICE_DRILL_PROG.format(repo=repo))
    env = {"TEST_CKPT": str(tmp_path / f"ckpt_{tag}"),
           "TEST_WEDGE_RANK": "1" if wedge else "-1",
           "TEST_PROBE_DEADLINE": "8", "TEST_PROBE_TIMEOUT": "40"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    d = tdvm.Dvm()
    try:
        cli = tdvm.DvmClient(d.address)
        out, err = io.StringIO(), io.StringIO()
        rc = cli.launch(3, [str(prog)], ft=True, timeout=240.0,
                        mca=[("ft_detector_period", "2.0"),
                             ("ft_detector_timeout", "120.0")],
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
    return re.findall(r"TRAIN-OK rank=(\d+) size=(\d+) recoveries=(\d+) "
                      r"steps=(\d+) final=([\d.]+) cause=(\S+)",
                      out.getvalue())


@pytest.mark.slow
def test_train_loop_survives_wedged_participant_under_the_daemon(tmp_path):
    """TestDeviceFaultTrainRecoveryDvm's counterpart: 3 port rank
    processes under the port's daemon train; rank 1's device wedges at
    step 2 and never unwinds: its probe classifies ``cause="device"``,
    the survivors shrink, roll back, the daemon respawns the rank, and
    every rank finishes at full size with the fault-free run's losses."""
    ref = {int(r[0]): float(r[4]) for r in _dvm_device_drill(tmp_path, False)}
    assert sorted(ref) == [0, 1, 2]
    rows = {int(r[0]): r for r in _dvm_device_drill(tmp_path, True)}
    assert sorted(rows) == [0, 1, 2], rows
    for rank, (_, size, recov, steps, final, cause) in rows.items():
        assert int(size) == 3
        assert abs(float(final) - ref[rank]) < 1e-5
        if rank != 1:
            assert int(recov) == 1 and cause == "device"
