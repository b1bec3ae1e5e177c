"""Deterministic fault injection — the test harness of the ULFM path
(namesake: ``zhpe_ompi_tpu/ft/inject.py``; the port's own copy).

Every recovery mechanism in :mod:`.ulfm` must be exercisable on CPU in
tier-1 without real process death, and *deterministically*: the same plan
kills the same rank at the same operation count every run.  A
:class:`FaultPlan` is that schedule; :meth:`FaultPlan.arm` wraps a rank's
endpoint so its point-to-point operations are counted, and at the chosen
count the rank "dies":

- its heartbeats stop (the universe's :class:`~.ulfm.HeartbeatBoard`
  slot is killed, or the TCP endpoint stops emitting), so the ring
  detector discovers it;
- its transport is severed (TCP sockets closed abruptly, no quiescence —
  the peer sees connection reset, exactly like a real crash);
- :class:`~.ulfm.RankKilled` unwinds the rank's program (a
  ``BaseException``, so recovery code catching ``MpiError`` never
  swallows its own death).

Kill modes: ``"exit"`` (default) — the rank's thread/process unwinds and
the runtime marks the death immediately (a crash); ``"mute"`` — only the
heartbeats stop and nothing is marked, so the *detector* is the only
discovery path (a hang/partition).

Replay integration (:mod:`.vprotocol`): a killed rank that was running
under pessimistic logging can be restarted against its log and, once the
log is exhausted, continue live — see
:class:`~.vprotocol.RejoinContext` and :func:`replay_rejoin`.

Device wedges (:meth:`FaultPlan.wedge_device`) export the probe child's
wedge hook, ``coll/nccl.WEDGE_ENV``, for the wedged rank's own probes.
The checkpoint-seam faults of the namesake (``ckpt_fault`` and its
helpers, ``arm_ckpt``, ``CkptSeamContext``, ``corrupt_ckpt_shard``)
inject into the collective checkpoint plane ``io/ckptio.py``, which the
port has not ported yet: they raise ``UnsupportedError`` naming it.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Any

from ..coll.host import HostCollectives
from ..coll.nbc import NonblockingCollectives
from ..core import errors
from . import ulfm


def _waits_for_ckptio(what: str) -> errors.UnsupportedError:
    return errors.UnsupportedError(
        f"{what} injects into the collective checkpoint plane "
        "(io/ckptio.py), which the PyTorch port has not ported yet")


class FaultPlan:
    """A deterministic kill schedule: which rank dies after how many
    point-to-point operations (each send/recv/sendrecv counts one),
    and which rank's DEVICE plane wedges after how many train steps
    (:meth:`wedge_device` — the device-plane twin; both schedules
    compose in one plan, the mixed host+device fault storm).

    ``seed`` drives :meth:`random_kill`'s choices, so randomized stress
    runs replay exactly from the seed alone."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._kills: dict[int, tuple[int, str]] = {}
        self._wedges: dict[int, int] = {}
        self._respawns: set[int] = set()
        self._ckpt_faults: dict[int, list[dict]] = {}

    def kill_rank(self, rank: int, after_ops: int,
                  mode: str = "exit") -> "FaultPlan":
        """Schedule `rank` to die when it attempts operation
        ``after_ops + 1`` (i.e. it completes exactly `after_ops` ops)."""
        if mode not in ("exit", "mute"):
            raise errors.ArgError(f"unknown kill mode {mode!r}")
        if after_ops < 0:
            raise errors.ArgError("after_ops must be >= 0")
        self._kills[int(rank)] = (int(after_ops), mode)
        return self

    def random_kill(self, size: int, max_ops: int = 8,
                    mode: str = "exit") -> "FaultPlan":
        """Seed-derived kill: one victim in [0, size), one op count in
        [1, max_ops] — deterministic given the constructor seed."""
        rank = self._rng.randrange(size)
        ops = self._rng.randint(1, max_ops)
        return self.kill_rank(rank, ops, mode)

    def kill_ranks(self, ranks, after_ops: int, mode: str = "exit",
                   respawn: bool = False) -> "FaultPlan":
        """Schedule N victims at once — the multi-failure plan the
        batched recovery pipeline (:func:`~zhpe_ompi_tpu_torch.ft.recovery.
        respawn_victims`) recovers in ONE agree → shrink → respawn
        pass.  ``respawn=True`` marks every victim for respawn."""
        for r in ranks:
            if respawn:
                self.kill_then_respawn(int(r), after_ops, mode)
            else:
                self.kill_rank(int(r), after_ops, mode)
        return self

    def kill_then_respawn(self, rank: int, after_ops: int,
                          mode: str = "exit") -> "FaultPlan":
        """Schedule a kill AND mark the victim for respawn: the recovery
        pipeline (:mod:`.recovery`) queries :attr:`respawn_victims` to
        grow the job back to full size after shrink + rollback — the
        kill-then-respawn plan of the checkpoint-integrated restart
        test harness."""
        self.kill_rank(rank, after_ops, mode)
        self._respawns.add(int(rank))
        return self

    def wedge_device(self, rank: int, after_steps: int) -> "FaultPlan":
        """Schedule `rank`'s DEVICE plane to wedge when it begins step
        ``after_steps + 1`` (it completes exactly `after_steps` steps).
        Nothing exits and nothing stops heartbeating — the process is
        healthy, only its device collective hangs (the NCCL-wedge
        failure mode) — so the device liveness probe is the ONLY
        discovery path, exactly the scenario the probe exists for.
        Composes with :meth:`kill_rank`/:meth:`kill_ranks` in one plan
        (mixed host+device fault storms)."""
        if after_steps < 0:
            raise errors.ArgError("after_steps must be >= 0")
        self._wedges[int(rank)] = int(after_steps)
        return self

    def kill_for(self, rank: int) -> tuple[int, str] | None:
        return self._kills.get(rank)

    def wedge_for(self, rank: int) -> int | None:
        return self._wedges.get(int(rank))

    def wants_respawn(self, rank: int) -> bool:
        return int(rank) in self._respawns

    @property
    def victims(self) -> frozenset:
        return frozenset(self._kills)

    @property
    def device_victims(self) -> frozenset:
        return frozenset(self._wedges)

    @property
    def respawn_victims(self) -> frozenset:
        return frozenset(self._respawns)

    # -- checkpoint-seam faults (io/ckptio.py fault points) ---------------

    _CKPT_SEAMS = ("gather", "aggregate", "write", "manifest")

    def ckpt_fault(self, rank: int, seam: str, after: int = 0,
                   action: str = "exit", hold_s: float = 0.0,
                   times: int = 1) -> "FaultPlan":
        """Schedule a fault at a checkpoint seam of ``rank``: the seam
        fires on its occurrence ``after + 1`` (``after`` occurrences
        complete cleanly).  Seams — ``"gather"`` (a non-aggregator's
        shard send), ``"aggregate"`` (an aggregator collecting one of
        its group's shards: the mid-two-phase-exchange kill point),
        ``"write"`` (one deadline-bounded fbtl stream attempt: the
        mid-stream kill / wedge point), ``"manifest"`` (rank 0 about to
        publish).  Actions — ``"exit"`` (thread-plane crash:
        :class:`~.ulfm.RankKilled` unwinds the writer), ``"kill9"``
        (real-process crash: SIGKILL self at the seam), ``"wedge"``
        (sleep ``hold_s`` inside the attempt, pushing it past the
        ``ckpt_write_deadline_s`` watchdog — fires ``times`` times then
        goes inert, so the retry ladder's later attempts succeed)."""
        raise _waits_for_ckptio("ckpt_fault")
        if seam not in self._CKPT_SEAMS:
            raise errors.ArgError(f"unknown ckpt seam {seam!r}")
        if action not in ("exit", "kill9", "wedge"):
            raise errors.ArgError(f"unknown ckpt fault action {action!r}")
        if after < 0:
            raise errors.ArgError("after must be >= 0")
        self._ckpt_faults.setdefault(int(rank), []).append({
            "seam": seam, "after": int(after), "action": action,
            "hold_s": float(hold_s), "times": int(times),
        })
        return self

    def ckpt_kill_aggregator(self, rank: int, after_shards: int = 0,
                             action: str = "exit") -> "FaultPlan":
        """Kill ``rank`` (an aggregator) mid two-phase exchange, after
        it has collected ``after_shards`` of its group's shards."""
        return self.ckpt_fault(rank, "aggregate", after_shards, action)

    def ckpt_kill_writer(self, rank: int, after_writes: int = 0,
                         action: str = "exit") -> "FaultPlan":
        """Kill ``rank`` mid-stream, after ``after_writes`` completed
        fbtl write attempts."""
        return self.ckpt_fault(rank, "write", after_writes, action)

    def ckpt_wedge_write(self, rank: int, hold_s: float,
                         after: int = 0, times: int = 1) -> "FaultPlan":
        """Wedge ``rank``'s fbtl stream write past its deadline for
        ``times`` attempts (then inert — the retry ladder recovers)."""
        return self.ckpt_fault(rank, "write", after, "wedge",
                               hold_s=hold_s, times=times)

    def ckpt_faults_for(self, rank: int) -> list[dict]:
        return [dict(f) for f in self._ckpt_faults.get(int(rank), [])]

    @property
    def ckpt_victims(self) -> frozenset:
        return frozenset(r for r, fs in self._ckpt_faults.items()
                         if any(f["action"] != "wedge" for f in fs))

    def arm(self, ep) -> "InjectedContext":
        """Wrap one rank's endpoint with op counting + the kill trigger."""
        return InjectedContext(ep, self)

    def arm_ckpt(self, rank: int, ep=None,
                 state=None) -> "CkptSeamContext":
        """Arm one rank's checkpoint-seam faults: the returned context
        manager installs itself as an :func:`~zhpe_ompi_tpu_torch.io.ckptio.
        install_fault_hook` hook for its scope (a no-op forever if this
        rank has no ckpt faults in the plan).  ``ep``/``state`` give the
        ``"exit"`` action its detector bookkeeping + transport kill, the
        :meth:`InjectedContext.die` semantics at a checkpoint seam."""
        raise _waits_for_ckptio("arm_ckpt")

    def arm_device(self, rank: int, state=None,
                   hold: bool = False) -> "WedgedDevice":
        """Arm one rank's device-plane wedge: the returned
        :class:`WedgedDevice` is ticked once per guarded train step and
        fires at the scheduled count (a no-op forever if this rank has
        no wedge in the plan).  ``hold=True`` makes the fired wedge
        ignore :meth:`WedgedDevice.release` — the TRUE-wedge drill: the
        victim process stays parked until the recovery pipeline's
        respawn SIGKILLs the declared-dead incarnation."""
        return WedgedDevice(int(rank), self.wedge_for(rank), state,
                            hold=hold)


class WedgedDevice:
    """One rank's armed device wedge — the injectable stand-in for a
    GPU participant freezing mid-all-reduce.

    ``tick()`` once per guarded device-collective region; at the
    scheduled step the wedge FIRES: it registers the expected failure
    (detector-accuracy bookkeeping), exports the probe-child wedge
    hook (``coll/nccl.WEDGE_ENV`` — the rank's own liveness probes now
    hang exactly like its collective would), and parks the calling
    thread.  The park resolves one of two ways:

    - :meth:`release` (the ``DeviceLivenessProbe`` on_fault hook in
      thread-plane drills): the parked "collective" unwinds by raising
      typed :class:`~zhpe_ompi_tpu_torch.core.errors.DeviceFault` — CI can
      drive the whole classify→shrink→remesh ladder in one process;
    - never (real-process drills): the rank stays wedged — healthy
      heartbeats, hung device — until the recovery pipeline's respawn
      SIGKILLs the declared-dead incarnation (the PRRTE contract).
    """

    def __init__(self, rank: int, after_steps: int | None, state=None,
                 hold: bool = False):
        self.rank = int(rank)
        self._at = after_steps
        self._state = state
        self.hold = bool(hold)
        self.steps = 0
        self.fired = False
        self._release = threading.Event()
        self._fault: errors.DeviceFault | None = None

    def tick(self) -> None:
        """One guarded step begins.  Fires the wedge at its count."""
        self.steps += 1
        if self._at is not None and self.steps > self._at \
                and not self.fired:
            self.fire()

    def fire(self) -> None:
        """The wedge: park this thread as the hung collective would.
        The probe-child hook is scoped to THIS rank's probes (a healthy
        survivor sharing the process must not inherit the wedge — its
        own probe answering ok is exactly what keeps it from
        self-classifying); a real-process drill's probes all carry this
        rank's number anyway."""
        self.fired = True
        if self._state is not None:
            ulfm.expect_failure(self._state, self.rank)
        from ..coll import nccl as coll_nccl

        os.environ[coll_nccl.WEDGE_ENV] = str(self.rank)
        self._release.wait()
        raise self._fault or errors.DeviceFault(
            f"rank {self.rank}: wedged device collective classified",
            failed_ranks=[self.rank],
        )

    def release(self, fault: errors.DeviceFault | None = None) -> None:
        """Unwind the parked wedge (classification happened): the
        ``DeviceLivenessProbe`` on_fault hook for in-process drills.
        Also clears the probe-child wedge hook so post-recovery probes
        in this process answer again.  A ``hold=True`` wedge ignores
        this — a real wedge has no unwind; only the respawn's SIGKILL
        ends it."""
        if self.hold:
            return
        from ..coll import nccl as coll_nccl

        self._fault = fault
        os.environ.pop(coll_nccl.WEDGE_ENV, None)
        self._release.set()


class CkptSeamContext:
    """One rank's armed checkpoint-seam faults (namesake: the
    ``io/ckptio.py`` fault hook).  Raises ``UnsupportedError`` naming
    ``io/ckptio.py`` until that plane is ported."""

    def __init__(self, plan: FaultPlan, rank: int, ep=None, state=None):
        raise _waits_for_ckptio("CkptSeamContext")


def corrupt_ckpt_shard(directory: str, step: int | None = None,
                       leaf: int = 0, rank: int = 0) -> str:
    """The corrupt-a-shard-on-disk fault point of the namesake (it
    flips a manifest-recorded shard of a collective checkpoint); raises
    ``UnsupportedError`` naming ``io/ckptio.py``."""
    raise _waits_for_ckptio("corrupt_ckpt_shard")


def _state_of(ep) -> "ulfm.FailureState | None":
    state = getattr(ep, "ft_state", None)
    if state is not None:
        return state
    uni = getattr(ep, "universe", None)
    return getattr(uni, "ft_state", None) if uni is not None else None


def _kill_transport(ep, mode: str) -> None:
    """Make the endpoint look dead to the outside world: silence its
    heartbeats, and for a crash ("exit") sever its transport."""
    uni = getattr(ep, "universe", None)
    if uni is not None and getattr(uni, "ft_board", None) is not None:
        uni.ft_board.kill(ep.rank)
    if hasattr(ep, "sever"):
        if mode == "exit":
            ep.sever()
        else:
            ep.mute()


class InjectedContext:
    """Endpoint proxy that counts operations and fires the plan's kill.

    The point-to-point surface is counted directly (send/recv/sendrecv/
    isend/irecv); collective methods are re-bound to THIS proxy, so their
    internal pt2pt traffic runs through the counted surface and a kill
    scheduled inside a collective fires mid-operation, at a pt2pt
    boundary, the way a real crash lands.  Everything else (ULFM calls,
    attributes) passes through to the wrapped endpoint untouched."""

    # public methods of the collective surfaces get re-bound to the proxy
    _COLL_NAMES = frozenset(
        name
        for base in (HostCollectives, NonblockingCollectives)
        for name in vars(base)
        if not name.startswith("_")
    )

    def __init__(self, ep, plan: FaultPlan):
        self._ep = ep
        self._plan = plan
        self.ops = 0
        kill = plan.kill_for(ep.rank)
        self._kill_at, self._kill_mode = kill if kill else (None, "exit")

    @property
    def rank(self) -> int:
        return self._ep.rank

    @property
    def size(self) -> int:
        return self._ep.size

    @property
    def endpoint(self):
        return self._ep

    def _tick(self) -> None:
        self.ops += 1
        if self._kill_at is not None and self.ops > self._kill_at:
            self.die()

    def die(self) -> None:
        """The kill: register the expected failure (detector-accuracy
        bookkeeping), silence/sever the transport, unwind the program."""
        state = _state_of(self._ep)
        if state is not None:
            ulfm.expect_failure(state, self._ep.rank)
        _kill_transport(self._ep, self._kill_mode)
        raise ulfm.RankKilled(self._ep.rank, self._kill_mode)

    # -- counted pt2pt surface -------------------------------------------

    def send(self, obj: Any, dest: int, tag: int = 0, cid: int = 0) -> None:
        self._tick()
        return self._ep.send(obj, dest, tag, cid)

    def recv(self, *args, **kwargs):
        self._tick()
        return self._ep.recv(*args, **kwargs)

    def sendrecv(self, *args, **kwargs):
        self._tick()
        return self._ep.sendrecv(*args, **kwargs)

    def isend(self, obj: Any, dest: int, tag: int = 0, cid: int = 0):
        self._tick()
        return self._ep.isend(obj, dest, tag, cid)

    def irecv(self, *args, **kwargs):
        self._tick()
        return self._ep.irecv(*args, **kwargs)

    def __getattr__(self, name: str):
        if name in self._COLL_NAMES:
            # look the method up on the endpoint's TYPE (an override like
            # TcpProc.barrier wins) and bind it to the proxy: its
            # self.send/self.recv land on the counted surface above
            fn = getattr(type(self._ep), name, None)
            if callable(fn):
                return fn.__get__(self)
        return getattr(self._ep, name)


def replay_rejoin(logger, rank: int, live_ep):
    """Restart a killed rank: deterministic replay from its pessimistic
    log, then live continuation on `live_ep` once the log is exhausted
    (see :class:`~.vprotocol.RejoinContext`).  Clears the rank's failure
    record so survivors stop classifying it dead — the
    checkpoint-integrated restart hook."""
    state = _state_of(live_ep)
    if state is not None:
        state.restore(rank)
    from .vprotocol import RejoinContext

    return RejoinContext(logger.replay_context(rank), live_ep)
