"""User-Level Failure Mitigation — the ULFM analog of the host plane
(namesake: ``zhpe_ompi_tpu/ft/ulfm.py``; the port's own copy).

The host plane shared by thread ranks
(:class:`~zhpe_ompi_tpu_torch.pt2pt.universe.RankContext`) and socket
ranks (:class:`~zhpe_ompi_tpu_torch.pt2pt.tcp.TcpProc`):

- :class:`FailureState` — per-job view of failed/acked ranks and revoked
  cids (one shared instance per thread universe; one per process on the
  wire, kept coherent by flooding).
- :class:`RingDetector` — the ULFM ring heartbeat detector: each rank
  *emits* heartbeats to its nearest live predecessor (its observer) and
  *observes* its nearest live successor; a missed-beat window marks the
  observed rank suspect and the suspicion propagates (shared state for
  thread ranks, a failure-notice flood for socket ranks).  Period and
  timeout are MCA variables (``ft_detector_period``/``ft_detector_timeout``).
- :func:`agree` — fault-tolerant agreement (flag AND-reduction) that
  completes despite participant death: the lowest live rank coordinates;
  a dead coordinator triggers re-election and a tagged retry round.
- :class:`ShrunkEndpoint` — the survivor communicator: live ranks
  renumbered densely, full host-collective surface over a
  generation-isolated cid space.

The control-plane cids, the agreement tags and the shrink cid windows are
the namesake's, value for value, so port and JAX-package ranks share one
ft universe on the wire.

Detector health is observable: suspicions of ranks that were never
actually killed count as *false positives* (see
:func:`false_positive_count`), and every detector registers itself so
tests can assert no heartbeat thread leaks (:func:`live_detectors`).

The device plane's revocations (``Communicator``, one process per GPU)
are the process-global cid registry below.  In the JAX package one
controller dispatches every device's operation, so its set of revoked
cids is the complete view.  Here each GPU has its own process and its
own set, and a revoke must also reach the other ranks.  It travels
through the store of the default process group, which every rank shares:

- the revoking rank sets ``zmpi_revoked/<gid>`` (``gid`` is the id of
  the communicator's process group, agreed by its members,
  ``Communicator.gid``) and then adds one to ``zmpi_revoke_seq``;
- a watcher thread in every other rank reads ``zmpi_revoke_seq`` every
  ``POLL_S`` (50 ms); when it moves, it checks the key of each live
  group it knows and revokes the cids of its communicators there.

A revoked group stays revoked: a communicator built over it later is
revoked at once, until the group is destroyed
(``comm/communicator.forget_destroyed``).  The check in the collective
path stays a lookup in the local set: no store round trip per
collective.  A revoke reaches another rank within one poll interval plus
a store round trip, and only ranks whose watcher runs
(``runtime.init()`` starts it when the world has more than one rank, and
``finalize()`` stops it).
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from typing import Any, Callable, Iterable

from ..coll.host import HostCollectives
from ..comm.group import Group
from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..runtime import flightrec, spc
from ..runtime import ztrace

_stream = mca_output.open_stream("ft")

mca_var.register(
    "ft_detector_period", 0.05,
    "Heartbeat emission period (seconds) of the ULFM ring failure "
    "detector (the reference's opal_mca_ft_detector_period)",
    type=float,
)
mca_var.register(
    "ft_detector_timeout", 0.5,
    "Missed-heartbeat window (seconds) after which the observed rank is "
    "suspected dead (opal_mca_ft_detector_timeout analog)",
    type=float,
)
mca_var.register(
    "ft_agree_timeout", 30.0,
    "Per-round deadline (seconds) of the fault-tolerant agreement "
    "protocol before the coordinator is presumed dead and re-elected",
    type=float,
)

# Control-plane cids, outside the user and collective cid spaces
FT_HB_CID = 0x7FF6      # heartbeat frames (wire transport only)
FT_NOTICE_CID = 0x7FF5  # failure-notice floods
FT_REVOKE_CID = 0x7FF4  # revoke floods
FT_AGREE_CID = 0x7FF3   # agreement rounds
FT_AGREE_PUB_CID = 0x7FF2  # completed-agreement result announcements
FT_BYE_CID = 0x7FF1     # orderly-departure goodbyes (close(), not death)
FT_JOIN_CID = 0x7FF0    # rejoin/re-modex frames (respawned-rank JOIN + ACK)
FT_DVM_CID = 0x7FEF     # authoritative daemon fault events (zprted waitpid
#                         truth: the DVM watched the corpse exit; payload is
#                         [[rank, exit_code], ...] — OS evidence, no timeout)
_AGREE_TAG = 0x7D00

# Shrunken communicators get a generation-isolated cid window so
# pre-shrink traffic (including traffic FROM the dead rank) can never
# match post-shrink operations.  The generation is a pure function of
# the failure count: every survivor that shrinks with the same (agreed)
# failure knowledge lands in the SAME window with no extra negotiation
# round — the reason ULFM requires uniform knowledge before shrink.
_SHRINK_CID_BASE = 0x100000
_SHRINK_CID_STRIDE = 0x10000

_state_uids = itertools.count(1)

# -- process-global bookkeeping -----------------------------------------

#: seconds between the watcher's reads of the revoke sequence number
POLL_S = 0.05
SEQ_KEY = "zmpi_revoke_seq"
KEY_PREFIX = "zmpi_revoked/"

_global_lock = threading.Lock()
# Device-plane Communicator cids are allocated monotonically and never
# reused, so a process-global revocation set is safe for them; endpoint
# cids (small, reused across tests) are revoked on their FailureState.
_REVOKED_CIDS: set[int] = set()
_REVOKED_GIDS: set[str] = set()
# (state.uid, rank) pairs a fault plan intends to kill: a detector
# suspicion outside this set is a FALSE POSITIVE.  The bare-rank set is
# the cross-process fallback: on the wire every process holds its OWN
# FailureState, and a real observer cannot know the victim's state uid —
# the injection harness registers the victim's global rank out-of-band
# (test instrumentation, not protocol).  In a clean run both sets are
# empty, so every suspicion counts — the zero-false-positive gate keeps
# full strength exactly where it matters.
_EXPECTED_FAILURES: set[tuple[int, int]] = set()
_EXPECTED_RANK_KILLS: set[int] = set()
_false_positives = 0
_DETECTORS: list["RingDetector"] = []


def revoke_cid(cid: int) -> None:
    """Process-local cid poisoning (MPIX_Comm_revoke's effect on this
    rank)."""
    with _global_lock:
        _REVOKED_CIDS.add(int(cid))
    flightrec.record(flightrec.REVOKE, cid=int(cid), plane="device")


def is_revoked(cid: int) -> bool:
    """Device-plane (Communicator) revocation check."""
    # unlocked fast path: CPython set membership is atomic enough for a
    # monotonic poison set (entries are only ever added)
    return cid in _REVOKED_CIDS


def reset_revocations() -> None:
    """Test isolation: forget every revocation of this process."""
    with _global_lock:
        _REVOKED_CIDS.clear()
        _REVOKED_GIDS.clear()


# -- across processes ---------------------------------------------------------

# gid -> communicators of this process with that gid (weakly held)
_by_gid: dict[str, weakref.WeakSet] = {}


def track(comm) -> None:
    """Remember a communicator so that a revoke of its gid on another rank
    can find it here; one built over a revoked group is revoked at once."""
    with _global_lock:
        _by_gid.setdefault(comm.gid, weakref.WeakSet()).add(comm)
        revoked = comm.gid in _REVOKED_GIDS
    if revoked:
        revoke_cid(comm.cid)


def publish_revocation(store, gid: str) -> None:
    """Tell the other ranks that the communicator ``gid`` was revoked."""
    store.set(KEY_PREFIX + gid, b"1")
    store.add(SEQ_KEY, 1)


def revoke_group(gid: str) -> int:
    """Revoke the group ``gid`` in this process: the cid of each of its
    communicators, and of any built over it later.  Returns the number
    newly revoked."""
    with _global_lock:
        _REVOKED_GIDS.add(gid)
        comms = list(_by_gid.get(gid, ()))
    n = 0
    for comm in comms:
        if not is_revoked(comm.cid):
            revoke_cid(comm.cid)
            n += 1
    return n


def forget_group(gid: str) -> None:
    """The group ``gid`` was destroyed: forget its communicators and its
    revocation, so a new group under the same name starts unrevoked."""
    with _global_lock:
        _REVOKED_GIDS.discard(gid)
        _by_gid.pop(gid, None)


class RevocationWatcher:
    """The thread that applies other ranks' revokes to this process's
    communicators (see the module docstring)."""

    def __init__(self, store):
        self.store = store
        self._halt = threading.Event()
        self._seen = int(store.add(SEQ_KEY, 0))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="zmpi-revoke-watcher")
        self._thread.start()

    def poll(self) -> int:
        """One read of the sequence number; returns the number of local
        communicators newly revoked."""
        seq = int(self.store.add(SEQ_KEY, 0))
        if seq == self._seen:
            return 0
        self._seen = seq
        with _global_lock:
            gids = [g for g, comms in _by_gid.items() if len(comms)]
        n = 0
        for gid in gids:
            if self.store.check([KEY_PREFIX + gid]):
                n += revoke_group(gid)
        if n:
            spc.record("comm_revokes_received", n)
            mca_output.verbose(5, _stream, "revocation watcher: %d "
                               "communicator(s) revoked by a peer", n)
        return n

    def _run(self) -> None:
        while not self._halt.wait(POLL_S):
            try:
                self.poll()
            except RuntimeError as e:  # the store went away at teardown
                mca_output.verbose(2, _stream, "revocation watcher "
                                   "stopped: %s", e)
                return

    def stop(self, timeout: float = 5.0) -> None:
        self._halt.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)


def expect_failure(state: "FailureState", rank: int) -> None:
    """Pre-register an intended kill so its detection is not counted as a
    detector false positive (called by the fault-injection harness)."""
    with _global_lock:
        _EXPECTED_FAILURES.add((state.uid, rank))
        _EXPECTED_RANK_KILLS.add(int(rank))


def clear_expected_failures() -> None:
    """Test isolation: forget the kills fault plans registered, so a
    later test's detector suspicions are judged at full strength — the
    zero-false-positive gate must not be blinded by rank numbers an
    EARLIER test legitimately killed."""
    with _global_lock:
        _EXPECTED_FAILURES.clear()
        _EXPECTED_RANK_KILLS.clear()


def false_positive_count() -> int:
    """Detector suspicions of ranks no fault plan ever killed — must stay
    0 across a clean run (the detector-accuracy acceptance gate)."""
    return _false_positives


def live_detectors() -> list["RingDetector"]:
    """Detector threads still running (must be [] after fixtures clean
    up — heartbeat threads may not leak into later tests)."""
    with _global_lock:
        _DETECTORS[:] = [d for d in _DETECTORS if d.is_alive()]
        return list(_DETECTORS)


def _register_detector(det: "RingDetector") -> None:
    with _global_lock:
        _DETECTORS[:] = [d for d in _DETECTORS if d.is_alive()]
        _DETECTORS.append(det)


class RankKilled(BaseException):
    """Raised inside a rank's program by the fault-injection harness to
    simulate process death.  Deliberately NOT an ``MpiError``: recovery
    code catching typed failures must never swallow its own death."""

    def __init__(self, rank: int, mode: str = "exit"):
        super().__init__(f"rank {rank} killed by fault plan (mode={mode})")
        self.rank = rank
        self.mode = mode  # "exit": thread unwinds; "mute": only hb stop


class FailureState:
    """One job's ULFM view: failed ranks, acknowledged failures, revoked
    cids.  Shared by every thread rank of a universe; per-process on the
    wire (kept coherent by the detector's failure-notice flood)."""

    def __init__(self, size: int):
        self.size = size
        self.uid = next(_state_uids)
        self._failed: set[int] = set()
        self._acked: set[int] = set()
        self._cause: dict[int, str] = {}
        self._revoked: set[int] = set()
        # cid -> logical cid it carries traffic FOR: the han tag
        # windows (pt2pt/groups.py GroupView) register themselves as
        # aliases of the collective cid, so revoking the logical
        # channel poisons the hierarchical phases' parked and future
        # operations exactly like the flat path's
        self._cid_aliases: dict[int, int] = {}
        self._shrink_groups: dict[int, frozenset[int]] = {}
        self._agreements: dict[int, Any] = {}
        # cumulative crash counter: bumps on every NEWLY-learned crash
        # and never decrements — restore() (a rejoin) must not let a
        # later shrink reuse an earlier generation's cid window for a
        # DIFFERENT survivor set
        self._crash_epoch = 0
        self._cv = threading.Condition()
        # death observers (e.g. the sm transport unmapping its rings to
        # a corpse): invoked OUTSIDE the cv, once per newly-learned
        # departure/failure, from whatever thread learned it
        self._listeners: list = []

    # -- failure listeners -----------------------------------------------

    def remove_failure_listener(self, fn) -> None:
        """Unregister a failure listener (a freed window must not keep
        recovering lock words for the rest of the endpoint's life);
        unknown listeners are ignored — remove races close paths."""
        with self._cv:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def add_failure_listener(self, fn) -> None:
        """Register ``fn(rank, cause)`` to run on every NEWLY-learned
        peer death or departure — the transport-teardown hook (a ring
        into a dead peer's address space must be unmapped; its consumer
        is never coming back).  Called outside the state lock; a
        listener that raises is logged-and-dropped, never fatal to the
        classification path that discovered the death."""
        with self._cv:
            self._listeners.append(fn)

    def _notify_death(self, rank: int, cause: str) -> None:
        with self._cv:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(rank, cause)
            except Exception as e:  # observer must not break the
                # classifier that discovered the death — but the drop
                # is LOUD: a teardown hook that silently failed leaves
                # rings mapped into a corpse's address space (ZL004)
                mca_output.emit(
                    "ft",
                    "failure listener %r raised on death of rank %s "
                    "(%s): %s — dropped", fn, rank, cause, e,
                )

    # -- failures --------------------------------------------------------

    def mark_failed(self, rank: int, cause: str = "transport") -> bool:
        """Record a rank death; returns True when newly learned.  A
        ``cause="detector"`` suspicion of a rank no fault plan killed is
        counted as a false positive."""
        with self._cv:
            if rank in self._failed:
                return False
            self._failed.add(rank)
            self._cause[rank] = cause
            self._crash_epoch += 1
            self._cv.notify_all()
        if cause == "detector":
            with _global_lock:
                if ((self.uid, rank) not in _EXPECTED_FAILURES
                        and rank not in _EXPECTED_RANK_KILLS):
                    global _false_positives
                    _false_positives += 1
        # the flight-recorder classification event lands BEFORE the
        # listeners run: a metrics publisher's on_classification hook
        # ships the window with this event as its tail entry
        flightrec.record(flightrec.FT_CLASS, rank=int(rank), cause=cause)
        if ztrace.active:
            # the recovery story's ROOT span: agree/shrink/respawn
            # legs follow it on the merged timeline
            ztrace.instant(ztrace.FT_CLASS, -1, failed=int(rank),
                           cause=cause)
        self._notify_death(rank, cause)
        return True

    def merge_failed(self, ranks: Iterable[int], cause: str = "notice"
                     ) -> None:
        for r in ranks:
            self.mark_failed(int(r), cause=cause)

    # causes that are SYMPTOMS (what a peer observed), not root cause:
    # a typed classification arriving later may refine them
    CIRCUMSTANTIAL_CAUSES = frozenset({"transport", "notice",
                                       "detector"})

    def refine_cause(self, rank: int, cause: str) -> bool:
        """Adopt a ROOT-CAUSE classification for an already-known
        failure: typed evidence (a device fault's own probe, a daemon's
        waitpid truth) outranks the circumstantial cause a downstream
        symptom produced first — a wedged device's host transport dies
        as a side effect, and whichever evidence wins the race must not
        hide what actually happened.  Returns True when refined."""
        with self._cv:
            if rank in self._failed and \
                    self._cause.get(rank) in self.CIRCUMSTANTIAL_CAUSES:
                self._cause[rank] = str(cause)
                return True
        return False

    def is_failed(self, rank: int) -> bool:
        return rank in self._failed

    def failed(self) -> frozenset:
        with self._cv:
            return frozenset(self._failed)

    def cause_of(self, rank: int) -> str | None:
        return self._cause.get(rank)

    def crash_count(self) -> int:
        """CURRENTLY-failed crashes, excluding orderly goodbyes.  The
        non-consensus shrink generation derives from this count: a BYE
        flood still in flight (finalize skew) must not put survivors
        holding identical crash knowledge into different cid windows."""
        with self._cv:
            return sum(1 for r in self._failed
                       if self._cause.get(r) != "goodbye")

    def crash_epoch(self) -> int:
        """CUMULATIVE crash counter (never decremented by restore): the
        consensus shrink derives its generation from the agreed MAX of
        these, so a post-rejoin crash can never land a new survivor set
        in a cid window an earlier shrink already used."""
        with self._cv:
            return self._crash_epoch

    def raise_epoch(self, epoch: int) -> None:
        """Adopt an agreed (or JOIN-ack'd) crash-epoch floor — a
        respawned rank's fresh state must count forward from the
        survivors' epoch, not from zero."""
        with self._cv:
            self._crash_epoch = max(self._crash_epoch, int(epoch))

    def failed_with_causes(self) -> list[tuple[int, str]]:
        """Snapshot of (rank, cause) pairs — the contribution this rank
        feeds into the failed-set agreement."""
        with self._cv:
            return sorted(
                (r, self._cause.get(r, "unknown")) for r in self._failed
            )

    def live(self) -> list[int]:
        with self._cv:
            return [r for r in range(self.size) if r not in self._failed]

    def wait_failed(self, rank: int, timeout: float | None = None) -> bool:
        """Block until `rank` is known failed (suspicion propagation)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while rank not in self._failed:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(0.05 if left is None else min(left, 0.05))
            return True

    def wait_restored(self, rank: int, timeout: float | None = None) -> bool:
        """Block until `rank` is no longer failed — the survivors' wait
        for a respawned replacement to rejoin (restore() notifies)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while rank in self._failed:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(0.05 if left is None else min(left, 0.05))
            return True

    # -- acknowledgement (MPIX_Comm_failure_ack / _get_acked) ------------

    def ack(self) -> frozenset:
        """Acknowledge every currently-known failure; wildcard receives
        blocked on PROC_FAILED_PENDING may proceed afterwards."""
        with self._cv:
            self._acked |= self._failed
            return frozenset(self._acked)

    def acked(self) -> frozenset:
        with self._cv:
            return frozenset(self._acked)

    def unacked(self) -> frozenset:
        with self._cv:
            return frozenset(self._failed - self._acked)

    def mark_departed(self, rank: int) -> bool:
        """Orderly goodbye (a peer's clean close): the rank is gone, so
        named receives on it classify typed ``ProcFailed`` — but the
        departure is pre-acknowledged, so it never gates wildcard
        receives the way an unacknowledged CRASH does.  ULFM pending
        semantics exist for failures recovery has not yet seen; normal
        finalize skew must not abort healthy survivors.  Returns True
        when the departure is NEWLY learned (the gossip-once gate for
        relaying BYE notices to peers the departing rank never
        connected to)."""
        with self._cv:
            fresh = rank not in self._failed
            if fresh:
                self._failed.add(rank)
                self._cause[rank] = "goodbye"
            self._acked.add(rank)
            self._cv.notify_all()
        if fresh:
            flightrec.record(flightrec.FT_CLASS, rank=int(rank),
                             cause="goodbye")
            self._notify_death(rank, "goodbye")
        return fresh

    def restore(self, rank: int) -> None:
        """Forget a failure — the rejoin path: a replayed/restarted rank
        re-enters the job (checkpoint-integrated restart)."""
        with self._cv:
            self._failed.discard(rank)
            self._acked.discard(rank)
            self._cause.pop(rank, None)
            self._cv.notify_all()  # wait_restored watchers

    # -- shrink membership ----------------------------------------------

    def register_shrink(self, generation: int, members: Iterable[int]
                        ) -> None:
        """Record a shrink window's survivor set, so classification can
        tell a PRE-shrink failure (of a non-member — exempt by the ULFM
        shrink contract) from a POST-shrink death of a member."""
        with self._cv:
            self._shrink_groups[int(generation)] = frozenset(
                int(r) for r in members
            )

    def shrink_group(self, generation: int) -> frozenset[int] | None:
        return self._shrink_groups.get(generation)

    # -- agreed results --------------------------------------------------

    def record_agreement(self, seq: int, result: Any) -> bool:
        """Publish a completed agreement's value: survivors that lose
        their coordinator mid-delivery converge on THIS result instead
        of re-running a round nobody can finish (see :func:`agree`).
        Values are arbitrary (bool for the flag AND-reduction, a
        [pairs, epoch] list for the failed-set agreement).  Returns
        True when the value is NEWLY adopted — the overlay flood's
        gossip-once relay predicate (a known value is never relayed
        again, so the flood terminates)."""
        with self._cv:
            fresh = int(seq) not in self._agreements
            self._agreements[int(seq)] = result
        return fresh

    def agreement(self, seq: int) -> Any | None:
        return self._agreements.get(seq)

    # -- revocation ------------------------------------------------------

    def revoke(self, cid: int) -> bool:
        """Poison ``cid``.  Returns True when the revocation is NEWLY
        learned (the overlay flood's gossip-once relay predicate)."""
        with self._cv:
            fresh = int(cid) not in self._revoked
            self._revoked.add(int(cid))
            self._cv.notify_all()
        if fresh:
            flightrec.record(flightrec.REVOKE, cid=int(cid))
        return fresh

    def alias_cid(self, cid: int, logical: int) -> None:
        """Declare ``cid`` a sub-channel of ``logical``: revocation of
        the logical cid then classifies against both (the han tag
        windows ride this; see pt2pt/groups.py)."""
        with self._cv:
            self._cid_aliases[int(cid)] = int(logical)

    def is_revoked(self, cid: int) -> bool:
        # unlocked fast path (monotonic poison set + write-once aliases)
        return cid in self._revoked or \
            self._cid_aliases.get(cid) in self._revoked

    def revoked_cids(self) -> frozenset:
        """Snapshot of the endpoint-plane revoked cids — the checkpoint
        quiescence view exempts their queue rows: a revoked channel
        never delivers again (recv on it raises ``Revoked``), so an
        aborted schedule's parked receives must not wedge
        ``quiesce_check`` for the rest of the job's life.  Aliased
        sub-channels (han tag windows) whose LOGICAL cid is revoked are
        included: their parked phase ops are just as uncancellable."""
        with self._cv:
            out = set(self._revoked)
            out.update(c for c, logical in self._cid_aliases.items()
                       if logical in self._revoked)
            return frozenset(out)

    def check_revoked(self, cid: int) -> None:
        if self.is_revoked(cid):
            raise errors.Revoked(f"communicator cid={cid} is revoked",
                                 cid=cid)


class HeartbeatBoard:
    """Shared heartbeat medium of a thread universe: one monotonic
    timestamp slot per rank (the btl/self analog of heartbeat frames).
    ``kill`` silences a rank — the fault-injection hook that makes a
    dead thread stop beating."""

    def __init__(self, size: int):
        now = time.monotonic()
        self._last = [now] * size
        self._dead = [False] * size
        self._lock = threading.Lock()

    def beat(self, rank: int) -> None:
        with self._lock:
            if not self._dead[rank]:
                self._last[rank] = time.monotonic()

    def last(self, rank: int) -> float:
        with self._lock:
            return self._last[rank]

    def kill(self, rank: int) -> None:
        with self._lock:
            self._dead[rank] = True

    def revive(self, rank: int) -> None:
        """Re-admit a rank (clean end-of-run, or a rejoin after replay):
        its slot beats again with a fresh window."""
        with self._lock:
            self._dead[rank] = False
            self._last[rank] = time.monotonic()

    def is_dead(self, rank: int) -> bool:
        with self._lock:
            return self._dead[rank]


class BoardTransport:
    """Detector transport over a :class:`HeartbeatBoard` (thread ranks)."""

    def __init__(self, board: HeartbeatBoard, rank: int):
        self._board = board
        self._rank = rank

    def emit(self, _dest: int) -> None:
        self._board.beat(self._rank)

    def last_beat(self, rank: int) -> float:
        return self._board.last(rank)

    def grace(self, rank: int) -> None:
        # board timestamps are global; a live rank's slot is always fresh
        pass


class WireTransport:
    """Detector transport over framed heartbeats (socket ranks): the
    endpoint feeds :meth:`on_beat` from its drain loop; emission rides a
    caller-provided frame sender."""

    def __init__(self, rank: int, size: int,
                 emit_fn: Callable[[int], None]):
        now = time.monotonic()
        self._last = {r: now for r in range(size)}
        self._lock = threading.Lock()
        self._emit = emit_fn
        self._rank = rank

    def on_beat(self, src: int) -> None:
        with self._lock:
            self._last[src] = time.monotonic()

    def emit(self, dest: int) -> None:
        if dest != self._rank:
            self._emit(dest)

    def last_beat(self, rank: int) -> float:
        with self._lock:
            return self._last[rank]

    def grace(self, rank: int) -> None:
        # freshly-adopted observed target: restart its window so a rank
        # that was beating toward the DEAD observer isn't insta-suspected
        with self._lock:
            self._last[rank] = time.monotonic()


class RingDetector(threading.Thread):
    """The ULFM ring failure detector as a daemon thread.

    Rank r emits one heartbeat per ``ft_detector_period`` toward its
    nearest live predecessor and observes its nearest live successor;
    when the observed rank's last beat ages past ``ft_detector_timeout``
    it is marked failed (suspicion) and the suspicion propagates via
    ``flood`` (no-op for thread ranks — their state is shared)."""

    def __init__(self, rank: int, size: int, state: FailureState,
                 transport, flood: Callable[[frozenset], None] | None = None,
                 muted: Callable[[], bool] | None = None,
                 period: float | None = None, timeout: float | None = None,
                 name: str | None = None):
        super().__init__(name=name or f"ft-detector-{rank}", daemon=True)
        self.rank = rank
        self.size = size
        self.state = state
        self.transport = transport
        self._flood = flood
        self._muted = muted
        self.period = float(
            period if period is not None
            else mca_var.get("ft_detector_period", 0.05)
        )
        self.timeout = float(
            timeout if timeout is not None
            else mca_var.get("ft_detector_timeout", 0.5)
        )
        self.suspicions: list[int] = []
        self._halt = threading.Event()
        _register_detector(self)

    # -- ring neighbourhood over the live set ----------------------------

    def _live_succ(self) -> int:
        for k in range(1, self.size):
            r = (self.rank + k) % self.size
            if not self.state.is_failed(r):
                return r
        return self.rank

    def _live_pred(self) -> int:
        for k in range(1, self.size):
            r = (self.rank - k) % self.size
            if not self.state.is_failed(r):
                return r
        return self.rank

    def run(self) -> None:  # pragma: no branch - loop body covered
        observed = self._live_succ()
        while not self._halt.wait(self.period):
            if self._muted is not None and self._muted():
                continue  # a killed rank stops beating but the thread
                # stays parked until stop() so teardown is uniform
            self.transport.emit(self._live_pred())
            live_obs = self._live_succ()
            if live_obs != observed:
                # ring reconfiguration (someone else's notice arrived)
                observed = live_obs
                self.transport.grace(observed)
            if observed == self.rank:
                continue  # last one standing
            age = time.monotonic() - self.transport.last_beat(observed)
            if age > self.timeout:
                self.suspicions.append(observed)
                if self.state.mark_failed(observed, cause="detector"):
                    if self._flood is not None:
                        self._flood(self.state.failed())
                observed = self._live_succ()
                self.transport.grace(observed)

    def stop(self, join_timeout: float = 5.0) -> None:
        self._halt.set()
        if self.is_alive() and threading.current_thread() is not self:
            self.join(join_timeout)


def classify_recv_failure(state: FailureState, source: int, cid: int
                          ) -> errors.MpiError | None:
    """The shared transport-side classification of a receive that cannot
    complete: revoked cid → ``Revoked``; named dead source →
    ``ProcFailed``; wildcard receive with an unacknowledged failure →
    ``ProcFailedPending``.  None means "keep waiting" (a stall is not a
    death).  Only the endpoint's own revocation set applies: the global
    registry is the device-plane Communicator space, whose cids are a
    DIFFERENT numbering from endpoint cids — consulting it here would
    poison unrelated endpoint traffic."""
    if state.is_revoked(cid):
        return errors.Revoked(f"recv on revoked cid={cid}", cid=cid)
    if source != -1:  # named source (ANY_SOURCE is -1)
        if state.is_failed(source):
            return errors.ProcFailed(
                f"rank {source} failed (cause: {state.cause_of(source)})",
                failed_ranks=state.failed(),
            )
        return None
    if cid >= _SHRINK_CID_BASE:
        # the shrunken communicator "contains no failed processes" per
        # the ULFM shrink contract, so a PRE-shrink failure (of a
        # non-member) is exempt, ack or no ack — but a MEMBER that died
        # after the shrink is a real pending failure for this window's
        # wildcard receives
        gen = (cid - _SHRINK_CID_BASE) // _SHRINK_CID_STRIDE
        members = state.shrink_group(gen)
        if members is None:
            # a window this process never registered (it is not a
            # survivor of that shrink): nothing to classify against
            return None
        pending = state.unacked() & members
        if pending:
            return errors.ProcFailedPending(
                f"wildcard receive on shrink window gen={gen} with "
                f"unacknowledged member failures {sorted(pending)}; "
                f"failure_ack() to continue",
                failed_ranks=pending,
            )
        return None
    pending = state.unacked()
    if pending:
        return errors.ProcFailedPending(
            f"wildcard receive with unacknowledged failures "
            f"{sorted(pending)}; failure_ack() to continue",
            failed_ranks=pending,
        )
    return None


# -- fault-tolerant agreement (MPIX_Comm_agree) -------------------------


def _agree_tags(seq: int) -> tuple[int, int]:
    """(gather, result) tag pair unique to one agreement instance.  Tags
    carry the sequence number, NOT the retry round: any contribution for
    agreement `seq` matches its coordinator's gather regardless of how
    many re-elections either side has counted, so view skew between
    participants can never strand a frame on mismatched round tags —
    and a stale frame from an earlier agreement can never match a later
    one's protocol."""
    base = _AGREE_TAG + ((seq & 0xFFFFF) << 1)
    return base, base + 1


class _AgreeDone(Exception):
    """Internal: the agreement completed through the published-result
    channel while this rank was still mid-protocol."""

    def __init__(self, result: Any):
        super().__init__(result)
        self.result = result


def _await_frame(ep, state: FailureState, seq: int, source: int,
                 tag: int, timeout: float):
    """Wait for one protocol frame, adopting the published result if the
    agreement completes through another path first (a survivor that
    already holds the result records it in the registry / announces it
    on the wire — see :func:`_publish`).  ONE posted receive per call,
    never a repost loop: sliced re-receiving would abandon one engine
    post per slice (the engines have no cancel) and the stale posts
    re-inject recursively when a frame finally lands.  An exceptional
    exit leaves at most this one post behind, and the instance-unique
    tags keep it from ever stealing another agreement's frames."""
    deadline = time.monotonic() + timeout
    # poll=True: the protocol owns failure handling (re-election /
    # exclusion below) — classification must raise typed out of test(),
    # never route through the user's errhandler disposition
    req = ep.irecv(source=source, tag=tag, cid=FT_AGREE_CID, poll=True)
    while True:
        flag, value = req.test()  # drives progress on thread ranks
        if flag:
            return value
        done = state.agreement(seq)
        if done is not None:
            raise _AgreeDone(done)
        if state.is_failed(source):
            # final pump: death must not eat a frame already delivered
            flag, value = req.test()
            if flag:
                return value
            raise errors.ProcFailed(
                f"rank {source} failed (cause: {state.cause_of(source)})",
                failed_ranks=state.failed(),
            )
        if time.monotonic() > deadline:
            raise errors.InternalError(
                f"agreement {seq}: no frame from rank {source} "
                f"within {timeout}s"
            )
        time.sleep(0.002)


def _publish(ep, state: FailureState, seq: int, result: Any) -> None:
    """Make a completed agreement's value recoverable: record it in the
    failure state's registry (shared by every thread rank of a universe)
    and, on wire endpoints, announce it into the live peers' registries.
    Survivors that lose the coordinator mid-delivery converge on THIS
    value instead of re-running a round that could compute a different
    one (the uniformity half of the MPIX_Comm_agree contract)."""
    state.record_agreement(seq, result)
    announce = getattr(ep, "_agree_announce", None)
    if announce is not None:
        announce(seq, result)


def _agree_value(ep, value: Any, combine: Callable[[Any, Any], Any],
                 timeout: float | None = None) -> Any:
    """The fault-tolerant agreement protocol over an arbitrary
    contribution type: the lowest live rank coordinates, folding every
    live contribution through `combine`; contributors that die mid-round
    are excluded; a dead coordinator triggers re-election and a retry.
    A coordinator that dies after delivering its result to only SOME
    survivors cannot split the outcome: the delivered ranks publish the
    value and everyone still mid-protocol adopts it.  Values must be
    DSS-packable (bools, ints, nested lists) so the same protocol runs
    over thread and socket endpoints."""
    sp = ztrace.begin(ztrace.AGREE, getattr(ep, "rank", -1)) \
        if ztrace.active else None
    out = _agree_value_body(ep, value, combine, timeout)
    if sp is not None:
        # the recovery timeline's agreement leg, completion only (an
        # abandoned agreement records nothing — the signal)
        sp.end(seq=getattr(ep, "_agree_seq", 0) - 1)
    return out


def _agree_value_body(ep, value: Any,
                      combine: Callable[[Any, Any], Any],
                      timeout: float | None = None) -> Any:
    state = _require_ft(ep)
    if timeout is None:
        timeout = float(mca_var.get("ft_agree_timeout", 30.0))
    # collective-order instance number: every rank's k-th agree is the
    # same instance — the result registry and the tags key off it
    seq = getattr(ep, "_agree_seq", 0)
    ep._agree_seq = seq + 1
    gather_tag, result_tag = _agree_tags(seq)
    round_no = 0
    while True:
        done = state.agreement(seq)
        if done is not None:
            return done
        live = [r for r in range(ep.size) if not state.is_failed(r)]
        coord = live[0]
        try:
            if ep.rank == coord:
                acc = value
                for r in live:
                    if r == ep.rank:
                        continue
                    try:
                        contrib = _await_frame(ep, state, seq, r,
                                               gather_tag, timeout)
                    except errors.ProcFailed:
                        continue  # died mid-agreement: excluded
                    if (isinstance(contrib, (list, tuple))
                            and len(contrib) == 2 and contrib[0] == seq):
                        acc = combine(acc, contrib[1])
                # a survivor may have completed this instance through a
                # PREVIOUS coordinator's partial delivery: that value is
                # the agreement (uniformity), ours is discarded
                done = state.agreement(seq)
                if done is not None:
                    return done
                # publish BEFORE distributing: if we die mid-delivery,
                # the ranks we reached hold (and spread) the result
                _publish(ep, state, seq, acc)
                for r in live:
                    if r == ep.rank or state.is_failed(r):
                        continue
                    try:
                        ep.send((seq, acc), r, tag=result_tag,
                                cid=FT_AGREE_CID, poll=True)
                    except (errors.MpiError, OSError):
                        pass  # result undeliverable to a dying rank
                return acc
            # poll=True on the protocol's own sends: a dead coordinator
            # must surface as typed ProcFailed for the re-election path
            # below, never as the user disposition (FATAL would abort the
            # survivor — breaking the completes-despite-death contract)
            ep.send((seq, value), coord, tag=gather_tag,
                    cid=FT_AGREE_CID, poll=True)
            res = _await_frame(ep, state, seq, coord, result_tag, timeout)
            if not (isinstance(res, (list, tuple)) and len(res) == 2
                    and res[0] == seq):
                raise errors.InternalError(
                    f"agreement {seq}: mismatched result frame {res!r}"
                )
            acc = res[1]
            _publish(ep, state, seq, acc)
            return acc
        except _AgreeDone as d:
            # adopted from the registry/announce channel: re-publish so
            # the value keeps spreading to ranks still mid-protocol
            _publish(ep, state, seq, d.result)
            return d.result
        except errors.ProcFailed:
            # the coordinator died: re-elect and retry (same tags — the
            # instance, not the round, keys the matching)
            round_no += 1
            if round_no > ep.size:
                raise


def _combine_and(a: Any, b: Any) -> bool:
    return bool(a) and bool(b)


def agree(ep, flag: bool = True, timeout: float | None = None) -> bool:
    """Fault-tolerant AND-reduction of `flag` over the live ranks of an
    endpoint — the MPIX_Comm_agree contract (completes despite
    participant death; uniform result under partial delivery)."""
    return bool(_agree_value(ep, bool(flag), _combine_and, timeout))


def _combine_failed_sets(a: Any, b: Any) -> list:
    """Union of two [pairs, epoch] failed-set contributions: merge the
    (rank, cause) pairs and take the max crash epoch.  A ROOT cause
    (device, daemon) outranks the circumstantial ones (transport
    reset, second-hand notice, detector suspicion) — survivors holding
    only the symptom must converge on what actually happened; beyond
    that, first cause seen wins (causes then only disagree on which
    transport noticed first)."""
    merged = {int(r): str(c) for r, c in a[0]}
    for r, c in b[0]:
        r, c = int(r), str(c)
        have = merged.get(r)
        if have is None or (
                have in FailureState.CIRCUMSTANTIAL_CAUSES
                and c not in FailureState.CIRCUMSTANTIAL_CAUSES):
            merged[r] = c
    return [sorted([r, c] for r, c in merged.items()),
            max(int(a[1]), int(b[1]))]


def agree_failed_set(ep, timeout: float | None = None
                     ) -> tuple[dict[int, str], int]:
    """Internal agreement on the failed SET (not just a flag): every
    survivor contributes its locally-known (rank, cause) pairs plus its
    cumulative crash epoch; the agreed value is the union and the max.
    This is the uniform-knowledge step real ULFM runs inside shrink — a
    BYE flood or failure notice still in flight cannot leave survivors
    holding divergent member maps, because the union is what everyone
    adopts.  Returns ``(failed, generation)``: a rank→cause dict and the
    agreed shrink generation."""
    state = _require_ft(ep)
    contribution = [
        [[int(r), str(c)] for r, c in state.failed_with_causes()],
        state.crash_epoch(),
    ]
    pairs, epoch = _agree_value(ep, contribution, _combine_failed_sets,
                                timeout)
    return {int(r): str(c) for r, c in pairs}, int(epoch)


# -- survivor communicator (MPIX_Comm_shrink) ---------------------------


def _shrink_cid(gen: int, cid: int) -> int:
    return _SHRINK_CID_BASE + gen * _SHRINK_CID_STRIDE + (cid & 0xFFFF)


class ShrunkEndpoint(HostCollectives):
    """The shrunken communicator of the host plane: survivors renumbered
    densely (0..m-1), every operation translated onto the parent endpoint
    inside a generation-isolated cid window.  Carries the full
    host-collective surface, so ``shrunk.allreduce(...)`` just works —
    the coll-rides-the-PML layering survives the shrink."""

    def __init__(self, ep, survivors: list[int], generation: int):
        if ep.rank not in survivors:
            raise errors.ProcFailed(
                f"rank {ep.rank} is not a survivor of the shrink",
                failed_ranks=[r for r in range(ep.size)
                              if r not in survivors],
            )
        self._ep = ep
        self._map = list(survivors)          # shrunk rank -> parent rank
        self._inv = {g: i for i, g in enumerate(self._map)}
        self._gen = generation
        self.rank = self._inv[ep.rank]
        self.size = len(self._map)
        self.group = Group(self._map)
        state = getattr(ep, "ft_state", None)
        if state is not None:
            # the survivor set defines this generation's cid window:
            # classification can then tell a pre-shrink failure (of a
            # non-member — exempt per the shrink contract) from a
            # post-shrink death of a member (see classify_recv_failure)
            state.register_shrink(generation, self._map)

    def _xlate_src(self, source: int) -> int:
        if source == -1:  # ANY_SOURCE passes through
            return source
        return self._map[source]

    def boot_token_of(self, rank: int) -> str | None:
        """Locality identity of a SHRUNK rank, translated to the parent
        endpoint — the han topology layer's rebuild contract: a
        post-shrink hierarchical collective derives its groups from the
        survivor set, not the pre-failure membership."""
        fn = getattr(self._ep, "boot_token_of", None)
        if fn is None:
            return None
        return fn(self._map[rank])

    def numa_token_of(self, rank: int):
        """NUMA-domain identity of a SHRUNK rank, translated to the
        parent endpoint — the nested (three-level) twin of
        :meth:`boot_token_of`'s rebuild contract."""
        fn = getattr(self._ep, "numa_token_of", None)
        if fn is None:
            return None
        return fn(self._map[rank])

    def send(self, obj: Any, dest: int, tag: int = 0, cid: int = 0) -> None:
        self._ep.send(obj, self._map[dest], tag, _shrink_cid(self._gen, cid))

    def isend(self, obj: Any, dest: int, tag: int = 0, cid: int = 0):
        return self._ep.isend(obj, self._map[dest], tag,
                              _shrink_cid(self._gen, cid))

    def recv(self, source: int = -1, tag: int = -1, cid: int = 0,
             timeout: float | None = None, return_status: bool = False):
        out = self._ep.recv(self._xlate_src(source), tag,
                            _shrink_cid(self._gen, cid), timeout=timeout,
                            return_status=return_status)
        if return_status:
            value, status = out
            if status.source >= 0:
                status.source = self._inv.get(status.source, -1)
            return value, status
        return out

    def irecv(self, source: int = -1, tag: int = -1, cid: int = 0,
              poll: bool = False):
        return self._ep.irecv(self._xlate_src(source), tag,
                              _shrink_cid(self._gen, cid), poll=poll)

    def sendrecv(self, obj: Any, dest: int, source: int = -1,
                 sendtag: int = 0, recvtag: int = -1, cid: int = 0):
        # isend-then-classified-recv, NOT irecv+wait: a bare Request
        # wait has no failure classification, so a partner dying
        # post-shrink would hang the exchange instead of raising typed
        # ProcFailed (collectives built over sendrecv inherit this).
        # The send request is WAITED after the recv: on the deferred
        # wire engine the frame may still be queued when recv returns,
        # and sendrecv's buffer-reuse contract holds only at send
        # completion (a recv that raises typed leaves the request to
        # the failure machinery — reuse is moot on that path).
        sreq = self.isend(obj, dest, sendtag, cid)
        out = self.recv(source, recvtag, cid)
        sreq.wait()
        return out

    def barrier(self) -> None:
        n, k = self.size, 1
        while k < n:
            self.send(b"", (self.rank + k) % n, tag=0x7FFE, cid=0x7FFE)
            self.recv(source=(self.rank - k) % n, tag=0x7FFE, cid=0x7FFE)
            k <<= 1

    def revoke(self, cid: int) -> None:
        """MPIX_Comm_revoke on THIS window: the cid translates into the
        generation-isolated space before delegating to the parent
        endpoint's revoke (which floods on wire transports) — a
        survivor unblocking peers parked in this window's collectives
        mid-recovery, without poisoning the parent's own channels."""
        self._ep.revoke(_shrink_cid(self._gen, cid))

    def __repr__(self):  # pragma: no cover
        return (f"ShrunkEndpoint(rank={self.rank}/{self.size}, "
                f"parents={self._map}, gen={self._gen})")


def _require_ft(ep) -> FailureState:
    state = getattr(ep, "ft_state", None)
    if state is None:
        raise errors.UnsupportedError(
            "ULFM operations need fault tolerance enabled on the "
            "endpoint (construct with ft=True)"
        )
    return state


class UlfmEndpointAPI:
    """Mixin giving any endpoint with ``ft_state`` the ULFM user surface
    (MPIX_Comm_failure_ack/_get_acked/_agree/_shrink/_revoke)."""

    def failure_ack(self) -> None:
        """MPIX_Comm_failure_ack: acknowledge every known failure;
        wildcard receives stop raising PROC_FAILED_PENDING for them."""
        _require_ft(self).ack()

    def failure_get_acked(self) -> Group:
        """MPIX_Comm_failure_get_acked: the group of acknowledged-failed
        ranks."""
        return Group(sorted(_require_ft(self).acked()))

    def agree(self, flag: bool = True, timeout: float | None = None) -> bool:
        """MPIX_Comm_agree: fault-tolerant flag AND-reduction."""
        return agree(self, flag, timeout)

    def shrink(self, consensus: bool = True) -> ShrunkEndpoint:
        """MPIX_Comm_shrink: a survivor endpoint with dense new ranks.
        Collective over the survivors.  By default an INTERNAL agreement
        on the failed set runs first (:func:`agree_failed_set`, the same
        seq/announce machinery as ``agree``), exactly as real ULFM does
        inside shrink: survivors holding divergent failure knowledge — a
        BYE flood or failure notice still in flight concurrent with a
        crash — converge on one member map and one agreed generation, so
        no two survivors can land in different cid windows.  The merged
        failures are adopted locally (detector-cause entries merge as
        second-hand "notice" so the false-positive gate keeps its
        meaning; goodbyes merge pre-acknowledged).

        ``consensus=False`` restores the caller-holds-uniform-knowledge
        contract (one fewer protocol round): the generation then derives
        from the local CRASH count (orderly departures excluded, so
        finalize skew cannot split the window)."""
        state = _require_ft(self)
        sp = ztrace.begin(ztrace.SHRINK, getattr(self, "rank", -1),
                          consensus=consensus) if ztrace.active else None
        if not consensus:
            shrunk = ShrunkEndpoint(self, state.live(),
                                    generation=state.crash_count())
            if sp is not None:
                sp.end(gen=shrunk._gen, survivors=shrunk.size)
            return shrunk
        failed, generation = agree_failed_set(self)
        for r, cause in failed.items():
            if cause == "goodbye":
                state.mark_departed(r)
            else:
                cause = "notice" if cause == "detector" else cause
                if not state.mark_failed(r, cause=cause) and \
                        cause not in state.CIRCUMSTANTIAL_CAUSES:
                    # the agreed set carries a ROOT cause a local
                    # symptom beat to the punch: adopt it
                    state.refine_cause(r, cause)
        state.raise_epoch(generation)
        survivors = [r for r in range(self.size) if r not in failed]
        shrunk = ShrunkEndpoint(self, survivors, generation=generation)
        if sp is not None:
            sp.end(gen=generation, survivors=len(survivors))
        return shrunk

    def revoke(self, cid: int) -> None:
        """MPIX_Comm_revoke for an endpoint-plane cid: every pending and
        future operation on it raises ``Revoked`` on all live ranks.
        Transports with a wire (TCP) override to flood the notice."""
        _require_ft(self).revoke(cid)
