"""Flight recorder — a fixed-size ring of typed runtime events (namesake:
``zhpe_ompi_tpu/runtime/flightrec.py``; the port's own copy).

Where SPC counters say *how much* happened, the flight recorder says
*what, in order*: a lock-cheap per-process ring of small typed events
recorded at the runtime's seams.  The event table is the JAX package's;
the seams the port has so far are the send/recv and han seams, the ft
plane's classifications, revocations and recovery legs (``ft/ulfm.py``,
``ft/recovery.py``), the device probe's faults and the daemon's fault
routing and resizes (``runtime/dvm.py``).  On a typed failure a rank's
metrics publisher (``runtime/spc.py``) ships the window to the PMIx store
as ``flightrec:<job>:<rank>``; in process it is read with :func:`window`.

Cost discipline mirrors :mod:`.peruse`: the recorder is ARMED only while
someone holds the refcount — ``arm()``/``disarm()`` flip the module gate
AND the PERUSE match-event subscription together, so a process with no
reader pays exactly one false module-attribute check per seam.  While
armed, a seam pays one slot write under a plain lock.

The ring OVERWRITES: an event that displaces an unread slot counts in the
``flightrec_events_dropped`` SPC counter.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from ..mca import var as mca_var
from . import peruse, spc

mca_var.register(
    "flightrec_capacity", 256,
    "Slots in the per-process flight-recorder ring (the last-N window "
    "published to the store on a typed failure classification); the "
    "ring overwrites, counting displaced events in "
    "flightrec_events_dropped",
    type=int,
)

# event types (the seams that record them)
SEND = "send"              # pt2pt/tcp.py send/isend dispatch
RECV = "recv"              # pt2pt/tcp.py recv post
MATCH = "match"            # matching engines, via the PERUSE events
COLL_ENTER = "coll_enter"  # coll/han.py schedule + phase entry
COLL_EXIT = "coll_exit"    # coll/han.py schedule + phase completion
FT_CLASS = "ft_class"      # ft/ulfm.py FailureState classification
REVOKE = "revoke"          # ft/ulfm.py cid revocation
RESPAWN = "respawn"        # ft/recovery.py respawn pipelines
RESIZE = "resize"          # runtime/dvm.py resize RPC + elastic-session
                           # membership changes (ft/recovery.py)
DAEMON_FAULT = "daemon_fault"  # runtime/dvm.py fault routing (a rank's
                           # waitpid death or a lost daemon subtree)
DEVICE_FAULT = "device_fault"  # parallel/mesh.py device liveness probe:
                           # a missed deadline classified cause="device"
                           # (probe kind + victim rank ride the event)
CKPT_BEGIN = "ckpt_begin"  # io/ckptio.py collective checkpoint write
                           # accepted (snapshot captured, stream begins)
CKPT_COMMIT = "ckpt_commit"  # io/ckptio.py manifest published atomically
                           # (steps between begin/commit = async overlap)
CKPT_RESTORE = "ckpt_restore"  # ft/recovery.py rollback leg: restore
                           # from the newest COMPLETE step (bytes +
                           # step + integrity rejects ride the event)

ALL_EVENTS = (SEND, RECV, MATCH, COLL_ENTER, COLL_EXIT, FT_CLASS,
              REVOKE, RESPAWN, RESIZE, DAEMON_FAULT, DEVICE_FAULT,
              CKPT_BEGIN, CKPT_COMMIT, CKPT_RESTORE)

#: hot-path gate (the peruse cost discipline): seams check this bare
#: module attribute before paying the record() call.  False until a
#: metrics publisher arms the recorder — a ring nobody will ever
#: publish is not worth one event dict per message
active = False


class FlightRecorder:
    """The ring itself: ``capacity`` fixed slots, a monotonically
    increasing sequence, overwrite-with-accounting.  The module-level
    recorder is per-process (thread ranks share it, exactly like the
    SPC registry); tests construct private instances."""

    def __init__(self, capacity: int | None = None):
        cap = int(mca_var.get("flightrec_capacity", 256)) \
            if capacity is None else int(capacity)
        self._cap = max(8, cap)
        self._slots: list[dict | None] = [None] * self._cap
        self._n = 0  # total events ever recorded (next seq)
        self._lock = threading.Lock()
        # merge-safe clock domain (shared with runtime/ztrace.py):
        # events stamp monotonic ns — a wall clock stepping under NTP
        # mid-window would corrupt cross-rank ordering — and the ring
        # carries ONE wall anchor captured back-to-back with its
        # monotonic twin, so consumers map stamps onto the wall clock
        # through a fixed offset
        self.anchor_wall = time.time()
        self.anchor_mono_ns = time.monotonic_ns()

    @property
    def capacity(self) -> int:
        return self._cap

    def anchors(self) -> tuple[float, int]:
        """(anchor_wall, anchor_mono_ns): the ring's clock anchor —
        ``anchor_wall + (t_ns - anchor_mono_ns)/1e9`` is an event's
        wall time."""
        return self.anchor_wall, self.anchor_mono_ns

    def record(self, etype: str, **fields: Any) -> None:
        """One typed event: seq + monotonic-ns stamp + the caller's
        small DSS-packable fields.  Lock-cheap: slot write and index
        bump."""
        evt = {"t_ns": time.monotonic_ns(), "type": etype}
        evt.update(fields)
        with self._lock:
            i = self._n % self._cap
            dropped = self._slots[i] is not None
            evt["seq"] = self._n
            self._slots[i] = evt
            self._n += 1
        if dropped:
            spc.record("flightrec_events_dropped")

    def window(self, n: int | None = None) -> list[dict]:
        """The last ``n`` (default: whole ring) events in record order —
        the postmortem view the publisher ships to the store."""
        with self._lock:
            total = self._n
            have = min(total, self._cap)
            want = have if n is None else min(int(n), have)
            out = []
            for seq in range(total - want, total):
                evt = self._slots[seq % self._cap]
                if evt is not None:
                    out.append(dict(evt))
        return out

    def total(self) -> int:
        """Events ever recorded (seq of the next event)."""
        with self._lock:
            return self._n

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self._cap
            self._n = 0
            # a fresh window gets a fresh anchor: the old pair mapped
            # stamps nobody can see anymore
            self.anchor_wall = time.time()
            self.anchor_mono_ns = time.monotonic_ns()


_recorder = FlightRecorder()


def record(etype: str, **fields: Any) -> None:
    """Record into the process-global ring (no-op while ``active`` is
    False — the seams' one-boolean gate)."""
    if active:
        _recorder.record(etype, **fields)


def window(n: int | None = None) -> list[dict]:
    return _recorder.window(n)


def anchors() -> tuple[float, int]:
    """(anchor_wall, anchor_mono_ns) of the process-global ring."""
    return _recorder.anchors()


def total() -> int:
    return _recorder.total()


def clear() -> None:
    _recorder.clear()


# -- arming (the module gate + PERUSE match events) -------------------------
#
# Refcounted: each metrics publisher arms on start and disarms on
# stop, so both `active` and `peruse.active` return to False once the
# last publisher is gone (the "inactive costs nothing" contract of
# runtime/peruse.py, applied to the whole recorder).

_arm_lock = threading.Lock()
_arm_count = 0


def _on_match(event: str, **info: Any) -> None:
    record(MATCH, src=int(info.get("src", -1)),
           tag=int(info.get("tag", -1)),
           unexpected=event == peruse.REQ_MATCH_UNEX)


def arm() -> None:
    """Arm the recorder (refcounted): the seams' module gate flips on
    and the PERUSE match events are subscribed."""
    global _arm_count, active
    with _arm_lock:
        _arm_count += 1
        if _arm_count == 1:
            active = True
            peruse.subscribe(peruse.MSG_MATCH_POSTED_REQ, _on_match)
            peruse.subscribe(peruse.REQ_MATCH_UNEX, _on_match)


def disarm() -> None:
    global _arm_count, active
    with _arm_lock:
        if _arm_count == 0:
            return
        _arm_count -= 1
        if _arm_count == 0:
            active = False
            peruse.unsubscribe(peruse.MSG_MATCH_POSTED_REQ, _on_match)
            peruse.unsubscribe(peruse.REQ_MATCH_UNEX, _on_match)
