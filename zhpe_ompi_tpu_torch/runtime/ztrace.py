"""ztrace — causal distributed tracing: the span recorder (namesake:
``zhpe_ompi_tpu/runtime/ztrace.py``; the port's own copy).

Where SPC counters say *how much* happened and the flight recorder says
*what, in order* on one rank, ztrace says *why across ranks*: every span
carries a globally-unique id and may be parented to a span on another
rank through a compact trace context, ``(trace_id, parent_sid, seq)``,
that a transport carries beside its payload.

Span model — one dict per span, recorded into a fixed-size ring:

- ``sid``     globally-unique span id (pid ⊕ rank salted + counter)
- ``kind``    one of the documented table below
- ``t0``/``t1`` monotonic-ns stamps in THIS process's clock domain
  (``t0 == t1`` for instant events); the recorder's once-captured
  ``anchor_wall``/``anchor_mono_ns`` pair maps them onto the wall clock
- ``rank``    the recording rank
- ``parent``  parent span id (local causality, or the wire context's)
- ``trace``   trace id (adopted from the wire context when parented
  remotely)
- free-form small fields (``dest``, ``tag``, ``cid``, ...)

Cost discipline mirrors :mod:`.peruse`: the recorder is ARMED refcounted
(``arm()``/``disarm()``) and every seam checks the bare module attribute
``active`` before paying anything; a disarmed process pays one false
boolean per seam.  The seams the port has so far are the device liveness
probe (``DEVICE_PROBE``) and the survivor mesh (``REMESH``) in
``parallel/mesh.py``, ``Communicator.shrink``/``agree``, and the phases of
``models/transformer.make_train_step_optax`` given ``timings=``: one
``PHASE`` span a phase, named ``step.<phase>``, with the phase's device
milliseconds as ``device_ms`` on CUDA (``parallel/hybrid.Laps``).

Spans against a ``torch.profiler`` trace: the recorder's ``anchor_wall``
and the profiler's ``trace_start_ns`` are both Unix time.  A span's
``wall_of(t0)`` (seconds) therefore sits at
``wall_of(t0) * 1e6 - trace_start_ns / 1e3`` microseconds on the trace's
clock, where a profiler event's ``time_range.start`` lies (the kineto
results of a finished profile: ``prof.profiler.kineto_results
.trace_start_ns()``); the step's phases also open profiler ranges named
``zmpi.step.<phase>`` that land there, beside the kernels.
:func:`profiler_recording` is the seams' check for a recording profiler,
and :data:`profiler_range` the range they open.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

from ..mca import var as mca_var
from . import spc

mca_var.register(
    "ztrace_capacity", 4096,
    "Slots in the per-process ztrace span ring (the trace buffer "
    "published to the store as trace:<job>:<rank>); the ring "
    "overwrites, counting displaced spans in trace_spans_dropped",
    type=int,
)

# the tracing counters join the metrics pvar family
mca_var.register_family("trace", "metrics")
mca_var.register_family("ztrace", "metrics")

# -- span kinds (the documented table; zlint ZL010 checks call sites) -------
SEND = "send"          # pt2pt send/isend dispatch (sender side)
RECV = "recv"          # pt2pt recv post→completion (receiver side)
DELIVER = "deliver"    # frame ingest into the matching engine, parented
                       # to the sender's send span via the wire context
MATCH = "match"        # matching-engine match (via the PERUSE events)
RTS = "rts"            # rendezvous announce leg (sender side)
CTS = "cts"            # rendezvous clear-to-send leg (receiver side)
PUSH = "push"          # rendezvous CTS-released bulk push (sender side)
PHASE = "phase"        # coll/han phase enter→exit at any level
COLL = "coll"          # whole-collective schedule (han ops, nbc)
FT_CLASS = "ft_class"  # ft/ulfm.py failure classification (instant)
AGREE = "agree"        # fault-tolerant agreement protocol run
SHRINK = "shrink"      # survivor-endpoint construction (consensus)
RESPAWN = "respawn"    # ft/recovery.py respawn legs
RESIZE = "resize"      # elastic-resize legs: the daemon's RPC span
                       # (generation + delta) and each rank's
                       # membership-rebuild span (ft/recovery.py)
DEVICE_PROBE = "device_probe"  # device liveness probe round
                       # (parallel/mesh.py): begin at spawn, end with
                       # the structured kind; a "hung"/"deadline" end
                       # is the recovery timeline's device-fault root
REMESH = "remesh"      # survivor-mesh rebuild + re-shard legs
                       # (parallel/mesh.py survivor_mesh, zero.reshard)
CKPT = "ckpt"          # io/ckptio.py collective checkpoint write: the
                       # two-phase exchange + fbtl stream as one span
ROLLBACK = "rollback"  # ft/recovery.py checkpoint-restore leg of a
                       # recovery (digest-verified manifest load +
                       # survivor-mesh re-slice) — named on the
                       # critical path by tools/ztrace postmortems

ALL_KINDS = (SEND, RECV, DELIVER, MATCH, RTS, CTS, PUSH, PHASE, COLL,
             FT_CLASS, AGREE, SHRINK, RESPAWN, RESIZE, DEVICE_PROBE,
             REMESH, CKPT, ROLLBACK)

#: hot-path gate (the peruse discipline): seams check this bare module
#: attribute before paying anything — False means no span dicts, no
#: wire context bytes, no clock reads
active = False


def _now_ns() -> int:
    return time.monotonic_ns()


def profiler_recording() -> bool:
    """True while a ``torch.profiler`` profile records in this process:
    the gate of the seams' profiler ranges (one module attribute read, as
    ``active`` is)."""
    return _autograd_profiler._is_profiler_enabled


#: ``profiler_range(name)``: a context manager that shows in a profiler
#: trace as ``torch.profiler.record_function(name)`` does, at a tenth of
#: its host cost (its C++ form; a traced training step opens hundreds)
profiler_range = _RecordFunctionFast


class SpanRecorder:
    """The ring: ``capacity`` fixed slots, overwrite-with-accounting,
    one monotonic clock domain plus a once-captured wall anchor (the
    merge contract).  The module-level recorder is per-process (thread
    ranks share it — span ids stay unique through the shared counter);
    tests construct private instances."""

    def __init__(self, capacity: int | None = None):
        cap = int(mca_var.get("ztrace_capacity", 4096)) \
            if capacity is None else int(capacity)
        self._cap = max(16, cap)
        self._slots: list[dict | None] = [None] * self._cap
        self._n = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        # the clock anchor: wall and monotonic captured back-to-back
        # ONCE, so every span maps onto the wall clock through one
        # fixed offset (an NTP step after this point shifts nothing)
        self.anchor_wall = time.time()
        self.anchor_mono_ns = time.monotonic_ns()
        # per-process salt: span ids must stay unique across the ranks
        # of one merged timeline — real procs differ by pid, thread
        # ranks share this counter, a respawned incarnation is a new pid
        self._salt = (os.getpid() & 0x3FFFFF) << 40
        self.trace_id = (
            (self.anchor_mono_ns ^ (os.getpid() << 16)) & 0x7FFFFFFF
        )

    @property
    def capacity(self) -> int:
        return self._cap

    def new_sid(self, rank: int) -> int:
        return self._salt | ((rank & 0xFF) << 32) | \
            (next(self._ids) & 0xFFFFFFFF)

    def record(self, kind: str, rank: int, t0_ns: int, t1_ns: int,
               parent: int | None = None, trace: int | None = None,
               sid: int | None = None, **fields: Any) -> int:
        """One span into the ring; returns its sid.  Lock-cheap: slot
        write and index bump (counters recorded outside the lock)."""
        if sid is None:
            sid = self.new_sid(rank)
        span = {"sid": sid, "kind": kind, "rank": int(rank),
                "t0": int(t0_ns), "t1": int(t1_ns),
                "trace": int(trace if trace is not None
                             else self.trace_id)}
        if parent is not None:
            span["parent"] = int(parent)
        span.update(fields)
        with self._lock:
            i = self._n % self._cap
            dropped = self._slots[i] is not None
            self._slots[i] = span
            self._n += 1
        spc.record("trace_spans_recorded")
        if dropped:
            spc.record("trace_spans_dropped")
        return sid

    def window(self, n: int | None = None) -> list[dict]:
        """The last ``n`` (default: whole ring) spans in record order —
        the buffer the publisher ships to the store."""
        with self._lock:
            total = self._n
            have = min(total, self._cap)
            want = have if n is None else min(int(n), have)
            out = []
            for seq in range(total - want, total):
                span = self._slots[seq % self._cap]
                if span is not None:
                    out.append(dict(span))
        return out

    def total(self) -> int:
        with self._lock:
            return self._n

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self._cap
            self._n = 0

    def payload(self, rank: int) -> dict:
        """The per-rank trace publication (``trace:<job>:<rank>``):
        spans plus the clock anchor the merge needs, and the ring's
        displaced-span count — a consumer pairing collectives across
        ranks by occurrence must know the buffer is truncated."""
        with self._lock:
            dropped = max(0, self._n - self._cap)
        return {
            "rank": int(rank),
            "trace_id": self.trace_id,
            "anchor_wall": self.anchor_wall,
            "anchor_mono_ns": self.anchor_mono_ns,
            "dropped": dropped,
            "spans": self.window(),
        }

    def wall_of(self, t_ns: int) -> float:
        """Map a monotonic-ns stamp onto this recorder's wall-anchored
        trace clock (seconds) — the per-rank clock ``tools/mpisync``
        measures offsets between."""
        return self.anchor_wall + (t_ns - self.anchor_mono_ns) / 1e9


_recorder = SpanRecorder()


def recorder() -> SpanRecorder:
    return _recorder


def trace_clock() -> float:
    """This process's trace-clock "now" (wall-anchored monotonic) —
    the clock hook a TcpProc-plane ``sync_clocks`` run measures."""
    return _recorder.wall_of(time.monotonic_ns())


# -- recording surface (gated on `active`) ----------------------------------


def record_span(kind: str, rank: int, t0_ns: int, t1_ns: int,
                parent: int | None = None, trace: int | None = None,
                **fields: Any) -> int | None:
    """A completed span into the process-global ring; no-op (None)
    while disarmed."""
    if not active:
        return None
    return _recorder.record(kind, rank, t0_ns, t1_ns, parent=parent,
                            trace=trace, **fields)


def instant(kind: str, rank: int, parent: int | None = None,
            trace: int | None = None, **fields: Any) -> int | None:
    """A zero-duration span stamped now."""
    if not active:
        return None
    now = _now_ns()
    return _recorder.record(kind, rank, now, now, parent=parent,
                            trace=trace, **fields)


class _Live:
    """An open span handle: ``begin()`` captured t0 and pre-allocated
    the sid (so children/wire contexts can reference it before the
    span closes); ``end()`` records.  A handle whose ``end`` never
    runs records nothing — the missing span IS the postmortem signal
    (the flightrec exit-only-on-success discipline)."""

    __slots__ = ("sid", "kind", "rank", "t0", "parent", "fields")

    def __init__(self, kind: str, rank: int,
                 parent: int | None, fields: dict):
        self.sid = _recorder.new_sid(rank)
        self.kind = kind
        self.rank = rank
        self.t0 = _now_ns()
        self.parent = parent
        self.fields = fields

    def end(self, **fields: Any) -> int | None:
        if not active:
            return None
        f = dict(self.fields)
        f.update(fields)
        return _recorder.record(self.kind, self.rank, self.t0,
                                _now_ns(), parent=self.parent,
                                sid=self.sid, **f)


class _Null:
    """Disarmed twin of :class:`_Live`: one shared instance, sid None,
    no-op end — callers hold whichever ``begin`` returned without
    re-checking the gate."""

    __slots__ = ()
    sid = None
    t0 = 0

    def end(self, **fields: Any) -> None:
        return None


_NULL = _Null()


def begin(kind: str, rank: int, parent: int | None = None,
          **fields: Any):
    """Open a span (captures t0 + sid); ``.end()`` records it.  Returns
    the shared null handle while disarmed."""
    if not active:
        return _NULL
    return _Live(kind, rank, parent, fields)


class _PhaseCtx:
    """``with ztrace.phase_span(...)`` — records the PHASE span on
    clean exit only (an aborted phase's missing span is the signal)."""

    __slots__ = ("_live",)

    def __init__(self, live):
        self._live = live

    def __enter__(self):
        return self._live

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._live.end()
        return False


_NULL_PHASE = _PhaseCtx(_NULL)


def phase_span(name: str, rank: int, **fields: Any):
    """Context manager for a coll/han phase at any level
    (intra-domain / dleader / inter-host): a PHASE span spanning the
    block, named by ``name``.  Disarmed returns one shared null
    context — the collective hot path allocates nothing (the
    one-false-boolean-per-seam discipline)."""
    if not active:
        return _NULL_PHASE
    return _PhaseCtx(begin(PHASE, rank, name=name, **fields))


# -- wire context ------------------------------------------------------------


def wire_context(sid: "int | None", seq: int
                 ) -> "tuple[int, int, int] | None":
    """The compact ``(trace_id, parent_sid, seq)`` triple carried as
    the optional sixth DSS frame-header value while tracing is armed.
    ``sid`` None (a ``begin()`` that lost the race against a concurrent
    disarm returned the null handle) yields None — the send proceeds
    untraced instead of crashing on the teardown edge.  Callers
    account the header growth in ``trace_wire_context_bytes`` at the
    pack site (the bytes are frame-encoding-dependent)."""
    if sid is None:
        return None
    return (_recorder.trace_id, int(sid), int(seq))


def parse_wire_context(value: Any) -> tuple[int, int, int] | None:
    """Validate a received sixth frame value as a trace context —
    a malformed foreign triple degrades to None, never raises out of
    a drain loop."""
    if (isinstance(value, tuple) and len(value) == 3
            and all(isinstance(v, int) for v in value)):
        return value
    return None


# -- convenience views -------------------------------------------------------


def window(n: int | None = None) -> list[dict]:
    return _recorder.window(n)


def total() -> int:
    return _recorder.total()


def clear() -> None:
    _recorder.clear()


def payload(rank: int) -> dict:
    return _recorder.payload(rank)


# -- arming (refcounted; the peruse/flightrec gate discipline) ---------------

_arm_lock = threading.Lock()
_arm_count = 0
_match_count = 0


def _on_match(event: str, **info: Any) -> None:
    from . import peruse

    instant(MATCH, -1, src=int(info.get("src", -1)),
            tag=int(info.get("tag", -1)),
            cid=int(info.get("cid", -1)),
            unexpected=event == peruse.REQ_MATCH_UNEX)


def arm(match_events: bool = False) -> None:
    """Arm the recorder (refcounted).  ``match_events=True``
    additionally subscribes MATCH spans through PERUSE — the
    send→match→deliver middle edge; kept opt-in because match spans
    carry no rank attribution on shared-engine planes.  The match
    subscription carries its OWN refcount: a publisher asking for
    match events while some plain armer already holds the recorder
    still gets its subscription (pass ``match_events=True`` to the
    paired :func:`disarm`)."""
    global _arm_count, _match_count, active
    from . import peruse

    with _arm_lock:
        _arm_count += 1
        if _arm_count == 1:
            active = True
        if match_events:
            _match_count += 1
            if _match_count == 1:
                peruse.subscribe(peruse.MSG_MATCH_POSTED_REQ, _on_match)
                peruse.subscribe(peruse.REQ_MATCH_UNEX, _on_match)


def disarm(match_events: bool = False) -> None:
    global _arm_count, _match_count, active
    from . import peruse

    with _arm_lock:
        if _arm_count == 0:
            return
        _arm_count -= 1
        if match_events and _match_count:
            _match_count -= 1
            if _match_count == 0:
                peruse.unsubscribe(peruse.MSG_MATCH_POSTED_REQ, _on_match)
                peruse.unsubscribe(peruse.REQ_MATCH_UNEX, _on_match)
        if _arm_count == 0:
            active = False
            if _match_count:  # mismatched pairing must not leak PERUSE subs
                peruse.unsubscribe(peruse.MSG_MATCH_POSTED_REQ, _on_match)
                peruse.unsubscribe(peruse.REQ_MATCH_UNEX, _on_match)
                _match_count = 0


def armed_count() -> int:
    """Live arm refcount — a test's teardown asserts this is
    zero (and ``active`` False) once every test released its tracer."""
    with _arm_lock:
        return _arm_count
