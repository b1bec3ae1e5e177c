"""PERUSE-style message-queue instrumentation (namesake:
``zhpe_ompi_tpu/runtime/peruse.py``; the port's own copy).

Re-design of ``ompi/peruse/peruse.h:22-35`` (SURVEY.md §5): tools subscribe
callbacks to the lifecycle events of the receive path — request activation,
posted-queue insertion, unexpected-queue traffic, matching — and the
matching engine fires them inline.

Cost discipline: the hot path pays ONE module-attribute boolean check when
no subscriber exists (the reference compiles PERUSE out entirely; Python
can't, so the gate is the cheapest possible).  The ARMED hot path
is lock-free too: the subscriber table is copy-on-write — ``fire()``
reads one immutable dict of tuples and never takes the registry lock,
so N sender threads firing per-message events (armed tracing fires on
every match) are never serialized behind a subscribe/unsubscribe, and
a subscriber that re-enters subscribe()/unsubscribe() from inside its
own callback cannot deadlock.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

# Event names mirror the PERUSE_COMM_* enum (peruse.h).
REQ_ACTIVATE = "req_activate"
REQ_INSERT_IN_POSTED_Q = "req_insert_in_posted_q"
REQ_REMOVE_FROM_POSTED_Q = "req_remove_from_posted_q"
REQ_MATCH_UNEX = "req_match_unex"
REQ_COMPLETE = "req_complete"
MSG_ARRIVED = "msg_arrived"
MSG_INSERT_IN_UNEX_Q = "msg_insert_in_unex_q"
MSG_REMOVE_FROM_UNEX_Q = "msg_remove_from_unex_q"
MSG_MATCH_POSTED_REQ = "msg_match_posted_req"

ALL_EVENTS = (
    REQ_ACTIVATE, REQ_INSERT_IN_POSTED_Q, REQ_REMOVE_FROM_POSTED_Q,
    REQ_MATCH_UNEX, REQ_COMPLETE, MSG_ARRIVED, MSG_INSERT_IN_UNEX_Q,
    MSG_REMOVE_FROM_UNEX_Q, MSG_MATCH_POSTED_REQ,
)

# Copy-on-write subscriber table: an IMMUTABLE dict of tuples, swapped
# wholesale under _lock by subscribe/unsubscribe.  fire() reads it with
# one attribute load — no lock, no copy — so armed per-message events
# never serialize sender threads (the match hot path's contract).
_subscribers: dict[str, tuple[Callable[..., None], ...]] = {}
_lock = threading.Lock()

# Hot-path gate: matching engines check this bare module attribute.
active = False


def subscribe(event: str, fn: Callable[..., None]) -> Callable[..., None]:
    """PERUSE_Event_comm_register analog; returns `fn` as the handle."""
    global active, _subscribers
    if event not in ALL_EVENTS:
        raise ValueError(f"unknown PERUSE event {event!r}")
    with _lock:
        table = dict(_subscribers)
        table[event] = table.get(event, ()) + (fn,)
        _subscribers = table  # one atomic rebind: firing threads see
        active = True         # either the old or the new table, whole
    return fn


def unsubscribe(event: str, fn: Callable[..., None]) -> None:
    global active, _subscribers
    with _lock:
        table = dict(_subscribers)
        subs = table.get(event, ())
        if fn in subs:
            i = subs.index(fn)
            remaining = subs[:i] + subs[i + 1:]
            if remaining:
                table[event] = remaining
            else:
                table.pop(event, None)
        _subscribers = table
        active = any(table.values())


def fire(event: str, **info: Any) -> None:
    """Called by the matching engine under its `active` gate.  Reads
    the copy-on-write table with ONE attribute load — never the lock:
    the armed hot path fires per message and must not serialize sender
    threads behind a registry mutation."""
    for fn in _subscribers.get(event, ()):
        fn(event=event, **info)
