"""Serving plane — fault-tolerant continuous-batching inference loop
(namesake: ``zhpe_ompi_tpu/models/inferloop.py``; the port's own copy).

:class:`~zhpe_ompi_tpu_torch.models.ftloop.FtTrainLoop`'s inference sibling:
where the training loop drives a fixed number of steps over a static
dataset, this loop serves a CONTINUOUS request stream over the DVM —
requests arrive at any time, batches form at step boundaries
(continuous batching: admit up to ``infer_batch_max`` waiting requests
per step, finished requests leave immediately), and the fleet itself
grows and shrinks under load while serving.

Three planes cooperate:

- **Request plane** — :class:`RequestQueue` + :class:`Ticket`: callers
  ``submit(payload)`` and block on ``ticket.result()``; rank 0 admits
  waiting tickets at each step boundary and broadcasts the batch over
  the live window, so every rank runs the same step collectively.  A
  typed fault mid-step RE-QUEUES the in-flight batch (counted by
  ``infer_requeues``) — a request is served or requeued, never dropped
  silently.
- **Fault plane** — the same typed-fault → revoke → consensus-shrink →
  respawn → survivor-mesh pipeline as the training loop: a rank death
  degrades the fleet, not the service.  Survivors requeue the in-
  flight batch, recover to full size, and the next step serves it.
- **Elastic plane** — the FIRST closed observability→runtime loop in
  this tree: rank 0 publishes queue pressure through the SPC/metrics
  plane (``infer_requests_submitted`` − ``infer_requests_served`` =
  backlog; ``infer_queue_depth_max`` rides as a watermark), an
  operator-side :class:`LoadController` scrapes it through the DVM's
  ``metrics`` RPC, feeds a hysteresis :class:`QueueDepthPolicy`, and
  applies ``DvmClient.resize`` — which the worker-side
  :class:`~zhpe_ompi_tpu_torch.ft.recovery.ElasticSession` the loop wraps
  picks up at the NEXT step boundary (``infer_resizes``).  Hysteresis
  (patience + cooldown) keeps an injected load step from thrashing the
  membership.

The loop contract (worker side)::

    ep = zmpi.host_init()
    ses = recovery.ElasticSession(ep)          # optional: elastic jobs
    loop = FtInferLoop(ep, infer_fn=infer, state=params, elastic=ses)
    loop.queue.submit(req)                     # rank 0, any thread
    act = loop.serve()                         # until stop/retire/halt

``infer_fn(ep, state, batch) -> (state, outputs)`` runs one collective
serving step over the CURRENT live endpoint; ``outputs`` aligns with
``batch`` and rank 0 resolves the tickets.  Rank 0 is the control
plane: ``stop()`` there broadcasts the shutdown, every other rank's
loop exits through the same step-boundary broadcast (a local stop on a
non-zero rank would diverge the collective schedule).

Hygiene: every serving thread registers in a module registry
(:func:`live_worker_threads`) and every live queue exposes its parked
tickets (:func:`parked_tickets`) — the tests' hygiene asserts check
both empty at teardown, so a test that leaks a serving thread or
abandons a submitted request fails the suite.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable

from ..core import errors
from ..ft import recovery
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..runtime import spc

_stream = mca_output.open_stream("inferloop")

# category derivation (tools/mpit.py): the serving plane's vars and
# counters (infer_*) are one family
mca_var.register_family("infer", "infer")

mca_var.register(
    "infer_batch_max", 8,
    "Continuous-batching admission cap: rank 0 admits at most this "
    "many waiting requests per serve step (the step boundary is the "
    "admit/evict point)",
    type=int,
)
mca_var.register(
    "infer_resize_high", 8,
    "Queue-backlog high watermark of the elastic resize policy: a "
    "backlog above this votes GROW (a grow applies after "
    "infer_resize_patience consecutive votes)",
    type=int,
)
mca_var.register(
    "infer_resize_low", 1,
    "Queue-backlog low watermark of the elastic resize policy: a "
    "backlog below this votes SHRINK",
    type=int,
)
mca_var.register(
    "infer_resize_patience", 2,
    "Consecutive same-direction observations before the resize policy "
    "acts — the hysteresis half that keeps a single load spike from "
    "resizing the fleet",
    type=int,
)
mca_var.register(
    "infer_resize_cooldown", 2,
    "Observations ignored after an applied resize — the hysteresis "
    "half that keeps an in-flight membership change from compounding "
    "(grow takes effect only after the spawned ranks join)",
    type=int,
)


# -- hygiene registries (the tests' hygiene view) ------------------------

_live_workers: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
_live_queues: "weakref.WeakSet[RequestQueue]" = weakref.WeakSet()


def live_worker_threads() -> list[str]:
    """Inference serving threads still alive — must be [] once every
    loop's stop()/serve() returned (the rank-0-broadcast shutdown
    contract)."""
    return [t.name for t in list(_live_workers) if t.is_alive()]


def parked_tickets() -> list[str]:
    """Unresolved tickets still parked in live request queues — a
    drained serving plane has served, failed, or evicted every
    submitted request; an entry here is a caller wedged in
    ``result()`` forever."""
    out = []
    for q in list(_live_queues):
        out.extend(q._parked())
    return out


# -- request plane -------------------------------------------------------


class Ticket:
    """One submitted request: the caller's handle.  ``result()`` blocks
    until a serve step resolves it (or a failure/eviction raises).
    Status walks ``queued → in-flight → served`` in the good case; a
    typed fault mid-step walks it back to ``queued`` (requeued, never
    silently dropped)."""

    def __init__(self, payload: Any):
        self.payload = payload
        self.status = "queued"
        self.requeues = 0
        self._event = threading.Event()
        self._value: Any = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> Any:
        if not self._event.wait(timeout):
            raise errors.InternalError(
                f"inference ticket not served within {timeout}s "
                f"(status {self.status})")
        if self._error is not None:
            raise self._error
        return self._value

    # loop-side transitions (rank 0 only)
    def _serve(self, value: Any) -> None:
        self.status = "served"
        self._value = value
        self._event.set()

    def _fail(self, exc: BaseException, status: str = "failed") -> None:
        self.status = status
        self._error = exc
        self._event.set()


class RequestQueue:
    """Thread-safe FIFO between callers and the serving loop.  Callers
    submit from any thread; rank 0's serve step takes a batch at the
    step boundary.  Requeued batches go back to the FRONT in order —
    a fault must not reorder a caller behind later arrivals."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: deque[Ticket] = deque()
        self._inflight: set[Ticket] = set()
        self._closed = False
        _live_queues.add(self)

    def submit(self, payload: Any) -> Ticket:
        t = Ticket(payload)
        with self._lock:
            if self._closed:
                raise errors.UnsupportedError(
                    "request queue is closed (serving loop shut down)")
            self._items.append(t)
        spc.record("infer_requests_submitted")
        return t

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def take(self, max_n: int) -> list[Ticket]:
        """Admit up to ``max_n`` waiting tickets (the step boundary)."""
        out: list[Ticket] = []
        with self._lock:
            while self._items and len(out) < max(0, int(max_n)):
                t = self._items.popleft()
                t.status = "in-flight"
                self._inflight.add(t)
                out.append(t)
        return out

    def served(self, tickets: list[Ticket], values: list[Any]) -> None:
        with self._lock:
            for t in tickets:
                self._inflight.discard(t)
        for t, v in zip(tickets, values):
            t._serve(v)

    def requeue(self, tickets: list[Ticket]) -> None:
        """A typed fault interrupted the step: the batch goes back to
        the queue head, LOUDLY counted — served or requeued, never
        silently dropped."""
        if not tickets:
            return
        with self._lock:
            for t in reversed(tickets):
                self._inflight.discard(t)
                t.status = "queued"
                t.requeues += 1
                self._items.appendleft(t)
        spc.record("infer_requeues", len(tickets))
        mca_output.verbose(
            1, _stream, "requeued %d in-flight request(s) after a "
            "typed fault", len(tickets),
        )

    def abort(self, exc: BaseException | None = None) -> None:
        """Close the queue and fail everything still parked — the
        shutdown path that keeps :func:`parked_tickets` clean when a
        test tears a loop down with requests outstanding."""
        with self._lock:
            self._closed = True
            parked = list(self._items) + list(self._inflight)
            self._items.clear()
            self._inflight.clear()
        for t in parked:
            t._fail(exc or errors.UnsupportedError(
                "serving loop shut down before this request was "
                "served"), status="evicted")

    def _parked(self) -> list[str]:
        with self._lock:
            return [
                f"ticket:{t.status}:{t.payload!r:.40}"
                for t in list(self._items) + list(self._inflight)
                if not t.done()
            ]


# -- elastic policy (the observability→runtime half) ---------------------


class QueueDepthPolicy:
    """Hysteresis resize policy keyed on request-queue backlog.  A
    backlog above ``high`` for ``patience`` consecutive observations
    grows the fleet by ``step``; below ``low`` shrinks it; ``cooldown``
    observations after an applied resize are ignored so an in-flight
    membership change never compounds.  :meth:`decide` degrades
    loudly and never raises: malformed observations vote
    nothing."""

    def __init__(self, *, high: int | None = None, low: int | None = None,
                 patience: int | None = None, cooldown: int | None = None,
                 min_size: int = 1, max_size: int | None = None,
                 step: int = 1):
        def _var(v, name, dflt):
            if v is not None:
                return int(v)
            try:
                return int(mca_var.get(name, dflt))
            except (TypeError, ValueError):
                return dflt
        self.high = _var(high, "infer_resize_high", 8)
        self.low = _var(low, "infer_resize_low", 1)
        self.patience = max(1, _var(patience, "infer_resize_patience", 2))
        self.cooldown = max(0, _var(cooldown, "infer_resize_cooldown", 2))
        self.min_size = max(1, int(min_size))
        self.max_size = None if max_size is None else int(max_size)
        self.step = max(1, int(step))
        self._grow_votes = 0
        self._shrink_votes = 0
        self._cool = 0

    def decide(self, backlog: Any, live: Any) -> int | None:
        """One observation → a target size, or None (hold).  Never
        raises: an unparseable observation resets nothing and votes
        nothing (the scrape retries next tick)."""
        try:
            backlog = int(backlog)
            live = int(live)
        except (TypeError, ValueError):
            mca_output.verbose(
                2, _stream, "resize policy: unparseable observation "
                "(backlog=%r live=%r); holding", backlog, live,
            )
            return None
        if self._cool > 0:
            self._cool -= 1
            self._grow_votes = self._shrink_votes = 0
            return None
        if backlog > self.high:
            self._grow_votes += 1
            self._shrink_votes = 0
        elif backlog < self.low:
            self._shrink_votes += 1
            self._grow_votes = 0
        else:
            self._grow_votes = self._shrink_votes = 0
        cap = self.max_size if self.max_size is not None else live
        if self._grow_votes >= self.patience and live < cap:
            self._grow_votes = self._shrink_votes = 0
            self._cool = self.cooldown
            return min(live + self.step, cap)
        if self._shrink_votes >= self.patience and live > self.min_size:
            self._grow_votes = self._shrink_votes = 0
            self._cool = self.cooldown
            return max(live - self.step, self.min_size)
        return None


class LoadController:
    """Operator-side half of the closed loop: scrape the job's
    published SPC snapshots through the DVM's ``metrics`` RPC, derive
    the backlog gauge from two monotone counters
    (``infer_requests_submitted`` − ``infer_requests_served`` — the
    Prometheus counter-difference idiom; the watermark alone cannot
    observe load FALLING), feed the policy, and apply
    ``DvmClient.resize``.  One :meth:`tick` per control interval."""

    def __init__(self, client, job_id: str,
                 policy: QueueDepthPolicy | None = None,
                 resize_timeout: float = 60.0):
        self.client = client
        self.job_id = str(job_id)
        self.policy = policy if policy is not None else QueueDepthPolicy()
        self.resize_timeout = float(resize_timeout)
        self.applied: list[dict] = []

    def observe(self) -> tuple[int, int] | None:
        """(backlog, live) from the metrics + stat RPCs, or None when
        the job has not published yet (the scrape retries)."""
        try:
            agg = self.client.metrics(self.job_id)["aggregate"]
            jobs = self.client.stat().get("jobs") or {}
            live = int((jobs.get(self.job_id) or {}).get("live") or 0)
        except errors.MpiError as e:
            mca_output.verbose(
                2, _stream, "load controller: scrape failed (%s); "
                "holding", e,
            )
            return None
        if not live:
            return None
        backlog = int(agg.get("infer_requests_submitted", 0)) \
            - int(agg.get("infer_requests_served", 0))
        return backlog, live

    def tick(self) -> dict | None:
        """One control interval: observe → decide → resize.  Returns
        the applied resize event, or None (held)."""
        obs = self.observe()
        if obs is None:
            return None
        backlog, live = obs
        target = self.policy.decide(backlog, live)
        if target is None or target == live:
            return None
        mca_output.verbose(
            1, _stream, "load controller: backlog %d over %d live "
            "rank(s) -> resize to %d", backlog, live, target,
        )
        evt = self.client.resize(self.job_id, target,
                                 timeout=self.resize_timeout)
        self.applied.append(evt)
        return evt


# -- the serving loop ----------------------------------------------------


class FtInferLoop:
    """See the module docstring for the contract."""

    def __init__(self, proc, *, infer_fn: Callable, state: Any,
                 queue: RequestQueue | None = None,
                 batch_max: int | None = None, elastic=None,
                 probe=None, prober=None, wedge=None,
                 respawner: Callable | None = None,
                 remesh_fn: Callable | None = None,
                 rejoin_timeout: float = 30.0, idle_wait: float = 0.02):
        if getattr(proc, "ft_state", None) is None:
            raise errors.UnsupportedError(
                "FtInferLoop needs fault tolerance enabled (ft=True)")
        self.proc = proc
        self.infer_fn = infer_fn
        self.state = state
        self.queue = queue if queue is not None else RequestQueue()
        self.batch_max = int(batch_max) if batch_max is not None \
            else int(mca_var.get("infer_batch_max", 8))
        self.elastic = elastic
        self.probe = probe
        self.prober = prober
        self.wedge = wedge
        self.respawner = respawner
        self.remesh_fn = remesh_fn
        self.rejoin_timeout = float(rejoin_timeout)
        self.idle_wait = float(idle_wait)
        self.served = 0
        self.steps = 0
        self.resizes = 0
        self.recoveries = 0
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if probe is not None and probe.on_fault is None:
            probe.on_fault = self._on_device_fault
        # traffic rides a generation-windowed dense endpoint, exactly
        # the FtTrainLoop/ElasticSession contract: an elastic loop
        # adopts the session's live window (ONE constructor shrink —
        # a second would desync the agreement counters)
        if elastic is not None:
            self.live = elastic.live
        else:
            shrink = getattr(proc, "shrink", None)
            self.live = shrink() if callable(shrink) else proc

    # -- device-fault plumbing (FtTrainLoop's hook, verbatim contract) ---

    def _on_device_fault(self, fault: errors.DeviceFault) -> None:
        flood = getattr(self.proc, "flood_device_fault", None)
        if flood is not None:
            flood(fault)
        if self.wedge is not None:
            self.wedge.release(fault)

    def _guard(self):
        inner = self.probe.guard() if self.probe is not None \
            else contextlib.nullcontext()
        if self.prober is not None:
            return self.prober.region(inner)
        return inner

    # -- one collective serve step ---------------------------------------

    def serve_step(self) -> str:
        """One continuous-batching step, collective over ``live``:
        rank 0 admits a batch (and publishes queue pressure), everyone
        adopts it through the step-boundary broadcast, the collective
        ``infer_fn`` serves it, rank 0 resolves the tickets, and the
        elastic boundary applies any pending resize.  Returns one of
        ``served | idle | stopped | resized | recovered | retire |
        halt``."""
        tickets: list[Ticket] = []
        cmd = "serve"
        if self.live.rank == 0:
            if self._stop.is_set():
                cmd = "stop"
            else:
                spc.record("infer_queue_depth_max", self.queue.depth())
                tickets = self.queue.take(self.batch_max)
        try:
            cmd, batch = self.live.bcast(
                (cmd, [t.payload for t in tickets])
                if self.live.rank == 0 else None, root=0)
            if cmd == "stop":
                return "stopped"
            outputs: list[Any] | None = None
            if batch:
                with self._guard():
                    if self.wedge is not None:
                        self.wedge.tick()
                    self.state, outputs = self.infer_fn(
                        self.live, self.state, batch)
            self.steps += 1
            if self.live.rank == 0 and tickets:
                self.queue.served(tickets, list(outputs or ()))
                self.served += len(tickets)
                spc.record("infer_requests_served", len(tickets))
        except errors.DeviceFault as e:
            if self.proc.rank in e.failed_ranks:
                raise  # THIS rank is the corpse: no survivor act
            self.queue.requeue(tickets)
            self._recover()
            return "recovered"
        except (errors.ProcFailed, errors.ProcFailedPending,
                errors.Revoked):
            self.queue.requeue(tickets)
            self._recover()
            return "recovered"
        if self.elastic is not None:
            act = self.elastic.step()  # the COLLECTIVE resize boundary
            if act in ("retire", "halt"):
                return act
            if act == "resized":
                self.resizes += 1
                spc.record("infer_resizes")
                self.live = self.elastic.live
                if self.remesh_fn is not None:
                    self.remesh_fn(self.live, self.state)
                return "resized"
        return "served" if batch else "idle"

    def serve(self, max_steps: int | None = None) -> str:
        """Serve until rank 0 stops the fleet, a resize retires this
        rank, the job halts, or ``max_steps`` boundaries pass (every
        rank counts the same boundaries — the step is collective).
        Returns the final action."""
        if self.prober is not None:
            self.prober.start()
        act = "idle"
        try:
            while max_steps is None or self.steps < max_steps:
                act = self.serve_step()
                if act in ("stopped", "retire", "halt"):
                    break
                if act == "idle":
                    time.sleep(self.idle_wait)  # uniform: the empty
                    # batch came off the broadcast, so every rank idles
                    # the same boundary
        finally:
            if self.prober is not None:
                self.prober.stop()
        if act in ("stopped", "halt"):
            # shutdown is an EVICT boundary: anything still queued is
            # failed loudly (status "evicted"), never left parked — a
            # waiter unwedges with a typed error, and the hygiene
            # parked-ticket gate stays clean
            self.queue.abort()
        return act

    # -- background serving (the worker-thread surface) ------------------

    def start(self) -> None:
        """Serve on a background thread (registered for the hygiene
        leak gate); ``stop()`` on rank 0 shuts the whole fleet down
        through the step-boundary broadcast."""
        if self._thread is not None and self._thread.is_alive():
            raise errors.UnsupportedError("serving thread already runs")
        self._stop.clear()
        t = threading.Thread(
            target=self._serve_bg,
            name=f"infer-serve-r{getattr(self.proc, 'rank', '?')}",
            daemon=True)
        self._thread = t
        _live_workers.add(t)
        t.start()

    def _serve_bg(self) -> None:
        try:
            self.serve()
        except BaseException as e:  # surfaced to join(), never lost
            self.error = e
            # the serving thread is dead: unwedge every waiter with
            # the same error instead of leaving tickets parked
            self.queue.abort(e)

    def stop(self, timeout: float = 30.0) -> None:
        """Request shutdown and join the serving thread.  Meaningful
        on rank 0 (the control plane broadcasts the stop); other
        ranks' threads exit through the same broadcast — join only."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise errors.InternalError(
                    "inference serving thread failed to stop within "
                    f"{timeout}s")
            self._thread = None
        if self.error is not None:
            raise self.error

    # -- recovery (the FtTrainLoop pipeline, minus checkpoint rollback) --

    def _recover(self) -> None:
        with (self.prober.region() if self.prober is not None
              else contextlib.nullcontext()):
            self._recover_inner()

    def _recover_inner(self) -> None:
        if self.respawner is None:
            raise errors.UnsupportedError(
                "FtInferLoop: a typed fault arrived with no respawner "
                "configured — pass respawner=recovery.daemon_respawn "
                "(DVM jobs) or a thread-plane respawn loop")
        self.recoveries += 1
        mca_output.verbose(
            1, _stream, "rank %d: typed fault; entering recovery %d "
            "(in-flight batch requeued)", self.proc.rank,
            self.recoveries,
        )
        revoke = getattr(self.live, "revoke", None)
        if callable(revoke):
            try:
                from ..coll import host as coll_host

                revoke(coll_host.COLL_CID)
            except errors.MpiError:
                pass

        def rollback_fn(shrunk):
            # the survivor-mesh leg: no checkpoint to roll back (the
            # request plane re-queued the batch); re-broadcast the
            # serving state onto the survivor mesh
            if self.remesh_fn is not None:
                self.remesh_fn(shrunk, self.state)

        shrunk, victims = recovery.respawn_victims(
            self.proc, self.respawner, rollback_fn=rollback_fn,
            timeout=self.rejoin_timeout)
        for v in victims:
            if not recovery.await_rejoin(self.proc, v,
                                         self.rejoin_timeout):
                raise errors.InternalError(
                    f"recovery: rank {v} never rejoined within "
                    f"{self.rejoin_timeout}s")
        state = self.proc.ft_state
        state.raise_epoch(state.crash_epoch() + 1)
        from ..coll import han as han_mod

        han_mod.invalidate(self.proc)
        self.live = self.proc.shrink()
        if self.elastic is not None:
            # keep the session's window in lockstep: its next step()
            # must ride the post-recovery membership
            self.elastic.live = self.live
        if self.remesh_fn is not None:
            self.remesh_fn(self.live, self.state)
