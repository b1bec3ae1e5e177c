"""Checkpoint-integrated restart — the shrink → rollback → respawn
recovery pipeline (namesake: ``zhpe_ompi_tpu/ft/recovery.py``; the port's
own copy).

The ULFM machinery (:mod:`.ulfm`) lets a job *survive* a failure:
detect, revoke, shrink, agree.  But a shrunken job stays shrunken.  This
module is the other half the reference's crs/crcp/vprotocol lineage
exists for: replacing the failed rank and rolling the job back to a
consistent point, so the application finishes at FULL size.

The pipeline (the MPI_Comm_spawn blocking-recovery idiom):

1. **detect** — a crash surfaces as typed ``ProcFailed`` (transport
   classification or the ring heartbeat detector).
2. **agree on the failed set** — :func:`agree_failed_set` (re-exported
   from :mod:`.ulfm`) unions every survivor's (rank, cause) knowledge
   and their crash epochs, so a notice still in flight cannot leave
   survivors holding divergent member maps.
3. **shrink** — ``ep.shrink()`` (set consensus built in) yields the
   dense survivor communicator in an agreed cid-generation window.
4. **rollback** — survivors restore the last quiescent checkpoint
   (:func:`rollback`; quiescence was proven by the crcp bookmarks /
   :func:`~zhpe_ompi_tpu_torch.runtime.checkpoint.quiesce_check`, both
   ft-aware: acked-failed ranks' rows are exempt).
5. **respawn** — grow back to full size: :func:`respawn_rank` puts a
   replacement into the dead rank's old universe slot (thread plane), or
   a ``TcpProc(rejoin_book=...)`` re-modexes the survivors over JOIN
   control frames (wire plane) — fresh endpoint, fresh beat window,
   survivors' collective/agreement counters adopted so post-recovery
   full-size collectives tag identically.
6. **restore** — the replacement loads its state from the snapshot
   (``Checkpointer.restore``, shardings supported) instead of replaying
   pessimistic logs — the checkpoint-integrated restart the ROADMAP
   called out.

Hygiene is observable exactly like the detector's: every respawned-rank
thread registers here (:func:`live_respawn_threads` must be empty after
fixtures clean up) and every checkpoint directory a rollback touched is
scanned for orphaned ``.tmp``/``.old`` partials
(:func:`orphaned_checkpoint_partials`) — test fixtures assert both.

Over real processes, :func:`daemon_respawn` asks the resident runtime
daemon (``runtime/dvm.py``) to exec the replacements, and
:class:`ElasticSession` applies the daemon's elastic resize events that it
reads from the job's PMIx namespace (``runtime/pmix.py``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

from ..core import errors
from ..runtime import flightrec
from ..runtime import spc
from ..runtime import ztrace
from . import ulfm
from .ulfm import agree_failed_set  # noqa: F401  (pipeline step 2)

_lock = threading.Lock()
_RESPAWN_THREADS: list[threading.Thread] = []
_RECOVERY_DIRS: set[str] = set()


# -- hygiene registries (consumed by the conftest session gate) ---------


def _register_thread(t: threading.Thread) -> None:
    with _lock:
        _RESPAWN_THREADS[:] = [x for x in _RESPAWN_THREADS if x.is_alive()]
        _RESPAWN_THREADS.append(t)


def live_respawn_threads() -> list[threading.Thread]:
    """Respawned-rank threads still running — must be [] once recovery
    tests have joined their handles (no replacement may leak)."""
    with _lock:
        _RESPAWN_THREADS[:] = [x for x in _RESPAWN_THREADS if x.is_alive()]
        return list(_RESPAWN_THREADS)


def register_recovery_dir(path: str) -> None:
    """Track a checkpoint directory the recovery pipeline rolled back
    from, so the session gate can assert no ``.tmp``/``.old`` partials
    were orphaned by the recovery tests."""
    with _lock:
        _RECOVERY_DIRS.add(os.path.abspath(path))


def orphaned_checkpoint_partials() -> list[str]:
    """Leftover ``.tmp``/``.old`` entries in every checkpoint directory a
    rollback touched.  A healthy pipeline leaves none: ``restore`` heals
    interrupted republishes and writers clean their own partials."""
    out = []
    with _lock:
        dirs = list(_RECOVERY_DIRS)
    for d in dirs:
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.endswith((".tmp", ".old")):
                out.append(os.path.join(d, name))
    return out


# -- pipeline steps ------------------------------------------------------


def rollback(checkpointer, step: int | None = None, shardings=None):
    """Step 4/6: restore the last (or a named) quiescent checkpoint —
    used identically by survivors rolling back and by the replacement
    restoring its state from the snapshot instead of replaying logs.
    Registers the directory with the hygiene gate.

    This is the ROLLBACK LEG of the recovery pipeline, named on every
    postmortem: the ``ckpt_restore`` flightrec event (restored step +
    restore bytes + integrity rejects ride it, so :func:`mttr_legs`
    reports the leg and a bandwidth) and a ``rollback`` ztrace span
    (the critical-path entry ``tools/ztrace`` merges into the
    per-fault timeline)."""
    register_recovery_dir(checkpointer.directory)
    sp = ztrace.begin(ztrace.ROLLBACK, -1, dir=checkpointer.directory) \
        if ztrace.active else None
    before = spc.snapshot()
    out = checkpointer.restore(step, shardings)
    restored = out[1] if isinstance(out, tuple) else step
    after = spc.snapshot()
    rbytes = after.get("ckpt_restore_bytes", 0) \
        - before.get("ckpt_restore_bytes", 0)
    rejects = after.get("ckpt_integrity_rejects", 0) \
        - before.get("ckpt_integrity_rejects", 0)
    flightrec.record(flightrec.CKPT_RESTORE, step=restored,
                     bytes=rbytes, integrity_rejects=rejects)
    if sp is not None:
        sp.end(step=restored, bytes=rbytes)
    return out


def await_rejoin(ep, rank: int, timeout: float = 30.0) -> bool:
    """Survivor side of step 5: block until `rank`'s failure record is
    cleared — i.e. the replacement took the slot (thread plane) or its
    JOIN re-modex reached this endpoint (wire plane)."""
    state = getattr(ep, "ft_state", None)
    if state is None:
        state = ep  # a bare FailureState is accepted too
    return state.wait_restored(rank, timeout)


class RespawnHandle:
    """A replacement rank's second life: the thread it runs on plus its
    eventual result.  ``result()`` joins and re-raises the replacement's
    failure — a respawn that dies again must not vanish silently."""

    def __init__(self, rank: int | None, context, thread: threading.Thread):
        self.rank = rank
        self.context = context
        self._thread = thread
        self._result: Any = None
        self._exc: BaseException | None = None

    def result(self, timeout: float = 60.0):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise errors.InternalError(
                f"respawned rank {self.rank} did not finish in {timeout}s"
            )
        if self._exc is not None:
            raise self._exc
        return self._result


def spawn_replacement(fn: Callable[[], Any], rank: int | None = None,
                      context=None, name: str | None = None
                      ) -> RespawnHandle:
    """Run a replacement rank's program on a tracked daemon thread (the
    wire-plane entry: the caller's `fn` constructs the rejoining
    ``TcpProc(rejoin_book=...)`` itself and owns its close)."""
    handle = RespawnHandle(rank, context, None)

    def runner():
        try:
            handle._result = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by result()
            handle._exc = e

    t = threading.Thread(
        target=runner, daemon=True,
        name=name or f"respawn-{rank if rank is not None else 'rank'}",
    )
    handle._thread = t
    _register_thread(t)
    t.start()
    return handle


def daemon_respawn(ranks, dvm: str | tuple | None = None,
                   job: str | None = None,
                   timeout: float = 30.0) -> list[int]:
    """Step 5 over REAL OS processes: ask the resident runtime daemon
    (``zprted``, :mod:`zhpe_ompi_tpu_torch.runtime.dvm`) to exec fresh
    replacements for ``ranks``.  ONE RPC carries the whole batch — the
    daemon bumps the job's PMIx generation once, so every replacement
    of this recovery window publishes its fresh card under the same tag
    and FT_JOINs the same name-served job.  Inside a daemon-hosted rank
    the daemon address and job id come from the ``ZMPI_DVM``/``ZMPI_JOB``
    environment the daemon exported at launch; callers outside the job
    (a controller) pass them explicitly.  Returns the replacement pids.
    """
    from ..runtime.dvm import DvmClient

    dvm = dvm if dvm is not None else os.environ.get("ZMPI_DVM")
    job = job if job is not None else os.environ.get("ZMPI_JOB")
    if dvm is None or job is None:
        raise errors.UnsupportedError(
            "daemon_respawn needs a resident daemon: run the job under "
            "zmpirun --dvm (ZMPI_DVM/ZMPI_JOB exported) or pass "
            "dvm=(host, port) and job explicitly"
        )
    batch = sorted(int(r) for r in ranks)
    flightrec.record(flightrec.RESPAWN, ranks=batch, via="daemon")
    sp = ztrace.begin(ztrace.RESPAWN, -1, via="daemon",
                      ranks=batch) if ztrace.active else None
    client = DvmClient(dvm, timeout=timeout)
    try:
        pids = client.respawn(job, batch, timeout=timeout)
        if sp is not None:
            # the recovery timeline's respawn leg: RPC round trip
            # included — usually the longest leg the critical-path
            # report names
            sp.end(n=len(batch))
        return pids
    finally:
        client.close()


class ElasticSession:
    """Worker-side half of the DVM's elastic resize (the
    torchrun-elastic shape): wraps a daemon-hosted ft endpoint whose
    universe is the launch-time ``max_size``, keeps ``live`` — the
    dense shrunken endpoint over the CURRENT membership — and applies
    the ``resize:<seq>`` event stream the daemon publishes into the
    job's namespace.

    The loop contract::

        ep = zmpi.host_init()
        ses = recovery.ElasticSession(ep)
        while True:
            result = ses.live.allreduce(x)       # traffic on `live`
            act = ses.step()                     # COLLECTIVE boundary
            if act in ("retire", "halt"):
                break                            # close + exit 0

    :meth:`step` is collective over ``live``: rank 0 reads the event
    stream and broadcasts, so every member applies each event at the
    SAME loop boundary — two ranks polling the store independently
    could observe a publish at different iterations and deadlock the
    next collective.  Applying a grow waits for the new ranks'
    FT_JOINs (:func:`await_rejoin`); applying a shrink waits for the
    retiring ranks' orderly BYEs; both then raise the crash-epoch
    floor (so the rebuilt window's generation is provably fresh),
    invalidate the han locality topology, and re-shrink.  A grown
    rank constructs its session AFTER host_init — its constructor
    shrink pairs with the survivors' post-grow shrink, and
    ``ZMPI_ELASTIC_SEEN`` makes it skip the event that spawned it.
    """

    def __init__(self, ep, store=None, ns: str | None = None,
                 seen: int | None = None, timeout: float = 30.0):
        if getattr(ep, "ft_state", None) is None:
            raise errors.UnsupportedError(
                "ElasticSession needs fault tolerance enabled (ft=True)")
        self._ep = ep
        self._timeout = timeout
        self._own_client = False
        if store is None:
            uri = os.environ.get("ZMPI_PMIX", "")
            if "/" not in uri:
                raise errors.UnsupportedError(
                    "ElasticSession needs the job's store: run under "
                    "zmpirun --dvm (ZMPI_PMIX exported) or pass "
                    "store= and ns= explicitly")
            from ..runtime.pmix import PmixClient

            addr, env_ns = uri.rsplit("/", 1)
            store = PmixClient(addr, timeout=timeout)
            self._own_client = True
            ns = ns if ns is not None else env_ns
        if ns is None:
            raise errors.ArgError(
                "ElasticSession: pass ns= alongside store=")
        self._store = store
        self._ns = str(ns)
        self._seen = int(os.environ.get("ZMPI_ELASTIC_SEEN", "-1")) \
            if seen is None else int(seen)
        self.live = ep.shrink()

    # -- event stream ------------------------------------------------------

    def event(self) -> dict | None:
        """The next unapplied resize event, or None.  Non-collective —
        rank 0 of the live endpoint calls this inside :meth:`step` and
        broadcasts the answer.  Event seqs are DENSE (the daemon
        increments once per applied event), so only ``resize:<seen+1>``
        is probed — a full ``resize:`` history scan would pay
        O(events) wire bytes per loop iteration, forwarded up the
        whole daemon tree (lookup keys are never leaf-cached)."""
        nxt = self._seen + 1
        try:
            published = self._store.lookup(self._ns, f"resize:{nxt}")
        except errors.MpiError:
            return None  # store unreachable mid-teardown: no event
        for value in published.values():
            try:
                seq = int(value["seq"])
                kind = str(value["kind"])
            except (TypeError, KeyError, ValueError):
                continue  # foreign key shape: not a resize event
            if seq != nxt:
                continue  # prefix over-match (resize:1 vs resize:10)
            return {"seq": seq, "kind": kind,
                    "ranks": [int(r) for r in value.get("ranks")
                              or ()],
                    "live": [int(r) for r in value.get("live") or ()],
                    "generation": int(value.get("generation") or 0)}
        return None

    def step(self) -> str | None:
        """One COLLECTIVE resize boundary: agree on the next event
        (rank 0 reads, everyone adopts), apply it, return what this
        rank should do — None (no event), "resized" (membership
        rebuilt, keep looping on the fresh ``live``), "retire" (this
        rank leaves: close the endpoint and exit 0), or "halt" (the
        whole job winds down)."""
        evt = self.live.bcast(
            self.event() if self.live.rank == 0 else None, root=0)
        if evt is None:
            return None
        return self.apply(evt)

    def apply(self, evt: dict) -> str:
        """Apply one resize event (every live member calls this with
        the SAME event — :meth:`step` guarantees it)."""
        from ..coll import han as han_mod

        self._seen = int(evt["seq"])
        kind = str(evt["kind"])
        ranks = [int(r) for r in evt.get("ranks") or ()]
        if kind == "halt":
            return "halt"
        flightrec.record(flightrec.RESIZE, kind=kind, ranks=ranks,
                         seq=self._seen)
        sp = ztrace.begin(ztrace.RESIZE, self._ep.rank, kind=kind,
                          seq=self._seen) if ztrace.active else None
        state = self._ep.ft_state
        if kind == "shrink":
            if self._ep.rank in ranks:
                # this rank retires: the orderly BYE rides close() —
                # the caller exits 0 and the daemon's accounting takes
                # it as a clean finish, not a failure
                if sp is not None:
                    sp.end(action="retire")
                return "retire"
            for r in ranks:
                # the retiring rank's BYE marks it departed; a crash
                # while retiring still classifies (typed) and the
                # consensus shrink below absorbs it either way
                if not state.wait_failed(r, self._timeout):
                    raise errors.InternalError(
                        f"elastic shrink: retiring rank {r} neither "
                        f"said goodbye nor died within "
                        f"{self._timeout}s")
        elif kind == "grow":
            for r in ranks:
                if r == self._ep.rank:
                    continue
                if not await_rejoin(self._ep, r, self._timeout):
                    raise errors.InternalError(
                        f"elastic grow: rank {r} never FT_JOINed "
                        f"within {self._timeout}s")
        else:
            raise errors.ArgError(
                f"elastic session: unknown resize kind {kind!r}")
        # a FRESH generation for the rebuilt window: every member
        # raises the epoch floor once per event (deterministic), so
        # the consensus shrink below can never reuse a cid window an
        # earlier membership already used
        state.raise_epoch(state.crash_epoch() + 1)
        # membership changed: the next hierarchical collective must
        # re-derive locality from the post-resize cards
        han_mod.invalidate(self._ep)
        self.live = self._ep.shrink()
        if sp is not None:
            sp.end(action="resized", survivors=self.live.size,
                   gen=int(evt.get("generation") or 0))
        return "resized"

    def close(self) -> None:
        if self._own_client:
            self._store.close()


def respawn_victims(ep, respawner: Callable[[list[int]], Any],
                    rollback_fn: Callable[[Any], Any] | None = None,
                    timeout: float = 30.0, max_reentries: int = 4):
    """The batched multi-failure pipeline: ONE failed-set agreement
    (inside ``ep.shrink(consensus=True)``) covers EVERY victim, then
    rollback, then N respawns into the same generation window — instead
    of one victim per pass.  A failure DURING recovery (a survivor
    dying mid-shrink or mid-rollback surfaces as typed
    ``ProcFailed``/``ProcFailedPending`` out of the shrunken
    collectives) re-enters the pipeline at agree: the next pass's
    agreement absorbs the new corpse into the same recovery.

    Every survivor calls this collectively.  ``respawner(victims)`` is
    invoked on the LOWEST survivor only — pass
    ``recovery.daemon_respawn`` for daemon-hosted real processes, or a
    thread-plane loop over :func:`respawn_rank`.  ``rollback_fn(shrunk)``
    (optional) runs the checkpoint rollback over the shrunken survivor
    endpoint before the respawns.  Returns ``(shrunk, victims)``; the
    caller still awaits the rejoins it cares about
    (:func:`await_rejoin`) before full-size traffic.
    """
    state = getattr(ep, "ft_state", None)
    if state is None:
        raise errors.UnsupportedError(
            "respawn_victims needs fault tolerance enabled (ft=True)"
        )
    last: BaseException | None = None
    for _ in range(max_reentries):
        try:
            ep.failure_ack()
            shrunk = ep.shrink()  # consensus: one agree covers the batch
            # crashes are respawned; orderly goodbyes are not failures
            victims = sorted(
                r for r in range(ep.size)
                if r not in shrunk._map
                and state.cause_of(r) != "goodbye"
            )
            if rollback_fn is not None:
                rollback_fn(shrunk)
            # survivor barrier BEFORE regrowth: every survivor must have
            # finished adopting the agreed failed set (and rolling back)
            # before any replacement's record is cleared — a slow
            # survivor's adoption landing after the restore would
            # re-mark the fresh rank failed and strand the recovery
            shrunk.barrier()
            if victims and shrunk.rank == 0:
                respawner(victims)
            return shrunk, victims
        except (errors.ProcFailed, errors.ProcFailedPending) as e:
            # a survivor died mid-recovery: re-enter at agree — the
            # next shrink's failed-set agreement absorbs the new corpse
            last = e
            continue
    raise last  # noqa: B904 - the last re-entry's typed failure


def respawn_ranks(uni, ranks, fn: Callable[[Any], Any],
                  name: str | None = None) -> dict[int, RespawnHandle]:
    """Thread-plane batch respawner: one :func:`respawn_rank` per
    victim, all into the universe's existing slots — the shape
    ``respawn_victims`` wants for its ``respawner`` argument on the
    thread plane."""
    return {
        int(r): respawn_rank(uni, int(r), fn, name=name)
        for r in sorted(int(r) for r in ranks)
    }


def respawn_rank(uni, rank: int, fn: Callable[[Any], Any],
                 name: str | None = None) -> RespawnHandle:
    """Step 5 on the thread plane: put a FRESH context into the dead
    rank's universe slot (``LocalUniverse.respawn_rank`` — new mailbox
    and matching engine, survivors' collective/agreement counters
    adopted, failure record cleared last) and launch ``fn(ctx)`` as the
    replacement's program.  Mirrors ``LocalUniverse.run``'s bookkeeping:
    a replacement that dies again is marked failed; a clean finish is
    not a process failure."""
    flightrec.record(flightrec.RESPAWN, ranks=[int(rank)], via="thread")
    sp = ztrace.begin(ztrace.RESPAWN, -1, via="thread",
                      ranks=[int(rank)]) if ztrace.active else None
    ctx = uni.respawn_rank(rank)
    if sp is not None:
        sp.end()

    def second_life():
        try:
            return fn(ctx)
        except ulfm.RankKilled as e:
            if uni.ft_board is not None:
                uni.ft_board.kill(rank)
            if e.mode != "mute":
                uni.ft_state.mark_failed(rank, cause="killed")
            raise
        except BaseException:
            if uni.ft_board is not None:
                uni.ft_board.kill(rank)
            uni.ft_state.mark_failed(rank, cause="crash")
            raise

    return spawn_replacement(second_life, rank=rank, context=ctx,
                             name=name or f"respawn-uni-{rank}")


# -- MTTR postmortem (the soak harness's per-fault leg extraction) ----------


def mttr_legs(window: list[dict], anchors: tuple[float, int],
              job: str | None = None) -> list[dict]:
    """Per-fault recovery legs out of a flight-recorder window.

    ``window`` is :func:`~zhpe_ompi_tpu_torch.runtime.flightrec.window`
    output (monotonic-ns stamped typed events) and ``anchors`` the
    matching :func:`~zhpe_ompi_tpu_torch.runtime.flightrec.anchors` pair, so
    each leg maps onto the wall clock the soak harness's own stamps
    live on.  For every fault classification event (``daemon_fault`` /
    ``device_fault``, optionally filtered to one ``job``) the walk
    collects the FIRST of each recovery-leg event that follows it for
    the same job — ``respawn`` (the relaunch RPC batch), ``resize``
    split by kind into ``shrink``/``grow``, and ``rollback`` (the
    ``ckpt_restore`` checkpoint-restore leg, with its restore bytes so
    the report can derive a bandwidth) — as milliseconds since the
    classification.  Report-only by design: the legs a 1-CPU container
    measures are ordering truth, not latency truth."""
    anchor_wall, anchor_mono_ns = anchors

    def wall(t_ns: int) -> float:
        return anchor_wall + (int(t_ns) - anchor_mono_ns) / 1e9

    faults: list[dict] = []
    for i, evt in enumerate(window):
        if evt.get("type") not in (flightrec.DAEMON_FAULT,
                                   flightrec.DEVICE_FAULT):
            continue
        if job is not None and evt.get("job") not in (None, job):
            continue
        t0 = int(evt["t_ns"])
        rec = {
            "job": evt.get("job"),
            "cause": evt.get("cause", evt.get("kind", "?")),
            "deaths": evt.get("deaths", evt.get("rank")),
            "t_fault": wall(t0),
            "legs_ms": {},
        }
        for later in window[i + 1:]:
            if job is not None and later.get("job") not in (None, job) \
                    or evt.get("job") is not None \
                    and later.get("job") is not None \
                    and later["job"] != evt["job"]:
                continue
            etype = later.get("type")
            leg = None
            if etype == flightrec.RESPAWN:
                leg = "respawn"
            elif etype == flightrec.RESIZE:
                leg = "shrink" if later.get("kind") == "shrink" \
                    else "grow"
            elif etype == flightrec.CKPT_RESTORE:
                leg = "rollback"
                if "rollback_bytes" not in rec:
                    rec["rollback_bytes"] = int(later.get("bytes", 0))
                    rec["rollback_step"] = later.get("step")
            elif etype in (flightrec.DAEMON_FAULT,
                           flightrec.DEVICE_FAULT):
                break  # next fault: its own record owns what follows
            if leg is not None and leg not in rec["legs_ms"]:
                rec["legs_ms"][leg] = (int(later["t_ns"]) - t0) / 1e6
        faults.append(rec)
    return faults
