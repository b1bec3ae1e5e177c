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

Against the namesake: :func:`daemon_respawn` (real processes through the
runtime daemon) raises naming ``runtime/dvm.py``, and
:class:`ElasticSession` (the DVM's elastic resize) raises naming
``runtime/pmix.py``.
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
    """Step 5 over REAL OS processes: the namesake asks the resident
    runtime daemon (``zprted``, ``runtime/dvm.py``) to exec fresh
    replacements for ``ranks``.  The port has no daemon yet: this raises
    ``UnsupportedError`` naming ``runtime/dvm.py``."""
    raise errors.UnsupportedError(
        "daemon_respawn needs the resident runtime daemon "
        "(runtime/dvm.py), which the PyTorch port has not ported yet")


class ElasticSession:
    """Worker-side half of the DVM's elastic resize (namesake:
    ``ElasticSession``): it reads the ``resize:<seq>`` event stream the
    daemon publishes into the job's PMIx namespace.  The port has no
    store yet: constructing one raises ``UnsupportedError`` naming
    ``runtime/pmix.py``."""

    def __init__(self, ep, store=None, ns: str | None = None,
                 seen: int | None = None, timeout: float = 30.0):
        raise errors.UnsupportedError(
            "ElasticSession reads the job's resize events from the PMIx "
            "store (runtime/pmix.py), which the PyTorch port has not "
            "ported yet")


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
