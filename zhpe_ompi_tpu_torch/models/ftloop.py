"""Fault-tolerant training loop — the scenario the FT subsystem exists
for (namesake: ``zhpe_ompi_tpu/models/ftloop.py``; the port's own copy).

Every recovery mechanism of the ft plane — typed classification,
consensus shrink, checkpoint rollback, batched respawn, and the device
liveness probe (``parallel/mesh.py``) — is plumbing; a TRAINING JOB
surviving a fault is the product.  This module
is that product: a driver that runs an application step function under
the armed device-probe guard, checkpoints at quiescent points, and on
ANY typed fault — a transport death, a daemon waitpid event, a wedged
device — runs the full pipeline and resumes at full size:

    fault → failure_ack → consensus shrink → REMESH (the app re-shards
    onto the survivor endpoint) → rollback (checkpoint restore) →
    respawn → await rejoin → REMESH back to full size → resume

The loop contract::

    loop = FtTrainLoop(
        proc, step_fn=step, state=params,
        checkpointer=Checkpointer(dir), ckpt_every=2,
        probe=DeviceLivenessProbe(...),      # optional, opt-in
        wedge=plan.arm_device(rank, state),  # fault injection (tests)
        respawner=lambda victims: recovery.respawn_ranks(
            uni, victims, replacement),      # thread ranks
        remesh_fn=lambda ep, st: ...,
    )
    state, losses = loop.run(steps)

``step_fn(ep, state, step_i) -> (state, loss)`` computes one training
step over the CURRENT endpoint (full size in steady state; the loop
never hands it a shrunken endpoint — remesh_fn owns the survivor-mesh
leg).  A replacement rank constructs the same loop; its first act is
restoring the rolled-back checkpoint (``ZMPI_REJOIN=1`` makes ``run`` do
it, the real-process contract; a thread-plane replacement, which shares
its process's environment with the survivors, calls :meth:`restore`
before ``run``), so it enters step ``k`` holding exactly what the
survivors hold.  ``shardings_fn(ep)`` returns the ``placements`` the
restore hands ``Checkpointer.restore`` (a device such as ``"cuda"`` puts
the restored tensors back on the card).

Device-victim semantics: a :class:`~zhpe_ompi_tpu_torch.core.errors.
DeviceFault` naming THIS rank re-raises out of :meth:`run` — the rank
was classified dead and flooded; it must not impersonate a survivor
(on the real-process plane it never gets here: the wedge parks it
until the respawn kills the declared-dead incarnation).

:func:`make_dp_step` is the data-parallel ``step_fn`` the port's own
drivers use (``chip_smoke.py``'s ft phase, the CPU tests): the
transformer's loss and autograd on this rank's batch, the gradients
flattened into one tensor, one ``allreduce`` SUM over the loop's live
endpoint (on the thread plane a CUDA tensor stays on its device), and an
SGD step with the mean.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch

from .. import ops as zops
from ..core import errors
from ..ft import recovery
from ..mca import output as mca_output
from ..runtime import spc
from . import transformer

_stream = mca_output.open_stream("ftloop")


class FtTrainLoop:
    """See the module docstring for the contract."""

    def __init__(self, proc, *, step_fn: Callable, state: Any,
                 checkpointer, ckpt_every: int = 1, probe=None,
                 prober=None, wedge=None,
                 respawner: Callable | None = None,
                 remesh_fn: Callable | None = None,
                 shardings_fn: Callable | None = None,
                 rejoin_timeout: float = 30.0):
        if getattr(proc, "ft_state", None) is None:
            raise errors.UnsupportedError(
                "FtTrainLoop needs fault tolerance enabled (ft=True)")
        self.proc = proc
        self.step_fn = step_fn
        self.state = state
        self.ckpt = checkpointer
        self.ckpt_every = max(1, int(ckpt_every))
        self.probe = probe
        # the always-on half (parallel/mesh.DeviceProber): armed for
        # run()'s whole extent, quiet inside guarded regions and the
        # recovery leg (region() brackets both), probing the gaps —
        # data loading, checkpoint writes — where a wedge would
        # otherwise wait for the next collective to classify
        self.prober = prober
        self.wedge = wedge
        self.respawner = respawner
        self.remesh_fn = remesh_fn
        # device-plane state: ``shardings_fn(ep) -> shardings pytree``
        # lets the rollback restore MATERIALIZE directly onto the
        # endpoint's mesh (the survivor mesh mid-recovery; each device
        # reads only its extents) instead of staging full arrays on
        # the host.  None = host restore (remesh_fn re-partitions).
        self.shardings_fn = shardings_fn
        self.rejoin_timeout = float(rejoin_timeout)
        self.step_i = 0
        self.losses: list[float] = []
        self.recoveries = 0
        if probe is not None and probe.on_fault is None:
            probe.on_fault = self._on_device_fault
        # the ElasticSession traffic contract: step collectives ride a
        # generation-windowed dense endpoint (``live``), never the raw
        # one — a mid-collective fault then has a REVOCABLE window to
        # unblock stranded survivors through, and every recovery
        # re-shrinks into a provably fresh cid window.  A replacement's
        # constructor shrink pairs with the survivors' post-recovery
        # shrink (both ride the JOIN-adopted agreement counters).
        shrink = getattr(proc, "shrink", None)
        self.live = shrink() if callable(shrink) else proc

    # -- device-fault plumbing ---------------------------------------------

    def _on_device_fault(self, fault: errors.DeviceFault) -> None:
        """DeviceLivenessProbe on_fault hook (watchdog thread): flood
        the typed classification like a transport death, then release
        the injected wedge so an in-process drill's parked collective
        unwinds typed (a REAL wedge has nothing to release — the rank
        stays parked until the respawn kills it)."""
        flood = getattr(self.proc, "flood_device_fault", None)
        if flood is not None:
            flood(fault)
        if self.wedge is not None:
            self.wedge.release(fault)

    # -- the loop ----------------------------------------------------------

    def _guard(self):
        inner = self.probe.guard() if self.probe is not None \
            else contextlib.nullcontext()
        if self.prober is not None:
            # the guarded region silences the background prober (its
            # watchdog owns this window); the guard still arms inside
            return self.prober.region(inner)
        return inner

    def _checkpoint(self) -> None:
        # a collective checkpointer (io/ckptio.py, async_capable)
        # snapshots NOW and streams in the background, re-bound to the
        # current live window first so its gather cids revoke with the
        # mesh; steps keep committing while the previous checkpoint
        # drains (counted as ckpt_async_overlapped in run()).  The
        # serial Checkpointer stays blocking: a background pickle
        # racing a fault's rollback helps nobody
        bind = getattr(self.ckpt, "bind", None)
        if callable(bind):
            bind(self.live)
        self.ckpt.save(
            self.step_i, self.state,
            blocking=not getattr(self.ckpt, "async_capable", False))

    def restore(self, shardings=None) -> int:
        """Adopt the newest checkpoint (replacement ranks call this
        through run(); survivors through the rollback leg)."""
        self.state, step = recovery.rollback(self.ckpt,
                                             shardings=shardings)
        self.step_i = int(step)
        return self.step_i

    def run(self, steps: int) -> tuple[Any, list[float]]:
        """Run to ``steps`` total completed steps, surviving typed
        faults along the way.  Returns ``(state, losses)``."""
        if os.environ.get("ZMPI_REJOIN") == "1" and self.step_i == 0:
            # a replacement enters holding the rolled-back snapshot,
            # re-sharded onto the live window it joined
            self.restore(self.shardings_fn(self.live)
                         if self.shardings_fn is not None else None)
            if self.remesh_fn is not None:
                self.remesh_fn(self.live, self.state)
        if self.step_i == 0 and self.ckpt.latest_step() is None:
            self._checkpoint()  # step-0 snapshot: a fault before the
            # first interval still has a rollback point
        if self.prober is not None:
            self.prober.start()
        try:
            while self.step_i < steps:
                try:
                    with self._guard():
                        if self.wedge is not None:
                            self.wedge.tick()
                        self.state, loss = self.step_fn(
                            self.live, self.state, self.step_i)
                    self.step_i += 1
                    self.losses.append(float(loss))
                    if getattr(self.ckpt, "in_flight", False):
                        # the overlap gate: this step committed while
                        # the previous checkpoint's stream still drains
                        spc.record("ckpt_async_overlapped")
                    if self.step_i % self.ckpt_every == 0 \
                            or self.step_i == steps:
                        self._checkpoint()
                except errors.DeviceFault as e:
                    if self.proc.rank in e.failed_ranks:
                        raise  # THIS rank is the corpse: no survivor
                        # act
                    self._recover()
                except (errors.ProcFailed, errors.ProcFailedPending,
                        errors.Revoked):
                    # Revoked: a FELLOW survivor observed the fault
                    # first and revoked the live window to unblock this
                    # rank's parked collective — same recovery,
                    # different messenger
                    self._recover()
            # drain the last checkpoint's stream (and surface a
            # writer's pending failure) before declaring the run done
            wait = getattr(self.ckpt, "wait", None)
            if callable(wait):
                wait()
            # training done: one barrier before the caller finalizes,
            # so a fast rank's goodbye can never poison a peer still
            # receiving the last step's contributions (finalize skew —
            # the same race a daemon's exit frame closes one layer
            # down)
            barrier = getattr(self.live, "barrier", None)
            if callable(barrier):
                barrier()
        finally:
            if self.prober is not None:
                self.prober.stop()
        return self.state, self.losses

    def _recover(self) -> None:
        """The pipeline, end to end, collectively over the survivors.
        Runs inside a prober region: the background prober must not
        classify fresh faults against a plane mid-remesh."""
        with (self.prober.region() if self.prober is not None
              else contextlib.nullcontext()):
            self._recover_inner()

    def _recover_inner(self) -> None:
        if self.respawner is None:
            raise errors.UnsupportedError(
                "FtTrainLoop: a typed fault arrived with no respawner "
                "configured — pass respawner=recovery.daemon_respawn "
                "(DVM jobs) or a thread-plane respawn loop")
        self.recoveries += 1
        mca_output.verbose(
            1, _stream, "rank %d: typed fault; entering recovery %d",
            self.proc.rank, self.recoveries,
        )
        # unblock FELLOW survivors parked in the live window's
        # collectives (a wedged participant strands every rank whose
        # pending recv names a live-but-stalled peer): revoke the
        # window — they surface Revoked and enter this same recovery
        revoke = getattr(self.live, "revoke", None)
        if callable(revoke):
            try:
                from ..coll import host as coll_host

                revoke(coll_host.COLL_CID)
            except errors.MpiError:
                pass

        def rollback_fn(shrunk):
            # the REMESH leg: restore the rolled-back snapshot —
            # directly onto the SURVIVOR mesh when the app provides
            # shardings (each device reads only its extents) — then
            # let the app re-shard its partitioned state onto the
            # survivor endpoint (optimizer chunks, grad-sync
            # partitions)
            self.restore(self.shardings_fn(shrunk)
                         if self.shardings_fn is not None else None)
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
        # full size again, in a FRESH window (the ElasticSession
        # resize sequence): every member raises the epoch floor once,
        # invalidates the locality topology, and re-shrinks — the
        # replacement's constructor shrink pairs with this one.  The
        # replacements restored the same snapshot, so every rank holds
        # identical state at the rolled-back step.
        state = self.proc.ft_state
        state.raise_epoch(state.crash_epoch() + 1)
        from ..coll import han as han_mod

        han_mod.invalidate(self.proc)
        self.live = self.proc.shrink()
        if self.remesh_fn is not None:
            self.remesh_fn(self.live, self.state)
        # roll the loss history back with the step counter (losses
        # past the checkpoint were un-learned by the rollback)
        del self.losses[self.step_i:]


def make_dp_step(cfg, tokens, targets, lr: float, device=None,
                 wrap: Callable | None = None,
                 timings: dict | None = None) -> Callable:
    """A data-parallel SGD ``step_fn(ep, params, step_i) -> (params,
    loss)`` over this rank's batch (``tokens``/``targets``): loss and
    gradients from ``transformer.loss_fn``, the gradients flattened in
    sorted parameter order into one tensor, one ``ep.allreduce`` SUM,
    and ``p - lr * sum / ep.size`` for each parameter.  Parameters may
    arrive as numpy arrays or tensors on any device (a host restore);
    they are taken to ``device`` (CUDA unless the caller asks for the
    CPU).  ``wrap(ep, step_i)`` returns the endpoint the allreduce runs
    on (the fault-injection seam: ``FaultPlan.arm``).  ``timings``, when
    given, collects per step the seconds of the local part (``"local"``:
    forward, backward, flatten) and of the reduction and update
    (``"allreduce"``), with the device synchronized at each boundary."""
    dev = transformer._device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tokens = torch.as_tensor(tokens, device=dev)
    targets = torch.as_tensor(targets, device=dev)

    def step_fn(ep, params, step_i):
        names = sorted(params)
        leaves = {k: torch.as_tensor(params[k], device=dev).detach()
                  .requires_grad_(True) for k in names}
        if timings is not None:
            sync()
            t0 = time.perf_counter()
        loss = transformer.loss_fn(leaves, tokens, targets, cfg)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        flat = torch.cat([g.reshape(-1) for g in grads])
        if timings is not None:
            sync()
            t1 = time.perf_counter()
        comm = wrap(ep, step_i) if wrap is not None else ep
        total = comm.allreduce(flat, zops.SUM)
        scale = lr / ep.size
        out, off = {}, 0
        with torch.no_grad():
            for k in names:
                p = leaves[k]
                n = p.numel()
                out[k] = p.detach() - scale * total[off:off + n].view_as(p)
                off += n
        loss = float(loss.detach())
        if timings is not None:
            sync()
            t2 = time.perf_counter()
            timings.setdefault("local", []).append(t1 - t0)
            timings.setdefault("allreduce", []).append(t2 - t1)
        return out, loss

    return step_fn
