"""Device mesh construction — the wire-up plane (namesake:
``zhpe_ompi_tpu/parallel/mesh.py``).

The reference's runtime wire-up (``ompi_rte_init`` → PMIx modex,
``ompi/runtime/ompi_mpi_init.c:508,667-700``) is, with one process per GPU,
``torch.distributed.init_process_group`` from torchrun's environment
contract (the store address is the modex), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh``: an N-D array of world ranks
with one process group per dimension.  World rank r sits at the row-major
index r of the mesh, the layout ``models/transformer.make_train_step``
documents: ``r = (d * tp + t) * sp + s`` for a ("dp", "tp", "sp") mesh.

The device half of the fault loop lives here too: :func:`probe_device_plane`
(a killable child running a one-rank NCCL all-reduce on this process's
card), the armed guard :class:`DeviceLivenessProbe` around a device
region, and the always-on background :class:`DeviceProber`; both feed a
missed probe into ``ft/ulfm.FailureState`` as a typed ``cause="device"``
fault.
"""

from __future__ import annotations

import contextlib
import os
import threading
import weakref

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..runtime import flightrec, spc, ztrace
from ..utils import deadline as deadline_mod

_stream = mca_output.open_stream("rte")

mca_var.register(
    "rte_distributed_init",
    False,
    "Join a multi-process job at init from torchrun's environment contract "
    "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK): the "
    "PMIx-client analog.  Left unset, init joins when WORLD_SIZE > 1",
    type=bool,
)

# -- device liveness probe (the device_probe_* family) -----------------------
# The probe child's life is mostly ``import torch`` (its report gives the
# seconds by stage; PERF.md has them from ``chip_smoke.py``), and a healthy
# probe has outlived 12 s on a loaded H100 host.  The watchdog counts from
# the child's start, so the defaults leave that start-up several times
# over: a shorter deadline reports a healthy plane as wedged.

mca_var.register(
    "device_probe_enable", False,
    "Arm the device liveness probe around guarded device regions: a "
    "region that outlives device_probe_deadline triggers a killable-"
    "child probe (a one-element NCCL all-reduce, coll/nccl.PROBE_SRC); "
    "a missed probe classifies a typed cause=\"device\" fault into the "
    "job's FailureState.  Off by default — probes cost a subprocess",
    type=bool,
)
mca_var.register(
    "device_probe_timeout", 90.0,
    "Outer kill (seconds) of one device liveness probe child — the "
    "backstop around its internal watchdog deadline",
    type=float,
)
mca_var.register(
    "device_probe_deadline", 60.0,
    "Internal watchdog deadline (seconds) of the probe child, counted "
    "from its start, ``import torch`` included (it os._exits from the "
    "inside at expiry — the structured \"deadline\" outcome)",
    type=float,
)
mca_var.register(
    "device_probe_grace", 2,
    "Probe rounds that may come back \"ok\" while the guarded region "
    "still blocks before the guard stops re-probing (a slow-but-alive "
    "local plane is a peer's fault to classify, never this rank's own)",
    type=int,
)

#: torchrun's environment contract
ENV_CONTRACT = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def distributed_initialize(backend: str = "nccl", **kwargs) -> None:
    """Multi-process wire-up (PMIx_Init analog): ``dist.init_process_group``
    from torchrun's environment contract (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the GPU).  No-op
    if already initialized.  ``backend`` is NCCL, which needs a CUDA
    device (else this raises), unless the caller asks for ``"gloo"``."""
    if dist.is_initialized():
        mca_output.verbose(1, _stream, "torch.distributed already initialized")
        return
    missing = [k for k in ENV_CONTRACT if k not in os.environ]
    if missing:
        # failing loudly beats silently running at the wrong world size
        raise errors.NotInitializedError(
            f"distributed init: {', '.join(missing)} not set — start the job "
            "with torchrun or export RANK, WORLD_SIZE, MASTER_ADDR and "
            "MASTER_PORT")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass backend='gloo' to join on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://", **kwargs)
    mca_output.verbose(1, _stream, "torch.distributed initialized: rank %d of %d",
                       dist.get_rank(), dist.get_world_size())


def world_devices() -> list[torch.device]:
    """This process's device in every rank's slot, in rank order — the proc
    table analog: ``cuda:LOCAL_RANK`` of each rank on NCCL (gathered from
    every rank), the CPU on gloo."""
    if not dist.is_initialized():
        raise errors.NotInitializedError()
    if dist.get_backend() != "nccl":
        return [torch.device("cpu")] * dist.get_world_size()
    mine = torch.cuda.current_device()
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return [torch.device("cuda", i) for i in every]


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def world_mesh(axis_name: str = "world", devices=None) -> DeviceMesh:
    """1-D mesh over every rank: MPI_COMM_WORLD's footprint.  ``devices``
    (a device or device type, as in :func:`make_mesh`) overrides the
    device type the default group's backend implies."""
    return make_mesh({axis_name: dist.get_world_size()}, devices)


def make_mesh(axis_sizes: dict[str, int], devices=None) -> DeviceMesh:
    """N-D mesh, e.g. ``{"dp": 2, "tp": 4}``: the topo-framework analog
    (cartesian topologies, ``ompi/mca/topo``), over ``init_device_mesh``.
    World rank r is the mesh's row-major index r; ``devices`` (a device or
    device type) overrides the type the default group's backend implies
    (cuda on NCCL, else cpu).  Collective over the
    world: every rank calls it, and its groups come from
    ``dist.new_group``.  ``mesh.get_group(name)`` is a dimension's group:
    ``Communicator(mesh.get_group("tp"))`` is this rank's tp
    communicator."""
    if not dist.is_initialized():
        raise errors.NotInitializedError()
    names = tuple(axis_sizes.keys())
    shape = tuple(int(v) for v in axis_sizes.values())
    n = 1
    for v in shape:
        n *= v
    if n != dist.get_world_size():
        raise errors.ArgError(
            f"mesh {dict(axis_sizes)} holds {n} ranks, the world "
            f"{dist.get_world_size()}")
    device_type = _device_type() if devices is None else torch.device(devices).type
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def survivor_mesh(mesh: DeviceMesh, failed, axis: str | None = None
                  ) -> DeviceMesh:
    """The remesh step of the device-plane recovery pipeline: the same mesh
    minus the failed indices along ``axis`` (default: the first axis — the
    data-parallel outer loop).  The result is the survivors' rank layout
    only, without process groups: making them would need every rank of the
    world, dead ones included; the survivors make their communicators with
    ``Communicator.shrink``, and a respawned job calls :func:`make_mesh`
    again for the full-size resume."""
    names = tuple(mesh.mesh_dim_names or ())
    axis = axis or names[0]
    if axis not in names:
        raise errors.ArgError(f"survivor_mesh: axis {axis!r} not in {names}")
    k = names.index(axis)
    drop = {int(r) for r in failed}
    arr = torch.movedim(mesh.mesh, k, 0)
    keep = [i for i in range(arr.shape[0]) if i not in drop]
    if not keep:
        raise errors.ArgError(
            f"survivor_mesh: every index of axis {axis!r} failed")
    sp = ztrace.begin(ztrace.REMESH, -1, axis=axis,
                      dropped=sorted(drop)) if ztrace.active else None
    layout = torch.movedim(arr[keep], 0, k).contiguous()
    out = DeviceMesh(mesh.device_type, layout, mesh_dim_names=names,
                     _init_backend=False)
    if sp is not None:
        sp.end(survivors=len(keep))
    return out


# -- device liveness probe (the fault loop's device half) -------------------


def probe_device_plane(timeout: float | None = None,
                       deadline: float | None = None,
                       env: dict | None = None,
                       rank: int | None = None,
                       device=None) -> tuple[str, str]:
    """One killable-child device liveness probe: a one-element NCCL
    all-reduce on a one-rank group of its own (``coll/nccl.PROBE_SRC``)
    through the shared ``utils/deadline`` idiom, so a wedged CUDA context
    or a wedged collective dies from the inside at the child's internal
    watchdog.

    Returns the structured ``(kind, detail)``: "ok" (detail = the child's
    JSON), "hung", "deadline", "error".  Counts ``device_probe_rounds``
    (and ``device_probe_misses`` on hung/deadline) and records the
    DEVICE_PROBE ztrace span.  ``rank`` scopes the ``ZMPI_DEVICE_WEDGE``
    injection hook to one rank's probes.  The probe runs on this process's
    CUDA device unless ``device="cpu"`` (a gloo all-reduce) is passed; with
    no CUDA device it raises."""
    from ..coll import nccl as coll_nccl

    timeout = float(mca_var.get("device_probe_timeout", 90.0)) \
        if timeout is None else float(timeout)
    deadline = float(mca_var.get("device_probe_deadline", 60.0)) \
        if deadline is None else float(deadline)
    env = dict(os.environ if env is None else env)
    if rank is not None:
        # the child wedges only when the hook names THIS rank (or "all")
        env[coll_nccl.PROBE_RANK_ENV] = str(int(rank))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to probe the CPU plane")
        # the probe child must use this process's card
        env[coll_nccl.PROBE_DEVICE_ENV] = str(
            dev.index if dev.index is not None else torch.cuda.current_device())
    else:
        env[coll_nccl.PROBE_DEVICE_ENV] = "cpu"
    spc.record("device_probe_rounds")
    sp = ztrace.begin(ztrace.DEVICE_PROBE, -1) if ztrace.active else None
    kind, detail = deadline_mod.run_probe(
        coll_nccl.PROBE_SRC, timeout, deadline, env=env)
    if kind in ("hung", "deadline"):
        spc.record("device_probe_misses")
    if sp is not None:
        # the outcome rides as "outcome": "kind" names the span itself
        # (the namesake's sp.end(kind=kind) collides with it and raises
        # TypeError whenever the tracing plane is armed)
        sp.end(outcome=kind)
    return kind, detail


class DeviceLivenessProbe:
    """The armed guard: a deadline around a device-collective region,
    feeding missed probes into the SAME :class:`~zhpe_ompi_tpu_torch.ft
    .ulfm.FailureState` the host-plane detectors feed — the device half
    of the fault loop.

    Usage (the models/ftloop shape)::

        probe = DeviceLivenessProbe(state=proc.ft_state, rank=proc.rank,
                                    on_fault=proc.flood_device_fault)
        ...
        with probe.guard():
            loss = step(params, batch)   # may wedge mid-all-reduce

    A region that outlives ``device_probe_deadline`` triggers one
    killable-child probe from the watchdog thread (the region itself
    cannot be killed — a wedged kernel or collective holds the caller's
    thread):

    - probe MISSED ("hung"/"deadline"): the local device plane is
      wedged — classify a typed ``cause="device"`` fault for THIS rank
      into the FailureState (flooding notices exactly like transport
      deaths do, via ``on_fault``), count ``device_faults``, record the
      DEVICE_FAULT flightrec event.
    - probe OK: the local plane answers — the region is slow, or a
      REMOTE participant wedged (that rank's own guard classifies it;
      its notice unwinds us).  Re-arm, up to ``device_probe_grace``
      ok-rounds, then stop probing and leave the wait to the host
      plane.

    ``probe_fn`` is injectable (tests drill the ladder without paying
    a subprocess per case); the default is :func:`probe_device_plane`
    on ``device`` (this process's CUDA device unless ``device="cpu"``).
    ``deadline`` is the guarded region's deadline and, unless
    ``probe_deadline`` says otherwise, the probe child's internal one,
    as in the namesake; a child's own start-up (``import torch`` and a
    CUDA context, most of 10 s on a card's host) must fit in the
    latter, so a region deadline shorter than that takes a longer
    ``probe_deadline``.  ``guard()`` is a no-op unless
    ``device_probe_enable`` is on or the probe was constructed with
    ``enable=True`` — opt-in, per contract.
    """

    def __init__(self, state=None, rank: int = -1, on_fault=None,
                 probe_fn=None, enable: bool | None = None,
                 timeout: float | None = None,
                 deadline: float | None = None,
                 grace: int | None = None,
                 probe_deadline: float | None = None,
                 device=None):
        self.state = state
        self.rank = int(rank)
        self.on_fault = on_fault
        self.probe_fn = probe_fn  # None = probe_device_plane, rank-scoped
        self.enabled = bool(mca_var.get("device_probe_enable", False)) \
            if enable is None else bool(enable)
        self.timeout = timeout
        self.deadline = float(mca_var.get("device_probe_deadline", 60.0)) \
            if deadline is None else float(deadline)
        self.probe_deadline = self.deadline if probe_deadline is None \
            else float(probe_deadline)
        self.device = device
        self.grace = int(mca_var.get("device_probe_grace", 2)) \
            if grace is None else int(grace)
        self.fault: errors.DeviceFault | None = None

    # -- classification ----------------------------------------------------

    def classify(self, kind: str, detail: str) -> errors.DeviceFault:
        """A missed probe becomes a typed device fault: counted,
        flight-recorded, marked into the FailureState (cause="device" —
        never a detector suspicion, so the zero-false-positive gate
        keeps its meaning), and handed to ``on_fault`` (the wire
        plane's notice flood / the test's wedge release)."""
        fault = errors.DeviceFault(
            f"device plane missed its liveness deadline ({kind}: "
            f"{detail})",
            failed_ranks=[self.rank] if self.rank >= 0 else (),
            kind=kind,
        )
        spc.record("device_faults")
        flightrec.record(flightrec.DEVICE_FAULT, rank=self.rank,
                         kind=kind)
        if ztrace.active:
            ztrace.instant(ztrace.FT_CLASS, self.rank,
                           failed=self.rank, cause="device")
        if self.state is not None and self.rank >= 0:
            self.state.mark_failed(self.rank, cause="device")
        self.fault = fault
        if self.on_fault is not None:
            self.on_fault(fault)
        return fault

    def probe_once(self) -> tuple[str, str]:
        if self.probe_fn is not None:
            return self.probe_fn(timeout=self.timeout,
                                 deadline=self.probe_deadline)
        return probe_device_plane(
            timeout=self.timeout, deadline=self.probe_deadline,
            rank=self.rank if self.rank >= 0 else None,
            device=self.device)

    # -- the armed guard ---------------------------------------------------

    def _expired(self, watchdog) -> None:
        """Watchdog-thread body: the guarded region outlived its
        deadline.  Probe; classify a miss; tolerate up to ``grace``
        ok-rounds before going quiet (re-arming forever would turn a
        long legitimate region into a polling loop)."""
        for _ in range(max(1, self.grace)):
            kind, detail = self.probe_once()
            if watchdog._disarmed.is_set():
                return  # the region finished while we probed: no fault
            if kind in ("hung", "deadline"):
                self.classify(kind, detail)
                return
            # ok/error: the plane answered (an error is a health
            # problem, not a wedge — loud in the probe counters, not a
            # classification); wait out one more deadline
            if watchdog._disarmed.wait(self.deadline):
                return
        mca_output.verbose(
            1, _stream,
            "device probe guard: region still blocked after %d ok "
            "rounds; leaving the wait to the host plane", self.grace,
        )

    def guard(self, deadline: float | None = None):
        """Context manager arming the deadline around one device-
        collective region (one train step).  No-op when disabled."""
        if not self.enabled:
            return contextlib.nullcontext()
        wd_box: list = []
        wd = deadline_mod.Watchdog(
            float(deadline if deadline is not None else self.deadline),
            on_expire=lambda: self._expired(wd_box[0]),
            name=f"device-probe-guard-{self.rank}",
        )
        wd_box.append(wd)
        return wd


# -- the always-on background prober (the fleet-health half) ----------------

mca_var.register(
    "dvm_device_probe_interval_ms", 0,
    "Interval (milliseconds) of the ALWAYS-ON background device "
    "prober (DeviceProber): between guarded regions it runs the same "
    "killable-child liveness probe the guard runs, so a wedge that "
    "lands OUTSIDE a guarded region still classifies (cause=\"device\","
    " the typed DeviceFault path) within one interval plus one probe "
    "timeout instead of at the next collective; 0 (the default) = off",
    type=int,
)

_live_probers: weakref.WeakSet = weakref.WeakSet()


def live_prober_threads() -> list[str]:
    """Background prober threads still RUNNING — must be [] once every
    owner stopped its prober (the conftest session gate; a stopped
    prober's thread finishing one last probe call is not a leak, the
    deadline-watchdog contract)."""
    out = []
    for p in list(_live_probers):
        t = p._thread
        if t is not None and t.is_alive() and not p._stop.is_set():
            out.append(t.name)
    return out


class DeviceProber:
    """Detector-style background device prober — the always-on half of
    the device fault loop.  The :class:`DeviceLivenessProbe` guard only
    watches INSIDE guarded regions (a train step); a device plane that
    wedges between steps — data loading, checkpointing, an idle serving
    process — classifies only at the NEXT collective.  This thread
    probes on ``dvm_device_probe_interval_ms`` whenever no guarded
    region is active (:meth:`region` brackets them), feeding the same
    typed ``DeviceFault``/FailureState path via the probe's
    ``classify``, so an out-of-region wedge classifies in bounded time
    (one interval + one probe timeout).

    Counters: every background round records ``device_probes``; a miss
    records ``device_probe_faults`` (on top of the probe family's own
    ``device_probe_rounds``/``device_probe_misses``).  Hygiene:
    :func:`live_prober_threads` must be [] once owners stop — the
    models/ftloop seam starts the prober at ``run()`` entry and stops
    it on the way out."""

    def __init__(self, probe: DeviceLivenessProbe,
                 interval_ms: int | None = None):
        self.probe = probe
        ms = int(mca_var.get("dvm_device_probe_interval_ms", 0)) \
            if interval_ms is None else int(interval_ms)
        self.interval_s = ms / 1000.0
        self._stop = threading.Event()
        self._busy = 0
        self._busy_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        _live_probers.add(self)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive() \
            and not self._stop.is_set()

    def start(self) -> "DeviceProber":
        """Arm the background thread; a no-op when the interval is 0
        (the opt-in gate) or the prober already runs."""
        if self.interval_s <= 0 or self.running:
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"device-prober-{self.probe.rank}",
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            with self._busy_lock:
                busy = self._busy > 0
            if busy or self.probe.fault is not None:
                # a guarded region owns this window (its watchdog
                # classifies), or a fault already classified and the
                # recovery path owns the plane until it clears
                continue
            kind, detail = self.probe.probe_once()
            spc.record("device_probes")
            if self._stop.is_set():
                return  # outcome after stop is dropped (watchdog rule)
            with self._busy_lock:
                busy = self._busy > 0
            if busy:
                continue  # a region started mid-probe: its guard owns it
            if kind in ("hung", "deadline"):
                spc.record("device_probe_faults")
                self.probe.classify(kind, detail)

    @contextlib.contextmanager
    def region(self, inner=None):
        """Bracket a guarded region (optionally entering ``inner`` —
        the probe's guard — inside the bracket): the background thread
        goes quiet while any region is active, so the two halves never
        double-probe one wedge."""
        with self._busy_lock:
            self._busy += 1
        try:
            if inner is not None:
                with inner:
                    yield
            else:
                yield
        finally:
            with self._busy_lock:
                self._busy -= 1

    def stop(self, join_timeout: float = 1.0) -> None:
        """Stop probing.  The join is a short tidy-up (a thread still
        inside a probe subprocess is bounded by the probe's outer kill
        and its outcome is dropped) — the leak gate counts only
        running probers."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(join_timeout)
