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

Not ported yet: ``DeviceLivenessProbe`` and ``DeviceProber``, which feed
``ft/ulfm.FailureState``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..runtime import spc, ztrace
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
        sp.end(kind=kind)
    return kind, detail
