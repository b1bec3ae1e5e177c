"""Hook framework — init/finalize interposition (namesake:
``zhpe_ompi_tpu/hook/__init__.py``).

Re-design of ``ompi/mca/hook``: components get called at fixed points in
the runtime lifecycle.  The shipped component mirrors ``hook/comm_method``
(``ompi/mca/hook/comm_method/hook_comm_method.h:21-26``), which prints the
transport selected for each peer at init.  Where the JAX package prints
the mesh shape, the port prints the world's layout — its ranks, this
process's rank, the device type and the process group's backend — and
which coll component won each operation.

Enable with ``ZMPI_MCA_hook_comm_method_enable=1`` (the reference's
``--mca hook_comm_method_enable_mpi_init`` analog).
"""

from __future__ import annotations

from ..mca import component as mca_component
from ..mca import output as mca_output
from ..mca import var as mca_var

_stream = mca_output.open_stream("hook")


class HookComponent(mca_component.Component):
    framework_name = "hook"

    def at_init_bottom(self, world) -> None:
        """Called at the end of init(), world communicator constructed."""

    def at_finalize_top(self) -> None:
        """Called at the start of finalize()."""


class CommMethodHook(HookComponent):
    """Prints the world's layout and the per-operation coll selection — the
    comm_method transport matrix for one process per GPU."""

    name = "comm_method"
    default_priority = 10

    def register_params(self) -> None:
        mca_var.registry.register(
            "hook_comm_method_enable", False, type=bool,
            description="print the world's layout and per-op coll "
                        "component selection at init",
        )
        mca_var.registry.register(
            "hook_comm_method_max", 12, type=int,
            description="max coll table rows to print",
        )

    def at_init_bottom(self, world) -> None:
        if not mca_var.get("hook_comm_method_enable", False):
            return
        lines = [
            f"comm_method: world of {world.size} rank(s) "
            f"{list(world.group.ranks)} on {world.device.type} device(s), "
            f"backend {world.backend}, this rank {world.rank}",
            f"comm_method: {world.name} coll selection:",
        ]
        limit = int(mca_var.get("hook_comm_method_max", 12))
        for opname, (fn, comp) in list(world.coll.items())[:limit]:
            lines.append(f"comm_method:   {opname:<16} -> {comp}")
        for line in lines:
            mca_output.emit(_stream, line)

    def at_finalize_top(self) -> None:
        if not mca_var.get("hook_comm_method_enable", False):
            return
        from ..runtime import spc

        snap = spc.snapshot()
        if snap:
            mca_output.emit(
                _stream,
                "comm_method: SPC at finalize: "
                + ", ".join(f"{k}={v}" for k, v in sorted(snap.items())),
            )


def hook_framework() -> mca_component.Framework:
    fw = mca_component.framework("hook", "init/finalize interposition")
    fw.register(CommMethodHook())
    fw.open()
    return fw


def run_init_hooks(world) -> None:
    for comp in hook_framework().admitted():
        comp.at_init_bottom(world)


def run_finalize_hooks() -> None:
    for comp in hook_framework().admitted():
        comp.at_finalize_top()
