"""MCA component architecture: frameworks, components, priority selection.

Re-design of the reference's Modular Component Architecture
(``opal/mca/mca.h:1-403``, ``opal/mca/base/mca_base_framework.c``,
``mca_base_components_select.c``): a *framework* is a fixed interface (e.g.
"coll"); a *component* is one implementation (e.g. "nccl");
a *module* is a per-communicator instance returned by the component's query.
The PyTorch port's own copy of ``zhpe_ompi_tpu/mca/component.py``.

Selection semantics match the reference:

- The framework-name MCA variable holds an include list
  (``ZMPI_MCA_coll=nccl``) or an exclude list (``ZMPI_MCA_coll=^nccl``)
  — mixing both is an error, as in ``mca_base_component_find.c``.
- Each component registers ``<fw>_<name>_priority``; among the admitted
  components, higher priority wins.
- Component availability is dynamic: a component's ``available()`` may refuse
  (e.g. the nccl component before ``torch.distributed`` is initialized),
  mirroring ``component_init`` probing hardware.

Python components are the in-tree analog of static components; third-party
packages can register components via :func:`Framework.register` at import
time, the analog of DSO component discovery
(``mca_base_component_repository.c:361-432``).
"""

from __future__ import annotations

import threading
from typing import Any

from ..core import errors
from . import output as mca_output
from . import var as mca_var


class Component:
    """Base class for all MCA components."""

    #: Framework this component belongs to (e.g. "coll").
    framework_name: str = ""
    #: Component name (e.g. "tuned").
    name: str = ""
    #: Default selection priority; overridable via <fw>_<name>_priority.
    default_priority: int = 0
    #: Version triple for introspection (ompi_info analog).
    version: tuple[int, int, int] = (1, 0, 0)

    def __init__(self) -> None:
        self._priority_var = mca_var.register(
            f"{self.framework_name}_{self.name}_priority",
            self.default_priority,
            f"Selection priority of the {self.framework_name}/{self.name} component",
            type=int,
        )

    @property
    def priority(self) -> int:
        return int(mca_var.get(self._priority_var.name, self.default_priority))

    def register_params(self) -> None:
        """Register this component's MCA variables (called at framework open)."""

    def available(self) -> bool:
        """Hardware/environment probe; False removes the component from
        selection (cf. component_init returning NULL)."""
        return True

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{self.framework_name}/{self.name} prio={self.priority}>"


def parse_include_exclude(spec: str | None) -> tuple[set[str] | None, set[str]]:
    """Parse a component-list spec into (includes, excludes).

    ``"a,b"`` → include exactly {a,b}; ``"^a,b"`` → exclude {a,b};
    empty/None → no restriction.  Mixing forms raises, as the reference does.
    """
    if not spec:
        return None, set()
    spec = spec.strip()
    if spec.startswith("^"):
        # tolerate a leading ^ on every item ("^a,^b" means exclude both)
        return None, {
            s.strip().lstrip("^") for s in spec[1:].split(",") if s.strip("^ ")
        }
    items = [s.strip() for s in spec.split(",") if s.strip()]
    for it in items:
        if it.startswith("^"):
            raise errors.ArgError(
                f"component list {spec!r} mixes include and exclude forms"
            )
    return set(items), set()


class Framework:
    """A named framework holding registered components."""

    def __init__(self, name: str, description: str = "") -> None:
        self.name = name
        self.description = description
        self._components: dict[str, Component] = {}
        self._lock = threading.RLock()
        self._opened = False
        self._stream = mca_output.open_stream(name)
        self._select_var = mca_var.register(
            name,
            "",
            f"Comma-separated list of {name} components to include "
            f"(or ^list to exclude)",
            type=str,
        )

    def register(self, component: Component) -> Component:
        with self._lock:
            if component.name in self._components:
                return self._components[component.name]
            self._components[component.name] = component
            mca_output.verbose(
                10, self._stream, "registered component %s", component.name
            )
            return component

    def open(self) -> None:
        with self._lock:
            if self._opened:
                return
            for comp in self._components.values():
                comp.register_params()
            self._opened = True

    def close(self) -> None:
        with self._lock:
            self._opened = False

    def components(self) -> list[Component]:
        with self._lock:
            return list(self._components.values())

    def admitted(self) -> list[Component]:
        """Components admitted by the include/exclude list and available(),
        sorted by descending priority (stable for equal priorities)."""
        spec = mca_var.get(self.name, "")
        includes, excludes = parse_include_exclude(spec)
        out = []
        with self._lock:
            for comp in self._components.values():
                if includes is not None and comp.name not in includes:
                    continue
                if comp.name in excludes:
                    continue
                if not comp.available():
                    mca_output.verbose(
                        5, self._stream, "component %s not available", comp.name
                    )
                    continue
                out.append(comp)
        out.sort(key=lambda c: -c.priority)
        return out

    def select_one(self) -> Component:
        """Select exactly one component (the pml-style exclusive selection,
        ``mca_pml_base_select``)."""
        adm = self.admitted()
        if not adm:
            raise errors.InternalError(
                f"no available component in framework {self.name!r}"
            )
        winner = adm[0]
        mca_output.verbose(1, self._stream, "selected component %s", winner.name)
        return winner


class FrameworkRegistry:
    def __init__(self) -> None:
        self._frameworks: dict[str, Framework] = {}
        self._lock = threading.Lock()

    def framework(self, name: str, description: str = "") -> Framework:
        with self._lock:
            fw = self._frameworks.get(name)
            if fw is None:
                fw = Framework(name, description)
                self._frameworks[name] = fw
            return fw

    def all_frameworks(self) -> list[Framework]:
        with self._lock:
            return sorted(self._frameworks.values(), key=lambda f: f.name)


registry = FrameworkRegistry()
framework = registry.framework


def build_framework(name: str, description: str,
                    component_factories) -> Framework:
    """Memoized framework construction: the first call registers the
    components (built from the zero-arg factories); later calls return the
    populated framework without reconstructing anything.  The caller
    opens it, as the ``<fw>_framework()`` helpers do."""
    fw = registry.framework(name, description)
    if not fw.components():
        for factory in component_factories:
            fw.register(factory())
    return fw


def info() -> list[dict[str, Any]]:
    """Introspection dump (the ompi_info analog): every framework with
    its components' priority, version and availability."""
    out = []
    for fw in registry.all_frameworks():
        out.append(
            {
                "framework": fw.name,
                "description": fw.description,
                "components": [
                    {
                        "name": c.name,
                        "priority": c.priority,
                        "version": ".".join(map(str, c.version)),
                        "available": c.available(),
                    }
                    for c in fw.components()
                ],
            }
        )
    return out
