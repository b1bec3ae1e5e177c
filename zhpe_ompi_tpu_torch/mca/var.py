"""MCA variable (config/flag) system.

Re-design of the reference's ``mca_base_var`` machinery
(``opal/mca/base/mca_base_var.c``): every tunable in the framework is a
registered, typed, introspectable variable with layered value sources and
strict precedence

    default < file (~/.zhpe_ompi_tpu/mca-params.conf) < env (ZMPI_MCA_<name>)
            < API/CLI set

matching the reference's precedence chain (``mca_base_var.c:330,423-433``).
The source of the winning value is tracked per variable
(``mca_base_var.c:566-595``).

Variables are named ``<framework>_<component>_<param>`` exactly as in the
reference so that e.g. ``ZMPI_MCA_coll_tuned_allreduce_algorithm=ring``
selects a forced collective algorithm the way
``OMPI_MCA_coll_tuned_allreduce_algorithm=4`` does.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Callable, Iterable

ENV_PREFIX = "ZMPI_MCA_"
PARAM_FILE = os.path.join(os.path.expanduser("~"), ".zhpe_ompi_tpu", "mca-params.conf")
# Override file: wins over everything, like openmpi-mca-params-override.conf
# (mca_base_var.c:457).
OVERRIDE_FILE = os.path.join(
    os.path.expanduser("~"), ".zhpe_ompi_tpu", "mca-params-override.conf"
)


class VarSource(IntEnum):
    """Where a variable's current value came from (precedence order)."""

    DEFAULT = 0
    FILE = 1
    ENV = 2
    API = 3
    OVERRIDE = 4


def _parse_bool(text: str) -> bool:
    t = str(text).strip().lower()
    if t in ("1", "true", "yes", "on", "enabled"):
        return True
    if t in ("0", "false", "no", "off", "disabled"):
        return False
    raise ValueError(f"cannot parse boolean from {text!r}")


@dataclass
class MCAVar:
    """One registered variable."""

    name: str
    default: Any
    description: str = ""
    type: type = str
    enum: tuple | None = None  # allowed values, if restricted
    settable: bool = True  # MPI_T-style write access
    validator: Callable[[Any], bool] | None = None

    _value: Any = field(default=None, repr=False)
    _source: VarSource = VarSource.DEFAULT

    def convert(self, raw: Any) -> Any:
        if raw is None:
            return None
        if self.type is bool:
            return raw if isinstance(raw, bool) else _parse_bool(raw)
        if self.type is int and not isinstance(raw, int):
            return int(str(raw), 0)
        if self.type is float and not isinstance(raw, float):
            return float(raw)
        if self.type is str and not isinstance(raw, str):
            return str(raw)
        return raw

    def validate(self, value: Any) -> Any:
        value = self.convert(value)
        if self.enum is not None and value not in self.enum:
            raise ValueError(
                f"MCA var {self.name}: value {value!r} not in {self.enum!r}"
            )
        if self.validator is not None and not self.validator(value):
            raise ValueError(f"MCA var {self.name}: value {value!r} rejected")
        return value

    @property
    def value(self) -> Any:
        return self._value

    @property
    def source(self) -> VarSource:
        return self._source


class VarRegistry:
    """Process-global registry of MCA variables."""

    def __init__(self) -> None:
        self._vars: dict[str, MCAVar] = {}
        self._lock = threading.RLock()
        self._file_values: dict[str, str] | None = None
        self._override_values: dict[str, str] | None = None
        # API-set values that arrived before the variable was registered
        # (the reference keeps these in the var system's file-value list).
        self._pending_api: dict[str, Any] = {}
        #: bumped by every register, set and unset: a cache of decisions
        #: that read variables is valid while this number is unchanged
        self.generation = 0

    # -- file layer ------------------------------------------------------

    @staticmethod
    def _read_param_file(path: str) -> dict[str, str]:
        values: dict[str, str] = {}
        try:
            with open(path, "r", encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    if "=" not in line:
                        continue
                    key, _, val = line.partition("=")
                    values[key.strip()] = val.strip()
        except OSError:
            pass
        return values

    def _file_layer(self) -> dict[str, str]:
        if self._file_values is None:
            self._file_values = self._read_param_file(PARAM_FILE)
        return self._file_values

    def _override_layer(self) -> dict[str, str]:
        if self._override_values is None:
            self._override_values = self._read_param_file(OVERRIDE_FILE)
        return self._override_values

    def reload_files(self) -> None:
        """Drop the cached file layers (used by tests)."""
        with self._lock:
            self.generation += 1
            self._file_values = None
            self._override_values = None

    # -- registration ----------------------------------------------------

    def register(
        self,
        name: str,
        default: Any,
        description: str = "",
        *,
        type: type | None = None,
        enum: Iterable | None = None,
        settable: bool = True,
        validator: Callable[[Any], bool] | None = None,
    ) -> MCAVar:
        """Register a variable and resolve its value through the layers.

        Re-registration with the same name returns the existing variable
        (the reference permits duplicate registration within a component).
        """
        with self._lock:
            if name in self._vars:
                return self._vars[name]
            if type is None:
                type = default.__class__ if default is not None else str
            var = MCAVar(
                name=name,
                default=default,
                description=description,
                type=type,
                enum=tuple(enum) if enum is not None else None,
                settable=settable,
                validator=validator,
            )
            # Resolve precedence: default < file < env < API < override.
            var._value, var._source = default, VarSource.DEFAULT
            file_val = self._file_layer().get(name)
            if file_val is not None:
                var._value, var._source = var.validate(file_val), VarSource.FILE
            env_val = os.environ.get(ENV_PREFIX + name)
            if env_val is not None:
                var._value, var._source = var.validate(env_val), VarSource.ENV
            if name in self._pending_api:
                var._value = var.validate(self._pending_api.pop(name))
                var._source = VarSource.API
            ovr_val = self._override_layer().get(name)
            if ovr_val is not None:
                var._value, var._source = var.validate(ovr_val), VarSource.OVERRIDE
            self._vars[name] = var
            self.generation += 1
            return var

    # -- access ----------------------------------------------------------

    def get(self, name: str, default: Any = None) -> Any:
        with self._lock:
            var = self._vars.get(name)
            if var is None:
                return default
            return var.value

    def lookup(self, name: str) -> MCAVar | None:
        with self._lock:
            return self._vars.get(name)

    def set(self, name: str, value: Any) -> None:
        """API-layer set (highest precedence below the override file)."""
        with self._lock:
            self.generation += 1
            var = self._vars.get(name)
            if var is None:
                self._pending_api[name] = value
                return
            if not var.settable:
                raise PermissionError(f"MCA var {name} is not settable")
            if var._source == VarSource.OVERRIDE:
                return  # override file wins over API sets
            var._value = var.validate(value)
            var._source = VarSource.API

    def unset(self, name: str) -> None:
        """Drop an API-layer value, re-resolving from lower layers."""
        with self._lock:
            self.generation += 1
            self._pending_api.pop(name, None)
            var = self._vars.get(name)
            if var is None:
                return
            var._value, var._source = var.default, VarSource.DEFAULT
            file_val = self._file_layer().get(name)
            if file_val is not None:
                var._value, var._source = var.validate(file_val), VarSource.FILE
            env_val = os.environ.get(ENV_PREFIX + name)
            if env_val is not None:
                var._value, var._source = var.validate(env_val), VarSource.ENV
            ovr_val = self._override_layer().get(name)
            if ovr_val is not None:
                var._value, var._source = var.validate(ovr_val), VarSource.OVERRIDE

    def all_vars(self) -> list[MCAVar]:
        with self._lock:
            return sorted(self._vars.values(), key=lambda v: v.name)

    def reset(self) -> None:
        """Forget everything (test isolation only)."""
        with self._lock:
            self.generation += 1
            self._vars.clear()
            self._pending_api.clear()
            self._file_values = None
            self._override_values = None


#: The process-global registry, like the reference's single var system.
registry = VarRegistry()

register = registry.register
get = registry.get
lookup = registry.lookup
set_var = registry.set
unset = registry.unset


# -- framework prefix table (category derivation) ---------------------------
#
# Variables are named <framework>_<component>_<param>, but a bare
# first-`_`-segment split cannot tell `coll_han_enable` (framework coll,
# component han) from `collective_thing`.  Subsystems therefore register
# their name prefixes here, next to their var registrations: the category
# of a name is its longest registered prefix's family, with the first
# segment as the unregistered fallback.

_family_lock = threading.Lock()
_families: dict[str, str] = {}


def register_family(prefix: str, family: str | None = None) -> None:
    """Map every name under ``prefix`` (exact, or ``prefix_*``) to
    ``family`` (default: the prefix itself).  Idempotent; last
    registration wins (subsystems re-register on re-import)."""
    with _family_lock:
        _families[str(prefix)] = str(family if family is not None
                                     else prefix)


def family_of(name: str) -> str:
    """Family of a var/counter name: the LONGEST registered prefix
    matching at a ``_`` boundary; unregistered names fall back to their
    first ``_`` segment."""
    name = str(name)
    best: tuple[int, str] | None = None
    with _family_lock:
        for prefix, family in _families.items():
            if name == prefix or name.startswith(prefix + "_"):
                if best is None or len(prefix) > best[0]:
                    best = (len(prefix), family)
    if best is not None:
        return best[1]
    return name.split("_", 1)[0]


def family_table() -> dict[str, str]:
    with _family_lock:
        return dict(_families)
