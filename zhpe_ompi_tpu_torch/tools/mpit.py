"""MPI_T tool interface analog — cvar/pvar/category introspection
(namesake: ``zhpe_ompi_tpu/tools/mpit.py``).

Re-design of ``ompi/mpi/tool`` (SURVEY.md §5): the MPI_T surface is a typed
window onto (a) the MCA var system (control variables) and (b) the runtime
counter plane (performance variables).  The reference's handle/session
machinery is kept because it carries real semantics:

- **cvar handles** read and (scope permitting) write an MCA var through the
  same precedence machinery as env/file/CLI — a write is an API-source set.
- **pvar sessions** isolate measurement intervals: a counter handle records
  its baseline at ``start`` and reads deltas, so two tools can watch the
  same global counter without trampling each other (the reason MPI_T has
  sessions at all).
- **categories** group variables for tool discovery, derived from the var
  registry's framework prefixes rather than a hand-maintained tree.

Counter pvars come from SPC (``runtime/spc.py``); state pvars are provided
by live subsystems via :func:`register_pvar` (e.g. matching-queue depths,
the PERUSE-adjacent surface of ``test/monitoring/test_pvar_access.c``).

Two properties the reference's tool plane has that this surface keeps:

- **deterministic discovery**: counter pvars enumerate the DOCUMENTED
  counter table of ``runtime/spc.py`` (parsed with zlint's ZL006
  parser), not merely counters that happen to have fired — so
  ``pvar_get_num`` is stable from init and a tool that allocated
  handle indices at startup never watches them shift under traffic.
- **remote sessions**: ``PvarSession(remote=(dvm_addr, job, rank))``
  reads a LIVE job's published store snapshots through the zprted
  ``metrics`` RPC — the MPI_T-reads-SPCs-from-running-jobs surface of
  the reference (PAPER.md §5), against the fleet instead of the local
  process.  Remote counter handles keep the same baseline-isolated
  delta semantics.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable

from ..core import errors
from ..mca import var as mca_var
from ..runtime import spc

# -- scopes (MPI_T_SCOPE_*) -------------------------------------------------

SCOPE_CONSTANT = "constant"  # read-only forever
SCOPE_READONLY = "readonly"  # read-only in this build
SCOPE_LOCAL = "local"        # writable, affects this controller only
SCOPE_ALL = "all"            # writable, affects every device (SPMD: same)

# -- pvar classes (MPI_T_PVAR_CLASS_*) --------------------------------------

PVAR_COUNTER = "counter"
PVAR_STATE = "state"
PVAR_WATERMARK = "highwatermark"


# =========================== control variables =============================


def cvar_get_num() -> int:
    return len(mca_var.registry.all_vars())


def cvar_names() -> list[str]:
    return [v.name for v in mca_var.registry.all_vars()]


def cvar_get_info(name: str) -> dict[str, Any]:
    """MPI_T_cvar_get_info: metadata without allocating a handle."""
    v = mca_var.registry.lookup(name)
    if v is None:
        raise errors.ArgError(f"no such cvar {name!r}")
    return {
        "name": v.name,
        "description": v.description,
        "type": v.type.__name__,
        "scope": SCOPE_ALL if v.settable else SCOPE_READONLY,
        "value": v.value,
        "source": v.source.name,
    }


class CvarHandle:
    """MPI_T_cvar_handle_alloc product: read/write one control variable."""

    def __init__(self, name: str) -> None:
        self._var = mca_var.registry.lookup(name)
        if self._var is None:
            raise errors.ArgError(f"no such cvar {name!r}")
        self.name = name

    def read(self) -> Any:
        return self._var.value

    def write(self, value: Any) -> None:
        if not self._var.settable:
            raise errors.ArgError(f"cvar {self.name} is read-only")
        mca_var.registry.set(self.name, value)


# ========================= performance variables ===========================


@dataclass
class _PvarDef:
    name: str
    klass: str
    description: str
    reader: Callable[[], int | float]
    writable_reset: bool = False
    resetter: Callable[[], None] | None = None
    #: counter-class defs may carry the backing store's reset-epoch
    #: reader: an open handle whose baseline predates a reset observes
    #: the epoch change and rebases instead of reading a negative delta
    epoch: Callable[[], int] | None = None


_pvars: dict[str, _PvarDef] = {}
_pvar_lock = threading.Lock()


def register_pvar(name: str, reader: Callable[[], int | float],
                  klass: str = PVAR_STATE, description: str = "",
                  resetter: Callable[[], None] | None = None) -> None:
    """Publish a performance variable backed by a live reader callable.
    Idempotent by name (last registration wins — subsystems re-register on
    re-init)."""
    with _pvar_lock:
        _pvars[name] = _PvarDef(
            name, klass, description, reader,
            resetter is not None, resetter,
        )


def _spc_defs() -> dict[str, _PvarDef]:
    """Every SPC counter is a counter-class pvar named spc_<counter>
    (the reference surfaces SPCs as MPI_T pvars, ompi_spc.c).

    The universe is the DOCUMENTED counter table — deterministic from
    init, zero-valued until a counter first fires — plus any dynamic
    names (templated families) that actually recorded: discovery never
    shrinks and never depends on which code paths traffic happened to
    warm."""
    out = {}
    names = set(spc.documented_counters())
    names.update(spc.snapshot())
    for cname in names:
        klass = PVAR_WATERMARK if cname in spc.WATERMARK else PVAR_COUNTER
        out[f"spc_{cname}"] = _PvarDef(
            f"spc_{cname}", klass, f"SPC counter {cname}",
            (lambda c=cname: spc.read(c)),
            epoch=spc.reset_epoch,
        )
    return out


def registered_pvars() -> dict[str, _PvarDef]:
    """Live-subsystem pvars only (the :func:`register_pvar` products,
    state/watermark readers) — the metrics publisher sweeps THESE per
    tick without rebuilding the whole counter universe."""
    with _pvar_lock:
        return dict(_pvars)


def pvar_defs() -> dict[str, _PvarDef]:
    defs = registered_pvars()
    defs.update(_spc_defs())
    return defs


def pvar_get_num() -> int:
    return len(pvar_defs())


def pvar_names() -> list[str]:
    return sorted(pvar_defs())


class _RemoteMetrics:
    """Reader plane of a remote pvar session: one rank's published
    store snapshots, fetched through the zprted ``metrics`` RPC.  Each
    handle read fetches the LATEST snapshot — staleness is bounded by
    the publisher interval, which is exactly the remote contract
    ("within one publish interval of the rank's own counters")."""

    def __init__(self, dvm_addr, job: str, rank: int):
        from ..runtime.dvm import DvmClient

        self.job = str(job)
        self.rank = int(rank)
        self._client = DvmClient(dvm_addr, timeout=10.0)

    def fetch(self) -> dict:
        """The rank's latest snapshot — {} while nothing is published
        yet (a session bound before the first publish reads the same
        zero-filled universe the publisher will ship; a DEAD daemon
        still raises — absence of data and absence of the daemon are
        different failures)."""
        try:
            return self._client.metrics(self.job, self.rank)
        except errors.MpiError as e:
            if "published" in str(e):
                return {}
            raise

    def counter(self, cname: str) -> int:
        return int((self.fetch().get("counters") or {}).get(cname, 0))

    def state(self, pname: str):
        return (self.fetch().get("pvars") or {}).get(pname, 0)

    def defs(self) -> dict[str, _PvarDef]:
        """The remote rank's pvar universe: the documented counter
        table (deterministic, exactly like local discovery) plus
        whatever the latest snapshot carries — extra fired counters
        and the publisher's state-pvar sweep."""
        names = set(spc.documented_counters())
        watermarks = set(spc.WATERMARK)
        states: dict[str, object] = {}
        try:
            snap = self.fetch()
            names.update(snap.get("counters") or {})
            watermarks.update(snap.get("watermark") or ())
            states = dict(snap.get("pvars") or {})
        except errors.MpiError:
            pass  # nothing published yet: the documented table stands
        out: dict[str, _PvarDef] = {}
        for cname in names:
            klass = PVAR_WATERMARK if cname in watermarks \
                else PVAR_COUNTER
            out[f"spc_{cname}"] = _PvarDef(
                f"spc_{cname}", klass,
                f"SPC counter {cname} of {self.job}:{self.rank}",
                (lambda c=cname: self.counter(c)),
            )
        for pname in states:
            out[pname] = _PvarDef(
                pname, PVAR_STATE,
                f"state pvar {pname} of {self.job}:{self.rank}",
                (lambda n=pname: self.state(n)),
            )
        return out

    def close(self) -> None:
        self._client.close()


class PvarSession:
    """MPI_T_pvar_session_create: an isolation scope for handles.

    ``remote=(dvm_addr, job, rank)`` binds the session to a LIVE job's
    published metrics instead of the local process: handles read
    baseline-isolated deltas from the rank's store snapshots via the
    daemon's ``metrics`` RPC.  ``free()`` releases the RPC socket —
    the session owns it."""

    def __init__(self, remote: tuple | None = None) -> None:
        self._handles: list[PvarHandle] = []
        self._remote: _RemoteMetrics | None = None
        if remote is not None:
            dvm_addr, job, rank = remote
            self._remote = _RemoteMetrics(dvm_addr, job, rank)

    def handle_alloc(self, name: str) -> "PvarHandle":
        defs = self._remote.defs() if self._remote is not None \
            else pvar_defs()
        if name not in defs:
            raise errors.ArgError(f"no such pvar {name!r}")
        h = PvarHandle(defs[name])
        self._handles.append(h)
        return h

    def free(self) -> None:
        self._handles.clear()
        if self._remote is not None:
            self._remote.close()
            self._remote = None


class PvarHandle:
    """Counter handles measure deltas from their ``start`` baseline so
    concurrent sessions don't interfere; state/watermark handles read the
    live value.

    A handle's baseline can outlive a store reset (``spc.reset()``
    between ``start`` and ``read``): the handle tracks the store's
    reset epoch and rebases to zero when it advances — a read after a
    reset reports the counts since the reset, never a negative delta.
    Remote handles (and any def without an epoch reader) keep the same
    contract through the monotonicity guard: a value below the
    baseline proves an upstream reset, so the baseline rebases."""

    def __init__(self, d: _PvarDef) -> None:
        self._def = d
        self._running = False
        self._baseline: int | float = 0
        self._epoch: int | None = None

    @property
    def name(self) -> str:
        return self._def.name

    @property
    def klass(self) -> str:
        return self._def.klass

    def start(self) -> None:
        if self._def.klass == PVAR_COUNTER:
            self._baseline = self._def.reader()
            if self._def.epoch is not None:
                self._epoch = self._def.epoch()
        self._running = True

    def stop(self) -> None:
        self._running = False

    def read(self) -> int | float:
        v = self._def.reader()
        if self._def.klass != PVAR_COUNTER:
            return v
        if self._def.epoch is not None:
            epoch = self._def.epoch()
            if self._epoch is not None and epoch != self._epoch:
                # the store was reset under the open handle: the old
                # baseline measures a dead incarnation
                self._baseline = 0
                self._epoch = epoch
        if v < self._baseline:
            # counters are monotonic: going backwards proves a reset
            # this handle could not observe (no epoch reader — e.g. a
            # remote rank restarted)
            self._baseline = 0
        return v - self._baseline

    def reset(self) -> None:
        """Counter handles rebase; others delegate to their resetter."""
        if self._def.klass == PVAR_COUNTER:
            self._baseline = self._def.reader()
            if self._def.epoch is not None:
                self._epoch = self._def.epoch()
        elif self._def.resetter is not None:
            self._def.resetter()
        else:
            raise errors.UnsupportedError(
                f"pvar {self._def.name} is not resettable"
            )


# =============================== categories ================================


def _pvar_category(pname: str) -> str:
    """Category of one pvar: ``spc_<counter>`` pvars land in the
    per-family ``spc.<family>`` bucket (``spc.tcp``, ``spc.han``, ...);
    other pvars bucket by their own name's family."""
    if pname.startswith("spc_"):
        return f"spc.{mca_var.family_of(pname[len('spc_'):])}"
    return mca_var.family_of(pname)


def category_names() -> list[str]:
    """Categories derived from the REGISTERED framework prefix table
    (``mca_var.register_family`` — the <framework>_<component> naming
    contract), not a bare first-``_``-segment split: ``coll_han_*``
    vars sit together in ``han`` instead of scattering across
    ``coll``/``han``/``sm`` buckets, and counter pvars land in
    per-family ``spc.<family>`` subcategories under the ``spc``
    umbrella (MPI_T_category_get_num analog)."""
    cats = {mca_var.family_of(v.name)
            for v in mca_var.registry.all_vars()}
    for pname in pvar_names():
        cats.add(_pvar_category(pname))
    cats.add("spc")  # the umbrella over every counter subcategory
    return sorted(cats)


def category_info(cat: str) -> dict[str, list[str]]:
    cvars = [
        v.name for v in mca_var.registry.all_vars()
        if mca_var.family_of(v.name) == cat
    ]
    if cat == "spc":
        pvars = [n for n in pvar_names() if n.startswith("spc_")]
    else:
        pvars = [n for n in pvar_names() if _pvar_category(n) == cat]
    if not cvars and not pvars:
        raise errors.ArgError(f"no such category {cat!r}")
    return {"cvars": cvars, "pvars": pvars}
