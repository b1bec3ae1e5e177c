"""Software performance counters (SPC) (namesake:
``zhpe_ompi_tpu/runtime/spc.py``; the port's own copy).

Re-design of ``ompi/runtime/ompi_spc.c``: named monotonic counters recorded
at API call sites, resettable for tests and benchmarks.  Counters record
**host-side events** per process: PyTorch runs eagerly, so a collective is
counted once per call (the JAX package counts once per trace under
``jit``).  With one process per GPU, a multi-rank job's totals are the sum
over its ranks.

The table below documents every counter the port records; the
:func:`documented_counters` parser reads it (the port keeps its own copy
of the JAX package's ``tools/zlint/rules.parse_counter_doc``).

API-surface counters:

- ``init_count`` — runtime initializations (``runtime/init.py``'s
  ``init()``; an idempotent second call does not count).

Device-plane liveness counters (``parallel/mesh.py``):

- ``device_probe_rounds`` — killable-child liveness probes launched
  (each a one-element NCCL all-reduce under a deadline, the
  ``utils/deadline`` idiom).
- ``device_probe_misses`` — probes that came back "hung"/"deadline"
  (the device plane did not answer inside its window).

Fault-tolerance counters (``comm/communicator.py``, ``ft/ulfm.py``):

- ``comm_revokes`` — communicators this process revoked itself
  (``Communicator.revoke``).
- ``comm_revokes_received`` — communicators marked revoked here because
  another rank revoked them (the revocation watcher's store reads).

One-sided and PGAS counters (``shmem/device.py``):

- ``pgas_device_epochs`` — device-heap epoch advances (the PGAS
  quiet/fence boundary on the device plane).

Observability-plane counters (``runtime/flightrec.py``):

- ``flightrec_events_dropped`` — flight-recorder ring overwrites: typed
  events displaced from the fixed-size window before anyone read them
  (``flightrec_capacity`` slots).

Tracing-plane counters (``runtime/ztrace.py``):

- ``trace_spans_recorded`` — spans recorded into the per-process ztrace
  ring while the tracing plane is armed.
- ``trace_spans_dropped`` — span-ring overwrites: spans displaced from the
  fixed-size buffer (``ztrace_capacity`` slots).

Templated counter families (dynamic names routed through literal templates
at the call site):

- ``coll_<op>_calls`` / ``coll_<op>_bytes`` — per-operation collective
  monitoring interposition (``coll/monitoring.py``, default off).
- ``comm_<name>_coll_calls`` — per-communicator collective calls (the
  same interposition, keyed by communicator name).
"""

from __future__ import annotations

import re
import threading
from collections import defaultdict

from ..core import errors
from ..mca import var as mca_var

# the metrics-plane counters form their own pvar family (spc.metrics)
mca_var.register_family("spc_publishes", "metrics")
mca_var.register_family("flightrec", "metrics")

_counters: dict[str, int] = defaultdict(int)
_lock = threading.Lock()
_reset_epoch = 0

WATERMARK = {"max_bytes_in_collective", "match_unexpected_max_depth",
             "dvm_queue_wait_ms", "infer_queue_depth_max"}


def record(name: str, value: int = 1) -> None:
    with _lock:
        if name in WATERMARK:
            _counters[name] = max(_counters[name], value)
        else:
            _counters[name] += value


def read(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def snapshot() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Clear every counter and advance the reset epoch — an open counter
    handle observes the epoch change and rebases instead of reading a
    negative delta."""
    global _reset_epoch
    with _lock:
        _counters.clear()
        _reset_epoch += 1


def reset_epoch() -> int:
    """Monotonic count of :func:`reset` calls (the handle rebase signal)."""
    with _lock:
        return _reset_epoch


# The counter-table parser (the JAX package's
# ``tools/zlint/rules.parse_counter_doc``): a bullet whose head is one or
# more double-backticked names separated by "/", where a name may carry
# ``<placeholder>`` segments (a templated family).
_DOC_ENTRY_RE = re.compile(
    r"^- (``[a-zA-Z0-9_<>]+``(?: */ *``[a-zA-Z0-9_<>]+``)*)")
_DOC_TICKED_RE = re.compile(r"``([a-zA-Z0-9_<>]+)``")


def parse_counter_doc(doc: str) -> tuple[set[str], set[str]]:
    """Split a counter doc table into (exact names, templated families).
    A templated family carries ``<...>`` placeholders (``coll_<op>_calls``)
    — the documented shape of a dynamic name routed through a literal
    template at its call site."""
    names: set[str] = set()
    templates: set[str] = set()
    for line in doc.splitlines():
        m = _DOC_ENTRY_RE.match(line.strip())
        if not m:
            continue
        for ticked in _DOC_TICKED_RE.findall(m.group(1)):
            (templates if "<" in ticked else names).add(ticked)
    return names, templates


_documented: frozenset[str] | None = None


def documented_counters() -> frozenset[str]:
    """Exact counter names from this module's doc table: the deterministic
    counter universe, stable from import instead of growing with
    traffic."""
    global _documented
    if _documented is None:
        names, _templates = parse_counter_doc(__doc__ or "")
        _documented = frozenset(names)
    return _documented


# ========================= rank-side publisher =============================


def live_publisher_threads() -> list[str]:
    """Metrics-publisher threads still alive: always [] in the port, which
    cannot start one until ``runtime/pmix.py`` is ported."""
    return []


class MetricsPublisher:
    """The rank-side half of the metrics plane, which publishes SPC
    snapshots into the DVM's PMIx store.  It needs ``runtime/pmix.py``'s
    store client, which the port has not ported yet: constructing one
    raises."""

    def __init__(self, pmix_addr, namespace: str, rank: int,
                 trace: bool = False):
        raise errors.UnsupportedError(
            "MetricsPublisher publishes into the PMIx store, which needs "
            "runtime/pmix.py; the PyTorch port has not ported it yet")
