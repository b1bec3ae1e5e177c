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
  ``init()`` and ``host_init()``; an idempotent second call does not
  count).

Host-plane matching counters (``pt2pt/matching.py``):

- ``match_comparisons`` — posted/unexpected entry inspections performed
  while matching (the bin walks' actual work).
- ``match_unexpected_max_depth`` — WATERMARK: the deepest the
  unexpected backlog ever got (recorded at insert).
- ``pt2pt_sends`` / ``pt2pt_bytes_sent`` — thread-plane
  (``RankContext``) isends and their payload bytes; the wire plane's
  twin is the ``tcp_*`` family.

Wire-plane counters (``pt2pt/tcp.py``):

- ``tcp_bytes_sent`` / ``tcp_bytes_recvd`` — on-wire bytes: every
  length-framed message including its 4-byte header (eager frames,
  rendezvous RTS/CTS/data, modex and hello frames; rank-to-self delivery
  never hits the wire and is not counted).
- ``tcp_zero_copy_sends`` — sends whose array/bytes payload left as
  out-of-band segments (``dss.pack_frames`` + vectored ``sendmsg``).
- ``tcp_copy_bytes_avoided`` — payload bytes that skipped the pack-side
  serialization copy (OOB segment bytes, plus loopback payload bytes).
- ``tcp_loopback_fast_deliveries`` — rank-to-self sends delivered by the
  single-defensive-copy shortcut instead of a full DSS round trip.
- ``tcp_rndv_sends`` — rendezvous (RTS/CTS) transfers initiated.
- ``tcp_isend_deferred`` — isends that entered the deferred-contract
  progress engine (eager frames queued for the push-pool workers,
  rendezvous descriptors parked without the copy).
- ``rndv_park_bytes_avoided`` — payload bytes a rendezvous isend parked
  as the caller's own pinned buffers instead of the blocking path's
  defensive ``bytes()`` copy.
- ``tcp_rndv_park_copy_bytes`` — payload bytes the blocking send path
  copied at park time (its buffer-reuse contract holds at return).
- ``tcp_lazy_connects`` — outbound wire sockets actually dialed (a modex
  card costs no socket until first traffic).
- ``tcp_push_rr_rotations`` — rendezvous push-pool drains that hit the
  fair-share quantum with other destination channels waiting and
  rotated to the back of the pool queue.
- ``trace_wire_context_bytes`` — bytes of ``(trace_id, parent_sid,
  seq)`` context appended to DSS frame headers while tracing is armed.

Shared-memory-plane counters (recorded at the per-peer transport
dispatch seam in ``pt2pt/tcp.py``; the rings live in ``pt2pt/sm.py``):

- ``sm_bytes_sent`` / ``sm_bytes_recvd`` — on-ring bytes: every
  fragment's payload plus its 16-byte slot header.  ``recvd`` counts at
  consume time.
- ``sm_eager_sends`` — messages that fit one ring slot (DSS header
  packed straight into slot memory via ``dss.pack_frames_into``).
- ``sm_frag_sends`` — messages that took the multi-slot fragment
  pipeline (``sm_max_frag`` per slot).
- ``sm_ring_full_spins`` — producer spins on a full ring (backpressure);
  a high rate means ``sm_ring_bytes`` is undersized for the traffic.
- ``sm_fallback_tcp_sends`` — data sends to a peer that ADVERTISED a
  shared-memory endpoint this rank could not ride (boot-id mismatch or
  an unmappable segment): visible degradation.  Intentional TCP
  (``sm=0`` peers, remote hosts) is not counted.
- ``sm_rings_materialized`` — rings demand-mapped into existence by a
  sender's first-contact allocation request.

Hierarchical-collective counters (``coll/han.py`` and the
``pt2pt/groups.py`` GroupView send seam):

- ``coll_han_leader_elections`` — locality-group structures built (the
  deterministic min-rank leader election of each new group layout on an
  endpoint).
- ``coll_han_intra_bytes`` — payload bytes sent by intra-phase
  (same-host group) traffic; rides the sm rings through the send seam.
- ``coll_han_inter_bytes`` — payload bytes sent by inter-phase
  (leader-to-leader) traffic: the bytes that cross the wire.
- ``han_flat_fallbacks`` — collectives that REQUESTED the hierarchical
  path (``coll_han_enable=on`` or a ``han`` rules line) but ran flat
  (degenerate topology, non-commutative op): loud degradation.  The
  ``auto`` mode's decision not to engage is not counted.
- ``coll_han_pipelined`` — allreduces whose segmented leader exchange
  took the pipelined schedule (``coll_han_pipeline`` auto/on, >= 2
  segments).
- ``coll_han_numa_collectives`` — collectives that ran the THREE-level
  (NUMA) schedule: intra-domain phase → intra-host domain-leader
  exchange → inter-host wire exchange.
- ``coll_han_dleader_bytes`` — payload bytes of the three-level
  schedule's intra-host domain-leader exchange.
- ``han_numa_fallbacks`` — collectives that REQUESTED the three-level
  schedule (``coll_han_numa_level=on``) but ran two-level because the
  NUMA structure is degenerate.
- ``han_malformed_numa_cards`` — ranks whose ``pynuma:`` card item was
  present but unusable during topology derivation (demoted to a
  singleton domain).
- ``coll_han_alltoall_collectives`` — alltoall-family collectives
  (alltoall, alltoallv, reduce_scatter's leader phase) that ran the
  hierarchical block schedule: intra gather → leader exchange of
  aggregated per-host block matrices → intra scatter.
- ``coll_han_alltoall_inter_bytes`` — payload bytes the alltoall
  family's leader phase handed to the wire (each leader's own block
  excluded).
- ``coll_han_alltoall_leader_msgs`` — wire messages the leader exchange
  issued per leader: ``p-1`` pairwise, ``ceil(log2 p)`` once
  ``coll_han_alltoall_bruck_min`` leaders flip it to Bruck.

Device-plane liveness counters (``parallel/mesh.py``):

- ``device_probe_rounds`` — killable-child liveness probes launched
  (each a one-element NCCL all-reduce under a deadline, the
  ``utils/deadline`` idiom).
- ``device_probe_misses`` — probes that came back "hung"/"deadline"
  (the device plane did not answer inside its window).
- ``device_faults`` — typed ``cause="device"`` classifications fed into
  the FailureState (the DEVICE_FAULT flightrec event lands with each;
  zero across any run with no injected wedge).
- ``device_probes`` — background rounds the always-on DeviceProber ran
  between guarded regions (each also counts in
  ``device_probe_rounds``).
- ``device_probe_faults`` — background-prober rounds that missed and
  classified a typed device fault (each also counts in
  ``device_faults``).

Fault-tolerance counters (``comm/communicator.py``, ``ft/ulfm.py``):

- ``comm_revokes`` — communicators this process revoked itself
  (``Communicator.revoke``).
- ``comm_revokes_received`` — communicators marked revoked here because
  another rank revoked them (the revocation watcher's store reads).
- ``ft_overlay_hops`` — FT control frames (notice/revoke/agree/BYE
  floods and their gossip-once relays) sent over overlay links,
  recorded at each sender (``pt2pt/tcp.py``).
- ``tcp_deferred_dials`` — live peers a control flood skipped because
  they are not overlay neighbors (per flood evaluation).
- ``dvm_fault_events`` — authoritative daemon fault events a rank
  ingested (``FT_DVM_CID`` frames; the daemon that sends them waits for
  ``runtime/dvm.py``).
- ``ckpt_async_overlapped`` — training steps that committed while the
  previous checkpoint still drained (``models/ftloop.py``; an async
  checkpointer's overlap gate, zero with the serial one).

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
