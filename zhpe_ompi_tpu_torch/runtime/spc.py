"""Software performance counters (SPC) (namesake:
``zhpe_ompi_tpu/runtime/spc.py``; the port's own copy).

Re-design of ``ompi/runtime/ompi_spc.c``: named monotonic counters recorded
at API call sites, resettable for tests and benchmarks.  Counters record
**host-side events** per process: PyTorch runs eagerly, so a collective is
counted once per call (the JAX package counts once per trace under
``jit``).  With one process per GPU, a multi-rank job's totals are the sum
over its ranks.

The table below documents every counter the port records; the
:func:`documented_counters` parser reads it with zlint's
``tools/zlint/rules.parse_counter_doc``, the parser the ZL006 doc-parity
rule uses.

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

One-sided and PGAS counters (``osc/window.py``, ``osc/am.py``,
``osc/direct.py``, ``shmem/api.py``; the namesake's names and meanings):

- ``osc_puts`` / ``osc_gets`` / ``osc_bytes_put`` — one-sided window
  operations (every window plane records the same names: the counter
  tracks the OP, not the transport).
- ``osc_am_applied`` — active-message puts applied at the TARGET by the
  AM service dispatch.
- ``osc_direct_puts`` / ``osc_direct_gets`` — window/symmetric-heap puts
  and gets executed as direct load/store against a mapped sm RMA region.
- ``osc_direct_atomics`` — fetch-atomics (accumulate/get_accumulate/
  compare_and_swap/fetch_and_op and the shmem AMO family) applied under
  the region header's cross-process lock word.
- ``osc_direct_bytes`` — payload bytes moved by the direct path (puts +
  gets + atomics).
- ``osc_am_fallbacks`` — operations a direct-capable window routed to the
  active-message path (cross-host target, revoked channel, known-failed
  peer, unmappable region); windows with no region anywhere are plain AM
  windows and are not counted.
- ``osc_doorbell_posts`` / ``osc_doorbell_completes`` — stage-handoff
  epochs opened and completed by ringing the region header's POST and
  COMPLETE doorbell words instead of AM messages.
- ``shmem_puts`` / ``shmem_gets`` / ``shmem_puts_nbi`` / ``shmem_gets_nbi``
  — OpenSHMEM put/get traffic, blocking and nonblocking-implicit.

Runtime-plane counters (the PRRTE/PMIx analog — ``runtime/pmix.py``
records the ``pmix_*`` family in the process hosting the STORE, i.e.
the daemon; ``runtime/dvm.py`` records the daemon-side ``dvm_*`` events
and ``pt2pt/tcp.py`` records ``dvm_fault_events`` again in each
SURVIVOR that ingests the frame — the daemon's ``stat`` RPC surfaces
the daemon-side values):

- ``pmix_puts`` / ``pmix_gets`` / ``pmix_fences`` — PMIx verb traffic
  against the name-served KV store: staged puts, blocking
  get-until-published reads (one per published key read, not per
  wait wakeup), and completed fence ENTRIES (one per rank released,
  not per barrier).  A cold 4-rank modex is 4 puts + 4 fence entries
  + 16 gets.
- ``dvm_jobs_launched`` — jobs spawned into the resident VM (one per
  ``launch`` RPC that reached the spawn loop).
- ``dvm_fault_events`` — authoritative daemon fault events: in the
  daemon, one per child whose ``waitpid`` returned nonzero in an ft
  job; in a survivor, one per NEWLY-learned corpse an ``FT_DVM_CID``
  frame delivered (cause ``"daemon"`` — OS truth, never a detector
  false positive).
- ``dvm_respawns`` — replacement processes exec'd by the relaunch RPC
  (N victims respawned in one batched RPC count N, but share ONE
  namespace-generation bump — the same recovery window).
- ``dvm_tree_forwards`` — store verbs a CHILD daemon pushed up its
  parent link (``runtime/dvmtree.py``): every write
  (put/commit/fence/mkns/…), every ``lookup`` (mutable keys are never
  cached), and every ``get`` cache miss.  Recorded in the child
  daemon's process.
- ``dvm_store_cache_hits`` — blocking ``get``\\ s a child daemon served
  from its leaf-local cache instead of forwarding (single-flight
  waiters of an in-flight fetch count here once it lands).
- ``dvm_resizes`` — elastic resize RPCs the root daemon applied (one
  per grow or shrink event published, however many ranks it spawned
  or retired).
- ``dvm_jobs_queued`` — launches the admission queue actually BLOCKED
  (the client saw at least one ``[queued, pos]`` frame) before
  admitting; an uncontended launch admits without counting.
- ``dvm_queue_wait_ms`` — WATERMARK: the longest a launch waited in
  the admission queue (milliseconds, enqueue to admission) — the
  multi-tenant head-of-line latency the soak harness reports.
- ``dvm_placement_fallbacks`` — exclusive-placement requests that
  found no free daemon and degraded (loudly, with a client note) to
  spread; the capacity-exceeded signal, deliberately distinct from
  audit failures.
- ``dvm_placement_audit_failures`` — per-job placement audits that
  caught two live jobs sharing sessions/namespaces/exclusive
  subtrees; each raised a typed PlacementViolation and failed the
  launch.  Must stay zero in any healthy run.
- ``store_leaf_cache_hits`` / ``store_leaf_cache_misses`` — the leaf
  cache's hit/miss split on the generation-floored read path
  (``runtime/dvmtree.py``): hits serve locally (and additionally count
  in ``dvm_store_cache_hits``), misses forward up; the floor guarantees
  a post-respawn get can never count a corpse-incarnation entry as a
  hit.
- ``dvm_tree_routed_launches`` — spawn frames the root sent DOWN the
  daemon tree (one per remote daemon per launch/respawn/grow batch).

Serving-plane counters (the continuous-batching inference loop —
``models/inferloop.py`` records them; rank 0 of a serving job is the
request plane's control point, so its published snapshot carries the
load signal the operator-side LoadController scrapes):

- ``infer_requests_submitted`` — requests submitted into a serving
  queue (monotone; the backlog gauge the elastic policy keys on is
  ``infer_requests_submitted`` − ``infer_requests_served`` — the
  counter-difference idiom, derivable from any published snapshot).
- ``infer_requests_served`` — requests resolved by a completed serve
  step (rank 0 resolves the whole admitted batch at the step
  boundary).
- ``infer_queue_depth_max`` — WATERMARK: the deepest the request
  backlog ever got, observed at each admission boundary; a burst the
  resize policy absorbed is still visible here after the queue
  drains.
- ``infer_requeues`` — in-flight requests a typed fault sent BACK to
  the queue head (served or requeued, never silently dropped — the
  mid-serve kill drill's conservation gate).
- ``infer_resizes`` — elastic membership changes the serving loop
  applied at a step boundary (the worker-side count of the closed
  observability→runtime loop; the daemon's ``dvm_resizes`` is the
  operator-side twin).

Checkpoint-I/O-plane counters (``io/ckptio.py`` records them at the
two-phase writer, the digest-verified restore and the deadline-bounded
fbtl stream; ``models/ftloop.py`` records the overlap gate):

- ``ckpt_shards_written`` — shards an aggregator streamed through the
  fbtl backend into a checkpoint step directory (one per leaf-shard a
  rank contributed that the delta pass did not skip).
- ``ckpt_bytes_written`` — payload bytes of those shards.
- ``ckpt_gather_bytes`` — bytes non-aggregator ranks sent to their
  host's aggregator in the two-phase exchange (one send per live shard
  to one destination, never all-pairs).
- ``ckpt_delta_skips`` — shards an incremental checkpoint skipped
  because their digest matched the previous complete manifest's entry.
- ``ckpt_async_overlapped`` — training steps that committed while the
  previous checkpoint still drained (an async checkpointer's overlap
  gate, zero with the serial one).
- ``ckpt_integrity_rejects`` — shards (or tree files) whose manifest
  digest failed verification at restore; the step is disqualified.
- ``ckpt_degraded_restores`` — restores that fell back past a rejected
  newest step to an earlier complete one.
- ``ckpt_write_retries`` — stream writes that missed their
  ``ckpt_write_deadline_s`` watchdog window or raised, and were retried.
- ``ckpt_write_deadline_failures`` — writes that exhausted the retry
  budget and surfaced as a typed ``CheckpointWriteError``.
- ``ckpt_restore_bytes`` — payload bytes read back by a digest-verified
  restore.
- ``io_nonblocking_ops`` — nonblocking file transfers submitted to an
  ``io/fbtl.AsyncFbtl`` pool.

One-sided and PGAS counters (``shmem/device.py``):

- ``pgas_device_epochs`` — device-heap epoch advances (the PGAS
  quiet/fence boundary on the device plane).

Observability-plane counters (this module's :class:`MetricsPublisher`
and ``runtime/flightrec.py``):

- ``spc_publishes`` — metrics snapshots published into the PMIx store
  by the rank-side publisher (the periodic interval ticks plus the
  guaranteed final flush at close — a short-lived job is never
  invisible).  The interval is ``spc_publish_interval_ms`` (default
  1000), clamped to a 250 ms floor.
- ``flightrec_events_dropped`` — flight-recorder ring overwrites: typed
  events displaced from the fixed-size window before anyone read them
  (``flightrec_capacity`` slots).

Tracing-plane counters (``runtime/ztrace.py``):

- ``trace_spans_recorded`` — spans recorded into the per-process ztrace
  ring while the tracing plane is armed.
- ``trace_spans_dropped`` — span-ring overwrites: spans displaced from the
  fixed-size buffer (``ztrace_capacity`` slots).

Self-tuning-plane counters (``tools/ztune.py`` records the sweep side,
``runtime/pmix.py`` serves the table that ``coll/ztable.py`` reads):

- ``tuned_table_store_fetches`` — published tables actually fetched
  from a DVM's PMIx store (once per process; the negative result is
  cached too).
- ``tuned_regression_rejects`` — distilled cells the ztune regression
  gate REFUSED to emit because the candidate's counter-gated wire
  bytes exceeded the default's for that (op, comm_size, nbytes) cell;
  a planted worse-than-default winner must move this, never the
  table.
- ``ztune_cells_swept`` — (op, size, candidate, topology) benchmark
  cells the sweep harness measured; the sweep's own progress/coverage
  denominator.

Templated counter families (dynamic names routed through literal templates
at the call site):

- ``coll_<op>_calls`` / ``coll_<op>_bytes`` — per-operation collective
  monitoring interposition (``coll/monitoring.py``, default off).
- ``comm_<name>_coll_calls`` — per-communicator collective calls (the
  same interposition, keyed by communicator name).
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import defaultdict

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..tools.zlint.rules import parse_counter_doc

_stream = mca_output.open_stream("spc")

mca_var.register(
    "spc_publish_interval_ms", 1000,
    "Milliseconds between metrics-plane snapshot publishes into the "
    "PMIx store (rank-side publisher, armed by ZMPI_METRICS); clamped "
    "to a 250 ms floor — the publisher must never become sub-interval "
    "polling",
    type=int,
)

# the metrics-plane counters form their own pvar family (spc.metrics)
mca_var.register_family("spc_publishes", "metrics")
mca_var.register_family("flightrec", "metrics")

_counters: dict[str, int] = defaultdict(int)
_lock = threading.Lock()
_reset_epoch = 0

WATERMARK = {"max_bytes_in_collective", "match_unexpected_max_depth",
             "dvm_queue_wait_ms", "infer_queue_depth_max"}

#: publisher interval floor (seconds): below this a fleet of publishers
#: degenerates into sub-interval polling on shared cores
PUBLISH_FLOOR_S = 0.25


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

# hygiene registry (read by the tests' hygiene asserts): publisher
# threads must die with the proc that started them
_live_publishers: weakref.WeakSet = weakref.WeakSet()


def live_publisher_threads() -> list[str]:
    """Metrics-publisher threads still alive — must be [] once every
    proc's close() ran (the final-flush-then-stop contract)."""
    return [
        f"spc-publisher:{p.name}"
        for p in list(_live_publishers)
        if p.is_alive()
    ]


class MetricsPublisher(threading.Thread):
    """The rank-side half of the metrics plane: a daemon thread that
    publishes generation-tagged ``metrics:<job>:<rank>`` snapshots
    (full SPC table zero-filled from the documented universe, plus
    watermark labels and live state pvars) into the PMIx store every
    ``spc_publish_interval_ms`` (>= 250 ms), with one snapshot at
    start and a guaranteed final flush at :meth:`stop` — a job shorter
    than one interval is still visible.  On a typed failure
    classification the owning proc's failure listener calls
    :meth:`on_classification`, which ships the flight recorder's
    last-N window under ``flightrec:<job>:<rank>`` (the classification
    event is the tail entry by construction: the FailureState records
    it before notifying listeners).

    The store traffic rides one :class:`~zhpe_ompi_tpu_torch.runtime.pmix
    .PmixClient` (its own socket; the client lock serializes the
    interval thread against a classification-path flightrec publish).
    Waits are event-based (``Event.wait(interval)``) — never polling.
    """

    def __init__(self, pmix_addr, namespace: str, rank: int,
                 trace: bool = False):
        super().__init__(
            daemon=True, name=f"spc-pub-{namespace}-{rank}",
        )
        from . import pmix as pmix_mod

        self.namespace = str(namespace)
        self.rank = int(rank)
        var_ms = int(mca_var.get("spc_publish_interval_ms", 1000))
        # the 250 ms floor is a hard contract, not a default
        self.interval = max(PUBLISH_FLOOR_S, var_ms / 1000.0)
        self._client = pmix_mod.PmixClient(pmix_addr, timeout=10.0)
        self._halt = threading.Event()
        self._dead = False
        self._launched = False
        self._seq = 0
        self._seq_lock = threading.Lock()
        # the flight recorder is armed for this publisher's whole life
        # (ctor to stop), so the postmortem window covers everything
        # the owning proc did — not just what happened after the
        # publisher thread got scheduled
        from . import flightrec

        flightrec.arm()
        # tracing plane (opt-in on top of metrics): arm the span
        # recorder the same way and ship the trace buffer as
        # trace:<job>:<rank> with every snapshot — a victim killed -9
        # mid-job leaves its LAST periodic buffer in the store (the
        # postmortem the merged timeline is built from); the final
        # flush at stop() ships the rest
        self._trace = bool(trace)
        if self._trace:
            from . import ztrace

            ztrace.arm(match_events=True)
        self._armed = True
        _live_publishers.add(self)

    # -- payloads ---------------------------------------------------------

    def _snapshot_payload(self, final: bool) -> dict:
        counters = {name: 0 for name in documented_counters()}
        counters.update(snapshot())
        from ..tools import mpit

        pvars: dict[str, float] = {}
        # only the registered live-subsystem pvars: rebuilding the whole
        # counter universe per tick would be pure allocation on a
        # 250 ms-floor periodic path
        for name, d in mpit.registered_pvars().items():
            if d.klass != mpit.PVAR_STATE:
                continue
            try:
                v = d.reader()
            except Exception as e:
                mca_output.verbose(
                    3, _stream, "metrics publisher: pvar %s reader "
                    "raised (%s); row skipped", name, e,
                )
                continue  # a reader over torn-down state
            if isinstance(v, (int, float)):
                pvars[name] = v
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        return {
            "seq": seq,
            "t": time.time(),
            "interval_ms": int(self.interval * 1000),
            "final": bool(final),
            "counters": counters,
            "watermark": sorted(n for n in counters if n in WATERMARK),
            "pvars": pvars,
        }

    def _put(self, key: str, payload) -> None:
        self._client.put(self.namespace, self.rank, key, payload)
        self._client.commit(self.namespace, self.rank)

    def publish(self, final: bool = False) -> bool:
        """One snapshot into the store; False once the store refuses
        (namespace destroyed / daemon gone — the publisher is outliving
        its job and stops)."""
        if self._dead:
            return False
        # counted BEFORE the snapshot is built, so every shipped
        # snapshot carries its own publish (the very first one already
        # reads spc_publishes == 1 — the acceptance gate's "rises")
        from . import spc  # this module, for the ZL006 parity sweep

        spc.record("spc_publishes")
        payload = self._snapshot_payload(final)
        try:
            self._put(f"metrics:{self.namespace}:{self.rank}", payload)
            if self._trace:
                from . import ztrace

                self._put(f"trace:{self.namespace}:{self.rank}",
                          ztrace.payload(self.rank))
        except errors.MpiError as e:
            self._dead = True
            mca_output.verbose(
                2, _stream, "metrics publisher %s: store refused "
                "publish (%s); stopping", self.name, e,
            )
            return False
        return True

    def on_classification(self, failed_rank: int, cause: str) -> None:
        """Failure-listener hook: ship the flight-recorder window under
        ``flightrec:<job>:<rank>``.  The FT_CLASS event for
        ``failed_rank`` is already in the ring (FailureState records
        before it notifies), so it is the window's tail entry."""
        if self._dead:
            return
        from . import flightrec

        wall, mono = flightrec.anchors()
        try:
            # events stamp monotonic ns (merge-safe under NTP steps);
            # the ring's wall anchor ships WITH the window so store
            # consumers can map the stamps onto the wall clock
            self._put(f"flightrec:{self.namespace}:{self.rank}",
                      {"anchor_wall": wall, "anchor_mono_ns": mono,
                       "events": flightrec.window()})
        except errors.MpiError as e:
            mca_output.verbose(
                2, _stream, "metrics publisher %s: flightrec publish "
                "failed (%s)", self.name, e,
            )

    # -- lifecycle --------------------------------------------------------

    def run(self) -> None:
        try:
            if not self.publish():  # the start-of-life snapshot
                return
            while not self._halt.wait(self.interval):
                if not self.publish():
                    return
            self.publish(final=True)  # the guaranteed final flush
        finally:
            self._client.close()

    def start(self) -> None:
        # _launched flips only AFTER start() returns: a start() that
        # raises (thread exhaustion, interpreter shutdown) must leave
        # stop() on the never-started path — joining an unstarted
        # thread raises and would mask the ctor's original error
        super().start()
        self._launched = True

    def stop(self, timeout: float = 5.0) -> None:
        """Signal the final flush and join (bounded) — the owning
        proc's close() path.  A publisher that was never started (a
        constructor that failed later) still owns its client socket
        and its flight-recorder arm refcount."""
        self._halt.set()
        if self._armed:
            from . import flightrec

            flightrec.disarm()
            if self._trace:
                from . import ztrace

                ztrace.disarm(match_events=True)
            self._armed = False
        if not self._launched:
            self._client.close()
            return
        self.join(timeout)

    def abort(self, timeout: float = 5.0) -> None:
        """The crash path (``sever()``): stop WITHOUT the final flush —
        a clean final snapshot from a simulated corpse would lie to
        the fleet — but the thread still dies with the proc."""
        self._dead = True
        self.stop(timeout)

