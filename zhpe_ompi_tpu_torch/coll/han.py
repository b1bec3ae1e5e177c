"""coll/han — hierarchical topology-aware host collectives (namesake:
``zhpe_ompi_tpu/coll/han.py``; the port's own copy, over tensors).

Re-design of ``ompi/mca/coll/han`` (Luo et al., "HAN: a Hierarchical
AutotuNed Collective Communication Framework", IEEE Cluster 2020) for
the host plane: every collective splits into an **intra phase** inside
each locality group (same-host ranks, where the send seam rides the
``pt2pt/sm.py`` mmap rings) and an **inter phase** among one leader per
group (where it rides the wire), because a flat ring that interleaves
shared-memory and wire hops runs at the speed of its slowest hop.

Topology comes from :func:`zhpe_ompi_tpu_torch.pt2pt.groups
.locality_groups` (the ``(boot_id, segment)`` modex cards); each phase
runs the FLAT algorithms of ``coll/host.py`` unchanged on a
:class:`~zhpe_ompi_tpu_torch.pt2pt.groups.GroupView` sub-endpoint.
Algorithms:

- ``allreduce``  — intra reduce → leader allreduce → intra bcast; above
  ``host_coll_large_msg`` the leader exchange takes the split
  (reduce-scatter + allgather ring) schedule in ``coll_han_inter_segment``
  pieces, and with ``coll_han_pipeline`` auto/on and >= 2 segments each
  segment's intra bcast is issued nonblocking (``coll/nbc.ibcast``) while
  the leaders exchange the next one.
- ``bcast``      — root→leader hop (when the root is not its group's
  leader) → leader bcast → intra bcast.
- ``reduce``     — intra reduce → leader reduce to the root's leader →
  leader→root hop.
- ``barrier``    — intra gather → leader allgather → intra release.
- ``allgather``  — intra gather → leader allgather (blocks travel with
  their global rank map) → intra bcast.
- ``reduce_scatter`` — intra blockwise reduce → leader alltoall of each
  group's blocks → per-block combine → intra scatter.
- ``alltoall``/``alltoallv`` — intra gather of each member's full
  rank-indexed send list → ONE aggregated leader exchange per host pair
  (pairwise below ``coll_han_alltoall_bruck_min`` leaders, Bruck
  store-and-forward at or above it) → intra scatter of the reassembled
  receive lists (the MoE expert-dispatch pattern, ``models/moe.py``).

With ``coll_han_numa_level`` engaged (``pynuma:`` card tokens, pinned per
rank by ``sm_numa_id``), allreduce, bcast and barrier nest a third level:
intra-domain phase → intra-host domain-leader exchange → wire exchange.

**Payloads.**  As in ``coll/host.py``: CPU tensors, numpy arrays and
Python values.  The array-shaped steps (segmenting the leader exchange,
reassembling the pipelined segments) run in torch on the operand's own
device; allreduce, reduce and reduce_scatter return the caller's kind.
Tags, windows, segment bounds and message order are the namesake's.

Selection (``coll/host.py``'s dispatch seam): ``coll_han_enable`` =
``auto`` (on only when the topology has >= 2 locality groups with >= 2
members each, or a NUMA level that qualifies), ``on`` (forced; a
degenerate topology falls back to the flat algorithms LOUDLY via the
``han_flat_fallbacks`` counter and the ``coll_han`` stream), or ``off``.
A ``<op> <comm_size_min> <msg_bytes_min> han`` line of the
``coll_tuned_dynamic_rules`` file requests han per op and size like a
forced enable.  Non-commutative reductions always route flat.

Fault tolerance (revoke aliases, shrink rebuilds) waits for
``ft/ulfm.py``; :func:`invalidate` is kept for the membership changes
that will call it.
"""


from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..pt2pt import groups as groups_mod
from ..pt2pt.groups import LEADER_WINDOW, GroupView, payload_bytes
from ..runtime import flightrec
from ..runtime import spc
from ..runtime import ztrace
from . import host

_stream = mca_output.open_stream("coll_han")

# category derivation (tools/mpit.py): the hierarchical-collective
# plane's vars (coll_han_*) and counters (coll_han_*, han_*) are ONE
# family
mca_var.register_family("coll_han", "han")
mca_var.register_family("han", "han")


def _recorded(opname: str):
    """Flight-recorder enter/exit around a hierarchical collective —
    exit records only on SUCCESS, so a postmortem window shows the
    schedule a failing rank died inside (an aborted collective's
    missing exit is the signal, not a gap).  While the tracing plane
    is armed the same pairing records one COLL span per schedule (the
    same success-only discipline: an aborted collective's missing
    span is the signal)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(ctx, *args, **kwargs):
            flightrec.record(flightrec.COLL_ENTER, op=opname)
            sp = ztrace.begin(ztrace.COLL, getattr(ctx, "rank", -1),
                              op=opname) if ztrace.active else None
            out = fn(ctx, *args, **kwargs)
            flightrec.record(flightrec.COLL_EXIT, op=opname)
            if sp is not None:
                sp.end()
            return out
        return wrapper
    return deco


mca_var.register(
    "coll_han_inter_segment", 1 << 20,
    "Segment size (bytes) of the large-message leader exchange: the "
    "inter phase processes the reduced payload in pieces of at most "
    "this size, so every leader-to-leader transfer stays on the eager "
    "zero-copy wire path (a monolithic half/chunk above "
    "tcp_eager_limit would fall into RTS/CTS rendezvous and pay its "
    "defensive copy + round trips).  Default matches tcp_eager_limit",
    type=int,
)
mca_var.register(
    "coll_han_numa_level", "auto",
    "Third (NUMA) topology level of the hierarchical collectives: "
    "nest an intra-DOMAIN phase under the host level — intra-domain "
    "reduce/bcast, an intra-host domain-leader exchange over the sm "
    "rings, and the inter-host wire exchange among host leaders.  "
    "auto = engage when some host has >= 2 domains of >= 2 members "
    "(the pynuma: modex tokens / sm_numa_id emulation); on = forced — "
    "a degenerate NUMA structure falls back to the TWO-LEVEL path "
    "loudly (han_numa_fallbacks), never silently and never all the "
    "way to flat while the host level is viable; off = two-level only",
    enum=("auto", "on", "off"),
)
mca_var.register(
    "coll_han_pipeline", "auto",
    "Pipelined inter/intra overlap of the segmented leader exchange "
    "(the reference han's 'w' variants): segment k's intra bcast is "
    "issued nonblocking — the deferred-contract isend engine drains it "
    "onto the rings — while the leaders already run segment k+1's wire "
    "exchange.  auto/on = pipeline whenever the large-message "
    "segmented exchange yields >= 2 segments; off = the sequential "
    "schedule (every segment's exchange and bcast strictly ordered)",
    enum=("auto", "on", "off"),
)

#: collectives with a two-level schedule — canonical home is the
#: dispatch seam (coll/host.py), re-exported here for the decision API
HAN_OPS = host.HAN_OPS


class _Topology:
    """One endpoint's locality structure: ascending-member groups
    ordered by leader (min) rank; ``leaders[i]`` leads ``groups[i]``.
    ``nested`` (when known) adds the NUMA level: per host, its domain
    member-lists ordered by domain leader — the three-level schedule's
    input."""

    __slots__ = ("groups", "leaders", "gidx", "degenerate", "qualified",
                 "nested", "numa_viable", "numa_qualified")

    def __init__(self, size: int, rank: int, groups: list[list[int]],
                 nested: list[list[list[int]]] | None = None):
        flat = sorted(r for g in groups for r in g)
        if flat != list(range(size)):
            raise errors.ArgError(
                f"han groups must partition ranks 0..{size - 1}, got "
                f"{groups}"
            )
        self.groups = sorted((sorted(g) for g in groups),
                             key=lambda g: g[0])
        self.leaders = [g[0] for g in self.groups]
        self.gidx = next(i for i, g in enumerate(self.groups)
                         if rank in g)
        n = len(self.groups)
        # degenerate: one group (pure intra), all singletons (pure
        # inter == flat with extra dispatch), or more groups than tag
        # windows — nothing hierarchical to win
        self.degenerate = n < 2 or n == size or n > groups_mod.MAX_GROUPS
        # the auto-on bar: at least two groups that actually HAVE an
        # intra phase — anything less and flat is at least as good
        self.qualified = (not self.degenerate) and sum(
            1 for g in self.groups if len(g) >= 2) >= 2
        self.nested = None
        self.numa_viable = self.numa_qualified = False
        if nested is not None:
            norm = []
            for hostdoms in nested:
                norm.append(sorted((sorted(d) for d in hostdoms),
                                   key=lambda d: d[0]))
            norm.sort(key=lambda doms: doms[0][0])
            if [sorted(r for d in h for r in d) for h in norm] \
                    != self.groups:
                raise errors.ArgError(
                    "han nested domains must partition their host "
                    f"groups, got {nested} over {self.groups}"
                )
            self.nested = norm
            n_domains = sum(len(h) for h in norm)
            # viable: some host actually SPLITS into domains, and the
            # window partition can carry the layout (global domain
            # index + per-host dleader window + the wire window)
            self.numa_viable = (
                any(len(h) >= 2 for h in norm)
                and n_domains <= groups_mod.DOMAIN_WINDOWS
                and len(norm) <= groups_mod.MAX_HOSTS_NESTED
            )
            # the auto bar: >= 2 domains of >= 2 members on some host —
            # anything less and the two-level schedule is at least as
            # good (a lone multi-rank domain IS the host group)
            self.numa_qualified = self.numa_viable and any(
                sum(1 for d in h if len(d) >= 2) >= 2 for h in norm)

    def group_of(self, rank: int) -> int:
        return next(i for i, g in enumerate(self.groups) if rank in g)

    def domain_of(self, rank: int) -> tuple[int, int]:
        """(host index, domain index within host) of ``rank``."""
        h = self.group_of(rank)
        return h, next(i for i, d in enumerate(self.nested[h])
                       if rank in d)

    def domain_window(self, h: int, d: int) -> int:
        """Window id of domain ``d`` of host ``h``: the disjoint
        domain range (DOMAIN_WINDOW_BASE +) indexed globally in
        (host, domain) order."""
        return groups_mod.DOMAIN_WINDOW_BASE + \
            sum(len(self.nested[i]) for i in range(h)) + d


def topology(ctx, groups: list[list[int]] | None = None) -> _Topology:
    """The endpoint's (cached) locality topology; ``groups`` overrides
    the modex derivation (test harnesses emulating multi-host layouts
    on the thread plane) — depth-2 lists give host groups only,
    depth-3 lists (host → domain → members) emulate the NUMA level.
    Never raises out of a malformed FOREIGN card: the nested
    derivation counts it and demotes the rank to a singleton domain."""
    if groups is None:
        cached = getattr(ctx, "_han_topology", None)
        if cached is not None:
            return cached
        nested = groups_mod.locality_groups(ctx, nested=True)
        hostg = [sorted(r for d in h for r in d) for h in nested]
        topo = _Topology(ctx.size, ctx.rank, hostg, nested=nested)
        ctx._han_topology = topo
        return topo
    if groups and groups[0] and isinstance(groups[0][0], (list, tuple)):
        hostg = [[r for d in h for r in d] for h in groups]
        return _Topology(ctx.size, ctx.rank, hostg,
                         nested=[[list(d) for d in h] for h in groups])
    return _Topology(ctx.size, ctx.rank, groups)


def invalidate(ctx) -> None:
    """Drop the cached topology/views (a membership change: JOIN
    re-modex scrubbing a rejoiner's card).  The next han collective
    re-derives the groups — the same rebuild a shrink gets by being a
    fresh endpoint."""
    for attr in ("_han_topology", "_han_views"):
        try:
            delattr(ctx, attr)
        except AttributeError:
            pass


def _views(ctx, topo: _Topology) -> tuple[GroupView, GroupView | None]:
    """(intra view, leader view-or-None) for this rank, cached per
    group structure.  Building the views IS the leader election (the
    deterministic min-rank rule), counted in
    ``coll_han_leader_elections``."""
    cache = getattr(ctx, "_han_views", None)
    if cache is None:
        cache = {}
        ctx._han_views = cache
    key = tuple(tuple(g) for g in topo.groups)
    got = cache.get(key)
    if got is None:
        intra = GroupView(ctx, topo.groups[topo.gidx],
                          window=topo.gidx, plane="intra")
        inter = None
        if ctx.rank in topo.leaders:
            inter = GroupView(ctx, topo.leaders, window=LEADER_WINDOW,
                              plane="inter")
        spc.record("coll_han_leader_elections", 1)
        got = (intra, inter)
        cache[key] = got
    return got


def _numa_views(ctx, topo: _Topology
                ) -> tuple[GroupView, GroupView | None, GroupView | None]:
    """(intra-domain view, per-host domain-leader view or None, wire
    view or None) for this rank under the three-level schedule, cached
    per nested structure.  The domain and dleader views NEST inside the
    host view (view-of-view: members in host-view coordinates, traffic
    flattened onto the base endpoint under the nested view's OWN
    window), so the three-level layout exercises exactly the rel/parent
    translation machinery the nesting contract specifies."""
    cache = getattr(ctx, "_han_views", None)
    if cache is None:
        cache = {}
        ctx._han_views = cache
    key = ("numa",) + tuple(
        tuple(tuple(d) for d in h) for h in topo.nested)
    got = cache.get(key)
    if got is None:
        h = topo.gidx
        doms = topo.nested[h]
        hview = GroupView(ctx, topo.groups[h], window=h, plane="intra")
        _h, d = topo.domain_of(ctx.rank)
        dview = GroupView(
            hview, [hview.rel_base(r) for r in doms[d]],
            window=topo.domain_window(h, d), plane="intra")
        dlview = None
        dleaders = [dom[0] for dom in doms]
        if ctx.rank in dleaders:
            dlview = GroupView(
                hview, [hview.rel_base(r) for r in dleaders],
                window=groups_mod.HOST_LEADER_BASE + h, plane="dleader")
        wview = None
        if ctx.rank in topo.leaders:
            wview = GroupView(ctx, topo.leaders, window=LEADER_WINDOW,
                              plane="inter")
        spc.record("coll_han_leader_elections", 1)
        got = (dview, dlview, wview)
        cache[key] = got
    return got


def _flat_fallback(ctx, opname: str, reason: str) -> None:
    """An explicitly-requested han that cannot run hierarchically:
    LOUD degradation — counted and
    emitted, never silent."""
    spc.record("han_flat_fallbacks", 1)
    mca_output.emit(
        _stream,
        "rank %s: %s requested the hierarchical (han) path but %s; "
        "running the flat algorithm", getattr(ctx, "rank", "?"),
        opname, reason,
    )


def _numa_fallback(ctx, opname: str, reason: str) -> None:
    """A forced NUMA (three-level) schedule that cannot nest: LOUD
    degradation to the TWO-LEVEL path — counted and emitted.  Distinct
    from ``_flat_fallback`` by contract: while the host level is
    viable, a degenerate NUMA structure costs only the domain phase,
    never the whole hierarchy."""
    spc.record("han_numa_fallbacks", 1)
    mca_output.emit(
        _stream,
        "rank %s: %s requested the NUMA (three-level) schedule but %s; "
        "running the two-level path", getattr(ctx, "rank", "?"),
        opname, reason,
    )


#: collectives with a three-level (NUMA) schedule; the rest run their
#: two-level schedule even when the NUMA level is engaged (their phase
#: structure gains nothing from a third nesting)
NUMA_OPS = frozenset(("allreduce", "bcast", "barrier"))


def _numa_mode() -> str:
    return str(mca_var.get("coll_han_numa_level", "auto"))


def _use_numa(ctx, topo: _Topology, opname: str) -> bool:
    """Per-collective decision for the third (NUMA) level, consulted
    AFTER han itself was selected.  Deterministic across ranks: it
    reads only the shared topology and MCA state."""
    mode = _numa_mode()
    if mode == "off" or topo.nested is None or opname not in NUMA_OPS:
        return False
    if mode == "on":
        if topo.numa_viable:
            return True
        _numa_fallback(
            ctx, opname,
            "the NUMA structure is degenerate "
            f"({sum(len(h) for h in topo.nested)} domain(s) over "
            f"{len(topo.groups)} host(s))")
        return False
    return topo.numa_qualified


def topology_key(ctx=None):
    """The job's ``(n_hosts, n_domains, ranks_per_domain)`` decision-
    table key: the ``coll_tuned_topology`` var when set, else derived
    from the endpoint's cached locality topology (``ranks_per_domain``
    is the LARGEST domain — tables for ragged layouts should pin the
    coarser fields and wildcard it).  Never raises: no context
    or an underivable topology matches wildcard sections only."""
    from . import ztable

    key = ztable.job_topology_key()
    if key is not None or ctx is None:
        return key
    try:
        topo = topology(ctx)
    except errors.MpiError as e:
        mca_output.verbose(
            2, _stream,
            "topology-key derivation failed (%s); tuned tables match "
            "wildcard sections only", e,
        )
        return None
    n_hosts = len(topo.groups)
    if topo.nested:
        n_domains = sum(len(h) for h in topo.nested)
        biggest = max(
            (len(d) for h in topo.nested for d in h), default=1)
    else:
        n_domains = n_hosts
        biggest = max((len(g) for g in topo.groups), default=1)
    return (n_hosts, n_domains, biggest)


def _rule_requests_han(opname: str, size: int, payload: Any,
                       ctx=None) -> bool:
    # the table ladder (coll/ztable.py's file rung; the store rung
    # raises under ZMPI_PMIX) — topology-keyed when a context can
    # derive a key.
    # Size matching uses the LOCAL payload size — ops whose payloads
    # are not congruent across ranks (the host plane's bcast has none
    # at non-roots) must use msg_bytes_min 0.
    from . import ztable

    if not ztable.active():
        return False
    return ztable.resolve_rule(
        opname, size, payload_bytes(payload), topology_key(ctx)) == "han"


def wants_han(ctx, opname: str, payload: Any = None, op=None,
              mode: str | None = None) -> bool:
    """The han half of the host-plane decision (called from
    ``coll/host.py``'s dispatch seam): True when this collective should
    take the two-level schedule."""
    if mode is None:
        mode = str(mca_var.get("coll_han_enable", "auto"))
    if mode == "off" or opname not in HAN_OPS:
        return False
    if getattr(ctx, "_han_subview", False):
        return False  # phase traffic re-enters the flat algorithms
    requested = mode == "on" or _rule_requests_han(
        opname, getattr(ctx, "size", 0), payload, ctx)
    if not requested and mode != "auto":  # unknown mode string: off
        return False
    topo = topology(ctx)
    noncommutative = op is not None and not getattr(op, "commute", True)
    # the NUMA level can carry a host-degenerate topology (e.g. one
    # host whose domains split): the hierarchy then lives entirely in
    # the domain phase + dleader exchange
    numa_carries = (
        _numa_mode() != "off" and opname in NUMA_OPS
        and topo.numa_qualified
    )
    if requested:
        if noncommutative:
            _flat_fallback(ctx, opname, "the op is non-commutative "
                           "(group combine order != rank order)")
            return False
        if topo.degenerate:
            if numa_carries:
                return True
            _flat_fallback(ctx, opname, "the topology is degenerate "
                           f"({len(topo.groups)} locality group(s) over "
                           f"{ctx.size} rank(s))")
            return False
        return True
    return (topo.qualified or numa_carries) and not noncommutative


def _require_commutative(op, opname: str) -> None:
    if op is not None and not getattr(op, "commute", True):
        raise errors.ArgError(
            f"han {opname} requires a commutative op (group combine "
            "order is not rank order); use the flat path"
        )


# ------------------------------------------------------------ allreduce


def _is_array(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _elems(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(x.size)


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize


def _flat(x) -> torch.Tensor:
    """A contiguous 1-d tensor over ``x`` (a numpy array through
    ``torch.from_numpy``, no copy where it is already contiguous)."""
    return host._operand(x).contiguous().reshape(-1)


def _pipeline_geometry(n_groups: int, value: Any
                       ) -> tuple[int, int] | None:
    """Segment geometry ``(seg_elems, nseg)`` of the pipelined leader
    exchange, derived from the ALLREDUCE INPUT — congruent on every
    rank by the MPI contract, so leaders and members reach the
    identical schedule with no negotiation (members never see the
    reduced array the sequential path sizes its segments from).  None
    when the segmented large-message path would not engage, or when it
    yields a single segment (nothing to overlap)."""
    large = int(mca_var.get("host_coll_large_msg", 256 * 1024))
    if (
        not _is_array(value)
        or value.nbytes < large
        or _elems(value) < n_groups
    ):
        return None
    seg_bytes = max(1, int(mca_var.get("coll_han_inter_segment",
                                       1 << 20)))
    seg = max(n_groups, seg_bytes // max(_itemsize(value), 1))
    if _elems(value) <= seg:
        return None
    return seg, -(-_elems(value) // seg)


def _allreduce_pipelined(intra, inter, value: Any, op,
                         geom: tuple[int, int]) -> Any:
    """The reference han's "w" overlap: the segmented leader exchange
    isends segment k's intra bcast (nonblocking — the deferred-contract
    engine drains it onto the rings) while segment k+1's wire exchange
    already runs, so the intra plane and the wire stay busy at once
    instead of strictly alternating.  Members consume the segments
    SEQUENTIALLY with the blocking binomial phase — one intra-window
    tag bump per segment as each bcast runs, matching the leader's
    one-ibcast-per-segment issue order — so a member is forwarding
    segment k while its leader already exchanges k+1."""
    from ..pt2pt.requests import wait_all
    from . import nbc

    seg, nseg = geom
    spc.record("coll_han_pipelined", 1)
    partial = host.reduce(intra, value, op, root=0) \
        if intra.size > 1 else value
    pieces: list = [None] * nseg
    if inter is not None:
        flat = _flat(partial)
        breqs = []
        for k in range(nseg):
            piece = flat[k * seg:(k + 1) * seg]
            if inter.size > 2:
                tag = host._next_tag(inter, host.TAG_ALLREDUCE)
                done = host._allreduce_ring(inter, piece, op, tag)
            else:
                done = host.allreduce(inter, piece, op)
            pieces[k] = host._operand(done).reshape(-1)
            if intra.size > 1:
                # the isends under this ibcast pin `pieces[k]` until
                # drained — freshly produced per segment, never mutated
                breqs.append(nbc.ibcast(intra, pieces[k], root=0))
        wait_all(breqs)
    else:
        # member: consume the per-segment bcasts with the BLOCKING
        # binomial phase — event-blocked receives; a polling
        # SchedRequest wait per segment measurably steals scheduler
        # quanta from the producing leader on small hosts.  Wire-
        # compatible with the leader's nonblocking issue: nbc.ibcast
        # and the flat binomial bcast run the identical tree and tag
        # sequence, so each side picks the form that fits its role.
        for k in range(nseg):
            pieces[k] = host._operand(host.bcast(
                intra, None, root=0, algorithm="binomial")).reshape(-1)
    # nseg >= 2 by construction: _pipeline_geometry returns None for a
    # single-segment payload (nothing to overlap)
    return torch.cat(pieces).reshape(tuple(value.shape))


def _allreduce_numa(ctx, topo: _Topology, value: Any, op) -> Any:
    """Three-level allreduce: intra-DOMAIN reduce → intra-host
    domain-leader reduce (over the sm rings, the dleader window) →
    inter-host wire exchange among host leaders (the same segmented
    reduce-scatter+allgather schedule as two-level) → dleader bcast →
    domain bcast.  Exactly the hops that cross the wire carry exactly
    one host-reduced payload — a domains-as-hosts layout pays the full
    leader exchange among every domain leader instead."""
    dview, dlview, wview = _numa_views(ctx, topo)
    spc.record("coll_han_numa_collectives", 1)
    rank = getattr(ctx, "rank", -1)
    flightrec.record(flightrec.COLL_ENTER, op="allreduce",
                     phase="domain", sched="han3")
    with ztrace.phase_span("intra-domain", rank, op="allreduce",
                           sched="han3"):
        part = host.reduce(dview, value, op, root=0) \
            if dview.size > 1 else value
    if dlview is not None:
        if dlview.size > 1:
            with ztrace.phase_span("dleader", rank, op="allreduce",
                                   sched="han3"):
                part = host.reduce(dlview, part, op, root=0)
        if wview is not None:
            part = _leader_allreduce(wview, part, op)
        if dlview.size > 1:
            with ztrace.phase_span("dleader", rank, op="allreduce",
                                   sched="han3"):
                part = host.bcast(dlview, part, root=0,
                                  algorithm="binomial")
    if dview.size > 1:
        with ztrace.phase_span("intra-domain", rank, op="allreduce",
                               sched="han3"):
            part = host.bcast(dview, part, root=0,
                              algorithm="binomial")
    flightrec.record(flightrec.COLL_EXIT, op="allreduce",
                     phase="domain", sched="han3")
    return part


@_recorded("allreduce")
def allreduce(ctx, value: Any, op,
              groups: list[list[int]] | None = None) -> Any:
    """Two-level allreduce: intra reduce → leader allreduce → intra
    bcast.  Above ``host_coll_large_msg`` the leader exchange runs the
    split (reduce-scatter + allgather) ring explicitly — the
    bandwidth-optimal inter-node schedule, applied to exactly the hops
    that cross the wire — and, with ``coll_han_pipeline`` auto/on and
    >= 2 segments, OVERLAPS each segment's intra bcast with the next
    segment's wire exchange (the "w" pipelining).  With the NUMA level
    engaged (``coll_han_numa_level``) the schedule nests a third,
    intra-domain phase instead."""
    _require_commutative(op, "allreduce")
    topo = topology(ctx, groups)
    if _use_numa(ctx, topo, "allreduce"):
        return host._like(_allreduce_numa(ctx, topo, value, op), value)
    return host._like(_allreduce_two_level(ctx, topo, value, op), value)


def _allreduce_two_level(ctx, topo: _Topology, value: Any, op) -> Any:
    intra, inter = _views(ctx, topo)
    if str(mca_var.get("coll_han_pipeline", "auto")) != "off" \
            and len(topo.groups) >= 2:
        geom = _pipeline_geometry(len(topo.groups), value)
        if geom is not None:
            return _allreduce_pipelined(intra, inter, value, op, geom)
    rank = getattr(ctx, "rank", -1)
    with ztrace.phase_span("intra", rank, op="allreduce"):
        partial = host.reduce(intra, value, op, root=0) \
            if intra.size > 1 else value
    full = None
    if inter is not None:
        full = _leader_allreduce(inter, partial, op)
    if intra.size > 1:
        with ztrace.phase_span("intra", rank, op="allreduce"):
            full = host.bcast(intra, full, root=0,
                              algorithm="binomial")
    return full


def _leader_allreduce(inter, partial: Any, op) -> Any:
    """The inter phase of allreduce.  Below ``host_coll_large_msg`` the
    flat allreduce runs as-is (recursive doubling — 2 leaders is its
    sweet spot).  Above it, the payload takes the SPLIT schedule —
    reduce-scatter + allgather across the leaders — processed in
    ``coll_han_inter_segment`` pieces so every wire transfer stays on
    the eager zero-copy path (segments are congruent across leaders:
    the geometry derives from the reduced payload, which the reduce
    phase made identical everywhere)."""
    if inter.size <= 1:
        return partial
    flightrec.record(flightrec.COLL_ENTER, op="allreduce",
                     phase="inter")
    with ztrace.phase_span("inter-host", getattr(inter, "rank", -1),
                           op="allreduce"):
        out = _leader_allreduce_body(inter, partial, op)
    flightrec.record(flightrec.COLL_EXIT, op="allreduce",
                     phase="inter")
    return out


def _leader_allreduce_body(inter, partial: Any, op) -> Any:
    large = int(mca_var.get("host_coll_large_msg", 256 * 1024))
    if (
        not _is_array(partial)
        or partial.nbytes < large
        or _elems(partial) < inter.size
    ):
        return host.allreduce(inter, partial, op)
    seg_bytes = max(1, int(mca_var.get("coll_han_inter_segment",
                                       1 << 20)))
    shape = tuple(partial.shape)
    flat = _flat(partial)
    seg = max(inter.size, seg_bytes // max(_itemsize(partial), 1))
    if flat.numel() <= seg:
        if inter.size > 2:
            tag = host._next_tag(inter, host.TAG_ALLREDUCE)
            return host._allreduce_ring(
                inter, flat, op, tag).reshape(shape)
        return host._operand(
            host.allreduce(inter, flat, op)).reshape(shape)
    out = torch.empty_like(flat)
    for off in range(0, flat.numel(), seg):
        piece = flat[off:off + seg]
        if inter.size > 2:
            tag = host._next_tag(inter, host.TAG_ALLREDUCE)
            done = host._allreduce_ring(inter, piece, op, tag)
        else:
            done = host.allreduce(inter, piece, op)
        out[off:off + seg] = host._operand(done).reshape(-1)
    return out.reshape(shape)


# -------------------------------------------------------------- bcast


def _bcast_numa(ctx, topo: _Topology, obj: Any, root: int) -> Any:
    """Three-level bcast: root → its domain leader (domain window) →
    its host leader (dleader window) → wire bcast among host leaders →
    dleader bcast → domain bcast.  Hop tags are consumed by every
    member of the hop's window (the two-level sequence-uniformity rule
    applied per level), and the hop conditions read only global
    topology, so every rank derives the identical schedule."""
    dview, dlview, wview = _numa_views(ctx, topo)
    spc.record("coll_han_numa_collectives", 1)
    orig = obj
    h_root, d_root = topo.domain_of(root)
    root_dom = topo.nested[h_root][d_root]
    droot_leader = root_dom[0]
    host_leader = topo.groups[h_root][0]
    # hop 1: root -> its domain's leader (all members of that domain
    # consume the tag; other domains' windows stay untouched)
    if root != droot_leader and ctx.rank in root_dom:
        hoptag = host._next_tag(dview, host.TAG_BCAST)
        if ctx.rank == root:
            dview.send(obj, 0, tag=hoptag)
        elif ctx.rank == droot_leader:
            obj = dview.recv(source=dview.rel_base(root), tag=hoptag)
    # hop 2: root's domain leader -> its host's leader (all that
    # host's domain leaders consume the dleader-window tag)
    if droot_leader != host_leader and topo.gidx == h_root \
            and dlview is not None:
        hoptag = host._next_tag(dlview, host.TAG_BCAST)
        if ctx.rank == droot_leader:
            dlview.send(obj, 0, tag=hoptag)
        elif ctx.rank == host_leader:
            obj = dlview.recv(source=dlview.rel_base(droot_leader),
                              tag=hoptag)
    if wview is not None and wview.size > 1:
        obj = host.bcast(wview, obj, algorithm="binomial",
                         root=topo.leaders.index(host_leader))
    if dlview is not None and dlview.size > 1:
        obj = host.bcast(dlview, obj, root=0, algorithm="binomial")
    out = host.bcast(dview, obj, root=0, algorithm="binomial") \
        if dview.size > 1 else obj
    # the root returns ITS payload (MPI buffer semantics), never the
    # round-tripped copy the down phases delivered back to it
    return orig if ctx.rank == root else out


@_recorded("bcast")
def bcast(ctx, obj: Any = None, root: int = 0,
          groups: list[list[int]] | None = None) -> Any:
    """Two-level bcast.  The leader set is FIXED (min rank per group,
    so every rank agrees on the tag windows with no negotiation); a
    non-leader root first hands the payload to its group's leader over
    the intra window — every member of that group consumes the hop tag
    so the window's sequence stays uniform."""
    topo = topology(ctx, groups)
    if _use_numa(ctx, topo, "bcast"):
        return _bcast_numa(ctx, topo, obj, root)
    intra, inter = _views(ctx, topo)
    root_g = topo.group_of(root)
    root_leader = topo.groups[root_g][0]
    if root != root_leader and topo.gidx == root_g:
        hoptag = host._next_tag(intra, host.TAG_BCAST)
        if ctx.rank == root:
            intra.send(obj, 0, tag=hoptag)
        elif ctx.rank == root_leader:
            obj = intra.recv(source=intra.rel(root), tag=hoptag)
    if inter is not None:
        obj = host.bcast(inter, obj, algorithm="binomial",
                         root=topo.leaders.index(root_leader))
    out = host.bcast(intra, obj, root=0, algorithm="binomial") \
        if intra.size > 1 else obj
    # the root returns ITS payload (MPI buffer semantics), not the
    # round-tripped copy the intra phase delivered back to it
    return obj if ctx.rank == root and root != root_leader else out


# -------------------------------------------------------------- reduce


@_recorded("reduce")
def reduce(ctx, value: Any, op, root: int = 0,
           groups: list[list[int]] | None = None) -> Any:
    """Two-level reduce: intra reduce → leader reduce rooted at the
    root's group leader → leader→root hop.  Result significant at root
    (others return None)."""
    _require_commutative(op, "reduce")
    topo = topology(ctx, groups)
    intra, inter = _views(ctx, topo)
    root_g = topo.group_of(root)
    root_leader = topo.groups[root_g][0]
    partial = host.reduce(intra, value, op, root=0) \
        if intra.size > 1 else value
    res = None
    if inter is not None:
        res = host.reduce(inter, partial, op,
                          root=topo.leaders.index(root_leader))
    if root != root_leader and topo.gidx == root_g:
        hoptag = host._next_tag(intra, host.TAG_REDUCE)
        if ctx.rank == root_leader:
            intra.send(res, intra.rel(root), tag=hoptag)
            res = None
        elif ctx.rank == root:
            res = intra.recv(source=0, tag=hoptag)
    return host._like(res, value) if ctx.rank == root else None


# -------------------------------------------------------------- barrier


def _barrier_numa(ctx, topo: _Topology) -> None:
    """Three-level barrier: domain gather (arrival) → dleader gather →
    wire allgather among host leaders → dleader bcast → domain bcast
    (release).  No rank releases before every host's arrival reached
    the wire exchange."""
    dview, dlview, wview = _numa_views(ctx, topo)
    spc.record("coll_han_numa_collectives", 1)
    if dview.size > 1:
        host.gather(dview, b"", root=0)
    if dlview is not None:
        if dlview.size > 1:
            host.gather(dlview, b"", root=0)
        if wview is not None and wview.size > 1:
            host.allgather(wview, b"")
        if dlview.size > 1:
            host.bcast(dlview, b"", root=0, algorithm="binomial")
    if dview.size > 1:
        host.bcast(dview, b"", root=0, algorithm="binomial")


@_recorded("barrier")
def barrier(ctx, groups: list[list[int]] | None = None) -> None:
    """Two-level barrier: intra gather (arrival) → leader allgather →
    intra bcast (release) — p-1 sm hops plus the leader exchange,
    instead of log2(p) interleaved-transport dissemination rounds."""
    topo = topology(ctx, groups)
    if _use_numa(ctx, topo, "barrier"):
        return _barrier_numa(ctx, topo)
    intra, inter = _views(ctx, topo)
    if intra.size > 1:
        host.gather(intra, b"", root=0)
    if inter is not None and inter.size > 1:
        host.allgather(inter, b"")
    if intra.size > 1:
        host.bcast(intra, b"", root=0, algorithm="binomial")


# ------------------------------------------------------------ allgather


@_recorded("allgather")
def allgather(ctx, value: Any,
              groups: list[list[int]] | None = None) -> list:
    """Two-level allgather: intra gather → leader allgather (each block
    travels with its group's global rank map) → intra bcast of the
    assembled rank-indexed list."""
    topo = topology(ctx, groups)
    intra, inter = _views(ctx, topo)
    mine = host.gather(intra, value, root=0) \
        if intra.size > 1 else [value]
    out = None
    if inter is not None:
        blocks = host.allgather(inter, mine)
        out = [None] * ctx.size
        for gi, vals in enumerate(blocks):
            for g, v in zip(topo.groups[gi], vals):
                out[g] = v
    if intra.size > 1:
        out = host.bcast(intra, out, root=0, algorithm="binomial")
    return out


# -------------------------------------------------------- reduce_scatter


@_recorded("reduce_scatter")
def reduce_scatter(ctx, values: list, op,
                   groups: list[list[int]] | None = None) -> Any:
    """Two-level reduce_scatter: intra blockwise reduce → leader
    alltoall (leader j ships leader k the partials of k's group
    members) → per-block combine → intra scatter.  Rank r returns the
    fully-reduced block r."""
    _require_commutative(op, "reduce_scatter")
    if len(values) != ctx.size:
        raise errors.ArgError(
            f"reduce_scatter needs {ctx.size} blocks"
        )
    topo = topology(ctx, groups)
    intra, inter = _views(ctx, topo)
    partial = host.reduce(intra, list(values), op, root=0) \
        if intra.size > 1 else list(values)
    mine = None
    if inter is not None:
        send = [[partial[g] for g in topo.groups[k]]
                for k in range(len(topo.groups))]
        got = _leader_alltoall(inter, send)
        mine = got[0]
        for j in range(1, len(got)):
            mine = [host._combine(op, a, b)
                    for a, b in zip(mine, got[j])]
    out = host.scatter(intra, mine, root=0) if intra.size > 1 else mine[0]
    return host._like(out, values[ctx.rank])


# --------------------------------------------------------------- alltoall


mca_var.register(
    "coll_han_alltoall_bruck_min", 8,
    "Leader count at which the han alltoall family's wire exchange "
    "switches from pairwise (one aggregated message per leader pair, "
    "p-1 rounds) to Bruck store-and-forward (ceil(log2 p) rounds, "
    "each forwarding up to half the aggregated blocks); 0 pins "
    "pairwise at every leader count",
    type=int,
)


def _leader_exchange_alg(inter) -> str:
    """Wire-exchange decision of the han alltoall family's leader
    phase: "pairwise" below ``coll_han_alltoall_bruck_min`` leaders,
    "bruck" at or above the bar.  Degrades loudly, never raises:
    a malformed bar falls back to the registered default."""
    try:
        bar = int(mca_var.get("coll_han_alltoall_bruck_min", 8))
    except (TypeError, ValueError):
        mca_output.verbose(
            2, _stream,
            "coll_han_alltoall_bruck_min is not an integer; the "
            "default bar (8) applies",
        )
        bar = 8
    return "bruck" if bar > 0 and getattr(inter, "size", 0) >= bar \
        else "pairwise"


def _leader_alltoall(inter, send: list) -> list:
    """The aggregated leader exchange shared by alltoall/alltoallv and
    reduce_scatter's leader phase: each wire message carries a whole
    per-host block aggregate instead of the flat path's one message
    per cross-host RANK pair.  ``coll_han_alltoall_inter_bytes``
    accounts the payload this leader hands to the wire (its own block
    excluded); ``coll_han_alltoall_leader_msgs`` the wire messages it
    issues."""
    n, rank = inter.size, inter.rank
    spc.record(
        "coll_han_alltoall_inter_bytes",
        sum(payload_bytes(send[j]) for j in range(n) if j != rank),
    )
    if _leader_exchange_alg(inter) == "bruck":
        spc.record("coll_han_alltoall_leader_msgs",
                   max(0, (n - 1).bit_length()))
        tag = host._next_tag(inter, host.TAG_ALLTOALL)
        return host._alltoall_bruck(inter, list(send), tag)
    spc.record("coll_han_alltoall_leader_msgs", max(0, n - 1))
    return host.alltoall(inter, send)


def _alltoall_blocks(ctx, topo: _Topology, blocks: list) -> list:
    """The shared three-phase block schedule: intra gather of each
    member's full rank-indexed send list to its leader → leader j
    ships leader k the [src-in-j × dst-in-k] block matrix through
    ``_leader_alltoall`` → intra scatter of each member's reassembled
    rank-indexed receive list.  Intra traffic grows (every list rides
    the sm rings twice) to buy the wire aggregation — the han trade."""
    intra, inter = _views(ctx, topo)
    spc.record("coll_han_alltoall_collectives", 1)
    rank = getattr(ctx, "rank", -1)
    with ztrace.phase_span("intra", rank, op="alltoall"):
        lists = host.gather(intra, blocks, root=0) \
            if intra.size > 1 else [blocks]
    recv_lists = None
    if inter is not None:
        members = topo.groups[topo.gidx]
        send = [[[lists[si][d] for d in topo.groups[k]]
                 for si in range(len(members))]
                for k in range(len(topo.groups))]
        flightrec.record(flightrec.COLL_ENTER, op="alltoall",
                         phase="inter")
        with ztrace.phase_span("inter-host", getattr(inter, "rank", -1),
                               op="alltoall"):
            got = _leader_alltoall(inter, send)
        flightrec.record(flightrec.COLL_EXIT, op="alltoall",
                         phase="inter")
        # got[j][si][di]: the block global rank topo.groups[j][si] sent
        # to the di-th member of MY group — reassemble one rank-indexed
        # receive list per member
        recv_lists = []
        for di in range(len(members)):
            out: list = [None] * ctx.size
            for j, srcs in enumerate(topo.groups):
                for si, src in enumerate(srcs):
                    out[src] = got[j][si][di]
            recv_lists.append(out)
    elif len(topo.groups) == 1 and getattr(intra, "rank", -1) == 0:
        # forced single-group topology: no wire phase — the leader
        # holds every member's list already
        members = topo.groups[0]
        recv_lists = []
        for di in range(len(members)):
            out = [None] * ctx.size
            for si, src in enumerate(members):
                out[src] = lists[si][members[di]]
            recv_lists.append(out)
    if intra.size > 1:
        with ztrace.phase_span("intra", rank, op="alltoall"):
            return host.scatter(intra, recv_lists, root=0)
    return recv_lists[0]


@_recorded("alltoall")
def alltoall(ctx, values: list,
             groups: list[list[int]] | None = None) -> list:
    """Two-level alltoall: see ``_alltoall_blocks``.  ``values`` is the
    rank-indexed send list; returns the rank-indexed receive list (the
    flat contract of ``coll/host.py``)."""
    if len(values) != ctx.size:
        raise errors.ArgError(f"alltoall needs {ctx.size} blocks")
    topo = topology(ctx, groups)
    return _alltoall_blocks(ctx, topo, list(values))


@_recorded("alltoallv")
def alltoallv(ctx, sendbuf, counts: list, displs: list | None = None,
              groups: list[list[int]] | None = None) -> list:
    """Two-level alltoallv: the flat (counts, displs) slicing of
    ``coll/host.py`` feeds the shared block schedule — variable-size
    blocks ride the aggregated leader exchange unchanged (host-plane
    objects carry their own size)."""
    blocks = host._blocks_from(sendbuf, counts, displs, ctx.size)
    topo = topology(ctx, groups)
    return _alltoall_blocks(ctx, topo, blocks)
