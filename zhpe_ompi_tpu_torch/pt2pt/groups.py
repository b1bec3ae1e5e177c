"""Locality groups — the topology layer under the hierarchical (han)
host collectives (namesake: ``zhpe_ompi_tpu/pt2pt/groups.py``; the port's
own copy).

The reference's ``coll/han`` splits every collective into an intra-node
phase and an inter-node phase among one leader per node (Luo et al.,
"HAN: a Hierarchical AutotuNed Collective Communication Framework",
IEEE Cluster 2020).  Its topology input is the proc locality the RTE
publishes; ours is the ``(boot_id, segment)`` card the shared-memory
transport (``pt2pt/sm.py``) advertises on the modex — two ranks with
equal boot tokens are provably one ``/dev/shm`` namespace, i.e. one
host.  This module derives those **locality groups** and exposes a
:class:`GroupView`: a lightweight sub-endpoint over any endpoint's
``rank``/``size``/``send``/``recv``/``sendrecv`` surface with

- **relative ranks** — members renumbered densely 0..m-1, so the flat
  algorithms in ``coll/host.py`` run on a subgroup unchanged;
- **a disjoint tag window** — every view translates its traffic onto a
  per-window cid (``_HAN_CID_BASE + window``) with a per-window
  collective sequence kept ON the parent endpoint, so concurrent
  subgroup collectives (each host's intra phase runs at the same time)
  and interleaved parent-level flat collectives can never cross-match;
- **phase accounting** — every send records its payload bytes into
  ``coll_han_intra_bytes``, ``coll_han_dleader_bytes`` or
  ``coll_han_inter_bytes``.

Because a view only *translates*, the transport fast paths arrive through
the send seam: an intra-phase send between same-boot ranks rides the
mmap rings, a leader-phase send rides the wire.  The cids, tag windows
and message order are the namesake's, so a view's traffic means the same
to a JAX-package rank.

Fault tolerance waits for ``ft/ulfm.py``: the port's endpoints carry no
``FailureState``, so a view registers no revoke alias (the hook is kept
for when one appears).

Hygiene: window registrations are tracked per endpoint; a closed
endpoint (``TcpProc.close`` calls :func:`release`) must hold none —
:func:`leaked_tag_windows` is the gate's view, and
:func:`live_election_threads` guards that leader election stays the
deterministic min-rank rule (no thread may ever outlive it).
"""


from __future__ import annotations

import threading
import weakref
from typing import Any

from ..coll.host import COLL_CID
from ..core import errors
from ..runtime import spc
from ..utils.payload import payload_size_estimate as payload_bytes
from . import sm as sm_mod

# One cid per tag window: groups 0..253 plus the leader window.  The
# whole span sits below every control/collective cid in use (user cids
# are small, COLL_CID/barrier live at 0x7FF0+) and within 16 bits, so a
# view over a ShrunkEndpoint survives the generation translation
# (_shrink_cid masks cid & 0xFFFF).
_HAN_CID_BASE = 0x7900
_HAN_WINDOWS = 0x100
LEADER_WINDOW = _HAN_WINDOWS - 1  # the inter-phase (leader) window
MAX_GROUPS = LEADER_WINDOW       # group i owns window i (two-level)

# three-level (NUMA) window partition.  A window id's tag sequence is
# uniform only among ONE member set, so every window range must be
# DISJOINT from every other range that can coexist on an endpoint:
# host windows (two-level intra; also the three-level nesting parent)
# keep 0..0x3F, intra-DOMAIN views own DOMAIN_WINDOW_BASE + global
# domain index, each host's domain-leader exchange owns
# HOST_LEADER_BASE + host index, and the inter-host leader window
# stays LEADER_WINDOW.  A topology too large for the partition is not
# NUMA-viable and runs two-level (which alone may still use the full
# 0..MAX_GROUPS-1 span — no domain windows exist to collide with).
DOMAIN_WINDOW_BASE = 0x40
DOMAIN_WINDOWS = 0x40                        # <= 64 domains total
HOST_LEADER_BASE = 0x80
MAX_HOSTS_NESTED = DOMAIN_WINDOW_BASE        # <= 64 hosts when nested

#: plane -> SPC byte counter of a GroupView's send seam ("dleader" is
#: the three-level intra-host leader exchange — same-host sm traffic,
#: accounted apart from both the domain phase and the wire phase)
PLANE_COUNTERS = {
    "intra": "coll_han_intra_bytes",
    "inter": "coll_han_inter_bytes",
    "dleader": "coll_han_dleader_bytes",
}

# endpoint -> set of registered window ids (weak: a collected endpoint
# takes its registrations with it); the leak gate inspects what is left
_reg_lock = threading.Lock()
_registrations: "weakref.WeakKeyDictionary[Any, set[int]]" = \
    weakref.WeakKeyDictionary()

# leader election is the deterministic min-rank rule — no threads, by
# design.  The registry exists so the hygiene gate keeps asserting that
# if an asynchronous election ever lands, its threads cannot leak.
_election_threads: list[threading.Thread] = []


def boot_token_of(ep, rank: int) -> str | None:
    """Locality identity of ``rank`` on ``ep``: endpoints expose
    ``boot_token_of`` (TcpProc reads the modex cards, thread ranks are
    one process, shrunk endpoints translate to their parent); None =
    unknown, grouped as its own singleton locality."""
    fn = getattr(ep, "boot_token_of", None)
    if fn is None:
        return None
    return fn(rank)


def numa_token_of(ep, rank: int):
    """NUMA-domain identity of ``rank`` on ``ep``: the token string,
    ``None`` when unknown (old cards, sm=0 peers — the host degrades
    to one domain), or :data:`~zhpe_ompi_tpu_torch.pt2pt.sm.NUMA_MALFORMED`.
    Exception-safe by contract: a malformed FOREIGN card must never
    raise out of a collective's topology derivation — it is counted
    and demoted to the sentinel instead."""
    fn = getattr(ep, "numa_token_of", None)
    if fn is None:
        return None
    try:
        return fn(rank)
    except Exception:  # noqa: BLE001 - foreign-card robustness
        return sm_mod.NUMA_MALFORMED


def locality_groups(ep, nested: bool = False):
    """Same-host groups of ``ep``'s ranks, derived from the modex boot
    tokens: a list of ascending-rank member lists, ordered by leader
    (minimum) rank.  Ranks with no provable locality (no card, sm=0
    peers, C ranks, rejoiners) are their own singleton group — han then
    treats them as one-rank hosts, which is always correct and merely
    forgoes an intra phase for them.

    With ``nested=True`` the structure gains the NUMA level: each host
    entry becomes a list of DOMAIN member-lists (ordered by domain
    leader), derived from the ``pynuma:`` card tokens.  The derivation
    ladder per rank: token present → its domain; token absent (old
    card) → the host's single default domain; token malformed →
    counted (``han_malformed_numa_cards``) and demoted to a singleton
    domain.  It never raises — a host whose members advertise no
    usable tokens is simply one domain, i.e. exactly the two-level
    structure."""
    size = getattr(ep, "size", 1)
    by_token: dict[str, list[int]] = {}
    groups: list[list[int]] = []
    for r in range(size):
        tok = boot_token_of(ep, r)
        if tok is None:
            groups.append([r])
            continue
        members = by_token.get(tok)
        if members is None:
            members = by_token[tok] = [r]
            groups.append(members)
        else:
            members.append(r)
    groups.sort(key=lambda g: g[0])
    if not nested:
        return groups
    out: list[list[list[int]]] = []
    for g in groups:
        if len(g) == 1:
            out.append([list(g)])
            continue
        by_dom: dict[str, list[int]] = {}
        domains: list[list[int]] = []
        for r in g:
            tok = numa_token_of(ep, r)
            if tok is sm_mod.NUMA_MALFORMED:
                spc.record("han_malformed_numa_cards", 1)
                domains.append([r])  # singleton domain, never a raise
                continue
            if tok is None:
                tok = ""  # absent: the host's shared default domain
            members = by_dom.get(tok)
            if members is None:
                members = by_dom[tok] = [r]
                domains.append(members)
            else:
                members.append(r)
        domains.sort(key=lambda d: d[0])
        out.append(domains)
    return out


def _ft_state(ep):
    """Nearest FailureState up the endpoint chain (ShrunkEndpoint and
    views wrap their parent; the state lives on the transport)."""
    seen = 0
    while ep is not None and seen < 8:
        state = getattr(ep, "ft_state", None)
        if state is not None:
            return state
        ep = getattr(ep, "_ep", None)
        seen += 1
    return None


def _window_seqs(ep) -> dict[int, int]:
    """Per-window collective sequence counters, kept on the ENDPOINT so
    re-created views over the same window continue the tag sequence
    (the reason two successive han collectives can never cross-match
    even though each built its views afresh)."""
    seqs = getattr(ep, "_han_window_seqs", None)
    if seqs is None:
        seqs = {}
        ep._han_window_seqs = seqs
    return seqs


def _transport_of(ep):
    """The close-owning endpoint under any wrapper chain (fault
    injection proxies, shrunk endpoints, nested views all expose the
    parent as ``_ep``): window registrations must key on the object
    whose ``close()`` releases them, or the hygiene gate would flag
    wrappers nobody closes."""
    seen = 0
    while seen < 8:
        inner = getattr(ep, "_ep", None)
        if inner is None:
            return ep
        ep = inner
        seen += 1
    return ep


def _register(ep, window: int) -> None:
    owner = _transport_of(ep)
    with _reg_lock:
        wids = _registrations.get(owner)
        if wids is None:
            wids = set()
            _registrations[owner] = wids
        wids.add(window)


def release(ep) -> None:
    """Drop every tag-window registration of ``ep`` (called from the
    endpoint's close(); thread-plane endpoints release by GC)."""
    with _reg_lock:
        _registrations.pop(ep, None)


def leaked_tag_windows() -> list[str]:
    """Window registrations whose endpoint is already CLOSED — the
    hygiene gate's view (an open endpoint legitimately keeps its
    windows for its next collective)."""
    with _reg_lock:
        items = list(_registrations.items())
    out = []
    for ep, wids in items:
        closed = getattr(ep, "_closed", None)
        if closed is not None and closed.is_set():
            out.append(f"{type(ep).__name__}(rank={getattr(ep, 'rank', '?')})"
                       f":windows={sorted(wids)}")
    return sorted(out)


def live_election_threads() -> list[str]:
    """Leader-election threads still alive — [] by construction (the
    min-rank rule is synchronous); asserted by the session gate."""
    _election_threads[:] = [t for t in _election_threads if t.is_alive()]
    return [t.name for t in _election_threads]


class GroupView:
    """Sub-endpoint over one locality group (or a leader set): the
    flat host-plane algorithms run on it unchanged while the traffic
    stays inside a disjoint tag window of the parent endpoint.

    ``plane`` is ``"intra"``, ``"dleader"`` or ``"inter"`` — it selects
    the SPC byte counter and documents which han phase the view
    carries.

    A view may be built OVER ANOTHER VIEW (the three-level NUMA
    schedule nests its domain views inside the host view): ``members``
    are then ranks of that parent view, and the nested view flattens
    the chain — its traffic translates straight onto the BASE endpoint
    with the nested view's OWN window cid (never the parent's), its
    per-window sequence lives on the base endpoint (recreated nested
    views continue the sequence), and its window registration keys on
    the close-owning transport.  ``rel``/``parent_rank`` stay
    parent-relative; ``base_rank``/``rel_base`` translate to the base
    endpoint."""

    # coll/host.py's han seam checks this to re-enter the FLAT
    # algorithms for phase traffic (no recursive hierarchy)
    _han_subview = True

    def __init__(self, ep, members: list[int], window: int,
                 plane: str = "intra"):
        if ep.rank not in members:
            raise errors.ArgError(
                f"rank {ep.rank} building a view it is not a member of "
                f"({members})"
            )
        self._parent = ep
        self._pmembers = list(members)      # view rank -> parent rank
        self._pinv = {g: i for i, g in enumerate(self._pmembers)}
        if isinstance(ep, GroupView):
            # view-of-view: collapse to the base endpoint so nested
            # phases pay ONE translation, not a tower — and so the
            # window cid on the wire is this view's, not the parent's
            base = ep._ep
            base_members = [ep._members[m] for m in members]
        else:
            base = ep
            base_members = list(members)
        self._ep = base
        self._members = base_members        # view rank -> base rank
        self._inv = {g: i for i, g in enumerate(self._members)}
        self.rank = self._inv[base.rank]
        self.size = len(self._members)
        self._window = int(window) % _HAN_WINDOWS
        self._cid = _HAN_CID_BASE + self._window
        self._plane = plane
        self._bytes_counter = PLANE_COUNTERS.get(
            plane, "coll_han_intra_bytes")
        self._seqs = _window_seqs(base)
        state = _ft_state(base)
        if state is not None and hasattr(state, "alias_cid"):
            # revoke(COLL_CID) must poison the window's parked and
            # future operations exactly like the flat path's
            state.alias_cid(self._cid, COLL_CID)
        _register(base, self._window)

    # -- per-window collective sequence (read/written by coll/host's
    # _next_tag through the ordinary attribute protocol) ----------------

    @property
    def _coll_seq(self) -> int:
        return self._seqs.get(self._window, 0)

    @_coll_seq.setter
    def _coll_seq(self, value: int) -> None:
        self._seqs[self._window] = value

    # -- nonblocking-schedule support (coll/nbc over a view) -------------

    @property
    def ft_state(self):
        """Nearest FailureState up the parent chain (None on non-ft
        endpoints): an nbc schedule running on a view stays
        revoke-aware — its window cid is aliased to COLL_CID, so the
        schedule's revocation checks resolve through the same alias
        machinery as the blocking phases'."""
        return _ft_state(self._ep)

    def progress(self) -> None:
        """Drive the parent's progress engine (thread-plane mailbox
        delivery); socket endpoints progress from their drain threads
        and this is a no-op."""
        fn = getattr(self._ep, "progress", None)
        if fn is not None:
            fn()

    # -- translation helpers ---------------------------------------------

    def rel(self, parent_rank: int) -> int:
        """View rank of a PARENT rank (ArgError for non-members) — the
        parent is whatever the view was built over, another view
        included."""
        try:
            return self._pinv[parent_rank]
        except KeyError:
            raise errors.ArgError(
                f"parent rank {parent_rank} is not a member of this view"
            ) from None

    def parent_rank(self, view_rank: int) -> int:
        return self._pmembers[view_rank]

    def base_rank(self, view_rank: int) -> int:
        """Rank of a view member on the BASE endpoint (== parent_rank
        unless this view was built over another view)."""
        return self._members[view_rank]

    def rel_base(self, base_rank: int) -> int:
        """View rank of a base-endpoint rank (ArgError for
        non-members) — the inverse of :meth:`base_rank`."""
        try:
            return self._inv[base_rank]
        except KeyError:
            raise errors.ArgError(
                f"base rank {base_rank} is not a member of this view"
            ) from None

    def boot_token_of(self, rank: int) -> str | None:
        return boot_token_of(self._ep, self._members[rank])

    def _xsrc(self, source: int) -> int:
        return source if source == -1 else self._members[source]

    # -- endpoint surface (the coll/host contract) -----------------------

    def send(self, obj: Any, dest: int, tag: int = 0, cid: int = 0) -> None:
        spc.record(self._bytes_counter, payload_bytes(obj))
        self._ep.send(obj, self._members[dest], tag, self._cid)

    def isend(self, obj: Any, dest: int, tag: int = 0, cid: int = 0):
        spc.record(self._bytes_counter, payload_bytes(obj))
        return self._ep.isend(obj, self._members[dest], tag, self._cid)

    def recv(self, source: int = -1, tag: int = -1, cid: int = 0,
             timeout: float | None = None, return_status: bool = False):
        out = self._ep.recv(self._xsrc(source), tag, self._cid,
                            timeout=timeout, return_status=return_status)
        if return_status:
            value, status = out
            if status.source >= 0:
                status.source = self._inv.get(status.source, -1)
            return value, status
        return out

    def irecv(self, source: int = -1, tag: int = -1, cid: int = 0):
        return self._ep.irecv(self._xsrc(source), tag, self._cid)

    def sendrecv(self, obj: Any, dest: int, source: int = -1,
                 sendtag: int = 0, recvtag: int = -1, cid: int = 0):
        spc.record(self._bytes_counter, payload_bytes(obj))
        return self._ep.sendrecv(obj, self._members[dest],
                                 source=self._xsrc(source),
                                 sendtag=sendtag, recvtag=recvtag,
                                 cid=self._cid)

    def __repr__(self):  # pragma: no cover
        return (f"GroupView({self._plane}, rank={self.rank}/{self.size}, "
                f"parents={self._members}, window={self._window:#x})")
