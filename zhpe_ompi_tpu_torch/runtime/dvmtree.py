"""Multi-host DVM tree — the routed half of the PRRTE analog (namesake:
``zhpe_ompi_tpu/runtime/dvmtree.py``; the port's own copy).

One :mod:`.dvm` is ONE resident daemon: every rank of every job
modexes into one PMIx listener, every fault event fans out of one
socket, and launch traffic scales O(n) into one accept loop.  PRRTE's
whole value is that it is a *routed tree* of daemons — one ``prted``
per host, parent/child links, launch/modex/fault traffic climbing and
descending the tree so no single socket sees more than its subtree.
This module is that layer:

- **routed store** (:class:`RoutedStore`): a child daemon's store-verb
  surface.  Writes (``put``/``commit``/``fence``/``mkns``/…) forward UP
  the tree to the root's authoritative :class:`~zhpe_ompi_tpu_torch.runtime.
  pmix.PmixStore`; reads (``get``) serve from a leaf-local cache, so a
  rank only ever talks to ITS host's daemon and the root's listener
  sees one fetch per (daemon, key) instead of one per (rank, key).
  Cache coherence rides the store's generation machinery: published
  entries are immutable within a namespace generation (the store
  contract — republishing a key is always preceded by a generation
  bump, e.g. a respawn window), and generation bumps ride the parent
  link DOWN the tree as invalidations (:meth:`RoutedStore.
  invalidate_ns`).  ``lookup`` (the non-blocking introspection verb —
  metrics, resize events) always forwards: its keys are mutable.
- **tree links**: a child daemon holds ONE persistent connection to its
  parent's control port (:class:`TreeLink`) — ``["up", kind, payload]``
  frames climb (IOF, exit accounting, daemon membership), ``["down",
  kind, payload]`` frames descend (spawn commands, fault floods,
  generation invalidations).  The parent half (:class:`ChildLink`)
  lives inside the parent daemon's attach handler.
- **tree shape** (:func:`plan_tree`): parent assignment per
  ``dvm_tree_fanout`` — ``f >= 1`` builds the classic fanout-f tree
  (daemon ``i``'s parent is ``(i-1)//f``), ``f <= 0`` the flat star
  (every child attaches straight to the root).
- **harness** (:func:`spawn_tree`): build an n-daemon tree in-process
  (tests, thread-fast) or as real ``zprted --parent`` OS processes
  (the kill-a-daemon drill, the launch-latency ladder's depth rows).

Counters (documented in :mod:`zhpe_ompi_tpu_torch.runtime.spc`):
``dvm_tree_forwards`` (verbs a child pushed up), ``dvm_store_cache_hits``
(gets served leaf-locally); the two move in opposite directions at
depth >= 1.

Hygiene is observable: every routed store registers weakly and
:func:`stale_cache_state` must be empty at session end — a closed
child daemon holds no cached keys, and no routed store outlives its
daemon.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import weakref
from typing import Any, Callable

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from . import pmix as pmix_mod
from . import spc

_stream = mca_output.open_stream("dvmtree")

mca_var.register(
    "dvm_tree_fanout", 2,
    "Children per daemon when building a DVM tree (plan_tree/"
    "spawn_tree): f >= 1 is the fanout-f tree (daemon i's parent is "
    "(i-1)//f), f <= 0 the flat star (every child attaches straight "
    "to the root)",
    type=int,
)

mca_var.register(
    "dvm_store_cache_ttl", 0.0,
    "Age bound (seconds) on a child daemon's leaf-local store cache "
    "entries; 0 (the default) trusts generation invalidations alone — "
    "published keys are immutable within a namespace generation, so "
    "expiry is only a belt-and-braces bound for foreign stores that "
    "break that contract",
    type=float,
)

_live_routed: weakref.WeakSet = weakref.WeakSet()


def stale_cache_state() -> list[str]:
    """Routed-store cache state still held at session end — a closed
    store holds nothing, and no store may outlive its daemon's stop()
    (the session gate's view)."""
    out = []
    for store in list(_live_routed):
        if store.open:
            out.append(f"routed-store:{store.parent[0]}:{store.parent[1]}"
                       ":still-open")
            continue
        keys = store.cached_keys()
        if keys:
            out.append(
                f"routed-store:{store.parent[0]}:{store.parent[1]}:"
                f"{len(keys)} cached keys past close()")
    return out


def plan_tree(n: int, fanout: int | None = None) -> list[int | None]:
    """Parent INDEX per daemon for an n-daemon tree (index 0 is the
    root, parent ``None``).  ``fanout`` defaults to the
    ``dvm_tree_fanout`` MCA var; ``<= 0`` means flat star."""
    f = int(mca_var.get("dvm_tree_fanout", 2)) if fanout is None \
        else int(fanout)
    out: list[int | None] = [None]
    for i in range(1, max(1, int(n))):
        out.append(0 if f <= 0 else (i - 1) // f)
    return out


def block_placement(ranks: list[int], daemons: list[str]
                    ) -> dict[int, str]:
    """Contiguous near-even blocks of ``ranks`` over ``daemons`` (the
    by-host placement PRRTE's round-robin-by-node defaults to for
    dense jobs): rank r lands on ``daemons[(i * len(daemons)) //
    len(ranks)]`` for its position i."""
    if not daemons:
        raise errors.InternalError("dvm tree: no daemons to place on")
    n = len(ranks)
    return {
        r: daemons[(i * len(daemons)) // n]
        for i, r in enumerate(sorted(int(r) for r in ranks))
    }


# -- multi-tenant placement -------------------------------------------------

#: the placement ladder: every policy degrades to the one before it
#: when the tree is too small, never the other way around
PLACEMENT_POLICIES = ("pack", "spread", "exclusive")

mca_var.register(
    "dvm_placement", "pack",
    "Multi-tenant placement policy for daemon-tree jobs: 'pack' "
    "block-places over all daemons in attach order (the single-tenant "
    "default), 'spread' block-places over the daemons ordered "
    "least-loaded first (co-tenants naturally claim different "
    "subtrees while capacity allows), 'exclusive' claims only "
    "daemons no live job uses and fails over to spread — loudly, "
    "counted in dvm_placement_fallbacks — when none are free; a "
    "launch spec's placement= overrides per job",
)


def place_job(ranks: list[int], daemons: list[str],
              busy: dict[str, int], policy: str
              ) -> tuple[dict[int, str], bool]:
    """Placement for one new job under the multi-tenant ladder.

    ``busy`` maps daemon id -> count of LIVE jobs already placed on it
    (the root computes it from its job table).  Returns ``(placement,
    fell_back)`` — ``fell_back`` is True only for an exclusive request
    that found no free daemon and degraded to spread (the caller
    reports it loudly and counts ``dvm_placement_fallbacks``).

    - ``pack``: :func:`block_placement` over attach order — dense,
      single-tenant shape, co-tenants overlap.
    - ``spread``: block placement over the first ``len(ranks)``
      daemons sorted least-loaded first (ties broken by attach
      order).  The minimal claim is the point: a k-rank job touches
      only the k least-loaded daemons, so two spread tenants land on
      disjoint subtrees whenever there are enough daemons — claiming
      the whole load order (an earlier draft) put rank k-1 back onto
      a busy daemon and broke exactly that.
    - ``exclusive``: place ONLY on daemons with zero live jobs,
      claiming the minimal prefix (len(ranks) at most) so successive
      exclusive tenants can coexist; no free daemon at all means
      fallback to spread.
    """
    policy = str(policy or "pack")
    if policy not in PLACEMENT_POLICIES:
        raise errors.ArgError(
            f"dvm placement: unknown policy {policy!r} "
            f"(one of {'/'.join(PLACEMENT_POLICIES)})")
    if not daemons:
        raise errors.InternalError("dvm tree: no daemons to place on")
    if policy == "pack":
        return block_placement(ranks, daemons), False
    order = {d: i for i, d in enumerate(daemons)}
    by_load = sorted(daemons,
                     key=lambda d: (busy.get(d, 0), order[d]))
    if policy == "spread":
        return block_placement(
            ranks, by_load[:max(1, len(ranks))]), False
    free = [d for d in by_load if busy.get(d, 0) == 0]
    if not free:
        return block_placement(ranks, by_load), True
    return block_placement(ranks, free[:max(1, len(ranks))]), False


_audit_failures: list[str] = []
_audit_lock = threading.Lock()


def placement_audit_failures() -> list[str]:
    """Recorded placement-audit violations — must be [] at session end
    : an audit failure means two live jobs were
    about to share sm-segment prefixes, namespaces, or an exclusive
    subtree, and the offending launch was failed loudly."""
    with _audit_lock:
        return list(_audit_failures)


def clear_placement_audit_failures() -> None:
    with _audit_lock:
        _audit_failures.clear()


def _sessions_collide(a: str, b: str) -> bool:
    # the /dev/shm sweep keys on "<prefix>_{session}_": equality OR a
    # prefix-with-underscore relation would let one job's sweep (or
    # segment namespace) reach the other's files
    return a == b or b.startswith(a + "_") or a.startswith(b + "_")


def audit_placement(new_job: dict, live_jobs: list[dict]) -> None:
    """Per-job placement audit at admission: prove the new job's
    runtime state is disjoint from every LIVE co-tenant's.

    Each job dict carries ``id`` (the PMIx namespace — cid windows are
    coordinated per namespace, so distinct ids imply disjoint cid
    state), ``session`` (the sm-segment / sweep prefix tag) and
    ``daemons`` (the placed daemon set) plus ``exclusive`` (the job
    demanded — and got — an exclusive subtree).  A violation is typed
    (:class:`~zhpe_ompi_tpu_torch.core.errors.PlacementViolation`), recorded
    for the session gate, counted (``dvm_placement_audit_failures``),
    and raised so the launch fails loudly instead of admitting a
    tenant that could corrupt a neighbour."""
    for other in live_jobs:
        if other["id"] == new_job["id"]:
            viol = errors.PlacementViolation(
                f"placement audit: job id/namespace {new_job['id']!r} "
                "already live (cid windows would collide)",
                jobs=(new_job["id"], other["id"]), prop="namespace")
        elif _sessions_collide(str(new_job["session"]),
                               str(other["session"])):
            viol = errors.PlacementViolation(
                f"placement audit: session tag {new_job['session']!r} "
                f"collides with live job {other['id']!r}'s "
                f"{other['session']!r} (sm segments / shm sweep would "
                "cross tenants)",
                jobs=(new_job["id"], other["id"]), prop="session")
        elif (new_job.get("exclusive") or other.get("exclusive")) \
                and set(new_job["daemons"]) & set(other["daemons"]):
            shared = sorted(set(new_job["daemons"])
                            & set(other["daemons"]))
            viol = errors.PlacementViolation(
                f"placement audit: exclusive subtree violated — jobs "
                f"{new_job['id']!r}/{other['id']!r} share daemons "
                f"{shared}",
                jobs=(new_job["id"], other["id"]), prop="subtree")
        else:
            continue
        with _audit_lock:
            _audit_failures.append(str(viol))
        spc.record("dvm_placement_audit_failures")
        raise viol


class RoutedStore:
    """Store-verb surface of a CHILD daemon: same method signatures as
    :class:`~zhpe_ompi_tpu_torch.runtime.pmix.PmixStore` (so a
    ``PmixServer`` serves ranks from either), but writes forward UP to
    the parent and ``get`` serves a leaf-local cache.

    Forwarding is per-calling-thread (one persistent
    :class:`~zhpe_ompi_tpu_torch.runtime.pmix.PmixClient` per handler
    thread): a blocking verb — a rank's modex ``fence`` parked at the
    root until the whole namespace enters — parks only ITS handler
    thread's upstream connection, never another rank's ``get``.

    Cache-miss fetches are SINGLE-FLIGHT per (ns, key): concurrent
    first readers of one key coalesce into one upward fetch, and the
    waiters count as cache hits once it lands — the hit/forward
    counters the launch ladder gates on are deterministic, not
    scheduling noise.
    """

    def __init__(self, parent_pmix: "tuple[str, int] | str",
                 timeout: float = 30.0):
        self.parent = pmix_mod.parse_addr(parent_pmix)
        self._timeout = timeout
        self.open = True
        # ns -> key -> (generation, value, cached_at, fill_floor)
        self._cache: dict[
            str, dict[str, tuple[int, Any, float, int]]] = {}
        # ns -> highest namespace generation this daemon has LEARNED
        # (gen-carrying invalidations + observed fill tags).  Entries
        # filled under an older floor are never served again: a
        # respawn's republished card can overwrite a key at the root,
        # and a warm leaf entry fetched before the bump would otherwise
        # keep serving the corpse incarnation's value to default-
        # min_generation getters (the respawn race, through the tree path)
        self._ns_gen: dict[str, int] = {}
        self._fetching: set[tuple[str, str]] = set()
        self._cv = threading.Condition()
        self._tls = threading.local()
        self._clients: list[pmix_mod.PmixClient] = []
        self._clients_lock = threading.Lock()
        _live_routed.add(self)

    # -- upstream plumbing ------------------------------------------------

    def _up(self) -> pmix_mod.PmixClient:
        cli = getattr(self._tls, "client", None)
        if cli is None:
            cli = pmix_mod.PmixClient(self.parent, timeout=self._timeout)
            self._tls.client = cli
            with self._clients_lock:
                self._clients.append(cli)
        return cli

    def _forward(self, verb: str, *args, **kw) -> Any:
        if not self.open:
            raise errors.InternalError(
                "routed store closed (daemon stopping)")
        spc.record("dvm_tree_forwards")
        return getattr(self._up(), verb)(*args, **kw)

    # -- cached read path -------------------------------------------------

    def get(self, ns: str, key: str, timeout: float = 30.0,
            min_generation: int = 0) -> Any:
        value, _gen = self.get_meta(ns, key, timeout, min_generation)
        return value

    def get_meta(self, ns: str, key: str, timeout: float = 30.0,
                 min_generation: int = 0) -> tuple[Any, int]:
        """Blocking get-until-published with the leaf cache in front:
        a fresh-enough cached entry is served locally
        (``dvm_store_cache_hits``); a miss forwards up
        (``dvm_tree_forwards``) and caches the result.  ``min_generation``
        is honored against the cached entry's tag — a recovery window's
        insistence on a fresh card can never be satisfied by the
        corpse's cached one."""
        ns, key = str(ns), str(key)
        ttl = float(mca_var.get("dvm_store_cache_ttl", 0.0))
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                floor = self._ns_gen.get(ns, 0)
                hit = self._cache.get(ns, {}).get(key)
                if hit is not None and hit[0] >= int(min_generation) \
                        and hit[3] >= floor \
                        and (ttl <= 0
                             or time.monotonic() - hit[2] <= ttl):
                    spc.record("dvm_store_cache_hits")
                    spc.record("store_leaf_cache_hits")
                    return hit[1], hit[0]
                if not self.open:
                    raise errors.InternalError(
                        "routed store closed (daemon stopping)")
                if (ns, key) not in self._fetching:
                    self._fetching.add((ns, key))
                    fill_floor = floor
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise errors.InternalError(
                        f"routed get({ns!r}, {key!r}): in-flight fetch "
                        f"did not land within {timeout}s")
                self._cv.wait(min(left, 0.25))
        try:
            # the forward happens OUTSIDE the cache lock: a parked
            # get-until-published upstream must never wedge local hits
            spc.record("dvm_tree_forwards")
            spc.record("store_leaf_cache_misses")
            value, gen = self._up().get_meta(ns, key, timeout,
                                             min_generation)
        except BaseException:
            with self._cv:
                self._fetching.discard((ns, key))
                self._cv.notify_all()
            raise
        # cache fill and marker discard are ONE critical section: a
        # waiter waking between them would see miss + no in-flight
        # marker and launch a duplicate upstream fetch (the hit
        # counters the launch ladder gates on must be deterministic)
        with self._cv:
            if self.open:
                # a fill tag NEWER than the known floor teaches us the
                # namespace moved on; a floor that advanced DURING the
                # fetch (a bump invalidation raced the forward) marks
                # this value as possibly the pre-bump incarnation's —
                # cache it under the old floor so it is never served
                if int(gen) > self._ns_gen.get(ns, 0):
                    self._ns_gen[ns] = int(gen)
                self._cache.setdefault(ns, {})[key] = (
                    int(gen), value, time.monotonic(),
                    max(fill_floor, int(gen)))
            self._fetching.discard((ns, key))
            self._cv.notify_all()
        return value, int(gen)

    # -- forwarded verbs --------------------------------------------------

    def put(self, ns: str, rank: int, key: str, value: Any) -> None:
        self._forward("put", ns, int(rank), str(key), value)

    def commit(self, ns: str, rank: int) -> int:
        return int(self._forward("commit", ns, int(rank)))

    def fence(self, ns: str, rank: int, timeout: float = 30.0) -> None:
        self._forward("fence", ns, int(rank), float(timeout))

    def ensure_ns(self, ns: str, size: int) -> None:
        self._forward("ensure_ns", ns, int(size))

    def destroy_ns(self, ns: str) -> bool:
        self.forget_ns(ns)
        return bool(self._forward("destroy_ns", ns))

    def bump_generation(self, ns: str) -> int:
        # a bump through THIS daemon invalidates its own cache eagerly;
        # the root's broadcast covers every other daemon
        self.invalidate_ns(ns)
        gen = int(self._forward("bump_generation", ns))
        self.invalidate_ns(ns, gen=gen)  # raise the bucket floor too
        return gen

    def generation(self, ns: str) -> int:
        return int(self._forward("generation", ns))

    def lookup(self, ns: str, prefix: str | None = None) -> dict:
        # NEVER cached: lookup keys (metrics snapshots, resize events)
        # are the mutable part of the store contract
        return self._forward("lookup", ns, prefix)

    def namespaces(self) -> list[str]:
        return list(self._forward("stat").keys())

    def stat(self) -> dict:
        return self._forward("stat")

    # -- coherence / lifecycle --------------------------------------------

    def invalidate_ns(self, ns: str, gen: "int | None" = None) -> None:
        """Drop every cached entry of ``ns`` — the generation-bump (or
        namespace-destroy) invalidation riding the parent link.  A
        gen-carrying invalidation also raises the bucket's generation
        FLOOR, so an in-flight fetch that started before the bump can
        never park its (possibly pre-bump) value back into the warm
        cache as servable."""
        with self._cv:
            self._cache.pop(str(ns), None)
            if gen is not None:
                self._ns_gen[str(ns)] = max(
                    self._ns_gen.get(str(ns), 0), int(gen))
            self._cv.notify_all()

    def forget_ns(self, ns: str) -> None:
        """Namespace DESTROYED: drop its cache bucket AND its
        generation floor — a later namespace reusing the name starts
        over at generation 0, and a stale floor would wrongly embargo
        every entry it publishes."""
        with self._cv:
            self._cache.pop(str(ns), None)
            self._ns_gen.pop(str(ns), None)
            self._cv.notify_all()

    def cached_keys(self) -> list[str]:
        with self._cv:
            return sorted(
                f"{ns}:{key}"
                for ns, kv in self._cache.items()
                for key in kv
            )

    def cache_info(self) -> dict[str, int]:
        with self._cv:
            return {ns: len(kv) for ns, kv in self._cache.items()}

    def close(self) -> None:
        """Drop the cache, close every upstream connection, error out
        parked fetch waiters — the owning PmixServer calls this on its
        own close (store-compatible surface)."""
        with self._cv:
            self.open = False
            self._cache.clear()
            self._cv.notify_all()
        with self._clients_lock:
            clients, self._clients = list(self._clients), []
        for cli in clients:
            cli.close()


class ChildLink:
    """Parent half of one tree link: registered by the attach handler,
    holds the child's identity, its known subtree membership, and the
    connection downward frames ride."""

    def __init__(self, info: dict, conn, conn_lock):
        self.id = str(info["id"])
        self.control = tuple(info.get("control") or ("", 0))
        self.pmix = tuple(info.get("pmix") or ("", 0))
        self.conn = conn
        self.conn_lock = conn_lock
        # every daemon id reachable through this link (the child plus
        # whatever it later reports via daemon-up) — targeted downward
        # routing resolves against this set
        self.daemons: set[str] = {self.id}
        self.detached = False

    def send_down(self, kind: str, payload: Any) -> None:
        from ..pt2pt.tcp import _send_frame
        from ..utils import dss

        with self.conn_lock:
            _send_frame(self.conn, dss.pack(["down", str(kind), payload]))


class TreeLink:
    """Child half of the parent link: one persistent connection to the
    parent daemon's control port.  The constructor performs the attach
    handshake synchronously (send ``["attach", info]``, read the
    ``["ok", meta]`` reply); :meth:`start` launches the reader thread
    that dispatches downward frames and reports a lost parent."""

    def __init__(self, parent_addr: tuple[str, int], info: dict,
                 on_down: Callable[[str, Any], None],
                 on_lost: Callable[[], None], timeout: float = 30.0):
        import socket as socket_mod

        from ..pt2pt.tcp import _recv_frame, _send_frame
        from ..utils import dss

        self.parent = pmix_mod.parse_addr(parent_addr)
        self._on_down = on_down
        self._on_lost = on_lost
        self._closed = False
        self._send_lock = threading.Lock()
        self._sock = socket_mod.socket(socket_mod.AF_INET,
                                       socket_mod.SOCK_STREAM)
        self._sock.settimeout(timeout)
        try:
            self._sock.connect(self.parent)
            _send_frame(self._sock, dss.pack(["attach", info]))
            frame = _recv_frame(self._sock)
            if frame is None:
                raise errors.InternalError(
                    f"dvm tree: parent at {self.parent} closed the "
                    "attach handshake")
            [status, meta] = dss.unpack(frame)[0]
            if status != "ok":
                raise errors.InternalError(f"dvm tree attach: {meta}")
            self.meta = meta
        except (OSError, errors.MpiError) as e:
            try:
                self._sock.close()
            except OSError:
                pass
            if isinstance(e, errors.MpiError):
                raise
            raise errors.InternalError(
                f"dvm tree: no parent daemon at {self.parent}: {e}"
            ) from e
        self._sock.settimeout(None)
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"dvm-tree-link-{self.parent[1]}",
        )

    def start(self) -> None:
        self._reader.start()

    def _read_loop(self) -> None:
        from ..pt2pt.tcp import _recv_frame
        from ..utils import dss

        try:
            while not self._closed:
                frame = _recv_frame(self._sock)
                if frame is None:
                    break
                try:
                    [msg] = dss.unpack(frame)
                    if msg[0] != "down":
                        continue  # foreign frame shape: ignore, stay up
                    self._on_down(str(msg[1]), msg[2])
                except errors.MpiError as e:
                    # a handler that raises must not kill the link —
                    # but the drop is LOUD: a swallowed down-frame is a
                    # lost fault flood or invalidation
                    mca_output.emit(
                        _stream,
                        "tree link: down-frame handler failed (%s) — "
                        "frame dropped", e,
                    )
        except OSError:
            pass
        finally:
            if not self._closed:
                self._on_lost()

    def send_up(self, kind: str, payload: Any) -> None:
        """One upward frame; raises ``OSError`` when the parent is gone
        (the reader's on_lost owns the policy)."""
        from ..pt2pt.tcp import _send_frame
        from ..utils import dss

        with self._send_lock:
            _send_frame(self._sock, dss.pack(["up", str(kind), payload]))

    def detach(self) -> None:
        """Orderly goodbye: tell the parent this daemon is leaving on
        purpose (no ranks re-classified), then close the link."""
        try:
            self.send_up("detach", None)
        except OSError:
            pass
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        import socket as socket_mod

        try:
            self._sock.shutdown(socket_mod.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._reader.is_alive() \
                and self._reader is not threading.current_thread():
            self._reader.join(timeout=5.0)


class DvmTree:
    """Harness handle over an n-daemon tree (tests/benchmarks): the
    root first, children in :func:`plan_tree` order.  ``stop()`` tears
    the tree down leaves-first so no child ever classifies an orderly
    shutdown as a lost parent."""

    def __init__(self, nodes: list[dict]):
        self.nodes = nodes

    @property
    def root(self):
        return self.nodes[0].get("dvm")

    @property
    def root_address(self) -> tuple[str, int]:
        return tuple(self.nodes[0]["address"])

    def addresses(self) -> list[tuple[str, int]]:
        return [tuple(n["address"]) for n in self.nodes]

    def stop(self) -> None:
        from . import dvm as dvm_mod

        for node in reversed(self.nodes):
            d = node.get("dvm")
            if d is not None:
                d.stop()
                continue
            p: subprocess.Popen | None = node.get("proc")
            if p is None or p.poll() is not None:
                continue
            try:
                cli = dvm_mod.DvmClient(tuple(node["address"]),
                                        timeout=10.0)
                try:
                    cli.stop()
                finally:
                    cli.close()
            except errors.MpiError:
                pass  # already dying: the kill below reaps it
            try:
                p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def kill_node(self, index: int, sig) -> None:
        """SIGKILL-style death injection for subprocess nodes (the
        kill-a-daemon drill)."""
        p = self.nodes[index].get("proc")
        if p is None:
            raise errors.ArgError(
                "kill_node needs a subprocess daemon (in_process trees "
                "stop, they don't die)")
        p.send_signal(sig)
        p.wait(timeout=10.0)


def spawn_tree(n: int, fanout: int | None = None,
               host: str = "127.0.0.1", in_process: bool = True,
               timeout: float = 60.0) -> DvmTree:
    """Build an n-daemon DVM tree: the root, then each child attached
    per :func:`plan_tree`.  ``in_process=True`` constructs
    :class:`~zhpe_ompi_tpu_torch.runtime.dvm.Dvm` objects in this process
    (thread-fast tests; counters shared); ``False`` spawns real
    ``zprted --parent`` OS processes (the drill / ladder shape) and
    parses their ready lines."""
    from . import dvm as dvm_mod

    parents = plan_tree(n, fanout)
    nodes: list[dict] = []
    try:
        for i, parent_idx in enumerate(parents):
            parent_addr = None if parent_idx is None \
                else tuple(nodes[parent_idx]["address"])
            if in_process:
                d = dvm_mod.Dvm(host=host, parent=parent_addr)
                nodes.append({"address": d.address,
                              "pmix": d.pmix.address, "dvm": d,
                              "proc": None})
                continue
            cmd = [sys.executable, "-m", "zhpe_ompi_tpu_torch.runtime.dvm",
                   "--host", host]
            if parent_addr is not None:
                cmd += ["--parent", f"{parent_addr[0]}:{parent_addr[1]}"]
            env = dict(os.environ)
            pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            parts = env.get("PYTHONPATH", "").split(os.pathsep)
            if pkg_root not in parts:
                env["PYTHONPATH"] = os.pathsep.join(
                    [pkg_root] + [p for p in parts if p])
            p = subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )
            ready = _read_ready_line(p, timeout)
            addr = pmix_mod.parse_addr(ready.split("dvm=")[1].split()[0])
            pmix_addr = pmix_mod.parse_addr(
                ready.split("pmix=")[1].split()[0])
            nodes.append({"address": addr, "pmix": pmix_addr,
                          "dvm": None, "proc": p})
        # the whole tree is placeable before the harness returns: a
        # DIRECT child registers synchronously inside its attach
        # handshake, but a grandchild's daemon-up frame relays through
        # its parent asynchronously — a launch racing that relay would
        # place ranks on a partial tree
        deadline = time.monotonic() + timeout
        while True:
            root = nodes[0].get("dvm")
            known = len(root._placement_ids) if root is not None \
                else len(dvm_mod._tree_query(tuple(nodes[0]["address"]))
                         .get("daemons") or ())
            if known >= len(nodes):
                break
            if time.monotonic() > deadline:
                raise errors.InternalError(
                    f"dvm tree: root knows {known}/{len(nodes)} "
                    "daemons after spawn")
            time.sleep(0.01)
    except BaseException:
        DvmTree(nodes).stop()
        raise
    return DvmTree(nodes)


def _read_ready_line(p: subprocess.Popen, timeout: float) -> str:
    """Bounded read of a zprted subprocess's ready line: a daemon that
    dies before announcing must fail the spawn, not hang it."""
    import select

    deadline = time.monotonic() + timeout
    r, _, _ = select.select([p.stdout], [], [],
                            max(0.0, deadline - time.monotonic()))
    if not r:
        raise errors.InternalError(
            "zprted child never printed its ready line")
    line = p.stdout.readline()
    if not line.startswith("zprted ready"):
        err = p.stderr.read() if p.poll() is not None else ""
        raise errors.InternalError(
            f"zprted child failed to start: {line!r} {err}")
    return line
