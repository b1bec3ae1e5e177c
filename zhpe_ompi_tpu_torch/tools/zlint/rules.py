"""zlint rules ZL001–ZL010
(namesake: ``zhpe_ompi_tpu/tools/zlint/rules.py``).

Every rule encodes an invariant a REAL bug in this repo's history
violated; the docstrings cite the incident so the rule's teeth are
traceable.  Rules are small AST walks — ``visit(mod)`` per file,
``finalize(mods)`` for the cross-file audits (the lock graph, the
SPC/MCA parity sweeps).
"""

from __future__ import annotations

import ast
import re

from .engine import (
    Finding,
    Module,
    call_name,
    call_receiver,
    const_fold,
    dotted_name,
)

_UNFOLDABLE = const_fold.UNFOLDABLE


# -- the SPC doc-table parser (shared surface) -------------------------------
#
# One parser serves three consumers: ZL006's exact-name parity audit,
# ZL009's publisher-seam audit of templated/dynamic names, and the
# RUNTIME's deterministic MPI_T discovery + metrics-publisher zero-fill
# (``runtime/spc.py::documented_counters``) — so "documented" means the
# same thing to the linter and to the live tool plane.

#: ``- ``name`` [/ ``name``...]`` doc-table entry; names may carry
#: ``<placeholder>`` segments (templated families)
_DOC_ENTRY_RE = re.compile(
    r"^- (``[a-zA-Z0-9_<>]+``(?: */ *``[a-zA-Z0-9_<>]+``)*)")
_DOC_TICKED_RE = re.compile(r"``([a-zA-Z0-9_<>]+)``")


def parse_counter_doc(doc: str) -> tuple[set[str], set[str]]:
    """Split a counter doc table into (exact names, templated
    families).  A templated family carries ``<...>`` placeholders
    (``coll_<op>_calls``) — the documented shape of a dynamic name
    routed through a literal template at its call site."""
    names: set[str] = set()
    templates: set[str] = set()
    for line in doc.splitlines():
        m = _DOC_ENTRY_RE.match(line.strip())
        if not m:
            continue
        for ticked in _DOC_TICKED_RE.findall(m.group(1)):
            (templates if "<" in ticked else names).add(ticked)
    return names, templates


_TEMPLATE_HOLE_RE = re.compile(r"<[^<>]*>")


def template_shape(template: str) -> str:
    """Normalize a templated name (``coll_<op>_calls`` or an f-string's
    ``coll_<*>_calls``) so documented and recorded shapes compare
    exactly: every placeholder collapses to one hole marker."""
    return _TEMPLATE_HOLE_RE.sub("\x00", template)


class Rule:
    id = "ZL000"
    title = ""
    guards = ""  # the historical bug this rule encodes

    def visit(self, mod: Module) -> list[Finding]:
        return []

    def finalize(self, mods: list[Module]) -> list[Finding]:
        return []


# ----------------------------------------------------------------------
class DiscardedRequest(Rule):
    """ZL001 — a nonblocking operation's Request must be observed.

    Historical bug: the sendrecv regression — ``ShrunkEndpoint``
    and the crcp/vprotocol logged sendrecv fire-and-forgot an
    ``isend`` whose frame could still be queued when the recv
    returned; the discarded request's typed error was never observed
    and the buffer-reuse contract silently broke for post-shrink ring
    collectives over the wire.  A bare expression-statement
    ``ep.isend(...)`` is that bug's AST shape.
    """

    id = "ZL001"
    title = "discarded-request"
    guards = "sendrecv fire-and-forget isend (typed error lost)"

    NONBLOCKING = {
        "isend", "issend", "irecv", "ibcast", "ireduce", "iallreduce",
        "ibarrier", "iallgather", "ialltoall", "ialltoallv", "igather",
        "iscatter", "ireduce_scatter", "isendrecv", "irsend",
    }

    def visit(self, mod: Module) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)):
                continue
            name = call_name(node.value)
            if name in self.NONBLOCKING:
                out.append(mod.finding(
                    self.id, node, name,
                    f"result of nonblocking `{name}` is discarded — its "
                    "typed error can never be observed (wait/test/store "
                    "the Request)",
                ))
        return out


# ----------------------------------------------------------------------
class LockOrder(Rule):
    """ZL002 — static lock-acquisition graph over ``with lock:``
    nesting, plus blocking calls made while holding a transport lock.

    Historical bug: the ``ch.lock``/``_rndv_lock`` seam took THREE
    review rounds before the ownership handshake was atomic —
    ``_drain_channel`` sets ownership inside ``ch.lock``,
    ``_push_rndv`` inside ``_rndv_lock``, and ``_fail_inflight`` walks
    both; one inverted nesting wedges a survivor against a completing
    worker.  The rule merges every ``with A: ... with B:`` nesting
    into one graph and flags cycles; it also flags direct blocking
    calls (socket ops, ``join``, ``wait``, ``sleep``) under any lock —
    the global-send-lock heartbeat starvation is the incident
    (a wedged peer's data send starved beat emission and got the
    sender falsely suspected).
    """

    id = "ZL002"
    title = "lock-order"
    guards = "ch.lock/_rndv_lock inversion; send under a global lock"

    BLOCKING = {
        "send", "sendall", "sendmsg", "sendto", "recv", "recv_into",
        "recvfrom", "accept", "connect", "join", "wait", "select",
        "sleep",
    }
    #: with-item expressions that ARE locks: last path component
    #: mentions "lock" (``self._rndv_lock``, ``ch.lock``, ``lock``)
    _LOCKISH = re.compile(r"(^|[._])r?lock$|_lock$|^lock", re.IGNORECASE)

    def __init__(self):
        # (outer_key, inner_key) -> (mod, node) of first witness site
        self.edges: dict[tuple[str, str], tuple[Module, ast.AST]] = {}

    @staticmethod
    def _nonblocking_lookalike(call: ast.Call, name: str) -> bool:
        """``os.path.join`` and ``sep.join(parts)`` are not thread
        joins; a bare ``wait()``/``join()`` with no receiver is not a
        method on a waitable either."""
        recv = call_receiver(call)
        if name == "join":
            return recv is None or "path" in recv
        if name == "wait":
            return recv is None
        return False

    def _lock_key(self, expr: ast.AST, mod: Module, node: ast.AST
                  ) -> str | None:
        name = dotted_name(expr)
        if name is None or not self._LOCKISH.search(name.rsplit(".", 1)[-1]):
            return None
        if name.startswith("self."):
            qual = mod.qualname(node)
            cls = qual.split(".", 1)[0] if "." in qual else ""
            return f"{cls}.{name[5:]}" if cls else name[5:]
        return name

    def visit(self, mod: Module) -> list[Finding]:
        out: list[Finding] = []

        def walk(node: ast.AST, held: list[tuple[str, ast.AST]]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Lambda)):
                    # a nested def's body runs LATER, not under the lock
                    walk(child, [])
                    continue
                pushed = 0
                if isinstance(child, ast.With):
                    for item in child.items:
                        key = self._lock_key(item.context_expr, mod, child)
                        if key is None:
                            continue
                        for outer, _site in held:
                            if outer != key and (outer, key) not in self.edges:
                                self.edges[(outer, key)] = (mod, child)
                        held.append((key, child))
                        pushed += 1
                if isinstance(child, ast.Call) and held:
                    name = call_name(child)
                    if name in self.BLOCKING \
                            and not self._nonblocking_lookalike(child, name):
                        lock, site = held[-1]
                        f = mod.finding(
                            self.id, child, f"blocking:{lock}:{name}",
                            f"blocking call `{name}()` while holding lock "
                            f"`{lock}` — can starve every other acquirer "
                            "(heartbeats included)",
                        )
                        # suppression on the with-statement's line covers
                        # the whole guarded body (the sanctioned-site idiom)
                        if not mod.is_suppressed(self.id, site.lineno):
                            out.append(f)
                walk(child, held)
                for _ in range(pushed):
                    held.pop()

        walk(mod.tree, [])
        return out

    def finalize(self, mods: list[Module]) -> list[Finding]:
        graph: dict[str, set[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
        out: list[Finding] = []
        seen_cycles: set[tuple[str, ...]] = set()

        def dfs(start: str, cur: str, path: list[str]) -> None:
            for nxt in sorted(graph.get(cur, ())):
                if nxt == start:
                    cycle = path + [cur]
                    lowest = cycle.index(min(cycle))
                    canon = tuple(cycle[lowest:] + cycle[:lowest])
                    if canon in seen_cycles:
                        continue
                    seen_cycles.add(canon)
                    mod, node = self.edges[(cur, start)]
                    out.append(mod.finding(
                        self.id, node, "cycle:" + "->".join(canon),
                        "lock-order cycle: " + " -> ".join(
                            canon + (canon[0],))
                        + " — two threads taking these in opposite order "
                        "deadlock",
                    ))
                elif nxt not in path + [cur]:
                    dfs(start, nxt, path + [cur])

        for start in sorted(graph):
            dfs(start, start, [])
        self.edges.clear()
        return out


# ----------------------------------------------------------------------
class PollingWait(Rule):
    """ZL003 — hot-polling waits: a ``while`` loop spinning on
    ``sleep(0)``/sub-millisecond sleeps.

    Historical bug: the ``sm_poll_hot_us`` finding — idle procs'
    5 ms ``sleep(0)`` spinners on a single-CPU affinity mask
    serialized han's localized phases behind scheduler quanta,
    tripling flat-ladder latencies; a later measurement found the same poison
    in sub-ms request-wait wakeups.  Sanctioned spin sites (the futex
    fallback, bounded hot-yield windows) carry inline suppressions
    with their justification.
    """

    id = "ZL003"
    title = "polling-wait"
    guards = "sm_poll_hot_us — hot spinners poison 1-CPU hosts"

    THRESHOLD_S = 0.001

    def visit(self, mod: Module) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.While):
                continue
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Call)
                        and call_name(sub) == "sleep" and sub.args):
                    continue
                val = const_fold(sub.args[0], mod)
                if val is _UNFOLDABLE or not isinstance(val, (int, float)):
                    continue
                if val < self.THRESHOLD_S:
                    out.append(mod.finding(
                        self.id, sub, f"sleep:{val!r}",
                        f"while-loop hot-polls with sleep({val!r}) — "
                        "sub-ms spinners steal scheduler quanta from the "
                        "completing threads on oversubscribed hosts (use "
                        "an event/futex wait or a bounded backoff)",
                    ))
        return out


# ----------------------------------------------------------------------
class SwallowedError(Rule):
    """ZL004 — a broad ``except:``/``except Exception:`` on a protocol
    seam must classify, complete, get loud, or re-raise.

    Historical bug: classified-vs-swallowed is this repo's recurring
    FT seam — a transport error swallowed instead of classified left a
    severed sm peer raising bare ``InternalError`` racing the detector
    (fixed by classifying ``ConsumerStopped`` as typed
    ProcFailed), and the rendezvous push had to catch EVERY escape
    and complete the request errored because an uncompleted request
    there could never be completed again.  A broad handler that
    neither re-raises, nor calls a completion/classification/output
    function, nor even references the caught exception, is the
    swallow shape.

    Scope: protocol modules (``pt2pt/``, ``ft/``, ``runtime/``,
    ``coll/``, ``comm/``); teardown paths (close/stop/sever/...) are
    exempt — best-effort cleanup is their contract.
    """

    id = "ZL004"
    title = "swallowed-error"
    guards = "unclassified transport errors racing the detector"

    SCOPES = ("pt2pt/", "ft/", "runtime/", "coll/", "comm/")
    BROAD = {"Exception", "BaseException"}
    #: calls that make a handler sanctioned: request completion, FT
    #: classification, loud degradation, process exit
    SANCTIONED_CALLS = {
        "complete_error", "mark_failed", "mark_departed",
        "classify_recv_failure", "emit", "verbose", "warn", "warning",
        "exception", "record", "_exit", "abort", "print",
    }
    TEARDOWN = re.compile(
        r"(^|_)(close|stop|sever|shutdown|teardown|cleanup|unlink|kill|"
        r"del|drain|sweep|reap|abandon|quiesce|free)", re.IGNORECASE
    )

    def _in_scope(self, mod: Module) -> bool:
        return any(s in mod.path_key for s in self.SCOPES) \
            or "/" not in mod.path_key  # test fixtures lint flat files

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        names = []
        for n in ast.walk(t) if isinstance(t, ast.Tuple) else [t]:
            d = dotted_name(n)
            if d:
                names.append(d.rsplit(".", 1)[-1])
        return any(n in self.BROAD for n in names)

    def visit(self, mod: Module) -> list[Finding]:
        if not self._in_scope(mod):
            return []
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler) \
                    or not self._is_broad(node):
                continue
            qual = mod.qualname(node)
            fname = qual.rsplit(".", 1)[-1]
            if self.TEARDOWN.search(fname):
                continue
            handled = False
            for sub in ast.walk(ast.Module(body=node.body,
                                           type_ignores=[])):
                if isinstance(sub, ast.Raise):
                    handled = True
                    break
                if isinstance(sub, ast.Call) \
                        and call_name(sub) in self.SANCTIONED_CALLS:
                    handled = True
                    break
                if node.name and isinstance(sub, ast.Name) \
                        and sub.id == node.name:
                    # the exception is referenced — repackaged/logged/
                    # fed to a classifier we don't know by name
                    handled = True
                    break
            if not handled:
                out.append(mod.finding(
                    self.id, node, f"swallow:{qual}",
                    "broad except on a protocol seam neither re-raises, "
                    "completes a request errored, classifies via "
                    "FailureState, nor references the exception — "
                    "failures vanish here",
                ))
        return out


# ----------------------------------------------------------------------
class ThreadHygiene(Rule):
    """ZL005 — every ``threading.Thread`` is daemonized or visibly
    registered with a tracked join path (the conftest leak gates'
    static twin).

    Historical bug: the suite-wide leak gates exist because threads
    DID leak — leaked heartbeat threads, the
    thread-per-rendezvous spawn replaced by the tracked ``_PushPool``,
    the agreement flood threads taken to the grave by their own
    rank's close (fixed by registering them in ``_flood_threads``
    with a bounded join).  A Thread that is neither ``daemon=True``
    nor appended/joined anywhere in its function can reproduce all
    three.
    """

    id = "ZL005"
    title = "thread-hygiene"
    guards = "leaked heartbeat/rendezvous/flood threads"

    def visit(self, mod: Module) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            recv = call_receiver(node)
            if name != "Thread" or (recv is not None
                                    and recv != "threading"):
                continue
            if any(kw.arg == "daemon"
                   and isinstance(kw.value, ast.Constant)
                   and kw.value.value is True for kw in node.keywords):
                continue
            if self._tracked(mod, node):
                continue
            out.append(mod.finding(
                self.id, node, f"thread:{mod.qualname(node)}",
                "Thread is neither daemon=True nor registered with a "
                "tracked join path — it can outlive its owner and trip "
                "the suite leak gates",
            ))
        return out

    def _tracked(self, mod: Module, call: ast.Call) -> bool:
        """True when the Thread object is assigned to a name that is
        later appended to a container, joined, or daemonized in the
        same function."""
        parent = mod.parent(call)
        if not isinstance(parent, ast.Assign):
            return False
        targets = [t.id for t in parent.targets if isinstance(t, ast.Name)]
        if not targets:
            return False
        fn = mod.enclosing_function(call)
        if fn is None:
            return False
        for sub in ast.walk(fn):
            # t.daemon = True
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and tgt.attr == "daemon" \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id in targets:
                        return True
            # container.append(t) / registry.add(t) / t.join()
            if isinstance(sub, ast.Call):
                cname = call_name(sub)
                if cname in ("append", "add", "register"):
                    for arg in sub.args:
                        if isinstance(arg, ast.Name) and arg.id in targets:
                            return True
                if cname == "join" and isinstance(sub.func, ast.Attribute) \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id in targets:
                    return True
        return False


# ----------------------------------------------------------------------
class SpcDocParity(Rule):
    """ZL006 — SPC counters are documentation-bearing by contract:
    every counter bumped in code appears in ``runtime/spc.py``'s doc
    table, and every documented counter is actually recorded.

    Historical grounding: the OSU ladders GATE on counters
    (``tcp_zero_copy_sends`` stalling fails CI, not a mystery perf
    regression) — a counter nobody can find in the doc table is a
    gate nobody can interpret, and a documented counter that silently
    stopped being recorded is a gate that silently stopped gating.
    The reference's SPC design (``ompi_spc.c``) carries its
    descriptions in the counter registry itself.

    Active only when the scan set includes ``runtime/spc.py``.
    """

    id = "ZL006"
    title = "spc-doc-parity"
    guards = "counter-gated CI: undocumented/unrecorded counters lie"

    def __init__(self):
        self.recorded: dict[str, tuple[Module, ast.AST]] = {}
        #: string literals in modules that route DYNAMIC counter names
        #: into spc.record (``spc.record(self._bytes_counter, n)`` fed
        #: from a literal table): they satisfy the documented-side
        #: check but cannot assert undocumented-side findings
        self.maybe_recorded: set[str] = set()
        self.spc_mod: Module | None = None

    def visit(self, mod: Module) -> list[Finding]:
        if mod.path_key.endswith("runtime/spc.py") \
                or mod.path_key == "spc.py":
            self.spc_mod = mod
        dynamic = False
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and call_name(node) == "record"
                    and call_receiver(node) == "spc" and node.args):
                continue
            arg0 = node.args[0]
            if isinstance(arg0, ast.Constant) and isinstance(arg0.value, str):
                self.recorded.setdefault(arg0.value, (mod, node))
            elif isinstance(arg0, ast.IfExp):
                # a conditional name: ``spc.record(<"a" if c else "b">, 1)``
                for arm in (arg0.body, arg0.orelse):
                    if isinstance(arm, ast.Constant) \
                            and isinstance(arm.value, str):
                        self.recorded.setdefault(arm.value, (mod, node))
            else:
                dynamic = True
        if dynamic:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str):
                    self.maybe_recorded.add(node.value)
        return []

    def documented(self) -> set[str]:
        """Exact names only — templated families are ZL009's concern
        (they cannot satisfy nor demand an exact-name parity row)."""
        if self.spc_mod is None:
            return set()
        doc = ast.get_docstring(self.spc_mod.tree) or ""
        names, _templates = parse_counter_doc(doc)
        return names

    def finalize(self, mods: list[Module]) -> list[Finding]:
        out: list[Finding] = []
        if self.spc_mod is None:
            self.recorded.clear()
            return out
        doc = self.documented()
        for name in sorted(set(self.recorded) - doc):
            mod, node = self.recorded[name]
            out.append(mod.finding(
                self.id, node, f"undocumented:{name}",
                f"counter `{name}` is recorded but missing from "
                "runtime/spc.py's doc table (counters are "
                "documentation-bearing by contract)",
            ))
        for name in sorted(doc - set(self.recorded) - self.maybe_recorded):
            out.append(self.spc_mod.finding(
                self.id, self.spc_mod.tree, f"unrecorded:{name}",
                f"counter `{name}` is documented in runtime/spc.py but "
                "never recorded anywhere in the scan set",
            ))
        self.recorded.clear()
        self.maybe_recorded.clear()
        self.spc_mod = None
        return out


# ----------------------------------------------------------------------
class SpcPublisherSeam(Rule):
    """ZL009 — DYNAMIC counter names must still resolve into the
    documented table: the publisher seam ships ``spc.snapshot()``
    verbatim, so a counter recorded under a computed name that no doc
    entry covers becomes an undocumented metric on every dashboard the
    moment the metrics plane publishes a snapshot.

    ZL006 deliberately exempts dynamic first-args (a module routing
    names through a literal table gets blanket literal-table credit) —
    this rule closes that loophole by RESOLVING the dynamic shapes:

    - ``spc.record(self._counter, n)`` → the assignments feeding
      ``_counter`` in the module (one hop through module-level literal
      containers, dict VALUES only) must all be documented exact names;
    - ``spc.record(<f"coll_{{op}}_calls">, 1)`` → the f-string's template
      must match a documented TEMPLATED family (``coll_<op>_calls``);
    - a first-arg that resolves to NO literal at all is flagged as
      unresolvable — route it through a literal table.

    Active only when the scan set includes ``runtime/spc.py``
    (the doc table anchor, like ZL006/ZL007).  Baseline kept empty.
    """

    id = "ZL009"
    title = "spc-publisher-seam"
    guards = ("a dynamically-named counter publishes as an "
              "undocumented metric")

    def __init__(self):
        self.spc_mod: Module | None = None
        self.sites: list[tuple[Module, ast.Call, ast.AST]] = []

    def visit(self, mod: Module) -> list[Finding]:
        if mod.path_key.endswith("runtime/spc.py") \
                or mod.path_key == "spc.py":
            self.spc_mod = mod
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and call_name(node) == "record"
                    and call_receiver(node) == "spc" and node.args):
                continue
            arg0 = node.args[0]
            if isinstance(arg0, ast.Constant):
                continue  # exact literal: ZL006's beat
            if isinstance(arg0, ast.IfExp) and all(
                    isinstance(a, ast.Constant) for a in
                    (arg0.body, arg0.orelse)):
                continue  # literal-armed IfExp: ZL006 covers both arms
            self.sites.append((mod, node, arg0))
        return []

    # -- dynamic-name resolution -----------------------------------------

    @staticmethod
    def _container_strings(node: ast.AST) -> list[str]:
        """String literals a container literal contributes as counter
        names: dict VALUES (keys are selectors, not names), every
        element otherwise."""
        values: list[ast.AST]
        if isinstance(node, ast.Dict):
            values = list(node.values)
        elif isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            values = list(node.elts)
        else:
            values = [node]
        out = []
        for v in values:
            for sub in ast.walk(v):
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str):
                    out.append(sub.value)
        return out

    @classmethod
    def _rhs_strings(cls, mod: Module, rhs: ast.AST) -> list[str]:
        """Literals an assignment RHS can produce: its own string
        constants, plus — one hop — the values of any module-level
        literal container it references by name
        (``PLANE_COUNTERS.get(plane, "default")`` resolves to the
        table's values and the default)."""
        out: list[str] = []
        for sub in ast.walk(rhs):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                out.append(sub.value)
            elif isinstance(sub, ast.Name):
                for stmt in mod.tree.body:
                    if isinstance(stmt, ast.Assign) and any(
                            isinstance(t, ast.Name) and t.id == sub.id
                            for t in stmt.targets):
                        out.extend(cls._container_strings(stmt.value))
        return out

    @classmethod
    def _resolve(cls, mod: Module, arg0: ast.AST
                 ) -> "tuple[list[str], list[str]] | None":
        """(exact candidates, template candidates) for a dynamic
        first-arg, or None when nothing resolves to a literal."""
        if isinstance(arg0, ast.JoinedStr):
            shape = "".join(
                v.value if isinstance(v, ast.Constant) else "<*>"
                for v in arg0.values
            )
            return [], [shape]
        if isinstance(arg0, ast.IfExp):
            a = cls._resolve(mod, arg0.body)
            b = cls._resolve(mod, arg0.orelse)
            if a is None or b is None:
                return None
            return a[0] + b[0], a[1] + b[1]
        if isinstance(arg0, ast.Constant) and isinstance(arg0.value, str):
            return [arg0.value], []
        target: str | None = None
        if isinstance(arg0, ast.Name):
            target = arg0.id
        elif isinstance(arg0, ast.Attribute):
            target = arg0.attr
        if target is None:
            # a computed first-arg used in place (`TABLE.get(k, "x")`,
            # a subscript): its own literals + one-hop named tables
            names = cls._rhs_strings(mod, arg0)
            return (names, []) if names else None
        names: list[str] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if not any(
                (isinstance(t, ast.Name) and t.id == target)
                or (isinstance(t, ast.Attribute) and t.attr == target)
                for t in targets
            ):
                continue
            if node.value is not None:
                names.extend(cls._rhs_strings(mod, node.value))
        return (names, []) if names else None

    def finalize(self, mods: list[Module]) -> list[Finding]:
        out: list[Finding] = []
        sites, self.sites = self.sites, []
        spc_mod, self.spc_mod = self.spc_mod, None
        if spc_mod is None:
            return out  # anchor-gated: no doc table in the scan set
        doc = ast.get_docstring(spc_mod.tree) or ""
        names, templates = parse_counter_doc(doc)
        doc_shapes = {template_shape(t) for t in templates}
        for mod, node, arg0 in sites:
            resolved = self._resolve(mod, arg0)
            if resolved is None:
                out.append(mod.finding(
                    self.id, node, "unresolvable",
                    "dynamic spc.record counter name resolves to no "
                    "literal — route it through a literal table so the "
                    "published metric stays documentable",
                ))
                continue
            exact, shaped = resolved
            for cand in sorted(set(exact)):
                if cand not in names:
                    out.append(mod.finding(
                        self.id, node, f"undocumented:{cand}",
                        f"dynamic counter name `{cand}` is absent from "
                        "runtime/spc.py's doc table — it publishes as "
                        "an undocumented metric",
                    ))
            for cand in sorted(set(shaped)):
                if template_shape(cand) not in doc_shapes:
                    out.append(mod.finding(
                        self.id, node, f"untemplated:{cand}",
                        f"f-string counter family `{cand}` has no "
                        "templated entry in runtime/spc.py's doc table "
                        "(``coll_<op>_calls`` shape) — it publishes as "
                        "an undocumented metric family",
                    ))
        return out


# ----------------------------------------------------------------------
class McaParity(Rule):
    """ZL007 — every MCA var read is registered, and literal fallback
    defaults match the registration.

    Historical bug: ``_geometry()`` — the sm slot/ring fallback
    literals drifted from the registered defaults, so a process that
    read the var before its registering module imported computed a
    DIFFERENT geometry than one that read it after (the cross-process
    desync the segment-header geometry adoption exists to prevent).
    The reference avoids the whole class by construction: reads go
    through the registered variable, never a literal.

    Active only when the scan set includes ``mca/var.py``.
    """

    id = "ZL007"
    title = "mca-parity"
    guards = "_geometry() fallback literals drifted from registration"

    _RECEIVERS = {"mca_var", "var", "mca_var.registry", "registry"}

    def __init__(self):
        self.registered: dict[str, object] = {}
        self.reg_sites: dict[str, tuple[Module, ast.AST]] = {}
        self.reads: list[tuple[str, object, Module, ast.AST]] = []
        self.anchor = False

    def visit(self, mod: Module) -> list[Finding]:
        out: list[Finding] = []
        if mod.path_key.endswith("mca/var.py") or mod.path_key == "var.py":
            self.anchor = True
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            recv = call_receiver(node)
            if recv not in self._RECEIVERS:
                continue
            cname = call_name(node)
            if cname == "register" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                name = node.args[0].value
                default = _UNFOLDABLE
                if len(node.args) > 1:
                    default = const_fold(node.args[1], mod)
                else:
                    for kw in node.keywords:
                        if kw.arg == "default":
                            default = const_fold(kw.value, mod)
                if name in self.registered \
                        and self.registered[name] is not _UNFOLDABLE \
                        and default is not _UNFOLDABLE \
                        and default != self.registered[name]:
                    out.append(mod.finding(
                        self.id, node, f"dup-register:{name}",
                        f"MCA var `{name}` registered twice with "
                        f"different defaults ({self.registered[name]!r} "
                        f"vs {default!r})",
                    ))
                self.registered.setdefault(name, default)
                self.reg_sites.setdefault(name, (mod, node))
            elif cname == "get" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                default = const_fold(node.args[1], mod) \
                    if len(node.args) > 1 else _UNFOLDABLE
                self.reads.append(
                    (node.args[0].value, default, mod, node))
        return out

    def finalize(self, mods: list[Module]) -> list[Finding]:
        out: list[Finding] = []
        if not self.anchor:
            self.registered.clear()
            self.reads.clear()
            self.reg_sites.clear()
            self.anchor = False
            return out
        flagged_unreg: set[str] = set()
        for name, default, mod, node in self.reads:
            if name not in self.registered:
                if name not in flagged_unreg:
                    flagged_unreg.add(name)
                    out.append(mod.finding(
                        self.id, node, f"unregistered:{name}",
                        f"MCA var `{name}` is read but never registered "
                        "— invisible to zmpi-info and the MPI_T surface, "
                        "and its default lives only in call-site "
                        "literals",
                    ))
                continue
            reg_default = self.registered[name]
            if default is _UNFOLDABLE or reg_default is _UNFOLDABLE:
                continue
            if default != reg_default:
                out.append(mod.finding(
                    self.id, node, f"drift:{name}:{default!r}",
                    f"MCA var `{name}` fallback literal {default!r} "
                    f"drifted from the registered default "
                    f"{reg_default!r} (the _geometry() bug shape)",
                ))
        self.registered.clear()
        self.reads.clear()
        self.reg_sites.clear()
        self.anchor = False
        return out


# ----------------------------------------------------------------------
class LoudDegradation(Rule):
    """ZL008 — decision functions degrade loudly, they do not raise.

    Historical bug: the rules loader — ``int()`` RAISED out of
    ``decide`` on a malformed dynamic-rules line (non-int threshold),
    aborting the collective instead of emitting-and-skipping the line;
    the loader was rewritten to degrade loudly per line.  The same
    contract covers every topology/card parser: a malformed FOREIGN
    card must never raise out of a collective
    (``han_malformed_numa_cards``).  In the named decision functions,
    a ``raise`` outside an except handler, or an unguarded
    ``int()``/``float()`` on a non-constant, is the bug shape.
    """

    id = "ZL008"
    title = "loud-degradation"
    guards = "int() raised out of decide on a malformed rules line"

    DECISION_FUNCS = {
        "decide", "_load_rules", "_dynamic_rule", "_valid_rule_alg",
        "wants_han", "_use_numa", "_numa_mode", "_rule_requests_han",
        "parse_card", "parse_numa", "numa_token", "topology",
        "locality_groups",
        # the ztune table plane: every seam between a tuned
        # table and a live decision degrades loudly, never by raising
        "parse_table", "resolve_rule", "table_geometry",
        "job_topology_key", "topology_key",
        # the serving plane: the han alltoall family's leader
        # wire-exchange choice; the elastic resize policy's `decide`
        # rides the existing name above
        "_leader_exchange_alg",
    }

    def visit(self, mod: Module) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name not in self.DECISION_FUNCS:
                continue
            guarded: set[ast.AST] = set()
            in_handler: set[ast.AST] = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Try) and sub.handlers:
                    for s in sub.body:
                        guarded.update(ast.walk(s))
                if isinstance(sub, ast.ExceptHandler):
                    in_handler.update(ast.walk(
                        ast.Module(body=sub.body, type_ignores=[])))
            n_raise = n_cast = 0
            for sub in ast.walk(node):
                if isinstance(sub, ast.Raise) and sub not in in_handler:
                    n_raise += 1
                    out.append(mod.finding(
                        self.id, sub, f"raise:{node.name}:{n_raise}",
                        f"decision function `{node.name}` raises instead "
                        "of degrading loudly (emit + fall back; a "
                        "malformed input must never abort the decision)",
                    ))
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Name) \
                        and sub.func.id in ("int", "float") \
                        and sub not in guarded \
                        and sub.args \
                        and not all(isinstance(a, ast.Constant)
                                    for a in sub.args):
                    n_cast += 1
                    out.append(mod.finding(
                        self.id, sub,
                        f"cast:{node.name}:{sub.func.id}:{n_cast}",
                        f"decision function `{node.name}` calls "
                        f"`{sub.func.id}()` on non-constant input "
                        "outside any try — a malformed value raises out "
                        "of the decision (the rules-loader bug)",
                    ))
        return out


# ----------------------------------------------------------------------
class TraceKindParity(Rule):
    """ZL010 — flight-recorder events and ztrace spans are TYPED by
    contract: every ``flightrec.record(KIND, ...)`` /
    ``ztrace.record_span/instant/begin(KIND, ...)`` call site's kind
    must resolve into the documented type table of its plane (the
    module-level constants enumerated by ``flightrec.ALL_EVENTS`` /
    ``ztrace.ALL_KINDS``) — the ZL009 publisher-seam discipline
    applied to the event planes.

    Grounding: the metrics publisher ships both buffers into the
    store verbatim and ``tools/ztrace`` classifies the merged timeline
    BY KIND — a seam recording a misspelled or undeclared kind
    publishes events every consumer (the critical-path report, the
    flightrec postmortem view, the test gates asserting tail-entry
    types) silently drops.  A literal outside the table, an attribute
    that names no declared constant, or a first argument that resolves
    to no literal at all is the bug shape.

    Active only when the scan set includes the plane's anchor module
    (``runtime/flightrec.py`` / ``runtime/ztrace.py``), like
    ZL006/ZL007/ZL009.
    """

    id = "ZL010"
    title = "trace-kind-parity"
    guards = ("a misspelled span kind publishes as a type no "
              "timeline consumer matches")

    #: receiver -> (anchor path suffix, ALL-table name, flagged calls)
    PLANES = {
        "flightrec": ("runtime/flightrec.py", "ALL_EVENTS",
                      ("record",)),
        "ztrace": ("runtime/ztrace.py", "ALL_KINDS",
                   ("record_span", "instant", "begin")),
    }

    def __init__(self):
        # plane -> (const name -> value, documented kind values)
        self.tables: dict[str, tuple[dict[str, str], set[str]]] = {}
        self.sites: list[tuple[str, Module, ast.Call, ast.AST]] = []

    def _harvest(self, mod: Module, all_name: str
                 ) -> tuple[dict[str, str], set[str]]:
        consts: dict[str, str] = {}
        listed: set[str] = set()
        for stmt in mod.tree.body:
            if not isinstance(stmt, ast.Assign) \
                    or len(stmt.targets) != 1 \
                    or not isinstance(stmt.targets[0], ast.Name):
                continue
            tname = stmt.targets[0].id
            if isinstance(stmt.value, ast.Constant) \
                    and isinstance(stmt.value.value, str):
                consts[tname] = stmt.value.value
            elif tname == all_name \
                    and isinstance(stmt.value, ast.Tuple):
                for el in stmt.value.elts:
                    if isinstance(el, ast.Name):
                        listed.add(el.id)
        kinds = {consts[n] for n in listed if n in consts}
        return consts, kinds

    def visit(self, mod: Module) -> list[Finding]:
        for plane, (suffix, all_name, calls) in self.PLANES.items():
            if mod.path_key.endswith(suffix) \
                    or mod.path_key == suffix.rsplit("/", 1)[-1]:
                self.tables[plane] = self._harvest(mod, all_name)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            recv = call_receiver(node)
            plane = self.PLANES.get(recv) if recv else None
            if plane is None or call_name(node) not in plane[2]:
                continue
            self.sites.append((recv, mod, node, node.args[0]))
        return []

    def finalize(self, mods: list[Module]) -> list[Finding]:
        out: list[Finding] = []
        sites, self.sites = self.sites, []
        tables, self.tables = self.tables, {}
        for plane, mod, node, arg0 in sites:
            if plane not in tables:
                continue  # anchor-gated per plane
            consts, kinds = tables[plane]
            if isinstance(arg0, ast.IfExp):
                # ``KIND_A if cond else KIND_B``: both arms resolve
                # independently (the ZL006 IfExp discipline)
                sites.append((plane, mod, node, arg0.body))
                sites.append((plane, mod, node, arg0.orelse))
                continue
            if isinstance(arg0, ast.Constant) \
                    and isinstance(arg0.value, str):
                if arg0.value not in kinds:
                    out.append(mod.finding(
                        self.id, node, f"unknown:{plane}:{arg0.value}",
                        f"`{plane}` kind literal {arg0.value!r} is "
                        f"outside the documented "
                        f"{self.PLANES[plane][1]} table — no timeline "
                        "consumer will ever match it",
                    ))
                continue
            if isinstance(arg0, ast.Attribute) \
                    and isinstance(arg0.value, ast.Name) \
                    and arg0.value.id == plane:
                value = consts.get(arg0.attr)
                if value is None or value not in kinds:
                    out.append(mod.finding(
                        self.id, node,
                        f"undeclared:{plane}:{arg0.attr}",
                        f"`{plane}.{arg0.attr}` names no constant in "
                        f"the documented {self.PLANES[plane][1]} "
                        "table",
                    ))
                continue
            out.append(mod.finding(
                self.id, node, f"unresolvable:{plane}",
                f"`{plane}` event/span kind resolves to no literal — "
                "record through a documented module constant so the "
                "published type stays classifiable",
            ))
        return out


def all_rules() -> list[Rule]:
    """Fresh rule instances (cross-file rules carry per-run state)."""
    return [
        DiscardedRequest(), LockOrder(), PollingWait(), SwallowedError(),
        ThreadHygiene(), SpcDocParity(), McaParity(), LoudDegradation(),
        SpcPublisherSeam(), TraceKindParity(),
    ]


def rule_table() -> list[tuple[str, str, str]]:
    """(id, title, guards) for the CLI's --list-rules and the README."""
    return [(r.id, r.title, r.guards) for r in all_rules()]
