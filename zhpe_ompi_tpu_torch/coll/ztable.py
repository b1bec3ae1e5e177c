"""coll/ztable — topology-keyed tuned decision tables, the file rung
(namesake: ``zhpe_ompi_tpu/coll/ztable.py``).

The reference's coll/tuned reads decision tables distilled from benchmark
sweeps (``coll_tuned_dynamic_file.c``).  This module parses, caches and
resolves those tables for ``coll/tuned.py``.  The format is the JAX
package's, so one table means the same in both packages::

    # comments and blank lines ignored
    [topology 2 2 2]            # n_hosts n_domains ranks_per_domain
    allreduce 0 16384 ring      # <op> <comm_min> <bytes_min> <alg>
    geometry sm_ring_bytes 1048576
    [topology * * *]            # wildcard section: matches every job
    allreduce 4 16384 ring

Lines before any ``[topology ...]`` header belong to an implicit
all-wildcard section (the headerless dynamic-rules format).  Resolution is
most-specific-wins across sections: sections are ordered by pinned-field
count (then pinned-ness of ``n_hosts`` over ``n_domains`` over
``ranks_per_domain``), the first matching section holding a rule that
fires for ``(op, comm_size, nbytes)`` wins, and within a section the most
specific ``(comm_min, bytes_min)`` rule wins.  A job with no known
topology key matches only all-wildcard sections.

Only the file rung is ported: the table named by the
``coll_tuned_dynamic_rules`` MCA variable.  The store rung (a table served
from the DVM's PMIx store when ``ZMPI_PMIX`` is set) needs
``runtime/pmix.py``, which the port does not have yet, so
:func:`active`, :func:`resolve_rule` and :func:`table_geometry` raise
``UnsupportedError`` when ``ZMPI_PMIX`` is set rather than ignore it.  Malformed table lines degrade loudly: each is
reported on the ``coll_ztable`` stream and skipped, never raised into a
collective call.
"""

from __future__ import annotations

import os

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var

_stream = mca_output.open_stream("coll_ztable")

#: sm segment-geometry vars a table may size (``pt2pt/sm.py`` adopts them
#: through :func:`table_geometry` while the var holds its default).
GEOMETRY_VARS = ("sm_ring_bytes", "sm_leader_ring_bytes")

mca_var.register(
    "coll_tuned_topology", "",
    "Topology key 'n_hosts:n_domains:ranks_per_domain' selecting the "
    "matching [topology ...] sections of a tuned decision table; '' "
    "matches only wildcard sections",
)

# A parsed table is a list of sections, each (key, rules, geometry) with
# key a 3-tuple of int-or-None (None = wildcard field), rules a list of
# (op, comm_min, bytes_min, alg) and geometry a dict var-name -> bytes.
_WILDCARD = (None, None, None)

# Installed by coll/tuned.py at its import: validates (op, alg) pairs
# against the real algorithm tables.  Absent, rule lines pass shape
# validation only; the decision seam re-checks membership before dispatch.
_alg_validator = None


def set_alg_validator(fn) -> None:
    global _alg_validator
    _alg_validator = fn


def _complain(origin, lineno, line, reason, problems) -> None:
    if problems is not None:
        problems.append((lineno, line.strip(), reason))
    mca_output.emit(
        _stream,
        "tuned table %s:%d: ignoring %r (%s); the fixed decision applies",
        origin, lineno, line.strip(), reason,
    )


def _parse_header(parts):
    """``["topology", H, D, R]`` with int-or-* fields -> key or None."""
    if len(parts) != 4 or parts[0] != "topology":
        return None
    fields = []
    for tok in parts[1:]:
        if tok == "*":
            fields.append(None)
            continue
        try:
            val = int(tok)
        except ValueError:
            return None
        if val < 1:
            return None
        fields.append(val)
    return tuple(fields)


def _specificity(key):
    pinned = sum(1 for f in key if f is not None)
    return (-pinned, tuple(0 if f is not None else 1 for f in key))


def _geometry_problem(parts):
    """The reason a ``geometry`` line is malformed, or None."""
    if len(parts) != 3:
        return "expected geometry <var> <bytes>"
    if parts[1] not in GEOMETRY_VARS:
        return (f"unknown geometry var {parts[1]!r} (one of "
                + ", ".join(GEOMETRY_VARS) + ")")
    try:
        nbytes = int(parts[2])
    except ValueError:
        return "non-integer geometry bytes"
    return "geometry bytes must be positive" if nbytes < 1 else None


def _rule_problem(parts):
    """The reason a rule line is malformed, or None."""
    if len(parts) != 4:
        return "expected <op> <comm_min> <bytes_min> <alg>"
    try:
        int(parts[1]), int(parts[2])
    except ValueError:
        return "non-integer comm/byte threshold"
    if _alg_validator is not None and not _alg_validator(parts[0], parts[3]):
        return f"unknown op/algorithm {parts[0]}/{parts[3]}"
    return None


def parse_table(text, origin="<table>", problems=None):
    """Parse a sectioned tuned table, degrading LOUDLY per line: every
    malformed header/rule/geometry line is reported (and collected into
    ``problems`` when given) and skipped, and rule lines under an
    unparseable header are quarantined — reported and never served —
    rather than misfiled into the previous topology."""
    by_key = {}
    order = []
    current = _WILDCARD
    quarantined = False
    for lineno, line in enumerate((text or "").splitlines(), 1):
        stripped = line.split("#")[0].strip()
        if not stripped:
            continue
        if stripped.startswith("["):
            key = (_parse_header(stripped[1:-1].split())
                   if stripped.endswith("]") else None)
            if key is None:
                reason = ("unterminated [topology ...] header"
                          if not stripped.endswith("]") else
                          "expected [topology <n_hosts|*> <n_domains|*> "
                          "<ranks_per_domain|*>]")
                _complain(origin, lineno, line, reason, problems)
                quarantined = True
                continue
            current = key
            quarantined = False
            continue
        if quarantined:
            _complain(origin, lineno, line,
                      "line under an unparseable [topology ...] header",
                      problems)
            continue
        parts = stripped.split()
        geometry = parts[0] == "geometry"
        reason = _geometry_problem(parts) if geometry else _rule_problem(parts)
        if reason is not None:
            _complain(origin, lineno, line, reason, problems)
            continue
        if current not in by_key:
            by_key[current] = ([], {})
            order.append(current)
        if geometry:
            by_key[current][1][parts[1]] = int(parts[2])
        else:
            by_key[current][0].append(
                (parts[0], int(parts[1]), int(parts[2]), parts[3]))
    sections = [(key, by_key[key][0], by_key[key][1]) for key in order]
    sections.sort(key=lambda s: _specificity(s[0]))
    return sections


def _matches(section_key, job_key) -> bool:
    for want, have in zip(section_key, job_key or _WILDCARD):
        if want is not None and want != have:
            return False
    return True


def _section_rule(sections, opname, comm_size, nbytes, job_key):
    for key, rules, _geom in sections:
        if not _matches(key, job_key):
            continue
        best = None
        best_at = (-1, -1)
        for op, cmin, bmin, algname in rules:
            if (op == opname and comm_size >= cmin and nbytes >= bmin
                    and (cmin, bmin) > best_at):
                best, best_at = algname, (cmin, bmin)
        if best is not None:
            return best
    return None


# path -> ((mtime_ns, size), sections): a rules file rewritten in place is
# reloaded on its next use
_file_cache: dict = {}


def invalidate_cache() -> None:
    """Drop all cached table state."""
    _file_cache.clear()


def file_stamp(path):
    """``(mtime_ns, size)`` of ``path``, or None when it cannot be read."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def load_file(path):
    """Parse ``path`` into sections through the (mtime_ns, size)-stamped
    cache; unreadable files degrade loudly to an empty table."""
    stamp = file_stamp(path)
    hit = _file_cache.get(path)
    if stamp is not None and hit is not None and hit[0] == stamp:
        return hit[1]
    try:
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
    except OSError as e:
        mca_output.emit(
            _stream,
            "tuned table file %r unreadable (%s); falling back to fixed "
            "decisions", path, e,
        )
        _file_cache.pop(path, None)
        return []
    sections = parse_table(text, origin=path)
    _file_cache[path] = (stamp, sections)
    return sections


def job_topology_key():
    """The job's ``(n_hosts, n_domains, ranks_per_domain)`` key from the
    ``coll_tuned_topology`` var, or None (match wildcard sections only).
    Malformed values degrade loudly to None, never raise."""
    raw = str(mca_var.get("coll_tuned_topology", "")).strip()
    if not raw:
        return None
    fields = []
    for tok in raw.split(":"):
        try:
            fields.append(int(tok))
        except ValueError:
            fields = None
            break
    if not fields or len(fields) != 3 or any(f < 1 for f in fields):
        mca_output.emit(
            _stream,
            "coll_tuned_topology %r malformed (want "
            "'n_hosts:n_domains:ranks_per_domain', positive ints); "
            "matching wildcard sections only", raw,
        )
        return None
    return tuple(fields)


def _refuse_store() -> None:
    """With ``ZMPI_PMIX`` set, the store-served table would come first;
    that rung needs ``runtime/pmix.py``, so raise instead of silently
    skipping it."""
    if os.environ.get("ZMPI_PMIX", ""):
        raise errors.UnsupportedError(
            "ZMPI_PMIX is set: the store-served tuned table needs "
            "runtime/pmix.py, which the PyTorch port has not ported yet; "
            "unset ZMPI_PMIX or use coll_tuned_dynamic_rules")


def active() -> bool:
    """Cheap gate for the hot seams: is a table configured (the
    ``coll_tuned_dynamic_rules`` file)?  Raises under ``ZMPI_PMIX``."""
    _refuse_store()
    return bool(mca_var.get("coll_tuned_dynamic_rules", ""))


def resolve_rule(opname, comm_size, nbytes, job_key=None):
    """Resolve ``(op, comm_size, nbytes)`` through the table named by
    ``coll_tuned_dynamic_rules``, else None (the caller's builtin fixed
    decision applies).  Raises under ``ZMPI_PMIX`` (the store rung)."""
    _refuse_store()
    path = mca_var.get("coll_tuned_dynamic_rules", "")
    if not path:
        return None
    return _section_rule(load_file(str(path)), opname, comm_size, nbytes,
                         job_key)


def table_geometry(varname, job_key=None):
    """A swept segment-geometry var (one of :data:`GEOMETRY_VARS`) from
    the first section of the rules file that matches ``job_key`` and
    sizes it; None when none does.  Raises under ``ZMPI_PMIX``."""
    _refuse_store()
    if varname not in GEOMETRY_VARS:
        return None
    path = mca_var.get("coll_tuned_dynamic_rules", "")
    if path:
        for key, _rules, geom in load_file(str(path)):
            if _matches(key, job_key) and varname in geom:
                return geom[varname]
    return None
