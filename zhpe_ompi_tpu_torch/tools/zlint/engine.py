"""zlint engine: file walking, suppressions, baseline, rule driving
(namesake: ``zhpe_ompi_tpu/tools/zlint/engine.py``).

The engine is deliberately small: it parses every ``.py`` file once,
hands each parsed module to every registered rule (``visit``), then
lets cross-file rules reconcile their accumulated state (``finalize``
— the lock-order graph, the SPC doc-parity and MCA-registry-parity
audits need the whole scan set).  Findings carry a *stable key*
(path + rule + enclosing qualname + rule-specific detail, no line
numbers) so the checked-in baseline survives unrelated edits.
"""

from __future__ import annotations

import ast
import io
import os
import re
import sys
import tokenize
from dataclasses import dataclass, field

#: ``# zlint: disable=ZL001,ZL002 -- reason text`` (reason mandatory)
_SUPPRESS_RE = re.compile(
    r"#\s*zlint:\s*disable=([A-Za-z0-9,\s]+?)\s*(?:--\s*(\S.*))?$"
)

#: engine-level pseudo-rule id: parse errors and malformed suppressions
ENGINE_RULE = "ZL000"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # display path (as walked)
    path_key: str      # package-rooted stable path for the baseline
    line: int
    qualname: str      # enclosing Class.function scope ("<module>" at top)
    detail: str        # rule-specific stable fingerprint (no line numbers)
    message: str

    def key(self) -> str:
        """The baseline identity: stable across line-number drift."""
        return f"{self.path_key}|{self.rule}|{self.qualname}|{self.detail}"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule} [{self.qualname}] "
            f"{self.message}"
        )


def _path_key(abspath: str) -> str:
    """Stable, location-independent identity for a scanned file: rooted
    at the last ``zhpe_ompi_tpu_torch/`` package component when present
    (the real scan), else the basename (test fixtures in tmp dirs)."""
    norm = abspath.replace(os.sep, "/")
    marker = "/zhpe_ompi_tpu_torch/"
    idx = norm.rfind(marker)
    if idx >= 0:
        return "zhpe_ompi_tpu_torch/" + norm[idx + len(marker):]
    return os.path.basename(norm)


class Module:
    """One parsed file plus the lookups every rule needs."""

    def __init__(self, path: str, src: str):
        self.path = path
        self.path_key = _path_key(os.path.abspath(path))
        self.src = src
        self.tree = ast.parse(src, filename=path)
        # suppressions: line -> set of rule ids; malformed ones (missing
        # the mandatory reason) recorded for the engine to flag
        self.suppress: dict[int, set[str]] = {}
        self.bad_suppressions: list[int] = []
        self._scan_comments()
        # parent links for qualname resolution
        self._parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    def _scan_comments(self) -> None:
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.src).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                if not m.group(2):
                    # reason text is mandatory: a reasonless suppression
                    # is inert AND a finding
                    self.bad_suppressions.append(tok.start[0])
                    continue
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.suppress.setdefault(tok.start[0], set()).update(rules)
        except tokenize.TokenizeError:
            pass

    def qualname(self, node: ast.AST) -> str:
        parts: list[str] = []
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                parts.append(cur.name)
            cur = self._parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    def enclosing_function(
        self, node: ast.AST
    ) -> ast.FunctionDef | ast.AsyncFunctionDef | None:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self._parents.get(cur)
        return None

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(node)

    def is_suppressed(self, rule: str, line: int) -> bool:
        """A finding is suppressed by a comment on its own line or the
        line directly above (the statement-decoration idiom)."""
        for ln in (line, line - 1):
            rules = self.suppress.get(ln)
            if rules and (rule in rules or "all" in rules):
                return True
        return False

    def finding(self, rule: str, node: ast.AST, detail: str, message: str
                ) -> Finding:
        return Finding(
            rule=rule, path=self.path, path_key=self.path_key,
            line=getattr(node, "lineno", 1), qualname=self.qualname(node),
            detail=detail, message=message,
        )


# -- shared AST helpers (used by the rules) ------------------------------


def dotted_name(node: ast.AST) -> str | None:
    """``self._rndv_lock`` / ``ch.lock`` / ``lock`` as text; None for
    anything that is not a plain name/attribute chain."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        if base is None:
            return None
        return f"{base}.{node.attr}"
    return None


def call_name(node: ast.Call) -> str | None:
    """The called function's LAST name component (``isend`` for both
    ``ep.isend(...)`` and ``isend(...)``)."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


def call_receiver(node: ast.Call) -> str | None:
    """Dotted receiver of a method call (``mca_var`` for
    ``mca_var.get(...)``); None for bare-name calls."""
    if isinstance(node.func, ast.Attribute):
        return dotted_name(node.func.value)
    return None


_UNFOLDABLE = object()


def const_fold(node: ast.AST, mod: Module | None = None):
    """Fold a constant expression (``64 * 1024``, ``128 << 10``,
    ``-1``, tuples of constants); resolves one hop of module-level
    ``NAME = <const>`` assignments when ``mod`` is given.  Returns
    the value or the ``UNFOLDABLE`` sentinel."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(
        node.op, (ast.USub, ast.UAdd, ast.Invert)
    ):
        v = const_fold(node.operand, mod)
        if v is _UNFOLDABLE:
            return _UNFOLDABLE
        try:
            if isinstance(node.op, ast.USub):
                return -v
            if isinstance(node.op, ast.UAdd):
                return +v
            return ~v
        except TypeError:
            return _UNFOLDABLE
    if isinstance(node, ast.BinOp):
        lv = const_fold(node.left, mod)
        rv = const_fold(node.right, mod)
        if lv is _UNFOLDABLE or rv is _UNFOLDABLE:
            return _UNFOLDABLE
        try:
            if isinstance(node.op, ast.Add):
                return lv + rv
            if isinstance(node.op, ast.Sub):
                return lv - rv
            if isinstance(node.op, ast.Mult):
                return lv * rv
            if isinstance(node.op, ast.Div):
                return lv / rv
            if isinstance(node.op, ast.FloorDiv):
                return lv // rv
            if isinstance(node.op, ast.Mod):
                return lv % rv
            if isinstance(node.op, ast.Pow):
                return lv ** rv
            if isinstance(node.op, ast.LShift):
                return lv << rv
            if isinstance(node.op, ast.RShift):
                return lv >> rv
            if isinstance(node.op, ast.BitOr):
                return lv | rv
            if isinstance(node.op, ast.BitAnd):
                return lv & rv
        except (TypeError, ValueError, ZeroDivisionError):
            return _UNFOLDABLE
        return _UNFOLDABLE
    if isinstance(node, ast.Tuple):
        vals = [const_fold(e, mod) for e in node.elts]
        if any(v is _UNFOLDABLE for v in vals):
            return _UNFOLDABLE
        return tuple(vals)
    if isinstance(node, ast.Name) and mod is not None:
        # one-hop module-level constant (``_DEFAULT_SMALL = 8192``)
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == node.id:
                        return const_fold(stmt.value, None)
        return _UNFOLDABLE
    return _UNFOLDABLE


const_fold.UNFOLDABLE = _UNFOLDABLE  # type: ignore[attr-defined]


# -- baseline ------------------------------------------------------------


def load_baseline(path: str) -> dict[str, str]:
    """``key -- justification`` per line; '#' comments and blanks
    ignored.  Returns key -> justification."""
    entries: dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for raw in fh:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                key, sep, reason = line.partition(" -- ")
                if not sep or not reason.strip():
                    # a baseline entry without a justification does not
                    # grandfather anything
                    continue
                entries[key.strip()] = reason.strip()
    except OSError:
        pass
    return entries


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.txt")


# -- runner --------------------------------------------------------------


def _walk_py(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        elif os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d != "__pycache__" and not d.startswith(".")
                )
                for name in sorted(names):
                    if name.endswith(".py"):
                        files.append(os.path.join(root, name))
    return files


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)
    suppressed: int = 0
    baselined: int = 0
    stale_baseline: list[str] = field(default_factory=list)
    files: int = 0

    @property
    def clean(self) -> bool:
        return not self.findings


def lint_paths(paths: list[str], baseline: str | None = None,
               rules=None) -> LintResult:
    """Lint files/dirs; returns surviving findings (suppressions and
    the baseline already applied).  ``rules`` defaults to the full
    registry (``rules.all_rules()``)."""
    if rules is None:
        from .rules import all_rules
        rules = all_rules()
    result = LintResult()
    modules: list[Module] = []
    raw: list[Finding] = []
    walked = _walk_py(paths)
    result.files = len(walked)
    for path in walked:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
            mod = Module(path, src)
        except (OSError, SyntaxError, ValueError) as e:
            raw.append(Finding(
                rule=ENGINE_RULE, path=path,
                path_key=_path_key(os.path.abspath(path)), line=1,
                qualname="<module>", detail="parse-error",
                message=f"cannot parse: {e}",
            ))
            continue
        modules.append(mod)
        for idx, line in enumerate(mod.bad_suppressions, 1):
            raw.append(Finding(
                rule=ENGINE_RULE, path=path, path_key=mod.path_key,
                line=line, qualname="<module>",
                # occurrence ordinal, NOT the line number: baseline
                # keys must survive line drift like every other rule's
                detail=f"reasonless-suppression:{idx}",
                message="suppression without the mandatory reason text "
                        "(`# zlint: disable=RULE -- reason`); ignored",
            ))
        for rule in rules:
            raw.extend(rule.visit(mod))
    for rule in rules:
        raw.extend(rule.finalize(modules))

    by_path = {m.path: m for m in modules}
    entries = load_baseline(baseline) if baseline else {}
    used: set[str] = set()
    for f in raw:
        mod = by_path.get(f.path)
        if mod is not None and f.rule != ENGINE_RULE \
                and mod.is_suppressed(f.rule, f.line):
            result.suppressed += 1
            continue
        if f.key() in entries:
            used.add(f.key())
            result.baselined += 1
            continue
        result.findings.append(f)
    result.stale_baseline = sorted(set(entries) - used)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return result


def run(paths: list[str], baseline: str | None = None,
        out=None) -> int:
    """CLI body: print findings, return the exit code (0 clean, 1
    findings, 2 nothing scanned)."""
    out = out or sys.stdout
    result = lint_paths(paths, baseline=baseline)
    if result.files == 0:
        print("zlint: no Python files found", file=out)
        return 2
    for f in result.findings:
        print(f.render(), file=out)
    for key in result.stale_baseline:
        print(f"zlint: stale baseline entry (no longer found): {key}",
              file=out)
    print(
        f"zlint: {result.files} files, {len(result.findings)} finding(s), "
        f"{result.suppressed} suppressed, {result.baselined} baselined",
        file=out,
    )
    return 1 if result.findings else 0
