"""Lint framework of the port: source model, rule registry,
suppressions, findings (the port's copy of
``repro/analysis/framework.py``, plain ``ast`` code, kept apart so that
the port imports nothing of the JAX package).

The analysis pass is a custom AST linter for the failure modes this
repo has shipped (recompiles and host reads in hot loops, dtype drift,
lock-window races, dropped config kwargs, a ctypes table out of step
with its CUDA prototypes) — bug classes that are statically visible in
the source but invisible to generic linters. The framework layer is
rule-agnostic:

* ``SourceFile`` parses one file once and pre-extracts the inline
  directives every rule shares;
* ``Rule`` subclasses register themselves by ``name`` (R001..) via
  ``register``; ``run_rules`` drives them over a ``Project``;
* ``Project`` holds every analyzed file plus the cross-file indexes
  rules need (e.g. R005's attribute-load index: an ``__init__`` kwarg
  stored on ``self`` counts as consumed if ANY analyzed file loads an
  attribute of that name);
* findings on a line carrying a matching suppression directive are
  demoted to ``suppressed`` — but a suppression without a reason is
  itself reported (rule ``R000``), so every waiver in the tree is
  explained.

Inline directives (comments), the reference's syntax::

    # repro: noqa[R002] -- host-side diagnostic, never on the device
    # repro: noqa[R001,R004] -- <reason>
    # repro: holds[_lock]        (on a `def` line: caller holds _lock)

``noqa`` suppresses the named rules on that line; the ``-- reason`` text
is REQUIRED (an unexplained suppression is an R000 finding). ``holds``
is the lock-discipline annotation R004 trusts for internal helpers that
are documented to run under a caller-held lock. The rule IDs are the
reference's (R000–R005), each in its torch meaning: the reference's
linter scans the port too, and a ``noqa`` naming an ID it does not know
would be an R000 finding there.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterable, Optional

META_RULE = "R000"

_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa\[([A-Z0-9_,\s]+)\]\s*(?:--\s*(\S.*))?")
_HOLDS_RE = re.compile(r"#\s*repro:\s*holds\[([A-Za-z0-9_,\s]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, anchored to a source line."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}")

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


@dataclasses.dataclass(frozen=True)
class Suppression:
    """A finding waived by an inline ``noqa`` directive."""

    finding: Finding
    reason: Optional[str]

    def to_json(self) -> dict:
        d = self.finding.to_json()
        d["reason"] = self.reason
        return d


class SourceFile:
    """One parsed source file + its inline directives.

    ``path`` is the path as reported in findings (relative when the
    caller passed a relative root). Files that fail to parse raise
    ``SyntaxError`` to the caller — a tree that does not parse cannot
    be certified clean.
    """

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        # line -> (frozenset of rule names, reason or None)
        self.noqa: dict[int, tuple[frozenset, Optional[str]]] = {}
        # line -> frozenset of lock attribute names (R004 `holds`)
        self.holds: dict[int, frozenset] = {}
        for i, raw in enumerate(self.lines, start=1):
            m = _NOQA_RE.search(raw)
            if m:
                rules = frozenset(r.strip() for r in m.group(1).split(",")
                                  if r.strip())
                self.noqa[i] = (rules, m.group(2))
            h = _HOLDS_RE.search(raw)
            if h:
                self.holds[i] = frozenset(l.strip()
                                          for l in h.group(1).split(",")
                                          if l.strip())

    def suppression_for(self, finding: Finding
                        ) -> Optional[tuple[frozenset, Optional[str]]]:
        entry = self.noqa.get(finding.line)
        if entry and finding.rule in entry[0]:
            return entry
        return None


class Project:
    """Every analyzed file + lazily-built cross-file indexes."""

    def __init__(self, files: Iterable[SourceFile]):
        self.files = list(files)
        self._attr_loads: Optional[frozenset] = None

    @property
    def attr_loads(self) -> frozenset:
        """Attribute names loaded anywhere in the analyzed set — the
        consumption index R005 checks ``self.<attr> = kwarg`` stores
        against. ``getattr(obj, "name")`` string literals count too."""
        if self._attr_loads is None:
            names: set[str] = set()
            for f in self.files:
                for node in ast.walk(f.tree):
                    if (isinstance(node, ast.Attribute)
                            and isinstance(node.ctx, ast.Load)):
                        names.add(node.attr)
                    elif (isinstance(node, ast.Call)
                          and isinstance(node.func, ast.Name)
                          and node.func.id == "getattr"
                          and len(node.args) >= 2
                          and isinstance(node.args[1], ast.Constant)
                          and isinstance(node.args[1].value, str)):
                        names.add(node.args[1].value)
            self._attr_loads = frozenset(names)
        return self._attr_loads


class Rule:
    """Base class; subclasses set ``name``/``summary`` and implement
    ``check``. Register with ``@register``."""

    name: str = ""
    summary: str = ""

    def check(self, src: SourceFile, project: Project) -> list[Finding]:
        raise NotImplementedError


RULES: dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate + add to the rule registry."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"rule class {cls.__name__} has no name")
    RULES[inst.name] = inst
    return cls


# ------------------------------------------------------------- AST helpers
def dotted_name(node: ast.AST) -> str:
    """'torch.as_tensor' for Attribute/Name chains, '' when not a plain
    dotted path (calls, subscripts)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node: ast.Call) -> str:
    return dotted_name(node.func)


def walk_functions(tree: ast.AST):
    """Yield every (possibly nested) function/method definition."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def own_nodes(fn: ast.AST):
    """Walk a function body WITHOUT descending into nested function or
    class definitions (those are analyzed as their own scopes)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def param_names(fn) -> set[str]:
    a = fn.args
    names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return {n for n in names if n not in ("self", "cls")}


def is_trivial_body(fn) -> bool:
    """Docstring-only / pass / raise / Ellipsis bodies — interface
    stubs whose parameters are legitimately unread."""
    body = fn.body
    if body and isinstance(body[0], ast.Expr) and isinstance(
            body[0].value, ast.Constant):
        body = body[1:]
    return all(isinstance(s, (ast.Pass, ast.Raise)) or
               (isinstance(s, ast.Expr)
                and isinstance(s.value, ast.Constant)
                and s.value.value is Ellipsis)
               for s in body) or not body


# --------------------------------------------------------------- driver
@dataclasses.dataclass
class LintResult:
    findings: list[Finding]
    suppressed: list[Suppression]
    n_files: int


def run_rules(project: Project,
              rule_names: Optional[Iterable[str]] = None) -> LintResult:
    """Run the (selected) registered rules over every file; split raw
    findings into active vs suppressed; emit R000 for suppressions
    without a reason and for noqa directives naming unknown rules."""
    # import for side effects: rule modules self-register on import
    from repro_torch.analysis import (rules_config,  # noqa: F401
                                      rules_kernels, rules_threads,
                                      rules_torch)
    selected = (list(RULES.values()) if rule_names is None
                else [RULES[r] for r in rule_names])
    findings: list[Finding] = []
    suppressed: list[Suppression] = []
    for src in project.files:
        raw: list[Finding] = []
        for rule in selected:
            raw.extend(rule.check(src, project))
        for f in raw:
            entry = src.suppression_for(f)
            if entry is None:
                findings.append(f)
                continue
            _, reason = entry
            suppressed.append(Suppression(finding=f, reason=reason))
            if not reason:
                findings.append(Finding(
                    rule=META_RULE, path=src.path, line=f.line, col=0,
                    message=(f"unexplained suppression of {f.rule}: add "
                             f"`-- <reason>` to the noqa directive")))
        for line, (rules, _) in src.noqa.items():
            unknown = rules - set(RULES) - {META_RULE}
            if unknown:
                findings.append(Finding(
                    rule=META_RULE, path=src.path, line=line, col=0,
                    message=(f"noqa names unknown rule(s) "
                             f"{sorted(unknown)}; known: {sorted(RULES)}")))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(findings=findings, suppressed=suppressed,
                      n_files=len(project.files))
