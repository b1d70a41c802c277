"""R004 lock-discipline: guarded attributes touched outside their lock
(the port's copy of ``repro/analysis/rules_threads.py``; the rule
means the same in torch).

``ServingService`` runs a worker thread and ``ModelRegistry`` is shared
across request threads; both coordinate through per-instance locks. The
bug class: an attribute the worker mutates under the lock is READ from
the submit path without it — a torn snapshot or a lost update that no
test catches deterministically. This is the Clang ``GUARDED_BY``
discipline, done lexically:

* a class opts in by declaring ``_GUARDED_BY = {"_attr": "_lock"}``
  (attribute name -> lock attribute name, a plain dict literal);
* every ``self._attr`` load/store in its methods must then sit
  lexically inside a ``with self._lock:`` block;
* ``__init__`` / ``__del__`` are exempt (no concurrent aliases exist);
* a helper documented to run under a caller-held lock annotates its
  ``def`` line with ``# repro: holds[_lock]``;
* nested functions (worker closures) do NOT inherit the enclosing
  ``with`` — they execute later, on another thread; they need their own
  acquisition or a ``holds`` annotation.

Lexical means conservative: lock-free reads that are genuinely safe
(immutable after construction) should either not be declared in
``_GUARDED_BY`` or carry a ``noqa`` with the reason.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.framework import (Finding, Project, Rule,
                                            SourceFile, dotted_name,
                                            register)


def _guarded_decl(cls: ast.ClassDef) -> dict[str, str]:
    """Extract the ``_GUARDED_BY`` dict literal, {} when absent."""
    for node in cls.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_GUARDED_BY"):
            try:
                val = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return {}
            if isinstance(val, dict):
                return {str(k): str(v) for k, v in val.items()}
    return {}


_EXEMPT_METHODS = ("__init__", "__del__", "__repr__")


@register
class LockDiscipline(Rule):
    name = "R004"
    summary = ("attribute declared in _GUARDED_BY touched outside a "
               "`with self.<lock>:` block (and without a holds[...] "
               "annotation)")

    def check(self, src: SourceFile, project: Project) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                guarded = _guarded_decl(node)
                if guarded:
                    self._check_class(src, node, guarded, out)
        return out

    def _check_class(self, src: SourceFile, cls: ast.ClassDef,
                     guarded: dict[str, str], out: list[Finding]) -> None:
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name in _EXEMPT_METHODS:
                continue
            held = set(src.holds.get(item.lineno, frozenset()))
            for stmt in item.body:
                self._visit(src, stmt, guarded, held, item.name, out)

    def _visit(self, src: SourceFile, node: ast.AST,
               guarded: dict[str, str], held: set, method: str,
               out: list[Finding]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = set()
            for it in node.items:
                name = dotted_name(it.context_expr)
                if name.startswith("self."):
                    acquired.add(name[len("self."):])
            inner = held | acquired
            for stmt in node.body:
                self._visit(src, stmt, guarded, inner, method, out)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested closure runs later / on another thread: the
            # enclosing `with` gives it nothing. Own holds[] only.
            inner = set(src.holds.get(node.lineno, frozenset()))
            for stmt in node.body:
                self._visit(src, stmt, guarded, inner,
                            f"{method}.{node.name}", out)
            return
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in guarded):
            lock = guarded[node.attr]
            if lock not in held:
                kind = ("written" if isinstance(node.ctx,
                                                (ast.Store, ast.Del))
                        else "read")
                out.append(Finding(
                    rule=self.name, path=src.path, line=node.lineno,
                    col=node.col_offset,
                    message=(f"`self.{node.attr}` {kind} in `{method}` "
                             f"outside `with self.{lock}:` — declared "
                             f"guarded by {lock} in _GUARDED_BY; acquire "
                             f"the lock or annotate the helper with "
                             f"`# repro: holds[{lock}]`")))
        for child in ast.iter_child_nodes(node):
            self._visit(src, child, guarded, held, method, out)
