"""R005 trapped-kwargs: config fields accepted but never consumed (the
port's copy of ``repro/analysis/rules_config.py``; the rule means the
same in torch).

The ``max_iter`` bug class: a constructor accepts a tuning kwarg,
stores it on ``self`` — and no code ever reads it back, so the user's
setting silently does nothing. Statically visible in two shapes:

* ``self.X = kwarg`` in ``__init__`` where the attribute ``X`` is
  loaded NOWHERE in the analyzed tree (checked against the
  project-wide attribute-load index, including ``getattr(obj, "X")``
  string literals) — the kwarg reaches a shelf, not a solver config;
* a parameter of ``__init__`` or a public module-level function that
  is never referenced in the body at all.

Exemptions: trivial bodies (interface stubs), underscore-prefixed
params (documented-unused), and ``*args``/``**kwargs`` catch-alls
(pass-through by construction). Cross-file consumption is what the
project index is for — ``SVC.__init__`` storing ``self.C`` is consumed
because the fit path loads ``.C``, even from another module.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.framework import (Finding, Project, Rule,
                                            SourceFile, is_trivial_body,
                                            own_nodes, register,
                                            walk_functions)


def _explicit_params(fn) -> set[str]:
    """Named params only — vararg/kwarg catch-alls are pass-through."""
    a = fn.args
    return {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)
            if p.arg not in ("self", "cls")
            and not p.arg.startswith("_")}


@register
class TrappedKwargs(Rule):
    name = "R005"
    summary = ("config kwarg accepted but never consumed: stored on self "
               "with no attribute load anywhere in the tree, or a "
               "parameter the body never reads")

    def check(self, src: SourceFile, project: Project) -> list[Finding]:
        out: list[Finding] = []
        module_level = {n for n in src.tree.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        for fn in walk_functions(src.tree):
            is_init = fn.name == "__init__"
            is_public_fn = fn in module_level and not fn.name.startswith("_")
            if not (is_init or is_public_fn):
                continue
            if is_trivial_body(fn):
                continue
            params = _explicit_params(fn)
            if not params:
                continue
            # all loads of each param (nested closures/lambdas COUNT as
            # consumption — factory functions capture their configs),
            # and the self.X = param stores
            uses: dict[str, list[ast.Name]] = {p: [] for p in params}
            stores: dict[str, list[tuple[str, ast.Assign]]] = \
                {p: [] for p in params}
            for node in ast.walk(fn):
                if node is fn:
                    continue
                if isinstance(node, ast.Name) and node.id in params:
                    uses[node.id].append(node)
            for node in own_nodes(fn):
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Name)
                        and node.value.id in params):
                    for tgt in node.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            stores[node.value.id].append((tgt.attr, node))
            for p in sorted(params):
                if not uses[p]:
                    out.append(Finding(
                        rule=self.name, path=src.path, line=fn.lineno,
                        col=fn.col_offset,
                        message=(f"`{fn.name}` accepts `{p}` but the body "
                                 f"never reads it — the setting silently "
                                 f"does nothing (the max_iter bug class); "
                                 f"plumb it into a config or drop the "
                                 f"parameter")))
                    continue
                if not is_init or not stores[p]:
                    continue
                # stored on self and used nowhere else in the body?
                if len(uses[p]) != len(stores[p]):
                    continue
                dead = [(attr, node) for attr, node in stores[p]
                        if attr not in project.attr_loads]
                for attr, node in dead:
                    out.append(Finding(
                        rule=self.name, path=src.path, line=node.lineno,
                        col=node.col_offset,
                        message=(f"`self.{attr} = {p}` but `.{attr}` is "
                                 f"never loaded anywhere in the analyzed "
                                 f"tree — the kwarg is accepted and "
                                 f"shelved, never reaching a solver "
                                 f"config")))
        return out
