"""R001 and R002 in their torch meaning (the counterpart of
``repro/analysis/rules_jax.py``).

R001 has two parts.

* **Per-request programs on the serving hot path** (``serve/`` and
  ``dist.py``, the reference's scope). The reference flags request-shaped
  data fed to ``jnp`` without the pow2 ladder, or a ``jax.jit`` minted per
  call, because XLA compiles one program per distinct shape. Here the
  same leak is a ``torch.compile(...)`` built inside a hot-path function
  (a fresh graph and its guards per call), a CUDA graph captured there
  (``torch.cuda.CUDAGraph()`` / ``torch.cuda.graph(...)``) in a function
  that shows no pow2 / pad / bucket discipline (a capture and a memory
  pool per call or per width, where the ``serve.Predictor`` captures
  once a batch bucket), or a launch-plan resolver
  (``*_plan``, ``autotune.plan``, ``autotune.resolve_*``) fed a
  request-derived argument in a function that shows no pow2 / pad /
  bucket discipline: a plan (and a tuner-cache entry) per distinct
  width. ``__init__`` / ``warmup`` and cached factories are exempt, as in
  the reference.
* **Host reads in a solver's inner loop** (``core/smo.py``,
  ``core/linear.py``, ``core/gd.py``, ``core/cascade.py``). Each read of
  a device value on the host (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, or ``float(`` / ``int(`` / ``bool(`` of a tensor
  expression) inside a ``for`` / ``while`` body waits for the card to
  drain and stalls the host's issue of the next kernels. The solvers
  read once a check block (SMO) or once an epoch (DCD); those reads
  carry a ``noqa[R001]`` with their reason. A ``float`` / ``int`` /
  ``bool`` argument counts as host-evident, and is not flagged, when it
  is a constant, a ``len(...)``, a name every assignment of which in the
  function is host-evident (a host read's result, a constant, a list),
  or a subscript, arithmetic or comparison of those (a parameter is
  not: it may be a tensor).

R002 flags float64 introduced outside the certified sites (the KKT
certificate: ``kkt_violation`` and ``core/cascade.py``): ``np.float64``
and the reference's other markers, and in torch ``torch.float64``,
``torch.double`` and ``.double()``. A non-certified use needs a
``noqa`` with a reason. The reference's Pallas half
(``preferred_element_type`` on a kernel matmul) has no torch meaning:
the port's kernels are CUDA C++.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.framework import (Finding, Project, Rule,
                                            SourceFile, call_name,
                                            dotted_name, own_nodes,
                                            param_names, register,
                                            walk_functions)

# functions that legitimately build programs: construction-time uploads
# and pre-compilation entry points
_R001_EXEMPT_FUNCS = ("__init__", "warmup")
# body markers that show pow2-ladder / padding discipline
_R001_MARKERS = ("pow2", "pad", "bucket")
_R001_SOLVERS = ("core/smo.py", "core/linear.py", "core/gd.py",
                 "core/cascade.py")
# CUDA graph captures: the torch meaning of a jax.jit minted per call
_GRAPH_CAPTURES = ("torch.cuda.CUDAGraph", "torch.cuda.graph")
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")
_HOST_CASTS = ("float", "int", "bool")


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _in_serving_scope(path: str) -> bool:
    p = _norm(path)
    return "/serve/" in p or p.startswith("serve/") or p.endswith("dist.py")


def _in_solver_scope(path: str) -> bool:
    p = _norm(path)
    return any(p == s or p.endswith("/" + s) for s in _R001_SOLVERS)


def _has_ladder_marker(fn: ast.AST) -> bool:
    """Does the function body (including nested helpers) show pow2 /
    padding discipline? Markers: a ``.bit_length()`` call (the pow2
    rounding idiom) or any identifier mentioning pow2/pad/bucket."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute):
            if node.attr == "bit_length":
                return True
            if any(m in node.attr.lower() for m in _R001_MARKERS):
                return True
        elif isinstance(node, ast.Name):
            if any(m in node.id.lower() for m in _R001_MARKERS):
                return True
    return False


def _references_param(node: ast.AST, params: set[str]) -> list[str]:
    return sorted({n.id for n in ast.walk(node)
                   if isinstance(n, ast.Name) and n.id in params})


def _is_plan_call(name: str) -> bool:
    last = name.rsplit(".", 1)[-1]
    return (last.endswith("_plan") or name == "autotune.plan"
            or name.startswith("autotune.resolve_"))


def _cached(fn) -> bool:
    """An lru_cache'd factory builds its program once per static config."""
    for d in fn.decorator_list:
        target = d.func if isinstance(d, ast.Call) else d
        if "cache" in dotted_name(target).lower():
            return True
    return False


def _host_read(node: ast.Call) -> bool:
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_METHODS and not node.args)


def _host_names(fn) -> set[str]:
    """Names every binding of which in ``fn`` is host-evident (the
    greatest fixed point, so that ``n += 1`` on a host ``n`` stays host).
    Parameters and loop targets are not."""
    binds: dict[str, list] = {}

    def bind(target, value) -> None:
        if isinstance(target, ast.Name):
            binds.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            pairs = (isinstance(value, (ast.Tuple, ast.List))
                     and len(value.elts) == len(target.elts))
            for i, t in enumerate(target.elts):
                # unpacking a host read's list gives host values
                bind(t, value.elts[i] if pairs else (
                    value if isinstance(value, ast.Call)
                    and _host_read(value) else None))

    for node in own_nodes(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                bind(t, node.value)
        elif isinstance(node, ast.AugAssign):
            bind(node.target, ast.BinOp(left=node.target, op=node.op,
                                        right=node.value))
        elif isinstance(node, ast.AnnAssign):
            bind(node.target, node.value)
        elif isinstance(node, (ast.For, ast.comprehension)):
            bind(node.target, None)
    host = set(binds)
    while True:
        new = {n for n, vals in binds.items()
               if all(v is not None and _host_evident(v, host)
                      for v in vals)}
        if new == host:
            return host
        host = new


def _host_evident(node: ast.AST, host: set[str]) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in host
    if isinstance(node, (ast.List, ast.Tuple, ast.ListComp)):
        return True
    if isinstance(node, ast.Subscript):
        return _host_evident(node.value, host)
    if isinstance(node, ast.BinOp):
        return _host_evident(node.left, host) and _host_evident(
            node.right, host)
    if isinstance(node, ast.UnaryOp):
        return _host_evident(node.operand, host)
    if isinstance(node, ast.Compare):
        return all(_host_evident(v, host)
                   for v in (node.left, *node.comparators))
    if isinstance(node, ast.BoolOp):
        return all(_host_evident(v, host) for v in node.values)
    if isinstance(node, ast.Call):
        if _host_read(node) or call_name(node) == "len":
            return True
        return call_name(node) in _HOST_CASTS and all(
            _host_evident(a, host) for a in node.args)
    return False


def _loop_bodies(fn):
    """Every node lexically inside a ``for`` / ``while`` body (or a
    ``while`` test) of ``fn``, nested functions excluded."""
    seen = set()
    for loop in own_nodes(fn):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        roots = [*loop.body, *loop.orelse]
        if isinstance(loop, ast.While):
            roots.append(loop.test)
        for root in roots:
            stack = [root]
            while stack:
                node = stack.pop()
                if id(node) in seen:
                    continue
                seen.add(id(node))
                yield node
                if not isinstance(node, (ast.FunctionDef, ast.Lambda,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef)):
                    stack.extend(ast.iter_child_nodes(node))


@register
class TorchHotPath(Rule):
    name = "R001"
    summary = ("serving/dist hot path builds a torch.compile, a CUDA "
               "graph or a launch plan per request width; or a solver "
               "reads the device from the host inside its inner loop")

    def check(self, src: SourceFile, project: Project) -> list[Finding]:
        out: list[Finding] = []
        if _in_serving_scope(src.path):
            out.extend(self._serving(src))
        if _in_solver_scope(src.path):
            out.extend(self._solver(src))
        return out

    def _serving(self, src: SourceFile) -> list[Finding]:
        out = []
        for fn in walk_functions(src.tree):
            if fn.name in _R001_EXEMPT_FUNCS or _cached(fn):
                continue
            padded = _has_ladder_marker(fn)
            params = param_names(fn)
            for node in own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if name == "torch.compile":
                    out.append(Finding(
                        rule=self.name, path=src.path, line=node.lineno,
                        col=node.col_offset,
                        message=(f"`torch.compile` called inside hot-path "
                                 f"function `{fn.name}` — every call "
                                 f"builds a fresh graph and its guards "
                                 f"(recompile per call); hoist it to "
                                 f"__init__ / module scope")))
                    continue
                if name in _GRAPH_CAPTURES:
                    if not padded:
                        out.append(Finding(
                            rule=self.name, path=src.path, line=node.lineno,
                            col=node.col_offset,
                            message=(f"`{name}` capture inside hot-path "
                                     f"function `{fn.name}` without pow2 "
                                     f"padding-bucket discipline — a CUDA "
                                     f"graph (and its memory pool) per "
                                     f"call or per distinct width; capture "
                                     f"once a batch bucket and replay")))
                    continue
                if padded or not _is_plan_call(name):
                    continue
                hot = [a for arg in (*node.args,
                                     *(k.value for k in node.keywords))
                       for a in _references_param(arg, params)]
                if hot:
                    out.append(Finding(
                        rule=self.name, path=src.path, line=node.lineno,
                        col=node.col_offset,
                        message=(f"`{name}` on request-shaped argument(s) "
                                 f"{hot} in `{fn.name}` without pow2 "
                                 f"padding-bucket discipline — one launch "
                                 f"plan (and tuner-cache entry) per "
                                 f"distinct width; pad onto the pow2 "
                                 f"ladder first")))
        return out

    def _solver(self, src: SourceFile) -> list[Finding]:
        out = []
        for fn in walk_functions(src.tree):
            host = None
            for node in _loop_bodies(fn):
                if not isinstance(node, ast.Call):
                    continue
                if _host_read(node):
                    what, line = f".{node.func.attr}()", node.func.end_lineno
                elif (isinstance(node.func, ast.Name)
                      and node.func.id in _HOST_CASTS
                      and len(node.args) == 1):
                    host = _host_names(fn) if host is None else host
                    if _host_evident(node.args[0], host):
                        continue
                    what, line = f"{node.func.id}(...)", node.lineno
                else:
                    continue
                out.append(Finding(
                    rule=self.name, path=src.path, line=line,
                    col=node.col_offset,
                    message=(f"host read `{what}` of a device value inside "
                             f"a loop of solver `{fn.name}` — the host "
                             f"waits for the card to drain at every trip; "
                             f"read once a check block / epoch and "
                             f"suppress that read with its reason")))
        return out


# --------------------------------------------------------------- R002
# the certified f64 recompute sites: full-precision KKT certificates
_R002_CERTIFIED_FILES = ("core/cascade.py",)
_R002_CERTIFIED_FUNCS = ("kkt_violation",)
_F64_NAMES = ("np.float64", "numpy.float64", "jnp.float64",
              "jax.numpy.float64", "torch.float64", "torch.double")


def _is_f64_marker(node: ast.AST) -> bool:
    if isinstance(node, (ast.Attribute, ast.Name)):
        return dotted_name(node) in _F64_NAMES
    if isinstance(node, ast.Constant) and node.value == "float64":  # repro: noqa[R002] -- the rule's own pattern literal, not a dtype use
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "double" and not node.args)


@register
class DtypeDiscipline(Rule):
    name = "R002"
    summary = ("f64 introduced outside the certified KKT-certificate "
               "sites (np.float64, torch.float64 / torch.double, "
               ".double())")

    def check(self, src: SourceFile, project: Project) -> list[Finding]:
        if any(_norm(src.path).endswith(c) for c in _R002_CERTIFIED_FILES):
            return []
        # map every node to its enclosing function name (module level ok)
        enclosing: dict[int, str] = {}
        for fn in walk_functions(src.tree):
            for node in ast.walk(fn):
                enclosing.setdefault(id(node), fn.name)
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if not _is_f64_marker(node):
                continue
            fn_name = enclosing.get(id(node), "<module>")
            if fn_name in _R002_CERTIFIED_FUNCS:
                continue
            out.append(Finding(
                rule=self.name, path=src.path, line=node.lineno,
                col=node.col_offset,
                message=(f"float64 introduced in `{fn_name}` outside "
                         f"the certified KKT-certificate sites "
                         f"({', '.join(_R002_CERTIFIED_FUNCS)} / "
                         f"{', '.join(_R002_CERTIFIED_FILES)}); keep "
                         f"device dtypes f32/bf16, or suppress with a "
                         f"reason if this is host-side diagnostics")))
        return out
