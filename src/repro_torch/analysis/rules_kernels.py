"""R003 in its torch meaning: the kernels' launch contract (the
counterpart of ``repro/analysis/rules_pallas.py``).

The reference's R003 checks what a ``pl.pallas_call`` cannot check for
itself (BlockSpec divisibility, the VMEM budget). The port launches its
CUDA kernels through ctypes: ``kernels/_build.py`` declares each
exported function's argument types by hand in its ``SIGNATURES`` table
(``argtypes``; ``restype`` is ``c_int`` for every one), and the
``extern "C"`` prototypes in ``kernels/csrc/*.cu`` define them. ctypes
trusts the table: an entry out of step with its prototype passes
arguments in the wrong registers or of the wrong width and corrupts
memory without an error. The rule parses both sides:

* the ``SIGNATURES`` dict of a module that has a ``csrc/`` directory
  beside it, by ``ast``, with the module's own aliases (``_P =
  ctypes.c_void_p``) resolved and ``[_P] * 10 + [_I]`` evaluated;
* every function defined in an ``extern "C"`` block (or declared
  ``extern "C"`` alone) of ``csrc/*.cu``, comments stripped.

One finding for each: an entry with no exported function, an exported
function with no entry, an arity that differs, a parameter whose C type
does not match its ctypes class (a pointer takes ``c_void_p``, ``int``
``c_int``, ``float`` ``c_float``; ``int64_t``, ``double`` or ``bool`` by
value each need their own class in the table), and a return type other
than ``int``. Findings are anchored in the Python file (the entry's line,
or the table's), so a ``noqa`` there applies.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.framework import (Finding, Project, Rule,
                                            SourceFile, dotted_name,
                                            register)

# C type of a by-value parameter -> the ctypes class that passes it
_C_TO_CTYPES = {
    "int": "c_int", "unsigned": "c_uint", "unsigned int": "c_uint",
    "float": "c_float", "double": "c_double", "bool": "c_bool",
    "int64_t": "c_int64", "long long": "c_longlong", "uint64_t": "c_uint64",
    "int32_t": "c_int32", "uint32_t": "c_uint32", "size_t": "c_size_t",
    "long": "c_long", "char": "c_char",
}
# ctypes classes that are the same C type on the card's host (LP64)
_SAME = {"c_int32": "c_int", "c_uint32": "c_uint", "c_longlong": "c_int64",
         "c_long": "c_int64", "c_ulonglong": "c_uint64",
         "c_size_t": "c_uint64", "c_ulong": "c_uint64"}
_POINTER = "c_void_p"

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_EXTERN = re.compile(r'extern\s+"C"\s*')
_FUNC = re.compile(r"([A-Za-z_][\w\s\*&]*?)\b([A-Za-z_]\w*)\s*\(([^()]*)\)\s*"
                   r"(?=[{;])")


def _blank(m: re.Match) -> str:
    """A comment replaced by blanks, its newlines kept (offsets hold)."""
    return re.sub(r"[^\n]", " ", m.group(0))


def _canon(name: str) -> str:
    return _SAME.get(name, name)


def c_type_class(param: str) -> str:
    """The ctypes class a C parameter declaration is passed as."""
    p = re.sub(r"\b(const|volatile|__restrict__|restrict)\b", " ", param)
    if "*" in p or "[" in p or "&" in p:
        return _POINTER
    words = p.split()
    base = " ".join(words[:-1]) if len(words) > 1 else p.strip()
    return _C_TO_CTYPES.get(base, base)


def exported_functions(cu: Path) -> dict[str, dict]:
    """``{name: {"ret", "params", "line"}}`` of every ``extern "C"``
    function of one source, its parameters as ctypes classes."""
    text = _COMMENT.sub(_blank, cu.read_text())
    out = {}
    for m in _EXTERN.finditer(text):
        at = m.end()
        if text.startswith("{", at):
            depth, i = 1, at + 1
            while depth and i < len(text):
                depth += {"{": 1, "}": -1}.get(text[i], 0)
                i += 1
            body, base = text[at + 1:i - 1], at + 1
            spans = _top_level(body)
        else:
            end = min(j for j in (text.find("{", at), text.find(";", at))
                      if j >= 0)
            body, base, spans = text[at:end + 1], at, [(0, end + 1 - at)]
        for s, e in spans:
            f = _FUNC.search(body, s, e)
            if f is None:
                continue
            ret = " ".join(f.group(1).replace("static", " ").split())
            params = [p.strip() for p in f.group(3).split(",") if p.strip()]
            if params == ["void"]:
                params = []
            out[f.group(2)] = {
                "ret": ret, "params": [c_type_class(p) for p in params],
                "decls": params,
                "line": text.count("\n", 0, base + f.start(2)) + 1}
    return out


def _top_level(body: str) -> list[tuple[int, int]]:
    """Spans of ``body`` at brace depth 0, each ending before a ``{`` or
    at a ``;`` (one declaration or function header each)."""
    spans, depth, start = [], 0, 0
    for i, ch in enumerate(body):
        if ch == "{":
            if depth == 0:
                spans.append((start, i + 1))
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                start = i + 1
        elif ch == ";" and depth == 0:
            spans.append((start, i + 1))
            start = i + 1
    return spans


def _aliases(tree: ast.Module) -> dict[str, str]:
    """Module-level ``_X = ctypes.c_y`` aliases -> ``c_y``."""
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            d = dotted_name(node.value)
            if d.startswith("ctypes.c_"):
                out[node.targets[0].id] = d.split(".", 1)[1]
    return out


def _eval_list(node: ast.AST, aliases: dict[str, str]) -> list[str]:
    """A SIGNATURES value: a list of ctypes classes, ``+`` and ``*``."""
    if isinstance(node, ast.List):
        out = []
        for e in node.elts:
            d = dotted_name(e)
            out.append(aliases.get(d, d.split(".")[-1] if d else "?"))
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _eval_list(node.left, aliases) + _eval_list(node.right,
                                                           aliases)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        lst, n = node.left, node.right
        if isinstance(lst, ast.Constant):
            lst, n = n, lst
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return _eval_list(lst, aliases) * n.value
    raise ValueError(f"line {node.lineno}: SIGNATURES value is not a list "
                     f"of ctypes classes")


def signatures(tree: ast.Module) -> tuple[int, dict[str, tuple]] | None:
    """``(line of the table, {name: (line, [ctypes class, ...])})`` of a
    module-level ``SIGNATURES = {...}``, or None."""
    aliases = _aliases(tree)
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "SIGNATURES"
                and isinstance(node.value, ast.Dict)):
            table = {}
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    table[k.value] = (k.lineno, _eval_list(v, aliases))
            return node.lineno, table
    return None


@register
class LaunchContract(Rule):
    name = "R003"
    summary = ("kernels/_build.py SIGNATURES out of step with the "
               "extern \"C\" prototypes of csrc/*.cu: a missing symbol or "
               "entry, an arity, a parameter type or a return type")

    def check(self, src: SourceFile, project: Project) -> list[Finding]:
        csrc = Path(src.path).parent / "csrc"
        found = signatures(src.tree) if csrc.is_dir() else None
        if found is None:
            return []
        table_line, table = found
        exported = {}
        for cu in sorted(csrc.glob("*.cu")):
            for name, fn in exported_functions(cu).items():
                exported[name] = dict(fn, file=f"csrc/{cu.name}")
        out: list[Finding] = []

        def report(line: int, msg: str) -> None:
            out.append(Finding(rule=self.name, path=src.path, line=line,
                               col=0, message=msg))

        for name, (line, args) in table.items():
            fn = exported.get(name)
            if fn is None:
                report(line, f"SIGNATURES entry `{name}` has no extern \"C\" "
                             f"function in csrc/*.cu — ctypes would fail "
                             f"to bind it")
                continue
            where = f"{fn['file']}:{fn['line']}"
            if fn["ret"] != "int":
                report(line, f"`{name}` ({where}) returns `{fn['ret']}`, "
                             f"but its restype is c_int — every exported "
                             f"function returns its cudaError_t as int")
            if len(args) != len(fn["params"]):
                report(line, f"`{name}`: SIGNATURES has {len(args)} "
                             f"argument(s), the prototype ({where}) "
                             f"{len(fn['params'])} — ctypes passes the "
                             f"rest in the wrong registers")
                continue
            for i, (got, want) in enumerate(zip(args, fn["params"])):
                if _canon(got) != _canon(want):
                    report(line, f"`{name}` argument {i} "
                                 f"(`{fn['decls'][i]}`, {where}) is "
                                 f"passed as {got}, not {want}")
        for name in sorted(set(exported) - set(table)):
            fn = exported[name]
            report(table_line, f"`{name}` ({fn['file']}:{fn['line']}) is "
                               f"exported but has no SIGNATURES entry — "
                               f"its arguments would go through ctypes' "
                               f"defaults")
        return out
