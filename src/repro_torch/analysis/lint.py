"""CLI driver of the port's lint (the port of ``repro/analysis/lint.py``):
``python -m repro_torch.analysis.lint src/repro_torch/ [options]``.

Exit codes: 0 clean, 1 findings, 2 internal error (unparseable file,
bad arguments, broken baseline). Output is human-readable by default;
``--format json`` emits the pinned machine schema (``"schema": 1``)
that the golden tests consume (the reference's, unchanged):

    {"schema": 1,
     "findings":        [{rule, path, line, col, message}, ...],
     "suppressed":      [{rule, path, line, col, message, reason}, ...],
     "baseline_waived": [{rule, path, line, col, message}, ...],
     "counts": {"findings": N, "suppressed": N,
                "baseline_waived": N, "files": N}}

``--baseline FILE`` points at a committed JSON waiver file so a future
rule can land warn-only: each entry ``{"rule": "R0xx", "path": "..."}``
waives that rule's findings under that path prefix (omit ``path`` to
waive repo-wide). Waived findings are reported but do not affect the
exit code. The port's gate runs without one: every rule is enforced.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from repro_torch.analysis.framework import (Finding, LintResult,
                                            Project, SourceFile, run_rules)

JSON_SCHEMA_VERSION = 1


def collect_paths(roots: list[str]) -> list[str]:
    """Expand files/directories into a sorted list of .py files."""
    files: list[str] = []
    for root in roots:
        if os.path.isfile(root):
            files.append(root)
        elif os.path.isdir(root):
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"
                               and not d.startswith(".")]
                files.extend(os.path.join(dirpath, f)
                             for f in filenames if f.endswith(".py"))
        else:
            raise FileNotFoundError(root)
    return sorted(set(files))


def load_project(paths: list[str]) -> Project:
    sources = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as fh:
            sources.append(SourceFile(path, fh.read()))
    return Project(sources)


def load_baseline(path: Optional[str]) -> list[dict]:
    if path is None:
        return []
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    waivers = data["waive"] if isinstance(data, dict) else data
    if not isinstance(waivers, list):
        raise ValueError(f"baseline {path}: expected a list or "
                         f"{{'waive': [...]}} object")
    for w in waivers:
        if not isinstance(w, dict) or "rule" not in w:
            raise ValueError(f"baseline {path}: each waiver needs a "
                             f"'rule' key: {w!r}")
    return waivers


def _waived(f: Finding, waivers: list[dict]) -> bool:
    norm = f.path.replace("\\", "/")
    return any(w["rule"] == f.rule
               and norm.startswith(w.get("path", "").replace("\\", "/"))
               for w in waivers)


def apply_baseline(result: LintResult, waivers: list[dict]
                   ) -> tuple[list[Finding], list[Finding]]:
    active = [f for f in result.findings if not _waived(f, waivers)]
    waived = [f for f in result.findings if _waived(f, waivers)]
    return active, waived


def render_human(active: list[Finding], waived: list[Finding],
                 result: LintResult) -> str:
    lines = [f.render() for f in active]
    lines.extend(f"{f.render()}  [baseline]" for f in waived)
    lines.append(f"{len(active)} finding(s), {len(waived)} baseline-"
                 f"waived, {len(result.suppressed)} suppressed, "
                 f"{result.n_files} file(s) checked")
    return "\n".join(lines)


def render_json(active: list[Finding], waived: list[Finding],
                result: LintResult) -> str:
    return json.dumps({
        "schema": JSON_SCHEMA_VERSION,
        "findings": [f.to_json() for f in active],
        "suppressed": [s.to_json() for s in result.suppressed],
        "baseline_waived": [f.to_json() for f in waived],
        "counts": {"findings": len(active),
                   "suppressed": len(result.suppressed),
                   "baseline_waived": len(waived),
                   "files": result.n_files},
    }, indent=2, sort_keys=True)


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="PyTorch/CUDA static-analysis pass of the port for "
                    "this repo's shipped bug classes (R001-R005).")
    parser.add_argument("paths", nargs="+",
                        help="files or directories to lint")
    parser.add_argument("--format", choices=("human", "json"),
                        default="human")
    parser.add_argument("--baseline", default=None,
                        help="JSON waiver file for warn-only rules")
    parser.add_argument("--rules", default=None,
                        help="comma-separated subset (e.g. R001,R004)")
    args = parser.parse_args(argv)
    try:
        paths = collect_paths(args.paths)
        project = load_project(paths)
        rule_names = (None if args.rules is None
                      else [r.strip() for r in args.rules.split(",")
                            if r.strip()])
        result = run_rules(project, rule_names)
        waivers = load_baseline(args.baseline)
        active, waived = apply_baseline(result, waivers)
    except (OSError, SyntaxError, ValueError, KeyError) as exc:
        print(f"repro_torch.analysis.lint: error: {exc}", file=sys.stderr)
        return 2
    render = render_json if args.format == "json" else render_human
    print(render(active, waived, result))
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
