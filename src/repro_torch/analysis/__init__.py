"""Static-analysis pass and runtime compile guard of the port.

``python -m repro_torch.analysis.lint src/repro_torch/`` runs rules
R001–R005 in their torch meaning (host reads in solver loops and
per-request programs on the serving path, dtype discipline, the CUDA
launch contract of ``kernels/_build.py``, lock discipline, trapped
kwargs); ``repro_torch.analysis.compile_guard.CompileGuard`` is the
runtime budget of fresh programs. The reference's linter
(``python -m repro.analysis.lint src/``) scans this package too.
"""
from repro_torch.analysis.compile_guard import (  # noqa: F401
    CompileBudgetExceeded, CompileGuard)
from repro_torch.analysis.framework import (  # noqa: F401
    RULES, Finding, Project, Rule, SourceFile, run_rules)

__all__ = ["CompileBudgetExceeded", "CompileGuard", "Finding", "Project",
           "Rule", "RULES", "SourceFile", "run_rules"]
