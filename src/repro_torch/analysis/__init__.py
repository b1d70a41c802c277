"""The runtime compile guard of the port
(``repro_torch.analysis.compile_guard.CompileGuard``). The reference's
static rules (R001–R005) scan ``src/`` as they are, this package
included."""
from repro_torch.analysis.compile_guard import (  # noqa: F401
    CompileBudgetExceeded, CompileGuard)
