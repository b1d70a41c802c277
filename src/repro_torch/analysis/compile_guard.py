"""Runtime compile guard: fail a region that makes more fresh programs
than it declared.

The counterpart of ``repro/analysis/compile_guard.py``. There a fresh
program is an XLA compilation; the port runs eagerly or replays CUDA
graphs, and what it makes per new shape are these, each counted as one
event with a name:

* a ``torch.compile`` graph: dynamo's
  ``counters["stats"]["unique_graphs"]``, read on entry and on exit,
  named by dynamo's compilation records of the region;
* a CUDA-graph capture: every ``torch.cuda.CUDAGraph.capture_begin``
  (which ``torch.cuda.graph`` calls), named by the capturing code and by
  the ``capture_label`` it runs under (the SMO solvers label theirs
  ``solve_qp`` / ``solve_qp_tasks``, a ``serve.Predictor`` a bucket's
  ``predictor program`` with its (bank signature, bucket) pairs);
* a new ``serve.Predictor`` program: a (bank signature, batch bucket)
  pair that predictor had not served, the entries of ``n_programs``;
* a new launch plan or tuner resolution: a miss of a function
  memoised with ``memoised``, the plan functions
  (``rbf_gram.gram_plan``, ``decision.decision_plan``,
  ``feature_map.rff_plan``) and the tuner's per-shape
  ``autotune.resolve_*``;
* a build of the kernel library (``kernels._build.library`` running
  nvcc).

A serving replay that should reuse the warm batch buckets fails loudly
the day a change starts making a program (or a plan) per request width
again::

    with CompileGuard(budget=0, note="mixed-size replay"):
        svc.submit(...)   # any fresh program inside -> CompileBudgetExceeded

Events from every thread count while a guard is active (a service's
worker thread makes its programs there). ``tests/torch_helpers.py`` has
a ``compile_guard`` fixture that hands tests this class.
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading
from typing import Optional

_recorders: list = []    # the event lists of the active guards
_lock = threading.Lock()
_hooked: list = []       # the CUDAGraph class once its capture is wrapped
_label = threading.local()   # .name: what this thread's captures are of


class CompileBudgetExceeded(AssertionError):
    """More fresh programs than the declared budget."""


def record(kind: str, name: str) -> None:
    """One fresh program of ``kind``: every active guard counts it. With
    no guard active it costs one list check."""
    if not _recorders:
        return
    with _lock:
        for events in _recorders:
            events.append(f"{kind} {name}")


def memoised(fn=None, *, kind: str = "plan"):
    """``functools.lru_cache(maxsize=4096)`` over a plan function whose
    misses (new plans; ``kind`` names them) are recorded; a hit costs
    what lru_cache costs. ``@memoised`` or ``@memoised(kind=...)``."""
    if fn is None:
        return functools.partial(memoised, kind=kind)

    def miss(*args, **kwargs):
        record(kind, f"{fn.__name__}{args}"
               + (f" {kwargs}" if kwargs else ""))
        return fn(*args, **kwargs)
    return functools.update_wrapper(functools.lru_cache(maxsize=4096)(miss),
                                    fn)


def _caller() -> str:
    """The first frame outside torch and this file, as "name file:line"."""
    import torch
    skip = (os.path.dirname(torch.__file__), __file__)
    frame = sys._getframe(1)
    while frame is not None and frame.f_code.co_filename.startswith(skip):
        frame = frame.f_back
    if frame is None:
        return "?"
    code = frame.f_code
    return f"{code.co_name} {code.co_filename}:{frame.f_lineno}"


@contextlib.contextmanager
def capture_label(name: str):
    """Name the CUDA-graph captures this thread begins inside the block
    (``"cuda graph capture <name> (<caller>)"``)."""
    prev = getattr(_label, "name", None)
    _label.name = name
    try:
        yield
    finally:
        _label.name = prev


def _hook_graph_capture() -> None:
    """Wrap ``torch.cuda.CUDAGraph.capture_begin`` once so every capture
    is recorded (the wrapper stays: with no guard active it passes
    through)."""
    with _lock:
        if _hooked:
            return
        import torch
        cls = torch.cuda.CUDAGraph
        begin = cls.capture_begin

        @functools.wraps(begin)
        def capture_begin(self, *args, **kwargs):
            name = getattr(_label, "name", None)
            record("cuda graph capture",
                   _caller() if name is None else f"{name} ({_caller()})")
            return begin(self, *args, **kwargs)

        cls.capture_begin = capture_begin
        _hooked.append(cls)


def _dynamo_state() -> tuple[int, list]:
    """(graphs dynamo has made, its compilation records); (0, []) where
    dynamo was never loaded (nothing compiled yet)."""
    utils = sys.modules.get("torch._dynamo.utils")
    if utils is None:
        return 0, []
    records = getattr(utils, "get_compilation_metrics", list)()
    return utils.counters["stats"]["unique_graphs"], list(records)


class CompileGuard:
    """Context manager bounding the fresh programs in its dynamic extent.

    ``budget``: how many fresh programs are allowed (warm ones are
    free). ``note`` names the guarded region in the failure message. The
    count and the programs' names stay readable after exit via
    ``.count`` / ``.compiled``.
    """

    def __init__(self, budget: int, note: str = ""):
        if budget < 0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        self.budget = budget
        self.note = note
        self._events: Optional[list] = None
        self._dynamo0: tuple[int, list] = (0, [])
        self._graphs: Optional[list] = None   # dynamo's, fixed at exit

    def _new_graphs(self) -> list:
        graphs0, records0 = self._dynamo0
        graphs, records = _dynamo_state()
        seen = {id(r) for r in records0}   # records0 keeps them alive
        names = [f"torch.compile {r.co_name} {r.compile_id}"
                 for r in records if id(r) not in seen]
        n = graphs - graphs0
        return names[:n] + ["torch.compile graph"] * (n - len(names))

    @property
    def compiled(self) -> list[str]:
        if self._events is None:
            return []
        with _lock:
            events = list(self._events)
        graphs = self._new_graphs() if self._graphs is None else self._graphs
        return events + graphs

    @property
    def count(self) -> int:
        return len(self.compiled)

    def __enter__(self) -> "CompileGuard":
        _hook_graph_capture()
        self._dynamo0 = _dynamo_state()
        self._graphs = None
        self._events = []
        with _lock:
            _recorders.append(self._events)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        with _lock:
            _recorders[:] = [e for e in _recorders if e is not self._events]
        self._graphs = self._new_graphs()
        if exc_type is None and self.count > self.budget:
            raise CompileBudgetExceeded(
                f"compile budget exceeded"
                f"{f' ({self.note})' if self.note else ''}: "
                f"{self.count} fresh programs > budget {self.budget} "
                f"[{', '.join(self.compiled)}] — a program or launch plan "
                f"per request width, or an undeclared new program; pad "
                f"onto the pow2 ladder or raise the declared budget with "
                f"justification")
        return False
