"""The port's runtime compile guard (``repro_torch.analysis.CompileGuard``;
ROADMAP A.13) against the guard cases of ``tests/test_analysis.py``.

* The four reference cases on ``torch.compile(backend="eager",
  dynamic=False)``, where a fresh graph a distinct width is what a fresh
  XLA program a width is there: padded widths make one graph and pass,
  raw widths trip the budget, budget 0 rejects any fresh graph and lets
  cache hits through, a negative budget is refused.
* The port's own programs: a new ``Predictor`` (bank, batch bucket)
  program, a new launch plan or tuner resolution, a CUDA-graph capture
  and a kernel-library build each count once, with a name.
* The service replay of ``tests/test_serve_service.py::
  test_service_replay_stays_within_compile_budget``: after warmup at the
  covering buckets, a burst of odd-sized requests through the port's
  ``ServingService`` counts 0; a ``Predictor`` whose pow2 ladder is
  bypassed (raw request widths) trips the guard.
"""
import ctypes
import threading
import types

import numpy as np
import pytest
import torch

from repro.data.synth import make_imbalanced_blobs
from repro_torch import serve
from repro_torch.analysis import CompileBudgetExceeded, CompileGuard
from repro_torch.core.svm import SVC
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import decision as D
from torch_helpers import compile_guard  # noqa: F401  (the fixture)

TIMEOUT = 60   # seconds any future may take


def _pad(w: int) -> int:
    return 1 << max(w - 1, 0).bit_length()


# ------------------------------------------------ the reference's cases
def test_compile_guard_counts_and_passes_within_budget():
    f = torch.compile(lambda x: torch.sum(x * 2.0), backend="eager",
                      dynamic=False)
    # pow2 ladder: widths 5..8 all pad to bucket 8 -> one graph. Inputs
    # built outside the guard.
    xs = {w: torch.zeros((_pad(w),)) for w in (5, 6, 7, 8)}
    with CompileGuard(budget=1, note="padded widths") as g:
        for w in (5, 6, 7, 8):
            f(xs[w])
    assert g.count == 1
    assert "<lambda>" in g.compiled[0]
    # cache hits after exit stay free, and the count stays as it was
    f(torch.zeros((8,)))
    assert g.count == 1


def test_compile_guard_trips_when_pow2_ladder_bypassed():
    """Dispatching at RAW request widths makes one graph per distinct
    width and blows the budget the padded path satisfies."""
    f = torch.compile(lambda x: torch.sum(x * 3.0), backend="eager",
                      dynamic=False)
    with pytest.raises(CompileBudgetExceeded, match="compile budget"):
        with CompileGuard(budget=2, note="raw widths"):
            for w in (3, 5, 7, 9, 11):   # no padding: 5 distinct shapes
                f(torch.zeros((w,)))


def test_compile_guard_budget_zero_rejects_any_compile():
    f = torch.compile(lambda x: x + 1.0, backend="eager", dynamic=False)
    f(torch.zeros((4,)))                 # warm outside the guard
    with CompileGuard(budget=0):
        f(torch.zeros((4,)))             # cache hit: fine
    with pytest.raises(CompileBudgetExceeded):
        with CompileGuard(budget=0):
            f(torch.zeros((16,)))        # fresh shape


def test_compile_guard_validates_budget():
    with pytest.raises(ValueError):
        CompileGuard(budget=-1)


def test_compile_guard_lets_an_error_through():
    """An exception inside the region propagates as itself, whatever the
    count (the budget is checked on a clean exit only)."""
    with pytest.raises(KeyError):
        with CompileGuard(budget=0) as g:
            D.decision_plan(911, 3, 977, 5)     # a fresh plan
            raise KeyError("inside")
    assert g.count == 1


# ---------------------------------------------------- the port's programs
def test_plans_and_tuner_resolutions_count_once_a_shape():
    cpu = torch.device("cpu")
    with CompileGuard(budget=10) as g:
        for _ in range(3):
            D.decision_plan(913, 3, 979, 7)
            autotune.resolve_kkt(40_961, cpu)
    assert g.count == 2, g.compiled
    assert g.compiled[0].startswith("plan decision_plan(913, 3, 979, 7")
    assert g.compiled[1].startswith("tuner resolution resolve_kkt(40961")
    with CompileGuard(budget=0):        # warm: nothing new
        D.decision_plan(913, 3, 979, 7)
        autotune.resolve_kkt(40_961, cpu)


def test_raw_widths_through_a_plan_function_trip_the_guard():
    with pytest.raises(CompileBudgetExceeded, match="decision_plan"):
        with CompileGuard(budget=2, note="raw widths"):
            for t in (3001, 3005, 3007, 3011):
                D.decision_plan(t, 6, 986, 102)


def test_events_from_other_threads_count():
    with CompileGuard(budget=10) as g:
        t = threading.Thread(target=D.decision_plan, args=(917, 2, 31, 5))
        t.start()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive() and g.count == 1


def test_nested_guards_each_count():
    with CompileGuard(budget=10) as outer:
        D.decision_plan(919, 2, 31, 5)
        with CompileGuard(budget=10) as inner:
            D.decision_plan(921, 2, 31, 5)
    assert (outer.count, inner.count) == (2, 1)


def test_cuda_graph_captures_count():
    """Every ``CUDAGraph.capture_begin`` is one program. On the CPU the
    capture itself fails (there is no card), after the guard saw it;
    ``tests/test_torch_cuda.py`` captures a real graph."""
    with pytest.raises(CompileBudgetExceeded, match="cuda graph capture"):
        with CompileGuard(budget=0) as g:
            with pytest.raises(Exception):
                torch.cuda.CUDAGraph.capture_begin(object())
    assert g.count == 1
    assert "test_cuda_graph_captures_count" in g.compiled[0]


def test_kernel_library_builds_count(tmp_path, monkeypatch):
    """A ``_build.library()`` that runs nvcc is one program (nvcc and the
    loader stubbed: the CPU has neither a compiler nor a card)."""
    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", [])
    monkeypatch.setattr(_build, "build_seconds", [])
    monkeypatch.setattr(_build, "_compile", lambda path: path.touch())
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    with CompileGuard(budget=5) as g:
        _build.library()
        _build.library()   # loaded: nothing new
    assert g.count == 1
    assert g.compiled[0].startswith("kernel library build libsvm_kernels_")


# ------------------------------------------------------------ the serving
@pytest.fixture(scope="module")
def ovo_problem():
    x, y = make_imbalanced_blobs([40, 25, 12, 9], 4, sep=3.0, seed=1)
    return x, y, SVC(gamma=0.5, device="cpu").fit(x, y)


@pytest.mark.parametrize("engine", ["pallas", "chunked"])
def test_service_replay_stays_within_compile_budget(ovo_problem, engine,
                                                    compile_guard):
    """Open-loop replay with mixed request sizes through the service
    reuses the warm bucketed programs: after warmup at the covering
    buckets, a burst of odd-sized requests makes NOTHING new."""
    x, _, model = ovo_problem
    packed = serve.pack(model)
    with serve.ServingService(packed, engine=engine, window_ms=2.0,
                              device="cpu") as svc:
        # warm every bucket the burst below can land in — merged
        # windows reach ~120 rows, the 128 bucket — plus the decode path
        for t in (1, 2, 4, 8, 16, 32, 64, len(x)):
            svc.predict(x[:t])
        with compile_guard(budget=0, note="mixed-size replay") as g:
            futs = [svc.submit(x[i % 30:i % 30 + 1 + i % 5])
                    for i in range(40)]
            for f in futs:
                f.result(timeout=TIMEOUT)
        assert g.count == 0


def test_predictor_programs_count_and_raw_widths_trip(ovo_problem,
                                                      monkeypatch,
                                                      compile_guard):
    x, _, model = ovo_problem
    pred = serve.Predictor(serve.pack(model), engine="pallas", device="cpu")
    n_banks = len(serve.pack(model).buckets)
    with compile_guard(budget=100) as g:
        pred.predict(x[:3])               # bucket 4: one program a bank
        pred.predict(x[:4])               # warm
    assert g.count == n_banks == pred.n_programs
    assert all(c.startswith("predictor program ") and c.endswith(", 4)")
               for c in g.compiled)
    assert {c.split(" ", 2)[2] for c in g.compiled} == {
        str(s) for s in pred._program_sigs}
    # the pow2 ladder bypassed: a program a raw width
    monkeypatch.setattr(serve.Predictor, "_batch_bucket",
                        lambda self, t: min(self.max_batch, max(t, 1)))
    with pytest.raises(CompileBudgetExceeded, match="predictor program"):
        with compile_guard(budget=2, note="raw widths"):
            for t in (5, 6, 7):
                pred.predict(x[:t])
