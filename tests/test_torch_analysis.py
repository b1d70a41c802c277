"""The port's static-analysis pass (``repro_torch.analysis``): the
counterpart of ``tests/test_analysis.py``'s golden fixtures.

* The rules that mean the same in torch (R004 lock discipline, R005
  trapped kwargs, R002's ``np.float64``) and the framework (R000 for an
  unexplained or unknown suppression, ``noqa`` with a reason, the
  baseline, ``--rules``, the JSON schema, exit codes): both linters run
  through their ``main([... "--format", "json"])`` over the same tmp
  tree, and the two JSON reports must be equal.
* The torch meanings, one bad and one clean fixture each: R001's
  per-request programs on the serving path (``torch.compile``, a launch
  plan fed a request width) and its host reads in a solver loop; R002's
  ``torch.float64`` / ``torch.double`` / ``.double()``; R003's launch
  contract, on a tmp copy of one ``SIGNATURES`` entry of
  ``kernels/_build.py`` and its ``csrc`` source, with an arity, a type, a
  missing symbol and a return type injected.
* The shipped tree: ``python -m repro_torch.analysis.lint src/repro_torch``
  finds nothing, and every suppression carries a reason; R003 parses
  every exported function of ``csrc/*.cu``.
"""
import ast
import io
import json
import os
import shutil
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint as port_lint
from repro_torch.analysis import rules_kernels

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ROOT / "src" / "repro_torch" / "kernels"


def _main(cli, args) -> tuple[int, dict | None]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = cli.main(args)
    out = buf.getvalue()
    return code, json.loads(out) if out.strip() else None


def write(tmp_path, files: dict) -> None:
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)


def run_lint(tmp_path, files, *args, cli=port_lint):
    write(tmp_path, files)
    return _main(cli, [str(tmp_path), "--format", "json", *args])


def rules_hit(report):
    return {f["rule"] for f in report["findings"]}


# ------------------------------------------------ fixtures of both linters
R002_NP = """\
import numpy as np

def loss(x):
    return np.asarray(x, np.float64).sum()
"""

R002_NP_CLEAN = """\
import numpy as np

def kkt_violation(f, alpha):
    return np.asarray(f, np.float64).max() + alpha.sum()
"""

R004_BAD = """\
import threading

class Service:
    _GUARDED_BY = {"_stats": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._stats = {"n": 0}

    def submit(self):
        self._stats["n"] += 1

    def worker(self):
        def loop():
            return self._stats["n"]
        return loop
"""

R004_CLEAN = """\
import threading

class Service:
    _GUARDED_BY = {"_stats": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._stats = {"n": 0}

    def submit(self):
        with self._lock:
            self._stats["n"] += 1

    def _bump(self):  # repro: holds[_lock]
        self._stats["n"] += 1
"""

R005_BAD = """\
class Solver:
    def __init__(self, C=1.0, max_iter=100):
        self.C = C
        self.max_iter = max_iter

    def fit(self):
        return self.C
"""

SHARED = {
    "r002_np_float64": ({"core/thing.py": R002_NP}, ()),
    "r002_certified": ({"core/thing.py": R002_NP_CLEAN,
                        "core/cascade.py": R002_NP}, ()),
    "r004_bad": ({"serve/s.py": R004_BAD}, ()),
    "r004_clean": ({"serve/s.py": R004_CLEAN}, ()),
    "r005_bad": ({"core/s.py": R005_BAD}, ()),
    "r005_cross_file": ({"core/s.py": R005_BAD,
                         "core/user.py": "def run(s):\n    return "
                                         "s.max_iter\n"}, ()),
    "r005_public_param": ({"core/f.py": "def tune(budget, iters):\n    "
                                        "return budget\n"}, ()),
    "r005_underscore": ({"core/f.py": "def tune(budget, _iters):\n    "
                                      "return budget\n"}, ()),
    "noqa_reason": ({"core/s.py": R005_BAD.replace(
        "        self.max_iter = max_iter",
        "        self.max_iter = max_iter  "
        "# repro: noqa[R005] -- kept for pickle back-compat")}, ()),
    "r000_unexplained": ({"core/s.py": R005_BAD.replace(
        "        self.max_iter = max_iter",
        "        self.max_iter = max_iter  # repro: noqa[R005]")}, ()),
    "r000_unknown_rule": ({"core/s.py": "X = 1  # repro: noqa[R999] -- "
                                        "no such rule\n"}, ()),
    "rules_subset": ({"core/s.py": R005_BAD}, ("--rules", "R004")),
    "baseline": ({"core/s.py": R005_BAD,
                  "base.json": json.dumps({"waive": [{"rule": "R005"}]})},
                 ("--baseline", "{tmp}/base.json")),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_both_linters_give_equal_reports(tmp_path, case):
    files, args = SHARED[case]
    write(tmp_path, files)
    args = [a.replace("{tmp}", str(tmp_path)) for a in args]
    got = _main(port_lint, [str(tmp_path), "--format", "json", *args])
    want = _main(ref_lint, [str(tmp_path), "--format", "json", *args])
    assert got == want
    code, report = got
    assert report["schema"] == 1
    assert set(report) == {"schema", "findings", "suppressed",
                           "baseline_waived", "counts"}
    assert set(report["counts"]) == {"findings", "suppressed",
                                     "baseline_waived", "files"}
    assert code == (1 if report["findings"] else 0)
    expect = {"r002_np_float64": {"R002"}, "r004_bad": {"R004"},
              "r005_bad": {"R005"}, "r005_public_param": {"R005"},
              "r000_unexplained": {"R000"}, "r000_unknown_rule": {"R000"}}
    assert rules_hit(report) == expect.get(case, set())
    if case == "noqa_reason":
        assert report["suppressed"][0]["reason"] == \
            "kept for pickle back-compat"
    if case == "baseline":
        assert report["counts"]["baseline_waived"] == 1


@pytest.mark.parametrize("cli", [port_lint, ref_lint], ids=["port", "ref"])
def test_cli_exit_codes_agree(tmp_path, cli, capsys):
    (tmp_path / "clean.py").write_text("x = 1\n")
    bad = tmp_path / "bad.py"
    bad.write_text("def f(:\n")  # unparseable -> cannot certify clean
    assert cli.main([str(tmp_path / "clean.py")]) == 0
    assert cli.main([str(tmp_path / "missing.py")]) == 2
    assert cli.main([str(bad)]) == 2
    assert cli.main([str(tmp_path / "clean.py"), "--rules", "R042"]) == 2
    capsys.readouterr()


# ---------------------------------------------------- R001, torch meaning
R001_SERVE_BAD = """\
import torch
from repro_torch.kernels import autotune

def handle(model, request_rows):
    fn = torch.compile(model)
    plan = autotune.plan("decision", (len(request_rows), 128))
    return fn(request_rows), plan
"""

R001_SERVE_CLEAN = """\
import torch
from repro_torch.kernels import autotune

class Server:
    def __init__(self, model):
        self.fn = torch.compile(model)

    def handle(self, request_rows):
        bucket = 1 << (len(request_rows) - 1).bit_length()
        plan = autotune.plan("decision", (bucket, 128))
        return self.fn(request_rows), plan
"""


def test_r001_serving_bad(tmp_path):
    code, report = run_lint(tmp_path, {"serve/handler.py": R001_SERVE_BAD})
    assert code == 1 and rules_hit(report) == {"R001"}
    msgs = " ".join(f["message"] for f in report["findings"])
    assert "torch.compile" in msgs and "request_rows" in msgs
    assert len(report["findings"]) == 2


def test_r001_serving_clean_and_out_of_scope(tmp_path):
    code, report = run_lint(tmp_path,
                            {"serve/handler.py": R001_SERVE_CLEAN})
    assert code == 0, report["findings"]
    code, _ = run_lint(tmp_path / "other",
                       {"training/handler.py": R001_SERVE_BAD})
    assert code == 0


R001_CAPTURE_BAD = """\
import torch

def handle(fn, request_rows):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(request_rows)
    graph.replay()
    return out
"""

R001_CAPTURE_CLEAN = """\
import torch

class Server:
    def __init__(self, fn):
        self.fn, self.graphs = fn, {}

    def warmup(self, rows):
        graph = torch.cuda.CUDAGraph()   # exempt: captured before traffic
        with torch.cuda.graph(graph):
            self.fn(rows)

    def handle(self, request_rows):
        bucket = 1 << (len(request_rows) - 1).bit_length()
        if bucket not in self.graphs:
            self.graphs[bucket] = torch.cuda.CUDAGraph()
        self.graphs[bucket].replay()
"""


@pytest.mark.parametrize("case,findings", [("bad", 2), ("clean", 0)])
def test_r001_serving_cuda_graph_capture(tmp_path, case, findings):
    """A CUDA graph captured in a serving hot-path function is the torch
    meaning of a ``jax.jit`` minted per call: flagged (both the
    ``CUDAGraph()`` and the ``torch.cuda.graph(...)`` capture) unless the
    function shows the bucket ladder, or is ``__init__`` / ``warmup``."""
    src = R001_CAPTURE_BAD if case == "bad" else R001_CAPTURE_CLEAN
    code, report = run_lint(tmp_path, {"serve/handler.py": src})
    assert len(report["findings"]) == findings, report["findings"]
    if findings:
        assert code == 1 and rules_hit(report) == {"R001"}
        msgs = " ".join(f["message"] for f in report["findings"])
        assert "torch.cuda.CUDAGraph" in msgs and "torch.cuda.graph" in msgs
        assert "handle" in msgs
    else:
        assert code == 0
    code, _ = run_lint(tmp_path / "other",
                       {"training/handler.py": R001_CAPTURE_BAD})
    assert code == 0


R001_LOOP_BAD = """\
import torch

def solve(f, tol):
    gap = f.max() - f.min()
    n = 0
    while gap.item() > tol:
        f = f * 0.5
        gap = f.max() - f.min()
        if bool(gap < tol):
            break
        n += 1
    return f, n
"""

R001_LOOP_CLEAN = """\
import torch

def solve(f, check_every=8):
    done, n = False, 0
    while not done:
        for _ in range(check_every):
            f = f * 0.5
        gap, n_dev = torch.stack([f.max() - f.min(), f.sum()]).tolist()  # repro: noqa[R001] -- the one read a check block
        done = bool(gap <= 0.001) or int(n) > 100
        n += len(f) // len(f)
    return f, n

def descend(f, steps):
    for _ in range(steps):
        f = f - 0.1 * f
    return f
"""


def test_r001_solver_loop_bad(tmp_path):
    code, report = run_lint(tmp_path, {"core/smo.py": R001_LOOP_BAD})
    assert code == 1 and rules_hit(report) == {"R001"}
    msgs = [f["message"] for f in report["findings"]]
    assert len(msgs) == 2
    assert any(".item()" in m for m in msgs)
    assert any("bool(...)" in m for m in msgs)


def test_r001_solver_loop_clean(tmp_path):
    code, report = run_lint(tmp_path, {"core/gd.py": R001_LOOP_CLEAN})
    assert code == 0, report["findings"]
    assert report["counts"]["suppressed"] == 1
    # the same loop in a file that is not a solver is not in scope
    code, _ = run_lint(tmp_path / "other",
                       {"core/other.py": R001_LOOP_BAD})
    assert code == 0


# ---------------------------------------------------- R002, torch meaning
R002_TORCH_BAD = """\
import torch

def loss(x):
    a = x.to(torch.float64)
    b = torch.zeros(3, dtype=torch.double)
    return a.sum() + b.sum() + x.double().sum()
"""

R002_TORCH_CLEAN = """\
import torch

def kkt_violation(x):
    return x.to(torch.float64).max()

def loss(x):
    return x.to(torch.float32).sum()
"""


def test_r002_torch_float64(tmp_path):
    code, report = run_lint(tmp_path, {"core/thing.py": R002_TORCH_BAD})
    assert code == 1 and rules_hit(report) == {"R002"}
    assert len(report["findings"]) == 3


def test_r002_torch_certified_sites(tmp_path):
    code, report = run_lint(tmp_path, {"core/thing.py": R002_TORCH_CLEAN,
                                       "core/cascade.py": R002_TORCH_BAD})
    assert code == 0, report["findings"]


# ---------------------------------------------------- R003, torch meaning
def _one_entry_kernels(tmp_path, name="svm_kkt_select",
                       cu="kkt_select.cu"):
    """A kernels/ dir holding ``_build.py``'s aliases and its real entry
    for ``name``, beside a copy of ``csrc/<cu>``."""
    text = (KERNELS / "_build.py").read_text()
    tree = ast.parse(text)
    table = next(n for n in tree.body if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "SIGNATURES")
    key = next(i for i, k in enumerate(table.value.keys)
               if k.value == name)
    entry = ast.get_source_segment(text, table.value.values[key])
    d = tmp_path / "kernels"
    (d / "csrc").mkdir(parents=True)
    (d / "_build.py").write_text(
        "import ctypes\n\n_P = ctypes.c_void_p\n_I = ctypes.c_int\n"
        "_F = ctypes.c_float\n"
        f"SIGNATURES = {{\n    {name!r}: {entry},\n}}\n")
    shutil.copy(KERNELS / "csrc" / cu, d / "csrc" / cu)
    return d


def _r003(d):
    return _main(port_lint, [str(d), "--format", "json", "--rules",
                             "R003"])


def test_r003_clean_copy(tmp_path):
    d = _one_entry_kernels(tmp_path)
    code, report = _r003(d)
    assert code == 0, report["findings"]


@pytest.mark.parametrize("mutation", ["arity", "type_table", "type_proto",
                                      "missing_symbol", "return_type"])
def test_r003_reports_each_mismatch(tmp_path, mutation):
    d = _one_entry_kernels(tmp_path)
    build, cu = d / "_build.py", d / "csrc" / "kkt_select.cu"
    b, c = build.read_text(), cu.read_text()
    if mutation == "arity":
        b = b.replace("_P, _P, _P,\n", "_P, _P,\n", 1)
        assert b != build.read_text()
    elif mutation == "type_table":
        b = b.replace("_I, _I, _I", "_I, _F, _I", 1)
    elif mutation == "type_proto":
        c = c.replace("int n_tasks, int n,", "int n_tasks, int64_t n,", 1)
    elif mutation == "missing_symbol":
        c = c.replace("int svm_kkt_select(", "int svm_kkt_selects(", 1)
    else:
        c = c.replace("int svm_kkt_select(", "void svm_kkt_select(", 1)
    assert (b, c) != (build.read_text(), cu.read_text())
    build.write_text(b)
    cu.write_text(c)
    code, report = _r003(d)
    assert code == 1 and rules_hit(report) == {"R003"}
    msgs = [f["message"] for f in report["findings"]]
    want = {"arity": ["argument(s)"], "type_table": ["c_float, not c_int"],
            "type_proto": ["c_int, not c_int64"],
            "missing_symbol": ["no extern", "no SIGNATURES entry"],
            "return_type": ["returns `void`"]}[mutation]
    assert len(msgs) == len(want)
    for w in want:
        assert any(w in m for m in msgs), msgs
    assert all(f["path"].endswith("_build.py") for f in report["findings"])


def test_r003_parses_every_shipped_prototype():
    tree = ast.parse((KERNELS / "_build.py").read_text())
    _, table = rules_kernels.signatures(tree)
    exported = {}
    for cu in sorted((KERNELS / "csrc").glob("*.cu")):
        exported.update(rules_kernels.exported_functions(cu))
    assert set(exported) == set(table) and len(table) == 14
    for name, (_, args) in table.items():
        assert len(args) == len(exported[name]["params"]), name
        assert exported[name]["ret"] == "int"
    # the expression entries evaluate to their prototypes' arity
    assert len(table["svm_flash_attention_bwd"][1]) == 26
    assert len(table["svm_ssd_diag_bwd"][1]) == 20


# ------------------------------------------------------- the shipped tree
def test_shipped_port_is_lint_clean():
    code, report = _main(port_lint, [str(ROOT / "src" / "repro_torch"),
                                     "--format", "json"])
    assert code == 0, report["findings"]
    assert report["counts"]["files"] > 50
    assert report["suppressed"] and all(s["reason"]
                                        for s in report["suppressed"])
    # the solvers' permitted host reads: one a check block, one an epoch
    reads = {(os.path.basename(s["path"]), s["rule"])
             for s in report["suppressed"] if s["rule"] == "R001"}
    assert reads == {("smo.py", "R001"), ("linear.py", "R001")}

