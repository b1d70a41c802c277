"""The port's boundary: what it imports, where it runs, what it refuses.

* No module of ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  jax, jaxlib, ml_dtypes or anything of the reference package ``repro``
  (the machine with the card has no JAX).
* Entry points run on the card unless asked for the CPU: ``SVC()``,
  ``SVR()`` (exact or low-rank) and ``Predictor(...)`` raise without
  CUDA unless ``device="cpu"``;
  functional entry points follow their input tensors' device.
* Features of later slices raise NotImplementedError naming the slice
  (multiclass fits, the GD solver and the cascade run; a mesh and the
  data-parallel shard modes still raise).
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import serve as tserve
from repro_torch.core import dist as tdist
from repro_torch.core import kernel_engine as TKE
from repro_torch.core import kernels as TK
from repro_torch.core import smo as tsmo
from repro_torch.core.svm import SVC, SVR
from repro_torch.data import load_iris, make_blobs

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_nothing_of_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (SVC, SVR, lambda: SVC(engine="rff"),
                 lambda: SVR(engine="rff"), lambda: SVR(engine="pallas")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    x, y = load_iris()
    keep = y < 2
    clf = SVC(device="cpu").fit(x[keep], y[keep])
    packed = tserve.pack(clf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.Predictor(packed)
    pred = tserve.Predictor(packed, device="cpu")
    np.testing.assert_array_equal(pred.predict(x[keep]), clf.predict(x[keep]))


def test_functional_entry_points_follow_their_tensors():
    x, y = make_blobs(20, 2, 3, seed=1)
    xt = torch.from_numpy(x)
    yt = torch.from_numpy(np.where(y == 0, 1.0, -1.0).astype(np.float32))
    r = tsmo.binary_smo(xt, yt, kernel=TK.KernelParams(gamma=0.5))
    assert r.alpha.device.type == "cpu" and bool(r.converged)
    eng = TKE.make_engine(xt, TK.KernelParams(gamma=0.5), "pallas")
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("cls", [SVC, SVR])
def test_gd_solver_runs(cls):
    """solver="gd" (ROADMAP A.7) runs now, on the CPU when asked."""
    x, y = make_blobs(20, 2, 3, seed=1)
    model = cls(device="cpu", solver="gd", gd_steps=50).fit(x, y)
    assert model.converged_ and model.n_iter_ == 50
    assert model.predict(x).shape == y.shape


@pytest.mark.parametrize("cls", [SVC, SVR])
@pytest.mark.parametrize("kwargs,match", [
    (dict(engine="sharded"), "A.11"),
    (dict(engine=TKE.EngineConfig(backend="sharded")), "A.11"),
])
def test_unported_options_raise(kwargs, match, cls):
    with pytest.raises(NotImplementedError, match=match):
        cls(device="cpu", **kwargs)


@pytest.mark.parametrize("engine", ["auto", "rff", "nystrom"])
def test_multiclass_fit_raises(engine):
    """Multiclass fits run now, exact and low-rank, by SMO and by GD (the
    solver knob is ignored on a low-rank engine, as in the reference);
    the task layer refuses ``shard="cascade"`` (a mode of ``SVC``, not
    of the task layer) with ValueError, and what it still refuses raises
    naming its ROADMAP item."""
    x, y = load_iris()
    clf = SVC(device="cpu", engine=engine, rank=16).fit(x, y)
    assert clf.predict(x).shape == y.shape and not clf._binary
    gd = SVC(device="cpu", engine=engine, rank=16, solver="gd",
             gd_steps=50).fit(x, y)
    assert gd.predict(x).shape == y.shape and not gd._binary
    with pytest.raises(ValueError, match="shard mode"):
        tdist.fit_taskset(clf._taskset, engine=engine, device="cpu",
                          shard="cascade")
    for kwargs, match in ((dict(shard="data"), "A.11"),
                          (dict(mesh=object()), "A.11")):
        with pytest.raises(NotImplementedError, match=match):
            tdist.fit_taskset(clf._taskset, engine=engine, device="cpu",
                              **kwargs)
