"""Determinism of the port's fits: the same data and config give equal
bits on a second fit, also after the global RNG has moved (the
counterpart of ``tests/test_determinism.py``, on the CPU). Nothing in a
fit may depend on ambient state: the global generators, dict order, or
a warm cache (the tuner's is reset between the runs)."""
import numpy as np
import torch

from repro_torch.core.svm import SVC, SVR
from repro_torch.data import make_blobs, make_synth_regression, normalize
from repro_torch.kernels import autotune


def _fit_svc_binary():
    x, y = make_blobs(60, 2, 5, sep=1.5, seed=11)
    clf = SVC(kernel="rbf", C=1.0, device="cpu").fit(normalize(x), y)
    return clf.alpha_.copy(), clf.b_, clf.n_iter_


def _fit_svc_multiclass():
    x, y = make_blobs(40, 3, 5, sep=2.0, seed=12)
    clf = SVC(kernel="rbf", C=1.0, device="cpu").fit(normalize(x), y)
    return (np.asarray(clf._fit.alpha).copy(),
            np.asarray(clf._fit.b).copy(),
            clf.decision_function(normalize(x)))


def _fit_svr():
    x, y = make_synth_regression(70, 3, kind="sinc", noise=0.05, seed=13)
    reg = SVR(kernel="rbf", epsilon=0.1, device="cpu").fit(x, y)
    return reg.beta_.copy(), reg.b_, reg.alpha_raw_.copy(), reg.predict(x)


def _assert_runs_identical(fit_fn):
    first = fit_fn()
    again = fit_fn()
    torch.manual_seed(1234)          # move the global generators
    np.random.seed(1234)
    autotune.reset()                 # and drop any cached plan
    moved = fit_fn()
    for a, b, c in zip(first, again, moved):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_svc_binary_bit_identical():
    _assert_runs_identical(_fit_svc_binary)


def test_svc_multiclass_bit_identical():
    _assert_runs_identical(_fit_svc_multiclass)


def test_svr_bit_identical():
    _assert_runs_identical(_fit_svr)
