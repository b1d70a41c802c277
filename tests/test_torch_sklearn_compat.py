"""The port's sklearn-compatible behaviours (``repro_torch.core.svm``), held
against the reference's ``repro.core.SVC`` / ``SVR`` on the same inputs:
the counterpart of ``tests/test_sklearn_compat.py``, on the CPU.

1. binary label orientation: ``fit`` encodes ``classes_[1]`` as +1, so a
   positive ``decision_function`` margin predicts ``classes_[1]``;
2. a single-class ``y`` raises ValueError;
3. the support threshold is relative to C: small-C fits keep their
   support vectors;
4. ``gamma="scale"`` on constant / near-constant features falls back to
   1.0.

Parity with ``sklearn.svm.SVC`` itself is checked where sklearn is
installed (each such test skips alone where it is not: the machine with
the card has none).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import kernels as JK
from repro.core.svm import SVC as JSVC
from repro.core.svm import SVR as JSVR
from repro_torch.core import kernels as K
from repro_torch.core.svm import SVC, SVR
from repro_torch.data.synth import make_blobs


def _svc(**kw):
    return SVC(device="cpu", **kw)


@pytest.fixture(scope="module")
def binary_fixture():
    return make_blobs(25, 2, 4, sep=2.0, seed=7)


# ------------------------------------------------- 1. label orientation
class TestBinaryOrientation:
    def test_positive_margin_predicts_second_class(self, binary_fixture):
        x, y = binary_fixture
        clf = _svc(kernel="rbf", C=1.0, gamma=0.5).fit(x, y)
        df, pred = clf.decision_function(x), clf.predict(x)
        assert (df != 0).all()
        np.testing.assert_array_equal(
            pred, np.where(df > 0, clf.classes_[1], clf.classes_[0]))
        ref = JSVC(kernel="rbf", C=1.0, gamma=0.5).fit(x, y)
        np.testing.assert_array_equal(clf.classes_, ref.classes_)
        np.testing.assert_array_equal(pred, ref.predict(x))
        np.testing.assert_array_equal(np.sign(df),
                                      np.sign(ref.decision_function(x)))
        np.testing.assert_allclose(df, ref.decision_function(x), atol=1e-3)

    def test_orientation_holds_for_gd_solver(self, binary_fixture):
        x, y = binary_fixture
        clf = _svc(solver="gd", gd_steps=2000, gamma=0.5).fit(x, y)
        ref = JSVC(solver="gd", gd_steps=2000, gamma=0.5).fit(x, y)
        assert np.mean(clf.predict(x) == ref.predict(x)) >= 0.95

    def test_decision_sign_parity_with_sklearn(self, binary_fixture):
        sklearn_svm = pytest.importorskip("sklearn.svm")
        x, y = binary_fixture
        ours = _svc(kernel="rbf", C=1.0, gamma=0.5).fit(x, y)
        ref = sklearn_svm.SVC(kernel="rbf", C=1.0, gamma=0.5).fit(x, y)
        df_ours, df_ref = ours.decision_function(x), ref.decision_function(x)
        np.testing.assert_array_equal(ours.classes_, ref.classes_)
        np.testing.assert_array_equal(ours.predict(x), ref.predict(x))
        assert (np.abs(df_ref) > 1e-3).all()
        np.testing.assert_array_equal(np.sign(df_ours), np.sign(df_ref))
        np.testing.assert_allclose(df_ours, df_ref, rtol=1e-2, atol=1e-2)


# --------------------------------------------------- 2. single-class y
class TestSingleClass:
    def test_single_class_fit_raises(self):
        x = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
        with pytest.raises(ValueError, match="2 classes"):
            _svc().fit(x, np.zeros(10))
        with pytest.raises(ValueError, match="2 classes"):
            JSVC().fit(x, np.zeros(10))

    def test_sklearn_also_rejects_single_class(self):
        sklearn_svm = pytest.importorskip("sklearn.svm")
        with pytest.raises(ValueError):
            sklearn_svm.SVC().fit(np.ones((6, 2), np.float32), np.zeros(6))


# ------------------------------------------- 3. relative SV threshold
class TestSmallCSupportThreshold:
    def test_small_c_binary_keeps_support_vectors(self, binary_fixture):
        x, y = binary_fixture
        clf = _svc(kernel="rbf", C=1e-6, gamma=0.5).fit(x, y)
        ref = JSVC(kernel="rbf", C=1e-6, gamma=0.5).fit(x, y)
        assert clf.n_support_ == ref.n_support_ > 0
        assert np.std(clf.decision_function(x)) > 0
        assert clf.score(x, y) >= 0.9

    def test_small_c_multiclass_keeps_support_vectors(self):
        x, y = make_blobs(15, 3, 4, sep=4.0, seed=8)
        clf = _svc(kernel="rbf", C=1e-6, gamma=0.5).fit(x, y)
        ref = JSVC(kernel="rbf", C=1e-6, gamma=0.5).fit(x, y)
        assert np.all(clf.n_support_ > 0)
        np.testing.assert_array_equal(clf.n_support_, ref.n_support_)
        assert clf.score(x, y) >= 0.9

    def test_small_c_svr_keeps_support_vectors(self):
        rng = np.random.default_rng(9)
        x = rng.uniform(-1, 1, size=(50, 3)).astype(np.float32)
        yv = x[:, 0] + 0.1 * rng.normal(size=50)
        reg = SVR(C=1e-6, epsilon=0.01, gamma=0.5, device="cpu").fit(x, yv)
        ref = JSVR(C=1e-6, epsilon=0.01, gamma=0.5).fit(x, yv)
        assert reg.n_support_ == ref.n_support_ > 0
        assert np.std(reg.predict(x)) > 0

    def test_large_c_compaction_still_drops_non_svs(self, binary_fixture):
        x, y = binary_fixture
        clf = _svc(kernel="rbf", C=10.0, gamma=0.5).fit(x, y)
        assert 0 < clf.n_support_ < len(y)


# ------------------------------------------------- 4. gamma="scale"
class TestGammaScaleFallback:
    @pytest.mark.parametrize("jitter", [0.0, 1e-7])
    def test_constant_features_fall_back_to_one(self, jitter):
        x = np.full((12, 5), 3.25, np.float32)
        x[0, 0] += jitter                  # var ~ 1e-16: below the floor
        kp = K.resolve_gamma(K.KernelParams(gamma=-1.0), torch.from_numpy(x))
        jkp = JK.resolve_gamma(JK.KernelParams(gamma=-1.0), x)
        assert kp.gamma == jkp.gamma == 1.0

    def test_matches_reference_scale_on_regular_data(self):
        x, _ = make_blobs(20, 2, 6, seed=10)
        kp = K.resolve_gamma(K.KernelParams(gamma=-1.0), torch.from_numpy(x))
        jkp = JK.resolve_gamma(JK.KernelParams(gamma=-1.0), x)
        np.testing.assert_allclose(kp.gamma, 1.0 / (x.shape[1] * x.var()),
                                   rtol=1e-5)
        np.testing.assert_allclose(kp.gamma, jkp.gamma, rtol=1e-6)

    def test_fit_on_constant_features_is_not_degenerate(self):
        x = np.full((20, 4), 2.0, np.float32)
        y = np.r_[np.zeros(10), np.ones(10)]
        x[y == 1, 0] += 1e-9               # numerically constant
        assert _svc(kernel="rbf").fit(x, y).kernel_params.gamma == 1.0

    def test_explicit_gamma_untouched(self):
        x = torch.ones((8, 3))
        kp = K.resolve_gamma(K.KernelParams(gamma=0.7), x)
        assert kp.gamma == 0.7 and dataclasses.replace(kp).gamma == 0.7

    def test_refit_re_resolves_gamma_from_new_data(self):
        x1, y1 = make_blobs(15, 2, 4, sep=2.0, seed=12, cov_scale=1.0)
        x2, y2 = make_blobs(15, 2, 4, sep=20.0, seed=13, cov_scale=10.0)
        clf = _svc(kernel="rbf").fit(x1, y1)
        g1 = clf.kernel_params.gamma
        g2 = clf.fit(x2, y2).kernel_params.gamma
        assert g2 == _svc(kernel="rbf").fit(x2, y2).kernel_params.gamma
        assert g1 != g2
