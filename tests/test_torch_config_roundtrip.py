"""Every public field of the port's ``SMOConfig``, ``DCDConfig`` and
``EngineConfig`` changes an observable result, or errors: the run-time
twin of lint rule R005 (a kwarg that reaches a config and is then
ignored), the counterpart of ``tests/test_config_roundtrip.py``. One
case per field, on the CPU.

Where a field acts the same way in both packages, the same inputs give
the same result in the reference (``repro.core``): on one shared Gram
(SMO trajectories part on each package's own Gram, whose last bits
differ) iteration counts equal and alphas within 1e-5; engines of the
same kind, equal low-rank widths and cache shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.core import linear, smo
from repro_torch.data import make_blobs, normalize


def _blobs(n=24, d=3, seed=0):
    rng = np.random.default_rng(seed)
    y = np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
    x = (rng.normal(size=(n, d)) + 2.0 * y[:, None]).astype(np.float32)
    return x, y


XN, YN = _blobs()
X, Y = torch.from_numpy(XN), torch.from_numpy(YN)
KP = K.KernelParams(name="rbf", gamma=0.5)


def _smo(**overrides):
    return smo.binary_smo(X, Y, cfg=smo.SMOConfig(**overrides), kernel=KP)


def _overlap_smo(**overrides):
    """Overlapping blobs solved to a MID-RUN iteration cap: the final
    convergence pass un-shrinks, so shrinking shows only where the cap
    fires while the corridor freeze is in effect."""
    x, y = make_blobs(150, 2, 10, sep=0.8, seed=3)
    yy = np.where(y == 0, 1.0, -1.0).astype(np.float32)
    x = torch.from_numpy(normalize(x))
    kp = K.resolve_gamma(K.KernelParams(), x)
    return smo.binary_smo(x, torch.from_numpy(yy), kernel=kp,
                          engine="chunked",
                          cfg=smo.SMOConfig(max_iter=320, **overrides))


def _max_iter_case():
    capped, free = _smo(max_iter=2), _smo(max_iter=100_000)
    return (int(capped.n_iter) < int(free.n_iter)
            and not bool(capped.converged) and bool(free.converged))


SMO_FIELD_CASES = {
    "C": lambda: not np.allclose(_smo(C=1.0).alpha, _smo(C=0.05).alpha),
    "tol": lambda: int(_smo(tol=1e-6).n_iter) != int(_smo(tol=0.5).n_iter),
    "max_iter": _max_iter_case,
    # the cap quantizes to check_every device iterations per check
    "check_every": lambda: (int(_smo(max_iter=2, check_every=1).n_iter)
                            != int(_smo(max_iter=2, check_every=32).n_iter)),
    "selection": lambda: (int(_smo(selection="first").n_iter)
                          != int(_smo(selection="second").n_iter)),
    "shrink_every": lambda: (int(_overlap_smo(shrink_every=1).n_active)
                             < int(_overlap_smo(shrink_every=0).n_active)),
    "shrink_slack": lambda: (
        int(_overlap_smo(shrink_every=1, shrink_slack=0.0).n_active)
        != int(_overlap_smo(shrink_every=1, shrink_slack=1000.0).n_active)),
}


@pytest.mark.parametrize("field", sorted(f.name for f in
                                         dataclasses.fields(smo.SMOConfig)))
def test_smo_config_field_observable(field):
    assert field in SMO_FIELD_CASES, (
        f"SMOConfig grew field {field!r}: add an observability case")
    assert SMO_FIELD_CASES[field](), (
        f"SMOConfig.{field} did not observably change solver behavior")


# the reference's binary_smo on the same inputs and one shared Gram
SMO_PARITY = {
    "C": [{"C": 1.0}, {"C": 0.05}],
    "tol": [{"tol": 1e-6}, {"tol": 0.5}],
    "max_iter": [{"max_iter": 2}, {"max_iter": 100_000}],
    "check_every": [{"max_iter": 2, "check_every": 1},
                    {"max_iter": 2, "check_every": 32}],
    "selection": [{"selection": "first"}, {"selection": "second"}],
}


@pytest.mark.parametrize("field", sorted(SMO_PARITY))
def test_smo_config_field_matches_reference(field):
    import jax.numpy as jnp
    from repro.core import kernel_engine as JKE
    from repro.core import kernels as JK
    from repro.core import smo as jsmo
    jx, jy = jnp.asarray(XN), jnp.asarray(YN)
    jkp = JK.KernelParams(name="rbf", gamma=0.5)
    gram = JK.rbf_gram(jx, jx, gamma=0.5)
    for kw in SMO_PARITY[field]:
        got = smo.binary_smo(X, Y, cfg=smo.SMOConfig(**kw), kernel=KP,
                             engine=KE.DenseKernelEngine(
                                 X, KP, gram=torch.tensor(
                                     np.asarray(gram))))
        want = jsmo.binary_smo(jx, jy, cfg=jsmo.SMOConfig(**kw), kernel=jkp,
                               engine=JKE.DenseKernelEngine(jx, jkp,
                                                            gram=gram))
        assert int(got.n_iter) == int(want.n_iter), kw
        assert bool(got.converged) == bool(want.converged), kw
        np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                                   atol=1e-5, err_msg=str(kw))


# ------------------------------------------------------------ DCDConfig
PHI_N = np.random.default_rng(1).normal(size=(32, 4)).astype(np.float32)
YL_N = np.where(np.arange(32) % 2 == 0, 1.0, -1.0).astype(np.float32)
PHI, YL = torch.from_numpy(PHI_N), torch.from_numpy(YL_N)


def _dcd(**overrides):
    return linear.linear_svc(PHI, YL, cfg=linear.DCDConfig(**overrides))


DCD_FIELD_CASES = {
    "C": lambda: not np.allclose(_dcd(C=1.0).alpha, _dcd(C=0.01).alpha),
    "tol": lambda: int(_dcd(tol=1e-8).n_iter) != int(_dcd(tol=0.9).n_iter),
    "max_epochs": lambda: (int(_dcd(max_epochs=1).n_iter)
                           < int(_dcd(max_epochs=1000).n_iter)),
    "bias": lambda: (float(_dcd(bias=0.0).b) == 0.0
                     and float(_dcd(bias=1.0).b) != 0.0),
}


@pytest.mark.parametrize("field", sorted(f.name for f in
                                         dataclasses.fields(linear.DCDConfig)))
def test_dcd_config_field_observable(field):
    assert field in DCD_FIELD_CASES, (
        f"DCDConfig grew field {field!r}: add an observability case")
    assert DCD_FIELD_CASES[field](), (
        f"DCDConfig.{field} did not observably change solver behavior")


# ---------------------------------------------------------- EngineConfig
def _engine(**overrides):
    return KE.make_engine(X, KP, KE.EngineConfig(**overrides))


def _backend_case():
    assert isinstance(_engine(backend="dense"), KE.DenseKernelEngine)
    assert isinstance(_engine(backend="chunked"), KE.ChunkedKernelEngine)
    assert isinstance(_engine(backend="pallas"), KE.PallasKernelEngine)
    with pytest.raises(ValueError):
        _engine(backend="no-such-backend")
    return True


def _cache_slots_case():
    eng0 = _engine(backend="chunked", cache_slots=0)
    eng8 = _engine(backend="chunked", cache_slots=8)
    return (eng0.init_cache() is None
            and eng8.init_cache().rows.shape == (8, X.shape[0]))


def _gram_calls(chunk: int) -> int:
    """Row blocks the training matvec streams at this ``chunk``."""
    eng = _engine(backend="chunked", chunk=chunk)
    calls = []
    inner = eng._gram_fn

    def counted(a, b):
        calls.append(a.shape[0])
        return inner(a, b)
    eng._gram_fn = counted
    eng.matvec(Y)
    return len(calls)


def _chunk_case():
    return _gram_calls(4) == 6 and _gram_calls(16) == 2


def _dense_limit_case():
    n = X.shape[0]
    small = _engine(backend="auto", dense_limit=n)
    big = _engine(backend="auto", dense_limit=n - 1)
    return (isinstance(small, KE.DenseKernelEngine)
            and isinstance(big, KE.ChunkedKernelEngine)
            and not isinstance(big, KE.PallasKernelEngine))


def _shard_axis_case():
    with pytest.raises(ValueError, match="shard_axis"):
        _engine(backend="sharded")
    return True


def _gram_dtype_case():
    g32 = _engine(backend="chunked", gram_dtype="fp32").full().numpy()
    g16 = _engine(backend="chunked", gram_dtype="bf16").full().numpy()
    return (not np.array_equal(g32, g16)) and np.allclose(g32, g16,
                                                          atol=5e-2)


ENGINE_FIELD_CASES = {
    "backend": _backend_case,
    "cache_slots": _cache_slots_case,
    "chunk": _chunk_case,
    "dense_limit": _dense_limit_case,
    "shard_axis": _shard_axis_case,
    "gram_dtype": _gram_dtype_case,
    "rank": lambda: (_engine(backend="rff", rank=8).rank == 8
                     and _engine(backend="rff", rank=16).rank == 16),
    "landmarks": lambda: not np.allclose(
        _engine(backend="nystrom", rank=8, landmarks="uniform").phi,
        _engine(backend="nystrom", rank=8, landmarks="kmeans++").phi),
    "seed": lambda: not np.allclose(
        _engine(backend="rff", rank=8, seed=0).phi,
        _engine(backend="rff", rank=8, seed=1).phi),
}


@pytest.mark.parametrize("field", sorted(f.name for f in
                                         dataclasses.fields(KE.EngineConfig)))
def test_engine_config_field_observable(field):
    assert field in ENGINE_FIELD_CASES, (
        f"EngineConfig grew field {field!r}: add an observability case")
    assert ENGINE_FIELD_CASES[field](), (
        f"EngineConfig.{field} did not observably change engine behavior")


def test_engine_config_fields_match_reference():
    """The fields the two packages share, with the reference's defaults;
    the same settings pick engines of the same kind and width."""
    import jax.numpy as jnp
    from repro.core import kernel_engine as JKE
    from repro.core import kernels as JK
    ours = {f.name: f.default for f in dataclasses.fields(KE.EngineConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(JKE.EngineConfig)}
    assert ours == theirs
    jx, jkp = jnp.asarray(XN), JK.KernelParams(name="rbf", gamma=0.5)
    for kw in ({"backend": "auto", "dense_limit": 24},
               {"backend": "auto", "dense_limit": 23},
               {"backend": "chunked"}, {"backend": "pallas"}):
        got = type(_engine(**kw)).__name__
        want = type(JKE.make_engine(jx, jkp, JKE.EngineConfig(**kw))).__name__
        assert got == want, kw
    for kw in ({"backend": "rff", "rank": 8}, {"backend": "nystrom",
                                               "rank": 16}):
        got = _engine(**kw).rank
        want = JKE.make_engine(jx, jkp, JKE.EngineConfig(**kw)).rank
        assert got == want, kw
    g = _engine(backend="chunked", cache_slots=8)
    jg = JKE.make_engine(jx, jkp, JKE.EngineConfig(backend="chunked",
                                                   cache_slots=8))
    assert tuple(g.init_cache().rows.shape) == tuple(
        jg.init_cache().rows.shape)
