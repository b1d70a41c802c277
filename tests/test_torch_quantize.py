"""Quantized SV banks (schema v3) in the port against the JAX reference.

* ``quantize`` / ``pack(..., sv_dtype=...)``: the port rounds an fp32
  bank to fp16 and bf16 with the reference's bits (round to nearest,
  ties to even; a bf16 bank held as its uint16 pattern), re-rounds a
  quantized bank as the reference does, and keeps biases, counts and
  routing as they were;
* v3 artifacts cross the packages both ways with equal banks, and the
  port's ``save`` of a v3 pack is array for array the reference's; fp32
  packs still write v1, low-rank packs refuse quantization;
* served decisions on one quantized pack — the port's ``Predictor``
  (``engine="pallas"`` and ``"chunked"``, on the CPU, where the decision
  kernel runs its plain version on the upcast bank) against the
  reference ``Predictor(engine="chunked")`` — agree to DF_TOL with equal
  labels, and every quantized pack holds the reference's 3e-2 gate
  against its fp32 pack;
* a quantized ``Predictor`` keeps its bank resident at the storage
  dtype (half the bytes), with ``sv_coef`` upcast once.

Toy sizes: the reference's ``tests/test_serve_service.py`` problems.
"""
import io
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core.svm import SVC as JSVC, SVR as JSVR
from repro.data.synth import (make_blobs, make_imbalanced_blobs,
                              make_synth_regression)
from repro_torch import serve as tserve
from repro_torch.core import kernel_engine as TKE
from repro_torch.core.svm import SVC as TSVC
from repro_torch.kernels import ops
from repro_torch.serve.artifact import bank_f32, bf16_bits

DF_TOL = dict(rtol=2e-4, atol=1e-4)   # tests/test_torch_serve.py
QUANT_GATE = 3e-2                     # tests/test_serve_service.py
KINDS = ("binary", "ovo", "svr")
QUANT = ("fp16", "bf16")


def _data(kind):
    if kind == "binary":
        return make_blobs(30, 2, 4, sep=3.0, seed=0)
    if kind == "ovo":
        return make_imbalanced_blobs([40, 25, 12, 9], 4, sep=3.0, seed=1)
    return make_synth_regression(60, 5, seed=2)


@pytest.fixture(scope="module")
def fitted():
    """kind -> (x, reference fit, reference fp32 pack, the same pack read
    by the port from the reference's file)."""
    out = {}
    for kind in KINDS:
        x, y = _data(kind)
        model = (JSVR(solver="smo", gamma=0.5, epsilon=0.05) if kind == "svr"
                 else JSVC(solver="smo", gamma=0.5)).fit(x, y)
        jpack = jserve.pack(model)
        buf = io.BytesIO()
        jserve.save(buf, jpack)
        buf.seek(0)
        out[kind] = (np.asarray(x, np.float32), model, jpack,
                     tserve.load(buf))
    return out


def _bits(a) -> np.ndarray:
    """The uint16 pattern of a 16-bit bank of either package."""
    a = np.asarray(a)
    return a if a.dtype == np.uint16 else a.view(np.uint16)


def _roundtrip(save, load, packed):
    buf = io.BytesIO()
    save(buf, packed)
    buf.seek(0)
    return load(buf)


def _npz(save, packed) -> dict:
    buf = io.BytesIO()
    save(buf, packed)
    buf.seek(0)
    with np.load(buf, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_bf16_rounding_matches_ml_dtypes():
    """Round to nearest, ties to even, over every binade, exact ties,
    subnormals, the overflow to inf, signed zeros, inf and NaN."""
    rng = np.random.default_rng(3)
    mags = 10.0 ** rng.uniform(-44, 38.5, 20000)
    a = (rng.choice([-1.0, 1.0], 20000) * mags).astype(np.float32)
    ties = ((rng.integers(0, 1 << 16, 2000).astype(np.uint32) << 16)
            | 0x8000).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                        1e-45, -1e-45, 1e-40, 3.4028235e38, -3.4e38,
                        1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8], np.float32)
    a = np.concatenate([a, ties[np.isfinite(ties)], special])
    np.testing.assert_array_equal(
        bf16_bits(a), a.astype(ml_dtypes.bfloat16).view(np.uint16))
    back = bank_f32(bf16_bits(a), "bf16")
    np.testing.assert_array_equal(
        back, a.astype(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("sv_dtype", QUANT)
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_gives_the_reference_bits(fitted, kind, sv_dtype):
    """quantize of the same fp32 pack: banks equal bit for bit (uint16
    views), everything else untouched; re-rounding an already quantized
    pack (to the other half type, and back to fp32) as the reference
    does."""
    _, _, jpack, tpack = fitted[kind]
    jq, tq = jserve.quantize(jpack, sv_dtype), tserve.quantize(tpack, sv_dtype)
    assert tq.sv_dtype == sv_dtype and tpack.sv_dtype == "fp32"
    assert tserve.quantize(tq, sv_dtype) is tq
    for other in ("fp32", "fp16", "bf16"):
        jo, to = jserve.quantize(jq, other), tserve.quantize(tq, other)
        for jg, tg in zip(jo.buckets, to.buckets):
            assert tg.sv_x.dtype == tserve.SV_DTYPES[other]
            for field in ("sv_x", "sv_coef"):
                want, got = getattr(jg, field), getattr(tg, field)
                if other == "fp32":
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_array_equal(_bits(got), _bits(want))
            for field in ("task_ids", "b", "sv_counts"):
                np.testing.assert_array_equal(getattr(tg, field),
                                              getattr(jg, field))
                assert getattr(tg, field).dtype == getattr(jg, field).dtype


@pytest.mark.parametrize("sv_dtype", QUANT)
@pytest.mark.parametrize("kind", KINDS)
def test_v3_artifacts_cross_the_packages(fitted, kind, sv_dtype):
    """A reference v3 artifact loads in the port and a port one in the
    reference, banks equal; the port's file is the reference's array for
    array (names, dtypes, values, meta)."""
    _, _, jpack, tpack = fitted[kind]
    jq, tq = jserve.quantize(jpack, sv_dtype), tserve.quantize(tpack, sv_dtype)
    ref_file, port_file = _npz(jserve.save, jq), _npz(tserve.save, tq)
    assert sorted(ref_file) == sorted(port_file)
    for k, want in ref_file.items():
        got = port_file[k]
        if k == "meta":
            assert json.loads(str(got)) == json.loads(str(want))
            continue
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    meta = json.loads(str(port_file["meta"]))
    assert meta["version"] == tserve.SCHEMA_VERSION_QUANT == 3
    assert meta["sv_dtype"] == sv_dtype
    in_port = _roundtrip(jserve.save, tserve.load, jq)
    in_ref = _roundtrip(tserve.save, jserve.load, tq)
    assert in_port.sv_dtype == in_ref.sv_dtype == sv_dtype
    for jg, pg, rg in zip(jq.buckets, in_port.buckets, in_ref.buckets):
        for field in ("sv_x", "sv_coef"):
            np.testing.assert_array_equal(_bits(getattr(pg, field)),
                                          _bits(getattr(jg, field)))
            np.testing.assert_array_equal(_bits(getattr(rg, field)),
                                          _bits(getattr(jg, field)))
            assert getattr(rg, field).dtype == jserve.SV_DTYPES[sv_dtype]
        assert pg.b.dtype == rg.b.dtype == np.float32


@pytest.mark.parametrize("sv_dtype", QUANT)
@pytest.mark.parametrize("kind", KINDS)
def test_quantized_decisions_match_the_reference(fitted, kind, sv_dtype):
    """One quantized pack served by both packages: the port's pallas and
    chunked predictors within DF_TOL of the reference's chunked one,
    labels equal (SVR values within DF_TOL)."""
    x, _, jpack, tpack = fitted[kind]
    want = jserve.Predictor(jserve.quantize(jpack, sv_dtype),
                            engine="chunked")
    tq = tserve.quantize(tpack, sv_dtype)
    df_want = want.decision_values(x)
    for engine in ("pallas", "chunked"):
        pred = tserve.Predictor(tq, engine=engine, device="cpu")
        np.testing.assert_allclose(pred.decision_values(x), df_want,
                                   **DF_TOL)
        if kind == "svr":
            np.testing.assert_allclose(pred.predict(x), want.predict(x),
                                       **DF_TOL)
        else:
            np.testing.assert_array_equal(pred.predict(x), want.predict(x))


@pytest.mark.parametrize("sv_dtype", QUANT)
@pytest.mark.parametrize("kind", KINDS)
def test_quantized_pack_accuracy_gate(fitted, kind, sv_dtype):
    """The reference's gate: decisions within 3e-2 of the fp32 pack's,
    labels equal (SVR values within the gate)."""
    x, _, _, tpack = fitted[kind]
    full = tserve.Predictor(tpack, engine="pallas", device="cpu")
    quant = tserve.Predictor(tserve.quantize(tpack, sv_dtype),
                             engine="pallas", device="cpu")
    delta = np.abs(quant.decision_values(x) - full.decision_values(x))
    assert delta.max() <= QUANT_GATE
    if kind == "svr":
        assert np.abs(quant.predict(x) - full.predict(x)).max() <= QUANT_GATE
    else:
        np.testing.assert_array_equal(quant.predict(x), full.predict(x))


def test_port_fit_packs_quantized():
    """pack(fit, sv_dtype=...) is quantize(pack(fit)) and writes v3."""
    x, y = make_imbalanced_blobs([40, 25, 12, 9], 4, sep=3.0, seed=1)
    clf = TSVC(gamma=0.5, device="cpu").fit(x, y)
    full = tserve.pack(clf)
    for sv_dtype in QUANT:
        packed = tserve.pack(clf, sv_dtype=sv_dtype)
        want = tserve.quantize(full, sv_dtype)
        assert packed.sv_dtype == sv_dtype
        for g, w in zip(packed.buckets, want.buckets):
            np.testing.assert_array_equal(_bits(g.sv_x), _bits(w.sv_x))
        loaded = _roundtrip(tserve.save, tserve.load, packed)
        for g, w in zip(loaded.buckets, packed.buckets):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_fp32_pack_still_writes_v1(fitted):
    """Quantization does not bump unquantized writers: fp32 SV-bank
    packs keep schema v1 with no sv_dtype, and read back as fp32."""
    _, _, _, tpack = fitted["binary"]
    meta = json.loads(str(_npz(tserve.save, tpack)["meta"]))
    assert meta["version"] == 1 and "sv_dtype" not in meta
    assert _roundtrip(tserve.save, tserve.load, tpack).sv_dtype == "fp32"
    assert _roundtrip(tserve.save, jserve.load, tpack).sv_dtype == "fp32"


def test_lowrank_pack_rejects_quantization():
    x, y = make_blobs(40, 2, 6, sep=3.0, seed=7)
    clf = TSVC(engine="rff", rank=32, gamma=0.5, device="cpu").fit(x, y)
    with pytest.raises(ValueError, match="low-rank"):
        tserve.pack(clf, sv_dtype="fp16")
    packed = tserve.pack(clf)
    with pytest.raises(ValueError, match="low-rank"):
        tserve.quantize(packed, "bf16")
    import dataclasses
    with pytest.raises(ValueError, match="low-rank"):
        dataclasses.replace(packed, sv_dtype="bf16")
    # the v2 low-rank schema still round-trips, read by both packages
    meta = json.loads(str(_npz(tserve.save, packed)["meta"]))
    assert meta["version"] == 2 and "sv_dtype" not in meta
    loaded = _roundtrip(tserve.save, tserve.load, packed)
    assert loaded.feature_map is not None and loaded.sv_dtype == "fp32"
    assert _roundtrip(tserve.save, jserve.load, packed).sv_dtype == "fp32"


def test_sv_dtype_validation(fitted):
    import dataclasses
    _, _, _, tpack = fitted["binary"]
    with pytest.raises(ValueError, match="sv_dtype"):
        tserve.quantize(tpack, "int8")
    x, y = _data("binary")
    with pytest.raises(ValueError, match="sv_dtype"):
        tserve.pack(TSVC(gamma=0.5, device="cpu").fit(x, y),
                    sv_dtype="fp64")
    with pytest.raises(ValueError, match="sv_dtype"):
        dataclasses.replace(tpack, sv_dtype="fp8")
    # a bank whose dtype is not the one its sv_dtype names
    with pytest.raises(ValueError, match="stores its banks"):
        dataclasses.replace(tpack, sv_dtype="fp16")
    bad = tserve.quantize(tpack, "bf16")
    with pytest.raises(ValueError, match="stores its banks"):
        dataclasses.replace(bad, buckets=tuple(
            g._replace(sv_x=bank_f32(g.sv_x, "bf16")) for g in bad.buckets))


@pytest.mark.parametrize("sv_dtype", QUANT)
def test_quantized_predictor_keeps_the_storage_dtype(fitted, sv_dtype):
    """The resident bank is at the storage dtype (half the fp32 bank's
    bytes; the bf16 one the stored bits), sv_coef float32; the ladder
    ledger keeps the dtype; on the CPU the decision entry serves the
    upcast bank's values bit for bit and counts no launch."""
    x, _, _, tpack = fitted["ovo"]
    tq = tserve.quantize(tpack, sv_dtype)
    want = {"fp16": torch.float16, "bf16": torch.bfloat16}[sv_dtype]
    full = tserve.Predictor(tpack, engine="pallas", device="cpu")
    pred = tserve.Predictor(tq, engine="pallas", device="cpu")
    for (sv, cf, b, _), (fsv, _, _, _), g in zip(pred._banks, full._banks,
                                                 tq.buckets):
        assert sv.dtype == want and cf.dtype == b.dtype == torch.float32
        assert 2 * sv.untyped_storage().nbytes() == \
            fsv.untyped_storage().nbytes()
        np.testing.assert_array_equal(
            sv.view(torch.int16).numpy().view(np.uint16), _bits(g.sv_x))
        np.testing.assert_array_equal(cf.numpy(),
                                      bank_f32(g.sv_coef, sv_dtype))
    ops.reset_launches()
    z = torch.from_numpy(x[:9])
    for sv, cf, b, _ in pred._banks:
        np.testing.assert_array_equal(
            ops.multitask_decision(z, sv, cf, b, gamma=0.5).numpy(),
            ops.multitask_decision(z, sv.float(), cf, b, gamma=0.5).numpy())
    assert not any(ops.launches.values())
    pred.decision_values(x[:5])
    assert {s[1] for s in pred._program_sigs} == {str(want)}


def test_fp16_bank_under_bf16_compute(fitted):
    """Under bf16 compute an fp16 bank is rounded once to bf16 at
    construction (fp16 -> float32 exactly, then to nearest even, as the
    reference's decide program does): the resident bank is those bits,
    and it serves what the fp32 pack of the fp16 values serves under
    bf16 compute, bit for bit (that bank is rounded from float32)."""
    x, _, _, tpack = fitted["ovo"]
    cfg = TKE.EngineConfig(backend="pallas", gram_dtype="bf16")
    from_fp16 = tserve.Predictor(tserve.quantize(tpack, "fp16"), engine=cfg,
                                 device="cpu")
    bf16 = tserve.Predictor(tserve.quantize(tpack, "bf16"), engine=cfg,
                            device="cpu")
    for (a, _, _, _), g in zip(from_fp16._banks,
                               tserve.quantize(tpack, "fp16").buckets):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            a.view(torch.int16).numpy().view(np.uint16),
            bf16_bits(np.asarray(g.sv_x, np.float32)))
    upcast = tserve.Predictor(
        tserve.quantize(tserve.quantize(tpack, "fp16"), "fp32"), engine=cfg,
        device="cpu")
    np.testing.assert_array_equal(from_fp16.decision_values(x),
                                  upcast.decision_values(x))
    full = tserve.Predictor(tpack, engine="pallas", device="cpu")
    for pred in (from_fp16, bf16):
        assert np.abs(pred.decision_values(x)
                      - full.decision_values(x)).max() <= QUANT_GATE
