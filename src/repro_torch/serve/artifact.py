"""Packed model artifacts — the immutable, serving-side form of a fit.

Mirrors ``repro/serve/artifact.py``. A ``PackedModel`` holds either

* serving buckets — stacked, zero-padded SV banks ``sv_x`` /
  ``sv_coef`` / ``b``: one bucket for a binary SVC (kind "svc") or an
  SVR (kind "svr", coefficients beta = alpha - alpha*), and for a
  multiclass SVC (strategy "ovo" | "ovr") the pow2 SV-width buckets of
  its compaction, each a (T, w, d) bank; or
* for a low-rank fit (``engine="nystrom" | "rff"``), the feature-map
  arrays (landmarks + proj, or omega + phase, as a ``LowRankMap``) and
  the stacked linear weights ``linear_w (n_tasks, rank)`` /
  ``linear_b (n_tasks,)`` — serving is one feature transform and a
  matmul;

plus the kernel parameters, the class table, the vote-routing ``pairs``
and the OvO ``decision``, all as numpy arrays. ``save`` / ``load`` read
and write the reference's versioned ``.npz`` format
(``repro.svm-pack``) array for array: fp32 SV-bank packs write version
1, low-rank packs version 2 (meta ``feature_map``, arrays ``fm_a`` /
``fm_b`` / ``linear_w`` / ``linear_b``), quantized packs version 3, so
an artifact written by either package loads in the other.

Quantized SV banks (``pack(..., sv_dtype="fp16" | "bf16")`` or
``quantize`` on a pack) store ``sv_x`` / ``sv_coef`` at half precision
— half the artifact and half the device-resident bank — while biases,
counts and routing stay float32 / int64. Version 3 records
``meta.sv_dtype``. numpy has no bfloat16 (and this package does not
need ``ml_dtypes``), so a bf16 bank is held as its uint16 bit pattern,
which is also what the npz stores; the ``Predictor`` views it as
``torch.bfloat16`` on the device. Rounding is to nearest, ties to even,
as numpy (fp16) and ``ml_dtypes`` (bf16) round, so a bank quantized
here has the reference's bits.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core import kernels as K

SCHEMA_NAME = "repro.svm-pack"
SCHEMA_VERSION = 2                  # current writer for low-rank packs
SCHEMA_VERSION_CLASSIC = 1          # fp32 SV-bank packs
SCHEMA_VERSION_QUANT = 3            # quantized (fp16 / bf16) SV-bank packs
SCHEMA_VERSIONS = (1, 2, 3)         # what load() accepts

# storage dtypes of the SV bank (sv_x / sv_coef) as numpy holds them: a
# bf16 bank as its uint16 bit pattern (see the module docstring)
SV_DTYPES = {"fp32": np.float32, "fp16": np.float16, "bf16": np.uint16}


def bf16_bits(a) -> np.ndarray:
    """uint16 bit patterns of float32 values rounded to bfloat16, to
    nearest with ties to even (a NaN becomes the quiet NaN of its
    sign), as ``ml_dtypes`` rounds."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32)
    bits = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        bits[nan] = np.where(np.signbit(a[nan]), 0xFFC0, 0x7FC0)
    return bits


def bank_f32(a, sv_dtype: str) -> np.ndarray:
    """float32 values of a bank stored at ``sv_dtype`` (exact: every
    fp16 and bf16 value is a float32)."""
    if sv_dtype == "bf16":
        return (np.asarray(a, np.uint16).astype(np.uint32) << 16).view(
            np.float32)
    return np.asarray(a, np.float32)


def _store(a32: np.ndarray, sv_dtype: str) -> np.ndarray:
    """float32 values at the storage dtype, rounded to nearest even."""
    if sv_dtype == "bf16":
        return bf16_bits(a32)
    return np.asarray(a32, SV_DTYPES[sv_dtype])


def _check_sv_dtype(sv_dtype: str) -> None:
    if sv_dtype not in SV_DTYPES:
        raise ValueError(f"unknown sv_dtype {sv_dtype!r}; expected one of "
                         f"{sorted(SV_DTYPES)}")


class TaskBucket(NamedTuple):
    """One serving bucket: tasks stacked at a common (padded) SV width;
    padding rows carry ``sv_coef == 0``. ``sv_x`` / ``sv_coef`` are at
    the pack's ``sv_dtype`` (``SV_DTYPES``), the rest float32 / int64."""

    task_ids: np.ndarray   # (T,)   int64 global task index per stacked row
    sv_x: np.ndarray       # (T, w, d) support vectors, zero-padded
    sv_coef: np.ndarray    # (T, w) alpha_i * y_i
    b: np.ndarray          # (T,)   float32 biases
    sv_counts: np.ndarray  # (T,)   int64 real SV count per stacked task


class LowRankMap(NamedTuple):
    """Serialized feature map of a low-rank fit (``core/approx.py``).

    kind "nystrom": ``a`` = landmarks (k, d), ``b`` = proj (k, rank).
    kind "rff":     ``a`` = omega (d, rank),  ``b`` = phase (rank,).
    Rebuild with ``approx.map_from_arrays(kind, kernel, a, b)``.
    """

    kind: str
    a: np.ndarray
    b: np.ndarray


# (kind, strategy) pairs a pack may carry
_KINDS = (("svc", "binary"), ("svc", "ovo"), ("svc", "ovr"), ("svr", "svr"))


@dataclasses.dataclass(frozen=True)
class PackedModel:
    """Immutable serving artifact of an SVC or an SVR (see module
    docstring).

    kind:     "svc" | "svr".
    strategy: "binary" | "ovo" | "ovr" (SVC) or "svr".
    pairs:    (n_tasks, 2) class-index credit table — column 0 credited
              on decision > 0, column 1 on decision < 0 (-1 = no
              credit); binary packs as [[1, 0]] (a positive decision
              credits ``classes[1]``).
    """

    kind: str
    kernel: K.KernelParams
    n_features: int
    n_tasks: int
    buckets: tuple[TaskBucket, ...]
    strategy: str = "binary"
    decision: str = "vote"
    classes: Optional[np.ndarray] = None
    pairs: Optional[np.ndarray] = None
    feature_map: Optional[LowRankMap] = None
    linear_w: Optional[np.ndarray] = None   # (n_tasks, rank)
    linear_b: Optional[np.ndarray] = None   # (n_tasks,)
    sv_dtype: str = "fp32"                  # sv_x / sv_coef storage dtype

    def __post_init__(self):
        _check_sv_dtype(self.sv_dtype)
        if (self.kind, self.strategy) not in _KINDS:
            raise ValueError(f"unknown pack kind/strategy "
                             f"{self.kind}/{self.strategy}; expected one of "
                             f"{['/'.join(k) for k in _KINDS]}")
        multiclass = self.strategy in ("ovo", "ovr")
        if not multiclass and self.n_tasks != 1:
            raise ValueError("a binary or SVR pack has exactly one task")
        if multiclass and (self.classes is None or self.pairs is None
                           or self.pairs.shape != (self.n_tasks, 2)):
            raise ValueError(f"a {self.strategy} pack needs its classes and "
                             f"a ({self.n_tasks}, 2) pairs table")
        if self.feature_map is not None:
            if self.sv_dtype != "fp32":
                raise ValueError(
                    "sv_dtype quantization applies to SV banks; a "
                    "low-rank pack has no SV bank (its artifact is "
                    "already O(rank))")
            if self.buckets:
                raise ValueError("a low-rank pack carries linear weights, "
                                 "not SV buckets; got both")
            if self.linear_w is None or self.linear_b is None:
                raise ValueError("a low-rank pack needs linear_w and "
                                 "linear_b alongside its feature_map")
            if (self.linear_w.shape[0] != self.n_tasks
                    or self.linear_b.shape != (self.n_tasks,)):
                raise ValueError(
                    f"linear weights must stack all {self.n_tasks} tasks: "
                    f"linear_w {self.linear_w.shape}, "
                    f"linear_b {self.linear_b.shape}")
            return
        ids = np.sort(np.concatenate([g.task_ids for g in self.buckets]))
        if not np.array_equal(ids, np.arange(self.n_tasks)):
            raise ValueError(
                f"buckets must cover task ids 0..{self.n_tasks - 1} "
                f"exactly once, got {ids.tolist()}")
        want = np.dtype(SV_DTYPES[self.sv_dtype])
        for g in self.buckets:
            if g.sv_x.dtype != want or g.sv_coef.dtype != want:
                raise ValueError(
                    f"an sv_dtype {self.sv_dtype!r} pack stores its banks "
                    f"as {want}, got sv_x {g.sv_x.dtype} and sv_coef "
                    f"{g.sv_coef.dtype}")

    @property
    def n_support(self) -> int:
        return int(sum(int(g.sv_counts.sum()) for g in self.buckets))

    @classmethod
    def from_numpy(cls, *, kernel: K.KernelParams | dict,
                   sv_x: np.ndarray, sv_coef: np.ndarray, b: float,
                   classes: np.ndarray) -> "PackedModel":
        """A binary SVC pack from its numpy state: the (n_sv, d) support
        vectors, their (n_sv,) coefficients alpha_i y_i, the bias and the
        two classes (``classes[1]`` on a positive margin)."""
        if isinstance(kernel, dict):
            kernel = K.KernelParams(**kernel)
        bucket = _single_task_bucket(sv_x, sv_coef, b)
        return cls(kind="svc", kernel=kernel, n_features=bucket.sv_x.shape[2],
                   n_tasks=1, buckets=(bucket,), strategy="binary",
                   classes=np.asarray(classes),
                   pairs=np.array([[1, 0]], np.int64))


def _single_task_bucket(sv_x, sv_coef, b: float) -> TaskBucket:
    """The one serving bucket of a binary SVC or an SVR pack."""
    sv_x = np.asarray(sv_x, np.float32)
    sv_coef = np.asarray(sv_coef, np.float32)
    if sv_x.ndim != 2 or sv_coef.shape != (sv_x.shape[0],):
        raise ValueError(f"need (n_sv, d) sv_x and (n_sv,) sv_coef, got "
                         f"{sv_x.shape} and {sv_coef.shape}")
    return TaskBucket(task_ids=np.array([0], np.int64), sv_x=sv_x[None],
                      sv_coef=sv_coef[None], b=np.array([b], np.float32),
                      sv_counts=np.array([sv_x.shape[0]], np.int64))


def _numpy(a) -> np.ndarray:
    """float32 numpy copy of a tensor (on any device) or an array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _pack_svr(reg) -> PackedModel:
    bucket = _single_task_bucket(reg.support_vectors_, reg.dual_coef_,
                                 reg.b_)
    return PackedModel(kind="svr", kernel=reg.kernel_params,
                       n_features=bucket.sv_x.shape[2], n_tasks=1,
                       buckets=(bucket,), strategy="svr")


def _pack_multiclass_svc(clf) -> PackedModel:
    """A multiclass SVC: its pow2 SV-width serving buckets as they are."""
    taskset = clf._taskset
    return PackedModel(
        kind="svc", kernel=clf.kernel_params,
        n_features=taskset.tasks[0].x.shape[1], n_tasks=taskset.n_tasks,
        buckets=tuple(clf._serving_buckets), strategy=taskset.strategy,
        decision=clf.decision,
        classes=np.asarray(clf.classes_),
        pairs=np.asarray(taskset.pairs, np.int64))


def _pack_lowrank(model) -> PackedModel:
    """Low-rank (Nystrom / RFF) fits: feature-map arrays + stacked
    linear weights instead of SV banks; the artifact is O(rank), whatever
    the training-set size."""
    fmap = model._feature_map
    a, b = fmap.arrays
    fm = LowRankMap(kind=fmap.kind, a=_numpy(a), b=_numpy(b))
    kind, strategy, decision, classes, pairs = "svr", "svr", "vote", None, None
    if not hasattr(model, "beta_"):
        kind, decision = "svc", model.decision
        classes = np.asarray(model.classes_)
        strategy = "binary" if model._binary else model._taskset.strategy
        pairs = (np.array([[1, 0]], np.int64) if model._binary
                 else np.asarray(model._taskset.pairs, np.int64))
    if strategy in ("ovo", "ovr"):
        w = np.asarray(model.task_w_, np.float32)
        bias = np.asarray(model.task_b_, np.float32)
    else:
        w = np.asarray(model.w_, np.float32)[None]
        bias = np.array([model.b_], np.float32)
    return PackedModel(
        kind=kind, kernel=model.kernel_params, n_features=fmap.n_features,
        n_tasks=w.shape[0], buckets=(), strategy=strategy,
        decision=decision, classes=classes, pairs=pairs, feature_map=fm,
        linear_w=w, linear_b=bias)


def quantize(model: PackedModel, sv_dtype: str) -> PackedModel:
    """Re-store an SV-bank pack's ``sv_x`` / ``sv_coef`` at ``sv_dtype``
    ("fp32" | "fp16" | "bf16"); biases, counts and routing stay as they
    are. A quantized pack is re-rounded from its stored values (widening
    gives them back exactly; keep the fp32 pack if you may need it)."""
    _check_sv_dtype(sv_dtype)
    if model.feature_map is not None:
        raise ValueError("sv_dtype quantization applies to SV banks; a "
                         "low-rank pack has no SV bank")
    if sv_dtype == model.sv_dtype:
        return model
    buckets = tuple(
        g._replace(sv_x=_store(bank_f32(g.sv_x, model.sv_dtype), sv_dtype),
                   sv_coef=_store(bank_f32(g.sv_coef, model.sv_dtype),
                                  sv_dtype))
        for g in model.buckets)
    return dataclasses.replace(model, buckets=buckets, sv_dtype=sv_dtype)


def pack(model, *, sv_dtype: str = "fp32") -> PackedModel:
    """Compact a fitted ``SVC`` (binary or multiclass) or ``SVR`` into an
    immutable PackedModel (duck-typed on the fitted attributes).
    ``sv_dtype`` ("fp32", "fp16" | "bf16") quantizes the stored SV bank
    (``quantize``); low-rank fits reject quantization."""
    if not getattr(model, "_fitted", False):
        raise ValueError("pack() needs a fitted model (call .fit first)")
    if getattr(model, "_feature_map", None) is not None:
        if sv_dtype != "fp32":
            raise ValueError("sv_dtype quantization applies to SV banks; "
                             "a low-rank fit packs no SV bank")
        return _pack_lowrank(model)
    if hasattr(model, "beta_"):
        packed = _pack_svr(model)
    elif not model._binary:
        packed = _pack_multiclass_svc(model)
    else:
        packed = PackedModel.from_numpy(kernel=model.kernel_params,
                                        sv_x=model.support_vectors_,
                                        sv_coef=model.dual_coef_, b=model.b_,
                                        classes=model.classes_)
    return quantize(packed, sv_dtype) if sv_dtype != "fp32" else packed


def save(path, model: PackedModel) -> None:
    """Write the .npz artifact (path or open file object): version 1 for
    an fp32 SV-bank pack, 2 for a low-rank one, 3 for a quantized one
    (``meta.sv_dtype``; a bf16 bank as its uint16 bits). The path is
    written verbatim (no ".npz" appended)."""
    lowrank = model.feature_map is not None
    quant = model.sv_dtype != "fp32"
    meta = {
        "schema": SCHEMA_NAME,
        "version": (SCHEMA_VERSION_QUANT if quant else SCHEMA_VERSION
                    if lowrank else SCHEMA_VERSION_CLASSIC),
        "kind": model.kind, "strategy": model.strategy,
        "decision": model.decision,
        "kernel": dataclasses.asdict(model.kernel),
        "n_features": model.n_features, "n_tasks": model.n_tasks,
        "n_buckets": len(model.buckets),
    }
    if lowrank:
        meta["feature_map"] = model.feature_map.kind
    if quant:
        meta["sv_dtype"] = model.sv_dtype
    arrays = {"meta": np.array(json.dumps(meta, sort_keys=True))}
    if model.classes is not None:
        arrays["classes"] = model.classes
    if model.pairs is not None:
        arrays["pairs"] = model.pairs
    if lowrank:
        arrays["fm_a"] = model.feature_map.a
        arrays["fm_b"] = model.feature_map.b
        arrays["linear_w"] = model.linear_w
        arrays["linear_b"] = model.linear_b
    for i, g in enumerate(model.buckets):
        for field, value in g._asdict().items():
            arrays[f"b{i}_{field}"] = value
    if hasattr(path, "write"):
        np.savez(path, **arrays)
    else:
        with open(os.fspath(path), "wb") as f:
            np.savez(f, **arrays)


def load(path) -> PackedModel:
    """Read a schema v1, v2 or v3 artifact written by either package;
    strict about the schema."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("schema") != SCHEMA_NAME:
            raise ValueError(f"not a {SCHEMA_NAME} artifact: "
                             f"schema={meta.get('schema')!r}")
        if meta.get("version") not in SCHEMA_VERSIONS:
            raise ValueError(
                f"unsupported {SCHEMA_NAME} version {meta.get('version')!r}"
                f" (this build reads versions {list(SCHEMA_VERSIONS)})")
        sv_dtype = meta.get("sv_dtype", "fp32")
        if sv_dtype not in SV_DTYPES:
            raise ValueError(f"unsupported sv_dtype {sv_dtype!r} "
                             f"(this build reads {sorted(SV_DTYPES)})")
        buckets = tuple(
            TaskBucket(**{f: z[f"b{i}_{f}"] for f in TaskBucket._fields})
            for i in range(meta["n_buckets"]))
        fm = w = lb = None
        if "feature_map" in meta:
            fm = LowRankMap(kind=meta["feature_map"],
                            a=np.asarray(z["fm_a"], np.float32),
                            b=np.asarray(z["fm_b"], np.float32))
            w = np.asarray(z["linear_w"], np.float32)
            lb = np.asarray(z["linear_b"], np.float32)
        return PackedModel(
            kind=meta["kind"], kernel=K.KernelParams(**meta["kernel"]),
            n_features=meta["n_features"], n_tasks=meta["n_tasks"],
            buckets=buckets, strategy=meta["strategy"],
            decision=meta["decision"],
            classes=z["classes"] if "classes" in z else None,
            pairs=np.asarray(z["pairs"], np.int64) if "pairs" in z
            else None, feature_map=fm, linear_w=w, linear_b=lb,
            sv_dtype=sv_dtype)
