"""Packed model artifacts — the immutable, serving-side form of a fit.

Mirrors the fp32 parts of ``repro/serve/artifact.py``. A
``PackedModel`` holds either

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
(``repro.svm-pack``) byte for byte: SV-bank packs write version 1,
low-rank packs version 2 (meta ``feature_map``, arrays ``fm_a`` /
``fm_b`` / ``linear_w`` / ``linear_b``), so an artifact written by
either package loads in the other.

Not ported yet, and raising NotImplementedError until its slice:
quantized banks (schema v3, ROADMAP A.10).
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
SCHEMA_VERSIONS = (1, 2)            # what this port's load() accepts
_LATER = {3: "quantized SV banks (ROADMAP A.10)"}


class TaskBucket(NamedTuple):
    """One serving bucket: tasks stacked at a common (padded) SV width;
    padding rows carry ``sv_coef == 0``."""

    task_ids: np.ndarray   # (T,)   int64 global task index per stacked row
    sv_x: np.ndarray       # (T, w, d) float32 support vectors, zero-padded
    sv_coef: np.ndarray    # (T, w) float32 alpha_i * y_i
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

    def __post_init__(self):
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


def pack(model) -> PackedModel:
    """Compact a fitted ``SVC`` (binary or multiclass) or ``SVR`` into an
    immutable PackedModel (duck-typed on the fitted attributes)."""
    if not getattr(model, "_fitted", False):
        raise ValueError("pack() needs a fitted model (call .fit first)")
    if getattr(model, "_feature_map", None) is not None:
        return _pack_lowrank(model)
    if hasattr(model, "beta_"):
        return _pack_svr(model)
    if not model._binary:
        return _pack_multiclass_svc(model)
    return PackedModel.from_numpy(kernel=model.kernel_params,
                                  sv_x=model.support_vectors_,
                                  sv_coef=model.dual_coef_, b=model.b_,
                                  classes=model.classes_)


def save(path, model: PackedModel) -> None:
    """Write the .npz artifact (path or open file object): version 1 for
    an SV-bank pack, 2 for a low-rank one. The path is written verbatim
    (no ".npz" appended)."""
    lowrank = model.feature_map is not None
    meta = {
        "schema": SCHEMA_NAME,
        "version": SCHEMA_VERSION if lowrank else SCHEMA_VERSION_CLASSIC,
        "kind": model.kind, "strategy": model.strategy,
        "decision": model.decision,
        "kernel": dataclasses.asdict(model.kernel),
        "n_features": model.n_features, "n_tasks": model.n_tasks,
        "n_buckets": len(model.buckets),
    }
    if lowrank:
        meta["feature_map"] = model.feature_map.kind
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
    """Read a schema-v1 or v2 artifact written by either package; strict
    about the schema."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("schema") != SCHEMA_NAME:
            raise ValueError(f"not a {SCHEMA_NAME} artifact: "
                             f"schema={meta.get('schema')!r}")
        version = meta.get("version")
        if version in _LATER:
            raise NotImplementedError(
                f"{SCHEMA_NAME} version {version} is not ported yet; it "
                f"comes with {_LATER[version]}")
        if version not in SCHEMA_VERSIONS:
            raise ValueError(f"unsupported {SCHEMA_NAME} version "
                             f"{version!r} (this build reads versions "
                             f"{list(SCHEMA_VERSIONS)})")
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
            else None, feature_map=fm, linear_w=w, linear_b=lb)
