"""Packed model artifacts — the immutable, serving-side form of a fit.

Mirrors the binary SV-bank part of ``repro/serve/artifact.py``: a
``PackedModel`` holds one serving bucket (the stacked, zero-padded SV
bank ``sv_x`` / ``sv_coef`` / ``b``), the kernel parameters, the class
table and the vote-routing ``pairs``, all as numpy arrays — the whole
fitted state of an SVM. ``save`` / ``load`` read and write schema
version 1 of the reference's versioned ``.npz`` format
(``repro.svm-pack``), byte for byte the layout the reference writes, so
an artifact written by either package loads in the other. The v1
loader needs no bfloat16 support.

Not ported yet, and raising NotImplementedError until their slice:
multiclass packs (ROADMAP A.6), SVR packs (next slice), low-rank packs
(schema v2, A.8) and quantized banks (schema v3, A.10).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core import kernels as K

SCHEMA_NAME = "repro.svm-pack"
SCHEMA_VERSION_CLASSIC = 1          # fp32 SV-bank packs
SCHEMA_VERSIONS = (1,)              # what this port's load() accepts
_LATER = {2: "low-rank packs (ROADMAP A.8)",
          3: "quantized SV banks (ROADMAP A.10)"}


class TaskBucket(NamedTuple):
    """One serving bucket: tasks stacked at a common (padded) SV width;
    padding rows carry ``sv_coef == 0``."""

    task_ids: np.ndarray   # (T,)   int64 global task index per stacked row
    sv_x: np.ndarray       # (T, w, d) float32 support vectors, zero-padded
    sv_coef: np.ndarray    # (T, w) float32 alpha_i * y_i
    b: np.ndarray          # (T,)   float32 biases
    sv_counts: np.ndarray  # (T,)   int64 real SV count per stacked task


@dataclasses.dataclass(frozen=True)
class PackedModel:
    """Immutable serving artifact of a binary SVC (see module docstring).

    pairs: (n_tasks, 2) class-index credit table; binary packs as
    [[1, 0]] (a positive decision credits ``classes[1]``).
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

    def __post_init__(self):
        if self.kind != "svc" or self.strategy != "binary":
            raise NotImplementedError(
                f"{self.kind}/{self.strategy} packs are not ported yet: "
                "multiclass comes with ROADMAP A.6, SVR with the next "
                "slice; this slice serves binary SVC")
        if self.n_tasks != 1 or len(self.buckets) != 1:
            raise ValueError("a binary pack has exactly one task in one "
                             "bucket")
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
        sv_x = np.asarray(sv_x, np.float32)
        sv_coef = np.asarray(sv_coef, np.float32)
        if sv_x.ndim != 2 or sv_coef.shape != (sv_x.shape[0],):
            raise ValueError(f"need (n_sv, d) sv_x and (n_sv,) sv_coef, got "
                             f"{sv_x.shape} and {sv_coef.shape}")
        bucket = TaskBucket(task_ids=np.array([0], np.int64),
                            sv_x=sv_x[None], sv_coef=sv_coef[None],
                            b=np.array([b], np.float32),
                            sv_counts=np.array([sv_x.shape[0]], np.int64))
        return cls(kind="svc", kernel=kernel, n_features=sv_x.shape[1],
                   n_tasks=1, buckets=(bucket,), strategy="binary",
                   classes=np.asarray(classes),
                   pairs=np.array([[1, 0]], np.int64))


def pack(model) -> PackedModel:
    """Compact a fitted binary ``SVC`` into an immutable PackedModel."""
    if not getattr(model, "_fitted", False):
        raise ValueError("pack() needs a fitted model (call .fit first)")
    return PackedModel.from_numpy(kernel=model.kernel_params,
                                  sv_x=model.support_vectors_,
                                  sv_coef=model.dual_coef_, b=model.b_,
                                  classes=model.classes_)


def save(path, model: PackedModel) -> None:
    """Write the schema-v1 .npz artifact (path or open file object). The
    path is written verbatim (no ".npz" appended)."""
    meta = {
        "schema": SCHEMA_NAME,
        "version": SCHEMA_VERSION_CLASSIC,
        "kind": model.kind, "strategy": model.strategy,
        "decision": model.decision,
        "kernel": dataclasses.asdict(model.kernel),
        "n_features": model.n_features, "n_tasks": model.n_tasks,
        "n_buckets": len(model.buckets),
    }
    arrays = {"meta": np.array(json.dumps(meta, sort_keys=True))}
    if model.classes is not None:
        arrays["classes"] = model.classes
    if model.pairs is not None:
        arrays["pairs"] = model.pairs
    for i, g in enumerate(model.buckets):
        for field, value in g._asdict().items():
            arrays[f"b{i}_{field}"] = value
    if hasattr(path, "write"):
        np.savez(path, **arrays)
    else:
        with open(os.fspath(path), "wb") as f:
            np.savez(f, **arrays)


def load(path) -> PackedModel:
    """Read a schema-v1 artifact written by either package; strict about
    the schema."""
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
        return PackedModel(
            kind=meta["kind"], kernel=K.KernelParams(**meta["kernel"]),
            n_features=meta["n_features"], n_tasks=meta["n_tasks"],
            buckets=buckets, strategy=meta["strategy"],
            decision=meta["decision"],
            classes=z["classes"] if "classes" in z else None,
            pairs=np.asarray(z["pairs"], np.int64) if "pairs" in z
            else None)
