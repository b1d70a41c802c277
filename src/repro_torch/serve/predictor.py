"""Batched serving engine: device-resident SV banks and one decide
program per (bank signature, batch bucket).

Mirrors ``repro/serve/predictor.py``:

* the packed SV bank is moved to the device once, at construction, and
  stays resident — at the pack's storage dtype: a quantized pack
  (``sv_dtype`` "fp16" | "bf16", schema v3) keeps half the bytes of an
  fp32 one on the device. With ``engine="pallas"`` the decision kernel
  reads such a bank as it is (widening it to float32 as it stages it,
  float32 accumulation), so no request copies it; the chunked config
  upcasts it per call (it is the plain path). Only ``sv_coef``, 1/d of
  the bank, is upcast once, at construction. Under bf16 compute
  (``gram_dtype="bf16"``) a bf16 bank goes as is and an fp16 one is
  rounded once to bf16 at construction (fp16 -> float32 is exact, then
  to nearest even), which is what the reference computes;
* a request is cut into slices of at most ``max_batch`` rows, and each
  slice is zero-padded up to the next power of two (capped at
  ``max_batch``), so arbitrary request sizes reuse a small warm set of
  program shapes; padded rows are sliced off before results leave;
* with ``engine="pallas"`` and an RBF kernel, a slice is one launch of
  the fused ``multitask_decision`` kernel per serving bucket — a
  multiclass bucket stacks T tasks (T, w, d) and gets its (T, B)
  decisions from that one launch; the chunked config runs
  ``KernelEngine.decide`` per task (the plain reference path);
* ``n_programs`` counts the distinct (bank signature, batch bucket)
  pairs served so far: the launch shapes a warm predictor has planned
  (each a launch plan the kernel wrappers resolve once). Nothing is
  captured or compiled for them (PyTorch runs eagerly); each new one is
  reported to an active ``analysis.compile_guard.CompileGuard``;
* a low-rank pack (``PackedModel.feature_map``) keeps the feature map
  and the linear weights resident instead of an SV bank; a slice is
  one feature transform (the ``rff_features`` kernel for an RFF map on
  the card) and a (rank, n_tasks) matmul, on the same ladder, in the
  ledger under ``("lowrank", bucket)``;
* an SVR pack decodes to its decision values (``predict`` returns
  them); a multiclass pack decodes its (n_tasks, nt) decisions by vote,
  margin or OvR argmax (``multiclass.decide_from_pairs``) on the
  host, where the decisions already are.

``decision_values`` is thread-safe: each caller owns its output, and the
served-row counter and the program ledger are guarded by a lock.

    pred = Predictor(serve.load("model.npz"), engine="pallas")
    pred.warmup((1, 256)).predict(Z)
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.analysis.compile_guard import record
from repro_torch.core import approx
from repro_torch.core import kernel_engine as KE
from repro_torch.core import multiclass as MC
from repro_torch.kernels import ops
from repro_torch.serve.artifact import PackedModel, bank_f32, bf16_bits


def serving_config(engine: str | KE.EngineConfig) -> KE.EngineConfig:
    """Resolve an engine choice into the serving-side config: serving
    needs neither the (sv, sv) training Gram nor the row cache, so every
    backend but an explicit pallas degrades to chunked; ``shard_axis``
    is stripped (the serving host has no training mesh)."""
    cfg = (engine if isinstance(engine, KE.EngineConfig)
           else KE.EngineConfig(backend=engine))
    backend = "pallas" if cfg.backend == "pallas" else "chunked"
    return dataclasses.replace(cfg, backend=backend, cache_slots=0,
                               shard_axis=None)


def _pow2_floor(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


class Predictor:
    """Serve an SVC (binary or multiclass) or SVR ``PackedModel`` on
    ``device``; see module docstring."""

    # the served-row counter and program ledger are mutated by every
    # concurrent decision_values caller (enforced by analysis rule R004)
    _GUARDED_BY = {"n_requests": "_lock", "_program_sigs": "_lock"}

    def __init__(self, model: PackedModel, *,
                 engine: str | KE.EngineConfig = "auto",
                 max_batch: int = 1024,
                 device: str | torch.device = "cuda"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.model = model
        # max_batch is a rung on the pow2 padding ladder: round DOWN so
        # the cap is on-ladder and never exceeds what the caller asked
        self.max_batch = _pow2_floor(max_batch)
        self.engine_cfg = serving_config(engine)
        # SV banks move to the device once and stay resident, at their
        # storage dtype; task_ids stay on the host (they only scatter
        # results into place)
        self._banks = tuple(
            (self._resident_bank(g.sv_x),
             torch.from_numpy(bank_f32(g.sv_coef, model.sv_dtype))
             .to(self.device),
             torch.from_numpy(np.asarray(g.b, np.float32)).to(self.device),
             np.asarray(g.task_ids))
            for g in model.buckets)
        if model.feature_map is not None:
            fm = model.feature_map
            self._fmap = approx.map_from_arrays(
                fm.kind, model.kernel, fm.a, fm.b,
                gram_dtype=self.engine_cfg.gram_dtype, device=self.device)
            self._linear = tuple(
                torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
                for a in (model.linear_w, model.linear_b))
        self.n_requests = 0  # rows served (warmup excluded)
        self._program_sigs: set = set()
        self._lock = threading.Lock()

    def _resident_bank(self, sv_x: np.ndarray) -> torch.Tensor:
        """A bank on the device at its storage dtype: float32, float16,
        or bfloat16 viewed from its uint16 bits; an fp16 bank under bf16
        compute rounded once to bf16."""
        sv_dtype = self.model.sv_dtype
        if sv_dtype == "fp16" and self.engine_cfg.gram_dtype == "bf16":
            sv_x, sv_dtype = bf16_bits(np.asarray(sv_x, np.float32)), "bf16"
        if sv_dtype == "bf16":
            bits = np.ascontiguousarray(sv_x, np.uint16).view(np.int16)
            return torch.from_numpy(bits).view(torch.bfloat16).to(self.device)
        return torch.from_numpy(np.ascontiguousarray(sv_x)).to(self.device)

    # ---------------------------------------------------------- programs
    def _decide_stack(self, sv_x, sv_coef, b, z):
        """(T, w, d) stacked bank x (B, d) batch -> (T, B) decisions. The
        kernel reads the bank at its storage dtype; the chunked path
        upcasts it for the call."""
        kp = self.model.kernel
        if self.engine_cfg.backend == "pallas" and kp.name == "rbf":
            return ops.multitask_decision(
                z, sv_x, sv_coef, b, gamma=kp.gamma, mode="rbf",
                compute_dtype=self.engine_cfg.gram_dtype)
        return torch.stack([
            KE.make_engine(sv, kp, self.engine_cfg).decide(z, cf, bb)
            for sv, cf, bb in zip(sv_x.to(torch.float32), sv_coef, b)])

    @property
    def n_programs(self) -> int:
        """Distinct (bank shape/dtype, batch bucket) signatures served."""
        with self._lock:
            return len(self._program_sigs)

    def _batch_bucket(self, t: int) -> int:
        return min(self.max_batch, 1 << (max(t, 1) - 1).bit_length())

    def warmup(self, batch_sizes=(1,)) -> "Predictor":
        """Run the decide and decode paths once per request size (this
        also builds the CUDA kernels on first use). Warmup rows do NOT
        count toward ``n_requests``."""
        d = self.model.n_features
        for t in batch_sizes:
            self.predict(np.zeros((int(t), d), np.float32))
        # subtract exactly the synthetic rows: real requests served
        # concurrently during warmup keep their counts
        with self._lock:
            self.n_requests -= sum(int(t) for t in batch_sizes)
        return self

    # ------------------------------------------------------------ serving
    def decision_values(self, xt: np.ndarray) -> np.ndarray:
        """(n_tasks, nt) stacked binary decision values."""
        xt = np.asarray(xt, np.float32)
        if xt.ndim != 2 or xt.shape[1] != self.model.n_features:
            raise ValueError(
                f"expected (n, {self.model.n_features}) request batch, "
                f"got shape {xt.shape}")
        nt = xt.shape[0]
        out = np.empty((self.model.n_tasks, nt), np.float32)
        sigs = []
        for start in range(0, nt, self.max_batch):
            stop = min(start + self.max_batch, nt)
            bucket = self._batch_bucket(stop - start)
            zp = np.zeros((bucket, xt.shape[1]), np.float32)
            zp[:stop - start] = xt[start:stop]
            z = torch.from_numpy(zp).to(self.device)
            if self.model.feature_map is not None:
                w, lb = self._linear
                df = (self._fmap.transform(z) @ w.T).T + lb[:, None]
                out[:, start:stop] = df.cpu().numpy()[:, :stop - start]
                sigs.append(("lowrank", bucket))
                continue
            for sv_x, sv_coef, b, task_ids in self._banks:
                if sv_x.shape[1] == 0:  # empty-SV bank: constant bias
                    out[task_ids, start:stop] = b.cpu().numpy()[:, None]
                    continue
                df = self._decide_stack(sv_x, sv_coef, b, z)
                out[task_ids, start:stop] = df.cpu().numpy()[:, :stop - start]
                sigs.append((tuple(sv_x.shape), str(sv_x.dtype), bucket))
        with self._lock:
            new = set(sigs) - self._program_sigs
            self._program_sigs.update(new)
            self.n_requests += nt
        for sig in sorted(new, key=str):
            record("predictor program", str(sig))
        return out

    def decode(self, df: np.ndarray, op: str = "predict") -> np.ndarray:
        """Post-process stacked decision values ``df (n_tasks, nt)``:
        op "values" (unchanged), "decision_function" (margins, sklearn
        orientation) or "predict" (labels; SVR values)."""
        m = self.model
        if op == "values":
            return df
        if op == "decision_function":
            return df[0] if m.strategy in ("binary", "svr") else df
        if op != "predict":
            raise ValueError(f"unknown decode op {op!r}; expected "
                             "'predict', 'decision_function' or 'values'")
        if m.kind == "svr":
            return df[0]
        if m.strategy == "binary":
            return m.classes[(df[0] > 0).astype(np.int64)]
        # df is on the host already, and decoding is per column
        idx = MC.decide_from_pairs(
            torch.from_numpy(np.ascontiguousarray(df, np.float32)),
            m.pairs, len(m.classes), m.strategy, m.decision)
        return m.classes[idx.numpy()]

    def decision_function(self, xt: np.ndarray) -> np.ndarray:
        """Margins in the training-side convention: (nt,) for a binary
        SVC or an SVR (positive => ``classes[1]``), (n_tasks, nt) for a
        multiclass SVC."""
        return self.decode(self.decision_values(xt), "decision_function")

    def predict(self, xt: np.ndarray) -> np.ndarray:
        """Class labels (SVR: the predicted values)."""
        return self.decode(self.decision_values(xt), "predict")
