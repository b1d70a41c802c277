"""Async serving service: a request queue and a dynamic-batching window.

Mirrors ``repro/serve/service.py``. ``serve.Predictor`` serves a batch
in one decision launch per bank; this module keeps that true under
open-loop traffic, where requests arrive on their own clock and mostly
one row at a time. Dispatching each arrival alone pays a launch and the
host's per-call work for one row, so the service batches the queue:

* ``submit`` enqueues a request (any row count) and returns a
  ``concurrent.futures.Future`` at once — callers never block the
  batcher;
* one worker thread collects arrivals for at most ``window_ms``
  (measured from the FIRST request of the window) or until some model's
  collected rows reach its predictor's ``max_batch``, whichever comes
  first, then flushes: per model, one ``decision_values`` over the
  concatenated rows, one decode per op, and each request's slice set on
  its future;
* requests for different models share a window (the registry keeps
  their banks resident); an idle service burns no CPU (the worker
  blocks on the queue).

``window_ms=0`` disables the *wait* but not the batching: whatever is
already queued when the worker wakes is still served in one call (the
greedy backlog). The decision kernel folds each row's sum in an order
fixed by the bank, so a request's values are the bits its rows get when
served alone, whatever they were batched with.

    svc = ServingService(serve.pack(clf), window_ms=2.0, engine="pallas")
    fut = svc.submit(z_row, op="predict")     # non-blocking
    fut.result()                              # one label
    svc.predict(Z)                            # blocking convenience
    svc.close()                               # flushes, then stops

Multi-model form: pass a ``ModelRegistry`` (or a ``{name: PackedModel}``
dict) and route with ``submit(x, model="name")``; an existing
``Predictor`` is served as the one model ``"default"``. ``stats``
reports the request / batch / row counters. The worker launches the
kernels on the service's device; build the kernels and warm the
predictors (``Predictor.warmup``, ``ModelRegistry(warmup_sizes=...)``)
before traffic arrives.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.serve.artifact import PackedModel
from repro_torch.serve.predictor import Predictor, _pow2_floor
from repro_torch.serve.registry import ModelRegistry

_OPS = ("predict", "decision_function", "values")
_SENTINEL = object()


class _Request(NamedTuple):
    model: str
    op: str
    x: np.ndarray          # (n, d) float32
    future: Future


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class ServingService:
    """Dynamic-batching front end over one or many packed models on
    ``device``."""

    # shared mutable state and its lock (enforced by analysis rule R004):
    # the worker thread mutates _stats; _closed coordinates submit/close
    _GUARDED_BY = {"_stats": "_stats_lock", "_closed": "_stats_lock"}

    def __init__(self, models, *, window_ms: float = 2.0,
                 engine="auto", max_batch: int = 1024,
                 max_resident: int = 4, warmup_sizes: tuple = (1,),
                 device: str | torch.device = "cuda"):
        if window_ms < 0:
            raise ValueError(f"window_ms must be >= 0, got {window_ms}")
        self.device = resolve_device(device)
        self.window_s = float(window_ms) * 1e-3
        self._direct: dict[str, Predictor] = {}
        self.registry: Optional[ModelRegistry] = None
        if isinstance(models, Predictor):
            # serve an existing predictor as the single "default" model
            self._direct["default"] = models
            given = models.device
        elif isinstance(models, ModelRegistry):
            self.registry = models
            given = models.device
        else:
            self.registry = ModelRegistry(
                max_resident=max_resident, engine=engine,
                max_batch=max_batch, warmup_sizes=warmup_sizes,
                device=self.device)
            named = (models if isinstance(models, dict)
                     else {"default": models})
            for name, m in named.items():
                self.registry.register(name, m)
            given = self.device
        if not _same_device(given, self.device):
            raise ValueError(f"the models run on {given}, the service was "
                             f"asked for {self.device}")
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._stats_lock = threading.Lock()
        self._stats = {"n_requests": 0, "n_rows": 0, "n_batches": 0,
                       "n_window_flushes": 0, "n_full_flushes": 0,
                       "max_batch_rows": 0}
        self._worker = threading.Thread(target=self._run,
                                        name="repro-torch-serving-batcher",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- submit
    def _packed(self, name: str) -> PackedModel:
        if name in self._direct:
            return self._direct[name].model
        if self.registry is None or name not in self.registry:
            known = sorted(self._direct) + (
                sorted(self.registry.names) if self.registry else [])
            raise KeyError(f"unknown model {name!r} (known: {known})")
        return self.registry.model(name)

    def submit(self, x, *, model: str = "default",
               op: str = "predict") -> Future:
        """Enqueue a request; returns a Future resolving to the decoded
        output for exactly the submitted rows. A 1-D ``x`` is one row
        (and resolves to a length-1 result)."""
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}; expected one of {_OPS}")
        with self._stats_lock:
            if self._closed:
                raise RuntimeError("service is closed")
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        d = self._packed(model).n_features
        if x.ndim != 2 or x.shape[1] != d or x.shape[0] == 0:
            raise ValueError(f"expected a non-empty (n, {d}) request "
                             f"for model {model!r}, got shape {x.shape}")
        fut: Future = Future()
        self._q.put(_Request(model, op, x, fut))
        return fut

    # ------------------------------------------------- blocking shortcuts
    def predict(self, x, *, model: str = "default"):
        return self.submit(x, model=model, op="predict").result()

    def decision_function(self, x, *, model: str = "default"):
        return self.submit(x, model=model,
                           op="decision_function").result()

    # -------------------------------------------------------------- stats
    @property
    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
        s["rows_per_batch"] = (s["n_rows"] / s["n_batches"]
                               if s["n_batches"] else 0.0)
        return s

    # ------------------------------------------------------------ teardown
    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting requests, flush everything queued, join the
        worker. Idempotent."""
        with self._stats_lock:
            first = not self._closed
            self._closed = True
        if first:
            # exactly one closer enqueues the sentinel
            self._q.put(_SENTINEL)
        self._worker.join(timeout)
        # a submit that raced close() may have queued behind the
        # sentinel: fail those futures rather than hang their callers
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not _SENTINEL:
                req.future.set_exception(
                    RuntimeError("service closed before dispatch"))

    def __enter__(self) -> "ServingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- batcher
    def _predictor(self, name: str) -> Predictor:
        if name in self._direct:
            return self._direct[name]
        return self.registry.get(name)

    def _cap(self, name: str) -> int:
        """Rows at which a model's window is full (its predictor's
        max_batch: beyond that the predictor slices anyway)."""
        if name in self._direct:
            return self._direct[name].max_batch
        # host-side cap (no admission just to read it); the predictor
        # rounds its max_batch to the same pow2 rung
        return _pow2_floor(self.registry.max_batch)

    def _run(self) -> None:
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)   # this thread's launches
        while True:
            req = self._q.get()
            if req is _SENTINEL:
                return
            pending = [req]
            rows = {req.model: req.x.shape[0]}
            deadline = time.perf_counter() + self.window_s
            full = req.x.shape[0] >= self._cap(req.model)
            while not full:
                try:
                    # drain the backlog greedily first (all the batching
                    # window_ms=0 gets), then wait out the window
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                if nxt is _SENTINEL:
                    self._flush(pending)
                    return
                pending.append(nxt)
                rows[nxt.model] = rows.get(nxt.model, 0) + nxt.x.shape[0]
                full = rows[nxt.model] >= self._cap(nxt.model)
            with self._stats_lock:
                self._stats["n_full_flushes" if full
                            else "n_window_flushes"] += 1
            self._flush(pending)

    def _flush(self, pending: list) -> None:
        """One ``decision_values`` and one decode per op for each model
        present, then each request's slice set on its future."""
        by_model: dict[str, list] = {}
        for r in pending:
            by_model.setdefault(r.model, []).append(r)
        for name, reqs in by_model.items():
            try:
                pred = self._predictor(name)
                xcat = (reqs[0].x if len(reqs) == 1
                        else np.concatenate([r.x for r in reqs], axis=0))
                df = pred.decision_values(xcat)
                # decode once per op over the merged batch (every op is
                # columnwise), then slice per request
                decoded = {op: pred.decode(df, op)
                           for op in {r.op for r in reqs}}
            except Exception as e:                 # noqa: BLE001
                # the boundary of the worker: the error goes to every
                # caller of the batch, and the worker serves on
                for r in reqs:
                    if not r.future.cancelled():
                        r.future.set_exception(e)
                continue
            with self._stats_lock:
                self._stats["n_requests"] += len(reqs)
                self._stats["n_rows"] += xcat.shape[0]
                self._stats["n_batches"] += 1
                self._stats["max_batch_rows"] = max(
                    self._stats["max_batch_rows"], xcat.shape[0])
            start = 0
            for r in reqs:
                stop = start + r.x.shape[0]
                out = decoded[r.op]
                sl = out[..., start:stop] if out.ndim > 1 else out[start:stop]
                start = stop
                if not r.future.cancelled():
                    r.future.set_result(sl)
