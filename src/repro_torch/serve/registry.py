"""Multi-model registry with LRU device residency.

Mirrors ``repro/serve/registry.py``. A serving host holds many packed
models but has bounded device memory: the SV banks of every registered
model cannot all stay resident. ``ModelRegistry`` splits the two
concerns:

* **registration** is host-side and unbounded — ``register`` keeps the
  ``PackedModel`` (numpy arrays, or loaded from an artifact path) on
  the host;
* **residency** is device-side and LRU-bounded — ``get`` returns a warm
  ``serve.Predictor`` for the name, admitting it (bank upload and
  warmup) on first use and evicting the least recently used resident
  model once ``max_resident`` is reached. Eviction drops the predictor,
  and with it the only references to its device banks, its programs'
  static and pinned buffers, its CUDA graphs and their memory pool, so
  that memory returns to the allocator (``torch.cuda.memory_allocated``
  falls by at least the bank's bytes); the host arrays stay registered,
  so re-admission is a
  re-upload and re-warm (and, on the card, new captures), not a reload
  from disk, and serves the same bits (same pack, same kernels).

All public methods are thread-safe (one registry lock); admission work
(upload and warmup) happens under the lock, so concurrent ``get`` calls
for the same cold model admit it exactly once.

    reg = ModelRegistry(max_resident=2, engine="pallas")
    reg.register("fraud-v3", serve.pack(clf))
    reg.register("churn-v1", "/models/churn-v1.npz")   # path form
    reg.get("fraud-v3").predict(Z)                     # admits + serves
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core import kernel_engine as KE
from repro_torch.serve import artifact
from repro_torch.serve.artifact import PackedModel
from repro_torch.serve.predictor import Predictor


class ModelRegistry:
    """Named packed models with LRU-bounded residency on ``device``."""

    # everything mutable is coordinated by the one registry lock
    # (enforced by analysis rule R004); readers go through the locked
    # accessors / the `stats` snapshot property
    _GUARDED_BY = {"_models": "_lock", "_resident": "_lock",
                   "_stats": "_lock"}

    def __init__(self, *, max_resident: int = 4,
                 engine: Union[str, KE.EngineConfig] = "auto",
                 max_batch: int = 1024,
                 warmup_sizes: tuple = (1,),
                 device: str | torch.device = "cuda"):
        if max_resident < 1:
            raise ValueError(
                f"max_resident must be >= 1, got {max_resident}")
        self.device = resolve_device(device)
        self.max_resident = int(max_resident)
        self.engine = engine
        self.max_batch = int(max_batch)
        self.warmup_sizes = tuple(warmup_sizes)
        self._models: dict[str, PackedModel] = {}          # host-side
        self._resident: OrderedDict[str, Predictor] = OrderedDict()
        self._lock = threading.RLock()
        self._stats = {"hits": 0, "admissions": 0, "evictions": 0}

    # ------------------------------------------------------- registration
    def register(self, name: str, model, *, replace: bool = False) -> None:
        """Register a ``PackedModel`` (or an artifact path to ``load``)
        under ``name``. Host-side only: nothing touches the device until
        the first ``get``. ``replace=True`` swaps an existing entry and
        evicts its resident predictor (the next ``get`` serves the new
        pack)."""
        if not isinstance(model, PackedModel):
            model = artifact.load(model)
        with self._lock:
            if name in self._models and not replace:
                raise ValueError(f"model {name!r} already registered "
                                 "(pass replace=True to swap it)")
            self._models[name] = model
            self._drop_resident(name)

    def unregister(self, name: str) -> None:
        """Forget ``name`` entirely (host arrays and any residency)."""
        with self._lock:
            self._require(name)
            del self._models[name]
            self._drop_resident(name)

    # ---------------------------------------------------------- residency
    def get(self, name: str) -> Predictor:
        """The warm predictor for ``name`` — admitting it (upload and
        warmup, evicting the LRU resident if full) or refreshing its
        recency."""
        with self._lock:
            self._require(name)
            pred = self._resident.get(name)
            if pred is not None:
                self._resident.move_to_end(name)
                self._stats["hits"] += 1
                return pred
            while len(self._resident) >= self.max_resident:
                self._resident.popitem(last=False)   # least recently used
                self._stats["evictions"] += 1
            pred = Predictor(self._models[name], engine=self.engine,
                             max_batch=self.max_batch, device=self.device)
            if self.warmup_sizes:
                pred.warmup(self.warmup_sizes)
            self._resident[name] = pred
            self._stats["admissions"] += 1
            return pred

    def evict(self, name: str) -> bool:
        """Drop ``name``'s device residency (the host arrays stay
        registered). Returns whether it was resident."""
        with self._lock:
            self._require(name)
            return self._drop_resident(name)

    def model(self, name: str) -> PackedModel:
        """The registered host-side pack (no residency side effects)."""
        with self._lock:
            self._require(name)
            return self._models[name]

    # --------------------------------------------------------- inspection
    @property
    def stats(self) -> dict:
        """A snapshot of the hit / admission / eviction counters, taken
        under the lock (a copy: `get` mutates them on other threads)."""
        with self._lock:
            return dict(self._stats)

    @property
    def names(self) -> tuple:
        with self._lock:
            return tuple(self._models)

    @property
    def resident(self) -> tuple:
        """Resident names, least to most recently used."""
        with self._lock:
            return tuple(self._resident)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._models

    def __len__(self) -> int:
        with self._lock:
            return len(self._models)

    # ----------------------------------------------------------- internal
    def _require(self, name: str) -> None:  # repro: holds[_lock]
        if name not in self._models:
            raise KeyError(f"model {name!r} is not registered "
                           f"(registered: {sorted(self._models)})")

    def _drop_resident(self, name: str) -> bool:  # repro: holds[_lock]
        return self._resident.pop(name, None) is not None
