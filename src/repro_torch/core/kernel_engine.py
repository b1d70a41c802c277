"""KernelEngine — every Gram evaluation of the port, one interface.

Mirrors ``repro/core/kernel_engine.py``; one ``EngineConfig`` means the
same thing in both packages. An engine lives on the device of the
training matrix it is given::

    engine.full()            # (n, n) Gram
    engine.diag()            # (n,)  K(x_i, x_i)
    engine.row(i, cache)     # ((n,), cache) one kernel row, LRU-cached
    engine.block(rows, cols) # (r, c) arbitrary sub-block
    engine.matvec(v)         # (n,)  K @ v (pallas: one launch, no K)
    engine.cross(z)          # (t, n) K(z, X) test-vs-train block
    engine.decide(z, coef,b) # (t,)  K(z, X) @ coef + b
    engine.init_cache()      # LRU row-cache state (None if unused)

``TaskKernelEngine`` is the same interface over a multiclass bucket of
T tasks stacked as (T, w, d): ``row`` takes one index per task and
returns the (T, w) rows, and ``matvec`` the (T, w) products — each one
launch of the task-axis ``rbf_gram`` row or matvec kernel under
``pallas`` — while ``diag`` works per task.

Backends: ``dense`` (precomputed (n, n) Gram), ``chunked`` (rows on the
fly, O(n d) memory, LRU row cache), ``pallas`` (the chunked layout with
the RBF / linear Gram, its rows and the decision values on the port's
hand-written CUDA kernels; the name is the reference's, kept so that a
config means the same in both packages), ``auto`` (dense up to
``dense_limit`` samples, chunked above), the low-rank ``nystrom`` /
``rff`` (``approx.LowRankKernelEngine``, K ~ Phi Phi^T over an explicit
feature map; the RFF map runs on the ``rff_features`` kernel) and
``sharded`` (``ShardedKernelEngine``: one rank's row block of the
data-parallel SMO over a ``launch.mesh.Mesh``, on the ``pallas``
kernels' row-range entries; ``make_engine(..., mesh=)``). The
plain backends compute with PyTorch ops in full float32 (TF32 stays
off, the default of ``torch.backends.cuda.matmul.allow_tf32``).

Row indices are 0-d int64 tensors on the engine's device, and the row
cache decides hit or miss on the device, so the SMO loop never waits
for the host to learn either (under ``pallas`` the lookup, the row and
the cache's update are one launch of the cached row kernel). The cache
is updated in place (the reference threads a functional copy through
its loop); hit and miss counts follow the reference exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import kernels as K
from repro_torch.kernels import ops
from repro_torch.kernels.rbf_gram import ROW_CHUNK, lru_row_plain, staged


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine selection/config (same fields and defaults as the
    reference).

    backend:     auto | dense | chunked | pallas | nystrom | rff |
                 sharded (one rank of ``smo.sharded_solve_qp``; needs
                 ``shard_axis`` and a mesh).
    cache_slots: LRU row-cache capacity (chunked/pallas row mode).
    chunk:       row-block size for matvec()/decide() streaming.
    dense_limit: 'auto' picks dense up to this n, chunked above; also the
                 guard above which chunked/pallas full() refuse.
    shard_axis:  the sharded backend's mesh axis.
    gram_dtype:  "fp32" (exact, default) or "bf16" (bf16 operands with
                 f32 accumulation and f32 epilogue).
    rank / landmarks / seed: low-rank backends only (nystrom | rff;
                 ``repro_torch.core.approx``).
    """

    backend: str = "auto"
    cache_slots: int = 32
    chunk: int = 2048
    dense_limit: int = 8192
    shard_axis: Optional[str] = None
    gram_dtype: str = "fp32"
    rank: int = 256
    landmarks: str = "uniform"
    seed: int = 0


@dataclasses.dataclass
class RowCache:
    """LRU row-cache state, all on the engine's device, updated in place."""

    keys: torch.Tensor    # (slots,) int64 row index per slot, -1 = empty
    stamp: torch.Tensor   # (slots,) int64 last-use tick (min = LRU victim)
    rows: torch.Tensor    # (slots, n) float32 cached kernel rows
    clock: torch.Tensor   # () int64 monotone tick
    hits: torch.Tensor    # () int64 lookup statistics
    misses: torch.Tensor  # () int64
    # every field is updated in place (rbf_gram.lru_row_plain or the
    # cached row kernel), so one RowCache stays valid for a whole solve


def take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-d index tensor, gathered on the device (plain
    indexing with a 0-d tensor may read it on the host)."""
    return t.index_select(0, i.reshape(1))[0]


class KernelEngine:
    """Base: owns x + kernel params; subclasses define the Gram strategy."""

    backend = "base"

    def __init__(self, x: torch.Tensor, kernel: K.KernelParams,
                 cfg: EngineConfig = EngineConfig()):
        self.x = x.to(torch.float32).contiguous()
        self.n = self.x.shape[0]
        self.device = self.x.device
        self.kernel = kernel
        self.cfg = cfg
        self._gram_fn = K.make_gram_fn(kernel, compute_dtype=cfg.gram_dtype)

    # -------------------------------------------------------- interface
    def full(self) -> torch.Tensor:
        raise NotImplementedError

    def diag(self) -> torch.Tensor:
        if self.kernel.name == "rbf":  # K(x, x) = exp(0) exactly
            return torch.ones((self.n,), dtype=torch.float32,
                              device=self.device)
        return torch.cat([torch.diagonal(self._gram_fn(xb, xb))
                          for xb in self._row_blocks()])

    def row(self, i: torch.Tensor, cache=None):
        raise NotImplementedError

    def block(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        return self._gram_fn(self.x[rows], self.x[cols])

    def cross(self, z: torch.Tensor) -> torch.Tensor:
        return self._gram_fn(z.to(torch.float32), self.x)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decide(self, z: torch.Tensor, coef: torch.Tensor,
               b: torch.Tensor | float = 0.0) -> torch.Tensor:
        """K(z, X) @ coef + b, streamed over test-row chunks."""
        z = z.to(torch.float32)
        chunk = min(self.cfg.chunk, max(z.shape[0], 1))
        out = [self.cross(zb) @ coef for zb in torch.split(z, chunk)]
        if not out:
            return torch.zeros((0,), dtype=torch.float32,
                               device=self.device) + b
        return torch.cat(out) + b

    def init_cache(self) -> Optional[RowCache]:
        return None

    def _row_blocks(self):
        return torch.split(self.x, min(self.cfg.chunk, max(self.n, 1)))


class DenseKernelEngine(KernelEngine):
    """Precomputed (n, n) Gram — the n <= ~8k fast path."""

    backend = "dense"

    def __init__(self, x, kernel, cfg: EngineConfig = EngineConfig(), *,
                 gram: Optional[torch.Tensor] = None):
        super().__init__(x, kernel, cfg)
        self.gram = (self._gram_fn(self.x, self.x) if gram is None
                     else gram.to(device=self.device, dtype=torch.float32))

    def full(self):
        return self.gram

    def diag(self):
        return torch.diagonal(self.gram)

    def row(self, i, cache=None):
        return take(self.gram, i), cache

    def block(self, rows, cols):
        return self.gram[rows][:, cols]

    def matvec(self, v):
        return self.gram @ v


class ChunkedKernelEngine(KernelEngine):
    """On-the-fly rows + LRU row cache; O(n d) resident memory."""

    backend = "chunked"

    def _compute_row(self, i: torch.Tensor) -> torch.Tensor:
        return self._gram_fn(self.x, take(self.x, i)[None, :])[:, 0]

    def init_cache(self) -> Optional[RowCache]:
        slots = self.cfg.cache_slots
        if slots <= 0:
            return None
        dev = self.device

        def zero():
            return torch.zeros((), dtype=torch.int64, device=dev)

        return RowCache(
            keys=torch.full((slots,), -1, dtype=torch.int64, device=dev),
            stamp=torch.zeros((slots,), dtype=torch.int64, device=dev),
            rows=torch.zeros((slots, self.n), dtype=torch.float32,
                             device=dev),
            clock=zero(), hits=zero(), misses=zero())

    def row(self, i, cache: Optional[RowCache] = None):
        if cache is None:
            return self._compute_row(i), None
        return self._cached_row(i, cache), cache

    def _cached_row(self, i, cache: RowCache) -> torch.Tensor:
        """Row i through the LRU cache, updated in place (the lookup the
        plain path runs; the pallas engine does it in one launch)."""
        return lru_row_plain(cache.keys, cache.stamp, cache.rows,
                             cache.clock, cache.hits, cache.misses, i,
                             self._compute_row)

    def matvec(self, v):
        return torch.cat([self._gram_fn(xb, self.x) @ v
                          for xb in self._row_blocks()])

    def _refuse_full(self):
        if self.n > self.cfg.dense_limit:
            raise RuntimeError(
                f"{type(self).__name__}.full(): refusing to materialize a "
                f"({self.n}, {self.n}) Gram (dense_limit="
                f"{self.cfg.dense_limit}); use row()/block()/matvec()")

    def full(self):
        self._refuse_full()
        return torch.cat([self._gram_fn(xb, self.x)
                          for xb in self._row_blocks()])


class PallasKernelEngine(ChunkedKernelEngine):
    """The chunked layout with the Gram hot spots on the CUDA kernels.

    RBF and linear rows, blocks and matvecs go through
    ``ops.gram_row`` / ``ops.rbf_gram`` / ``ops.gram_matvec`` (one
    launch a matvec, K never written), and RBF decisions through
    ``ops.decision``; on a CUDA tensor each launches its kernel or
    raises. Other kernels take the plain path, as the reference's
    pallas backend falls back to jnp for them. The training matrix is
    kept at the compute precision, with its squared norms, and on the
    card once more with its rows zero-padded to the Gram block route's
    staged stride, so that a tile of rows is one copy
    (``rbf_gram.staged``; on the CPU the same tensor).
    """

    backend = "pallas"

    def __init__(self, x, kernel, cfg: EngineConfig = EngineConfig()):
        super().__init__(x, kernel, cfg)
        self._mode = kernel.name if kernel.name in ("rbf", "linear") else None
        self._xk = self.x.to(ops.tile_dtype(cfg.gram_dtype)).contiguous()
        self._x2 = K.sqnorms(self._xk)
        self._xs = staged(self._xk)

    def _gram(self, a, b, a2=None, b2=None):
        return ops.rbf_gram(a, b, gamma=self.kernel.gamma, mode=self._mode,
                            compute_dtype=self.cfg.gram_dtype, a2=a2, b2=b2)

    def _compute_row(self, i):
        if self._mode is None:
            return super()._compute_row(i)
        return ops.gram_row(self._xk, self._x2, i, gamma=self.kernel.gamma,
                            mode=self._mode)

    def _cached_row(self, i, cache):
        if self._mode is None:
            return super()._cached_row(i, cache)
        return ops.gram_row_cached(
            self._xk, self._x2, i, cache.keys, cache.stamp, cache.rows,
            cache.clock, cache.hits, cache.misses, gamma=self.kernel.gamma,
            mode=self._mode)

    def cross(self, z):
        if self._mode is None:
            return super().cross(z)
        return self._gram(z, self._xs, b2=self._x2)

    def block(self, rows, cols):
        if self._mode is None:
            return super().block(rows, cols)
        return self._gram(self._xk[rows], self._xk[cols], self._x2[rows],
                          self._x2[cols])

    def matvec(self, v):
        if self._mode is None:
            return super().matvec(v)
        return ops.gram_matvec(self._xs, self._x2, v.contiguous(),
                               gamma=self.kernel.gamma, mode=self._mode,
                               chunk=self.cfg.chunk)

    def decide(self, z, coef, b=0.0):
        if self.kernel.name == "rbf":
            return ops.decision(z, self.x, coef, b, gamma=self.kernel.gamma,
                                compute_dtype=self.cfg.gram_dtype)
        return super().decide(z, coef, b)

    def full(self):
        self._refuse_full()
        if self._mode is None:
            return super().full()
        return self._gram(self._xs, self._xs, self._x2, self._x2)


class ShardedKernelEngine(ChunkedKernelEngine):
    """One rank's engine of the data-parallel SMO
    (``smo.sharded_solve_qp``), after the reference's
    ``ShardedKernelEngine``; every rank of the mesh builds one.

    ``x`` is the FULL (n, d) sample matrix: every rank holds it (O(n d),
    as the reference all-gathers it once; the (n, n) Gram exists nowhere).
    The sample axis, zero-padded, is split into P (the mesh axis's size)
    contiguous blocks of ``n_local`` rows, ``n / P`` rounded up to whole
    32-row chunks of the row kernel (so every chunk's copy is one
    16-byte-aligned TMA copy; one rank takes the n rows as they are),
    and this rank owns rows
    ``[row0, row0 + n_local)``; its methods return the
    LOCAL slice of the global quantity (zero on the padding):

      row(i)     -> (n_local,) K(x_local, x_i) for a GLOBAL i, through a
                    per-rank LRU cache keyed by the global index
      matvec(v)  -> (n_local,) this rank's rows of K @ v, from the LOCAL
                    part of v (one all_reduce builds the whole v)
      diag()     -> (n_local,) K(x_r, x_r) of the local rows
      cross(z)   -> (t, n_local) K(z, x_local)
      decide(..) -> (t,) the global decision (local partial + all_reduce)

    ``full()`` is refused: there is no global Gram in this layout. RBF
    and linear rows and matvecs run on the ``rbf_gram`` kernels'
    row-range entries, RBF decisions on ``decision``; on a CUDA tensor
    each launches its kernel or raises, on the CPU it runs the plain
    version. A local row's bits are those of the same row of the whole
    call, so a sharded solve follows ``engine="pallas"``'s trajectory bit
    for bit. Other kernels (poly, sigmoid) take the plain Gram function,
    as the pallas engine computes them (the reference computes them
    outside any kernel too), and a local row or matvec block is the slice
    of the whole call's rows: the plain product's bits depend on its row
    count, so a row of K(x_local, x_i) alone could round apart from the
    unsharded one. Each rank then computes a whole row (O(n d)) and the
    matvec's row blocks that meet its range; such a solve too follows
    ``engine="pallas"``'s trajectory bit for bit. ``cross`` and
    ``block`` compute only what they are asked for.
    """

    backend = "sharded"

    def __init__(self, x, kernel, cfg: EngineConfig = EngineConfig(), *,
                 mesh=None):
        if not cfg.shard_axis:
            raise ValueError(
                "ShardedKernelEngine needs EngineConfig.shard_axis (the "
                "mesh axis the sample dimension is sharded over)")
        if mesh is None:
            raise ValueError(
                "ShardedKernelEngine runs on a mesh: pass mesh= (a "
                "launch.mesh.make_shard_mesh) from every rank")
        if cfg.shard_axis not in mesh.shape:
            raise ValueError(
                f"shard_axis {cfg.shard_axis!r} is not an axis of the mesh "
                f"(mesh axes: {tuple(mesh.shape)})")
        super().__init__(x, kernel, cfg)
        self.mesh = mesh
        self.n_global = n = self.n
        self.n_shards = int(mesh.shape[cfg.shard_axis])
        chunk = ROW_CHUNK * self.n_shards
        self.n = (n if self.n_shards == 1             # n_local
                  else -(-n // chunk) * ROW_CHUNK)
        self.row0 = mesh.rank * self.n
        self.valid = max(0, min(self.n, n - self.row0))  # rows inside X
        self._mode = kernel.name if kernel.name in ("rbf", "linear") else None
        self._xk = self.x.to(ops.tile_dtype(cfg.gram_dtype)).contiguous()
        self._x2 = K.sqnorms(self._xk)
        self._xs = staged(self._xk)

    def _pad(self, t: torch.Tensor) -> torch.Tensor:
        """(.., valid) -> (.., n_local), zero on the padding."""
        return torch.nn.functional.pad(t, (0, self.n - t.shape[-1]))

    def _local(self, rows: torch.Tensor, first: int = 0) -> torch.Tensor:
        """This rank's block of rows that start at global row ``first``,
        zero-padded to (n_local,)."""
        start = self.row0 - first
        return self._pad(rows[start:start + self.valid])

    def _compute_row(self, i):
        if self._mode is None:   # the whole row's slice, bit for bit
            return self._local(super()._compute_row(i))
        return ops.gram_row(self._xk, self._x2, i, gamma=self.kernel.gamma,
                            mode=self._mode, row0=self.row0, count=self.n)

    def _cached_row(self, i, cache):
        if self._mode is None:
            return super()._cached_row(i, cache)
        return ops.gram_row_cached(
            self._xk, self._x2, i, cache.keys, cache.stamp, cache.rows,
            cache.clock, cache.hits, cache.misses, gamma=self.kernel.gamma,
            mode=self._mode, row0=self.row0, count=self.n)

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """The (n,) global vector of the ranks' (n_local,) parts: one
        all_reduce SUM over a zero-filled (P n_local,) buffer in which
        each rank writes its block (exact: every other entry is 0)."""
        full = v.new_zeros((self.n_shards * self.n,))
        full[self.row0:self.row0 + self.n] = v
        return self.mesh.all_reduce(full)[:self.n_global]

    def _first_block(self) -> tuple[int, int]:
        """(row step, first row) of the whole engine's chunk-row blocks
        that meet this rank's range (the blocks the unsharded engine's
        matvec and diag compute, so each entry has their bits)."""
        step = min(self.cfg.chunk, max(self.n_global, 1))
        return step, self.row0 // step * step

    def matvec(self, v):
        if self._mode is None:
            v = self.gather(v)
            step, first = self._first_block()
            rows = [self._gram_fn(self.x[s:s + step], self.x) @ v
                    for s in range(first, self.row0 + self.valid, step)]
            return self._local(torch.cat(rows) if rows else v[:0], first)
        return ops.gram_matvec(self._xs, self._x2, self.gather(v),
                               gamma=self.kernel.gamma, mode=self._mode,
                               chunk=self.cfg.chunk, row0=self.row0,
                               count=self.n)

    def diag(self):
        if self.kernel.name == "rbf":   # K(x, x) = exp(0) exactly
            return torch.ones((self.n,), dtype=torch.float32,
                              device=self.device)
        step, first = self._first_block()
        diag = [torch.diagonal(self._gram_fn(xb, xb))
                for xb in (self.x[s:s + step] for s in range(
                    first, self.row0 + self.valid, step))]
        return self._local(torch.cat(diag) if diag else self.x[:0, 0], first)

    def cross(self, z):
        if self._mode is None:
            return self._pad(self._gram_fn(
                z.to(torch.float32),
                self.x[self.row0:self.row0 + self.valid]))
        lo, hi = self.row0, self.row0 + self.valid
        return self._pad(ops.rbf_gram(
            z, self._xs[lo:hi], gamma=self.kernel.gamma, mode=self._mode,
            compute_dtype=self.cfg.gram_dtype, b2=self._x2[lo:hi]))

    def block(self, rows, cols):
        """K(x_rows, x_cols) for GLOBAL index tensors."""
        if self._mode is None:
            return super().block(rows, cols)
        return ops.rbf_gram(self._xk[rows], self._xk[cols],
                            gamma=self.kernel.gamma, mode=self._mode,
                            compute_dtype=self.cfg.gram_dtype,
                            a2=self._x2[rows], b2=self._x2[cols])

    def decide(self, z, coef, b=0.0):
        """sum_i coef_i K(z, x_i) + b over ALL samples, from the LOCAL
        ``coef``: this rank's partial (the ``decision`` kernel for RBF),
        then one all_reduce SUM. A collective: every rank calls it."""
        z = z.to(torch.float32)
        lo, hi = self.row0, self.row0 + self.valid
        if self.kernel.name == "rbf":
            part = ops.decision(z, self.x[lo:hi], coef[:self.valid].contiguous(),
                                0.0, gamma=self.kernel.gamma,
                                compute_dtype=self.cfg.gram_dtype)
        else:
            part = super().decide(z, coef, 0.0)
        return self.mesh.all_reduce(part.contiguous()) + b

    def full(self):
        raise RuntimeError(
            "ShardedKernelEngine has no global Gram; row()/matvec() "
            "return local slices of the sharded sample axis")


_BACKENDS = {
    "dense": DenseKernelEngine,
    "chunked": ChunkedKernelEngine,
    "pallas": PallasKernelEngine,
}


class TaskKernelEngine:
    """The kernel engine of a multiclass bucket: T binary tasks stacked
    as x (T, w, d), zero-padded, solved together by
    ``smo.solve_qp_tasks`` — the counterpart of the reference's engine
    under ``vmap`` (``repro/core/dist.py::_batched_engine``).

    It keeps one single-task engine per task (views of ``x``, no row
    cache: a batched lookup would compute every row anyway), so
    ``diag`` and ``matvec`` are those engines' own, value for value (the
    task-axis matvec launch gives each task its lone call's bits).
    ``row(i)`` takes the (T,) indices and returns the (T, w) rows:
    gathered from the stacked Gram (dense), one launch of the task-axis
    row kernel (pallas, RBF / linear), or the tasks' own row functions
    (chunked). Each task's row equals its engine's. ``auto`` picks dense
    up to ``dense_limit`` columns, chunked above, per bucket width. A
    given (T, w, w) ``gram`` forces dense over those Grams (the
    reference's shim for precomputed Grams).
    """

    def __init__(self, x: torch.Tensor, kernel: K.KernelParams,
                 cfg: EngineConfig | str = EngineConfig(), *,
                 gram: Optional[torch.Tensor] = None):
        if isinstance(cfg, str):
            cfg = EngineConfig(backend=cfg)
        if gram is not None:
            cfg = dataclasses.replace(cfg, backend="dense")
        check_backend(cfg.backend)
        if cfg.backend in LOWRANK_BACKENDS:
            raise ValueError(
                f"engine {cfg.backend!r} has no task-batched form: a "
                "low-rank multiclass fit shares one feature map over the "
                "tasks (SVC with engine='nystrom' | 'rff')")
        if cfg.backend == "sharded":
            raise ValueError(
                "engine 'sharded' has no task-batched form: a task is "
                "sharded over a mesh by dist.fit_taskset(shard='data')")
        if x.ndim != 3:
            raise ValueError(f"TaskKernelEngine: x must be (T, w, d), got "
                             f"{tuple(x.shape)}")
        self.x = x.to(torch.float32).contiguous()
        self.n_tasks, self.n = self.x.shape[:2]
        self.device = self.x.device
        self.kernel = kernel
        backend = cfg.backend
        if backend == "auto":
            backend = "dense" if self.n <= cfg.dense_limit else "chunked"
        self.backend = backend
        self.cfg = dataclasses.replace(cfg, backend=backend, cache_slots=0)
        self._gram = self._xk = None
        if backend == "dense":
            # one stacked Gram; the task engines hold views of it
            if gram is None:
                fn = K.make_gram_fn(kernel, compute_dtype=cfg.gram_dtype)
                gram = torch.stack([fn(xt, xt) for xt in self.x])
            self._gram = gram.to(device=self.device, dtype=torch.float32)
            self.tasks = [DenseKernelEngine(xt, kernel, self.cfg, gram=g)
                          for xt, g in zip(self.x, self._gram)]
            # made once: a row call allocates nothing of its own (a
            # captured SMO block would take it from the graph's pool)
            self._task_ids = torch.arange(self.n_tasks, device=self.device)
            return
        self.tasks = [_BACKENDS[backend](xt, kernel, self.cfg)
                      for xt in self.x]
        if backend == "pallas" and self.tasks[0]._mode is not None:
            self._xk = self.x.to(ops.tile_dtype(cfg.gram_dtype)).contiguous()
            self._x2 = torch.stack([e._x2 for e in self.tasks])
            self._xs = staged(self._xk)

    def init_cache(self) -> None:
        return None

    def row(self, i: torch.Tensor, cache=None):
        """((T, w) rows K(X_t, x_t[i_t]), None) for the (T,) indices."""
        if self._gram is not None:
            return self._gram[self._task_ids, i], cache
        if self._xk is not None:
            return ops.gram_row(self._xk, self._x2, i,
                                gamma=self.kernel.gamma,
                                mode=self.tasks[0]._mode), cache
        return torch.stack([e._compute_row(it)
                            for e, it in zip(self.tasks, i)]), cache

    def diag(self) -> torch.Tensor:
        return torch.stack([e.diag() for e in self.tasks])

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """(T, w) K_t v_t: one launch of the task-axis Gram matvec under
        ``pallas`` (RBF / linear), else the tasks' own matvecs."""
        if self._xk is not None:
            return ops.gram_matvec(self._xs, self._x2, v.contiguous(),
                                   gamma=self.kernel.gamma,
                                   mode=self.tasks[0]._mode,
                                   chunk=self.cfg.chunk)
        return torch.stack([e.matvec(vt) for e, vt in zip(self.tasks, v)])

# low-rank approximation backends resolve lazily
# (repro_torch.core.approx imports this module for the base class)
LOWRANK_BACKENDS = ("nystrom", "rff")


def check_backend(backend: str) -> None:
    """Raise for an unknown backend name."""
    if (backend not in ("auto", "sharded") and backend not in _BACKENDS
            and backend not in LOWRANK_BACKENDS):
        raise ValueError(
            f"unknown engine backend {backend!r}; expected one of "
            f"{sorted([*_BACKENDS, *LOWRANK_BACKENDS, 'sharded'])}"
            " or 'auto'")


def make_engine(x: torch.Tensor, kernel: K.KernelParams,
                cfg: EngineConfig | str = EngineConfig(), *,
                gram: Optional[torch.Tensor] = None,
                mesh=None) -> KernelEngine:
    """Resolve an EngineConfig (or backend name) into an engine bound to
    ``x``, on ``x``'s device. A provided ``gram`` forces the dense
    backend (the reference's shim for precomputed Grams). The
    ``sharded`` backend is one rank's engine over ``mesh`` (``x`` the
    full sample matrix); without a mesh or ``shard_axis`` it raises the
    reference's ValueError."""
    if isinstance(cfg, str):
        cfg = EngineConfig(backend=cfg)
    if gram is not None:
        return DenseKernelEngine(x, kernel, cfg, gram=gram)
    check_backend(cfg.backend)
    backend = cfg.backend
    if backend == "sharded":
        return ShardedKernelEngine(x, kernel, cfg, mesh=mesh)
    if backend == "auto":
        backend = "dense" if x.shape[0] <= cfg.dense_limit else "chunked"
    if backend in LOWRANK_BACKENDS:
        from repro_torch.core.approx import LowRankKernelEngine
        return LowRankKernelEngine(x, kernel, cfg)
    return _BACKENDS[backend](x, kernel, cfg)
