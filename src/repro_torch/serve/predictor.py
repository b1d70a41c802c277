"""Batched serving engine: device-resident SV banks and one decide
program per batch bucket.

Mirrors ``repro/serve/predictor.py``:

* the packed SV bank is moved to the device once, at construction, and
  stays resident — at the pack's storage dtype: a quantized pack
  (``sv_dtype`` "fp16" | "bf16", schema v3) keeps half the bytes of an
  fp32 one on the device. With ``engine="pallas"`` the decision kernel
  reads such a bank as it is (widening it to float32 as it stages it,
  float32 accumulation), so no request copies it; the chunked config
  upcasts it per call (it is the plain path). Only ``sv_coef``, 1/d of
  the bank, is upcast once, at construction. Under bf16 compute
  (``gram_dtype="bf16"``) every bank is rounded once to bf16 at
  construction (fp16 -> float32 is exact, then to nearest even), which
  is what the reference computes per call;
* a request is cut into slices of at most ``max_batch`` rows, and each
  slice is zero-padded up to the next power of two (capped at
  ``max_batch``), so arbitrary request sizes reuse a small warm set of
  program shapes; padded rows are sliced off before results leave;
* a slice runs the decide program of its batch bucket: with
  ``engine="pallas"`` and an RBF kernel, one launch of the fused
  ``multitask_decision`` kernel a serving bucket of the pack — a
  multiclass bucket stacks T tasks (T, w, d) and gets its (T, B)
  decisions from that one launch — and its bias add, each bank's rows
  written into its tasks' rows of one (n_tasks, B) output; the chunked
  config runs ``KernelEngine.decide`` per task (the plain reference
  path);
* a low-rank pack (``PackedModel.feature_map``) keeps the feature map
  and the linear weights resident instead of an SV bank; its program is
  one feature transform (the ``rff_features`` kernel for an RFF map on
  the card) and a (rank, n_tasks) matmul, on the same ladder;
* an SVR pack decodes to its decision values (``predict`` returns
  them); a multiclass pack decodes its (n_tasks, nt) decisions by vote,
  margin or OvR argmax (``multiclass.decide_from_pairs``) on the
  host, where the decisions already are.

**The programs.** A bucket's program keeps static buffers: the padded
rows and the (n_tasks, bucket) output on the device, and on the card
their pinned host staging. A slice copies its rows in, runs the program,
and reads the output back once. On the card, the kernel route (pallas +
RBF) and every low-rank pack run their program as a CUDA graph, the
counterpart of the reference's ``jax.jit`` program per (bank signature,
batch bucket): the first call at a bucket (at ``warmup``, or the first
request of an unwarmed size) runs it eagerly, which resolves the launch
plans and builds the kernel library, and then captures it through
``torch.cuda.CUDAGraph`` on this thread's capture stream
(``ops.capture_stream``); every later call is one replay on the
caller's stream. The capture's error mode is ``"thread_local"``: under
``"global"`` a replay or a copy on another thread while this thread
captures fails and invalidates the capture, so a predictor could not
capture a bucket while another serves. The graphs share one private memory
pool a predictor (their replays never overlap); the split launches'
scratch is the predictor's own (``ops.serving_scratch``, made once at
the most any plan of its banks takes at ``max_batch`` rows, installed
only while capturing), so no stream's scratch, and no other predictor,
shares a graph's pointers. A replay adds the captured launches to
``ops.launches`` (the eager run's counts). A capture, instantiation or
replay that fails raises; nothing falls back to the eager path. The
plain path (the chunked config, other kernels), the CPU, and
``CUDA_GRAPHS = False`` run the same program eagerly. Dropping the
predictor frees its banks, buffers, graphs and pool.

``n_programs`` counts the distinct (bank signature, batch bucket) pairs
served so far (``("lowrank", bucket)`` for a low-rank pack): what the
reference's jit compiles. Each new one is reported to an active
``analysis.compile_guard.CompileGuard``, and each capture as a ``cuda
graph capture`` labelled ``predictor program`` with its signatures.

``decision_values`` is thread-safe: the served-row counter and the
program ledger are guarded by one lock, a bucket's static buffers (the
copy-in, the run or replay and the read-out) by another, a predictor's
own; each caller owns its output.

    pred = Predictor(serve.load("model.npz"), engine="pallas")
    pred.warmup((1, 256)).predict(Z)
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.analysis.compile_guard import capture_label, record
from repro_torch.core import approx
from repro_torch.core import kernel_engine as KE
from repro_torch.core import multiclass as MC
from repro_torch.kernels import ops
from repro_torch.serve.artifact import PackedModel, bank_f32, bf16_bits

# On the card, a Predictor's kernel-route and low-rank programs replay a
# CUDA graph a batch bucket; False (read when a Predictor is made) runs
# them eagerly. The two give the same bits: tests and chip_smoke.py set it
# to compare them. The CPU never captures.
CUDA_GRAPHS = True


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


def _decide_stack(kernel, cfg: KE.EngineConfig, sv_x, sv_coef, b, z):
    """(T, w, d) stacked bank x (B, d) batch -> (T, B) decisions. The
    kernel reads the bank at its storage dtype; the chunked path
    upcasts it for the call."""
    if cfg.backend == "pallas" and kernel.name == "rbf":
        return ops.multitask_decision(
            z, sv_x, sv_coef, b, gamma=kernel.gamma, mode="rbf",
            compute_dtype=cfg.gram_dtype)
    return torch.stack([
        KE.make_engine(sv, kernel, cfg).decide(z, cf, bb)
        for sv, cf, bb in zip(sv_x.to(torch.float32), sv_coef, b)])


def _sv_program(banks, kernel, cfg: KE.EngineConfig, device):
    """``decide(z, out)`` of an SV pack: each bank's (T, B) decisions (an
    empty-SV bank's bias) into its tasks' rows of ``out``."""
    rows = [torch.from_numpy(np.asarray(ids, np.int64)).to(device)
            for _, _, _, ids in banks]

    def decide(z: torch.Tensor, out: torch.Tensor) -> None:
        for (sv_x, sv_coef, b, _), idx in zip(banks, rows):
            df = (b[:, None].expand(-1, z.shape[0]) if sv_x.shape[1] == 0
                  else _decide_stack(kernel, cfg, sv_x, sv_coef, b, z))
            out.index_copy_(0, idx, df)
    return decide


def _lowrank_program(fmap, w: torch.Tensor, lb: torch.Tensor):
    """``decide(z, out)`` of a low-rank pack: the feature transform and
    the (rank, n_tasks) matmul."""
    def decide(z: torch.Tensor, out: torch.Tensor) -> None:
        out.copy_((fmap.transform(z) @ w.T).T + lb[:, None])
    return decide


class _Program:
    """One batch bucket's program: its static rows and output, and on
    the card their pinned host staging and, once captured, the graph and
    the launches it replays."""

    def __init__(self, bucket: int, n_features: int, n_tasks: int,
                 device: torch.device):
        self.bucket = bucket
        self.z = torch.zeros((bucket, n_features), device=device)
        self.out = torch.zeros((n_tasks, bucket), device=device)
        on_card = device.type == "cuda"
        self.z_host = (torch.zeros((bucket, n_features), pin_memory=True)
                       if on_card else self.z)
        self.out_host = (torch.zeros((n_tasks, bucket), pin_memory=True)
                         if on_card else self.out)
        self.z_np, self.out_np = self.z_host.numpy(), self.out_host.numpy()
        self.graph = None
        self.launches: dict = {}


class Predictor:
    """Serve an SVC (binary or multiclass) or SVR ``PackedModel`` on
    ``device``; see module docstring."""

    # the served-row counter and program ledger are mutated by every
    # concurrent decision_values caller; the bucket programs' static
    # buffers, graphs and counters are shared by them too (enforced by
    # analysis rule R004)
    _GUARDED_BY = {"n_requests": "_lock", "_program_sigs": "_lock",
                   "_programs": "_run_lock", "_graph_stats": "_run_lock",
                   "_scratch": "_run_lock", "_pool": "_run_lock"}

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
        # storage dtype; task_ids stay on the host (the ledger's
        # signatures) and on the device (the program's scatter)
        self._banks = tuple(
            (self._resident_bank(g.sv_x),
             torch.from_numpy(bank_f32(g.sv_coef, model.sv_dtype))
             .to(self.device),
             torch.from_numpy(np.asarray(g.b, np.float32)).to(self.device),
             np.asarray(g.task_ids))
            for g in model.buckets)
        kernel_route = (self.engine_cfg.backend == "pallas"
                        and model.kernel.name == "rbf")
        if model.feature_map is not None:
            fm = model.feature_map
            self._fmap = approx.map_from_arrays(
                fm.kind, model.kernel, fm.a, fm.b,
                gram_dtype=self.engine_cfg.gram_dtype, device=self.device)
            self._linear = tuple(
                torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
                for a in (model.linear_w, model.linear_b))
            self._decide = _lowrank_program(self._fmap, *self._linear)
        else:
            self._decide = _sv_program(self._banks, model.kernel,
                                       self.engine_cfg, self.device)
        self._graphed = (self.device.type == "cuda" and CUDA_GRAPHS
                         and (model.feature_map is not None
                              or kernel_route))
        self.n_requests = 0  # rows served (warmup excluded)
        self._program_sigs: set = set()
        self._lock = threading.Lock()
        self._run_lock = threading.Lock()
        self._programs: dict = {}   # batch bucket -> _Program
        self._graph_stats = {"captures": 0, "capture_s": 0.0,
                             "instantiate_s": 0.0, "replays": 0}
        self._scratch = None   # the split launches' own scratch
        self._pool = None      # the graphs' private memory pool

    def _resident_bank(self, sv_x: np.ndarray) -> torch.Tensor:
        """A bank on the device at its storage dtype: float32, float16,
        or bfloat16 viewed from its uint16 bits; under bf16 compute an
        fp32 or fp16 bank rounded once to bf16."""
        sv_dtype = self.model.sv_dtype
        if sv_dtype != "bf16" and self.engine_cfg.gram_dtype == "bf16":
            sv_x, sv_dtype = bf16_bits(np.asarray(sv_x, np.float32)), "bf16"
        if sv_dtype == "bf16":
            bits = np.ascontiguousarray(sv_x, np.uint16).view(np.int16)
            return torch.from_numpy(bits).view(torch.bfloat16).to(self.device)
        return torch.from_numpy(np.ascontiguousarray(sv_x)).to(self.device)

    # ---------------------------------------------------------- programs
    @property
    def n_programs(self) -> int:
        """Distinct (bank shape/dtype, batch bucket) signatures served."""
        with self._lock:
            return len(self._program_sigs)

    @property
    def graph_stats(self) -> dict:
        """The programs' CUDA graphs so far: captures, seconds issuing
        and instantiating them, replays (a copy)."""
        with self._run_lock:
            return dict(self._graph_stats)

    def _batch_bucket(self, t: int) -> int:
        return min(self.max_batch, 1 << (max(t, 1) - 1).bit_length())

    def _signatures(self, bucket: int) -> list:
        """The (bank signature, bucket) pairs a bucket's program serves."""
        if self.model.feature_map is not None:
            return [("lowrank", bucket)]
        return [(tuple(sv_x.shape), str(sv_x.dtype), bucket)
                for sv_x, _, _, _ in self._banks if sv_x.shape[1] > 0]

    def _serve_slice(self, rows: np.ndarray, bucket: int,
                     dest: np.ndarray) -> None:
        """Decisions of ``rows`` (at most ``bucket``) into ``dest``
        (n_tasks, len(rows)) through the bucket's program."""
        n = rows.shape[0]
        with self._run_lock:
            prog = self._programs.get(bucket)
            if prog is None:
                prog = _Program(bucket, self.model.n_features,
                                self.model.n_tasks, self.device)
                self._programs[bucket] = prog
            prog.z_np[:n] = rows
            prog.z_np[n:] = 0.0
            on_card = self.device.type == "cuda"
            if on_card:
                prog.z.copy_(prog.z_host, non_blocking=True)
            if prog.graph is not None:
                prog.graph.replay()
                ops.add_launches(prog.launches)
                self._graph_stats["replays"] += 1
            else:
                self._decide(prog.z, prog.out)
                if self._graphed:
                    self._capture(prog)
            if on_card:
                prog.out_host.copy_(prog.out, non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
            dest[:] = prog.out_np[:, :n]

    def _capture(self, prog: _Program) -> None:  # repro: holds[_run_lock]
        """Capture ``prog``'s program as a CUDA graph on this thread's
        capture stream, with the predictor's own scratch and pool."""
        dev = self.device
        side, caller = ops.capture_stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            if self._scratch is None:
                self._scratch = ops.serving_scratch(
                    dev, [tuple(sv.shape[:2]) for sv, _, _, _ in self._banks
                          if sv.shape[1] > 0], self.max_batch)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            label = f"predictor program {self._signatures(prog.bucket)}"
            with ops.using_scratch(self._scratch), \
                    ops.captured_launches() as launches:
                t0 = time.perf_counter()
                with capture_label(label):
                    # thread_local: in "global" mode another thread's
                    # replay (a copy, a stream sync) is refused while
                    # this capture runs, and invalidates it
                    graph.capture_begin(pool=self._pool,
                                        capture_error_mode="thread_local")
                try:
                    self._decide(prog.z, prog.out)
                except BaseException:
                    # end the broken capture, then raise what broke it
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                t1 = time.perf_counter()
                graph.capture_end()    # instantiates the graph
                t2 = time.perf_counter()
        caller.wait_stream(side)
        prog.graph, prog.launches = graph, launches
        self._graph_stats["captures"] += 1
        self._graph_stats["capture_s"] += t1 - t0
        self._graph_stats["instantiate_s"] += t2 - t1

    def warmup(self, batch_sizes=(1,)) -> "Predictor":
        """Run the decide and decode paths once per request size (this
        also builds the CUDA kernels on first use and, on the card,
        captures each bucket's graph). Warmup rows do NOT count toward
        ``n_requests``."""
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
            self._serve_slice(xt[start:stop], bucket, out[:, start:stop])
            sigs.extend(self._signatures(bucket))
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
