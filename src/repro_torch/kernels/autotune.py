"""Launch-plan tuning for the port's SVM kernels.

The counterpart of ``repro/kernels/autotune.py``, function by function.
The five tunable kernels and their shapes are the reference's
(``rbf_gram`` N x M x D, ``rff_features`` N x K x D, ``kkt_select`` N,
``decision`` T x N x D, ``multitask_decision`` TASKS x T x W x D). What
differs is what a configuration is: not a fixed tile, but the knobs the
kernel's launch plan already takes, which its bits do not depend on:

* ``rbf_gram`` (the Gram block entry): ``rows``, the row tile of the
  mma route (``rbf_gram.ROWS``); each entry's dot runs in chunk order
  whatever the tile;
* ``rff_features``: ``rows`` (64 or 128), for the same reason;
* ``kkt_select``: ``blocks`` a task; the argmin / argmax with ties to
  the lowest index is exact in any split;
* ``decision`` / ``multitask_decision``: ``rows`` (64 or 128) and
  ``splits`` (1 .. the bank's segments); a row's sum is folded in an
  order fixed by the bank's width, and splits take whole segments.

The default configuration is the analytic plan each kernel uses without
a tuner (``rbf_gram.gram_plan``, ``feature_map.rff_plan``,
``kkt_select.n_blocks``, ``decision.decision_plan``), so with no cache
entry every launch is the plan it was, bit for bit:

* ``candidates(kernel, shape, dtype)`` enumerates the configurations —
  powers of two per knob (every split count for ``splits``), clipped to
  the shape, the default always included — and keeps those whose plan
  function accepts them and whose shared memory fits the Hopper opt-in
  limit of ``rbf_gram.SMEM_LIMIT`` bytes a block;
* ``roofline_estimate(...)`` prices a configuration on the H100
  (``repro_torch.roofline.collect``): the operations and bytes of the
  bounds ``chip_smoke.py`` reports, the operands a tile re-streams, and
  wave quantisation of the grid over the card's SMs;
* ``tune(...)`` is the reference's hill-climb: the default first, then
  single-knob x2 / /2 neighbours (an off-ladder default, as
  ``kkt_select``'s analytic block count, steps to the powers of two
  around it), a move only on a strict improvement, a stop when no
  neighbour improves or ``budget`` configurations were evaluated;
* ``TuningCache`` is the reference's versioned JSON keyed by
  ``device|kernel|dtype|bucket``. A missing, corrupted or
  version-mismatched file gives an empty cache; a malformed entry, or
  one whose plan the plan function rejects, is dropped and counted
  (``TuningCache.dropped``), never launched;
* ``resolve_gram`` / ``resolve_rff`` / ``resolve_kkt`` /
  ``resolve_decision`` are the runtime path of ``kernels.ops``: an
  explicit knob wins, else the tuned entry of this shape's bucket, else
  the analytic plan. They are memoised per (shape, dtype, device,
  knobs), so the cache is read once a distinct shape, never once a
  launch; ``reset`` / ``set_cache_path`` clear them.

Objectives
----------
``wall``      median device time of the real ``ops`` wrapper with the
              configuration forced (CUDA events around back-to-back
              calls queued behind a spin kernel); on the card only.
``roofline``  the estimate alone.
``auto``      ``wall`` on the card and ``roofline`` on the CPU. Unlike
              the reference's ``combined``, nothing is timed on the CPU:
              there the wrappers run the plain versions, which take no
              plan, so a wall time would measure nothing of the knobs.

The cache location is ``$REPRO_TORCH_TUNE_CACHE`` when set, else
``~/.cache/repro_torch/autotune.json``, so a cache the reference wrote
for a TPU is never read here. ``repro_torch.roofline.svm_tune`` is the
command line that fills it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.analysis.compile_guard import memoised
from repro_torch.kernels import decision as D
from repro_torch.kernels import feature_map as FM
from repro_torch.kernels import kkt_select as KS
from repro_torch.kernels import rbf_gram as G
from repro_torch.kernels.tile_f32 import H100_SMS
from repro_torch.roofline.collect import roofline_terms

CACHE_VERSION = 1
_ENV_CACHE = "REPRO_TORCH_TUNE_CACHE"

# the knobs of each tunable kernel's launch plan
KNOBS: dict[str, tuple[str, ...]] = {
    "rbf_gram": ("rows",),
    "rff_features": ("rows",),
    "kkt_select": ("blocks",),
    "decision": ("rows", "splits"),
    "multitask_decision": ("rows", "splits"),
}
_AXES = {
    "rbf_gram": ("n", "m", "d"),
    "rff_features": ("n", "k", "d"),
    "kkt_select": ("n",),
    "decision": ("t", "n", "d"),
    "multitask_decision": ("tasks", "t", "w", "d"),
}
_TILE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _next_pow2(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# --------------------------------------------------------------- buckets
def shape_bucket(kernel: str, shape: tuple[int, ...]) -> str:
    """Shape -> cache-bucket string: every axis rounded up to a power of
    two, so one tuning run generalizes to its whole pow2 neighbourhood
    (the serving layer already pads batches to pow2 buckets)."""
    axes = _AXES[kernel]
    if len(shape) != len(axes):
        raise ValueError(
            f"{kernel} expects a {len(axes)}-axis shape {axes}, got "
            f"{shape}")
    return "_".join(f"{a}{_next_pow2(s)}" for a, s in zip(axes, shape))


def cache_key(device: str, kernel: str, dtype: str,
              shape: tuple[int, ...]) -> str:
    return "|".join((device, kernel, dtype, shape_bucket(kernel, shape)))


def _device(device=None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_kind(device=None) -> str:
    """``torch.cuda.get_device_name`` of ``device`` (the current card by
    default) with "|" replaced, or "cpu"."""
    dev = _device(device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev).replace("|", "_")


def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


# ------------------------------------------------------------ the plans
def plan(kernel: str, shape: tuple[int, ...], dtype: str = "fp32",
         cfg: Optional[dict] = None, sms: int = H100_SMS):
    """The launch plan of configuration ``cfg`` (knobs left out, or no
    ``cfg``: the analytic choice) from the kernel's plan function — a
    ``GramPlan``, ``RffPlan``, ``DecisionPlan``, or ``kkt_select``'s
    block count. Raises ValueError where the plan function rejects it."""
    cfg = cfg or {}
    if kernel == "rbf_gram":
        n, m, d = shape
        return G.gram_plan(n, m, d, _TILE_DTYPES[dtype], 1, "block", sms,
                           cfg.get("rows"))
    if kernel == "rff_features":
        n, k, d = shape
        return FM.rff_plan(n, k, d, sms, cfg.get("rows"))
    if kernel == "kkt_select":
        n, = shape
        blocks = cfg.get("blocks")
        if blocks is None:
            return KS.n_blocks(n)
        if not 1 <= blocks <= KS.MAX_BLOCKS:
            raise ValueError(f"kkt_select: blocks must be in [1, "
                             f"{KS.MAX_BLOCKS}], got {blocks}")
        return blocks
    if kernel == "decision":
        t, n, d = shape
        return D.decision_plan(t, 1, n, d, sms, cfg.get("rows"),
                               cfg.get("splits"), _TILE_DTYPES[dtype])
    if kernel == "multitask_decision":
        tasks, t, w, d = shape
        return D.decision_plan(t, tasks, w, d, sms, cfg.get("rows"),
                               cfg.get("splits"), _TILE_DTYPES[dtype])
    raise ValueError(f"unknown tunable kernel {kernel!r}; expected one of "
                     f"{sorted(KNOBS)}")


def config_of(kernel: str, the_plan) -> dict[str, int]:
    """The knobs of a plan."""
    if kernel == "kkt_select":
        return {"blocks": int(the_plan)}
    return {k: int(getattr(the_plan, k)) for k in KNOBS[kernel]}


def default_config(kernel: str, shape: tuple[int, ...], dtype: str = "fp32",
                   sms: int = H100_SMS) -> dict[str, int]:
    """The knobs of the analytic plan (what runs without a tuner)."""
    return config_of(kernel, plan(kernel, shape, dtype, None, sms))


def feasible(kernel: str, shape: tuple[int, ...], dtype: str,
             cfg: dict, sms: int = H100_SMS) -> bool:
    """True if the plan function takes ``cfg`` at this shape and its
    shared memory fits a block's opt-in limit."""
    try:
        p = plan(kernel, shape, dtype, cfg, sms)
    except ValueError:
        return False
    return getattr(p, "smem_bytes", 0) <= G.SMEM_LIMIT


# ------------------------------------------------------------ candidates
def _ladders(kernel: str, shape: tuple[int, ...]) -> dict[str, tuple]:
    """Each knob's values at this shape: powers of two up to the
    (pow2-rounded) axis they tile, every split count up to the bank's
    segments."""
    def up_to(ladder, axis):
        cap = max(_next_pow2(axis), ladder[0])
        return tuple(v for v in ladder if v <= cap)

    if kernel == "rbf_gram":
        return {"rows": up_to(G.ROWS, shape[0])}
    if kernel == "rff_features":
        return {"rows": up_to(FM.ROWS, shape[0])}
    if kernel == "kkt_select":   # up to one element a thread
        pow2 = tuple(1 << i for i in range(KS.MAX_BLOCKS.bit_length()))
        return {"blocks": up_to(pow2, _ceil_div(shape[0], KS.THREADS))}
    t, w = (shape[0], shape[1]) if kernel == "decision" else shape[1:3]
    segments = _ceil_div(max(1, _ceil_div(w, D.SV_TILE)),
                         D.segment_tiles(w))
    return {"rows": up_to((64, 128), t),
            "splits": tuple(range(1, segments + 1))}


def candidates(kernel: str, shape: tuple[int, ...], dtype: str = "fp32",
               sms: int = H100_SMS) -> list[dict[str, int]]:
    """Feasible configurations: ladder values clipped to the shape,
    filtered by the plan function and the shared-memory limit, the
    default always included (first where it is off the ladders)."""
    ladders = _ladders(kernel, shape)
    out: list[dict[str, int]] = [{}]
    for knob, values in ladders.items():
        out = [dict(c, **{knob: v}) for c in out for v in values]
    default = default_config(kernel, shape, dtype, sms)
    if default not in out:
        out.insert(0, default)
    return [c for c in out if feasible(kernel, shape, dtype, c, sms)] or \
        [default]


def clip_to_candidates(kernel: str, cfg: dict[str, int],
                       shape: tuple[int, ...], dtype: str = "fp32",
                       sms: int = H100_SMS) -> dict[str, int]:
    """Clip a configuration onto the per-shape candidates: each knob
    into its range at this shape, then down to a value there; the
    default where the result is not a candidate (a tile past a tiny
    problem clips down to the largest that fits it)."""
    space = candidates(kernel, shape, dtype, sms)
    default = default_config(kernel, shape, dtype, sms)
    out = {}
    for knob in KNOBS[kernel]:
        values = sorted({c[knob] for c in space})
        v = min(max(cfg.get(knob, default[knob]), values[0]), values[-1])
        out[knob] = max(x for x in values if x <= v)
    return out if out in space else default


# ------------------------------------------------------ roofline pricing
def roofline_estimate(kernel: str, shape: tuple[int, ...], dtype: str,
                      cfg: dict[str, int], sms: int = H100_SMS) -> dict:
    """Analytic per-call roofline terms of one configuration on the
    H100. Operations as ``chip_smoke.py``'s bounds count them (the Gram
    block's dots 3 x 2 n m d as 3xTF32 or 2 n m d in bf16 on the tensor
    cores, 6 epilogue operations a pair; 2d + 8 a (row, SV) pair of a
    decision; 2d + 3 a feature of ``rff_features``); HBM bytes as each
    tile streams its operands (an operand tile is read again by every
    block that needs it, so bigger tiles re-stream less); and wave
    quantisation: the time of ``ceil(blocks / sms)`` full waves, as if
    every SM took a share of the grid."""
    es = 2 if dtype == "bf16" else 4
    p = plan(kernel, shape, dtype, cfg, sms)
    fp32 = tf32 = bf16 = 0.0
    if kernel == "rbf_gram":
        n, m, d = shape
        row_tiles, col_tiles = _ceil_div(n, p.rows), _ceil_div(m, G.COLS)
        if dtype == "bf16":
            bf16 = 2.0 * n * m * d
        else:
            tf32 = 6.0 * n * m * d
        fp32 = 6.0 * n * m
        a_reads = 1 if p.chunks == 1 else _ceil_div(col_tiles, p.groups)
        hbm = (a_reads * n * d * es + row_tiles * m * d * es + n * m * 4
               + n * 4 + row_tiles * m * 4)
        blocks = row_tiles * p.groups
    elif kernel == "rff_features":
        n, k, d = shape
        row_tiles, cols = _ceil_div(n, p.rows), _ceil_div(k, FM.COLS)
        fp32 = n * k * (2.0 * d + 3.0)
        hbm = (cols * n * d * es + row_tiles * k * (d * es + 4)
               + n * k * 4)
        blocks = p.blocks
    elif kernel == "kkt_select":
        n, = shape
        fp32 = 12.0 * n
        hbm = 21 * n + 2 * 2 * p * 8 + 16   # inputs, keys out and back
        blocks = p
    else:
        tasks, t, w, d = ((1,) + tuple(shape) if kernel == "decision"
                          else tuple(shape))
        row_tiles = _ceil_div(t, p.rows)
        fp32 = tasks * t * w * (2.0 * d + 8.0)
        hbm = (tasks * p.splits * t * d * es        # test rows a block
               + row_tiles * tasks * w * (d * es + 4)  # bank a row tile
               + tasks * t * 4
               + (2 * tasks * p.segments * t * 8 if p.splits > 1 else 0))
        blocks = p.blocks
    terms = roofline_terms(hbm_bytes=hbm, fp32_flops=fp32, tf32_flops=tf32,
                           bf16_flops=bf16)
    waves = _ceil_div(blocks, sms)
    terms["t_total_est_s"] *= waves * sms / blocks
    terms.update(flops=fp32 + tf32 + bf16, hbm_bytes=float(hbm),
                 blocks=blocks, waves=waves)
    return terms


# ------------------------------------------------------------ measuring
SPIN_CYCLES = 8_000_000   # ~4 ms at the H100's clocks: longer than the
                          # host takes to enqueue the timed calls


def device_ms(fn: Callable, calls: int = 10, reps: int = 3,
              warmup: int = 1) -> float:
    """Device time of one call of ``fn`` (median of ``reps``): CUDA
    events around ``calls`` back-to-back calls enqueued behind a spin
    kernel, so the host's enqueue is hidden (``chip_smoke.device_ms``)."""
    for _ in range(max(warmup, 1)):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bench_inputs(kernel: str, shape: tuple[int, ...], dtype: str = "fp32",
                 device=None, seed: int = 0) -> dict:
    """Seeded operands of one call at ``shape`` on ``device``, already at
    the compute dtype (Gram operands in ``rbf_gram.staged``'s layout,
    with their norms), so a timed call is the kernel alone."""
    from repro_torch.core.kernels import sqnorms
    dev = _device(device)
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    dt = _TILE_DTYPES[dtype]
    if kernel == "rbf_gram":
        n, m, d = shape
        a, b = (G.staged(t(rng.normal(size=(r, d)), dt)) for r in (n, m))
        return dict(a=a, b=b, a2=sqnorms(a), b2=sqnorms(b))
    if kernel == "rff_features":
        n, k, d = shape
        return dict(x=t(rng.normal(size=(n, d)), dt),
                    omega=t(rng.normal(size=(d, k)), dt),
                    phase=t(rng.uniform(0, 2 * np.pi, size=k)),
                    scale=math.sqrt(2.0 / k))
    if kernel == "kkt_select":
        n, = shape
        return dict(f=t(rng.normal(size=n)), alpha=t(rng.uniform(0, 1, n)),
                    y=t(np.where(rng.random(n) < 0.5, 1.0, -1.0)),
                    mask=torch.ones(n, dtype=torch.bool, device=dev),
                    lo=t(np.zeros(n)), hi=t(np.ones(n)))
    if kernel == "decision":
        t_, n, d = shape
        return dict(z=t(rng.normal(size=(t_, d)), dt),
                    sv=t(rng.normal(size=(n, d)), dt),
                    coef=t(rng.normal(size=n)))
    tasks, t_, w, d = shape
    return dict(z=t(rng.normal(size=(t_, d)), dt),
                sv=t(rng.normal(size=(tasks, w, d)), dt),
                coef=t(rng.normal(size=(tasks, w))))


def run(kernel: str, inputs: dict, dtype: str, cfg: dict[str, int]):
    """One call of the kernel's ``ops`` wrapper on ``inputs``
    (``bench_inputs``) with the knobs of ``cfg`` forced."""
    from repro_torch.kernels import ops   # ops imports this module
    if kernel == "rbf_gram":
        return ops.rbf_gram(inputs["a"], inputs["b"], gamma=0.5,
                            compute_dtype=dtype, a2=inputs["a2"],
                            b2=inputs["b2"], **cfg)
    if kernel == "rff_features":
        return ops.rff_features(inputs["x"], inputs["omega"],
                                inputs["phase"], scale=inputs["scale"],
                                compute_dtype=dtype, **cfg)
    if kernel == "kkt_select":
        return ops.kkt_select(inputs["f"], inputs["alpha"], inputs["y"],
                              inputs["mask"], inputs["lo"], inputs["hi"],
                              **cfg)
    if kernel == "decision":
        return ops.decision(inputs["z"], inputs["sv"], inputs["coef"],
                            gamma=0.5, compute_dtype=dtype, **cfg)
    return ops.multitask_decision(inputs["z"], inputs["sv"], inputs["coef"],
                                  gamma=0.5, compute_dtype=dtype, **cfg)


# ------------------------------------------------------------- hillclimb
@dataclasses.dataclass
class Evaluation:
    config: dict[str, int]
    roofline_s: float
    wall_s: Optional[float]
    score: tuple


@dataclasses.dataclass
class TuneResult:
    kernel: str
    shape: tuple[int, ...]
    dtype: str
    objective: str
    best: Evaluation
    default: Evaluation
    trace: list[Evaluation]

    @property
    def config(self) -> dict[str, int]:
        return self.best.config


def _resolve_objective(objective: str, device: torch.device) -> str:
    if objective == "auto":
        return "wall" if device.type == "cuda" else "roofline"
    if objective not in ("wall", "roofline"):
        raise ValueError(f"unknown objective {objective!r}; expected "
                         "'auto', 'wall' or 'roofline'")
    if objective == "wall" and device.type != "cuda":
        raise ValueError("objective 'wall' times the kernels on the card; "
                         "on the CPU the wrappers run the plain versions, "
                         "which take no plan (use 'roofline')")
    return objective


def _score(objective: str, roofline_s: float,
           wall_s: Optional[float]) -> tuple:
    return (wall_s,) if objective == "wall" else (roofline_s,)


def _neighbours(cfg: dict[str, int], space: list[dict[str, int]]
                ) -> list[dict[str, int]]:
    """Single-knob x2 / /2 steps that land inside the candidate space; a
    value with neither (an analytic default off a pow2 ladder) steps to
    the powers of two around it."""
    out = []
    for axis, v in cfg.items():
        steps = [v * 2, v // 2]
        if not any(dict(cfg, **{axis: s}) in space for s in steps):
            steps = [_next_pow2(v), _next_pow2(v) // 2]
        for nv in steps:
            cand = dict(cfg, **{axis: nv})
            if cand != cfg and cand in space and cand not in out:
                out.append(cand)
    return out


def tune(kernel: str, shape: tuple[int, ...], *, dtype: str = "fp32",
         budget: int = 12, objective: str = "auto", warmup: int = 1,
         iters: int = 3, device=None,
         inputs: Optional[dict] = None) -> TuneResult:
    """Hill-climb the launch plan for one (kernel, shape, dtype) on
    ``device`` (the card if there is one, else the CPU).

    Starts from the analytic default, evaluates its single-knob x2 / /2
    neighbours, moves to the strict best, and repeats until no neighbour
    improves or ``budget`` configurations have been evaluated. The
    default is always evaluated first, so ``result.best`` is never worse
    than the default under the chosen objective. ``wall`` times each
    configuration on ``inputs`` (``bench_inputs`` unless given): the
    median of ``iters`` device times after ``warmup`` calls."""
    dev = _device(device)
    obj = _resolve_objective(objective, dev)
    sms = _sm_count(dev)
    space = candidates(kernel, shape, dtype, sms)
    if obj == "wall" and inputs is None:
        inputs = bench_inputs(kernel, shape, dtype, dev)

    evaluated: dict[tuple, Evaluation] = {}

    def key(cfg):
        return tuple(sorted(cfg.items()))

    def evaluate(cfg) -> Evaluation:
        k = key(cfg)
        if k in evaluated:
            return evaluated[k]
        roofline_s = roofline_estimate(kernel, shape, dtype, cfg,
                                       sms)["t_total_est_s"]
        wall = (device_ms(lambda: run(kernel, inputs, dtype, cfg),
                          reps=iters, warmup=warmup) * 1e-3
                if obj == "wall" else None)
        ev = Evaluation(config=dict(cfg), roofline_s=roofline_s,
                        wall_s=wall, score=_score(obj, roofline_s, wall))
        evaluated[k] = ev
        return ev

    start = default_config(kernel, shape, dtype, sms)
    default_ev = evaluate(start)
    best = default_ev
    while len(evaluated) < budget:
        moved = False
        for cand in _neighbours(best.config, space):
            if len(evaluated) >= budget:
                break
            ev = evaluate(cand)
            if ev.score < best.score:
                best = ev
                moved = True
        if not moved:
            break
    return TuneResult(kernel=kernel, shape=tuple(shape), dtype=dtype,
                      objective=obj, best=best, default=default_ev,
                      trace=list(evaluated.values()))


# ----------------------------------------------------------- disk cache
def default_cache_path() -> str:
    env = os.environ.get(_ENV_CACHE)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def _entry_ok(key: str, rec) -> bool:
    """A well-formed entry whose plan the plan function takes at its
    bucket's widest or narrowest shape (every axis at its pow2 top, or
    just past the pow2 below: shared memory grows with d, splits with w,
    so an entry that fits some shape of its bucket fits one of these;
    ``_tuned`` checks the exact shape at launch)."""
    parts = key.split("|")
    if len(parts) != 4 or not isinstance(rec, dict):
        return False
    _, kernel, dtype, bucket = parts
    cfg = rec.get("config")
    if (kernel not in KNOBS or dtype not in _TILE_DTYPES
            or not isinstance(cfg, dict) or set(cfg) != set(KNOBS[kernel])
            or not all(type(v) is int for v in cfg.values())):
        return False
    dims = bucket.split("_")
    axes = _AXES[kernel]
    if len(dims) != len(axes) or not all(
            p.startswith(a) and p[len(a):].isdigit()
            for p, a in zip(dims, axes)):
        return False
    top = tuple(int(p[len(a):]) for p, a in zip(dims, axes))
    if not all(top) or top != tuple(_next_pow2(v) for v in top):
        return False
    bottom = tuple(v // 2 + 1 if v > 1 else 1 for v in top)
    return any(feasible(kernel, shape, dtype, cfg)
               for shape in (top, bottom))


class TuningCache:
    """Versioned on-disk tuning cache.

    JSON schema (version 1, the reference's)::

        {"version": 1,
         "entries": {"<device>|<kernel>|<dtype>|<bucket>": {
             "config": {"rows": 64, ...},
             "objective": "wall", "wall_s": ..., "roofline_s": ...,
             "n_evaluated": 7}}}

    ``load`` NEVER raises on a bad file: a missing, unreadable,
    corrupted, or version-mismatched cache yields an empty cache, which
    makes every launch take its analytic plan. Entries that are
    malformed or whose plan the plan function rejects at both ends of
    their bucket are dropped and listed in ``dropped`` (as are tuned
    entries that ``resolve_*`` finds infeasible at the shape launched).
    """

    def __init__(self, entries: Optional[dict] = None,
                 dropped: Optional[list] = None):
        self.entries: dict[str, dict] = dict(entries or {})
        self.dropped: list[str] = list(dropped or [])

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return cls()
        if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION:
            return cls()
        entries = raw.get("entries")
        if not isinstance(entries, dict):
            return cls()
        good = {k: v for k, v in entries.items() if _entry_ok(k, v)}
        return cls(good, [k for k in entries if k not in good])

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": self.entries},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    def get(self, key: str) -> Optional[dict]:
        rec = self.entries.get(key)
        return dict(rec["config"]) if rec else None

    def put(self, key: str, result: TuneResult) -> None:
        self.entries[key] = {
            "config": dict(result.best.config),
            "objective": result.objective,
            "wall_s": result.best.wall_s,
            "roofline_s": result.best.roofline_s,
            "default_wall_s": result.default.wall_s,
            "default_roofline_s": result.default.roofline_s,
            "n_evaluated": len(result.trace),
        }


# ---------------------------------------------------- runtime fast path
_runtime_cache: Optional[TuningCache] = None
_runtime_path: Optional[str] = None


def reset() -> None:
    """Drop the loaded in-process cache and every memoised resolution,
    so the next launch of each shape reads the cache from disk again
    (tests; or after an external tune run). A path pinned with
    ``set_cache_path`` stays pinned."""
    global _runtime_cache
    _runtime_cache = None
    for fn in (resolve_gram, resolve_rff, resolve_kkt, resolve_decision):
        fn.cache_clear()


def set_cache_path(path: Optional[str]) -> None:
    """Pin the runtime cache to ``path`` (``None`` -> back to default
    resolution) and reload lazily on next lookup."""
    global _runtime_path
    reset()
    _runtime_path = path


def runtime_cache() -> TuningCache:
    """The cache the runtime path reads (loaded at first use)."""
    global _runtime_cache
    if _runtime_cache is None:
        _runtime_cache = TuningCache.load(_runtime_path
                                          or default_cache_path())
    return _runtime_cache


def lookup(kernel: str, shape: tuple[int, ...], dtype: str = "fp32",
           device=None) -> Optional[dict[str, int]]:
    """Tuned config for this (device, kernel, dtype, shape bucket) or
    ``None`` when untuned (launches then take their analytic plan)."""
    cache = runtime_cache()
    if not cache.entries:
        return None
    return cache.get(cache_key(device_kind(device), kernel, dtype, shape))


def _tuned(kernel: str, shape: tuple[int, ...], dtype: str, device,
           sms: int) -> dict[str, int]:
    """The tuned knobs of this exact shape, or {}: an entry whose plan
    the plan function rejects at this shape (a split count past a
    narrower bank of its bucket) is dropped and counted."""
    cfg = lookup(kernel, shape, dtype, device)
    if cfg is None:
        return {}
    if not feasible(kernel, shape, dtype, cfg, sms):
        runtime_cache().dropped.append(
            f"{cache_key(device_kind(device), kernel, dtype, shape)} at "
            f"{tuple(shape)}")
        return {}
    return cfg


def _dtype_name(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


@memoised(kind="tuner resolution")
def resolve_gram(n: int, m: int, d: int, dtype: torch.dtype,
                 device: torch.device, sms: int,
                 rows: Optional[int] = None) -> G.GramPlan:
    """The Gram block entry's plan: ``rows`` if given, else the tuned
    row tile of this bucket, else ``gram_plan``'s own."""
    if rows is None:
        rows = _tuned("rbf_gram", (n, m, d), _dtype_name(dtype), device,
                      sms).get("rows")
    return G.gram_plan(n, m, d, dtype, 1, "block", sms, rows)


@memoised(kind="tuner resolution")
def resolve_rff(n: int, k: int, d: int, dtype: torch.dtype,
                device: torch.device, sms: int,
                rows: Optional[int] = None) -> FM.RffPlan:
    """``rff_features``' plan: ``rows`` if given, else tuned, else
    ``rff_plan``'s own."""
    if rows is None:
        rows = _tuned("rff_features", (n, k, d), _dtype_name(dtype), device,
                      sms).get("rows")
    return FM.rff_plan(n, k, d, sms, rows)


@memoised(kind="tuner resolution")
def resolve_kkt(n: int, device: torch.device,
                blocks: Optional[int] = None) -> int:
    """``kkt_select``'s blocks a task: ``blocks`` if given, else tuned,
    else ``n_blocks(n)``."""
    if blocks is None:
        blocks = _tuned("kkt_select", (n,), "fp32", device,
                        H100_SMS).get("blocks")
    return plan("kkt_select", (n,), "fp32", {"blocks": blocks})


@memoised(kind="tuner resolution")
def resolve_decision(kernel: str, nt: int, n_tasks: int, w: int, d: int,
                     dtype: torch.dtype, device: torch.device, sms: int,
                     rows: Optional[int] = None,
                     splits: Optional[int] = None,
                     bank: Optional[torch.dtype] = None) -> D.DecisionPlan:
    """The decision kernel's plan for ``kernel`` ("decision": one bank,
    or "multitask_decision") over rows of ``dtype`` and a bank of
    ``bank`` (default ``dtype``; a quantized bank's 16-bit stage): each
    of ``rows`` / ``splits`` if given, else tuned (the tuner's entry of
    the rows' dtype), else ``decision_plan``'s own."""
    if rows is None or splits is None:
        shape = ((nt, w, d) if kernel == "decision"
                 else (n_tasks, nt, w, d))
        tuned = _tuned(kernel, shape, _dtype_name(dtype), device, sms)
        rows = tuned.get("rows") if rows is None else rows
        splits = tuned.get("splits") if splits is None else splits
    return D.decision_plan(nt, n_tasks, w, d, sms, rows, splits,
                           dtype if bank is None else bank)
