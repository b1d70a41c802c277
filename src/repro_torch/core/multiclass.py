"""Multiclass strategy layer: task builders, decode and the scheduler.

Mirrors ``repro/core/multiclass.py`` (the port keeps its own copy and
never imports the reference). Two pieces:

Strategies (``MulticlassStrategy``)
    Turn an (x, y) multiclass problem into a ``TaskSet`` of independent
    binary subproblems; ``decide_from_pairs`` turns the stacked binary
    decision values back into class predictions.

    * ``OneVsOneStrategy``  — C = m(m-1)/2 pairwise tasks; predict by
      majority ``vote`` (LIBSVM convention) or summed ``margin``.
    * ``OneVsRestStrategy`` — m tasks, class c vs the rest; predict by
      argmax of the decision values.

Scheduler (``build_schedule``)
    Group the variable-length binary tasks into shape buckets
    (next-power-of-two task lengths, capped at the largest task) so each
    bucket is solved at its own width, and lay tasks out over workers
    with a greedy longest-processing-time (LPT) assignment.
    ``schedule_stats`` reports how much of the scheduled cost is
    padding.

Task building and scheduling are numpy on the host, as in the
reference; the decode (``decide_from_pairs``) runs on torch tensors on
their own device. ``repro_torch.core.dist.fit_taskset`` consumes
(TaskSet, Schedule) and runs one batched SMO per bucket.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


# --------------------------------------------------------------------- tasks
class BinaryTask(NamedTuple):
    """One binary subproblem: samples, +-1 labels, and vote routing.

    ``pos`` / ``neg`` index ``TaskSet.classes``: a positive decision
    credits ``pos``, a negative one ``neg`` (-1 for the OvR "rest"
    pseudo-class, which never receives credit). ``indices`` maps task
    rows back to the original training matrix (``x == X[indices]``); the
    low-rank multiclass fit gathers each task's feature rows with it.
    """

    x: np.ndarray    # (k, d) float32
    y: np.ndarray    # (k,)   float32 in {+1, -1}
    pos: int
    neg: int
    indices: Optional[np.ndarray] = None   # (k,) int64 rows into X

    @property
    def size(self) -> int:
        return self.x.shape[0]


class TaskSet(NamedTuple):
    """Strategy-agnostic bundle of variable-length binary tasks; padding
    is the scheduler's decision, not the builder's."""

    tasks: tuple[BinaryTask, ...]
    classes: np.ndarray   # (m,) sorted unique labels
    strategy: str         # "ovo" | "ovr"

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    @property
    def sizes(self) -> np.ndarray:
        return np.array([t.size for t in self.tasks], np.int64)

    @property
    def pairs(self) -> np.ndarray:
        """(C, 2) class-index array: column 0 credited on decision > 0,
        column 1 on decision < 0 (-1 = no credit)."""
        return np.array([(t.pos, t.neg) for t in self.tasks], np.int64)


# ----------------------------------------------------------------- strategies
class MulticlassStrategy:
    """Interface: build the TaskSet; classes come back from the stacked
    decisions through ``decide_from_pairs`` with the TaskSet's pairs."""

    name = "base"

    def build_taskset(self, x: np.ndarray, y: np.ndarray) -> TaskSet:
        raise NotImplementedError


def _classes_and_members(x, y):
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    classes = np.unique(y)
    if len(classes) < 2:
        raise ValueError("need at least 2 classes")
    members = {i: np.where(y == c)[0] for i, c in enumerate(classes)}
    return x, classes, members


class OneVsOneStrategy(MulticlassStrategy):
    """C = m(m-1)/2 pairwise tasks (the paper's decomposition), in the
    order (0, 1), (0, 2), ..., (m-2, m-1)."""

    name = "ovo"

    def build_taskset(self, x, y) -> TaskSet:
        x, classes, members = _classes_and_members(x, y)
        tasks = []
        m = len(classes)
        for a in range(m):
            for b in range(a + 1, m):
                ia, ib = members[a], members[b]
                xt = np.concatenate([x[ia], x[ib]], axis=0)
                yt = np.concatenate([np.ones(len(ia), np.float32),
                                     -np.ones(len(ib), np.float32)])
                tasks.append(BinaryTask(x=xt, y=yt, pos=a, neg=b,
                                        indices=np.concatenate([ia, ib])))
        return TaskSet(tasks=tuple(tasks), classes=classes,
                       strategy=self.name)


class OneVsRestStrategy(MulticlassStrategy):
    """m tasks, class c (+1) vs all others (-1), in class order; argmax
    decision."""

    name = "ovr"

    def build_taskset(self, x, y) -> TaskSet:
        x, classes, members = _classes_and_members(x, y)
        tasks = []
        for c in range(len(classes)):
            yt = -np.ones(x.shape[0], np.float32)
            yt[members[c]] = 1.0
            tasks.append(BinaryTask(x=x, y=yt, pos=c, neg=-1,
                                    indices=np.arange(x.shape[0])))
        return TaskSet(tasks=tuple(tasks), classes=classes,
                       strategy=self.name)


_STRATEGIES = {"ovo": OneVsOneStrategy, "ovr": OneVsRestStrategy}


def get_strategy(name: str | MulticlassStrategy) -> MulticlassStrategy:
    if isinstance(name, MulticlassStrategy):
        return name
    try:
        return _STRATEGIES[name]()
    except KeyError:
        raise ValueError(f"unknown multiclass strategy {name!r}; "
                         f"expected one of {sorted(_STRATEGIES)}") from None


# ------------------------------------------------------------ vote decisions
def decide_from_pairs(df, pairs: np.ndarray, m: int, strategy: str,
                      decision: str = "vote") -> torch.Tensor:
    """Class indices from stacked decision values ``df (C, t)`` and the
    (C, 2) credit table alone — shared by the strategies and the
    serving layer, which carries ``pairs`` in the packed artifact. OvR
    has one decision value per class (tasks in class order), so argmax
    is the decision and ``decision`` is ignored there."""
    df = torch.as_tensor(df, dtype=torch.float32)
    if strategy == "ovr":
        return torch.argmax(df, dim=0)
    if decision == "margin":
        return margin_decision(df, pairs, m)
    if decision == "vote":
        return vote_decision(df, pairs, m)
    raise ValueError(f"unknown OvO decision {decision!r}; "
                     "expected 'vote' or 'margin'")


def vote_decision(df, pairs: np.ndarray, m: int) -> torch.Tensor:
    """Majority vote as a pair of (t, C) @ (C, m) products.

    Vote counts are small integers, exact in float32. A tanh(margin)
    term breaks ties toward the larger margin; among leaders with equal
    tie-break terms the lowest class index wins (LIBSVM order). ``neg =
    -1`` rows (OvR) drop out of the one-hot."""
    df = torch.as_tensor(df, dtype=torch.float32)
    pos = (df > 0).to(torch.float32)                    # (C, t)
    one_pos = _one_hot(pairs[:, 0], m, df.device)       # (C, m)
    one_neg = _one_hot(pairs[:, 1], m, df.device)
    votes = pos.T @ one_pos + (1.0 - pos).T @ one_neg   # (t, m)
    tie = torch.tanh(df).T @ (one_pos - one_neg)        # (t, m)
    lead = votes >= torch.max(votes, dim=1, keepdim=True).values - 0.5
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return torch.argmax(torch.where(lead, tie, -torch.inf), dim=1)


def margin_decision(df, pairs: np.ndarray, m: int) -> torch.Tensor:
    """Summed-margin decision: each task adds tanh(df) to its positive
    class and -tanh(df) to its negative class; argmax wins."""
    df = torch.as_tensor(df, dtype=torch.float32)
    w = torch.tanh(df)                                  # (C, t)
    score = (w.T @ _one_hot(pairs[:, 0], m, df.device)
             - w.T @ _one_hot(pairs[:, 1], m, df.device))
    return torch.argmax(score, dim=1)


def _one_hot(idx: np.ndarray, m: int, device) -> torch.Tensor:
    """(C,) class indices -> (C, m) float32 one-hot; idx = -1 maps to
    all-zeros."""
    idx = np.asarray(idx, np.int64)
    out = np.zeros((len(idx), m), np.float32)
    valid = idx >= 0
    out[np.arange(len(idx))[valid], idx[valid]] = 1.0
    return torch.from_numpy(out).to(device)


# ------------------------------------------------------------------ schedule
@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Size-bucketing + worker-layout policy (the reference's fields and
    defaults).

    bucket_by: "pow2" rounds each task length up to the next power of
               two (>= min_width) and groups equal widths; "none" is one
               bucket, every task padded to the global max (or
               ``pad_width``).
    min_width: floor on bucket widths.
    n_workers: worker count the layout targets (1 = one device).
    pad_width: bucket_by="none" only — force the single bucket's width.
    """

    bucket_by: str = "pow2"
    min_width: int = 32
    n_workers: int = 1
    pad_width: int | None = None


class Bucket(NamedTuple):
    """One shape bucket: every task in it runs at sample-width ``width``.
    ``task_ids`` is the (n_workers, slots_per_worker) layout grid, -1
    marking dummy slots (fully masked solves)."""

    width: int
    task_ids: np.ndarray

    @property
    def n_slots(self) -> int:
        return self.task_ids.size


class Schedule(NamedTuple):
    buckets: tuple[Bucket, ...]
    n_workers: int


def bucket_width(size: int, cfg: ScheduleConfig) -> int:
    if cfg.bucket_by == "none":
        raise ValueError("bucket_by='none' has a single explicit width")
    if cfg.bucket_by != "pow2":
        raise ValueError(f"unknown bucket_by {cfg.bucket_by!r}; "
                         "expected 'pow2' or 'none'")
    return max(cfg.min_width, 1 << (max(size, 1) - 1).bit_length())


def task_cost(width: int) -> float:
    """Relative cost of one scheduled slot: SMO iterations grow ~linearly
    with the task size and each pays O(width) row work, so width^2 (LPT
    only needs the relative order)."""
    return float(width) ** 2


def build_schedule(sizes: Sequence[int],
                   cfg: ScheduleConfig = ScheduleConfig()) -> Schedule:
    """Bucket tasks by padded width, then greedy-LPT the layout: buckets
    largest first, each task to the least-loaded worker."""
    sizes = np.asarray(sizes, np.int64)
    if sizes.ndim != 1 or len(sizes) == 0:
        raise ValueError("sizes must be a non-empty 1-D sequence")
    p = max(1, cfg.n_workers)

    if cfg.bucket_by == "none":
        width = int(cfg.pad_width if cfg.pad_width is not None
                    else sizes.max())
        if width < sizes.max():
            raise ValueError(f"pad_width {width} < max task size "
                             f"{sizes.max()}")
        by_width = {width: list(range(len(sizes)))}
    else:
        # cap at the largest task: rounding the widest task up (or up to
        # min_width) would pad more than the pad-to-max layout
        cap = int(sizes.max())
        by_width: dict[int, list[int]] = {}
        for t, s in enumerate(sizes):
            w = min(bucket_width(int(s), cfg), cap)
            by_width.setdefault(w, []).append(t)

    loads = np.zeros(p, np.float64)  # repro: noqa[R002] -- host-side LPT load accounting, never on the device
    buckets = []
    for width in sorted(by_width, reverse=True):
        ids = sorted(by_width[width], key=lambda t: -sizes[t])
        per_worker: list[list[int]] = [[] for _ in range(p)]
        for t in ids:
            w = int(np.argmin(loads))
            per_worker[w].append(t)
            loads[w] += task_cost(width)
        slots = max(len(g) for g in per_worker)
        grid = np.full((p, slots), -1, np.int64)
        for w, g in enumerate(per_worker):
            grid[w, :len(g)] = g
            # dummy slots still run a masked solve in lockstep
            loads[w] += task_cost(width) * (slots - len(g))
        buckets.append(Bucket(width=width, task_ids=grid))
    return Schedule(buckets=tuple(buckets), n_workers=p)


def schedule_stats(sizes: Sequence[int], schedule: Schedule) -> dict:
    """Padding accounting: how much of the scheduled cost is real work
    vs. pad-to-width / dummy-slot waste."""
    sizes = np.asarray(sizes, np.int64)
    real = float(sum(task_cost(int(s)) for s in sizes))
    scheduled = 0.0
    for b in schedule.buckets:
        scheduled += task_cost(b.width) * b.n_slots
    return {
        "n_tasks": int(len(sizes)),
        "n_buckets": len(schedule.buckets),
        "bucket_widths": [int(b.width) for b in schedule.buckets],
        "scheduled_cost": scheduled,
        "real_cost": real,
        "padded_flop_fraction": 1.0 - real / scheduled if scheduled else 0.0,
    }
