"""Launch-plan tuner for the port's SVM kernels: the counterpart of
``repro/roofline/svm_tune.py``, with the same flags and shape sweeps.

    # on the card: time each plan's device ms and keep the best
    PYTHONPATH=src python -m repro_torch.roofline.svm_tune --kernel all

    # on the CPU: rank the plans by the H100 roofline estimate alone
    PYTHONPATH=src python -m repro_torch.roofline.svm_tune --kernel all \
        --objective roofline --dry-run

Per (kernel, shape, dtype) this enumerates the feasible launch plans
(``kernels.autotune.candidates``: the knobs each plan function takes,
clipped to the shape, filtered by the shared-memory limit), hill-climbs
from the analytic plan by device time and/or the roofline estimate
(``--objective``; see ``kernels.autotune``), prints every evaluated plan
and the default -> tuned line, and merges the winner into the versioned
on-disk cache that ``kernels.ops`` reads at its first launch of a shape
(``$REPRO_TORCH_TUNE_CACHE``, else ``~/.cache/repro_torch/autotune.json``;
``--out`` writes elsewhere). Existing entries for other keys are kept.

Shapes are 'x'-separated per kernel:
    rbf_gram            NxMxD        (Gram block)
    rff_features        NxKxD        (samples x random features x dims)
    kkt_select          N            (sample count)
    decision            TxNxD        (test batch x train rows x features)
    multitask_decision  TASKSxTxWxD  (serving bucket)
"""
import argparse
import sys

# default tuning sweeps per kernel (training + serving shape regimes)
DEFAULT_SHAPES = {
    "rbf_gram": ["1024x1024x128", "4096x4096x128"],
    "rff_features": ["16384x256x128"],
    "kkt_select": ["4096", "16384"],
    "decision": ["256x2048x128"],
    "multitask_decision": ["8x256x512x128"],
}


def parse_shape(kernel: str, text: str) -> tuple:
    arity = {"rbf_gram": 3, "rff_features": 3, "kkt_select": 1,
             "decision": 3, "multitask_decision": 4}[kernel]
    parts = tuple(int(p) for p in text.lower().split("x"))
    if len(parts) != arity or any(p <= 0 for p in parts):
        raise ValueError(
            f"{kernel} expects {arity} positive 'x'-separated dims "
            f"(see module docstring), got {text!r}")
    return parts


def tune_one(kernel: str, shape: tuple, *, dtype: str, budget: int,
             objective: str, verbose: bool = True):
    from repro_torch.kernels import autotune
    res = autotune.tune(kernel, shape, dtype=dtype, budget=budget,
                        objective=objective)
    if verbose:
        shape_s = "x".join(map(str, shape))
        print(f"{kernel} {shape_s} [{dtype}] objective={res.objective} "
              f"({len(res.trace)} plans evaluated)")
        for ev in sorted(res.trace, key=lambda e: e.score):
            mark = "*" if ev.config == res.best.config else " "
            dev = (f"{ev.wall_s * 1e3:9.4f}ms" if ev.wall_s is not None
                   else "        —")
            print(f"  {mark} {ev.config}  roofline="
                  f"{ev.roofline_s * 1e6:8.2f}us  device={dev}")
        d, b = res.default, res.best
        if d.wall_s and b.wall_s:
            print(f"  default -> tuned device: {d.wall_s * 1e3:.4f}ms -> "
                  f"{b.wall_s * 1e3:.4f}ms ({d.wall_s / b.wall_s:.2f}x)")
        print(f"  default -> tuned roofline est: "
              f"{d.roofline_s * 1e6:.2f}us -> {b.roofline_s * 1e6:.2f}us")
    return res


def main(argv=None):
    from repro_torch.kernels import autotune

    ap = argparse.ArgumentParser(
        description="Hill-climb the launch plans of the SVM kernels and "
                    "persist them to the tuning cache.")
    ap.add_argument("--kernel", default="all",
                    choices=sorted(autotune.KNOBS) + ["all"])
    ap.add_argument("--shape", action="append", default=[],
                    help="kernel shape, e.g. 1024x1024x128 (repeatable; "
                         "defaults to a per-kernel sweep)")
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                    help="compute precision to tune for")
    ap.add_argument("--budget", type=int, default=12,
                    help="max plans evaluated per (kernel, shape)")
    ap.add_argument("--objective", default="auto",
                    choices=["auto", "wall", "roofline"])
    ap.add_argument("--out", default="",
                    help="cache file to merge results into (default: the "
                         "runtime cache path)")
    ap.add_argument("--dry-run", action="store_true",
                    help="tune and report, do not write the cache")
    args = ap.parse_args(argv)

    kernels = (sorted(autotune.KNOBS) if args.kernel == "all"
               else [args.kernel])
    jobs = []
    for k in kernels:
        shapes = args.shape if args.shape else DEFAULT_SHAPES[k]
        for s in shapes:
            jobs.append((k, parse_shape(k, s)))

    path = args.out or autotune.default_cache_path()
    cache = autotune.TuningCache.load(path)
    device = autotune.device_kind()
    print(f"device={device}  cache={path}  "
          f"({len(cache.entries)} existing entries, {len(cache.dropped)} "
          f"dropped)")
    for kernel, shape in jobs:
        res = tune_one(kernel, shape, dtype=args.dtype,
                       budget=args.budget, objective=args.objective)
        cache.put(autotune.cache_key(device, kernel, args.dtype, shape),
                  res)
    if not args.dry_run:
        cache.save(path)
        autotune.reset()   # runtime launches see the fresh entries
        print(f"wrote {len(cache.entries)} entries -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
