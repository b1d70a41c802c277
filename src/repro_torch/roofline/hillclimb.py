"""Hill-climb driver: a runtime variant -> its roofline terms (the port of
``repro/roofline/hillclimb.py``).

    PYTHONPATH=src python -m repro_torch.roofline.hillclimb \\
        --arch deepseek_67b --shape train_4k --variant bf16_scores \\
        [--skip-full] [--multi-pod] [--out FILE.jsonl] [--reduced] \
        [--mesh DxM]

Each variant turns on switches of ``models.runtime`` (every name in
``VARIANTS`` is one of ``runtime.FLAGS``), runs the depth-differential
probe (``roofline.differential.probe``) on the fake mesh, and returns
the full-depth counts, their three roofline terms on the H100
(``roofline.report.terms_of``) and the full-depth trace's per-rank
memory. The switches are reset after the run, so later combos in the
process do not inherit them.

The reference multiplies every count by ``MICROBATCHES``, because XLA
counts its accumulation scan's body once. The port's train step loops
the microbatches in Python (``training.train.make_train_step``), and
``RankCounter`` sees each one, so the counts are taken as they are:
``accum4`` counts the FLOPs of ``baseline``.

Every number is a per-rank estimate of a fake mesh on the CPU, not a
measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys

VARIANTS = {
    "baseline": {},
    "bf16_scores": {"scores_bf16": True},
    "remat_dots": {"remat_policy": "dots"},
    "remat_none": {"remat_policy": "none"},
    "chunk_attn_4k": {"chunked_threshold": 4096},
    "bf16+dots": {"scores_bf16": True, "remat_policy": "dots"},
    "bf16+chunk": {"scores_bf16": True, "chunked_threshold": 4096},
    "bf16+dots+chunk": {"scores_bf16": True, "remat_policy": "dots",
                        "chunked_threshold": 4096},
    "onehot_embed": {"embed_onehot": True},
    "moe_grouped": {"moe_grouped": True},
    "grouped+bf16": {"moe_grouped": True, "scores_bf16": True},
    "onehot+bf16": {"embed_onehot": True, "scores_bf16": True},
    "accum4": {"microbatches": 4},
    "fit4": {"scores_bf16": True, "chunked_threshold": 4096,
             "microbatches": 4},
    "fit8": {"scores_bf16": True, "chunked_threshold": 4096,
             "microbatches": 8},
    "grouped+accum4": {"moe_grouped": True, "microbatches": 4},
    "serve_tp": {"serve_pure_tp": True},
    "serve_tp+grouped": {"serve_pure_tp": True, "moe_grouped": True},
    "window_sp": {"window_cache_sp": True},
    "serve_tp+window_sp": {"serve_pure_tp": True, "window_cache_sp": True},
    "serve_tp+window_sp+onehot": {"serve_pure_tp": True,
                                  "window_cache_sp": True,
                                  "embed_onehot": True},
    "gather_w": {"gather_weights": True},
    "gather_w+accum4": {"gather_weights": True, "microbatches": 4},
    "gather_w+accum8": {"gather_weights": True, "microbatches": 8},
    "accum8": {"microbatches": 8},
    "accum16": {"microbatches": 16},
    "accum16+chunk": {"microbatches": 16, "chunked_threshold": 4096},
    "accum32": {"microbatches": 32},
    "xe_shard": {"moe_xe_shard": True},
    "xe_shard+cap1": {"moe_xe_shard": True},  # cap handled via cfg override
    "mla_pad": {"mla_pad_heads": True},
    "mla_pad+accum8": {"mla_pad_heads": True, "microbatches": 8},
}


@contextlib.contextmanager
def variant_flags(variant: str):
    """The switches of ``VARIANTS[variant]`` on inside the block, every
    switch of ``models.runtime`` back as it was after it."""
    from repro_torch.models import runtime as RT
    saved = {k: getattr(RT, k) for k in RT.FLAGS}
    try:
        RT.set_flags(**VARIANTS[variant])
        yield
    finally:
        RT.set_flags(**saved)


def run(arch: str, shape: str, variant: str, *, multi_pod: bool = False,
        skip_full: bool = False, **combo) -> dict:
    """One variant's record: ``corrected`` (the probe's counts, without
    the per-layer slopes), ``terms`` and ``full_depth_memory`` (None
    under ``skip_full``, whose counts are then the two-depth
    extrapolation). ``combo`` goes to ``differential.probe``."""
    from repro_torch.roofline.differential import probe
    from repro_torch.roofline.report import terms_of
    with variant_flags(variant):
        res = probe(arch, shape, multi_pod=multi_pod, full=not skip_full,
                    **combo)
    if res["status"] != "ok":
        return res
    c = {k: v for k, v in res["corrected"].items()
         if not k.startswith("per_layer")}
    return {"arch": arch, "shape": shape, "variant": variant,
            "status": "ok", "estimate": res["estimate"],
            "corrected": c, "corrected_from": res["corrected_from"],
            "terms": terms_of(c, res["n_ranks"]),
            "full_depth_memory": res["memory"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, choices=list(VARIANTS))
    ap.add_argument("--out", default="")
    ap.add_argument("--skip-full", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    from repro_torch.launch import dryrun as DR
    DR.add_combo_args(ap)
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    res = run(args.arch, args.shape, args.variant, multi_pod=args.multi_pod,
              skip_full=args.skip_full, **DR.combo_kwargs(args))
    if res["status"] == "ok":
        t = res["terms"]
        mem = res.get("full_depth_memory")
        mem_s = (f" temp={mem['temp_bytes'] / 2**30:.1f}GiB"
                 if mem else "")
        print(f"{args.arch} x {args.shape} [{args.variant}]: "
              f"compute={t['t_compute_s'] * 1e3:.1f}ms "
              f"memory={t['t_memory_s'] * 1e3:.1f}ms "
              f"coll={t['t_collective_s'] * 1e3:.1f}ms "
              f"dominant={t['dominant']}{mem_s} (estimates)", flush=True)
    else:
        print(res["status"])
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
