"""Depth-differential roofline probe (the port of
``repro/roofline/differential.py``).

The reference compiles each (arch x shape) at two shallow depths (L1,
L2) because XLA's ``cost_analysis`` and its HLO collective scan count a
``lax.scan`` body once, not once a trip; it recovers

    per_layer = (C(L2) - C(L1)) / (L2 - L1)
    total(L)  = C(L1) + per_layer * (L - L1)

for FLOPs, bytes accessed and per-kind collective bytes. The port's
counters (``roofline.collect.RankCounter``) run eagerly over every
layer of the Python loops the stacks are, so a trace at the full depth
counts the full depth directly. Decided here:

* ``corrected`` holds the full-depth eager count
  (``lower_combo(..., n_layers=0)``), which is exact, and the per-layer
  costs of the depth pair (``per_layer_*``), as the reference's record;
* ``extrapolated`` holds the reference's two-depth formula on the same
  two shallow traces, beside it, so the two can be read together. They
  agree where every layer is alike and the depth pair respects the
  family's period; they differ where the full depth is not a multiple
  of the period (zamba2's shared attention before every 6th layer: 7
  applications at 38 layers, 1 + 32 / 6 = 6.33 by the formula).

``UNROLL_SCANS`` has no counterpart (``models/runtime.py``), and neither
has the reference's forced-host-device setup: the fake process group of
``launch.dryrun.fake_world`` takes its place, inside each trace.

    PYTHONPATH=src python -m repro_torch.roofline.differential \\
        [--arch X --shape Y] [--multi-pod] [--all] [--out FILE.jsonl] \
        [--reduced] [--mesh DxM]

Every number is a per-rank estimate of a fake mesh on the CPU (see
``launch.dryrun``), not a measurement.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import traceback

from repro_torch.configs.base import ARCH_NAMES, INPUT_SHAPES
from repro_torch.launch import dryrun as DR

# (L1, L2) per arch, respecting structural periodicity (the reference's)
DEPTH_PAIRS = {
    "phi3_vision_4p2b": (4, 8),
    "mamba2_780m": (4, 8),
    "phi4_mini_3p8b": (4, 8),
    "gemma3_12b": (6, 12),
    "deepseek_moe_16b": (5, 9),
    "minicpm3_4b": (4, 8),
    "whisper_medium": (4, 8),
    "zamba2_1p2b": (6, 12),
    "qwen2_moe_a2p7b": (4, 8),
    "deepseek_67b": (4, 8),
}


def _extract(res: dict) -> dict:
    c = {"flops": float(res["flops"]),
         "bytes_accessed": float(res["bytes_accessed"]),
         "collective_total": res["collectives"]["total_bytes"]}
    for k, v in res["collectives"]["per_kind_bytes"].items():
        c[f"coll_{k}"] = v
    return c


def extrapolate(c1: dict, c2: dict, l1: int, l2: int, depth: int) -> dict:
    """The reference's formula: each cost at ``depth`` from its values at
    depths ``l1`` and ``l2``, and its per-layer slope (``per_layer_*``)."""
    full = {}
    for k in c1:
        per = (c2[k] - c1[k]) / (l2 - l1)
        full[k] = c1[k] + per * (depth - l1)
        full[f"per_layer_{k}"] = per
    return full


def probe(arch: str, shape: str, *, multi_pod: bool, depth: int = 0,
          full: bool = True, input_shape=None, **combo) -> dict:
    """The record of one combo: ``corrected`` (the full-depth count, and
    the pair's per-layer costs), ``extrapolated`` (the reference's
    formula), ``depth_pair``, ``shallow_flops``. ``depth`` replaces the
    config's depth and ``input_shape`` (an ``InputShape``) the shape of
    that name (the tests' small combos); ``combo`` goes to
    ``launch.dryrun.lower_combo`` (``mesh_shape``, ``reduced``,
    ``cfg_overrides``, ``remat``).
    ``full=False`` skips the full-depth trace: ``corrected`` is then the
    extrapolation, and ``corrected_from`` says so."""
    l1, l2 = DEPTH_PAIRS[arch]
    cfg = DR.combo_config(arch, reduced=combo.get("reduced", False),
                          cfg_overrides=combo.get("cfg_overrides"))
    depth = depth or cfg.n_layers
    combo["shape"] = input_shape
    r1 = DR.lower_combo(arch, shape, multi_pod=multi_pod, n_layers=l1,
                        **combo)
    if r1["status"] != "ok":
        return r1
    r2 = DR.lower_combo(arch, shape, multi_pod=multi_pod, n_layers=l2,
                        **combo)
    c1, c2 = _extract(r1), _extract(r2)
    ext = extrapolate(c1, c2, l1, l2, depth)
    per_layer = {k: v for k, v in ext.items() if k.startswith("per_layer")}
    extrapolated = {k: v for k, v in ext.items()
                    if not k.startswith("per_layer")}
    rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
           "status": "ok", "estimate": DR.ESTIMATE,
           "n_ranks": r1["n_ranks"], "n_layers": depth,
           "depth_pair": [l1, l2],
           "shallow_flops": [c1["flops"], c2["flops"]],
           "extrapolated": extrapolated}
    if full:
        rf = {l1: r1, l2: r2}.get(depth) or DR.lower_combo(
            arch, shape, multi_pod=multi_pod, n_layers=depth, **combo)
        rec.update(corrected={**_extract(rf), **per_layer},
                   corrected_from="full-depth trace",
                   memory=rf["memory"], full_depth=rf)
    else:
        rec.update(corrected=ext, corrected_from="extrapolation",
                   memory=None)
    return rec


def gap(rec: dict, key: str = "flops") -> float:
    """``corrected`` over ``extrapolated`` for one cost, less 1."""
    got, ext = rec["corrected"][key], rec["extrapolated"][key]
    return got / ext - 1.0 if ext else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="")
    DR.add_combo_args(ap)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    # DTensor warns at each multi-axis reduction of the mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    combos = ([(a, s) for a in ARCH_NAMES for s in INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    out_f = open(args.out, "a") if args.out else None
    fails = 0
    for arch, shape in combos:
        try:
            res = probe(arch, shape, multi_pod=args.multi_pod,
                        **DR.combo_kwargs(args))
            if res["status"] == "ok":
                res.pop("full_depth")
                c = res["corrected"]
                print(f"OK   {arch} x {shape}: flops/rank = "
                      f"{c['flops']:.3e} (extrapolated "
                      f"{res['extrapolated']['flops']:.3e}, gap "
                      f"{gap(res):+.4f}) coll = "
                      f"{c['collective_total']:.3e}B (estimates)",
                      flush=True)
            else:
                print(f"SKIP {arch} x {shape}: {res['status']}", flush=True)
        except Exception as e:
            fails += 1
            res = {"arch": arch, "shape": shape,
                   "status": f"FAIL: {type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-1500:]}
            print(f"FAIL {arch} x {shape}: {e}", flush=True)
        if out_f:
            out_f.write(json.dumps(res) + "\n")
            out_f.flush()
    if out_f:
        out_f.close()
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
