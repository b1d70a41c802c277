"""Roofline report: dry-run JSON lines -> the roofline tables (the port of
``repro/roofline/report.py``).

    PYTHONPATH=src python -m repro_torch.roofline.report FILE.jsonl ... \\
        [--diff=DIFF.jsonl]

Per (arch x shape x mesh), from a ``launch.dryrun`` record (per rank:
``flops``, ``bytes_accessed``, ``collectives.total_bytes``, ``n_ranks``,
``memory.argument_bytes + temp_bytes``): the three roofline terms on the
H100 (``roofline.collect.roofline_terms``: the products at the bf16
tensor-core peak, the bytes at HBM's rate, the collective bytes at one
card's link rate), the dominant one, MODEL_FLOPS = 6·N·D (train) /
2·N_active·D (inference) per rank (the record's
``model_flops_per_rank``, of the config the dry run traced), and the
useful-compute ratio MODEL_FLOPS over the counted FLOPs. ``--diff=`` takes
``roofline.differential`` records, whose ``corrected`` counts replace
the row's. Every row is a per-rank estimate of a fake mesh on the CPU
(``launch.dryrun.ESTIMATE``), not a measurement.
"""
from __future__ import annotations

import glob
import json
import sys
from collections import Counter

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.roofline import collect as C
from repro_torch.roofline.collect import roofline_terms

RATES = (f"NVIDIA H100 SXM: {C.PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s dense "
         f"bf16, HBM {C.HBM_BW / 1e12:g} TB/s, links a card "
         f"{C.NVLINK_BW / 1e9:g} GB/s NVLink up to {C.NODE_CARDS} cards, "
         f"{C.NIC_BW / 1e9:g} GB/s NIC beyond (ring, per direction)")


def terms_of(counts: dict, n_ranks: int) -> dict:
    """The three roofline terms of a rank's counts (``flops``,
    ``bytes_accessed``, ``collective_total``) in a mesh of ``n_ranks``:
    the LM's products run in bf16 on the tensor cores."""
    return roofline_terms(hbm_bytes=counts["bytes_accessed"],
                          bf16_flops=counts["flops"],
                          collective_bytes_total=counts["collective_total"],
                          n_ranks=n_ranks)


def load(paths) -> list[dict]:
    rows = []
    for pat in paths:
        for p in sorted(glob.glob(pat)):
            with open(p) as f:
                for line in f:
                    if line.strip():
                        rows.append(json.loads(line))
    return rows


def analyze(row: dict, diff: dict | None = None) -> dict | None:
    """The row with its ``terms`` and ``useful_ratio``; None for a row
    that did not trace. ``diff``:
    {(arch, shape, multi_pod): corrected counts} from
    ``roofline.differential``."""
    if row.get("status") != "ok":
        return None
    n_ranks = row["n_ranks"]
    key = (row["arch"], row["shape"], row.get("multi_pod", False))
    if diff and key in diff:
        counts = diff[key]
        row = dict(row, corrected=True)
    else:                                             # per rank
        counts = {"flops": row["flops"],
                  "bytes_accessed": row["bytes_accessed"],
                  "collective_total": row["collectives"]["total_bytes"]}
    flops = counts["flops"]
    # the dry run's 6·N·D (2·N·D) of the config it traced, per rank
    ratio = row["model_flops_per_rank"] / flops if flops else 0.0
    return dict(row, terms=terms_of(counts, n_ranks), useful_ratio=ratio)


def fmt_table(rows: list[dict], *, multi_pod: bool) -> str:
    out = ["| arch | shape | t_compute | t_memory | t_collective | "
           "dominant | 6ND/counted | HBM GiB/rank |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r is None or r.get("multi_pod") != multi_pod:
            continue
        t = r["terms"]
        mem_gib = (r["memory"]["argument_bytes"]
                   + r["memory"]["temp_bytes"]) / 2**30
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {t['t_compute_s'] * 1e3:.2f} ms "
            f"| {t['t_memory_s'] * 1e3:.2f} ms "
            f"| {t['t_collective_s'] * 1e3:.2f} ms "
            f"| **{t['dominant']}** "
            f"| {r['useful_ratio']:.2f} "
            f"| {mem_gib:.2f} |")
    return "\n".join(out)


def _mesh(r: dict) -> str:
    """"16x16 = 256" of a row's (data, model) mesh."""
    return f"{'x'.join(map(str, r['mesh'].values()))} = {r['n_ranks']}"


def _order(r: dict):
    shapes = list(INPUT_SHAPES)
    return (r["arch"], shapes.index(r["shape"]) if r["shape"] in shapes
            else len(shapes), r["shape"])


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    paths = [a for a in args if not a.startswith("--diff")]
    diff_paths = [a.split("=", 1)[1] for a in args
                  if a.startswith("--diff=")]
    diff = {}
    for r in load(diff_paths):
        if r.get("status") == "ok":
            diff[(r["arch"], r["shape"], r.get("multi_pod", False))] = \
                r["corrected"]
    rows = [analyze(r, diff) for r in load(paths)]
    rows = sorted((r for r in rows if r), key=_order)
    if rows:
        print(f"Every row: {rows[0]['estimate']}.")
    print(f"Terms against {RATES}.\n")
    for mp, title, default in ((False, "Single-pod", "16x16 = 256"),
                               (True, "Multi-pod", "2x16x16 = 512")):
        meshes = sorted({_mesh(r) for r in rows if r["multi_pod"] == mp})
        if mp:
            print()
        print(f"## {title} ({', '.join(meshes) or default} ranks)\n")
        print(fmt_table(rows, multi_pod=mp))
    single = [r for r in rows if not r["multi_pod"]]
    doms = Counter(r["terms"]["dominant"] for r in single)
    print(f"\nsingle-pod dominance: {dict(doms)}")
    print("\nworst useful-compute ratios (hillclimb candidates):")
    for r in sorted(single, key=lambda r: r["useful_ratio"])[:5]:
        print(f"  {r['arch']} x {r['shape']}: ratio="
              f"{r['useful_ratio']:.3f} dominant="
              f"{r['terms']['dominant']}")
    print("\nmost collective-bound:")
    for r in sorted(single, key=lambda r: -(
            r["terms"]["t_collective_s"]
            / max(r["terms"]["t_total_est_s"], 1e-12)))[:5]:
        t = r["terms"]
        print(f"  {r['arch']} x {r['shape']}: "
              f"coll={t['t_collective_s'] * 1e3:.2f}ms "
              f"vs total={t['t_total_est_s'] * 1e3:.2f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
