"""Collective attribution: the largest collectives of a traced combo, each
with the model source line that issued it (the port of
``repro/roofline/inspect_hlo.py``).

    PYTHONPATH=src python -m repro_torch.roofline.inspect_hlo \\
        --arch gemma3_12b --shape decode_32k [--variant onehot_embed] \\
        [--n-layers 2]

There is no HLO in torch. The reference scans the compiled module's text
for collectives and reads each one's ``op_name`` metadata; here
``roofline.collect.RankCounter`` records each functional collective
DTensor issues for rank 0 of the fake mesh as it runs
(``launch.dryrun.lower_combo(..., keep_collectives=True)``): its result
bytes, kind, result shape and the innermost frame under
``repro_torch/models/`` (``file:line function``). The combo is traced at
a shallow depth (2 layers by default), as the reference's is.
"""
from __future__ import annotations

import argparse
import logging
import sys


def top_collectives(records: list[dict], n: int = 15) -> list[tuple]:
    """The ``n`` largest of ``RankCounter.records``, largest first:
    ``(bytes, kind, shape, source)``."""
    out = [(r["bytes"], r["kind"], str(r["shape"])[:60], r["source"][-120:])
           for r in records]
    out.sort(reverse=True)
    return out[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline",
                    help="a name of roofline.hillclimb.VARIANTS")
    ap.add_argument("--n-layers", type=int, default=0)
    from repro_torch.launch import dryrun as DR
    DR.add_combo_args(ap)
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    from repro_torch.roofline.hillclimb import variant_flags
    nl = args.n_layers or 2
    with variant_flags(args.variant):
        r = DR.lower_combo(args.arch, args.shape, n_layers=nl,
                           keep_collectives=True, **DR.combo_kwargs(args))
    if r["status"] != "ok":
        print(f"SKIP {args.arch} x {args.shape}: {r['status']}")
        return 0
    print(f"{args.arch} x {args.shape} [{args.variant}] depth={nl} "
          f"ranks={r['n_ranks']} (estimates)")
    print(f"total collective bytes: {r['collectives']['total_bytes']:.3e}")
    for b, kind, shape, name in top_collectives(r["_collectives"]):
        print(f"  {b / 1e6:10.2f} MB  {kind:15s} {shape:40s} {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
